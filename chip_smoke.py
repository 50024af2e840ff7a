#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (alpine_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printing one JSON line:
  device  the card's name, count and power limit (nvidia-smi);
  build   nvcc builds every kernel of alpine_tpu_torch/csrc for sm_90a;
  sass    cuobjdump of the fused_iteration library: tensor-core (HMMA)
          instructions in both passes of the int8 and bf16 instantiations
          and in none of the float32/int16 per-tile pass, and no spill
          stores on the bf16 path (ptxas -v); the library's copies of the
          fp32 X passes (hxt_fma, wtx_fma: K1's float32/int16 path) with
          FFMA and cp.async copies (LDGSTS), no HMMA, no spill store and the
          registers of x_passes' copies; for fused_transform, registers, spill stores (none
          allowed) and FFMA count of each bucket of the register path, and
          registers, spill stores (none allowed), FFMA, LDGSTS (its WtW2
          ring) and LDS of each instantiation of the tiled path; for
          x_passes (ALS's hxt and wtx), HMMA in the bf16 kernels and none in
          the fp32 ones, FFMA in the fp32 ones, cp.async copies (LDGSTS) in
          every one (their rings) and ldmatrix (LDSM) in wtx_mma (none
          there, or a spill store anywhere, fails), registers and spill
          stores; the wgmma X passes above K = 512 (hxt_wide, wtx_wide on
          int8/bf16 X, rows aligned or not): HGMMA, TMA loads (UTMALDG)
          of the Hb/Wb tiles and of aligned X, cp.async windows of
          misaligned X, LDSM in wtx_wide's aligned path, no spill store,
          and ptxas's performance notes (C75xx); the fp32 X passes above
          K = 512 (hxt_fma_wide, wtx_fma_wide on float32/int16 X, rows
          aligned or not): FFMA of a ring chunk, cp.async copies (LDGSTS),
          no HMMA, at most 128 registers (two blocks an SM), no spill;
  kernel  each kernel against its plain PyTorch version on the card, at the
          bench shape (100k cells x 2,000 genes, K = 40, labels (2, 3), int8)
          and at small shapes over the other storage types, blocks and
          losses (K not a multiple of 16, ragged genes and cells, K = 300
          and 512 where the bf16 path takes its own tile), a second launch
          of each fused_iteration case bit for bit the first, with its time
          beside the plain version's and its bound; beside K1, K4 and K2 the
          two bf16 cuBLAS products over a bf16 copy of X as a yardstick; K1, K4 and
          K2 on int16 X (counts above 127) and K1 on float32 X at the bench
          shape, each with the two products as fp32 torch.matmul over a
          float32 copy of X beside it;
          fused_iteration's counts mode (weighted_fast) with counts from the
          port's own balanced sampler, undrawn columns checked bit for bit;
          fused_transform at K = 40 (the register path; also at a 2 x 2
          grid's 50,000 cells) and K = 100, 300 and
          512 (the tiled path), each row naming its path and grid; ALS's X
          passes hxt (P1,
          K = 40) and wtx (P2, k = 5 and 30) on int8, float32 and int16 X
          (counts above 127) at the bench shape, timed beside a bf16
          (float32) torch.matmul over a pre-cast copy of X (one call, and 20
          back to back, which hides the host's time per call), and at the
          minibatch steps' shape (8,192 cells, K = 40, int8), at a 2 x 2
          grid's block (1,000 genes x 50,000 cells, K = 40, int8) and wtx at a
          minibatch epoch's loss shape (all cells, K = 40, int8), each row with
          the grid it ran (hxt: gene block, splits, ring stages, partial
          bytes; wtx: tile, warp rows or lanes along K, gene chunk, ring
          stages, blocks, gene ranges, waves), each timed row also with the
          card's time of a call (device_us: its kernels' durations from
          torch.profiler, median of 20 calls) and the host's (host_us: 200
          calls enqueued behind a sleeping card), the library call's too;
          and at small
          edge shapes on every storage type (17, 1,001 and 5,040 cells,
          K = 1, 13, 40, 65, 300 and 512); then (kernel_twin rows) P1 and
          P2 on int8 X at K = 40 away from the bench shape, each X whose
          rows are off 16-byte alignment beside its aligned twin: 100k
          cells and the same X at a 1-byte offset (its aligned copy's bits
          checked), 66,667 against 66,672 cells, 33,334 against 33,344,
          8,192 cells and at a 1-byte offset, a tiled slab, the
          optimizer's ALS folds (P1 K = 44, P2 k = 32) at 66,667 against
          66,672, and a 2 x 2 grid's minibatch shares (1,000 genes, a cell
          column's share of epoch 0's batches: the first one off 16-byte
          alignment beside its aligned twin, and the last batch's), with a
          summary of each misaligned row's device time over
          its twin's and each row's time over the library's; and K1 at
          K = 144 and K4 at K = 44 on 66,667 against 66,672 cells;
  kernel_wide  every large-K route (K > 512: kernels.route) against its
          plain version: K1 with and without counts, K2, P1, P2 on int8,
          bf16, int16 and float32 X at K = 513, 600, 768, 1024, 2048 on 70
          genes x 17, 1,001 and 5,040 cells (int8 also at a 1-byte offset),
          K3 on its per-step path there and the large-K product alone
          (wtw_gemm's store), each launched twice (bit for bit), and the
          per-step path called directly at K = 40, 300 and 512 bit for bit
          the register and tiled paths (one summary line); then rows at the
          bench shape, K = 768: K1, K4, K2 (int8) and K1 on float32 and on
          int16 X (counts x 3), the
          chain's D = WᵀW H alone (wtw_gemm), K3 (50 steps), with the card's
          ms of each kernel
          they launch, P1 and P2 (int8: the wgmma kernels hxt_wide and
          wtx_wide) at K = 520, 768, 1024 and 2048 and P2 at k = 384; P1
          and P2 on float32 and int16 X (the FP32 kernels hxt_fma_wide and
          wtx_fma_wide) at K = 768, on float32 also at 1024 and 2048, and
          at K = 768 on 66,667 cells beside their 66,672-cell twins
          (their bits checked), beside fp32 torch.matmul (TF32 off; int16
          through a float32 copy); and
          P1/P2 at K = 768 on the minibatch's 8,192 cells and on 66,667
          cells beside a 66,672-cell twin (zero cells added: its bits
          checked), each with every output against the plain version's, a
          second launch bit for bit, its time, bound, plain and library
          time (bf16 cuBLAS X products with fp32 (WᵀW)H and H Hᵀ; fp32
          torch.matmul for wtw_gemm, 50 of them for K3; bf16 torch.matmul
          for P1/P2, with the card's
          µs of a call beside the library's) and grid;
  stream_probe  the streaming probe's entry point (alpine_tpu_torch/
          probe.py) on int8 and float32 X at the bench shape: ms and GB/s
          read, the fold and column sums checked exactly against the plain
          version, torch.sum beside it;
  fit_loop  the fused fit loop alone on device-resident bench data: ms
          per iteration, device busy share and device time per kernel
          (profiler); then the same for the weighted_fast loop
          (fit_loop_weighted_fast, the sampler's draws included), for
          the ALS loop (fit_loop_als, 50 iterations) and for 3 epochs of
          8,192-cell minibatches, joint and ALS (fit_loop_minibatch,
          fit_loop_minibatch_als: "iterations" are epochs); then, on int16 X
          holding counts above 127, the ALS loop (fit_loop_als_int16: the
          fp32 X passes), the joint loop (fit_loop_int16: K1's fp32 path),
          the weighted_fast loop (fit_loop_weighted_fast_int16: K4's) and
          the unguided loop (fit_loop_unguided_int16: K2's), and on float32
          X the ALS loop (fit_loop_als_float32) and the joint loop
          (fit_loop_float32), each with the launch counts of its timed run;
          and the full-batch loop at K = 768 (fit_loop_k768, blocks (192,
          192, 384): K1's large-K chain), also on int16 X (counts x 3:
          fit_loop_k768_int16, the chain's fp32 X passes);
  small   a small fit on the card against the same fit on the CPU (plain
          kernel versions, same seed); small_als the same with
          use_als=True;
  slice   ALPINE(n_components=30, n_covariate_components=[5, 5]).fit(...,
          max_iter=50) and .transform() (through the fit's device X) on
          100k x 2,000 Poisson counts (int8), with the launch counts read
          around it;
  slice_persist  the slice's model fit and transformed on the first
          20,000 cells (cut: the file holds X as float32, whose compression
          took 85 s at 100k cells), saved (compressed NPZ, the JAX
          package's format), loaded onto the card, its uncached transform
          (one K3 launch) held against the fitted model's own (the same
          bits, or K3's plain tolerance), the export on the card
          (get_normalized_expression's default, checked to run its
          products on the card) against the host's (on_device=False),
          then write_h5ad and read_h5ad in full and by a range of cells,
          bit for bit (where h5py and pandas are installed; the phase
          says so where they are not), with the seconds of each step, the
          file sizes, peak device memory and K3's launches;
  slice_sharded  the slice's fit and transform over a cell mesh
          (alpine_tpu_torch.parallel.distributed): one process (NCCL, this
          one), then 2 and 3 gloo ranks spawned on the same card, each
          memory-mapping its run of the cells from one file (50,000 each;
          33,334 / 33,333 / 33,333 for 10 iterations); world 1 must be the
          slice bit for bit, worlds 2 and 3 within loss rtol 5e-4 of the
          slice's, embeddings within 5e-3 (relative Frobenius) of one
          device's fit of as many iterations, transforms within rtol 1e-5
          of one device's with rank 0's W, W and the losses bit-equal
          across the ranks, one all-reduce an iteration of the same bytes
          in every world; each rank prints a slice_sharded_rank line
          (cells, seconds, device ms an iteration, launches, all-reduce
          calls, bytes and ms).  Ranks
          share one card: no time here is a multi-GPU speed;
  slice_sharded_modes  the other fit modes over a cell mesh (the slice's
          model, int8 named): one device's weighted_fast (20 iterations),
          ALS (10) and ALS "weighted" (10 epochs of 8,192 draws) fits,
          then those and the ALS minibatch and "weighted" fits (10 epochs
          of 8,192, bit for bit slice_minibatch_als and slice_weighted) on
          one NCCL process (this one), bit for bit; then 2 gloo ranks
          spawned on the card (50,000 cells each), each fitting
          weighted_fast (its first draws concatenated must be one
          device's; a cached transform after, against the uncached one),
          ALS, 5 epochs of random minibatch and of tiled batches of 8,192
          (finite, falling losses; one P1 and one P2 launch a batch, P2
          once more an epoch), the three global-draw fits (ALS minibatch,
          "weighted", ALS "weighted": each rank its share of every batch
          of the single-device epoch; P1 once and P2 once a block for a
          non-empty share, P2 once an epoch; nb · blocks + 1 all-reduces
          an epoch; a weighted fit's one gather of the label codes), the
          modes with a one-device reference within loss rtol 5e-4 and H
          relative Frobenius 5e-3 of it, and a weighted_fast fit with a
          snapshot every 5 iterations of 10, interrupted after the first
          and resumed (bit for bit the uninterrupted one); every cell's H
          changed by each fit (but the gathered weighted ones, which leave
          undrawn cells alone), the launches of K4/P1/P2/K3 and the
          all-reduces counted from zero in every world, W, the Bs and the
          losses bit-equal across the ranks; each rank prints a
          slice_sharded_modes_rank line a mode (seconds, device ms an
          iteration or epoch, launches, all-reduce calls, bytes and ms; a
          global-draw fit its shares of every batch and its empty ones, a
          weighted one the label gather's bytes and ms); then K4 alone at
          50,000 cells and at 50,001 (rows off 16-byte alignment) beside
          its twin 50,016;
  slice_gene_cell  the slice's model (int8 named) over ("genes", "cells")
          grids of processes (distributed.global_gene_cell_mesh), 10
          iterations a fit: a 1 x 1 grid on one NCCL process (this one)
          fits joint, ALS, weighted_fast and minibatches of 8,192 from the
          global draw, random, ALS and "weighted" (10 epochs: P1 13 and P2
          14 times an epoch, ALS 40; also bit for bit the single-device
          estimator's fits: slice_minibatch, slice_minibatch_als and
          slice_weighted), each bit for bit
          the step loop (mu._fit_scan_steps) called directly on its inputs
          on one device, P1/P2 only (no K1/K4), the joint fit's losses
          beside the slice's K1 fit, and a transform (one K3), and a joint
          fit with a snapshot every 5 iterations, interrupted after the
          first and resumed by a fresh model, bit for bit its joint fit;
          then 4 gloo ranks spawned on the card as a 2 x 2 grid (1,000
          genes x 50,000 cells a rank: the cells of its column, every
          gene, memory-mapped from one file) run the three full-batch
          modes, 5 epochs of each minibatch mode from the global draw
          (each rank its column's share of every batch), a transform and
          the checkpointed joint and "weighted" fits (the weighted one 5
          epochs with a snapshot every 2; snapshots a rank in one
          directory, the resume on every rank, bit for bit the
          uninterrupted checkpointed fit), and 2 ranks as a 2 x 1 grid (1,000 x
          100,000 a rank) the joint fit; each rank prints a
          slice_gene_cell_rank line a mode (coordinates, genes, cells,
          device ms an iteration or epoch, launches, all-reduce calls,
          bytes and ms an iteration over each axis, whether its W, H and
          Bs are bit-equal to its replicas', its loss gap to world 1; a
          minibatch fit its shares of every batch and its empty ones, a
          weighted fit the label gather's bytes and ms) and a line for
          each checkpointed fit (snapshot seconds and bytes);
          checked: launches, one genes all-reduce of K x (local cells + K)
          values an iteration (ALS n_blocks + 1; a minibatch epoch nb + 1
          over each axis, ALS nb · n_blocks + 1, the bytes from the
          shares), replicas, losses
          rtol 5e-4 and (full batch) H relative Frobenius 5e-3 against
          world 1, the resumed fits, transforms at rtol
          1e-6 against one device's K3 on the same gene-block sums of 2WᵀX
          and 2WᵀW (their bits reported) and within 1e-4 (relative
          Frobenius) of the unsplit projection.  Ranks
          share the card: no time here is a multi-GPU speed;
  slice_unguided  an unguided fit (no covariates) for fused_h_update's
          path;
  slice_weighted_fast  the same fit with sampling_method="weighted_fast",
          a transform through the fit's group-sorted device X, then
          free_device_cache() and the uncached transform;
  slice_als  the same fit with use_als=True (hxt once and wtx three times
          an iteration, fused_iteration never) and a cached transform;
  slice_minibatch, slice_minibatch_als, slice_weighted, slice_tiled  (run
          after slice, before the mesh phases, whose references they are)
          fits of 10 epochs with batch_size=8192 (13 batches an epoch): random
          minibatch joint, the same with use_als=True,
          sampling_method="weighted" (balanced draws with replacement) and
          sampling_method="tiled" (64 whole 128-cell tiles a batch of 782,
          96 pad columns, ms an epoch beside slice_minibatch's, and a
          transform through the padded, shuffled device X against the
          uncached one); each checks the launches of hxt (one a batch) and
          wtx (one a batch, ALS one a block, and one an epoch for the loss),
          finite losses, a falling reconstruction loss, and peak device
          memory at most the slice's and under a float32 copy of X;
  slice_bucket  the slice's fit with component_bucket=8: fused_iteration
          at K = 48 once an iteration, true-sized stored matrices, one K3
          launch at K = 40; then mu.fit_scan on the fit's device X from
          masked inits, whose phantom components must stay exactly zero;
  slice_restarts  the slice's fit with n_restarts=3: fused_iteration 150
          times, X uploaded once, restart 0 the slice's loss history bit
          for bit, the winner no worse;
  slice_checkpoint  the slice's fit with a snapshot every 10 iterations,
          interrupted after the second and resumed by a fresh model: its
          loss history against the slice's (rtol 1e-4), seconds and bytes
          a snapshot, the snapshot gone after success;
  slice_k100  ALPINE(n_components=90, n_covariate_components=[5, 5]) (K =
          100: fused_transform's tiled path), a 5-iteration fit and a
          50-step transform through the fit's device X;
  slice_k768  ALPINE(n_components=384, n_covariate_components=[192, 192])
          (K = 768, the JAX package's bucket level) fit 20 iterations and
          transformed 50 steps at 100k x 2,000 (int8): K1 20, P1 1, K3 1
          launches, finite falling losses, cached = uncached transform;
          then the same model on the first 5,000 cells on the card against
          the CPU (plain versions) at the small phase's tolerances;
  slice_k768_int16  the same model on the counts x 5 (some above 127, so
          data_dtype "auto" resolves to int16): fit 10 iterations and a
          50-step transform at 100k x 2,000: K1 10, P1 1, K3 1 launches,
          hxt_fma_wide 11 and wtx_fma_wide 10 (P1's first X Hᵀ, and the
          chain's X Hsᵀ and WᵀX in every K1 call), finite falling losses,
          cached = uncached transform; the first 5,000 cells fit on the
          card and on the CPU at slice_k768's tolerances;
  slice_k768_modes  K = 768 on the first 20,000 cells, 5 iterations each:
          unguided (K2), weighted_fast (K4), use_als=True (P1 at K = 768,
          P2 a block) and random minibatch of 8,192 (P1 and P2 at K = 768),
          launch counts and finite losses;
  slice_optimize  ComponentOptimizer(adata, ["batch", "condition"],
          max_iter=50, random_state=0) with its defaults (the card, fold
          batching, auto bucketing, int8), search_hyperparams((10, 100),
          n_splits=3, max_evals=4) and fit_the_best_param(): seconds of the
          fold-data build and of each trial split into fits, transforms,
          kNN, graph and Leiden, each trial's blocks and score, K1 and K3
          launches, the Leiden backend (must be "native"), peak device
          memory; pad columns of H exactly zero after every fold fit, one
          fold's K3 output against the plain projection, one fold's kNN on
          the card against the float64 host search (rows that differ
          counted), and one trial again through the sequential route
          (fold_batching=False) with its score and seconds; K1 at the
          largest trial's fold shape gets a kernel row, and K3 a row for
          each path the search launched (register, tiled), at the
          validation shape and the largest K that took that path;
  slice_optimize_paths  one calc_score each at max_iter=10 with frozen
          parameters: weighted_fast folds (K4, and its kernel row at the
          fold shape), ALS folds (P1/P2, their rows at the fold shape) and
          tiled folds of 8,192-cell batches (P1/P2 on slabs);
  slice_optimize_sharded  ComponentOptimizer over a cell mesh with
          slice_optimize's settings: one NCCL process (this one) runs the
          first 2 trials, bit for bit slice_optimize's; then 2 gloo ranks
          spawned on the card, each memory-mapping all the cells, run 2
          rounds of 2 trials (each rank fits and scores its own trials,
          one loss a trial exchanged) and fit_the_best_param: the trials,
          best parameters and refit losses equal on both ranks, the points
          slice_optimize's, K1 and K3 launched on each rank for its own
          trials, one of rank 1's trials against this process's calc_score
          of its point (atol 1e-6); then a max_iter=None search of 3 trials
          on the first 20,000 cells (cut; a replicated round, then a
          parallel one); a slice_optimize_sharded_rank line for each rank
          (seconds a trial, local evaluations, the exchange's ms a round
          and alone).  Ranks share the card: no time here is a multi-GPU
          speed;
  slice_optimize_grid  ComponentOptimizer on a 2 x 2 ("genes", "cells")
          grid: 4 gloo ranks spawned on the card, each memory-mapping all
          the cells: (a) slice_optimize's search of 4 trials, each fold fit
          whole on the card of its owner (fold f on rank f mod 4: K1 and
          K3 there only), the scores exchanged, the trials slice_optimize's
          bit for bit; (b) a max_iter=None search of 3 trials on the first
          20,000 cells, whose first trial's folds are grid fits (P1/P2 on
          each rank's block of 1,000 genes x its column's share of the
          fold, the validation embedding gathered for the fold's scorer),
          its first-trial loss beside slice_optimize_sharded's
          single-device one; (c) the refit of (a)'s best parameters, a grid
          fit of all cells (P1/P2, no K1), its loss within rtol 5e-4 of
          slice_optimize's refit; trials, max_iter and the refit's W and
          losses bit-equal on every rank, no rank on the CPU; a
          slice_optimize_grid_rank line for each rank (seconds, fold fits
          and scoring a trial, the embedding gathers' and score exchange's
          bytes and ms, the exchange alone, launches of K1, K3, P1, P2).
          Ranks share the card: no time here is a multi-GPU speed.
The fit_loop phases include fit_loop_tiled (3 tiled epochs) with the
device time of the batches' copies beside fit_loop_minibatch's.
Then one JSON line with every kernel's numbers (fused_transform twice: its
register path at K = 40 with the launches of slice, its tiled path at
K = 100 with those of slice_k100; hxt and wtx at the minibatch shape with
the per-batch launches of slice_minibatch, and wtx at the loss's full shape
with its once-an-epoch launches; hxt and wtx on a tiled batch's slab with
slice_tiled's launches; fused_iteration at slice_bucket's K = 48; hxt and
wtx twice more: their fp32 paths hxt_fma and wtx_fma on float32 and on
int16 X, with the launches of the ALS loop on that X; K1, K4 and K2 again
on their fp32 path, with the launches of the float32/int16 joint,
weighted_fast and unguided loops; K1, K3 (a row per path), K4, hxt and
wtx at the optimizer's fold shapes with the launches of slice_optimize and
slice_optimize_paths; K1 and K3 again with world 2's launches of
slice_optimize_sharded, and with the 2 x 2 grid's of slice_optimize_grid,
at the same folds; hxt and wtx at a grid rank's block of
slice_optimize_grid's sequential folds and of its refit; hxt, wtx and fused_transform
at a 2 x 2 grid's block, 1,000 genes x 50,000 cells, with the four ranks'
launches of slice_gene_cell; the large-K routes at K = 768 (kernel_wide's
bench rows) with the launches of slice_k768 and slice_k768_modes, and K1,
hxt_fma_wide and wtx_fma_wide on int16 X with those of slice_k768_int16;
hxt and wtx at a 2 x 2 grid rank's share of
a minibatch batch with the four ranks' minibatch launches; hxt and wtx (k =
5, 30 and 40) at the shares of the global-draw fits, a cell mesh rank's
(2,000 genes, world 2 of slice_sharded_modes) and a 2 x 2 grid rank's, ALS
and weighted apart, and wtx at a world-2 rank's 50,000 cells for those
fits' losses; their timings are kernel_twin rows measured after the mesh
phases at rank 0's shares of the fits' first epochs, an ALS share beside
its aligned twin) and, last, the
result line
{"ok": true, "device": {...}}.  slice_persist's line says in "h5ad_run"
whether its .h5ad round trip ran.
Any failed check raises: the script exits non-zero and prints no result.
Without a GPU it exits with code 2 before doing anything.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

G, N = 2000, 100_000
BLOCKS, N_LABELS = (5, 5, 30), (2, 3)
BUCKET_BLOCKS = (8, 8, 32)  # BLOCKS under component_bucket=8
TILE = 128  # tiled sampling's tile (alpine_tpu_torch.ops.mu.DEFAULT_TILE)
TRANSFORM_ITERS = 50
FIT_ITERS = 50
LOOP_ITERS = 10
ALS_LOOP_ITERS = 50
# minibatch phases: the JAX package's minibatch bench batch
# (benchmarks/gather_floor.py:57), 13 batches an epoch at N cells
MB_BATCH = 8192
MB_EPOCHS = 10
MB_LOOP_EPOCHS = 3  # the profiled minibatch loops (fit_loop_minibatch*)
EPS = 1e-6
# published dense peaks (NVIDIA data sheets): bytes/s, bf16 flop/s, fp32
# flop/s outside the tensor cores
PEAKS = {"H100 PCIe": (2.0e12, 756e12, 51e12),
         "H100 NVL": (3.9e12, 835e12, 60e12),
         "H100": (3.35e12, 989e12, 67e12)}
REPLACES = {
    "fused_iteration": "alpine_tpu/ops/pallas_kernels.py:637",
    "fused_iteration_counts": "alpine_tpu/ops/pallas_kernels.py:637 (counts)",
    "fused_h_update": "alpine_tpu/ops/pallas_kernels.py:361",
    "fused_transform": "alpine_tpu/ops/pallas_kernels.py:806",
    "hxt": "benchmarks/als_probe.py:172",
    "wtx": "benchmarks/als_probe.py:180",
    "stream_probe": "benchmarks/envelope_probe.py:129",
    # the large-K chain's statistics against Hn: fused_iteration's H_stat
    # contractions (HHt_ref, HHtU_ref, rowsum_Hn, bnum_all)
    "gram_wide": "alpine_tpu/ops/pallas_kernels.py:584",
    # the large-K chain's denominator: fused_iteration's WtW H product
    "wtw_gemm": "alpine_tpu/ops/pallas_kernels.py:500",
}
SOURCES = {
    "fused_iteration": "alpine_tpu_torch/csrc/fused_iteration.cu",
    "fused_iteration_counts": "alpine_tpu_torch/csrc/fused_iteration.cu",
    "fused_h_update": "alpine_tpu_torch/csrc/fused_iteration.cu",
    "fused_transform": "alpine_tpu_torch/csrc/fused_transform.cu",
    "hxt": "alpine_tpu_torch/csrc/x_passes.cu",
    "wtx": "alpine_tpu_torch/csrc/x_passes.cu",
    "stream_probe": "alpine_tpu_torch/csrc/stream_probe.cu",
    "gram_wide": "alpine_tpu_torch/csrc/gram_wide.cuh",
    "wtw_gemm": "alpine_tpu_torch/csrc/wtw_gemm.cuh",
}
# mangled names of fused_iteration.cu's passes: iter_tiles<X type, kBf16,
# kCounts>, hxt_partial<X type, kCounts> (the bf16 path only)
PASS_NAME = re.compile(r"(iter_tiles)I(\w+?)Lb([01])ELb([01])E|(hxt_partial)I(\w+?)Lb([01])E")
# the fp32 X passes: <X type, rows a thread>; and the bf16 ones: <X type,
# ring chunk or cell groups, X rows aligned>
FMA_NAME = re.compile(r"(hxt_mma|hxt_fma|wtx_mma|wtx_fma)I(\w+?)(?:Li(\d+)E)?(?:Lb([01])E)?E")
# the wgmma X passes above K = 512: <X type, X rows aligned, cluster size>
WIDE_NAME = re.compile(r"(hxt_wide|wtx_wide)I(\w+?)Lb([01])ELi(\d+)EE")
# the fp32 X passes above K = 512: <X type, X rows aligned>
FMA_WIDE_NAME = re.compile(r"(hxt_fma_wide|wtx_fma_wide)I(\w+?)Lb([01])EE")
X_CODES = {"f": "float32", "13__nv_bfloat16": "bfloat16", "a": "int8", "s": "int16"}
# mangled names of fused_transform.cu's register path, transform_columns<KB>,
# and of its tiled path, transform_tiles<T, G> (T cells a tile, G pairs of
# rows a thread)
COLUMNS_NAME = re.compile(r"transform_columnsILi(\d+)E")
TILES_NAME = re.compile(r"transform_tilesILi(\d+)ELi(\d+)E")

# the script's start (set by main; spawned ranks leave it unset)
_T0 = None


def emit(obj):
    """One JSON line, written in one call, so that the lines of ranks
    printing at once do not run together.  A phase's line printed by the
    script's own process carries the seconds since the script started
    ("script_seconds")."""
    if _T0 is not None and "phase" in obj:
        obj = dict(obj, script_seconds=time.perf_counter() - _T0)
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), (json.dumps(obj) + "\n").encode())


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def peaks(name):
    for key, val in PEAKS.items():
        if key in name:
            return val
    return PEAKS["H100"]


def time_ms(fn, reps):
    """Median CUDA-event time of `reps` warm calls (ms)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_back_to_back_ms(fn, calls, reps=3):
    """CUDA-event time of `calls` back-to-back calls over `calls`, the
    median of `reps` (ms): the host enqueues ahead of the card, so its own
    time per call is hidden where it is shorter than the card's."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def compare(got, want, rtol, atol_scale):
    """Max abs error, and the worst error over its allowance
    (atol_scale * max|want| + rtol * |want|): passes when <= 1."""
    got, want = got.double(), want.double()
    atol = atol_scale * float(want.abs().max()) + 1e-30
    err = (got - want).abs()
    return float(err.max()), float((err / (atol + rtol * want.abs())).max())


def ptxas_usage(log):
    """{mangled kernel: {"registers", "spill_stores"}} from nvcc's ptxas -v
    report."""
    usage, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )"
                      r"([\w$]+)", line)
        if m:
            fn = m.group(1)
            usage.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            usage[fn]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn]["registers"] = int(m.group(1))
    return usage


def sass_counts(_build, name, opcodes):
    """{mangled kernel: {opcode: number of its instructions}} in the SASS of
    the built library of csrc/<name>.cu (cuobjdump)."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(_build._lib_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = dict.fromkeys(opcodes, 0)
        elif fn is not None:
            for op in opcodes:
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
    return counts


def sass_check(_build, kernels):
    """Which instantiations of fused_iteration's two passes run on tensor
    cores: HMMA instructions in the SASS of the built library (cuobjdump)
    for int8/bf16 X and none for float32/int16, and no spill stores on the
    tensor-core path (ptxas -v).  For fused_transform's register path, one
    instantiation per bucket with no spill stores, and at least K² FFMA in
    the K = 40 bucket (its step's sums, each a FFMA of its own); the counts
    of shared loads, shuffles and MUFU (the division's reciprocal) beside
    them give the instruction mix of a step.  Its tiled path: one
    instantiation per (T, KP) of the wrapper's rule, no spill stores, at
    most 128 registers where two blocks share an SM, cp.async copies
    (LDGSTS, its ring) and at least 8 × 16 G FFMA (8 unrolled rows of a
    chunk, G pairs of rows × 8 cells each)."""
    usage = ptxas_usage(_build.build_log("fused_iteration"))
    rows, k1_fma = [], []
    ops = ("HMMA", "LDGSTS", "FFMA")
    for fn, count in sorted(sass_counts(_build, "fused_iteration", ops).items()):
        m = PASS_NAME.search(fn)
        u = usage.get(fn, {})
        if m and m.group(1):
            kernel, x, bf16, counts = m.group(1, 2, 3, 4)
        elif m:
            kernel, x, bf16, counts = m.group(5), m.group(6), "1", m.group(7)
        else:
            f = FMA_NAME.search(fn)
            if f:
                k1_fma.append({"kernel": f.group(1), "x": X_CODES.get(f.group(2), f.group(2)),
                               "rows": int(f.group(3)),
                               **{op.lower(): count[op] for op in ops},
                               "registers": u.get("registers"),
                               "spill_stores": u.get("spill_stores")})
            continue
        rows.append({"kernel": kernel, "x": X_CODES.get(x, x),
                     "counts": counts == "1", "tensor_core_path": bf16 == "1",
                     "hmma": count["HMMA"], "registers": u.get("registers"),
                     "spill_stores": u.get("spill_stores")})
    usage = ptxas_usage(_build.build_log("fused_transform"))
    trows = []
    ops = ("FFMA", "LDS", "LDGSTS", "SHFL", "MUFU", "HMMA")
    for fn, count in sorted(sass_counts(_build, "fused_transform", ops).items()):
        m, t = COLUMNS_NAME.search(fn), TILES_NAME.search(fn)
        u = usage.get(fn, {})
        T, G = (int(t.group(1)), int(t.group(2))) if t else (None, None)
        trows.append({"kernel": ("transform_columns" if m else "transform_tiles" if t
                                 else "wtw_gemm" if "wtw_gemm" in fn
                                 else "wtw_transpose" if "wtw_transpose" in fn
                                 else "pad_transpose"),
                      "bucket": int(m.group(1)) if m else None, "T": T,
                      "KP": 2 * kernels._THREADS // (T // 8) * G if t else None,
                      "row_pairs": G,
                      **{op.lower(): count[op] for op in ops},
                      "registers": u.get("registers"),
                      "spill_stores": u.get("spill_stores")})
    emit({"phase": "sass", "functions": rows, "fused_iteration_fp32_passes": k1_fma,
          "fused_transform": trows})
    # iter_tiles on four X types with and without counts, hxt_partial on two
    check(len(rows) == 12, f"expected 12 pass instantiations, found {len(rows)}")
    for r in rows:
        tag = f"{r['kernel']} {r['x']} counts={r['counts']}"
        check((r["hmma"] > 0) == r["tensor_core_path"],
              f"{tag}: HMMA count {r['hmma']} does not fit its path")
        if r["tensor_core_path"]:
            check(r["spill_stores"] == 0, f"{tag}: spill stores {r['spill_stores']}")
    xrows, wide, wgmma, gram = [], [], [], []
    usage = ptxas_usage(_build.build_log("x_passes"))
    ops = ("HMMA", "LDGSTS", "LDSM", "FFMA", "HGMMA", "UTMALDG")
    fma_wide = []
    for fn, count in sorted(sass_counts(_build, "x_passes", ops).items()):
        fw = FMA_WIDE_NAME.search(fn)
        if fw:  # hxt_fma_wide / wtx_fma_wide
            u = usage.get(fn, {})
            fma_wide.append({"kernel": fw.group(1), "x": X_CODES.get(fw.group(2), fw.group(2)),
                             "aligned": fw.group(3) == "1",
                             **{op.lower(): count[op] for op in ops},
                             "registers": u.get("registers"),
                             "spill_stores": u.get("spill_stores")})
            continue
        w = WIDE_NAME.search(fn)
        if w:  # hxt_wide / wtx_wide
            u = usage.get(fn, {})
            wgmma.append({"kernel": w.group(1), "x": X_CODES.get(w.group(2), w.group(2)),
                          "aligned": w.group(3) == "1", "cluster": int(w.group(4)),
                          **{op.lower(): count[op] for op in ops},
                          "registers": u.get("registers"),
                          "spill_stores": u.get("spill_stores")})
            continue
        # <X type>, and hxt_mma's ring chunk, wtx_mma's 16-cell groups a warp
        # or the fp32 kernels' rows a thread (MK); the bf16 kernels' third
        # argument: X's rows on 16-byte boundaries, or not (aligned windows)
        m = FMA_NAME.search(fn)
        if "gram_wideILb" in fn:  # gram_wide<kCounts>
            u = usage.get(fn, {})
            gram.append({"kernel": "gram_wide", "counts": "gram_wideILb1E" in fn,
                         **{op.lower(): count[op] for op in ops},
                         "registers": u.get("registers"),
                         "spill_stores": u.get("spill_stores")})
            continue
        if not m and ("iter_wide" in fn or "wtw_gemm" in fn):  # the large-K chain's own
            u = usage.get(fn, {})
            wide.append({"kernel": "iter_wide" if "iter_wide" in fn else "wtw_gemm",
                         "mangled": fn, **{op.lower(): count[op] for op in ops},
                         "registers": u.get("registers"),
                         "spill_stores": u.get("spill_stores")})
        if m:
            u = usage.get(fn, {})
            arg = int(m.group(3)) if m.group(3) else None
            xrows.append({"kernel": m.group(1), "x": X_CODES.get(m.group(2), m.group(2)),
                          "chunk": arg if m.group(1) == "hxt_mma" else None,
                          "cell_groups": arg if m.group(1) == "wtx_mma" else None,
                          "rows": arg if m.group(1).endswith("_fma") else None,
                          "aligned": m.group(4) == "1" if m.group(4) else None,
                          **{op.lower(): count[op] for op in ops},
                          "registers": u.get("registers"),
                          "spill_stores": u.get("spill_stores")})
    notes = sorted({m.group(1) for m in re.finditer(r"\((C75\d\d)\)",
                                                    _build.build_log("x_passes"))})
    emit({"phase": "sass", "x_passes": xrows, "x_passes_wide": wide, "wgmma_passes": wgmma,
          "fma_wide_passes": fma_wide, "gram_wide": gram, "wgmma_ptxas_notes": notes})
    # ptxas's performance notes (C75xx: wgmma serialized, setmaxnreg ignored)
    check(not notes, f"x_passes: ptxas performance notes {notes}")
    # hxt_wide and wtx_wide on int8 and bf16 X, rows aligned or not, at the
    # cluster size of the grid rules: wgmma (HGMMA), TMA loads of the
    # Hb / Wb tiles (and of X where its rows are aligned, else the windows'
    # cp.async), wtx's ldmatrix on the aligned tile, no spill store
    check(sorted((r["kernel"], r["x"], r["aligned"], r["cluster"]) for r in wgmma)
          == sorted((k, x, a, kernels._WIDE_CL[k[:3]]) for k in ("hxt_wide", "wtx_wide")
                    for x in ("int8", "bfloat16") for a in (False, True)),
          f"the wgmma passes' instantiations differ from the wrapper's: {len(wgmma)}")
    for r in wgmma:
        tag = f"{r['kernel']} {r['x']} aligned={r['aligned']}"
        check(r["hgmma"] > 0 and r["hmma"] == 0, f"{tag}: HGMMA {r['hgmma']}, HMMA {r['hmma']}")
        check(r["utmaldg"] >= (2 if r["aligned"] else 1), f"{tag}: UTMALDG {r['utmaldg']}")
        check(r["aligned"] or r["ldgsts"] > 0, f"{tag}: no cp.async (LDGSTS) for the windows")
        check(r["kernel"] == "hxt_wide" or not r["aligned"] or r["ldsm"] > 0,
              f"{tag}: no ldmatrix (LDSM)")
        check(r["spill_stores"] == 0, f"{tag}: spill stores {r['spill_stores']}")
    # hxt_fma_wide and wtx_fma_wide on float32 and int16 X, rows aligned or
    # not: true fp32 (no HMMA), a ring chunk of 8 x 8 outputs a thread
    # unrolled (64 FFMA a reduction value), cp.async into the ring (LDGSTS),
    # at most 128 registers (two blocks an SM), no spill store
    check(sorted((r["kernel"], r["x"], r["aligned"]) for r in fma_wide)
          == sorted((k, x, a) for k in ("hxt_fma_wide", "wtx_fma_wide")
                    for x in ("float32", "int16") for a in (False, True)),
          f"the fp32 large-K passes' instantiations differ: {len(fma_wide)}")
    for r in fma_wide:
        tag = f"{r['kernel']} {r['x']} aligned={r['aligned']}"
        check(r["hmma"] == 0 and r["ffma"] >= 64 * kernels.wtw_design()["chunk"]
              and r["ldgsts"] > 0,
              f"{tag}: HMMA {r['hmma']}, FFMA {r['ffma']}, LDGSTS {r['ldgsts']}")
        check(r["registers"] is not None and r["registers"] <= 128 and r["spill_stores"] == 0,
              f"{tag}: {r['registers']} registers, spill stores {r['spill_stores']}")
    # gram_wide with and without counts: true fp32 on the FP32 units (no
    # HMMA), a chunk of 8 cells unrolled (8 x 64 FMAs a thread; counts mode
    # 8 x 128), no spill store
    check(sorted(r["counts"] for r in gram) == [False, True],
          f"expected gram_wide with and without counts, found {len(gram)}")
    for r in gram:
        tag = f"gram_wide counts={r['counts']}"
        check(r["spill_stores"] == 0 and r["hmma"] == 0,
              f"{tag}: spill stores {r['spill_stores']}, HMMA {r['hmma']}")
        check(r["ffma"] >= (1024 if r["counts"] else 512), f"{tag}: {r['ffma']} FFMA")
    # iter_wide on four Y types with and without counts, wtw_gemm's store
    # epilogue (and, in fused_transform, its update), each with 16- and
    # 4-byte copies: true fp32 (no HMMA), no spill store
    check(sum(r["kernel"] == "iter_wide" for r in wide) == 8
          and sum(r["kernel"] == "wtw_gemm" for r in wide) == 2,
          f"expected 8 iter_wide and 2 wtw_gemm in x_passes, found {len(wide)}")
    gemms = [r for r in wide + trows if r["kernel"] == "wtw_gemm"]
    check(len(gemms) == 4, f"expected wtw_gemm's store and update twice, found {len(gemms)}")
    for r in wide + gemms:
        check(r["spill_stores"] == 0 and r["hmma"] == 0,
              f"{r['kernel']}: spill stores {r['spill_stores']}, HMMA {r['hmma']}")
        if r["kernel"] == "wtw_gemm":
            # a chunk of the ring (kGemmBK values of j) unrolled, 8 x 8
            # outputs a thread; both operands by cp.async (LDGSTS) into the
            # ring; two blocks an SM
            check(r["ffma"] >= 64 * kernels.wtw_design()["chunk"] and r["ldgsts"] > 0
                  and r["registers"] is not None and r["registers"] <= 128,
                  f"wtw_gemm: {r['ffma']} FFMA, {r['ldgsts']} LDGSTS, "
                  f"{r['registers']} registers")
    # hxt_fma<XT, 1 .. _FMA_MAX_MK + 1> (8 rows only past K = 448), wtx_fma<XT, 1 .. 6>
    fma_rows = {"hxt_fma": kernels._FMA_MAX_MK + 1, "wtx_fma": kernels._WTX_FMA_MAX_MK}
    n_fma = 2 * sum(fma_rows.values())
    # hxt_mma<XT, chunk, aligned>, wtx_mma<XT, cell groups, aligned> on int8 and bf16 X
    n_mma = 4 * (len(kernels._HXT_CHUNKS) + len(kernels._WTX_GROUPS))
    check(len(xrows) == n_mma + n_fma,
          f"expected {n_mma + n_fma} x_passes kernels, found {len(xrows)}")
    check(sorted((r["chunk"], r["aligned"]) for r in xrows if r["kernel"] == "hxt_mma")
          == sorted(2 * [(c, a) for c in kernels._HXT_CHUNKS for a in (False, True)]),
          "hxt_mma's chunks differ from the wrapper's")
    check(sorted((r["cell_groups"], r["aligned"]) for r in xrows if r["kernel"] == "wtx_mma")
          == sorted(2 * [(c, a) for c in kernels._WTX_GROUPS for a in (False, True)]),
          "wtx_mma's cell groups differ from the wrapper's")
    for kname, most in fma_rows.items():
        check(sorted(r["rows"] for r in xrows if r["kernel"] == kname)
              == sorted(2 * list(range(1, most + 1))), f"{kname}'s rows differ from the wrapper's")
    for r in xrows:
        tag = f"x_passes {r['kernel']} {r['x']} {r['rows'] or ''}"
        check((r["hmma"] > 0) == r["kernel"].endswith("_mma"),
              f"{tag}: HMMA count {r['hmma']}")
        # every kernel streams X through a cp.async ring and must not spill
        check(r["ldgsts"] > 0, f"{tag}: no cp.async (LDGSTS)")
        check(r["spill_stores"] == 0, f"{tag}: spill stores {r['spill_stores']}")
        if r["kernel"] == "wtx_mma":  # operands by ldmatrix
            check(r["ldsm"] > 0, f"{tag}: no ldmatrix (LDSM)")
        if r["kernel"].endswith("_fma"):  # the FP32 units
            check(r["ffma"] >= 8 * r["rows"], f"{tag}: {r['ffma']} FFMA")
    # fused_iteration's copies of the fp32 X passes (fma_passes.cuh): the same
    # instantiations, FFMA and LDGSTS, no HMMA, no spill, x_passes' registers
    check(sorted((r["kernel"], r["x"], r["rows"]) for r in k1_fma)
          == sorted((r["kernel"], r["x"], r["rows"]) for r in xrows
                    if r["kernel"].endswith("_fma")),
          "fused_iteration's fp32 X passes differ from x_passes'")
    x_regs = {(r["kernel"], r["x"], r["rows"]): r["registers"] for r in xrows}
    for r in k1_fma:
        tag = f"fused_iteration {r['kernel']} {r['x']} {r['rows']}"
        check(r["hmma"] == 0 and r["ldgsts"] > 0 and r["ffma"] >= 8 * r["rows"],
              f"{tag}: HMMA {r['hmma']}, LDGSTS {r['ldgsts']}, FFMA {r['ffma']}")
        check(r["spill_stores"] == 0, f"{tag}: spill stores {r['spill_stores']}")
        check(r["registers"] == x_regs[(r["kernel"], r["x"], r["rows"])],
              f"{tag}: {r['registers']} registers, x_passes' copy "
              f"{x_regs[(r['kernel'], r['x'], r['rows'])]}")
    buckets = sorted(r["bucket"] for r in trows if r["bucket"])
    check(buckets == sorted(kernels._TRANSFORM_BUCKETS),
          f"fused_transform buckets {buckets} differ from the wrapper's")
    for r in trows:
        if r["bucket"]:
            check(r["spill_stores"] == 0,
                  f"transform_columns<{r['bucket']}>: spill stores {r['spill_stores']}")
        if r["bucket"] == 40:
            check(r["ffma"] >= 40 * 40, f"transform_columns<40>: {r['ffma']} FFMA")
    tiles = [r for r in trows if r["kernel"] == "transform_tiles"]
    check(sorted((r["T"], r["KP"]) for r in tiles) == sorted(kernels._TRANSFORM_TILES),
          "transform_tiles' instantiations differ from the wrapper's")
    for r in tiles:
        tag = f"transform_tiles T={r['T']} KP={r['KP']}"
        check(r["spill_stores"] == 0, f"{tag}: spill stores {r['spill_stores']}")
        most = 128 if kernels.transform_blocks_per_sm(r["T"], r["KP"]) == 2 else 255
        check(r["registers"] is not None and r["registers"] <= most,
              f"{tag}: {r['registers']} registers")
        check(r["ldgsts"] > 0, f"{tag}: no cp.async (LDGSTS)")
        check(r["ffma"] >= 8 * 16 * r["row_pairs"], f"{tag}: {r['ffma']} FFMA")


def iteration_problem(torch, gen, dev, g, n, blocks, n_labels, xdtype):
    K = sum(blocks)
    rate = torch.full((g, n), 1.5, device=dev)
    X = torch.poisson(rate, generator=gen).clamp_(max=127)
    X = (X if xdtype in (torch.int8, torch.int16)
         else X + torch.rand((g, n), generator=gen, device=dev)).to(xdtype)
    del rate
    W = torch.rand((g, K), generator=gen, device=dev) + 0.05
    H = torch.rand((K, n), generator=gen, device=dev) + 0.05
    Ys, Bs = [], []
    for c, nl in enumerate(n_labels):
        lab = torch.randint(0, nl, (n,), generator=gen, device=dev)
        Ys.append(torch.nn.functional.one_hot(lab, nl).T.contiguous().to(xdtype))
        Bs.append(torch.rand((nl, blocks[c]), generator=gen, device=dev) + 0.05)
    lam = torch.full((len(n_labels),), 1e3, device=dev)
    return X, W, H, W.T @ W, Ys, Bs, lam


def iteration_cost(g, n, blocks, n_labels, xbytes, bf16, counts=False, symmetric=False):
    """(bytes, bf16 flop, fp32 flop) one fused iteration must move/do; the
    counts mode also reads the (2, n) f32 counts and forms HHtU (K x K).
    ``symmetric``: H Hᵀ (and HHtU) as the upper triangle that determines
    them, K (K + 1) n flop each (the large-K rows); else 2 K² n each."""
    K, L, Kg = sum(blocks), sum(n_labels), sum(blocks[:-1])
    nbytes = (xbytes * g * n + xbytes * L * n + 4 * 2 * K * n + 4 * 2 * g * K
              + 4 * K * K * 2 + 4 * L * Kg)
    x_ops = 4.0 * g * n * K
    gram = (K * (K + 1.0) if symmetric else 2.0 * K * K) * n
    f32_ops = 2.0 * K * K * n + gram + (8.0 * L * Kg + 2.0 * L * K) * n + 12.0 * K * n
    if counts:
        nbytes += 4 * 2 * n + 4 * K * K
        f32_ops += gram
    return nbytes, (x_ops if bf16 else 0.0), f32_ops + (0.0 if bf16 else x_ops)


def gram_cost(K, n, L, counts):
    """(bytes, bf16 flop, fp32 flop) of gram_wide: Hn, c and Q read once, HHt
    (and HHtU), rowsum and Bnum written once; the upper triangles of HHt (and
    HHtU), K (K + 1) n flop each, and the L + 1 extra columns, 2 (L + 1) K n
    (counts mode: K n products Hs = c Hn more)."""
    nmat = 2 if counts else 1
    nbytes = 4 * (K * n + (n if counts else 0) + L * n + nmat * K * K + (L + 1) * K)
    ops = (nmat * K * (K + 1.0) + 2.0 * (L + 1) * K + (K if counts else 0)) * n
    return nbytes, 0.0, ops


def bound(nbytes, bf16_ops, f32_ops, card):
    bw, p16, p32 = card
    t_bytes = nbytes / bw * 1e3
    t_ops = (bf16_ops / p16 + f32_ops / p32) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_us(torch, fn, calls=20, tries=3):
    """The card's time of one call of `fn`: the durations of the CUDA
    kernels each of `calls` calls launched (torch.profiler), summed a call,
    the median over the calls (µs), and the kernels a call.  Calls run one
    after another on one stream, so a call's kernels are the next run of
    the same count.  (None, 0) where `tries` profiles in a row saw no
    kernel or a count that is not a multiple of `calls`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        per_call = len(spans) // calls
        if per_call and per_call * calls == len(spans):
            sums = [sum(d for _, d in spans[i * per_call:(i + 1) * per_call])
                    for i in range(calls)]
            return float(np.median(sums)), per_call
    return None, 0


def host_us(torch, fn, calls=200):
    """The host's time to enqueue one call of `fn` (µs): the wall time of
    `calls` calls enqueued behind a long torch.cuda._sleep, so that no call
    waits for the card, over `calls`; and whether the card was still
    asleep when the host was done (else the number holds waits too)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)  # about 0.2 s at 2 GHz
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    done = torch.cuda.Event()
    done.record()
    hidden = not done.query()
    torch.cuda.synchronize()
    return t * 1e6 / calls, hidden


def make_x_pass_problem(torch, gen, dev, g, n, K, xdtype):
    """X (g, n) of Poisson counts in xdtype (int16: counts x 3, above 127;
    float32/bf16: plus a uniform fraction), W (g, K) and H (K, n)."""
    X = torch.poisson(torch.full((g, n), 1.5, device=dev), generator=gen)
    if xdtype == torch.int16:
        X *= 3  # counts above 127: int16 is what "auto" gives them
    else:
        X = X.clamp_(max=127)
    if xdtype not in (torch.int8, torch.int16):
        X += torch.rand((g, n), generator=gen, device=dev)
    X = X.to(xdtype)
    H = torch.rand((K, n), generator=gen, device=dev) + 0.05
    W = torch.rand((g, K), generator=gen, device=dev) + 0.05
    return X, W, H


def at_byte_offset(torch, X, offset):
    """A copy of X that starts `offset` bytes into a buffer `offset` bytes
    longer: the same values at another alignment."""
    nbytes = X.numel() * X.element_size()
    buf = torch.empty(nbytes + offset, dtype=torch.uint8, device=X.device)
    view = buf[offset:].view(X.dtype).view(X.shape)
    view.copy_(X)
    return view


def x_pass_grid(kernels, kind, g, n, K, dtype):
    """The grid the X pass runs at this shape, as its rule gives it."""
    bf16 = dtype in kernels._MMA_XTYPES
    if not bf16 and kernels.route(K) == "wide":  # hxt_fma_wide / wtx_fma_wide
        d = kernels.wtw_design()
        smem = kernels.fma_wide_smem_bytes(kind, dtype)
        if kind == "hxt":
            n_split, cps = kernels.hxt_fma_wide_grid(g, n, K, dtype)
            blocks = kernels.wtw_design(K, g)["blocks"] * n_split
            return dict(kernel="hxt_fma_wide", tile=d["tile"], chunk=d["chunk"],
                        stages=d["stages"], n_split=n_split, cells_per_split=cps,
                        blocks=blocks, waves=blocks / (2 * kernels._SMS), smem_bytes=smem,
                        partial_bytes=4 * n_split * K * g if n_split > 1 else 0)
        T, chunk, S, blocks = kernels.wtx_fma_wide_grid(g, n, K, dtype)
        return dict(kernel="wtx_fma_wide", tile=[d["tile"][0], T], chunk=chunk, stages=S,
                    blocks=blocks, waves=blocks / (2 * kernels._SMS), smem_bytes=smem)
    if bf16 and kernels.route(K) == "wide":  # hxt_wide / wtx_wide
        if kind == "hxt":
            CL, n_split, cps, S = kernels.hxt_wide_grid(g, n, K, dtype)
            return dict(kernel="hxt_wide", cluster=CL, n_split=n_split, cells_per_split=cps,
                        stages=S, tiles=kernels._wide_tiles("hxt", g, K),
                        blocks=kernels._wide_tiles("hxt", g, K) * n_split,
                        partial_bytes=4 * n_split * K * g if n_split > 1 else 0)
        CL, ranges, range_genes, S = kernels.wtx_wide_grid(g, n, K, dtype)
        return dict(kernel="wtx_wide", cluster=CL, gene_ranges=ranges,
                    genes_a_range=range_genes, stages=S, tiles=kernels._wide_tiles("wtx", n, K),
                    blocks=kernels._wide_tiles("wtx", n, K) * ranges,
                    partial_bytes=4 * K * n * ranges if ranges > 1 else 0)
    if kind == "hxt" and bf16:
        GB, n_split, cps, S, chunk = kernels.hxt_grid(g, n, K, dtype)
        return dict(gene_block=GB, n_split=n_split, cells_per_split=cps, stages=S,
                    chunk=chunk, partial_bytes=4 * n_split * K * g)
    if kind == "hxt":
        GB, n_split, cps, S, chunk = kernels.hxt_fma_grid(g, n, K, dtype)
        WK, MK = kernels.hxt_fma_rows(K)
        return dict(gene_block=GB, n_split=n_split, cells_per_split=cps, stages=S,
                    chunk=chunk, warp_rows=WK, rows_a_thread=MK,
                    partial_bytes=4 * n_split * K * g)
    if bf16:
        T, WR, GC, S, blocks = kernels.wtx_grid(g, n, K, dtype)
        split = getattr(kernels, "wtx_gene_split", None)
        ranges, range_genes = split(g, n, K, dtype) if split else (1, g)
        return dict(tile=T, warp_rows=WR, gene_chunk=GC, stages=S, blocks=blocks,
                    gene_ranges=ranges, genes_a_range=range_genes,
                    waves=blocks * ranges / (2 * kernels._SMS),
                    partial_bytes=4 * K * n * ranges if ranges > 1 else 0)
    T, LK, GC, S, blocks = kernels.wtx_fma_grid(g, n, K, dtype)
    WK, MK = kernels.wtx_fma_rows(K, LK)
    return dict(tile=T, lanes_along_k=LK, warp_rows=WK, rows_a_thread=MK, gene_chunk=GC,
                stages=S, blocks=blocks, waves=blocks / (2 * kernels._SMS))


def x_pass_row(torch, kernels, mu, card, kind, X, P, timed, note=""):
    """hxt(X, H = P) or wtx(X, W = P) against its plain version; timed
    at the bench shape beside one torch.matmul over a copy of X cast to
    its compute dtype outside the timed region (bf16 for int8/bf16 X):
    one call, 20 back to back, the card's time of a call (device_us, the
    profiler) and the host's (host_us, enqueued behind a sleeping card)."""
    g, n = X.shape
    K = P.shape[0] if kind == "hxt" else P.shape[1]
    kern = lambda: getattr(kernels, kind)(X, P)
    plain = lambda: getattr(kernels, f"{kind}_plain")(X, P)
    abs_err, worst = compare(kern(), plain(), 1e-4, 1e-6)
    tag = f"{kind} {'bench' if timed else 'small'} {str(X.dtype)[6:]} K={K} n={n}{note}"
    row = {"phase": "kernel", "case": tag, "max_abs_err": abs_err,
           "worst_err_over_tolerance": worst,
           "tolerance": "rtol 1e-4, atol 1e-6*max|plain|"}
    if timed:
        row["ms"] = time_ms(kern, 5)
        row["plain_ms"] = time_ms(plain, 3)
        bf16 = X.dtype in (torch.int8, torch.bfloat16)
        cdt = torch.bfloat16 if bf16 else torch.float32
        Xc, Pc = X.to(cdt), mu.round_partner(P, X.dtype).to(cdt)
        lib = ((lambda: torch.matmul(Pc, Xc.T)) if kind == "hxt"
               else (lambda: torch.matmul(Pc.T, Xc)))
        row["library_ms"] = time_ms(lib, 5)
        row["library"] = f"torch.matmul, {str(cdt)[6:]} operands"
        row["ms_back_to_back"] = time_back_to_back_ms(kern, 20)
        row["library_ms_back_to_back"] = time_back_to_back_ms(lib, 20)
        row["device_us"], row["kernels_a_call"] = device_us(torch, kern)
        row["host_us"], row["host_us_hidden"] = host_us(torch, kern)
        row["library_device_us"], _ = device_us(torch, lib)
        row["library_host_us"], _ = host_us(torch, lib)
        del Xc, Pc
        side = 4 * K * n if kind == "hxt" else 4 * g * K  # H or W
        out = 4 * K * g if kind == "hxt" else 4 * K * n
        row["bytes"] = X.element_size() * g * n + side + out
        ops = 2.0 * K * g * n
        row["bf16_flop"], row["fp32_flop"] = (ops, 0.0) if bf16 else (0.0, ops)
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["bf16_flop"],
                                                 row["fp32_flop"], card)
        row.update(x_pass_grid(kernels, kind, g, n, K, X.dtype))
    emit(row)
    check(worst <= 1.0, f"{tag}: kernel disagrees with its plain version")
    return row


def mode_batch_geometry(n_cells, world, batch, tiled):
    """(batches an epoch, cells of a full batch, cells of the last batch)
    of the widest rank of ``world`` over ``n_cells`` cells
    (alpine_tpu_torch.ops.mu._fit_scan_steps): a batch takes ⌈w / nb⌉ of
    the widest rank's w cells (tiled: its tiles, whole ones, after the pad
    to a tile multiple)."""
    def cdiv(a, b):
        return -(-a // b)

    unit = TILE if tiled else 1
    span = cdiv(cdiv(n_cells, world), unit)  # the widest rank's units
    per = min(cdiv(cdiv(span * unit, cdiv(n_cells, batch)), unit), span)
    nbat = cdiv(span, per)
    return nbat, per * unit, (span - per * (nbat - 1)) * unit


# P1/P2 on int8 X away from the bench shape, each misaligned shape beside
# its aligned twin: (label, cells, byte offset of X, twin label); a label
# with "slab" takes whole tiles of X in a random order, as a tiled batch
_MB2 = mode_batch_geometry(N, 2, MB_BATCH, False)  # world 2's minibatch fit
_TL2 = mode_batch_geometry(N, 2, MB_BATCH, True)  # and its tiled fit
TWIN_SHAPES = (("bench", N, 0, None), ("bench offset 1", N, 1, "bench"),
               ("fold", 66_667, 0, "fold twin"), ("fold twin", 66_672, 0, None),
               ("validation fold", 33_334, 0, "validation twin"),
               ("validation twin", 33_344, 0, None),
               ("minibatch", MB_BATCH, 0, None),
               ("minibatch offset 1", MB_BATCH, 1, "minibatch"),
               ("tiled slab", MB_BATCH, 0, None),
               ("world-2 minibatch", _MB2[1], 0, "world-2 minibatch twin"),
               ("world-2 minibatch twin", -(-_MB2[1] // 16) * 16, 0, None),
               ("world-2 minibatch last", _MB2[2], 0, None),
               ("world-2 tiled slab", _TL2[1], 0, None),
               ("world-2 tiled last slab", _TL2[2], 0, None),
               ("world-2 shard", -(-N // 2), 0, None))


def grid_share_widths(torch, mu, dev):
    """The cells of cell column 0's share of each MB_BATCH-cell batch of a
    2 x 2 grid's first minibatch epoch over the N cells: the global
    permutation the slice's model (random_state 42) draws for epoch 0,
    cut as alpine_tpu_torch.ops.mu._fit_scan_steps cuts it."""
    from alpine_tpu_torch.models.alpine import draw_cells_stream
    from alpine_tpu_torch.parallel.distributed import process_cell_range

    idx = draw_cells_stream(N, 42, dev)(0)
    return [int(s.numel()) for s in mu._column_shares(
        idx, MB_BATCH, *process_cell_range(N, 2, 0))]


def x_pass_twin_rows(torch, kernels, mu, gen, dev, card, K=40):
    """P1 and P2 (K = 40) on int8 X at TWIN_SHAPES (among them the batches
    of slice_sharded_modes' world-2 minibatch and tiled fits, a full one
    and the last), at the optimizer's ALS folds (P1 K = 44, P2 k = 32)
    at 66,667 cells and its twin 66,672, and on a 2 x 2 grid's 1,000
    genes at a cell column's share of a minibatch (``grid_share_widths``:
    the first full share whose rows sit off 16-byte alignment beside its
    aligned twin, and the last batch's share):
    each row timed as x_pass_row times it, with a digest of its output and,
    for a copy of X at a byte offset, whether it gives the aligned copy's
    bits.  Returns {(kind, label): row}."""
    import hashlib

    rows = {}
    Xf, Wf, Hf = make_x_pass_problem(torch, gen, dev, G, N, 44, torch.int8)
    tiles = torch.randperm(N // TILE, generator=gen, device=dev)
    slab = lambda A, n: A[:, :N // TILE * TILE].reshape(A.shape[0], -1, TILE).index_select(
        1, tiles[:n // TILE]).reshape(A.shape[0], -1).contiguous()
    cases = [(label, n, off, K, K, G) for label, n, off, _ in TWIN_SHAPES]
    cases += [("als fold", 66_667, 0, 44, 32, G), ("als fold twin", 66_672, 0, 44, 32, G)]
    widths = grid_share_widths(torch, mu, dev)
    share = next((w for w in widths[:-1] if w % 16), widths[0])
    cases += [("grid minibatch", share, 0, K, K, G // 2),
              ("grid minibatch twin", -(-share // 16) * 16, 0, K, K, G // 2),
              ("grid minibatch last", widths[-1], 0, K, K, G // 2)]
    for label, n, off, kh, kw, g in cases:
        X = slab(Xf, n) if "slab" in label else Xf[:g, :n].contiguous()
        H = slab(Hf[:kh], n) if "slab" in label else Hf[:kh, :n].contiguous()
        W = Wf[:g, :kw].contiguous()
        Xo = at_byte_offset(torch, X, off) if off else X
        for kind, P in (("hxt", H), ("wtx", W)):
            row = x_pass_row(torch, kernels, mu, card, kind, Xo, P, True, f" {label}")
            out = getattr(kernels, kind)(Xo, P)
            row["digest"] = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
            row["x_byte_offset"] = (Xo.data_ptr() % 16, (n * Xo.element_size()) % 16)
            if off:
                row["bits_equal_aligned_copy"] = bool(torch.equal(out, getattr(kernels, kind)(X, P)))
                check(row["bits_equal_aligned_copy"],
                      f"{kind} {label}: X at a byte offset gave other bits than its aligned copy")
            emit({"phase": "kernel_twin", "kind": kind, "label": label,
                  **{k: v for k, v in row.items() if k != "phase"}})
            rows[(kind, label)] = row
        del X, H, W, Xo
        torch.cuda.empty_cache()
    del Xf, Wf, Hf
    torch.cuda.empty_cache()
    twins = {label: twin for label, _, _, twin in TWIN_SHAPES if twin}
    twins["als fold"] = "als fold twin"
    twins["grid minibatch"] = "grid minibatch twin"
    emit({"phase": "kernel_twin_summary", "grid_share_widths_epoch_0_column_0": widths,
          "device_us_over_aligned_twin": {
              f"{kind} {label}": rows[(kind, label)]["device_us"] / rows[(kind, twin)]["device_us"]
              for kind in ("hxt", "wtx") for label, twin in twins.items()
              if rows[(kind, label)]["device_us"] and rows[(kind, twin)]["device_us"]},
          "ms_over_library": {f"{kind} {label}": [r["ms"] / r["library_ms"],
                                                  r["ms_back_to_back"]
                                                  / r["library_ms_back_to_back"]]
                              for (kind, label), r in rows.items()}})
    return rows


def x_pass_share_rows(torch, kernels, mu, gen, dev, card, specs):
    """P1 (K = 40) and P2 on int8 X at the shares of a batch that the mesh
    phases' global-draw fits ran, rank 0's of their first epoch: each spec
    (label, genes, share widths, P2's widths k) gives the first share but
    the last whose X rows sit off 16-byte alignment (or the first) and,
    for an ALS spec, its aligned twin, then the last share; each row timed
    as x_pass_row times it ("kernel_twin" lines).  Returns {(kind, label):
    row}, a P2 label ending in " k=<k>"."""
    rows = {}
    Xf, Wf, Hf = make_x_pass_problem(torch, gen, dev, G, MB_BATCH + 16, 40, torch.int8)
    for label, g, widths, ks in specs:
        first = next((w for w in widths[:-1] if w % 16), widths[0])
        shapes = [(label, first)]
        if "als" in label:
            shapes.append((f"{label} twin", -(-first // 16) * 16))
        shapes.append((f"{label} last", widths[-1]))
        for tag, n in shapes:
            if not n:  # an empty share launches nothing
                continue
            X = Xf[:g, :n].contiguous()
            passes = [("hxt", tag, Hf[:, :n].contiguous())] + [
                ("wtx", f"{tag} k={k}", Wf[:g, :k].contiguous()) for k in ks]
            for kind, name, P in passes:
                row = x_pass_row(torch, kernels, mu, card, kind, X, P, True, f" {name}")
                emit({"phase": "kernel_twin", "kind": kind, "label": name,
                      "x_row_bytes_mod_16": n % 16,
                      **{k: v for k, v in row.items() if k != "phase"}})
                rows[(kind, name)] = row
            del X, passes
    del Xf, Wf, Hf
    torch.cuda.empty_cache()
    emit({"phase": "kernel_twin_summary", "global_draw_shares": {
              label: widths for label, _, widths, _ in specs},
          "device_us_over_aligned_twin": {
              f"{kind} {name}": rows[(kind, name)]["device_us"] / rows[twin]["device_us"]
              for (kind, name), twin in (
                  ((kind, name), (kind, name.replace(" k=", " twin k=") if " k=" in name
                                  else f"{name} twin")) for kind, name in rows)
              if twin in rows and rows[(kind, name)]["device_us"]
              and rows[twin]["device_us"]},
          "ms_over_library": {f"{kind} {name}": [r["ms"] / r["library_ms"],
                                                 r["ms_back_to_back"]
                                                 / r["library_ms_back_to_back"]]
                              for (kind, name), r in rows.items()}})
    return rows


# the kernels line's rows at the global-draw shares: row name -> the
# x_pass_share_rows row that times it
SHARE_ROW_SOURCE = {
    "hxt global share als": ("hxt", "global share als"),
    "wtx global share als k=5": ("wtx", "global share als k=5"),
    "wtx global share als k=30": ("wtx", "global share als k=30"),
    "hxt global share weighted": ("hxt", "global share weighted"),
    "wtx global share weighted": ("wtx", "global share weighted k=40"),
    "wtx global share weighted k=5": ("wtx", "global share weighted k=5"),
    "wtx global share weighted k=30": ("wtx", "global share weighted k=30"),
    "hxt gene_cell als share": ("hxt", "grid share als"),
    "wtx gene_cell als share k=5": ("wtx", "grid share als k=5"),
    "wtx gene_cell als share k=30": ("wtx", "grid share als k=30"),
    "hxt gene_cell weighted share": ("hxt", "grid share weighted"),
    "wtx gene_cell weighted share": ("wtx", "grid share weighted k=40"),
}


def share_launches(sharded, grid):
    """The launches of the kernels line's share rows (and of world 2's
    losses) from slice_sharded_modes' world-2 counts (``sharded``: P1 and
    P2 by mode, the non-empty shares by mode, the epochs) and the 2 x 2
    grid's (``grid``: P1 and P2 at the shares by mode).  An ALS share runs
    P2 at k = 5 twice and at k = 30 once; a weighted ALS fit's shares are
    the weighted fit's widths, so its P2s count in the weighted rows."""
    busy_als = sharded["busy shares als_minibatch"]
    busy_wals = sharded["busy shares weighted_als"]
    grid_als = grid["wtx als_minibatch"] // len(BLOCKS)
    return {"hxt global share als": sharded["hxt als_minibatch"],
            "wtx global share als k=5": 2 * busy_als,
            "wtx global share als k=30": busy_als,
            "hxt global share weighted": sharded["hxt weighted"] + sharded["hxt weighted_als"],
            "wtx global share weighted": sharded["busy shares weighted"],
            "wtx global share weighted k=5": 2 * busy_wals,
            "wtx global share weighted k=30": busy_wals,
            "hxt gene_cell als share": grid["hxt als_minibatch"],
            "wtx gene_cell als share k=5": 2 * grid_als,
            "wtx gene_cell als share k=30": grid_als,
            "hxt gene_cell weighted share": grid["hxt weighted"],
            "wtx gene_cell weighted share": grid["wtx weighted"],
            "wtx global shard loss": sharded["epochs"]}


def iteration_twin_rows(torch, kernels, gen, dev, card):
    """K1 at the optimizer's fold K = 144 (blocks (24, 24, 96)) and K4 at
    the weighted_fast folds' K = 44 (blocks (6, 6, 32), counts 0..3) on
    int8 X of 66,667 cells and of its aligned twin 66,672: one call
    (CUDA events), the card's time of a call (device_us) and the kernel's
    grid."""
    rows = {}
    for tag, blocks, counts in (("fused_iteration K=144", (24, 24, 96), False),
                                ("fused_iteration_counts K=44", (6, 6, 32), True)):
        for n in (66_667, 66_672):
            X, W, H, WtW, Ys, Bs, lam = iteration_problem(
                torch, gen, dev, G, n, blocks, N_LABELS, torch.int8)
            C = (torch.randint(0, 4, (2, n), generator=gen, device=dev).float()
                 if counts else None)
            kern = lambda: kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, EPS, C,
                                                   blocks=blocks, loss_kl=True)
            cost = iteration_cost(G, n, blocks, N_LABELS, 1, True, counts=counts)
            b_ms, b_by = bound(*cost, card)
            row = {"phase": "kernel_twin", "case": f"{tag} int8 n={n}", "ms": time_ms(kern, 5),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "x_row_bytes_mod_16": n % 16,
                   "grid": kernels.iteration_grid(G, n, sum(blocks), torch.int8)._asdict()}
            row["device_us"], row["kernels_a_call"] = device_us(torch, kern)
            emit(row)
            rows[(tag, n)] = row
            del X, W, H, WtW, Ys, Bs, lam, C
            torch.cuda.empty_cache()
    return rows


SHARDED_KEYS = ["batch", "condition"]
SHARDED_PARAMS = {"n_components": 30, "n_covariate_components": [5, 5],
                  "lam": [1e3, 1e3]}
# gloo ranks sharing the card: a rank waiting longer than this in a
# collective raises, and the parent stops a rank that outlives its budget
RANK_PG_TIMEOUT = 120.0
RANK_TIMEOUT = 240.0


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _kernel_device_ms(prof, DeviceType):
    """The CUDA kernels of a profile (copies and fills left out): their
    summed durations and the five longest [name, ms], in ms."""
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                     and not re.search(r"memcpy|memset", e.key, re.I)),
                    key=lambda e: -e.self_device_time_total)
    return (sum(e.self_device_time_total for e in events) * 1e-3,
            [[e.key[:60], e.self_device_time_total * 1e-3] for e in events[:5]])


def sharded_fit(torch, kernels, dist, ALPINE, adata, iters, device):
    """One fit and cached transform of the slice's model on ``device`` (a
    cell mesh), the kernel launches and all-reduces of each counted from
    zero, the fit under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = ALPINE(device=device, **SHARDED_PARAMS)
    kernels.reset_launches()
    dist.reset_collectives(timed=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.fit(adata, SHARDED_KEYS, max_iter=iters)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    device_ms, top = _kernel_device_ms(prof, DeviceType)
    fit_launches = dict(kernels.launches)
    coll = dist.collective_summary()
    kernels.reset_launches()
    model.transform(adata)  # through the fit's device X
    torch.cuda.synchronize()
    loop = coll["iteration"]
    row = {"fit_seconds_profiled": fit_s, "timings": model.timings_,
           "device_ms_per_iteration": device_ms / iters,
           "top_kernels_device_ms_per_iteration": [[k, ms / iters] for k, ms in top],
           "launches": {"fused_iteration": fit_launches["fused_iteration"],
                        "fused_h_update": fit_launches["fused_h_update"],
                        "fused_transform": kernels.launches["fused_transform"],
                        "hxt": fit_launches["hxt"]},
           "allreduce_calls_before_loop": coll["setup"]["calls"],
           "allreduce_calls_per_iteration": loop["calls"] / iters,
           "allreduce_bytes_per_iteration": loop["bytes"] / loop["calls"],
           "allreduce_ms_per_iteration": loop["ms"] / loop["calls"],
           "allreduce_ms_before_loop": coll["setup"]["ms"]}
    out = {"loss": model.loss_history_,
           "W": np.concatenate(model.matrices["Ws"], axis=1),
           "H": np.concatenate(model.matrices["Hs"], axis=0),
           "T": np.concatenate([adata.obsm[k] for k in SHARDED_KEYS]
                               + [adata.obsm["ALPINE_embedding"]], axis=1)}
    model.free_device_cache()
    return row, out


def sharded_rank(here, workdir, world, rank, port, iters, n_cells):
    """One gloo rank of slice_sharded (a spawned process): its run of the
    bench cells, memory-mapped from the parent's file, fit and transformed
    over the cell mesh; its numbers printed and its results saved."""
    sys.path.insert(0, here)
    import torch

    from alpine_tpu_torch import ALPINE, AnnData
    from alpine_tpu_torch.ops import kernels
    from alpine_tpu_torch.parallel import distributed as dist

    dist.initialize(f"localhost:{port}", num_processes=world, process_id=rank,
                    local_device_ids=0, backend="gloo", timeout=RANK_PG_TIMEOUT)
    try:
        lo, hi = dist.process_cell_range(n_cells)
        counts = np.load(os.path.join(workdir, "counts.npy"), mmap_mode="r")
        labels = np.load(os.path.join(workdir, "obs.npz"), allow_pickle=True)
        adata = AnnData(np.asarray(counts[lo:hi], dtype=np.float32),
                        obs={k: labels[k][lo:hi] for k in SHARDED_KEYS})
        t0 = time.perf_counter()
        row, out = sharded_fit(torch, kernels, dist, ALPINE, adata, iters,
                               dist.global_cell_mesh())
        np.savez(os.path.join(workdir, f"world{world}_rank{rank}.npz"), **out)
        row = {"phase": "slice_sharded_rank", "world": world, "rank": rank,
               "backend": torch.distributed.get_backend(), "cells": hi - lo,
               "first_cell": lo, "iterations": iters,
               "rank_seconds": time.perf_counter() - t0, **row}
        with open(os.path.join(workdir, f"world{world}_rank{rank}.json"), "w") as f:
            json.dump(row, f)
        emit(row)
    finally:
        dist.shutdown()


def run_sharded_phase(torch, kernels, mu, ALPINE, AnnData, counts, obs, ref):
    """slice_sharded: the slice's fit and transform over a cell mesh of 1
    (NCCL, this process), 2 and 3 (gloo, spawned ranks sharing the card)
    processes, each held against the slice phase's results (``ref``)."""
    import multiprocessing
    import tempfile

    from alpine_tpu_torch.models.alpine import draw_init, draw_transform_h0
    from alpine_tpu_torch.parallel import distributed as dist
    from alpine_tpu_torch.utils.encoder import FeatureEncoders

    here = os.path.dirname(os.path.abspath(__file__))
    phase_t0 = time.perf_counter()
    n, g = counts.shape
    K = sum(BLOCKS)
    payload = 4 * (g * K + K * K + 1 + len(N_LABELS)
                   + sum(nl * k for nl, k in zip(N_LABELS, BLOCKS)) + sum(BLOCKS[:-1]))
    worlds = []

    def check_rank(world, row, iters):
        want = {"fused_iteration": iters, "fused_h_update": 0, "fused_transform": 1,
                "hxt": 1}
        check(row["launches"] == want,
              f"world {world}: launches {row['launches']}, expected {want}")
        check(row["allreduce_calls_per_iteration"] == 1
              and row["allreduce_calls_before_loop"] == 1,
              f"world {world}: one all-reduce an iteration (and one before the loop)")
        check(row["allreduce_bytes_per_iteration"] == payload,
              f"world {world}: {row['allreduce_bytes_per_iteration']} bytes an "
              f"iteration, expected {payload}")

    # world 1: NCCL in this process; the all-reduce changes nothing, so
    # the fit and transform are the slice's bit for bit
    t0 = time.perf_counter()
    dist.initialize(f"localhost:{_free_port()}", num_processes=1, process_id=0,
                    backend="nccl", timeout=RANK_PG_TIMEOUT)
    try:
        backend = torch.distributed.get_backend()
        row, out = sharded_fit(torch, kernels, dist, ALPINE, AnnData(counts, obs=obs),
                               FIT_ITERS, dist.global_cell_mesh())
    finally:
        dist.shutdown()
    torch.cuda.empty_cache()
    bits = {k: bool(np.array_equal(out[k], ref[k])) for k in ("loss", "W", "H", "T")}
    emit({"phase": "slice_sharded_rank", "world": 1, "rank": 0, "backend": backend,
          "cells": n, "first_cell": 0, "iterations": FIT_ITERS,
          "rank_seconds": time.perf_counter() - t0, **row})
    check_rank(1, row, FIT_ITERS)
    check(all(bits.values()), f"world 1 must be the slice bit for bit: {bits}")
    worlds.append({"world": 1, "backend": backend, "iterations": FIT_ITERS,
                   "cells": [n], "device_ms_per_iteration": [row["device_ms_per_iteration"]],
                   "allreduce_ms_per_iteration": [row["allreduce_ms_per_iteration"]],
                   "bits_equal_slice": bits, "seconds": time.perf_counter() - t0})

    # worlds 2 and 3: gloo ranks spawned on the one card (NCCL refuses two
    # ranks on one GPU); each memory-maps its cells from one file
    ctx = multiprocessing.get_context("spawn")
    X_card = torch.from_numpy(np.ascontiguousarray(counts.T.astype(np.int8))).cuda()

    def short_fit_h(iters):
        """The slice's fit cut to ``iters`` iterations on one device, as the
        estimator runs it (its first losses must be the slice's bit for
        bit): the scaled H."""
        Ys = [torch.from_numpy(y.T.copy()).cuda()
              for y in FeatureEncoders(SHARDED_KEYS).fit_transform(obs)]
        cfg = mu.MUConfig(blocks=BLOCKS, n_labels=tuple(y.shape[0] for y in Ys),
                          n_cells=n, max_iter=iters, x_dtype="int8")
        W0, H0, Bs0 = draw_init(cfg, g, 42, EPS, X_card.device)
        hyper = (torch.tensor(SHARDED_PARAMS["lam"], dtype=torch.float32, device="cuda"),
                 0.0, 0.0, 0.0, float(np.float32(EPS)))
        W, H, Bs, L = mu.fit_scan(cfg, W0, H0, Bs0, X_card, Ys, hyper)
        check(np.array_equal(L.cpu().numpy(), ref["loss"][:iters]),
              "the short single-device fit must be the slice's first iterations")
        return mu.scale_matrices(cfg.blocks, W, H, Bs)[1].cpu().numpy()
    with tempfile.TemporaryDirectory() as workdir:
        np.save(os.path.join(workdir, "counts.npy"), counts.astype(np.int8))
        np.savez(os.path.join(workdir, "obs.npz"), **obs)
        for world, iters in ((2, FIT_ITERS), (3, 10)):
            t0 = time.perf_counter()
            port = _free_port()
            procs = [ctx.Process(target=sharded_rank,
                                 args=(here, workdir, world, r, port, iters, n))
                     for r in range(world)]
            for p in procs:
                p.start()
            deadline = time.monotonic() + RANK_TIMEOUT
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.terminate()
                p.join(10)
            codes = [p.exitcode for p in procs]
            check(not alive and codes == [0] * world,
                  f"world {world}: ranks ended with {codes}"
                  + (" (stopped at the time limit)" if alive else ""))
            outs = [dict(np.load(os.path.join(workdir, f"world{world}_rank{r}.npz")))
                    for r in range(world)]
            rows = []
            for r in range(world):
                with open(os.path.join(workdir, f"world{world}_rank{r}.json")) as f:
                    rows.append(json.load(f))
                check_rank(world, rows[-1], iters)
            same = {k: all(np.array_equal(o[k], outs[0][k]) for o in outs)
                    for k in ("loss", "W")}
            check(all(same.values()), f"world {world}: W and the losses must be "
                  f"bit-equal across the ranks: {same}")
            loss_gap = float(np.max(np.abs(outs[0]["loss"] / ref["loss"][:iters] - 1)))
            H = np.concatenate([o["H"] for o in outs], axis=1)
            H_ref = ref["H"] if iters == FIT_ITERS else short_fit_h(iters)
            h_err = float(np.linalg.norm(H - H_ref) / np.linalg.norm(H_ref))
            # a single-device transform of all cells with rank 0's W and the
            # same global H0 draw
            W = torch.from_numpy(outs[0]["W"]).cuda()
            H0 = draw_transform_h0(W.shape[1], n, 42, EPS, X_card.device)
            T_ref = mu.run_transform(W, X_card, H0, float(np.float32(EPS)),
                                     n_iter=iters).cpu().numpy().T
            T = np.concatenate([o["T"] for o in outs], axis=0)
            # elementwise, rtol 1e-5 (a zero beside a non-zero fails)
            t_err = float(np.max(np.abs(T - T_ref) / np.maximum(np.abs(T_ref), 1e-30)))
            del W, H0
            worlds.append({"world": world, "backend": rows[0]["backend"],
                           "iterations": iters, "cells": [r["cells"] for r in rows],
                           "device_ms_per_iteration": [r["device_ms_per_iteration"]
                                                       for r in rows],
                           "allreduce_ms_per_iteration": [r["allreduce_ms_per_iteration"]
                                                          for r in rows],
                           "loss_max_rel_err": loss_gap, "H_rel_frobenius_err": h_err,
                           "transform_max_rel_err": t_err, "replicas_bit_equal": same,
                           "seconds": time.perf_counter() - t0})
            check(loss_gap <= 5e-4, f"world {world}: losses {loss_gap} from the slice's")
            check(h_err <= 5e-3, f"world {world}: embedding {h_err} from the slice's")
            check(t_err <= 1e-5, f"world {world}: transform {t_err} from one device's")
    del X_card
    torch.cuda.empty_cache()
    # what a shard's K1 costs alone on the card (no rank beside it): world
    # 2's 50,000 cells, world 3's 33,334 (rows off 16-byte alignment) and
    # that shard's aligned twin, 33,344 cells; the kernels' summed
    # durations a call (torch.profiler, 20 calls) and one call's CUDA-event
    # time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_alone = {}
    shard3 = -(-n // 3)
    for cells in (n // 2, shard3, -(-shard3 // 16) * 16):
        X, W, H, WtW, Ys, Bs, lam = iteration_problem(
            torch, gen, torch.device("cuda"), g, cells, BLOCKS, N_LABELS, torch.int8)

        def k1():
            return kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, EPS,
                                           blocks=BLOCKS, loss_kl=True)

        k1()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                k1()
            torch.cuda.synchronize()
        k1_alone[str(cells)] = {"device_ms": _kernel_device_ms(prof, DeviceType)[0] / 20,
                                "ms": time_ms(k1, 5)}
        del X, W, H, WtW, Ys, Bs, lam
    torch.cuda.empty_cache()
    emit({"phase": "slice_sharded", "cells": n, "genes": g,
          "allreduce_bytes_per_iteration": payload, "worlds": worlds,
          "k1_alone_by_cells": k1_alone,
          "tolerance": "world 1 bit for bit; worlds 2, 3: loss rtol 5e-4, embedding "
                       "relative Frobenius 5e-3, transform rtol 1e-5, W and losses "
                       "bit-equal across ranks",
          "seconds": time.perf_counter() - phase_t0})


# the fit modes of slice_sharded_modes: (name, model keywords, fit keywords,
# iterations or epochs); the last three take the global draw (each rank its
# share of every batch of the single-device epoch) and run MB_EPOCHS epochs,
# as slice_minibatch_als and slice_weighted do
SHARDED_MODES = (
    ("weighted_fast", {}, {"sampling_method": "weighted_fast"}, 20),
    ("als", {"use_als": True}, {}, 10),
    ("minibatch", {}, {"batch_size": MB_BATCH}, 5),
    ("tiled", {}, {"batch_size": MB_BATCH, "sampling_method": "tiled"}, 5),
    ("als_minibatch", {"use_als": True}, {"batch_size": MB_BATCH}, MB_EPOCHS),
    ("weighted", {}, {"batch_size": MB_BATCH, "sampling_method": "weighted"}, MB_EPOCHS),
    ("weighted_als", {"use_als": True}, {"batch_size": MB_BATCH, "sampling_method": "weighted"},
     MB_EPOCHS),
)
GLOBAL_DRAW_MODES = ("als_minibatch", "weighted", "weighted_als")
MODES_CKPT_EVERY, MODES_CKPT_ITERS = 5, 10
# the slice's model with its storage named: "auto" resolves to int8 on these
# counts too, but its scan of X for fractions costs seconds a fit
MODES_PARAMS = dict(SHARDED_PARAMS, data_dtype="int8")
MODES_RANK_TIMEOUT = 300.0


def share_widths(mu, cfg, cells, cell_range, iters):
    """The cells of a global-draw fit's share of each batch of each epoch
    (the epochs redrawn from the fit's own stream, cut as
    mu._fit_scan_steps cuts them), and how many shares were empty."""
    widths = [[int(u.numel()) for u in mu._column_shares(
        cells(t), cfg.eff_batch_size, *cell_range)] for t in range(iters)]
    return widths, sum(w == 0 for ws in widths for w in ws)


def mode_fit(torch, kernels, mu, dist, ALPINE, adata, device, model_kw, fit_kw, iters):
    """One fit of the slice's model in a mode on ``device`` under the
    profiler, its kernel launches and all-reduces counted from zero.  The
    fit loop's H0 and H are compared column by column (the cells it left
    untrained: none but undrawn ones of a weighted fit), a weighted_fast
    fit keeps its first draw in caller order, a global-draw fit over a
    mesh reports its shares of every batch and a weighted one the gather
    of the cells' label codes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from alpine_tpu_torch.models import alpine as talpine

    seen = {}
    real_fit, real_stream = mu.fit_scan, talpine.draw_counts_stream

    def fit_scan(cfg, W0, H0, *args, **kw):
        out = real_fit(cfg, W0, H0, *args, **kw)
        seen["untrained"] = int((out[1] == H0).all(dim=0).sum())
        seen["cfg"], seen["cells"] = cfg, kw.get("draw_cells")
        seen["cell_range"] = kw.get("cell_range")
        return out

    def stream(*args, **kw):
        draw = real_stream(*args, **kw)

        def first(t):
            c = draw(t)
            if t == 0:
                seen["first_draw"] = c.cpu().numpy()
            return c
        return first

    model = ALPINE(device=device, **MODES_PARAMS, **model_kw)
    kernels.reset_launches()
    dist.reset_collectives(timed=True)
    mu.fit_scan, talpine.draw_counts_stream = fit_scan, stream
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.fit(adata, SHARDED_KEYS, max_iter=iters, **fit_kw)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
    finally:
        mu.fit_scan, talpine.draw_counts_stream = real_fit, real_stream
    device_ms, top = _kernel_device_ms(prof, DeviceType)
    coll = dist.collective_summary()
    setup, loop = coll.get("setup", {}), coll.get("iteration", {})
    row = {"iterations": iters, "fit_seconds_profiled": fit_s, "timings": model.timings_,
           "device_ms_per_iteration": device_ms / iters,
           "top_kernels_device_ms_per_iteration": [[k, ms / iters] for k, ms in top],
           "launches": {k: kernels.launches[k] for k in
                        ("fused_iteration", "fused_iteration_counts", "hxt", "wtx")},
           "every_cell_trained": seen["untrained"] == 0,
           "cells_untrained": seen["untrained"],
           "allreduce_calls_before_loop": setup.get("calls", 0),
           "allreduce_ms_before_loop": setup.get("ms", 0.0),
           "allreduce_calls_per_iteration": loop.get("calls", 0) / iters,
           "allreduce_bytes_per_iteration": loop.get("bytes", 0) / iters,
           "allreduce_ms_per_iteration": loop.get("ms", 0.0) / iters,
           "labels_gather": coll.get("labels gather")}
    if seen["cell_range"] is not None:
        row["share_cells"], row["empty_shares"] = share_widths(
            mu, seen["cfg"], seen["cells"], seen["cell_range"], iters)
    out = _fit_outputs(model)
    if "first_draw" in seen:
        out["first_draw"] = seen["first_draw"][np.argsort(model._x_cache[3])]
    return model, row, out


def mode_checkpoints(ALPINE, FitCheckpointer, adata, device, workdir):
    """weighted_fast with a snapshot every MODES_CKPT_EVERY iterations:
    the uninterrupted fit, then one interrupted after its first snapshot
    and resumed by a fresh model.  Chunk c's draws are keyed on c, so the
    reference is the uninterrupted fit with the same snapshots."""
    def fit(directory):
        model = ALPINE(device=device, **MODES_PARAMS)
        model.fit(adata, SHARDED_KEYS, max_iter=MODES_CKPT_ITERS,
                  sampling_method="weighted_fast", checkpoint_every=MODES_CKPT_EVERY,
                  checkpoint_dir=os.path.join(workdir, directory))
        return model.loss_history_

    t0 = time.perf_counter()
    whole = fit("modes_ck_whole")
    orig_save, orig_load = FitCheckpointer.save, FitCheckpointer.load
    loaded = []

    def interrupting_save(self, *args):
        orig_save(self, *args)
        raise KeyboardInterrupt

    def recording_load(self):
        r = orig_load(self)
        loaded.append(None if r is None else int(r[0]))
        return r

    interrupted = False
    FitCheckpointer.save = interrupting_save
    try:
        fit("modes_ck_resume")
    except KeyboardInterrupt:
        interrupted = True
    finally:
        FitCheckpointer.save = orig_save
    FitCheckpointer.load = recording_load
    try:
        resumed = fit("modes_ck_resume")
    finally:
        FitCheckpointer.load = orig_load
    return {"interrupted": interrupted, "resumed_from": loaded,
            "bits_equal_uninterrupted": bool(np.array_equal(whole, resumed)),
            "seconds": time.perf_counter() - t0}


def sharded_modes_rank(here, workdir, world, rank, port, n_cells):
    """One gloo rank of slice_sharded_modes (a spawned process): every mode
    on its run of the bench cells, a cached transform after the
    weighted_fast fit, and the checkpointed weighted_fast fit; a line a
    mode, and its results saved."""
    sys.path.insert(0, here)
    import torch

    from alpine_tpu_torch import ALPINE, AnnData
    from alpine_tpu_torch.io.checkpoint import FitCheckpointer
    from alpine_tpu_torch.ops import kernels, mu
    from alpine_tpu_torch.parallel import distributed as dist

    dist.initialize(f"localhost:{port}", num_processes=world, process_id=rank,
                    local_device_ids=0, backend="gloo", timeout=RANK_PG_TIMEOUT)
    try:
        lo, hi = dist.process_cell_range(n_cells)
        counts = np.load(os.path.join(workdir, "counts.npy"), mmap_mode="r")
        labels = np.load(os.path.join(workdir, "obs.npz"), allow_pickle=True)
        adata = AnnData(np.asarray(counts[lo:hi], dtype=np.float32),
                        obs={k: labels[k][lo:hi] for k in SHARDED_KEYS})
        mesh = dist.global_cell_mesh()
        outs, rows = {}, []
        for name, model_kw, fit_kw, iters in SHARDED_MODES:
            t0 = time.perf_counter()
            model, row, out = mode_fit(torch, kernels, mu, dist, ALPINE, adata, mesh,
                                       model_kw, fit_kw, iters)
            if name == "weighted_fast":
                kernels.reset_launches()
                model.transform(adata)  # through the fit's group-sorted device X
                torch.cuda.synchronize()
                cached = np.concatenate([adata.obsm[k] for k in SHARDED_KEYS]
                                        + [adata.obsm["ALPINE_embedding"]], axis=1)
                row["transform_launches"] = kernels.launches["fused_transform"]
                model.free_device_cache()
                model.transform(adata)
                fresh = np.concatenate([adata.obsm[k] for k in SHARDED_KEYS]
                                       + [adata.obsm["ALPINE_embedding"]], axis=1)
                row["transform_cached_max_rel_err"] = float(np.max(
                    np.abs(cached - fresh) / np.maximum(np.abs(fresh), 1e-30)))
                row["transform_finite"] = bool(np.isfinite(cached).all())
            model.free_device_cache()
            del model
            torch.cuda.empty_cache()
            row = {"phase": "slice_sharded_modes_rank", "world": world, "rank": rank,
                   "mode": name, "backend": torch.distributed.get_backend(),
                   "cells": hi - lo, "first_cell": lo,
                   "mode_seconds": time.perf_counter() - t0, **row}
            emit(row)
            rows.append(row)
            outs.update({f"{name}_{k}": v for k, v in out.items()})
        ck = mode_checkpoints(ALPINE, FitCheckpointer, adata, mesh, workdir)
        emit({"phase": "slice_sharded_modes_rank", "world": world, "rank": rank,
              "mode": "weighted_fast checkpointed", **ck})
        np.savez(os.path.join(workdir, f"modes_world{world}_rank{rank}.npz"), **outs)
        with open(os.path.join(workdir, f"modes_world{world}_rank{rank}.json"), "w") as f:
            json.dump({"rows": rows, "checkpoint": ck}, f)
    finally:
        dist.shutdown()


def run_sharded_modes_phase(torch, kernels, mu, ALPINE, AnnData, counts, obs, mb_refs):
    """slice_sharded_modes: the fit modes beyond full-batch joint over a
    cell mesh.  One device's weighted_fast (20 iterations), ALS (10) and
    ALS "weighted" (MB_EPOCHS) fits, and ``mb_refs``' slice_minibatch_als
    and slice_weighted fits, are the references; world 1 (NCCL, this
    process) must give them bit for bit; world 2 (gloo, two spawned ranks
    sharing the card) runs every mode, within tolerance of one device for
    the modes whose trajectory is the single-device one.  Returns world
    2's launches of the global-draw fits, its two ranks together, and
    rank 0's shares of their first epochs."""
    import multiprocessing
    import tempfile

    from alpine_tpu_torch.parallel import distributed as dist

    here = os.path.dirname(os.path.abspath(__file__))
    phase_t0 = time.perf_counter()
    n, g = counts.shape
    K = sum(BLOCKS)
    adata = AnnData(counts, obs=obs)
    # one all-reduce an iteration of the fused loop, with the counts' HHtU
    payload_wf = 4 * (g * K + 2 * K * K + 1 + len(N_LABELS)
                      + sum(nl * k for nl, k in zip(N_LABELS, BLOCKS)) + sum(BLOCKS[:-1]))
    modes = {name: (model_kw, fit_kw, iters) for name, model_kw, fit_kw, iters in SHARDED_MODES}
    expect = {}
    for name, (_, fit_kw, iters) in modes.items():
        if name == "weighted_fast":
            expect[name] = ({"fused_iteration": 0, "fused_iteration_counts": iters, "hxt": 1,
                             "wtx": 0}, 1)
        elif name == "als":
            expect[name] = ({"fused_iteration": 0, "fused_iteration_counts": 0, "hxt": iters,
                             "wtx": len(BLOCKS) * iters}, len(BLOCKS) + 1)
    refs, worlds = {}, []
    nb = -(-n // MB_BATCH)  # the global draw's batches an epoch

    def check_mode(world, name, row):
        want, calls = expect.get(name, (None, None))
        iters = modes[name][2]
        blocks = len(BLOCKS) if modes[name][0].get("use_als") else 1
        if name in GLOBAL_DRAW_MODES:
            # a P1 and a P2 a block for each non-empty share of a batch (one
            # device: every batch), a P2 an epoch for the loss
            busy = (nb * iters if "share_cells" not in row else
                    sum(w > 0 for ws in row["share_cells"] for w in ws))
            want = {"fused_iteration": 0, "fused_iteration_counts": 0, "hxt": busy,
                    "wtx": blocks * busy + iters}
            calls = nb * blocks + 1
            if "share_cells" in row:
                check(all(len(ws) == nb for ws in row["share_cells"]),
                      f"world {world} {name}: {nb} shares an epoch")
        elif want is None:  # minibatch, tiled: one P1 and one P2 a batch
            nbat = mode_batch_geometry(n, world, MB_BATCH, name == "tiled")[0]
            want = {"fused_iteration": 0, "fused_iteration_counts": 0,
                    "hxt": nbat * iters, "wtx": (nbat + 1) * iters}
            calls = nbat + 1
        check(row["launches"] == want,
              f"world {world} {name}: launches {row['launches']}, expected {want}")
        # before the loop: ‖X‖² (with the fused loop's other sums) and, for
        # a shard-local minibatch or tiled fit, the widest rank's units
        setup = 2 if name in ("minibatch", "tiled") else 1
        check(row["allreduce_calls_per_iteration"] == calls
              and row["allreduce_calls_before_loop"] == setup,
              f"world {world} {name}: {row['allreduce_calls_per_iteration']} all-reduces "
              f"an iteration, expected {calls} (and {setup} before the loop)")
        # a gathered weighted fit leaves the cells it never drew as they were
        if name not in ("weighted", "weighted_als"):
            check(row["every_cell_trained"], f"world {world} {name}: a cell kept its H0")
        else:
            gathered = row["labels_gather"]
            check(gathered is not None and gathered["calls"] == 1
                  and gathered["bytes"] == 8 * world * (2 + -(-n // world)),
                  f"world {world} {name}: one gather of the label codes: {gathered}")
        if name == "weighted_fast":
            check(row["allreduce_bytes_per_iteration"] == payload_wf,
                  f"world {world}: {row['allreduce_bytes_per_iteration']} bytes an "
                  f"iteration, expected {payload_wf}")

    # one device: the references (slice_minibatch_als and slice_weighted
    # fitted the slice's model in those modes already)
    refs["als_minibatch"] = mb_refs["slice_minibatch_als"]
    refs["weighted"] = mb_refs["slice_weighted"]
    for name in ("weighted_fast", "als", "weighted_als"):
        model_kw, fit_kw, iters = modes[name]
        model, row, refs[name] = mode_fit(torch, kernels, mu, dist, ALPINE, adata, "cuda",
                                          model_kw, fit_kw, iters)
        model.free_device_cache()
        del model
        emit({"phase": "slice_sharded_modes_rank", "world": 0, "rank": 0, "mode": name,
              "backend": None, "cells": n, **row})
    torch.cuda.empty_cache()

    # world 1: NCCL in this process, bit for bit one device's fits
    t0 = time.perf_counter()
    dist.initialize(f"localhost:{_free_port()}", num_processes=1, process_id=0,
                    backend="nccl", timeout=RANK_PG_TIMEOUT)
    try:
        backend = torch.distributed.get_backend()
        mesh = dist.global_cell_mesh()
        w1 = {"world": 1, "backend": backend, "cells": [n], "modes": {}}
        for name in ("weighted_fast", "als", *GLOBAL_DRAW_MODES):
            model_kw, fit_kw, iters = modes[name]
            model, row, out = mode_fit(torch, kernels, mu, dist, ALPINE, adata, mesh,
                                       model_kw, fit_kw, iters)
            model.free_device_cache()
            del model
            bits = {k: bool(np.array_equal(out[k], refs[name][k])) for k in refs[name]}
            emit({"phase": "slice_sharded_modes_rank", "world": 1, "rank": 0, "mode": name,
                  "backend": backend, "cells": n, "bits_equal_one_device": bits, **row})
            check_mode(1, name, row)
            check(all(bits.values()), f"world 1 {name} must be one device's fit bit for "
                                      f"bit: {bits}")
            w1["modes"][name] = {"device_ms_per_iteration": [row["device_ms_per_iteration"]],
                                 "allreduce_ms_per_iteration": [row["allreduce_ms_per_iteration"]],
                                 "allreduce_bytes_per_iteration": row["allreduce_bytes_per_iteration"],
                                 "labels_gather": row["labels_gather"],
                                 "bits_equal_one_device": bits}
    finally:
        dist.shutdown()
    torch.cuda.empty_cache()
    w1["seconds"] = time.perf_counter() - t0
    worlds.append(w1)

    # world 2: gloo ranks spawned on the one card
    ctx = multiprocessing.get_context("spawn")
    world = 2
    with tempfile.TemporaryDirectory() as workdir:
        np.save(os.path.join(workdir, "counts.npy"), counts.astype(np.int8))
        np.savez(os.path.join(workdir, "obs.npz"), **obs)
        t0 = time.perf_counter()
        port = _free_port()
        procs = [ctx.Process(target=sharded_modes_rank,
                             args=(here, workdir, world, r, port, n)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + MODES_RANK_TIMEOUT
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(10)
        codes = [p.exitcode for p in procs]
        check(not alive and codes == [0] * world,
              f"slice_sharded_modes world {world}: ranks ended with {codes}"
              + (" (stopped at the time limit)" if alive else ""))
        outs = [dict(np.load(os.path.join(workdir, f"modes_world{world}_rank{r}.npz")))
                for r in range(world)]
        infos = []
        for r in range(world):
            with open(os.path.join(workdir, f"modes_world{world}_rank{r}.json")) as f:
                infos.append(json.load(f))
    w2 = {"world": world, "backend": infos[0]["rows"][0]["backend"],
          "cells": [info["rows"][0]["cells"] for info in infos], "modes": {}}
    global_launches, global_shares = {}, {}
    for i, (name, _, _, iters) in enumerate(SHARDED_MODES):
        rows = [info["rows"][i] for info in infos]
        for row in rows:
            check_mode(world, name, row)
        same = {k: all(np.array_equal(o[f"{name}_{k}"], outs[0][f"{name}_{k}"]) for o in outs)
                for k in ("loss", "W", "B0", "B1")}
        check(all(same.values()), f"world {world} {name}: W, the Bs and the losses must be "
                                  f"bit-equal across the ranks: {same}")
        L = outs[0][f"{name}_loss"]
        check(np.isfinite(L).all() and L[-1, 0] < L[0, 0],
              f"world {world} {name}: losses finite and falling")
        m = {"iterations": iters,
             "device_ms_per_iteration": [r["device_ms_per_iteration"] for r in rows],
             "allreduce_calls_per_iteration": rows[0]["allreduce_calls_per_iteration"],
             "allreduce_bytes_per_iteration": rows[0]["allreduce_bytes_per_iteration"],
             "allreduce_ms_per_iteration": [r["allreduce_ms_per_iteration"] for r in rows],
             "fit_seconds": [r["timings"]["fit"] for r in rows],
             "replicas_bit_equal": same}
        if name in GLOBAL_DRAW_MODES:
            m["launches"] = [r["launches"] for r in rows]
            m["empty_shares"] = [r["empty_shares"] for r in rows]
            m["share_cells_epoch_0"] = [r["share_cells"][0] for r in rows]
            m["labels_gather"] = [r["labels_gather"] for r in rows]
            m["cells_untrained"] = [r["cells_untrained"] for r in rows]
            for k in ("hxt", "wtx"):
                global_launches[f"{k} {name}"] = sum(r["launches"][k] for r in rows)
            global_launches[f"busy shares {name}"] = sum(
                w > 0 for r in rows for ws in r["share_cells"] for w in ws)
            global_launches["epochs"] = global_launches.get("epochs", 0) + iters * world
            global_shares[name] = rows[0]["share_cells"][0]
        if name in refs:
            ref = refs[name]
            m["loss_max_rel_err"] = float(np.max(np.abs(L / ref["loss"] - 1)))
            H = np.concatenate([o[f"{name}_H"] for o in outs], axis=1)
            m["H_rel_frobenius_err"] = float(np.linalg.norm(H - ref["H"])
                                             / np.linalg.norm(ref["H"]))
            check(m["loss_max_rel_err"] <= 5e-4,
                  f"world {world} {name}: losses {m['loss_max_rel_err']} from one device's")
            check(m["H_rel_frobenius_err"] <= 5e-3,
                  f"world {world} {name}: H {m['H_rel_frobenius_err']} from one device's")
            check(worlds[0]["modes"][name]["allreduce_bytes_per_iteration"]
                  == m["allreduce_bytes_per_iteration"],
                  f"{name}: the all-reduce bytes must not depend on the cells a rank")
        if name == "weighted_fast":
            draw = np.concatenate([o["weighted_fast_first_draw"] for o in outs])
            m["first_draw_equal_one_device"] = bool(np.array_equal(draw, ref["first_draw"]))
            check(m["first_draw_equal_one_device"],
                  "world 2: the ranks' first draws must be one device's draw")
            errs = [r["transform_cached_max_rel_err"] for r in rows]
            m["transform_cached_max_rel_err"] = errs
            check(all(r["transform_launches"] == 1 and r["transform_finite"] for r in rows)
                  and max(errs) <= 1e-5,
                  f"world {world}: cached transforms against uncached {errs}")
        w2["modes"][name] = m
    cks = [info["checkpoint"] for info in infos]
    w2["weighted_fast_checkpointed"] = cks
    check(all(c["interrupted"] and c["resumed_from"] == [MODES_CKPT_EVERY]
              and c["bits_equal_uninterrupted"] for c in cks),
          f"world {world}: the resumed weighted_fast fit must be the uninterrupted one "
          f"bit for bit: {cks}")
    w2["seconds"] = time.perf_counter() - t0
    worlds.append(w2)
    del adata
    torch.cuda.empty_cache()

    # K4 alone (no rank beside it) at world 2's shard, 50,000 cells, and at
    # a ragged world-2 shard (100,001 cells: 50,001, rows off 16-byte
    # alignment) beside its aligned twin, 50,016 cells
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_ms(fn, reps=20):
        """The card's summed kernel time of a call, and its kernels."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, top = _kernel_device_ms(prof, DeviceType)
        return total / reps, [[k, ms / reps] for k, ms in top]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k4_alone = {}
    for cells in (n // 2, n // 2 + 1, -(-(n // 2 + 1) // 16) * 16):
        X, W, H, WtW, Ys, Bs, lam = iteration_problem(
            torch, gen, dev, g, cells, BLOCKS, N_LABELS, torch.int8)
        C = torch.randint(0, 4, (2, cells), generator=gen, device=dev).float()

        def k4():
            return kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, EPS, C,
                                           blocks=BLOCKS, loss_kl=True)

        k4_alone[str(cells)] = {"device_ms": device_ms(k4)[0], "ms": time_ms(k4, 5),
                                "x_row_bytes_mod_16": cells % 16}
        del X, W, H, WtW, Ys, Bs, lam, C
    torch.cuda.empty_cache()

    # the weighted_fast sampler (mu.grouped_balanced_counts) on the bench's
    # joint groups: a draw of the full form (one device) and of each window
    # of a 2-rank mesh, the windows' counts concatenated the full draw; then
    # its index_add_ alone on n draws, half of them in a window of n / 2
    # cells and half outside it, those on one sink address or spread over
    # mu._SINK sink columns
    from alpine_tpu_torch.utils.sampling import balanced_group_tables, window_group_tables

    ids = np.unique(np.stack([np.asarray(obs[k]).astype(str) for k in SHARDED_KEYS], 1),
                    axis=0, return_inverse=True)[1].reshape(-1)
    _, start, sizes = balanced_group_tables(ids)
    half = -(-n // 2)
    forms = {"full": ((start, sizes), None)}
    for w, (sl, off, ml) in enumerate(window_group_tables(start, sizes, np.zeros_like(sizes),
                                                          2, half)):
        forms[f"window {w}"] = ((sl, sizes, off, ml), min(half, n - w * half))
    sgen = torch.Generator(device=dev)
    sampler = {"draws": n, "groups": int(len(sizes)), "sink_columns": mu._SINK}
    drawn = {}
    for name, (tabs, n_out) in forms.items():
        tabs = tuple(torch.from_numpy(np.asarray(a, np.int32)).to(dev) for a in tabs)

        def draw(tabs=tabs, n_out=n_out):
            return mu.grouped_balanced_counts(sgen.manual_seed(7), n, tabs, n_out)

        drawn[name] = draw()
        ms, top = device_ms(draw)
        sampler[name] = {"device_ms": ms, "ms": time_ms(draw, 5), "kernels": top}
    sampler["windows_equal_full_draw"] = bool(torch.equal(
        torch.cat([drawn["window 0"], drawn["window 1"]]), drawn["full"]))
    check(sampler["windows_equal_full_draw"],
          "the 2 windows' counts, concatenated, must be the full draw")
    inside = torch.randint(0, half, (n,), generator=gen, device=dev)
    outside = torch.rand(n, generator=gen, device=dev) < 0.5
    spread = torch.randint(0, mu._SINK, (n,), generator=gen, device=dev)
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    for name, idx in (("index_add_one_sink", torch.where(outside, half, inside)),
                      ("index_add_spread_sink", torch.where(outside, half + spread, inside))):
        acc = torch.zeros(half + mu._SINK, dtype=torch.int32, device=dev)
        ms, top = device_ms(lambda: acc.index_add_(0, idx, ones))
        sampler[name] = {"device_ms": ms, "kernels": top}
    del drawn, inside, outside, spread, ones, acc
    emit({"phase": "slice_sharded_modes", "cells": n, "genes": g,
          "weighted_fast_allreduce_bytes_per_iteration": payload_wf, "worlds": worlds,
          "k4_alone_by_cells": k4_alone, "sampler": sampler,
          "tolerance": "world 1 bit for bit one device's weighted_fast, ALS, ALS "
                       "minibatch, weighted and ALS weighted fits; world 2: those "
                       "modes' loss rtol 5e-4 and H relative Frobenius 5e-3 against "
                       "one device, W, Bs and losses bit-equal across ranks, the "
                       "first weighted_fast draw equal, "
                       "minibatch and tiled losses finite and falling with every cell "
                       "trained (their batches' P1/P2 held at TWIN_SHAPES), the resumed "
                       "checkpointed fit bit for bit, the sampler's windows the full "
                       "draw exactly, cached "
                       "transforms rtol 1e-5 against uncached, W and losses bit-equal "
                       "across ranks",
          "seconds": time.perf_counter() - phase_t0})
    return global_launches, global_shares


# the fits of slice_gene_cell: (mode, model keywords, fit keywords), each
# GRID_ITERS iterations (epochs) on the 1 x 1 grid, and the grids that run
# them over spawned gloo ranks; the 2 x 2 grid's minibatch fits (random,
# ALS, weighted: GRID_MB_MODES) run GRID_MB_EPOCHS epochs, its
# checkpointed joint fit GRID_ITERS iterations with a snapshot every
# GRID_CKPT_EVERY, its checkpointed weighted fit GRID_MB_EPOCHS epochs with
# a snapshot every GRID_MB_CKPT_EVERY
GRID_ITERS = 10
GRID_MB_EPOCHS = 5
GRID_CKPT_EVERY = 5
GRID_MB_CKPT_EVERY = 2
GRID_MODES = (("joint", {}, {}), ("als", {"use_als": True}, {}),
              ("weighted_fast", {}, {"sampling_method": "weighted_fast"}),
              ("minibatch", {}, {"batch_size": MB_BATCH}),
              ("als_minibatch", {"use_als": True}, {"batch_size": MB_BATCH}),
              ("weighted", {}, {"batch_size": MB_BATCH, "sampling_method": "weighted"}))
GRID_MB_MODES = ("minibatch", "als_minibatch", "weighted")
GRID_WORLDS = (((2, 2), ("joint", "als", "weighted_fast", "minibatch", "als_minibatch",
                         "weighted")), ((2, 1), ("joint",)))
GRID_RANK_TIMEOUT = 300.0


def _grid_blocks(adata):
    return np.concatenate([adata.obsm[k] for k in SHARDED_KEYS]
                          + [adata.obsm["ALPINE_embedding"]], axis=1)


def _fit_outputs(model):
    return {"loss": model.loss_history_,
            "W": np.concatenate(model.matrices["Ws"], axis=1),
            "H": np.concatenate(model.matrices["Hs"], axis=0),
            **{f"B{i}": b for i, b in enumerate(model.matrices["Bs"])}}


def grid_fit(torch, kernels, mu, dist, ALPINE, adata, device, name, iters=GRID_ITERS):
    """One ``iters``-iteration (minibatch: epoch) fit of the slice's model
    (int8 named) in mode ``name`` on a ("genes", "cells") grid under the
    profiler, its kernel launches and each axis's all-reduces counted from
    zero; a joint fit's cached transform after it.  A minibatch fit's row
    holds the cells of this rank's share of each batch of each epoch
    (the epochs redrawn from the fit's own stream) and its empty shares,
    a weighted fit's the gather of the cells' label codes.  Returns (row,
    outputs, the inputs and outputs of the fit's one mu.fit_scan call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model_kw, fit_kw = {m: (mk, fk) for m, mk, fk in GRID_MODES}[name]
    seen = {}
    real_fit = mu.fit_scan

    def fit_scan(*args, **kw):
        seen["args"], seen["draw"], seen["cells"] = (args, kw.get("draw_counts"),
                                                     kw.get("draw_cells"))
        seen["cell_range"] = kw.get("cell_range")
        seen["out"] = real_fit(*args, **kw)
        return seen["out"]

    model = ALPINE(device=device, **MODES_PARAMS, **model_kw)
    kernels.reset_launches()
    dist.reset_collectives(timed=True)
    mu.fit_scan = fit_scan
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.fit(adata, SHARDED_KEYS, max_iter=iters, **fit_kw)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
    finally:
        mu.fit_scan = real_fit
    device_ms, top = _kernel_device_ms(prof, DeviceType)
    coll = dist.collective_summary()

    def axis(tag):
        c = coll.get(tag, {})
        return {"calls": c.get("calls", 0) / iters,
                "bytes": c.get("bytes", 0) / iters,
                "ms": c.get("ms", 0.0) / iters}

    row = {"mode": name, "iterations": iters, "fit_seconds_profiled": fit_s,
           "timings": model.timings_, "device_ms_per_iteration": device_ms / iters,
           "top_kernels_device_ms_per_iteration": [[k, ms / iters] for k, ms in top],
           "launches": {k: kernels.launches[k] for k in
                        ("fused_iteration", "fused_iteration_counts", "hxt", "wtx")},
           "allreduce_per_iteration": {"cells": axis("iteration"),
                                       "genes": axis("genes iteration")},
           "allreduce_before_loop": {"cells": coll.get("setup"),
                                     "genes": coll.get("genes setup")},
           "labels_gather": coll.get("labels gather")}
    if name in GRID_MB_MODES:
        row["share_cells"], row["empty_shares"] = share_widths(
            mu, seen["args"][0], seen["cells"], seen["cell_range"], iters)
    out = _fit_outputs(model)
    if name == "joint":
        kernels.reset_launches()
        dist.reset_collectives(timed=True)
        model.transform(adata)  # through the fit's device X (its block)
        torch.cuda.synchronize()
        row["transform_launches"] = {k: kernels.launches[k]
                                     for k in ("fused_transform", "hxt", "wtx")}
        row["transform_allreduce"] = dist.collective_summary().get("genes transform")
        out["T"] = _grid_blocks(adata)
    model.free_device_cache()
    del model
    torch.cuda.empty_cache()
    return row, out, seen


def grid_checkpoints(torch, kernels, ALPINE, adata, device, directory, whole, name="joint"):
    """slice_gene_cell's checkpointed fit in mode ``name`` on ``device`` (a
    grid): the joint fit's GRID_ITERS iterations with a snapshot every
    GRID_CKPT_EVERY, or a minibatch mode's GRID_MB_EPOCHS epochs with one
    every GRID_MB_CKPT_EVERY, into ``directory`` (a file a rank),
    interrupted after its first snapshot, then resumed by a fresh model,
    whose outputs are held bit for bit against ``whole`` (the
    uninterrupted fit's).  A sampled fit's chunk c draws with c in its
    seeds, so its ``whole`` is None and the uninterrupted checkpointed fit
    runs first.  Returns the rank's row: the iteration it resumed from,
    each snapshot's seconds and bytes, whether its one snapshot file
    outlived the interruption and went with the fit's end, P1 and P2
    launches of the interrupted and resumed fits, the bits."""
    from alpine_tpu_torch.io.checkpoint import FitCheckpointer

    orig_save, orig_load = FitCheckpointer.save, FitCheckpointer.load
    saves, loaded, paths = [], [], set()

    def timed_save(self, iteration, *args):
        t0 = time.perf_counter()
        orig_save(self, iteration, *args)
        saves.append((time.perf_counter() - t0, os.path.getsize(self.path)))
        paths.add(self.path)

    def interrupting_save(self, *args):
        timed_save(self, *args)
        raise KeyboardInterrupt

    def recording_load(self):
        r = orig_load(self)
        loaded.append(None if r is None else int(r[0]))
        return r

    model_kw, fit_kw = {m: (mk, fk) for m, mk, fk in GRID_MODES}[name]
    iters, every = ((GRID_MB_EPOCHS, GRID_MB_CKPT_EVERY) if name in GRID_MB_MODES
                    else (GRID_ITERS, GRID_CKPT_EVERY))

    def fit(where=directory):
        model = ALPINE(device=device, **MODES_PARAMS, **model_kw)
        model.fit(adata, SHARDED_KEYS, max_iter=iters, checkpoint_dir=where,
                  checkpoint_every=every, **fit_kw)
        return model

    t0 = time.perf_counter()
    if whole is None:
        model = fit(directory + "_whole")
        whole = _fit_outputs(model)
        model.free_device_cache()
        del model
    kernels.reset_launches()
    interrupted = False
    FitCheckpointer.save = interrupting_save
    try:
        fit()
    except KeyboardInterrupt:
        interrupted = True
    finally:
        FitCheckpointer.save = orig_save
    kept = [os.path.exists(p) for p in paths]
    FitCheckpointer.save, FitCheckpointer.load = timed_save, recording_load
    try:
        model = fit()
        torch.cuda.synchronize()
    finally:
        FitCheckpointer.save, FitCheckpointer.load = orig_save, orig_load
    out = _fit_outputs(model)
    model.free_device_cache()
    del model
    torch.cuda.empty_cache()
    return {"mode": name, "iterations": iters, "checkpoint_every": every,
            "interrupted": interrupted, "resumed_from": loaded,
            "snapshot_kept_after_interrupt": kept == [True],
            "snapshot_seconds": [v[0] for v in saves],
            "snapshot_bytes": [v[1] for v in saves],
            "launches": {k: kernels.launches[k] for k in ("hxt", "wtx")},
            "bits_equal_uninterrupted": {k: bool(np.array_equal(out[k], whole[k]))
                                         for k in out},
            "snapshot_removed_after_fit": len(paths) == 1 and not any(
                os.path.exists(p) for p in paths),
            "seconds": time.perf_counter() - t0}


def _digest(a):
    """A 48-bit digest of an array's bytes (exact as a float64)."""
    import hashlib

    return float(int.from_bytes(hashlib.sha256(
        np.ascontiguousarray(a).tobytes()).digest()[:6], "big"))


def grid_transform_check(torch, kernels, mu, W_np, X_card, grid, T):
    """A grid's transform ``T`` (cells x K) against one device's with the
    same W (rank 0's) and global H0 draw.  The grid sums 2WᵀX and 2WᵀW
    gene block by gene block, which the MU steps amplify by WᵀW's
    conditioning (2e-5 relative seen on large entries at 2 x 2): so T is
    held against K3 on the same block sums, formed here a cell run at a
    time as each rank forms them (gloo adds two blocks as a + b), at rtol
    1e-6 with atol 1e-7 max|T| (and its bits reported), and within 1e-4
    relative Frobenius of the unsplit projection."""
    from alpine_tpu_torch.models.alpine import draw_transform_h0
    from alpine_tpu_torch.parallel.distributed import process_cell_range

    n_g, n_c = grid
    g, n = X_card.shape
    eps = float(np.float32(EPS))
    W = torch.from_numpy(W_np).cuda()
    H0 = draw_transform_h0(W.shape[1], n, 42, EPS, X_card.device)
    T_ref = mu.run_transform(W, X_card, H0, eps, n_iter=GRID_ITERS).cpu().numpy().T
    blocks = []
    with mu.matmul_precision("highest"):
        for ci in range(n_c):
            lo, hi = process_cell_range(n, n_c, ci)
            num2 = WtW2 = 0.0
            for gi in range(n_g):
                a, b = gi * g // n_g, (gi + 1) * g // n_g
                Xb = X_card[a:b, lo:hi].contiguous()
                num2 = num2 + 2.0 * (W[a:b].T @ Xb.float())
                WtW2 = WtW2 + 2.0 * (W[a:b].T @ W[a:b])
            blocks.append(kernels.fused_transform(
                num2, H0[:, lo:hi].contiguous(), WtW2, eps,
                n_iter=GRID_ITERS).cpu().numpy().T)
    T_sums = np.concatenate(blocks)
    _, worst = compare(torch.from_numpy(T), torch.from_numpy(T_sums), 1e-6, 1e-7)
    return {"transform_bits_equal_block_sums": bool(np.array_equal(T, T_sums)),
            "transform_worst_over_tolerance_block_sums": worst,
            "transform_max_rel_err_unsplit": float(np.max(
                np.abs(T - T_ref) / np.maximum(np.abs(T_ref), 1e-30))),
            "transform_rel_frobenius_err": float(np.linalg.norm(T - T_ref)
                                                 / np.linalg.norm(T_ref))}


def gene_cell_rank(here, workdir, grid, modes, rank, port, n_cells):
    """One gloo rank of slice_gene_cell (a spawned process) at its place
    on a ``grid``: the cells of its column with every gene, memory-mapped
    from the parent's file; each mode's fit (and the joint fit's
    transform; a minibatch fit of GRID_MB_EPOCHS epochs), a line a mode
    with whether its W, H and Bs are bit-equal to its replicas' (digests
    gathered from every rank) and its loss gap to world 1's fit; on the
    2 x 2 grid the checkpointed joint fit (``grid_checkpoints``, snapshots
    in one directory) against the uninterrupted one, a line; its results
    saved."""
    sys.path.insert(0, here)
    import torch

    from alpine_tpu_torch import ALPINE, AnnData
    from alpine_tpu_torch.ops import kernels, mu
    from alpine_tpu_torch.parallel import distributed as dist
    from alpine_tpu_torch.parallel.mesh import Placement

    world = grid[0] * grid[1]
    dist.initialize(f"localhost:{port}", num_processes=world, process_id=rank,
                    local_device_ids=0, backend="gloo", timeout=RANK_PG_TIMEOUT)
    try:
        mesh = dist.global_gene_cell_mesh(*grid)
        place = Placement(mesh)
        lo, hi = dist.mesh_cell_range(mesh, n_cells)
        counts = np.load(os.path.join(workdir, "counts.npy"), mmap_mode="r")
        g0, g1 = place.gene_range(counts.shape[1])
        labels = np.load(os.path.join(workdir, "obs.npz"), allow_pickle=True)
        adata = AnnData(np.asarray(counts[lo:hi], dtype=np.float32),
                        obs={k: labels[k][lo:hi] for k in SHARDED_KEYS})
        tag = f"{grid[0]}x{grid[1]}"
        rows, outs = [], {}
        for name in modes:
            t0 = time.perf_counter()
            iters = GRID_MB_EPOCHS if name in GRID_MB_MODES else GRID_ITERS
            row, out, _ = grid_fit(torch, kernels, mu, dist, ALPINE, adata, mesh, name,
                                   iters)
            B = np.concatenate([out[k].ravel() for k in sorted(out) if k.startswith("B")])
            d = dist.process_allgather_rows(np.asarray(
                [place.process_chunk_index, _digest(out["W"]), _digest(out["H"]),
                 _digest(B), _digest(out["loss"])]))
            mine = d[dist.process_index()]
            column = d[d[:, 0] == mine[0]]
            ref = np.load(os.path.join(workdir, f"world1_{name}.npz"))
            row = {"phase": "slice_gene_cell_rank", "grid": list(grid), "rank": rank,
                   "coordinates": [place.gene_index, place.process_chunk_index],
                   "backend": torch.distributed.get_backend(), "genes": g1 - g0,
                   "first_gene": g0, "cells": hi - lo, "first_cell": lo,
                   "mode_seconds": time.perf_counter() - t0, **row,
                   # W gathered whole on every rank: equal everywhere exactly
                   # where each gene row's ranks hold bit-equal rows
                   "replicas_bit_equal": {"W": bool((d[:, 1] == mine[1]).all()),
                                          "H": bool((column[:, 2] == mine[2]).all()),
                                          "Bs": bool((d[:, 3] == mine[3]).all()),
                                          "loss": bool((d[:, 4] == mine[4]).all())},
                   "loss_max_rel_gap_to_world_1": float(np.max(np.abs(
                       out["loss"] / ref["loss"][:iters] - 1)))}
            emit(row)
            rows.append(row)
            outs.update({f"{name}_{k}": v for k, v in out.items()})
        ck = []
        if grid == (2, 2):
            whole = {k[len("joint_"):]: v for k, v in outs.items()
                     if k.startswith("joint_") and k != "joint_T"}
            for name, ref in (("joint", whole), ("weighted", None)):
                ck.append(grid_checkpoints(torch, kernels, ALPINE, adata, mesh,
                                           os.path.join(workdir, f"ck_{tag}_{name}"), ref,
                                           name))
                emit({"phase": "slice_gene_cell_rank", "grid": list(grid), "rank": rank,
                      **ck[-1], "mode": f"{name} checkpointed"})
        np.savez(os.path.join(workdir, f"grid{tag}_rank{rank}.npz"), **outs)
        with open(os.path.join(workdir, f"grid{tag}_rank{rank}.json"), "w") as f:
            json.dump({"rows": rows, "checkpoint": ck}, f)
    finally:
        dist.shutdown()


def run_gene_cell_phase(torch, kernels, mu, ALPINE, AnnData, counts, obs, slice_loss,
                        mb_refs):
    """slice_gene_cell: the slice's model over ("genes", "cells") grids of
    processes.  World 1 (NCCL, this process, a 1 x 1 grid) fits joint, ALS,
    weighted_fast and minibatches of MB_BATCH from the global draw (random,
    ALS, weighted; GRID_ITERS iterations or epochs each), each bit for bit
    the step loop ``mu._fit_scan_steps`` called directly on its inputs on
    one device (the minibatch fits also the single-device estimator's
    fits: ``mb_refs``' slice_minibatch, slice_minibatch_als and
    slice_weighted), and transforms, and a checkpointed joint fit,
    interrupted and resumed, is its joint fit bit for bit; then a 2 x 2
    grid (4 gloo ranks sharing
    the card, 1,000 genes x 50,000 cells a rank) runs the modes
    (minibatch modes: GRID_MB_EPOCHS epochs), the transform and the
    checkpointed joint and weighted fits, and a 2 x 1 grid (genes only,
    1,000 x 100,000 a rank) the joint fit.  Returns the 2 x 2 grid's
    launches, its four ranks together (P1 and P2 at a rank's block: the
    full-batch fits at K = 40, the checkpointed joint fit, each minibatch
    epoch's loss; at a rank's share of a batch of each minibatch mode;
    K3), and rank 0's shares of the first epoch of each minibatch mode."""
    import multiprocessing
    import tempfile

    from alpine_tpu_torch.parallel import distributed as dist

    here = os.path.dirname(os.path.abspath(__file__))
    phase_t0 = time.perf_counter()
    n, g = counts.shape
    K = sum(BLOCKS)
    want = {"joint": {"fused_iteration": 0, "fused_iteration_counts": 0,
                      "hxt": GRID_ITERS, "wtx": GRID_ITERS},
            "als": {"fused_iteration": 0, "fused_iteration_counts": 0,
                    "hxt": GRID_ITERS, "wtx": len(BLOCKS) * GRID_ITERS},
            "weighted_fast": {"fused_iteration": 0, "fused_iteration_counts": 0,
                              "hxt": GRID_ITERS, "wtx": GRID_ITERS}}
    nb = -(-n // MB_BATCH)  # batches an epoch
    # a step's sums over cells: X Hᵀ of the rank's genes, H Hᵀ, the B
    # statistics; the loss's: its dot, H Hᵀ, the prediction terms
    b_stats = sum(nl * k for nl, k in zip(N_LABELS, BLOCKS)) + sum(BLOCKS[:-1])
    loss_sums = 1 + K * K + len(N_LABELS)

    def check_row(label, row, n_loc, g_loc):
        name = row["mode"]
        ar = row["allreduce_per_iteration"]
        if name in GRID_MB_MODES:
            # a P1 and a P2 a block for a non-empty share, a P2 an epoch for
            # the loss; nb · blocks + 1 all-reduces over each axis an epoch,
            # the genes' of K x (share + K) values a batch (ALS: its blocks'
            # k_i x (share + K) together) and K x (local cells + K) the
            # loss's, the cells' of the step's sums a batch (ALS: X Hᵀ, H Hᵀ
            # and the B statistics over its blocks' calls) and the loss's
            blocks = len(BLOCKS) if name == "als_minibatch" else 1
            busy = sum(w > 0 for ws in row["share_cells"] for w in ws)
            exp = {"fused_iteration": 0, "fused_iteration_counts": 0, "hxt": busy,
                   "wtx": blocks * busy + row["iterations"]}
            calls = (nb * blocks + 1,) * 2
            genes = 4 * K * sum(sum(w + K for w in ws) + n_loc + K
                                for ws in row["share_cells"]) / row["iterations"]
            cells = 4 * (nb * (g_loc * K + K * K + b_stats) + loss_sums)
            # a permutation's shares hold the column's cells once; weighted
            # draws repeat cells and miss others
            check(all(len(ws) == nb and (name == "weighted" or sum(ws) == n_loc)
                      for ws in row["share_cells"]),
                  f"{label}: a column's shares {row['share_cells']}")
            if name == "weighted":
                gathered = row["labels_gather"]
                world = n // n_loc * g // g_loc
                check(gathered is not None and gathered["calls"] == 1
                      and gathered["bytes"] == 8 * world * (2 + n_loc),
                      f"{label}: one gather of the label codes: {gathered}")
            check(ar["cells"]["bytes"] == cells,
                  f"{label} {name}: {ar['cells']['bytes']} bytes over cells an epoch, "
                  f"expected {cells}")
        else:
            exp = want[name]
            calls = (len(BLOCKS) + 1,) * 2 if name == "als" else (2, 1)
            # WᵀX and WᵀW of the rank's cells: K x (local cells + K) values
            genes = None if name == "als" else 4 * K * (n_loc + K)
        check(row["launches"] == exp,
              f"{label} {name}: launches {row['launches']}, expected {exp}")
        check((ar["cells"]["calls"], ar["genes"]["calls"]) == calls,
              f"{label} {name}: all-reduces an iteration over cells and genes "
              f"{ar['cells']['calls']}, {ar['genes']['calls']}, expected {calls}")
        if genes is not None:
            check(ar["genes"]["bytes"] == genes,
                  f"{label} {name}: {ar['genes']['bytes']} bytes over genes an "
                  f"iteration, expected {genes}")
        if name == "joint":
            check(row["transform_launches"] == {"fused_transform": 1, "hxt": 0, "wtx": 0}
                  and row["transform_allreduce"]["calls"] == 1,
                  f"{label}: the transform must launch K3 once after one genes all-reduce")

    worlds = []
    with tempfile.TemporaryDirectory() as workdir:
        # world 1: NCCL in this process, a 1 x 1 grid
        t0 = time.perf_counter()
        dist.initialize(f"localhost:{_free_port()}", num_processes=1, process_id=0,
                        backend="nccl", timeout=RANK_PG_TIMEOUT)
        adata = AnnData(counts, obs=obs)
        w1 = {"grid": [1, 1], "modes": {}}
        try:
            w1["backend"] = torch.distributed.get_backend()
            mesh = dist.global_gene_cell_mesh(1, 1)
            w1_outs = {}
            # the single-device estimator's fits of the slice's model in the
            # minibatch modes, with the same seed and GRID_ITERS epochs
            assert GRID_ITERS == MB_EPOCHS
            one_device = {"minibatch": mb_refs["slice_minibatch"],
                          "als_minibatch": mb_refs["slice_minibatch_als"],
                          "weighted": mb_refs["slice_weighted"]}
            for name, _, _ in GRID_MODES:
                row, out, seen = grid_fit(torch, kernels, mu, dist, ALPINE, adata, mesh, name)
                # the step loop called directly on the fit's inputs, one device
                cfg, W0, H0, Bs0, X, Ys, hyper = seen["args"]
                W, H, Bs, L = mu._fit_scan_steps(
                    cfg, W0.contiguous(), H0.contiguous(), tuple(b.contiguous() for b in Bs0),
                    X.to(cfg.xdt).contiguous(), [y.to(cfg.xdt).contiguous() for y in Ys],
                    hyper, seen["draw"], seen["cells"], None)
                fW, fH, fBs, fL = seen["out"]
                bits = {"W": torch.equal(W, fW), "H": torch.equal(H, fH),
                        "Bs": all(torch.equal(a, b) for a, b in zip(Bs, fBs)),
                        "loss": torch.equal(L, fL)}
                del W, H, Bs, L, seen
                row["bits_equal_step_loop"] = bits
                if name == "joint":
                    row["loss_max_rel_gap_to_slice_k1"] = float(np.max(np.abs(
                        out["loss"] / slice_loss[:GRID_ITERS] - 1)))
                if name in GRID_MB_MODES:
                    row["bits_equal_single_device"] = {
                        k: bool(np.array_equal(v, out[k]))
                        for k, v in one_device[name].items()}
                emit({"phase": "slice_gene_cell_rank", "grid": [1, 1], "rank": 0,
                      "coordinates": [0, 0], "backend": w1["backend"], "genes": g,
                      "cells": n, **row})
                check_row("world 1", row, n, g)
                check(all(bits.values()), f"world 1 {name} must be the step loop bit for "
                                          f"bit: {bits}")
                if name in GRID_MB_MODES:
                    blocks = len(BLOCKS) if name == "als_minibatch" else 1
                    check(row["launches"]["hxt"] == nb * GRID_ITERS
                          and row["launches"]["wtx"] == (nb * blocks + 1) * GRID_ITERS,
                          f"world 1 {name}: P1/P2 {nb} and {nb * blocks + 1} times an epoch")
                    check(all(row["bits_equal_single_device"].values()),
                          f"world 1 {name} must be the single-device fit bit for bit: "
                          f"{row['bits_equal_single_device']}")
                check(np.isfinite(out["loss"]).all() and out["loss"][-1, 0] < out["loss"][0, 0],
                      f"world 1 {name}: losses finite and falling")
                np.savez(os.path.join(workdir, f"world1_{name}.npz"), **out)
                w1_outs[name] = out
                w1["modes"][name] = {k: row[k] for k in (
                    "device_ms_per_iteration", "allreduce_per_iteration",
                    "bits_equal_step_loop")}
                if name == "joint":
                    w1["loss_max_rel_gap_to_slice_k1"] = row["loss_max_rel_gap_to_slice_k1"]
            whole = {k: v for k, v in w1_outs["joint"].items() if k != "T"}
            ck = grid_checkpoints(torch, kernels, ALPINE, adata, mesh,
                                  os.path.join(workdir, "ck_1x1"), whole)
            emit({"phase": "slice_gene_cell_rank", "grid": [1, 1], "rank": 0, **ck,
                  "mode": "joint checkpointed"})
            check(ck["interrupted"] and ck["resumed_from"] == [GRID_CKPT_EVERY]
                  and all(ck["bits_equal_uninterrupted"].values())
                  and ck["snapshot_kept_after_interrupt"] and ck["snapshot_removed_after_fit"],
                  f"world 1: the resumed checkpointed joint fit must be its joint fit "
                  f"bit for bit: {ck}")
            w1["checkpointed"] = ck
        finally:
            dist.shutdown()
        del adata
        torch.cuda.empty_cache()
        w1["seconds"] = time.perf_counter() - t0
        worlds.append(w1)

        # the grids: gloo ranks spawned on the one card (NCCL refuses two
        # ranks on one GPU), each memory-mapping its cells from one file
        np.save(os.path.join(workdir, "counts.npy"), counts.astype(np.int8))
        np.savez(os.path.join(workdir, "obs.npz"), **obs)
        ctx = multiprocessing.get_context("spawn")
        X_card = torch.from_numpy(np.ascontiguousarray(counts.T.astype(np.int8))).cuda()
        launches, shares = {}, {}
        for grid, modes in GRID_WORLDS:
            t0 = time.perf_counter()
            world, tag = grid[0] * grid[1], f"{grid[0]}x{grid[1]}"
            port = _free_port()
            procs = [ctx.Process(target=gene_cell_rank,
                                 args=(here, workdir, grid, modes, r, port, n))
                     for r in range(world)]
            for p in procs:
                p.start()
            deadline = time.monotonic() + GRID_RANK_TIMEOUT
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.terminate()
                p.join(10)
            codes = [p.exitcode for p in procs]
            check(not alive and codes == [0] * world,
                  f"grid {tag}: ranks ended with {codes}"
                  + (" (stopped at the time limit)" if alive else ""))
            outs = [dict(np.load(os.path.join(workdir, f"grid{tag}_rank{r}.npz")))
                    for r in range(world)]
            reports = []
            for r in range(world):
                with open(os.path.join(workdir, f"grid{tag}_rank{r}.json")) as f:
                    reports.append(json.load(f))
            rows = [rep["rows"] for rep in reports]
            summary = {"grid": list(grid), "backend": rows[0][0]["backend"],
                       "genes": [rr[0]["genes"] for rr in rows],
                       "cells": [rr[0]["cells"] for rr in rows], "modes": {}}
            for i, name in enumerate(modes):
                mrows = [rr[i] for rr in rows]
                for row in mrows:
                    check_row(f"grid {tag} rank {row['rank']}", row, row["cells"],
                              row["genes"])
                    check(all(row["replicas_bit_equal"].values()),
                          f"grid {tag} rank {row['rank']} {name}: replicas "
                          f"{row['replicas_bit_equal']}")
                ref = np.load(os.path.join(workdir, f"world1_{name}.npz"))
                L = outs[0][f"{name}_loss"]
                gap = max(r["loss_max_rel_gap_to_world_1"] for r in mrows)
                m = {"device_ms_per_iteration": [r["device_ms_per_iteration"] for r in mrows],
                     "allreduce_per_iteration": [r["allreduce_per_iteration"] for r in mrows],
                     "fit_seconds": [r["timings"]["fit"] for r in mrows],
                     "loss_max_rel_gap_to_world_1": gap}
                check(np.isfinite(L).all() and L[-1, 0] < L[0, 0],
                      f"grid {tag} {name}: losses finite and falling")
                check(gap <= 5e-4, f"grid {tag} {name}: losses {gap} from world 1's")
                if name in GRID_MB_MODES:
                    # GRID_MB_EPOCHS epochs against world 1's GRID_ITERS: the
                    # losses of the first epochs only
                    m["empty_shares"] = [r["empty_shares"] for r in mrows]
                    m["share_cells_epoch_0"] = [r["share_cells"][0] for r in mrows]
                    m["launches"] = [r["launches"] for r in mrows]
                    m["labels_gather"] = [r["labels_gather"] for r in mrows]
                else:
                    # H of every cell: the ranks of gene block 0, in column order
                    H = np.concatenate([outs[r][f"{name}_H"] for r in range(world)
                                        if mrows[r]["coordinates"][0] == 0], axis=1)
                    m["H_rel_frobenius_err"] = h_err = float(
                        np.linalg.norm(H - ref["H"]) / np.linalg.norm(ref["H"]))
                    check(h_err <= 5e-3, f"grid {tag} {name}: H {h_err} from world 1's")
                if name == "joint":
                    T = np.concatenate([outs[r]["joint_T"] for r in range(world)
                                        if mrows[r]["coordinates"][0] == 0])
                    m.update(grid_transform_check(torch, kernels, mu, outs[0]["joint_W"],
                                                  X_card, grid, T))
                    check(m["transform_worst_over_tolerance_block_sums"] <= 1.0
                          and m["transform_rel_frobenius_err"] <= 1e-4,
                          f"grid {tag}: transform against one device's: {m}")
                summary["modes"][name] = m
                if grid == (2, 2) and name in GRID_MB_MODES:
                    # a share's P1 and P2s (one a block) at the batch shape, the
                    # loss's P2 at the block
                    epochs = sum(r["iterations"] for r in mrows)
                    launches[f"hxt {name}"] = sum(r["launches"]["hxt"] for r in mrows)
                    launches[f"wtx {name}"] = sum(r["launches"]["wtx"]
                                                  for r in mrows) - epochs
                    launches["wtx"] = launches.get("wtx", 0) + epochs
                    shares[name] = mrows[0]["share_cells"][0]
                elif grid == (2, 2):
                    for k in ("hxt", "wtx"):
                        if k == "hxt" or name != "als":
                            launches[k] = launches.get(k, 0) + sum(
                                r["launches"][k] for r in mrows)
                    if name == "joint":
                        launches["fused_transform"] = sum(
                            r["transform_launches"]["fused_transform"] for r in mrows)
            if grid == (2, 2):
                summary["checkpointed"] = {}
                for i, name in enumerate(("joint", "weighted")):
                    cks = [rep["checkpoint"][i] for rep in reports]
                    if name == "joint":  # at the block; the weighted fit's P1 and
                        # its P2s but the losses' at shares, not counted
                        for k in ("hxt", "wtx"):
                            launches[k] += sum(c["launches"][k] for c in cks)
                    summary["checkpointed"][name] = {
                        k: [c[k] for c in cks] for k in (
                            "resumed_from", "snapshot_seconds", "snapshot_bytes",
                            "bits_equal_uninterrupted", "seconds")}
                    every = cks[0]["checkpoint_every"]
                    check(all(c["interrupted"] and c["resumed_from"] == [every]
                              and c["snapshot_kept_after_interrupt"]
                              and c["snapshot_removed_after_fit"]
                              and all(c["bits_equal_uninterrupted"].values()) for c in cks),
                          f"grid {tag}: the resumed checkpointed {name} fit must resume "
                          f"from iteration {every} on every rank and be the "
                          f"uninterrupted fit bit for bit: {summary['checkpointed'][name]}")
            summary["seconds"] = time.perf_counter() - t0
            worlds.append(summary)
        del X_card
    torch.cuda.empty_cache()
    emit({"phase": "slice_gene_cell", "cells": n, "genes": g, "iterations": GRID_ITERS,
          "worlds": worlds, "launches_2x2": launches,
          "tolerance": "world 1 bit for bit the step loop on one device (the "
                       "minibatch modes also the single-device fits, the resumed "
                       "checkpointed fit its joint fit); grids: W, Bs and losses "
                       "bit-equal on every rank, H within each cell column, losses "
                       "rtol 5e-4 and (but the minibatch modes) H relative Frobenius "
                       "5e-3 against world 1, the resumed checkpointed 2 x 2 joint and "
                       "weighted fits bit for bit the uninterrupted ones on every "
                       "rank, transform rtol 1e-6 (atol 1e-7*max|T|) against one "
                       "device's K3 on the same gene-block sums and relative "
                       "Frobenius 1e-4 against the unsplit projection",
          "seconds": time.perf_counter() - phase_t0})
    return launches, shares


PERSIST_CELLS = 20_000


def run_persist_phase(torch, kernels, ALPINE, AnnData, counts, obs):
    """slice_persist: the slice's model fit (FIT_ITERS iterations) and
    transformed on the first PERSIST_CELLS cells (the saved file holds X as
    float32: at 100k cells its compression alone took 85 s), saved, loaded
    onto the card and its uncached transform (K3) held against the fitted
    model's own; the export on the card against the host's; the AnnData
    written to .h5ad and read back whole and by a range of cells."""
    import importlib.util
    import tempfile

    sec = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec[name] = time.perf_counter() - t0
        return out

    n = PERSIST_CELLS
    cut = lambda: AnnData(counts[:n], obs={k: v[:n] for k, v in obs.items()})  # noqa: E731
    adata = cut()
    model = ALPINE(n_components=30, n_covariate_components=[5, 5], lam=[1e3, 1e3],
                   device="cuda")
    timed("fit", lambda: model.fit(adata, ["batch", "condition"], max_iter=FIT_ITERS))
    timed("transform_cached", lambda: model.transform(adata))
    model.free_device_cache()
    keys = ["ALPINE_embedding", "batch", "condition"]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model")
        timed("save", lambda: model.save(path))
        sizes = {"npz": os.path.getsize(path + ".npz"),
                 "encoders_pkl": os.path.getsize(path + ".encoders.pkl")}
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        loaded = timed("load", lambda: ALPINE.load(path, device="cuda"))
        check(getattr(loaded, "_x_cache", None) is None, "a loaded model has no device X")
        fresh = cut()
        timed("transform_uncached", lambda: loaded.transform(fresh))
        persist_launches = dict(kernels.launches)
        diffs = {k: float(np.max(np.abs(fresh.obsm[k] - adata.obsm[k]))) for k in keys}
        same_bits = all(np.array_equal(fresh.obsm[k], adata.obsm[k]) for k in keys)
        worst = max(compare(torch.from_numpy(fresh.obsm[k]), torch.from_numpy(adata.obsm[k]),
                            2e-4, 1e-6)[1] for k in keys)
        with MatmulDevices(torch) as export_devices:  # the default: the model's device
            timed("export_on_device", lambda: loaded.get_normalized_expression(
                fresh, library_size=1e4))
        on_dev = fresh.layers["normalized_expression"]
        timed("export_host", lambda: loaded.get_normalized_expression(
            fresh, library_size=1e4, on_device=False))
        host = fresh.layers["normalized_expression"]
        export_ok = bool(np.allclose(on_dev, host, rtol=1e-5, atol=1e-6))
        export_err = float(np.max(np.abs(on_dev - host)))
        del on_dev
        peak = torch.cuda.max_memory_allocated()
        # h5ad I/O needs h5py and pandas, which a GPU machine may not have:
        # the phase says so and runs the rest (the CPU tests hold h5ad I/O
        # against the JAX package's)
        missing = [m for m in ("h5py", "pandas") if importlib.util.find_spec(m) is None]
        h5ad = {"not_run": f"{', '.join(missing)} not installed"} if missing else (
            h5ad_round_trip(fresh, os.path.join(d, "slice.h5ad"), timed, sizes))
    emit({"phase": "slice_persist", "cells": n, "genes": G,
          "reduced": {"cells": f"{n} of {N}"}, "seconds": sec,
          "total_seconds": sum(sec.values()), "file_bytes": sizes,
          "layer_bytes": int(host.nbytes), "launches": persist_launches,
          "transform_bits_equal_fitted": same_bits, "transform_max_abs_diff": diffs,
          "transform_worst_err_over_tolerance": worst,
          "transform_tolerance": "rtol 2e-4, atol 1e-6*max|fitted| (K3's plain tolerance)",
          "export_default_matmul_devices": sorted(set(export_devices.devices)),
          "export_on_device_allclose_host": export_ok, "export_max_abs_diff": export_err,
          "export_tolerance": "rtol 1e-5, atol 1e-6", "h5ad": h5ad,
          # whether the .h5ad round trip ran (it needs h5py)
          "h5ad_run": not missing,
          "peak_memory_bytes_load_transform_export": peak})
    check(persist_launches["fused_transform"] == 1,
          "the loaded model's uncached transform must launch fused_transform once")
    check(same_bits or worst <= 1.0, "the loaded model's transform differs from the fitted model's")
    check(export_devices.devices and set(export_devices.devices) == {"cuda"},
          "get_normalized_expression must run its products on the model's card by default")
    check(export_ok, "get_normalized_expression on the card differs from the host's")
    check(np.allclose(host.sum(axis=1), 1e4, rtol=1e-3), "exported rows must sum to 1e4")
    if not missing:
        check(all(h5ad["round_trip_bits_equal"].values()), f"h5ad round trip: {h5ad}")
        check(all(h5ad["range_equals_slice"].values()), f"h5ad obs_range read: {h5ad}")


def MatmulDevices(torch):
    """A torch function mode that records the device type of every
    ``torch.matmul`` (or ``@``) made while it is entered."""

    class Mode(torch.overrides.TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.devices = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in ("matmul", "__matmul__"):
                self.devices.append(args[0].device.type)
            return func(*args, **(kwargs or {}))

    return Mode()


def run_minibatch_phase(phase, torch, kernels, ALPINE, adata, slice_peak, use_als=False,
                        sampling_method="random", baseline=None):
    """A MB_BATCH-cell minibatch fit of MB_EPOCHS epochs at full width: each
    batch runs hxt once and wtx once (ALS: once a block), each epoch's loss
    wtx once over all cells; no float32 copy of X (peak device memory under
    X's float32 bytes, and at most the slice's).  Tiled: batches of whole
    128-cell tiles of the padded, shuffled cell axis, then a transform
    through that device X against the uncached one; ``baseline`` is
    slice_minibatch's row, whose ms an epoch is reported beside.  Returns
    the launches, the row and the fit's outputs (the mesh phases'
    single-device references)."""
    model = ALPINE(n_components=30, n_covariate_components=[5, 5],
                   lam=[1e3, 1e3], use_als=use_als, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    model.fit(adata, ["batch", "condition"], max_iter=MB_EPOCHS, batch_size=MB_BATCH,
              sampling_method=sampling_method)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    L = model.loss_history_
    tiled = sampling_method == "tiled"
    if tiled:  # 782 tiles (96 pad columns), 64 a batch: 12 batches and one of 14
        n_tiles = -(-N // TILE)
        per_epoch = -(-n_tiles // -(-MB_BATCH // TILE))
    else:
        per_epoch = -(-N // MB_BATCH)
    batches = MB_EPOCHS * per_epoch
    want = {"hxt": batches, "wtx": (len(BLOCKS) if use_als else 1) * batches + MB_EPOCHS}
    row = {"phase": phase, "cells": N, "genes": G, "batch_size": MB_BATCH,
           "epochs": MB_EPOCHS, "batches_an_epoch": per_epoch,
           "sampling_method": sampling_method, "use_als": use_als,
           "fit_seconds": fit_s, "timings": model.timings_,
           "ms_per_epoch": model.timings_["fit"] * 1e3 / MB_EPOCHS,
           "launches": launches, "launches_expected": want,
           "loss_first": L[0].tolist(), "loss_last": L[-1].tolist(),
           "peak_memory_bytes": peak, "slice_peak_memory_bytes": slice_peak,
           "x_float32_bytes": 4 * G * N}
    if baseline is not None:
        row["slice_minibatch_ms_per_epoch"] = baseline["ms_per_epoch"]
    if tiled:
        X_dev, pad = model._x_cache[0], model._x_cache[4]
        row.update(n_tiles=n_tiles, pad=pad, device_x_shape=list(X_dev.shape))
        keys = ("ALPINE_embedding", "batch", "condition")
        t0 = time.perf_counter()
        model.transform(adata)  # through the padded, shuffled device X
        torch.cuda.synchronize()
        row["transform_seconds_cached"] = time.perf_counter() - t0
        cached = {k: adata.obsm[k].copy() for k in keys}
        model.free_device_cache()
        model.transform(adata)  # uploads X again
        diff = max(float(np.max(np.abs(cached[k] - adata.obsm[k]))) for k in keys)
        row["cached_max_abs_diff_uncached"] = diff
        row["cached_matches_uncached"] = all(
            np.allclose(cached[k], adata.obsm[k], rtol=1e-5) for k in keys)
    emit(row)
    for name, n in want.items():
        check(launches[name] == n, f"{phase}: {launches[name]} {name} launches, expected {n}")
    check(launches["fused_iteration"] == 0, f"{phase}: a minibatch fit runs no fused_iteration")
    check(np.isfinite(L).all(), f"{phase}: loss history must be finite")
    check(L[-1, 1] < L[0, 1], f"{phase}: the reconstruction loss must fall")
    check(peak <= slice_peak, f"{phase}: peak memory {peak} above the slice's {slice_peak}")
    check(peak < 4 * G * N, f"{phase}: peak memory {peak} holds a float32 copy of X")
    if tiled:
        check(n_tiles == 782 and per_epoch == 13, f"{phase}: {n_tiles} tiles, {per_epoch} batches")
        check(row["pad"] == 96 and row["device_x_shape"] == [G, n_tiles * TILE],
              f"{phase}: device X {row['device_x_shape']}, pad {row['pad']}")
        check(row["cached_matches_uncached"],
              f"{phase}: cached and uncached transforms must agree (rtol 1e-5)")
    out = _fit_outputs(model)
    model.free_device_cache()
    torch.cuda.empty_cache()
    return launches, row, out


# -- K > 512: the large-K routes (kernel_wide, slice_k768, slice_k768_modes) --
WIDE_KS = (513, 600, 768, 1024, 2048)
WIDE_NS = (17, 1001, 5040)  # 17 and 1,001: rows off 16-byte alignment for int8/bf16/int16
WIDE_G = 70  # not a multiple of any gene chunk
# K3 at a K of the register and of the tiled path, where the per-step path
# called directly must give that path's bits
STEPS_SAME_BITS_KS = (40, 300, 512)
# the kernels line's rows of the large-K routes (kernel_wide's bench rows)
# and their sources: K1/K2/K4's chain lives beside P1/P2, whose int8/bf16
# kernels above K = 512 (hxt_wide, wtx_wide) x_passes.cu includes
WIDE_ROWS = {"fused_iteration wide": "alpine_tpu_torch/csrc/x_passes.cu",
             "fused_iteration_counts wide": "alpine_tpu_torch/csrc/x_passes.cu",
             "fused_h_update wide": "alpine_tpu_torch/csrc/x_passes.cu",
             "fused_transform wide K=768 n_iter=50": "alpine_tpu_torch/csrc/fused_transform.cu",
             "hxt wide K=768": "alpine_tpu_torch/csrc/x_passes_wide.cuh",
             "wtx wide K=768": "alpine_tpu_torch/csrc/x_passes_wide.cuh",
             "wtx k=384 K=384": "alpine_tpu_torch/csrc/x_passes.cu",
             # the chain's H Hᵀ, HHtU, rowsum and Bnum (gram_wide alone)
             "gram_wide K=768": "alpine_tpu_torch/csrc/gram_wide.cuh",
             "gram_wide counts K=768": "alpine_tpu_torch/csrc/gram_wide.cuh",
             # the chain's D = WᵀW H (wtw_gemm's store alone)
             "wtw_gemm K=768": "alpine_tpu_torch/csrc/wtw_gemm.cuh",
             # K1's chain and P1/P2 on int16 X (slice_k768_int16): the fp32
             # X passes hxt_fma_wide and wtx_fma_wide
             "fused_iteration wide int16": "alpine_tpu_torch/csrc/x_passes.cu",
             "hxt fma_wide K=768 int16": "alpine_tpu_torch/csrc/fma_wide.cuh",
             "wtx fma_wide K=768 int16": "alpine_tpu_torch/csrc/fma_wide.cuh"}
K768 = 768  # the JAX package's component bucket level (alpine_tpu/ops/mu.py:1681)
# kernel_wide's P1/P2 bench rows above K = 512 (hxt_wide, wtx_wide; and
# hxt_fma_wide, wtx_fma_wide on float32 X)
WIDE_BENCH_KS = (520, 768, 1024, 2048)
FMA_WIDE_KS = (768, 1024, 2048)
K768_BLOCKS = (192, 192, 384)
K768_ITERS = 20
K768_INT16_ITERS = 10  # slice_k768_int16's fit (cut, as slice_k768's, for the time limit)
# slice_k768_int16's counts: the bench counts times this, so that some pass
# 127 (the largest is 38; x 3 would stay at 114, which "auto" stores as
# int8), in the first 5,000 cells too (largest 32)
K768_INT16_SCALE = 5
K768_SMALL_CELLS = 5000
K768_MODE_CELLS = 20_000
K768_MODE_ITERS = 5


def wide_blocks(K):
    """Two covariates of K // 4 and K // 8 components, the rest unguided."""
    return (K // 4, K // 8, K - K // 4 - K // 8)


def transform_steps_direct(torch, _build, num2, H0, WtW2, n_iter):
    """fused_transform's per-step path called through its C entry at any K
    (the wrapper takes it only for K > 512), for the bit-for-bit check
    against the register and tiled paths; not counted as a launch."""
    K, n = H0.shape
    out, scratch = torch.empty_like(H0), torch.empty_like(H0)
    At = torch.empty((K, K), dtype=torch.float32, device=H0.device)
    rc = _build.entry("fused_transform")(
        num2.data_ptr(), H0.data_ptr(), WtW2.data_ptr(), K, 0, n, 0, 0, 0, 0, n_iter, EPS,
        scratch.data_ptr(), At.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"fused_transform's per-step path failed to launch: CUDA error {rc}")
    return out


def run_kernel_wide_phase(torch, kernels, _build, gen, dev, card):
    """Every large-K route (K > 512) against its plain version on the card:
    small ragged shapes (70 genes x 17, 1,001 and 5,040 cells; int8, bf16,
    int16, float32 X; K = 513, 600, 768, 1024, 2048; X at a 1-byte offset
    too), a second launch of each bit for bit the first; K3's per-step path
    and, called directly at K = 40, 300 and 512, bit for bit the register
    and tiled paths.
    Then rows at the bench shape, K = 768: K1, K4, K2 (int8) and K1 on
    float32 X, K3 (50 steps), each with its time, bound, plain and library
    time, grid and device ms by kernel; P1 and P2 (hxt_wide, wtx_wide) at
    K = 520, 768, 1024 and 2048 and P2 at k = 384, and at K = 768 on the
    minibatch's 8,192 cells and on 66,667 cells beside their 66,672-cell
    twin (zero cells added: the same bits), each with the card's µs of a
    call beside bf16 torch.matmul's.  Returns the bench rows by name."""
    flat = lambda o: [t for v in (o if isinstance(o, tuple) else (o,))
                      for t in (v if isinstance(v, tuple) else (v,))]
    worst = {}  # kernel -> (worst error over tolerance, max abs error, cases)

    def hold(name, kern, plain, rtol, atol, hs=None):
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        got, again, want = flat(got), flat(again), flat(want)
        if hs is not None:
            # int8/bf16 X: XHt against the plain product over the kernel's own
            # Hs; an Hn one ulp off the plain one can round Hs to the next
            # bf16 value, which moves a sum over 17 cells past rtol 1e-4
            want[1] = kernels.hxt_plain(hs[0], hs[1](got[0])).T
        errs = [compare(a, b, rtol, atol) for a, b in zip(got, want)]
        w, a = max(e[1] for e in errs), max(e[0] for e in errs)
        check(w <= 1.0, f"kernel_wide {name}: disagrees with its plain version ({w})")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"kernel_wide {name}: a second launch gave other bits")
        kname = name.split()[0]
        old = worst.get(kname, (0.0, 0.0, 0))
        worst[kname] = (max(old[0], w), max(old[1], a), old[2] + 1)
        return got

    xdts = (torch.int8, torch.bfloat16, torch.int16, torch.float32)
    mixed_counts = lambda n: torch.randint(0, 4, (2, n), generator=gen, device=dev).float()
    for xdt in xdts:
        kl = xdt in (torch.int8, torch.float32)
        for K in WIDE_KS:
            blocks = wide_blocks(K)
            for n in WIDE_NS:
                X, W, H, WtW, Ys, Bs, lam = iteration_problem(
                    torch, gen, dev, WIDE_G, n, blocks, (2, 3), xdt)
                if xdt == torch.int16:
                    X *= 3
                variants = [("", X)]
                if xdt == torch.int8 and n == 5040:
                    variants.append((" offset 1", at_byte_offset(torch, X, 1)))
                bf16 = xdt in kernels._MMA_XTYPES
                for note, Xv in variants:
                    tag = f"{str(xdt)[6:]} K={K} n={n}{note}"
                    C = mixed_counts(n)
                    hs = (Xv, lambda Hn: Hn) if bf16 else None
                    hold(f"fused_iteration {tag}",
                         lambda: kernels.fused_iteration(Xv, W, H, WtW, Ys, Bs, lam, EPS,
                                                         blocks=blocks, loss_kl=kl),
                         lambda: kernels.fused_iteration_plain(Xv, W, H, WtW, Ys, Bs, lam, EPS,
                                                               blocks=blocks, loss_kl=kl),
                         1e-4, 1e-6, hs)
                    got = hold(f"fused_iteration_counts {tag}",
                               lambda: kernels.fused_iteration(Xv, W, H, WtW, Ys, Bs, lam, EPS,
                                                               C, blocks=blocks, loss_kl=kl),
                               lambda: kernels.fused_iteration_plain(
                                   Xv, W, H, WtW, Ys, Bs, lam, EPS, C, blocks=blocks,
                                   loss_kl=kl), 1e-4, 1e-6,
                               (Xv, lambda Hn: Hn * C[1]) if bf16 else None)
                    undrawn = C[0] == 0
                    check(torch.equal(got[0][:, undrawn], H[:, undrawn]),
                          f"kernel_wide K4 {tag}: undrawn columns must keep H bit for bit")
                    hold(f"fused_h_update {tag}",
                         lambda: kernels.fused_h_update(Xv, W, H, WtW, EPS),
                         lambda: kernels.fused_h_update_plain(Xv, W, H, WtW, EPS), 1e-4, 1e-6,
                         hs)
                    hold(f"hxt {tag}", lambda: kernels.hxt(Xv, H),
                         lambda: kernels.hxt_plain(Xv, H), 1e-4, 1e-6)
                    hold(f"wtx {tag}", lambda: kernels.wtx(Xv, W),
                         lambda: kernels.wtx_plain(Xv, W), 1e-4, 1e-6)
                del X, W, H, WtW, Ys, Bs, variants
    # 60 labels over 768 guided components at K = 2048: iter_wide reads Bg
    # through the cache (it does not fit beside the label rows) in 8 label
    # passes, gram_wide takes 8 blocks of extra columns a row tile
    many, K, n = (30, 30), 2048, 1001
    blocks = wide_blocks(K)
    check(not kernels.wide_stages_bg(sum(many), sum(blocks[:-1]), False),
          "kernel_wide: 60 labels at K = 2048 should not stage Bg")
    for xdt in (torch.int8, torch.float32):
        X, W, H, WtW, Ys, Bs, lam = iteration_problem(torch, gen, dev, WIDE_G, n, blocks, many,
                                                      xdt)
        bf16 = xdt in kernels._MMA_XTYPES
        C = mixed_counts(n)
        for Cc in (None, C):
            hold(f"fused_iteration {str(xdt)[6:]} K={K} n={n} L=60 counts={Cc is not None}",
                 lambda: kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, EPS, Cc,
                                                 blocks=blocks, loss_kl=True),
                 lambda: kernels.fused_iteration_plain(X, W, H, WtW, Ys, Bs, lam, EPS, Cc,
                                                       blocks=blocks, loss_kl=True),
                 1e-4, 1e-6,
                 (X, (lambda Hn: Hn) if Cc is None else (lambda Hn: Hn * C[1])) if bf16 else None)
        del X, W, H, WtW, Ys, Bs
    # gram_wide alone (the chain's H Hᵀ, HHtU, rowsum and Bnum) at every K
    # and cell count, with and without counts, 5 labels (the diagonal
    # blocks' extra columns) and 9 (a second chunk: blocks of their own);
    # HHt and HHtU exactly symmetric
    real = lambda out: tuple(t for t in out if t is not None)
    for K in WIDE_KS:
        for n in WIDE_NS:
            Hn = torch.rand((K, n), generator=gen, device=dev) + 0.05
            cn = torch.randint(0, 4, (n,), generator=gen, device=dev).float()
            for L in (5, 9):
                Q = torch.rand((L, n), generator=gen, device=dev)
                for c in (None, cn):
                    got = hold(f"gram_wide K={K} n={n} L={L} counts={c is not None}",
                               lambda: real(kernels.gram_wide(Hn, c, Q)),
                               lambda: real(kernels.gram_wide_plain(Hn, c, Q)), 1e-4, 1e-6)
                    check(torch.equal(got[0], got[0].T)
                          and (c is None or torch.equal(got[1], got[1].T)),
                          f"kernel_wide gram_wide K={K} n={n}: HHt not symmetric")
            del Hn, cn, Q
    # the large-K product alone (wtw_gemm's store: the chain's D = WᵀW H) at
    # every K and cell count, B at a 4-byte offset too (rows off 16-byte
    # alignment at any n)
    for K in WIDE_KS:
        A = torch.rand((K, K), generator=gen, device=dev)
        for n in WIDE_NS:
            Bm = torch.rand((K, n + 1), generator=gen, device=dev) + 0.05
            for note, Bv in (("", Bm[:, :n].contiguous()),
                             (" offset 4", Bm.view(-1)[1:1 + K * n].view(K, n))):
                hold(f"wtw_gemm K={K} n={n}{note}", lambda: kernels.wtw_gemm(A, Bv),
                     lambda: kernels.wtw_gemm_plain(A, Bv), 1e-4, 1e-6)
        del A, Bm, Bv
    # K3: the per-step path at every K > 512, and at a K of the register and
    # of the tiled path called directly
    for K in WIDE_KS + STEPS_SAME_BITS_KS:
        for n in WIDE_NS:
            W = torch.rand((WIDE_G, K), generator=gen, device=dev)
            X = torch.poisson(torch.full((WIDE_G, n), 1.5, device=dev), generator=gen)
            num2, WtW2 = 2.0 * (W.T @ X), 2.0 * (W.T @ W)
            H0 = torch.rand((K, n), generator=gen, device=dev) + 0.05
            if K in STEPS_SAME_BITS_KS:
                # every path forms its sums and update alike: the same bits
                got = kernels.fused_transform(num2, H0, WtW2, EPS, n_iter=TRANSFORM_ITERS)
                check(torch.equal(transform_steps_direct(torch, _build, num2, H0, WtW2,
                                                         TRANSFORM_ITERS), got),
                      f"kernel_wide: K3's per-step path at K={K} n={n} must give the "
                      f"{kernels.transform_path(K)} path's bits")
                continue
            hold(f"fused_transform {kernels.transform_path(K)} K={K} n={n}",
                 lambda: kernels.fused_transform(num2, H0, WtW2, EPS, n_iter=TRANSFORM_ITERS),
                 lambda: kernels.fused_transform_plain(num2, H0, WtW2, EPS,
                                                       n_iter=TRANSFORM_ITERS),
                 2e-4, 1e-6)
    emit({"phase": "kernel_wide", "small_cases": {
        k: {"cases": c, "worst_err_over_tolerance": w, "max_abs_err": a}
        for k, (w, a, c) in worst.items()},
        "ks": list(WIDE_KS), "cells": list(WIDE_NS), "genes": WIDE_G, "gram_labels": [5, 9],
        "wtw_gemm_b_offsets_bytes": [0, 4],
        "many_labels": {"K": 2048, "cells": 1001, "labels": 60, "bg_staged": False},
        "steps_bit_equal_other_paths_at": list(STEPS_SAME_BITS_KS),
        "tolerance": "rtol 1e-4 (K3 2e-4), atol 1e-6*max|plain| per output (K1/K2/K4 "
                     "on int8/bf16 X: XHt against the plain product over the kernel's "
                     "own Hs); second launch bit for bit"})
    torch.cuda.empty_cache()
    return run_kernel_wide_bench(torch, kernels, gen, dev, card)


def device_ms_by_kernel(torch, fn):
    """The card's ms of each CUDA kernel one call of `fn` launches
    (torch.profiler), by kernel name; empty where the profiler saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:48]: e.self_device_time_total * 1e-3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def run_kernel_wide_bench(torch, kernels, gen, dev, card):
    """The bench-shape rows of kernel_wide (100k x 2,000, K = 768), the
    large-K chain's rows (K1, K4, K2) and K3's with the card's ms of each
    kernel they launch."""
    rows = {}

    def timed_row(name, kern, plain, library, library_name, rtol, atol, cost, grid, note=None,
                  names=("out",), xht_of=None, extra=None):
        # every output against the plain version's, and a second launch bit
        # for bit the first, as the K <= 512 rows (run_iteration_case) hold them
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        got, again, want = flat(got), flat(again), flat(want)
        if xht_of is not None:
            # int8 X: XHt against the plain product over the kernel's own Hs
            want[1] = xht_of(got[0])
        errs = [compare(a, b, rtol, atol) for a, b in zip(got, want)]
        repeats = all(torch.equal(a, b) for a, b in zip(got, again))
        worst = max(e[1] for e in errs)
        del got, again, want
        row = {"phase": "kernel_wide", "case": name, "max_abs_err": max(e[0] for e in errs),
               "worst_err_over_tolerance": worst,
               "err_by_output": {nm: {"max_abs_err": e[0], "worst_err_over_tolerance": e[1]}
                                 for nm, e in zip(names, errs)},
               "second_launch_bit_equal": repeats,
               "tolerance": f"rtol {rtol}, atol {atol}*max|plain| per output"
                            + (" (XHt against the plain product over the kernel's own Hs)"
                               if xht_of is not None else ""),
               "ms": time_ms(kern, 5), "plain_ms": time_ms(plain, 3),
               "library_ms": time_ms(library, 3), "library": library_name,
               "bytes": cost[0], "bf16_flop": cost[1], "fp32_flop": cost[2], "grid": grid}
        row["bound_ms"], row["bound_by"] = bound(*cost, card)
        if name.startswith(("hxt", "wtx")):  # the card's time of a call, and the library's
            row["device_us"], row["kernels_a_call"] = device_us(torch, kern)
            row["library_device_us"], _ = device_us(torch, library)
            row["device_ms_by_kernel"] = device_ms_by_kernel(torch, kern)
        else:
            row["device_ms_by_kernel"] = device_ms_by_kernel(torch, kern)
        if note:
            row["note"] = note
        row.update(extra or {})
        emit(row)
        check(len(errs) == len(names), f"kernel_wide {name}: {len(errs)} outputs, "
                                       f"{len(names)} names")
        bad = [nm for nm, e in zip(names, errs) if e[1] > 1.0]
        check(not bad, f"kernel_wide {name}: {bad} disagree with the plain version's")
        check(repeats, f"kernel_wide {name}: a second launch gave other bits")
        rows[name] = row
        return row

    flat = lambda o: [t for v in (o if isinstance(o, tuple) else (o,))
                      for t in (v if isinstance(v, tuple) else (v,))]

    def iteration_names(blocks, counts, guided=True):
        head = ["Hn", "XHt", "HHt"] + (["HHtU"] if counts else []) + ["lossdot"]
        if not guided:
            return tuple(head)
        per = lambda what: [f"{what}[{c}]" for c in range(len(blocks) - 1)]
        return tuple(head + per("pred") + per("bnum") + per("bden"))

    labels = (2, 3)
    for xdt, kinds in ((torch.int8, ("K1", "K4", "K2")), (torch.float32, ("K1",)),
                       (torch.int16, ("K1",))):
        bf16 = xdt == torch.int8
        X, W, H, WtW, Ys, Bs, lam = iteration_problem(torch, gen, dev, G, N, K768_BLOCKS,
                                                      labels, xdt)
        if xdt == torch.int16:
            X *= 3  # counts above 127: what "auto" stores as int16
        cdt = torch.bfloat16 if bf16 else torch.float32
        Xc, Wc, Hc = X.to(cdt), W.to(cdt), H.to(cdt)
        library = lambda: (Wc.T @ Xc, Hc @ Xc.T, WtW @ H, H @ H.T)
        lib_name = (f"{str(cdt)[6:]} torch.matmul X products (WᵀX, H Xᵀ) and fp32 "
                    "torch.matmul (WᵀW)H, H Hᵀ")
        grid = kernels.iteration_grid(G, N, K768, xdt)._asdict()
        for kind in kinds:
            if kind == "K2":
                blocks, args = (K768,), ()
                kern = lambda: kernels.fused_h_update(X, W, H, WtW, EPS)
                plain = lambda: kernels.fused_h_update_plain(X, W, H, WtW, EPS)
                name = "fused_h_update wide"
                cost = iteration_cost(G, N, (K768,), (), 1, True, symmetric=True)
                full = iteration_cost(G, N, (K768,), (), 1, True)
                names, Hs = iteration_names((K768,), False, guided=False), lambda Hn: Hn
            else:
                C = None
                if kind == "K4":
                    C = torch.randint(0, 3, (2, N), generator=gen, device=dev).float()
                kern = lambda C=C: kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, EPS, C,
                                                           blocks=K768_BLOCKS, loss_kl=True)
                plain = lambda C=C: kernels.fused_iteration_plain(
                    X, W, H, WtW, Ys, Bs, lam, EPS, C, blocks=K768_BLOCKS, loss_kl=True)
                name = ("fused_iteration_counts wide" if kind == "K4" else "fused_iteration wide")
                if not bf16:
                    name += f" {str(xdt)[6:]}"
                cost = iteration_cost(G, N, K768_BLOCKS, labels, X.element_size(), bf16,
                                      counts=kind == "K4", symmetric=True)
                full = iteration_cost(G, N, K768_BLOCKS, labels, X.element_size(), bf16,
                                      counts=kind == "K4")
                names = iteration_names(K768_BLOCKS, C is not None)
                Hs = (lambda Hn: Hn) if C is None else (lambda Hn, C=C: Hn * C[1])
            xht_of = lambda Hn, Hs=Hs: kernels.hxt_plain(X, Hs(Hn)).T
            # beside the bound, that of the full K x K products (as the chain
            # formed H Hᵀ before it took the upper triangle alone)
            row = timed_row(name, kern, plain, library, lib_name, 1e-4, 1e-6, cost, grid,
                            names=names, xht_of=xht_of if bf16 else None,
                            extra={"bound_full_ms": bound(*full, card)[0]})
            by = row["device_ms_by_kernel"]
            # X's passes: the wgmma kernels on int8 X, the fp32 ones else
            passes = ("hxt_wide", "wtx_wide") if bf16 else ("hxt_fma_wide", "wtx_fma_wide")
            check(not by or all(any(k in key for key in by)
                                for k in ("gram_wide", "iter_wide") + passes),
                  f"kernel_wide {name}: its kernels {sorted(by)} lack one of gram_wide, "
                  f"iter_wide, {passes}")
        del X, W, H, WtW, Ys, Bs, Xc, Wc, Hc
        torch.cuda.empty_cache()
    # gram_wide alone at the bench shape (5 labels), without and with counts,
    # beside fp32 torch.matmul (no TF32) of H Hᵀ (counts mode: Hs Hnᵀ and
    # Hn Hnᵀ)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    Hn = torch.rand((K768, N), generator=gen, device=dev) + 0.05
    Q = torch.rand((sum(labels), N), generator=gen, device=dev)
    cn = torch.randint(0, 3, (N,), generator=gen, device=dev).float()
    real = lambda out: tuple(t for t in out if t is not None)
    n_split, cps = kernels.gram_wide_grid(N, K768)
    ggrid = {"pairs": len(kernels.gram_wide_pairs(K768)), "splits": n_split,
             "cells_per_split": cps, "blocks": kernels.gram_items(K768, sum(labels)) * n_split}
    for c in (None, cn):
        Hs = Hn if c is None else Hn * c
        lib = ((lambda: torch.matmul(Hn, Hn.T)) if c is None
               else (lambda Hs=Hs: (torch.matmul(Hs, Hn.T), torch.matmul(Hn, Hn.T))))
        timed_row(f"gram_wide{'' if c is None else ' counts'} K={K768}",
                  lambda c=c: real(kernels.gram_wide(Hn, c, Q)),
                  lambda c=c: real(kernels.gram_wide_plain(Hn, c, Q)), lib,
                  "fp32 torch.matmul(Hn, Hn.T), TF32 off" if c is None else
                  "fp32 torch.matmul(Hs, Hn.T) and (Hn, Hn.T), TF32 off", 1e-4, 1e-6,
                  gram_cost(K768, N, sum(labels), c is not None), ggrid,
                  names=("HHt", "rowsum", "Bnum") if c is None
                  else ("HHt", "HHtU", "rowsum", "Bnum"))
    # the chain's D = WᵀW H alone (wtw_gemm's store) beside fp32
    # torch.matmul(WtW, H), TF32 off, which is its plain version too
    Wt = torch.rand((G, K768), generator=gen, device=dev)
    WtW = Wt.T @ Wt
    mm = lambda: torch.matmul(WtW, Hn)
    timed_row(f"wtw_gemm K={K768}", lambda: kernels.wtw_gemm(WtW, Hn),
              lambda: kernels.wtw_gemm_plain(WtW, Hn), mm,
              "fp32 torch.matmul(WtW, H), TF32 off", 1e-4, 1e-6,
              (4 * (K768 * K768 + 2 * K768 * N), 0.0, 2.0 * K768 * K768 * N),
              kernels.wtw_design(K768, N),
              names=("D",))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    del Hn, Q, cn, Hs, Wt, WtW
    torch.cuda.empty_cache()
    # K3 at K = 768: the per-step path, 50 launches a call
    Wt = torch.rand((G, K768), generator=gen, device=dev)
    Xt = torch.poisson(torch.full((G, N), 1.5, device=dev), generator=gen)
    num2, WtW2 = 2.0 * (Wt.T @ Xt), 2.0 * (Wt.T @ Wt)
    del Xt
    H0 = torch.rand((K768, N), generator=gen, device=dev) + 0.05
    t_ops = TRANSFORM_ITERS * (2.0 * K768 * K768 + 3.0 * K768) * N
    timed_row(f"fused_transform wide K={K768} n_iter={TRANSFORM_ITERS}",
              lambda: kernels.fused_transform(num2, H0, WtW2, EPS, n_iter=TRANSFORM_ITERS),
              lambda: kernels.fused_transform_plain(num2, H0, WtW2, EPS, n_iter=TRANSFORM_ITERS),
              lambda: [torch.matmul(WtW2, H0) for _ in range(TRANSFORM_ITERS)],
              f"{TRANSFORM_ITERS} x fp32 torch.matmul(WtW2, H)", 2e-4, 1e-6,
              (3 * 4 * K768 * N + 4 * K768 * K768, 0.0, t_ops),
              {"path": kernels.transform_path(K768)})
    del Wt, num2, WtW2, H0
    torch.cuda.empty_cache()
    # P1/P2 above K = 512 (hxt_wide, wtx_wide) at the bench shape at K = 520,
    # 768, 1024 and 2048, and P2 at an ALS block's k = 384 (wtx_mma); then at
    # K = 768 the minibatch batch (8,192 cells) and an optimizer fold's
    # 66,667 cells (rows off 16-byte alignment) beside its 66,672-cell twin
    X, W, H = make_x_pass_problem(torch, gen, dev, G, N, max(WIDE_BENCH_KS), torch.int8)
    Xc = X.to(torch.bfloat16)
    cases = [(kind, K) for K in WIDE_BENCH_KS for kind in ("hxt", "wtx")] + [("wtx", K768 // 2)]
    for kind, K in cases:
        P = H[:K].contiguous() if kind == "hxt" else W[:, :K].contiguous()
        wide_row(torch, kernels, timed_row, kind, X, Xc, P, K,
                 f"{kind} {'wide' if K > 512 else 'k=384'} K={K}")
    del X, W, H, Xc, P
    torch.cuda.empty_cache()
    # P1/P2 on float32 and int16 X (hxt_fma_wide, wtx_fma_wide) at K = 768
    # and, on float32, 1024 and 2048, beside fp32 torch.matmul (TF32 off;
    # int16 through a float32 copy)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    for xdt in (torch.float32, torch.int16):
        ks = FMA_WIDE_KS if xdt == torch.float32 else (K768,)
        X, W, H = make_x_pass_problem(torch, gen, dev, G, N, max(ks), xdt)
        Xc = X.float()
        for K in ks:
            for kind in ("hxt", "wtx"):
                P = H[:K].contiguous() if kind == "hxt" else W[:, :K].contiguous()
                wide_row(torch, kernels, timed_row, kind, X, Xc, P, K,
                         f"{kind} fma_wide K={K} {str(xdt)[6:]}")
        del X, W, H, Xc, P
        torch.cuda.empty_cache()
    # at K = 768: the minibatch batch (8,192 cells, int8) and an optimizer
    # fold's 66,667 cells (rows off 16-byte alignment) beside its
    # 66,672-cell twin, on int8 X (the wgmma kernels) and on float32 and
    # int16 X (the fp32 ones)
    for xdt, ns in ((torch.int8, (MB_BATCH, 66_667, 66_672)),
                    (torch.float32, (66_667, 66_672)), (torch.int16, (66_667, 66_672))):
        twins = {}
        tag = "wide" if xdt == torch.int8 else "fma_wide"
        dt = "" if xdt == torch.int8 else f" {str(xdt)[6:]}"
        for n in ns:
            if n == 66_672:  # the 66,667-cell problem padded with zero cells
                X = torch.zeros((G, n), dtype=xdt, device=dev)
                X[:, :66_667] = twins["X"]
                H = torch.zeros((K768, n), device=dev)
                H[:, :66_667] = twins["H"]
                W = twins["W"]
            else:
                X, W, H = make_x_pass_problem(torch, gen, dev, G, n, K768, xdt)
            Xc = X.to(torch.bfloat16) if xdt == torch.int8 else X.float()
            for kind in ("hxt", "wtx"):
                got = wide_row(torch, kernels, timed_row, kind, X, Xc,
                               H if kind == "hxt" else W, K768,
                               f"{kind} {tag} K={K768} n={n}{dt}")
                if n == 66_667:
                    twins[kind] = got
                elif n == 66_672:
                    same = (torch.equal(got, twins["hxt"]) if kind == "hxt"
                            else torch.equal(got[:, :66_667], twins["wtx"]))
                    rows[f"{kind} {tag} K={K768} n={n}{dt}"]["twin_bit_equal"] = same
                    emit({"phase": "kernel_wide", "case": f"{kind} {tag} K={K768} twins{dt}",
                          "cells": [66_667, 66_672], "bit_equal": same,
                          "grid_equal": x_pass_grid(kernels, kind, G, 66_667, K768, xdt)
                          == x_pass_grid(kernels, kind, G, 66_672, K768, xdt)})
                    check(same, f"kernel_wide {kind}{dt} at 66,667 cells: not its 66,672-cell "
                                "twin's bits")
            if n == 66_667:
                twins.update(X=X, W=W, H=H)
            del X, W, H, Xc
        twins.clear()
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = tf32
    return rows


def wide_row(torch, kernels, timed_row, kind, X, Xc, P, K, name):
    """One P1 (P = H) or P2 (P = W) row of kernel_wide's bench rows: the
    kernel against its plain version, timed beside one torch.matmul over
    Xc, a copy of X made outside the timed region (int8/bf16 X: bf16
    operands; float32/int16 X: fp32, TF32 off); returns the kernel's
    output."""
    g, n = X.shape
    bf16 = X.dtype in kernels._MMA_XTYPES
    Pc = P.bfloat16() if bf16 else P
    lib = ((lambda: torch.matmul(Pc, Xc.T)) if kind == "hxt" else (lambda: torch.matmul(Pc.T, Xc)))
    side = 4 * K * n if kind == "hxt" else 4 * g * K
    out = 4 * K * g if kind == "hxt" else 4 * K * n
    ops = 2.0 * K * g * n
    grid = x_pass_grid(kernels, kind, g, n, K, X.dtype)
    timed_row(name, lambda: getattr(kernels, kind)(X, P),
              lambda: getattr(kernels, f"{kind}_plain")(X, P), lib,
              "torch.matmul, bf16 operands" if bf16 else
              "fp32 torch.matmul, TF32 off" + (" (over a float32 copy of X)"
                                               if X.dtype == torch.int16 else ""),
              1e-4, 1e-6, (X.element_size() * g * n + side + out,
                           ops if bf16 else 0.0, 0.0 if bf16 else ops), grid)
    return getattr(kernels, kind)(X, P)


def run_k768_phase(torch, kernels, ALPINE, AnnData, counts, obs, phase="slice_k768",
                   iters=K768_ITERS, dtype="int8", extra=None):
    """slice_k768: ALPINE(n_components=384, n_covariate_components=[192,
    192]) (K = 768) through fit (``iters`` iterations) and a 50-step
    transform at 100k x 2,000 on ``counts``, which data_dtype "auto" must
    store as ``dtype`` (int8: P1/P2 as the wgmma kernels; int16, the counts
    x 5 of slice_k768_int16: the fp32 ones); then the same model on the
    first 5,000 cells on the card against the CPU.  ``extra`` joins the
    phase's line.  Returns the launches of the fit and transform."""
    adata = AnnData(counts, obs=obs)
    model = ALPINE(n_components=K768_BLOCKS[-1], n_covariate_components=list(K768_BLOCKS[:-1]),
                   lam=[1e3, 1e3], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    model.fit(adata, ["batch", "condition"], max_iter=iters)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(model._x_cache is not None, f"{phase}: the fit must keep its device X")
    t0 = time.perf_counter()
    model.transform(adata, n_iter=TRANSFORM_ITERS)  # through the fit's device X
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    emb_cached = {k: adata.obsm[k].copy() for k in ("ALPINE_embedding", "batch", "condition")}
    model.free_device_cache()
    model.transform(adata, n_iter=TRANSFORM_ITERS)  # uploads X again
    torch.cuda.synchronize()
    cache_ok = all(np.allclose(emb_cached[k], adata.obsm[k], rtol=1e-5) for k in emb_cached)
    L = model.loss_history_
    row = {"phase": phase, "components": K768, "blocks": list(K768_BLOCKS),
           "cells": N, "genes": G, "fit_seconds": fit_s, "fit_iterations": iters,
           "timings": model.timings_, "transform_seconds_cached": transform_s,
           "transform_iterations": TRANSFORM_ITERS, "data_dtype": model.data_dtype_,
           "transform_path": kernels.transform_path(K768),
           "launches": launches, "cached_matches_uncached": bool(cache_ok),
           "loss_first": L[0].tolist(), "loss_last": L[-1].tolist(),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(), **(extra or {})}
    model.free_device_cache()
    del model
    torch.cuda.empty_cache()
    check(row["data_dtype"] == dtype, f"{phase}: auto must resolve to {dtype}")
    check(launches["fused_iteration"] == iters,
          f"{phase}: {launches['fused_iteration']} K1 launches, expected {iters}")
    check(launches["hxt"] == 1, f"{phase}: {launches['hxt']} P1 launches, expected 1")
    # X's passes: P1's first X Hᵀ and, in each K1 call, its chain's WᵀX and
    # X Hsᵀ: the wgmma kernels on int8 X, the fp32 ones on int16
    used, unused = ("hxt_wide", "wtx_wide"), ("hxt_fma_wide", "wtx_fma_wide")
    if dtype != "int8":
        used, unused = unused, used
    check(launches[used[0]] == 1 + iters and launches[used[1]] == iters
          and launches[unused[0]] == launches[unused[1]] == 0,
          f"{phase}: {used[0]} {launches[used[0]]}, {used[1]} {launches[used[1]]} launches, "
          f"expected {1 + iters} and {iters}; {unused} {launches[unused[0]]}, "
          f"{launches[unused[1]]}, expected 0")
    check(launches["gram_wide"] == iters and launches["wtw_gemm"] == iters,
          f"{phase}: gram_wide {launches['gram_wide']}, wtw_gemm {launches['wtw_gemm']} "
          f"launches, expected {iters}")
    check(launches["fused_transform"] == 1, f"{phase}: transform must launch K3 once")
    check(np.isfinite(L).all(), f"{phase}: loss history must be finite")
    check(L[-1, 0] < L[0, 0], f"{phase}: total loss must fall")
    check(all(np.isfinite(v).all() for v in emb_cached.values()), f"{phase}: embeddings finite")
    check(emb_cached["ALPINE_embedding"].shape == (N, K768_BLOCKS[-1]), f"{phase}: shape")
    check(cache_ok, f"{phase}: cached and uncached transforms must agree (rtol 1e-5)")
    # the same model on the first cells: the card against the CPU (plain versions)
    m_cells = K768_SMALL_CELLS
    sub = {k: v[:m_cells] for k, v in obs.items()}
    fits = {}
    for where in ("cuda", "cpu"):
        ad = AnnData(counts[:m_cells], obs=sub)
        m = ALPINE(n_components=K768_BLOCKS[-1], n_covariate_components=list(K768_BLOCKS[:-1]),
                   lam=[1e3, 1e3], device=where, random_state=7)
        t0 = time.perf_counter()
        m.fit(ad, ["batch", "condition"], max_iter=iters)
        m.transform(ad, n_iter=TRANSFORM_ITERS)
        fits[where] = (m.loss_history_, ad.obsm["ALPINE_embedding"], time.perf_counter() - t0,
                       m.data_dtype_)
        m.free_device_cache()
    X64 = np.asarray(counts[:m_cells], dtype=np.float64)
    floor = 2e-6 * float(np.sum(np.square(X64)))
    loss_gap = float(np.max(np.abs(fits["cuda"][0] - fits["cpu"][0])
                            - 5e-4 * np.abs(fits["cpu"][0]) - floor))
    emb_ok = np.allclose(fits["cuda"][1], fits["cpu"][1], rtol=5e-3, atol=1e-5)
    rel = float(np.linalg.norm(fits["cuda"][1] - fits["cpu"][1])
                / np.linalg.norm(fits["cpu"][1]))
    row.update({"small_cells": m_cells, "small_loss_excess_over_tolerance": loss_gap,
                "small_embedding_allclose": bool(emb_ok),
                "small_embedding_relative_frobenius": rel,
                "small_seconds": {w: f[2] for w, f in fits.items()},
                "small_data_dtype": fits["cuda"][3],
                "small_tolerance": "loss rtol 5e-4 + 2e-6*|X|^2, embedding rtol 5e-3 atol 1e-5"})
    emit(row)
    check(fits["cuda"][3] == fits["cpu"][3] == dtype,
          f"{phase}: the small fits stored X as {fits['cuda'][3]} / {fits['cpu'][3]}")
    check(loss_gap <= 0 and emb_ok, f"{phase}: the card's fit disagrees with the CPU's")
    return launches


def run_k768_modes_phase(torch, kernels, ALPINE, AnnData, counts, obs):
    """slice_k768_modes: K = 768 on the first 20,000 cells, 5 iterations
    (epochs) each: unguided (K2), weighted_fast (K4), use_als=True (P1 at
    K = 768, P2 a block) and random minibatch of 8,192 (P1 and P2 at
    K = 768).  Returns each mode's launches."""
    n = K768_MODE_CELLS
    sub = {k: v[:n] for k, v in obs.items()}
    nb = -(-n // MB_BATCH)
    # the wgmma X passes (hxt_wide, wtx_wide) in every P1/P2 call at K = 768
    # and twice in each K2/K4 call (its chain's WᵀX and X Hsᵀ); ALS's blocks
    # (192, 192, 384 components) take wtx_mma
    its = K768_MODE_ITERS
    modes = (("unguided", dict(n_components=K768, n_covariate_components=[], lam=[]), {},
              {"fused_h_update": its, "hxt": 1, "hxt_wide": its + 1, "wtx_wide": its,
               "gram_wide": its, "wtw_gemm": its}),
             ("weighted_fast", {}, dict(sampling_method="weighted_fast"),
              {"fused_iteration_counts": its, "fused_iteration": 0,
               "hxt_wide": its + 1, "wtx_wide": its, "gram_wide": its, "wtw_gemm": its}),
             ("als", dict(use_als=True), {},
              {"hxt": its, "wtx": 3 * its, "fused_iteration": 0, "hxt_wide": its,
               "wtx_wide": 0, "gram_wide": 0, "wtw_gemm": 0}),
             ("minibatch", {}, dict(batch_size=MB_BATCH),
              {"hxt": nb * its, "wtx": (nb + 1) * its, "fused_iteration": 0,
               "hxt_wide": nb * its, "wtx_wide": (nb + 1) * its, "gram_wide": 0,
               "wtw_gemm": 0}))
    out = {}
    for name, model_kw, fit_kw, expect in modes:
        ad = AnnData(counts[:n], obs=sub)
        kw = dict(n_components=K768_BLOCKS[-1], n_covariate_components=list(K768_BLOCKS[:-1]),
                  lam=[1e3, 1e3], device="cuda")
        kw.update(model_kw)
        m = ALPINE(**kw)
        keys = [] if name == "unguided" else ["batch", "condition"]
        kernels.reset_launches()
        t0 = time.perf_counter()
        m.fit(ad, keys, max_iter=K768_MODE_ITERS, **fit_kw)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        L = m.loss_history_
        emit({"phase": "slice_k768_modes", "mode": name, "cells": n, "genes": G,
              "components": K768, "iterations": K768_MODE_ITERS, "fit_seconds": fit_s,
              "launches": launches, "loss_first": L[0].tolist(), "loss_last": L[-1].tolist()})
        m.free_device_cache()
        del m
        for kname, want in expect.items():
            check(launches[kname] == want,
                  f"slice_k768_modes {name}: {launches[kname]} {kname} launches, expected {want}")
        check(np.isfinite(L).all(), f"slice_k768_modes {name}: loss history must be finite")
        out[name] = launches
    torch.cuda.empty_cache()
    return out


def run_bucket_phase(torch, kernels, mu, ALPINE, adata):
    """slice_bucket: component_bucket=8 pads the blocks (5, 5, 30) to (8, 8,
    32), so K1 runs at K = 48 and the transform (K3) at the true K = 40;
    then mu.fit_scan alone on the fit's device-resident int8 X from masked
    inits, whose phantom components must stay exactly zero."""
    from alpine_tpu_torch.models.alpine import draw_init

    model = ALPINE(n_components=30, n_covariate_components=[5, 5], lam=[1e3, 1e3],
                   device="cuda", component_bucket=8)
    kernels.reset_launches()
    t0 = time.perf_counter()
    model.fit(adata, ["batch", "condition"], max_iter=FIT_ITERS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = dict(kernels.launches)
    kernels.reset_launches()
    model.transform(adata)  # through the fit's device X, at the true K
    torch.cuda.synchronize()
    transform_launches = dict(kernels.launches)
    blocks, true = model._cfg_blocks(), tuple(model.n_all_components)
    sizes = [w.shape[1] for w in model.matrices["Ws"]]
    L = model.loss_history_
    # the same padded fit through mu.fit_scan, its phantom components read back
    X = model._x_cache[0]
    Ys = [torch.from_numpy(y.T.copy()).to(X.device) for y in model.fe.transform(adata.obs)]
    cfg = mu.MUConfig(blocks=blocks, n_labels=N_LABELS, n_cells=N, max_iter=FIT_ITERS,
                      x_dtype="int8")
    W0, H0, Bs0 = mu.mask_block_padding(
        blocks, true, *draw_init(cfg, G, model.random_state, EPS, X.device))
    kernels.reset_launches()
    W, H, Bs, Lm = mu.fit_scan(cfg, W0, H0, Bs0, X, Ys, model._hyper())
    torch.cuda.synchronize()
    valid = mu.block_valid_mask(blocks, true, X.device)
    phantom_zero = bool(not W[:, ~valid].any() and not H[~valid].any()
                        and all(not b[:, k:].any() for b, k in zip(Bs, true)))
    scan_launches = dict(kernels.launches)
    emit({"phase": "slice_bucket", "component_bucket": 8, "blocks": list(blocks),
          "true_blocks": list(true), "fit_seconds": fit_s, "timings": model.timings_,
          "fit_iterations": FIT_ITERS, "launches_fit": fit_launches,
          "launches_transform": transform_launches, "stored_block_sizes": sizes,
          "loss_first": L[0].tolist(), "loss_last": L[-1].tolist(),
          "fit_scan_launches": scan_launches, "fit_scan_phantom_exactly_zero": phantom_zero,
          "fit_scan_loss_last": Lm[-1].tolist()})
    check(blocks == (8, 8, 32), f"slice_bucket: blocks {blocks}")
    check(fit_launches["fused_iteration"] == FIT_ITERS,
          "slice_bucket: fused_iteration must launch once an iteration at K = 48")
    check(transform_launches["fused_transform"] == 1 and sizes == [5, 5, 30],
          "slice_bucket: one K3 launch at the true K = 40, true-sized matrices")
    check(np.isfinite(L).all() and L[-1, 0] < L[0, 0], "slice_bucket: loss")
    check(scan_launches["fused_iteration"] == FIT_ITERS and phantom_zero,
          "slice_bucket: phantom components must stay exactly zero through K1")
    check(bool(torch.isfinite(Lm).all()), "slice_bucket: fit_scan loss finite")
    model.free_device_cache()
    del X, Ys, W, H, Bs, W0, H0, Bs0
    torch.cuda.empty_cache()
    return fit_launches


def run_restarts_phase(torch, kernels, mu, ALPINE, adata, slice_losses):
    """slice_restarts: three restarts of the slice's fit one after another on
    one upload of X; restart 0 is the slice's fit (its loss history's
    bits), the winner's final loss at most restart 0's."""
    runs, uploads = [], []
    fit_scan, cast = mu.fit_scan, ALPINE._cast_x_host

    def spy(*args, **kw):
        out = fit_scan(*args, **kw)
        runs.append(out[3].cpu().numpy())
        return out

    def counting_cast(self, *args, **kw):
        uploads.append(1)
        return cast(self, *args, **kw)

    model = ALPINE(n_components=30, n_covariate_components=[5, 5], lam=[1e3, 1e3],
                   device="cuda")
    mu.fit_scan, ALPINE._cast_x_host = spy, counting_cast
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        model.fit(adata, ["batch", "condition"], max_iter=FIT_ITERS, n_restarts=3)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        mu.fit_scan, ALPINE._cast_x_host = fit_scan, cast
    launches = dict(kernels.launches)
    L = model.loss_history_
    finals = [float(r[-1, 0]) for r in runs]
    emit({"phase": "slice_restarts", "n_restarts": 3, "fit_iterations": FIT_ITERS,
          "fit_seconds": fit_s, "timings": model.timings_, "launches": launches,
          "x_uploads": len(uploads), "final_total_losses": finals,
          "winner": int(np.nanargmin(finals)), "loss_last": L[-1].tolist(),
          "restart0_bits_equal_slice": bool(np.array_equal(runs[0], slice_losses))})
    check(launches["fused_iteration"] == 3 * FIT_ITERS,
          "slice_restarts: fused_iteration must launch once an iteration of each restart")
    check(len(uploads) == 1, f"slice_restarts: X uploaded {len(uploads)} times")
    check(len(runs) == 3 and L[-1, 0] <= finals[0], "slice_restarts: the winner must be "
          "no worse than restart 0")
    check(np.array_equal(runs[0], slice_losses),
          "slice_restarts: restart 0 must have the bits of the slice's fit")
    model.free_device_cache()
    torch.cuda.empty_cache()
    return launches


def run_checkpoint_phase(torch, kernels, ALPINE, adata, slice_losses):
    """slice_checkpoint: the slice's fit with a snapshot every 10 iterations,
    interrupted after its second snapshot, resumed by a fresh model, held
    against the slice's loss history (each chunk start computes X Hᵀ with
    hxt, where the single fit carries K1's); the snapshot is gone after
    success."""
    import tempfile

    import alpine_tpu_torch.io.checkpoint as ckpt

    class Interrupt(Exception):
        pass

    saves, orig = [], ckpt.FitCheckpointer.save

    def timed_save(self, *args, interrupt_after=None):
        t0 = time.perf_counter()
        orig(self, *args)
        saves.append((time.perf_counter() - t0, os.path.getsize(self.path)))
        if interrupt_after is not None and len(saves) == interrupt_after:
            raise Interrupt

    make = lambda: ALPINE(n_components=30, n_covariate_components=[5, 5],
                          lam=[1e3, 1e3], device="cuda")
    kw = dict(max_iter=FIT_ITERS, checkpoint_every=10)
    with tempfile.TemporaryDirectory() as d:
        ckpt.FitCheckpointer.save = lambda self, *a: timed_save(self, *a, interrupt_after=2)
        try:
            t0 = time.perf_counter()
            make().fit(adata, ["batch", "condition"], checkpoint_dir=d, **kw)
            check(False, "slice_checkpoint: the first fit must be interrupted")
        except Interrupt:
            first_s = time.perf_counter() - t0
        finally:
            ckpt.FitCheckpointer.save = orig
        left = os.listdir(d)
        model = make()
        ckpt.FitCheckpointer.save = timed_save
        try:
            kernels.reset_launches()
            t0 = time.perf_counter()
            model.fit(adata, ["batch", "condition"], checkpoint_dir=d, **kw)
            torch.cuda.synchronize()
            resumed_s = time.perf_counter() - t0
        finally:
            ckpt.FitCheckpointer.save = orig
        launches = dict(kernels.launches)
        gone = not os.listdir(d)
    L = model.loss_history_
    rel = np.max(np.abs(L - slice_losses) / np.abs(slice_losses), axis=0)
    emit({"phase": "slice_checkpoint", "checkpoint_every": 10, "fit_iterations": FIT_ITERS,
          "interrupted_fit_seconds": first_s, "resumed_fit_seconds": resumed_s,
          "timings": model.timings_, "snapshots_after_interrupt": left,
          "launches_resumed": launches, "snapshot_seconds": [v[0] for v in saves],
          "snapshot_bytes": saves[0][1], "seconds_per_snapshot": float(
              np.mean([v[0] for v in saves])),
          "loss_max_rel_diff_slice": rel.tolist(),
          "first_chunk_bits_equal_slice": bool(np.array_equal(L[:10], slice_losses[:10])),
          "tolerance": "the first chunk bit for bit, every loss rtol 1e-4, against slice",
          "snapshot_removed": gone})
    check(len(left) == 1, f"slice_checkpoint: {left} after the interruption")
    check(launches["fused_iteration"] == FIT_ITERS - 20 and launches["hxt"] == 3,
          "slice_checkpoint: the resumed fit runs 30 iterations in 3 chunks")
    # the first chunk runs as the single fit does; from the first chunk
    # boundary on, bf16 roundings of W and H flip where the recomputed X Hᵀ
    # differs from K1's in the last bit
    check(np.array_equal(L[:10], slice_losses[:10]) and rel.max() <= 1e-4,
          f"slice_checkpoint: resumed loss history {rel.tolist()} from the slice's")
    check(gone, "slice_checkpoint: the snapshot must be removed after success")
    model.free_device_cache()
    torch.cuda.empty_cache()
    return launches


def h5ad_round_trip(adata, path, timed, sizes):
    """write_h5ad, read_h5ad in full and by a range of cells: what came
    back bit for bit."""
    from alpine_tpu_torch.io.h5ad import read_h5ad, write_h5ad

    timed("h5ad_write", lambda: write_h5ad(adata, path))
    sizes["h5ad"] = os.path.getsize(path)
    back = timed("h5ad_read", lambda: read_h5ad(path))
    lo, hi = N // 4, 3 * N // 5
    part = timed("h5ad_read_range", lambda: read_h5ad(path, obs_range=(lo, hi)))
    layer = "normalized_expression"
    return {
        "round_trip_bits_equal": {
            "X": np.array_equal(back.X, adata.X),
            "layer": np.array_equal(back.layers[layer], adata.layers[layer]),
            "obsm": all(np.array_equal(back.obsm[k], np.asarray(v))
                        for k, v in adata.obsm.items()),
            "varm": all(np.array_equal(back.varm[k], np.asarray(v))
                        for k, v in adata.varm.items()),
            "obs_names": list(back.obs_names) == list(adata.obs_names)},
        "range": [lo, hi],
        "range_equals_slice": {
            "X": np.array_equal(part.X, back.X[lo:hi]),
            "layer": np.array_equal(part.layers[layer], back.layers[layer][lo:hi]),
            "obsm": all(np.array_equal(part.obsm[k], back.obsm[k][lo:hi]) for k in back.obsm),
            "obs": all(list(part.obs[c]) == list(back.obs[c][lo:hi])
                       for c in back.obs.columns)}}


class StageTimers:
    """Seconds of a search's stages, from wrappers around the functions that
    run them: fold fits (batched.fit_fold), validation projections
    (mu.run_transform), the kNN search (scoring.exact_knn), the whole kNN
    graph (scoring.knn_graph, its search included) and Leiden
    (scoring.leiden_native).  Device stages end with a synchronize.  Hooks
    see each call's arguments and result (checks made outside the timed
    region)."""

    STAGES = ("fits", "transforms", "knn", "graph", "leiden")

    def __init__(self, torch, batched, mu, scoring, hooks=None):
        self.torch, self.hooks = torch, hooks or {}
        self.spent = dict.fromkeys(self.STAGES, 0.0)
        self.restore = []
        for module, name, stage, sync in ((batched, "fit_fold", "fits", True),
                                          (mu, "run_transform", "transforms", True),
                                          (scoring, "exact_knn", "knn", True),
                                          (scoring, "knn_graph", "graph", False),
                                          (scoring, "leiden_native", "leiden", False)):
            self._wrap(module, name, stage, sync)

    def _wrap(self, module, name, stage, sync):
        orig = getattr(module, name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            if sync:
                self.torch.cuda.synchronize()
            self.spent[stage] += time.perf_counter() - t0
            if stage in self.hooks:
                self.hooks[stage](orig, args, kw, out)
            return out

        setattr(module, name, timed)
        self.restore.append((module, name, orig))

    def take(self):
        """Seconds since the last take; graph without its kNN search."""
        out = dict(self.spent)
        out["graph"] -= out["knn"]
        self.spent = dict.fromkeys(self.STAGES, 0.0)
        return out

    def close(self):
        for module, name, orig in self.restore:
            setattr(module, name, orig)


OPT_KEYS = ["batch", "condition"]
OPT_MAX_ITER, OPT_SPLITS, OPT_EVALS = 50, 3, 4
PATHS_MAX_ITER = 10
# the paths phase's frozen parameters: the slice's blocks, auto-bucketed to
# (6, 6, 32)
PATHS_PARAMS = {"n_components": 30, "n_covariate_components": [5, 5],
                "lam": [1e3, 1e3], "orth_W": 0.0, "alpha_W": 0.0, "l1_ratio_W": 0.0}


def count_k3_paths(kernels):
    """Wrap ``kernels.fused_transform`` to count its launches by path (the
    rule by K: ``transform_bucket``), each with the largest K that took it:
    returns {"registers": [launches, K], "tiled": [launches, K]}.  The
    caller puts the wrapper's original back."""
    paths = {"registers": [0, 0], "tiled": [0, 0]}
    fused_transform = kernels.fused_transform

    def counted(num2, H0, *args, **kw):
        before = kernels.launches["fused_transform"]
        out = fused_transform(num2, H0, *args, **kw)
        K = H0.shape[0]
        entry = paths["registers" if kernels.transform_bucket(K) else "tiled"]
        entry[0] += kernels.launches["fused_transform"] - before
        entry[1] = max(entry[1], K)
        return out

    kernels.fused_transform = counted
    return paths


def trial_summary(trials):
    """Each trial's tid, point, loss, status and record (JSON-safe)."""
    return [{"tid": t["tid"],
             "vals": {k: [float(x) for x in v] for k, v in t["misc"]["vals"].items()},
             "loss": float(t["result"].get("loss", np.inf)),
             "status": t["result"]["status"], "params": t["result"].get("params")}
            for t in trials.trials]


def run_optimize_phase(torch, kernels, adata, cases):
    """slice_optimize: ComponentOptimizer's default search at the bench
    shape (fold batching, auto bucketing, native Leiden, kNN on the card),
    four trials of three folds, then fit_the_best_param.  Checks: finite
    scores, K1 and K3 launches, native Leiden, pad columns of H exactly
    zero after every fold fit, one fold's K3 output against the plain
    projection, one fold's card kNN against the float64 host search.  One
    trial's calc_score runs again through the sequential route."""
    from alpine_tpu_torch import ComponentOptimizer
    from alpine_tpu_torch.native import build_error, leiden_backend
    from alpine_tpu_torch.ops import mu
    from alpine_tpu_torch.ops.knn import exact_knn
    from alpine_tpu_torch.optimize import batched, scoring

    seen = {"pad_folds": 0, "pad_nonzero": 0, "k3": None, "knn": None}
    fused_transform = kernels.fused_transform

    def on_fit(orig, args, kw, out):
        fd, f = args[0], args[1]
        n_real = len(fd.folds[f][0])
        if n_real < fd.n_tr:
            seen["pad_folds"] += 1
            seen["pad_nonzero"] += int(out[1][:, n_real:].count_nonzero())

    def on_transform(orig, args, kw, out):
        if seen["k3"] is None and kw.get("fused", True):
            plain = orig(*args, **dict(kw, fused=False))
            seen["k3"] = compare(out, plain, 2e-4, 1e-6) + (list(out.shape),)

    def on_knn(orig, args, kw, out):
        if seen["knn"] is None and kw.get("device") is not None:
            seen["knn"] = (np.array(args[0]), args[1], out)

    from alpine_tpu_torch.utils.adata import suggest_data_dtype

    # the constructor's one scan of X for data_dtype="auto", alone
    t0 = time.perf_counter()
    suggest_data_dtype(adata.X)
    dtype_scan_s = time.perf_counter() - t0
    timers = StageTimers(torch, batched, mu, scoring, hooks={
        "fits": on_fit, "transforms": on_transform, "knn": on_knn})
    trial_rows = []
    try:
        t0 = time.perf_counter()
        co = ComponentOptimizer(adata, OPT_KEYS, max_iter=OPT_MAX_ITER, random_state=0)
        init_s = time.perf_counter() - t0
        check(co.fold_batching and co.shape_bucket == "auto" and co.data_dtype_ == "int8",
              "slice_optimize: the defaults (fold batching, auto buckets, int8)")
        objective, fold_data = co.objective, co._fold_data
        build = {}

        def timed_fold_data(folds):
            fresh = getattr(co, "_fold_cache", None) is None
            t = time.perf_counter()
            fd = fold_data(folds)
            torch.cuda.synchronize()
            if fresh:
                build["seconds"] = time.perf_counter() - t
            return fd

        def timed_objective(point):
            timers.take()
            t = time.perf_counter()
            out = objective(point)
            row = {"seconds": time.perf_counter() - t, **timers.take(),
                   "status": out["status"],
                   "score": out["loss"] if np.isfinite(out["loss"]) else None}
            if "params" in out:
                p = out["params"]
                true = tuple(p["n_covariate_components"]) + (p["n_components"],)
                row.update(true_blocks=list(true),
                           blocks=list(mu.auto_bucket_blocks(true)), params=p)
            trial_rows.append(row)
            return out

        co.objective, co._fold_data = timed_objective, timed_fold_data
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k3_paths = count_k3_paths(kernels)
        kernels.reset_launches()
        t0 = time.perf_counter()
        best = co.search_hyperparams(n_total_components_range=(10, 100),
                                     n_splits=OPT_SPLITS, max_evals=OPT_EVALS)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
        kernels.fused_transform = fused_transform
        search_launches = dict(kernels.launches)
        search_trials = trial_summary(co.trials)
        search_peak = torch.cuda.max_memory_allocated()
        co.objective, co._fold_data = objective, fold_data
        valid = [r for r in trial_rows if r["status"] == "ok"]
        fd = co._fold_cache[1]

        # one trial again through the sequential route (an ALPINE fit a
        # fold: host preparation, upload, fit, uncached transform)
        first = valid[0]
        args = {k: v for k, v in first["params"].items() if k not in ("max_iter", "score")}
        co.fold_batching = False
        kernels.reset_launches()
        timers.take()
        t0 = time.perf_counter()
        seq_score = co.calc_score(args)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
        seq_split = timers.take()
        seq_launches = dict(kernels.launches)
        co.fold_batching = True
    finally:
        kernels.fused_transform = fused_transform
        timers.close()

    # the fold shape of the largest trial K, for the kernel rows; K3 a row
    # for each path the search launched, at the largest K that took it
    largest = max(valid, key=lambda r: sum(r["blocks"]))
    cases["iteration"]("fused_iteration optimizer fold", fd.g, fd.n_tr,
                       tuple(largest["blocks"]))
    for path, (n_launched, K) in k3_paths.items():
        if n_launched:
            cases["transform"](f"fused_transform optimizer {path} fold", K, fd.n_va)

    # the card's kNN of one validation fold against the float64 host search
    emb, k, (cd, ci) = seen["knn"]
    t0 = time.perf_counter()
    hd, hi = exact_knn(emb, k)
    host_knn_s = time.perf_counter() - t0
    rows_differ = int((np.sort(ci, axis=1) != np.sort(hi, axis=1)).any(axis=1).sum())
    knn_err, knn_worst = compare(torch.from_numpy(np.sort(cd, axis=1)),
                                 torch.from_numpy(np.sort(hd, axis=1)), 1e-4, 1e-6)
    backend = leiden_backend()

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    model = co.fit_the_best_param()
    torch.cuda.synchronize()
    best_s = time.perf_counter() - t0
    best_launches = dict(kernels.launches)
    best_peak = torch.cuda.max_memory_allocated()
    Lb = model.loss_history_

    emit({"phase": "slice_optimize", "cells": N, "genes": G, "covariates": OPT_KEYS,
          "max_iter": OPT_MAX_ITER, "n_splits": OPT_SPLITS, "max_evals": OPT_EVALS,
          "data_dtype": co.data_dtype_, "constructor_seconds": init_s,
          "suggest_data_dtype_seconds": dtype_scan_s,
          "fold_data_seconds": build.get("seconds"), "search_seconds": search_s,
          "fold_shape": {"genes": fd.g, "n_train": fd.n_tr, "n_validation": fd.n_va},
          "trials": trial_rows, "launches_search": search_launches,
          "k3_launches_by_path": {p: {"launches": n, "largest_K": K}
                                  for p, (n, K) in k3_paths.items()},
          "launches_expected": {"fused_iteration": len(valid) * OPT_SPLITS * OPT_MAX_ITER,
                                "fused_transform": len(valid) * OPT_SPLITS},
          "pad_folds_checked": seen["pad_folds"], "pad_nonzero": seen["pad_nonzero"],
          "k3_vs_plain": {"max_abs_err": seen["k3"][0],
                          "worst_err_over_tolerance": seen["k3"][1],
                          "shape": seen["k3"][2],
                          "tolerance": "rtol 2e-4, atol 1e-6*max|plain|"},
          "knn_vs_host": {"cells": len(emb), "dims": emb.shape[1], "k": k,
                          "rows_differ": rows_differ, "max_abs_err": knn_err,
                          "worst_err_over_tolerance": knn_worst,
                          "host_float64_seconds": host_knn_s,
                          "tolerance": "rtol 1e-4, atol 1e-6*max|host|"},
          "leiden_backend": backend, "leiden_build_error": build_error(),
          "peak_memory_bytes_search": search_peak,
          "sequential": {"score": seq_score, "seconds": seq_s, **seq_split,
                         "launches": seq_launches, "batched_score": first["score"],
                         "batched_seconds": first["seconds"]},
          "best_param": best, "fit_the_best_param_seconds": best_s,
          "launches_fit_the_best_param": best_launches,
          "peak_memory_bytes_fit_the_best_param": best_peak,
          "best_loss_last": Lb[-1].tolist()})
    check(len(valid) >= 1 and all(np.isfinite(r["score"]) for r in valid),
          "slice_optimize: every valid trial's score must be finite")
    check(search_launches["fused_iteration"] == len(valid) * OPT_SPLITS * OPT_MAX_ITER,
          f"slice_optimize: {search_launches['fused_iteration']} K1 launches")
    check(search_launches["fused_transform"] == len(valid) * OPT_SPLITS
          == sum(n for n, _ in k3_paths.values()),
          f"slice_optimize: {search_launches['fused_transform']} K3 launches "
          f"({k3_paths} by path)")
    check(backend == "native", f"slice_optimize: Leiden backend {backend} ({build_error()})")
    check(seen["pad_folds"] >= 1 and seen["pad_nonzero"] == 0,
          "slice_optimize: pad columns of H must stay exactly zero through K1")
    check(seen["k3"][1] <= 1.0, "slice_optimize: a fold's K3 output disagrees with "
          "the plain projection")
    check(knn_worst <= 1.0 and rows_differ <= 0.001 * len(emb),
          f"slice_optimize: card kNN vs host: {rows_differ} rows differ, "
          f"worst {knn_worst}")
    check(all(int(i) == r for r, i in enumerate(ci[:, 0])), "slice_optimize: self first")
    check(np.isfinite(seq_score) and seq_launches["fused_iteration"] == OPT_SPLITS * OPT_MAX_ITER,
          "slice_optimize: the sequential route's score and K1 launches")
    check(best_launches["fused_iteration"] == OPT_MAX_ITER and np.isfinite(Lb).all(),
          "slice_optimize: fit_the_best_param runs K1 once an iteration")
    check(co._fold_cache is None, "slice_optimize: the fold tensors go before the refit")
    model.free_device_cache()
    del co, model, fd
    torch.cuda.empty_cache()
    return (search_launches, {p: n for p, (n, _) in k3_paths.items() if n},
            {"trials": search_trials, "best": best, "refit_loss": Lb.tolist()})


def run_optimize_paths_phase(torch, kernels, adata, cases):
    """slice_optimize_paths: one calc_score each through the batched route
    at the bench shape, max_iter = 10, frozen parameters: weighted_fast
    folds (K4), ALS folds (P1/P2) and tiled folds of 8,192-cell batches
    (P1/P2 on slabs)."""
    from alpine_tpu_torch import ComponentOptimizer
    from alpine_tpu_torch.ops import mu
    from alpine_tpu_torch.optimize import batched, scoring

    launches = {}
    for name, kw in (("weighted_fast", dict(sampling_method="weighted_fast")),
                     ("als", dict(use_als=True)),
                     ("tiled", dict(sampling_method="tiled", batch_size=MB_BATCH))):
        co = ComponentOptimizer(adata, OPT_KEYS, max_iter=PATHS_MAX_ITER, random_state=0,
                                **kw)
        co.n_splits, co.iter_records = OPT_SPLITS, []
        timers = StageTimers(torch, batched, mu, scoring)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.perf_counter()
            score = co.calc_score(PATHS_PARAMS)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches[name] = dict(kernels.launches)
            split = timers.take()
        finally:
            timers.close()
        fd = co._fold_cache[1]
        emit({"phase": "slice_optimize_paths", "path": name, "settings": kw,
              "max_iter": PATHS_MAX_ITER, "params": PATHS_PARAMS,
              "blocks": list(mu.auto_bucket_blocks((5, 5, 30))),
              "fold_shape": {"n_train": fd.n_tr, "n_validation": fd.n_va, "tile": fd.tile},
              "score": score, "seconds": seconds, **split,
              "launches": launches[name],
              "peak_memory_bytes": torch.cuda.max_memory_allocated()})
        check(np.isfinite(score), f"slice_optimize_paths {name}: score must be finite")
        L = launches[name]
        if name == "weighted_fast":
            check(L["fused_iteration_counts"] == OPT_SPLITS * PATHS_MAX_ITER
                  and L["fused_iteration"] == 0,
                  f"slice_optimize_paths weighted_fast: {L['fused_iteration_counts']} K4")
            cases["iteration"]("fused_iteration_counts optimizer fold", fd.g, fd.n_tr,
                               mu.auto_bucket_blocks((5, 5, 30)), counts=True)
        else:
            check(L["hxt"] > 0 and L["wtx"] > 0 and L["fused_iteration"] == 0,
                  f"slice_optimize_paths {name}: P1 {L['hxt']}, P2 {L['wtx']}")
        if name == "als":
            cases["x_pass"](fd.g, fd.n_tr, sum(mu.auto_bucket_blocks((5, 5, 30))))
        check(L["fused_transform"] == OPT_SPLITS,
              f"slice_optimize_paths {name}: one K3 launch a fold")
        co.free_device_cache()
        del co, fd
        torch.cuda.empty_cache()
    return launches


# slice_optimize_sharded: world 1 runs the first trials of slice_optimize's
# search, world 2 two rounds of two; the max_iter=None search is cut to the
# first OPT_DETECT_CELLS cells
OPT_W1_EVALS, OPT_SHARDED_EVALS = 2, 4
OPT_DETECT_CELLS, OPT_DETECT_EVALS = 20_000, 3
OPT_RANK_TIMEOUT = 300.0


def optimize_sharded_rank(here, workdir, world, rank, port, n_detect):
    """One gloo rank of slice_optimize_sharded (a spawned process): the full
    bench data memory-mapped from the parent's file, a search of two rounds
    over the cell mesh (this rank fits and scores its own trials on the
    card), the replicated refit, the loss exchange alone, and a
    max_iter=None search on the first ``n_detect`` cells; its numbers and
    results saved for the parent."""
    sys.path.insert(0, here)
    import torch

    from alpine_tpu_torch import AnnData, ComponentOptimizer
    from alpine_tpu_torch.ops import kernels
    from alpine_tpu_torch.parallel import distributed as dist

    dist.initialize(f"localhost:{port}", num_processes=world, process_id=rank,
                    local_device_ids=0, backend="gloo", timeout=RANK_PG_TIMEOUT)
    try:
        rank_t0 = time.perf_counter()
        counts = np.load(os.path.join(workdir, "counts.npy"), mmap_mode="r")
        labels = np.load(os.path.join(workdir, "obs.npz"), allow_pickle=True)
        adata = AnnData(np.asarray(counts, dtype=np.float32),
                        obs={k: labels[k] for k in OPT_KEYS})
        load_s = time.perf_counter() - rank_t0
        mesh = dist.global_cell_mesh()

        def timed(co):
            """Seconds of each calc_score this rank runs: its own trials."""
            spent, calc = [], co.calc_score

            def timed_calc(args):
                t = time.perf_counter()
                score = calc(args)
                torch.cuda.synchronize()
                spent.append(time.perf_counter() - t)
                return score

            co.calc_score = timed_calc
            return spent

        # a round's loss exchange: one float a rank (the digests send more)
        exchanges, allgather = [], dist.process_allgather_rows

        def timed_allgather(row):
            t = time.perf_counter()
            out = allgather(row)
            if np.asarray(row).size == 1:
                exchanges.append((time.perf_counter() - t) * 1e3)
            return out

        t0 = time.perf_counter()
        co = ComponentOptimizer(adata, OPT_KEYS, max_iter=OPT_MAX_ITER, random_state=0,
                                device=mesh)
        init_s = time.perf_counter() - t0
        trial_s = timed(co)
        kernels.reset_launches()
        fused_transform = kernels.fused_transform
        k3_paths = count_k3_paths(kernels)
        dist.process_allgather_rows = timed_allgather
        try:
            t0 = time.perf_counter()
            best = co.search_hyperparams(n_total_components_range=(10, 100),
                                         n_splits=OPT_SPLITS, max_evals=OPT_SHARDED_EVALS)
            torch.cuda.synchronize()
            search_s = time.perf_counter() - t0
        finally:
            dist.process_allgather_rows = allgather
            kernels.fused_transform = fused_transform
        launches = dict(kernels.launches)
        kernels.reset_launches()
        t0 = time.perf_counter()
        model = co.fit_the_best_param()
        torch.cuda.synchronize()
        refit_s = time.perf_counter() - t0
        refit_launches = dict(kernels.launches)
        refit_loss = model.loss_history_.tolist()
        del model
        torch.cuda.empty_cache()
        # the exchange alone, both ranks in step: 20 gathers of one float
        allgather(np.zeros(1))
        t0 = time.perf_counter()
        for _ in range(20):
            allgather(np.zeros(1))
        alone_ms = (time.perf_counter() - t0) * 1e3 / 20

        # max_iter detection: a replicated round (each rank runs the
        # sequential route's elbow fits), then one parallel round
        cut = AnnData(np.asarray(counts[:n_detect], dtype=np.float32),
                      obs={k: labels[k][:n_detect] for k in OPT_KEYS})
        det = ComponentOptimizer(cut, OPT_KEYS, max_iter=None, random_state=0, device=mesh)
        det_s = timed(det)
        t0 = time.perf_counter()
        det.search_hyperparams(n_total_components_range=(10, 100), n_splits=OPT_SPLITS,
                               max_evals=OPT_DETECT_EVALS)
        torch.cuda.synchronize()
        det_search_s = time.perf_counter() - t0
        row = {"phase": "slice_optimize_sharded_rank", "world": world, "rank": rank,
               "backend": torch.distributed.get_backend(),
               "topology": [co._mp_workers, co._mp_rank, str(co._exec_device)],
               "load_seconds": load_s, "constructor_seconds": init_s,
               "search_seconds": search_s, "local_evaluations": len(trial_s),
               "seconds_per_trial": trial_s,
               "exchange_ms_per_round": exchanges, "exchange_ms_alone": alone_ms,
               "launches_search": {"fused_iteration": launches["fused_iteration"],
                                   "fused_transform": launches["fused_transform"]},
               "k3_launches_by_path": {p: {"launches": n, "largest_K": K}
                                       for p, (n, K) in k3_paths.items()},
               "fit_the_best_param_seconds": refit_s,
               "launches_fit_the_best_param": {
                   "fused_iteration": refit_launches["fused_iteration"]},
               "detect": {"cells": n_detect, "search_seconds": det_search_s,
                          "local_evaluations": len(det_s), "max_iter": det.max_iter},
               "rank_seconds": time.perf_counter() - rank_t0}
        with open(os.path.join(workdir, f"opt_rank{rank}.json"), "w") as f:
            json.dump({"row": row, "trials": trial_summary(co.trials), "best": best,
                       "refit_loss": refit_loss,
                       "detect_trials": trial_summary(det.trials)}, f, default=float)
    finally:
        dist.shutdown()


def run_optimize_sharded_phase(torch, kernels, adata, counts, obs, ref_trials):
    """slice_optimize_sharded: ComponentOptimizer over a cell mesh at the
    bench shape with slice_optimize's settings.  World 1 (NCCL, this
    process) runs the first two trials, which must be slice_optimize's bit
    for bit.  World 2 (two gloo ranks spawned on the one card, each holding
    all cells) runs two rounds of two trials and the replicated refit:
    identical trials, best parameters and refit losses on both ranks, K1
    and K3 launched on each for its own trials, and one trial rank 1 fit
    against this process's calc_score of its point (atol 1e-6); then a
    max_iter=None search cut to OPT_DETECT_CELLS cells.  Ranks share the
    card: no time here is a multi-GPU speed."""
    import multiprocessing
    import tempfile

    from alpine_tpu_torch import ComponentOptimizer
    from alpine_tpu_torch.parallel import distributed as dist

    here = os.path.dirname(os.path.abspath(__file__))
    phase_t0 = time.perf_counter()
    per_trial = OPT_SPLITS * OPT_MAX_ITER

    # world 1: a mesh of one runs the sequential search on this card
    t0 = time.perf_counter()
    dist.initialize(f"localhost:{_free_port()}", num_processes=1, process_id=0,
                    backend="nccl", timeout=RANK_PG_TIMEOUT)
    try:
        backend = torch.distributed.get_backend()
        co = ComponentOptimizer(adata, OPT_KEYS, max_iter=OPT_MAX_ITER, random_state=0,
                                device=dist.global_cell_mesh())
        topology = [co._mp_workers, co._mp_rank, str(co._exec_device)]
        kernels.reset_launches()
        co.search_hyperparams(n_total_components_range=(10, 100), n_splits=OPT_SPLITS,
                              max_evals=OPT_W1_EVALS)
        torch.cuda.synchronize()
        w1_launches = dict(kernels.launches)
    finally:
        dist.shutdown()
    w1_trials = trial_summary(co.trials)
    w1_valid = sum(t["status"] == "ok" for t in w1_trials)
    w1_bits = [a["vals"] == b["vals"] and a["loss"] == b["loss"] and a["status"] == b["status"]
               for a, b in zip(w1_trials, ref_trials)]
    w1 = {"world": 1, "backend": backend, "topology": topology,
          "trials": [[t["tid"], t["loss"], t["status"]] for t in w1_trials],
          "bits_equal_slice_optimize": w1_bits,
          "launches_search": {k: w1_launches[k] for k in ("fused_iteration",
                                                         "fused_transform")},
          "seconds": time.perf_counter() - t0}
    check(topology == [1, 0, "cuda:0"], f"slice_optimize_sharded world 1: {topology}")
    check(len(w1_bits) == OPT_W1_EVALS and all(w1_bits),
          f"slice_optimize_sharded world 1: trials must be slice_optimize's: {w1_bits}")
    check(w1_launches["fused_iteration"] == w1_valid * per_trial
          and w1_launches["fused_transform"] == w1_valid * OPT_SPLITS and w1_valid > 0,
          f"slice_optimize_sharded world 1: launches {w1_launches}")

    # world 2: gloo ranks spawned on the one card, each with all cells
    ctx = multiprocessing.get_context("spawn")
    world = 2
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        np.save(os.path.join(workdir, "counts.npy"), counts.astype(np.int8))
        np.savez(os.path.join(workdir, "obs.npz"), **obs)
        port = _free_port()
        procs = [ctx.Process(target=optimize_sharded_rank,
                             args=(here, workdir, world, r, port, OPT_DETECT_CELLS))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + OPT_RANK_TIMEOUT
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(10)
        codes = [p.exitcode for p in procs]
        check(not alive and codes == [0] * world,
              f"slice_optimize_sharded world {world}: ranks ended with {codes}"
              + (" (stopped at the time limit)" if alive else ""))
        outs = []
        for r in range(world):
            with open(os.path.join(workdir, f"opt_rank{r}.json")) as f:
                outs.append(json.load(f))
    w2_s = time.perf_counter() - t0
    rows = [o["row"] for o in outs]
    for row in rows:  # printed here: two ranks printing at once mix their lines
        emit(row)
    trials = outs[0]["trials"]
    valid = [t for t in trials if t["status"] == "ok"]
    same = {
        "trials": all(o["trials"] == trials for o in outs),
        "best_param": all(o["best"] == outs[0]["best"] for o in outs),
        "refit_loss": all(o["refit_loss"] == outs[0]["refit_loss"] for o in outs),
        "detect_trials": all(o["detect_trials"] == outs[0]["detect_trials"] for o in outs),
        "detect_max_iter": len({r["detect"]["max_iter"] for r in rows}) == 1}
    # a trial rank 1 fit (worker j takes the j-th point of a round) against
    # this process's calc_score of the same point on the card
    mine = [t for t in trials if t["tid"] % world == 1 and t["status"] == "ok"]
    probe = (mine or valid)[0]
    args = {k: v for k, v in probe["params"].items() if k not in ("max_iter", "score")}
    t1 = time.perf_counter()
    parent_score = co.calc_score(args)
    parent_s = time.perf_counter() - t1
    co.free_device_cache()
    del co
    torch.cuda.empty_cache()
    detect = outs[0]["detect_trials"]
    det_ok = sum(t["status"] == "ok" for t in detect)
    det_evals = sum(r["detect"]["local_evaluations"] for r in rows)
    emit({"phase": "slice_optimize_sharded", "cells": N, "genes": G,
          "covariates": OPT_KEYS, "max_iter": OPT_MAX_ITER, "n_splits": OPT_SPLITS,
          "worlds": [w1, {
              "world": world, "backend": rows[0]["backend"], "max_evals": OPT_SHARDED_EVALS,
              "trials": [[t["tid"], t["loss"], t["status"]] for t in trials],
              "losses_equal_slice_optimize": [
                  t["vals"] == r["vals"] and t["loss"] == r["loss"]
                  for t, r in zip(trials, ref_trials)],
              "local_evaluations": [r["local_evaluations"] for r in rows],
              "seconds_per_trial": [r["seconds_per_trial"] for r in rows],
              "exchange_ms_per_round": [r["exchange_ms_per_round"] for r in rows],
              "exchange_ms_alone": [r["exchange_ms_alone"] for r in rows],
              "launches_search": [r["launches_search"] for r in rows],
              "same_on_every_rank": same, "best_param": outs[0]["best"],
              "refit_loss_last": outs[0]["refit_loss"][-1],
              "rank_check": {"tid": probe["tid"], "rank_loss": probe["loss"],
                             "parent_calc_score": parent_score,
                             "parent_seconds": parent_s, "tolerance": "atol 1e-6"},
              "detect": {"cells": OPT_DETECT_CELLS, "max_evals": OPT_DETECT_EVALS,
                         "trials": [[t["tid"], t["loss"], t["status"]] for t in detect],
                         "max_iter": rows[0]["detect"]["max_iter"],
                         "local_evaluations": [r["detect"]["local_evaluations"]
                                               for r in rows]},
              "seconds": w2_s}],
          "reduced": {"detect_cells": f"{OPT_DETECT_CELLS} of {N}"},
          "seconds": time.perf_counter() - phase_t0})
    check(all(same.values()), f"slice_optimize_sharded world 2: ranks differ: {same}")
    # TPE's first draws come from the prior: the same points as
    # slice_optimize's search, so its kernel rows hold for these folds
    check(len(ref_trials) >= len(trials)
          and all(t["vals"] == r["vals"] for t, r in zip(trials, ref_trials)),
          "slice_optimize_sharded world 2: the points must be slice_optimize's")
    check(len(trials) == OPT_SHARDED_EVALS and valid
          and all(np.isfinite(t["loss"]) for t in valid),
          "slice_optimize_sharded world 2: every valid trial's score must be finite")
    check(sum(r["local_evaluations"] for r in rows) == len(valid),
          "slice_optimize_sharded world 2: each valid trial fit on one rank only")
    for r, row in enumerate(rows):
        n_local = row["local_evaluations"]
        L = row["launches_search"]
        check(row["topology"] == [world, r, "cuda:0"],
              f"slice_optimize_sharded rank {r}: topology {row['topology']}")
        check(n_local > 0 and L["fused_iteration"] == n_local * per_trial
              and L["fused_transform"] == n_local * OPT_SPLITS
              == sum(v["launches"] for v in row["k3_launches_by_path"].values()),
              f"slice_optimize_sharded rank {r}: launches {L} for {n_local} trials")
        check(row["launches_fit_the_best_param"]["fused_iteration"] == OPT_MAX_ITER,
              f"slice_optimize_sharded rank {r}: the refit runs K1 once an iteration")
    check(abs(parent_score - probe["loss"]) <= 1e-6,
          f"slice_optimize_sharded: trial {probe['tid']} {probe['loss']} against "
          f"calc_score {parent_score}")
    check(rows[0]["detect"]["max_iter"] is not None and det_ok > 0
          and det_ok < det_evals < world * det_ok + world,
          f"slice_optimize_sharded detect: {det_evals} local evaluations of {det_ok}")
    k3 = {}
    for row in rows:
        for p, v in row["k3_launches_by_path"].items():
            k3[p] = k3.get(p, 0) + v["launches"]
    return ({"fused_iteration": sum(r["launches_search"]["fused_iteration"] for r in rows)},
            {p: n for p, n in k3.items() if n}, detect)


# slice_optimize_grid: a 2 x 2 ("genes", "cells") grid of gloo ranks on the
# one card, each holding all cells; its max_iter=None search is cut to the
# first OPT_DETECT_CELLS cells, as slice_optimize_sharded's
OPT_GRID = (2, 2)
OPT_GRID_RANK_TIMEOUT = 420.0
GRID_LAUNCH_KEYS = ("fused_iteration", "fused_transform", "hxt", "wtx")


def instrument_search(torch, kernels, dist, co):
    """Per trial of ``co`` on this rank: the seconds of calc_score, of its
    fold fits (the batched route's, with their projections; on a grid the
    sequential grid fits with their projections and embedding gathers) and
    of its scoring (kNN, graph, Leiden), the host collectives (embedding
    gathers, score exchange; their bytes and ms) and the all-reduces of
    its grid fits, and its launches of K1, K3, P1 and P2."""
    rows, stage = [], {}

    def wrap(name, key):
        orig = getattr(co, name)

        def timed(*args, **kw):
            t = time.perf_counter()
            out = orig(*args, **kw)
            torch.cuda.synchronize()
            stage[key] = stage.get(key, 0.0) + time.perf_counter() - t
            return out

        setattr(co, name, timed)

    wrap("_batched_fold_embeddings", "fits")
    wrap("_fit_one_fold", "fits")
    wrap("_leakage_score", "scoring")
    calc = co.calc_score

    def timed_calc(args):
        stage.clear()
        dist.reset_collectives()
        before = {k: kernels.launches[k] for k in GRID_LAUNCH_KEYS}
        t = time.perf_counter()
        score = calc(args)
        torch.cuda.synchronize()
        rows.append({"seconds": time.perf_counter() - t,
                     "fits_seconds": stage.get("fits", 0.0),
                     "scoring_seconds": stage.get("scoring", 0.0),
                     "collectives": dist.collective_summary(),
                     "launches": {k: kernels.launches[k] - before[k]
                                  for k in GRID_LAUNCH_KEYS}})
        return score

    co.calc_score = timed_calc
    return rows


def optimize_grid_rank(here, workdir, rank, port, n_detect):
    """One gloo rank of slice_optimize_grid (a spawned process) at its
    place on the 2 x 2 grid: the full bench data memory-mapped from the
    parent's file; (a) the batched search (its folds fit on the card of
    their owners), (b) a max_iter=None search on the first ``n_detect``
    cells (the first trial's folds are grid fits), (c) the refit of (a)'s
    best parameters, a grid fit of all cells; its numbers and results
    saved for the parent."""
    sys.path.insert(0, here)
    import torch

    from alpine_tpu_torch import AnnData, ComponentOptimizer
    from alpine_tpu_torch.ops import kernels
    from alpine_tpu_torch.parallel import distributed as dist

    world = OPT_GRID[0] * OPT_GRID[1]
    dist.initialize(f"localhost:{port}", num_processes=world, process_id=rank,
                    local_device_ids=0, backend="gloo", timeout=RANK_PG_TIMEOUT)
    try:
        rank_t0 = time.perf_counter()
        counts = np.load(os.path.join(workdir, "counts.npy"), mmap_mode="r")
        labels = np.load(os.path.join(workdir, "obs.npz"), allow_pickle=True)
        adata = AnnData(np.asarray(counts, dtype=np.float32),
                        obs={k: labels[k] for k in OPT_KEYS})
        load_s = time.perf_counter() - rank_t0
        mesh = dist.global_gene_cell_mesh(*OPT_GRID)

        # (a) the batched search: slice_optimize's settings
        t0 = time.perf_counter()
        co = ComponentOptimizer(adata, OPT_KEYS, max_iter=OPT_MAX_ITER, random_state=0,
                                device=mesh)
        init_s = time.perf_counter() - t0
        topology = [co._mp_workers, co._mp_rank, str(co._local_device),
                    type(co._exec_device).__name__, co._exec_device.device_type]
        trial_rows = instrument_search(torch, kernels, dist, co)
        kernels.reset_launches()
        fused_transform = kernels.fused_transform
        k3_paths = count_k3_paths(kernels)
        try:
            t0 = time.perf_counter()
            best = co.search_hyperparams(n_total_components_range=(10, 100),
                                         n_splits=OPT_SPLITS, max_evals=OPT_EVALS)
            torch.cuda.synchronize()
            search_s = time.perf_counter() - t0
        finally:
            kernels.fused_transform = fused_transform
        launches = {k: kernels.launches[k] for k in GRID_LAUNCH_KEYS}

        # (b) max_iter=None: the first trial's folds are grid fits
        cut = AnnData(np.asarray(counts[:n_detect], dtype=np.float32),
                      obs={k: labels[k][:n_detect] for k in OPT_KEYS})
        det = ComponentOptimizer(cut, OPT_KEYS, max_iter=None, random_state=0, device=mesh)
        det_rows = instrument_search(torch, kernels, dist, det)
        kernels.reset_launches()
        t0 = time.perf_counter()
        det.search_hyperparams(n_total_components_range=(10, 100), n_splits=OPT_SPLITS,
                               max_evals=OPT_DETECT_EVALS)
        torch.cuda.synchronize()
        det_s = time.perf_counter() - t0
        det_launches = {k: kernels.launches[k] for k in GRID_LAUNCH_KEYS}
        # this rank's cells of each training fold of (b)'s grid fits
        det_shares = [hi - lo for lo, hi in (dist.mesh_cell_range(mesh, len(tr))
                                             for tr, _ in det._stratified_folds())]
        det_out = {"trials": trial_summary(det.trials), "max_iter": det.max_iter}
        del det, cut

        # the score exchange alone, every rank in step: 20 exchanges of a
        # trial's row (a float a fold and the failure flag)
        dist.process_allgather_rows(np.zeros(OPT_SPLITS + 1))
        t0 = time.perf_counter()
        for _ in range(20):
            dist.process_allgather_rows(np.zeros(OPT_SPLITS + 1))
        exchange_alone_ms = (time.perf_counter() - t0) * 1e3 / 20

        # (c) the refit: a grid fit of all cells
        co.free_device_cache()
        kernels.reset_launches()
        dist.reset_collectives()
        t0 = time.perf_counter()
        model = co.fit_the_best_param()
        torch.cuda.synchronize()
        refit_s = time.perf_counter() - t0
        W = np.concatenate(model.matrices["Ws"], axis=1)
        refit = {"seconds": refit_s,
                 "launches": {k: kernels.launches[k] for k in GRID_LAUNCH_KEYS},
                 "collectives": dist.collective_summary(),
                 "cells": int(model.matrices["Hs"][-1].shape[1]),
                 "K": int(W.shape[1]), "W_digest": _digest(W),
                 "loss": model.loss_history_.tolist()}
        del model
        row = {"phase": "slice_optimize_grid_rank", "grid": list(OPT_GRID), "rank": rank,
               "backend": torch.distributed.get_backend(), "topology": topology,
               "owned_folds": co._owned_folds(OPT_SPLITS),
               "load_seconds": load_s, "constructor_seconds": init_s,
               "search_seconds": search_s, "trials": trial_rows,
               "score_exchange_ms_alone": exchange_alone_ms,
               "launches_search": launches,
               "k3_launches_by_path": {p: {"launches": n, "largest_K": K}
                                       for p, (n, K) in k3_paths.items()},
               "detect": {"cells": n_detect, "search_seconds": det_s, "trials": det_rows,
                          "launches": det_launches, "train_fold_shares": det_shares},
               "refit": {k: v for k, v in refit.items() if k not in ("W_digest", "loss")},
               "rank_seconds": time.perf_counter() - rank_t0}
        with open(os.path.join(workdir, f"grid_opt_rank{rank}.json"), "w") as f:
            json.dump({"row": row, "trials": trial_summary(co.trials), "best": best,
                       "detect": det_out, "refit_W_digest": refit["W_digest"],
                       "refit_loss": refit["loss"]}, f, default=float)
    finally:
        dist.shutdown()


def run_optimize_grid_phase(torch, kernels, counts, obs, ref, detect_ref, cases):
    """slice_optimize_grid: ComponentOptimizer on a 2 x 2 ("genes", "cells")
    grid, four gloo ranks spawned on the one card, each holding all cells.
    (a) slice_optimize's search (OPT_EVALS trials of OPT_SPLITS folds at
    OPT_MAX_ITER): each fold fit whole on the card of its owner (fold f on
    rank f mod 4), the scores exchanged; its trials must be
    slice_optimize's bit for bit (``ref``).  (b) A max_iter=None search of
    OPT_DETECT_EVALS trials on the first OPT_DETECT_CELLS cells: the first
    trial's folds are grid fits (P1/P2 on each rank's block), printed
    beside the single-device first trial on those cells (``detect_ref``,
    slice_optimize_sharded's replicated round; a difference, not a
    check).  (c) The refit of (a)'s best parameters, a grid fit of all
    cells, against slice_optimize's single-device refit (loss rtol 5e-4).
    Checks: the same trials, best parameters, max_iter and refit W and
    losses on every rank, K1/K3 (and P1 once a fold fit, for its first
    X Hᵀ) on the folds' owners only, P1/P2 on every rank in (b)'s grid
    folds and in (c), no rank on the CPU.  Returns the
    launches of its kernel rows.  Ranks share the card: no time here is a
    multi-GPU speed."""
    import multiprocessing
    import tempfile

    from alpine_tpu_torch.ops import mu

    here = os.path.dirname(os.path.abspath(__file__))
    phase_t0 = time.perf_counter()
    world = OPT_GRID[0] * OPT_GRID[1]
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as workdir:
        np.save(os.path.join(workdir, "counts.npy"), counts.astype(np.int8))
        np.savez(os.path.join(workdir, "obs.npz"), **obs)
        port = _free_port()
        procs = [ctx.Process(target=optimize_grid_rank,
                             args=(here, workdir, r, port, OPT_DETECT_CELLS))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + OPT_GRID_RANK_TIMEOUT
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(10)
        codes = [p.exitcode for p in procs]
        check(not alive and codes == [0] * world,
              f"slice_optimize_grid: ranks ended with {codes}"
              + (" (stopped at the time limit)" if alive else ""))
        outs = []
        for r in range(world):
            with open(os.path.join(workdir, f"grid_opt_rank{r}.json")) as f:
                outs.append(json.load(f))
    rows = [o["row"] for o in outs]
    for row in rows:  # printed here: ranks printing at once mix their lines
        emit(row)
    trials = outs[0]["trials"]
    valid = [t for t in trials if t["status"] == "ok"]
    detect = outs[0]["detect"]
    det_valid = [t for t in detect["trials"] if t["status"] == "ok"]
    same = {"trials": all(o["trials"] == trials for o in outs),
            "best_param": all(o["best"] == outs[0]["best"] for o in outs),
            "detect_trials": all(o["detect"] == detect for o in outs),
            "refit_W": all(o["refit_W_digest"] == outs[0]["refit_W_digest"] for o in outs),
            "refit_loss": all(o["refit_loss"] == outs[0]["refit_loss"] for o in outs)}
    bits = [t["vals"] == r["vals"] and t["loss"] == r["loss"] and t["status"] == r["status"]
            for t, r in zip(trials, ref["trials"])]
    refit_loss = np.asarray(outs[0]["refit_loss"])
    # the total loss's gap (the other columns printed)
    refit_gaps = np.abs(refit_loss[-1] / np.asarray(ref["refit_loss"][-1]) - 1)
    refit_gap = float(refit_gaps[0])
    first_single = next(t for t in detect_ref if t["status"] == "ok")
    first_grid = det_valid[0] if det_valid else None
    emit({"phase": "slice_optimize_grid", "grid": list(OPT_GRID), "cells": N, "genes": G,
          "covariates": OPT_KEYS, "max_iter": OPT_MAX_ITER, "n_splits": OPT_SPLITS,
          "max_evals": OPT_EVALS, "backend": rows[0]["backend"],
          "trials": [[t["tid"], t["loss"], t["status"]] for t in trials],
          "bits_equal_slice_optimize": bits, "same_on_every_rank": same,
          "best_param": outs[0]["best"],
          "owned_folds": [r["owned_folds"] for r in rows],
          "seconds_per_trial": [[t["seconds"] for t in r["trials"]] for r in rows],
          "launches_search": [r["launches_search"] for r in rows],
          "detect": {"cells": OPT_DETECT_CELLS, "max_evals": OPT_DETECT_EVALS,
                     "trials": [[t["tid"], t["loss"], t["status"]] for t in detect["trials"]],
                     "max_iter": detect["max_iter"],
                     "first_trial_loss_grid": first_grid and first_grid["loss"],
                     "first_trial_loss_single_device": first_single["loss"],
                     "first_trial_points_equal": bool(first_grid and
                                                      first_grid["vals"] == first_single["vals"]),
                     "first_trial_loss_difference": first_grid and
                     first_grid["loss"] - first_single["loss"],
                     "launches": [r["detect"]["launches"] for r in rows]},
          "refit": {"loss_last": refit_loss[-1].tolist(),
                    "slice_optimize_loss_last": ref["refit_loss"][-1],
                    "rel_gap_last": refit_gaps.tolist(),
                    "tolerance": "total loss rtol 5e-4",
                    "launches": [r["refit"]["launches"] for r in rows],
                    "seconds": [r["refit"]["seconds"] for r in rows]},
          "reduced": {"detect_cells": f"{OPT_DETECT_CELLS} of {N}"},
          "seconds": time.perf_counter() - phase_t0})
    check(all(same.values()), f"slice_optimize_grid: ranks differ: {same}")
    check(len(bits) == OPT_EVALS and all(bits),
          f"slice_optimize_grid: the trials must be slice_optimize's bit for bit: {bits}")
    check(det_valid and all(np.isfinite(t["loss"]) for t in det_valid)
          and detect["max_iter"] is not None,
          f"slice_optimize_grid detect: trials {detect}")
    check(refit_gap <= 5e-4, f"slice_optimize_grid: refit loss gap {refit_gap}")
    n_valid = len(valid)
    for r, row in enumerate(rows):
        mine = len(row["owned_folds"])
        L, D, R = row["launches_search"], row["detect"]["launches"], row["refit"]["launches"]
        check(row["topology"] == [world, r, "cuda:0", "DeviceMesh", "cuda"],
              f"slice_optimize_grid rank {r}: topology {row['topology']}")
        check(row["owned_folds"] == [f for f in range(OPT_SPLITS) if f % world == r],
              f"slice_optimize_grid rank {r}: folds {row['owned_folds']}")
        check(L["fused_iteration"] == n_valid * mine * OPT_MAX_ITER
              and L["fused_transform"] == n_valid * mine
              == sum(v["launches"] for v in row["k3_launches_by_path"].values())
              and L["hxt"] == n_valid * mine and L["wtx"] == 0,
              f"slice_optimize_grid rank {r}: search launches {L} for {mine} folds a trial")
        first = row["detect"]["trials"][0]["launches"]
        check(first["fused_iteration"] == 0 and first["hxt"] > 0 and first["wtx"] > 0
              and first["fused_transform"] == OPT_SPLITS,
              f"slice_optimize_grid rank {r}: the grid folds' launches {first}")
        check(R["fused_iteration"] == 0 and R["hxt"] == R["wtx"] == OPT_MAX_ITER,
              f"slice_optimize_grid rank {r}: refit launches {R}")
    # the kernel rows: P1/P2 at a rank's block of (b)'s first training fold
    # (its column's share, the trial's bucketed K) and of the refit (its
    # column's 50,000 cells, the best parameters' K)
    p_first = first_grid["params"]
    K_first = sum(mu.auto_bucket_blocks(tuple(p_first["n_covariate_components"])
                                        + (p_first["n_components"],)))
    share = rows[0]["detect"]["train_fold_shares"][0]
    cases["grid_x_pass"]("optimizer grid fold", G // OPT_GRID[0], share, K_first)
    cases["grid_x_pass"]("optimizer grid refit", G // OPT_GRID[0], rows[0]["refit"]["cells"],
                         rows[0]["refit"]["K"])
    k3 = {}
    for row in rows:
        for p, v in row["k3_launches_by_path"].items():
            k3[p] = k3.get(p, 0) + v["launches"]
    return {"fused_iteration optimizer grid":
            sum(r["launches_search"]["fused_iteration"] for r in rows),
            **{f"fused_transform optimizer grid {p}": n for p, n in k3.items() if n},
            "hxt optimizer grid fold": sum(r["detect"]["trials"][0]["launches"]["hxt"]
                                           for r in rows),
            "wtx optimizer grid fold": sum(r["detect"]["trials"][0]["launches"]["wtx"]
                                           for r in rows),
            "hxt optimizer grid refit": sum(r["refit"]["launches"]["hxt"] for r in rows),
            "wtx optimizer grid refit": sum(r["refit"]["launches"]["wtx"] for r in rows)}


def main():
    global _T0
    _T0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from alpine_tpu_torch import ALPINE, AnnData, probe
    from alpine_tpu_torch.ops import _build, kernels, mu
    from alpine_tpu_torch.utils.sampling import (
        balanced_group_tables, joint_label_ids)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: true fp32
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit({"phase": "device", "kind": name, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    card = peaks(name)

    t0 = time.perf_counter()
    build_s = _build.build_all()
    for src, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "properties" in line:
                print(f"ptxas {src}: {line.strip()}", file=sys.stderr)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": build_s})
    sass_check(_build, kernels)

    results = {}
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- kernels against their plain versions ------------------------------
    def group_tables(Ys):
        """The balanced sampler's (start, sizes) over the joint labels of Ys."""
        _, start, sizes = balanced_group_tables(
            joint_label_ids([y.cpu().numpy() for y in Ys]))
        return torch.from_numpy(start).to(dev), torch.from_numpy(sizes).to(dev)

    def sampler_counts(Ys, n):
        """Two epochs of the port's balanced sampler (this draw, the next),
        as fused_iteration's (2, n) counts."""
        tables = group_tables(Ys)
        return torch.stack([mu.grouped_balanced_counts(gen, n, tables)
                            for _ in range(2)])

    def run_iteration_case(tag, g, n, blocks, n_labels, xdtype, loss_kl, timed,
                           counts=None, x_scale=1):
        X, W, H, WtW, Ys, Bs, lam = iteration_problem(
            torch, gen, dev, g, n, blocks, n_labels, xdtype)
        X *= x_scale  # int16: counts above 127
        C = None if counts is None else counts(Ys, n)
        if n_labels:
            kern = lambda: kernels.fused_iteration(
                X, W, H, WtW, Ys, Bs, lam, EPS, C, blocks=blocks,
                loss_kl=loss_kl)
            plain = lambda: kernels.fused_iteration_plain(
                X, W, H, WtW, Ys, Bs, lam, EPS, C, blocks=blocks,
                loss_kl=loss_kl)
        else:
            kern = lambda: kernels.fused_h_update(X, W, H, WtW, EPS)
            plain = lambda: kernels.fused_h_update_plain(X, W, H, WtW, EPS)
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        flat = lambda o: [t for v in o for t in (v if isinstance(v, tuple) else (v,))]
        errs = [compare(a, b, 1e-4, 1e-6) for a, b in zip(flat(got), flat(want))]
        worst = max(e[1] for e in errs)
        # fixed-order sums: a second launch gives the same bits
        repeats = all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
        row = {"phase": "kernel", "case": tag, "max_abs_err_Hn": errs[0][0],
               "worst_err_over_tolerance": worst, "second_launch_bit_equal": repeats,
               "tolerance": "rtol 1e-4, atol 1e-6*max|plain| per output"}
        if C is not None:
            undrawn = C[0] == 0
            row["counts"] = {"undrawn": int(undrawn.sum()),
                             "max": float(C.max()), "sum_row0": float(C[0].sum())}
            row["undrawn_columns_bit_equal"] = bool(
                torch.equal(got[0][:, undrawn], H[:, undrawn]))
        if timed:
            row["ms"] = time_ms(kern, 5)
            row["plain_ms"] = time_ms(plain, 3)
            xb = torch.empty((), dtype=xdtype).element_size()
            bf16 = xdtype in (torch.int8, torch.bfloat16)
            cost = iteration_cost(g, n, blocks, n_labels, xb, bf16,
                                  counts=C is not None)
            row["bytes"], row["bf16_flop"], row["fp32_flop"] = cost
            row["bound_ms"], row["bound_by"] = bound(*cost, card)
        if timed and bf16:
            # yardstick, used nowhere in the port: the two X products alone
            # as bf16 cuBLAS calls over a bf16 copy of X (K1, K4 and K2 alike)
            Xb, Wb, Hb = X.to(torch.bfloat16), W.bfloat16(), H.bfloat16()
            row["x_products_cublas_bf16_ms"] = time_ms(
                lambda: (Wb.T @ Xb, Hb @ Xb.T), 5)
            del Xb
        if timed and not bf16:
            # the same yardstick on the fp32 path: fp32 torch.matmul over a
            # float32 copy of X; and the grid the four launches ran
            Xf = X.float()
            row["x_products_cublas_fp32_ms"] = time_ms(lambda: (W.T @ Xf, H @ Xf.T), 5)
            del Xf
            row["grid"] = kernels.iteration_grid(g, n, sum(blocks), xdtype)._asdict()
        emit(row)
        check(worst <= 1.0, f"{tag}: kernel disagrees with its plain version")
        check(repeats, f"{tag}: a second launch gave other bits")
        if C is not None:
            check(row["undrawn_columns_bit_equal"] and row["counts"]["undrawn"] > 0,
                  f"{tag}: undrawn columns must keep H bit for bit")
        return row

    results["fused_iteration"] = run_iteration_case(
        "fused_iteration bench int8 kl", G, N, BLOCKS, N_LABELS, torch.int8,
        True, True)
    # small cases: 300 genes (not a multiple of either gene chunk) and 5000
    # or 5003 cells (not a multiple of any tile or of the cell chunk); K not
    # a multiple of 16 on the tensor-core path (int8, bf16), and K = 300 and
    # 512, where that path takes 16-cell tiles and float32 8-cell ones
    edge_cases = [
        (torch.int8, (7, 14), (3,), True),
        (torch.bfloat16, (5, 5, 30), (2, 3), False),
        (torch.bfloat16, (150, 150), (3,), False),
        (torch.int8, (200, 312), (4,), True),
        (torch.float32, (200, 312), (4,), True),
        (torch.int16, (150, 150), (3,), False)]
    for xdt, blocks, labels, kl in [
            (torch.float32, (3, 4, 6), (2, 3), False),
            (torch.bfloat16, (3, 9), (2,), True),
            (torch.int16, (2, 3, 4, 5), (2, 5, 3), False),
            (torch.float32, (1, 1), (1,), True),
            (torch.int8, (2, 1), (17,), True)] + edge_cases:
        run_iteration_case(f"fused_iteration small {str(xdt)[6:]} "
                           f"{blocks}/{labels} {'kl' if kl else 'frob'}",
                           300, 5000, blocks, labels, xdt, kl, False)
    results["fused_iteration_counts"] = run_iteration_case(
        "fused_iteration counts bench int8 kl", G, N, BLOCKS, N_LABELS,
        torch.int8, True, True, counts=sampler_counts)
    mixed_counts = lambda Ys, n: torch.randint(
        0, 4, (2, n), generator=gen, device=dev).float()  # 0, 1 and above 1
    for xdt, blocks, labels, kl in [
            (torch.float32, (3, 4, 6), (2, 3), False),
            (torch.bfloat16, (3, 9), (2,), True),
            (torch.int16, (2, 3, 4, 5), (2, 5, 3), False),
            (torch.float32, (1, 1), (1,), True),
            (torch.int8, (2, 1), (17,), True),
            (torch.int8, (5, 5, 30), (2, 3), False)] + edge_cases:
        run_iteration_case(f"fused_iteration counts small {str(xdt)[6:]} "
                           f"{blocks}/{labels} {'kl' if kl else 'frob'}",
                           300, 5003, blocks, labels, xdt, kl, False,
                           counts=mixed_counts)
    # 5040 cells: a multiple of 16, so the tensor-core path stages X, W and
    # Hn in 16-byte loads (5000 and 5003 take its element-by-element
    # staging), but not of the 64-cell tile or chunk
    for xdt, blocks, labels, kl in edge_cases:
        for C in (None, mixed_counts):
            run_iteration_case(f"fused_iteration {'counts ' if C else ''}small "
                               f"{str(xdt)[6:]} {blocks}/{labels} "
                               f"{'kl' if kl else 'frob'} n=5040",
                               300, 5040, blocks, labels, xdt, kl, False, counts=C)
    results["fused_h_update"] = run_iteration_case(
        "fused_h_update bench int8", G, N, (sum(BLOCKS),), (), torch.int8,
        True, True)
    # component_bucket=8: the blocks (5, 5, 30) padded to (8, 8, 32), K = 48
    results["fused_iteration bucketed"] = run_iteration_case(
        "fused_iteration bench int8 kl bucketed K=48", G, N, BUCKET_BLOCKS, N_LABELS,
        torch.int8, True, True)
    # the fp32 path (wtx_fma, the per-tile pass, hxt_fma): K1, K4 and K2 on
    # int16 X holding counts above 127, K1 on float32 X
    torch.cuda.empty_cache()
    results["fused_iteration int16"] = run_iteration_case(
        "fused_iteration bench int16 kl", G, N, BLOCKS, N_LABELS, torch.int16,
        True, True, x_scale=3)
    results["fused_iteration_counts int16"] = run_iteration_case(
        "fused_iteration counts bench int16 kl", G, N, BLOCKS, N_LABELS,
        torch.int16, True, True, counts=sampler_counts, x_scale=3)
    results["fused_h_update int16"] = run_iteration_case(
        "fused_h_update bench int16", G, N, (sum(BLOCKS),), (), torch.int16,
        True, True, x_scale=3)
    results["fused_iteration float32"] = run_iteration_case(
        "fused_iteration bench float32 kl", G, N, BLOCKS, N_LABELS, torch.float32,
        True, True)
    torch.cuda.empty_cache()
    run_iteration_case("fused_h_update small float32", 300, 5001, (13,), (),
                       torch.float32, True, False)
    run_iteration_case("fused_h_update small int16 n=5040", 300, 5040, (300,), (),
                       torch.int16, True, False, x_scale=3)
    run_iteration_case("fused_h_update small int8", 300, 5001, (21,), (),
                       torch.int8, True, False)

    def run_transform_case(K, n=N):
        """fused_transform at n cells (100k by default) and K components
        against its plain version, timed, with the path the rule by K takes."""
        Wt = torch.rand((G, K), generator=gen, device=dev)
        Xt = torch.poisson(torch.full((G, n), 1.5, device=dev), generator=gen)
        num2 = 2.0 * (Wt.T @ Xt)
        del Xt
        WtW2 = 2.0 * (Wt.T @ Wt)
        H0 = torch.rand((K, n), generator=gen, device=dev) + 0.05
        kern = lambda: kernels.fused_transform(num2, H0, WtW2, EPS,
                                               n_iter=TRANSFORM_ITERS)
        plain = lambda: kernels.fused_transform_plain(num2, H0, WtW2, EPS,
                                                      n_iter=TRANSFORM_ITERS)
        abs_err, worst = compare(kern(), plain(), 2e-4, 1e-6)
        bucket = kernels.transform_bucket(K)
        grid = None if bucket else kernels.transform_tiles_grid(K)
        path = (f"registers, bucket {bucket}" if bucket
                else f"tiled, {grid.T} cells a tile, K padded to {grid.KP}, "
                     f"ring of {grid.S} stages of {grid.J} rows")
        t_bytes = 3 * 4 * K * n + 4 * K * K
        t_ops = TRANSFORM_ITERS * (2.0 * K * K + 3.0 * K) * n
        bms, bby = bound(t_bytes, 0.0, t_ops, card)
        row = {"phase": "kernel",
               "case": f"fused_transform K={K} n_iter={TRANSFORM_ITERS}"
                       + ("" if n == N else f" n={n}"),
               "path": path, "grid": grid._asdict() if grid else None,
               "max_abs_err_Hn": abs_err,
               "worst_err_over_tolerance": worst,
               "tolerance": "rtol 2e-4, atol 1e-6*max|plain|",
               "ms": time_ms(kern, 5), "plain_ms": time_ms(plain, 3),
               # context, not the same function: n_iter fp32 products alone
               "matmul_fp32_x_n_iter_ms": TRANSFORM_ITERS * time_ms(
                   lambda: torch.matmul(WtW2, H0), 5),
               # loads and stores alone: what the steps' time sits on
               "ms_n_iter_0": time_ms(lambda: kernels.fused_transform(
                   num2, H0, WtW2, EPS, n_iter=0), 5),
               "bytes": t_bytes, "bf16_flop": 0.0, "fp32_flop": t_ops,
               "bound_ms": bms, "bound_by": bby}
        emit(row)
        check(worst <= 1.0, f"fused_transform at K={K} disagrees with its plain version")
        return row

    results["fused_transform"] = run_transform_case(sum(BLOCKS))
    results["fused_transform tiled"] = run_transform_case(100)
    # a 2 x 2 ("genes", "cells") grid's rank: its 50,000 cells (slice_gene_cell)
    results["fused_transform gene_cell"] = run_transform_case(sum(BLOCKS), N // 2)
    for K in (300, 512):
        run_transform_case(K)
    torch.cuda.empty_cache()

    # -- ALS's X passes: hxt (P1) and wtx (P2) -------------------------------
    x_pass_problem = lambda g, n, K, xdtype: make_x_pass_problem(torch, gen, dev, g, n, K,
                                                                 xdtype)
    run_x_pass_case = lambda kind, X, P, timed, note="": x_pass_row(
        torch, kernels, mu, card, kind, X, P, timed, note)

    X, W, H = x_pass_problem(G, N, sum(BLOCKS), torch.int8)
    results["hxt"] = run_x_pass_case("hxt", X, H, True)
    run_x_pass_case("wtx", X, W[:, :5].contiguous(), True)
    results["wtx"] = run_x_pass_case("wtx", X, W[:, 10:].contiguous(), True)
    # the minibatch steps' shape: one batch of MB_BATCH cells, all of K
    Xb = X[:, :MB_BATCH].contiguous()
    results["hxt minibatch"] = run_x_pass_case("hxt", Xb, H[:, :MB_BATCH].contiguous(), True)
    results["wtx minibatch"] = run_x_pass_case("wtx", Xb, W, True)
    # a minibatch epoch's loss: WᵀX over all cells, all of K
    results["wtx minibatch loss"] = run_x_pass_case("wtx", X, W, True)
    # a tiled batch: 64 whole tiles of 128 cells copied as slabs
    tiles = torch.randperm(N // TILE, generator=gen, device=dev)[:MB_BATCH // TILE]
    slab = lambda A: A[:, :N // TILE * TILE].reshape(A.shape[0], -1, TILE).index_select(
        1, tiles).reshape(A.shape[0], -1)
    Xt = slab(X)
    results["hxt tiled"] = run_x_pass_case("hxt", Xt, slab(H), True, " tiled slab")
    results["wtx tiled"] = run_x_pass_case("wtx", Xt, W, True, " tiled slab")
    # a 2 x 2 ("genes", "cells") grid's block: 1,000 genes x 50,000 cells
    # (slice_gene_cell), a contiguous row range of the rank's X
    Xg = X[:G // 2, :N // 2].contiguous()
    results["hxt gene_cell"] = run_x_pass_case("hxt", Xg, H[:, :N // 2].contiguous(), True,
                                               " grid block")
    results["wtx gene_cell"] = run_x_pass_case("wtx", Xg, W[:G // 2].contiguous(), True,
                                               " grid block")
    del X, W, H, Xb, Xt, Xg  # the int8 X goes before the float32 one is made
    torch.cuda.empty_cache()
    # P1/P2 away from the bench shape: X rows off 16-byte alignment beside
    # their aligned twins, small n; K1/K4 at the optimizer's fold widths
    twin_rows = x_pass_twin_rows(torch, kernels, mu, gen, dev, card)
    # a 2 x 2 grid's minibatch batch share (slice_gene_cell)
    results["hxt gene_cell minibatch"] = twin_rows[("hxt", "grid minibatch")]
    results["wtx gene_cell minibatch"] = twin_rows[("wtx", "grid minibatch")]
    iteration_twin_rows(torch, kernels, gen, dev, card)
    # float32 and int16 X (the FP32 units): one X at a time
    for xdt in (torch.float32, torch.int16):
        X, W, H = x_pass_problem(G, N, sum(BLOCKS), xdt)
        results[f"hxt_fma {str(xdt)[6:]}"] = run_x_pass_case("hxt", X, H, True)
        run_x_pass_case("wtx", X, W[:, :5].contiguous(), True)
        results[f"wtx_fma {str(xdt)[6:]}"] = run_x_pass_case(
            "wtx", X, W[:, 10:].contiguous(), True)
        del X, W, H
        torch.cuda.empty_cache()
    for xdt in (torch.int8, torch.bfloat16, torch.float32, torch.int16):
        for K, n in ((1, 1001), (13, 1001), (300, 1001), (40, 5040), (65, 5040),
                     (512, 5040), (40, 17)):
            X, W, H = x_pass_problem(300, n, K, xdt)
            run_x_pass_case("hxt", X, H, False)
            run_x_pass_case("wtx", X, W, False)

    # -- K > 512: every large-K route against its plain version ---------------
    results.update(run_kernel_wide_phase(torch, kernels, _build, gen, dev, card))

    # -- the streaming probe's entry point (P3) -------------------------------
    kernels.reset_launches()
    rates = probe.streaming_GBps(("int8", "float32"))
    torch.cuda.synchronize()
    probe_launches = kernels.launches["stream_probe"]
    check(probe_launches > 0, "the streaming probe must launch stream_probe")
    for xname, rate in rates.items():
        X = probe.stream_input(xname)
        fold, colsum = kernels.stream_probe(X)
        want_fold, want_colsum = kernels.stream_probe_plain(X)
        exact = bool(torch.equal(fold, want_fold) and torch.equal(colsum, want_colsum))
        g, n = X.shape
        nbytes = X.element_size() * g * n + 4 * n + 4 * 8 * 128
        bms, bby = bound(nbytes, 0.0, float(g) * n, card)
        row = {"phase": "stream_probe", "x_dtype": xname, "shape": [g, n],
               "tile": rate["tile"], "reps": rate["reps"], "ms": rate["ms"],
               "GBps_read": rate["GBps"], "bytes_read": rate["bytes_read"],
               "fold_and_colsum_exact": exact,
               "max_abs_err": float((fold - want_fold).abs().max()),
               "plain_ms": time_ms(lambda: kernels.stream_probe_plain(X), 3),
               "library_ms": time_ms(lambda: torch.sum(X, dim=0, dtype=torch.float32), 5),
               "library": "torch.sum(X, dim=0, dtype=float32)",
               "bytes": nbytes, "bound_ms": bms, "bound_by": bby,
               "launches": probe_launches}
        emit(row)
        check(exact, f"stream_probe {xname}: fold or column sums differ from the plain version")
        results.setdefault("stream_probe", row)
        del X

    # -- where the fit's device time goes: the fused fit loop alone ----------
    loop_rows = {}  # each loop's line, by phase

    def run_fit_loops(loops, xdtype, blocks=BLOCKS):
        """Each (phase, weighted, als, iterations[, batch size[, tile]]) fit
        loop on device-resident bench data whose X is stored as xdtype
        (int16: counts above 127); weighted None: the unguided loop (no
        covariates, K = 40); with a batch size, random minibatch epochs (a
        permutation an epoch from a seeded device generator), and with a
        tile, tiled epochs over X, Ys and H zero-padded to a tile multiple
        (a permutation of the tiles an epoch)."""
        X, W, H, _, Ys, Bs, lam = iteration_problem(
            torch, gen, dev, G, N, blocks, N_LABELS, xdtype)
        if xdtype == torch.int16:
            X *= 3
        hyper = (lam, 0.0, 0.0, 0.0, EPS)
        unguided_hyper = (lam[:0], 0.0, 0.0, 0.0, EPS)
        tables = group_tables(Ys)
        loop_gen = torch.Generator(device=dev)

        def draw_counts(t):
            loop_gen.manual_seed(t)
            return mu.grouped_balanced_counts(loop_gen, N, tables)

        loop_launches = {}
        for phase, weighted, als, iters, *mb in loops:
            batch = mb[0] if mb else None
            tile = mb[1] if len(mb) > 1 else 0
            guided = weighted is not None
            cfg = mu.MUConfig(blocks=blocks if guided else (sum(blocks),),
                              n_labels=N_LABELS if guided else (), n_cells=N,
                              max_iter=iters, x_dtype=str(xdtype)[6:],
                              weighted_counts=bool(weighted), use_als=als,
                              batch_size=batch, tile=tile)
            pad = (-N) % tile if tile else 0
            pad_cells = lambda A: torch.nn.functional.pad(A, (0, pad)) if pad else A
            Xl, Ysl = pad_cells(X), [pad_cells(y) for y in Ys]
            n_draw = Xl.shape[1] // tile if tile else N

            def draw_cells(t, n_draw=n_draw):
                loop_gen.manual_seed(t)
                return torch.randperm(n_draw, generator=loop_gen, device=dev)

            drive = (lambda: mu.fit_scan(cfg, W, H, Bs, Xl, Ysl, hyper,
                                         draw_counts=draw_counts,
                                         draw_cells=draw_cells)) if guided else (
                lambda: mu.fit_scan(cfg, W, H, (), X, (), unguided_hyper))
            drive()
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            drive()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            loop_launches[phase] = dict(kernels.launches)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                drive()
                torch.cuda.synchronize()
                traced_wall = time.perf_counter() - t0
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0]
            events.sort(key=lambda e: -e.self_device_time_total)
            busy_us = sum(e.self_device_time_total for e in events)
            # the batches' copies of X, Ys and H and the scatter of H back
            copy_us = sum(e.self_device_time_total for e in events
                          if re.search(r"index|gather|scatter", e.key, re.I))
            del Xl, Ysl
            loop_rows[phase] = {
                "phase": phase, "iterations": iters, "x_dtype": str(xdtype)[6:],
                "launches": loop_launches[phase], "tile": tile,
                "ms_per_iteration": wall * 1e3 / iters,
                "gather_scatter_device_ms_per_iteration": copy_us * 1e-3 / iters,
                # kernel time over wall time, both of the traced run
                "device_busy_share": busy_us * 1e-6 / traced_wall,
                "device_ms_per_iteration": busy_us * 1e-3 / iters,
                "top_device_kernels_ms_per_iteration": [
                    [e.key[:60], e.self_device_time_total * 1e-3 / iters]
                    for e in events[:10]]}
            emit(loop_rows[phase])
        del X, W, H, Ys, Bs, tables
        torch.cuda.empty_cache()
        return loop_launches

    run_fit_loops((("fit_loop", False, False, LOOP_ITERS),
                   ("fit_loop_weighted_fast", True, False, LOOP_ITERS),
                   ("fit_loop_als", False, True, ALS_LOOP_ITERS),
                   ("fit_loop_minibatch", False, False, MB_LOOP_EPOCHS, MB_BATCH),
                   ("fit_loop_tiled", False, False, MB_LOOP_EPOCHS, MB_BATCH, TILE),
                   ("fit_loop_minibatch_als", False, True, MB_LOOP_EPOCHS, MB_BATCH)),
                  torch.int8)
    # int16 X: the ALS loop runs hxt_fma and wtx_fma, the joint loops K1's,
    # K4's and K2's fp32 path (wtx_fma, the per-tile pass, hxt_fma; and P1's
    # hxt_fma once for the first X Hᵀ)
    int16_loops = run_fit_loops(
        (("fit_loop_als_int16", False, True, ALS_LOOP_ITERS),
         ("fit_loop_int16", False, False, LOOP_ITERS),
         ("fit_loop_weighted_fast_int16", True, False, LOOP_ITERS),
         ("fit_loop_unguided_int16", None, False, LOOP_ITERS)), torch.int16)
    float32_loops = run_fit_loops(
        (("fit_loop_als_float32", False, True, ALS_LOOP_ITERS),
         ("fit_loop_float32", False, False, LOOP_ITERS)), torch.float32)
    # K = 768: the full-batch loop on the large-K chain (K1 a step)
    k768_loop = run_fit_loops((("fit_loop_k768", False, False, LOOP_ITERS),), torch.int8,
                              K768_BLOCKS)["fit_loop_k768"]
    check(k768_loop["fused_iteration"] == LOOP_ITERS,
          f"fit_loop_k768: {k768_loop['fused_iteration']} K1 launches")
    # and on int16 X (counts x 3): the chain's fp32 X passes
    k768_int16_loop = run_fit_loops((("fit_loop_k768_int16", False, False, LOOP_ITERS),),
                                    torch.int16, K768_BLOCKS)["fit_loop_k768_int16"]
    check(k768_int16_loop["fused_iteration"] == LOOP_ITERS
          and k768_int16_loop["wtx_fma_wide"] == LOOP_ITERS
          and k768_int16_loop["hxt_fma_wide"] >= LOOP_ITERS
          and k768_int16_loop["hxt_wide"] == k768_int16_loop["wtx_wide"] == 0,
          f"fit_loop_k768_int16: launches {k768_int16_loop}")
    int16_launches = int16_loops["fit_loop_als_int16"]
    float32_launches = float32_loops["fit_loop_als_float32"]
    for tag, counted in (("int16", int16_launches), ("float32", float32_launches)):
        check(counted["hxt"] == ALS_LOOP_ITERS and counted["wtx"] == 3 * ALS_LOOP_ITERS,
              f"the {tag} ALS loop must launch hxt once and wtx once a block per iteration")
    fp32_k_launches = {
        "fused_iteration int16": int16_loops["fit_loop_int16"]["fused_iteration"],
        "fused_iteration_counts int16":
            int16_loops["fit_loop_weighted_fast_int16"]["fused_iteration_counts"],
        "fused_h_update int16": int16_loops["fit_loop_unguided_int16"]["fused_h_update"],
        "fused_iteration float32": float32_loops["fit_loop_float32"]["fused_iteration"]}
    for kname, counted in fp32_k_launches.items():
        check(counted == LOOP_ITERS, f"{kname}: {counted} launches in {LOOP_ITERS} iterations")

    # -- a small fit on the card against the same fit on the CPU ------------
    r = np.random.default_rng(1)
    Xs = (r.gamma(2.0, 1.0, (400, 6)) @ r.gamma(2.0, 1.0, (6, 60))
          + r.random((400, 60))).astype(np.float32)
    obs_s = {"batch": np.array([f"b{i % 2}" for i in range(400)], dtype=object)}
    for phase, als in (("small", False), ("small_als", True)):
        fits = {}
        for where in ("cuda", "cpu"):
            ad = AnnData(Xs, obs=obs_s)
            m = ALPINE(n_components=6, n_covariate_components=[2], lam=[10.0],
                       device=where, random_state=7, use_als=als)
            m.fit(ad, ["batch"], max_iter=20)
            m.transform(ad)
            fits[where] = (m.loss_history_, ad.obsm["ALPINE_embedding"])
        floor = 2e-6 * float(np.sum(np.square(Xs.astype(np.float64))))
        loss_gap = float(np.max(np.abs(fits["cuda"][0] - fits["cpu"][0])
                                - 5e-4 * np.abs(fits["cpu"][0]) - floor))
        emb_ok = np.allclose(fits["cuda"][1], fits["cpu"][1], rtol=5e-3, atol=1e-5)
        emit({"phase": phase, "loss_excess_over_tolerance": loss_gap,
              "embedding_allclose": bool(emb_ok),
              "tolerance": "loss rtol 5e-4 + 2e-6*|X|^2, embedding rtol 5e-3 atol 1e-5"})
        check(loss_gap <= 0 and emb_ok, f"{phase}: card fit disagrees with the CPU fit")

    # -- the slice at full width ---------------------------------------------
    r = np.random.default_rng(0)
    t0 = time.perf_counter()
    rates = (r.gamma(2.0, 0.5, (N, 8)) @ r.gamma(2.0, 0.25, (8, G))).astype(np.float32)
    counts = np.minimum(r.poisson(rates), 127).astype(np.float32)
    del rates
    obs = {"batch": np.array(["b0", "b1"], dtype=object)[r.integers(0, 2, N)],
           "condition": np.array(["c0", "c1", "c2"], dtype=object)[r.integers(0, 3, N)]}
    adata = AnnData(counts, obs=obs)
    data_s = time.perf_counter() - t0

    model = ALPINE(n_components=30, n_covariate_components=[5, 5],
                   lam=[1e3, 1e3], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    model.fit(adata, ["batch", "condition"], max_iter=FIT_ITERS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(model._x_cache is not None, "the fit must keep its device X")
    t0 = time.perf_counter()
    model.transform(adata)  # through the fit's device X
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    main_launches = dict(kernels.launches)
    slice_peak = torch.cuda.max_memory_allocated()
    L = slice_losses = model.loss_history_
    emit({"phase": "slice", "cells": N, "genes": G, "data_seconds": data_s,
          "fit_seconds": fit_s, "fit_iterations": FIT_ITERS,
          "seconds_per_iteration_incl_setup": fit_s / FIT_ITERS,
          "timings": model.timings_, "transform_seconds_cached": transform_s,
          "transform_iterations": model.max_iter, "data_dtype": model.data_dtype_,
          "launches": main_launches, "loss_first": L[0].tolist(),
          "loss_last": L[-1].tolist(), "peak_memory_bytes": slice_peak})
    model.free_device_cache()
    check(model.data_dtype_ == "int8", "auto must resolve to int8")
    check(main_launches["fused_iteration"] == FIT_ITERS,
          "fused_iteration must launch once per fit iteration")
    check(main_launches["fused_transform"] == 1, "transform must launch fused_transform")
    check(np.isfinite(L).all(), "loss history must be finite")
    check(L[-1, 0] < L[0, 0], "total loss must fall")
    check(adata.obsm["ALPINE_embedding"].shape == (N, 30), "embedding shape")
    for key in ("batch", "condition"):
        check(adata.obsm[key].shape == (N, 5), f"{key} block shape")
        check(np.isfinite(adata.obsm[key]).all(), f"{key} block finite")
    check(np.isfinite(adata.obsm["ALPINE_embedding"]).all(), "embedding finite")

    slice_ref = {"loss": slice_losses, "W": np.concatenate(model.matrices["Ws"], axis=1),
                 "H": np.concatenate(model.matrices["Hs"], axis=0),
                 "T": np.concatenate([adata.obsm[k] for k in ("batch", "condition")]
                                     + [adata.obsm["ALPINE_embedding"]], axis=1)}

    # -- random-minibatch and gathered weighted fits: hxt/wtx on the batches;
    # their fits are the mesh phases' single-device references (on an
    # AnnData of their own: slice_persist reads the slice's embeddings) -----
    mb_launches, mb_rows, mb_refs = {}, {}, {}
    mb_adata = AnnData(counts, obs=obs)
    for phase, kw in (("slice_minibatch", {}),
                      ("slice_minibatch_als", dict(use_als=True)),
                      ("slice_weighted", dict(sampling_method="weighted")),
                      ("slice_tiled", dict(sampling_method="tiled"))):
        mb_launches[phase], mb_rows[phase], mb_refs[phase] = run_minibatch_phase(
            phase, torch, kernels, ALPINE, mb_adata, slice_peak,
            baseline=mb_rows.get("slice_minibatch"), **kw)
    del mb_adata

    # -- the slice over a cell mesh of 1, 2 and 3 processes ------------------
    run_sharded_phase(torch, kernels, mu, ALPINE, AnnData, counts, obs, slice_ref)
    del slice_ref
    global_launches, global_shares = run_sharded_modes_phase(
        torch, kernels, mu, ALPINE, AnnData, counts, obs, mb_refs)
    grid_launches, grid_shares = run_gene_cell_phase(
        torch, kernels, mu, ALPINE, AnnData, counts, obs, slice_losses, mb_refs)
    del mb_refs
    # P1/P2 at the shares of a batch that those fits ran (rank 0's, epoch 0;
    # the ALS and weighted fits' shares differ, the ALS ones of the random
    # minibatch's permutation): a cell mesh rank's 2,000 genes, a 2 x 2
    # grid rank's 1,000
    share_rows = x_pass_share_rows(torch, kernels, mu, gen, dev, card, (
        ("global share als", G, global_shares["als_minibatch"], (5, 30)),
        ("global share weighted", G, global_shares["weighted"], (5, 30, 40)),
        ("grid share als", G // 2, grid_shares["als_minibatch"], (5, 30)),
        ("grid share weighted", G // 2, grid_shares["weighted"], (40,))))
    check(global_shares["weighted"] == global_shares["weighted_als"],
          "the weighted fits' shares come from one draw stream")

    run_persist_phase(torch, kernels, ALPINE, AnnData, counts, obs)

    # -- the unguided path (no covariates): fused_h_update -------------------
    unguided = ALPINE(n_components=40, n_covariate_components=[], lam=[],
                      device="cuda")
    kernels.reset_launches()
    t0 = time.perf_counter()
    unguided.fit(adata, [], max_iter=10)
    torch.cuda.synchronize()
    unguided_s = time.perf_counter() - t0
    unguided_launches = dict(kernels.launches)
    Lu = unguided.loss_history_
    emit({"phase": "slice_unguided", "fit_seconds": unguided_s,
          "fit_iterations": 10, "launches": unguided_launches,
          "loss_first": Lu[0].tolist(), "loss_last": Lu[-1].tolist()})
    check(unguided_launches["fused_h_update"] == 10,
          "fused_h_update must launch once per unguided fit iteration")
    check(np.isfinite(Lu).all() and Lu[-1, 0] < Lu[0, 0], "unguided loss")
    unguided.free_device_cache()
    del model, unguided
    torch.cuda.empty_cache()

    # -- weighted_fast: balanced sampling as per-cell counts (K4) -------------
    wf = ALPINE(n_components=30, n_covariate_components=[5, 5],
                lam=[1e3, 1e3], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    wf.fit(adata, ["batch", "condition"], max_iter=FIT_ITERS,
           sampling_method="weighted_fast")
    torch.cuda.synchronize()
    wf_fit_s = time.perf_counter() - t0
    check(wf._x_cache is not None and wf._x_cache[3] is not None,
          "the weighted_fast fit must keep its group-sorted device X")
    t0 = time.perf_counter()
    wf.transform(adata)  # through the group-sorted device X
    torch.cuda.synchronize()
    cached_s = time.perf_counter() - t0
    emb_cached = {k: adata.obsm[k].copy()
                  for k in ("ALPINE_embedding", "batch", "condition")}
    wf.free_device_cache()
    t0 = time.perf_counter()
    wf.transform(adata)  # uploads X again
    torch.cuda.synchronize()
    uncached_s = time.perf_counter() - t0
    wf_launches = dict(kernels.launches)
    Lw = wf.loss_history_
    cache_ok = all(np.allclose(emb_cached[k], adata.obsm[k], rtol=1e-5)
                   for k in emb_cached)
    emit({"phase": "slice_weighted_fast", "fit_seconds": wf_fit_s,
          "fit_iterations": FIT_ITERS, "timings": wf.timings_,
          "transform_seconds_cached": cached_s,
          "transform_seconds_uncached": uncached_s,
          "cached_matches_uncached": bool(cache_ok),
          "launches": wf_launches, "loss_first": Lw[0].tolist(),
          "loss_last": Lw[-1].tolist(),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    check(wf_launches["fused_iteration_counts"] == FIT_ITERS,
          "fused_iteration's counts mode must launch once per fit iteration")
    check(wf_launches["fused_iteration"] == 0,
          "a weighted_fast fit must not launch the plain fused_iteration")
    check(wf_launches["fused_transform"] >= 1, "transform must launch fused_transform")
    check(np.isfinite(Lw).all(), "weighted_fast loss history must be finite")
    check(Lw[-1, 0] < Lw[0, 0], "weighted_fast total loss must fall")
    check(adata.obsm["ALPINE_embedding"].shape == (N, 30), "embedding shape")
    for key in ("batch", "condition"):
        check(adata.obsm[key].shape == (N, 5), f"{key} block shape")
    check(all(np.isfinite(v).all() for v in emb_cached.values()),
          "weighted_fast embeddings finite")
    check(cache_ok, "cached and uncached transforms must agree (rtol 1e-5)")
    wf.free_device_cache()
    del wf
    torch.cuda.empty_cache()

    # -- ALS mode: hxt once and wtx once a block each iteration ---------------
    als = ALPINE(n_components=30, n_covariate_components=[5, 5],
                 lam=[1e3, 1e3], use_als=True, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    als.fit(adata, ["batch", "condition"], max_iter=FIT_ITERS)
    torch.cuda.synchronize()
    als_fit_s = time.perf_counter() - t0
    check(als._x_cache is not None, "the ALS fit must keep its device X")
    t0 = time.perf_counter()
    als.transform(adata)  # through the fit's device X
    torch.cuda.synchronize()
    als_transform_s = time.perf_counter() - t0
    als_launches = dict(kernels.launches)
    La = als.loss_history_
    emit({"phase": "slice_als", "fit_seconds": als_fit_s,
          "fit_iterations": FIT_ITERS, "timings": als.timings_,
          "transform_seconds_cached": als_transform_s,
          "launches": als_launches, "loss_first": La[0].tolist(),
          "loss_last": La[-1].tolist(),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    check(als_launches["hxt"] == FIT_ITERS, "hxt must launch once per ALS iteration")
    check(als_launches["wtx"] == 3 * FIT_ITERS,
          "wtx must launch once per block per ALS iteration")
    check(als_launches["fused_iteration"] == 0, "an ALS fit must not launch fused_iteration")
    check(als_launches["fused_transform"] == 1, "transform must launch fused_transform")
    check(np.isfinite(La).all(), "ALS loss history must be finite")
    check(La[-1, 0] < La[0, 0], "ALS total loss must fall")
    check(adata.obsm["ALPINE_embedding"].shape == (N, 30), "embedding shape")
    for key in ("batch", "condition"):
        check(adata.obsm[key].shape == (N, 5), f"{key} block shape")
        check(np.isfinite(adata.obsm[key]).all(), f"{key} block finite")
    check(np.isfinite(adata.obsm["ALPINE_embedding"]).all(), "embedding finite")
    als.free_device_cache()
    del als
    torch.cuda.empty_cache()

    # -- component bucketing, restarts and mid-fit checkpoints ----------------
    bucket_launches = run_bucket_phase(torch, kernels, mu, ALPINE, adata)
    run_restarts_phase(torch, kernels, mu, ALPINE, adata, slice_losses)
    run_checkpoint_phase(torch, kernels, ALPINE, adata, slice_losses)

    # -- K = 100: the transform's tiled path through the estimator ------------
    k100 = ALPINE(n_components=90, n_covariate_components=[5, 5],
                  lam=[1e3, 1e3], device="cuda")
    kernels.reset_launches()
    t0 = time.perf_counter()
    k100.fit(adata, ["batch", "condition"], max_iter=5)
    torch.cuda.synchronize()
    k100_fit_s = time.perf_counter() - t0
    check(k100._x_cache is not None, "the K = 100 fit must keep its device X")
    t0 = time.perf_counter()
    k100.transform(adata, n_iter=TRANSFORM_ITERS)  # through the fit's device X
    torch.cuda.synchronize()
    k100_transform_s = time.perf_counter() - t0
    k100_launches = dict(kernels.launches)
    emb = adata.obsm["ALPINE_embedding"]
    emit({"phase": "slice_k100", "components": 100, "fit_seconds": k100_fit_s,
          "fit_iterations": 5, "transform_seconds_cached": k100_transform_s,
          "transform_iterations": TRANSFORM_ITERS,
          "transform_path": kernels.transform_tiles_grid(100)._asdict(),
          "launches": k100_launches, "loss_last": k100.loss_history_[-1].tolist()})
    check(kernels.transform_bucket(100) == 0, "K = 100 must take the tiled path")
    check(k100_launches["fused_transform"] == 1, "transform must launch fused_transform once")
    check(emb.shape == (N, 90), f"embedding shape {emb.shape}")
    check(np.isfinite(emb).all(), "K = 100 embedding finite")
    k100.free_device_cache()
    del k100
    torch.cuda.empty_cache()

    # -- K = 768 (the JAX package's bucket level): the large-K routes --------
    k768_launches = run_k768_phase(torch, kernels, ALPINE, AnnData, counts, obs)
    # the same model on counts above 127 (x 5): "auto" stores int16 X, so
    # K1's chain and P1 take the fp32 X passes hxt_fma_wide / wtx_fma_wide;
    # the device loop's ms an iteration and ms by kernel are
    # fit_loop_k768_int16's
    loop = loop_rows["fit_loop_k768_int16"]
    k768_int16_launches = run_k768_phase(
        torch, kernels, ALPINE, AnnData, counts * K768_INT16_SCALE, obs,
        phase="slice_k768_int16", iters=K768_INT16_ITERS, dtype="int16",
        extra={"device_loop": {k: loop[k] for k in (
            "phase", "ms_per_iteration", "device_ms_per_iteration", "device_busy_share",
            "top_device_kernels_ms_per_iteration")}})
    k768_modes = run_k768_modes_phase(torch, kernels, ALPINE, AnnData, counts, obs)

    # -- ComponentOptimizer: a search at the bench shape, then its paths ------
    def iteration_row(tag, g, n, blocks, counts=False):
        results[tag[:-len(" fold")]] = run_iteration_case(
            f"{tag} int8 kl K={sum(blocks)} n={n}", g, n, tuple(blocks), N_LABELS,
            torch.int8, True, True, counts=sampler_counts if counts else None)

    def transform_row(tag, K, n):
        results[tag[:-len(" fold")]] = run_transform_case(K, n)

    def grid_x_pass_rows(name, g, n, K):
        """P1 and P2 (all of W) at a grid rank's block of g genes x n cells."""
        X, W, H = x_pass_problem(g, n, K, torch.int8)
        results[f"hxt {name}"] = run_x_pass_case("hxt", X, H, True, " grid optimizer")
        results[f"wtx {name}"] = run_x_pass_case("wtx", X, W, True, " grid optimizer")
        del X, W, H
        torch.cuda.empty_cache()

    def x_pass_rows(g, n, K):
        X, W, H = x_pass_problem(g, n, K, torch.int8)
        results["hxt optimizer"] = run_x_pass_case("hxt", X, H, True, " optimizer fold")
        # the unguided block's width (the ALS step's widest wtx)
        results["wtx optimizer"] = run_x_pass_case(
            "wtx", X, W[:, K - 32:].contiguous(), True, " optimizer fold")
        del X, W, H
        torch.cuda.empty_cache()

    cases = {"iteration": iteration_row, "transform": transform_row, "x_pass": x_pass_rows,
             "grid_x_pass": grid_x_pass_rows}
    opt_launches, opt_k3_paths, opt_ref = run_optimize_phase(torch, kernels, adata, cases)
    paths_launches = run_optimize_paths_phase(torch, kernels, adata, cases)
    sharded_opt_launches, sharded_opt_k3, sharded_detect = run_optimize_sharded_phase(
        torch, kernels, adata, counts, obs, opt_ref["trials"])
    grid_opt_launches = run_optimize_grid_phase(torch, kernels, counts, obs, opt_ref,
                                                sharded_detect, cases)

    launches = {"fused_iteration": main_launches["fused_iteration"],
                "fused_iteration_counts": wf_launches["fused_iteration_counts"],
                "fused_transform": main_launches["fused_transform"],
                "fused_transform tiled": k100_launches["fused_transform"],
                "fused_h_update": unguided_launches["fused_h_update"],
                "hxt": als_launches["hxt"], "wtx": als_launches["wtx"],
                "hxt minibatch": mb_launches["slice_minibatch"]["hxt"],
                # slice_minibatch's wtx: one a batch, and one an epoch for the loss
                "wtx minibatch": mb_launches["slice_minibatch"]["wtx"] - MB_EPOCHS,
                "wtx minibatch loss": MB_EPOCHS,
                "hxt tiled": mb_launches["slice_tiled"]["hxt"],
                # slice_tiled's wtx: one a batch (and one an epoch for the loss)
                "wtx tiled": mb_launches["slice_tiled"]["wtx"] - MB_EPOCHS,
                "fused_iteration bucketed": bucket_launches["fused_iteration"],
                "stream_probe": probe_launches,
                # the fp32 paths (hxt_fma, wtx_fma): the int16 and float32 ALS loops
                "hxt_fma int16": int16_launches["hxt"], "wtx_fma int16": int16_launches["wtx"],
                "hxt_fma float32": float32_launches["hxt"],
                "wtx_fma float32": float32_launches["wtx"], **fp32_k_launches,
                # the optimizer's folds: the search's K1 and K3, the paths' K4
                # (weighted_fast folds) and P1/P2 (ALS folds)
                "fused_iteration optimizer": opt_launches["fused_iteration"],
                # the search's K3 by path: a row each, timed at its own K
                **{f"fused_transform optimizer {p}": n for p, n in opt_k3_paths.items()},
                "fused_iteration_counts optimizer":
                    paths_launches["weighted_fast"]["fused_iteration_counts"],
                "hxt optimizer": paths_launches["als"]["hxt"],
                "wtx optimizer": paths_launches["als"]["wtx"],
                # the search over processes: world 2's ranks together, at the
                # folds (and points) of slice_optimize
                "fused_iteration optimizer sharded": sharded_opt_launches["fused_iteration"],
                **{f"fused_transform optimizer sharded {p}": n
                   for p, n in sharded_opt_k3.items()},
                # the search on a 2 x 2 grid: K1 and K3 on the folds' owners
                # (four ranks together, at slice_optimize's folds), P1/P2 in
                # the max_iter=None search's grid folds (at a rank's share of
                # a training fold) and in the grid refit (a rank's block)
                **grid_opt_launches,
                # the 2 x 2 grid's four ranks together, at a rank's block:
                # P1 in every full-batch fit and the checkpointed one, P2 at
                # K = 40 (joint, weighted_fast, checkpointed, each minibatch
                # epoch's loss), K3 in the transform; at a rank's share of a
                # minibatch batch, P1 and P2 a non-empty share
                "hxt gene_cell": grid_launches["hxt"],
                "wtx gene_cell": grid_launches["wtx"],
                "fused_transform gene_cell": grid_launches["fused_transform"],
                "hxt gene_cell minibatch": grid_launches["hxt minibatch"],
                "wtx gene_cell minibatch": grid_launches["wtx minibatch"],
                # the global-draw fits over processes at a rank's share of a
                # batch: slice_sharded_modes' world 2 (2,000 genes; its two
                # ranks together) and the 2 x 2 grid of slice_gene_cell (1,000
                # genes; four ranks), P1 one a non-empty share, P2 one a block
                # of it (ALS: k = 5, 5, 30); and world 2's losses, a P2 at a
                # rank's 50,000 cells an epoch
                **share_launches(global_launches, grid_launches),
                # K = 768: slice_k768 (K1 once an iteration, P1 once, K3
                # once) and slice_k768_modes (K2, K4; ALS: P1 once an
                # iteration and P2 a block, the k = 384 block a third of
                # them; minibatch: P1 and P2 at K = 768 a batch, P2 an epoch)
                "fused_iteration wide": k768_launches["fused_iteration"],
                "fused_iteration_counts wide":
                    k768_modes["weighted_fast"]["fused_iteration_counts"],
                "fused_h_update wide": k768_modes["unguided"]["fused_h_update"],
                f"fused_transform wide K={K768} n_iter={TRANSFORM_ITERS}":
                    k768_launches["fused_transform"],
                f"hxt wide K={K768}": k768_launches["hxt"] + sum(
                    m["hxt"] for m in k768_modes.values()),
                f"wtx wide K={K768}": k768_modes["minibatch"]["wtx"],
                f"wtx k=384 K={K768 // 2}": k768_modes["als"]["wtx"] // 3,
                # gram_wide: once in each K1 (slice_k768) and K2 call, and
                # in counts mode once in each K4 call
                f"gram_wide K={K768}": k768_launches["gram_wide"]
                + k768_modes["unguided"]["gram_wide"],
                f"gram_wide counts K={K768}": k768_modes["weighted_fast"]["gram_wide"],
                # wtw_gemm's store: once in each K1 (slice_k768), K2 and K4
                # call (K3's per-step updates are fused_transform's row)
                f"wtw_gemm K={K768}": k768_launches["wtw_gemm"]
                + k768_modes["unguided"]["wtw_gemm"] + k768_modes["weighted_fast"]["wtw_gemm"],
                # int16 X at K = 768 (slice_k768_int16): K1's chain and the
                # fp32 X passes, P1's first X Hᵀ and the chain's X Hsᵀ and WᵀX
                "fused_iteration wide int16": k768_int16_launches["fused_iteration"],
                f"hxt fma_wide K={K768} int16": k768_int16_launches["hxt_fma_wide"],
                f"wtx fma_wide K={K768} int16": k768_int16_launches["wtx_fma_wide"]}
    for kname in SHARE_ROW_SOURCE:
        results[kname] = share_rows[SHARE_ROW_SOURCE[kname]]
    results["wtx global shard loss"] = twin_rows[("wtx", "world-2 shard")]
    for p in sharded_opt_k3:
        results[f"fused_transform optimizer sharded {p}"] = \
            results[f"fused_transform optimizer {p}"]
    results["fused_iteration optimizer sharded"] = results["fused_iteration optimizer"]
    for kname in grid_opt_launches:
        if kname.startswith(("fused_iteration", "fused_transform")):
            results[kname] = results[kname.replace(" grid", "")]
    for kname in ("fused_iteration wide int16", f"hxt fma_wide K={K768} int16",
                  f"wtx fma_wide K={K768} int16"):
        check(launches[kname] > 0, f"{kname}: no launch on slice_k768_int16's path")
    rows = []
    for kname in ("fused_iteration", "fused_iteration_counts", "fused_h_update",
                  "fused_iteration float32", "fused_iteration int16",
                  "fused_iteration_counts int16", "fused_h_update int16",
                  "fused_transform", "fused_transform tiled", "hxt", "wtx",
                  "hxt minibatch", "wtx minibatch", "wtx minibatch loss",
                  "hxt tiled", "wtx tiled", "fused_iteration bucketed",
                  "hxt_fma float32", "hxt_fma int16",
                  "wtx_fma float32", "wtx_fma int16", "stream_probe",
                  "fused_iteration optimizer",
                  *(k for k in launches if k.startswith("fused_transform optimizer ")
                    and "sharded" not in k and "grid" not in k),
                  "fused_iteration_counts optimizer", "hxt optimizer", "wtx optimizer",
                  "fused_iteration optimizer sharded",
                  *(k for k in launches
                    if k.startswith("fused_transform optimizer sharded ")),
                  *grid_opt_launches,
                  "hxt gene_cell", "wtx gene_cell", "fused_transform gene_cell",
                  "hxt gene_cell minibatch", "wtx gene_cell minibatch",
                  *SHARE_ROW_SOURCE, "wtx global shard loss",
                  *WIDE_ROWS):
        res = results[kname]
        base = kname.split()[0].replace("_fma", "")
        rows.append({"name": kname, "route": "cuda",
                     "source": WIDE_ROWS.get(kname, SOURCES[base]),
                     "replaces": REPLACES[base], "launches": launches[kname],
                     "max_abs_err": res.get("max_abs_err_Hn", res.get("max_abs_err")),
                     "ms": res["ms"], "plain_ms": res["plain_ms"],
                     "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                     "library_ms": res.get("library_ms")})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
