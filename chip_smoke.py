#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``repro_torch``) on one GPU.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --parent-log FILE    # and other runs' times

Run from a checkout: it builds the CUDA kernels from
``src/repro_torch/kernels/csrc`` with ``nvcc`` (sm_90a), then

1. prints the card's name and power limit (``nvidia-smi``), the build
   time and, per kernel instantiation (f32, f64 and bf16), registers,
   spill stores and static shared memory; fails if an f32 or bf16
   full-link instantiation of any kernel (B1, B2 or B3) spills;
2. holds kernel B1 (hop block) against its plain PyTorch version on the
   card over both parities, axpy on/off, gc 18/12/8, nrhs 1/4/12 (12 is
   the propagator's block), f32/f64, on (3,5,3,6), a ragged (4,5,3,10),
   wilson-16x16x16x16 and wilson-64x16x16x8 (tolerance: f32 5e-5, f64
   1e-10 absolute, the reference's parity tolerances); then B1's halo
   mode on halo-extended arrays with random halos, with four tz_offsets,
   on three of those shapes (per-real and 16-byte link copies) and on
   the thin slabs of the distributed boundary passes (``SLAB_SHAPES``:
   one t-row or one z-plane of 16^4 under a 2 x 2 grid and at one rank),
   where it must also equal periodic mode on wrap-extended arrays bit
   for bit;
   then the two-launch Dhat (two B1 launches) against B2, bit for bit,
   at every shape, link form and ``FUSED_NRHS``;
3. holds kernel B2 (fused Dhat) against its plain version over the same
   shapes with nrhs 1/3/4/5/12 (3 and 5 give uneven thread groups; the
   ragged shape's Y*Xh and Z are no multiples of the tiles);
4. holds kernel B3 (the streaming fused Dhat over a ring of t-rows,
   ordered by flags) against its plain version, which walks the same
   schedule, and against B2, bit for bit, over f32/f64, gc 18/12/8,
   nrhs 1/3/4/5/12, tz_offset (0,0)/(1,0) on the same shapes, plus rings
   of 4 and 5 rows (the default is 8);
4b. holds the bf16 kernels against their plain versions (bf16 stored,
   f32 computed, each stored tensor rounded once) within 2^-7 of
   max|plain|, one bf16 rounding step: B1 periodic on every check shape
   and halo mode on the halo shapes, B2 and B3 at FUSED_NRHS; the
   two-launch Dhat and B3 must equal B2 bit for bit;
4c. holds the fused CG update (``cg_update``) to the plain op sequence
   on the card, bit for bit, at the propagator cell's block (16x32x32x64
   x 12, f32) and at 16^4 x 12 in f64, its reductions to a float64 sum,
   times each of its launches beside its bound and the inline ATen ops it
   replaced, and a 12-column cgnr at 16^4 with and without it;
4d. runs the invariant gate's runtime checks on the card (``gate``,
   ``repro_torch.analysis``: TJ1, TJ2, TJ4 and TJ6 at 4x4x4x8, f32 and
   bf16, through B1, B2 and B3): no dtype change or codec call inside a
   native solve of any backend and its host reads per iteration within
   budget (printed), exact kernel calls per Dhat and per distributed
   hop, one build per session key and pool bucket, every Krylov method
   stopped by a non-finite operator; fails on any finding and on any
   wrapper whose calls (what the gate counts on the CPU) differ from its
   launches; prints its time beside the card's name and power limit;
5. drives the main path, ``repro_torch.launch.solve.main`` with cgnr,
   tol 1e-6 and backend auto (which must resolve to cuda_fused), at
   wilson-16x16x16x16 and wilson-64x16x16x8, with the launch counters
   set to 0 just before each run and its Dhat applications counted;
   checks the full-lattice residual and that every Dhat went through the
   kernel measured faster there (written out in ``MAIN_LATTICES``, not
   asked of the rule under test: B2 at 16^4, two B1 launches at
   wilson-64x16x16x8), then solves once more with the torch_ref backend
   on the card;
6. drives the multi-RHS path: one 12-source propagator per solve at
   wilson-16x16x16x16 with ``--nrhs 12 --backend cuda_fused_stream``,
   counters set to 0 just before; checks every column's full-lattice
   residual and that every Dhat was a B3 launch; then the same solve with
   ``--backend auto``, whose Dhats must be the kernel measured faster
   for a block (``PROPAGATOR_AUTO_KERNEL``, two B1 launches);
7. drives the ``cuda_hop`` backend at wilson-16x16x16x16 with one source
   and with the 12-source propagator, counters set to 0 just before
   each; checks every column's residual and that every Dhat was two B1
   launches, with no B2 or B3 launch;
7b. drives the mixed-precision path, refined solves to tol 1e-10 with
   cgnr (``--inner-dtype``; ``REFINED``): ``auto`` with f32 and bf16
   inner solves at 16^4 with 1 and 12 sources, and ``cuda_fused_stream``
   with bf16 at 16^4 x 12, counters set to 0 just before each; checks
   every column's f64 Schur residual (<= 1e-10) and full-lattice
   residual in complex128 (<= 1e-9), and that every inner Dhat ran the
   kernel of its path at the inner dtype (counted with its dtype at
   ``ops.apply_dhat_planar_any``), or at a rung's dtype after a printed
   escalation;
7c. drives block CG on the propagator (``--method blockcg --nrhs 12``,
   ``auto``), counters set to 0 just before: every column's full-lattice
   residual, and every ``Dhat`` two B1 launches, 12 sources wide,
   counted exactly (the true-residual replacements every 50 iterations
   and the exit-time residual included); prints its iterations per
   column and steady time beside cgnr's on the same sources;
7d. drives low-mode deflation at 16^4 (``deflation``): the CLI with
   ``--deflate-rank 24 --deflate-iters 200 --n-solves 3`` on its hot
   gauge, every ``Dhat`` counted (the Lanczos steps and the solves on
   B2, the batched apply over the 200-vector basis on B1); the API on a
   weak gauge (``su3.weak_gauge``, eps 0.2, kappa 0.124), 16 sources
   undeflated, Lanczos-deflated and through a recycle stream, each solve
   within the residual gate, a Lanczos solve no slower than the
   undeflated one on the same source, every ``Dhat`` through B2 or B1;
   a ``BasisSnapshot`` round trip of the basis, bit-equal, whose restore
   solves in the same iterations;
7e. drives the resilience path at 16^4 (``resilience``, hot gauge, cgnr
   tol 1e-6, every ``Dhat`` counted): a flipped exponent bit caught by
   ``audit_gauge`` and repaired at bind (full, ``two_row`` and
   ``minimal`` links, each solved on B2 to a full-lattice residual
   <= 1e-5 against the repaired field, unless the repair put a link at
   the ``minimal`` codec's singular point, where that bind must refuse);
   a NaN column of a 12-source block under
   ``auto`` (B1) contained, the other 11 bit-equal to the clean block's;
   ``nan_operator`` on B2 tripping the guard mid-iteration;
   ``cuda_fused_stream`` (B3) broken by ``break_ops`` falling back to
   ``cuda_fused`` (every later ``Dhat`` two B1 launches), ``cuda_hop``
   broken falling back to ``torch_ref`` on the card (no launch), a
   broken solve with fallback off raising; the CLI with ``--validate
   repair --fallback``; prints the audit, repair and rebind times;
7f. drives the distributed operator at one rank (``distributed``): one
   ``Dhat`` of each overlap mode launches B1 exactly 2 (fused), 10
   (interior) or 8 + 2 (split, 2 periodic) times, fused bit-equal to
   ``cuda_hop``'s two-launch ``Dhat``, interior and split within 5e-5
   (bit equality printed), at ``DIST_POINTS``; then the CLI with
   ``--backend distributed --overlap MODE`` (cgnr, tol 1e-6) at those
   points, counters set to 0 just before: every hop's B1 launches by
   mode exactly, every column within the residual gate, in
   ``cuda_hop``'s iterations; then four gloo ranks spawned on the one
   card (``four_ranks``, a 2 x 2 grid at 16^4, faces staged through
   pinned host buffers): every mode with full and ``two_row`` links, 1
   and 12 sources (1 in split), the gathered ``Dhat`` within 5e-5 of
   ``cuda_hop``'s, a cgnr solve per mode within one iteration of one
   process's, and the fused ``Dhat``'s wall time beside its exchanges';
   then, on the same four ranks, block CG x 12 (interior), undeflated,
   Lanczos-deflated (rank 24, 100 steps) and recycle cgnr on the weak
   gauge (fused, 4 sources each) and refined f32 and bf16 solves to
   1e-10 with 1 and 12 sources (fused), each held to the same solve in
   one process on ``cuda_hop`` (iterations within one, two for
   Lanczos; outer passes equal) and to its residual gates, every B1
   launch counted exactly (halo mode, none periodic), each path's
   launches per solve and wall time printed beside the card's name and
   power limit; the Lanczos basis saved through ``checkpoint=`` (each
   rank its block of one global snapshot), restored by a rebind with no
   kernel launched and solving in the same iterations, and restored by
   one process on ``cuda_hop`` bit for bit against the gathered basis
   (within one iteration); a refined f32 solve stopped after two outer
   passes and resumed from its snapshot (the uninterrupted outer passes
   in all, the f64 gates); and a daemon serving the split lattice
   (every rank registers the hot gauge, rank 0 takes 16 single-source
   requests at once, the others follow): every request within one
   iteration of one process and the residual gate, one build per
   (spec, bucket) and B1's launches exact on every rank;
7g. drives the serving daemon at 16^4 (``serving``, hot gauge, cgnr tol
   1e-6, every ``Dhat`` counted and every kernel's launches checked
   exactly): the CLI ``repro_torch.launch.serve --selftest 16`` (HTTP on
   a loopback port, default policy, cgnr and bicgstab), which must print
   ``selftest PASS``; then the API with a pool of an ``auto`` and a
   ``cuda_fused_stream`` entry: three single sources coalesced into
   bucket 4 (two B1 launches per ``Dhat``), each within 1e-5 of the solo
   solve and within the residual gate, a lone request in bucket 1 (B2),
   a 12-column propagator on the stream entry (B3), and a NaN request
   contained with its batchmates bit-equal to the clean run; then times
   32 single-source requests submitted at once, submitted one at a time
   (each a served block of one), and solved one by one through a
   session;
7h. drives the language-model stack (``lm``, plain PyTorch, no kernel):
   all ten architectures at the CPU tests' size, f32 and bf16, a
   prefill, two decode steps and one train step on the card against
   the same run on the CPU; ``deepseek-7b`` at its published widths cut
   to 4 layers: 5 train steps (remat) at batch 8 x seq 512 (step ms,
   tokens/s, peak memory), a prefill of 8 x 1024 and 16 decode steps
   (prefill ms, decode tokens/s; the last step against a full forward);
   and ``python -m repro_torch.launch.train`` to 20 steps, uninterrupted
   and resumed at 10, ending on the same loss;
7i. checks the multi-device dry run against the card (``dryrun``): the
   dry run of the ``lm`` phase's full-width step (``deepseek-7b``, 4
   layers, 8 x 512, remat, AdamW) on a 1 x 1 mesh, its peak within
   ``DRYRUN_PEAK_TOL`` of that step's ``max_memory_allocated`` and its
   matmul flops equal to a ``FlopCounterMode`` count of the step; the
   dry run of ``wilson-16x16x16x16`` ``opt`` on a fake 2 x 2 group, its
   halo bytes and messages per ``Dhat`` equal to what the halo counter
   read on each of the ``four_ranks`` job's ranks for one fused
   ``Dhat``; the dry-run CLI (``--qcd-only --mesh both``) and
   ``examples/torch_multipod_dryrun.py`` (``deepseek-7b decode_32k`` on
   the 512-rank mesh, then the roofline, whose rows it prints), every
   cell ``ok`` or skipped for the reference's reason; and the trainer
   sharded over four gloo ranks on the one card (an ``elastic`` 1 x 4
   mesh and a 2 x 2 one, f32), its losses within ``SHARDED_TOL`` of one
   rank's, where gloo carries DTensor's collectives on CUDA tensors (a
   two-rank probe first; in torch 2.11 its functional all-gather crashes
   the rank, and the same check runs over NCCL on four cards through
   ``tools/four_gpus_nccl.py --sharded-train``);
8. times the unbatched solve against the batched pipeline with a block
   of one source at wilson-16x16x16x16 (the candidate removal of the
   unbatched solvers), and steady solves under each Dhat policy (two B1
   launches, B2, B3) at ``SOLVE_POINTS`` (16^4 with 1 and 12 sources,
   wilson-64x16x16x8 with one): the end-to-end side of the auto rule;
9. times each kernel at the main paths' shapes with CUDA events (median
   of 100 launches after a warm-up, device time) beside its bound, its
   wall time per call with host work, and its plain version's; then
   times B3 against B2 at the points that set the ``auto`` rule
   (``POLICY_POINTS``, from ``repro_torch.analysis.trace_checks``:
   wilson-16x16x16x16 with nrhs 1 and 12;
   wilson-64x16x16x8 and wilson-64x32x32x16 with nrhs 1, 2, 4 and 12,
   and with one source in f64 and f32 with each link form), and the
   two-launch B1 Dhat at wilson-64x32x32x16, where the odd intermediate
   (100 MB in f32) no longer fits the 50 MB L2; then B1 at ``B1_POINTS``
   (halo mode included) beside its bound; then the steady refined
   solves against a pure-f64 ``cuda_fused`` solve to the same 1e-10, and
   the bf16 kernels beside the f32 ones at ``BF16_POINTS`` with their
   bf16 bounds, and B1 at 16^4 with the Lanczos basis's 200 sources
   beside its bound and against its plain version; steady distributed
   solves per overlap mode beside ``cuda_hop`` at 16^4 x 1 and x 12,
   with one fused ``Dhat``'s device time beside its source extensions';
   and B1 on the slabs (``SLAB_POINTS``) beside its bound.  With
   ``--parent-log FILE`` (repeatable), the output of other runs in the same call (the parent
   commit's ``chip_smoke.py``; ``tools/time_tree.py`` on another tree)
   gives their times at each policy and B1 point beside this run's.

It exits non-zero at the first failed phase.  The line before the last
is a JSON object ``{"kernels": [...]}`` (with each kernel's launches on
the block CG, deflation, resilience, serving and gate paths, and B1's row the
16^4 x 200 timing, its launches by mode on the distributed path and on
the four-rank solver paths, and its slab times); the last line is
``{"ok": true, "device": {...}}``.  It imports nothing of JAX or of the
reference package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ATOL = {"f32": 5e-5, "f64": 1e-10}
# bf16 kernels against their plain versions: both round nearly equal f32
# values to bf16, so they lie at most one rounding step apart, 2^-7 of
# max|plain|.
BF16_RTOL = 2.0 ** -7
REAL = {"f32": "float32", "f64": "float64", "bf16": "bfloat16"}
KAPPA = 0.13
CHECK_SHAPES = {               # (T, Z, Y, X) full lattice
    "odd-3x5x3x6": (3, 5, 3, 6),
    # Ragged tiles of B2/B3: Y*Xh = 15 and Z = 5 are no multiples of them.
    "ragged-4x5x3x10": (4, 5, 3, 10),
    "wilson-16x16x16x16": (16, 16, 16, 16),
    "wilson-64x16x16x8": (16, 16, 16, 64),
}
# Where B1's halo mode meets its plain version: the per-real link copies
# (Xh = 3 and 5) and the 16-byte ones (16^4), each with every t0 + z0.
HALO_SHAPES = ("odd-3x5x3x6", "ragged-4x5x3x10", "wilson-16x16x16x16")
HALO_TZ = ((0, 0), (1, 0), (0, 1), (1, 1))
# Source counts at which B2 and B3 meet their plain versions: 1 (two
# threads per site in f64), 3 and 5 (uneven groups of threads), 4 and 12
# (the propagator's block).
FUSED_NRHS = (1, 3, 4, 5, 12)
# (lattice, solves, the Dhat kernel auto must launch there): the solve
# measured faster on B2 at 16^4 with one source (bound by host work), on
# two B1 launches at wilson-64x16x16x8 (PERF.md 6).
MAIN_LATTICES = (("wilson-16x16x16x16", 2, "dhat_planar_fused"),
                 ("wilson-64x16x16x8", 1, "hop_block_planar"))
# The multi-RHS path: one point-source propagator (4 spins x 3 colours),
# and the Dhat kernel auto must launch for it: two B1 launches measured
# faster than B2 and B3 for a block of sources (PERF.md 6).
PROPAGATOR = ("wilson-16x16x16x16", 12, 2)     # lattice, nrhs, solves
PROPAGATOR_AUTO_KERNEL = "hop_block_planar"
# (lattice, nrhs) where steady solves are timed under each Dhat policy.
SOLVE_POINTS = (("wilson-16x16x16x16", 1), ("wilson-16x16x16x16", 12),
                ("wilson-64x16x16x8", 1))
# Where the cuda_hop backend (every Dhat two B1 launches) is driven.
CUDA_HOP_LATTICE = "wilson-16x16x16x16"
# The largest lattice of the configs, where B2's scratch overflows the L2.
BIG_LATTICE = ("wilson-64x32x32x16", (32, 32, 32, 64))
# (lattice, nrhs, dtype, gc, halo) where B1 is timed beside its bound and
# the parent's B1: the main lattices, the propagator's block, the largest
# lattice with each link form and in f64, and halo mode (the parent has
# none: its periodic B1 at the same shape stands in).
B1_POINTS = (
    ("wilson-16x16x16x16", 1, "f32", 18, False),
    ("wilson-16x16x16x16", 12, "f32", 18, False),
    ("wilson-64x16x16x8", 1, "f32", 18, False),
    *[(BIG_LATTICE[0], 1, "f32", gc, False) for gc in (18, 12, 8)],
    (BIG_LATTICE[0], 1, "f64", 18, False),
    ("wilson-16x16x16x16", 1, "f32", 18, True),
)
# The mixed-precision path: refined cgnr solves to REFINED_TOL at
# REFINED_LATTICE, as (backend, inner dtype, inner tol, nrhs, the Dhat
# kernel the backend takes there).  Inner tols: the reference's default
# 1e-4 for f32, its bf16 test value 1e-3 for bf16.
REFINED_TOL = 1e-10
REFINED_LATTICE = "wilson-16x16x16x16"
REFINED = (("auto", "f32", 1e-4, 1, "dhat_planar_fused"),
           ("auto", "f32", 1e-4, 12, "hop_block_planar"),
           ("auto", "bf16", 1e-3, 1, "dhat_planar_fused"),
           ("auto", "bf16", 1e-3, 12, "hop_block_planar"),
           ("cuda_fused_stream", "bf16", 1e-3, 12,
            "dhat_planar_fused_stream"))
# Low-mode deflation at full width (16^4, f32, cuda_fused): rank and
# Lanczos steps (bench_deflation.py's 8^4 setting), the weak-field gauge
# (su3.weak_gauge, eps 0.2) at bench_deflation.py's kappa, where
# undeflated cgnr reaches 1e-6 well within max_iters (41-47 iterations
# on an H100, PERF.md section 6), and the length of each run's stream.
DEFLATION_LATTICE = "wilson-16x16x16x16"
DEFLATION_RANK, DEFLATION_ITERS = 24, 200
WEAK_EPS, WEAK_KAPPA, WEAK_SOLVES = 0.2, 0.124, 16
# The resilience phase: the hot gauge and sources of its runs (cgnr, tol
# 1e-6, f32), the seed of the flipped link (bitflip_gauge's top exponent
# bit) and the column a NaN poisons in the 12-source block.
RESILIENCE_LATTICE = "wilson-16x16x16x16"
RESILIENCE_SEED, BITFLIP_SEED, POISONED_COLUMN = 31, 5, 5
# (lattice, nrhs) where the bf16 kernels are timed beside the f32 ones.
BF16_POINTS = (("wilson-16x16x16x16", 1), ("wilson-16x16x16x16", 12),
               ("wilson-64x16x16x8", 1))
# The distributed phase: (lattice, nrhs) of the one-rank CLI runs, the
# overlap modes (split takes one source), B1's launches per hop in each
# mode as (halo, periodic), the four-rank job's grid and lattice (Tl = Zl
# = 8, every rank on the one card), and the thin slabs that the
# interior and split modes launch B1 on: output (T, Z, Y, X) of the t-row
# and z-column slabs of 16^4 under that grid and at one rank.
DIST_POINTS = (("wilson-16x16x16x16", 1), ("wilson-16x16x16x16", 12),
               ("wilson-64x16x16x8", 1))
DIST_MODES = ("fused", "interior", "split")
DIST_HOP_LAUNCHES = {"fused": (1, 0), "interior": (5, 0), "split": (4, 1)}
DIST_GRID, DIST_LATTICE = (2, 2), "wilson-16x16x16x16"
# The four-rank job's solver paths on that grid: block CG on the
# 12-source block in interior mode; undeflated, Lanczos-deflated
# (DEFLATION_RANK, DIST_LANCZOS_ITERS steps) and recycle cgnr on the weak
# gauge, DIST_WEAK_SOLVES sources each; refined solves to REFINED_TOL as
# (inner dtype, inner tol, nrhs); the overlap mode of each.  The Lanczos
# pass takes 100 steps, not DEFLATION_ITERS: every MGS coefficient is a
# group sum, a host round trip through gloo with four ranks on one card,
# so its cost grows with the square of the steps (PERF.md section 6, PR
# 21), and 100 steps still deflate to no more iterations than undeflated
# on each of the four sources (tools/lanczos_steps.py).
DIST_SOLVER_MODES = {"blockcg": "interior", "deflation": "fused",
                     "refined": "fused"}
DIST_WEAK_SOLVES, DIST_LANCZOS_ITERS = 4, 100
# The four-rank job's serving path: DIST_SERVED single-source requests
# at once (hot gauge, cgnr 1e-6, max block 4, DIST_SERVE_BUCKETS,
# fused); and the refined f32 x 1 solve stopped after DIST_RESUME_AT
# outer passes, then resumed from its snapshot.
DIST_SERVED, DIST_SERVE_BUCKETS, DIST_RESUME_AT = 16, (1, 2, 4), 2
DIST_REFINED = (("f32", 1e-4, 1), ("f32", 1e-4, 12), ("bf16", 1e-3, 1),
                ("bf16", 1e-3, 12))
SLAB_SHAPES = {"slab-1x8x16x16": (1, 8, 16, 16),
               "slab-8x1x16x16": (8, 1, 16, 16),
               "slab-1x16x16x16": (1, 16, 16, 16),
               "slab-16x1x16x16": (16, 1, 16, 16)}
SLAB_POINTS = tuple((name, nrhs, "f32", 18, True) for name in SLAB_SHAPES
                    for nrhs in (1, 12))
# The serving phase: its lattice (hot gauge, kappa 0.13, cuda_fused auto
# and cuda_fused_stream), the seed of its gauge and sources, and the
# requests of its timed runs (single sources, max block 4).
SERVING_LATTICE, SERVING_SEED, SERVING_TIMED = "wilson-16x16x16x16", 41, 32
# Published H100 SXM peaks (NVIDIA data sheet, dense, no tensor cores, at
# the full 700 W power limit): the bound of every kernel is taken at them.
# bf16 kernels compute in f32 registers, so their operations count at the
# f32 rate.
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12, "bf16": 67e12}
PEAK_BYTES_PER_S = 3.35e12


class PhaseError(RuntimeError):
    pass


def card_name():
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False)
    except OSError as exc:
        return f"nvidia-smi failed: {exc}"
    return smi.stdout.strip() or smi.stderr.strip()


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def undegraded(what, *sessions):
    """Every session of a timed run ran the backend it names: fallback
    off, no walk taken (only the resilience phase arms fallback)."""
    for sess in sessions:
        st = sess.stats()
        check(not sess.matrix.fallback_enabled and not st["degraded"]
              and st["fallbacks"] == 0,
              f"{what}: timed on a session with fallback armed or "
              f"degraded: {sess.matrix!r}, stats {st}")


def fields(shape, dtype, device, seed):
    """Planar gauge halves for gc 18/12/8 and a source spinor generator,
    from a seeded CPU generator (the same field on every run)."""
    import torch

    from repro_torch.core import evenodd, su3
    from repro_torch.kernels import layout
    gen = torch.Generator().manual_seed(seed)
    U = su3.random_gauge(gen, shape, dtype=torch.complex64, device=device)
    U_e, U_o = evenodd.pack_gauge(U)
    real = getattr(torch, REAL[dtype])
    u_e = layout.gauge_to_planar(U_e, real)
    u_o = layout.gauge_to_planar(U_o, real)
    gauges = {gc: (layout.gauge_compress_planar(u_e, mode),
                   layout.gauge_compress_planar(u_o, mode))
              for mode, gc in layout.GAUGE_COMPRESSIONS.items()}

    def spinor(nrhs):
        T, Z, Y, X = shape
        lead = (nrhs,) if nrhs > 1 else ()
        draw = torch.float32 if real == torch.bfloat16 else real
        return torch.randn(lead + (T, Z, 24, Y, X // 2), generator=gen,
                           dtype=draw).to(device=device, dtype=real)
    return gauges, spinor


def ptxas_summary(log):
    """One line per kernel instantiation from ``nvcc -Xptxas -v``:
    (kernel<type, gc, D[, halo]>, registers, spill store bytes, static
    shared memory; the kernels take their tile's shared memory
    dynamically, printed per shape by the timing phase)."""
    names = {"f": "float", "d": "double", "13__nv_bfloat16": "bf16"}
    out, current, spill, smem = [], None, "0", "0"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(hop_kernel|"
                      r"dhat_fused_kernel|dhat_stream_kernel)"
                      r"I([fd]|13__nv_bfloat16)Li(\d+)"
                      r"ELi(\d+)E(?:Lb([01])E)?", line)
        if m:
            current = (f"{m.group(1)}<{names[m.group(2)]}, gc={m.group(3)},"
                       f" D={m.group(4)}"
                       + (f", halo={m.group(5)}" if m.group(5) else "")
                       + ">")
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            sm = re.search(r"(\d+) bytes smem", line)
            smem = sm.group(1) if sm else "0"
            out.append(f"{current}: {m.group(1)} registers, {spill} B "
                       f"spill stores, {smem} B static smem")
            current, spill = None, "0"
    return out


def phase_build():
    """Build the kernels; fails if an f32 or bf16 full-link instantiation
    of any kernel (the forms the driven paths launch) spills."""
    from repro_torch.kernels import build
    t0 = time.time()
    result = build.build_all(verbose=True)
    seconds = time.time() - t0
    print(f"build: {seconds:.1f} s wall for {len(result)} libraries "
          f"(parallel nvcc, sm_90a)")
    for name, info in result.items():
        for line in ptxas_summary(info["log"]):
            print(f"  ptxas {line}")
            if (re.match(r"\w+_kernel<(float|bf16), gc=18,", line)
                    and " 0 B spill" not in line):
                raise PhaseError(f"f32/bf16 full-link kernel spills: "
                                 f"{line}")


def parent_times(paths):
    """``{point: {label: median us}}`` from other runs' output, such as
    the parent commit's ``chip_smoke.py`` and ``tools/time_tree.py`` on
    another tree: the policy points' lines (``time: ... Dhat ... device
    us in run order ...``, point ``(lattice, nrhs, dtype, gc)``) and B1's
    (``time: B1 ...``, and the older ``time: ... hop_block_planar:
    device ... us`` lines; point ``("B1", lattice, nrhs, dtype, gc,
    mode)``).  Readings of one label at one point from several lines
    pool into one median."""
    dhat = re.compile(r"time: (\S+) (f32|f64) gc=(\d+) nrhs=(\d+) Dhat .*?"
                      r"device us in run order (.*?); bound")
    hop = re.compile(r"time: B1 (\S+) (f32|f64) gc=(\d+) nrhs=(\d+) "
                     r"(periodic|halo): .*?device us in run order (.*?); "
                     r"bound")
    old_hop = re.compile(r"time: (\S+) (f32|f64) gc=(\d+) nrhs=(\d+) "
                         r"hop_block_planar: device ([\d.]+) us")
    readings = {}
    for path in paths:
        for line in Path(path).read_text().splitlines():
            m = dhat.match(line)
            if m:
                key = (m.group(1), int(m.group(4)), m.group(2),
                       int(m.group(3)))
                items = m.group(5)
            elif hop.match(line):
                m = hop.match(line)
                key = ("B1", m.group(1), int(m.group(4)), m.group(2),
                       int(m.group(3)), m.group(5))
                items = m.group(6)
            elif old_hop.match(line):
                m = old_hop.match(line)
                key = ("B1", m.group(1), int(m.group(4)), m.group(2),
                       int(m.group(3)), "periodic")
                items = f"B1 {m.group(5)}"
            else:
                continue
            point = readings.setdefault(key, {})
            for item in items.split(", "):
                label, us = item.rsplit(" ", 1)
                point.setdefault(label, []).append(float(us))
    check(readings, f"--parent-log {paths}: no timing lines")
    return {key: {k: statistics.median(v) for k, v in point.items()}
            for key, point in readings.items()}


def compare_line(what, old, new):
    """``parent vs new`` for one point: each label of ``old`` (``B1``,
    ``B3``, ``B3@tree``) against this run's kernel of the same name."""
    parts = []
    for label, us in sorted(old.items()):
        kernel = label.split("@")[0]
        if kernel in new:
            parts.append(f"{label} {us:.1f} -> {new[kernel]:.1f} us "
                         f"({new[kernel] / us:.2f}x)")
    print(f"parent vs new: {what}: "
          + (", ".join(parts) or "no parent reading"), flush=True)


def wrap_extend(a, t_axis):
    """``a`` extended by one row and one plane on either side in t (axis
    ``t_axis``) and z (the next axis) by periodic wrap: the halo an
    exchange between periodic neighbours would deliver."""
    import torch
    for ax in (t_axis, t_axis + 1):
        n = a.shape[ax]
        a = torch.cat([a.narrow(ax, n - 1, 1), a, a.narrow(ax, 0, 1)], ax)
    return a.contiguous()


def halo_fields(shape, dtype, device, seed):
    """Links and a spinor generator on the lattice extended by 2 in t and
    z (random halos, not a wrap), and a slicer of the centre."""
    T, Z, Y, X = shape
    gauges, spinor = fields((T + 2, Z + 2, Y, X), dtype, device, seed)

    def centre(a, t_axis):
        return a.narrow(t_axis, 1, T).narrow(t_axis + 1, 1, Z).contiguous()
    return gauges, spinor, centre


def phase_b1(device):
    """B1 against its plain version: periodic, then halo mode (random
    halos, four tz_offsets), where it must also equal periodic mode on
    wrap-extended arrays bit for bit; then the two-launch Dhat against
    B2, bit for bit, at every shape and FUSED_NRHS."""
    import torch

    from repro_torch.kernels import ops, ref, wilson_stencil as ws
    worst = {"f32": 0.0, "f64": 0.0}
    cases = 0

    def hold(got, want, dtype, what):
        nonlocal cases
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst[dtype] = max(worst[dtype], err)
        cases += 1
        check(err <= ATOL[dtype], f"B1 {what}: max abs err {err:.3e} > "
                                  f"{ATOL[dtype]:g}")

    for sname, shape in CHECK_SHAPES.items():
        for dtype in ("f32", "f64"):
            gauges, spinor = fields(shape, dtype, device, seed=11)
            for gc, (u_e, u_o) in gauges.items():
                for nrhs in (1, 4, 12):
                    src = spinor(nrhs)
                    psi0 = spinor(nrhs)
                    for parity in (0, 1):
                        u_out, u_in = (u_o, u_e) if parity else (u_e, u_o)
                        for axpy in (None, (-0.37, psi0)):
                            hold(ws.hop_block_planar(u_out, u_in, src,
                                                     parity, axpy=axpy),
                                 ref.hop_block_planar_ref(
                                     u_out, u_in, src, parity, axpy=axpy),
                                 dtype, f"{sname} {dtype} gc={gc} "
                                        f"nrhs={nrhs} parity={parity} "
                                        f"axpy={axpy is not None}")
            print(f"B1 vs plain: {sname} {dtype}: ok "
                  f"(worst so far {worst[dtype]:.3e}, atol "
                  f"{ATOL[dtype]:g})", flush=True)
    for sname in HALO_SHAPES + tuple(SLAB_SHAPES):
        shape = lattice_shape(sname)
        for dtype in ("f32", "f64"):
            gauges, spinor, centre = halo_fields(shape, dtype, device,
                                                 seed=17)
            pgauges, pspinor = fields(shape, dtype, device, seed=18)
            for gc, (u_e, u_o) in gauges.items():
                pu_e, pu_o = pgauges[gc]
                for nrhs in (1, 4, 12):
                    lead = 1 if nrhs > 1 else 0
                    src = spinor(nrhs)
                    psi0 = centre(spinor(nrhs), lead)
                    psrc = pspinor(nrhs)
                    for i, tz in enumerate(HALO_TZ):
                        axpy = (-0.37, psi0) if i % 2 else None
                        for parity in (0, 1):
                            u_out, u_in = (u_o, u_e) if parity else \
                                (u_e, u_o)
                            u_out = centre(u_out, 1)
                            what = (f"halo {sname} {dtype} gc={gc} nrhs="
                                    f"{nrhs} parity={parity} tz={tz}")
                            hold(ws.hop_block_planar(
                                     u_out, u_in, src, parity, tz_offset=tz,
                                     halo=True, axpy=axpy),
                                 ref.hop_block_planar_ref(
                                     u_out, u_in, src, parity, tz_offset=tz,
                                     halo=True, axpy=axpy),
                                 dtype, what)
                            pu_out, pu_in = (pu_o, pu_e) if parity else \
                                (pu_e, pu_o)
                            periodic = ws.hop_block_planar(
                                pu_out, pu_in, psrc, parity, tz_offset=tz)
                            wrapped = ws.hop_block_planar(
                                pu_out, wrap_extend(pu_in, 1),
                                wrap_extend(psrc, lead), parity,
                                tz_offset=tz, halo=True)
                            check(torch.equal(periodic, wrapped),
                                  f"B1 {what}: periodic mode differs from "
                                  f"halo mode on wrap-extended arrays")
            print(f"B1 halo vs plain, and periodic vs wrap-extended halo "
                  f"bit for bit: {sname} {dtype}: ok (worst so far "
                  f"{worst[dtype]:.3e})", flush=True)
    pairs = 0
    for sname, shape in CHECK_SHAPES.items():
        for dtype in ("f32", "f64"):
            gauges, spinor = fields(shape, dtype, device, seed=19)
            for gc, (u_e, u_o) in gauges.items():
                for nrhs in FUSED_NRHS:
                    psi = spinor(nrhs)
                    two = ops.apply_dhat_planar(u_e, u_o, psi, KAPPA)
                    b2 = ws.dhat_planar_fused(u_e, u_o, psi, KAPPA)
                    torch.cuda.synchronize()
                    pairs += 1
                    check(torch.equal(two, b2),
                          f"two-launch B1 Dhat differs from B2 at {sname} "
                          f"{dtype} gc={gc} nrhs={nrhs}: max abs diff "
                          f"{float((two - b2).abs().max()):.3e}")
    print(f"B1 vs plain: {cases} cases (halo mode included), max abs err "
          f"f32 {worst['f32']:.3e} (atol 5e-5), f64 {worst['f64']:.3e} "
          f"(atol 1e-10); two-launch Dhat equals B2 bit for bit in {pairs}"
          f" cases", flush=True)
    return worst


def phase_b2(device):
    import torch

    from repro_torch.kernels import ref, wilson_stencil as ws
    worst = {"f32": 0.0, "f64": 0.0}
    cases = 0
    for sname, shape in CHECK_SHAPES.items():
        for dtype in ("f32", "f64"):
            gauges, spinor = fields(shape, dtype, device, seed=12)
            for gc, (u_e, u_o) in gauges.items():
                for nrhs in FUSED_NRHS:
                    psi = spinor(nrhs)
                    got = ws.dhat_planar_fused(u_e, u_o, psi, KAPPA)
                    want = ref.dhat_planar_ref(u_e, u_o, psi, KAPPA)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    worst[dtype] = max(worst[dtype], err)
                    cases += 1
                    check(err <= ATOL[dtype],
                          f"B2 {sname} {dtype} gc={gc} nrhs={nrhs}: max abs"
                          f" err vs plain {err:.3e} > {ATOL[dtype]:g}")
            print(f"B2 vs plain: {sname} {dtype}: ok (worst so far "
                  f"{worst[dtype]:.3e})", flush=True)
    print(f"B2: {cases} cases, max abs err f32 {worst['f32']:.3e}, "
          f"f64 {worst['f64']:.3e}")
    return worst


def phase_b3(device):
    import torch

    from repro_torch.kernels import ref, wilson_stencil as ws
    worst = {"f32": 0.0, "f64": 0.0}
    cases = 0
    for sname, shape in CHECK_SHAPES.items():
        for dtype in ("f32", "f64"):
            gauges, spinor = fields(shape, dtype, device, seed=15)
            for gc, (u_e, u_o) in gauges.items():
                for nrhs in FUSED_NRHS:
                    psi = spinor(nrhs)
                    for tz in ((0, 0), (1, 0)):
                        got = ws.dhat_planar_fused_stream(
                            u_e, u_o, psi, KAPPA, tz_offset=tz)
                        want = ref.dhat_planar_stream_ref(
                            u_e, u_o, psi, KAPPA, tz_offset=tz)
                        b2 = ws.dhat_planar_fused(u_e, u_o, psi, KAPPA,
                                                  tz_offset=tz)
                        torch.cuda.synchronize()
                        err = float((got - want).abs().max())
                        err2 = float((got - b2).abs().max())
                        worst[dtype] = max(worst[dtype], err, err2)
                        cases += 1
                        check(err <= ATOL[dtype] and torch.equal(got, b2),
                              f"B3 {sname} {dtype} gc={gc} nrhs={nrhs} "
                              f"tz_offset={tz}: max abs err vs plain "
                              f"{err:.3e} (atol {ATOL[dtype]:g}), vs B2 "
                              f"{err2:.3e} (must be bit for bit)")
            print(f"B3 vs plain and vs B2: {sname} {dtype}: ok, equal to "
                  f"B2 bit for bit (worst vs plain so far "
                  f"{worst[dtype]:.3e})", flush=True)
    # Other rings than the default's: the slots rotate differently and
    # the producers run ahead less far; the result must not change.
    gauges, spinor = fields(CHECK_SHAPES["wilson-16x16x16x16"], "f32",
                            device, seed=16)
    u_e, u_o = gauges[18]
    psi = spinor(4)
    want = ref.dhat_planar_stream_ref(u_e, u_o, psi, KAPPA)
    b2 = ws.dhat_planar_fused(u_e, u_o, psi, KAPPA)
    for window in (4, 5):
        got = ws.dhat_planar_fused_stream(u_e, u_o, psi, KAPPA,
                                          window=window)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst["f32"] = max(worst["f32"], err)
        cases += 1
        check(err <= ATOL["f32"] and torch.equal(got, b2),
              f"B3 window={window}: max abs err {err:.3e}, equal to B2: "
              f"{torch.equal(got, b2)}")
    print(f"B3: {cases} cases (windows 4 and 5 included), max abs err f32 "
          f"{worst['f32']:.3e} (atol 5e-5), f64 {worst['f64']:.3e} (atol "
          "1e-10)")
    return worst


def phase_bf16(device):
    """The bf16 kernels against their plain versions within BF16_RTOL of
    max|plain|: B1 periodic (both parities, axpy on/off, nrhs 1/4/12) on
    every check shape and in halo mode on the halo shapes with four
    tz_offsets; B2 and B3 at FUSED_NRHS, where the two-launch Dhat and B3
    must equal B2 bit for bit.  Returns ``{kernel: (max abs err, max
    err / max|plain|)}``."""
    import torch

    from repro_torch.kernels import ops, ref, wilson_stencil as ws
    worst = {k: [0.0, 0.0] for k in ("hop_block_planar", "dhat_planar_fused",
                                     "dhat_planar_fused_stream")}
    cases = [0]

    def hold(kernel, got, want, what):
        torch.cuda.synchronize()
        check(got.dtype == want.dtype == torch.bfloat16,
              f"bf16 {what}: dtype {got.dtype}")
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        worst[kernel][0] = max(worst[kernel][0], err)
        worst[kernel][1] = max(worst[kernel][1], err / scale)
        cases[0] += 1
        check(err <= BF16_RTOL * scale, f"bf16 {what}: max abs err "
                                        f"{err:.3e} > 2^-7 x {scale:.3e}")

    pairs = 0
    for sname, shape in CHECK_SHAPES.items():
        gauges, spinor = fields(shape, "bf16", device, seed=21)
        for gc, (u_e, u_o) in gauges.items():
            for nrhs in (1, 4, 12):
                src, psi0 = spinor(nrhs), spinor(nrhs)
                for parity in (0, 1):
                    u_out, u_in = (u_o, u_e) if parity else (u_e, u_o)
                    for axpy in (None, (-0.37, psi0)):
                        hold("hop_block_planar",
                             ws.hop_block_planar(u_out, u_in, src, parity,
                                                 axpy=axpy),
                             ref.hop_block_planar_ref(u_out, u_in, src,
                                                      parity, axpy=axpy),
                             f"B1 {sname} gc={gc} nrhs={nrhs} parity="
                             f"{parity} axpy={axpy is not None}")
            for nrhs in FUSED_NRHS:
                psi = spinor(nrhs)
                b2 = ws.dhat_planar_fused(u_e, u_o, psi, KAPPA)
                hold("dhat_planar_fused", b2,
                     ref.dhat_planar_ref(u_e, u_o, psi, KAPPA),
                     f"B2 {sname} gc={gc} nrhs={nrhs}")
                b3 = ws.dhat_planar_fused_stream(u_e, u_o, psi, KAPPA)
                hold("dhat_planar_fused_stream", b3,
                     ref.dhat_planar_stream_ref(u_e, u_o, psi, KAPPA),
                     f"B3 {sname} gc={gc} nrhs={nrhs}")
                two = ops.apply_dhat_planar(u_e, u_o, psi, KAPPA)
                torch.cuda.synchronize()
                pairs += 1
                check(torch.equal(two, b2) and torch.equal(b3, b2),
                      f"bf16 {sname} gc={gc} nrhs={nrhs}: two-launch Dhat "
                      f"equal to B2 {torch.equal(two, b2)}, B3 equal to B2 "
                      f"{torch.equal(b3, b2)} (both must be bit for bit)")
        print(f"bf16 B1, B2, B3 vs plain, two-launch and B3 equal to B2: "
              f"{sname}: ok (worst err / max|plain| so far "
              f"{max(w[1] for w in worst.values()):.3e}, limit 2^-7)",
              flush=True)
    for sname in HALO_SHAPES:
        gauges, spinor, centre = halo_fields(CHECK_SHAPES[sname], "bf16",
                                             device, seed=22)
        for gc, (u_e, u_o) in gauges.items():
            for nrhs in (1, 4, 12):
                src = spinor(nrhs)
                psi0 = centre(spinor(nrhs), 1 if nrhs > 1 else 0)
                for i, tz in enumerate(HALO_TZ):
                    axpy = (-0.37, psi0) if i % 2 else None
                    for parity in (0, 1):
                        u_out, u_in = (u_o, u_e) if parity else (u_e, u_o)
                        u_out = centre(u_out, 1)
                        hold("hop_block_planar",
                             ws.hop_block_planar(u_out, u_in, src, parity,
                                                 tz_offset=tz, halo=True,
                                                 axpy=axpy),
                             ref.hop_block_planar_ref(
                                 u_out, u_in, src, parity, tz_offset=tz,
                                 halo=True, axpy=axpy),
                             f"B1 halo {sname} gc={gc} nrhs={nrhs} "
                             f"parity={parity} tz={tz}")
    print(f"bf16: {cases[0]} cases against the plain versions (halo mode "
          f"included), worst " + ", ".join(
              f"{k} {a:.3e} abs / {r:.3e} of max|plain|"
              for k, (a, r) in worst.items())
          + f" (limit 2^-7 = {BF16_RTOL:.3e}); two-launch Dhat and B3 "
          f"equal to B2 bit for bit in {pairs} cases", flush=True)
    return worst


# The fused CG update (kernels/cg_update.py): the block the benchmark's
# propagator cell solves, (T, Z, Y, X) (16, 32, 32, 64) x 12 columns in
# f32, and a 16^4 x 12 block in f64.
CG_UPDATE_POINTS = (((16, 32, 32, 64), 12, "f32"),
                    ((16, 16, 16, 16), 12, "f64"))
HBM_BYTES_PER_S = 3.35e12


def phase_cg_update(device):
    """The fused CG update on the card: its ptxas lines; at
    ``CG_UPDATE_POINTS`` the update bit-equal to the plain op sequence
    (run on the card) given the same scalars, with frozen columns; the
    reductions within 1e-6 relative of a float64 sum and the same bits in
    three runs; then each launch's device time beside its bound (its
    passes over one block vector at 3.35 TB/s) and beside the inline ATen
    ops it replaced; then a 12-column cgnr at 16^4 on ``cuda_hop`` with
    the kernel and with its dispatch patched off, in iterations within
    one and residuals within 10 %.  Returns the f32 point's times."""
    import torch

    from repro_torch.analysis import trace_checks
    from repro_torch.core import evenodd, solver, su3
    from repro_torch.kernels import build, cg_update, counters

    log = build.build_all()["cg_update"]["log"]
    current, spill = None, "0"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(cg_[a-z]+_kernel)"
                      r"I([fd])(?:Li(\d+)E)?(?:Lb([01])E)?", line)
        if m:
            real = "float" if m.group(2) == "f" else "double"
            current = (f"{m.group(1)}<{real}"
                       + (f", W={m.group(3)}" if m.group(3) else "")
                       + (f", rr1={m.group(4)}" if m.group(4) else "") + ">")
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            print(f"  ptxas {current}: {m.group(1)} registers, {spill} B "
                  "spill stores", flush=True)
            check(spill == "0", f"cg_update kernel spills: {current}")
            current, spill = None, "0"

    def plain(x, r, p, ap, alpha, beta, accept):
        bb = cg_update._bb
        x1 = bb(alpha, p) * p + x
        r1 = bb(-alpha, ap) * ap + r
        p1 = bb(beta, p) * p + r1
        if accept is not None:
            x1 = torch.where(bb(accept, x1), x1, x)
            r1 = torch.where(bb(accept, r1), r1, r)
            p1 = torch.where(bb(accept, p1), p1, p)
        return x1, r1, p1

    out = {}
    for (T, Z, Y, X), n, dt in CG_UPDATE_POINTS:
        dtype = getattr(torch, REAL[dt])
        gen = torch.Generator(device=device).manual_seed(29)
        shape = (n, T, Z, 24, Y, X // 2)
        x, r, p, ap = (torch.randn(shape, generator=gen, dtype=dtype,
                                   device=device) for _ in range(4))
        alpha = torch.rand(n, generator=gen, dtype=dtype, device=device)
        beta = torch.rand(n, generator=gen, dtype=dtype, device=device)
        accept = torch.ones(n, dtype=torch.bool, device=device)
        accept[1::5] = False
        label = f"{T}x{Z}x{Y}x{X} x {n} {dt}"
        for acc in (accept, None):
            want = plain(x, r, p, ap, alpha, beta, acc)
            got = [t.clone() for t in (x, r, p)]
            cg_update.update_(*got, ap, alpha, beta, acc)
            torch.cuda.synchronize()
            check(all(torch.equal(g.view(torch.int32 if dt == "f32"
                                         else torch.int64),
                                  w.view(torch.int32 if dt == "f32"
                                         else torch.int64))
                      for g, w in zip(got, want)),
                  f"cg_update: update_ at {label} (accept "
                  f"{'given' if acc is not None else 'None'}) differs from "
                  "the plain op sequence")
            del want, got
        r1 = cg_update._bb(-alpha, ap) * ap + r
        refs = {"pap": (p.double() * ap.double()).reshape(n, -1).sum(1),
                "rr1": (r1.double() ** 2).reshape(n, -1).sum(1)}
        del r1
        calls = {"pap": lambda: cg_update.pap(p, ap),
                 "rr1": lambda: cg_update.rr1(r, ap, alpha)}
        for name, call in calls.items():
            first = call()
            rel = ((first.double() - refs[name]).abs()
                   / refs[name].abs()).max().item()
            same = all(torch.equal(call(), first) for _ in range(3))
            print(f"cg_update {name} at {label}: max rel err vs f64 "
                  f"{rel:.2e}, repeats bit for bit: {same}", flush=True)
            check(rel <= 1e-6 and same,
                  f"cg_update: {name} at {label} off the f64 sum or not "
                  "repeatable")
        if dt != "f32":
            continue
        vec_bytes = x.numel() * x.element_size()
        # Timed in place on every column: p += r each call, x and r kept.
        zero, one = torch.zeros_like(alpha), torch.ones_like(beta)
        every = torch.ones_like(accept)
        times = {
            "pap": (device_ms(calls["pap"], 20), 2),
            "rr1": (device_ms(calls["rr1"], 20), 2),
            "update": (device_ms(lambda: cg_update.update_(
                x, r, p, ap, zero, one, every), 20), 7),
        }
        inline = {
            "pap": device_ms(lambda: solver._bvdot(p, ap).real, 10),
            "rr1": device_ms(lambda: solver._bnorm2(
                solver._baxpy(-alpha, ap, r)), 10),
            "update": device_ms(lambda: plain(x, r, p, ap, alpha, beta,
                                              accept), 10),
        }
        card = card_name()
        # The inline update's row counts the r1 axpy that its rr1 row
        # counts too: of the 37 passes the three rows time, the parent
        # iteration ran 32.
        for name, (ms, passes) in times.items():
            bound = passes * vec_bytes / HBM_BYTES_PER_S * 1e3
            print(f"cg_update {name} at {label}: {ms * 1e3:.1f} us, bound "
                  f"{bound * 1e3:.1f} us ({passes} passes of "
                  f"{vec_bytes / 1e6:.0f} MB at 3.35 TB/s), "
                  f"{100 * bound / ms:.1f} % of bound; inline ATen ops "
                  f"{inline[name] * 1e3:.1f} us [{card}]", flush=True)
            out[name] = {"ms": ms, "bound_ms": bound,
                         "inline_ms": inline[name]}
        del x, r, p, ap
        torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(7)
    U_e, U_o = evenodd.pack_gauge(su3.weak_gauge(gen, (16, 16, 16, 16), 0.2,
                                                 device=device))
    e = torch.complex(torch.randn((12, 16, 16, 16, 8, 4, 3), generator=gen),
                      torch.randn((12, 16, 16, 16, 8, 4, 3), generator=gen))
    bops = trace_checks._bind("cuda_hop", U_e, U_o)
    rhs = bops.to_domain_batched(e.to(device))

    def solve():
        before = dict(counters.SOLVER)
        res = solver.cgnr_batched(
            lambda v: bops.apply_dhat_native_batched(v, 0.124),
            lambda v: bops.apply_dhat_dagger_native_batched(v, 0.124), rhs,
            tol=1e-6, max_iters=500)
        return res, counters.SOLVER["fused_updates"] - before["fused_updates"]

    res, fused = solve()
    real = solver._fuses
    solver._fuses = lambda b, project: False
    try:
        off, fused_off = solve()
    finally:
        solver._fuses = real
    print(f"cg_update cgnr 16^4 x 12: iterations {res.iterations.tolist()} "
          f"(fused updates {fused}) vs {off.iterations.tolist()} without "
          f"(fused updates {fused_off}); worst residual "
          f"{res.residual.max().item():.3e} vs "
          f"{off.residual.max().item():.3e}", flush=True)
    check(fused > 0 and fused_off == 0
          and bool(res.converged.all()) and bool(off.converged.all())
          and (res.iterations - off.iterations).abs().max().item() <= 1
          and torch.allclose(res.residual, off.residual, rtol=0.1, atol=0),
          "cg_update: the 12-column cgnr differs with and without the "
          "kernel")
    return out


def phase_gate(device):
    """The invariant gate's runtime checks on the card
    (``repro_torch.analysis.trace_checks``), through the three kernels in
    f32 and bf16: TJ1 (no dtype change or codec call inside a native
    solve of every backend, host reads per iteration within budget),
    TJ2 (kernel calls per Dhat by policy, link form and source count,
    per distributed hop by overlap mode), TJ4 (one build per session key
    and pool bucket) and TJ6 (every Krylov method stopped by a
    non-finite operator).  Any finding fails the phase, and so does a
    wrapper whose calls (the count the gate reads on the CPU) differ
    from its launches.  Prints each solve's host reads per iteration
    (each a device synchronisation here) and the phase's time beside the
    card's name and power limit; returns each kernel's launches over the
    phase."""
    import torch

    from repro_torch.analysis import trace_checks as tc
    from repro_torch.kernels import counters
    t0 = time.perf_counter()
    reads, calls, builds, guard = {}, {}, {}, {}
    findings = []
    launched = {}
    counters.reset_launch_counts()
    for name, fn, kw in (
            ("TJ1", tc.check_conversion_free, {"report": reads}),
            ("TJ2", tc.check_kernel_counts, {"report": calls}),
            ("TJ4", tc.check_build_budget,
             {"report": builds, "dtypes": tc.DTYPES}),
            ("TJ6", tc.check_nonfinite_guard,
             {"report": guard, "dtypes": tc.DTYPES})):
        before = dict(counters.LAUNCHES)
        findings += fn(str(ROOT), device=device, **kw)
        torch.cuda.synchronize()
        check(counters.CALLS == counters.LAUNCHES
              and counters.B1_MODE_CALLS == counters.B1_MODE_LAUNCHES,
              f"gate {name}: calls {counters.CALLS} (B1 "
              f"{counters.B1_MODE_CALLS}) are not the launches "
              f"{counters.LAUNCHES} ({counters.B1_MODE_LAUNCHES})")
        launched[name] = {k: v - before[k]
                          for k, v in counters.LAUNCHES.items()}
    seconds = time.perf_counter() - t0
    print("gate TJ1 host reads per iteration (budget "
          + ", ".join(f"{m}{' batched' if b else ''} {n}" for (m, b), n
                      in tc.READS_PER_ITERATION.items()) + "): "
          + "; ".join(f"{name} {dtype} {method}"
                      f"{' batched' if batched else ''} {n:g}"
                      for (name, dtype, method, batched), n
                      in reads.items()), flush=True)
    print(f"gate TJ2: {len(calls)} cases, every Dhat and hop with its "
          f"exact calls, each call one launch; TJ4: " + ", ".join(
              f"{what} {dtype} {got}"
              for (what, dtype), got in builds.items())
          + "; TJ6: applications "
          f"after the first non-finite one " + ", ".join(
              f"{m} {d}{' batched' if b else ''} {n}"
              for (m, d, b), n in guard.items()), flush=True)
    for f in findings:
        print(f"gate finding: {f.render()}", flush=True)
    check(not findings, f"gate: {len(findings)} finding(s)")
    print(f"gate: no finding, launches {dict(counters.LAUNCHES)} (by check "
          f"{launched}), {seconds:.1f} s on {card_name()}", flush=True)
    return {"launches": dict(counters.LAUNCHES), "seconds": seconds,
            "reads": reads}


class DhatCount:
    """Counts, while entered, the ``Dhat`` applications at the policy
    entry point (``ops.apply_dhat_planar_any``): in all, by the dtype of
    their vector, and by their source count (``widths``: 1 for an
    unbatched vector); and those of the distributed operator
    (``dist_dhats``, at the functions ``qcd.make_dhat_fn`` returns); the
    call and launch counters are set to 0 on entry and read on exit
    (``launches``, and B1's by mode, ``b1_modes``; ``calls``, the
    wrappers' calls, which the invariant gate counts on the CPU), after
    a synchronise where CUDA exists; there every call must have been one
    launch (a CPU rehearsal calls the plain versions and launches
    nothing)."""

    def __enter__(self):
        from repro_torch.distributed import qcd
        from repro_torch.kernels import ops, wilson_stencil as ws
        self.dhats, self.dtypes, self.widths = 0, {}, {}
        self.dist_dhats = 0
        self._entry = ops.apply_dhat_planar_any
        self._make_dhat = qcd.make_dhat_fn

        def counted_make(part, kappa):
            fn = self._make_dhat(part, kappa)

            def dhat(links, v):
                self.dist_dhats += 1
                return fn(links, v)
            return dhat
        qcd.make_dhat_fn = counted_make

        def counted(*args, **kwargs):
            v = args[2]
            self.dhats += 1
            name = str(v.dtype).replace("torch.", "")
            self.dtypes[name] = self.dtypes.get(name, 0) + 1
            width = int(v.shape[0]) if v.ndim == 6 else 1
            self.widths[width] = self.widths.get(width, 0) + 1
            return self._entry(*args, **kwargs)
        ops.apply_dhat_planar_any = counted
        ws.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        import torch

        from repro_torch.distributed import qcd
        from repro_torch.kernels import ops, wilson_stencil as ws
        ops.apply_dhat_planar_any = self._entry
        qcd.make_dhat_fn = self._make_dhat
        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        self.launches = dict(ws.LAUNCHES)
        self.b1_modes = dict(ws.B1_MODE_LAUNCHES)
        self.calls = dict(ws.CALLS)
        if exc[0] is None and cuda:
            check(self.calls == self.launches
                  and dict(ws.B1_MODE_CALLS) == self.b1_modes,
                  f"wrapper calls {self.calls} (B1 by mode "
                  f"{dict(ws.B1_MODE_CALLS)}) are not the launches "
                  f"{self.launches} ({self.b1_modes})")
        return False


def drive(argv, what, full_tol=1e-5):
    """``repro_torch.launch.solve.main(argv)`` with the launch counters
    set to 0 just before and read just after, and its ``Dhat``
    applications counted at the policy entry point
    (``ops.apply_dhat_planar_any``, :class:`DhatCount`), by the dtype and
    the source count of their vector; checks every column's full-lattice
    residual against ``full_tol``; the run's summary with ``launches``,
    ``dhats``, ``dhat_dtypes`` and ``dhat_widths`` added."""
    from repro_torch.launch import solve as launch_solve
    print(f"{what}: python -m repro_torch.launch.solve {' '.join(argv)}",
          flush=True)
    check("--fallback" not in argv, f"{what}: timed runs keep fallback off")
    with DhatCount() as count:
        out = launch_solve.main(argv)
    check(not out["stats"]["degraded"] and out["stats"]["fallbacks"] == 0,
          f"{what}: the run degraded: {out['stats']['fallback_events']}")
    print(f"{what}: {count.dhats} Dhat applications (by dtype "
          f"{count.dtypes}, by source count {count.widths}), launches "
          f"{count.launches}", flush=True)
    for i, rels in enumerate(out["col_residuals"]):
        check(max(rels) <= full_tol,
              f"{what} solve {i}: column full-lattice residuals {rels} "
              f"(each <= {full_tol:g})")
    return dict(out, launches=count.launches, dhats=count.dhats,
                dhat_dtypes=count.dtypes, dhat_widths=count.widths,
                dist_dhats=count.dist_dhats, b1_modes=count.b1_modes)


def check_path(what, run, kernel, n_solves):
    """Every ``Dhat`` of ``run`` went through ``kernel`` (two launches
    of B1, or one of B2 or B3), and nothing else launched but B1's two
    hops per solve (the right-hand side and the odd half)."""
    want = {"hop_block_planar": 2 * n_solves, "dhat_planar_fused": 0,
            "dhat_planar_fused_stream": 0}
    want[kernel] += (2 if kernel == "hop_block_planar" else 1) * run["dhats"]
    check(run["launches"] == want
          and run["dhats"] >= 2 * sum(run["iterations"]),
          f"{what}: launches {run['launches']} for {run['dhats']} Dhat "
          f"applications in {run['iterations']} cgnr iterations; expected "
          f"{want}, every Dhat through {kernel}")


def phase_slice():
    from repro_torch.launch import solve as launch_solve
    runs = {}
    for lattice, n_solves, kernel in MAIN_LATTICES:
        run = drive(["--lattice", lattice, "--method", "cgnr", "--tol",
                     "1e-6", "--backend", "auto", "--n-solves",
                     str(n_solves), "--seed", "1", "--device", "cuda"],
                    f"slice {lattice}")
        check(run["backend"] == "cuda_fused",
              f"auto resolved to {run['backend']!r}, not 'cuda_fused'")
        check_path(f"slice {lattice}", run, kernel, n_solves)
        runs[lattice] = run
    lattice = MAIN_LATTICES[0][0]
    ref_out = launch_solve.main(
        ["--lattice", lattice, "--method", "cgnr", "--tol", "1e-6",
         "--backend", "torch_ref", "--n-solves", "1", "--seed", "1",
         "--device", "cuda"])
    fused = runs[lattice]
    diff = float((fused["solutions"][0] - ref_out["solutions"][0])
                 .abs().max())
    print(f"slice: {lattice} cuda_fused iterations "
          f"{fused['iterations']} vs torch_ref {ref_out['iterations']}; "
          f"max |xi_cuda_fused - xi_torch_ref| = {diff:.3e}")
    check(ref_out["residuals"][0] <= 1e-5,
          f"torch_ref residual {ref_out['residuals'][0]:.3e} > 1e-5")
    return runs


def phase_slice2():
    lattice, nrhs, n_solves = PROPAGATOR
    runs = {}
    for backend, kernel in (("cuda_fused_stream", "dhat_planar_fused_stream"),
                            ("auto", PROPAGATOR_AUTO_KERNEL)):
        run = drive(["--lattice", lattice, "--nrhs", str(nrhs), "--method",
                     "cgnr", "--tol", "1e-6", "--backend", backend,
                     "--n-solves", str(n_solves), "--seed", "1",
                     "--device", "cuda"], f"slice2 {backend}")
        check(all(len(rels) == nrhs for rels in run["col_residuals"]),
              f"slice2 {backend}: {run['col_residuals']} (need {nrhs} "
              "columns)")
        check_path(f"slice2 {backend}", run, kernel, n_solves)
        runs[backend] = run
    stream, auto = runs["cuda_fused_stream"], runs["auto"]
    check(auto["backend"] == "cuda_fused",
          f"auto resolved to {auto['backend']!r}, not 'cuda_fused'")
    diff = max(float((a - b).abs().max()) for a, b in
               zip(stream["solutions"], auto["solutions"]))
    print(f"slice2: auto resolved to {auto['backend']}; iterations per "
          f"column cuda_fused_stream {stream['col_iterations']} vs auto "
          f"{auto['col_iterations']}; max |xi_stream - xi_auto| = "
          f"{diff:.3e}", flush=True)
    return runs


def phase_cuda_hop():
    """The ``cuda_hop`` backend, whose every ``Dhat`` is two B1 launches,
    at CUDA_HOP_LATTICE with one source and with the 12-source
    propagator (cgnr, tol 1e-6); checks every column's full-lattice
    residual and that B1 made all of the run's launches: two per
    ``Dhat`` and two per solve (the right-hand side and the odd
    half)."""
    runs = {}
    for nrhs in (1, PROPAGATOR[1]):
        run = drive(["--lattice", CUDA_HOP_LATTICE, "--nrhs", str(nrhs),
                     "--method", "cgnr", "--tol", "1e-6", "--backend",
                     "cuda_hop", "--n-solves", "1", "--seed", "1",
                     "--device", "cuda"], f"cuda_hop nrhs={nrhs}")
        check(run["backend"] == "cuda_hop",
              f"backend {run['backend']!r}, not 'cuda_hop'")
        check(len(run["col_residuals"][0]) == nrhs,
              f"cuda_hop nrhs={nrhs}: residuals {run['col_residuals']}")
        check_path(f"cuda_hop nrhs={nrhs}", run, "hop_block_planar", 1)
        runs[nrhs] = run
    return runs


def phase_refined():
    """The mixed-precision path: each of REFINED through the CLI
    (``--inner-dtype``, tol 1e-10, cgnr), counters set to 0 just before.
    Every column's f64 Schur residual must reach REFINED_TOL and its
    full-lattice residual (complex128) ten times that; every inner Dhat
    must run the path's kernel (one B2 or B3 launch, or two B1 launches;
    the outer operator and hops are complex128 PyTorch, no kernel) at the
    inner dtype, or at the dtype of a rung the outer loop escalated to,
    which is printed."""
    runs = {}
    for backend, dtype, inner_tol, nrhs, kernel in REFINED:
        what = f"refined {backend} {dtype} x{nrhs}"
        run = drive(["--lattice", REFINED_LATTICE, "--nrhs", str(nrhs),
                     "--method", "cgnr", "--tol", f"{REFINED_TOL:g}",
                     "--backend", backend, "--inner-dtype", dtype,
                     "--inner-tol", f"{inner_tol:g}", "--n-solves", "1",
                     "--seed", "1", "--device", "cuda"], what,
                    full_tol=10 * REFINED_TOL)
        (res,) = run["results"]
        rel = [float(r) for r in (res.residual if nrhs > 1
                                  else [res.residual])]
        check(max(rel) <= REFINED_TOL, f"{what}: f64 Schur residuals {rel} "
                                       f"(each <= {REFINED_TOL:g})")
        rungs = [dtype] + list(res.escalations)
        allowed = {REAL[r] for r in rungs}
        check(set(run["dhat_dtypes"]) <= allowed
              and run["dhat_dtypes"].get(REAL[dtype], 0) > 0,
              f"{what}: inner Dhats by dtype {run['dhat_dtypes']}, rungs "
              f"{rungs}")
        want = {"hop_block_planar": 0, "dhat_planar_fused": 0,
                "dhat_planar_fused_stream": 0}
        want[kernel] = (2 if kernel == "hop_block_planar" else 1) * \
            run["dhats"]
        check(run["launches"] == want,
              f"{what}: launches {run['launches']} for {run['dhats']} "
              f"Dhats; expected {want}, every Dhat through {kernel}")
        print(f"{what}: outer {res.outer_iterations}, f64_applies "
              f"{res.f64_applies}, inner iterations {res.inner_iterations}"
              f", escalations {list(res.escalations) or 'none'}; f64 Schur "
              f"residual max {max(rel):.2e}, full-lattice max "
              f"{max(run['col_residuals'][0]):.2e}; every inner Dhat "
              f"through {kernel} at {dtype}"
              + (f" or a rung's dtype ({rungs})" if res.escalations
                 else ""), flush=True)
        runs[(backend, dtype, nrhs)] = run
    return runs


def _steady(run):
    """The steady solve time (s) of a CLI run's one session key."""
    (row,) = run["stats"]["keys"].values()
    return row["steady_state_s"]


def phase_blockcg(cgnr_run):
    """Block CG on the propagator (PROPAGATOR: 12 sources, 2 solves)
    through the CLI with ``--backend auto``, counters set to 0 just
    before: every column's full-lattice residual, and exact accounting of
    every ``Dhat`` (two B1 launches each, 12 sources wide): per solve of
    K iterations, one for the normal right-hand side, two per iteration,
    two per true-residual replacement (every
    ``BLOCKCG_RECOMPUTE_DEFAULT`` iterations), two for the exit-time
    residual and one for the true-system residual, plus B1's two hops
    per solve.  Prints the iterations per column beside ``cgnr``'s on the
    same sources (``cgnr_run``, slice2's auto run) and both steady
    times."""
    from repro_torch.core import solver
    lattice, nrhs, n_solves = PROPAGATOR
    run = drive(["--lattice", lattice, "--nrhs", str(nrhs), "--method",
                 "blockcg", "--tol", "1e-6", "--backend", "auto",
                 "--n-solves", str(n_solves), "--seed", "1", "--device",
                 "cuda"], "blockcg")
    check(run["backend"] == "cuda_fused"
          and all(x.device.type == "cuda" for x in run["solutions"]),
          f"blockcg ran on {run['backend']!r}, not cuda_fused on the card")
    every = solver.BLOCKCG_RECOMPUTE_DEFAULT
    ks = [max(c) for c in run["col_iterations"]]
    want_dhats = sum(2 * k + 2 * (k // every) + 4 for k in ks)
    want = {"hop_block_planar": 2 * want_dhats + 2 * n_solves,
            "dhat_planar_fused": 0, "dhat_planar_fused_stream": 0}
    check(run["dhats"] == want_dhats
          and run["dhat_widths"] == {nrhs: want_dhats}
          and run["launches"] == want,
          f"blockcg: {run['dhats']} Dhats by width {run['dhat_widths']}, "
          f"launches {run['launches']}; expected {want_dhats} Dhats "
          f"{nrhs} wide for {ks} iterations, launches {want}")
    print(f"blockcg: {lattice} x {nrhs}, tol 1e-6, auto (two B1 launches "
          f"per Dhat, counted exactly); iterations per column "
          f"{run['col_iterations']} against cgnr's "
          f"{cgnr_run['col_iterations']} on the same sources; steady solve "
          f"blockcg "
          f"{_steady(run) * 1e3:.2f} ms, cgnr {_steady(cgnr_run) * 1e3:.2f}"
          f" ms; full-lattice residual max "
          f"{max(max(r) for r in run['col_residuals']):.2e}", flush=True)
    return run


def _full_residual(U, xe, xo, ee, eo, kappa):
    """``|eta - D_W xi| / |eta|`` with the full-lattice ``D_W``, which
    no backend shares."""
    import torch

    from repro_torch.core import evenodd, wilson
    eta = evenodd.unpack(ee, eo)
    xi = evenodd.unpack(xe, xo)
    return float(torch.linalg.vector_norm(
        eta - wilson.apply_wilson(U, xi, kappa))
        / torch.linalg.vector_norm(eta))


def phase_deflation(device):
    """Low-mode deflation at DEFLATION_LATTICE, f32, on the card.

    1. The CLI on its hot gauge with ``--deflate-rank 24 --deflate-iters
       200 --method cgnr --n-solves 3`` (``auto``), counters set to 0
       just before: the residual gates, and every ``Dhat`` through its
       kernel, counted exactly: the Lanczos basis's one batched normal
       apply (two ``Dhat``s, m = 200 sources, two B1 launches each), its
       m - 1 single applies and every solve's (one B2 launch each: a
       deflated cgnr solve of K iterations takes 2K + 5 ``Dhat``s).
    2. The API on a weak gauge (WEAK_EPS, WEAK_KAPPA), ``cuda_fused``,
       WEAK_SOLVES sources through three sessions: undeflated, Lanczos
       (rank 24, 200 steps) and a recycle stream; each solve's
       full-lattice residual at most 1e-5, every ``Dhat`` through B2 (or
       two B1 launches for the batched apply), a Lanczos solve no slower
       than the undeflated one on the same source; iterations, Ritz
       values kept, fill, build and steady times printed.  (The recycle
       stream's iterations are printed, not held: on these gauges both
       packages' recycle mode takes more iterations than an undeflated
       solve, PERF.md section 6.)
    3. A ``BasisSnapshot`` round trip of the Lanczos basis: bit-equal
       tensors, and a fresh bind restoring it solves in the same
       iterations.
    Returns the CLI run, the API run's counts and the batched width."""
    import shutil

    import torch

    from repro_torch import api
    from repro_torch.core import deflate
    from repro_torch.resilience import BasisSnapshot
    n_solves = 3
    run = drive(["--lattice", DEFLATION_LATTICE, "--deflate-rank",
                 str(DEFLATION_RANK), "--deflate-iters",
                 str(DEFLATION_ITERS), "--method", "cgnr", "--tol", "1e-6",
                 "--backend", "auto", "--n-solves", str(n_solves), "--seed",
                 "1", "--device", "cuda"], "deflation cli")
    check(run["backend"] == "cuda_fused"
          and all(x.device.type == "cuda" for x in run["solutions"]),
          f"deflation cli ran on {run['backend']!r}, not cuda_fused on the "
          "card")
    widths = dict(run["dhat_widths"])
    single = widths.pop(1, 0)
    m = DEFLATION_ITERS
    want_single = 2 * (m - 1) + sum(2 * k + 5 for k in run["iterations"])
    want = {"hop_block_planar": 2 * 2 + 2 * n_solves,
            "dhat_planar_fused": want_single, "dhat_planar_fused_stream": 0}
    check(widths == {m: 2} and single == want_single
          and run["launches"] == want,
          f"deflation cli: Dhats by width {run['dhat_widths']}, launches "
          f"{run['launches']}; expected 2 of width {m}, {want_single} "
          f"single for iterations {run['iterations']}, launches {want}")
    (row,) = run["stats"]["keys"].values()
    d = row["deflation"]
    print(f"deflation cli: hot gauge, iterations {run['iterations']}, "
          f"basis {d['mode']} {d['filled']}/{d['rank']} active "
          f"{d['active']}; every Dhat counted: B2 {single}, B1 for the "
          f"batched apply over {m} vectors", flush=True)

    shape = CHECK_SHAPES[DEFLATION_LATTICE]
    U, U_e, U_o, srcs = _weak_fields(shape, WEAK_SOLVES, device)
    matrix = api.WilsonMatrix.bind(U_e, U_o, WEAK_KAPPA,
                                   backend="cuda_fused")
    check(matrix.backend.name == "cuda_fused" and matrix.device.type
          == "cuda", f"weak gauge bound to {matrix!r}")
    base = dict(method="cgnr", tol=1e-6, max_iters=2000)
    specs = {"undeflated": api.SolveSpec(**base),
             "lanczos": api.SolveSpec(**base, deflate_rank=DEFLATION_RANK,
                                      deflate_iters=DEFLATION_ITERS),
             "recycle": api.SolveSpec(**base, deflate_rank=DEFLATION_RANK,
                                      deflate_mode="recycle")}
    out = {}
    with DhatCount() as count:
        for label, spec in specs.items():
            t0 = time.perf_counter()
            if spec.deflate_rank:
                matrix.ensure_deflation(spec.deflate_rank, spec.deflate_mode,
                                        lanczos_iters=spec.deflate_iters)
            torch.cuda.synchronize()
            build = time.perf_counter() - t0
            sess = api.SolveSession(matrix, spec)
            iters, rels, walls = [], [], []
            for ee, eo in srcs:
                t0 = time.perf_counter()
                xe, xo, res = sess.solve(ee, eo)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                rel = _full_residual(U, xe, xo, ee, eo, WEAK_KAPPA)
                check(res.converged and xe.device.type == "cuda"
                      and rel <= 1e-5,
                      f"weak gauge {label}: converged {res.converged}, "
                      f"full-lattice residual {rel:.2e}, solution on "
                      f"{xe.device} (must be the card)")
                iters.append(int(res.iterations))
                rels.append(rel)
            undegraded(f"weak gauge {label}", sess)
            (row,) = sess.stats()["keys"].values()
            out[label] = {"iterations": iters, "build_s": build,
                          "steady_s": row["steady_state_s"],
                          "wall_s": statistics.median(walls[1:]),
                          "max_rel": max(rels),
                          "deflation": row.get("deflation")}
            if spec.deflate_rank:
                state = matrix.ensure_deflation(
                    spec.deflate_rank, spec.deflate_mode,
                    lanczos_iters=spec.deflate_iters)
                b = state.basis
                out[label]["ritz"] = sorted(
                    b.gram.diagonal()[b.mask].real.tolist())
    widths = dict(count.widths)
    single = widths.pop(1, 0)
    total = WEAK_SOLVES * len(specs)
    want = {"hop_block_planar": 2 * 2 + 2 * total,
            "dhat_planar_fused": single, "dhat_planar_fused_stream": 0}
    check(list(widths.values()) == [2] and count.launches == want,
          f"weak gauge: Dhats by width {count.widths}, launches "
          f"{count.launches}; expected one batched normal apply (2 Dhats) "
          f"and launches {want}")
    (lanczos_m,) = widths
    for label, r in out.items():
        d = r["deflation"]
        print(f"deflation weak gauge: {DEFLATION_LATTICE} eps {WEAK_EPS} "
              f"kappa {WEAK_KAPPA} cuda_fused f32 cgnr tol 1e-6, {label}: "
              f"iterations {r['iterations']}; build "
              f"{r['build_s'] * 1e3:.1f} ms; steady solve "
              f"{r['steady_s'] * 1e3:.2f} ms (median of "
              f"{WEAK_SOLVES - 1} after the first; with the harvest "
              f"{r['wall_s'] * 1e3:.2f} ms); full-lattice residual max "
              f"{r['max_rel']:.2e}"
              + (f"; basis {d['filled']}/{d['rank']} filled, {d['active']}"
                 f" active, Ritz values kept "
                 + ", ".join(f"{v:.5f}" for v in r["ritz"])
                 if d else ""), flush=True)
    plain = out["undeflated"]["iterations"]
    lanczos = out["lanczos"]["iterations"]
    check(all(a <= b for a, b in zip(lanczos, plain)),
          f"Lanczos-deflated solves {lanczos} take more iterations than "
          f"undeflated ones {plain} on the same sources")
    recycle = out["recycle"]["iterations"]
    print(f"deflation weak gauge: per source, Lanczos minus undeflated "
          f"{[a - b for a, b in zip(lanczos, plain)]}, recycle minus "
          f"undeflated {[a - b for a, b in zip(recycle, plain)]}; the "
          f"batched Lanczos apply was {lanczos_m} sources wide; every Dhat "
          f"counted: B2 {single}, B1 {count.launches['hop_block_planar']}",
          flush=True)

    snapdir = ROOT / "build" / "chip_smoke_basis"
    shutil.rmtree(snapdir, ignore_errors=True)
    try:
        state = matrix.ensure_deflation(DEFLATION_RANK, "lanczos",
                                        lanczos_iters=DEFLATION_ITERS)
        t0 = time.perf_counter()
        BasisSnapshot(snapdir).save(state.basis.count(), state.basis)
        save_s = time.perf_counter() - t0
        template = deflate.empty_basis(DEFLATION_RANK,
                                       state.basis.vectors[0])
        restored = BasisSnapshot(snapdir).resume(template)
        check(restored is not None and all(
            torch.equal(a, b) for a, b in zip(restored, state.basis)),
              "BasisSnapshot round trip of the 16^4 basis is not bit-equal")
        fresh = api.WilsonMatrix.bind(U_e, U_o, WEAK_KAPPA,
                                      backend="cuda_fused")
        sess = api.SolveSession(fresh, dataclasses.replace(
            specs["lanczos"], deflate_checkpoint=str(snapdir)))
        _, _, res = sess.solve(*srcs[0])
        again = fresh.ensure_deflation(DEFLATION_RANK, "lanczos",
                                       checkpoint=str(snapdir),
                                       lanczos_iters=DEFLATION_ITERS)
        check(all(torch.equal(a, b) for a, b in zip(again.basis,
                                                     state.basis))
              and int(res.iterations) == lanczos[0],
              f"restored basis: solve took {res.iterations} iterations, "
              f"the built one {lanczos[0]}")
        nbytes = sum(t.numel() * t.element_size() for t in state.basis)
        print(f"deflation snapshot: {nbytes / 1e6:.1f} MB basis saved in "
              f"{save_s:.2f} s, restored bit-equal; a fresh bind restoring "
              f"it solves source 0 in {int(res.iterations)} iterations "
              f"(built: {lanczos[0]})", flush=True)
    finally:
        shutil.rmtree(snapdir, ignore_errors=True)
    return {"cli": run, "weak": out, "launches": count.launches,
            "m": lanczos_m}


def time_lanczos_b1(device, nrhs):
    """B1 at the Lanczos basis's batched apply: DEFLATION_LATTICE x
    ``nrhs`` sources, f32, full links, against its plain version (f32
    atol), device time (median of 20 CUDA-event readings) beside its
    bound (``hop_traffic_model``), and the plain version's wall time."""
    import torch

    from repro_torch.kernels import ref, wilson_stencil as ws
    T, Z, Y, X = CHECK_SHAPES[DEFLATION_LATTICE]
    gauges, spinor = fields((T, Z, Y, X), "f32", device, seed=15)
    u_e, u_o = gauges[18]
    psi = spinor(nrhs)
    err = float((ws.hop_block_planar(u_e, u_o, psi, 0)
                 - ref.hop_block_planar_ref(u_e, u_o, psi, 0)).abs().max())
    check(err <= ATOL["f32"], f"B1 at {DEFLATION_LATTICE} x {nrhs}: max "
                              f"abs err {err:.3e}")
    ms = device_ms(lambda: ws.hop_block_planar(u_e, u_o, psi, 0), 20)
    plain_ms = call_ms(lambda: ref.hop_block_planar_ref(u_e, u_o, psi, 0),
                       1, warmup=0)
    m = ws.hop_traffic_model(T, Z, Y, X // 2, nrhs=nrhs, itemsize=4)
    t_bytes = m["bytes_total"] / PEAK_BYTES_PER_S * 1e3
    t_ops = m["flops"] / PEAK_FLOPS["f32"] * 1e3
    bound = max(t_bytes, t_ops)
    row = {"lattice": DEFLATION_LATTICE, "nrhs": nrhs, "ms": ms,
           "bound_ms": bound, "plain_ms": plain_ms, "max_abs_err": err,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"time: B1 at the Lanczos batched apply, {DEFLATION_LATTICE} x "
          f"{nrhs} f32 gc=18: device {ms * 1e3:.1f} us, bound "
          f"{bound * 1e3:.1f} us ({row['bound_by']}, {m['bytes_total']} B "
          f"at 3.35 TB/s), {bound / ms:.0%} of bound; plain version "
          f"{plain_ms * 1e3:.1f} us per call; max abs err {err:.3e}",
          flush=True)
    del psi
    torch.cuda.empty_cache()
    return row


def _broken_at_fault(ops, seen):
    """``break_ops(ops)`` whose entry points first append the launch
    counts at the moment of the fault to ``seen``: what the failed
    attempt launched before its first ``Dhat`` raised."""
    from repro_torch.kernels import wilson_stencil as ws
    from repro_torch.resilience import break_ops
    bad = break_ops(ops)

    def at_fault(fn):
        def noted(v, kappa):
            seen.append(dict(ws.LAUNCHES))
            return fn(v, kappa)
        return noted
    return dataclasses.replace(bad, **{
        f: at_fault(getattr(bad, f)) for f in (
            "apply_dhat_native", "apply_dhat_dagger_native",
            "apply_dhat_native_batched", "apply_dhat_dagger_native_batched")})


def _timed_ms(fn, n=3):
    """``fn()`` once to warm up, then the median wall time (ms) of ``n``
    calls, each ended by a synchronise; returns (last result, ms)."""
    import torch
    out = fn()
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(walls)


def phase_resilience(device):
    """The resilience path at RESILIENCE_LATTICE (hot gauge, kappa 0.13,
    cgnr tol 1e-6, f32), every ``Dhat`` counted with :class:`DhatCount`:

    1. audit and repair: ``bitflip_gauge`` flips exponent bit 30 of one
       link; ``audit_gauge`` must report it; ``bind(validate="repair")``
       under ``auto`` with full, ``two_row`` and ``minimal`` links solves
       one source on B2, to a full-lattice residual <= 1e-5 against the
       repaired field; the ``minimal`` bind refuses with ``ValueError``
       instead exactly when the repaired field has a link at that
       codec's singular point (``minimal_singular_links``), and then
       launches nothing; ``validate="warn"`` emits one RuntimeWarning;
    2. containment: a 12-source block under ``auto`` (two B1 launches per
       ``Dhat``) with column POISONED_COLUMN poisoned by
       ``nan_spinor_column``: that column diverged, the other 11
       converged and bit-equal to the clean block's;
    3. mid-iteration guard: ``cuda_fused``'s native ``Dhat`` (B2) wrapped
       by ``nan_operator``: the solve returns diverged after 0 < k <
       max_iters iterations;
    4. fallback: ``cuda_fused_stream`` with ``fallback=True`` solves the
       block on B3, then with ``break_ops`` rebinds to ``cuda_fused``,
       where every ``Dhat`` after the fault is two B1 launches and B3
       makes none; ``cuda_hop`` broken reaches ``torch_ref``, which
       launches no kernel after the fault and answers on the card; with
       fallback off the broken solve raises ``InjectedFault`` and commits
       no solve;
    5. the CLI with ``--validate repair --fallback`` and its defaults.

    Returns the launches of every run, by kernel."""
    import contextlib
    import io
    import warnings

    import torch

    from repro_torch import api
    from repro_torch.core import evenodd, su3
    from repro_torch.launch import solve as launch_solve
    from repro_torch.resilience import (InjectedFault, audit_gauge,
                                        bitflip_gauge, break_ops,
                                        nan_operator, nan_spinor_column,
                                        repair_gauge)
    from repro_torch.resilience.validate import minimal_singular_links
    shape = CHECK_SHAPES[RESILIENCE_LATTICE]
    gen = torch.Generator().manual_seed(RESILIENCE_SEED)
    U = su3.random_gauge(gen, shape, device=device)
    U_e, U_o = evenodd.pack_gauge(U)
    one = _sources(shape, 1, device, gen, torch.complex64)
    block = _sources(shape, 12, device, gen, torch.complex64)
    spec = api.SolveSpec(method="cgnr", tol=1e-6)
    launches = {"hop_block_planar": 0, "dhat_planar_fused": 0,
                "dhat_planar_fused_stream": 0}

    def tally(count):
        for k, v in count.launches.items():
            launches[k] += v

    def want(b1=0, b2=0, b3=0):
        return {"hop_block_planar": b1, "dhat_planar_fused": b2,
                "dhat_planar_fused_stream": b3}

    def block_rels(Uf, xe, xo, ee, eo):
        return [_full_residual(Uf, *cols, KAPPA)
                for cols in zip(xe, xo, ee, eo)]

    # 1. Audit and repair.
    bad = bitflip_gauge(U_e, seed=BITFLIP_SEED)
    flips = (bad.view(torch.float32).view(torch.int32)
             ^ U_e.contiguous().view(torch.float32).view(torch.int32))
    check(int((flips != 0).sum()) == 1
          and int(flips[flips != 0]) == 1 << 30,
          "bitflip_gauge did not flip exactly exponent bit 30 of one real")
    report, audit_ms = _timed_ms(lambda: audit_gauge(bad, U_o))
    check(not report.ok and report.max_defect > report.tolerance,
          f"the audit missed the flipped link: {report}")
    repaired, repair_ms = _timed_ms(lambda: repair_gauge(bad, U_o))
    check(repaired[2].repaired and repaired[2].ok,
          f"repair_gauge left {repaired[2]}")
    singular = minimal_singular_links(*repaired[:2])
    rels = {}
    for gc in ("none", "two_row", "minimal"):
        with DhatCount() as count:
            try:
                m = api.WilsonMatrix.bind(
                    bad, U_o, KAPPA, validate="repair",
                    backend=api.BackendSpec("auto", gauge_compression=gc))
            except ValueError as exc:
                refusal = exc
            else:
                refusal = None
                xe, xo, res = api.SolveSession(m, spec).solve(*one)
        tally(count)
        if refusal is not None:
            rels[gc] = f"refused ({refusal})"
            check(gc == "minimal" and singular and "two_row" in str(refusal)
                  and count.dhats == 0 and count.launches == want(),
                  f"repaired bind ({gc}) refused: {refusal}; {singular} "
                  f"links at the minimal codec's singular point, launches "
                  f"{count.launches}")
            continue
        R = torch.stack([evenodd.unpack(a, b) for a, b in
                         zip(*m.gauge_complex(torch.complex64))])
        rel = _full_residual(R, xe, xo, *one, KAPPA)
        rels[gc] = f"{rel:.2e}"
        check(m.backend.name == "cuda_fused" and m.gauge_audit.repaired
              and m.gauge_audit.ok and res.converged and rel <= 1e-5
              and not (gc == "minimal" and singular)
              and count.launches == want(2, count.dhats) and count.dhats,
              f"repaired bind ({gc}): {m!r}, audit {m.gauge_audit}, "
              f"converged {res.converged}, residual {rel:.2e}, "
              f"launches {count.launches} for {count.dhats} Dhats, "
              f"{singular} links at the minimal codec's singular point")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        api.WilsonMatrix.bind(bad, U_o, KAPPA, validate="warn")
    n_warn = sum(issubclass(w.category, RuntimeWarning) for w in caught)
    check(n_warn == 1, f"validate='warn' emitted {n_warn} RuntimeWarnings")
    print(f"resilience audit: {RESILIENCE_LATTICE} flipped bit 30 of one "
          f"real (seed {BITFLIP_SEED}): {report}; audit "
          f"{audit_ms:.2f} ms, repair {repair_ms:.2f} ms (median of 3, "
          f"both halves); repaired solves on B2, full-lattice residual "
          + ", ".join(f"{gc} {r}" for gc, r in rels.items())
          + f" ({singular} repaired links at the minimal codec's singular "
          "point); validate='warn' gave one RuntimeWarning", flush=True)

    # 2. Containment: one NaN in column POISONED_COLUMN of the block.
    sess = api.SolveSession(api.WilsonMatrix.bind(U_e, U_o, KAPPA), spec)
    with DhatCount() as count:
        xc, oc, clean, _ = sess.solve_block(*block)
        xb, ob, res, _ = sess.solve_block(
            nan_spinor_column(block[0], POISONED_COLUMN), block[1])
    tally(count)
    j = POISONED_COLUMN
    healthy = [i for i in range(12) if i != j]
    check(bool(res.diverged[j]) and not bool(res.converged[j]),
          f"poisoned column {j}: diverged {bool(res.diverged[j])}, "
          f"converged {bool(res.converged[j])}")
    check(all(bool(res.converged[i]) and torch.equal(xb[i], xc[i])
              and torch.equal(ob[i], oc[i]) for i in healthy),
          "a healthy column is not converged or not bit-equal to the "
          "clean block's: something mixes columns")
    check(count.launches == want(2 * count.dhats + 4),
          f"containment: launches {count.launches} for {count.dhats} "
          "Dhats; expected two B1 launches each and two hops per solve")
    print(f"resilience containment: 12-source block under auto, column "
          f"{j} poisoned: diverged after {int(res.iterations[j])} "
          f"iterations; the other 11 converged in "
          f"{[int(res.iterations[i]) for i in healthy]} iterations, "
          f"bit-equal to the clean block's; every Dhat two B1 launches",
          flush=True)

    # 3. The mid-iteration guard on B2.
    m = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="cuda_fused")
    m.ops = dataclasses.replace(
        m.ops, apply_dhat_native=nan_operator(m.ops.apply_dhat_native))
    with DhatCount() as count:
        _, _, res = api.SolveSession(m, spec).solve(*one)
    tally(count)
    check(res.diverged and not res.converged
          and 0 < res.iterations < spec.max_iters
          and count.launches == want(2, count.dhats) and count.dhats,
          f"nan_operator on B2: diverged {res.diverged}, converged "
          f"{res.converged}, iterations {res.iterations}, launches "
          f"{count.launches} for {count.dhats} Dhats")
    print(f"resilience guard: nan_operator on cuda_fused's Dhat (B2): "
          f"diverged after {res.iterations} iterations, returned without "
          f"raising", flush=True)

    # 4. Fallback: cuda_fused_stream -> cuda_fused on the block.
    m = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="cuda_fused_stream",
                              fallback=True)
    with DhatCount() as count:
        _, _, res = api.SolveSession(m, spec).solve(*block)
    tally(count)
    b3_healthy = count.launches["dhat_planar_fused_stream"]
    check(bool(res.converged.all())
          and count.launches == want(2, 0, count.dhats),
          f"healthy cuda_fused_stream: launches {count.launches} for "
          f"{count.dhats} Dhats")
    seen = []
    m.ops = _broken_at_fault(m.ops, seen)
    sess = api.SolveSession(m, spec)
    with DhatCount() as count:
        xe, xo, res = sess.solve(*block)
    tally(count)
    after = {k: v - seen[0][k] for k, v in count.launches.items()}
    st = sess.stats()
    rels = block_rels(U, xe, xo, *block)
    check(st["backend"] == "cuda_fused" and st["fallbacks"] == 1
          and st["degraded"] and sess.matrix.degraded
          and st["fallback_events"][0][0] == "cuda_fused_stream"
          and "InjectedFault" in st["fallback_events"][0][1]
          and xe.device == U.device and max(rels) <= 1e-5,
          f"cuda_fused_stream fallback: stats {st}, solution on "
          f"{xe.device}, residuals {rels}")
    check(seen[0] == want(1) and after == want(2 * count.dhats + 2),
          f"cuda_fused_stream fallback: launches {seen[0]} before the "
          f"fault, {after} after it for {count.dhats} Dhats; expected "
          f"{want(1)} (the right-hand side's hop), then two B1 launches "
          f"per Dhat and two hops")
    _, rebind_ms = _timed_ms(lambda: m.fallback_next("timing"))
    print(f"resilience fallback: cuda_fused_stream ({b3_healthy} B3 "
          f"launches healthy) broken -> cuda_fused: events "
          f"{st['fallback_events']}, degraded {st['degraded']}; after the "
          f"fault {after} for {count.dhats} Dhats, B3 none; residual max "
          f"{max(rels):.2e}; rebind to cuda_fused (bind with its layout "
          f"conversion) {rebind_ms:.2f} ms (median of 3)", flush=True)

    # cuda_hop -> torch_ref, one source: torch_ref computes on the card.
    m = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="cuda_hop",
                              fallback=True)
    seen = []
    m.ops = _broken_at_fault(m.ops, seen)
    sess = api.SolveSession(m, spec)
    with DhatCount() as count:
        xe, xo, res = sess.solve(*one)
    tally(count)
    after = {k: v - seen[0][k] for k, v in count.launches.items()}
    st = sess.stats()
    rel = _full_residual(U, xe, xo, *one, KAPPA)
    check(st["backend"] == "torch_ref" and st["fallbacks"] == 1
          and st["degraded"] and seen[0] == want(1) and after == want()
          and count.dhats == 0 and xe.device == U.device
          and res.converged and rel <= 1e-5,
          f"cuda_hop fallback: stats {st}, launches {seen[0]} before the "
          f"fault and {after} after, solution on {xe.device}, residual "
          f"{rel:.2e}")
    print(f"resilience fallback: cuda_hop broken -> torch_ref on "
          f"{xe.device}: no kernel launch after the fault, "
          f"{res.iterations} iterations, residual {rel:.2e}", flush=True)

    # Fallback off: the broken solve raises and commits nothing.
    m = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="cuda_fused_stream")
    m.ops = break_ops(m.ops)
    sess = api.SolveSession(m, spec)
    try:
        sess.solve(*block)
        raised = False
    except InjectedFault:
        raised = True
    check(raised and sess.stats()["solves"] == 0
          and sess.stats()["fallbacks"] == 0,
          f"fallback off: raised {raised}, stats {sess.stats()}")
    print("resilience fallback off: the broken solve raised InjectedFault, "
          "solves=0", flush=True)

    # 5. The CLI with its defaults.
    buf = io.StringIO()
    with DhatCount() as count, contextlib.redirect_stdout(buf):
        out = launch_solve.main(["--validate", "repair", "--fallback"])
    tally(count)
    text = buf.getvalue()
    print(text, end="", flush=True)
    check("gauge audit:" in text and "fallbacks=0 degraded=False" in text
          and out["backend"] == "cuda_fused" and out["residuals"][0] <= 1e-5
          and count.launches == want(2, count.dhats),
          f"CLI --validate repair --fallback: backend {out['backend']}, "
          f"residuals {out['residuals']}, launches {count.launches} for "
          f"{count.dhats} Dhats")
    print(f"resilience launches (every run of the phase): {launches}",
          flush=True)
    return {"launches": launches, "audit_ms": audit_ms,
            "repair_ms": repair_ms, "rebind_ms": rebind_ms}


def phase_block_of_one(device, shape=None, n_solves=6):
    """The unbatched solve against the batched pipeline given the same
    source as a block of one (``solve_block``), on one session at the
    main lattice (cuda_fused, cgnr, tol 1e-6), in alternating order:
    steady wall times (median after the first solve of each), iterations
    and the largest difference of the solutions.  Timing only; it
    measures whether the unbatched solvers can go."""
    import torch

    from repro_torch import api
    from repro_torch.core import evenodd, su3
    shape = CHECK_SHAPES[MAIN_LATTICES[0][0]] if shape is None else shape
    gen = torch.Generator().manual_seed(1)
    U = su3.random_gauge(gen, shape, device=device)
    matrix = api.WilsonMatrix.bind(*evenodd.pack_gauge(U), KAPPA,
                                   backend="cuda_fused")
    session = api.SolveSession(matrix,
                               api.SolveSpec(method="cgnr", tol=1e-6))
    eta = torch.complex(torch.randn(shape + (4, 3), generator=gen),
                        torch.randn(shape + (4, 3), generator=gen))
    ee, eo = evenodd.pack(eta.to(device))
    runs = {"unbatched": lambda: session.solve(ee, eo),
            "block of one": lambda: session.solve_block(ee, eo)}
    times = {k: [] for k in runs}
    out = {}
    for _ in range(n_solves):
        for label, fn in runs.items():
            t0 = time.perf_counter()
            out[label] = fn()
            if device.type == "cuda":
                torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
    undegraded("block of one", session)
    steady = {k: statistics.median(t[1:]) for k, t in times.items()}
    iters = {"unbatched": int(out["unbatched"][2].iterations),
             "block of one": int(out["block of one"][2].iterations[0])}
    diff = float((out["unbatched"][0] - out["block of one"][0][0])
                 .abs().max())
    print(f"block of one: {shape} cgnr tol 1e-6 cuda_fused, steady solve "
          f"unbatched {steady['unbatched'] * 1e3:.2f} ms, block of one "
          f"{steady['block of one'] * 1e3:.2f} ms ({n_solves} solves "
          f"each, alternating); iterations {iters}; max |xi_unbatched - "
          f"xi_block| = {diff:.3e}", flush=True)
    # The tolerance of the CPU tests' batched-against-unbatched solves.
    check(diff <= 1e-4 and
          abs(iters["unbatched"] - iters["block of one"]) <= 2,
          f"block of one disagrees with the unbatched solve: {diff:.3e}, "
          f"iterations {iters}")
    return steady


def phase_policy_solves(device, n_solves=6):
    """Steady cgnr solves (tol 1e-6) at ``SOLVE_POINTS`` under each
    ``Dhat`` policy: two B1 launches (``unfused``), B2 (``resident``)
    and B3 (``stream``), one session each, solves alternating; median
    wall time after the first solve of each, ending in a synchronise.
    These times, not the kernels' alone, set where ``auto`` takes B2.
    Returns ``{(lattice, nrhs): {policy: seconds}}``."""
    import torch

    from repro_torch import api
    from repro_torch.core import evenodd, su3
    from repro_torch.kernels import ops
    out = {}
    for lattice, nrhs in SOLVE_POINTS:
        shape = CHECK_SHAPES[lattice]
        gen = torch.Generator().manual_seed(1)
        U_e, U_o = evenodd.pack_gauge(su3.random_gauge(gen, shape,
                                                       device=device))
        ee, eo = _sources(shape, nrhs, device, gen, torch.complex64)
        sessions = {
            policy: api.SolveSession(
                api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend=api.BackendSpec(
                    "cuda_fused", opts=(("policy", policy),))),
                api.SolveSpec(method="cgnr", tol=1e-6, nrhs=nrhs))
            for policy in ("unfused", "resident", "stream")}
        times = {k: [] for k in sessions}
        iters = {}
        for _ in range(n_solves):
            for policy, session in sessions.items():
                t0 = time.perf_counter()
                _, _, res = session.solve(ee, eo)
                torch.cuda.synchronize()
                times[policy].append(time.perf_counter() - t0)
                iters[policy] = int(torch.as_tensor(res.iterations).max())
                check(bool(torch.as_tensor(res.converged).all()),
                      f"{lattice} x {nrhs} under {policy} did not converge")
        undegraded(f"solve {lattice} x {nrhs}", *sessions.values())
        steady = {k: statistics.median(t[1:]) for k, t in times.items()}
        auto = ops.auto_policy(_planar_shape(shape, nrhs))
        print(f"solve: {lattice} x {nrhs} source(s), cgnr tol 1e-6, steady "
              f"solve (median of {n_solves - 1} after the first) "
              + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in steady.items())
              + f"; auto takes {auto}; iterations {iters}", flush=True)
        out[(lattice, nrhs)] = steady
        del sessions
        torch.cuda.empty_cache()
    return out


def _dist_fields(shape, nrhs, device, seed=1):
    """Complex gauge halves and even-half planar sources (``nrhs`` of
    them, a leading axis above 1) of the distributed phase, from a seeded
    CPU generator: every rank of the four-rank job draws the same."""
    import torch

    from repro_torch.core import evenodd, su3
    from repro_torch.kernels import layout
    gen = torch.Generator().manual_seed(seed)
    U = su3.random_gauge(gen, shape)
    U_e, U_o = evenodd.pack_gauge(U)
    ee, eo = _sources(shape, nrhs, "cpu", gen, torch.complex64)
    return (U.to(device), U_e.to(device), U_o.to(device), ee.to(device),
            eo.to(device), layout.spinor_to_planar(ee).to(device))


def _dist_matrix(U_e, U_o, mode, group=None, grid=(1, 1), gc="none",
                 kappa=KAPPA, dtype=None):
    from repro_torch import api
    from repro_torch.distributed import qcd
    part = qcd.QCDPartition(group=group, t_ranks=grid[0], z_ranks=grid[1],
                            overlap=mode)
    return api.WilsonMatrix.bind(
        U_e, U_o, kappa, backend=api.BackendSpec(
            "distributed", gauge_compression=gc, dtype=dtype),
        partition=part)


def _weak_fields(shape, n, device):
    """The deflation phase's weak gauge (WEAK_EPS) and its first ``n``
    single sources, from its seeded CPU generator."""
    import torch

    from repro_torch.core import evenodd, su3
    gen = torch.Generator().manual_seed(7)
    U = su3.weak_gauge(gen, shape, eps=WEAK_EPS, device=device)
    U_e, U_o = evenodd.pack_gauge(U)
    srcs = [_sources(shape, 1, device, gen, torch.complex64)
            for _ in range(n)]
    return U, U_e, U_o, srcs


def phase_distributed(device):
    """The distributed operator at one rank, on the card.

    Per ``Dhat`` of each overlap mode, B1's launches by mode, exactly (2
    halo in fused, 10 halo in interior, 8 halo + 2 periodic in split);
    the fused ``Dhat`` bit-equal to ``cuda_hop``'s two-launch one, the
    other modes within 5e-5 of it (bit equality printed), at every
    ``DIST_POINTS``; then the CLI (``--backend distributed --overlap
    MODE``, cgnr tol 1e-6) at each point and mode, counters set to 0
    just before: every hop's B1 launches counted exactly (two hops per
    ``Dhat`` and two per solve), each solve within the residual gate and
    in ``cuda_hop``'s iterations on the same sources.  Returns the runs
    and the launches of B1 by mode over them."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import wilson_stencil as ws
    for lattice, nrhs in DIST_POINTS:
        shape = CHECK_SHAPES[lattice]
        _, U_e, U_o, _, _, psi = _dist_fields(shape, nrhs, device)
        hop = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="cuda_hop")
        want = hop.apply_native(psi)
        for mode in DIST_MODES:
            if mode == "split" and nrhs > 1:
                continue
            m = _dist_matrix(U_e, U_o, mode)
            m.apply_native(psi)                 # warm, bound
            torch.cuda.synchronize()
            ws.reset_launch_counts()
            got = m.apply_native(psi)
            torch.cuda.synchronize()
            halo_n, periodic_n = DIST_HOP_LAUNCHES[mode]
            check(ws.B1_MODE_LAUNCHES == {"halo": 2 * halo_n,
                                          "periodic": 2 * periodic_n}
                  and ws.LAUNCHES == {
                      "hop_block_planar": 2 * (halo_n + periodic_n),
                      "dhat_planar_fused": 0,
                      "dhat_planar_fused_stream": 0},
                  f"distributed {mode} {lattice} x {nrhs}: one Dhat "
                  f"launched {ws.LAUNCHES}, B1 by mode "
                  f"{ws.B1_MODE_LAUNCHES}")
            err = float((got - want).abs().max())
            equal = bool(torch.equal(got, want))
            check(equal if mode == "fused" else err <= ATOL["f32"],
                  f"distributed {mode} {lattice} x {nrhs}: Dhat differs "
                  f"from cuda_hop's by {err:.3e}"
                  + (" (must be bit-equal)" if mode == "fused" else ""))
            print(f"distributed: {lattice} x {nrhs} {mode}: one Dhat = "
                  f"B1 {dict(ws.B1_MODE_LAUNCHES)}; against cuda_hop's "
                  f"two-launch Dhat max abs diff {err:.3e}, bit-equal "
                  f"{equal}", flush=True)
            del m
        del hop
        torch.cuda.empty_cache()
    runs, totals = {}, {"halo": 0, "periodic": 0}
    for lattice, nrhs in DIST_POINTS:
        base = ["--lattice", lattice, "--nrhs", str(nrhs), "--method",
                "cgnr", "--tol", "1e-6", "--n-solves", "1", "--seed", "1",
                "--device", "cuda"]
        ref = drive(base + ["--backend", "cuda_hop"],
                    f"distributed {lattice} x {nrhs} cuda_hop")
        for mode in DIST_MODES:
            if mode == "split" and nrhs > 1:
                continue
            what = f"distributed {lattice} x {nrhs} {mode}"
            run = drive(base + ["--backend", "distributed", "--overlap",
                                mode], what)
            hops = 2 * run["dist_dhats"] + 2
            halo_n, periodic_n = DIST_HOP_LAUNCHES[mode]
            want = {"halo": hops * halo_n, "periodic": hops * periodic_n}
            check(run["backend"] == "distributed" and run["dhats"] == 0
                  and run["dist_dhats"] >= 2 * sum(run["iterations"])
                  and run["b1_modes"] == want
                  and run["launches"] == {
                      "hop_block_planar": sum(want.values()),
                      "dhat_planar_fused": 0,
                      "dhat_planar_fused_stream": 0},
                  f"{what}: {run['dist_dhats']} Dhats, launches "
                  f"{run['launches']}, B1 by mode {run['b1_modes']}; "
                  f"expected {want} for {hops} hops")
            check(run["col_iterations"] == ref["col_iterations"],
                  f"{what}: iterations {run['col_iterations']}, cuda_hop "
                  f"{ref['col_iterations']}")
            print(f"{what}: {run['dist_dhats']} Dhats, B1 {run['b1_modes']}"
                  f" (exact); iterations {run['col_iterations']} as "
                  f"cuda_hop; full-lattice residual max "
                  f"{max(max(r) for r in run['col_residuals']):.2e}",
                  flush=True)
            for k in totals:
                totals[k] += run["b1_modes"][k]
            runs[(lattice, nrhs, mode)] = run
    return {"runs": runs, "b1_modes": totals}


@contextlib.contextmanager
def _timed_calls(cls, name, walls):
    """While entered, every call of ``cls.name`` appends its wall
    seconds to ``walls``."""
    real = getattr(cls, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            walls.append(time.perf_counter() - t0)
    setattr(cls, name, timed)
    try:
        yield walls
    finally:
        setattr(cls, name, real)


def _ranks_in_step(device):
    """``(sync, in_step)``: a device synchronise, and a barrier then a
    synchronise that returns the host clock (the ranks in step)."""
    import torch
    import torch.distributed as dist

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def in_step():
        dist.barrier()
        sync()
        return time.perf_counter()
    return sync, in_step


def _dist_solver_paths(group, device, snapdir):
    """The split-lattice solver paths of the four-rank job, each through
    a ``SolveSession`` on the ``distributed`` backend (B1 in halo mode),
    its solves counted (:class:`DhatCount`: the distributed ``Dhat``s
    and B1's launches by mode) and timed on the host clock with the
    ranks in step: block CG on the 12-source block (interior), then on
    the weak gauge (fused) undeflated, the Lanczos build (saved through
    ``checkpoint=`` under ``snapdir``) and the deflated solves, a rebind
    restoring the basis and its deflated solve of the first source
    (``restored``), and a recycle stream, then the refined solves of
    DIST_REFINED (fused).  Rank 0 adds every column's full-lattice
    residual (complex128 for the refined solves).  Returns a row per
    path, and the basis snapshot's record: save and restore seconds,
    bytes per rank, the restore's launches, its bit equality with the
    built basis, and (rank 0) the gathered basis."""
    import torch
    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.resilience import BasisSnapshot
    shape = CHECK_SHAPES[DIST_LATTICE]
    rank0 = dist.get_rank() == 0
    sync, in_step = _ranks_in_step(device)

    def solve_all(label, sess, pairs, U, kappa):
        walls, results, rels = [], [], []
        with DhatCount() as count:
            for ee, eo in pairs:
                t0 = in_step()
                xe, xo, res = sess.solve(ee, eo)
                sync()
                walls.append(time.perf_counter() - t0)
                check(xe.device == xo.device == ee.device,
                      f"four ranks {label}: solution on {xe.device}")
                cols = (zip(ee, eo, xe, xo) if ee.ndim == 7
                        else [(ee, eo, xe, xo)])
                rels.append([_full_residual(U, x_e, x_o, e, o, kappa)
                             for e, o, x_e, x_o in cols] if rank0 else [])
                results.append(res)
        undegraded(f"four ranks {label}", sess)
        row = {"walls": walls, "rels": rels, "dhats": count.dist_dhats,
               "b1_modes": count.b1_modes, "launches": count.launches,
               "solves": len(pairs)}
        if results[0].__class__.__name__ == "RefinedResult":
            row.update(
                outer=[r.outer_iterations for r in results],
                schur=[torch.as_tensor(r.residual).reshape(-1).tolist()
                       for r in results],
                escalations=[list(r.escalations) for r in results],
                converged=[bool(torch.as_tensor(r.converged).all())
                           for r in results])
        else:
            row.update(
                iterations=[torch.as_tensor(r.iterations).reshape(-1)
                            .tolist() for r in results],
                converged=[bool(torch.as_tensor(r.converged).all())
                           for r in results])
        d = sess.stats()["keys"]
        row["deflation"] = next(iter(d.values())).get("deflation")
        return row

    out = {}
    U, U_e, U_o, ee, eo, _ = _dist_fields(shape, 12, device)
    m = _dist_matrix(U_e, U_o, DIST_SOLVER_MODES["blockcg"], group,
                     DIST_GRID)
    out["blockcg"] = solve_all(
        "blockcg", api.SolveSession(m, api.SolveSpec(method="blockcg",
                                                     tol=1e-6)),
        [(ee, eo)], U, KAPPA)
    del m

    Uw, Uw_e, Uw_o, srcs = _weak_fields(shape, DIST_WEAK_SOLVES, device)
    mw = _dist_matrix(Uw_e, Uw_o, DIST_SOLVER_MODES["deflation"], group,
                      DIST_GRID, kappa=WEAK_KAPPA)
    base = dict(method="cgnr", tol=1e-6, max_iters=2000)
    out["undeflated"] = solve_all("undeflated", api.SolveSession(
        mw, api.SolveSpec(**base)), srcs, Uw, WEAK_KAPPA)
    basis_dir = str(snapdir / "basis")
    saves = []
    with DhatCount() as count, _timed_calls(BasisSnapshot, "save", saves):
        t0 = in_step()
        built = mw.ensure_deflation(DEFLATION_RANK, "lanczos",
                                    checkpoint=basis_dir,
                                    lanczos_iters=DIST_LANCZOS_ITERS)
        sync()
        build = time.perf_counter() - t0
    out["lanczos_build"] = {"walls": [build], "dhats": count.dist_dhats,
                            "b1_modes": count.b1_modes,
                            "launches": count.launches, "solves": 0}
    lanczos = api.SolveSpec(**base, deflate_rank=DEFLATION_RANK,
                            deflate_iters=DIST_LANCZOS_ITERS)
    out["lanczos"] = solve_all("lanczos", api.SolveSession(mw, lanczos),
                               srcs, Uw, WEAK_KAPPA)
    # A rebind restores the basis: no kernel before its first solve.
    again = _dist_matrix(Uw_e, Uw_o, DIST_SOLVER_MODES["deflation"], group,
                         DIST_GRID, kappa=WEAK_KAPPA)
    with DhatCount() as count:
        t0 = in_step()
        restored = again.ensure_deflation(
            DEFLATION_RANK, "lanczos", checkpoint=basis_dir,
            lanczos_iters=DIST_LANCZOS_ITERS)
        sync()
        restore = time.perf_counter() - t0
    shard = mw.ops.shard
    snap = {"build_s": build, "save_s": saves, "restore_s": restore,
            "restore_launches": count.launches,
            "restore_dhats": count.dist_dhats,
            "equal": all(torch.equal(a, b)
                         for a, b in zip(restored.basis, built.basis)),
            "bytes_per_rank": sum(t.nbytes for t in built.basis),
            "filled": built.basis.count()}
    gathered = [shard.gather(v, 1) for v in built.basis[:2]]
    if rank0:
        snap["gathered"] = tuple(t.cpu() for t in
                                 gathered + list(built.basis[2:]))
    del gathered
    out["restored"] = solve_all("restored", api.SolveSession(
        again, dataclasses.replace(lanczos, deflate_checkpoint=basis_dir)),
        srcs[:1], Uw, WEAK_KAPPA)
    del again, restored
    out["recycle"] = solve_all("recycle", api.SolveSession(
        mw, api.SolveSpec(**base, deflate_rank=DEFLATION_RANK,
                          deflate_mode="recycle")), srcs, Uw, WEAK_KAPPA)
    del mw

    c128 = torch.complex128
    for dtype, inner_tol, nrhs in DIST_REFINED:
        U, U_e, U_o, ee, eo, _ = _dist_fields(shape, nrhs, device)
        m = _dist_matrix(U_e, U_o, DIST_SOLVER_MODES["refined"], group,
                         DIST_GRID, dtype=dtype)
        sess = api.SolveSession(m, api.SolveSpec(
            method="cgnr", tol=REFINED_TOL, inner_dtype=dtype,
            inner_tol=inner_tol))
        out[f"refined {dtype} x{nrhs}"] = solve_all(
            f"refined {dtype} x{nrhs}", sess, [(ee.to(c128), eo.to(c128))],
            U.to(c128), KAPPA)
        del m, sess
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out, snap


def _dist_refined_resume(device, snapdir):
    """The refined f32 x 1 solve of DIST_REFINED (fused) stopped after
    DIST_RESUME_AT outer passes with a ``RefinementSnapshot`` under
    ``snapdir``, then resumed from it, counted and timed (ranks in
    step); the snapshot's save and restore seconds and bytes per rank.
    Rank 0 adds the full-lattice residual in complex128."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import solver
    from repro_torch.resilience import RefinementSnapshot
    shape = CHECK_SHAPES[DIST_LATTICE]
    sync, in_step = _ranks_in_step(device)
    group = dist.group.WORLD
    c128 = torch.complex128
    U, U_e, U_o, ee, eo, _ = _dist_fields(shape, 1, device)
    m = _dist_matrix(U_e, U_o, DIST_SOLVER_MODES["refined"], group,
                     DIST_GRID, dtype="f32")
    U64 = m.gauge_complex()
    e64, o64 = ee.to(c128), eo.to(c128)
    snap = RefinementSnapshot(snapdir / "refined")

    def refined(**kw):
        return solver.make_refined_solve(
            m.ops, *U64, KAPPA, tol=REFINED_TOL, inner_tol=1e-4,
            snapshot=snap, **kw)
    saves, restores, walls = [], [], []
    with DhatCount() as count, \
            _timed_calls(RefinementSnapshot, "save", saves), \
            _timed_calls(RefinementSnapshot, "resume", restores):
        t0 = in_step()
        _, _, part = refined(max_outer=DIST_RESUME_AT)(e64, o64)
        sync()
        walls.append(time.perf_counter() - t0)
        t0 = in_step()
        xe, xo, res = refined()(e64, o64)
        sync()
        walls.append(time.perf_counter() - t0)
    Tl, Zl = m.ops.shard.extents
    return {"part_outer": part.outer_iterations,
            "part_converged": bool(part.converged),
            "outer": res.outer_iterations, "converged": bool(res.converged),
            "schur": float(res.residual), "escalations": res.escalations,
            "rel": (_full_residual(U.to(c128), xe, xo, e64, o64, KAPPA)
                    if dist.get_rank() == 0 else None),
            "walls": walls, "save_s": saves, "restore_s": restores,
            "bytes_per_rank": e64.nbytes * Tl * Zl // (shape[0] * shape[1]),
            "dhats": count.dist_dhats, "b1_modes": count.b1_modes,
            "launches": count.launches}


def _dist_serving(device):
    """The serving daemon on the split lattice: every rank binds the hot
    gauge on ``distributed`` (fused) and registers it warmed (cgnr 1e-6,
    DIST_SERVE_BUCKETS); rank 0 submits DIST_SERVED single sources at
    once (max block 4, linger 2 ms) and times them, the others follow.
    Every rank's launches and ``Dhat``s over the window are counted, and
    its daemon's batches and builds read.  Returns every rank's row (rank
    0's with each request's iterations, full-lattice residual and
    latency)."""
    import torch
    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.serving import BatchingPolicy, PropagatorDaemon
    shape = CHECK_SHAPES[DIST_LATTICE]
    group = dist.group.WORLD
    sync, in_step = _ranks_in_step(device)
    U, U_e, U_o, ee, eo, _ = _dist_fields(shape, DIST_SERVED, device)
    spec = api.SolveSpec(method="cgnr", tol=1e-6)
    daemon = PropagatorDaemon(batching=BatchingPolicy(
        max_block=4, linger_s=0.002, buckets=DIST_SERVE_BUCKETS),
        group=group)
    daemon.register("hot", _dist_matrix(U_e, U_o, "fused", group,
                                        DIST_GRID), warmup_spec=spec)
    row = {}
    with DhatCount() as count:
        t0 = in_step()
        if daemon.rank == 0:
            daemon.start()
            subs, done = [], {}
            for i in range(DIST_SERVED):
                ts = time.perf_counter()
                f = daemon.submit("hot", ee[i], eo[i], spec)
                f.add_done_callback(lambda _, i=i: done.__setitem__(
                    i, time.perf_counter()))
                subs.append((ts, f))
            results = [f.result(timeout=600) for _, f in subs]
            wall = time.perf_counter() - t0
            daemon.drain()
            row.update(
                wall_s=wall,
                latency_s=[done[i] - ts for i, (ts, _) in enumerate(subs)],
                iterations=[r.stats["iterations"][0] for r in results],
                converged=[r.converged for r in results],
                rels=[_full_residual(U, r.xi_e[0], r.xi_o[0], ee[i], eo[i],
                                     KAPPA)
                      for i, r in enumerate(results)])
        else:
            daemon.follow()
        sync()
    m = daemon.metrics()
    sess = m["pool"]["entries"]["hot"]["session"]
    row.update(batches=m["batches"], failed=m["failed"],
               mean_batch_columns=m["mean_batch_columns"],
               traces=sess["traces"], keys=len(sess["keys"]),
               dhats=count.dist_dhats, b1_modes=count.b1_modes,
               launches=count.launches)
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, row)
    return rows


def _dist_rank(rank, world, port, out_path, device_type="cuda",
               backend="gloo"):
    """One rank of the four-rank job (spawned): the gathered ``Dhat`` of
    every overlap mode with full and ``two_row`` links, one and 12
    sources (one in split); a cgnr solve per mode; the fused ``Dhat``'s
    wall time and its source exchange's; then the solver paths
    (:func:`_dist_solver_paths`).  Rank 0 saves the results to
    ``out_path``.  gloo puts every rank on card 0 (``device_type``
    ``"cpu"`` rehearses the job without a card); NCCL puts rank r on
    card r."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch import api
    from repro_torch.distributed import halo
    cuda = device_type == "cuda"
    index = rank if backend == "nccl" else 0
    if cuda:
        torch.cuda.set_device(index)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        device = torch.device(device_type, index if cuda else None)
        shape = CHECK_SHAPES[DIST_LATTICE]
        out = {"dhat": {}, "solve": {}, "times": {}}
        group = dist.group.WORLD
        grid = halo.TZGrid(group, *DIST_GRID)
        for nrhs in (1, 12):
            U, U_e, U_o, ee, eo, _ = _dist_fields(shape, nrhs, device)
            for gc in ("none", "two_row"):
                for mode in DIST_MODES:
                    if mode == "split" and nrhs > 1:
                        continue
                    m = _dist_matrix(U_e, U_o, mode, group, DIST_GRID, gc)
                    w = m.apply_native(m.encode(ee))
                    out["dhat"][nrhs, gc, mode] = halo.gather_tz(
                        grid, w, w.ndim - 5).cpu()
            if nrhs == 1:
                for mode in DIST_MODES:
                    m = _dist_matrix(U_e, U_o, mode, group, DIST_GRID)
                    sess = api.SolveSession(
                        m, api.SolveSpec(method="cgnr", tol=1e-6))
                    xe, xo, res = sess.solve(ee, eo)
                    out["solve"][mode] = (int(res.iterations),
                                          _full_residual(U, xe, xo, ee, eo,
                                                         KAPPA))
            # Wall time of the fused Dhat and of the exchanges of its
            # source (two extensions, t then z faces each), ranks in step.
            m = _dist_matrix(U_e, U_o, "fused", group, DIST_GRID)
            v = m.encode(ee)
            lead = v.ndim - 5

            def timed(fn, n=10):
                ts = []
                for _ in range(n + 2):
                    dist.barrier()
                    if cuda:
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    if cuda:
                        torch.cuda.synchronize()
                    ts.append(time.perf_counter() - t0)
                return statistics.median(ts[2:])
            out["times"][nrhs] = (
                timed(lambda: m.apply_native(v)),
                2 * timed(lambda: halo.extend_tz(v, grid, lead, lead + 1)))
            if nrhs == 1:
                # what this rank hands the group in one fused Dhat
                from repro_torch.kernels import counters
                counters.reset_halo_counts()
                m.apply_native(v)
                sent = [None] * world
                dist.all_gather_object(sent, dict(counters.HALO),
                                       group=group)
                out["halo_dhat"] = sent
        del m, v
        snapdir = Path(out_path).parent / "snapshots"
        out["solvers"], out["basis_snapshot"] = _dist_solver_paths(
            group, device, snapdir)
        out["refined_resume"] = _dist_refined_resume(device, snapdir)
        out["serving"] = _dist_serving(device)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def phase_four_ranks(device, backend="gloo"):
    """Four ranks (``torch.multiprocessing``, spawn), a 2 x 2 grid at
    ``DIST_LATTICE`` (Tl = Zl = 8): gloo on the one card (faces staged
    through pinned host buffers), or NCCL on four cards (device
    buffers; ``tools/four_gpus_nccl.py``).  Every gathered ``Dhat``
    within 5e-5 of the one-process ``cuda_hop`` ``Dhat`` on ``device``,
    each mode's cgnr solve within one iteration of the one-process count
    and within the residual gate; prints the fused ``Dhat``'s wall time
    and its source exchange's share beside ``halo_traffic_model``'s
    bytes; then holds the solver paths (:func:`_check_dist_solvers`) and
    the snapshot and serving paths (:func:`_check_dist_snapshots_serving`,
    while the ranks' snapshots are still on disk).  Returns rank 0's
    results, with B1's launches by mode over the solver paths
    (``b1_modes``) and over the serving window (``serving_b1_modes``)."""
    import shutil
    import socket

    import torch
    import torch.multiprocessing as mp

    from repro_torch import api
    from repro_torch.distributed import halo
    out_dir = ROOT / "build" / "chip_smoke_dist"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    world = DIST_GRID[0] * DIST_GRID[1]
    t0 = time.time()
    mp.start_processes(_dist_rank, args=(world, port,
                                         str(out_dir / "out.pt"), "cuda",
                                         backend),
                       nprocs=world, join=True, start_method="spawn")
    res = torch.load(out_dir / "out.pt", weights_only=False)
    cards = "one card" if backend == "gloo" else f"{world} cards"
    print(f"four ranks: {backend} job of {world} ranks on {cards}, "
          f"{time.time() - t0:.1f} s", flush=True)
    shape = CHECK_SHAPES[DIST_LATTICE]
    T, Z, Y, X = shape
    Tl, Zl = T // DIST_GRID[0], Z // DIST_GRID[1]
    worst = 0.0
    for nrhs in (1, 12):
        U, U_e, U_o, ee, eo, psi = _dist_fields(shape, nrhs, device)
        for gc in ("none", "two_row"):
            hop = api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend=api.
                                        BackendSpec("cuda_hop",
                                                    gauge_compression=gc))
            want = hop.apply_native(psi).cpu()
            for mode in DIST_MODES:
                if mode == "split" and nrhs > 1:
                    continue
                err = float((res["dhat"][nrhs, gc, mode] - want).abs().max())
                worst = max(worst, err)
                check(err <= ATOL["f32"],
                      f"four ranks {mode} {gc} x {nrhs}: gathered Dhat "
                      f"{err:.3e} off cuda_hop's")
        if nrhs == 1:
            sess = api.SolveSession(
                api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="cuda_hop"),
                api.SolveSpec(method="cgnr", tol=1e-6))
            single = int(sess.solve(ee, eo)[2].iterations)
            for mode, (iters, rel) in res["solve"].items():
                check(abs(iters - single) <= 1 and rel <= 1e-5,
                      f"four ranks {mode}: cgnr {iters} iterations (one "
                      f"process: {single}), full-lattice residual "
                      f"{rel:.2e}")
            print(f"four ranks: cgnr tol 1e-6 per mode (iterations, "
                  f"full-lattice residual) {res['solve']}; one process "
                  f"(cuda_hop) {single} iterations", flush=True)
        dhat_s, exch_s = res["times"][nrhs]
        model = halo.halo_traffic_model(Tl, Zl, Y, X // 2, nrhs=nrhs)
        print(f"four ranks: {DIST_LATTICE} x {nrhs} on a {DIST_GRID[0]} x "
              f"{DIST_GRID[1]} grid, fused Dhat {dhat_s * 1e3:.3f} ms wall "
              f"(median of 10, ranks in step), its source exchanges "
              f"(two extend_tz, {backend}) {exch_s * 1e3:.3f} ms = "
              f"{exch_s / dhat_s:.0%}; halo_traffic_model per rank: "
              f"{2 * model['bytes_spinor_exchange']} B of spinor faces per "
              f"Dhat (gauge hoisted to the bind: "
              f"{model['bytes_gauge_exchange']} B once), "
              f"bytes_dhat_exchange {model['bytes_dhat_exchange']} B",
              flush=True)
    print(f"four ranks: every gathered Dhat (3 modes x full/two_row, 1 and "
          f"12 sources) within {worst:.3e} of cuda_hop's (atol 5e-5)",
          flush=True)
    res["b1_modes"] = _check_dist_solvers(res["solvers"], device)
    res["serving_b1_modes"] = _check_dist_snapshots_serving(
        res, device, out_dir / "snapshots")
    shutil.rmtree(out_dir, ignore_errors=True)
    return res


def _one_process_solvers(device):
    """The four-rank solver paths' references in one process on
    ``cuda_hop`` (two B1 launches per ``Dhat``): block CG's iterations
    per column, the Lanczos-deflated solves' and the recycle stream's
    iterations, and each refined solve's outer passes."""
    import torch

    from repro_torch import api
    shape = CHECK_SHAPES[DIST_LATTICE]
    out = {}
    _, U_e, U_o, ee, eo, _ = _dist_fields(shape, 12, device)
    sess = api.SolveSession(
        api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="cuda_hop"),
        api.SolveSpec(method="blockcg", tol=1e-6))
    out["blockcg"] = [sess.solve(ee, eo)[2].iterations.tolist()]
    _, Uw_e, Uw_o, srcs = _weak_fields(shape, DIST_WEAK_SOLVES, device)
    mw = api.WilsonMatrix.bind(Uw_e, Uw_o, WEAK_KAPPA, backend="cuda_hop")
    base = dict(method="cgnr", tol=1e-6, max_iters=2000)
    for label, kw in (("lanczos", dict(deflate_rank=DEFLATION_RANK,
                                       deflate_iters=DIST_LANCZOS_ITERS)),
                      ("recycle", dict(deflate_rank=DEFLATION_RANK,
                                       deflate_mode="recycle"))):
        sess = api.SolveSession(mw, api.SolveSpec(**base, **kw))
        out[label] = [[int(sess.solve(e, o)[2].iterations)]
                      for e, o in srcs]
    for dtype, inner_tol, nrhs in DIST_REFINED:
        _, U_e, U_o, ee, eo, _ = _dist_fields(shape, nrhs, device)
        sess = api.SolveSession(
            api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend=api.BackendSpec(
                "cuda_hop", dtype=dtype)),
            api.SolveSpec(method="cgnr", tol=REFINED_TOL, inner_dtype=dtype,
                          inner_tol=inner_tol))
        out[f"refined {dtype} x{nrhs}"] = [sess.solve(
            ee.to(torch.complex128), eo.to(torch.complex128))[2]
            .outer_iterations]
    del sess, mw
    torch.cuda.empty_cache()
    return out


def _check_dist_solvers(rows, device):
    """Hold the four-rank solver paths (:func:`_dist_solver_paths`) to
    one process's (:func:`_one_process_solvers`) and their gates:

    * block CG x 12: every column within one iteration of one process's
      and its full-lattice residual <= 1e-5;
    * Lanczos-deflated cgnr: each solve no slower than the four-rank
      undeflated solve of its source and within two iterations of one
      process's deflated solve; the recycle stream within one, solve by
      solve; every full-lattice residual <= 1e-5;
    * refined f32 and bf16, 1 and 12 sources: every column's f64 Schur
      residual <= REFINED_TOL and full-lattice residual (complex128)
      <= 10 REFINED_TOL, no escalation, outer passes as one process's;
    * every path's B1 launches, exactly: in halo mode, (launches per hop
      of its overlap mode) x (2 per distributed ``Dhat`` + 2 per plain
      solve for its right-hand side and odd reconstruction; a refined
      solve's hops are the f64 oracle's), none periodic, no B2 or B3.

    Prints each path's launches per solve and wall time beside the
    card's name and power limit; returns B1's launches by mode over
    every path."""
    one = _one_process_solvers(device)
    card = card_name()
    totals = {"halo": 0, "periodic": 0}
    for label, row in rows.items():
        mode = DIST_SOLVER_MODES[label.split()[0] if label.startswith(
            ("blockcg", "refined")) else "deflation"]
        halo_n, periodic_n = DIST_HOP_LAUNCHES[mode]
        hops = 2 * row["dhats"] + (
            0 if label.startswith("refined") else 2 * row["solves"])
        want = {"halo": hops * halo_n, "periodic": hops * periodic_n}
        check(row["b1_modes"] == want and row["launches"] == {
                  "hop_block_planar": sum(want.values()),
                  "dhat_planar_fused": 0, "dhat_planar_fused_stream": 0},
              f"four ranks {label}: {row['dhats']} Dhats, launches "
              f"{row['launches']}, B1 by mode {row['b1_modes']}; expected "
              f"{want} for {hops} hops")
        for k in totals:
            totals[k] += row["b1_modes"][k]
        if label == "lanczos_build":
            print(f"four ranks: Lanczos build (rank {DEFLATION_RANK}, "
                  f"{DIST_LANCZOS_ITERS} steps over complex blocks) "
                  f"{row['walls'][0]:.3f} s, {row['dhats']} Dhats, B1 "
                  f"{row['b1_modes']} ({mode}); card {card}", flush=True)
            continue
        rels = [r for rs in row["rels"] for r in rs]
        gate = 10 * REFINED_TOL if label.startswith("refined") else 1e-5
        check(all(row["converged"]) and max(rels) <= gate,
              f"four ranks {label}: converged {row['converged']}, "
              f"full-lattice residuals {rels} (gate {gate:g})")
        if label.startswith("refined"):
            schur = [r for rs in row["schur"] for r in rs]
            check(max(schur) <= REFINED_TOL
                  and not any(row["escalations"])
                  and row["outer"] == one[label],
                  f"four ranks {label}: f64 Schur residuals {schur}, "
                  f"escalations {row['escalations']}, outer passes "
                  f"{row['outer']} (one process: {one[label]})")
            counts = f"outer {row['outer']} (one process {one[label]})"
        else:
            iters = row["iterations"]
            if label in one:
                slack = 2 if label == "lanczos" else 1
                check(all(abs(a - b) <= slack for s4, s1 in
                          zip(iters, one[label]) for a, b in zip(s4, s1)),
                      f"four ranks {label}: iterations {iters}, one "
                      f"process {one[label]} (within {slack})")
            if label == "lanczos":
                check(all(a <= b for (a,), (b,) in
                          zip(iters, rows["undeflated"]["iterations"])),
                      f"four ranks lanczos: iterations {iters} above the "
                      f"undeflated {rows['undeflated']['iterations']}")
            counts = f"iterations {iters}" + (
                f" (one process {one[label]})" if label in one else "")
        n = max(1, row["solves"])
        print(f"four ranks: {label} ({mode}) {counts}; full-lattice "
              f"residual max {max(rels):.2e}; per solve B1 halo "
              f"{row['b1_modes']['halo'] / n:g} periodic "
              f"{row['b1_modes']['periodic'] / n:g} ({row['dhats'] / n:g} "
              f"Dhats); wall per solve "
              + ", ".join(f"{w * 1e3:.1f}" for w in row["walls"])
              + f" ms (ranks in step); card {card}"
              + (f"; basis {row['deflation']}" if row.get("deflation")
                 else ""), flush=True)
    return totals


def _check_dist_snapshots_serving(res, device, snapdir):
    """Hold the four-rank job's snapshot and serving paths to their
    gates (the job's basis snapshot is still under ``snapdir``):

    * the basis: the rebind's restore launched no kernel and ran no
      ``Dhat`` on any rank, bit-equal to the built basis, and its
      deflated solve took the Lanczos solve's iterations on that source;
      one process on ``cuda_hop`` restores the directory bit for bit
      against the gathered basis, launching nothing, and solves within
      one iteration;
    * the refined f32 x 1 solve stopped after DIST_RESUME_AT outer
      passes and resumed: the uninterrupted solve's outer passes in all,
      f64 Schur residual <= REFINED_TOL, full-lattice residual
      (complex128) <= 10 REFINED_TOL, no escalation, B1 two halo
      launches per ``Dhat``;
    * serving: every request converged within the residual gate and one
      iteration of one process's ``cuda_hop`` solve of its source; on
      every rank, no failure, one build per (spec, bucket) and B1's
      launches exactly two halo per ``Dhat`` and two per batch.

    Prints the times beside the card's name and power limit; returns
    B1's launches by mode on rank 0 over the serving window."""
    import torch

    from repro_torch import api
    card = card_name()
    shape = CHECK_SHAPES[DIST_LATTICE]
    rows = res["solvers"]
    zero = {"hop_block_planar": 0, "dhat_planar_fused": 0,
            "dhat_planar_fused_stream": 0}

    # The deflation basis.
    snap = res["basis_snapshot"]
    built_iters = rows["lanczos"]["iterations"][0]
    check(snap["restore_launches"] == zero and snap["restore_dhats"] == 0
          and snap["equal"]
          and rows["restored"]["iterations"][0] == built_iters,
          f"four ranks basis restore: launches {snap['restore_launches']}, "
          f"{snap['restore_dhats']} Dhats, bit-equal {snap['equal']}, "
          f"iterations {rows['restored']['iterations']} (built basis: "
          f"{built_iters})")
    _, Uw_e, Uw_o, srcs = _weak_fields(shape, 1, device)
    one = api.WilsonMatrix.bind(Uw_e, Uw_o, WEAK_KAPPA, backend="cuda_hop")
    with DhatCount() as count:
        t0 = time.perf_counter()
        state = one.ensure_deflation(
            DEFLATION_RANK, "lanczos", checkpoint=str(snapdir / "basis"),
            lanczos_iters=DIST_LANCZOS_ITERS)
        torch.cuda.synchronize()
        one_restore = time.perf_counter() - t0
    check(count.launches == zero and all(
              torch.equal(a.cpu(), b)
              for a, b in zip(state.basis, snap["gathered"])),
          f"one process restoring the four-rank basis: launches "
          f"{count.launches}, not bit-equal to the gathered basis")
    one_iters = int(api.SolveSession(one, api.SolveSpec(
        method="cgnr", tol=1e-6, max_iters=2000,
        deflate_rank=DEFLATION_RANK, deflate_iters=DIST_LANCZOS_ITERS))
        .solve(*srcs[0])[2].iterations)
    check(abs(one_iters - rows["restored"]["iterations"][0][0]) <= 1,
          f"one process's deflated solve on the restored basis: "
          f"{one_iters} iterations (four ranks: "
          f"{rows['restored']['iterations'][0]})")
    del one, state
    mb = snap["bytes_per_rank"] / 1e6
    print(f"four ranks: basis snapshot (rank {DEFLATION_RANK}, "
          f"{snap['filled']} filled, {mb:.1f} MB per rank, "
          f"{4 * mb:.1f} MB in all): save "
          + ", ".join(f"{t:.3f}" for t in snap["save_s"])
          + f" s inside the {snap['build_s']:.3f} s Lanczos build, restore "
          f"by a rebind {snap['restore_s']:.3f} s (no launch; deflated "
          f"solve {rows['restored']['iterations'][0]} iterations, built "
          f"basis {built_iters}); one process on cuda_hop restores it in "
          f"{one_restore:.3f} s, bit-equal, {one_iters} iterations; card "
          f"{card}", flush=True)

    # The refinement snapshot.
    ref = res["refined_resume"]
    full = rows["refined f32 x1"]["outer"][0]
    want = {"halo": 2 * ref["dhats"], "periodic": 0}
    check(ref["part_outer"] == DIST_RESUME_AT and not ref["part_converged"]
          and ref["converged"] and ref["outer"] == full
          and not ref["escalations"] and ref["schur"] <= REFINED_TOL
          and ref["rel"] <= 10 * REFINED_TOL and ref["b1_modes"] == want
          and ref["launches"] == dict(zero, hop_block_planar=want["halo"]),
          f"four ranks refined resume: stopped at {ref['part_outer']} "
          f"(converged {ref['part_converged']}), resumed to "
          f"{ref['outer']} outer passes (uninterrupted {full}), "
          f"escalations {ref['escalations']}, Schur {ref['schur']:.2e}, "
          f"full-lattice {ref['rel']:.2e}, B1 {ref['b1_modes']} for "
          f"{ref['dhats']} Dhats")
    print(f"four ranks: refined f32 x1 stopped after {ref['part_outer']} "
          f"outer passes ({ref['walls'][0] * 1e3:.1f} ms) and resumed to "
          f"{ref['outer']} in all ({ref['walls'][1] * 1e3:.1f} ms; "
          f"uninterrupted {full}); Schur {ref['schur']:.2e}, full-lattice "
          f"{ref['rel']:.2e}; {ref['bytes_per_rank'] / 1e6:.2f} MB per "
          f"rank per snapshot, save "
          + ", ".join(f"{t * 1e3:.1f}" for t in ref["save_s"])
          + " ms, restore "
          + ", ".join(f"{t * 1e3:.1f}" for t in ref["restore_s"])
          + f" ms; card {card}", flush=True)

    # Serving.
    served = res["serving"]
    lead = served[0]
    U, U_e, U_o, ee, eo, _ = _dist_fields(shape, DIST_SERVED, device)
    sess = api.SolveSession(
        api.WilsonMatrix.bind(U_e, U_o, KAPPA, backend="cuda_hop"),
        api.SolveSpec(method="cgnr", tol=1e-6))
    single = [int(k) for k in sess.solve(ee, eo)[2].iterations]
    check(all(lead["converged"]) and max(lead["rels"]) <= 1e-5
          and all(abs(a - b) <= 1
                  for a, b in zip(lead["iterations"], single)),
          f"four ranks serving: converged {lead['converged']}, "
          f"full-lattice residuals max {max(lead['rels']):.2e}, "
          f"iterations {lead['iterations']} (one process {single})")
    for r, row in enumerate(served):
        halo = 2 * row["dhats"] + 2 * row["batches"]
        check(row["failed"] == 0 and row["batches"] == lead["batches"]
              and row["traces"] == row["keys"] == len(DIST_SERVE_BUCKETS)
              and row["b1_modes"] == {"halo": halo, "periodic": 0}
              and row["launches"] == dict(zero, hop_block_planar=halo),
              f"four ranks serving, rank {r}: failed {row['failed']}, "
              f"batches {row['batches']} (rank 0: {lead['batches']}), "
              f"builds {row['traces']} for {row['keys']} keys, B1 "
              f"{row['b1_modes']} for {row['dhats']} Dhats; launches "
              f"{row['launches']}")
    p50, p99 = _latency_ms(lead["latency_s"])
    print(f"four ranks: served {DIST_SERVED} single-source requests at "
          f"once ({DIST_LATTICE}, cgnr 1e-6, fused, max block 4): "
          f"{DIST_SERVED / lead['wall_s']:.2f} requests/s, latency p50 "
          f"{p50:.1f} ms p99 {p99:.1f} ms, {lead['batches']} batches of "
          f"{lead['mean_batch_columns']:.2f} columns; iterations "
          f"{lead['iterations']} (one process {single}); full-lattice "
          f"residual max {max(lead['rels']):.2e}; B1 halo launches per "
          f"batch by rank "
          + str([row["b1_modes"]["halo"] / row["batches"] for row in served])
          + f" ({[row['dhats'] for row in served]} Dhats); builds "
          f"{lead['traces']} for {lead['keys']} keys on every rank; card "
          f"{card}", flush=True)
    return lead["b1_modes"]


def _serving_want(count, stream, batches):
    """The launches a serving window must have made, from its counted
    ``Dhat`` applications: on a ``cuda_fused_stream`` entry one B3 launch
    each; on an ``auto`` entry at SERVING_LATTICE one B2 launch for a
    single source (a block of one included: its t-rows hold 2048 sites)
    and two B1 launches for a block; and B1's two hops (the right-hand
    side and the odd half) per session solve (``batches``)."""
    single = count.widths.get(1, 0)
    wide = count.dhats - single
    return {"hop_block_planar": 2 * batches + (0 if stream else 2 * wide),
            "dhat_planar_fused": 0 if stream else single,
            "dhat_planar_fused_stream": count.dhats if stream else 0}


def _latency_ms(stamps):
    """(p50, p99) of a list of seconds, in ms (p99 by the nearest rank)."""
    walls = sorted(stamps)
    p99 = walls[min(len(walls) - 1, int(0.99 * len(walls) + 0.5) - 1)]
    return statistics.median(walls) * 1e3, p99 * 1e3


def phase_serving(device):
    """The serving path at SERVING_LATTICE (hot gauge, kappa 0.13, cgnr
    tol 1e-6, f32, full links), every ``Dhat`` counted with
    :class:`DhatCount` and every kernel's launches checked exactly:

    a. the CLI, ``repro_torch.launch.serve.main`` with ``--selftest 16``
       and the default policy (max block 4, buckets 1, 2, 4; cgnr and
       bicgstab specs) through HTTP on a loopback port: it must print
       ``selftest PASS``;
    b. the API: a pool of an ``auto`` and a ``cuda_fused_stream`` entry
       under one daemon (max block 12, buckets 1, 2, 4, 12): three single
       sources coalesce into one batch (bucket 4, two B1 launches per
       ``Dhat``), each within 1e-5 of the entry's solo solve (B2) and
       within the full-lattice residual gate; a lone request (bucket 1,
       B2); a 12-column propagator request on the stream entry (B3); the
       three sources again with one poisoned by ``nan_spinor_column``:
       that request diverged, its batchmates bit-equal to the clean run;
    c. timing, recorded only: SERVING_TIMED single-source requests
       submitted at once to a warmed daemon (max block 4, linger 2 ms):
       requests/s, p50 and p99 latency; the same sources submitted one
       at a time (each a bucket-1 batch, a served block of one); and
       solved one by one through a session (unbatched).

    Returns the launches of (a) and (b) by kernel, and the timings."""
    import contextlib
    import io

    import torch

    from repro_torch import api
    from repro_torch.core import evenodd, su3
    from repro_torch.launch import serve as launch_serve
    from repro_torch.resilience import nan_spinor_column
    from repro_torch.serving import (BatchingPolicy, PropagatorDaemon,
                                     SessionPool)
    launches = {"hop_block_planar": 0, "dhat_planar_fused": 0,
                "dhat_planar_fused_stream": 0}

    def hold(what, count, stream, batches):
        want = _serving_want(count, stream, batches)
        check(count.launches == want and count.dhats > 0,
              f"serving {what}: launches {count.launches} for "
              f"{count.dhats} Dhat applications (by width "
              f"{count.widths}) in {batches} solves; expected {want}")
        for k, v in count.launches.items():
            launches[k] += v
        print(f"serving {what}: {count.dhats} Dhat applications (by width "
              f"{count.widths}) in {batches} solves, launches "
              f"{count.launches}", flush=True)

    # a. The CLI.
    argv = ["--lattice", SERVING_LATTICE, "--selftest", "16", "--port", "0"]
    print(f"serving: python -m repro_torch.launch.serve {' '.join(argv)}",
          flush=True)
    buf = io.StringIO()
    t0 = time.time()
    with DhatCount() as count, contextlib.redirect_stdout(buf):
        rc = launch_serve.main(argv)
    text = buf.getvalue()
    print(text.rstrip(), flush=True)
    check(rc == 0 and "selftest PASS" in text,
          f"serving CLI: exit {rc}, no 'selftest PASS'")
    summary = json.loads(text[text.index("{"):text.rindex("}") + 1])
    check(summary["selftest"]["backend"] == "cuda_fused",
          f"serving CLI: auto resolved to {summary['selftest']['backend']}")
    hold("CLI", count, False, summary["selftest"]["batches"])
    print(f"serving CLI: {time.time() - t0:.1f} s", flush=True)

    # b. The API.
    shape = CHECK_SHAPES[SERVING_LATTICE]
    gen = torch.Generator().manual_seed(SERVING_SEED)
    U = su3.random_gauge(gen, shape, device=device)
    U_e, U_o = evenodd.pack_gauge(U)
    singles = [_sources(shape, 1, device, gen, torch.complex64)
               for _ in range(4)]
    block = _sources(shape, 12, device, gen, torch.complex64)
    spec = api.SolveSpec(method="cgnr", tol=1e-6)
    pool = SessionPool()
    daemon = PropagatorDaemon(pool, BatchingPolicy(
        max_block=12, linger_s=0.2, buckets=(1, 2, 4, 12)))
    daemon.register("auto", api.WilsonMatrix.bind(U_e, U_o, KAPPA))
    daemon.register("stream", api.WilsonMatrix.bind(
        U_e, U_o, KAPPA, backend="cuda_fused_stream"))
    check(pool.entry("auto").matrix.backend.name == "cuda_fused",
          "serving: auto did not resolve to cuda_fused")

    def serve(name, sources):
        futs = [daemon.submit(name, e, o, spec) for e, o in sources]
        return [f.result(timeout=600) for f in futs]

    def solves():
        return sum(pool.entry(n).session.stats()["solves"]
                   for n in ("auto", "stream"))

    daemon.start()
    try:
        n0 = solves()
        with DhatCount() as count:
            clean = serve("auto", singles[:3])
        hold("API coalesced x3", count, False, solves() - n0)
        check(len({r.stats["batch_id"] for r in clean}) == 1
              and clean[0].stats["bucket"] == 4,
              f"serving: three requests did not coalesce into bucket 4: "
              f"{[r.stats for r in clean]}")
        n0 = solves()
        with DhatCount() as count:
            (lone,) = serve("auto", singles[3:])
        hold("API bucket 1", count, False, solves() - n0)
        check(lone.stats["bucket"] == 1, f"serving: lone request rode "
                                         f"bucket {lone.stats['bucket']}")
        n0 = solves()
        with DhatCount() as count:
            (prop,) = serve("stream", [block])
        hold("API propagator x12 (stream)", count, True, solves() - n0)
        poisoned = list(singles[:3])
        pe, po = poisoned[1]
        poisoned[1] = (nan_spinor_column(pe[None], 0)[0], po)
        n0 = solves()
        with DhatCount() as count:
            chaos = serve("auto", poisoned)
        hold("API NaN in a shared batch", count, False, solves() - n0)
    finally:
        daemon.drain()
    undegraded("serving", pool.entry("auto").session,
               pool.entry("stream").session)
    solo = api.SolveSession(pool.entry("auto").matrix)
    rels, diffs = [], []
    for r, (ee, eo) in zip(clean + [lone], singles):
        check(r.converged and not r.diverged,
              f"serving: request {r.stats}")
        xe, xo, _ = solo.solve(ee, eo, spec)
        diffs.append(max(float((r.xi_e[0] - xe).abs().max()),
                         float((r.xi_o[0] - xo).abs().max())))
        rels.append(_full_residual(U, r.xi_e[0], r.xi_o[0], ee, eo, KAPPA))
    check(max(diffs) <= 1e-5 and max(rels) <= 1e-5,
          f"serving: coalesced against solo {diffs} (each <= 1e-5), "
          f"full-lattice residuals {rels} (each <= 1e-5)")
    check(prop.converged and prop.stats["bucket"] == 12,
          f"serving propagator: {prop.stats}")
    prop_rels = [_full_residual(U, *cols, KAPPA)
                 for cols in zip(prop.xi_e, prop.xi_o, *block)]
    check(max(prop_rels) <= 1e-5,
          f"serving propagator: full-lattice residuals {prop_rels}")
    check(chaos[1].diverged and not chaos[1].converged
          and len({r.stats["batch_id"] for r in chaos}) == 1,
          f"serving NaN: poisoned request {chaos[1].stats}")
    for j in (0, 2):
        check(chaos[j].converged and not chaos[j].diverged
              and torch.equal(chaos[j].xi_e, clean[j].xi_e)
              and torch.equal(chaos[j].xi_o, clean[j].xi_o),
              f"serving NaN: batchmate {j} not bit-equal to the clean run")
    print(f"serving API: coalesced x3 iterations "
          f"{[r.stats['iterations'][0] for r in clean]}, lone "
          f"{lone.stats['iterations']}, propagator x12 "
          f"{prop.stats['iterations']}; coalesced/lone against solo "
          f"{max(diffs):.3e}, full-lattice residuals {max(rels):.2e}, "
          f"propagator {max(prop_rels):.2e}; NaN request diverged, "
          f"batchmates bit-equal", flush=True)

    # c. Timing.
    timed_src = [_sources(shape, 1, device, gen, torch.complex64)
                 for _ in range(SERVING_TIMED)]
    matrix = pool.entry("auto").matrix
    times = {}
    for label, linger in (("at once", 0.002), ("one at a time", 0.0)):
        d = PropagatorDaemon(SessionPool(), BatchingPolicy(
            max_block=4, linger_s=linger, buckets=(1, 2, 4)))
        d.register("auto", matrix, warmup_spec=spec)
        lat = []
        d.start()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if label == "at once":
                subs, done = [], {}
                for i, (ee, eo) in enumerate(timed_src):
                    subs.append(time.perf_counter())
                    f = d.submit("auto", ee, eo, spec)
                    f.add_done_callback(
                        lambda _, i=i: done.__setitem__(
                            i, time.perf_counter()))
                    subs.append(f)
                for f in subs[1::2]:
                    f.result(timeout=600)
                lat = [done[i] - ts for i, ts in enumerate(subs[::2])]
            else:
                for ee, eo in timed_src:
                    ts = time.perf_counter()
                    f = d.submit("auto", ee, eo, spec)
                    f.result(timeout=600)
                    lat.append(time.perf_counter() - ts)
            wall = time.perf_counter() - t0
        finally:
            d.drain()
        m = d.metrics()
        p50, p99 = _latency_ms(lat)
        times[label] = {"requests_per_s": SERVING_TIMED / wall,
                        "wall_s": wall, "p50_ms": p50, "p99_ms": p99,
                        "batches": m["batches"],
                        "mean_batch_columns": m["mean_batch_columns"]}
    sess = api.SolveSession(matrix, spec)
    sess.solve(*timed_src[0])
    lat = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ee, eo in timed_src:
        ts = time.perf_counter()
        sess.solve(ee, eo)
        lat.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    p50, p99 = _latency_ms(lat)
    times["session one by one"] = {
        "requests_per_s": SERVING_TIMED / wall, "wall_s": wall,
        "p50_ms": p50, "p99_ms": p99}
    for label, t in times.items():
        print(f"serving times: {SERVING_TIMED} requests {label} "
              f"({SERVING_LATTICE}, cgnr tol 1e-6, cuda_fused auto): "
              f"{t['requests_per_s']:.1f} requests/s, wall "
              f"{t['wall_s'] * 1e3:.2f} ms, latency p50 "
              f"{t['p50_ms']:.2f} ms p99 {t['p99_ms']:.2f} ms"
              + (f", {t['batches']} batches of {t['mean_batch_columns']:.2f}"
                 f" columns" if "batches" in t else ""), flush=True)
    return {"launches": launches, "times": times}


def phase_distributed_times(device, n_solves=6):
    """Steady cgnr solves (tol 1e-6) at one rank in each overlap mode
    beside ``cuda_hop`` at 16^4 x 1 and x 12, sessions alternating; and
    the device time of one fused ``Dhat`` beside that of its source's
    two halo extensions (local wraps at one rank)."""
    import torch

    from repro_torch import api
    from repro_torch.distributed import halo
    out = {}
    for lattice, nrhs in DIST_POINTS[:2]:
        shape = CHECK_SHAPES[lattice]
        _, U_e, U_o, ee, eo, psi = _dist_fields(shape, nrhs, device)
        spec = api.SolveSpec(method="cgnr", tol=1e-6)
        sessions = {"cuda_hop": api.SolveSession(api.WilsonMatrix.bind(
            U_e, U_o, KAPPA, backend="cuda_hop"), spec)}
        for mode in DIST_MODES:
            if mode == "split" and nrhs > 1:
                continue
            sessions[mode] = api.SolveSession(
                _dist_matrix(U_e, U_o, mode), spec)
        times = {k: [] for k in sessions}
        for _ in range(n_solves):
            for k, sess in sessions.items():
                t0 = time.perf_counter()
                _, _, res = sess.solve(ee, eo)
                torch.cuda.synchronize()
                times[k].append(time.perf_counter() - t0)
                check(bool(torch.as_tensor(res.converged).all()),
                      f"{lattice} x {nrhs} {k} did not converge")
        undegraded(f"distributed solves {lattice} x {nrhs}",
                   *sessions.values())
        steady = {k: statistics.median(t[1:]) for k, t in times.items()}
        m = sessions["fused"].matrix
        lead = psi.ndim - 5
        dhat_ms = device_ms(lambda: m.apply_native(psi), 50)
        ext_ms = 2 * device_ms(lambda: halo.extend_tz(
            psi, halo.TZGrid(), lead, lead + 1), 50)
        print(f"distributed times: {lattice} x {nrhs}, cgnr tol 1e-6, "
              f"steady solve (median of {n_solves - 1} after the first) "
              + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in steady.items())
              + f"; one fused Dhat {dhat_ms * 1e3:.1f} us of device time, "
              f"its two source extensions {ext_ms * 1e3:.1f} us "
              f"({ext_ms / dhat_ms:.0%})", flush=True)
        out[(lattice, nrhs)] = dict(steady, dhat_ms=dhat_ms, ext_ms=ext_ms)
        del sessions, m
        torch.cuda.empty_cache()
    return out


def _planar_shape(shape, nrhs):
    """The planar even-half spinor shape of a lattice ``(T, Z, Y, X)``."""
    T, Z, Y, X = shape
    return ((nrhs,) if nrhs > 1 else ()) + (T, Z, 24, Y, X // 2)


def _events(n):
    import torch
    return ([torch.cuda.Event(enable_timing=True) for _ in range(n)],
            [torch.cuda.Event(enable_timing=True) for _ in range(n)])


def call_ms(fn, n, warmup=3):
    """Median wall time of one call, host overhead included: the card is
    idle when each call starts, so a launch-bound sequence of small ops
    (the plain versions) is timed as a caller experiences it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, n, warmup=5):
    """Median device time of one launch, in ms, from CUDA events.

    A sleep kernel holds the card while the host enqueues every launch
    with its pair of events, so the events bracket the kernel alone and
    not the wrapper's host-side work between them."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts, ends = _events(n)
    torch.cuda._sleep(200_000_000)          # ~0.1 s of GPU clock cycles
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def copy_bandwidth(device):
    """Device-to-device copy rate in bytes/s (read + write counted)."""
    import torch
    n = 1 << 28                                    # 1 GiB of f32
    a = torch.empty(n, dtype=torch.float32, device=device).normal_()
    b = torch.empty_like(a)
    ms = device_ms(lambda: b.copy_(a), 20)
    return 2 * 4 * n / (ms * 1e-3)


def phase_times(device, paths, parent=None):
    """Kernel times; ``paths`` maps ``(lattice, nrhs, dtype, gc)`` to the
    kernel launches of the main paths driven at that shape; ``parent``
    (:func:`parent_times` of another run) is printed beside every policy
    point."""
    import torch

    from repro_torch.analysis.trace_checks import POLICY_POINTS
    from repro_torch.kernels import geometry, ops, ref, wilson_stencil as ws
    rows = {}
    for lattice, _, _ in MAIN_LATTICES:
        T, Z, Y, X = CHECK_SHAPES[lattice]
        gauges, spinor = fields((T, Z, Y, X), "f32", device, seed=13)
        u_e, u_o = gauges[18]
        psi = spinor(1)
        m = ws.hop_traffic_model(T, Z, Y, X // 2, itemsize=4)
        # B2 must move psi_e in, Dhat psi_e out, and both gauge parities.
        b2_bytes = 2 * m["bytes_spinor"] + m["bytes_gauge"]
        b2_flops = 2 * m["flops"] + 2 * 24 * T * Z * Y * (X // 2)
        cases = {
            "hop_block_planar": (
                lambda: ws.hop_block_planar(u_e, u_o, psi, 0),
                lambda: ref.hop_block_planar_ref(u_e, u_o, psi, 0),
                m["bytes_total"], m["flops"]),
            "dhat_planar_fused": (
                lambda: ws.dhat_planar_fused(u_e, u_o, psi, KAPPA),
                lambda: ref.dhat_planar_ref(u_e, u_o, psi, KAPPA),
                b2_bytes, b2_flops),
        }
        for name, (kern, plain, nbytes, flops) in cases.items():
            ms = device_ms(kern, 100)
            wall_ms = call_ms(kern, 50)
            plain_ms = call_ms(plain, 20)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS["f32"] * 1e3
            bound = max(t_bytes, t_ops)
            rows[(lattice, name)] = {
                "ms": ms, "call_ms": wall_ms, "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops}
            print(f"time: {lattice} f32 gc=18 nrhs=1 {name}: device "
                  f"{ms * 1e3:.1f} us, bound {bound * 1e3:.1f} us "
                  f"({rows[(lattice, name)]['bound_by']}, {nbytes} B at "
                  f"3.35 TB/s), {bound / ms:.0%} of bound; "
                  f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s effective, "
                  f"{flops / (ms * 1e-3) / 1e9:.0f} GFlop/s; one call "
                  f"with host work {wall_ms * 1e3:.1f} us; plain version "
                  f"{plain_ms * 1e3:.1f} us per call", flush=True)
        unfused = device_ms(
            lambda: ops.apply_dhat_planar(u_e, u_o, psi, KAPPA), 100)
        print(f"time: {lattice} two-launch B1 Dhat (unfused policy): "
              f"device {unfused * 1e3:.1f} us", flush=True)

    # B2, B3 and the two-launch Dhat (two B1 launches): the device times
    # behind the auto policy's rule.  Run order alternates, so drift
    # during the run shows as a difference between the two readings.
    for lattice, nrhs, dtype, gc in POLICY_POINTS:
        T, Z, Y, X = shape = lattice_shape(lattice)
        itemsize = 4 if dtype == "f32" else 8
        gauges, spinor = fields(shape, dtype, device, seed=14)
        u_e, u_o = gauges[gc]
        del gauges
        psi = spinor(nrhs)
        cands = {
            "B2": lambda: ws.dhat_planar_fused(u_e, u_o, psi, KAPPA),
            "B3": lambda: ws.dhat_planar_fused_stream(u_e, u_o, psi,
                                                      KAPPA),
            "two-launch": lambda: ops.apply_dhat_planar(u_e, u_o, psi,
                                                        KAPPA),
        }
        order = list(cands) + list(reversed(cands))
        ref_out = cands["B2"]()
        errs = {k: float((f() - ref_out).abs().max())
                for k, f in cands.items() if k != "B2"}
        for k, err in errs.items():
            check(err <= ATOL[dtype], f"{k} vs B2 at {lattice} nrhs={nrhs} "
                                      f"{dtype} gc={gc}: max abs err "
                                      f"{err:.3e}")
        times = [(label, device_ms(cands[label], 50)) for label in order]
        m = ws.hop_traffic_model(T, Z, Y, X // 2, nrhs=nrhs,
                                 itemsize=itemsize, gauge_comps=gc)
        # Dhat, however implemented, must move psi_e in, the result out
        # and both gauge parities once: B2's bound is B3's too.
        nbytes = 2 * m["bytes_spinor"] + m["bytes_gauge"]
        flops = 2 * m["flops"] + 2 * 24 * T * Z * Y * (X // 2) * nrhs
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        bound = max(t_bytes, t_ops)
        model = ws.dhat_stream_traffic_model(T, Z, Y, X // 2, nrhs=nrhs,
                                             itemsize=itemsize,
                                             gauge_comps=gc)
        wall = {k: call_ms(cands[k], 20) for k in cands}
        # One call each: the plain B3 walks its schedule row by row (0.5-2
        # s a call here), and its time is no yardstick of speed.
        plain = {
            "B2": call_ms(lambda: ref.dhat_planar_ref(u_e, u_o, psi,
                                                      KAPPA), 1, warmup=0),
            "B3": call_ms(lambda: ref.dhat_planar_stream_ref(
                u_e, u_o, psi, KAPPA), 1, warmup=0)}
        scratch = itemsize * psi.numel()
        ring = ws.stream_ring_bytes(psi.shape, itemsize, ws.STREAM_RING_ROWS)
        launched = paths.get((lattice, nrhs, dtype, gc), {})
        geom = geometry.tile_geometry(Z, Y, X // 2, nrhs, itemsize)
        print(f"time: {lattice} {dtype} gc={gc} nrhs={nrhs} Dhat (auto "
              f"takes {ops.auto_policy(psi.shape)}; tiles D="
              f"{geom.D} G={geom.G}x{geom.groups} S={geom.S}, "
              f"{geom.threads} threads and {geom.smem} B shared memory a "
              f"block; B2 scratch {scratch / 1e6:.1f} MB, B3 ring "
              f"{ring / 1e6:.2f} MB of {ws.STREAM_RING_ROWS} rows), device "
              f"us in run "
              f"order " + ", ".join(f"{k} {t * 1e3:.1f}" for k, t in times)
              + f"; bound {bound * 1e3:.1f} us ({nbytes} B at 3.35 TB/s, "
              f"{'bytes' if t_bytes >= t_ops else 'operations'}); "
              f"dhat_stream_traffic_model {model['bytes_total']} B "
              f"(printed, not the bound); wall per call "
              + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in wall.items())
              + f"; plain B2 {plain['B2'] * 1e3:.1f} us, B3 "
              f"{plain['B3'] * 1e3:.1f} us; max abs err vs B2 "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f"; launches on the paths driven at this shape: B1 "
              f"{launched.get('hop_block_planar', 0)}, B2 "
              f"{launched.get('dhat_planar_fused', 0)}, B3 "
              f"{launched.get('dhat_planar_fused_stream', 0)}",
              flush=True)
        med = {k: statistics.median(t for label, t in times if label == k)
               for k in cands}
        if parent is not None:
            compare_line(f"{lattice} {dtype} gc={gc} nrhs={nrhs}",
                         parent.get((lattice, nrhs, dtype, gc), {}),
                         {k: v * 1e3 for k, v in med.items()})
        check(errs["B3"] == 0.0 and errs["two-launch"] == 0.0,
              f"B3 or the two-launch Dhat differs from B2 at {lattice} "
              f"nrhs={nrhs} {dtype} gc={gc}: {errs}")
        rows[(lattice, nrhs, dtype, gc)] = {
            "times": times, "ms": med, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "call_ms": wall, "plain_ms": plain,
            "model_bytes": model["bytes_total"], "bytes": nbytes}
        del u_e, u_o, psi, ref_out, cands
        torch.cuda.empty_cache()
    return rows


def lattice_shape(lattice):
    if lattice == BIG_LATTICE[0]:
        return BIG_LATTICE[1]
    return SLAB_SHAPES[lattice] if lattice in SLAB_SHAPES else \
        CHECK_SHAPES[lattice]


def time_b1(device, parent=None, points=B1_POINTS):
    """B1 at each of ``points``: device time (median of 50 CUDA-event
    readings, taken twice), bound (``hop_traffic_model``: source, output
    and both link parities, halo faces not counted), the plain version's
    wall time per call; prints a ``time: B1`` line per point and, with
    ``parent`` (:func:`parent_times`), ``parent vs new``.  It times the
    ``repro_torch`` that is imported, so ``tools/time_tree.py`` runs it
    on another tree; a tree without halo mode says so and skips those
    points.  Returns ``{point: row}``."""
    import torch

    from repro_torch.kernels import geometry, ref, wilson_stencil as ws
    rows = {}
    for lattice, nrhs, dtype, gc, halo in points:
        T, Z, Y, X = shape = lattice_shape(lattice)
        itemsize = 4 if dtype == "f32" else 8
        mode = "halo" if halo else "periodic"
        if halo:
            gauges, spinor, centre = halo_fields(shape, dtype, device,
                                                 seed=13)
            u_out, u_in = centre(gauges[gc][0], 1), gauges[gc][1]
        else:
            gauges, spinor = fields(shape, dtype, device, seed=13)
            u_out, u_in = gauges[gc]
        del gauges
        src = spinor(nrhs)
        kw = {"halo": True} if halo else {}

        def kern():
            return ws.hop_block_planar(u_out, u_in, src, 0, **kw)
        try:
            kern()
        except NotImplementedError as exc:
            print(f"time: B1 {lattice} {dtype} gc={gc} nrhs={nrhs} {mode}: "
                  f"not timed ({exc})", flush=True)
            continue
        times = [device_ms(kern, 50) for _ in range(2)]
        ms = statistics.median(times)
        m = ws.hop_traffic_model(T, Z, Y, X // 2, nrhs=nrhs,
                                 itemsize=itemsize, gauge_comps=gc)
        t_bytes = m["bytes_total"] / PEAK_BYTES_PER_S * 1e3
        t_ops = m["flops"] / PEAK_FLOPS[dtype] * 1e3
        bound = max(t_bytes, t_ops)
        plain = call_ms(lambda: ref.hop_block_planar_ref(u_out, u_in, src,
                                                         0, **kw),
                        3, warmup=1)
        hop_geometry = getattr(geometry, "hop_geometry", None)
        tiles = "tiles: no hop_geometry in this tree"
        if hop_geometry is not None:
            g = hop_geometry(T, Z, Y, X // 2, nrhs, itemsize)
            tiles = (f"tiles D={g.D} G={g.G}x{g.groups} S={g.S}, "
                     f"{T * g.tiles * g.groups} blocks of {g.threads} "
                     f"threads and {g.smem} B shared memory")
        print(f"time: B1 {lattice} {dtype} gc={gc} nrhs={nrhs} {mode}: "
              f"{tiles}; device us in run order "
              + ", ".join(f"B1 {t * 1e3:.1f}" for t in times)
              + f"; bound {bound * 1e3:.1f} us ("
              f"{'bytes' if t_bytes >= t_ops else 'operations'}, "
              f"{m['bytes_total']} B at 3.35 TB/s), {bound / ms:.0%} of "
              f"bound; plain version {plain * 1e3:.1f} us per call",
              flush=True)
        if parent is not None:
            old = parent.get(("B1", lattice, nrhs, dtype, gc, mode))
            if old is None and halo:
                per = parent.get(("B1", lattice, nrhs, dtype, gc,
                                  "periodic"), {})
                old = {"B1@periodic": per["B1"]} if "B1" in per else {}
            compare_line(f"B1 {lattice} {dtype} gc={gc} nrhs={nrhs} {mode}",
                         old or {}, {"B1": ms * 1e3})
        rows[(lattice, nrhs, dtype, gc, halo)] = {
            "ms": ms, "bound_ms": bound, "plain_ms": plain,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        del u_out, u_in, src
        torch.cuda.empty_cache()
    return rows


def _sources(shape, nrhs, device, gen, dtype):
    """Even/odd halves of ``nrhs`` random complex sources on ``shape``
    (a leading axis for nrhs > 1)."""
    import torch

    from repro_torch.core import evenodd
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    lead = (nrhs,) if nrhs > 1 else ()
    eta = torch.complex(torch.randn(lead + shape + (4, 3), generator=gen,
                                    dtype=real),
                        torch.randn(lead + shape + (4, 3), generator=gen,
                                    dtype=real))
    packed = [evenodd.pack(c) for c in eta.to(device).reshape(-1, *shape,
                                                             4, 3)]
    ee = torch.stack([e for e, _ in packed])
    eo = torch.stack([o for _, o in packed])
    return (ee, eo) if nrhs > 1 else (ee[0], eo[0])


def phase_refined_times(device, n_solves=4):
    """Steady refined solves (tol 1e-10, cgnr) against a pure-f64
    ``cuda_fused`` solve to the same tolerance, one session each, solves
    alternating, at REFINED_LATTICE with 1 and 12 sources: median wall
    time after the first solve, outer passes, inner iterations,
    ``f64_applies`` and escalations (the pure-f64 solve: its iterations,
    about two f64 Dhats each); and the wall time of one application of
    the refined solves' outer operator (the complex128 ``Dhat`` of
    ``core/evenodd``, mapped over the sources), which each outer pass
    pays once.  Returns ``{(nrhs, label): row}``."""
    import torch

    from repro_torch import api
    from repro_torch.core import evenodd, su3
    shape = CHECK_SHAPES[REFINED_LATTICE]
    out = {}
    for nrhs in (1, 12):
        gen = torch.Generator().manual_seed(2)
        U_e, U_o = evenodd.pack_gauge(su3.random_gauge(gen, shape,
                                                       device=device))
        ee, eo = _sources(shape, nrhs, device, gen, torch.complex128)

        def session(backend, dtype, spec):
            return api.SolveSession(api.WilsonMatrix.bind(
                U_e, U_o, KAPPA, backend=api.BackendSpec(backend,
                                                         dtype=dtype)),
                spec)
        sessions = {"pure f64": session("cuda_fused", "f64", api.SolveSpec(
            method="cgnr", tol=REFINED_TOL))}
        for backend, dtype, inner_tol, n, _ in REFINED:
            if n == nrhs:
                sessions[f"refined {backend} {dtype}"] = session(
                    "cuda_fused" if backend == "auto" else backend, dtype,
                    api.SolveSpec(method="cgnr", tol=REFINED_TOL,
                                  inner_dtype=dtype, inner_tol=inner_tol))
        U64 = [u.to(torch.complex128) for u in (U_e, U_o)]

        def outer_dhat():
            def one(v):
                return evenodd.apply_dhat(*U64, v, KAPPA)
            return torch.func.vmap(one)(ee) if nrhs > 1 else one(ee)
        outer_ms = call_ms(outer_dhat, 3, warmup=1)
        print(f"refined time: {REFINED_LATTICE} x {nrhs}: one application "
              f"of the outer complex128 Dhat (core/evenodd) "
              f"{outer_ms:.2f} ms wall", flush=True)
        out[(nrhs, "outer Dhat")] = {"ms": outer_ms}
        times = {k: [] for k in sessions}
        last = {}
        for _ in range(n_solves):
            for label, sess in sessions.items():
                t0 = time.perf_counter()
                _, _, res = sess.solve(ee, eo)
                torch.cuda.synchronize()
                times[label].append(time.perf_counter() - t0)
                last[label] = res
        undegraded(f"refined time x {nrhs}", *sessions.values())
        for label, res in last.items():
            rel = float(torch.as_tensor(res.residual).max())
            check(bool(torch.as_tensor(res.converged).all())
                  and rel <= 10 * REFINED_TOL,
                  f"{label} x{nrhs}: residual {rel:.2e}, converged "
                  f"{res.converged}")
            row = {"steady_ms": statistics.median(times[label][1:]) * 1e3,
                   "residual": rel}
            if hasattr(res, "outer_iterations"):
                row.update(outer=res.outer_iterations,
                           inner=res.inner_iterations,
                           f64_applies=res.f64_applies,
                           escalations=list(res.escalations))
            else:
                row.update(iterations=int(torch.as_tensor(
                    res.iterations).max()))
            out[(nrhs, label)] = row
            print(f"refined time: {REFINED_LATTICE} x {nrhs}, tol "
                  f"{REFINED_TOL:g}, {label}: steady solve "
                  f"{row['steady_ms']:.2f} ms (median of {n_solves - 1} "
                  f"after the first), residual {rel:.2e}, "
                  + (f"outer {row['outer']}, inner iterations "
                     f"{row['inner']}, f64_applies {row['f64_applies']}, "
                     f"escalations {row['escalations'] or 'none'}"
                     if "outer" in row else
                     f"iterations {row['iterations']} (about "
                     f"{2 * row['iterations'] + 2} f64 Dhats)"), flush=True)
        del sessions, last
        torch.cuda.empty_cache()
    return out


def time_bf16(device):
    """The bf16 kernels beside the f32 ones at BF16_POINTS (full links):
    B1, B2, B3 and the two-launch Dhat, device time (median of 50
    CUDA-event readings, run order alternating), the bound with bf16
    bytes (operations at the f32 rate: the kernels compute in f32), its
    share, the plain version's wall time per call, and whether ``auto``'s
    choice is the fastest bf16 Dhat there.  Returns ``{(lattice, nrhs):
    {kernel: row}}``."""
    import torch

    from repro_torch.kernels import ops, ref, wilson_stencil as ws
    out = {}
    for lattice, nrhs in BF16_POINTS:
        T, Z, Y, X = shape = CHECK_SHAPES[lattice]
        sites = T * Z * Y * (X // 2)
        cands, plains, bounds = {}, {}, {}
        for dtype in ("f32", "bf16"):
            gauges, spinor = fields(shape, dtype, device, seed=23)
            u_e, u_o = gauges[18]
            psi = spinor(nrhs)
            del gauges
            cands.update({
                f"B1 {dtype}": lambda u_e=u_e, u_o=u_o, psi=psi:
                    ws.hop_block_planar(u_e, u_o, psi, 0),
                f"B2 {dtype}": lambda u_e=u_e, u_o=u_o, psi=psi:
                    ws.dhat_planar_fused(u_e, u_o, psi, KAPPA),
                f"B3 {dtype}": lambda u_e=u_e, u_o=u_o, psi=psi:
                    ws.dhat_planar_fused_stream(u_e, u_o, psi, KAPPA),
                f"two-launch {dtype}": lambda u_e=u_e, u_o=u_o, psi=psi:
                    ops.apply_dhat_planar(u_e, u_o, psi, KAPPA)})
            if dtype == "bf16":
                plains = {
                    "B1": lambda u_e=u_e, u_o=u_o, psi=psi:
                        ref.hop_block_planar_ref(u_e, u_o, psi, 0),
                    "B2": lambda u_e=u_e, u_o=u_o, psi=psi:
                        ref.dhat_planar_ref(u_e, u_o, psi, KAPPA),
                    "B3": lambda u_e=u_e, u_o=u_o, psi=psi:
                        ref.dhat_planar_stream_ref(u_e, u_o, psi, KAPPA)}
            itemsize = 2 if dtype == "bf16" else 4
            m = ws.hop_traffic_model(T, Z, Y, X // 2, nrhs=nrhs,
                                     itemsize=itemsize)
            dhat_bytes = 2 * m["bytes_spinor"] + m["bytes_gauge"]
            dhat_flops = 2 * m["flops"] + 2 * 24 * sites * nrhs
            for k, (nbytes, flops) in {
                    "B1": (m["bytes_total"], m["flops"]),
                    "Dhat": (dhat_bytes, dhat_flops)}.items():
                t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_FLOPS[dtype] * 1e3
                bounds[(k, dtype)] = (max(t_bytes, t_ops), "bytes"
                                      if t_bytes >= t_ops else "operations",
                                      nbytes)
        order = list(cands) + list(reversed(cands))
        times = [(label, device_ms(cands[label], 50)) for label in order]
        med = {k: statistics.median(t for label, t in times if label == k)
               for k in cands}
        plain_ms = {k: call_ms(f, 1, warmup=0) for k, f in plains.items()}
        rows = {}
        for label, ms in med.items():
            kernel, dtype = label.split()
            bound, by, nbytes = bounds[("B1" if kernel == "B1" else "Dhat",
                                        dtype)]
            rows[label] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                           "bytes": nbytes,
                           "plain_ms": plain_ms.get(kernel)
                           if dtype == "bf16" else None}
        auto = ops.auto_policy(_planar_shape(shape, nrhs))
        auto_label = {"resident": "B2", "unfused": "two-launch",
                      "stream": "B3"}[auto]
        dhats = {k: med[f"{k} bf16"] for k in ("B2", "B3", "two-launch")}
        fastest = min(dhats, key=dhats.get)
        kinds = ("B1", "B2", "B3", "two-launch")
        share = {k: rows[k]["bound_ms"] / rows[k]["ms"] for k in rows}
        verdict = "is" if fastest == auto_label else "is not"
        print(f"time: bf16 {lattice} nrhs={nrhs} gc=18: device us in run "
              f"order " + ", ".join(f"{k} {t * 1e3:.1f}" for k, t in times)
              + "; bf16 " + ", ".join(
                  f"{k} {rows[k + ' bf16']['ms'] * 1e3:.1f} us = "
                  f"{share[k + ' bf16']:.0%} of "
                  f"{rows[k + ' bf16']['bound_ms'] * 1e3:.1f} us "
                  f"({rows[k + ' bf16']['bound_by']})" for k in kinds)
              + "; f32 " + ", ".join(
                  f"{k} {share[k + ' f32']:.0%} of "
                  f"{rows[k + ' f32']['bound_ms'] * 1e3:.1f} us"
                  for k in kinds)
              + "; plain bf16 " + ", ".join(
                  f"{k} {v * 1e3:.1f} us" for k, v in plain_ms.items())
              + f"; auto takes {auto_label}, fastest bf16 Dhat {fastest}"
              f" (auto {verdict} fastest)", flush=True)
        out[(lattice, nrhs)] = rows
        del cands, plains
        torch.cuda.empty_cache()
    return out


# --- the language-model stack (no kernel: plain PyTorch) --------------

LM_F32_TOL = 1e-4      # the CPU tests' f32 tolerance (of max|CPU run|)
LM_BF16_TOL = 3e-2     # the CPU tests' bf16 tolerance
LM_SMALL_LR = 1e-3     # the small train step's AdamW: lr, one warmup step
# bf16 first moments are held leaf by leaf, each against the larger of
# its own max and this share of the model's largest: a leaf whose
# gradient is small beside the others' is mostly the bf16 rounding of
# larger terms (RWKV's w0, 6.9e-5 of the model's largest, is off by
# 3.02e-2 of its own max on the H100; PERF.md lists the readings)
LM_M_FLOOR = 1e-3
# A first Adam step moves every entry by lr * sign(gradient) plus the
# decay, so an entry whose gradient is rounding noise may step the other
# way (2 lr off).  The parameter change (new - old) is held against the
# CPU's within tol * max|CPU change| of its leaf, except at most this
# share of the model's entries and of any one leaf's (a missing or
# wrong-signed update moves every entry of its leaf 1 or 2 lr off).
LM_FLIP_SHARE = {"float32": 1e-3, "bfloat16": 2e-2}
LM_LEAF_FLIP_SHARE = 0.25
LM_FULL = ("deepseek-7b", 4)           # arch at published widths, depth
LM_TRAIN = (8, 512, 5)                 # batch, seq, steps (remat)
LM_PREFILL = (8, 1024, 16)             # batch, prompt tokens, decodes
LM_PREFILL_REPS = 3                    # timed prefills after a warm-up
# the reference's decode-against-forward tolerance in bf16
# (tests/test_models.py::test_decode_matches_forward)
LM_DECODE_TOL = 5e-2
LM_CLI = ["--ckpt-every", "5"]           # and the defaults otherwise
LM_CLI_STEPS = (20, 10)                  # uninterrupted; first leg
LM_CLI_TIMEOUT = 300                     # s, each CLI run
# The dryrun phase: the dry run's peak against the card's, relative; the
# sharded trainer's losses against one rank's, relative (f32 compute).
DRYRUN_PEAK_TOL = 0.15
SHARDED_TOL = 1e-5
SHARDED_TRAIN = ["--device", "cuda", "--scale", "0.05", "--steps", "3",
                 "--batch", "8", "--seq", "64", "--log-every", "100"]
SHARDED_LAYOUTS = (("elastic", []), ("2x2", ["--mesh-shape", "2x2"]))
DRYRUN_CLI_TIMEOUT = 400                 # s, each dry-run CLI process
# the reference's skip reasons (repro/launch/dryrun.py, configs)
DRYRUN_SKIPS = (r"lattice T=\d+,Z=\d+ not divisible by mesh shards "
                r"\(\d+,\d+\); paper volumes are per-node, run them on "
                r"smaller meshes",
                r"split overlap needs local T,Z >= 2",
                r"encoder-only: no decode step",
                r"full attention is quadratic at 500k; per-instruction skip")


def lm_small(name, **over):
    """An architecture at the CPU tests' size (``build_small(name,
    n_layers=2)``): two layers, narrow widths, its family kept."""
    from repro_torch import configs
    cfg = configs.get(name)
    small = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                 d_ff=128, vocab_size=128, head_dim=16)
    if cfg.n_kv_heads < cfg.n_heads:
        small["n_kv_heads"] = 2
    if cfg.attention == "mla":
        small.update(q_lora_rank=32, kv_lora_rank=24, qk_nope_dim=8,
                     qk_rope_dim=8, v_head_dim=8, head_dim=16)
    if cfg.moe:
        small.update(n_experts=4, moe_d_ff=64, capacity_factor=2.0)
    if cfg.attention == "none":
        small.update(rwkv_head_dim=16, rwkv_decay_lora=8)
    if cfg.attention == "hybrid":
        small.update(ssm_state=4, sliding_window=64, n_heads=5,
                     n_kv_heads=5, d_model=80, head_dim=16)
    if cfg.encoder_layers:
        small.update(encoder_layers=2)
    if cfg.num_prefix_embeds:
        small.update(num_prefix_embeds=6)
    small.update(over)
    return cfg.scaled(**small)


def _rel(got, want):
    """max|got - want| / max|want| in f32 on the CPU."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def _lm_small_run(cfg, tree, batch, device):
    """Prefill, two decode steps and one train step of ``cfg`` from the
    tree (moved to ``device``): (logits of the three, loss, grad norm,
    each parameter's change by name, first moments)."""
    import numpy as np
    import torch

    from repro_torch.models import model as TM, steps
    from repro_torch.optim import adamw
    model = TM.LanguageModel(cfg, TM.tree_map(lambda t: t.clone(), tree),
                             device=device)
    x = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in batch.items()}
    toks = x.pop("tokens")
    extra = {k: v for k, v in x.items() if k != "mask"}
    S = toks.shape[1] - 2
    cache_dtype = getattr(torch, cfg.compute_dtype)
    with torch.no_grad():
        last, cache, idx = model.prefill(toks[:, :S], S + 4 +
                                         cfg.num_prefix_embeds,
                                         cache_dtype=cache_dtype, **extra)
        d1, cache = model.decode_step(cache, toks[:, S:S + 1], idx)
        d2, cache = model.decode_step(cache, toks[:, S + 1:S + 2], idx + 1)
    opt = adamw.AdamW(lr=LM_SMALL_LR, warmup_steps=1, total_steps=10)
    named = TM.flatten(model.params())
    before = {k: p.detach().clone() for k, p in named.items()}
    state = opt.init(list(named.values()))
    step = steps.make_train_step(cfg, opt, remat=True)
    state, met = step(model, state, {"tokens": toks[:, :S], **x}, 0)
    return {"logits": (last, d1[:, 0], d2[:, 0]), "loss": met["loss"],
            "grad_norm": met["grad_norm"],
            "step": {k: (p.detach() - before[k]).cpu()
                     for k, p in named.items()},
            "m": dict(zip(named, (m.cpu() for m in state.m)))}


def _lm_small_check(name, dtype, device):
    """One architecture in one compute dtype, on the card against the
    CPU on the same weights and batch: (ok, the worst relative errors,
    the leaves they came from)."""
    import numpy as np
    import torch

    from repro_torch.models import model as TM
    cfg = dataclasses.replace(lm_small(name), compute_dtype=dtype)
    tree = TM.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    B, S = 2, 16
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 2)),
             "mask": np.ones((B, S), np.float32)}
    if cfg.num_prefix_embeds:
        batch["prefix_embeds"] = (rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.d_model)) * 0.1).astype(
                np.float32)
    if cfg.is_enc_dec:
        batch["enc_embeds"] = (rng.standard_normal(
            (B, 8, cfg.d_model)) * 0.1).astype(np.float32)
    cpu = _lm_small_run(cfg, tree, batch, torch.device("cpu"))
    gpu = _lm_small_run(cfg, tree, batch, device)
    tol = LM_F32_TOL if dtype == "float32" else LM_BF16_TOL
    floor = 0.0 if dtype == "float32" else LM_M_FLOOR
    m_max = max(float(c.abs().max()) for c in cpu["m"].values())
    # first moments (0.1 x the clipped gradient), leaf by leaf: the error
    # over the larger of the leaf's max and floor x the model's max
    m_err = {k: float((gpu["m"][k] - c).abs().max())
             / max(float(c.abs().max()), floor * m_max, 1e-30)
             for k, c in cpu["m"].items()}
    m_own = {k: _rel(gpu["m"][k], c) for k, c in cpu["m"].items()}
    # the parameter change, leaf by leaf against the CPU's
    flips, n, excess, leaf_share = 0, 0, 0.0, {}
    for k, c in cpu["step"].items():
        d = (gpu["step"][k] - c).abs()
        bound = tol * float(c.abs().max())
        off = int((d > bound).sum())
        flips, n = flips + off, n + c.numel()
        leaf_share[k] = off / c.numel()
        excess = max(excess, float(d.max()) - bound)
    worst_m = max(m_err, key=m_err.get)
    worst_own = max(m_own, key=m_own.get)
    worst_leaf = max(leaf_share, key=leaf_share.get)
    err = {"logits": max(_rel(g, c) for g, c in zip(gpu["logits"],
                                                      cpu["logits"])),
           "loss": _rel(gpu["loss"], cpu["loss"]),
           "grad_norm": _rel(gpu["grad_norm"], cpu["grad_norm"]),
           "m": m_err[worst_m],
           "m_own": m_own[worst_own],
           "m_own_of_model": float(cpu["m"][worst_own].abs().max()) / m_max,
           "step_share": flips / n,
           "step_leaf_share": leaf_share[worst_leaf],
           "step_excess": excess}         # beyond tol * max|change|
    ok = (max(err[k] for k in ("logits", "loss", "grad_norm", "m")) <= tol
          and err["step_share"] <= LM_FLIP_SHARE[dtype]
          and err["step_leaf_share"] <= LM_LEAF_FLIP_SHARE
          and err["step_excess"] <= 2 * LM_SMALL_LR)
    return ok, err, {"m": worst_m, "m_own": worst_own, "step": worst_leaf}


def _lm_cli(runs):
    """Run ``python -m repro_torch.launch.train`` once per ``(args,
    log)`` of ``runs``, all at once, each with its defaults but ``args``
    and its output to ``log``: [(exit code, lines, last step's loss)].
    A run still going after ``LM_CLI_TIMEOUT`` s is killed."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = []
    try:
        for args, log in runs:
            fh = open(log, "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train", *args],
                stdout=fh, stderr=subprocess.STDOUT, env=env, cwd=ROOT),
                fh, log))
        out = []
        for proc, _, log in procs:
            try:
                rc = proc.wait(timeout=LM_CLI_TIMEOUT)
            except subprocess.TimeoutExpired:
                rc = None
            lines = Path(log).read_text().splitlines()
            steps = [ln.split() for ln in lines if ln.startswith("step ")]
            out.append((rc, lines, float(steps[-1][3]) if steps else None))
        return out
    finally:
        for proc, fh, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fh.close()


def phase_lm(device):
    """The language-model stack on the card (plain PyTorch: it holds no
    kernel, and the TPU side had no Pallas kernel there either).

    1. All ten architectures at the CPU tests' size (:func:`lm_small`), in
       f32 compute and in the config's bf16: a prefill and two decode
       steps (their logits) and one train step (loss, grad norm, first
       moments, updated parameters; AdamW lr 1e-3 after one warmup step)
       on the card, held against the same run on the CPU from the same
       weights and batch within the CPU tests' tolerances (f32 1e-4,
       bf16 3e-2 of max|CPU|); the first moments leaf by leaf (in bf16
       of the larger of the leaf's max and ``LM_M_FLOOR`` of the
       model's); each parameter's change against the CPU's within that
       tolerance of its leaf's largest change, except a share of entries
       (``LM_FLIP_SHARE``, ``LM_LEAF_FLIP_SHARE``), each within 2 lr
       more (an Adam step moves an entry whose gradient is rounding
       noise by lr either way).
    2. ``deepseek-7b`` at its published widths (d_model 4096, 32 heads of
       128, d_ff 11008, vocab 102400) with its depth cut from 30 to 4
       layers (``cfg.scaled(n_layers=4)``): 5 steps of
       ``make_train_step(remat=True)`` at batch 8 x seq 512 from weights
       drawn on the card (finite loss and grad norm; step ms, the median
       of steps 2-5, tokens/s, peak memory), then prefills of 8 x 1024
       tokens and 16 greedy decode steps through ``make_prefill_step``
       and ``make_serve_step`` (prefill ms, the median of
       ``LM_PREFILL_REPS`` after a warm-up; decode tokens/s from the
       median of steps 2-16 after a warm-up step), the last decode
       step's logits held against a full forward over the same 1040
       tokens within ``LM_DECODE_TOL``.
    3. The CLI, ``python -m repro_torch.launch.train`` with its defaults
       and ``--steps 20 --ckpt-every 5``: once uninterrupted and, at
       the same time in another process, to ``--steps 10``; then resumed
       to 20, which must print ``resumed from step 10`` and end on the
       uninterrupted run's last loss within 1e-3 relative.
    Returns the full-width numbers."""
    import shutil

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.models import model as TM, steps
    from repro_torch.optim import adamw
    t0 = time.time()
    for name in configs.ARCH_NAMES:
        for dtype in ("float32", lm_small(name).compute_dtype):
            ok, err, where = _lm_small_check(name, dtype, device)
            print(f"lm small {name} {dtype}: " + ", ".join(
                f"{k} {v:.2e}" for k, v in err.items()) + "; worst leaves "
                + ", ".join(f"{k} {v}" for k, v in where.items()),
                flush=True)
            check(ok, f"lm: {name} in {dtype} on the card differs from the "
                      f"CPU: {err}")
    print(f"lm small: 10 architectures x 2 dtypes in "
          f"{time.time() - t0:.1f} s", flush=True)

    arch, depth = LM_FULL
    full = configs.get(arch)
    cfg = full.scaled(n_layers=depth)
    n_params = cfg.param_count()
    print(f"lm full width: {arch} d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; depth cut {full.n_layers} -> {depth} layers "
          f"(cfg.scaled(n_layers={depth})): {n_params / 1e9:.3f} B "
          f"parameters, {cfg.compute_dtype} compute, f32 weights",
          flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = TM.LanguageModel(cfg, generator=torch.Generator(device=device)
                             .manual_seed(0), device=device)
    B, S, n_steps = LM_TRAIN
    opt = adamw.AdamW(total_steps=100, warmup_steps=10)
    leaves = list(TM.flatten(model.params()).values())
    state = opt.init(leaves)
    train_step = steps.make_train_step(cfg, opt, remat=True)
    source = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B))
    walls, losses, norms = [], [], []
    for i in range(n_steps):
        batch = to_device(source.batch(i), device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        # the first step (not in the median) under the flop counter,
        # which the dryrun phase's dry run of this step must equal
        with (FlopCounterMode(display=False) if i == 0
              else contextlib.nullcontext()) as flops:
            state, met = train_step(model, state, batch, i)
        if i == 0:
            step_flops = flops.get_total_flops()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    check(all(map(math.isfinite, losses + norms)),
          f"lm: non-finite loss or grad norm at full width: {losses}, "
          f"{norms}")
    step_s = statistics.median(walls[1:])
    train_tps = B * S / step_s
    print(f"lm train {arch} x{depth} layers, batch {B} x seq {S}, remat: "
          f"step {step_s * 1e3:.1f} ms (median of steps 2-{n_steps}, "
          f"{min(walls[1:]) * 1e3:.1f}-{max(walls[1:]) * 1e3:.1f}; first "
          f"{walls[0] * 1e3:.1f} ms under the flop counter: "
          f"{step_flops:.4e} flops), {train_tps:.0f} tokens/s, peak "
          f"{peak / 1e9:.2f} GB (max_memory_allocated); losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; grad norms "
          f"{', '.join(f'{v:.3f}' for v in norms)}; card {card_name()}",
          flush=True)
    del state, met, train_step, batch
    torch.cuda.empty_cache()

    B, P, n_dec = LM_PREFILL
    gen = torch.Generator(device=device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=device)
    toks = [prompt]
    params = model.params()
    prefill_step = steps.make_prefill_step(cfg, P + n_dec)
    serve_step = steps.make_serve_step(cfg)

    def wall(fn, *a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return time.perf_counter() - t, out
    with torch.no_grad():
        pre = []                # a full-size warm-up, then the timed ones
        for _ in range(1 + LM_PREFILL_REPS):
            cache = None
            dt, (last, cache, idx) = wall(prefill_step, params,
                                          {"tokens": prompt})
            pre.append(dt)
        prefill_s = statistics.median(pre[1:])
        nxt = torch.argmax(last, dim=-1)[:, None]
        # a warm-up decode step; the first timed one rewrites its slot
        serve_step(params, cache, nxt, idx)
        dec = []
        for i in range(n_dec):
            toks.append(nxt)
            dt, (nxt, logits, cache) = wall(serve_step, params, cache, nxt,
                                            idx + i)
            dec.append(dt)
        decode_s = statistics.median(dec[1:])
        del cache
        full_logits, _ = model(torch.cat(toks, dim=1))
    err = _rel(logits[:, -1], full_logits[:, -1])
    print(f"lm serve {arch} x{depth} layers: prefill {B} x {P} tokens "
          f"{prefill_s * 1e3:.1f} ms (median of {LM_PREFILL_REPS} after a "
          f"warm-up, {min(pre[1:]) * 1e3:.1f}-{max(pre[1:]) * 1e3:.1f}); "
          f"decode at batch {B}: {decode_s * 1e3:.2f} ms a step (median of "
          f"steps 2-{n_dec} after a warm-up step, {min(dec[1:]) * 1e3:.2f}-"
          f"{max(dec[1:]) * 1e3:.2f}), {B / decode_s:.0f} tokens/s; last "
          f"decode vs full forward {err:.2e} (tol {LM_DECODE_TOL}); card "
          f"{card_name()}", flush=True)
    check(err <= LM_DECODE_TOL, f"lm: the last decode step's logits differ "
                                f"from the full forward by {err:.3e}")
    del model, params, full_logits, logits
    torch.cuda.empty_cache()

    out_dir = ROOT / "build" / "chip_smoke_lm"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    try:
        t = time.time()
        n, first = LM_CLI_STEPS

        def run(steps_, d, log):
            return (LM_CLI + ["--steps", str(steps_), "--ckpt-dir",
                              str(out_dir / d)], out_dir / log)
        # the uninterrupted run and the first leg at once, then the resume
        (rc, lines, want), (rc1, lines1, _) = _lm_cli(
            [run(n, "full", "full.log"), run(first, "legs", "first.log")])
        check(rc == 0 and lines[-1:] == ["done"],
              f"lm: the train CLI failed (rc {rc}): {lines[-5:]}")
        check(rc1 == 0, f"lm: the first leg failed (rc {rc1}): "
                        f"{lines1[-5:]}")
        ((rc, lines, got),) = _lm_cli([run(n, "legs", "resumed.log")])
        check(rc == 0 and f"resumed from step {first}" in lines,
              f"lm: the resumed run failed or did not resume (rc {rc}): "
              f"{lines[-5:]}")
        rel = abs(got - want) / abs(want)
        print(f"lm cli: {lines[0]}; last loss uninterrupted {want:.4f}, "
              f"resumed at {first} {got:.4f} (rel {rel:.1e}, tol 1e-3); "
              f"{time.time() - t:.1f} s for the three runs (the first two at "
              f"once)", flush=True)
        check(rel <= 1e-3, f"lm: resumed loss {got} against {want}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return {"step_ms": step_s * 1e3, "tokens_per_s": train_tps,
            "peak_bytes": peak, "step_flops": step_flops,
            "prefill_ms": prefill_s * 1e3,
            "decode_tokens_per_s": B / decode_s}


def _sharded_rank(rank, world, port, out_path, backend="gloo"):
    """One rank of the sharded trainer's job (spawned): gloo with every
    rank on card 0, or NCCL with rank r on card r; the trainer on each of
    ``SHARDED_LAYOUTS``; rank 0 saves the losses, or the error a rank
    met."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    out = {}
    try:
        from repro_torch.launch import train
        train.scaled_config = _f32_config(train.scaled_config)
        for label, extra in SHARDED_LAYOUTS:
            try:
                out[label] = train.main(SHARDED_TRAIN + extra)
            except Exception as e:  # noqa: BLE001
                out[label] = f"{type(e).__name__}: {e}"
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def _f32_config(base):
    """``train.scaled_config`` in f32 compute (``SHARDED_TOL`` is f32's)."""
    def scaled(name, scale):
        return base(name, scale).scaled(compute_dtype="float32")
    return scaled


def _funcol_rank(rank, world, port):
    """One rank of the gloo probe: DTensor's all-gather (a functional
    ``all_gather_into_tensor`` and its ``wait_tensor``) on a CUDA
    tensor."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        x = torch.ones(4, 4, device="cuda")
        funcol.all_gather_tensor(x, 0, dist.group.WORLD).wait()
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def gloo_carries_cuda_collectives() -> "str | None":
    """``None`` if two gloo ranks on this card complete DTensor's
    functional all-gather of a CUDA tensor; else what happened."""
    import torch.multiprocessing as mp
    try:
        mp.start_processes(_funcol_rank, args=(2, _free_port()), nprocs=2,
                           join=True, start_method="spawn")
    except Exception as e:  # noqa: BLE001  (a rank's signal or error)
        return f"{type(e).__name__}: {e}"
    return None


def check_sharded_train(backend="gloo", world=4):
    """The trainer sharded over ``world`` ranks on CUDA tensors (gloo on
    this card, or NCCL on ``world`` cards) on each of
    ``SHARDED_LAYOUTS``, its losses within ``SHARDED_TOL`` of one rank's
    on card 0.  Returns the losses."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    from repro_torch.launch import train
    t0 = time.time()
    out_dir = ROOT / "build" / "chip_smoke_sharded"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    base = train.scaled_config
    try:
        train.scaled_config = _f32_config(base)
        try:
            one_rank = train.main(SHARDED_TRAIN)
        finally:
            train.scaled_config = base
        mp.start_processes(_sharded_rank,
                           args=(world, _free_port(),
                                 str(out_dir / "train.pt"), backend),
                           nprocs=world, join=True, start_method="spawn")
        got = torch.load(out_dir / "train.pt", weights_only=False)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    cards = "one card" if backend == "gloo" else f"{world} cards"
    for label, _ in SHARDED_LAYOUTS:
        losses = got[label]
        check(isinstance(losses, list),
              f"sharded train ({label}, {backend}) failed: {losses}")
        err = max(abs(a - b) / abs(b) for a, b in zip(losses, one_rank))
        print(f"sharded train: {label} on {world} {backend} ranks on "
              f"{cards}, f32, losses {losses}; one rank {one_rank}; worst "
              f"{err:.2e} relative (tol {SHARDED_TOL}); card "
              f"{card_name()}", flush=True)
        check(len(losses) == len(one_rank) and err <= SHARDED_TOL,
              f"sharded losses ({label}, {backend}) {losses} against one "
              f"rank's {one_rank}")
    print(f"sharded train: {time.time() - t0:.1f} s", flush=True)
    return got


def phase_dryrun(device, lm, four):
    """The multi-device dry run checked against the card, and the trainer
    sharded over four ranks on it (``lm``: the ``lm`` phase's full-width
    step, its peak bytes and flops; ``four``: the ``four_ranks`` job's
    results, each rank's halo counts of one fused ``Dhat``).

    The two dry-run CLI processes (``--qcd-only --mesh both``, and the
    multi-pod example: ``deepseek-7b decode_32k`` on the 512-rank mesh and
    the roofline) run in the background while the rest runs here; every
    cell they record must be ``ok`` or skipped for one of the reference's
    reasons (``DRYRUN_SKIPS``)."""
    import os
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun, mesh as mesh_lib
    t0 = time.time()
    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    clis = {"qcd": [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--qcd-only", "--mesh", "both", "--out",
                    str(out_dir / "qcd")],
            "example": [sys.executable,
                        str(ROOT / "examples" / "torch_multipod_dryrun.py"),
                        "--out", str(out_dir / "example")]}
    logs = {k: open(out_dir / f"{k}.log", "w") for k in clis}
    procs = {k: (subprocess.Popen(cmd, stdout=logs[k],
                                  stderr=subprocess.STDOUT, env=env,
                                  cwd=ROOT), time.time())
             for k, cmd in clis.items()}
    try:
        # 1. memory and flops of the lm phase's step, dry-run on 1 x 1
        arch, depth = LM_FULL
        B, S, _ = LM_TRAIN
        cfg = configs.get(arch).scaled(n_layers=depth)
        with mesh_lib.fake_world(1):
            one = mesh_lib.grid_mesh((1, 1), ("data", "model"), "cuda")
            rec = dryrun.run_lm_cell(f"{arch}__lm-step__1x1", cfg,
                                     ShapeCell("lm-step", S, B, "train"),
                                     one, accum=1)
        peak, real = rec["peak_bytes_per_device"], lm["peak_bytes"]
        rel = abs(peak - real) / real
        print(f"dryrun memory: {arch} x{depth} layers, train {B} x {S}, "
              f"remat, AdamW, 1 x 1 mesh: dry-run peak {peak / 1e9:.3f} GB "
              f"(args {rec['arg_bytes_per_device'] / 1e9:.3f}, temp "
              f"{rec['temp_bytes_per_device'] / 1e9:.3f}; traced in "
              f"{rec['trace_s']:.1f} s) against the card's "
              f"max_memory_allocated {real / 1e9:.3f} GB: {rel:.1%} (tol "
              f"{DRYRUN_PEAK_TOL:.0%}); matmul flops dry run "
              f"{rec['flops_per_device']:.6e}, FlopCounterMode on the card "
              f"{lm['step_flops']:.6e}; card {card_name()}", flush=True)
        check(rel <= DRYRUN_PEAK_TOL,
              f"dryrun: peak {peak} B against the card's {real} B")
        check(rec["flops_per_device"] == lm["step_flops"],
              f"dryrun: {rec['flops_per_device']} flops against the card's "
              f"{lm['step_flops']}")

        # 2. halo bytes of one Dhat on the four_ranks job's 2 x 2 grid
        lat = configs.get_qcd(DIST_LATTICE)
        with mesh_lib.fake_world(DIST_GRID[0] * DIST_GRID[1]):
            qrec = dryrun.run_qcd_cell(
                f"{DIST_LATTICE}__dhat-opt__2x2", lat, dist.group.WORLD,
                *DIST_GRID, **dryrun.QCD_VARIANTS["opt"])
        coll = qrec["collectives"]
        want = {"bytes": coll["total_bytes"], "messages": coll["n_ops"]}
        print(f"dryrun halo: {DIST_LATTICE} opt on a fake {DIST_GRID[0]} x "
              f"{DIST_GRID[1]} group: {want['bytes']} B in "
              f"{want['messages']} messages per rank per Dhat; the "
              f"four_ranks job's ranks counted {four['halo_dhat']}",
              flush=True)
        for r, got in enumerate(four["halo_dhat"]):
            check(got == want, f"dryrun: rank {r} sent {got} in one Dhat, "
                               f"the dry run {want}")

        # 4. the trainer sharded over four gloo ranks on this card, if
        # gloo carries DTensor's collectives on CUDA tensors; else over
        # NCCL on four cards (tools/four_gpus_nccl.py)
        missing = gloo_carries_cuda_collectives()
        if missing is None:
            check_sharded_train("gloo")
        else:
            print(f"dryrun sharded train: gloo on this card does not carry "
                  f"DTensor's functional all_gather_into_tensor + "
                  f"wait_tensor on CUDA tensors (torch {torch.__version__}: "
                  f"{missing}); the four-rank check runs over NCCL on four "
                  f"cards instead: python3 tools/four_gpus_nccl.py "
                  f"--sharded-train", flush=True)

        # 3. the CLI processes
        for name, (proc, started) in procs.items():
            try:
                proc.wait(timeout=max(
                    1.0, DRYRUN_CLI_TIMEOUT - (time.time() - started)))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            logs[name].close()
            lines = (out_dir / f"{name}.log").read_text().splitlines()
            check(proc.returncode == 0,
                  f"dryrun: {' '.join(clis[name][1:])} exited "
                  f"{proc.returncode}: {lines[-5:]}")
            recs = [json.loads(f.read_text())
                    for f in sorted((out_dir / name).glob("*.json"))]
            for r in recs:
                check(r["status"] == "ok" or (
                    r["status"] == "skip" and any(
                        re.fullmatch(p, r["reason"]) for p in DRYRUN_SKIPS)),
                      f"dryrun: {r['cell']} is {r['status']}: "
                      f"{r.get('reason') or r.get('error')}")
            done = [ln for ln in lines if ln.startswith("dry-run:")]
            print(f"dryrun cli {name}: {done[-1] if done else lines[-1:]} "
                  f"({time.time() - started:.1f} s)", flush=True)
            if name == "example":
                for ln in lines:
                    if ln.startswith(("|", "hardware:")):
                        print(f"dryrun roofline {ln}", flush=True)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for fh in logs.values():
            fh.close()
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"dryrun: {time.time() - t0:.1f} s; card {card_name()}",
          flush=True)
    return {"peak_bytes": peak, "halo": want}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Smoke test of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--parent-log", metavar="FILE", action="append",
                    default=[],
                    help="the output of another run of chip_smoke.py (the "
                         "parent commit's) or of tools/time_tree.py; may be "
                         "repeated: its B1, B2 and B3 times are printed "
                         "beside this run's at every B1 and policy point")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"error: {SRC / 'repro_torch'} not found; run chip_smoke.py "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False; this smoke test "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(f"card: {card_name()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    t_start = time.time()
    parent = parent_times(args.parent_log) if args.parent_log else None
    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.time()
        out = fn(*a)
        phase_s[name] = time.time() - t0
        return out
    timed("build", phase_build)
    worst = {"hop_block_planar": timed("b1", phase_b1, device),
             "dhat_planar_fused": timed("b2", phase_b2, device),
             "dhat_planar_fused_stream": timed("b3", phase_b3, device)}
    worst_bf16 = timed("bf16", phase_bf16, device)
    timed("cg_update", phase_cg_update, device)
    gate = timed("gate", phase_gate, device)
    runs = timed("slice", phase_slice)
    runs2 = timed("slice2", phase_slice2)
    timed("cuda_hop", phase_cuda_hop)
    refined = timed("refined", phase_refined)
    blockcg = timed("blockcg", phase_blockcg, runs2["auto"])
    deflation = timed("deflation", phase_deflation, device)
    resilience = timed("resilience", phase_resilience, device)
    timed("block_of_one", phase_block_of_one, device)
    timed("policy_solves", phase_policy_solves, device)
    distributed = timed("distributed", phase_distributed, device)
    four = timed("four_ranks", phase_four_ranks, device)
    serving = timed("serving", phase_serving, device)
    lm = timed("lm", phase_lm, device)
    timed("dryrun", phase_dryrun, device, lm, four)
    copy_bps = copy_bandwidth(device)
    print(f"copy bandwidth: {copy_bps / 1e9:.0f} GB/s (device-to-device"
          f" copy, read + write; the bounds use the 3.35 TB/s peak)",
          flush=True)
    # Every driven path runs f32 with full links.
    paths = {(lattice, 1, "f32", 18): run["launches"]
             for lattice, run in runs.items()}
    lattice, nrhs, _ = PROPAGATOR
    paths[(lattice, nrhs, "f32", 18)] = {
        k: sum(run["launches"][k] for run in runs2.values())
        for k in runs2["auto"]["launches"]}
    rows = timed("times", phase_times, device, paths, parent)
    timed("b1_times", time_b1, device, parent)
    timed("refined_times", phase_refined_times, device)
    timed("distributed_times", phase_distributed_times, device)
    slab_rows = timed("slab_times", time_b1, device, None, SLAB_POINTS)
    bf16_rows = timed("bf16_times", time_bf16, device)
    lanczos_b1 = timed("lanczos_b1", time_lanczos_b1, device,
                       deflation["m"])
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in phase_s.items()),
          flush=True)

    main_lattice = MAIN_LATTICES[0][0]
    sources = {
        "hop_block_planar": ("src/repro_torch/kernels/csrc/wilson_hop.cu",
                             "src/repro/kernels/wilson_stencil.py:481"),
        "dhat_planar_fused": (
            "src/repro_torch/kernels/csrc/wilson_dhat_fused.cu",
            "src/repro/kernels/wilson_stencil.py:673"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        row = rows[(main_lattice, name)]
        # The main path's runs: B2 at 16^4, B1 at wilson-64x16x16x8.
        launched = sum(run["launches"][name] for run in runs.values())
        check(launched > 0, f"{name} made no launch on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launched,
            "max_abs_err": worst[name]["f32"],
            "max_abs_err_f64": worst[name]["f64"],
            "ms": row["ms"], "call_ms": row["call_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "copy_bytes_per_s": copy_bps,
            "lattice": main_lattice, "nrhs": 1, "dtype": "f32"})
    lattice, nrhs, _ = PROPAGATOR
    row = rows[(lattice, nrhs, "f32", 18)]
    name = "dhat_planar_fused_stream"
    kernels.append({
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wilson_dhat_stream.cu",
        "replaces": "src/repro/kernels/wilson_stencil.py:992",
        "launches": runs2["cuda_fused_stream"]["launches"][name],
        "max_abs_err": worst[name]["f32"],
        "max_abs_err_f64": worst[name]["f64"],
        "ms": row["ms"]["B3"], "call_ms": row["call_ms"]["B3"],
        "plain_ms": row["plain_ms"]["B3"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
        "copy_bytes_per_s": copy_bps,
        "lattice": lattice, "nrhs": nrhs, "dtype": "f32"})
    # The mixed-precision path: each kernel's launches on the refined
    # bf16 runs, and its bf16 numbers at the point that path drives it.
    bf16_point = {"hop_block_planar": (REFINED_LATTICE, 12, "B1"),
                  "dhat_planar_fused": (REFINED_LATTICE, 1, "B2"),
                  "dhat_planar_fused_stream": (REFINED_LATTICE, 12, "B3")}
    for row in kernels:
        name = row["name"]
        launched = sum(run["launches"][name] for (_, dtype, _), run
                       in refined.items() if dtype == "bf16")
        check(launched > 0, f"{name} made no launch on the refined bf16 "
                            "path")
        lattice, nrhs, label = bf16_point[name]
        b = bf16_rows[(lattice, nrhs)][f"{label} bf16"]
        row.update({
            "dtypes": ["f32", "bf16", "f64"],
            "launches_refined_bf16": launched,
            "max_abs_err_bf16": worst_bf16[name][0],
            "max_rel_err_bf16": worst_bf16[name][1],
            "ms_bf16": b["ms"], "bound_ms_bf16": b["bound_ms"],
            "bound_by_bf16": b["bound_by"], "plain_ms_bf16": b["plain_ms"],
            "lattice_bf16": lattice, "nrhs_bf16": nrhs})
    # The block CG and deflation paths: each kernel's launches there (the
    # deflation CLI run and the API runs on the weak gauge), and B1 at the
    # Lanczos basis's batched apply.
    for row in kernels:
        name = row["name"]
        row["launches_blockcg"] = blockcg["launches"][name]
        row["launches_deflation"] = (deflation["cli"]["launches"][name]
                                     + deflation["launches"][name])
    check(kernels[0]["launches_blockcg"] > 0
          and kernels[0]["launches_deflation"] > 0
          and kernels[1]["launches_deflation"] > 0,
          "B1 or B2 made no launch on the blockcg or deflation path")
    kernels[0]["lanczos_batch"] = lanczos_b1
    # The distributed path (one rank, the CLI in each overlap mode): B1's
    # launches by mode, and its times on the slabs of the boundary passes.
    kernels[0]["launches_distributed"] = distributed["b1_modes"]
    check(distributed["b1_modes"]["halo"] > 0,
          "B1 made no halo-mode launch on the distributed path")
    # The split-lattice solver paths of the four-rank job (block CG,
    # deflation, refined solves): rank 0's B1 launches by mode there.
    kernels[0]["launches_four_rank_solvers"] = four["b1_modes"]
    check(four["b1_modes"]["halo"] > 0,
          "B1 made no halo-mode launch on the four-rank solver paths")
    # The daemon serving the split lattice: rank 0's B1 launches there.
    kernels[0]["launches_four_rank_serving"] = four["serving_b1_modes"]
    check(four["serving_b1_modes"]["halo"] > 0,
          "B1 made no halo-mode launch serving the split lattice")
    kernels[0]["slabs"] = [
        {"lattice": lattice, "nrhs": nrhs, **row}
        for (lattice, nrhs, _, _, _), row in slab_rows.items()]
    # The resilience path: each kernel's launches over its runs.
    for row in kernels:
        row["launches_resilience"] = resilience["launches"][row["name"]]
        check(row["launches_resilience"] > 0,
              f"{row['name']} made no launch on the resilience path")
    # The invariant gate's runtime checks on the card: each kernel's
    # launches there (each one call the gate counts).
    for row in kernels:
        row["launches_gate"] = gate["launches"][row["name"]]
        check(row["launches_gate"] > 0,
              f"{row['name']} made no launch in the gate phase")
    # The serving path (the CLI selftest and the API runs): each kernel's
    # launches there.
    for row in kernels:
        row["launches_serving"] = serving["launches"][row["name"]]
        check(row["launches_serving"] > 0,
              f"{row['name']} made no launch on the serving path")
    print(f"total: {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
