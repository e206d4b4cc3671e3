"""On-card smoke run of genomax_torch, the port of genomax to PyTorch and
CUDA.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero). They run in the
order 1, 2, 19, 21, 24, 27, 3, 4, 5, 33, 22, 23, 25, 26, 28, 29, 20,
7-18, 38, 39, 30-32, 34-37, 6:
  1. build      nvcc-builds the nine kernels (csrc/sw_tile.cu,
                csrc/sw_long.cu, csrc/sw_strips.cu, csrc/sw_rotor.cu,
                csrc/sw_stacked.cu, csrc/sw_conveyor.cu, csrc/sw_xstrip.cu,
                csrc/pairhmm_tile.cu, csrc/pairhmm_long.cu) from the
                checkout, one nvcc each, in parallel, and g++-builds the
                native golden library; prints ptxas's registers and spills
                of every kernel instance, and the SASS count of integer
                arithmetic a cell along one step of the loop of every
                instance of csrc/sw_long.cu and csrc/sw_xstrip.cu (R = 4,
                8, 16), csrc/sw_strips.cu and csrc/sw_tile.cu (R = 2, 3,
                4, 5, 6, 8; the lane tile's warp form and its blocks of
                2-16 and 17-32 warps),
                csrc/sw_rotor.cu (every G and C), csrc/sw_stacked.cu
                (R = 2-16) and csrc/sw_conveyor.cu (every G and R, and
                the block form) (cuobjdump -sass), which SW_OPS_PER_CELL
                must not pass,
                and of fp32
                flops a cell (FFMA 2) along one step of
                csrc/pairhmm_tile.cu's (the warp form at every R, the
                block form at R = 4, 5, 6, 8 at each launch bound) and
                csrc/pairhmm_long.cu's
                loop at every R, which must reach PHMM_FLOPS_PER_CELL
  2. kernel     the lane-tile SW kernel at its default R and at every R
                the build makes vs its plain PyTorch version on ragged
                buckets (one warp a pair, and past 32R rows a block of
                warps) under three scoring configs, exact
  3. goldens    Engine(device="cuda") on the vendored SW goldens, exact
  4. main path  the engine on 25,000 pairs of 512bp random DNA + '\\n'
                (seeded), twice: with sw_strips on (the bucket of 520 rows
                takes the strips kernel) and off (the lane-tile kernel);
                for each the wall and both kernels' launch counts read
                around the run, 512 sampled pairs held against the native
                golden model; the two runs equal on all 25,000 pairs
  5. timing     on phase 4's bucket: the lane-tile and the strips kernels
                at every R, each == the plain version on all 28,672 lanes,
                ms per call by CUDA events, slope (t(9) - t(1)) / 8 (the
                plain version by one call), in turns: plain, the lane
                tile and strips at each R ascending, then descending,
                plain; the default R's ms are
                the kernels'; the plain strip sweep of the same bucket
                timed by one call and held against the strips kernel on
                all 28,672 lanes, exact
  6. card       the card's name and power limit from nvidia-smi
  7. phmm kernel PairHMM kernel vs its plain version on ragged batches
                (reads 1-500bp, haplotypes 1-700bp, N runs, a deep-decay
                pair), bitmask and raw codes, mm_div 1 and 3, and on 151bp
                reads against 7-10kbp haplotypes (a stream past 6,144
                rows, timed as in phase 13), within
                1e-4; then every R the build makes on the ragged buckets a
                warp holds at it (with 1-30bp reads, small buckets also cut
                to their rows) and on the deep-decay pairs at every
                rescale period 1-32 in both code forms
  8. phmm golden Engine(device="cuda").pairhmm_file on test.in and 10s.in
                within 1e-4 of the fp64 goldens, and the error above -45
                with the fallback off
  9. phmm main   the engine on 65,536 GATK-shaped jobs (8,192 reads of
                151bp x 8 haplotypes of 300bp, seeded), 256 sampled jobs
                held against the native fp64 model; the kernel's launch
                count is read around this run; then three more runs of
                the engine, each with its stages (job list, offload mask,
                pack, run, unpack, offload, fallback; inside the run the
                copy with the expansion, and the launch) and the cyclic
                garbage collector's pauses timed inside it, beside its
                wall; the stages must sum to within 10% of the wall
 10. phmm time   expansion ms, then on the expanded 65,536-job bucket
                every R at which a warp holds its 160 rows held against
                the plain result, the plain version's ms (one call), and
                each R's ms in turns (ascending, then descending)
 11. long kernel long-read PairHMM kernel vs its plain version on a tile
                of 128 jobs (reads 511-1500bp, haplotypes to 2kbp, N runs,
                a deep-decay pair), mm_div 1 and 3, at every R at which a
                warp holds a strip of 256 rows, within 1e-4; and on reads
                ending on strip seams (a deep-decay one among them) at
                strip widths 256 and 24 (9 strips, two rounds)
 12. long main   the engine on 512 jobs (128 reads of 1,000bp, the
                reference's longest, x 4 haplotypes of 1,200bp, seeded):
                every read is past the lane-tile kernel's 510bp and takes
                the long-read kernel; 64 sampled jobs held against the
                native fp64 model; its launch count is read around this
                run
 13. long time   long-read kernel vs plain ms on one tile of phase 12,
                slope (t(3) - t(1)) / 2 (the plain version by one call,
                first), then each R in turns (8, 16, 32, 32, 16, 8)
 14. sw long     long-pair SW kernel vs its plain versions and the native
                model on a tile of 128 pairs (x 1,023-4,000bp, y to 5kbp,
                an identical pair, a tandem repeat across a strip seam, an
                all-mismatch pair, a one-base pair) under three scoring
                configs, packed at strip widths 64 and 1024, the kernel at
                R = 4, 8 and 16, exact; the plain
                strip sweep at 1024 (under the first config, timed by
                that call) and the plain full-height sweep
                there, and the strip sweep at 64 on a tile a quarter as
                long (x 300-1,100bp, the same special pairs, 18 strips);
                on a tile taller than 4,096 rows (24 pairs, x
                4,200-4,400bp, two sub-strips at every R, a tandem repeat
                across their seam) the kernel at each R == the plain
                full-height sweep == native; kernel vs plain ms on the
                4kbp tile
 15. sw streamed the lane-tile SW kernel on buckets whose stream passes
                6,144 rows (x 30-600bp planted in y of 6-10kbp): kernel at
                every R == plain == native, exact, and kernel (default R,
                slope (t(3) - t(1)) / 2) vs plain (one call) ms on the
                largest bucket, in turns
 16. sw long main  the engine on one tile of 128 pairs of 50,000bp x
                50,000bp random DNA (seeded), one pair identical (score
                50,000): all 128 leave the lane-tile kernel for the
                long-pair kernel, none for the native model; four sampled
                pairs held against the native model; the kernel's launch
                count is read around this run; then pack, copy and kernel
                timed apart, and all 128 scores held against the plain
                full-height sweep of the same packed tile on the card,
                exact, which is timed by that one call
 17. sw mixed    the engine on 2,000 pairs with x of 20-4,000bp in one
                call: buckets under strips_min_nxs rows take the lane-tile
                kernel (or the rotor where its predicate takes them), the
                others the strips kernel, pairs past 1,022bp the long-pair
                kernel; results in input order, 256 sampled pairs ==
                native model, the lane-tile, strips and long-pair launch
                counts move
 18. sw long time  long-pair kernel ms per 50kbp tile at its default
                R, twice, slope (t(3) - t(1)) / 2, each R's scores (4, 8,
                16) == phase 16's, beside phase 16's plain ms on the same
                tile
 19. sw strips   the strips kernel vs its plain strip sweep, the plain
                lane-tile sweep and the native model on ragged buckets of
                136-608 rows (an identical pair, a tandem repeat across
                seams, an all-mismatch pair, a one-base y, an empty y)
                under three scoring configs, at the router's strip width
                and at 88 rows (every last strip re-padded), the kernel at
                its default R and at every R, exact; the plain strip sweep
                at both widths under the default config, and at 88 on the
                first bucket under the other two
 20. sw sweep    kernel GCUPS of the lane-tile and the strips kernels
                at their default R on 4,096 pairs of 32, 64, 128, 256, 512
                and 1,000bp (slope (t(5) - t(1)) / 4, in turns), the
                rotor kernel at rotor_max_slots 1-32 at 32, 64 and
                128bp, the stacked
                kernel at sw_stack 2, 4 and 8 at 32 and 64bp (each at its
                default geometry), the conveyor kernel at max_slots 4 and
                64 at 32, 64 and 128bp, and which kernel the router
                sends each point to; no plain calls
 21. sw rotor    the rotor kernel (both wrappers) vs its plain rotor sweep,
                the plain lane-tile sweep and the native model on ragged
                buckets of 5-135bp at periods 8, 40, 48, 64, 80 and 136
                (the unrolls 8, 8, 24, 32, 16, 8), an identical pair at the
                period's edge, an all-mismatch pair, a one-base y and a
                one-base pair, queues 2 and up to 32 deep, under three
                scoring configs, at its default geometry and at every
                (G, C) the build makes that holds the period (all of them
                at T = 8); and on the queue-leak adversary (tiles of
                identical and of all-mismatch pairs in turns, at T = 64
                and 72) at each, where every all-mismatch pair scores 0;
                exact
 22. rotor main  the engine on 25,000 pairs of 64bp random DNA + '\n'
                (seeded; one bucket of 72 rows, T = 72): with sw_rotor on
                and off, at strips_min_nxs 72 and 73 and at the defaults;
                the three short-pair kernels' launch counts read around
                each run and held to the kernel the predicates pick; 512
                sampled pairs == native model; all runs equal on all
                25,000 pairs
 23. rotor time  on phase 22's bucket: the rotor kernel at the default
                rotor_max_slots at every geometry that holds T = 72 vs its
                plain version, the strips kernel and the lane-tile kernel,
                slope (t(9) - t(1)) / 8, in turns; the plain rotor sweep
                == the kernel on every lane at each; then the default
                geometry at rotor_max_slots 2, 4, 8 and 16, in turns
 24. sw stacked  the stacked kernel vs its plain stacked sweep, the plain
                lane-tile sweep and the native model on ragged buckets of
                8-96 rows and five tiles (an identical pair, an
                all-mismatch pair, a one-base y, a one-base pair) stacked
                2, 3 and 4 deep and as deep as 1,024 rows allow (pad
                tiles, which must score 0), under three scoring configs,
                at its default R and at every R the build makes at which a
                region fits a warp; and on the directed ghost-read
                adversary (256 pairs, S = 2, region 1's x region 0's
                stream) at each, where every pair scores 0; exact
 25. stacked main  the engine on phase 22's pairs with sw_stack 2, 4 and
                8: one stacked launch and no other each (the rotor
                bypassed), 512 sampled pairs == native model, all 25,000
                == the default route's, the wall of each run
 26. stacked time  on phase 22's bucket: the stacked kernel at S = 2, 4
                and 8, each at every R at which a region fits a warp, vs
                its plain version, the rotor and the lane-tile kernel,
                slope (t(9) - t(1)) / 8, in turns; the plain stacked sweep
                == the kernel on every lane at each
 27. sw conveyor the conveyor kernel vs its plain conveyor sweep and the
                native model on ragged short pairs, y past the window
                (T > nxs) and x longer than y (each with an identical, an
                all-mismatch and one-base pairs, half without '\\n'), x
                of at most 5 bases (a window of 8 rows), and on the
                queue-leak adversary (maximum-scoring and all-mismatch
                pairs in turns in every lane's queue, at T = nxs and
                T > nxs, where every all-mismatch pair scores 0), at
                max_slots 1, 2, 4 and 64, and on windows past one warp
                (x to 700 and 1,022 bases, nxs 704 and 1,024, queues two
                deep), under three scoring configs, at the default
                geometry and at every (G, R, W) the build makes that holds
                the window; rows P..P8-1 are 0; exact
 28. conveyor main  the library entry sw_scores_conveyor(device="cuda")
                on phase 22's 25,000 x 64bp pairs at its default 64 slots:
                one conveyor launch (the count read around the call), all
                scores == phase 22's engine scores, 512 sampled pairs ==
                native model; the wall, then pack, copy, kernel and
                copy back with unpack apart (three runs)
 29. conveyor time  on phase 22's pairs packed at max_slots 4, 16 and 64:
                the kernel at its default geometry, slope (t(9) - t(1)) /
                8, in turns, each depth's scores == the engine's; at each
                depth in turns, each == the default on every row: at 4
                slots every geometry that holds the window, at 16 and 64
                G = 1, 2, 4 at their fewest rows (the warp forms that
                geometry() weighs); the block geometries on phase 27's
                1,024-row window, in turns; the
                plain conveyor sweep at 64 slots by one call, == the
                kernel on every row; beside the rotor's time of phase 23,
                GCUPS and the bound
 30. xstrip kernel  the cross-device strip kernel vs its plain block on
                seeded states and halos at w = 24, 25 (a lane stride of
                no whole int4: the state moved one int at a time), 1,024,
                1,032 and 5,000 rows (sub-strip seams) and U = 1, 8, 32
                and 64, contiguous and lane-major in place, under three
                scoring configs, all eight outputs exact; at R = 4, 8 and
                16 on the whole strip and on partial windows (g_lo > 0,
                g_hi < w), in place: the window == the plain block on the
                slice, the rows outside bit for bit the input; one block
                at U = 8,192 (MAX_UNROLL) on 8,000 rows at each R, where
                the prefetch has no room, exact; then the K-strip ring (each strip's
                halo handed to the next a block later, in one process) at
                K = 1, 2, 4 and 8 on the cases of tests/test_xsharded.py
                and phase 14's 4kbp tile: kernel ring == plain ring ==
                native model, exact, K * n_blocks launches each, and the
                ring windowed to the live rows == the plain ring, one
                launch a non-empty window
 31. xshard main  initialize_distributed over NCCL at world size 1 (a free
                localhost port) and ShardedEngine(make_mesh(1, "cuda"),
                xshard_min_len=40,000) on phase 16's tile: all 128 pairs
                take the cross-device path, the launch count read around
                the call is the non-empty live-row windows' (the forward
                windowed by the tile's longest y), all 128 scores == phase
                16's sw_long
                scores, the identical pair 50,000, four sampled == native;
                the wall, then pack, copy and forward apart; then phase
                17's file (== Engine, exact) and phase 9's jobs (within
                1e-5 of Engine, the same fallbacks) through it
 33. default route  the engine on 25,000 pairs of x 100bp + '\n'
                against y 300bp + '\n' (seeded; one bucket of 104 rows
                that strips, the rotor and the stacked kernel decline) at
                the default EngineConfig: the four short-pair kernels'
                launch counts read around the run (the lane tile's only),
                512 sampled pairs == native model; then the bucket's
                lane-tile kernel at every R == its plain version on every
                lane, and each R's ms beside the plain version's, slope
                (t(9) - t(1)) / 8, in turns
 32. xstrip time  the kernel on one full-window block at the 50kbp shape
                (w = 50,008, U = 32), in place, at R = 4, 8 and 16 in
                turns, between two timings of its plain block, slope
                (t(9) - t(1)) / 8, its bound; the kernel and plain rings on the
                4kbp tile at K = 1 by one call each; the forward's wall
                beside phase 18's sw_long time
 34. stream     Engine.sw_scores_stream on bench.py's 100,000 x 512bp
                pairs (seed 0; the first 25,000 are phase 4's) at chunks
                of 65,536 and 25,000, == Engine.sw_scores on all 100,000
                pairs, 512 sampled == native model; on phase 4's pairs at
                6,250 (== phase 4's scores); on phase 22's at 6,250, where
                the rotor is the only kernel launched, once a chunk; and
                Engine.pairhmm_stream on phase 9's jobs regrouped as 128
                batches of 64 reads x 8 haplotypes (the same flat job
                order) at 32, within 1e-6 of Engine.pairhmm on the 128
                batches, with the same fallbacks; each point's walls in
                turns (unchunked, each chunk size, backwards, unchunked),
                each run's pack_s (the stream's wait for its worker),
                exec_s and stages as in phase 9, summing to its wall
 35. cli        python -m genomax_torch in process (one subprocess):
                generate (the defaults), then sw, sw --chunk 128 and a
                subprocess's sw --chunk 100 print the same scores ==
                native; pairhmm 10s.in one-shot, --chunk 16, --chunk 2
                and --resume write the same 3,550 values (within 1e-6;
                1e-4 of the golden), and after a run cut by hand after 3
                batches (a torn line past them) --resume completes the
                same file; --profile on sw_small.in leaves a trace that
                names a port kernel; --devices 1 --xshard 64 --unroll 8
                gives the scores of the run without --xshard, through the
                cross-device kernel
 36. harnesses  python -m genomax_torch in process: parity (the vendored
                goldens, five cases OK, PARITY: PASS); soak --rounds 3
                --seed 20260817 and soak --deep --rounds 4 (a one-rank
                mesh, reads of 2,048-4,096 x haplotypes of 600-2,200)
                pass, the launch counters read around each: strips, the
                rotor, the lane tile, sw_long, the PairHMM tile and the
                long-read kernel each launched, and 3 the fewest rounds
                that launch the first five; bench --lengths 64,512,1024
                --num 25000 (the rotor, strips and sw_long routes) and
                bench --kernel pairhmm at 512 reads x 128 haplotypes of
                151 x 300, every row printed, the 64bp, 512bp and PairHMM
                rows within 0.5-2x of phases 23, 5 and 10's slopes;
                bench-dist --devices 1,2: the 1-device row measures, the
                2-device row is "--"
 37. ladder     the SW transfer ladder (pack/nibble.py): on phase 4's
                and phase 22's buckets the raw, band, nibble and band +
                nibble forms copied and rebuilt on the card == the host
                pack's tensors bit for bit (the nibble forms its codes
                through the bucket's LUT), and make_shipper likewise;
                each form's bytes and its copy + expansion ms by CUDA
                events in turns, the host's build_code_lut and
                nibble_pack by the host clock; the engine walls of phase
                4's, phase 22's and phase 34's 100,000 x 512bp pairs with
                the band (the engine's path) and with the full stream
                (the gate closed), three turns of both forms forward and
                backward, each run's stages as in phase 9 with the stream
                copy inside the run, every score == the one-shot engine's
                of phases 4, 22 and 34, one launch of the strips or rotor
                kernel a run; the medians and spreads; a one-rank
                ShardedEngine with the band == Engine
 38. past 1,024 rows  max_device_len up to 4,096 (tall_phase): the lane
                tile's block form (8 and 16 warps) on buckets of 256
                pairs of 2,048 rows (y of 100-1,000bp, a stream the JAX
                engine keeps resident, and y up to x + 1,000) and 4,096
                rows at every R that 32 warps hold them at, and the strips kernel on
                the same buckets, == the plain lane-tile sweep under two
                configs (the plain strip sweep under one), 8 sampled ==
                native, exact; both kernels' slopes (t(5) - t(1)) / 4 in
                turns and bounds; the PairHMM tile's block form at R = 4,
                5, 6, 8 on phase 12's jobs (1,008 rows) and 256 jobs of
                2,040bp reads (2,048 rows) vs its plain version within
                1e-4, -inf on the same slots, the default R's slope, the
                plain by one call, the bound, beside phase 10's one-warp
                time; engine walls in turns, three each: phase 17's file
                at max_device_len 1,024 (1-4kbp pairs on sw_long) and
                4,096 (on strips), == phase 17's scores, the offloads the
                predicate counts; phase 12's jobs at 1,024 (pairhmm_long)
                and 2,048 (the block form), 64 sampled within 1e-4 of the
                native fp64 model, the same fallback counts
 39. past 4,096 rows  max_device_len with no cap (deep_phase): the lane
                tile's 17-32-warp form on 256 pairs of x 4,100-8,190bp
                (long-read windows) against y of x to x + 1,000bp, three
                buckets of 4,344, 6,144 and 8,192 rows (17, 24 and 32
                warps at R = 8), at every R that 32 warps hold them at,
                and the strips
                kernel on the same buckets, == the plain lane-tile sweep
                (one call a bucket), exact, 8 sampled == native; both
                kernels' slopes (t(5) - t(1)) / 4 in turns and bounds; the
                PairHMM block form on a tile of 128 HaplotypeCaller-shaped
                jobs (reads from their haplotypes with 0.1% substitutions,
                base qualities 30-40) at 4,096 rows (16 warps) and one at
                8,192 rows (32 warps), at every R that 32 warps hold them
                at, vs its plain version (one call a height) within 1e-4,
                -inf on the same slots, the default R's slope and bound;
                engine walls in turns, three each, with RunStats and the
                launch counters: 512 such SW pairs at max_device_len
                4,096 (all on sw_long), 8,192 (strips) and 8,192 with
                sw_strips off (the lane tile), every score equal across
                the three, 8 sampled == native; 256 PairHMM jobs of
                2,100-8,190bp at 4,096 (pairhmm_long) and 16,384 (the
                block form), within 1e-4 of each other, 4 sampled within
                1e-4 of the native fp64 model, the fallback counts; one
                sw_long and one pairhmm_long tile of them timed by slope

Then one JSON line describing each kernel, the card line, and, last,
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result. It imports no jax.
"""

import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# the bucket routes of SW by label, each with its launch counter's route
SW_ROUTES = {"lane tile": "tile", "strips": "strips", "rotor": "rotor",
             "stacked": "stacked"}
N_PAIRS, LEN, SEED = 25000, 512, 0
# PairHMM main path: bench.py's GATK-shaped point, 8,192 reads x 8 haps.
PH_READS, PH_HAPS, PH_READ_LEN, PH_HAP_LEN = 8192, 8, 151, 300
PH_TOL = 1e-4  # log10, the repo's PairHMM tolerance
# Long-read path: the reference's longest read (MAX_READ_LEN 1000).
LR_READS, LR_HAPS, LR_READ_LEN, LR_HAP_LEN = 128, 4, 1000, 1200
# Long-pair SW main path: one tile of 50kbp x 50kbp pairs, the JAX
# package's own long-pair point.
LP_PAIRS, LP_LEN = 128, 50000
# Mixed SW file: x of 20-4,000bp, y up to 1,000bp longer.
MX_PAIRS, MX_X_LENS = 2000, (20, 4000)
# Phase 38: pairs a bucket past 1,024 SW rows, and the PairHMM jobs of
# 2,040bp reads (2,048 rows, the tallest at max_device_len 4,096) as reads x
# phase 12's LR_HAPS haplotypes.
TALL_PAIRS = 256
TALL_READS, TALL_READ_LEN, TALL_HAP_LEN = 64, 2040, 2200
# Phase 39: SW pairs of x 4,100-8,190bp (long-read windows and amplicons),
# 256 for the kernels and 512 for the engine walls; PairHMM tiles of 128
# jobs at 4,096 and 8,192 rows (reads of one ladder level each), and 256
# jobs of 2,100-8,190bp for the engine walls.
DEEP_X, DEEP_PAIRS, DEEP_WALL_PAIRS = (4100, 8190), 256, 512
DEEP_PH_TILES = {4096: (3100, 4090), 8192: (6200, 8190)}
DEEP_PH_JOBS, DEEP_PH_READS = 256, (2100, 8190)
# SW sweep: pairs per point and lengths; the rotor's lengths and queue
# depths (rotor_max_slots).
SWEEP_PAIRS, SWEEP_LENS = 4096, (32, 64, 128, 256, 512, 1000)
ROTOR_LENS, ROTOR_SLOTS = (32, 64, 128), (1, 2, 4, 8, 16, 32)
# Phase 21's x lengths (periods 8-136: at T = 8 every (G, C) the build
# makes holds the period) and phase 23's queue depths on the 64bp bucket.
ROTOR_CHECK_LENS = (7, 39, 47, 63, 79, 135)
ROTOR_MAIN_SLOTS = (2, 4, 8, 16)
# Rotor main path: bench.py's short-pair point, 25,000 x 64bp + '\n'.
RT_PAIRS, RT_LEN = 25000, 64
# Phase 36: the soak's seed (the CLI default) and the fewest rounds with
# which it launches strips, the rotor, the lane tile, sw_long and the
# PairHMM tile (rounds 0, 0, 1, 0 and 2: the routing is the host's, the
# same on the CPU); the deep soak's rounds (0 and 2 sharded, 1 and 3 on
# the long-read kernel); the sweep's lengths and its PairHMM point, phase
# 9's 65,536 jobs of 151 x 300 as 512 reads x 128 haplotypes.
SOAK_SEED, SOAK_ROUNDS, DEEP_ROUNDS = 20260817, 3, 4
BENCH_LENS, BENCH_PH_POINT = (64, 512, 1024), "512,128,151,300"
# Phase 37: the turns of the engine walls with the band and with the full
# stream, each turn both forms forward and backward.
LADDER_TURNS = 3
# The lane tile's default route: short reads against reference windows
# longer than the rotor's period, 25,000 x (100bp + '\n', 300bp + '\n').
DR_PAIRS, DR_X_LEN, DR_Y_LEN = 25000, 100, 300
# Stacked SW: the stack depths of the main path and the sweep (sw_stack),
# the x lengths of phase 24's buckets (8-96 rows), and the most rows a
# stack takes (stack * rows, the TPU kernel's limit, kept).
STACKS, STACK_MAX_X = (2, 4, 8), (6, 14, 30, 46, 62, 70, 94)
MAX_STACK_ROWS = 1024
STACK_LENS = (32, 64)
# Conveyor SW: the queue depths (max_slots) of phase 27's checks, of phase
# 29's timing (the library default, 64, last) and of the sweep's points.
CONVEYOR_CHECK_SLOTS, CONVEYOR_SLOTS = (1, 2, 4, 64), (4, 16, 64)
CONVEYOR_SWEEP_SLOTS = (4, 64)
# The conveyor's windows past one warp (phase 27): x up to 700 and 1,022
# bases (nxs 704 and 1,024), queued two deep.
CONVEYOR_TALL_X, CONVEYOR_TALL_SLOTS = (700, 1022), (2,)
# Cross-device strip kernel: phase 30's strip widths (25: a lane-major
# lane stride of no whole int4; 5,000: two sub-strips) and block lengths, the ring's strip counts; phase 31's
# xshard_min_len, under which phase 16's 50kbp pairs take the cross-device
# path and phase 17's pairs (x up to 4kbp) do not.
XSTRIP_WIDTHS, XSTRIP_UNROLLS = (24, 25, 1024, 1032, 5000), (1, 8, 32, 64)
XSTRIP_RINGS, XS_MIN_LEN = (1, 2, 4, 8), 40000
# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# device memory rate and fp32 rate outside the tensor cores. The int32
# rate is 64 lanes on each of 132 SMs at the SM clock nvidia-smi reports.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SMS, INT32_LANES = 132, 64
# Operations per real cell. SW: the fewest integer instructions a cell
# needs on this card, 7.5: sw_cell.cuh's `sw_cell_dpx_preopen` (the strip
# kernel's form) is P' and Q' one __viaddmax_s32 each, max(P', Q'), D one
# __viaddmax_s32_relu, the substitution a compare, a select and an add,
# and the running best half a three-way max. Phase 1 reads the count as
# compiled along one step of the loops of the six kernels with the DPX
# cell (about 8.5 to 20 a cell with the loop's own code) and fails if
# any falls below it.
# DPX's own issue rate is assumed to be the int32 rate, not published.
# (The plain count, with no fused instruction, is 13: P and Q two adds and
# a max each, compare, select and add, four more maxes.) PairHMM: M three
# multiplies and two adds, X and Y two multiplies and an add each.
SW_OPS_PER_CELL = 7.5
PHMM_FLOPS_PER_CELL = (3 + 2) + (2 + 1) + (2 + 1)
# SASS opcodes of the SW cell's own arithmetic (no moves, loads or stores).
SW_CELL_OPCODES = ("VIADDMNMX", "VIMNMX", "VIMNMX3", "VIADD", "IMAD.IADD",
                   "IADD3", "ISETP", "SEL")
CFGS = [dict(match=1, mismatch=-1, gap_open=-3, gap_extend=-1),
        dict(match=2, mismatch=-3, gap_open=-5, gap_extend=-2),
        dict(match=3, mismatch=-1, gap_open=0, gap_extend=-2)]


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def ragged_pairs(seed):
    """Lengths 1-700 with the trailing '\\n', an empty pair, a lone '\\n'
    and tandem repeats (y holds x again about NXs rows later)."""
    import numpy as np

    from genomax_torch.io.formats import SWPair

    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGT", np.uint8)
    pairs = [SWPair(sx=b"", sy=b""), SWPair(sx=b"\n", sy=b"ACGT\n")]
    for _ in range(600):
        a = rng.choice(abc, int(rng.integers(1, 701))).tobytes() + b"\n"
        b = rng.choice(abc, int(rng.integers(1, 701))).tobytes() + b"\n"
        pairs.append(SWPair(sx=min(a, b, key=len), sy=max(a, b, key=len)))
    for xlen, gap in [(100, 104), (250, 256), (250, 1000), (600, 610)]:
        x = rng.choice(abc, xlen).tobytes()
        junk = rng.choice(abc, gap).tobytes()
        pairs.append(SWPair(sx=x, sy=x + junk + x))
        pairs.append(SWPair(sx=x, sy=x + junk + x + junk + x))
    return pairs


def log10_err(got, want, valid, torch):
    """max |got - want| over the valid slots whose plain result is finite;
    fails unless both are finite at the same slots (pairs too deep for
    fp32 come out -inf in both, and the engine's fallback takes them)."""
    got, want = got.reshape(-1)[valid], want.reshape(-1)[valid]
    fin = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), fin),
          "kernel and plain disagree on which slots are finite")
    return float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0


def load_cases():
    """tests/_phmm_cases.py of this checkout, the seeded PairHMM cases the
    kernel tests use too."""
    import importlib.util

    path = os.path.join(REPO, "tests", "_phmm_cases.py")
    spec = importlib.util.spec_from_file_location("_phmm_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def slope_ms(fn, torch, k=9):
    """Marginal ms of one more back-to-back call: (t(k) - t(1)) / (k - 1),
    each t(n) from CUDA events around n calls."""
    def t(k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    fn()
    torch.cuda.synchronize()
    return (t(k) - t(1)) / (k - 1)


def one_ms(fn, torch):
    """ms of one call after the caller's warm-up, by CUDA events: for the
    plain versions that take seconds, where launch order is no noise."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def native_sw(native, pairs, cfg=None, threads=8):
    """native.sw_scores_native over `threads` slices of pairs at once (the
    library call releases the GIL); the same scores in the same order."""
    import numpy as np

    if len(pairs) <= 1:
        return native.sw_scores_native(pairs, cfg)
    chunks = [pairs[i::threads] for i in range(min(threads, len(pairs)))]
    with concurrent.futures.ThreadPoolExecutor(len(chunks)) as pool:
        parts = list(pool.map(lambda c: native.sw_scores_native(c, cfg),
                              chunks))
    out = np.zeros(len(pairs), np.int32)
    for i, part in enumerate(parts):
        out[i::threads] = part
    return out


@functools.lru_cache(maxsize=None)
def sass_text(lib):
    """cuobjdump -sass of the library `lib` (the CUDA toolkit's, else the
    one Triton carries); phase 1 reads every library's at once."""
    import shutil

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        import triton
        exe = os.path.join(os.path.dirname(triton.__file__), "backends",
                           "nvidia", "bin", "cuobjdump")
    sass = subprocess.run([exe, "-sass", lib], capture_output=True,
                          text=True, timeout=120)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-500:]}")
    return sass.stdout


def sass_functions(lib):
    """{function name: [(address, opcode, branch target or None,
    predicated)]} of the library `lib`, read with cuobjdump -sass."""
    import re

    ins_re = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
    bra_re = re.compile(r"BRA (?:!?U?P\w+, )?(0x[0-9a-f]+)")
    funcs, name = {}, None
    for line in sass_text(lib).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and (m := ins_re.search(line)):
            op = re.sub(r"^@!?U?P\w+\s+", "", m.group(2))
            t = bra_re.search(op)
            funcs[name].append((int(m.group(1), 16), op.split()[0],
                                int(t.group(1), 16) if t else None,
                                m.group(2).startswith("@")))
    return funcs


def sass_blocks(ins):
    """The straight-line blocks of one function's instructions: lists of
    indices, cut at branch targets and after branches, exits and
    barriers."""
    targets = {t for _, _, t, _ in ins if t is not None}
    blocks, cur = [], []
    for n, (a, op, _, _) in enumerate(ins):
        if a in targets and cur:
            blocks.append(cur)
            cur = []
        cur.append(n)
        if op.startswith(("BRA", "EXIT", "BAR")):
            blocks.append(cur)
            cur = []
    return blocks


def sass_phmm_flops(lib, kernel):
    """{(R, *flags): (fp32 flops a cell along one step, cells on the
    path)} of the PairHMM `kernel` in `lib`, flags the lane-tile kernel's
    other template arguments (the bitmask codes; the block form's launch
    bound in warps, 0 for the warp form; none for the long-read kernel's
    instances, whose key is (R, None)).
    In each instance the walk starts from the straight-line block with the
    most FFMAs on a loop that takes no vote and no reducing barrier (the
    cells of the step loop, one step or as many as the compiler unrolled,
    with the block form's seam barrier; a rescale block's last step and
    its votes, a warp's or the block's, lie on the outer loop) and
    takes the shortest path from its end round that loop back to it, so
    that every branch a step may skip (the stream chunk, the first
    diagonal) is skipped and predicated code is counted. Along it FADD
    and FMUL count 1, FFMA 2; the cells are its FFMAs over 3, a cell's
    three fused multiply-adds."""
    import collections
    import re

    flop = {"FADD": 1, "FMUL": 1, "FFMA": 2}
    out = {}
    for name, ins in sass_functions(lib).items():
        m = re.search(kernel + r"I((?:L[ib]\d+E)+)E", name)
        if not m:
            continue
        r, *flags = (int(v) for v in re.findall(r"L[ib](\d+)E", m.group(1)))
        flags = tuple(flags)
        index = {a: n for n, (a, _, _, _) in enumerate(ins)}

        def succ(n):
            _, op, t, cond = ins[n]
            ends = op.startswith(("EXIT", "RET")) or t is not None
            nxt = [n + 1] if (cond or not ends) and n + 1 < len(ins) else []
            return nxt + ([index[t]] if t is not None and t in index else [])

        def cycle(block):
            """The shortest path from the block's end back to its start,
            the block included; None if it lies on no loop."""
            first, last = block[0], block[-1]
            prev, todo = {n: last for n in succ(last)}, collections.deque(
                succ(last))
            while todo and first not in prev:
                n = todo.popleft()
                for q in succ(n):
                    if q not in prev:
                        prev[q] = n
                        todo.append(q)
            if first not in prev:
                return None
            path, n = list(block), prev[first]
            while n != last:
                path.append(n)
                n = prev[n]
            return path

        def op(n):
            return ins[n][1].split(".")[0]

        best = None
        for b in sass_blocks(ins):
            ffma = sum(op(n) == "FFMA" for n in b)
            if ffma >= 3 and (best is None or ffma > best[0]):
                path = cycle(b)
                if path is not None and not any(
                        op(n) == "VOTE" or ins[n][1].startswith("BAR.RED")
                        for n in path):
                    best = (ffma, path)
        check(best is not None, f"{name}: no FFMA block on a loop")
        path = best[1]
        ffma = sum(op(n) == "FFMA" for n in path)
        check(ffma % 3 == 0 and ffma // 3 % r == 0,
              f"{name}: {ffma} FFMAs on one step's path, not 3 x R cells")
        out[(r, *flags) if flags else (r, None)] = (
            sum(flop.get(op(n), 0) for n in path) / (ffma // 3), ffma // 3)
    return out


def sass_cell_ops(lib, kernel, dpx_per_cell):
    """{R: (integer arithmetic instructions a cell, cells a step)} of
    `kernel` in the library `lib`, read with cuobjdump -sass (the CUDA
    toolkit's, else the one Triton carries); {(first, second): ...} where
    the kernel has a second template argument (sw_tile.cu's block form,
    a bool; sw_rotor.cu's (G, C)). In each template instance the
    cell block is the straight-line block with the fewest selects a cell
    and then the most DPX add-max instructions (the unmasked path), of
    the blocks of two cells or more, or of one where the compiler hoisted
    the rest of the step out of every block; from
    it (a loop head on a tie; the next where a walk does not come back)
    the count walks one step of the loop, or the steps the compiler
    unrolled into one turn, forward branches taken (the
    code one thread in a warp or a block runs is skipped) except one that
    jumps past the cell block, the back edge followed round to the cell
    block again. Along that path it counts the opcodes of SW_CELL_OPCODES
    (the loop's own counters and tests among them) and the cells (DPX
    add-max instructions / dpx_per_cell)."""
    import collections
    import re

    funcs = sass_functions(lib)

    def arith(o):
        return o.split(".")[0] in SW_CELL_OPCODES or o in SW_CELL_OPCODES

    out = {}
    for name, ins in funcs.items():
        m = re.search(kernel + r"I((?:L[ib]\d+E)+)E", name)
        if not m:
            continue
        args = [int(v) for v in re.findall(r"L[ib](\d+)E", m.group(1))]
        inst = args[0] if len(args) == 1 else tuple(args)
        index = {a: n for n, (a, _, _, _) in enumerate(ins)}
        heads = {t for a, _, t, _ in ins if t is not None and t <= a}
        found = []
        for least in (2, 1):  # a block of one cell where none holds two
            for b in sass_blocks(ins):
                ops = [ins[n][1] for n in b]
                cells = sum(o.startswith("VIADDMNMX")
                            for o in ops) // dpx_per_cell
                if cells >= least:
                    found.append(((ops.count("SEL") / cells, -cells,
                                   ins[b[0]][0] not in heads), b[0]))
            if found:
                break
        check(bool(found), f"no DPX cell block in {name}")

        def walk(start):
            """The path round the loop from `start`, or None where it does
            not come back."""
            n, seen, path = start, set(), collections.Counter()
            while True:
                if n in seen or ins[n][1] == "EXIT":
                    return None
                seen.add(n)
                a, op, t, cond = ins[n]
                path[op] += 1
                if t is not None and not (cond and a < ins[start][0] < t):
                    n = index[t]
                else:
                    n += 1
                if n == start:
                    return path

        # the best block (a loop head on a tie) whose step comes back
        path = next((p for p in (walk(st) for _, st in sorted(found))
                     if p is not None), None)
        check(path is not None,
              f"{name}: the step from the cell block does not return")
        cells = sum(c for o, c in path.items()
                    if o.startswith("VIADDMNMX")) // dpx_per_cell
        out[inst] = (sum(c for o, c in path.items() if arith(o)) / cells,
                     cells)
    return out


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes, ops, ops_per_s):
    """(least ms the card could take, which limit binds): every input byte
    read once and every output byte written once at the memory rate, or
    the real cells' operations at the peak rate of their type."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


@contextlib.contextmanager
def stage_clock(patches):
    """Times every call of each ``(owner, attribute, name)`` in ``patches``
    while the block runs, and the cyclic garbage collector's pauses: yields
    a dict that ends up holding {name: [s, gc s inside it]} and "gc": [s,
    collections of generation 0, 1, 2] over the whole block. A stage's
    time is its own thread's; the stream's worker stages overlap the
    caller's."""
    t = {"gc": [0.0, 0, 0, 0]}
    gc_at = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_at[0] = time.perf_counter()
        else:
            t["gc"][0] += time.perf_counter() - gc_at[0]
            t["gc"][1 + info["generation"]] += 1

    def timed(name, fn):
        def call(*a, **kw):
            t0, g0 = time.perf_counter(), t["gc"][0]
            try:
                return fn(*a, **kw)
            finally:
                row = t.setdefault(name, [0.0, 0.0])
                row[0] += time.perf_counter() - t0
                row[1] += t["gc"][0] - g0
        return call

    saved = [(owner, attr, owner.__dict__.get(attr)) for owner, attr, _ in
             patches]
    for owner, attr, name in patches:
        setattr(owner, attr, timed(name, getattr(owner, attr)))
    gc.callbacks.append(on_gc)
    try:
        yield t
    finally:
        gc.callbacks.remove(on_gc)
        for owner, attr, old in reversed(saved):
            if old is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)


def stage_line(t, wall, caller, others="worker", whole=True):
    """The stages of one run beside its wall: with ``whole``, the
    caller's-thread stages named in ``caller`` must sum to within 10% of
    the wall (a streamed run's caller also waits for the interpreter lock
    between its stages while the worker packs: that time is in no stage);
    the other stages are printed after ``others``."""
    total = sum(t[k][0] for k in caller if k in t)
    check(not whole or abs(total - wall) <= 0.1 * wall,
          f"the stages sum to {total:.4f} s against a wall of {wall:.4f} s: "
          f"{t}")
    return (f"wall {wall:.4f} s = " + " + ".join(
        f"{k} {t[k][0]:.4f}" for k in caller if k in t)
        + f" (sum {total:.4f}, {total / wall:.3f} of the wall; "
        f"{wall - total:.4f} s in no stage)"
        + "".join(f"; {others} {k} {v[0]:.4f}" for k, v in t.items()
                  if k not in caller and k != "gc")
        + f"; gc {t['gc'][0]:.4f} s in {t['gc'][1]}/{t['gc'][2]}/"
        f"{t['gc'][3]} collections of generation 0/1/2, inside "
        + ", ".join(f"{k} {v[1]:.4f}" for k, v in t.items()
                    if k != "gc" and v[1] > 0))


def engine_stages(eng, kind, streamed):
    """The patches of stage_clock for one run of ``eng``: SW ("sw") or
    PairHMM ("pairhmm"), one-shot or streamed, and the stages that run on
    the caller's thread. The one-shot engine runs every stage on the
    caller's thread; the stream packs (job list, mask, pack) in its
    worker and waits for it (RunStats.pack_s, "wait" here). Both pack
    PairHMM through Engine._phmm_pack, the executor's pack call."""
    from genomax_torch.engine import executor, stream

    mod = stream if streamed else executor
    run = ((stream, "_run_buckets", "run") if streamed else
           (eng, "_sw_run" if kind == "sw" else "_phmm_run", "run"))
    if kind == "sw":
        patches = [(eng, "_sw_offload_mask", "mask"),
                   (mod, "pack_sw_pairs", "pack"), run,
                   (mod, "unpack_scores", "unpack"),
                   (eng, "_sw_offload_post", "offload")]
    else:
        patches = [(mod, "_jobs", "jobs"),
                   (eng, "_phmm_offload_mask", "mask"),
                   (executor, "pack_pairhmm_batches", "pack"), run,
                   (mod, "unpack_scores", "unpack"),
                   (eng, "_phmm_offload_post", "offload"),
                   (eng, "_phmm_fallback", "fallback")]
    names = [name for _, _, name in patches]
    caller = (["wait"] + names[names.index("run"):] if streamed else names)
    return patches, caller


def timed_run(eng, kind, fn, streamed, extra=(), others="worker",
              collect=True):
    """One run of ``fn`` (a call of ``eng``) under stage_clock, with
    ``collect`` after a full collection so that runs in turns start from
    the same collector state: (result, wall s, RunStats, the
    stage_line)."""
    patches, caller = engine_stages(eng, kind, streamed)
    if collect:
        gc.collect()
    with stage_clock(patches + list(extra)) as t:
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
    if streamed:
        t["wait"] = [eng.last_stats.pack_s, 0.0]
    return out, wall, eng.last_stats, stage_line(t, wall, caller, others,
                                                 whole=not streamed)


def stream_phase(sw512, sw64, ph):
    """Phase 34: Engine.sw_scores_stream and Engine.pairhmm_stream against
    the one-shot engine at full width, each streamed wall in turns with
    its unchunked wall. ``sw512`` is phase 4's (pairs, scores), ``sw64``
    phase 22's, ``ph`` phase 9's (batch, values, fallback_jobs). Returns
    the headline's (pairs, one-shot scores), 100,000 x 512bp."""
    import numpy as np

    from genomax_torch import native, trace
    from genomax_torch.engine.executor import Engine
    from genomax_torch.io.formats import PairHMMBatch, SWPair
    from genomax_torch.io.generator import random_dna

    counters = {"lane tile": "tile", "strips": "strips", "rotor": "rotor",
                "stacked": "stacked", "pairhmm": "pairhmm_tile"}

    def turns(label, kind, work, chunks, want, atol=None):
        """The one-shot engine, each chunk size, the chunk sizes again
        backwards, the one-shot engine: every result == ``want`` (within
        ``atol`` for PairHMM, with want's dtype); the walls by chunk size
        (None: unchunked) and each streamed run's launches."""
        eng = Engine(device="cuda")
        walls, launches = {}, []
        for c in [None, *chunks, *reversed(chunks), None]:
            if kind == "sw":
                fn = ((lambda: eng.sw_scores(work)) if c is None else
                      (lambda c=c: eng.sw_scores_stream(work, c)))
            else:
                fn = ((lambda: eng.pairhmm(work)) if c is None else
                      (lambda c=c: eng.pairhmm_stream(work, c)))
            launch0 = trace.counts()
            out, wall, st, line = timed_run(eng, kind, fn, c is not None)
            n = {k: trace.launched(r, launch0) for k, r in counters.items()}
            n = {k: v for k, v in n.items() if v}
            if atol is None:
                check(np.array_equal(out, want),
                      f"{label} at chunk {c}: != the one-shot engine")
            else:
                err = float(np.abs(out - want).max())
                check(out.dtype == want.dtype and err <= atol,
                      f"{label} at chunk {c}: {out.dtype}, max |err| {err}")
            if c is not None:
                launches.append(n)
            walls.setdefault(c, []).append(wall)
            print(f"phase 34 {label}, "
                  f"{'unchunked' if c is None else f'chunk {c}'}: pack_s "
                  f"{st.pack_s:.4f}{'' if c is None else ' (the wait)'}, "
                  f"exec_s {st.exec_s:.4f}, {st.buckets} buckets, launches "
                  f"{json.dumps(n)}; {line}")
        print(f"phase 34 {label} walls in turns, s: " + "; ".join(
            f"{'unchunked' if c is None else f'chunk {c}'} "
            + " / ".join(f"{w:.4f}" for w in ws) for c, ws in walls.items())
            + f"; best streamed / best unchunked "
            + ", ".join(f"{c}: {min(walls[c]) / min(walls[None]):.3f}"
                        for c in chunks))
        return eng.last_stats, launches

    # bench.py's headline, 100,000 x 512bp (seed 0): its first 25,000 pairs
    # are phase 4's
    rng = np.random.default_rng(SEED)
    pairs = [SWPair(sx=random_dna(rng, LEN) + b"\n",
                    sy=random_dna(rng, LEN) + b"\n")
             for _ in range(4 * N_PAIRS)]
    check(pairs[:N_PAIRS] == sw512[0], "the headline's first 25,000 pairs "
          "are not phase 4's")
    eng = Engine(device="cuda")
    want = eng.sw_scores(pairs)
    check(np.array_equal(want[:N_PAIRS], sw512[1]),
          "the 100,000-pair one-shot scores != phase 4's on its pairs")
    # every streamed result below equals want, exactly
    sample = np.random.default_rng(SEED + 11).choice(len(pairs), 512,
                                                     replace=False)
    check(np.array_equal(want[sample], native.sw_scores_native(
        [pairs[i] for i in sample])), "the engine != native model on the "
        "sampled pairs")
    turns(f"sw {len(pairs)} x {LEN}bp", "sw", pairs, [65536, 25000], want)
    headline = (pairs, want)
    turns(f"sw {N_PAIRS} x {LEN}bp (phase 4)", "sw", sw512[0], [6250],
          sw512[1])
    _, launches = turns(f"sw {RT_PAIRS} x {RT_LEN}bp (phase 22)", "sw",
                        sw64[0], [6250], sw64[1])
    check(all(n == {"rotor": 4} for n in launches),
          f"the 64bp stream's launches {launches}: want the rotor's, one a "
          "chunk")
    # phase 9's jobs as 128 batches of 64 reads x 8 haplotypes: the same
    # reads in the same order, so the flat job order is phase 9's
    batch, ph_values, ph_fallbacks = ph
    batches = [PairHMMBatch(reads=batch.reads[i:i + 64],
                            haplotypes=batch.haplotypes)
               for i in range(0, len(batch.reads), 64)]
    check(len(batches) == 128, f"{len(batches)} batches")
    eng = Engine(device="cuda")
    want = eng.pairhmm(batches)
    one_fallbacks = eng.last_stats.fallback_jobs
    err9 = float(np.abs(want - ph_values).max())
    check(err9 <= 1e-6 and one_fallbacks == ph_fallbacks,
          f"128 batches vs phase 9's one batch: max |err| {err9}, "
          f"fallbacks {one_fallbacks} vs {ph_fallbacks}")
    st, _ = turns(f"pairhmm {len(want)} jobs in 128 batches", "pairhmm",
                  batches, [32], want, atol=1e-6)
    check(st.fallback_jobs == one_fallbacks,
          f"streamed fallbacks {st.fallback_jobs} vs {one_fallbacks}")
    print(f"phase 34 pairhmm: one-shot on the 128 batches vs phase 9 max "
          f"|err| {err9:.3g}, {one_fallbacks} fallbacks in every run")
    return headline


def cli_phase(kernels):
    """Phase 35: ``python -m genomax_torch`` on the card, in process (one
    subprocess): generate, sw --chunk, pairhmm --chunk and --resume (also
    after a run cut short by hand), --profile, --unroll under --devices 1
    --xshard. ``kernels`` are the CUDA sources' names (``_build.KERNELS``),
    whose kernels are ``<name>_kernel``."""
    import numpy as np

    from genomax_torch import native, trace
    from genomax_torch.cli.main import main as cli
    from genomax_torch.io.formats import parse_pairhmm_file, parse_sw_file

    golden = os.path.join(REPO, "tests", "golden")

    def run(*argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli(list(argv))
        check(rc == 0, f"genomax_torch {' '.join(argv)}: rc {rc}, "
              f"{err.getvalue()[-600:]}")
        return out.getvalue(), err.getvalue()

    def scores(text):
        return [ln for ln in text.splitlines() if ln.startswith("Score: ")]

    with tempfile.TemporaryDirectory() as d:
        gen = os.path.join(d, "gen.in")
        out, _ = run("generate", gen)
        pairs = parse_sw_file(gen)
        check(len(pairs) == 500 and "(500 alignments)" in out,
              f"generate: {out.strip()}, {len(pairs)} pairs")
        want = scores(run("sw", gen)[0])
        got = scores(run("sw", gen, "--chunk", "128")[0])
        proc = subprocess.run(
            [sys.executable, "-m", "genomax_torch", "sw", gen, "--chunk",
             "100", "--stats"], cwd=REPO, capture_output=True, text=True,
            timeout=300)
        check(proc.returncode == 0, f"python -m genomax_torch sw --chunk: "
              f"{proc.stderr[-600:]}")
        nat = [f"Score: {v}" for v in native_sw(native, pairs)]
        check(want == got == scores(proc.stdout) == nat,
              "sw --chunk != sw != native on the generated file")
        print(f"phase 35 cli generate: {len(pairs)} pairs of 450-500bp; sw, "
              f"sw --chunk 128 and python -m genomax_torch sw --chunk 100 "
              f"print the same {len(want)} scores == native model, stats "
              f"{proc.stderr.strip().splitlines()[-1]}")

        ten = os.path.join(golden, "10s.in")
        batches = parse_pairhmm_file(ten)
        gold = np.loadtxt(os.path.join(golden, "10s.golden.out"))
        outs = {}
        for name, flags in [("one-shot", ()), ("chunk 16", ("--chunk", "16")),
                            ("chunk 2", ("--chunk", "2")),
                            ("resume", ("--resume",))]:
            path = os.path.join(d, name.replace(" ", "") + ".out")
            run("pairhmm", ten, path, *flags)
            with open(path) as f:
                outs[name] = f.read()
        vals = {k: np.array(v.split(), float) for k, v in outs.items()}
        for k, v in vals.items():
            check(v.shape == gold.shape == (3550,)
                  and float(np.abs(v - vals["one-shot"]).max()) <= 1e-6
                  and float(np.abs(v - gold).max()) <= PH_TOL,
                  f"pairhmm 10s.in {k}: {v.shape}, max |err| vs one-shot "
                  f"{float(np.abs(v - vals['one-shot']).max())}")
        # a run cut short by hand after k batches, with a torn line past
        # them: --resume truncates the tail and completes the same file
        res = os.path.join(d, "resume.out")
        k = 3
        n_k = sum(len(b.reads) * len(b.haplotypes) for b in batches[:k])
        with open(res, "w") as f:
            f.writelines(outs["resume"].splitlines(True)[:n_k] + ["-1.0\n"])
        with open(res + ".progress.json", "w") as f:
            json.dump({"input": os.path.abspath(ten),
                       "config": {"gatk_emission": False},
                       "completed_batches": k, "lines": n_k}, f)
        _, err = run("pairhmm", ten, res, "--resume")
        with open(res) as f:
            resumed = f.read()
        check(f"resuming at batch {k}/{len(batches)}" in err
              and resumed == outs["resume"],
              f"--resume after batch {k}: {err.strip()[-300:]}")
        print(f"phase 35 cli pairhmm 10s.in: one-shot, --chunk 16, --chunk 2 "
              f"and --resume write 3,550 values, max |err| vs one-shot "
              + ", ".join(f"{k} {float(np.abs(v - vals['one-shot']).max()):.3g}"
                          for k, v in vals.items() if k != "one-shot")
              + f", vs golden {float(np.abs(vals['one-shot'] - gold).max()):.3g}"
              f"; text identical to one-shot: "
              + ", ".join(f"{k} {v == outs['one-shot']}"
                          for k, v in outs.items() if k != "one-shot")
              + f"; cut after batch {k} ({n_k} lines and a torn one), "
              f"--resume completed the same file")

        prof = os.path.join(d, "profile")
        run("sw", os.path.join(golden, "sw_small.in"), "--profile", prof)
        traces = [os.path.join(r, f) for r, _, fs in os.walk(prof)
                  for f in fs if f.endswith(".json")]
        check(len(traces) == 1, f"--profile wrote {traces}")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        ours = sorted({e["name"] for e in events
                       if e.get("cat") == "kernel"
                       and any(f"{k}_kernel" in e["name"] for k in kernels)})
        check(ours, "the --profile trace names none of the port's kernels: "
              + str(sorted({e["name"] for e in events
                            if e.get("cat") == "kernel"})[:20]))
        print(f"phase 35 cli --profile: {os.path.getsize(traces[0])} bytes, "
              f"{len(events)} events, the port's kernels in it: {ours}")

        rng = np.random.default_rng(SEED + 35)
        abc = np.frombuffer(b"ATGC", np.uint8)
        seqs = [rng.choice(abc, n).tobytes().decode()
                for n in (8, 12, 80, 110, 30, 40, 150, 200, 190, 240)]
        small = os.path.join(d, "xshard.in")
        with open(small, "w") as f:
            f.write(f"{len(seqs)}\n" + "\n".join(seqs) + "\n")
        base = ("sw", small, "--max-device-len", "40")
        want = scores(run(*base)[0])
        launch0 = trace.counts()
        out, err = run(*base, "--devices", "1", "--xshard", "64", "--unroll",
                       "8", "--stats")
        stats = json.loads(err.strip().splitlines()[-1])
        n = trace.launched("xstrip", launch0)
        check(scores(out) == want and stats["xsharded_jobs"] == 3 and n > 0,
              f"--unroll 8 --xshard: {scores(out)} vs {want}, stats {stats}, "
              f"{n} xstrip launches")
        print(f"phase 35 cli --devices 1 --xshard 64 --unroll 8: "
              f"{len(want)} scores == the run without --xshard, "
              f"{stats['xsharded_jobs']} pairs across devices in "
              f"{n} xstrip launches of 8 diagonals")


def harness_phase(slopes):
    """Phase 36: ``parity``, ``soak`` (plain and deep), ``bench`` and
    ``bench-dist`` of ``python -m genomax_torch`` on the card, in process.
    ``slopes`` are phase 23's rotor, phase 5's strips and phase 10's
    PairHMM ms on their main-path buckets, the sweep's rows held within
    0.5-2x of them."""
    from genomax_torch import trace
    from genomax_torch.cli.main import main as cli

    counters = {"strips": "strips", "rotor": "rotor", "lane tile": "tile",
                "sw_long": "sw_long", "pairhmm_tile": "pairhmm_tile",
                "pairhmm_long": "pairhmm_long"}

    class Rounds(io.StringIO):
        """stdout that notes, at each soak round's line, which counters
        are past 0: the round at which each kernel first launched."""

        def __init__(self):
            super().__init__()
            self.first = {}

        def write(self, text):
            if text.startswith("round "):
                rd = int(text.split()[1].rstrip(":"))
                for k, r in counters.items():
                    if trace.launched(r, launch0):
                        self.first.setdefault(k, rd)
            return super().write(text)

    def run(*argv, out=None):
        out, err = out or io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli(list(argv))
        check(rc == 0, f"genomax_torch {' '.join(argv)}: rc {rc}, "
              f"{out.getvalue()[-600:]} {err.getvalue()[-600:]}")
        return out.getvalue(), time.perf_counter() - t0

    launch0 = {}

    def launched():
        """Each route's launches since the last call."""
        nonlocal launch0
        n = {k: trace.launched(r, launch0) for k, r in counters.items()}
        launch0 = trace.counts()
        return n

    text, t = run("parity")
    cases = [ln for ln in text.splitlines()
             if ln.startswith(("SW ", "PairHMM "))]
    check("PARITY: PASS" in text and len(cases) == 5
          and all(": OK (" in ln for ln in cases), f"parity: {text}")
    print(f"phase 36 parity ({t:.1f} s): " + "; ".join(cases)
          + "; PARITY: PASS")

    launched()
    rounds = Rounds()
    text, t = run("soak", "--rounds", str(SOAK_ROUNDS), "--seed",
                  str(SOAK_SEED), out=rounds)
    plain = launched()
    check(text.rstrip().endswith("SOAK PASS"), f"soak: {text[-600:]}")
    text_d, t_d = run("soak", "--deep", "--rounds", str(DEEP_ROUNDS))
    deep = launched()
    check(text_d.rstrip().endswith("DEEP SOAK PASS"),
          f"soak --deep: {text_d[-600:]}")
    missing = [k for k in counters if not plain[k] + deep[k]]
    check(not missing, f"the soaks launched no {missing}: {plain}, {deep}")
    want = [k for k in counters if k != "pairhmm_long"]
    fewest = max(rounds.first.get(k, SOAK_ROUNDS) for k in want) + 1
    check(fewest == SOAK_ROUNDS,
          f"soak --seed {SOAK_SEED}: its kernels first launch at rounds "
          f"{rounds.first}, so {fewest} rounds, not {SOAK_ROUNDS}")
    print(f"phase 36 soak --rounds {SOAK_ROUNDS} --seed {SOAK_SEED} "
          f"({t:.1f} s): SOAK PASS, launches {plain}, first launch by round "
          f"{rounds.first}: {SOAK_ROUNDS} is the fewest rounds that launch "
          f"the five; " + " | ".join(ln for ln in text.splitlines()
                                     if ln.startswith("round ")))
    print(f"phase 36 soak --deep --rounds {DEEP_ROUNDS} ({t_d:.1f} s): "
          f"DEEP SOAK PASS, launches {deep}; " + " | ".join(
              ln for ln in text_d.splitlines() if ln.startswith("round ")))

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sw.json")
        text, t = run("bench", "--lengths", ",".join(map(str, BENCH_LENS)),
                      "--num", str(N_PAIRS), "--json", path)
        with open(path) as f:
            rows = json.load(f)
        path = os.path.join(d, "ph.json")
        text_p, t_p = run("bench", "--kernel", "pairhmm", "--pairhmm-points",
                          BENCH_PH_POINT, "--json", path)
        with open(path) as f:
            ph_rows = json.load(f)
    check([r["length"] for r in rows] == list(BENCH_LENS)
          and [r["routes"] for r in rows] == [["rotor"], ["strips"],
                                              ["sw_long"]]
          and all(r["device"] == "cuda" for r in rows + ph_rows)
          and len(ph_rows) == 1 and ph_rows[0]["pairs"] == PH_READS * PH_HAPS,
          f"bench rows {rows}, {ph_rows}")
    for row in rows:
        print(f"phase 36 bench row: {json.dumps(row)}")
    print(f"phase 36 bench row: {json.dumps(ph_rows[0])}")
    ratios = {}
    for name, ms, ref in (("64bp / phase 23 rotor", rows[0]["elapsed_ms"],
                           slopes["rotor"]),
                          ("512bp / phase 5 strips", rows[1]["elapsed_ms"],
                           slopes["strips"]),
                          ("PairHMM / phase 10", ph_rows[0]["elapsed_ms"],
                           slopes["pairhmm"])):
        ratios[name] = ms / ref
        check(0.5 <= ms / ref <= 2,
              f"bench {name}: {ms:.4f} ms against {ref:.4f} ms, outside "
              "0.5-2x: the sweep times something other than the kernel")
    print(f"phase 36 bench ({t:.1f} s, PairHMM {t_p:.1f} s): the sweep's ms "
          "over the phases' slopes on the same buckets: " + ", ".join(
              f"{k} {v:.3f}" for k, v in ratios.items())
          + " (0.5-2x); " + " | ".join(
              ln.strip() for ln in (text + text_p).splitlines()
              if ln.strip()[:1].isdigit() or "note:" in ln))

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "dist.json")
        text, t = run("bench-dist", "--devices", "1,2", "--num", "2048",
                      "--length", "256", "--json", path)
        with open(path) as f:
            dist_rows = json.load(f)
    lines = text.splitlines()
    check(len(dist_rows) == 1 and dist_rows[0]["devices"] == 1
          and dist_rows[0]["pairs_per_s"] > 0
          and any(ln.split()[:2] == ["2", "--"] for ln in lines)
          and "cannot show scaling" in text,
          f"bench-dist: {text}")
    print(f"phase 36 bench-dist ({t:.1f} s): " + " | ".join(
        ln.strip() for ln in lines))


def tall_phase(mixed, lr_batch, int32_ops, ph_one_warp_ms):
    """Phase 38, past 1,024 rows (max_device_len up to 4,096, as the JAX
    engine runs it). ``mixed`` is phase 17's (pairs, scores), ``lr_batch``
    phase 12's batch, ``ph_one_warp_ms`` phase 10's kernel time. (a) The
    lane tile's block form on buckets of 2,048 rows (8 warps at R = 8; a
    stream the JAX engine keeps resident, y of 100-1,000bp, and one it
    streams, y up to x + 1,000) and 4,096 rows (16 warps, streamed), 256
    pairs each, at every R that 32 warps hold the bucket at, under two
    configs == the plain lane-tile sweep, exact, 8 sampled pairs == native;
    (b) the strips kernel on the same buckets == the same plain sweep, and
    the plain strip sweep under the first config; the two kernels' slopes
    in turns and their bounds; (c) the PairHMM lane tile's block form at
    every R of BLOCK_R on phase 12's jobs (1,008 rows) and 256 jobs of
    2,040bp reads (2,048 rows) against its plain version (finite slots
    within 1e-4, -inf on the same slots), the default R timed, its bound,
    beside phase 10's one-warp time; (d) engine walls in turns, three each:
    phase 17's file at max_device_len 1,024 (the 1-4kbp pairs on sw_long)
    and 4,096 (on strips), every score == phase 17's; phase 12's jobs at 1,024
    (pairhmm_long) and 2,048 (the block form), 64 sampled jobs within 1e-4
    of the native fp64 model at both, the same fallback counts. Returns the
    numbers of the kernels line."""
    import numpy as np
    import torch

    from genomax_torch import native, trace
    from genomax_torch.config import EngineConfig, SWConfig
    from genomax_torch.engine.executor import Engine
    from genomax_torch.io.generator import generate_pairhmm_batch
    from genomax_torch.kernels import pairhmm, sw, sw_strips
    from genomax_torch.kernels.wavefront import (phmm_forward_tiles,
                                                 sw_forward_tiles,
                                                 sw_strips_forward_tiles)
    from genomax_torch.pack import (pack_pairhmm_batches, pack_sw_pairs,
                                    phmm_bucket_to_torch, sw_bucket_to_torch,
                                    sw_strips_to_torch, unpack_scores)

    dev = torch.device("cuda")
    cases = load_cases()
    out = {"sw_tile": {}, "sw_strips": {}, "pairhmm_tile": {},
           "sw_err": 0, "ph_err": 0.0}
    # (a), (b): the SW buckets past 1,024 rows
    for height, y_short in ((2048, True), (2048, False), (4096, False)):
        name = f"{height}-{'resident' if y_short else 'streamed'}"
        pairs = cases.tall_sw_pairs(SEED + 38, height, n_pairs=TALL_PAIRS,
                                    y_short=y_short)
        (b,) = pack_sw_pairs(pairs)
        check(b.sx.shape[1] == height, f"phase 38: bucket {b.sx.shape}")
        t = sw_bucket_to_torch(b, dev)
        prep = sw_strips.prep_bucket_strips(b)
        (_, _, _, nyt), kw = prep
        ts, kw = sw_strips_to_torch(prep, b, dev), dict(kw)
        rs = [r for r in sw.ROWS_PER_THREAD
              if height - 1 <= sw.MAX_WARPS * sw.WARP * r]
        sample = np.random.default_rng(SEED + 38).choice(len(pairs), 8,
                                                         replace=False)
        plain_ms = {}
        for i, c in enumerate(CFGS[:2]):
            cfg = SWConfig(**c)
            held = []
            p_ms = one_ms(lambda: held.append(sw_forward_tiles(*t, cfg)),
                          torch)
            want = held[0]
            plain_ms.setdefault("tile", p_ms)
            for r in rs:
                got = sw.sw_forward(*t, cfg, _rows_per_thread=r)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                out["sw_err"] = max(out["sw_err"], err)
                check(err == 0, f"phase 38: lane tile R = {r} != plain on "
                                f"{name} under {cfg}: {err}")
            got = sw_strips.sw_forward_strips(*ts, ny_max=int(nyt.max()),
                                              cfg=cfg, **kw)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"phase 38: strips != plain lane tile on {name}, {cfg}")
            if i == 0:  # the plain strip sweep, timed by that call
                held = []
                plain_ms["strips"] = one_ms(lambda: held.append(
                    sw_strips_forward_tiles(*ts, cfg=cfg, **kw)), torch)
                check(torch.equal(held[0], want),
                      f"phase 38: plain strip sweep != plain on {name}")
            scores = unpack_scores([b], [want.cpu().numpy()], len(pairs))
            check(np.array_equal(scores[sample], native_sw(
                native, [pairs[j] for j in sample], cfg)),
                  f"phase 38: plain != native on {name}, {cfg}")
        tile = lambda: sw.sw_forward(*t)  # noqa: E731
        strips = lambda: sw_strips.sw_forward_strips(  # noqa: E731
            *ts, ny_max=int(nyt.max()), **kw)
        ms = {"tile": [], "strips": []}
        for key in ("tile", "strips", "strips", "tile"):
            ms[key].append(slope_ms(tile if key == "tile" else strips, torch,
                                    5))
        cells = int(((b.nx - 1).astype(np.int64) * (b.ny - 1)).sum())
        geo = sw.tile_geometry(height)
        for key, tensors in (("tile", t), ("strips", ts)):
            bound = bound_ms(nbytes(*tensors) + 4 * b.nx.size,
                             cells * SW_OPS_PER_CELL, int32_ops)
            k = sum(ms[key]) / 2
            out["sw_tile" if key == "tile" else "sw_strips"][name] = {
                "shape": [TALL_PAIRS, height, int(t[1].shape[1])],
                "ms": k, "plain_ms": plain_ms[key], "bound_ms": bound[0],
                "bound_by": bound[1]}
            print(f"phase 38 {'lane tile' if key == 'tile' else 'strips'} "
                  f"{name}: bucket {tuple(t[0].shape)} stream "
                  f"{tuple(t[1].shape)}"
                  + (f", R = {geo.rows_per_thread}, {geo.warps} warps a pair "
                     f"(every R of {rs} == plain)" if key == "tile" else "")
                  + f": {ms[key][0]:.3f} / {ms[key][1]:.3f} ms in turns, "
                  f"plain {plain_ms[key]:.1f} ms (one call), "
                  f"bound {bound[0]:.4f} ms by {bound[1]} "
                  f"({100 * bound[0] / k:.1f}% of it), GCUPS "
                  f"{cells / k / 1e6:.2f}; == plain under two configs, "
                  "8 sampled == native")
    # (c): the PairHMM block form
    for name, batch in (("1000bp", lr_batch), ("2040bp", generate_pairhmm_batch(
            TALL_READS, LR_HAPS, read_len=TALL_READ_LEN,
            hap_len=TALL_HAP_LEN, seed=SEED + 38, from_haps=True))):
        (b,), _ = pack_pairhmm_batches([batch], byte_quals=True,
                                       factored=True, bitmask_codes=True)
        t = phmm_bucket_to_torch(b, dev)
        valid = torch.from_numpy(b.rl > 0).to(dev)
        want = phmm_forward_tiles(*t, 32, 1.0, True)
        plain_ms = one_ms(lambda: phmm_forward_tiles(*t, 32, 1.0, True),
                          torch)
        errs = {}
        for r in pairhmm.BLOCK_R:
            got = pairhmm.pairhmm_forward(*t, bitmask=True, _rows_per_thread=r)
            errs[r] = log10_err(got, want, valid, torch)
        err = max(errs.values())
        out["ph_err"] = max(out["ph_err"], err)
        check(err <= PH_TOL, f"phase 38: block form != plain on {name}: "
                             f"{errs}")
        # every R checked above; the default R timed, two slopes
        geo = pairhmm.tile_geometry(b.nxs)
        fn = lambda: pairhmm.pairhmm_forward(*t, bitmask=True)  # noqa: E731
        times = {geo.rows_per_thread: [slope_ms(fn, torch),
                                       slope_ms(fn, torch)]}
        k = sum(times[geo.rows_per_thread]) / 2
        cells = int((b.rl.astype(np.int64) * b.hl).sum())
        bound = bound_ms(nbytes(*t) + 4 * b.rl.size,
                         cells * PHMM_FLOPS_PER_CELL, FP32_FLOPS)
        out["pairhmm_tile"][name] = {
            "shape": [int(b.rl.size), b.nxs, int(t[7].shape[1])],
            "rows_per_thread": geo.rows_per_thread, "warps": geo.warps,
            "ms": k, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1],
            "ms_by_r": {r: sum(v) / 2 for r, v in times.items()}}
        print(f"phase 38 phmm block form {name}: bucket {tuple(t[0].shape)} "
              f"stream {tuple(t[7].shape)}, default R = "
              f"{geo.rows_per_thread} ({geo.warps} warps a pair); ms "
              + ", ".join(f"R={r} ({-(-b.nxs // (32 * r))} warps) "
                                   f"{v[0]:.3f} / {v[1]:.3f}"
                                   for r, v in times.items())
              + f"; plain {plain_ms:.1f} ms; bound {bound[0]:.4f} ms by "
              f"{bound[1]} ({100 * bound[0] / k:.1f}% of it), GCUPS "
              f"{cells / k / 1e6:.2f} (cells {cells}); max |dlog10| by R "
              + ", ".join(f"R={r} {e:.3g}" for r, e in errs.items())
              + f", {int(torch.isfinite(want).sum())} finite; phase 10's "
              f"one-warp time {ph_one_warp_ms:.3f} ms")
    # (d): engine walls in turns
    pairs, want = mixed
    walls = {}

    def sw_run(L):
        eng = Engine(EngineConfig(max_device_len=L), device="cuda")
        launch0 = trace.counts()
        t0 = time.perf_counter()
        scores = eng.sw_scores(pairs)
        wall = time.perf_counter() - t0
        check(np.array_equal(scores, want),
              f"phase 38: the mixed file at L = {L} != phase 17's scores")
        n_off = sum(len(p.sx) + 2 > L for p in pairs)
        st = eng.last_stats
        n = tuple(trace.launched(r, launch0)
                  for r in ("tile", "strips", "rotor", "sw_long"))
        check(st.offloaded_jobs == n_off and n[3] == -(-n_off // 128),
              f"phase 38: L = {L}: {st.offloaded_jobs} offloaded, "
              f"{n[3]} sw_long launches, want {n_off}")
        return wall, st.exec_s, n, st

    sample = np.random.default_rng(SEED + 2).choice(len(lr_batch.reads) * LR_HAPS,
                                                   64, replace=False)
    jobs = [(lr_batch.reads[j // LR_HAPS], lr_batch.haplotypes[j % LR_HAPS])
            for j in sample]
    ref = np.array([native.pairhmm_native([type(lr_batch)(
        reads=[rd], haplotypes=[hp])])[0] for rd, hp in jobs])

    def ph_run(L):
        eng = Engine(EngineConfig(max_device_len=L), device="cuda")
        launch0 = trace.counts()
        t0 = time.perf_counter()
        values = eng.pairhmm([lr_batch])
        wall = time.perf_counter() - t0
        err = float(np.abs(values[sample] - ref).max())
        out["ph_err"] = max(out["ph_err"], err)
        check(err <= PH_TOL and bool(np.isfinite(values).all()),
              f"phase 38: phase 12's jobs at L = {L} vs native: {err}")
        n = (trace.launched("pairhmm_tile", launch0),
             trace.launched("pairhmm_long", launch0))
        return wall, eng.last_stats.exec_s, n, eng.last_stats, values

    for kind, run, Ls in (("sw", sw_run, (1024, 4096)),
                          ("phmm", ph_run, (1024, 2048))):
        res = {L: [] for L in Ls}
        for L in (Ls[0], Ls[1], Ls[1], Ls[0], Ls[0], Ls[1]):
            res[L].append(run(L))
        for L in Ls:
            st = res[L][-1][3]
            print(f"phase 38 {kind} engine, max_device_len {L}: walls "
                  + " / ".join(f"{r[0]:.4f}" for r in res[L])
                  + " s in turns, exec_s " + " / ".join(
                      f"{r[1]:.4f}" for r in res[L])
                  + f"; launches {res[L][0][2]} ("
                  + ("lane tile, strips, rotor, sw_long" if kind == "sw"
                     else "pairhmm_tile, pairhmm_long")
                  + f"); stats {json.dumps(st.as_dict())}")
        walls[kind] = {L: sorted(r[0] for r in res[L])[1] for L in Ls}
        if kind == "phmm":
            a, b = (res[L][0][4] for L in Ls)
            fa, fb = (res[L][0][3].fallback_jobs for L in Ls)
            check(fa == fb, f"phase 38: fallback jobs {fa} at L = {Ls[0]}, "
                            f"{fb} at L = {Ls[1]}")
            print(f"phase 38 phmm L = {Ls[0]} vs {Ls[1]}: max |dlog10| "
                  f"{float(np.abs(a - b).max()):.3g} over {len(a)} jobs, "
                  f"fallback jobs {fa} == {fb}, 64 sampled within "
                  f"{PH_TOL} of native at both")
        print(f"phase 38 {kind} engine medians: " + ", ".join(
            f"L = {L} {w:.4f} s" for L, w in walls[kind].items())
            + f" (ratio {walls[kind][Ls[1]] / walls[kind][Ls[0]]:.3f})")
    out["walls"] = walls
    return out


def deep_phase(int32_ops):
    """Phase 39, past 4,096 rows (max_device_len with no cap, as the JAX
    engine takes it). (a) The lane tile's 17-32-warp form: DEEP_PAIRS
    pairs of x 4,100-8,190bp against y of x to x + 1,000bp, which pack into
    three buckets of 4,344, 6,144 and 8,192 rows (17, 24 and 32 warps at
    R = 8), at every R that 32 warps hold them at
    == the plain lane-tile sweep (one call a bucket), exact, 8 sampled ==
    native; the strips kernel on the same buckets == that sweep; both
    kernels' slopes (t(5) - t(1)) / 4 in turns and their bounds. (b) The
    PairHMM block form on a tile of 128 HaplotypeCaller-shaped jobs at
    4,096 rows (16 warps at R = 8) and one at 8,192 (32 warps), every R
    that 32 warps hold them at against the plain version (one call a
    height: finite slots within 1e-4, -inf on the same slots), the default
    R's slope and bound, and pairhmm_long's slope on the same jobs. (c)
    Engine walls in turns, three each, with
    RunStats and the launch counters: DEEP_WALL_PAIRS SW pairs at
    max_device_len 4,096 (sw_long), 8,192 (strips) and 8,192 with
    sw_strips off (the lane tile), equal scores, 8 sampled == native;
    DEEP_PH_JOBS PairHMM jobs at 4,096 (pairhmm_long) and 16,384 (the
    block form), within 1e-4 of each other, 4 sampled within 1e-4 of the
    native fp64 model; one sw_long and one pairhmm_long tile of these
    timed by slope (t(3) - t(1)) / 2. Returns the numbers of the kernels
    line."""
    import numpy as np
    import torch

    from genomax_torch import native, trace
    from genomax_torch.config import EngineConfig
    from genomax_torch.engine.executor import Engine, _jobs
    from genomax_torch.kernels import (pairhmm, pairhmm_long, sw, sw_long,
                                       sw_strips)
    from genomax_torch.kernels.wavefront import (phmm_forward_tiles,
                                                 sw_forward_tiles)
    from genomax_torch.pack import (pack_pairhmm_batches, pack_sw_pairs,
                                    phmm_bucket_to_torch, sw_bucket_to_torch,
                                    sw_strips_to_torch, unpack_scores)

    dev = torch.device("cuda")
    cases = load_cases()
    out = {"sw_tile": {}, "sw_strips": {}, "pairhmm_tile": {},
           "sw_err": 0, "ph_err": 0.0}
    # (a): the lane tile's 17-32-warp form and strips
    pairs = cases.tall_sw_pairs(SEED + 39, 8192, n_pairs=DEEP_PAIRS,
                                x_min=DEEP_X[0], y_less=0)
    buckets = pack_sw_pairs(pairs)
    check(len(buckets) == 3 and buckets[-1].sx.shape[1] == 8192
          and all(sw.tile_geometry(b.sx.shape[1]).warps > 16
                  for b in buckets),
          f"phase 39: buckets {[b.sx.shape for b in buckets]}")
    for b in buckets:
        height = b.sx.shape[1]
        name = f"{height}-rows"
        t = sw_bucket_to_torch(b, dev)
        prep = sw_strips.prep_bucket_strips(b)
        (_, _, _, nyt), kw = prep
        ts, kw = sw_strips_to_torch(prep, b, dev), dict(kw)
        held = []
        plain_ms = one_ms(lambda: held.append(sw_forward_tiles(*t)), torch)
        want = held[0]
        rs = [r for r in sw.ROWS_PER_THREAD
              if height - 1 <= sw.MAX_WARPS * sw.WARP * r]
        for r in rs:
            got = sw.sw_forward(*t, _rows_per_thread=r)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            out["sw_err"] = max(out["sw_err"], err)
            check(err == 0, f"phase 39: lane tile R = {r} != plain on "
                            f"{name}: {err}")
        got = sw_strips.sw_forward_strips(*ts, ny_max=int(nyt.max()), **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"phase 39: strips != plain on {name}")
        scores = unpack_scores([b], [want.cpu().numpy()], len(pairs))
        idx = b.perm[np.random.default_rng(SEED + 39).choice(
            b.n_valid, 8, replace=False)]
        check(np.array_equal(scores[idx], native_sw(
            native, [pairs[j] for j in idx])),
              f"phase 39: plain != native on {name}")
        tile = lambda: sw.sw_forward(*t)  # noqa: E731
        strips = lambda: sw_strips.sw_forward_strips(  # noqa: E731
            *ts, ny_max=int(nyt.max()), **kw)
        ms = {"tile": [], "strips": []}
        for key in ("tile", "strips", "strips", "tile"):
            ms[key].append(slope_ms(tile if key == "tile" else strips, torch,
                                    5))
        cells = int(((b.nx - 1).astype(np.int64) * (b.ny - 1)).sum())
        geo = sw.tile_geometry(height)
        for key, tensors in (("tile", t), ("strips", ts)):
            bound = bound_ms(nbytes(*tensors) + 4 * b.nx.size,
                             cells * SW_OPS_PER_CELL, int32_ops)
            k = sum(ms[key]) / 2
            out["sw_tile" if key == "tile" else "sw_strips"][name] = {
                "shape": [b.n_valid, height, int(t[1].shape[1])],
                "rows_per_thread": geo.rows_per_thread, "warps": geo.warps,
                "ms": k, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1]}
            print(f"phase 39 {'lane tile' if key == 'tile' else 'strips'} "
                  f"{name}: {b.n_valid} pairs, bucket {tuple(t[0].shape)} "
                  f"stream {tuple(t[1].shape)}"
                  + (f", R = {geo.rows_per_thread}, {geo.warps} warps a pair "
                     f"(every R of {rs} == plain)" if key == "tile" else "")
                  + f": {ms[key][0]:.3f} / {ms[key][1]:.3f} ms in turns, "
                  f"the plain lane-tile sweep {plain_ms:.1f} ms (one call), "
                  f"bound {bound[0]:.4f} ms by {bound[1]} "
                  f"({100 * bound[0] / k:.1f}% of it), GCUPS "
                  f"{cells / k / 1e6:.2f}; == plain, 8 sampled == native")
    # (b): the PairHMM block form at 4,096 and 8,192 rows
    for height, lens in DEEP_PH_TILES.items():
        name = f"{height}-rows"
        tile_batches = cases.hc_long_batches(SEED + 39 + height, 128, lens)
        (b,), _ = pack_pairhmm_batches(
            tile_batches, byte_quals=True, factored=True, bitmask_codes=True)
        check(b.nxs == height and b.rl.size == 128,
              f"phase 39: PairHMM bucket {b.nxs} x {b.rl.size}")
        t = phmm_bucket_to_torch(b, dev)
        valid = torch.from_numpy(b.rl > 0).to(dev)
        held = []
        plain_ms = one_ms(lambda: held.append(
            phmm_forward_tiles(*t, 32, 1.0, True)), torch)
        want = held[0]
        rs = [r for r in pairhmm.BLOCK_R
              if -(-height // (32 * r)) <= pairhmm.BLOCK_MAX_WARPS]
        errs = {}
        for r in rs:
            got = pairhmm.pairhmm_forward(*t, bitmask=True, _rows_per_thread=r)
            errs[r] = log10_err(got, want, valid, torch)
        err = max(errs.values())
        out["ph_err"] = max(out["ph_err"], err)
        check(err <= PH_TOL, f"phase 39: block form != plain on {name}: "
                             f"{errs}")
        geo = pairhmm.tile_geometry(height)
        fn = lambda: pairhmm.pairhmm_forward(*t, bitmask=True)  # noqa: E731
        times = [slope_ms(fn, torch), slope_ms(fn, torch)]
        k = sum(times) / 2
        cells = int((b.rl.astype(np.int64) * b.hl).sum())
        bound = bound_ms(nbytes(*t) + 4 * b.rl.size,
                         cells * PHMM_FLOPS_PER_CELL, FP32_FLOPS)
        # the same jobs on the long-read kernel, the route past 8,190bp
        arrays, st = pairhmm_long.pack_pairhmm_long(_jobs(tile_batches))
        tl = [torch.from_numpy(arrays[f]).to(dev)
              for f in ("rchar", "qual", "hap", "meta")]
        lfn = lambda: pairhmm_long.pairhmm_long_forward(  # noqa: E731
            *tl, **st)
        long_ms = sum(slope_ms(lfn, torch, 3) for _ in range(2)) / 2
        out["pairhmm_tile"][name] = {
            "shape": [int(b.rl.size), b.nxs, int(t[7].shape[1])],
            "rows_per_thread": geo.rows_per_thread, "warps": geo.warps,
            "ms": k, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "pairhmm_long_ms": long_ms}
        finite = int(torch.isfinite(want.reshape(-1)[valid.reshape(-1)])
                     .sum())
        print(f"phase 39 phmm block form {name}: reads {lens[0]}-{lens[1]}"
              f"bp, bucket {tuple(t[0].shape)} stream {tuple(t[7].shape)}, "
              f"R = {geo.rows_per_thread} ({geo.warps} warps a pair): "
              f"{times[0]:.3f} / {times[1]:.3f} ms; plain {plain_ms:.1f} ms "
              f"(one call); bound {bound[0]:.4f} ms by {bound[1]} "
              f"({100 * bound[0] / k:.1f}% of it), GCUPS "
              f"{cells / k / 1e6:.2f}; max |dlog10| by R "
              + ", ".join(f"R={r} ({-(-height // (32 * r))} warps) {e:.3g}"
                          for r, e in errs.items())
              + f", {finite} of {int(valid.sum())} finite; the same jobs "
              f"on pairhmm_long {long_ms:.3f} ms")
    # (c): engine walls in turns
    pairs = cases.tall_sw_pairs(SEED + 39 + 1, 8192,
                                n_pairs=DEEP_WALL_PAIRS, x_min=DEEP_X[0],
                                y_less=0)
    sample = np.random.default_rng(SEED + 39 + 1).choice(len(pairs), 8,
                                                         replace=False)
    ref = native_sw(native, [pairs[j] for j in sample])
    routes = {"L4096": (4096, True), "L8192-strips": (8192, True),
              "L8192-tile": (8192, False)}
    n_sw = len(pack_sw_pairs(pairs))
    want_launches = {"L4096": (0, 0, 0, -(-len(pairs) // 128)),
                     "L8192-strips": (0, n_sw, 0, 0),
                     "L8192-tile": (n_sw, 0, 0, 0)}
    first = {}

    def sw_run(route):
        L, strips = routes[route]
        eng = Engine(EngineConfig(max_device_len=L, sw_strips=strips),
                     device="cuda")
        launch0 = trace.counts()
        t0 = time.perf_counter()
        scores = eng.sw_scores(pairs)
        wall = time.perf_counter() - t0
        n = tuple(trace.launched(r, launch0)
                  for r in ("tile", "strips", "rotor", "sw_long"))
        check(n == want_launches[route],
              f"phase 39: {route} launches {n} (lane tile, strips, rotor, "
              f"sw_long), want {want_launches[route]}")
        check(np.array_equal(scores[sample], ref),
              f"phase 39: {route}: 8 sampled != native")
        check(all(np.array_equal(scores, s) for s in first.values()),
              f"phase 39: {route}'s scores != the other routes'")
        first.setdefault(route, scores)
        return wall, eng.last_stats, n

    batches = cases.hc_long_batches(SEED + 39 + 2, DEEP_PH_JOBS,
                                    DEEP_PH_READS)
    ph_sample = np.random.default_rng(SEED + 39 + 2).choice(len(batches), 4,
                                                            replace=False)
    ph_ref = native.pairhmm_native([batches[j] for j in ph_sample])
    ph_first = {}
    n_ph = len(pack_pairhmm_batches(
        batches, byte_quals=True, factored=True, bitmask_codes=True)[0])
    ph_routes = {"L4096": 4096, "L16384": 16384}
    ph_want = {"L4096": (0, -(-len(batches) // 128)), "L16384": (n_ph, 0)}

    def ph_run(route):
        eng = Engine(EngineConfig(max_device_len=ph_routes[route]),
                     device="cuda")
        launch0 = trace.counts()
        t0 = time.perf_counter()
        values = eng.pairhmm(batches)
        wall = time.perf_counter() - t0
        n = (trace.launched("pairhmm_tile", launch0),
             trace.launched("pairhmm_long", launch0))
        check(n == ph_want[route], f"phase 39: {route} launches {n} "
                                   "(pairhmm_tile, pairhmm_long), want "
                                   f"{ph_want[route]}")
        err = float(np.abs(values[ph_sample] - ph_ref).max())
        out["ph_err"] = max(out["ph_err"], err)
        check(err <= PH_TOL and bool(np.isfinite(values).all()),
              f"phase 39: PairHMM at {route} vs native: {err}")
        ph_first.setdefault(route, values)
        return wall, eng.last_stats, n

    walls = {}
    for kind, run, order in (
            ("sw", sw_run, ("L4096", "L8192-strips", "L8192-tile",
                            "L8192-tile", "L8192-strips", "L4096",
                            "L4096", "L8192-strips", "L8192-tile")),
            ("phmm", ph_run, ("L4096", "L16384", "L16384", "L4096",
                              "L4096", "L16384"))):
        res = {}
        for route in order:
            res.setdefault(route, []).append(run(route))
        for route, rs in res.items():
            print(f"phase 39 {kind} engine, {route}: walls "
                  + " / ".join(f"{r[0]:.4f}" for r in rs) + " s in turns, "
                  f"launches {rs[0][2]} ("
                  + ("lane tile, strips, rotor, sw_long" if kind == "sw"
                     else "pairhmm_tile, pairhmm_long")
                  + "); stats " + " | ".join(json.dumps(r[1].as_dict())
                                              for r in rs))
        walls[kind] = {route: sorted(r[0] for r in rs)[1]
                       for route, rs in res.items()}
        print(f"phase 39 {kind} engine medians: " + ", ".join(
            f"{route} {w:.4f} s" for route, w in walls[kind].items()))
    a, b = ph_first["L4096"], ph_first["L16384"]
    d = float(np.abs(a - b).max())
    out["ph_err"] = max(out["ph_err"], d)
    check(d <= PH_TOL, f"phase 39: PairHMM L4096 vs L16384: {d}")
    print(f"phase 39 phmm L4096 vs L16384: max |dlog10| {d:.3g} over "
          f"{len(a)} jobs in {n_ph} buckets at L16384; 4 sampled within "
          f"{PH_TOL} of native at both; SW: every score equal across the "
          f"three routes ({n_sw} buckets at L8192), 8 sampled == native")
    out["walls"] = walls
    # one tile of each long kernel on these jobs, by slope
    _, n, launch = next(sw_long.tile_launches(pairs[:128], device=dev))
    k = sum(slope_ms(launch, torch, 3) for _ in range(2)) / 2
    check(np.array_equal(launch().cpu().numpy()[:n], first["L4096"][:128]),
          "phase 39: the sw_long tile != the engine's scores")
    cells = sum(len(p.sx) * len(p.sy) for p in pairs[:128])
    bound = bound_ms(sum(len(p.sx) + len(p.sy) for p in pairs[:128])
                     + 4 * 128, cells * SW_OPS_PER_CELL, int32_ops)
    out["sw_long"] = {"shape": [128, *DEEP_X], "ms": k,
                      "bound_ms": bound[0], "bound_by": bound[1],
                      "launches": want_launches["L4096"][3]}
    print(f"phase 39 sw_long tile of 128 pairs (x {DEEP_X[0]}-{DEEP_X[1]}"
          f"bp): {k:.3f} ms, bound {bound[0]:.4f} ms by {bound[1]} "
          f"({100 * bound[0] / k:.1f}% of it), GCUPS {cells / k / 1e6:.2f}")
    jobs = _jobs(batches[:128])
    arrays, st = pairhmm_long.pack_pairhmm_long(jobs)
    tl = [torch.from_numpy(arrays[f]).to(dev)
          for f in ("rchar", "qual", "hap", "meta")]
    fn = lambda: pairhmm_long.pairhmm_long_forward(*tl, **st)  # noqa: E731
    k = sum(slope_ms(fn, torch, 3) for _ in range(2)) / 2
    cells = sum(len(rd.bases) * len(hp) for rd, hp in jobs)
    bound = bound_ms(nbytes(*tl) + 4 * 128, cells * PHMM_FLOPS_PER_CELL,
                     FP32_FLOPS)
    out["pairhmm_long"] = {"shape": [128, *DEEP_PH_READS], "ms": k,
                           "bound_ms": bound[0], "bound_by": bound[1],
                           "launches": ph_want["L4096"][1]}
    print(f"phase 39 pairhmm_long tile of 128 jobs (reads "
          f"{DEEP_PH_READS[0]}-{DEEP_PH_READS[1]}bp): {k:.3f} ms, bound "
          f"{bound[0]:.4f} ms by {bound[1]} ({100 * bound[0] / k:.1f}% of "
          f"it), GCUPS {cells / k / 1e6:.2f}")
    return out


def ladder_phase(sw512, sw64, headline):
    """Phase 37: the SW transfer ladder (pack/nibble.py) on the card.
    ``sw512`` is phase 4's (pairs, scores), ``sw64`` phase 22's,
    ``headline`` phase 34's 100,000 x 512bp (pairs, scores). (a) On
    both buckets the raw, band, nibble and band + nibble forms rebuild the
    host pack's tensors bit for bit on the card (the nibble forms its
    remapped codes), and so does make_shipper; (b) each form's copy and
    expansion by CUDA events and its bytes, the host's LUT and nibble pack
    by the host clock (the nibble rung runs on no engine path; these are
    its costs); (c) the engine walls of 25,000 x 512bp, 25,000 x 64bp and
    bench.py's 100,000 x 512bp with the band (the engine) and with the
    full stream (the gate closed) in turns, every score equal to the
    one-shot engine's of phases 4, 22 and 34; (d) a one-rank
    ShardedEngine, which ships the band, equal to Engine."""
    import numpy as np
    import torch

    from genomax_torch import trace
    from genomax_torch.config import EngineConfig
    from genomax_torch.dist.engine import ShardedEngine
    from genomax_torch.dist.mesh import make_mesh
    from genomax_torch.engine.executor import Engine
    from genomax_torch.pack import nibble, tensors
    from genomax_torch.pack.bucketing import pack_sw_pairs

    dev = torch.device("cuda")

    def put(a):
        return torch.from_numpy(a).to(dev)

    def host_s(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    # (a) and (b), bucket by bucket
    for label, pairs in ((f"{N_PAIRS} x {LEN}bp", sw512[0]),
                         (f"{RT_PAIRS} x {RT_LEN}bp", sw64[0])):
        (bf,), t_full = host_s(lambda: pack_sw_pairs(pairs))
        (bb,), t_band = host_s(lambda: pack_sw_pairs(pairs, stream_band=True))
        band = bb.sy.band
        check(np.array_equal(bb.sx, bf.sx)
              and np.array_equal(bb.sy.materialize(), bf.sy),
              f"{label}: the band pack != the full pack on the host")
        lut, t_lut_full = host_s(lambda: nibble.build_code_lut(bf.sx, bf.sy))
        lut_b, t_lut_band = host_s(lambda: nibble.build_code_lut(bf.sx, band))
        check(lut is not None and np.array_equal(lut, lut_b),
              f"{label}: the LUTs of the full and the band forms differ")
        psx, t_psx = host_s(lambda: nibble.nibble_pack(bf.sx, lut))
        psy, t_psy = host_s(lambda: nibble.nibble_pack(bf.sy, lut))
        pband, t_pband = host_s(lambda: nibble.nibble_pack(band, lut))
        packed = {id(bf.sx): psx, id(bf.sy): psy, id(band): pband}

        def dev_ship(a):
            # make_shipper's device side: the copy of the host-packed
            # bytes and the expansion
            return nibble.expand_nibbles(put(packed[id(a)]), a.shape[1])

        raw = (put(bf.sx), put(bf.sy))
        remapped = (put(lut[bf.sx.view(np.uint8)].view(np.int8)),
                    put(lut[bf.sy.view(np.uint8)].view(np.int8)))
        forms = {"raw": (put, bf.sy, bf.sx.nbytes + bf.sy.nbytes, raw),
                 "band": (put, bb.sy, bf.sx.nbytes + band.nbytes, raw),
                 "nibble": (dev_ship, bf.sy, psx.nbytes + psy.nbytes,
                            remapped),
                 "band+nibble": (dev_ship, bb.sy, psx.nbytes + pband.nbytes,
                                 remapped)}
        for name, (ship, sy, _, want) in forms.items():
            got = (ship(bf.sx), nibble.ship_stream(ship, sy))
            check(all(g.dtype == torch.int8 and g.is_contiguous()
                      and torch.equal(g, w) for g, w in zip(got, want)),
                  f"{label}, {name}: the tensors on the card != the host "
                  "pack's")
        shipper = nibble.make_shipper(put, lut=lut)
        for sy in (bf.sy, bb.sy):
            got = (shipper(bf.sx), nibble.ship_stream(shipper, sy))
            check(all(torch.equal(g, w) for g, w in zip(got, remapped)),
                  f"{label}: make_shipper's tensors != the remapped pack")
        check(torch.equal(nibble.expand_nibbles(put(pband), band.shape[1]),
                          put(lut[band.view(np.uint8)].view(np.int8))),
              f"{label}: expand_nibbles != the remapped band")
        del raw, remapped, got
        ms = {name: [] for name in forms}
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        order = list(forms) + list(forms)[::-1] + list(forms)
        for name in order:
            ship, sy = forms[name][:2]
            torch.cuda.synchronize()
            start.record()
            ship(bf.sx)
            nibble.ship_stream(ship, sy)
            end.record()
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(end))
        print(f"phase 37 {label} (NT {bf.sx.shape[0]}, NXs {bf.sx.shape[1]}, "
              f"NDs {bf.sy.shape[1]}, band rows {band.shape[1]} from lo "
              f"{bb.sy.lo}): every form == the host pack on the card, "
              f"bit for bit; copy + expansion by CUDA events, ms in turns: "
              + "; ".join(f"{n} {forms[n][2] / 1e6:.3f} MB "
                          + " / ".join(f"{m:.4f}" for m in ms[n])
                          for n in forms)
              + f"; host s: pack full {t_full:.4f}, pack band {t_band:.4f}, "
              f"build_code_lut (sx, stream) {t_lut_full:.4f}, (sx, band) "
              f"{t_lut_band:.4f}, nibble_pack sx {t_psx:.4f}, stream "
              f"{t_psy:.4f}, band {t_pband:.4f}")
        del forms, packed, bf, bb, band, psx, psy, pband

    # (c) the engine's walls (the band) and the full stream's, in turns
    class FullStream(Engine):
        """The engine with the full stream buffer packed and copied, as
        before the band: the gate closed."""

        def _stream_band(self):
            return False

    counters = {"lane tile": "tile", "strips": "strips", "rotor": "rotor",
                "stacked": "stacked"}
    inside = [(tensors, "ship_stream", "ship_stream")]
    forms = {"band": Engine, "full": FullStream}
    for label, (pairs, want), route in (
            (f"sw {N_PAIRS} x {LEN}bp", sw512, "strips"),
            (f"sw {RT_PAIRS} x {RT_LEN}bp", sw64, "rotor"),
            (f"sw {len(headline[0])} x {LEN}bp", headline, "strips")):
        walls = {name: [] for name in forms}
        for name in [*forms, *list(forms)[::-1]] * LADDER_TURNS:
            eng = forms[name](EngineConfig(), device="cuda")
            launch0 = trace.counts()
            out, wall, st, line = timed_run(
                eng, "sw", lambda: eng.sw_scores(pairs), False, extra=inside,
                others="inside run")
            n = {k: trace.launched(r, launch0) for k, r in counters.items()}
            n = {k: v for k, v in n.items() if v}
            check(np.array_equal(out, want),
                  f"{label}, {name}: scores != the one-shot engine's")
            check(n == {route: 1}, f"{label}, {name}: launches {n}, want one "
                  f"of {route}")
            walls[name].append(wall)
            print(f"phase 37 {label}, {name}: pack_s {st.pack_s:.4f}, exec_s "
                  f"{st.exec_s:.4f}, launches {json.dumps(n)}; {line}")
        med = {k: float(np.median(w)) for k, w in walls.items()}
        spread = {k: max(w) - min(w) for k, w in walls.items()}
        print(f"phase 37 {label} walls in turns, s: " + "; ".join(
            f"{k} " + " / ".join(f"{w:.4f}" for w in ws)
            + f" (median {med[k]:.4f}, spread {spread[k]:.4f})"
            for k, ws in walls.items())
            + f"; band / full medians {med['band'] / med['full']:.3f}")

    # (d) a one-rank ShardedEngine, which ships the band, == Engine
    deng = ShardedEngine(make_mesh(1, device="cuda"), EngineConfig())
    for label, (pairs, want) in (("512bp", sw512), ("64bp", sw64)):
        check(np.array_equal(deng.sw_scores(pairs), want),
              f"ShardedEngine with the band != Engine on {label}")
    print("phase 37 ShardedEngine, one rank, with the band: == Engine on "
          "phase 4's and phase 22's pairs")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="On-card smoke run of "
                                 "genomax_torch (see the module docstring).")
    ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda finds no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from genomax_torch import native, trace
    from genomax_torch.config import (RESCALE_PERIODS, EngineConfig,
                                      PairHMMConfig, SWConfig)
    from genomax_torch.dist import xsharded
    from genomax_torch.dist.engine import ShardedEngine
    from genomax_torch.dist.mesh import initialize_distributed, make_mesh
    from genomax_torch.engine import executor
    from genomax_torch.engine.executor import Engine
    from genomax_torch.io.formats import SWPair
    from genomax_torch.io.generator import generate_pairhmm_batch, random_dna
    from genomax_torch.kernels import (_build, pairhmm, pairhmm_long, sw,
                                       sw_conveyor, sw_long, sw_rotor,
                                       sw_stacked, sw_strips)
    from genomax_torch.kernels.expand import expand_factored
    from genomax_torch.kernels.wavefront import (phmm_forward_tiles,
                                                 phmm_long_forward,
                                                 sw_conveyor_forward_tiles,
                                                 sw_forward_tiles,
                                                 sw_long_forward,
                                                 sw_long_forward_dense,
                                                 sw_rotor_forward_tiles,
                                                 sw_stacked_forward_tiles,
                                                 sw_strips_forward_tiles,
                                                 sw_xstrip_block)
    from genomax_torch.pack import (pack_pairhmm_batches, pack_sw_pairs,
                                    phmm_bucket_to_torch, sw_bucket_to_torch,
                                    sw_rotor_to_torch, sw_stacked_to_torch,
                                    sw_strips_to_torch, unpack_scores)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    clk = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(clk.returncode == 0 and clk.stdout.strip(),
          f"nvidia-smi failed: {clk.stderr.strip()}")
    sm_mhz = float(clk.stdout.split()[0])
    int32_ops = SMS * INT32_LANES * sm_mhz * 1e6  # integer operations / s
    print(f"bounds: {HBM_BYTES_PER_S / 1e12:g} TB/s, fp32 "
          f"{FP32_FLOPS / 1e12:g} TFLOP/s, int32 {SMS} SMs x {INT32_LANES} "
          f"lanes x {sm_mhz:g} MHz = {int32_ops / 1e12:.2f} TOP/s; "
          f"{SW_OPS_PER_CELL} integer operations per SW cell, "
          f"{PHMM_FLOPS_PER_CELL} flops per PairHMM cell")
    max_err = 0
    cases = load_cases()

    # 1. build the kernels, one nvcc each, at once
    t0 = time.perf_counter()
    names = _build.KERNELS
    check(len(names) == 9, f"kernels to build: {names}")
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as pool:
        golden = pool.submit(native.build)
        builds = list(pool.map(_build.build, names))
        print(f"phase 1 build: {os.path.relpath(golden.result(), REPO)}")
    for path, log in builds:
        print(f"phase 1 build: {os.path.relpath(path, REPO)} in "
              f"{time.perf_counter() - t0:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "bytes stack" in line:
                print(f"  ptxas: {line.strip()}")
            elif "Compiling entry" in line:
                print(f"  ptxas: {line.split('for')[0].strip()[-96:]}")
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(sass_text, [path for path, _ in builds]))
    # the DPX cell of the seven kernels that take it, instance by instance
    # (sw_tile's keys (R, form), sw_rotor's (G, C), sw_conveyor's (G, R,
    # block form)); a step holds a whole number of R cells (C for the
    # rotor)
    sass_ops = {}
    for name, kernel, dpx, want, per, label in (
            ("sw_long", "sw_long_kernel", 2, sw_long.ROWS_PER_THREAD, None,
             "R"),
            ("sw_xstrip", "sw_xstrip_kernel", 3, xsharded.ROWS_PER_THREAD,
             None, "R"),
            ("sw_strips", "sw_strips_kernel", 2, sw_strips.ROWS_PER_THREAD,
             None, "R"),
            ("sw_tile", "sw_tile_kernel", 2,
             [(r, f) for r in sw.ROWS_PER_THREAD for f in (0, 1, 2)], 0,
             "(R, form: warp / block of 2-16 / 17-32 warps)"),
            ("sw_rotor", "sw_rotor_kernel", 2, sw_rotor.GEOMETRIES, 1,
             "(G, C)"),
            ("sw_stacked", "sw_stacked_kernel", 2,
             sw_stacked.ROWS_PER_THREAD, None, "R"),
            ("sw_conveyor", "sw_conveyor_kernel", 3,
             sorted({(g, r, int(w > 1))
                     for g, r, w in sw_conveyor.GEOMETRIES}), 1,
             "(G, R, block form)")):
        path = builds[names.index(name)][0]
        sass_ops[name] = sass_cell_ops(path, kernel, dpx)
        check(sorted(sass_ops[name]) == sorted(want),
              f"{name}: SASS instances {sorted(sass_ops[name])}")
        check(all(c % (k if per is None else k[per]) == 0
                  for k, (_, c) in sass_ops[name].items()),
              f"{name}: cells a step by {label} {sass_ops[name]}")
        print(f"phase 1 sass {name}: integer arithmetic a cell along one "
              f"step by {label} " + ", ".join(
                  f"{k}: {n:.2f} over {c} cells" for k, (n, c)
                  in sorted(sass_ops[name].items())))
    fewest = min(n for ops in sass_ops.values() for n, _ in ops.values())
    check(SW_OPS_PER_CELL <= fewest,
          f"SW_OPS_PER_CELL {SW_OPS_PER_CELL}: a kernel's step takes "
          f"{fewest} a cell")
    # the PairHMM cell of the two redesigned kernels, instance by instance
    phmm_flops = {}
    for name, kernel, want in (
            ("pairhmm_tile", "pairhmm_tile_kernel",
             [(r, b, 0) for r in pairhmm.TILE_R for b in (0, 1)]
             + [(r, b, w) for r in pairhmm.BLOCK_R for b in (0, 1)
                for w in pairhmm.block_bounds(r)]),
            ("pairhmm_long", "pairhmm_long_kernel",
             [(r, None) for r in pairhmm_long.LONG_R])):
        flops = sass_phmm_flops(builds[names.index(name)][0], kernel)
        check(sorted(flops, key=str) == sorted(want, key=str),
              f"{name}: SASS instances {sorted(flops, key=str)}")
        phmm_flops[name] = flops

        def by_r(label, rs, variants):
            return label + ": " + ", ".join(
                f"R={r}: " + " / ".join(
                    f"{flops[(r, *v)][0]:.2f} over {flops[(r, *v)][1]} cells"
                    for v in variants) for r in rs)

        if name == "pairhmm_long":
            text = by_r("", pairhmm_long.LONG_R, [(None,)])
        else:
            text = (by_r(" (raw / bitmask codes), warp form", pairhmm.TILE_R,
                         [(0, 0), (1, 0)])
                    + "".join(by_r(f"; block form, launch bound {w} warps",
                                   [r for r in pairhmm.BLOCK_R
                                    if w in pairhmm.block_bounds(r)],
                                   [(0, w), (1, w)])
                              for w in sorted({w for r in pairhmm.BLOCK_R
                                               for w in
                                               pairhmm.block_bounds(r)})))
        print(f"phase 1 sass {name}: fp32 flops a cell along one step of the "
              "loop (FFMA 2) by R" + text)
    fewest = min(f for fl in phmm_flops.values() for f, _ in fl.values())
    check(PHMM_FLOPS_PER_CELL <= fewest,
          f"PHMM_FLOPS_PER_CELL {PHMM_FLOPS_PER_CELL}: a PairHMM step takes "
          f"{fewest} a cell")

    # 2. kernel vs plain version on the card
    pairs = ragged_pairs(1)
    buckets = pack_sw_pairs(pairs)
    for c in CFGS:
        cfg = SWConfig(**c)
        results = []
        for b in buckets:
            sx, sy, nd = sw_bucket_to_torch(b, dev)
            want = sw_forward_tiles(sx, sy, nd, cfg)
            for r in (None, *sw.ROWS_PER_THREAD):  # the default, every R
                got = sw.sw_forward(sx, sy, nd, cfg, _rows_per_thread=r)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                max_err = max(max_err, err)
                check(err == 0, f"kernel (R={r}) != plain on bucket "
                                f"{tuple(sx.shape)} under {cfg}: max |diff| "
                                f"{err}")
            results.append(got.cpu().numpy())
        scores = unpack_scores(buckets, results, len(pairs))
        check(np.array_equal(scores, native.sw_scores_native(pairs, cfg)),
              f"kernel != native model under {cfg}")
        print(f"phase 2 kernel == plain: {len(pairs)} ragged pairs, "
              f"{len(buckets)} buckets of {min(b.sx.shape[1] for b in buckets)}"
              f"-{max(b.sx.shape[1] for b in buckets)} rows, at the default "
              f"R and R = {sw.ROWS_PER_THREAD}, {cfg}, max_abs_err 0")

    # 19. the strips kernel vs its plain versions and the native model
    def strips_inputs(b, strip_w=None):
        prep = sw_strips.prep_bucket_strips(b, strip_w)
        (_, _, _, nyt), st = prep
        return sw_strips_to_torch(prep, b, dev), st, int(nyt.max())

    strips_err = 0
    pairs = cases.strips_sw_pairs(3, x_lens=(126, 600))
    buckets = pack_sw_pairs(pairs)
    big = [i for i, b in enumerate(buckets) if b.sx.shape[1] >= 128]
    check(len(big) >= 4, f"{len(big)} strips buckets")
    t0 = time.perf_counter()
    for ci, c in enumerate(CFGS):
        cfg = SWConfig(**c)
        results, widths = [], set()
        for i, b in enumerate(buckets):
            want = sw_forward_tiles(*sw_bucket_to_torch(b, dev), cfg)
            if i in big:
                for strip_w in (None, 88):
                    t, st, ny_max = strips_inputs(b, strip_w)
                    check(strip_w is None
                          or st["k_strips"] * 88 != b.sx.shape[1],
                          f"strips of 88 fill {b.sx.shape[1]} rows")
                    widths.add(st["strip_w"])
                    got = {f"kernel R={r}": sw_strips.sw_forward_strips(
                        *t, ny_max=ny_max, cfg=cfg, **st, _rows_per_thread=r)
                        for r in (None, *sw_strips.ROWS_PER_THREAD)}
                    if ci == 0 or (strip_w == 88 and i == big[0]):
                        got["plain strip sweep"] = sw_strips_forward_tiles(
                            *t, cfg=cfg, **st)
                    torch.cuda.synchronize()
                    for name, g in got.items():
                        err = int((g.long() - want.long()).abs().max())
                        strips_err = max(strips_err, err)
                        check(err == 0, f"strips ({name}, W={st['strip_w']}) "
                                        f"!= plain lane-tile sweep on bucket "
                                        f"{tuple(b.sx.shape)} under {cfg}: "
                                        f"max |diff| {err}")
            results.append(want.cpu().numpy())
        check(np.array_equal(unpack_scores(buckets, results, len(pairs)),
                             native_sw(native, pairs, cfg)),
              f"strips buckets != native model under {cfg}")
        print(f"phase 19 sw strips kernel == plain == native: {len(pairs)} "
              f"pairs, {len(big)} buckets of "
              f"{min(buckets[i].sx.shape[1] for i in big)}-"
              f"{max(buckets[i].sx.shape[1] for i in big)} rows, strip widths "
              f"{sorted(widths)}, the kernel at the default R and R = "
              f"{sw_strips.ROWS_PER_THREAD}, {cfg}, max_abs_err 0 "
              f"({time.perf_counter() - t0:.1f} s so far)")

    # 21. the rotor kernel vs its plain versions and the native model
    def rotor_inputs(b, max_slots):
        """Phase 21's prep of bucket b at its own period, gate or no gate:
        (xrev, ybuf) on the card and the statics."""
        T = -(-max(int(b.nx.max()), int(b.ny.max())) // 8) * 8
        prep = sw_rotor.prep_bucket_rotor(b, T, max_slots)
        return sw_rotor_to_torch(prep, dev), prep[1]

    def p_rows(full, st):
        """The bucket wrapper's rows of sw_forward_rotor's (NT_r*P8, 128)."""
        p = st["n_slots"]
        return full.view(-1, -(-p // 8) * 8, 128)[:, :p].reshape(-1, 128)

    def rotor_fits(T):
        """Every geometry (G, C) the build makes whose segments hold T."""
        return [g for g in sw_rotor.GEOMETRIES if (32 // g[0]) * g[1] >= T - 1]

    rotor_err, rotor_geos, t0 = 0, set(), time.perf_counter()
    for ci, c in enumerate(CFGS):
        cfg = SWConfig(**c)
        periods, n_buckets, n_pairs, n_runs = set(), 0, 0, 0
        for length in ROTOR_CHECK_LENS:
            pairs = cases.rotor_sw_pairs(10 + length, length)
            buckets = pack_sw_pairs(pairs)
            for max_slots in (2, 32):
                results = []
                for b in buckets:
                    (x, y), st = rotor_inputs(b, max_slots)
                    periods.add((st["period"], st["unroll"]))
                    plain = sw_rotor_forward_tiles(x, y, cfg=cfg, **st)
                    n = -(-b.n_valid // 128)
                    tiles = sw_forward_tiles(*sw_bucket_to_torch(b, dev),
                                             cfg)[:n]
                    # the default geometry first, then every one that fits
                    for geo in (None, *rotor_fits(st["period"])):
                        got = sw_rotor.sw_forward_rotor_bucket(
                            x, y, cfg=cfg, _geometry=geo, **st)
                        full = sw_rotor.sw_forward_rotor(
                            x, y, cfg=cfg, _geometry=geo, **st)
                        torch.cuda.synchronize()
                        for name, g, w in (("kernel", full, plain),
                                           ("bucket wrapper", got,
                                            p_rows(plain, st)),
                                           ("lane tile", got[:n], tiles)):
                            err = int((g.long() - w.long()).abs().max())
                            rotor_err = max(rotor_err, err)
                            check(err == 0, f"rotor {name} != plain on "
                                            f"bucket {tuple(b.sx.shape)}, "
                                            f"{st}, geometry {geo}, {cfg}: "
                                            f"max |diff| {err}")
                        if geo is None:
                            results.append(got.cpu().numpy())
                        rotor_geos.add(geo)
                        n_runs += 2
                check(np.array_equal(unpack_scores(buckets, results,
                                                   len(pairs)),
                                     native_sw(native, pairs, cfg)),
                      f"rotor buckets != native model at {length}bp, "
                      f"{max_slots} slots, {cfg}")
                n_buckets += len(buckets)
            n_pairs += len(pairs)
        # the queue-leak adversary: identical and all-mismatch tiles in
        # turns, queued two deep, at every geometry that holds the period
        for length in (63, 71):
            (b,) = pack_sw_pairs(cases.rotor_leak_pairs(ci, length))
            (x, y), st = rotor_inputs(b, 2)
            check(st["n_slots"] == 2, f"leak queues {st}")
            plain = p_rows(sw_rotor_forward_tiles(x, y, cfg=cfg, **st), st)
            for geo in (None, *rotor_fits(st["period"])):
                got = sw_rotor.sw_forward_rotor_bucket(x, y, cfg=cfg,
                                                       _geometry=geo, **st)
                err = int((got.long() - plain.long()).abs().max())
                rotor_err = max(rotor_err, err)
                check(err == 0 and bool((got[0::2] == length * cfg.match)
                                        .all())
                      and not bool(got[1::2].any()),
                      f"rotor queue leak at T={st['period']}, geometry "
                      f"{geo} under {cfg}: max |diff| {err}, identical "
                      f"{got[0::2].unique().tolist()}, all-mismatch "
                      f"{got[1::2].unique().tolist()}")
                n_runs += 1
        check({u for _, u in periods} == {8, 16, 24, 32},
              f"rotor unrolls {sorted(periods)}")
        check(rotor_geos >= {None, *sw_rotor.GEOMETRIES},
              f"rotor geometries run: {sorted(rotor_geos, key=str)}")
        print(f"phase 21 sw rotor kernel == plain == native: {n_pairs} pairs "
              f"of 7-135bp, {n_buckets} bucket preps at (period, unroll) "
              f"{sorted(periods)}, queues 2 and up to 32 deep, both "
              f"wrappers, at the default geometry and every (G, C) of "
              f"{len(sw_rotor.GEOMETRIES)} that holds the period "
              f"({n_runs} launches); queue leak at T = 64 and 72 at each "
              f"(all-mismatch pairs 0); {cfg}, max_abs_err 0 "
              f"({time.perf_counter() - t0:.1f} s so far)")

    # 24. the stacked kernel vs its plain versions and the native model
    def stacked_inputs(b, stack):
        prep = sw_stacked.prep_bucket_stacked(b, stack)
        check(prep is not None, f"bucket {b.sx.shape} does not stack {stack}")
        return sw_stacked_to_torch(prep, dev), prep[1]

    def stacked_fits(h):
        """Every R the build makes at which a region of h rows fits a
        warp."""
        return [r for r in sw_stacked.ROWS_PER_THREAD
                if -(-(h - 1) // r) <= 32]

    stacked_err, stacked_rs, t0 = 0, set(), time.perf_counter()
    for c in CFGS:
        cfg = SWConfig(**c)
        n_pairs, shapes, n_runs = 0, [], 0
        for max_x in STACK_MAX_X:
            pairs = cases.stacked_sw_pairs(max_x, max_x)
            (b,) = pack_sw_pairs(pairs)
            h, nt = b.sx.shape[1], b.sx.shape[0]
            tiles = sw_forward_tiles(*sw_bucket_to_torch(b, dev), cfg)
            want = native_sw(native, pairs, cfg)
            for stack in (2, 3, 4, MAX_STACK_ROWS // h):
                t, st = stacked_inputs(b, stack)
                plain = sw_stacked_forward_tiles(*t, cfg=cfg, **st)
                for r in (None, *stacked_fits(h)):
                    got = sw_stacked.sw_forward_stacked(
                        *t, cfg=cfg, _rows_per_thread=r, **st)
                    torch.cuda.synchronize()
                    for name, g, w in (("plain stacked sweep", got, plain),
                                       ("plain lane-tile sweep", got[:nt],
                                        tiles)):
                        err = int((g.long() - w.long()).abs().max())
                        stacked_err = max(stacked_err, err)
                        check(err == 0, f"stacked kernel != {name} on "
                                        f"bucket {tuple(b.sx.shape)} at "
                                        f"S={stack}, R={r}, {cfg}: max "
                                        f"|diff| {err}")
                    check(not bool(got[nt:].any()),
                          f"a pad tile scored at S={stack}, h={h}, R={r}")
                    stacked_rs.add(r)
                    n_runs += 1
                    if r is None:
                        got = unpack_scores([b], [got.cpu().numpy()],
                                            len(pairs))
                        check(np.array_equal(got, want),
                              f"stacked kernel != native model at h={h}, "
                              f"S={stack}, {cfg}")
            shapes.append(f"{h} rows at S 2/3/4/{MAX_STACK_ROWS // h}")
            n_pairs += len(pairs)
        # the directed ghost-read adversary: every pair scores 0, at
        # every R
        pairs = cases.stacked_ghost_pairs(47)
        (b,) = pack_sw_pairs(pairs)
        t, st = stacked_inputs(b, 2)
        for r in (None, *stacked_fits(st["h"])):
            got = sw_stacked.sw_forward_stacked(*t, cfg=cfg,
                                                _rows_per_thread=r, **st)
            check(b.sx.shape[0] == 2 and not bool(got.any()),
                  f"ghost reads at R={r} under {cfg}: scores "
                  f"{got.unique().tolist()}")
            n_runs += 1
        check(stacked_rs >= {None, *sw_stacked.ROWS_PER_THREAD},
              f"stacked R run: {sorted(stacked_rs, key=str)}")
        print(f"phase 24 sw stacked kernel == plain == lane tile == native: "
              f"{n_pairs} pairs in buckets of {', '.join(shapes)} (5 tiles, "
              f"pad tiles at S 2, 3, 4), at the default R and every R of "
              f"{sw_stacked.ROWS_PER_THREAD} at which a region fits a warp "
              f"({n_runs} launches); ghost-read adversary (256 pairs, S 2) "
              f"all 0 at each; {cfg}, max_abs_err 0 "
              f"({time.perf_counter() - t0:.1f} s so far)")

    # 27. the conveyor kernel vs its plain version and the native model
    def conveyor_inputs(pairs, max_slots):
        """The pack of pairs at max_slots: the pack, (sched, sy) on the
        card and the wrapper's statics."""
        b = sw_conveyor.pack_sw_conveyor(pairs, max_slots=max_slots)
        return b, (torch.from_numpy(b.sched).to(dev),
                   torch.from_numpy(b.sy).to(dev)), dict(
            nxs=b.nxs, n_slots=b.n_slots, period=b.period, a0=b.a0)

    def conveyor_plain(t, st, cfg=SWConfig()):
        return sw_conveyor_forward_tiles(*t, cfg=cfg,
                                         unroll=sw_conveyor.UNROLL, **st)

    conveyor_cases = {kind: cases.conveyor_sw_pairs(30, kind)
                      for kind in cases.CONVEYOR_KINDS}
    conveyor_cases["leak"] = cases.conveyor_leak_pairs(31, 45, 45)
    conveyor_cases["leak, T > nxs"] = cases.conveyor_leak_pairs(32, 20, 45)
    for x_max in CONVEYOR_TALL_X:
        conveyor_cases[f"tall, x to {x_max}bp"] = cases.conveyor_tall_pairs(
            36, x_max)
    conveyor_err, conveyor_geos, t0 = 0, set(), time.perf_counter()
    for c in CFGS:
        cfg = SWConfig(**c)
        geoms, n_runs = set(), 0
        for name, pairs in conveyor_cases.items():
            want = native_sw(native, pairs, cfg)
            tall = name.startswith("tall")
            for max_slots in (CONVEYOR_TALL_SLOTS if tall
                              else CONVEYOR_CHECK_SLOTS):
                b, t, st = conveyor_inputs(pairs, max_slots)
                geoms.add((st["nxs"], st["period"], st["n_slots"]))
                check(tall == (sw_conveyor.geometry(
                    st["nxs"], 128).warps_per_queue > 1),
                      f"{name}: the default geometry's form at {st}")
                plain = conveyor_plain(t, st, cfg)
                # the default geometry, then every one that holds the window
                for geo in (None, *sw_conveyor.geometries_holding(st["nxs"])):
                    g = sw_conveyor.sw_forward_conveyor(*t, cfg=cfg, **st,
                                                        _geometry=geo)
                    torch.cuda.synchronize()
                    err = int((g.long() - plain.long()).abs().max())
                    conveyor_err = max(conveyor_err, err)
                    check(err == 0, f"conveyor kernel (geometry {geo}) != "
                                    f"plain on {name} at max_slots "
                                    f"{max_slots}, {st}, {cfg}: max |diff| "
                                    f"{err}")
                    if geo is None:
                        got = g
                    conveyor_geos.add(geo)
                    n_runs += 1
                p8 = -(-st["n_slots"] // 8) * 8
                check(not bool(got.view(-1, p8, 128)[:, st["n_slots"]:]
                               .any()),
                      f"conveyor rows past P not 0 on {name}, {st}")
                scores = sw_conveyor.unpack_conveyor(b, got.cpu().numpy(),
                                                     len(pairs))
                check(np.array_equal(scores, want),
                      f"conveyor kernel != native model on {name} at "
                      f"max_slots {max_slots}, {cfg}")
                if name.startswith("leak"):
                    miss = np.array([p.sx.startswith(b"A" * 20)
                                     for p in pairs])
                    check(not scores[miss].any(),
                          f"conveyor queue leak on {name} at max_slots "
                          f"{max_slots}, {cfg}: all-mismatch pairs score "
                          f"{np.unique(scores[miss]).tolist()}")
        check(any(T > nxs for nxs, T, _ in geoms)
              and any(T == nxs for nxs, T, _ in geoms)
              and any(p >= 2 for _, _, p in geoms)
              and max(nxs for nxs, _, _ in geoms) == 1024,
              f"conveyor geometries (nxs, T, P) {sorted(geoms)}")
        check(conveyor_geos >= {None, *sw_conveyor.GEOMETRIES},
              f"conveyor geometries run: {sorted(conveyor_geos, key=str)}")
        shown = ", ".join(f"{k} ({len(v)} pairs)"
                          for k, v in conveyor_cases.items())
        print(f"phase 27 sw conveyor kernel == plain == native: {shown} "
              f"at max_slots {CONVEYOR_CHECK_SLOTS} (the tall ones at "
              f"{CONVEYOR_TALL_SLOTS}), (nxs, T, P) {sorted(geoms)}, at the "
              f"default geometry and every (G, R, W) of "
              f"{len(sw_conveyor.GEOMETRIES)} that holds the window "
              f"({n_runs} launches); rows past P 0, all-mismatch pairs of "
              f"the leak 0; {cfg}, max_abs_err 0 "
              f"({time.perf_counter() - t0:.1f} s so far)")

    # 3. engine on the vendored goldens
    eng = Engine(device="cuda")
    launch0 = trace.counts()
    for name in ("sw_small", "sw_medium", "sw_quirks"):
        got = eng.sw_scores_file(os.path.join(REPO, "tests", "golden",
                                              name + ".in"))
        with open(os.path.join(REPO, "tests", "golden",
                               name + ".golden.out")) as f:
            want = np.array([int(line.split()[1]) for line in f], np.int32)
        check(np.array_equal(got, want), f"engine != golden on {name}")
        print(f"phase 3 golden {name}: {len(got)} scores exact")
    print(f"phase 3 kernel launches: {trace.launched('tile', launch0)}")

    # 4. the main path at full width, with sw_strips on and off
    rng = np.random.default_rng(SEED)
    pairs = [SWPair(sx=random_dna(rng, LEN) + b"\n",
                    sy=random_dna(rng, LEN) + b"\n") for _ in range(N_PAIRS)]
    sample = np.random.default_rng(SEED + 1).choice(N_PAIRS, 512,
                                                    replace=False)
    ref = native.sw_scores_native([pairs[i] for i in sample])
    main = {}
    for on in (True, False):
        e4 = Engine(EngineConfig(sw_strips=on), device="cuda")
        launch0 = trace.counts()
        t0 = time.perf_counter()
        scores = e4.sw_scores(pairs)
        wall = time.perf_counter() - t0
        n_tile, n_strips = (trace.launched("tile", launch0),
                            trace.launched("strips", launch0))
        stats = e4.last_stats
        check(scores.shape == (N_PAIRS,) and scores.dtype == np.int32,
              f"scores of shape {scores.shape} {scores.dtype}")
        check((n_strips if on else n_tile) >= stats.buckets >= 1
              and (n_tile if on else n_strips) == 0,
              f"sw_strips={on}: {n_tile} lane-tile and {n_strips} strips "
              f"launches for {stats.buckets} buckets")
        check(np.array_equal(scores[sample], ref),
              f"sw_strips={on}: engine != native model on the sampled pairs")
        main[on] = (scores, n_tile, n_strips)
        print(f"phase 4 main path, sw_strips={on}: {N_PAIRS} x {LEN}bp+'\\n', "
              f"engine wall {wall:.3f} s, {n_tile} lane-tile and {n_strips} "
              f"strips launches for {stats.buckets} buckets, {len(sample)} "
              f"sampled pairs == native model, "
              f"stats {json.dumps(stats.as_dict())}")
    check(np.array_equal(main[True][0], main[False][0]),
          "sw_strips on and off disagree on the 25,000 pairs")
    launches, strips_launches = main[False][1], main[True][2]
    sw512 = (pairs, main[True][0])
    print(f"phase 4 sw_strips on == off on all {N_PAIRS} pairs")

    # 5. timing on the full-width bucket: both kernels at every R in turns
    (b,) = pack_sw_pairs(pairs)
    sx, sy, nd = sw_bucket_to_torch(b, dev)
    cfg = SWConfig()
    got = sw.sw_forward(sx, sy, nd, cfg)
    want = sw_forward_tiles(sx, sy, nd, cfg)
    err = int((got.long() - want.long()).abs().max())
    max_err = max(max_err, err)
    check(err == 0, f"kernel != plain on the 25k bucket: {err}")
    ts4, st4, ny4 = strips_inputs(b)
    tile_r = sw.tile_geometry(sx.shape[1]).rows_per_thread
    strips_r = sw_strips.geometry(st4["k_strips"] * st4["strip_w"],
                                  ny4).rows_per_thread
    timed = {("lane tile", r): (lambda r=r: sw.sw_forward(
        sx, sy, nd, cfg, _rows_per_thread=r)) for r in sw.ROWS_PER_THREAD}
    timed.update({("strips", r): (lambda r=r: sw_strips.sw_forward_strips(
        *ts4, ny_max=ny4, cfg=cfg, **st4, _rows_per_thread=r))
        for r in sw_strips.ROWS_PER_THREAD})
    for key, fn in timed.items():
        err = int((fn().long() - want.long()).abs().max())
        check(err == 0, f"{key} != plain on the 25k bucket: {err}")
    plain = lambda: sw_forward_tiles(sx, sy, nd, cfg)  # noqa: E731
    by_r = {key: [] for key in timed}
    p1 = one_ms(plain, torch)
    for key in list(timed) + list(timed)[::-1]:
        by_r[key].append(slope_ms(timed[key], torch))
    p2 = one_ms(plain, torch)
    k1, k2 = by_r[("lane tile", tile_r)]
    s1, s2 = by_r[("strips", strips_r)]
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    strips_ms = (s1 + s2) / 2
    tile_ms_by_r = {r: sum(by_r[("lane tile", r)]) / 2
                    for r in sw.ROWS_PER_THREAD}
    strips_ms_by_r = {r: sum(by_r[("strips", r)]) / 2
                      for r in sw_strips.ROWS_PER_THREAD}
    strips = timed[("strips", strips_r)]
    cells = int(((b.nx - 1).astype(np.int64) * (b.ny - 1)).sum())
    sw_bound = bound_ms(nbytes(sx, sy, nd, got), cells * SW_OPS_PER_CELL,
                        int32_ops)
    got4 = strips()
    sw4 = []
    strips_plain_ms = one_ms(lambda: sw4.append(sw_strips_forward_tiles(
        *ts4, cfg=cfg, **st4)), torch)
    err = max(int((got4.long() - sw4[0].long()).abs().max()),
              int((got4.long() - want.long()).abs().max()))
    strips_err = max(strips_err, err)
    check(err == 0, f"strips kernel != plain strip sweep on the 25k bucket: "
                    f"{err}")
    strips_bound = bound_ms(nbytes(*ts4, got4), cells * SW_OPS_PER_CELL,
                            int32_ops)
    for name, geo_r, ms_by in (("lane tile", tile_r, tile_ms_by_r),
                               ("strips", strips_r, strips_ms_by_r)):
        print(f"phase 5 {name} by R (ms, in turns ascending then "
              f"descending; the default R = {geo_r}): " + ", ".join(
                  f"R={r}: {by_r[(name, r)][0]:.3f} / {by_r[(name, r)][1]:.3f}"
                  for r in sorted(ms_by)) + f"; fastest R = "
              f"{min(ms_by, key=ms_by.get)}, every R == plain on all "
              f"{want.numel()} lanes")
    print(f"phase 5 timing, bucket {tuple(sx.shape)} stream "
          f"{tuple(sy.shape)}: kernel (R = {tile_r}, "
          f"{sw.tile_geometry(sx.shape[1]).warps} warps a pair) "
          f"{k1:.3f} / {k2:.3f} ms, plain "
          f"{p1:.3f} / {p2:.3f} ms per call, bound {sw_bound[0]:.4f} ms by "
          f"{sw_bound[1]}; GCUPS kernel "
          f"{cells / kernel_ms / 1e6:.2f}, plain {cells / plain_ms / 1e6:.2f} "
          f"(cells = sum (nx-1)(ny-1) = len(sx) * len(sy) with the '\\n', "
          f"{cells})")
    print(f"phase 5 strips timing, same bucket, {st4['k_strips']} strips of "
          f"{st4['strip_w']} rows, sub-strips of {32 * strips_r} rows (R = "
          f"{strips_r}): strips kernel {s1:.3f} / {s2:.3f} ms per "
          f"call ({cells / strips_ms / 1e6:.2f} GCUPS, "
          f"{kernel_ms / strips_ms:.2f}x the lane-tile kernel's "
          f"{kernel_ms:.3f}), plain strip sweep "
          f"{strips_plain_ms:.1f} ms (one call), == kernel on all "
          f"{got4.numel()} lanes; bound {strips_bound[0]:.4f} ms by "
          f"{strips_bound[1]}")

    # 33. the lane-tile kernel where the default router sends it
    rng = np.random.default_rng(SEED + 9)
    pairs = [SWPair(sx=random_dna(rng, DR_X_LEN) + b"\n",
                    sy=random_dna(rng, DR_Y_LEN) + b"\n")
             for _ in range(DR_PAIRS)]
    sample = np.random.default_rng(SEED + 10).choice(DR_PAIRS, 512,
                                                     replace=False)
    ref = native.sw_scores_native([pairs[i] for i in sample])
    e33 = Engine(device="cuda")
    launch0 = trace.counts()
    t0 = time.perf_counter()
    scores = e33.sw_scores(pairs)
    wall = time.perf_counter() - t0
    n = {k: trace.launched(r, launch0) for k, r in SW_ROUTES.items()}
    check(n["lane tile"] == e33.last_stats.buckets >= 1
          and n["strips"] == n["rotor"] == n["stacked"] == 0,
          f"phase 33: launches {n}, want the lane tile's only")
    dr_launches = n["lane tile"]
    check(np.array_equal(scores[sample], ref),
          "phase 33: engine != native model on the sampled pairs")
    print(f"phase 33 default route: {DR_PAIRS} x ({DR_X_LEN}bp+'\\n', "
          f"{DR_Y_LEN}bp+'\\n') through Engine(device=cuda) at the default "
          f"EngineConfig, engine wall {wall:.3f} s, launches {n}, "
          f"{len(sample)} sampled pairs == native model")
    (b,) = pack_sw_pairs(pairs)
    t = sw_bucket_to_torch(b, dev)
    dr_geo = sw.tile_geometry(b.sx.shape[1])
    want = sw_forward_tiles(*t)
    timed = {r: (lambda r=r: sw.sw_forward(*t, _rows_per_thread=r))
             for r in sw.ROWS_PER_THREAD}
    for r, fn in timed.items():
        err = int((fn().long() - want.long()).abs().max())
        max_err = max(max_err, err)
        check(err == 0, f"phase 33: kernel at R={r} != plain: {err}")
    check(np.array_equal(unpack_scores([b], [want.cpu().numpy()],
                                       DR_PAIRS), scores),
          "phase 33: the plain version != the engine's scores")
    plain = lambda: sw_forward_tiles(*t)  # noqa: E731
    p1 = slope_ms(plain, torch)
    by_r = {r: [] for r in timed}
    for r in list(timed) + list(timed)[::-1]:
        by_r[r].append(slope_ms(timed[r], torch))
    p2 = slope_ms(plain, torch)
    dr_ms = sum(by_r[dr_geo.rows_per_thread]) / 2
    dr_plain_ms = (p1 + p2) / 2
    dr_cells = int(((b.nx - 1).astype(np.int64) * (b.ny - 1)).sum())
    dr_bound = bound_ms(nbytes(*t, want), dr_cells * SW_OPS_PER_CELL,
                        int32_ops)
    print(f"phase 33 default route timing, bucket {tuple(t[0].shape)} "
          f"stream {tuple(t[1].shape)}, R = {dr_geo.rows_per_thread} "
          f"({dr_geo.warps} warp a pair, {dr_geo.pairs} pairs a block): "
          f"kernel {by_r[dr_geo.rows_per_thread][0]:.4f} / "
          f"{by_r[dr_geo.rows_per_thread][1]:.4f} ms "
          f"({dr_cells / dr_ms / 1e6:.2f} GCUPS), plain {p1:.3f} / "
          f"{p2:.3f} ms, == kernel on all {want.numel()} lanes at every R; "
          f"by R (ms, in turns) " + ", ".join(
              f"R={r}: {v[0]:.4f} / {v[1]:.4f}" for r, v in by_r.items())
          + f"; bound {dr_bound[0]:.4f} ms by {dr_bound[1]} (cells "
          f"{dr_cells})")

    # 22. the rotor's main path: 25,000 x 64bp + '\n', one bucket of 72
    # rows, with sw_rotor on and off, at strips_min_nxs 72 (strips first
    # takes the bucket), 73 (the rotor's, if on) and the defaults
    def routed_to(cfg, b):
        if sw_strips.maybe_prep_strips(cfg, b) is not None:
            return "strips"
        if sw_rotor.maybe_prep_rotor(cfg, b) is not None:
            return "rotor"
        if sw_stacked.maybe_prep_stacked(cfg, b) is not None:
            return "stacked"
        return "lane tile"

    rng = np.random.default_rng(SEED + 7)
    pairs = [SWPair(sx=random_dna(rng, RT_LEN) + b"\n",
                    sy=random_dna(rng, RT_LEN) + b"\n")
             for _ in range(RT_PAIRS)]
    (rb,) = pack_sw_pairs(pairs)
    check(rb.sx.shape[1] == 72, f"the 64bp bucket has {rb.sx.shape[1]} rows")
    sample = np.random.default_rng(SEED + 8).choice(RT_PAIRS, 512,
                                                    replace=False)
    ref = native.sw_scores_native([pairs[i] for i in sample])
    runs, rt_scores, rotor_launches = [], None, 0
    for kw in (dict(), dict(sw_rotor=False),
               dict(sw_rotor=True, strips_min_nxs=72),
               dict(sw_rotor=True, strips_min_nxs=73),
               dict(sw_rotor=False, strips_min_nxs=73)):
        cfg22 = EngineConfig(**kw)
        want = routed_to(cfg22, rb)
        e22 = Engine(cfg22, device="cuda")
        launch0 = trace.counts()
        t0 = time.perf_counter()
        scores = e22.sw_scores(pairs)
        wall = time.perf_counter() - t0
        n = {k: trace.launched(r, launch0) for k, r in SW_ROUTES.items()}
        check(scores.shape == (RT_PAIRS,) and scores.dtype == np.int32,
              f"scores of shape {scores.shape} {scores.dtype}")
        check(n[want] == 1 and sum(n.values()) == 1,
              f"{kw}: launches {n}, want one of {want}")
        check(np.array_equal(scores[sample], ref),
              f"{kw}: engine != native model on the sampled pairs")
        check(rt_scores is None or np.array_equal(scores, rt_scores),
              f"{kw}: scores differ from the first run's")
        rt_scores = scores
        if want == "rotor" and not rotor_launches:
            rotor_launches = n["rotor"]
        runs.append(want)
        print(f"phase 22 rotor main path, {kw or 'defaults'}: {RT_PAIRS} x "
              f"{RT_LEN}bp+'\\n', engine wall {wall:.3f} s, launches "
              f"{json.dumps(n)} (the predicates pick {want}), 512 sampled "
              f"pairs == native model, "
              f"stats {json.dumps(e22.last_stats.as_dict())}")
    check(runs.count("rotor") >= 1 and rotor_launches >= 1,
          f"no run of phase 22 took the rotor: {runs}")
    sw64 = (pairs, rt_scores)
    print(f"phase 22 all {len(runs)} runs equal on all {RT_PAIRS} pairs")

    # 23. rotor timing on phase 22's bucket: at the default queue depth
    # every geometry that holds its period, beside the plain sweep, strips
    # and the lane tile, in turns; then the default geometry at each
    # queue depth of ROTOR_MAIN_SLOTS, in turns
    rprep = sw_rotor.maybe_prep_rotor(EngineConfig(sw_rotor=True), rb)
    rx, ry = sw_rotor_to_torch(rprep, dev)
    rst, cfg = rprep[1], SWConfig()
    rt = sw_bucket_to_torch(rb, dev)
    ts22, st22, ny22 = strips_inputs(rb)
    rotor_geo = sw_rotor.geometry(rst["period"], rx.shape[0] * 128)
    rgeos = rotor_fits(rst["period"])
    f_rotor = lambda: sw_rotor.sw_forward_rotor_bucket(  # noqa: E731
        rx, ry, cfg=cfg, **rst)
    f_geo = {g: (lambda g=g: sw_rotor.sw_forward_rotor_bucket(
        rx, ry, cfg=cfg, _geometry=g, **rst)) for g in rgeos}
    f_plain = lambda: sw_rotor_forward_tiles(  # noqa: E731
        rx, ry, cfg=cfg, **rst)
    f_strips = lambda: sw_strips.sw_forward_strips(  # noqa: E731
        *ts22, ny_max=ny22, cfg=cfg, **st22)
    f_tile = lambda: sw.sw_forward(*rt, cfg)  # noqa: E731
    got = f_rotor()
    n_live = -(-rb.n_valid // 128)
    for name, w in ([("plain", p_rows(f_plain(), rst)),
                     ("strips", f_strips()[:n_live]),
                     ("lane tile", f_tile()[:n_live])]
                    + [(f"geometry {g}", f()) for g, f in f_geo.items()]):
        err = int((got[:len(w)].long() - w.long()).abs().max())
        rotor_err = max(rotor_err, err)
        check(err == 0, f"rotor != {name} on the 64bp bucket: {err}")
    order = [f_plain, *f_geo.values(), f_strips, f_tile]
    times = [slope_ms(f, torch) for f in order + order[::-1]]
    pairs_ms = list(zip(times[:len(order)], times[len(order):][::-1]))
    (rp1, rp2), (s1, s2), (k1, k2) = (pairs_ms[0], pairs_ms[-2],
                                      pairs_ms[-1])
    rotor_ms_by_geo = {f"G{g}C{c}": list(ab)
                       for (g, c), ab in zip(rgeos, pairs_ms[1:-2])}
    dkey = f"G{rotor_geo.queues_per_warp}C{rotor_geo.cols}"
    r1, r2 = rotor_ms_by_geo[dkey]
    rotor_ms, rotor_plain_ms = (r1 + r2) / 2, (rp1 + rp2) / 2
    rt_cells = int(((rb.nx - 1).astype(np.int64) * (rb.ny - 1)).sum())
    rotor_bound = bound_ms(nbytes(rx, ry, got), rt_cells * SW_OPS_PER_CELL,
                           int32_ops)
    fastest = min(rotor_ms_by_geo, key=lambda k: sum(rotor_ms_by_geo[k]))
    print(f"phase 23 rotor timing, bucket {tuple(rt[0].shape)} as "
          f"{rx.shape[0]} rotor tiles x {rst['n_slots']} slots, T "
          f"{rst['period']} (rotor_max_slots "
          f"{EngineConfig().rotor_max_slots}), default geometry {dkey} "
          f"({rotor_geo.warps_per_block} warps a block): rotor {r1:.4f} / "
          f"{r2:.4f} ms ({rt_cells / rotor_ms / 1e6:.2f} GCUPS), plain "
          f"rotor sweep {rp1:.3f} / {rp2:.3f} ms, strips {s1:.4f} / "
          f"{s2:.4f} ms ({rt_cells / ((s1 + s2) / 2) / 1e6:.2f} GCUPS), "
          f"lane tile {k1:.4f} / {k2:.4f} ms "
          f"({rt_cells / ((k1 + k2) / 2) / 1e6:.2f} GCUPS); rotor "
          f"{(s1 + s2) / 2 / rotor_ms:.2f}x strips, "
          f"{(k1 + k2) / 2 / rotor_ms:.2f}x the lane tile; by geometry "
          f"(ms, in turns) " + ", ".join(
              f"{k}: {a:.4f} / {b:.4f}" for k, (a, b)
              in rotor_ms_by_geo.items())
          + f"; fastest {fastest}; bound {rotor_bound[0]:.4f} ms by "
          f"{rotor_bound[1]} (cells {rt_cells}); kernel == plain == strips "
          f"== lane tile on every live lane at every geometry")
    f_slots = {}
    for slots in ROTOR_MAIN_SLOTS:
        sp_ = sw_rotor.maybe_prep_rotor(
            EngineConfig(sw_rotor=True, rotor_max_slots=slots), rb)
        sxy = sw_rotor_to_torch(sp_, dev)
        f = (lambda sxy=sxy, st=sp_[1]: sw_rotor.sw_forward_rotor_bucket(
            *sxy, cfg=cfg, **st))
        check(torch.equal(f()[:n_live], got[:n_live]),
              f"rotor at {slots} slots differs on the 64bp bucket")
        f_slots[slots] = (f, sxy[0].shape[0], sp_[1]["n_slots"],
                          sw_rotor.geometry(sp_[1]["period"],
                                            sxy[0].shape[0] * 128))
    times = [slope_ms(f_slots[k][0], torch)
             for k in ROTOR_MAIN_SLOTS + ROTOR_MAIN_SLOTS[::-1]]
    n_sl = len(ROTOR_MAIN_SLOTS)
    rotor_ms_by_slots = {k: (times[i], times[2 * n_sl - 1 - i])
                         for i, k in enumerate(ROTOR_MAIN_SLOTS)}
    print("phase 23 rotor by rotor_max_slots on the same bucket (ms, in "
          "turns): " + "; ".join(
              f"{k} ({f_slots[k][1]} tiles x {f_slots[k][2]}, "
              f"G{f_slots[k][3].queues_per_warp}C{f_slots[k][3].cols}): "
              f"{a:.4f} / {b:.4f}" for k, (a, b)
              in rotor_ms_by_slots.items()) + "; each == the default's")

    # 25. the stacked route on phase 22's pairs: sw_stack 2, 4 and 8 send
    # the bucket to the stacked kernel and bypass the rotor
    stacked_launches = {}
    for stack in STACKS:
        cfg25 = EngineConfig(sw_stack=stack)
        check(routed_to(cfg25, rb) == "stacked",
              f"sw_stack={stack}: the predicates pick {routed_to(cfg25, rb)}")
        e25 = Engine(cfg25, device="cuda")
        launch0 = trace.counts()
        t0 = time.perf_counter()
        scores = e25.sw_scores(pairs)
        wall = time.perf_counter() - t0
        n = {k: trace.launched(r, launch0) for k, r in SW_ROUTES.items()}
        check(n == {"lane tile": 0, "strips": 0, "rotor": 0, "stacked": 1},
              f"sw_stack={stack}: launches {n}")
        check(scores.shape == (RT_PAIRS,) and scores.dtype == np.int32,
              f"scores of shape {scores.shape} {scores.dtype}")
        check(np.array_equal(scores[sample], ref),
              f"sw_stack={stack}: engine != native model on the sampled "
              f"pairs")
        check(np.array_equal(scores, rt_scores),
              f"sw_stack={stack}: scores differ from the default route's")
        stacked_launches[stack] = n["stacked"]
        print(f"phase 25 stacked main path, sw_stack={stack}: {RT_PAIRS} x "
              f"{RT_LEN}bp+'\\n', engine wall {wall:.3f} s, launches "
              f"{json.dumps(n)}, 512 sampled pairs == native model, == the "
              f"default route on all {RT_PAIRS} pairs, "
              f"stats {json.dumps(e25.last_stats.as_dict())}")

    # 26. stacked timing on phase 22's bucket at S = 2, 4, 8, each at
    # every R at which a region fits a warp, beside its plain version,
    # the rotor and the lane tile, in turns
    f_stk, f_stp, stk_in = {}, {}, {}
    for stack in STACKS:
        t, st = stacked_inputs(rb, stack)
        stk_in[stack] = (t, st, sw_stacked.geometry(stack, st["h"]))
        f_stp[stack] = (lambda t=t, st=st: sw_stacked_forward_tiles(
            *t, **st))
        want = f_stp[stack]()
        check(torch.equal(want[:n_live], f_tile()[:n_live]),
              f"plain stacked (S={stack}) != lane tile on the 64bp bucket")
        for r in (None, *stacked_fits(st["h"])):
            f = (lambda t=t, st=st, r=r: sw_stacked.sw_forward_stacked(
                *t, _rows_per_thread=r, **st))
            err = int((f().long() - want.long()).abs().max())
            stacked_err = max(stacked_err, err)
            check(err == 0, f"stacked (S={stack}, R={r}) != plain on the "
                            f"64bp bucket: {err}")
            if r is not None:
                f_stk[(stack, r)] = f
    order = ([f_stp[k] for k in STACKS] + list(f_stk.values())
             + [f_rotor, f_tile])
    times = [slope_ms(f, torch) for f in order + order[::-1]]
    half = len(order)
    pairs_ms = [(a, b) for a, b in zip(times[:half], times[half:][::-1])]
    n_s = len(STACKS)
    stp_ms = {k: pairs_ms[i] for i, k in enumerate(STACKS)}
    stk_by = {k: pairs_ms[n_s + i] for i, k in enumerate(f_stk)}
    stk_ms = {k: stk_by[(k, stk_in[k][2].rows_per_thread)] for k in STACKS}
    r26, k26 = pairs_ms[-2], pairs_ms[-1]

    def mean(ab):
        return (ab[0] + ab[1]) / 2

    stacked_ms, stacked_plain_ms = mean(stk_ms[4]), mean(stp_ms[4])
    stacked_ms_by_geo = {f"S{k}R{r}": list(v) for (k, r), v in stk_by.items()}
    best = min(stk_by, key=lambda k: mean(stk_by[k]))
    r4 = stk_in[4][2].rows_per_thread
    stacked_bound = bound_ms(nbytes(*stk_in[4][0], f_stk[(4, r4)]()),
                             rt_cells * SW_OPS_PER_CELL, int32_ops)
    print(f"phase 26 stacked timing, bucket {tuple(rt[0].shape)}: "
          + "; ".join(
              f"S={k} ({stk_in[k][0][0].shape[0]} stacked tiles, default R "
              f"{stk_in[k][2].rows_per_thread}, "
              f"{stk_in[k][2].warps_per_stack} warp(s) a stack) kernel "
              f"{stk_ms[k][0]:.4f} / {stk_ms[k][1]:.4f} ms "
              f"({rt_cells / mean(stk_ms[k]) / 1e6:.2f} GCUPS), plain "
              f"{stp_ms[k][0]:.3f} / {stp_ms[k][1]:.3f} ms"
              for k in STACKS)
          + "; by S and R (ms, in turns) " + ", ".join(
              f"{k}: {a:.4f} / {b:.4f}" for k, (a, b)
              in stacked_ms_by_geo.items())
          + f"; rotor {r26[0]:.4f} / {r26[1]:.4f} ms, lane tile "
          f"{k26[0]:.4f} / {k26[1]:.4f} ms in the same turns; fastest "
          f"S{best[0]}R{best[1]} {mean(stk_by[best]):.4f} ms = "
          f"{mean(stk_by[best]) / mean(r26):.2f}x the rotor, "
          f"{mean(stk_by[best]) / mean(k26):.2f}x the lane tile; bound at "
          f"S=4 {stacked_bound[0]:.4f} ms by {stacked_bound[1]}; kernel == "
          f"plain == lane tile on every live lane at every R")

    # 28. the conveyor's library entry on phase 22's pairs: one launch, the
    # engine's scores; then its stages apart, each synchronized
    launch0 = trace.counts()
    t0 = time.perf_counter()
    scores = sw_conveyor.sw_scores_conveyor(pairs, device="cuda")
    wall = time.perf_counter() - t0
    conveyor_launches = trace.launched("conveyor", launch0)
    check(conveyor_launches == 1,
          f"sw_scores_conveyor made {conveyor_launches} conveyor launches")
    check(scores.shape == (RT_PAIRS,) and scores.dtype == np.int32,
          f"scores of shape {scores.shape} {scores.dtype}")
    check(np.array_equal(scores[sample], ref),
          "sw_scores_conveyor != native model on the sampled pairs")
    check(np.array_equal(scores, rt_scores),
          "sw_scores_conveyor != the engine's scores (phase 22)")
    stages = []
    for _ in range(3):
        t0 = time.perf_counter()
        cb = sw_conveyor.pack_sw_conveyor(pairs)
        t1 = time.perf_counter()
        ct = (torch.from_numpy(cb.sched).to(dev),
              torch.from_numpy(cb.sy).to(dev))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res = sw_conveyor.sw_forward_conveyor(
            *ct, nxs=cb.nxs, n_slots=cb.n_slots, period=cb.period, a0=cb.a0)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        got = sw_conveyor.unpack_conveyor(cb, res.cpu().numpy(), RT_PAIRS)
        t4 = time.perf_counter()
        check(np.array_equal(got, scores), "conveyor stages != the entry")
        stages.append((t1 - t0, t2 - t1, t3 - t2, t4 - t3))
    print(f"phase 28 conveyor main path, sw_scores_conveyor(device=cuda) at "
          f"max_slots 64: {RT_PAIRS} x {RT_LEN}bp+'\\n', {cb.sched.shape[0]} "
          f"tiles x {cb.n_slots} slots, nxs {cb.nxs}, T {cb.period}, "
          f"{(cb.sched.nbytes + cb.sy.nbytes) / 1e6:.2f} MB packed; wall "
          f"{wall:.3f} s, {conveyor_launches} conveyor launch, all "
          f"{RT_PAIRS} scores == the engine's (phase 22), 512 sampled pairs "
          f"== native model; stages, s (three runs, each synchronized): "
          + "; ".join(f"pack {a:.4f}, h2d {b_:.4f}, kernel {k:.4f}, d2h + "
                      f"unpack {u:.4f}" for a, b_, k, u in stages))

    # 29. conveyor timing on that pack: the default geometry at max_slots
    # 4, 16, 64 in turns; at 4 slots every geometry that holds the window,
    # at 16 and 64 the warp forms geometry() weighs (each G at its fewest
    # rows), each depth's in turns; the block geometries on the tall
    # window; the plain conveyor sweep at 64 (one call) and the rotor
    # beside them
    def in_turns(fns):
        """Each function's slope, forwards then backwards: {key: [a, b]}."""
        order = list(fns.values())
        times = [slope_ms(f, torch) for f in order + order[::-1]]
        return {k: [times[i], times[-1 - i]] for i, k in enumerate(fns)}

    def fewest_rows(nxs):
        """G = 1, 2, 4, each at the fewest rows a lane that hold nxs rows:
        the warp forms geometry() weighs."""
        hold = [g for g in sw_conveyor.geometries_holding(nxs) if g[2] == 1]
        return [min((g for g in hold if g[0] == q), key=lambda g: g[1])
                for q in sw_conveyor.QUEUES_PER_WARP
                if any(g[0] == q for g in hold)]

    f_conv, conv_in = {}, {}
    for slots in CONVEYOR_SLOTS:
        b, t, st = conveyor_inputs(pairs, slots)
        conv_in[slots] = (b, t, st)
        f_conv[slots] = (lambda t=t, st=st: sw_conveyor.sw_forward_conveyor(
            *t, **st))
        check(np.array_equal(sw_conveyor.unpack_conveyor(
            b, f_conv[slots]().cpu().numpy(), RT_PAIRS), rt_scores),
              f"the conveyor at max_slots {slots} != the engine's scores")
    conv_ms = in_turns(f_conv)

    def by_geometry(t, st, geos, where):
        """{(G, R, W): function} of the kernel at each geometry, each
        checked == the default geometry on every row."""
        want = sw_conveyor.sw_forward_conveyor(*t, **st)
        fns = {}
        for geo in geos:
            fns[geo] = (lambda geo=geo: sw_conveyor.sw_forward_conveyor(
                *t, **st, _geometry=geo))
            check(torch.equal(fns[geo](), want),
                  f"conveyor geometry {geo} != the default {where}")
        return fns

    def geo_name(g):
        return "G{}R{}W{}".format(*g)

    conveyor_ms_by_geo = {}
    for slots in CONVEYOR_SLOTS:
        _, t, st = conv_in[slots]
        geos = (sw_conveyor.geometries_holding(st["nxs"]) if slots == 4
                else fewest_rows(st["nxs"]))
        conveyor_ms_by_geo[str(slots)] = {
            geo_name(g): v for g, v in in_turns(by_geometry(
                t, st, geos, f"at max_slots {slots}")).items()}
    # the tallest window of phase 27 (nxs 1,024, one tile two deep) at
    # each block geometry that holds it
    bt, tt, stt = conveyor_inputs(conveyor_cases["tall, x to 1022bp"],
                                  CONVEYOR_TALL_SLOTS[0])
    tall_ms_by_geo = {geo_name(g): v for g, v in in_turns(by_geometry(
        tt, stt, sw_conveyor.geometries_holding(stt["nxs"]),
        "on the tall window")).items()}
    b64, t64, st64 = conv_in[64]
    got = f_conv[64]()
    want = []
    conveyor_plain_ms = one_ms(lambda: want.append(conveyor_plain(t64, st64)),
                               torch)
    err = int((got.long() - want[0].long()).abs().max())
    conveyor_err = max(conveyor_err, err)
    check(err == 0, f"conveyor kernel != plain conveyor sweep on the 64bp "
                    f"pack at max_slots 64: max |diff| {err}")
    conveyor_ms = mean(conv_ms[64])
    conveyor_geo = sw_conveyor.geometry(st64["nxs"],
                                        t64[0].shape[0] * 128)
    conveyor_bound = bound_ms(nbytes(*t64, got), rt_cells * SW_OPS_PER_CELL,
                              int32_ops)
    shown = []
    for k in CONVEYOR_SLOTS:
        nt_k, st = conv_in[k][0].sched.shape[0], conv_in[k][2]
        steps = (st["n_slots"] + 1) * st["period"]
        geo = sw_conveyor.geometry(st["nxs"], nt_k * 128)
        by = conveyor_ms_by_geo[str(k)]
        shown.append(f"max_slots {k} ({nt_k} tiles x {st['n_slots']} slots "
                     f"= {nt_k * 128} queues of {steps} steps, "
                     f"{geo_name(dataclasses.astuple(geo)[:3])}) kernel "
                     f"{conv_ms[k][0]:.4f} / {conv_ms[k][1]:.4f} ms "
                     f"({rt_cells / mean(conv_ms[k]) / 1e6:.2f} GCUPS); by "
                     f"geometry (ms, in turns) " + ", ".join(
                         f"{g}: {a:.4f} / {b_:.4f}" for g, (a, b_)
                         in by.items())
                     + f", fastest {min(by, key=lambda g: sum(by[g]))}")
    tall_geo = sw_conveyor.geometry(stt["nxs"], bt.sched.shape[0] * 128)
    print(f"phase 29 conveyor timing, phase 22's {RT_PAIRS} x {RT_LEN}bp "
          f"pairs (cells {rt_cells}): " + "; ".join(shown)
          + f"; on the tall window (nxs {stt['nxs']}, T "
          f"{stt['period']}, {bt.sched.shape[0] * 128} queues x "
          f"{stt['n_slots']}, default "
          f"{geo_name(dataclasses.astuple(tall_geo)[:3])}) " + ", ".join(
              f"{k}: {a:.4f} / {b_:.4f}" for k, (a, b_)
              in tall_ms_by_geo.items())
          + f" ms; plain conveyor sweep at max_slots 64 "
          f"{conveyor_plain_ms:.1f} ms (one call), == kernel on every row; "
          f"rotor (phase 23) {rotor_ms:.4f} ms, the conveyor at 64 slots "
          f"{conveyor_ms / rotor_ms:.2f}x it; bound {conveyor_bound[0]:.4f} "
          f"ms by {conveyor_bound[1]}")

    # 20. both SW kernels across lengths, kernel only, each at its
    # default R: the lane-tile kernel, then the strips kernel (the pack's
    # strip width no longer shapes it, so no width sweep)
    rng = np.random.default_rng(SEED + 6)
    for length in SWEEP_LENS:
        sp = [SWPair(sx=random_dna(rng, length), sy=random_dna(rng, length))
              for _ in range(SWEEP_PAIRS)]
        (bs,) = pack_sw_pairs(sp)
        t = sw_bucket_to_torch(bs, dev)
        tsw, stw, nyw = strips_inputs(bs)
        fk = lambda: sw.sw_forward(*t)  # noqa: E731
        fs = lambda: sw_strips.sw_forward_strips(  # noqa: E731
            *tsw, ny_max=nyw, **stw)
        ref = fk()
        check(torch.equal(ref, fs()), f"strips != lane tile at {length}bp")
        a1, b1, b2, a2 = (slope_ms(fk, torch, 5), slope_ms(fs, torch, 5),
                          slope_ms(fs, torch, 5), slope_ms(fk, torch, 5))
        c = SWEEP_PAIRS * length * length
        # the rotor at each queue depth, in turns with itself, beside the
        # lane tile and strips of this point
        # the stacked kernel at each depth, in turns with itself
        stacked = []
        if length in STACK_LENS:
            n_live = -(-bs.n_valid // 128)
            for stack in STACKS:
                t, st = stacked_inputs(bs, stack)
                fst = lambda: sw_stacked.sw_forward_stacked(  # noqa: E731
                    *t, **st)
                check(torch.equal(fst()[:n_live], ref[:n_live]),
                      f"stacked at S={stack} differs at {length}bp")
                s1, s2 = slope_ms(fst, torch, 5), slope_ms(fst, torch, 5)
                stacked.append(f"{stack}: {s1:.4f} / {s2:.4f} ms = "
                               f"{c / ((s1 + s2) / 2) / 1e6:.2f} GCUPS")
            stacked = [f"stacked ({bs.sx.shape[1]} rows) by sw_stack "
                       + "; ".join(stacked)]
        rotor = []
        if length in ROTOR_LENS:
            n_live = -(-bs.n_valid // 128)
            for slots in ROTOR_SLOTS:
                rp = sw_rotor.maybe_prep_rotor(
                    EngineConfig(sw_rotor=True, rotor_max_slots=slots), bs)
                check(rp is not None, f"the rotor declines {length}bp")
                rxy = sw_rotor_to_torch(rp, dev)
                fr = lambda: sw_rotor.sw_forward_rotor_bucket(  # noqa: E731
                    *rxy, **rp[1])
                check(torch.equal(fr()[:n_live], ref[:n_live]),
                      f"rotor at {slots} slots differs at {length}bp")
                r1, r2 = slope_ms(fr, torch, 5), slope_ms(fr, torch, 5)
                rotor.append(f"{slots}: {r1:.4f} / {r2:.4f} ms = "
                             f"{c / ((r1 + r2) / 2) / 1e6:.2f} GCUPS")
            rotor = [f"rotor (T {rp[1]['period']}) by rotor_max_slots "
                     + "; ".join(rotor)]
        # the conveyor (library entry only) at two queue depths
        conveyor = []
        if length in ROTOR_LENS:
            want = unpack_scores([bs], [ref.cpu().numpy()], len(sp))
            for slots in CONVEYOR_SWEEP_SLOTS:
                cb, ct, cst = conveyor_inputs(sp, slots)
                fc = lambda: sw_conveyor.sw_forward_conveyor(  # noqa: E731
                    *ct, **cst)
                check(np.array_equal(sw_conveyor.unpack_conveyor(
                    cb, fc().cpu().numpy(), len(sp)), want),
                      f"conveyor at {slots} slots differs at {length}bp")
                c1, c2 = slope_ms(fc, torch, 5), slope_ms(fc, torch, 5)
                cg = sw_conveyor.geometry(cst["nxs"],
                                          cb.sched.shape[0] * 128)
                conveyor.append(f"{slots} ({cb.sched.shape[0]} x "
                                f"{cst['n_slots']}, G{cg.queues_per_warp}"
                                f"R{cg.rows}W{cg.warps_per_queue}): "
                                f"{c1:.4f} / {c2:.4f} ms "
                                f"= {c / ((c1 + c2) / 2) / 1e6:.2f} GCUPS")
            conveyor = [f"conveyor (T {cst['period']}) by max_slots "
                        + "; ".join(conveyor)]
        dflt = EngineConfig()
        r_tile = sw.tile_geometry(bs.sx.shape[1]).rows_per_thread
        r_strips = sw_strips.geometry(stw["k_strips"] * stw["strip_w"],
                                      nyw).rows_per_thread
        print(f"phase 20 sw sweep {length}bp: {SWEEP_PAIRS} pairs, bucket "
              f"{tuple(t[0].shape)}; lane tile (R = {r_tile}) {a1:.3f} / "
              f"{a2:.3f} ms = {c / ((a1 + a2) / 2) / 1e6:.2f} GCUPS; strips "
              f"(R = {r_strips}) {b1:.3f} / {b2:.3f} ms = "
              f"{c / ((b1 + b2) / 2) / 1e6:.2f} GCUPS; "
              + "".join(r + "; " for r in rotor + stacked + conveyor)
              + f"the default router sends it to the {routed_to(dflt, bs)} "
              f"kernel (sw_rotor {dflt.sw_rotor}, rotor_max_slots "
              f"{dflt.rotor_max_slots}, strips_min_nxs "
              f"{dflt.strips_min_nxs})")

    # 7. PairHMM kernel vs plain version on the card
    ph_err = 0.0
    ph_cases = []  # (bucket, tensors, plain result, mm_div, period)
    for alphabet, gatk, period in ((b"ACGT", False, 32), (b"ACGT", True, 32),
                                   (b"ACGTX", False, 8), (b"ACGTX", True, 32),
                                   (None, False, 32)):
        cfg = PairHMMConfig(gatk_emission=gatk)
        batches = (cases.streamed_batches(3) if alphabet is None else
                   cases.phmm_batches(7 + len(alphabet) + gatk, alphabet))
        buckets, n = pack_pairhmm_batches(batches, byte_quals=True,
                                          factored=True, bitmask_codes=True)
        check(all(b.bitmask_codes == (alphabet != b"ACGTX") for b in buckets),
              "pack chose other codes than asked")
        err, nt, nds = 0.0, 0, 0
        for b in buckets:
            t = phmm_bucket_to_torch(b, dev)
            got = pairhmm.pairhmm_forward(*t, rescale_period=period,
                                          mm_div=cfg.mm_div,
                                          bitmask=b.bitmask_codes)
            want = phmm_forward_tiles(*t, period, cfg.mm_div,
                                      b.bitmask_codes)
            torch.cuda.synchronize()
            err = max(err, log10_err(got, want,
                                     torch.from_numpy(b.rl > 0).to(dev),
                                     torch))
            nt, nds = max(nt, b.meta.shape[0]), max(nds, b.nds)
            if alphabet is not None and period == 32:
                ph_cases.append((b, t, want, cfg.mm_div, period))
        ph_err = max(ph_err, err)
        check(err <= PH_TOL, f"PairHMM kernel vs plain: {err} > {PH_TOL}")
        check(alphabet is not None or nds > 6144,
              f"the streamed case packed a {nds}-row stream")
        print(f"phase 7 phmm kernel vs plain: {n} "
              f"{'ragged' if alphabet else '151bp x 7-10kbp'} jobs, "
              f"{len(buckets)} buckets (up to {nt} tiles, stream up to "
              f"{nds} rows), "
              f"{'raw' if alphabet == b'ACGTX' else 'bitmask'} codes, "
              f"mm_div {cfg.mm_div:g}, period {period}, max |dlog10| "
              f"{err:.3g}")
    # the streamed case's bucket (the last one packed): kernel vs plain ms
    bm = b.bitmask_codes
    st_t = t
    st_k = lambda: pairhmm.pairhmm_forward(*st_t, bitmask=bm)  # noqa: E731
    st_p = lambda: phmm_forward_tiles(*st_t, 32, 1.0, bm)  # noqa: E731
    p1, k1, k2 = (one_ms(st_p, torch), slope_ms(st_k, torch, 3),
                  slope_ms(st_k, torch, 3))
    st_bound = bound_ms(nbytes(*t) + 4 * b.rl.size,
                        int((b.rl.astype(np.int64) * b.hl).sum())
                        * PHMM_FLOPS_PER_CELL, FP32_FLOPS)
    print(f"phase 7 streamed timing, bucket {tuple(t[0].shape)} stream "
          f"{tuple(t[7].shape)}: kernel {k1:.3f} / {k2:.3f} ms, plain "
          f"{p1:.3f} ms per call, bound {st_bound[0]:.4f} ms by "
          f"{st_bound[1]}")
    # every R the build makes, on the ragged buckets above whose rows a warp
    # holds at that R (bitmask codes at mm_div 1, raw at 3; with short reads,
    # and each bucket also cut to its rows, so that every R meets buckets)
    # and on the deep-decay pairs at every rescale period in both code forms
    def tight(b, t, cases_out, mm_div, period):
        cut, n = cases.tight_rows(t, b.rl)
        if n < b.nxs <= 136:  # the buckets whose cut a smaller R takes
            cases_out.append((b, cut, n, phmm_forward_tiles(
                *cut, period, mm_div, b.bitmask_codes), mm_div, period))

    ragged = []
    for b, t, want, mm_div, period in ph_cases:
        ragged.append((b, t, b.nxs, want, mm_div, period))
        tight(b, t, ragged, mm_div, period)
    for alphabet, mm_div in ((b"ACGT", 1.0), (b"ACGTX", 3.0)):
        sbs, _ = pack_pairhmm_batches(cases.short_phmm_batches(6, alphabet),
                                      byte_quals=True, factored=True,
                                      bitmask_codes=True)
        for b in sbs:
            t = phmm_bucket_to_torch(b, dev)
            ragged.append((b, t, b.nxs, phmm_forward_tiles(
                *t, 32, mm_div, b.bitmask_codes), mm_div, 32))
            tight(b, t, ragged, mm_div, 32)
    deep = []
    for bitmask, mm_div in ((True, 1.0), (False, 3.0)):
        for batch in cases.deep_decay_batches():
            (b,), _ = pack_pairhmm_batches([batch], byte_quals=True,
                                           factored=True,
                                           bitmask_codes=bitmask)
            t, n = cases.tight_rows(phmm_bucket_to_torch(b, dev), b.rl)
            for period in RESCALE_PERIODS:
                deep.append((b, t, n, phmm_forward_tiles(
                    *t, period, mm_div, b.bitmask_codes), mm_div, period))
    for r in pairhmm.TILE_R:
        err, n_run = 0.0, [0, 0]
        for kind, group in enumerate((ragged, deep)):
            for b, t, nxs, want, mm_div, period in group:
                if -(-nxs // r) > pairhmm.WARP:
                    continue
                got = pairhmm.pairhmm_forward(*t, rescale_period=period,
                                              mm_div=mm_div,
                                              bitmask=b.bitmask_codes,
                                              _rows_per_thread=r)
                err = max(err, log10_err(
                    got, want, torch.from_numpy(b.rl > 0).to(dev), torch))
                n_run[kind] += 1
        ph_err = max(ph_err, err)
        check(err <= PH_TOL, f"PairHMM kernel at R = {r} vs plain: {err}")
        check(n_run[0] and n_run[1] >= 2 * len(RESCALE_PERIODS),
              f"R = {r}: {n_run} ragged and deep-decay buckets")
        print(f"phase 7 phmm kernel at R = {r} vs plain: {n_run[0]} ragged "
              f"buckets of up to {pairhmm.WARP * r} rows, {n_run[1]} "
              f"deep-decay buckets (periods {RESCALE_PERIODS}, bitmask and "
              f"raw codes), max |dlog10| {err:.3g}")

    # 8. PairHMM engine on the vendored goldens
    gold = os.path.join(REPO, "tests", "golden")
    eng = Engine(device="cuda")
    got = eng.pairhmm_file(os.path.join(gold, "test.in"))
    with open(os.path.join(gold, "test.out")) as f:
        err = abs(float(got[0]) - float(f.read()))
    check(err <= PH_TOL, f"test.in off the golden by {err}")
    print(f"phase 8 phmm golden test.in: {got[0]:.6f}, |err| {err:.3g}")
    want = np.loadtxt(os.path.join(gold, "10s.golden.out"))
    got = eng.pairhmm_file(os.path.join(gold, "10s.in"))
    err = float(np.abs(got - want).max())
    check(got.shape == want.shape and err <= PH_TOL,
          f"10s.in off the golden by {err}")
    fallback = eng.last_stats.fallback_jobs
    raw = Engine(EngineConfig(phmm_fallback_threshold=None),
                 device="cuda").pairhmm_file(os.path.join(gold, "10s.in"))
    above = want > -45
    raw_err = float(np.abs(raw - want)[above].max())
    print(f"phase 8 phmm golden 10s.in: {len(got)} values, max |err| "
          f"{err:.3g}, fallback_jobs {fallback}; fallback off: max |err| "
          f"{raw_err:.3g} over the {int(above.sum())} golden values above "
          f"-45")

    # 9. the PairHMM main path at full width
    batch = generate_pairhmm_batch(PH_READS, PH_HAPS, read_len=PH_READ_LEN,
                                   hap_len=PH_HAP_LEN, seed=SEED,
                                   from_haps=True)
    n_jobs = PH_READS * PH_HAPS
    launch0 = trace.counts()
    t0 = time.perf_counter()
    values = eng.pairhmm([batch])
    wall = time.perf_counter() - t0
    ph_launches = trace.launched("pairhmm_tile", launch0)
    stats = eng.last_stats
    check(values.shape == (n_jobs,) and bool(np.isfinite(values).all()),
          f"PairHMM values of shape {values.shape}, or not finite")
    check(ph_launches >= stats.buckets >= 1,
          f"{ph_launches} PairHMM launches for {stats.buckets} buckets")
    sample = np.random.default_rng(SEED + 1).choice(n_jobs, 256,
                                                    replace=False)
    ref = np.array([native.pairhmm_native([type(batch)(
        reads=[batch.reads[j // PH_HAPS]],
        haplotypes=[batch.haplotypes[j % PH_HAPS]])])[0] for j in sample])
    err = float(np.abs(values[sample] - ref).max())
    check(err <= PH_TOL, f"engine vs native on the sample: {err}")
    print(f"phase 9 phmm main path: {n_jobs} jobs ({PH_READS} reads of "
          f"{PH_READ_LEN}bp x {PH_HAPS} haps of {PH_HAP_LEN}bp), engine wall "
          f"{wall:.3f} s, {ph_launches} launches for {stats.buckets} buckets, "
          f"256 sampled jobs vs native max |err| {err:.3g}, "
          f"stats {json.dumps(stats.as_dict())}")
    ph_batch, ph_values, ph_fallbacks = batch, values, stats.fallback_jobs

    # 9, stage by stage: three more runs of the engine on the same jobs,
    # each stage timed inside the run whose wall it is printed beside (the
    # copy with the expansion, and the launch, inside "run"), with the
    # collector's pauses; the collector left as the earlier phases left it
    for k in range(3):
        values, wall, _, line = timed_run(
            eng, "pairhmm", lambda: eng.pairhmm([batch]), False,
            extra=[(executor, "phmm_bucket_to_torch", "copy+expand"),
                   (executor, "pairhmm_forward", "launch")],
            others="inside run:", collect=False)
        check(np.array_equal(values, ph_values), "a staged run's values "
              "differ from the first run's")
        print(f"phase 9 stages, run {k + 1} of 3: {line}")

    # 10. PairHMM timing on the full-width bucket
    (b,), _ = pack_pairhmm_batches([batch], byte_quals=True, factored=True,
                                   bitmask_codes=True)
    packed = [torch.from_numpy(a).to(dev)
              for a in (b.rchar_u, b.qb_u, b.hap_u, b.ridx, b.hidx)]
    expand_ms = slope_ms(lambda: expand_factored(*packed), torch)
    t = phmm_bucket_to_torch(b, dev)
    period, mm_div, bm = 32, 1.0, b.bitmask_codes
    got = pairhmm.pairhmm_forward(*t, rescale_period=period, mm_div=mm_div,
                                  bitmask=bm)
    want = phmm_forward_tiles(*t, period, mm_div, bm)
    err = log10_err(got, want, torch.from_numpy(b.rl > 0).to(dev), torch)
    ph_err = max(ph_err, err)
    check(err <= PH_TOL, f"PairHMM kernel vs plain on the 65k bucket: {err}")
    # every R at which a warp holds the bucket's rows, each held against
    # the plain result, then timed in turns (R ascending, then descending)
    # after one plain slope
    rs = [r for r in pairhmm.TILE_R if -(-b.nxs // r) <= pairhmm.WARP]
    ph_r = pairhmm.default_rows_per_thread(b.nxs)
    for r in rs:
        got_r = pairhmm.pairhmm_forward(*t, rescale_period=period,
                                        mm_div=mm_div, bitmask=bm,
                                        _rows_per_thread=r)
        err = max(err, log10_err(got_r, want,
                                 torch.from_numpy(b.rl > 0).to(dev), torch))
    ph_err = max(ph_err, err)
    check(err <= PH_TOL, f"PairHMM kernel at every R on the 65k bucket: {err}")

    def kernel_at(r):
        return lambda: pairhmm.pairhmm_forward(
            *t, rescale_period=period, mm_div=mm_div, bitmask=bm,
            _rows_per_thread=r)

    plain = lambda: phmm_forward_tiles(*t, period, mm_div, bm)  # noqa: E731
    ph_plain_ms = one_ms(plain, torch)
    times = {r: [] for r in rs}
    for r in rs + rs[::-1]:
        times[r].append(slope_ms(kernel_at(r), torch))
    ph_kernel_ms = sum(times[ph_r]) / 2
    cells = stats.dp_cells  # phase 9's bucket: sum rl*hl
    ph_bound = bound_ms(nbytes(*t, got), cells * PHMM_FLOPS_PER_CELL,
                        FP32_FLOPS)
    ph_times = {r: sum(v) / 2 for r, v in times.items()}
    print(f"phase 10 phmm timing, bucket {tuple(t[0].shape)} stream "
          f"{tuple(t[7].shape)}: expansion {expand_ms:.3f} ms; kernel by R "
          "(threads a pair), ms per call in turns: " + ", ".join(
              f"R={r} (G={-(-b.nxs // r)}) {v[0]:.3f} / {v[1]:.3f}"
              for r, v in times.items())
          + f"; default R={ph_r} {ph_kernel_ms:.3f} ms, plain "
          f"{ph_plain_ms:.3f} ms per call, bound {ph_bound[0]:.4f} ms by "
          f"{ph_bound[1]} ({100 * ph_bound[0] / ph_kernel_ms:.1f}% of it); "
          f"GCUPS kernel {cells / ph_kernel_ms / 1e6:.2f}, plain "
          f"{cells / ph_plain_ms / 1e6:.2f} (cells = sum rl*hl, {cells}); "
          f"max |dlog10| over every R {err:.3g}")
    print(f"phase 10 phmm fastest R: {min(ph_times, key=ph_times.get)} "
          f"({min(ph_times.values()):.3f} ms); default R={ph_r}")

    # 11. the long-read kernel vs its plain version on the card
    def long_tile(jobs):
        return long_tile_w(jobs, pairhmm_long.STRIP_W)

    def long_tile_w(jobs, strip_w):
        arrays, st = pairhmm_long.pack_pairhmm_long(jobs, strip_w=strip_w)
        st = dict(st)
        t = {k: torch.from_numpy(a).to(dev) for k, a in arrays.items()}
        sweep, anchor, _ = pairhmm_long.long_layout(st["ny_max"],
                                                    st["strip_w"])
        valid = torch.from_numpy(arrays["meta"][0] > 0).to(dev)

        def kernel(unroll, mm_div, r=None):
            return pairhmm_long.pairhmm_long_forward(
                **t, **st, unroll=unroll, mm_div=mm_div, _rows_per_thread=r)

        def plain(unroll, mm_div):
            return phmm_long_forward(*t.values(), st["k_strips"],
                                     st["strip_w"], anchor, sweep, unroll,
                                     mm_div)

        return kernel, plain, valid, {**st, "bytes": nbytes(*t.values())}

    lr_err = 0.0
    jobs = cases.long_jobs(5)
    kernel, plain, valid, st = long_tile(jobs)
    lr_rs = [r for r in pairhmm_long.LONG_R
             if -(-st["strip_w"] // r) <= pairhmm_long.WARP]
    for gatk, unroll in ((False, 16), (True, 8)):
        mm_div = PairHMMConfig(gatk_emission=gatk).mm_div
        want = plain(unroll, mm_div)
        errs = []
        for r in lr_rs:  # every R at which a warp holds a strip
            got = kernel(unroll, mm_div, r)
            torch.cuda.synchronize()
            errs.append(log10_err(got, want, valid, torch))
        err = max(errs)
        lr_err = max(lr_err, err)
        check(err <= PH_TOL, f"long-read kernel vs plain: {err} > {PH_TOL}")
        print(f"phase 11 long kernel vs plain: {len(jobs)} jobs (reads "
              f"511-1500bp, "
              f"haplotypes to 2kbp), {st['k_strips']} strips of "
              f"{st['strip_w']} rows, unroll {unroll}, mm_div {mm_div:g}, "
              "max |dlog10| by R " + ", ".join(
                  f"R={r} {e:.3g}" for r, e in zip(lr_rs, errs))
              + f", {int(torch.isfinite(want).sum())} finite")
    # reads ending on a strip seam (the strip after the owner only
    # rescales) and a deep-decay pair among them, at the engine's strip
    # width and at 24 rows (9 strips: the block sweeps them in two rounds,
    # the seam between rounds through global memory)
    for strip_w, read_lens in ((256, (300, 1000)), (24, (30, 200))):
        # long_jobs' last pair, a 700bp deep-decay one, would take the
        # plain strip sweep at 24 rows through 30 strips; the seam jobs
        # hold a deep-decay pair of their own
        jobs = cases.long_seam_jobs(3, strip_w) + cases.long_jobs(
            8, n_jobs=13, read_lens=read_lens,
            hap_max=read_lens[1] + 100)[:-1]
        kernel, plain, valid, st = long_tile_w(jobs, strip_w)
        rs = [r for r in pairhmm_long.LONG_R
              if -(-strip_w // r) <= pairhmm_long.WARP]
        for unroll, mm_div in ((16, 1.0), (4, 3.0)):
            want = plain(unroll, mm_div)
            errs = [log10_err(kernel(unroll, mm_div, r), want, valid, torch)
                    for r in rs]
            lr_err = max(lr_err, *errs)
            check(max(errs) <= PH_TOL,
                  f"long-read kernel vs plain on seam reads: {errs}")
            print(f"phase 11 long kernel vs plain, reads ending on strip "
                  f"seams: {len(jobs)} jobs, {st['k_strips']} strips of "
                  f"{strip_w} rows, unroll {unroll}, mm_div {mm_div:g}, max "
                  "|dlog10| by R " + ", ".join(
                      f"R={r} {e:.3g}" for r, e in zip(rs, errs))
                  + f", {int(torch.isfinite(want).sum())} finite")

    # 12. the long-read path through the engine
    batch = generate_pairhmm_batch(LR_READS, LR_HAPS, read_len=LR_READ_LEN,
                                   hap_len=LR_HAP_LEN, seed=SEED,
                                   from_haps=True)
    lr_jobs = LR_READS * LR_HAPS
    launch0 = trace.counts()
    t0 = time.perf_counter()
    values = eng.pairhmm([batch])
    wall = time.perf_counter() - t0
    lr_launches = trace.launched("pairhmm_long", launch0)
    stats = eng.last_stats
    check(values.shape == (lr_jobs,) and bool(np.isfinite(values).all()),
          f"long-read values of shape {values.shape}, or not finite")
    check(stats.offloaded_jobs == lr_jobs,
          f"{stats.offloaded_jobs} of {lr_jobs} long jobs left the lane tile")
    check(lr_launches >= -(-lr_jobs // 128),
          f"{lr_launches} long-read launches for {lr_jobs} jobs")
    sample = np.random.default_rng(SEED + 2).choice(lr_jobs, 64,
                                                    replace=False)
    jobs = [(batch.reads[j // LR_HAPS], batch.haplotypes[j % LR_HAPS])
            for j in sample]
    ref = np.array([native.pairhmm_native([type(batch)(
        reads=[rd], haplotypes=[hp])])[0] for rd, hp in jobs])
    err = float(np.abs(values[sample] - ref).max())
    check(err <= PH_TOL, f"long-read engine vs native on the sample: {err}")
    raw = pairhmm_long.pairhmm_long(jobs, device=dev)
    above = ref > -45
    raw_err = float(np.abs(raw - ref)[above].max()) if above.any() else 0.0
    lr_err = max(lr_err, raw_err)
    check(raw_err <= PH_TOL, f"long-read kernel vs native above -45: "
                             f"{raw_err}")
    print(f"phase 12 long main path: {lr_jobs} jobs ({LR_READS} reads of "
          f"{LR_READ_LEN}bp x {LR_HAPS} haps of {LR_HAP_LEN}bp), engine "
          f"wall {wall:.3f} s, {lr_launches} long-read launches, 64 sampled "
          f"jobs vs native max |err| {err:.3g}; kernel alone vs native "
          f"{raw_err:.3g} over the {int(above.sum())} sampled above -45; "
          f"stats {json.dumps(stats.as_dict())}")

    # 13. long-read timing on one tile of phase 12
    kernel, plain, valid, st = long_tile(
        [(rd, hp) for rd in batch.reads[:128 // LR_HAPS]
         for hp in batch.haplotypes])
    want = plain(16, 1.0)
    err = max(log10_err(kernel(16, 1.0, r), want, valid, torch)
              for r in lr_rs)
    lr_err = max(lr_err, err)
    check(err <= PH_TOL, f"long-read kernel vs plain on the tile: {err}")
    lr_plain_ms = one_ms(lambda: plain(16, 1.0), torch)
    times = {r: [] for r in lr_rs}
    for r in lr_rs + lr_rs[::-1]:
        times[r].append(slope_ms(lambda: kernel(16, 1.0, r), torch, 3))
    lr_r = pairhmm_long.long_geometry(st["k_strips"], st["strip_w"],
                                      st["ny_max"]).rows_per_thread
    lr_kernel_ms = sum(times[lr_r]) / 2
    cells = LR_READ_LEN * LR_HAP_LEN * 128
    lr_bound = bound_ms(st["bytes"] + 4 * 128, cells * PHMM_FLOPS_PER_CELL,
                        FP32_FLOPS)
    print(f"phase 13 long timing, tile of 128 jobs {LR_READ_LEN} x "
          f"{LR_HAP_LEN}, {st['k_strips']} strips: kernel by R (threads a "
          "strip), ms per call in turns: " + ", ".join(
              f"R={r} ({-(-st['strip_w'] // r)}) {v[0]:.3f} / {v[1]:.3f}"
              for r, v in times.items())
          + f"; default R={lr_r} {lr_kernel_ms:.3f} ms, plain "
          f"{lr_plain_ms:.3f} ms per call, bound {lr_bound[0]:.4f} ms by "
          f"{lr_bound[1]} ({100 * lr_bound[0] / lr_kernel_ms:.2f}% of it); "
          f"GCUPS kernel {cells / lr_kernel_ms / 1e6:.2f}, plain "
          f"{cells / lr_plain_ms / 1e6:.2f} (cells = sum rl*hl, {cells}); "
          f"max |dlog10| over every R {err:.3g}")

    # 14. the long-pair SW kernel vs its plain version and the native model
    def sw_long_tile(pairs, strip_w):
        b = sw_long.pack_sw_long(pairs, strip_w)
        t = sw_long.tile_to_torch(b, dev)
        _, anchor, _ = sw_long._layout(b.ny_max, b.strip_w)
        kw = dict(k_strips=b.n_strips, strip_w=b.strip_w, ny_max=b.ny_max)

        def kernel(cfg, r=sw_long.LONG_R):
            return sw_long.sw_forward_long(*t, cfg=cfg, **kw,
                                           _rows_per_thread=r)

        def plain(cfg):
            return sw_long_forward(*t, b.n_strips, b.strip_w, anchor, cfg)

        def dense(cfg):
            return sw_long_forward_dense(t[0], t[1], b.n_diags, b.ny_max,
                                         anchor, cfg)

        return kernel, plain, dense, b, t

    # The plain strip sweep launches some forty torch operations a
    # diagonal: at strips of 64 it sweeps the 4kbp tile in minutes, so it
    # runs there on a tile a quarter as long with the same four special
    # pairs, and the kernel at strips of 64 is held on both tiles. The
    # plain full-height sweep, which phase 16 holds the 50kbp tile
    # against, is held against the native model here too.
    sl_err = 0
    pairs = cases.long_sw_pairs(3)
    small = cases.long_sw_pairs(5, x_lens=(300, 1100), y_max=1300, seam=256)
    n = len(pairs)
    k64, _, _, b64, _ = sw_long_tile(pairs, 64)
    kdef, pdef, ddef, bdef, tdef = sw_long_tile(pairs, sw_long.STRIP_W)
    ks64, ps64, _, bs64, _ = sw_long_tile(small, 64)
    # A tile taller than sw_long.MAX_ROWS (5 strips of 1,024: two
    # sub-strips of 2,560 rows at every R), the tandem repeat across that
    # seam, held against the plain full-height sweep.
    tall = cases.long_sw_pairs(9, n_pairs=24, x_lens=(4200, 4400),
                               y_max=4600, seam=2560)
    ktall, _, dtall, btall, _ = sw_long_tile(tall, sw_long.STRIP_W)
    for r in sw_long.ROWS_PER_THREAD:
        geo = sw_long.geometry(btall.n_strips * btall.strip_w, btall.ny_max,
                               r)
        check((geo.n_sub, geo.height) == (2, 2560),
              f"the tall tile at R = {r}: {geo}")
    for i, c in enumerate(CFGS):
        cfg = SWConfig(**c)
        t0 = time.perf_counter()
        want = torch.from_numpy(native_sw(native, pairs, cfg)).to(dev)
        want_small = torch.from_numpy(native_sw(native, small, cfg)).to(dev)
        want_tall = torch.from_numpy(native_sw(native, tall, cfg)).to(dev)
        t_native = time.perf_counter() - t0
        got = {"plain, full height": ddef(cfg),
               "small tile, plain, strips of 64": ps64(cfg),
               "tall tile, plain, full height": dtall(cfg)}
        if i == 0:
            # the plain strip sweep of the 4kbp tile (some 8 s) under the
            # first config only, timed by that call
            held = []
            p1 = one_ms(lambda: held.append(pdef(cfg)), torch)
            got[f"plain, strips of {bdef.strip_w}"] = held[0]
        # the kernel at every R on every pack
        for r in sw_long.ROWS_PER_THREAD:
            got[f"R={r}, strips of 64"] = k64(cfg, r)
            got[f"R={r}, strips of {bdef.strip_w}"] = kdef(cfg, r)
            got[f"small tile, R={r}, strips of 64"] = ks64(cfg, r)
            got[f"tall tile, R={r}, strips of {btall.strip_w}"] = ktall(cfg,
                                                                        r)
        torch.cuda.synchronize()
        for name, g in got.items():
            ref = (want_small if name.startswith("small") else
                   want_tall if name.startswith("tall") else want)
            m = len(ref)
            err = int((g[:m].long() - ref.long()).abs().max())
            sl_err = max(sl_err, err)
            check(err == 0, f"long-pair SW ({name}) != native model under "
                            f"{cfg}: max |diff| {err}")
            check(not bool(g[m:].any()),
                  f"long-pair SW ({name}): an empty lane scored")
        check(int(want[n - 4]) == 4000 * cfg.match
              and int(want_small[len(small) - 4]) == 1100 * cfg.match
              and int(want_tall[len(tall) - 4]) == 4400 * cfg.match,
              f"the identical pairs scored {int(want[n - 4])}, "
              f"{int(want_small[len(small) - 4])}, "
              f"{int(want_tall[len(tall) - 4])}")
        print(f"phase 14 sw long kernel == plain == native: {n} pairs (x "
              f"1,023-4,000bp, y to 5kbp), packs of {b64.n_strips} strips "
              f"of 64 and {bdef.n_strips} of {bdef.strip_w}, plain at "
              f"{bdef.strip_w} (the first config) and at full height; "
              f"{len(small)} pairs (x "
              f"300-1,100bp, y to 1.3kbp), {bs64.n_strips} strips of 64, "
              f"kernel and plain; {len(tall)} pairs (x 4,200-4,400bp, y to "
              f"4.6kbp), {btall.n_strips} strips of {btall.strip_w}, two "
              f"sub-strips of 2,560 rows, kernel and plain at full height; "
              f"the kernel at R = {sw_long.ROWS_PER_THREAD}; {cfg}, "
              f"{len(got)} results exact (native {t_native:.2f} s)")
    cfg = SWConfig()
    k1, f1, k2 = (slope_ms(lambda: kdef(cfg), torch, 3),
                  one_ms(lambda: ddef(cfg), torch),
                  slope_ms(lambda: kdef(cfg), torch, 3))
    sl4_kernel_ms = (k1 + k2) / 2
    cells = sum(len(p.sx) * len(p.sy) for p in pairs)
    sl4_bound = bound_ms(nbytes(*tdef) + 4 * 128, cells * SW_OPS_PER_CELL,
                         int32_ops)
    print(f"phase 14 sw long timing, tile of {n} pairs x 1,023-4,000bp, "
          f"{bdef.n_strips} strips of {bdef.strip_w}: kernel {k1:.3f} / "
          f"{k2:.3f} ms, plain strip sweep {p1:.3f} ms, plain full-height "
          f"sweep {f1:.3f} ms (one call each), bound {sl4_bound[0]:.4f} ms "
          f"by {sl4_bound[1]}; GCUPS kernel {cells / sl4_kernel_ms / 1e6:.2f}"
          f", plain {cells / p1 / 1e6:.2f} and {cells / f1 / 1e6:.2f} "
          f"(cells = sum len(sx)*len(sy), {cells})")

    # 15. the lane-tile SW kernel on streams past 6,144 rows
    pairs = cases.streamed_sw_pairs(4)
    buckets = pack_sw_pairs(pairs)
    check(min(b.sy.shape[1] for b in buckets) > 6144,
          "a streamed SW bucket packed a stream of "
          f"{min(b.sy.shape[1] for b in buckets)} rows")
    results, cfg = [], SWConfig()
    for b in buckets:
        sx, sy, nd = sw_bucket_to_torch(b, dev)
        want = sw_forward_tiles(sx, sy, nd, cfg)
        for r in (*sw.ROWS_PER_THREAD, None):  # every R, then the default
            got = sw.sw_forward(sx, sy, nd, cfg, _rows_per_thread=r)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"kernel (R={r}) != plain on streamed bucket "
                            f"{tuple(sy.shape)}: max |diff| {err}")
        results.append(got.cpu().numpy())
    check(np.array_equal(unpack_scores(buckets, results, len(pairs)),
                         native_sw(native, pairs, cfg)),
          "kernel != native model on the streamed SW buckets")
    big = max(buckets, key=lambda b: b.sx.size)
    sx, sy, nd = sw_bucket_to_torch(big, dev)
    kernel = lambda: sw.sw_forward(sx, sy, nd, cfg)  # noqa: E731
    plain = lambda: sw_forward_tiles(sx, sy, nd, cfg)  # noqa: E731
    p1, k1, k2, p2 = (one_ms(plain, torch), slope_ms(kernel, torch, 3),
                      slope_ms(kernel, torch, 3), one_ms(plain, torch))
    cells = int(((big.nx - 1).astype(np.int64) * (big.ny - 1)).sum())
    ss_bound = bound_ms(nbytes(sx, sy, nd) + 4 * big.nx.size,
                        cells * SW_OPS_PER_CELL, int32_ops)
    print(f"phase 15 sw streamed: {len(pairs)} pairs (x 30-600bp in y "
          f"6-10kbp), {len(buckets)} buckets, streams of "
          f"{min(b.sy.shape[1] for b in buckets)}-"
          f"{max(b.sy.shape[1] for b in buckets)} rows, kernel at every R == "
          f"plain == native exact; bucket {tuple(sx.shape)} stream "
          f"{tuple(sy.shape)} at R = "
          f"{sw.tile_geometry(sx.shape[1]).rows_per_thread}: "
          f"kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms per "
          f"call, bound {ss_bound[0]:.4f} ms by {ss_bound[1]}; GCUPS kernel "
          f"{cells / ((k1 + k2) / 2) / 1e6:.2f} (cells {cells})")

    # 16. the long-pair SW path through the engine, one 50kbp x 50kbp tile
    rng = np.random.default_rng(SEED + 3)
    pairs = [SWPair(sx=random_dna(rng, LP_LEN), sy=random_dna(rng, LP_LEN))
             for _ in range(LP_PAIRS)]
    pairs[LP_PAIRS // 2] = SWPair(sx=pairs[0].sx, sy=pairs[0].sx)
    native_calls = []
    real_native = native.sw_scores_native
    native.sw_scores_native = (
        lambda ps, cfg=None: native_calls.append(len(ps))
        or real_native(ps, cfg))
    launch0 = trace.counts()
    t0 = time.perf_counter()
    try:
        scores = eng.sw_scores(pairs)
    finally:
        native.sw_scores_native = real_native
    wall = time.perf_counter() - t0
    lp_launches, tile_launches = (trace.launched("sw_long", launch0),
                                  trace.launched("tile", launch0))
    stats = eng.last_stats
    check(scores.shape == (LP_PAIRS,) and scores.dtype == np.int32,
          f"scores of shape {scores.shape} {scores.dtype}")
    check(lp_launches >= 1 and tile_launches == 0,
          f"{lp_launches} long-pair and {tile_launches} lane-tile launches")
    check(stats.offloaded_jobs == LP_PAIRS and not native_calls,
          f"{stats.offloaded_jobs} of {LP_PAIRS} pairs left the lane tile, "
          f"native calls {native_calls}")
    check(int(scores[LP_PAIRS // 2]) == LP_LEN,
          f"the identical pair scored {int(scores[LP_PAIRS // 2])}")
    print(f"phase 16 sw long main path: {LP_PAIRS} x {LP_LEN}bp x "
          f"{LP_LEN}bp, engine wall {wall:.3f} s, {lp_launches} long-pair "
          f"launches, 0 native calls, offloaded_jobs {stats.offloaded_jobs}, "
          f"identical pair {int(scores[LP_PAIRS // 2])}, stats "
          f"{json.dumps(stats.as_dict())}")

    # 16, stage by stage: pack, copy, kernel and copy back of that tile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b50 = sw_long.pack_sw_long(pairs)
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    t50 = sw_long.tile_to_torch(b50, dev)
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    kw50 = dict(k_strips=b50.n_strips, strip_w=b50.strip_w,
                ny_max=b50.ny_max)
    t0 = time.perf_counter()
    got = sw_long.sw_forward_long(*t50, **kw50)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = got.cpu().numpy()
    t_d2h = time.perf_counter() - t0
    check(np.array_equal(host, scores), "the staged tile != the engine's")
    geo50 = sw_long.geometry(b50.n_strips * b50.strip_w, b50.ny_max)
    halo_mb = 128 * geo50.halo_entries * 8 / 1e6
    print(f"phase 16 stages, s: pack {t_pack:.4f}, h2d {t_h2d:.4f}, kernel "
          f"{t_kernel:.4f}, d2h {t_d2h:.4f}; tile {nbytes(*t50) / 1e6:.1f} MB, "
          f"halo {halo_mb:.1f} MB; pack of {b50.n_strips} strips of "
          f"{b50.strip_w}, kernel at R = {sw_long.LONG_R}: "
          f"{geo50.n_sub} sub-strips of {geo50.height} rows, "
          f"{geo50.threads} threads")

    # 16, kernel vs plain on that tile: every lane against the plain
    # full-height sweep (all 50,176 rows at once over 100,001 diagonals; the
    # plain strip sweep would take 49 times the steps), in one timed call;
    # beside it, on host threads, the native model (seconds per 50kbp
    # pair: one thread each) on four sampled pairs
    sample = [0, LP_PAIRS // 2, 77, LP_PAIRS - 1]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        t0 = time.perf_counter()
        native_ref = pool.submit(native_sw, native,
                                 [pairs[i] for i in sample],
                                 threads=len(sample))
        _, anchor50, _ = sw_long._layout(b50.ny_max, b50.strip_w)
        want = []
        sl_plain_ms = one_ms(lambda: want.append(sw_long_forward_dense(
            t50[0], t50[1], b50.n_diags, b50.ny_max, anchor50)), torch)
        ref = native_ref.result()
        t_native = time.perf_counter() - t0
    check(np.array_equal(scores[sample], ref),
          f"engine {scores[sample]} != native {ref} on the sampled pairs")
    print(f"phase 16 {len(sample)} sampled pairs == native model (native "
          f"{t_native:.1f} s on {len(sample)} threads, beside the plain "
          "sweep)")
    lp_pairs, lp_scores, lp_sample, lp_ref = pairs, scores, sample, ref
    err = int((got.long() - want[0].long()).abs().max())
    sl_err = max(sl_err, err)
    check(err == 0, f"long-pair SW kernel != plain full-height sweep on the "
                    f"50kbp tile: max |diff| {err}")
    check(np.array_equal(want[0].cpu().numpy(), scores),
          "the engine's scores != the plain full-height sweep's")
    print(f"phase 16 sw long kernel == plain on the 50kbp tile: all "
          f"{LP_PAIRS} scores exact against the plain full-height sweep "
          f"({b50.n_strips * b50.strip_w} rows x {b50.n_diags} diagonals), "
          f"plain {sl_plain_ms:.1f} ms (one call)")

    # 17. short and long pairs in one call
    rng = np.random.default_rng(SEED + 4)
    pairs = []
    for _ in range(MX_PAIRS):
        nx_ = int(rng.integers(MX_X_LENS[0], MX_X_LENS[1] + 1))
        pairs.append(SWPair(sx=random_dna(rng, nx_), sy=random_dna(
            rng, nx_ + int(rng.integers(0, 1001)))))
    n_long = sum(len(p.sx) + 2 > eng.cfg.max_device_len for p in pairs)
    e17 = Engine(EngineConfig(sw_strips=True), device="cuda")
    launch0 = trace.counts()
    t0 = time.perf_counter()
    scores = e17.sw_scores(pairs)
    wall = time.perf_counter() - t0
    mx_long, mx_tile, mx_strips, mx_rotor = (
        trace.launched(r, launch0)
        for r in ("sw_long", "tile", "strips", "rotor"))
    stats = e17.last_stats
    check(0 < n_long < MX_PAIRS and stats.offloaded_jobs == n_long,
          f"{stats.offloaded_jobs} offloaded, {n_long} long of {MX_PAIRS}")
    check(mx_long == -(-n_long // 128) and mx_tile >= 1 and mx_strips >= 1
          and mx_tile + mx_strips + mx_rotor == stats.buckets,
          f"{mx_long} long-pair launches for {n_long} pairs, {mx_tile} "
          f"lane-tile, {mx_strips} strips and {mx_rotor} rotor launches for "
          f"{stats.buckets} buckets")
    sample = np.random.default_rng(SEED + 5).choice(MX_PAIRS, 256,
                                                    replace=False)
    ref = native_sw(native, [pairs[i] for i in sample])
    check(np.array_equal(scores[sample], ref),
          "engine != native model on the mixed file's sampled pairs")
    print(f"phase 17 sw mixed: {MX_PAIRS} pairs, x {MX_X_LENS[0]}-"
          f"{MX_X_LENS[1]}bp, engine wall {wall:.3f} s, {mx_tile} lane-tile, "
          f"{mx_strips} strips and {mx_rotor} rotor launches for "
          f"{MX_PAIRS - n_long} pairs, "
          f"{mx_long} long-pair launches for {n_long} pairs, 256 sampled "
          f"pairs == native model in input order, "
          f"stats {json.dumps(stats.as_dict())}")
    mx_pairs, mx_scores = pairs, scores

    # 18. long-pair kernel timing on the 50kbp tile: each R's result ==
    # phase 16's, the default R timed twice (every R's times: PERF.md §6,
    # row 5)
    for r in sw_long.ROWS_PER_THREAD:
        check(torch.equal(sw_long.sw_forward_long(
            *t50, **kw50, _rows_per_thread=r), got),
              f"sw_long at R = {r} != R = {sw_long.LONG_R} on the 50kbp "
              "tile")
    k1, k2 = (slope_ms(lambda: sw_long.sw_forward_long(*t50, **kw50), torch,
                       3) for _ in range(2))
    sl_kernel_ms = (k1 + k2) / 2
    cells = LP_PAIRS * LP_LEN * LP_LEN
    sl_bound = bound_ms(nbytes(*t50) + 4 * 128, cells * SW_OPS_PER_CELL,
                        int32_ops)
    print(f"phase 18 sw long timing, tile of {LP_PAIRS} pairs {LP_LEN} x "
          f"{LP_LEN}, every R of {sw_long.ROWS_PER_THREAD} == phase 16's "
          f"scores; the default R = {sw_long.LONG_R}: {k1:.3f} / {k2:.3f} "
          f"ms, mean {sl_kernel_ms:.3f} ms, "
          f"bound {sl_bound[0]:.4f} ms by {sl_bound[1]}; GCUPS kernel "
          f"{cells / sl_kernel_ms / 1e6:.2f}, plain "
          f"{cells / sl_plain_ms / 1e6:.2f} at phase 16's {sl_plain_ms:.1f} "
          f"ms (cells = sum len(sx)*len(sy), {cells})")

    # 38. past 1,024 rows: the block forms, strips and the engine walls
    t0 = time.perf_counter()
    tall = tall_phase((mx_pairs, mx_scores), batch, int32_ops, ph_kernel_ms)
    max_err = max(max_err, tall["sw_err"])
    ph_err = max(ph_err, tall["ph_err"])
    print(f"phase 38 took {time.perf_counter() - t0:.1f} s")

    # 39. past 4,096 rows: the 32-warp forms, the routes past them
    t0 = time.perf_counter()
    deep = deep_phase(int32_ops)
    max_err = max(max_err, deep["sw_err"])
    ph_err = max(ph_err, deep["ph_err"])
    print(f"phase 39 took {time.perf_counter() - t0:.1f} s")

    # 30. the cross-device strip kernel vs its plain version, then the
    # K-strip ring, each strip's halo handed to the next, on the card
    xs_err, t0 = 0, time.perf_counter()
    for ci, c in enumerate(CFGS):
        cfg = SWConfig(**c)
        for w in XSTRIP_WIDTHS:
            for U in XSTRIP_UNROLLS:
                sxb, slab, hD, hQ, st = (
                    torch.from_numpy(a).to(dev) if not isinstance(a, tuple)
                    else tuple(torch.from_numpy(b).to(dev) for b in a)
                    for a in cases.xstrip_inputs(1000 * ci + w + U, w, U))
                want = sw_xstrip_block(sxb, slab, hD, hQ, st, w=w, U=U,
                                       cfg=cfg)
                lane_major = tuple(a.t().contiguous().t() for a in st)
                got = {"contiguous": xsharded.strip_block(
                           sxb, slab, hD, hQ, st, w=w, U=U, cfg=cfg),
                       "lane-major in place": xsharded.strip_block(
                           sxb, slab, hD, hQ, lane_major, w=w, U=U, cfg=cfg,
                           out=lane_major)}
                torch.cuda.synchronize()
                for name, g in got.items():
                    for i, (a, b) in enumerate(zip((*g[0], g[1], g[2]),
                                                   (*want[0], want[1],
                                                    want[2]))):
                        err = int((a.long() - b.long()).abs().max())
                        xs_err = max(xs_err, err)
                        check(err == 0, f"sw_xstrip ({name}) output {i} != "
                                        f"plain at w={w}, U={U} under {cfg}:"
                                        f" max |diff| {err}")
                # every R on partial windows, in place: the plain block on
                # the slice (zeros above g_lo > 0, zero halo out below
                # g_hi < w), the rows outside bit for bit as they were
                zero = torch.zeros_like(hD)
                for g_lo, g_hi in ((0, w), (w // 3, w), (0, w // 2 + 1),
                                   (w // 4, w - w // 5)):
                    if g_lo >= g_hi:
                        continue
                    sl = slice(g_lo, g_hi)
                    top = (hD, hQ) if g_lo == 0 else (zero, zero)
                    part = sw_xstrip_block(
                        sxb[sl], slab[g_lo: g_hi + U], *top,
                        tuple(a[sl] for a in st), w=g_hi - g_lo, U=U,
                        cfg=cfg)
                    for r in xsharded.ROWS_PER_THREAD:
                        io = tuple(a.t().contiguous().t() for a in st)
                        _, bD, bQ = xsharded.strip_block(
                            sxb, slab, hD, hQ, io, w=w, U=U, cfg=cfg, out=io,
                            rows=(g_lo, g_hi), _rows_per_thread=r)
                        torch.cuda.synchronize()
                        ok = all(torch.equal(a[sl], b) and torch.equal(
                                     a[:g_lo], c[:g_lo]) and torch.equal(
                                     a[g_hi:], c[g_hi:])
                                 for a, b, c in zip(io, part[0], st))
                        ok = ok and all(
                            torch.equal(a, b if g_hi == w else
                                        torch.zeros_like(b))
                            for a, b in zip((bD, bQ), part[1:]))
                        check(ok, f"sw_xstrip at R = {r}, rows ({g_lo}, "
                                  f"{g_hi}) != plain on the slice at w={w}, "
                                  f"U={U} under {cfg}")
        print(f"phase 30 xstrip kernel == plain: w {XSTRIP_WIDTHS} x U "
              f"{XSTRIP_UNROLLS}, contiguous and lane-major in place, {cfg}, "
              f"8 outputs exact; at R = {xsharded.ROWS_PER_THREAD} on the "
              f"whole strip and partial windows, the window == the plain "
              f"block on the slice and the rows outside untouched "
              f"({time.perf_counter() - t0:.1f} s so far)")
    # the longest block, U = MAX_UNROLL, on two sub-strips: the prefetch of
    # the next sub-strip's state has no room beside the block's 5U ints,
    # so the kernel moves the lane-major state by int4 straight from memory
    w, U = 8000, xsharded.MAX_UNROLL
    sxb, slab, hD, hQ, st = (
        torch.from_numpy(a).to(dev) if not isinstance(a, tuple)
        else tuple(torch.from_numpy(b).to(dev) for b in a)
        for a in cases.xstrip_inputs(11, w, U))
    want = sw_xstrip_block(sxb, slab, hD, hQ, st, w=w, U=U)
    for r in xsharded.ROWS_PER_THREAD:
        io = tuple(a.t().contiguous().t() for a in st)
        moves = xsharded._moves([a.data_ptr() for a in io], 1, w,
                                xsharded._threads(w, r), r, U)
        check(moves == (True, False), f"U = {U}, R = {r}: moves {moves}")
        got = xsharded.strip_block(sxb, slab, hD, hQ, io, w=w, U=U, out=io,
                                   _rows_per_thread=r)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip((*got[0], got[1], got[2]),
                                       (*want[0], want[1], want[2]))):
            err = int((a.long() - b.long()).abs().max())
            xs_err = max(xs_err, err)
            check(err == 0, f"sw_xstrip at U = {U}, R = {r}: output {i} != "
                            f"plain, max |diff| {err}")
    print(f"phase 30 xstrip kernel == plain at U = {U} (MAX_UNROLL), w {w}, "
          f"lane-major in place, no prefetch, R = "
          f"{xsharded.ROWS_PER_THREAD}, 8 outputs exact "
          f"({time.perf_counter() - t0:.1f} s so far)")
    ring_cases = cases.xshard_cases() + [
        ("4kbp tile", cases.long_sw_pairs(3), 32)]
    ring_native = {name: native_sw(native, pairs)
                   for name, pairs, _ in ring_cases}
    for K in XSTRIP_RINGS:
        n_launch = n_window = 0
        for name, pairs, U in ring_cases:
            pk = xsharded.pack_sw_xsharded(pairs, K, unroll=U)
            sx, sy = (torch.from_numpy(a).to(dev) for a in (pk.sx, pk.sy))
            kw = dict(n_strips=K, strip_w=pk.strip_w, n_diags=pk.n_diags,
                      unroll=U, anchor=pk.anchor)
            launch0 = trace.counts()
            got = xsharded.sw_forward_xsharded_ring(sx, sy, **kw)
            n = trace.launched("xstrip", launch0)
            plain = xsharded.sw_forward_xsharded_ring(
                sx, sy, block=sw_xstrip_block, **kw)
            torch.cuda.synchronize()
            check(n == K * xsharded.n_blocks(pk.n_diags, U, K),
                  f"{n} xstrip launches for the {name} ring at K = {K}")
            err = int((got.long() - plain.long()).abs().max())
            xs_err = max(xs_err, err)
            check(err == 0, f"xstrip ring ({name}, K = {K}) != plain ring: "
                            f"max |diff| {err}")
            check(np.array_equal(got.cpu().numpy()[: len(pairs)],
                                 ring_native[name])
                  and not bool(got[len(pairs):].any()),
                  f"xstrip ring ({name}, K = {K}) != native model")
            # windowed to the live rows, as the forward runs
            ly_max = xsharded.tile_ly_max(pk)
            live = sum(
                lo < hi for b in range(xsharded.n_blocks(pk.n_diags, U, K))
                for k in range(K)
                for lo, hi in [xsharded.live_rows(
                    k, b, strip_w=pk.strip_w, unroll=U, ly_max=ly_max)])
            launch0 = trace.counts()
            windowed = xsharded.sw_forward_xsharded_ring(sx, sy, **kw,
                                                         ly_max=ly_max)
            nw = trace.launched("xstrip", launch0)
            torch.cuda.synchronize()
            check(nw == live and torch.equal(windowed, plain),
                  f"windowed xstrip ring ({name}, K = {K}): {nw} launches "
                  f"(want {live} windows), equal to the plain ring: "
                  f"{torch.equal(windowed, plain)}")
            n_launch += n
            n_window += nw
        print(f"phase 30 xstrip ring, K = {K}: {len(ring_cases)} cases "
              f"({', '.join(n for n, _, _ in ring_cases)}) == plain ring == "
              f"native, exact, {n_launch} launches; windowed to the live "
              f"rows == plain ring, {n_window} launches (the non-empty "
              f"windows) ({time.perf_counter() - t0:.1f} s so far)")

    # 31. the cross-device path through ShardedEngine on a one-rank NCCL
    # mesh: phase 16's tile, then phase 17's file and phase 9's jobs
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    t0 = time.perf_counter()
    initialize_distributed(f"localhost:{port}", 1, 0, backend="nccl",
                           timeout_s=300)
    t_init = time.perf_counter() - t0
    try:
        mesh = make_mesh(1, device="cuda")
        check(mesh.group is not None and mesh.size == 1
              and torch.distributed.get_backend() == "nccl",
              f"mesh {mesh}, backend {torch.distributed.get_backend()}")
        xeng = ShardedEngine(mesh, EngineConfig(xshard_min_len=XS_MIN_LEN))
        launch0 = trace.counts()
        t0 = time.perf_counter()
        scores = xeng.sw_scores(lp_pairs)
        wall = time.perf_counter() - t0
        xs_launches = trace.launched("xstrip", launch0)
        stats = xeng.last_stats
        xs_unroll = xeng.cfg.unroll
        xs_blocks = xsharded.n_blocks(2 * LP_LEN + 1, xs_unroll, 1)
        # the blocks whose live-row window is not empty (ly_max 50,000)
        xs_windows = [xsharded.live_rows(0, b, strip_w=LP_LEN + 8,
                                         unroll=xs_unroll, ly_max=LP_LEN)
                      for b in range(xs_blocks)]
        xs_live = sum(lo < hi for lo, hi in xs_windows)
        xs_rows = sum(max(0, hi - lo) for lo, hi in xs_windows)
        check(stats.xsharded_jobs == stats.offloaded_jobs == LP_PAIRS,
              f"xsharded_jobs {stats.xsharded_jobs}, offloaded_jobs "
              f"{stats.offloaded_jobs} of {LP_PAIRS}")
        xs_long, xs_tile = (trace.launched("sw_long", launch0),
                            trace.launched("tile", launch0))
        check(xs_launches == xs_live and xs_long == 0 and xs_tile == 0,
              f"{xs_launches} xstrip launches (want the {xs_live} non-empty "
              f"windows of {xs_blocks} blocks), {xs_long} long-pair, "
              f"{xs_tile} lane-tile")
        check(np.array_equal(scores, lp_scores),
              "the cross-device scores != phase 16's sw_long scores")
        check(int(scores[LP_PAIRS // 2]) == LP_LEN,
              f"the identical pair scored {int(scores[LP_PAIRS // 2])}")
        check(np.array_equal(scores[lp_sample], lp_ref),
              "the cross-device scores != native on the sampled pairs")
        print(f"phase 31 xshard main path: ShardedEngine on a one-rank NCCL "
              f"mesh (init {t_init:.2f} s), {LP_PAIRS} x {LP_LEN}bp x "
              f"{LP_LEN}bp, xshard_min_len {XS_MIN_LEN}, unroll {xs_unroll}: "
              f"wall {wall:.3f} s, {xs_launches} xstrip launches of "
              f"{xs_blocks} blocks (windows of {xs_rows} rows in all, "
              f"{xs_rows / (xs_blocks * (LP_LEN + 8)):.3f} of the full "
              f"sweep's), 0 long-pair"
              f", xsharded_jobs {stats.xsharded_jobs}, all {LP_PAIRS} == "
              f"phase 16's sw_long scores, identical pair {LP_LEN}, "
              f"{len(lp_sample)} sampled == native, stats "
              f"{json.dumps(stats.as_dict())}")

        # 31, stage by stage: pack, copy, forward of that tile
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pkx = xsharded.pack_sw_xsharded(lp_pairs, 1, unroll=xs_unroll)
        t_pack = time.perf_counter() - t0
        t0 = time.perf_counter()
        sxs = torch.from_numpy(pkx.sx).to(dev)
        sys_ = torch.from_numpy(pkx.sy).to(dev)
        torch.cuda.synchronize()
        t_h2d = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = xsharded.sw_forward_xsharded(
            sxs, sys_, mesh=mesh, strip_w=pkx.strip_w, n_diags=pkx.n_diags,
            unroll=xs_unroll, anchor=pkx.anchor,
            ly_max=xsharded.tile_ly_max(pkx))
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        check(np.array_equal(got.cpu().numpy(), scores)
              and pkx.strip_w == LP_LEN + 8
              and xsharded.tile_ly_max(pkx) == LP_LEN,
              "the staged forward != the engine's")
        print(f"phase 31 stages, s: pack {t_pack:.4f}, h2d {t_h2d:.4f}, "
              f"forward {t_fwd:.4f} ({pkx.n_diags} diagonals in "
              f"{xs_launches} blocks of {xs_unroll}, one strip of "
              f"{pkx.strip_w} rows, state {6 * pkx.strip_w * 128 * 4 / 1e6:.1f}"
              f" MB)")

        t0 = time.perf_counter()
        scores = xeng.sw_scores(mx_pairs)
        wall = time.perf_counter() - t0
        check(np.array_equal(scores, mx_scores),
              "ShardedEngine != Engine on phase 17's mixed file")
        check(xeng.last_stats.xsharded_jobs == 0,
              f"{xeng.last_stats.xsharded_jobs} mixed pairs took xshard")
        print(f"phase 31 xshard mixed: {MX_PAIRS} pairs through "
              f"ShardedEngine == Engine, exact, wall {wall:.3f} s, stats "
              f"{json.dumps(xeng.last_stats.as_dict())}")
        t0 = time.perf_counter()
        values = xeng.pairhmm([ph_batch])
        wall = time.perf_counter() - t0
        err = float(np.abs(values - ph_values).max())
        check(err <= 1e-5 and xeng.last_stats.fallback_jobs == ph_fallbacks,
              f"ShardedEngine PairHMM vs Engine: max |err| {err}, fallbacks "
              f"{xeng.last_stats.fallback_jobs} vs {ph_fallbacks}")
        print(f"phase 31 xshard pairhmm: {len(values)} jobs through "
              f"ShardedEngine, max |err| vs Engine {err:.3g}, fallbacks "
              f"{ph_fallbacks} both, wall {wall:.3f} s")
    finally:
        torch.distributed.destroy_process_group()

    # 32. the strip kernel on one block at the 50kbp shape, in place as the
    # forward runs it, in turns with the plain block; the rings on the 4kbp
    # tile by one call each
    w, U = pkx.strip_w, xs_unroll
    s = xsharded.slab_start(pkx.anchor, 0, xs_blocks // 2, strip_w=w, unroll=U,
                            ndt=pkx.sy.shape[0])
    slab = sys_[s: s + w + U]
    zh = torch.zeros((U, 128), dtype=torch.int32, device=dev)
    st = xsharded.new_state(w, dev)
    got = xsharded.strip_block(sxs, slab, zh, zh, st, w=w, U=U)
    plain = sw_xstrip_block(sxs, slab, zh, zh, st, w=w, U=U)
    torch.cuda.synchronize()
    for a, b in zip((*got[0], got[1], got[2]),
                    (*plain[0], plain[1], plain[2])):
        err = int((a.long() - b.long()).abs().max())
        xs_err = max(xs_err, err)
        check(err == 0, f"sw_xstrip != plain on the 50kbp block: {err}")
    pst = tuple(a.contiguous() for a in st)
    plain_blk = lambda: sw_xstrip_block(  # noqa: E731
        sxs, slab, zh, zh, pst, w=w, U=U)
    # the kernel at each R in turns (4, 8, 16, 16, 8, 4), the plain block
    # before and after, each R == the default's on that block
    xs_r_ms = {r: [] for r in xsharded.ROWS_PER_THREAD}
    p1 = slope_ms(plain_blk, torch)
    for r in xsharded.ROWS_PER_THREAD + xsharded.ROWS_PER_THREAD[::-1]:
        kern = lambda: xsharded.strip_block(  # noqa: E731
            sxs, slab, zh, zh, st, w=w, U=U, out=st, _rows_per_thread=r)
        one = xsharded.strip_block(sxs, slab, zh, zh,
                                   xsharded.new_state(w, dev), w=w, U=U,
                                   _rows_per_thread=r)
        check(all(torch.equal(a, b) for a, b in zip(
            (*one[0], one[1], one[2]), (*got[0], got[1], got[2]))),
            f"sw_xstrip at R = {r} != R = {xsharded.XSTRIP_R} on the 50kbp "
            "block")
        xs_r_ms[r].append(slope_ms(kern, torch))
    p2 = slope_ms(plain_blk, torch)
    k1, k2 = xs_r_ms[xsharded.XSTRIP_R]
    xs_kernel_ms, xs_plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    xs_bound = bound_ms(nbytes(sxs, slab, zh, zh) + 2 * nbytes(*st)
                        + 2 * nbytes(zh), SW_OPS_PER_CELL * w * U * 128,
                        int32_ops)
    pk4 = xsharded.pack_sw_xsharded(ring_cases[-1][1], 1, unroll=U)
    sx4, sy4 = (torch.from_numpy(a).to(dev) for a in (pk4.sx, pk4.sy))
    kw4 = dict(n_strips=1, strip_w=pk4.strip_w, n_diags=pk4.n_diags,
               unroll=U, anchor=pk4.anchor)
    r4_plain_ms = one_ms(lambda: xsharded.sw_forward_xsharded_ring(
        sx4, sy4, block=sw_xstrip_block, **kw4), torch)
    r4_kernel_ms = one_ms(lambda: xsharded.sw_forward_xsharded_ring(
        sx4, sy4, **kw4), torch)
    cells = LP_PAIRS * LP_LEN * LP_LEN
    print(f"phase 32 xstrip timing, one full-window block of w {w} rows x "
          f"U {U} x 128 lanes, in place, ms per call in turns: " + ", ".join(
              f"R={r} {a:.4f} / {b:.4f}" for r, (a, b) in xs_r_ms.items())
          + f"; the default R = {xsharded.XSTRIP_R}: kernel {k1:.4f} / "
          f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} "
          f"ms per call, bound {xs_bound[0]:.4f} ms by {xs_bound[1]} (bytes "
          f"{(nbytes(sxs, slab, zh, zh) + 2 * nbytes(*st) + 2 * nbytes(zh)) / HBM_BYTES_PER_S * 1e3:.4f}"
          f" ms, operations {SW_OPS_PER_CELL * w * U * 128 / int32_ops * 1e3:.4f}"
          f" ms); {xs_launches} windowed launches, windows of {xs_rows} "
          f"rows = {xs_rows / w:.1f} full blocks x {xs_kernel_ms:.4f} ms = "
          f"{xs_rows / w * xs_kernel_ms / 1e3:.3f} s of kernel; forward wall "
          f"{t_fwd:.3f} s ({cells / t_fwd / 1e9:.2f} GCUPS) against phase "
          f"18's sw_long {sl_kernel_ms / 1e3:.3f} s per tile; 4kbp tile "
          f"(K = 1, {xsharded.n_blocks(pk4.n_diags, U, 1)} blocks): kernel "
          f"ring {r4_kernel_ms:.1f} ms, plain ring {r4_plain_ms:.1f} ms (one "
          f"call each)")

    # 34. the stream against the one-shot engine on phases 4, 22 and 9's
    # workloads and bench.py's 100,000 x 512bp, walls in turns
    t0 = time.perf_counter()
    headline = stream_phase(sw512, sw64, (ph_batch, ph_values, ph_fallbacks))
    print(f"phase 34 took {time.perf_counter() - t0:.1f} s")

    # 35. the command line on the card
    t0 = time.perf_counter()
    cli_phase(_build.KERNELS)
    print(f"phase 35 took {time.perf_counter() - t0:.1f} s")

    # 36. parity, soak, bench and bench-dist on the card
    t0 = time.perf_counter()
    harness_phase({"rotor": rotor_ms, "strips": strips_ms,
                   "pairhmm": ph_kernel_ms})
    print(f"phase 36 took {time.perf_counter() - t0:.1f} s")

    # 37. the transfer ladder: the forms on the card, the engine walls
    t0 = time.perf_counter()
    ladder_phase(sw512, sw64, headline)
    print(f"phase 37 took {time.perf_counter() - t0:.1f} s")

    # 6. the card
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    check("jax" not in sys.modules, "jax was imported")

    def entry(name, source, replaces, n_launches, err, ms, plain_ms, bound,
              **more):
        return {"name": name, "route": "cuda",
                "source": f"genomax_torch/csrc/{source}",
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None,  # no one PyTorch call computes either
                **more}

    # Each row at the shape its main path gives the kernel, kernel and
    # plain alike; sw_long's plain version is the full-height sweep. The
    # lane-tile kernel's launches are phase 4's sw_strips=False run's, the
    # strips kernel's the sw_strips=True run's (both with the default R,
    # the ms of every R in ms_by_r; the lane tile's default route, phase
    # 33, beside it), the rotor's phase 22's
    # first run that the predicates send to it (its default geometry's ms,
    # every geometry's and queue depth's in ms_by_geometry and
    # ms_by_slots), the stacked kernel's (at S = 4 and its default R, as
    # its times; every S and R in ms_by_geometry) phase 25's sw_stack=4
    # run's, the conveyor's (at
    # the library default of 64 slots and its default geometry, as its
    # times; each depth's in ms_by_slots, each depth's geometries' in
    # ms_by_geometry, the tall window's in tall_ms_by_geometry) phase
    # 28's.
    print(json.dumps({"kernels": [
        entry("sw_tile", "sw_tile.cu", "genomax/kernels/sw_pallas.py:42",
              launches, max_err, kernel_ms, plain_ms, sw_bound,
              rows_per_thread=tile_r, ms_by_r=tile_ms_by_r,
              default_route={
                  "shape": [DR_PAIRS, DR_X_LEN, DR_Y_LEN],
                  "rows_per_thread": dr_geo.rows_per_thread,
                  "launches": dr_launches, "ms": dr_ms,
                  "plain_ms": dr_plain_ms, "bound_ms": dr_bound[0],
                  "bound_by": dr_bound[1]},
              past_1024_rows=tall["sw_tile"],
              past_4096_rows=deep["sw_tile"]),
        entry("sw_strips", "sw_strips.cu", "genomax/kernels/sw_strips.py:68",
              strips_launches, strips_err, strips_ms, strips_plain_ms,
              strips_bound, rows_per_thread=strips_r,
              ms_by_r=strips_ms_by_r, past_1024_rows=tall["sw_strips"],
              past_4096_rows=deep["sw_strips"]),
        entry("sw_rotor", "sw_rotor.cu", "genomax/kernels/sw_rotor.py:141",
              rotor_launches, rotor_err, rotor_ms, rotor_plain_ms,
              rotor_bound, geometry=dataclasses.asdict(rotor_geo),
              ms_by_geometry=rotor_ms_by_geo,
              ms_by_slots={str(k): list(v)
                           for k, v in rotor_ms_by_slots.items()}),
        entry("sw_stacked", "sw_stacked.cu",
              "genomax/kernels/sw_stacked.py:63", stacked_launches[4],
              stacked_err, stacked_ms, stacked_plain_ms, stacked_bound,
              geometry={"stack": 4, **dataclasses.asdict(stk_in[4][2])},
              ms_by_geometry=stacked_ms_by_geo),
        entry("sw_conveyor", "sw_conveyor.cu",
              "genomax/kernels/sw_conveyor.py:135", conveyor_launches,
              conveyor_err, conveyor_ms, conveyor_plain_ms, conveyor_bound,
              geometry=dataclasses.asdict(conveyor_geo),
              ms_by_slots={str(k): list(v) for k, v in conv_ms.items()},
              ms_by_geometry=conveyor_ms_by_geo,
              tall_ms_by_geometry=tall_ms_by_geo),
        entry("sw_long", "sw_long.cu", "genomax/kernels/sw_long.py:126",
              lp_launches, sl_err, sl_kernel_ms, sl_plain_ms, sl_bound,
              past_4096_rows=deep["sw_long"]),
        entry("sw_xstrip", "sw_xstrip.cu", "genomax/dist/xsharded.py:72",
              xs_launches, xs_err, xs_kernel_ms, xs_plain_ms, xs_bound),
        entry("pairhmm_tile", "pairhmm_tile.cu",
              "genomax/kernels/pairhmm_pallas.py:93", ph_launches, ph_err,
              ph_kernel_ms, ph_plain_ms, ph_bound,
              block_form=tall["pairhmm_tile"],
              block_form_past_2048=deep["pairhmm_tile"]),
        entry("pairhmm_long", "pairhmm_long.cu",
              "genomax/kernels/pairhmm_long.py:130", lr_launches, lr_err,
              lr_kernel_ms, lr_plain_ms, lr_bound,
              past_2048_rows=deep["pairhmm_long"])]}))
    print(f"phase 6 elapsed: {time.perf_counter() - t_start:.1f} s")
    print(f"phase 6 card: {smi.stdout.strip()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
