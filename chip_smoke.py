#!/usr/bin/env python3
"""Drive the repro_torch paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and ``nvcc``.
Phases, each of which fails the run (non-zero exit) on error:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``; print
   ``nvcc -Xptxas -v``'s registers, shared memory and spills per kernel, the
   instructions per recurrence step (Sturm) and per term (prod-diff) in the
   SASS of the kernels' inner loops (``cuobjdump -sass``), and the Sturm
   kernel's launch geometry at each of its shapes;
2. hold each kernel against its plain PyTorch version at the main path's
   shapes (b = 16 matrices of n = 600), in float64 and float32:
   - the Sturm kernel bitwise on the spectrum, the k = 8 window and all
     9600 minor bands, and the prod-diff kernel within its tolerance, also
     on terms from the floor up to ~1e300 (1e30 in float32); the two
     bitwise contracts (a Sturm window equals the slice of the full
     spectrum; windowed prod-diff rows equal the full table's rows);
   - the segmented Sturm kernel, bitwise, on the 16 bands packed 4 to a row
     and on the 9600 minor bands packed 4 to a row, and from warm brackets
     after a rank-1 update (some made stale on purpose); with one full-band
     segment it equals the Sturm kernel's window bitwise;
   - the masked (random per-matrix mask) and single-matrix prod-diff
     kernels;
3. run ``SolverEngine`` on the ``cuda`` backend (solve, windowed and full
   top-k, eigenvalues full and windowed) and check each result against
   ``torch.linalg.eigh``;
4. run the masked and single-matrix prod-diff kernels through their op
   entry points (``logabs_sum_batched(mask=)``, ``logabs_sum``,
   ``eei_magnitudes``) and check what they compute;
5. run a streaming session at n = 600, k = 8 (2 warm-up rank-1 updates, 32
   at 1% of ``||A||_F``, 2 at 60%) and check every step against float64
   ``eigvalsh`` and the verify stage: the stream must take the fast path
   with one segmented-Sturm launch per update, bitwise its plain version on
   each update's operands, and the large updates must force a drift
   re-solve, with no verify re-solve; the host rung may run only for a
   float32 re-solve after a large update, and only where the card's own
   re-solve of that matrix fails verify;
6. run the packed top-k program (``packed_topk_program(packed_plan_for(
   512), 8, largest=True, verify=True)``) on 64 rows packing 16 seeded
   requests of n = 32 each, in float64 and float32: one kernel-3 launch a
   call, bitwise its plain version on the program's own operands; every
   slot within 5e-4 * max(1, |lambda|max) of float64 eigvalsh of its
   request; every per-slot verify flag ok, but for float32 slots that miss
   only the in-segment mass (as repro's chain does); its wall time beside
   ``torch.linalg.eigh`` of the (1024, 32, 32) requests, split by stage;
   and the eigh chain the same way at the server's default width 64;
7. run the dense compositions (``eei_dense`` and ``eei_dense_windowed``,
   named plans) on 64 seeded matrices of n = 64 per dtype: solve, windowed
   and full top-k (k = 8), eigenvalues, held to phase 3's gates; kernel 2
   must launch once per solve and top-k (with I = k in the windowed one) and
   never for eigenvalues, each launch within tolerance of its plain
   version, the windowed rows bitwise the full table's; each call timed
   beside ``torch.linalg.eigh`` of the stack;
8. run the Krylov compositions (``eei_krylov``, and ``eei_krylov_si`` at
   the direct leg's band m = 256) on the throughput lane's n = 4096
   matrix, k = 16, per dtype: top-k and
   eigenvalues within 5e-3 of float64 eigh (eigenvalue error over the
   span, residual over max |lambda|); every kernel-1 launch (the window on
   the band and the Lanczos residual checks) bitwise its plain version;
   the Lanczos steps per call; top-k timed beside ``torch.linalg.eigh``
   and, once in float32, the windowed Householder chain;
9. run ``calibrate(smoke=True)`` on the card and check every field, and
   print the committed calibration table (the smoke sweep writes no file);
10. time each kernel (CUDA events) beside its bound, its plain version and
   the library yardstick (the Sturm kernel also on the k = 8 window, the
   segmented kernel also alone at the shapes the session and the packed
   program launch it, there also by its card time in a CUDA graph),
   split one solve into its stages, and time the end-to-end solve against
   ``torch.linalg.eigh`` and the session update against a top-k from
   scratch;
11. serve five streams through ``EeiServer`` on the card, each request
   checked against float64 ``torch.linalg.eigh``: (1) 64 mixed requests
   (n in {96, 192, 288}, k in 1..8) with each bucket planned under the
   committed table, caller-driven and threaded (linger 2 ms), beside the
   ``--sync`` loop of ``launch/serve.py`` on the same stream; (2) the main
   path's 16 matrices of n = 600 in float64 under a named ``eei_tridiag``
   plan, bitwise ``topk_program(plan, 8, True, verify=True)`` on the
   recorded stack; (3) 64 packed requests (n in {16, 32, 48}) at rows of
   512, kernel 3's chain; (4) stream 1 threaded under 5% chaos a point,
   then caller-driven under launch and NaN faults that must reach the
   fallback chain, with no failed request; (5) a session on the first
   n = 600 matrix, 8 updates at ~1% of ||A||_F.  Stream 1 is also served
   one request at a time under the server's bucket plans, beside the
   ``--sync`` loop's one plan.  No plain version may run on these paths,
   and no retry, bisection, verify miss or fallback may happen but for the
   causes a stream allows (none in 1, 2 and 5; verify misses in 3;
   injected faults in 4); every launch of kernels 1 and 3 in streams 1-3
   and 5 is held bitwise against its plain version afterwards, kernel 2's
   within its tolerance;
12. serve stream 1 through ``EeiFleet`` on the card, in five parts: (1)
   three in-process replicas, clean: 0 failed, redispatched, killed or
   deadline deaths, every key on its rendezvous owner (``route_key``) but
   for hedged attempts, beside phase 11's threaded single server; (2) the
   same under replica chaos from a seed whose schedule kills, hangs and
   slows a replica, the deadline set from part 1's p99: 0 failed, at
   least one kill, restart, redispatch and deadline death; (3) 16 of its
   requests through two worker processes that need the card, worker 0
   SIGKILLed mid-stream: nothing stranded, two compute processes more
   on the card than before the fleet (``nvidia-smi``), after the warm-up
   and again after the restart, with the workers' start time, HBM (the
   card's used memory before and with them) and restart time; (4) a session on the first
   n = 600 matrix whose replica is killed after 4 of 8 updates: the next
   result a ``DegradedResult("session_reopen")``, every step at the
   session gates; (5) ``launch/serve.py --replicas 3 --chaos-replicas``
   on the stream, 0 failed.  Every request at the served-request gates;
   every replica death, redispatch and session failover's cause read from
   the fleet's log (``_check_fleet_log``); no plain version on the path;
   every in-process launch of parts 1, 2 and 4 held against its plain
   version;
13. run the sharded backend (``core/distributed.py``) and the paper's
   ladder: the engine on a 1x1 mesh of the card (solve, windowed and full
   top-k, eigenvalues; float64 and float32), each result bitwise phase 3's
   on the ``cuda`` backend; the same on a logical 2x1 mesh (the card
   twice) at phase 3's gates, with each stage launching once a shard and a
   stack of 3 padded to 4; a session of 8 updates at ~1% of ||A||_F on a
   2x1 plan at the session gates; ``EeiServer(mesh=2x1)`` on stream 1,
   every bucket even, 0 failed, no retry or fallback, every request at the
   served-request gates; every launch of kernels 1 and 3 of the 2x1 runs
   held bitwise against its plain version, kernel 2 within its tolerance;
   the minor and term axes on a logical 1x2 mesh at n = 64 against the 1x1
   mesh and eigh; every ladder variant against float64 eigh at n = 12 and
   at the n = 200 (x10) overflow case, and one component per variant timed
   at n = 600 beside ``numpy_ref.numpy_full_eigh`` and
   ``numpy_ref.eigen_component_optimized`` on the host;
14. serve the language model at full published width, seeded weights drawn
   on the card, B = 2 greedy sequences of 16 tokens: gemma2-2b (prompts of
   5120 tokens, past its 4096-token window) in float32, its prefill's last
   logits within 1e-2 of max |logit| of a float64 run of the same weights
   and of a prefill of 5112 tokens plus 8 decode steps, then in bfloat16
   (params cast once) within 0.15 of float32; whisper-large-v3 (1500
   frames, prompts of 224 tokens) in float32, its float64 and consistency
   gates at full width and depth 1 + 1 (at full depth its random-weight
   attention is so sharp that even float64 moves by O(1) under a 2**-24
   nudge of the frames, printed); every logit finite, every token in the
   vocabulary; prefill ms, decode ms a token, tokens/s and peak memory
   beside each call's bound; then ``launch/serve.py --arch gemma2-2b
   --batch 4 --prompt-len 32 --gen 16`` in a subprocess on the card: exit
   0, a 4 x 16 array of token ids, a log that names ``cuda``.  The path
   runs no kernel of the repo: every launch count stays 0;
15. train: gemma2-2b at full published width (seeded weights drawn on the
   card, train_4k's 4096 tokens, a global batch of 2 in 2 microbatches,
   remat "all", float32), 3 steps of ``make_train_step`` with
   ``EigenPre()`` over ``AdamW()`` in ``repro``'s stacked layout: every
   loss and grad norm finite; step 1's refresh launches kernel 1 twice and
   kernel 2 once for each of the four eligible (13, 2304) norm stacks, and
   steps 2 and 3 launch none; each refreshed eigenpair set within phase
   3's float32 eigenvalue gate of float64 eigh, and the same top-k of the
   gram scaled to unit norm within 2e-3 of eigh's components |v|^2 for
   each eigenvector 1e-2 of ||A||_2 apart from the others (as refreshed,
   below scale 1, the signs are lost, in repro too: printed);
   then one bfloat16 step, its loss
   within 2% of the float32 loss at the same state and batch; step ms
   beside its bound, tokens/s, the refresh's ms and peak memory.  At depth
   2 and full width, 1024 tokens: float32 loss and gradients against
   float64, remat against none, 2 microbatches against the full batch.
   Reduced codeqwen1.5-7b, 30 EigenPre steps (rank 2, refresh every 10) on
   the repeating batches: the loss falls by 0.5, kernels 1 and 2 launch at
   each refresh and at no other step.  Every launch of the phase held
   against its plain version.  Then ``launch/train.py --arch gemma2-2b
   --reduced --eigenpre`` in subprocesses on the card: 20 steps with a
   checkpoint every 5, ``--resume`` to 25 (exit 0, a log that names
   ``cuda`` and resumes at step 20), and a run sent SIGTERM after 5 steps
   (a blocking checkpoint, then ``Preempted``).
16. the other block families at published width, seeded weights drawn on
   the card: zamba2-2.7b (Mamba2 with one shared attention set) and
   xlstm-125m (mLSTM and sLSTM) whole, B = 2 prompts of 4096 tokens, 16
   greedy tokens, float32 and bfloat16, their float64, prefill-then-decode
   and bfloat16 gates at full depth (xlstm) or at one period of the
   pattern (zamba2, whose whole random-weight model is ill-conditioned:
   printed); kimi-k2-1t-a32b and deepseek-v3-671b at one period of each
   pattern entry with all experts, bfloat16, prompts of 2048, every logit
   and the loss finite, their float32 gates at reduced width (a MoE's
   prefill-then-decode against the same path in float64); the sLSTM scan
   against autograd through its eager loop; zamba2 and xlstm trained as
   phase 15 trains gemma2-2b (step 1's refresh launching kernels 1 and 2
   on 40 and 9 stacked grams, each launch held against its plain
   version), reduced kimi and deepseek for 25 AdamW steps.
17. the sharded language model (``train.steps.build_programs``) on
   logical meshes of the card (the card repeated: parity, memory per
   shard and cost): gemma2-2b at full width, B = 2 prompts of 5120, 16
   greedy tokens, float32, on 1x1 (the mesh program against the
   unsharded one), 1x2 (heads split), 2x1 and 1x3 (the query sequence
   split), every step's logits within 1e-4 of max |logit| of the
   unsharded path fed its tokens, times, peak memory and the bytes each
   mesh position holds; one period of deepseek-v3-671b on 1x2 in
   bfloat16 within 0.05 of the unsharded bfloat16 path (its MoE's
   dropped pairs printed) and in float32 within 1e-4, its MoE dropping
   exactly the unsharded path's count, and a full-width MoE layer in
   float32 on 2x1 against the unsharded layer (a routing group
   straddling the rows at 1536 tokens a row); gemma2-2b trained as phase
   15 trains it (3 EigenPre steps) on 1x2 and on 2x1 under FSDP,
   each loss within 1e-5 of phase 15's, step 1's refresh on the mesh's
   first device launching kernels 1 and 2 (each launch held against its
   plain version); ``launch/serve.py --arch gemma2-2b --mesh 1x2`` and
   ``launch/train.py --reduced --mesh 2x1 --eigenpre`` on ``cuda:0``.
18. (a) the example twins (``examples/torch_*.py``) on ``cuda:0``, each
   with every launch count at 0 just before and read just after:
   quickstart and distributed_eei must launch kernels 1 and 2,
   spectral_monitor's fast updates kernel 3, and every launch is held
   against its plain version (kernels 1 and 3 bitwise, kernel 2 within
   its tolerance); serve_lm and train_lm (reduced) must exit 0.  (b) the
   dry run against the card: one period of gemma2-2b at full width on a
   1x1 mesh, a train cell of TRAIN_BATCH x TRAIN_SEQ and a decode cell of
   LM_BATCH at LM_GEMMA_PROMPT, each counted on ``"meta"`` and again
   while it runs on the card: FLOPs and bytes equal, the argument bytes
   within DRY_ARGS_TOL of ``memory_allocated()``'s growth while placing;
   printed without a gate: the measured peak beside the count's temp, and
   the step's time beside ``bound_time``, ``dominant`` and
   ``roofline_fraction`` on the H100 constants.  The phase's time is
   printed.
19. hold the minor-determinant kernel against its plain version at the
   main path's shapes (the topk8 and topk16 cells' Lanczos bands, a
   session band, the windowed chain at b = 16, n = 600), float64 and
   float32, within MINOR_DET_RTOL; time it by CUDA events and by its card
   time in a CUDA graph, beside the plain version and its bound, the
   dependent chain of n - 1 steps at the per-step latency of one lane;
   then run a Krylov top-k at the topk8 and topk16 cells' shapes: every
   ``minor_det`` stage and Lanczos residual check launches the kernel
   (later calls' checks by graph replays), the plain loop never runs on
   a CUDA tensor, and one call is split by stage.

Every launch count is set to 0 just before each of phases 3, 4, 5, 6 (each
run of the packed program), 7, 8, each stream of 11, each part of 12, each
run of 13, phase 14, each step of 15, 16 and 17 and 16's and 17's
serving, and each example of 18, and read just after, and a kernel that
its path did not launch fails the run (phase 14 and 16's and 17's serving: a kernel that it
launched; phases 15, 16 and 17: a step that is not a refresh and
launched one).  Every record carries its wrapper's launches in each part
of phases 15, 16 and 17 (``train_launches``, ``families_launches``,
``mesh_launches``) and in each example of 18 (``examples_launches``).  The records of kernels 1, 2 and 3 on the served
paths carry the launches of phase 11's streams (``server_launches``) and of
phase 12's in-process parts (``fleet_launches``; the worker processes'
launches are not counted in this process); every record carries its
wrapper's launches in each run of phase 13 (``sharded_launches``).
The line before the last holds the card's name and power limit; the one
before it the kernels' JSON record; the last line is the JSON verdict.
TF32 is off for matmul and cuDNN throughout, so float32 products run in
full float32.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

B, N, K = 16, 600, 8
SEED = 0
#: Kernel versus plain version: (rtol, atol) as in assert_allclose, from the
#: JAX package's own kernel tests (tests/test_kernels.py).
TOL = {
    ("sturm", "float64"): (1e-10, 1e-10), ("sturm", "float32"): (2e-5, 2e-5),
    ("prod_diff", "float64"): (1e-10, 1e-10),
    ("prod_diff", "float32"): (1e-4, 1e-4),
}
#: float32 solve: the largest relative 2-norm error of one magnitude row
#: against eigh's |v|^2.  At b=16, n=600 on an H100 the port's worst row
#: read 5.3e-2 and the uniform 1/n control's best row 0.77 (PERF.md); the
#: limit is about their geometric mean, a factor of ~4 from each.
F32_ROW_LIMIT = 0.2
#: Largest dense input of one eigvalsh call in the minor-stack yardstick.
LIBRARY_CHUNK_BYTES = 16e9
#: H100 SXM peaks (NVIDIA data sheet): non-tensor FP64 and FP32 rates and
#: the HBM3 rate.  Each operation is counted as one FLOP against them.
PEAK_OPS = {"float64": 34e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
#: Operations per Sturm recurrence step: a divide, two subtracts, an abs,
#: two compares, a select and an integer add.
STURM_OPS_PER_STEP = 8
#: Operations per prod-diff term: a subtract, an abs, a max, a log, an add.
PROD_DIFF_OPS_PER_TERM = 5
#: Segments packed to a row for the segmented Sturm kernel, and the rows of
#: the packed minor bands whose segments the eigvalsh yardstick takes (its
#: time is scaled to all rows).
SEG_S = 4
SEG_LIBRARY_ROWS = 64
#: Operations per segmented Sturm step beside the recurrence's: the two
#: compares of the step against the lane's segment.
SEGMENT_COMPARE_OPS = 2
#: The session stream (benchmarks/throughput.py:682-785): warm-up updates,
#: updates at ~1% of ||A||_F, then updates at ~60%; every step's eigenvalues
#: within SESSION_TOL of the spectral span of float64 eigvalsh.
SESSION_WARMUP, SESSION_STREAM, SESSION_BIG = 2, 32, 2
SESSION_TOL = 5e-3
#: The packed program (repro's engine/autotune.py:430-448 layout): PACK_B
#: rows (the server's max_batch) of width PACK_ROW_N, each packing
#: PACK_ROW_N / PACK_SEG_N seeded symmetric requests of n = PACK_SEG_N
#: (PACK_N_MAX, the largest packable); the eigh chain once at the server's
#: default width PACK_EIGH_ROW_N.  Each slot's eigenvalues within
#: PACK_TOL * max(1, |lambda|max) of float64 eigvalsh of its own request
#: (tests/test_server.py:1118-1145).
PACK_B, PACK_ROW_N, PACK_SEG_N, PACK_EIGH_ROW_N = 64, 512, 32, 64
PACK_TOL = 5e-4
#: The dense compositions: DENSE_B seeded symmetric matrices of n = DENSE_N
#: (the static dense crossover, plan.DENSE_CROSSOVER_N), windows of K.
DENSE_B, DENSE_N = 64, 64
#: The Krylov compositions on the throughput lane's matrix
#: (benchmarks/throughput.py:633-637) at its target (n, k)
#: (throughput.py:136), gated at its KRYLOV_TOL (throughput.py:139): the
#: largest eigenvalue error over the spectral span and the largest eigenpair
#: residual over max |lambda|, against float64 eigh.
KRYLOV_N, KRYLOV_K, KRYLOV_TOL = 4096, 16, 5e-3
#: Band of the shift-and-invert leg: the direct leg's default_m(4096, 16).
#: At its own default, default_si_m(4096, 16) = 128, shift-and-invert
#: misses KRYLOV_TOL on this matrix in repro and in the port alike (the
#: Gershgorin shift sits ~25x the spectral radius away, so the inverted
#: operator separates nothing): tests/test_torch_lanczos.py::
#: test_shift_invert_default_band_on_the_lane_matrix_matches_repro.
KRYLOV_SI_M = 256
#: The Householder leg beside the Krylov topk is timed at KRYLOV_N unless
#: one call there took longer than this (s); then at n = 1024.
DENSE_LEG_LIMIT_S = 60.0
#: The minor-determinant kernel's launches on the main path, ``(what, b, n,
#: k)``: the Lanczos bands of the benchmark's topk8 (b 256, m 128) and
#: topk16 (b 8, m 256) cells, a session update's 16-wide band with its 12
#: kept pairs, and the windowed chain on the smoke's stack.
MINOR_DET_SHAPES = (("topk8 band", 256, 128, 8), ("topk16 band", 8, 256, 16),
                    ("session band", 1, 16, 12), ("windowed", B, N, K))
#: Kernel against plain version on the card, relative, with the dtype's
#: smallest normal number as the absolute floor: the same steps, log, exp
#: and IEEE divide; only the normalisation's row sum is added in another
#: order (a few units in the last place).
MINOR_DET_RTOL = {"float64": 1e-12, "float32": 1e-5}
#: One lane at these band lengths: the slope of its time is the latency of
#: one step of the dependent chain, which bounds the kernel.
MINOR_DET_CHAIN_N = (1024, 4096)
#: The top-k calls whose minor-determinant launches are counted and whose
#: stages are split: the benchmark's topk8 and topk16 shapes ``(b, n, k,
#: m)`` on the Krylov chain.
MINOR_DET_TOPK = ((256, 600, 8, 128), (8, 4096, 16, 256))
#: The server phase: a mixed stream of make_eei_stream(*SERVE_MIXED,
#: mixed=True) (n in {96, 192, 288}, k in 1..8) through EeiServer at
#: max_batch SERVE_BATCH, caller-driven and with a linger of SERVE_LINGER_MS
#: (and once more under chaos at SERVE_CHAOS_RATE a point); a packed stream
#: of make_eei_stream(*SERVE_PACKED, mixed=True) (n in {16, 32, 48}) at rows
#: of SERVE_PACK_ROW_N; SERVE_SESSION_UPDATES session updates at ~1% of
#: ||A||_F.  Every wait is bounded by SERVE_WAIT_S.
SERVE_MIXED, SERVE_PACKED = (64, 192, 8), (64, 32, 8)
SERVE_BATCH, SERVE_LINGER_MS, SERVE_CHAOS_RATE = 8, 2.0, 0.05
SERVE_PACK_ROW_N, SERVE_SESSION_UPDATES, SERVE_WAIT_S = 512, 8, 600
#: What the committed H100 table (engine/calibration_default.json) picks for
#: each n of the mixed stream's buckets (k buckets to 8).
SERVE_PICKS = {96: "eigh", 192: "eei_tridiag", 288: "eei_krylov"}
#: The forced-fault chaos run: launch and NaN faults only, from a seed whose
#: schedule over the mixed stream (a function of the seed and the dispatch
#: sequence alone in caller-driven mode) sends requests down the fallback
#: chain from both; the run fails if it does not.
SERVE_FORCED_FAULTS = dict(seed=1, launch_rate=0.5, nan_rate=0.3)
#: The fleet phase: stream 1 through EeiFleet(FLEET_REPLICAS) at FLEET_SALT,
#: which spreads its keys over the replicas (n = 192 on replica 0, 96 on 1,
#: 288 on 2; over two replicas 192 and 288 on 0, 96 on 1).  The replica
#: chaos run draws from FLEET_CHAOS, whose schedule over the stream's 64
#: submits (a function of the seed and the dispatch sequence, checked on
#: the CPU) fires a kill at submit 16, a hang at 38 and a slowdown at 52:
#: each kind once, and no kill after the hang, so the hung replica is the
#: deadline probe's to find.  Its deadline_s is FLEET_DEADLINE_X times the
#: clean fleet run's p99 (at least FLEET_DEADLINE_MIN_S) and a hang lasts
#: twice that.  FLEET_SUBPROCESS requests of the stream go through two
#: worker processes, worker 0 SIGKILLed mid-stream; the session fails over
#: after the first half of the SERVE_SESSION_UPDATES updates.
FLEET_REPLICAS, FLEET_SALT, FLEET_SUBPROCESS = 3, 7, 16
FLEET_CHAOS = dict(seed=51, replica_kill_rate=0.03, replica_hang_rate=0.02,
                   replica_slow_rate=0.05)
FLEET_DEADLINE_X, FLEET_DEADLINE_MIN_S = 4.0, 2.0
#: The LM phase, at the configs' full published widths, weights and prompts
#: seeded: gemma2-2b with LM_BATCH prompts of LM_GEMMA_PROMPT tokens (past its
#: 4096-token local window), and whisper-large-v3 with LM_BATCH x 1500
#: frames and prompts of LM_WHISPER_PROMPT tokens; LM_GEN greedy tokens
#: each.  The consistency check prefills all but the prompt's last LM_TAIL
#: tokens and decodes those, teacher-forced: a prefill of 5119 (a prime)
#: would run in chunks of one token (_fit_chunk).  Gates, relative to the
#: reference's max |logit|: the float32 prefill's last logits against a
#: float64 run of the same weights, LM_F64_TOL, and the consistency check,
#: LM_CONSISTENCY_TOL (sharp random-weight attention over 26 to 64 layers
#: amplifies float32 rounding: reduced llama-vision's ten layers already
#: reach 2.7e-3 on the CPU, tests/test_torch_lm.py); bfloat16 against
#: float32, LM_BF16_TOL.  whisper's gates run at a cut depth (_lm_whisper).  The launcher serves gemma2-2b in a subprocess:
#: LM_LAUNCHER_BATCH prompts of 32 tokens, LM_LAUNCHER_GEN tokens.
LM_BATCH, LM_GEN, LM_TAIL = 2, 16, 8
LM_GEMMA_PROMPT, LM_WHISPER_PROMPT = 5120, 224
LM_F64_TOL, LM_CONSISTENCY_TOL, LM_BF16_TOL = 1e-2, 1e-2, 0.15
LM_LAUNCHER_BATCH, LM_LAUNCHER_GEN, LM_LAUNCHER_TIMEOUT_S = 4, 16, 600
#: whisper's float64 and consistency gates run at full width and this depth
#: (encoder and decoder layers): see _lm_whisper.
LM_WHISPER_GATE_DEPTH = 1
LM_LAUNCHER = ("--arch", "gemma2-2b", "--batch", str(LM_LAUNCHER_BATCH),
               "--prompt-len", "32", "--gen", str(LM_LAUNCHER_GEN))
#: Dense peak of the H100 SXM in bfloat16 (NVIDIA data sheet), for the
#: bfloat16 LM run's bound.
PEAK_BF16 = 989e12
#: Phase 15, the trainer.  gemma2-2b at full width: train_4k's sequence,
#: a global batch of TRAIN_BATCH (cut from 256) in TRAIN_MICRO
#: microbatches, EigenPre() over AdamW(), float32 compute, remat "all" (the
#: config's), TRAIN_STEPS steps, then one step in bfloat16 whose loss must
#: be within TRAIN_BF16_TOL (relative) of the float32 loss at the same
#: state and batch.  Each refreshed eigenpair set is held against float64
#: eigh of its gram at phase 3's float32 eigenvalue gate; its eigenvectors
#: lose their signs on grams far below scale 1, in repro too (ROADMAP.md
#: Queue 3), so the same engine's top-k of the gram scaled to unit norm is
#: held instead: the components |v[i, j]|^2 of each eigenvector whose
#: eigenvalue is TRAIN_GAP_MIN of ||A||_2 apart from every other within
#: TRAIN_COMPONENT_TOL of eigh's, the engine's float32 component tolerance
#: (tests/test_torch_engine.py); float32 cannot resolve closer ones.  Both packages' float32 EEI projectors are
#: 1e-5 to 1.1e-3 from float64 eigh on seeded 12 x 12 to 64 x 64 grams
#: (tests/test_torch_optim.py).
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4096, 2, 2, 3
TRAIN_BF16_TOL, TRAIN_COMPONENT_TOL, TRAIN_GAP_MIN = 0.02, 2e-3, 1e-2
#: The gates at depth 2 (one (attn_local, attn) group) and full width,
#: TRAIN_GATE_SEQ tokens a sequence: the float32 loss within
#: TRAIN_F64_LOSS_TOL (relative) and every gradient within
#: TRAIN_F64_GRAD_TOL of its leaf's max |g| of a float64 run of the same
#: weights; remat "all" against no remat within TRAIN_REMAT_TOL of max |g|
#: (float32 rounding of a recompute; printed); microbatched against full
#: batch at repro's rtol 2e-4, atol 2e-5 (tests/test_distribution.py:209).
TRAIN_GATE_SEQ = 1024
TRAIN_F64_LOSS_TOL, TRAIN_F64_GRAD_TOL, TRAIN_REMAT_TOL = 1e-5, 1e-3, 1e-6
#: Reduced codeqwen1.5-7b on repro's repeating batches (tests/test_system.py
#: _train: sequences of 16, batch 4, batch i % 4): EigenPre(AdamW(lr=3e-3,
#: weight_decay=0), rank=2, refresh_every=10), TRAIN_REDUCED_STEPS steps;
#: the loss must fall by at least TRAIN_REDUCED_DROP.
TRAIN_REDUCED_STEPS, TRAIN_REDUCED_DROP = 30, 0.5
#: The launcher: reduced gemma2-2b with EigenPre, TRAIN_LAUNCHER_STEPS
#: steps with a checkpoint every TRAIN_LAUNCHER_EVERY, resumed to
#: TRAIN_LAUNCHER_RESUME_TO; then a long run sent SIGTERM after
#: TRAIN_SIGTERM_AFTER logged steps.
TRAIN_LAUNCHER_STEPS, TRAIN_LAUNCHER_EVERY = 20, 5
TRAIN_LAUNCHER_RESUME_TO, TRAIN_SIGTERM_AFTER = 25, 5
TRAIN_LAUNCHER_TIMEOUT_S = 300


#: Phase 16, the other block families at their published widths.
#: zamba2-2.7b and xlstm-125m whole: B = LM_BATCH prompts of FAM_PROMPT
#: tokens, LM_GEN greedy tokens, float32 then bfloat16; the float64,
#: consistency and bfloat16 (LM_BF16_TOL) gates at full depth or at one
#: period of the pattern (FAM_GATE_WHOLE).  kimi-k2-1t-a32b and deepseek-v3-671b cannot fit the card
#: whole: one period of each pattern entry (every kind in its published
#: ratio, all experts; 19.97 B and 13.94 B parameters) in bfloat16, prompts
#: of FAM_MOE_PROMPT tokens (4 routing groups of 1024, capacity drops as in
#: a deployment), every logit and the loss finite; their gates at reduced
#: width, prompts of FAM_REDUCED_PROMPT.  Training: zamba2 and xlstm whole
#: as phase 15 trains gemma2-2b (TRAIN_SEQ x TRAIN_BATCH tokens in
#: TRAIN_MICRO microbatches, remat, float32, TRAIN_STEPS EigenPre steps);
#: kimi and deepseek at reduced width, FAM_REDUCED_STEPS AdamW steps on
#: repro's repeating batches (tests/test_system.py), the loss falling by
#: FAM_REDUCED_DROP.
FAM_WHOLE = ("zamba2-2.7b", "xlstm-125m")
#: The configs gated at full depth (_fam_serve_whole); the others at one
#: period of the pattern.
FAM_GATE_WHOLE = ("xlstm-125m",)
FAM_MOE = ("kimi-k2-1t-a32b", "deepseek-v3-671b")
FAM_PROMPT, FAM_MOE_PROMPT, FAM_REDUCED_PROMPT = 4096, 2048, 256
FAM_REDUCED_STEPS, FAM_REDUCED_DROP = 25, 0.3
#: The sLSTM scan against autograd through its eager loop (_fam_slstm_scan):
#: steps, and the gradients' bound relative to each one's max |g|.
FAM_SCAN_STEPS, FAM_SCAN_TOL = 512, 1e-5
#: EigenPre's eligible stacked keys (2-D, at most 1024 rows): zamba2's
#: five Mamba2 blocks' eight vectors each, (9, .); xlstm's nine, (6, .).
FAM_ELIGIBLE = {"zamba2-2.7b": (40, 9), "xlstm-125m": (9, 6)}


#: Phase 17, the sharded language model on logical meshes of the one card
#: (the card repeated: parity, memory per shard and cost, no speed claim).
#: gemma2-2b served at LM_GEMMA_PROMPT, float32, on MESH_SERVE, every step's
#: logits within MESH_TOL of max |logit| of the unsharded path (float32 is
#: 2e-6 from float64 there, phase 14); 1x1 times the mesh program against
#: the unsharded one.  One period of deepseek-v3-671b served on 1x2 in
#: bfloat16 within MESH_BF16_TOL of the unsharded bfloat16 path (its MoE's
#: dropped pairs printed), and in float32 within MESH_TOL with its MoE
#: dropping exactly the unsharded path's count; a full-width MoE layer in
#: float32 on 2x1 at MESH_MOE_SEQS tokens a row (1536: a routing group
#: straddles the rows) against the unsharded layer.  gemma2-2b trained as
#: phase 15 trains it on MESH_TRAIN ((mesh, fsdp, microbatches)), each loss
#: within MESH_LOSS_TOL of phase 15's unsharded losses.  The train launcher
#: runs MESH_LAUNCHER_STEPS.
MESH_SERVE = ("1x1", "1x2", "2x1", "1x3")
MESH_MOE_SEQS = (1536, 2048)
MESH_TRAIN = (("1x2", False, TRAIN_MICRO), ("2x1", True, None))
MESH_TOL, MESH_BF16_TOL, MESH_LOSS_TOL = 1e-4, 0.05, 1e-5
MESH_LAUNCHER_STEPS = 2


#: Phase 18 (a), the example twins on the card: (example, its arguments
#: after ``--device cuda``, the kernels its path must launch).
EXAMPLES = (
    ("torch_quickstart", (), ("sturm_bisect", "logabs_sum")),
    ("torch_distributed_eei", (), ("sturm_bisect", "logabs_sum")),
    ("torch_spectral_monitor", (), ("sturm_segmented",)),
    ("torch_serve_lm", ("--batch", "2", "--gen", "4"), ()),
    ("torch_train_lm", ("--small", "--steps", "3", "--batch", "2", "--seq",
                        "64"), ()),
)
#: Phase 18 (b): the dry run's argument bytes against the card's
#: ``memory_allocated()`` growth while placing them (the allocator rounds
#: each block up to 512 bytes).
DRY_ARGS_TOL = 0.01


class PhaseError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cudnn")
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"({build.library_dir()})")
    _kernel_report(build)
    from repro_torch.kernels.sturm.kernel import _geometry
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for what, rows, n, m in (("spectrum", B, N, N), ("window", B, N, K),
                             ("minor stack", B * N, N - 1, N - 1)):
        cap, threads = _geometry(rows, n, m, 8, sms)
        print(f"[build] sturm_bisect {what} {rows}x{m}: {cap} lanes and "
              f"{threads} threads a block, {-(-m // cap)} block(s) a row")
    from repro_torch.kernels.sturm.kernel import _segmented_geometry
    for what, rows, n, m, seg in (
            ("synthetic packed", B * N // SEG_S, SEG_S * (N - 1), SEG_S * K, K),
            ("session", 1, 16, 12, 0),
            ("packed program", PACK_B, PACK_ROW_N,
             PACK_ROW_N // PACK_SEG_N * K, K)):
        cap, threads, window = _segmented_geometry(rows, n, m, seg, 8, sms)
        print(f"[build] sturm_segmented {what} {rows}x{n}, {m} lanes a row "
              f"(float64): {cap} lanes and {threads} threads a block, a "
              f"window of {window} columns")

    stack = _stack(torch, dev)
    kernels = _phase_kernels(torch, dev, stack)
    segmented = _phase_segmented(torch, dev, stack, kernels)
    variants = _phase_prod_diff_variants(torch, dev, kernels)
    counts, engine_results = _phase_engine(torch, dev, stack)
    op_counts = _phase_ops(torch, dev, kernels)
    sessions = _phase_session(torch, dev, stack)
    packed = _phase_packed(torch, dev)
    records = _phase_timing(torch, dev, stack, kernels, counts)
    # The phase-2 records of kernels 1 and 2 and the packed program's of
    # kernel 3 also carry the server streams' launches (phase 11) and the
    # fleet's in-process ones (phase 12).
    on_server_path = list(records)
    records += _phase_timing_other_kernels(torch, dev, kernels, segmented, variants,
                                 op_counts, sessions)
    for name, pk in packed.items():
        records.append(_packed_record(torch, dev, name, pk))
        _print_record(records[-1])
        on_server_path.append(records[-1])
    t_new = time.perf_counter()
    dense = _phase_dense(torch, dev)
    krylov = _phase_krylov(torch, dev)
    _phase_calibration(torch)
    records += _dense_records(torch, dense)
    records += _krylov_records(torch, krylov)
    print(f"[timing] the dense, Krylov and calibration phases took "
          f"{time.perf_counter() - t_new:.1f} s")
    served = _phase_server(torch, dev, stack, kernels)
    fleet_launches = _phase_fleet(torch, dev, stack, served)
    for r in on_server_path:
        kind = r["name"].split("[")[0]
        r["server_launches"] = served["launches"][kind]
        r["fleet_launches"] = fleet_launches[kind]
    served["record"]["fleet_launches"] = fleet_launches["sturm_segmented"]
    records.append(served["record"])
    sharded = _phase_sharded(torch, dev, stack, engine_results,
                             served["known"])
    for r in records:
        kind = r["name"].split("[")[0]
        r["sharded_launches"] = {tag: counts[kind]
                                 for tag, counts in sharded.items()}
    _phase_lm(torch, dev)
    train, train_record = _phase_train(torch, dev)
    families = _phase_families(torch, dev)
    mesh = _phase_mesh_lm(torch, dev, train_record)
    examples = _phase_examples_dryrun(torch, dev)
    for r in records:
        kind = r["name"].split("[")[0]
        r["train_launches"] = {part: counts[kind]
                               for part, counts in train.items()}
        r["families_launches"] = {part: counts[kind]
                                  for part, counts in families.items()}
        r["mesh_launches"] = {part: counts[kind]
                              for part, counts in mesh.items()}
        r["examples_launches"] = {name: counts[kind]
                                  for name, counts in examples.items()}
    records += _phase_minor_det(torch, dev)
    print(f"[timing] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": records}))
    print("nvidia-smi: " + _gpu_name_and_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _gpu_name_and_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def _stack(torch, dev):
    """Seeded (B, N, N) symmetric float64 stack on the card."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    a = rng.standard_normal((B, N, N))
    return torch.as_tensor((a + np.swapaxes(a, 1, 2)) / 2, device=dev)


def _events_ms(torch, fn, warmup: int, reps: int) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: SASS opcode classes for the per-step counts (the opcode up to its first
#: dot); anything else (branches, barriers, conversions) counts as "other".
SASS_CLASSES = {
    "fp64": {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET"},
    "fp32": {"FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FCHK",
             "FSET"},
    "mufu": {"MUFU"},
    "integer": {"IADD3", "IADD", "VIADD", "IMAD", "IMUL", "ISETP", "LOP3",
                "PLOP3", "SEL", "SHF", "LEA", "IMNMX", "VIMNMX", "IABS",
                "PRMT", "MOV", "FLO", "POPC", "BMSK", "SGXT", "P2R", "R2P"},
    "memory": {"LDS", "STS", "LDG", "STG", "LDL", "STL", "LDC", "ULDC",
               "ATOMS", "LD", "ST"},
}
#: Kernel 1's and kernel 2's inner loops in the SASS: (label, mangled-name
#: keys tried in order, the opcode that marks one recurrence step or one
#: term, an opcode the loop must not hold).  A step has one IEEE divide (one
#: reciprocal seed), a term one multiply into the running product; the
#: prod-diff loop without a log (no MUFU) is the one-log-per-cell path.
SASS_LOOPS = (
    ("sturm_bisect float64, per step", ("sturm_bisect_kernelIdE",),
     "MUFU.RCP64H", None),
    ("sturm_bisect float32, per step", ("sturm_bisect_kernelIfE",),
     "MUFU.RCP", None),
    ("logabs_sum float64, per term", ("logabs_sum_kernelIdE",), "DMUL",
     "MUFU"),
    ("logabs_sum float32, per term", ("logabs_sum_kernelIfE",), "FMUL",
     "MUFU"),
)


def _cuda_tool(name):
    """Path of a CUDA toolkit program, or None."""
    import os
    import shutil

    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for path in ([Path(home) / "bin" / name] if home else []) + [
            Path(shutil.which(name) or "/nonexistent"),
            Path("/usr/local/cuda/bin") / name]:
        if path.is_file():
            return str(path)
    return None


def _kernel_short(mangled):
    """``sturm_bisect_kernel<double, 1>`` from a mangled kernel name."""
    import re

    m = re.search(r"([a-z_]+_kernel)I([fd])(?:Li(\d+)E)?", mangled)
    if not m:
        return mangled
    args = ["double" if m.group(2) == "d" else "float"] + (
        [m.group(3)] if m.group(3) else [])
    return f"{m.group(1)}<{', '.join(args)}>"


def _ptxas_summary(report):
    """Per kernel of ``nvcc -Xptxas -v``'s report: registers, static shared
    memory, stack frame and spill bytes."""
    import re

    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_short(m.group(1))
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers(?:, (\d+) bytes smem)?", line)
        if m:
            out[name].update(registers=int(m.group(1)),
                             smem=int(m.group(2) or 0))
    return out


def _sass_loop(sass, keys, marker, without=None):
    """Instructions per ``marker`` by class in the innermost loop (a
    backward branch) around the most ``marker`` opcodes, and no opcode
    starting with ``without``, of the first kernel whose mangled name holds
    one of ``keys``; None if there is none."""
    import re

    functions, body, pending = {}, None, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            body = functions.setdefault(m.group(1), [])
            continue
        if body is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m:
            t = re.search(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b", m.group(3))
            target = None
            if t:
                target = t.group(1) or int(t.group(2), 16)
            body.append((int(m.group(1), 16), m.group(2), target, pending))
            pending = []
    body = next((functions[f] for key in keys for f in functions if key in f),
                None)
    if body is None:
        return None
    index = {addr: i for i, (addr, *_rest) in enumerate(body)}
    index.update({lab: i for i, x in enumerate(body) for lab in x[3]})
    loops = []
    for i, (_, op, target, _) in enumerate(body):
        lo = index.get(target) if op.startswith("BRA") else None
        if lo is not None and lo < i:
            n_mark = sum(1 for x in body[lo:i + 1] if x[1] == marker)
            if n_mark and not (without and any(
                    x[1].startswith(without) for x in body[lo:i + 1])):
                loops.append((lo, i, n_mark))
    inner = [a for a in loops if not any(
        b != a and a[0] <= b[0] and b[1] <= a[1] for b in loops)]
    if not inner:
        return None
    lo, hi, n_mark = max(inner, key=lambda a: (a[2], a[0] - a[1]))
    # The fast path: a predicated forward branch inside the loop skips a
    # slow path (the IEEE divide's call for out-of-range operands), which is
    # not counted.
    skipped = set()
    for i in range(lo, hi + 1):
        _, op, target, _ = body[i]
        j = index.get(target) if op.startswith("BRA") else None
        if j is not None and i < j <= hi:
            skipped.update(range(i + 1, j))
    counts = {c: 0 for c in (*SASS_CLASSES, "other")}
    for i in range(lo, hi + 1):
        if i in skipped:
            continue
        op = body[i][1].split(".")[0]
        cls = next((c for c, ops in SASS_CLASSES.items() if op in ops),
                   "other")
        counts[cls] += 1
    counts["total"] = sum(counts.values())
    return {c: v / n_mark for c, v in counts.items()} | {
        "static": (hi + 1 - lo) / n_mark, "unrolled": n_mark}


def _kernel_report(build, tag="build"):
    """Print the ptxas figures of every kernel and the SASS counts of
    kernels 1 and 2's inner loops; returns both."""
    report = build.library_dir() / "ptxas.txt"
    ptxas = _ptxas_summary(report.read_text()) if report.is_file() else {}
    for name, v in ptxas.items():
        print(f"[{tag}] ptxas {name}: {v.get('registers')} registers, "
              f"{v.get('smem')} B static shared memory, {v.get('stack')} B "
              f"stack, spills {v.get('spill_stores')} B stored / "
              f"{v.get('spill_loads')} B loaded")
    tool = _cuda_tool("cuobjdump")
    sass = {}
    if tool is None:
        print(f"[{tag}] SASS counts: not measured (no cuobjdump)")
        return ptxas, sass
    text = subprocess.run(
        [tool, "-sass", str(build.library_dir() / build.LIB_NAME)],
        capture_output=True, text=True, timeout=300).stdout
    (build.library_dir() / "sass.txt").write_text(text)
    for label, keys, marker, without in SASS_LOOPS:
        sass[label] = _sass_loop(text, keys, marker, without)
        if sass[label] is None:
            print(f"[{tag}] SASS {label}: not measured (loop not found)")
            continue
        print(f"[{tag}] SASS {label} (inner loop, {sass[label]['unrolled']} "
              f"per pass; fast path, and all instructions as 'static'): "
              + ", ".join(f"{c} {v:.2f}" for c, v in sass[label].items()
                          if c != "unrolled"))
    return ptxas, sass


def _device_ms(torch, fn):
    """Time the card spent in kernels and copies during one call of ``fn``,
    and their number: the durations of torch.profiler's device-side events
    (0.0 and 0 if it recorded none).  (Summing the ops' self device times
    instead would count a PyTorch kernel twice, under its op and under its
    own name.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in device) / 1e3, len(device)


def _max_err(torch, got, ref, rtol: float, atol: float, what: str) -> float:
    """Check ``|got - ref| <= atol + rtol |ref|`` (in float64) and finite
    values of the same shape; returns the largest absolute error."""
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"{what}: shape {tuple(got.shape)} != "
          f"{tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = (got.double() - ref.double()).abs()
    bad = err > atol + rtol * ref.double().abs()
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} entries outside "
          f"rtol={rtol} atol={atol}, max abs err {float(err.max())}")
    return float(err.max())


def _phase_kernels(torch, dev, stack):
    """Each kernel against its plain version, and the bitwise contracts."""
    from repro_torch.core import minors
    from repro_torch.kernels.prod_diff import kernel as pd_kernel
    from repro_torch.kernels.prod_diff import ops as pd_ops
    from repro_torch.kernels.sturm import kernel as st_kernel
    from repro_torch.kernels.sturm import ops as st_ops
    from repro_torch.linalg import householder
    from repro_torch.linalg.sturm import _pivmin, default_iters, gershgorin_bounds

    out = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        a = stack.to(dtype)
        d, e, _ = householder.tridiagonalize(a, with_q=False)
        iters = default_iters(dtype)

        def bounds_of(dd, ee):
            lo, hi = gershgorin_bounds(dd, ee)
            return torch.stack([lo, hi, _pivmin(dd, ee)], dim=-1)

        # Sturm, full spectrum (B, N), and the k = K window, each bitwise its
        # plain version.
        bnd = bounds_of(d, e)
        args = dict(target_base=0, m=N, n_iter=iters)
        lam = st_kernel.sturm_bisect(d, e, bnd, **args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lam_plain = st_kernel.sturm_bisect_plain(d, e, bnd, **args)
        torch.cuda.synchronize()
        spec_plain_ms = (time.perf_counter() - t) * 1e3
        check(torch.equal(lam, lam_plain),
              f"sturm spectrum {name}: kernel != plain version")
        wargs = dict(target_base=N - K, m=K, n_iter=iters)
        win = st_kernel.sturm_bisect(d, e, bnd, **wargs)
        win_plain, win_plain_ms = _plain_ms(
            torch, lambda: st_kernel.sturm_bisect_plain(d, e, bnd, **wargs))
        check(torch.equal(win, win_plain),
              f"sturm window {name}: kernel != plain version")
        check(torch.equal(st_ops.sturm_eigenvalues(d, e, window=(K, True)),
                          st_ops.sturm_eigenvalues(d, e)[:, -K:]),
              f"sturm window != slice of the full spectrum ({name})")
        print(f"[kernels] sturm spectrum {name} ({B}, {N}) and window ({B}, "
              f"{K}): bitwise-equal to the plain version; the window "
              f"bitwise-equal to the slice")

        # Sturm, all stacked minor bands (B*N, N-1), every row bitwise.
        dm, em = minors.all_tridiagonal_minor_bands(d, e)
        dm = dm.reshape(B * N, N - 1).contiguous()
        em = em.reshape(B * N, N - 2).contiguous()
        mbnd = bounds_of(dm, em)
        margs = dict(target_base=0, m=N - 1, n_iter=iters)
        mu = st_kernel.sturm_bisect(dm, em, mbnd, **margs)
        torch.cuda.synchronize()
        t = time.perf_counter()
        mu_plain = st_kernel.sturm_bisect_plain(dm, em, mbnd, **margs)
        torch.cuda.synchronize()
        minor_plain_ms = (time.perf_counter() - t) * 1e3
        check(torch.equal(mu, mu_plain),
              f"sturm minor spectra {name}: kernel != plain version on "
              f"{int((mu != mu_plain).any(dim=1).sum())} rows")
        print(f"[kernels] sturm minor spectra {name} ({B * N}, {N - 1}): all "
              f"rows bitwise-equal to the plain version")
        spec_err, win_err, minor_err = (
            float((got - ref).abs().max())
            for got, ref in ((lam, lam_plain), (win, win_plain),
                             (mu, mu_plain)))

        # Prod-diff numerator table (B, N, N, N-1).
        mu = mu.reshape(B, N, N - 1)
        floor = pd_ops._floor_from_spectra(lam).contiguous()
        num = pd_kernel.logabs_sum(lam, mu, floor)
        torch.cuda.synchronize()
        t = time.perf_counter()
        num_plain = pd_kernel.logabs_sum_plain(lam, mu, floor)
        torch.cuda.synchronize()
        pd_plain_ms = (time.perf_counter() - t) * 1e3
        pd_err = _max_err(torch, num, num_plain, *TOL[("prod_diff", name)],
                          f"prod_diff {name}")
        idx = torch.arange(N - K, N, device=dev)
        check(torch.equal(pd_ops.eei_magnitudes_windowed(lam, mu, idx),
                          pd_ops.eei_magnitudes_batched(lam, mu)[:, idx]),
              f"windowed prod-diff rows != full-table rows ({name})")
        print(f"[kernels] prod_diff {name} ({B}, {N}, {N}, {N - 1}): max abs "
              f"err {pd_err:.3e}; windowed rows bitwise-equal to the table")
        ext_err = _prod_diff_extremes(torch, dev, dtype, name)

        out[name] = dict(
            d=d, e=e, bnd=bnd, dm=dm, em=em, mbnd=mbnd, lam=lam, mu=mu,
            floor=floor, iters=iters,
            err={"spectrum": spec_err, "minor": minor_err, "window": win_err,
                 "prod_diff": pd_err, "prod_diff_extremes": ext_err},
            plain_ms={"spectrum": spec_plain_ms, "minor": minor_plain_ms,
                      "window": win_plain_ms, "prod_diff": pd_plain_ms})
    return out


def _prod_diff_extremes(torch, dev, dtype, name):
    """The prod-diff kernel against its plain version on terms that run
    from the floor up to ~1e300 (1e30 in float32): magnitudes from 1e-30
    up, both signs, exact and near coincidences with ``lam``; also with a
    floor far below every term."""
    import numpy as np

    from repro_torch.core.identity import spectral_floor
    from repro_torch.kernels.prod_diff import kernel as pd_kernel

    rng = np.random.default_rng(SEED + 5)
    top = 300 if name == "float64" else 30
    b, i_n, j_n = 4, 40, 70

    def draw(shape):
        return np.sign(rng.standard_normal(shape)) * 10.0 ** rng.uniform(
            -30, top, shape)

    lam = np.sort(draw((b, i_n)), -1)
    mu = draw((b, j_n, N - 1))
    mu[:, :, :3] = lam[:, None, :3]
    mu[:, :, 3:6] = lam[:, None, :3] * (1 + 1e-12)
    lam = torch.as_tensor(lam, dtype=dtype, device=dev)
    mu = torch.as_tensor(mu, dtype=dtype, device=dev)
    worst = 0.0
    for floor in (spectral_floor(lam).contiguous(),
                  torch.full((b,), torch.finfo(dtype).tiny * 4, dtype=dtype,
                             device=dev)):
        got = pd_kernel.logabs_sum(lam, mu, floor)
        worst = max(worst, _max_err(
            torch, got, pd_kernel.logabs_sum_plain(lam, mu, floor),
            *TOL[("prod_diff", name)], f"prod_diff {name} extreme scales"))
    print(f"[kernels] prod_diff {name} ({b}, {i_n}, {j_n}, {N - 1}), terms "
          f"from the floor to ~1e{top}: max abs err {worst:.3e}")
    return worst


def _check_solve(torch, a, res, name):
    lam_ref, v_ref = torch.linalg.eigh(a.double())
    lam, mags = res
    check(lam.dtype == a.dtype and mags.dtype == a.dtype, f"solve {name}: dtype")
    check(bool(torch.isfinite(mags).all()), f"solve {name}: non-finite")
    mags_ref = (v_ref * v_ref).transpose(-1, -2)
    norm2 = lam_ref.abs().amax(dim=-1, keepdim=True)
    if name == "float64":
        _max_err(torch, lam, lam_ref, 1e-6, 1e-8, f"solve {name} eigenvalues")
        _max_err(torch, mags, mags_ref, 1e-4, 1e-7, f"solve {name} magnitudes")
    else:
        err = (lam.double() - lam_ref).abs() / norm2
        check(float(err.max()) <= 2e-4, f"solve {name}: eigenvalue error "
              f"{float(err.max()):.3e} of ||A||_2 > 2e-4")
        # Each row of the table (one eigenvector's |v|^2) against eigh's, by
        # its relative 2-norm error.  A table of uniform 1/n rows is the
        # control: the limit must sit well below its best row, so that the
        # check fails a table that knows nothing of the eigenvectors.
        worst = float(_row_err(mags, mags_ref).max())
        control = _row_err(torch.full_like(mags_ref, 1.0 / a.shape[-1]),
                           mags_ref)
        print(f"[engine] solve {name}: magnitude rows vs eigh, relative "
              f"2-norm error: worst {worst:.3e}; uniform 1/n control: best "
              f"row {float(control.min()):.3e}, worst {float(control.max()):.3e}"
              f"; limit {F32_ROW_LIMIT:g}")
        check(float(control.min()) > F32_ROW_LIMIT,
              f"solve {name}: the uniform control passes the row limit")
        check(worst <= F32_ROW_LIMIT, f"solve {name}: a magnitude row is off "
              f"by {worst:.3e} (relative 2-norm) > {F32_ROW_LIMIT:g}")
    print(f"[engine] solve {name}: within tolerance of torch.linalg.eigh; max "
          f"eigenvalue error {float((lam.double() - lam_ref).abs().max()):.3e},"
          f" max magnitude error {float((mags.double() - mags_ref).abs().max()):.3e}")


def _row_err(mags, ref):
    """Per-row relative 2-norm error of a magnitude table, in float64."""
    ref = ref.double()
    return (mags.double() - ref).norm(dim=-1) / ref.norm(dim=-1)


def _check_topk(torch, a, res, name, what):
    lam_ref, v_ref = torch.linalg.eigh(a.double())
    lam, vecs = res
    k = lam.shape[-1]
    check(tuple(vecs.shape) == (a.shape[0], k, a.shape[-1]),
          f"{what} {name}: shape")
    check(bool(torch.isfinite(vecs).all()), f"{what} {name}: non-finite")
    norm2 = lam_ref.abs().amax(dim=-1, keepdim=True)
    res_norm = (torch.einsum("bij,bkj->bki", a.double(), vecs.double())
                - lam.double()[..., None] * vecs.double()).norm(dim=-1)
    fro = a.double().norm(dim=(-2, -1))[:, None]
    if name == "float64":
        _max_err(torch, lam, lam_ref[:, -k:], 1e-6, 1e-8,
                      f"{what} {name} eigenvalues")
        ref = v_ref[..., -k:].transpose(-1, -2)
        err = torch.minimum((vecs - ref).abs().amax(-1),
                            (vecs + ref).abs().amax(-1))
        check(float(err.max()) < 1e-5, f"{what} {name}: vectors off by "
              f"{float(err.max()):.3e}")
    else:
        err = (lam.double() - lam_ref[:, -k:]).abs() / norm2
        check(float(err.max()) <= 2e-4, f"{what} {name}: eigenvalue error "
              f"{float(err.max()):.3e} of ||A||_2 > 2e-4")
        nrm = (vecs.double().norm(dim=-1) - 1).abs().max()
        check(float(nrm) <= 1e-4, f"{what} {name}: norms off by {float(nrm)}")
    # The residual bound of the JAX package's verify stage (engine/verify.py).
    worst = float((res_norm / fro).max())
    check(worst <= 2e-3, f"{what} {name}: residual {worst:.3e} of ||A||_F "
          f"> 2e-3")
    lam_err = float((lam.double() - lam_ref[:, -k:]).abs().max())
    print(f"[engine] {what} {name}: within tolerance of torch.linalg.eigh; "
          f"max eigenvalue error {lam_err:.3e}, worst residual {worst:.3e} "
          f"of ||A||_F")


def _check_eigenvalues(torch, a, lam, name, what, k=None):
    lam_ref = torch.linalg.eigvalsh(a.double())
    if k:
        lam_ref = lam_ref[:, -k:]
    if name == "float64":
        _max_err(torch, lam, lam_ref, 1e-6, 1e-8, f"{what} {name}")
    else:
        norm2 = lam_ref.abs().amax(dim=-1, keepdim=True)
        err = (lam.double() - lam_ref).abs() / norm2
        check(float(err.max()) <= 2e-4, f"{what} {name}: error "
              f"{float(err.max()):.3e} of ||A||_2 > 2e-4")
    print(f"[engine] {what} {name}: within tolerance of torch.linalg.eigh; "
          f"max error {float((lam.double() - lam_ref).abs().max()):.3e}")


def _wrappers():
    """Every kernel wrapper, by the name of its launch count."""
    from repro_torch.kernels.prod_diff import kernel as pd
    from repro_torch.kernels.sturm import kernel as st

    return {"sturm_bisect": st.sturm_bisect,
            "sturm_segmented": st.sturm_segmented,
            "logabs_sum": pd.logabs_sum,
            "logabs_sum_masked": pd.logabs_sum_masked,
            "logabs_sum_single": pd.logabs_sum_single}


def _reset_counts():
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def _read_counts():
    return {name: w.launches for name, w in _wrappers().items()}


def _phase_engine(torch, dev, stack):
    """The main path through the entry points a user calls."""
    from repro_torch import SolverEngine, SolverPlan, plan_for

    # The plans are named, so that this phase launches what it launched
    # before the planner read the card's calibration table; what plan_for
    # picks under that table is printed beside them.
    shape = tuple(stack.shape)
    windowed = SolverPlan(method="eei_tridiag", spectrum="windowed")
    full = SolverPlan(method="eei_tridiag")
    topk_full = full
    print(f"[engine] plan_for{shape} picks {plan_for(shape)}; with k={K} "
          f"{plan_for(shape, k=K)}")

    inputs = {name: stack.to(dt) for name, dt in
              (("float64", torch.float64), ("float32", torch.float32))}
    results, counts = {}, {}
    for name, a in inputs.items():
        _reset_counts()
        results[name] = {
            "solve": SolverEngine(full).solve(a),
            "topk windowed": SolverEngine(windowed).topk(a, K),
            "topk full": SolverEngine(topk_full).topk(a, K),
            "eigenvalues": SolverEngine(full).eigenvalues(a),
            "eigenvalues k": SolverEngine(full).eigenvalues(a, k=K),
        }
        torch.cuda.synchronize()
        counts[name] = _read_counts()
        print(f"[engine] launches on the main path, {name} (solve, topk "
              f"windowed, topk full, eigenvalues, eigenvalues k): "
              f"{counts[name]}")
        check(counts[name]["sturm_bisect"] > 0
              and counts[name]["logabs_sum"] > 0,
              f"a kernel of the main path was never launched: {counts[name]}")

    for name, a in inputs.items():
        r = results[name]
        _check_solve(torch, a, r["solve"], name)
        _check_topk(torch, a, r["topk windowed"], name, "topk windowed")
        _check_topk(torch, a, r["topk full"], name, "topk full")
        _check_eigenvalues(torch, a, r["eigenvalues"], name, "eigenvalues")
        _check_eigenvalues(torch, a, r["eigenvalues k"], name,
                           "eigenvalues k", k=K)
    return counts, results


def _sturm_cost(rows, n, m, iters, elsize, dtype_name):
    ops = rows * m * iters * n * STURM_OPS_PER_STEP
    nbytes = (rows * n + rows * (n - 1) + rows * 3 + rows * m) * elsize
    return _bound(ops, nbytes, dtype_name)


def _bound(ops, nbytes, dtype_name):
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def _phase_timing(torch, dev, stack, kernels, counts):
    from repro_torch import SolverEngine, SolverPlan
    from repro_torch.engine.engine import ProgramSpec, program
    from repro_torch.kernels.prod_diff.kernel import logabs_sum
    from repro_torch.kernels.sturm.kernel import sturm_bisect
    from repro_torch.linalg.householder import tridiagonal_matrix

    plan = SolverPlan(method="eei_tridiag")
    per_solve = {}
    for name, kd in kernels.items():
        engine = SolverEngine(plan)
        a = stack.to(kd["d"].dtype)
        engine.solve(a)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        engine.solve(a)
        torch.cuda.synchronize()
        per_solve[name] = _read_counts()
        print(f"[timing] launches per solve {name}: {per_solve[name]}")

    records = []
    for name, kd in kernels.items():
        elsize = kd["d"].element_size()
        iters = kd["iters"]
        path, solve = counts[name], per_solve[name]
        st_launches = dict(launches=path["sturm_bisect"],
                           launches_per_solve=solve["sturm_bisect"])

        # Sturm, full spectrum; yardstick: eigvalsh of the dense tridiagonal.
        ms = _events_ms(torch, lambda: sturm_bisect(
            kd["d"], kd["e"], kd["bnd"], target_base=0, m=N, n_iter=iters),
            warmup=2, reps=20)
        dense = tridiagonal_matrix(kd["d"], kd["e"])
        lib_ms = _events_ms(torch, lambda: torch.linalg.eigvalsh(dense),
                            warmup=2, reps=10)
        del dense
        bound, by = _sturm_cost(B, N, N, iters, elsize, name)
        records.append(_record(
            f"sturm_bisect[spectrum {B}x{N} {name}]", "sturm",
            err=kd["err"]["spectrum"], ms=ms,
            plain_ms=kd["plain_ms"]["spectrum"], bound_ms=bound, bound_by=by,
            library_ms=lib_ms, **st_launches))

        # Sturm, the k = K window (windowed topk, eigenvalues(k)); the same
        # yardstick, which computes the whole spectrum.
        ms = _events_ms(torch, lambda: sturm_bisect(
            kd["d"], kd["e"], kd["bnd"], target_base=N - K, m=K,
            n_iter=iters), warmup=2, reps=20)
        bound, by = _sturm_cost(B, N, K, iters, elsize, name)
        records.append(_record(
            f"sturm_bisect[window {B}x{K} {name}]", "sturm",
            err=kd["err"]["window"], ms=ms, plain_ms=kd["plain_ms"]["window"],
            bound_ms=bound, bound_by=by, library_ms=lib_ms, **st_launches))

        # Sturm, all stacked minor bands; yardstick: eigvalsh of the dense
        # minor tridiagonals, in row chunks of at most LIBRARY_CHUNK_BYTES.
        ms = _events_ms(torch, lambda: sturm_bisect(
            kd["dm"], kd["em"], kd["mbnd"], target_base=0, m=N - 1,
            n_iter=iters), warmup=1, reps=3)
        lib_ms, calls, lib_err = _minor_library_ms(torch, kd)
        print(f"[timing] eigvalsh of the {B * N} dense minor tridiagonals "
              f"{name}: {lib_ms:.1f} ms in {calls} call(s); max abs "
              f"difference from the kernel's minor spectra {lib_err:.3e}")
        bound, by = _sturm_cost(B * N, N - 1, N - 1, iters, elsize, name)
        records.append(_record(
            f"sturm_bisect[minor_spectra {B * N}x{N - 1} {name}]", "sturm",
            err=kd["err"]["minor"], ms=ms, plain_ms=kd["plain_ms"]["minor"],
            bound_ms=bound, bound_by=by, library_ms=lib_ms, **st_launches))

        # Prod-diff numerator table; no single library call.
        ms = _events_ms(torch, lambda: logabs_sum(
            kd["lam"], kd["mu"], kd["floor"]), warmup=2, reps=10)
        terms = B * N * N * (N - 1)
        nbytes = (B * N + B * N * (N - 1) + B + B * N * N) * elsize
        bound, by = _bound(terms * PROD_DIFF_OPS_PER_TERM, nbytes, name)
        records.append(_record(
            f"logabs_sum[{B}x{N}x{N}x{N - 1} {name}]", "prod_diff",
            launches=path["logabs_sum"],
            launches_per_solve=solve["logabs_sum"],
            err=kd["err"]["prod_diff"], ms=ms,
            plain_ms=kd["plain_ms"]["prod_diff"], bound_ms=bound,
            bound_by=by, library_ms=None))

    print(f"[timing] bounds: {STURM_OPS_PER_STEP} operations per Sturm "
          f"recurrence step, {PROD_DIFF_OPS_PER_TERM} per prod-diff term, "
          f"against {PEAK_OPS['float64'] / 1e12:.0f} TFLOP/s (float64) and "
          f"{PEAK_OPS['float32'] / 1e12:.0f} TFLOP/s (float32); bytes against "
          f"{PEAK_BYTES / 1e12:.2f} TB/s")
    for r in records:
        _print_record(r)

    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        a = stack.to(dtype)
        engine = SolverEngine(plan)

        # Each stage's wall time, then the card's kernel time for a second
        # run of the same stage on the same state (torch.profiler): their
        # ratio is the share of the stage the device is busy.
        prog = program(plan, ProgramSpec("solve"))
        state = prog.initial_state(a)
        split, busy = {}, {}
        for sig, fn in prog.stages:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(state)
            torch.cuda.synchronize()
            split[sig.role] = (time.perf_counter() - t) * 1e3
            busy[sig.role] = _device_ms(torch, lambda: fn(state))[0]
            state.update(out)
        print(f"[timing] solve stages {name} (ms): " + ", ".join(
            f"{role} {v:.2f}" for role, v in split.items()))
        if sum(busy.values()) > 0:
            print(f"[timing] solve stages {name}, device busy (kernel ms, share"
                  f" of wall): " + ", ".join(
                      f"{role} {busy[role]:.2f} ({busy[role] / v:.0%})"
                      for role, v in split.items())
                  + f"; whole solve {sum(busy.values()) / sum(split.values()):.0%}")
        else:
            print(f"[timing] solve stages {name}, device busy: not measured "
                  f"(the profiler recorded no device time)")

        solve_ms = _wall_ms(torch, lambda: engine.solve(a))
        eigh_ms = _wall_ms(torch, lambda: torch.linalg.eigh(a))
        print(f"[timing] end to end {name} ({B}, {N}, {N}): SolverEngine.solve "
              f"{solve_ms:.2f} ms, torch.linalg.eigh {eigh_ms:.2f} ms "
              f"(median of 3)")
    return records


def _print_record(r):
    library = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    card = (f", card time {r['device_ms']:.4f} ms" if "device_ms" in r
            else "")
    print(f"[timing] {r['name']}: {r['ms']:.4f} ms{card} (bound "
          f"{r['bound_ms']:.4g} ms by {r['bound_by']}; plain "
          f"{r['plain_ms']:.1f} ms; library {library})")


def _minor_library_ms(torch, kd):
    """``torch.linalg.eigvalsh`` on the dense minor tridiagonals of the main
    path's stack, the same function as the minor-spectra Sturm launch: the
    summed CUDA-event time of its calls over row chunks (one chunk where
    the dense stack fits in LIBRARY_CHUNK_BYTES), the number of calls, and
    the largest difference from the kernel's minor spectra."""
    dm, em, mu = kd["dm"], kd["em"], kd["mu"].reshape(B * N, N - 1)
    rows = max(1, int(LIBRARY_CHUNK_BYTES
                      // ((N - 1) ** 2 * dm.element_size())))

    def dense(lo, hi):
        t = dm.new_zeros((hi - lo, N - 1, N - 1))
        t.diagonal(dim1=-2, dim2=-1).copy_(dm[lo:hi])
        t.diagonal(1, dim1=-2, dim2=-1).copy_(em[lo:hi])
        t.diagonal(-1, dim1=-2, dim2=-1).copy_(em[lo:hi])
        return t

    torch.cuda.empty_cache()
    torch.linalg.eigvalsh(dense(0, B))  # warm-up
    total, calls, err = 0.0, 0, 0.0
    for lo in range(0, B * N, rows):
        hi = min(lo + rows, B * N)
        t = dense(lo, hi)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        w = torch.linalg.eigvalsh(t)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
        calls += 1
        err = max(err, float((w - mu[lo:hi]).abs().max()))
        del t, w
    torch.cuda.empty_cache()
    return total, calls, err


def _pack(torch, d, e, seg):
    """Pack ``seg`` bands of ``d (b, n)``, ``e (b, n-1)`` to a row, with
    zero off-diagonals at the junctions: ``(b / seg, seg * n)`` bands and
    their segment layout ``seg_off``, ``seg_len``."""
    b, n = d.shape
    rows = b // seg
    dp = d.reshape(rows, seg * n).contiguous()
    ep = torch.zeros((rows, seg, n), dtype=e.dtype, device=e.device)
    ep[:, :, :n - 1] = e.reshape(rows, seg, n - 1)
    ep = ep.reshape(rows, seg * n)[:, :-1].contiguous()
    off = (torch.arange(seg, dtype=torch.int32, device=d.device) * n
           ).expand(rows, seg).contiguous()
    length = torch.full((rows, seg), n, dtype=torch.int32, device=d.device)
    return dp, ep, off, length


def _packed_layout(batch, row_n, seg_n, seed):
    """A uniform packed stack with numpy: ``row_n // seg_n`` seeded
    symmetric requests ``a (batch * slots, seg_n, seg_n)`` a row, the
    block-diagonal rows ``(batch, row_n, row_n)`` and the layout ``off``,
    ``length`` ``(batch, slots)``."""
    import numpy as np

    slots = row_n // seg_n
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch * slots, seg_n, seg_n))
    a = (a + np.swapaxes(a, 1, 2)) / 2
    rows = np.zeros((batch, row_n, row_n))
    for b in range(batch):
        for s in range(slots):
            o = s * seg_n
            rows[b, o:o + seg_n, o:o + seg_n] = a[b * slots + s]
    off = np.tile(np.arange(slots, dtype=np.int32) * seg_n, (batch, 1))
    length = np.full((batch, slots), seg_n, np.int32)
    return a, rows, off, length


def _packed_program_bands(torch, dev, dtype, householder):
    """The bands and layout of the packed program's kernel-3 launch: the
    Householder bands of the packed rows (zero junctions)."""
    _, rows, off, length = _packed_layout(PACK_B, PACK_ROW_N, PACK_SEG_N,
                                          SEED + 7)
    d, e, _ = householder.tridiagonalize(
        torch.as_tensor(rows, dtype=dtype, device=dev), with_q=False)
    return (d.contiguous(), e.contiguous(), torch.as_tensor(off, device=dev),
            torch.as_tensor(length, device=dev))


def _plain_ms(torch, fn):
    """One call of a plain version on the card: its result and wall ms."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _phase_segmented(torch, dev, stack, kernels):
    """The segmented Sturm kernel against its plain version, bitwise, on
    packed bands and on warm brackets, and its contract with the Sturm
    kernel's window."""
    import numpy as np

    from repro_torch.kernels.sturm import kernel as st_kernel
    from repro_torch.kernels.sturm import ops as st_ops
    from repro_torch.linalg import householder, interlace
    from repro_torch.linalg.sturm import _pivmin, gershgorin_bounds

    out = {}
    for name, kd in kernels.items():
        d, e, iters = kd["d"], kd["e"], kd["iters"]
        tol = TOL[("sturm", name)]

        def both(dd, ee, lanes):
            got = st_kernel.sturm_segmented(dd, ee, **lanes, n_iter=iters,
                                            segment_lanes=K)
            plain, ms = _plain_ms(
                torch, lambda: st_kernel.sturm_segmented_plain(
                    dd, ee, **lanes, n_iter=iters))
            return got, plain, ms

        # The 16 bands packed SEG_S to a row.
        dp, ep, off, length = _pack(torch, d, e, SEG_S)
        for largest in (True, False):
            lanes = st_ops.segmented_lanes(dp, ep, off, length, k=K,
                                           largest=largest)
            got, plain, _ = both(dp, ep, lanes)
            check(torch.equal(got, plain), f"sturm_segmented {name} "
                  f"({B // SEG_S}, {SEG_S * N}) largest={largest}: kernel "
                  f"!= plain version")
            win = st_ops.sturm_eigenvalues(d, e, window=(K, largest))
            err = _max_err(torch, got.reshape(B, K), win, *tol,
                           f"sturm_segmented {name} vs the bands' windows")
            print(f"[kernels] sturm_segmented {name} ({B // SEG_S}, "
                  f"{SEG_S * N}), S={SEG_S}, k={K}, largest={largest}: "
                  f"bitwise-equal to the plain version; max abs err against "
                  f"each band's Sturm window {err:.3e}")

        # The 9600 minor bands packed SEG_S to a row: the timed shape.
        dmp, emp, moff, mlen = _pack(torch, kd["dm"], kd["em"], SEG_S)
        lanes = st_ops.segmented_lanes(dmp, emp, moff, mlen, k=K,
                                       largest=True)
        mgot, plain, plain_ms = both(dmp, emp, lanes)
        check(torch.equal(mgot, plain), f"sturm_segmented {name} minor "
              f"bands {tuple(dmp.shape)}: kernel != plain version")
        plain_err = float((mgot - plain).abs().max())
        top = kd["mu"].reshape(B * N, N - 1)[:, -K:]
        err = _max_err(torch, mgot.reshape(B * N, K), top, *tol,
                       f"sturm_segmented {name} minor bands vs sturm_bisect")
        same = torch.equal(mgot.reshape(B * N, K), top)
        print(f"[kernels] sturm_segmented {name} minor bands "
              f"{tuple(dmp.shape)}, S={SEG_S}, k={K}: bitwise-equal to the "
              f"plain version; against sturm_bisect's minor spectra max abs "
              f"err {err:.3e} (bitwise: {same})")

        # Warm brackets after a rank-1 update A' = A + rho u u^T, the first
        # four matrices' brackets made stale on purpose.
        rng = np.random.default_rng(SEED + 1)
        a = stack.to(d.dtype)
        u = torch.as_tensor(rng.standard_normal((B, N)), dtype=d.dtype,
                            device=dev)
        u = u / u.norm(dim=-1, keepdim=True)
        fro = a.norm(dim=(-2, -1))
        rho = 0.01 * fro
        a2 = a + rho[:, None, None] * u[:, :, None] * u[:, None, :]
        d2, e2, _ = householder.tridiagonalize(a2, with_q=False)
        lo, hi = interlace.rank1_update_brackets(
            kd["lam"][:, -K:], rho, drift_bound=(1e-6 * fro)[:, None])
        lo[:4] += 5.0
        hi[:4] += 5.0
        blanes = st_ops.bracketed_lanes(d2, e2, lo, hi, k=K, largest=True)
        kept = (blanes["lo"] == lo) & (blanes["hi"] == hi)
        check(not bool(kept[:4].any()), "a stale bracket passed validation")
        check(int(kept[4:].sum()) >= (B - 4) * K // 2,
              f"only {int(kept[4:].sum())} warm brackets passed validation")
        got, plain, _ = both(d2, e2, blanes)
        check(torch.equal(got, plain),
              f"sturm_segmented {name} warm brackets: kernel != plain version")
        err = _max_err(torch, got, st_ops.sturm_eigenvalues(
            d2, e2, window=(K, True)), *tol,
            f"sturm_eigenvalues_bracketed {name} vs the Sturm window")
        print(f"[kernels] sturm_eigenvalues_bracketed {name} ({B}, {N}), "
              f"k={K}: {int(kept.sum())} of {B * K} warm brackets kept, the "
              f"{int((~kept).sum())} others (all stale ones among them) on "
              f"Gershgorin; bitwise-equal to the plain version; max abs err "
              f"against the updated bands' Sturm window {err:.3e}")

        # Contract: one full-band segment and the Gershgorin bracket give
        # the Sturm kernel's window, bitwise.
        glo, ghi = gershgorin_bounds(d, e)

        def lane(x):
            return x.unsqueeze(-1).expand(B, K).contiguous()

        targets = torch.arange(N - K, N, dtype=torch.int32,
                               device=dev).expand(B, K).contiguous()
        full = st_kernel.sturm_segmented(
            d, e, lane(glo), lane(ghi), lane(_pivmin(d, e)),
            torch.zeros_like(targets), torch.full_like(targets, N), targets,
            n_iter=iters)
        check(torch.equal(full, st_ops.sturm_eigenvalues(d, e,
                                                         window=(K, True))),
              f"sturm_segmented {name}: one full-band segment != the "
              f"sturm_bisect window")
        print(f"[kernels] sturm_segmented {name}: one full-band segment with "
              f"the Gershgorin bracket is bitwise the sturm_bisect window")
        out[name] = dict(dm=dmp, em=emp, lanes=lanes, got=mgot, iters=iters,
                         err=plain_err, plain_ms=plain_ms)
    return out


def _kernel_device_ms(torch, fn, reps=20):
    """The card's time of one call of ``fn``, apart from the host's time to
    issue it: ``reps`` calls captured in one CUDA graph, replayed between
    two CUDA events (median of 5 replays)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[2]


def _phase_packed(torch, dev):
    """The packed top-k program through its entry points: PACK_B rows of
    PACK_ROW_N packing requests of n = PACK_SEG_N (the windowed tridiagonal
    chain and kernel 3), and the eigh chain at PACK_EIGH_ROW_N, in float64
    and float32.  Kernel 3's launch is held bitwise against its plain
    version on the program's own operands, every slot against float64
    eigvalsh of its request, and the per-slot verify flags are read."""
    from repro_torch import SolverPlan, packed_plan_for, packed_topk_program
    from repro_torch.kernels.sturm import kernel as st_kernel
    from repro_torch.kernels.sturm import ops as st_ops

    out = {}
    for name in ("float64", "float32"):
        dtype = getattr(torch, name)
        for row_n in (PACK_ROW_N, PACK_EIGH_ROW_N):
            tridiag = row_n > 128
            a, rows, off, length = _packed_layout(PACK_B, row_n, PACK_SEG_N,
                                                  SEED + 7)
            # Each chain named, whatever the calibration table picks.
            plan = (SolverPlan(method="eei_tridiag", spectrum="windowed")
                    if tridiag else SolverPlan(method="eigh"))
            print(f"[packed] packed_plan_for({row_n}) picks "
                  f"{packed_plan_for(row_n)}")
            prog = packed_topk_program(plan, K, True, verify=True)
            rows_t = torch.as_tensor(rows, dtype=dtype, device=dev)
            off_t = torch.as_tensor(off, device=dev)
            len_t = torch.as_tensor(length, device=dev)
            what = (f"packed {name} {PACK_B}x{row_n}, {off.shape[1]} requests "
                    f"of n={PACK_SEG_N} a row, k={K} ({plan.method} chain)")

            # The program once, with the counts set to 0 just before and
            # read just after; kernel 3's operands captured as the session
            # phase captures them.
            seg_calls = []
            seg = st_ops.sturm_segmented

            def capturing(d, e, *, n_iter, **lanes):
                got = seg(d, e, **lanes, n_iter=n_iter)
                seg_calls.append((d, e, lanes, n_iter, got))
                return got

            st_ops.sturm_segmented = capturing
            try:
                _reset_counts()
                res, flags = prog(rows_t, off_t, len_t)
                torch.cuda.synchronize()
                counts = _read_counts()
            finally:
                st_ops.sturm_segmented = seg
            print(f"[packed] {what}: launches {counts}")
            check(counts["sturm_segmented"] == (1 if tridiag else 0),
                  f"{what}: {counts['sturm_segmented']} segmented Sturm "
                  f"launches in one call")
            check(len(seg_calls) == counts["sturm_segmented"],
                  f"{what}: {len(seg_calls)} launches captured")
            for d, e, lanes, n_iter, got in seg_calls:
                check(torch.equal(got, st_kernel.sturm_segmented_plain(
                    d, e, **lanes, n_iter=n_iter)),
                    f"{what}: kernel 3 differs from its plain version on the "
                    f"program's {tuple(d.shape)} band")

            # Every slot against float64 eigvalsh of its own request.
            ref = torch.linalg.eigvalsh(torch.as_tensor(a, device=dev))[:, -K:]
            lam = res.eigenvalues.double().reshape(-1, K)
            check(tuple(res.vectors.shape) == (PACK_B, off.shape[1], K, row_n)
                  and bool(torch.isfinite(res.vectors).all()),
                  f"{what}: vectors {tuple(res.vectors.shape)} or not finite")
            scale = torch.clamp(ref.abs().amax(dim=-1, keepdim=True), min=1.0)
            err = float(((lam - ref).abs() / scale).max())
            check(err <= PACK_TOL, f"{what}: eigenvalue error {err:.3e} of "
                  f"max(1, |lambda|max) > {PACK_TOL:g}")
            # The per-slot flags: all ok, but for the in-segment mass of
            # float32 slots of the tridiagonal chain, which repro's chain
            # misses as well (tests/test_torch_packed.py): those slots must
            # fail that check alone, as a server re-solves them.
            check(bool((flags.finite & flags.residual_ok & flags.ordered)
                       .all()), f"{what}: a slot failed finite, residual or "
                  f"order: {flags}")
            mass_misses = int((~flags.ok).sum())
            if name == "float64" or not tridiag:
                check(mass_misses == 0, f"{what}: {mass_misses} slots failed "
                      f"verify")
            else:
                check(torch.equal(flags.ok, flags.norm_ok),
                      f"{what}: a slot failed more than the mass check")
            print(f"[packed] {what}: every slot within {err:.3e} of "
                  f"max(1, |lambda|max) of eigvalsh of its request (limit "
                  f"{PACK_TOL:g}); verify ok on {int(flags.ok.sum())} of "
                  f"{flags.ok.numel()} slots ({mass_misses} missed only the "
                  f"in-segment mass); worst residual "
                  f"{float(flags.residual.max()):.3e} of the segment's norm"
                  + ("; kernel 3 bitwise its plain version" if tridiag
                     else ""))

            # Wall time of the program (median of 5), launches a call, the
            # eigh yardstick on the (requests, n, n) stack, and the stages.
            a_t = torch.as_tensor(a, dtype=dtype, device=dev)
            times = []
            before = st_kernel.sturm_segmented.launches
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                prog(rows_t, off_t, len_t)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            per_call = (st_kernel.sturm_segmented.launches - before) / 5
            check(per_call == (1 if tridiag else 0),
                  f"{what}: {per_call} segmented launches a call")
            torch.linalg.eigh(a_t)
            eigh = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                torch.linalg.eigh(a_t)
                torch.cuda.synchronize()
                eigh.append((time.perf_counter() - t) * 1e3)
            state = prog.initial_state(rows_t, off_t, len_t)
            split = []
            for sig, fn in prog.stages:
                torch.cuda.synchronize()
                t = time.perf_counter()
                state.update(fn(state))
                torch.cuda.synchronize()
                split.append(f"{sig.name} {(time.perf_counter() - t) * 1e3:.3f}")
            print(f"[packed] {what}: program {sorted(times)[2]:.3f} ms "
                  f"(median of 5; {per_call:g} kernel-3 launch a call); "
                  f"torch.linalg.eigh of the ({a.shape[0]}, {PACK_SEG_N}, "
                  f"{PACK_SEG_N}) requests {sorted(eigh)[2]:.3f} ms; by stage "
                  f"(ms): " + ", ".join(split))
            if tridiag:
                out[name] = dict(call=seg_calls[0], counts=counts,
                                 program_ms=sorted(times)[2],
                                 eigh_ms=sorted(eigh)[2])
    return out


def _packed_record(torch, dev, name, packed):
    """Kernel 3's record at the packed program's launch: its own operands,
    timed with CUDA events (and the card's kernel time), beside its bound,
    its plain version and eigvalsh of the dense segment tridiagonals."""
    from repro_torch.kernels.sturm import kernel as st_kernel
    from repro_torch.linalg.householder import tridiagonal_matrix

    d, e, lanes, n_iter, got = packed["call"]
    rows, n = d.shape
    m = lanes["lo"].shape[1]
    fn = lambda: st_kernel.sturm_segmented(d, e, **lanes, n_iter=n_iter)  # noqa: E731
    ms = _events_ms(torch, fn, warmup=3, reps=50)
    device_ms = _kernel_device_ms(torch, fn)
    plain, plain_ms = _plain_ms(torch, lambda: st_kernel.sturm_segmented_plain(
        d, e, **lanes, n_iter=n_iter))
    seg_steps = int((lanes["end"] - lanes["start"]).sum())
    ops = seg_steps * n_iter * (STURM_OPS_PER_STEP + SEGMENT_COMPARE_OPS)
    nbytes = ((rows * n + rows * (n - 1) + 4 * rows * m) * d.element_size()
              + 3 * rows * m * 4)
    bound, by = _bound(ops, nbytes, name)
    # The same function by the library: eigvalsh of every segment's dense
    # tridiagonal, (rows * slots, PACK_SEG_N, PACK_SEG_N).
    slots = n // PACK_SEG_N
    dd = d.reshape(rows * slots, PACK_SEG_N)
    ee = torch.cat([e, e.new_zeros((rows, 1))], dim=1).reshape(
        rows * slots, PACK_SEG_N)[:, :-1]
    dense = tridiagonal_matrix(dd, ee)
    lib_ms = _events_ms(torch, lambda: torch.linalg.eigvalsh(dense),
                        warmup=2, reps=20)
    lib_err = float((torch.linalg.eigvalsh(dense)[:, -K:]
                     - got.reshape(rows * slots, K)).abs().max())
    print(f"[timing] eigvalsh of the ({rows * slots}, {PACK_SEG_N}, "
          f"{PACK_SEG_N}) segment tridiagonals {name}: {lib_ms:.4f} ms; max "
          f"abs difference from kernel 3's lanes {lib_err:.3e}; kernel 3's "
          f"card time {device_ms:.4f} ms a launch (CUDA graph)")
    return _record(
        f"sturm_segmented[packed program {rows}x{n} S={slots} k={K} {name}]",
        "sturm_segmented", launches=packed["counts"]["sturm_segmented"],
        err=float((got - plain).abs().max()), ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=lib_ms, device_ms=device_ms,
        program_ms=packed["program_ms"], eigh_ms=packed["eigh_ms"])


def _phase_prod_diff_variants(torch, dev, kernels):
    """The masked and single-matrix prod-diff kernels against their plain
    versions."""
    import numpy as np

    from repro_torch.kernels.prod_diff import kernel as pd_kernel

    out = {}
    for name, kd in kernels.items():
        lam, mu, floor = kd["lam"], kd["mu"], kd["floor"]
        tol = TOL[("prod_diff", name)]
        rng = np.random.default_rng(SEED + 2)
        mask = torch.as_tensor(rng.random((B, N, N - 1)) > 0.25, device=dev)
        got = pd_kernel.logabs_sum_masked(lam, mu, mask, floor)
        plain, masked_plain_ms = _plain_ms(
            torch, lambda: pd_kernel.logabs_sum_masked_plain(lam, mu, mask,
                                                             floor))
        masked_err = _max_err(torch, got, plain, *tol,
                              f"logabs_sum_masked {name}")
        lam0, mu0, floor0 = lam[0], mu[0], floor[0]
        one = pd_kernel.logabs_sum_single(lam0, mu0, floor0)
        plain, single_plain_ms = _plain_ms(
            torch, lambda: pd_kernel.logabs_sum_single_plain(lam0, mu0,
                                                             floor0))
        single_err = _max_err(torch, one, plain, *tol,
                              f"logabs_sum_single {name}")
        check(torch.equal(one, pd_kernel.logabs_sum(lam, mu, floor)[0]),
              f"logabs_sum_single {name} != logabs_sum's first matrix")
        print(f"[kernels] logabs_sum_masked {name} ({B}, {N}, {N}, {N - 1}), "
              f"random per-matrix mask ({int(mask.sum())} of {mask.numel()} "
              f"cells valid): max abs err {masked_err:.3e}; logabs_sum_single"
              f" {name} ({N}, {N}, {N - 1}): max abs err {single_err:.3e}, "
              f"bitwise logabs_sum's first matrix")
        out[name] = dict(mask=mask, masked_err=masked_err,
                         masked_plain_ms=masked_plain_ms,
                         single_err=single_err,
                         single_plain_ms=single_plain_ms)
    return out


def _phase_ops(torch, dev, kernels):
    """The masked and single-matrix kernels through their op entry points,
    with the counts set to 0 just before and read just after."""
    import numpy as np

    from repro_torch.kernels.prod_diff import ops as pd_ops
    from repro_torch.linalg.householder import tridiagonal_matrix

    counts = {}
    for name, kd in kernels.items():
        lam, mu, floor = kd["lam"], kd["mu"], kd["floor"]
        # Each matrix's valid block is its own: rows j < J_b, terms k < K_b.
        rng = np.random.default_rng(SEED + 3)
        j_b = rng.integers(N // 2, N + 1, size=B).tolist()
        k_b = rng.integers(N // 2, N, size=B).tolist()
        jj = torch.arange(N, device=dev)[None, :, None]
        kk = torch.arange(N - 1, device=dev)[None, None, :]
        ragged = ((jj < torch.tensor(j_b, device=dev)[:, None, None])
                  & (kk < torch.tensor(k_b, device=dev)[:, None, None]))
        _reset_counts()
        num = pd_ops.logabs_sum_batched(lam, mu, floor, mask=ragged)
        mags = pd_ops.eei_magnitudes(lam[0], mu[0])
        one = pd_ops.logabs_sum(lam[0], mu[0], floor[0])
        torch.cuda.synchronize()
        counts[name] = _read_counts()
        print(f"[ops] launches through the op entry points, {name} "
              f"(logabs_sum_batched(mask=), eei_magnitudes, logabs_sum): "
              f"{counts[name]}")
        check(counts[name]["logabs_sum_masked"] == 1
              and counts[name]["logabs_sum_single"] == 2,
              f"the op entry points did not launch their kernels: "
              f"{counts[name]}")
        # A masked cell adds exactly 0, so each matrix's rows are the
        # unmasked kernel's on its own valid block, bitwise.
        for b in range(B):
            ref = pd_ops.logabs_sum_batched(
                lam[b:b + 1], mu[b:b + 1, :j_b[b], :k_b[b]].contiguous(),
                floor[b:b + 1])
            check(torch.equal(num[b:b + 1, :, :j_b[b]], ref),
                  f"logabs_sum_batched(mask=) {name}, matrix {b}: != the "
                  f"unmasked kernel on its valid block")
        check(torch.equal(one, pd_ops.logabs_sum_batched(
            lam[:1], mu[:1], floor[:1])[0]),
            f"logabs_sum {name} != logabs_sum_batched's first matrix")
        # eei_magnitudes of the first band against eigh of its tridiagonal.
        t0 = tridiagonal_matrix(kd["d"][0], kd["e"][0]).double()
        w = torch.linalg.eigh(t0)[1]
        ref = (w * w).transpose(0, 1)
        batched = pd_ops.eei_magnitudes_batched(lam[:1], mu[:1])[0]
        _max_err(torch, mags, batched, *TOL[("prod_diff", name)],
                 f"eei_magnitudes {name} vs eei_magnitudes_batched")
        if name == "float64":
            err = _max_err(torch, mags, ref, 1e-4, 1e-7,
                           f"eei_magnitudes {name} vs eigh")
        else:
            worst = float(_row_err(mags, ref).max())
            check(worst <= F32_ROW_LIMIT, f"eei_magnitudes {name}: a row is "
                  f"off by {worst:.3e} (relative 2-norm) > {F32_ROW_LIMIT:g}")
            err = float((mags.double() - ref).abs().max())
        print(f"[ops] {name}: logabs_sum_batched(mask=) rows bitwise the "
              f"unmasked kernel's on each matrix's valid block; logabs_sum "
              f"bitwise logabs_sum_batched; eei_magnitudes of band 0 within "
              f"tolerance of eigh (max abs err {err:.3e})")
    return counts


def _phase_session(torch, dev, stack):
    """A streaming session on one n = 600 matrix of the stack, per dtype,
    every step checked against float64 eigvalsh and the verify stage."""
    import numpy as np

    from repro_torch import (Rank1Update, SessionConfig, SolverEngine,
                             SolverPlan)
    from repro_torch.engine import session as session_mod
    from repro_torch.engine.verify import verify_topk_host
    from repro_torch.kernels.sturm import ops as st_ops
    from repro_torch.kernels.sturm.kernel import (sturm_segmented,
                                                  sturm_segmented_plain)

    # Every run of the host rung, with where in the stream it ran and the
    # matrix it was given.
    reseeds, where = [], {}
    host_reseed = session_mod.host_reseed

    def counted_reseed(session, a_new, *args, **kwargs):
        reseeds.append(dict(where, a=a_new.detach().cpu().numpy()))
        return host_reseed(session, a_new, *args, **kwargs)

    session_mod.host_reseed = counted_reseed
    out = {}
    try:
        for name in ("float64", "float32"):
            dtype = getattr(torch, name)
            a_np = stack[0].cpu().numpy()
            plan = SolverPlan(method="eei_tridiag", backend="cuda",
                              precision=name)
            engine = SolverEngine(plan)
            rng = np.random.default_rng(SEED + 4)
            fro = float(np.linalg.norm(a_np))
            small = np.sqrt(0.01 * fro / N)
            big = np.sqrt(0.6 * fro / N)
            span0 = None
            worst = 0.0

            def check_step(res, a_now, what):
                nonlocal span0, worst
                lam = np.linalg.eigvalsh(a_now)
                if span0 is None:
                    span0 = float(lam[-1] - lam[0])
                got = res.eigenvalues.double().cpu().numpy()
                vecs = res.vectors.double().cpu().numpy()
                rel = float(np.max(np.abs(got - lam[-K:]))) / span0
                worst = max(worst, rel)
                check(rel <= SESSION_TOL, f"session {name} {what}: eigenvalue "
                      f"error {rel:.3e} of the span > {SESSION_TOL:g}")
                flags = verify_topk_host(a_now, got, vecs)
                check(bool(flags.ok), f"session {name} {what}: verify failed "
                      f"({flags})")

            def update(scale, what):
                nonlocal a_np
                where["stage"] = what
                u = rng.standard_normal(N) * scale
                a_np = a_np + np.outer(u, u)
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = engine.update(session, Rank1Update(u, 1))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                check_step(res, a_np, what)
                return ms

            where.update(dtype=name, stage="open")
            _reset_counts()
            session = engine.open_session(
                a_np, K, config=SessionConfig(drift_bound=0.5))
            check_step(session.result(), a_np, "open")
            check(session.dtype == dtype, f"session dtype {session.dtype}")
            for i in range(SESSION_WARMUP):
                update(small, f"warm-up {i}")
            fast0 = session.fast_updates
            seg0 = sturm_segmented.launches
            # Every segmented launch of the stream, with the operands the
            # tridiag_bracketed stage gave it and what it returned: held
            # against the plain version below, outside the counted run.
            seg_calls = []

            def capturing(d, e, *, n_iter, **lanes):
                got = sturm_segmented(d, e, **lanes, n_iter=n_iter)
                seg_calls.append((d, e, lanes, n_iter, got))
                return got

            st_ops.sturm_segmented = capturing
            try:
                times = [update(small, f"stream {i}")
                         for i in range(SESSION_STREAM)]
            finally:
                st_ops.sturm_segmented = sturm_segmented
            stream_fast = session.fast_updates - fast0
            stream_seg = sturm_segmented.launches - seg0
            for i in range(SESSION_BIG):
                update(big, f"large {i}")
            torch.cuda.synchronize()
            counts = _read_counts()
            stats = session.stats()
            mine = [r for r in reseeds if r["dtype"] == name]
            print(f"[session] {name} n={N} k={K} m_keep={stats['m_keep']}: "
                  f"{stats}; launches on the session path {counts}; host "
                  f"reseeds {[r['stage'] for r in mine]}; worst eigenvalue "
                  f"error {worst:.3e} of the span")
            check(stream_fast == SESSION_STREAM, f"session {name}: "
                  f"{stream_fast} of {SESSION_STREAM} stream updates took "
                  f"the fast path")
            check(stream_seg == SESSION_STREAM, f"session {name}: "
                  f"{stream_seg} segmented Sturm launches over "
                  f"{SESSION_STREAM} fast updates")
            check(counts["sturm_segmented"] == stats["fast_updates"],
                  f"session {name}: {counts['sturm_segmented']} segmented "
                  f"Sturm launches for {stats['fast_updates']} fast updates")
            check(len(seg_calls) == SESSION_STREAM, f"session {name}: "
                  f"{len(seg_calls)} segmented launches went through the "
                  f"bracketed op over {SESSION_STREAM} fast updates")
            for i, (d, e, lanes, n_iter, got) in enumerate(seg_calls):
                check(torch.equal(got, sturm_segmented_plain(
                    d, e, **lanes, n_iter=n_iter)),
                    f"session {name} stream {i}: the segmented Sturm kernel "
                    f"differs from its plain version on the update's "
                    f"{tuple(d.shape)} band, {tuple(got.shape)} lanes")
            d, e, lanes, n_iter, got = seg_calls[-1]
            print(f"[session] {name}: sturm_segmented bitwise its plain "
                  f"version on the operands of all {len(seg_calls)} stream "
                  f"updates (band {tuple(d.shape)}, lanes "
                  f"{tuple(got.shape)}, n_iter {n_iter}, segment "
                  f"[{int(lanes['start'].min())}, {int(lanes['end'].max())}))")
            causes = stats["resolves_by_cause"]
            check(causes.get("drift", 0) >= 1,
                  f"session {name}: the large updates forced no drift "
                  f"re-solve: {causes}")
            check("verify" not in causes,
                  f"session {name}: a fast update failed verify: {causes}")
            # The host rung may only have run where the session's own
            # re-solve could not pass verify: in float32, on the matrix a
            # large update left (a dominant eigenvalue takes the float32 EEI
            # components past the residual bound; repro's float32 re-solve
            # of this very matrix misses it with the same residual:
            # tests/test_torch_session.py::test_float32_resolve_of_the_chip_
            # smoke_matrix_misses_verify_in_both_packages).  Never in
            # float64, and never for the open, the warm-up or the stream.
            for r in mine:
                check(name == "float32" and r["stage"].startswith("large"),
                      f"session {name}: the host rung ran for {r['stage']}")
                a_r = torch.as_tensor(r["a"], dtype=dtype, device=dev)
                res = engine.topk(a_r, session.m_keep)
                flags = verify_topk_host(r["a"], res.eigenvalues.cpu().numpy(),
                                         res.vectors.cpu().numpy())
                check(not bool(flags.ok), f"session {name}: the host rung ran "
                      f"for {r['stage']} although the card's re-solve passes "
                      f"verify ({flags})")
                print(f"[session] {name}: the re-solve after {r['stage']} fell"
                      f" to the host rung: the card's top-{session.m_keep} of "
                      f"that matrix has residual {float(flags.residual):.3e} of"
                      f" ||A||_F > the verify bound; top eigenvalue "
                      f"{float(np.linalg.eigvalsh(r['a'])[-1]):.2f}, "
                      f"||A||_F {float(np.linalg.norm(r['a'])):.2f}")
            check(counts["sturm_bisect"] > 0 and counts["logabs_sum"] > 0,
                  f"session {name}: the re-solves ran no main-path kernel")

            # Latency: the warm update against a top-k from scratch (the
            # session's plan, and the windowed plan) and
            # torch.linalg.eigh, on the stream's last matrix.
            a_t = torch.as_tensor(a_np, dtype=dtype, device=dev)
            windowed = SolverEngine(SolverPlan(
                method="eei_tridiag", spectrum="windowed", precision=name))

            lat = {"update_ms": float(np.median(times)),
                   "update_ms_min": float(np.min(times)),
                   "update_ms_max": float(np.max(times)),
                   "topk_scratch_ms": _wall_ms(torch,
                                               lambda: engine.topk(a_t, K)),
                   "topk_windowed_ms": _wall_ms(
                       torch, lambda: windowed.topk(a_t, K)),
                   "eigh_ms": _wall_ms(torch,
                                       lambda: torch.linalg.eigh(a_t))}
            print(f"[session] {name} latency (ms): warm update median "
                  f"{lat['update_ms']:.3f} (min {lat['update_ms_min']:.3f}, "
                  f"max {lat['update_ms_max']:.3f}, {SESSION_STREAM} updates)"
                  f"; engine.topk from scratch {lat['topk_scratch_ms']:.3f} "
                  f"(session plan), {lat['topk_windowed_ms']:.3f} (windowed "
                  f"plan); torch.linalg.eigh {lat['eigh_ms']:.3f} (median "
                  f"of 3)")
            _split_update(torch, dev, engine, session, rng, small, name)
            out[name] = dict(counts=counts, stats=stats, latency=lat,
                             reseeds=[r["stage"] for r in mine],
                             launches_per_update=stream_seg / SESSION_STREAM,
                             seg_call=seg_calls[-1])
    finally:
        session_mod.host_reseed = host_reseed
    return out


def _split_update(torch, dev, engine, session, rng, scale, name):
    """One more update of ``session``'s state (not committed) split into
    the update program's stages: wall ms (median of 5, synchronised around
    each), and the card's kernel ms and kernel count for one more run of
    the stage (torch.profiler)."""
    from repro_torch.engine.engine import update_program

    prog = update_program(engine.plan, session.k, session.largest,
                          session.m_keep, session.n_aug)
    u = torch.as_tensor(rng.standard_normal(N) * scale, dtype=session.dtype,
                        device=dev)
    rho = (u * u).sum().reshape(1)
    state = prog.initial_state(session.a[None], session.basis[None],
                               session.theta[None], (u / rho.sqrt())[None],
                               rho)
    parts = []
    for sig, fn in prog.stages:
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        busy, launched = _device_ms(torch, lambda: fn(state))
        state.update(out)
        parts.append(f"{sig.name} {sorted(times)[2]:.3f} ms ({launched} "
                     f"device events, {busy:.3f} ms busy)")
    print(f"[session] {name} one update by stage: " + "; ".join(parts))


def _phase_timing_other_kernels(torch, dev, kernels, segmented, variants, op_counts,
                      sessions):
    """Time the segmented Sturm, masked and single-matrix prod-diff kernels
    beside their bounds, plain versions and library yardsticks."""
    from repro_torch.kernels.prod_diff import kernel as pd_kernel
    from repro_torch.kernels.sturm import kernel as st_kernel
    from repro_torch.linalg.householder import tridiagonal_matrix

    records = []
    for name, kd in kernels.items():
        elsize = kd["d"].element_size()
        sg = segmented[name]
        dmp, emp, lanes, iters = sg["dm"], sg["em"], sg["lanes"], sg["iters"]
        rows, n_band = dmp.shape
        m = lanes["lo"].shape[1]
        ms = _events_ms(torch, lambda: st_kernel.sturm_segmented(
            dmp, emp, **lanes, n_iter=iters, segment_lanes=K), warmup=1,
            reps=3)
        # What any implementation must do: the steps inside each lane's own
        # segment, with the segment compare.
        seg_steps = int((lanes["end"] - lanes["start"]).sum())
        ops = seg_steps * iters * (STURM_OPS_PER_STEP + SEGMENT_COMPARE_OPS)
        nbytes = ((rows * n_band + rows * (n_band - 1) + 4 * rows * m)
                  * elsize + 3 * rows * m * 4)
        bound, by = _bound(ops, nbytes, name)
        lib_ms, lib_err = _segment_library_ms(torch, kd, sg)
        print(f"[timing] eigvalsh of the dense segment tridiagonals of the "
              f"first {SEG_LIBRARY_ROWS} packed rows "
              f"({SEG_LIBRARY_ROWS * SEG_S} segments) {name}, scaled to all "
              f"{rows} rows: {lib_ms:.1f} ms; max abs difference from the "
              f"kernel's lanes {lib_err:.3e}")
        whole_band = rows * m * iters * n_band * (
            STURM_OPS_PER_STEP + SEGMENT_COMPARE_OPS)
        print(f"[timing] sturm_segmented {name}: the whole-band recurrence "
              f"runs {whole_band / ops:.2f}x the steps inside the segments")
        records.append(_record(
            f"sturm_segmented[minor bands packed {rows}x{n_band} S={SEG_S} "
            f"k={K} {name}]", "sturm_segmented",
            launches=sessions[name]["counts"]["sturm_segmented"],
            err=sg["err"], ms=ms, plain_ms=sg["plain_ms"], bound_ms=bound,
            bound_by=by, library_ms=lib_ms,
            launches_per_update=sessions[name]["launches_per_update"]))

        # Kernel 3 alone at the shape the session launches it: the last
        # stream update's band and lanes (bitwise its plain version, checked
        # in the session phase); yardstick: eigvalsh of the dense band.
        d1, e1, lanes1, it1, got1 = sessions[name]["seg_call"]
        rows1, n1 = d1.shape
        m1 = lanes1["lo"].shape[1]
        ms = _events_ms(torch, lambda: st_kernel.sturm_segmented(
            d1, e1, **lanes1, n_iter=it1), warmup=5, reps=200)
        device_ms = _kernel_device_ms(torch, lambda: st_kernel.sturm_segmented(
            d1, e1, **lanes1, n_iter=it1))
        plain1, plain_ms = _plain_ms(
            torch, lambda: st_kernel.sturm_segmented_plain(d1, e1, **lanes1,
                                                           n_iter=it1))
        seg_steps = int((lanes1["end"] - lanes1["start"]).sum())
        ops = seg_steps * it1 * (STURM_OPS_PER_STEP + SEGMENT_COMPARE_OPS)
        nbytes = ((rows1 * n1 + rows1 * (n1 - 1) + 4 * rows1 * m1) * elsize
                  + 3 * rows1 * m1 * 4)
        bound, by = _bound(ops, nbytes, name)
        dense = tridiagonal_matrix(d1, e1)
        lib_ms = _events_ms(torch, lambda: torch.linalg.eigvalsh(dense),
                            warmup=2, reps=20)
        records.append(_record(
            f"sturm_segmented[session band {rows1}x{n1}, {m1} lanes {name}]",
            "sturm_segmented",
            launches=sessions[name]["counts"]["sturm_segmented"],
            err=float((got1 - plain1).abs().max()), ms=ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=lib_ms, device_ms=device_ms,
            launches_per_update=sessions[name]["launches_per_update"]))

        vd = variants[name]
        lam, mu, floor, mask = kd["lam"], kd["mu"], kd["floor"], vd["mask"]
        ms = _events_ms(torch, lambda: pd_kernel.logabs_sum_masked(
            lam, mu, mask, floor), warmup=2, reps=10)
        terms = N * int(mask.sum())
        nbytes = (B * N + B * N * (N - 1) + B + B * N * N) * elsize \
            + B * N * (N - 1)
        bound, by = _bound(terms * PROD_DIFF_OPS_PER_TERM, nbytes, name)
        records.append(_record(
            f"logabs_sum_masked[{B}x{N}x{N}x{N - 1} random mask {name}]",
            "prod_diff_masked",
            launches=op_counts[name]["logabs_sum_masked"],
            err=vd["masked_err"], ms=ms, plain_ms=vd["masked_plain_ms"],
            bound_ms=bound, bound_by=by, library_ms=None))

        lam0, mu0, floor0 = lam[0], mu[0], floor[0]
        ms = _events_ms(torch, lambda: pd_kernel.logabs_sum_single(
            lam0, mu0, floor0), warmup=2, reps=20)
        nbytes = (N + N * (N - 1) + 1 + N * N) * elsize
        bound, by = _bound(N * N * (N - 1) * PROD_DIFF_OPS_PER_TERM, nbytes,
                           name)
        records.append(_record(
            f"logabs_sum_single[{N}x{N}x{N - 1} {name}]", "prod_diff_single",
            launches=op_counts[name]["logabs_sum_single"],
            err=vd["single_err"], ms=ms, plain_ms=vd["single_plain_ms"],
            bound_ms=bound, bound_by=by, library_ms=None))
    for r in records:
        _print_record(r)
    return records


def _segment_library_ms(torch, kd, sg):
    """``torch.linalg.eigvalsh`` of the dense segment tridiagonals of the
    first SEG_LIBRARY_ROWS packed rows (minor bands 0 .. SEG_S * rows - 1),
    the same function as the segmented launch there: its CUDA-event time
    scaled to all rows, and the largest difference of its top K eigenvalues
    from the kernel's lanes."""
    dm, em = kd["dm"], kd["em"]
    count = SEG_LIBRARY_ROWS * SEG_S
    t = dm.new_zeros((count, N - 1, N - 1))
    t.diagonal(dim1=-2, dim2=-1).copy_(dm[:count])
    t.diagonal(1, dim1=-2, dim2=-1).copy_(em[:count])
    t.diagonal(-1, dim1=-2, dim2=-1).copy_(em[:count])
    torch.linalg.eigvalsh(t[:SEG_S])  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    w = torch.linalg.eigvalsh(t)
    end.record()
    torch.cuda.synchronize()
    rows = sg["dm"].shape[0]
    got = sg["got"][:SEG_LIBRARY_ROWS].reshape(count, K)
    err = float((w[:, -K:] - got).abs().max())
    del t, w
    torch.cuda.empty_cache()
    return start.elapsed_time(end) * rows / SEG_LIBRARY_ROWS, err


# -- the dense and Krylov compositions, and the calibration sweep ------------


def _wall_ms(torch, fn, reps=3):
    """Median wall ms of ``reps`` calls after one warm-up, synchronized."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[len(times) // 2]


def _stage_split(torch, plan, spec, a):
    """One more run of ``plan``'s ``spec`` program on ``a``, stage by stage
    with a synchronize around each: ``"name ms, ..."``."""
    from repro_torch.engine.engine import program

    prog = program(plan, spec)
    state = prog.initial_state(a)
    parts = []
    for sig, fn in prog.stages:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state.update(fn(state))
        torch.cuda.synchronize()
        parts.append(f"{sig.name} {(time.perf_counter() - t) * 1e3:.3f}")
    return ", ".join(parts)


class _GraphRecord(tuple):
    """A ``_capture`` record ``(args, kwargs, result)`` of a call recorded
    into a CUDA graph (the Lanczos residual check's kernel 1): it launched
    nothing, the graph launches it at each replay (counted in its
    wrapper's ``replayed``), and its tensors are the graph's, which each
    replay rewrites (:func:`_settle`)."""


def _capture(module, attr, calls):
    """Replace ``module.attr`` (a kernel's entry, by the name its caller
    looks it up under) with a wrapper that appends ``(args, kwargs,
    result)`` to ``calls``, a :class:`_GraphRecord` for a call under CUDA
    graph capture; returns the undo.  The wrappers' own launch counts are
    untouched."""
    import torch

    launch = getattr(module, attr)

    def capturing(*args, **kwargs):
        out = launch(*args, **kwargs)
        record = (args, kwargs, out)
        if (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            record = _GraphRecord(record)
        calls.append(record)
        return out

    setattr(module, attr, capturing)
    return lambda: setattr(module, attr, launch)


def _settle(torch, calls, start=0):
    """Replace each :class:`_GraphRecord` of ``calls[start:]`` by a copy of
    its operands and result as the graph's last replay left them (call
    after the card is idle), so that later replays leave what is held
    against the plain version as it is."""
    for i in range(start, len(calls)):
        if isinstance(calls[i], _GraphRecord):
            args, kwargs, out = calls[i]
            calls[i] = _GraphRecord((
                tuple(x.clone() if torch.is_tensor(x) else x for x in args),
                kwargs, out.clone()))


def _graph_launches(records, replayed):
    """A wrapper's launches from its ``_capture`` records and the launches
    its graphs' replays made: each record but a :class:`_GraphRecord`, and
    each replayed launch."""
    return sum(not isinstance(r, _GraphRecord) for r in records) + replayed


def _phase_dense(torch, dev):
    """``eei_dense`` and ``eei_dense_windowed`` through the engine: every
    kernel-2 launch captured, held against its plain version and, for the
    windowed one, bitwise against the full table's rows."""
    import numpy as np

    from repro_torch import SolverEngine, SolverPlan, plan_for
    from repro_torch.engine.engine import ProgramSpec
    from repro_torch.kernels.prod_diff import kernel as pd_kernel
    from repro_torch.kernels.prod_diff import ops as pd_ops

    rng = np.random.default_rng(SEED + 8)
    a_np = rng.standard_normal((DENSE_B, DENSE_N, DENSE_N))
    a_np = (a_np + np.swapaxes(a_np, 1, 2)) / 2
    shape = a_np.shape
    print(f"[dense] plan_for{shape} picks {plan_for(shape)}; with k={K} "
          f"{plan_for(shape, k=K)}")
    full = SolverPlan(method="eei_dense")
    windowed = SolverPlan(method="eei_dense", spectrum="windowed")
    full_shape = (DENSE_B, DENSE_N, DENSE_N, DENSE_N - 1)
    win_shape = (DENSE_B, K, DENSE_N, DENSE_N - 1)
    out = {}
    for name in ("float64", "float32"):
        a = torch.as_tensor(a_np, dtype=getattr(torch, name), device=dev)
        runs = {
            "solve": lambda: SolverEngine(full).solve(a),
            "topk windowed": lambda: SolverEngine(windowed).topk(a, K),
            "topk full": lambda: SolverEngine(full).topk(a, K),
            "eigenvalues": lambda: SolverEngine(full).eigenvalues(a),
            "eigenvalues k": lambda: SolverEngine(full).eigenvalues(a, k=K),
        }
        calls, results, per_call = [], {}, {}
        undo = _capture(pd_ops, "logabs_sum_batched", calls)
        try:
            _reset_counts()
            for what, fn in runs.items():
                before = pd_kernel.logabs_sum.launches
                results[what] = fn()
                per_call[what] = pd_kernel.logabs_sum.launches - before
            torch.cuda.synchronize()
            counts = _read_counts()
        finally:
            undo()
        print(f"[dense] {name} {shape}, k={K}: kernel-2 launches per call "
              f"{per_call}; launches on the dense path {counts}")
        check(per_call == {"solve": 1, "topk windowed": 1, "topk full": 1,
                           "eigenvalues": 0, "eigenvalues k": 0},
              f"dense {name}: kernel-2 launches per call {per_call}")
        check(counts == {**{key: 0 for key in counts}, "logabs_sum": 3},
              f"dense {name}: the dense path launched {counts}")
        shapes = [tuple(c[0][0].shape) + tuple(c[0][1].shape[1:])
                  for c in calls]
        check(shapes == [full_shape, win_shape, full_shape],
              f"dense {name}: kernel-2 launch shapes {shapes}")
        errs, plain_ms = [], []
        for (lam, mu, floor), _, got in calls[:2]:
            plain, ms = _plain_ms(torch, lambda: pd_kernel.logabs_sum_plain(
                lam, mu, floor))
            errs.append(_max_err(torch, got, plain,
                                 *TOL[("prod_diff", name)],
                                 f"dense {name} kernel 2 {tuple(lam.shape)}"))
            plain_ms.append(ms)
        # The windowed launch's rows against the full table's, bitwise: on
        # the solve's own operands, and on the windowed program's where its
        # spectra are the solve's.
        (lam, mu, floor), _, table = calls[0]
        idx = torch.arange(DENSE_N - K, DENSE_N, device=dev)
        rows = pd_kernel.logabs_sum(lam[:, idx].contiguous(), mu, floor)
        check(torch.equal(rows, table[:, idx]),
              f"dense {name}: I = k rows != the full table's rows")
        (w_lam, w_mu, w_floor), _, w_rows = calls[1]
        same = (torch.equal(w_lam, lam[:, idx]) and torch.equal(w_mu, mu)
                and torch.equal(w_floor, floor))
        if same:
            check(torch.equal(w_rows, table[:, idx]),
                  f"dense {name}: the windowed program's launch != the "
                  f"solve's table rows")
        print(f"[dense] {name}: kernel 2 within tolerance of its plain "
              f"version at {full_shape} (max abs err {errs[0]:.3e}) and "
              f"{win_shape} ({errs[1]:.3e}); I = k rows bitwise the full "
              f"table's (the windowed program's own launch: "
              f"{'bitwise too' if same else 'its eigvalsh differed, not compared'})")
        _check_solve(torch, a, results["solve"], f"{name} dense")
        _check_topk(torch, a, results["topk windowed"], name,
                    "dense topk windowed")
        _check_topk(torch, a, results["topk full"], name, "dense topk full")
        _check_eigenvalues(torch, a, results["eigenvalues"], name,
                           "dense eigenvalues")
        _check_eigenvalues(torch, a, results["eigenvalues k"], name,
                           "dense eigenvalues k", k=K)
        if name == "float32":
            _minor_eigvalsh_precision(torch, a)
        runs[f"topk, plan_for's {plan_for(shape, k=K).method}"] = \
            lambda: SolverEngine(plan_for(shape, k=K)).topk(a, K)
        times = {what: _wall_ms(torch, fn) for what, fn in runs.items()}
        times["torch.linalg.eigh"] = _wall_ms(
            torch, lambda: torch.linalg.eigh(a))
        print(f"[dense] {name} {shape} wall ms (median of 3): " + ", ".join(
            f"{what} {ms:.3f}" for what, ms in times.items()))
        for what, plan, spec in (
                ("solve", full, ProgramSpec("solve")),
                ("topk windowed", windowed, ProgramSpec("topk", K, True))):
            print(f"[dense] {name} {what} by stage (ms): "
                  + _stage_split(torch, plan, spec, a))
        out[name] = dict(calls=calls[:2], errs=errs, plain_ms=plain_ms,
                         counts=counts, times=times)
    return out


def _minor_eigvalsh_precision(torch, a):
    """Why the cuda backend takes a float32 stack's dense spectra in
    float64: ``eigvalsh`` of its minors on the card in both dtypes, timed
    and held against LAPACK's float64 on the host."""
    from repro_torch.core import identity

    ref = identity.minor_spectra(a.double().cpu())
    for x in (a, a.double()):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mu = identity.minor_spectra(x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        err = float((mu.double().cpu() - ref).abs().max())
        print(f"[dense] torch.linalg.eigvalsh of the {tuple(mu.shape[:2])} "
              f"minors of the float32 stack, in {x.dtype} on the card: "
              f"{ms:.1f} ms, max abs error {err:.3e} against float64 "
              f"LAPACK on the host")


def _dense_records(torch, dense):
    """Kernel 2 at the dense shapes: the engine's own launches."""
    from repro_torch.kernels.prod_diff import kernel as pd_kernel

    records = []
    for name, dd in dense.items():
        for i, what in enumerate(("eei_dense", "eei_dense_windowed")):
            (lam, mu, floor), _, _ = dd["calls"][i]
            b, i_n = lam.shape
            j_n, k_n = mu.shape[1:]
            fn = lambda: pd_kernel.logabs_sum(lam, mu, floor)  # noqa: E731
            ms = _events_ms(torch, fn, warmup=3, reps=50)
            device_ms = _kernel_device_ms(torch, fn)
            nbytes = (b * i_n + b * j_n * k_n + b + b * i_n * j_n) \
                * lam.element_size()
            bound, by = _bound(b * i_n * j_n * k_n * PROD_DIFF_OPS_PER_TERM,
                               nbytes, name)
            records.append(_record(
                f"logabs_sum[{what} {b}x{i_n}x{j_n}x{k_n} {name}]",
                "prod_diff", launches=dd["counts"]["logabs_sum"],
                err=dd["errs"][i], ms=ms, plain_ms=dd["plain_ms"][i],
                bound_ms=bound, bound_by=by, library_ms=None,
                device_ms=device_ms, launches_per_call=1))
            _print_record(records[-1])
    return records


def _phase_krylov(torch, dev):
    """``eei_krylov`` and ``eei_krylov_si`` on the throughput lane's matrix:
    every kernel-1 launch captured and held bitwise against its plain
    version, the Lanczos steps of every call, the lane's accuracy gates."""
    import numpy as np

    from repro_torch import SolverEngine, SolverPlan, plan_for
    from repro_torch.engine.engine import ProgramSpec
    from repro_torch.kernels.sturm import kernel as st_kernel
    from repro_torch.kernels.sturm import ops as st_ops
    from repro_torch.linalg import lanczos

    n, k = KRYLOV_N, KRYLOV_K
    print(f"[krylov] plan_for((1, {n}, {n}), k={k}) picks "
          f"{plan_for((1, n, n), k=k)}")
    raw = np.random.default_rng(n + k).standard_normal((n, n))
    plans = {"eei_krylov": SolverPlan(method="eei_krylov"),
             "eei_krylov_si": SolverPlan(method="eei_krylov_si",
                                         krylov_m=KRYLOV_SI_M)}
    out = {}
    for name in ("float64", "float32"):
        x = raw.astype(np.float32) if name == "float32" else raw
        a = torch.as_tensor((x + x.T) / 2, device=dev)[None]  # (1, n, n)
        a64 = a[0].double()
        lam_ref = torch.linalg.eigvalsh(a64)
        span = float(lam_ref[-1] - lam_ref[0])
        top = float(lam_ref.abs().max())
        calls, steps, results, per_call = [], [], {}, {}
        undo_sturm = _capture(st_ops, "sturm_bisect", calls)
        undo_lanczos = _capture(lanczos, "lanczos_partial", steps)
        replayed = st_kernel.sturm_bisect.replayed
        try:
            _reset_counts()
            for method, plan in plans.items():
                eng = SolverEngine(plan)
                for kind in ("topk", "eigenvalues"):
                    c0, s0 = len(calls), len(steps)
                    r0 = st_kernel.sturm_bisect.replayed
                    results[(method, kind)] = (
                        eng.topk(a, k) if kind == "topk"
                        else eng.eigenvalues(a, k=k))
                    per_call[(method, kind)] = (
                        _graph_launches(calls[c0:],
                                        st_kernel.sturm_bisect.replayed - r0),
                        st_kernel.sturm_bisect.replayed - r0,
                        [int(r[2].steps[0]) for r in steps[s0:]])
            torch.cuda.synchronize()
            counts = _read_counts()
            replayed = st_kernel.sturm_bisect.replayed - replayed
            _settle(torch, calls)
        finally:
            undo_sturm()
            undo_lanczos()
        for (method, kind), (launched, by_graph, st) in per_call.items():
            print(f"[krylov] {name} {method} {kind}: {launched} kernel-1 "
                  f"launches ({by_graph} by graph replays), Lanczos steps "
                  f"{st}")
        print(f"[krylov] {name}: launches on the Krylov path {counts}")
        graphed = sum(isinstance(r, _GraphRecord) for r in calls)
        check(counts["sturm_bisect"] == _graph_launches(calls, replayed) > 0
              and (graphed > 0 or replayed == 0)
              and all(v == 0 for key, v in counts.items()
                      if key != "sturm_bisect"),
              f"krylov {name}: launches {counts} for {len(calls)} captured "
              f"({graphed} into graphs, which replayed {replayed} launches)")
        # Every launch bitwise its plain version; a launch identical to one
        # already checked (the eigenvalues program repeats its top-k's
        # reduce) is not run again.
        checked, plain_ms = [], {}
        for i, ((d, e, bounds), kw, got) in enumerate(calls):
            same = [j for j, (d2, e2, b2, kw2) in checked
                    if kw2 == kw and torch.equal(d, d2) and torch.equal(e, e2)
                    and torch.equal(bounds, b2)]
            if same:
                check(torch.equal(got, calls[same[0]][2]),
                      f"krylov {name}: launch {i} differs from launch "
                      f"{same[0]} on the same operands")
                continue
            plain, ms = _plain_ms(torch, lambda: st_kernel.sturm_bisect_plain(
                d, e, bounds, **kw))
            check(torch.equal(got, plain), f"krylov {name}: kernel-1 launch "
                  f"{i} ({tuple(d.shape)}, {kw}) != its plain version")
            checked.append((i, (d, e, bounds, kw)))
            plain_ms[i] = ms
        print(f"[krylov] {name}: all {len(calls)} kernel-1 launches bitwise "
              f"their plain version ({len(checked)} distinct)")
        worst = {}
        for (method, kind), res in results.items():
            lam = (res.eigenvalues if kind == "topk" else res)[0].double()
            rel = float((lam - lam_ref[-k:]).abs().max()) / span
            check(rel <= KRYLOV_TOL, f"krylov {name} {method} {kind}: "
                  f"eigenvalue error {rel:.3e} of the span > {KRYLOV_TOL:g}")
            res_rel, said = None, ""
            if kind == "topk":
                v = res.vectors[0].double()
                res_rel = float((a64 @ v.T - v.T * lam).norm(dim=0).max()) \
                    / top
                check(res_rel <= KRYLOV_TOL, f"krylov {name} {method}: "
                      f"residual {res_rel:.3e} of max|lambda| > "
                      f"{KRYLOV_TOL:g}")
                said = f", residual {res_rel:.3e} of max|lambda|"
            worst[(method, kind)] = (rel, res_rel)
            print(f"[krylov] {name} {method} {kind}: eigenvalue error "
                  f"{rel:.3e} of the span{said} (limit {KRYLOV_TOL:g})")
        times = {m: _wall_ms(torch, lambda e_=SolverEngine(p): e_.topk(a, k))
                 for m, p in plans.items()}
        picked = plan_for(tuple(a.shape), k=k)
        times[f"topk, plan_for's {picked.method}"] = _wall_ms(
            torch, lambda: SolverEngine(picked).topk(a, k))
        times["torch.linalg.eigh"] = _wall_ms(
            torch, lambda: torch.linalg.eigh(a))
        if name == "float32":
            times.update(_householder_leg(torch, a, k))
        print(f"[krylov] {name} (1, {n}, {n}), k={k}, wall ms: " + ", ".join(
            f"{what} {ms:.3f}" for what, ms in times.items()))
        for method, plan in plans.items():
            print(f"[krylov] {name} {method} topk by stage (ms): "
                  + _stage_split(torch, plan, ProgramSpec("topk", k, True), a))
        # The window on the band of eei_krylov's top-k: its last launch.
        c0 = per_call[("eei_krylov", "topk")][0]
        window = calls[c0 - 1]
        out[name] = dict(window=window, plain_ms=plain_ms.get(c0 - 1),
                         counts=counts, times=times, worst=worst,
                         steps=per_call)
    return out


def _householder_leg(torch, a, k):
    """The windowed Householder chain, the lane's dense leg, once: at the
    matrix's own n, or at n = 1024 when that call took longer than
    DENSE_LEG_LIMIT_S."""
    from repro_torch import SolverEngine, SolverPlan

    eng = SolverEngine(SolverPlan(method="eei_tridiag", spectrum="windowed"))
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.topk(a, k)
    torch.cuda.synchronize()
    s = time.perf_counter() - t
    n = a.shape[-1]
    if s <= DENSE_LEG_LIMIT_S:
        return {f"windowed Householder chain, n={n}, once": s * 1e3}
    small = a[:, :1024, :1024].contiguous()
    ms = _wall_ms(torch, lambda: eng.topk(small, k), reps=1)
    return {f"windowed Householder chain, n={n}, once (over the limit)":
            s * 1e3, "windowed Householder chain, n=1024": ms}


def _krylov_records(torch, krylov):
    """Kernel 1's window on the Krylov band: the engine's own launch."""
    from repro_torch.kernels.sturm import kernel as st_kernel
    from repro_torch.linalg.householder import tridiagonal_matrix

    records = []
    for name, kd in krylov.items():
        (d, e, bounds), kw, got = kd["window"]
        rows, m = d.shape
        lanes = kw["m"]
        fn = lambda: st_kernel.sturm_bisect(d, e, bounds, **kw)  # noqa: E731
        ms = _events_ms(torch, fn, warmup=5, reps=100)
        device_ms = _kernel_device_ms(torch, fn)
        plain_ms = kd["plain_ms"]
        if plain_ms is None:
            _, plain_ms = _plain_ms(torch, lambda: st_kernel.sturm_bisect_plain(
                d, e, bounds, **kw))
        bound, by = _sturm_cost(rows, m, lanes, kw["n_iter"],
                                d.element_size(), name)
        dense = tridiagonal_matrix(d, e)
        lib_ms = _events_ms(torch, lambda: torch.linalg.eigvalsh(dense),
                            warmup=2, reps=20)
        records.append(_record(
            f"sturm_bisect[krylov window {rows}x{m}, k={lanes} {name}]",
            "sturm", launches=kd["counts"]["sturm_bisect"], err=0.0, ms=ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=lib_ms, device_ms=device_ms))
        _print_record(records[-1])
    return records


def _phase_calibration(torch):
    """``calibrate(smoke=True)`` on the card, every field checked; and the
    committed table's fields.  Nothing is written."""
    from repro_torch.engine import autotune

    t = time.perf_counter()
    table = autotune.calibrate(smoke=True)
    seconds = time.perf_counter() - t
    d = table.to_dict()
    print(f"[calibration] smoke sweep on the card in {seconds:.1f} s: "
          f"{json.dumps(d)}")
    sizes = (7, 8, 16, 32)
    check(table.backend == "cuda" and "-cuda-" in table.host,
          f"calibration: backend {table.backend!r}, host {table.host!r}")
    for key in ("eigh_crossover_n", "dense_crossover_n",
                "cuda_eigh_crossover_n", "cuda_dense_crossover_n"):
        check(d[key] in sizes, f"calibration: {key} = {d[key]}")
    check(0.0 <= table.windowed_k_frac <= 1.0,
          f"calibration: windowed_k_frac = {table.windowed_k_frac}")
    check(table.krylov_n_min in (64, 128, autotune.KRYLOV_NEVER),
          f"calibration: krylov_n_min = {table.krylov_n_min}")
    check(table.pack_n_max in (0, 8, 16) and
          table.packed_eigh_n_max in (16, 32, 64),
          f"calibration: pack_n_max = {table.pack_n_max}, "
          f"packed_eigh_n_max = {table.packed_eigh_n_max}")
    committed = autotune.load_table(autotune.REPO_DEFAULT_PATH)
    print(f"[calibration] committed default "
          f"({autotune.REPO_DEFAULT_PATH.name}): "
          f"{json.dumps(committed.to_dict())}")
    active = autotune.get_table()
    check(active is not None and active.source == "repo-default",
          f"calibration: the planner reads {active}")


# -- the serving runtime -------------------------------------------------------


class _LogRecords:
    """The records of level INFO and above that one logger emits while
    attached (``with``)."""

    def __init__(self, name):
        import logging

        self.records = []
        self._logger = logging.getLogger(name)
        self._handler = logging.Handler()
        self._handler.emit = self.records.append
        self._level = None

    def __enter__(self):
        import logging

        self._level = self._logger.level
        if not self._logger.isEnabledFor(logging.INFO):
            self._logger.setLevel(logging.INFO)
        self._logger.addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self._handler)
        self._logger.setLevel(self._level)


def _check_faults(tag, records, causes=()):
    """Every retry, bisection and degraded result that the server logged in
    one stream had one of ``causes`` (exception types) as its cause, and the
    server logged no other warning or error.  A kernel that failed to build
    or launch, a device error at a copy, or a crashed thread thus fails the
    run even where the fallback chain served the requests.  Returns the
    count of each kind of event by the cause's type name."""
    import logging

    from repro_torch.runtime.chaos import ChaosError

    events = {}
    for r in records:
        if r.msg.startswith("EEI dispatch retry"):
            kind, exc = "retry", r.args[2]
        elif r.msg.startswith("EEI stack of"):
            kind, exc = "split", r.args[1]
        elif r.msg.startswith("EEI request") and "degraded" in r.msg:
            kind, exc = "degraded", r.args[3]
        elif r.msg.endswith("thread: injected crash; restarting"):
            kind, exc = "restart", ChaosError(r.msg)
        elif r.levelno >= logging.WARNING:
            kind, exc = "other", None
        else:
            continue
        check(isinstance(exc, tuple(causes)),
              f"{tag}: the server logged {r.getMessage()!r}")
        key = (kind, type(exc).__name__)
        events[key] = events.get(key, 0) + 1
    return events


def _arm_server_capture():
    """Capture every launch of kernels 1, 2 and 3 by the names their callers
    look them up under, and count every call of their plain versions.
    Returns ``(calls, plain, undo)``."""
    from repro_torch.kernels.prod_diff import kernel as pd_kernel
    from repro_torch.kernels.prod_diff import ops as pd_ops
    from repro_torch.kernels.sturm import kernel as st_kernel
    from repro_torch.kernels.sturm import ops as st_ops

    calls = {"sturm_bisect": [], "sturm_segmented": [], "logabs_sum": []}
    plain = dict.fromkeys(calls, 0)
    undo = [_capture(st_ops, "sturm_bisect", calls["sturm_bisect"]),
            _capture(st_ops, "sturm_segmented", calls["sturm_segmented"]),
            _capture(pd_ops, "logabs_sum_batched", calls["logabs_sum"])]
    for module, attr, key in (
            (st_kernel, "sturm_bisect_plain", "sturm_bisect"),
            (st_kernel, "sturm_segmented_plain", "sturm_segmented"),
            (pd_kernel, "logabs_sum_plain", "logabs_sum")):
        fn = getattr(module, attr)

        def counting(*args, _fn=fn, _key=key, **kwargs):
            plain[_key] += 1
            return _fn(*args, **kwargs)

        setattr(module, attr, counting)
        undo.append(lambda m=module, a=attr, f=fn: setattr(m, a, f))
    return calls, plain, lambda: [u() for u in reversed(undo)]


def _same(torch, x, y) -> bool:
    """Bitwise-equal tensors (same shape and dtype), or equal values."""
    if torch.is_tensor(x) or torch.is_tensor(y):
        return (torch.is_tensor(x) and torch.is_tensor(y)
                and x.shape == y.shape and x.dtype == y.dtype
                and torch.equal(x, y))
    return x == y


def _serve_stream(server, stream, threaded):
    """Submit ``stream``, drain (caller-driven: ``flush``; threaded: the
    linger thread alone), close; every wait bounded.  Returns the futures,
    their results and the wall seconds from the first submit to the last
    result."""
    t0 = time.perf_counter()
    futs = [server.submit(a, k) for a, k in stream]
    if not threaded:
        server.flush()
    results = [f.result(timeout=SERVE_WAIT_S) for f in futs]
    wall = time.perf_counter() - t0
    stranded = server.close(timeout=SERVE_WAIT_S)
    check(not stranded, f"server: {len(stranded)} futures left unresolved")
    return futs, results, wall


def _sync_loop_s(torch, dev, stream, plans):
    """``launch/serve.py``'s ``--sync`` loop (warm-up of each (n, k), then
    one ``engine.topk`` and its copy to the host a request), but with each
    request under ``plans[i]`` instead of one plan for the stream.  Returns
    the loop's wall seconds."""
    from repro_torch.engine import SolverEngine

    engines = {}

    def solve(a, k, plan):
        if plan not in engines:
            engines[plan] = SolverEngine(plan, dev)
        res = engines[plan].topk(torch.as_tensor(a, device=dev), k)
        return res.eigenvalues.cpu().numpy(), res.vectors.cpu().numpy()

    seen = {}
    for (a, k), plan in zip(stream, plans):
        seen.setdefault((a.shape[0], k, plan), a)
    for (_, k, plan), a in seen.items():
        solve(a, k, plan)
    t0 = time.perf_counter()
    for (a, k), plan in zip(stream, plans):
        solve(a, k, plan)
    return time.perf_counter() - t0


def _check_requests(torch, dev, stream, results, what):
    """Each float32 request against float64 ``torch.linalg.eigh`` of its
    matrix at the smoke's float32 gates: eigenvalues within 2e-4 of
    ||A||_2, residuals within 2e-3 of ||A||_F.  Returns the worst pair."""
    import numpy as np

    worst_lam = worst_res = 0.0
    for n in sorted({a.shape[0] for a, _ in stream}):
        idx = [i for i, (a, _) in enumerate(stream) if a.shape[0] == n]
        a = torch.as_tensor(np.stack([stream[i][0] for i in idx]),
                            dtype=torch.float64, device=dev)
        w = torch.linalg.eigvalsh(a)
        for j, i in enumerate(idx):
            k = stream[i][1]
            lam = torch.as_tensor(np.asarray(results[i].eigenvalues),
                                  dtype=torch.float64, device=dev)
            vec = torch.as_tensor(np.asarray(results[i].vectors),
                                  dtype=torch.float64, device=dev)
            check(tuple(lam.shape) == (k,) and tuple(vec.shape) == (k, n)
                  and bool(torch.isfinite(vec).all()),
                  f"{what} request {i}: shapes {tuple(lam.shape)}, "
                  f"{tuple(vec.shape)} or non-finite vectors")
            err = float((lam - w[j, -k:]).abs().max() / w[j].abs().max())
            res = float((a[j] @ vec.T - vec.T * lam).norm(dim=0).max()
                        / a[j].norm())
            check(err <= 2e-4 and res <= 2e-3,
                  f"{what} request {i} (n={n}, k={k}): eigenvalue error "
                  f"{err:.3e} of ||A||_2 (limit 2e-4), residual {res:.3e} "
                  f"of ||A||_F (limit 2e-3)")
            worst_lam, worst_res = max(worst_lam, err), max(worst_res, res)
    return worst_lam, worst_res


def _server_line(tag, stats, wall, requests):
    print(f"[server] {tag}: {requests} requests in {wall:.3f} s, "
          f"{requests / wall:.2f} requests/s; p50 "
          f"{stats['p50_latency_ms']:.1f} ms, p99 "
          f"{stats['p99_latency_ms']:.1f} ms; {stats['stacks_dispatched']} "
          f"stacks ({stats['packed_stacks_dispatched']} packed), "
          f"{stats['program_compiles']} program builds over "
          f"{stats['distinct_buckets']} buckets; pad waste "
          f"{stats['pad_waste_frac']:.4f}; verify failed "
          f"{stats['verify_failed']}, degraded {stats['requests_degraded']} "
          f"{stats['fallbacks_by_plan']}, failed {stats['requests_failed']}")


def _phase_server(torch, dev, stack, kernels):
    """The serving runtime (``EeiServer``, ``launch/serve.py``) on the card:
    five streams (the chaos one twice), each through the entry points a
    user calls, with the launch counts set to 0 just before and read just
    after each; every launch of kernels 1, 2 and 3 in streams 1-3 and 5
    held against its plain version afterwards; no plain version may run on
    the path, and no retry, bisection or fallback may happen in a stream
    but for the causes that stream allows.  Returns each wrapper's launches
    by stream and the record of kernel 3 at the packed stream's shape."""
    import numpy as np

    from repro_torch.engine import (EeiServer, SolverPlan, plan_for,
                                    topk_program, verify_topk_host)
    from repro_torch.engine.server import VerifyFailed, make_eei_stream
    from repro_torch.launch import serve as serve_cli
    from repro_torch.runtime import ChaosConfig, ChaosMonkey
    from repro_torch.runtime.chaos import ChaosError, ChaosFailure

    t_phase = time.perf_counter()
    mixed = make_eei_stream(*SERVE_MIXED, seed=0, mixed=True)
    packed_stream = make_eei_stream(*SERVE_PACKED, seed=1, mixed=True)
    a_main = stack.cpu().numpy()  # the main path's 16 requests of n = 600
    main_stream = [(a_main[i], K) for i in range(B)]
    rng = np.random.default_rng(SEED + 16)
    fro = float(np.linalg.norm(a_main[0]))
    updates = [rng.standard_normal(N) * np.sqrt(0.01 * fro / N)
               for _ in range(SERVE_SESSION_UPDATES)]

    calls, plain, undo = _arm_server_capture()
    streams, launches, logs = {}, {}, {}

    def counted(tag, fn):
        """Run one stream counted (``_run_counted``); its captured launches
        are ``streams[tag]``, its counts ``launches[tag]``, the server's log
        records ``logs[tag]``."""
        out, counts, got, records = _run_counted(
            torch, "server", tag, fn, calls, plain)
        streams[tag] = dict(calls=got, counts=counts)
        launches[tag] = counts
        logs[tag] = records["repro_torch.engine.server"]
        return out

    def clean(tag, stats, requests):
        """Every request served from a stack that retired whole: no retry,
        bisection, verify miss or fallback."""
        check(stats["requests_completed"] == requests
              and stats["requests_failed"] == stats["requests_degraded"]
              == stats["verify_failed"] == stats["retries"]
              == stats["stack_splits"] == 0
              and stats["fallbacks_by_plan"] == {}, f"{tag}: {stats}")
        _check_faults(tag, logs[tag])

    try:
        # 1. Per-bucket planning under the committed table, caller-driven
        # then threaded.
        for mode, linger in (("caller-driven", None),
                             ("threaded", SERVE_LINGER_MS)):
            tag = f"stream 1 {mode}"
            server = EeiServer(None, max_batch=SERVE_BATCH, verify=True,
                               linger_ms=linger, record_dispatches=True)
            check(server.device.type == dev.type, f"{tag}: {server.device}")
            futs, results, wall = counted(tag, lambda: _serve_stream(
                server, mixed, linger is not None))
            stats = server.stats()
            clean(tag, stats, len(mixed))
            picks, plan_of = {}, {}
            for rec in server.dispatch_log:
                b = rec.bucket
                check(rec.plan == plan_for((b.b, b.n, b.n), k=b.k)
                      and rec.plan.backend == "cuda"
                      and rec.plan.method == SERVE_PICKS.get(b.n),
                      f"{tag}: bucket {b} ran {rec.plan}; the committed "
                      f"table picks {SERVE_PICKS}")
                picks[(b.n, b.k)] = f"{rec.plan.method}/{rec.plan.spectrum}"
                plan_of.update((id(req.future), rec.plan)
                               for req in rec.requests)
            check({n for n, _ in picks} == set(SERVE_PICKS)
                  and all(id(f) in plan_of for f in futs),
                  f"{tag}: buckets {sorted(picks)}, or a request served "
                  f"from no dispatched stack")
            print(f"[server] {tag} picks by (n, k) bucket: " + ", ".join(
                f"n={n} k={k} {pick}" for (n, k), pick in sorted(
                    picks.items())))
            err, res = _check_requests(torch, dev, mixed, results, tag)
            _server_line(tag, stats, wall, len(mixed))
            if linger is not None:
                single = dict(wall=wall, p50=stats["p50_latency_ms"],
                              p99=stats["p99_latency_ms"],
                              stacks=stats["stacks_dispatched"])
            print(f"[server] {tag}: every request within the float32 gates "
                  f"of float64 eigh (worst eigenvalue error {err:.3e} of "
                  f"||A||_2, residual {res:.3e} of ||A||_F)")
            check(streams[tag]["counts"]["sturm_bisect"] > 0
                  and streams[tag]["counts"]["logabs_sum"] > 0,
                  f"{tag}: kernels 1 and 2 not both launched")
            if linger is None:
                bucket_plans = [plan_of[id(f)] for f in futs]
        with _LogRecords("repro_torch.serve") as log:
            serve_cli.main(["--eei", "--sync", "--mixed", "--requests",
                            str(SERVE_MIXED[0]), "--n", str(SERVE_MIXED[1]),
                            "--k", str(SERVE_MIXED[2]), "--batch",
                            str(SERVE_BATCH), "--seed", "0"])
        served = [r.args for r in log.records
                  if r.msg.startswith("sync loop served")]
        check(len(served) == 1, f"sync loop: {len(served)} summary lines")
        count, seconds = served[0][:2]
        print(f"[server] stream 1 --sync loop (launch/serve.py, plan "
              f"{plan_for((SERVE_BATCH, SERVE_MIXED[1], SERVE_MIXED[1]), k=SERVE_MIXED[2])}"
              f"): {count} requests in {seconds:.3f} s, "
              f"{count / seconds:.2f} requests/s")
        seconds = _sync_loop_s(torch, dev, mixed, bucket_plans)
        print(f"[server] stream 1 sync loop under the server's bucket plans "
              f"(each request alone, under the plan of the stack it rode "
              f"in the caller-driven run): {len(mixed)} requests in "
              f"{seconds:.3f} s, {len(mixed) / seconds:.2f} requests/s")

        # 2. The main path: 16 requests of n = 600, float64, plan named.
        tag = "stream 2 main path"
        server = EeiServer(SolverPlan(method="eei_tridiag"),
                           dtype=torch.float64, max_batch=B, verify=True,
                           record_dispatches=True)
        _, results, wall = counted(tag, lambda: _serve_stream(
            server, main_stream, False))
        stats = server.stats()
        _server_line(tag, stats, wall, B)
        clean(tag, stats, B)
        check(stats["stacks_dispatched"] == 1
              and streams[tag]["counts"]["sturm_bisect"] == 2
              and streams[tag]["counts"]["logabs_sum"] == 1,
              f"{tag}: {stats}, launches {streams[tag]['counts']}")
    finally:
        undo()
    # The served results bitwise topk_program(plan, 8, True, verify=True)
    # on the recorded stack (outside the counted run).
    rec = server.dispatch_log[0]
    ref, flags = topk_program(rec.plan, rec.bucket.k, rec.bucket.largest,
                              verify=True)(torch.tensor(rec.stack, device=dev))
    check(bool(flags.ok.all()), f"{tag}: the program's verify flags")
    for row, req in enumerate(rec.requests):
        got = req.future.result(timeout=0)
        check(np.array_equal(got.eigenvalues,
                             ref.eigenvalues[row, -req.k:].cpu().numpy())
              and np.array_equal(got.vectors,
                                 ref.vectors[row, -req.k:].cpu().numpy()),
              f"{tag}: request {row} differs from topk_program's row")
    _check_topk(torch, stack, (
        torch.as_tensor(np.stack([r.eigenvalues for r in results]),
                        device=dev),
        torch.as_tensor(np.stack([r.vectors for r in results]), device=dev)),
        "float64", "server main path")
    print(f"[server] {tag}: every request bitwise topk_program({rec.plan}, "
          f"{rec.bucket.k}, True, verify=True) on the recorded "
          f"{rec.bucket} stack")

    def degraded_ok(tag, stream, results, stats):
        """Every degraded result verifies on the host and came from a link
        of the chain on the card, not from the host's eigh oracle."""
        degraded = [(a, r) for (a, _), r in zip(stream, results)
                    if r.degraded]
        for a, r in degraded:
            check(bool(verify_topk_host(a, r.eigenvalues, r.vectors).ok),
                  f"{tag}: a degraded result ({r.fallback}) fails verify")
        check(len(degraded) == stats["requests_degraded"]
              and "eigh_oracle" not in stats["fallbacks_by_plan"],
              f"{tag}: {len(degraded)} degraded results, {stats}")
        return len(degraded)

    calls, plain, undo = _arm_server_capture()
    try:
        # 3. Packed: pack="always" at rows of 512.
        tag = "stream 3 packed"
        server = EeiServer(None, max_batch=SERVE_BATCH, pack="always",
                           pack_row_n=SERVE_PACK_ROW_N, verify=True,
                           record_dispatches=True)
        plan = server._packed_plan()
        print(f"[server] {tag}: packed_plan_for({SERVE_PACK_ROW_N}) is "
              f"{plan}")
        check(plan.method == "eei_tridiag" and plan.backend == "cuda",
              f"{tag}: the packed plan {plan}")
        _, results, wall = counted(tag, lambda: _serve_stream(
            server, packed_stream, False))
        stats = server.stats()
        _server_line(tag, stats, wall, len(packed_stream))
        # Only a slot's verify miss may send a request down the chain.
        _check_faults(tag, logs[tag], (VerifyFailed,))
        check(stats["requests_failed"] == stats["retries"]
              == stats["stack_splits"] == 0
              and stats["verify_failed"] == stats["requests_degraded"]
              == sum(stats["fallbacks_by_plan"].values())
              and stats["packed_stacks_dispatched"]
              == stats["stacks_dispatched"]
              == streams[tag]["counts"]["sturm_segmented"] > 0,
              f"{tag}: {stats}, launches {streams[tag]['counts']}")
        degraded_ok(tag, packed_stream, results, stats)
        worst = 0.0
        for i, ((a, k), res) in enumerate(zip(packed_stream, results)):
            w = np.linalg.eigvalsh(a.astype(np.float64))[-k:]
            err = float(np.abs(res.eigenvalues - w).max()
                        / max(1.0, float(np.abs(w).max())))
            check(err <= PACK_TOL and np.all(np.isfinite(res.vectors)),
                  f"{tag} request {i}: eigenvalue error {err:.3e} of "
                  f"max(1, |lambda|max) > {PACK_TOL:g}")
            worst = max(worst, err)
        print(f"[server] {tag}: {stats['packed_requests_completed']} "
              f"requests from packed slots, {stats['verify_failed']} slots "
              f"missed verify and went down the fallback chain "
              f"{stats['fallbacks_by_plan']}; every request within "
              f"{PACK_TOL:g} of max(1, |lambda|max) (worst {worst:.3e})")

        # 4. Chaos: stream 1, threaded, faults at 5% a point; then
        # caller-driven with launch and NaN faults only, no retries, from a
        # seed whose schedule sends requests down the chain from both.
        for tag, threaded, config, kwargs in (
                ("stream 4 chaos", True,
                 ChaosConfig(seed=0, rate=SERVE_CHAOS_RATE),
                 dict(linger_ms=SERVE_LINGER_MS)),
                ("stream 4 forced faults", False,
                 ChaosConfig(rate=0.0, **SERVE_FORCED_FAULTS),
                 dict(max_retries=0))):
            server = EeiServer(None, max_batch=SERVE_BATCH, verify=True,
                               chaos=ChaosMonkey(config), **kwargs)
            _, results, wall = counted(tag, lambda: _serve_stream(
                server, mixed, threaded))
            stats = server.stats()
            _server_line(tag, stats, wall, len(mixed))
            # A NaN row escalates as a verify miss; nothing else may.
            events = _check_faults(tag, logs[tag],
                                   (ChaosFailure, ChaosError, VerifyFailed))
            check(stats["requests_failed"] == 0
                  and stats["requests_completed"] == len(mixed)
                  and stats["verify_failed"]
                  <= stats["chaos_injected"]["nan"],
                  f"{tag}: {stats}")
            n_degraded = degraded_ok(tag, mixed, results, stats)
            if not threaded:
                by_launch = events.get(("degraded", "ChaosFailure"), 0)
                check(by_launch > 0 and stats["verify_failed"] > 0
                      and stats["stack_splits"] > 0
                      and by_launch + stats["verify_failed"] == n_degraded,
                      f"{tag}: the schedule reached the chain from launch "
                      f"faults {by_launch} and NaN rows "
                      f"{stats['verify_failed']} times: {stats}")
            err, res = _check_requests(torch, dev, mixed, results, tag)
            print(f"[server] {tag}: injected {stats['chaos_injected']}; "
                  f"retries {stats['retries']}, stack splits "
                  f"{stats['stack_splits']}, verify failed "
                  f"{stats['verify_failed']}, fallbacks "
                  f"{stats['fallbacks_by_plan']}; causes logged "
                  f"{ {f'{k} {c}': v for (k, c), v in events.items()} }; "
                  f"{n_degraded} degraded results, each verified; every "
                  f"request within the float32 gates (worst {err:.3e} / "
                  f"{res:.3e})")
            del streams[tag]  # its launches are not held against plain ones

        # 5. A session through the server on the main path's first matrix.
        tag = "stream 5 session"
        server = EeiServer(None, verify=True)
        print(f"[server] {tag}: plan {server._session_plan(N, K)}")

        def session_stream():
            sid = server.open_session(a_main[0], K)
            a_now = a_main[0].copy()
            out = []
            for u in updates:
                a_now = a_now + np.outer(u, u)
                out.append((a_now, server.submit_update(sid, u).result(
                    timeout=SERVE_WAIT_S)))
            return out

        steps = counted(tag, session_stream)
        server.close(timeout=SERVE_WAIT_S)
        _check_faults(tag, logs[tag])
        span0 = None
        worst = 0.0
        for i, (a_now, res) in enumerate(steps):
            w = np.linalg.eigvalsh(a_now)
            span0 = span0 or float(w[-1] - w[0])
            rel = float(np.abs(np.asarray(res.eigenvalues, np.float64)
                               - w[-K:]).max()) / span0
            check(rel <= SESSION_TOL and bool(verify_topk_host(
                a_now, res.eigenvalues, res.vectors).ok),
                f"{tag} update {i}: eigenvalue error {rel:.3e} of the span "
                f"(limit {SESSION_TOL:g}) or verify failed")
            worst = max(worst, rel)
        stats = server.stats()
        print(f"[server] {tag}: {stats['session_updates']} updates "
              f"({stats['session_fast_updates']} fast, "
              f"{stats['session_full_resolves']} full re-solves, "
              f"{stats['session_degraded']} degraded); worst eigenvalue "
              f"error {worst:.3e} of the span (limit {SESSION_TOL:g})")
        check(stats["session_degraded"] == stats["requests_failed"] == 0
              and stats["session_updates"] == stats["session_fast_updates"]
              == SERVE_SESSION_UPDATES
              and streams[tag]["counts"]["sturm_segmented"]
              >= SERVE_SESSION_UPDATES,
              f"{tag}: launches {streams[tag]['counts']}, {stats}")
    finally:
        undo()
    serve_s = time.perf_counter() - t_phase

    known = _known_launches(kernels)
    firsts = _hold_against_plain(torch, "server", streams, known)
    print(f"[timing] the server phase took {serve_s:.1f} s to serve, "
          f"{time.perf_counter() - t_phase:.1f} s with its checks")
    by_wrapper = {key: {tag: counts[key] for tag, counts in launches.items()}
                  for key in _PLAINS}
    record = _server_segmented_record(
        torch, firsts[("stream 3 packed", "sturm_segmented")],
        launches["stream 3 packed"]["sturm_segmented"])
    record["server_launches"] = by_wrapper["sturm_segmented"]
    _print_record(record)
    return dict(launches=by_wrapper, record=record, known=known,
                single=single)


#: Each captured wrapper -> its plain version in the kernel module.
_PLAINS = {"sturm_bisect": "sturm_bisect_plain",
           "sturm_segmented": "sturm_segmented_plain",
           "logabs_sum": "logabs_sum_plain"}


def _run_counted(torch, prefix, tag, fn, calls, plain,
                 loggers=("repro_torch.engine.server",)):
    """Run one stream with every launch count at 0 just before and read just
    after, the records of ``loggers`` captured.  Fails if a plain version
    ran, if a wrapper's count and its captured launches disagree, or if a
    masked or single-matrix prod-diff kernel launched.  Returns ``(fn's
    output, the counts, the captured launches by wrapper, the log records
    by logger)``."""
    from contextlib import ExitStack

    from repro_torch.kernels.sturm import kernel as st_kernel

    start = {key: len(c) for key, c in calls.items()}
    replayed = st_kernel.sturm_bisect.replayed
    _reset_counts()
    for key in plain:
        plain[key] = 0
    t = time.perf_counter()
    with ExitStack() as stack:
        records = {name: stack.enter_context(_LogRecords(name)).records
                   for name in loggers}
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = _read_counts()
    check(not any(plain.values()), f"{prefix} {tag}: plain versions ran "
          f"on the card's path: {plain}")
    replayed = st_kernel.sturm_bisect.replayed - replayed
    for key, c in calls.items():
        _settle(torch, c, start[key])
    got = {key: c[start[key]:] for key, c in calls.items()}
    for key, launched in got.items():
        by_graph = replayed if key == "sturm_bisect" else 0
        check(_graph_launches(launched, by_graph) == counts[key],
              f"{prefix} {tag}: {key} launched {counts[key]} times, "
              f"{len(launched)} captured ({by_graph} by graph replays)")
    check(counts["logabs_sum_masked"] == counts["logabs_sum_single"] == 0
          and all(c[1].get("mask") is None for c in got["logabs_sum"]),
          f"{prefix} {tag}: launches {counts}")
    print(f"[{prefix}] {tag}: launches {counts} in {wall:.3f} s")
    return out, counts, got, records


def _known_launches(kernels):
    """Phase 2's float64 spectrum and minor-band launches of kernel 1 with
    their checked results: ``{wrapper: [(args, kwargs, result, plain ms)]}``,
    the table ``_hold_against_plain`` grows."""
    kd = kernels["float64"]
    return {"sturm_bisect": [
        ((kd["d"], kd["e"], kd["bnd"]), dict(target_base=0, m=N,
                                             n_iter=kd["iters"]),
         kd["lam"], kd["plain_ms"]["spectrum"]),
        ((kd["dm"], kd["em"], kd["mbnd"]), dict(target_base=0, m=N - 1,
                                                n_iter=kd["iters"]),
         kd["mu"].reshape(B * N, N - 1), kd["plain_ms"]["minor"])],
        "sturm_segmented": [], "logabs_sum": []}


def _hold_against_plain(torch, prefix, streams, known):
    """Every captured launch of ``streams`` (``{tag: {"calls": {wrapper:
    [(args, kwargs, result)]}}}``) against its plain version: kernels 1
    and 3 bitwise, kernel 2 within its tolerance (as in phase 2).  A launch
    on operands already checked (in ``known``, which grows) is held against
    that checked result instead.  Returns the first launch of each (tag,
    wrapper) as ``(args, kwargs, plain ms)``."""
    from repro_torch.kernels.prod_diff import kernel as pd_kernel
    from repro_torch.kernels.sturm import kernel as st_kernel

    t_check = time.perf_counter()
    summary, firsts = {}, {}
    for tag, sd in streams.items():
        for key, launched in sd["calls"].items():
            module = pd_kernel if key == "logabs_sum" else st_kernel
            n_plain = n_known = 0
            for args, kwargs, got in launched:
                kwargs = {k: v for k, v in kwargs.items() if k != "mask"}
                same = [entry for entry in known[key]
                        if entry[1].keys() == kwargs.keys()
                        and all(_same(torch, v, entry[1][x])
                                for x, v in kwargs.items())
                        and all(_same(torch, x, y)
                                for x, y in zip(args, entry[0]))]
                if same:
                    ref, ms = same[0][2], same[0][3]
                    n_known += 1
                else:
                    fn = getattr(module, _PLAINS[key])
                    ref, ms = _plain_ms(torch, lambda: fn(*args, **kwargs))
                    known[key].append((args, kwargs, ref, ms))
                    n_plain += 1
                if key == "logabs_sum":
                    _max_err(torch, got, ref, *TOL[(
                        "prod_diff", str(got.dtype)[6:])],
                        f"{prefix} {tag} kernel 2 {tuple(got.shape)}")
                else:
                    check(torch.equal(got, ref), f"{prefix} {tag}: {key} "
                          f"launch on {tuple(args[0].shape)} {kwargs.keys()} "
                          f"!= its plain version")
                firsts.setdefault((tag, key), (args, kwargs, ms))
            summary[(tag, key)] = (len(launched), n_plain, n_known)
    print(f"[{prefix}] launches held against their plain versions in "
          f"{time.perf_counter() - t_check:.1f} s (kernels 1 and 3 "
          f"bitwise, kernel 2 within its tolerance): " + "; ".join(
              f"{tag} {key} {n} ({p} plain runs, {k} on checked operands)"
              for (tag, key), (n, p, k) in summary.items() if n))
    return firsts


def _hold_grouped(torch, prefix, streams, known):
    """``_hold_against_plain`` for many launches on new operands: each
    captured launch of ``streams`` is held against its plain version
    (kernels 1 and 3 bitwise, kernel 2 within its tolerance).  A launch on
    operands already checked (in ``known``, or of an earlier launch here)
    is held against that result; the plain version runs once for all other
    launches that share a wrapper, a row shape and their other arguments,
    on their rows stacked.  Every plain version is elementwise over rows,
    so each launch's rows of that run are its own plain result."""
    from repro_torch.kernels.prod_diff import kernel as pd_kernel
    from repro_torch.kernels.sturm import kernel as st_kernel

    t_check = time.perf_counter()

    def operands(args, kwargs):
        names = tuple(sorted(kwargs))
        return names, list(args) + [kwargs[k] for k in names]

    def same(a, b):
        return (a[0] == b[0] and len(a[1]) == len(b[1])
                and all(_same(torch, x, y) for x, y in zip(a[1], b[1])))

    launches, uniques = [], {key: [] for key in _PLAINS}
    for tag, sd in streams.items():
        for key, launched in sd["calls"].items():
            for args, kwargs, got in launched:
                kwargs = {k: v for k, v in kwargs.items() if k != "mask"}
                ops = operands(args, kwargs)
                ref = next((entry[2] for entry in known[key]
                            if same(ops, operands(entry[0], entry[1]))), None)
                slot = None
                if ref is None:
                    slot = next((u for u in uniques[key]
                                 if same(ops, u["ops"])), None)
                    if slot is None:
                        slot = dict(args=args, kwargs=kwargs, ops=ops)
                        uniques[key].append(slot)
                launches.append((tag, key, got, ref, slot))
    n_runs = 0
    for key, slots in uniques.items():
        module = pd_kernel if key == "logabs_sum" else st_kernel
        fn = getattr(module, _PLAINS[key])
        groups = {}
        for slot in slots:
            rows = slot["args"][0].shape[0]
            names, values = slot["ops"]
            sig = tuple(
                ("rows", tuple(x.shape[1:]), x.dtype)
                if torch.is_tensor(x) and x.ndim and x.shape[0] == rows
                else ("fixed", id(x) if torch.is_tensor(x) else x)
                for x in values)
            groups.setdefault((sig, names), []).append(slot)
        for (sig, names), group in groups.items():
            def stacked(i):
                xs = [slot["ops"][1][i] for slot in group]
                return torch.cat(xs) if sig[i][0] == "rows" else xs[0]

            n_args = len(group[0]["args"])
            args = [stacked(i) for i in range(n_args)]
            kwargs = {k: stacked(n_args + j) for j, k in enumerate(names)}
            ref, ms = _plain_ms(torch, lambda: fn(*args, **kwargs))
            n_runs += 1
            start = 0
            for slot in group:
                rows = slot["args"][0].shape[0]
                slot["ref"] = ref[start:start + rows]
                start += rows
                known[key].append((slot["args"], slot["kwargs"], slot["ref"],
                                   ms))
    summary = {}
    for tag, key, got, ref, slot in launches:
        ref = slot["ref"] if ref is None else ref
        if key == "logabs_sum":
            _max_err(torch, got, ref, *TOL[("prod_diff", str(got.dtype)[6:])],
                     f"{prefix} {tag} kernel 2 {tuple(got.shape)}")
        else:
            check(torch.equal(got, ref), f"{prefix} {tag}: {key} launch of "
                  f"{tuple(got.shape)} != its plain version")
        summary[(tag, key)] = summary.get((tag, key), 0) + 1
    print(f"[{prefix}] launches held against their plain versions in "
          f"{time.perf_counter() - t_check:.1f} s, {n_runs} plain runs on "
          f"{sum(len(u) for u in uniques.values())} distinct launches' rows "
          f"(kernels 1 and 3 bitwise, kernel 2 within its tolerance): "
          + "; ".join(f"{tag} {key} {n}" for (tag, key), n in summary.items()))


def _server_segmented_record(torch, launch, launches):
    """Kernel 3's record at the packed stream's shape (the server's packed
    rows of 512, 16 slots of k lanes a row); ``launch`` is one captured
    launch of that stream, with its plain version's time."""
    from repro_torch.kernels.sturm import kernel as st_kernel
    from repro_torch.linalg.householder import tridiagonal_matrix

    (d, e), lanes, plain_ms = launch
    n_iter = lanes["n_iter"]
    lanes = {k: v for k, v in lanes.items() if k != "n_iter"}
    fn = lambda: st_kernel.sturm_segmented(d, e, **lanes, n_iter=n_iter)  # noqa: E731
    rows, n = d.shape
    m = lanes["lo"].shape[1]
    name = str(d.dtype)[6:]
    seg_steps = int((lanes["end"] - lanes["start"]).sum())
    ops = seg_steps * n_iter * (STURM_OPS_PER_STEP + SEGMENT_COMPARE_OPS)
    nbytes = ((rows * n + rows * (n - 1) + 4 * rows * m) * d.element_size()
              + 3 * rows * m * 4)
    bound, by = _bound(ops, nbytes, name)
    dense = tridiagonal_matrix(d, e)
    return _record(
        f"sturm_segmented[server packed stream {rows}x{n}, {m} lanes, "
        f"{name}]", "sturm_segmented", launches=launches, err=0.0,
        ms=_events_ms(torch, fn, warmup=3, reps=20), plain_ms=plain_ms,
        bound_ms=bound, bound_by=by,
        library_ms=_events_ms(torch, lambda: torch.linalg.eigvalsh(dense),
                              warmup=1, reps=5))


# -- the replica fleet ---------------------------------------------------------


def _check_fleet_log(tag, records, reasons=()):
    """Every failover in one fleet stream had a cause the stream allows,
    read from the fleet's log: a replica may die only for a reason in
    ``reasons`` (``"deadline"`` only after a chaos hang on that replica),
    every redispatch or parked request follows a death and names a
    replica's failure as its cause, and a session fails over only where
    ``"session"`` is allowed.  Slow classifications and hedges are counted,
    not refused.  Returns the count of each kind of event."""
    import logging

    from repro_torch.engine.fleet import ReplicaDied
    from repro_torch.engine.server import ServerClosed

    events, hung, dead = {}, set(), 0
    for r in records:
        msg = r.msg
        if msg.startswith("fleet: chaos "):
            kind = f"chaos {r.args[0]}"
            if r.args[0] == "hang":
                hung.add(r.args[1])
        elif msg.startswith("fleet: replica %d dead"):
            rid, reason = r.args
            kind = "dead " + reason.split()[0]
            if reason.startswith("deadline"):
                ok = "deadline" in reasons and rid in hung
            else:
                ok = reason in reasons
            check(ok, f"{tag}: the fleet logged {r.getMessage()!r}")
            hung.discard(rid)
            dead += 1
        elif msg.startswith(("fleet: replica %d restarting",
                             "fleet: replica %d restarted")):
            kind = "restart"
            check(dead > 0, f"{tag}: {r.getMessage()!r} with no death")
        elif msg.startswith("fleet: redispatching"):
            # A worker's EOF fails its requests before the monitor logs the
            # death: the death is checked after the loop.
            kind = "redispatch"
            check(bool(reasons) and isinstance(
                r.args[4], (ReplicaDied, ServerClosed)),
                f"{tag}: the fleet logged {r.getMessage()!r}")
        elif "exhausted" in msg and msg.endswith("parked"):
            kind = "parked"
            check(bool(reasons), f"{tag}: {r.getMessage()!r}")
        elif msg.startswith("fleet: session %s failing over"):
            kind = "session failover"
            check("session" in reasons,
                  f"{tag}: the fleet logged {r.getMessage()!r}")
        elif msg.startswith("fleet: replica %d classified SLOW"):
            kind = "slow"
        elif msg.startswith("fleet: hedging"):
            kind = "hedge"
        elif r.levelno >= logging.WARNING:
            kind = None
            check(False, f"{tag}: the fleet logged {r.getMessage()!r}")
        else:
            continue
        events[kind] = events.get(kind, 0) + 1
    check(dead > 0 or not (events.get("redispatch") or events.get("parked")),
          f"{tag}: requests failed over with no replica death: {events}")
    return events


def _check_replica_server_log(tag, records, killed):
    """The replica servers' log in one fleet stream: a killed replica's
    server may fail its queued groups with ``ServerClosed`` and report the
    futures its ``close(timeout=0)`` left to the fleet; anything else goes
    through ``_check_faults`` with no cause allowed."""
    from repro_torch.engine.server import ServerClosed

    rest, n_closed = [], 0
    for r in records:
        if killed and (
                (r.msg.startswith("EEI stack dispatch failed")
                 and isinstance(r.args[1], ServerClosed))
                or r.msg.startswith("EeiServer.close(): drain did not")):
            n_closed += 1
        else:
            rest.append(r)
    _check_faults(tag, rest)
    return n_closed


def _fleet_line(tag, stats, wall, requests):
    per = stats["per_replica"]
    stacks = {rid: s.get("stacks_dispatched", "-") for rid, s in per.items()}
    print(f"[fleet] {tag}: {requests} requests in {wall:.3f} s, "
          f"{requests / wall:.2f} requests/s; p50 "
          f"{stats['p50_latency_ms']:.1f} ms, p99 "
          f"{stats['p99_latency_ms']:.1f} ms; stacks by replica {stacks}; "
          f"hedges {stats['hedges']} (wasted {stats['hedge_wasted']}); "
          f"redispatches {stats['redispatches']}, killed "
          f"{stats['replicas_killed']}, restarted "
          f"{stats['replicas_restarted']}, deadline deaths "
          f"{stats['deadline_deaths']}, failed {stats['requests_failed']}; "
          f"states {stats['replica_states']}")


def _quiesce(timeout_s):
    """Wait for every serving thread (``eei-*``: replicas' forwarders and
    servers', killed ones' too, the fleet monitor) to end, so that no launch
    lands after the counts are read."""
    import threading

    deadline = time.monotonic() + timeout_s
    for t in threading.enumerate():
        if t.name.startswith("eei-"):
            t.join(max(deadline - time.monotonic(), 0.0))
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("eei-")]
    check(not alive, f"fleet: threads still running: {alive}")


def _compute_apps():
    """What ``nvidia-smi`` says of the card's compute processes: ``(the
    ``pid, used_memory`` lines, the card's used memory in MiB)``.  In a
    container it may name every process by the namespace's pid 1, so the
    lines are counted, not matched to pids."""
    lines = []
    for query in ("--query-compute-apps=pid,used_memory",
                  "--query-gpu=memory.used"):
        smi = subprocess.run(["nvidia-smi", query,
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
        lines.append([x.strip() for x in smi.stdout.strip().splitlines()
                      if x.strip()])
    apps, used = lines
    print(f"[fleet] nvidia-smi compute apps (pid, MiB): {apps}; card "
          f"memory used {used[0]} MiB")
    return apps, float(used[0])


def _phase_fleet(torch, dev, stack, served):
    """The replica fleet (``EeiFleet``, ``launch/serve.py --replicas``) on
    the card, in five parts, each through the entry points a user calls with
    the launch counts at 0 just before and read just after: (1) stream 1
    through a clean in-process fleet; (2) the same under replica chaos; (3)
    part of it through two worker processes, one SIGKILLed mid-stream; (4) a
    session whose replica is killed halfway; (5) the launcher under replica
    chaos.  Every request at the served-request gates; every failover's
    cause read from the fleet's log; every in-process launch of parts 1, 2
    and 4 held against its plain version.  Returns each wrapper's launches
    by part."""
    import os
    import signal

    import numpy as np

    from repro_torch.engine import EeiFleet, verify_topk_host
    from repro_torch.engine.server import DegradedResult, make_eei_stream
    from repro_torch.launch import serve as serve_cli
    from repro_torch.runtime import ChaosConfig, ChaosMonkey, route_key

    t_phase = time.perf_counter()
    mixed = make_eei_stream(*SERVE_MIXED, seed=0, mixed=True)
    a_main = stack.cpu().numpy()
    rng = np.random.default_rng(SEED + 16)  # phase 11's session updates
    fro = float(np.linalg.norm(a_main[0]))
    updates = [rng.standard_normal(N) * np.sqrt(0.01 * fro / N)
               for _ in range(SERVE_SESSION_UPDATES)]
    loggers = ("repro_torch.engine.fleet", "repro_torch.engine.server")
    kwargs = dict(max_batch=SERVE_BATCH, linger_ms=SERVE_LINGER_MS,
                  verify=True)
    restart = dict(max_restarts=1000, base_delay_s=0.05, cap_s=0.5)
    calls, plain, undo = _arm_server_capture()
    streams, launches = {}, {}

    def counted(tag, fn, hold=True):
        out, counts, got, records = _run_counted(
            torch, "fleet", tag, fn, calls, plain, loggers)
        if hold:
            streams[tag] = dict(calls=got)
        launches[tag] = counts
        return out, records

    def serve(fleet, stream):
        """Submit at once, wait every result, close (nothing stranded),
        wait for the serving threads; returns results, wall and stats."""
        try:
            t0 = time.perf_counter()
            futs = [fleet.submit(a, k) for a, k in stream]
            results = [f.result(timeout=SERVE_WAIT_S) for f in futs]
            wall = time.perf_counter() - t0
        finally:
            stranded = fleet.close(timeout=SERVE_WAIT_S)
        check(not stranded, f"fleet: {len(stranded)} futures stranded")
        _quiesce(SERVE_WAIT_S)
        return results, wall, fleet.stats()

    try:
        # 1. Clean, in-process: every key on its rendezvous owner.
        tag = "part 1 clean"
        fleet = EeiFleet(FLEET_REPLICAS, salt=FLEET_SALT,
                         server_kwargs=dict(kwargs, record_dispatches=True))
        servers = {rid: r.driver._server
                   for rid, r in fleet._replicas.items()}
        check(all(sv.device.type == dev.type for sv in servers.values()),
              f"{tag}: replicas on {[sv.device for sv in servers.values()]}")
        (results, wall, stats), logs = counted(
            tag, lambda: serve(fleet, mixed))
        _fleet_line(tag, stats, wall, len(mixed))
        single = served["single"]
        print(f"[fleet] {tag} beside phase 11's threaded single server on "
              f"the same stream: {len(mixed) / single['wall']:.2f} "
              f"requests/s, p50 {single['p50']:.1f} ms, p99 "
              f"{single['p99']:.1f} ms, {single['stacks']} stacks")
        check(stats["requests_completed"] == len(mixed)
              and stats["requests_failed"] == stats["redispatches"]
              == stats["replicas_killed"] == stats["deadline_deaths"] == 0,
              f"{tag}: {stats}")
        for rid, sv in servers.items():
            st = sv.stats()
            check(st["requests_failed"] == st["requests_degraded"]
                  == st["verify_failed"] == st["retries"]
                  == st["stack_splits"] == 0, f"{tag} replica {rid}: {st}")
        _check_replica_server_log(tag, logs["repro_torch.engine.server"],
                                  killed=False)
        events = _check_fleet_log(tag, logs["repro_torch.engine.fleet"])
        owners, off_owner = {}, 0
        for rid, sv in servers.items():
            for rec in sv.dispatch_log:
                for req in rec.requests:
                    key = (req.n, req.largest)
                    owner = route_key(key, list(servers), FLEET_SALT)
                    owners[key] = owner
                    off_owner += rid != owner
        # A hedged request also runs on a non-owner (its second attempt).
        check(off_owner <= stats["hedges"] and len(set(owners.values()))
              == FLEET_REPLICAS, f"{tag}: {off_owner} requests served off "
              f"their owner with {stats['hedges']} hedges; owners {owners}")
        print(f"[fleet] {tag}: owners by (n, largest) {owners}, "
              f"{off_owner} requests served off their owner (hedged); "
              f"fleet log {events}")
        err, res = _check_requests(torch, dev, mixed, results, tag)
        print(f"[fleet] {tag}: every request within the float32 gates "
              f"(worst {err:.3e} / {res:.3e})")
        check(launches[tag]["sturm_bisect"] > 0
              and launches[tag]["logabs_sum"] > 0,
              f"{tag}: kernels 1 and 2 not both launched")
        deadline_s = max(FLEET_DEADLINE_X * stats["p99_latency_ms"] / 1e3,
                         FLEET_DEADLINE_MIN_S)

        # 2. Replica chaos, in-process.
        tag = "part 2 replica chaos"
        config = ChaosConfig(rate=0.0, replica_hang_s=2 * deadline_s,
                             **FLEET_CHAOS)
        fleet = EeiFleet(FLEET_REPLICAS, salt=FLEET_SALT,
                         server_kwargs=kwargs, deadline_s=deadline_s,
                         chaos=ChaosMonkey(config),
                         restart_policy_kwargs=restart)

        print(f"[fleet] {tag}: deadline_s {deadline_s:.3f} "
              f"({FLEET_DEADLINE_X:g} x part 1's p99), hang "
              f"{config.replica_hang_s:.3f} s, {FLEET_CHAOS}")
        (results, wall, stats), logs = counted(
            tag, lambda: serve(fleet, mixed))
        _fleet_line(tag, stats, wall, len(mixed))
        injected = stats["chaos_injected"]
        check(stats["requests_failed"] == 0
              and stats["requests_completed"] == len(mixed)
              and stats["replicas_killed"] >= 1
              and stats["replicas_restarted"] >= 1
              and stats["redispatches"] >= 1
              and stats["deadline_deaths"] >= 1
              and all(injected[f"replica_{x}"] >= 1
                      for x in ("kill", "hang", "slow")),
              f"{tag}: {stats}")
        events = _check_fleet_log(tag, logs["repro_torch.engine.fleet"],
                                  ("chaos kill", "deadline"))
        closed = _check_replica_server_log(
            tag, logs["repro_torch.engine.server"], killed=True)
        err, res = _check_requests(torch, dev, mixed, results, tag)
        print(f"[fleet] {tag}: injected {injected}; fleet log {events}; "
              f"{closed} closed-server records of killed replicas; every "
              f"request within the float32 gates (worst {err:.3e} / "
              f"{res:.3e})")

        # 3. Subprocess replicas on the card (no device: the workers need
        # the card); worker 0 owns n = 192 and 288 at FLEET_SALT.
        tag = "part 3 subprocess"
        sub_stream = mixed[:FLEET_SUBPROCESS]
        owner0 = [(a, k) for a, k in mixed
                  if route_key((a.shape[0], True), [0, 1], FLEET_SALT) == 0]
        warm = {}
        for a, k in mixed:
            warm.setdefault(a.shape[0], (a, k))

        def subprocess_run():
            out = dict(apps0=_compute_apps())
            t0 = time.perf_counter()
            fleet = EeiFleet(2, replica_mode="subprocess", salt=FLEET_SALT,
                             server_kwargs=kwargs,
                             restart_policy_kwargs=restart)
            out.update(start_wall=time.perf_counter() - t0, fleet=fleet,
                       starts={rid: r.driver.start_s
                               for rid, r in fleet._replicas.items()})
            try:
                t0 = time.perf_counter()
                futs = [fleet.submit(a, k) for a, k in warm.values()]
                [f.result(timeout=SERVE_WAIT_S) for f in futs]
                out["warm_s"] = time.perf_counter() - t0
                pids = {rid: r.driver.stats()["pid"]
                        for rid, r in fleet._replicas.items()}
                out["apps"], out["pids"] = _compute_apps(), pids
                t0 = time.perf_counter()
                futs = [fleet.submit(a, k) for a, k in sub_stream]
                os.kill(pids[0], signal.SIGKILL)
                t_kill = time.perf_counter()
                out["results"] = [f.result(timeout=SERVE_WAIT_S)
                                  for f in futs]
                out["wall"] = time.perf_counter() - t0
                while fleet.stats()["replicas_restarted"] < 1:
                    check(time.perf_counter() - t_kill < SERVE_WAIT_S,
                          f"{tag}: worker 0 did not restart")
                    time.sleep(0.05)
                out["restart_s"] = time.perf_counter() - t_kill
                out["restart_start_s"] = fleet._replicas[0].driver.start_s
                # The restarted worker makes its CUDA context at its first
                # request: send it a few of its own keys.
                t0 = time.perf_counter()
                futs = [fleet.submit(a, k) for a, k in owner0[:4]]
                out["after"] = [f.result(timeout=SERVE_WAIT_S)
                                for f in futs]
                out["after_s"] = time.perf_counter() - t0
                out["pids_after"] = {rid: r.driver.stats()["pid"]
                                     for rid, r in fleet._replicas.items()}
                out["apps_after"] = _compute_apps()
            finally:
                out["stranded"] = fleet.close(timeout=SERVE_WAIT_S)
            return out

        out, logs = counted(tag, subprocess_run, hold=False)
        stats = out["fleet"].stats()
        _fleet_line(tag, stats, out["wall"], len(sub_stream))
        check(not out["stranded"] and stats["requests_failed"] == 0
              and stats["requests_completed"]
              == len(warm) + len(sub_stream) + len(out["after"])
              and stats["replicas_killed"] >= 1,
              f"{tag}: {len(out['stranded'])} stranded, {stats}")
        # Each live worker holds a context on the card: two compute
        # processes more than before the fleet, after the warm-up and
        # again after the restart (the SIGKILLed worker's is gone).
        n0, mib0 = len(out["apps0"][0]), out["apps0"][1]
        for name, (apps, _) in (("after the warm-up", out["apps"]),
                                ("after the restart", out["apps_after"])):
            check(len(apps) == n0 + 2, f"{tag}: {len(apps)} compute "
                  f"processes {name}, {n0} before the workers: {apps}")
        check(out["pids_after"][0] != out["pids"][0]
              and out["pids_after"][1] == out["pids"][1],
              f"{tag}: worker pids {out['pids']} -> {out['pids_after']}")
        hbm = (out["apps"][1] - mib0) / 2
        events = _check_fleet_log(tag, logs["repro_torch.engine.fleet"],
                                  ("driver died",))
        check(launches[tag]["sturm_bisect"] == launches[tag][
            "logabs_sum"] == 0, f"{tag}: the parent launched "
              f"{launches[tag]}")
        err, res = _check_requests(torch, dev, sub_stream, out["results"],
                                   tag)
        _check_requests(torch, dev, owner0[:4], out["after"],
                        f"{tag} after the restart")
        print(f"[fleet] {tag}: 2 workers (pids {out['pids']}) started in "
              f"{out['start_wall']:.3f} s (spawn to ready: "
              f"{ {r: round(t, 3) for r, t in out['starts'].items()} }), "
              f"first requests (CUDA context, kernel library) "
              f"{out['warm_s']:.3f} s; {n0} compute process(es) before "
              f"them, {n0 + 2} with them; card memory {mib0:.0f} -> "
              f"{out['apps'][1]:.0f} MiB, {hbm:.0f} MiB a worker; worker 0 "
              f"SIGKILLed mid-stream, restarted (pid "
              f"{out['pids_after'][0]}) in {out['restart_s']:.3f} s (spawn "
              f"to ready {out['restart_start_s']:.3f} s), its first "
              f"requests {out['after_s']:.3f} s, card memory "
              f"{out['apps_after'][1]:.0f} MiB; fleet log {events}; every "
              f"request within the float32 gates (worst {err:.3e} / "
              f"{res:.3e})")

        # 4. Session failover: kill the session's replica halfway.
        tag = "part 4 session failover"
        half = SERVE_SESSION_UPDATES // 2
        fleet = EeiFleet(FLEET_REPLICAS, salt=FLEET_SALT,
                         server_kwargs=dict(verify=True),
                         restart_policy_kwargs=restart)

        def session_run():
            try:
                sid = fleet.open_session(a_main[0], K)
                a_now, steps = a_main[0].copy(), []
                for i, u in enumerate(updates):
                    if i == half:
                        rid = fleet._sessions[sid].rid
                        fleet._kill_replica(rid, reason="session kill")
                    a_now = a_now + np.outer(u, u)
                    steps.append((a_now, fleet.submit_update(sid, u).result(
                        timeout=SERVE_WAIT_S)))
                return steps
            finally:
                fleet.close(timeout=SERVE_WAIT_S)
                _quiesce(SERVE_WAIT_S)

        steps, logs = counted(tag, session_run)
        stats = fleet.stats()
        events = _check_fleet_log(tag, logs["repro_torch.engine.fleet"],
                                  ("session kill", "session"))
        _check_replica_server_log(tag, logs["repro_torch.engine.server"],
                                  killed=True)
        span0, worst = None, 0.0
        for i, (a_now, res) in enumerate(steps):
            w = np.linalg.eigvalsh(a_now)
            span0 = span0 or float(w[-1] - w[0])
            rel = float(np.abs(np.asarray(res.eigenvalues, np.float64)
                               - w[-K:]).max()) / span0
            reopened = isinstance(res, DegradedResult) and \
                res.fallback == "session_reopen"
            check(rel <= SESSION_TOL and bool(verify_topk_host(
                a_now, res.eigenvalues, res.vectors).ok)
                and reopened == (i == half),
                f"{tag} update {i}: eigenvalue error {rel:.3e} of the span "
                f"(limit {SESSION_TOL:g}), verify, or {type(res).__name__} "
                f"{getattr(res, 'fallback', '')!r}")
            worst = max(worst, rel)
        check(stats["session_failovers"] >= 1
              and launches[tag]["sturm_segmented"] > 0,
              f"{tag}: {stats}, launches {launches[tag]}")
        print(f"[fleet] {tag}: {len(steps)} updates, the replica killed "
              f"before update {half}; session_failovers "
              f"{stats['session_failovers']}, update {half} a "
              f"DegradedResult('session_reopen'); worst eigenvalue error "
              f"{worst:.3e} of the span (limit {SESSION_TOL:g}); fleet log "
              f"{events}")

        # 5. The launcher under replica chaos.
        tag = "part 5 launcher"

        def launcher_run():
            with _LogRecords("repro_torch.serve") as log:
                serve_cli.main(["--eei", "--replicas", str(FLEET_REPLICAS),
                                "--chaos-replicas", "--mixed", "--requests",
                                str(SERVE_MIXED[0]), "--n",
                                str(SERVE_MIXED[1]), "--k",
                                str(SERVE_MIXED[2]), "--batch",
                                str(SERVE_BATCH), "--seed", "0"])
            _quiesce(SERVE_WAIT_S)
            return [r.getMessage() for r in log.records]

        said, logs = counted(tag, launcher_run, hold=False)
        _check_fleet_log(tag, logs["repro_torch.engine.fleet"],
                         ("chaos kill", "deadline"))
        _check_replica_server_log(tag, logs["repro_torch.engine.server"],
                                  killed=True)
        rollup = [m for m in said if m.startswith(("fleet served",
                                                   "failover:",
                                                   "chaos injected:"))]
        check(any(m.startswith(f"fleet served {SERVE_MIXED[0]} requests")
                  and m.endswith("| 0 unresolved at close") for m in said)
              and any(m.startswith("chaos injected:")
                      and m.endswith("requests_failed=0") for m in said),
              f"{tag}: {said}")
        print(f"[fleet] {tag}: " + " | ".join(rollup))
    finally:
        undo()
    serve_s = time.perf_counter() - t_phase
    _hold_against_plain(torch, "fleet", streams, served["known"])
    print(f"[timing] the fleet phase took {serve_s:.1f} s to serve, "
          f"{time.perf_counter() - t_phase:.1f} s with its checks")
    return {key: {tag: counts[key] for tag, counts in launches.items()}
            for key in _PLAINS}


# -- the sharded backend and the ladder ---------------------------------------


def _max_diff(torch, x, y) -> float:
    """Largest absolute difference of two results (tensors or tuples)."""
    if isinstance(x, tuple):
        return max(_max_diff(torch, a, b) for a, b in zip(x, y))
    return float((x.double() - y.double()).abs().max())


def _equal(torch, x, y) -> bool:
    if isinstance(x, tuple):
        return all(_equal(torch, a, b) for a, b in zip(x, y))
    return _same(torch, x, y)


def _phase_sharded(torch, dev, stack, engine_results, known):
    """13. The sharded backend (``SolverEngine`` on 1x1 and logical 2x1
    meshes of the card, a session on a 2x1 plan, ``EeiServer(mesh=)``, the
    minor and term axes) and the paper's component ladder, each through the
    entry points a user calls, with the launch counts set to 0 just before
    each run and read just after.  ``engine_results`` are phase 3's results
    on the ``cuda`` backend, which the 1x1 mesh must reproduce bitwise;
    ``known`` the launches already held against their plain versions.
    Returns each wrapper's launches by run."""
    import numpy as np

    from repro_torch import (Rank1Update, SolverEngine, SolverPlan,
                             make_local_mesh, plan_for)
    from repro_torch.core import distributed, identity, minors
    from repro_torch.engine import EeiServer, verify_topk_host
    from repro_torch.engine.server import make_eei_stream

    card = _gpu_name_and_limit()
    print(f"[sharded] phase 13 on {card}")
    t_phase = time.perf_counter()
    meshes = {"1x1": make_local_mesh(1, 1),
              "2x1": make_local_mesh(2, 1, devices=[dev, dev]),
              "1x2": make_local_mesh(1, 2, devices=[dev, dev])}
    check(meshes["1x1"].first_device.type == dev.type
          and meshes["2x1"].shape == {"data": 2, "model": 1},
          f"sharded: meshes {meshes}")
    calls, plain, undo = _arm_server_capture()
    streams, launches = {}, {}

    def counted(tag, fn, hold=True):
        out, counts, got, records = _run_counted(
            torch, "sharded", tag, fn, calls, plain)
        launches[tag] = counts
        if hold:
            streams[tag] = dict(calls=got, counts=counts)
        return out, counts, records["repro_torch.engine.server"]

    programs = {
        "solve": ("full", lambda eng, a: eng.solve(a)),
        "topk windowed": ("windowed", lambda eng, a: eng.topk(a, K)),
        "topk full": ("full", lambda eng, a: eng.topk(a, K)),
        "eigenvalues": ("full", lambda eng, a: eng.eigenvalues(a)),
    }
    #: Launches of (kernel 1, kernel 2) a call of each program on one shard.
    per_shard = {"solve": (2, 1), "topk windowed": (1, 0),
                 "topk full": (2, 1), "eigenvalues": (1, 0)}
    try:
        # 1. The engine on 1x1 (bitwise the cuda backend's phase-3 results)
        # and on 2x1 (phase 3's gates), float64 and float32.
        ones = {}
        for mesh_name, shards in (("1x1", 1), ("2x1", 2)):
            for name, dt in (("float64", torch.float64),
                             ("float32", torch.float32)):
                a = stack.to(dt)
                for what, (spectrum, call) in programs.items():
                    tag = f"{mesh_name} {what} {name}"
                    plan = SolverPlan(method="eei_tridiag", backend="sharded",
                                      mesh=meshes[mesh_name],
                                      spectrum=spectrum)
                    engine = SolverEngine(plan)
                    check(engine.device == meshes[mesh_name].first_device,
                          f"{tag}: engine on {engine.device}")
                    res, counts, _ = counted(tag, lambda: call(engine, a),
                                             hold=shards > 1)
                    k1, k2 = per_shard[what]
                    check(counts["sturm_bisect"] == shards * k1
                          and counts["logabs_sum"] == shards * k2,
                          f"{tag}: launches {counts}, expected "
                          f"{(shards * k1, shards * k2)}")
                    if shards == 1:
                        ref = engine_results[name][what]
                        check(_equal(torch, res, ref), f"{tag}: not bitwise "
                              f"the cuda backend's result")
                        ones[(what, name)] = res
                        continue
                    if what == "solve":
                        _check_solve(torch, a, res, name)
                    elif what.startswith("topk"):
                        _check_topk(torch, a, res, name, f"2x1 {what}")
                    else:
                        _check_eigenvalues(torch, a, res, name,
                                           "2x1 eigenvalues")
                    print(f"[sharded] {tag}: max difference from the 1x1 "
                          f"result {_max_diff(torch, res, ones[(what, name)]):.3e}")
        print("[sharded] 1x1 mesh: solve, topk windowed and full, "
              "eigenvalues bitwise the cuda backend's results, float64 and "
              "float32; one launch a stage")
        # A stack of 3 is padded to 4 and sliced back.
        plan = SolverPlan(method="eei_tridiag", backend="sharded",
                          mesh=meshes["2x1"], spectrum="windowed")
        a3 = stack[:3]
        res, counts, _ = counted("2x1 topk windowed, stack of 3",
                                 lambda: SolverEngine(plan).topk(a3, K))
        check(tuple(res.eigenvalues.shape) == (3, K)
              and counts["sturm_bisect"] == 2,
              f"stack of 3: shapes {tuple(res.eigenvalues.shape)}, "
              f"launches {counts}")
        seen = streams["2x1 topk windowed, stack of 3"]["calls"]
        check([tuple(args[0].shape) for args, _, _ in seen["sturm_bisect"]]
              == [(2, N)] * 2, "stack of 3: shards "
              f"{[tuple(c[0][0].shape) for c in seen['sturm_bisect']]}")
        _check_topk(torch, a3, res, "float64", "2x1 topk windowed, stack of 3")

        # 2. A session on the 2x1 plan: 8 updates at ~1% of ||A||_F.
        a_np = stack[0].cpu().numpy()
        rng = np.random.default_rng(SEED + 16)
        fro = float(np.linalg.norm(a_np))
        updates = [rng.standard_normal(N) * np.sqrt(0.01 * fro / N)
                   for _ in range(SERVE_SESSION_UPDATES)]
        engine = SolverEngine(SolverPlan(
            method="eei_tridiag", backend="sharded", mesh=meshes["2x1"],
            spectrum="windowed", precision="float64"))

        def session_stream():
            session = engine.open_session(a_np, K)
            a_now, out = a_np.copy(), []
            for u in updates:
                a_now = a_now + np.outer(u, u)
                out.append((a_now, engine.update(session, Rank1Update(u, 1))))
            return session, out

        (session, steps), counts, _ = counted("2x1 session", session_stream)
        span0, worst = None, 0.0
        for i, (a_now, res) in enumerate(steps):
            w = np.linalg.eigvalsh(a_now)
            span0 = span0 or float(w[-1] - w[0])
            got = res.eigenvalues.double().cpu().numpy()
            rel = float(np.abs(got - w[-K:]).max()) / span0
            check(rel <= SESSION_TOL and bool(verify_topk_host(
                a_now, got, res.vectors.double().cpu().numpy()).ok),
                f"2x1 session update {i}: eigenvalue error {rel:.3e} of the "
                f"span (limit {SESSION_TOL:g}) or verify failed")
            worst = max(worst, rel)
        per_update = counts["sturm_segmented"] / SERVE_SESSION_UPDATES
        check(session.fast_updates == SERVE_SESSION_UPDATES
              and session.full_resolves == 0 and per_update == 2,
              f"2x1 session: {session.stats()}, launches {counts}")
        print(f"[sharded] 2x1 session, float64: {session.fast_updates} fast "
              f"updates, {per_update:g} kernel-3 launches an update (one a "
              f"shard); worst eigenvalue error {worst:.3e} of the span "
              f"(limit {SESSION_TOL:g})")

        # 3. EeiServer(mesh=2x1) on stream 1, caller-driven.
        tag = "2x1 server stream 1"
        mixed = make_eei_stream(*SERVE_MIXED, seed=0, mixed=True)
        server = EeiServer(None, mesh=meshes["2x1"], max_batch=SERVE_BATCH,
                           verify=True, record_dispatches=True)
        (_, results, wall), counts, records = counted(
            tag, lambda: _serve_stream(server, mixed, False))
        stats = server.stats()
        check(stats["requests_completed"] == len(mixed)
              and stats["requests_failed"] == stats["requests_degraded"]
              == stats["verify_failed"] == stats["retries"]
              == stats["stack_splits"] == 0
              and stats["fallbacks_by_plan"] == {}, f"{tag}: {stats}")
        _check_faults(tag, records)
        picks = {}
        for rec in server.dispatch_log:
            b = rec.bucket
            check(b.b % 2 == 0 and rec.plan == plan_for(
                (b.b, b.n, b.n), k=b.k, mesh=meshes["2x1"])
                and rec.plan.backend == "sharded"
                and rec.plan.method == SERVE_PICKS.get(b.n),
                f"{tag}: bucket {b} ran {rec.plan}")
            picks[(b.n, b.k)] = f"{rec.plan.method}/{rec.plan.spectrum}"
        check(counts["sturm_bisect"] > 0 and counts["logabs_sum"] > 0,
              f"{tag}: kernels 1 and 2 not both launched: {counts}")
        err, res_err = _check_requests(torch, dev, mixed, results, tag)
        _server_line(tag, stats, wall, len(mixed))
        print(f"[sharded] {tag}: every bucket even, sharded "
              + ", ".join(f"n={n} k={k} {p}" for (n, k), p in
                          sorted(picks.items()))
              + f"; 0 failed, 0 retries, 0 fallbacks; every request within "
              f"the float32 gates (worst {err:.3e} / {res_err:.3e}); {card}")
    finally:
        undo()
    known = {key: list(v) for key, v in known.items()}
    _hold_grouped(torch, "sharded", streams, known)

    # 4. The minor and term axes on a logical 1x2 mesh, at n = 64.
    rng = np.random.default_rng(SEED + 13)
    a64 = rng.standard_normal((64, 64))
    a64 = (a64 + a64.T) / 2
    lam_ref, v_ref = np.linalg.eigh(a64)
    mags_ref = (v_ref * v_ref).T
    from repro_torch.engine.backends import _card_float64

    # The term axis takes the spectra the minor axis computes (float64 on
    # the card, cast to the input's dtype).
    eigvalsh = _card_float64(torch.linalg.eigvalsh)
    pairs = ((0, 0), (31, 63), (63, 5))
    ref = np.array([mags_ref[i, j] for i, j in pairs])
    for name, dt in (("float64", torch.float64), ("float32", torch.float32)):
        a = torch.as_tensor(a64, dtype=dt, device=dev)
        tables = {m: distributed.minor_sharded_magnitudes(a, meshes[m])
                  for m in ("1x1", "1x2")}
        lam = eigvalsh(a)
        mu = eigvalsh(minors.all_minors(a))
        comps = {m: [float(distributed.term_sharded_component(
            lam, mu[j], i, meshes[m])) for i, j in pairs]
            for m in ("1x1", "1x2")}
        one = tables["1x1"].double().cpu().numpy()
        for m in ("1x1", "1x2"):
            # repro's tolerances (tests/test_system.py:98-116): the table
            # against the 1x1 table and eigh, the term components against
            # the 1x1 ones and the table's entries; and the components
            # against eigh (float32: within the 2e-3 component bound of
            # tests/test_torch_parity.py).
            got = tables[m].double().cpu().numpy()
            check(got.shape == (64, 64)
                  and np.allclose(got, one, rtol=1e-4, atol=1e-5)
                  and np.allclose(got, mags_ref, rtol=1e-4, atol=1e-5),
                  f"minor axis {m} {name}: off by "
                  f"{np.abs(got - mags_ref).max():.3e} from eigh, "
                  f"{np.abs(got - one).max():.3e} from 1x1")
            comp = np.array(comps[m])
            check(np.allclose(comp, comps["1x1"], rtol=1e-4)
                  and np.allclose(comp, [one[i, j] for i, j in pairs],
                                  rtol=1e-4)
                  and np.allclose(comp, ref, **(
                      dict(rtol=1e-4) if name == "float64"
                      else dict(rtol=0.0, atol=2e-3))),
                  f"term axis {m} {name}: {comps[m]} vs eigh {ref}")
        print(f"[sharded] minor axis (1x2, n = 64, {name}): max error "
              f"{np.abs(tables['1x2'].double().cpu().numpy() - mags_ref).max():.3e}"
              f" from eigh, {_max_diff(torch, tables['1x2'], tables['1x1']):.3e}"
              f" from 1x1; term axis (1x2) at {pairs}: {comps['1x2']}, "
              f"relative error from eigh "
              f"{float(np.abs(np.array(comps['1x2']) / ref - 1).max()):.3e}")

    # 5. The ladder on the card, float64.
    for n, scale, pairs in ((12, 1.0, ((0, 0), (6, 11), (11, 0))),
                            (200, 10.0, ((100, 0),))):
        rng = np.random.default_rng(0)
        a_np = rng.standard_normal((n, n)) * scale
        a_np = (a_np + a_np.T) / 2
        _, v = np.linalg.eigh(a_np)
        a = torch.as_tensor(a_np, device=dev)
        for variant in identity.VARIANTS:
            for i, j in pairs:
                got = float(identity.component(a, i, j, variant=variant,
                                               batch_size=3 if n == 12
                                               else 64))
                ref = v[j, i] ** 2
                if n == 200 and variant in ("baseline", "cached",
                                            "vectorized"):
                    check(not np.isfinite(got), f"ladder n=200 {variant}: "
                          f"{got} (the unpaired products must overflow)")
                    continue
                rtol, atol = (1e-8, 1e-12) if n == 12 else (1e-6, 0.0)
                check(abs(got - ref) <= atol + rtol * abs(ref),
                      f"ladder n={n} {variant} ({i}, {j}): {got} vs eigh "
                      f"{ref}")
        print(f"[sharded] ladder n={n}{' (x10)' if scale > 1 else ''}: every "
              f"variant within repro's tolerance of eigh"
              + ("" if n == 12 else "; baseline, cached and vectorized "
                 "overflow, as repro's test requires"))
    from repro_torch.core import numpy_ref

    rng = np.random.default_rng(1)
    a_np = rng.standard_normal((N, N))
    a_np = (a_np + a_np.T) / 2
    a = torch.as_tensor(a_np, device=dev)
    i, j = N - 1, 0
    times = {}
    for variant in identity.VARIANTS:
        def one(variant=variant):
            out = identity.component(a, i, j, variant=variant)
            torch.cuda.synchronize()
            return out
        times[variant] = _wall_ms(torch, one)
    host = {"numpy_full_eigh": lambda: numpy_ref.numpy_full_eigh(a_np),
            "eigen_component_optimized": lambda:
            numpy_ref.eigen_component_optimized(a_np, i, j)}
    for what, fn in host.items():
        times[f"host {what}"] = _wall_ms(torch, fn)
    print(f"[timing] the ladder at n = {N} (one component ({i}, {j}), float64,"
          f" median of 3 wall ms; {card}; host: numpy on this machine's "
          f"CPU): " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    print(f"[timing] the sharded phase took {time.perf_counter() - t_phase:.1f}"
          f" s with its checks ({card})")
    return launches


def _lm_rel(torch, got, ref) -> float:
    """max |got - ref| over max |ref|."""
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


def _lm_generate(torch, model, params, batch, prompt):
    """Prefill, then LM_GEN - 1 greedy decode steps (the launcher's loop).
    Returns the logits of every step (LM_GEN, B, V), the tokens (B, LM_GEN),
    the prefill's wall ms and the decode's wall ms a step, synchronized."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, caches = model.prefill(params, batch, prompt + LM_GEN)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    tok = logits.argmax(-1)
    out, toks = [logits], [tok]
    t = time.perf_counter()
    for i in range(LM_GEN - 1):
        logits, caches = model.decode_step(params, caches, tok, prompt + i)
        tok = logits.argmax(-1)
        out.append(logits)
        toks.append(tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / (LM_GEN - 1)
    return torch.stack(out), torch.stack(toks, 1), prefill_ms, decode_ms


def _kind_uses(cfg, kind: str) -> int:
    """How many positions of ``cfg.pattern`` run block ``kind``."""
    return sum(r * ks.count(kind) for r, ks in cfg.pattern)


def _routed(name: str) -> bool:
    """A routed experts' stacked weight ``(experts, ., .)`` of a MoE."""
    return "/moe/w_" in name


def _recurrent_ops(cfg, kind: str, tokens: int, prompt: int, decode=False):
    """Operations of a recurrent block's mixer beyond its weights'
    products, for ``tokens`` tokens of sequences of ``prompt``: the
    chunked GLA's within-chunk pairs (the causal half of each chunk) and
    its chunk summaries and state reads (``decode``: the state's update
    and read), the sLSTM's block-diagonal recurrent product; and the
    state's float32 bytes a sequence."""
    d = cfg.d_model
    if kind == "slstm":
        return 2 * tokens * d * 4 * (d // cfg.n_kv_heads), 4 * d * 4
    if kind == "mamba":
        h, dk, dv = 2 * d // cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_head_dim
    else:  # mlstm
        h = cfg.n_heads
        dk = dv = 2 * d // h
    lc = min(cfg.ssm_chunk, prompt)
    while prompt % lc:
        lc //= 2
    per = 2 * dk * dv if decode else (lc + 1) / 2 * (dk + dv) + 2 * dk * dv
    return 2 * tokens * h * per, h * dk * dv * 4


def _lm_bounds(model, batch: int, prompt: int, elsize: int, peak: float):
    """The least time of a prefill of ``prompt`` tokens and of a decode step
    (at the mean position of the LM_GEN - 1 steps) on the card: the larger
    of the bytes the call must move over PEAK_BYTES and its operations over
    ``peak``.  Operations: 2 x rows x weights of every product (rows: the
    tokens; the frames for the encoder and for the cross keys and values;
    one a sequence in decode) -- a shared block's weights once for each
    position that runs it, a MoE's routed experts' for top_k of their
    n_experts (the work routing selects; the dense one-hot dispatch of
    ``models/moe.py`` computes every expert's capacity slots and so does
    more) -- 2 x heads x (qk + v dims) for every (query, key) pair the
    masks let through (MLA's absorbed decode: 2 x heads x (2 x latent +
    rope) a key), the recurrent mixers' chunked or stepwise work
    (``_recurrent_ops``), the head on the last token only.  Bytes: every
    weight the call reads, once (prefill: all of them; decode: the
    decoder's, less the cross keys' and values' projections, whose output
    prefill left in the caches, one embedding row a sequence unless the
    head is the embedding, and of the routed experts only the batch x
    top_k a step's tokens reach, fewer if two share one), the cache
    positions read and written (a recurrent state read and written whole
    in decode), the logits.  Returns {call: (ms, "bytes" or "operations",
    ops, bytes)}."""
    import math

    cfg = model.cfg
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    kv_row = 2 * cfg.n_kv_heads * dh * elsize  # k and v of one position
    pos = prompt + (LM_GEN - 2) / 2  # the mean decode position
    src = cfg.enc_seq if cfg.family == "audio" else cfg.img_seq
    window = cfg.window or float("inf")
    pre_ops = dec_ops = 0.0
    pre_bytes = dec_bytes = batch * cfg.vocab_size * 4  # the logits
    for name, decl in model.layer_table().items():
        size = math.prod(decl.shape)
        pre_bytes += size * elsize
        uses = (_kind_uses(cfg, name.split("/")[1])
                if name.startswith("shared/") else 1)
        if name == "unembed" or (name == "embed/tokens"
                                 and cfg.tie_embeddings):
            pre_ops += 2 * batch * size
            dec_ops += 2 * batch * size
            dec_bytes += size * elsize
        elif name == "embed/tokens":
            dec_bytes += batch * cfg.d_model * elsize
        elif name.startswith("enc"):
            if name.startswith("enc/") and len(decl.shape) > 1:
                pre_ops += 2 * batch * cfg.enc_seq * size
        elif "/xattn/wk" in name or "/xattn/wv" in name:
            pre_ops += 2 * batch * src * size
        elif _routed(name):
            share = cfg.top_k / cfg.n_experts
            pre_ops += 2 * batch * prompt * size * share
            dec_ops += 2 * batch * size * share
            dec_bytes += min(batch * cfg.top_k, cfg.n_experts) / (
                cfg.n_experts) * size * elsize
        else:
            if len(decl.shape) > 1:
                pre_ops += 2 * batch * prompt * size * uses
                dec_ops += 2 * batch * size * uses
            dec_bytes += size * elsize
    kinds = [k for r, ks in cfg.pattern for _ in range(r) for k in ks]
    attend = 4 * batch * h * dh  # operations a (query, key) pair
    for kind in kinds + ["attn_bidir"] * cfg.n_enc_layers:
        if kind == "attn_bidir":
            pre_ops += attend * cfg.enc_seq ** 2
            continue
        if kind in ("mamba", "mlstm", "slstm"):
            ops, state = _recurrent_ops(cfg, kind, batch * prompt, prompt)
            pre_ops += ops
            dec_ops += _recurrent_ops(cfg, kind, batch, prompt, True)[0]
            pre_bytes += batch * state
            dec_bytes += 2 * batch * state
            continue
        pair, row = attend, kv_row
        if kind in ("mla", "mla_moe"):
            qk, r = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.kv_lora_rank
            pair = 2 * batch * h * (qk + cfg.v_head_dim)
            row = (r + cfg.qk_rope_dim) * elsize
        if kind != "cross":
            w = window if kind == "attn_local" else float("inf")
            pre_ops += pair * sum(min(q + 1, w) for q in range(prompt))
            seen = min(pos + 1, w)
            dec_ops += (2 * batch * h * (2 * r + cfg.qk_rope_dim) * seen
                        if kind in ("mla", "mla_moe") else pair * seen)
            pre_bytes += batch * row * prompt
            dec_bytes += batch * row * (seen + 1)
        if kind in ("cross", "dec_cross"):
            pre_ops += attend * prompt * src
            dec_ops += attend * src
            pre_bytes += batch * kv_row * src
            dec_bytes += batch * kv_row * src
    out = {}
    for call, ops, nbytes in (("prefill", pre_ops, pre_bytes),
                              ("decode", dec_ops, dec_bytes)):
        by_ops, by_bytes = ops / peak, nbytes / PEAK_BYTES
        out[call] = (max(by_ops, by_bytes) * 1e3,
                     "operations" if by_ops >= by_bytes else "bytes",
                     ops, nbytes)
    return out


def _lm_line(tag, n_params, elsize, batch, prompt, run, bounds, peak_gb,
             card, phase="lm"):
    _, _, prefill_ms, decode_ms = run
    (pb, pby, pops, pbytes), (db, dby, dops, dbytes) = (bounds["prefill"],
                                                         bounds["decode"])
    print(f"[{phase}] {tag}: {n_params / 1e9:.3f} B parameters "
          f"({n_params * elsize / 1e9:.2f} GB), B = {batch}, prompt {prompt},"
          f" {LM_GEN} greedy tokens; prefill {prefill_ms:.1f} ms (bound "
          f"{pb:.1f} ms by {pby}: {pops / 1e12:.2f} TFLOP, "
          f"{pbytes / 1e9:.2f} GB); decode {decode_ms:.3f} ms a token "
          f"(bound {db:.3f} ms by {dby}: {dbytes / 1e9:.3f} GB, "
          f"{dops / 1e9:.2f} GFLOP), "
          f"{batch * 1e3 / decode_ms:.1f} tokens/s; peak memory "
          f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated); {card}")


def _lm_build(torch, dev, cfg, prompt, dtype=None, tag="lm"):
    """``cfg``'s model on the card (parameters of ``dtype``, float32 when
    None), weights drawn there from SEED, and the launcher's seeded batch
    of LM_BATCH prompts.  Prints the peak memory of the build (each
    parameter is drawn whole in float32, then cast)."""
    from repro_torch.launch.serve import lm_batch
    from repro_torch.models import LanguageModel

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = LanguageModel(cfg, device=dev, dtype=dtype or torch.float32).init(
        torch.Generator(device=dev).manual_seed(SEED))
    batch = lm_batch(cfg, LM_BATCH, prompt, SEED, dev)
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name}: {model.n_params()} parameters drawn on the "
          f"card in {time.perf_counter() - t:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated)")
    return model, batch


def _lm_serve(torch, model, params, batch, prompt, tag, elsize, peak, card,
              phase="lm"):
    """A warm-up prefill, then the timed prefill and LM_GEN - 1 greedy steps,
    every logit finite and every token in the vocabulary.  Returns the
    logits of every step and the tokens."""
    cfg = model.cfg
    model.prefill(params, batch, prompt + LM_GEN)  # cuBLAS, lazy modules
    torch.cuda.reset_peak_memory_stats()
    run = _lm_generate(torch, model, params, batch, prompt)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    logits, tokens = run[0], run[1]
    check(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logits")
    check(tuple(tokens.shape) == (LM_BATCH, LM_GEN)
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"{tag}: tokens {tuple(tokens.shape)} outside the vocabulary")
    _lm_line(tag, model.n_params(), elsize, LM_BATCH, prompt, run,
             _lm_bounds(model, LM_BATCH, prompt, elsize, peak), peak_gb,
             card, phase)
    return logits, tokens


def _lm_exact(torch, model, params, batch, prompt, frames_scale=1.0):
    """The float64 prefill's last logits of the same weights (the frames
    scaled by ``frames_scale``)."""
    from repro_torch.train.steps import cast_tree

    p64 = cast_tree(params, torch.float64)
    b64 = {k: v.double() * (frames_scale if k == "frames" else 1.0)
           if v.is_floating_point() else v for k, v in batch.items()}
    return model.prefill(p64, b64, prompt + LM_GEN)[0]


def _lm_gates(torch, model, batch, prompt, what, tag="lm"):
    """The float64 and consistency gates on the float32 prefill's last
    logits: against the float64 run, and against a prefill of all but the
    last LM_TAIL prompt tokens followed by LM_TAIL decode steps.  A MoE
    decode routes each step's tokens as one group of capacity 4, a
    different function from the prefill's routing (``repro``'s), so with
    MoE blocks the prefill-then-decode path is held against the same path
    in float64 instead."""
    from repro_torch.train.steps import cast_tree

    p32 = model.param_dict()
    logits, caches = model.prefill(p32, batch, prompt + LM_GEN)
    del caches
    exact = _lm_exact(torch, model, p32, batch, prompt)
    err64 = _lm_rel(torch, logits, exact)
    check(bool(torch.isfinite(exact).all()) and err64 <= LM_F64_TOL,
          f"{what}: float32 prefill logits {err64:.3e} of max |logit| from "
          f"float64 (limit {LM_F64_TOL:g})")
    head = {k: v[:, :-LM_TAIL] if k in ("tokens", "labels") else v
            for k, v in batch.items()}

    def tail(params):
        _, caches = model.prefill(params, head, prompt + LM_GEN)
        for pos in range(prompt - LM_TAIL, prompt):
            step, caches = model.decode_step(params, caches,
                                             batch["tokens"][:, pos], pos)
        return step

    step = tail(p32)
    moe = any(k.endswith("_moe") for _, ks in model.cfg.pattern for k in ks)
    ref = tail(cast_tree(p32, torch.float64)) if moe else logits
    against = (f"the same path in float64" if moe
               else f"prefill of {prompt}")
    err_c = _lm_rel(torch, step, ref)
    check(err_c <= LM_CONSISTENCY_TOL,
          f"{what}: prefill of {prompt - LM_TAIL} + {LM_TAIL} decode steps "
          f"{err_c:.3e} of max |logit| from {against} (limit "
          f"{LM_CONSISTENCY_TOL:g})")
    print(f"[{tag}] {what} gates: prefill float32 vs float64 {err64:.3e} of "
          f"max |logit| (limit {LM_F64_TOL:g}); prefill of {prompt - LM_TAIL}"
          f" + {LM_TAIL} decode steps vs {against} {err_c:.3e} (limit "
          f"{LM_CONSISTENCY_TOL:g})")


def _lm_gemma(torch, dev, card):
    """gemma2-2b at full width and depth: float32 served and gated, then in
    bfloat16 (the params cast once) against float32."""
    from repro_torch.configs import get_config
    from repro_torch.train.steps import cast_tree

    cfg, prompt = get_config("gemma2-2b"), LM_GEMMA_PROMPT
    model, batch = _lm_build(torch, dev, cfg, prompt)
    logits, tokens = _lm_serve(torch, model, model.param_dict(), batch,
                               prompt, "gemma2-2b float32", 4,
                               PEAK_OPS["float32"], card)
    _lm_gates(torch, model, batch, prompt, "gemma2-2b")
    pb = cast_tree(model.param_dict(), torch.bfloat16)  # once, before decode
    logits_b, tokens_b = _lm_serve(torch, model, pb, batch, prompt,
                                   "gemma2-2b bfloat16", 2, PEAK_BF16, card)
    err_b = _lm_rel(torch, logits_b[0], logits[0])
    check(err_b <= LM_BF16_TOL, f"gemma2-2b: bfloat16 prefill logits "
          f"{err_b:.3e} of max |logit| from float32 (limit {LM_BF16_TOL:g})")
    print(f"[lm] gemma2-2b bfloat16 gate: prefill logits {err_b:.3e} of max "
          f"|logit| from float32 (limit {LM_BF16_TOL:g}); "
          f"{int((tokens_b == tokens).sum())} of {tokens.numel()} greedy "
          f"tokens as in float32")


def _lm_whisper(torch, dev, card):
    """whisper-large-v3 at full width and depth, float32, served; its
    float64 and consistency gates at full width and depth
    LM_WHISPER_GATE_DEPTH.  Under repro's init rules every attention score
    has a standard deviation of ~64 here (no softcap), so the softmax picks
    near-argmax keys and, from 4 layers on, even the float64 prefill moves
    by O(1) of max |logit| when the frames move by 2**-24 (the sensitivity
    printed at full depth).  No comparison of two orders of rounding can be
    held there; at depth LM_WHISPER_GATE_DEPTH the function is
    well-conditioned."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg, prompt = get_config("whisper-large-v3"), LM_WHISPER_PROMPT
    model, batch = _lm_build(torch, dev, cfg, prompt)
    p32 = model.param_dict()
    logits, _ = _lm_serve(torch, model, p32, batch, prompt,
                          "whisper-large-v3 float32", 4, PEAK_OPS["float32"],
                          card)
    exact = _lm_exact(torch, model, p32, batch, prompt)
    moved = _lm_exact(torch, model, p32, batch, prompt, 1 + 2.0 ** -24)
    check(bool(torch.isfinite(exact).all()), "whisper float64: non-finite")
    print(f"[lm] whisper-large-v3 at depth {cfg.n_enc_layers} + "
          f"{cfg.n_layers} (not gated): prefill float32 vs float64 "
          f"{_lm_rel(torch, logits[0], exact):.3e} of max |logit|; float64 "
          f"with the frames x (1 + 2**-24) vs float64 "
          f"{_lm_rel(torch, moved, exact):.3e}")
    del model, p32, exact, moved
    depth = LM_WHISPER_GATE_DEPTH
    cut = dataclasses.replace(cfg, n_layers=depth, n_enc_layers=depth,
                              pattern=((depth, ("dec_cross",)),))
    model, batch = _lm_build(torch, dev, cut, prompt)
    _lm_gates(torch, model, batch, prompt,
              f"whisper-large-v3 at depth {depth} + {depth}")


def _phase_lm(torch, dev):
    """The language model's serving path at full published width: gemma2-2b
    (float32, float64 and bfloat16) and whisper-large-v3 (float32, float64)
    through ``LanguageModel.prefill`` / ``decode_step``, then
    ``launch/serve.py --arch`` in a subprocess.  The path runs no kernel of
    the repo: every launch count stays 0."""
    card = _gpu_name_and_limit()
    t_phase = time.perf_counter()
    _reset_counts()
    with torch.inference_mode():
        _lm_gemma(torch, dev, card)
        _lm_whisper(torch, dev, card)
    counts = _read_counts()
    check(not any(counts.values()), f"lm: the LM path launched a kernel of "
          f"the repo: {counts}")
    torch.cuda.empty_cache()

    import os

    import numpy as np

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *LM_LAUNCHER],
        cwd=root, env=env, capture_output=True, text=True,
        timeout=LM_LAUNCHER_TIMEOUT_S)
    wall = time.perf_counter() - t
    check(proc.returncode == 0, f"lm launcher exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    from repro_torch.configs import get_config

    gen = np.array(json.loads(proc.stdout.strip().splitlines()[-1]))
    shape = (LM_LAUNCHER_BATCH, LM_LAUNCHER_GEN)
    check(gen.shape == shape and gen.dtype.kind == "i" and bool(
        ((gen >= 0) & (gen < get_config("gemma2-2b").vocab_size)).all()),
        f"lm launcher printed {gen.tolist()}")
    logged = [line for line in proc.stderr.splitlines()
              if "repro_torch.serve" in line]
    check(any("on cuda" in line for line in logged),
          f"lm launcher did not serve on cuda: {logged}")
    for line in logged:
        print(f"[lm] launcher: {line}")
    print(f"[lm] launcher {' '.join(LM_LAUNCHER)}: exit 0, a "
          f"{shape[0]} x {shape[1]} array of token ids in the vocabulary, "
          f"{wall:.1f} s in all (process start, import, weights, prefill, "
          f"decode); {card}")
    print(f"[timing] the LM phase took {time.perf_counter() - t_phase:.1f} s"
          f" ({card})")


def _train_bound(model, seqs: int, seq: int, n_micro: int, peak: float):
    """The least time of one training step of ``seqs`` sequences of ``seq``
    tokens in ``n_micro`` microbatches: the larger of its operations over
    ``peak`` and its bytes over PEAK_BYTES.  Operations, per token: 2 x the
    weights of every product (the layers' matrices and the head) forward,
    twice that backward, once more for the layers' products under remat
    (the recompute); attention 4 x heads x head_dim for every (query, key)
    pair the masks let through, forward, twice that backward and once more
    under remat.  Bytes: the optimizer's pass (parameter, gradient and
    float32 ``v`` read and written, bfloat16 ``m`` read and written), every
    float32 weight read by each microbatch's forward, backward and
    recompute, the float32 logits written and read back.  A shared block's
    weights count once for each position that runs it, a MoE's routed
    experts top_k of n_experts, and the recurrent mixers add their chunked
    or stepwise work (``_recurrent_ops``) in each pass.  Returns
    ``(ms, "bytes" or "operations", operations, bytes)``."""
    import math

    cfg = model.cfg
    tokens = seqs * seq
    layers = head = 0
    for name, decl in model.layer_table().items():
        size = math.prod(decl.shape)
        if name == "unembed" or (name == "embed/tokens"
                                 and cfg.tie_embeddings):
            head += size
        elif _routed(name):
            layers += size * cfg.top_k / cfg.n_experts
        elif name.startswith("shared/") and len(decl.shape) > 1:
            layers += size * _kind_uses(cfg, name.split("/")[1])
        elif name.startswith("dec/") and len(decl.shape) > 1:
            layers += size
    passes = 3 + (1 if cfg.remat else 0)
    ops = 2 * tokens * (3 * head + passes * layers)
    window = cfg.window or float("inf")
    for kind in [k for r, ks in cfg.pattern for _ in range(r) for k in ks]:
        if kind in ("mamba", "mlstm", "slstm"):
            ops += passes * _recurrent_ops(cfg, kind, tokens, seq)[0]
            continue
        w = window if kind == "attn_local" else float("inf")
        pairs = sum(min(q + 1, w) for q in range(seq))
        ops += passes * 4 * seqs * cfg.n_heads * cfg.resolved_head_dim * pairs
    n = model.n_params()
    nbytes = (n * (4 + 4 + 4 + 2) * 2 + n * 4 * passes * n_micro
              + 2 * tokens * cfg.vocab_size * 4)
    by_ops, by_bytes = ops / peak, nbytes / PEAK_BYTES
    return (max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes", ops, nbytes)


def _train_counted(torch, tag, fn, capture, streams, launches):
    """One counted run (``_run_counted``) of a step: its launches recorded
    under ``tag`` and kept for the check against the plain versions.
    Returns ``(fn's output, the counts, the wall ms)``."""
    calls, plain = capture
    t = time.perf_counter()
    out, counts, got, _ = _run_counted(torch, "train", tag, fn, calls, plain,
                                       loggers=())
    wall = (time.perf_counter() - t) * 1e3
    launches[tag] = counts
    if any(got.values()):
        streams[tag] = dict(calls=got, counts=counts)
    return out, counts, wall


def _check_refresh(torch, key, gram, lam, vecs, opt):
    """One refreshed eigenpair set (the rows the solve filled) against
    float64 eigh of the matrix the refresh solved (``a = gram + eps I`` in
    float32): eigenvalues within phase 3's float32 gate (2e-4 of ||A||_2)
    and unit norms within 1e-4.  Its eigenvectors are not held to eigh's:
    EigenPre's grams lie far below scale 1, where repro's sign recovery
    (``tridiagonal_signs``: an off-diagonal under eps * max(scale, 1)
    takes sign +1) loses the signs, in both packages alike (ROADMAP.md
    Queue 3).  So the distances of its components ``|v[i, j]|^2``, its
    rank-k projector and its residual from eigh's are printed, and the
    same engine's top-k of ``a`` scaled by a power of two to a spectral
    norm near 1 (the same eigenvectors) is held instead: the components of
    each eigenvector whose eigenvalue lies at least TRAIN_GAP_MIN of
    ||A||_2 from every other within TRAIN_COMPONENT_TOL of eigh's (closer
    ones are beyond float32: a gram of ~1e-10 under ``eps I = 1e-6 I``
    keeps a few bits of itself).  Returns the distances."""
    d = gram.shape[0]
    k = min(opt.rank, d)
    a = gram + opt.eps * torch.eye(d, dtype=gram.dtype, device=gram.device)
    lam, vecs = lam[opt.rank - k:].double(), vecs[opt.rank - k:].double()
    w, v_ref = torch.linalg.eigh(a.double())
    top = v_ref[:, -k:]
    norm2 = float(w.abs().max())
    lam_err = float((lam - w[-k:]).abs().max()) / norm2
    nrm = float((vecs.norm(dim=-1) - 1).abs().max())
    check(lam_err <= 2e-4 and nrm <= 1e-4, f"train refresh {key}: "
          f"eigenvalue error {lam_err:.3e} of ||A||_2 (limit 2e-4), norms "
          f"off by {nrm:.3e} (limit 1e-4)")
    comp = float((vecs.square() - top.T.square()).abs().max())
    proj = float((vecs.T @ vecs - top @ top.T).abs().max())
    res = float((a.double() @ vecs.T - vecs.T * lam).norm(dim=0).max()
                / a.double().norm())
    scaled = opt._engine(a.device).topk(a * 2.0 ** -round(math.log2(norm2)),
                                        k).vectors.double()
    gaps = torch.stack([(w[-k:][i] - torch.cat([w[:d - k + i],
                                                w[d - k + i + 1:]])).abs()
                        .min() for i in range(k)]) / norm2
    apart = gaps >= TRAIN_GAP_MIN
    row_err = (scaled.square() - top.T.square()).abs().amax(dim=-1)
    comp1 = float(row_err[apart].max()) if bool(apart.any()) else 0.0
    check(comp1 <= TRAIN_COMPONENT_TOL, f"train refresh {key}: at unit "
          f"scale the components of the eigenvectors {apart.tolist()} "
          f"apart by {TRAIN_GAP_MIN:g} of ||A||_2 are {comp1:.3e} from "
          f"eigh's (limit {TRAIN_COMPONENT_TOL:g}); eigenvalues {w.tolist()}")
    print(f"[train] refresh {key}: eigenvalues {lam.tolist()}, relative gaps"
          f" {[f'{g:.2e}' for g in gaps.tolist()]}; at unit scale, "
          f"components |v|^2 from eigh's by row {[f'{e:.2e}' for e in row_err.tolist()]}"
          f" (gated where the gap is at least {TRAIN_GAP_MIN:g})")
    return lam_err, comp1, comp, proj, res


def _train_gemma(torch, dev, card, capture, streams, launches):
    """gemma2-2b at full width: TRAIN_STEPS float32 steps with EigenPre,
    then one bfloat16 step.  Returns the step record for the JSON line."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_synthetic
    from repro_torch.models import LanguageModel
    from repro_torch.optim import EigenPre
    from repro_torch.train import TrainState, make_train_step, put_batch

    cfg = get_config("gemma2-2b")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    model = LanguageModel(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    params = model.stacked_dict()
    opt = EigenPre()
    eligible = sorted(k for k, p in params.items() if opt._eligible(p))
    check(eligible == sorted(f"dec/g0/{b}/{ln}" for b in (
        "b0:attn_local", "b1:attn") for ln in ("ln1", "ln2"))
        and all(tuple(params[k].shape) == (13, 2304) for k in eligible),
        f"train: EigenPre's eligible gemma2-2b parameters {eligible}")
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    source = make_synthetic(cfg, ShapeConfig("train_4k", TRAIN_SEQ,
                                             TRAIN_BATCH, "train"), seed=SEED)
    step32 = make_train_step(model, opt, torch.float32,
                             microbatch=TRAIN_MICRO)
    torch.cuda.synchronize()
    print(f"[train] gemma2-2b: {model.n_params()} parameters drawn on the "
          f"card in {time.perf_counter() - t:.2f} s; EigenPre eligible: "
          f"{eligible}, each (13, 2304)")
    torch.cuda.reset_peak_memory_stats()
    walls, losses, gnorms, refreshed = [], [], [], {}
    for i in range(TRAIN_STEPS):
        batch = put_batch(source.global_batch_at(i), dev)
        tag = f"gemma2-2b step {i + 1}"
        (state, metrics), counts, wall = _train_counted(
            torch, tag, lambda: step32(state, batch), capture, streams,
            launches)
        walls.append(wall)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        check(all(map(math.isfinite, (losses[-1], gnorms[-1]))),
              f"{tag}: loss {losses[-1]}, grad norm {gnorms[-1]}")
        want = (2 * len(eligible), len(eligible)) if i == 0 else (0, 0)
        check((counts["sturm_bisect"], counts["logabs_sum"]) == want
              and counts["sturm_segmented"] == 0,
              f"{tag}: launches {counts}, expected (kernel 1, kernel 2) "
              f"{want}")
        if i == 0:
            refreshed = {k: (state.opt_state.gram[k],
                             state.opt_state.eigvals[k],
                             state.opt_state.eigvecs[k]) for k in eligible}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    worst = [max(x) for x in zip(*(_check_refresh(torch, k, *v, opt)
                                   for k, v in refreshed.items()))]
    norms = [float(torch.linalg.eigvalsh(g.double()).abs().max())
             for g, _, _ in refreshed.values()]
    grams = [state.opt_state.gram[k] for k in eligible]

    def refresh():
        for g in grams:
            opt._topk(g)

    refresh_ms = _events_ms(torch, refresh, 1, 5)
    bound_ms, bound_by, ops, nbytes = _train_bound(
        model, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, PEAK_OPS["float32"])
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[train] gemma2-2b float32, {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
          f"{TRAIN_MICRO} microbatches, remat {cfg.remat_policy}, EigenPre: "
          f"losses {losses}, grad norms {gnorms}; step ms "
          + ", ".join(f"{w:.1f}" for w in walls)
          + f" (step 1 refreshes) against a bound of {bound_ms:.1f} ms by "
          f"{bound_by} ({ops / 1e12:.2f} TFLOP, {nbytes / 1e9:.1f} GB), "
          f"{tokens * 1e3 / steady:.1f} tokens/s at the median of steps "
          f"2-{TRAIN_STEPS}; the refresh ({len(eligible)} top-{opt.rank} "
          f"solves of {sorted({tuple(g.shape) for g in grams})} float32 "
          f"grams) {refresh_ms:.3f} ms by CUDA events; peak memory {peak_gb:.2f} GB "
          f"(torch.cuda.max_memory_allocated); {card}")
    print(f"[train] step 1's refreshes against float64 eigh: worst "
          f"eigenvalue error {worst[0]:.3e} of ||A||_2 (limit 2e-4); the "
          f"grams' spectral norms {min(norms):.3e} to {max(norms):.3e}; at "
          f"unit scale the components |v|^2 of eigenvectors apart by "
          f"{TRAIN_GAP_MIN:g} {worst[1]:.3e} from eigh's (limit "
          f"{TRAIN_COMPONENT_TOL:g}); as refreshed (not gated, signs lost "
          f"below scale 1): components {worst[2]:.3e}, rank-{opt.rank} "
          f"projector {worst[3]:.3e}, residual {worst[4]:.3e} of ||A||_F")

    # One bfloat16 step against the float32 loss at the same state and
    # batch (a no-grad pass over the same microbatches).
    batch = put_batch(source.global_batch_at(TRAIN_STEPS), dev)
    rows = TRAIN_BATCH // TRAIN_MICRO
    with torch.no_grad():
        ref = sum(float(model.loss(model.unstack(state.params), {
            k: v[i * rows:(i + 1) * rows] for k, v in batch.items()})[0])
            for i in range(TRAIN_MICRO)) / TRAIN_MICRO
    step16 = make_train_step(model, opt, torch.bfloat16,
                             microbatch=TRAIN_MICRO)
    (state, m16), counts, wall16 = _train_counted(
        torch, "gemma2-2b bfloat16 step", lambda: step16(state, batch),
        capture, streams, launches)
    loss16 = float(m16["loss"])
    rel = abs(loss16 - ref) / abs(ref)
    check(math.isfinite(float(m16["grad_norm"])) and rel <= TRAIN_BF16_TOL
          and not any(counts.values()),
          f"gemma2-2b bfloat16 step: loss {loss16} vs float32 {ref} "
          f"({rel:.3e}, limit {TRAIN_BF16_TOL:g}), launches {counts}")
    print(f"[train] gemma2-2b bfloat16 step {TRAIN_STEPS + 1}: loss "
          f"{loss16:.6f} vs float32 {ref:.6f} at the same state and batch "
          f"({rel:.3e} relative, limit {TRAIN_BF16_TOL:g}); {wall16:.1f} ms; "
          f"{card}")
    return dict(ms=steady, walls=walls, bound_ms=bound_ms, bound_by=bound_by,
                tokens_per_s=tokens * 1e3 / steady, refresh_ms=refresh_ms,
                peak_gb=peak_gb, bf16_ms=wall16, losses=losses)


def _rel_leaf(torch, got, ref) -> float:
    ref = ref.double()
    return float((got.double() - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-30))


def _train_gates(torch, dev, card):
    """gemma2-2b at full width and depth 2, TRAIN_GATE_SEQ tokens: float32
    against float64, remat against none, microbatched against full batch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_synthetic
    from repro_torch.models import LanguageModel
    from repro_torch.train import put_batch
    from repro_torch.train.microbatch import accumulated_grads

    torch.cuda.empty_cache()
    base = dataclasses.replace(get_config("gemma2-2b"), n_layers=2,
                               pattern=((1, ("attn_local", "attn")),))
    batch = put_batch(make_synthetic(base, ShapeConfig(
        "t", TRAIN_GATE_SEQ, TRAIN_BATCH, "train"), seed=SEED)
        .global_batch_at(0), dev)
    models = {remat: LanguageModel(base.scaled(remat=remat), device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
        for remat in (True, False)}

    def grads(model, n_micro=1):
        loss, _, g = accumulated_grads(
            lambda p, b: model.loss(model.unstack(p), b),
            model.stacked_dict(), batch, n_micro)
        return float(loss), g

    loss_r, g_r = grads(models[True])
    loss_n, g_n = grads(models[False])
    loss_m, g_m = grads(models[True], TRAIN_MICRO)
    plain = models[False]
    leaves = {k: p.detach().double().requires_grad_()
              for k, p in plain.stacked_dict().items()}
    loss64, _ = plain.loss(plain.unstack(leaves), batch)
    loss64.backward()
    g64 = {k: v.grad for k, v in leaves.items()}
    loss64 = float(loss64.detach())
    rel_loss = abs(loss_n - loss64) / abs(loss64)
    err64 = max((_rel_leaf(torch, g_n[k], g64[k]), k) for k in g64)
    err_remat = max((_rel_leaf(torch, g_r[k], g_n[k]), k) for k in g_n)
    check(rel_loss <= TRAIN_F64_LOSS_TOL and err64[0] <= TRAIN_F64_GRAD_TOL,
          f"train depth 2: float32 loss {loss_n} vs float64 {loss64} "
          f"({rel_loss:.3e}), worst gradient {err64}")
    check(loss_r == loss_n and err_remat[0] <= TRAIN_REMAT_TOL,
          f"train depth 2: remat loss {loss_r} vs {loss_n}, worst gradient "
          f"{err_remat}")
    micro = 0.0
    for k in g_r:
        diff = (g_m[k] - g_r[k]).abs()
        bound = 2e-5 + 2e-4 * g_r[k].abs()
        check(bool((diff <= bound).all()), f"train depth 2: microbatched "
              f"gradient {k} off by {float((diff - bound).max()):.3e} beyond "
              f"rtol 2e-4, atol 2e-5")
        micro = max(micro, float(diff.max()))
    check(abs(loss_m - loss_r) <= 1e-5 * abs(loss_r),
          f"train depth 2: microbatched loss {loss_m} vs {loss_r}")
    print(f"[train] gemma2-2b at depth 2, full width, {TRAIN_BATCH} x "
          f"{TRAIN_GATE_SEQ} tokens: float32 loss {loss_n:.6f} vs float64 "
          f"{loss64:.6f} ({rel_loss:.3e} relative, limit "
          f"{TRAIN_F64_LOSS_TOL:g}); worst float32 gradient {err64[0]:.3e} "
          f"of max |g| from float64 ({err64[1]}; limit "
          f"{TRAIN_F64_GRAD_TOL:g}); remat all vs none: loss equal, worst "
          f"gradient {err_remat[0]:.3e} of max |g| (limit "
          f"{TRAIN_REMAT_TOL:g}); {TRAIN_MICRO} microbatches vs the full "
          f"batch: max |diff| {micro:.3e} (rtol 2e-4, atol 2e-5); {card}")


def _train_reduced(torch, dev, card, capture, streams, launches):
    """Reduced codeqwen1.5-7b, TRAIN_REDUCED_STEPS EigenPre steps on the
    repeating batches: the loss falls, kernels 1 and 2 launch at every
    refresh and at no other step."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_synthetic
    from repro_torch.models import LanguageModel
    from repro_torch.optim import AdamW, EigenPre
    from repro_torch.train import TrainState, make_train_step, put_batch

    cfg = reduced_config(get_config("codeqwen1.5-7b"))
    model = LanguageModel(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    opt = EigenPre(adamw=AdamW(lr=3e-3, weight_decay=0.0), rank=2,
                   refresh_every=10)
    params = model.stacked_dict()
    eligible = [k for k, p in params.items() if opt._eligible(p)]
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    step = make_train_step(model, opt, torch.float32)
    source = make_synthetic(cfg, ShapeConfig("t", 16, 4, "train"), seed=0)
    losses, refreshes = [], 0
    for i in range(TRAIN_REDUCED_STEPS):
        batch = put_batch(source.global_batch_at(i % 4), dev)
        refresh = i % opt.refresh_every == 0
        tag = f"codeqwen reduced step {i + 1}"
        (state, metrics), counts, _ = _train_counted(
            torch, tag, lambda: step(state, batch), capture, streams,
            launches)
        want = (2 * len(eligible), len(eligible)) if refresh else (0, 0)
        check((counts["sturm_bisect"], counts["logabs_sum"]) == want,
              f"{tag}: launches {counts}, expected {want}")
        refreshes += refresh
        losses.append(float(metrics["loss"]))
    check(all(map(math.isfinite, losses))
          and losses[-1] < losses[0] - TRAIN_REDUCED_DROP,
          f"codeqwen reduced: losses {losses[::6]}")
    print(f"[train] reduced codeqwen1.5-7b, {TRAIN_REDUCED_STEPS} EigenPre "
          f"steps (rank 2, refresh every 10; eligible {eligible}): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (must fall by "
          f"{TRAIN_REDUCED_DROP:g}); kernels 1 and 2 launched at each of the "
          f"{refreshes} refreshes and at no other step; {card}")


def _train_launcher(torch, card):
    """``launch/train.py`` in subprocesses on the card: a run with
    checkpoints, its resume, and a run sent SIGTERM mid-stream."""
    import os
    import shutil
    import signal
    import tempfile
    import threading

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    (root / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="train-", dir=root / "build"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "gemma2-2b", "--reduced", "--eigenpre"]
    try:
        ckpt = work / "run"
        args = cmd + ["--ckpt-dir", str(ckpt), "--ckpt-every",
                      str(TRAIN_LAUNCHER_EVERY), "--log-every",
                      str(TRAIN_LAUNCHER_EVERY)]
        logs = []
        for extra in (["--steps", str(TRAIN_LAUNCHER_STEPS)],
                      ["--steps", str(TRAIN_LAUNCHER_RESUME_TO),
                       "--resume"]):
            t = time.perf_counter()
            proc = subprocess.run(args + extra, cwd=root, env=env,
                                  capture_output=True, text=True,
                                  timeout=TRAIN_LAUNCHER_TIMEOUT_S)
            check(proc.returncode == 0, f"train launcher {extra} exited "
                  f"{proc.returncode}: {proc.stderr[-2000:]}")
            check("on cuda" in proc.stderr, f"train launcher {extra} did "
                  f"not train on cuda: {proc.stderr[-2000:]}")
            logs.append((extra, time.perf_counter() - t, proc.stderr))
        resumed = logs[1][2]
        check(f"resumed at step {TRAIN_LAUNCHER_STEPS}" in resumed
              and f"done: {TRAIN_LAUNCHER_RESUME_TO} steps" in resumed,
              f"train launcher --resume: {resumed[-2000:]}")
        kept = sorted(int(p.name[5:]) for p in (ckpt / "gemma2-2b-smoke")
                      .glob("step-*"))
        check(kept[-1] == TRAIN_LAUNCHER_RESUME_TO and len(kept) == 3,
              f"train launcher: checkpoints {kept}")
        for extra, wall, log in logs:
            for line in log.splitlines():
                if "repro_torch.train" in line:
                    print(f"[train] launcher {' '.join(extra)}: {line}")
            print(f"[train] launcher {' '.join(extra)}: exit 0 in {wall:.1f} s")

        # SIGTERM after TRAIN_SIGTERM_AFTER logged steps.
        ckpt = work / "sigterm"
        proc = subprocess.Popen(
            cmd + ["--steps", "1000000", "--ckpt-every", "1000000",
                   "--log-every", "1", "--ckpt-dir", str(ckpt)],
            cwd=root, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        timer = threading.Timer(TRAIN_LAUNCHER_TIMEOUT_S, proc.kill)
        timer.start()
        try:
            seen, lines = 0, []
            for line in proc.stderr:
                lines.append(line)
                seen += " loss " in line
                if seen >= TRAIN_SIGTERM_AFTER:
                    break
            proc.send_signal(signal.SIGTERM)
            lines.append(proc.stderr.read())
            rc = proc.wait()
        finally:
            timer.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        log = "".join(lines)
        import re

        got = re.search(r"Preempted: checkpointed at step (\d+)", log)
        check(rc == 1 and got is not None
              and "preemption signal 15 received" in log,
              f"train launcher SIGTERM: exit {rc}: {log[-2000:]}")
        at = int(got.group(1))
        saved = ckpt / "gemma2-2b-smoke" / f"step-{at}" / "manifest.json"
        check(at >= TRAIN_SIGTERM_AFTER and saved.exists(),
              f"train launcher SIGTERM: no checkpoint at step {at}")
        print(f"[train] launcher sent SIGTERM after {TRAIN_SIGTERM_AFTER} "
              f"logged steps: a blocking checkpoint at step {at}, then "
              f"Preempted, exit {rc}; {card}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _phase_train(torch, dev):
    """15. The trainer: gemma2-2b at full width with EigenPre (its refresh
    launching kernels 1 and 2), the depth-2 gates, reduced codeqwen's 30
    EigenPre steps, and ``launch/train.py`` in subprocesses.  Every launch
    count is set to 0 just before each step and read just after; every
    launch is held against its plain version afterwards.  Returns each
    wrapper's launches, summed by part."""
    card = _gpu_name_and_limit()
    print(f"[train] phase 15 on {card}")
    t_phase = time.perf_counter()
    calls, plain, undo = _arm_server_capture()
    streams, launches = {}, {}
    try:
        record = _train_gemma(torch, dev, card, (calls, plain), streams,
                              launches)
        _train_gates(torch, dev, card)
        _train_reduced(torch, dev, card, (calls, plain), streams, launches)
    finally:
        undo()
    _hold_grouped(torch, "train", streams, {key: [] for key in _PLAINS})
    torch.cuda.empty_cache()
    _train_launcher(torch, card)
    parts = {"gemma2-2b step 1": ["gemma2-2b step 1"],
             "gemma2-2b steps 2-3": [f"gemma2-2b step {i}"
                                     for i in range(2, TRAIN_STEPS + 1)],
             "gemma2-2b bfloat16 step": ["gemma2-2b bfloat16 step"],
             "codeqwen reduced, 30 steps": [
                 t for t in launches if t.startswith("codeqwen")]}
    summed = {part: {key: sum(launches[t][key] for t in tags)
                     for key in launches[tags[0]]}
              for part, tags in parts.items()}
    print(f"[train] launches by part: {summed}")
    print(f"[timing] the train phase took {time.perf_counter() - t_phase:.1f}"
          f" s with its checks ({card})")
    return summed, record


def _period(cfg):
    """``cfg`` cut to one period of each pattern entry: every block kind in
    its published ratio, the widths unchanged."""
    import dataclasses

    pattern = tuple((1, kinds) for _, kinds in cfg.pattern)
    return dataclasses.replace(cfg, pattern=pattern,
                               n_layers=sum(len(k) for _, k in pattern))


def _fam_serve_whole(torch, dev, card, name):
    """``name`` whole at full width: float32 then bfloat16 served.  The
    float64, consistency and bfloat16 gates run at full depth for the
    configs of FAM_GATE_WHOLE and at one period for the others, whose
    whole random-weight model is too ill-conditioned for any comparison of
    two orders of rounding (its attention is as sharp as whisper's,
    ``_lm_whisper``): there the distances at full depth, and float64's own
    move under a 2**-24 nudge of the embedding, are printed."""
    from repro_torch.configs import get_config
    from repro_torch.train.steps import cast_tree

    cfg, prompt = get_config(name), FAM_PROMPT
    model, batch = _lm_build(torch, dev, cfg, prompt, tag="families")
    p32 = model.param_dict()
    logits, tokens = _lm_serve(torch, model, p32, batch, prompt,
                               f"{name} float32", 4, PEAK_OPS["float32"],
                               card, "families")
    pb = cast_tree(p32, torch.bfloat16)
    logits_b, tokens_b = _lm_serve(torch, model, pb, batch, prompt,
                                   f"{name} bfloat16", 2, PEAK_BF16, card,
                                   "families")
    err_b = _lm_rel(torch, logits_b[0], logits[0])
    print(f"[families] {name} at full depth: bfloat16 prefill logits "
          f"{err_b:.3e} of max |logit| from float32; "
          f"{int((tokens_b == tokens).sum())} of {tokens.numel()} greedy "
          f"tokens as in float32")
    del pb, logits_b
    if name not in FAM_GATE_WHOLE:
        exact = _lm_exact(torch, model, p32, batch, prompt)
        p64 = cast_tree(p32, torch.float64)
        p64["embed/tokens"] = p64["embed/tokens"] * (1 + 2.0 ** -24)
        moved = model.prefill(p64, batch, prompt + LM_GEN)[0]
        del p64
        print(f"[families] {name} at full depth (not gated): prefill "
              f"float32 vs float64 {_lm_rel(torch, logits[0], exact):.3e} "
              f"of max |logit|; float64 with the embedding x (1 + 2**-24) "
              f"vs float64 {_lm_rel(torch, moved, exact):.3e}")
        del exact, moved, model, p32
        model, batch = _lm_build(torch, dev, _period(cfg), prompt,
                                 tag="families")
        p32 = model.param_dict()
        logits = model.prefill(p32, batch, prompt + LM_GEN)[0][None]
        logits_b = model.prefill(cast_tree(p32, torch.bfloat16), batch,
                                 prompt + LM_GEN)[0]
        err_b = _lm_rel(torch, logits_b, logits[0])
    what = (name if name in FAM_GATE_WHOLE
            else f"{name} at one period ({model.cfg.n_layers} blocks)")
    check(err_b <= LM_BF16_TOL, f"{what}: bfloat16 prefill logits "
          f"{err_b:.3e} of max |logit| from float32 (limit {LM_BF16_TOL:g})")
    print(f"[families] {what} bfloat16 gate: prefill logits {err_b:.3e} of "
          f"max |logit| from float32 (limit {LM_BF16_TOL:g})")
    _lm_gates(torch, model, batch, prompt, what, "families")


def _fam_serve_moe(torch, dev, card, name):
    """``name`` at one period of its pattern, full width, all experts, in
    bfloat16: served, the loss finite; its float32 gates at reduced
    width."""
    from repro_torch.configs import get_config, reduced_config

    cfg, prompt = _period(get_config(name)), FAM_MOE_PROMPT
    model, batch = _lm_build(torch, dev, cfg, prompt, torch.bfloat16,
                             "families")
    params = model.param_dict()
    _lm_serve(torch, model, params, batch, prompt,
              f"{name} one period ({cfg.n_layers} blocks) bfloat16", 2,
              PEAK_BF16, card, "families")
    loss, metrics = model.loss(params, batch)
    check(math.isfinite(float(loss)) and math.isfinite(float(metrics["aux"])),
          f"{name}: loss {float(loss)}, aux {float(metrics['aux'])}")
    print(f"[families] {name} one period bfloat16: loss {float(loss):.4f} "
          f"(aux {float(metrics['aux']):.4f}) on the {LM_BATCH} x {prompt} "
          f"prompts")
    del model, params
    red = reduced_config(get_config(name))
    model, batch = _lm_build(torch, dev, red, FAM_REDUCED_PROMPT,
                             tag="families")
    _lm_gates(torch, model, batch, FAM_REDUCED_PROMPT, f"reduced {name}",
              "families")


def _fam_slstm_scan(torch, dev, card):
    """xlstm-125m's sLSTM loop at full width on the card, FAM_SCAN_STEPS
    steps of a batch of 1: the scan (a CUDA graph replay a step, its own
    backward) against autograd through the eager loop of the same cell,
    the outputs and the final carry equal and the gradients within
    FAM_SCAN_TOL of each one's max; both timed, synchronized."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks, xlstm

    cfg = blocks.slstm_config(get_config("xlstm-125m"))
    d, nh = cfg.d_model, cfg.n_heads
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def draw(*shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).requires_grad_()

    leaves = [draw(1, FAM_SCAN_STEPS, 4 * d, scale=1.0),
              draw(nh, d // nh, 4 * d // nh, scale=(nh / d) ** 0.5),
              draw(4 * d, scale=0.1)]
    carry = xlstm.slstm_init_carry(cfg, 1, dev)
    weight = torch.randn((1, FAM_SCAN_STEPS, d), generator=gen, device=dev)

    def loop(cfg, wx, r, b, carry):
        h, c, n, m = carry
        hs = []
        for t in range(wx.shape[1]):
            h, c, n, m = xlstm._cell(xlstm._gates(cfg, wx[:, t], h, r, b),
                                     c, n, m)
            hs.append(h)
        return torch.stack(hs, 1), (h, c, n, m)

    runs = {}
    for name, fn in (("scan", xlstm._slstm_scan), ("autograd loop", loop)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        hs, out = fn(cfg, *leaves, carry)
        grads = torch.autograd.grad((hs * weight).sum(), leaves)
        torch.cuda.synchronize()
        runs[name] = (hs.detach(), out, grads, time.perf_counter() - t)
    (hs, out, grads, t_scan), (hs_r, out_r, grads_r, t_loop) = runs.values()
    same = bool(torch.equal(hs, hs_r)) and all(
        torch.equal(x, y) for x, y in zip(out, out_r))
    errs = [_rel_leaf(torch, g, r) for g, r in zip(grads, grads_r)]
    check(same and max(errs) <= FAM_SCAN_TOL, f"sLSTM scan: outputs equal "
          f"{same}, gradient errors {errs} (limit {FAM_SCAN_TOL:g})")
    print(f"[families] xlstm-125m's sLSTM, {FAM_SCAN_STEPS} steps at d = {d}"
          f": the scan (graph replays, own backward) {t_scan * 1e3:.1f} ms "
          f"forward and backward against autograd through the eager loop "
          f"{t_loop * 1e3:.1f} ms; outputs and carry equal, gradients "
          f"{max(errs):.3e} of max |g| apart (limit {FAM_SCAN_TOL:g}); "
          f"{card}")


def _fam_train(torch, dev, card, capture, streams, launches, name):
    """``name`` at full width: TRAIN_STEPS float32 EigenPre steps (as
    ``_train_gemma``), step 1's refresh held as phase 15 holds it.  Returns
    the step record."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_synthetic
    from repro_torch.models import LanguageModel
    from repro_torch.optim import EigenPre
    from repro_torch.train import TrainState, make_train_step, put_batch

    cfg = get_config(name)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    model = LanguageModel(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    params = model.stacked_dict()
    opt = EigenPre()
    eligible = sorted(k for k, p in params.items() if opt._eligible(p))
    n_keys, rows = FAM_ELIGIBLE[name]
    check(len(eligible) == n_keys
          and all(params[k].shape[0] == rows for k in eligible),
          f"families: EigenPre's eligible {name} parameters {eligible}")
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    source = make_synthetic(cfg, ShapeConfig("train_4k", TRAIN_SEQ,
                                             TRAIN_BATCH, "train"), seed=SEED)
    step32 = make_train_step(model, opt, torch.float32,
                             microbatch=TRAIN_MICRO)
    torch.cuda.synchronize()
    print(f"[families] {name}: {model.n_params()} parameters drawn on the "
          f"card in {time.perf_counter() - t:.2f} s; EigenPre eligible: "
          f"{len(eligible)} stacked keys of {rows} rows")
    torch.cuda.reset_peak_memory_stats()
    walls, losses, gnorms, refreshed = [], [], [], {}
    for i in range(TRAIN_STEPS):
        batch = put_batch(source.global_batch_at(i), dev)
        tag = f"{name} step {i + 1}"
        (state, metrics), counts, wall = _train_counted(
            torch, tag, lambda: step32(state, batch), capture, streams,
            launches)
        walls.append(wall)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        check(all(map(math.isfinite, (losses[-1], gnorms[-1]))),
              f"{tag}: loss {losses[-1]}, grad norm {gnorms[-1]}")
        want = (2 * len(eligible), len(eligible)) if i == 0 else (0, 0)
        check((counts["sturm_bisect"], counts["logabs_sum"]) == want
              and counts["sturm_segmented"] == 0,
              f"{tag}: launches {counts}, expected (kernel 1, kernel 2) "
              f"{want}")
        if i == 0:
            refreshed = {k: (state.opt_state.gram[k],
                             state.opt_state.eigvals[k],
                             state.opt_state.eigvecs[k]) for k in eligible}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    worst = [max(x) for x in zip(*(_check_refresh(torch, k, *v, opt)
                                   for k, v in refreshed.items()))]
    grams = [state.opt_state.gram[k] for k in eligible]

    def refresh():
        for g in grams:
            opt._topk(g)

    refresh_ms = _events_ms(torch, refresh, 1, 3)
    bound_ms, bound_by, ops, nbytes = _train_bound(
        model, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, PEAK_OPS["float32"])
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[families] {name} float32, {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
          f"in {TRAIN_MICRO} microbatches, remat {cfg.remat_policy}, "
          f"EigenPre: losses {losses}, grad norms {gnorms}; step ms "
          + ", ".join(f"{w:.1f}" for w in walls)
          + f" (step 1 refreshes) against a bound of {bound_ms:.1f} ms by "
          f"{bound_by} ({ops / 1e12:.2f} TFLOP, {nbytes / 1e9:.1f} GB), "
          f"{tokens * 1e3 / steady:.1f} tokens/s at the median of steps "
          f"2-{TRAIN_STEPS}; the refresh ({len(eligible)} top-{opt.rank} "
          f"solves of {sorted({tuple(g.shape) for g in grams})} float32 "
          f"grams) {refresh_ms:.3f} ms by CUDA events; peak memory "
          f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated); {card}")
    print(f"[families] {name} step 1's refreshes against float64 eigh: "
          f"worst eigenvalue error {worst[0]:.3e} of ||A||_2 (limit 2e-4); "
          f"at unit scale the components |v|^2 of eigenvectors apart by "
          f"{TRAIN_GAP_MIN:g} {worst[1]:.3e} from eigh's (limit "
          f"{TRAIN_COMPONENT_TOL:g}); as refreshed (not gated): components "
          f"{worst[2]:.3e}, rank-{opt.rank} projector {worst[3]:.3e}, "
          f"residual {worst[4]:.3e} of ||A||_F")
    return dict(ms=steady, walls=walls, bound_ms=bound_ms, bound_by=bound_by,
                tokens_per_s=tokens * 1e3 / steady, refresh_ms=refresh_ms,
                peak_gb=peak_gb)


def _fam_train_reduced(torch, dev, card, name):
    """Reduced ``name``, FAM_REDUCED_STEPS AdamW steps on repro's repeating
    batches: the loss falls by FAM_REDUCED_DROP; no kernel launches."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_synthetic
    from repro_torch.models import LanguageModel
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainState, make_train_step, put_batch

    cfg = reduced_config(get_config(name))
    model = LanguageModel(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    opt = AdamW(lr=3e-3, weight_decay=0.0)
    params = model.stacked_dict()
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    step = make_train_step(model, opt, torch.float32)
    source = make_synthetic(cfg, ShapeConfig("t", 16, 4, "train"), seed=0)
    losses = []
    _reset_counts()
    t = time.perf_counter()
    for i in range(FAM_REDUCED_STEPS):
        state, metrics = step(state, put_batch(
            source.global_batch_at(i % 4), dev))
        losses.append(float(metrics["loss"]))
    wall = time.perf_counter() - t
    counts = _read_counts()
    check(not any(counts.values()), f"reduced {name} AdamW: launches "
          f"{counts}")
    check(all(map(math.isfinite, losses))
          and losses[-1] < losses[0] - FAM_REDUCED_DROP,
          f"reduced {name}: losses {losses[::5]}")
    print(f"[families] reduced {name}, {FAM_REDUCED_STEPS} AdamW steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (must fall by "
          f"{FAM_REDUCED_DROP:g}) in {wall:.1f} s; {card}")


def _phase_families(torch, dev):
    """16. The other block families at published width: Mamba2 with
    zamba2's shared attention, mLSTM and sLSTM, MoE, MLA.  Serving
    (``_fam_serve_whole``, ``_fam_serve_moe``) launches no kernel of the
    repo; training zamba2 and xlstm with EigenPre launches kernels 1 and 2
    at step 1's refresh, each launch held against its plain version.
    Returns each wrapper's launches, summed by part."""
    card = _gpu_name_and_limit()
    print(f"[families] phase 16 on {card}")
    t_phase = time.perf_counter()
    _reset_counts()
    with torch.inference_mode():
        for name in FAM_WHOLE:
            _fam_serve_whole(torch, dev, card, name)
        for name in FAM_MOE:
            _fam_serve_moe(torch, dev, card, name)
    counts = _read_counts()
    check(not any(counts.values()), f"families: the serving path launched "
          f"a kernel of the repo: {counts}")
    print(f"[timing] the families' serving took "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    _fam_slstm_scan(torch, dev, card)
    calls, plain, undo = _arm_server_capture()
    streams, launches = {}, {}
    try:
        for name in FAM_WHOLE:
            _fam_train(torch, dev, card, (calls, plain), streams, launches,
                       name)
            torch.cuda.empty_cache()
        for name in FAM_MOE:
            _fam_train_reduced(torch, dev, card, name)
    finally:
        undo()
    _hold_grouped(torch, "families", streams, {key: [] for key in _PLAINS})
    torch.cuda.empty_cache()
    parts = {}
    for name in FAM_WHOLE:
        parts[f"{name} step 1"] = [f"{name} step 1"]
        parts[f"{name} steps 2-{TRAIN_STEPS}"] = [
            f"{name} step {i}" for i in range(2, TRAIN_STEPS + 1)]
    summed = {part: {key: sum(launches[t][key] for t in tags)
                     for key in launches[tags[0]]}
              for part, tags in parts.items()}
    print(f"[families] launches by part: {summed}")
    print(f"[timing] the families phase took "
          f"{time.perf_counter() - t_phase:.1f} s with its checks ({card})")
    return summed


def _mesh_of(spec: str, dev):
    from repro_torch.launch.mesh import parse_mesh

    return parse_mesh(spec, dev)


def _mesh_serve(torch, progs, params, batch, prompt, toks, stats=None):
    """The mesh's prefill (timed after a warm-up; ``stats`` collects its
    MoE's dropped pairs), then LM_GEN - 1 decode steps fed the unsharded
    path's greedy tokens ``toks`` (B, LM_GEN).  Returns the logits of every
    step (LM_GEN, B, V), the caches, the prefill's wall ms and the decode's
    wall ms a step, synchronized."""
    progs.prefill(params, batch, prompt + LM_GEN)  # lazy modules, cuBLAS
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, caches = progs.prefill(params, batch, prompt + LM_GEN,
                                   stats=stats)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    out = [logits]
    t = time.perf_counter()
    for i in range(LM_GEN - 1):
        logits, caches = progs.decode_step(params, caches, toks[:, i],
                                           prompt + i)
        out.append(logits)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / (LM_GEN - 1)
    return torch.stack(out), caches, prefill_ms, decode_ms


def _mesh_gemma_serve(torch, dev, card):
    """gemma2-2b at full width, float32, on MESH_SERVE: every step's logits
    within MESH_TOL of max |logit| of the unsharded path (phase 14's), the
    mesh fed the unsharded path's greedy tokens; times, peak memory and
    the bytes each mesh position holds beside the unsharded path's."""
    from repro_torch.configs import get_config
    from repro_torch.sharding.placement import device_bytes, put_tree
    from repro_torch.train.steps import build_programs

    cfg, prompt = get_config("gemma2-2b"), LM_GEMMA_PROMPT
    model, batch = _lm_build(torch, dev, cfg, prompt, tag="mesh")
    params = model.param_dict()
    model.prefill(params, batch, prompt + LM_GEN)
    torch.cuda.reset_peak_memory_stats()
    ref, toks, pre1, dec1 = _lm_generate(torch, model, params, batch, prompt)
    peak1 = torch.cuda.max_memory_allocated() / 1e9
    print(f"[mesh] gemma2-2b float32 unsharded (LanguageModel): prefill "
          f"{pre1:.1f} ms, decode {dec1:.3f} ms a token, peak memory "
          f"{peak1:.2f} GB; {card}")
    del params
    stacked = model.stacked_dict()
    for spec in MESH_SERVE:
        mesh = _mesh_of(spec, dev)
        progs = build_programs(model, mesh, fsdp=False,
                               compute_dtype=torch.float32)
        placed = put_tree(stacked, progs.state_shardings.params)
        torch.cuda.reset_peak_memory_stats()
        run = _mesh_serve(torch, progs, placed, batch, prompt, toks)
        peak = torch.cuda.max_memory_allocated() / 1e9
        logits, caches, pre, dec = run
        errs = [_lm_rel(torch, a, b) for a, b in zip(logits, ref)]
        check(bool(torch.isfinite(logits).all()) and max(errs) <= MESH_TOL,
              f"mesh gemma2-2b {spec}: logits {max(errs):.3e} of max |logit| "
              f"from the unsharded path (limit {MESH_TOL:g})")
        same = int((logits.argmax(-1) == ref.argmax(-1)).sum())
        pb, cb = device_bytes(placed, mesh), device_bytes(caches, mesh)
        print(f"[mesh] gemma2-2b float32 {spec}: prefill {pre:.1f} ms "
              f"({pre / pre1:.2f}x unsharded), decode {dec:.3f} ms a token "
              f"({dec / dec1:.2f}x); logits {max(errs):.3e} of max |logit| "
              f"from the unsharded path at worst over the prefill and "
              f"{LM_GEN - 1} steps (limit {MESH_TOL:g}), {same} of "
              f"{ref[..., 0].numel()} argmaxes as unsharded; peak memory "
              f"{peak:.2f} GB; bytes a position: parameters {pb}, caches "
              f"{cb}; {card}")
        del progs, placed, run, logits, caches
        torch.cuda.empty_cache()
    del model, stacked
    torch.cuda.empty_cache()


def _drops(stats) -> list:
    """The dropped (token, choice) pairs of each routing in ``stats``."""
    return [int(d) for d in stats["moe_dropped"]]


def _mesh_deepseek_serve(torch, dev, card):
    """deepseek-v3-671b at one period of its pattern, all 256 experts,
    prompts of FAM_MOE_PROMPT, on 1x2 against its unsharded path on the
    same weights, the mesh fed the unsharded path's greedy tokens:

    * bfloat16: every step's logits within MESH_BF16_TOL of max |logit|.
      The (token, choice) pairs the prefill's MoE drops past capacity are
      printed, not gated: its inputs differ from the unsharded path's by
      bfloat16 roundings of sums taken in another order, and a token near
      a routing tie may then pick another expert.
    * float32: every step's logits within MESH_TOL, and the prefill's MoE
      drops exactly the unsharded path's count.  (2x1 would hold the
      float32 experts once a row, 2 x 45 GB: :func:`_mesh_moe_rows` holds
      the MoE layer alone there.)

    The weights are placed on the mesh one tensor at a time, each dropped
    from the model as it is placed."""
    from repro_torch.configs import get_config
    from repro_torch.sharding.placement import device_bytes, put
    from repro_torch.train.steps import build_programs

    cfg, prompt = _period(get_config("deepseek-v3-671b")), FAM_MOE_PROMPT
    smax = prompt + LM_GEN
    name = f"deepseek-v3-671b one period ({cfg.n_layers} blocks)"
    mesh = _mesh_of("1x2", dev)
    for dtype, tol in ((torch.bfloat16, MESH_BF16_TOL),
                       (torch.float32, MESH_TOL)):
        what = f"{name} {str(dtype).split('.')[1]} 1x2"
        model, batch = _lm_build(torch, dev, cfg, prompt, dtype, "mesh")
        params = model.param_dict()
        model.prefill(params, batch, smax)
        ref, toks, pre1, dec1 = _lm_generate(torch, model, params, batch,
                                             prompt)
        stats1 = {}
        model.prefill(params, batch, smax, stats=stats1)
        drops1 = _drops(stats1)
        del params
        progs = build_programs(model, mesh, fsdp=False, compute_dtype=dtype)
        shardings = progs.state_shardings.params
        stacked = model.stacked_dict()
        model.release()
        placed = {k: put(stacked.pop(k), shardings[k]) for k in list(stacked)}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        logits, caches, pre, dec = _mesh_serve(torch, progs, placed, batch,
                                               prompt, toks, stats)
        peak = torch.cuda.max_memory_allocated() / 1e9
        drops = _drops(stats)
        errs = [_lm_rel(torch, a, b) for a, b in zip(logits, ref)]
        same = int((logits.argmax(-1) == ref.argmax(-1)).sum())
        pb, cb = device_bytes(placed, mesh), device_bytes(caches, mesh)
        print(f"[mesh] {what}: prefill {pre:.1f} ms (unsharded {pre1:.1f}), "
              f"decode {dec:.3f} ms a token (unsharded {dec1:.3f}); logits "
              f"{max(errs):.3e} of max |logit| from the unsharded path at "
              f"worst (limit {tol:g}; by step {[f'{e:.1e}' for e in errs]}), "
              f"{same} of {ref[..., 0].numel()} argmaxes as unsharded; the "
              f"prefill's MoE drops {drops} (token, choice) pairs, the "
              f"unsharded path {drops1}"
              f"{' (gated equal)' if dtype == torch.float32 else ''}; peak "
              f"memory {peak:.2f} GB; bytes a position: parameters {pb}, "
              f"caches {cb}; {card}")
        check(bool(torch.isfinite(logits).all()) and max(errs) <= tol,
              f"mesh {what}: logits {max(errs):.3e} of max |logit| from the "
              f"unsharded path (limit {tol:g})")
        if dtype == torch.float32:
            check(drops == drops1 and sum(drops1) > 0,
                  f"mesh {what}: the MoE dropped {drops} (token, choice) "
                  f"pairs, the unsharded path {drops1}")
        del progs, placed, caches, logits, model, stacked, batch
        torch.cuda.empty_cache()
    _mesh_moe_rows(torch, cfg, dev, card)


def _mesh_moe_rows(torch, cfg, dev, card):
    """``cfg``'s MoE layer at full width, float32, drawn from SEED, over a
    logical 2x1 mesh (``moe.moe_rows``; the TP rules replicate the experts
    on each row, and on the one card both rows read the same tensors)
    against the unsharded layer (``moe.moe``) on the same seeded tokens,
    for MESH_MOE_SEQS tokens a row: the dropped (token, choice) pairs
    equal and the outputs within MESH_TOL of max |y|.  Where a routing
    group straddles the rows, the rows' tokens are routed together; routing
    each row as a batch of its own (a group size from the row's token
    count) drops another count, and the check requires that it does, so
    that the case tells the global grouping from a per-row one."""
    from repro_torch.models import blocks, moe
    from repro_torch.models.params import init_std
    from repro_torch.sharding.placement import Split

    mcfg = blocks.moe_config(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    layer = {n: torch.randn(d.shape, generator=gen, device=dev).mul_(
                 init_std(d))
             for n, d in sorted(moe.moe_param_table(mcfg).items())}
    rows = ((dev,), (dev,))
    ps = [{n: Split((w,), None) for n, w in layer.items()}] * 2
    for seq in MESH_MOE_SEQS:
        x = torch.randn(2, seq, cfg.d_model, generator=gen, device=dev)
        s_rows, s_whole, s_own = {}, {}, {}
        ys, _ = moe.moe_rows(mcfg, ps, [x[:1], x[1:]], rows, s_rows)
        y, _ = moe.moe(mcfg, layer, x, s_whole)
        for r in range(2):
            moe.moe(mcfg, layer, x[r:r + 1], s_own)
        err = _lm_rel(torch, torch.cat(ys), y)
        n_rows, n_whole = _drops(s_rows), _drops(s_whole)
        n_own = sum(_drops(s_own))
        g = moe.group_size(mcfg, 2 * seq)
        straddles = seq % g != 0
        print(f"[mesh] deepseek-v3-671b MoE layer float32 2x1, {seq} tokens "
              f"a row (routing groups of {g}"
              f"{', one straddling the rows' if straddles else ''}): drops "
              f"{n_rows} (token, choice) pairs, the unsharded layer "
              f"{n_whole}, each row routed alone {n_own}; outputs "
              f"{err:.3e} of max |y| from the unsharded layer (limit "
              f"{MESH_TOL:g}); {card}")
        check(n_rows == n_whole and n_whole[0] > 0 and err <= MESH_TOL
              and (not straddles or n_own != n_whole[0]),
              f"mesh deepseek MoE 2x1 at {seq} tokens a row: drops "
              f"{n_rows}, unsharded {n_whole}, rows alone {n_own}; "
              f"outputs {err:.3e} (limit {MESH_TOL:g})")
        del x, ys, y
    del layer, ps
    torch.cuda.empty_cache()


def _mesh_gemma_train(torch, dev, card, capture, streams, launches, ref):
    """gemma2-2b at full width, TRAIN_STEPS float32 EigenPre steps on each
    of MESH_TRAIN (1x2 under TP in TRAIN_MICRO microbatches, 2x1 under
    FSDP a row a sequence) from phase 15's initialization and
    batches: each loss within MESH_LOSS_TOL (relative) of the unsharded
    run's (``ref``: its ``losses`` and step ``walls``); step 1's refresh
    launches kernels 1 and 2 on the mesh's first device (held against
    their plain versions by the caller), later steps none."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_synthetic
    from repro_torch.models import LanguageModel
    from repro_torch.optim import EigenPre
    from repro_torch.sharding.placement import device_bytes, put_tree
    from repro_torch.train import TrainState, put_batch
    from repro_torch.train.steps import build_programs

    cfg = get_config("gemma2-2b")
    source = make_synthetic(cfg, ShapeConfig("train_4k", TRAIN_SEQ,
                                             TRAIN_BATCH, "train"), seed=SEED)
    out = {}
    for spec, fsdp, micro in MESH_TRAIN:
        torch.cuda.empty_cache()
        model = LanguageModel(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(SEED))
        opt = EigenPre()
        params = model.stacked_dict()
        mesh = _mesh_of(spec, dev)
        progs = build_programs(model, mesh, fsdp=fsdp, optimizer=opt,
                               compute_dtype=torch.float32, microbatch=micro)
        state = put_tree(TrainState(params, opt.init(params),
                                    torch.zeros((), dtype=torch.int32)),
                         progs.state_shardings)
        del params
        model.release()
        torch.cuda.empty_cache()
        held = device_bytes(state, mesh)
        n_grams = sum(g.shape[0] > 1 for g in state.opt_state.gram.values())
        torch.cuda.reset_peak_memory_stats()
        walls, losses = [], []
        name = f"gemma2-2b {spec}{' fsdp' if fsdp else ''}"
        for i in range(TRAIN_STEPS):
            batch = put_batch(source.global_batch_at(i), dev)
            tag = f"{name} step {i + 1}"
            (state, metrics), counts, wall = _train_counted(
                torch, tag, lambda: progs.train_step(state, batch), capture,
                streams, launches)
            walls.append(wall)
            losses.append(float(metrics["loss"]))
            want = (2 * n_grams, n_grams) if i == 0 else (0, 0)
            check((counts["sturm_bisect"], counts["logabs_sum"]) == want
                  and counts["sturm_segmented"] == 0,
                  f"mesh {tag}: launches {counts}, expected (kernel 1, "
                  f"kernel 2) {want}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        rel = [abs(a / b - 1) for a, b in zip(losses, ref["losses"])]
        check(max(rel) <= MESH_LOSS_TOL, f"mesh {name}: losses {losses} vs "
              f"unsharded {ref['losses']} ({max(rel):.3e} relative, limit "
              f"{MESH_LOSS_TOL:g})")
        grams = list(state.opt_state.gram.values())
        eligible = [g for g in grams if g.shape[0] > 1]

        def refresh():
            for g in eligible:
                opt._topk(g)

        refresh_ms = _events_ms(torch, refresh, 1, 5)
        bound_ms, bound_by, _, _ = _train_bound(
            model, TRAIN_BATCH, TRAIN_SEQ, micro or 1, PEAK_OPS["float32"])
        steady = sorted(walls[1:])[len(walls[1:]) // 2]
        print(f"[mesh] {name}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens"
              f"{f' in {micro} microbatches' if micro else ''}, remat, "
              f"EigenPre: losses {losses} vs unsharded {ref['losses']} "
              f"({max(rel):.3e} relative at worst, limit "
              f"{MESH_LOSS_TOL:g}); step ms "
              + ", ".join(f"{w:.1f}" for w in walls)
              + " (step 1 refreshes; unsharded "
              + ", ".join(f"{w:.1f}" for w in ref["walls"])
              + f") against the unsharded bound of {bound_ms:.1f} ms by "
              f"{bound_by}; the refresh "
              f"({len(eligible)} grams on {mesh.first_device}) "
              f"{refresh_ms:.3f} ms by CUDA events; peak memory {peak:.2f} "
              f"GB; bytes a position {held}; {card}")
        out[name] = dict(ms=steady, walls=walls, losses=losses, peak_gb=peak,
                         refresh_ms=refresh_ms, bytes=held)
        del state, progs, model, grams, eligible
    torch.cuda.empty_cache()
    return out


def _mesh_launchers(torch, card):
    """``launch/serve.py --arch gemma2-2b --mesh 1x2 --device cuda:0`` and
    ``launch/train.py --arch gemma2-2b --reduced --mesh 2x1 --device cuda:0
    --eigenpre`` in subprocesses, both at once: exit 0, on cuda, the mesh
    and its bytes logged, the served ids in the vocabulary."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    (root / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="mesh-", dir=root / "build"))
    try:
        runs = (("serve", [sys.executable, "-m", "repro_torch.launch.serve",
                           *LM_LAUNCHER, "--mesh", "1x2", "--device",
                           "cuda:0"]),
                ("train", [sys.executable, "-m", "repro_torch.launch.train",
                           "--arch", "gemma2-2b", "--reduced", "--mesh",
                           "2x1", "--device", "cuda:0", "--eigenpre",
                           "--steps", str(MESH_LAUNCHER_STEPS),
                           "--log-every", "1", "--ckpt-dir", str(work)]))
        t = time.perf_counter()
        procs = [subprocess.Popen(cmd, cwd=root, env=env, text=True,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE)
                 for _, cmd in runs]
        try:
            outs = [p.communicate(timeout=LM_LAUNCHER_TIMEOUT_S)
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t
        for (what, cmd), p, (stdout, stderr) in zip(runs, procs, outs):
            check(p.returncode == 0, f"mesh {what} launcher exited "
                  f"{p.returncode}: {stderr[-2000:]}")
            check("cuda" in stderr and "bytes per device" in stderr,
                  f"mesh {what} launcher: {stderr[-2000:]}")
            if what == "serve":
                gen = np.array(json.loads(stdout.strip().splitlines()[-1]))
                check(gen.shape == (LM_LAUNCHER_BATCH, LM_LAUNCHER_GEN)
                      and bool(((gen >= 0) & (gen < get_config(
                          "gemma2-2b").vocab_size)).all()),
                      f"mesh serve launcher printed {gen.tolist()}")
            else:
                check(f"done: {MESH_LAUNCHER_STEPS} steps" in stderr,
                      f"mesh train launcher: {stderr[-2000:]}")
            for line in stderr.splitlines():
                if "repro_torch." in line:
                    print(f"[mesh] {what} launcher: {line}")
            print(f"[mesh] {what} launcher {' '.join(cmd[3:])}: exit 0; "
                  f"{card}")
        print(f"[mesh] both launchers ran at once in {wall:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _phase_mesh_lm(torch, dev, train_ref=None):
    """17. The sharded language model on logical meshes of the one card
    (``build_programs``): gemma2-2b served on MESH_SERVE and trained on
    MESH_TRAIN, one period of deepseek-v3-671b served on 1x2 in bfloat16
    and float32 (a MoE layer on 2x1), and both launchers with ``--mesh``.  ``train_ref``: the unsharded run's
    losses and step walls (phase 15's record); computed here when None.
    Serving launches no kernel of the repo; each training run's step 1
    refresh launches kernels 1 and 2, each launch held against its plain
    version.  Returns each wrapper's launches, summed by part."""
    card = _gpu_name_and_limit()
    print(f"[mesh] phase 17 on {card}")
    t_phase = time.perf_counter()
    _reset_counts()
    with torch.inference_mode():
        _mesh_gemma_serve(torch, dev, card)
        _mesh_deepseek_serve(torch, dev, card)
    counts = _read_counts()
    check(not any(counts.values()), f"mesh: the serving path launched a "
          f"kernel of the repo: {counts}")
    print(f"[timing] the mesh phase's serving took "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    if train_ref is None:
        train_ref = _mesh_train_ref(torch, dev)
    calls, plain, undo = _arm_server_capture()
    streams, launches = {}, {}
    try:
        _mesh_gemma_train(torch, dev, card, (calls, plain), streams,
                          launches, train_ref)
    finally:
        undo()
    _hold_grouped(torch, "mesh", streams, {key: [] for key in _PLAINS})
    torch.cuda.empty_cache()
    _mesh_launchers(torch, card)
    parts = {}
    for spec, fsdp, _ in MESH_TRAIN:
        name = f"gemma2-2b {spec}{' fsdp' if fsdp else ''}"
        parts[f"{name} step 1"] = [f"{name} step 1"]
        parts[f"{name} steps 2-{TRAIN_STEPS}"] = [
            f"{name} step {i}" for i in range(2, TRAIN_STEPS + 1)]
    summed = {part: {key: sum(launches[t][key] for t in tags)
                     for key in launches[tags[0]]}
              for part, tags in parts.items()}
    print(f"[mesh] launches by part: {summed}")
    print(f"[timing] the mesh phase took {time.perf_counter() - t_phase:.1f} "
          f"s with its checks ({card})")
    return summed


def _mesh_train_ref(torch, dev):
    """Phase 15's unsharded float32 EigenPre run of gemma2-2b (TRAIN_STEPS
    steps in TRAIN_MICRO microbatches), for running phase 17 alone: its
    ``losses`` and step ``walls`` (ms, synchronized)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_synthetic
    from repro_torch.models import LanguageModel
    from repro_torch.optim import EigenPre
    from repro_torch.train import TrainState, make_train_step, put_batch

    cfg = get_config("gemma2-2b")
    model = LanguageModel(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    opt = EigenPre()
    params = model.stacked_dict()
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    source = make_synthetic(cfg, ShapeConfig("train_4k", TRAIN_SEQ,
                                             TRAIN_BATCH, "train"), seed=SEED)
    step = make_train_step(model, opt, torch.float32, microbatch=TRAIN_MICRO)
    losses, walls = [], []
    for i in range(TRAIN_STEPS):
        batch = put_batch(source.global_batch_at(i), dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        walls.append((time.perf_counter() - t) * 1e3)
    del state, params, model
    torch.cuda.empty_cache()
    print(f"[mesh] gemma2-2b unsharded reference losses {losses}, step ms "
          f"{walls}")
    return dict(losses=losses, walls=walls)


def _minor_det_case(torch, dev, b, n, k, dtype):
    """Seeded bands ``d (b, n)``, ``e (b, n-1)`` and their top ``k``
    eigenvalues as the shifts, as the top-k chain's ``minor_det`` takes
    them."""
    import numpy as np

    from repro_torch.kernels.sturm import ops as st_ops

    rng = np.random.default_rng(SEED + n)
    d = torch.as_tensor(rng.standard_normal((b, n)), dtype=dtype, device=dev)
    e = torch.as_tensor(rng.standard_normal((b, n - 1)), dtype=dtype,
                        device=dev)
    return d, e, st_ops.sturm_eigenvalues(d, e, window=(k, True))


def _phase_minor_det(torch, dev):
    """19. The minor-determinant kernel against its plain version, timed,
    and the top-k paths through it; returns its timing records."""
    from repro_torch import SolverEngine, SolverPlan, tracing
    from repro_torch.core import identity
    from repro_torch.engine.engine import ProgramSpec
    from repro_torch.kernels.minor_det import kernel as md

    t_phase = time.perf_counter()
    records = []
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        chain = []
        for n in MINOR_DET_CHAIN_N:
            d, e, x = _minor_det_case(torch, dev, 1, n, 1, dtype)
            chain.append(_kernel_device_ms(
                torch, lambda: md.minor_det(d, e, x)))
        step_ms = (chain[1] - chain[0]) / (MINOR_DET_CHAIN_N[1]
                                           - MINOR_DET_CHAIN_N[0])
        print(f"[minor_det] {dname}: one lane {chain[0]:.4f} ms at n = "
              f"{MINOR_DET_CHAIN_N[0]}, {chain[1]:.4f} ms at n = "
              f"{MINOR_DET_CHAIN_N[1]}: {step_ms * 1e6:.1f} ns a step")
        for what, b, n, k in MINOR_DET_SHAPES:
            d, e, x = _minor_det_case(torch, dev, b, n, k, dtype)
            before = md.minor_det.launches
            got = md.minor_det(d, e, x)
            check(md.minor_det.launches == before + 1,
                  f"minor_det {what}: {md.minor_det.launches - before} "
                  f"launches for one call")
            want, _ = _plain_ms(torch, lambda: md.minor_det_plain(d, e, x))
            _, plain_ms = _plain_ms(torch,
                                    lambda: md.minor_det_plain(d, e, x))
            err = _max_err(torch, got, want, MINOR_DET_RTOL[dname],
                           torch.finfo(dtype).tiny,
                           f"minor_det {what} {dname}")
            rel = float(((got.double() - want.double()).abs()
                         / want.double().abs().clamp(
                             min=torch.finfo(dtype).tiny)).max())
            records.append(dict(
                name=f"minor_det[{what} {b}x{n}, k={k}, {dname}]",
                ms=_events_ms(torch, lambda: md.minor_det(d, e, x), 3, 50),
                device_ms=_kernel_device_ms(
                    torch, lambda: md.minor_det(d, e, x)),
                bound_ms=(n - 1) * step_ms,
                bound_by=f"the chain of {n - 1} steps at one lane's "
                         f"{step_ms * 1e6:.1f} ns",
                plain_ms=plain_ms, library_ms=None, max_err=err,
                max_rel_err=rel))
            _print_record(records[-1])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for b, n, k, m in MINOR_DET_TOPK:
        x = torch.randn((b, n, n), dtype=torch.float64, device=dev,
                        generator=gen)
        a = x + x.transpose(-1, -2)
        del x
        plan = SolverPlan(method="eei_krylov", krylov_m=m)
        engine = SolverEngine(plan)
        devices = []
        plain = identity.tridiag_minor_logdets

        def recording(d, e, x):
            devices.append(d.device.type)
            return plain(d, e, x)

        identity.tridiag_minor_logdets = recording
        try:
            for call in range(2):  # the first captures the check's graph
                tracing.reset()
                before = md.minor_det.launches
                top = engine.topk(a, k)
                torch.cuda.synchronize()
                counts = tracing.counts()
                launched = md.minor_det.launches - before
                chunks = counts.get("lanczos_graph_chunk", 0)
                check(launched == counts.get("minor_det_kernel", 0) >= 2
                      and "minor_det_plain" not in counts,
                      f"minor_det top-k {b}x{n}: {launched} launches, "
                      f"counters {counts}")
                check(call == 0 or chunks >= 1,
                      f"minor_det top-k {b}x{n}: no graph replay {counts}")
        finally:
            identity.tridiag_minor_logdets = plain
        check(devices.count("cuda") == 0,
              f"minor_det top-k {b}x{n}: the plain loop ran on the card "
              f"{devices.count('cuda')} times")
        lam = torch.linalg.eigvalsh(a)
        span = float((lam[:, -1] - lam[:, 0]).max())
        err = float((top.eigenvalues - lam[:, -k:]).abs().max()) / span
        check(err < KRYLOV_TOL, f"minor_det top-k {b}x{n}: eigenvalue error "
              f"{err:.3e} of the window's span")
        split = _stage_split(torch, plan, ProgramSpec("topk", k, True), a)
        print(f"[minor_det] Krylov top-k b={b} n={n} k={k} m={m}: "
              f"{launched} launches a call ({chunks} by graph replays), "
              f"eigenvalue error {err:.3e}; stages (ms) {split}")
        del a
    torch.cuda.empty_cache()
    print(f"[minor_det] phase took {time.perf_counter() - t_phase:.1f} s")
    return records


def _phase_examples_dryrun(torch, dev):
    """18. The example twins on the card (a) and the dry run against the
    card (b).  Returns each wrapper's launches by example."""
    card = _gpu_name_and_limit()
    print(f"[examples] phase 18 on {card}")
    t_phase = time.perf_counter()
    launches = _phase_examples(torch, dev, card)
    torch.cuda.empty_cache()
    _phase_dryrun(torch, dev, card)
    print(f"[timing] phase 18 (examples and dry run) took "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return launches


def _example(name):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _phase_examples(torch, dev, card):
    """18 (a). Each example twin of EXAMPLES run on the card with every
    launch count at 0 just before and read just after (``_run_counted``:
    no plain version may run); the kernels its path must launch launched,
    and every launch held against its plain version afterwards."""
    import tempfile

    calls, plain, undo = _arm_server_capture()
    streams, launches = {}, {}
    try:
        with tempfile.TemporaryDirectory() as ckpt:
            for name, argv, must in EXAMPLES:
                argv = ["--device", str(dev), *argv]
                if name == "torch_train_lm":
                    argv += ["--ckpt-dir", ckpt]
                mod = _example(name)
                t = time.perf_counter()
                rc, counts, got, _ = _run_counted(
                    torch, "examples", name, lambda: mod.main(argv), calls,
                    plain, loggers=())
                check(rc == 0, f"examples: {name} {argv} returned {rc}")
                missing = [k for k in must if not counts[k]]
                check(not missing, f"examples: {name} did not launch "
                      f"{missing} on the card: {counts}")
                print(f"[examples] {name}: exit 0 in "
                      f"{time.perf_counter() - t:.1f} s, launches {counts} "
                      f"({card})")
                launches[name] = counts
                if any(got.values()):
                    streams[name] = dict(calls=got, counts=counts)
    finally:
        undo()
    _hold_grouped(torch, "examples", streams, {key: [] for key in _PLAINS})
    return launches


def _phase_dryrun(torch, dev, card):
    """18 (b). One period of gemma2-2b at full width on a 1x1 mesh, a train
    and a decode cell, counted by the dry run on ``"meta"`` and again while
    running on the card: FLOPs and bytes equal, argument bytes within
    DRY_ARGS_TOL of the card's allocation growth while placing them; the
    measured peak, time and the roofline's terms printed."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.roofline import Roofline, model_flops

    full = get_config("gemma2-2b")
    cfg = dryrun_lib._scaled_pattern(full, [1] * len(full.pattern))
    meta_mesh = make_local_mesh(1, 1, devices=["meta"])
    card_mesh = make_local_mesh(1, 1, devices=[dev])
    for shape in (ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
                  ShapeConfig("decode", LM_GEMMA_PROMPT, LM_BATCH,
                              "decode")):
        tag = (f"gemma2-2b {'+'.join(full.pattern[0][1])} {shape.kind} "
               f"{shape.global_batch}x{shape.seq_len}")
        meta = dryrun_lib.compile_and_extract(
            dryrun_lib.lower_cell(cfg, shape, meta_mesh))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        cell = dryrun_lib.lower_cell(
            cfg, shape, card_mesh, fsdp=meta["fsdp"],
            generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        placed = torch.cuda.memory_allocated() - before
        args = meta["memory"]["argument_size_in_bytes"]
        check(abs(placed - args) <= DRY_ARGS_TOL * args,
              f"dry run {tag}: {args} argument bytes counted, {placed} "
              f"allocated on the card")
        cell.run()  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        cell.run()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counted = dryrun_lib.compile_and_extract(cell)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        for key in ("flops", "bytes accessed"):
            check(counted["cost"][key] == meta["cost"][key],
                  f"dry run {tag}: {key} {counted['cost'][key]} on the card, "
                  f"{meta['cost'][key]} on meta")
        rl = Roofline(flops=meta["cost"]["flops"],
                      bytes_accessed=meta["cost"]["bytes accessed"],
                      collective_bytes=meta["collectives"]["total"], chips=1,
                      model_flops=model_flops(cfg, shape))
        print(f"[dryrun] {tag}: flops {meta['cost']['flops']:.6e} and bytes "
              f"{meta['cost']['bytes accessed']:.6e} equal on meta and the "
              f"card; arguments {args} B counted, {placed} B allocated; "
              f"temp {meta['memory']['temp_size_in_bytes']} B counted, peak "
              f"{peak} B measured; step {step_s * 1e3:.3f} ms measured, "
              f"bound_time {rl.bound_time * 1e3:.3f} ms ({rl.dominant}), "
              f"{step_s / rl.bound_time:.2f}x the bound, roofline_fraction "
              f"{rl.roofline_fraction:.4f}; meta count {meta['run_s']:.2f} s "
              f"({card})")
        del cell
        torch.cuda.empty_cache()


#: Kernel kind -> (CUDA source, the TPU kernel's pallas_call it replaces).
_SOURCES = {
    "sturm": ("src/repro_torch/kernels/csrc/sturm.cu",
              "src/repro/kernels/sturm/kernel.py:197"),
    "sturm_segmented": ("src/repro_torch/kernels/csrc/sturm_segmented.cu",
                        "src/repro/kernels/sturm/kernel.py:159"),
    "prod_diff": ("src/repro_torch/kernels/csrc/prod_diff.cu",
                  "src/repro/kernels/prod_diff/kernel.py:107"),
    "prod_diff_masked": ("src/repro_torch/kernels/csrc/prod_diff.cu",
                         "src/repro/kernels/prod_diff/kernel.py:187"),
    "prod_diff_single": ("src/repro_torch/kernels/csrc/prod_diff.cu",
                         "src/repro/kernels/prod_diff/kernel.py:251"),
}


def _record(name, kind, launches, err, ms, plain_ms, bound_ms, bound_by,
            library_ms, **extra):
    """One kernel's entry of the JSON line.  ``launches`` is the wrapper's
    count over this dtype's run of the kernel's path: the main path (solve,
    two topk, two eigenvalues) for the Sturm and prod-diff kernels, the
    session for the segmented Sturm kernel, the op entry points for the
    masked and single-matrix prod-diff kernels.  The Sturm wrapper's count
    covers all its roles (spectrum, window, minor stack)."""
    source, replaces = _SOURCES[kind]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, **extra,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


if __name__ == "__main__":
    sys.exit(main())
