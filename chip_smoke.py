#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pumiumtally_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on any failed check:

1. device: the card's name and power limit from nvidia-smi;
2. build: the six CUDA sources (csrc/walk.cu, scatter.cu, gather.cu,
   source.cu, exchange.cu, integrity.cu), one nvcc each, started
   together, timed;
3. kernel vs plain on a jittered 20^3 box (48,000 tets, two materials),
   65,536 lanes, 8 groups, float32 and float64, initial and move mode with
   robust=True plus one move with robust=False: elements, material ids,
   done flags and stats equal on every lane, positions within 1e-12 (f64)
   / 1e-5 (f32), flux bitwise equal (the ordered tally folds each bin in
   the plain walk's order); the robust move also through the atomic
   tally, its flux within rtol 1e-4;
4. main path: the four-call facade at the headline configuration
   (998,250-tet box, 1,048,576 particles, 8 groups, float32, the default
   ``io_pipeline="packed"``): construct (the mesh's derived tables and
   adjacency through the native host runtime, one call each), locate, 4
   moves, write a .vtu. Launch counts are zeroed just before and read just after; the
   conservation invariant, the boundary write-backs, the .vtu and one
   transfer each way a call are checked. Each walk must run the lane
   schedule's 3 kernels once (a relaunch none) and each move's ordered
   scatter must take the bucket path (its largest bucket and the capacity
   are printed);
5. kernel vs plain at the main path's shapes: the inputs of the main
   path's initial search and of its first move, replayed through the
   kernel and the plain walk, compared (flux bitwise) and timed with CUDA
   events (the kernel a median of 5, the plain walk one call); the
   ordered move is also timed in its two parts
   (walk into records, ordered scatter) and beside the atomic walk. The
   bound is the larger of two times: the bytes the walk must move (each
   distinct table row it needs once, each flux bin it scores read and
   written once, the lanes' inputs and outputs) over the HBM rate, and its
   lane iterations' operations over the FP32/FP64 rate. Each walk's
   active-lane share, Σ lane iterations / (32 · Σ warp loop trips), is
   printed beside the share one-thread-per-lane warps in launch order
   would have had (32-lane groups of the lane iterations), and the walk
   launch is timed with its lanes in the kernel's order (by start
   element, or by destination cell in the initial search; the lane
   schedule included) and in launch order, a move's ordered scatter too.
   The lane schedule (``walk_cuda.lane_records``, three kernels) is held
   against ``lane_records_plain`` on the inputs of move 1 and of the
   initial search (every lane's record bytes, keys in slot order, its key
   counts left at zero) and timed: device time by kernel (torch.profiler,
   which must show its three kernels and nothing else), event span, the
   plain version and ``torch.argsort`` of the keys, beside its bound.
   Move 1's records are scattered by the ordered scatter's bucket path,
   by its crowded path called directly and by ``torch.argsort`` +
   ``Tensor.index_put_(accumulate=True)``, each held bitwise to the plain
   version and timed, and the bucket path is profiled by kernel;
6. reproducibility (phase C): move 1 replayed twice through the ordered
   walk gives the same flux bits; twice through the atomic walk, each run
   held against the plain walk (lanes equal, flux within rtol 1e-4) and
   their run-to-run difference reported (the atomic walk's path: its
   launches are counted over these replays);
7. overflow (phase D): move 1 with a record capacity of 1,000 overflows,
   runs the walk again and gives the same flux bits;
8. probe path (phase A): the gather/scatter probe
   (``pumiumtally_tpu_torch.probes.gather_scatter.run``) with the main
   path's geo20 table and move 1's real records: K2 and K3 against their
   plain versions (bitwise for the gather and the ordered scatter, rtol
   1e-5 for the atomic one) at the JAX probe's shapes and the walk's,
   timed, with the library call beside them; launch counts zeroed before
   and read after (the gather bitwise through the words' integer views).
   K3 outer also in float64, with and without squares, at the JAX probe's
   shapes and move 1's records (the move-1 reading goes into the
   ``kernels`` line beside index_add_'s); K2 also at the walk's shape in
   float64 (the box's geo20 built in float64, its codes int64 bits),
   bitwise, timed beside the plain version and index_select, its launches
   counted apart; and the SASS of the atomic scatter and the atomic walk
   (cuobjdump) must hold the float32 pair's vector reduction;
9. point source (phase E): all 1,048,576 lanes start at one point of the
   main-path mesh and fly one move; the ordered scatter of its records
   must take the crowded path; it is held bitwise against the plain
   version and timed, and its largest bin's record count reported;
10. move-loop I/O: the main path's initial search and moves 1-4 from the
   same seed under each ``io_pipeline`` mode (legacy, packed, overlap),
   twice each: once with a ``StepClock`` (each host step of every move on
   the host clock and as a stream span, and the walk's two host waits),
   once with moves 2-4 traced by torch.profiler (the card's busy share of
   their host time). Write-backs and raw flux must be bitwise equal
   across all runs; a packed or overlap move must make 1 host→device and
   1 device→host transfer, a legacy move 4 and 1; every run launches the
   walk 5 times and the bucket scatter 4 times. Segments/s of moves 2-4
   per mode;
11. pipeline: 4 independent batches of 1,048,576 lanes through
   ``StreamingTallyPipeline`` at depth 1 and 2, flux and positions
   bitwise equal to sequential ``walk_cuda.trace``; batches/s beside the
   sequential walk's, the submit calls' host times, and the busy share;
12. run statistics: the main path's inputs (init and moves 1-4, packed)
   under four configurations, launch counts zeroed before and read after
   their runs: (a) ``convergence=True, batch_moves=2``: flux and
   write-backs bitwise the run without it, one transfer each way a move,
   2 batches, the summary equal to a float64 host recomputation from the
   moves' even entries (rtol 1e-5); (b) ``sd_mode="batch"``: even
   entries bitwise (a)'s, odd entries Σ (ΔT)² in float64 (rtol 1e-5, or
   within the dtype's smallest normal number below it);
   (c) ``max_crossings=4`` with re-walks (``RUNSTATS_TRUNC``): lanes
   re-walked, none lost, elements equal to the ample run's, flux within
   rtol 1e-5 + atol 1e-5; (d) ``quarantine=True`` with 1,000 NaN
   destinations on move 2: 1,000 lanes quarantined, flux finite and
   bitwise the run in which they are parked. Move wall time with
   convergence off and on in turns (off, on, on, off); the device time
   of ``fold_and_reduce`` and ``accumulate_batch_squares``; move 1
   replayed kernel against plain walk with squares off and at (c)'s bound
   with its re-walks (bitwise), the first re-walk's walk and scatter
   timed; the peak device memory;
13. feature tails (``[tails]`` lines): the main path's inputs with (a)
   ``record_xpoints=8`` (move 1's points and counts from the facade and
   the kernel against the plain walk on the card, counts equal, points
   within 1e-5; the flux bitwise the run without them; the buffers'
   bytes), (b) the element sort every move (positions, materials,
   element ids and flux bitwise across the three ``io_pipeline`` modes
   and two runs; against the unsorted run bitwise but for the flux, rtol
   1e-5; the sort's device ms and the lane schedule's kernels with sorted
   slots against unsorted ones) and (c) ``checkify_invariants`` (a clean
   run bitwise the unchecked one; the kernel must raise the walk's
   message for a corrupted parent element and for a NaN destination,
   the next walk in the process give its flux bits, and a checked
   facade run after both raises the unchecked run's flux). Each feature's
   move cost on against off in turns, its walk call's CUDA-event time,
   and its launches (the ``kernels`` line's ``feature_launches``).

14. megastep (``[mega]`` lines), the device-sourced move loop: (a) on a
   jittered 20^3 two-region box, 4,096 lanes, both dtypes: move 1's
   flight kernel (``csrc/source.cu``) against its plain version on the
   card (its five uniforms bitwise, the collision and roulette draws
   bitwise, the destinations bitwise or their differing elements counted
   with their largest ulp, limit 2), and 4 fused moves through the kernels
   against the same moves through the plain sampling and the plain walk
   on the card (counters and discrete state equal; positions and flux
   bitwise where every destination is, else within the walk's
   tolerances); (b) the full cell, bench.py's megastep cell (the main
   mesh, 1,048,576 lanes, 8 groups, ``tolerance=1e-6``, Σt 12.5, seed 1,
   K = 8): a warm call and a timed call of 8 moves, clocked by step
   (``StepClock``: sample, walk and its two host waits, physics, folds,
   the tail read), launches counted (8 flight launches, 8 walks and their
   relaunches, one tail copy), then the same at K = 1, which must end
   bitwise where K = 8 ended; a profiled K = 8 call for the card's busy
   share; the flight kernel at the timed call's first move, timed beside
   its plain version and its bound; (c) ``SyntheticTransport`` on
   ``problems.assembly(55, 3)`` (998,250 tets, 10 regions, pins at
   ``Material(4.0, 0.5)``), 1,048,576 particles: a megastep batch to its
   end (K = 8, at most 1,000 events) and 4 host-mode events, in turns
   (megastep, host, host, megastep), moves/s and segments/s.
15. integrity and resilience (``[resil]`` lines) at the main cell (the
   main path's inputs, recorded once with the defaults; every run below
   is held bitwise to that run's flux, positions, elements and
   write-backs), launch counts zeroed before and read after: (a)
   ``integrity="warn"`` with 64 audited lanes a move: 0 violations, 0
   audit mismatches, one transfer each way a move (the audit's gather of
   its 64 lanes is out of band), the conservation sums within 1e-5
   relative of the host oracle from the write-backs and the residual
   within ``conservation_tolerance``; on a full-width move's walk
   outputs the fused vector (``csrc/integrity.cu``) equal to the walk's,
   bitwise across two launches, against the plain torch vector (counts
   equal, sums and residual within 1e-5 relative), both timed in turns
   (plain, fused, fused, plain; CUDA events, median of 5) beside the
   bytes bound, the ``verify`` step's host ms, and the move's host ms
   with the checks off and on in turns (off, on, on, off); (b) the
   checkpoint round trip after move 2
   went to phase 22 (a), whose migrated job's checkpoint is saved,
   restored into a fresh tally on the other member (every save and
   restore counted) and continued bitwise, its save and restore seconds
   printed (the resumed runner of (c) restores a generation into a fresh
   tally too); (c) ``ResilientRunner``: ``die_at_move:3`` and an
   auto-resume from the store (no cadence after the resume, so one
   generation is written), a transient retried once, and
   ``bitflip_flux:2`` under
   ``integrity="halt"`` caught as "flux" at move 3 with generation 2
   flushed; (d) ``move_deadline_s`` on healthy moves: no timeout, the
   move's host ms with the deadline off and on in turns; (e) the
   megastep cell (K = 8) with integrity on: 0 violations, bitwise the
   run without, the fused vector launched once a fused move and the two
   runs' chunk vectors bitwise equal (its checkpoint round trip went to
   phase 22 (a), whose migrated job restores a megastep checkpoint at
   full width).
16. the partitioned tally (``[part]`` lines): (a) the unpacked table
   layout: the four calls on the main box with 65 z-slab classes built
   ``packed=False`` (initial search and one move through the unpacked
   instantiation, counted; material stops at the slabs), their inputs
   replayed kernel against plain walk (every lane and the flux bitwise),
   the same on a float64 65-class 20^3 box, and move 1 of the main path
   on the main mesh's unpacked twin (bitwise the packed walk) timed
   against the packed mesh in turns (packed, unpacked, unpacked, packed;
   CUDA events, median of 5) beside its bound, with the unpacked and
   partitioned instantiations' ptxas registers and spills; (b) the
   partitioned walk phase on a jittered 20^3 box in 4 parts, halo 0 and
   1, both dtypes: the first walk phase kernel against plain (every
   lane's state, target and the slab flux bitwise) and the whole step
   through the walk and exchange kernels (``csrc/exchange.cu``) against
   the plain walk phases and ``_exchange_plain`` (every slot field, slab
   flux, rounds, round stats and drops bitwise, twice through the
   kernels, one exchange launch pair a round), also on 512 of the lanes
   sent 0.8 of the way to a corner, in a slot layout of the most any
   part starts with and 2 rows a destination a round (emigrants wait
   rounds, the corner's part drops immigrants); (c) the main cell (seed
   1) through
   ``PartitionedTally(n_parts=4, halo_layers=1)``: a counted run (launch
   counts zeroed before and read after, round waits, peak device memory,
   a .vtu; every round exchanged through the kernels), a run beside
   ``PumiTally`` in turns (host ms and segments/s a
   move, rounds, walk relaunches, emigrants a round, each round's walk
   phase, exchange and halo fold in CUDA events, the exchange's beside
   torch exchange's 3.19-4.87 ms a round; positions within 1e-5,
   materials and elements counted where they differ, the flux per bin
   within rtol 1e-5 + atol 1e-5, segments equal, the conservation
   residual <= 1e-4, the flux bitwise the counted run's), a profiled run
   of the search and moves 1-2 (the card's busy share; its slabs bitwise
   the counted run's after move 2), and move 1's first walk phase at full width
   as the facade's step makes it (one launch with the step's budget and
   count restart, then the ordered fold of its records) kernel against
   plain, timed beside its bound, and the exchange round that follows
   it (its slots from that phase's outputs) through the kernels against
   ``_exchange_plain`` (every field, the stats and drops bitwise), both
   timed in turns (plain, kernel, kernel, plain) beside the round's
   bytes bound; (d) ``io_pipeline``
   "legacy" (the initial search and move 1) and "overlap" (the search and
   moves 1-2, so that a move drains the previous one's deferred folds):
   the packed run's slabs and write-backs after the last move bitwise.
17. the partitioned source loop (``[pmega]`` lines,
   ``PartitionedTally.run_source_moves``): (b) on a jittered 20^3 box in
   4 parts, halo 1, both dtypes: 3 fused moves of the partitioned
   megastep through the kernels against the same through the plain
   flight and the plain walk phases on the card (slot state, slab flux
   and readback bitwise), and K = 3 bitwise 3 x K = 1; at the megastep
   cell (the main mesh, 1,048,576 particles, 8 groups, float32, Σt 12.5,
   seed 1, K = 8) in 4 parts, halo 1: (c) the first fused move beside
   PumiTally's (segments equal, positions within 1e-5, the flux per bin
   within rtol 1e-5 + atol 1e-5: the flux is scored before the physics),
   (a) the flight kernel on the next move's stacked slots (4 x 1,048,576,
   each lane's region at its part-local row) and in its single-device
   form against the plain version (uniforms and draws bitwise, the
   destinations within 2 ulp), timed beside its bound, (c) a warm chunk
   each, then chunks of 8 in turns with ``PumiTally.run_source_moves``
   (partitioned, single, single, partitioned): moves/s, segments/s, host
   ms a fused move and rounds; the first partitioned chunk counted
   (launches, ``ROUND_WAITS``, the walk, exchange and halo spans, peak
   device memory), a profiled chunk for the busy share; (d) integrity
   on, convergence on, and a checkpoint saved after move 1: each run
   held bitwise to (c)'s after its first two calls, the checkpoint
   restored into 4 parts bitwise and into 2 parts (the restored flux
   bitwise, the next chunk's segments and flux sum within 2e-2).

18. the partitioned tally across processes and its recovery (``[ranks]``
   lines): (a) the walk launches and stop tests of phase 16 (c)'s counted
   run and phase 17 (c)'s counted chunk equal PR 14's (the crossing
   budget's later rounds add none at the default bound), then move 1 of
   the partitioned cell as one step at ``max_crossings=16``, kernel
   against plain bitwise, with the later-round launches and the lanes
   given a fresh budget; (b) that step (default bound) over the
   ``MeshEntry`` mesh of a one-rank NCCL group against the stacked step,
   in turns (stacked, nccl, nccl, stacked), every output bitwise, every
   round's exchange through the exchange kernels (their send blocks and
   row counts through NCCL), each round's exchange in CUDA events and
   the peak device memory; (e)
   ``write_parallel_vtk`` on that rank (the piece holds the mesh's cells,
   the index names it); (c) ``chip_down_at_move:2,chip:2`` under
   ``ResilientRunner`` on the 4-part cell (located before the runner
   wraps it, so no generation 0 is written: the rollback is to the
   runner's snapshot on the card): rebuilt on 3 parts, the
   cell's 4 moves finished, the recovery seconds, segments and flux sum
   within 1e-4 of phase 16 (c)'s fault-free 4-part counted run; (d) two ``DepletionLoop`` steps in megastep
   mode on a two-region 20^3 box (65,536 particles): the densities fall.
19. the partitioned debug surfaces and the megastep over ranks
   (``[debug]`` lines): (a) move 1 of the main path on the main mesh's
   unpacked twin (its tables without geo20) with ``record_xpoints=8`` and
   the checks, through the unpacked layout's feature instantiation against
   the plain walk (counts, points, lanes and flux bitwise; the flux and
   lanes bitwise the walk without features), and the walk call with the
   features off and on in turns; (b) the partitioned cell (phase 16 (c):
   seed 1, 4 parts, halo 1) through ``PartitionedTally`` with
   ``record_xpoints=8`` and ``checkify_invariants`` for the initial
   search and move 1 beside ``PumiTally`` with the points: counts equal,
   points within 1e-5, the slabs bitwise phase 16 (c)'s after move 1,
   every walk launch a feature launch of the partitioned layout; move
   1's first walk phase with points through the partitioned layout's
   feature instantiation against the plain walk phase (lanes, points,
   counts and flux bitwise) and with and without points in turns (CUDA
   events); the exchange round after that phase with 8 points a slot in
   the send rows, kernels against ``_exchange_plain`` (every field,
   points and counts included, bitwise) with each one's send buffer; the
   largest send buffer an exchange allocated (``walk_partitioned.
   SEND_BYTES``, against phase 16 (c)'s) and the peak device memory; (c)
   the
   partitioned megastep cell's first chunk (phase 17's source and
   staging, K = 8) stacked and over the ``MeshEntry`` mesh of a one-rank
   NCCL group, every output bitwise; (d) on (b)'s tally one NaN
   destination: ``checkify_invariants`` raises the JAX facade's
   ValueError and leaves the tally as it was. Phases 5, 16 (a) and 16 (c)
   time their plain walks with one call each (a median of 5 before),
   which makes room for this phase and for the build's 16 more walk
   instantiations.

20. the tuning (``[tune]`` lines): (a) the walk kernel's instantiations
   at 64, 256 and 512 threads a block (the packed, robust initial search
   and ordered move) against the 128 kernel on the main cell's initial
   search and move 1 (lanes and flux bitwise, float32) and against the
   plain walk on the jittered 20^3 box in float64 (bitwise); each width's
   move 1 ordered walk call (CUDA events, median of 5, the widths in
   turns), its resident threads and the ptxas registers,
   spills and shared memory of every width; (b) ``tuning/search.py`` in
   ``mode="hardware"`` on the headline class (the main mesh): four widths
   (3 timed chains of 2 moves each) and K in {1, 4, 16} (16 moves), every
   candidate's median, parity verdict and the winners, each width
   launched (``walk_cuda.BLOCK_LAUNCHES``); ``PumiTally(tuning=<that
   database>)`` on the main cell's inputs, initial search and moves 1-2
   bitwise the default facade, every walk launch at the winning width;
   ``PUMI_TPU_TUNE_FAULT=kernel:cuda:256`` on smoke1 rejected by the
   parity gate; (c) move 1 of phase 16 (c)'s partitioned cell under
   ``compact_stages="plan"`` and ``"auto"`` against the default:
   write-backs and slabs bitwise; each run's ``PART_LAUNCHES``, rounds
   and first walk phase (CUDA events).
21. serving (``[serve]`` lines): (a) ``TallyScheduler`` on the main cell
   (the 55^3 box, 8 groups, float32) serves three synthetic jobs of
   1,048,576, 786,432 (padded to 1,048,576) and 262,144 particles, 4
   moves each, ``max_resident=2``, quanta of 2 moves, the exporter on
   port 0 (``/metrics``, ``/jobs`` and ``/trace`` fetched from it): every
   job's flux bitwise its uninterrupted ``PumiTally`` run, every job's
   spans through ``obs.check_job_trace``, the walk, schedule,
   bucket-scatter and flight launches over the drain (zeroed before,
   read after; on the ``kernels`` line as ``serving_*``), jobs and
   segments a second of the drain (timed without the profiler), each
   quantum's device seconds, no job running more moves than it asked
   (the preempted job's checkpoint round trip is phase 22 (a)'s
   migration); (b) server
   processes, each the serving CLI's ``main`` (``python -m
   pumiumtally_tpu_torch.serving --demo 3``) serving three jobs of 65,536 and 32,768 particles on the 20^3 box: a
   cold process over an empty library bank, started before the smoke's
   build (the two nvcc builds run together) and waited for before phase
   3, builds the bank (3 misses); in phase 21, after (a) and (d), a warm
   one over that bank builds nothing (0 misses, 0 compile seconds), and
   one over a copy of the bank whose ``source`` library was cut in half
   names its entry "torn", rebuilds and rewrites it; all three give the
   bits of the same jobs served in this process, and each prints its
   seconds to the first quantum; (c) beside them, the same jobs
   journaled, the server stopped by ``kill_server_at_quantum:3``, then a
   fresh process that recovers its journal (``--resume``; imported
   beside the crash, its main() started when the crash process has
   exited): every job
   bitwise the in-process run, every
   job's trace one trace id across both pids; (d) (a)'s 262,144-particle
   job with ``PUMI_TPU_TRACE=off`` gives (a)'s bits and keeps no span,
   its drain under torch.profiler (card activity only) gives a served
   drain's busy share, and an SLO
   on ``pumi_job_time_to_first_quantum_seconds`` that must fire, under
   ``PUMI_TPU_PROFILE=anomaly``, opens a torch.profiler window over a
   probe job and writes one Chrome trace whose device events are listed
   by name (a window that kept none is taken again, at most 3 times).
22. the serving fleet (``[fleet]`` lines): (a) a ``FleetRouter`` of two
   members (``max_resident=2``, quanta of 2, every member journaled) on
   the card behind a ``TallyGateway`` on port 0 serves phase 21 (a)'s
   jobs of 1,048,576 and 262,144 particles (its 786,432-particle job is
   left out: each full-width job costs seconds of journal JSON and
   checkpoints on the host): each POSTed with its idempotency key, then
   again (the same ids, ``n_submitted`` unchanged); after the first
   round the 1,048,576-particle job migrates to the other member (the
   checkpoint the source member's journal saved at that quantum
   boundary, which the migration reuses without a save of its own,
   restored once on the target, whose admission says so); each result
   fetched over ``GET /result`` and
   decoded, bitwise phase 21 (a)'s flux; one ``migrated`` trace link,
   ``pumi_jobs_recovered_total{source="migrated"}`` 1, every job's spans
   through ``check_job_trace``, no job running more moves than it
   asked; jobs a second of the drain, each checkpoint's save seconds,
   the migration's seconds, peak device memory after ``settle_memory``
   and the kernels' launches over the drain (``fleet_*`` on the
   ``kernels`` line); (b) phase 21 (b)'s three jobs on the 20^3 box
   through three failures: member 0 killed after the first round under
   ``absorb_member_kills=True``; the router crashed by
   ``kill_server_at_quantum:3`` and ``FleetRouter.recover``ed with the
   whole workload POSTed again (every key deduped); a
   ``FleetSupervisor`` evicting the member that ``wedge_member:1``
   wedges. Each path ends with every job terminal on exactly one alive
   member, the alive members' journals disjoint and every flux bitwise
   phase 21's; ``obs.fleetview``'s check passes over every fleet
   directory.
23. the C ABI (``[capi]`` lines): the bridge library, the demo host and
   the replay host built with g++ (``capi.build_bridge``, the
   interpreter's sysconfig flags); the native host runtime against the
   numpy path on the main cell's arrays (998,250 tets: derived tables and
   adjacency bitwise on this host, each path's seconds in turns); the
   main cell written as .npz and phase 4's inputs (1,048,576 particles, 8
   groups, seed 1, moves 1-4) written to files; the replay host (a C
   program: create, initialize, 4 moves, get_flux, write) on the card
   once, between two runs of ``PumiTally`` on the same mesh file in this
   process (in-process, C, in-process): the flux and every move's
   positions, flying flags and material ids in the C buffers bitwise the
   in-process run's, each move's host seconds on both sides (the C side's
   ``clock_gettime``), the in-process mesh loads through the native
   runtime. The C host's kernel launches happen in its own process and
   are not counted;
24. the chaos drivers (``[chaos]`` lines): ``python -m
   pumiumtally_tpu_torch.chaos.campaign --only corrupt_manifest_chip_down``,
   ``chaos.serve --only storm`` and ``chaos.fleet --only retry_storm``
   (its routers over phase 21's warm bank), each with ``--device cuda``,
   and phase 23's demo host, the four processes together: each exits 0
   (the demo printing ``OK``);
25. host syncs (``[syncs]`` lines): the port's lint runner (``python -m
   pumiumtally_tpu_torch.analysis --no-contracts``, which imports no
   torch; its cost layer reads phase 2's build logs) over this checkout
   in a process of its own, started first and required to exit 0;
   meanwhile, under
   ``torch.cuda.set_sync_debug_mode("warn")``, two packed moves of phase
   4's tally, one megastep chunk of bench.py's cell (K = 8, Σt 12.5) and
   one move of the partitioned cell (4 parts, halo 1). Each synchronizing
   operation that torch reports is placed at its innermost frame in the
   package (file, line, function): every site must be a counted PUMI001
   entry of LINT_BASELINE_TORCH.json or lie in a module that PUMI002
   approves for transfers, and none may lie in ``_exchange`` (the
   partitioned move's rounds run ``csrc/exchange.cu``, counted). The
   sites and their counts are printed; syncs inside the kernels'
   ``ctypes`` libraries are not seen by torch;
26. contracts (``[contracts]`` lines): the kernel resource contracts
   (analysis/costmodel.py) over phase 2's fresh build logs of the six
   sources: every instantiation's ptxas record and its float64 SASS
   instructions (``cuobjdump -sass``), the baseline-free invariants (the
   card's opt-in shared memory read from the device), the drift against
   PERF_CONTRACTS_TORCH.json and its source digests, and the shared
   memory mirror against the bytes each source's ``pumi_*_smem`` entry
   says a launch passes; the program contracts (analysis/contracts.py):
   the CPU families on this host against CONTRACTS_TORCH.json and the
   ``cuda`` family (a packed move and a megastep chunk through the
   kernels); ``cost.peak.cuda``: phase 4's ``max_memory_allocated``
   against the analytic allowance of the main cell. Any finding outside
   LINT_BASELINE_TORCH.json raises.

The peaks of device memory that phases 16 (c), 17 (c) and 19 (b) print
follow a garbage collection (``settle_memory``): they count what is
live, not earlier phases' objects that wait for Python's collector.

The last two lines of standard output are the card line and the result
JSON; before them one line carries the ``kernels`` JSON.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings

import numpy as np
import torch

# The walk's operations a lane iteration, the bytes a lane reads and
# writes once, and the flight kernel's integer operations a lane: the
# counts the tuner's cost model uses too.
from pumiumtally_tpu_torch.tuning.costmodel import (  # noqa: E402
    FLIGHT_OPS_PER_LANE as FLIGHT_INT_OPS,
    FLOPS_PER_ITER,
    LANE_IN,
    LANE_OUT,
)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM, float32 outside the tensor cores
FP64_FLOPS = 34e12             # H100 SXM, float64 outside the tensor cores

# Where and at what size the phases run (a CPU rehearsal at a tiny size
# may override these; the run on the card uses them as they are).
DEVICE = "cuda"
SMALL_CELLS, SMALL_LANES = 20, 65536
MAIN_CELLS, MAIN_PARTICLES, MAIN_GROUPS = 55, 1048576, 8
OVERFLOW_CAPACITY = 1000
# The run-statistics phase's configurations. A lane of the main cell
# crosses up to ~200 faces in the initial search and ~150 in a move, so
# from max_crossings=4 the doubling re-walks need 6 attempts (a budget of
# 4 + 8 + ... + 256 crossings) to lose nothing.
RUNSTATS_CONV = dict(convergence=True, batch_moves=2)
RUNSTATS_TRUNC = dict(max_crossings=4, truncation_retries=6)
RUNSTATS_BAD = 1000  # lanes given NaN destinations in (d)
SOURCES = ("walk", "scatter", "gather", "source", "exchange", "integrity")
LIBS: list = []  # the built libraries, for their ptxas logs
WARP = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def event_ms(fn, reps: int = 5, setup=None) -> float:
    """Median over ``reps`` of one call's device time (CUDA events)."""
    times = []
    for _ in range(reps):
        args = setup() if setup is not None else ()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def compare(k, p, dtype, pos_tol, flux_rtol, label: str) -> dict:
    """Hold a kernel TraceResult against the plain one; raises on a
    mismatch. ``flux_rtol`` 0 asks for bitwise equal flux. Returns the
    error summary."""
    differ = (
        (k.elem != p.elem) | (k.material_id != p.material_id)
        | (k.done != p.done)
    )
    n_differ = int(differ.sum())
    pos_err = float((k.position - p.position).abs().max())
    fk, fp = k.flux.double(), p.flux.double()
    flux_abs = float((fk - fp).abs().max())
    denom = torch.maximum(fk.abs(), fp.abs())
    rel = (fk - fp).abs() / torch.where(denom > 0, denom, 1.0)
    flux_rel = float(rel.max())
    flux_bitwise = bool(torch.equal(k.flux, p.flux))
    stats_equal = bool(torch.equal(k.stats, p.stats))
    iters_equal = bool(torch.equal(k.lane_iters, p.lane_iters))
    log(
        f"[compare] {label}: lanes whose path differs={n_differ} "
        f"max|dpos|={pos_err:.3e} (tol {pos_tol:g}) "
        f"max flux rel={flux_rel:.3e} (rtol {flux_rtol:g}) "
        f"flux bitwise equal={flux_bitwise} "
        f"stats equal={stats_equal} stats={k.stats.tolist()}"
    )
    if n_differ or not stats_equal or not iters_equal:
        raise AssertionError(f"{label}: kernel and plain walk disagree")
    if not pos_err <= pos_tol:
        raise AssertionError(f"{label}: positions differ by {pos_err}")
    if not (flux_bitwise if flux_rtol == 0 else flux_rel <= flux_rtol):
        raise AssertionError(f"{label}: flux differs by rel {flux_rel}")
    return {"max_abs_err": max(pos_err, flux_abs)}


def jittered_box(nx: int, jitter: float, seed: int, dtype):
    from pumiumtally_tpu_torch.mesh.box import build_box_arrays
    from pumiumtally_tpu_torch.mesh.core import TetMesh

    coords, tets = build_box_arrays(1.0, 1.0, 1.0, nx, nx, nx)
    rng = np.random.default_rng(seed)
    interior = (coords > 1e-9).all(axis=1) & (coords < 1 - 1e-9).all(axis=1)
    coords = coords.copy()
    coords[interior] += rng.uniform(
        -jitter / nx, jitter / nx, (interior.sum(), 3)
    )
    cid = (coords[tets].mean(axis=1)[:, 0] > 0.5).astype(np.int32)
    return TetMesh.from_numpy(coords, tets, cid, dtype=dtype, device=DEVICE)


def phase_kernel_vs_plain_small() -> None:
    from pumiumtally_tpu_torch.ops import walk, walk_cuda

    n, G = SMALL_LANES, 8
    for dtype, pos_tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        mesh = jittered_box(SMALL_CELLS, 0.2, 0, dtype)
        rng = np.random.default_rng(0)
        dev = mesh.device

        def t(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

        weight = t(rng.uniform(0.5, 2.0, n), dtype)
        group = rng.integers(0, G, n).astype(np.int32)
        group[rng.uniform(size=n) < 0.01] = G  # out of range: scores nothing
        group = t(group, torch.int32)
        mat = torch.full((n,), -1, dtype=torch.int32, device=dev)
        flux0 = torch.zeros(mesh.ntet * G * 2, dtype=dtype, device=dev)
        kw = dict(max_crossings=mesh.ntet + 64, n_groups=G)

        # Initial mode: every lane from element 0's centroid.
        origin = mesh.centroids()[0].expand(n, 3).contiguous()
        elem = torch.zeros(n, dtype=torch.int32, device=dev)
        src = t(rng.uniform(0.02, 0.98, (n, 3)), dtype)
        fly = torch.ones(n, dtype=torch.bool, device=dev)
        args = (mesh, origin, src, elem, fly, weight, group, mat)
        k = walk_cuda.trace(*args, flux0.clone(), initial=True, **kw)
        p = walk.trace(*args, flux0.clone(), initial=True, **kw)
        compare(k, p, dtype, pos_tol, 0.0, f"{dtype} initial robust")

        # Move mode from the located positions, some lanes leaving.
        direction = rng.normal(size=(n, 3))
        direction /= np.linalg.norm(direction, axis=1, keepdims=True)
        length = rng.exponential(0.15, (n, 1))
        origin, elem = p.position, p.elem
        dest = t(origin.double().cpu().numpy() + direction * length, dtype)
        fly = t(rng.uniform(size=n) > 0.05, torch.bool)
        args = (mesh, origin, dest, elem, fly, weight, group, mat)
        for robust in (True, False):
            k = walk_cuda.trace(*args, flux0.clone(), initial=False,
                                robust=robust, **kw)
            p = walk.trace(*args, flux0.clone(), initial=False,
                           robust=robust, **kw)
            compare(k, p, dtype, pos_tol, 0.0,
                    f"{dtype} move robust={robust}")
            if robust:
                a = walk_cuda.trace(*args, flux0.clone(), initial=False,
                                    tally="atomic", **kw)
                compare(a, p, dtype, pos_tol, 1e-4, f"{dtype} move atomic")
        torch.cuda.synchronize()


def phase_main_path(tmpdir: str):
    """The four calls at the headline configuration. Returns the tally,
    snapshots of the inputs of the initial search and of the first move
    (for the replay of phase 5), and the kernel launches counted."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box, native
    from pumiumtally_tpu_torch.ops import scatter

    cells, n, G = MAIN_CELLS, MAIN_PARTICLES, MAIN_GROUPS
    rng = np.random.default_rng(1)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    native_before = dict(native.CALLS)
    t0 = time.perf_counter()
    mesh = build_box(1.0, 1.0, 1.0, cells, cells, cells, device=DEVICE)
    tally = PumiTally(mesh, n, TallyConfig(n_groups=G), device=DEVICE)
    torch.cuda.synchronize()
    native_calls = {k: native.CALLS[k] - native_before[k]
                    for k in native.CALLS}
    log(f"[main] construct: {time.perf_counter() - t0:.3f} s "
        f"(ntet={mesh.ntet}, particles={n}, groups={G}); the native host "
        f"runtime's calls {native_calls}")
    if mesh.ntet != 6 * cells ** 3:
        raise AssertionError(f"mesh has {mesh.ntet} tets")
    if (native_calls["derive_geometry"], native_calls["build_tet2tet"]) != (
            1, 1):
        raise AssertionError("the main mesh was not built through the "
                             "native host runtime")

    pos = rng.uniform(0.05, 0.95, (n, 3))
    snaps = {"initial": _snapshot(tally, pos, tally.state.group.cpu().numpy()),
             "run": {"pos": pos.copy(), "moves": []}}
    t0 = time.perf_counter()
    tally.initialize_particle_location(pos.reshape(-1))
    torch.cuda.synchronize()
    log(f"[main] initialize_particle_location: "
        f"{time.perf_counter() - t0:.3f} s, stats {tally.last_stats}")
    if tally.last_stats["truncated"]:
        raise AssertionError("initial search truncated")

    prev = pos.copy()
    path = 0.0
    late_segs, late_secs, most_segs = 0, 0.0, 0
    for move in range(1, 5):
        direction = rng.normal(size=(n, 3))
        direction /= np.linalg.norm(direction, axis=1, keepdims=True)
        length = rng.exponential(0.08, (n, 1))
        want = prev + direction * length
        dest = want.reshape(-1).copy()
        flying = np.ones(n, np.int8)
        weights = np.ones(n)
        groups = rng.integers(0, G, n).astype(np.int32)
        mats = np.zeros(n, np.int32)
        snaps["run"]["moves"].append(
            (want.copy(), flying.copy(), weights.copy(), groups.copy(),
             mats.copy()))
        if move == 1:
            snaps["move"] = _snapshot(tally, want, groups)
        paths = (scatter.BUCKET_LAUNCHES, scatter.CROWDED_LAUNCHES)
        t0 = time.perf_counter()
        tally.move_to_next_location(dest, flying, weights, groups, mats)
        secs = time.perf_counter() - t0
        st = tally.last_stats
        took = (scatter.BUCKET_LAUNCHES - paths[0],
                scatter.CROWDED_LAUNCHES - paths[1])
        log(f"[main] move {move}: ordered scatter took the "
            f"{scatter.LAST_BUCKETS['path']} path (bucket, crowded calls "
            f"{took}); {scatter.LAST_BUCKETS}")
        final = dest.reshape(n, 3)
        if flying.any():
            raise AssertionError(f"move {move}: flying not reset")
        outside = ((want < 0) | (want > 1)).any(axis=1)
        on_bound = (np.minimum(final, 1 - final).min(axis=1) <= 1e-5)
        if not (mats[outside] == -1).all() or not on_bound[outside].all():
            raise AssertionError(
                f"move {move}: a lane that left the domain is not on the "
                "boundary with material id -1"
            )
        reach = np.abs(final[~outside] - want[~outside]).max()
        if not reach <= 1e-5 or not (mats == -1).all():
            raise AssertionError(
                f"move {move}: inside destinations not reached ({reach})"
            )
        if st["truncated"]:
            raise AssertionError(f"move {move}: truncated walks")
        path += float(np.linalg.norm(final - prev, axis=1).sum())
        prev = final.copy()
        if move >= 2:
            late_segs += st["segments"]
            late_secs += secs
        most_segs = max(most_segs, st["segments"])
        log(f"[main] move {move}: {secs:.4f} s, segments={st['segments']}, "
            f"crossings={st['crossings']}, loop_iters={st['loop_iters']}, "
            f"segments/s={st['segments'] / secs:.4e}, "
            f"left domain={int(outside.sum())}")

    log(f"[main] moves 2-4: {late_segs} segments in {late_secs:.4f} s, "
        f"segments/s={late_segs / late_secs:.4e}")

    scored = float(tally.raw_flux[..., 0].astype(np.float64).sum())
    rel = abs(scored - path) / path
    log(f"[main] conservation: flux sum {scored:.9e} vs path {path:.9e}, "
        f"rel {rel:.3e} (limit 1e-4)")
    if not rel <= 1e-4:
        raise AssertionError("conservation invariant violated")

    out = os.path.join(tmpdir, "fluxresult.vtu")
    t0 = time.perf_counter()
    tally.write_pumi_tally_mesh(out)
    log(f"[main] write_pumi_tally_mesh: {time.perf_counter() - t0:.3f} s, "
        f"{os.path.getsize(out)} bytes")
    torch.cuda.synchronize()
    launches = read_counts()
    with open(out) as f:
        head = f.read(4096)
    cells_m = re.search(r'NumberOfCells="(\d+)"', head)
    if cells_m is None or int(cells_m.group(1)) != mesh.ntet:
        raise AssertionError(".vtu does not hold the mesh's cells")
    # cost.peak.cuda (phase 26) holds this peak to the analytic allowance.
    snaps["peak"] = dict(bytes=torch.cuda.max_memory_allocated(),
                         segments=most_segs)
    log(f"[main] times: init {tally.tally_times.initialization_time:.3f} s, "
        f"tally {tally.tally_times.total_time_to_tally:.3f} s, "
        f"vtk {tally.tally_times.vtk_file_write_time:.3f} s; "
        f"max_memory_allocated={snaps['peak']['bytes']} bytes")
    log(f"[main] launches: {launches}; transfers {tally.io}")
    if (tally.io["h2d_transfers"], tally.io["d2h_transfers"]) != (5, 5):
        raise AssertionError("the packed facade did not make one transfer "
                             "each way a call")
    if launches["walk"] != 5 + launches["walk_relaunches"]:
        raise AssertionError(f"walk kernel launches {launches}: not 5 "
                             "walks and their relaunches")
    walks = launches["walk"] - launches["walk_relaunches"]
    if launches["schedule"] != 3 * walks:
        raise AssertionError("the lane schedule did not run its 3 kernels "
                             "once a walk")
    if launches["scatter_ordered"] != 4:
        raise AssertionError("the ordered scatter did not run once a move")
    if launches["scatter_bucket"] != 4 or launches["scatter_crowded"]:
        raise AssertionError("a move's ordered scatter left the bucket path")
    if launches["scatter_atomic"] or launches["gather"]:
        raise AssertionError("the facade launched a probe kernel")
    return tally, snaps, launches


def main_move_inputs(rng, n: int, G: int, prev: np.ndarray):
    """One main-path move's destinations (isotropic flights of mean 0.08
    from ``prev``) and groups."""
    direction = rng.normal(size=(n, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    want = prev + direction * rng.exponential(0.08, (n, 1))
    return want, rng.integers(0, G, n).astype(np.int32)


def io_run(mesh, mode: str, *, clocked: bool, profiled: bool) -> dict:
    """The main-path cell's initial search and moves 1-4 under one
    ``io_pipeline`` mode, from numpy seed 1 (the main path's inputs).
    ``clocked`` times each host step of every move (``StepClock``: host
    clock and stream span) and the host waits inside the walk;
    ``profiled`` traces moves 2-4 with torch.profiler for the card's busy
    share. Returns the write-backs, the flux, the per-move host seconds,
    segments, transfers and step rows, and the launches counted."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.ops import scatter, walk_cuda
    from pumiumtally_tpu_torch.utils.timing import StepClock

    n, G = MAIN_PARTICLES, MAIN_GROUPS
    rng = np.random.default_rng(1)
    tally = PumiTally(mesh, n, TallyConfig(n_groups=G, io_pipeline=mode),
                      device=DEVICE)
    pos = rng.uniform(0.05, 0.95, (n, 3))
    torch.cuda.synchronize()
    zero_counts()
    tally.initialize_particle_location(pos.reshape(-1))
    if clocked:
        tally.step_clock = StepClock(DEVICE)
    prev, outs, moves, prof = pos, [], [], None
    for move in range(1, 5):
        want, groups = main_move_inputs(rng, n, G, prev)
        dest = want.reshape(-1).copy()
        mats = np.zeros(n, np.int32)
        io0 = dict(tally.io)
        if profiled and move == 2:
            prof = start_profile()
        t0 = time.perf_counter()
        tally.move_to_next_location(dest, np.ones(n, np.int8), np.ones(n),
                                    groups, mats)
        secs = time.perf_counter() - t0
        row = dict(move=move, secs=secs,
                   segments=tally.last_stats["segments"],
                   io={k: tally.io[k] - io0[k] for k in io0})
        if clocked:
            row["steps"] = tally.step_clock.rows()
            row["count_wait_ms"] = walk_cuda.LAST_WAIT_S * 1e3
            row["bucket_wait_ms"] = scatter.LAST_BUCKETS.get(
                "wait_s", float("nan")) * 1e3
        moves.append(row)
        outs.append((dest.copy(), mats.copy()))
        prev = dest.reshape(n, 3).copy()
    busy = (stop_profile(prof, 3, sum(m["secs"] for m in moves[1:]))
            if profiled else None)
    torch.cuda.synchronize()
    return dict(mode=mode, outs=outs, flux=tally.raw_flux, moves=moves,
                busy=busy, launches=read_counts())


def start_profile():
    """A torch.profiler session tracing the card's activity only (kernels
    and copies, CUPTI), so the host runs untraced."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop_profile(prof, calls: int, host_s: float) -> dict:
    """Stop a ``start_profile`` session after ``calls`` calls that took
    ``host_s`` seconds on the host clock: per call, the card's busy time
    (the device events only: kernels, copies and fills), its copies'
    part, the host time, and the busy share of the host time."""
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    rows = device_rows(prof)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    copies = sum(e.self_device_time_total for e in rows
                 if e.key.startswith(("Memcpy", "Memset"))) / 1e6
    return dict(busy_ms=busy / calls * 1e3, copy_ms=copies / calls * 1e3,
                span_ms=host_s / calls * 1e3, share=busy / host_s,
                kernel_share=(busy - copies) / host_s,
                top=[(e.key[:60], e.self_device_time_total / calls / 1e3)
                     for e in sorted(rows, key=lambda e:
                                     -e.self_device_time_total)[:8]])


def print_io_run(run: dict) -> None:
    """A run's moves (host clock, segments, transfers), segments/s of
    moves 2-4 and, when profiled, the card's busy share and its kernels."""
    mode, tag = run["mode"], "profiled" if run["busy"] else "clocked"
    for m in run["moves"]:
        log(f"[io] {mode} ({tag}) move {m['move']}: {m['secs'] * 1e3:.4f} ms "
            f"host clock, segments {m['segments']}, transfers {m['io']}")
    late = run["moves"][1:]
    segs, secs = sum(m["segments"] for m in late), sum(m["secs"] for m in late)
    run["segments_per_s"] = segs / secs
    log(f"[io] {mode} ({tag}) moves 2-4: {segs} segments in {secs:.4f} s, "
        f"segments/s={segs / secs:.4e}")
    if run["busy"] is not None:
        b = run["busy"]
        log(f"[io] {mode} moves 2-4 profiled, per move: card busy "
            f"{b['busy_ms']:.4f} ms (copies {b['copy_ms']:.4f} ms) of "
            f"{b['span_ms']:.4f} ms on the host clock, busy share "
            f"{b['share']:.4f} (kernels alone {b['kernel_share']:.4f})")
        for key, ms in b["top"]:
            log(f"[io]   {ms:9.4f} ms {key}")


def print_step_table(label: str, moves: list, tag: str = "[io]") -> None:
    """Median, least and most of each host step (host clock and stream
    span) over ``moves``, which carry StepClock rows, in step order."""
    steps: dict = {}
    for m in moves:
        for r in m["steps"]:
            steps.setdefault(r["step"], []).append(r)
        for key in ("count_wait_ms", "bucket_wait_ms"):
            if key in m:
                steps.setdefault(f"  {key[:-3]}", []).append(
                    {"host_ms": m[key], "stream_ms": None})
    for name, rows in steps.items():
        host = np.array([r["host_ms"] for r in rows])
        span = [r["stream_ms"] for r in rows if r["stream_ms"] is not None]
        stream = (f"; stream span median {np.median(span):.4f} ms"
                  if span else "")
        log(f"{tag} {label} {name:<16} host median {np.median(host):.4f} ms "
            f"(least {host.min():.4f}, most {host.max():.4f}, "
            f"{len(host)} samples){stream}")


IO_MODES = ("legacy", "packed", "overlap")
# The clocked runs, in turns, so that each mode meets the host's drift.
IO_TURNS = ("legacy", "packed", "overlap", "overlap", "packed", "legacy")
PIPE_BATCHES = 4


def phase_io(mesh) -> dict:
    """The main-path cell under each ``io_pipeline`` mode: clocked runs in
    turns (``IO_TURNS``: per-step host table over moves 2-4 of both turns,
    segments/s of moves 2-4) and one profiled run a mode (busy share of
    moves 2-4). Every run's write-backs and flux must be bitwise equal to
    the first's."""
    runs: dict = {m: [] for m in IO_MODES}
    ref = None
    for mode, clocked in ([(m, True) for m in IO_TURNS]
                          + [(m, False) for m in IO_MODES]):
        run = io_run(mesh, mode, clocked=clocked, profiled=not clocked)
        print_io_run(run)
        outs, flux = run.pop("outs"), run.pop("flux")
        if ref is None:
            ref = dict(mode=mode, outs=outs, flux=flux)
        for k, ((d, m), (d0, m0)) in enumerate(zip(outs, ref["outs"]), 1):
            if not (np.array_equal(d, d0) and np.array_equal(m, m0)):
                raise AssertionError(f"{mode}: move {k}'s write-backs "
                                     f"differ from {ref['mode']}'s")
        if not np.array_equal(flux, ref["flux"]):
            raise AssertionError(f"{mode}: flux differs from "
                                 f"{ref['mode']}'s")
        want = (4, 1) if mode == "legacy" else (1, 1)
        for m in run["moves"]:
            got = (m["io"]["h2d_transfers"], m["io"]["d2h_transfers"])
            if got != want:
                raise AssertionError(f"{mode} move {m['move']}: "
                                     f"transfers {got}, not {want}")
        la = run["launches"]
        if la["walk"] != 5 or la["scatter_bucket"] != 4:
            raise AssertionError(f"{mode}: launches {la}")
        runs[mode].append(run)
    out = {}
    for mode in IO_MODES:
        clocked = [r for r in runs[mode] if r["busy"] is None]
        print_step_table(f"{mode} moves 2-4",
                         [m for r in clocked for m in r["moves"][1:]])
        print_step_table(f"{mode} move 1",
                         [r["moves"][0] for r in clocked])
        rates = [r["segments_per_s"] for r in clocked]
        busy = [r["busy"] for r in runs[mode] if r["busy"]][0]
        out[mode] = dict(segments_per_s=rates, busy=busy,
                         launches=clocked[0]["launches"])
        log(f"[io] {mode}: moves 2-4 segments/s in turns "
            f"{', '.join(f'{x:.4e}' for x in rates)}; busy share "
            f"{busy['share']:.4f}; write-backs and flux bitwise equal to "
            f"{ref['mode']}'s; launches {clocked[0]['launches']}")
    return out


def pipeline_batches(mesh, n: int, G: int) -> list:
    """Independent batches at the main path's cell (numpy seed 11): lanes
    start at the centroids of random elements and fly isotropically (mean
    0.08), unit weights, random groups."""
    rng = np.random.default_rng(11)
    cent = mesh.centroids().double().cpu().numpy()
    out = []
    for _ in range(PIPE_BATCHES):
        elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
        want, group = main_move_inputs(rng, n, G, cent[elem])
        out.append((cent[elem], want, elem, group))
    return out


def walk_batch(mesh, cfg, batch, flux, capacity=None):
    """One batch through ``walk_cuda.trace`` with pageable copies in and
    out (the outputs a pipeline batch reads back: positions, elements,
    material ids, stats): the pipeline's sequential reference. Returns the
    positions."""
    from pumiumtally_tpu_torch.ops import walk_cuda

    origin, dest, elem, group = batch
    n, dev, dt = len(elem), mesh.device, cfg.dtype
    r = walk_cuda.trace(
        mesh, torch.from_numpy(origin).to(dev, dt),
        torch.from_numpy(dest).to(dev, dt), torch.from_numpy(elem).to(dev),
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.ones(n, dtype=dt, device=dev), torch.from_numpy(group).to(dev),
        torch.full((n,), -1, dtype=torch.int32, device=dev), flux,
        initial=False, max_crossings=cfg.resolve_max_crossings(mesh.ntet),
        n_groups=cfg.n_groups, tolerance=cfg.tolerance, capacity=capacity,
    )
    r.elem.cpu(), r.material_id.cpu(), r.stats.cpu()
    return r.position.cpu().numpy()


def phase_pipeline(mesh) -> dict:
    """``PIPE_BATCHES`` independent batches of the main-path width through
    ``StreamingTallyPipeline`` at depth 1 and 2, each held bitwise (flux
    and every batch's positions) to the same batches through sequential
    ``walk_cuda.trace``; batches per second on the host clock (the
    sequential walk with pageable copies beside them) and, from a second,
    profiled run, the card's busy share."""
    from pumiumtally_tpu_torch import TallyConfig
    from pumiumtally_tpu_torch.models.pipeline import StreamingTallyPipeline
    from pumiumtally_tpu_torch.ops import walk_cuda
    from pumiumtally_tpu_torch.utils.timing import StepClock

    cfg = TallyConfig(n_groups=MAIN_GROUPS)
    n = MAIN_PARTICLES
    batches = pipeline_batches(mesh, n, cfg.n_groups)
    ref = torch.zeros(mesh.ntet * cfg.n_groups * 2, dtype=cfg.dtype,
                      device=mesh.device)
    ref_pos = [walk_batch(mesh, cfg, b, ref) for b in batches]
    cap = walk_cuda.record_capacity(n, max(
        walk_cuda.path_records(walk_cuda.face_rate(mesh), b[0], b[1],
                               np.ones(n, bool)) for b in batches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = torch.zeros_like(ref)
    for b in batches:
        walk_batch(mesh, cfg, b, seq, capacity=cap)
    seq.cpu()
    seq_s = time.perf_counter() - t0
    log(f"[pipe] sequential walk_cuda.trace with pageable copies (the flux "
        f"read back at the end, as finish() does): {PIPE_BATCHES} batches "
        f"of {n} lanes in {seq_s:.4f} s, {PIPE_BATCHES / seq_s:.4f} "
        "batches/s")
    out = {"sequential_batches_per_s": PIPE_BATCHES / seq_s}
    for depth in (1, 2):
        # The warm-up run fills the caching allocators (pinned host
        # buffers, device blocks), so the timed runs see the steady state
        # a long stream of batches runs in.
        for run in ("warm-up", "clocked", "profiled"):
            zero_counts()
            torch.cuda.synchronize()
            prof = start_profile() if run == "profiled" else None
            t0 = time.perf_counter()
            pipe = StreamingTallyPipeline(mesh, cfg, depth=depth)
            if run == "clocked":
                pipe.step_clock = StepClock(DEVICE)
            submit_s = []
            for origin, dest, elem, group in batches:
                t1 = time.perf_counter()
                pipe.submit(origin, dest, elem, group=group)
                submit_s.append(time.perf_counter() - t1)
            flux = pipe.finish()
            secs = time.perf_counter() - t0
            got = list(pipe.results())
            launches = read_counts()
            if not np.array_equal(flux.reshape(-1), ref.cpu().numpy()):
                raise AssertionError(f"pipeline depth {depth}: flux differs "
                                     "from sequential walk_cuda.trace")
            if [b.index for b in got] != list(range(PIPE_BATCHES)):
                raise AssertionError(f"pipeline depth {depth}: results out "
                                     "of order")
            for b, want in zip(got, ref_pos):
                if not (np.array_equal(b.position, want) and b.all_done):
                    raise AssertionError(f"pipeline depth {depth}: batch "
                                         f"{b.index}'s positions differ")
            if (launches["walk"] != PIPE_BATCHES + launches["walk_relaunches"]
                    or launches["scatter_bucket"] != PIPE_BATCHES):
                raise AssertionError(f"pipeline depth {depth}: launches "
                                     f"{launches}")
            if run == "profiled":
                b = stop_profile(prof, PIPE_BATCHES, secs)
                log(f"[pipe] depth {depth} profiled, per batch: card busy "
                    f"{b['busy_ms']:.4f} ms (copies {b['copy_ms']:.4f} ms) "
                    f"of {b['span_ms']:.4f} ms on the host clock, busy share "
                    f"{b['share']:.4f} (kernels alone "
                    f"{b['kernel_share']:.4f})")
                for key, ms in b["top"]:
                    log(f"[pipe]   {ms:9.4f} ms {key}")
                out[f"depth{depth}_busy"] = b
                continue
            log(f"[pipe] depth {depth} {run}: {PIPE_BATCHES} batches in "
                f"{secs:.4f} s, {PIPE_BATCHES / secs:.4f} batches/s; submit "
                f"calls {[round(x * 1e3, 4) for x in submit_s]} ms; flux and "
                f"positions bitwise equal to sequential walk_cuda.trace; "
                f"launches {launches}")
            if run == "warm-up":
                continue
            rows = pipe.step_clock.rows()
            for r in rows:
                span = ("" if r["stream_ms"] is None
                        else f", stream span {r['stream_ms']:.4f} ms")
                log(f"[pipe]   depth {depth} {r['step']:<9} host "
                    f"{r['host_ms']:.4f} ms{span}")
            flux_s = sum(r["host_ms"] for r in rows
                         if r["step"] == "flux") / 1e3
            out[f"depth{depth}_batches_per_s"] = PIPE_BATCHES / secs
            out[f"depth{depth}_launches"] = launches
            steady = (PIPE_BATCHES - 1) / sum(submit_s[1:])
            out[f"depth{depth}_steady_submits_per_s"] = steady
            log(f"[pipe] depth {depth}: {PIPE_BATCHES / secs:.4f} batches/s "
                f"with finish()'s flux copy ({flux_s * 1e3:.4f} ms), "
                f"{PIPE_BATCHES / (secs - flux_s):.4f} without it; submits "
                f"2-{PIPE_BATCHES} (past the first batch's set-up) "
                f"{steady:.4f} a second")
    return out


def zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from pumiumtally_tpu_torch.ops import exchange_cuda, integrity_cuda
    from pumiumtally_tpu_torch.ops import gather, scatter, source_cuda
    from pumiumtally_tpu_torch.ops import walk_cuda

    walk_cuda.LAUNCHES = walk_cuda.RELAUNCHES = 0
    walk_cuda.FEATURE_LAUNCHES = walk_cuda.SCHEDULE_LAUNCHES = 0
    walk_cuda.UNPACKED_LAUNCHES = walk_cuda.PART_LAUNCHES = 0
    walk_cuda.BLOCK_LAUNCHES = dict.fromkeys(walk_cuda.BLOCKS, 0)
    scatter.ATOMIC_LAUNCHES = scatter.ORDERED_LAUNCHES = 0
    scatter.BUCKET_LAUNCHES = scatter.CROWDED_LAUNCHES = 0
    gather.LAUNCHES = source_cuda.LAUNCHES = 0
    exchange_cuda.BUCKET_LAUNCHES = exchange_cuda.ADOPT_LAUNCHES = 0
    integrity_cuda.LAUNCHES = 0


def read_counts() -> dict:
    from pumiumtally_tpu_torch.ops import exchange_cuda, integrity_cuda
    from pumiumtally_tpu_torch.ops import gather, scatter, source_cuda
    from pumiumtally_tpu_torch.ops import walk_cuda

    return {
        "walk": walk_cuda.LAUNCHES,
        "walk_relaunches": walk_cuda.RELAUNCHES,
        "walk_features": walk_cuda.FEATURE_LAUNCHES,
        "walk_unpacked": walk_cuda.UNPACKED_LAUNCHES,
        "walk_partitioned": walk_cuda.PART_LAUNCHES,
        "scatter_ordered": scatter.ORDERED_LAUNCHES,
        "scatter_bucket": scatter.BUCKET_LAUNCHES,
        "scatter_crowded": scatter.CROWDED_LAUNCHES,
        "scatter_atomic": scatter.ATOMIC_LAUNCHES,
        "schedule": walk_cuda.SCHEDULE_LAUNCHES,
        "gather": gather.LAUNCHES,
        "source": source_cuda.LAUNCHES,
        "exchange_bucket": exchange_cuda.BUCKET_LAUNCHES,
        "exchange_adopt": exchange_cuda.ADOPT_LAUNCHES,
        "integrity": integrity_cuda.LAUNCHES,
    }


def _snapshot(tally, dest: np.ndarray, groups: np.ndarray) -> dict:
    """The walk inputs a facade call is about to use (unit weights, all
    lanes flying, as the main path drives them)."""
    s = tally.state
    return dict(
        origin=s.origin.clone(), elem=s.elem.clone(),
        material_id=s.material_id.clone(), flux=tally.flux.clone(),
        dest=np.array(dest, copy=True), groups=np.array(groups, copy=True),
    )


def touched(mesh, args, kw, end_elem, scores: bool) -> tuple[int, int]:
    """Distinct geo20 rows and flux bins one walk cannot avoid: the rows of
    the start and end elements and of every element a segment scored in,
    and (when the walk scores) the (element, group) bins it adds to. The
    scored elements come from a probe launch with unit weights into a zero
    flux; rows only chased through are left out, so the count is a lower
    bound."""
    from pumiumtally_tpu_torch.ops import walk_cuda

    origin, elem, weight = args[1], args[3], args[5]
    probe = walk_cuda.trace(
        *args[:5], torch.ones_like(weight), *args[6:],
        torch.zeros(mesh.ntet * kw["n_groups"] * 2, dtype=origin.dtype,
                    device=origin.device),
        **kw,
    )
    hit = probe.flux.view(mesh.ntet, kw["n_groups"], 2)[..., 0] > 0
    rows = hit.any(dim=1)
    rows[elem.long()] = True
    rows[end_elem.long()] = True
    return int(rows.sum()), (int(hit.sum()) if scores else 0)


def replay_args(tally, snap, initial: bool):
    """The walk arguments of a snapshotted main-path call (without the
    flux) and its keywords."""
    mesh, cfg = tally.mesh, tally.config
    dev, dtype = mesh.device, cfg.dtype
    n = tally.num_particles
    dest = torch.from_numpy(snap["dest"]).to(dev, dtype)
    fly = torch.ones(n, dtype=torch.bool, device=dev)
    weight = torch.ones(n, dtype=dtype, device=dev)
    if initial:  # the facade walks its zero-initialized weights
        weight = torch.zeros(n, dtype=dtype, device=dev)
    group = torch.from_numpy(snap["groups"]).to(dev, torch.int32)
    args = (mesh, snap["origin"], dest, snap["elem"], fly, weight, group,
            snap["material_id"])
    kw = dict(initial=initial, max_crossings=tally._max_crossings,
              n_groups=cfg.n_groups, tolerance=cfg.tolerance)
    return args, kw


def phase_kernel_vs_plain_full(tally, snap, initial: bool) -> dict:
    """Replay one main-path walk (the initial search or the first move)
    through the kernel and the plain walk: compare, then time both. The
    move is also timed in its parts and with the atomic tally; its plain
    result, its records and a record capacity that holds them are returned
    for the later phases."""
    from pumiumtally_tpu_torch.ops import scatter, walk, walk_cuda

    mesh, dtype = tally.mesh, tally.config.dtype
    n = tally.num_particles
    args, kw = replay_args(tally, snap, initial)
    label = "initial search" if initial else "move 1"
    k = walk_cuda.trace(*args, snap["flux"].clone(), **kw)
    trips = int(walk_cuda.WARP_TRIPS)
    p = walk.trace(*args, snap["flux"].clone(), **kw)
    err = compare(k, p, dtype, 1e-5, 0.0, f"main-path {label} ({dtype})")
    # Buffers for every record (at most one per segment), so the timed
    # calls never run the walk again.
    cap = {} if initial else {"capacity": int(k.n_segments)}
    share = active_share(k.lane_iters, trips)
    runs = walk_orders(args, snap["flux"], kw, cap.get("capacity", 0))
    resident = walk_cuda.resident_threads(dtype, initial=initial)
    log(f"[share] {label}: active-lane share {share:.4f} (Σ lane "
        f"iterations / (32 · {trips} warp trips), {resident} resident "
        f"threads); one thread per lane in launch order (the earlier "
        f"design, 32-lane groups): {launch_order_share(k.lane_iters):.4f}")
    by = "destination cell" if initial else "start element"
    log(f"[order] {label}: walk launch with lanes by {by} "
        f"{runs['slots']['ms']:.4f} ms (lane schedule "
        f"{runs['order_ms']:.4f} ms included, share "
        f"{runs['slots']['share']:.4f}); in launch order "
        f"{runs['launch']['ms']:.4f} ms (share "
        f"{runs['launch']['share']:.4f}); median of 5")
    if not initial:
        slot_sum = runs["slots"]["ms"] + runs["slots"]["scatter_ms"]
        launch_sum = runs["launch"]["ms"] + runs["launch"]["scatter_ms"]
        log(f"[order] {label}: ordered scatter of the records of the walk "
            f"by {by} {runs['slots']['scatter_ms']:.4f} ms, in launch "
            f"order {runs['launch']['scatter_ms']:.4f} ms; walk and "
            f"scatter {slot_sum:.4f} / {launch_sum:.4f} ms")

    def fresh():
        return (snap["flux"].clone(),)

    ms = event_ms(lambda f: walk_cuda.trace(*args, f, **kw, **cap), 5, fresh)
    # One call of the plain walk (0.8-1.8 s at this size) is its yardstick.
    plain_ms = event_ms(lambda f: walk.trace(*args, f, **kw), 1, fresh)
    out = {}
    if not initial:
        wkw = {key: v for key, v in kw.items() if key != "initial"}
        _, rec = walk_cuda.walk_records(*args, snap["flux"].clone(), **wkw,
                                        **cap)
        nbins = mesh.ntet * kw["n_groups"]
        out = dict(
            walk_ms=event_ms(
                lambda f: walk_cuda.walk_records(*args, f, **wkw, **cap), 5,
                fresh),
            atomic_ms=event_ms(
                lambda f: walk_cuda.trace(*args, f, **kw, tally="atomic"), 5,
                fresh),
            records=rec, plain=p, **cap,
            **scatter_paths(snap["flux"], rec, nbins),
        )
        profile_call("ordered move 1",
                     lambda: walk_cuda.trace(*args, snap["flux"].clone(),
                                             **kw, **cap))
        log(f"[kernel] move 1 ordered = walk into {rec.bin.numel()} records "
            f"{out['walk_ms']:.4f} ms + ordered scatter "
            f"{out['scatter_ms']:.4f} ms (whole call {ms:.4f} ms); atomic "
            f"walk {out['atomic_ms']:.4f} ms")
    item = torch.finfo(dtype).bits // 8
    rows = int(k.lane_iters.sum(dtype=torch.int64))
    segs = int(k.n_segments)
    table_rows, bins = touched(mesh, args, dict(kw, **cap), k.elem,
                               scores=not initial)
    nbytes = table_rows * 20 * item + bins * 2 * 2 * item + n * (
        LANE_IN[item] + LANE_OUT[item]
    )
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = rows * FLOPS_PER_ITER / (
        FP32_FLOPS if item == 4 else FP64_FLOPS
    ) * 1e3
    log(f"[kernel] walk, main-path {label}: {ms:.4f} ms (median of 5), "
        f"plain {plain_ms:.4f} ms (one call); lane iterations (row reads) {rows}, "
        f"their bytes {rows * 20 * item}, segments {segs}; distinct rows "
        f"{table_rows}, flux bins written {bins}, bytes that must move "
        f"{nbytes}, bytes bound {bytes_ms:.4f} ms, operations bound "
        f"{ops_ms:.4f} ms")
    if initial:
        profile_call("initial search",
                     lambda: walk_cuda.trace(*args, snap["flux"].clone(),
                                             **kw))
    return dict(
        ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        max_abs_err=err["max_abs_err"], share=share,
        launch_order_share=launch_order_share(k.lane_iters),
        slot_order_ms=runs["slots"]["ms"],
        launch_order_ms=runs["launch"]["ms"], **out,
    )


def scatter_paths(flux0, rec, nbins: int) -> dict:
    """Move 1's records through the ordered scatter's bucket path (the
    wrapper the walk calls), its crowded path called directly, and
    ``torch.argsort`` + ``Tensor.index_put_(accumulate=True)``: each held
    bitwise to the plain version, then timed in turns (CUDA events,
    median of 5); the bucket path's calls profiled by kernel."""
    from pumiumtally_tpu_torch.ops import scatter
    from pumiumtally_tpu_torch.probes.gather_scatter import library_ordered

    def bucket(f):
        return scatter.ordered_cuda(f, rec.bin, rec.order, rec.c, True, nbins)

    def crowded(f):
        return scatter.crowded_cuda(f, rec.bin, rec.order, rec.c, True, nbins)

    def library(f):
        return library_ordered(f, rec.bin, rec.order, rec.c)

    ref = scatter.scatter_ordered_plain(flux0.clone(), rec.bin, rec.order,
                                        rec.c)
    before = scatter.BUCKET_LAUNCHES
    if not torch.equal(bucket(flux0.clone()), ref):
        raise AssertionError("move 1: the bucket path differs from plain")
    if scatter.BUCKET_LAUNCHES != before + 1:
        raise AssertionError("move 1's records left the bucket path")
    info = dict(scatter.LAST_BUCKETS)
    if not torch.equal(crowded(flux0.clone()), ref):
        raise AssertionError("move 1: the crowded path differs from plain")
    lib_equal = bool(torch.equal(library(flux0.clone()), ref))

    def fresh():
        return (flux0.clone(),)

    out = {}
    for name, fn in (("scatter_ms", bucket), ("crowded_ms", crowded),
                     ("library_ms", library), ("scatter_ms_2", bucket),
                     ("crowded_ms_2", crowded)):
        out[name] = event_ms(fn, 5, fresh)
    log(f"[scatter] move 1's {rec.bin.numel()} records into {nbins} bins: "
        f"bucket path {out['scatter_ms']:.4f} / {out['scatter_ms_2']:.4f} ms "
        f"(shift {info['shift']}, {info['buckets']} buckets, largest "
        f"{info['largest']} of capacity {info['capacity']}), crowded path "
        f"{out['crowded_ms']:.4f} / {out['crowded_ms_2']:.4f} ms, "
        f"torch.argsort + index_put_(accumulate=True) "
        f"{out['library_ms']:.4f} ms (bitwise equal: {lib_equal}); median "
        "of 5 each, in turns")
    profile_call("ordered scatter of move 1, bucket path",
                 lambda: bucket(flux0.clone()))
    return dict(out, buckets=info)


def active_share(iters, trips: int) -> float:
    """Σ lane iterations over the lane slots of the warps' loop trips."""
    return int(iters.sum(dtype=torch.int64)) / (WARP * trips)


def launch_order_share(iters) -> float:
    """The active-lane share of one thread per lane, lanes in launch order:
    each 32-lane warp issues for as long as its longest lane."""
    pad = torch.nn.functional.pad(iters, (0, (-iters.numel()) % WARP))
    longest = pad.view(-1, WARP).amax(dim=1).sum(dtype=torch.int64)
    return int(iters.sum(dtype=torch.int64)) / (WARP * int(longest))


def walk_orders(args, flux0, kw, capacity: int) -> dict:
    """The walk launch alone, its lanes taken in the schedule's slot order
    (``lane_records``, the schedule included) and in launch order (records
    built beforehand): time (median of 5) and active-lane share of each,
    and the schedule alone. A move's records from each order are also
    folded by the ordered scatter, timed: the order the walk makes its
    records in is the order the scatter's passes meet their bins in."""
    from pumiumtally_tpu_torch.ops import scatter, walk_cuda

    initial = kw["initial"]
    full = dict(kw, score_squares=True, robust=True, ledger=True,
                stats=True, ordered=not initial, capacity=capacity)
    n = args[1].shape[0]

    def slots():
        return walk_cuda.lane_records(*args[:7], initial=initial)

    in_launch_order = walk_cuda.lane_records_plain(
        torch.arange(n, device=args[1].device), *args[1:7])
    order = {
        "slots": lambda f: walk_cuda._launch(*args, f, **full,
                                             lanes=slots()),
        "launch": lambda f: walk_cuda._launch(*args, f, **full,
                                              lanes=in_launch_order),
    }

    def fresh():
        return (flux0.clone(),)

    out = {}
    for name, fn in order.items():
        o = fn(flux0.clone())
        trips = int(walk_cuda.WARP_TRIPS)
        out[name] = dict(ms=event_ms(fn, 5, fresh))
        if not initial:
            o, rec, made = o
            b, k, c = (r[:made] for r in rec)
            out[name]["scatter_ms"] = event_ms(
                lambda f: scatter.ordered_cuda(f, b, k, c, True,
                                               flux0.numel() // 2), 5, fresh)
        out[name]["share"] = active_share(o["iters"], trips)
    out["order_ms"] = event_ms(slots, 5)
    return out


def device_rows(prof) -> list:
    """A profile's device events (kernels, copies, fills) by name: the rows
    on the card, without the CPU ops that carry their kernels' device time
    (counting those too counts a torch op twice) and without CUPTI's own
    buffer requests."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and e.key != "Activity Buffer Request"]


def profile_call(label: str, fn, calls: int = 3) -> None:
    """Device time by kernel per call, from torch.profiler's CUDA activity
    (CUPTI) over ``calls`` calls after a warm-up; the share of the calls'
    host span the card was busy."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) / calls
    rows = device_rows(prof)
    busy = sum(e.self_device_time_total for e in rows) / calls
    log(f"[profile] {label}, per call of {calls}: {len(rows)} device "
        f"kernels, busy {busy / 1e3:.4f} ms of a {span * 1e3:.4f} ms host "
        "span")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total):
        log(f"[profile]   {e.self_device_time_total / calls / 1e3:9.4f} ms "
            f"x{e.count / calls:g} {e.key[:90]}")


def phase_reproducible(tally, snap, move) -> dict:
    """Move 1 twice through the ordered walk (same bits) and twice through
    the atomic walk, each atomic run held against the plain walk
    (``move["plain"]`` from phase 5) and their run-to-run difference
    reported. The atomic replays are the atomic walk's path: its launches
    are counted there."""
    from pumiumtally_tpu_torch.ops import walk_cuda

    args, kw = replay_args(tally, snap, initial=False)
    cap = move["capacity"]
    a = walk_cuda.trace(*args, snap["flux"].clone(), **kw, capacity=cap)
    b = walk_cuda.trace(*args, snap["flux"].clone(), **kw, capacity=cap)
    if not torch.equal(a.flux, b.flux):
        raise AssertionError("ordered walk: two runs of move 1 differ")
    zero_counts()
    x = walk_cuda.trace(*args, snap["flux"].clone(), **kw, tally="atomic")
    y = walk_cuda.trace(*args, snap["flux"].clone(), **kw, tally="atomic")
    torch.cuda.synchronize()
    launches = read_counts()["walk"]
    dtype = tally.config.dtype
    err = max(
        compare(r, move["plain"], dtype, 1e-5, 1e-4,
                f"main-path move 1 atomic run {i}")["max_abs_err"]
        for i, r in enumerate((x, y), 1)
    )
    diff = (x.flux.double() - y.flux.double()).abs()
    log(f"[repro] ordered: two runs of move 1 bitwise equal; atomic: two "
        f"runs differ in {int((diff > 0).sum())} of {diff.numel()} flux "
        f"entries, max |diff| {float(diff.max()):.3e}; atomic vs plain "
        f"max abs err {err:.3e}; atomic walk launches {launches}")
    return dict(flux=a.flux, launches=launches, max_abs_err=err)


def phase_overflow(tally, snap, ordered_flux) -> None:
    """Move 1 with buffers for OVERFLOW_CAPACITY records: the walk runs
    again with buffers of its count and gives the same flux bits."""
    from pumiumtally_tpu_torch.ops import walk_cuda

    args, kw = replay_args(tally, snap, initial=False)
    before = walk_cuda.RELAUNCHES
    r = walk_cuda.trace(*args, snap["flux"].clone(), **kw,
                        capacity=OVERFLOW_CAPACITY)
    if walk_cuda.RELAUNCHES != before + 1:
        raise AssertionError("a capacity of 1,000 records did not overflow")
    if not torch.equal(r.flux, ordered_flux):
        raise AssertionError("the relaunched walk's flux differs")
    log(f"[overflow] capacity {OVERFLOW_CAPACITY}: walk relaunched once, "
        "flux bitwise equal to the ordered walk's")


def phase_probe(tally, snap, rec) -> tuple[dict, dict]:
    """The gather/scatter probe with the main path's table and move 1's
    records; its launch counts are zeroed before and read after."""
    from pumiumtally_tpu_torch.probes import gather_scatter

    records = dict(flux=snap["flux"].clone(), bin=rec.bin, order=rec.order,
                   c=rec.c)
    zero_counts()
    payload = gather_scatter.run(DEVICE, geo20=tally.mesh.geo20,
                                 records=records)
    torch.cuda.synchronize()
    launches = read_counts()
    for p in payload["probes"]:
        log(f"[probe] {p['probe']} {p['shape']}: ok={p['ok']} "
            f"agree={p['agree']} {p['usec_per_call']} us (plain "
            f"{p['plain_usec_per_call']}, {p['library']} "
            f"{p['library_usec_per_call']}), {p['gbps']} GB/s, bound "
            f"{p['bound_usec']} us" + (f" {p['error']}" if p["error"] else ""))
    bad = [p for p in payload["probes"] if not p["ok"]]
    if bad:
        raise AssertionError(f"probes failed: {bad}")
    log(f"[probe] launches: {launches}")
    atomic = [p for p in payload["probes"] if p["probe"] == "scatter_atomic"]
    log(f"[probe] K3 outer with move 1's records: "
        f"{atomic[-1]['usec_per_call'] / 1e3:.4f} ms, Tensor.index_add_ "
        f"{atomic[-1]['library_usec_per_call'] / 1e3:.4f} ms (median of 5)")
    return payload, launches


def probe_gather_f64() -> dict:
    """K2 at the walk's shape in float64: the geo20 of the main path's box
    built in float64 (int64 topology codes as float bits), gathered at the
    probe's 16,934,705 indices, bitwise against its plain version and
    timed beside it and ``torch.index_select``; its launches are counted
    apart from the probe path's."""
    from pumiumtally_tpu_torch.mesh.box import build_box
    from pumiumtally_tpu_torch.probes import gather_scatter as gs

    cells = MAIN_CELLS
    geo = build_box(1.0, 1.0, 1.0, cells, cells, cells, dtype=torch.float64,
                    device=DEVICE).geo20
    ridx = np.random.default_rng(3).integers(0, geo.shape[0], gs.WALK_RECORDS)
    idx = torch.from_numpy(ridx.astype(np.int32)).to(DEVICE)
    zero_counts()
    p = gs.gather_probe(geo, idx)
    torch.cuda.synchronize()
    p["launches"] = read_counts()["gather"]
    log(f"[probe] gather float64 {p['shape']}: ok={p['ok']} "
        f"agree={p['agree']} {p['usec_per_call']} us (plain "
        f"{p['plain_usec_per_call']}, {p['library']} "
        f"{p['library_usec_per_call']}), {p['gbps']} GB/s, bound "
        f"{p['bound_usec']} us, launches {p['launches']}"
        + (f" {p['error']}" if p["error"] else ""))
    if not p["ok"]:
        raise AssertionError(f"float64 gather failed: {p}")
    return p


def probe_atomic_f64(rec, nbins: int) -> dict:
    """K3 outer in float64 (two scalar adds a record) against its plain
    version, with and without squares: at the JAX probe's shapes and with
    move 1's records, their contributions in float64. Returns the reading
    with move 1's records and squares."""
    from pumiumtally_tpu_torch.probes import gather_scatter as gs

    cases = [(gs.probe_scatter_inputs(B, ntet, G, DEVICE), (B, ntet, G))
             for B, ntet, G in gs.SCATTER_SHAPES]
    cases.append((dict(flux=torch.zeros(2 * nbins, device=DEVICE),
                       bin=rec.bin, order=rec.order, c=rec.c),
                  (rec.bin.numel(), nbins)))
    move1 = None
    for r, shape in cases:
        for sq in (True, False):
            p = gs.scatter_probe("atomic", r["flux"].double(), r["bin"],
                                 r["order"], r["c"].double(), shape,
                                 score_squares=sq)
            log(f"[probe] scatter_atomic float64 {shape} squares={sq}: "
                f"ok={p['ok']} agree={p['agree']} {p['usec_per_call']} us, "
                f"Tensor.index_add_ {p['library_usec_per_call']} us"
                + (f" {p['error']}" if p["error"] else ""))
            if not p["ok"]:
                raise AssertionError(f"float64 atomic scatter failed: {p}")
            if sq:
                move1 = p
    log(f"[probe] K3 outer float64 with move 1's records: "
        f"{move1['usec_per_call'] / 1e3:.4f} ms, Tensor.index_add_ "
        f"{move1['library_usec_per_call'] / 1e3:.4f} ms, plain "
        f"{move1['plain_usec_per_call'] / 1e3:.4f} ms, bound "
        f"{move1['bound_usec'] / 1e3:.4f} ms (median of 5)")
    return move1


def sass_reductions(lib: str, kernel: str) -> list[str]:
    """The atomic instructions (RED*, ATOM*) of the functions in lib's SASS
    (cuobjdump) whose mangled name contains ``kernel``."""
    from pumiumtally_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    found, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and re.search(r"\b(RED|ATOM)G?\.", line):
            found.append(re.sub(r"\s+", " ", line.split(";")[0]).strip())
    return found


def check_sass(libs: list[str]) -> None:
    """The float32 atomic scatter (aligned records) and the float32 atomic
    walk must add each (c, c²) pair with one vector reduction."""
    lib = dict(zip(SOURCES, libs))
    for source, kernel in (("scatter", "atomic_kernelIfLb1E"),
                           ("walk", "walk_kernelIfLb1ELb0ELb0E")):
        ops = sass_reductions(lib[source], kernel)
        log(f"[sass] {kernel}: {ops}")
        if not any("F32x2" in op for op in ops):
            raise AssertionError(f"{kernel}: no vector reduction in its SASS")


def device_kernels(fn, calls: int = 3, tries: int = 3) -> list:
    """torch.profiler's device events of ``calls`` calls of ``fn`` after a
    warm-up, by name: (name, device ms per event, events). CUPTI may drop
    an event, so a kernel's time is the mean over the events it kept; a
    trace that kept no device event at all is taken again, at most
    ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if rows:
            break
    return [(e.key, e.self_device_time_total / e.count / 1e3, e.count)
            for e in rows]


SCHEDULE_KERNEL_NAMES = ("lane_count", "lane_scan", "lane_place")


def phase_schedule(tally, snaps) -> dict:
    """The lane schedule (``walk_cuda.lane_records``) against
    ``lane_records_plain`` on the inputs of the main path's first move and
    of its initial search: every lane's record must be the plain
    version's bytes (matched through Lane.index), the keys non-decreasing
    in slot order, the key counts and the scan's ticket left at zero.
    Timed: its device time by kernel (torch.profiler over 3 calls: its
    three kernels and no other event, no memset or copy), its CUDA-event
    span (median of 5), the plain version's (keys and records) and
    ``torch.argsort``'s of the keys, beside its bound: each lane's inputs
    read once and its Lane written once (``LANE_PAYLOAD``; the padding to
    whole sectors is the design's cost, not the function's). Its
    ``max_abs_err`` is the largest difference of any decoded field from
    the plain version's."""
    from pumiumtally_tpu_torch.ops import walk_cuda

    out = {}
    for label, initial in (("move 1", False), ("initial search", True)):
        args, _ = replay_args(tally, snaps["initial" if initial else "move"],
                              initial)
        mesh, origin, dest, elem = args[:4]
        dtype, n = origin.dtype, origin.shape[0]

        def kernel():
            return walk_cuda.lane_records(*args[:7], initial=initial)

        def plain():
            keys, _ = walk_cuda.lane_keys(mesh, elem, dest, initial)
            return walk_cuda.lane_records_plain(keys, *args[1:7])

        rec = kernel()
        keys, nkeys = walk_cuda.lane_keys(mesh, elem, dest, initial)
        want = plain()
        idx = walk_cuda.decode_lanes(rec, dtype)["index"].long()
        if not torch.equal(torch.sort(idx).values,
                           torch.arange(n, device=idx.device)):
            raise AssertionError(f"schedule, {label}: not a permutation")
        by_lane = torch.empty_like(rec)
        by_lane[idx] = rec
        want = want[torch.argsort(
            walk_cuda.decode_lanes(want, dtype)["index"].long())]
        differ = int((by_lane != want).any(dim=1).sum())
        err = _field_err(walk_cuda.decode_lanes(by_lane, dtype),
                         walk_cuda.decode_lanes(want, dtype))
        if differ:
            raise AssertionError(f"schedule, {label}: {differ} lanes' "
                                 "records differ from the plain version's "
                                 f"(largest field difference {err})")
        if not bool((keys[idx][1:] >= keys[idx][:-1]).all()):
            raise AssertionError(f"schedule, {label}: keys out of order")
        for ws in walk_cuda._WORKSPACES.values():
            if ws["counts"].any() or ws["ticket"].any():
                raise AssertionError(f"schedule, {label}: counts not zero")
        rows = device_kernels(kernel)
        names = [next((k for k in SCHEDULE_KERNEL_NAMES if k in key), key)
                 for key, _, _ in rows]
        if sorted(names) != sorted(SCHEDULE_KERNEL_NAMES):
            raise AssertionError(f"schedule, {label}: device events {rows}, "
                                 "not its three kernels alone")
        item = origin.element_size()
        bound = n * (LANE_IN[item] + walk_cuda.LANE_PAYLOAD[dtype]) / (
            HBM_BYTES_PER_S) * 1e3
        r = dict(
            device_ms=sum(ms for _, ms, _ in rows),
            kernels={name: ms for name, (_, ms, _) in zip(names, rows)},
            span_ms=event_ms(kernel, 5), plain_ms=event_ms(plain, 5),
            library_ms=event_ms(lambda: torch.argsort(keys), 5),
            bound_ms=bound, max_abs_err=err, lanes_differ=differ,
            keys=nkeys,
        )
        out[label] = r
        log(f"[schedule] {label}: {n} lanes over {nkeys} keys, records equal "
            f"to the plain version's ({differ} lanes differ, largest field "
            f"difference {err}), keys in order, counts left at zero; "
            f"device {r['device_ms']:.4f} ms ("
            + ", ".join(f"{k} {v:.4f}" for k, v in r["kernels"].items())
            + f"; torch.profiler, mean over 3 calls), event span "
            f"{r['span_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"torch.argsort of the keys {r['library_ms']:.4f} ms, bound "
            f"{bound:.4f} ms (bytes; median of 5)")
    return out


def _field_err(got: dict, want: dict) -> float:
    """The largest absolute difference between two decodings of lane
    records, over every field; a field whose values are the same (NaN
    against NaN included) differs by 0."""
    err = 0.0
    for name, a in got.items():
        b = want[name]
        if a.dtype == torch.bool:
            a, b = a.int(), b.int()
        a, b = a.double(), b.double()
        same = (a == b) | (a.isnan() & b.isnan())
        d = torch.where(same, torch.zeros_like(a), (a - b).abs())
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def phase_point_source(tally) -> None:
    """Every lane starts at one point (the centroid of the element nearest
    the box centre) and flies one move: the ordered scatter of its records
    against the plain version, timed, with its largest bin."""
    from pumiumtally_tpu_torch.ops import scatter, walk_cuda

    mesh, cfg = tally.mesh, tally.config
    dev, dtype, n = mesh.device, cfg.dtype, tally.num_particles
    cent = mesh.centroids()
    e0 = int(((cent - 0.5) ** 2).sum(dim=1).argmin())
    rng = np.random.default_rng(7)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    origin = cent[e0].expand(n, 3).contiguous()
    dest = origin + torch.from_numpy(d * rng.exponential(0.08, (n, 1))).to(
        dev, dtype)
    group = torch.from_numpy(
        rng.integers(0, cfg.n_groups, n).astype(np.int32)).to(dev)
    args = (mesh, origin, dest,
            torch.full((n,), e0, dtype=torch.int32, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.ones(n, dtype=dtype, device=dev), group,
            torch.full((n,), -1, dtype=torch.int32, device=dev))
    flux0 = torch.zeros(mesh.ntet * cfg.n_groups * 2, dtype=dtype, device=dev)
    res, rec = walk_cuda.walk_records(
        *args, flux0, max_crossings=tally._max_crossings,
        n_groups=cfg.n_groups, tolerance=cfg.tolerance)
    per_bin = torch.bincount(rec.bin)
    nbins = mesh.ntet * cfg.n_groups
    crowded = scatter.CROWDED_LAUNCHES
    got = scatter.scatter_ordered(flux0.clone(), rec.bin, rec.order, rec.c)
    log(f"[point] ordered scatter took the {scatter.LAST_BUCKETS['path']} "
        f"path: {scatter.LAST_BUCKETS}")
    if scatter.CROWDED_LAUNCHES != crowded + 1:
        raise AssertionError("point source: the scatter was not crowded")
    t0 = time.perf_counter()
    ref = scatter.scatter_ordered_plain(flux0.clone(), rec.bin, rec.order,
                                        rec.c)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not torch.equal(got, ref):
        raise AssertionError("point source: ordered scatter differs from "
                             "its plain version")

    def fresh():
        return (flux0.clone(),)

    ms = event_ms(lambda f: scatter.ordered_cuda(f, rec.bin, rec.order,
                                                 rec.c, True, nbins), 5, fresh)
    log(f"[point] {n} lanes from element {e0}: {rec.bin.numel()} records, "
        f"largest bin {int(per_bin.max())} records, bins over 32 records "
        f"{int((per_bin > 32).sum())}; ordered scatter {ms:.4f} ms (median "
        f"of 5), bitwise equal to the plain version ({plain_s:.3f} s on the "
        f"host clock); walk truncated {int((~res.done).sum())}")


def stats_run(mesh, cfg_kw: dict, *, nan_move: int = 0, park: bool = False,
              evens: bool = False, clocked: bool = False,
              snap: dict | None = None) -> dict:
    """The main-path cell's initial search and moves 1-4 (numpy seed 1,
    the main path's inputs, ``io_pipeline="packed"``) with the
    ``TallyConfig`` fields ``cfg_kw``. On move ``nan_move`` the first
    ``RUNSTATS_BAD`` lanes get NaN destinations, or with ``park`` are
    given ``flying=0`` instead. Returns the tally, each move's host
    seconds and write-backs, the per-move transfers, (``evens``) the
    flux's even entries after each move in float64 and (``clocked``)
    each move's host steps (``StepClock``). ``snap`` receives move 1's
    inputs (``_snapshot``) and, with ``record_xpoints``, its crossing
    points (``intersection_points``)."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.utils.timing import StepClock

    n, G = MAIN_PARTICLES, MAIN_GROUPS
    rng = np.random.default_rng(1)
    tally = PumiTally(mesh, n, TallyConfig(n_groups=G, **cfg_kw),
                      device=DEVICE)
    pos = rng.uniform(0.05, 0.95, (n, 3))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # nothing is lost
        tally.initialize_particle_location(pos.reshape(-1))
        if clocked:
            tally.step_clock = StepClock(DEVICE)
        prev, out = pos, dict(secs=[], outs=[], io=[], evens=[], moves=[])
        for move in range(1, 5):
            want, groups = main_move_inputs(rng, n, G, prev)
            dest = want.reshape(-1).copy()
            flying = np.ones(n, np.int8)
            if move == nan_move:
                if park:
                    flying[:RUNSTATS_BAD] = 0
                else:
                    dest[:3 * RUNSTATS_BAD] = np.nan
            mats = np.zeros(n, np.int32)
            io0 = dict(tally.io)
            if move == 1 and snap is not None:
                snap.update(_snapshot(tally, want, groups))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tally.move_to_next_location(dest, flying, np.ones(n), groups,
                                        mats)
            out["secs"].append(time.perf_counter() - t0)
            if move == 1 and snap is not None and \
                    tally.config.record_xpoints is not None:
                snap["xpoints"] = tally.intersection_points()
            if clocked:
                out["moves"].append(dict(steps=tally.step_clock.rows()))
            out["io"].append({k: tally.io[k] - io0[k] for k in io0})
            out["outs"].append((dest.copy(), mats.copy()))
            if evens:
                out["evens"].append(tally.flux[0::2].double().cpu().numpy())
            prev = dest.reshape(n, 3).copy()
    torch.cuda.synchronize()
    out["tally"] = tally
    return out


def _log_moves(label: str, run: dict) -> None:
    """A run's per-move host seconds and, when clocked, its host steps
    over moves 2-4."""
    log(f"[stats] {label}: moves 1-4 host "
        f"{', '.join(f'{x * 1e3:.4f}' for x in run['secs'])} ms; moves "
        f"2-4 median {float(np.median(run['secs'][1:])) * 1e3:.4f} ms")
    if run["moves"]:
        print_step_table(f"{label} moves 2-4", run["moves"][1:], "[stats]")


def _same_outputs(a: dict, b: dict, label: str) -> None:
    for k, ((d, m), (d0, m0)) in enumerate(zip(a["outs"], b["outs"]), 1):
        if not (np.array_equal(d, d0) and np.array_equal(m, m0)):
            raise AssertionError(f"{label}: move {k}'s write-backs differ")


def _batch_oracle(evens: list, cuts: list, target: float) -> dict:
    """The convergence summary in host float64 from the even entries
    after each move: batches end after the moves in ``cuts``."""
    snaps = np.stack([np.zeros_like(evens[0])] + [evens[c - 1]
                                                  for c in cuts])
    t = np.diff(snaps, axis=0)
    nb = t.shape[0]
    s1, s2 = t.sum(0), (t * t).sum(0)
    scored = s1 > 0
    rel = np.where(scored, np.sqrt(np.maximum(nb * s2 - s1 * s1, 0.0)
                                   / max(nb - 1, 1))
                   / np.where(scored, s1, 1.0), 0.0)
    return dict(n_batches=nb, scored=int(scored.sum()),
                sum_rel_err=float(rel.sum()), max_rel_err=float(rel.max()),
                converged=int((scored & (rel <= target)).sum()),
                near=int((np.abs(rel - target) < 1e-3 * target).sum()))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def phase_run_statistics(mesh) -> dict:
    """The run statistics and recovery at the main cell, each from the
    main path's inputs under ``io_pipeline="packed"``: (a) convergence
    reads only (flux bitwise the run without it, one transfer each way a
    move, its summary the float64 host recomputation), (b) batch sd (even
    entries bitwise (a)'s, odd entries Σ (ΔT)² in float64), (c) a
    truncation re-walk (nothing lost, the ample run's elements and flux;
    move 1's walk and re-walks kernel against plain walk on the card,
    bitwise), (d) quarantine (the parked run's flux, bitwise). Times the
    move with convergence on and off in turns, the convergence fold and
    the batch fold (CUDA events), the re-walk, and the peak memory.
    Launches are counted over the facade runs only."""
    from pumiumtally_tpu_torch.core.tally import accumulate_batch_squares
    from pumiumtally_tpu_torch.obs.convergence import (
        CONV_FIELDS, ConvState, fold_and_reduce)
    from pumiumtally_tpu_torch.ops import scatter, walk, walk_cuda

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    runs = {}
    # Move wall time with convergence off and on, in turns.
    for label, kw in (("off", {}), ("on", RUNSTATS_CONV),
                      ("on", RUNSTATS_CONV), ("off", {})):
        run = stats_run(mesh, kw, evens=label == "off" and "off" not in runs)
        _log_moves(f"convergence {label}", run)
        runs.setdefault(label, run)
        runs.setdefault(f"{label} secs", []).append(run["secs"])
        if run is not runs[label]:
            _same_outputs(run, runs[label], f"convergence {label}")
        del run
    base, conv = runs["off"], runs["on"]
    for label in ("off", "on"):
        med = [float(np.median(s[1:])) * 1e3 for s in runs[f"{label} secs"]]
        log(f"[stats] convergence {label}: moves 2-4 host median "
            f"{', '.join(f'{m:.4f}' for m in med)} ms in turns "
            f"(off, on, on, off)")

    # (a) Convergence only reads.
    t_a = conv["tally"]
    if not torch.equal(t_a.flux, base["tally"].flux):
        raise AssertionError("(a) convergence changed the flux")
    _same_outputs(conv, base, "(a)")
    for k, io in enumerate(conv["io"], 1):
        if (io["h2d_transfers"], io["d2h_transfers"]) != (1, 1):
            raise AssertionError(f"(a) move {k} transfers {io}")
    summary = dict(zip(CONV_FIELDS,
                       t_a._conv.summary.double().cpu().tolist()))
    want = _batch_oracle(base["evens"], [2, 4],
                         t_a.config.rel_err_target)
    tm = t_a.telemetry()
    log(f"[stats] (a) summary {summary}; float64 recomputation {want}; "
        f"telemetry {tm['convergence']}")
    if tm["convergence"]["n_batches"] != 2 or want["n_batches"] != 2:
        raise AssertionError("(a) not 2 batches")
    if summary["scored"] != want["scored"]:
        raise AssertionError("(a) scored bins differ")
    for f in ("sum_rel_err", "max_rel_err"):
        if not _rel(summary[f], want[f]) <= 1e-5:
            raise AssertionError(f"(a) {f} {summary[f]} vs {want[f]}")
    if abs(summary["converged"] - want["converged"]) > want["near"]:
        raise AssertionError("(a) converged bins differ")

    # (b) Batch sd.
    b = stats_run(mesh, dict(sd_mode="batch"), clocked=True)
    _log_moves("(b) sd_mode='batch'", b)
    fb, fa = b["tally"].flux, t_a.flux
    if not torch.equal(fb[0::2], fa[0::2]):
        raise AssertionError("(b) even entries differ from (a)'s")
    totals = np.diff(np.stack([np.zeros_like(base["evens"][0])]
                              + base["evens"]), axis=0)
    sq = (totals * totals).sum(0)
    odd = fb[1::2].double().cpu().numpy()
    # Squares below the walk dtype's smallest normal number (a sliver
    # segment's ΔT² in float32) keep only an absolute precision of it.
    tiny = float(torch.finfo(fb.dtype).tiny)
    normal = sq >= tiny
    err = np.abs(odd - sq) / np.where(normal, sq, 1.0)
    sub = np.abs(odd - sq)[~normal]
    worst = int(np.argmax(np.where(normal, err, 0.0)))
    log(f"[stats] (b) odd entries vs float64 Σ (ΔT)²: max rel "
        f"{err[normal].max():.3e} (limit 1e-5; bin {worst}: "
        f"{odd[worst]:.9e} against {sq[worst]:.9e}) over "
        f"{int(normal.sum())} "
        f"bins; {int((~normal & (sq > 0)).sum())} bins below "
        f"{tiny:.3e} differ by at most {sub.max(initial=0):.3e} (limit "
        f"{tiny:.3e}); even entries bitwise (a)'s")
    if not (err[normal].max() <= 1e-5 and sub.max(initial=0) <= tiny):
        raise AssertionError("(b) odd entries differ")
    _same_outputs(b, base, "(b)")
    del b, fb, odd, err, totals, sq

    # (c) Truncation re-walk.
    c = stats_run(mesh, RUNSTATS_TRUNC, clocked=True)
    _log_moves(f"(c) {RUNSTATS_TRUNC}", c)
    t_c = c["tally"]
    tot = t_c.telemetry()["totals"]
    rec = [r for r in t_c.telemetry()["per_move"] if r["kind"] == "rewalk"]
    log(f"[stats] (c) {RUNSTATS_TRUNC}: rewalked "
        f"{tot['rewalked']} lanes, lost {tot['lost']}; per call "
        f"{[(r['move'], r['retried']) for r in rec]}")
    if not tot["rewalked"] > 0 or tot["lost"]:
        raise AssertionError("(c) re-walk did not recover every lane")
    if not np.array_equal(t_c.element_ids, base["tally"].element_ids):
        raise AssertionError("(c) elements differ from the ample run's")
    fc = t_c.flux.double()
    fbase = base["tally"].flux.double()
    bad = ((fc - fbase).abs() > 1e-5 * fbase.abs() + 1e-5).sum()
    log(f"[stats] (c) flux vs ample run: max abs "
        f"{float((fc - fbase).abs().max()):.3e}, bins beyond rtol 1e-5 + "
        f"atol 1e-5: {int(bad)}")
    if int(bad):
        raise AssertionError("(c) flux differs from the ample run's")
    del fc, fbase, c

    # (d) Quarantine.
    q = stats_run(mesh, dict(quarantine=True), nan_move=2)
    p = stats_run(mesh, {}, nan_move=2, park=True)
    _log_moves("(d) quarantine", q)
    _log_moves("(d) parked", p)
    lanes = q["tally"].quarantined_lanes()
    log(f"[stats] (d) quarantined {int(lanes.sum())} lanes, flux finite "
        f"{bool(torch.isfinite(q['tally'].flux).all())}, bitwise the "
        f"parked run's {bool(torch.equal(q['tally'].flux, p['tally'].flux))}")
    if lanes.sum() != RUNSTATS_BAD or lanes[:RUNSTATS_BAD].sum() != \
            RUNSTATS_BAD:
        raise AssertionError("(d) quarantined lanes")
    if not torch.isfinite(q["tally"].flux).all():
        raise AssertionError("(d) flux not finite")
    if not torch.equal(q["tally"].flux, p["tally"].flux):
        raise AssertionError("(d) flux differs from the parked run's")
    _same_outputs(q, p, "(d)")
    del q, p
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"[stats] launches over the facade runs: {launches}")
    if not launches["walk"] or not launches["scatter_bucket"]:
        raise AssertionError("run statistics did not launch the walk and "
                             "the bucket scatter")

    # Device time of the two folds at the main cell's flux.
    flux = t_a.flux.clone()
    nbins = flux.numel() // 2

    def fresh_state():
        st = ConvState.zeros(nbins, flux.dtype, flux.device)
        st.snap.copy_(flux[0::2] * 0.5)
        return (st,)

    fold_ms = event_ms(lambda st: fold_and_reduce(
        flux, st, batch_moves=1, rel_err_target=0.05), 5, fresh_state)
    prev = flux[0::2] * 0.5
    batch_ms = event_ms(
        lambda f, pe: accumulate_batch_squares(f, pe), 5,
        lambda: (flux.clone(), prev.clone()))
    nbytes = flux.element_size()
    fold_bound = (3 * nbins * nbytes + 2 * nbins * nbytes) / HBM_BYTES_PER_S
    batch_bound = (5 * nbins * nbytes) / HBM_BYTES_PER_S
    log(f"[stats] fold_and_reduce (a batch end, {nbins} bins): "
        f"{fold_ms:.4f} ms (bytes bound {fold_bound * 1e3:.4f} ms); "
        f"accumulate_batch_squares: {batch_ms:.4f} ms (bytes bound "
        f"{batch_bound * 1e3:.4f} ms); CUDA events, median of 5")

    # Move 1 replayed at the main cell, kernel against the plain walk on
    # the card: the move with squares off (batch sd's walk), and the walk
    # at (c)'s bound with its re-walks; the first re-walk attempt timed.
    from pumiumtally_tpu_torch import PumiTally, TallyConfig

    n, G, dev = MAIN_PARTICLES, MAIN_GROUPS, torch.device(DEVICE)
    rng = np.random.default_rng(1)
    t0 = PumiTally(mesh, n, TallyConfig(n_groups=G), device=DEVICE)
    pos = rng.uniform(0.05, 0.95, (n, 3))
    t0.initialize_particle_location(pos.reshape(-1))
    want1, groups = main_move_inputs(rng, n, G, pos)
    args = (mesh, t0.state.origin,
            torch.from_numpy(want1).to(dev, t0.config.dtype), t0.state.elem,
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.ones(n, dtype=t0.config.dtype, device=dev),
            torch.from_numpy(groups).to(dev), t0.state.material_id)
    kw = dict(initial=False, n_groups=G, tolerance=t0.config.tolerance)
    nosq = dict(kw, max_crossings=t0._max_crossings, score_squares=False)
    got = walk_cuda.trace(*args, t0.flux.clone(), **nosq)
    ref = walk.trace(*args, t0.flux.clone(), **nosq)
    compare(got, ref, t0.config.dtype, 1e-5, 0, "move 1, squares off")
    if not torch.equal(got.flux[1::2], t0.flux[1::2]):
        raise AssertionError("squares off: odd entries written")
    del got, ref
    mc = RUNSTATS_TRUNC["max_crossings"]
    first = walk_cuda.trace(*args, t0.flux.clone(), max_crossings=mc, **kw)
    pfirst = walk.trace(*args, t0.flux.clone(), max_crossings=mc, **kw)
    compare(first, pfirst, t0.config.dtype, 1e-5, 0,
            f"move 1 at max_crossings={mc}")
    todo = ~first.done
    n_todo = int(todo.sum())
    rw_args = (mesh, first.position, args[2], first.elem, todo, args[5],
               args[6], first.material_id)
    rw_kw = dict(max_crossings=2 * mc, n_groups=G,
                 tolerance=t0.config.tolerance,
                 capacity=min(2 * mc * n_todo, 8 * n))
    walk_ms = event_ms(lambda: walk_cuda.walk_records(
        *rw_args, first.flux, **rw_kw))
    _, rec1 = walk_cuda.walk_records(*rw_args, first.flux, **rw_kw)
    scat_ms = event_ms(lambda f: scatter.scatter_ordered(
        f, rec1.bin, rec1.order, rec1.c), 5,
        lambda: (first.flux.clone(),))
    retries = RUNSTATS_TRUNC["truncation_retries"]
    got, retried, lost = walk_cuda.rewalk_truncated(
        mesh, first, args[2], args[5], args[6], retries=retries,
        max_crossings=mc, **kw)
    ref, retried_p, lost_p = walk.rewalk_truncated(
        mesh, pfirst, args[2], args[5], args[6], retries=retries,
        max_crossings=mc, **kw)
    compare(got, ref, t0.config.dtype, 0, 0, "move 1 re-walked")
    log(f"[stats] (c) move 1 replayed: {n_todo} of {n} lanes truncated at "
        f"max_crossings={mc}, {retried} lane walks over the attempts, "
        f"{lost} lost; first re-walk (max_crossings={2 * mc}): walk into "
        f"{rec1.bin.numel()} records {walk_ms:.4f} ms, ordered scatter "
        f"{scat_ms:.4f} ms (CUDA events, median of 5)")
    if (retried, lost) != (retried_p, lost_p) or lost:
        raise AssertionError("(c) re-walk kernel differs from the plain walk")
    del got, ref, first, pfirst, rec1, t0
    peak = torch.cuda.max_memory_allocated()
    log(f"[stats] peak device memory {peak} bytes; card {card_line()}")
    return dict(launches=launches, fold_ms=fold_ms, batch_ms=batch_ms,
                rewalk_walk_ms=walk_ms, rewalk_scatter_ms=scat_ms,
                rewalked=tot["rewalked"], peak_bytes=peak)

# The feature-tails phase: the points kept a lane, the sort's cadence and
# the modes its runs take (legacy, packed, overlap, packed again for the
# run-to-run check), and the flux limit against the unsorted run: the sort
# changes only the add order of each bin's positive terms, so a bin of k
# terms differs by at most about k float32 roundings.
TAILS_K = 8
TAILS_SORT = dict(sort_by_element=True, migration_period=1)
TAILS_SORT_RTOL = 1e-5


def _turns(mesh, label: str, off: dict, on: dict, **kw) -> tuple:
    """Runs of the main cell with ``off`` and ``on`` in turns (off, on,
    on, off); logs the moves 2-4 host medians; returns the first off and
    on runs, after holding each repeat to its first run's write-backs and
    flux."""
    runs: dict = {}
    for tag, cfg in (("off", off), ("on", on), ("on", on), ("off", off)):
        run = stats_run(mesh, cfg, **(kw if tag == "on" else {}))
        runs.setdefault(f"{tag} secs", []).append(run["secs"])
        if tag in runs:
            _same_outputs(run, runs[tag], f"{label} {tag}")
            if not torch.equal(run["tally"].flux, runs[tag]["tally"].flux):
                raise AssertionError(f"{label} {tag}: flux differs by run")
        else:
            runs[tag] = run
    for tag in ("off", "on"):
        med = [float(np.median(x[1:])) * 1e3 for x in runs[f"{tag} secs"]]
        log(f"[tails] {label} {tag}: moves 2-4 host median "
            f"{', '.join(f'{m:.4f}' for m in med)} ms in turns "
            f"(off, on, on, off)")
    return runs["off"], runs["on"]


def phase_feature_tails(mesh) -> dict:
    """The walk's feature tails at the main cell (998,250 tets, 1,048,576
    lanes, 8 groups, float32, numpy seed 1; init and 4 moves a run):
    (a) ``record_xpoints=8``: move 1's points and counts from the facade
    and from the kernel replayed on its inputs against the plain walk on
    the card (counts equal, points within 1e-5), the flux bitwise the run
    with the points off, the buffers' bytes; (b) the element sort every
    move: positions, materials, element ids and flux bitwise equal across
    the three io_pipeline modes and across two packed runs, bitwise
    equal to the unsorted run but for the flux (rtol TAILS_SORT_RTOL);
    the sort's device ms and the lane schedule's kernels with sorted
    slots and unsorted ones; (c) ``checkify_invariants``: a clean run
    bitwise the unchecked legacy run, then the kernel called directly
    with a corrupted parent element and with a NaN destination must raise
    the walk's messages, each raise followed by a clean walk that gives
    its flux bits, and after both a checked facade run must give the
    unchecked run's flux bits. Each feature's move cost on against off,
    in turns;
    launches counted over each feature's facade runs."""
    from pumiumtally_tpu_torch.ops import walk, walk_cuda
    from pumiumtally_tpu_torch.ops.walk import CHECKS, WalkInvariantError

    out = {"launches": {}}
    n, K = MAIN_PARTICLES, TAILS_K

    # (a) Recorded intersection points.
    zero_counts()
    snap: dict = {}
    off, on = _turns(mesh, "(a) record_xpoints=8", {},
                     dict(record_xpoints=K), snap=snap)
    torch.cuda.synchronize()
    out["launches"]["xpoints"] = read_counts()
    _same_outputs(on, off, "(a)")
    if not torch.equal(on["tally"].flux, off["tally"].flux):
        raise AssertionError("(a) recording the points changed the flux")
    xp_h, kx_h = snap["xpoints"]
    args, kw = replay_args(on["tally"], snap, initial=False)
    kern = walk_cuda.trace(*args, snap["flux"].clone(), **kw,
                           record_xpoints=K)
    plain = walk.trace(*args, snap["flux"].clone(), **kw, record_xpoints=K)
    err = compare(kern, plain, args[1].dtype, 1e-5, 0,
                  "(a) move 1 with record_xpoints=8")
    counts_equal = bool(torch.equal(kern.n_xpoints, plain.n_xpoints))
    pts_err = float((kern.xpoints - plain.xpoints).abs().max())
    facade_err = float(np.abs(xp_h - plain.xpoints.double().cpu().numpy())
                       .max())
    facade_counts = bool(np.array_equal(kx_h, plain.n_xpoints.cpu().numpy()))
    nbytes = kern.xpoints.numel() * kern.xpoints.element_size()
    cbytes = kern.n_xpoints.numel() * kern.n_xpoints.element_size()
    counts = plain.n_xpoints
    log(f"[tails] (a) move 1 points: kernel vs plain counts equal "
        f"{counts_equal}, max|dpoint| {pts_err:.3e}; facade vs plain counts "
        f"equal {facade_counts}, max|dpoint| {facade_err:.3e} (limit 1e-5); "
        f"crossings a lane: mean {float(counts.double().mean()):.3f}, max "
        f"{int(counts.max())}, lanes past K {int((counts > K).sum())}; "
        f"buffers {nbytes} B of points + {cbytes} B of counts on the card")
    if not (counts_equal and facade_counts and pts_err <= 1e-5
            and facade_err <= 1e-5):
        raise AssertionError("(a) recorded points differ from the plain walk")
    flux0 = snap["flux"]
    rec_ms = event_ms(lambda f: walk_cuda.trace(*args, f, **kw,
                                                record_xpoints=K), 5,
                      lambda: (flux0.clone(),))
    base_ms = event_ms(lambda f: walk_cuda.trace(*args, f, **kw), 5,
                       lambda: (flux0.clone(),))
    log(f"[tails] (a) move 1 walk call: with record_xpoints=8 "
        f"{rec_ms:.4f} ms, without {base_ms:.4f} ms (CUDA events, median "
        "of 5)")
    out.update(xpoints_ms=rec_ms, walk_ms=base_ms,
               xpoints_err=max(pts_err, err["max_abs_err"]),
               xpoint_bytes=nbytes, count_bytes=cbytes)
    del kern, plain, on, off

    # (b) The element sort.
    zero_counts()
    runs = {}
    for label, cfg in (("off", dict(io_pipeline="packed")),
                       ("packed", dict(TAILS_SORT, io_pipeline="packed")),
                       ("overlap", dict(TAILS_SORT, io_pipeline="overlap")),
                       ("legacy", dict(TAILS_SORT, io_pipeline="legacy")),
                       ("packed again", dict(TAILS_SORT,
                                             io_pipeline="packed")),
                       ("off again", dict(io_pipeline="packed"))):
        runs[label] = stats_run(mesh, cfg)
        _log_moves(f"(b) sort {label}", runs[label])
    torch.cuda.synchronize()
    out["launches"]["sort"] = read_counts()
    for label in ("off", "packed"):
        med = [float(np.median(runs[x]["secs"][1:])) * 1e3
               for x in (label, f"{label} again")]
        log(f"[tails] (b) sort {'on' if label == 'packed' else 'off'} "
            f"(packed): moves 2-4 host median {med[0]:.4f}, {med[1]:.4f} ms "
            f"(runs 1 and 5, 2 and 6 of off, on, overlap, legacy, on, off)")
    ref = runs["packed"]["tally"]
    for label in ("overlap", "legacy", "packed again", "off"):
        t = runs[label]["tally"]
        _same_outputs(runs[label], runs["packed"], f"(b) {label}")
        if not np.array_equal(t.element_ids, ref.element_ids):
            raise AssertionError(f"(b) {label}: element ids differ")
        if label != "off" and not torch.equal(t.flux, ref.flux):
            raise AssertionError(f"(b) {label}: flux differs")
    fo, fs = runs["off"]["tally"].flux.double(), ref.flux.double()
    rel = float(((fo - fs).abs() / fo.abs().clamp_min(1e-300)).max())
    log(f"[tails] (b) sorted runs bitwise equal across legacy, packed, "
        f"overlap and two packed runs; against the unsorted run write-backs "
        f"and element ids bitwise, flux max rel {rel:.3e} (limit "
        f"{TAILS_SORT_RTOL:g}), bitwise {bool(torch.equal(fo, fs))}")
    if not rel <= TAILS_SORT_RTOL:
        raise AssertionError("(b) sorted flux beyond its limit")
    s = ref.state
    fields = [f.name for f in dataclasses.fields(s)]

    def sort_state():
        order = torch.argsort(s.elem, stable=True)
        return [getattr(s, f)[order] for f in fields]

    sort_ms = event_ms(sort_state)
    log(f"[tails] (b) the sort (stable argsort of {n} elements and the "
        f"gather of {len(fields)} state fields): {sort_ms:.4f} ms (CUDA "
        "events, median of 5)")
    sched = {}
    for label, tally in (("sorted", ref), ("unsorted",
                                           runs["off"]["tally"])):
        st = tally.state
        rows = device_kernels(lambda: walk_cuda.lane_records(
            mesh, st.origin, st.dest, st.elem, st.in_flight, st.weight,
            st.group, initial=False))
        sched[label] = {name: ms for name, ms, _ in rows}
        log(f"[tails] (b) lane schedule over {label} slots (device ms a "
            f"call, torch.profiler over 3 calls): "
            f"{', '.join(f'{k} {v:.4f}' for k, v in sched[label].items())}")
    place = {k: next(v for name, v in d.items() if "lane_place" in name)
             for k, d in sched.items()}
    out.update(sort_ms=sort_ms, place_sorted_ms=place["sorted"],
               place_unsorted_ms=place["unsorted"], sort_flux_rel=rel)
    del runs, ref, s

    # (c) The invariant checks.
    zero_counts()
    off, on = _turns(mesh, "(c) checkify_invariants",
                     dict(io_pipeline="legacy"),
                     dict(checkify_invariants=True))
    torch.cuda.synchronize()
    out["launches"]["checks"] = read_counts()
    _same_outputs(on, off, "(c)")
    if not torch.equal(on["tally"].flux, off["tally"].flux):
        raise AssertionError("(c) the checked run's flux differs")
    ref = walk_cuda.trace(*args, flux0.clone(), **kw)
    chk_ms = event_ms(lambda f: walk_cuda.trace(*args, f, **kw,
                                                debug_checks=True), 5,
                      lambda: (flux0.clone(),))
    cents = mesh.centroids()
    far = int(torch.argmax(((cents - args[1][0]) ** 2).sum(dim=1)))
    bad_elem, bad_dest = args[3].clone(), args[2].clone()
    bad_elem[0] = far
    bad_dest[5] = float("nan")
    for label, i, bad, want in (("corrupted parent element", 3, bad_elem,
                                 CHECKS[0]),
                                ("NaN destination", 2, bad_dest, CHECKS[1])):
        flux = flux0.clone()
        try:
            walk_cuda.trace(*args[:i], bad, *args[i + 1:], flux, **kw,
                            debug_checks=True)
        except WalkInvariantError as e:
            got = str(e)
        else:
            raise AssertionError(f"(c) {label}: nothing raised")
        after = walk_cuda.trace(*args, flux0.clone(), **kw)
        torch.cuda.synchronize()
        log(f"[tails] (c) {label}: raised {got!r}; flux left as it was "
            f"{bool(torch.equal(flux, flux0))}; the next walk's flux "
            f"bitwise {bool(torch.equal(after.flux, ref.flux))}")
        if got != want or not torch.equal(flux, flux0) \
                or not torch.equal(after.flux, ref.flux):
            raise AssertionError(f"(c) {label}: check or context failed")
    again = stats_run(mesh, dict(checkify_invariants=True))
    same = torch.equal(again["tally"].flux, off["tally"].flux)
    log(f"[tails] (c) after the raises, a checked facade run (init and 4 "
        f"moves) gives the unchecked run's flux bits: {same}")
    if not same:
        raise AssertionError("(c) the run after the raises differs")
    _same_outputs(again, off, "(c) after the raises")
    del again
    log(f"[tails] (c) move 1 walk call with the checks {chk_ms:.4f} ms, "
        f"without {base_ms:.4f} ms (CUDA events, median of 5)")
    out.update(checks_ms=chk_ms)
    for feat, counts in out["launches"].items():
        log(f"[tails] launches over the {feat} runs: {counts}")
    if not (out["launches"]["xpoints"]["walk_features"]
            and out["launches"]["checks"]["walk_features"]
            and out["launches"]["sort"]["walk"]):
        raise AssertionError("the feature runs did not launch their walk")
    log(f"[tails] peak device memory {torch.cuda.max_memory_allocated()} "
        f"bytes; card {card_line()}")
    return out


# The megastep phase: the 20^3 box's lanes and fused moves, the full
# cell's chunk (bench.py's megastep cell: Σt 12.5 = 1/0.08, the main
# cell's mean flight), the transport cell's assembly and event cap, and
# the INT32 rate of the flight kernel's bound: 132 SMs x 64 INT32 lanes a
# clock (Hopper's SM has half as many INT32 as FP32 units) x 1.98 GHz.
MEGA_SMALL_LANES, MEGA_SMALL_MOVES = 4096, 4
MEGA_K, MEGA_SIGMA_T = 8, 12.5
TRANSPORT_CELLS, TRANSPORT_LATTICE, TRANSPORT_EVENTS = 55, 3, 1000
INT32_OPS = 132 * 64 * 1.98e9
# The walk's flux tolerance where kernel and plain runs may differ.
FLUX_RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}
# float32 / float64 bytes a lane of the flight kernel must move: pid,
# elem, alive, origin, class_id[elem] and sigma_t[region] read; dest,
# coll_u and roul_u written.
FLIGHT_BYTES = {4: 4 + 4 + 1 + 12 + 4 + 4 + 12 + 4 + 4,
                8: 4 + 4 + 1 + 24 + 4 + 8 + 24 + 8 + 8}


def _ulp_diff(got, want) -> tuple[int, float]:
    """Elements of ``got`` not bitwise ``want``, and their largest
    difference in ulps of max(|want|, 1)."""
    differ = got != want
    if not bool(differ.any()):
        return 0, 0.0
    eps = torch.finfo(want.dtype).eps
    ulps = ((got - want).abs() / (eps * want.abs().clamp_min(1.0)))[differ]
    return int(differ.sum()), float(ulps.max())


def flight_check(label, mesh, key, pid, elem, alive, origin, sig,
                 class_id=None, cap=None, max_local=None, tag="[mega]"
                 ) -> dict:
    """The flight kernel against its plain version on the card on one
    move's inputs: the five uniforms (the kernel's debug output) bitwise,
    the collision and roulette draws bitwise, the destinations bitwise or
    their differing elements counted with their largest ulp (limit 2: the
    directions' cos and sin round once each); the kernel's and the plain
    version's device ms. ``class_id`` (default the mesh's), ``cap`` and
    ``max_local`` give the stacked-row form of the partitioned megastep
    (lane i's region at row (i // cap)·max_local + clip(elem))."""
    from pumiumtally_tpu_torch.ops import source, source_cuda

    n, dtype = origin.shape[0], origin.dtype
    cls = mesh.class_id if class_id is None else class_id
    rows_kw = dict(cap=cap, max_local=max_local)
    u = torch.empty(n, 5, dtype=dtype, device=origin.device)
    launches = source_cuda.LAUNCHES
    dest, cu, ru = source_cuda.sample_flight(key, pid, n, elem, alive, origin,
                                             cls, sig, u_out=u, **rows_kw)
    pd, pc, pr = source.sample_flight_plain(key, pid, n, elem, alive, origin,
                                            cls, sig, **rows_kw)
    want_u = source.lane_uniforms(key, pid, n, dtype)
    torch.cuda.synchronize()
    if not torch.equal(u.view(torch.uint8), want_u.view(torch.uint8)):
        raise AssertionError(f"{label}: the kernel's uniforms differ")
    if not (torch.equal(cu, pc) and torch.equal(ru, pr)):
        raise AssertionError(f"{label}: collision/roulette draws differ")
    n_diff, ulps = _ulp_diff(dest, pd)
    err = float((dest - pd).abs().max()) if n else 0.0
    if ulps > 2:
        raise AssertionError(f"{label}: {n_diff} destinations differ by up "
                             f"to {ulps} ulp (limit 2)")
    args = (key, pid, n, elem, alive, origin, cls, sig)
    ms = event_ms(lambda: source_cuda.sample_flight(*args, **rows_kw))
    plain_ms = event_ms(lambda: source.sample_flight_plain(*args, **rows_kw))
    source_cuda.LAUNCHES = launches  # comparisons count no launch
    item = origin.element_size()
    ml = cls.shape[0] if max_local is None else max_local
    rows = elem.long().clamp(0, ml - 1)
    if cap is not None:
        rows = rows + torch.arange(n, device=elem.device) // cap * ml
    distinct = int(torch.unique(rows).numel())
    nbytes = n * FLIGHT_BYTES[item] - n * 4 + distinct * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n * FLIGHT_INT_OPS / INT32_OPS * 1e3
    out = dict(max_abs_err=err, dest_differ=n_diff, max_ulp=ulps, ms=ms,
               plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               bytes_ms=bytes_ms, ops_ms=ops_ms)
    log(f"{tag} {label}: uniforms bitwise, draws bitwise, destinations "
        f"differing {n_diff} (largest {ulps:.1f} ulp, limit 2), max abs err "
        f"{err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms by {out['bound_by']} (bytes "
        f"{bytes_ms:.4f}, {FLIGHT_INT_OPS} integer ops a lane {ops_ms:.4f})")
    return out


def _mega_state(tally) -> dict:
    s = tally.state
    return {f: getattr(s, f).clone() for f in (
        "origin", "elem", "material_id", "weight", "group", "in_flight",
        "particle_id")}


def megastep_small(dtype) -> None:
    """(a) on the 20^3 box: move 1's flight kernel against plain, and 4
    fused moves through the kernels against the same moves through the
    plain sampling and the plain walk on the card."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.ops import source, walk
    from pumiumtally_tpu_torch.ops.staging import split_megastep_tail

    n, G = MEGA_SMALL_LANES, 2
    mesh = jittered_box(SMALL_CELLS, 0.2, 4, dtype)
    src = source.SourceParams(sigma_t={0: 4.0, 1: 9.0},
                              absorption={0: 0.3, 1: 0.5},
                              survival_weight=0.2, seed=13)
    tally = PumiTally(mesh, n, TallyConfig(n_groups=G, dtype=dtype,
                                           megastep=MEGA_SMALL_MOVES),
                      device=DEVICE)
    pos = np.random.default_rng(3).uniform(0.1, 0.9, (n, 3))
    tally.initialize_particle_location(pos.reshape(-1))
    s = _mega_state(tally)
    sig, ab, _ = tally._source_tables(src)
    key = source.prng_key(src.seed)
    flight_check(f"{dtype} 20^3 move 1", mesh, source.fold_in(key, 0),
                 s["particle_id"], s["elem"], s["in_flight"], s["origin"],
                 sig)
    statics = tally._megastep_statics(src)
    runs = {}
    for plain in (False, True):
        flux = tally.flux.clone()
        r = walk.megastep(
            mesh, s["origin"], s["elem"], s["material_id"], s["weight"],
            s["group"], s["in_flight"], s["particle_id"], flux, 0, key, sig,
            ab, n_moves=MEGA_SMALL_MOVES, plain=plain, **statics)
        tail, _, _, phys = split_megastep_tail(
            r.readback.cpu(), dtype, True, False, False)
        runs[plain] = (r, tail, phys)
    (k, kt, kp), (p, pt, pp) = runs[False], runs[True]
    if not (np.array_equal(kt, pt) and np.array_equal(kp[[0, 1, 2, 4, 5]],
                                                      pp[[0, 1, 2, 4, 5]])):
        raise AssertionError(f"{dtype} 20^3: counters differ: {kt} {kp} / "
                             f"{pt} {pp}")
    for f in ("elem", "material_id", "group", "alive"):
        if not torch.equal(getattr(k, f), getattr(p, f)):
            raise AssertionError(f"{dtype} 20^3: {f} differs")
    same = all(torch.equal(getattr(k, f), getattr(p, f))
               for f in ("dest", "position", "weight", "flux"))
    pos_tol = 1e-12 if dtype == torch.float64 else 1e-5
    pos_err = float((k.position - p.position).abs().max())
    flux_err = float(((k.flux - p.flux).abs()
                      / p.flux.abs().clamp_min(1e-30)).max())
    if not same and not (pos_err <= pos_tol
                         and flux_err <= FLUX_RTOL[dtype]):
        raise AssertionError(f"{dtype} 20^3: positions {pos_err}, flux "
                             f"{flux_err}")
    log(f"[mega] {dtype} 20^3 {MEGA_SMALL_MOVES} fused moves, kernels "
        f"against plain sampling + plain walk on the card: counters "
        f"{[int(x) for x in kt[[0, 3, 6]]]} (crossings, truncated, "
        f"segments) and physics {pp.tolist()} equal, discrete state equal, "
        f"{'bitwise in every output' if same else 'not bitwise'} "
        f"(positions {pos_err:.3e}, flux rel {flux_err:.3e})")



def mega_tally(mesh, k: int):
    from pumiumtally_tpu_torch import PumiTally, TallyConfig

    n = MAIN_PARTICLES
    tally = PumiTally(mesh, n, TallyConfig(n_groups=MAIN_GROUPS,
                                           tolerance=1e-6, megastep=k),
                      device=DEVICE)
    pos = np.random.default_rng(1).uniform(0.05, 0.95, (n, 3))
    tally.initialize_particle_location(pos.reshape(-1))
    return tally


def megastep_full(mesh) -> dict:
    """(b) the full cell: a warm call and a timed call of K = 8 moves
    (clocked by step, launches counted), then the same two calls at
    K = 1, which must end bitwise where K = 8 ended (flux, per-lane state,
    counters; the absorbed weight within rtol 1e-5, its grouping follows
    the chunks); a profiled K = 8 call for the busy share; the flight
    kernel at the timed call's first move."""
    from pumiumtally_tpu_torch.ops import source
    from pumiumtally_tpu_torch.utils.timing import StepClock

    n = MAIN_PARTICLES
    src = source.SourceParams(default_sigma_t=MEGA_SIGMA_T, seed=1)
    ones, zeros = np.ones(n), np.zeros(n, np.int32)
    alive = np.ones(n, bool)
    runs, keep = {}, None
    for k in (MEGA_K, 1):
        tally = mega_tally(mesh, k)
        t0 = time.perf_counter()
        tally.run_source_moves(MEGA_K, src, weights=ones, groups=zeros,
                               alive=alive)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        flight = None
        if k == MEGA_K:
            before = _mega_state(tally)
            flight = flight_check(
                "full cell, the timed call's first move", mesh,
                source.fold_in(source.prng_key(src.seed), tally.iter_count),
                before["particle_id"], before["elem"],
                torch.ones(n, dtype=torch.bool, device=mesh.device),
                before["origin"], tally._source_tables(src)[0])
            del before
            tally.step_clock = StepClock(DEVICE)
        seg0, io0 = tally.total_segments, dict(tally.io)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res = tally.run_source_moves(MEGA_K, src, weights=ones, alive=alive)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        segs = tally.total_segments - seg0
        io = {key: tally.io[key] - io0[key] for key in io0}
        log(f"[mega] full cell K={k}: warm call {warm:.4f} s; timed call "
            f"{res['moves']} moves, {segs} segments in {secs:.4f} s: "
            f"segments/s={segs / secs:.4e}, moves/s={res['moves'] / secs:.4f}"
            f"; {res}; transfers {io}; launches {counts}")
        if counts["source"] != res["moves"] or res["moves"] != MEGA_K:
            raise AssertionError(f"K={k}: flight kernel launches "
                                 f"{counts['source']} for {res['moves']} "
                                 "moves")
        if counts["walk"] != MEGA_K + counts["walk_relaunches"]:
            raise AssertionError(f"K={k}: walk launches {counts}")
        if io["d2h_transfers"] != -(-MEGA_K // k) or io["h2d_transfers"] != 2:
            raise AssertionError(f"K={k}: transfers {io}")
        runs[k] = dict(res=res, secs=secs, segs=segs, counts=counts,
                       warm_s=warm, flight=flight,
                       segments_per_s=segs / secs,
                       moves_per_s=res["moves"] / secs)
        state = _mega_state(tally)
        if keep is None:
            keep = dict(state=state, flux=tally.flux.clone(), res=res)
            runs[k]["steps"] = tally.step_clock.rows()
            tally.step_clock = None
            print_step_table(f"full cell K={k} timed call",
                             [{"steps": runs[k]["steps"]}], tag="[mega]")
            prof = start_profile()
            t0 = time.perf_counter()
            tally.run_source_moves(MEGA_K, src, weights=ones, alive=alive)
            busy = stop_profile(prof, 1, time.perf_counter() - t0)
            runs[k]["busy"] = busy
            log(f"[mega] full cell K={k} profiled call: card busy "
                f"{busy['busy_ms']:.4f} ms (copies {busy['copy_ms']:.4f}) of "
                f"{busy['span_ms']:.4f} ms host clock, busy share "
                f"{busy['share']:.4f} (kernels {busy['kernel_share']:.4f})")
            for key, ms in busy["top"]:
                log(f"[mega]   {ms:9.4f} ms {key}")
            del tally
            continue
        for f, v in state.items():
            if not torch.equal(v, keep["state"][f]):
                raise AssertionError(f"K=1 against K={MEGA_K}: {f} differs")
        if not torch.equal(tally.flux, keep["flux"]):
            raise AssertionError(f"K=1 against K={MEGA_K}: flux differs")
        for f in ("moves", "segments", "collisions", "escaped", "rouletted",
                  "alive", "truncated"):
            if res[f] != keep["res"][f]:
                raise AssertionError(f"K=1 against K={MEGA_K}: {f}")
        if not np.isclose(res["absorbed_weight"],
                          keep["res"]["absorbed_weight"], rtol=1e-5):
            raise AssertionError("K=1 against K=8: absorbed weight")
        log(f"[mega] full cell: {MEGA_K} x megastep-1 ends bitwise where "
            f"megastep-{MEGA_K} ended (flux, per-lane state, counters; "
            f"absorbed weight {res['absorbed_weight']:.9e} / "
            f"{keep['res']['absorbed_weight']:.9e})")
    return runs


def transport_run(sim, tally) -> dict:
    """One megastep batch of ``SyntheticTransport`` to its end: the batch's
    moves, segments and the host clock of its source moves (the tally's
    ``total_time_to_tally``; the initial search apart)."""
    moves0, segs0 = sim.stats.events, tally.total_segments
    t_tally0 = tally.tally_times.total_time_to_tally
    t0 = time.perf_counter()
    sim.run_batch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    secs = tally.tally_times.total_time_to_tally - t_tally0
    moves = sim.stats.events - moves0
    segs = tally.total_segments - segs0
    return dict(moves=moves, segments=segs, secs=secs, wall=wall,
                moves_per_s=moves / secs, segments_per_s=segs / secs)


def host_events(sim, tally, events: int) -> dict:
    """``events`` host-mode advance events of a fresh batch (the OpenMC
    call pattern through the packed facade), each on the host clock."""
    from pumiumtally_tpu_torch.utils.timing import StepClock

    pos = sim.start_batch()
    st = sim.host_state(pos)
    secs, segs, facade, moves = [], [], [], []
    tally.step_clock = StepClock(DEVICE)
    for _ in range(events):
        seg0 = tally.total_segments
        f0 = tally.tally_times.total_time_to_tally
        t0 = time.perf_counter()
        if not sim.host_event(st):
            break
        secs.append(time.perf_counter() - t0)
        facade.append(tally.tally_times.total_time_to_tally - f0)
        segs.append(tally.total_segments - seg0)
        moves.append({"steps": tally.step_clock.rows()})
    tally.step_clock = None
    return dict(secs=secs, segments=segs, facade_secs=facade, moves=moves,
                segments_per_s=sum(segs) / sum(secs))


def phase_transport() -> dict:
    """(c) SyntheticTransport on the 3x3 assembly at 55^3 cells (998,250
    tets, 10 regions; the pins at Material(4.0, 0.5)), 1,048,576
    particles: a megastep batch to its end (K = 8, at most 1,000 events)
    and 4 host-mode events, in turns."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.models import problems
    from pumiumtally_tpu_torch.models.transport import (
        Material,
        SyntheticTransport,
    )

    t0 = time.perf_counter()
    mesh = problems.assembly(cells=TRANSPORT_CELLS,
                             lattice=TRANSPORT_LATTICE, device=DEVICE)
    regions = int(torch.unique(mesh.class_id).numel())
    log(f"[mega] transport mesh: assembly({TRANSPORT_CELLS}, "
        f"{TRANSPORT_LATTICE}) {mesh.ntet} tets, {regions} regions, built "
        f"in {time.perf_counter() - t0:.3f} s")
    mats = {c: Material(4.0, 0.5)
            for c in range(1, TRANSPORT_LATTICE ** 2 + 1)}
    n = MAIN_PARTICLES

    def transport(mode, seed):
        tally = PumiTally(mesh, n, TallyConfig(n_groups=2, megastep=MEGA_K),
                          device=DEVICE)
        return tally, SyntheticTransport(tally, materials=mats, seed=seed,
                                         max_events=TRANSPORT_EVENTS,
                                         mode=mode)

    mt, md = transport("megastep", 5)
    ht, hd = transport("host", 5)
    out = dict(megastep=[], host=[], regions=regions)
    for turn in ("megastep", "host", "host", "megastep"):
        if turn == "megastep":
            r = transport_run(md, mt)
            log(f"[mega] transport megastep batch: {r['moves']} moves, "
                f"{r['segments']} segments, source moves "
                f"{r['secs']:.4f} s on the host clock (batch "
                f"{r['wall']:.4f} s with its initial search): moves/s="
                f"{r['moves_per_s']:.4f}, segments/s="
                f"{r['segments_per_s']:.4e}; {md.stats}")
            if r["moves"] >= TRANSPORT_EVENTS or not md.stats.collisions:
                raise AssertionError(f"transport batch did not end: {r}")
        else:
            r = host_events(hd, ht, 4)
            log(f"[mega] transport host events: "
                f"{', '.join(f'{x * 1e3:.4f}' for x in r['secs'])} ms, of "
                f"them in move_to_next_location "
                f"{', '.join(f'{x * 1e3:.4f}' for x in r['facade_secs'])} "
                f"ms, segments {r['segments']}, segments/s="
                f"{r['segments_per_s']:.4e}")
        out[turn].append(r)
    print_step_table("transport host event", [
        m for r in out["host"] for m in r["moves"]], tag="[mega]")
    flux = mt.raw_flux[..., 0]
    cid = mesh.class_id.cpu().numpy()
    flown = [int(c) for c in np.unique(cid) if flux[cid == c].sum() > 0]
    if len(flown) != regions or not np.isfinite(flux).all():
        raise AssertionError(f"transport flux: regions flown {flown}")
    log(f"[mega] transport: every region flown ({flown}), flux finite")
    return out


def phase_megastep(mesh) -> dict:
    """Phase 14: the device-sourced move loop."""
    for dtype in (torch.float64, torch.float32):
        megastep_small(dtype)
    full = megastep_full(mesh)
    transport = phase_transport()
    return dict(full=full, transport=transport)


# --------------------------------------------------------------------- #
# Phase 15: integrity, checkpoints, the runner and the watchdog
# --------------------------------------------------------------------- #
RESIL_MOVES = 4
RESIL_AUDIT = dict(integrity="warn", audit_lanes=64, audit_every=1)
RESIL_REL = 1e-5  # the integrity sums against the host oracle, float32
RESIL_DEADLINE_S = 30.0
# The order of the runs a feature's cost is read from (on against off).
RESIL_TURNS = ("off", "on", "on", "off")


def resil_tally(mesh, **kw):
    from pumiumtally_tpu_torch import PumiTally, TallyConfig

    return PumiTally(mesh, MAIN_PARTICLES,
                     TallyConfig(n_groups=MAIN_GROUPS, **kw), device=DEVICE)


def resil_record(mesh) -> dict:
    """The main path's inputs (numpy seed 1: positions, then 4 moves of
    isotropic flights from the previous write-backs) walked once with the
    defaults: the inputs kept for every later run, the write-backs and
    the end state to hold them to."""
    n, G = MAIN_PARTICLES, MAIN_GROUPS
    rng = np.random.default_rng(1)
    t = resil_tally(mesh)
    pos = rng.uniform(0.05, 0.95, (n, 3))
    t.initialize_particle_location(pos.reshape(-1))
    prev, moves, outs = pos, [], []
    for _ in range(RESIL_MOVES):
        want, groups = main_move_inputs(rng, n, G, prev)
        moves.append((want.reshape(-1).copy(), groups))
        dest, mats = want.reshape(-1).copy(), np.zeros(n, np.int32)
        t.move_to_next_location(dest, np.ones(n, np.int8), np.ones(n),
                                groups, mats)
        outs.append((dest, mats))
        prev = dest.reshape(n, 3).copy()
    return dict(pos=pos, moves=moves, outs=outs, flux=t.flux.clone(),
                origin=t.state.origin.clone(), elem=t.state.elem.clone())


def resil_move(t, rec, i: int, run=None) -> tuple:
    """Move ``i`` (0-based) of the recorded inputs through ``run`` (a
    runner) or the tally; returns the write-backs and the host seconds."""
    n = MAIN_PARTICLES
    dest0, groups = rec["moves"][i]
    dest, mats = dest0.copy(), np.zeros(n, np.int32)
    t0 = time.perf_counter()
    (run or t).move_to_next_location(dest, np.ones(n, np.int8), np.ones(n),
                                     groups, mats)
    return dest, mats, time.perf_counter() - t0


def resil_same(t, rec, outs, label: str) -> None:
    """The tally's flux, positions and elements, and the write-backs of
    ``outs`` (the last moves), bitwise the recorded run's."""
    if not torch.equal(t.flux, rec["flux"]):
        raise AssertionError(f"[resil] {label}: flux differs")
    if not (torch.equal(t.state.origin, rec["origin"])
            and torch.equal(t.state.elem, rec["elem"])):
        raise AssertionError(f"[resil] {label}: positions or elements "
                             "differ")
    for (d, m), (rd, rm) in zip(outs, rec["outs"][-len(outs):]):
        if not (np.array_equal(d, rd) and np.array_equal(m, rm)):
            raise AssertionError(f"[resil] {label}: write-backs differ")


def resil_run(mesh, rec, runner_kw=None, **cfg) -> dict:
    """The recorded inputs through a tally of ``cfg`` (under a
    ResilientRunner with ``runner_kw`` when given); the moves' host
    seconds, transfers and write-backs, and the tally."""
    from pumiumtally_tpu_torch.resilience.runner import ResilientRunner
    from pumiumtally_tpu_torch.utils.timing import StepClock

    t = resil_tally(mesh, **cfg)
    # Located before the runner wraps it: the runner then writes no
    # generation 0 (a checkpoint write is seconds of one host thread).
    t.initialize_particle_location(rec["pos"].reshape(-1))
    run = (ResilientRunner(t, handle_signals=False, sleep=lambda s: None,
                           **runner_kw) if runner_kw is not None else None)
    t.step_clock = StepClock(DEVICE)
    secs, outs, io, steps = [], [], [], []
    for i in range(RESIL_MOVES):
        io0 = dict(t.io)
        d, m, sec = resil_move(t, rec, i, run)
        secs.append(sec)
        outs.append((d, m))
        io.append({k: t.io[k] - io0[k] for k in io0})
        steps.append({"steps": t.step_clock.rows()})
    t.step_clock = None
    return dict(tally=t, run=run, secs=secs, outs=outs, io=io, steps=steps)


def integrity_err(got, want, pseg, label: str) -> float:
    """The fused vector against the plain one on lanes with track
    lengths ``pseg``: the counts (bad flux entries, lanes in flight,
    lanes done) equal, the sums within 1e-5 of path_wlen in float32
    (1e-12 in float64: the sums' order differs), the residual within that
    part of itself plus 4 ulps of max |pseg| (a max does not depend on
    the fold's order, only on the norm's rounding); returns the largest
    absolute difference."""
    from pumiumtally_tpu_torch.integrity.invariants import integrity_to_dict

    g = integrity_to_dict(got.cpu().numpy())
    w = integrity_to_dict(want.cpu().numpy())
    rtol = 1e-5 if got.dtype == torch.float32 else 1e-12
    ulps = 4 * torch.finfo(got.dtype).eps * float(pseg.abs().max())
    bad = [f for f in ("bad_flux", "lanes_flying", "lanes_done")
           if g[f] != w[f]]
    bad += [f for f in ("scored_wlen", "path_wlen")
            if not abs(g[f] - w[f]) <= rtol * max(1.0, abs(w["path_wlen"]))]
    if not abs(g["max_residual"] - w["max_residual"]) <= \
            rtol * abs(w["max_residual"]) + ulps:
        bad.append("max_residual")
    err = float((got.double() - want.double()).abs().max())
    log(f"[resil] {label}: fused vector {g} against plain {w}: max "
        f"|difference| {err:.3e}, fields outside the tolerance {bad}")
    if bad:
        raise AssertionError(f"[resil] {label}: the fused integrity vector "
                             f"disagrees with the plain one at {bad}")
    return err


def resil_integrity(mesh, rec) -> dict:
    """(a) integrity="warn" with 64 audited lanes a move: no violation, no
    mismatch, the recorded run's bits, one copy each way a move (the
    audit's gather of its lanes is out of band), the conservation sums
    against the host oracle from the write-backs; the integrity vector's
    device ms against its bytes bound; the move's host ms with the checks
    on and off in turns."""
    from pumiumtally_tpu_torch.integrity import invariants
    from pumiumtally_tpu_torch.ops import integrity_cuda, walk, walk_cuda

    n = MAIN_PARTICLES
    # The main path's run: every count 0 just before it, read just after
    # (the phase's total goes on from here).
    zero_counts()
    a = resil_run(mesh, rec, **RESIL_AUDIT)
    torch.cuda.synchronize()
    path = read_counts()
    if not path["integrity"]:
        raise AssertionError(f"[resil] (a) no fused integrity launch on the "
                             f"path: {path}")
    t = a["tally"]
    tm = t.telemetry()
    resil_same(t, rec, a["outs"], "integrity warn + audit")
    if tm["integrity"]["violations"] or tm["integrity"]["audit_mismatches"]:
        raise AssertionError(f"[resil] (a) violations {tm['integrity']}")
    audited = tm["integrity"]["audited_lanes"]
    if audited < RESIL_MOVES * RESIL_AUDIT["audit_lanes"] // 2:
        raise AssertionError(f"[resil] (a) only {audited} lanes audited")
    for i, io in enumerate(a["io"], 1):
        if (io["h2d_transfers"], io["d2h_transfers"]) != (1, 1):
            raise AssertionError(f"[resil] (a) move {i} transfers {io}")
    tol = invariants.conservation_tolerance(
        None, torch.float32, invariants.mesh_scale(mesh.coords.cpu()),
        t.config.tolerance)
    recs = [r for r in tm["per_move"] if r["kind"] == "integrity"
            and r["move"] >= 1]
    prev = rec["pos"].astype(np.float32).astype(np.float64)
    worst = 0.0
    for r, (d, _) in zip(recs, a["outs"]):
        final = d.reshape(n, 3)
        oracle = float(np.linalg.norm(final - prev, axis=1).sum())
        for f in ("scored_wlen", "path_wlen"):
            rel = abs(r[f] - oracle) / oracle
            worst = max(worst, rel)
            if not rel <= RESIL_REL:
                raise AssertionError(f"[resil] (a) move {r['move']} {f} "
                                     f"{r[f]} against oracle {oracle}")
        if not r["max_residual"] <= tol or r["lanes_done"] != n:
            raise AssertionError(f"[resil] (a) move {r['move']}: {r}")
        prev = final
    log(f"[resil] (a) integrity=warn, audit 64 lanes a move: moves "
        f"1-{RESIL_MOVES} bitwise the run without, 0 violations, "
        f"{audited} lanes audited, 0 mismatches; transfers a move "
        f"{a['io'][1]}; sums against the host oracle rel <= {worst:.3e} "
        f"(limit {RESIL_REL:g}); max_residual <= "
        f"{max(r['max_residual'] for r in recs):.3e} (conservation_"
        f"tolerance {tol:.3e}); last vector {recs[-1]}")
    print_step_table("(a) integrity + audit, moves 1-4", a["steps"],
                     tag="[resil]")
    verify = [r["host_ms"] for m in a["steps"] for r in m["steps"]
              if r["step"] == "verify"]
    # The vector alone at full width: a move-1 walk's outputs.
    s0 = resil_tally(mesh)
    s0.initialize_particle_location(rec["pos"].reshape(-1))
    st = s0.state
    dest = torch.from_numpy(rec["moves"][0][0].reshape(n, 3)).to(
        DEVICE, torch.float32)
    fly = torch.ones(n, dtype=torch.bool, device=DEVICE)
    w = torch.ones(n, device=DEVICE)
    g = torch.from_numpy(rec["moves"][0][1]).to(DEVICE)
    r = walk_cuda.trace(mesh, st.origin, dest, st.elem, fly, w, g,
                        st.material_id, s0.flux, initial=False,
                        max_crossings=s0._max_crossings,
                        n_groups=MAIN_GROUPS, integrity=True)
    args = (fly, r.done, w, r.track_length, r.position, st.origin, r.flux,
            False)
    vec = integrity_cuda.integrity_vector(*args)
    again = integrity_cuda.integrity_vector(*args)
    plain = walk.integrity_vector(*args)
    if not (torch.equal(vec, r.integrity) and torch.equal(vec, again)):
        raise AssertionError("[resil] the fused vector differs from the "
                             "walk's or between two launches")
    err = integrity_err(vec, plain, r.track_length, "(a) full width")
    # A residual of 0.25 planted on a lane in flight and done, one of 1.0
    # on a lane taken out of flight: the fused max finds the first and
    # skips the second.
    fly2, pseg2 = fly.clone(), r.track_length.clone()
    fly2[0] = False
    pseg2[0] += 1.0
    pseg2[1] += 0.25
    planted = (fly2, r.done, w, pseg2) + args[4:]
    pv, pp = (f(*planted) for f in (integrity_cuda.integrity_vector,
                                    walk.integrity_vector))
    integrity_err(pv, pp, pseg2, "(a) planted residual 0.25")
    if not (0.2 < float(pp[2]) < 0.3 and bool(r.done[1])):
        raise AssertionError(f"[resil] (a) the planted residual reads "
                             f"{float(pp[2])}")
    vturns: dict = {"plain": [], "fused": []}
    for which in ("plain", "fused", "fused", "plain"):
        fn = (walk.integrity_vector if which == "plain"
              else integrity_cuda.integrity_vector)
        vturns[which].append(event_ms(lambda: fn(*args)))
    vec_ms = float(np.median(vturns["fused"]))
    plain_ms = float(np.median(vturns["plain"]))
    profile_call("(a) the fused integrity vector at full width",
                 lambda: integrity_cuda.integrity_vector(*args))
    nbytes = (r.flux.numel() * r.flux.element_size()
              + sum(x.numel() * x.element_size() for x in args[:6]))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[resil] (a) integrity vector at full width (CUDA events, median "
        f"of 5, in turns plain, fused, fused, plain): fused "
        f"(csrc/integrity.cu) {vturns['fused']} ms, plain (torch ops) "
        f"{vturns['plain']} ms (earlier: 0.3689-0.7853 ms), against its bound "
        f"{bound_ms:.4f} ms (bytes: {nbytes} read once); bitwise across two "
        f"launches; the verify step (checks + audit of 64 lanes) host median "
        f"{np.median(verify):.4f} ms")
    del s0, r, args
    # The move's host ms, checks off and on in turns (no audit).
    turns, steps = {}, {}
    for label in RESIL_TURNS:
        cfg = dict(integrity="warn") if label == "on" else {}
        run = resil_run(mesh, rec, **cfg)
        if label == "on":
            resil_same(run["tally"], rec, run["outs"], "integrity warn")
            if any(io["d2h_transfers"] != 1 for io in run["io"]):
                raise AssertionError(f"[resil] (a) transfers {run['io']}")
        turns.setdefault(label, []).extend(run["secs"][1:])
        steps.setdefault(label, []).extend(run["steps"][1:])
    for label in ("off", "on"):
        print_step_table(f"(a) checks {label}, moves 2-4", steps[label],
                         tag="[resil]")
    on_ms = float(np.median(turns["on"])) * 1e3
    off_ms = float(np.median(turns["off"])) * 1e3
    log(f"[resil] (a) move host ms, moves 2-4 in turns {RESIL_TURNS}:"
        f" off median {off_ms:.4f} ({[round(x * 1e3, 4) for x in turns['off']]}"
        f"), on median {on_ms:.4f} ({[round(x * 1e3, 4) for x in turns['on']]}"
        f"); one D2H a move with the checks on")
    return dict(vec_ms=vec_ms, plain_ms=plain_ms, vec_turns=vturns,
                bound_ms=bound_ms, vec_bytes=nbytes, max_abs_err=err,
                launches=path["integrity"],
                verify_ms=float(np.median(verify)), on_ms=on_ms,
                off_ms=off_ms)


def resil_runner(mesh, rec, tmpdir: str) -> dict:
    """(c) a die_at_move fault then auto-resume from the store, a
    transient retried once, and a bitflip under integrity="halt" caught
    as "flux" with the last good generation flushed."""
    from pumiumtally_tpu_torch.integrity import FatalIntegrityViolation
    from pumiumtally_tpu_torch.resilience.faultinject import (
        FaultInjector,
        InjectedKill,
        parse_faults,
    )
    from pumiumtally_tpu_torch.resilience.runner import ResilientRunner

    store = os.path.join(tmpdir, "die")
    t0 = time.perf_counter()
    t = resil_tally(mesh)
    t.initialize_particle_location(rec["pos"].reshape(-1))
    run = ResilientRunner(t, store, every_moves=2, handle_signals=False,
                          faults=FaultInjector(parse_faults("die_at_move:3")))
    try:
        for i in range(RESIL_MOVES):
            resil_move(t, rec, i, run)
        raise AssertionError("[resil] (c) die_at_move:3 did not fire")
    except InjectedKill:
        pass
    if t.iter_count != 2:
        raise AssertionError(f"[resil] (c) died at iteration {t.iter_count}")
    del run, t
    b = resil_tally(mesh)
    # No cadence after the resume: a second generation at move 4 is
    # seconds of host time and checks nothing the first did not.
    run = ResilientRunner(b, store, every_moves=None, handle_signals=False)
    if run.resumed_from != 2:
        raise AssertionError(f"[resil] (c) resumed from {run.resumed_from}")
    run.initialize_particle_location(rec["pos"].reshape(-1))
    outs = [resil_move(b, rec, i, run)[:2] for i in (2, 3)]
    run.close(final_checkpoint=False)
    resil_same(b, rec, outs, "die at move 3, resumed")
    die_s = time.perf_counter() - t0
    log(f"[resil] (c) die_at_move:3, resumed from generation 2 of the "
        f"store: bitwise the uninterrupted run ({die_s:.3f} s with 1 "
        f"generation written and restored, and no cadence after the "
        f"resume)")

    t0 = time.perf_counter()
    tr = resil_run(mesh, rec, dict(
        store=os.path.join(tmpdir, "transient"), every_moves=100,
        faults=FaultInjector(parse_faults("transient_at_move:3"))))
    resil_same(tr["tally"], rec, tr["outs"], "transient retried")
    retries = tr["tally"].metrics.counter("pumi_move_retries_total").value()
    if retries != 1:
        raise AssertionError(f"[resil] (c) {retries} retries")
    log(f"[resil] (c) transient_at_move:3 retried once from the snapshot "
        f"on the card: bitwise the uninterrupted run; move 3 host "
        f"{tr['secs'][2] * 1e3:.4f} ms with its rollback, moves "
        f"{[round(x * 1e3, 4) for x in tr['secs']]} ms "
        f"({time.perf_counter() - t0:.3f} s)")

    os.environ["PUMI_TPU_FAULTS"] = "bitflip_flux:2"
    try:
        h = resil_tally(mesh, integrity="halt")
    finally:
        del os.environ["PUMI_TPU_FAULTS"]
    h.initialize_particle_location(rec["pos"].reshape(-1))
    run = ResilientRunner(h, os.path.join(tmpdir, "halt"), every_moves=100,
                          handle_signals=False, sleep=lambda s: None)
    try:
        for i in range(RESIL_MOVES):
            resil_move(h, rec, i, run)
        raise AssertionError("[resil] (c) the bitflip was not detected")
    except FatalIntegrityViolation as e:
        checks, move = e.checks, e.move
    latest = run.store.find_latest()
    if checks != ("flux",) or move != 3 or latest[0] != 2:
        raise AssertionError(f"[resil] (c) halt: checks {checks} at move "
                             f"{move}, last generation {latest}")
    flips = h.metrics.counter("pumi_injected_faults_total").value(
        kind="bitflip_flux")
    log(f"[resil] (c) bitflip_flux:2 under integrity=halt: caught at move "
        f"{move} as {list(checks)}, generation {latest[0]} (the last good "
        f"state) flushed, {flips} flip injected")
    return dict(die_s=die_s)


def resil_watchdog(mesh, rec) -> dict:
    """(d) move_deadline_s on healthy moves: no timeout, the recorded
    run's bits; the move's host ms with the deadline off and on in turns
    (the worker thread's cost)."""
    turns: dict = {}
    for label in RESIL_TURNS:
        cfg = {"move_deadline_s": RESIL_DEADLINE_S} if label == "on" else {}
        run = resil_run(mesh, rec, **cfg)
        resil_same(run["tally"], rec, run["outs"], f"deadline {label}")
        if run["tally"].telemetry()["integrity"]["violations"]:
            raise AssertionError("[resil] (d) the watchdog fired")
        turns.setdefault(label, []).extend(run["secs"][1:])
    out = {}
    for label, secs in turns.items():
        ms = np.array(secs) * 1e3
        out[label] = dict(median=float(np.median(ms)),
                          quartiles=[float(q) for q in
                                     np.percentile(ms, [25, 75])])
    log(f"[resil] (d) move_deadline_s={RESIL_DEADLINE_S:g} on healthy "
        f"moves: no timeout, bitwise; moves 2-4 host ms in turns "
        f"{RESIL_TURNS}: " + "; ".join(
            f"{k} median {v['median']:.4f} (quartiles "
            f"{v['quartiles'][0]:.4f}, {v['quartiles'][1]:.4f}, "
            f"{len(turns[k])} moves)" for k, v in out.items()))
    return dict(on_ms=out["on"]["median"], off_ms=out["off"]["median"])


def resil_megastep(mesh) -> dict:
    """(e) the phase-14 megastep cell (K = 8) with integrity on: no
    violation, bitwise the run without. (A megastep checkpoint restored
    into a fresh tally and run on is phase 21 (a)'s preemption.)"""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.ops import source

    n = MAIN_PARTICLES
    src = source.SourceParams(default_sigma_t=MEGA_SIGMA_T, seed=1)
    lanes = dict(weights=np.ones(n), groups=np.zeros(n, np.int32),
                 alive=np.ones(n, bool))
    pos = np.random.default_rng(1).uniform(0.05, 0.95, (n, 3))

    def tally(**kw):
        t = PumiTally(mesh, n, TallyConfig(
            n_groups=MAIN_GROUPS, tolerance=1e-6, megastep=MEGA_K, **kw),
            device=DEVICE)
        t.initialize_particle_location(pos.reshape(-1))
        return t

    from pumiumtally_tpu_torch.ops import integrity_cuda

    runs, secs = {}, {"off": [], "on": []}
    for label in ("warm-up",) + RESIL_TURNS[:4]:
        t = tally(**({} if label == "off" else dict(integrity="warn")))
        launches = integrity_cuda.LAUNCHES
        t0 = time.perf_counter()
        t.run_source_moves(MEGA_K, src, **lanes)
        torch.cuda.synchronize()
        if label != "warm-up":
            secs[label].append(time.perf_counter() - t0)
            runs.setdefault(label, []).append(dict(
                state=_mega_state(t), flux=t.flux.clone(),
                tm=t.telemetry()["integrity"],
                launches=integrity_cuda.LAUNCHES - launches,
                recs=[r for r in t.telemetry()["per_move"]
                      if r["kind"] == "integrity"]))
        del t
    (off, _), (on, on2) = runs["off"], runs["on"]
    on["secs"], off["secs"] = (float(np.median(secs[k])) for k in ("on", "off"))
    if on["tm"]["violations"] or len(on["recs"]) != 2:
        raise AssertionError(f"[resil] (e) {on['tm']} {on['recs']}")
    if not torch.equal(on["flux"], off["flux"]) or any(
            not torch.equal(v, off["state"][f])
            for f, v in on["state"].items()):
        raise AssertionError("[resil] (e) integrity changed the megastep")
    if on["recs"] != on2["recs"] or on["launches"] != MEGA_K or \
            on2["launches"] != MEGA_K or runs["off"][0]["launches"]:
        raise AssertionError(
            f"[resil] (e) the chunk vectors differ between two runs or the "
            f"fused kernel ran {on['launches']}, {on2['launches']} times "
            f"for {MEGA_K} moves")
    log(f"[resil] (e) megastep cell K={MEGA_K} with integrity=warn: 0 "
        f"violations, bitwise the run without (a call of {MEGA_K} moves "
        f"after a warm-up, in turns off/on/on/off: on {secs['on']} s, off "
        f"{secs['off']} s); the fused vector launched once a fused move "
        f"({on['launches']}), the two runs' chunk vectors bitwise equal: "
        f"{on['recs'][-1]}")
    return dict(on_s=on["secs"], off_s=off["secs"],
                launches=on["launches"])


def phase_resilience(mesh) -> dict:
    """Phase 15: integrity, checkpoints, the runner and the watchdog at
    the main cell's full width; launch counts zeroed before (a)'s run
    and read after (e)."""
    torch.cuda.synchronize()
    rec = resil_record(mesh)
    out = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        out["a"] = resil_integrity(mesh, rec)
        out["c"] = resil_runner(mesh, rec, tmpdir)
        out["d"] = resil_watchdog(mesh, rec)
        out["e"] = resil_megastep(mesh)
    torch.cuda.synchronize()
    out["launches"] = read_counts()
    log(f"[resil] launches over phase 15: {out['launches']}")
    for key in ("walk", "scatter_bucket", "schedule", "source", "integrity"):
        if not out["launches"][key]:
            raise AssertionError(f"[resil] no {key} launch in phase 15")
    return out


# ---------------------------------------------------------------------- #
# 16. The partitioned tally on one card (A9's first half), with the
# unpacked table layout (B1) and the partitioned walk phase (B8).
# ---------------------------------------------------------------------- #
PART_PARTS, PART_HALO = 4, 1
UNPACKED_CLASSES = 65
# Bytes of an element's row that a walk must read. B1, the single-device
# walk without geo20 (the JAX four-gather fallback): 12 normal components
# and 4 offsets in the walk's type, the four neighbor codes and the class
# as int32 (a neighbor's class is its own row's). B8, the partitioned walk
# phase: the same and the four neighbor classes, since a neighbor across
# a cut has no row in the part.
UNPACKED_ROW = {4: 16 * 4 + 5 * 4, 8: 16 * 8 + 5 * 4}
PART_ROW = {4: 16 * 4 + 9 * 4, 8: 16 * 8 + 9 * 4}
# A partitioned walk lane's inputs and outputs: origin, dest, row,
# weight, group, material, track, prev, stuck, slot in; position, row,
# material, done, track, prev, stuck, target, target row, crossings,
# chases, segments, iterations out.
PART_LANE_IN = {4: 12 + 12 + 4 + 4 + 4 + 4 + 4 + 4 + 4 + 8,
                8: 24 + 24 + 4 + 8 + 4 + 4 + 8 + 4 + 4 + 8}
PART_LANE_OUT = {4: 12 + 4 + 4 + 1 + 4 + 4 * 8, 8: 24 + 4 + 4 + 1 + 8 + 4 * 8}
# The partitioned segment's |x1 - x0|: 3 subtractions, 5 for the norm.
PART_FLOPS_PER_ITER = FLOPS_PER_ITER + 8


def walk_bound(rows: int, row_bytes: int, bins: int, item: int,
               lane_bytes: int, iters: int, flops: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one walk: each distinct row
    read once, each scored bin's pair read and written once, each lane's
    inputs read and outputs written once, against the lane iterations'
    operations at the card's rate for the type."""
    nbytes = rows * row_bytes + bins * 2 * 2 * item + lane_bytes
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = iters * flops / (FP32_FLOPS if item == 4 else FP64_FLOPS) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), nbytes


def ptxas_records(lib: str) -> dict:
    """{instantiation: ptxas record} of ``lib``'s build log, read by the
    resource contracts' parser (analysis/costmodel.py::parse_ptxas)."""
    from pumiumtally_tpu_torch.analysis.costmodel import parse_ptxas

    with open(lib[:-3] + ".log") as f:
        return parse_ptxas(f.read())


def walk_registers(lib: str, layouts=(1, 2)) -> list:
    """ptxas's registers and spills of the walk kernel's instantiations of
    the given table layouts, from the build log."""
    from pumiumtally_tpu_torch.analysis.costmodel import ptxas_lines

    pat = re.compile(r"walk_kernel<([fd])Lb(\d)ELb(\d)ELb(\d)ELb(\d)ELi(\d)E")
    out = []
    for inst, rec in ptxas_records(lib).items():
        m = pat.match(inst)
        if m and int(m.group(6)) in layouts:
            out += [(m.groups(), line) for line in ptxas_lines(rec)]
    return out


def unpacked_main_mesh(classes: int | None):
    """The main cell's box without geo20: ``classes`` z-slabs of class ids
    (None: one class, the main mesh's unpacked twin)."""
    from pumiumtally_tpu_torch import build_box
    from pumiumtally_tpu_torch.mesh.box import build_box_arrays

    cells = MAIN_CELLS
    cid = None
    if classes is not None:
        coords, tets = build_box_arrays(1.0, 1.0, 1.0, cells, cells, cells)
        z = coords[tets].mean(axis=1)[:, 2]
        cid = np.minimum((z * classes).astype(np.int32), classes - 1)
    mesh = build_box(1.0, 1.0, 1.0, cells, cells, cells, class_id=cid,
                     device=DEVICE, packed=False)
    if mesh.geo20 is not None:
        raise AssertionError("the unpacked main mesh has a geo20 table")
    return mesh


def part_unpacked(main_tally, main_snaps) -> dict:
    """(a) B1: the four calls on the 65-class main box (init, one move),
    counted; the kernel against the plain walk on their inputs (flux
    bitwise) and on a float64 65-class 20^3 box; move 1's walk on the main
    mesh's unpacked twin against the packed main mesh in turns."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.ops import walk, walk_cuda

    n, G = MAIN_PARTICLES, MAIN_GROUPS
    t0 = time.perf_counter()
    mesh65 = unpacked_main_mesh(UNPACKED_CLASSES)
    log(f"[part] (a) 65-class main box, packed=False: built in "
        f"{time.perf_counter() - t0:.3f} s, geo20 None, "
        f"{int(mesh65.class_values.numel())} classes")
    rng = np.random.default_rng(1)
    zero_counts()
    t = PumiTally(mesh65, n, TallyConfig(n_groups=G), device=DEVICE)
    pos = rng.uniform(0.05, 0.95, (n, 3))
    snaps = {"initial": _snapshot(t, pos, t.state.group.cpu().numpy())}
    t.initialize_particle_location(pos.reshape(-1))
    want, groups = main_move_inputs(rng, n, G, pos)
    snaps["move"] = _snapshot(t, want, groups)
    dest, mats = want.reshape(-1).copy(), np.zeros(n, np.int32)
    t.move_to_next_location(dest, np.ones(n, np.int8), np.ones(n), groups,
                            mats)
    torch.cuda.synchronize()
    launches = read_counts()
    stops = int((mats >= 0).sum())
    log(f"[part] (a) facade on the 65-class box: launches {launches}, "
        f"unpacked walk launches {walk_cuda.UNPACKED_LAUNCHES}, material "
        f"stops in move 1: {stops}")
    if walk_cuda.UNPACKED_LAUNCHES < 2 or launches["walk"] != \
            walk_cuda.UNPACKED_LAUNCHES:
        raise AssertionError("the unpacked facade did not run the unpacked "
                             "walk instantiation")
    if not stops:
        raise AssertionError("no material stop at the 65 class boundaries")
    errs = []
    for initial in (True, False):
        label = "initial search" if initial else "move 1"
        args, kw = replay_args(t, snaps["initial" if initial else "move"],
                               initial)
        flux0 = snaps["initial" if initial else "move"]["flux"]
        k = walk_cuda.trace(*args, flux0.clone(), **kw)
        p = walk.trace(*args, flux0.clone(), **kw)
        errs.append(compare(k, p, torch.float32, 0.0, 0.0,
                            f"[part] (a) unpacked 65-class {label} "
                            "(float32)")["max_abs_err"])
    # Float64 on a small 65-class box.
    from pumiumtally_tpu_torch.mesh.box import build_box_arrays
    from pumiumtally_tpu_torch.mesh.core import TetMesh

    coords, tets = build_box_arrays(1.0, 1.0, 1.0, SMALL_CELLS, SMALL_CELLS,
                                    SMALL_CELLS)
    cid = (np.arange(len(tets)) % UNPACKED_CLASSES).astype(np.int32)
    small = TetMesh.from_numpy(coords, tets, cid, dtype=torch.float64,
                               device=DEVICE)
    srng = np.random.default_rng(2)
    m = SMALL_LANES
    sdev = small.device
    elem = torch.from_numpy(srng.integers(0, small.ntet, m).astype(
        np.int32)).to(sdev)
    origin = small.centroids()[elem.long()].contiguous()
    sdest = torch.from_numpy(srng.uniform(-0.1, 1.1, (m, 3))).to(sdev)
    sargs = (small, origin, sdest, elem,
             torch.ones(m, dtype=torch.bool, device=sdev),
             torch.from_numpy(srng.uniform(0.5, 2, m)).to(sdev),
             torch.from_numpy(srng.integers(0, G, m).astype(np.int32)).to(
                 sdev),
             torch.full((m,), -1, dtype=torch.int32, device=sdev))
    for initial in (True, False):
        skw = dict(initial=initial, max_crossings=small.ntet + 64,
                   n_groups=G)
        f0 = torch.zeros(small.ntet * G * 2, dtype=torch.float64,
                         device=sdev)
        k = walk_cuda.trace(*sargs, f0.clone(), **skw)
        p = walk.trace(*sargs, f0.clone(), **skw)
        errs.append(compare(k, p, torch.float64, 0.0, 0.0,
                            f"[part] (a) unpacked 65-class 20^3 "
                            f"{'initial' if initial else 'move'} "
                            "(float64)")["max_abs_err"])
    # Move 1 of the main path on its unpacked twin against the packed
    # main mesh, in turns.
    twin = unpacked_main_mesh(None)
    args, kw = replay_args(main_tally, main_snaps["move"], False)
    targs = (twin,) + args[1:]
    flux0 = main_snaps["move"]["flux"]
    kp = walk_cuda.trace(*args, flux0.clone(), **kw)
    ku = walk_cuda.trace(*targs, flux0.clone(), **kw)
    same = all(torch.equal(getattr(kp, f), getattr(ku, f)) for f in (
        "flux", "position", "elem", "material_id", "done"))
    log(f"[part] (a) move 1, unpacked twin against packed main mesh: "
        f"bitwise equal={same}")
    if not same:
        raise AssertionError("the unpacked twin walks move 1 differently")
    cap = {"capacity": int(kp.n_segments)}

    def fresh():
        return (flux0.clone(),)

    turns = {"packed": [], "unpacked": []}
    for which in ("packed", "unpacked", "unpacked", "packed"):
        a = args if which == "packed" else targs
        turns[which].append(event_ms(
            lambda f, a=a: walk_cuda.trace(*a, f, **kw, **cap), 5, fresh))
    # One call of the plain walk (~1.8 s at this size) is its yardstick.
    plain_ms = event_ms(lambda f: walk.trace(*targs, f, **kw), 1, fresh)
    item = 4
    table_rows, bins = touched(twin, targs, dict(kw, **cap), ku.elem, True)
    iters = int(ku.lane_iters.sum(dtype=torch.int64))
    bound, by, nbytes = walk_bound(
        table_rows, UNPACKED_ROW[item], bins, item,
        n * (LANE_IN[item] + LANE_OUT[item]), iters, FLOPS_PER_ITER)
    ms = float(np.median(turns["unpacked"]))
    log(f"[part] (a) move 1 walk call (CUDA events, median of 5), in turns "
        f"packed, unpacked, unpacked, packed: packed {turns['packed']} ms, "
        f"unpacked {turns['unpacked']} ms; plain (unpacked, one call) "
        f"{plain_ms:.4f} ms; distinct rows {table_rows} x {UNPACKED_ROW[item]} B (geo20 "
        f"row 80 B), bins {bins}, bytes {nbytes}, bound {bound:.4f} ms "
        f"({by})")
    for kernel, line in walk_registers(
            [x for x in LIBS if "libwalk" in x][0]):
        log(f"[part] ptxas walk_kernel<{','.join(kernel)}> "
            f"(T, ROBUST, INITIAL, ORDERED, FEAT, LAYOUT): {line}")
    return dict(launches=launches["walk_unpacked"], ms=ms,
                packed_ms=float(np.median(turns["packed"])),
                turns=turns, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, max_abs_err=max(errs), stops=stops,
                touched=(table_rows, bins, iters))


def part_phase_inputs(part, placed):
    """The first walk phase's lanes of a distributed step: every occupied
    slot, as ``walk_rows`` takes them."""
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp

    slots = torch.nonzero(placed["valid"])[:, 0].contiguous()
    total = placed["valid"].shape[0]
    cap = total // part.n_parts
    rows = ((slots // cap) * part.max_local
            + placed["elem"][slots]).to(torch.int32)
    m = slots.numel()
    dev, dtype = slots.device, placed["origin"].dtype
    i32 = dict(dtype=torch.int32, device=dev)
    args = (wp.stacked_tables(part), placed["origin"][slots],
            placed["dest"][slots], rows, placed["weight"][slots],
            placed["group"][slots], placed["material_id"][slots],
            torch.zeros(m, dtype=dtype, device=dev),
            torch.full((m,), -1, **i32), torch.zeros(m, **i32), slots)
    return args, dict(stride=total, max_local=part.max_local)


PHASE_FIELDS = ("pos", "elem", "mat", "done", "pseg", "ncross", "nchase",
                "nseg", "iters", "target", "target_elem", "prev", "stuck")
STEP_FIELDS = ("position", "dest", "elem", "material_id", "weight", "group",
               "done", "valid", "particle_id", "track_length", "flux",
               "n_rounds", "n_segments", "round_stats", "stats", "n_dropped")
# 16 (b)'s overflow case: its lanes (the first of the batch, each sent
# EXCH_PULL of the way to the corner EXCH_CORNER), the rows a destination
# takes a round.
EXCH_LANES, EXCH_SIZE, EXCH_PULL, EXCH_CORNER = 512, 2, 0.8, 0.95


def part_kernel_vs_plain() -> dict:
    """(b) B8 and B12 on a jittered 20^3 box in 4 parts, halo 0 and 1,
    both dtypes: the first walk phase (every lane's slot state, target and
    the slab flux) and the whole step (slots, every slot field, the slab
    flux, the rounds, the exchange's round stats and drops) through the
    walk and exchange kernels against the plain walk phases and
    ``_exchange_plain`` on the card, bitwise; the step also on the first
    EXCH_LANES lanes sent most of the way to one corner, in a slot layout
    of the most any part starts with and EXCH_SIZE rows a destination a
    round, so that emigrants wait rounds and the corner's part drops
    immigrants."""
    from pumiumtally_tpu_torch.ops import exchange_cuda, walk_cuda
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp
    from pumiumtally_tpu_torch.parallel.mesh_partition import partition_mesh

    n, G = SMALL_LANES, MAIN_GROUPS
    out = {"max_abs_err": 0.0}
    for dtype in (torch.float64, torch.float32):
        mesh = jittered_box(SMALL_CELLS, 0.2, 0, dtype)
        npdt = np.float64 if dtype == torch.float64 else np.float32
        rng = np.random.default_rng(3)
        elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
        origin = mesh.centroids().double().cpu().numpy()[elem]
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        dest = origin + u * rng.exponential(0.15, (n, 1))
        fields = dict(origin=origin.astype(npdt), dest=dest.astype(npdt),
                      weight=rng.uniform(0.5, 2, n).astype(npdt),
                      group=rng.integers(0, G, n).astype(np.int32),
                      material_id=np.full(n, -1, np.int32))
        for halo in (0, 1):
            part = partition_mesh(mesh, PART_PARTS, halo_layers=halo)
            placed = wp.distribute_particles(part, None, elem, fields)
            args, pkw = part_phase_inputs(part, placed)
            L = part.max_local
            label = f"{dtype} halo {halo}"
            for initial in (True, False):
                kw = dict(pkw, initial=initial, n_groups=G,
                          max_crossings=mesh.ntet + 64)
                f0 = torch.zeros(PART_PARTS * L * G * 2, dtype=dtype,
                                 device=mesh.device)
                fk, fp = f0.clone(), f0.clone()
                k, rk = walk_cuda.walk_rows(*args, fk, **kw)
                p, rp = wp.walk_rows_plain(*args, fp, **kw)
                for f, r, plain in ((fk, rk, False), (fp, rp, True)):
                    if r is not None:
                        wp.fold_records(f, [r], True, f.numel() // 2, plain)
                torch.cuda.synchronize()
                bad = [f for f in PHASE_FIELDS if not torch.equal(k[f], p[f])]
                frozen = int((p["target"] >= 0).sum())
                log(f"[part] (b) walk phase {label} "
                    f"{'initial' if initial else 'move'}: {n} lanes, "
                    f"{frozen} froze at cuts, fields differing {bad}, flux "
                    f"bitwise {torch.equal(fk, fp)}")
                if bad or not torch.equal(fk, fp) or not frozen:
                    raise AssertionError(f"partitioned walk phase {label}: "
                                         "kernel and plain disagree")
            e2 = elem[:EXCH_LANES]
            sub = {f: v[:EXCH_LANES] for f, v in fields.items()}
            o = sub["origin"]
            sub["dest"] = (o + EXCH_PULL * (EXCH_CORNER - o)).astype(npdt)
            tight = wp.distribute_particles(
                part, None, e2, sub, cap=int(np.bincount(
                    part.owner[e2], minlength=PART_PARTS).max()))
            for case, pl, kw in (("", placed, {}),
                                 (", overflow and drops", tight,
                                  dict(exchange_size=EXCH_SIZE))):
                runs, launched = [], []
                for plain in (False, True, False):
                    step = wp.make_partitioned_step(
                        [mesh.device] * PART_PARTS, part, n_groups=G,
                        max_crossings=mesh.ntet + 64, plain=plain, **kw)
                    b0 = exchange_cuda.BUCKET_LAUNCHES
                    runs.append(step(
                        pl["origin"], pl["dest"], pl["elem"],
                        torch.zeros_like(pl["valid"]), pl["material_id"],
                        pl["weight"], pl["group"], pl["particle_id"],
                        pl["valid"],
                        torch.zeros(PART_PARTS, L * G * 2, dtype=dtype,
                                    device=mesh.device)))
                    launched.append(exchange_cuda.BUCKET_LAUNCHES - b0)
                torch.cuda.synchronize()
                k, p, again = runs
                bad = [f for f in STEP_FIELDS
                       if not torch.equal(getattr(k, f), getattr(p, f))
                       or not torch.equal(getattr(k, f), getattr(again, f))]
                rs = k.round_stats
                dropped, rounds = int(k.n_dropped.sum()), int(k.n_rounds[0])
                waited = bool((rs[:, 1] < rs[:, 0]).any())
                log(f"[part] (b) step {label}{case}: {pl['valid'].shape[0]} "
                    f"slots, rounds {rounds}, emigrants sent "
                    f"{int(rs[:, 1].sum())}, left waiting in a round "
                    f"{waited}, dropped {dropped}, exchange kernel rounds "
                    f"{launched} (kernel, plain, kernel), fields differing "
                    f"{bad}")
                if bad or not rounds or launched != [rounds, 0, rounds] or (
                        (dropped == 0 or not waited) if case else dropped):
                    raise AssertionError(f"partitioned step {label}{case}: "
                                         "kernel and plain disagree")
    return out


def part_tally(mesh, io: str = "packed"):
    from pumiumtally_tpu_torch import PartitionedTally, TallyConfig

    return PartitionedTally(mesh, MAIN_PARTICLES,
                            TallyConfig(n_groups=MAIN_GROUPS,
                                        io_pipeline=io),
                            n_parts=PART_PARTS, halo_layers=PART_HALO,
                            device=DEVICE)


def part_inputs() -> dict:
    """The main cell's inputs (numpy seed 1, as the main path's): source
    positions, then 4 moves of destinations and groups, each from the
    previous move's reached points (the destinations clipped nowhere)."""
    rng = np.random.default_rng(1)
    n, G = MAIN_PARTICLES, MAIN_GROUPS
    pos = rng.uniform(0.05, 0.95, (n, 3))
    moves, prev = [], pos
    for _ in range(4):
        want, groups = main_move_inputs(rng, n, G, prev)
        moves.append((want, groups))
        prev = np.clip(want, 0.0, 1.0)
    return dict(pos=pos, moves=moves)


def part_run(mesh, inputs, io="packed", single=None, spans=False,
             profiled=False, tmpdir=None, keep=None, clocked=False) -> dict:
    """The partitioned cell: construct, locate, 4 moves (and a .vtu with
    ``tmpdir``). With ``single`` (a PumiTally) each call of it runs
    beside the partitioned one, in turns (single first on odd moves).
    Returns the write-backs, the host ms and segments of each move, the
    rounds, round stats, host waits, walk relaunches and (``spans``) the
    CUDA-event spans of each move's walk phases, exchanges and halo fold;
    ``clocked`` times each host step of the partitioned moves
    (``StepClock``)."""
    from pumiumtally_tpu_torch.ops import walk_cuda
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp
    from pumiumtally_tpu_torch.utils.timing import StepClock

    n = MAIN_PARTICLES
    t0 = time.perf_counter()
    t = part_tally(mesh, io)
    torch.cuda.synchronize()
    construct = time.perf_counter() - t0
    if keep is not None:
        keep(t, "construct")
    t.initialize_particle_location(inputs["pos"].reshape(-1))
    if single is not None:
        single.initialize_particle_location(inputs["pos"].reshape(-1))
    if clocked:
        t.step_clock = StepClock(DEVICE)
    out = dict(construct_s=construct, moves=[], init_rounds=t.total_rounds,
               init_round_stats=t.last_round_stats)
    prof = start_profile() if profiled else None
    host = 0.0
    for i, (want, groups) in enumerate(inputs["moves"], 1):
        if keep is not None:
            keep(t, f"move {i}")
        rec = {}
        order = (("single", "part") if i % 2 else ("part", "single"))
        for which in order:
            if which == "single" and single is None:
                continue
            tl = t if which == "part" else single
            dest, mats = want.reshape(-1).copy(), np.zeros(n, np.int32)
            fly = np.ones(n, np.int8)
            rounds0, waits0 = t.total_rounds, wp.ROUND_WAITS
            relaunch0 = walk_cuda.RELAUNCHES
            seg0 = getattr(tl, "total_segments", 0)
            if spans and which == "part":
                wp.SPANS = []
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            tl.move_to_next_location(dest, fly, np.ones(n), groups, mats)
            torch.cuda.synchronize()
            secs = time.perf_counter() - s0
            if which == "part":
                host += secs
                got = dict(dest=dest.reshape(n, 3), mats=mats,
                           ms=secs * 1e3, rounds=t.total_rounds - rounds0,
                           waits=wp.ROUND_WAITS - waits0,
                           relaunches=walk_cuda.RELAUNCHES - relaunch0,
                           segments=tl.total_segments - seg0,
                           round_stats=t.last_round_stats)
                if clocked:
                    got["steps"] = t.step_clock.rows()
                if spans:
                    got["spans"] = [(nm, r, a.elapsed_time(b))
                                    for nm, r, a, b in wp.SPANS]
                    wp.SPANS = None
                rec["part"] = got
            else:
                rec["single"] = dict(dest=dest.reshape(n, 3), mats=mats,
                                     ms=secs * 1e3,
                                     segments=tl.last_stats["segments"])
        out["moves"].append(rec)
    if profiled:
        out["busy"] = stop_profile(prof, len(inputs["moves"]), host)
    out["flux"] = t.flux_slabs.clone()
    out["raw_flux"] = t.raw_flux
    out["elem_global"] = t.elem_global.copy()
    out["segments"] = t.total_segments
    out["tally"] = t
    if tmpdir is not None:
        path = os.path.join(tmpdir, "partitioned.vtu")
        t.write_pumi_tally_mesh(path)
        out["vtu_bytes"] = os.path.getsize(path)
        with open(path) as f:
            head = f.read(4096)
        m = re.search(r'NumberOfCells="(\d+)"', head)
        if m is None or int(m.group(1)) != mesh.ntet:
            raise AssertionError("the partitioned .vtu does not hold the "
                                 "mesh's cells")
    return out


def part_phase_timing(t, state, inputs) -> dict:
    """Move 1's first walk phase at full width, from the facade's state
    before move 1, as the facade's step makes it: one launch with the
    step's budget (``compact_after`` + ``max_crossings``, the chase
    hash's count restarting at ``compact_after``) and the ordered fold of
    its records. The kernel against the plain walk phase (bitwise) and
    both timed (CUDA events: the kernel a median of 5, the plain version
    one call), with its bound."""
    from pumiumtally_tpu_torch.ops import walk_cuda
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp

    want, groups = inputs["moves"][0]
    n, G = MAIN_PARTICLES, MAIN_GROUPS
    placed = wp.distribute_particles(t.partition, None, state["elem"], dict(
        origin=state["pos"].astype(np.float32),
        dest=want.astype(np.float32), weight=np.ones(n, np.float32),
        group=groups, material_id=state["mat"]), cap=t.cap)
    args, pkw = part_phase_inputs(t.partition, placed)
    mc, ca = (t._step_kwargs[k] for k in ("max_crossings", "compact_after"))
    reset = ca if ca is not None and ca < mc else 0
    kw = dict(pkw, initial=False, n_groups=G, max_crossings=mc + reset,
              reset=reset)
    L = t.partition.max_local
    nbins = PART_PARTS * L * G
    f0 = torch.zeros(2 * nbins, dtype=torch.float32, device=DEVICE)

    def kernel(f, lanes=args, **cap):
        out, rec = walk_cuda.walk_rows(*lanes, f, **kw, **cap)
        wp.fold_records(f, [rec], True, nbins, False)
        return out, rec

    def plain(f):
        out, rec = wp.walk_rows_plain(*args, f, **kw)
        wp.fold_records(f, [rec], True, nbins, True)
        return out, rec

    fk, fp = f0.clone(), f0.clone()
    k, records = kernel(fk)
    p, _ = plain(fp)
    torch.cuda.synchronize()
    records = records[0].numel()
    bad = [f for f in PHASE_FIELDS if not torch.equal(k[f], p[f])]
    err = max(float((k["pos"] - p["pos"]).abs().max()),
              float((fk - fp).abs().max()))
    log(f"[part] (c) move 1's first walk phase at full width: "
        f"{args[1].shape[0]} lanes, bound {mc + reset}, count restart "
        f"{reset}, {records} records, "
        f"{int((k['target'] >= 0).sum())} froze at cuts, fields differing "
        f"{bad}, flux bitwise {torch.equal(fk, fp)}")
    if bad or not torch.equal(fk, fp):
        raise AssertionError("the full-width walk phase: kernel and plain "
                             "disagree")

    def fresh():
        return (f0.clone(),)

    cap = dict(capacity=records)
    ms = event_ms(lambda f: kernel(f, **cap), 5, fresh)
    plain_ms = event_ms(plain, 1, fresh)  # one call (~1.1 s)
    # Rows the phase cannot avoid: start, end and every scored row (a
    # probe with unit weights into a zero flux).
    probe = f0.clone()
    ones = torch.ones_like(args[4])
    kernel(probe, args[:4] + (ones,) + args[5:], **cap)
    hit = probe.view(-1, G, 2)[..., 0] > 0
    rows = hit.any(dim=1)
    rows[args[3].long()] = True
    rows[(args[3].long() // L) * L + k["elem"].long()] = True
    m = args[1].shape[0]
    bound, by, nbytes = walk_bound(
        int(rows.sum()), PART_ROW[4], int(hit.sum()), 4,
        m * (PART_LANE_IN[4] + PART_LANE_OUT[4]),
        int(k["iters"].sum(dtype=torch.int64)), PART_FLOPS_PER_ITER)
    log(f"[part] (c) walk phase kernel {ms:.4f} ms (walk_rows and "
        f"fold_records: schedule, walk, ordered scatter; median of 5), "
        f"plain {plain_ms:.4f} ms (one call); "
        f"distinct rows {int(rows.sum())} x {PART_ROW[4]} B, bins "
        f"{int(hit.sum())}, bytes {nbytes}, bound {bound:.4f} ms ({by})")
    # Move 1's first exchange round at full width, from this phase.
    exchange = exchange_round(
        t.partition, exchange_state(placed, args[-1], k),
        "(c) move 1's first")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                max_abs_err=err, bound_bytes=nbytes,
                iters=int(k["iters"].sum(dtype=torch.int64)),
                exchange=exchange)


# The torch exchange's ms a round and its ms of a fused partitioned move,
# measured on an NVIDIA H100 80GB HBM3 at 700 W before the exchange had
# kernels (PERF.md, row B12): the figures the kernels' are printed beside.
PARENT_EXCHANGE_MS, PARENT_FUSED_MOVE = (3.19, 4.87), (21.47, 42.85)


def exchange_state(placed, slots, out, K=None) -> dict:
    """The slot state a step holds after its first walk phase, as
    ``_exchange`` takes it: the distributed slots ``placed`` with the
    walked ``slots`` updated from ``walk_rows``' outputs ``out`` (and
    their recorded points with ``K``)."""
    dev, dtype = placed["origin"].device, placed["origin"].dtype
    total = placed["valid"].shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    s = dict(cur=placed["origin"].clone(), dest=placed["dest"].clone(),
             weight=placed["weight"].clone(),
             pseg=torch.zeros(total, dtype=dtype, device=dev),
             pid=placed["particle_id"].clone(), group=placed["group"].clone(),
             material_id=placed["material_id"].clone(),
             elem=placed["elem"].to(torch.int32).clone(),
             done=torch.zeros(total, dtype=torch.bool, device=dev),
             valid=placed["valid"].clone(),
             target=torch.full((total,), -1, **i32),
             target_elem=torch.zeros(total, **i32),
             prev=torch.full((total,), -1, **i32),
             stuck=torch.zeros(total, **i32), xp=None, kx=None)
    for f, o in (("cur", "pos"), ("elem", "elem"), ("material_id", "mat"),
                 ("done", "done"), ("pseg", "pseg"), ("prev", "prev"),
                 ("stuck", "stuck"), ("target", "target"),
                 ("target_elem", "target_elem")):
        s[f][slots] = out[o]
    if K is not None:
        s["xp"] = torch.zeros(total, K, 3, dtype=dtype, device=dev)
        s["kx"] = torch.zeros(total, **i32)
        s["xp"][slots] = out["xp"]
        s["kx"][slots] = out["kx"]
    return s


def exchange_bound(total: int, sent: int, adopted: int, item: int,
                   K: int, row: int) -> tuple[float, int]:
    """(ms, bytes) the least an exchange round must move: every slot's
    valid flag and target read; a sent slot's fields read (8 floats, the
    3K points, 6 int32, its done flag and its 8 B back code), its row
    written and its valid and target cleared; an adopted slot's row read
    and its fields written (8 floats, the points, 6 int32, two flags)."""
    pts = 3 * K * item + (4 if K else 0)
    nbytes = (total * 5 + sent * (8 * item + pts + 33 + row + 5)
              + adopted * (row + 8 * item + pts + 26))
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def exchange_round(part, state, label: str, timed: bool = True,
                   tag: str = "[part]") -> dict:
    """One exchange round of the stacked parts from ``state``: the kernels
    (``walk_partitioned._exchange``) against ``_exchange_plain`` on copies
    of it, every slot field (points too), the round stats and the drops
    bitwise, and each one's send buffer; with ``timed`` both in CUDA
    events in turns (plain, kernel, kernel, plain; a median of 5 each,
    the kernel on the step's buffer as a later round finds it) beside
    the round's bytes bound."""
    from pumiumtally_tpu_torch.ops import exchange_cuda
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp
    from pumiumtally_tpu_torch.parallel.ranks import RankLayout

    P, L, dev = part.n_parts, part.max_local, state["cur"].device
    total = state["valid"].shape[0]
    cap = total // P
    E = min(max(cap // (2 * P), 64), cap)
    comm = wp.Collectives(RankLayout(0, P, dev))
    canon = (-2 - (part.row_owner.long() * L
                   + part.row_owner_local.long()).view(-1)
             if part.halo_layers else None)
    K = 0 if state["xp"] is None else state["xp"].shape[1]

    def fresh(send=None):
        s = {f: None if v is None else v.clone() for f, v in state.items()}
        if send is not None:
            s["send"] = send
        return s, torch.zeros(P, dtype=torch.int64, device=dev)

    def run(fn, s, dropped):
        return fn(comm, P, 0, P, cap, E, L, canon, s, dropped)

    kept = wp.SEND_BYTES
    out = {}
    for which, fn in (("kernel", wp._exchange),
                      ("plain", wp._exchange_plain)):
        wp.SEND_BYTES = 0
        s, d = fresh()
        b0 = exchange_cuda.BUCKET_LAUNCHES
        stats = run(fn, s, d)
        torch.cuda.synchronize()
        out[which] = dict(s=s, d=d, stats=stats, send_bytes=wp.SEND_BYTES,
                        launches=exchange_cuda.BUCKET_LAUNCHES - b0)
    wp.SEND_BYTES = kept
    k, p = out["kernel"], out["plain"]
    bad = [f for f, v in state.items()
           if v is not None and not torch.equal(k["s"][f], p["s"][f])]
    bad += [f for f in ("stats", "d") if not torch.equal(k[f], p[f])]
    sent, adopted = (int(k["stats"][:, c].sum()) for c in (1, 4))
    item = state["cur"].element_size()
    row = exchange_cuda.row_bytes(state["cur"].dtype, K)
    if exchange_cuda.kernel_row_bytes(state["cur"].dtype, K) != row:
        raise AssertionError(f"{label} the send buffer's rows of {row} B "
                             "are not the kernels' stride")
    bound, nbytes = exchange_bound(total, sent, adopted, item, K, row)
    log(f"{tag} {label} one exchange round of {P} stacked parts, {total} "
        f"slots, E {E}, {K} points a slot: pending "
        f"{int(k['stats'][:, 0].sum())}, sent {sent}, received "
        f"{int(k['stats'][:, 2].sum())}, adopted {adopted}, dropped "
        f"{int(k['d'].sum())}; kernel against _exchange_plain: fields "
        f"differing {bad}; send buffer {k['send_bytes']} B (kernel, once a "
        f"step) / {p['send_bytes']} B (plain, zeroed every round); row "
        f"{row} B; bound {bound:.4f} ms (bytes: {nbytes})")
    if bad or k["launches"] != 1 or p["launches"] or not sent:
        raise AssertionError(f"{label} the exchange kernels disagree with "
                             f"_exchange_plain at {bad}")
    err = max(float((k["s"][f] - p["s"][f]).abs().max())
              for f in ("cur", "dest", "weight", "pseg", "xp")
              if state[f] is not None)
    res = dict(sent=sent, adopted=adopted, bound_ms=bound, bound_bytes=nbytes,
               send_bytes=k["send_bytes"], plain_send_bytes=p["send_bytes"],
               max_abs_err=err)
    if not timed:
        return res
    send = k["s"]["send"]
    del out, k, p
    turns: dict = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = wp._exchange if which == "kernel" else wp._exchange_plain
        turns[which].append(event_ms(
            lambda s, d: run(fn, s, d), 5,
            lambda: fresh(send if which == "kernel" else None)))
    wp.SEND_BYTES = kept
    ms, plain_ms = (float(np.median(turns[x])) for x in ("kernel", "plain"))
    log(f"{tag} {label} the round in CUDA events (median of 5, in turns "
        f"plain, kernel, kernel, plain): kernel {turns['kernel']} ms, plain "
        f"{turns['plain']} ms (the torch exchange in the step: "
        f"{PARENT_EXCHANGE_MS[0]}-{PARENT_EXCHANGE_MS[1]} ms a round), bound "
        f"{bound:.4f} ms")
    return dict(res, ms=ms, plain_ms=plain_ms, turns=turns)



def settle_memory() -> tuple[int, int]:
    """Collect the cycles of earlier phases' objects and reset the peak,
    so that the peak that follows counts what is live: the run's own
    memory and what the smoke keeps. Returns (device bytes resident
    after the collection, bytes it freed)."""
    held = torch.cuda.memory_allocated()
    gc.collect()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return resident, held - resident


def part_full_width(mesh, tmpdir: str) -> dict:
    """(c) and (d): the partitioned cell at full width against PumiTally,
    bitwise across runs and io_pipeline modes."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.ops import walk_cuda
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp

    inputs = part_inputs()
    n = MAIN_PARTICLES
    # Run 1: the counted run (packed), with move 1's state kept.
    state = {}

    def keep(t, when):
        if when == "move 1":
            state.update(pos=t.positions.copy(), elem=t.elem_global.copy(),
                         mat=t.material_id.copy())
        elif when == "move 2":  # the slabs after the search and move 1,
            # on the host, so that no device memory outlives this phase
            state["flux1"] = t.flux_slabs.cpu()
        elif when == "move 3":  # and after move 2
            state["flux2"] = t.flux_slabs.cpu()

    resident, collected = settle_memory()
    zero_counts()
    wp.ROUND_WAITS = 0
    wp.SEND_BYTES = 0
    t0 = time.perf_counter()
    run1 = part_run(mesh, inputs, tmpdir=tmpdir, keep=keep)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    launches["walk_partitioned"] = walk_cuda.PART_LAUNCHES
    waits = wp.ROUND_WAITS
    send_bytes = wp.SEND_BYTES
    peak = torch.cuda.max_memory_allocated()
    log(f"[part] (c) run 1 (packed): {secs:.3f} s (construct "
        f"{run1['construct_s']:.3f} s, partition max_local "
        f"{run1['tally'].partition.max_local}, counts "
        f"{run1['tally'].partition.counts.tolist()}); launches {launches}; "
        f"ROUND_WAITS {waits}; largest send buffer {send_bytes} B; peak "
        f"device memory {peak} bytes (resident before {resident} B, after "
        f"a garbage collection that freed {collected} B); .vtu "
        f"{run1['vtu_bytes']} bytes")
    if not launches["walk_partitioned"] or launches["walk"] != \
            launches["walk_partitioned"]:
        raise AssertionError("the partitioned run did not walk through the "
                             "partitioned layout alone")
    if not launches["scatter_ordered"] or not launches["schedule"]:
        raise AssertionError("the partitioned run did not schedule or "
                             "scatter its walk phases")
    rounds1 = run1["init_rounds"] + sum(m["part"]["rounds"]
                                        for m in run1["moves"])
    if not rounds1 or launches["exchange_bucket"] != rounds1 or \
            launches["exchange_adopt"] != rounds1:
        raise AssertionError(f"the partitioned run's {rounds1} rounds did "
                             "not each exchange through the kernels")
    timing = part_phase_timing(run1.pop("tally"), state, inputs)
    # Run 2: beside PumiTally, in turns, with the phases' spans.
    single = PumiTally(mesh, n, TallyConfig(n_groups=MAIN_GROUPS),
                       device=DEVICE)
    run2 = part_run(mesh, inputs, single=single, spans=True, clocked=True)
    run2.pop("tally")
    print_step_table("partitioned moves 2-4",
                     [r["part"] for r in run2["moves"][1:]], "[part]")
    for i, rec in enumerate(run2["moves"], 1):
        p, s = rec["part"], rec["single"]
        rs = p["round_stats"][:, :, :p["rounds"]]
        per_round = {}
        for nm, r, ms in p["spans"]:
            per_round.setdefault(r, {}).setdefault(nm, 0.0)
            per_round[r][nm] += ms
        log(f"[part] (c) move {i}: partitioned {p['ms']:.3f} ms host, "
            f"{p['segments']} segments, {p['segments'] / p['ms'] * 1e3:.4e} "
            f"segments/s, {p['rounds']} rounds, {p['waits']} round waits, "
            f"{p['relaunches']} walk relaunches; "
            f"PumiTally {s['ms']:.3f} ms, {s['segments']} segments, "
            f"{s['segments'] / s['ms'] * 1e3:.4e} segments/s")
        log(f"[part] (c) move {i}: emigrants sent a round "
            f"{rs[:, 1].sum(axis=0).tolist()}, pending "
            f"{rs[:, 0].sum(axis=0).tolist()}, adopted "
            f"{rs[:, 4].sum(axis=0).tolist()}")
        for r in sorted(per_round):
            log(f"[part] (c) move {i} round {r}: " + ", ".join(
                f"{nm} {ms:.4f} ms" for nm, ms in per_round[r].items()))
    ex_ms = [ms for r in run2["moves"] for nm, _, ms in r["part"]["spans"]
             if nm == "exchange"]
    log(f"[part] (c) exchange spans over moves 1-4: {len(ex_ms)} rounds, "
        f"{min(ex_ms):.4f}-{max(ex_ms):.4f} ms a round, median "
        f"{float(np.median(ex_ms)):.4f} ms (the torch exchange: "
        f"{PARENT_EXCHANGE_MS[0]}-{PARENT_EXCHANGE_MS[1]} ms a round); "
        f"exchange rounds through the kernels in run 1: "
        f"{launches['exchange_bucket']} bucket, "
        f"{launches['exchange_adopt']} adopt")
    late = run2["moves"][1:]
    pseg = sum(r["part"]["segments"] for r in late)
    pms = sum(r["part"]["ms"] for r in late)
    sseg = sum(r["single"]["segments"] for r in late)
    sms = sum(r["single"]["ms"] for r in late)
    log(f"[part] (c) moves 2-4 in turns: partitioned {pseg / pms * 1e3:.4e} "
        f"segments/s ({pms:.3f} ms), PumiTally {sseg / sms * 1e3:.4e} "
        f"segments/s ({sms:.3f} ms)")
    # Against PumiTally.
    last = run2["moves"][-1]
    ps, ss = last["part"], last["single"]
    pos_err = max(float(np.abs(r["part"]["dest"] - r["single"]["dest"]).max())
                  for r in run2["moves"])
    mat_diff = sum(int((r["part"]["mats"] != r["single"]["mats"]).sum())
                   for r in run2["moves"])
    elem_diff = int((run2["elem_global"] != single.element_ids).sum())
    a = run2["raw_flux"].astype(np.float64)
    b = single.raw_flux.astype(np.float64)
    slack = np.abs(a - b) - (1e-5 * np.abs(b) + 1e-5)
    flux_bad = int((slack > 0).sum())
    path = sum(float(np.linalg.norm(
        r["part"]["dest"] - (run2["moves"][i - 1]["part"]["dest"]
                             if i else inputs["pos"]), axis=1).sum())
        for i, r in enumerate(run2["moves"]))
    scored = float(a[..., 0].sum())
    resid = abs(scored - path) / path
    log(f"[part] (c) against PumiTally: max|dpos| {pos_err:.3e} (limit "
        f"1e-5), materials differing {mat_diff}, elements differing "
        f"{elem_diff}, flux bins past rtol 1e-5 + atol 1e-5: {flux_bad}, "
        f"max |dflux| {float(np.abs(a - b).max()):.3e}; segments "
        f"{run2['segments']} / {single.total_segments}; conservation "
        f"residual {resid:.3e} (limit 1e-4)")
    if pos_err > 1e-5 or flux_bad or run2["segments"] != \
            single.total_segments or resid > 1e-4:
        raise AssertionError("the partitioned cell disagrees with PumiTally")
    if mat_diff or elem_diff:
        log(f"[part] (c) note: {mat_diff} material ids and {elem_diff} "
            "elements differ (ties: positions agree within 1e-5)")
    if not torch.equal(run1["flux"], run2["flux"]):
        raise AssertionError("the partitioned flux differs between runs")
    # Run 3: profiled, for the card's busy share (the search, moves 1-2).
    run3 = part_run(mesh, dict(inputs, moves=inputs["moves"][:2]),
                    profiled=True)
    run3.pop("tally")
    busy = run3["busy"]
    log(f"[part] (c) profiled run (moves 1-2): the card busy "
        f"{busy['share']:.4f} of "
        f"the moves' host time ({busy['busy_ms']:.3f} of "
        f"{busy['span_ms']:.3f} ms a move; copies {busy['copy_ms']:.3f} "
        f"ms); top {busy['top']}")
    same = [torch.equal(run3["flux"].cpu(), state["flux2"])]
    # (d) The other io_pipeline modes: "legacy" the search and move 1,
    # "overlap" the search and moves 1-2 (its deferred folds drain inside
    # the next move from move 2 on).
    for io, moves, flux in (("legacy", 1, state["flux1"]),
                            ("overlap", 2, state["flux2"])):
        r = part_run(mesh, dict(inputs, moves=inputs["moves"][:moves]),
                     io=io)
        r.pop("tally")
        same.append(torch.equal(r["flux"].cpu(), flux) and all(
            np.array_equal(x["part"]["dest"], y["part"]["dest"])
            and np.array_equal(x["part"]["mats"], y["part"]["mats"])
            for x, y in zip(r["moves"], run1["moves"][:moves])))
        span = "move 1" if moves == 1 else f"moves 1-{moves}"
        log(f"[part] (d) io_pipeline={io}: the search and {span}, flux and "
            f"write-backs bitwise the packed run: {same[-1]}")
    if not all(same):
        raise AssertionError("the partitioned flux differs across runs or "
                             "io_pipeline modes")
    return dict(launches=launches, waits=waits, peak=peak, busy=busy,
                exchange_span_ms=[min(ex_ms), float(np.median(ex_ms)),
                                  max(ex_ms)],
                segments_per_s=pseg / pms * 1e3,
                single_segments_per_s=sseg / sms * 1e3,
                rounds=[r["part"]["rounds"] for r in run2["moves"]],
                relaunches=[r["part"]["relaunches"] for r in run2["moves"]],
                fault_free=dict(segments=run1["segments"], flux_sum=float(
                    run1["raw_flux"][..., 0].astype(np.float64).sum())),
                flux1=state["flux1"], send_bytes=send_bytes, **timing)


def phase_partitioned(main_tally, main_snaps, tmpdir: str) -> dict:
    t0 = time.perf_counter()
    b1 = part_unpacked(main_tally, main_snaps)
    log(f"[phase] (a) unpacked layout: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    b8 = part_kernel_vs_plain()
    log(f"[phase] (b) partitioned walk phase: "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    full = part_full_width(main_tally.mesh, tmpdir)
    log(f"[phase] (c, d) partitioned cell: {time.perf_counter() - t0:.2f} s")
    return dict(b1=b1, b8=b8, full=full)


# --------------------------------------------------------------------- #
# Phase 17: the partitioned source loop
# --------------------------------------------------------------------- #
PMEGA_SMALL_LANES, PMEGA_SMALL_MOVES = 4096, 3
PMEGA_CKPT_PARTS = 2  # the part count a checkpoint is restored into


def pmega_tally(mesh, n: int, k: int, n_parts=PART_PARTS, dtype=None,
                **kw):
    from pumiumtally_tpu_torch import PartitionedTally, TallyConfig

    cfg = dict(n_groups=MAIN_GROUPS, tolerance=1e-6, megastep=k)
    if dtype is not None:
        cfg.update(dtype=dtype, n_groups=2, tolerance=1e-8)
    cfg.update(kw)
    return PartitionedTally(mesh, n, TallyConfig(**cfg), n_parts=n_parts,
                            halo_layers=PART_HALO, device=DEVICE)


def pmega_slots(t) -> dict:
    """Clones of a partitioned tally's device slot state and slabs."""
    out = {k: v.clone() for k, v in t._src.items()}
    out["flux"] = t.flux_slabs.clone()
    return out


def pmega_same(a: dict, b: dict) -> list:
    """The fields of two ``pmega_slots`` that are not bitwise equal."""
    return [f for f in a if not torch.equal(a[f], b[f])]


def pmega_small(dtype) -> None:
    """(b) on the 20^3 box, 4 parts, halo 1: 3 fused moves of the
    megastep through the kernels against the same moves through the plain
    flight and the plain walk phases on the card (slot state, slab flux
    and the readback bitwise), and run_source_moves at K = 3 bitwise
    3 x K = 1."""
    from pumiumtally_tpu_torch.ops import source
    from pumiumtally_tpu_torch.ops.walk_partitioned import (
        make_partitioned_megastep,
    )

    n = PMEGA_SMALL_LANES
    mesh = jittered_box(SMALL_CELLS, 0.2, 4, dtype)
    src = source.SourceParams(sigma_t={0: 4.0, 1: 9.0},
                              absorption={0: 0.3, 1: 0.5},
                              survival_weight=0.2, seed=13)
    pos = np.random.default_rng(3).uniform(0.1, 0.9, (n, 3))
    sig, ab = src.tables(mesh.class_id.cpu().numpy())
    ends = {}
    for k in (PMEGA_SMALL_MOVES, 1):
        t = pmega_tally(mesh, n, k, dtype=dtype)
        t.initialize_particle_location(pos.reshape(-1))
        t._ensure_source_state(np.ones(n), None, None)
        if k == PMEGA_SMALL_MOVES:
            start = pmega_slots(t)
            l2g = np.clip(t.partition.local2global, 0, mesh.ntet - 1)
            cls_local = np.clip(mesh.class_id.cpu().numpy()[l2g], 0,
                                sig.size - 1)
            runs = []
            for plain in (False, True):
                mega = make_partitioned_megastep(
                    t.device_mesh, t.partition, n_moves=PMEGA_SMALL_MOVES,
                    n_total=n, n_groups=2, class_local=cls_local,
                    sigma_t=sig, absorb_t=ab,
                    eps_near=source.near_epsilon(mesh.coords),
                    survival_weight=src.survival_weight,
                    downscatter=src.downscatter, dtype=dtype,
                    max_crossings=t._step_kwargs["max_crossings"],
                    tolerance=1e-8, plain=plain)
                s = {f: v.clone() for f, v in start.items()}
                runs.append(mega(s["pos"], s["elem"], s["material_id"],
                                 s["weight"], s["group"], s["pid"],
                                 s["valid"], s["alive"], s["flux"], 0,
                                 source.prng_key(src.seed)))
            torch.cuda.synchronize()
            kr, pr = runs
            bad = [f for f in ("position", "elem", "material_id", "weight",
                               "group", "particle_id", "valid", "alive",
                               "flux", "readback")
                   if not torch.equal(getattr(kr, f), getattr(pr, f))]
            log(f"[pmega] (b) {dtype} {SMALL_CELLS}^3, 4 parts, "
                f"{PMEGA_SMALL_MOVES} fused moves, kernels against plain flight + plain walk on "
                f"the card: fields differing {bad}")
            if bad:
                raise AssertionError(f"(b) {dtype}: kernels and plain "
                                     f"disagree in {bad}")
        out = t.run_source_moves(PMEGA_SMALL_MOVES, src)
        ends[k] = (pmega_slots(t), out)
    bad = pmega_same(ends[PMEGA_SMALL_MOVES][0], ends[1][0])
    log(f"[pmega] (b) {dtype} run_source_moves K={PMEGA_SMALL_MOVES} against "
        f"{PMEGA_SMALL_MOVES} x K=1: fields differing {bad}; "
        f"{ends[1][1]}")
    if bad or ends[1][1]["segments"] != ends[PMEGA_SMALL_MOVES][1]["segments"]:
        raise AssertionError(f"(b) {dtype}: K={PMEGA_SMALL_MOVES} is not "
                             "bitwise K=1")


def pmega_chunk(t, src, k: int, **stage) -> dict:
    """One timed ``run_source_moves`` call of k moves: host seconds, the
    part of them the re-stage of given lanes took (a partitioned tally's
    ``_ensure_source_state``: the slot state folded back, distributed
    again and copied), segments and rounds."""
    seg0, rounds0 = t.total_segments, getattr(t, "total_rounds", 0)
    staged = []
    ensure = getattr(t, "_ensure_source_state", None)
    if ensure is not None:
        def timed_ensure(*a):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            out = ensure(*a)
            torch.cuda.synchronize()
            staged.append(time.perf_counter() - s0)
            return out
        t._ensure_source_state = timed_ensure
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = t.run_source_moves(k, src, **stage)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if ensure is not None:
        del t._ensure_source_state
    stage_s = sum(staged)
    return dict(res=res, secs=secs, stage_s=stage_s,
                move_ms=(secs - stage_s) / res["moves"] * 1e3,
                segments=t.total_segments - seg0,
                rounds=getattr(t, "total_rounds", 0) - rounds0,
                moves_per_s=res["moves"] / secs,
                segments_per_s=(t.total_segments - seg0) / secs)


def pmega_full(mesh, tmpdir: str) -> dict:
    """(a), (c) and (d) on the main mesh with bench.py's megastep source
    (1,048,576 particles, 8 groups, float32, Σt 12.5, seed 1, K = 8),
    4 parts, halo 1."""
    from pumiumtally_tpu_torch.ops import source, source_cuda, walk_cuda
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp

    n = MAIN_PARTICLES
    src = source.SourceParams(default_sigma_t=MEGA_SIGMA_T, seed=1)
    # bench.py's megastep calls: the lanes staged in the first call and
    # every later call re-staging unit weights and all lanes alive.
    stage = dict(weights=np.ones(n), groups=np.zeros(n, np.int32),
                 alive=np.ones(n, bool))
    restage = dict(weights=stage["weights"], alive=stage["alive"])
    t0 = time.perf_counter()
    pt = pmega_tally(mesh, n, MEGA_K)
    torch.cuda.synchronize()
    construct = time.perf_counter() - t0
    pos = np.random.default_rng(1).uniform(0.05, 0.95, (n, 3))
    pt.initialize_particle_location(pos.reshape(-1))
    st = mega_tally(mesh, MEGA_K)
    # The first fused move beside PumiTally's: the flux is scored before
    # the physics, so one move is the same work in both.
    first = {}
    for which, t in (("part", pt), ("single", st)):
        first[which] = pmega_chunk(t, src, 1, **stage)
    pt._sync_source_state()
    a = pt.raw_flux.astype(np.float64)
    b = st.raw_flux.astype(np.float64)
    slack = np.abs(a - b) - (1e-5 * np.abs(b) + 1e-5)
    flux_bad = int((slack > 0).sum())
    order = st._perm if st._perm is not None else np.arange(n)
    single_pos = np.empty((n, 3))
    single_pos[order] = st.state.origin.double().cpu().numpy()
    pos_err = float(np.abs(pt.positions - single_pos).max())
    log(f"[pmega] (c) fused move 1 beside PumiTally's: segments "
        f"{first['part']['segments']} / {first['single']['segments']}, "
        f"max|dpos| {pos_err:.3e} (limit 1e-5), flux bins past rtol 1e-5 + "
        f"atol 1e-5: {flux_bad}, max |dflux| {float(np.abs(a - b).max()):.3e}")
    if (first["part"]["segments"] != first["single"]["segments"]
            or flux_bad or pos_err > 1e-5):
        raise AssertionError("(c) the partitioned megastep's first move "
                             "disagrees with PumiTally's")
    # (a) The flight kernel at full width on the stacked slots of the
    # next move, and the single-device form on PumiTally's lanes.
    s = pt._src
    sig = torch.as_tensor(src.tables(mesh.class_id.cpu().numpy())[0],
                          dtype=torch.float32, device=DEVICE)
    class_id = mesh.class_id.cpu().numpy()
    l2g = np.clip(pt.partition.local2global, 0, mesh.ntet - 1)
    cls = torch.from_numpy(np.clip(class_id[l2g], 0, sig.numel() - 1)
                           .astype(np.int32).reshape(-1)).to(DEVICE)
    key = source.fold_in(source.prng_key(src.seed), pt.iter_count)
    go = s["valid"] & s["alive"]
    stacked = flight_check(
        f"(a) stacked slots ({PART_PARTS} x {pt.cap}, "
        f"{int(go.sum())} live)", mesh, key, s["pid"], s["elem"], go,
        s["pos"], sig, class_id=cls, cap=pt.cap,
        max_local=pt.partition.max_local, tag="[pmega]")
    ss = _mega_state(st)
    single = flight_check("(a) the single-device form, PumiTally's lanes",
                          mesh, key, ss["particle_id"], ss["elem"],
                          ss["in_flight"], ss["origin"],
                          st._source_tables(src)[0], tag="[pmega]")
    del ss
    # (c) A warm chunk each, then timed chunks in turns.
    warm = {w: pmega_chunk(t, src, MEGA_K, **restage)
            for w, t in (("part", pt), ("single", st))}
    ref = pmega_slots(pt)
    ref_res = warm["part"]["res"]
    turns = []
    counted = None
    for which in ("part", "single", "single", "part"):
        t = pt if which == "part" else st
        if which == "part" and counted is None:
            resident, collected = settle_memory()
            zero_counts()
            waits0 = wp.ROUND_WAITS
            wp.SPANS = []
            row = pmega_chunk(t, src, MEGA_K, **restage)
            counts = read_counts()
            spans = [(nm, r, a_.elapsed_time(b_))
                     for nm, r, a_, b_ in wp.SPANS]
            wp.SPANS = None
            counted = dict(counts=counts, waits=wp.ROUND_WAITS - waits0,
                           spans=spans, move_ms=row["move_ms"],
                           peak=torch.cuda.max_memory_allocated(),
                           resident=resident, collected=collected)
        else:
            row = pmega_chunk(t, src, MEGA_K, **restage)
        row["which"] = which
        turns.append(row)
        log(f"[pmega] (c) {which} chunk of {MEGA_K}: {row['secs']:.4f} s "
            f"host (the re-stage {row['stage_s'] * 1e3:.3f} ms), "
            f"{row['move_ms']:.3f} ms a fused move, "
            f"{row['segments']} segments, segments/s="
            f"{row['segments_per_s']:.4e}, moves/s={row['moves_per_s']:.4f}"
            + (f", rounds {row['rounds']} ({row['rounds'] / MEGA_K:.2f} a "
               "move)" if which == "part" else ""))
    c = counted["counts"]
    log(f"[pmega] (c) counted chunk: launches {c}; ROUND_WAITS "
        f"{counted['waits']}; peak device memory {counted['peak']} bytes "
        f"(resident before the chunk {counted['resident']} B, after a "
        f"garbage collection that freed {counted['collected']} B)")
    if c["source"] != MEGA_K or not c["walk_partitioned"] or \
            c["walk"] != c["walk_partitioned"]:
        raise AssertionError(f"(c) the partitioned megastep did not run "
                             f"through its kernels: {c}")
    if not c["scatter_ordered"] or not c["schedule"]:
        raise AssertionError("(c) the walk phases were not scheduled or "
                             "scattered")
    per = {}
    for nm, _, ms in counted["spans"]:
        per.setdefault(nm, []).append(ms)
    for nm, v in per.items():
        log(f"[pmega] (c) counted chunk {nm}: {len(v)} spans, "
            f"{sum(v):.4f} ms in all, {sum(v) / MEGA_K:.4f} ms a move, "
            f"least {min(v):.4f}, most {max(v):.4f}")
    counted["exchange_ms"] = sum(per.get("exchange", [])) / MEGA_K
    log(f"[pmega] (c) counted chunk: the exchange {counted['exchange_ms']:.4f}"
        f" ms of a {counted['move_ms']:.3f} ms fused move (the torch "
        f"exchange: {PARENT_FUSED_MOVE[0]} of {PARENT_FUSED_MOVE[1]} ms), "
        f"{c['exchange_bucket']} rounds through csrc/exchange.cu")
    if not c["exchange_bucket"] or c["exchange_adopt"] != c["exchange_bucket"]:
        raise AssertionError("(c) the partitioned megastep did not exchange "
                             "through its kernels")
    # A profiled chunk: the card's busy share of a chunk.
    pt._ensure_source_state(restage["weights"], None, restage["alive"])
    prof = start_profile()
    t0 = time.perf_counter()
    pt.run_source_moves(MEGA_K, src)
    busy = stop_profile(prof, MEGA_K, time.perf_counter() - t0)
    log(f"[pmega] (c) profiled chunk, per fused move: card busy "
        f"{busy['busy_ms']:.4f} ms (copies {busy['copy_ms']:.4f} ms) of "
        f"{busy['span_ms']:.4f} ms host, busy share {busy['share']:.4f} "
        f"(kernels {busy['kernel_share']:.4f})")
    for key_, ms in busy["top"]:
        log(f"[pmega]   {ms:9.4f} ms {key_}")
    parts = [r for r in turns if r["which"] == "part"]
    singles = [r for r in turns if r["which"] == "single"]
    pseg = sum(r["segments"] for r in parts)
    psec = sum(r["secs"] for r in parts)
    pstage = sum(r["stage_s"] for r in parts)
    sseg = sum(r["segments"] for r in singles)
    ssec = sum(r["secs"] for r in singles)
    log(f"[pmega] (c) in turns, bench.py's calls (the re-stage included): "
        f"partitioned {pseg / psec:.4e} segments/s, "
        f"{MEGA_K * len(parts) / psec:.4f} moves/s; without the re-stage "
        f"{pseg / (psec - pstage):.4e} segments/s, "
        f"{(psec - pstage) / (MEGA_K * len(parts)) * 1e3:.3f} ms a fused "
        f"move; PumiTally {sseg / ssec:.4e} segments/s, "
        f"{MEGA_K * len(singles) / ssec:.4f} moves/s, "
        f"{ssec / (MEGA_K * len(singles)) * 1e3:.3f} ms a fused move")
    del pt, st
    torch.cuda.empty_cache()
    features = pmega_features(mesh, src, stage, restage, pos, ref, ref_res,
                              tmpdir)
    return dict(first=first, stacked=stacked, single=single, turns=turns,
                counted=counted, busy=busy, construct_s=construct,
                segments_per_s=pseg / psec, moves_per_s=MEGA_K * len(parts)
                / psec, single_segments_per_s=sseg / ssec,
                stage_ms=pstage / len(parts) * 1e3,
                move_ms=(psec - pstage) / (MEGA_K * len(parts)) * 1e3,
                single_move_ms=ssec / (MEGA_K * len(singles)) * 1e3,
                features=features)


def pmega_run(mesh, src, stage, restage, pos, k=MEGA_K, **kw):
    """A fresh partitioned tally through (c)'s first two calls: one fused
    move with the lanes staged, then a chunk of MEGA_K moves re-staging
    weights and alive flags."""
    t = pmega_tally(mesh, MAIN_PARTICLES, k, **kw)
    t.initialize_particle_location(pos.reshape(-1))
    t.run_source_moves(1, src, **stage)
    t.run_source_moves(MEGA_K, src, **restage)
    return t


def pmega_features(mesh, src, stage, restage, pos, ref, ref_res,
                   tmpdir) -> dict:
    """(d) each feature at full width, held bitwise to (c)'s run after its
    first two calls: integrity on, convergence on, and a checkpoint saved
    after the first call and restored into a fresh tally of the same
    layout (bitwise) and of another part count (the restored state
    bitwise; the continued run to the tolerance stated)."""
    out = {}
    for name, kw in (("integrity", dict(integrity="warn")),
                     ("convergence", dict(convergence=True, batch_moves=2))):
        t0 = time.perf_counter()
        t = pmega_run(mesh, src, stage, restage, pos, **kw)
        bad = pmega_same(pmega_slots(t), ref)
        tel = t.telemetry()
        extra = (tel["integrity"] if name == "integrity"
                 else {f: tel["convergence"][f] for f in
                       ("n_batches", "scored", "rel_err_mean",
                        "rel_err_max")})
        log(f"[pmega] (d) {name} on: fields differing from (c)'s run {bad}; "
            f"{extra}; {time.perf_counter() - t0:.2f} s")
        if bad or (name == "integrity" and tel["integrity"]["violations"]):
            raise AssertionError(f"(d) {name}: not bitwise (c)'s run or "
                                 "violations")
        out[name] = extra
        del t
    # The checkpoint: after the first call, then the chunk.
    t = pmega_tally(mesh, MAIN_PARTICLES, MEGA_K)
    t.initialize_particle_location(pos.reshape(-1))
    t.run_source_moves(1, src, **stage)
    path = os.path.join(tmpdir, "pmega.npz")
    t0 = time.perf_counter()
    t.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    saved = t.raw_flux
    t.run_source_moves(MEGA_K, src, **restage)
    bad = pmega_same(pmega_slots(t), ref)
    del t
    rows = {}
    for parts in (PART_PARTS, PMEGA_CKPT_PARTS):
        r = pmega_tally(mesh, MAIN_PARTICLES, MEGA_K, n_parts=parts)
        t0 = time.perf_counter()
        r.restore_checkpoint(path)
        restore_s = time.perf_counter() - t0
        restored = np.array_equal(r.raw_flux, saved)
        res = r.run_source_moves(MEGA_K, src, **restage)
        rows[parts] = dict(restore_s=restore_s, restored=restored, res=res,
                           segments=res["segments"])
        if parts == PART_PARTS:
            rows[parts]["differ"] = pmega_same(pmega_slots(r), ref)
        else:
            rows[parts]["flux_sum"] = float(r.flux_slabs.double().sum())
        del r
    ref_sum = float(ref["flux"].double().sum())
    other = rows[PMEGA_CKPT_PARTS]
    seg_rel = abs(other["segments"] - ref_res["segments"]) / ref_res[
        "segments"]
    flux_rel = abs(other["flux_sum"] - ref_sum) / ref_sum
    log(f"[pmega] (d) checkpoint after move 1: save {save_s:.3f} s, "
        f"{os.path.getsize(path)} bytes; the writer's continued run "
        f"differs from (c)'s in {bad}; restored into {PART_PARTS} parts in "
        f"{rows[PART_PARTS]['restore_s']:.3f} s (flux bitwise "
        f"{rows[PART_PARTS]['restored']}), its chunk differs from (c)'s in "
        f"{rows[PART_PARTS]['differ']}; into {PMEGA_CKPT_PARTS} parts in "
        f"{other['restore_s']:.3f} s (flux bitwise {other['restored']}), "
        f"its chunk's segments {other['segments']} against "
        f"{ref_res['segments']} (rel {seg_rel:.3e}), flux sum rel "
        f"{flux_rel:.3e} (limits 2e-2: the slots differ, so do the physics "
        "draws of lanes that migrate)")
    if bad or rows[PART_PARTS]["differ"] or not rows[PART_PARTS][
            "restored"] or not other["restored"] or seg_rel > 2e-2 or \
            flux_rel > 2e-2:
        raise AssertionError("(d) the checkpoint did not resume (c)'s run")
    out["checkpoint"] = dict(save_s=save_s, bytes=os.path.getsize(path),
                             restore_s={p: r["restore_s"]
                                        for p, r in rows.items()},
                             other_seg_rel=seg_rel, other_flux_rel=flux_rel)
    return out


def phase_partitioned_megastep(mesh, tmpdir: str) -> dict:
    """Phase 17: the partitioned source loop."""
    t0 = time.perf_counter()
    for dtype in (torch.float64, torch.float32):
        pmega_small(dtype)
    log(f"[phase] (b) small partitioned megastep: "
        f"{time.perf_counter() - t0:.2f} s")
    return pmega_full(mesh, tmpdir)


# --------------------------------------------------------------------- #
# Phase 18: the partitioned tally across processes and its recovery
# --------------------------------------------------------------------- #
# PR 14's launch counts at the partitioned cells (phase 16 (c)'s counted
# run, phase 17 (c)'s counted chunk): walk phases and stop tests.
PR14_PART_LAUNCHES, PR14_PART_WAITS = 37, 37
PR14_PMEGA_LAUNCHES, PR14_PMEGA_WAITS = 58, 58
C3_MAX_CROSSINGS = 16
DEPLETION_CELLS, DEPLETION_PARTICLES, DEPLETION_STEPS = 20, 65536, 2


def ranks_cell(mesh) -> dict:
    """The partitioned cell's move 1 as a step's inputs: a fresh 4-part
    facade locates the cell's sources (seed 1), then its host state and
    move 1's destinations are distributed into the slot layout; the step
    keywords are the facade's."""
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp

    inputs = part_inputs()
    t = part_tally(mesh)
    t.initialize_particle_location(inputs["pos"].reshape(-1))
    want, groups = inputs["moves"][0]
    n = MAIN_PARTICLES
    placed = wp.distribute_particles(
        t.partition, t.device_mesh, t.elem_global, dict(
            origin=t.positions.astype(np.float32),
            dest=want.astype(np.float32), weight=np.ones(n, np.float32),
            group=groups, material_id=t.material_id))
    kw = dict(t._step_kwargs, initial=False)
    return dict(tally=t, placed=placed, kw=kw, partition=t.partition)


def ranks_step(cell, device_mesh, spans=False, **over) -> tuple:
    """One partitioned step over ``device_mesh`` on the cell's inputs:
    (the result, the exchange spans in ms, the step's peak device bytes
    above what was allocated before it)."""
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp

    part, p = cell["partition"], cell["placed"]
    step = wp.make_partitioned_step(device_mesh, part,
                                    **dict(cell["kw"], **over))
    flux = torch.zeros(part.n_parts,
                       part.max_local * MAIN_GROUPS * 2,
                       dtype=torch.float32, device=DEVICE)
    if spans:
        wp.SPANS = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res = step(p["origin"], p["dest"], p["elem"],
               torch.zeros_like(p["valid"]), p["material_id"], p["weight"],
               p["group"], p["particle_id"], p["valid"], flux)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ex = []
    if spans:
        ex = [a.elapsed_time(b) for nm, _, a, b in wp.SPANS
              if nm == "exchange"]
        wp.SPANS = None
    return res, ex, peak


def ranks_budget(part_counts, pmega_counts, cell) -> dict:
    """(a) C3 at the cell: the default bound's launches against PR 14's,
    then max_crossings=16, kernel against plain."""
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp

    got = dict(part=part_counts, pmega=pmega_counts)
    want = dict(part=(PR14_PART_LAUNCHES, PR14_PART_WAITS),
                pmega=(PR14_PMEGA_LAUNCHES, PR14_PMEGA_WAITS))
    log(f"[ranks] (a) default bound: phase 16 (c) walk launches and stop "
        f"tests {got['part']}, phase 17 (c) {got['pmega']}; PR 14 "
        f"{want['part']}, {want['pmega']}")
    if got != want:
        raise AssertionError("the default bound's launches differ from "
                             "PR 14's")
    runs, fresh = [], []
    for plain in (False, True):
        r0, l0 = wp.BUDGET_RELAUNCHES, wp.BUDGET_LANES
        t0 = time.perf_counter()
        res, _, _ = ranks_step(cell, cell["tally"].device_mesh, plain=plain,
                               max_crossings=C3_MAX_CROSSINGS)
        secs = time.perf_counter() - t0
        runs.append(res)
        fresh.append((wp.BUDGET_RELAUNCHES - r0, wp.BUDGET_LANES - l0))
        trunc = int((res.valid & ~res.done).sum())
        log(f"[ranks] (a) max_crossings={C3_MAX_CROSSINGS} "
            f"{'plain' if plain else 'kernel'}: {secs:.3f} s, rounds "
            f"{int(res.n_rounds[0])}, later-round launches {fresh[-1][0]}, "
            f"lanes given a fresh budget {fresh[-1][1]}, lanes starved "
            f"{wp.BUDGET_STARVED}, truncated after the step {trunc}")
    (k, p), kernel = runs, fresh[0]
    bad = [f for f in STEP_FIELDS
           if not torch.equal(getattr(k, f), getattr(p, f))]
    log(f"[ranks] (a) kernel against plain at max_crossings="
        f"{C3_MAX_CROSSINGS}: fields differing {bad}")
    if bad or fresh[0] != fresh[1] or not kernel[1]:
        raise AssertionError("C3's later rounds: kernel and plain disagree "
                             "or no lane got a fresh budget")
    return dict(default=got, relaunches=kernel[0], lanes=kernel[1])


def ranks_nccl(cell, tmpdir: str) -> dict:
    """(b) the step in a one-rank NCCL group against the stacked step,
    bitwise, each step's exchange timed a round (CUDA events); (e)
    write_parallel_vtk on that rank."""
    import socket

    import torch.distributed as dist

    from pumiumtally_tpu_torch.ops import exchange_cuda
    from pumiumtally_tpu_torch.parallel import multihost
    from pumiumtally_tpu_torch.parallel.mesh_partition import (
        assemble_global_flux,
    )

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    up = multihost.init_distributed(f"tcp://localhost:{port}", 1, 0,
                                    device=DEVICE, group_of_one=True,
                                    timeout_s=120)
    log(f"[ranks] (b) process group: {up}, backend {dist.get_backend()}, "
        f"world {dist.get_world_size()}, in {time.perf_counter() - t0:.3f} s")
    try:
        dm = multihost.global_device_mesh(PART_PARTS)
        stacked = cell["tally"].device_mesh
        out, ref, bad = {}, None, set()
        for label, mesh_ in (("stacked", stacked), ("nccl", dm),
                             ("nccl", dm), ("stacked", stacked)):
            b0 = exchange_cuda.BUCKET_LAUNCHES
            res, ex, peak = ranks_step(cell, mesh_, spans=True)
            launched = exchange_cuda.BUCKET_LAUNCHES - b0
            out.setdefault(label, []).append((ex, peak))
            log(f"[ranks] (b) {label}: rounds {int(res.n_rounds[0])}, "
                f"exchange kernel rounds {launched}, exchange ms a round "
                f"{[round(x, 4) for x in ex]}, total "
                f"{sum(ex):.4f} ms; the step's peak device memory {peak} "
                "bytes above its inputs")
            if launched != int(res.n_rounds[0]):
                raise AssertionError(f"the {label} step did not exchange "
                                     "through the kernels every round")
            if ref is None:
                ref = res
            else:  # each result held to the first, then let go
                bad |= {f for f in STEP_FIELDS
                        if not torch.equal(getattr(res, f), getattr(ref, f))}
            del res
        bad = sorted(bad)
        log(f"[ranks] (b) one-rank NCCL step against the stacked step: "
            f"fields differing {bad}")
        if bad:
            raise AssertionError("the one-rank NCCL step differs from the "
                                 "stacked step")
        part = cell["partition"]
        flux = assemble_global_flux(part, ref.flux.view(
            part.n_parts, part.max_local, MAIN_GROUPS, 2))
        t0 = time.perf_counter()
        piece = multihost.write_parallel_vtk(
            os.path.join(tmpdir, "ranks"), cell["tally"].mesh, flux)
        secs = time.perf_counter() - t0
        with open(os.path.join(tmpdir, "ranks.pvtu")) as f:
            index = f.read()
        with open(piece) as f:
            head = f.read(4096)
        m = re.search(r'NumberOfCells="(\d+)"', head)
        log(f"[ranks] (e) write_parallel_vtk on one rank: {piece} "
            f"{os.path.getsize(piece)} bytes in {secs:.3f} s; index names "
            f"it: {os.path.basename(piece) in index}")
        if m is None or int(m.group(1)) != part.ntet or \
                os.path.basename(piece) not in index:
            raise AssertionError("the parallel VTK piece or index is wrong")
        return dict(
            exchange_ms={k: [sum(ex) for ex, _ in v] for k, v in out.items()},
            peak={k: [pk for _, pk in v] for k, v in out.items()})
    finally:
        dist.destroy_process_group()
        multihost._initialized = False


def ranks_elastic(mesh, tmpdir: str, fault_free: dict) -> dict:
    """(c) a chip lost at move 2 of the 4-part cell under the runner:
    rebuilt on 3 parts, the run's 4 moves finished, against phase 16's
    fault-free 4-part run of the same moves (segments and flux sum)."""
    from pumiumtally_tpu_torch.resilience.faultinject import (
        FaultInjector,
        parse_faults,
    )
    from pumiumtally_tpu_torch.resilience.runner import ResilientRunner
    from pumiumtally_tpu_torch.resilience.store import CheckpointStore

    inputs = part_inputs()
    n = MAIN_PARTICLES
    t0 = time.perf_counter()
    # Located before the runner wraps it: the runner then writes no
    # generation 0 (seconds of one host thread) and rolls back to its
    # snapshot on the card, then flushes the recovery's generation.
    t = part_tally(mesh)
    t.initialize_particle_location(inputs["pos"].reshape(-1))
    run = ResilientRunner(
        t, CheckpointStore(os.path.join(tmpdir, "cks"), shards=None),
        every_moves=1000, handle_signals=False, sleep=lambda s: None,
        faults=FaultInjector(parse_faults("chip_down_at_move:2,chip:2")))
    del t
    for want, groups in inputs["moves"]:
        run.move_to_next_location(want.reshape(-1).copy(),
                                  np.ones(n, np.int8), np.ones(n), groups,
                                  np.zeros(n, np.int32))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st = run.recovery_stats
    got = run.tally
    a = got.raw_flux.astype(np.float64)
    ref_seg = fault_free["segments"]
    seg_rel = abs(got.total_segments - ref_seg) / max(ref_seg, 1)
    sum_rel = abs(float(a[..., 0].sum()) - fault_free["flux_sum"]) / (
        fault_free["flux_sum"])
    health = run.coordinator.probe_chips()
    moves = len(inputs["moves"])
    log(f"[ranks] (c) chip 2 lost at move 2 of {moves}: rebuilt on "
        f"{got.n_parts} parts; recovery {st['recovery_seconds']:.3f} s "
        f"(rollbacks {st['rollbacks']}, reshards {st['reshards']}, lost "
        f"moves {st['lost_moves']}); run {secs:.3f} s; against the "
        f"fault-free {PART_PARTS}-part run: segments {got.total_segments} "
        f"/ {ref_seg} (rel {seg_rel:.3e}), flux sum rel {sum_rel:.3e}, "
        f"survivors healthy {all(health.values())}")
    if got.n_parts != PART_PARTS - 1 or st["reshards"] != 1 or \
            got.iter_count != moves or not np.isfinite(a).all() or \
            seg_rel > 1e-4 or sum_rel > 1e-4 or not all(health.values()):
        raise AssertionError("the chip-loss recovery did not finish the "
                             "run on the survivors")
    # No final generation: (c) checks the recovery's, and a flush of this
    # size takes 5-7 s of the smoke's time.
    run.close(final_checkpoint=False)
    return dict(recovery_s=st["recovery_seconds"], run_s=secs,
                seg_rel=seg_rel, sum_rel=sum_rel)


def ranks_depletion() -> dict:
    """(d) two depletion steps in megastep mode on a two-region 20^3 box
    (65,536 particles a step)."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.models.depletion import (
        DepletionLoop,
        RegionNuclide,
    )

    mesh = jittered_box(DEPLETION_CELLS, 0.0, 0, torch.float32)
    t = PumiTally(mesh, DEPLETION_PARTICLES,
                  TallyConfig(n_groups=2, tolerance=1e-6, megastep=MEGA_K),
                  device=DEVICE)
    inv = {0: RegionNuclide(1.0, 3.0, 1.5), 1: RegionNuclide(2.0, 5.0, 2.0)}
    loop = DepletionLoop(t, inv, dt=0.05 * 64 / DEPLETION_PARTICLES, seed=7,
                         mode="megastep")
    secs = []
    for _ in range(DEPLETION_STEPS):
        t0 = time.perf_counter()
        h = loop.step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        log(f"[ranks] (d) depletion step {h.step}: {secs[-1]:.3f} s, "
            f"densities {h.densities}, absorption rates "
            f"{h.absorption_rate}, total flux {h.total_flux:.6e}")
    hist = loop.history
    # The JAX test's step, dt 0.05 at 64 particles, scaled per particle
    # (the raw rates grow with the particles a step): no density reaches
    # the floor.
    falls = all(b.densities[r] < a.densities[r]
                for a, b in zip(hist, hist[1:]) for r in inv) and all(
        d > 1e-6 for r in inv for d in (hist[-1].densities[r],))
    if not falls or not all(h.total_flux > 0 and np.isfinite(h.total_flux)
                            for h in hist):
        raise AssertionError("the depletion steps did not burn the "
                             "densities down")
    return dict(step_s=secs)


def phase_ranks(mesh, part_counts, pmega_counts, fault_free: dict,
                tmpdir: str) -> dict:
    t0 = time.perf_counter()
    cell = ranks_cell(mesh)
    budget = ranks_budget(part_counts, pmega_counts, cell)
    log(f"[phase] (a) crossing budget: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    nccl = ranks_nccl(cell, tmpdir)
    log(f"[phase] (b, e) one-rank NCCL step and parallel VTK: "
        f"{time.perf_counter() - t0:.2f} s")
    del cell
    t0 = time.perf_counter()
    elastic = ranks_elastic(mesh, tmpdir, fault_free)
    log(f"[phase] (c) chip loss: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    depl = ranks_depletion()
    log(f"[phase] (d) depletion: {time.perf_counter() - t0:.2f} s")
    return dict(budget=budget, nccl=nccl, elastic=elastic, depletion=depl)


# --------------------------------------------------------------------- #
# Phase 19: the partitioned debug surfaces and the megastep over ranks
# --------------------------------------------------------------------- #
DEBUG_K = 8  # recorded points kept a lane
POINTS_LIMIT = 1e-5  # partitioned against PumiTally's points, float32


def points_bound(nbytes: int, iters: int, flops: int, lanes: int,
                 rows: int) -> tuple:
    """(bound ms, "bytes" or "operations") of a walk whose ``nbytes``
    without points grow by the points it records (``rows`` of 12 B in
    float32) and each lane's count, read and written (8 B)."""
    b = nbytes + 12 * rows + 8 * lanes
    bytes_ms = b / HBM_BYTES_PER_S * 1e3
    ops_ms = iters * flops / FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), b


def debug_unpacked(main_tally, main_snaps, b1) -> dict:
    """(a) C4: move 1 of the main path on the main mesh's unpacked twin
    (its tables without geo20: phase 16 (a) walks a twin built with
    ``packed=False`` bitwise the packed mesh) with ``record_xpoints=8``
    and the checks, through
    the unpacked layout's feature instantiation against the plain walk
    (every lane, the counts, the points and the flux bitwise; the flux
    and lanes bitwise the walk without features); the walk call with the
    features off and on in turns (CUDA events, median of 5 each)."""
    from pumiumtally_tpu_torch.ops import walk, walk_cuda

    n, K = MAIN_PARTICLES, DEBUG_K
    args, kw = replay_args(main_tally, main_snaps["move"], False)
    twin = dataclasses.replace(main_tally.mesh, geo20=None)
    targs = (twin,) + args[1:]
    flux0 = main_snaps["move"]["flux"]
    feat = dict(record_xpoints=K, debug_checks=True)
    zero_counts()
    walk_cuda.FEATURE_UNPACKED_LAUNCHES = 0
    on = walk_cuda.trace(*targs, flux0.clone(), **kw, **feat)
    torch.cuda.synchronize()
    launches = walk_cuda.FEATURE_UNPACKED_LAUNCHES
    off = walk_cuda.trace(*targs, flux0.clone(), **kw)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    plain = walk.trace(*targs, flux0.clone(), **kw, **feat)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    err = compare(on, plain, torch.float32, 0.0, 0.0,
                  "[debug] (a) unpacked twin move 1, points and checks")
    counts = bool(torch.equal(on.n_xpoints, plain.n_xpoints))
    points = bool(torch.equal(on.xpoints, plain.xpoints))
    same_off = [f for f in ("flux", "position", "elem", "material_id",
                            "done", "lane_iters")
                if not torch.equal(getattr(on, f), getattr(off, f))]
    rows = int(on.n_xpoints.clamp(max=K).sum(dtype=torch.int64))
    log(f"[debug] (a) unpacked twin, move 1 with record_xpoints={K} and the "
        f"checks: {launches} feature launch(es) of the unpacked layout; "
        f"kernel vs plain counts bitwise {counts}, points bitwise {points}; "
        f"fields differing from the walk without features {same_off}; "
        f"points recorded {rows} (mean count "
        f"{float(on.n_xpoints.double().mean()):.3f}, max "
        f"{int(on.n_xpoints.max())})")
    if not (counts and points and not same_off and launches >= 1):
        raise AssertionError("(a) the unpacked feature instantiation "
                             "disagrees with the plain walk")
    cap = {"capacity": int(off.n_segments)}
    turns: dict = {"off": [], "on": []}
    for tag in ("off", "on", "on", "off"):
        extra = feat if tag == "on" else {}
        turns[tag].append(event_ms(
            lambda f, e=extra: walk_cuda.trace(*targs, f, **kw, **cap, **e),
            5, lambda: (flux0.clone(),)))
    table_rows, bins, iters = b1["touched"]
    _, _, nbytes = walk_bound(table_rows, UNPACKED_ROW[4], bins, 4,
                              n * (LANE_IN[4] + LANE_OUT[4]), iters,
                              FLOPS_PER_ITER)
    bound, by, pbytes = points_bound(nbytes, iters, FLOPS_PER_ITER, n, rows)
    on_ms, off_ms = (float(np.median(turns[t])) for t in ("on", "off"))
    log(f"[debug] (a) move 1 walk call on the unpacked twin (CUDA events, "
        f"median of 5), in turns off, on, on, off: off {turns['off']} ms, "
        f"on {turns['on']} ms; plain with the features {plain_ms:.4f} ms "
        f"(one call); bound with the points {bound:.4f} ms ({by}, {pbytes} "
        f"B; without them {nbytes} B)")
    return dict(launches=launches, on_ms=on_ms, off_ms=off_ms, turns=turns,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                max_abs_err=err["max_abs_err"])


def debug_partitioned(mesh, full) -> dict:
    """(b) the partitioned cell through ``PartitionedTally`` with
    ``record_xpoints=8`` (and ``checkify_invariants``, which forces
    "legacy" with it) for the initial search and move 1, beside
    ``PumiTally`` with the points: counts equal, points within
    POINTS_LIMIT, the slabs bitwise phase 16 (c)'s after move 1 (points
    off); every walk launch of the run a feature launch of the
    partitioned layout; the first walk phase of move 1 with points,
    kernel against plain (bitwise, points and counts too), and with and
    without points in turns (CUDA events); the largest send buffer the
    exchanges allocated (``SEND_BYTES``) and the peak device memory. (d) one NaN destination: ``checkify_invariants``
    raises the JAX facade's ValueError and the tally is left as it
    was."""
    from pumiumtally_tpu_torch import PartitionedTally, PumiTally, TallyConfig
    from pumiumtally_tpu_torch.ops import walk_cuda
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp

    n, G, K, P = MAIN_PARTICLES, MAIN_GROUPS, DEBUG_K, PART_PARTS
    inputs = part_inputs()
    want, groups = inputs["moves"][0]
    t = PartitionedTally(mesh, n, TallyConfig(
        n_groups=G, record_xpoints=K, checkify_invariants=True),
        n_parts=P, halo_layers=PART_HALO, device=DEVICE)
    if t._io != "legacy":
        raise AssertionError("the debug surfaces did not force legacy I/O")
    torch.cuda.synchronize()
    resident, collected = settle_memory()
    zero_counts()
    walk_cuda.FEATURE_PART_LAUNCHES = 0
    wp.SEND_BYTES = 0
    t.initialize_particle_location(inputs["pos"].reshape(-1))
    state = dict(pos=t.positions.copy(), elem=t.elem_global.copy(),
                 mat=t.material_id.copy())
    dest, mats = want.reshape(-1).copy(), np.zeros(n, np.int32)
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    t.move_to_next_location(dest, np.ones(n, np.int8), np.ones(n), groups,
                            mats)
    torch.cuda.synchronize()
    move_ms = (time.perf_counter() - s0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    send_on, send_off = wp.SEND_BYTES, full["send_bytes"]
    launches = read_counts()
    feat = walk_cuda.FEATURE_PART_LAUNCHES
    xp, cp = t.intersection_points()
    single = PumiTally(mesh, n, TallyConfig(n_groups=G, record_xpoints=K),
                       device=DEVICE)
    single.initialize_particle_location(inputs["pos"].reshape(-1))
    single.move_to_next_location(want.reshape(-1).copy(),
                                 np.ones(n, np.int8), np.ones(n), groups,
                                 np.zeros(n, np.int32))
    xs, cs = single.intersection_points()
    differ = int((cp != cs).sum())
    pts_err = float(np.abs(xp - xs).max())
    flux_same = bool(torch.equal(t.flux_slabs.cpu(), full["flux1"]))
    cap = t.cap
    log(f"[debug] (b) partitioned cell, record_xpoints={K}: move 1 "
        f"{move_ms:.3f} ms host (legacy I/O), launches {launches}, feature "
        f"launches of the partitioned layout {feat}; counts differing from "
        f"PumiTally's {differ} of {n}, max|dpoint| {pts_err:.3e} (limit "
        f"{POINTS_LIMIT:g}); crossings a lane mean "
        f"{float(cp.astype(np.float64).mean()):.3f}, max {int(cp.max())}; "
        f"slabs bitwise the points-off run's (phase 16 (c)) {flux_same}; "
        f"largest send buffer {send_on} B (phase 16 (c)'s points-off run "
        f"{send_off} B); peak device memory {peak} B (resident before "
        f"{resident} B, after a garbage collection that freed {collected} "
        f"B; phase 16 (c)'s points-off run {full['peak']} B)")
    if differ or pts_err > POINTS_LIMIT or not flux_same or not feat or \
            feat != launches["walk_partitioned"] or send_on <= send_off:
        raise AssertionError("(b) the partitioned points disagree with "
                             "PumiTally's, or the run changed the flux")
    # Move 1's first walk phase with and without points, in turns.
    placed = wp.distribute_particles(t.partition, None, state["elem"], dict(
        origin=state["pos"].astype(np.float32),
        dest=want.astype(np.float32), weight=np.ones(n, np.float32),
        group=groups, material_id=state["mat"]), cap=cap)
    args, pkw = part_phase_inputs(t.partition, placed)
    mc, ca = (t._step_kwargs[k] for k in ("max_crossings", "compact_after"))
    reset = ca if ca is not None and ca < mc else 0
    kw = dict(pkw, initial=False, n_groups=G, max_crossings=mc + reset,
              reset=reset)
    nbins = P * t.partition.max_local * G
    f0 = torch.zeros(2 * nbins, dtype=torch.float32, device=DEVICE)
    m = args[1].shape[0]

    def fresh_points():
        return (torch.zeros(m, K, 3, dtype=torch.float32, device=DEVICE),
                torch.zeros(m, dtype=torch.int32, device=DEVICE))

    def phase(f, pts=None, **cap_kw):
        extra = {} if pts is None else dict(record_xpoints=K, xpoints=pts)
        out, rec = walk_cuda.walk_rows(*args, f, **kw, **extra, **cap_kw)
        wp.fold_records(f, [rec], True, nbins, False)
        return out, rec

    fo, fn, fp = f0.clone(), f0.clone(), f0.clone()
    o, rec = phase(fo)
    w, _ = phase(fn, fresh_points())
    # The partitioned feature instantiation against the plain walk phase
    # with the same points, on the same inputs.
    p, prec = wp.walk_rows_plain(*args, fp, **kw, record_xpoints=K,
                                 xpoints=fresh_points())
    wp.fold_records(fp, [prec], True, nbins, True)
    torch.cuda.synchronize()
    bad = [f for f in PHASE_FIELDS if not torch.equal(o[f], w[f])]
    bad_plain = [f for f in PHASE_FIELDS + ("xp", "kx")
                 if not torch.equal(w[f], p[f])]
    log(f"[debug] (b) move 1's first walk phase with points, kernel vs "
        f"plain: fields differing {bad_plain}, flux bitwise "
        f"{torch.equal(fn, fp)}; against the kernel without points: "
        f"fields differing {bad}, flux bitwise {torch.equal(fo, fn)}")
    if bad or bad_plain or not torch.equal(fo, fn) or \
            not torch.equal(fn, fp):
        raise AssertionError(f"(b) the walk phase with points differs "
                             f"{bad} {bad_plain}")
    del p, prec, fp
    # Move 1's first exchange round with the phase's points in the rows.
    pts_ex = exchange_round(t.partition,
                            exchange_state(placed, args[-1], w, K),
                            f"(b) move 1's first, record_xpoints={K}:",
                            timed=False, tag="[debug]")
    cap_kw = dict(capacity=rec[0].numel())
    turns: dict = {"off": [], "on": []}
    for tag in ("off", "on", "on", "off"):
        if tag == "on":
            turns[tag].append(event_ms(
                lambda f, pts: phase(f, pts, **cap_kw), 5,
                lambda: (f0.clone(), fresh_points())))
        else:
            turns[tag].append(event_ms(lambda f: phase(f, **cap_kw), 5,
                                       lambda: (f0.clone(),)))
    prow = int(w["kx"].clamp(max=K).sum(dtype=torch.int64))
    bound, by, pbytes = points_bound(full["bound_bytes"], full["iters"],
                                     PART_FLOPS_PER_ITER, m, prow)
    on_ms, off_ms = (float(np.median(turns[x])) for x in ("on", "off"))
    log(f"[debug] (b) move 1's first walk phase ({m} lanes; walk_rows and "
        f"fold_records, CUDA events, median of 5), in turns off, on, on, "
        f"off: off {turns['off']} ms, on {turns['on']} ms; points recorded "
        f"{prow}; bound with the points {bound:.4f} ms ({by}, {pbytes} B)")
    # (d) checkify_invariants on the cell: one NaN destination.
    bad_dest = want.reshape(-1).copy()
    bad_dest[3 * (n // 2)] = np.nan
    before, it0 = t.flux_slabs.clone(), t.iter_count
    pos0 = t.positions.copy()
    try:
        t.move_to_next_location(bad_dest, np.ones(n, np.int8), np.ones(n),
                                groups, np.zeros(n, np.int32))
        raised = None
    except ValueError as e:
        raised = str(e)
    kept = (torch.equal(t.flux_slabs, before) and t.iter_count == it0
            and np.array_equal(t.positions, pos0))
    log(f"[debug] (d) checkify_invariants, one NaN destination: raised "
        f"{raised!r}; the tally left as it was {kept}")
    if raised != "particle_destinations contains non-finite values" or \
            not kept:
        raise AssertionError("(d) the partitioned checks did not refuse the "
                             "NaN destination")
    return dict(launches=feat, move_ms=move_ms, pts_err=pts_err, peak=peak,
                send_on=send_on, send_off=send_off,
                exchange_points=pts_ex, on_ms=on_ms,
                off_ms=off_ms, turns=turns, bound_ms=bound, bound_by=by)


def debug_megastep_ranks(mesh) -> dict:
    """(c) the partitioned megastep cell's first chunk (bench.py's
    megastep source, K = 8, 4 parts, halo 1; the lanes staged as phase 17
    stages them) through the stacked megastep and over the MeshEntry mesh
    of a one-rank NCCL group: every output bitwise (slot state, slabs,
    the readback with its physics sums)."""
    import socket

    import torch.distributed as dist

    from pumiumtally_tpu_torch.ops import source
    from pumiumtally_tpu_torch.parallel import multihost

    n = MAIN_PARTICLES
    src = source.SourceParams(default_sigma_t=MEGA_SIGMA_T, seed=1)
    pt = pmega_tally(mesh, n, MEGA_K)
    pt.initialize_particle_location(np.random.default_rng(1).uniform(
        0.05, 0.95, (n, 3)).reshape(-1))
    pt._ensure_source_state(np.ones(n), np.zeros(n, np.int32),
                            np.ones(n, bool))
    s, key = pmega_slots(pt), pt._rng_key(src.seed)

    def chunk():
        mega, capacity = pt._mega_prog(src, MEGA_K)
        x = {k: v.clone() for k, v in s.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = mega(x["pos"], x["elem"], x["material_id"], x["weight"],
                 x["group"], x["pid"], x["valid"], x["alive"], x["flux"],
                 pt.iter_count, key, capacity=capacity)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    ref, s_secs = chunk()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    multihost.init_distributed(f"tcp://localhost:{port}", 1, 0,
                               device=DEVICE, group_of_one=True,
                               timeout_s=120)
    try:
        pt.device_mesh = multihost.global_device_mesh(PART_PARTS)
        pt._mega_progs = {}
        got, r_secs = chunk()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
        multihost._initialized = False
    fields = ("position", "dest", "elem", "material_id", "weight", "group",
              "particle_id", "valid", "alive", "flux", "readback")
    bad = [f for f in fields
           if not torch.equal(getattr(got, f), getattr(ref, f))]
    log(f"[debug] (c) partitioned megastep cell, first chunk of {MEGA_K} "
        f"moves: stacked {s_secs:.3f} s, one-rank {backend} group "
        f"{r_secs:.3f} s; fields differing {bad}; alive after "
        f"{int(got.alive.sum())}")
    if bad:
        raise AssertionError("(c) the megastep over ranks differs from the "
                             "stacked megastep")
    return dict(stacked_s=s_secs, ranks_s=r_secs)


def phase_debug(main_tally, main_snaps, part) -> dict:
    t0 = time.perf_counter()
    a = debug_unpacked(main_tally, main_snaps, part["b1"])
    log(f"[phase] (a) unpacked feature tails: "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    b = debug_partitioned(main_tally.mesh, part["full"])
    log(f"[phase] (b, d) partitioned points and checks: "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    c = debug_megastep_ranks(main_tally.mesh)
    log(f"[phase] (c) partitioned megastep over ranks: "
        f"{time.perf_counter() - t0:.2f} s")
    return dict(a=a, b=b, c=c)


# Phase 20: the block widths of the walk kernel, the tuner on the card and
# the compaction ladder on the partitioned cell.
WIDE_BLOCKS = (64, 256, 512)
TUNE_REPS, TUNE_MOVES, TUNE_MEGA_MOVES = 3, 2, 16
TUNE_FAULT_BLOCK = 256


def width_ptxas(lib: str) -> dict:
    """{(dtype letter, "initial" or "move", width): ptxas lines} of the
    packed, non-feature, robust walk instantiations at every width, from
    the build log."""
    from pumiumtally_tpu_torch.analysis.costmodel import ptxas_lines

    pat = re.compile(r"walk_kernel<([fd])Lb1ELb(\d)ELb(\d)ELb0ELi0ELi(\d+)E>")
    out = {}
    for inst, rec in ptxas_records(lib).items():
        m = pat.match(inst)
        if m and (m.group(2) == "1" or m.group(3) == "1"):
            out[(m.group(1), "initial" if m.group(2) == "1" else "move",
                 int(m.group(4)))] = ptxas_lines(rec)
    return out


def tuning_widths(tally, snaps) -> dict:
    """(a) Each width against the 128 kernel on the main cell's initial
    search and move 1 (float32: lanes and flux bitwise), against the
    plain walk on the 20^3 box (float64), and move 1's ordered walk call
    at each width in turns (CUDA events, median of 5)."""
    from pumiumtally_tpu_torch.ops import walk, walk_cuda

    out = {"ms": {}, "resident": {}, "max_abs_err": 0.0}
    for initial in (True, False):
        args, kw = replay_args(tally, snaps["initial" if initial
                                             else "move"], initial)
        flux0 = snaps["initial" if initial else "move"]["flux"]
        ref = walk_cuda.trace(*args, flux0.clone(), **kw)
        cap = {} if initial else {"capacity": int(ref.n_segments)}
        for b in WIDE_BLOCKS:
            got = walk_cuda.trace(*args, flux0.clone(), **kw, **cap, block=b)
            err = compare(got, ref, tally.config.dtype, 0.0, 0.0,
                          f"[tune] (a) main cell "
                          f"{'initial search' if initial else 'move 1'} "
                          f"block {b} against block 128")
            out["max_abs_err"] = max(out["max_abs_err"], err["max_abs_err"])
        if initial:
            continue
        order = (128, *WIDE_BLOCKS)
        calls = {b: [] for b in order}
        for rep in range(5):
            turn = order if rep % 2 == 0 else order[::-1]
            for b in turn:
                calls[b].append(event_ms(
                    lambda f: walk_cuda.trace(*args, f, **kw, **cap,
                                              block=b),
                    1, lambda: (flux0.clone(),)))
        for b in order:
            out["ms"][b] = float(np.median(calls[b]))
    lines = width_ptxas(LIBS[0])
    for b in (128, *WIDE_BLOCKS):
        res = {(dt, i): walk_cuda.resident_threads(dt, initial=i, block=b)
               for dt in (torch.float32, torch.float64)
               for i in (True, False)}
        out["resident"][b] = res[(tally.config.dtype, False)]
        log(f"[tune] (a) block {b}: move 1 ordered walk call "
            f"{out['ms'][b]:.4f} ms (median of 5, widths in turns); "
            f"resident threads (initial, move) float32 "
            f"{res[(torch.float32, True)]}, {res[(torch.float32, False)]}, "
            f"float64 {res[(torch.float64, True)]}, "
            f"{res[(torch.float64, False)]}")
        for tag, item in (("f", 48), ("d", 80)):
            dyn = item * 2 * b if item * 2 * b > 48 * 1024 else 0
            for phase in ("initial", "move"):
                log(f"[tune] (a) ptxas {tag} {phase} block {b}: "
                    + "; ".join(lines.get((tag, phase, b), ["(none)"]))
                    + (f"; {dyn} bytes of dynamic shared memory" if dyn
                       else ""))
    # float64 on the 20^3 box: every width against the plain walk.
    n, G = SMALL_LANES, 8
    f64 = torch.float64
    mesh = jittered_box(SMALL_CELLS, 0.2, 0, f64)
    rng = np.random.default_rng(20)
    dev = mesh.device

    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    weight, group = t(rng.uniform(0.5, 2.0, n), f64), t(
        rng.integers(0, G, n).astype(np.int32), torch.int32)
    mat = torch.full((n,), -1, dtype=torch.int32, device=dev)
    flux0 = torch.zeros(mesh.ntet * G * 2, dtype=f64, device=dev)
    kw = dict(max_crossings=mesh.ntet + 64, n_groups=G)
    origin = mesh.centroids()[0].expand(n, 3).contiguous()
    elem = torch.zeros(n, dtype=torch.int32, device=dev)
    fly = torch.ones(n, dtype=torch.bool, device=dev)
    src = t(rng.uniform(0.02, 0.98, (n, 3)), f64)
    args = (mesh, origin, src, elem, fly, weight, group, mat)
    p = walk.trace(*args, flux0.clone(), initial=True, **kw)
    direction = rng.normal(size=(n, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    dest = t(p.position.cpu().numpy() + direction * rng.exponential(
        0.15, (n, 1)), f64)
    margs = (mesh, p.position, dest, p.elem, fly, weight, group, mat)
    pm = walk.trace(*margs, flux0.clone(), initial=False, **kw)
    for b in WIDE_BLOCKS:
        for a, ref, initial in ((args, p, True), (margs, pm, False)):
            got = walk_cuda.trace(*a, flux0.clone(), initial=initial,
                                  block=b, **kw)
            err = compare(got, ref, f64, 0.0, 0.0,
                          f"[tune] (a) float64 20^3 "
                          f"{'initial' if initial else 'move'} block {b} "
                          f"against the plain walk")
            out["max_abs_err"] = max(out["max_abs_err"], err["max_abs_err"])
    torch.cuda.synchronize()
    return out


def tuning_search(tally, tmpdir: str) -> dict:
    """(b) The tuner in ``mode="hardware"`` on the headline class (the
    main mesh): the kernel axis at four widths, the megastep axis at K in
    {1, 4, 16}; then ``PumiTally(tuning=...)`` on the main cell's inputs,
    moves 1-2, bitwise the default facade, through the winning width; the
    fault hook on smoke1."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.ops import walk_cuda
    from pumiumtally_tpu_torch.tuning import db as tdb
    from pumiumtally_tpu_torch.tuning import search

    path = os.path.join(tmpdir, "TUNING_TORCH.json")
    zero_counts()
    t0 = time.perf_counter()
    data = search.tune({"headline": search.SPECS["headline"]},
                       mode="hardware", reps=TUNE_REPS, moves=TUNE_MOVES,
                       mega_moves=TUNE_MEGA_MOVES,
                       meshes={"headline": tally.mesh})
    secs = time.perf_counter() - t0
    launches = dict(walk_cuda.BLOCK_LAUNCHES)
    tdb.write_tuning(path, data)
    sec = data["environments"][tdb.env_key(tdb.environment(DEVICE))]
    (key, entry), = sec["entries"].items()
    for c in entry["candidates"]:
        what = (f"block {c['block']}" if c["kind"] == "kernel"
                else f"megastep K={c['megastep']}")
        log(f"[tune] (b) {key} {what}: {c['median_s_per_move'] * 1e3:.4f} "
            f"ms a move (median of {TUNE_REPS}: "
            f"{[round(x * 1e3, 4) for x in c['times_s_per_move']]}), "
            f"parity {c['parity']}, predicted "
            f"{c['predicted_s_per_move'] * 1e3:.4f} ms")
        if c["parity"] != "bitwise":
            raise AssertionError(f"tuner candidate {what} failed parity")
    log(f"[tune] (b) winners {key}: block {entry['block']}, megastep "
        f"{entry['megastep']}; calibration {entry['calibration']}; tuner "
        f"{secs:.2f} s; walk launches by width {launches}")
    if any(launches[b] == 0 for b in walk_cuda.BLOCKS):
        raise AssertionError(f"the tuner did not launch every width: "
                             f"{launches}")
    # The tuned facade against the default on the main cell's moves 1-2.
    inputs = part_inputs()
    n, G = MAIN_PARTICLES, MAIN_GROUPS
    runs = {}
    cfgs = {"default": TallyConfig(n_groups=G),
            "tuned": TallyConfig(n_groups=G, tuning=path)}
    for name, cfg in cfgs.items():
        t = PumiTally(tally.mesh, n, cfg, device=DEVICE)
        walk_cuda.BLOCK_LAUNCHES = dict.fromkeys(walk_cuda.BLOCKS, 0)
        walk0 = walk_cuda.LAUNCHES
        t.initialize_particle_location(inputs["pos"].reshape(-1))
        outs = []
        for want, groups in inputs["moves"][:2]:
            dest, mats = want.reshape(-1).copy(), np.zeros(n, np.int32)
            t.move_to_next_location(dest, np.ones(n, np.int8), np.ones(n),
                                    groups, mats)
            outs.append((dest, mats))
        torch.cuda.synchronize()
        runs[name] = dict(outs=outs, flux=t.flux.clone(), width=t._block,
                          launches=dict(walk_cuda.BLOCK_LAUNCHES),
                          walk=walk_cuda.LAUNCHES - walk0)
        log(f"[tune] (b) PumiTally {name}: shape key {t.shape_key}, tuned "
            f"{t._tuned}, width {t._block}, walk launches "
            f"{runs[name]['walk']} by width {runs[name]['launches']}")
    base = runs["default"]
    for name, r in runs.items():
        same = torch.equal(r["flux"], base["flux"]) and all(
            np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            for a, b in zip(r["outs"], base["outs"]))
        log(f"[tune] (b) PumiTally {name} moves 1-2 bitwise the default: "
            f"{same}")
        if not same:
            raise AssertionError(f"the {name} facade differs from the "
                                 "default")
        if r["launches"][r["width"]] != r["walk"] or r["walk"] == 0:
            raise AssertionError(f"the {name} facade did not walk at width "
                                 f"{r['width']}: {r['launches']}")
    # The fault hook: one candidate corrupted by one ulp is rejected.
    os.environ["PUMI_TPU_TUNE_FAULT"] = f"kernel:cuda:{TUNE_FAULT_BLOCK}"
    try:
        _, faulted = search.tune_shape_class(
            search.SPECS["smoke1"], mode="hardware", reps=1, moves=1,
            mega_moves=1)
    finally:
        del os.environ["PUMI_TPU_TUNE_FAULT"]
    verdicts = {c["block"]: c["parity"] for c in faulted["candidates"]
                if c["kind"] == "kernel"}
    log(f"[tune] (b) fault kernel:cuda:{TUNE_FAULT_BLOCK} on smoke1: "
        f"verdicts {verdicts}, winner block {faulted['block']}")
    if (verdicts.get(TUNE_FAULT_BLOCK) != "failed"
            or faulted["block"] == TUNE_FAULT_BLOCK
            or any(v != "bitwise" for b, v in verdicts.items()
                   if b != TUNE_FAULT_BLOCK)):
        raise AssertionError("the parity gate did not reject the fault")
    return dict(entry=entry, launches=launches, seconds=secs,
                facade_launches={k: r["launches"] for k, r in runs.items()})


def tuning_ladder(mesh) -> dict:
    """(c) Move 1 of the partitioned cell (phase 16 (c)'s) under
    ``compact_stages="plan"`` and ``"auto"`` against the default, in
    turns: the write-backs and slabs bitwise; each run's walk launches,
    rounds and first walk phase (CUDA events, round 0's launches)."""
    from pumiumtally_tpu_torch import PartitionedTally, TallyConfig
    from pumiumtally_tpu_torch.ops import walk_cuda
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp

    inputs = part_inputs()
    n, G = MAIN_PARTICLES, MAIN_GROUPS
    want, groups = inputs["moves"][0]
    out = {}
    for cs in (None, "plan", "auto"):
        t = PartitionedTally(mesh, n, TallyConfig(n_groups=G,
                                                  compact_stages=cs),
                             n_parts=PART_PARTS, halo_layers=PART_HALO,
                             device=DEVICE)
        t.initialize_particle_location(inputs["pos"].reshape(-1))
        dest, mats = want.reshape(-1).copy(), np.zeros(n, np.int32)
        walk_cuda.PART_LAUNCHES = 0
        rounds0 = t.total_rounds
        wp.SPANS = []
        t.move_to_next_location(dest, np.ones(n, np.int8), np.ones(n),
                                groups, mats)
        torch.cuda.synchronize()
        first = sum(a.elapsed_time(b) for nm, r, a, b in wp.SPANS
                    if nm == "walk" and r == 0)
        wp.SPANS = None
        name = cs or "default"
        out[name] = dict(dest=dest, mats=mats, flux=t.flux_slabs.clone(),
                         launches=walk_cuda.PART_LAUNCHES,
                         rounds=t.total_rounds - rounds0, first_ms=first,
                         stages=t._step_kwargs["compact_stages"])
        log(f"[tune] (c) partitioned move 1 compact_stages={name}: "
            f"schedule {out[name]['stages']}, PART_LAUNCHES "
            f"{out[name]['launches']}, rounds {out[name]['rounds']}, "
            f"first walk phase {first:.4f} ms")
        del t
    base = out["default"]
    for name in ("plan", "auto"):
        r = out[name]
        same = (np.array_equal(r["dest"], base["dest"])
                and np.array_equal(r["mats"], base["mats"])
                and torch.equal(r["flux"], base["flux"]))
        log(f"[tune] (c) {name} bitwise the default: {same}")
        if not same or not r["stages"]:
            raise AssertionError(f"compact_stages={name} differs from the "
                                 "default or resolved no schedule")
    return out


def phase_tuning(tally, snaps, tmpdir: str) -> dict:
    t0 = time.perf_counter()
    widths = tuning_widths(tally, snaps)
    t1 = time.perf_counter()
    tuned = tuning_search(tally, tmpdir)
    t2 = time.perf_counter()
    ladder = tuning_ladder(tally.mesh)
    t3 = time.perf_counter()
    log(f"[tune] (a) {t1 - t0:.2f} s, (b) {t2 - t1:.2f} s, (c) "
        f"{t3 - t2:.2f} s; card {card_line()}")
    return dict(widths=widths, tuned=tuned, ladder=ladder)



# ---------------------------------------------------------------------- #
# 21. Serving on one card (A11's first part) and its observability (A12).
# ---------------------------------------------------------------------- #
SERVE_CLASSES = (1048576, 786432, 262144)
SERVE_MOVES, SERVE_QUANTUM = 4, 2
CRASH_CELLS, CRASH_CLASSES = 20, (65536, 32768)
CRASH_FAULT = "kill_server_at_quantum:3"
# A server process: the serving CLI's main() (``python -m
# pumiumtally_tpu_torch.serving``'s), started after a gate file exists
# when one is named (argv[1]), its import, wait and main() timed on the
# log's last line.
SERVE_CODE = """import json, os, sys, time
t0 = time.perf_counter()
from pumiumtally_tpu_torch.serving.__main__ import main
t1 = time.perf_counter()
while sys.argv[1] and not os.path.exists(sys.argv[1]):
    time.sleep(0.02)
t2 = time.perf_counter()
try:
    sys.exit(main(sys.argv[2:]))
finally:
    print("[timing] " + json.dumps(dict(
        import_s=t1 - t0, gate_s=t2 - t1,
        main_s=time.perf_counter() - t2)), flush=True)
"""
SERVER_TIMEOUT_S = 600
PROBE_LANES = 65536  # (d)'s profiled probe job: a small trace to write


class ServerProcesses:
    """Phase 21's server processes, each running the serving CLI's
    ``main`` (``python -m pumiumtally_tpu_torch.serving``'s, through
    ``SERVE_CODE``), serving three jobs on the 20^3 box
    over a library bank and writing its JSON beside a log: (b) a cold
    process over the empty bank (started before the smoke's own build,
    so that both nvcc builds run together, and waited for before phase
    3, so that no timed phase shares the card with it), then in phase 21
    a warm one over the bank it filled and one over a copy of that bank
    whose ``source`` library was cut in half; (c) a journaled server
    stopped by ``kill_server_at_quantum:3`` and a fresh process that
    recovers its journal, imported beside the crash and started when the
    crash process has exited. ``stop`` kills every process still
    running."""

    def __init__(self, tmpdir: str):
        self.dir = tmpdir
        self.bank = os.path.join(tmpdir, "bank")
        self.torn_bank = os.path.join(tmpdir, "torn_bank")
        self.journal = os.path.join(tmpdir, "journal")
        # No phase's knob reaches a server process.
        self.env = {k: v for k, v in os.environ.items()
                    if not k.startswith("PUMI_TPU_")}
        self.results: dict = {}
        self._running: dict = {}
        self.torn_entry: str | None = None

    def start(self, label: str, *, bank: str | None = None,
              journal: bool = False, extra=(), fault: str | None = None,
              ok: bool = True, gate: str = "") -> None:
        out = os.path.join(self.dir, f"{label}.json")
        cmd = [sys.executable, "-c", SERVE_CODE, gate, "--demo", "3", "--moves", str(SERVE_MOVES),
               "--quantum", str(SERVE_QUANTUM), "--cells", str(CRASH_CELLS),
               "--classes", ",".join(map(str, CRASH_CLASSES)),
               "--max-resident", "1", "--bank", bank or self.bank,
               "--device", DEVICE,
               "--out", out, *extra]
        if journal:
            cmd += ["--journal", self.journal]
        env = dict(self.env, **({"PUMI_TPU_FAULTS": fault} if fault else {}))
        logf = os.path.join(self.dir, f"{label}.log")
        with open(logf, "w") as f:
            proc = subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT, env=env,
                cwd=os.path.dirname(os.path.abspath(__file__)))
        ended: dict = {}
        reaper = threading.Thread(target=lambda: ended.update(
            rc=proc.wait(), t=time.perf_counter()), daemon=True)
        reaper.start()
        self._running[label] = (proc, cmd, out, logf, ok, time.perf_counter(),
                                reaper, ended)

    def finish(self, label: str) -> dict:
        """Wait for ``label``'s process; its JSON with its wall seconds
        (start to exit), its import, gate and main() seconds, exit code
        and log. Raises if it exits otherwise than expected."""
        proc, cmd, out, logf, ok, t0, reaper, ended = self._running.pop(label)
        reaper.join(timeout=SERVER_TIMEOUT_S)
        if reaper.is_alive():
            proc.kill()
            raise AssertionError(f"[serve] {label} did not end in "
                                 f"{SERVER_TIMEOUT_S} s")
        rc, wall = ended["rc"], ended["t"] - t0
        with open(logf) as f:
            text = f.read()
        if (rc == 0) != ok:
            raise AssertionError(f"[serve] {label}: exit {rc} "
                                 f"({' '.join(cmd)}):\n{text[-3000:]}")
        res = {}
        if ok:
            with open(out) as f:
                res = json.load(f)
        timing = [ln for ln in text.splitlines() if ln.startswith("[timing] ")]
        res.update(json.loads(timing[-1][9:]) if timing else {})
        res.update(wall_s=wall, rc=rc, log=text)
        self.results[label] = res
        return res

    def tear(self) -> None:
        """Copy the bank and cut the copy's ``source`` library in half."""
        import shutil

        shutil.copytree(self.bank, self.torn_bank)
        section = os.path.join(self.torn_bank, os.listdir(self.torn_bank)[0])
        entry = [d for d in os.listdir(section) if d.startswith("source-")][0]
        lib = [f for f in os.listdir(os.path.join(section, entry))
               if f.endswith(".so")][0]
        path = os.path.join(section, entry, lib)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        self.torn_entry = entry

    def stop(self) -> None:
        for proc, *_ in self._running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        self._running.clear()


def _sha(arr) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _get(url: str) -> tuple:
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read().decode()


def quantum_moves(records: list, ids: list) -> dict:
    """The moves each job ran over its quanta (flight records): a job
    replayed from move 0 would run more than it asked."""
    per_job = {j: sum(r["moves"] for r in records
                      if r["kind"] == "quantum" and r["job"] == j)
               for j in ids}
    if set(per_job.values()) != {SERVE_MOVES}:
        raise AssertionError(f"moves run a job: {per_job}")
    return per_job


def serve_full_width(mesh, tmpdir: str) -> dict:
    """(a) three jobs of 1,048,576, 786,432 (padded to 1,048,576) and
    262,144 particles, 4 moves each, through ``TallyScheduler``
    (max_resident 2, quantum 2), with the exporter on port 0; each job's
    flux against its uninterrupted ``PumiTally`` run, bitwise; each job's
    spans through ``check_job_trace``; the kernels' launches over the
    drain, which is timed without the profiler. (The checkpoint round
    trip of a job preempted and re-admitted is phase 22 (a)'s
    migration.)"""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.obs import check_job_trace, job_trace
    from pumiumtally_tpu_torch.serving import (
        TallyScheduler,
        synthetic_requests,
    )
    from pumiumtally_tpu_torch.tuning.shapes import bucket

    cfg = TallyConfig(n_groups=MAIN_GROUPS, tolerance=1e-6)
    reqs = synthetic_requests(mesh, 3, class_sizes=SERVE_CLASSES,
                              n_moves=SERVE_MOVES, seed=0)
    t_start = time.perf_counter()
    os.environ["PUMI_TPU_PROM_PORT"] = "0"
    try:
        sched = TallyScheduler(
            mesh, cfg, max_resident=2, quantum_moves=SERVE_QUANTUM,
            handle_signals=False, device=DEVICE)
    finally:
        del os.environ["PUMI_TPU_PROM_PORT"]
    try:
        ids = [sched.submit(r) for r in reqs]
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        sched.run()
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t0
        launches = read_counts()
        base = sched._exporter.url.replace("/metrics", "")
        scrapes = {p: _get(base + p) for p in ("/metrics", "/jobs", "/trace")}
        records = sched.recorder.records()
        spans = sched.tracer.records()
        stats = sched.stats()
        results = {j: sched.result(j) for j in ids}
        rows = {j: sched.job(j) for j in ids}
    finally:
        sched.close()
    for path, (status, body) in scrapes.items():
        if status != 200:
            raise AssertionError(f"[serve] (d) {path} answered {status}")
    if "pumi_jobs_total" not in scrapes["/metrics"][1]:
        raise AssertionError("[serve] (d) /metrics lacks pumi_jobs_total")
    jobs = {r["id"]: r for r in json.loads(scrapes["/jobs"][1])["jobs"]}
    chrome = json.loads(scrapes["/trace"][1])
    if set(jobs) != set(ids) or not any(
            e.get("args", {}).get("job_id") == ids[0]
            for e in chrome["traceEvents"]):
        raise AssertionError("[serve] (d) /jobs or /trace misses a job")
    if stats["outcomes"] != {"completed": 3}:
        raise AssertionError(f"[serve] (a) {stats}")
    per_job = quantum_moves(records, ids)
    for jid in ids:
        problems = check_job_trace(job_trace(spans, jid), jid)
        if problems:
            raise AssertionError(f"[serve] (a) {jid}'s trace: {problems}")
    for key in ("walk", "schedule", "scatter_bucket", "source"):
        if not launches[key]:
            raise AssertionError(f"[serve] (a) no {key} launch")
    quanta = [r for r in records if r["kind"] == "quantum"]
    segments = sum(int(rows[j].totals["segments"]) for j in ids)
    dev_s = [r["device_seconds"] for r in quanta]
    q_wall = sum(r["seconds"] for r in quanta)
    log(f"[serve] (a) 3 jobs ({', '.join(map(str, SERVE_CLASSES))} "
        f"particles, padded to {[bucket(n) for n in SERVE_CLASSES]}), "
        f"{SERVE_MOVES} moves, quantum {SERVE_QUANTUM}, max_resident 2: "
        f"outcomes {stats['outcomes']}, {len(quanta)} quanta (moves a job "
        f"{per_job}); drain {drain_s:.4f} s "
        f"(no profiler): {3 / drain_s:.4f} jobs/s, "
        f"{segments / drain_s:.4e} segments/s ({segments} segments)")
    log(f"[serve] (a) quanta in order (job, moves, device s, wall s): "
        + ", ".join(f"({r['job']}, {r['moves']}, {r['device_seconds']:.4f},"
                    f" {r['seconds']:.4f})" for r in quanta))
    log(f"[serve] (a) quanta's device seconds {sum(dev_s):.4f} of their "
        f"{q_wall:.4f} s wall ({sum(dev_s) / q_wall:.2%})")
    log(f"[serve] (a) launches over the drain: {launches}")
    t0 = time.perf_counter()
    for req, jid in zip(reqs, ids):
        n = req.origins.shape[0]
        N = bucket(n)
        origins = np.concatenate(
            [req.origins, np.broadcast_to(req.origins[0], (N - n, 3))])
        t = PumiTally(mesh, N, dataclasses.replace(cfg, megastep=SERVE_QUANTUM),
                      device=DEVICE)
        t.initialize_particle_location(origins.reshape(-1).copy())
        t.run_source_moves(
            SERVE_MOVES, req.source,
            weights=np.concatenate([np.ones(n), np.zeros(N - n)]),
            groups=np.zeros(N, np.int32),
            alive=np.concatenate([np.ones(n, bool), np.zeros(N - n, bool)]))
        if t.raw_flux.tobytes() != results[jid].tobytes():
            raise AssertionError(f"[serve] (a) {jid} differs from its "
                                 "uninterrupted PumiTally run")
        del t
    refs_s = time.perf_counter() - t0
    log(f"[serve] (a) seconds: drain {drain_s:.3f}, the 3 uninterrupted "
        f"runs {refs_s:.3f}, all {time.perf_counter() - t_start:.3f}")
    log(f"[serve] (a) every job's flux bitwise its uninterrupted PumiTally "
        f"run; every job's spans pass check_job_trace; /metrics, /jobs and "
        f"/trace answered from the live exporter (port "
        f"{base.rsplit(':', 1)[1]})")
    return dict(launches=launches, drain_s=drain_s, segments=segments,
                jobs_per_s=3 / drain_s, segments_per_s=segments / drain_s,
                device_s=dev_s, quantum_wall=q_wall,
                hashes={j: _sha(v) for j, v in results.items()},
                results=results, reqs=reqs)


def small_box_run() -> dict:
    """The 20^3 box's three jobs served fault-free in this process: the
    bits (b)'s and (c)'s server processes must give."""
    from pumiumtally_tpu_torch import TallyConfig, build_box
    from pumiumtally_tpu_torch.serving import run_saturation

    box = build_box(1.0, 1.0, 1.0, CRASH_CELLS, CRASH_CELLS, CRASH_CELLS,
                    device=DEVICE)
    clean = run_saturation(
        box, TallyConfig(n_groups=MAIN_GROUPS, tolerance=1e-6), n_jobs=3,
        class_sizes=CRASH_CLASSES, n_moves=SERVE_MOVES, seed=0,
        max_resident=1, quantum_moves=SERVE_QUANTUM, device=DEVICE)
    return {j: _sha(v) for j, v in clean["results"].items()}


def serve_bank(servers: ServerProcesses, want: dict) -> dict:
    """(b) the cold, warm and torn server processes: the cold one fills
    the bank (3 misses), the warm one builds nothing (0 misses, 0 compile
    seconds) and the torn one names its entry "torn", rebuilds and
    rewrites it; all three serve the 20^3 box's jobs with this process's
    bits."""
    runs = {k: servers.results[k] for k in ("cold", "warm", "torn")}
    for label, run in runs.items():
        if run["flux_sha256"] != want:
            raise AssertionError(f"[serve] (b) the {label} process's flux "
                                 "differs from the in-process run")
    aot = {k: r["scheduler"]["aot"] for k, r in runs.items()}
    if aot["cold"]["misses"] != 3 or aot["cold"]["compile_seconds"] <= 0:
        raise AssertionError(f"[serve] (b) cold bank {aot['cold']}")
    if (aot["warm"]["misses"], aot["warm"]["compile_seconds"],
            aot["warm"]["hits"]) != (0, 0.0, 3):
        raise AssertionError(f"[serve] (b) warm bank {aot['warm']}")
    entry = servers.torn_entry
    if (aot["torn"]["rewrites"], aot["torn"]["hits"]) != (1, 2) or \
            f"rewriting entry {entry} (torn)" not in runs["torn"]["log"]:
        raise AssertionError(f"[serve] (b) torn bank {aot['torn']}")
    beside = {"cold": "beside the smoke's own nvcc build",
              "warm": "beside the torn and crash processes",
              "torn": "beside the warm and crash processes"}
    for label, run in runs.items():
        log(f"[serve] (b) {label} process ({beside[label]}): first quantum "
            f"{run['first_quantum_s']:.4f} s after main() began (mesh "
            f"build, bank and admission included), serving "
            f"{run['elapsed_s']:.4f} s, main() {run['main_s']:.3f} s, the "
            f"import {run['import_s']:.3f} s, process wall "
            f"{run['wall_s']:.3f} s, "
            f"bank {dict((k, v) for k, v in aot[label].items() if k != 'root')}")
    log(f"[serve] (b) the torn process named {entry} \"torn\", rebuilt "
        f"and rewrote it; all three processes served the {CRASH_CELLS}^3 "
        f"box's jobs with this process's bits")
    return {k: dict(first_quantum_s=r["first_quantum_s"],
                    wall_s=r["wall_s"], aot=aot[k])
            for k, r in runs.items()}


def serve_recovery(servers: ServerProcesses, want: dict) -> dict:
    """(c) the crashed journaled server and its recovery in a fresh
    process against the fault-free in-process run of the same jobs,
    bitwise; every job's trace one trace id across both pids."""
    from pumiumtally_tpu_torch.obs import (
        check_job_trace,
        job_trace,
        load_trace_records,
    )

    crash, rec = servers.results["crash"], servers.results["recover"]
    journal = servers.journal
    if "InjectedKill" not in crash["log"]:
        raise AssertionError("[serve] (c) the server was not killed")
    if rec["flux_sha256"] != want or rec["scheduler"]["recovered"] < 1:
        raise AssertionError("[serve] (c) the recovered jobs differ from "
                             "the fault-free run")
    with open(os.path.join(journal, "JOBS.json")) as f:
        doc = json.load(f)
    recs = load_trace_records(journal)
    crossed = 0
    for jid, entry in doc["jobs"].items():
        trace = job_trace(recs, jid)
        problems = check_job_trace(trace, jid)
        if problems or {r["trace_id"] for r in trace} != {entry["trace_id"]}:
            raise AssertionError(f"[serve] (c) {jid}'s trace: {problems}")
        crossed += len({r["pid"] for r in trace}) > 1
    if not crossed:
        raise AssertionError("[serve] (c) no trace crossed the crash")
    log(f"[serve] (c) {CRASH_FAULT} stopped the journaled server "
        f"({CRASH_CELLS}^3 box, jobs of {CRASH_CLASSES} particles); "
        f"crash process wall {crash['wall_s']:.3f} s; recovery in a fresh "
        f"process ({rec['scheduler']['recovered']} jobs re-queued, serving "
        f"{rec['elapsed_s']:.4f} s, main() {rec['main_s']:.3f} s after "
        f"the crash process ended, the import {rec['import_s']:.3f} s "
        f"beside it, process wall {rec['wall_s']:.3f} s) "
        f"finished every job bitwise the fault-free "
        f"run; {crossed} of {len(doc['jobs'])} traces go on across both "
        f"pids under their trace ids")
    return dict(recovered=rec["scheduler"]["recovered"], crossed=crossed)


def serve_observability(mesh, full: dict, tmpdir: str) -> dict:
    """(d) (a)'s 262,144-particle job with tracing off, its drain under
    the profiler (the served drain's busy share): (a)'s bits and no span;
    a forced burn-rate alert under ``PUMI_TPU_PROFILE=anomaly``
    opens a profiler window over a probe job's quanta (65,536 particles,
    one quantum) and writes one Chrome trace whose device events are
    listed (a window that kept none is taken again, at most 3 times)."""
    from collections import Counter

    from pumiumtally_tpu_torch import TallyConfig
    from pumiumtally_tpu_torch.obs import SLO, FleetProfiler, SLOEvaluator
    from pumiumtally_tpu_torch.serving import (
        TallyScheduler,
        synthetic_requests,
    )

    cfg = TallyConfig(n_groups=MAIN_GROUPS, tolerance=1e-6)
    os.environ["PUMI_TPU_TRACE"] = "off"
    try:
        sched = TallyScheduler(mesh, cfg, max_resident=1,
                               quantum_moves=SERVE_QUANTUM,
                               handle_signals=False, device=DEVICE)
    finally:
        del os.environ["PUMI_TPU_TRACE"]
    try:
        members = [(0, "solo", sched.registry, True)]
        slo = SLO(name="forced-ttfq", kind="latency",
                  metric="pumi_job_time_to_first_quantum_seconds",
                  threshold_s=1e-9, objective=0.5, windows=((1e-6, 1e-6),))
        ev = SLOEvaluator((slo,), sched.registry, sched.recorder)
        ev.evaluate(members)
        job = full["reqs"][2]
        jid = sched.submit(job)
        prof = start_profile()
        t0 = time.perf_counter()
        sched.run()
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t0
        busy = stop_profile(prof, 1, drain_s)
        if sched.result(jid).tobytes() != full["results"][jid].tobytes():
            raise AssertionError("[serve] (d) tracing off changed the bits")
        if sched.tracer.records():
            raise AssertionError("[serve] (d) tracing off kept spans")
        alert = ev.evaluate(members).get("forced-ttfq")
        if alert is None:
            raise AssertionError("[serve] (d) the forced alert did not fire")
        os.environ["PUMI_TPU_PROFILE"] = "anomaly"
        try:
            prof = FleetProfiler(sched.registry, journal_dir=tmpdir,
                                 capture_s=0.0)
        finally:
            del os.environ["PUMI_TPU_PROFILE"]
        for attempt in range(3):
            if not prof.on_alert(alert):
                raise AssertionError("[serve] (d) no capture opened")
            probe = synthetic_requests(mesh, 1, class_sizes=(PROBE_LANES,),
                                       n_moves=SERVE_QUANTUM,
                                       seed=100 + attempt)[0]
            probe.job_id = f"probe-{attempt}"
            sched.submit(probe)
            sched.run()
            prof.sample(members)
            capture = prof.status()["captures"][-1]
            if capture["device_events"]:
                break
        status = prof.status()
    finally:
        sched.close()
    if not capture["trace"] or not capture["device_events"]:
        raise AssertionError(f"[serve] (d) the capture kept no device "
                             f"event: {status}")
    with open(capture["trace"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = Counter(e["name"][:60] for e in events
                      if e.get("cat") in ("kernel", "gpu_memcpy",
                                          "gpu_memset"))
    log(f"[serve] (d) tracing off: (a)'s {SERVE_CLASSES[2]}-particle job "
        f"bitwise, no span kept; its drain under the profiler "
        f"{drain_s:.4f} s, card busy {busy['busy_ms'] / 1e3:.4f} s "
        f"({busy['share']:.2%}; copies {busy['copy_ms'] / 1e3:.4f} s), top "
        f"device work {busy['top'][:4]}")
    log(f"[serve] (d) forced alert {alert['slo']} (burn "
        f"{alert['burn']}) under PUMI_TPU_PROFILE=anomaly: "
        f"{len(status['captures'])} window(s), the last "
        f"{capture['trace']} with {capture['device_events']} device "
        f"events, by name {kernels.most_common(8)}")
    return dict(captures=len(status["captures"]),
                device_events=capture["device_events"],
                busy_share=busy["share"], profiled_drain_s=drain_s)


def phase_serving(mesh, servers: ServerProcesses, tmpdir: str) -> dict:
    """Phase 21: (a) full-width serving, (d) observability, then the
    server processes of (b) the library bank and (c) crash and recovery,
    run together with nothing timed beside them."""
    t0 = time.perf_counter()
    full = serve_full_width(mesh, tmpdir)
    t1 = time.perf_counter()
    obs = serve_observability(mesh, full, tmpdir)
    t2 = time.perf_counter()
    servers.tear()
    gate = os.path.join(servers.dir, "crash_ended")
    servers.start("crash", journal=True, fault=CRASH_FAULT, ok=False)
    servers.start("recover", journal=True, extra=["--resume"], gate=gate)
    servers.start("warm")
    servers.start("torn", bank=servers.torn_bank)
    want = small_box_run()
    servers.finish("crash")
    open(gate, "w").close()
    for label in ("warm", "torn", "recover"):
        servers.finish(label)
    t3 = time.perf_counter()
    bank = serve_bank(servers, want)
    rec = serve_recovery(servers, want)
    log(f"[serve] (a) {t1 - t0:.2f} s, (d) {t2 - t1:.2f} s, (b, c) "
        f"{time.perf_counter() - t2:.2f} s (the server processes "
        f"{t3 - t2:.2f} s); card {card_line()}")
    # Phase 22 serves the same jobs through the fleet and holds them to
    # these bits.
    bits = dict(full=full.pop("results"), small=want)
    full.pop("reqs")
    return dict(full=full, bank=bank, recovery=rec, obs=obs, bits=bits)


# ---------------------------------------------------------------------- #
# 22. The serving fleet (A11's second part).
# ---------------------------------------------------------------------- #
FLEET_MEMBERS = 2
# Phase 21 (a)'s jobs that (a) serves: its 786,432-particle job is left
# out, as each job's journal texts and checkpoints cost seconds of host
# time at full width (PERF.md, the fleet cell).
FLEET_CLASSES = (1048576, 262144)
FLEET_KILL = "kill_server_at_quantum:3"
FLEET_WEDGE = "wedge_member:1"


def _post(url: str, body: bytes) -> dict:
    import urllib.request

    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        if resp.status != 200:
            raise AssertionError(f"[fleet] POST {url}: {resp.status}")
        return json.loads(resp.read())


def fleet_checks(router, label: str, ids: list, want) -> dict:
    """Every job terminal on exactly one alive member, the alive members'
    journals disjoint and together every job, each flux against
    ``want`` (job id -> flux, or -> its sha256), fleetview's check over
    the fleet directory. Returns the members' journaled ids."""
    from pumiumtally_tpu_torch.obs import fleetview

    owned = sorted(j.id for j in router.jobs())
    if owned != sorted(ids):
        raise AssertionError(f"[fleet] {label}: jobs owned {owned}, "
                             f"accepted {sorted(ids)}")
    if not all(router.job(j).terminal for j in ids):
        raise AssertionError(f"[fleet] {label}: a job did not end")
    # fleetview's view of the directory holds every member journal's
    # rows (a full-width request is seconds of json to read).
    view = fleetview.load_dir(router.journal.dir)
    problems = fleetview.check_fleetstats(view)
    if problems:
        raise AssertionError(f"[fleet] {label}: fleetview: {problems}")
    alive = {m.index for m in router.members if m.alive}
    journals = {i: sorted(r["id"] for r in view["jobs"] if r["member"] == i)
                for i in alive}
    seen = [j for v in journals.values() for j in v]
    if sorted(seen) != sorted(ids):
        raise AssertionError(f"[fleet] {label}: member journals "
                             f"{journals} are not disjoint or miss a job")
    for jid in ids:
        got = router.result(jid)
        ok = (got.tobytes() == want[jid].tobytes()
              if isinstance(want[jid], np.ndarray) else _sha(got) == want[jid])
        if not ok:
            raise AssertionError(f"[fleet] {label}: {jid}'s flux differs "
                                 "from phase 21's")
    return journals


def fleet_full_width(mesh, want: dict, tmpdir: str) -> dict:
    """(a) phase 21 (a)'s three jobs through a ``FleetRouter`` of two
    members behind a ``TallyGateway`` on port 0: each POSTed with its
    idempotency key and POSTed again (the same ids, ``n_submitted``
    unchanged), the 1,048,576-particle job migrated after its first
    quantum, every result fetched over ``GET /result`` and decoded,
    bitwise phase 21 (a)'s; the migration's trace link and counter,
    each job's spans through ``check_job_trace``; the kernels' launches
    over the drain; the journal's checkpoint saves timed."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.obs import (
        check_job_trace,
        job_trace,
        load_trace_records,
    )
    from pumiumtally_tpu_torch.serving import (
        FleetRouter,
        TallyGateway,
        decode_result,
        synthetic_requests,
    )
    from pumiumtally_tpu_torch.serving.journal import request_to_json

    cfg = TallyConfig(n_groups=MAIN_GROUPS, tolerance=1e-6)
    reqs = synthetic_requests(mesh, 3, class_sizes=SERVE_CLASSES,
                              n_moves=SERVE_MOVES, seed=0)
    reqs = [r for r in reqs if r.origins.shape[0] in FLEET_CLASSES]
    ckpt: dict = {"save": [], "restore": []}
    saved = PumiTally.save_checkpoint, PumiTally.restore_checkpoint

    def timed(kind, fn):
        def call(self, path, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(self, path, *a, **kw)
            torch.cuda.synchronize()
            ckpt[kind].append((os.path.basename(path).split(".")[0],
                               time.perf_counter() - t0))
        return call

    fdir = os.path.join(tmpdir, "fleet_a")
    resident, freed = settle_memory()
    PumiTally.save_checkpoint = timed("save", saved[0])
    PumiTally.restore_checkpoint = timed("restore", saved[1])
    t_start = time.perf_counter()
    router = FleetRouter(mesh, cfg, fleet_dir=fdir, n_members=FLEET_MEMBERS,
                         max_resident=2, quantum_moves=SERVE_QUANTUM,
                         device=DEVICE)
    gateway = TallyGateway(router, port=0)
    try:
        t0 = time.perf_counter()
        bodies = [json.dumps(dict(request_to_json(r),
                                  idempotency_key=f"key-{r.job_id}")).encode()
                  for r in reqs]
        t1 = time.perf_counter()
        posted = [_post(gateway.url + "/submit", b) for b in bodies]
        t2 = time.perf_counter()
        submitted = router.stats()["jobs"], router._n_submitted
        again = [_post(gateway.url + "/submit", b) for b in bodies]
        t3 = time.perf_counter()
        if again != posted or (router.stats()["jobs"],
                               router._n_submitted) != submitted:
            raise AssertionError(f"[fleet] (a) the second POSTs gave "
                                 f"{again} against {posted}")
        ids = [p["job"] for p in posted]
        placed = {j: router.member_of(j) for j in ids}
        torch.cuda.synchronize()
        zero_counts()
        t_drain = time.perf_counter()
        router.step()
        torch.cuda.synchronize()
        t_mig = time.perf_counter()
        saves_before = len(ckpt["save"])
        moved = router.migrate(ids[0])
        torch.cuda.synchronize()
        mig_s = time.perf_counter() - t_mig
        mig_saves = ckpt["save"][saves_before:]
        router.run()
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t_drain
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        t4 = time.perf_counter()
        fetched = {}
        for jid in ids:
            status, body = _get(f"{gateway.url}/result/{jid}")
            if status != 200:
                raise AssertionError(f"[fleet] (a) /result/{jid}: {status}")
            fetched[jid] = decode_result(json.loads(body))
        t5 = time.perf_counter()
        stats = router.stats()
        recovered = sum(m.registry.counter("pumi_jobs_recovered_total")
                        .value(source="migrated") for m in router.members)
        per_job = quantum_moves(router.recorder.records(), ids)
        fleet_checks(router, "(a)", ids, want)
    finally:
        PumiTally.save_checkpoint, PumiTally.restore_checkpoint = saved
        gateway.stop()
        router.close()
    for jid in ids:
        if fetched[jid].tobytes() != want[jid].tobytes():
            raise AssertionError(f"[fleet] (a) {jid} over GET /result differs "
                                 "from phase 21 (a)'s flux")
    spans = load_trace_records(fdir)
    links = [r["job_id"] for r in spans if r["name"] == "migrated"]
    if links != [ids[0]] or recovered != 1:
        raise AssertionError(f"[fleet] (a) migrated links {links}, "
                             f"pumi_jobs_recovered_total{{source=migrated}} "
                             f"{recovered}")
    for jid in ids:
        problems = check_job_trace(job_trace(spans, jid), jid)
        if problems:
            raise AssertionError(f"[fleet] (a) {jid}'s trace: {problems}")
    # The migration's checkpoint round trip: the source member saved the
    # job at the quantum boundary (the journal's checkpoint, which the
    # migration reuses: it saves nothing more), the target restored it
    # once and its admission says so; each job ran its moves once.
    restored = [r["job_id"] for r in spans
                if r["name"] == "admit" and r.get("restored")]
    if [j for j, _ in ckpt["restore"]] != [ids[0]] or restored != [ids[0]] \
            or mig_saves or ids[0] not in [j for j, _ in ckpt["save"]]:
        raise AssertionError(f"[fleet] (a) saves {ckpt['save']} (the "
                             f"migration's {mig_saves}), restores "
                             f"{ckpt['restore']}, restoring admissions "
                             f"{restored}")
    if stats["outcomes"] != {"completed": len(ids)} or \
            stats["migrations"] != 1 or moved == placed[ids[0]]:
        raise AssertionError(f"[fleet] (a) {stats}")
    for key in ("walk", "schedule", "scatter_bucket", "source"):
        if not launches[key]:
            raise AssertionError(f"[fleet] (a) no {key} launch")
    sizes = [r.origins.shape[0] for r in reqs]
    log(f"[fleet] (a) {len(ids)} jobs ({', '.join(map(str, sizes))} "
        f"particles), {SERVE_MOVES} moves, quantum {SERVE_QUANTUM}, "
        f"{FLEET_MEMBERS} members of max_resident 2 on {DEVICE}, placed "
        f"{placed}, {ids[0]} migrated to member {moved} after its first "
        f"quantum: outcomes {stats['outcomes']}, placements "
        f"{stats['placements']}")
    log(f"[fleet] (a) submission: bodies encoded {t1 - t0:.3f} s "
        f"({sum(map(len, bodies))} bytes), POSTed {t2 - t1:.3f} s, POSTed "
        f"again {t3 - t2:.3f} s (the same ids, n_submitted "
        f"{submitted[1]} unchanged)")
    log(f"[fleet] (a) drain {drain_s:.4f} s: {len(ids) / drain_s:.4f} jobs/s; "
        f"the migration {mig_s:.4f} s; GET /result of {len(ids)} fluxes "
        f"{t5 - t4:.3f} s; peak device memory {peak} B after settle_memory "
        f"({resident} B resident, {freed} B collected)")
    log(f"[fleet] (a) checkpoint saves (job, s; the journal's at each "
        f"quantum boundary; the migration reused {ids[0]}'s and saved "
        f"none): "
        + ", ".join(f"({j}, {s:.3f})" for j, s in ckpt["save"])
        + "; restores: "
        + ", ".join(f"({j}, {s:.3f})" for j, s in ckpt["restore"])
        + f"; admissions restored from a checkpoint {restored}; moves a "
        f"job {per_job}")
    log(f"[fleet] (a) launches over the drain: {launches}")
    log(f"[fleet] (a) every flux over GET /result bitwise phase 21 (a)'s; one "
        f"migrated link, pumi_jobs_recovered_total{{source=\"migrated\"}} "
        f"1; every job's spans pass check_job_trace; fleetview --check "
        f"passed; all {time.perf_counter() - t_start:.3f} s")
    return dict(launches=launches, drain_s=drain_s,
                jobs_per_s=len(ids) / drain_s, migration_s=mig_s, peak=peak,
                saves=ckpt["save"], restores=ckpt["restore"],
                submit_s=t3 - t0, sizes=sizes)


def fleet_failures(want: dict, tmpdir: str) -> dict:
    """(b) the 20^3 box's three jobs (phase 21 (b), (c)) through three
    failures, each ending bitwise phase 21's fluxes: a member killed and
    absorbed; the router crashed by ``kill_server_at_quantum:3`` and
    recovered with the whole workload POSTed again; a supervisor
    evicting a member wedged by ``wedge_member:1``."""
    from pumiumtally_tpu_torch import TallyConfig, build_box
    from pumiumtally_tpu_torch.resilience.faultinject import (
        FaultInjector,
        InjectedKill,
        parse_faults,
    )
    from pumiumtally_tpu_torch.serving import (
        FleetJournal,
        FleetRouter,
        FleetSupervisor,
        run_fleet_saturation,
        synthetic_requests,
    )

    box = build_box(1.0, 1.0, 1.0, CRASH_CELLS, CRASH_CELLS, CRASH_CELLS,
                    device=DEVICE)
    cfg = TallyConfig(n_groups=MAIN_GROUPS, tolerance=1e-6)
    kw = dict(max_resident=1, quantum_moves=SERVE_QUANTUM, device=DEVICE)
    reqs = synthetic_requests(box, 3, class_sizes=CRASH_CLASSES,
                              n_moves=SERVE_MOVES, seed=0)
    ids = [r.job_id for r in reqs]
    out = {}

    t0 = time.perf_counter()
    router = FleetRouter(box, cfg, fleet_dir=os.path.join(tmpdir, "kill"),
                         n_members=FLEET_MEMBERS, absorb_member_kills=True,
                         **kw)
    try:
        for r in reqs:
            router.submit(r, idempotency_key=f"key-{r.job_id}")
        router.step()
        victims = [j for j in ids if router.member_of(j) == 0]
        router.kill_member(0)
        router.run()
        if router.members[0].alive or not victims or any(
                router.member_of(j) == 0 for j in ids):
            raise AssertionError("[fleet] (b) kill: member 0's jobs stayed")
        fleet_checks(router, "(b) kill", ids, want)
        out["kill"] = dict(s=time.perf_counter() - t0, moved=len(victims),
                           migrations=router.stats()["migrations"])
    finally:
        router.close()
    log(f"[fleet] (b) member 0 killed after the first round, "
        f"absorb_member_kills=True: its {len(victims)} journaled jobs "
        f"placed on member 1, every flux bitwise phase 21's "
        f"({out['kill']['s']:.3f} s)")

    t0 = time.perf_counter()
    fdir = os.path.join(tmpdir, "crash")
    run = dict(fleet_dir=fdir, n_members=FLEET_MEMBERS, n_jobs=3,
               class_sizes=CRASH_CLASSES, n_moves=SERVE_MOVES, seed=0, **kw)
    try:
        run_fleet_saturation(
            box, cfg, faults=FaultInjector(parse_faults(FLEET_KILL)), **run)
        raise AssertionError(f"[fleet] (b) {FLEET_KILL} did not crash the "
                             "router")
    except InjectedKill:
        pass
    t1 = time.perf_counter()
    before = FleetJournal(fdir).load()
    resumed = run_fleet_saturation(box, cfg, resume=True, **run)
    after = FleetJournal(fdir).load()
    if (after["n_submitted"], after["accepted"]) != (
            before["n_submitted"], before["accepted"]) or \
            before["n_submitted"] != 3:
        raise AssertionError(f"[fleet] (b) the POSTs after the crash "
                             f"accepted anew: {before['accepted']} -> "
                             f"{after['accepted']}")
    for jid in ids:
        if _sha(resumed["results"][jid]) != want[jid]:
            raise AssertionError(f"[fleet] (b) crash: {jid} differs")
    if resumed["fleet"]["recovered"] < 1 or resumed["fleet"]["outcomes"] \
            != {"completed": 3}:
        raise AssertionError(f"[fleet] (b) crash: {resumed['fleet']}")
    from pumiumtally_tpu_torch.obs import fleetview

    view = fleetview.load_dir(fdir)
    docs = sorted(r["id"] for r in view["jobs"])
    if docs != sorted(ids) or fleetview.check_fleetstats(view):
        raise AssertionError(f"[fleet] (b) crash: member journals {docs}, "
                             f"fleetview {fleetview.check_fleetstats(view)}")
    out["crash"] = dict(s=time.perf_counter() - t0,
                        recovered=resumed["fleet"]["recovered"])
    log(f"[fleet] (b) {FLEET_KILL} crashed the router "
        f"({t1 - t0:.3f} s); FleetRouter.recover with the workload POSTed "
        f"again: every key deduped (n_submitted {after['n_submitted']}), "
        f"{resumed['fleet']['recovered']} jobs recovered, every flux "
        f"bitwise phase 21's, member journals disjoint, fleetview --check "
        f"passed ({time.perf_counter() - t1:.3f} s)")

    t0 = time.perf_counter()
    router = FleetRouter(box, cfg, fleet_dir=os.path.join(tmpdir, "wedge"),
                         n_members=FLEET_MEMBERS,
                         faults=FaultInjector(parse_faults(FLEET_WEDGE)),
                         **kw)
    try:
        for r in reqs:
            router.submit(r, idempotency_key=f"key-{r.job_id}")
        victims = [j for j in ids if router.member_of(j) == 1]
        sup = FleetSupervisor(router, heartbeat_misses=2, grace_ticks=1)
        sup.run()
        doc = FleetJournal(router.journal.dir).load()
        if router.members[1].alive or doc["evicted"] != {
                "1": {"cause": "wedged"}} or not victims:
            raise AssertionError(f"[fleet] (b) wedge: {doc['evicted']}")
        fleet_checks(router, "(b) wedge", ids, want)
        probes = router.registry.histogram(
            "pumi_supervisor_probe_seconds").snapshot()["series"][0]["value"]
        out["wedge"] = dict(s=time.perf_counter() - t0, moved=len(victims),
                            ticks=probes["count"],
                            probe_s=probes["sum"] / probes["count"])
    finally:
        router.close()
    log(f"[fleet] (b) {FLEET_WEDGE}: the supervisor evicted member 1 "
        f"(wedged) after {out['wedge']['ticks']} ticks "
        f"({out['wedge']['probe_s'] * 1e3:.3f} ms a tick), its "
        f"{len(victims)} jobs drained onto member 0, every flux bitwise "
        f"phase 21's ({out['wedge']['s']:.3f} s)")
    return out


def phase_fleet(mesh, bits: dict, tmpdir: str) -> dict:
    """Phase 22: (a) the fleet at full width, (b) its failure paths."""
    t0 = time.perf_counter()
    full = fleet_full_width(mesh, bits["full"], tmpdir)
    t1 = time.perf_counter()
    fail = fleet_failures(bits["small"], tmpdir)
    log(f"[fleet] (a) {t1 - t0:.2f} s, (b) {time.perf_counter() - t1:.2f} s; "
        f"card {card_line()}")
    return dict(full=full, fail=fail)


# In-process runs around one C host process: a C host spends ~12 s of its
# own before its first call returns (the interpreter, torch, the card).
CAPI_TURNS = ("python", "c", "python")
CAPI_TIMEOUT_S = 600


def capi_mesh_turns(coords, tets) -> dict:
    """The native host runtime against the numpy path on the main cell's
    arrays: their derived tables and adjacency bitwise (on this host), and
    each path's seconds in turns (native, numpy, numpy, native)."""
    from unittest import mock

    from pumiumtally_tpu_torch import native
    from pumiumtally_tpu_torch.mesh import core

    def tables(use_native: bool):
        t0 = time.perf_counter()
        if use_native:
            t2v, vol, nrm, d = native.derive_geometry(coords, tets.copy())
        else:
            t2v = core._canonicalize_orientation(coords, tets.copy())
            vol = core._tet_volumes(coords, t2v)
            nrm, d = core._face_planes(coords, t2v)
        t1 = time.perf_counter()
        if use_native:
            t2t = core.build_tet2tet(t2v)
        else:
            with mock.patch.object(native, "load", return_value=None):
                t2t = core.build_tet2tet(t2v)
        t2 = time.perf_counter()
        return (t2v, vol, nrm, d, t2t), (t1 - t0, t2 - t1)

    secs = {True: [], False: []}
    out = {}
    for use_native in (True, False, False, True):
        out[use_native], s = tables(use_native)
        secs[use_native].append(s)
    for a, b, label in zip(out[True], out[False],
                           ("tet2vert", "volumes", "normals", "face_d",
                            "tet2tet")):
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError(f"[capi] native {label} differs from the "
                                 "numpy path's on this host")
    return {"native": secs[True], "numpy": secs[False]}


def capi_inprocess(mesh_file: str, run: dict) -> dict:
    """The four calls in this process on the mesh file, as the bridge's
    ``capi.create`` makes them: per-call host seconds, write-backs and
    the raw flux as float64."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig

    n = run["pos"].shape[0]
    t0 = time.perf_counter()
    t = PumiTally(mesh_file, n, TallyConfig(n_groups=MAIN_GROUPS),
                  device=DEVICE)
    torch.cuda.synchronize()
    out = {"create_s": time.perf_counter() - t0, "move_s": [], "outs": []}
    t0 = time.perf_counter()
    t.initialize_particle_location(run["pos"].reshape(-1).copy())
    out["init_s"] = time.perf_counter() - t0
    for dest, flying, weights, groups, mats in run["moves"]:
        d, f, m = dest.reshape(-1).copy(), flying.copy(), mats.copy()
        t0 = time.perf_counter()
        t.move_to_next_location(d, f, weights, groups, m)
        out["move_s"].append(time.perf_counter() - t0)
        out["outs"].append((d.reshape(n, 3), f, m))
    t0 = time.perf_counter()
    out["flux"] = np.asarray(t.raw_flux, np.float64).ravel()
    out["flux_s"] = time.perf_counter() - t0
    t.close()
    return out


def capi_host(hosts: dict, mesh_file: str, work: str, n: int, moves: int,
              ntet: int) -> dict:
    """One run of the replay host on the card: its per-call seconds
    (``clock_gettime`` on the C side), write-backs and flux."""
    from pumiumtally_tpu_torch import capi

    t0 = time.perf_counter()
    r = subprocess.run(
        [hosts["replay_host"], mesh_file, work, str(n), str(moves),
         str(MAIN_GROUPS), str(ntet * MAIN_GROUPS * 2)],
        env=capi.host_env(DEVICE), capture_output=True, text=True,
        timeout=CAPI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if r.returncode != 0 or r.stdout.splitlines()[-1:] != ["OK"]:
        raise AssertionError(f"[capi] replay host exit {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    replay = capi.read_replay_outputs(work, n, moves)
    return dict(capi.parse_host_seconds(r.stdout), wall=wall,
                flux=replay["flux"], outs=replay["moves"])


def phase_capi(run: dict, tmpdir: str) -> dict:
    """Phase 23: the C ABI at full width. The main cell's mesh written as
    .npz, phase 4's inputs written to files, the replay host (a C program
    linked to the port's bridge) driving the four entry points on the
    card, its flux and every move's write-backs held bitwise to
    ``PumiTally`` driven in this process on the same mesh file and
    inputs, each move's host seconds on both sides in turns (in-process,
    C, in-process); the native
    mesh build against the numpy path at 998,250 tets. The demo host runs
    in phase 24, beside the chaos drivers."""
    from pumiumtally_tpu_torch import capi, native
    from pumiumtally_tpu_torch.mesh.box import build_box_arrays
    from pumiumtally_tpu_torch.mesh.io import save_npz

    if not native.available():
        raise AssertionError("[capi] the native host runtime did not build "
                             "on this host (g++)")
    t0 = time.perf_counter()
    hosts = capi.build_bridge()
    build_s = time.perf_counter() - t0
    log(f"[capi] bridge, demo_host and replay_host built in {build_s:.3f} s "
        f"({os.path.basename(hosts['lib'])}); python {sys.version.split()[0]}"
        f", sysconfig flags {capi.python_flags()}")

    cells, n = MAIN_CELLS, run["pos"].shape[0]
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, cells, cells, cells)
    coords = np.asarray(coords, np.float64)
    tets = np.asarray(tets, np.int64)
    ntet = tets.shape[0]
    mesh_secs = capi_mesh_turns(coords, tets)
    log(f"[capi] mesh build at {ntet} tets on this host, in turns (native, "
        f"numpy, numpy, native): derive_geometry native "
        f"{[round(s[0], 4) for s in mesh_secs['native']]} s, numpy "
        f"{[round(s[0], 4) for s in mesh_secs['numpy']]} s; build_tet2tet "
        f"native {[round(s[1], 4) for s in mesh_secs['native']]} s, numpy "
        f"{[round(s[1], 4) for s in mesh_secs['numpy']]} s; every table "
        f"bitwise")

    mesh_file = os.path.join(tmpdir, "main.npz")
    save_npz(mesh_file, coords, tets, np.zeros(ntet, np.int32))
    work = os.path.join(tmpdir, "replay")
    t0 = time.perf_counter()
    capi.write_replay_inputs(work, run["pos"], run["moves"])
    log(f"[capi] the main cell ({ntet} tets) as .npz and phase 4's inputs "
        f"({n} particles, {len(run['moves'])} moves) written in "
        f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.empty_cache()
    res = {"c": [], "python": []}
    before = dict(native.CALLS)
    for side in CAPI_TURNS:
        if side == "c":
            res["c"].append(capi_host(hosts, mesh_file, work, n,
                                      len(run["moves"]), ntet))
        else:
            res["python"].append(capi_inprocess(mesh_file, run))
    if native.CALLS["derive_geometry"] - before["derive_geometry"] != 2:
        raise AssertionError("[capi] the in-process mesh loads did not go "
                             "through the native host runtime")
    want = res["python"][0]
    for r in res["c"] + res["python"][1:]:
        if r["flux"].tobytes() != want["flux"].tobytes():
            raise AssertionError("[capi] a run's flux differs bitwise")
    for label, r in [("c", r) for r in res["c"]] + [
            ("python", r) for r in res["python"][1:]]:
        for m, (g, w) in enumerate(zip(r["outs"], want["outs"]), start=1):
            for a, b, what in zip(g, w, ("positions", "flying", "materials")):
                if a.tobytes() != b.tobytes():
                    raise AssertionError(f"[capi] {label} move {m}: "
                                         f"{what} differ bitwise")
    last = res["c"][0]["outs"][-1]
    if last[1].any() or not (last[2] == -1).any():
        raise AssertionError("[capi] the C buffers' write-backs: flying "
                             "not reset or no lane ended with material -1")
    scored = float(want["flux"][0::2].sum())
    log(f"[capi] the replay host's flux ({want['flux'].size} float64) and "
        f"every move's positions, flying flags and material ids in the C "
        f"buffers bitwise PumiTally's in this process (flux sum "
        f"{scored:.9e})")
    c_moves = [r["move_s"] for r in res["c"]]
    py_moves = [r["move_s"] for r in res["python"]]
    log(f"[capi] host seconds a move, in turns (in-process, C, "
        f"in-process): C {[[round(x, 6) for x in m] for m in c_moves]}; "
        f"in-process {[[round(x, 6) for x in m] for m in py_moves]}")
    log(f"[capi] C side: create "
        f"{[round(r['create_s'], 3) for r in res['c']]} s (interpreter, "
        f"torch import, mesh load and card set-up), initialize "
        f"{[round(r['init_s'], 4) for r in res['c']]} s, get_flux "
        f"{[round(r['flux_s'], 4) for r in res['c']]} s, write "
        f"{[round(r['write_s'], 4) for r in res['c']]} s, process "
        f"{[round(r['wall'], 3) for r in res['c']]} s; in-process: create "
        f"{[round(r['create_s'], 3) for r in res['python']]} s (mesh load "
        f"and tally), initialize "
        f"{[round(r['init_s'], 4) for r in res['python']]} s, raw_flux "
        f"{[round(r['flux_s'], 4) for r in res['python']]} s")
    demo_mesh = os.path.join(tmpdir, "demo.npz")
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, 2, 2, 2)
    save_npz(demo_mesh, coords, tets, np.zeros(tets.shape[0], np.int32))
    return {"c_move_s": c_moves, "python_move_s": py_moves,
            "hosts": hosts, "demo_mesh": demo_mesh}


CHAOS_RUNS = (
    ("campaign", "corrupt_manifest_chip_down"),
    ("serve", "storm"),
    ("fleet", "retry_storm"),
)


def phase_chaos(hosts: dict, demo_mesh: str, bank: str,
                tmpdir: str) -> dict:
    """Phase 24: one scenario of each chaos driver on the card
    (``python -m pumiumtally_tpu_torch.chaos.<driver> --only <scenario>
    --device cuda``; the fleet's routers over phase 21's warm bank), and
    phase 23's demo host once, all five processes together. Each must
    exit 0 (the demo printing ``OK``)."""
    from pumiumtally_tpu_torch import capi

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PUMI_TPU_")}
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    t0 = time.perf_counter()
    for driver, scenario in CHAOS_RUNS:
        cmd = [sys.executable, "-m", f"pumiumtally_tpu_torch.chaos.{driver}",
               "--only", scenario, "--device", DEVICE]
        if driver == "fleet":
            cmd += ["--bank", bank]
        logf = open(os.path.join(tmpdir, f"{driver}.log"), "w")
        procs[f"{driver} {scenario}"] = (subprocess.Popen(
            cmd, stdout=logf, stderr=subprocess.STDOUT, env=env, cwd=root),
            logf)
    logf = open(os.path.join(tmpdir, "demo.log"), "w")
    procs["demo_host"] = (subprocess.Popen(
        [hosts["demo_host"], demo_mesh, os.path.join(tmpdir, "demo.vtu")],
        stdout=logf, stderr=subprocess.STDOUT,
        env=capi.host_env(DEVICE), cwd=root), logf)
    out = {}
    try:
        for label, (proc, logf) in procs.items():
            rc = proc.wait(timeout=CAPI_TIMEOUT_S)
            logf.close()
            with open(logf.name) as f:
                text = f.read()
            lines = [ln for ln in text.splitlines()
                     if ln.startswith(("[chaos", "FLUX_SUM", "OK",
                                       "CHAOS", "SERVING", "FLEET"))]
            for ln in lines:
                log(f"[chaos] {label}: {ln[:400]}")
            done = text.splitlines()[-1:] == ["OK"] if label == "demo_host" \
                else "PASS" in text
            if rc != 0 or not done:
                raise AssertionError(f"[chaos] {label}: exit {rc}:\n"
                                     f"{text[-3000:]}")
            out[label] = dict(rc=rc, s=time.perf_counter() - t0)
    finally:
        for proc, logf in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()
    log(f"[chaos] all four processes exited 0 ("
        + ", ".join(f"{k} by {v['s']:.2f} s" for k, v in out.items())
        + f"); card {card_line()}")
    return out


class SyncSites:
    """A ``warnings.showwarning`` hook that counts the synchronizing
    operations torch reports under ``set_sync_debug_mode("warn")`` by
    their innermost frame in the package: (path, line, function, with
    ``<locals>`` and comprehension frames folded into their def). A
    warning with no package frame counts under torch's own location."""

    def __init__(self):
        import collections

        self.root = os.path.dirname(os.path.abspath(__file__))
        self.pkg = os.path.join(self.root, "pumiumtally_tpu_torch") + os.sep
        self.sites = collections.Counter()
        self.other = []
        self.stacks: dict = {}  # a site without a package frame: its stack

    def hook(self, message, category, filename, lineno, file=None,
             line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            self.other.append((str(message)[:120], filename, lineno))
            return
        f = sys._getframe(1)
        while f is not None and not f.f_code.co_filename.startswith(
                self.pkg):
            f = f.f_back
        if f is None:
            key = (filename, lineno, "<no package frame>")
            self.sites[key] += 1
            self.stacks.setdefault(key, " <- ".join(
                f"{os.path.basename(g.filename)}:{g.lineno} {g.name}"
                for g in reversed(traceback.extract_stack()[-12:-1])))
            return
        symbol = ".".join(p for p in f.f_code.co_qualname.split(".")
                          if not p.startswith("<"))
        self.sites[(os.path.relpath(f.f_code.co_filename, self.root),
                    f.f_lineno, symbol)] += 1

    def watch(self, fn):
        """``fn()`` under the sync debug mode, every warning shown."""
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = self.hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def phase_host_syncs(tally) -> dict:
    """25. The lint runner in a process of its own (exit 0), and the move
    loop's synchronizing operations on the card, each held to the lint's
    allowance: a counted PUMI001 entry of LINT_BASELINE_TORCH.json, or a
    module that PUMI002 approves for transfers. Returns the sites, the
    runner's seconds and the watched runs' seconds."""
    from pumiumtally_tpu_torch.analysis import load_baseline
    from pumiumtally_tpu_torch.analysis.astlint import (
        APPROVED_TRANSFER_MODULES,
    )
    from pumiumtally_tpu_torch.ops import exchange_cuda, source

    root = os.path.dirname(os.path.abspath(__file__))
    t_lint = time.perf_counter()
    lint = subprocess.Popen(
        [sys.executable, "-m", "pumiumtally_tpu_torch.analysis",
         "--no-contracts"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        counted = {(e["path"], e["symbol"]) for e in load_baseline(
            os.path.join(root, "LINT_BASELINE_TORCH.json"))
            if e["rule"] == "PUMI001"}
        n, G = MAIN_PARTICLES, MAIN_GROUPS
        rng = np.random.default_rng(25)
        watch, runs = SyncSites(), {}
        prev = tally.state.origin.double().cpu().numpy()
        for move in (1, 2):
            want, groups = main_move_inputs(rng, n, G, prev)
            dest = want.reshape(-1).copy()
            t0 = time.perf_counter()
            watch.watch(lambda: tally.move_to_next_location(
                dest, np.ones(n, np.int8), np.ones(n), groups,
                np.zeros(n, np.int32)))
            runs[f"packed move {move}"] = time.perf_counter() - t0
            prev = dest.reshape(n, 3).copy()
        mega = mega_tally(tally.mesh, MEGA_K)
        src = source.SourceParams(default_sigma_t=MEGA_SIGMA_T, seed=1)
        t0 = time.perf_counter()
        watch.watch(lambda: mega.run_source_moves(
            MEGA_K, src, weights=np.ones(n), groups=np.zeros(n, np.int32),
            alive=np.ones(n, bool)))
        runs[f"megastep chunk (K={MEGA_K})"] = time.perf_counter() - t0
        del mega
        part = part_tally(tally.mesh)
        inputs = part_inputs()
        part.initialize_particle_location(inputs["pos"].reshape(-1))
        want, groups = inputs["moves"][0]
        dest = want.reshape(-1).copy()
        t0 = time.perf_counter()
        b0 = exchange_cuda.BUCKET_LAUNCHES
        watch.watch(lambda: part.move_to_next_location(
            dest, np.ones(n, np.int8), np.ones(n), groups,
            np.zeros(n, np.int32)))
        runs["partitioned move"] = time.perf_counter() - t0
        exchanged = exchange_cuda.BUCKET_LAUNCHES - b0
        del part
        gc.collect()
    finally:
        out, _ = lint.communicate(timeout=300)
    lint_s = time.perf_counter() - t_lint
    own = re.search(r"analysis: ([0-9.]+) s", out)
    log(f"[syncs] runner: python -m pumiumtally_tpu_torch.analysis "
        f"--no-contracts exit "
        f"{lint.returncode} in {lint_s:.2f} s on this host (its own clock "
        f"{own.group(1) if own else '?'} s), beside the watched runs")
    if lint.returncode != 0:
        raise AssertionError(f"the port's lint runner failed:\n{out}")
    outside = []
    for (path, line, symbol), count in sorted(watch.sites.items()):
        if (path, symbol) in counted:
            why = "counted PUMI001 entry"
        elif path in APPROVED_TRANSFER_MODULES:
            why = "PUMI002-approved module"
        else:
            why = "OUTSIDE the allowance"
            outside.append((path, line, symbol))
        log(f"[syncs] {count:5d} x {path}:{line} {symbol} ({why})")
        if (path, line, symbol) in watch.stacks:
            log(f"[syncs]         stack: {watch.stacks[path, line, symbol]}")
    log(f"[syncs] {sum(watch.sites.values())} synchronizing operations at "
        f"{len(watch.sites)} sites over "
        + ", ".join(f"{k} {v:.3f} s" for k, v in runs.items())
        + "; syncs inside the kernels' ctypes libraries are not seen by "
        "torch's sync debug mode")
    for msg, filename, lineno in watch.other[:5]:
        log(f"[syncs] other warning {filename}:{lineno}: {msg}")
    at_exchange = [(path, line, symbol) for path, line, symbol in watch.sites
                   if path.endswith("ops/walk_partitioned.py")
                   and symbol.startswith("_exchange")]
    log(f"[syncs] the partitioned move's {exchanged} exchange rounds "
        f"through csrc/exchange.cu; synchronizing operations at _exchange's "
        f"sites: {at_exchange}")
    if outside:
        raise AssertionError(f"synchronizing operations outside the "
                             f"lint's allowance: {outside}")
    if at_exchange or not exchanged:
        raise AssertionError("the partitioned move's exchange synchronized "
                             "or did not run through its kernels")
    return dict(sites=dict(watch.sites), runs=runs, lint_s=lint_s,
                exchanged=exchanged)


SASS: dict = {}  # the float64 census of phase 26, started in phase 25


def start_sass_census() -> None:
    """``cuobjdump -sass`` of the six libraries in a thread (the dumps
    take seconds), so that phase 25's runs overlap it; phase 26 joins."""
    from pumiumtally_tpu_torch.analysis import costmodel as M

    def run():
        t0 = time.perf_counter()
        SASS["f64"] = M.sass_census(M.find_logs())
        SASS["seconds"] = time.perf_counter() - t0

    SASS["thread"] = threading.Thread(target=run, daemon=True)
    SASS["thread"].start()


def phase_contracts(mesh, peak: dict, bank: str) -> dict:
    """26. The kernel resource contracts over phase 2's build logs (and
    ``cost.bank`` over the entries of phase 21's bank at ``bank``), the
    program contracts (the CPU families on this host, the ``cuda`` family
    on the card) and ``cost.peak.cuda`` on phase 4's peak (``peak``:
    ``max_memory_allocated`` and the largest move's segments). Raises on
    any finding outside LINT_BASELINE_TORCH.json. Returns the seconds of
    each part and the numbers printed."""
    from pumiumtally_tpu_torch.analysis import (
        apply_baseline,
        contracts as C,
        costmodel as M,
        load_baseline,
    )
    from pumiumtally_tpu_torch.ops import walk_cuda

    root = os.path.dirname(os.path.abspath(__file__))
    entries = load_baseline(os.path.join(root, "LINT_BASELINE_TORCH.json"))
    out, findings = {}, []
    t0 = time.perf_counter()
    logs = M.find_logs()
    if set(logs) != set(SOURCES):
        raise AssertionError(f"build logs of {sorted(logs)} only")
    if SASS.get("thread") is None:
        start_sass_census()
    SASS["thread"].join()
    out["sass_s"] = SASS["seconds"]
    fresh = M.capture_ptxas(logs, f64=SASS["f64"])
    committed = M.load_perf_contracts(
        os.path.join(root, M.PERF_CONTRACTS_FILE))
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    findings += (M.check_cost(fresh, optin) + M.check_stale(committed["ptxas"])
                 + M.diff_cost(fresh, committed["ptxas"])
                 + M.check_smem_entries())
    metas = []
    for dirpath, _, files in os.walk(bank):
        if "META.json" in files:
            with open(os.path.join(dirpath, "META.json")) as f:
                metas.append(json.load(f))
    findings += M.check_bank(metas, fresh)
    out["ptxas_s"] = time.perf_counter() - t0
    insts = {i: r for s in fresh["sources"].values()
             for i, r in s["instantiations"].items()}
    spills = {i: (r["spill_stores"], r["spill_loads"]) for i, r in insts.items()
              if r["spill_stores"] or r["spill_loads"]}
    f64 = {i: r["f64"] for i, r in insts.items()
           if r.get("f64") and "<d" not in i}
    log(f"[contracts] ptxas: {len(insts)} instantiations of "
        f"{sorted(fresh['sources'])} under {fresh['environment']}, "
        f"registers {min(r['registers'] for r in insts.values())}-"
        f"{max(r['registers'] for r in insts.values())}, static shared "
        f"memory up to {max(r['smem'] for r in insts.values())} B (opt-in "
        f"{optin} B); spills {spills}; float64 SASS instructions outside "
        f"the float64 instantiations {f64}; {len(metas)} bank entries "
        f"checked; {out['ptxas_s']:.2f} s (the cuobjdump census "
        f"{out['sass_s']:.2f} s, begun in phase 25)")
    t0 = time.perf_counter()
    cpu = C.capture()
    findings += C.check_structural(cpu, entries) + C.diff_baseline(
        cpu, C.load_contracts(os.path.join(root, C.CONTRACTS_FILE)))
    out["cpu_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cuda = C.capture_cuda()
    findings += C.check_structural(cuda, entries)
    out["cuda_s"] = time.perf_counter() - t0
    for name, w in cuda["families"]["cuda"].items():
        log(f"[contracts] cuda family, {name} window ({w['moves']} "
            f"move(s)): calls {w['calls']}, launches {w['launches']}, host "
            f"reads {w['host_reads']}, transfers {w['transfers']}"
            + (f", facade io {w['io']}" if "io" in w else "")
            + f", float64 outputs {w['f64_outputs']}, flux kept "
            f"{w['flux_kept']}")
    log(f"[contracts] CPU families on this host (torch {torch.__version__}) "
        f"against {C.CONTRACTS_FILE}: {out['cpu_s']:.2f} s; the cuda family "
        f"{out['cuda_s']:.2f} s")
    records = walk_cuda.record_capacity(MAIN_PARTICLES, peak["segments"])
    a = M.family_analytic(
        "trace_packed", n=MAIN_PARTICLES, ntet=mesh.ntet,
        n_groups=MAIN_GROUPS, itemsize=4, table_bytes=M.mesh_bytes(mesh),
        records=records)
    findings += M.check_peak_cuda(peak["bytes"], a)
    out["peak"] = dict(bytes=peak["bytes"], allowance=M.allowance_bytes(a),
                       analytic=a)
    log(f"[contracts] cost.peak.cuda: phase 4's max_memory_allocated "
        f"{peak['bytes']} B against the allowance {M.allowance_bytes(a)} B "
        f"(flux {a['flux_bytes']}, lanes {a['lane_bytes']}, tables "
        f"{a['table_bytes']}, records {a['record_bytes']} for {records} "
        "records)")
    ours = [e for e in entries if e["rule"] in ("CONTRACT", "COST")]
    kept, suppressed, _ = apply_baseline(findings, ours)
    for f in suppressed:
        log(f"[contracts] baselined: {f.render()}")
    if kept:
        raise AssertionError("contract findings:\n" + "\n".join(
            f.render() for f in kept))
    out["instantiations"], out["spills"], out["f64"] = len(insts), spills, f64
    return out


def _probe_entry(p: dict, launches) -> dict:
    """The measured numbers of one probe entry, in ms."""
    lib = p["library_usec_per_call"]
    return {
        "launches": launches, "max_abs_err": p["max_abs_err"],
        "ms": p["usec_per_call"] / 1e3,
        "plain_ms": p["plain_usec_per_call"] / 1e3,
        "bound_ms": p["bound_usec"] / 1e3, "bound_by": "bytes",
        "library_ms": None if lib is None else lib / 1e3,
        "library": p["library"], "shape": p["shape"],
    }


def _probe_kernel(payload, probe: str, launches: int, name: str,
                  source: str, replaces: str) -> dict:
    """A ``kernels`` entry from the probe's walk-shape run of ``probe``
    (its last entry of that kind)."""
    p = [q for q in payload["probes"] if q["probe"] == probe][-1]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, **_probe_entry(p, launches)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {name} | host: {os.cpu_count()} CPUs, "
        f"torch threads {torch.get_num_threads()}")

    # Phase 21's cold server process starts here, its nvcc build beside
    # the smoke's own; the build phase waits for it to end.
    serve_dir = tempfile.mkdtemp(prefix="pumi_serve_")
    servers = ServerProcesses(serve_dir)
    servers.start("cold")
    try:
        return _phases(card, name, t_start, servers, serve_dir)
    finally:
        servers.stop()
        import shutil

        shutil.rmtree(serve_dir, ignore_errors=True)


def _phases(card: str, name: str, t_start: float,
            servers: ServerProcesses, serve_dir: str) -> int:
    """The build, phases 3-26 and the closing lines."""
    from pumiumtally_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_many(SOURCES)
    LIBS[:] = libs
    log(f"[build] csrc/{{{','.join(SOURCES)}}}.cu, built together, in "
        f"{time.perf_counter() - t0:.2f} s")
    from pumiumtally_tpu_torch.analysis.costmodel import ptxas_lines

    for lib in libs:  # ptxas's registers, shared memory and spills
        for inst, rec in ptxas_records(lib).items():
            for line in ptxas_lines(rec):
                log(f"[build] {os.path.basename(lib)} {inst}: {line}")

    check_sass(libs)
    t0 = time.perf_counter()
    servers.finish("cold")
    log(f"[build] waited {time.perf_counter() - t0:.2f} s for phase 21's "
        f"cold server process, so that no timed phase shares the card "
        f"with it")

    t0 = time.perf_counter()
    phase_kernel_vs_plain_small()
    log(f"[phase] kernel vs plain (20^3 box): "
        f"{time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tally, snaps, launches = phase_main_path(tmpdir)
        log(f"[phase] main path: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_kernel_vs_plain_full(tally, snaps["initial"], initial=True)
    k = phase_kernel_vs_plain_full(tally, snaps["move"], initial=False)
    sched = phase_schedule(tally, snaps)
    log(f"[phase] kernel vs plain (main-path shapes): "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    repro = phase_reproducible(tally, snaps["move"], k)
    phase_overflow(tally, snaps["move"], repro["flux"])
    log(f"[phase] reproducibility and overflow: "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    payload, probe_launches = phase_probe(tally, snaps["move"], k["records"])
    atomic_f64 = probe_atomic_f64(k["records"], tally.flux.numel() // 2)
    gather_f64 = probe_gather_f64()
    log(f"[phase] probe path: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_point_source(tally)
    log(f"[phase] point source: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    io = phase_io(tally.mesh)
    log(f"[phase] move-loop I/O: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    pipe = phase_pipeline(tally.mesh)
    log(f"[phase] pipeline: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    stats = phase_run_statistics(tally.mesh)
    log(f"[phase] run statistics: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    tails = phase_feature_tails(tally.mesh)
    log(f"[phase] feature tails: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    mega = phase_megastep(tally.mesh)
    log(f"[phase] megastep: {time.perf_counter() - t0:.2f} s")
    full, flight = mega["full"][MEGA_K], mega["full"][MEGA_K]["flight"]

    t0 = time.perf_counter()
    resil = phase_resilience(tally.mesh)
    log(f"[phase] integrity and resilience: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        part = phase_partitioned(tally, snaps, tmpdir)
    log(f"[phase] partitioned tally: {time.perf_counter() - t0:.2f} s")
    b1, pfull = part["b1"], part["full"]

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        pmega = phase_partitioned_megastep(tally.mesh, tmpdir)
    log(f"[phase] partitioned source loop: {time.perf_counter() - t0:.2f} s")
    pcount = pmega["counted"]["counts"]

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        ranks = phase_ranks(
            tally.mesh, (pfull["launches"]["walk_partitioned"],
                         pfull["waits"]),
            (pcount["walk_partitioned"], pmega["counted"]["waits"]),
            pfull["fault_free"], tmpdir)
    log(f"[phase] partitioned tally across ranks: "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    debug = phase_debug(tally, snaps, part)
    log(f"[phase] partitioned debug surfaces and megastep over ranks: "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        tune = phase_tuning(tally, snaps, tmpdir)
    log(f"[phase] tuning: {time.perf_counter() - t0:.2f} s")
    widths, tuned = tune["widths"], tune["tuned"]

    t0 = time.perf_counter()
    serve = phase_serving(tally.mesh, servers, serve_dir)
    log(f"[phase] serving: {time.perf_counter() - t0:.2f} s")
    served = serve["full"]["launches"]

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        fleet = phase_fleet(tally.mesh, serve.pop("bits"), tmpdir)
    log(f"[phase] serving fleet: {time.perf_counter() - t0:.2f} s")
    fleeted = fleet["full"]["launches"]

    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        capi_run = phase_capi(snaps.pop("run"), tmpdir)
        log(f"[phase] C ABI: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        phase_chaos(capi_run["hosts"], capi_run["demo_mesh"], servers.bank,
                    tmpdir)
        log(f"[phase] chaos drivers and demo host: "
            f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    start_sass_census()
    syncs = phase_host_syncs(tally)
    log(f"[phase] host syncs: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_contracts(tally.mesh, snaps["peak"], servers.bank)
    log(f"[phase] contracts: {time.perf_counter() - t0:.2f} s")

    walk = {
        "route": "cuda",
        "source": "pumiumtally_tpu_torch/csrc/walk.cu",
        "replaces": "pumiumtally_tpu/ops/walk_pallas.py:730",
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,
    }
    kernels = [
        {"name": "walk_cuda.trace", **walk, "launches": launches["walk"],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "walk_ms": k["walk_ms"], "scatter_ms": k["scatter_ms"],
         "atomic_ms": k["atomic_ms"], "active_share": k["share"],
         "launch_order_share": k["launch_order_share"],
         "slot_order_ms": k["slot_order_ms"],
         "launch_order_ms": k["launch_order_ms"],
         "io_launches": {m: r["launches"]["walk"] for m, r in io.items()},
         "pipeline_launches": {d: pipe[f"depth{d}_launches"]["walk"]
                               for d in (1, 2)},
         "runstats_launches": stats["launches"]["walk"],
         "runstats_relaunches": stats["launches"]["walk_relaunches"],
         "rewalk_walk_ms": stats["rewalk_walk_ms"],
         "rewalk_scatter_ms": stats["rewalk_scatter_ms"],
         "feature_launches": {
             f: {"walk": c["walk"], "feature_walk": c["walk_features"]}
             for f, c in tails["launches"].items()},
         "feature_launches_by_layout": {
             "packed": tails["launches"]["xpoints"]["walk_features"],
             "unpacked": debug["a"]["launches"],
             "partitioned": debug["b"]["launches"]},
         "xpoints_ms": tails["xpoints_ms"],
         "xpoints_max_abs_err": tails["xpoints_err"],
         "checks_ms": tails["checks_ms"], "sort_ms": tails["sort_ms"],
         "lane_place_sorted_ms": tails["place_sorted_ms"],
         "lane_place_unsorted_ms": tails["place_unsorted_ms"],
         "megastep_launches": full["counts"]["walk"],
         "megastep_relaunches": full["counts"]["walk_relaunches"],
         "resil_launches": resil["launches"]["walk"],
         "resil_relaunches": resil["launches"]["walk_relaunches"],
         "serving_launches": served["walk"],
         "serving_relaunches": served["walk_relaunches"],
         "fleet_launches": fleeted["walk"],
         "fleet_relaunches": fleeted["walk_relaunches"],
         "integrity_vector_ms": resil["a"]["vec_ms"],
         "integrity_vector_bound_ms": resil["a"]["bound_ms"],
         "capi_host_move_s": capi_run["c_move_s"],
         "capi_inprocess_move_s": capi_run["python_move_s"],
         "capi_launches": "not counted: phase 23's C host launches the "
                          "walk in a process of its own"},
        {"name": "walk_cuda.trace(tally='atomic')", **walk,
         "launches": repro["launches"], "max_abs_err": repro["max_abs_err"],
         "ms": k["atomic_ms"]},
        dict(_probe_kernel(payload, "gather", probe_launches["gather"],
                           "gather.gather_rows",
                           "pumiumtally_tpu_torch/csrc/gather.cu",
                           "scripts/probe_pallas_gather.py:76"),
             jax_probe_ms=payload["probes"][0]["usec_per_call"] / 1e3,
             f64=_probe_entry(gather_f64, gather_f64["launches"])),
        dict(_probe_kernel(payload, "scatter_atomic",
                           probe_launches["scatter_atomic"],
                           "scatter.scatter_atomic",
                           "pumiumtally_tpu_torch/csrc/scatter.cu",
                           "scripts/probe_pallas_gather.py:211"),
             f64=_probe_entry(atomic_f64, None)),
        dict(_probe_kernel(payload, "scatter_ordered",
                           launches["scatter_ordered"],
                           "scatter.scatter_ordered",
                           "pumiumtally_tpu_torch/csrc/scatter.cu",
                           "scripts/probe_pallas_gather.py:211"),
             bucket_launches=launches["scatter_bucket"],
             crowded_launches=launches["scatter_crowded"],
             move1_bucket_ms=k["scatter_ms"], move1_crowded_ms=k["crowded_ms"],
             move1_library_ms=k["library_ms"], buckets=k["buckets"],
             io_bucket_launches={m: r["launches"]["scatter_bucket"]
                                 for m, r in io.items()},
             pipeline_bucket_launches={
                 d: pipe[f"depth{d}_launches"]["scatter_bucket"]
                 for d in (1, 2)},
             runstats_launches=stats["launches"]["scatter_ordered"],
             runstats_bucket_launches=stats["launches"]["scatter_bucket"],
             resil_bucket_launches=resil["launches"]["scatter_bucket"],
             serving_bucket_launches=served["scatter_bucket"],
             fleet_bucket_launches=fleeted["scatter_bucket"],
             pmega_launches=pcount["scatter_ordered"]),
        {"name": "walk_cuda.lane_records", "route": "cuda",
         "source": "pumiumtally_tpu_torch/csrc/walk.cu",
         "replaces": "pumiumtally_tpu/ops/walk_pallas.py:730",
         "launches": launches["schedule"],
         "max_abs_err": sched["move 1"]["max_abs_err"],
         "ms": sched["move 1"]["device_ms"],
         "span_ms": sched["move 1"]["span_ms"],
         "plain_ms": sched["move 1"]["plain_ms"],
         "bound_ms": sched["move 1"]["bound_ms"], "bound_by": "bytes",
         "library_ms": sched["move 1"]["library_ms"],
         "library": "torch.argsort", "kernels": sched["move 1"]["kernels"],
         "initial_search": sched["initial search"],
         "resil_launches": resil["launches"]["schedule"],
         "serving_launches": served["schedule"],
         "fleet_launches": fleeted["schedule"]},
        {"name": "source_cuda.sample_flight", "route": "cuda",
         "source": "pumiumtally_tpu_torch/csrc/source.cu",
         "replaces": "pumiumtally_tpu/ops/source.py:179 (XLA)",
         "launches": full["counts"]["source"],
         "max_abs_err": flight["max_abs_err"], "ms": flight["ms"],
         "plain_ms": flight["plain_ms"], "bound_ms": flight["bound_ms"],
         "bound_by": flight["bound_by"], "library_ms": None,
         "dest_differ": flight["dest_differ"], "max_ulp": flight["max_ulp"],
         "megastep_segments_per_s": full["segments_per_s"],
         "megastep_moves_per_s": full["moves_per_s"],
         "megastep_busy_share": full["busy"]["share"],
         "transport_moves_per_s": [
             r["moves_per_s"] for r in mega["transport"]["megastep"]],
         "resil_launches": resil["launches"]["source"],
         "serving_launches": served["source"],
         "fleet_launches": fleeted["source"],
         "stacked_launches": pcount["source"],
         "stacked_max_abs_err": pmega["stacked"]["max_abs_err"],
         "stacked_ms": pmega["stacked"]["ms"],
         "stacked_plain_ms": pmega["stacked"]["plain_ms"],
         "stacked_bound_ms": pmega["stacked"]["bound_ms"],
         "stacked_bound_by": pmega["stacked"]["bound_by"],
         "single_again_ms": pmega["single"]["ms"],
         "single_again_max_abs_err": pmega["single"]["max_abs_err"]},
        {"name": "walk_cuda.trace (unpacked layout)", "route": "cuda",
         "source": "pumiumtally_tpu_torch/csrc/walk.cu",
         "replaces": "pumiumtally_tpu/ops/walk.py:823 (XLA four-gather "
                     "fallback of trace_impl)",
         "launches": b1["launches"], "max_abs_err": b1["max_abs_err"],
         "ms": b1["ms"], "packed_ms": b1["packed_ms"],
         "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"],
         "bound_by": b1["bound_by"], "library_ms": None,
         "feature_launches": debug["a"]["launches"],
         "features_ms": debug["a"]["on_ms"],
         "features_off_ms": debug["a"]["off_ms"],
         "features_plain_ms": debug["a"]["plain_ms"],
         "features_bound_ms": debug["a"]["bound_ms"],
         "features_bound_by": debug["a"]["bound_by"],
         "features_max_abs_err": debug["a"]["max_abs_err"]},
        {"name": "walk_cuda.walk_rows (partitioned layout)", "route": "cuda",
         "source": "pumiumtally_tpu_torch/csrc/walk.cu",
         "replaces": "pumiumtally_tpu/ops/walk_partitioned.py:186 (XLA "
                     "_walk_phase)",
         "launches": pfull["launches"]["walk_partitioned"],
         "max_abs_err": max(part["b8"]["max_abs_err"], pfull["max_abs_err"]),
         "ms": pfull["ms"], "plain_ms": pfull["plain_ms"],
         "bound_ms": pfull["bound_ms"], "bound_by": pfull["bound_by"],
         "library_ms": None, "round_waits": pfull["waits"],
         "rounds": pfull["rounds"], "relaunches": pfull["relaunches"],
         "segments_per_s": pfull["segments_per_s"],
         "pumitally_segments_per_s": pfull["single_segments_per_s"],
         "busy_share": pfull["busy"]["share"],
         "peak_device_bytes": pfull["peak"],
         "megastep_launches": pcount["walk_partitioned"],
         "megastep_relaunches": pcount["walk_relaunches"],
         "megastep_round_waits": pmega["counted"]["waits"],
         "megastep_segments_per_s": pmega["segments_per_s"],
         "megastep_moves_per_s": pmega["moves_per_s"],
         "megastep_move_ms": pmega["move_ms"],
         "megastep_restage_ms": pmega["stage_ms"],
         "megastep_busy_share": pmega["busy"]["share"],
         "megastep_peak_device_bytes": pmega["counted"]["peak"],
         "budget_mc16_relaunches": ranks["budget"]["relaunches"],
         "budget_mc16_fresh_lanes": ranks["budget"]["lanes"],
         "nccl_exchange_ms": ranks["nccl"]["exchange_ms"]["nccl"],
         "stacked_exchange_ms": ranks["nccl"]["exchange_ms"]["stacked"],
         "nccl_peak_device_bytes": ranks["nccl"]["peak"]["nccl"],
         "stacked_peak_device_bytes": ranks["nccl"]["peak"]["stacked"],
         "chip_loss_recovery_s": ranks["elastic"]["recovery_s"],
         "depletion_step_s": ranks["depletion"]["step_s"],
         "feature_launches": debug["b"]["launches"],
         "xpoints_phase_ms": debug["b"]["on_ms"],
         "xpoints_phase_off_ms": debug["b"]["off_ms"],
         "xpoints_phase_bound_ms": debug["b"]["bound_ms"],
         "xpoints_phase_bound_by": debug["b"]["bound_by"],
         "xpoints_max_abs_err_vs_pumitally": debug["b"]["pts_err"],
         "xpoints_send_buffer_bytes": debug["b"]["send_on"],
         "send_buffer_bytes": debug["b"]["send_off"],
         "xpoints_peak_device_bytes": debug["b"]["peak"],
         "megastep_nccl_chunk_s": debug["c"]["ranks_s"],
         "megastep_stacked_chunk_s": debug["c"]["stacked_s"]},
    ]
    pex = pfull["exchange"]
    kernels += [
        {"name": "exchange_cuda (bucket + adopt, a round)", "route": "cuda",
         "source": "pumiumtally_tpu_torch/csrc/exchange.cu",
         "replaces": "pumiumtally_tpu/ops/walk_partitioned.py:788-934 "
                     "(XLA exchange)",
         "launches": pfull["launches"]["exchange_bucket"],
         "adopt_launches": pfull["launches"]["exchange_adopt"],
         "max_abs_err": pex["max_abs_err"],
         "ms": pex["ms"], "plain_ms": pex["plain_ms"],
         "bound_ms": pex["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "round_turns": pex["turns"],
         "round_sent": pex["sent"], "round_adopted": pex["adopted"],
         "span_ms_a_round_min_median_max": pfull["exchange_span_ms"],
         "send_buffer_bytes": pex["send_bytes"],
         "xpoints_send_buffer_bytes":
             debug["b"]["exchange_points"]["send_bytes"],
         "megastep_launches": pcount["exchange_bucket"],
         "megastep_exchange_ms_a_move": pmega["counted"]["exchange_ms"],
         "megastep_move_ms": pmega["counted"]["move_ms"],
         "nccl_exchange_ms": ranks["nccl"]["exchange_ms"]["nccl"],
         "stacked_exchange_ms": ranks["nccl"]["exchange_ms"]["stacked"],
         "host_sync_move_rounds": syncs["exchanged"]},
        {"name": "integrity_cuda.integrity_vector", "route": "cuda",
         "source": "pumiumtally_tpu_torch/csrc/integrity.cu",
         "replaces": "pumiumtally_tpu/ops/walk.py:274 (XLA)",
         "launches": resil["a"]["launches"],
         "max_abs_err": resil["a"]["max_abs_err"],
         "ms": resil["a"]["vec_ms"], "plain_ms": resil["a"]["plain_ms"],
         "bound_ms": resil["a"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "turns": resil["a"]["vec_turns"],
         "megastep_launches_a_chunk": resil["e"]["launches"]},
    ]
    for b in WIDE_BLOCKS:
        kernels.append({
            "name": f"walk_cuda.trace(block={b})", **walk,
            "launches": tuned["launches"][b],
            "max_abs_err": widths["max_abs_err"], "ms": widths["ms"][b],
            "block_128_ms": widths["ms"][128],
            "resident_threads": widths["resident"][b],
            "facade_launches": {name: c[b] for name, c in
                                tuned["facade_launches"].items()}})
    for kern in kernels:
        if not kern["launches"]:
            raise AssertionError(f"{kern['name']} was not launched on its path")
    log(f"[phase] total: {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
