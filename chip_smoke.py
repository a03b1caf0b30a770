#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA GPU, and check them.

    python3 chip_smoke.py [--seed N]

1. Prints the environment: PyTorch and its CUDA, the card, its power limit
   (nvidia-smi) and nvcc.
2. Builds the kernels from ``grayscott_tpu_torch/csrc/`` into the build
   store (``$GRAYSCOTT_CACHE_DIR/kernels``: the script's temporary store)
   and prints the build time, ptxas's report, each K1,
   K2, K3, K7, K9, K4, K5 and K6 instantiation's registers, spills and
   static shared memory, K2's ring kernels' and K7's read-site kernels'
   among them (a spill in K2, K4, K6 or K7 fails the run), K4's
   and K6's dynamic shared memory, how many of K1's, K2's, K3's, K4's,
   K5's, K6's and K9's tiles are interior tiles, and K7's per shard on each
   mesh, for both of its tile geometries.
3. Holds each kernel against its plain PyTorch version on the card at
   1080x1920, 1000x1917 (ragged against the tiles; rows not 16-byte
   aligned) and 4096x4096, both boundaries: K1 (windowed) at 1 and 8 steps
   a launch and 32 steps through the backend, K3 (resident) at 1, 27 and 32
   steps in one launch, K2 (mega) at 8, 27 and 32 steps through the
   backend (one time block; three and a remainder launch; four) and at 8
   steps against K1. K1, K2 and K3 also at 1001x1920 and 40x40 (no
   interior tile), and with the other three stencils and dt = 0.5 at every
   shape but 4096x4096; and bit for bit on states that hold NaN and +-Inf.
   K2 also with each part of its design taken out (its 32x32 geometry and
   the first stepper's kernel among them) at every shape, and with grids
   pinned to 1 and 7 blocks.
4. Runs the default ``simulate`` run (1080x1920, naive boundary,
   Oono-Puri, float32) through ``cli.simulate.run`` for 16 images of 32
   steps on the engine that ``auto`` picks (the shipped autotune record's:
   the script points ``GRAYSCOTT_CACHE_DIR`` at an empty store first, so no
   store on the machine steers a phase), then with ``--pallas-engine
   windowed``, ``--pallas-resident on`` and ``--pallas-engine mega``. Each
   run starts with every launch count at 0 and reads them after; every
   frame is held against a replay of the plain version. Then a small
   domain against the plain version on the CPU, and ``simulate.main``
   writing HDF5 when h5py is installed. Phase 4c times these runs again in
   turns, with the packed and sharded ones (K7's and the windowed
   engine's of phase 10b), and the default and packed
   runs also with the snapshot copy on the launch stream
   (``simulate.run``'s part 0, its first form).
5. Runs the bench path at full size: ``bench.headline.measure`` for the
   4096x4096 x 1000-step zero and naive rows on what ``auto`` runs (a
   shipped record may pack the zero row), then
   one fresh 1000-step run on the mega engine for each boundary, held
   against a 1000-step plain replay on the card, its time beside its bound
   and the headline row's.
6. Times each engine at 1080x1920 and 4096x4096 for both boundaries (the
   times the engine choice ``backends.cuda.auto_engine`` is set from); K1,
   K2, K3 and K9 at split 1 (on the Hopper tile stepper) in turns with
   K2's first-stepper kernel and K9's first form at split 1 (K3's former
   code shape), 32 steps each, and with each part of their design taken
   out, and K1's and K3's plain versions;
   and the snapshot copy of the main path; each beside the card's bound
   for the same work.
7. The species-packed path (``--pallas-pack on``, zero boundary) at the
   shapes of phase 3's K1-K3: K4 (packed windowed: one launch of 1 and 8
   steps, 32 steps through the backend), K5 (packed resident: one launch
   of 1, 8, 27 and 32 steps) and K6 (packed mega: 1, 8, 27 and 32 steps
   through the backend and in one launch) against the plain packed version
   on the card; all three (on the packed Hopper stepper) also with each
   part of their design taken out (their first forms among them), K5 and
   K6 on grids pinned to 1 and 7 blocks; all three with the other separable
   stencils and dt = 0.5 at every shape but 4096x4096, and bit for bit on
   states that hold NaN and +-Inf; ``simulate --boundary zero
   --pallas-pack on`` on ``auto`` and each pin (every frame against the
   plain packed replay, and against the unpacked zero run on K1: within
   2e-6 after the first image and 1e-4 after the last), the 70x97 domain
   against the CPU; one 4096x4096 x
   1000-step run on the packed ``auto`` engine against a plain replay;
   each packed engine timed beside K1 and K2 on the zero boundary (the
   times ``backends.cuda.auto_packed_engine`` is set from); K4, K5 and K6
   in turns with their first forms, and K1, K2 and K3 on the zero
   boundary, 32 steps each, and with each part of their design taken out;
   and each packed kernel's plain version.
8. Prints the nvidia-smi line, one JSON line on the nine kernels (K1's
   with its shard entry's launches and time), and last the JSON line
   ``{"ok": true, "device": {...}}``.
9. The two microbenchmarks' kernels. K8 (``ops/oplat.py``, the chain of
   dependent operations) against its plain version at 1088x1920 and
   2176x3840, 4 steps of 15 and 45 ops, with and without rolls, on inputs
   in [0.5, 2), and at the entry point's call (1088x1920, 256 steps of 90
   ops, both forms; on ones too, without rolls, as it is timed); K9
   (``ops/ilpsplit.py``, the row-split resident step, on the Hopper tile
   stepper) against its plain version on the same slabs and against K3, at
   the five shapes of phase 3, both boundaries, split 1, 2, 4 and 8 (as
   far as the tile rows allow), 1, 27 and 32 steps in one launch, each
   part of its design taken out (its first form among them), and bit for
   bit on states that hold NaN and +-Inf. Then their entry points' sweeps,
   each with
   the launch counts zeroed before it and read after:
   ``scripts.oplat.sweep`` at 1088x1920, 256 steps of 15 and 90 ops, both
   forms; ``scripts.ilpsplit.sweep`` at 1080x1920 and 4096x4096, both
   boundaries, 32 steps, split 1, 2, 4 and 8 beside K3; each time beside
   the card's bound.
10. The sharded megakernel K7 (``ops/sharded_mega.py``; all shards on the
   one card, one launch). On both tile geometries, launch by launch as the
   backend makes them, against its plain version on the card and against
   K2: 1080x1920 and 1000x1917 on meshes 1x1, 2x1, 4x1 and 2x2 at 8, 27
   and 32 steps, 1001x1920 (its last shards partly past the domain) on 4x1
   and 2x2 at 27, 4096x4096 on 4x1 and 2x2 at 32, both boundaries; through
   the backend (the geometry it picks) at 27 steps on each; the other
   stencils, dt = 0.5 and NaN and +-Inf states on 2x2 at 1080x1920. ``simulate --backend sharded --sharded-engine
   mega --sharded-devices 4`` on the default run (16 images of 32 steps),
   on the default mesh (2x2 at this shape) and with ``--sharded-mesh-cols
   1`` and ``2``, each with the launch counts zeroed before it (16 K7
   launches and no other) and every frame against the plain replay of the
   unsharded run. K7's 32-step launch on 1x1, 4x1 and 2x2, on both tile
   geometries, timed in turns with K2 and K2's first-stepper kernel at
   1080x1920 and 4096x4096, both boundaries, beside its bound; the
   backend's call (exchange and launch); each mesh's tile counts and
   rounds; the plain version once. Then the windowed sharded engine, K1's
   shard entry (``ops/windowed.py:shard_multistep``): (a) launch by launch
   as the backend makes them (the exchange of the current slot, then one
   launch of every tile, or the overlap-interior launch and the edge
   launch), against its plain version on the card, against unsharded K1
   and split against serialized, all at 0.0: 1080x1920 and 1000x1917 on
   meshes 1x1, 4x1, 2x2 and 1x4 at 8, 27 and 32 steps, 1001x1920 on each
   at 27, 4096x4096 on 4x1 and 2x2 at 32, both boundaries; through the
   backend with overlap off and on (the copy stream) at the first of those
   counts; the other stencils and dt = 0.5 on 2x2, and NaN and +-Inf
   states (at the seams of every mesh) on each mesh, bit for bit. (b)
   ``simulate --backend sharded --sharded-devices 4`` on the default run
   with no engine pin (the shipped sharded record's engine, mesh and
   overlap), with ``--sharded-engine windowed`` and with
   ``--sharded-overlap on``, each on the default mesh and with
   ``--sharded-mesh-cols 1`` and ``2``: the launch counts zeroed before
   each, 4 shard launches an image (8 where the split engages) and no
   other kernel, every frame the plain replay of the unsharded run. (c)
   The windowed call (exchange and launches, 32 steps) with overlap off
   and on, in turns with K7 and with unsharded K1 on each mesh at
   1080x1920 and 4096x4096, both boundaries, and one launch of the shard
   entry beside one of K1, each beside its bound.
11. The plain rungs of the ladder and the rest of ``simulate``. Each rung
   (``naive``, ``regular``, ``fused``, ``conv``) through ``simulate.run``
   on the default run (1080x1920, 32 steps an image) for 4 images, both
   boundaries, beside the ``cuda`` backend on ``auto``, each with the
   launch counts zeroed before it and read after (a rung launches none of
   the nine kernels): naive's frames bit for bit the cuda backend's, fused
   bit for bit regular (the same operations, replayed from a CUDA graph),
   regular, fused and conv within 1e-4 of naive after the last image (the
   cuda run unpacked, ``--pallas-pack off``); conv
   on the card within 1e-5 of conv on the CPU at 70x97 after 32 steps (TF32
   left on would miss it). A run of 8 images, then ``uv_host``,
   ``build_storage`` and 8 more, against 16 straight at 0.0 (the in-memory
   part of ``--resume`` and ``--checkpoint``) on ``cuda`` ``auto``,
   ``--pallas-pack on`` (zero boundary), ``sharded`` 2x2 on K7 and on
   the windowed engine with overlap on, and ``fused``;
   ``--snapshot-dtype bfloat16`` frames on ``auto`` against the float32
   frames rounded through bf16, bit for bit. Then the ladder table: each
   rung and ``cuda`` ``auto``, ms an image in turns
   (``bench/ladder.py:ladder_ms``).
12. The autotuner (``bench/autotune.py``): ``autotune(persist=True)`` into
   a store of its own on the four configurations whose records
   ``bench/defaults.py`` ships (1080x1920 and 4096x4096, naive and zero),
   every candidate run (K1, K2, K3, K1 at K = 16 and on 32x128 and
   128x32 tiles; on zero also K4, K6, K5, K4 at K = 16 and on 32-row
   tiles), each winner
   beside its shipped record and the candidates' times; a shipped record
   that names no candidate of its key, or whose engine trails the winner
   by 3 % or more, fails. Then ``simulate.run`` with ``--autotune`` twice
   at 1080x1920 naive into a fresh store: the first call measures, the
   second measures nothing and runs the record's engine, its frames
   bitwise the plain replay. (b) The sharded tuner
   (``autotune.sharded_autotune``) at 1080x1920 naive in 4 shards: every
   candidate (each viable mesh: windowed with overlap off and on, K7), the
   winner beside the shipped record (``bench/defaults.py:SHARDED``),
   which must name a candidate and trail the winner by less than 3 %; then
   ``--autotune --backend sharded --sharded-devices 4`` twice into a fresh
   store, as above.
13. ``scripts/parity_check.py`` at its defaults (256x384, 1000 steps,
   snapshots every 100, against the ``naive`` rung on the card) on K1, K2
   and K3 on both boundaries, K4, K6 and K5 on the zero boundary, and on
   ``fused`` and ``conv``: its 1e-3 rule, every kernel launched, the
   unpacked engines within PARITY.md's 6.1e-6; each max|dV| a snapshot.
14. ``livesim`` on the card at 1080x1920 (``cli/livesim.py``). (a) The
   headless dump ``--frames 8 -e 32`` on ``auto`` (K3 by the shipped
   record) at depths 1 and 3, and with ``--boundary zero --pallas-pack
   on`` (K6) at depth 3, each with the launch counts zeroed before it and
   read after (one launch a frame): 8 PNGs each, the depths' files
   identical, every picture the palette of the plain replay's indices on
   the card; the host's PNG encode of one frame, timed. (b) The web view
   served from a thread on a free localhost port: ``/state``,
   ``/palette.bin``, two ``/frame.bin`` against the plain replay's
   indices, ``/set?feedrate=`` with the state carried over, then the
   server shut down. (c) ``scripts/livesim_fps.py`` at depths 1-4, 1 and
   32 steps a frame, and the index pass and one frame's device-to-host
   copy by CUDA events. (d) ``GRAYSCOTT_DEBUG``: a diverging run raises
   ``FloatingPointError``, and the default run with the checks on and off
   in turns; a ``utils/profiling.py:trace`` of two images on the card
   (``bench/ladder.py:profile_images``). (e) One build of the kernel
   library and of the native colorizer and PNG encoder into a fresh
   ``GRAYSCOTT_CACHE_DIR``, timed; (f) which PNG encoder runs, and g++'s
   version. The ``kernels`` line gives K3 and K6 their ``livesim_launches``.
15. bf16 storage (``--pallas-dtype bfloat16``): the bf16 entries of K1,
   K1's shard entry, K2 and K7. (a) Each through its backend (the shard
   entry and K7 on 2x2) against ``stencil.run_bf16`` on the card after 1,
   8 and 12 steps, at 1080x1920, 4096x4096 and 1000x1924 (rows of 16
   bytes in float32 but not in bf16), both boundaries, and on a NaN/Inf
   state: bit for bit, NaN's bit pattern aside. (b) K1's shard entry,
   overlap off and on, against K1, and K7 against K2, on 1x1, 4x1, 2x2
   and 1x4, random and NaN/Inf states. (c) ``simulate.run`` with
   ``--pallas-dtype bfloat16``, 16 images x 32 steps at 1080x1920 naive,
   on ``auto`` (K1), each engine pinned and 4 shards (windowed, and K7),
   launch counts zeroed before each and read after, every frame the plain
   bf16 replay's; then timed in turns with the float32 runs. (d) Each bf16
   entry in turns with its float32 entry (CUDA events) at 1080x1920 and
   4096x4096, both boundaries, beside its bound at 8 B a cell; K1 also at
   16384x16384, against its plain version too. (e) One 32-step K1 call at
   32768x32768 in float32 and in bf16: ``max_memory_allocated`` and its
   time. The ``kernels`` line gains the four bf16 entries.
16. The folded naive reaction (``--pallas-naive-fold on``): the fold
   entries of K1 and K2, float32 and bf16. (a) Each against its plain
   version (``stencil.run_naive_fold``, ``run_naive_fold_bf16``) on the
   card: K1 one launch of 1 and of 8 steps, K2 one launch of 4 time blocks
   of 8, at 1080x1920, 4096x4096 and 1000x1917, the default stencil at
   each, every other stencil and dt = 0.5 at 1000x1917, and a NaN/Inf
   state at 1080x1920: float32 bit for bit, bf16 bit for bit NaN's bit
   pattern aside. (b) The drift of the fold from the exact naive kernel
   (K1), max|dV| after 32 and 1000 steps at 256x384 from the default
   state, within JAX's budgets of 3e-6 and 1e-4. (c) ``simulate.run``
   with ``--pallas-naive-fold on`` (``auto``: K1), with ``--pallas-engine
   mega``, and both on bf16 storage, launch counts zeroed before each and
   read after (K1 4 an image, K2 1, no K3 and no exact entry), every
   frame bit for bit the plain fold's replay; then timed in phase 4c's
   turns beside the default run. (d) Each fold entry in turns with the
   exact naive entry and the zero entry of the same engine and storage
   (CUDA events): K1 one launch of 8 steps, K2 one of 4 time blocks of 8,
   at 1080x1920 and 4096x4096, beside its bound at the fold's operation
   count (``fold_ops_per_cell_step``), and the plain version's time at
   1080x1920. The ``kernels`` line gains the four fold entries. The
   entries run the fold's second form (``csrc/gs_fold_sm90.cuh``: 2-D
   register blocks; float32 windows through TMA where ``geometry.tma_ok``
   allows, so 1080x1920 and 4096x4096 load through TMA and 1000x1917 with
   cp.async, each checked and counted in ``fold_tma_launches``); (a) also
   holds every part of the split (``windowed.fold_ablation``,
   ``megakernel.fold_ablation``: the first form, part 0, among them) bit
   for bit against its plain version at each shape and on the NaN/Inf
   state. (e) The split: each part of ``FOLD_ABLATIONS`` of both entries
   in turns with the entry itself (CUDA events; K1 one launch of 8 steps,
   K2 one of 4 time blocks of 8) at 1080x1920 and 4096x4096, each beside
   part 0 and the bound.

17. The window ring (``mega_depth``, ``ops/megakernel.py:ring_geometry``)
   and K7's read-site wait. Each depth's geometry at 1080x1920 and
   4096x4096 (tile, depth after JAX's clamp, buffers, bytes, blocks an SM
   by shared memory) beside the occupancy API's blocks of K2. (a)
   Every K2 entry (float32 and bf16 on both boundaries, the fold on both
   storages) at depths 2-8, one launch of 3 time blocks of 8 steps
   at both shapes (and a NaN/Inf state at 1080x1920), bit for bit against
   the plain version and against depth 2. (b) One 32-step launch at every
   depth in turns, beside depth 2, the bound, and the plain versions. (c)
   K7 on the row meshes 4x1 and 2x1 at both shapes and boundaries (and
   NaN/Inf): the read-site wait bit for bit against the entry gate and the
   plain version, then timed in turns with the entry gate. (d)
   ``simulate.run`` at 1080x1920, 16 images of 32 steps, on
   ``CudaSimulation(engine='mega', mega_depth=4)`` on both storages, with
   and without the fold, each frame bit for bit the depth-2 run's; the
   packed K6 (zero) at depth 4, which declines the pin as JAX's
   ``packed_megastep`` does (the double buffer runs; frames bitwise to
   depth 2's); the sharded simulate on 4x1 with
   the read-site wait against the entry gate, frame for frame; launch
   counts zeroed before each and read after. The ``kernels`` line gains
   the four ring entries and K7's read-site wait.
18. The tile and depth pins of K1 and K4 (``--pallas-steps-per-call``,
   ``--pallas-block-rows``, ``--pallas-block-cols``; ``ops/geometry.py``,
   ``csrc/windowed_pins.cu``, K4's pinned entry in ``csrc/packed.cu``).
   (a) Each pinned entry of K1 (float32 and bf16 on both boundaries, the
   fold on both storages) one launch of K steps for K in 1, 3, 8, 12, 16,
   24 and 32 on the default tiles, 32x32, 8x512, 64x128, 128x32 and
   32x256, every combination whose window fits (the rest checked
   refused, past 232,448 B), at 1080x1920 (and a NaN/Inf state),
   1001x1920 and 40x40, and a subset at 4096x4096; the other stencils and
   dt = 0.5 at 1001x1920; K4 on row tiles of 8, 32 and 128 at each K:
   bit for bit the plain versions (the compiled geometry through the
   compiled entries). (b) ptxas's report of the 23 pinned instantiations
   (no spill, no stack). (c) ``simulate.run`` under ``--pallas-steps-per-call
   16`` and ``4``, ``--pallas-block-rows 32 --pallas-block-cols 128``,
   ``--pallas-pack on --pallas-steps-per-call 16`` and K = 16 on bf16, the
   fold and both: ceil(32 / K) launches an image of the entry that runs,
   the frames bit for bit the unpinned run's and the plain replay's. (d)
   K1 at each pinned depth and tile shape, 96 steps a call, in turns with
   the default geometry, and K4's pins, at 1080x1920 and 4096x4096,
   beside the bound, the halo recompute and the blocks an SM; one K = 16
   launch of each pinned entry beside the compiled K = 8 launch. (e)
   ``bench.harness`` with ``--block-rows`` and ``--steps-per-call``. Phase
   12's tuner measures K1's and K4's depth and tile candidates. The
   ``kernels`` line gains the five pinned entries.
19. The megakernels' tile pins (K2, K6, K7) and the sharded windowed
   engine's K and row tile (K1's shard entry): each pinned entry bit for
   bit its plain version on several geometries and a NaN/Inf state, the
   JAX pins the shared memory refuses counted, ptxas's report of the
   pinned instantiations, ten ``simulate.run`` paths under the pins (each
   frame the unpinned run's), each pin timed in turns with the default
   geometry. The ``kernels`` line gains the nine pinned entries.
20. Several processes (``GRAYSCOTT_COORDINATOR``, ``utils/
   distributed.py``). (a) K1's shard entries (float32 and bf16 at K = 8,
   the pinned entry at K = 16, both boundaries) on rank 1's block of 2x2,
   4x1 and 1x4 split over two processes, at its mesh offset, bit for bit
   against the plain version there. (b) The script starts itself twice
   (``--distributed-child``) as the two ranks of a gloo group on the one
   card, each driving ``simulate.run`` at 1080x1920, 8 images of 32 steps,
   on the windowed engine on 2x1 (one shard a process; naive, zero,
   bf16) and 2x2 (a mesh row a process; naive, zero, K = 16 with
   overlap): every frame of each rank bit for bit the one-process run's,
   each rank's launch counts (ceil(32 / K) an image, twice with the
   overlap split, no other kernel), a pinned K7 refused (Queue 1 item
   7.3); then ms an image of two processes against one in turns on 2x1
   and 2x2, one exchange, its bands' gloo round trip and one image's
   gather alone. A child that fails, hangs past DIST_TIMEOUT or exits
   non-zero fails the phase. The ``kernels`` line gives K1's shard
   entries their two-process launches by rank.
21. The lane fold (``--pallas-fold F``; ``ops/lane_fold.py``, K1's folded
   entry in ``csrc/windowed_pins.cu``) and the window ring at a pinned
   tile (``mega_depth`` with ``block_rows``/``block_cols``; K2's pinned
   ring entries in ``csrc/mega_pins_ring.cu``). (a) ptxas's report of the 4
   folded, 1 refresh and 24 pinned ring instantiations (no spill, no
   stack); the folded entry (its refresh, then 8 or 16 steps), at
   1080x1920 F = 2 (and a NaN/Inf state, the seam's cells among them),
   1001x1920 F = 3 (dead rows) and 4096x512 F = 8, both boundaries, bit
   for bit its plain version and the unfolded K1; each pinned ring entry
   (float32, bf16, the fold, the fold on bf16) at 32x128 depth 3, 16x64
   depths 4 and 8, 8x256 depth 3, at 1080x1920 (and NaN/Inf), bit for bit
   its plain version and the pinned double buffer, each ring's blocks
   beside the occupancy API's. (b) ``simulate.run`` with ``--pallas-fold
   2`` (naive, K = 16, zero) against the unfolded K1, and each pinned ring
   entry at depth 4 on 16-row tiles against depth 2, launch counts zeroed
   before each and read after, every frame bit for bit, then each pair in
   turns. (c) The folded launch against the unfolded K1's, the refresh
   alone and 32 steps through the backend folded and unfolded, in turns,
   at 1080x1920 F = 2, 4096x512 F = 8 and 2048x256 F = 8; each pinned ring
   against depth 2 on its tiles in turns. The ``kernels`` line gains the
   folded entry and the four pinned ring entries.
22. The window ring's redesign (K2 ring and K2 ring pinned: the ring on
   twice the double buffer's threads at 64 registers a thread, the pinned
   ring on two blocks of 512 where its bytes leave room for them). (a)
   ptxas's report of the 44 compiled and 24 pinned ring instantiations (no
   spill, no stack) and of the 27 ablation instantiations
   (``csrc/splits/mega_ring_ablation.cu``; their spills reported); the
   occupancy API's blocks of each ring below, which must equal
   ``RingGeometry.blocks_per_sm`` an SM. (b) Every part of the ring's
   split (``megakernel.RING_ABLATIONS``: the first form, its loads and
   stores alone, every window waited for, the double buffer on its tile
   and grid, each tile stepped in place, more threads or fewer registers)
   on the compiled rings at depth 3, 4 and 8 and the pinned 16x64 ring at
   depth 4, 32x128 and 8x256 at depth 3, at 1080x1920 (and NaN/Inf) and
   4096^2, one launch of 3 time blocks of 8 steps: bit for bit the plain
   version (part 2, which steps nothing: its input) and the entry. (c)
   The split: every part, the entry and depth 2 on the same tiles, one
   launch of 32 steps in device time (``queued_ms``) in turns, each beside
   part 0 and the bound. The ``kernels`` line gives the float32 ring
   entries the first form's time.
23. The redesign of K1's pinned entries (K1 pinned, K1 shard pinned: the
   second form, 4x4 register blocks with 16-byte shared loads on interior
   tiles, sizes compiled in on 64x64 and 32x64 tiles at a halo of 16;
   ``csrc/gs_pin_sm90.cuh``, ``csrc/windowed_pins.cuh``). (a) ptxas's
   report of the split's 23 instantiations
   (``csrc/splits/windowed_pins_ablation.cu``; phases 18b and 19b check the
   entries'), the occupancy API's blocks an SM of each entry's kernel
   against ``Geometry.pin_launch`` (equal) and of the cluster part
   against ``geometry.cluster_bytes``. (b) Every part of the split
   (``windowed.PIN_ABLATIONS``: the first form, 1024 threads, loads and
   stores alone, every tile an edge tile, compiled sizes, register
   blocks, 2x2 clusters over distributed shared memory, and their
   combinations) and the entry, one launch of K steps on K = 16 64x64, K
   = 24 64x64, K = 16 32x32 and K = 8 32x128 at 1080x1920 (and NaN/Inf),
   1001x1920, 40x40 and 4096^2, bit for bit the plain version (part 2:
   its input); the entry also on the zero boundary and bf16; the shard
   entry's parts and entry on 2x2, 4x1 and 1x4 at 1080x1920 (and NaN/Inf)
   and 1001x1920, K = 16 on 32-row tiles and on 64x64 with the overlap's
   two launches. (c) The split in device time, in turns with part 0 and
   the bound, at 1080x1920 and 4096^2 (the shard entry at 1080x1920 on
   2x2). The ``kernels`` line gives both entries their first form's time.
26. The redesign of K2's and K7's pinned entries (their sizes compiled in
   on the pins users and the tuner name most, ``csrc/mega_pins_fixed.cu``
   and ``csrc/sharded_mega_pins_fixed.cu``, the threads a block fitted to
   the window's bytes where that paid: 16x64 on 256, 64x128 naive on
   1024; ``geometry.mega_pin_launch`` chooses). (a) ptxas's report of the compiled entries and of the
   splits' parts (``csrc/splits/mega_pins_ablation.cu``,
   ``csrc/splits/sharded_mega_pins_ablation.cu``), none of which may spill
   or take a stack frame; the occupancy API's blocks of each compiled
   instantiation against ``mega_pin_launch``'s. (b) Every part of both
   splits (``megakernel.PINNED_ABLATIONS``,
   ``sharded_mega.PINNED_ABLATIONS``: the first form, its loads and stores
   or its exchange alone, compiled sizes, threads fitted to the bytes, both)
   and both entries on float32 and bf16, one launch of 4 time blocks of 8
   steps on the timed geometries (K2 32x128, 16x64 bf16 and 32x64 at
   1080x1920, 64x128 at 4096^2; K7 32x128 on 2x2 at 1080x1920 and 4096^2,
   64x128 bf16 on 1x4), on a NaN/Inf state, and the entries at every
   compiled geometry on 1025x1920 and 1000x1917 (K7 on 2x2, 1x4, 4x1), bit
   for bit the plain version (part 1: its input); K7's grid against
   ``sharded_mega.pinned_walk`` (two blocks an SM on 32x128 naive). (c)
   Both splits in device time, in turns, twice for their spread, each
   part beside part 0 and the bound, with the compiled 64x64 K2 and K7;
   (d) the two pins' ``simulate`` paths from phase 19c. The ``kernels``
   line gives the four pinned entries their first form's time.

Phases 3-6 run the unpacked kernels K1-K3 and phase 7 the packed ones
(in the order 3, 7a, 4, 7b, 5, 7c, 6, 7d); phases 9 to 15 run after
them, then phases 16 to 26 and phase 4c, before phase 8's lines. Every bound is the larger of
the bytes (each input read once, each output written once) over 3.35 TB/s
and the float32 operations over 33.5 T/s, the rate at which each unfused
operation takes an issue slot (the kernels build with ``-fmad=false``);
K8's fused multiply-adds count two operations at 67 TFLOP/s. Every check runs; a failed one makes the script exit 1
without the two JSON lines. With no CUDA GPU visible it exits 1 at once.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import http.client
import importlib.util
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from grayscott_tpu_torch import native
from grayscott_tpu_torch.backends import cuda as cuda_backend
from grayscott_tpu_torch.backends import get_backend
from grayscott_tpu_torch.backends.base import DEBUG_VAR
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.backends.sharded import ShardedSimulation
from grayscott_tpu_torch.bench import (autotune, defaults, headline, ladder,
                                       simulate_turns)
from grayscott_tpu_torch.cli import livesim, shared, simulate
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import (build, geometry, ilpsplit, lane_fold,
                                     megakernel, oplat,
                                     packed, resident, sharded_mega, stencil,
                                     windowed)
from grayscott_tpu_torch.parallel import halo
from grayscott_tpu_torch.params import (Parameters, fold_constants,
                                        kernel_constants, packed_constants)
from grayscott_tpu_torch.scripts import ilpsplit as ilpsplit_script
from grayscott_tpu_torch.scripts import livesim_fps
from grayscott_tpu_torch.scripts import oplat as oplat_script
from grayscott_tpu_torch.scripts import parity_check
from grayscott_tpu_torch.species import Species, initial_uv
from grayscott_tpu_torch.utils import cache
from grayscott_tpu_torch.utils import device as gpu
from grayscott_tpu_torch.utils.logs import init_logging
from grayscott_tpu_torch.utils.palette import inferno_lut

#: kernel vs plain version, max |difference|: both run the same float32
#: expression tree with every operation rounded once (nvcc -fmad=false, no
#: flush to zero), so they agree bit for bit
TOL = 0.0

#: the card; every tensor of the checks lives there
DEVICE = "cuda"
SHAPES = [(1080, 1920), (1000, 1917), (4096, 4096)]
#: phase 3's shapes for K1 and K3 (on the Hopper tile stepper): SHAPES, a
#: last tile row of one row (1001x1920), and a domain with no interior tile
#: (40x40)
REDESIGNED_SHAPES = [(1080, 1920), (1000, 1917), (1001, 1920), (4096, 4096),
                     (40, 40)]
#: the stencils other than the default, and a time step
OTHER_PARAMS = [("5points", Parameters.with_stencil("5points")),
                ("pretty", Parameters.with_stencil("pretty")),
                ("patra-karttunen",
                 Parameters.with_stencil("patra-karttunen")),
                ("dt=0.5", Parameters(time_step=0.5))]
MAIN_SHAPE = (1080, 1920)
BENCH_SHAPE = (4096, 4096)
MAIN_IMAGES, MAIN_STEPS = 16, 32
BENCH_STEPS = 1000

#: NVIDIA's data sheet for the H100 SXM at its 700 W limit: HBM3 bytes/s
#: and float32 operations/s outside the tensor cores, a fused multiply-add
#: counted as two
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
#: float32 operations/s when each add, multiply and subtract takes an issue
#: slot of its own, as in the kernels (nvcc -fmad=false): 132 SMs x 128
#: float32 lanes x 1.98 GHz
PEAK_F32_UNFUSED = 33.5e12

#: the kernels' wrapper modules, by engine
MODULES = {"windowed": windowed, "resident": resident, "mega": megakernel}

#: every kernel's launch counter, by its storage tag: (module, attribute)
COUNTERS = {
    "windowed": (windowed, "launches"),
    "resident": (resident, "launches"),
    "mega": (megakernel, "launches"),
    "packed": (packed, "launches"),
    "respack": (packed, "resident_launches"),
    "megapack": (megakernel, "packed_launches"),
    "oplat": (oplat, "launches"),
    "ilpsplit": (ilpsplit, "launches"),
    "shmega": (sharded_mega, "launches"),
    "shwin": (windowed, "shard_launches"),
    # the bf16 entries (bfloat16 storage), counted apart
    "windowed_bf16": (windowed, "bf16_launches"),
    "shwin_bf16": (windowed, "bf16_shard_launches"),
    "mega_bf16": (megakernel, "bf16_launches"),
    "shmega_bf16": (sharded_mega, "bf16_launches"),
    # the fold entries (the folded naive reaction), counted apart
    "windowed_fold": (windowed, "fold_launches"),
    "windowed_fold_bf16": (windowed, "fold_bf16_launches"),
    "mega_fold": (megakernel, "fold_launches"),
    "mega_fold_bf16": (megakernel, "fold_bf16_launches"),
    # the float32 fold launches whose windows loaded through TMA (also
    # counted in windowed_fold or mega_fold)
    "windowed_fold_tma": (windowed, "fold_tma_launches"),
    "mega_fold_tma": (megakernel, "fold_tma_launches"),
    # the window ring's entries (mega_depth), K2's, counted apart
    "mega_ring": (megakernel, "ring_launches"),
    "mega_ring_bf16": (megakernel, "ring_bf16_launches"),
    "mega_ring_fold": (megakernel, "ring_fold_launches"),
    "mega_ring_fold_bf16": (megakernel, "ring_fold_bf16_launches"),
    # K7's launches that waited at the read site (row meshes; also counted
    # in shmega or shmega_bf16)
    "shmega_read_site": (sharded_mega, "read_site_launches"),
    # the pinned entries of K1 and K4 (the tile and depth pins), counted
    # apart
    "windowed_pinned": (windowed, "pinned_launches"),
    "windowed_pinned_bf16": (windowed, "pinned_bf16_launches"),
    "windowed_pinned_fold": (windowed, "pinned_fold_launches"),
    "windowed_pinned_fold_bf16": (windowed, "pinned_fold_bf16_launches"),
    "packed_pinned": (packed, "pinned_launches"),
    # the megakernels' pinned entries (K2, K6, K7) and K1's pinned shard
    # entry (the sharded windowed engine's K and row tile), counted apart
    "mega_pinned": (megakernel, "pinned_launches"),
    "mega_pinned_bf16": (megakernel, "pinned_bf16_launches"),
    "mega_pinned_fold": (megakernel, "pinned_fold_launches"),
    "mega_pinned_fold_bf16": (megakernel, "pinned_fold_bf16_launches"),
    "megapack_pinned": (megakernel, "packed_pinned_launches"),
    "shmega_pinned": (sharded_mega, "pinned_launches"),
    "shmega_pinned_bf16": (sharded_mega, "pinned_bf16_launches"),
    "shwin_pinned": (windowed, "pinned_shard_launches"),
    "shwin_pinned_bf16": (windowed, "pinned_bf16_shard_launches"),
    # K1's folded entry (the lane fold) and K2's ring on pinned tiles,
    # counted apart
    "windowed_folded": (windowed, "folded_launches"),
    "mega_pinned_ring": (megakernel, "pinned_ring_launches"),
    "mega_pinned_ring_bf16": (megakernel, "pinned_ring_bf16_launches"),
    "mega_pinned_ring_fold": (megakernel, "pinned_ring_fold_launches"),
    "mega_pinned_ring_fold_bf16": (megakernel,
                                   "pinned_ring_fold_bf16_launches"),
}

#: storage tags that share another tag's kernel (K7 and K1's shard entry on
#: a 2-D mesh)
KERNEL_OF = {"shmega2d": "shmega", "shwin2d": "shwin"}

#: K8's shapes (the TPU script's first and largest) and K9's splits
OPLAT_SHAPES = [(1088, 1920), (2176, 3840)]
SPLITS = (1, 2, 4, 8)

#: the flags that pin each packed engine on the command line
PACKED_FLAGS = {"packed": ["--pallas-engine", "windowed"],
                "respack": ["--pallas-resident", "on"],
                "megapack": ["--pallas-engine", "mega"]}
ZERO_PACKED = ["--boundary", "zero", "--pallas-pack", "on"]

#: packed frames against the unpacked zero run on K1 at 1080x1920, max|dV|:
#: the two trees round differently (the separable pass and the linear fold
#: against the oracle's 9 taps) and drift apart by a few ulp a step, more as
#: the pattern grows. The plain versions on the CPU give 8.0e-7 after the
#: first image (32 steps) and 5.0e-5 after the last (512 steps); the limits
#: are about twice that
PACK_VS_UNPACKED_FIRST = 2e-6
PACK_VS_UNPACKED_LAST = 1e-4

KERNELS = {
    "windowed": {
        "name": "windowed_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/windowed.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:929",
    },
    "resident": {
        "name": "resident_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/resident.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:1312",
    },
    "mega": {
        "name": "mega_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81",
    },
    "packed": {
        "name": "packed_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/packed.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:1624",
    },
    "respack": {
        "name": "packed_resident_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/packed_resident.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:1745",
    },
    "megapack": {
        "name": "packed_mega_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/packed_mega.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:1112",
    },
    "oplat": {
        "name": "oplat_chain",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/oplat.cu",
        "replaces": "scripts/oplat.py:36",
    },
    "ilpsplit": {
        "name": "ilpsplit_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/ilpsplit.cu",
        "replaces": "scripts/ilpsplit.py:43",
    },
    "shmega": {
        "name": "sharded_mega_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/sharded_mega.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (sharded, "
                    "grayscott_tpu/parallel/halo.py:487)",
    },
    "windowed_bf16": {
        "name": "windowed_multistep_bf16",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/windowed.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:929 (bfloat16 "
                    "storage, :970-993)",
    },
    "shwin_bf16": {
        "name": "windowed_shard_multistep_bf16",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/windowed.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:929 (bfloat16 "
                    "storage, per shard: grayscott_tpu/parallel/"
                    "halo.py:314-316)",
    },
    "mega_bf16": {
        "name": "mega_multistep_bf16",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (bfloat16 storage, "
                    ":166-169)",
    },
    "shmega_bf16": {
        "name": "sharded_mega_multistep_bf16",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/sharded_mega_bf16.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (sharded, bfloat16 "
                    "storage; grayscott_tpu/parallel/halo.py:487)",
    },
    "windowed_fold": {
        "name": "windowed_multistep_fold",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/windowed.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:929 (fast_fold, "
                    ":363-382, :817-859)",
    },
    "windowed_fold_bf16": {
        "name": "windowed_multistep_fold_bf16",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/windowed.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:929 (fast_fold, "
                    "bfloat16 storage)",
    },
    "mega_fold": {
        "name": "mega_multistep_fold",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (fast_fold)",
    },
    "mega_fold_bf16": {
        "name": "mega_multistep_fold_bf16",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (fast_fold, "
                    "bfloat16 storage)",
    },
    "mega_ring": {
        "name": "mega_ring_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega_ring.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (depth=D, the ring "
                    ":562-630)",
    },
    "mega_ring_bf16": {
        "name": "mega_ring_multistep_bf16",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega_ring.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (depth=D, bfloat16 "
                    "storage)",
    },
    "mega_ring_fold": {
        "name": "mega_ring_multistep_fold",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega_ring.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (depth=D, "
                    "fast_fold)",
    },
    "mega_ring_fold_bf16": {
        "name": "mega_ring_multistep_fold_bf16",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega_ring.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (depth=D, "
                    "fast_fold, bfloat16 storage)",
    },
    "shmega_read_site": {
        "name": "sharded_mega_fit_multistep (read-site wait, 68x64 tiles)",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/sharded_mega_fit.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (sharded, row mesh: "
                    "the 1-D read-site waits, :428-463)",
    },
    "windowed_pinned": {
        "name": "windowed_pinned_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/windowed_pins.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:929 (tr, tc, chalo, "
                    "steps, halo: :929-999)",
    },
    "windowed_pinned_bf16": {
        "name": "windowed_pinned_multistep_bf16",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/windowed_pins.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:929 (tr, tc, steps, "
                    "halo; bfloat16 storage, :970-993)",
    },
    "windowed_pinned_fold": {
        "name": "windowed_pinned_multistep_fold",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/windowed_pins.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:929 (tr, tc, steps, "
                    "halo; fast_fold)",
    },
    "windowed_pinned_fold_bf16": {
        "name": "windowed_pinned_multistep_fold_bf16",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/windowed_pins.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:929 (tr, tc, steps, "
                    "halo; fast_fold, bfloat16 storage)",
    },
    "packed_pinned": {
        "name": "packed_pinned_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/packed.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:1624 (tr, halo, "
                    "steps)",
    },
    "mega_pinned": {
        "name": "mega_pinned_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega_pins_fixed.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (tr, tc: "
                    "grayscott_tpu/backends/pallas.py:384-411)",
    },
    "mega_pinned_bf16": {
        "name": "mega_pinned_multistep_bf16",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega_pins_fixed.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (tr, tc; bfloat16 "
                    "storage)",
    },
    "mega_pinned_fold": {
        "name": "mega_pinned_multistep_fold",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega_pins.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (tr, tc; "
                    "fast_fold)",
    },
    "mega_pinned_fold_bf16": {
        "name": "mega_pinned_multistep_fold_bf16",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega_pins.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (tr, tc; fast_fold, "
                    "bfloat16 storage)",
    },
    "megapack_pinned": {
        "name": "packed_mega_pinned_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega_pins.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:1112 (tr: "
                    "grayscott_tpu/backends/pallas.py:554-576)",
    },
    "shmega_pinned": {
        "name": "sharded_mega_pinned_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/sharded_mega_pins_fixed.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (sharded, tr, tc: "
                    "grayscott_tpu/backends/sharded.py:281-321)",
    },
    "shmega_pinned_bf16": {
        "name": "sharded_mega_pinned_multistep_bf16",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/sharded_mega_pins_fixed.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (sharded, tr, tc; "
                    "bfloat16 storage)",
    },
    "shwin_pinned": {
        "name": "windowed_shard_pinned_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/windowed_pins.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:929 (per shard at "
                    "steps, halo and tr: grayscott_tpu/parallel/"
                    "halo.py:226-317)",
    },
    "shwin_pinned_bf16": {
        "name": "windowed_shard_pinned_multistep_bf16",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/windowed_pins.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:929 (per shard at "
                    "steps, halo and tr; bfloat16 storage)",
    },
    "windowed_folded": {
        "name": "windowed_folded_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/windowed_pins_fixed.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:929 (fold=(F, Cd, "
                    "Rp): :929-933, :1123-1138; after fold_refresh, :1547)",
    },
    "mega_pinned_ring": {
        "name": "mega_pinned_ring_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega_pins.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (depth=D with tr, "
                    "tc: the ring :562-630)",
    },
    "mega_pinned_ring_bf16": {
        "name": "mega_pinned_ring_multistep_bf16",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega_pins.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (depth=D with tr, "
                    "tc; bfloat16 storage)",
    },
    "mega_pinned_ring_fold": {
        "name": "mega_pinned_ring_multistep_fold",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega_pins.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (depth=D with tr, "
                    "tc; fast_fold)",
    },
    "mega_pinned_ring_fold_bf16": {
        "name": "mega_pinned_ring_multistep_fold_bf16",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega_pins.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (depth=D with tr, "
                    "tc; fast_fold, bfloat16 storage)",
    },
}

#: K7's meshes (rows, cols), and the flags of its simulate runs: the
#: default mesh of 4 shards (2x2 at 1080x1920: halo.choose_mesh_cols), and
#: each form pinned
SHARDED_MESHES = [(1, 1), (2, 1), (4, 1), (2, 2)]
#: 1001 rows in 4 shards of 256 (or 2 of 504): the last row of shards
#: reaches past the domain
PAST_EDGE_SHAPE = (1001, 1920)
SHARDED_FLAGS = ["--backend", "sharded", "--sharded-engine", "mega",
                 "--sharded-devices", "4"]
SHARDED_PATHS = [[], ["--sharded-mesh-cols", "1"],
                 ["--sharded-mesh-cols", "2"]]

#: the windowed sharded engine (K1's shard entry): its meshes, and the
#: flags of its simulate runs (each on the default mesh and on each form
#: of SHARDED_PATHS): no engine pin (a shipped record, else windowed), the
#: engine pinned, and overlap on
WINDOWED_MESHES = [(1, 1), (4, 1), (2, 2), (1, 4)]
SHARDED_4 = ["--backend", "sharded", "--sharded-devices", "4"]
WINDOWED_FLAGS = {"auto": SHARDED_4,
                  "windowed": SHARDED_4 + ["--sharded-engine", "windowed"],
                  "overlap": SHARDED_4 + ["--sharded-overlap", "on"]}

#: phase 11: the plain rungs of the ladder, images of MAIN_STEPS steps a
#: run, and the runs split by a resume
RUNGS = ("naive", "regular", "fused", "conv")
RUNG_IMAGES = 4
RESUME_IMAGES = 8
#: the shift algebra and the convolution against the oracle's tree (the
#: naive rung) after RUNG_IMAGES images: both reassociate the stencil sum,
#: a few ulp a step; the plain rungs on the CPU stay within 1e-5 of the
#: oracle over 64 steps (tests/test_torch_rungs.py)
RUNG_TOL = 1e-4
#: conv on the card against conv on the CPU at CONV_SHAPE after MAIN_STEPS
#: steps: cuDNN sums the 9 taps in another order (an ulp a step), while
#: TF32 left on would put errors of about 1e-3 into every step
CONV_TOL = 1e-5
CONV_SHAPE = (70, 97)
#: the paths a run resumed through build_storage is held on
RESUME_PATHS = {"cuda auto": [], "cuda pack": ZERO_PACKED,
                "sharded 2x2": SHARDED_FLAGS,
                "sharded windowed 2x2 overlap": WINDOWED_FLAGS["windowed"]
                + ["--sharded-overlap", "on"],
                "fused": ["--backend", "fused"]}
#: rounds of the ladder's timed runs (each rung in order, then reversed)
LADDER_ROUNDS = 2


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item()


def gcells(shape, steps: int, ms: float) -> float:
    return shape[0] * shape[1] * steps / (ms * 1e-3) / 1e9


def ops_per_cell_step(params: Parameters, boundary: str) -> int:
    """float32 operations of one cell-step as the kernels compute it: a
    subtract, a multiply and an add for each tap (the taps of nonzero
    weight, and the centre on the naive path), twice, and 15 in the
    reaction and the update."""
    w = params.weights_array()
    taps = int(np.count_nonzero(w))
    if boundary == "naive" and w[1, 1] == 0.0:
        taps += 1
    return 2 * 3 * taps + 15


def fold_ops_per_cell_step(params: Parameters) -> int:
    """float32 operations of one interior cell-step of the folded naive
    reaction as the fold entries compute it (csrc/gs_tile_sm90.cuh:
    step_strip_fold, fold_update), both species: the separable pass's 4 in
    the row pass and 4 in the column pass, or a direct plan's multiply and
    add a tap of nonzero weight; 2 for uv^2 and 1 more for dt*uv^2 when dt
    != 1; 5 in U's update and 4 in V's."""
    fc = fold_constants(params)
    taps = int(np.count_nonzero(params.weights_array()))
    diffusion = 8 if fc.separable else 2 * taps
    return 2 * diffusion + 2 + (0 if fc.dt_is_one else 1) + 5 + 4


def roofline_ms(shape, steps: int, ops: int,
                cell_bytes: int = 16) -> tuple[float, str]:
    """The least time the card could take to advance ``shape`` by
    ``steps`` steps of ``ops`` float32 operations a cell-step in one call:
    U and V read once and written once (``cell_bytes`` a cell: 16 in
    float32, 8 in bf16 storage), and the operations, none fused, at the
    unfused float32 peak. Returns (ms, what bounds it)."""
    cells = shape[0] * shape[1]
    by_bytes = cell_bytes * cells / PEAK_BYTES
    by_ops = cells * steps * ops / PEAK_F32_UNFUSED
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def bound_ms(shape, steps: int, boundary: str,
             params: Parameters = Parameters(),
             cell_bytes: int = 16) -> tuple[float, str]:
    """:func:`roofline_ms` of the oracle's tree (K1-K3; K1, K2 and K7 on
    bf16 storage with ``cell_bytes=8``)."""
    return roofline_ms(shape, steps, ops_per_cell_step(params, boundary),
                       cell_bytes)


#: float32 operations of one cell-step of the species-packed step, both
#: species, for every separable stencil (ops/packed.py:packed_step): 4 in
#: each pass of the separable convolution, for two passes and two species,
#: 2 for uv^2, and 6 in each update (the V update's + 0.0 included)
PACKED_OPS = 2 * 2 * 4 + 2 + 2 * 6


def oplat_bound_ms(shape, steps: int, n_ops: int,
                   rolls: bool) -> tuple[float, str]:
    """The least time the card could take for one K8 call: the array read
    once and written once (8 B a cell), and each roll one more pass over it
    (8 B a cell a roll), at the HBM rate, and 2 operations a fused
    multiply-add at the float32 peak; rolls add no operations. While the
    array sits in L2 a roll can move faster than HBM does: this is the HBM
    bound."""
    passes = 1 + steps * oplat.rolls_per_chain(n_ops, rolls)
    by_bytes = 8 * shape[0] * shape[1] * passes / PEAK_BYTES
    by_ops = 2 * oplat.fmas(shape, steps, n_ops, rolls) / PEAK_F32
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def reset_launches() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_launches() -> dict:
    return {tag: getattr(module, attr)
            for tag, (module, attr) in COUNTERS.items()}


class Checks:
    def __init__(self):
        self.failures: list[str] = []
        self.kernel_err = {tag: 0.0 for tag in COUNTERS}

    def expect(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)
            print(f"FAILED: {what}", flush=True)

    def compare(self, engine: str, got, want, what: str) -> None:
        errs = [max_err(g, w) for g, w in zip(got, want)]
        self.kernel_err[engine] = max(self.kernel_err[engine], *errs)
        print(f"compare {engine} {what}: max|dU|={errs[0]!r} "
              f"max|dV|={errs[1]!r}", flush=True)
        self.expect(max(errs) <= TOL, f"{engine} vs plain {what}")

    def compare_bits(self, engine: str, got, want, what: str) -> None:
        """Bit for bit, NaN included: max|d| is 0.0 when every bit agrees,
        else inf."""
        same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want))
        err = 0.0 if same else float("inf")
        self.kernel_err[engine] = max(self.kernel_err[engine], err)
        print(f"compare {engine} {what}: bitwise {same}", flush=True)
        self.expect(same, f"{engine} vs plain {what}")

    def compare_bf16(self, engine: str, got, want, what: str) -> None:
        """bf16 storage, bit for bit: the same NaN positions, and the same
        bits in every other cell (NaN's own bit pattern may differ between
        the card's rounding and the CPU's). max|d| is 0.0 when they agree,
        else the largest difference outside NaN (inf on a NaN mismatch)."""
        err = 0.0
        for g, w in zip(got, want):
            g, w = g.float(), w.float()
            nan = torch.isnan(g)
            if not torch.equal(nan, torch.isnan(w)):
                err = float("inf")
                continue
            g, w = torch.where(nan, 0.0, g), torch.where(nan, 0.0, w)
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                d = (g - w).abs().nan_to_num(nan=float("inf"))
                err = max(err, float(d.max()) or float("inf"))
        self.kernel_err[engine] = max(self.kernel_err[engine], err)
        print(f"compare {engine} {what}: bitwise {err == 0.0}", flush=True)
        self.expect(err == 0.0, f"{engine} vs plain {what}")

    def compare_one(self, engine: str, got, want, what: str) -> None:
        err = max_err(got, want)
        self.kernel_err[engine] = max(self.kernel_err[engine], err)
        print(f"compare {engine} {what}: max|d|={err!r}", flush=True)
        self.expect(err <= TOL, f"{engine} vs plain {what}")


def engine_run(engine: str, params: Parameters, boundary: str, u_np, v_np,
               steps: int, pack: str = "auto"):
    """The backend's state after ``steps`` steps on ``engine``."""
    sim = CudaSimulation(params, boundary, device=DEVICE, pack=pack,
                         tuned_lookup=False, **engine_pins(engine))
    storage = sim.build_storage(u_np, v_np)
    storage = sim.run_steps(storage, u_np.shape, steps)
    return sim.extract_uv(storage, u_np.shape)


def compare_kernels(checks: Checks, rng) -> None:
    """Phase 3: every kernel against the plain version on the card."""
    default = Parameters()
    consts = kernel_constants(default)
    for shape in REDESIGNED_SHAPES:
        u_np = rng.uniform(0.0, 1.0, shape).astype(np.float32)
        v_np = rng.uniform(0.0, 1.0, shape).astype(np.float32)
        u0 = torch.from_numpy(u_np).to(DEVICE)
        v0 = torch.from_numpy(v_np).to(DEVICE)
        for boundary in ("naive", "zero"):
            # the plain states after 1, 8, 27 and 32 steps, one replay
            plain, u, v, done = {}, u0, v0, 0
            for n in (1, 8, 27, 32):
                u, v = stencil.run(u, v, n - done, consts, boundary)
                plain[n], done = (u, v), n
            tag = f"{shape[0]}x{shape[1]} {boundary}"
            k1 = {}
            for steps in (1, 8):
                ku, kv = torch.empty_like(u0), torch.empty_like(v0)
                windowed.multistep(u0, v0, ku, kv, steps, consts, boundary)
                k1[steps] = (ku, kv)
                checks.compare("windowed", (ku, kv), plain[steps],
                               f"{tag} steps={steps} (one launch)")
            checks.compare("windowed", engine_run(
                "windowed", default, boundary, u_np, v_np, 32), plain[32],
                f"{tag} steps=32 (backend)")
            for steps in (1, 27, 32):
                out = resident.multistep(u0.clone(), v0.clone(),
                                         torch.empty_like(u0),
                                         torch.empty_like(v0), steps,
                                         consts, boundary)
                checks.compare("resident", out[:2], plain[steps],
                               f"{tag} steps={steps} (one launch)")
            for steps in (8, 27, 32):
                got = engine_run("mega", default, boundary, u_np, v_np,
                                 steps)
                checks.compare("mega", got, plain[steps],
                               f"{tag} steps={steps} (backend)")
                if steps == 8:  # K2 against K1
                    checks.compare("mega", got, k1[8],
                                   f"{tag} steps=8 (backend) vs K1")
            compare_mega_parts(checks, shape, boundary, u0, v0, plain)
    # K1, K2 and K3 with the other stencils and a time step (K2 in two time
    # blocks of 4 steps)
    for shape in REDESIGNED_SHAPES:
        if shape == BENCH_SHAPE:
            continue
        u0, v0 = (torch.from_numpy(rng.uniform(0.0, 1.0, shape)
                                   .astype(np.float32)).to(DEVICE)
                  for _ in range(2))
        for label, params in OTHER_PARAMS:
            consts = kernel_constants(params)
            for boundary in ("naive", "zero"):
                want = stencil.run(u0, v0, 8, consts, boundary)
                what = (f"{shape[0]}x{shape[1]} {boundary} params={label} "
                        "steps=8 (one launch)")
                ku, kv = torch.empty_like(u0), torch.empty_like(v0)
                windowed.multistep(u0, v0, ku, kv, 8, consts, boundary)
                checks.compare("windowed", (ku, kv), want, what)
                out = resident.multistep(u0.clone(), v0.clone(),
                                         torch.empty_like(u0),
                                         torch.empty_like(v0), 8, consts,
                                         boundary)
                checks.compare("resident", out[:2], want, what)
                pu, pv = megakernel.pair_state(u0), megakernel.pair_state(v0)
                megakernel.megastep(pu, pv, 2, 4, consts, boundary)
                checks.compare("mega", (pu[0], pv[0]), want, what)
    # states that hold NaN and +-Inf, in interior and edge tiles and on the
    # domain's edge: held bit for bit (K2 in a time block of 3 steps)
    for shape in ((200, 300), MAIN_SHAPE):
        u0, v0 = (torch.from_numpy(rng.uniform(0.0, 1.0, shape)
                                   .astype(np.float32)).to(DEVICE)
                  for _ in range(2))
        u0[100, 150] = v0[0, 5] = float("nan")
        v0[90, 140] = u0[70, 200] = float("inf")
        u0[120, 7] = v0[-1, -1] = float("-inf")
        for label, params in (("oono-puri", default), *OTHER_PARAMS):
            consts = kernel_constants(params)
            for boundary in ("naive", "zero"):
                want = stencil.run(u0, v0, 3, consts, boundary)
                what = (f"{shape[0]}x{shape[1]} {boundary} params={label} "
                        "NaN and Inf, steps=3 (one launch)")
                ku, kv = torch.empty_like(u0), torch.empty_like(v0)
                windowed.multistep(u0, v0, ku, kv, 3, consts, boundary)
                checks.compare_bits("windowed", (ku, kv), want, what)
                out = resident.multistep(u0.clone(), v0.clone(),
                                         torch.empty_like(u0),
                                         torch.empty_like(v0), 3, consts,
                                         boundary)
                checks.compare_bits("resident", out[:2], want, what)
                pu, pv = megakernel.pair_state(u0), megakernel.pair_state(v0)
                megakernel.megastep(pu, pv, 1, 3, consts, boundary)
                checks.compare_bits("mega", (pu[0], pv[0]), want, what)
                if label == "oono-puri":  # each part of K2, in 3 blocks of 1
                    for part in megakernel.ABLATIONS:
                        pu = megakernel.pair_state(u0)
                        pv = megakernel.pair_state(v0)
                        megakernel.megastep_ablation(pu, pv, 3, 1, consts,
                                                     boundary, part)
                        checks.compare_bits(
                            "mega", (pu[0], pv[0]), want,
                            f"{what} with {megakernel.ABLATIONS[part]}")


#: K2's, K5's and K6's grids pinned below the co-resident maximum, many
#: rounds of tiles a time block or a step
MEGA_GRID_PINS = (1, 7)


def compare_mega_parts(checks: Checks, shape, boundary: str, u0, v0,
                       plain: dict) -> None:
    """Phase 3's K2 parts: each part of the design taken out
    (``megakernel.ABLATIONS``: the 32x32 geometry and the first stepper's
    kernel among them) in one time block of 8 steps and in four (slot copy
    and none), and the whole kernel on grids pinned to MEGA_GRID_PINS
    blocks (two time blocks of 4 steps), against the plain version."""
    consts = kernel_constants(Parameters())
    tag = f"{shape[0]}x{shape[1]} {boundary}"
    for part, what in megakernel.ABLATIONS.items():
        for n_blocks in (1, 4):
            pu, pv = megakernel.pair_state(u0), megakernel.pair_state(v0)
            megakernel.megastep_ablation(pu, pv, n_blocks, 8, consts,
                                         boundary, part)
            checks.compare("mega", (pu[0], pv[0]), plain[8 * n_blocks],
                           f"{tag} steps={8 * n_blocks} (one launch) with "
                           f"{what}")
    want = stencil.run(u0, v0, 8, consts, boundary)
    for grid in MEGA_GRID_PINS:
        pu, pv = megakernel.pair_state(u0), megakernel.pair_state(v0)
        megakernel.megastep(pu, pv, 2, 4, consts, boundary, grid=grid)
        checks.compare("mega", (pu[0], pv[0]), want,
                       f"{tag} steps=8 (two time blocks) on a grid of "
                       f"{grid} blocks")


#: the separable stencils other than the default, and a time step
PACKED_PARAMS = [(label, params) for label, params in OTHER_PARAMS
                 if label != "5points"]
#: K6 in one launch, (time blocks, steps a block), for 1, 8, 27 and 32 steps
MEGA_SPLITS = {1: (1, 1), 8: (1, 8), 27: (9, 3), 32: (4, 8)}


def packed_mega_run(x0, n_blocks: int, steps: int, pc, part=None,
                    grid: int = 0):
    """Slot 0 of a packed pair of ``x0`` after one K6 launch (or one of
    its ablation ``part``)."""
    pair = megakernel.pair_state(x0)
    if part is None:
        megakernel.packed_megastep(pair, n_blocks, steps, pc, grid=grid)
    else:
        megakernel.packed_mega_ablation(pair, n_blocks, steps, pc, part,
                                        grid=grid)
    return pair[0]


def packed_resident_run(x0, steps: int, pc, part=None, grid: int = 0):
    """K5's result after one launch of ``steps`` steps (or one of its
    ablation ``part``) from ``x0``."""
    bufs = (x0.clone(), torch.empty_like(x0))
    if part is None:
        return packed.resident_multistep(*bufs, steps, pc, grid=grid)[0]
    return packed.packed_resident_ablation(*bufs, steps, pc, part,
                                           grid=grid)[0]


def compare_packed_kernels(checks: Checks, rng) -> None:
    """Phase 3b: K4, K5 and K6 (all three on the packed Hopper stepper)
    against the plain packed version on the card, zero boundary, at every
    shape of REDESIGNED_SHAPES: each of their ablation parts, K5 and K6 on
    grids pinned to MEGA_GRID_PINS blocks, the other separable stencils and
    dt = 0.5, and states that hold NaN and +-Inf (bit for bit)."""
    default = Parameters()
    pc = packed_constants(default)

    def compare(tag, got, want, what):
        c = want.shape[-1] // 2
        checks.compare(tag, packed.unpack_state(got, c),
                       packed.unpack_state(want, c), what)

    def compare_bits(tag, got, want, what):
        c = want.shape[-1] // 2
        checks.compare_bits(tag, packed.unpack_state(got, c),
                            packed.unpack_state(want, c), what)

    for shape in REDESIGNED_SHAPES:
        u_np = rng.uniform(0.0, 1.0, shape).astype(np.float32)
        v_np = rng.uniform(0.0, 1.0, shape).astype(np.float32)
        x0 = packed.pack_state(*(torch.from_numpy(a).to(DEVICE)
                                 for a in (u_np, v_np)))
        plain, x, done = {}, x0, 0
        for n in (1, 8, 27, 32):
            x = packed.packed_run(x, n - done, pc)
            plain[n], done = x, n
        tag = f"{shape[0]}x{shape[1]} zero packed"
        for steps in (1, 8):
            out = torch.empty_like(x0)
            packed.multistep(x0, out, steps, pc)
            compare("packed", out, plain[steps],
                    f"{tag} steps={steps} (one launch)")
            for part, what in packed.WINDOWED_ABLATIONS.items():
                out = torch.empty_like(x0)
                packed.packed_windowed_ablation(x0, out, steps, pc, part)
                compare("packed", out, plain[steps],
                        f"{tag} steps={steps} (one launch) with {what}")
        checks.compare("packed", engine_run(
            "windowed", default, "zero", u_np, v_np, 32, pack="on"),
            packed.unpack_state(plain[32], shape[1]),
            f"{tag} steps=32 (backend)")
        for steps in (1, 8, 27, 32):
            compare("respack", packed_resident_run(x0, steps, pc),
                    plain[steps], f"{tag} steps={steps} (one launch)")
            checks.compare("megapack", engine_run(
                "mega", default, "zero", u_np, v_np, steps, pack="on"),
                packed.unpack_state(plain[steps], shape[1]),
                f"{tag} steps={steps} (backend)")
            compare("megapack", packed_mega_run(x0, *MEGA_SPLITS[steps], pc),
                    plain[steps], f"{tag} steps={steps} (one launch of "
                    f"{MEGA_SPLITS[steps][0]} time blocks)")
        for part, what in packed.RESIDENT_ABLATIONS.items():
            for steps in (8, 27):
                compare("respack", packed_resident_run(x0, steps, pc, part),
                        plain[steps], f"{tag} steps={steps} (one launch) "
                        f"with {what}")
        for part, what in megakernel.PACKED_ABLATIONS.items():
            for n_blocks in (1, 4):
                compare("megapack",
                        packed_mega_run(x0, n_blocks, 8, pc, part),
                        plain[8 * n_blocks], f"{tag} steps={8 * n_blocks} "
                        f"(one launch) with {what}")
        for grid in MEGA_GRID_PINS:
            compare("respack", packed_resident_run(x0, 8, pc, grid=grid),
                    plain[8], f"{tag} steps=8 (one launch) on a grid of "
                    f"{grid} blocks")
            compare("megapack", packed_mega_run(x0, 2, 4, pc, grid=grid),
                    plain[8], f"{tag} steps=8 (two time blocks) on a grid "
                    f"of {grid} blocks")
        if shape == BENCH_SHAPE:
            continue
        # the other separable stencils and a time step
        for label, params in PACKED_PARAMS:
            pco = packed_constants(params)
            what = f"{tag} params={label}"
            out = torch.empty_like(x0)
            packed.multistep(x0, out, 8, pco)
            compare("packed", out, packed.packed_run(x0, 8, pco),
                    f"{what} steps=8 (one launch)")
            want = packed.packed_run(x0, 27, pco)
            compare("respack", packed_resident_run(x0, 27, pco), want,
                    f"{what} steps=27 (one launch)")
            checks.compare("megapack", engine_run(
                "mega", params, "zero", u_np, v_np, 27, pack="on"),
                packed.unpack_state(want, shape[1]),
                f"{what} steps=27 (backend)")
            compare("megapack", packed_mega_run(x0, 9, 3, pco), want,
                    f"{what} steps=27 (one launch of 9 time blocks)")
    # states that hold NaN and +-Inf, in interior and edge tiles and on the
    # domain's edge: held bit for bit (K6 in a time block of 3 steps, its
    # parts in 3 blocks of 1)
    for shape in ((200, 300), MAIN_SHAPE):
        u0, v0 = (torch.from_numpy(rng.uniform(0.0, 1.0, shape)
                                   .astype(np.float32)).to(DEVICE)
                  for _ in range(2))
        u0[100, 150] = v0[0, 5] = float("nan")
        v0[90, 140] = u0[70, 200] = float("inf")
        u0[120, 7] = v0[-1, -1] = float("-inf")
        x0 = packed.pack_state(u0, v0)
        for label, params in (("oono-puri", default), *PACKED_PARAMS):
            pco = packed_constants(params)
            want = packed.packed_run(x0, 3, pco)
            what = (f"{shape[0]}x{shape[1]} zero packed params={label} NaN "
                    "and Inf, steps=3 (one launch)")
            out = torch.empty_like(x0)
            packed.multistep(x0, out, 3, pco)
            compare_bits("packed", out, want, what)
            compare_bits("respack", packed_resident_run(x0, 3, pco), want,
                         what)
            compare_bits("megapack", packed_mega_run(x0, 1, 3, pco), want,
                         what)
            if label != "oono-puri":
                continue
            for part, part_what in packed.WINDOWED_ABLATIONS.items():
                out = torch.empty_like(x0)
                packed.packed_windowed_ablation(x0, out, 3, pco, part)
                compare_bits("packed", out, want, f"{what} with {part_what}")
            for part, part_what in packed.RESIDENT_ABLATIONS.items():
                compare_bits("respack",
                             packed_resident_run(x0, 3, pco, part), want,
                             f"{what} with {part_what}")
            for part, part_what in megakernel.PACKED_ABLATIONS.items():
                compare_bits("megapack",
                             packed_mega_run(x0, 3, 1, pco, part), want,
                             f"{what} with {part_what}")


def replay_frames(shape, boundary, params, images, steps, device):
    """V after each batch, from the plain version on ``device``."""
    consts = kernel_constants(params)
    u, v = (torch.from_numpy(x).to(device) for x in initial_uv(shape))
    frames = []
    for _ in range(images):
        u, v = stencil.run(u, v, steps, consts, boundary)
        frames.append(v)
    return frames


def replay_packed_frames(shape, params, images, steps, device):
    """V after each batch, from the plain packed version on ``device``."""
    pc = packed_constants(params)
    x = packed.pack_state(*(torch.from_numpy(a).to(device)
                            for a in initial_uv(shape)))
    frames = []
    for _ in range(images):
        x = packed.packed_run(x, steps, pc)
        frames.append(packed.unpack_state(x, shape[1])[1])
    return frames


def expected_launches(engine: str, images: int, steps: int,
                      split: bool = False) -> int:
    """Launches of ``images`` images of ``steps`` steps on ``engine``;
    ``split``: the windowed sharded engine's overlap split engages (two
    launches a block)."""
    if engine in ("windowed", "packed"):
        return images * -(-steps // windowed.K)
    if engine == "shwin":
        return images * -(-steps // windowed.K) * (2 if split else 1)
    if engine in ("resident", "respack"):
        return images
    n_full, rem = divmod(steps, megakernel.MEGA_STEPS)
    return images * ((n_full > 0) + (rem > 0))


def fold_tma_counts(want: dict, shape) -> dict:
    """``want`` with the float32 fold entries' TMA counts: at a shape that
    ``geometry.tma_ok`` takes, every launch of windowed_fold or mega_fold
    (on fresh, 16-byte aligned tensors) is also counted in its _tma tag."""
    out = dict(want)
    for tag in ("windowed_fold", "mega_fold"):
        if out.get(tag) and geometry.tma_ok(shape, pair=tag == "mega_fold"):
            out[tag + "_tma"] = out[tag]
    return out


def simulate_path(checks: Checks, flags: list, replay) -> dict:
    """One default ``simulate`` run (with ``flags``) of MAIN_IMAGES images
    through ``simulate.run``, with the launch counts zeroed before it and
    read after; every frame against ``replay``."""
    ns = simulate.build_parser().parse_args(flags)
    sim = shared.make_simulation(ns)
    species = sim.make_species(shared.domain_shape(ns))
    engine = KERNEL_OF.get(species.storage[0], species.storage[0])
    split = engine == "shwin" and sim.overlap_runs(species.shape)
    # the fold and the bf16 entries count their launches apart
    counter = (engine + ("_fold" if getattr(sim, "naive_fold", False)
                         else "")
               + ("_bf16" if getattr(sim, "dtype", None) == "bfloat16"
                  else ""))
    frames: list[np.ndarray] = []
    # This sink keeps every frame, so each image would pay a fresh pinned
    # allocation (cudaHostAlloc, ~1.3 ms at this shape), which a long run
    # does not: simulate.main's writer drops each frame once written and
    # PyTorch's pinned-memory cache hands the block back. Fill that cache
    # first, so the rate below is the steady state's.
    pinned = [torch.empty(MAIN_SHAPE, pin_memory=True)
              for _ in range(MAIN_IMAGES + 1)]
    del pinned
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    simulate.run(sim, species, MAIN_IMAGES, MAIN_STEPS, frames.append)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    want = {tag: 0 for tag in COUNTERS}
    want[counter] = expected_launches(engine, MAIN_IMAGES, MAIN_STEPS, split)
    if engine == "shmega" and sharded_mega.read_site_applies(
            species.shape, sim.mesh.shape,
            sharded_mega.tile_for(species.shape, sim.mesh)):
        want["shmega_read_site"] = want[counter]
    want = fold_tma_counts(want, species.shape)
    label = " ".join(flags) or "(auto)"
    print(f"path simulate {label}: engine {counter}, {MAIN_IMAGES} images x "
          f"{MAIN_STEPS} steps at {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} "
          f"{ns.boundary}: {seconds!r} s, launches {launches} (expected "
          f"{want})", flush=True)
    checks.expect(launches == want and launches[counter] > 0,
                  f"simulate {label}: launches {launches}, not {want}")
    checks.expect(len(frames) == MAIN_IMAGES
                  and all(f.shape == MAIN_SHAPE and f.dtype == np.float32
                          and np.isfinite(f).all() for f in frames),
                  f"simulate {label}: frame count, shape, dtype or "
                  "finiteness")
    errs = [float(np.abs(f - r.cpu().numpy()).max())
            for f, r in zip(frames, replay)]
    checks.kernel_err[counter] = max(checks.kernel_err[counter], *errs)
    print(f"path simulate {label} vs plain replay on the card, max|dV| per "
          f"frame: {errs}", flush=True)
    checks.expect(max(errs) <= TOL, f"simulate {label} vs plain replay")
    return {"engine": engine, "counter": counter, "seconds": seconds,
            "launches": launches, "frames": frames,
            "tag": species.storage[0], "flags": flags,
            "mesh": getattr(getattr(sim, "mesh", None), "shape", None),
            "split": split}


#: timed runs of each simulate path after its checked run: this many rounds
#: in turns, the paths in order and then reversed
PATH_ROUNDS = 2


def time_paths(runs: list) -> None:
    """Phase 4c: the simulate paths of ``runs`` (the checked runs of phases
    4, 4b and 10b, and runs of ``simulate.run`` with a part of its
    snapshot pipeline taken out, ``ablation``) timed again, 2 x PATH_ROUNDS
    runs each in turns (``bench/simulate_turns.py:run_ms``: the host clock,
    ending in a device synchronise, as the checked run is timed), since one
    16-image run varies by up to 10 % between processes; each run gains
    ``turns_ms`` and ``median_ms`` (ms an image over the checked run, where
    there is one, and these)."""
    for run in runs:
        run["turns_ms"] = ([run["seconds"] / MAIN_IMAGES * 1e3]
                           if "seconds" in run else [])
    order = [*runs, *reversed(runs)]
    for _ in range(PATH_ROUNDS):
        for run in order:
            run["turns_ms"].append(simulate_turns.run_ms(
                run["flags"], MAIN_IMAGES, MAIN_STEPS, run.get("ablation")))
    for run in runs:
        run["median_ms"] = statistics.median(run["turns_ms"])


def main_paths(checks: Checks) -> dict:
    """Phase 4: the default run on the auto engine and on each pin."""
    ns = simulate.build_parser().parse_args([])  # the default user run
    checks.expect((ns.nbrow, ns.nbcol, ns.boundary, ns.device)
                  == (*MAIN_SHAPE, "naive", DEVICE), "default simulate args")
    replay = replay_frames(MAIN_SHAPE, "naive", shared.simulation_parameters(
        ns), MAIN_IMAGES, MAIN_STEPS, DEVICE)
    runs = {}
    for flags in ([], ["--pallas-engine", "windowed"],
                  ["--pallas-resident", "on"], ["--pallas-engine", "mega"]):
        runs[" ".join(flags) or "auto"] = simulate_path(checks, flags, replay)
    auto = runs["auto"]
    print(f"main path final frame: V in [{float(auto['frames'][-1].min())!r}"
          f", {float(auto['frames'][-1].max())!r}], sum "
          f"{float(auto['frames'][-1].sum())!r}")

    # a small ragged domain, both boundaries, 9 steps an image (one full
    # and one remainder launch), each engine, against the plain version on
    # the CPU, which the CPU tests hold bitwise to the numpy oracle
    for boundary in ("naive", "zero"):
        want = replay_frames((70, 97), boundary, Parameters(), 3, 9, "cpu")
        for flags in ([], ["--pallas-engine", "windowed"],
                      ["--pallas-resident", "on"],
                      ["--pallas-engine", "mega"]):
            small = simulate.build_parser().parse_args(
                ["-r", "70", "-c", "97", "--boundary", boundary, *flags])
            sim_s = shared.make_simulation(small)
            sp = sim_s.make_species(shared.domain_shape(small))
            got: list[np.ndarray] = []
            simulate.run(sim_s, sp, 3, 9, got.append)
            err = max(float(np.abs(g - w.numpy()).max())
                      for g, w in zip(got, want))
            print(f"small 70x97 {boundary} {sp.storage[0]}, 3 images x 9 "
                  f"steps, vs plain on the CPU: max|dV|={err!r}", flush=True)
            checks.expect(err <= TOL, f"small {boundary} {flags} vs plain "
                          "on the CPU")

    if importlib.util.find_spec("h5py") is None:
        print("simulate.main: not run (h5py is not installed); "
              "simulate.run ran with an in-memory sink")
        return runs
    import h5py

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "output.h5")
        reset_launches()
        t0 = time.perf_counter()
        rc = simulate.main(["-n", str(MAIN_IMAGES), "-o", out])
        h5_seconds = time.perf_counter() - t0
        launches = read_launches()
        with h5py.File(out, "r") as f:
            written = f["matrix"][:]
    print(f"simulate.main ran and wrote HDF5: rc={rc}, {h5_seconds!r} s, "
          f"launches {launches}", flush=True)
    checks.expect(rc == 0 and launches == auto["launches"], "simulate.main")
    checks.expect(written.shape == (MAIN_IMAGES, *MAIN_SHAPE)
                  and np.array_equal(written[-1], auto["frames"][-1]),
                  "simulate.main HDF5 frames vs simulate.run")
    auto["hdf5_seconds"] = h5_seconds
    return runs


def packed_paths(checks: Checks) -> dict:
    """Phase 4b: ``simulate --boundary zero --pallas-pack on`` on the auto
    engine and on each pin, every frame against the plain packed replay;
    the last frame against the unpacked zero run on K1; a small domain
    against the plain packed version on the CPU."""
    params = Parameters()
    replay = replay_packed_frames(MAIN_SHAPE, params, MAIN_IMAGES,
                                  MAIN_STEPS, DEVICE)
    runs = {}
    for flags in ([], *PACKED_FLAGS.values()):
        runs[" ".join(flags) or "auto"] = simulate_path(
            checks, ZERO_PACKED + flags, replay)

    # the same run unpacked, on K1 (the oracle's tree)
    sim = CudaSimulation(params, "zero", device=DEVICE, engine="windowed",
                         tuned_lookup=False)
    species = sim.make_species(MAIN_SHAPE)
    reset_launches()
    unpacked = []
    for _ in range(MAIN_IMAGES):
        sim.prepare_steps(species, MAIN_STEPS)
        unpacked.append(species.result().clone())
    k1 = read_launches()["windowed"]
    errs = [float(np.abs(f - w.cpu().numpy()).max())
            for f, w in zip(runs["auto"]["frames"], unpacked)]
    print(f"packed frames ({runs['auto']['engine']}) vs the unpacked zero "
          f"run on K1 ({k1} launches) at {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}, "
          f"max|dV| per frame: {errs} (limits: first "
          f"{PACK_VS_UNPACKED_FIRST!r}, last {PACK_VS_UNPACKED_LAST!r})",
          flush=True)
    checks.expect(k1 == expected_launches("windowed", MAIN_IMAGES,
                                          MAIN_STEPS), "unpacked K1 run")
    checks.expect(errs[0] <= PACK_VS_UNPACKED_FIRST
                  and errs[-1] <= PACK_VS_UNPACKED_LAST,
                  "packed vs unpacked zero run")
    runs["vs_unpacked"] = errs

    want = replay_packed_frames((70, 97), params, 3, 9, "cpu")
    for flags in ([], *PACKED_FLAGS.values()):
        small = simulate.build_parser().parse_args(
            ["-r", "70", "-c", "97", *ZERO_PACKED, *flags])
        sim_s = shared.make_simulation(small)
        sp = sim_s.make_species(shared.domain_shape(small))
        got: list[np.ndarray] = []
        simulate.run(sim_s, sp, 3, 9, got.append)
        err = max(float(np.abs(g - w.numpy()).max())
                  for g, w in zip(got, want))
        print(f"small 70x97 zero {sp.storage[0]}, 3 images x 9 steps, vs "
              f"plain packed on the CPU: max|dV|={err!r}", flush=True)
        checks.expect(err <= TOL, f"small packed {flags} vs plain on the "
                      "CPU")
    return runs


def packed_bench(checks: Checks, card: str) -> dict:
    """Phase 5b: one 4096x4096 x 1000-step run on the packed auto engine,
    against a 1000-step plain packed replay on the card."""
    params = Parameters()
    u_np, v_np = initial_uv(BENCH_SHAPE)
    sim = CudaSimulation(params, "zero", device=DEVICE, pack="on")
    storage = sim.build_storage(u_np, v_np)
    tag = storage[0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_launches()
    start.record()
    storage = sim.run_steps(storage, BENCH_SHAPE, BENCH_STEPS)
    end.record()
    end.synchronize()
    launches = read_launches()[tag]
    ms = start.elapsed_time(end)
    x = packed.pack_state(*(torch.from_numpy(a).to(DEVICE)
                            for a in (u_np, v_np)))
    start.record()
    x = packed.packed_run(x, BENCH_STEPS, packed_constants(params))
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    checks.compare(tag, sim.extract_uv(storage, BENCH_SHAPE),
                   packed.unpack_state(x, BENCH_SHAPE[1]),
                   f"{BENCH_SHAPE[0]}x{BENCH_SHAPE[1]} zero packed "
                   f"steps={BENCH_STEPS} (auto)")
    want = expected_launches(tag, 1, BENCH_STEPS)
    checks.expect(launches == want, f"1000-step packed {tag} run made "
                  f"{launches} launches, not {want}")
    print(f"time packed auto ({tag}) {BENCH_SHAPE[0]}x{BENCH_SHAPE[1]} "
          f"zero {BENCH_STEPS} steps, {launches} launches: {ms!r} ms = "
          f"{gcells(BENCH_SHAPE, BENCH_STEPS, ms)!r} Gcell/s; plain replay "
          f"{plain_ms!r} ms [{card}]", flush=True)
    return {"engine": tag, "ms": ms, "plain_ms": plain_ms,
            "launches": launches}


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` on the card over ``reps`` calls after one
    warm-up, from CUDA events around the whole run."""
    return gpu.time_call(fn, DEVICE, reps, best_of=1) * 1e3


def queued_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls that the host
    enqueues behind a sleeping kernel (``torch.cuda._sleep``, twice the
    host's time for the calls), so that a launch shorter than the host's
    enqueue time is timed by the card, not by the host; after one warm-up,
    from CUDA events around the calls (the host clock on the CPU)."""
    if DEVICE != "cuda":
        return cuda_ms(fn, reps)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * reps * host * 2e9) + 1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bench_path(checks: Checks, card: str) -> dict:
    """Phase 5: the headline rows, and 1000-step mega runs checked."""
    reset_launches()
    rows = {b: headline.measure(*BENCH_SHAPE, BENCH_STEPS, boundary=b,
                                device=DEVICE)
            for b in ("zero", "naive")}
    launches = read_launches()
    engines = {b: auto_layout(BENCH_SHAPE, b) for b in ("zero", "naive")}
    print(f"path bench.headline {BENCH_SHAPE[0]}x{BENCH_SHAPE[1]} x "
          f"{BENCH_STEPS} steps: engines {engines}, launches {launches} "
          f"[{card}]", flush=True)
    for engine in engines.values():
        checks.expect(launches[engine] > 0,
                      f"bench path launched {engine} no time")
    line = headline.headline(rows["zero"], rows["naive"], BENCH_SHAPE,
                             BENCH_STEPS, DEVICE)
    print(f"headline {json.dumps(line)}", flush=True)

    result = {"launches": launches}
    default = Parameters()
    consts = kernel_constants(default)
    u_np, v_np = initial_uv(BENCH_SHAPE)
    for boundary in ("naive", "zero"):
        sim = CudaSimulation(default, boundary, device=DEVICE, engine="mega",
                             tuned_lookup=False)
        storage = sim.build_storage(u_np, v_np)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reset_launches()
        start.record()
        storage = sim.run_steps(storage, BENCH_SHAPE, BENCH_STEPS)
        end.record()
        end.synchronize()
        mega_launches = read_launches()["mega"]
        ms = start.elapsed_time(end)
        u0, v0 = (torch.from_numpy(x).to(DEVICE) for x in (u_np, v_np))
        start.record()
        ru, rv = stencil.run(u0, v0, BENCH_STEPS, consts, boundary)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        checks.compare("mega", sim.extract_uv(storage, BENCH_SHAPE),
                       (ru, rv), f"{BENCH_SHAPE[0]}x{BENCH_SHAPE[1]} "
                       f"{boundary} steps={BENCH_STEPS} (one launch)")
        checks.expect(mega_launches == 1,
                      f"1000-step mega run made {mega_launches} launches")
        bound, by = bound_ms(BENCH_SHAPE, BENCH_STEPS, boundary)
        name, steady, single, _ = rows[boundary]
        print(f"time mega {BENCH_SHAPE[0]}x{BENCH_SHAPE[1]} {boundary} "
              f"{BENCH_STEPS} steps in one launch: {ms!r} ms = "
              f"{gcells(BENCH_SHAPE, BENCH_STEPS, ms)!r} Gcell/s; bound "
              f"{bound!r} ms ({by}), {100 * bound / ms!r} % of it; the "
              f"headline's {boundary} row ({name}, {engines[boundary]}): "
              f"steady {steady!r} Gcell/s = "
              f"{BENCH_SHAPE[0] * BENCH_SHAPE[1] * BENCH_STEPS / steady / 1e6!r}"
              f" ms, single run {single!r} Gcell/s; plain replay "
              f"{plain_ms!r} ms [{card}]", flush=True)
        result[boundary] = (ms, plain_ms)
    return result


def auto_layout(shape, boundary: str) -> str:
    """The storage tag that ``auto`` runs for ``shape`` and ``boundary``:
    the autotune record's engine and layout (the shipped one, since the
    store is empty), else the measured ranking."""
    packed_layout, engine = CudaSimulation(
        Parameters(), boundary, device=DEVICE).layout_for(shape)
    return cuda_backend.PACKED_TAGS[engine] if packed_layout else engine


def engine_pins(engine: str) -> dict:
    """The backend knobs that pin ``engine``."""
    return {"resident": "on"} if engine == "resident" else {"engine": engine}


def time_engines(rng, card: str) -> dict:
    """Phase 6a: each engine through the backend, 32 steps a call, timed
    in turns (windowed, resident, mega, mega, resident, windowed) and
    averaged, so that a drift of the card's clock favours none."""
    times = {}
    for shape, reps in ((MAIN_SHAPE, 40), (BENCH_SHAPE, 8)):
        u_np = rng.uniform(0, 1, shape).astype(np.float32)
        v_np = rng.uniform(0, 1, shape).astype(np.float32)
        for boundary in ("naive", "zero"):
            samples = {engine: [] for engine in MODULES}
            for engine in [*MODULES, *reversed(MODULES)]:
                sim = CudaSimulation(Parameters(), boundary, device=DEVICE,
                                     tuned_lookup=False,
                                     **engine_pins(engine))
                box = [sim.build_storage(u_np, v_np)]

                def call():
                    box[0] = sim.run_steps(box[0], shape, MAIN_STEPS)

                samples[engine].append(cuda_ms(call, reps))
            bound, by = bound_ms(shape, MAIN_STEPS, boundary)
            for engine, pair in samples.items():
                ms = sum(pair) / len(pair)
                times[shape, boundary, engine] = ms
                print(f"time engine {engine} {shape[0]}x{shape[1]} "
                      f"{boundary}, {MAIN_STEPS} steps a call: {ms!r} ms "
                      f"(turns {pair!r}) = "
                      f"{gcells(shape, MAIN_STEPS, ms)!r} Gcell/s; bound "
                      f"{bound!r} ms ({by}) [{card}]", flush=True)
            ranked = sorted(MODULES, key=lambda e: times[shape, boundary, e])
            print(f"engines {shape[0]}x{shape[1]} {boundary} "
                  f"({cuda_backend.shape_class(shape)}), fastest first: "
                  f"{ranked}; the measured ranking picks "
                  f"{cuda_backend.auto_engine(shape, boundary)}; auto runs "
                  f"{auto_layout(shape, boundary)}", flush=True)
    return times


def time_packed_engines(rng, card: str) -> dict:
    """Phase 6c: each packed engine through the backend, 32 steps a call,
    beside K1 and K2 on the zero boundary, timed in turns (K1, K2, K4, K5,
    K6, K6, K5, K4, K2, K1) and averaged; the times
    ``auto_packed_engine`` is set from."""
    tags = cuda_backend.PACKED_TAGS
    order = ["windowed", "mega", *tags.values()]
    engine_of = {tag: engine for engine, tag in tags.items()}
    times = {}
    for shape, reps in ((MAIN_SHAPE, 40), (BENCH_SHAPE, 8)):
        u_np = rng.uniform(0, 1, shape).astype(np.float32)
        v_np = rng.uniform(0, 1, shape).astype(np.float32)
        samples = {tag: [] for tag in order}
        for tag in [*order, *reversed(order)]:
            if tag in MODULES:
                sim = CudaSimulation(Parameters(), "zero", device=DEVICE,
                                     engine=tag, tuned_lookup=False)
            else:
                sim = CudaSimulation(Parameters(), "zero", device=DEVICE,
                                     pack="on", tuned_lookup=False,
                                     **engine_pins(engine_of[tag]))
            box = [sim.build_storage(u_np, v_np)]
            assert box[0][0] == tag

            def call():
                box[0] = sim.run_steps(box[0], shape, MAIN_STEPS)

            samples[tag].append(cuda_ms(call, reps))
        for tag, pair in samples.items():
            ms = sum(pair) / len(pair)
            times[shape, tag] = ms
            bound, by = (bound_ms(shape, MAIN_STEPS, "zero")
                         if tag in MODULES
                         else roofline_ms(shape, MAIN_STEPS, PACKED_OPS))
            print(f"time engine {tag} {shape[0]}x{shape[1]} zero, "
                  f"{MAIN_STEPS} steps a call: {ms!r} ms (turns {pair!r}) "
                  f"= {gcells(shape, MAIN_STEPS, ms)!r} Gcell/s; bound "
                  f"{bound!r} ms ({by}) [{card}]", flush=True)
        ranked = sorted(tags, key=lambda e: times[shape, tags[e]])
        print(f"packed engines {shape[0]}x{shape[1]} "
              f"({cuda_backend.shape_class(shape)}), fastest first: "
              f"{ranked}; the measured ranking picks "
              f"{cuda_backend.auto_packed_engine(shape)}; auto runs "
              f"{auto_layout(shape, 'zero')}; unpacked K1 "
              f"{times[shape, 'windowed']!r} ms, K2 "
              f"{times[shape, 'mega']!r} ms", flush=True)
    return times


def time_packed_kernels(checks: Checks, rng, card: str) -> dict:
    """Phase 6d: K6 (one launch of 4 time blocks of 8 steps), K5 (one
    32-step launch) and K4 (four 8-step launches), on the packed Hopper
    stepper, timed in turns with their first forms (ablation part 0), and
    K1, K2 and K3 on the zero boundary (the same stepper unpacked), 32 steps
    each, at 1080x1920 and 4096x4096; then each of K4, K5 and K6 with one
    part of its design taken out, in turns with the whole kernel (whole,
    parts..., parts reversed, whole), held bit for bit against it, each
    time as a ratio to the whole; then the plain packed version of 8 and 32
    steps. Each beside the card's bound."""
    pc = packed_constants(Parameters())
    consts = kernel_constants(Parameters())
    out = {}
    for shape, reps in ((MAIN_SHAPE, 40), (BENCH_SHAPE, 8)):
        u, v = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
                .to(DEVICE) for _ in range(2))
        x = packed.pack_state(u, v)
        k1_bufs = [u, v, torch.empty_like(u), torch.empty_like(v)]
        k3_bufs = [u.clone(), v.clone(), torch.empty_like(u),
                   torch.empty_like(v)]
        k2_pairs = (megakernel.pair_state(u), megakernel.pair_state(v))

        def k4_run(part):
            bufs = [x.clone(), torch.empty_like(x)]

            def call():
                for _ in range(MAIN_STEPS // packed.K):
                    if part is None:
                        packed.multistep(*bufs, packed.K, pc)
                    else:
                        packed.packed_windowed_ablation(*bufs, packed.K, pc,
                                                        part)
                    bufs.reverse()
            return call

        def k5_run(part):
            bufs = [x.clone(), torch.empty_like(x)]

            def call():
                if part is None:
                    bufs[:] = packed.resident_multistep(*bufs, MAIN_STEPS, pc)
                else:
                    bufs[:] = packed.packed_resident_ablation(
                        *bufs, MAIN_STEPS, pc, part)
            return call

        def k6_run(part):
            pair = megakernel.pair_state(x)

            def call():
                if part is None:
                    megakernel.packed_megastep(pair, MAIN_STEPS // 8, 8, pc)
                else:
                    megakernel.packed_mega_ablation(pair, MAIN_STEPS // 8, 8,
                                                    pc, part)
            return call

        def k3():
            k3_bufs[:] = resident.multistep(*k3_bufs, MAIN_STEPS, consts,
                                            "zero")

        def k2():
            megakernel.megastep(*k2_pairs, MAIN_STEPS // 8, 8, consts, "zero")

        def k1():
            for _ in range(MAIN_STEPS // windowed.K):
                windowed.multistep(*k1_bufs, windowed.K, consts, "zero")
                k1_bufs[:] = k1_bufs[2:] + k1_bufs[:2]

        calls = {"megapack": k6_run(None), "megapack0": k6_run(0),
                 "respack": k5_run(None), "respack0": k5_run(0),
                 "packed": k4_run(None), "packed0": k4_run(0),
                 "windowed": k1, "mega": k2, "resident": k3}
        samples = {name: [] for name in calls}
        for name in [*calls, *reversed(calls)]:
            samples[name].append(cuda_ms(calls[name], reps))
        ms = {name: sum(p) / len(p) for name, p in samples.items()}
        for name, pair in samples.items():
            bound, by = (bound_ms(shape, MAIN_STEPS, "zero")
                         if name in MODULES
                         else roofline_ms(shape, MAIN_STEPS, PACKED_OPS))
            out[name, shape, "ms32"] = ms[name]
            print(f"time {name} {shape[0]}x{shape[1]} zero, {MAIN_STEPS} "
                  f"steps: {ms[name]!r} ms (turns {pair!r}) = "
                  f"{gcells(shape, MAIN_STEPS, ms[name])!r} Gcell/s; bound "
                  f"{bound!r} ms ({by}), {100 * bound / ms[name]!r} % of it "
                  f"[{card}]", flush=True)
        print(f"redesigned packed {shape[0]}x{shape[1]} zero: K6 "
              f"{ms['megapack0'] / ms['megapack']!r}x faster than its first "
              f"form, K5 {ms['respack0'] / ms['respack']!r}x, K4 "
              f"{ms['packed0'] / ms['packed']!r}x; K6 "
              f"{ms['megapack'] / ms['packed']!r}x K4's time, "
              f"{ms['megapack'] / ms['mega']!r}x K2's; K5 "
              f"{ms['respack'] / ms['resident']!r}x K3's; K4 "
              f"{ms['packed'] / ms['windowed']!r}x K1's [{card}]",
              flush=True)

        def one_launch(tag, part=None):
            """The state after one launch of 8 steps."""
            if tag == "megapack":
                return packed_mega_run(x, 1, 8, pc, part)
            if tag == "respack":
                return packed_resident_run(x, 8, pc, part)
            got = torch.empty_like(x)
            if part is None:
                packed.multistep(x, got, 8, pc)
            else:
                packed.packed_windowed_ablation(x, got, 8, pc, part)
            return got

        for tag, run, parts in (
                ("megapack", k6_run, megakernel.PACKED_ABLATIONS),
                ("respack", k5_run, packed.RESIDENT_ABLATIONS),
                ("packed", k4_run, packed.WINDOWED_ABLATIONS)):
            # each part after 8 steps, held against the whole kernel
            want = one_launch(tag)
            for part, what in parts.items():
                got = one_launch(tag, part)
                checks.compare(tag, packed.unpack_state(got, shape[1]),
                               packed.unpack_state(want, shape[1]),
                               f"{shape[0]}x{shape[1]} zero packed steps=8 "
                               f"with {what} vs the whole")
            timed = [None, *(p for p in parts if p)]
            part_calls = {p: run(p) for p in timed}
            part_samples = {p: [] for p in timed}
            for p in [*timed, *reversed(timed)]:
                part_samples[p].append(cuda_ms(part_calls[p], reps))
            whole = sum(part_samples[None]) / 2
            for p in timed[1:]:
                t = sum(part_samples[p]) / 2
                out[tag, shape, "part", p] = t / whole
                print(f"time {tag} {shape[0]}x{shape[1]} zero, "
                      f"{MAIN_STEPS} steps, with {parts[p]}: {t!r} ms (turns "
                      f"{part_samples[p]!r}) = {t / whole!r}x the whole "
                      f"kernel's {whole!r} ms (the turns above: "
                      f"{ms[tag]!r}) [{card}]", flush=True)
        for tag, steps in (("packed", packed.K), ("respack", MAIN_STEPS),
                           ("megapack", MAIN_STEPS)):
            plain_ms = cuda_ms(lambda: packed.packed_run(x, steps, pc),
                               2 if shape == MAIN_SHAPE else 1)
            kernel_ms = ms[tag] * steps / MAIN_STEPS
            bound, by = roofline_ms(shape, steps, PACKED_OPS)
            out[tag, shape] = (kernel_ms, plain_ms, bound, by, steps)
            print(f"time {tag} {shape[0]}x{shape[1]} zero, {steps} steps "
                  f"a launch: kernel {kernel_ms!r} ms = "
                  f"{gcells(shape, steps, kernel_ms)!r} Gcell/s; plain "
                  f"{plain_ms!r} ms = {gcells(shape, steps, plain_ms)!r} "
                  f"Gcell/s; bound {bound!r} ms ({by}), "
                  f"{100 * bound / kernel_ms!r} % of it [{card}]", flush=True)
    return out


def time_snapshot(shape, reps: int) -> float:
    """ms of the main path's per-image snapshot: a device clone of V and
    its non-blocking copy into pinned host memory."""
    v = torch.zeros(shape, device=DEVICE)
    host = torch.empty(shape, pin_memory=True)
    return cuda_ms(lambda: host.copy_(v.clone(), non_blocking=True), reps)


def time_kernels(checks: Checks, rng, card: str) -> dict:
    """Phase 6b: K1 (four 8-step launches), K2 (one launch of 4 time blocks
    of 8 steps), K3 and K9 at split 1 (one 32-step launch each), all four on
    the Hopper tile stepper, timed in turns with K2's first-stepper kernel
    (its ablation part 0: K1's and K2's former code shape) and K9's first
    form at split 1 (its part 0: K3's and K9's former code shape), 32 steps
    each (K1, K2, K2 part 0, K3, K9, K9 part 0, then back), at 1080x1920
    and 4096x4096, both boundaries; then each of K1, K2, K3 and K9 with one
    part of its design taken out (:func:`time_ablations`); then K1's and
    K3's plain versions. Each beside the card's bound for 32 steps."""
    consts = kernel_constants(Parameters())
    out = {}
    for shape, reps in ((MAIN_SHAPE, 40), (BENCH_SHAPE, 8)):
        u, v = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
                .to(DEVICE) for _ in range(2))
        for boundary in ("naive", "zero"):
            k1_bufs = [u, v, torch.empty_like(u), torch.empty_like(v)]
            k3_bufs = [u.clone(), v.clone(), torch.empty_like(u),
                       torch.empty_like(v)]
            k9_bufs = [u.clone(), v.clone(), torch.empty_like(u),
                       torch.empty_like(v)]
            k9_old = [u.clone(), v.clone(), torch.empty_like(u),
                      torch.empty_like(v)]
            pair_u, pair_v = megakernel.pair_state(u), megakernel.pair_state(v)
            old_u, old_v = megakernel.pair_state(u), megakernel.pair_state(v)

            def k1():
                for _ in range(MAIN_STEPS // windowed.K):
                    windowed.multistep(*k1_bufs, windowed.K, consts, boundary)
                    k1_bufs[:] = k1_bufs[2:] + k1_bufs[:2]

            def k3():
                k3_bufs[:] = resident.multistep(*k3_bufs, MAIN_STEPS, consts,
                                                boundary)

            def k2():
                megakernel.megastep(pair_u, pair_v, MAIN_STEPS // 8, 8,
                                    consts, boundary)

            def k2_first():
                megakernel.megastep_ablation(old_u, old_v, MAIN_STEPS // 8, 8,
                                             consts, boundary, 0)

            def k9():
                k9_bufs[:] = ilpsplit.split_multistep(
                    *k9_bufs, MAIN_STEPS, consts, boundary, 1)

            def k9_first():
                k9_old[:] = ilpsplit.split_ablation(
                    *k9_old, MAIN_STEPS, consts, boundary, 1, 0)

            calls = {"windowed": k1, "mega": k2, "mega0": k2_first,
                     "resident": k3, "ilpsplit": k9, "ilpsplit0": k9_first}
            samples = {name: [] for name in calls}
            for name in [*calls, *reversed(calls)]:
                samples[name].append(cuda_ms(calls[name], reps))
            bound, by = bound_ms(shape, MAIN_STEPS, boundary)
            ms = {name: sum(p) / len(p) for name, p in samples.items()}
            for name, pair in samples.items():
                out[name, shape, boundary, "ms32"] = ms[name]
                print(f"time {name} {shape[0]}x{shape[1]} {boundary}, "
                      f"{MAIN_STEPS} steps: {ms[name]!r} ms (turns "
                      f"{pair!r}) = {gcells(shape, MAIN_STEPS, ms[name])!r} "
                      f"Gcell/s; bound {bound!r} ms ({by}), "
                      f"{100 * bound / ms[name]!r} % of it [{card}]",
                      flush=True)
            print(f"redesigned {shape[0]}x{shape[1]} {boundary}: K2 "
                  f"{ms['mega'] / ms['windowed']!r}x K1's time (the "
                  f"megakernel against the windowed kernel on one stepper); "
                  f"K2 {ms['mega0'] / ms['mega']!r}x faster than its first "
                  f"stepper's kernel; K1 {ms['mega0'] / ms['windowed']!r}x "
                  f"faster than it (K1's former code shape); K3 "
                  f"{ms['ilpsplit0'] / ms['resident']!r}x faster than K9's "
                  f"first form at split 1 (K3's former code shape); K9 at "
                  f"split 1 {ms['ilpsplit'] / ms['resident']!r}x K3's time, "
                  f"{ms['ilpsplit0'] / ms['ilpsplit']!r}x faster than its "
                  f"first form [{card}]", flush=True)
            time_ablations(checks, shape, boundary, u, v, reps, ms, card)
            for engine, steps in (("windowed", windowed.K),
                                  ("resident", MAIN_STEPS)):
                plain_ms = cuda_ms(
                    lambda: stencil.run(u, v, steps, consts, boundary),
                    2 if shape == MAIN_SHAPE else 1)
                kernel_ms = ms[engine] * steps / MAIN_STEPS
                bound, by = bound_ms(shape, steps, boundary)
                out[engine, shape, boundary] = (kernel_ms, plain_ms, bound,
                                                by, steps)
                print(f"time {engine} {shape[0]}x{shape[1]} {boundary}, "
                      f"{steps} steps a launch: kernel {kernel_ms!r} ms; "
                      f"plain {plain_ms!r} ms = "
                      f"{gcells(shape, steps, plain_ms)!r} Gcell/s; bound "
                      f"{bound!r} ms ({by}) [{card}]", flush=True)
    return out


#: the parts of K1's, K3's, K2's and K9's design that their ablation entries
#: take out (csrc/windowed.cu: gs_windowed_ablation, csrc/resident.cu:
#: gs_resident_ablation; K2's and K9's part 0, their first forms, are timed
#: in phase 6b's turns)
ABLATIONS = {
    "windowed": {1: "every tile an edge tile",
                 2: "the tap set tested at run time",
                 3: "32x32 tiles in 48x48 windows",
                 4: "32x128 tiles in 48x144 windows"},
    "resident": {1: "every tile an edge tile",
                 2: "the tap set tested at run time",
                 3: "no prefetch of the next window"},
    "mega": {p: what for p, what in megakernel.ABLATIONS.items() if p},
    "ilpsplit": {p: what for p, what in ilpsplit.ABLATIONS.items() if p},
}


def time_ablations(checks: Checks, shape, boundary: str, u, v, reps: int,
                   ms: dict, card: str) -> None:
    """Phase 6b's ablations: K1 (four 8-step launches), K3 and K9 at split 1
    (one 32-step launch each) and K2 (one launch of 4 time blocks of 8
    steps) of the default stencil, each with one part of its design taken
    out or with another tile shape (ABLATIONS; K2's and K9's part 0, their
    first forms, are timed in phase 6b's turns), timed in turns with the
    whole kernel (whole, parts..., parts reversed, whole) and held bit for
    bit against it; each time also as a ratio to the whole kernel's (and
    beside phase 6b's, ``ms``)."""
    consts = kernel_constants(Parameters())
    naive = int(boundary == "naive")
    stream = torch.cuda.current_stream().cuda_stream
    floats = [ctypes.c_float] * 14
    k1_fn = build.bind("gs_windowed_ablation",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + floats
                       + [ctypes.c_void_p, ctypes.c_int])
    k3_fn = build.bind("gs_resident_ablation",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + floats
                       + [ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int])
    barrier = torch.zeros(1, dtype=torch.int64, device=DEVICE)

    def k1(bufs, part, steps=windowed.K):
        if part is None:
            windowed.multistep(*bufs, steps, consts, boundary)
            return
        err = k1_fn(*(b.data_ptr() for b in bufs), *shape, steps, naive,
                    u.device.index or 0, *consts.weights, *consts.reaction,
                    stream, part)
        if err:
            raise RuntimeError(f"K1 ablation {part}: CUDA error {err} "
                               f"({build.error_name(err)})")

    def k3(bufs, part, steps=MAIN_STEPS):
        if part is None:
            return resident.multistep(*bufs, steps, consts, boundary)
        barrier.zero_()
        err = k3_fn(*(b.data_ptr() for b in bufs), *shape, steps, naive,
                    u.device.index or 0, *consts.weights, *consts.reaction,
                    0, barrier.data_ptr(), stream, part)
        if err:
            raise RuntimeError(f"K3 ablation {part}: CUDA error {err} "
                               f"({build.error_name(err)})")
        return bufs if steps % 2 == 0 else (*bufs[2:], *bufs[:2])

    def k2(bufs, part, steps=MAIN_STEPS):
        n_blocks, k = (MAIN_STEPS // 8, 8) if steps == MAIN_STEPS else (1, steps)
        if part is None:
            megakernel.megastep(*bufs[:2], n_blocks, k, consts, boundary)
        else:
            megakernel.megastep_ablation(*bufs[:2], n_blocks, k, consts,
                                         boundary, part)
        return bufs

    def k9(bufs, part, steps=MAIN_STEPS):
        if part is None:
            return ilpsplit.split_multistep(*bufs, steps, consts, boundary, 1)
        return ilpsplit.split_ablation(*bufs, steps, consts, boundary, 1,
                                       part)

    for engine, run in (("windowed", k1), ("resident", k3), ("mega", k2),
                        ("ilpsplit", k9)):
        parts = [None, *ABLATIONS[engine]]
        if engine == "mega":  # pairs, slot 0 current
            bufs = {p: [megakernel.pair_state(u), megakernel.pair_state(v)]
                    for p in parts}
        else:
            bufs = {p: [u.clone(), v.clone(), torch.empty_like(u),
                        torch.empty_like(v)] for p in parts}
        want = None
        for part in parts:  # one launch of 8 steps, held against the whole
            if engine == "mega":
                b = [megakernel.pair_state(u), megakernel.pair_state(v)]
            else:
                b = [u.clone(), v.clone(), torch.empty_like(u),
                     torch.empty_like(v)]
            out = run(b, part, steps=8)
            got = ((b[2], b[3]) if engine == "windowed"
                   else (out[0][0], out[1][0]) if engine == "mega"
                   else tuple(out[:2]))
            if part is None:
                want = got
            else:
                checks.compare(engine, got, want, f"{shape[0]}x{shape[1]} "
                               f"{boundary} steps=8 with "
                               f"{ABLATIONS[engine][part]} vs the whole")
        calls = {}
        for part in parts:
            def call(part=part, b=bufs[part]):
                if engine == "windowed":
                    for _ in range(MAIN_STEPS // windowed.K):
                        run(b, part)
                else:
                    b[:] = run(b, part)
            calls[part] = call
        samples = {p: [] for p in parts}
        for part in [*parts, *reversed(parts)]:
            samples[part].append(cuda_ms(calls[part], reps))
        whole = sum(samples[None]) / 2
        for part in parts[1:]:
            t = sum(samples[part]) / 2
            print(f"time {engine} {shape[0]}x{shape[1]} {boundary}, "
                  f"{MAIN_STEPS} steps, with {ABLATIONS[engine][part]}: "
                  f"{t!r} ms (turns {samples[part]!r}) = {t / whole!r}x the "
                  f"whole kernel's {whole!r} ms (phase 6b's turns: "
                  f"{ms[engine]!r}) [{card}]", flush=True)


PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
PTXAS_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads")
PTXAS_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
#: the kernels on the Hopper tile steppers, K1, K3, K2, K7 and K9
#: (gs_tile_sm90.cuh) and K4, K5 and K6 (gs_packed_sm90.cuh), as their
#: mangled names spell them (the name's length, then the name:
#: "15resident_kernel" is not a part of "22packed_resident_kernel")
REDESIGNED_KERNELS = ("15windowed_kernel", "15resident_kernel",
                      "11mega_kernel", "19sharded_mega_kernel",
                      "15ilpsplit_kernel", "13packed_kernel",
                      "22packed_resident_kernel", "18packed_mega_kernel",
                      "11ring_kernel", "13pinned_kernel",
                      "20packed_pinned_kernel", "18folded_form_kernel",
                      "19fold_refresh_kernel", "18ring_pinned_kernel",
                      "20windowed_fold_kernel", "16mega_fold_kernel",
                      "18pinned_form_kernel", "17shard_form_kernel",
                      "20mega_pin_form_kernel", "23sharded_pin_form_kernel",
                      "15exchange_kernel")
#: of those, the ones whose instantiations must not spill (K2, K7, K4, K6,
#: K2's ring, the pinned entries of K1 and K4, K1's folded entry and its
#: refresh, K2's pinned ring, the fold entries' second form, K2's and K7's
#: pinned forms and their splits' parts)
NO_SPILL_KERNELS = ("11mega_kernel", "19sharded_mega_kernel",
                    "13packed_kernel", "18packed_mega_kernel",
                    "11ring_kernel", "13pinned_kernel",
                    "20packed_pinned_kernel", "18mega_pinned_kernel",
                    "25packed_mega_pinned_kernel",
                    "26sharded_mega_pinned_kernel",
                    "18folded_form_kernel",
                    "19fold_refresh_kernel", "18ring_pinned_kernel",
                    "20windowed_fold_kernel", "16mega_fold_kernel",
                    "18pinned_form_kernel", "17shard_form_kernel",
                    "20mega_pin_form_kernel", "23sharded_pin_form_kernel",
                    "15exchange_kernel")


def ptxas_report(log: str, kernels=REDESIGNED_KERNELS) -> list:
    """(function, registers, spill store bytes, spill load bytes, static
    shared bytes) of each instantiation of ``kernels`` in ptxas's report;
    the function from its kernel's name on (its template arguments
    mangled)."""
    rows, entry = [], None
    spills = (None, None)
    for line in log.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            entry = next((m.group(1)[m.group(1).index(k) + 2:]
                          for k in kernels if k in m.group(1)), None)
            spills = (None, None)
            continue
        if entry is None:
            continue
        m = PTXAS_SPILLS.search(line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = PTXAS_USED.search(line)
        if m:
            rows.append((entry, int(m.group(1)), *spills,
                         int(m.group(2) or 0)))
            entry = None
    return rows


def compare_microbench_kernels(checks: Checks, rng) -> None:
    """Phase 9a: K8 and K9 against their plain versions on the card, K9
    also against K3. K8 also at the entry point's call, 256 steps of 90
    ops at 1088x1920, both forms (the pass sequence of 30 rolls a step and
    its buffer parity); the ones that the entry point times are held in
    phase 9c. K9 at every shape of REDESIGNED_SHAPES (the splits that its
    tile rows allow), each of its ablation parts at 27 steps, and on states
    that hold NaN and +-Inf (bit for bit; every stencil and dt = 0.5, and
    each part on the default)."""
    for shape in OPLAT_SHAPES:
        x = torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32)
                             ).to(DEVICE)
        calls = [(4, n_ops) for n_ops in (15, 45)]
        if shape == OPLAT_SHAPES[0]:
            calls.append((oplat_script.STEPS, 90))
        for steps, n_ops in calls:
            for rolls in (False, True):
                checks.compare_one(
                    "oplat", oplat.chain(x, steps, n_ops, rolls),
                    oplat.chain_reference(x, steps, n_ops, rolls),
                    f"{shape[0]}x{shape[1]} steps={steps} n_ops={n_ops} "
                    f"rolls={rolls} (one launch)")
    consts = kernel_constants(Parameters())

    def k9(u0, v0, steps, consts, boundary, split, part=None):
        bufs = (u0.clone(), v0.clone(), torch.empty_like(u0),
                torch.empty_like(v0))
        if part is None:
            return ilpsplit.split_multistep(*bufs, steps, consts, boundary,
                                            split)[:2]
        return ilpsplit.split_ablation(*bufs, steps, consts, boundary, split,
                                       part)[:2]

    for shape in REDESIGNED_SHAPES:
        u0, v0 = (torch.from_numpy(rng.uniform(0.0, 1.0, shape)
                                   .astype(np.float32)).to(DEVICE)
                  for _ in range(2))
        splits = [s for s in SPLITS if s <= -(-shape[0] // ilpsplit.TILE)]
        for boundary in ("naive", "zero"):
            tag = f"{shape[0]}x{shape[1]} {boundary}"
            k3 = {steps: resident.multistep(
                u0.clone(), v0.clone(), torch.empty_like(u0),
                torch.empty_like(v0), steps, consts, boundary)[:2]
                for steps in (1, 27, 32)}
            for split in splits:
                u, v, done = u0, v0, 0
                for steps in (1, 27, 32):
                    u, v = ilpsplit.split_reference(
                        u, v, steps - done, consts, boundary, split,
                        quantum=ilpsplit.TILE)
                    done = steps
                    out = k9(u0, v0, steps, consts, boundary, split)
                    what = f"{tag} split={split} steps={steps} (one launch)"
                    checks.compare("ilpsplit", out, (u, v), what)
                    checks.compare("ilpsplit", out, k3[steps],
                                   f"{what} vs K3")
                    if steps != 27:
                        continue
                    for part, part_what in ilpsplit.ABLATIONS.items():
                        out = k9(u0, v0, steps, consts, boundary, split, part)
                        checks.compare("ilpsplit", out, (u, v),
                                       f"{what} with {part_what}")
                        checks.compare("ilpsplit", out, k3[steps],
                                       f"{what} with {part_what} vs K3")
    # states that hold NaN and +-Inf, in interior and edge tiles, on slab
    # seams and on the domain's edge: held bit for bit
    for shape in ((200, 300), MAIN_SHAPE):
        u0, v0 = (torch.from_numpy(rng.uniform(0.0, 1.0, shape)
                                   .astype(np.float32)).to(DEVICE)
                  for _ in range(2))
        u0[100, 150] = v0[0, 5] = float("nan")
        v0[90, 140] = u0[70, 200] = float("inf")
        u0[120, 7] = v0[-1, -1] = float("-inf")
        u0[64, 40] = v0[95, 33] = float("nan")  # next to tile-row seams
        splits = [s for s in SPLITS if s <= -(-shape[0] // ilpsplit.TILE)]
        for label, params in (("oono-puri", Parameters()), *OTHER_PARAMS):
            pco = kernel_constants(params)
            for boundary in ("naive", "zero"):
                k3 = resident.multistep(u0.clone(), v0.clone(),
                                        torch.empty_like(u0),
                                        torch.empty_like(v0), 3, pco,
                                        boundary)[:2]
                parts = [None]
                if label == "oono-puri":
                    parts += list(ilpsplit.ABLATIONS)
                for split in splits:
                    want = ilpsplit.split_reference(u0, v0, 3, pco, boundary,
                                                    split,
                                                    quantum=ilpsplit.TILE)
                    for part in parts:
                        what = (f"{shape[0]}x{shape[1]} {boundary} params="
                                f"{label} NaN and Inf, split={split} steps=3 "
                                "(one launch)")
                        if part is not None:
                            what += f" with {ilpsplit.ABLATIONS[part]}"
                        out = k9(u0, v0, 3, pco, boundary, split, part)
                        checks.compare_bits("ilpsplit", out, want, what)
                        checks.compare_bits("ilpsplit", out, k3,
                                            f"{what} vs K3")


def microbench_paths(checks: Checks, card: str) -> dict:
    """Phase 9b: the two entry points' sweeps, each with the launch counts
    zeroed before it and read after; every time beside the card's bound."""
    out = {}
    shape = OPLAT_SHAPES[0]
    reset_launches()
    records = oplat_script.sweep([shape], (15, 90), oplat_script.STEPS,
                                 DEVICE)
    launches = read_launches()
    want = {tag: 0 for tag in COUNTERS}
    want["oplat"] = 4 * len(records)  # a warm call and 3 timed ones each
    print(f"path scripts.oplat {shape[0]}x{shape[1]}: launches {launches} "
          f"(expected {want})", flush=True)
    checks.expect(launches == want, f"oplat sweep: launches {launches}, "
                  f"not {want}")
    out["oplat_launches"] = launches["oplat"]
    for rec in records:
        steps = oplat_script.STEPS
        ms = rec["us_per_step"] * steps * 1e-3
        bound, by = oplat_bound_ms(shape, steps, rec["n_ops"], rec["rolls"])
        out["oplat", rec["n_ops"], rec["rolls"]] = (ms, bound, by)
        print(f"time oplat {shape[0]}x{shape[1]} n_ops={rec['n_ops']} "
              f"rolls={rec['rolls']}, {steps} steps a launch: {ms!r} ms, "
              f"{rec['ns_per_op']!r} ns/op, {rec['ps_per_cell_op']!r} "
              f"ps/cell-op; bound {bound!r} ms ({by}), "
              f"{100 * bound / ms!r} % of it [{card}]", flush=True)
    for line in oplat_script.fits(records):
        print(f"{line} [{card}]", flush=True)

    reset_launches()
    runs = 0
    for shape in (MAIN_SHAPE, BENCH_SHAPE):
        for boundary in ("zero", "naive"):
            recs = ilpsplit_script.sweep(shape, boundary, SPLITS, MAIN_STEPS,
                                         DEVICE)
            runs += 1
            bound, by = bound_ms(shape, MAIN_STEPS, boundary)
            k3_ms = recs[0]["seconds"] * 1e3
            for rec in recs:
                ms = rec["seconds"] * 1e3
                label = ("resident (K3)" if rec["split"] is None
                         else f"split={rec['split']}")
                out["ilpsplit", shape, boundary, rec["split"]] = ms
                print(f"time ilpsplit {shape[0]}x{shape[1]} {boundary} "
                      f"{label}, {MAIN_STEPS} steps a launch: {ms!r} ms = "
                      f"{rec['gcells_per_sec']!r} Gcell/s, {k3_ms / ms!r}x "
                      f"K3; bound {bound!r} ms ({by}) [{card}]", flush=True)
    launches = read_launches()
    want = {tag: 0 for tag in COUNTERS}
    # each split: a 3-step check, a warm call and 3 timed ones; K3 the same
    want["ilpsplit"] = runs * len(SPLITS) * 5
    want["resident"] = runs * 5
    print(f"path scripts.ilpsplit: launches {launches} (expected {want})",
          flush=True)
    checks.expect(launches == want, f"ilpsplit sweep: launches {launches}, "
                  f"not {want}")
    out["ilpsplit_launches"] = launches["ilpsplit"]
    return out


def time_microbench_plain(checks: Checks, rng) -> dict:
    """Phase 9c: the plain versions of the calls that the kernels line
    reports: K8's 256 steps of 90 ops without rolls at 1088x1920 on the
    entry point's ones, whose result the kernel is held against, and K9's
    32 steps in 2 slabs at 1080x1920, zero boundary."""
    x = torch.ones(OPLAT_SHAPES[0], device=DEVICE)
    u, v = (torch.from_numpy(rng.uniform(0, 1, MAIN_SHAPE).astype(np.float32))
            .to(DEVICE) for _ in range(2))
    consts = kernel_constants(Parameters())
    plain = []
    out = {
        "oplat": cuda_ms(lambda: plain.append(oplat.chain_reference(
            x, oplat_script.STEPS, 90, False)), 1),
        "ilpsplit": cuda_ms(lambda: ilpsplit.split_reference(
            u, v, MAIN_STEPS, consts, "zero", 2, quantum=ilpsplit.TILE), 1),
    }
    checks.compare_one(
        "oplat", oplat.chain(x, oplat_script.STEPS, 90, False), plain[-1],
        f"{OPLAT_SHAPES[0][0]}x{OPLAT_SHAPES[0][1]} ones "
        f"steps={oplat_script.STEPS} n_ops=90 rolls=False (the timed call)")
    return out


def sharded_run(params: Parameters, boundary: str, u_np, v_np, mesh_shape,
                steps: int):
    """The sharded backend's state after ``steps`` steps on K7."""
    n_r, n_c = mesh_shape
    sim = ShardedSimulation(params, boundary, device=DEVICE, engine="mega",
                            n_devices=n_r * n_c, mesh_cols=n_c,
                            tuned_lookup=False)
    storage = sim.build_storage(u_np, v_np)
    assert sim.mesh.shape == tuple(mesh_shape)
    storage = sim.run_steps(storage, u_np.shape, steps)
    return sim.extract_uv(storage, u_np.shape)


def sharded_launches(params: Parameters, boundary: str, u_np, v_np,
                     mesh_shape, steps: int, tile=None,
                     read_site: bool = True):
    """K7 launch by launch as the backend makes them (the halo exchange,
    then ``steps // 8`` time blocks, then the remainder), on ``tile`` x
    ``tile`` tiles; ``tile`` "plain" runs the plain version instead;
    ``read_site=False`` gates every time block's entry on a row mesh
    too."""
    shape = u_np.shape
    consts = kernel_constants(params)
    mesh = halo.make_mesh(mesh_shape[0] * mesh_shape[1], mesh_shape[1],
                          DEVICE)
    pairs = halo.mega_shard_state(u_np, v_np, mesh)
    for n_blocks, k in sharded_mega.launch_plan(steps):
        for p in pairs:
            halo.exchange_halos(p)
        if tile == "plain":
            sharded_mega.sharded_megastep_reference(*pairs, n_blocks, k,
                                                    consts, boundary, shape)
        else:
            sharded_mega.sharded_megastep(*pairs, mesh, n_blocks, k, consts,
                                          boundary, shape,
                                          geometry=None if tile is None
                                          else geometry.Geometry(tile, tile,
                                                                 8),
                                          read_site=read_site)
    return tuple(halo.mega_unshard_result(p, shape) for p in pairs)


def compare_sharded(checks: Checks, rng) -> int:
    """Phase 10a: K7 on both tile geometries (launch by launch as the
    backend makes them) against its plain version on the card and against
    K2, on every mesh of SHARDED_MESHES at 1080x1920 and 1000x1917 (8, 27
    and 32 steps), on 1001x1920 (its last row of shards partly past the
    domain; 27 steps) and at 4096x4096 (32 steps) on 4x1 and 2x2, both
    boundaries; through the backend (the geometry it picks) at the first of
    those step counts. Then, on 2x2 at 1080x1920, the other stencils and
    dt = 0.5 (27 steps) and states that hold NaN and +-Inf (3 steps, bit for
    bit), both geometries. Returns the comparisons."""
    default = Parameters()
    cases = [(shape, mesh, (8, 27, 32)) for shape in SHAPES[:2]
             for mesh in SHARDED_MESHES]
    cases += [(PAST_EDGE_SHAPE, mesh, (27,)) for mesh in ((4, 1), (2, 2))]
    cases += [(BENCH_SHAPE, mesh, (MAIN_STEPS,)) for mesh in ((4, 1), (2, 2))]
    inputs, k2, n = {}, {}, 0
    for shape, mesh_shape, step_counts in cases:
        if shape not in inputs:
            inputs[shape] = tuple(rng.uniform(0.0, 1.0, shape)
                                  .astype(np.float32) for _ in range(2))
        u_np, v_np = inputs[shape]
        for boundary in ("naive", "zero"):
            for steps in step_counts:
                key = (shape, boundary, steps)
                if key not in k2:
                    k2[key] = engine_run("mega", default, boundary, u_np,
                                         v_np, steps)
                plain = sharded_launches(default, boundary, u_np, v_np,
                                         mesh_shape, steps, "plain")
                what = (f"{shape[0]}x{shape[1]} {boundary} mesh "
                        f"{mesh_shape[0]}x{mesh_shape[1]} steps={steps}")
                runs = {f"{t}x{t} tiles": sharded_launches(
                    default, boundary, u_np, v_np, mesh_shape, steps, t)
                    for t in sharded_mega.TILES}
                if steps == step_counts[0]:
                    runs["backend"] = sharded_run(default, boundary, u_np,
                                                  v_np, mesh_shape, steps)
                for label, got in runs.items():
                    checks.compare("shmega", got, plain, f"{what} ({label})")
                    checks.compare("shmega", got, k2[key],
                                   f"{what} ({label}) vs K2")
                    n += 2
    shape, mesh_shape = MAIN_SHAPE, (2, 2)
    u_np, v_np = (rng.uniform(0.0, 1.0, shape).astype(np.float32)
                  for _ in range(2))
    for label, params in OTHER_PARAMS:
        for boundary in ("naive", "zero"):
            want = engine_run("mega", params, boundary, u_np, v_np, 27)
            plain = sharded_launches(params, boundary, u_np, v_np,
                                     mesh_shape, 27, "plain")
            for t in sharded_mega.TILES:
                got = sharded_launches(params, boundary, u_np, v_np,
                                       mesh_shape, 27, t)
                what = (f"{shape[0]}x{shape[1]} {boundary} mesh 2x2 "
                        f"params={label} steps=27 ({t}x{t} tiles)")
                # bit for bit: pretty's state overflows within 27 steps
                checks.compare_bits("shmega", got, plain, what)
                checks.compare_bits("shmega", got, want, f"{what} vs K2")
                n += 2
    r_loc, c_loc = halo.shard_extents(shape, halo.Mesh(*mesh_shape, None))
    u_np[100, 150] = v_np[0, 5] = np.nan
    v_np[r_loc - 1, c_loc - 1] = u_np[r_loc, c_loc] = np.inf  # at the seams
    u_np[120, 7] = v_np[-1, -1] = -np.inf
    u_np[r_loc + 60, c_loc + 1] = np.nan
    consts = kernel_constants(default)
    u0, v0 = (torch.from_numpy(x).to(DEVICE) for x in (u_np, v_np))
    for boundary in ("naive", "zero"):
        want = stencil.run(u0, v0, 3, consts, boundary)
        plain = sharded_launches(default, boundary, u_np, v_np, mesh_shape,
                                 3, "plain")
        pu, pv = megakernel.pair_state(u0), megakernel.pair_state(v0)
        megakernel.megastep(pu, pv, 1, 3, consts, boundary)
        for t in sharded_mega.TILES:
            got = sharded_launches(default, boundary, u_np, v_np, mesh_shape,
                                   3, t)
            what = (f"{shape[0]}x{shape[1]} {boundary} mesh 2x2 NaN and Inf, "
                    f"steps=3 ({t}x{t} tiles)")
            checks.compare_bits("shmega", got, plain, what)
            checks.compare_bits("shmega", got, want, f"{what} vs plain step")
            checks.compare_bits("shmega", got, (pu[0], pv[0]),
                                f"{what} vs K2")
            n += 3
    return n


def sharded_paths(checks: Checks) -> dict:
    """Phase 10b: ``simulate --backend sharded --sharded-engine mega
    --sharded-devices 4`` on the default run, on the default mesh and on
    each form pinned, with the launch counts zeroed before each and read
    after; every frame against the plain replay of the unsharded run."""
    ns = simulate.build_parser().parse_args([])
    replay = replay_frames(MAIN_SHAPE, "naive", shared.simulation_parameters(
        ns), MAIN_IMAGES, MAIN_STEPS, DEVICE)
    runs = {}
    for flags in SHARDED_PATHS:
        run = simulate_path(checks, SHARDED_FLAGS + flags, replay)
        print(f"path simulate {' '.join(SHARDED_FLAGS + flags)}: storage "
              f"{run['tag']}, mesh {run['mesh']}", flush=True)
        runs[" ".join(flags) or "auto"] = run
    checks.expect(runs["auto"]["mesh"] == (2, 2)
                  and runs["--sharded-mesh-cols 1"]["mesh"] == (4, 1),
                  "sharded simulate meshes")
    return runs


def exchange_cells(shape, mesh_shape) -> int:
    """Cells one time block of K7 pushes, both species: every present
    neighbour's band (HALO rows across the interior columns, COL_HALO
    columns across the interior rows, HALO x COL_HALO corners)."""
    n_r, n_c = mesh_shape
    mesh = halo.Mesh(n_r, n_c, torch.device("cpu"))
    r_loc, c_loc = halo.shard_extents(shape, mesh)
    cells = 0
    for i in range(n_r):
        for j in range(n_c):
            for dr, dc in halo.DIRECTIONS:
                if 0 <= i + dr < n_r and 0 <= j + dc < n_c:
                    cells += ((halo.HALO if dr else r_loc)
                              * (mesh.chalo if dc else c_loc))
    return 2 * cells


def sharded_bound_ms(shape, mesh_shape, steps: int,
                     boundary: str) -> tuple[float, str]:
    """The least time for K7's call: K2's (the state read and written once,
    the oracle's operations) plus the pushes' bytes, each cell read and
    written once (8 B) a time block."""
    cells = shape[0] * shape[1]
    pushed = exchange_cells(shape, mesh_shape) * -(-steps // 8)
    by_bytes = (16 * cells + 8 * pushed) / PEAK_BYTES
    by_ops = cells * steps * ops_per_cell_step(Parameters(), boundary) \
        / PEAK_F32_UNFUSED
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def time_sharded(rng, card: str) -> dict:
    """Phase 10c: one K7 launch of 32 steps (4 time blocks) on 1x1, 4x1 and
    2x2 meshes, on both tile geometries, timed in turns with K2 through its
    backend and K2's first-stepper kernel (K2, K2 part 0, then each mesh
    and geometry, then back), at 1080x1920 and 4096x4096, both boundaries;
    which geometry won on each mesh, beside the one the wrapper picks; the
    sharded backend's call (the exchange and the launch) on each mesh; the
    tiles and rounds of each mesh; the plain version once."""
    consts = kernel_constants(Parameters())
    out = {}
    meshes = [(1, 1), (4, 1), (2, 2)]
    dev = torch.device(DEVICE)
    coresident = {t: sharded_mega.max_blocks(dev, t)
                  for t in sharded_mega.TILES}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape, reps in ((MAIN_SHAPE, 40), (BENCH_SHAPE, 8)):
        u_np, v_np = (rng.uniform(0, 1, shape).astype(np.float32)
                      for _ in range(2))
        k2_tiles = -(-shape[0] // 64) * -(-shape[1] // 64)
        for n_r, n_c in meshes:
            mesh = halo.Mesh(n_r, n_c, torch.device("cpu"))
            r_loc, c_loc = halo.shard_extents(shape, mesh)
            for t in sharded_mega.TILES:
                tiles = -(-r_loc // t) * -(-c_loc // t)
                print(f"tiles {shape[0]}x{shape[1]} mesh {n_r}x{n_c} {t}x{t}: "
                      f"shards {r_loc}x{c_loc}, {tiles} tiles a shard, "
                      f"{n_r * n_c * tiles} in all, "
                      f"{sharded_mega.tile_rounds(shape, (n_r, n_c), t, coresident[t])}"
                      f" rounds on {coresident[t]} co-resident blocks (K2: "
                      f"{k2_tiles} tiles of 64x64, "
                      f"{-(-k2_tiles // min(k2_tiles, megakernel.max_blocks(dev)))}"
                      f" rounds); cells stepped past the domain "
                      f"{100 * (1 - shape[0] * shape[1] / (n_r * n_c * tiles * t * t))!r} "
                      f"%; pushed {exchange_cells(shape, (n_r, n_c))} cells a "
                      "time block", flush=True)
            print(f"tiles {shape[0]}x{shape[1]} mesh {n_r}x{n_c}: the wrapper "
                  "picks "
                  f"{sharded_mega.choose_tile(shape, (n_r, n_c), coresident, sms)}"
                  f"x (co-resident {coresident}, {sms} SMs)", flush=True)
        for boundary in ("naive", "zero"):
            k2 = CudaSimulation(Parameters(), boundary, device=DEVICE,
                                engine="mega", tuned_lookup=False)
            box = [k2.build_storage(u_np, v_np)]

            def k2_call(k2=k2, box=box):
                box[0] = k2.run_steps(box[0], shape, MAIN_STEPS)

            old = [megakernel.pair_state(torch.from_numpy(x).to(DEVICE))
                   for x in (u_np, v_np)]

            def k2_first(old=old, boundary=boundary):
                megakernel.megastep_ablation(*old, MAIN_STEPS // 8, 8, consts,
                                             boundary, 0)

            calls, sims = {"K2": k2_call, "K2 part 0": k2_first}, {}
            for n_r, n_c in meshes:
                mesh = halo.make_mesh(n_r * n_c, n_c, DEVICE)
                for t in sharded_mega.TILES:
                    pairs = halo.mega_shard_state(u_np, v_np, mesh)
                    for p in pairs:
                        halo.exchange_halos(p)

                    def k7_call(pairs=pairs, mesh=mesh, boundary=boundary,
                                t=t):
                        sharded_mega.sharded_megastep(
                            *pairs, mesh, MAIN_STEPS // 8, 8, consts,
                            boundary, shape,
                            geometry=geometry.Geometry(t, t, 8))

                    calls[f"K7 {n_r}x{n_c} {t}"] = k7_call
                sims[n_r, n_c] = ShardedSimulation(
                    Parameters(), boundary, device=DEVICE, engine="mega",
                    n_devices=n_r * n_c, mesh_cols=n_c, tuned_lookup=False)
            samples = {name: [] for name in calls}
            for name in [*calls, *reversed(calls)]:
                samples[name].append(cuda_ms(calls[name], reps))
            for name, pair in samples.items():
                ms = sum(pair) / len(pair)
                mesh_shape = (1, 1) if name.startswith("K2") else tuple(
                    int(x) for x in name.split()[1].split("x"))
                bound, by = (bound_ms(shape, MAIN_STEPS, boundary)
                             if name.startswith("K2") else sharded_bound_ms(
                                 shape, mesh_shape, MAIN_STEPS, boundary))
                out[shape, boundary, name] = (ms, bound, by)
                print(f"time {name} {shape[0]}x{shape[1]} {boundary}, "
                      f"{MAIN_STEPS} steps a launch: {ms!r} ms (turns "
                      f"{pair!r}) = {gcells(shape, MAIN_STEPS, ms)!r} "
                      f"Gcell/s, {ms / out[shape, boundary, 'K2'][0]!r}x "
                      f"K2; bound {bound!r} ms ({by}) [{card}]", flush=True)
            for n_r, n_c in meshes:
                ms = {t: out[shape, boundary, f"K7 {n_r}x{n_c} {t}"][0]
                      for t in sharded_mega.TILES}
                picked = sharded_mega.choose_tile(shape, (n_r, n_c),
                                                  coresident, sms)
                out[shape, boundary, f"K7 {n_r}x{n_c}"] = \
                    out[shape, boundary, f"K7 {n_r}x{n_c} {picked}"]
                print(f"geometry {shape[0]}x{shape[1]} {boundary} mesh "
                      f"{n_r}x{n_c}: {min(ms, key=ms.get)}x tiles won "
                      f"({ms}); the wrapper picks {picked} [{card}]",
                      flush=True)
            for mesh_shape, sim in sims.items():
                box = [sim.build_storage(u_np, v_np)]

                def call(sim=sim, box=box):
                    box[0] = sim.run_steps(box[0], shape, MAIN_STEPS)

                ms = cuda_ms(call, reps)
                out[shape, boundary, "backend", mesh_shape] = ms
                print(f"time sharded backend {shape[0]}x{shape[1]} "
                      f"{boundary} mesh {mesh_shape[0]}x{mesh_shape[1]}, "
                      f"{MAIN_STEPS} steps a call (exchange + K7): {ms!r} "
                      f"ms [{card}]", flush=True)
    mesh = halo.make_mesh(4, 2, DEVICE)
    pairs = halo.mega_shard_state(*initial_uv(MAIN_SHAPE), mesh)
    for p in pairs:
        halo.exchange_halos(p)
    out["plain"] = cuda_ms(lambda: sharded_mega.sharded_megastep_reference(
        *pairs, MAIN_STEPS // 8, 8, consts, "naive", MAIN_SHAPE), 1)
    print(f"time plain sharded {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} naive mesh "
          f"2x2, {MAIN_STEPS} steps: {out['plain']!r} ms [{card}]",
          flush=True)
    return out


def windowed_launches(params: Parameters, boundary: str, u_np, v_np,
                      mesh_shape, steps: int, mode: str):
    """K1's shard entry launch by launch as the backend makes them: per
    block of 8 steps and the remainder, the exchange of the current slot,
    then the block's launches, then the slot flips. ``mode``: "serial" one
    launch of every tile, "overlap" the overlap-interior launch then the
    edge launch (in order, on one stream), "plain" the plain version."""
    shape = u_np.shape
    consts = kernel_constants(params)
    mesh = halo.make_mesh(mesh_shape[0] * mesh_shape[1], mesh_shape[1],
                          DEVICE)
    pairs = halo.mega_shard_state(u_np, v_np, mesh)
    slot = 0
    n_full, rem = divmod(steps, windowed.K)
    for k in [windowed.K] * n_full + ([rem] if rem else []):
        for p in pairs:
            halo.exchange_halos(p, slot)
        if mode == "plain":
            windowed.shard_multistep_reference(*pairs, slot, k, consts,
                                               boundary, shape)
        else:
            for part in (("interior", "edge") if mode == "overlap"
                         else ("all",)):
                windowed.shard_multistep(*pairs, mesh, slot, k, consts,
                                         boundary, shape, part=part)
        slot = 1 - slot
    return tuple(halo.mega_unshard_result(p, shape, slot) for p in pairs)


def windowed_sim(params: Parameters, boundary: str, mesh_shape,
                 overlap: str) -> ShardedSimulation:
    n_r, n_c = mesh_shape
    return ShardedSimulation(params, boundary, device=DEVICE,
                             engine="windowed", n_devices=n_r * n_c,
                             mesh_cols=n_c, overlap=overlap,
                             tuned_lookup=False)


def windowed_run(params: Parameters, boundary: str, u_np, v_np, mesh_shape,
                 steps: int, overlap: str):
    """The backend's state after ``steps`` steps on the windowed engine
    (with ``overlap`` on: the exchange on the simulation's copy stream)."""
    sim = windowed_sim(params, boundary, mesh_shape, overlap)
    storage = sim.build_storage(u_np, v_np)
    assert sim.mesh.shape == tuple(mesh_shape)
    storage = sim.run_steps(storage, u_np.shape, steps)
    return sim.extract_uv(storage, u_np.shape)


def compare_windowed(checks: Checks, rng) -> int:
    """Phase 10a: K1's shard entry launch by launch as the backend makes
    them, serialized and split for overlap, against its plain version on
    the card and against unsharded K1, on every mesh of WINDOWED_MESHES at
    1080x1920 and 1000x1917 (8, 27 and 32 steps) and 1001x1920 (27), and
    at 4096x4096 on 4x1 and 2x2 (32), both boundaries; the split against
    the serialized run at 0.0; through the backend, overlap off and on (the
    copy stream), at the first step count. Then the other stencils and
    dt = 0.5 on 2x2 (27 steps), and states that hold NaN and +-Inf on every
    mesh (27 steps), bit for bit. Returns the comparisons."""
    default = Parameters()
    cases = [(shape, mesh, (8, 27, 32)) for shape in SHAPES[:2]
             for mesh in WINDOWED_MESHES]
    cases += [(PAST_EDGE_SHAPE, mesh, (27,)) for mesh in WINDOWED_MESHES]
    cases += [(BENCH_SHAPE, mesh, (MAIN_STEPS,)) for mesh in ((4, 1), (2, 2))]
    inputs, k1, n = {}, {}, 0
    for shape, mesh_shape, step_counts in cases:
        if shape not in inputs:
            inputs[shape] = tuple(rng.uniform(0.0, 1.0, shape)
                                  .astype(np.float32) for _ in range(2))
        u_np, v_np = inputs[shape]
        r_loc, c_loc = halo.shard_extents(shape, halo.Mesh(*mesh_shape,
                                                           None))
        engages = halo.overlap_engages(r_loc, c_loc, mesh_shape[1])
        checks.expect(engages, f"overlap engages at {shape} on {mesh_shape}")
        for boundary in ("naive", "zero"):
            for steps in step_counts:
                key = (shape, boundary, steps)
                if key not in k1:
                    k1[key] = engine_run("windowed", default, boundary, u_np,
                                         v_np, steps)
                what = (f"{shape[0]}x{shape[1]} {boundary} mesh "
                        f"{mesh_shape[0]}x{mesh_shape[1]} steps={steps}")
                plain = windowed_launches(default, boundary, u_np, v_np,
                                          mesh_shape, steps, "plain")
                runs = {"launches": windowed_launches(
                    default, boundary, u_np, v_np, mesh_shape, steps,
                    "serial")}
                runs["interior + edge"] = windowed_launches(
                    default, boundary, u_np, v_np, mesh_shape, steps,
                    "overlap")
                if steps == step_counts[0]:
                    for overlap in ("off", "on"):
                        runs[f"backend overlap {overlap}"] = windowed_run(
                            default, boundary, u_np, v_np, mesh_shape,
                            steps, overlap)
                for label, got in runs.items():
                    checks.compare("shwin", got, plain, f"{what} ({label})")
                    checks.compare("shwin", got, k1[key],
                                   f"{what} ({label}) vs K1")
                    checks.compare("shwin", got, runs["launches"],
                                   f"{what} ({label}) vs serialized")
                    n += 3
    shape = MAIN_SHAPE
    u_np, v_np = (rng.uniform(0.0, 1.0, shape).astype(np.float32)
                  for _ in range(2))
    for label, params in OTHER_PARAMS:
        for boundary in ("naive", "zero"):
            want = engine_run("windowed", params, boundary, u_np, v_np, 27)
            plain = windowed_launches(params, boundary, u_np, v_np, (2, 2),
                                      27, "plain")
            for mode in ("serial", "overlap"):
                got = windowed_launches(params, boundary, u_np, v_np, (2, 2),
                                        27, mode)
                what = (f"{shape[0]}x{shape[1]} {boundary} mesh 2x2 "
                        f"params={label} steps=27 ({mode})")
                checks.compare_bits("shwin", got, plain, what)
                checks.compare_bits("shwin", got, want, f"{what} vs K1")
                n += 2
    r_loc, c_loc = halo.shard_extents(shape, halo.Mesh(2, 2, None))
    u_np[100, 150] = v_np[0, 5] = np.nan
    v_np[r_loc - 1, c_loc - 1] = u_np[r_loc, c_loc] = np.inf  # at the seams
    u_np[120, 7] = v_np[-1, -1] = -np.inf
    u_np[r_loc + 60, c_loc + 1] = np.nan
    for n_r, n_c in WINDOWED_MESHES:  # on every mesh's seams
        r_seam, c_seam = halo.shard_extents(shape, halo.Mesh(n_r, n_c, None))
        if n_r > 1:
            u_np[r_seam, shape[1] // 2] = np.inf
        if n_c > 1:
            v_np[shape[0] - 1, c_seam] = np.nan
    for boundary in ("naive", "zero"):
        want = engine_run("windowed", default, boundary, u_np, v_np, 27)
        for mesh_shape in WINDOWED_MESHES:
            plain = windowed_launches(default, boundary, u_np, v_np,
                                      mesh_shape, 27, "plain")
            for mode in ("serial", "overlap"):
                got = windowed_launches(default, boundary, u_np, v_np,
                                        mesh_shape, 27, mode)
                what = (f"{shape[0]}x{shape[1]} {boundary} mesh "
                        f"{mesh_shape[0]}x{mesh_shape[1]} NaN and Inf, "
                        f"steps=27 ({mode})")
                checks.compare_bits("shwin", got, plain, what)
                checks.compare_bits("shwin", got, want, f"{what} vs K1")
                n += 2
    return n


def shipped_sharded(shape, boundary: str = "naive") -> dict | None:
    """The record the package ships for ``shape`` in 4 shards, no pin, on
    this card (``bench/defaults.py:SHARDED``)."""
    return defaults.SHARDED.get(autotune.sharded_key(
        Parameters(), shape, boundary, n_devices=4, device=DEVICE))


def windowed_paths(checks: Checks) -> dict:
    """Phase 10b: ``simulate --backend sharded --sharded-devices 4`` on the
    default run with no engine pin (the shipped record's engine, else
    windowed), with ``--sharded-engine windowed`` and with
    ``--sharded-overlap on``, each on the default mesh and on each form of
    SHARDED_PATHS, with the launch counts zeroed before each and read
    after: 4 launches of K1's shard entry an image, 8 where the split
    engages, and no other kernel (simulate_path); every frame against the
    plain replay of the unsharded run."""
    ns = simulate.build_parser().parse_args([])
    replay = replay_frames(MAIN_SHAPE, "naive", shared.simulation_parameters(
        ns), MAIN_IMAGES, MAIN_STEPS, DEVICE)
    rec = shipped_sharded(MAIN_SHAPE)
    print(f"path simulate sharded: the shipped record of "
          f"{MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} in 4 shards: {rec}", flush=True)
    runs = {}
    for label, base in WINDOWED_FLAGS.items():
        for flags in SHARDED_PATHS:
            run = simulate_path(checks, base + flags, replay)
            name = f"{label} {' '.join(flags)}".strip()
            runs[name] = run
            if label == "auto" and not flags and rec:
                want = ("shwin" if rec["engine"] == "windowed" else "shmega",
                        (4 // rec["mesh_cols"], rec["mesh_cols"]),
                        bool(rec.get("overlap")))
            else:
                want = ("shwin", (4, 1) if flags[-1:] == ["1"] else (2, 2),
                        label == "overlap")
            got = (run["engine"], run["mesh"], run["split"])
            print(f"path simulate {' '.join(base + flags)}: storage "
                  f"{run['tag']}, mesh {run['mesh']}, split {run['split']} "
                  f"(expected {want})", flush=True)
            checks.expect(got == want, f"simulate {name}: ran {got}, not "
                          f"{want}")
    return runs


def time_windowed(rng, card: str) -> dict:
    """Phase 10c: the windowed engine's call (the exchange and the
    launches of 32 steps, through the backend) with overlap off and on, on
    1x1, 4x1, 2x2 and 1x4 meshes, timed in turns with K7 (the geometry
    its wrapper picks) on each and with the unsharded K1 (four launches
    through the cuda backend), at 1080x1920 and 4096x4096, both
    boundaries, each beside its bound; one launch of K1's shard entry (8
    steps, every tile, on exchanged pairs) beside one launch of K1; the
    plain version once."""
    consts = kernel_constants(Parameters())
    out = {}
    for shape, reps in ((MAIN_SHAPE, 40), (BENCH_SHAPE, 8)):
        u_np, v_np = (rng.uniform(0, 1, shape).astype(np.float32)
                      for _ in range(2))
        for boundary in ("naive", "zero"):
            calls = {}

            def backend_call(sim):
                box = [sim.build_storage(u_np, v_np)]

                def call():
                    box[0] = sim.run_steps(box[0], shape, MAIN_STEPS)
                return call

            calls["K1"] = backend_call(CudaSimulation(
                Parameters(), boundary, device=DEVICE, engine="windowed",
                tuned_lookup=False))
            u_d, v_d = (torch.from_numpy(x).to(DEVICE) for x in (u_np, v_np))
            u_o, v_o = torch.empty_like(u_d), torch.empty_like(v_d)
            calls["K1 launch"] = lambda u_d=u_d, v_d=v_d, u_o=u_o, v_o=v_o, \
                boundary=boundary: windowed.multistep(
                    u_d, v_d, u_o, v_o, windowed.K, consts, boundary)
            for mesh_shape in WINDOWED_MESHES:
                tag = f"{mesh_shape[0]}x{mesh_shape[1]}"
                for overlap in ("off", "on"):
                    calls[f"K1w {tag} {overlap}"] = backend_call(
                        windowed_sim(Parameters(), boundary, mesh_shape,
                                     overlap))
                calls[f"K7 {tag}"] = backend_call(ShardedSimulation(
                    Parameters(), boundary, device=DEVICE, engine="mega",
                    n_devices=mesh_shape[0] * mesh_shape[1],
                    mesh_cols=mesh_shape[1], tuned_lookup=False))
                mesh = halo.make_mesh(mesh_shape[0] * mesh_shape[1],
                                      mesh_shape[1], DEVICE)
                pairs = halo.mega_shard_state(u_np, v_np, mesh)
                for p in pairs:
                    halo.exchange_halos(p)
                calls[f"K1 shard launch {tag}"] = \
                    lambda pairs=pairs, mesh=mesh, boundary=boundary: \
                    windowed.shard_multistep(*pairs, mesh, 0, windowed.K,
                                             consts, boundary, shape)
            samples = {name: [] for name in calls}
            for name in [*calls, *reversed(calls)]:
                samples[name].append(cuda_ms(calls[name], reps))
            for name, pair in samples.items():
                ms = sum(pair) / len(pair)
                if "launch" in name:
                    steps, (bound, by) = windowed.K, bound_ms(
                        shape, windowed.K, boundary)
                elif name == "K1":
                    steps, (bound, by) = MAIN_STEPS, bound_ms(
                        shape, MAIN_STEPS, boundary)
                else:
                    mesh_shape = tuple(int(x) for x in
                                       name.split()[1].split("x"))
                    steps, (bound, by) = MAIN_STEPS, sharded_bound_ms(
                        shape, mesh_shape, MAIN_STEPS, boundary)
                out[shape, boundary, name] = (ms, bound, by)
                print(f"time {name} {shape[0]}x{shape[1]} {boundary}, "
                      f"{steps} steps a call: {ms!r} ms (turns {pair!r}) = "
                      f"{gcells(shape, steps, ms)!r} Gcell/s; bound "
                      f"{bound!r} ms ({by}) [{card}]", flush=True)
            for mesh_shape in WINDOWED_MESHES:
                tag = f"{mesh_shape[0]}x{mesh_shape[1]}"
                off = out[shape, boundary, f"K1w {tag} off"][0]
                on = out[shape, boundary, f"K1w {tag} on"][0]
                k7 = out[shape, boundary, f"K7 {tag}"][0]
                print(f"windowed {shape[0]}x{shape[1]} {boundary} mesh "
                      f"{tag}: overlap on / off {on / off!r}x, off / K7 "
                      f"{off / k7!r}x, off / K1 "
                      f"{off / out[shape, boundary, 'K1'][0]!r}x [{card}]",
                      flush=True)
    mesh = halo.make_mesh(4, 2, DEVICE)
    pairs = halo.mega_shard_state(*initial_uv(MAIN_SHAPE), mesh)
    for p in pairs:
        halo.exchange_halos(p)
    out["plain"] = cuda_ms(lambda: windowed.shard_multistep_reference(
        *pairs, 0, windowed.K, consts, "naive", MAIN_SHAPE), 1)
    print(f"time plain windowed shard {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} naive "
          f"mesh 2x2, {windowed.K} steps: {out['plain']!r} ms [{card}]",
          flush=True)
    return out


def run_frames(flags: list, images: int, snapshot_dtype: str = "float32"):
    """A default ``simulate`` run (with ``flags``) of ``images`` images
    through ``simulate.run``, with the launch counts zeroed before it and
    read after: (frames, launches, simulation, species)."""
    ns = simulate.build_parser().parse_args(flags)
    sim = shared.make_simulation(ns)
    species = sim.make_species(shared.domain_shape(ns))
    frames: list[np.ndarray] = []
    torch.cuda.synchronize()
    reset_launches()
    simulate.run(sim, species, images, MAIN_STEPS, frames.append,
                 snapshot_dtype)
    torch.cuda.synchronize()
    return frames, read_launches(), sim, species


def frames_err(got, want) -> float:
    """max |difference| over two lists of frames, NaN as inf."""
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    return err if err == err else float("inf")


def ladder_paths(checks: Checks) -> None:
    """Phase 11a: each rung at the default shape, both boundaries, for
    RUNG_IMAGES images, beside the ``cuda`` backend on ``auto`` unpacked
    (``--pallas-pack off``: a zero-boundary record may pack, and the
    packed tree rounds otherwise): naive bitwise to cuda, fused bitwise to
    regular, regular, fused and conv within RUNG_TOL of naive, and no
    hand-written kernel launched by a rung. Then conv on the card against
    conv on the CPU (TF32 off)."""
    no_launches = {tag: 0 for tag in COUNTERS}
    for boundary in ("naive", "zero"):
        flags = ["--boundary", boundary]
        cuda_frames, launches, _, species = run_frames(
            [*flags, "--pallas-pack", "off"], RUNG_IMAGES)
        engine = KERNEL_OF.get(species.storage[0], species.storage[0])
        want = dict(no_launches)
        want[engine] = expected_launches(engine, RUNG_IMAGES, MAIN_STEPS)
        checks.expect(launches == want, f"cuda auto {boundary}: launches "
                      f"{launches}, not {want}")
        frames = {}
        for rung in RUNGS:
            frames[rung], launches, sim, _ = run_frames(
                ["--backend", rung, *flags], RUNG_IMAGES)
            checks.expect(launches == no_launches,
                          f"{rung} {boundary} launched {launches}")
            checks.expect(len(frames[rung]) == RUNG_IMAGES and all(
                f.shape == MAIN_SHAPE and f.dtype == np.float32
                and np.isfinite(f).all() for f in frames[rung]),
                f"{rung} {boundary}: frame count, shape, dtype or "
                "finiteness")
            print(f"ladder {rung} {boundary}: {RUNG_IMAGES} images x "
                  f"{MAIN_STEPS} steps at {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}, "
                  f"launches {launches}, graph captures "
                  f"{getattr(sim, 'captures', '-')}", flush=True)
        err = frames_err(frames["naive"], cuda_frames)
        print(f"ladder naive vs cuda auto ({engine}) {boundary}, every "
              f"frame: max|dV|={err!r}", flush=True)
        checks.expect(err == 0.0, f"naive vs cuda auto {boundary}")
        err = frames_err(frames["fused"], frames["regular"])
        print(f"ladder fused vs regular {boundary}, every frame: "
              f"max|dV|={err!r}", flush=True)
        checks.expect(err == 0.0, f"fused vs regular {boundary}")
        for rung in ("regular", "fused", "conv"):
            err = frames_err(frames[rung][-1:], frames["naive"][-1:])
            print(f"ladder {rung} vs naive {boundary}, after "
                  f"{RUNG_IMAGES * MAIN_STEPS} steps: max|dV|={err!r} "
                  f"(limit {RUNG_TOL!r})", flush=True)
            checks.expect(err <= RUNG_TOL, f"{rung} vs naive {boundary}")
        conv = {}
        for device in ("card", "cpu"):
            sim = get_backend("conv")(Parameters(), boundary, device=(
                DEVICE if device == "card" else "cpu"))
            species = sim.make_species(CONV_SHAPE)
            sim.perform_steps(species, MAIN_STEPS)
            conv[device] = species.uv_host()
        err = frames_err(conv["card"], conv["cpu"])
        print(f"ladder conv on the card vs the CPU {boundary}, "
              f"{CONV_SHAPE[0]}x{CONV_SHAPE[1]} x {MAIN_STEPS} steps: "
              f"max|d(U,V)|={err!r} (limit {CONV_TOL!r}; cuDNN allow_tf32 "
              f"left at {torch.backends.cudnn.allow_tf32})", flush=True)
        checks.expect(err <= CONV_TOL, f"conv card vs CPU {boundary}")


def resume_paths(checks: Checks) -> None:
    """Phase 11b: RESUME_IMAGES images, then ``uv_host``,
    ``build_storage`` and RESUME_IMAGES more, against an uninterrupted
    run of twice as many images, at 0.0 (the in-memory part of --resume
    and --checkpoint); then bf16 snapshots against the float32 frames
    rounded through bf16."""
    for label, flags in RESUME_PATHS.items():
        straight, launches, sim, _ = run_frames(flags, 2 * RESUME_IMAGES)
        first, _, sim, species = run_frames(flags, RESUME_IMAGES)
        u, v = species.uv_host()
        resumed = Species(u.shape, sim.build_storage(u, v), sim)
        resumed.steps_performed = species.steps_performed
        second: list[np.ndarray] = []
        simulate.run(sim, resumed, RESUME_IMAGES, MAIN_STEPS,
                     second.append)
        torch.cuda.synchronize()
        err = frames_err(first + second, straight)
        tag = species.storage[0]
        print(f"resume {label} ({tag if isinstance(tag, str) else sim.name}"
              f"): {RESUME_IMAGES} + {RESUME_IMAGES} images against "
              f"{2 * RESUME_IMAGES} straight (launches {launches}), every "
              f"frame: max|dV|={err!r}; steps {resumed.steps_performed}",
              flush=True)
        checks.expect(err == 0.0 and len(second) == RESUME_IMAGES
                      and resumed.steps_performed
                      == 2 * RESUME_IMAGES * MAIN_STEPS,
                      f"resume {label}")
    f32, _, _, _ = run_frames([], RUNG_IMAGES)
    bf16, launches, _, _ = run_frames([], RUNG_IMAGES, "bfloat16")
    rounded = [torch.from_numpy(f).to(torch.bfloat16).float().numpy()
               for f in f32]
    same = all(b.dtype == np.float32 and np.array_equal(
        b.view(np.int32), r.view(np.int32)) for b, r in zip(bf16, rounded))
    print(f"bf16 snapshots on auto, {RUNG_IMAGES} images: the float32 "
          f"frames rounded through bf16 bit for bit {same}; max|bf16 - "
          f"f32| {frames_err(bf16, f32)!r}; launches {launches}",
          flush=True)
    checks.expect(same and len(bf16) == RUNG_IMAGES, "bf16 snapshots")


def time_ladder(card: str) -> dict:
    """Phase 11c: each rung and ``cuda`` on ``auto``, ms an image of
    MAIN_STEPS steps at the default shape and boundary through
    ``simulate.run``, RUNG_IMAGES images a run, on the host clock ending in
    a device synchronise; one warm run each (the graphs' captures), then
    LADDER_ROUNDS rounds in turns (``bench/ladder.py:ladder_ms``). The
    median of the runs."""
    runs = ladder.ladder_ms(ladder.LABELS, MAIN_SHAPE, MAIN_STEPS,
                            RUNG_IMAGES, LADDER_ROUNDS, device=DEVICE)
    ms = {label: statistics.median(r) for label, r in runs.items()}
    cells = MAIN_SHAPE[0] * MAIN_SHAPE[1] * MAIN_STEPS
    print(f"ladder table, {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} naive, "
          f"{MAIN_STEPS} steps an image, ms an image (median of "
          f"{2 * LADDER_ROUNDS} runs of {RUNG_IMAGES} images in turns) "
          f"[{card}]:", flush=True)
    for label, runs_ms in runs.items():
        print(f"ladder {label:8s} {ms[label]!r} ms/image "
              f"{cells / ms[label] / 1e6!r} Gcell/s "
              f"{ms[label] / ms['cuda']!r} x cuda; runs {runs_ms!r} "
              f"[{card}]", flush=True)
    return ms


#: phase 12: the configurations whose records bench/defaults.py ships (the
#: default run's and the bench run's), and the share by which a shipped
#: record's engine may trail this run's winner before the record is stale
TUNED_KEYS = [(MAIN_SHAPE, "naive"), (MAIN_SHAPE, "zero"),
              (BENCH_SHAPE, "naive"), (BENCH_SHAPE, "zero")]
SHIPPED_MARGIN = 0.03
TUNED_IMAGES = 4
#: the sharded record phase 12 measures against the shipped one: the
#: default run in 4 shards
SHARDED_TUNED = (MAIN_SHAPE, "naive", 4)
SHARDED_MARGIN = 0.03


def ran(record: dict) -> tuple:
    """(engine, packed, K, block_rows, block_cols, fold) of a record or a
    candidate: K1's and K4's depth, tile and fold candidates apart."""
    return (record["engine"], bool(record["pack"]),
            record.get("steps_per_call", 8), record.get("block_rows"),
            record.get("block_cols"), record.get("fold") or 1)


def sharded_ran(record: dict) -> tuple:
    """(engine, mesh columns, overlap) of a sharded record or candidate
    (overlap None for the megakernel)."""
    return (record["engine"], record["mesh_cols"],
            bool(record["overlap"]) if record["engine"] == "windowed"
            else None)


def sharded_autotune_phase(checks: Checks, card: str, tmp: str) -> dict:
    """Phase 12b: ``sharded_autotune`` at SHARDED_TUNED into the store
    ``tmp/phase12``: every candidate runs (each viable mesh: windowed with
    overlap off and on, and K7), the winner beside the shipped record
    (``bench/defaults.py:SHARDED``), which must name a candidate of its key
    and trail the winner by less than SHARDED_MARGIN. Then ``simulate``
    with ``--autotune --backend sharded --sharded-devices 4`` twice into
    the store ``tmp/cli-sharded``: the first measures, the second measures
    nothing and runs the record's engine and mesh, its frames bitwise the
    plain replay."""
    params = Parameters()
    shape, boundary, n = SHARDED_TUNED
    os.environ["GRAYSCOTT_CACHE_DIR"] = os.path.join(tmp, "phase12")
    key = autotune.sharded_key(params, shape, boundary, n_devices=n,
                               device=DEVICE)
    before = autotune.measurements
    rec = autotune.sharded_autotune(params, shape, boundary, n_devices=n,
                                    verbose=True, device=DEVICE)
    wanted = autotune._sharded_candidates(shape, n)
    table = rec["candidates"]
    checks.expect(autotune.measurements - before >= len(wanted)
                  and [sharded_ran(c) for c in table]
                  == [sharded_ran({"overlap": None, **c}) for c in wanted]
                  and not any("error" in c for c in table),
                  f"sharded autotune {key}: candidates {table}")
    cells = shape[0] * shape[1] * autotune.STEPS
    times = {sharded_ran(c): cells / c["gcells_per_sec"] / 1e6
             for c in table if "error" not in c}
    print(f"sharded autotune {key}: winner {sharded_ran(rec)} at "
          f"{rec['gcells_per_sec']!r} Gcell/s (device "
          f"{rec.get('device_gcells_per_sec')!r}, wall "
          f"{rec['wall_gcells_per_sec']!r}); ms per {autotune.STEPS} steps "
          f"(the best device time): {times} [{card}]", flush=True)
    shipped = defaults.SHARDED.get(key)
    if shipped is None:
        print(f"sharded autotune {key}: no shipped record", flush=True)
    else:
        runs = sharded_ran(shipped) in times
        trail = (1 - times[sharded_ran(rec)] / times[sharded_ran(shipped)]
                 if runs else float("inf"))
        print(f"sharded autotune {key}: shipped {sharded_ran(shipped)} "
              f"({shipped['gcells_per_sec']!r} Gcell/s, "
              f"{shipped['source']}); this run's winner {sharded_ran(rec)}, "
              f"the shipped candidate trails it by {100 * trail!r} % "
              f"(limit {100 * SHARDED_MARGIN!r} %)", flush=True)
        checks.expect(runs, f"shipped record {key} names "
                      f"{sharded_ran(shipped)}, which the key does not run")
        checks.expect(trail < SHARDED_MARGIN, f"shipped record {key} is "
                      f"stale: {sharded_ran(shipped)} trails "
                      f"{sharded_ran(rec)}")
    os.environ["GRAYSCOTT_CACHE_DIR"] = os.path.join(tmp, "cli-sharded")
    replay = [r.cpu().numpy() for r in replay_frames(
        shape, boundary, params, TUNED_IMAGES, MAIN_STEPS, DEVICE)]
    measured = []
    for _ in range(2):
        before = autotune.measurements
        frames, launches, sim, species = run_frames(
            ["--autotune", *SHARDED_4], TUNED_IMAGES)
        measured.append(autotune.measurements - before)
        err = frames_err(frames, replay)
        checks.expect(err == 0.0, "--autotune --backend sharded frames vs "
                      "plain replay")
    cli = cache.load_autotune()[key]
    tag = KERNEL_OF.get(species.storage[0], species.storage[0])
    split = tag == "shwin" and sim.overlap_runs(shape)
    print(f"simulate --autotune {' '.join(SHARDED_4)} twice at {shape[0]}x"
          f"{shape[1]} {boundary}: candidates measured {measured}, the "
          f"record {sharded_ran(cli)}, the run {tag} mesh {sim.mesh.shape} "
          f"split {split}, launches {launches}, frames vs plain max|dV| "
          f"{err!r}", flush=True)
    checks.expect(measured[0] > 0 and measured[1] == 0,
                  f"--autotune --backend sharded measured {measured}")
    checks.expect(
        (sim.engine, sim.mesh.n_cols, split if tag == "shwin" else None)
        == sharded_ran(cli)
        and launches[tag] == expected_launches(tag, TUNED_IMAGES,
                                               MAIN_STEPS, split),
        f"--autotune --backend sharded ran {tag}, the record "
        f"{sharded_ran(cli)}")
    return {key: rec}


def autotune_phase(checks: Checks, card: str) -> dict:
    """Phase 12: ``autotune(persist=True)`` on each of TUNED_KEYS into a
    store of its own: every candidate runs, each winner beside its shipped
    record (``bench/defaults.py``) and the candidates' times; a shipped
    record must name a candidate of its key, and its engine may trail the
    winner by less than SHIPPED_MARGIN. Then ``simulate.run`` with
    ``--autotune`` at the default run's shape, twice, into another fresh
    store: the first call measures, the second measures nothing and runs
    the record's engine, its frames bitwise the plain replay. The empty
    store of the run is restored after."""
    empty = os.environ["GRAYSCOTT_CACHE_DIR"]
    params = Parameters()
    out = {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tmp:
            os.environ["GRAYSCOTT_CACHE_DIR"] = os.path.join(tmp, "phase12")
            for shape, boundary in TUNED_KEYS:
                key = autotune.key_for(params, shape, boundary,
                                       device=DEVICE)
                before = autotune.measurements
                rec = autotune.autotune(params, shape, boundary,
                                        verbose=True, device=DEVICE)
                wanted = autotune.default_candidates(
                    params, boundary, shape=shape, device=DEVICE)
                table = rec["candidates"]
                checks.expect(autotune.measurements - before >= len(wanted)
                              and len(table) == len(wanted)
                              and not any("error" in c for c in table),
                              f"autotune {key}: candidates {table}")
                cells = shape[0] * shape[1] * autotune.STEPS
                times = {ran(c): cells / c["gcells_per_sec"] / 1e6
                         for c in table if "error" not in c}
                print(f"autotune {key}: winner {ran(rec)} at "
                      f"{rec['gcells_per_sec']!r} Gcell/s (device "
                      f"{rec.get('device_gcells_per_sec')!r}, wall "
                      f"{rec['wall_gcells_per_sec']!r}); ms per "
                      f"{autotune.STEPS} steps (the best device time): {times} "
                      f"[{card}]", flush=True)
                shipped = defaults.SHIPPED.get(key)
                if shipped is None:
                    print(f"autotune {key}: no shipped record", flush=True)
                else:
                    runs = ran(shipped) in times
                    trail = (1 - times[ran(rec)] / times[ran(shipped)]
                             if runs else float("inf"))
                    print(f"autotune {key}: shipped {ran(shipped)} "
                          f"({shipped['gcells_per_sec']!r} Gcell/s, "
                          f"{shipped['source']}); this run's winner "
                          f"{ran(rec)}, the shipped engine trails it by "
                          f"{100 * trail!r} % (limit "
                          f"{100 * SHIPPED_MARGIN!r} %)", flush=True)
                    checks.expect(runs, f"shipped record {key} names "
                                  f"{ran(shipped)}, which the key does not "
                                  "run")
                    checks.expect(trail < SHIPPED_MARGIN,
                                  f"shipped record {key} is stale: "
                                  f"{ran(shipped)} trails {ran(rec)}")
                out[key] = rec
            os.environ["GRAYSCOTT_CACHE_DIR"] = os.path.join(tmp, "cli")
            replay = replay_frames(MAIN_SHAPE, "naive", params, TUNED_IMAGES,
                                   MAIN_STEPS, DEVICE)
            measured = []
            for _ in range(2):
                before = autotune.measurements
                frames, launches, _, species = run_frames(["--autotune"],
                                                          TUNED_IMAGES)
                measured.append(autotune.measurements - before)
                err = frames_err(frames, [r.cpu().numpy() for r in replay])
                checks.expect(err == 0.0, "--autotune frames vs plain "
                              "replay")
            rec = cache.load_autotune()[autotune.key_for(
                params, MAIN_SHAPE, "naive", device=DEVICE)]
            tag = species.storage[0]
            print(f"simulate --autotune twice at {MAIN_SHAPE[0]}x"
                  f"{MAIN_SHAPE[1]} naive: candidates measured {measured}, "
                  f"the record's engine {ran(rec)}, the run's {tag}, "
                  f"launches {launches}, frames vs plain max|dV| {err!r}",
                  flush=True)
            checks.expect(measured[0] > 0 and measured[1] == 0,
                          f"--autotune measured {measured}")
            checks.expect(tag == rec["engine"] and not rec["pack"]
                          and launches[tag] > 0,
                          f"--autotune ran {tag}, the record {ran(rec)}")
            out.update(sharded_autotune_phase(checks, card, tmp))
    finally:
        os.environ["GRAYSCOTT_CACHE_DIR"] = empty
    return out


#: phase 13: scripts/parity_check.py's backends on each boundary (every
#: engine of cuda, pinned, and two plain rungs), and PARITY.md's worst
#: drift over its run, which the unpacked engines must stay within
PARITY_BACKENDS = {
    "naive": ["cuda:engine=windowed", "cuda:engine=mega",
              "cuda:resident=on", "fused", "conv"],
    "zero": ["cuda:engine=windowed", "cuda:engine=mega", "cuda:resident=on",
             "cuda:pack=on:engine=windowed", "cuda:pack=on:engine=mega",
             "cuda:pack=on:resident=on", "fused", "conv"],
}
PARITY_MD_WORST = 6.1e-6


def parity_phase(checks: Checks, card: str) -> dict:
    """Phase 13: ``scripts/parity_check.py`` at its defaults (256x384, 1000
    steps, snapshots every 100) on PARITY_BACKENDS, with the launch counts
    zeroed before each boundary's run: its exit rule (max|dV| < 1e-3),
    every kernel of the boundary launched, the unpacked engines within
    PARITY_MD_WORST; each max|dV| a snapshot printed."""
    out = {}
    for boundary, specs in PARITY_BACKENDS.items():
        with tempfile.TemporaryDirectory(prefix="chip_smoke_parity_") as tmp:
            path = os.path.join(tmp, "parity.json")
            reset_launches()
            t0 = time.perf_counter()
            rc = parity_check.main(["--backends", ",".join(specs),
                                    "--boundary", boundary, "-o", path])
            seconds = time.perf_counter() - t0
            launches = read_launches()
            with open(path) as f:
                report = json.load(f)
        kernels = [t for t in ("windowed", "mega", "resident", "packed",
                               "megapack", "respack")
                   if boundary == "zero" or t in MODULES]
        print(f"parity {boundary}: rc {rc}, {seconds!r} s, launches "
              f"{launches} [{card}]", flush=True)
        checks.expect(rc == 0, f"parity_check {boundary}: rc {rc}")
        checks.expect(all(launches[t] > 0 for t in kernels),
                      f"parity_check {boundary} launched {launches}")
        for spec in specs:
            drift = [row[spec]["max_abs_v"] for row in report["rows"]]
            steps = [row["step"] for row in report["rows"]]
            unpacked = spec.startswith("cuda") and "pack=on" not in spec
            print(f"parity {boundary} {spec} max|dV| at steps {steps}: "
                  f"{drift}" + (f" (PARITY.md worst {PARITY_MD_WORST!r})"
                                if unpacked else ""), flush=True)
            checks.expect(max(drift) < parity_check.TOLERANCE,
                          f"parity {boundary} {spec}")
            if unpacked:
                checks.expect(max(drift) <= PARITY_MD_WORST,
                              f"parity {boundary} {spec} beyond PARITY.md")
            out[boundary, spec] = drift
    return out


#: phase 14: livesim on the card at the default 1080x1920 domain. (a) the
#: headless dump: LIVESIM_FRAMES frames of MAIN_STEPS steps at each depth
#: of LIVESIM_DEPTHS on auto (K3 by the shipped record), and at the last
#: one with ZERO_PACKED (K6); (c) livesim_fps at each depth of
#: LIVESIM_FPS_DEPTHS and each steps a frame of LIVESIM_FPS_STEPS
LIVESIM_FRAMES = 8
LIVESIM_DEPTHS = (1, 3)
LIVESIM_FPS_DEPTHS = (1, 2, 3, 4)
LIVESIM_FPS_STEPS = (1, MAIN_STEPS)
LIVESIM_FPS_FRAMES = 60
#: GRAYSCOTT_DEBUG's cost on the default run: rounds of (off, on, on, off)
DEBUG_ROUNDS = 2


def livesim_engine(flags: list) -> str:
    """The kernel tag that livesim's simulation runs with ``flags``."""
    ns = livesim.build_parser().parse_args(flags)
    sim = shared.make_simulation(ns)
    tag = sim.make_species((70, 97)).storage[0]
    return KERNEL_OF.get(tag, tag)


def livesim_headless(checks: Checks, card: str) -> dict:
    """Phase 14a: ``livesim.main --frames 8 -e 32`` at 1080x1920 on auto at
    depths 1 and 3, and with ``--boundary zero --pallas-pack on`` at depth
    3, each with the launch counts zeroed before it and read after: 8 PNGs,
    the depths' files identical, one launch of the engine a frame and no
    other, and every picture the palette of the indices of the plain replay
    on the card (the 256 rows are distinct, so equal pixels are equal
    indices). Returns each run's launches of its engine."""
    lut = inferno_lut(256)
    replays = {
        "naive": replay_frames(MAIN_SHAPE, "naive", Parameters(),
                               LIVESIM_FRAMES, MAIN_STEPS, DEVICE),
        "zero": replay_packed_frames(MAIN_SHAPE, Parameters(),
                                     LIVESIM_FRAMES, MAIN_STEPS, DEVICE)}
    want = {b: [lut[livesim.palette_index(f, len(lut)).cpu().numpy()]
                for f in frames] for b, frames in replays.items()}
    runs = [([], "naive", depth) for depth in LIVESIM_DEPTHS]
    runs.append((ZERO_PACKED, "zero", LIVESIM_DEPTHS[-1]))
    files: dict = {}
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_livesim_") as tmp:
        for flags, boundary, depth in runs:
            engine = livesim_engine(flags)
            outdir = os.path.join(tmp, f"{boundary}-{depth}")
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            rc = livesim.main(["--frames", str(LIVESIM_FRAMES), "-e",
                               str(MAIN_STEPS), "--frames-in-flight",
                               str(depth), "--output-dir", outdir, *flags])
            seconds = time.perf_counter() - t0
            launches = read_launches()
            names = sorted(os.listdir(outdir))
            data = []
            for name in names:
                with open(os.path.join(outdir, name), "rb") as f:
                    data.append(f.read())
            expect = {tag: 0 for tag in COUNTERS}
            expect[engine] = expected_launches(engine, LIVESIM_FRAMES,
                                               MAIN_STEPS)
            label = " ".join(flags) or "auto"
            print(f"path livesim --frames {LIVESIM_FRAMES} -e {MAIN_STEPS} "
                  f"{label} depth {depth}: engine {engine}, rc {rc}, "
                  f"{seconds!r} s ({LIVESIM_FRAMES / seconds!r} fps, "
                  f"set-up included), launches {launches} (expected "
                  f"{expect}) [{card}]", flush=True)
            checks.expect(rc == 0 and launches == expect,
                          f"livesim {label} depth {depth}: rc {rc}, "
                          f"launches {launches}")
            checks.expect(names == [f"{i}.png" for i in
                                    range(LIVESIM_FRAMES)],
                          f"livesim {label} depth {depth}: files {names}")
            same = [np.array_equal(native.png_decode(d), w)
                    for d, w in zip(data, want[boundary])]
            print(f"path livesim {label} depth {depth}: pictures equal to "
                  f"the palette of the plain replay's indices: {same}",
                  flush=True)
            checks.expect(len(same) == LIVESIM_FRAMES and all(same),
                          f"livesim {label} depth {depth} vs plain replay")
            files[boundary, depth] = data
            out[engine] = launches[engine]
    depths = [files["naive", d] for d in LIVESIM_DEPTHS]
    checks.expect(all(d == depths[0] for d in depths),
                  "livesim: the depths' PNG files differ")
    # the dump's steady rate, set-up excluded, and its host stages
    src = livesim.FrameSource(livesim.build_parser().parse_args(
        ["-e", str(MAIN_STEPS)]))
    src.next_idx_bounded(1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_livesim_") as tmp:
        t0 = time.perf_counter()
        livesim.run_headless(src, LIVESIM_FRAMES, tmp)
        dump_s = time.perf_counter() - t0
    idx = src._last_idx
    lut_ms = gpu.time_call(lambda: lut[idx], "cpu") * 1e3
    rgb = want["naive"][-1]
    png_ms = gpu.time_call(lambda: native.png_encode(rgb), "cpu") * 1e3
    print(f"livesim headless dump, depth {src.frames_in_flight}, set-up "
          f"excluded: {LIVESIM_FRAMES / dump_s!r} fps "
          f"({dump_s / LIVESIM_FRAMES * 1e3!r} ms/frame); on the host a "
          f"frame's palette lookup {lut_ms!r} ms and PNG encode {png_ms!r} "
          f"ms ({rgb.nbytes} B of RGB; {native.encoder()}) [{card}]",
          flush=True)
    return out


def _get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def livesim_web(checks: Checks, card: str) -> None:
    """Phase 14b: the web view of the default livesim (1080x1920, auto,
    depth 3, one step a frame) served from a thread on a free localhost
    port: /state, /palette.bin, two /frame.bin against the plain replay's
    indices (the first GET dispatches 3 frames, the second one more: 4
    launches of the engine and no other), /set?feedrate= reflected in
    /state with the state carried over; then the server is shut down."""
    lut = inferno_lut(256)
    src = livesim.FrameSource(livesim.build_parser().parse_args([]))
    engine = KERNEL_OF.get(src.species.storage[0], src.species.storage[0])
    replay = replay_frames(MAIN_SHAPE, "naive", Parameters(), 2, 1, DEVICE)
    want = [livesim.palette_index(f, len(lut)).cpu().numpy().tobytes()
            for f in replay]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = livesim.make_server(src, port, 1000.0)
    thread = threading.Thread(target=livesim.serve,
                              args=(server, init_logging()), daemon=True)
    thread.start()
    try:
        status, body = _get(port, "/state")
        state = json.loads(body)
        checks.expect(status == 200 and state["rows"] == MAIN_SHAPE[0]
                      and state["cols"] == MAIN_SHAPE[1]
                      and state["palette_n"] == 256
                      and state["backend"] == "cuda",
                      f"livesim web /state: {status} {state}")
        status, pal = _get(port, "/palette.bin")
        checks.expect(status == 200 and pal == lut.tobytes(),
                      f"livesim web /palette.bin: {status}, {len(pal)} B")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        frames = [_get(port, "/frame.bin") for _ in range(2)]
        seconds = time.perf_counter() - t0
        launches = read_launches()
        expect = {tag: 0 for tag in COUNTERS}
        expect[engine] = src.frames_in_flight + 1
        same = [status == 200 and body == w
                for (status, body), w in zip(frames, want)]
        print(f"livesim web: /state {state}; /palette.bin {len(pal)} B; "
              f"two /frame.bin of {[len(b) for _, b in frames]} B in "
              f"{seconds!r} s, equal to the plain replay's indices: {same}; "
              f"launches {launches} (expected {expect}) [{card}]",
              flush=True)
        checks.expect(all(same) and launches == expect,
                      f"livesim web /frame.bin: {same}, {launches}")
        before = src.species.uv_host()
        steps = src.species.steps_performed
        status, body = _get(port, "/set?feedrate=0.03")
        state = json.loads(body)
        after = src.species.uv_host()
        carried = all(np.array_equal(a, b) for a, b in zip(before, after))
        status2, frame = _get(port, "/frame.bin")
        print(f"livesim web /set?feedrate=0.03: {state}; state carried "
              f"over: {carried}, steps {steps} -> "
              f"{src.species.steps_performed} after one more /frame.bin "
              f"({status2}, {len(frame)} B)", flush=True)
        checks.expect(status == 200 and state["feedrate"] == 0.03
                      and json.loads(_get(port, "/state")[1])["feedrate"]
                      == 0.03 and carried and status2 == 200
                      and len(frame) == MAIN_SHAPE[0] * MAIN_SHAPE[1],
                      f"livesim web /set: {state}, carried {carried}")
    finally:
        server.shutdown()
        thread.join(timeout=60)
    checks.expect(not thread.is_alive(), "livesim web: server still up")


def livesim_rates(card: str) -> dict:
    """Phase 14c: ``scripts/livesim_fps.py`` at 1080x1920 on auto, each
    depth of LIVESIM_FPS_DEPTHS and steps a frame of LIVESIM_FPS_STEPS;
    the index pass and one frame's copy by CUDA events."""
    out = {}
    for spf in LIVESIM_FPS_STEPS:
        for depth in LIVESIM_FPS_DEPTHS:
            src = livesim_fps.make_source(*MAIN_SHAPE, depth, spf,
                                          device=DEVICE)
            if depth == LIVESIM_FPS_DEPTHS[0] and spf == LIVESIM_FPS_STEPS[0]:
                c = livesim_fps.frame_costs(src)
                out["costs"] = c
                print(f"livesim_fps frame: {c['frame_mb']!r} MB of indices;"
                      f" index pass {c['index_ms']!r} ms, device to host "
                      f"{c['d2h_ms']!r} ms (CUDA events) [{card}]",
                      flush=True)
            r = livesim_fps.measure_depth(src, LIVESIM_FPS_FRAMES)
            out[spf, depth] = r
            print(f"livesim_fps depth {depth} steps/frame {spf}: "
                  f"{r['fps']!r} fps ({r['ms_per_frame']!r} ms/frame, "
                  f"{r['mb_per_s']!r} MB/s) engine {r['engine']} [{card}]",
                  flush=True)
    return out


def debug_phase(checks: Checks, card: str) -> None:
    """Phase 14d: with GRAYSCOTT_DEBUG on, a diverging run (-t 1e4) on auto
    raises FloatingPointError naming the backend; the default run's ms an
    image with the checks on and off, in turns; then the ladder's trace
    (``utils/profiling.py:trace``) of two images of ``cuda`` auto."""
    os.environ[DEBUG_VAR] = "1"
    try:
        ns = simulate.build_parser().parse_args(["-t", "1e4"])
        sim = shared.make_simulation(ns)
        species = sim.make_species(MAIN_SHAPE)
        try:
            simulate.run(sim, species, 4, MAIN_STEPS, lambda frame: None)
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        print(f"{DEBUG_VAR}=1, -t 1e4 on auto: {raised!r}", flush=True)
        checks.expect(raised is not None and "cuda" in raised,
                      f"{DEBUG_VAR}: a diverging run did not raise")
        torch.cuda.synchronize()
    finally:
        del os.environ[DEBUG_VAR]
    ms: dict = {False: [], True: []}
    for _ in range(DEBUG_ROUNDS):
        for on in (False, True, True, False):
            if on:
                os.environ[DEBUG_VAR] = "1"
            try:
                ms[on].append(simulate_turns.run_ms([], MAIN_IMAGES,
                                                    MAIN_STEPS))
            finally:
                os.environ.pop(DEBUG_VAR, None)
    off, on = statistics.median(ms[False]), statistics.median(ms[True])
    print(f"{DEBUG_VAR} cost on the default run (auto, {MAIN_IMAGES} images "
          f"x {MAIN_STEPS} steps): on {on!r} ms/image {ms[True]!r}, off "
          f"{off!r} ms/image {ms[False]!r}, in turns: {on / off!r}x "
          f"[{card}]", flush=True)
    prof = ladder.profile_images("cuda", 2)
    print(f"trace of cuda auto, 2 images ({prof['trace']}): "
          f"{prof['kernels_per_step']!r} kernels a step, "
          f"{prof['copies_per_image']!r} copies an image, device busy "
          f"{prof['device_busy_ms']!r} ms an image, idle share "
          f"{prof['idle_share']!r} [{card}]", flush=True)
    checks.expect(prof["kernels_per_step"] > 0
                  and prof["device_busy_ms"] is not None,
                  f"the trace holds no device kernel: {prof}")


def build_cache_phase(checks: Checks) -> None:
    """Phase 14e: one build of the kernel library and of the native library
    into a fresh GRAYSCOTT_CACHE_DIR, each timed, each under it; (f) the
    PNG encoder that runs, and g++'s version."""
    saved = os.environ.get("GRAYSCOTT_CACHE_DIR")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cache_") as tmp:
        os.environ["GRAYSCOTT_CACHE_DIR"] = tmp
        try:
            t0 = time.perf_counter()
            built = build.build()
            kernel_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            native_path = native.build()
            native_s = time.perf_counter() - t0
        finally:
            if saved is None:
                del os.environ["GRAYSCOTT_CACHE_DIR"]
            else:
                os.environ["GRAYSCOTT_CACHE_DIR"] = saved
        print(f"build store {tmp}: kernels {built.path.name} in "
              f"{kernel_s!r} s (nvcc {built.seconds!r} s); native "
              f"{native_path.name if native_path else None} in "
              f"{native_s!r} s", flush=True)
        checks.expect(built.seconds > 0 and built.path.parent
                      == Path(tmp) / "kernels" and built.path.exists(),
                      f"kernel build into the store: {built.path}")
        gxx = native.gxx_version()
        checks.expect(gxx.startswith("g++ not found") or (
            native_path is not None and native_path.parent
            == Path(tmp) / "native" and native_path.exists()),
                      f"native build into the store: {native_path}")
    print(f"png encoder: {native.encoder()}; g++: {gxx}", flush=True)


def livesim_phase(checks: Checks, card: str) -> dict:
    """Phase 14 (a)-(f); returns phase 14a's launches by engine."""
    live = livesim_headless(checks, card)
    livesim_web(checks, card)
    livesim_rates(card)
    debug_phase(checks, card)
    build_cache_phase(checks)
    return live


# -- phase 15: bf16 storage (K1, K1's shard entry, K2 and K7) ---------------

#: phase 15's shapes: the default run's, the bench's, and a ragged one whose
#: rows are 16-byte rows in float32 but not in bf16 (1924 = 4 mod 8)
BF16_SHAPES = [MAIN_SHAPE, BENCH_SHAPE, (1000, 1924)]
#: K1's largest timed shape (against the plain version too), and the one
#: whose footprint is measured (grayscott_tpu/backends/pallas.py:699)
BF16_LARGE = (16384, 16384)
BF16_FOOTPRINT = (32768, 32768)
BF16 = ["--pallas-dtype", "bfloat16"]
#: the bf16 simulate paths: auto (K1), each engine pinned, and 4 shards on
#: the default mesh (2x2) with no engine pin (windowed) and on K7
BF16_PATHS = {"auto": BF16,
              "windowed": BF16 + ["--pallas-engine", "windowed"],
              "mega": BF16 + ["--pallas-engine", "mega"],
              "sharded": SHARDED_4 + BF16,
              "sharded mega": SHARDED_FLAGS + BF16}
#: the bf16 entries' tags, and the engine each stands for
BF16_TAGS = {"windowed": "windowed_bf16", "mega": "mega_bf16",
             "shwin": "shwin_bf16", "shmega": "shmega_bf16"}


def bf16_sims(params: Parameters, boundary: str, mesh=(2, 2),
              **shard_kwargs) -> dict:
    """tag -> a simulation pinned to that kernel on bf16 storage (the
    sharded ones on ``mesh``), the records ignored."""
    n = mesh[0] * mesh[1]
    common = dict(device=DEVICE, dtype="bfloat16", tuned_lookup=False)
    return {
        "windowed": CudaSimulation(params, boundary, engine="windowed",
                                   **common),
        "mega": CudaSimulation(params, boundary, engine="mega", **common),
        "shwin": ShardedSimulation(params, boundary, engine="windowed",
                                   n_devices=n, mesh_cols=mesh[1],
                                   **shard_kwargs, **common),
        "shmega": ShardedSimulation(params, boundary, engine="mega",
                                    n_devices=n, mesh_cols=mesh[1],
                                    **common)}


def sim_run(sim, u_np, v_np, steps: int):
    """(U, V) of ``sim`` after ``steps`` steps from the host state, as
    float32."""
    storage = sim.run_steps(sim.build_storage(u_np, v_np), u_np.shape, steps)
    return sim.extract_uv(storage, u_np.shape)


def bf16_state(rng, shape, special: bool):
    """A random host state; ``special``: NaN and +-Inf in interior and edge
    tiles and on the domain's edge."""
    u, v = (rng.uniform(0.0, 1.0, shape).astype(np.float32)
            for _ in range(2))
    if special:
        u[100, 150] = v[0, 5] = np.nan
        v[90, 140] = u[70, 200] = np.inf
        u[120, 7] = v[-1, -1] = -np.inf
    return u, v


def compare_bf16_kernels(checks: Checks, rng) -> int:
    """Phase 15a: each bf16 entry, through its backend (K1, K2, and K1's
    shard entry and K7 on 2x2), against ``stencil.run_bf16`` on the card
    after 1, 8 and 12 steps (a launch; a block; a block and a remainder),
    at BF16_SHAPES, both boundaries, and on a NaN/Inf state at 1080x1920.
    Returns the comparisons made."""
    consts = kernel_constants(Parameters())
    n = 0
    for shape in BF16_SHAPES:
        for special in ((False, True) if shape == MAIN_SHAPE else (False,)):
            u_np, v_np = bf16_state(rng, shape, special)
            u0, v0 = (torch.from_numpy(x).to(DEVICE).to(torch.bfloat16)
                      for x in (u_np, v_np))
            for boundary in ("naive", "zero"):
                sims = bf16_sims(Parameters(), boundary)
                plain = {1: stencil.run_bf16(u0, v0, 1, consts, boundary)}
                plain[8] = stencil.run_bf16(u0, v0, 8, consts, boundary)
                plain[12] = stencil.run_bf16(*plain[8], 4, consts, boundary)
                for steps, want in plain.items():
                    for tag, sim in sims.items():
                        what = (f"{shape[0]}x{shape[1]} {boundary}"
                                f"{' NaN and Inf' if special else ''}, "
                                f"bf16, {steps} steps")
                        checks.compare_bf16(BF16_TAGS[tag],
                                            sim_run(sim, u_np, v_np, steps),
                                            want, what)
                        n += 1
    return n


def compare_bf16_meshes(checks: Checks, rng) -> int:
    """Phase 15b: on bf16 storage, K1's shard entry (overlap off, and on:
    the split engages on every mesh here) against K1, and K7 against K2,
    at 1080x1920, 12 steps, both boundaries, on a random and a NaN/Inf
    state, on 1x1, 4x1, 2x2 and 1x4. Returns the comparisons made."""
    n = 0
    for special in (False, True):
        u_np, v_np = bf16_state(rng, MAIN_SHAPE, special)
        for boundary in ("naive", "zero"):
            one = bf16_sims(Parameters(), boundary)
            want = {tag: sim_run(one[tag], u_np, v_np, 12)
                    for tag in ("windowed", "mega")}
            for mesh in WINDOWED_MESHES:
                what = (f"{MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} {boundary}"
                        f"{' NaN and Inf' if special else ''}, bf16, 12 "
                        f"steps, mesh {mesh[0]}x{mesh[1]}")
                for overlap in ("off", "on"):
                    sim = bf16_sims(Parameters(), boundary, mesh,
                                    overlap=overlap)["shwin"]
                    if overlap == "on":
                        checks.expect(sim.overlap_runs(MAIN_SHAPE),
                                      f"overlap engages: {what}")
                    checks.compare_bf16(
                        "shwin_bf16", sim_run(sim, u_np, v_np, 12),
                        want["windowed"],
                        f"{what} overlap {overlap} vs K1 bf16")
                checks.compare_bf16(
                    "shmega_bf16", sim_run(bf16_sims(
                        Parameters(), boundary, mesh)["shmega"], u_np, v_np,
                        12), want["mega"], f"{what} K7 vs K2 bf16")
                n += 3
    return n


def bf16_paths(checks: Checks, card: str) -> dict:
    """Phase 15c: ``simulate.run`` on bf16 storage, 16 images x 32 steps at
    1080x1920 naive, on each path of BF16_PATHS (launch counts zeroed
    before each and read after), every frame bit for bit the plain bf16
    replay (``stencil.run_bf16`` a batch); then each timed in turns with
    the float32 default run and the float32 run on the same engine."""
    consts = kernel_constants(Parameters())
    u, v = (torch.from_numpy(x).to(DEVICE).to(torch.bfloat16)
            for x in initial_uv(MAIN_SHAPE))
    replay = []
    for _ in range(MAIN_IMAGES):
        u, v = stencil.run_bf16(u, v, MAIN_STEPS, consts, "naive")
        replay.append(v.float())
    runs = {label: simulate_path(checks, flags, replay)
            for label, flags in BF16_PATHS.items()}
    for label, run in runs.items():
        checks.expect(run["counter"] in BF16_TAGS.values(),
                      f"bf16 simulate {label}: ran {run['counter']}")
    f32 = {"f32 default": [], "f32 windowed": ["--pallas-engine",
                                                 "windowed"],
           "f32 mega": ["--pallas-engine", "mega"],
           "f32 sharded mega": SHARDED_FLAGS}
    timed = [{"label": k, "flags": f} for k, f in f32.items()]
    timed += [dict(run, label=label) for label, run in runs.items()]
    time_paths(timed)
    for run in timed:
        print(f"path simulate bf16 turns {run['label']} "
              f"({' '.join(run['flags']) or 'default'}): "
              f"{run['median_ms']!r} ms/image (the median of "
              f"{run['turns_ms']!r} in turns) [{card}]", flush=True)
    return runs


def time_bf16_kernels(checks: Checks, rng, card: str) -> dict:
    """Phase 15d: each bf16 entry timed in turns with its float32 entry
    (f32, bf16, bf16, f32; CUDA events): K1 one launch of 8 steps, K2 one
    launch of 4 time blocks of 8, K1's shard entry one launch of 8 steps
    on 2x2, K7 one launch of 32 steps on 2x2, at 1080x1920 and 4096^2,
    both boundaries; each beside its bound at 8 B a cell (bf16) and 16 B
    (f32), and the plain bf16 version's time at 1080x1920 naive. Then K1
    alone at 16384^2, against its plain version too."""
    consts = kernel_constants(Parameters())
    out = {}
    for shape, reps in ((MAIN_SHAPE, 40), (BENCH_SHAPE, 8)):
        u_np, v_np = bf16_state(rng, shape, False)
        for boundary in ("naive", "zero"):
            calls = {}
            for dtype in ("float32", "bfloat16"):
                torch_dtype = getattr(torch, dtype)
                u, v = (torch.from_numpy(x).to(DEVICE).to(torch_dtype)
                        for x in (u_np, v_np))
                k1 = [u, v, torch.empty_like(u), torch.empty_like(v)]
                pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
                mesh = halo.make_mesh(4, 2, DEVICE)
                su, sv = halo.mega_shard_state(u_np, v_np, mesh, torch_dtype)
                mu, mv = halo.mega_shard_state(u_np, v_np, mesh, torch_dtype)
                for x in (su, sv, mu, mv):
                    halo.exchange_halos(x)

                def k1_call(b=k1):
                    windowed.multistep(*b, windowed.K, consts, boundary)

                def k2_call(a=pu, b=pv):
                    megakernel.megastep(a, b, MAIN_STEPS // 8, 8, consts,
                                        boundary)

                def shwin_call(a=su, b=sv, m=mesh):
                    windowed.shard_multistep(a, b, m, 0, windowed.K, consts,
                                             boundary, shape)

                def k7_call(a=mu, b=mv, m=mesh):
                    sharded_mega.sharded_megastep(a, b, m, MAIN_STEPS // 8,
                                                  8, consts, boundary, shape)

                for tag, fn in (("windowed", k1_call), ("mega", k2_call),
                                ("shwin", shwin_call), ("shmega", k7_call)):
                    calls[tag, dtype] = fn
            samples = {key: [] for key in calls}
            for tag in ("windowed", "mega", "shwin", "shmega"):
                for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
                    samples[tag, dtype].append(cuda_ms(calls[tag, dtype],
                                                       reps))
            for tag in ("windowed", "mega", "shwin", "shmega"):
                steps = windowed.K if tag in ("windowed", "shwin") \
                    else MAIN_STEPS
                f32_ms = statistics.mean(samples[tag, "float32"])
                bf_ms = statistics.mean(samples[tag, "bfloat16"])
                bound, by = bound_ms(shape, steps, boundary, cell_bytes=8)
                f32_bound, _ = bound_ms(shape, steps, boundary)
                out[tag, shape, boundary] = (bf_ms, f32_ms, bound, by, steps)
                print(f"time bf16 {BF16_TAGS[tag]} {shape[0]}x{shape[1]} "
                      f"{boundary}, {steps} steps a launch"
                      f"{' (2x2)' if tag.startswith('sh') else ''}: "
                      f"{bf_ms!r} ms (turns {samples[tag, 'bfloat16']!r}), "
                      f"f32 {f32_ms!r} ms ({samples[tag, 'float32']!r}): "
                      f"{bf_ms / f32_ms!r}x; bound {bound!r} ms ({by}; f32 "
                      f"{f32_bound!r}), {100 * bound / bf_ms!r} % of it "
                      f"[{card}]", flush=True)
            if shape == MAIN_SHAPE and boundary == "naive":
                u, v = (torch.from_numpy(x).to(DEVICE).to(torch.bfloat16)
                        for x in (u_np, v_np))
                out["plain", "windowed"] = cuda_ms(lambda: stencil.run_bf16(
                    u, v, windowed.K, consts, boundary), 2)
                out["plain", "mega"] = cuda_ms(lambda: stencil.run_bf16(
                    u, v, MAIN_STEPS, consts, boundary), 1)
                mesh = halo.make_mesh(4, 2, DEVICE)
                su, sv = halo.mega_shard_state(u_np, v_np, mesh,
                                               torch.bfloat16)
                out["plain", "shwin"] = cuda_ms(
                    lambda: windowed.shard_multistep_reference(
                        su, sv, 0, windowed.K, consts, boundary, shape), 1)
                out["plain", "shmega"] = cuda_ms(
                    lambda: sharded_mega.sharded_megastep_reference(
                        su, sv, MAIN_STEPS // 8, 8, consts, boundary,
                        shape), 1)
                print(f"time bf16 plain versions {shape[0]}x{shape[1]} "
                      f"naive: K1 {out['plain', 'windowed']!r} ms (8 steps), "
                      f"K2 {out['plain', 'mega']!r} (32), K1 shard entry "
                      f"{out['plain', 'shwin']!r} (8, 2x2), K7 "
                      f"{out['plain', 'shmega']!r} (32, 2x2) [{card}]",
                      flush=True)
    # K1 at 16384^2: one launch of 8 steps, in turns with f32, and against
    # its plain version
    shape = BF16_LARGE
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    ms = {}
    bufs = {}
    for dtype in (torch.float32, torch.bfloat16):
        u = torch.rand(shape, device=DEVICE, generator=gen).to(dtype)
        v = torch.rand(shape, device=DEVICE, generator=gen).to(dtype)
        bufs[dtype] = [u, v, torch.empty_like(u), torch.empty_like(v)]
    for dtype in (torch.float32, torch.bfloat16, torch.bfloat16,
                  torch.float32):
        ms.setdefault(dtype, []).append(cuda_ms(
            lambda b=bufs[dtype]: windowed.multistep(*b, windowed.K, consts,
                                                     "naive"), 3))
    u, v, uo, vo = bufs[torch.bfloat16]
    windowed.multistep(u, v, uo, vo, windowed.K, consts, "naive")
    checks.compare_bf16("windowed_bf16", (uo, vo),
                        stencil.run_bf16(u, v, windowed.K, consts, "naive"),
                        f"{shape[0]}x{shape[1]} naive, bf16, 8 steps")
    bound, by = bound_ms(shape, windowed.K, "naive", cell_bytes=8)
    bf_ms = statistics.mean(ms[torch.bfloat16])
    f32_ms = statistics.mean(ms[torch.float32])
    out["windowed", shape, "naive"] = (bf_ms, f32_ms, bound, by, windowed.K)
    print(f"time bf16 windowed_bf16 {shape[0]}x{shape[1]} naive, 8 steps a "
          f"launch: {bf_ms!r} ms (turns {ms[torch.bfloat16]!r}), f32 "
          f"{f32_ms!r} ms ({ms[torch.float32]!r}): {bf_ms / f32_ms!r}x; "
          f"bound {bound!r} ms ({by}), {100 * bound / bf_ms!r} % of it "
          f"[{card}]", flush=True)
    del bufs, u, v, uo, vo
    return out


def bf16_footprint(card: str) -> None:
    """Phase 15e: one 32-step K1 call (four launches) at 32768^2, float32
    and then bf16: ``torch.cuda.max_memory_allocated`` from just before
    the call (the four state buffers and whatever the call allocates),
    and the call's time (CUDA events, one call after a warm one)."""
    consts = kernel_constants(Parameters())
    shape = BF16_FOOTPRINT
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    for dtype in (torch.float32, torch.bfloat16):
        torch.cuda.empty_cache()
        u = torch.rand(shape, device=DEVICE, generator=gen).to(dtype)
        v = torch.rand(shape, device=DEVICE, generator=gen).to(dtype)
        bufs = [u, v, torch.empty_like(u), torch.empty_like(v)]
        del u, v
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def call():
            for _ in range(MAIN_STEPS // windowed.K):
                windowed.multistep(*bufs, windowed.K, consts, "naive")
                bufs[:] = bufs[2:] + bufs[:2]

        ms = cuda_ms(call, 1)
        peak = torch.cuda.max_memory_allocated()
        print(f"footprint K1 {shape[0]}x{shape[1]} {str(dtype)[6:]}, one "
              f"{MAIN_STEPS}-step call: max_memory_allocated {peak!r} B "
              f"({peak / 1e9!r} GB), {ms!r} ms [{card}]", flush=True)
        del bufs
    torch.cuda.empty_cache()


def bf16_phase(checks: Checks, rng, card: str) -> tuple[dict, dict]:
    """Phase 15 (a)-(e); returns (15c's runs, 15d's times)."""
    n = compare_bf16_kernels(checks, rng)
    n += compare_bf16_meshes(checks, rng)
    print(f"phase 15: {n} bf16 comparisons", flush=True)
    runs = bf16_paths(checks, card)
    times = time_bf16_kernels(checks, rng, card)
    bf16_footprint(card)
    return runs, times


# -- phase 16: the folded naive reaction (K1's and K2's fold entries) -------

#: phase 16's shapes: the default run's, the bench's, and phase 3's ragged
#: one (every stencil and dt = 0.5 there)
FOLD_SHAPES = [MAIN_SHAPE, BENCH_SHAPE, (1000, 1917)]
FOLD = ["--pallas-naive-fold", "on"]
#: the fold's simulate paths: auto (K1), K2 pinned, both on bf16 storage
FOLD_PATHS = {"fold": FOLD, "fold mega": FOLD + ["--pallas-engine", "mega"],
              "fold bf16": FOLD + BF16,
              "fold mega bf16": FOLD + BF16 + ["--pallas-engine", "mega"]}
#: the fold's drift from the exact kernel: the shape (scripts/
#: parity_check.py's), and JAX's budgets after each step count
#: (tests/test_mega.py:514-535: 3e-6 from the exact path, 1e-4 from the
#: oracle)
DRIFT_SHAPE = (256, 384)
DRIFT_BUDGETS = {32: 3e-6, 1000: 1e-4}


def fold_tag(engine: str, dtype: torch.dtype) -> str:
    """The counter tag of a fold entry."""
    return f"{engine}_fold" + ("_bf16" if dtype == torch.bfloat16 else "")


def fold_plain(dtype: torch.dtype):
    return (stencil.run_naive_fold_bf16 if dtype == torch.bfloat16
            else stencil.run_naive_fold)


def compare_fold_kernels(checks: Checks, rng) -> int:
    """Phase 16a: each fold entry against its plain version on the card: K1
    one launch of 1 and of 8 steps, K2 one launch of 4 time blocks of 8, at
    FOLD_SHAPES, the default stencil at each and the others and dt = 0.5 at
    the ragged shape, a NaN/Inf state at 1080x1920. Returns the
    comparisons made."""
    n = 0
    for shape in FOLD_SHAPES:
        others = OTHER_PARAMS if shape == FOLD_SHAPES[-1] else []
        for special in ((False, True) if shape == MAIN_SHAPE else (False,)):
            u_np, v_np = bf16_state(rng, shape, special)
            for label, params in [("oono-puri", Parameters()), *others]:
                fc = fold_constants(params)
                for dtype in (torch.float32, torch.bfloat16):
                    u, v = (torch.from_numpy(x).to(DEVICE).to(dtype)
                            for x in (u_np, v_np))
                    compare = (checks.compare_bf16
                               if dtype == torch.bfloat16
                               else checks.compare_bits)
                    what = (f"{shape[0]}x{shape[1]} {label}"
                            f"{' NaN and Inf' if special else ''}, "
                            f"{str(dtype)[6:]}")
                    for steps in (1, windowed.K):
                        out = [torch.empty_like(u), torch.empty_like(v)]
                        windowed.multistep(u, v, *out, steps, fc, "naive",
                                           fold=True)
                        compare(fold_tag("windowed", dtype), out,
                                fold_plain(dtype)(u, v, steps, fc),
                                f"{what}, {steps} steps")
                    pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
                    megakernel.megastep(pu, pv, MAIN_STEPS // 8, 8, fc,
                                        "naive", fold=True)
                    compare(fold_tag("mega", dtype), (pu[0], pv[0]),
                            megakernel.megastep_reference_fold(
                                u, v, MAIN_STEPS // 8, 8, fc),
                            f"{what}, {MAIN_STEPS} steps")
                    n += 3
                    if dtype == torch.float32 and label == "oono-puri":
                        n += compare_fold_loads(checks, u, v, fc, what)
                        n += compare_fold_parts(checks, u, v, params, what)
    return n


def compare_fold_loads(checks: Checks, u, v, fc, what: str) -> int:
    """Phase 16a: the load each float32 fold entry names for this state
    (TMA where ``geometry.tma_ok`` takes the shape), and the TMA counters
    of one launch of each. Returns the checks made."""
    want = "tma" if geometry.tma_ok(tuple(u.shape)) else "cp.async"
    out = [torch.empty_like(u), torch.empty_like(v)]
    pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
    loads = {"windowed": windowed.fold_load(u, v, *out),
             "mega": windowed.fold_load(pu, pv)}
    reset_launches()
    windowed.multistep(u, v, *out, windowed.K, fc, "naive", fold=True)
    megakernel.megastep(pu, pv, 1, 8, fc, "naive", fold=True)
    counts = read_launches()
    for engine, load in loads.items():
        tma = counts[fold_tag(engine, torch.float32) + "_tma"]
        print(f"fold load {engine} {what}: {load} (expected {want}), "
              f"TMA launches {tma} of "
              f"{counts[fold_tag(engine, torch.float32)]}", flush=True)
        checks.expect(load == want and tma == (want == "tma"),
                      f"fold load {engine} {what}: {load}, {tma} TMA "
                      f"launches; expected {want}")
    return 2


def fold_part_plain(u, v, part: int, n_steps: int, params: Parameters):
    """The plain version of a fold ablation part's result after
    ``n_steps`` steps: the input for the parts of no step, the exact
    naive run for part 4, else the plain fold."""
    if part in windowed.FOLD_ABLATION_NO_STEP:
        return u, v
    if part == windowed.FOLD_ABLATION_EXACT:
        return stencil.run(u, v, n_steps, kernel_constants(params), "naive")
    return stencil.run_naive_fold(u, v, n_steps, fold_constants(params))


def fold_part_calls(u, v, part: int, params: Parameters):
    """One call of each engine's fold ablation ``part`` on the state
    (K1 one launch of K steps into fresh buffers, K2 one launch of 4 time
    blocks of 8 on fresh pairs), and where each leaves its result."""
    fc, kc = fold_constants(params), kernel_constants(params)
    k1 = [u, v, torch.empty_like(u), torch.empty_like(v)]
    pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
    return {
        "windowed": (lambda: windowed.fold_ablation(
            *k1, windowed.K, fc, part, exact=kc), k1[2:], windowed.K),
        "mega": (lambda: megakernel.fold_ablation(
            pu, pv, MAIN_STEPS // 8, 8, fc, part, exact=kc),
            (pu[0], pv[0]), MAIN_STEPS),
    }


def compare_fold_parts(checks: Checks, u, v, params: Parameters,
                       what: str) -> int:
    """Phase 16a: every part of the fold entries' split (the first form,
    part 0, among them; those built for TMA only where the state loads
    through TMA) bit for bit against its plain version, one call each.
    Returns the comparisons made."""
    n = 0
    tma = windowed.fold_load(u, v) == "tma"
    for part, part_what in windowed.FOLD_ABLATIONS.items():
        if part in windowed.FOLD_ABLATION_TMA_ONLY and not tma:
            continue
        for engine, (call, out, n_steps) in fold_part_calls(
                u, v, part, params).items():
            call()
            checks.compare_bits(fold_tag(engine, torch.float32), out,
                                fold_part_plain(u, v, part, n_steps, params),
                                f"{what}, part {part} ({part_what})")
            n += 1
    return n


def fold_drift(checks: Checks) -> None:
    """Phase 16b: K1's fold entry against its exact naive entry from the
    default state at DRIFT_SHAPE, max|dV| after each step count of
    DRIFT_BUDGETS, within JAX's budget there."""
    params = Parameters()
    consts = {False: kernel_constants(params), True: fold_constants(params)}
    u0, v0 = (torch.from_numpy(x).to(DEVICE)
              for x in initial_uv(DRIFT_SHAPE))
    bufs = {fold: [u0.clone(), v0.clone(), torch.empty_like(u0),
                   torch.empty_like(v0)] for fold in (False, True)}
    done = 0
    for steps, budget in DRIFT_BUDGETS.items():
        while done < steps:
            k = min(windowed.K, steps - done)
            for fold, b in bufs.items():
                windowed.multistep(*b, k, consts[fold], "naive", fold=fold)
                bufs[fold] = b[2:] + b[:2]
            done += k
        du, dv = (max_err(a, b) for a, b in zip(bufs[True][:2],
                                                bufs[False][:2]))
        print(f"drift fold vs exact K1 {DRIFT_SHAPE[0]}x{DRIFT_SHAPE[1]} "
              f"naive from the default state, {steps} steps: max|dV| "
              f"{dv!r} (JAX's budget {budget!r}), max|dU| {du!r}",
              flush=True)
        checks.expect(dv <= budget, f"fold drift after {steps} steps: "
                      f"max|dV| {dv!r} > {budget!r}")


def fold_paths(checks: Checks) -> dict:
    """Phase 16c: ``simulate.run`` on each path of FOLD_PATHS, 16 images x
    32 steps at 1080x1920 naive, launch counts zeroed before each and read
    after, every frame bit for bit the plain fold's replay on the card."""
    fc = fold_constants(Parameters())
    replays = {}
    for dtype in (torch.float32, torch.bfloat16):
        u, v = (torch.from_numpy(x).to(DEVICE).to(dtype)
                for x in initial_uv(MAIN_SHAPE))
        replays[dtype] = []
        for _ in range(MAIN_IMAGES):
            u, v = fold_plain(dtype)(u, v, MAIN_STEPS, fc)
            replays[dtype].append(v.float())
    runs = {}
    for label, flags in FOLD_PATHS.items():
        dtype = torch.bfloat16 if "bfloat16" in flags else torch.float32
        runs[label] = simulate_path(checks, flags, replays[dtype])
        want = fold_tag("mega" if "mega" in flags else "windowed", dtype)
        checks.expect(runs[label]["counter"] == want,
                      f"simulate {label}: ran {runs[label]['counter']}, not "
                      f"{want}")
    return runs


def time_fold_kernels(rng, card: str) -> dict:
    """Phase 16d: each fold entry in turns with the exact naive entry and
    the zero entry of the same engine and storage (fold, naive, zero, zero,
    naive, fold; CUDA events): K1 one launch of 8 steps, K2 one launch of 4
    time blocks of 8, at 1080x1920 and 4096^2, beside its bound at the
    fold's operation count; and the plain versions' time at 1080x1920."""
    params = Parameters()
    fc, kc = fold_constants(params), kernel_constants(params)
    ops = fold_ops_per_cell_step(params)
    kinds = ("fold", "naive", "zero")
    out = {}
    for shape, reps in ((MAIN_SHAPE, 40), (BENCH_SHAPE, 8)):
        u_np, v_np = bf16_state(rng, shape, False)
        for dtype in (torch.float32, torch.bfloat16):
            u, v = (torch.from_numpy(x).to(DEVICE).to(dtype)
                    for x in (u_np, v_np))
            k1 = [u, v, torch.empty_like(u), torch.empty_like(v)]
            pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
            args = {"fold": (fc, "naive", True), "naive": (kc, "naive", False),
                    "zero": (kc, "zero", False)}
            calls = {}
            for kind, (c, boundary, fold) in args.items():
                calls["windowed", kind] = (
                    lambda c=c, b=boundary, f=fold: windowed.multistep(
                        *k1, windowed.K, c, b, fold=f))
                calls["mega", kind] = (
                    lambda c=c, b=boundary, f=fold: megakernel.megastep(
                        pu, pv, MAIN_STEPS // 8, 8, c, b, fold=f))
            samples = {key: [] for key in calls}
            for engine in ("windowed", "mega"):
                for kind in kinds + kinds[::-1]:
                    samples[engine, kind].append(
                        cuda_ms(calls[engine, kind], reps))
            for engine in ("windowed", "mega"):
                steps = windowed.K if engine == "windowed" else MAIN_STEPS
                ms = {k: statistics.mean(samples[engine, k]) for k in kinds}
                bound, by = roofline_ms(
                    shape, steps, ops, 8 if dtype == torch.bfloat16 else 16)
                tag = fold_tag(engine, dtype)
                out[tag, shape] = (ms["fold"], bound, by, steps,
                                   ms["naive"], ms["zero"])
                print(f"time fold {tag} {shape[0]}x{shape[1]}, {steps} "
                      f"steps a launch: {ms['fold']!r} ms (turns "
                      f"{samples[engine, 'fold']!r}), exact naive "
                      f"{ms['naive']!r} ({samples[engine, 'naive']!r}), "
                      f"zero {ms['zero']!r} ({samples[engine, 'zero']!r}): "
                      f"{ms['fold'] / ms['naive']!r}x the exact naive; "
                      f"bound {bound!r} ms ({by}, {ops} operations a "
                      f"cell-step), {100 * bound / ms['fold']!r} % of it "
                      f"[{card}]", flush=True)
            if shape == MAIN_SHAPE:
                out["plain", fold_tag("windowed", dtype)] = cuda_ms(
                    lambda: fold_plain(dtype)(u, v, windowed.K, fc), 2)
                out["plain", fold_tag("mega", dtype)] = cuda_ms(
                    lambda: megakernel.megastep_reference_fold(
                        u, v, MAIN_STEPS // 8, 8, fc), 1)
                print(f"time fold plain versions {shape[0]}x{shape[1]} "
                      f"{str(dtype)[6:]}: K1 "
                      f"{out['plain', fold_tag('windowed', dtype)]!r} ms "
                      f"(8 steps), K2 "
                      f"{out['plain', fold_tag('mega', dtype)]!r} (32) "
                      f"[{card}]", flush=True)
    return out


#: phase 16e's reps a sample by shape, and its rounds (the parts in order,
#: then reversed, this many times)
SPLIT_REPS = {MAIN_SHAPE: 40, BENCH_SHAPE: 8}
SPLIT_ROUNDS = 2


def time_fold_split(rng, card: str, parts=None) -> dict:
    """Phase 16e: each part of the fold entries' split (``parts``, default
    every part of ``FOLD_ABLATIONS``) in turns with the entry itself
    ("entry"; device time, ``queued_ms``), K1 one launch of 8 steps and K2
    one launch of 4 time blocks of 8, at 1080x1920 and 4096^2 on a random
    state, each beside part 0 and the bound at the fold's operation count.
    Returns {(engine, shape): {part or "entry": ms}}."""
    params = Parameters()
    fc = fold_constants(params)
    ops = fold_ops_per_cell_step(params)
    parts = list(windowed.FOLD_ABLATIONS) if parts is None else list(parts)
    out = {}
    for shape in (MAIN_SHAPE, BENCH_SHAPE):
        u, v = (torch.from_numpy(x).to(DEVICE)
                for x in bf16_state(rng, shape, False))
        k1 = [u, v, torch.empty_like(u), torch.empty_like(v)]
        pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
        for engine in ("windowed", "mega"):
            calls = {p: fold_part_calls(u, v, p, params)[engine][0]
                     for p in parts}
            calls["entry"] = (
                (lambda: windowed.multistep(*k1, windowed.K, fc, "naive",
                                            fold=True))
                if engine == "windowed" else
                (lambda: megakernel.megastep(pu, pv, MAIN_STEPS // 8, 8, fc,
                                             "naive", fold=True)))
            order = list(calls)
            samples = {key: [] for key in order}
            for _ in range(SPLIT_ROUNDS):
                for key in order + order[::-1]:
                    samples[key].append(queued_ms(calls[key],
                                                  SPLIT_REPS[shape]))
            steps = windowed.K if engine == "windowed" else MAIN_STEPS
            bound, by = roofline_ms(shape, steps, ops, 16)
            ms = {key: statistics.mean(x) for key, x in samples.items()}
            out[engine, shape] = ms
            first = ms.get(0)
            load = windowed.fold_load(*((u, v) if engine == "windowed"
                                        else (pu, pv)))
            for key in order:
                what = ("the entry (the second form, " + load + " load)"
                        if key == "entry" else
                        f"part {key} ({windowed.FOLD_ABLATIONS[key]})")
                vs = (f", {ms[key] / first!r}x part 0" if first else "")
                print(f"split {fold_tag(engine, torch.float32)} "
                      f"{shape[0]}x{shape[1]}, {steps} steps a launch, "
                      f"{what}: {ms[key]!r} ms (turns {samples[key]!r})"
                      f"{vs}; {100 * bound / ms[key]!r} % of the bound "
                      f"{bound!r} ms ({by}) [{card}]", flush=True)
    return out


def fold_phase(checks: Checks, rng, card: str) -> tuple[dict, dict]:
    """Phase 16 (a)-(e); returns (16c's runs, 16d's times with 16e's
    split under ("split", engine, shape))."""
    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = megakernel.max_blocks(dev)
    print(f"co-resident blocks of K2, every instantiation with the fold "
          f"entries: {blocks} on {sms} SMs", flush=True)
    checks.expect(blocks == 2 * sms, f"K2's instantiations keep "
                  f"{blocks} blocks on {sms} SMs, not two an SM")
    n = compare_fold_kernels(checks, rng)
    print(f"phase 16: {n} fold comparisons", flush=True)
    fold_drift(checks)
    runs = fold_paths(checks)
    times = time_fold_kernels(rng, card)
    for key, ms in time_fold_split(rng, card).items():
        times["split", *key] = ms
    return runs, times


# --- 17. the window ring (mega_depth) and K7's read-site wait ---------------

#: the ring's shapes and depths (JAX's mega_depth values)
RING_SHAPES = [MAIN_SHAPE, BENCH_SHAPE]
RING_DEPTHS = tuple(megakernel.DEPTHS)
#: K2's entries by the ring's counter tag: (storage dtype, the folded naive
#: reaction), and the double buffer's tag of each
RING_K2 = {"mega_ring": (torch.float32, False),
           "mega_ring_bf16": (torch.bfloat16, False),
           "mega_ring_fold": (torch.float32, True),
           "mega_ring_fold_bf16": (torch.bfloat16, True)}
RING_BASE = {"mega_ring": "mega", "mega_ring_bf16": "mega_bf16",
             "mega_ring_fold": "mega_fold",
             "mega_ring_fold_bf16": "mega_fold_bf16"}
#: a checked ring launch: 3 time blocks of 8 steps (odd: the slot copy)
RING_BLOCKS = 3
#: K7's row meshes, where it waits at the read site
READ_SITE_MESHES = [(4, 1), (2, 1)]
#: phase 17b's and 17c's timings: rounds in turns (in order, then
#: reversed), launches a sample, by shape
RING_ROUNDS = 2
RING_REPS = {MAIN_SHAPE: 20, BENCH_SHAPE: 5}
#: the depth of phase 17d's simulate runs
RING_PATH_DEPTH = 4


def same_bits(got, want) -> bool:
    """Every element of each tensor of ``got`` has the bits of ``want``'s,
    NaN included."""
    def bits(x):
        return x.view(torch.int16 if x.dtype == torch.bfloat16
                      else torch.int32)
    return all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))


def ring_label(shape, depth: int) -> str:
    g = megakernel.ring_geometry(shape, depth)
    return (f"depth={depth} ({g.tile}x{g.tile} tiles, depth {g.depth}, "
            f"{g.buffers} buffers, {g.bytes} B)")


def k2_ring_run(u, v, tag: str, boundary: str, depth: int,
                n_blocks: int = RING_BLOCKS):
    """(U, V) after one launch of ``tag``'s K2 entry at ``depth``."""
    fold = RING_K2[tag][1]
    params = Parameters()
    k = fold_constants(params) if fold else kernel_constants(params)
    pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
    megakernel.megastep(pu, pv, n_blocks, 8, k, boundary, fold=fold,
                        depth=depth)
    return pu[0], pv[0]


def k2_ring_plain(u, v, tag: str, boundary: str,
                  n_blocks: int = RING_BLOCKS):
    """The plain version of ``tag``'s K2 entry."""
    dtype, fold = RING_K2[tag]
    params = Parameters()
    if fold:
        return megakernel.megastep_reference_fold(u, v, n_blocks, 8,
                                                  fold_constants(params))
    consts = kernel_constants(params)
    if dtype == torch.bfloat16:
        return megakernel.megastep_reference_bf16(u, v, n_blocks, 8, consts,
                                                  boundary)
    return stencil.run(u, v, 8 * n_blocks, consts, boundary)


def ring_report(checks: Checks) -> None:
    """Phase 17: each depth's geometry at RING_SHAPES (tile, depth after
    JAX's clamp, buffers, bytes, blocks an SM by shared memory) beside the
    occupancy API's blocks of K2, which must not exceed it."""
    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape in RING_SHAPES:
        for depth in RING_DEPTHS:
            g = megakernel.ring_geometry(shape, depth)
            k2 = (megakernel.ring_max_blocks(dev, g) if g.ring
                  else megakernel.max_blocks(dev))
            print(f"ring {shape[0]}x{shape[1]} mega_depth={depth}: "
                  f"{g.tile}x{g.tile} tiles, depth {g.depth}, {g.buffers} "
                  f"buffers, {g.bytes} B a block, {g.blocks_per_sm} blocks "
                  f"an SM by shared memory; occupancy API K2 {k2} blocks "
                  f"({k2 / sms!r} an SM)", flush=True)
            checks.expect(sms <= k2 <= g.blocks_per_sm * sms,
                          f"ring K2 {shape} depth {depth}: {k2} co-resident "
                          f"blocks, shared memory holds {g.blocks_per_sm} "
                          f"an SM")


def compare_ring(checks: Checks, rng) -> int:
    """Phase 17a: every K2 entry (float32, bf16, fold, fold bf16) at every
    depth, one launch of RING_BLOCKS time blocks of 8 steps at
    RING_SHAPES (and a NaN/Inf state at 1080x1920), naive and zero where
    the entry takes them: bit for bit against the plain version and against
    depth 2 (bf16: NaN's positions, then every other cell's bits). Returns
    the comparisons made."""
    n = 0
    for shape in RING_SHAPES:
        for special in ((False, True) if shape == MAIN_SHAPE else (False,)):
            u_np, v_np = bf16_state(rng, shape, special)
            state = " NaN and Inf" if special else ""
            for tag, (dtype, fold) in RING_K2.items():
                u, v = (torch.from_numpy(x).to(DEVICE).to(dtype)
                        for x in (u_np, v_np))
                compare = (checks.compare_bf16 if dtype == torch.bfloat16
                           else checks.compare_bits)
                for boundary in ("naive",) if fold else ("naive", "zero"):
                    want = k2_ring_plain(u, v, tag, boundary)
                    at2 = None
                    for depth in RING_DEPTHS:
                        got = k2_ring_run(u, v, tag, boundary, depth)
                        ring = megakernel.ring_geometry(shape, depth).ring
                        what = (f"{shape[0]}x{shape[1]} {boundary}{state} "
                                f"{RING_BLOCKS}x8 steps "
                                f"{ring_label(shape, depth)}")
                        compare(tag if ring else RING_BASE[tag], got, want,
                                what)
                        if at2 is None:
                            at2 = got
                        else:
                            same = same_bits(got, at2)
                            print(f"compare {tag} {what} vs depth 2: "
                                  f"bitwise {same}", flush=True)
                            checks.expect(same, f"{tag} {what} vs depth 2")
                        n += 1
    return n


def time_ring(rng, card: str) -> dict:
    """Phase 17b: one launch of 4 time blocks of 8 steps (32 steps) at
    every depth, in turns (RING_ROUNDS rounds, the depths in order, then
    reversed), at RING_SHAPES: K2 naive and zero, K2 bf16 naive, K2 fold
    on both storages; each depth beside depth 2 and the bound of the same
    work (the operations bound of K2 and its entries, unchanged), and the
    plain versions' time at 1080x1920. Returns {(tag, shape, boundary, depth):
    ms} and {("plain", tag): ms}."""
    params = Parameters()
    out = {}
    entries = [("mega_ring", "naive"), ("mega_ring", "zero"),
               ("mega_ring_bf16", "naive"), ("mega_ring_fold", "naive"),
               ("mega_ring_fold_bf16", "naive")]
    steps = MAIN_STEPS
    for shape in RING_SHAPES:
        u_np, v_np = (rng.uniform(0, 1, shape).astype(np.float32)
                      for _ in range(2))
        for tag, boundary in entries:
            calls = {}
            dtype, fold = RING_K2[tag]
            for depth in RING_DEPTHS:
                pu, pv = (megakernel.pair_state(
                    torch.from_numpy(a).to(DEVICE).to(dtype))
                    for a in (u_np, v_np))
                k = (fold_constants(params) if fold
                     else kernel_constants(params))

                def call(pu=pu, pv=pv, k=k, fold=fold, depth=depth,
                         boundary=boundary):
                    megakernel.megastep(pu, pv, steps // 8, 8, k, boundary,
                                        fold=fold, depth=depth)
                calls[depth] = call
            samples = {d: [] for d in RING_DEPTHS}
            for r in range(RING_ROUNDS):
                for d in (RING_DEPTHS if r % 2 == 0
                          else reversed(RING_DEPTHS)):
                    samples[d].append(cuda_ms(calls[d], RING_REPS[shape]))
            cell_bytes = 8 if dtype == torch.bfloat16 else 16
            if fold:
                bound, by = roofline_ms(shape, steps,
                                        fold_ops_per_cell_step(params),
                                        cell_bytes)
            else:
                bound, by = bound_ms(shape, steps, boundary,
                                     cell_bytes=cell_bytes)
            ms2 = statistics.median(samples[2])
            for d in RING_DEPTHS:
                ms = statistics.median(samples[d])
                out[tag, shape, boundary, d] = (ms, bound, by)
                print(f"time {tag} {shape[0]}x{shape[1]} {boundary} "
                      f"{ring_label(shape, d)}, {steps} steps a launch: "
                      f"{ms!r} ms (turns {samples[d]!r}) = "
                      f"{gcells(shape, steps, ms)!r} Gcell/s, {ms / ms2!r}x "
                      f"depth 2; bound {bound!r} ms ({by}), "
                      f"{100 * bound / ms!r} % of it [{card}]", flush=True)
    u, v = (torch.from_numpy(rng.uniform(0, 1, MAIN_SHAPE)
                             .astype(np.float32)).to(DEVICE)
            for _ in range(2))
    n_blocks = steps // 8
    for tag in RING_K2:
        dtype = RING_K2[tag][0]
        a, b = u.to(dtype), v.to(dtype)
        out["plain", tag] = cuda_ms(
            lambda a=a, b=b, tag=tag: k2_ring_plain(a, b, tag, "naive",
                                                    n_blocks), 2)
    for tag in RING_BASE:
        print(f"time plain {tag} {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}, {steps} "
              f"steps: {out['plain', tag]!r} ms [{card}]", flush=True)
    return out


def compare_read_site(checks: Checks, rng, card: str) -> dict:
    """Phase 17c: K7 on the row meshes READ_SITE_MESHES at RING_SHAPES,
    both boundaries (and a NaN/Inf state at 1080x1920 naive): the
    read-site wait bit for bit against the entry gate and the plain
    version, then one 32-step launch of each timed in turns. Returns
    {(shape, mesh, boundary): (read-site ms, entry-gate ms, bound, by)}."""
    out = {}
    consts = kernel_constants(Parameters())
    for shape in RING_SHAPES:
        for special in ((False, True) if shape == MAIN_SHAPE else (False,)):
            u_np, v_np = bf16_state(rng, shape, special)
            plain_u, plain_v = (torch.from_numpy(x).to(DEVICE)
                                for x in (u_np, v_np))
            for boundary in ("naive",) if special else ("naive", "zero"):
                want = stencil.run(plain_u, plain_v, MAIN_STEPS, consts,
                                   boundary)
                for mesh_shape in READ_SITE_MESHES:
                    what = (f"{shape[0]}x{shape[1]} {boundary}"
                            f"{' NaN and Inf' if special else ''} mesh "
                            f"{mesh_shape[0]}x{mesh_shape[1]}, {MAIN_STEPS} "
                            "steps")
                    before = sharded_mega.read_site_launches
                    got = sharded_launches(Parameters(), boundary, u_np,
                                           v_np, mesh_shape, MAIN_STEPS)
                    waited = sharded_mega.read_site_launches - before
                    checks.expect(waited > 0, f"K7 {what}: no launch waited "
                                  "at the read site")
                    gate = sharded_launches(Parameters(), boundary, u_np,
                                            v_np, mesh_shape, MAIN_STEPS,
                                            read_site=False)
                    checks.compare_bits("shmega_read_site", got, want, what)
                    same = same_bits(got, gate)
                    print(f"compare shmega_read_site {what} vs the entry "
                          f"gate: bitwise {same}", flush=True)
                    checks.expect(same, f"K7 read-site {what} vs the entry "
                                  "gate")
        u_np, v_np = (rng.uniform(0, 1, shape).astype(np.float32)
                      for _ in range(2))
        for boundary in ("naive", "zero"):
            for mesh_shape in READ_SITE_MESHES:
                mesh = halo.make_mesh(mesh_shape[0] * mesh_shape[1],
                                      mesh_shape[1], DEVICE)
                calls = {}
                for read_site in (True, False):
                    pairs = halo.mega_shard_state(u_np, v_np, mesh)
                    for p in pairs:
                        halo.exchange_halos(p)

                    def call(pairs=pairs, mesh=mesh, boundary=boundary,
                             read_site=read_site):
                        sharded_mega.sharded_megastep(
                            *pairs, mesh, MAIN_STEPS // 8, 8, consts,
                            boundary, shape, read_site=read_site)
                    calls[read_site] = call
                samples = {True: [], False: []}
                for r in range(2 * RING_ROUNDS):
                    for rs in ((True, False) if r % 2 == 0
                               else (False, True)):
                        samples[rs].append(cuda_ms(calls[rs],
                                                   RING_REPS[shape]))
                ms = {rs: statistics.median(x) for rs, x in samples.items()}
                bound, by = sharded_bound_ms(shape, mesh_shape, MAIN_STEPS,
                                             boundary)
                out[shape, mesh_shape, boundary] = (ms[True], ms[False],
                                                    bound, by)
                print(f"time K7 read-site {shape[0]}x{shape[1]} {boundary} "
                      f"mesh {mesh_shape[0]}x{mesh_shape[1]} (tile "
                      f"{sharded_mega.tile_for(shape, mesh)}), {MAIN_STEPS} "
                      f"steps a launch: {ms[True]!r} ms (turns "
                      f"{samples[True]!r}) against the entry gate's "
                      f"{ms[False]!r} (turns {samples[False]!r}): "
                      f"{ms[True] / ms[False]!r}x; bound {bound!r} ms ({by}) "
                      f"[{card}]", flush=True)
    mesh = halo.make_mesh(4, 1, DEVICE)
    pairs = halo.mega_shard_state(*initial_uv(MAIN_SHAPE), mesh)
    for p in pairs:
        halo.exchange_halos(p)
    out["plain"] = cuda_ms(lambda: sharded_mega.sharded_megastep_reference(
        *pairs, MAIN_STEPS // 8, 8, consts, "naive", MAIN_SHAPE), 1)
    print(f"time plain sharded {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} naive mesh "
          f"4x1, {MAIN_STEPS} steps: {out['plain']!r} ms [{card}]",
          flush=True)
    return out


class entry_gate:
    """Within the block, K7 gates every time block's entry on a row mesh
    too: the sharded backend's calls of ``sharded_megastep`` take
    ``read_site=False`` (the form the read-site wait is held against)."""

    def __enter__(self):
        self.fn = sharded_mega.sharded_megastep

        def gated(*args, **kwargs):
            return self.fn(*args, **kwargs, read_site=False)

        sharded_mega.sharded_megastep = gated

    def __exit__(self, *exc):
        sharded_mega.sharded_megastep = self.fn


def sim_path_ms(sim) -> float:
    """ms an image of one ``simulate.run`` of MAIN_IMAGES images of
    MAIN_STEPS steps at 1080x1920 on ``sim``, on the host clock ending in
    a device synchronise (``bench/simulate_turns.py:run_ms``'s timing)."""
    species = sim.make_species(MAIN_SHAPE)
    frames: list[np.ndarray] = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    simulate.run(sim, species, MAIN_IMAGES, MAIN_STEPS, frames.append)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / MAIN_IMAGES * 1e3


def ring_path(checks: Checks, label: str, sim, want: dict):
    """One ``simulate.run`` of MAIN_IMAGES images of MAIN_STEPS steps at
    1080x1920 on ``sim``, with the launch counts zeroed before it and read
    after (each count must be ``want``'s, with the fold entries' TMA
    counts, 0 where ``want`` has no entry): {frames, launches, ms an
    image}."""
    want = fold_tma_counts(want, MAIN_SHAPE)
    species = sim.make_species(MAIN_SHAPE)
    frames: list[np.ndarray] = []
    pinned = [torch.empty(MAIN_SHAPE, pin_memory=True)
              for _ in range(MAIN_IMAGES + 1)]
    del pinned
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    simulate.run(sim, species, MAIN_IMAGES, MAIN_STEPS, frames.append)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    moved = {t: n for t, n in launches.items() if n}
    print(f"path simulate {label}: {MAIN_IMAGES} images x {MAIN_STEPS} "
          f"steps at {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}: "
          f"{seconds / MAIN_IMAGES * 1e3!r} ms/image, launches {moved}",
          flush=True)
    checks.expect(all(n == want.get(t, 0) for t, n in launches.items()),
                  f"simulate {label}: launches {moved}, not {want}")
    checks.expect(len(frames) == MAIN_IMAGES
                  and all(f.shape == MAIN_SHAPE and np.isfinite(f).all()
                          for f in frames),
                  f"simulate {label}: frame count, shape or finiteness")
    return {"frames": frames, "launches": launches,
            "ms": seconds / MAIN_IMAGES * 1e3, "sim": sim}


def ring_paths(checks: Checks, card: str) -> dict:
    """Phase 17d: ``simulate.run`` at 1080x1920, MAIN_IMAGES images of
    MAIN_STEPS steps, on ``CudaSimulation(engine='mega',
    mega_depth=RING_PATH_DEPTH)`` (float32, bf16, the fold, the fold on
    bf16; naive), each against the same run at depth 2, every frame bit
    for bit; the packed K6 (zero) under the same pin, which it declines as
    JAX's ``packed_megastep`` does (the double buffer runs, frames bitwise
    to depth 2's); then the sharded simulate on 4x1 (K7 with the read-site
    wait) against the entry gate's. Each pair but K6's is then timed again
    in turns (the ring, depth 2, depth 2, the ring; twice). Returns the
    runs by counter tag, each with ``ms`` an image and its depth-2 twin's
    ``ms2`` (the medians of the turns)."""
    runs = {}
    images_steps = MAIN_IMAGES * expected_launches("mega", 1, MAIN_STEPS)
    for tag, (dtype, fold) in RING_K2.items():
        kwargs = dict(engine="mega", tuned_lookup=False,
                      dtype=str(dtype)[6:], naive_fold=fold)
        got = ring_path(
            checks, f"{tag} mega_depth={RING_PATH_DEPTH}",
            CudaSimulation(Parameters(), "naive", device=DEVICE,
                           mega_depth=RING_PATH_DEPTH, **kwargs),
            {tag: images_steps})
        ref = ring_path(
            checks, f"{RING_BASE[tag]} mega_depth=2",
            CudaSimulation(Parameters(), "naive", device=DEVICE,
                           mega_depth=2, **kwargs),
            {RING_BASE[tag]: images_steps})
        same = all(np.array_equal(a.view(np.int32), b.view(np.int32))
                   for a, b in zip(got["frames"], ref["frames"]))
        print(f"path simulate {tag} mega_depth={RING_PATH_DEPTH} vs depth "
              f"2: frames bitwise {same}; {got['ms']!r} against "
              f"{ref['ms']!r} ms/image [{card}]", flush=True)
        checks.expect(same, f"simulate {tag} frames vs depth 2")
        runs[tag] = dict(got, sims=(got["sim"], ref["sim"]))
    packs = [ring_path(
        checks, f"megapack mega_depth={depth} (declined)",
        CudaSimulation(Parameters(), "zero", device=DEVICE, engine="mega",
                       pack="on", mega_depth=depth, tuned_lookup=False),
        {"megapack": images_steps}) for depth in (RING_PATH_DEPTH, 2)]
    same = all(np.array_equal(a.view(np.int32), b.view(np.int32))
               for a, b in zip(packs[0]["frames"], packs[1]["frames"]))
    print(f"path simulate megapack mega_depth={RING_PATH_DEPTH} vs depth 2: "
          f"frames bitwise {same}; {packs[0]['ms']!r} against "
          f"{packs[1]['ms']!r} ms/image [{card}]", flush=True)
    checks.expect(same, "simulate megapack frames vs depth 2")
    params = Parameters()
    sims = {}
    for read_site in (True, False):
        sim = ShardedSimulation(params, "naive", device=DEVICE,
                                engine="mega", n_devices=4, mesh_cols=1,
                                tuned_lookup=False)
        if read_site:
            sims[read_site] = ring_path(
                checks, "sharded mega 4x1 read-site", sim,
                {"shmega": images_steps, "shmega_read_site": images_steps})
        else:
            with entry_gate():
                sims[read_site] = ring_path(
                    checks, "sharded mega 4x1 entry gate", sim,
                    {"shmega": images_steps})
    same = all(np.array_equal(a.view(np.int32), b.view(np.int32))
               for a, b in zip(sims[True]["frames"], sims[False]["frames"]))
    print(f"path simulate sharded mega 4x1 read-site vs the entry gate: "
          f"frames bitwise {same}; {sims[True]['ms']!r} against "
          f"{sims[False]['ms']!r} ms/image [{card}]", flush=True)
    checks.expect(same, "sharded simulate 4x1 read-site frames vs the entry "
                  "gate")
    runs["shmega_read_site"] = dict(sims[True], sims=(sims[True]["sim"],
                                                      sims[False]["sim"]))
    for tag, run in runs.items():
        turns = ([], [])
        for r in range(2 * RING_ROUNDS):
            for side in ((0, 1) if r % 2 == 0 else (1, 0)):
                if tag == "shmega_read_site" and side == 1:
                    with entry_gate():
                        turns[side].append(sim_path_ms(run["sims"][side]))
                else:
                    turns[side].append(sim_path_ms(run["sims"][side]))
        run["ms"], run["ms2"] = (statistics.median(t) for t in turns)
        print(f"path simulate {tag} (mega_depth={RING_PATH_DEPTH}, or the "
              f"read-site wait) in turns: {run['ms']!r} ms/image "
              f"({turns[0]!r}) against {run['ms2']!r} ({turns[1]!r}) for "
              f"depth 2 (or the entry gate): {run['ms'] / run['ms2']!r}x "
              f"[{card}]", flush=True)
    return runs


def ring_phase(checks: Checks, rng, card: str) -> tuple[dict, dict, dict]:
    """Phase 17: the report, then 17a-17d."""
    ring_report(checks)
    n = compare_ring(checks, rng)
    print(f"phase 17a: {n} comparisons of the ring's entries", flush=True)
    times = time_ring(rng, card)
    k7 = compare_read_site(checks, rng, card)
    runs = ring_paths(checks, card)
    return times, k7, runs


# --- 18. the tile and depth pins of K1 and K4 -------------------------------

#: the depths and the tile pins (block_rows, block_cols; None: the default
#: rule, ops/geometry.py) of phase 18a, every combination that fits
PIN_KS = (1, 3, 8, 12, 16, 24, 32)
PIN_TILES = ((None, None), (32, 32), (8, 512), (64, 128), (128, 32),
             (32, 256))
#: phase 18a's shapes (the default run's, a last tile row of one row, no
#: interior tile), and the 4096x4096 subset
PIN_SHAPES = [MAIN_SHAPE, (1001, 1920), (40, 40)]
PIN_BENCH = ((16, (None, None)), (32, (None, None)), (12, (32, 256)))
#: K4's row tiles (JAX's packed kernel takes no column tile)
PIN_PACKED_ROWS = (None, 32, 8, 128)
#: K1's pinned entries by counter tag: (storage dtype, the folded naive
#: reaction), and the compiled entry that runs the compiled geometry
PIN_ENTRIES = {"windowed_pinned": (torch.float32, False),
               "windowed_pinned_bf16": (torch.bfloat16, False),
               "windowed_pinned_fold": (torch.float32, True),
               "windowed_pinned_fold_bf16": (torch.bfloat16, True)}
PIN_BASE = {"windowed_pinned": "windowed",
            "windowed_pinned_bf16": "windowed_bf16",
            "windowed_pinned_fold": "windowed_fold",
            "windowed_pinned_fold_bf16": "windowed_fold_bf16"}
#: phase 18c's simulate paths: label -> (flags, the counter of the entry
#: that runs, K)
PIN_PATHS = {
    "k16": (["--pallas-steps-per-call", "16"], "windowed_pinned", 16),
    "k4": (["--pallas-steps-per-call", "4"], "windowed", 4),
    "tiles 32x128": (["--pallas-block-rows", "32", "--pallas-block-cols",
                      "128"], "windowed_pinned", 8),
    "pack k16": (ZERO_PACKED + ["--pallas-steps-per-call", "16"],
                 "packed_pinned", 16),
    "bf16 k16": (["--pallas-dtype", "bfloat16", "--pallas-steps-per-call",
                  "16"], "windowed_pinned_bf16", 16),
    "fold k16": (["--pallas-naive-fold", "on", "--pallas-steps-per-call",
                  "16"], "windowed_pinned_fold", 16),
    "fold bf16 k16": (["--pallas-naive-fold", "on", "--pallas-dtype",
                       "bfloat16", "--pallas-steps-per-call", "16"],
                      "windowed_pinned_fold_bf16", 16),
}
#: phase 18d: (K, block_rows, block_cols) of K1 timed in turns with the
#: default (the first), steps a timed call (a multiple of every K), rounds
PIN_TIMED = ((8, None, None), (4, None, None), (16, None, None),
             (24, None, None), (32, None, None), (8, 32, 32),
             (8, 32, 128), (8, 128, 32), (8, 64, 128))
PIN_PACKED_TIMED = ((8, None), (16, None), (8, 32), (32, None))
PIN_TIME_STEPS = 96
PIN_ROUNDS = 2
PIN_REPS = {MAIN_SHAPE: 10, BENCH_SHAPE: 3}


def pin_plain(u, v, steps: int, tag: str, boundary: str,
              params: Parameters):
    """The plain version of one launch of ``steps`` steps of ``tag``'s
    entry (bf16: rounded once, at the end)."""
    dtype, fold = PIN_ENTRIES[tag]
    bf16 = dtype == torch.bfloat16
    if fold:
        fc = fold_constants(params)
        return (stencil.run_naive_fold_bf16(u, v, steps, fc, block=steps)
                if bf16 else stencil.run_naive_fold(u, v, steps, fc))
    consts = kernel_constants(params)
    return (stencil.run_bf16(u, v, steps, consts, boundary, block=steps)
            if bf16 else stencil.run(u, v, steps, consts, boundary))


def pin_label(shape, g) -> str:
    return f"{shape[0]}x{shape[1]} {g.label()}"


def compare_pins(checks: Checks, rng) -> int:
    """Phase 18a: each pinned entry of K1 (float32 and bf16 on both
    boundaries, the fold on both storages) one launch of K steps for every
    K of PIN_KS and tile pin of PIN_TILES that fits, at PIN_SHAPES (and a
    NaN/Inf state at 1080x1920) and PIN_BENCH at 4096x4096, bit for bit
    against its plain version (bf16: NaN's bit pattern aside); the
    compiled geometry through the compiled entry; the other stencils and
    dt = 0.5 at 1001x1920; K4 on PIN_PACKED_ROWS; each refused geometry
    checked refused, its window past the shared memory. Returns the
    comparisons made."""
    n = refused = 0
    params = Parameters()
    states = [(s, False) for s in PIN_SHAPES] + [(MAIN_SHAPE, True),
                                                 (BENCH_SHAPE, False)]
    for shape, special in states:
        u_np, v_np = bf16_state(rng, shape, special)
        cases = (PIN_BENCH if shape == BENCH_SHAPE else
                 [(k, t) for k in PIN_KS for t in PIN_TILES])
        for tag, (dtype, fold) in PIN_ENTRIES.items():
            if shape == BENCH_SHAPE and fold:
                continue
            u, v = (torch.from_numpy(x).to(DEVICE).to(dtype)
                    for x in (u_np, v_np))
            compare = (checks.compare_bf16 if dtype == torch.bfloat16
                       else checks.compare_bits)
            k_consts = fold_constants(params) if fold else \
                kernel_constants(params)
            for boundary in ("naive",) if fold else ("naive", "zero"):
                plains = {}
                for k, (tr, tc) in cases:
                    try:
                        g = geometry.resolve(shape, k, tr, tc)
                    except UnsupportedConfigError as e:
                        nbytes = int(re.search(r"needs (\d+) B",
                                               str(e)).group(1))
                        checks.expect(nbytes > geometry.SMEM_OPTIN,
                                      f"pins {shape} K={k} {tr}x{tc}: "
                                      f"refused at {nbytes} B")
                        refused += 1
                        continue
                    if k not in plains:
                        plains[k] = pin_plain(u, v, k, tag, boundary, params)
                    uo, vo = torch.empty_like(u), torch.empty_like(v)
                    windowed.multistep(u, v, uo, vo, k, k_consts, boundary,
                                       fold=fold, geometry=g)
                    state = " NaN and Inf" if special else ""
                    compare(tag if not g.compiled else PIN_BASE[tag],
                            (uo, vo), plains[k],
                            f"{pin_label(shape, g)} K={k} {boundary}"
                            f"{state}")
                    n += 1
    shape = PIN_SHAPES[1]
    u_np, v_np = bf16_state(rng, shape, False)
    u, v = (torch.from_numpy(x).to(DEVICE) for x in (u_np, v_np))
    for label, p in OTHER_PARAMS:
        for boundary in ("naive", "zero"):
            for k, tr, tc in ((12, None, None), (16, 32, 128), (3, 8, 512),
                              (24, 128, 32)):
                g = geometry.resolve(shape, k, tr, tc)
                uo, vo = torch.empty_like(u), torch.empty_like(v)
                windowed.multistep(u, v, uo, vo, k, kernel_constants(p),
                                   boundary, geometry=g)
                checks.compare_bits("windowed_pinned", (uo, vo),
                                    stencil.run(u, v, k, kernel_constants(p),
                                                boundary),
                                    f"{pin_label(shape, g)} K={k} "
                                    f"{boundary} {label}")
                n += 1
    pc = packed_constants(params)
    for shape, special in states[:4]:
        u_np, v_np = bf16_state(rng, shape, special)
        x = packed.pack_state(*(torch.from_numpy(a).to(DEVICE)
                                for a in (u_np, v_np)))
        for k in PIN_KS:
            want = packed.packed_run(x, k, pc)
            for tr in PIN_PACKED_ROWS:
                g = geometry.resolve(shape, k, tr)
                out = torch.empty_like(x)
                packed.multistep(x, out, k, pc, geometry=g)
                checks.compare_bits(
                    "packed_pinned" if not g.compiled else "packed",
                    (out,), (want,), f"{pin_label(shape, g)} K={k}"
                    f"{' NaN and Inf' if special else ''}")
                n += 1
    big = geometry.Geometry(64, 64, 32)
    try:
        windowed.multistep(u, v, torch.empty_like(u), torch.empty_like(v), 8,
                           kernel_constants(params), "naive", geometry=big)
        checks.expect(False, f"{big.label()} launched")
    except RuntimeError as e:  # the C entry's check (pin_ok)
        print(f"pins {big.label()}: refused ({e})", flush=True)
    print(f"phase 18a: {n} comparisons, {refused} geometries refused",
          flush=True)
    return n


def pin_ptxas(checks: Checks, log: str) -> None:
    """Phase 18b: ptxas's report of the pinned entries (K1's: the fold
    entries' 6 first-form instantiations and the second form's 24, 8 of
    them on compiled sizes; K4's): registers, stack and spills, none of
    which may spill or take a stack frame. (Whether a change moved the
    compiled geometries' code is
    ``grayscott_tpu_torch/scripts/sass_diff.py``'s question, against the
    tree before it.)"""
    if not log:
        print("phase 18b: the library was reused, no ptxas report",
              flush=True)
        return
    rows, entry, frame = {}, None, None
    for line in log.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            entry, frame = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = PTXAS_USED.search(line)
        if m and entry:
            rows[entry] = (int(m.group(1)), frame)
            entry = None
    pinned = {name: r for name, r in rows.items()
              if "13pinned_kernel" in name or "20packed_pinned_kernel" in name
              or "18pinned_form_kernel" in name}
    for name, (regs, frame) in sorted(pinned.items()):
        print(f"ptxas pinned {name[name.index('pinned_'):]}: {regs} "
              f"registers, stack, spill stores, spill loads {frame}",
              flush=True)
    checks.expect(len(pinned) == 31 and all(
        f == (0, 0, 0) for _, f in pinned.values()),
        f"pinned entries: {len(pinned)} instantiations, stack or spills "
        f"{[r for r in pinned.values() if r[1] != (0, 0, 0)]}")
    print(f"phase 18b: {len(pinned)} pinned instantiations", flush=True)


def pin_replay(flags: list, tag: str, k: int, params: Parameters):
    """V after each image of the default run under ``flags``, from the
    plain version on the card: the unpinned plain step (float32, the
    packed layout), rounded to bf16 once a K-step block (bf16), or the
    fold."""
    u, v = (torch.from_numpy(x).to(DEVICE) for x in initial_uv(MAIN_SHAPE))
    if tag == "packed_pinned":
        return replay_packed_frames(MAIN_SHAPE, params, MAIN_IMAGES,
                                    MAIN_STEPS, DEVICE)
    dtype, fold = PIN_ENTRIES.get(tag, (torch.float32, False))
    bf16 = dtype == torch.bfloat16
    if bf16:
        u, v = u.to(torch.bfloat16), v.to(torch.bfloat16)
    frames = []
    for _ in range(MAIN_IMAGES):
        if fold:
            fc = fold_constants(params)
            u, v = (stencil.run_naive_fold_bf16(u, v, MAIN_STEPS, fc,
                                                block=k) if bf16 else
                    stencil.run_naive_fold(u, v, MAIN_STEPS, fc))
        elif bf16:
            u, v = stencil.run_bf16(u, v, MAIN_STEPS,
                                    kernel_constants(params), "naive",
                                    block=k)
        else:
            u, v = stencil.run(u, v, MAIN_STEPS, kernel_constants(params),
                               "naive")
        frames.append(v.float())
    return frames


def pin_paths(checks: Checks, card: str) -> dict:
    """Phase 18c: ``simulate.run`` (MAIN_IMAGES images of MAIN_STEPS steps
    at 1080x1920) under each of PIN_PATHS, with the launch counts zeroed
    before it and read after: ceil(32 / K) launches an image of the
    entry that runs and no other; every frame bit for bit the unpinned
    windowed run's (float32; the packed path: K4's unpinned run's) and
    the plain replay's (bf16: rounded once a K-step block; the fold's).
    Returns the runs by label."""
    params = Parameters()
    runs = {}
    unpinned = {}
    for label, flags in (("naive", ["--pallas-engine", "windowed"]),
                         ("zero", ZERO_PACKED + ["--pallas-engine",
                                                 "windowed"])):
        ns = simulate.build_parser().parse_args(flags)
        sim = shared.make_simulation(ns)
        tag = "packed" if label == "zero" else "windowed"
        unpinned[label] = ring_path(
            checks, f"{' '.join(flags)} (unpinned)", sim,
            {tag: MAIN_IMAGES * -(-MAIN_STEPS // windowed.K)})["frames"]
    for label, (flags, tag, k) in PIN_PATHS.items():
        ns = simulate.build_parser().parse_args(flags)
        sim = shared.make_simulation(ns)
        run = ring_path(checks, f"{' '.join(flags)}", sim,
                        {tag: MAIN_IMAGES * -(-MAIN_STEPS // k)})
        replay = pin_replay(flags, tag, k, params)
        same = all(np.array_equal(f.view(np.int32),
                                  r.cpu().numpy().view(np.int32))
                   for f, r in zip(run["frames"], replay))
        if tag in ("windowed", "windowed_pinned", "packed_pinned"):
            ref = unpinned["zero" if tag == "packed_pinned" else "naive"]
            same = same and all(np.array_equal(a.view(np.int32),
                                               b.view(np.int32))
                                for a, b in zip(run["frames"], ref))
        print(f"path simulate {' '.join(flags)}: frames bitwise the "
              f"unpinned run's and the plain replay's: {same}; "
              f"{run['ms']!r} ms/image [{card}]", flush=True)
        checks.expect(same, f"simulate {label} frames")
        if tag in checks.kernel_err and not same:
            checks.kernel_err[tag] = float("inf")
        runs[label] = dict(run, tag=tag, k=k)
    return runs


def time_pins(rng, card: str) -> dict:
    """Phase 18d: K1 under each pin of PIN_TIMED, PIN_TIME_STEPS steps a
    call (ceil(steps / K) launches), in turns (PIN_ROUNDS rounds, in order
    and reversed) with the default geometry, at 1080x1920 and 4096x4096,
    naive and zero; K4 under PIN_PACKED_TIMED on zero; each time per step
    beside the default's, the bound of the same work (output cell-steps at
    the unfused float32 rate), the stepped-area ratio (the halo
    recompute) and the blocks an SM. Then one K = 16 launch of each pinned
    entry at 1080x1920 naive beside the compiled entry's K = 8 launch
    (the kernels line), and their plain versions. Returns the times."""
    out = {}
    params = Parameters()
    consts = kernel_constants(params)
    steps = PIN_TIME_STEPS
    for shape in (MAIN_SHAPE, BENCH_SHAPE):
        u_np, v_np = (rng.uniform(0, 1, shape).astype(np.float32)
                      for _ in range(2))
        for boundary in ("naive", "zero"):
            calls = {}
            for cfg in PIN_TIMED:
                k, tr, tc = cfg
                g = geometry.resolve(shape, k, tr, tc)
                buf = [torch.from_numpy(a).to(DEVICE) for a in (u_np, v_np)]
                buf += [torch.empty_like(buf[0]), torch.empty_like(buf[0])]

                def call(buf=buf, k=k, g=g, boundary=boundary):
                    a, b, c, d = buf
                    for _ in range(steps // k):
                        windowed.multistep(a, b, c, d, k, consts, boundary,
                                           geometry=g)
                        a, b, c, d = c, d, a, b
                calls[cfg] = (call, g)
            if boundary == "zero":
                x = packed.pack_state(*(torch.from_numpy(a).to(DEVICE)
                                        for a in (u_np, v_np)))
                pc = packed_constants(params)
                for k, tr in PIN_PACKED_TIMED:
                    g = geometry.resolve(shape, k, tr)
                    xb = [x.clone(), torch.empty_like(x)]

                    def pcall(xb=xb, k=k, g=g):
                        a, b = xb
                        for _ in range(steps // k):
                            packed.multistep(a, b, k, pc, geometry=g)
                            a, b = b, a
                    calls["packed", k, tr] = (pcall, g)
            samples = {c: [] for c in calls}
            order = list(calls)
            for r in range(PIN_ROUNDS):
                for c in (order if r % 2 == 0 else reversed(order)):
                    samples[c].append(cuda_ms(calls[c][0], PIN_REPS[shape]))
            bound, by = bound_ms(shape, steps, boundary)
            for c in calls:
                ms = statistics.median(samples[c])
                g = calls[c][1]
                base = (("packed", 8, None) if c[0] == "packed"
                        else PIN_TIMED[0])
                ratio = ms / statistics.median(samples[base])
                k = c[1] if c[0] == "packed" else c[0]
                if c[0] == "packed":
                    bound_c, by_c = roofline_ms(shape, steps, PACKED_OPS)
                else:
                    bound_c, by_c = bound, by
                out[shape, boundary, c] = ms
                print(f"time pins {'K4' if c[0] == 'packed' else 'K1'} "
                      f"{pin_label(shape, g)} K={k} {boundary}, {steps} "
                      f"steps in {-(-steps // k)} launches: {ms!r} ms "
                      f"(turns {samples[c]!r}), {ms / steps!r} ms a step, "
                      f"{ratio!r}x the default geometry's; bound "
                      f"{bound_c!r} ms ({by_c}), {100 * bound_c / ms!r} % "
                      f"of it; stepped cells per output cell-step "
                      f"{g.stepped_ratio(k)!r}, {g.blocks_per_sm} blocks an "
                      f"SM [{card}]", flush=True)
    u_np, v_np = (rng.uniform(0, 1, MAIN_SHAPE).astype(np.float32)
                  for _ in range(2))
    g16 = geometry.resolve(MAIN_SHAPE, 16)
    for tag, (dtype, fold) in PIN_ENTRIES.items():
        u, v = (torch.from_numpy(a).to(DEVICE).to(dtype) for a in (u_np,
                                                                  v_np))
        uo, vo = torch.empty_like(u), torch.empty_like(v)
        kc = fold_constants(params) if fold else consts
        pinned_ms = cuda_ms(lambda: windowed.multistep(
            u, v, uo, vo, 16, kc, "naive", fold=fold, geometry=g16), 20)
        k8_ms = cuda_ms(lambda: windowed.multistep(
            u, v, uo, vo, 8, kc, "naive", fold=fold), 20)
        plain = cuda_ms(lambda: pin_plain(u, v, 16, tag, "naive", params), 2)
        cell_bytes = 8 if dtype == torch.bfloat16 else 16
        ops = (fold_ops_per_cell_step(params) if fold
               else ops_per_cell_step(params, "naive"))
        bound, by = roofline_ms(MAIN_SHAPE, 16, ops, cell_bytes)
        out[tag] = (pinned_ms, plain, bound, by, k8_ms)
        print(f"time {tag} {pin_label(MAIN_SHAPE, g16)} naive, one launch "
              f"of 16 steps: {pinned_ms!r} ms ({pinned_ms / 16!r} a step), "
              f"the compiled entry's 8-step launch {k8_ms!r} ({k8_ms / 8!r} "
              f"a step): {pinned_ms / 2 / k8_ms!r}x a step; bound {bound!r} "
              f"ms ({by}); plain {plain!r} ms [{card}]", flush=True)
    x = packed.pack_state(*(torch.from_numpy(a).to(DEVICE)
                            for a in (u_np, v_np)))
    xo = torch.empty_like(x)
    pc = packed_constants(params)
    pinned_ms = cuda_ms(lambda: packed.multistep(x, xo, 16, pc,
                                                 geometry=g16), 20)
    plain = cuda_ms(lambda: packed.packed_run(x, 16, pc), 2)
    bound, by = roofline_ms(MAIN_SHAPE, 16, PACKED_OPS)
    k8_ms = cuda_ms(lambda: packed.multistep(x, xo, 8, pc), 20)
    out["packed_pinned"] = (pinned_ms, plain, bound, by, k8_ms)
    print(f"time packed_pinned {pin_label(MAIN_SHAPE, g16)} zero, one "
          f"launch of 16 steps: {pinned_ms!r} ms, the compiled 8-step "
          f"launch {k8_ms!r}; bound {bound!r} ms ({by}); plain {plain!r} ms "
          f"[{card}]", flush=True)
    return out


def pin_harness(checks: Checks, card: str) -> None:
    """Phase 18e: ``bench.harness`` with ``--block-rows 32
    --steps-per-call 16`` on ``cuda`` at 1024x2048, 32 steps, the compute
    and device workloads: its rows labelled with the pins, and the pinned
    entry launched (the counts zeroed before, read after), no compiled
    K1 launch."""
    from grayscott_tpu_torch.bench import harness

    with tempfile.TemporaryDirectory(prefix="chip_smoke_harness_") as tmp:
        out = os.path.join(tmp, "sweep.json")
        reset_launches()
        rc = harness.main(["--backends", "cuda", "--smin", "10", "--smax",
                           "10", "--steps", "32", "--workloads",
                           "compute,device", "--reps", "3", "--block-rows",
                           "32", "--steps-per-call", "16", "-o", out])
        torch.cuda.synchronize()
        launches = {t: n for t, n in read_launches().items() if n}
        rows = json.load(open(out))
    table = [(r["workload"], r["block_rows"], r["steps_per_call"],
              r["gcells_per_sec"]) for r in rows]
    print(f"harness --block-rows 32 --steps-per-call 16: rc {rc}, rows "
          f"{table}, launches {launches} [{card}]", flush=True)
    checks.expect(rc == 0 and len(rows) == 2 and all(
        (r["block_rows"], r["steps_per_call"]) == (32, 16) for r in rows)
        and launches.get("windowed_pinned", 0) > 0
        and "windowed" not in launches,
        f"harness pins: rc {rc}, launches {launches}")


def pins_phase(checks: Checks, rng, card: str, log: str) -> tuple:
    """Phase 18: 18a-18e (18f is phase 12's tuner, whose candidates
    include K1's and K4's depth and tile candidates)."""
    n = compare_pins(checks, rng)
    pin_ptxas(checks, log)
    runs = pin_paths(checks, card)
    times = time_pins(rng, card)
    pin_harness(checks, card)
    return n, runs, times


# --- 19. the megakernels' tile pins (K2, K6, K7) and the sharded windowed --
# --- engine's K and row tile (K1's shard entry) ------------------------------

#: phase 19a: K2's pinned geometries (tr, tc) at the wrapper's level, and
#: the JAX pins (block_rows, block_cols) whose windows the rule refuses
MEGA_PIN_GEOMS = ((8, 64), (32, 128), (64, 128), (128, 32), (16, 256))
MEGA_PIN_GRID = [(tr, tc) for tr in (None, 8, 16, 32, 64, 128, 256)
                 for tc in (None, 128, 256, 384, 512, 640)]
#: the default run's shape, a ragged one, and one whose last tile row has
#: one row for every row tile of MEGA_PIN_GEOMS (1025 = 1024 + 1)
MEGA_PIN_SHAPES = [MAIN_SHAPE, (1000, 1917), (1025, 1920)]
#: K6's row tiles (JAX's packed megakernel takes no column tile)
MEGAPACK_PIN_ROWS = (8, 32, 128)
#: K7's pinned geometries and meshes
SHMEGA_PIN_GEOMS = ((32, 128), (64, 128), (16, 256))
SHMEGA_PIN_MESHES = ((1, 4), (4, 1), (2, 2))
#: K1's shard entry: (K, block_rows)
SHWIN_PIN_CASES = ((4, 32), (4, 64), (16, 32), (16, 64), (32, 32),
                   (32, 64))
#: K2's pinned entries by counter tag: (storage dtype, the fold)
MEGA_PIN_ENTRIES = {"mega_pinned": (torch.float32, False),
                    "mega_pinned_bf16": (torch.bfloat16, False),
                    "mega_pinned_fold": (torch.float32, True),
                    "mega_pinned_fold_bf16": (torch.bfloat16, True)}
#: phase 19c: label -> (flags, the counter of the entry that runs, the
#: label of the unpinned run whose frames it must equal, or None: the plain
#: replay at K = 16, bf16; the launches an image)
MEGA_FLAGS = ["--pallas-engine", "mega"]
BF16_FLAGS = ["--pallas-dtype", "bfloat16"]
FOLD_FLAGS = ["--pallas-naive-fold", "on"]
K16_FLAGS = ["--pallas-steps-per-call", "16"]
PIN19_REFS = {
    "mega": (MEGA_FLAGS, "mega", 1),
    "mega bf16": (MEGA_FLAGS + BF16_FLAGS, "mega_bf16", 1),
    "mega fold": (MEGA_FLAGS + FOLD_FLAGS, "mega_fold", 1),
    "mega fold bf16": (MEGA_FLAGS + FOLD_FLAGS + BF16_FLAGS,
                       "mega_fold_bf16", 1),
    "pack mega": (ZERO_PACKED + MEGA_FLAGS, "megapack", 1),
    "sharded mega": (SHARDED_FLAGS, "shmega", 1),
    "sharded mega bf16 1x4": (SHARDED_FLAGS + ["--sharded-mesh-cols", "4"]
                              + BF16_FLAGS, "shmega_bf16", 1),
    "sharded windowed": (WINDOWED_FLAGS["windowed"], "shwin", 4),
}
PIN19_PATHS = {
    "mega 32x128": (MEGA_FLAGS + ["--pallas-block-rows", "32",
                                  "--pallas-block-cols", "128"],
                    "mega_pinned", "mega", 1),
    "mega bf16 16": (MEGA_FLAGS + BF16_FLAGS + ["--pallas-block-rows", "16"],
                     "mega_pinned_bf16", "mega bf16", 1),
    "mega fold 64x128": (MEGA_FLAGS + FOLD_FLAGS
                         + ["--pallas-block-rows", "64",
                            "--pallas-block-cols", "128"],
                         "mega_pinned_fold", "mega fold", 1),
    "mega fold bf16 32": (MEGA_FLAGS + FOLD_FLAGS + BF16_FLAGS
                          + ["--pallas-block-rows", "32"],
                          "mega_pinned_fold_bf16", "mega fold bf16", 1),
    "pack mega 32": (ZERO_PACKED + MEGA_FLAGS + ["--pallas-block-rows", "32"],
                     "megapack_pinned", "pack mega", 1),
    "sharded mega 32x128": (SHARDED_FLAGS + ["--pallas-block-rows", "32",
                                             "--pallas-block-cols", "128"],
                            "shmega_pinned", "sharded mega", 1),
    "sharded mega bf16 1x4 64x128": (
        SHARDED_FLAGS + ["--sharded-mesh-cols", "4"] + BF16_FLAGS
        + ["--pallas-block-rows", "64", "--pallas-block-cols", "128"],
        "shmega_pinned_bf16", "sharded mega bf16 1x4", 1),
    "sharded windowed k16 32": (WINDOWED_FLAGS["windowed"] + K16_FLAGS
                                + ["--pallas-block-rows", "32"],
                                "shwin_pinned", "sharded windowed", 2),
    "sharded windowed bf16 k16 32": (
        WINDOWED_FLAGS["windowed"] + K16_FLAGS + BF16_FLAGS
        + ["--pallas-block-rows", "32"], "shwin_pinned_bf16", None, 2),
    "sharded windowed overlap k16 64": (
        WINDOWED_FLAGS["windowed"] + ["--sharded-overlap", "on"] + K16_FLAGS
        + ["--pallas-block-rows", "64"], "shwin_pinned", "sharded windowed",
        4),
}
#: phase 19d: the geometries timed in turns with the default (the first)
MEGA_PIN_TIMED = ((64, 64), (32, 128), (64, 128), (16, 256), (128, 32),
                  (8, 64))
MEGAPACK_PIN_TIMED = (64, 32, 128)
SHMEGA_PIN_TIMED = (None, (32, 128), (64, 128))
SHWIN_PIN_TIMED = ((8, None), (16, 32), (16, 64), (32, 32))
#: the new entries in the kernels line: tag -> (phase 19c path, the
#: geometry of its timed launch at 1080x1920)
PIN19_KERNELS = {
    "mega_pinned": ("mega 32x128", (32, 128)),
    "mega_pinned_bf16": ("mega bf16 16", (16, 64)),
    "mega_pinned_fold": ("mega fold 64x128", (64, 128)),
    "mega_pinned_fold_bf16": ("mega fold bf16 32", (32, 64)),
    "megapack_pinned": ("pack mega 32", (32, 64)),
    "shmega_pinned": ("sharded mega 32x128", (32, 128)),
    "shmega_pinned_bf16": ("sharded mega bf16 1x4 64x128", (64, 128)),
    "shwin_pinned": ("sharded windowed k16 32", (16, 32)),
    "shwin_pinned_bf16": ("sharded windowed bf16 k16 32", (16, 32)),
}
#: the pinned instantiations ptxas reports, by mangled kernel name
PIN19_PTXAS = {"18mega_pinned_kernel": 12,
               "25packed_mega_pinned_kernel": 1,
               "26sharded_mega_pinned_kernel": 16,
               "17shard_form_kernel": 16}


def pin19_compare(checks: Checks, tag: str, got, want, what: str) -> None:
    """Bit for bit; bf16 storage: NaN's own bit pattern aside."""
    if any(g.dtype == torch.bfloat16 for g in got):
        checks.compare_bf16(tag, got, want, what)
    else:
        checks.compare_bits(tag, got, want, what)


def mega_pin_plain(u, v, n_blocks: int, steps: int, tag: str,
                   boundary: str, params: Parameters):
    """The plain version of a K2 launch of ``tag``'s entry."""
    dtype, fold = MEGA_PIN_ENTRIES[tag]
    if fold:
        return megakernel.megastep_reference_fold(u, v, n_blocks, steps,
                                                  fold_constants(params))
    consts = kernel_constants(params)
    if dtype == torch.bfloat16:
        return megakernel.megastep_reference_bf16(u, v, n_blocks, steps,
                                                  consts, boundary)
    return stencil.run(u, v, n_blocks * steps, consts, boundary)


def compare_mega_pins(checks: Checks, rng) -> int:
    """Phase 19a: K2's pinned entries (float32 and bf16 on both boundaries,
    the fold on both storages) on each of MEGA_PIN_GEOMS, two time blocks
    of 8 steps (and one of 5 at 1080x1920) at MEGA_PIN_SHAPES and on a
    NaN/Inf state, K6's on MEGAPACK_PIN_ROWS, K7's on SHMEGA_PIN_GEOMS on
    each of SHMEGA_PIN_MESHES (float32 and bf16), and K1's shard entry at
    each (K, row tile) of SHWIN_PIN_CASES on the same meshes (and split
    into its overlap parts), each bit for bit against its plain version;
    the JAX pins of MEGA_PIN_GRID that the rule refuses, counted, each
    window past the shared memory. Returns the comparisons made."""
    n = refused = 0
    params = Parameters()
    consts = kernel_constants(params)
    for tr, tc in MEGA_PIN_GRID:
        try:
            geometry.mega_resolve(MAIN_SHAPE, tr, tc)
        except UnsupportedConfigError as e:
            nbytes = int(re.search(r"needs (\d+) B", str(e)).group(1))
            checks.expect(nbytes > geometry.SMEM_OPTIN,
                          f"mega pin {tr}x{tc} refused at {nbytes} B")
            refused += 1
    print(f"phase 19a: {refused} of {len(MEGA_PIN_GRID)} megakernel tile "
          f"pins refused at {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} (window past "
          f"{geometry.SMEM_OPTIN} B)", flush=True)
    states = [(s, False) for s in MEGA_PIN_SHAPES] + [(MAIN_SHAPE, True)]
    for shape, special in states:
        u_np, v_np = bf16_state(rng, shape, special)
        for tag, (dtype, fold) in MEGA_PIN_ENTRIES.items():
            u, v = (torch.from_numpy(x).to(DEVICE).to(dtype)
                    for x in (u_np, v_np))
            kc = fold_constants(params) if fold else consts
            for boundary in ("naive",) if fold else ("naive", "zero"):
                plans = [(2, 8)] + ([(3, 5)] if shape == MAIN_SHAPE
                                    and not special else [])
                for n_blocks, steps in plans:
                    want = mega_pin_plain(u, v, n_blocks, steps, tag,
                                          boundary, params)
                    for tr, tc in MEGA_PIN_GEOMS:
                        g = geometry.Geometry(tr, tc, geometry.HALO)
                        up, vp = (megakernel.pair_state(x) for x in (u, v))
                        megakernel.megastep(up, vp, n_blocks, steps, kc,
                                            boundary, fold=fold, geometry=g)
                        pin19_compare(
                            checks, tag, (up[0], vp[0]), want,
                            f"{pin_label(shape, g)} {boundary} {n_blocks}x"
                            f"{steps}{' NaN/Inf' if special else ''}")
                        n += 1
    pc = packed_constants(params)
    for shape in MEGA_PIN_SHAPES:
        u_np, v_np = bf16_state(rng, shape, False)
        x = packed.pack_state(*(torch.from_numpy(a).to(DEVICE)
                                for a in (u_np, v_np)))
        want = packed.packed_run(x, 16, pc)
        for tr in MEGAPACK_PIN_ROWS:
            g = geometry.mega_resolve(shape, tr, None)
            xp = megakernel.pair_state(x)
            megakernel.packed_megastep(xp, 2, 8, pc, geometry=g)
            checks.compare_bits("megapack_pinned", (xp[0],), (want,),
                                f"{pin_label(shape, g)} 2x8")
            n += 1
    dev = torch.device(DEVICE)
    for shape in (MAIN_SHAPE, (1001, 1917)):
        u_np, v_np = bf16_state(rng, shape, False)
        for n_r, n_c in SHMEGA_PIN_MESHES:
            for dtype in (torch.float32, torch.bfloat16):
                tag = "shmega_pinned" + (
                    "_bf16" if dtype == torch.bfloat16 else "")
                for boundary in ("naive", "zero"):
                    if boundary == "zero" and (shape != MAIN_SHAPE or
                                               dtype != torch.float32):
                        continue
                    mesh = halo.Mesh(n_r, n_c, dev)
                    up, vp = halo.mega_shard_state(u_np, v_np, mesh, dtype)
                    for x in (up, vp):
                        halo.exchange_halos(x)
                    cu, cv = up.clone(), vp.clone()
                    sharded_mega.sharded_megastep_reference(
                        cu, cv, 2, 8, consts, boundary, shape)
                    want = [halo.mega_unshard_result(x, shape)
                            for x in (cu, cv)]
                    for tr, tc in SHMEGA_PIN_GEOMS:
                        g = geometry.Geometry(tr, tc, geometry.HALO)
                        gu, gv = up.clone(), vp.clone()
                        sharded_mega.sharded_megastep(
                            gu, gv, mesh, 2, 8, consts, boundary, shape,
                            geometry=g)
                        got = [halo.mega_unshard_result(x, shape)
                               for x in (gu, gv)]
                        checks.compare_bits(
                            tag, got, want, f"{pin_label(shape, g)} mesh "
                            f"{n_r}x{n_c} {boundary}")
                        n += 1
        for n_r, n_c in SHMEGA_PIN_MESHES:
            for dtype in ((torch.float32, torch.bfloat16)
                          if shape == MAIN_SHAPE else (torch.float32,)):
                tag = "shwin_pinned" + (
                    "_bf16" if dtype == torch.bfloat16 else "")
                for k, tr in SHWIN_PIN_CASES:
                    h = geometry.halo_for_steps(k)
                    mesh = halo.Mesh(n_r, n_c, dev, h)
                    r_loc, c_loc = halo.shard_extents(shape, mesh)
                    g = geometry.resolve((r_loc, c_loc), k, tr)
                    up, vp = halo.mega_shard_state(u_np, v_np, mesh, dtype)
                    for x in (up, vp):
                        halo.exchange_halos(x, 0, h)
                    cu, cv = up.clone(), vp.clone()
                    windowed.shard_multistep_reference(
                        cu, cv, 0, k, consts, "naive", shape, "all", g)
                    want = [halo.mega_unshard_result(x, shape, 1, h)
                            for x in (cu, cv)]
                    parts = (("all",), ("interior", "edge")) \
                        if (k, tr) == (16, 64) else (("all",),)
                    for split in parts:
                        gu, gv = up.clone(), vp.clone()
                        for part in split:
                            windowed.shard_multistep(
                                gu, gv, mesh, 0, k, consts, "naive", shape,
                                part, geometry=g)
                        got = [halo.mega_unshard_result(x, shape, 1, h)
                               for x in (gu, gv)]
                        checks.compare_bits(
                            tag if not g.compiled else (
                                "shwin" + tag[12:]), got, want,
                            f"{pin_label(shape, g)} K={k} mesh {n_r}x{n_c}"
                            f" {'+'.join(split)}")
                        n += 1
    return n


def pin19_ptxas(checks: Checks, log: str) -> None:
    """Phase 19b: ptxas's report of the new pinned instantiations (K2's
    12, K6's, K7's 16, K1's shard entry's 16: the default stencils' tap set
    and any other, ``dispatch_taps_lean``, on run-time sizes, and the
    default set on the two compiled geometries): registers, stack and
    spills, none of which may spill or take a stack frame. (The compiled
    K2, K6 and K7 keep the parent's registers and SASS:
    ``scripts/sass_diff.py`` against the tree before.)"""
    if not log:
        print("phase 19b: the library was reused, no ptxas report",
              flush=True)
        return
    rows, entry, frame = {}, None, None
    for line in log.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            entry, frame = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = PTXAS_USED.search(line)
        if m and entry:
            rows[entry] = (int(m.group(1)), frame)
            entry = None
    for kernel, count in PIN19_PTXAS.items():
        found = {name: r for name, r in rows.items() if kernel in name}
        regs = sorted({r for r, _ in found.values()})
        bad = [f for _, f in found.values() if f != (0, 0, 0)]
        print(f"ptxas {kernel[2:]}: {len(found)} instantiations, registers "
              f"{regs}, stack or spills {bad}", flush=True)
        checks.expect(len(found) == count and not bad,
                      f"{kernel}: {len(found)} of {count} instantiations, "
                      f"stack or spills {bad}")


def pin19_replay(params: Parameters):
    """V after each image of the default run from the plain version on the
    card, bf16 storage rounded once a 16-step block."""
    u, v = (torch.from_numpy(x).to(DEVICE).to(torch.bfloat16)
            for x in initial_uv(MAIN_SHAPE))
    frames = []
    for _ in range(MAIN_IMAGES):
        u, v = stencil.run_bf16(u, v, MAIN_STEPS, kernel_constants(params),
                                "naive", block=16)
        frames.append(v.float())
    return frames


def pin19_paths(checks: Checks, card: str) -> dict:
    """Phase 19c: ``simulate.run`` (MAIN_IMAGES images of MAIN_STEPS steps
    at 1080x1920) on each unpinned run of PIN19_REFS and under each pin of
    PIN19_PATHS, the launch counts zeroed before each and read after; every
    pinned run's frames bit for bit its unpinned run's (the bf16 K = 16
    run: the plain replay's). Returns the runs by label."""
    refs, runs = {}, {}
    for label, (flags, tag, per_image) in PIN19_REFS.items():
        sim = shared.make_simulation(simulate.build_parser().parse_args(
            flags))
        refs[label] = ring_path(checks, f"{' '.join(flags)} (unpinned)",
                                sim, {tag: MAIN_IMAGES * per_image})
    for label, (flags, tag, ref, per_image) in PIN19_PATHS.items():
        sim = shared.make_simulation(simulate.build_parser().parse_args(
            flags))
        run = ring_path(checks, " ".join(flags), sim,
                        {tag: MAIN_IMAGES * per_image})
        want = (refs[ref]["frames"] if ref else
                [f.cpu().numpy() for f in pin19_replay(Parameters())])
        same = all(np.array_equal(a.view(np.int32), b.view(np.int32))
                   for a, b in zip(run["frames"], want))
        print(f"path simulate {' '.join(flags)}: frames bitwise "
              f"{'the unpinned run' if ref else 'the plain replay'}'s: "
              f"{same}; {run['ms']!r} ms/image (unpinned "
              f"{refs[ref]['ms'] if ref else float('nan')!r}) [{card}]",
              flush=True)
        checks.expect(same, f"simulate {label} frames")
        if not same:
            checks.kernel_err[tag] = float("inf")
        runs[label] = dict(run, tag=tag)
    return runs


def time_pin19(rng, card: str) -> dict:
    """Phase 19d: each pin per step in turns (2 rounds, in order and
    reversed) with the default geometry: K2 on MEGA_PIN_TIMED (one launch
    of 4 time blocks, naive) and K6 on MEGAPACK_PIN_TIMED (zero) at
    1080x1920 and 4096x4096, K7 on SHMEGA_PIN_TIMED on 2x2 and K1's shard
    entry on SHWIN_PIN_TIMED (K, row tile; 96 steps in blocks of K, the
    exchange between them) at 1080x1920; then one launch of each new entry
    at PIN19_KERNELS' geometry at 1080x1920, its plain version and its
    bound (at the output cell-steps, and at the stepped cells beside).
    Returns the times."""
    out = {}
    params = Parameters()
    consts = kernel_constants(params)
    pc = packed_constants(params)
    dev = torch.device(DEVICE)
    for shape in (MAIN_SHAPE, BENCH_SHAPE):
        reps = PIN_REPS[shape]
        u_np, v_np = (rng.uniform(0, 1, shape).astype(np.float32)
                      for _ in range(2))
        u, v = (torch.from_numpy(a).to(DEVICE) for a in (u_np, v_np))
        calls = {}
        for tr, tc in MEGA_PIN_TIMED:
            g = geometry.Geometry(tr, tc, geometry.HALO)
            up, vp = megakernel.pair_state(u), megakernel.pair_state(v)
            calls["K2", g] = (lambda up=up, vp=vp, g=g: megakernel.megastep(
                up, vp, 4, 8, consts, "naive", geometry=g), 32)
        x = packed.pack_state(u, v)
        for tr in MEGAPACK_PIN_TIMED:
            g = geometry.mega_resolve(shape, tr, None)
            xp = megakernel.pair_state(x)
            calls["K6", g] = (lambda xp=xp, g=g: megakernel.packed_megastep(
                xp, 4, 8, pc, geometry=g), 32)
        if shape == MAIN_SHAPE:
            mesh = halo.Mesh(2, 2, dev)
            r_loc, c_loc = halo.shard_extents(shape, mesh)
            for tiles in SHMEGA_PIN_TIMED:
                up, vp = halo.mega_shard_state(u, v, mesh)
                g = (geometry.Geometry(*tiles, geometry.HALO) if tiles
                     else None)
                calls["K7", g] = (lambda up=up, vp=vp, g=g:
                                  sharded_mega.sharded_megastep(
                                      up, vp, mesh, 4, 8, consts, "naive",
                                      shape, geometry=g), 32)
            for k, tr in SHWIN_PIN_TIMED:
                h = geometry.halo_for_steps(k)
                mesh_h = halo.Mesh(2, 2, dev, h)
                g = geometry.resolve((r_loc, c_loc), k, tr)
                up, vp = halo.mega_shard_state(u, v, mesh_h)

                def shwin(up=up, vp=vp, g=g, k=k, mesh_h=mesh_h):
                    slot = 0
                    for _ in range(PIN_TIME_STEPS // k):
                        halo.exchange_halos(up, slot, g.halo)
                        halo.exchange_halos(vp, slot, g.halo)
                        windowed.shard_multistep(up, vp, mesh_h, slot, k,
                                                 consts, "naive", shape,
                                                 geometry=g)
                        slot = 1 - slot
                calls["K1 shard", g, k] = (shwin, PIN_TIME_STEPS)
        samples = {c: [] for c in calls}
        order = list(calls)
        for r in range(PIN_ROUNDS):
            for c in (order if r % 2 == 0 else reversed(order)):
                samples[c].append(cuda_ms(calls[c][0], reps))
        first = {}
        for c in calls:
            ms = statistics.median(samples[c])
            steps = calls[c][1]
            first.setdefault(c[0], ms / steps)
            out[shape, c] = ms
            g = c[1]
            label = g.label() if g else "the compiled tiles (choose_tile)"
            print(f"time pins {c[0]} {shape[0]}x{shape[1]} {label}"
                  f"{f' K={c[2]}' if len(c) > 2 else ''}: {ms!r} ms for "
                  f"{steps} steps (turns {samples[c]!r}), {ms / steps!r} ms "
                  f"a step, {ms / steps / first[c[0]]!r}x the default "
                  f"geometry's [{card}]", flush=True)
    u_np, v_np = (rng.uniform(0, 1, MAIN_SHAPE).astype(np.float32)
                  for _ in range(2))
    for tag, (label, tiles) in PIN19_KERNELS.items():
        bf16 = tag.endswith("bf16")
        dtype = torch.bfloat16 if bf16 else torch.float32
        u, v = (torch.from_numpy(a).to(DEVICE).to(dtype)
                for a in (u_np, v_np))
        cell_bytes = 8 if bf16 else 16
        ops = ops_per_cell_step(params, "naive")
        if tag.startswith("mega_pinned"):
            _, fold = MEGA_PIN_ENTRIES[tag]
            g = geometry.Geometry(*tiles, geometry.HALO)
            kc = fold_constants(params) if fold else consts
            ops = fold_ops_per_cell_step(params) if fold else ops
            up, vp = megakernel.pair_state(u), megakernel.pair_state(v)
            ms = cuda_ms(lambda: megakernel.megastep(
                up, vp, 4, 8, kc, "naive", fold=fold, geometry=g), 10)
            plain = cuda_ms(lambda: mega_pin_plain(u, v, 4, 8, tag, "naive",
                                                   params), 2)
            steps, k = 32, 8
        elif tag == "megapack_pinned":
            g = geometry.Geometry(*tiles, geometry.HALO)
            x = packed.pack_state(u, v)
            xp = megakernel.pair_state(x)
            ms = cuda_ms(lambda: megakernel.packed_megastep(
                xp, 4, 8, pc, geometry=g), 10)
            plain = cuda_ms(lambda: packed.packed_run(x, 32, pc), 2)
            ops, steps, k = PACKED_OPS, 32, 8
        elif tag.startswith("shmega_pinned"):
            g = geometry.Geometry(*tiles, geometry.HALO)
            mesh = halo.Mesh(*((1, 4) if bf16 else (2, 2)), dev)
            up, vp = halo.mega_shard_state(u_np, v_np, mesh, dtype)
            ms = cuda_ms(lambda: sharded_mega.sharded_megastep(
                up, vp, mesh, 4, 8, consts, "naive", MAIN_SHAPE,
                geometry=g), 10)
            cu, cv = up.clone(), vp.clone()
            plain = cuda_ms(lambda: sharded_mega.sharded_megastep_reference(
                cu, cv, 4, 8, consts, "naive", MAIN_SHAPE), 1)
            steps, k = 32, 8
        else:
            k, tr = tiles
            mesh = halo.Mesh(2, 2, dev, geometry.halo_for_steps(k))
            g = geometry.resolve(halo.shard_extents(MAIN_SHAPE, mesh), k, tr)
            up, vp = halo.mega_shard_state(u_np, v_np, mesh, dtype)
            ms = cuda_ms(lambda: windowed.shard_multistep(
                up, vp, mesh, 0, k, consts, "naive", MAIN_SHAPE,
                geometry=g), 20)
            cu, cv = up.clone(), vp.clone()
            plain = cuda_ms(lambda: windowed.shard_multistep_reference(
                cu, cv, 0, k, consts, "naive", MAIN_SHAPE, "all", g), 1)
            steps = k
        bound, by = roofline_ms(MAIN_SHAPE, steps, ops, cell_bytes)
        stepped, _ = roofline_ms(MAIN_SHAPE, steps * g.stepped_ratio(k),
                                 ops, cell_bytes)
        out[tag] = (ms, plain, bound, by, stepped, g, steps)
        print(f"time {tag} {pin_label(MAIN_SHAPE, g)} "
              f"{'zero' if tag == 'megapack_pinned' else 'naive'}, one "
              f"launch of "
              f"{steps} steps: {ms!r} ms; bound {bound!r} ms ({by}) at the "
              f"output cell-steps, {stepped!r} ms at the stepped cells "
              f"({g.stepped_ratio(k)!r} a cell-step), {100 * bound / ms!r} "
              f"% / {100 * stepped / ms!r} % of them; plain {plain!r} ms "
              f"[{card}]", flush=True)
    return out


def pin19_phase(checks: Checks, rng, card: str, log: str) -> tuple:
    """Phase 19: 19a-19d (19e: the new entries in the kernels line; 19f is
    phase 12's tuner, whose candidates include K2's tile candidates)."""
    n = compare_mega_pins(checks, rng)
    pin19_ptxas(checks, log)
    runs = pin19_paths(checks, card)
    times = time_pin19(rng, card)
    return n, runs, times


# -- phase 20: two processes of the port on the one card ---------------------

#: the two-process runs: label -> (simulate flags after DIST_BASE, K, the
#: counter of the entry that runs); 2x1 is one shard a process, 2x2 a mesh
#: row a process
DIST_BASE = ["--backend", "sharded", "--sharded-engine", "windowed"]
DIST_RUNS = {
    "2x1 naive": (["--sharded-devices", "2", "--sharded-mesh-cols", "1",
                   "--sharded-overlap", "off"], 8, "shwin"),
    "2x1 zero": (["--sharded-devices", "2", "--sharded-mesh-cols", "1",
                  "--sharded-overlap", "off", "--boundary", "zero"], 8,
                 "shwin"),
    "2x1 naive bf16": (["--sharded-devices", "2", "--sharded-mesh-cols", "1",
                        "--sharded-overlap", "off", "--pallas-dtype",
                        "bfloat16"], 8, "shwin_bf16"),
    "2x2 naive": (["--sharded-devices", "4", "--sharded-mesh-cols", "2",
                   "--sharded-overlap", "off"], 8, "shwin"),
    "2x2 zero": (["--sharded-devices", "4", "--sharded-mesh-cols", "2",
                  "--sharded-overlap", "off", "--boundary", "zero"], 8,
                 "shwin"),
    "2x2 naive k16 overlap": (["--sharded-devices", "4",
                               "--sharded-mesh-cols", "2",
                               "--sharded-overlap", "on",
                               "--pallas-steps-per-call", "16"], 16,
                              "shwin_pinned"),
}
#: the runs timed in turns, one process against two
DIST_TIMED = ("2x1 naive", "2x2 naive")
DIST_IMAGES = 8
#: the children's limit, seconds: a child that hangs past it fails the phase
DIST_TIMEOUT = 150
#: exchanges and image gathers timed alone in each child
DIST_EXCHANGES = 50
DIST_GATHERS = 10


def frame_digests(frames) -> list:
    return [hashlib.sha256(np.ascontiguousarray(f).tobytes()).hexdigest()
            for f in frames]


def distributed_child(out: str) -> int:
    """One rank of phase 20 (``chip_smoke.py --distributed-child OUT``):
    joins the group that ``GRAYSCOTT_COORDINATOR`` names, runs every
    DIST_RUNS run through ``simulate.run`` with the launch counts zeroed
    before it and read after, times the DIST_TIMED runs twice (16 images),
    times DIST_EXCHANGES halo exchanges alone, checks that a pinned K7 is
    refused, and writes what it found to ``OUT/rank{r}.json``."""
    from grayscott_tpu_torch.utils import distributed

    distributed.maybe_initialize(init_logging())
    rank = distributed.process_index()
    report = {"rank": rank, "processes": distributed.process_count(),
              "device": str(torch.cuda.current_device()), "runs": {}}
    for label, (flags, _, _) in DIST_RUNS.items():
        frames, launches, sim, _ = run_frames(DIST_BASE + flags, DIST_IMAGES)
        report["runs"][label] = {
            "digests": frame_digests(frames),
            "launches": {t: n for t, n in launches.items() if n},
            "split": sim.overlap_runs(MAIN_SHAPE),
            "local": list(sim.mesh.local_shape),
            "origin": list(sim.mesh.origin)}
    report["ms"] = {label: [] for label in DIST_TIMED}
    for label in [*DIST_TIMED, *reversed(DIST_TIMED)]:
        report["ms"][label].append(simulate_turns.run_ms(
            DIST_BASE + DIST_RUNS[label][0], MAIN_IMAGES, MAIN_STEPS))
    # the host's parts of a two-process image, each alone: one exchange
    # (device copies, staging, gloo), its bands' gloo round trip on the
    # host, and the gather of one image
    import torch.distributed as tdist

    report["exchange_ms"], report["gloo_ms"], report["gather_ms"] = {}, {}, {}
    for label in DIST_TIMED:
        ns = simulate.build_parser().parse_args(DIST_BASE +
                                                DIST_RUNS[label][0])
        sim = shared.make_simulation(ns)
        species = sim.make_species(MAIN_SHAPE)
        pairs = species.storage[1:3]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DIST_EXCHANGES):
            halo.exchange(sim.mesh, pairs, 0)
        torch.cuda.synchronize()
        report["exchange_ms"][label] = (
            (time.perf_counter() - t0) / DIST_EXCHANGES * 1e3)
        cells = 2 * pairs[0].shape[1] * sim.mesh.halo * pairs[0].shape[4]
        send, got = torch.zeros(cells), torch.empty(cells)
        t0 = time.perf_counter()
        for _ in range(DIST_EXCHANGES):
            for work in (tdist.irecv(got, 1 - rank), tdist.isend(send,
                                                                 1 - rank)):
                work.wait()
        report["gloo_ms"][label] = (
            (time.perf_counter() - t0) / DIST_EXCHANGES * 1e3)
        frame = torch.empty(species.result().shape, pin_memory=True)
        t0 = time.perf_counter()
        for _ in range(DIST_GATHERS):
            distributed.gather(frame, species.blocks())
        report["gather_ms"][label] = (
            (time.perf_counter() - t0) / DIST_GATHERS * 1e3)
    try:
        shared.make_simulation(simulate.build_parser().parse_args(
            ["--backend", "sharded", "--sharded-engine", "mega",
             "--sharded-devices", "2"]))
        report["mega"] = None
    except UnsupportedConfigError as e:
        report["mega"] = str(e)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    print(f"RANK_OK {rank}", flush=True)
    return 0


#: phase 20a: (mesh, process of 2) whose block sits off the mesh's origin
DIST_OFFSETS = (((2, 2), 1), ((4, 1), 1), ((1, 4), 1))


def compare_offsets(checks: Checks, rng) -> int:
    """Phase 20a: K1's shard entries on one process's block of a mesh
    split over two (the block made here, without a group: rank 1's of 2x2,
    4x1 and 1x4, at mesh offsets (1, 0), (2, 0) and (0, 2)), at 1080x1920,
    both boundaries, on random pairs halos included: the compiled entry
    (8 steps), its bf16 twin and the pinned entry (K = 16), each bit for
    bit against the plain version at the same offset. Returns the count of
    comparisons."""
    consts = kernel_constants(Parameters())
    n = 0
    for (n_r, n_c), process in DIST_OFFSETS:
        for boundary in ("naive", "zero"):
            for tag, dtype, k in (("shwin", torch.float32, 8),
                                  ("shwin_bf16", torch.bfloat16, 8),
                                  ("shwin_pinned", torch.float32, 16)):
                mesh = halo.Mesh(n_r, n_c, torch.device(DEVICE),
                                 processes=2, process=process)
                r_loc, c_loc = halo.shard_extents(MAIN_SHAPE, mesh)
                g = geometry.resolve((r_loc, c_loc), k)
                mesh = mesh.with_halo(g.halo)
                shape = halo.pair_shape(MAIN_SHAPE, mesh)
                got = [torch.from_numpy(rng.uniform(0, 1, shape).astype(
                    np.float32)).to(DEVICE, dtype) for _ in range(2)]
                for x in got:
                    x[:, :, 1] = 0.0
                want = [x.clone() for x in got]
                windowed.shard_multistep(*got, mesh, 0, k, consts, boundary,
                                         MAIN_SHAPE, geometry=g)
                windowed.shard_multistep_reference(*want, 0, k, consts,
                                                   boundary, MAIN_SHAPE,
                                                   g=g, mesh=mesh)
                what = (f"at mesh offset {mesh.origin} ({n_r}x{n_c} over 2 "
                        f"processes, block {mesh.local_shape}) {boundary} "
                        f"K = {k}")
                compare = (checks.compare_bf16 if dtype == torch.bfloat16
                           else checks.compare_bits)
                compare(tag, [x[:, :, 1] for x in got],
                        [x[:, :, 1] for x in want], what)
                n += 1
    return n


def distributed_phase(checks: Checks, card: str) -> dict:
    """Phase 20: ``simulate`` in two processes of the port on the one card
    (``GRAYSCOTT_COORDINATOR=127.0.0.1:<free port>``, gloo, both on
    ``cuda:0``), each stepping its own shards with K1's shard entry. Every
    frame of each rank against the one-process run of the same flags,
    bit for bit (sha-256 of its bytes); each rank's launch counts (ceil(32 /
    K) an image of the entry that runs, twice with the overlap split, no
    other kernel); a pinned K7 refused on both ranks (ROADMAP.md Queue 1
    item 7.3); ms an image of two processes against one in turns (one,
    two, two, one), and the cross-process exchange's share of the call. A
    child that fails, hangs past DIST_TIMEOUT or exits non-zero fails the
    phase. Returns each run's launches by rank."""
    ref, one_ms = {}, {label: [] for label in DIST_TIMED}
    for label, (flags, _, _) in DIST_RUNS.items():
        ref[label] = frame_digests(run_frames(DIST_BASE + flags,
                                              DIST_IMAGES)[0])
    for label in DIST_TIMED:
        one_ms[label].append(simulate_turns.run_ms(
            DIST_BASE + DIST_RUNS[label][0], MAIN_IMAGES, MAIN_STEPS))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    procs = [subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__),
         "--distributed-child", out],
        env=dict(os.environ, GRAYSCOTT_COORDINATOR=f"127.0.0.1:{port}",
                 GRAYSCOTT_NUM_PROCESSES="2", GRAYSCOTT_PROCESS_ID=str(r),
                 GRAYSCOTT_HEARTBEAT_S="60"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    texts, t0 = [], time.perf_counter()
    try:
        for p in procs:
            left = DIST_TIMEOUT - (time.perf_counter() - t0)
            texts.append(p.communicate(timeout=max(left, 1))[0])
    except subprocess.TimeoutExpired:
        checks.expect(False, f"phase 20: a child ran past {DIST_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for label in reversed(DIST_TIMED):
        one_ms[label].append(simulate_turns.run_ms(
            DIST_BASE + DIST_RUNS[label][0], MAIN_IMAGES, MAIN_STEPS))
    reports = []
    for r, p in enumerate(procs):
        text = texts[r] if r < len(texts) else ""
        print(f"phase 20 rank {r} (exit {p.returncode}), the end of its "
              f"output:\n{text[-1500:]}", flush=True)
        checks.expect(p.returncode == 0 and f"RANK_OK {r}" in text,
                      f"phase 20: rank {r} exited {p.returncode}")
        path = os.path.join(out, f"rank{r}.json")
        reports.append(json.load(open(path)) if os.path.exists(path)
                       else None)
    if None in reports:
        checks.expect(False, "phase 20: a rank wrote no report")
        return {}
    launches = {}
    for label, (_, k, tag) in DIST_RUNS.items():
        runs = [rep["runs"][label] for rep in reports]
        split = runs[0]["split"]
        want = {tag: DIST_IMAGES * -(-MAIN_STEPS // k) * (2 if split else 1)}
        launches[label] = [run["launches"] for run in runs]
        for r, run in enumerate(runs):
            same = run["digests"] == ref[label]
            print(f"path simulate 2 processes {label} rank {r}: block "
                  f"{run['local']} at {run['origin']}, split {split}, "
                  f"launches {run['launches']} (expected {want}), "
                  f"{DIST_IMAGES} frames bitwise the one-process run's: "
                  f"{same}", flush=True)
            checks.expect(same, f"phase 20 {label} rank {r}: frames differ "
                          "from the one-process run's")
            checks.expect(run["launches"] == want, f"phase 20 {label} rank "
                          f"{r}: launches {run['launches']}, not {want}")
        checks.expect(split == ("overlap" in label),
                      f"phase 20 {label}: split {split}")
    for r, rep in enumerate(reports):
        print(f"phase 20 rank {r}: pinned K7 refused: {rep['mega']}",
              flush=True)
        checks.expect(bool(rep["mega"]) and "Queue 1 item 7.3" in rep["mega"],
                      f"phase 20 rank {r}: a pinned K7 was not refused")
    for label in DIST_TIMED:
        one = statistics.median(one_ms[label])
        two = [statistics.median(rep["ms"][label]) for rep in reports]
        calls = -(-MAIN_STEPS // DIST_RUNS[label][1])
        parts = {key: [rep[key][label] for rep in reports]
                 for key in ("exchange_ms", "gloo_ms", "gather_ms")}
        share = [(e * calls / t, g / t) for e, g, t in zip(
            parts["exchange_ms"], parts["gather_ms"], two)]
        print(f"time simulate {label} windowed K = 8, {MAIN_IMAGES} images "
              f"of {MAIN_STEPS} steps: one process {one_ms[label]!r} ms/image"
              f", two processes {[rep['ms'][label] for rep in reports]!r} "
              f"(ranks 0 and 1, in turns: one, two, two, one): "
              f"{two[0] / one!r}x; alone, by rank: one exchange across "
              f"processes {parts['exchange_ms']!r} ms ({calls} an image), "
              f"its bands' gloo round trip {parts['gloo_ms']!r} ms, the "
              f"gather of one image {parts['gather_ms']!r} ms; shares of the "
              f"two-process image (exchanges, gather) {share!r} [{card}]",
              flush=True)
    return launches

# --- 21. the lane fold (K1's folded entry) and the window ring at a pinned --
# --- tile (K2's pinned ring entries) -----------------------------------------

#: phase 21a: (shape, F) of the folded entry's checks at each of FOLD21_KS:
#: even panels, dead rows (1001 rows in 3 panels of 384), eight panels
FOLD21_CASES = [(MAIN_SHAPE, 2), ((1001, 1920), 3), ((4096, 512), 8)]
FOLD21_KS = (8, 16)
#: phase 21d: (shape, F) timed folded against unfolded K1, and the K of
#: the launches timed
FOLD21_TIMED = [(MAIN_SHAPE, 2), ((4096, 512), 8), ((2048, 256), 8)]
FOLD21_K = 8
#: phase 21b: label -> (flags, the counter of the entry that runs, the
#: label of the unfolded run whose frames it must equal, launches an image)
FOLD21_REFS = {
    "windowed": (["--pallas-engine", "windowed"], "windowed", 4),
    "windowed zero": (["--boundary", "zero", "--pallas-engine", "windowed",
                       "--pallas-pack", "off"], "windowed", 4),
}
FOLD21_PATHS = {
    "fold 2": (["--pallas-fold", "2"], "windowed_folded", "windowed", 4),
    "fold 2 k16": (["--pallas-fold", "2", "--pallas-steps-per-call", "16"],
                   "windowed_folded", "windowed", 2),
    "fold 2 zero": (["--boundary", "zero", "--pallas-fold", "2"],
                    "windowed_folded", "windowed zero", 4),
}
#: K2's pinned ring entries by counter tag: (storage dtype, the fold), and
#: the pinned double buffer's tag of each
RING21_ENTRIES = {"mega_pinned_ring": (torch.float32, False),
                  "mega_pinned_ring_bf16": (torch.bfloat16, False),
                  "mega_pinned_ring_fold": (torch.float32, True),
                  "mega_pinned_ring_fold_bf16": (torch.bfloat16, True)}
RING21_BASE = {tag: tag.replace("_ring", "") for tag in RING21_ENTRIES}
#: (tiles, depth) of the pinned rings checked and timed at 1080x1920, and
#: the one of the simulate paths and the kernels line
RING21_CASES = (((32, 128), 3), ((16, 64), 4), ((16, 64), 8), ((8, 256), 3))
RING21_PATH = ((16, 64), 4)
#: the new instantiations ptxas reports, by mangled kernel name
FOLD21_PTXAS = {"18folded_form_kernel": 14, "19fold_refresh_kernel": 1,
                "18ring_pinned_kernel": 24}
#: phase 21c/21d: rounds in turns (in order, then reversed), launches a
#: sample
FOLD21_ROUNDS = 2
FOLD21_REPS = 20


def fold21_plan(shape, f: int, k: int):
    """(geometry, Rp) of a folded run of ``shape`` at F and K: the panel's
    default tiles (``CudaSimulation.plan_for``), Rp from its row tile."""
    g = geometry.resolve((-(-shape[0] // f), shape[1]), k)
    return g, lane_fold.fold_geometry(shape[0], f, g.tr)


def fold21_state(u_np, v_np, f: int, g):
    """The folded state of host arrays on the card, its halos 0.0 (the
    entry refreshes them)."""
    return lane_fold.fold_state(u_np, v_np, f, g.tr, g.halo, DEVICE)


def fold21_stepped_rows(shape, f: int, g, rp: int) -> int:
    """Rows of the tiles the folded entry steps: each panel's tile rows
    that start inside the domain (a tile of dead rows returns at once)."""
    rows = 0
    for p in range(f):
        live = min(rp, shape[0] - p * rp)
        rows += max(0, -(-live // g.tr) * g.tr)
    return rows


def compare_folded(checks: Checks, rng) -> int:
    """Phase 21a: K1's folded entry (the refresh, then K in FOLD21_KS
    steps) on each of FOLD21_CASES, both boundaries (and at 1080x1920 a
    state with NaN and +-Inf in interior and edge tiles and at the panels'
    seam): bit for bit its plain version (the folded tensors, the
    refreshed input's halos among them), and the unfolded K1 on the same
    domain (one launch of K steps). Returns the comparisons made."""
    n = 0
    consts = kernel_constants(Parameters())
    for shape, f in FOLD21_CASES:
        for special in ((False, True) if shape == MAIN_SHAPE else (False,)):
            u_np, v_np = bf16_state(rng, shape, special)
            for k in FOLD21_KS:
                g, rp = fold21_plan(shape, f, k)
                if special:
                    # either side of the seam between panels 0 and 1
                    u_np[rp - 1, -1] = v_np[rp, 0] = np.nan
                    u_np[rp, -1] = -np.inf
                    v_np[rp - 1, 0] = np.inf
                ut, vt = (torch.from_numpy(x).to(DEVICE) for x in (u_np, v_np))
                for boundary in ("naive", "zero"):
                    what = (f"{pin_label(shape, g)} F={f} Rp={rp} K={k} "
                            f"{boundary}{' NaN/Inf' if special else ''}")
                    u, v = fold21_state(u_np, v_np, f, g)
                    pu, pv = u.clone(), v.clone()
                    uo, vo = torch.zeros_like(u), torch.zeros_like(v)
                    windowed.folded_multistep(u, v, uo, vo, k, consts,
                                              boundary, shape, rp, g)
                    po, qo = torch.zeros_like(u), torch.zeros_like(v)
                    windowed.folded_multistep_reference(
                        pu, pv, po, qo, k, consts, boundary, shape, rp,
                        g.halo)
                    checks.compare_bits("windowed_folded", (uo, vo, u, v),
                                        (po, qo, pu, pv), what)
                    ku, kv = torch.empty_like(ut), torch.empty_like(vt)
                    windowed.multistep(ut, vt, ku, kv, k, consts, boundary,
                                       geometry=geometry.resolve(shape, k))
                    got = [lane_fold.unfold_state(x, g.halo, f, shape[1],
                                                  shape[0]) for x in (uo, vo)]
                    checks.compare_bits("windowed_folded", got, (ku, kv),
                                        f"{what} vs the unfolded K1")
                    n += 2
    return n


def ring21_plain(u, v, n_blocks: int, tag: str, boundary: str):
    """The plain version of ``tag``'s K2 entry: ``n_blocks`` time blocks
    of 8 steps."""
    dtype, fold = RING21_ENTRIES[tag]
    params = Parameters()
    if fold:
        return megakernel.megastep_reference_fold(u, v, n_blocks, 8,
                                                  fold_constants(params))
    consts = kernel_constants(params)
    if dtype == torch.bfloat16:
        return megakernel.megastep_reference_bf16(u, v, n_blocks, 8, consts,
                                                  boundary)
    return stencil.run(u, v, 8 * n_blocks, consts, boundary)


def ring21_run(u, v, n_blocks: int, tag: str, boundary: str, tiles,
               depth: int):
    """(U, V) after one launch of ``n_blocks`` time blocks of 8 steps of
    ``tag``'s K2 entry on ``tiles`` at ``depth``."""
    fold = RING21_ENTRIES[tag][1]
    params = Parameters()
    k = fold_constants(params) if fold else kernel_constants(params)
    pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
    megakernel.megastep(pu, pv, n_blocks, 8, k, boundary, fold=fold,
                        depth=depth,
                        geometry=geometry.Geometry(*tiles, geometry.HALO))
    return pu[0], pv[0]


def compare_ring21(checks: Checks, rng) -> int:
    """Phase 21a: each pinned ring entry of K2 (float32, bf16, the fold,
    the fold on bf16) on each of RING21_CASES at 1080x1920 (and a NaN/Inf
    state), one launch of RING_BLOCKS time blocks of 8 steps, naive and
    zero where the entry takes them: bit for bit its plain version and the
    pinned double buffer on the same tiles (bf16: NaN's positions, then
    every other cell's bits); each ring's geometry beside the occupancy
    API's blocks. Returns the comparisons made."""
    n = 0
    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for tiles, depth in RING21_CASES:
        ring = megakernel.ring_geometry(
            MAIN_SHAPE, depth, tiles=geometry.Geometry(*tiles, geometry.HALO))
        blocks = megakernel.pinned_ring_max_blocks(dev, ring)
        print(f"ring pinned {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} "
              f"{tiles[0]}x{tiles[1]} mega_depth={depth}: depth "
              f"{ring.depth}, {ring.buffers} buffers, {ring.bytes} B a block, "
              f"{ring.blocks_per_sm} blocks an SM by shared memory; "
              f"occupancy API {blocks} blocks", flush=True)
        checks.expect(ring.ring and sms <= blocks <= ring.blocks_per_sm * sms,
                      f"pinned ring {tiles} depth {depth}: {blocks} blocks")
    for special in (False, True):
        u_np, v_np = bf16_state(rng, MAIN_SHAPE, special)
        for tag, (dtype, fold) in RING21_ENTRIES.items():
            u, v = (torch.from_numpy(x).to(DEVICE).to(dtype)
                    for x in (u_np, v_np))
            compare = (checks.compare_bf16 if dtype == torch.bfloat16
                       else checks.compare_bits)
            for boundary in ("naive",) if fold else ("naive", "zero"):
                want = ring21_plain(u, v, RING_BLOCKS, tag, boundary)
                for tiles, depth in RING21_CASES:
                    got = ring21_run(u, v, RING_BLOCKS, tag, boundary, tiles,
                                     depth)
                    what = (f"{MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} {boundary}"
                            f"{' NaN/Inf' if special else ''} {RING_BLOCKS}x8 "
                            f"steps on {tiles[0]}x{tiles[1]} tiles at "
                            f"mega_depth={depth}")
                    compare(tag, got, want, what)
                    at2 = ring21_run(u, v, RING_BLOCKS, tag, boundary, tiles,
                                     2)
                    same = same_bits(got, at2)
                    print(f"compare {tag} {what} vs depth 2: bitwise {same}",
                          flush=True)
                    checks.expect(same, f"{tag} {what} vs depth 2")
                    n += 2
    return n


def fold21_ptxas(checks: Checks, log: str) -> None:
    """Phase 21a: ptxas's report of the folded entry's form (14
    instantiations: the entry's 4 on run-time sizes and 4 compiled, its
    split's 6, naive; the first form's refresh kernel, 1) and the pinned ring's
    24 (12 bound to one block an SM, 12 to two): registers, stack and
    spills, none of which may spill or take a stack frame."""
    if not log:
        print("phase 21a: the library was reused, no ptxas report",
              flush=True)
        return
    rows = {}
    entry = frame = None
    for line in log.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            entry, frame = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = PTXAS_USED.search(line)
        if m and entry:
            rows[entry] = (int(m.group(1)), frame)
            entry = None
    for kernel, count in FOLD21_PTXAS.items():
        found = {name: r for name, r in rows.items() if kernel in name}
        regs = sorted({r for r, _ in found.values()})
        bad = [f for _, f in found.values() if f != (0, 0, 0)]
        print(f"ptxas {kernel[2:]}: {len(found)} instantiations, registers "
              f"{regs}, stack or spills {bad}", flush=True)
        checks.expect(len(found) == count and not bad,
                      f"{kernel}: {len(found)} of {count} instantiations, "
                      f"stack or spills {bad}")


def fold21_paths(checks: Checks, card: str) -> dict:
    """Phase 21b: ``simulate.run`` (MAIN_IMAGES images of MAIN_STEPS steps
    at 1080x1920) under each fold pin of FOLD21_PATHS against the unfolded
    K1 of FOLD21_REFS, and ``CudaSimulation(engine='mega',
    mega_depth=RING21_PATH's depth, block_rows=16)`` for each pinned ring
    entry against the same tiles at depth 2: the launch counts zeroed
    before each run and read after, every frame bit for bit the unfolded
    (or depth-2) run's; then each pair again in turns. Returns the runs
    by label, each with ``ms`` an image and its twin's ``ms2``."""
    refs, runs = {}, {}
    for label, (flags, tag, per_image) in FOLD21_REFS.items():
        sim = shared.make_simulation(simulate.build_parser().parse_args(
            flags))
        refs[label] = ring_path(checks, " ".join(flags), sim,
                                {tag: MAIN_IMAGES * per_image})
    for label, (flags, tag, ref, per_image) in FOLD21_PATHS.items():
        sim = shared.make_simulation(simulate.build_parser().parse_args(
            flags))
        run = ring_path(checks, " ".join(flags), sim,
                        {tag: MAIN_IMAGES * per_image})
        runs[label] = dict(run, tag=tag, ref=refs[ref])
    (tr, tc), depth = RING21_PATH
    per_image = expected_launches("mega", 1, MAIN_STEPS)
    for tag, (dtype, fold) in RING21_ENTRIES.items():
        kwargs = dict(engine="mega", tuned_lookup=False, block_rows=tr,
                      dtype=str(dtype)[6:], naive_fold=fold)
        got = ring_path(
            checks, f"{tag} mega_depth={depth} block_rows={tr}",
            CudaSimulation(Parameters(), "naive", device=DEVICE,
                           mega_depth=depth, **kwargs),
            {tag: MAIN_IMAGES * per_image})
        ref = ring_path(
            checks, f"{RING21_BASE[tag]} mega_depth=2 block_rows={tr}",
            CudaSimulation(Parameters(), "naive", device=DEVICE,
                           mega_depth=2, **kwargs),
            {RING21_BASE[tag]: MAIN_IMAGES * per_image})
        runs[tag] = dict(got, tag=tag, ref=ref)
    for label, run in runs.items():
        ref = run["ref"]
        same = all(np.array_equal(a.view(np.int32), b.view(np.int32))
                   for a, b in zip(run["frames"], ref["frames"]))
        print(f"path simulate {label}: frames bitwise the "
              f"{'depth-2' if label in RING21_ENTRIES else 'unfolded'} "
              f"run's: {same} [{card}]", flush=True)
        checks.expect(same, f"simulate {label} frames")
        if not same:
            checks.kernel_err[run["tag"]] = float("inf")
        turns = ([], [])
        for r in range(2 * FOLD21_ROUNDS):
            for side in ((0, 1) if r % 2 == 0 else (1, 0)):
                turns[side].append(sim_path_ms((run, ref)[side]["sim"]))
        run["ms"], run["ms2"] = (statistics.median(t) for t in turns)
        print(f"path simulate {label} in turns: {run['ms']!r} ms/image "
              f"({turns[0]!r}) against {run['ms2']!r} ({turns[1]!r}): "
              f"{run['ms'] / run['ms2']!r}x [{card}]", flush=True)
    return runs


def time_fold21(rng, card: str) -> dict:
    """Phase 21c: at each of FOLD21_TIMED, naive, in turns (FOLD21_ROUNDS
    rounds, in order and reversed): one call of FOLD21_K steps of the
    folded entry (its refresh and its step) against one launch of the
    unfolded K1 (the compiled entry), and FOLD21_K * 4 steps through the
    backend folded against unfolded; then at 1080x1920 the folded call's
    plain version and bound (the output cell-steps, the stepped cells
    beside). Returns {(shape, what): ms} and the kernels line's numbers
    under "windowed_folded"."""
    out = {}
    params = Parameters()
    consts = kernel_constants(params)
    k = FOLD21_K
    for shape, f in FOLD21_TIMED:
        u_np, v_np = (rng.uniform(0, 1, shape).astype(np.float32)
                      for _ in range(2))
        g, rp = fold21_plan(shape, f, k)
        u, v = fold21_state(u_np, v_np, f, g)
        uo, vo = torch.empty_like(u), torch.empty_like(v)
        ut, vt = (torch.from_numpy(x).to(DEVICE) for x in (u_np, v_np))
        ko, kv = torch.empty_like(ut), torch.empty_like(vt)
        sims = {}
        for label, fold in (("backend folded", f), ("backend unfolded",
                                                     "off")):
            sim = CudaSimulation(params, "naive", device=DEVICE, fold=fold,
                                 engine="windowed", tuned_lookup=False)
            species = sim.make_species(shape)
            sims[label] = (lambda sim=sim, species=species:
                           sim.prepare_steps(species, 4 * k), 4 * k)
        calls = {
            "folded launch": (lambda: windowed.folded_multistep(
                u, v, uo, vo, k, consts, "naive", shape, rp, g), k),
            "K1 launch": (lambda: windowed.multistep(
                ut, vt, ko, kv, k, consts, "naive"), k),
            **sims}
        samples = {c: [] for c in calls}
        order = list(calls)
        for r in range(FOLD21_ROUNDS):
            for c in (order if r % 2 == 0 else reversed(order)):
                samples[c].append(cuda_ms(calls[c][0], FOLD21_REPS))
        ms = {c: statistics.median(s) for c, s in samples.items()}
        out.update({(shape, c): m for c, m in ms.items()})
        for c in calls:
            print(f"time fold {shape[0]}x{shape[1]} F={f} Rp={rp} "
                  f"{g.label()} {c}, {calls[c][1]} steps: {ms[c]!r} ms "
                  f"(turns {samples[c]!r}) [{card}]", flush=True)
        print(f"time fold {shape[0]}x{shape[1]} F={f}: folded call "
              f"{ms['folded launch'] / ms['K1 launch']!r}x the unfolded K1's"
              f" launch; through the backend "
              f"{ms['backend folded'] / ms['backend unfolded']!r}x; stepped "
              f"rows {fold21_stepped_rows(shape, f, g, rp)} against "
              f"{-(-shape[0] // 64) * 64} [{card}]", flush=True)
        if shape == MAIN_SHAPE:
            pu, pv = torch.empty_like(u), torch.empty_like(v)
            plain = cuda_ms(lambda: windowed.folded_multistep_reference(
                u, v, pu, pv, k, consts, "naive", shape, rp, g.halo), 2)
            ops = ops_per_cell_step(params, "naive")
            bound, by = roofline_ms(shape, k, ops)
            ratio = (g.stepped_ratio(k) * fold21_stepped_rows(shape, f, g, rp)
                     / shape[0])
            stepped, _ = roofline_ms(shape, k * ratio, ops)
            out["windowed_folded"] = (ms["folded launch"], plain, bound, by,
                                      stepped, ms["K1 launch"], f, rp, g)
            print(f"time windowed_folded {pin_label(shape, g)} F={f} naive, "
                  f"one launch of {k} steps: {ms['folded launch']!r} ms; "
                  f"bound {bound!r} ms ({by}) at the output cell-steps, "
                  f"{stepped!r} ms at the stepped cells ({ratio!r} a "
                  f"cell-step), {100 * bound / ms['folded launch']!r} % / "
                  f"{100 * stepped / ms['folded launch']!r} % of them; plain "
                  f"{plain!r} ms [{card}]", flush=True)
    return out


def time_ring21(rng, card: str) -> dict:
    """Phase 21c: each ring of RING21_CASES against depth 2 on the same
    tiles, one launch of 4 time blocks of 8 steps at 1080x1920, naive,
    float32, in turns; then each entry on RING21_PATH at its depth and at
    depth 2, its plain version and its bound (the output cell-steps, the
    stepped cells beside). Returns {(tiles, depth): ms} and the kernels
    line's numbers by tag."""
    out = {}
    params = Parameters()
    u_np, v_np = (rng.uniform(0, 1, MAIN_SHAPE).astype(np.float32)
                  for _ in range(2))
    n_blocks, steps = 4, 32
    calls = {}
    for tiles, depth in RING21_CASES:
        for d in (depth, 2):
            pu, pv = (megakernel.pair_state(torch.from_numpy(a).to(DEVICE))
                      for a in (u_np, v_np))
            calls[tiles, depth, d] = (
                lambda pu=pu, pv=pv, tiles=tiles, d=d: megakernel.megastep(
                    pu, pv, n_blocks, 8, kernel_constants(params), "naive",
                    depth=d, geometry=geometry.Geometry(*tiles, 8)))
    samples = {c: [] for c in calls}
    order = list(calls)
    for r in range(FOLD21_ROUNDS):
        for c in (order if r % 2 == 0 else reversed(order)):
            samples[c].append(cuda_ms(calls[c], FOLD21_REPS))
    bound, by = bound_ms(MAIN_SHAPE, steps, "naive")
    for tiles, depth in RING21_CASES:
        ms = statistics.median(samples[tiles, depth, depth])
        ms2 = statistics.median(samples[tiles, depth, 2])
        out[tiles, depth] = (ms, ms2)
        print(f"time mega_pinned_ring {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} naive "
              f"{tiles[0]}x{tiles[1]} tiles mega_depth={depth}, {steps} "
              f"steps a launch: {ms!r} ms (turns "
              f"{samples[tiles, depth, depth]!r}), depth 2 {ms2!r} ms (turns "
              f"{samples[tiles, depth, 2]!r}): {ms / ms2!r}x; bound "
              f"{bound!r} ms ({by}), {100 * bound / ms!r} % of it [{card}]",
              flush=True)
    tiles, depth = RING21_PATH
    g = geometry.Geometry(*tiles, geometry.HALO)
    for tag, (dtype, fold) in RING21_ENTRIES.items():
        u, v = (torch.from_numpy(a).to(DEVICE).to(dtype)
                for a in (u_np, v_np))
        k = fold_constants(params) if fold else kernel_constants(params)
        times = []
        for d in (depth, 2):
            pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
            times.append(cuda_ms(lambda pu=pu, pv=pv, d=d: megakernel.megastep(
                pu, pv, n_blocks, 8, k, "naive", fold=fold, depth=d,
                geometry=g), FOLD21_REPS))
        plain = cuda_ms(lambda: ring21_plain(u, v, n_blocks, tag, "naive"), 2)
        ops = (fold_ops_per_cell_step(params) if fold
               else ops_per_cell_step(params, "naive"))
        cell_bytes = 8 if dtype == torch.bfloat16 else 16
        b, b_by = roofline_ms(MAIN_SHAPE, steps, ops, cell_bytes)
        stepped, _ = roofline_ms(MAIN_SHAPE, steps * g.stepped_ratio(8), ops,
                                 cell_bytes)
        out[tag] = (times[0], plain, b, b_by, stepped, times[1])
        print(f"time {tag} {pin_label(MAIN_SHAPE, g)} mega_depth={depth} "
              f"naive, one launch of {steps} steps: {times[0]!r} ms (depth 2 "
              f"{times[1]!r}); bound {b!r} ms ({b_by}) at the output "
              f"cell-steps, {stepped!r} ms at the stepped cells, "
              f"{100 * b / times[0]!r} % / {100 * stepped / times[0]!r} % of "
              f"them; plain {plain!r} ms [{card}]", flush=True)
    return out


def fold21_phase(checks: Checks, rng, card: str, log: str) -> tuple:
    """Phase 21: 21a (the folded entry's and the pinned rings' checks and
    ptxas), 21b (the simulate paths), 21c (times)."""
    fold21_ptxas(checks, log)
    n = compare_folded(checks, rng) + compare_ring21(checks, rng)
    runs = fold21_paths(checks, card)
    times = time_fold21(rng, card)
    times.update(time_ring21(rng, card))
    return n, runs, times


# --- 22. the window ring's redesign (K2 ring, K2 ring pinned) ----------------

#: the rings of phase 22's split: the compiled geometries at these depths,
#: and pinned (tiles, depth)
RING22_DEPTHS = (3, 4, 8)
RING22_PINNED = (((16, 64), 4), ((32, 128), 3), ((8, 256), 3))
#: the ring kernels' instantiations ptxas reports, by mangled kernel name:
#: the entries (none may spill or take a stack frame) and the ablation parts
RING22_PTXAS = {"11ring_kernel": 44, "18ring_pinned_kernel": 24}
RING22_ABLATION_PTXAS = {"20ring_ablation_kernel": 18,
                         "27ring_pinned_ablation_kernel": 9}
#: phase 22c: reps a sample by shape, and rounds (in order, then reversed)
RING22_REPS = {MAIN_SHAPE: 20, BENCH_SHAPE: 5}
RING22_ROUNDS = 2


def ring22_cases():
    """(label, depth, pinned tiles or None) of phase 22's rings."""
    cases = [(f"depth {d}", d, None) for d in RING22_DEPTHS]
    cases += [(f"{t[0]}x{t[1]} depth {d}", d,
               geometry.Geometry(*t, geometry.HALO))
              for t, d in RING22_PINNED]
    return cases


def ring22_parts(shape, depth: int, tiles) -> list:
    """The ablation parts that run on this ring (part 6 and 7's in-place
    steps hold a bounded number of strips a thread)."""
    parts = []
    for part in megakernel.RING_ABLATIONS:
        try:
            megakernel.ring_ablation_plan(shape, depth, part, tiles)
        except ValueError as err:
            print(f"ring22 {shape[0]}x{shape[1]} depth {depth} "
                  f"{tiles.label() if tiles else ''} part {part}: {err}",
                  flush=True)
            continue
        parts.append(part)
    return parts


def ring22_ptxas(checks: Checks, log: str) -> None:
    """Phase 22a: ptxas's report of the ring kernels (the entries' and the
    ablation parts' instantiations): registers, stack frame and spills.
    No entry may spill or take a stack frame; an ablation part's spills
    are reported beside its time."""
    if not log:
        print("phase 22a: the library was reused, no ptxas report",
              flush=True)
        return
    rows = {}
    entry = frame = None
    for line in log.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            entry, frame = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = PTXAS_USED.search(line)
        if m and entry:
            rows[entry] = (int(m.group(1)), frame)
            entry = None
    for kernels, strict in ((RING22_PTXAS, True),
                            (RING22_ABLATION_PTXAS, False)):
        for kernel, count in kernels.items():
            found = {name: r for name, r in rows.items() if kernel in name}
            for name, (regs, f) in sorted(found.items()):
                print(f"ptxas {name}: {regs} registers, stack frame, spill "
                      f"stores, spill loads {f}", flush=True)
            bad = {n: f for n, (_, f) in found.items() if f != (0, 0, 0)}
            print(f"ptxas {kernel[2:]}: {len(found)} instantiations, "
                  f"registers {sorted({r for r, _ in found.values()})}, "
                  f"stack or spills {list(bad.values())}", flush=True)
            checks.expect(len(found) == count and (not strict or not bad),
                          f"{kernel}: {len(found)} of {count} "
                          f"instantiations, stack or spills {bad}")


def ring22_plain(u, v, n_blocks: int):
    """The plain version of K2 naive, float32: n_blocks time blocks of 8."""
    return stencil.run(u, v, 8 * n_blocks, kernel_constants(Parameters()),
                       "naive")


def ring22_part(u, v, n_blocks: int, depth: int, tiles, part):
    """(U, V) after one launch of ``n_blocks`` time blocks of 8 steps of
    the ring's ablation ``part`` (None: the entry, the second form) at
    ``depth`` on ``tiles`` (None: the compiled geometries)."""
    consts = kernel_constants(Parameters())
    pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
    if part is None:
        megakernel.megastep(pu, pv, n_blocks, 8, consts, "naive",
                            depth=depth, geometry=tiles)
    else:
        megakernel.ring_ablation(pu, pv, n_blocks, 8, consts, part, depth,
                                 geometry=tiles)
    return pu[0], pv[0]


def compare_ring22(checks: Checks, rng) -> int:
    """Phase 22b: every ablation part of the ring (RING_ABLATIONS) on each
    of phase 22's rings, one launch of RING_BLOCKS time blocks of 8 steps
    at 1080x1920 (and a NaN/Inf state) and 4096^2, naive, float32: bit for
    bit the plain version (part 2, which steps nothing: its input) and the
    entry. Returns the comparisons made."""
    n = 0
    for shape in RING_SHAPES:
        for special in ((False, True) if shape == MAIN_SHAPE else (False,)):
            u_np, v_np = bf16_state(rng, shape, special)
            u, v = (torch.from_numpy(x).to(DEVICE) for x in (u_np, v_np))
            want = ring22_plain(u, v, RING_BLOCKS)
            for label, depth, tiles in ring22_cases():
                entry = ring22_part(u, v, RING_BLOCKS, depth, tiles, None)
                for part in ring22_parts(shape, depth, tiles):
                    got = ring22_part(u, v, RING_BLOCKS, depth, tiles, part)
                    ref = (u, v) if part == 2 else want
                    same = same_bits(got, ref)
                    same_entry = part == 2 or same_bits(got, entry)
                    what = (f"ring22 {shape[0]}x{shape[1]}"
                            f"{' NaN/Inf' if special else ''} {label} part "
                            f"{part}")
                    print(f"compare {what} vs "
                          f"{'its input' if part == 2 else 'plain'}: bitwise "
                          f"{same}; vs the entry {same_entry}", flush=True)
                    checks.expect(same and same_entry, what)
                    n += 1
    return n


def time_ring22(rng, card: str) -> dict:
    """Phase 22c: on each of phase 22's rings at 1080x1920 and 4096^2,
    naive, float32, one launch of 4 time blocks of 8 steps (32 steps) of
    every ablation part, of the entry (the second form) and of depth 2 on
    the same tiles, in device time (``queued_ms``), in turns (RING22_ROUNDS
    rounds, in order and reversed); each beside part 0 and the bound.
    Returns {(shape, label): {part, "entry" or "depth 2": ms}}."""
    out = {}
    consts = kernel_constants(Parameters())
    steps = MAIN_STEPS
    for shape in RING_SHAPES:
        u_np, v_np = (rng.uniform(0, 1, shape).astype(np.float32)
                      for _ in range(2))
        u, v = (torch.from_numpy(x).to(DEVICE) for x in (u_np, v_np))
        bound, by = bound_ms(shape, steps, "naive")
        for label, depth, tiles in ring22_cases():
            calls = {}
            for key in [*ring22_parts(shape, depth, tiles), "entry",
                        "depth 2"]:
                pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
                if key == "entry" or key == "depth 2":
                    d = depth if key == "entry" else 2
                    calls[key] = (
                        lambda pu=pu, pv=pv, d=d: megakernel.megastep(
                            pu, pv, steps // 8, 8, consts, "naive", depth=d,
                            geometry=tiles))
                else:
                    calls[key] = (
                        lambda pu=pu, pv=pv, p=key:
                        megakernel.ring_ablation(pu, pv, steps // 8, 8,
                                                 consts, p, depth,
                                                 geometry=tiles))
            order = list(calls)
            samples = {key: [] for key in order}
            for _ in range(RING22_ROUNDS):
                for key in order + order[::-1]:
                    samples[key].append(queued_ms(calls[key],
                                                  RING22_REPS[shape]))
            ms = {key: statistics.mean(x) for key, x in samples.items()}
            out[shape, label] = ms
            for key in order:
                what = (key if not isinstance(key, int) else
                        f"part {key} ({megakernel.RING_ABLATIONS[key]})")
                print(f"split ring {shape[0]}x{shape[1]} {label}, {steps} "
                      f"steps a launch, {what}: {ms[key]!r} ms (turns "
                      f"{samples[key]!r}), {ms[key] / ms[0]!r}x part 0, "
                      f"{ms[key] / ms['depth 2']!r}x depth 2; "
                      f"{100 * bound / ms[key]!r} % of the bound {bound!r} "
                      f"ms ({by}) [{card}]", flush=True)
    return out


def ring22_blocks(checks: Checks) -> None:
    """Phase 22a: each of phase 22's rings at 1080x1920 and 4096^2, the
    occupancy API's co-resident blocks of its entry against
    RingGeometry.blocks_per_sm, which must be the same an SM."""
    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape in RING_SHAPES:
        for label, depth, tiles in ring22_cases():
            g = megakernel.ring_geometry(shape, depth, tiles=tiles)
            n = (megakernel.pinned_ring_max_blocks(dev, g) if tiles
                 else megakernel.ring_max_blocks(dev, g))
            print(f"ring22 {shape[0]}x{shape[1]} {label}: {g.buffers} "
                  f"buffers, {g.bytes} B, blocks_per_sm {g.blocks_per_sm}; "
                  f"occupancy API {n} blocks ({n / sms!r} an SM)",
                  flush=True)
            checks.expect(n == g.blocks_per_sm * sms,
                          f"ring22 {shape} {label}: {n} co-resident blocks, "
                          f"blocks_per_sm {g.blocks_per_sm}")


def ring22_phase(checks: Checks, rng, card: str, log: str) -> tuple:
    """Phase 22: 22a (ptxas, the grids), 22b (every part bit for bit), 22c
    (the split and the second form in device time)."""
    ring22_ptxas(checks, log)
    ring22_blocks(checks)
    n = compare_ring22(checks, rng)
    print(f"phase 22b: {n} comparisons of the ring's parts", flush=True)
    return n, time_ring22(rng, card)


# --- 23. the pinned entries' redesign (K1 pinned, K1 shard pinned) ----------

#: the pinned entry's geometries of phase 23 (K, tr, tc): the kernel table's
#: row (K = 16 on 64x64), a deeper window, small tiles, wide tiles
PIN23_FLAT = ((16, 64, 64), (24, 64, 64), (16, 32, 32), (8, 32, 128))
#: the shard entry's (K, row tile, overlap) on 2x2: the row (32x64 tiles,
#: overlap off) and 64x64 tiles with the overlap on
PIN23_SHARD = ((16, 32, False), (16, 64, True))
PIN23_SHAPES = [MAIN_SHAPE, (1001, 1920), (40, 40), BENCH_SHAPE]
PIN23_MESHES = ((2, 2), (4, 1), (1, 4))
#: the ablation unit's instantiations ptxas reports (their spills are
#: reported, not failed)
PIN23_ABLATION_PTXAS = {"22pinned_ablation_kernel": 16,
                        "21shard_ablation_kernel": 7}
#: phase 23c: reps a sample by shape, and rounds (in order, then reversed)
PIN23_REPS = {MAIN_SHAPE: 20, BENCH_SHAPE: 4}
PIN23_ROUNDS = 2


def pin23_ptxas(checks: Checks, log: str) -> None:
    """Phase 23a: ptxas's report of the split's instantiations
    (``csrc/splits/windowed_pins_ablation.cu``): registers, stack frame, spills."""
    if not log:
        print("phase 23a: the library was reused, no ptxas report",
              flush=True)
        return
    rows = {}
    entry = frame = None
    for line in log.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            entry, frame = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = PTXAS_USED.search(line)
        if m and entry:
            rows[entry] = (int(m.group(1)), frame)
            entry = None
    for kernel, count in PIN23_ABLATION_PTXAS.items():
        found = {name: r for name, r in rows.items() if kernel in name}
        for name, (regs, f) in sorted(found.items()):
            print(f"ptxas {name}: {regs} registers, stack frame, spill "
                  f"stores, spill loads {f}", flush=True)
        print(f"ptxas {kernel[2:]}: {len(found)} instantiations, registers "
              f"{sorted({r for r, _ in found.values()})}", flush=True)
        checks.expect(len(found) == count,
                      f"{kernel}: {len(found)} of {count} instantiations")


def pin23_flat_cases(shape):
    """(K, geometry) of PIN23_FLAT on ``shape`` (``geometry.resolve``)."""
    return [(k, geometry.resolve(shape, k, tr, tc))
            for k, tr, tc in PIN23_FLAT]


def pin23_parts(g, shard: bool = False) -> list:
    """The parts of the split that run on ``g`` (``shard``: the shard
    entry's)."""
    parts = []
    for part in (windowed.PIN_SHARD_ABLATIONS if shard
                 else windowed.PIN_ABLATIONS):
        try:
            windowed.check_pin_part(part, g)
        except ValueError:
            continue
        parts.append(part)
    return parts


def pin23_shard_setup(u_np, v_np, shape, mesh_shape, k: int, tr: int,
                      dtype=torch.float32):
    """(mesh, geometry, u pairs, v pairs) of the shard entry at K on row
    tile ``tr``, the halos of slot 0 filled."""
    h = geometry.halo_for_steps(k)
    mesh = halo.Mesh(*mesh_shape, torch.device(DEVICE), h)
    g = geometry.resolve(halo.shard_extents(shape, mesh), k, tr)
    up, vp = halo.mega_shard_state(u_np, v_np, mesh, dtype)
    for x in (up, vp):
        halo.exchange_halos(x, 0, h)
    return mesh, g, up, vp


def compare_pin23(checks: Checks, rng) -> int:
    """Phase 23b: every part of the split (``windowed.PIN_ABLATIONS``) and
    the entry, one launch of K steps on each geometry of PIN23_FLAT at each
    shape of PIN23_SHAPES (and a NaN/Inf state at 1080x1920), bit for bit
    the plain version (part 2: its input); the entry also on the zero
    boundary and on bf16 storage. The shard entry's parts and entry on each
    mesh of PIN23_MESHES at 1080x1920 (and NaN/Inf) and 1001x1920 for each
    case of PIN23_SHARD (with the overlap: its interior launch, then its
    edge launch), bit for bit its plain version. Returns the comparisons."""
    n = 0
    params = Parameters()
    consts = kernel_constants(params)
    for shape in PIN23_SHAPES:
        for special in ((False, True) if shape == MAIN_SHAPE else (False,)):
            u_np, v_np = bf16_state(rng, shape, special)
            u, v = (torch.from_numpy(x).to(DEVICE) for x in (u_np, v_np))
            what0 = f"{shape[0]}x{shape[1]}{' NaN/Inf' if special else ''}"
            for k, g in pin23_flat_cases(shape):
                want = stencil.run(u, v, k, consts, "naive")
                for part in pin23_parts(g):
                    got = (torch.empty_like(u), torch.empty_like(v))
                    windowed.pinned_ablation(part, u, v, *got, k, consts, g)
                    checks.compare_bits(
                        "windowed_pinned", got,
                        (u, v) if part == windowed.PIN_ABLATION_NO_STEP
                        else want, f"pin23 {what0} {g.label()} K={k} part "
                        f"{part}")
                    n += 1
                for tag in ("windowed_pinned", "windowed_pinned_bf16"):
                    dtype, _ = PIN_ENTRIES[tag]
                    for boundary in ("naive", "zero"):
                        a, b = u.to(dtype), v.to(dtype)
                        got = (torch.empty_like(a), torch.empty_like(b))
                        windowed.multistep(a, b, *got, k, consts, boundary,
                                           geometry=g)
                        want_b = pin_plain(a, b, k, tag, boundary, params)
                        cmp = (checks.compare_bf16 if dtype == torch.bfloat16
                               else checks.compare_bits)
                        cmp(tag, got, want_b, f"pin23 {what0} {g.label()} "
                            f"K={k} {boundary} the entry")
                        n += 1
            if shape not in (MAIN_SHAPE, PAST_EDGE_SHAPE):
                continue
            for mesh_shape in PIN23_MESHES:
                for k, tr, overlap in PIN23_SHARD:
                    try:
                        mesh, g, up, vp = pin23_shard_setup(
                            u_np, v_np, shape, mesh_shape, k, tr)
                    except (UnsupportedConfigError, ValueError) as err:
                        print(f"pin23 {what0} mesh {mesh_shape} K={k} "
                              f"tr={tr}: {err}", flush=True)
                        continue
                    h = g.halo
                    cu, cv = up.clone(), vp.clone()
                    windowed.shard_multistep_reference(
                        cu, cv, 0, k, consts, "naive", shape, "all", g)
                    want = [halo.mega_unshard_result(x, shape, 1, h)
                            for x in (cu, cv)]
                    split = ("interior", "edge") if overlap else ("all",)
                    for part in [*pin23_parts(g, True), None]:
                        if part in windowed.PIN_ABLATION_CLUSTERS and overlap:
                            continue
                        gu, gv = up.clone(), vp.clone()
                        for tiles in split:
                            if part is None:
                                windowed.shard_multistep(
                                    gu, gv, mesh, 0, k, consts, "naive",
                                    shape, tiles, geometry=g)
                            else:
                                windowed.pinned_shard_ablation(
                                    part, gu, gv, mesh, 0, k, consts, shape,
                                    g, tiles)
                        ref = want
                        if part == windowed.PIN_ABLATION_NO_STEP:
                            ref = [halo.mega_unshard_result(x, shape, 0, h)
                                   for x in (up, vp)]
                        got = [halo.mega_unshard_result(x, shape, 1, h)
                               for x in (gu, gv)]
                        checks.compare_bits(
                            "shwin_pinned", got, ref,
                            f"pin23 {what0} {g.label()} K={k} mesh "
                            f"{mesh_shape[0]}x{mesh_shape[1]} "
                            f"{'+'.join(split)} "
                            f"{'the entry' if part is None else f'part {part}'}")
                        n += 1
    return n


def time_pin23(rng, card: str) -> dict:
    """Phase 23c: the split. On each geometry of PIN23_FLAT at 1080x1920
    and 4096^2, naive, float32, one launch of K steps of every part and of
    the entry; on each case of PIN23_SHARD on 2x2 at 1080x1920 the shard
    entry's (with the overlap: its interior and edge launches); in device
    time (``queued_ms``), in turns (PIN23_ROUNDS rounds, in order and
    reversed), each beside part 0 and the bound (at the output cell-steps).
    Returns {(label, shape): {part or "entry": ms}}."""
    out = {}
    consts = kernel_constants(Parameters())
    for shape in (MAIN_SHAPE, BENCH_SHAPE):
        u_np, v_np = (rng.uniform(0, 1, shape).astype(np.float32)
                      for _ in range(2))
        u, v = (torch.from_numpy(x).to(DEVICE) for x in (u_np, v_np))
        outs = (torch.empty_like(u), torch.empty_like(v))
        cases = []
        for k, g in pin23_flat_cases(shape):
            calls = {p: (lambda p=p, g=g, k=k: windowed.pinned_ablation(
                p, u, v, *outs, k, consts, g)) for p in pin23_parts(g)}
            calls["entry"] = (lambda g=g, k=k: windowed.multistep(
                u, v, *outs, k, consts, "naive", geometry=g))
            cases.append((f"K1 pinned {g.label()} K={k}", k, calls))
        if shape == MAIN_SHAPE:
            for k, tr, overlap in PIN23_SHARD:
                mesh, g, up, vp = pin23_shard_setup(u_np, v_np, shape,
                                                    (2, 2), k, tr)
                split = ("interior", "edge") if overlap else ("all",)
                calls = {}
                for p in [*pin23_parts(g, True), "entry"]:
                    if p in windowed.PIN_ABLATION_CLUSTERS and overlap:
                        continue

                    def call(p=p, g=g, k=k, mesh=mesh, up=up, vp=vp,
                             split=split):
                        for tiles in split:
                            if p == "entry":
                                windowed.shard_multistep(
                                    up, vp, mesh, 0, k, consts, "naive",
                                    shape, tiles, geometry=g)
                            else:
                                windowed.pinned_shard_ablation(
                                    p, up, vp, mesh, 0, k, consts, shape,
                                    g, tiles)
                    calls[p] = call
                cases.append((f"K1 shard pinned 2x2 {g.label()} K={k} "
                              f"{'+'.join(split)}", k, calls))
        for label, k, calls in cases:
            bound, by = bound_ms(shape, k, "naive")
            order = list(calls)
            samples = {key: [] for key in order}
            for _ in range(PIN23_ROUNDS):
                for key in order + order[::-1]:
                    samples[key].append(queued_ms(calls[key],
                                                  PIN23_REPS[shape]))
            ms = {key: statistics.mean(x) for key, x in samples.items()}
            out[label, shape] = ms
            for key in order:
                what = (key if not isinstance(key, int) else
                        f"part {key} ({windowed.PIN_ABLATIONS[key]})")
                print(f"split pin23 {shape[0]}x{shape[1]} {label}, {what}: "
                      f"{ms[key]!r} ms (turns {samples[key]!r}), "
                      f"{ms[key] / ms[0]!r}x part 0; "
                      f"{100 * bound / ms[key]!r} % of the bound {bound!r} "
                      f"ms ({by}) [{card}]", flush=True)
    return out


def pin23_blocks(checks: Checks) -> None:
    """Phase 23a: on each geometry of phase 23 at 1080x1920, the occupancy
    API's blocks an SM of the entry's kernel (float32, naive, the default
    stencils' tap set; ``gs_windowed_pinned_blocks``) beside
    ``Geometry.pin_launch``'s, which must be equal, and of the split's
    cluster part beside ``geometry.cluster_bytes``' blocks an SM."""
    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = build.bind("gs_windowed_pinned_ablation_occupancy",
                    [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2, build.SPLITS)
    entry = build.bind("gs_windowed_pinned_blocks",
                       [ctypes.c_int] * 5 + [ctypes.c_void_p])
    cases = [(g, 0) for _, g in pin23_flat_cases(MAIN_SHAPE)]
    for k, tr, _ in PIN23_SHARD:
        mesh = halo.Mesh(2, 2, dev, geometry.halo_for_steps(k))
        cases.append((geometry.resolve(halo.shard_extents(MAIN_SHAPE, mesh),
                                       k, tr), 1))
    for g, shard in cases:
        per_sm = ctypes.c_int(0)
        err = entry(g.tr, g.tc, g.halo, shard, dev.index or 0,
                    ctypes.byref(per_sm))
        launch = g.pin_launch()
        print(f"pin23 {'shard ' if shard else ''}entry {g.label()}: "
              f"{launch}; occupancy API {per_sm.value} blocks an SM, error "
              f"{err}", flush=True)
        checks.expect(err == 0 and per_sm.value == launch.blocks_per_sm,
                      f"pin23 entry {g.label()}: {per_sm.value} blocks an "
                      f"SM, pin_launch {launch.blocks_per_sm}")
    for g, shard in cases:
        per_sm, clusters = ctypes.c_int(0), ctypes.c_int(0)
        err = fn(g.tr, g.tc, g.halo, shard, dev.index or 0,
                 ctypes.byref(per_sm), ctypes.byref(clusters))
        nbytes = geometry.cluster_bytes(g.tr, g.tc, g.halo)
        want = geometry.blocks_per_sm(nbytes)
        print(f"pin23 cluster {'shard ' if shard else ''}{g.label()}: "
              f"{nbytes} B a block, blocks_per_sm {want}; occupancy API "
              f"{per_sm.value} an SM, {clusters.value} clusters of 4 "
              f"({4 * clusters.value / sms!r} blocks an SM), error {err}",
              flush=True)
        checks.expect(err == 0 and per_sm.value == want and
                      clusters.value > 0,
                      f"pin23 cluster {g.label()}: {per_sm.value} blocks an "
                      f"SM, blocks_per_sm {want}, {clusters.value} clusters")


def pin23_phase(checks: Checks, rng, card: str, log: str) -> tuple:
    """Phase 23: 23a (ptxas, the occupancy), 23b (every part and the entry
    bit for bit), 23c (the split in device time)."""
    pin23_ptxas(checks, log)
    pin23_blocks(checks)
    n = compare_pin23(checks, rng)
    print(f"phase 23b: {n} comparisons of the pinned entries and their "
          f"parts", flush=True)
    return n, time_pin23(rng, card)


# --- 25. K7's read-site entry and K1's folded entry redesigned --------------

#: K7's read-site split: (shape, row mesh), one launch of MAIN_STEPS steps
SHRS25_CASES = [(MAIN_SHAPE, (4, 1)), (MAIN_SHAPE, (2, 1)),
                (BENCH_SHAPE, (4, 1))]
#: the folded split: (shape, F, K)
FOLD25_CASES = [(MAIN_SHAPE, 2, 8), (MAIN_SHAPE, 2, 16), ((4096, 512), 8, 8)]
#: the new instantiations ptxas reports, by mangled kernel name: K7's
#: split, the folded entry (4 on run-time sizes, 4 compiled) and the
#: folded split's (12 more, the first form's step 2 and its refresh)
PTXAS25 = {"15ablation_kernel": 14, "18folded_form_kernel": 14,
           "24folded_first_form_kernel": 1, "19fold_refresh_kernel": 1}
#: K7's fitted instantiations: float32 and bf16, 68 rows, two tap sets, two
#: boundaries
PTXAS25_FITTED = ("ILi68ELi64ELi512ELi4E",)
PTXAS25_FITTED_COUNT = 8
#: the new kernels of the main path, which must not spill (the splits'
#: parts are reported)
PTXAS25_NO_SPILL = ("18folded_form_kernel", "fitted 19sharded_mega_kernel")
#: phase 25c: reps a sample by shape, and rounds (in order, then reversed)
SPLIT25_REPS = {MAIN_SHAPE: 20, BENCH_SHAPE: 4, (4096, 512): 20}
SPLIT25_ROUNDS = 2


def ptxas_entries(log: str) -> dict:
    """{function: (registers, (stack frame, spill stores, spill loads))} of
    every entry ptxas reports in ``log``."""
    rows, entry, frame = {}, None, None
    for line in log.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            entry, frame = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = PTXAS_USED.search(line)
        if m and entry:
            rows[entry] = (int(m.group(1)), frame)
            entry = None
    return rows


def ptxas25(checks: Checks, log: str) -> None:
    """Phase 25a: ptxas's report of the new kernels (the splits' units, the
    folded entry, K7's fitted instantiations): their count, registers, and
    no stack frame and no spill at their register bounds."""
    if not log:
        print("phase 25a: the library was reused, no ptxas report",
              flush=True)
        return
    rows = ptxas_entries(log)
    groups = {k: ({n: r for n, r in rows.items() if k in n}, c)
              for k, c in PTXAS25.items()}
    fitted = {n: r for n, r in rows.items() if "19sharded_mega_kernel" in n
              and any(f in n for f in PTXAS25_FITTED)}
    groups["fitted 19sharded_mega_kernel"] = (fitted, PTXAS25_FITTED_COUNT)
    for kernel, (found, count) in groups.items():
        for name, (regs, frame) in sorted(found.items()):
            print(f"ptxas {name}: {regs} registers, stack frame, spill "
                  f"stores, spill loads {frame}", flush=True)
        print(f"ptxas {kernel}: {len(found)} instantiations, registers "
              f"{sorted({r for r, _ in found.values()})}", flush=True)
        checks.expect(len(found) == count,
                      f"{kernel}: {len(found)} of {count} instantiations")
        bad = {n: f for n, (_, f) in found.items() if f != (0, 0, 0)}
        if bad:
            print(f"ptxas {kernel}: stack or spills {bad}", flush=True)
        checks.expect(not bad or kernel not in PTXAS25_NO_SPILL,
                      f"{kernel}: stack or spills {bad}")


def shrs25_setup(u_np, v_np, mesh_shape):
    """(mesh, u pairs, v pairs) of a row mesh on the card, slot 0's halos
    exchanged."""
    mesh = halo.make_mesh(mesh_shape[0] * mesh_shape[1], mesh_shape[1],
                          DEVICE)
    pairs = halo.mega_shard_state(u_np, v_np, mesh)
    for p in pairs:
        halo.exchange_halos(p)
    return mesh, pairs


def shrs25_tile(shape, mesh):
    """The tiles the entry picks on the card (``tile_for``); the CPU runs
    the plain version."""
    return sharded_mega.tile_for(shape, mesh) if DEVICE == "cuda" else "plain"


def compare_shrs25(checks: Checks, rng) -> int:
    """Phase 25b, K7: on each of SHRS25_CASES, both boundaries (and a
    NaN/Inf state at 1080x1920 naive), one launch of MAIN_STEPS steps of
    every part of ``sharded_mega.READ_SITE_ABLATIONS`` and of the entry
    (float32 and bf16, through ``sharded_megastep``'s own tile choice), the
    pairs' slot 0, halos included, bit for bit the plain version's
    (``sharded_megastep_reference``; the parts that step nothing: the
    input, its halos exchanged). Returns the comparisons made."""
    n = 0
    consts = kernel_constants(Parameters())
    n_blocks = MAIN_STEPS // 8
    for shape, mesh_shape in SHRS25_CASES:
        for special in ((False, True) if shape == MAIN_SHAPE else (False,)):
            u_np, v_np = bf16_state(rng, shape, special)
            for boundary in ("naive",) if special else ("naive", "zero"):
                what = (f"{shape[0]}x{shape[1]} {boundary}"
                        f"{' NaN/Inf' if special else ''} mesh "
                        f"{mesh_shape[0]}x{mesh_shape[1]}")
                mesh, ref = shrs25_setup(u_np, v_np, mesh_shape)
                start = [p.clone() for p in ref]
                sharded_mega.sharded_megastep_reference(
                    *ref, n_blocks, 8, consts, boundary, shape)
                for part in sharded_mega.READ_SITE_ABLATIONS:
                    got = [p.clone() for p in start]
                    grid = sharded_mega.read_site_ablation(
                        part, *got, mesh, n_blocks, 8, consts, boundary,
                        shape)
                    want = (start if part in sharded_mega.READ_SITE_NO_STEP
                            else ref)
                    checks.compare_bits(
                        "shmega_read_site", [g[:, :, 0] for g in got],
                        [w[:, :, 0] for w in want],
                        f"shrs25 {what} part {part} (grid {grid})")
                    n += 1
                for dtype in (torch.float32, torch.bfloat16):
                    _, got = shrs25_setup(u_np, v_np, mesh_shape)
                    got = [p.to(dtype) for p in got]
                    want = [p.clone() for p in got]
                    before = sharded_mega.read_site_launches
                    sharded_mega.sharded_megastep(*got, mesh, n_blocks, 8,
                                                  consts, boundary, shape)
                    checks.expect(sharded_mega.read_site_launches > before,
                                  f"shrs25 {what}: no read-site launch")
                    sharded_mega.sharded_megastep_reference(
                        *want, n_blocks, 8, consts, boundary, shape)
                    tag = ("shmega_read_site" if dtype == torch.float32
                           else "shmega_bf16")
                    cmp = (checks.compare_bits if dtype == torch.float32
                           else checks.compare_bf16)
                    cmp(tag, [g[:, :, 0] for g in got],
                        [w[:, :, 0] for w in want],
                        f"shrs25 {what} {str(dtype)[6:]} the entry (tiles "
                        f"{shrs25_tile(shape, mesh)})")
                    n += 1
    return n


def fold25_setup(u_np, v_np, f: int, k: int):
    """(geometry, Rp, u, v, u_out, v_out) of a folded call at F and K: the
    state's halo rows 0.0, the outputs 0.0."""
    g, rp = fold21_plan(u_np.shape, f, k)
    u, v = fold21_state(u_np, v_np, f, g)
    return g, rp, u, v, torch.zeros_like(u), torch.zeros_like(v)


def compare_fold25(checks: Checks, rng) -> int:
    """Phase 25b, the folded entry: on each of FOLD25_CASES, both
    boundaries (and a NaN/Inf state at 1080x1920 naive, also at the seam),
    the entry, and on the naive boundary every part of
    ``windowed.FOLDED_ABLATIONS`` that runs on the case's tiles: the
    outputs and the input's halo rows bit for bit
    the part's plain version (``folded_ablation_reference``; the entry's:
    ``folded_multistep_reference``). Returns the comparisons made."""
    n = 0
    consts = kernel_constants(Parameters())
    for shape, f, k in FOLD25_CASES:
        for special in ((False, True) if shape == MAIN_SHAPE else (False,)):
            u_np, v_np = bf16_state(rng, shape, special)
            if special:
                _, rp = fold21_plan(shape, f, k)
                u_np[rp - 1, -1] = v_np[rp, 0] = np.nan
                u_np[rp, -1] = -np.inf
                v_np[rp - 1, 0] = np.inf
            for boundary in ("naive",) if special else ("naive", "zero"):
                parts = (list(windowed.FOLDED_ABLATIONS)
                         if boundary == "naive" else [])
                for part in [*parts, None]:
                    g, rp, u, v, uo, vo = fold25_setup(u_np, v_np, f, k)
                    if part == windowed.FOLDED_ABLATION_STEP:
                        for x in (u, v):  # the step alone: fresh halo rows
                            lane_fold.fold_refresh(x, g.halo, f, shape[1], rp)
                    if part in windowed.FOLDED_ABLATION_FIXED and \
                            tuple(g) not in windowed.FOLDED_FIXED:
                        continue
                    want = [x.clone() for x in (u, v, uo, vo)]
                    if part is None:
                        windowed.folded_multistep(u, v, uo, vo, k, consts,
                                                  boundary, shape, rp, g)
                        windowed.folded_multistep_reference(
                            *want, k, consts, boundary, shape, rp, g.halo)
                    else:
                        windowed.folded_ablation(part, u, v, uo, vo, k,
                                                 consts, boundary, shape, rp,
                                                 g)
                        windowed.folded_ablation_reference(
                            part, *want, k, consts, boundary, shape, rp,
                            g.halo)
                    checks.compare_bits(
                        "windowed_folded", (uo, vo, u, v),
                        (want[2], want[3], want[0], want[1]),
                        f"fold25 {pin_label(shape, g)} F={f} Rp={rp} K={k} "
                        f"{boundary}{' NaN/Inf' if special else ''} "
                        f"{'the entry' if part is None else f'part {part}'}")
                    n += 1
    return n


def time_shrs25(rng, card: str) -> dict:
    """Phase 25c, K7: on each of SHRS25_CASES, naive and zero, one launch
    of MAIN_STEPS steps of every part and of the entry (its own tile
    choice), the halos exchanged before each, in device time
    (``queued_ms``; the launches follow one another on the same pairs), in
    turns (SPLIT25_ROUNDS rounds, in order and reversed), each beside part
    0, its tile rounds and the bound. Returns
    {(shape, mesh, boundary): {part or "entry": ms}}."""
    out = {}
    consts = kernel_constants(Parameters())
    for shape, mesh_shape in SHRS25_CASES:
        u_np, v_np = (rng.uniform(0, 1, shape).astype(np.float32)
                      for _ in range(2))
        mesh, pairs = shrs25_setup(u_np, v_np, mesh_shape)
        grids = {}
        for boundary in ("naive", "zero"):
            def call(part, boundary=boundary):
                if part == "entry":
                    sharded_mega.sharded_megastep(
                        *pairs, mesh, MAIN_STEPS // 8, 8, consts, boundary,
                        shape)
                else:
                    grids[part] = sharded_mega.read_site_ablation(
                        part, *pairs, mesh, MAIN_STEPS // 8, 8, consts,
                        boundary, shape)
            order = [*sharded_mega.READ_SITE_ABLATIONS, "entry"]
            samples = {key: [] for key in order}
            for _ in range(SPLIT25_ROUNDS):
                for key in order + order[::-1]:
                    samples[key].append(queued_ms(
                        lambda key=key: call(key), SPLIT25_REPS[shape]))
            ms = {key: statistics.mean(x) for key, x in samples.items()}
            out[shape, mesh_shape, boundary] = ms
            bound, by = sharded_bound_ms(shape, mesh_shape, MAIN_STEPS,
                                         boundary)
            r_loc = halo.shard_extents(shape, mesh)[0]
            for key in order:
                if key == "entry":
                    tile = shrs25_tile(shape, mesh)
                    what = f"the entry (tiles {tile})"
                    grid = None
                else:
                    tr = sharded_mega.check_read_site_part(
                        key, shape, mesh, MAIN_STEPS // 8, consts, None)
                    tile = (tr, 64)
                    grid = grids.get(key)
                    what = (f"part {key} "
                            f"({sharded_mega.READ_SITE_ABLATIONS[key]}; "
                            f"{tr}x64 tiles, grid {grid})")
                rounds = (sharded_mega.tile_rounds(shape, mesh_shape, tile,
                                                   grid) if grid else None)
                print(f"split shrs25 {shape[0]}x{shape[1]} mesh "
                      f"{mesh_shape[0]}x{mesh_shape[1]} (shard rows {r_loc}) "
                      f"{boundary}, {what}: {ms[key]!r} ms (turns "
                      f"{samples[key]!r}), {ms[key] / ms[0]!r}x part 0, "
                      f"rounds {rounds}; {100 * bound / ms[key]!r} % of the "
                      f"bound {bound!r} ms ({by}) [{card}]", flush=True)
    return out


def time_fold25(rng, card: str) -> dict:
    """Phase 25c, the folded entry: on each of FOLD25_CASES, naive, one call
    of K steps of every part that runs on the case's tiles and of the
    entry, beside one launch of the unfolded K1 on the same domain, in
    device time (``queued_ms``), in turns. Returns {(shape, F, K): {part,
    "entry" or "K1": ms}}."""
    out = {}
    consts = kernel_constants(Parameters())
    for shape, f, k in FOLD25_CASES:
        u_np, v_np = (rng.uniform(0, 1, shape).astype(np.float32)
                      for _ in range(2))
        g, rp, u, v, uo, vo = fold25_setup(u_np, v_np, f, k)
        ut, vt = (torch.from_numpy(x).to(DEVICE) for x in (u_np, v_np))
        ko, kv = torch.empty_like(ut), torch.empty_like(vt)
        calls = {}
        for part in windowed.FOLDED_ABLATIONS:
            if part in windowed.FOLDED_ABLATION_FIXED and \
                    tuple(g) not in windowed.FOLDED_FIXED:
                continue
            calls[part] = (lambda part=part: windowed.folded_ablation(
                part, u, v, uo, vo, k, consts, "naive", shape, rp, g))
        calls["entry"] = lambda: windowed.folded_multistep(
            u, v, uo, vo, k, consts, "naive", shape, rp, g)
        k1 = geometry.resolve(shape, k)
        calls["K1"] = lambda: windowed.multistep(ut, vt, ko, kv, k, consts,
                                                 "naive", geometry=k1)
        order = list(calls)
        samples = {key: [] for key in order}
        for _ in range(SPLIT25_ROUNDS):
            for key in order + order[::-1]:
                samples[key].append(queued_ms(calls[key],
                                              SPLIT25_REPS[shape]))
        ms = {key: statistics.mean(x) for key, x in samples.items()}
        out[shape, f, k] = ms
        bound, by = bound_ms(shape, k, "naive")
        for key in order:
            what = (key if not isinstance(key, int) else
                    f"part {key} ({windowed.FOLDED_ABLATIONS[key]})")
            print(f"split fold25 {shape[0]}x{shape[1]} F={f} Rp={rp} "
                  f"{g.label()} K={k}, {what}: {ms[key]!r} ms (turns "
                  f"{samples[key]!r}), {ms[key] / ms[0]!r}x part 0, "
                  f"{ms[key] / ms['K1']!r}x the unfolded K1; "
                  f"{100 * bound / ms[key]!r} % of the bound {bound!r} ms "
                  f"({by}) [{card}]", flush=True)
    return out


def paths25(runs17: dict, runs21: dict, card: str) -> None:
    """Phase 25d: the two redesigned entries' ``simulate`` paths, read from
    phases 17d (4x1, the read-site wait against the entry gate) and 21b
    (``--pallas-fold 2`` against the unfolded K1), in turns there."""
    rs = runs17["shmega_read_site"]
    fold = runs21["fold 2"]
    print(f"path25 simulate sharded mega 4x1: {rs['ms']!r} ms/image, "
          f"launches {rs['launches']} (the entry gate on 64x64 tiles "
          f"{rs['ms2']!r}) [{card}]", flush=True)
    print(f"path25 simulate --pallas-fold 2: {fold['ms']!r} ms/image "
          f"against the unfolded K1's {fold['ms2']!r}: "
          f"{fold['ms'] / fold['ms2']!r}x, launches {fold['launches']} "
          f"[{card}]", flush=True)


def phase25(checks: Checks, rng, card: str, log: str) -> tuple:
    """Phase 25: 25a (ptxas), 25b (every part and entry bit for bit), 25c
    (both splits in device time). Returns (comparisons, K7's split, the
    folded split)."""
    ptxas25(checks, log)
    n = compare_shrs25(checks, rng) + compare_fold25(checks, rng)
    print(f"phase 25b: {n} comparisons of the read-site and folded entries "
          f"and their parts", flush=True)
    return n, time_shrs25(rng, card), time_fold25(rng, card)


# -- phase 26: K2's and K7's pinned entries redesigned -----------------------

#: K2's split: (shape, (tr, tc), storage), each naive and zero
PIN26_K2 = [(MAIN_SHAPE, (32, 128), torch.float32),
            (MAIN_SHAPE, (16, 64), torch.bfloat16),
            (MAIN_SHAPE, (32, 64), torch.float32),
            (BENCH_SHAPE, (64, 128), torch.float32)]
#: K7's split: (shape, mesh, (tr, tc), storage), each naive and zero
PIN26_K7 = [(MAIN_SHAPE, (2, 2), (32, 128), torch.float32),
            (MAIN_SHAPE, (1, 4), (64, 128), torch.bfloat16),
            (BENCH_SHAPE, (2, 2), (32, 128), torch.float32)]
#: domains whose last tile row and column are partial (phase 18's), and
#: K7's meshes there (4x1: the read-site wait)
PIN26_EDGES = [(1025, 1920), (1000, 1917)]
PIN26_EDGE_MESHES = ((2, 2), (1, 4), (4, 1))
#: the new instantiations ptxas reports, by mangled kernel name: K2's (16
#: compiled entries, 26 in the split), K7's (16, 12) and the K7 split's
#: exchange alone (2)
PTXAS26 = {"20mega_pin_form_kernel": 42, "23sharded_pin_form_kernel": 28,
           "15exchange_kernel": 2}
#: phase 26c: reps a sample by shape, rounds (in order, then reversed) and
#: passes (the whole split again, for its spread)
SPLIT26_REPS = {MAIN_SHAPE: 20, BENCH_SHAPE: 4}
SPLIT26_ROUNDS = 2
SPLIT26_PASSES = 2
#: the blocks of 4 time blocks of 8 steps that every phase 26 launch takes
PIN26_BLOCKS = MAIN_STEPS // 8


def ptxas26(checks: Checks, log: str) -> None:
    """Phase 26a: ptxas's report of the new kernels (K2's and K7's pinned
    forms, compiled and in the splits): their count, registers, and no
    stack frame and no spill (phase 2's check holds them too:
    NO_SPILL_KERNELS)."""
    if not log:
        print("phase 26a: the library was reused, no ptxas report",
              flush=True)
        return
    # each unit's report, the libraries' joined: an instantiation that two
    # units compile (a kept form and its split part) counts twice
    rows = [ptxas_entries(unit) for unit in
            re.split(r"(?=ptxas info\s*: Compiling entry function)", log)]
    for kernel, count in PTXAS26.items():
        found = [(n, r) for row in rows for n, r in row.items()
                 if kernel in n]
        for name, (regs, frame) in found:
            print(f"ptxas {name}: {regs} registers, stack frame, spill "
                  f"stores, spill loads {frame}", flush=True)
        bad = {n: f for n, (_, f) in found if f != (0, 0, 0)}
        print(f"ptxas {kernel}: {len(found)} instantiations, registers "
              f"{sorted({r for _, (r, _) in found})}, stack or spills "
              f"{bad}", flush=True)
        checks.expect(len(found) == count,
                      f"{kernel}: {len(found)} of {count} instantiations")
        checks.expect(not bad, f"{kernel}: stack or spills {bad}")


def blocks26(checks: Checks) -> None:
    """Phase 26a: the co-resident blocks of every compiled pinned
    instantiation (the occupancy API) against ``geometry.mega_pin_launch``'s
    blocks an SM times the SMs, which the host's walk reckons with."""
    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for sharded, fixed in ((False, geometry.MEGA_FIXED_PINS),
                           (True, geometry.SHARDED_FIXED_PINS)):
        for tr, tc in fixed:
            g = geometry.Geometry(tr, tc, geometry.HALO)
            for boundary in ("naive", "zero"):
                form = geometry.mega_pin_launch(g, sharded, boundary)
                for dtype in (torch.float32, torch.bfloat16):
                    for wait in ((False, True) if sharded else (False,)):
                        n = (sharded_mega.pinned_fixed_blocks(
                            dev, g, boundary, wait, dtype) if sharded else
                            megakernel.pinned_fixed_blocks(dev, g, boundary,
                                                           dtype))
                        what = (f"blocks26 {'K7' if sharded else 'K2'} "
                                f"{g.label()} {boundary} {str(dtype)[6:]}"
                                f"{' read-site' if wait else ''}")
                        print(f"{what}: {n} co-resident, {form}", flush=True)
                        checks.expect(n == form.blocks_per_sm * sms,
                                      f"{what}: {n} co-resident against "
                                      f"{form.blocks_per_sm} x {sms}")


def pin26_k2_plain(u, v, boundary: str):
    """The plain version of a phase 26 K2 launch on either storage."""
    consts = kernel_constants(Parameters())
    if u.dtype == torch.bfloat16:
        return megakernel.megastep_reference_bf16(u, v, PIN26_BLOCKS, 8,
                                                  consts, boundary)
    return stencil.run(u, v, PIN26_BLOCKS * 8, consts, boundary)


def pin26_k2_parts(g, dtype, boundary: str) -> list:
    """The parts of ``megakernel.PINNED_ABLATIONS`` that run ``g`` on
    ``dtype`` pairs."""
    consts = kernel_constants(Parameters())
    out = []
    for part in megakernel.PINNED_ABLATIONS:
        try:
            megakernel.check_pinned_part(part, g, dtype, consts)
        except ValueError:
            continue
        out.append(part)
    return out


def pin26_k7_parts(g, dtype, boundary: str) -> list:
    """The parts of ``sharded_mega.PINNED_ABLATIONS`` that run ``g`` on
    ``dtype`` pairs at the ``boundary``."""
    consts = kernel_constants(Parameters())
    out = []
    for part in sharded_mega.PINNED_ABLATIONS:
        try:
            sharded_mega.check_pinned_part(part, g, dtype, consts, boundary,
                                           PIN26_BLOCKS)
        except ValueError:
            continue
        out.append(part)
    return out


def compare_pin26_k2(checks: Checks, rng) -> int:
    """Phase 26b, K2: on each of PIN26_K2 (and a NaN/Inf state at
    1080x1920 naive) and on PIN26_EDGES, both boundaries, one launch of
    PIN26_BLOCKS time blocks of every part of the split that takes the
    case's tiles and storage, and of the entry on float32 and bf16 pairs
    (on the edge domains at every compiled geometry), each bit for bit its
    plain version (part 1: its input). Returns the comparisons made."""
    n = 0
    consts = kernel_constants(Parameters())
    cases = [(s, t, d, False) for s, t, d in PIN26_K2]
    cases.append((MAIN_SHAPE, (32, 128), torch.float32, True))
    cases += [(s, t, torch.float32, False) for s in PIN26_EDGES
              for t in geometry.MEGA_FIXED_PINS]
    cases += [(s, (16, 64), torch.bfloat16, False) for s in PIN26_EDGES]
    for shape, tiles, dtype, special in cases:
        g = geometry.Geometry(*tiles, geometry.HALO)
        u_np, v_np = bf16_state(rng, shape, special)
        for boundary in ("naive",) if special else ("naive", "zero"):
            what = (f"pin26 K2 {pin_label(shape, g)} {boundary}"
                    f"{' NaN/Inf' if special else ''}")
            for dt in (torch.float32, torch.bfloat16):
                u, v = (torch.from_numpy(x).to(DEVICE).to(dt)
                        for x in (u_np, v_np))
                want = pin26_k2_plain(u, v, boundary)
                tag = "mega_pinned" + ("_bf16" if dt == torch.bfloat16
                                       else "")
                for part in (pin26_k2_parts(g, dt, boundary)
                             if dt == dtype else []):
                    up, vp = (megakernel.pair_state(x) for x in (u, v))
                    grid = megakernel.pinned_ablation(
                        part, up, vp, PIN26_BLOCKS, 8, consts, boundary, g)
                    pin19_compare(checks, tag, (up[0], vp[0]),
                                  (u, v) if part == megakernel.PINNED_NO_STEP
                                  else want,
                                  f"{what} {str(dt)[6:]} part {part} (grid "
                                  f"{grid})")
                    n += 1
                up, vp = (megakernel.pair_state(x) for x in (u, v))
                megakernel.megastep(up, vp, PIN26_BLOCKS, 8, consts, boundary,
                                    geometry=g)
                form = geometry.mega_pin_launch(g, boundary=boundary)
                pin19_compare(checks, tag, (up[0], vp[0]), want,
                              f"{what} {str(dt)[6:]} the entry ({form})")
                n += 1
    return n


def pin26_k7_setup(u_np, v_np, mesh, dtype):
    """Both pairs of a mesh on the card, slot 0's halos exchanged."""
    pairs = halo.mega_shard_state(u_np, v_np, mesh, dtype)
    for p in pairs:
        halo.exchange_halos(p)
    return pairs


def compare_pin26_k7(checks: Checks, rng) -> int:
    """Phase 26b, K7: on each of PIN26_K7 (and a NaN/Inf state at
    1080x1920 naive), both boundaries, one launch of PIN26_BLOCKS time
    blocks of every part of the split that takes the case's tiles,
    storage and boundary, and of the entry on float32 and bf16 pairs; on
    PIN26_EDGES the entry at every compiled geometry on each of
    PIN26_EDGE_MESHES: the pairs' slot 0, halos included, bit for bit the
    plain version's (part 1: the input, its halos exchanged). Prints the
    grid of each launch, and checks the entry's against
    ``sharded_mega.pinned_walk``. Returns the comparisons made."""
    n = 0
    consts = kernel_constants(Parameters())
    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [(s, m, t, d, False) for s, m, t, d in PIN26_K7]
    cases.append((MAIN_SHAPE, (2, 2), (32, 128), torch.float32, True))
    cases += [(s, m, t, None, False) for s in PIN26_EDGES
              for m in PIN26_EDGE_MESHES
              for t in geometry.SHARDED_FIXED_PINS]
    for shape, mesh_shape, tiles, dtype, special in cases:
        g = geometry.Geometry(*tiles, geometry.HALO)
        mesh = halo.Mesh(*mesh_shape, dev)
        u_np, v_np = bf16_state(rng, shape, special)
        for boundary in ("naive",) if special else ("naive", "zero"):
            what = (f"pin26 K7 {pin_label(shape, g)} mesh {mesh_shape[0]}x"
                    f"{mesh_shape[1]} {boundary}"
                    f"{' NaN/Inf' if special else ''}")
            for dt in (torch.float32, torch.bfloat16):
                start = pin26_k7_setup(u_np, v_np, mesh, dt)
                want = [p.clone() for p in start]
                sharded_mega.sharded_megastep_reference(
                    *want, PIN26_BLOCKS, 8, consts, boundary, shape)
                tag = "shmega_pinned" + ("_bf16" if dt == torch.bfloat16
                                         else "")
                for part in (pin26_k7_parts(g, dt, boundary)
                             if dt == dtype else []):
                    got = [p.clone() for p in start]
                    grid = sharded_mega.pinned_ablation(
                        part, *got, mesh, PIN26_BLOCKS, 8, consts, boundary,
                        shape, g)
                    ref = (start if part == sharded_mega.PINNED_NO_STEP
                           else want)
                    pin19_compare(checks, tag, [x[:, :, 0] for x in got],
                                  [x[:, :, 0] for x in ref],
                                  f"{what} {str(dt)[6:]} part {part} (grid "
                                  f"{grid})")
                    n += 1
                got = [p.clone() for p in start]
                grid = sharded_mega.sharded_megastep(
                    *got, mesh, PIN26_BLOCKS, 8, consts, boundary, shape,
                    geometry=g)
                walk = sharded_mega.pinned_walk(shape, mesh_shape, g,
                                                boundary, sms)
                pin19_compare(checks, tag, [x[:, :, 0] for x in got],
                              [x[:, :, 0] for x in want],
                              f"{what} {str(dt)[6:]} the entry (grid "
                              f"{grid}, {walk})")
                n += 1
                if DEVICE == "cuda":
                    checks.expect(grid == walk.grid,
                                  f"{what} {str(dt)[6:]}: grid {grid} "
                                  f"against the walk's {walk.grid}")
                if (shape, mesh_shape, tiles, boundary) == (
                        MAIN_SHAPE, (2, 2), (32, 128), "naive"):
                    print(f"grid26 K7 naive {pin_label(shape, g)} mesh 2x2 "
                          f"{str(dt)[6:]}: the launch took {grid} blocks "
                          f"({grid / sms!r} an SM), groups {walk.groups}, "
                          f"rounds {walk.rounds}", flush=True)
                    checks.expect(DEVICE != "cuda" or grid >= 2 * sms,
                                  f"{what}: {grid} blocks, under two an SM")
    return n


def pin26_spread(passes: list) -> float:
    """The largest relative difference between the passes' means of any
    call of a case: the split's spread."""
    return max((max(p[k] for p in passes) - min(p[k] for p in passes))
               / statistics.mean(p[k] for p in passes) for k in passes[0])


def pin26_turns(calls: dict, reps: int) -> list:
    """SPLIT26_PASSES passes of SPLIT26_ROUNDS rounds of ``calls`` in turns
    (in order, then reversed), in device time (``queued_ms``): a list of
    {key: mean ms} a pass, and of {key: samples}."""
    passes, samples = [], []
    order = list(calls)
    for _ in range(SPLIT26_PASSES):
        got = {key: [] for key in order}
        for _ in range(SPLIT26_ROUNDS):
            for key in order + order[::-1]:
                got[key].append(queued_ms(calls[key], reps))
        passes.append({key: statistics.mean(x) for key, x in got.items()})
        samples.append(got)
    return passes, samples


def pin26_report(label: str, passes: list, samples: list, describe,
                 bound: tuple, card: str) -> dict:
    """Print one line a call of a case: each pass's mean, the mean, the
    ratio to part 0, the case's spread; returns {key: mean ms} with
    "spread" and "passes"."""
    spread = pin26_spread(passes)
    ms = {key: statistics.mean(p[key] for p in passes) for key in passes[0]}
    for key in passes[0]:
        print(f"split pin26 {label}, {describe(key)}: {ms[key]!r} ms (passes "
              f"{[p[key] for p in passes]!r}, turns "
              f"{[s[key] for s in samples]!r}), {ms[key] / ms[0]!r}x part "
              f"0, spread {100 * spread!r} %; {100 * bound[0] / ms[key]!r} "
              f"% of the bound {bound[0]!r} ms ({bound[1]}) [{card}]",
              flush=True)
    return dict(ms, spread=spread, passes=passes)


def time_pin26_k2(rng, card: str) -> dict:
    """Phase 26c, K2: on each of PIN26_K2, naive and zero, one launch of
    PIN26_BLOCKS time blocks of every part that takes the case, of the
    entry and of the compiled 64x64 entry, in turns (``pin26_turns``).
    Returns {(shape, tiles, storage, boundary): {part, "entry" or
    "64x64": ms, "spread": ..., "passes": ...}}."""
    out = {}
    consts = kernel_constants(Parameters())
    for shape, tiles, dtype in PIN26_K2:
        g = geometry.Geometry(*tiles, geometry.HALO)
        u, v = (torch.from_numpy(rng.uniform(0, 1, shape).astype(
            np.float32)).to(DEVICE).to(dtype) for _ in range(2))
        up, vp = megakernel.pair_state(u), megakernel.pair_state(v)
        for boundary in ("naive", "zero"):
            grids = {}
            calls = {}
            for part in pin26_k2_parts(g, dtype, boundary):
                def call(part=part, boundary=boundary):
                    grids[part] = megakernel.pinned_ablation(
                        part, up, vp, PIN26_BLOCKS, 8, consts, boundary, g)
                calls[part] = call
            calls["entry"] = lambda boundary=boundary: megakernel.megastep(
                up, vp, PIN26_BLOCKS, 8, consts, boundary, geometry=g)
            calls["64x64"] = lambda boundary=boundary: megakernel.megastep(
                up, vp, PIN26_BLOCKS, 8, consts, boundary)
            passes, samples = pin26_turns(calls, SPLIT26_REPS[shape])

            def describe(key, g=g, boundary=boundary):
                if key == "entry":
                    return (f"the entry "
                            f"({geometry.mega_pin_launch(g, boundary=boundary)})")
                if key == "64x64":
                    return "the compiled 64x64 entry"
                return (f"part {key} ({megakernel.PINNED_ABLATIONS[key]}; "
                        f"{megakernel.pinned_part_threads(key, g)} threads, "
                        f"grid {grids.get(key)})")
            label = (f"K2 {pin_label(shape, g)} {str(dtype)[6:]} "
                     f"{boundary}")
            bound = bound_ms(shape, MAIN_STEPS, boundary,
                             cell_bytes=8 if dtype == torch.bfloat16 else 16)
            out[shape, tiles, dtype, boundary] = pin26_report(
                label, passes, samples, describe, bound, card)
    return out


def time_pin26_k7(rng, card: str) -> dict:
    """Phase 26c, K7: on each of PIN26_K7, naive and zero, one launch of
    PIN26_BLOCKS time blocks of every part that takes the case, of the
    entry and of the compiled K7 (its own tile choice) on the same mesh,
    in turns (``pin26_turns``; the launches follow one another on the same
    pairs, whose halos each leaves exchanged). Returns {(shape, mesh,
    tiles, storage, boundary): {...}} as time_pin26_k2."""
    out = {}
    consts = kernel_constants(Parameters())
    dev = torch.device(DEVICE)
    for shape, mesh_shape, tiles, dtype in PIN26_K7:
        g = geometry.Geometry(*tiles, geometry.HALO)
        mesh = halo.Mesh(*mesh_shape, dev)
        u_np, v_np = (rng.uniform(0, 1, shape).astype(np.float32)
                      for _ in range(2))
        pairs = pin26_k7_setup(u_np, v_np, mesh, dtype)
        for boundary in ("naive", "zero"):
            grids = {}
            calls = {}
            for part in pin26_k7_parts(g, dtype, boundary):
                def call(part=part, boundary=boundary):
                    grids[part] = sharded_mega.pinned_ablation(
                        part, *pairs, mesh, PIN26_BLOCKS, 8, consts,
                        boundary, shape, g)
                calls[part] = call

            def entry(boundary=boundary):
                grids["entry"] = sharded_mega.sharded_megastep(
                    *pairs, mesh, PIN26_BLOCKS, 8, consts, boundary, shape,
                    geometry=g)
            calls["entry"] = entry
            calls["compiled"] = lambda boundary=boundary: \
                sharded_mega.sharded_megastep(*pairs, mesh, PIN26_BLOCKS, 8,
                                              consts, boundary, shape)
            passes, samples = pin26_turns(calls, SPLIT26_REPS[shape])

            def describe(key, g=g, boundary=boundary):
                if key == "entry":
                    form = geometry.mega_pin_launch(g, True, boundary)
                    return f"the entry ({form}, grid {grids.get('entry')})"
                if key == "compiled":
                    tile = (sharded_mega.tile_for(shape, mesh)
                            if DEVICE == "cuda" else "plain")
                    return f"the compiled K7 (tiles {tile})"
                return (f"part {key} ({sharded_mega.PINNED_ABLATIONS[key]}; "
                        f"grid {grids.get(key)})")
            label = (f"K7 {pin_label(shape, g)} mesh {mesh_shape[0]}x"
                     f"{mesh_shape[1]} {str(dtype)[6:]} {boundary}")
            bound = sharded_bound_ms(shape, mesh_shape, MAIN_STEPS, boundary)
            out[shape, mesh_shape, tiles, dtype, boundary] = pin26_report(
                label, passes, samples, describe, bound, card)
    return out


def paths26(pin19_runs: dict, card: str) -> None:
    """Phase 26d: the two pins' ``simulate`` paths, read from phase 19c
    (K2 on 32x128, K7 on 2x2 at 32x128, each against its unpinned run)."""
    for label in ("mega 32x128", "sharded mega 32x128"):
        run = pin19_runs[label]
        print(f"path26 simulate {label}: {run['ms']!r} ms/image, launches "
              f"{run['launches']} [{card}]", flush=True)


def phase26(checks: Checks, rng, card: str, log: str) -> tuple:
    """Phase 26: 26a (ptxas, the compiled forms' co-resident blocks), 26b
    (every part and entry bit for bit), 26c (both splits in device time).
    Returns (comparisons, K2's split, K7's split)."""
    ptxas26(checks, log)
    blocks26(checks)
    n = compare_pin26_k2(checks, rng) + compare_pin26_k7(checks, rng)
    print(f"phase 26b: {n} comparisons of K2's and K7's pinned entries and "
          f"their parts", flush=True)
    return n, time_pin26_k2(rng, card), time_pin26_k7(rng, card)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=42,
                        help="seed of the random test fields")
    # phase 20's ranks: this script, started by itself
    parser.add_argument("--distributed-child", metavar="OUT",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA GPU "
              "(torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    if args.distributed_child:
        return distributed_child(args.distributed_child)
    # an empty autotune store: only the records the package ships steer
    # auto, never a store on this machine
    store = tempfile.TemporaryDirectory(prefix="chip_smoke_store_")
    os.environ["GRAYSCOTT_CACHE_DIR"] = store.name
    try:
        return run_phases(args)
    finally:
        store.cleanup()


def run_phases(args) -> int:
    rng = np.random.RandomState(args.seed)
    checks = Checks()
    t_start = time.perf_counter()

    # 1. environment
    card = gpu.nvidia_smi("name,power.limit").splitlines()[0]
    print(gpu.capability_dump(), flush=True)

    # 2. build: the kernels every path runs, then the splits' ablation
    # parts (a library of their own)
    t0 = time.perf_counter()
    built = build.build()
    build.load()
    print(f"build: {built.path.name} in {time.perf_counter() - t0!r} s "
          f"(nvcc {built.seconds!r} s)")
    t0 = time.perf_counter()
    splits = build.build(build.SPLITS)
    build.load(build.SPLITS)
    print(f"build: {splits.path.name} (the splits) in "
          f"{time.perf_counter() - t0!r} s (nvcc {splits.seconds!r} s)")
    log = built.log + splits.log
    print(log.strip(), flush=True)
    report = ptxas_report(log)
    for name, regs, stores, loads, smem in report:
        print(f"ptxas {name}: {regs} registers, spill stores {stores} B, "
              f"spill loads {loads} B, static shared {smem} B", flush=True)
    if log:
        spilled = [row for row in report
                   if any(row[0].startswith(k[2:]) for k in NO_SPILL_KERNELS)
                   and (row[2] or row[3])]
        counted = sum(any(row[0].startswith(k[2:]) for k in NO_SPILL_KERNELS)
                      for row in report)
        print(f"ptxas: {counted} K2, K4, K6, K7 and pinned K1 and K4 "
              f"instantiations, {len(spilled)} spill", flush=True)
        checks.expect(counted > 0 and not spilled,
                      f"K2, K4, K6, K7 and pinned instantiations spill: "
                      f"{spilled}")
    # K4's and K6's windows are dynamic shared memory, which ptxas does not
    # report
    for label, t in (("", megakernel.PACKED_TILE[0]),
                     (" (K4 part 2, K6 part 3)", 32)):
        win = t + 2 * megakernel.MEGA_STEPS
        print(f"dynamic shared packed_kernel and packed_mega_kernel{label}: "
              f"{t}x{t} tiles in {win}x{win} windows, two buffers of two "
              f"species: {4 * 4 * win * win} B", flush=True)
    for label, tile, ring in (("K1, K2 and K4", windowed.TILE, windowed.K),
                              ("K3 and K9", resident.TILE, resident.HALO),
                              ("K5", packed.RESIDENT_TILE,
                               packed.RESIDENT_HALO),
                              ("K6", megakernel.PACKED_TILE,
                               megakernel.MEGA_STEPS)):
        for shape in REDESIGNED_SHAPES:
            n = -(-shape[0] // tile[0]) * -(-shape[1] // tile[1])
            print(f"interior tiles {label} ({tile[0]}x{tile[1]} tiles, "
                  f"windows {ring} cells wider on every side) at "
                  f"{shape[0]}x{shape[1]}: "
                  f"{stencil.interior_tiles(shape, tile, ring)} of {n}",
                  flush=True)
    for shape in (MAIN_SHAPE, PAST_EDGE_SHAPE, BENCH_SHAPE):
        for n_r, n_c in SHARDED_MESHES:
            r_loc, c_loc = halo.shard_extents(shape, halo.Mesh(n_r, n_c,
                                                               None))
            for t in sharded_mega.TILES:
                counts = [stencil.interior_tiles_at(
                    (i * r_loc, j * c_loc), (r_loc, c_loc), shape, (t, t),
                    halo.HALO) for i in range(n_r) for j in range(n_c)]
                print(f"interior tiles K7 ({t}x{t} tiles) at "
                      f"{shape[0]}x{shape[1]} mesh {n_r}x{n_c}, per shard: "
                      f"{counts} of {-(-r_loc // t) * -(-c_loc // t)}",
                      flush=True)
    dev = torch.device(DEVICE)
    print(f"co-resident blocks: resident {resident.max_blocks(dev)}, mega "
          f"{megakernel.max_blocks(dev)}, packed resident "
          f"{packed.resident_max_blocks(dev)}, packed mega "
          f"{megakernel.packed_max_blocks(dev)}, oplat "
          f"{oplat.max_blocks(dev)}, ilpsplit {ilpsplit.max_blocks(dev)}, "
          f"sharded mega "
          f"{ {t: sharded_mega.max_blocks(dev, t) for t in sharded_mega.TILES} }",
          flush=True)

    # 3. every kernel vs its plain version
    compare_kernels(checks, rng)
    compare_packed_kernels(checks, rng)

    # 4. the default simulate run, on auto and on each pin; then the
    # packed zero-boundary run
    runs = main_paths(checks)
    packed_runs = packed_paths(checks)

    # 5. the bench path, and the packed 1000-step run
    bench = bench_path(checks, card)
    packed_bench(checks, card)

    # 6. times, beside the card
    print(f"timing on {card}")
    time_engines(rng, card)
    kernel_times = time_kernels(checks, rng, card)
    time_packed_engines(rng, card)
    kernel_times.update(time_packed_kernels(checks, rng, card))

    # 9. the microbenchmarks' kernels: checks, then their entry points
    compare_microbench_kernels(checks, rng)
    micro = microbench_paths(checks, card)
    micro_plain = time_microbench_plain(checks, rng)
    print(f"time plain oplat {OPLAT_SHAPES[0][0]}x{OPLAT_SHAPES[0][1]} "
          f"n_ops=90 rolls=False, {oplat_script.STEPS} steps: "
          f"{micro_plain['oplat']!r} ms; plain ilpsplit "
          f"{MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} zero split=2, {MAIN_STEPS} "
          f"steps: {micro_plain['ilpsplit']!r} ms [{card}]", flush=True)
    # 10. the sharded megakernel K7: checks, the sharded simulate runs,
    # times
    t10 = time.perf_counter()
    n10 = compare_sharded(checks, rng)
    n10w = compare_windowed(checks, rng)
    sharded_runs = sharded_paths(checks)
    windowed_runs = windowed_paths(checks)
    k7 = time_sharded(rng, card)
    k1w = time_windowed(rng, card)
    print(f"phase 10: {n10} comparisons of K7, {n10w} of K1's shard entry, "
          f"{time.perf_counter() - t10!r} s", flush=True)
    # 11. the plain rungs of the ladder, resume and bf16 snapshots
    t11 = time.perf_counter()
    ladder_paths(checks)
    resume_paths(checks)
    time_ladder(card)
    print(f"phase 11: {time.perf_counter() - t11!r} s", flush=True)
    # 12. the autotuner; 13. parity on the card
    t12 = time.perf_counter()
    autotune_phase(checks, card)
    print(f"phase 12: {time.perf_counter() - t12!r} s", flush=True)
    t13 = time.perf_counter()
    parity_phase(checks, card)
    print(f"phase 13: {time.perf_counter() - t13!r} s", flush=True)
    # 14. livesim on the card, the debug checks, the build store
    t14 = time.perf_counter()
    live = livesim_phase(checks, card)
    print(f"phase 14: {time.perf_counter() - t14!r} s", flush=True)
    # 15. bf16 storage: K1, K1's shard entry, K2 and K7 on bfloat16 buffers
    t15 = time.perf_counter()
    bf16_runs, bf16_times = bf16_phase(checks, rng, card)
    print(f"phase 15: {time.perf_counter() - t15!r} s", flush=True)
    # 16. the folded naive reaction: K1's and K2's fold entries
    t16 = time.perf_counter()
    fold_runs, fold_times = fold_phase(checks, rng, card)
    print(f"phase 16: {time.perf_counter() - t16!r} s", flush=True)
    # 17. the window ring (mega_depth) of K2, K7's read-site wait
    t17 = time.perf_counter()
    ring_times, k7_read_site, ring_runs = ring_phase(checks, rng, card)
    print(f"phase 17: {time.perf_counter() - t17!r} s", flush=True)
    # 18. the tile and depth pins of K1 and K4
    t18 = time.perf_counter()
    n18, pin_runs, pin_times = pins_phase(checks, rng, card, log)
    print(f"phase 18: {n18} comparisons, {time.perf_counter() - t18!r} s",
          flush=True)
    # 19. the megakernels' tile pins (K2, K6, K7) and the sharded windowed
    # engine's K and row tile (K1's shard entry)
    t19 = time.perf_counter()
    n19, pin19_runs, pin19_times = pin19_phase(checks, rng, card, log)
    print(f"phase 19: {n19} comparisons, {time.perf_counter() - t19!r} s",
          flush=True)
    # 20. two processes of the port on the one card (GRAYSCOTT_COORDINATOR);
    # first K1's shard entries at a block's offset in the mesh
    t20 = time.perf_counter()
    n20 = compare_offsets(checks, rng)
    dist_launches = distributed_phase(checks, card)
    print(f"phase 20: {n20} comparisons, {time.perf_counter() - t20!r} s",
          flush=True)
    # 21. the lane fold (K1's folded entry) and the window ring at a pinned
    # tile (K2's pinned ring entries)
    t21 = time.perf_counter()
    n21, fold21_runs, fold21_times = fold21_phase(checks, rng, card,
                                                  log)
    print(f"phase 21: {n21} comparisons, {time.perf_counter() - t21!r} s",
          flush=True)
    # 22. the window ring's redesign: ptxas, every part of its split bit for
    # bit, the split and the second form in device time
    t22 = time.perf_counter()
    n22, ring22_times = ring22_phase(checks, rng, card, log)
    print(f"phase 22: {n22} comparisons, {time.perf_counter() - t22!r} s",
          flush=True)
    # 23. the pinned entries' redesign: ptxas and the occupancy, every part
    # of their split and the entry bit for bit, the split in device time
    t23 = time.perf_counter()
    n23, pin23_times = pin23_phase(checks, rng, card, log)
    print(f"phase 23: {n23} comparisons, {time.perf_counter() - t23!r} s",
          flush=True)
    # 25. the read-site entry's and the folded entry's redesign: ptxas, every
    # part of their splits and the entries bit for bit, the splits in device
    # time, their simulate paths (phases 17d and 21b)
    t25 = time.perf_counter()
    n25, shrs25_times, fold25_times = phase25(checks, rng, card, log)
    paths25(ring_runs, fold21_runs, card)
    print(f"phase 25: {n25} comparisons, {time.perf_counter() - t25!r} s",
          flush=True)
    # 26. K2's and K7's pinned entries' redesign: ptxas and the compiled
    # forms' blocks, every part of their splits and the entries bit for bit,
    # the splits in device time, the pins' simulate paths (phase 19c)
    t26 = time.perf_counter()
    n26, k2_26, k7_26 = phase26(checks, rng, card, log)
    paths26(pin19_runs, card)
    print(f"phase 26: {n26} comparisons, {time.perf_counter() - t26!r} s",
          flush=True)
    snap_ms = time_snapshot(MAIN_SHAPE, 16)
    print(f"time snapshot {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} (clone + D2H to "
          f"pinned): {snap_ms!r} ms/image [{card}]")
    packed_runs = {k: r for k, r in packed_runs.items() if k != "vs_unpacked"}
    # the default and the packed run again with the copy on the launch
    # stream (simulate.run's first form), in the same turns
    part0 = {label: {"flags": group["auto"]["flags"], "ablation": 0}
             for label, group in (("", runs), (" ".join(ZERO_PACKED) + " ",
                                               packed_runs))}
    time_paths([*runs.values(), *packed_runs.values(),
                *sharded_runs.values(), *windowed_runs.values(),
                *fold_runs.values(), *part0.values()])
    cells = MAIN_SHAPE[0] * MAIN_SHAPE[1] * MAIN_STEPS
    for prefix, group in (("", runs), (" ".join(ZERO_PACKED) + " ",
                                       packed_runs),
                          (" ".join(SHARDED_FLAGS) + " ", sharded_runs)):
        for label, run in group.items():
            where = (f"{run['tag']}, mesh {run['mesh']}"
                     if run["mesh"] else run["engine"])
            print(f"path simulate {prefix}{label} end to end ({where}): "
                  f"{cells / run['median_ms'] / 1e6!r} Gcell/s "
                  f"({run['median_ms']!r} ms/image, the median of "
                  f"{run['turns_ms']!r} in turns; the checked run first) "
                  f"[{card}]")
    for run in windowed_runs.values():
        print(f"path simulate {' '.join(run['flags'])} end to end "
              f"({run['tag']}, mesh {run['mesh']}, split {run['split']}): "
              f"{cells / run['median_ms'] / 1e6!r} Gcell/s "
              f"({run['median_ms']!r} ms/image, the median of "
              f"{run['turns_ms']!r} in turns; the checked run first) "
              f"[{card}]")
    for run in fold_runs.values():
        print(f"path simulate {' '.join(run['flags'])} end to end "
              f"({run['counter']}): {cells / run['median_ms'] / 1e6!r} "
              f"Gcell/s ({run['median_ms']!r} ms/image, the median of "
              f"{run['turns_ms']!r} in turns; the checked run first), "
              f"{run['median_ms'] / runs['auto']['median_ms']!r}x the "
              f"default run's {runs['auto']['median_ms']!r} [{card}]")
    for prefix, run in part0.items():
        group = runs if not prefix else packed_runs
        print(f"path simulate {prefix}auto with part 0 ("
              f"{simulate.ABLATIONS[0]}): {run['median_ms']!r} ms/image "
              f"(the median of {run['turns_ms']!r} in turns), against "
              f"{group['auto']['median_ms']!r} with the copy on its own "
              f"stream: {run['median_ms'] / group['auto']['median_ms']!r}x "
              f"[{card}]")
    if "hdf5_seconds" in runs["auto"]:
        print(f"simulate.main with HDF5: "
              f"{runs['auto']['hdf5_seconds'] / MAIN_IMAGES * 1e3!r} "
              f"ms/image, set-up included [{card}]")
    print("nvidia-smi clocks.sm, power.draw, power.limit, temperature: "
          f"{gpu.nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    print(f"chip_smoke ran {time.perf_counter() - t_start!r} s", flush=True)

    if checks.failures:
        print(f"chip_smoke: {len(checks.failures)} check(s) failed: "
              f"{checks.failures}", file=sys.stderr)
        return 1
    entries = []
    for engine, path in (("windowed", "--pallas-engine windowed"),
                         ("resident", "--pallas-resident on")):
        ms, plain_ms, bound, by, steps = kernel_times[engine, MAIN_SHAPE,
                                                      "naive"]
        entries.append(dict(
            KERNELS[engine], launches=runs[path]["launches"][engine],
            max_abs_err=checks.kernel_err[engine], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=list(MAIN_SHAPE), steps=steps, boundary="naive",
            redesigned="csrc/gs_tile_sm90.cuh"))
    # K1's shard entry (the windowed sharded engine): its launches in the
    # default run's windowed paths (2x2), one launch's time and bound
    shard_ms, shard_bound, _ = k1w[MAIN_SHAPE, "naive",
                                   "K1 shard launch 2x2"]
    entries[0].update(
        max_abs_err=max(checks.kernel_err["windowed"],
                        checks.kernel_err["shwin"]),
        sharded_launches=windowed_runs["windowed"]["launches"]["shwin"],
        sharded_overlap_launches=windowed_runs["overlap"]["launches"][
            "shwin"],
        sharded_ms=shard_ms, sharded_plain_ms=k1w["plain"],
        sharded_bound_ms=shard_bound, sharded_mesh=[2, 2],
        sharded_steps=windowed.K)
    ms, plain_ms = bench["naive"]
    bound, by = bound_ms(BENCH_SHAPE, BENCH_STEPS, "naive")
    entries.append(dict(
        KERNELS["mega"],
        launches=runs["--pallas-engine mega"]["launches"]["mega"],
        max_abs_err=checks.kernel_err["mega"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None,
        shape=list(BENCH_SHAPE), steps=BENCH_STEPS, boundary="naive",
        redesigned="csrc/gs_tile_sm90.cuh"))
    for tag, flags in PACKED_FLAGS.items():
        ms, plain_ms, bound, by, steps = kernel_times[tag, MAIN_SHAPE]
        entries.append(dict(
            KERNELS[tag],
            launches=packed_runs[" ".join(flags)]["launches"][tag],
            max_abs_err=checks.kernel_err[tag], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=list(MAIN_SHAPE), steps=steps, boundary="zero",
            redesigned="csrc/gs_packed_sm90.cuh"))
    ms, bound, by = micro["oplat", 90, False]
    entries.append(dict(
        KERNELS["oplat"], launches=micro["oplat_launches"],
        max_abs_err=checks.kernel_err["oplat"], ms=ms,
        plain_ms=micro_plain["oplat"], bound_ms=bound, bound_by=by,
        library_ms=None, shape=list(OPLAT_SHAPES[0]),
        steps=oplat_script.STEPS, n_ops=90, rolls=False))
    bound, by = bound_ms(MAIN_SHAPE, MAIN_STEPS, "zero")
    entries.append(dict(
        KERNELS["ilpsplit"], launches=micro["ilpsplit_launches"],
        max_abs_err=checks.kernel_err["ilpsplit"],
        ms=micro["ilpsplit", MAIN_SHAPE, "zero", 2],
        plain_ms=micro_plain["ilpsplit"], bound_ms=bound, bound_by=by,
        library_ms=None, shape=list(MAIN_SHAPE), steps=MAIN_STEPS,
        boundary="zero", split=2, redesigned="csrc/gs_tile_sm90.cuh"))
    auto = sharded_runs["auto"]
    ms, bound, by = k7[MAIN_SHAPE, "naive", "K7 2x2"]
    entries.append(dict(
        KERNELS["shmega"], launches=auto["launches"]["shmega"],
        max_abs_err=checks.kernel_err["shmega"], ms=ms,
        plain_ms=k7["plain"], bound_ms=bound, bound_by=by, library_ms=None,
        shape=list(MAIN_SHAPE), steps=MAIN_STEPS, boundary="naive",
        mesh=list(auto["mesh"]), redesigned="csrc/gs_tile_sm90.cuh"))
    # the kernels that phase 14a's livesim runs drove, their launches there
    for tag, entry in zip(["windowed", "resident", "mega", *PACKED_FLAGS,
                           "oplat", "ilpsplit", "shmega"], entries):
        if tag in live:
            entry["livesim_launches"] = live[tag]
    # the bf16 entries: their launches on phase 15c's paths, one launch's
    # time at 1080x1920 naive beside the float32 entry's in the same turns
    for tag, path in (("windowed", "auto"), ("shwin", "sharded"),
                      ("mega", "mega"), ("shmega", "sharded mega")):
        ms, f32_ms, bound, by, steps = bf16_times[tag, MAIN_SHAPE, "naive"]
        name = BF16_TAGS[tag]
        entries.append(dict(
            KERNELS[name], launches=bf16_runs[path]["launches"][name],
            max_abs_err=checks.kernel_err[name], ms=ms,
            plain_ms=bf16_times["plain", tag], bound_ms=bound, bound_by=by,
            library_ms=None, shape=list(MAIN_SHAPE), steps=steps,
            boundary="naive", dtype="bfloat16", f32_ms=f32_ms,
            **({"mesh": [2, 2]} if tag.startswith("sh") else {})))
    # the fold entries: their launches on phase 16c's paths, one launch's
    # time at 1080x1920 beside the exact naive and zero entries' in turns,
    # and the first form's (phase 16e's part 0)
    for engine, path in (("windowed", "fold"), ("mega", "fold mega")):
        for dtype, suffix in ((torch.float32, ""),
                              (torch.bfloat16, " bf16")):
            tag = fold_tag(engine, dtype)
            ms, bound, by, steps, naive_ms, zero_ms = fold_times[tag,
                                                                 MAIN_SHAPE]
            entries.append(dict(
                KERNELS[tag],
                launches=fold_runs[path + suffix]["launches"][tag],
                max_abs_err=checks.kernel_err[tag], ms=ms,
                plain_ms=fold_times["plain", tag], bound_ms=bound,
                bound_by=by, library_ms=None, shape=list(MAIN_SHAPE),
                steps=steps, boundary="naive", dtype=str(dtype)[6:],
                naive_fold=True, exact_ms=naive_ms, zero_ms=zero_ms,
                **({"first_form_ms": fold_times["split", engine,
                                                MAIN_SHAPE][0],
                    "load": "tma"} if dtype == torch.float32 else {})))
    # the ring's entries: their launches on phase 17d's paths at
    # RING_PATH_DEPTH, one launch's time at 1080x1920 at that depth beside
    # depth 2's in the same turns (phase 17b)
    for tag, (dtype, fold) in RING_K2.items():
        boundary = "naive"
        ms, bound, by = ring_times[tag, MAIN_SHAPE, boundary,
                                   RING_PATH_DEPTH]
        entries.append(dict(
            KERNELS[tag], launches=ring_runs[tag]["launches"][tag],
            max_abs_err=checks.kernel_err[tag], ms=ms,
            plain_ms=ring_times["plain", tag], bound_ms=bound, bound_by=by,
            library_ms=None, shape=list(MAIN_SHAPE), steps=MAIN_STEPS,
            boundary=boundary, dtype=str(dtype)[6:], naive_fold=fold,
            mega_depth=RING_PATH_DEPTH,
            depth2_ms=ring_times[tag, MAIN_SHAPE, boundary, 2][0],
            **({"first_form_ms": ring22_times[
                MAIN_SHAPE, f"depth {RING_PATH_DEPTH}"][0]}
               if tag == "mega_ring" else {})))
    # K7's read-site wait: its launches on phase 17d's 4x1 path, one
    # launch's time on 4x1 at 1080x1920 beside the entry gate's (17c)
    rs_ms, gate_ms, bound, by = k7_read_site[MAIN_SHAPE, (4, 1), "naive"]
    entries.append(dict(
        KERNELS["shmega_read_site"],
        launches=ring_runs["shmega_read_site"]["launches"][
            "shmega_read_site"],
        max_abs_err=checks.kernel_err["shmega_read_site"], ms=rs_ms,
        plain_ms=k7_read_site["plain"], bound_ms=bound, bound_by=by,
        library_ms=None, shape=list(MAIN_SHAPE), steps=MAIN_STEPS,
        boundary="naive", mesh=[4, 1], entry_gate_ms=gate_ms,
        first_form_ms=shrs25_times[MAIN_SHAPE, (4, 1), "naive"][0],
        split_entry_ms=shrs25_times[MAIN_SHAPE, (4, 1), "naive"]["entry"],
        redesigned="grayscott_tpu_torch/csrc/sharded_mega_fit.cu"))
    # the pinned entries: their launches on phase 18c's paths, one K = 16
    # launch on 64x64 tiles at 1080x1920 beside the compiled entry's K = 8
    # launch (phase 18d)
    # (K1's pinned and pinned shard entries also the first form's time:
    # phase 23c's part 0 on the same tiles, in turns with the entry)
    g16 = geometry.resolve(MAIN_SHAPE, 16)
    first_form = {"windowed_pinned": pin23_times[
        f"K1 pinned {g16.label()} K=16", MAIN_SHAPE][0]}
    for tag, path in (("windowed_pinned", "k16"),
                      ("windowed_pinned_bf16", "bf16 k16"),
                      ("windowed_pinned_fold", "fold k16"),
                      ("windowed_pinned_fold_bf16", "fold bf16 k16"),
                      ("packed_pinned", "pack k16")):
        ms, plain_ms, bound, by, k8_ms = pin_times[tag]
        entries.append(dict(
            KERNELS[tag], launches=pin_runs[path]["launches"][tag],
            max_abs_err=checks.kernel_err[tag], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=list(MAIN_SHAPE), steps=16,
            boundary="zero" if tag == "packed_pinned" else "naive",
            steps_per_call=16, tile=[64, 64], compiled_k8_ms=k8_ms,
            **({"first_form_ms": first_form[tag]} if tag in first_form
               else {})))
    # the megakernels' and the shard entry's pinned entries: their launches
    # on phase 19c's paths, one launch at 1080x1920 naive (zero: K6) on the
    # path's tiles (phase 19d)
    # (K2's and K7's pinned entries: phase 26c's part 0 on the same tiles,
    # in turns with the entry)
    f32, bf16 = torch.float32, torch.bfloat16
    first_form.update({
        "mega_pinned": k2_26[MAIN_SHAPE, (32, 128), f32, "naive"][0],
        "mega_pinned_bf16": k2_26[MAIN_SHAPE, (16, 64), bf16, "naive"][0],
        "shmega_pinned": k7_26[MAIN_SHAPE, (2, 2), (32, 128), f32,
                               "naive"][0],
        "shmega_pinned_bf16": k7_26[MAIN_SHAPE, (1, 4), (64, 128), bf16,
                                    "naive"][0]})
    for tag, (path, _) in PIN19_KERNELS.items():
        ms, plain_ms, bound, by, stepped, g, steps = pin19_times[tag]
        if tag == "shwin_pinned":
            first_form[tag] = pin23_times[
                f"K1 shard pinned 2x2 {g.label()} K={steps} all",
                MAIN_SHAPE][0]
        entries.append(dict(
            KERNELS[tag], launches=pin19_runs[path]["launches"][tag],
            max_abs_err=checks.kernel_err[tag], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=list(MAIN_SHAPE), steps=steps,
            boundary="zero" if tag == "megapack_pinned" else "naive",
            tile=[g.tr, g.tc], halo=g.halo, stepped_bound_ms=stepped,
            **({"first_form_ms": first_form[tag]} if tag in first_form
               else {})))
    # K1's folded entry and K2's pinned ring entries: their launches on
    # phase 21b's paths, one launch at 1080x1920 naive (phase 21c)
    ms, plain_ms, bound, by, stepped, k1_ms, f, rp, g = fold21_times[
        "windowed_folded"]
    entries.append(dict(
        KERNELS["windowed_folded"],
        launches=fold21_runs["fold 2"]["launches"]["windowed_folded"],
        max_abs_err=checks.kernel_err["windowed_folded"], ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        shape=list(MAIN_SHAPE), steps=FOLD21_K, boundary="naive", fold=f,
        panel_rows=rp, tile=[g.tr, g.tc], halo=g.halo,
        stepped_bound_ms=stepped, unfolded_k1_ms=k1_ms,
        path_ms=fold21_runs["fold 2"]["ms"],
        unfolded_path_ms=fold21_runs["fold 2"]["ms2"],
        first_form_ms=fold25_times[MAIN_SHAPE, 2, FOLD21_K][0],
        split_entry_ms=fold25_times[MAIN_SHAPE, 2, FOLD21_K]["entry"],
        redesigned="grayscott_tpu_torch/csrc/windowed_folded.cuh"))
    (tr, tc), depth = RING21_PATH
    for tag, (dtype, fold) in RING21_ENTRIES.items():
        ms, plain_ms, bound, by, stepped, ms2 = fold21_times[tag]
        entries.append(dict(
            KERNELS[tag], launches=fold21_runs[tag]["launches"][tag],
            max_abs_err=checks.kernel_err[tag], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=list(MAIN_SHAPE), steps=32, boundary="naive",
            dtype=str(dtype)[6:], naive_fold=fold, tile=[tr, tc],
            mega_depth=depth, stepped_bound_ms=stepped, depth2_ms=ms2,
            **({"first_form_ms": ring22_times[
                MAIN_SHAPE, f"{tr}x{tc} depth {depth}"][0]}
               if tag == "mega_pinned_ring" else {})))
    # K1's shard entries: their launches on phase 20's two-process runs,
    # by rank, summed over the runs that launch them
    name_of = {"shwin": KERNELS["windowed"]["name"],
               "shwin_bf16": KERNELS["shwin_bf16"]["name"],
               "shwin_pinned": KERNELS["shwin_pinned"]["name"]}
    for entry in entries:
        labels = [label for label, (_, _, tag) in DIST_RUNS.items()
                  if name_of[tag] == entry["name"]]
        if labels:
            entry["two_process_launches"] = [
                sum(dist_launches[label][r].get(DIST_RUNS[label][2], 0)
                    for label in labels) for r in range(2)]
            entry["two_process_runs"] = labels
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
