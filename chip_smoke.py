#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, render.

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --k1-only    # phases 1-4, 19, 21 and 12
    python3 chip_smoke.py --shade-only # phases 1-3 and 19
    python3 chip_smoke.py --front-only # phases 1-3 and 21
    python3 chip_smoke.py --app-only   # phases 1, 2 and 13 (with phase 9's fixtures)
    python3 chip_smoke.py --animate-only   # phases 1, 2 and 14
    python3 chip_smoke.py --tracers-only   # phases 1, 2 and 15
    python3 chip_smoke.py --modes-only     # phases 1, 2 and 16
    python3 chip_smoke.py --builds-only    # phases 1, 2 and 17
    python3 chip_smoke.py --multi-only     # phases 1, 2 and 18
    python3 chip_smoke.py --lbvh-wide-only # phases 1, 2 and 20
    python3 chip_smoke.py --instanced-only # phases 1, 2 and 22
    python3 chip_smoke.py --k5-baseline OLD/tpu_raytracing_torch/csrc/lane_trace.cu
                                       # every phase; phase 7 also times an
                                       # earlier K5 source beside K5
    python3 chip_smoke.py --k6-baseline OLD/tpu_raytracing_torch/csrc/fat_traverse.cu
                                       # every phase; phase 9 also times an
                                       # earlier K6 source beside K6 (the
                                       # flag may be given more than once)
    python3 chip_smoke.py --builds-only --k1-baseline OLD/tpu_raytracing_torch/csrc/split_trace.cu
                                       # phase 17 also times an earlier K1
                                       # source on each 16-wide pass (the
                                       # flag may be given more than once)

Drives ``tpu_raytracing_torch`` only (no JAX, no ``tpu_raytracing``) and
exits non-zero if any phase fails:

1. Device: requires CUDA; prints the card, the device count and
   ``nvidia-smi``'s name and power limit.
2. Build: compiles ``csrc/split_trace.cu`` (K1), ``csrc/lane_trace.cu``
   (K5), ``csrc/fat_traverse.cu`` (K6), the probes'
   ``csrc/micro_probe.cu`` and ``csrc/lane_probe.cu``, the path
   tracer's ``csrc/bounce_shade.cu``, the Karras build's
   ``csrc/lbvh_hierarchy.cu``, the fat collapse's
   ``csrc/wide_collapse.cu`` and the split front's ``csrc/split_front.cu``
   with nvcc, in
   parallel, into ``tpu_raytracing_torch/build/`` and prints each
   kernel's ptxas register and spill lines under its name.
3. Split path: the frame ``bench.py`` times — ``terrain(1_000_000)``,
   aerial camera, per-frame split-BVH rebuild + capacity check,
   fixed-topology refit, the ``tid`` bounce sort from ``build_pair_tid``,
   then a 1024x1024 path-traced frame with 1 bounce: one warm frame and 2
   timed ones. K1's, the bounce-shade kernel's and the split front's two
   kernels' launch counts are set to 0 before these frames and read after
   them; every frame must launch K1 at least 4 times, each front kernel as
   often as K1 and the bounce-shade kernel ``BOUNCES + 1`` times, no
   ray may overflow its stack, and the image must be finite with a nonzero
   mean.
   Two frames with the ``leaf`` sort are timed after, for comparison.
4. K1 against its plain PyTorch version on the card, bit for bit: t, tri,
   inner and leaf pops and the overflow flag must agree on every ray, in
   closest-hit and any-hit, on the sphere and soup(2000) fixtures (camera,
   axis-aligned, random and half-dead ray sets), on 65,536 live rays
   sampled evenly from each of the 1M frame's four passes (each sample with
   at least one hit), and on the tie fixtures: every triangle of
   terrain(32) and soup(2000) twice, pairs off and on, leaf widths 8, 40,
   64 and 128, with rays of tmax = F32_MAX for the all-miss window. Then K1
   is timed on each of the frame's four passes as the frame launches it,
   held to the plain version on every ray of each, with each pass's bound
   and mean pops per live ray; the plain version is timed on the bounce
   pass. Phase 12 runs next; ``--k1-only`` stops after it.
12. The frame-0 binned-SAH trace tree (``bench.py:175-228``) on phase 3's
   scene with pairs and 64-pair windows, with no fallback: a failed build,
   or one past its deadline, fails the phase. One build through
   ``build_sah_split`` with its ``stats`` (setup, frontier, emit seconds;
   the frontier's level count; the deepest anchor's depth) and the peak
   memory; ``check_sah_split_capacity``; the Tri
   entries' windows must tile [0, num_leaves) exactly once, and
   ``refit_split`` must give back the emitted box words (as floats); the
   tree's depth in rows must match its deepest anchor. The same build of
   terrain(65,536), pairs on, splits off and on, on the card and on the
   CPU: integer words and pair rows bit-equal, box words equal as floats.
   Then the bench frame on the SAH tree (``sah_split_views``, K1 on all
   four passes, the ``leaf`` bounce sort, phase 3's camera and seeds): one
   warm frame and 2 timed; K1 must launch on every pass, no ray may
   overflow the tree's stack bound, and the image must be finite and
   within 40 dB PSNR of phase 3's; one profiled frame. K1 is held to its
   plain version on every ray of each of the four passes and timed there,
   as in phase 4, and its hits on 4,096 primary and 4,096 bounce rays to
   brute force over the 1M triangles (0.5% may differ; a different
   triangle at exactly the same t counts as agreement).
5. Treelet build at 1M: ``build_treelet_auto`` on the phase-3 front (one
   warm build, 2 timed), its capacity check, and ``pair_tid`` equal to
   ``build_pair_tid`` on every pair.
6. Lane path: the app's ``--tracer lane`` path (``app/main.py:build_trav``)
   at 1M, 1024x1024, 1 bounce, wave driver, with phase 3's camera and
   generator seeds: one warm frame and 2 timed. K5's launch count is set
   to 0 before and read after; it must grow on every one of the 4 passes
   of every frame, no ray may be left unfinished, and the image must be
   finite and within 40 dB PSNR of phase 3's split frame. The phase ends
   with one profiled frame, as phases 3 and 8 do.
7. K5 against its plain version on the card, bit for bit on all 8 out rows
   and the whole state, in closest-hit and any-hit and in three launch
   modes (unbudgeted, budget 48, no_switch): on the sphere and soup(2000)
   fixtures with ecap 128 and with ecap 16 (8-pair windows: portals and
   the multi-round cut), on 65,536 live rays sampled evenly from each
   lane-frame pass, and on the tie fixtures: every triangle of terrain(32)
   and soup(2000) twice, pairs off and on, leaf width 16 / ecap 128 and 8 /
   16 (and 24, 40 and 128 at ecap 128), with rays of tmax = F32_MAX for the
   all-miss window. The lane
   tracer's hits on 4,096 bounce rays are held to brute force over the 1M
   triangles. Then K5 is timed on each of the lane frame's four passes as
   the frame launches it (the sum of the wave driver's launches, each
   replayed on its recorded operands) and as one unbudgeted launch, held
   to the plain version bit for bit on every ray of each pass, with each
   pass's bound and inner and window visits per live ray; the plain version
   is timed on the bounce pass; and each lane driver is timed on the bounce
   pass. With ``--k5-baseline``, the earlier K5 source (same C interface,
   reading the reference's ``tables`` layout) is built beside the others,
   held bit-equal to K5 on every replayed launch and timed on the same
   operands, and the drivers are timed on it too.
8. Binary path: the Karras build (``build_lbvh``, one warm build and 2
   timed) of phase 3's scene with pairs; ``count_nodes``' leaf count must
   equal the build's live leaf count and ``verify_hierarchy`` must find no
   error. Then ``pack_pairs`` and ``build_wide_fat`` (timed) and a
   1024x1024, 1-bounce frame with ``make_fat_tracer`` on all four passes and
   the ``leaf`` bounce sort, with phase 3's camera and generator seeds: one
   warm frame and 2 timed. K6 must launch on every pass, no ray may
   overflow, and the image must be finite and within 40 dB PSNR of phase 3's
   split frame. Phases 3 and 8 end with one frame under ``torch.profiler``:
   the device's busy share of it and the kernels with the most device
   time.
9. K6 against its plain version on the card, bit for bit on all six
   outputs and the overflow flag, and so are its clock64-profiled form and
   the profiled one-thread-per-ray kernel it replaced
   (``fat_traverse_cycles``): on the sphere and soup(2000) fixtures (pairs
   off and on; camera, axis-aligned, random and half-dead ray sets), on
   65,536 live rays sampled evenly from each pass of the phase-8 frame,
   and on the tie fixtures: every triangle of terrain(32) and soup(2000)
   twice, pairs off and on, the same ray sets and rays of tmax = F32_MAX.
   K6's hits on 4,096 bounce rays are held to brute force and to the
   scalar ``trace_rays`` on the same tree. Then K6 (and, with
   ``--k6-baseline``, each earlier source) is timed on each of the frame's
   four passes as the tiled tracer hands them over, held to the plain
   version on every ray of each, with each pass's bound, pops per live
   ray, triangle tests per pop and per live ray, and two clock64 splits
   per live ray (node loads and box tests; the Tri entries; sort, push and
   pop): K6's, taken by the warp, and the replaced kernel's, taken per
   lane; the plain version is timed on the bounce pass.
10. K1 with no selector for the reference's K3, v4 and K4 on phase 3's
   bounce pass: one ``trace_rays_split`` call launches K1 once, and its
   statistics are per ray, K1's own inner and leaf pops times the row
   width and the window's triangles.
11. The ``benchmarks/`` micro-probes (``tpu_raytracing_torch/benchmarks/``,
   kernels ``csrc/micro_probe.cu`` and ``csrc/lane_probe.cu``): every
   module's entry point at the reference's size (N = 200,000 loop
   iterations, ITERS = 4,096 lane iterations; each probe the median of 5
   runs with inputs varied per run, each in CUDA events queued behind a
   spin kernel so that the wrapper's host work is left out), with the
   launch counts set to 0 before and read after; every one of the 33
   probes must launch, and the one-shot gathers, the
   one shift and E2's chain must equal PyTorch's own calls
   (``take_along_dim``; ITERS ``torch.matmul`` steps). Then each kernel
   against its plain version at N = 4,096 / ITERS = 64, bit for bit on
   every output (the final stacks and comp's tile included; the scalar
   probes from seeded scratch and from interpret mode's NaN / INT32_MIN
   fill); the plain versions timed there, the library calls at the
   reference's size; the sanity orderings (dma1 > loop, pipe4 < dma1,
   fetch2 >= fetch, V3 <= V2 per packet-iter) printed; and ``fetch`` timed
   with the lanes on one column, on 128 conflict-free columns and on 128
   columns 4 to a bank, beside how the reference's chains fall on the
   banks.
13. The app's default run (``tpu_raytracing/app/args.py:23,34,56,59``:
   ``--type sah --tracer wide --bounces 0``), called in this process
   through ``app/main.py:main``: first with no flags at all (cornell,
   1024x768, mode 0, ``out/frame0000_mode0.png``); then on phase 3's scene
   with ``--pairs --cycle-modes --width 1024 --height 768 --frames 2``:
   the SAH binary build and the fat collapse timed by the app's
   ``StageTimer``, the tree's binary depth, each mode's frame (render and
   read-back), the 18 PNGs read back at full size (all but LODS opaque;
   each mode's frames 0 and 1 equal), and K6's counting launches set to 0
   before and read after: every mode must launch the counting
   instantiation, and nothing the one without counts. The default camera
   sits at the scene's centre, on the terrain, so every mode is then also
   rendered and timed from phase 3's aerial camera (more than a quarter
   of each frame lit). K6's counting instantiation is held to its plain
   version bit for bit, outputs and both counts, on 65,536 rays of the
   primary pass and of TEXTURE_LIT_SHADOWS' shadow pass from both cameras
   (and, with ``--app-only``, on phase 9's fixtures; in a full run phase 9
   holds it there and on the binary frame's passes), then timed against
   the instantiation without counts on each whole primary pass, in turns,
   with the bound and the plain version, and held to the plain version
   on every ray of it. ``--tracer split`` renders the nine modes of the
   same scene, held to the wide images at 40 dB in modes 0 and 8. Last
   the rock (``scene/genasset.py``, 6 subdivisions, 81,922 triangles and
   a 256x256 texture): generated, parsed by the native parser (which must
   run) and by the Python one (the same arrays), and rendered in all nine
   modes through the app with the wide tracer and with ``--tracer
   scalar`` (``trace_rays``) on the same SAH tree: modes 0, 3 and 5-8 at
   40 dB or more between the two, the textured modes with more than one
   colour. Images go to ``out/chip_smoke/`` (git-ignored).
14. The app's animated run (``--animate-only`` runs phases 1, 2 and 14):
   the refit schedule on the bucket and SAH split trees at 1M through
   ``app.main.main``, per-frame rebuilds with ``--tracer wide`` and each
   ``--type`` and with ``--tracer lane``, the hybrid tree's checks,
   ``--profile-build``, and ``--interactive`` in a pseudo-terminal.
15. The app's last two tracers and instancing (``--tracers-only`` runs
   phases 1, 2 and 15, and first renders phase 3's split frame itself):
   the uniform grid on phase 3's scene with pairs (the build timed, its
   resolution, refs, big list and overflow), a 1024x1024 1-bounce frame
   with the grid's closest-hit tracer and its any-hit tracer for the
   shadows at phase 3's camera and seeds (frame ms, Mrays/s, finite, 40 dB
   or more from phase 3's split frame), its hits on 4,096 primary and
   bounce rays against brute force, and 65,536 bounce rays with
   ``residue_after`` and with ``segments`` equal to the single-phase walk
   bit for bit; the app's ``--tracer grid`` with ``--grid-scale 0.5`` and
   with ``--animate`` (3 frames at 1024x768, DIFFUSE, each frame's grid
   rebuild); the app's ``--tracer packet`` on the Karras tree in DEPTH and
   DIFFUSE at 1024x768, and the packet tracer against K6's wide tracer on
   the aerial camera's rays (exact-t ties allowed); config 4 of
   ``benchmarks/bench_configs.py`` (``sphere_scene(4)`` as the BLAS, 1,000
   instances from ``default_rng(3)``, 512x512): ``build_instanced`` and
   ``build_instanced_split`` per frame over jittered transforms, ``k_slots``
   from ``max_overlap`` and ``item_budget`` from the first trace's guard
   (an overflow fails the phase), both tracers' frames against each other,
   1,024 rays against brute force over the 5.1M world triangles, and K1
   against its plain version bit for bit on every item of the
   object-space pass. K1's launch count is set to 0 before the instanced
   frames and read after; its launches go into the ``kernels`` line.
16. The reference's remaining tracers (``--modes-only`` runs phases 1, 2
   and 16, and first renders phase 3's split frame itself), on phase 3's
   scene, bucket tree, camera and seeds: the 1024x1024 1-bounce frame with
   the bounce and bounce-shadow passes through the binned tracer
   (``make_split_tracer(sort_mode="binned")``, ``cell`` bounce sort): frame
   ms, items per live ray, the item slots needed against the cap, overflow
   0, finite and 40 dB or more from phase 3's frame; K1 with start tags
   against its plain version bit for bit on 65,536 live items sampled from
   each binned pass with their own tags (every leaf-window item too, where
   the root has Tri children), then with leaf-window and inner-row tags;
   K1 timed on both binned passes and on the same frame's presorted
   passes, each with its bound, held to plain on every ray; the binned
   hits against the presorted ones; the ``origin``, ``cell_octant`` and
   ``sort_origin`` modes on the bounce rays in a random order against the
   presorted pass, closest-hit and any-hit; the BFS tracer on the primary
   and bounce passes with caps of ``BFS_CAP_FACTOR`` x R (the reference's
   default 3.0 overflows at 1M; visits per level, against K1 on every ray
   and brute force on 4,096); config 4 on
   the instanced grid against the split-kernel instanced tracer on every
   ray; the wide packet tracer on the Karras ``WideBVH`` from the aerial
   camera at 1024x768 against K6 (at most 0.5% of the rays may differ: its
   Möller-Trumbore rounds as the reference's XLA code, K6's as its plain
   version). K1's launch count is set to 0 before the
   binned frames and read after; its launches go into the ``kernels`` line.
17. The remaining builds (``--builds-only`` runs phases 1, 2 and 17, and
   first renders phase 3's frame and builds phase 8's Karras rows itself),
   on phase 3's scene with pairs: the 16-wide bucket tree
   (``emit_split_views(inner_width=16)``, timed; its rows, levels and stack
   bound against what the tree needs), the bench frame on it with K1's
   16-wide instantiation on all four passes (K1's launch count set to 0
   before the frame and read after; 40 dB or more from phase 3's frame),
   each pass timed by CUDA events with its bound and pops per live ray
   against the 8-wide tree's on the same rays, K1 bit-equal to plain on
   every ray of the bounce pass and on 65,536 sampled live rays of the
   others, brute force on 4,096 primary and bounce rays; the registers of
   K1's instantiations; the 8-wide K1 kernels' SASS (``cuobjdump -sass``)
   against ``K1_8WIDE_SASS``, the digest of the build from before the
   16-wide inner rows moved to half-warps; on the bounce pass,
   ``split_traverse_cycles``' clock64 split (inner rows, leaf windows, leaf
   wait) of the 16-wide tree's half-warp and per-lane inner rows and of
   the 8-wide tree, on the same rays, each bit-equal to K1's outputs (with
   ``--k1-baseline``, each earlier source is held bit-equal to K1 and
   timed on every pass); entry-distance ties on a 16-wide row (entries 7
   and 15, 0 and 8, 7 and 8, and all 16 with the ray origins inside every
   box), K1 equal to plain and to the tie rule's ids;
   ``build_bucket_split_v1`` at widths 8 and 16, timed and bit-equal to
   ``build_bucket_split``; ``build_bucket_fat`` and
   ``build_implicit_wide_fat``, timed, their live rows and levels, the frame
   on each with K6 on every pass (40 dB or more from phase 3's), each pass
   timed against phase 8's Karras rows on the same rays, with its bound and
   box tests per live ray against the Karras rows' (the counting
   instantiation); on the bucket fat tree K6 is held to plain on 65,536
   sampled live rays a pass, with pops per live ray against the Karras
   rows'; the implicit tree's padding-subtree walk makes a plain pass
   minutes long at 1M, so K6 meets plain on every primary ray of a 128²
   frame over ``terrain(IMPLICIT_CHECK_TRIS)``'s implicit tree; ``with_trips=True`` on phase 8's rows at
   1024² in 8x8 packets (``benchmarks/profile_trips.py``'s statistics and
   the loop's ms); ``segmented_scan`` on the card against the CPU.
18. The multi-device renderers (``--multi-only`` runs phases 1, 2 and 18
   on its own copies of phase 3's inputs): a world of 1 on NCCL runs the
   split ``path_trace_sharded`` at 1024², 1 bounce (timed after a warm
   call), ``render_frame_sharded_split`` lit at 1024²,
   ``trace_instanced_split_sharded`` on config 4, the megakernel
   ``render_frame_sharded`` lit at ``MULTI_MEGA_RES``² on phase 8's Karras
   tree and the grid ``path_trace_sharded`` at ``MULTI_GRID_RES``² (both
   host-loop tracers), each held to its single-device function (bit-equal,
   the path traces 40 dB or more); then two processes of this script
   (``--multi-rank``) form a world of 2 on the one card over gloo (NCCL
   refuses two ranks on one device; the collectives take host copies) and
   must return the world of 1's results bit for bit, the instanced
   guard aside (a band maximum). K1's launch count is set to 0 before the
   phase and read after; its launches go into K1's ``kernels`` entry.
19. The bounce-shade kernel (right after phase 3, on its scene, tree,
   tracers and ``tid`` sort; ``--shade-only`` stops after it): an 8-bounce
   frame (the benchmark's split cells) and a 1-bounce one must each launch
   it ``num_bounces + 1`` times and match, image and ray count bit for
   bit, the frame with ``pathtrace.bounce_shade_plain`` in its place; on
   every call's captured inputs, with both ``sample_next`` values and every
   ray (the dead ones too), it must match the plain version bit for bit on
   every output; each launch as the frame made it is timed on the device
   from ``torch.profiler``'s trace (the kernel alone) against its bytes
   bound, and by CUDA events around the wrapper's call and around the plain
   version. Its entry in the ``kernels`` line counts the launches of phase
   3's frames (``BOUNCES + 1`` each) and of this phase's captured frames,
   each count set to 0 before and read after.
20. BASELINE config 5 as written (the benchmark's ``terrain1m-lbvh-wide``
   configuration; last, or ``--lbvh-wide-only`` for phases 1, 2 and 20):
   first the SASS of K6's closest-hit and counting instantiations
   (``cuobjdump -sass``) against ``K6_SASS`` and beside each
   ``--k6-baseline``'s; then the 1M terrain wobbled to t = ``LBVH_WIDE_T``,
   the Karras hierarchy kernel (``csrc/lbvh_hierarchy.cu``) bit-equal to
   ``generate_hierarchy_plain`` on that frame's paired and unpaired codes
   and on small codes full of ties with live counts down to none, and
   timed; its Karras tree and fat collapse through the app's ``build_accel`` and
   ``build_trav`` (``--type bottom-up --pairs --tracer wide --bounces 8
   --animate``), and an 8-bounce 1024x1024 frame with the app's four
   tracers (``make_fat_frame_tracers``): K6's launches by instantiation,
   the image and ray count bit-equal to the frame traced with the tiled
   counting tracer alone, both frames timed; on every shadow call, K6's
   any-hit ``hit`` equal to its closest-hit instantiation's on every ray,
   any-hit bit-equal to ``trace_fat_plain(..., any_hit=True)`` on all six
   outputs (every ray of the primary shadow pass and of the first bounce
   shadow pass, ``SLICE`` live rays of the others), and both
   instantiations timed on the operands the tracer hands over, with the
   any-hit bound from the plain version's counts. Between the hierarchy
   and the app's build, the collapse kernels (``csrc/wide_collapse.cu``
   through ``wide.collapse_fat``) must equal ``build_wide_fat`` on the card,
   rows and ``num_nodes``, one launch count a collapse, on the frame's 1M
   Karras tree with and without pairs, the modes configuration's binned-SAH
   tree (``--type sah --pairs``, root_count 1), a one-leaf root pair, a
   two-leaf tree, a small single-root SAH tree and a 30-level caterpillar;
   a 70- and a 5,000-level caterpillar must raise ``check_stack_depth``'s
   error, word for word; on the paired 1M tree the collapse is timed by
   CUDA events (with its one host read) and by kernel from
   ``torch.profiler``'s trace, beside its bytes bound and the plain
   ``check_stack_depth`` and ``build_wide_fat``, with its registers and
   spills; the app's two warm and timed ``build_trav`` calls must count one
   collapse each, and an animated app run of ``COLLAPSE_APP_FRAMES``
   frames one a frame.
21. The split front's kernels (``csrc/split_front.cu``; right after phase
   19, on phase 3's scene, tree, tracers and ``tid`` sort; ``--front-only``
   runs phases 1-3 and 21): first the 8-wide K1 kernels' SASS against
   ``K1_8WIDE_SASS``, as in phase 17; then an ``FRONT_BOUNCES``-bounce frame
   (the benchmark's split cells: 18 K1 calls, 9 closest-hit and 9 any-hit)
   must launch the operand kernel (``split_trace.kernel_operands``) and the
   record kernel (``traverse.reconstruct``) once a call, and match, image and
   ray count bit for bit, the frame with ``kernel_operands_plain`` and
   ``reconstruct_plain`` in their places; on every call's captured operands,
   each kernel must match its plain version bit for bit on every output and
   every ray; each launch as the frame made it is timed on the device from
   ``torch.profiler``'s trace against its bytes bound, and by CUDA events
   around the wrapper's call and around the plain version. Their entries in
   the ``kernels`` line count the launches of phase 3's frames and of this
   phase's captured frame.
22. BASELINE config 4 on the app's path (the benchmark's ``instanced1k-split``
   configuration's sizes with the app's own scene and scatter; last, or
   ``--instanced-only`` for phases 1, 2 and 22): the app's ``--instances``
   run (1,000 instances of ``sphere_scene(6)``, ``--tracer split --type
   bottom-up --pairs --bounces 8 --animate``, 1024x1024) must launch the
   sweep kernel (``csrc/instanced_sweep.cu``) once an instanced call; an
   8-bounce frame on its last instance level must match, image and ray
   count bit for bit, the frame with the plain sweep, items, resolve and
   record in their places; on every call's captured inputs the sweep kernel
   must give its plain version's counts, statistics and every ray's run of
   overlaps (lowest instance first, from the ray's first slot), the item,
   resolve and record kernels their plain versions' outputs bit for bit,
   K1 its plain version's on up to ``SLICE`` live items of the primary pass
   and its shadows, and the
   bounce-shade kernel with the instances' normal matrices its plain
   version's on every call. Each of the four kernels is timed on each
   call as the frame made it from ``torch.profiler``'s trace against its
   bound (the sweep: the larger of its slab tests' operations and its
   bytes; the item, resolve and record kernels: their bytes), with its
   plain version's time on the primary pass and its registers; each has
   its own launch count (``instanced_split.launch_count``,
   ``items_launch_count``, ``resolve_launch_count``,
   ``record_launch_count``), and its entry in the ``kernels`` line counts
   the launches of the app's frames and the captured frame, read before
   the checks launch it again. Phase 19 takes
   ``--shade-baseline SOURCE``: an earlier ``csrc/bounce_shade.cu`` built
   beside the current one, which must match it bit for bit on every call of
   its frames (the one-level frames hand the kernel no instance data) and
   is timed beside it.

For every kernel the script computes a bound: the larger of the float32
operations of its slab and triangle tests over 67 TFLOP/s and the bytes it
must move (rays in, results out, each structure row it visits once) over
3.35 TB/s, the H100 SXM's published peaks, counted from the 1M bounce
pass's per-ray statistics (K6's counting instantiation from the app
frame's primary pass; for a probe: from its inputs, outputs and loop
length at the reference's size, E2's bf16 products over the tensor cores'
989 TFLOP/s; see each module's ``work``). The last two lines of standard
output are a JSON summary of the kernels and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

T_PROCESS0 = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_raytracing_torch.app import main as app_main  # noqa: E402
from tpu_raytracing_torch.app.args import parse_cmd  # noqa: E402
from tpu_raytracing_torch.app.main import build_trav  # noqa: E402
from tpu_raytracing_torch.benchmarks import (  # noqa: E402
    _common,
    _lane,
    _micro,
    micro_control,
    micro_pallas,
    probe_lane_machine,
    probe_lane_machine2,
    probe_lane_machine3,
)
from tpu_raytracing_torch.bvh import (  # noqa: E402
    bucket,
    grid,
    hybrid,
    implicit,
    lbvh,
    split_convert,
    tlas,
    treelet,
    wide,
)
from tpu_raytracing_torch.bvh.types import BVH, CHILD_BOX, CHILD_NONE, CHILD_TRI  # noqa: E402
from tpu_raytracing_torch.bvh.verify import count_nodes, verify_hierarchy  # noqa: E402
from tpu_raytracing_torch.ops import _cuda_build, fat_traverse  # noqa: E402
from tpu_raytracing_torch.ops.scan import segmented_scan  # noqa: E402
from tpu_raytracing_torch.scene import camera as cam  # noqa: E402
from tpu_raytracing_torch.scene import genasset, native_loader, objio, procedural  # noqa: E402
from tpu_raytracing_torch.scene.types import scene_to_device  # noqa: E402
from tpu_raytracing_torch.trace import (  # noqa: E402
    binned,
    grid_instanced,
    grid_trace,
    instanced,
    instanced_split,
    lane_trace,
    render,
    split_trace,
    traverse,
    wavefront_bfs,
    wide_fat,
    wide_packet,
)
from tpu_raytracing_torch.trace.brute import brute_force_trace  # noqa: E402
from tpu_raytracing_torch.trace.modes import RenderType  # noqa: E402
from tpu_raytracing_torch.trace import pathtrace  # noqa: E402
from tpu_raytracing_torch.trace.pathtrace import path_trace  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays, generate_primary_rays  # noqa: E402
from tpu_raytracing_torch.trace.packet import tile_reorder  # noqa: E402
from tpu_raytracing_torch.trace.traverse import (  # noqa: E402
    PackedPairs,
    f2i,
    i2f,
    pack_bvh,
    pack_pairs,
    trace_rays,
)
from tpu_raytracing_torch.utils.compare import psnr  # noqa: E402
from tpu_raytracing_torch.utils.png import read_png  # noqa: E402
from tpu_raytracing_torch.utils.timing import StageTimer  # noqa: E402

NUM_TRIS = 1_000_000
RES = 1024
BOUNCES = 1
ITERS = 2
SLICE = 65_536
BRUTE_RAYS = 4096
T_RTOL = 1e-5
# Brute force tests each source triangle; the tracers test a pair's second
# triangle as (v2, v1, v3), so a ray at an edge may hit or miss by float32
# rounding, and neighbours sharing an edge tie on t.
BRUTE_AGREE = 0.995
MIN_PSNR = 40.0
# The SAH build's deadline (bench.py's TPURT_SAH_BUDGET_S is 1500) and the
# scene size of its card-against-CPU check.
SAH_BUDGET_S = 300.0
CPU_CHECK_TRIS = 65_536
PASSES = ("primary", "primary shadow", "bounce", "bounce shadow")
# The bench frame's tracers (make_frame_tracers' keys) in PASSES' order,
# each with its hit kind.
FRAME_TRACERS = (("tracer", False), ("shadow_tracer", True), ("bounce_tracer", False),
                 ("shadow_tracer_bounce", True))
TIE_LEAF_WIDTHS = (8, 40, split_trace.LEAFW, 128)
# K5's wider windows (2, 4 and 8 triangles a lane) on the tie fixtures
TIE_LANE_WIDTHS = (24, 40, lane_trace.MAX_LEAFW)
F32_MAX = float(torch.finfo(torch.float32).max)
LIBRARIES = ["split_trace", "lane_trace", "fat_traverse", "micro_probe", "lane_probe",
             "bounce_shade", "lbvh_hierarchy", "wide_collapse", "split_front",
             "instanced_sweep"]
PROBE_MODULES = (micro_pallas, micro_control, probe_lane_machine, probe_lane_machine2,
                 probe_lane_machine3)
PROBE_N_CHECK = 4096
PROBE_ITERS_CHECK = 64
# Published peaks of one H100 SXM: float32 outside the tensor cores, and
# HBM3. Operations per slab test (6 sub, 6 mul, 10 min/max, 3 compares) and
# per Möller-Trumbore test (12 sub/add and 14 mul of the edges and cross
# products, 3 dot products of 5, 3 products by 1/det, 1 divide, 9 compares
# and adds of the accept test), as the kernels compute them. bf16 products
# with float32 sums (the one probe that does them) bound at the tensor
# cores' dense bf16 peak.
# Phase 13: the app's default run (tpu_raytracing/app/args.py:23,34,56,59:
# --type sah, --tracer wide, --bounces 0) at 1024x768 on the 1M scene,
# then the rock asset (scene/genasset.py, 81,922 triangles at 6
# subdivisions). Its images go under out/chip_smoke/ (git-ignored).
APP_W, APP_H = 1024, 768
APP_FRAMES = 2
ROCK_SUBDIVISIONS = 6
NUM_MODES = 9
LODS_MODE = 4
# modes whose colour reads no texture: their images must be opaque
NO_TEXTURE_MODES = (0, 1, 2, 3, 5)
TEXTURED_MODES = (6, 7, 8)
# the rock's modes held between K6 and trace_rays: not the test-count heat
# maps (the two count differently) nor LODS (a log2 floored and times 20)
ROCK_PSNR_MODES = (0, 3, 5, 6, 7, 8)
SPLIT_PSNR_MODES = (0, 8)
OUT_DIR = Path(__file__).resolve().parent / "out" / "chip_smoke"
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
SLAB_OPS = 25
MT_OPS = 61
# Phase 14: the app's animated run (tpu_raytracing/app/main.py:306-369,
# 470-490). The refit schedule on the bucket and SAH split trees at 1M,
# 1024x1024, 1 bounce (frames after frame 0; a periodic rebuild every 3),
# then per-frame rebuilds at 1024x768 in DIFFUSE (mode 5, which draws no
# random numbers), then --interactive on cornell in a pseudo-terminal.
REFIT_RUNS = (("bottom-up", 6), ("sah", 3))
REFIT_INTERVAL = 3
REBUILD_RUNS = (("wide", "sah"), ("wide", "bottom-up"), ("wide", "hybrid"), ("lane", "bottom-up"))
REBUILD_FRAMES = 3
DIFFUSE_MODE = 5
# Phase 15: the app's last two tracers and instancing. The grid frame and
# its checks on phase 3's scene; the app's --tracer grid (--grid-scale 0.5,
# --animate) and --tracer packet at 1024x768; config 4 of
# benchmarks/bench_configs.py:257-380 (sphere_scene(4) as the BLAS, 1,000
# instances from default_rng(3), 512x512).
GRID_SCALE = 0.5
GRID_RESIDUE_AFTER = 8
GRID_SEGMENTS = 4
PACKET_MODES = (0, DIFFUSE_MODE)
INST_COUNT = 1000
INST_RES = 512
INST_SUBDIV = 4
INST_BRUTE_RAYS = 1024
# The BFS tracer's visit caps in phase 16, a multiple of the ray count per
# level: the reference's default (3.0) overflows on the 1M passes, whose
# largest lists need 3.4 (primary) and 4.5 (bounce) times the ray count on
# an H100 (PERF.md), so phase 16 passes these.
BFS_CAP_FACTOR = 6.0
BFS_LEAF_FACTOR = 6.0
# Phase 18: the megakernel and grid legs' frame sides (their tracers are
# PyTorch host loops), and the time a rank of the world of 2 may take.
MULTI_MEGA_RES = 128
MULTI_GRID_RES = 256
MULTI_WORKER_S = 400
# Phase 17: the terrain whose implicit tree K6 is held to plain on (the 1M
# tree's padding-subtree walk makes a plain pass minutes long), at RES/8².
IMPLICIT_CHECK_TRIS = 64_000
# Phase 17: the 8-wide K1 kernels' SASS digest (``k1_8wide_sass``) of the
# build from before the 16-wide inner rows moved to half-warps, and the
# nvcc release that built it; the 8-wide kernels must not change with them.
K1_8WIDE_SASS = ("12.9", "3813c4a2b957331919b2a7395ab3e3673c420accb7a91cfb82ef06df766fedbf")
# Phase 17's entry-distance ties on a 16-wide row: the tied Tri entries,
# and whether the ray origins lie inside every box (distance 0). Entries 7
# and 15 differ only above a 3-bit id; 0 and 8, and 7 and 8, meet at
# different steps of the half-warp reduction; all 16 tie everywhere.
WIDE16_TIES = (((7, 15), False), ((0, 8), False), ((7, 8), False), (tuple(range(16)), True))
# Phase 19: the bounce-shade kernel on phase 3's scene and tree, at the
# benchmark's split cells' bounce count (rtbench/configs/terrain1m-split.json)
# and at phase 3's own; its outputs in bounce_shade's order, rays unpacked.
SHADE_BOUNCES = (8, BOUNCES)
SHADE_FIELDS = ("radiance", "throughput", "alive", "origin", "direction", "tmin", "tmax")
SHADE_REPS = 5
# Phase 21: the split front's kernels in an 8-bounce frame on phase 3's scene
# and tree (rtbench/configs/terrain1m-split.json): a closest-hit and an
# any-hit K1 call for the primary rays and for each bounce.
FRONT_BOUNCES = 8
FRONT_CALLS = 2 * (FRONT_BOUNCES + 1)
FRONT_RECORD_FIELDS = ("hit", "t", "prim_id", "tri_id", "bary_u", "bary_v")
INTERACTIVE_W, INTERACTIVE_H = 256, 192
# Phase 20: BASELINE config 5 as written (rtbench/configs/terrain1m-lbvh-wide.json)
# at an animated frame's time, and the SASS digest (``k6_sass``) of K6's
# closest-hit and counting instantiations with the nvcc release that built
# it: the any-hit instantiation must leave both unchanged.
LBVH_WIDE_BOUNCES = 8
LBVH_WIDE_T = 0.7
K6_SASS = ("12.9", "20a952e6150955da2d9c9501901f9899645bf034fdd9f5ed3e19e28e6da10d5a")
K6_MANGLED = re.compile(r"fat_traverse_kernelILb([01])ELb([01])E")
# Phase 20's collapse checks: CUDA-event repetitions on the 1M tree, the
# caterpillars' depths (one K6's stack covers, two it does not: the second
# past the depth walk's cap) and the animated app run's frames and size.
COLLAPSE_REPS = 10
CATERPILLARS = (30, 70, 5000)
COLLAPSE_APP_FRAMES = 3
COLLAPSE_APP_RES = 256
# Phase 22: BASELINE config 4 on the app's path, at the benchmark's
# instanced cell's sizes (rtbench/configs/instanced1k-split.json) with the
# app's own scene and scatter: 1,000 instances of sphere_scene(6) (81,922
# triangles), 1024x1024, 8 bounces, animated.
INST_APP_COUNT = 1000
INST_APP_SUBDIV = 6
INST_APP_BOUNCES = 8
INST_APP_FRAMES = 3
# the calls (the primary pass and its shadows) on whose items K1 is held to
# its plain version
INST_K1_CALLS = 2
INTERACTIVE_FIRST_S = 180.0
INTERACTIVE_READ_S = 30.0


def demangled(log: str) -> str:
    """ptxas' log with its kernel names demangled by the toolkit's
    cu++filt (beside nvcc), or as it is where that fails."""
    filt = Path(_cuda_build.nvcc_path()).with_name("cu++filt")
    if not filt.is_file():
        return log
    proc = subprocess.run([str(filt)], input=log, capture_output=True, text=True, check=False,
                          timeout=60)
    return proc.stdout if proc.returncode == 0 and proc.stdout.strip() else log


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def aerial_camera(scene, device) -> dict:
    """bench.py:85-91: look down at ~40 degrees from above the terrain."""
    host = cam.initialise_camera(scene.aabb_min, scene.aabb_max)
    host.position = (scene.aabb_max * 0.0).astype("float32")
    host.position[1] = float(scene.aabb_max[1]) * 1.5 + 20.0
    host.position[2] = float(scene.aabb_min[2]) * 0.7
    host.yaw = 0.0
    host.pitch = 0.7
    return cam.camera_to_device(cam.update_camera(host), device)


def sync_ms(t0: float) -> float:
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0


def frame_psnr(a, b) -> float:
    """``utils/compare.py:psnr`` of two radiance frames, each clamped to
    [0, 1] (peak 1)."""
    return psnr(a.clamp(0, 1).cpu().numpy(), b.clamp(0, 1).cpu().numpy(), peak=1.0)


class Capture:
    """Wraps a tracer and keeps the (rays, active) of its last call."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.rays = self.active = None

    def __call__(self, views, packed, rays, active=None):
        self.rays, self.active = rays, active
        return self.tracer(views, packed, rays, active=active)


class PassRecorder:
    """Wraps a tracer: for every call, the launches of ``module``'s kernel
    it made, its overflow flag and its (rays, active)."""

    def __init__(self, tracer, module):
        self.tracer = tracer
        self.module = module
        self.calls = []

    def __call__(self, trav, packed, rays, active=None):
        before = self.module.launch_count
        rec, stats = self.tracer(trav, packed, rays, active=active)
        self.calls.append(dict(launches=self.module.launch_count - before,
                               overflow=stats.overflow, rays=rays, active=active))
        return rec, stats


def bound(ops: float, nbytes: float, bf16_ops: float = 0.0) -> dict:
    """The least time the card could take: the largest of ``ops`` float32
    operations at F32_OPS_PER_S, ``bf16_ops`` tensor-core operations at
    BF16_OPS_PER_S (the two units run side by side) and ``nbytes`` at
    HBM_BYTES_PER_S."""
    ops_ms = max(ops / F32_OPS_PER_S, bf16_ops / BF16_OPS_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def frame_fn(trav, packed, dev_scene, camera, device, **tracers):
    """One 1024x1024 path-traced frame with a given seed and camera jitter."""
    def frame(seed, jitter, pair_loc=None, sort_kind=None):
        cam_j = dict(camera)
        cam_j["position"] = camera["position"] + jitter
        return path_trace(trav, packed, dev_scene, cam_j, RES, RES, num_bounces=BOUNCES,
                          generator=torch.Generator(device=device).manual_seed(seed),
                          pair_loc=pair_loc, sort_kind=sort_kind, **tracers)
    return frame


def timed_frames(frame, **kw):
    """ITERS frames with seeds 1.. after the caller's warm frame: (last
    image, ms per frame, rays traced)."""
    total_rays = 0
    t0 = time.perf_counter()
    for i in range(ITERS):
        img, rays_traced = frame(i + 1, (i + 1) * 1e-4, **kw)
        total_rays += int(rays_traced)
    elapsed_ms = sync_ms(t0)
    return img, elapsed_ms / ITERS, total_rays


def profile_frame(label: str, frame, card: str, **kw) -> None:
    """One more frame under torch.profiler: the device's busy time (the
    union of its kernel intervals) against the frame's wall time, and the
    kernels with the most device time. The profiler's own overhead
    lengthens the wall time, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame(ITERS + 1, (ITERS + 1) * 1e-4, **kw)
        wall_ms = sync_ms(t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1000.0, n + 1)
    busy_ms = busy_us / 1000.0
    print(f"  {label} profiled frame: {wall_ms!r} ms wall, {busy_ms!r} ms device busy "
          f"({len(kernels)} device events, {100.0 * busy_ms / wall_ms:.1f}% busy)  [{card}]")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {ms:9.3f} ms {n:5d}x  {name[:100]}")


def split_path(device, card: str, scene, dev_scene, camera, triangles) -> dict:
    """Phase 3: the bench frame end to end."""
    torch.cuda.reset_peak_memory_stats()

    def build(tris):
        return bucket.emit_split_views(bucket.split_front(tris, True),
                                       leaf_width=split_trace.LEAFW)

    front = bucket.split_front(triangles, True)
    views, packed, split = bucket.emit_split_views(front, leaf_width=split_trace.LEAFW)
    bucket.check_split_capacity(split, scene.num_triangles)
    require(split.leaf_width == split_trace.LEAFW, "build/trace leaf width mismatch")
    build(triangles)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ITERS):
        build(triangles + (i + 1) * 1e-5)
    rebuild_ms = sync_ms(t0) / ITERS

    def deform_refit(s, rows, d):
        v = i2f(rows[:, :12]) + d
        return bucket.refit_split(s, PackedPairs(rows=torch.cat([f2i(v), rows[:, 12:]], dim=1)))

    deform_refit(split, packed.rows, 0.0)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ITERS):
        deform_refit(split, packed.rows, (i + 1) * 1e-4)
    refit_ms = sync_ms(t0) / ITERS

    # the bucket tree's tid bounce sort (bench.py:361-378)
    treelet.build_pair_tid(front)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        pair_loc = treelet.build_pair_tid(front)
    pair_tid_ms = sync_ms(t0) / ITERS

    tracers = split_trace.make_frame_tracers(RES, RES)
    captured = {k: Capture(v) for k, v in tracers.items()}
    split_trace.launch_count = 0
    split_trace.operands_launch_count = 0
    traverse.launch_count = 0
    pathtrace.launch_count = 0
    frame = frame_fn(views, packed, dev_scene, camera, device, **captured)
    frame(0, 0.0, pair_loc=pair_loc)
    torch.cuda.synchronize()
    ttff_s = time.perf_counter() - T_PROCESS0
    img, frame_ms, total_rays = timed_frames(frame, pair_loc=pair_loc)
    launches = split_trace.launch_count
    front_launches = (split_trace.operands_launch_count, traverse.launch_count)
    shade_launches = pathtrace.launch_count
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    require(launches >= 4 * (ITERS + 1),
            f"K1 launched {launches} times in {ITERS + 1} frames (< 4 per frame)")
    require(front_launches == (launches, launches),
            f"the split front's operand and record kernels launched {front_launches} times "
            f"in {ITERS + 1} frames, not once for each of K1's {launches} launches")
    require(shade_launches == (ITERS + 1) * (BOUNCES + 1),
            f"the bounce-shade kernel launched {shade_launches} times in {ITERS + 1} "
            f"{BOUNCES}-bounce frames (not {(ITERS + 1) * (BOUNCES + 1)})")
    require(bool(torch.isfinite(img).all()), "frame has non-finite pixels")
    mean = float(img.mean())
    require(mean > 0.0, f"frame mean {mean} is not positive")
    _, leaf_ms, _ = timed_frames(frame_fn(views, packed, dev_scene, camera, device, **tracers),
                                 sort_kind="leaf")
    profile_frame("bench", frame_fn(views, packed, dev_scene, camera, device, **tracers), card,
                  pair_loc=pair_loc)
    out = dict(rebuild_ms=rebuild_ms, refit_ms=refit_ms, pair_tid_ms=pair_tid_ms,
               frame_ms=frame_ms, mrays_per_s=total_rays / (frame_ms * ITERS) / 1000.0,
               time_to_first_frame_s=ttff_s, peak_mem_mib=peak_mib,
               leaf_sort_frame_ms=leaf_ms)
    print(f"phase 3: {scene.num_triangles} tris, {int(split.num_inner)} inner rows, "
          f"{RES}x{RES}, {BOUNCES} bounce, tid bounce sort, image mean {mean:.6f}, "
          f"{total_rays} rays in {ITERS} frames")
    for key, val in out.items():
        print(f"  {key} = {val!r}  [{card}]")
    print(f"  K1 launches in {ITERS + 1} main-path frames = {launches}")
    print(f"  bounce-shade launches in {ITERS + 1} main-path frames = {shade_launches}")
    print(f"  split front operand and record launches in {ITERS + 1} main-path frames = "
          f"{front_launches[0]}, {front_launches[1]}")
    return dict(front=front, views=views, packed=packed, captured=captured, launches=launches,
                shade_launches=shade_launches, front_launches=front_launches, img=img,
                pair_loc=pair_loc, **out)


class ShadeCapture:
    """Stands in for ``pathtrace.bounce_shade`` while entered: keeps each
    call's positional arguments and passes the call on."""

    def __init__(self):
        self.real = pathtrace.bounce_shade
        self.calls = []

    def __enter__(self):
        pathtrace.bounce_shade = self
        return self

    def __exit__(self, *exc):
        pathtrace.bounce_shade = self.real

    def __call__(self, *args, sample_next=True, **kw):
        self.calls.append(args)
        return self.real(*args, sample_next=sample_next, **kw)


def shade_outputs(out) -> tuple:
    rad, thr, alive, rays = out
    return rad, thr, alive, rays.origin, rays.direction, rays.tmin, rays.tmax


def shade_mismatches(kout, pout) -> dict:
    """Outputs on which the bounce-shade kernel and its plain version
    differ: output -> (elements, largest difference in units in the last
    place); floats compared bit for bit."""
    bad = {}
    for name, k, p in zip(SHADE_FIELDS, shade_outputs(kout), shade_outputs(pout)):
        if k.dtype == torch.bool:
            n, ulp = int((k != p).sum()), 0
        else:
            ki = k.contiguous().view(torch.int32).to(torch.int64)
            pi = p.contiguous().view(torch.int32).to(torch.int64)
            n = int((ki != pi).sum())
            ulp = int((ki - pi).abs().max()) if n else 0
        if n:
            bad[name] = (n, ulp)
    return bad


def shade_bytes(num: int, hits: int, sample_next: bool) -> int:
    """Bytes one bounce-shade launch must move for ``num`` rays of which
    ``hits`` name a triangle: for every ray, in, the ray (24 B), the hit
    record (21 B), the shadow verdict, throughput, radiance and alive; out,
    radiance and alive; with ``sample_next`` also the pixel and its two
    uniforms in, the throughput and the next ray (32 B) out. For each hit,
    its gathers: one word of the pair's row, the primitive's corner normals
    (36 B) and its material id. A ray without a hit names triangle 0
    (trace/traverse.py:reconstruct), which every such ray shares, so its
    gathers move no bytes of their own."""
    per_ray = 24 + 21 + 1 + 12 + 12 + 1 + 12 + 1
    if sample_next:
        per_ray += 8 + 8 + 12 + 32
    return num * per_ray + hits * (4 + 36 + 4)


def kernel_device_ms(calls, kernel: str) -> list:
    """A kernel's device time in ms, from torch.profiler's trace: each of
    ``calls`` (functions that each launch the kernel named ``kernel`` once)
    is called once to warm and then SHADE_REPS times; returns the mean
    device time of each call's kernels, in order. Each call has a session
    of its own, with a tensor update before and after its launches, and up
    to three tries: a full smoke run's session over every call once saw 75
    of 90 sweep launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")
    out = []
    for c, fn in enumerate(calls):
        for attempt in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                pad.add_(1.0)
                torch.cuda.synchronize()
                for _ in range(SHADE_REPS):
                    fn()
                torch.cuda.synchronize()
                pad.add_(1.0)
                torch.cuda.synchronize()
            us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA and kernel in e.name]
            if len(us) == SHADE_REPS:
                break
            print(f"    the profiler saw {len(us)} {kernel} launches of call {c}'s "
                  f"{SHADE_REPS} (try {attempt + 1})")
        require(len(us) == SHADE_REPS,
                f"the profiler saw {len(us)} {kernel} launches of call {c}, not {SHADE_REPS}")
        out.append(sum(us) / SHADE_REPS / 1000.0)
    return out


class BaselineShade:
    """An earlier ``csrc/bounce_shade.cu`` with the one-level launch (no
    instance arguments: 27 pointers, the constants, 6 ints, the stream),
    built beside the current one and called like ``pathtrace.bounce_shade``
    on a one-level record."""

    NAME = "bounce_shade_baseline"
    ARGTYPES = ([ctypes.c_void_p] * 27 + [ctypes.POINTER(ctypes.c_float)]
                + [ctypes.c_int] * 6 + [ctypes.c_void_p])

    def __init__(self, source: Path):
        self.source = source

    def __call__(self, scene, pairs, rays, rec, srec_hit, throughput, radiance, alive, pixel,
                 u_frame, max_t, sample_next=True, normal_maps=None):
        require(normal_maps is None, "the baseline bounce-shade kernel shades one level only")
        dev = rays.origin.device
        max_t = torch.as_tensor(max_t, dtype=torch.float32, device=dev).reshape(-1)
        fn = _cuda_build.load_library(self.NAME, self.source).bounce_shade_launch
        fn.argtypes = self.ARGTYPES
        fn.restype = ctypes.c_int
        num = pixel.shape[0]
        rad_out, alive_out = torch.empty_like(radiance), torch.empty_like(alive)
        thr_out, new = throughput, rays
        outs = (None,) * 5
        if sample_next:
            thr_out = torch.empty_like(throughput)
            new = Rays(origin=torch.empty_like(rays.origin),
                       direction=torch.empty_like(rays.direction),
                       tmin=torch.empty((num,), dtype=torch.float32, device=dev),
                       tmax=torch.empty((num,), dtype=torch.float32, device=dev))
            outs = (thr_out.data_ptr(), new.origin.data_ptr(), new.direction.data_ptr(),
                    new.tmin.data_ptr(), new.tmax.data_ptr())
        err = fn(rays.origin.data_ptr(), rays.direction.data_ptr(), rec.hit.data_ptr(),
                 rec.t.data_ptr(), rec.prim_id.data_ptr(), rec.tri_id.data_ptr(),
                 rec.bary_u.data_ptr(), rec.bary_v.data_ptr(), srec_hit.data_ptr(),
                 throughput.data_ptr(), radiance.data_ptr(), alive.data_ptr(),
                 pixel.data_ptr(), u_frame.data_ptr(), max_t.data_ptr(), pairs.rows.data_ptr(),
                 scene.normals.data_ptr(), scene.material_ids.data_ptr(),
                 scene.materials.diffuse.data_ptr(), scene.light.data_ptr(),
                 rad_out.data_ptr(), alive_out.data_ptr(), *outs, pathtrace._SHADE_CONSTS,
                 num, u_frame.shape[0], pairs.rows.shape[0], scene.normals.shape[0],
                 scene.materials.diffuse.shape[0], int(sample_next),
                 torch.cuda.current_stream(dev).cuda_stream)
        require(err == 0, f"the baseline bounce-shade kernel's launch failed: cudaError {err}")
        return rad_out, thr_out, alive_out, new


def shade_checks(device, card: str, split: dict, dev_scene, camera, baseline=None) -> dict:
    """Phase 19: the bounce-shade kernel on phase 3's scene, tree, tracers
    and tid sort, at SHADE_BOUNCES. A frame must launch it once a bounce
    and once more, and match the frame with the plain version in its place
    bit for bit; on every call's captured inputs, with both sample_next
    values and every ray (the dead ones at the back too), the kernel must
    match the plain version bit for bit. Each launch, as the frame made
    it, is timed on the device by the profiler (kernel_device_ms) against
    its bytes bound; the wrapper's call and the plain version by CUDA
    events (5 after a warm one; the plain version 3). With ``baseline`` (a
    ``BaselineShade``), the earlier kernel must match the current one bit
    for bit on every call, and is timed beside it. Returns the
    benchmark's frame (the first count) for the kernels line, with the
    launches of phase 3's frames and of this phase's captured frames."""
    print("phase 19: the bounce-shade kernel against its plain version on phase 3's frame")
    tracers = split_trace.make_frame_tracers(RES, RES)
    out = None
    launches_all = split["shade_launches"]
    for bounces in SHADE_BOUNCES:
        def frame(seed):
            return path_trace(split["views"], split["packed"], dev_scene, camera, RES, RES,
                              num_bounces=bounces,
                              generator=torch.Generator(device=device).manual_seed(seed),
                              pair_loc=split["pair_loc"], **tracers)

        frame(ITERS + 2)  # warm
        pathtrace.launch_count = 0
        with ShadeCapture() as cap:
            img, rays_traced = frame(ITERS + 3)
            torch.cuda.synchronize()
        launches = pathtrace.launch_count
        launches_all += launches
        require(launches == len(cap.calls) == bounces + 1,
                f"a {bounces}-bounce frame launched the bounce-shade kernel {launches} times "
                f"in {len(cap.calls)} calls (not {bounces + 1})")
        real = pathtrace.bounce_shade
        pathtrace.bounce_shade = pathtrace.bounce_shade_plain
        try:
            plain_img, plain_rays = frame(ITERS + 3)
        finally:
            pathtrace.bounce_shade = real
        differ = int((img.view(torch.int32) != plain_img.view(torch.int32)).sum())
        require(differ == 0 and int(rays_traced) == int(plain_rays),
                f"{bounces}-bounce frame: {differ} image words differ from the plain "
                f"version's frame, rays {int(rays_traced)} against {int(plain_rays)}")
        print(f"  {bounces}-bounce frame: {launches} launches, image and {int(rays_traced)} "
              f"rays bit-equal to the frame with the plain version")
        as_launched = []
        for b, args in enumerate(cap.calls):
            for sample_next in (b < bounces, b >= bounces):
                kout = pathtrace.bounce_shade(*args, sample_next=sample_next)
                pout = pathtrace.bounce_shade_plain(*args, sample_next=sample_next)
                bad = shade_mismatches(kout, pout)
                require(not bad, f"{bounces}-bounce frame, bounce {b}, sample_next="
                                 f"{int(sample_next)}: kernel and plain differ "
                                 f"(elements, largest ulp): {bad}")
                if baseline is not None:
                    bad = shade_mismatches(kout, baseline(*args, sample_next=sample_next))
                    require(not bad, f"{bounces}-bounce frame, bounce {b}, sample_next="
                                     f"{int(sample_next)}: kernel and {baseline.source} "
                                     f"differ (elements, largest ulp): {bad}")
            as_launched.append(functools.partial(pathtrace.bounce_shade, *args,
                                                 sample_next=b < bounces))
        device_ms = kernel_device_ms(as_launched, "bounce_shade_kernel")
        if baseline is not None:
            base_ms = kernel_device_ms(
                [functools.partial(baseline, *args, sample_next=b < bounces)
                 for b, args in enumerate(cap.calls)], "bounce_shade_kernel")
            print(f"  {bounces}-bounce frame: kernel {sum(device_ms)!r} ms a frame on the "
                  f"device, {baseline.source} {sum(base_ms)!r} ms; bit-equal on every call "
                  f"and both sample_next values  [{card}]")
        k_ms = call_ms = p_ms = nbytes = 0.0
        for b, (args, fn, ms) in enumerate(zip(cap.calls, as_launched, device_ms)):
            num, alive_in, sample_next = args[8].shape[0], int(args[7].sum()), b < bounces
            hits = int(args[3].hit.sum())
            c_ms, _ = event_ms(fn, 5)
            plain_ms, _ = event_ms(
                functools.partial(pathtrace.bounce_shade_plain, *args, sample_next=sample_next), 3)
            nb = shade_bytes(num, hits, sample_next)
            k_ms, call_ms, p_ms, nbytes = k_ms + ms, call_ms + c_ms, p_ms + plain_ms, nbytes + nb
            print(f"    bounce {b}: {num} rays ({alive_in} alive on entry, {hits} hits), "
                  f"sample_next={int(sample_next)}: kernel {ms!r} ms on the device, bound "
                  f"{bound(0.0, nb)['bound_ms']!r} ms ({nb} bytes), call {c_ms!r} ms, plain "
                  f"{plain_ms!r} ms; both sample_next values bit-equal to plain  [{card}]")
        # the arithmetic, a few hundred operations a ray, bounds far below the bytes
        b = bound(0.0, nbytes)
        print(f"  {bounces}-bounce frame: kernel {k_ms!r} ms a frame on the device, bound "
              f"{b['bound_ms']!r} ms ({b['bound_by']}), calls {call_ms!r} ms, plain {p_ms!r} ms"
              f"  [{card}]")
        if out is None:
            out = dict(ms=k_ms, call_ms=call_ms, plain_ms=p_ms, max_abs_err=0.0, **b)
    print(f"  bounce-shade launches in phase 3's and this phase's main-path frames = "
          f"{launches_all}")
    return dict(out, launches=launches_all)


class FrontCapture:
    """Stands in for ``split_trace.kernel_operands`` and the
    ``reconstruct`` that ``trace_rays_split`` calls while entered: keeps
    each call's arguments and passes the call on."""

    def __init__(self):
        self.real = (split_trace.kernel_operands, split_trace.reconstruct)
        self.operands, self.records = [], []

    def __enter__(self):
        split_trace.kernel_operands, split_trace.reconstruct = self.take_operands, self.record
        return self

    def __exit__(self, *exc):
        split_trace.kernel_operands, split_trace.reconstruct = self.real

    def take_operands(self, rays, active=None):
        self.operands.append((rays, active))
        return self.real[0](rays, active)

    def record(self, pairs, rays, t, tri, any_hit=False):
        self.records.append((pairs, rays, t, tri, any_hit))
        return self.real[1](pairs, rays, t, tri, any_hit=any_hit)


@contextlib.contextmanager
def plain_front():
    """``trace_rays_split`` with the plain versions of its glue."""
    real = (split_trace.kernel_operands, split_trace.reconstruct)
    split_trace.kernel_operands = split_trace.kernel_operands_plain
    split_trace.reconstruct = traverse.reconstruct_plain
    try:
        yield
    finally:
        split_trace.kernel_operands, split_trace.reconstruct = real


def differing_bits(a, b) -> int:
    """Elements of two same-shaped tensors whose bits differ (floats as
    int32 words); a dtype or shape mismatch counts every element."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return max(a.numel(), b.numel(), 1)
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return int((a != b).sum())


def operands_bytes(num: int, masked: bool) -> int:
    """Bytes one operand launch must move: the direction, tmin and tmax (20
    B a ray) in and out, and the active mask in."""
    return num * (2 * 20 + int(masked))


def record_bytes(tri, hit) -> int:
    """Bytes one record launch must move: t and tri in and the record (21
    B) out for every ray; a miss reads its tmax, a hit its origin and
    direction (24 B); each pair row a hit names (64 B), once."""
    num, hits = tri.shape[0], int(hit.sum())
    rows = int(torch.unique(tri[hit] >> 1).numel())
    return num * (8 + 21) + (num - hits) * 4 + hits * 24 + rows * 64


def front_checks(device, card: str, split: dict, dev_scene, camera) -> dict:
    """Phase 21: the split front's two kernels (csrc/split_front.cu) on
    phase 3's scene, tree, tracers and tid sort, in a FRONT_BOUNCES-bounce
    frame: each must launch once a K1 call, the frame must match the frame
    with the plain glue bit for bit, and on every call's captured operands
    each kernel must match its plain version bit for bit. Each launch, as
    the frame made it, is timed on the device by the profiler
    (kernel_device_ms) against its bytes bound; the wrapper's call and the
    plain version by CUDA events (5 after a warm one; the plain version 3).
    Returns the kernels line's entries, with the launches of phase 3's
    frames and of this phase's captured frame."""
    print("phase 21: the split front's kernels against their plain versions on an "
          f"{FRONT_BOUNCES}-bounce frame of phase 3's scene")
    k1_sass_check()
    tracers = split_trace.make_frame_tracers(RES, RES)

    def frame(seed):
        return path_trace(split["views"], split["packed"], dev_scene, camera, RES, RES,
                          num_bounces=FRONT_BOUNCES,
                          generator=torch.Generator(device=device).manual_seed(seed),
                          pair_loc=split["pair_loc"], **tracers)

    frame(ITERS + 4)  # warm
    split_trace.launch_count = split_trace.operands_launch_count = traverse.launch_count = 0
    with FrontCapture() as cap:
        img, rays_traced = frame(ITERS + 5)
        torch.cuda.synchronize()
    counts = (split_trace.launch_count, split_trace.operands_launch_count, traverse.launch_count,
              len(cap.operands), len(cap.records))
    require(counts == (FRONT_CALLS,) * 5,
            f"a {FRONT_BOUNCES}-bounce frame: K1, operand and record launches and captured "
            f"operand and record calls {counts}, not {FRONT_CALLS} each")
    any_hits = sum(int(r[4]) for r in cap.records)
    require(any_hits == FRONT_CALLS // 2, f"{any_hits} any-hit records of {FRONT_CALLS}")
    with plain_front():
        plain_img, plain_rays = frame(ITERS + 5)
    differ = differing_bits(img, plain_img)
    require(differ == 0 and int(rays_traced) == int(plain_rays),
            f"{FRONT_BOUNCES}-bounce frame: {differ} image words differ from the plain-glue "
            f"frame's, rays {int(rays_traced)} against {int(plain_rays)}")
    print(f"  {FRONT_BOUNCES}-bounce frame: {FRONT_CALLS} launches of each kernel, image and "
          f"{int(rays_traced)} rays bit-equal to the frame with the plain glue")

    for c, (rays, active) in enumerate(cap.operands):
        kout = split_trace.kernel_operands(rays, active)
        pout = split_trace.kernel_operands_plain(rays, active)
        bad = {n: differing_bits(k, p) for n, k, p in zip(("origin", "direction", "tmin", "tmax"),
                                                          kout, pout)}
        require(not any(bad.values()), f"call {c}: the operand kernel and its plain version "
                                       f"differ (elements): {bad}")
    for c, (pairs, rays, t, tri, any_hit) in enumerate(cap.records):
        kout = traverse.reconstruct(pairs, rays, t, tri, any_hit=any_hit)
        pout = traverse.reconstruct_plain(pairs, rays, t, tri, any_hit=any_hit)
        bad = {n: differing_bits(getattr(kout, n), getattr(pout, n))
               for n in FRONT_RECORD_FIELDS}
        require(not any(bad.values()), f"call {c} (any_hit={any_hit}): the record kernel and "
                                       f"its plain version differ (elements): {bad}")
    print(f"  every ray of all {FRONT_CALLS} calls: both kernels bit-equal to their plain "
          f"versions on every output")

    # per kernel: its calls' arguments, the kernel's and the plain version's
    # call on them, and the bytes and rays of a call
    kernels = (
        ("operands", "split_operands_kernel", cap.operands,
         lambda a: functools.partial(split_trace.kernel_operands, *a),
         lambda a: functools.partial(split_trace.kernel_operands_plain, *a),
         lambda a: (operands_bytes(a[0].origin.shape[0], a[1] is not None),
                    a[0].origin.shape[0])),
        ("record", "split_record_kernel", cap.records,
         lambda a: functools.partial(traverse.reconstruct, *a[:4], any_hit=a[4]),
         lambda a: functools.partial(traverse.reconstruct_plain, *a[:4], any_hit=a[4]),
         lambda a: (record_bytes(a[3], traverse.reconstruct_plain(*a[:4], any_hit=a[4]).hit),
                    a[1].origin.shape[0])),
    )
    out = {}
    for label, name, calls, launch, plain, size in kernels:
        device_ms = kernel_device_ms([launch(a) for a in calls], name)
        k_ms = call_ms = p_ms = total = 0.0
        for c, (args, ms) in enumerate(zip(calls, device_ms)):
            c_ms, _ = event_ms(launch(args), 5)
            plain_ms, _ = event_ms(plain(args), 3)
            nb, num = size(args)
            k_ms, call_ms, p_ms, total = k_ms + ms, call_ms + c_ms, p_ms + plain_ms, total + nb
            print(f"    {label} call {c} ({num} rays): kernel {ms!r} ms on the device, bound "
                  f"{bound(0.0, nb)['bound_ms']!r} ms ({nb} bytes), call {c_ms!r} ms, plain "
                  f"{plain_ms!r} ms  [{card}]")
        # a few dozen operations a ray: the bytes bound
        b = bound(0.0, total)
        launches = split["front_launches"][0 if label == "operands" else 1] + FRONT_CALLS
        print(f"  {label} kernel: {k_ms!r} ms an {FRONT_BOUNCES}-bounce frame on the device, "
              f"bound {b['bound_ms']!r} ms ({b['bound_by']}), calls {call_ms!r} ms, plain "
              f"{p_ms!r} ms; {launches} launches in phase 3's and this phase's main-path "
              f"frames  [{card}]")
        out[label] = dict(ms=k_ms, call_ms=call_ms, plain_ms=p_ms, max_abs_err=0.0,
                          launches=launches, **b)
    return out


def k1_mismatches(kout, pout) -> dict:
    """Rays on which K1 and its plain version differ, per output (t bit for
    bit), and whether their overflow flags differ."""
    kt, ktri, kip, klp, kov = kout
    pt, ptri, pip, plp, pov = pout
    return {
        "hit": int(((ktri >= 0) != (ptri >= 0)).sum()),
        "tri": int((ktri != ptri).sum()),
        "inner_pops": int((kip != pip).sum()),
        "leaf_pops": int((klp != plp).sum()),
        "t": int((kt.view(torch.int32) != pt.view(torch.int32)).sum()),
        "overflow": int(int(kov) != int(pov)),
    }


class Agreement:
    """Running K1-vs-plain comparison totals: every check must agree on
    every output of every ray."""

    def __init__(self):
        self.max_abs_err = 0.0

    def check(self, label, views, rays, active, any_hit, leafw=split_trace.LEAFW) -> int:
        inner, pairs, stack_cap = views
        ops = split_trace.kernel_operands(rays, active)
        kw = dict(leafw=leafw, any_hit=any_hit, stack_cap=stack_cap)
        kout = split_trace.split_traverse(inner, pairs, *ops, **kw)
        pout = split_trace.trace_split_plain(inner, pairs, *ops, **kw)
        torch.cuda.synchronize()
        num = kout[0].shape[0]
        bad = k1_mismatches(kout, pout)
        if num:
            self.max_abs_err = max(self.max_abs_err, float((kout[0] - pout[0]).abs().max()))
        hits = int((kout[1] >= 0).sum())
        print(f"  {label:<34} any_hit={int(any_hit)} rays={num:>7} hits={hits:>7} "
              f"mismatches={bad} overflow={int(kout[4])}/{int(pout[4])}")
        require(sum(bad.values()) == 0, f"{label}: K1 and plain disagree: {bad}")
        require(int(kout[4]) == int(pout[4]) == 0, f"{label}: stack overflow")
        return hits


def fixture_rays(scene, device, rng) -> dict:
    """Camera, axis-aligned, random and half-dead ray sets for a fixture."""
    lo, hi = scene.aabb_min.astype(np.float64), scene.aabb_max.astype(np.float64)
    camera = cam.camera_to_device(
        cam.update_camera(cam.initialise_camera(scene.aabb_min, scene.aabb_max)), device)
    primary = generate_primary_rays(camera, 64, 64)
    n = 16
    gx, gz = np.meshgrid(np.linspace(lo[0] + 1e-3, hi[0] - 1e-3, n),
                         np.linspace(lo[2] + 1e-3, hi[2] - 1e-3, n))
    down_o = np.stack([gx.ravel(), np.full(n * n, hi[1] + 1.0), gz.ravel()], 1)
    gy, gz2 = np.meshgrid(np.linspace(lo[1] + 1e-3, hi[1] - 1e-3, n),
                          np.linspace(lo[2] + 1e-3, hi[2] - 1e-3, n))
    side_o = np.stack([np.full(n * n, lo[0] - 1.0), gy.ravel(), gz2.ravel()], 1)
    axis_o = np.concatenate([down_o, side_o])
    axis_d = np.concatenate([np.tile([0.0, -1.0, 0.0], (n * n, 1)),
                             np.tile([1.0, 0.0, 0.0], (n * n, 1))])
    m = 4096
    rand_o = lo + (hi - lo) * rng.random((m, 3))
    rand_d = rng.normal(size=(m, 3))
    rand_d /= np.linalg.norm(rand_d, axis=1, keepdims=True)

    def rays(o, d):
        k = o.shape[0]
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        return Rays(f(o), f(d), f(np.zeros(k)), f(np.full(k, 1e6)))

    half_dead = torch.as_tensor(rng.random(64 * 64) < 0.5, device=device)
    return {"camera": (primary, None), "axis-aligned": (rays(axis_o, axis_d), None),
            "random": (rays(rand_o, rand_d), None), "half-dead": (primary, half_dead)}


def sample_idx(live: torch.Tensor, size: int = SLICE) -> torch.Tensor:
    """Up to ``size`` live positions, evenly spaced over the live ones."""
    idx = torch.nonzero(live).reshape(-1)
    if idx.shape[0] <= size:
        return idx
    return idx[torch.linspace(0, idx.shape[0] - 1, size, device=idx.device).round().long()]


def live_sample(rays: Rays, active, size: int = SLICE):
    """Up to ``size`` live rays of a pass, evenly spaced over the live ones
    in the pass's own order; returns (rays, number of live rays)."""
    if active is None:
        active = torch.ones(rays.origin.shape[0], dtype=torch.bool, device=rays.origin.device)
    return rays.take(sample_idx(active, size)), int(active.sum())


def event_ms(fn, reps, warm: bool = True):
    """Mean CUDA-event time of ``reps`` calls (after one warm call)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def pass_operands(key: str, cap: Capture):
    """K1's operands for one pass of the bench frame, in the order the
    frame's tracer hands them over (16 x K/16 screen tiles for the primary
    passes, the caller's sorted order for the bounce passes), and the live
    mask in that order."""
    rays, active = cap.rays, cap.active
    if key in ("tracer", "shadow_tracer"):
        tw, th = 16, split_trace.K // 16
        rays = Rays(*(tile_reorder(getattr(rays, f), RES, RES, tw, th)
                      for f in ("origin", "direction", "tmin", "tmax")))
        active = None if active is None else tile_reorder(active, RES, RES, tw, th)
    if active is None:
        active = torch.ones(rays.origin.shape[0], dtype=torch.bool, device=rays.origin.device)
    return split_trace.kernel_operands(rays, active), active


def k1_pass(label: str, views, ops, any_hit: bool, card: str, start=None) -> dict:
    """K1 on one whole pass as its tracer launched it (from ``start`` tags
    or from the root): CUDA-event ms (mean of 5 launches after a warm
    one), bit-equal to the plain version on every ray, the bound from the
    plain version's counts and visited rows, the mean inner and leaf pops
    per live ray (tmax > tmin), and the plain version's ms (it marks the
    visited rows too)."""
    inner, pairs, stack_cap = views
    w = inner.shape[1]
    kw = dict(leafw=split_trace.LEAFW, stack_cap=stack_cap, any_hit=any_hit, start=start)
    ms, kout = event_ms(lambda: split_trace.split_traverse(inner, pairs, *ops, **kw), 5)
    visited = {}
    t0 = time.perf_counter()
    pout = split_trace.trace_split_plain(inner, pairs, *ops, **kw, visited=visited)
    plain_ms = sync_ms(t0)
    bad = k1_mismatches(kout, pout)
    require(sum(bad.values()) == 0 and int(kout[4]) == 0,
            f"{label}: K1 and plain disagree ({bad}) or overflow {int(kout[4])}")
    # bound: every inner pop tests w boxes, every leaf pop 2 * LEAFW
    # triangles; rays in (32 B, and a 4 B start tag), results out (16 B),
    # each inner row (w * 32 B) and pair row (64 B) visited once
    num = ops[0].shape[0]
    live = ops[3] > ops[2]
    n_inner, n_pairs = int(visited["inner"].sum()), int(visited["pairs"].sum())
    n_ops = (float(kout[2].sum()) * w * SLAB_OPS
             + float(kout[3].sum()) * 2 * split_trace.LEAFW * MT_OPS)
    nbytes = num * (32 + 16 + (0 if start is None else 4)) + n_inner * w * 32 + n_pairs * 64
    b = bound(n_ops, nbytes)
    ipops = float(kout[2][live].float().mean())
    lpops = float(kout[3][live].float().mean())
    print(f"  {label}: {num} rays ({int(live.sum())} live), any_hit={int(any_hit)}: "
          f"K1 {ms!r} ms, bound {b['bound_ms']!r} ms ({b['bound_by']}; {n_ops:.4g} ops, "
          f"{nbytes} bytes: {n_inner} inner rows, {n_pairs} pair rows); pops per live ray "
          f"inner {ipops!r} leaf {lpops!r}; bit-equal to plain ({plain_ms!r} ms with the row "
          f"marking)  [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, inner_pops=ipops, leaf_pops=lpops,
                max_abs_err=float((kout[0] - pout[0]).abs().max()) if num else 0.0, **b)


def time_passes(views, captured: dict, card: str, label: str = "1M") -> dict:
    """K1 on each of a frame's four passes, as the frame launches it
    (``k1_pass``). Then the plain version is timed on the bounce pass (one
    run). Returns the bounce pass's numbers, which stand for K1 in the
    kernels line, and each pass's."""
    inner, pairs, stack_cap = views
    out = {name: k1_pass(f"{label} {name} pass", views,
                         pass_operands(key, captured[key])[0], any_hit, card)
           for (key, any_hit), name in zip(FRAME_TRACERS, PASSES)}
    print(f"  K1 on the four passes: {sum(r['ms'] for r in out.values())!r} ms a frame  "
          f"[{card}]")
    ops, _ = pass_operands("bounce_tracer", captured["bounce_tracer"])
    plain_ms, _ = event_ms(
        lambda: split_trace.trace_split_plain(inner, pairs, *ops, any_hit=False,
                                              leafw=split_trace.LEAFW, stack_cap=stack_cap), 1,
        warm=False)
    print(f"  plain version on the {label} bounce pass: {plain_ms!r} ms  [{card}]")
    return dict(out["bounce"], plain_ms=plain_ms, passes=out)


def tie_fixtures(device, agree: Agreement, rng) -> None:
    """K1 against its plain version where windows hold exact t ties: every
    triangle of terrain(32) (one 64-pair window) and of soup(2000) twice,
    pairs off and on, closest-hit and any-hit, at LEAFW and at the leaf
    widths 8, 40 and 128 (lanes past the window, four slots a lane). The
    "unbounded" rays have tmax = F32_MAX, so a window they enter and miss
    still names its all-miss slot, 2 * leafw - 1."""
    for name, base in (("terrain32x2", procedural.terrain(32)),
                       ("soup2000x2", procedural.random_triangle_soup(2000, seed=1))):
        scene = dataclasses.replace(base, triangles=np.repeat(base.triangles, 2, axis=0))
        tris = torch.as_tensor(scene.triangles, device=device)
        sets = fixture_rays(scene, device, rng)
        rays = sets["random"][0]
        sets["unbounded"] = (Rays(rays.origin, rays.direction, rays.tmin,
                                  torch.full_like(rays.tmax, F32_MAX)), None)
        for pairs in (False, True):
            front = bucket.split_front(tris, pairs)
            for leafw in TIE_LEAF_WIDTHS:
                views, _, _ = bucket.emit_split_views(front, leaf_width=leafw)
                for set_name, (rays, active) in sets.items():
                    if leafw != split_trace.LEAFW and set_name not in ("random", "unbounded"):
                        continue
                    for any_hit in (False, True):
                        agree.check(f"{name} pairs={int(pairs)} leafw={leafw} {set_name}",
                                    views, rays, active, any_hit, leafw=leafw)


def k1_checks(device, card: str, split: dict) -> dict:
    """Phase 4."""
    print("phase 4: K1 against its plain version on the card")
    agree = Agreement()
    rng = np.random.default_rng(0)
    for name, scene in (("sphere", procedural.sphere_scene(3)),
                        ("soup2000", procedural.random_triangle_soup(2000, seed=1))):
        tris = torch.as_tensor(scene.triangles, device=device)
        for pairs in (False, True):
            views, _, _ = bucket.emit_split_views(bucket.split_front(tris, pairs),
                                                  leaf_width=split_trace.LEAFW)
            for set_name, (rays, active) in fixture_rays(scene, device, rng).items():
                for any_hit in (False, True):
                    agree.check(f"{name} pairs={int(pairs)} {set_name}", views, rays, active,
                                any_hit)
    cap = split["captured"]
    for key, any_hit in FRAME_TRACERS:
        rays, n_live = live_sample(cap[key].rays, cap[key].active)
        print(f"  terrain1M {key}: {rays.origin.shape[0]} of {n_live} live rays")
        hits = agree.check(f"terrain1M {key}", split["views"], rays, None, any_hit)
        require(hits > 0, f"terrain1M {key}: no ray of the sample hits, so it checks nothing")
    tie_fixtures(device, agree, rng)
    timing = time_passes(split["views"], cap, card)
    print(f"  K1 launch count after the comparisons = {split_trace.launch_count} "
          f"(main path: {split['launches']})")
    return dict(timing, max_abs_err=agree.max_abs_err)


def same_split(a, b) -> dict:
    """Words on which two SAH split trees differ: the inner rows' integer
    words (meta, pad) and e_ranges bit for bit, their box words as floats
    (so -0.0 == +0.0), the sorted pair rows bit for bit, and the counts."""
    (sa, pa), (sb, pb) = a, b
    ia, ib = sa.inner.cpu().reshape(-1, 8), sb.inner.cpu().reshape(-1, 8)
    return {
        "shape": int(ia.shape != ib.shape or pa.rows.shape != pb.rows.shape),
        "int_words": int((ia[:, 6:] != ib[:, 6:]).sum()),
        "box_words": int((i2f(ia[:, :6]) != i2f(ib[:, :6])).sum()),
        "e_ranges": int((sa.e_ranges.cpu() != sb.e_ranges.cpu()).sum()),
        "pair_rows": int((pa.rows.cpu() != pb.rows.cpu()).sum()),
        "counts": int(int(sa.num_inner) != int(sb.num_inner)
                      or int(sa.num_leaves) != int(sb.num_leaves)),
    }


def brute_check(label: str, views, packed, rays, triangles, tree: str = "SAH tree",
                tracer=None) -> None:
    """K1's hits (or ``tracer``'s) on sampled rays against brute force over
    every triangle: at most 0.5% of the rays may differ on hit, t or the
    primitive; a different primitive at exactly the same t (either triangle
    of an exact tie) counts as agreement."""
    tracer = tracer or split_trace.make_split_tracer(RES, RES, sort_mode="presorted")
    rec, stats = tracer(views, packed, rays)
    ref = brute_force_trace(triangles, rays, chunk=64)
    num = rays.origin.shape[0]
    both = rec.hit & ref.hit
    bad_hit = int((rec.hit != ref.hit).sum())
    bad_t = int((both & ((rec.t - ref.t).abs() > T_RTOL * ref.t.abs())).sum())
    bad_prim = int((both & (rec.prim_id != ref.prim_id) & (rec.t != ref.t)).sum())
    ties = int((both & (rec.prim_id != ref.prim_id) & (rec.t == ref.t)).sum())
    print(f"  brute force, {num} {label} rays over {triangles.shape[0]} tris: "
          f"{int(ref.hit.sum())} hits, mismatches hit={bad_hit} t={bad_t} prim={bad_prim} "
          f"(exact-t ties naming the other triangle: {ties}), overflow {int(stats.overflow)}")
    for what, count in (("hit", bad_hit), ("t", bad_t), ("prim", bad_prim)):
        require(count <= (1.0 - BRUTE_AGREE) * num,
                f"{tree}: the tracer and brute force disagree on {what} for {count} "
                f"{label} rays")
    require(int(stats.overflow) == 0, f"{label} brute-force sample overflowed")
    require(int(ref.hit.sum()) > 0, f"no {label} ray of the brute-force sample hits")


def sah_checks(device, card: str, scene, dev_scene, camera, triangles, split: dict) -> dict:
    """Phase 12: the frame-0 binned-SAH trace tree at 1M, its checks, its
    agreement with a CPU build, and the bench frame traced on it by K1."""
    print("phase 12: the frame-0 binned-SAH trace tree (bench.py:175-228)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    deadline = time.monotonic() + SAH_BUDGET_S
    stats = {}
    t0 = time.perf_counter()
    tree, packed = split_convert.build_sah_split(triangles, True, split_trace.LEAFW,
                                                 deadline=deadline, stats=stats)
    stats["build_s"] = time.perf_counter() - t0
    build_peak_mib = torch.cuda.max_memory_allocated() / 2**20
    split_convert.check_sah_split_capacity(tree)
    views, packed, tree = split_convert.sah_split_views(tree, packed)
    rows = split_convert.row_depth(tree.inner, int(tree.num_inner))
    print(f"  {scene.num_triangles} tris, pairs: {int(tree.num_leaves)} leaves, "
          f"{int(tree.num_inner)} inner rows of {tree.inner.shape[0]}, {stats['levels']} frontier "
          f"levels, tree depth {stats['tree_depth']}, deepest anchor at depth "
          f"{stats['deepest_anchor']}, {rows} rows deep, stack bound {views[2]} (the bucket "
          f"tree's {bucket.stack_cap(8, views[1].shape[0])})")
    require(rows == stats["deepest_anchor"] // 3 + 1,
            f"{rows} rows deep, but the deepest anchor is at depth {stats['deepest_anchor']}")
    for key in ("setup_s", "frontier_s", "emit_s", "build_s"):
        print(f"  {key} = {stats[key]!r}  [{card}]")
    print(f"  build_peak_mem_mib = {build_peak_mib!r}  [{card}]")

    # the Tri entries' windows tile [0, num_leaves) exactly once
    ni = int(tree.num_inner)
    meta = tree.inner[:ni].reshape(-1, 8)[:, 6]
    er = tree.e_ranges[:ni].reshape(-1, 2)[(meta & 3) == 2].to(torch.int64)
    er = er[torch.argsort(er[:, 0])]
    tiled = (int(er[0, 0]) == 0 and bool((er[1:, 0] == (er[:, 0] + er[:, 1])[:-1]).all())
             and int((er[:, 0] + er[:, 1])[-1]) == int(tree.num_leaves))
    # a refit from the emitted pair rows gives back the emitted boxes
    refit = bucket.refit_split(tree, packed)
    box_bad = int((i2f(refit.inner.reshape(-1, 8)[:, :6])
                   != i2f(tree.inner.reshape(-1, 8)[:, :6])).sum())
    print(f"  check_sah_split_capacity passed; {er.shape[0]} Tri entries tile the leaves: "
          f"{tiled}; refit_split box words differing as floats: {box_bad}")
    require(tiled, "the SAH tree's Tri entries do not tile [0, num_leaves) exactly once")
    require(box_bad == 0, f"refit_split changes {box_bad} box words of the emitted SAH tree")

    # the same build on the card and on the CPU
    small = torch.as_tensor(procedural.terrain(CPU_CHECK_TRIS).triangles)
    for splits in (False, True):
        card_tree = split_convert.build_sah_split(small.to(device), True, split_trace.LEAFW,
                                                  enable_splits=splits)
        cpu_tree = split_convert.build_sah_split(small, True, split_trace.LEAFW,
                                                 enable_splits=splits)
        bad = same_split(card_tree, cpu_tree)
        print(f"  terrain({CPU_CHECK_TRIS}) pairs=1 splits={int(splits)}: "
              f"{int(cpu_tree[0].num_inner)} inner rows, card against CPU: {bad}")
        require(sum(bad.values()) == 0, f"SAH build differs between the card and the CPU: {bad}")

    # the bench frame on the SAH tree: K1 on all four passes, leaf sort
    torch.cuda.reset_peak_memory_stats()
    tracers = split_trace.make_frame_tracers(RES, RES)
    captured = {k: Capture(v) for k, v in tracers.items()}
    recorders = {k: PassRecorder(v, split_trace) for k, v in captured.items()}
    split_trace.launch_count = 0
    frame = frame_fn(views, packed, dev_scene, camera, device, **recorders)
    frame(0, 0.0, sort_kind="leaf")
    img, frame_ms, total_rays = timed_frames(frame, sort_kind="leaf")
    launches = split_trace.launch_count
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    calls = [c for r in recorders.values() for c in r.calls]
    overflowed = int(sum(int(c["overflow"].sum()) for c in calls))
    require(all(c["launches"] > 0 for c in calls) and len(calls) == 4 * (ITERS + 1),
            f"{len(calls)} tracer calls, launches {[c['launches'] for c in calls]}")
    require(launches >= 4 * (ITERS + 1), f"K1 launched {launches} times in {ITERS + 1} frames")
    require(overflowed == 0, f"{overflowed} passes overflowed a K1 stack")
    require(bool(torch.isfinite(img).all()), "SAH frame has non-finite pixels")
    db = frame_psnr(img, split["img"])
    out = dict(frame_ms=frame_ms, mrays_per_s=total_rays / (frame_ms * ITERS) / 1000.0,
               peak_mem_mib=peak_mib, psnr_vs_bucket_db=db)
    print(f"  SAH frame: {RES}x{RES}, {BOUNCES} bounce, leaf bounce sort, K1 on every pass, "
          f"{total_rays} rays in {ITERS} frames")
    for key, val in out.items():
        print(f"  {key} = {val!r}  [{card}]")
    print(f"  K1 launches in {ITERS + 1} SAH frames = {launches}")
    require(db >= MIN_PSNR, f"SAH frame {db:.2f} dB against the bucket frame (< {MIN_PSNR})")
    profile_frame("SAH", frame_fn(views, packed, dev_scene, camera, device, **tracers), card,
                  sort_kind="leaf")

    # K1 against its plain version on every ray of each pass, and brute force
    timing = time_passes(views, captured, card, label="SAH 1M")
    for label, key in (("primary", "tracer"), ("bounce", "bounce_tracer")):
        rays, active = captured[key].rays, captured[key].active
        idx = (torch.arange(rays.origin.shape[0], device=device) if active is None
               else torch.nonzero(active).reshape(-1))
        pick = idx[torch.linspace(0, idx.shape[0] - 1, BRUTE_RAYS, device=device).round().long()]
        brute_check(label, views, packed, rays.take(pick), triangles)
    return dict(launches=launches, **timing)


def treelet_build(card: str, front) -> dict:
    """Phase 5."""
    tb, packed = treelet.build_treelet_auto(front)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        tb, packed = treelet.build_treelet_auto(front)
    build_ms = sync_ms(t0) / ITERS
    treelet.check_treelet_capacity(tb)
    pair_tid = treelet.build_pair_tid(front)
    bad = int((tb.pair_tid != pair_tid).sum())
    tcap, wh, ecap = tb.tables.shape
    table_mib = tb.tables.numel() * 4 / 2**20
    print(f"phase 5: treelet build at 1M: {int(tb.num_treelets)} treelets, tcap {tcap}, "
          f"tables [{tcap}, {wh}, {ecap}] = {table_mib:.1f} MiB and columns [{tcap}, {ecap}, "
          f"{wh}] = {tb.columns.numel() * 4 / 2**20:.1f} MiB, root tid {int(tb.root_tid)}, "
          f"max col {int(tb.max_col)}; check_treelet_capacity passed")
    print(f"  treelet_build_ms = {build_ms!r}  [{card}]")
    print(f"  pair_tid vs build_pair_tid: {bad} of {pair_tid.shape[0]} pairs differ")
    require(bad == 0, "TreeletBVH.pair_tid != build_pair_tid")
    return dict(build_ms=build_ms)


def lane_path(device, card: str, dev_scene, camera, triangles, split_img) -> dict:
    """Phase 6: the app's --tracer lane path at full size."""
    args = parse_cmd(["--scene", f"terrain:{NUM_TRIS}", "--type", "bottom-up", "--pairs",
                      "--tracer", "lane", "--bounces", str(BOUNCES), "--width", str(RES),
                      "--height", str(RES)])
    torch.cuda.reset_peak_memory_stats()
    tb, packed, tracers = build_trav(args, triangles)
    recorder = PassRecorder(tracers["tracer"], lane_trace)
    lane_trace.launch_count = 0
    frame = frame_fn(tb, packed, dev_scene, camera, device, tracer=recorder)
    frame(0, 0.0)
    img, frame_ms, total_rays = timed_frames(frame)
    launches = lane_trace.launch_count
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    calls = recorder.calls
    per_call = [c["launches"] for c in calls]
    unfinished = int(sum(int(c["overflow"].sum()) for c in calls))
    print(f"phase 6: lane path ({int(tb.num_treelets)} treelets), {RES}x{RES}, {BOUNCES} "
          f"bounce, wave driver, {total_rays} rays in {ITERS} frames")
    require(len(calls) == 4 * (ITERS + 1), f"{len(calls)} tracer calls in {ITERS + 1} frames")
    require(all(n > 0 for n in per_call), f"a pass launched no K5: {per_call}")
    require(unfinished == 0, f"{unfinished} passes left rays unfinished")
    require(bool(torch.isfinite(img).all()), "lane frame has non-finite pixels")
    db = frame_psnr(img, split_img)
    out = dict(frame_ms=frame_ms, mrays_per_s=total_rays / (frame_ms * ITERS) / 1000.0,
               peak_mem_mib=peak_mib, psnr_vs_split_db=db)
    for key, val in out.items():
        print(f"  {key} = {val!r}  [{card}]")
    print(f"  K5 launches per pass = {per_call} (total {launches})")
    require(db >= MIN_PSNR, f"lane frame {db:.2f} dB against the split frame (< {MIN_PSNR})")
    profile_frame("lane", frame_fn(tb, packed, dev_scene, camera, device,
                                   tracer=tracers["tracer"]), card)
    return dict(tb=tb, packed=packed, passes=calls[-4:], launches=launches, **out)


def lane_operands(tb, rays: Rays, active):
    """(rays8, fresh state), padded to a multiple of 128 with dead rays."""
    rays, active = lane_trace.pad_to_packets(rays, active)
    return (lane_trace.rays8_of(rays, active),
            lane_trace.init_state(int(tb.root_tid), rays.tmax, active))


class LaneAgreement:
    """K5 against its plain version, bit for bit, in the launch modes
    unbudgeted, budget48 and no_switch."""

    MODES = {"unbudgeted": dict(budget=0), "budget48": dict(budget=48),
             "no_switch": dict(no_switch=True)}

    def __init__(self):
        self.max_abs_err = 0.0

    def check(self, label, tb, rays, active) -> int:
        """Six launches (2 hit kinds x 3 modes); one line with, per launch,
        the rays with a hit and the rays stopped unfinished."""
        r8, state = lane_operands(tb, rays, active)
        root = int(tb.root_tid)
        counts = []
        for any_hit in (False, True):
            for mode, kw in self.MODES.items():
                ko, ks = lane_trace.lane_traverse(tb.tables, tb.columns, r8, state, root,
                                                  lw=tb.leaf_width, any_hit=any_hit, **kw)
                po, ps = lane_trace.trace_lane_plain(tb.tables, r8, state, root,
                                                     lw=tb.leaf_width, any_hit=any_hit, **kw)
                torch.cuda.synchronize()
                rows = (ko.view(torch.int32) != po.view(torch.int32)).sum(dim=(0, 2)).tolist()
                st_bad = int((ks != ps).sum())
                self.max_abs_err = max(self.max_abs_err, float((ko[:, 0] - po[:, 0]).abs().max()))
                require(sum(rows) == 0 and st_bad == 0,
                        f"{label} {mode} any_hit={any_hit}: K5 != plain on out rows {rows} "
                        f"and {st_bad} state words")
                counts.append(f"{int((f2i(ko[:, 1]) >= 0).sum())}/{int((ko[:, 7] > 0).sum())}")
        print(f"  {label:<36} rays={r8.shape[0] * 128:>6} hit/stopped "
              f"closest {' '.join(counts[:3])} any {' '.join(counts[3:])}: bit-equal")
        return int(counts[0].split("/")[0])


def lane_tie_fixtures(device, agree: LaneAgreement, rng) -> None:
    """K5 against its plain version where windows hold exact t ties: every
    triangle of terrain(32) and of soup(2000) twice, pairs off and on, leaf
    width 16 / ecap 128 and 8 / 16 (16 of a warp's lanes on a window), and
    on the random and unbounded rays also leaf widths 24, 40 and 128 at
    ecap 128 (2, 4 and 8 triangles a lane). The "unbounded" rays have tmax
    = F32_MAX, so a window they enter and miss still names its all-miss
    index, 2 * lw - 1."""
    for name, base in (("terrain32x2", procedural.terrain(32)),
                       ("soup2000x2", procedural.random_triangle_soup(2000, seed=1))):
        scene = dataclasses.replace(base, triangles=np.repeat(base.triangles, 2, axis=0))
        tris = torch.as_tensor(scene.triangles, device=device)
        sets = fixture_rays(scene, device, rng)
        rays = sets["random"][0]
        sets["unbounded"] = (Rays(rays.origin, rays.direction, rays.tmin,
                                  torch.full_like(rays.tmax, F32_MAX)), None)
        for pairs in (False, True):
            front = bucket.split_front(tris, pairs)
            for lw, ecap in ((16, 128), (8, 16)) + tuple((w, 128) for w in TIE_LANE_WIDTHS):
                tcap = treelet.treelet_capacity(front, lw, ecap) + 8
                tb, _ = treelet.build_treelet(front, tcap, leaf_width=lw, ecap=ecap)
                treelet.check_treelet_capacity(tb)
                for set_name, (rays, active) in sets.items():
                    if lw in TIE_LANE_WIDTHS and set_name not in ("random", "unbounded"):
                        continue
                    agree.check(f"{name} pairs={int(pairs)} lw={lw} ecap={ecap} {set_name}",
                                tb, rays, active)


def lane_checks(device, card: str, lane: dict, triangles, baseline=None) -> dict:
    """Phase 7."""
    print("phase 7: K5 against its plain version on the card")
    agree = LaneAgreement()
    rng = np.random.default_rng(0)
    for name, scene in (("sphere", procedural.sphere_scene(3)),
                        ("soup2000", procedural.random_triangle_soup(2000, seed=1))):
        front = bucket.split_front(torch.as_tensor(scene.triangles, device=device), True)
        for lw, ecap in ((16, 128), (8, 16)):
            tcap = treelet.treelet_capacity(front, lw, ecap) + 8
            tb, _ = treelet.build_treelet(front, tcap, leaf_width=lw, ecap=ecap)
            treelet.check_treelet_capacity(tb)
            for set_name, (rays, active) in fixture_rays(scene, device, rng).items():
                agree.check(f"{name} ecap={ecap} T={int(tb.num_treelets)} {set_name}", tb, rays,
                            active)
    tb, packed = lane["tb"], lane["packed"]
    samples = {}
    for name, call in zip(PASSES, lane["passes"]):
        rays, n_live = live_sample(call["rays"], call["active"])
        samples[name] = rays
        print(f"  terrain1M {name}: {rays.origin.shape[0]} of {n_live} live rays")
        hits = agree.check(f"terrain1M {name}", tb, rays, None)
        require(hits > 0, f"terrain1M {name}: no ray of the sample hits, so it checks nothing")
    lane_tie_fixtures(device, agree, rng)

    # the lane tracer's hits against brute force over the 1M triangles
    n_sample = samples["bounce"].origin.shape[0]
    rays = samples["bounce"].take(
        torch.linspace(0, n_sample - 1, min(BRUTE_RAYS, n_sample), device=device).round().long())
    rec, stats = lane_trace.make_lane_tracer()(tb, packed, rays)
    ref = brute_force_trace(triangles, rays, chunk=64)
    both = rec.hit & ref.hit
    bad_hit = int((rec.hit != ref.hit).sum())
    bad_t = int((both & ((rec.t - ref.t).abs() > T_RTOL * ref.t.abs())).sum())
    bad_prim = int((both & (rec.prim_id != ref.prim_id)).sum())
    print(f"  brute force, {rays.origin.shape[0]} bounce rays over {triangles.shape[0]} tris: "
          f"{int(ref.hit.sum())} hits, mismatches hit={bad_hit} t={bad_t} prim={bad_prim}, "
          f"unfinished={int(stats.overflow)}")
    for key, count in (("hit", bad_hit), ("t", bad_t), ("prim", bad_prim)):
        require(count <= (1.0 - BRUTE_AGREE) * rays.origin.shape[0],
                f"lane tracer and brute force disagree on {key} for {count} rays")
    require(int(stats.overflow) == 0, "brute-force sample left rays unfinished")

    kernels = {"K5": lane_trace.lane_traverse}
    if baseline is not None:
        kernels["baseline K5"] = baseline
    timing = time_lane_passes(tb, packed, lane["passes"], card, kernels)
    for label, fn in kernels.items():
        time_drivers(tb, packed, lane["passes"][2], card, label, fn)
    print(f"  K5 launch count after the comparisons = {lane_trace.launch_count} "
          f"(lane path: {lane['launches']})")
    return dict(timing, max_abs_err=agree.max_abs_err)


class BaselineK5:
    """An earlier K5 source given by ``--k5-baseline``: the same C interface
    as csrc/lane_trace.cu, reading the reference's ``tables`` layout. Called
    as ``lane_traverse`` is; it counts no launch."""

    NAME = "lane_trace_baseline"

    def __init__(self, source: Path):
        self.source = source

    def __call__(self, tables, columns, rays8, state, root_tid, *, lw, any_hit, budget=0,
                 no_switch=False):
        fn = _cuda_build.load_library(self.NAME, self.source).lane_trace_launch
        fn.argtypes = lane_trace._ARGTYPES
        fn.restype = ctypes.c_int
        num_p = rays8.shape[0]
        out = torch.empty((num_p, 8, 128), dtype=torch.float32, device=rays8.device)
        state_out = torch.empty_like(state)
        t, wh, ecap = tables.shape
        err = fn(tables.data_ptr(), t, wh, ecap, lw, rays8.data_ptr(), state.data_ptr(),
                 out.data_ptr(), state_out.data_ptr(), num_p, int(root_tid), state.shape[1] - 5,
                 int(budget), int(no_switch), int(any_hit),
                 torch.cuda.current_stream(rays8.device).cuda_stream)
        require(err == 0, f"baseline K5 launch failed: cudaError {err}")
        return out, state_out


def wave_launches(tb, packed, call) -> list:
    """The K5 launches the lane frame's tracer (the wave driver) makes on
    one pass, in order: (rays8, state, keyword arguments) of each."""
    launches = []
    real = lane_trace.lane_traverse

    def record(tables, columns, rays8, state, root_tid, **kw):
        launches.append((rays8, state, kw))
        return real(tables, columns, rays8, state, root_tid, **kw)

    lane_trace.lane_traverse = record
    try:
        lane_trace.make_lane_tracer()(tb, packed, call["rays"], active=call["active"])
    finally:
        lane_trace.lane_traverse = real
    return launches


def launch_ms(fn) -> float:
    """Median device time of 3 calls after a warm one, each in CUDA events
    queued behind a spin kernel (the wrapper's host work left out)."""
    return statistics.median(_common.time_runs(fn, [()] * 4, torch.device("cuda")))


def same_words(a, b) -> bool:
    return bool((a.view(torch.int32) == b.view(torch.int32)).all())


def time_lane_passes(tb, packed, passes, card: str, kernels: dict) -> dict:
    """Each kernel of ``kernels`` (K5 and any baseline) on each of the lane
    frame's four passes: as the frame launches it (the wave driver's
    launches recorded, then each replayed on its operands and timed by
    ``launch_ms``; their sum) and as one unbudgeted closest-hit launch from
    a fresh state (mean of 5 after a warm one, by CUDA events). Every replay
    of a baseline must equal K5's output bit for bit; each unbudgeted K5
    launch must equal the plain version on every out row and state word of
    every ray. The bound comes from that plain run's counts; visits per
    live ray are out rows 2 and 3 over 8 and 2 * lw. The plain version's
    time is its run on the bounce pass (with the visit marking on). Returns
    the bounce pass's numbers, which stand for K5 in the kernels line."""
    root, lw = int(tb.root_tid), tb.leaf_width
    totals = {label: 0.0 for label in kernels}
    res = {}
    for name, call in zip(PASSES, passes):
        launches = wave_launches(tb, packed, call)
        wave = {label: 0.0 for label in kernels}
        for r8, st, kw in launches:
            ref = None
            for label, fn in kernels.items():
                wave[label] += launch_ms(lambda: fn(tb.tables, tb.columns, r8, st, root, **kw))
                got = fn(tb.tables, tb.columns, r8, st, root, **kw)
                if ref is None:
                    ref = got
                else:
                    require(same_words(got[0], ref[0]) and same_words(got[1], ref[1]),
                            f"1M {name} pass: {label} != K5 on a wave launch {kw}")
        n_wave = len(launches)
        del launches
        r8, st = lane_operands(tb, call["rays"], call["active"])
        kw = dict(lw=lw, any_hit=False)
        once, outs = {}, {}
        for label, fn in kernels.items():
            once[label], outs[label] = event_ms(
                lambda: fn(tb.tables, tb.columns, r8, st, root, **kw), 5)
        k5out = outs["K5"]
        visited = {}
        plain_ms, pout = event_ms(lambda: lane_trace.trace_lane_plain(
            tb.tables, r8, st, root, **kw, visited=visited), 1, warm=False)
        bad = [int((k.view(torch.int32) != p.view(torch.int32)).sum())
               for k, p in zip(k5out, pout)]
        require(sum(bad) == 0, f"1M {name} pass: K5 != plain on {bad} out / state words")
        # bound: out rows 2-3 count each ray's box and triangle tests; rays8
        # and the state in, out and the state written back, each inner column
        # (56 words) and window column (12 lw + 1 words) visited once
        out = k5out[0]
        n_ops = float(out[:, 2].sum()) * SLAB_OPS + float(out[:, 3].sum()) * MT_OPS
        n_rays = r8.shape[0] * 128
        n_inner, n_window = int(visited["inner"].sum()), int(visited["window"].sum())
        nbytes = (n_rays * 4 * (8 + 8 + 2 * st.shape[1]) + n_inner * 56 * 4
                  + n_window * (12 * lw + 1) * 4)
        b = bound(n_ops, nbytes)
        live = call["active"]
        n_live = int(live.sum()) if live is not None else call["rays"].origin.shape[0]
        per_ray = out.transpose(1, 2).reshape(n_rays, 8)[:call["rays"].origin.shape[0]]
        if live is not None:
            per_ray = per_ray[live]
        inner_v = float(per_ray[:, 2].sum()) / 8 / n_live
        window_v = float(per_ray[:, 3].sum()) / (2 * lw) / n_live
        times = ", ".join(f"{label} {wave[label]!r} ms ({once[label]!r} unbudgeted)"
                          for label in kernels)
        print(f"  1M {name} pass: {n_rays} rays ({n_live} live), wave driver ({n_wave} "
              f"launches): {times}; "
              f"bound {b['bound_ms']!r} ms ({b['bound_by']}; {n_ops:.4g} ops, {nbytes} bytes: "
              f"{n_inner} inner, {n_window} window columns); visits per live ray inner "
              f"{inner_v!r} window {window_v!r}; K5 bit-equal to plain  [{card}]")
        for label in kernels:
            totals[label] += wave[label]
        res[name] = dict(ms=once["K5"], plain_ms=plain_ms, **b)
    print("  on the four passes, as the frame launches them: "
          + ", ".join(f"{label} {ms!r} ms a frame" for label, ms in totals.items())
          + f"  [{card}]")
    print(f"  plain version on the 1M bounce pass: {res['bounce']['plain_ms']!r} ms  [{card}]")
    return res["bounce"]


def time_drivers(tb, packed, bounce_call, card: str, label: str, traverse) -> None:
    """Each lane driver on the 1M bounce pass with ``traverse`` as the
    kernel, host-timed around a synchronise (one warm run, then the mean of
    ITERS)."""
    rays, active = bounce_call["rays"], bounce_call["active"]
    line = []
    real = lane_trace.lane_traverse
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return traverse(*args, **kw)

    lane_trace.lane_traverse = counted
    try:
        for driver in lane_trace.DRIVERS:
            tracer = lane_trace.make_lane_tracer(driver=driver)
            calls.clear()
            tracer(tb, packed, rays, active=active)
            launches = len(calls)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ITERS):
                _, stats = tracer(tb, packed, rays, active=active)
            line.append(f"{driver} {sync_ms(t0) / ITERS:.3f} ms ({launches} launches)")
            require(int(stats.overflow) == 0, f"lane driver {driver} left rays unfinished")
    finally:
        lane_trace.lane_traverse = real
    print(f"  lane drivers on the 1M bounce pass, {label}: {', '.join(line)}  [{card}]")


def binary_path(device, card: str, dev_scene, camera, triangles, split_img) -> dict:
    """Phase 8: the Karras build, its checks, the fat collapse and the K6
    frame at full size."""
    torch.cuda.reset_peak_memory_stats()
    lbvh.build_lbvh(triangles, True)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        bvh, pairs = lbvh.build_lbvh(triangles, True)
    build_ms = sync_ms(t0) / ITERS
    _, _, num_leaves = lbvh.generate_morton_codes_pairs(triangles, *lbvh.scene_aabb(triangles))
    t0 = time.perf_counter()
    stats = count_nodes(bvh)
    errors = verify_hierarchy(bvh)
    check_s = time.perf_counter() - t0
    print(f"phase 8: Karras build of {triangles.shape[0]} tris: {bvh.num_slots} slots, tree height "
          f"{int(lbvh.tree_height(bvh))}; count_nodes {stats}, live leaves {int(num_leaves)}, "
          f"verify_hierarchy errors {len(errors)} (host checks {check_s:.2f} s)")
    require(stats.num_leaf_nodes == int(num_leaves),
            f"count_nodes finds {stats.num_leaf_nodes} leaves, the build made {int(num_leaves)}")
    require(not errors, f"verify_hierarchy: {len(errors)} boxes fail, first {errors[:8]}")
    packed = pack_pairs(pairs)
    wide.build_wide_fat(bvh, packed.rows)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fat = wide.build_wide_fat(bvh, packed.rows)
    fat_ms = sync_ms(t0) / ITERS
    rows256 = fat_traverse.pad_rows_256(fat.rows)
    print(f"  fat rows {tuple(fat.rows.shape)}, num_nodes {int(fat.num_nodes)}")
    del fat

    recorder = PassRecorder(fat_traverse.make_fat_tracer(None, RES, RES), fat_traverse)
    fat_traverse.launch_count = 0
    frame = frame_fn(rows256, packed, dev_scene, camera, device, tracer=recorder)
    frame(0, 0.0, sort_kind="leaf")
    img, frame_ms, total_rays = timed_frames(frame, sort_kind="leaf")
    launches = fat_traverse.launch_count
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    calls = recorder.calls
    per_call = [c["launches"] for c in calls]
    overflowed = int(sum(int(c["overflow"].sum()) for c in calls))
    print(f"  binary frame: {RES}x{RES}, {BOUNCES} bounce, leaf bounce sort, K6 on every pass, "
          f"{total_rays} rays in {ITERS} frames")
    require(len(calls) == 4 * (ITERS + 1), f"{len(calls)} tracer calls in {ITERS + 1} frames")
    require(all(n > 0 for n in per_call), f"a pass launched no K6: {per_call}")
    require(overflowed == 0, f"{overflowed} passes overflowed a K6 stack")
    require(bool(torch.isfinite(img).all()), "binary frame has non-finite pixels")
    db = frame_psnr(img, split_img)
    out = dict(build_lbvh_ms=build_ms, build_wide_fat_ms=fat_ms, frame_ms=frame_ms,
               mrays_per_s=total_rays / (frame_ms * ITERS) / 1000.0, peak_mem_mib=peak_mib,
               psnr_vs_split_db=db)
    for key, val in out.items():
        print(f"  {key} = {val!r}  [{card}]")
    print(f"  K6 launches per pass = {per_call} (total {launches})")
    require(db >= MIN_PSNR, f"binary frame {db:.2f} dB against the split frame (< {MIN_PSNR})")
    profile_frame("binary", frame_fn(rows256, packed, dev_scene, camera, device,
                                     tracer=fat_traverse.make_fat_tracer(None, RES, RES)), card,
                  sort_kind="leaf")
    return dict(bvh=bvh, packed=packed, rows256=rows256, passes=calls[-4:], launches=launches,
                **out)


def fat_mismatches(kout, pout) -> list:
    """Words of hit, t, prim, tri, u and v on which two K6 runs differ, and
    whether their overflow flags differ."""
    return ([int((k.view(torch.int32) != p.view(torch.int32)).sum())
             for k, p in zip(kout[:6], pout[:6])] + [int(int(kout[6]) != int(pout[6]))])


def count_mismatches(kout, pout, counts) -> list:
    """``fat_mismatches`` of K6's counting instantiation, then the rays on
    which its box tests and triangle-entry tests differ from the plain
    version's ``counts``."""
    return fat_mismatches(kout[:7], pout) + [
        int((kout[7] != counts["box_tests"]).sum()),
        int((kout[8] != counts["tri_entry_tests"]).sum())]


class FatAgreement:
    """K6 against its plain version, bit for bit on all six outputs and the
    overflow flag; so are both forms of ``fat_traverse_cycles``, and K6's
    counting instantiation on the outputs and both counts."""

    def __init__(self):
        self.max_abs_err = 0.0

    def check(self, label, rows256, rays, active) -> int:
        ops = fat_traverse.kernel_operands(rays, active)
        kout = fat_traverse.fat_traverse(rows256, *ops)
        counts = {}
        pout = fat_traverse.trace_fat_plain(rows256, *ops, counts=counts)
        bad = fat_mismatches(kout, pout)
        bad_count = count_mismatches(fat_traverse.fat_traverse(rows256, *ops, count=True), pout,
                                     counts)
        require(sum(bad_count) == 0, f"{label}: K6's counting instantiation != plain on "
                                     f"{bad_count} (outputs, overflow, box and entry tests)")
        for per_thread in (False, True):
            other = fat_mismatches(fat_traverse.fat_traverse_cycles(
                rows256, *ops, per_thread=per_thread), pout)
            require(sum(other) == 0, f"{label}: fat_traverse_cycles(per_thread={per_thread}) "
                                     f"!= plain on {other}")
        hit = kout[0] != 0
        if bool(hit.any()):
            self.max_abs_err = max(self.max_abs_err, float((kout[1] - pout[1])[hit].abs().max()))
        hits = int(hit.sum())
        print(f"  {label:<34} rays={hit.shape[0]:>7} hits={hits:>7} mismatches "
              f"hit/t/prim/tri/u/v/overflow={bad} overflow={int(kout[6])}/{int(pout[6])}; "
              f"both profiled forms and the counting form bit-equal")
        require(sum(bad) == 0, f"{label}: K6 != plain on {bad}")
        require(int(kout[6]) == int(pout[6]) == 0, f"{label}: stack overflow")
        return hits


def fat_tie_fixtures(device, agree: FatAgreement, rng) -> None:
    """K6 against its plain version where rows hold exact t ties: every
    triangle of terrain(32) and of soup(2000) twice, pairs off and on, on
    the camera, axis-aligned, random and half-dead rays and on the random
    rays with tmax = F32_MAX ("unbounded")."""
    for name, base in (("terrain32x2", procedural.terrain(32)),
                       ("soup2000x2", procedural.random_triangle_soup(2000, seed=1))):
        scene = dataclasses.replace(base, triangles=np.repeat(base.triangles, 2, axis=0))
        tris = torch.as_tensor(scene.triangles, device=device)
        sets = fixture_rays(scene, device, rng)
        rays = sets["random"][0]
        sets["unbounded"] = (Rays(rays.origin, rays.direction, rays.tmin,
                                  torch.full_like(rays.tmax, F32_MAX)), None)
        for pairs in (False, True):
            bvh, tp = lbvh.build_lbvh(tris, pairs)
            rows = fat_traverse.pad_rows_256(wide.build_wide_fat(bvh, pack_pairs(tp).rows).rows)
            for set_name, (rays, active) in sets.items():
                agree.check(f"{name} pairs={int(pairs)} {set_name}", rows, rays, active)


def fat_fixture_checks(device, agree: FatAgreement, rng) -> None:
    """K6's fixtures: the sphere and soup(2000), pairs off and on, on their
    camera, axis-aligned, random and half-dead rays; then the tie
    fixtures."""
    for name, scene in (("sphere", procedural.sphere_scene(3)),
                        ("soup2000", procedural.random_triangle_soup(2000, seed=1))):
        tris = torch.as_tensor(scene.triangles, device=device)
        for pairs in (False, True):
            bvh, tp = lbvh.build_lbvh(tris, pairs)
            rows = fat_traverse.pad_rows_256(wide.build_wide_fat(bvh, pack_pairs(tp).rows).rows)
            for set_name, (rays, active) in fixture_rays(scene, device, rng).items():
                agree.check(f"{name} pairs={int(pairs)} {set_name}", rows, rays, active)
    fat_tie_fixtures(device, agree, rng)


def fat_checks(device, card: str, binary: dict, triangles, baselines=()) -> dict:
    """Phase 9."""
    print("phase 9: K6 against its plain version on the card")
    agree = FatAgreement()
    rng = np.random.default_rng(0)
    fat_fixture_checks(device, agree, rng)
    rows256 = binary["rows256"]
    samples = {}
    for name, call in zip(PASSES, binary["passes"]):
        rays, n_live = live_sample(call["rays"], call["active"])
        samples[name] = rays
        print(f"  terrain1M {name}: {rays.origin.shape[0]} of {n_live} live rays")
        hits = agree.check(f"terrain1M {name}", rows256, rays, None)
        require(hits > 0, f"terrain1M {name}: no ray of the sample hits, so it checks nothing")

    # K6's hits against brute force and the scalar tracer on the same tree
    n_sample = samples["bounce"].origin.shape[0]
    rays = samples["bounce"].take(
        torch.linspace(0, n_sample - 1, min(BRUTE_RAYS, n_sample), device=device).round().long())
    rec, stats = fat_traverse.trace_rays_fat(rows256, rays)
    ref = brute_force_trace(triangles, rays, chunk=64)
    srec, sstats = trace_rays(pack_bvh(binary["bvh"]), binary["packed"], rays)
    num = rays.origin.shape[0]
    both = rec.hit & ref.hit
    bad_hit = int((rec.hit != ref.hit).sum())
    bad_t = int((both & ((rec.t - ref.t).abs() > T_RTOL * ref.t.abs())).sum())
    bad_prim = int((both & (rec.prim_id != ref.prim_id)).sum())
    both_s = rec.hit & srec.hit
    bad_hit_s = int((rec.hit != srec.hit).sum())
    bad_t_s = int((both_s & ((rec.t - srec.t).abs() > T_RTOL * srec.t.abs())).sum())
    print(f"  brute force, {num} bounce rays over {triangles.shape[0]} tris: "
          f"{int(ref.hit.sum())} hits, mismatches hit={bad_hit} t={bad_t} prim={bad_prim}; "
          f"scalar trace_rays: {int(srec.hit.sum())} hits, mismatches hit={bad_hit_s} "
          f"t={bad_t_s}; overflow K6 {int(stats.overflow)} scalar {int(sstats.overflow)}")
    for key, count in (("hit", bad_hit), ("t", bad_t), ("prim", bad_prim)):
        require(count <= (1.0 - BRUTE_AGREE) * num,
                f"K6 and brute force disagree on {key} for {count} rays")
    require(bad_hit_s == 0 and bad_t_s == 0, "K6 and the scalar tracer disagree")
    require(int(stats.overflow) == 0 and int(sstats.overflow) == 0, "stack overflow")
    timing = time_fat_passes(rows256, binary["passes"], card, baselines)
    print(f"  K6 launch count after the comparisons = {fat_traverse.launch_count} "
          f"(binary path: {binary['launches']})")
    return dict(timing, max_abs_err=agree.max_abs_err)


class BaselineK6:
    """An earlier K6 source given by ``--k6-baseline``: the same C entry,
    ``fat_traverse_launch``. Called as ``fat_traverse`` is; it counts no
    launch."""

    def __init__(self, source: Path, index: int):
        self.source = source
        self.name = f"fat_traverse_baseline{index}"

    def __call__(self, rows, origin, direction, tmin, tmax):
        _cuda_build.load_library(self.name, self.source)
        return fat_traverse._launch("fat_traverse_launch", fat_traverse._ARGTYPES, rows, origin,
                                    direction, tmin, tmax, library=self.name)


def fat_pass_operands(call):
    """K6's operands for one pass of the binary frame in the order the tiled
    tracer hands them over (16 x 8 screen tiles), and the live mask in that
    order."""
    rays, active = call["rays"], call["active"]
    tiled = Rays(*(tile_reorder(getattr(rays, f), RES, RES, 16, 8)
                   for f in ("origin", "direction", "tmin", "tmax")))
    live = (torch.ones(rays.origin.shape[0], dtype=torch.bool, device=rays.origin.device)
            if active is None else tile_reorder(active, RES, RES, 16, 8))
    return fat_traverse.kernel_operands(tiled, live), live


def time_fat_passes(rows256, passes, card: str, baselines=()) -> dict:
    """K6 on each of the binary frame's four passes, on the operands the
    tiled tracer hands it: K6 and any baselines, CUDA-event ms (mean of 5
    launches after a warm one), each bit-equal to the plain version on every
    ray; both clock64 splits and triangle tests run per live ray
    (``fat_traverse_cycles``: K6's by the warp, the replaced kernel's per
    lane) from one launch each; the bound from the plain version's
    counts, counted as phase 4 counts K1's; pops per live
    ray and triangle tests per pop and per live ray. Then the plain version
    is timed on the bounce pass (one run). Returns K6's numbers on the
    bounce pass, which stand for it in the kernels line."""
    kernels = {"K6": fat_traverse.fat_traverse}
    for b in baselines:
        kernels[f"{b.name} ({Path(b.source).name})"] = b
    totals = dict.fromkeys(kernels, 0.0)
    res = {}
    for name, call in zip(PASSES, passes):
        ops, live = fat_pass_operands(call)
        num, n_live = ops[0].shape[0], int(live.sum())
        counts = {}
        pout = fat_traverse.trace_fat_plain(rows256, *ops, counts=counts)
        times = {}
        for label, fn in kernels.items():
            ms, kout = event_ms(lambda: fn(rows256, *ops), 5)
            bad = fat_mismatches(kout, pout)
            require(sum(bad) == 0 and int(kout[6]) == 0,
                    f"1M {name} pass: {label} and plain disagree ({bad}) or overflow")
            times[label] = ms
            totals[label] += ms
        bad = count_mismatches(fat_traverse.fat_traverse(rows256, *ops, count=True), pout, counts)
        require(sum(bad) == 0, f"1M {name} pass: K6's counting instantiation != plain on {bad}")
        splits = []
        for per_thread, label in ((False, "K6, by the warp"),
                                  (True, "the one-thread-per-ray kernel, per lane")):
            *kout, cycles, tests = fat_traverse.fat_traverse_cycles(rows256, *ops,
                                                                    per_thread=per_thread)
            bad = fat_mismatches(kout, pout)
            require(sum(bad) == 0, f"1M {name} pass: {label}: profiled form != plain on {bad}")
            if per_thread:
                require(torch.equal(tests, counts["tri_tests"].to(tests)),
                        f"1M {name} pass: {label}: triangle tests != the plain version's")
            per_ray = cycles[:, live].double().mean(dim=1).tolist()
            whole = sum(per_ray)
            splits.append(f"{label} {whole:.0f} cycles: " + ", ".join(
                f"{phase} {c:.0f} ({100.0 * c / whole:.1f}%)"
                for phase, c in zip(fat_traverse.PHASES, per_ray))
                + f"; triangle tests run {float(tests[live].double().mean())!r}")
        # bound: box tests of non-empty entries and triangle tests run; rays in
        # (32 B), results out (24 B), the node words (256 B) of each row visited
        # and the pair words (64 B) of each Tri entry whose box a ray entered
        n_box, n_tri = float(counts["box_tests"].sum()), float(counts["tri_tests"].sum())
        n_ops = n_box * SLAB_OPS + n_tri * MT_OPS
        n_rows, n_entries = int(counts["visited"].sum()), int(counts["visited_tri"].sum())
        nbytes = num * (32 + 24) + n_rows * 256 + n_entries * 64
        b = bound(n_ops, nbytes)
        pops = float(counts["pops"][live].sum())
        tri_live = float(counts["tri_tests"][live].sum())
        print(f"  1M {name} pass: {num} rays ({n_live} live): "
              + ", ".join(f"{label} {ms!r} ms" for label, ms in times.items())
              + f"; bound {b['bound_ms']!r} ms ({b['bound_by']}; {n_ops:.4g} ops, {nbytes} bytes: "
              f"{n_rows} rows, {n_entries} Tri entries); per live ray: pops {pops / n_live!r}, "
              f"triangle tests {tri_live / n_live!r}; triangle tests per pop {tri_live / pops!r}; "
              f"bit-equal to plain, the counting form too  [{card}]")
        for line in splits:
            print(f"    clock64 per live ray, {line}  [{card}]")
        res[name] = dict(ms=times["K6"], **b)
    print("  on the four passes: " + ", ".join(f"{label} {ms!r} ms a frame"
                                               for label, ms in totals.items()) + f"  [{card}]")
    ops, _ = fat_pass_operands(passes[2])
    plain_ms, _ = event_ms(lambda: fat_traverse.trace_fat_plain(rows256, *ops), 1, warm=False)
    print(f"  plain version on the 1M bounce pass: {plain_ms!r} ms  [{card}]")
    return dict(plain_ms=plain_ms, **res["bounce"])


def split_versions(split: dict) -> int:
    """Phase 10: K1, with no selector, for the reference's K3, v4 and K4 on
    phase 3's bounce pass; returns the call's K1 launches."""
    print("phase 10: K1 for K3, v4 and K4 (no selector) on the bench frame's bounce pass")
    cap = split["captured"]["bounce_tracer"]
    views, packed = split["views"], split["packed"]
    inner, pairs, stack_cap = views
    split_trace.launch_count = 0
    _, stats = split_trace.trace_rays_split(views, packed, cap.rays, cap.active)
    torch.cuda.synchronize()
    launches = split_trace.launch_count
    _, _, ipops, lpops, _ = split_trace.split_traverse(
        inner, pairs, *split_trace.kernel_operands(cap.rays, cap.active),
        leafw=split_trace.LEAFW, any_hit=False, stack_cap=stack_cap)
    per_ray = (torch.equal(stats.box_tests, ipops * inner.shape[1])
               and torch.equal(stats.tri_tests, lpops * (2 * split_trace.LEAFW)))
    print(f"  {launches} K1 launch(es) for one call; statistics per ray, K1's pops times the "
          f"row width and the window's triangles: {per_ray}")
    require(launches == 1, f"one trace_rays_split call launched {launches} K1s")
    require(per_ray, "trace_rays_split's statistics are not K1's per-ray pops")
    return launches


def differing_words(a, b) -> int:
    """Words of a and b that differ bit for bit (NaN against NaN counts as
    equal: both sides carry interpret mode's NaN fill through)."""
    if a.dtype.is_floating_point:
        return int(((a.view(torch.int32) != b.view(torch.int32))
                    & ~(torch.isnan(a) & torch.isnan(b))).sum())
    return int((a != b).sum())


def abs_err(a, b) -> float:
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    d = d[~torch.isnan(d)]
    return float(d.max()) if d.numel() else 0.0


def outputs(res) -> tuple:
    return tuple(x for x in (res if isinstance(res, tuple) else (res,)) if x is not None)


def check_probe(mod, kind: str, device, rows) -> dict:
    """One probe's kernel against its plain version at the check size, bit
    for bit on every output; returns max_abs_err, plain_ms and the kernel's
    check-size outputs."""
    if mod in (micro_pallas, micro_control):
        seed = torch.tensor([7], dtype=torch.int32, device=device)
        runs = (("seeded scratch", _micro.make_fill(7, device)),
                ("interpret fill", _micro.interpret_fills(device)))
        call = lambda fill, f: f(kind, rows, seed, PROBE_N_CHECK, fill)  # noqa: E731
    else:
        tab, idx = mod.inputs(kind, 3, device)
        runs = (("seeded inputs", None),)
        call = lambda fill, f: f(kind, tab, idx, PROBE_ITERS_CHECK)  # noqa: E731
    worst, plain_ms, kout = 0.0, None, None
    for label, fill in runs:
        kout = outputs(call(fill, mod.probe))
        ms, pout = event_ms(lambda: call(fill, mod.probe_plain), 1, warm=False)
        plain_ms = ms if plain_ms is None else plain_ms
        pout = outputs(pout)
        bad = [differing_words(k, p) for k, p in zip(kout, pout)]
        require(len(kout) == len(pout) and sum(bad) == 0,
                f"{mod.__name__}.{kind} ({label}): kernel != plain on {bad} words")
        worst = max([worst] + [abs_err(k, p) for k, p in zip(kout, pout)])
    return dict(max_abs_err=worst, plain_ms=plain_ms, outputs=kout)


def probe_library_ms(mod, kind: str, device, iters: int):
    """PyTorch's own calls for the same function at the reference's size,
    median of 5 runs: take_along_dim for the one-shot gathers and the one
    shift (its kernels' device time, as the probes' kernels are timed); for
    e2 the whole chain of ITERS torch.matmul and remainder steps in one
    CUDA-event window. None where there is no such call."""
    if not hasattr(mod, "library"):
        return None
    tab, idx = mod.inputs(kind, 0, device)
    if mod.library(kind, tab, idx, 1) is None:
        return None
    runs = _common.time_runs(lambda t, i, n: mod.library(kind, t, i, n),
                             _lane.arg_sets((tab, idx), iters), device, window=kind == "e2")
    return statistics.median(runs)


def lane_spread(device, card: str, iters: int) -> None:
    """What bank conflicts cost a lane gather: ``fetch`` (96 rows gathered
    per lane and iteration) with every lane on one column, on 128 distinct
    conflict-free columns, and on 128 distinct columns 4 to a bank, each
    checked against its plain version; and how the reference's own chains
    fall on the banks (they converge onto a few columns)."""
    tab, idx = probe_lane_machine2.inputs("fetch", 0, device)
    tab3, idx3 = probe_lane_machine3.inputs("V2", 0, device)
    for name, walk in (("fetch/full", _lane.pointer_walk(tab, idx[0], iters)),
                       ("V0-V4", _lane.pointer_walk(tab3, idx3[0], iters, relative=True))):
        cols, degree = _lane.bank_profile(walk)
        print(f"  {name} on the reference's inputs: {cols!r} distinct columns per warp read, "
              f"mean bank-conflict degree {degree!r}")
    for spread in probe_lane_machine2.SPREADS:
        tab, idx = probe_lane_machine2.spread_inputs(spread, 0, device)
        kout, _ = probe_lane_machine2.probe("fetch", tab, idx, PROBE_ITERS_CHECK)
        pout, _ = probe_lane_machine2.probe_plain("fetch", tab, idx, PROBE_ITERS_CHECK)
        require(differing_words(kout, pout) == 0, f"fetch ({spread} lanes): kernel != plain")
        cols, degree = _lane.bank_profile(_lane.pointer_walk(tab, idx[0], iters))
        runs = _common.time_runs(lambda *a: probe_lane_machine2.probe("fetch", *a),
                                 _lane.arg_sets((tab, idx), iters), device)
        ms = statistics.median(runs)
        print(f"  fetch, lanes {spread:<9}: {cols!r} columns per warp read, conflict degree "
              f"{degree!r}: {ms * 1e6 / iters:.1f} ns/iter ({ms!r} ms, bit-equal)  [{card}]")


def probe_phase(device, card: str) -> list:
    """Phase 11: the micro-probes' entry points, then each kernel against
    its plain version; returns the probes' entries of the kernels line."""
    print("phase 11: the benchmarks/ micro-probes")
    for mod in PROBE_MODULES:
        for kind in mod.KINDS:
            mod.launch_count[kind] = 0
    timing = {mod: mod.main([]) for mod in PROBE_MODULES}
    launches = {mod: dict(mod.launch_count) for mod in PROBE_MODULES}
    for mod in PROBE_MODULES:
        idle = [k for k, n in launches[mod].items() if n == 0]
        require(not idle, f"{mod.__name__}: no launch of {idle} on the probes' path")
        wrong = [k for k, res in timing[mod].items() if res["ok"] is False]
        require(not wrong, f"{mod.__name__}: {wrong} differ from PyTorch's own calls")
    iters_ref = int(timing[probe_lane_machine]["e1c"]["iters"])
    rows = _micro.make_rows(device)
    entries = []
    print(f"  kernel vs plain at N = {PROBE_N_CHECK} / ITERS = {PROBE_ITERS_CHECK}, bit for bit; "
          f"kernel ms at the reference's size  [{card}]")
    for mod in PROBE_MODULES:
        short = mod.__name__.rsplit(".", 1)[1]
        for kind in mod.KINDS:
            res = timing[mod][kind]
            chk = check_probe(mod, kind, device, rows)
            if mod in (micro_pallas, micro_control):
                ops, nbytes = mod.work(kind, 1, res["iters"])
                bf16_ops, lib_ms = 0.0, None
            else:
                tab, idx = mod.inputs(kind, 0, device)
                outs = chk["outputs"]
                lane_kind = "wide" if kind.startswith("wide") else kind
                ops, bf16_ops, nbytes = _lane.work(
                    lane_kind, tab, idx, outs[0].shape[0],
                    outs[1].shape[0] if len(outs) > 1 else 0, iters_ref)
                lib_ms = probe_library_ms(mod, kind, device, iters_ref)
            b = bound(ops, nbytes, bf16_ops)
            rate = (f"{res['ns_per_iter']:10.1f} ns/iter" if res["iters"] > 1
                    else "  one shot     ")
            print(f"  {short}.{kind:<8} {rate}  kernel "
                  f"{res['ms']!r} ms, plain {chk['plain_ms']!r} ms (check size), bound "
                  f"{b['bound_ms']!r} ms ({b['bound_by']}), library {lib_ms!r} ms, "
                  f"launches {launches[mod][kind]}: bit-equal")
            entries.append({
                "name": f"{short}.{kind}", "route": "cuda", "source": mod.SOURCE,
                "replaces": f"{mod.REFERENCE}:{mod.REPLACES[kind]}",
                "launches": launches[mod][kind], "max_abs_err": chk["max_abs_err"],
                "ms": res["ms"], "plain_ms": chk["plain_ms"], "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "library_ms": lib_ms})
    ns = {(mod, k): timing[mod][k]["ns_per_iter"] for mod in PROBE_MODULES for k in mod.KINDS}
    for label, holds in (
            ("dma1 > loop", ns[micro_pallas, "dma1"] > ns[micro_pallas, "loop"]),
            ("pipe4 < dma1", ns[micro_pallas, "pipe4"] < ns[micro_pallas, "dma1"]),
            ("fetch2 >= fetch", ns[probe_lane_machine2, "fetch2"] >= ns[probe_lane_machine2, "fetch"]),
            ("V3 <= V2 per packet-iter",
             ns[probe_lane_machine3, "V3"] <= ns[probe_lane_machine3, "V2"])):
        print(f"  sanity ordering {label}: {'holds' if holds else 'DOES NOT HOLD'}")
    lane_spread(device, card, iters_ref)
    return entries


class ModeRecorder:
    """Wraps ``app/main.py:render_frame``: for each call, its render mode
    and the launches of K6's counting instantiation it made."""

    def __init__(self):
        self.fn = app_main.render_frame
        self.calls = []

    def __call__(self, *args, **kw):
        before = fat_traverse.count_launch_count
        out = self.fn(*args, **kw)
        self.calls.append((int(args[6]), fat_traverse.count_launch_count - before))
        return out


def run_app(argv):
    """``app/main.py:main(argv)`` in this process, its ``render_frame``
    recorded; returns (main's result, [(mode, counting launches)], wall s,
    its standard output)."""
    rec = ModeRecorder()
    app_main.render_frame = rec
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = app_main.main(argv)
    finally:
        app_main.render_frame = rec.fn
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        if not line.startswith(("Total number of box tests", "frame ")):
            print("    | " + line)
    return res, rec.calls, wall, buf.getvalue()


def mode_images(res) -> dict:
    """{(frame, mode): [H, W, 4] uint8} read back from the app's PNGs."""
    out = {}
    for frame, mode, _, path in res["frames"]:
        require(Path(path).stat().st_size > 0, f"{path} is empty")
        out[(frame, mode)] = read_png(path)
    return out


def check_mode_images(label: str, images: dict, frames: int) -> str:
    """Every mode's image decoded at full size; all but LODS (whose alpha
    is its grey) opaque, the modes that read no texture among them.
    Returns each frame-0 image's share of non-black pixels, to print."""
    for (frame, mode), img in images.items():
        require(img.shape == (APP_H, APP_W, 4), f"{label} mode {mode}: shape {img.shape}")
        if mode != LODS_MODE:
            require(bool((img[..., 3] == 255).all()), f"{label} mode {mode}: alpha not 255")
    require(sorted(m for f, m in images if f == 0) == list(range(NUM_MODES))
            and len(images) == NUM_MODES * frames, f"{label}: images {sorted(images)}")
    return ", ".join(f"{m}: {float(images[(0, m)][..., :3].any(axis=-1).mean()):.3f}"
                     for m in range(NUM_MODES))


def frame_ms_by_mode(res) -> dict:
    return {(f, m): ms for f, m, ms, _ in res["frames"]}


def aerial_modes(card: str, res) -> dict:
    """The app's structures rendered in every mode from phase 3's aerial
    camera (bench.py:85-91), whose rays cross the terrain as a user's view
    would: one warm frame and ITERS timed ones each (host clock,
    synchronised, the image left on the card), then one DEPTH and one
    TEXTURE_LIT_SHADOWS frame profiled. Returns the camera."""
    bvh = res["bvh"]
    box = dataclasses.make_dataclass("Box", ["aabb_min", "aabb_max"])(
        bvh.node_min[0].cpu().numpy(), bvh.node_max[0].cpu().numpy())
    camera = aerial_camera(box, bvh.node_min.device)
    times = {}
    for m in range(NUM_MODES):
        def frame():
            return render.render_frame(res["trav"], res["packed"], res["scene"], camera, APP_W,
                                       APP_H, RenderType(m), tracer=res["tracer"])
        img, _ = frame()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            img, tests = frame()
        times[m] = sync_ms(t0) / ITERS
        share = float((img[..., :3] != 0).any(dim=-1).float().mean())
        print(f"  terrain1M wide, aerial camera, mode {m} ({RenderType(m).name}): "
              f"{times[m]!r} ms a frame ({ITERS} frames), box tests {int(tests)}, non-black "
              f"share {share:.3f}  [{card}]")
        require(share > 0.25, f"aerial mode {m}: only {share:.3f} of the frame is lit")
    for m in (RenderType.DEPTH, RenderType.TEXTURE_LIT_SHADOWS):
        profile_frame(f"aerial mode {int(m)} ({m.name})", lambda *a, m=m: render.render_frame(
            res["trav"], res["packed"], res["scene"], camera, APP_W, APP_H, m,
            tracer=res["tracer"]), card)
    return camera


def counting_checks(card: str, res, aerial, fixtures: bool) -> dict:
    """Phase 13 (b): K6's counting instantiation against its plain version
    on 65,536 live rays of the app frame's primary pass and of
    TEXTURE_LIT_SHADOWS' shadow pass, in the 8x8 tile order the wide tracer
    hands them over, and the same from the ``aerial`` camera (with
    ``fixtures``, also phase 9's fixtures); then both instantiations timed
    on the whole aerial primary pass with the bound, and the counting one
    held to the plain version on every ray of it."""
    fat = res["trav"]
    rows256 = wide_fat.live_rows256(fat)

    def tiled(rays):
        return Rays(*(tile_reorder(getattr(rays, f), APP_W, APP_H, 8, 8)
                      for f in ("origin", "direction", "tmin", "tmax")))

    passes = {}
    for label, camera in (("app", res["camera"]), ("aerial", aerial)):
        primary = generate_primary_rays(camera, APP_W, APP_H)
        rec, _ = res["tracer"](fat, res["packed"], primary)
        passes[f"{label} primary"] = tiled(primary)
        passes[f"{label} shadow"] = tiled(render._shadow_rays(res["scene"], primary, rec))
    max_err = 0.0
    for name, rays in passes.items():
        sample, n_live = live_sample(rays, None)
        ops = fat_traverse.kernel_operands(sample)
        kout = fat_traverse.fat_traverse(rows256, *ops, count=True)
        counts = {}
        pout = fat_traverse.trace_fat_plain(rows256, *ops, counts=counts)
        bad = count_mismatches(kout, pout, counts)
        hits = int(pout[0].sum())
        print(f"  {name} pass: {sample.origin.shape[0]} of {n_live} live rays, {hits} hits; "
              f"mismatches hit/t/prim/tri/u/v/overflow/box/entry={bad}; box tests "
              f"{int(counts['box_tests'].sum())}, triangle-entry tests "
              f"{int(counts['tri_entry_tests'].sum())}")
        require(sum(bad) == 0, f"{name} pass: counting K6 != plain on {bad}")
        # the shadow rays may all reach the light; their tests are still counted
        require((hits > 0 or "shadow" in name) and int(counts["tri_entry_tests"].sum()) > 0,
                f"{name} pass: the sample checks no hit or no count")
        if hits:
            hit = kout[0] != 0
            max_err = max(max_err, float((kout[1] - pout[1])[hit].abs().max()))
    if fixtures:
        fat_fixture_checks(fat.rows.device, FatAgreement(), np.random.default_rng(0))

    res_by_pass = {}
    for name in ("app primary", "aerial primary"):
        res_by_pass[name] = time_counting(card, rows256, passes[name], name, int(fat.num_nodes))
    # the kernels line takes the main path's own pass: the app camera's
    return dict(max_abs_err=max_err, **res_by_pass["app primary"])


def time_counting(card: str, rows256, rays, name: str, num_rows: int) -> dict:
    """K6 and its counting instantiation timed on one whole pass (CUDA
    events, 5 launches after a warm one, in turns K6, counting, counting,
    K6), the plain version once, the counting one held to it on every ray;
    the bound from the plain version's counts, as phase 9 counts it."""
    ops = fat_traverse.kernel_operands(rays)
    num = ops[0].shape[0]
    counting = lambda: fat_traverse.fat_traverse(rows256, *ops, count=True)  # noqa: E731
    plain_k6 = lambda: fat_traverse.fat_traverse(rows256, *ops)  # noqa: E731
    times = {"K6": [], "K6 counting": []}
    for label, fn in (("K6", plain_k6), ("K6 counting", counting), ("K6 counting", counting),
                      ("K6", plain_k6)):
        ms, out = event_ms(fn, 5)
        times[label].append(ms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = {}
    pout = fat_traverse.trace_fat_plain(rows256, *ops, counts=counts)
    plain_ms = sync_ms(t0)
    bad = count_mismatches(counting(), pout, counts)
    require(sum(bad) == 0, f"{name} pass: counting K6 != plain on {bad}")
    # bound: box tests of non-empty entries and triangle tests run; rays in
    # (32 B), results and the two counts out (32 B), the node words (256 B)
    # of each row visited and the pair words (64 B) of each Tri entry entered
    n_box, n_tri = float(counts["box_tests"].sum()), float(counts["tri_tests"].sum())
    n_ops = n_box * SLAB_OPS + n_tri * MT_OPS
    n_rows, n_entries = int(counts["visited"].sum()), int(counts["visited_tri"].sum())
    nbytes = num * (32 + 32) + n_rows * 256 + n_entries * 64
    b = bound(n_ops, nbytes)
    print(f"  {name} pass, {num} rays, 8x8 tiles, {num_rows} fat rows: K6 "
          f"{times['K6'][0]!r} / {times['K6'][1]!r} ms, K6 counting {times['K6 counting'][0]!r} / "
          f"{times['K6 counting'][1]!r} ms (turns: K6, counting, counting, K6); bound "
          f"{b['bound_ms']!r} ms ({b['bound_by']}; {n_ops:.4g} ops, {nbytes} bytes: {n_rows} rows, "
          f"{n_entries} Tri entries); per ray: pops {float(counts['pops'].double().mean())!r}, box "
          f"tests {n_box / num!r}, triangle-entry tests "
          f"{float(counts['tri_entry_tests'].double().mean())!r}; plain version {plain_ms!r} ms; "
          f"counting K6 bit-equal to plain on every ray  [{card}]")
    return dict(ms=statistics.mean(times["K6 counting"]), plain_ms=plain_ms, **b)


def app_phase(device, card: str, fixtures: bool = False) -> dict:
    """Phase 13: the app's default run on the card (the render modes on
    the wide tracer), K6's counting instantiation against its plain
    version, the rock asset, and the split tracer's render modes."""
    print("phase 13: the app's default run: --type sah --tracer wide --bounces 0, "
          f"{APP_W}x{APP_H}, every render mode")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    scene_arg = f"terrain:{NUM_TRIS}"
    size = ["--width", str(APP_W), "--height", str(APP_H)]

    # the app with no flags at all, as a user first runs it: cornell,
    # 1024x768, mode 0, into ./out
    OUT_DIR.mkdir(parents=True)
    with contextlib.chdir(OUT_DIR):
        res, calls, wall, _ = run_app([])
    image = read_png(str(OUT_DIR / "out" / "frame0000_mode0.png"))
    require(image.shape == (768, 1024, 4) and calls == [(0, 1)],
            f"the no-flag run: image {image.shape}, counting launches {calls}")
    print(f"  no flags: cornell, out/frame0000_mode0.png {image.shape}, frame "
          f"{res['frames'][0][2]!r} ms, app wall {wall!r} s  [{card}]")
    del res

    # (a) the 1M scene through the app's default path
    fat_traverse.count_launch_count = 0
    fat_traverse.launch_count = 0
    torch.cuda.reset_peak_memory_stats()
    res, calls, wall, _ = run_app(["--scene", scene_arg, "--pairs", "--cycle-modes", *size,
                                   "--frames", str(APP_FRAMES), "--output",
                                   str(OUT_DIR / "terrain_wide")])
    launches = fat_traverse.count_launch_count
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    require(fat_traverse.launch_count == 0, "the wide tracer launched K6 without counts")
    require(len(calls) == NUM_MODES * APP_FRAMES and all(n > 0 for _, n in calls),
            f"a mode launched no counting K6: {calls}")
    stages = dict(res["stages"])
    depth = fat_traverse.binary_depth(res["bvh"])
    images = mode_images(res)
    lit = check_mode_images("terrain wide", images, APP_FRAMES)
    for m in range(NUM_MODES):
        require(np.array_equal(images[(0, m)], images[(APP_FRAMES - 1, m)]),
                f"mode {m}: frames 0 and {APP_FRAMES - 1} differ with one camera")
    ms = frame_ms_by_mode(res)
    print(f"  terrain1M wide: SAH binary build {stages['SharedTaskBuild     ']!r} ms, fat collapse "
          f"{stages['WideFatCollapse     ']!r} ms ({int(res['trav'].num_nodes)} rows, binary "
          f"depth {depth}); app wall {wall!r} s; peak {peak_mib!r} MiB  [{card}]")
    for m in range(NUM_MODES):
        print(f"  terrain1M wide mode {m} ({RenderType(m).name}): frame ms "
              + " / ".join(f"{ms[(f, m)]!r}" for f in range(APP_FRAMES))
              + f" (render and read-back, frames 0..{APP_FRAMES - 1}); counting K6 launches "
              f"{[n for mm, n in calls if mm == m]}  [{card}]")
    print(f"  counting K6 launches on the app's path = {launches}; non-black share by mode "
          f"(the default camera sits at the scene's centre, on the terrain): {lit}")
    aerial = aerial_modes(card, res)
    k6c = counting_checks(card, res, aerial, fixtures)
    wide_images = {m: images[(0, m)] for m in range(NUM_MODES)}
    del res, images

    # (d) the split tracer's render modes on the same scene
    res, _, wall, _ = run_app(["--scene", scene_arg, "--pairs", "--cycle-modes", "--tracer",
                               "split", *size, "--output", str(OUT_DIR / "terrain_split")])
    images = mode_images(res)
    lit = check_mode_images("terrain split", images, 1)
    ms = frame_ms_by_mode(res)
    dbs = {m: psnr(images[(0, m)], wide_images[m]) for m in range(NUM_MODES)}
    print(f"  terrain1M split (K1): app wall {wall!r} s; frame ms by mode "
          + ", ".join(f"{m}: {ms[(0, m)]!r}" for m in range(NUM_MODES)) + f"  [{card}]")
    print("  terrain1M split against wide, PSNR dB by mode: "
          + ", ".join(f"{m}: {db:.2f}" for m, db in dbs.items()) + f"; non-black share {lit}")
    for m in SPLIT_PSNR_MODES:
        require(dbs[m] >= MIN_PSNR, f"split mode {m}: {dbs[m]:.2f} dB against wide")
    del res, images, wide_images

    # (c) the rock: generated, loaded by both parsers, all modes on K6 and
    # on trace_rays over the same SAH tree
    t0 = time.perf_counter()
    path = genasset.generate_rock(str(OUT_DIR / "rock_asset"), subdivisions=ROCK_SUBDIVISIONS)
    gen_s = time.perf_counter() - t0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        scene_n = objio.load_obj(path)
    native_s = time.perf_counter() - t0
    require("OBJ parser: native" in buf.getvalue(), f"the native parser did not run: "
                                                    f"{buf.getvalue()!r}")
    native_parse = objio._try_native_parse
    objio._try_native_parse = lambda f: None  # the Python parser, as the tests force it
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            scene_p = objio.load_obj(path)
    finally:
        objio._try_native_parse = native_parse
    python_s = time.perf_counter() - t0
    for f in ("triangles", "normals", "uvs", "material_ids", "aabb_min", "aabb_max", "light"):
        require(np.array_equal(getattr(scene_n, f), getattr(scene_p, f)),
                f"rock: native and Python parsers differ on {f}")
    require(all(np.array_equal(a, b) for tn, tp in zip(scene_n.library.textures,
                                                       scene_p.library.textures)
                for a, b in zip(tn.mips, tp.mips)), "rock: textures differ")
    print(f"  rock: {scene_n.num_triangles} triangles, {len(scene_n.library.textures)} texture(s) "
          f"({scene_n.library.textures[0].mips[0].shape}); generated in {gen_s:.2f} s, native "
          f"parse {native_s:.2f} s ({native_loader.SRC.name}), Python parse {python_s:.2f} s; "
          f"the two parsers' arrays equal  [{card}]")
    fat_traverse.count_launch_count = 0
    res_w, calls_w, wall_w, _ = run_app([path, "--cycle-modes", *size, "--output",
                                         str(OUT_DIR / "rock_wide")])
    require(all(n > 0 for _, n in calls_w), f"rock: a mode launched no counting K6: {calls_w}")
    res_s, _, wall_s, _ = run_app([path, "--cycle-modes", "--tracer", "scalar", *size,
                                   "--output", str(OUT_DIR / "rock_scalar")])
    img_w, img_s = mode_images(res_w), mode_images(res_s)
    print(f"  rock non-black share by mode: {check_mode_images('rock wide', img_w, 1)}")
    check_mode_images("rock scalar", img_s, 1)
    ms_w, ms_s = frame_ms_by_mode(res_w), frame_ms_by_mode(res_s)
    for m in range(NUM_MODES):
        a, b = img_w[(0, m)], img_s[(0, m)]
        db = psnr(a, b)
        colours = len(np.unique(a[..., :3].reshape(-1, 3), axis=0))
        print(f"  rock mode {m} ({RenderType(m).name}): K6 {ms_w[(0, m)]!r} ms, trace_rays "
              f"{ms_s[(0, m)]!r} ms, PSNR {db:.2f} dB, {colours} colours  [{card}]")
        if m in ROCK_PSNR_MODES:
            require(db >= MIN_PSNR, f"rock mode {m}: {db:.2f} dB between K6 and trace_rays")
        if m in TEXTURED_MODES:
            require(colours > 1, f"rock mode {m} shows one colour: no texel was read")
    print(f"  rock: app wall {wall_w!r} s (wide), {wall_s!r} s (scalar); SAH build "
          f"{dict(res_w['stages'])['SharedTaskBuild     ']!r} ms, fat collapse "
          f"{dict(res_w['stages'])['WideFatCollapse     ']!r} ms  [{card}]")
    return dict(launches=launches, **k6c)


def stage_ms(stages, *names) -> float:
    """The summed ms of the named StageTimer stages (names unpadded)."""
    return sum(ms for name, ms in stages if name.strip() in names)


def k1_sample_stats(views, captured: dict) -> dict:
    """K1 on 65,536 live rays sampled from each of a frame's four passes:
    the mean inner and leaf pops per ray, and K1's CUDA-event ms on the
    whole pass (3 launches after a warm one)."""
    inner, pairs, stack_cap = views
    kw = dict(leafw=split_trace.LEAFW, stack_cap=stack_cap)
    out = {}
    for (key, any_hit), name in zip(FRAME_TRACERS, PASSES):
        rays, _ = live_sample(captured[key].rays, captured[key].active)
        kout = split_trace.split_traverse(inner, pairs, *split_trace.kernel_operands(rays, None),
                                          any_hit=any_hit, **kw)
        ops, _ = pass_operands(key, captured[key])
        ms, _ = event_ms(lambda: split_trace.split_traverse(inner, pairs, *ops, any_hit=any_hit,
                                                            **kw), 3)
        out[name] = dict(inner=float(kout[2].float().mean()), leaf=float(kout[3].float().mean()),
                         ms=ms)
    return out


def refit_run(device, card: str, build_type: str, frames: int, rebuild_ms) -> dict:
    """Phase 14 (a, b): the app's refit schedule on the split tree at 1M,
    1024x1024, 1 bounce, then the last (refitted) frame's checks: the card's
    refit against the CPU's, K1 against its plain version on each pass's
    sample, the image against a full rebuild at the same t, brute force."""
    tag = f"refit {build_type}"
    split_trace.launch_count = 0
    res, _, wall, out = run_app(
        ["--scene", f"terrain:{NUM_TRIS}", "--pairs", "--tracer", "split", "--type", build_type,
         "--bounces", str(BOUNCES), "--width", str(RES), "--height", str(RES), "--animate",
         "--refit", "--refit-interval", str(REFIT_INTERVAL), "--frames", str(frames),
         "--output", str(OUT_DIR / f"refit_{build_type}")])
    launches = split_trace.launch_count
    require(launches >= 4 * frames, f"{tag}: K1 launched {launches} times in {frames} frames")
    sched, recs = res["sched"], res["animated"]
    frame_ms = {f: ms for f, _, ms, _ in res["frames"]}
    build0 = stage_ms(res["stages"], "SplitBuild")
    print(f"  {tag} frame 0: build, split tree {build0!r} ms (the --type tree "
          f"{stage_ms(res['stages'], 'BottomUpBuild', 'SharedTaskBuild')!r} ms), frame "
          f"{frame_ms[0]!r} ms  [{card}]")
    for rec in recs:
        st_ = rec["stages"]
        ratio = None if rec["sa_ratio"] is None else float(rec["sa_ratio"])
        print(f"  {tag} frame {rec['frame']} (t={rec['t']:.2f}): {rec['kind']}, animate "
              f"{stage_ms(st_, 'Animate')!r} ms, deform {stage_ms(st_, 'DeformRows')!r} ms, "
              f"{rec['kind']} {stage_ms(st_, 'RefitSchedule')!r} ms, SA ratio {ratio!r}, frame "
              f"{frame_ms[rec['frame']]!r} ms  [{card}]")
    for line in out.splitlines():
        if line.startswith("refit schedule:"):
            print(f"  {tag}: {line}")
    sched_ms = [stage_ms(r["stages"], "DeformRows", "RefitSchedule") for r in recs]
    amortised = statistics.mean(sched_ms)
    print(f"  {tag}: amortised build {amortised!r} ms a frame over frames 1-{frames - 1} "
          f"(deform and refit or rebuild; {sched.rebuild_count} rebuilds), phase 3's full "
          f"rebuild {rebuild_ms!r} ms; app wall {wall!r} s; K1 launches {launches}  [{card}]")
    require(recs[-1]["kind"] == "refit", f"{tag}: the last frame was not a refit")

    # (b) the refitted frame: the card's refit against the CPU's
    views, packed = res["trav"], res["packed"]
    cpu_tree = dataclasses.replace(
        sched.split0, **{f: getattr(sched.split0, f).cpu()
                         for f in ("inner", "num_inner", "num_leaves", "e_ranges")})
    cpu = bucket.refit_split(cpu_tree, PackedPairs(rows=packed.rows.cpu()))
    card_words = views[0].cpu().reshape(cpu.inner.shape)
    bad = int((cpu.inner != card_words).sum())
    print(f"  {tag}: refit words differing between the card and the CPU: {bad} of "
          f"{cpu.inner.numel()} (as floats: {int((i2f(cpu.inner) != i2f(card_words)).sum())})")
    require(bad == 0, f"{tag}: the card's refit differs from the CPU's in {bad} words")

    # the same frame traced on the refitted tree and on a full rebuild at
    # the same t, with the same seed, from the aerial camera
    with contextlib.redirect_stdout(io.StringIO()):
        args = parse_cmd(["--scene", f"terrain:{NUM_TRIS}", "--pairs", "--tracer", "split",
                          "--type", build_type])
    t = recs[-1]["t"]
    scene = procedural.terrain(NUM_TRIS)
    triangles = procedural.animate_triangles(torch.as_tensor(scene.triangles, device=device), t)
    camera = aerial_camera(scene, device)
    dev_scene = res["scene"]
    captured = {k: Capture(v) for k, v in split_trace.make_frame_tracers(RES, RES).items()}
    img, _ = frame_fn(views, packed, dev_scene, camera, device, **captured)(7, 0.0)
    fresh, fresh_packed = app_main.split_tree(args, triangles)
    fresh_views = app_main.split_tree_views(args, fresh, fresh_packed)
    fresh_cap = {k: Capture(v) for k, v in split_trace.make_frame_tracers(RES, RES).items()}
    img_r, _ = frame_fn(fresh_views, fresh_packed, dev_scene, camera, device, **fresh_cap)(7, 0.0)
    db = frame_psnr(img, img_r)
    print(f"  {tag} t={t:.2f}: refitted frame against a full rebuild, same seed: {db!r} dB; "
          f"stack bound {views[2]} (rebuilt tree's {fresh_views[2]})")
    require(bool(torch.isfinite(img).all()) and db >= MIN_PSNR,
            f"{tag}: the refitted frame is {db:.2f} dB from the rebuilt one")
    agree = Agreement()
    for key, any_hit in FRAME_TRACERS:
        rays, n_live = live_sample(captured[key].rays, captured[key].active)
        hits = agree.check(f"{tag} refitted {key} ({n_live} live)", views, rays, None, any_hit)
        require(hits > 0, f"{tag} {key}: no ray of the sample hits, so it checks nothing")
    refit_k1, fresh_k1 = k1_sample_stats(views, captured), k1_sample_stats(fresh_views, fresh_cap)
    for name in PASSES:
        a, b = refit_k1[name], fresh_k1[name]
        print(f"  {tag} {name} pass: K1 {a['ms']!r} ms refitted / {b['ms']!r} ms rebuilt; pops "
              f"per sampled live ray inner {a['inner']!r} / {b['inner']!r}, leaf {a['leaf']!r} / "
              f"{b['leaf']!r}  [{card}]")
    rays = captured["tracer"].rays
    pick = torch.linspace(0, rays.origin.shape[0] - 1, BRUTE_RAYS, device=device).round().long()
    brute_check("primary", views, packed, rays.take(pick), triangles, tree=f"{tag} refitted tree")

    # one more animated frame under the profiler: the geometry moved, the
    # rows deformed, the schedule's step and the path-traced frame
    with contextlib.redirect_stdout(io.StringIO()):
        sargs = parse_cmd(["--tracer", "split", "--type", build_type, "--pairs", "--refit"])
    rest = {}

    def animated_frame(seed, jitter):
        trav, packed_t, _, _ = app_main.animated_trees(
            sargs, triangles0, t + app_main.ANIMATE_DT, views, sched, rest)
        return frame_fn(trav, packed_t, dev_scene, camera, device,
                        **split_trace.make_frame_tracers(RES, RES))(seed, jitter)

    triangles0 = torch.as_tensor(scene.triangles, device=device)
    sched.max_interval = 0  # the periodic cap off: both frames below refit
    animated_frame(ITERS, 0.0)  # warm: the rest rows of the last rebuild
    profile_frame(f"{tag} animated", animated_frame, card)
    return dict(launches=launches, amortised_ms=amortised, max_abs_err=agree.max_abs_err)


def rebuild_runs(card: str) -> dict:
    """Phase 14 (c): per-frame rebuilds through the app at 1M, 1024x768,
    DIFFUSE, 3 frames: --tracer wide with each --type, and --tracer lane.
    Each frame's rebuild ms; the hybrid tree's images against the SAH
    tree's; the last hybrid tree's checks and K6's counting instantiation
    against its plain version on its primary passes."""
    size = ["--width", str(APP_W), "--height", str(APP_H)]
    out, images = {"k6c": 0, "k5": 0}, {}
    for tracer, build_type in REBUILD_RUNS:
        tag = f"rebuild {tracer} {build_type}"
        fat_traverse.count_launch_count = 0
        lane_trace.launch_count = 0
        res, calls, wall, _ = run_app(
            ["--scene", f"terrain:{NUM_TRIS}", "--pairs", "--tracer", tracer, "--type",
             build_type, "--render-mode", str(DIFFUSE_MODE), *size, "--animate", "--frames",
             str(REBUILD_FRAMES), "--output", str(OUT_DIR / f"rebuild_{tracer}_{build_type}")])
        frame_ms = {f: ms for f, _, ms, _ in res["frames"]}
        recs = [dict(frame=0, stages=res["stages"])] + res["animated"]
        for rec in recs:
            stages = [(n.strip(), ms) for n, ms in rec["stages"]]
            print(f"  {tag} frame {rec['frame']}: "
                  + ", ".join(f"{n} {ms!r}" for n, ms in stages)
                  + f" ms; frame {frame_ms[rec['frame']]!r} ms  [{card}]")
        print(f"  {tag}: app wall {wall!r} s")
        if tracer == "wide":
            require(len(calls) == REBUILD_FRAMES and all(n > 0 for _, n in calls),
                    f"{tag}: a frame launched no counting K6: {calls}")
            out["k6c"] += fat_traverse.count_launch_count
        else:
            require(lane_trace.launch_count >= REBUILD_FRAMES,
                    f"{tag}: K5 launched {lane_trace.launch_count} times")
            out["k5"] += lane_trace.launch_count
        images[(tracer, build_type)] = mode_images(res)
        if build_type == "hybrid":
            hybrid_res = res
        del res
    for (f, m), img in images[("wide", "hybrid")].items():
        db = psnr(img, images[("wide", "sah")][(f, m)])
        print(f"  hybrid against SAH tree, frame {f}: {db!r} dB")
        require(db >= MIN_PSNR, f"hybrid frame {f}: {db:.2f} dB from the SAH tree's")

    # the last frame's hybrid tree: host checks and K6's counting
    # instantiation against its plain version on its primary passes
    bvh = hybrid_res["bvh"]
    t0 = time.perf_counter()
    stats, errors = count_nodes(bvh), verify_hierarchy(bvh)
    print(f"  hybrid tree (frame {REBUILD_FRAMES - 1}): {bvh.num_slots} slots, root "
          f"{int(bvh.root)} (count {int(bvh.root_count)}), binary depth "
          f"{fat_traverse.binary_depth(bvh)}, {stats}, verify_hierarchy errors {len(errors)} "
          f"({time.perf_counter() - t0:.2f} s)")
    require(not errors and int(bvh.root_count) == 1, f"hybrid tree: {len(errors)} errors")
    # the hybrid build's parts at 1M (synchronised, ITERS runs after a warm
    # one): the LBVH, the sub-root extraction, and the rest (the arena and
    # the SAH frontier over the sub-roots)
    triangles = torch.as_tensor(procedural.terrain(NUM_TRIS).triangles, device=bvh.child.device)
    base, _ = lbvh.build_lbvh(triangles, True)
    parts = {}
    for name, fn in (("build_lbvh", lambda: lbvh.build_lbvh(triangles, True)),
                     ("extract_depth", lambda: hybrid.extract_depth(base)),
                     ("build_hybrid", lambda: hybrid.build_hybrid(triangles, True))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        parts[name] = sync_ms(t0) / ITERS
    print(f"  hybrid build parts: build_lbvh {parts['build_lbvh']!r} ms, extract_depth "
          f"{parts['extract_depth']!r} ms, arena and SAH frontier "
          f"{parts['build_hybrid'] - parts['build_lbvh'] - parts['extract_depth']!r} ms, "
          f"build_hybrid {parts['build_hybrid']!r} ms  [{card}]")
    del triangles, base
    fat = hybrid_res["trav"]
    rows256 = wide_fat.live_rows256(fat)
    camera = aerial_camera(procedural.terrain(NUM_TRIS), rows256.device)
    max_err = 0.0
    for label, cam_dev in (("app", hybrid_res["camera"]), ("aerial", camera)):
        primary = generate_primary_rays(cam_dev, APP_W, APP_H)
        tiled = Rays(*(tile_reorder(getattr(primary, f), APP_W, APP_H, 8, 8)
                       for f in ("origin", "direction", "tmin", "tmax")))
        sample, n_live = live_sample(tiled, None)
        ops = fat_traverse.kernel_operands(sample)
        kout = fat_traverse.fat_traverse(rows256, *ops, count=True)
        counts = {}
        pout = fat_traverse.trace_fat_plain(rows256, *ops, counts=counts)
        bad = count_mismatches(kout, pout, counts)
        hits = int(pout[0].sum())
        print(f"  hybrid {label} primary pass: {sample.origin.shape[0]} of {n_live} rays, {hits} "
              f"hits; counting K6 mismatches hit/t/prim/tri/u/v/overflow/box/entry={bad}")
        require(sum(bad) == 0 and hits > 0, f"hybrid {label}: counting K6 != plain on {bad}")
        hit = kout[0] != 0
        max_err = max(max_err, float((kout[1] - pout[1])[hit].abs().max()))
    out["max_abs_err"] = max_err
    return out


def profile_runs(card: str) -> None:
    """Phase 14 (d): --profile-build at 1M for each --type and for the
    split tracer's bucket build; the app prints the stage lines."""
    for flags in (["--type", "sah"], ["--type", "bottom-up"], ["--type", "hybrid"],
                  ["--type", "bottom-up", "--tracer", "split"]):
        print(f"  --profile-build {' '.join(flags)}:  [{card}]")
        _, _, wall, out = run_app(["--scene", f"terrain:{NUM_TRIS}", "--pairs", "--profile-build",
                                   "--width", "256", "--height", "192", *flags, "--output",
                                   str(OUT_DIR / "profile")])
        require(" time elapsed: " in out, f"--profile-build {flags}: no stage line")


def interactive_run(card: str) -> None:
    """Phase 14 (e): --interactive in a pseudo-terminal on the card: w, the
    right arrow, m, p and x; every read with its own time limit; exit 0 and
    the PNG decodes."""
    import fcntl
    import os
    import pty
    import re
    import select
    import struct
    import termios

    out_dir = OUT_DIR / "interactive"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    err_path = out_dir / "stderr.txt"
    master, slave = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH", 40, 200, 0, 0))
    t0 = time.perf_counter()
    with open(err_path, "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "tpu_raytracing_torch.app.main", "--scene", "cornell",
             "--width", str(INTERACTIVE_W), "--height", str(INTERACTIVE_H), "--interactive",
             "--output", str(out_dir)],
            stdin=slave, stdout=slave, stderr=err, cwd=str(Path(__file__).parent))
    os.close(slave)
    status = re.compile(rb"mode=(\w+)  fps=(\S+)  pos=\(([-\d.]+),([-\d.]+),([-\d.]+)\) "
                        rb"yaw=([-\d.]+)")

    def fail(what):
        code = proc.poll()
        err = err_path.read_text(errors="replace")[-2000:]
        raise RuntimeError(f"interactive: no {what} after {time.perf_counter() - t0:.1f} s "
                           f"(exit code {code}); stderr: {err}")

    def until(what, limit, pred=lambda m: True):
        """Read the terminal until a status line satisfies ``pred``; the
        scan covers only the newest bytes (a frame is ~300 KB)."""
        buf, end = b"", time.monotonic() + limit
        while time.monotonic() < end:
            if select.select([master], [], [], 0.5)[0]:
                try:
                    buf = (buf + os.read(master, 1 << 16))[-(1 << 20):]
                except OSError:
                    fail(what)
            for m in reversed(list(status.finditer(buf))):
                if pred(m):
                    return m
            if proc.poll() is not None:
                fail(what)
        fail(what)

    try:
        first = until("first frame", INTERACTIVE_FIRST_S)
        first_s = time.perf_counter() - t0
        pos0, yaw0 = first.group(3, 4, 5), first.group(6)
        os.write(master, b"w\x1b[C")
        until("moved frame", INTERACTIVE_READ_S,
              lambda m: m.group(3, 4, 5) != pos0 and m.group(6) != yaw0)
        os.write(master, b"m")
        moved = until("BOX_TESTS frame", INTERACTIVE_READ_S, lambda m: m.group(1) == b"BOX_TESTS")
        os.write(master, b"p")
        shot, end = out_dir / "shot0000.png", time.monotonic() + INTERACTIVE_READ_S
        while not shot.is_file() and time.monotonic() < end:
            until("frame after the shot", INTERACTIVE_READ_S)
        img = read_png(str(shot))
        os.write(master, b"x")
        end = time.monotonic() + INTERACTIVE_READ_S
        while proc.poll() is None and time.monotonic() < end:
            if select.select([master], [], [], 0.5)[0]:
                try:
                    os.read(master, 1 << 16)
                except OSError:
                    pass
        code = proc.poll()
        print(f"  interactive: first frame after {first_s:.2f} s (process start included), "
              f"fps {moved.group(2).decode()} at {INTERACTIVE_W}x{INTERACTIVE_H}, shot "
              f"{img.shape}, exit code {code}  [{card}]")
        require(code == 0, f"interactive: exit code {code}: {err_path.read_text()[-1000:]}")
        require(img.shape == (INTERACTIVE_H, INTERACTIVE_W, 4), f"interactive shot {img.shape}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        os.close(master)


def animate_phase(device, card: str, rebuild_ms=None) -> dict:
    """Phase 14: the app's animated run on the card."""
    print("phase 14: the app's animated run: the refit schedule on the split trees, per-frame "
          "rebuilds on the wide and lane tracers, --profile-build, --interactive")
    (OUT_DIR).mkdir(parents=True, exist_ok=True)
    out = {"k1": 0}
    for build_type, frames in REFIT_RUNS:
        res = refit_run(device, card, build_type, frames, rebuild_ms)
        out["k1"] += res["launches"]
        out[f"refit {build_type}"] = res
    out.update(rebuild_runs(card))
    profile_runs(card)
    interactive_run(card)
    print(f"  phase 14 launches: K1 {out['k1']}, K5 {out['k5']}, counting K6 {out['k6c']}")
    return out



def grid_frame(device, card: str, scene, dev_scene, camera, triangles, split_img) -> dict:
    """Phase 15 (a): the uniform grid on phase 3's scene: its build (one
    warm, ITERS timed) at ``auto_res3`` over the scene's box, a 1-bounce
    frame with the grid's closest-hit tracer and its any-hit tracer for the
    shadows, brute force on sampled primary and bounce rays, and the
    residue and segment schedules against the single-phase walk."""
    res3 = grid.auto_res3(scene.aabb_max - scene.aabb_min, scene.num_triangles)
    tiers = grid.tier_params(1.0)

    def build(tris):
        return grid.build_grid_from_triangles(tris, True, res=res3, **tiers)

    ugrid, packed = build(triangles)
    grid.check_grid_capacity(ugrid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ITERS):
        build(triangles + (i + 1) * 1e-5)
    build_ms = sync_ms(t0) / ITERS
    live_refs = int(ugrid.cell_count.sum())
    print(f"  grid build: {build_ms!r} ms, res {ugrid.res}, refs {live_refs} live of "
          f"{ugrid.refs.shape[0]}, big list {int(ugrid.num_big)}, overflow "
          f"{int(ugrid.overflow)}  [{card}]")

    tracers = dict(tracer=grid_trace.make_grid_tracer(),
                   shadow_tracer=grid_trace.make_grid_tracer(any_hit=True),
                   bounce_tracer=grid_trace.make_grid_tracer(),
                   shadow_tracer_bounce=grid_trace.make_grid_tracer(any_hit=True))
    captured = {k: Capture(v) for k, v in tracers.items()}
    frame = frame_fn(ugrid, packed, dev_scene, camera, device, **captured)
    frame(0, 0.0)
    img, frame_ms, total_rays = timed_frames(frame)
    require(bool(torch.isfinite(img).all()), "grid frame has non-finite pixels")
    db = frame_psnr(img, split_img)
    mrays = total_rays / (frame_ms * ITERS) / 1000.0
    print(f"  grid frame: {RES}x{RES}, {BOUNCES} bounce, {frame_ms!r} ms, {mrays!r} Mrays/s, "
          f"{total_rays} rays in {ITERS} frames, {db!r} dB from phase 3's split frame  [{card}]")
    require(db >= MIN_PSNR, f"grid frame: {db:.2f} dB from the split frame")

    for key, label in (("tracer", "grid primary"), ("bounce_tracer", "grid bounce")):
        cap = captured[key]
        rays, _ = live_sample(cap.rays, cap.active, BRUTE_RAYS)
        brute_check(label, None, packed, rays, triangles, tree="grid",
                    tracer=lambda v, p, r: grid_trace.trace_rays_grid(ugrid, p, r))

    # the reference's tail cures: the same walk in another schedule, on
    # SLICE live rays sampled evenly from the bounce pass
    cap = captured["bounce_tracer"]
    sample, alive = live_sample(cap.rays, cap.active)
    n = sample.origin.shape[0] // GRID_SEGMENTS * GRID_SEGMENTS
    sample = sample.take(torch.arange(n, device=device))

    def run(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec, stats = grid_trace.trace_rays_grid(ugrid, packed, sample, **kw)
        return rec, stats, sync_ms(t0)

    base, base_stats, base_ms = run()
    print(f"  grid bounce pass: {alive} live rays; a sample of {n}: single phase {base_ms!r} ms, "
          f"mean steps per ray {float(base_stats.box_tests.float().mean())!r}, most "
          f"{int(base_stats.box_tests.max())}  [{card}]")
    for kw in (dict(residue_after=GRID_RESIDUE_AFTER), dict(segments=GRID_SEGMENTS)):
        rec, stats, ms = run(**kw)
        bad = {f: int((getattr(rec, f).view(torch.int32) != getattr(base, f).view(torch.int32))
                      .sum()) if getattr(rec, f).dtype == torch.float32 else
               int((getattr(rec, f) != getattr(base, f)).sum())
               for f in ("hit", "t", "prim_id", "tri_id", "bary_u", "bary_v")}
        bad["steps"] = int((stats.box_tests != base_stats.box_tests).sum())
        bad["tri_tests"] = int((stats.tri_tests != base_stats.tri_tests).sum())
        print(f"  grid bounce sample with {kw}: {ms!r} ms, mismatches {bad}  [{card}]")
        require(sum(bad.values()) == 0, f"grid {kw}: differs from the single phase: {bad}")
    return dict(build_ms=build_ms, frame_ms=frame_ms, mrays_per_s=mrays, psnr_db=db)


def grid_app_runs(card: str) -> None:
    """Phase 15 (b): the app's --tracer grid at 1M, 1024x768, DIFFUSE:
    with --grid-scale 0.5, then --animate for REBUILD_FRAMES frames with
    each frame's grid rebuild."""
    size = ["--width", str(APP_W), "--height", str(APP_H)]
    common = ["--scene", f"terrain:{NUM_TRIS}", "--pairs", "--type", "sah", "--tracer", "grid",
              "--render-mode", str(DIFFUSE_MODE), *size]
    for tag, extra in ((f"--grid-scale {GRID_SCALE}", ["--grid-scale", str(GRID_SCALE)]),
                       ("--animate", ["--animate", "--frames", str(REBUILD_FRAMES)])):
        res, _, wall, _ = run_app(common + extra + ["--output", str(OUT_DIR / "grid_app")])
        stages = dict(res["stages"])
        frame_ms = {f: ms for f, _, ms, _ in res["frames"]}
        print(f"  app --tracer grid {tag}: frame 0 grid build "
              f"{stages[app_main.REBUILD_STAGES['grid']]!r} ms, res {res['trav'].res}, frame "
              f"ms {[frame_ms[f] for f in sorted(frame_ms)]!r}, app wall {wall!r} s  [{card}]")
        for rec in res["animated"]:
            st = dict(rec["stages"])
            print(f"    animated frame {rec['frame']}: grid rebuild "
                  f"{st[app_main.REBUILD_STAGES['grid']]!r} ms  [{card}]")
        images = mode_images(res)
        for key, img in images.items():
            require(img.shape == (APP_H, APP_W, 4) and bool(img[..., :3].any()),
                    f"grid app {tag} {key}: an empty image")
        require(len(images) == (REBUILD_FRAMES if "animate" in tag else 1),
                f"grid app {tag}: {len(images)} images")


def packet_runs(card: str, device) -> dict:
    """Phase 15 (c): the app's --tracer packet at 1M on the Karras tree,
    DEPTH and DIFFUSE at 1024x768; then the packet tracer against K6's
    wide tracer on the same tree from phase 3's aerial camera."""
    out = {}
    for mode in PACKET_MODES:
        res, _, wall, _ = run_app(["--scene", f"terrain:{NUM_TRIS}", "--pairs", "--type",
                                   "bottom-up", "--tracer", "packet", "--render-mode", str(mode),
                                   "--width", str(APP_W), "--height", str(APP_H), "--output",
                                   str(OUT_DIR / "packet_app")])
        (_, _, ms, path), = res["frames"]
        img = read_png(path)
        require(img.shape == (APP_H, APP_W, 4) and bool((img[..., 3] == 255).all()),
                f"packet mode {mode}: image {img.shape}")
        out[mode] = ms
        print(f"  app --tracer packet mode {mode}: frame {ms!r} ms, app wall {wall!r} s  "
              f"[{card}]")
    bvh, trav, packed = res["bvh"], res["trav"], res["packed"]
    camera = aerial_camera(procedural.terrain(NUM_TRIS), device)
    rays = generate_primary_rays(camera, APP_W, APP_H)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec, stats = res["tracer"](trav, packed, rays)
    packet_ms = sync_ms(t0)
    fat = wide.build_wide_fat(bvh, packed.rows)
    ref, _ = wide_fat.make_tiled_fat_tracer(None, APP_W, APP_H, 8, 8)(fat, packed, rays)
    num = rays.origin.shape[0]
    both = rec.hit & ref.hit
    bad_hit = int((rec.hit != ref.hit).sum())
    bad_t = int((both & ((rec.t - ref.t).abs() > T_RTOL * ref.t.abs())).sum())
    bad_tri = int((both & (rec.tri_id != ref.tri_id) & (rec.t != ref.t)).sum())
    ties = int((both & (rec.tri_id != ref.tri_id) & (rec.t == ref.t)).sum())
    print(f"  packet against K6, aerial camera, {num} rays: packet trace {packet_ms!r} ms, "
          f"{int(ref.hit.sum())} hits, mismatches hit={bad_hit} t={bad_t} tri={bad_tri} "
          f"(exact-t ties naming the other triangle: {ties}), overflow {int(stats.overflow)}  "
          f"[{card}]")
    require(int(stats.overflow) == 0 and int(ref.hit.sum()) > 0, "packet: overflow or no hit")
    for what, count in (("hit", bad_hit), ("t", bad_t), ("tri", bad_tri)):
        require(count <= (1.0 - BRUTE_AGREE) * num,
                f"packet and K6 disagree on {what} for {count} rays")
    out["aerial_ms"] = packet_ms
    return out


class ItemRecorder:
    """Wraps ``split_trace.trace_rays_split``: keeps the (views, rays,
    active) of every call, the instanced tracer's object-space passes."""

    def __init__(self):
        self.fn = split_trace.trace_rays_split
        self.calls = []

    def __call__(self, views, packed, rays, active=None, **kw):
        self.calls.append((views, rays, active))
        return self.fn(views, packed, rays, active=active, **kw)


def config4(device) -> dict:
    """Config 4 of benchmarks/bench_configs.py:257-380: ``sphere_scene(4)``
    as the BLAS (its Karras tree and its bucket split tree), INST_COUNT
    instances from ``default_rng(3)``, primary rays at INST_RES²."""
    scene = procedural.sphere_scene(INST_SUBDIV)
    tris = torch.as_tensor(scene.triangles, device=device)
    blas, pairs = lbvh.build_lbvh(tris, True)
    rng = np.random.default_rng(3)
    base_t = rng.uniform(-40, 40, (INST_COUNT, 3)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (INST_COUNT, 1, 1)).astype(np.float32)
    mats = (np.broadcast_to(np.eye(3, dtype=np.float32), (INST_COUNT, 3, 3)) * scale)
    transforms = torch.as_tensor(np.concatenate([mats, base_t[:, :, None]], axis=2)
                                 .astype(np.float32), device=device)
    wmin, wmax = tlas.instance_world_aabbs(blas.node_min[blas.root.long()],
                                           blas.node_max[blas.root.long()], transforms)
    lo, hi = wmin.amin(dim=0).cpu().numpy(), wmax.amax(dim=0).cpu().numpy()
    camera = cam.camera_to_device(cam.update_camera(cam.initialise_camera(lo, hi)), device)
    views, packed_s, split = bucket.emit_split_views(bucket.split_front(tris, True),
                                                     leaf_width=split_trace.LEAFW)
    bucket.check_split_capacity(split, tris.shape[0])
    return dict(scene=scene, tris=tris, blas=blas, packed=pack_pairs(pairs),
                transforms=transforms, rays=generate_primary_rays(camera, INST_RES, INST_RES),
                views=views, packed_s=packed_s, num_leaves=int(split.num_leaves),
                blas_lo=tris.reshape(-1, 3).amin(dim=0), blas_hi=tris.reshape(-1, 3).amax(dim=0))


def instanced_split_frame(c4: dict, transforms):
    """The split-kernel instanced tracer on config 4's rays, ``k_slots``
    from ``max_overlap`` and ``item_budget`` from a first trace's guard (a
    candidate overflow raises): (k_slots, budget, guard of the first
    trace, (record, instance, stats, guard))."""
    ias_s = instanced_split.build_instanced_split(c4["views"], c4["packed_s"], c4["blas_lo"],
                                                  c4["blas_hi"], transforms)
    mo = instanced_split.max_overlap(ias_s, c4["rays"])
    k_slots = max(4, -(-(mo + 2) // 4) * 4)
    _, _, _, guard0 = instanced_split.trace_rays_instanced_split(ias_s, c4["rays"],
                                                                 k_slots=k_slots)
    instanced_split.check_candidate_capacity(guard0, k_slots)
    budget = -(-int(guard0[1]) * 13 // (10 * 256)) * 256
    out = instanced_split.trace_rays_instanced_split(ias_s, c4["rays"], k_slots=k_slots,
                                                     item_budget=budget)
    instanced_split.check_candidate_capacity(out[3], k_slots, budget)
    split_trace.check_overflow(out[2].overflow)
    return mo, k_slots, budget, guard0, out


def instanced_phase(device, card: str) -> dict:
    """Phase 15 (d): config 4 of benchmarks/bench_configs.py:257-380 on the
    card. Returns K1's launches in the timed instanced frames."""
    c4 = config4(device)
    scene, tris, blas, packed = c4["scene"], c4["tris"], c4["blas"], c4["packed"]
    transforms, rays, views, packed_s = c4["transforms"], c4["rays"], c4["views"], c4["packed_s"]
    blas_lo, blas_hi = c4["blas_lo"], c4["blas_hi"]

    def jitter(j):
        tf = transforms.clone()
        tf[:, :, 3] += j
        return tf

    def build_ms(fn):
        fn(jitter(0.0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(ITERS):
            out = fn(jitter((i + 1) * 1e-3))
        return sync_ms(t0) / ITERS, out

    stack_build_ms, _ = build_ms(lambda tf: tlas.build_instanced(blas, tf))
    split_build_ms, _ = build_ms(lambda tf: instanced_split.build_instanced_split(
        views, packed_s, blas_lo, blas_hi, tf))
    ias = tlas.build_instanced(blas, transforms)
    ias_s = instanced_split.build_instanced_split(views, packed_s, blas_lo, blas_hi, transforms)
    mo, k_slots, budget, guard0, _ = instanced_split_frame(c4, transforms)
    print(f"  config 4: {INST_COUNT} instances of {scene.num_triangles} tris, {INST_RES}x"
          f"{INST_RES}; max overlap {mo} -> k_slots {k_slots}; {int(guard0[1])} live items -> "
          f"item_budget {budget}; build_instanced {stack_build_ms!r} ms, "
          f"build_instanced_split {split_build_ms!r} ms  [{card}]")

    # the main path: the split-kernel instanced frames, K1's launches counted
    recorder = ItemRecorder()
    split_trace.trace_rays_split = recorder
    try:
        split_trace.launch_count = 0

        def split_frame(j):
            ias_j = instanced_split.build_instanced_split(views, packed_s, blas_lo, blas_hi,
                                                          jitter(j))
            return instanced_split.trace_rays_instanced_split(ias_j, rays, k_slots=k_slots,
                                                              item_budget=budget)

        split_frame(0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(ITERS):
            out = split_frame((i + 1) * 1e-3)
        split_frame_ms = sync_ms(t0) / ITERS
        launches = split_trace.launch_count
        # the last timed frame's guard (the reference drops it)
        instanced_split.check_candidate_capacity(out[3], k_slots, budget)
        rec_s, inst_s, stats_s, guard = instanced_split.trace_rays_instanced_split(
            ias_s, rays, k_slots=k_slots, item_budget=budget)
    finally:
        split_trace.trace_rays_split = recorder.fn
    instanced_split.check_candidate_capacity(guard, k_slots, budget)
    require(launches >= ITERS + 1, f"config 4: K1 launched {launches} times")
    split_trace.check_overflow(stats_s.overflow)

    def stack_frame(j):
        return instanced.trace_rays_instanced(tlas.build_instanced(blas, jitter(j)), packed,
                                              rays)

    stack_frame(0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ITERS):
        stack_frame((i + 1) * 1e-3)
    stack_frame_ms = sync_ms(t0) / ITERS
    rec, inst, stats = instanced.trace_rays_instanced(ias, packed, rays)
    split_trace.check_overflow(stats.overflow)
    num = rays.origin.shape[0]
    both = rec.hit & rec_s.hit
    bad_hit = int((rec.hit != rec_s.hit).sum())
    bad_t = int((both & ((rec.t - rec_s.t).abs() > T_RTOL * rec.t.abs())).sum())
    bad_inst = int((both & (inst != inst_s) & (rec.t != rec_s.t)).sum())
    ties = int((both & (inst != inst_s) & (rec.t == rec_s.t)).sum())
    print(f"  config 4 frame (TLAS rebuild and trace): split kernel {split_frame_ms!r} ms, "
          f"stack tracer {stack_frame_ms!r} ms; {int(rec.hit.sum())} hits; stack against "
          f"split mismatches hit={bad_hit} t={bad_t} instance={bad_inst} (exact-t ties "
          f"naming another instance: {ties})  [{card}]")
    for what, count in (("hit", bad_hit), ("t", bad_t), ("instance", bad_inst)):
        require(count <= (1.0 - BRUTE_AGREE) * num,
                f"config 4: the two instanced tracers disagree on {what} for {count} rays")

    # brute force over the flattened world triangles
    world = (torch.einsum("ijk,tvk->itvj", transforms[:, :, :3], tris)
             + transforms[:, None, None, :, 3]).reshape(-1, 3, 3)
    pick = torch.linspace(0, num - 1, INST_BRUTE_RAYS, device=device).round().long()
    sample = rays.take(pick)
    ref = brute_force_trace(world, sample, chunk=16)
    got = rec_s.hit[pick]
    both = got & ref.hit
    ref_inst = ref.prim_id // scene.num_triangles
    bad_hit = int((got != ref.hit).sum())
    bad_t = int((both & ((rec_s.t[pick] - ref.t).abs() > 1e-4 * ref.t.abs())).sum())
    bad_inst = int((both & (inst_s[pick] != ref_inst)
                    & ((rec_s.t[pick] - ref.t).abs() > 1e-4 * ref.t.abs())).sum())
    print(f"  config 4 brute force, {INST_BRUTE_RAYS} rays over {world.shape[0]} world tris: "
          f"{int(ref.hit.sum())} hits, mismatches hit={bad_hit} t={bad_t} instance={bad_inst}")
    require(int(ref.hit.sum()) > 0, "config 4: no brute-force hit")
    for what, count in (("hit", bad_hit), ("t", bad_t), ("instance", bad_inst)):
        require(count <= (1.0 - BRUTE_AGREE) * INST_BRUTE_RAYS,
                f"config 4: split tracer and brute force disagree on {what} for {count} rays")
    del world, ref

    # K1 on the object-space pass as the tracer launched it: timed, held
    # to its plain version bit for bit on every item, with its bound
    (inner, pairs, stack_cap), r, act = recorder.calls[-1]
    ops = split_trace.kernel_operands(r, act)
    kw = dict(leafw=split_trace.LEAFW, any_hit=False, stack_cap=stack_cap)
    ms, kout = event_ms(lambda: split_trace.split_traverse(inner, pairs, *ops, **kw), 5)
    visited = {}
    t0 = time.perf_counter()
    pout = split_trace.trace_split_plain(inner, pairs, *ops, **kw, visited=visited)
    plain_ms = sync_ms(t0)
    bad = k1_mismatches(kout, pout)
    hits = int((kout[1] >= 0).sum())
    require(sum(bad.values()) == 0 and int(kout[4]) == 0 and hits > 0,
            f"config 4 object-space pass: K1 and plain disagree ({bad}), overflow "
            f"{int(kout[4])} or no hit")
    w = inner.shape[1]
    n_items, n_live = ops[0].shape[0], int(act.sum())
    n_inner, n_pairs = int(visited["inner"].sum()), int(visited["pairs"].sum())
    n_ops = (float(kout[2].sum()) * w * SLAB_OPS
             + float(kout[3].sum()) * 2 * split_trace.LEAFW * MT_OPS)
    b = bound(n_ops, n_items * (32 + 16) + n_inner * w * 32 + n_pairs * 64)
    print(f"  config 4 object-space pass: {n_items} items ({n_live} live, {hits} with a "
          f"triangle), K1 {ms!r} ms, bound {b['bound_ms']!r} ms ({b['bound_by']}), pops per "
          f"live item inner {float(kout[2][act].float().mean())!r} leaf "
          f"{float(kout[3][act].float().mean())!r}, plain {plain_ms!r} ms; mismatches {bad}  "
          f"[{card}]")
    max_err = float((kout[0] - pout[0]).abs().max())
    return dict(launches=launches, split_frame_ms=split_frame_ms, stack_frame_ms=stack_frame_ms,
                build_ms=stack_build_ms, split_build_ms=split_build_ms, k1_ms=ms,
                plain_ms=plain_ms, max_abs_err=max_err, items=n_items, **b)


def tracers_phase(device, card: str, scene=None, dev_scene=None, camera=None, triangles=None,
                  split_img=None) -> dict:
    """Phase 15: the app's last two tracers and instancing. Without phase
    3's scene and frame (``--tracers-only``), builds them here first."""
    print("phase 15: the grid tracer, the packet tracer and instancing")
    t_phase = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    if scene is None:
        scene = procedural.terrain(NUM_TRIS)
        dev_scene = scene_to_device(scene, device)
        camera = aerial_camera(scene, device)
        triangles = torch.as_tensor(scene.triangles, device=device)
        front = bucket.split_front(triangles, True)
        views, packed, _ = bucket.emit_split_views(front, leaf_width=split_trace.LEAFW)
        frame = frame_fn(views, packed, dev_scene, camera, device,
                         **split_trace.make_frame_tracers(RES, RES))
        # phase 3's last timed frame: its seed, jitter and tid bounce sort
        split_img, _ = frame(ITERS, ITERS * 1e-4, pair_loc=treelet.build_pair_tid(front))
        del views, packed, front
    out = dict(grid=grid_frame(device, card, scene, dev_scene, camera, triangles, split_img))
    del scene, dev_scene, triangles
    grid_app_runs(card)
    out["packet"] = packet_runs(card, device)
    out["instanced"] = instanced_phase(device, card)
    print(f"  phase 15: {time.perf_counter() - t_phase:.2f} s, K1 launches "
          f"{out['instanced']['launches']}")
    return out


class StartRecorder:
    """Wraps ``split_trace.split_traverse``: keeps the operands of the last
    launch with start tags (a binned pass) for each of closest-hit and
    any-hit."""

    def __init__(self):
        self.fn = split_trace.split_traverse
        self.calls = {}

    def __call__(self, inner, pairs, origin, direction, tmin, tmax, *, start=None, **kw):
        if start is not None:
            self.calls[kw["any_hit"]] = ((inner, pairs, kw["stack_cap"]),
                                         (origin, direction, tmin, tmax), start)
        return self.fn(inner, pairs, origin, direction, tmin, tmax, start=start, **kw)


def tag_checks(views, recorder: StartRecorder) -> float:
    """K1 with start tags against its plain version, bit for bit, on
    SLICE live items sampled evenly from each binned pass with their own
    tags (and every item with a leaf-window tag, where the root has Tri
    children); then on the same items started at the leaf window that
    holds the triangle their own tags found and at the inner row holding
    that window's entry (items without a triangle cycle through the
    tree's windows and rows), so the leaf-start path runs on the card
    whatever the root holds. Returns the largest |t| difference (0)."""
    inner, pairs, stack_cap = views
    meta = inner[..., 6]
    root_tri = bool(((meta[0] & 3) == CHILD_TRI).any())
    rows_e, _ = torch.nonzero((meta & 3) == CHILD_TRI, as_tuple=True)
    starts = (meta >> 5)[(meta & 3) == CHILD_TRI]
    order = torch.argsort(starts)
    starts, rows_e = starts[order], rows_e[order]
    max_err = 0.0

    def check(label, name, sub, tags, any_hit):
        kw = dict(leafw=split_trace.LEAFW, any_hit=any_hit, stack_cap=stack_cap,
                  start=tags.to(torch.int32).contiguous())
        kout = split_trace.split_traverse(inner, pairs, *sub, **kw)
        pout = split_trace.trace_split_plain(inner, pairs, *sub, **kw)
        bad = k1_mismatches(kout, pout)
        hits = int((kout[1] >= 0).sum())
        print(f"    {label}: {tags.numel()} items, {hits} with a triangle, mismatches {bad}")
        require(sum(bad.values()) == 0 and int(kout[4]) == 0,
                f"binned {name} {label}: K1 and plain disagree ({bad})")
        require(hits > 0, f"binned {name} {label}: no item hits, so it checks nothing")
        return kout, float((kout[0] - pout[0]).abs().max())

    for any_hit in (False, True):
        _, (o, d, tmin, tmax), start = recorder.calls[any_hit]
        live = torch.nonzero(tmax > tmin).reshape(-1)
        pick = live[torch.linspace(0, live.numel() - 1, min(SLICE, live.numel()),
                                   device=live.device).round().long()]
        leaf_items = live[(start[live] & 1) == 1]
        if root_tri:
            pick = torch.unique(torch.cat([pick, leaf_items]))
        name = "bounce shadow" if any_hit else "bounce"
        n_leaf = int((start[pick] & 1).sum())
        print(f"  binned {name} pass: {pick.numel()} of {live.numel()} live items sampled, "
              f"{n_leaf} with a leaf-window start tag (the root has "
              f"{'Tri children' if root_tri else 'no Tri child: no item starts at a leaf window'})")
        if root_tri:
            require(n_leaf == leaf_items.numel(), "the sample lost leaf-window items")
        sub = [a[pick] for a in (o, d, tmin, tmax)]
        kout, err = check("own tags", name, sub, start[pick], any_hit)
        max_err = max(max_err, err)
        # the window (and its row) that holds each item's triangle
        cyc = torch.arange(pick.numel(), device=pick.device) % starts.numel()
        j = torch.searchsorted(starts, (kout[1] >> 1).clamp(min=0), right=True) - 1
        j = torch.where(kout[1] >= 0, j, cyc)
        for label, tags in (("leaf-window tags", (starts[j] << 1) | 1),
                            ("inner-row tags", rows_e[j] << 1)):
            max_err = max(max_err, check(label, name, sub, tags, any_hit)[1])
    return max_err


def hit_mismatches(rec, ref) -> dict:
    """Rays on which two closest-hit records differ: hit, tri (at different
    t: a different triangle at exactly the same t is an exact tie, counted
    apart) and t where the triangle is the same (bit for bit)."""
    both = rec.hit & ref.hit
    return dict(hit=int((rec.hit != ref.hit).sum()),
                tri=int((both & (rec.tri_id != ref.tri_id) & (rec.t != ref.t)).sum()),
                ties=int((both & (rec.tri_id != ref.tri_id) & (rec.t == ref.t)).sum()),
                t=int((both & (rec.tri_id == ref.tri_id) & (rec.t != ref.t)).sum()))


def binned_frame(device, card: str, dev_scene, camera, views, packed, split_img) -> dict:
    """Phase 16 (a-c): the 1-bounce frame with the binned bounce and
    bounce-shadow passes (``cell`` bounce sort), K1's start tags against
    the plain version, K1 timed on the binned and presorted passes, and the
    binned hits against the presorted ones."""
    tracers = dict(
        tracer=split_trace.make_split_tracer(RES, RES),
        shadow_tracer=split_trace.make_split_tracer(RES, RES, any_hit=True),
        bounce_tracer=split_trace.make_split_tracer(RES, RES, sort_mode="binned"),
        shadow_tracer_bounce=split_trace.make_split_tracer(RES, RES, any_hit=True,
                                                           sort_mode="binned"))
    captured = {k: Capture(v) for k, v in tracers.items()}
    recorder = StartRecorder()
    split_trace.split_traverse = recorder
    try:
        split_trace.launch_count = 0
        frame = frame_fn(views, packed, dev_scene, camera, device, **captured)
        frame(0, 0.0, sort_kind="cell")
        img, frame_ms, total_rays = timed_frames(frame, sort_kind="cell")
        launches = split_trace.launch_count
    finally:
        split_trace.split_traverse = recorder.fn
    require(launches >= 4 * (ITERS + 1),
            f"binned frame: K1 launched {launches} times in {ITERS + 1} frames")
    require(sorted(recorder.calls) == [False, True], "a binned pass launched no tagged K1")
    require(bool(torch.isfinite(img).all()), "binned frame has non-finite pixels")
    db = frame_psnr(img, split_img)
    mrays = total_rays / (frame_ms * ITERS) / 1000.0
    print(f"  binned frame: {RES}x{RES}, {BOUNCES} bounce, cell bounce sort, {frame_ms!r} ms, "
          f"{mrays!r} Mrays/s, {db!r} dB from phase 3's split frame, K1 launches {launches}  "
          f"[{card}]")
    require(db >= MIN_PSNR, f"binned frame: {db:.2f} dB from the split frame")

    out = dict(frame_ms=frame_ms, mrays_per_s=mrays, psnr_db=db, launches=launches)
    for key, any_hit in (("bounce_tracer", False), ("shadow_tracer_bounce", True)):
        cap = captured[key]
        _, stats, needed = binned.trace_rays_binned(views, packed, cap.rays, cap.active,
                                                    any_hit=any_hit, return_needed=True)
        _, (o, d, tmin, tmax), _ = recorder.calls[any_hit]
        items = int((tmax > tmin).sum())
        live = int((cap.active & (cap.rays.tmax > cap.rays.tmin)).sum())
        slots = binned.item_capacity(cap.rays.origin.shape[0], split_trace.K, 2.0)
        print(f"  binned {key}: {live} live rays, {items} items ({items / live!r} a live ray), "
              f"needed {int(needed)} of {slots} slots, overflow {int(stats.overflow)}")
        require(int(stats.overflow) == 0 and int(needed) <= slots, f"binned {key}: overflow")
        out[f"{key}_items_per_ray"] = items / live
    out["max_abs_err"] = tag_checks(views, recorder)

    for key, any_hit in (("bounce_tracer", False), ("shadow_tracer_bounce", True)):
        cap = captured[key]
        _, item_ops, start = recorder.calls[any_hit]
        name = "bounce shadow" if any_hit else "bounce"
        out[f"binned {name}"] = k1_pass(f"K1, binned {name} pass", views, item_ops, any_hit,
                                        card, start=start)
        ops = split_trace.kernel_operands(cap.rays, cap.active)
        out[f"presorted {name}"] = k1_pass(f"K1, presorted {name} pass", views, ops, any_hit,
                                           card)

    cap = captured["bounce_tracer"]
    rec_b, _ = tracers["bounce_tracer"](views, packed, cap.rays, cap.active)
    rec_p, _ = split_trace.trace_rays_split(views, packed, cap.rays, cap.active)
    bad = hit_mismatches(rec_b, rec_p)
    print(f"  binned against presorted, bounce pass: {int(rec_p.hit.sum())} hits, mismatches {bad}")
    require(bad["hit"] == bad["tri"] == bad["t"] == 0, f"binned and presorted differ: {bad}")
    cap = captured["shadow_tracer_bounce"]
    occl_b, _ = tracers["shadow_tracer_bounce"](views, packed, cap.rays, cap.active)
    occl_p, _ = split_trace.trace_rays_split(views, packed, cap.rays, cap.active, any_hit=True)
    n_bad = int((occl_b.hit != occl_p.hit).sum())
    print(f"  binned against presorted, bounce shadow pass: {int(occl_p.hit.sum())} occluded, "
          f"mismatches {n_bad}")
    require(n_bad == 0, f"binned and presorted shadow passes differ on {n_bad} rays")
    return dict(captured=captured, **out)


def sort_mode_runs(views, packed, captured: dict, card: str) -> dict:
    """Phase 16 (d): the sort modes on the bounce rays in a random order:
    each mode's hits against the presorted tracer's, closest-hit and
    any-hit, with its host-timed ms."""
    cap = captured["bounce_tracer"]
    gen = torch.Generator(device=cap.rays.origin.device).manual_seed(16)
    perm = torch.randperm(cap.rays.origin.shape[0], device=gen.device, generator=gen)
    rays, active = cap.rays.take(perm), cap.active[perm]
    out = {}
    for any_hit in (False, True):
        ref, _ = split_trace.trace_rays_split(views, packed, rays, active, any_hit=any_hit)
        for mode, sort_origin in (("origin", False), ("cell_octant", False), (None, True)):
            tracer = split_trace.make_split_tracer(RES, RES, any_hit=any_hit, sort_mode=mode,
                                                   sort_origin=sort_origin)
            tracer(views, packed, rays, active)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec, _ = tracer(views, packed, rays, active)
            ms = sync_ms(t0)
            name = "sort_origin=True" if sort_origin else mode
            bad = int((rec.hit != ref.hit).sum())
            extra = ""
            if not (any_hit or sort_origin):
                m = hit_mismatches(rec, ref)
                extra = f", closest-hit record {m}"
                require(m["tri"] == m["t"] == 0, f"sort mode {name}: {m}")
            print(f"  sort mode {name}, any_hit={int(any_hit)}: {ms!r} ms, {int(ref.hit.sum())} "
                  f"hits, hit mismatches {bad}{extra}  [{card}]")
            require(bad == 0, f"sort mode {name}: {bad} hits differ from the presorted pass")
            out[(name, any_hit)] = ms
    return out


def bfs_runs(views, packed, captured: dict, triangles, card: str) -> dict:
    """Phase 16 (e): the BFS tracer on the primary and bounce passes with
    BFS_CAP_FACTOR and BFS_LEAF_FACTOR (the reference's 3.0 overflows at
    1M): ms, overflow, visits per level and what the reference's default
    caps would have needed, hits against K1's on the same rays and
    against brute force on BRUTE_RAYS rays."""
    bviews = wavefront_bfs.BFSViews(inner=views[0], pair_rows=packed.rows,
                                    leaf_width=split_trace.LEAFW)
    kw = dict(cap_factor=BFS_CAP_FACTOR, leaf_factor=BFS_LEAF_FACTOR)
    out = {}
    for key, name in (("tracer", "primary"), ("bounce_tracer", "bounce")):
        cap = captured[key]
        rays, active = cap.rays, cap.active
        num = rays.origin.shape[0]
        wavefront_bfs.trace_rays_bfs(bviews, packed, rays, active, **kw)  # warm
        levels = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec, stats, ov = wavefront_bfs.trace_rays_bfs(bviews, packed, rays, active,
                                                      level_visits=levels, **kw)
        ms = sync_ms(t0)
        need = max(max(n, lv) for _, n, lv in levels) / num
        print(f"  BFS {name} pass: {num} rays, caps {BFS_CAP_FACTOR} and {BFS_LEAF_FACTOR} "
              f"x R a level, {ms!r} ms, overflow {int(ov)}, {len(levels)} levels; (visits, "
              f"next-level visits, leaf visits) per level {levels}; the largest list "
              f"{need!r} x R, {need / 3.0!r} x the reference's default cap  [{card}]")
        require(not bool(ov), f"BFS {name} pass overflows caps of {BFS_CAP_FACTOR} x R: a "
                              f"level needs {need!r} x R")
        ref, _ = split_trace.trace_rays_split(views, packed, rays, active)
        bad = hit_mismatches(rec, ref)
        print(f"  BFS {name} pass against K1: {int(ref.hit.sum())} hits, mismatches {bad}")
        require(bad["hit"] == bad["tri"] == bad["t"] == 0, f"BFS {name} against K1: {bad}")
        sample, _ = live_sample(rays, active, BRUTE_RAYS)
        brute_check(f"BFS {name}", None, packed, sample, triangles, tree="BFS",
                    tracer=lambda v, p, r: wavefront_bfs.trace_rays_bfs(bviews, p, r, **kw)[:2])
        out[name] = dict(ms=ms, levels=len(levels), need=need)
    return out


def instanced_grid_run(device, card: str) -> dict:
    """Phase 16 (f): config 4 on the instanced grid: the build and the
    trace timed, the work list against its cap, and the hits against the
    split-kernel instanced tracer on every ray."""
    c4 = config4(device)
    rays, transforms = c4["rays"], c4["transforms"]
    rows = PackedPairs(rows=c4["packed_s"].rows[:c4["num_leaves"]])
    grid_instanced.build_instanced_grid(rows, transforms)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ITERS):
        ias = grid_instanced.build_instanced_grid(rows, transforms)
    build_ms = sync_ms(t0) / ITERS
    grid.check_grid_capacity(ias.blas_grid)
    grid_instanced.trace_rays_instanced_grid(ias, rows, rays)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec, inst, stats, ov = grid_instanced.trace_rays_instanced_grid(ias, rows, rays)
    trace_ms = sync_ms(t0)
    grid_instanced.check_instanced_grid_capacity(ov)
    split_trace.check_overflow(stats.overflow)
    num = rays.origin.shape[0]
    items = int(grid_instanced.candidate_mask(ias, rays).sum())
    print(f"  config 4 instanced grid: res {ias.blas_grid.res}, build_instanced_grid "
          f"{build_ms!r} ms, trace {trace_ms!r} ms, {items} work items against "
          f"work_factor * R = {4 * num}, overflow {int(ov)}  [{card}]")
    _, _, _, _, (rec_s, inst_s, _, _) = instanced_split_frame(c4, transforms)
    both = rec.hit & rec_s.hit
    near = (rec.t - rec_s.t).abs() <= T_RTOL * rec_s.t.abs()
    bad = dict(hit=int((rec.hit != rec_s.hit).sum()),
               t=int((both & ~near).sum()),
               tri=int((both & (rec.tri_id != rec_s.tri_id) & ~near).sum()),
               instance=int((both & (inst != inst_s) & ~near).sum()),
               tri_ties=int((both & (rec.tri_id != rec_s.tri_id) & near).sum()),
               instance_ties=int((both & (inst != inst_s) & near).sum()))
    print(f"  config 4 instanced grid against the split-kernel tracer, {num} rays: "
          f"{int(rec_s.hit.sum())} hits, mismatches {bad}")
    for what in ("hit", "t", "tri", "instance"):
        require(bad[what] <= (1.0 - BRUTE_AGREE) * num,
                f"config 4: the instanced grid and the split tracer disagree on {what}: {bad}")
    return dict(build_ms=build_ms, trace_ms=trace_ms, items=items)


def wide_packet_run(device, card: str, triangles) -> dict:
    """Phase 16 (g): the wide packet tracer on the Karras ``WideBVH`` of
    phase 3's scene, the aerial primary pass at APP_W x APP_H, against K6's
    tiled tracer on the same tree. The packet tracer's Möller-Trumbore
    rounds as the reference's XLA code (one rounding per fused
    multiply-add) and K6 as its plain version, so a grazing hit's t may
    move past T_RTOL and an edge ray flip: at most 0.5% of the rays may
    differ on hit, t or the triangle (not counting another triangle at the
    same t within T_RTOL), as phase 15 holds the packet tracer."""
    bvh, pairs = lbvh.build_lbvh(triangles, True)
    packed = pack_pairs(pairs)
    wbvh = wide.build_wide(bvh)
    camera = aerial_camera(procedural.terrain(NUM_TRIS), device)
    rays = generate_primary_rays(camera, APP_W, APP_H)
    tracer = wide_packet.make_tiled_wide_tracer(wbvh, APP_W, APP_H)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec, stats = tracer(None, packed, rays)
    ms = sync_ms(t0)
    fat = wide.build_wide_fat(bvh, packed.rows)
    ref, _ = wide_fat.make_tiled_fat_tracer(None, APP_W, APP_H, 8, 8)(fat, packed, rays)
    num = rays.origin.shape[0]
    both = rec.hit & ref.hit
    near = (rec.t - ref.t).abs() <= T_RTOL * ref.t.abs()
    exact = rec.t == ref.t
    bad = dict(hit=int((rec.hit != ref.hit).sum()), t=int((both & ~near).sum()),
               tri=int((both & (rec.tri_id != ref.tri_id) & ~near).sum()),
               ties=int((both & (rec.tri_id != ref.tri_id) & near).sum()),
               t_inexact=int((both & ~exact).sum()))
    print(f"  wide packet tracer, aerial camera, {APP_W}x{APP_H} ({num} rays, 16x8 packets): "
          f"{ms!r} ms, {int(ref.hit.sum())} K6 hits, mismatches against K6 {bad} (t to rtol "
          f"{T_RTOL}; ties: another triangle within it; t_inexact: t not bit-equal), overflow "
          f"{int(stats.overflow)}  [{card}]")
    require(int(stats.overflow) == 0 and int(ref.hit.sum()) > 0, "wide packet: overflow or no hit")
    for what in ("hit", "t", "tri"):
        require(bad[what] <= (1.0 - BRUTE_AGREE) * num,
                f"wide packet and K6 disagree on {what} for {bad[what]} rays")
    return dict(ms=ms)


def modes_phase(device, card: str, scene=None, dev_scene=None, camera=None, triangles=None,
                views=None, packed=None, split_img=None) -> dict:
    """Phase 16: the reference's remaining tracers. Without phase 3's
    scene, tree and frame (``--modes-only``), builds them here first."""
    print("phase 16: the binned tracer and K1's start tags, the sort modes, the BFS tracer, "
          "the instanced grid and the wide packet tracer")
    t_phase = time.perf_counter()
    if scene is None:
        scene = procedural.terrain(NUM_TRIS)
        dev_scene = scene_to_device(scene, device)
        camera = aerial_camera(scene, device)
        triangles = torch.as_tensor(scene.triangles, device=device)
        front = bucket.split_front(triangles, True)
        views, packed, _ = bucket.emit_split_views(front, leaf_width=split_trace.LEAFW)
        frame = frame_fn(views, packed, dev_scene, camera, device,
                         **split_trace.make_frame_tracers(RES, RES))
        # phase 3's last timed frame: its seed, jitter and tid bounce sort
        split_img, _ = frame(ITERS, ITERS * 1e-4, pair_loc=treelet.build_pair_tid(front))
        del front
    out = dict(binned=binned_frame(device, card, dev_scene, camera, views, packed, split_img))
    captured = out["binned"].pop("captured")
    out["sort_modes"] = sort_mode_runs(views, packed, captured, card)
    out["bfs"] = bfs_runs(views, packed, captured, triangles, card)
    del captured
    out["instanced_grid"] = instanced_grid_run(device, card)
    out["wide_packet"] = wide_packet_run(device, card, triangles)
    print(f"  phase 16: {time.perf_counter() - t_phase:.2f} s, K1 launches "
          f"{out['binned']['launches']}")
    return out


# --- phase 17: the remaining builds (16-wide rows, bucket fat and v1, the
# implicit heap, packet trip counts, segmented scan) ---


def split_depth(inner: torch.Tensor) -> int:
    """Inner-row levels of a split tree: a walk from row 0 down Box entries."""
    rows, depth = torch.zeros(1, dtype=torch.int64, device=inner.device), 0
    while rows.numel():
        depth += 1
        meta = inner[rows][..., 6]
        child = meta[(meta & 3) == 1] >> 5
        rows = torch.unique(child.to(torch.int64))
    return depth


def fat_depth(rows: torch.Tensor) -> int:
    """Row levels of a fat wide tree: a walk from row 0 down Box entries."""
    cur, depth = torch.zeros(1, dtype=torch.int64, device=rows.device), 0
    while cur.numel():
        depth += 1
        meta = rows[cur][:, 6:64:8]
        cur = torch.unique((meta[(meta & 3) == 1] >> 5).to(torch.int64))
    return depth


class BaselineK1:
    """An earlier K1 source given by ``--k1-baseline``: the same C entry,
    ``split_trace_launch``. Called as ``split_traverse`` is; it counts no
    launch."""

    def __init__(self, source: Path, index: int):
        self.source = source
        self.name = f"split_trace_baseline{index}"

    def __call__(self, inner, pairs, origin, direction, tmin, tmax, *, leafw, any_hit,
                 stack_cap, start=None):
        _cuda_build.load_library(self.name, self.source)
        return split_trace._launch("split_trace_launch", split_trace._ARGTYPES, inner, pairs,
                                   origin, direction, tmin, tmax, leafw, any_hit, stack_cap,
                                   start, library=self.name)


def kernel_registers(log: str) -> dict:
    """Registers of each kernel in a ptxas -v log, by demangled name."""
    regs, name = {}, None
    for line in demangled(log).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name is not None and (m := re.search(r"Used (\d+) registers", line)):
            regs[name] = int(m.group(1))
    return regs


def nvcc_release() -> str:
    out = subprocess.run([_cuda_build.nvcc_path(), "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    m = re.search(r"release (\d+\.\d+)", out)
    return m.group(1) if m else out.strip().splitlines()[-1]


# K1's kernel template arguments in a mangled name: ANY_HIT, SLOTS, WIDTH and
# the later bool parameters (PROFILE first)
K1_MANGLED = re.compile(r"split_trace_kernelILb([01])ELi(\d+)ELi(\d+)E((?:Lb[01]E)*)E")


def k1_8wide_sass(so: Path) -> str:
    """sha256 of the 8-wide, unprofiled K1 kernels' SASS in the built
    library ``so`` (``cuobjdump -sass``): each kernel's instruction lines,
    keyed by (any_hit, slots). The names are left out: the anonymous
    namespace's mangling differs between builds."""
    tool = Path(_cuda_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    bodies, key = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = K1_MANGLED.search(line)
            key = None
            if m and m.group(3) == "8" and not m.group(4).startswith("Lb1"):
                key = (int(m.group(1)), int(m.group(2)))
                bodies[key] = []
        elif key is not None and "/*" in line:
            bodies[key].append(" ".join(line.split()))
    require(len(bodies) == 8, f"{so.name}: {len(bodies)} 8-wide K1 kernels in its SASS (8)")
    digest = hashlib.sha256()
    for k in sorted(bodies):
        digest.update(f"{k}\n".encode() + "\n".join(bodies[k]).encode() + b"\n")
    return digest.hexdigest()


def k1_sass_check() -> str:
    """The built 8-wide K1 kernels' SASS digest, required to equal
    ``K1_8WIDE_SASS`` when nvcc is the recorded release; returns it."""
    release = nvcc_release()
    cur = k1_8wide_sass(_cuda_build.LIB_PATHS["split_trace"])
    want_release, want = K1_8WIDE_SASS
    if release == want_release:
        print(f"  8-wide K1 SASS (cuobjdump -sass, 8 kernels, nvcc {release}): {cur} "
              f"{'unchanged' if cur == want else 'CHANGED'} against the recorded {want}")
        require(cur == want, "the 8-wide K1 kernels' SASS changed")
    else:
        print(f"  8-wide K1 SASS: {cur} from nvcc {release}; the recorded digest is from nvcc "
              f"{want_release}, not comparable")
    return cur


def k1_build_checks(baselines=()) -> None:
    """Phase 17 (a): K1's registers by instantiation, and the 8-wide
    kernels' SASS against ``K1_8WIDE_SASS`` (and beside each baseline's)."""
    regs = {}
    pattern = re.compile(r"split_trace_kernel<\(bool\)(\d), \(int\)(\d), \(int\)(\d+), "
                         r"\(bool\)(\d), \(bool\)(\d)>")
    for name, r in kernel_registers(_cuda_build.BUILD_INFO["split_trace"][1]).items():
        if m := pattern.search(name):
            regs[tuple(int(g) for g in m.groups())] = r
    for label, width, profile, half in (("16-wide, half-warp inner rows", 16, 0, 1),
                                        ("8-wide", 8, 0, 0)):
        rows = [[regs.get((any_hit, slots, width, profile, half)) for slots in range(1, 5)]
                for any_hit in (0, 1)]
        require(None not in rows[0] + rows[1], f"ptxas reported no registers for some K1 "
                                               f"{label} kernels: {rows}")
        print(f"  K1 {label}: registers at 1-4 pair slots a lane (leafw <= 32, 64, 96, 128): "
              f"closest-hit {rows[0]}, any-hit {rows[1]}")
    cur = k1_sass_check()
    for b in baselines:
        other = k1_8wide_sass(_cuda_build.LIB_PATHS[b.name])
        print(f"  8-wide K1 SASS of {b.source}: {other} "
              f"({'the same' if other == cur else 'different'})")


def k1_cycle_split(label: str, views, ops, any_hit: bool, kout, card: str,
                   per_lane: bool = False) -> dict:
    """``split_traverse_cycles`` on one pass: its outputs bit-equal to K1's
    ``kout``; the cycles of each phase summed over the live rays, as shares
    and as a mean per live ray."""
    inner, pairs, stack_cap = views
    out = split_trace.split_traverse_cycles(inner, pairs, *ops, leafw=split_trace.LEAFW,
                                            any_hit=any_hit, stack_cap=stack_cap,
                                            per_lane=per_lane)
    bad = k1_mismatches(out[:5], kout)
    require(sum(bad.values()) == 0, f"{label}: the clock64 instantiation differs from K1: {bad}")
    live = ops[3] > ops[2]
    tot = out[5][:, live].sum(dim=1).double()
    share = (tot / tot.sum()).tolist()
    mean = (tot / int(live.sum())).tolist()
    print(f"  {label}: clock64 cycles per live ray "
          + ", ".join(f"{n} {m!r} ({100 * f!r} %)" for n, m, f in
                      zip(split_trace.PHASES, mean, share))
          + f"; bit-equal to K1  [{card}]")
    return dict(zip(split_trace.PHASES, share))


def k1_wide_pass(label: str, views, ops, any_hit: bool, card: str, views8, live_rows: int,
                 whole: bool, baselines=()) -> dict:
    """K1 on one pass of the 16-wide frame as its tracer launched it:
    CUDA-event ms (mean of 5 after a warm launch), bit-equal to the plain
    version on 65,536 sampled live rays (``whole``: on every ray, timing
    the plain version and marking the rows it visits, and the clock64
    split of both trees), pops per live ray against the 8-wide tree's on
    the same rays; each baseline held bit-equal to K1 and timed between two
    timings of K1. The bound counts K1's own per-ray pops (equal to the
    plain version's where checked); its bytes take every row the plain
    version visited (``whole``), else every live row of the tree once
    (``live_rows`` inner rows and their windows)."""
    inner, pairs, stack_cap = views
    w = inner.shape[1]
    kw = dict(leafw=split_trace.LEAFW, stack_cap=stack_cap, any_hit=any_hit)
    ms, kout = event_ms(lambda: split_trace.split_traverse(inner, pairs, *ops, **kw), 5)
    num = ops[0].shape[0]
    live = ops[3] > ops[2]
    plain_ms = None
    if whole:
        visited = {}
        t0 = time.perf_counter()
        pout = split_trace.trace_split_plain(inner, pairs, *ops, **kw, visited=visited)
        plain_ms = sync_ms(t0)
        bad = k1_mismatches(kout, pout)
        checked = num
        n_rows = int(visited["inner"].sum()) * w * 32 + int(visited["pairs"].sum()) * 64
    else:
        pick = sample_idx(live)
        pout = split_trace.trace_split_plain(inner, pairs, *(o[pick] for o in ops), **kw)
        bad = k1_mismatches(tuple(k[pick] for k in kout[:4]) + (kout[4],), pout)
        checked = pick.shape[0]
        n_rows = live_rows * w * 32 + int(pairs.shape[0]) * 64
    require(sum(bad.values()) == 0 and int(kout[4]) == 0,
            f"{label}: 16-wide K1 and plain disagree ({bad}) or overflow {int(kout[4])}")
    n_ops = (float(kout[2].sum()) * w * SLAB_OPS
             + float(kout[3].sum()) * 2 * split_trace.LEAFW * MT_OPS)
    b = bound(n_ops, num * 48 + n_rows)
    i8, p8, s8 = views8
    kw8 = dict(kw, stack_cap=s8)
    ms8, k8 = event_ms(lambda: split_trace.split_traverse(i8, p8, *ops, **kw8), 5)
    pops = [float(x[live].float().mean()) for x in (kout[2], kout[3], k8[2], k8[3])]
    print(f"  {label}: {num} rays ({int(live.sum())} live), any_hit={int(any_hit)}: 16-wide K1 "
          f"{ms!r} ms, bound {b['bound_ms']!r} ms ({b['bound_by']}); pops per live ray inner "
          f"{pops[0]!r} leaf {pops[1]!r} against the 8-wide tree's {pops[2]!r} / {pops[3]!r} "
          f"({ms8!r} ms on the same rays); bit-equal to plain on {checked} rays"
          + (f" ({plain_ms!r} ms)" if plain_ms is not None else "") + f"  [{card}]")
    for base in baselines:
        bms, bout = event_ms(lambda: base(inner, pairs, *ops, **kw), 5)
        bad = k1_mismatches(bout, kout)
        require(sum(bad.values()) == 0, f"{label}: {base.source} and K1 disagree: {bad}")
        again, _ = event_ms(lambda: split_trace.split_traverse(inner, pairs, *ops, **kw), 5)
        print(f"    {base.source}: {bms!r} ms, bit-equal to K1; 16-wide K1 again {again!r} ms"
              f"  [{card}]")
    split = {}
    if whole:
        split = dict(
            half_warp=k1_cycle_split(f"{label}, half-warp inner rows", views, ops, any_hit,
                                     kout, card),
            per_lane=k1_cycle_split(f"{label}, per-lane inner rows (the replaced design)",
                                    views, ops, any_hit, kout, card, per_lane=True),
            w8=k1_cycle_split(f"{label}, the same rays on the 8-wide tree", views8, ops,
                              any_hit, k8, card))
    return dict(ms=ms, plain_ms=plain_ms, ms8=ms8, inner_pops=pops[0], leaf_pops=pops[1],
                cycle_split=split,
                max_abs_err=float((kout[0][:pout[0].shape[0]] - pout[0]).abs().max())
                if whole else float((kout[0][pick] - pout[0]).abs().max()), **b)


def wide16_tree(device, card: str, front, dev_scene, camera, triangles, views8, pair_loc,
                split_img, baselines=()) -> dict:
    """Phase 17 (a): the 16-wide bucket tree at 1M and the bench frame on
    it, K1's 16-wide instantiation on all four passes."""
    def build():
        return bucket.emit_split_views(front, leaf_width=split_trace.LEAFW, inner_width=16)

    views, packed, split = build()
    bucket.check_split_capacity(split, triangles.shape[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        build()
    build_ms = sync_ms(t0) / ITERS
    depth = split_depth(views[0])
    need = 15 * depth + 1  # w - 1 siblings left a level, w pushed by the deepest row
    print(f"  16-wide emit_split_views: {build_ms!r} ms  [{card}]; {int(split.num_inner)} inner "
          f"rows (8-wide: {int((views8[0][..., 6] != 0).any(dim=1).sum())} non-empty), "
          f"{depth} levels, stack bound {views[2]} (the tree needs at most {need}; K1 holds "
          f"256)")
    require(need <= views[2] <= 256, f"16-wide stack bound {views[2]} against need {need}")

    tracers = split_trace.make_frame_tracers(RES, RES)
    captured = {k: Capture(v) for k, v in tracers.items()}
    frame = frame_fn(views, packed, dev_scene, camera, device, **captured)
    split_trace.launch_count = 0
    t0 = time.perf_counter()
    img, rays_traced = frame(ITERS, ITERS * 1e-4, pair_loc=pair_loc)  # phase 3's last frame
    frame_ms = sync_ms(t0)
    launches = split_trace.launch_count
    require(launches >= 4, f"the 16-wide frame launched K1 {launches} times (< 4)")
    require(bool(torch.isfinite(img).all()), "16-wide frame has non-finite pixels")
    db = frame_psnr(img, split_img)
    print(f"  16-wide frame: {RES}x{RES}, {BOUNCES} bounce, tid sort: {frame_ms!r} ms (one "
          f"frame, host clock), {int(rays_traced)} rays, {db!r} dB from phase 3's frame, K1 "
          f"launches {launches}  [{card}]")
    require(db >= MIN_PSNR, f"16-wide frame {db:.2f} dB from phase 3's (< {MIN_PSNR})")
    live_rows = int(split.num_inner)
    passes = {}
    for (key, any_hit), name in zip(FRAME_TRACERS, PASSES):
        ops, _ = pass_operands(key, captured[key])
        passes[name] = k1_wide_pass(f"1M 16-wide {name} pass", views, ops, any_hit, card,
                                    views8, live_rows, whole=name == "bounce",
                                    baselines=baselines)
    print(f"  16-wide K1 on the four passes: {sum(r['ms'] for r in passes.values())!r} ms a "
          f"frame, the 8-wide tree on the same rays {sum(r['ms8'] for r in passes.values())!r}"
          f"  [{card}]")
    for key, label in (("tracer", "primary"), ("bounce_tracer", "bounce")):
        cap = captured[key]
        rays, n_live = live_sample(cap.rays, cap.active, BRUTE_RAYS)
        brute_check(label, views, packed, rays, triangles, tree="16-wide bucket tree")
    return dict(launches=launches, build_ms=build_ms, frame_ms=frame_ms, psnr_db=db,
                **passes["bounce"])


def wide16_tie_fixture(entries, inside: bool):
    """A 16-wide row whose Tri ``entries`` (ascending) share one box over
    16-pair windows of one triangle (entry i of the tuple at pair 16 i), and
    128 rays along +z that meet it; with ``inside`` the box holds the ray
    origins, so every entry's distance is 0. All tied entries are at one
    distance, so the highest pops first and the lowest last. Returns
    (inner, pairs, ops, the closest-hit tri, the any-hit tri)."""
    empty = torch.cat([f2i(torch.tensor([F32_MAX] * 3 + [-F32_MAX] * 3)),
                       torch.zeros(2, dtype=torch.int32)])
    inner = empty.repeat(8, 16, 1)
    box = f2i(torch.tensor([-1.0, -1.0, -3.0 if inside else -0.5, 1.0, 1.0, 0.5]))
    for i, e in enumerate(entries):
        inner[0, e] = torch.cat([box, torch.tensor([((16 * i) << 5) | 2, 0], dtype=torch.int32)])
    tri = torch.tensor([-1.0, -1.0, 0.0, 1.0, -1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0.0])
    pairs = torch.cat([f2i(tri), torch.zeros(4, dtype=torch.int32)]).repeat(
        16 * len(entries), 1)
    gen = torch.Generator().manual_seed(3)
    xy = torch.rand((128, 2), generator=gen) * 0.6 - 0.3
    ops = (torch.cat([xy, torch.full((128, 1), -2.0)], dim=1),
           torch.tensor([0.0, 0.0, 1.0]).repeat(128, 1), torch.zeros(128),
           torch.full((128,), 10.0))
    # each window's winner is its last slot's first triangle (enc 2 * 15):
    # the second, (v2, v1, v3) with v3 = v2, is degenerate
    return inner, pairs, ops, 30, 2 * 16 * (len(entries) - 1) + 30


def wide16_tie_check(device) -> None:
    """Phase 17 (a): 16-wide K1 on exact entry-distance ties
    (``WIDE16_TIES``): the higher id pops first, so an any-hit ray ends in
    the highest entry's window and a closest-hit ray takes the lowest
    entry's, popped last, on the t tie. K1 equal to plain and to those ids,
    closest-hit and any-hit, on 128 rays each."""
    for entries, inside in WIDE16_TIES:
        inner, pairs, ops, closest, anyhit = wide16_tie_fixture(entries, inside)
        for any_hit, want, lp in ((False, closest, len(entries)), (True, anyhit, 1)):
            kw = dict(leafw=16, stack_cap=64, any_hit=any_hit)
            kout = split_trace.split_traverse(inner.to(device), pairs.to(device),
                                              *(o.to(device) for o in ops), **kw)
            pout = split_trace.trace_split_plain(inner, pairs, *ops, **kw)
            bad = k1_mismatches(tuple(k.cpu() for k in kout), pout)
            require(sum(bad.values()) == 0 and bool((kout[1] == want).all())
                    and bool((kout[3] == lp).all()),
                    f"16-wide K1 on the tie of entries {entries}, any_hit={int(any_hit)}: {bad}, "
                    f"tri {sorted(set(kout[1].tolist()))} (want {want}), leaf pops "
                    f"{sorted(set(kout[3].tolist()))} (want {lp})")
    print(f"  16-wide K1 on exact entry-distance ties ({len(WIDE16_TIES)} rows: entries 7/15, "
          f"0/8, 7/8, all 16 at distance 0): the higher id pops first, equal to plain "
          f"(closest-hit and any-hit)")


def v1_builds(card: str, triangles) -> None:
    """Phase 17 (b): ``build_bucket_split_v1`` at widths 8 and 16, timed,
    and equal to ``build_bucket_split`` bit for bit."""
    for w in (8, 16):
        def build():
            return bucket.build_bucket_split_v1(triangles, True, split_trace.LEAFW, w)
        v1, packed = build()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            build()
        ms = sync_ms(t0) / ITERS
        split, spacked = bucket.build_bucket_split(triangles, True, split_trace.LEAFW, w)
        same = {f: bool(torch.equal(getattr(v1, f), getattr(split, f)))
                for f in ("inner", "num_inner", "num_leaves")}
        same["pairs"] = bool(torch.equal(packed.rows, spacked.rows))
        print(f"  build_bucket_split_v1 width {w}: {ms!r} ms  [{card}]; {int(v1.num_inner)} "
              f"inner rows; equal to build_bucket_split: {same}")
        require(all(same.values()), f"v1 width {w} differs from build_bucket_split: {same}")


def k6_sample_pass(label: str, rows256, call, card: str, karras256, live_rows: int,
                   sample: int) -> dict:
    """K6 on one pass of a fat-tree frame as the tiled tracer launched it:
    CUDA-event ms (mean of 5 after a warm launch); the counting
    instantiation's box and triangle-entry tests over every ray, for the
    bound (bytes: rays in and out, each live row once) and for box tests
    per live ray against phase 8's Karras rows on the same rays; then, on
    ``sample`` sampled live rays (0: none), K6 bit-equal to the plain
    version and the plain version's pops per live ray on both trees."""
    ops, live = fat_pass_operands(call)
    num, n_live = ops[0].shape[0], int(live.sum())
    ms, kout = event_ms(lambda: fat_traverse.fat_traverse(rows256, *ops), 5)
    karras_ms, _ = event_ms(lambda: fat_traverse.fat_traverse(karras256, *ops), 5)
    require(int(kout[6]) == 0, f"{label}: a K6 stack overflowed")
    kc = fat_traverse.fat_traverse(rows256, *ops, count=True)
    kk = fat_traverse.fat_traverse(karras256, *ops, count=True)
    require(torch.equal(kc[0], kout[0]), f"{label}: the counting instantiation's hits differ")
    n_ops = float(kc[7].sum()) * SLAB_OPS + float(kc[8].sum()) * MT_OPS
    b = bound(n_ops, num * (32 + 24) + live_rows * 256)
    box, kbox = (float(x[7][live].float().mean()) for x in (kc, kk))
    line = (f"  {label}: {num} rays ({n_live} live): K6 {ms!r} ms (the Karras tree on the "
            f"same rays {karras_ms!r}), bound {b['bound_ms']!r} ms ({b['bound_by']}); box tests "
            f"per live ray {box!r} against the Karras tree's {kbox!r} ({box / kbox:.2f}x)")
    pops = None
    if sample:
        pick = sample_idx(live, sample)
        sub = tuple(o[pick] for o in ops)
        counts, kcounts = {}, {}
        t0 = time.perf_counter()
        pout = fat_traverse.trace_fat_plain(rows256, *sub, counts=counts)
        plain_ms = sync_ms(t0)
        bad = fat_mismatches(tuple(k[pick] for k in kout[:6]) + (kout[6],), pout)
        require(sum(bad) == 0, f"{label}: K6 and plain disagree on {bad}")
        fat_traverse.trace_fat_plain(karras256, *sub, counts=kcounts)
        pops = float(counts["pops"].float().mean())
        kpops = float(kcounts["pops"].float().mean())
        line += (f"; on {pick.shape[0]} sampled live rays: pops {pops!r} against the Karras "
                 f"tree's {kpops!r} ({pops / kpops:.2f}x), K6 bit-equal to plain ({plain_ms!r} "
                 f"ms)")
    print(line + f"  [{card}]")
    return dict(ms=ms, karras_ms=karras_ms, box_per_ray=box, karras_box_per_ray=kbox, pops=pops,
                **b)


def fat_tree_frame(label: str, device, card: str, fat, packed, dev_scene, camera,
                   split_img, karras256, samples) -> dict:
    """Phase 17 (c): the bench frame on a fat tree with K6 on every pass
    (``make_fat_tracer``, the ``leaf`` sort, phase 3's last seed), and K6
    on each of its passes (``k6_sample_pass``, with ``samples[i]`` rays of
    pass i held to plain)."""
    live_rows = int(fat.num_nodes)
    rows256 = wide_fat.live_rows256(fat)
    depth = fat_depth(rows256)
    recorder = PassRecorder(fat_traverse.make_fat_tracer(None, RES, RES), fat_traverse)
    frame = frame_fn(rows256, packed, dev_scene, camera, device, tracer=recorder)
    fat_traverse.launch_count = 0
    t0 = time.perf_counter()
    img, rays_traced = frame(ITERS, ITERS * 1e-4, sort_kind="leaf")
    frame_ms = sync_ms(t0)
    launches = fat_traverse.launch_count
    require(len(recorder.calls) == 4 and all(c["launches"] > 0 for c in recorder.calls),
            f"{label}: a pass launched no K6")
    require(all(int(c["overflow"].sum()) == 0 for c in recorder.calls),
            f"{label}: a K6 stack overflowed")
    require(bool(torch.isfinite(img).all()), f"{label} frame has non-finite pixels")
    db = frame_psnr(img, split_img)
    print(f"  {label} frame: {live_rows} live rows, {depth} levels; {frame_ms!r} ms (one frame, "
          f"host clock), {int(rays_traced)} rays, {db!r} dB from phase 3's frame, K6 launches "
          f"{launches}  [{card}]")
    require(db >= MIN_PSNR, f"{label} frame {db:.2f} dB from phase 3's (< {MIN_PSNR})")
    res = {name: k6_sample_pass(f"1M {label} {name} pass", rows256, call, card, karras256,
                                live_rows, n)
           for name, call, n in zip(PASSES, recorder.calls, samples)}
    print(f"  K6 on the {label} tree's four passes: {sum(r['ms'] for r in res.values())!r} ms a "
          f"frame  [{card}]")
    return dict(launches=launches, frame_ms=frame_ms, psnr_db=db, passes=res)


def implicit_plain_check(device, card: str) -> None:
    """Phase 17 (c'): K6 against its plain version, bit for bit, on every
    ray of a (RES/8)² aerial frame's primary pass over the implicit tree of
    ``terrain(IMPLICIT_CHECK_TRIS)``, closest-hit, with pops per ray."""
    scene = procedural.terrain(IMPLICIT_CHECK_TRIS)
    tris = torch.as_tensor(scene.triangles, device=device)
    fat, _, _ = implicit.build_implicit_wide_fat(tris)
    rows256 = wide_fat.live_rows256(fat)
    side = RES // 8
    rays = generate_primary_rays(aerial_camera(scene, device), side, side)
    ops = fat_traverse.kernel_operands(Rays(*(tile_reorder(getattr(rays, f), side, side, 16, 8)
                                              for f in ("origin", "direction", "tmin", "tmax"))))
    kout = fat_traverse.fat_traverse(rows256, *ops)
    counts = {}
    t0 = time.perf_counter()
    pout = fat_traverse.trace_fat_plain(rows256, *ops, counts=counts)
    plain_ms = sync_ms(t0)
    bad = fat_mismatches(kout, pout)
    live = pout[0] != 0
    print(f"  implicit tree of {tris.shape[0]} tris ({int(fat.num_nodes)} rows): K6 against "
          f"plain on {side}x{side} primary rays: mismatching words {bad}; pops per ray "
          f"{float(counts['pops'].float().mean())!r} (max {int(counts['pops'].max())}), "
          f"{int(live.sum())} hits; plain {plain_ms!r} ms  [{card}]")
    require(sum(bad) == 0 and int(live.sum()) > 0, f"implicit tree: K6 != plain on {bad}")


def trips_run(card: str, camera, karras256, num_nodes, packed) -> None:
    """Phase 17 (d): ``with_trips=True`` on phase 8's fat rows at
    ``benchmarks/profile_trips.py``'s 1024² in 8x8 packets, primary rays
    from the aerial camera; prints that script's trip statistics."""
    rays = generate_primary_rays(camera, RES, RES)
    tiled = Rays(*(tile_reorder(getattr(rays, f), RES, RES, 8, 8)
                   for f in ("origin", "direction", "tmin", "tmax")))
    fat = wide.FatWideBVH(rows=karras256, num_nodes=num_nodes, live_rows=int(num_nodes))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec, stats, trips = wide_fat.trace_rays_wide_fat(fat, packed, tiled, packet_size=64,
                                                      with_trips=True)
    loop_ms = sync_ms(t0)
    k6, _ = wide_fat.trace_rays_wide_fat(fat, packed, tiled, packet_size=64)
    agree = float((rec.hit == k6.hit).float().mean())
    ns = trips.cpu().numpy().astype(np.float64)
    print(f"  with_trips=True, {RES}x{RES} in 8x8 packets ({ns.size} packets): the loop "
          f"{loop_ms!r} ms (host clock, {int(ns.max())} iterations)  [{card}]")
    for q in (50, 75, 90, 95, 99, 99.9, 100):
        print(f"    trip p{q}: {np.percentile(ns, q):.0f}")
    print(f"    trip mean: {ns.mean():.1f}  sum: {ns.sum():.0f}; lockstep cost (max*P): "
          f"{ns.max() * ns.size:.0f}, ratio {ns.max() * ns.size / ns.sum():.1f}x; box tests/ray: "
          f"{float(stats.box_tests.float().mean()):.0f}; hits equal to K6's on {agree:.6f} "
          f"({int((rec.hit != k6.hit).sum())} rays differ); a push dropped a pending subtree "
          f"(the overflow flag): {int(stats.overflow)}")
    require(agree >= BRUTE_AGREE, f"the trips loop and K6 agree on {agree} of the hits")


def scan_check(device) -> None:
    """Phase 17 (e): ``segmented_scan`` on the card equal to the CPU
    result, bit for bit."""
    rng = np.random.default_rng(17)
    v = rng.standard_normal((100_000, 3)).astype(np.float32)
    v[rng.random(v.shape) < 0.1] = -0.0
    f = rng.random(100_000) < 0.01
    bad = []
    for name, op in (("min", torch.minimum), ("max", torch.maximum), ("add", torch.add)):
        for rev in (False, True):
            a = segmented_scan(torch.from_numpy(v), torch.from_numpy(f), op, rev)
            b = segmented_scan(torch.from_numpy(v).to(device), torch.from_numpy(f).to(device),
                               op, rev).cpu()
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                bad.append((name, rev))
    print(f"  segmented_scan on the card against the CPU, 100000 x 3, min/max/add, both "
          f"directions: mismatching cases {bad}")
    require(not bad, f"segmented_scan differs on the card: {bad}")


def builds_phase(device, card: str, scene=None, dev_scene=None, camera=None, triangles=None,
                 front=None, views8=None, split_img=None, karras=None, k1_baselines=()) -> dict:
    """Phase 17: the remaining builds on phase 3's scene. Without phase 3's
    tree and frame and phase 8's Karras rows (``--builds-only``), builds
    them here first. ``k1_baselines`` (``BaselineK1``) are timed beside
    16-wide K1."""
    print("phase 17: the 16-wide bucket tree, build_bucket_split_v1, build_bucket_fat, "
          "build_implicit_wide_fat, with_trips and segmented_scan")
    t_phase = time.perf_counter()
    if scene is None:
        scene = procedural.terrain(NUM_TRIS)
        dev_scene = scene_to_device(scene, device)
        camera = aerial_camera(scene, device)
        triangles = torch.as_tensor(scene.triangles, device=device)
        front = bucket.split_front(triangles, True)
        views8, packed8, _ = bucket.emit_split_views(front, leaf_width=split_trace.LEAFW)
        frame = frame_fn(views8, packed8, dev_scene, camera, device,
                         **split_trace.make_frame_tracers(RES, RES))
        split_img, _ = frame(ITERS, ITERS * 1e-4, pair_loc=treelet.build_pair_tid(front))
        bvh, pairs = lbvh.build_lbvh(triangles, True)
        kpacked = pack_pairs(pairs)
        fat = wide.build_wide_fat(bvh, kpacked.rows)
        karras = dict(rows256=fat_traverse.pad_rows_256(fat.rows), num_nodes=fat.num_nodes,
                      packed=kpacked)
        del bvh, pairs, fat
    pair_loc = treelet.build_pair_tid(front)
    k1_build_checks(k1_baselines)
    out = dict(wide16=wide16_tree(device, card, front, dev_scene, camera, triangles, views8,
                                  pair_loc, split_img, k1_baselines))
    wide16_tie_check(device)
    print(f"  phase 17 (a): {time.perf_counter() - t_phase:.2f} s")
    v1_builds(card, triangles)
    fats = {}
    # On the 1M implicit tree a ray that enters a node straddling the live
    # and padding leaves walks its padding subtrees (their inverted boxes
    # pass the slab test): thousands of pops, and the plain version pays
    # ~800 launches a pop. So K6 meets plain on that tree at a smaller size
    # (implicit_plain_check), and here only the counts and times.
    for label, fn, samples in (
            ("bucket fat", lambda: bucket.build_bucket_fat(triangles, True), (SLICE,) * 4),
            ("implicit", lambda: implicit.build_implicit_wide_fat(triangles), (0,) * 4)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            res = fn()
        ms = sync_ms(t0) / ITERS
        fat, pk = res[0], res[1]
        packed = pk if isinstance(pk, PackedPairs) else pack_pairs(pk)
        print(f"  {label} build: {ms!r} ms  [{card}]; rows {tuple(fat.rows.shape)}")
        fats[label] = dict(build_ms=ms, **fat_tree_frame(
            label, device, card, fat, packed, dev_scene, camera, split_img, karras["rows256"],
            samples))
        del res, fat, pk, packed
        print(f"  phase 17, {label}: {time.perf_counter() - t_phase:.2f} s")
    out["fats"] = fats
    # the frames' launches (the main path); the pass timings launch K6 too
    out["k6_launches"] = sum(f["launches"] for f in fats.values())
    require(out["k6_launches"] >= 8, f"the fat frames launched K6 {out['k6_launches']} times")
    implicit_plain_check(device, card)
    trips_run(card, camera, karras["rows256"], karras["num_nodes"], karras["packed"])
    scan_check(device)
    print(f"  phase 17: {time.perf_counter() - t_phase:.2f} s, 16-wide K1 launches "
          f"{out['wide16']['launches']}, K6 launches {out['k6_launches']}")
    return out


# --- phase 18: the multi-device renderers on torch.distributed ---


def multi_inputs(device, scene=None, dev_scene=None, camera=None, triangles=None, views=None,
                 packed=None) -> dict:
    """Phase 18's replicated inputs: phase 3's scene, camera and bucket
    tree (built here when not given), phase 8's Karras tree for the
    megakernel leg, the grid over phase 3's pair rows, config 4."""
    if scene is None:
        scene = procedural.terrain(NUM_TRIS)
        dev_scene = scene_to_device(scene, device)
        camera = aerial_camera(scene, device)
        triangles = torch.as_tensor(scene.triangles, device=device)
        views, packed, _ = bucket.emit_split_views(bucket.split_front(triangles, True),
                                                   leaf_width=split_trace.LEAFW)
    bvh, pairs = lbvh.build_lbvh(triangles, True)
    c4 = config4(device)
    ias = instanced_split.build_instanced_split(c4["views"], c4["packed_s"], c4["blas_lo"],
                                                c4["blas_hi"], c4["transforms"])
    mo = instanced_split.max_overlap(ias, c4["rays"])
    # the grid over the live rows (emit_split zeroes the rest: as rows they
    # would all land in the cell holding the origin)
    num_live = int((packed.rows[:, :12] != 0).any(dim=1).sum())
    return dict(dev_scene=dev_scene, camera=camera, views=views, packed=packed,
                trav=pack_bvh(bvh), pairs=pack_pairs(pairs),
                grid=grid.build_grid(packed.rows, num_live),
                ias=ias, inst_rays=c4["rays"], k_slots=max(4, -(-(mo + 2) // 4) * 4))


def multi_legs(mesh, s: dict) -> dict:
    """Every sharded function of ``tpu_raytracing_torch.parallel`` once on
    ``mesh``: the split ``path_trace_sharded`` at RES² (timed), the
    ``render_frame_sharded_split`` lit frame at RES², the instanced split
    tracer on config 4, the megakernel ``render_frame_sharded`` at
    MULTI_MEGA_RES² and the grid ``path_trace_sharded`` at MULTI_GRID_RES²,
    each bounce's uniforms from a generator seeded 1 on every rank."""
    from tpu_raytracing_torch.parallel import flagship, render as prender

    dev = s["camera"]["position"].device
    out, ms = {}, {}

    def gen():
        return torch.Generator(device=dev).manual_seed(1)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        ms[name] = sync_ms(t0)

    timed("split_path", lambda: flagship.path_trace_sharded(
        mesh, s["views"], s["packed"], s["dev_scene"], s["camera"], RES, RES,
        num_bounces=BOUNCES, generator=gen(), k=128))
    timed("split_path", lambda: flagship.path_trace_sharded(
        mesh, s["views"], s["packed"], s["dev_scene"], s["camera"], RES, RES,
        num_bounces=BOUNCES, generator=gen(), k=128))
    timed("split_render", lambda: flagship.render_frame_sharded_split(
        mesh, s["views"], s["packed"], s["dev_scene"], s["camera"], RES, RES,
        RenderType.TEXTURE_LIT_SHADOWS, k=128))
    timed("inst_split", lambda: flagship.trace_instanced_split_sharded(
        mesh, s["ias"], s["inst_rays"], k_slots=s["k_slots"]))
    timed("megakernel", lambda: prender.render_frame_sharded(
        mesh, s["trav"], s["pairs"], s["dev_scene"], s["camera"], MULTI_MEGA_RES,
        MULTI_MEGA_RES, RenderType.TEXTURE_LIT_SHADOWS))
    timed("grid_path", lambda: flagship.path_trace_sharded(
        mesh, s["grid"], s["packed"], s["dev_scene"], s["camera"], MULTI_GRID_RES,
        MULTI_GRID_RES, num_bounces=BOUNCES, generator=gen(), k=128, tracer_kind="grid"))
    return out, ms


def _cpu(x):
    """Every tensor of a result on the host (tuples and dataclasses kept)."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple):
        return tuple(_cpu(v) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _cpu(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in _tensors(v)]
    return [t for f in dataclasses.fields(x) for t in _tensors(getattr(x, f.name))]


def multi_worker(rank: int, world: int, port: int, out_dir: str, device=None) -> int:
    """One rank of phase 18's world of ``world`` processes on ``device``
    (default ``cuda:0``) with gloo: the inputs built from their seeds,
    every leg, the results saved to ``out_dir/rank{rank}.pt``."""
    from tpu_raytracing_torch.parallel import render as prender

    device = torch.device("cuda", 0) if device is None else device
    s = multi_inputs(device)
    mesh = prender.init_mesh(rank, world, f"tcp://localhost:{port}", device=device,
                             backend="gloo")
    try:
        out, ms = multi_legs(mesh, s)
        torch.save(dict(out=_cpu(out), ms=ms), f"{out_dir}/rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def multi_phase(device, card: str, scene=None, dev_scene=None, camera=None, triangles=None,
                views=None, packed=None) -> dict:
    """Phase 18: the multi-device renderers, a world of 1 on NCCL, held to
    the single-device functions, then a world of 2 processes on the one
    card over gloo, held bit for bit to the world of 1. K1's launch count
    is set to 0 before the phase and read after it."""
    from tpu_raytracing_torch.parallel import render as prender

    print("phase 18: the multi-device renderers (tpu_raytracing_torch/parallel) on "
          "torch.distributed")
    t_phase = time.perf_counter()
    s = multi_inputs(device, scene, dev_scene, camera, triangles, views, packed)
    split_trace.launch_count = 0
    mesh = prender.init_mesh(0, 1, f"tcp://localhost:{free_port()}", device=device)
    try:
        one, ms = multi_legs(mesh, s)
    finally:
        torch.distributed.destroy_process_group()
    launches = split_trace.launch_count
    require(launches > 0, "phase 18 launched no K1")
    img, rays = one["split_path"]
    print(f"  world of 1 ({mesh.backend}): split path_trace_sharded {RES}x{RES}, {BOUNCES} "
          f"bounce: {ms['split_path']!r} ms (host clock, after a warm call), {int(rays)} rays "
          f"traced; render_frame_sharded_split lit {ms['split_render']!r} ms; instanced split "
          f"(config 4, {s['inst_rays'].origin.shape[0]} rays, k_slots {s['k_slots']}) "
          f"{ms['inst_split']!r} ms; megakernel lit at {MULTI_MEGA_RES}^2 "
          f"{ms['megakernel']!r} ms; grid path trace at {MULTI_GRID_RES}^2 {ms['grid_path']!r} "
          f"ms  [{card}]")

    # the single-device functions on the same inputs
    gen = torch.Generator(device=device).manual_seed(1)
    ref, _ = path_trace(s["views"], s["packed"], s["dev_scene"], s["camera"], RES, RES,
                        num_bounces=BOUNCES, generator=gen,
                        **split_trace.make_frame_tracers(RES, RES))
    checks = {"split_path dB": frame_psnr(img, ref),
              "split_path equal": bool(torch.equal(img, ref))}
    rimg, rtests = render.render_frame(s["views"], s["packed"], s["dev_scene"], s["camera"],
                                       RES, RES, RenderType.TEXTURE_LIT_SHADOWS,
                                       tracer=split_trace.make_split_tracer(RES, RES))
    checks["split_render equal"] = bool(torch.equal(one["split_render"][0], rimg)) and \
        int(one["split_render"][1]) == int(rtests)
    single = instanced_split.trace_rays_instanced_split(s["ias"], s["inst_rays"],
                                                        k_slots=s["k_slots"])
    checks["inst_split equal"] = all(torch.equal(a, b) for a, b in zip(
        _tensors(single), _tensors(one["inst_split"])))
    mimg, mtests = render.render_frame(s["trav"], s["pairs"], s["dev_scene"], s["camera"],
                                       MULTI_MEGA_RES, MULTI_MEGA_RES,
                                       RenderType.TEXTURE_LIT_SHADOWS)
    checks["megakernel equal"] = bool(torch.equal(one["megakernel"][0], mimg)) and \
        int(one["megakernel"][1]) == int(mtests)
    gen = torch.Generator(device=device).manual_seed(1)
    gimg, _ = path_trace(s["grid"], s["packed"], s["dev_scene"], s["camera"], MULTI_GRID_RES,
                         MULTI_GRID_RES, num_bounces=BOUNCES, generator=gen,
                         tracer=grid_trace.make_grid_tracer(),
                         shadow_tracer=grid_trace.make_grid_tracer(any_hit=True))
    checks["grid_path dB"] = frame_psnr(one["grid_path"][0], gimg)
    print(f"  world of 1 against the single-device functions: {checks}")
    require(checks["split_path dB"] >= MIN_PSNR and checks["grid_path dB"] >= MIN_PSNR
            and checks["split_render equal"] and checks["inst_split equal"]
            and checks["megakernel equal"], f"phase 18 world of 1: {checks}")
    require(int(one["inst_split"][0].hit.sum()) > 0, "config 4's sharded trace hits nothing")

    # a world of 2 on the one card (NCCL refuses two ranks on one device)
    out_dir = OUT_DIR / "multi"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--multi-rank",
                               str(r), "--multi-world", "2", "--multi-port", str(port),
                               "--multi-out", str(out_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=MULTI_WORKER_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    world_s = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        require(p.returncode == 0, f"phase 18 rank {r} of 2 failed ({p.returncode}):\n"
                                   f"{log[-4000:]}")
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(2)]
    one_cpu = _cpu(one)
    differ = {}
    for r, res in enumerate(ranks):
        for leg, val in one_cpu.items():
            got = _tensors(res["out"][leg][:3] if leg == "inst_split" else res["out"][leg])
            want = _tensors(val[:3] if leg == "inst_split" else val)
            n = sum(int(not torch.equal(a, b)) for a, b in zip(got, want))
            if n:
                differ[(r, leg)] = n
    print(f"  world of 2 (gloo, two processes on {device}, host copies for the collectives): "
          f"{world_s:.2f} s for both processes; split path trace "
          f"{ranks[0]['ms']['split_path']!r} / {ranks[1]['ms']['split_path']!r} ms per rank; "
          f"results differing from the world of 1 (rank, leg): {differ or 'none'}  [{card}]")
    require(not differ, f"phase 18: the world of 2 differs from the world of 1: {differ}")
    print(f"  phase 18: {time.perf_counter() - t_phase:.2f} s, K1 launches {launches}")
    return dict(k1=launches, split_path_ms=ms["split_path"], rays=int(rays))


def k6_sass(so: Path) -> str:
    """sha256 of K6's closest-hit and counting instantiations' SASS (the two
    unprofiled ``fat_traverse_kernel``s) in the built library ``so``, their
    instruction lines keyed by COUNT, names left out as ``k1_8wide_sass``
    leaves them out."""
    tool = Path(_cuda_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    bodies, key = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = K6_MANGLED.search(line)
            key = int(m.group(2)) if m and m.group(1) == "0" else None
            if key is not None:
                bodies[key] = []
        elif key is not None and "/*" in line:
            bodies[key].append(" ".join(line.split()))
    require(sorted(bodies) == [0, 1], f"{so.name}: K6 kernels {sorted(bodies)} in its SASS")
    digest = hashlib.sha256()
    for k in sorted(bodies):
        digest.update(f"{k}\n".encode() + "\n".join(bodies[k]).encode() + b"\n")
    return digest.hexdigest()


def k6_sass_checks(baselines=()) -> None:
    """Phase 20 (a): K6's registers by kernel, and its closest-hit and
    counting instantiations' SASS against ``K6_SASS`` and each baseline's."""
    for name, regs in kernel_registers(_cuda_build.BUILD_INFO["fat_traverse"][1]).items():
        print(f"  {name[:100]}: {regs} registers")
    release = nvcc_release()
    cur = k6_sass(_cuda_build.LIB_PATHS["fat_traverse"])
    want_release, want = K6_SASS
    if release == want_release and want:
        print(f"  K6 closest-hit and counting SASS (nvcc {release}): {cur} "
              f"{'unchanged' if cur == want else 'CHANGED'} against the recorded {want}")
        require(cur == want, "K6's closest-hit or counting instantiation's SASS changed")
    else:
        print(f"  K6 closest-hit and counting SASS: {cur} from nvcc {release}; the recorded "
              f"digest {want or '(none)'} is from nvcc {want_release}, not comparable")
    for b in baselines:
        _cuda_build.load_library(b.name, b.source)
        other = k6_sass(_cuda_build.LIB_PATHS[b.name])
        print(f"  K6 closest-hit and counting SASS of {b.source}: {other} "
              f"({'the same' if other == cur else 'different'})")


def lbvh_hierarchy_checks(device, card: str, tris) -> dict:
    """Phase 20 (b): the Karras hierarchy kernel (``csrc/lbvh_hierarchy.cu``)
    against ``generate_hierarchy_plain`` on the same card, every output
    compared: the 1M frame's paired codes (the live count a device scalar)
    and unpaired ones, then small sorted codes with many ties and live
    counts below the padded length, down to none. Returns its numbers on the
    paired 1M codes, for the kernels line."""
    aabb = lbvh.scene_aabb(tris)
    codes, _, num_leaves = lbvh.generate_morton_codes_pairs(tris, *aabb)
    paired = lbvh.sort_codes(codes, codes)[0]
    unpaired = lbvh.sort_codes(*lbvh.generate_morton_codes(tris, *aabb))[0]
    cases = [("1M paired", paired, num_leaves), ("1M unpaired", unpaired, tris.shape[0])]
    gen = torch.Generator().manual_seed(20)
    for n, count in ((2, 2), (2, 1), (3, 3), (3, 0), (5, 2), (1000, 1000), (1000, 617),
                     (4097, 4097)):
        small = torch.sort(torch.randint(0, 64, (n,), generator=gen)).values
        cases.append((f"{n} codes, {count} live", small.to(device), count))
    lbvh.launch_count = 0
    for label, c, count in cases:
        bk, lo_k, hi_k = lbvh.generate_hierarchy(c, count)
        bp, lo_p, hi_p = lbvh.generate_hierarchy_plain(c, count)
        bad = [f for f, a, b in (("child", bk.child, bp.child), ("count", bk.count, bp.count),
                                 ("type", bk.type, bp.type), ("parent", bk.parent, bp.parent),
                                 ("range_lo", lo_k, lo_p), ("range_hi", hi_k, hi_p))
               if not torch.equal(a, b)]
        require(not bad, f"the hierarchy kernel differs from plain on {label}: {bad}")
    launches = lbvh.launch_count
    require(launches == len(cases), f"{launches} hierarchy launches for {len(cases)} cases")
    ms, _ = event_ms(lambda: lbvh.generate_hierarchy(paired, num_leaves), 10)
    t0 = time.perf_counter()
    lbvh.generate_hierarchy_plain(paired, num_leaves)
    plain_ms = sync_ms(t0)
    n = paired.shape[0]
    # bytes: each node reads its code and its neighbours' (3 x 8 B) and
    # writes its slot pair (2 x (3 x 4 + 2 x 8) B) and two parent words
    res = dict(ms=ms, plain_ms=plain_ms, max_abs_err=0.0, launches=launches,
               **bound(0.0, (n - 1) * (24 + 56 + 8)))
    print(f"  the hierarchy kernel bit-equal to plain on {len(cases)} code sets; 1M paired "
          f"codes: {ms!r} ms against a {res['bound_ms']!r} ms bytes bound, plain "
          f"{plain_ms:.1f} ms  [{card}]")
    return res


def caterpillar(depth: int, device, seed: int = 0):
    """A tree (root pair at slots 0-1) of ``depth + 1`` slot pairs, each
    pair's first slot a Box over the next pair and its second a leaf, the
    last pair two leaves: ``depth`` binary levels deep; with random boxes
    and pair rows. Returns (BVH, pair rows)."""
    gen = torch.Generator().manual_seed(seed)
    n = 2 * (depth + 1)
    slot = torch.arange(n, dtype=torch.int32)
    pair = slot // 2
    box = (slot % 2 == 0) & (pair < depth)
    leaf_index = torch.cumsum((~box).to(torch.int32), 0, dtype=torch.int32) - 1
    lo = torch.rand((n, 3), generator=gen) - 1.0
    i32 = dict(dtype=torch.int32, device=device)
    bvh = BVH(node_min=lo.to(device), node_max=(lo + torch.rand((n, 3), generator=gen)).to(device),
              child=torch.where(box, 2 * pair + 2, leaf_index).to(**i32),
              count=torch.where(box, 2, 1).to(**i32),
              type=torch.where(box, CHILD_BOX, CHILD_TRI).to(**i32),
              parent=torch.where(pair == 0, slot, 2 * pair - 2).to(**i32),
              root=torch.tensor(0, **i32), root_count=torch.tensor(2, **i32))
    rows = torch.randint(-2**31, 2**31 - 1, (depth + 2, 16), generator=gen, dtype=torch.int32)
    return bvh, rows.to(device)


def collapse_device_ms(fn, reps: int) -> dict:
    """Mean device ms a call of ``fn`` by kernel (``torch.profiler``'s trace,
    ``reps`` calls after a warm one), the memcpy and memset included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name[:60]] = out.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / reps / 1e3
    return out


def wide_collapse_checks(device, card: str, tris) -> dict:
    """Phase 20 (c): the collapse kernels (``csrc/wide_collapse.cu``, through
    ``wide.collapse_fat``) against ``build_wide_fat`` on the same card (see
    the module docstring). Returns their numbers on the paired 1M tree, for
    the kernels line."""
    log = demangled(_cuda_build.BUILD_INFO["wide_collapse"][1])
    for line in log.splitlines():
        if "Compiling entry function" in line:
            print(f"  {line.split(chr(39))[1][:100]}")
        elif "registers" in line or "spill" in line:
            print(f"    {line.strip()}")
    modes_args = parse_cmd(["--scene", f"terrain:{NUM_TRIS}", "--type", "sah", "--pairs",
                            "--tracer", "wide", "--device", str(device)])
    static = torch.as_tensor(procedural.terrain(NUM_TRIS).triangles, device=device)
    cases = []
    for pairs in (True, False):
        bvh, tp = lbvh.build_lbvh(tris, pairs)
        cases.append((f"1M Karras, pairs {pairs}", bvh, pack_pairs(tp).rows))
    bvh, tp = app_main.build_accel(static, modes_args, StageTimer())
    cases.append(("the modes configuration's binned-SAH tree", bvh, pack_pairs(tp).rows))
    del static
    f = torch.tensor([[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]], device=device)
    i32 = dict(dtype=torch.int32, device=device)
    one = BVH(node_min=f - 1.0, node_max=f + 1.0, child=torch.tensor([0, 0], **i32),
              count=torch.tensor([1, 0], **i32), type=torch.tensor([CHILD_TRI, CHILD_NONE], **i32),
              parent=torch.tensor([0, 1], **i32), root=torch.tensor(0, **i32),
              root_count=torch.tensor(2, **i32))
    cases.append(("a one-leaf root pair", one, torch.arange(100, 116, **i32)[None]))
    two = torch.as_tensor(procedural.random_triangle_soup(2, seed=3).triangles, device=device)
    bvh, tp = lbvh.build_lbvh(two, False)
    cases.append(("a two-leaf tree", bvh, pack_pairs(tp).rows))
    small = torch.as_tensor(procedural.cornell_box().triangles, device=device)
    bvh, tp = app_main.build_accel(small, modes_args, StageTimer())
    cases.append(("cornell's SAH tree (root_count 1)", bvh, pack_pairs(tp).rows))
    cases.append((f"a {CATERPILLARS[0]}-level caterpillar", *caterpillar(CATERPILLARS[0], device)))
    for label, bvh, rows in cases:
        before = wide.launch_count
        fat = wide.collapse_fat(bvh, rows)
        plain = wide.build_wide_fat(bvh, rows)
        require(wide.launch_count == before + 1,
                f"{label}: {wide.launch_count - before} collapses counted for one")
        require(fat.rows.shape == plain.rows.shape and torch.equal(fat.rows, plain.rows),
                f"{label}: the collapse kernels' rows differ from build_wide_fat's")
        require(fat.num_nodes.device == plain.num_nodes.device
                and fat.num_nodes.dtype == plain.num_nodes.dtype
                and int(fat.num_nodes) == int(plain.num_nodes) == fat.live_rows,
                f"{label}: num_nodes {fat.num_nodes} (read as {fat.live_rows}) against "
                f"{plain.num_nodes}")
        print(f"  {label}: {bvh.num_slots} slots, root_count {int(bvh.root_count)}, depth "
              f"{fat_traverse.binary_depth(bvh)}, {int(fat.num_nodes)} wide rows: bit-equal "
              f"to build_wide_fat")
    for depth in CATERPILLARS[1:]:
        bvh, rows = caterpillar(depth, device)
        want = got = None
        try:
            fat_traverse.check_stack_depth(bvh)
        except ValueError as e:
            want = str(e)
        try:
            wide.collapse_fat(bvh, rows)
        except ValueError as e:
            got = str(e)
        require(want is not None and got == want,
                f"a {depth}-level caterpillar: collapse_fat raised {got!r}, the check {want!r}")
        print(f"  a {depth}-level caterpillar: both raise {got!r}")

    label, bvh, rows = cases[0]
    ms, fat = event_ms(lambda: wide.collapse_fat(bvh, rows), COLLAPSE_REPS)
    kernels = collapse_device_ms(lambda: wide.collapse_fat(bvh, rows), COLLAPSE_REPS)
    t0 = time.perf_counter()
    fat_traverse.check_stack_depth(bvh)
    wide.build_wide_fat(bvh, rows)
    plain_ms = sync_ms(t0)
    n, num_wide = bvh.num_slots, int(fat.num_nodes)
    # bytes: each slot's parent and type (8 B), its flag written, scanned and
    # read twice (16 B) and its scan written and read (8 B); each live
    # entry's type, child, count and box (36 B) and a Tri entry's pair row
    # (64 B); every output word written once
    tri = int((((fat.rows[:num_wide, 6:64:8]) & 3) == CHILD_TRI).sum())
    nbytes = n * 32 + num_wide * wide.WIDE * 36 + tri * 64 + fat.rows.numel() * 4
    res = dict(ms=ms, plain_ms=plain_ms, max_abs_err=0.0, **bound(0.0, nbytes))
    print(f"  {label}: the collapse {ms!r} ms a call (CUDA events, its host read included) "
          f"against a {res['bound_ms']!r} ms bytes bound ({nbytes} B), plain {plain_ms:.1f} ms; "
          f"device ms by kernel: " + ", ".join(f"{k} {v!r}" for k, v in kernels.items())
          + f"  [{card}]")
    return res


def lbvh_wide_phase(device, card: str, baselines=()) -> dict:
    """Phase 20 (see the module docstring). Returns the any-hit
    instantiation's numbers on the first bounce shadow pass, for the
    kernels line, and its launches, with the hierarchy kernel's under
    ``hierarchy``."""
    print("phase 20: BASELINE config 5 as written: a Karras rebuild at an animated frame's time, "
          "the fat collapse, an 8-bounce frame with K6's any-hit shadows")
    k6_sass_checks(baselines)
    scene = procedural.terrain(NUM_TRIS)
    dev_scene = scene_to_device(scene, device)
    camera = aerial_camera(scene, device)
    args = parse_cmd(["--scene", f"terrain:{NUM_TRIS}", "--type", "bottom-up", "--pairs",
                      "--tracer", "wide", "--bounces", str(LBVH_WIDE_BOUNCES), "--animate",
                      "--width", str(RES), "--height", str(RES), "--device", str(device)])
    tris = procedural.animate_triangles(torch.as_tensor(scene.triangles, device=device),
                                        LBVH_WIDE_T)
    hierarchy = lbvh_hierarchy_checks(device, card, tris)
    collapse = wide_collapse_checks(device, card, tris)
    wide.launch_count = 0
    for label in ("warm", "timed"):
        timer = StageTimer()
        bvh, pairs = app_main.build_accel(tris, args, timer)
        trav, packed, tracers = build_trav(args, tris, bvh, pairs, timer)
    require(wide.launch_count == 2, f"{wide.launch_count} collapses in two build_trav calls")
    collapse["launches"] = wide.launch_count
    print(f"  {tris.shape[0]} triangles at t = {LBVH_WIDE_T}: "
          + ", ".join(f"{n.strip()} {ms!r} ms" for n, ms in timer.stages)
          + f"; {int(trav.num_nodes)} fat rows  [{card}]")
    require(set(tracers) == {t for t, _ in FRAME_TRACERS}, f"the app's tracers: {set(tracers)}")

    def render(trs, seed=1):
        img, rays = path_trace(trav, packed, dev_scene, camera, RES, RES,
                               num_bounces=LBVH_WIDE_BOUNCES,
                               generator=torch.Generator(device=device).manual_seed(seed), **trs)
        return img, int(rays)

    calls = []

    def recording(key, tracer):
        def wrapped(trav_, packed_, rays, active=None):
            rec, stats = tracer(trav_, packed_, rays, active=active)
            calls.append(dict(key=key, rays=rays, active=active, hit=rec.hit,
                              overflow=stats.overflow))
            return rec, stats
        return wrapped

    single = dict(tracer=wide_fat.make_tiled_fat_tracer(None, RES, RES, 8, 8))
    frame_ms = {}
    for label, trs in (("the app's four tracers", tracers), ("the tiled tracer alone", single)):
        render(trs)
        t0 = time.perf_counter()
        for i in range(ITERS):
            render(trs, seed=i + 2)
        frame_ms[label] = sync_ms(t0) / ITERS
    fat_traverse.launch_count = fat_traverse.count_launch_count = 0
    fat_traverse.any_launch_count = 0
    img, n_rays = render({k: recording(k, v) for k, v in tracers.items()})
    launches = (fat_traverse.count_launch_count, fat_traverse.launch_count,
                fat_traverse.any_launch_count)
    img1, n_rays1 = render(single)
    print(f"  8-bounce frame: {n_rays} rays; K6 launches counting / closest-hit / any-hit "
          f"{launches}; " + ", ".join(f"{k} {v!r} ms a frame" for k, v in frame_ms.items())
          + f"  [{card}]")
    require(launches == (1, LBVH_WIDE_BOUNCES, 1 + LBVH_WIDE_BOUNCES),
            f"K6 launches by instantiation {launches}")
    require(torch.equal(img, img1) and n_rays == n_rays1,
            "the fat-frame image differs from the tiled tracer's alone")
    require(all(int(c["overflow"].sum()) == 0 for c in calls), "a K6 stack overflowed")
    print("  the image and ray count bit-equal to the tiled tracer's alone")

    rows256 = wide_fat.live_rows256(trav)
    shadow = [c for c in calls if "shadow" in c["key"]]
    require(len(shadow) == 1 + LBVH_WIDE_BOUNCES, f"{len(shadow)} shadow calls")
    totals = [0.0, 0.0]
    res = None
    for i, c in enumerate(shadow):
        rays, active = c["rays"], c["active"]
        hit_in_order = c["hit"]
        if c["key"] == "shadow_tracer":  # as the tiled tracer hands them over
            rays = Rays(*(tile_reorder(getattr(rays, f), RES, RES, 8, 8)
                          for f in ("origin", "direction", "tmin", "tmax")))
            active = tile_reorder(active, RES, RES, 8, 8)
            hit_in_order = tile_reorder(hit_in_order, RES, RES, 8, 8)
        ops = fat_traverse.kernel_operands(rays, active)
        any_ms, kout = event_ms(lambda: fat_traverse.fat_traverse(rows256, *ops, any_hit=True),
                                5)
        closest_ms, cout = event_ms(lambda: fat_traverse.fat_traverse(rows256, *ops), 5)
        totals[0] += any_ms
        totals[1] += closest_ms
        require(torch.equal(kout[0], cout[0]) and torch.equal(kout[0] != 0, hit_in_order),
                f"shadow call {i}: any-hit and closest-hit verdicts differ")
        full = i < 2
        idx = (torch.arange(ops[0].shape[0], device=device) if full
               else sample_idx(active))
        counts = {}
        t0 = time.perf_counter()
        pout = fat_traverse.trace_fat_plain(rows256, *(x[idx] for x in ops), counts=counts,
                                            any_hit=True)
        plain_ms = sync_ms(t0)
        bad = fat_mismatches([x[idx] for x in kout[:6]] + [kout[6]], pout)
        require(sum(bad) == 0, f"shadow call {i}: any-hit != plain on {bad}")
        n_live = int(active.sum())
        print(f"  {c['key']} call {i}: {ops[0].shape[0]} rays ({n_live} live, "
              f"{int(kout[0].sum())} occluded): any-hit {any_ms!r} ms, closest-hit "
              f"{closest_ms!r} ms; bit-equal to plain on {idx.shape[0]} rays "
              f"(plain {plain_ms:.1f} ms)  [{card}]")
        if i == 1:
            # the bound as phase 9 counts K6's: box and triangle tests run; rays
            # in (32 B) and out (24 B), the node words of each row visited and
            # the pair words of each Tri entry entered
            n_ops = (float(counts["box_tests"].sum()) * SLAB_OPS
                     + float(counts["tri_tests"].sum()) * MT_OPS)
            nbytes = (ops[0].shape[0] * (32 + 24) + int(counts["visited"].sum()) * 256
                      + int(counts["visited_tri"].sum()) * 64)
            res = dict(ms=any_ms, plain_ms=plain_ms, max_abs_err=0.0, **bound(n_ops, nbytes))
            print(f"    any-hit bound {res['bound_ms']!r} ms ({res['bound_by']}); pops per live "
                  f"ray {float(counts['pops'][active].sum()) / max(n_live, 1)!r}")
    print(f"  the {len(shadow)} shadow passes: any-hit {totals[0]!r} ms, closest-hit "
          f"{totals[1]!r} ms a frame  [{card}]")

    del trav, packed, tracers, rows256, calls, shadow, bvh, pairs
    wide.launch_count = 0
    res_app, _, wall, _ = run_app(
        ["--scene", f"terrain:{NUM_TRIS}", "--type", "bottom-up", "--pairs", "--tracer", "wide",
         "--bounces", str(LBVH_WIDE_BOUNCES), "--animate", "--frames", str(COLLAPSE_APP_FRAMES),
         "--width", str(COLLAPSE_APP_RES), "--height", str(COLLAPSE_APP_RES),
         "--output", str(OUT_DIR / "lbvh_wide_app")])
    print(f"  the app, --animate --frames {COLLAPSE_APP_FRAMES}: wide.launch_count "
          f"{wide.launch_count}; app wall {wall!r} s  [{card}]")
    require(wide.launch_count == COLLAPSE_APP_FRAMES,
            f"{wide.launch_count} collapses in {COLLAPSE_APP_FRAMES} animated app frames")
    collapse["launches"] += wide.launch_count
    del res_app
    return dict(res, launches=launches[2], hierarchy=hierarchy, collapse=collapse)


class InstancedCapture:
    """Stands in for ``instanced_split``'s sweep, items, resolve and record
    while entered: keeps each call's arguments (and, for the resolve, a copy
    of the sweep's per-ray state, which the kernel updates in place) and
    passes the call on."""

    NAMES = ("sweep", "items", "resolve", "record")

    def __init__(self):
        self.real = {n: getattr(instanced_split, n) for n in self.NAMES}
        self.calls = {n: [] for n in self.NAMES}

    def __enter__(self):
        for n in self.NAMES:
            setattr(instanced_split, n, functools.partial(self.take, n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(instanced_split, n, fn)

    def take(self, name, *args):
        if name == "resolve":
            args = (sweep_copy(args[0]),) + args[1:]
            self.calls[name].append(args)
            return self.real[name](sweep_copy(args[0]), *args[1:])
        self.calls[name].append(args)
        return self.real[name](*args)


def items_plain_stage(inv, rays, sw):
    """``instanced_split.items`` with the plain item mapping."""
    s_key, order = torch.sort(sw.item_key, stable=True)
    ops, s_ray = instanced_split.items_plain(inv, rays, s_key, order, sw.item_ray)
    return ops, s_ray, s_key


def sweep_copy(sw):
    """A copy of a ``Sweep`` whose tensors the resolve may update."""
    return dataclasses.replace(sw, **{f.name: getattr(sw, f.name).clone()
                                      for f in dataclasses.fields(sw)
                                      if getattr(sw, f.name) is not None})


def sweep_runs(sw, num: int):
    """(ray, key) of a sweep's filled slots, in the order of (ray, slot):
    each ray's overlaps as its run of slots holds them."""
    n = min(int(sw.stats[0]), sw.item_key.shape[0])
    ray = sw.item_ray[:n].to(torch.int64)
    order = torch.argsort(ray * (n + 1) + torch.arange(n, device=ray.device))
    return ray[order], sw.item_key[:n][order]


def sweep_mismatches(kern, plain, num: int) -> dict:
    """What differs between the sweep kernel's output and its plain
    version's: counts, statistics, and each ray's run of (ray, key)."""
    bad = {}
    if not torch.equal(kern.nov, plain.nov):
        bad["nov"] = int((kern.nov != plain.nov).sum())
    if not torch.equal(kern.stats[:3], plain.stats[:3]):
        bad["stats"] = (kern.stats.tolist(), plain.stats.tolist())
    kr, kk = sweep_runs(kern, num)
    pr, pk = sweep_runs(plain, num)
    if not (torch.equal(kr, pr) and torch.equal(kk, pk)):
        bad["runs"] = int((kk != pk).sum()) if kk.shape == pk.shape else (kk.shape, pk.shape)
    # every run starts at its ray's first slot
    n = min(int(kern.stats[0]), kern.item_key.shape[0])
    slots = torch.arange(n, device=kern.nov.device)
    ray = kern.item_ray[:n].to(torch.int64)
    off = slots - kern.first[ray]
    if bool(((off < 0) | (off >= kern.nov[ray])).any()):
        bad["first"] = int(((off < 0) | (off >= kern.nov[ray])).sum())
    return bad


def bits_differ(a, b) -> int:
    """Elements of two equal-shaped tensors whose bits differ."""
    if a.dtype == torch.bool:
        return int((a != b).sum())
    width = {1: torch.int8, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return int((a.contiguous().view(width) != b.contiguous().view(width)).sum())


def sweep_bytes(live: int, overlaps: int, num_inst: int) -> int:
    """The sweep's least bytes (rtbench/instanced_roofline.py): the live
    rays in (32 B), each overlap out (4 B), the boxes and inverse
    transforms once (72 B an instance)."""
    return live * 32 + overlaps * 4 + num_inst * 72


def instanced_launches() -> dict:
    """The instanced kernels' launch counts, by kernel."""
    return dict(sweep=instanced_split.launch_count, items=instanced_split.items_launch_count,
                resolve=instanced_split.resolve_launch_count,
                record=instanced_split.record_launch_count)


def zero_instanced_launches() -> None:
    instanced_split.launch_count = instanced_split.items_launch_count = 0
    instanced_split.resolve_launch_count = instanced_split.record_launch_count = 0


def items_bytes(args) -> int:
    """The item kernel's least bytes on a call's (inv, rays, sweep): each
    slot's sorted key in (4 B) and its K1 operands and ray out (36 B); each
    filled slot's sort position and ray id (12 B); each live ray once (32
    B); each inverse transform once (48 B)."""
    inv, _, sw = args
    slots = sw.item_key.shape[0]
    filled, live = min(int(sw.stats[0]), slots), int(sw.stats[1])
    return slots * 40 + filled * 12 + live * 32 + inv.shape[0] * 48


def resolve_bytes(args) -> int:
    """The resolve kernel's least bytes on a call's arguments: each slot's
    ray (4 B); each filled slot's t, triangle and two pop counts (16 B) and
    closest-hit its key (4 B); each live ray's two statistics read and
    written (16 B) and its best key (16 B) or occlusion flag (1 B)."""
    sw, s_ray, any_hit = args[0], args[1], args[8]
    filled, live = int((s_ray >= 0).sum()), int(sw.stats[1])
    return (s_ray.shape[0] * 4 + filled * (16 if any_hit else 20)
            + live * (16 + (1 if any_hit else 16)))


def record_bytes_inst(args) -> int:
    """The record kernel's least bytes on a call's arguments: each ray's
    best key (8 B) and record out (25 B); each miss its tmax (4 B); each
    hit its world ray (24 B); each pair row and instance a hit names, once
    (64 B, 48 B)."""
    best, tri_range = args[3], args[4]
    num = best.shape[0]
    hit = best != torch.iinfo(torch.int64).max
    low = best[hit] & 0xFFFFFFFF
    hits = int(hit.sum())
    rows = int(torch.unique((low % tri_range) >> 1).numel())
    insts = int(torch.unique(low // tri_range).numel())
    return num * (8 + 25) + (num - hits) * 4 + hits * 24 + rows * 64 + insts * 48


def instanced_app_phase(device, card: str) -> dict:
    """Phase 22: BASELINE config 4 on the app's path. Returns the kernels
    line's figures of the sweep, item, resolve and record kernels over a
    frame, each with its launches in the app's frames and the captured
    one."""
    print("phase 22: the app's --instances path (config 4 at "
          f"{INST_APP_COUNT} instances of sphere_scene({INST_APP_SUBDIV}), "
          f"{RES}x{RES}, {INST_APP_BOUNCES} bounces)")
    zero_instanced_launches()
    res, _, wall, _ = run_app(
        ["--scene", f"sphere:{INST_APP_SUBDIV}", "--type", "bottom-up", "--pairs",
         "--tracer", "split", "--bounces", str(INST_APP_BOUNCES), "--instances",
         str(INST_APP_COUNT), "--width", str(RES), "--height", str(RES), "--animate",
         "--frames", str(INST_APP_FRAMES), "--output", str(OUT_DIR / "instanced_app")])
    # each pass of a frame sweeps, maps and resolves; the closest-hit ones
    # (the primary pass and each bounce) also record
    calls = 2 * (INST_APP_BOUNCES + 1)
    per_frame = dict(sweep=calls, items=calls, resolve=calls, record=INST_APP_BOUNCES + 1)
    app_launches = instanced_launches()
    print(f"  the app, --animate --frames {INST_APP_FRAMES}: launches {app_launches}; frames "
          f"{[round(f[2], 2) for f in res['frames']]} ms; app wall {wall!r} s  [{card}]")
    require(app_launches == {k: INST_APP_FRAMES * n for k, n in per_frame.items()},
            f"{app_launches} instanced launches in {INST_APP_FRAMES} frames of {per_frame}")
    ias, packed, dev_scene, camera = res["trav"], res["packed"], res["scene"], res["camera"]
    num_inst = ias.wmin.shape[0]
    blas_tris = int(packed.rows.shape[0])
    sizes = {f.name: tuple(getattr(ias, f.name).shape) for f in dataclasses.fields(ias)
             if isinstance(getattr(ias, f.name), torch.Tensor)}
    print(f"  instance level {sizes}, BLAS pair rows {blas_tris}, inner rows "
          f"{tuple(ias.views[0].shape)}: no world triangles")
    tracers = app_main.make_instanced_tracers()

    def frame(seed):
        return path_trace(ias, packed, dev_scene, camera, RES, RES,
                          num_bounces=INST_APP_BOUNCES,
                          generator=torch.Generator(device=device).manual_seed(seed), **tracers)

    frame(ITERS + 7)  # warm
    zero_instanced_launches()
    with InstancedCapture() as cap, ShadeCapture() as shade:
        t0 = time.perf_counter()
        img, rays_traced = frame(ITERS + 8)
        frame_ms = sync_ms(t0)
    # the main path's launches (the app's frames and this one), before the
    # checks below launch each kernel again
    frame_launches = instanced_launches()
    require(frame_launches == per_frame and len(cap.calls["sweep"]) == calls,
            f"{frame_launches} instanced launches in a frame of {per_frame}")
    launches = {k: app_launches[k] + n for k, n in frame_launches.items()}
    real = {n: getattr(instanced_split, n) for n in InstancedCapture.NAMES}
    plain = dict(sweep=instanced_split.sweep_plain, items=items_plain_stage,
                 resolve=instanced_split.resolve_plain, record=instanced_split.record_plain)
    t0 = time.perf_counter()
    try:
        for n in InstancedCapture.NAMES:
            setattr(instanced_split, n, plain[n])
        plain_img, plain_rays = frame(ITERS + 8)
        plain_ms = sync_ms(t0)
    finally:
        for n, fn in real.items():
            setattr(instanced_split, n, fn)
    differ = bits_differ(img, plain_img)
    require(differ == 0 and int(rays_traced) == int(plain_rays),
            f"instanced frame: {differ} image words differ from the plain stages' frame, "
            f"rays {int(rays_traced)} against {int(plain_rays)}")
    print(f"  frame {frame_ms:.2f} ms, {int(rays_traced)} rays; image and rays bit-equal to "
          f"the frame with the plain sweep, items, resolve and record ({plain_ms:.0f} ms)  "
          f"[{card}]")

    # each stage against its plain version on every call's captured inputs
    totals = dict(items=0, live=0, top=0)
    for c, (wmin, wmax, rays, active, capacity, any_hit) in enumerate(cap.calls["sweep"]):
        kern = instanced_split.sweep(wmin, wmax, rays, active, capacity, any_hit, True)
        pl = instanced_split.sweep_plain(wmin, wmax, rays, active, capacity, any_hit, True)
        bad = sweep_mismatches(kern, pl, rays.origin.shape[0])
        require(not bad, f"call {c}: the sweep kernel and its plain version differ: {bad}")
        st = kern.stats.tolist()
        totals["items"] += st[0]
        totals["live"] += st[1]
        totals["top"] = max(totals["top"], st[2])
        require(st[0] <= capacity, f"call {c}: {st[0]} overlaps in {capacity} slots")
        print(f"    call {c} ({'any' if any_hit else 'closest'}): {st[1]} live rays, {st[0]} "
              f"overlaps ({st[0] / max(st[1], 1):.3f} a live ray, {st[0] / capacity:.3f} of "
              f"the slots), largest {st[2]}; sweep bit-equal to plain")
    for c, (inv, rays, sw) in enumerate(cap.calls["items"]):
        ops, s_ray, s_key = real["items"](inv, rays, sw)
        pops, ps_ray = instanced_split.items_plain(inv, rays, s_key,
                                                   torch.sort(sw.item_key, stable=True)[1],
                                                   sw.item_ray)
        bad = {name: bits_differ(a, b) for name, a, b in
               zip(("origin", "direction", "tmin", "tmax", "ray"), (*ops, s_ray),
                   (*pops, ps_ray))}
        require(not any(bad.values()), f"call {c}: the item kernel and plain differ: {bad}")
        if c >= INST_K1_CALLS:
            continue
        live = (s_ray >= 0).nonzero().reshape(-1)
        idx = live[torch.randperm(live.shape[0], device=device)[:SLICE]]
        inner, pairs, stack_cap = ias.views
        any_hit = cap.calls["sweep"][c][5]
        kout = split_trace.split_traverse(inner, pairs, *(o[idx] for o in ops),
                                          leafw=split_trace.LEAFW, any_hit=any_hit,
                                          stack_cap=stack_cap)
        pout = split_trace.trace_split_plain(inner, pairs, *(o[idx] for o in ops),
                                             leafw=split_trace.LEAFW, any_hit=any_hit,
                                             stack_cap=stack_cap)
        kbad = sum(bits_differ(a, b) for a, b in zip(kout[:4], pout[:4]))
        require(kbad == 0, f"call {c}: K1 and plain differ on {kbad} of {idx.shape[0]} items")
    for c, args in enumerate(cap.calls["resolve"]):
        sw = args[0]
        kwon, kstats = real["resolve"](sweep_copy(sw), *args[1:])
        pwon, pstats = instanced_split.resolve_plain(sweep_copy(sw), *args[1:])
        bad = {name: bits_differ(a, b) for name, a, b in
               (("won", kwon, pwon), ("box_tests", kstats.box_tests, pstats.box_tests),
                ("tri_tests", kstats.tri_tests, pstats.tri_tests),
                ("overflow", kstats.overflow, pstats.overflow))}
        require(not any(bad.values()), f"call {c}: the resolve kernel and plain differ: {bad}")
    for c, args in enumerate(cap.calls["record"]):
        krec, prec = real["record"](*args), instanced_split.record_plain(*args)
        bad = {f.name: bits_differ(getattr(krec, f.name), getattr(prec, f.name))
               for f in dataclasses.fields(krec)}
        require(not any(bad.values()), f"call {c}: the record kernel and plain differ: {bad}")
    print(f"  every call's items ({len(cap.calls['items'])}), resolve "
          f"({len(cap.calls['resolve'])}) and record ({len(cap.calls['record'])}) bit-equal "
          f"to plain; K1 bit-equal to plain on up to {SLICE} live items of calls "
          f"0-{INST_K1_CALLS - 1}")
    for b, args in enumerate(shade.calls):
        for sample_next in (True, False):
            kout = pathtrace.bounce_shade(*args, sample_next=sample_next,
                                          normal_maps=ias.normal_maps)
            pout = pathtrace.bounce_shade_plain(*args, sample_next=sample_next,
                                                normal_maps=ias.normal_maps)
            bad = shade_mismatches(kout, pout)
            require(not bad, f"bounce {b}: the bounce-shade kernel with instance normals "
                             f"and plain differ: {bad}")
    print(f"  the bounce-shade kernel with instance normals bit-equal to plain on "
          f"{len(shade.calls)} calls, both sample_next values")

    # the sweep's device time on each call as the frame made it
    as_made = [functools.partial(real["sweep"], *args) for args in cap.calls["sweep"]]
    dev_ms = kernel_device_ms(as_made, "inst_sweep_kernel")
    k_ms, nbytes, n_ops = sum(dev_ms), 0, 0.0
    for c, (args, ms) in enumerate(zip(cap.calls["sweep"], dev_ms)):
        sw = instanced_split.sweep(*args)
        live, overlaps = int(sw.stats[1]), int(sw.stats[0])
        nb = sweep_bytes(live, overlaps, num_inst)
        nbytes += nb
        n_ops += float(live) * num_inst * SLAB_OPS
        if c < 4:
            b = bound(float(live) * num_inst * SLAB_OPS, nb)
            print(f"    call {c}: sweep {ms!r} ms on the device, bound {b['bound_ms']!r} ms "
                  f"({b['bound_by']}; bytes alone {bound(0.0, nb)['bound_ms']!r} ms)  [{card}]")
    p_ms, _ = event_ms(functools.partial(instanced_split.sweep_plain, *cap.calls["sweep"][0]), 1)
    b = bound(n_ops, nbytes)
    regs = {name.split("(")[0]: n for name, n in
            kernel_registers(_cuda_build.BUILD_INFO["instanced_sweep"][1]).items()
            if "inst_sweep_kernel" in name}
    print(f"  sweep kernel: {k_ms!r} ms a frame on the device ({dev_ms[0]!r} on the primary "
          f"pass), bound {b['bound_ms']!r} ms ({b['bound_by']}; bytes alone "
          f"{bound(0.0, nbytes)['bound_ms']!r} ms, {100 * bound(0.0, nbytes)['bound_ms'] / k_ms:.3f}%"
          f" of its roofline), plain {p_ms!r} ms on the primary pass; registers {regs}; "
          f"{totals['items']} overlaps of {totals['live']} live rays a frame, largest "
          f"{totals['top']}  [{card}]")
    out = dict(sweep=dict(ms=k_ms, primary_ms=dev_ms[0], plain_ms=p_ms, max_abs_err=0.0,
                          launches=launches["sweep"], **b))

    # the item, resolve and record kernels: each launch as the frame made it,
    # against its bytes bound (a few dozen operations an item or a ray)
    glue = (
        ("items", "inst_items_kernel", lambda a: functools.partial(real["items"], *a),
         lambda a: functools.partial(items_plain_stage, *a), items_bytes),
        ("resolve", "inst_resolve_kernel",
         lambda a: lambda: real["resolve"](sweep_copy(a[0]), *a[1:]),
         lambda a: lambda: instanced_split.resolve_plain(sweep_copy(a[0]), *a[1:]),
         resolve_bytes),
        ("record", "inst_record_kernel", lambda a: functools.partial(real["record"], *a),
         lambda a: functools.partial(instanced_split.record_plain, *a), record_bytes_inst),
    )
    for label, name, launch, plain, size in glue:
        args = cap.calls[label]
        dev_ms = kernel_device_ms([launch(a) for a in args], name)
        nbytes = sum(size(a) for a in args)
        p_ms, _ = event_ms(plain(args[0]), 1)
        b = bound(0.0, nbytes)
        regs = {n.split("(")[0]: r for n, r in
                kernel_registers(_cuda_build.BUILD_INFO["instanced_sweep"][1]).items()
                if name in n}
        print(f"  {label} kernel: {sum(dev_ms)!r} ms a frame on the device over {len(args)} "
              f"calls ({dev_ms[0]!r} on the primary pass), bound {b['bound_ms']!r} ms "
              f"({b['bound_by']}), plain {p_ms!r} ms on the primary pass; registers {regs}; "
              f"{launches[label]} launches in the main-path frames  [{card}]")
        out[label] = dict(ms=sum(dev_ms), primary_ms=dev_ms[0], plain_ms=p_ms,
                          max_abs_err=0.0, launches=launches[label], **b)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    parser.add_argument("--k1-only", action="store_true",
                        help="stop after phase 4 (build, bench frame, K1's checks and timings); "
                             "prints no summary lines")
    parser.add_argument("--shade-only", action="store_true",
                        help="stop after phases 3 and 19 (the bench frame and the bounce-shade "
                             "kernel's checks and timings); prints no summary lines")
    parser.add_argument("--front-only", action="store_true",
                        help="run phases 1-3 and 21 only (the bench frame and the split "
                             "front's kernels' checks and timings); prints no summary lines")
    parser.add_argument("--app-only", action="store_true",
                        help="run phases 1, 2 and 13 only (the app's render modes, K6's "
                             "counting instantiation with phase 9's fixtures, the rock); "
                             "prints no summary lines")
    parser.add_argument("--animate-only", action="store_true",
                        help="run phases 1, 2 and 14 only (the app's animated run: the refit "
                             "schedule, per-frame rebuilds, --profile-build, --interactive); "
                             "prints no summary lines")
    parser.add_argument("--tracers-only", action="store_true",
                        help="run phases 1, 2 and 15 only (the grid and packet tracers and "
                             "instancing); prints no summary lines")
    parser.add_argument("--modes-only", action="store_true",
                        help="run phases 1, 2 and 16 only (the binned tracer and K1's start "
                             "tags, the sort modes, the BFS, instanced-grid and wide packet "
                             "tracers); prints no summary lines")
    parser.add_argument("--builds-only", action="store_true",
                        help="run phases 1, 2 and 17 only (the 16-wide bucket tree and K1's "
                             "16-wide instantiation, build_bucket_split_v1, build_bucket_fat, "
                             "build_implicit_wide_fat, with_trips, segmented_scan); prints no "
                             "summary lines")
    parser.add_argument("--multi-only", action="store_true",
                        help="run phases 1, 2 and 18 only (the multi-device renderers on "
                             "torch.distributed); prints no summary lines")
    parser.add_argument("--lbvh-wide-only", action="store_true",
                        help="run phases 1, 2 and 20 only (BASELINE config 5 as written: the "
                             "Karras rebuild, the fat collapse and K6's any-hit shadows); "
                             "prints no summary lines")
    parser.add_argument("--instanced-only", action="store_true",
                        help="run phases 1, 2 and 22 only (BASELINE config 4 on the app's "
                             "--instances path: the sweep, item, resolve and record kernels "
                             "and the instanced shading); prints no summary lines")
    parser.add_argument("--shade-baseline", type=Path, metavar="SOURCE",
                        help="an earlier csrc/bounce_shade.cu (the one-level launch) to build, "
                             "hold bit-equal to the bounce-shade kernel and time beside it in "
                             "phase 19")
    # one rank of phase 18's world of 2 (the phase starts these itself)
    parser.add_argument("--multi-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--multi-world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--multi-port", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--multi-out", help=argparse.SUPPRESS)
    parser.add_argument("--k5-baseline", type=Path, metavar="SOURCE",
                        help="an earlier csrc/lane_trace.cu (the same C interface over the "
                             "reference's tables layout) to build, check against K5 and time "
                             "beside it in phase 7")
    parser.add_argument("--k6-baseline", type=Path, metavar="SOURCE", action="append",
                        default=[],
                        help="an earlier csrc/fat_traverse.cu (the same fat_traverse_launch) "
                             "to build, check against K6 and time beside it in phase 9; "
                             "may be given more than once")
    parser.add_argument("--k1-baseline", type=Path, metavar="SOURCE", action="append",
                        default=[],
                        help="an earlier csrc/split_trace.cu (the same split_trace_launch) "
                             "to build, check against K1 and time beside it on each 16-wide "
                             "pass in phase 17; may be given more than once")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    if args.multi_rank is not None:
        return multi_worker(args.multi_rank, args.multi_world, args.multi_port, args.multi_out)
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"phase 1: {kind}, {count} device(s); python {sys.version.split()[0]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card)

    t0 = time.perf_counter()
    baseline, sources = None, {}
    if args.k5_baseline is not None:
        baseline = BaselineK5(args.k5_baseline.resolve())
        sources[BaselineK5.NAME] = baseline.source
    baselines6 = [BaselineK6(src.resolve(), i) for i, src in enumerate(args.k6_baseline)]
    baselines1 = [BaselineK1(src.resolve(), i) for i, src in enumerate(args.k1_baseline)]
    for b in baselines6 + baselines1:
        sources[b.name] = b.source
    _cuda_build.load_libraries(LIBRARIES + list(sources), sources)
    print(f"phase 2: built {', '.join(n + '.cu' for n in LIBRARIES)}"
          f"{''.join(f' and {src} (as {n})' for n, src in sources.items())} in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, (nvcc_s, log) in _cuda_build.BUILD_INFO.items():
        print(f"  {name}: nvcc {nvcc_s:.2f} s")
        for line in demangled(log).splitlines():
            if "Compiling entry function" in line:
                print("    " + line.split("'")[1][:110])
            elif "registers" in line or "spill" in line:
                print("      " + line.strip())

    if args.app_only:
        app_phase(device, card, fixtures=True)
        print("chip_smoke: stopped after phase 13 (--app-only)")
        return 0
    if args.animate_only:
        animate_phase(device, card)
        print("chip_smoke: stopped after phase 14 (--animate-only)")
        return 0
    if args.tracers_only:
        tracers_phase(device, card)
        print("chip_smoke: stopped after phase 15 (--tracers-only)")
        return 0
    if args.modes_only:
        modes_phase(device, card)
        print("chip_smoke: stopped after phase 16 (--modes-only)")
        return 0
    if args.builds_only:
        builds_phase(device, card, k1_baselines=baselines1)
        print("chip_smoke: stopped after phase 17 (--builds-only)")
        return 0
    if args.multi_only:
        multi_phase(device, card)
        print("chip_smoke: stopped after phase 18 (--multi-only)")
        return 0
    if args.lbvh_wide_only:
        lbvh_wide_phase(device, card, baselines6)
        print("chip_smoke: stopped after phase 20 (--lbvh-wide-only)")
        return 0
    if args.instanced_only:
        instanced_app_phase(device, card)
        print("chip_smoke: stopped after phase 22 (--instanced-only)")
        return 0
    scene = procedural.terrain(NUM_TRIS)
    dev_scene = scene_to_device(scene, device)
    camera = aerial_camera(scene, device)
    triangles = torch.as_tensor(scene.triangles, device=device)
    split = split_path(device, card, scene, dev_scene, camera, triangles)
    if args.front_only:
        front_checks(device, card, split, dev_scene, camera)
        print("chip_smoke: stopped after phase 21 (--front-only)")
        return 0
    shade = shade_checks(device, card, split, dev_scene, camera,
                         None if args.shade_baseline is None
                         else BaselineShade(args.shade_baseline.resolve()))
    if args.shade_only:
        print("chip_smoke: stopped after phase 19 (--shade-only)")
        return 0
    front = front_checks(device, card, split, dev_scene, camera)
    k1 = k1_checks(device, card, split)
    sah_frame = sah_checks(device, card, scene, dev_scene, camera, triangles, split)
    if args.k1_only:
        print("chip_smoke: stopped after phases 4 and 12 (--k1-only)")
        return 0
    treelet_build(card, split["front"])
    lane = lane_path(device, card, dev_scene, camera, triangles, split["img"])
    lane_launches = lane["launches"]
    k5 = lane_checks(device, card, lane, triangles, baseline)
    del lane
    binary = binary_path(device, card, dev_scene, camera, triangles, split["img"])
    k6 = fat_checks(device, card, binary, triangles, baselines6)
    versions = split_versions(split)
    probes = probe_phase(device, card)
    k1_launches = split["launches"] + sah_frame["launches"]
    binary_launches = binary["launches"]
    rebuild_ms = split["rebuild_ms"]
    split_img = split["img"]
    split_views, split_packed, front = split["views"], split["packed"], split["front"]
    karras = dict(rows256=binary["rows256"], num_nodes=binary["rows256"].shape[0],
                  packed=binary["packed"])
    del split, binary, sah_frame
    app = app_phase(device, card)
    anim = animate_phase(device, card, rebuild_ms)
    tracers = tracers_phase(device, card, scene, dev_scene, camera, triangles, split_img)
    modes = modes_phase(device, card, scene, dev_scene, camera, triangles, split_views,
                        split_packed, split_img)
    builds = builds_phase(device, card, scene, dev_scene, camera, triangles, front, split_views,
                          split_img, karras, baselines1)
    del front, karras
    multi = multi_phase(device, card, scene, dev_scene, camera, triangles, split_views,
                        split_packed)
    del split_views, split_packed
    any_hit = lbvh_wide_phase(device, card, baselines6)
    inst = instanced_app_phase(device, card)

    def entry(name, source, replaces, launches, res):
        # no single PyTorch call traces rays through a BVH: library_ms is null
        return {"name": name, "route": "cuda", "source": f"tpu_raytracing_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": res["max_abs_err"],
                "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": None}

    # K1 stands for the reference's other versions with no selector: their
    # rows point to the split_trace entry, which counts phase 10's launch,
    # and its measurements on the bounce pass (phase 4) serve them
    sp = "tpu_raytracing/trace/split_pallas.py"
    print(f"chip_smoke: full run {time.perf_counter() - T_PROCESS0:.2f} s of command time")
    print(json.dumps({"kernels": [
        entry("split_trace", "split_trace.cu", f"{sp}:143",
              k1_launches + anim["k1"] + tracers["instanced"]["launches"]
              + modes["binned"]["launches"] + multi["k1"] + versions, k1),
        entry("split_trace 16-wide", "split_trace.cu", f"{sp}:143",
              builds["wide16"]["launches"], builds["wide16"]),
        entry("split_trace for _kernel_v4", "split_trace.cu", f"{sp}:541", 0, k1),
        entry("split_trace for _kernel_v5", "split_trace.cu", f"{sp}:898", 0, k1),
        entry("split_trace for _kernel (v2)", "split_trace.cu", f"{sp}:1250", 0, k1),
        entry("lane_trace", "lane_trace.cu", "tpu_raytracing/trace/lane_pallas.py:107",
              lane_launches + anim["k5"], k5),
        entry("fat_traverse", "fat_traverse.cu", "tpu_raytracing/ops/pallas_traverse.py:71",
              binary_launches + builds["k6_launches"], k6),
        entry("fat_traverse count=True", "fat_traverse.cu",
              "tpu_raytracing/ops/pallas_traverse.py:71", app["launches"] + anim["k6c"], app),
        entry("fat_traverse any_hit=True", "fat_traverse.cu",
              "tpu_raytracing/ops/pallas_traverse.py:71", any_hit["launches"], any_hit),
        entry("bounce_shade", "bounce_shade.cu",
              "none (the JAX package shades with XLA operations)", shade["launches"], shade),
        entry("lbvh_hierarchy", "lbvh_hierarchy.cu",
              "none (the JAX package builds the hierarchy with XLA operations)",
              any_hit["hierarchy"]["launches"], any_hit["hierarchy"]),
        entry("wide_collapse", "wide_collapse.cu",
              "none (the JAX package collapses with XLA operations)",
              any_hit["collapse"]["launches"], any_hit["collapse"]),
        entry("split_operands", "split_front.cu",
              "none (the JAX package prepares K1's operands with XLA operations, "
              f"{sp}:1601)", front["operands"]["launches"], front["operands"]),
        entry("split_record", "split_front.cu",
              "none (the JAX package rebuilds the hit record with XLA operations, "
              "tpu_raytracing/trace/wide_fat.py:_reconstruct)", front["record"]["launches"],
              front["record"]),
        entry("instanced_sweep", "instanced_sweep.cu",
              "none (the JAX package sweeps the instances with XLA operations, "
              "tpu_raytracing/trace/instanced_split.py:candidate_masks)",
              inst["sweep"]["launches"], inst["sweep"]),
        entry("instanced_items", "instanced_sweep.cu",
              "none (the JAX package maps the items into object space with XLA operations, "
              "tpu_raytracing/trace/instanced_split.py:trace_rays_instanced_split)",
              inst["items"]["launches"], inst["items"]),
        entry("instanced_resolve", "instanced_sweep.cu",
              "none (the JAX package takes each ray's winner with XLA operations, "
              "tpu_raytracing/trace/instanced_split.py:trace_rays_instanced_split)",
              inst["resolve"]["launches"], inst["resolve"]),
        entry("instanced_record", "instanced_sweep.cu",
              "none (the JAX package rebuilds the hit record with XLA operations, "
              "tpu_raytracing/trace/instanced_split.py:trace_rays_instanced_split)",
              inst["record"]["launches"], inst["record"]),
    ] + probes}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
