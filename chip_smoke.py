"""Chip smoke test of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py                # kernels + flagship solve
    python3 chip_smoke.py --profile DIR  # also trace one 3-iteration chunk
                                         # of the flagship solve into DIR,
                                         # and of the phase flagship into
                                         # DIR/phase
    python3 chip_smoke.py --resume-child DIR  # phase 5c's resuming process

Phases, each of which ends the run with a non-zero exit code on failure:

1. build: one ``nvcc`` per CUDA source of the port, all started together.
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at every shape the flagship gives it (fused loss forward and
   backward: the flagship volume with bf16 and float32 ``out``, the
   backward with the main path's incoming gradient and a random one; wgrad:
   the 24 distinct 3x3x3 convs of the net in bf16, and float32 at two of
   them), with the tolerance printed beside the error; times from CUDA
   events around many back-to-back launches divided by their count, after a
   warm-up, of the kernel, the plain version and, where one exists, the one
   PyTorch call that computes the same function (``library_ms``, timed here
   only; the float32 ``conv3d_weight`` with TF32 off). The fused loss's
   kernels are shorter than the host's dispatch of a call, so their times
   come from a CUDA graph of many calls, over copies of the inputs that
   together exceed L2; the eager times are printed beside them. The sum of launches x ms over
   the 32 wgrad launches of an iteration is printed as wgrad ms/iteration.
   The linear upsample's backward (``upsample_bwd``, a gather) at the
   flagship's four upsample shapes in bf16 and float32: bit-equal to the
   plain version (and so within one bf16 rounding of the float32 sum;
   float32: 1e-6 of max |g|), repeated calls bit-identical, each shape on
   the TMA kernel, its time beside its bound, the direct kernel's (the
   earlier kernel, which the planner keeps for gradients TMA cannot read) and the
   atomic backward of ``F.interpolate`` (``upsample_trilinear3d_backward``);
   the same in 2D at the lines net's bilinear shapes with 32 and 64 lanes
   folded (bit-equal, the kernel each takes, the atomic
   ``upsample_bilinear2d_backward``); and ``F.interpolate``'s trilinear
   forward alone at the four 3D shapes beside its bound (no kernel of the
   port's: a measurement). The Norm's kernel pair (``ops/norm_act.py``) at
   the flagship's 28 Norm shapes in bf16 and float32, with LeakyReLU fused
   and without: held against the plain version in float32 from the same
   input at the card tests' tolerances, then forward and backward timed
   beside the design's bound and the least-traffic bound, the plain version
   and ``F.batch_norm`` + ``F.leaky_relu`` (timed only), summed over each
   resolution's Norms and the 70 of an iteration, with each one's launches.
3. small: a tiny 3D solve with both kernels on the card against the same
   solve on the CPU (plain versions), same canvas and weights.
4. main path: ``DIPSolver(cfg).solve(img, mask, seed=0)`` on the flagship
   (256, 128, 128) volume, MulResUnet 3D at filters [16..256], inputdepth 64,
   bf16, ``fused_loss`` and ``DPI_PALLAS_WGRAD=1``, 9 iterations in chunks
   of 3, the step's forward and backward from the solve's CUDA graph: step
   0 eager, step 1 captured, 7 replayed (``graph_routes``), and no capture
   that fell back to eager steps (its ``RuntimeWarning`` fails the run). A
   one-step solve first sets up what a shape's first call sets up (the
   wgrad tuner's timing launches), so the device trace of the solve
   (``torch.profiler``) holds its 9 steps' kernels alone: every kernel must
   have run (fused loss forward and backward 9 times each, wgrad 9 x 32,
   upsample_bwd 9 x 4, all 36 on its TMA kernel, 9 x 70 x 2 of each of the
   Norm pair's directions). A replayed step calls no Python, so the launch
   counters, the Norms' routes and the hooks on the conv's weight gradient
   and the upsample's backward count the eager and the captured step: 2 x
   the same, the hooks' shapes the 24 and the 4 of phase 2, each as often as
   listed there, and 2 x 70 Norms on the kernel route (70 more plain: the
   solver's shape pass on the meta device). A 3-step solve with the kernels
   off (the Norm kernels on: phase 2 holds them) must give the same
   iteration-0 loss. Every other phase's solves run their steps eagerly
   (``engine/solver.py`` ``_GRAPHS`` off): they count the launches and the
   shapes that the wrappers and hooks see from Python; the step graph's
   card tests (``tests/test_torch_cuda_step_graph.py``, phase 9) hold the
   graphed solves bit for bit against the eager ones.
5. the CLI (``cli.run``, on the card by default), three paths, the
   launch counters set to 0 just before each and read just after:
   a. a 3D survey at the flagship's width: a (256, 256, 128) hyperbolic
      volume with 66 % of its traces NaN, written as ``.npy`` files, run
      with the flagship's flags and ``--patch_shape 256 128 128 --gain 40
      --epochs 6 --scan_chunk 3 --save_every 3 --pocs --savemodel``: 2
      patches x 6 iterations, launches 12 / 12 / 384 / 48. It checks the bundle
      keys (the JAX package's), one snapshot and one ``_model.msgpack`` a patch,
      the reconstruction of the run directory against each bundle's
      ``output / 40`` (rtol 1e-6), and that a second run on the same
      directory skips both patches and launches nothing. It prints each
      patch's steady s/iteration, the peak memory and the device ms of one
      ``fk_projection`` at (1, 1, 256, 128, 128) float32;
   b. the README's command on the bundled lines data (170, 100, 1) with
      the default 2D net, ``--pocs --fused_loss --epochs 9``: launches 9 / 9,
      a finite POCS history;
   c. an exact resume on the card, in another process: the flagship net and
      volume (trilinear, bf16, fused loss, ``DPI_PALLAS_WGRAD=1``), 6
      iterations straight with a checkpoint path (so with deterministic
      cuDNN, which the solver sets), then 3 iterations saved after each
      chunk and resumed to 6 in a fresh Python process (this script with
      ``--resume-child DIR``), whose wgrad tuner starts empty and takes the
      checkpoint's grids without timing any; history and ``out_best`` must
      be bit-equal to the straight run's. The straight run's s/iteration
      stands beside phase 4's (the cost of deterministic cuDNN).

6. the solver options and the model zoo at full width, the launch counters
   set to 0 just before each run and read just after:
   a. the flagship with ``remat`` and ``virtual_input``, 6 iterations:
      launches 6 / 6 / 192, the iteration-0 loss of phase 4 (rel 1e-5), a
      peak memory below phase 4's (printed beside the prediction);
   b. the flagship with ``remat``, ``dropout=0.1`` and ``param_noise``:
      finite losses, launches 6 / 6 / 192;
   c. the flagship in float32 (the JAX package refuses these options in
      bf16, with ``TypeError``, and so does the port: checked) with
      ``opt_over="net,input"``, ``data_forgetting_factor=5`` and the
      low-pass canvas (250 / 40): the canvas moved, launches, peak memory;
   d. the flagship in float32 with and without ``remat``: peak memory and
      s/iteration;
   e. ``--net skip`` and ``--net unet`` (bf16) and ``--net part`` (float32,
      the only dtype the JAX package runs it in) at the flagship volume and
      flags: a spy on ``conv_same`` counts the convs the wgrad gate admits
      (launches = admitted x 6, fused 6 / 6, upsample_bwd 6 x the net's
      linear upsamples) and prints those it turns away
      to ``conv3d_weight``; every wgrad shape that phase 2 did not check is
      held against its plain version (1e-4 of max |dW| + 1e-4) and timed
      beside its bound and ``conv3d_weight`` (TF32 off for float32);
   f. the README's 2D command with ``--net attmultiunet``, then ``--net
      part`` (the mask through the CLI): 9 / 9 / 0 each, upsample_bwd 36
      (its attention gates' bilinear upsamples) and 0;
   g. the ConvGRU ``Ensemble``: one forward and backward on the card in
      float32 against the CPU in float64.

7. phase space and the alternative conv formulations, the launch counters
   set to 0 just before each run and read just after:
   a. the phase flagship (``bench.py``'s default: phase 4's configuration
      with ``phase_space=True, phase_levels=2``), 9 iterations in chunks of
      3: launches 9 / 9 / 270 / 18, hooks on the wgrad kernel's and the
      upsample's callers check their shapes (22 and 2, 9 of the 22 new to
      the kernel), its steady s/iteration and peak memory beside phase 4's
      and the iteration-0 loss against phase 4's (same parameters and
      canvas; rel 1e-3, bf16 rounding at other places);
   b. one float32 forward of the plain and the phase flagship nets (levels
      2, then levels 3 with resolution 0 at depth 2), same parameters and
      canvas, TF32 off: outputs to 2e-5 of the output's scale, masked L1 to
      rel 1e-5;
   c. two 3-iteration phase-flagship solves from one seed with a checkpoint
      path (deterministic cuDNN), the second with the wgrad tuner emptied
      and given the first's grids from its checkpoint: nothing timed,
      history and ``out_best`` bit-equal;
   d. the wgrad kernel at its 9 new shapes against its plain version (as in
      phase 2), timed beside the bound, the plain version and
      ``conv3d_weight``, with the phase path's wgrad ms/iteration; the entry
      conv's weight gradient ((4, 4, 4), stride 2, over (1, 64, 256, 128,
      128)), which the phase path leaves to ``conv3d_weight``, against the
      folded form;
   e. phase 3's small solve with ``vmap_conv_mode="tapmm"`` and with the
      packed and folded weight gradients (wgrad kernel off), against phase
      3's losses.

8. patch batches on one card (``parallel/mesh.py``), the launch counters
   set to 0 just before each run and read just after:
   a. the flagship's flags through ``cli.run --batch_patches 8`` on phase
      5a's hyperbolic volume at (256, 128, 128), 66 % of its traces NaN, cut
      into 8 patches of (128, 64, 64) (the voxels of phase 4's one patch),
      6 iterations in chunks of 3: one batch of 8 lanes, launches of the
      lane kernels 6 / 6 / 192 / 24 (fused loss forward and backward, wgrad,
      upsample backward) and 840 / 840 of the lane Norm pair (6 x 70 x 2,
      through the vmap rule), none of the one-lane wrappers, hooks on the
      lane wgrad's and the upsample's callers check their shapes, the
      bundles' keys; then the same 8 patches one after another
      (``--batch_patches 0``, 8 x 6 x 70 x 2 one-lane Norm launches a
      direction): each lane's iteration-0 loss to rel 1e-3 of
      its solo solve (bf16, grouped against plain cuDNN convs); s/iteration
      of the batch and a patch beside the sequential run's and phase 4's,
      and the peak memory;
   b. BENCH_2D.json's configuration on the lines gather (MulResUnet 2D,
      filters [16..256], inputdepth 64, bf16, fused loss) through
      ``solve_patches_batched``, B lanes with B decimation masks from seeds
      0..B-1, 2 chunks of 25 iterations (3 before PR 17): the one-lane
      solver (no vmap), then B = 1, 32 with tapmm, 32 grouped, 64 with
      tapmm; s / 1000 iterations a patch beside the reference's V100 47 s,
      50 / 50 lane fused-loss launches whatever B is;
   c. the lane kernels against their plain versions: the fused loss at
      (32, 170 x 100) and (8, 128 x 64 x 64), bf16 and float32 ``out``, each
      lane bit-equal to a one-lane launch, CUDA-graph times beside the
      bound; the lane wgrad at every shape 8a saw (1e-4 of max |dW| + 1e-4)
      beside its bound, the plain version and ``conv3d_weight`` with
      ``groups=8``, and the sum of launches x ms of an 8a iteration; the
      lane-folded upsample backward on the TMA kernel, one launch bit-equal to
      per-lane calls and to the plain version, beside the atomic backward;
      the lane Norm pair at the widest Norm of each of the patch's levels,
      two launches a direction, each lane bit-equal to a one-lane call,
      timed beside the 8 one-lane calls;
   d. ``overlap_add_sharded`` and the repaired ``overlap_add`` on the card
      at 8a's tiling (8a's outputs) and an overlapping one: two calls
      bit-equal, within 1e-6 of a float64 numpy overlap-add.

10. spatial shards (``parallel/spatial.py``), the launch counters set to
    0 just before each run and read just after:
    a. phase 4's flagship split along H over [cuda:0] x 2 and x 4, 9
       iterations through ``DIPSolver.solve(spatial_mesh=...)``: launches
       32 N / N / N / 4 N an iteration (wgrad through the padded-dy route,
       fused loss forward and backward, upsample_bwd, each shape's kernel
       printed), the first 3 losses beside phase 4's (iteration 0 to rel
       1e-3, bf16), s/iteration and peak memory beside phase 4's;
    b. phase 3's small float32 solve over 4 shards of the card against the
       unsharded card solve (first 3 losses, rel 1e-4), two sharded solves
       and a sharded resume from a 3-iteration checkpoint bit-equal;
    c. each kernel at 10a's shard shapes against its plain version: wgrad
       on (x with its halo, padded dy) timed beside its bound, the plain
       version and ``conv3d_weight`` of the shard conv, the shards' dW
       summed in order against the unsharded dW; the fused loss on each
       shard's output; ``upsample_bwd`` at every shard shape, bit-equal;
    d. where there are two cards, 10a's 2-shard solve over cuda:0 and
       cuda:1 with each card's peak; else a line saying it was skipped.
       The upsample's rows of 10c carry the plain version's and the atomic
       ``upsample_trilinear3d_backward``'s times.

11. the solver's options over spatial shards, each sharded solve traced as
    10a (launch counters set to 0 just before and read just after: 32 N /
    N / N / 4 N an iteration, the hooks' wgrad and upsample shapes those of
    ``spatial_wgrad_shapes(N)`` / ``spatial_upsample_shapes(N)``, every
    upsample backward on the TMA kernel):
    a. phase 4's flagship with parameter noise, dropout 0.1, the virtual
       canvas and remat over [cuda:0] x 2 and x 4, 6 iterations: the
       iteration-0 loss against the unsharded solve with the same options
       and seed (rel 1e-4), s/iteration and peak beside 10a's;
    b. the flagship in float32 (TF32 off) with data forgetting, POCS
       (adaptive eps) and the low-pass canvas over 2 shards, 4 iterations,
       without and with remat: iteration 0's loss, df, reg and eps against
       the unsharded solve's (rel 1e-4), the peak of each;
    c. phase 3's small float32 solve with dropout, parameter noise and
       remat over 4 shards: two solves and a resume bit-equal.

12. phase space, the optimised canvas and tapmm over spatial shards, each
    sharded solve traced as 10a:
    a. the phase flagship of 7a over [cuda:0] x 2 and x 4, 9 iterations:
       launches 30 N / N / N / 2 N an iteration (wgrad at the phase path's
       shard shapes: its 9 phase convs on their phase grids and its plain
       levels 2-4, each shard's planes with a halo plane on each side;
       every upsample backward on the TMA kernel), the iteration-0 loss
       against 7a's (rel 1e-3, bf16), s/iteration and peak beside 7a's;
    b. the flagship in float32 (TF32 off) with ``opt_over="net,input"``
       and remat over [cuda:0] x 2: one step's gradient by the canvas
       against the unsharded one, no further than TF32's own error (as
       10a holds the parameters'); 4 iterations against the unsharded
       solve: the iteration-0 loss (rel 1e-4), the peak of each, and how
       far the gathered canvas lies from the unsharded one;
    c. phase 3's small float32 solve in phase space with tapmm and the
       optimised canvas over 4 shards: two solves and a resume bit-equal;
    d. the wgrad kernel at 12a's new shard shapes against its plain
       version, timed beside its bound, the plain version and
       ``conv3d_weight``, and the phase path's wgrad ms an iteration.

13. the zoo nets over spatial shards (``parallel/spatial_zoo.py``), each
    sharded solve traced as 10a (launch counters set to 0 just before and
    read just after):
    a. ``--net skip`` and ``--net unet`` (bf16) at 6e's configuration (the
       flagship volume and flags) over [cuda:0] x 2 and x 4 along H, 4
       iterations in chunks of 2 (6 in chunks of 3 before PR 17): launches
       fused N / N, wgrad N x 6e's
       admitted convs and ``upsample_bwd`` N x the net's linear upsamples
       (5, 4) an iteration, the wgrad hook's shapes 6e's split over the
       shards (each shard's planes with a halo plane on each side), the
       kernel each upsample shape takes; s/iteration, peak and the
       iteration-0 loss beside 6e's (rel 1e-3, bf16);
    b. ``--net part`` in float32 (TF32 off) over x 2 and x 4, 4 iterations
       in chunks of 2, traced as 13a (wgrad at the decoder's convs only: the
       partial convs' own convs go to cuDNN), the iteration-0 loss to rel
       1e-5 of 6e's; one iteration's parameter gradients over 2 shards held
       to TF32's own error, as 10a holds the flagship's;
    c. the README's 2D command with ``--net attmultiunet`` (its patch, seed
       and flags) through ``DIPSolver.solve`` over 2 shards of the card along
       axis 1 (``--spatial_shards`` takes one card a shard): launches 18 /
       18 / 0 / 72 (the four gates' one-channel bilinear upsamples on each
       shard), the kernel each shape takes, the iteration-0 loss to rel
       1e-5 of 6f's;
    d. phase 3's small float32 problem with ``--net skip`` over 2 shards:
       two solves and a resume bit-equal;
    e. the kernels at the zoo's new shard shapes: wgrad (bf16 and part's
       float32 decoder) against its plain version, timed beside its bound
       and ``conv3d_weight``; ``upsample_bwd`` (3D and the gates' 2D)
       bit-equal, timed beside the plain version and the atomic backward;
       the fused loss on float32 and 2D shard outputs.

14. convergence against the JAX repository's goldens
    (``scripts/torch_golden.py``: each workload as the JAX script builds
    it, both kernel switches on), the launch counters set to 0 just before
    each run and read just after; each sub-phase prints its JSON line (the
    port's best SNR mean and std over the seeds, the JAX file's and the
    torch reference's, the rule's verdict, launches, s/iteration) and fails
    unless ``accept`` (the JAX scripts' rule: means within 0.5 dB, or at
    least 5 seeds and overlapping 1-sigma intervals) takes the port against
    the JAX column (for gpocs the JAX package's float32 column,
    ``golden_torch_cpu.json``: the golden file's three TPU seeds are
    narrower than the workload's spread at float32), every loss is finite
    and every count is as stated:
    a. g3d (``golden_3d.json``): 8 problems x 150 iterations through
       ``DIPSolver.solve``, one lane: fused loss 1200 / 1200, wgrad the
       convs a spy on ``conv_same`` finds the gate admits, ``upsample_bwd``
       4 x 1200; the differences paired by problem;
    b. g25d (``golden_25d.json``): 5 seeds x 300 iterations as 5 lanes of
       ``solve_patches_batched``, the 2.5D mode (slice ``tx``, 8 channels):
       lane fused loss 300 / 300 and nothing else;
    c. gpocs (``golden_pocs.json``, stop-grad eps): 5 seeds x 300 as 5
       lanes, lane fused loss 300 / 300, the step's ``fk_projection`` 300
       times;
    d. the flagship with ``phase_levels=3`` (``quality_3d.py``'s net), 9
       iterations traced as 7a: finite, fused 9 / 9, wgrad = the admitted
       convs, ``upsample_bwd`` = the hook's plain upsamples, iteration 0 to
       rel 1e-3 of phase 4's; every wgrad shape that phase 2 and 7d did not
       check held against its plain version and timed.

15. the zoo's remaining constructor options over spatial shards, each
    net given to the solver (``DIPSolver(model=...)``), solved unsharded
    and sharded along axis 1 with the launch counters set to 0 just before
    each solve and read just after: finite losses, an ``out_best`` of the
    image's shape, fused N x iterations forward and backward, wgrad N x
    the unsharded solve's, ``upsample_bwd`` N x the net's linear upsamples
    an iteration, the iteration-0 loss within 1e-3 (bf16) or 1e-5
    (float32; the CBAM U-Net 1e-4, its own conditioning) of the unsharded
    solve's, s/iteration and peak beside it:
    a. at the flagship volume and widths, 4 iterations in chunks of 2 (6
       in chunks of 3 before PR 17), over [cuda:0] x 2 and x 4: the skip net with reflection padding and
       Lanczos downsampling (bf16, trilinear), the U-Net with its deconv up
       path and ``more_layers=1`` (float32: its transposed convs compute in
       float32), the U-Net with ``concat_x`` (bf16, trilinear, 8 input
       channels);
    b. the lines command's patch with ``--pad_multiple 32`` over
       [cuda:0] x 2, 9 iterations with POCS: the CBAM U-Net (its gates'
       bilinear upsamples on the upsample kernel) and the ConvGRU ensemble
       of one frame (hidden 512);
    c. 15a's ``concat_x`` U-Net over 2 shards, two 3-iteration solves with
       deterministic cuDNN: bit-equal;
    d. each kernel at the new shard shapes: wgrad against its plain version
       timed beside its bound, the plain version and ``conv3d_weight``,
       ``upsample_bwd``
       bit-equal beside the plain version and the atomic backward, the
       fused loss on 15b's 2D shard outputs.

16. a module of the caller's own over spatial shards (the sharded walker
   of ``parallel/spatial_custom.py``): ``Caller3D``, the flagship
   MulResUnet as a child with glue around it (a 3 x 3 x 3 ``nn.Conv3d``
   64 -> 8 in the canvas's dtype, a spatial mean into an ``nn.Linear``
   gate, a 2 x 2 x 2 average pool, the port's trilinear x2 ``upsample``, a
   1 x 1 x 1 ``nn.Conv3d`` head in float32 and a scalar ``scale``: a
   library child, a halo conv, a spatial reduction feeding a replicated
   op, a local pool and a linear upsample), given to the solver as
   ``model=``, its weights made from seed 0:
   a. at the flagship volume, widths and flags (bf16, trilinear, the fused
      loss, the wgrad kernel), unsharded and over [cuda:0] x 2 and x 4
      along H, 6 iterations in chunks of 3, the launch counters set to 0
      just before each solve and read just after: fused N x iterations
      forward and backward, wgrad N x the unsharded solve's,
      ``upsample_bwd`` N x 5 an iteration (the body's 4, the glue's 1), the
      iteration-0 loss within 1e-4 of the unsharded solve's, s/iteration
      and peak beside it;
   b. two 3-iteration solves over 2 shards with deterministic cuDNN:
      bit-equal;
   c. the same module reading its pooled map's mean with ``.item()`` on
      the shards (a host read, which ``jax.jit`` refuses too):
      ``NotImplementedError`` naming the op and ROADMAP D.4, every launch
      counter still 0;
   d. each kernel at the new shard shapes (the glue's upsample, any wgrad
      shape no earlier phase held), as 15d.

17. a mesh of the devices there are, and spatial shards that do not lie on
   the net's blocks (``parallel/spatial.py``'s uneven layout):
   a. ``make_spatial_mesh(cards + 1)`` gives the cards there are and warns;
      the README's lines command through ``cli.run`` with
      ``--spatial_shards 2 --net part`` (on one card a one-device mesh)
      against 6f's unsharded ``--net part`` run, and with
      ``--batch_patches 2 --mesh_shape 2`` against the command without
      ``--mesh_shape``: bundles written, the fused loss launched on each
      shard or lane, the iteration-0 losses to rel 1e-5;
   b. the flagship (phase 4's configuration) over [cuda:0] x 10 along H,
      3 iterations: 128 planes as 16 x 6 + 8 x 4 (8 of its 16-plane
      blocks), its deepest level's 8 planes one a shard with two shards
      empty; launches and wgrad / upsample shapes computed from the layout,
      the iteration-0 loss within 1e-4 of phase 4's, s/iteration, peak and
      the layout at each level printed;
   c. the skip net (bf16, the flagship's widths) on (256, 112, 128), 3.5 of
      its 32-plane blocks, unsharded and over [cuda:0] x 2 and x 4, 4
      iterations: launches and shapes from the layout, iteration-0 losses
      within 1e-4 of the unsharded one's, two 2-shard solves bit-equal;
   d. each kernel at the new shard shapes, as 16d.

18. every op of a caller's module over spatial shards (the walker's
   relayout, window and whole routes): ``Caller18``, 16's ``Caller3D``
   whose glue also rolls its 8-channel pooled map by 3 planes along H,
   adds its flip, slices ``[..., 1:-1, :]`` and re-pads it circularly
   (relayouts), runs a ``'valid'`` 3 x 3 x 3 conv re-padded by one zero
   plane (a window), an ``rfft``/``irfft`` low-pass along H and a custom
   ``autograd.Function`` (the whole route), a ``torch.no_grad()`` scale
   and ``randn_like`` noise (drawn whole):
   a. at the flagship volume, widths and flags, unsharded and over
      [cuda:0] x 2 and x 4 along H, 6 iterations in chunks of 3: launches
      exactly N x the unsharded solve's for all three kernels, at 16a's
      shapes; the iteration-0 loss within 1e-4 of the unsharded solve's;
      ``SolveResult.whole_ops`` exactly the FFT pair and the Function;
      s/iteration and peak;
   b. two 3-iteration solves over 2 shards with deterministic cuDNN:
      bit-equal.

9. the CUDA-only tests (``tests/test_torch_cuda*.py``) in a child pytest,
   after phase 18; every one must pass.

Each phase's seconds are printed. The ``{"kernels": [...]}`` JSON is the
next-to-last line (each kernel with its launches by shard count in 10a,
11a, 11b, 12a, 12b, 13a-13c, 15a, 15b, 16a, 17a-17c, 18a, and in phase 14; each
kernel with its rows at 10a's, 12a's, the zoo's and phases 15's, 16's and
17's shard shapes), the ``{"phase18": ...}``, ``{"phase17": ...}``, ``{"phase16": ...}``,
``{"phase15": ...}``, ``{"phase14": ...}``,
``{"phase13": ...}``,
``{"phase12": ...}``, ``{"phase11": ...}``, ``{"phase10": ...}``,
``{"phase8": ...}``, ``{"phase7": ...}``, ``{"phase6": ...}``, ``{"cli": ...}``
and ``{"main_path": ...}`` lines before it, the last line ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by input type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
REPEATS = 3


def log(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _events_ms(fn, n: int) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def time_ms(fn, window_ms: float = 20.0, repeats: int = REPEATS) -> float:
    """Milliseconds of one ``fn()``: CUDA events around n back-to-back calls
    divided by n, n chosen so a window lasts about ``window_ms`` (3 to 500
    calls), after a warm-up; the median of ``repeats`` windows."""
    fn()
    n = max(3, min(500, math.ceil(window_ms / max(_events_ms(fn, 1), 1e-3))))
    return statistics.median(_events_ms(fn, n) for _ in range(repeats))


def graph_ms(fn, calls: int = 60) -> float:
    """Milliseconds of one ``fn()`` on the card alone: ``calls`` calls
    captured in one CUDA graph (after a warm-up on the capture stream) and
    the graph replayed back to back by ``time_ms``, so no host dispatch sits
    between the launches."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay) / calls


def cycling(fn, inputs: list):
    """A call of ``fn`` on the next of ``inputs`` each time: with copies
    that together exceed the 50 MB L2, each call finds its inputs in device
    memory, as the solver's loss does once an iteration."""
    state = {"i": 0}

    def call():
        fn(*inputs[state["i"] % len(inputs)])
        state["i"] += 1
    return call


def bound_ms(n_bytes: float, n_flops: float, dtype) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------

def _loss_bounds(n: int, out_dtype) -> tuple:
    """(forward, backward) bounds of the fused loss: each input read once,
    each output written once; ~17 and ~16 float32 flops a voxel."""
    esz = torch.empty((), dtype=out_dtype).element_size()
    fwd = bound_ms(n * (esz + 4 + 4) + 8 * 4, 17.0 * n, torch.float32)
    bwd = bound_ms(n * (esz + 4 + 4 + esz) + 8 * 4, 16.0 * n, torch.float32)
    return fwd, bwd


def check_fused_loss(dev):
    """Both fused-loss kernels against their plain versions at the flagship
    size, bf16 and float32 ``out``; returns the forward's and the backward's
    entries of the kernels line (bf16, the main path's, with float32 as a
    variant)."""
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
    from deep_prior_interpolation_tpu_torch.ops import losses as L

    img_np, mask_np = flagship_problem(256, 128, 128)
    img = torch.from_numpy(img_np[..., 0])[None, None].to(dev)
    mask = torch.from_numpy(mask_np[..., 0])[None, None].to(dev)
    n = img.numel()
    gen = torch.Generator(device=dev).manual_seed(3)
    noisy = img + torch.randn(img.shape, generator=gen, device=dev)
    outs = {"bfloat16": noisy.to(torch.bfloat16), "float32": noisy}
    # the main path's incoming gradient (mae alone) and one with all 8 non-zero
    g_main = torch.zeros(8, device=dev)
    g_main[0] = 1.0 / n
    g_rand = torch.randn(8, generator=gen, device=dev)
    if not bool((g_rand != 0).all()):
        fail("the random incoming gradient has a zero")

    # forward: float32 sums of 4.19 M terms in another order, relative 1e-4;
    # one launch and no float atomics, so repeated calls are bit-identical
    sums_abs = 0.0
    for name, out in outs.items():
        sums_k = FL.fused_sums(out, img, mask)
        sums_p = FL.fused_sums_plain(out, img, mask)
        rel = float(((sums_k - sums_p).abs() / sums_p.abs().clamp_min(1e-30)).max())
        sums_abs = max(sums_abs, float((sums_k - sums_p).abs().max()))
        same = all(torch.equal(FL.fused_sums(out, img, mask), sums_k) for _ in range(5))
        log(f"fused_loss sums, {name} out: max rel err {rel:.3e} (tol 1e-4), "
            f"5 repeated calls bit-identical: {same}")
        if not rel <= 1e-4:
            fail(f"fused_loss sums ({name} out) disagree with the plain version")
        if not same:
            fail(f"fused_loss sums ({name} out) differ from call to call")

    # the metrics, against the plain path of the loss as the solver computes it
    out = outs["bfloat16"]
    loss_k, mets_k = FL.fused_loss_metrics(out, img, mask, "mae")
    out32 = out.float()
    ref = {"loss": L.masked_mae(out, img, mask), "snr": L.snr(out32, img),
           "pcorr": L.pcorr(out32, img), "mse": L.masked_mse(out, img, mask)}
    got = {"loss": loss_k, "snr": mets_k["snr"], "pcorr": mets_k["pcorr"],
           "mse": mets_k["mse"]}
    # float32 sums in another order: relative 1e-4; the one-pass covariance
    # of pcorr against the two-pass form: absolute 1e-3
    tol = {"loss": ("rel", 1e-4), "snr": ("rel", 1e-4), "pcorr": ("abs", 1e-3),
           "mse": ("rel", 1e-4)}
    for k in ref:
        err = abs(float(got[k]) - float(ref[k]))
        kind, t = tol[k]
        lim = t * abs(float(ref[k])) if kind == "rel" else t
        log(f"fused_loss {k}: kernel {float(got[k]):.7g} plain {float(ref[k]):.7g} "
            f"abs err {err:.3e} (tol {kind} {t:g})")
        if not err <= lim:
            fail(f"fused_loss {k} disagrees with the plain version")

    # backward: the same float32 formula, term by term; within one bf16 ulp
    # of the plain value for bf16 out, 1e-5 of max |plain| for float32
    grad_abs = 0.0
    for name, out in outs.items():
        for gname, g in (("main-path g", g_main), ("random g", g_rand)):
            got = FL.loss_sums_grad(out, img, mask, g).float()
            ref = FL.loss_sums_grad_plain(out, img, mask, g).float()
            err = (got - ref).abs()
            grad_abs = max(grad_abs, float(err.max()))
            if name == "bfloat16":
                ok = bool((err <= 2.0 ** -7 * ref.abs()).all())
                tol_s = "|k-p| <= 2^-7 |p| per element"
            else:
                ok = float(err.max()) <= 1e-5 * float(ref.abs().max())
                tol_s = f"{1e-5 * float(ref.abs().max()):.3e}, 1e-5 of max |p|"
            log(f"fused_loss_grad, {name} out, {gname}: max abs err {float(err.max()):.3e} "
                f"(tol {tol_s})")
            if not ok:
                fail(f"fused_loss_grad ({name} out, {gname}) disagrees with the plain version")
            del got, ref, err

    # end to end: the kernels' gradient of the loss against autograd of the
    # plain masked_mae
    o1 = outs["bfloat16"].clone().requires_grad_(True)
    FL.fused_loss_metrics(o1, img, mask, "mae")[0].backward()
    o2 = outs["bfloat16"].clone().requires_grad_(True)
    L.masked_mae(o2, img, mask).backward()
    gerr = float((o1.grad.float() - o2.grad.float()).abs().max())
    glim = 1e-3 * float(o2.grad.float().abs().max())
    log(f"fused_loss autograd: max abs err {gerr:.3e} (tol {glim:.3e}, 1e-3 of max |grad|)")
    if not gerr <= glim:
        fail("fused_loss gradient disagrees with autograd of masked_mae")
    del o1, o2

    fwd = {"name": "fused_loss", "route": "cuda",
           "source": "deep_prior_interpolation_tpu_torch/csrc/fused_loss.cu",
           "replaces": "deep_prior_interpolation_tpu/ops/pallas_kernels.py:85",
           "shape": list(img.shape), "max_abs_err": sums_abs,
           "tolerance": "sums rel 1e-4; loss/snr/mse rel 1e-4; pcorr abs 1e-3",
           "library_ms": None, "variants": []}
    bwd = {"name": "fused_loss_grad", "route": "cuda",
           "source": "deep_prior_interpolation_tpu_torch/csrc/fused_loss.cu",
           "replaces": "deep_prior_interpolation_tpu/ops/pallas_kernels.py:128",
           "shape": list(img.shape), "max_abs_err": grad_abs,
           "tolerance": "bf16 |k-p| <= 2^-7 |p|; float32 1e-5 of max |p|",
           "library_ms": None, "variants": []}
    # times: "ms" and "plain_ms" on the card alone (CUDA-graph replay), the
    # "eager_" ones back-to-back eager calls, which add the host's dispatch
    # where it is the longer; both over three copies of the inputs (126-151
    # MB), so no call finds its inputs in L2
    fns = {"ms": (FL.fused_sums, FL.loss_sums_grad),
           "plain_ms": (FL.fused_sums_plain, FL.loss_sums_grad_plain)}
    for name, out in outs.items():
        copies = [(out.clone(), img.clone(), mask.clone()) for _ in range(3)]
        grads = [c + (g_main,) for c in copies]
        (fb, fby), (bb, bby) = _loss_bounds(n, out.dtype)
        rows = {"fwd": {"bound_ms": fb, "bound_by": fby},
                "bwd": {"bound_ms": bb, "bound_by": bby}}
        for key, (f_fwd, f_bwd) in fns.items():
            for row, fn, ins in (("fwd", f_fwd, copies), ("bwd", f_bwd, grads)):
                rows[row][key] = graph_ms(cycling(fn, ins))
                rows[row]["eager_" + key] = time_ms(cycling(fn, ins))
        for row, label in (("fwd", "forward"), ("bwd", "backward")):
            r = rows[row]
            log(f"fused_loss {label}, {name} out: ms {r['ms']:.4f} (eager {r['eager_ms']:.4f}) "
                f"plain {r['plain_ms']:.4f} (eager {r['eager_plain_ms']:.4f}) bound "
                f"{r['bound_ms']:.4f} ({r['bound_by']}), {r['bound_ms'] / r['ms']:.0%} of "
                f"the bound's speed")
        for entry, row in ((fwd, rows["fwd"]), (bwd, rows["bwd"])):
            if name == "bfloat16":
                entry.update(row)
            else:
                entry["variants"].append({"out_dtype": name, **row})
        del copies, grads
    return fwd, bwd


# the 24 distinct 3x3x3 stride-1 convs of the flagship MulResUnet 3D
# (filters [16, 32, 64, 128, 256], skip [16, 32, 64, 128], input depth 64)
# and their wgrad launches an iteration: (Ci, Co, spatial, launches)
_L = [(256, 128, 128), (128, 64, 64), (64, 32, 32), (32, 16, 16), (16, 8, 8)]
WGRAD_SHAPES = [
    (64, 4, _L[0], 1), (4, 8, _L[0], 2), (8, 13, _L[0], 2), (25, 16, _L[0], 1),
    (67, 4, _L[0], 1), (25, 1, _L[0], 1),
    (25, 8, _L[1], 1), (8, 17, _L[1], 2), (17, 26, _L[1], 2), (51, 32, _L[1], 1),
    (137, 8, _L[1], 1),
    (51, 17, _L[2], 1), (17, 35, _L[2], 2), (35, 53, _L[2], 2), (105, 64, _L[2], 1),
    (276, 17, _L[2], 1),
    (105, 35, _L[3], 1), (35, 71, _L[3], 2), (71, 106, _L[3], 2), (212, 128, _L[3], 1),
    (554, 35, _L[3], 1),
    (212, 71, _L[4], 1), (71, 142, _L[4], 1), (142, 213, _L[4], 1),
]
# shapes whose plain version is timed too (the others only checked)
PLAIN_TIMED = {(64, 4), (4, 8), (8, 13), (25, 16), (67, 4), (25, 1), (137, 8), (554, 35)}
# float32 (Config's default dtype): the full-resolution 25 -> 16 and a deep shape
FLOAT32_SHAPES = [(25, 16, _L[0]), (554, 35, _L[3])]


# the flagship's four trilinear upsamples (C, input spatial), one backward
# launch each an iteration
UPSAMPLE_SHAPES = [(426, _L[4]), (212, _L[3]), (105, _L[2]), (51, _L[1])]


def check_upsample(dev):
    """The upsample backward against its plain version at the flagship's
    shapes, bf16 (the main path's) and float32, and timed beside its bound
    and the atomic backward of ``F.interpolate``."""
    from deep_prior_interpolation_tpu_torch.ops import upsample as U

    g = torch.Generator(device=dev).manual_seed(7)
    rows, max_abs, per_iter, lib_iter, direct_iter = [], 0.0, 0.0, 0.0, 0.0
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        for c, sp in UPSAMPLE_SHAPES:
            out_sp = tuple(2 * s for s in sp)
            go = torch.randn((1, c) + out_sp, generator=g, device=dev).to(dt)
            got = U.upsample_bwd(go, 3)
            torch.cuda.synchronize()
            ref32 = U.upsample_bwd_plain(go.float(), 3)
            ref = ref32.to(dt)
            err32 = (got.float() - ref32).abs()
            if dt == torch.bfloat16:
                # round to nearest: within half a bf16 ulp, 2^-8 of |sum|
                ok = bool((err32 <= 2.0 ** -8 * ref32.abs()).all())
                tol = "|k - p32| <= 2^-8 |p32| per element (one bf16 rounding)"
            else:
                lim = 1e-6 * float(go.abs().max())
                ok = float(err32.max()) <= lim
                tol = f"{lim:.3e}, 1e-6 of max |g|"
            equal = torch.equal(got, ref)
            same = all(torch.equal(U.upsample_bwd(go, 3), got) for _ in range(3))
            max_abs = max(max_abs, float((got.float() - ref.float()).abs().max()))
            plan = U.plan(c, *sp, True, go.element_size(), go.data_ptr() % 16 == 0)
            log(f"upsample_bwd {c} x {sp} {name} ({plan.kernel} kernel): max abs err to the "
                f"float32 sum {float(err32.max()):.3e} (tol {tol}), bit-equal to the plain "
                f"version {equal}, 3 repeated calls bit-identical {same}")
            if not ok or not equal:
                fail(f"upsample_bwd {c} x {sp} {name} is not bit-equal to the plain version")
            if not same:
                fail(f"upsample_bwd {c} x {sp} {name} differs from call to call")
            if plan.kernel != "tma":
                fail(f"upsample_bwd {c} x {sp} {name} takes the {plan.kernel} kernel, not tma")
            del got, ref, ref32, err32
            row = {"channels": c, "spatial": list(sp), "dtype": name, "kernel": plan.kernel,
                   "plan": plan._asdict(),
                   "launches_per_iteration": 1 if dt == torch.bfloat16 else 0,
                   "bit_equal_to_plain": equal}
            row["ms"] = time_ms(lambda: U.upsample_bwd(go, 3))
            # the direct kernel (the earlier design, kept) at the same shape
            gin = torch.empty((1, c) + sp, dtype=dt, device=dev)
            direct = U.direct_plan(c, *sp, True)
            U._launch(go, gin, direct)
            if not torch.equal(gin, U.upsample_bwd_plain(go, 3)):
                fail(f"the direct kernel at {c} x {sp} {name} is not bit-equal to the plain one")
            row["direct_ms"] = time_ms(lambda: U._launch(go, gin, direct))
            del gin
            row["plain_ms"] = time_ms(lambda: U.upsample_bwd_plain(go, 3))
            sizes = [1, c, *sp]
            row["library_ms"] = time_ms(lambda: torch.ops.aten.upsample_trilinear3d_backward(
                go, list(out_sp), sizes, False, 2.0, 2.0, 2.0))
            n_in = c * math.prod(sp)
            # grad_out read once (8 x), grad_in written once; 7 flops an
            # output of each of the three passes (4 + 2 + 1 per input)
            row["bound_ms"], row["bound_by"] = bound_ms(9 * n_in * go.element_size(),
                                                        49.0 * n_in, torch.float32)
            log(f"  ms {row['ms']:.4f} ({plan.kernel}) direct kernel {row['direct_ms']:.4f} "
                f"plain {row['plain_ms']:.4f} atomic F.interpolate backward "
                f"{row['library_ms']:.4f} bound {row['bound_ms']:.4f} ({row['bound_by']}), "
                f"{row['bound_ms'] / row['ms']:.0%} of the bound's speed")
            per_iter += row["launches_per_iteration"] * row["ms"]
            lib_iter += row["launches_per_iteration"] * row["library_ms"]
            direct_iter += row["launches_per_iteration"] * row["direct_ms"]
            rows.append(row)
            del go
    log(f"upsample_bwd ms/iteration over the {len(UPSAMPLE_SHAPES)} bf16 launches: "
        f"{per_iter:.4f} (the direct kernel {direct_iter:.4f}, atomic F.interpolate backward "
        f"{lib_iter:.4f})")
    entry = {"name": "upsample_bwd", "route": "cuda",
             "source": "deep_prior_interpolation_tpu_torch/csrc/upsample.cu",
             "replaces": "deep_prior_interpolation_tpu/models/blocks.py:255",
             "max_abs_err": max_abs, "ms_per_iteration": per_iter,
             "direct_ms_per_iteration": direct_iter, "library_ms_per_iteration": lib_iter,
             "tolerance": "bit-equal to the plain version (bf16: one rounding of the float32 "
                          "sum; float32 1e-6 of max |g| also checked)",
             "shapes": rows}
    head = rows[len(UPSAMPLE_SHAPES) - 1]  # the largest, 51 x (128, 64, 64) bf16
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
        entry[key] = head[key]
    entry["shape"] = [head["channels"]] + head["spatial"]
    return entry


# the lines net's (the 2D MulResUnet on the (170, 100) lines gather) four
# bilinear upsamples, (C, input H x W), with ``--upsample bilinear``: 8b
# itself runs nearest upsampling, so these are the shapes its lane batches
# would give the kernel
LINES_UPSAMPLE_SHAPES = [(426, (11, 7)), (212, (22, 14)), (105, (44, 28)), (51, (88, 56))]


def check_upsample_2d(dev) -> list:
    """The 2D upsample backward at the lines net's bilinear shapes with B
    lanes folded into the planes (B = 32, 64), bf16: bit-equal to the plain
    version, timed beside its bound (5 x the input's bytes) and the atomic
    ``upsample_bilinear2d_backward``, with the kernel each shape takes."""
    from deep_prior_interpolation_tpu_torch.ops import upsample as U

    g = torch.Generator(device=dev).manual_seed(9)
    rows = []
    for b in (32, 64):
        per_iter = lib_iter = 0.0
        for c, hw in LINES_UPSAMPLE_SHAPES:
            out_hw = [2 * s for s in hw]
            go = torch.randn((1, b * c, *out_hw), generator=g, device=dev).to(torch.bfloat16)
            got = U.upsample_bwd(go, 2)
            equal = torch.equal(got, U.upsample_bwd_plain(go, 2))
            kernel = U.plan(b * c, 1, *hw, False, 2, go.data_ptr() % 16 == 0).kernel
            if not equal:
                fail(f"upsample_bwd 2D {b} x {c} x {hw} is not bit-equal to the plain version")
            ms = time_ms(lambda: U.upsample_bwd(go, 2))
            plain_ms = time_ms(lambda: U.upsample_bwd_plain(go, 2))
            lib = time_ms(lambda: torch.ops.aten.upsample_bilinear2d_backward(
                go, out_hw, [1, b * c, *hw], False, 2.0, 2.0))
            n_in = b * c * math.prod(hw)
            # 7 flops an output of each pass: 2 x 7 (W) + 7 (H) an input
            b_ms, b_by = bound_ms(5 * n_in * 2, 21.0 * n_in, torch.float32)
            log(f"upsample_bwd 2D lines B = {b}: {b * c} planes x {hw} bf16 ({kernel} kernel), "
                f"bit-equal {equal}; ms {ms:.4f} plain {plain_ms:.4f} atomic F.interpolate "
                f"backward {lib:.4f} bound {b_ms:.4f} ({b_by}), {b_ms / ms:.0%} of the bound's "
                f"speed")
            per_iter += ms
            lib_iter += lib
            rows.append({"lanes": b, "planes": b * c, "spatial": list(hw), "kernel": kernel,
                         "ms": ms, "plain_ms": plain_ms, "library_ms": lib, "bound_ms": b_ms,
                         "bound_by": b_by,
                         "bit_equal_to_plain": equal})
        log(f"upsample_bwd 2D lines B = {b}: {per_iter:.4f} ms a step over the four "
            f"(atomic {lib_iter:.4f})")
    return rows


def time_upsample_forward(dev) -> list:
    """``F.interpolate``'s trilinear forward (the upsample's forward, no
    kernel of the port's) alone at the main path's four shapes, bf16, beside
    its bound: the input read once, 8 x its bytes written."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(10)
    rows, per_iter = [], 0.0
    for c, sp in UPSAMPLE_SHAPES:
        x = torch.randn((1, c, *sp), generator=g, device=dev).to(torch.bfloat16)
        ms = time_ms(lambda: F.interpolate(x, scale_factor=2, mode="trilinear",
                                           align_corners=False))
        n_in = c * math.prod(sp)
        # 8 outputs of 3 lerps (3 flops each) an input
        b_ms, b_by = bound_ms(9 * n_in * 2, 72.0 * n_in, torch.float32)
        log(f"F.interpolate trilinear forward {c} x {sp} bf16: ms {ms:.4f} bound {b_ms:.4f} "
            f"({b_by}), {b_ms / ms:.0%} of the bound's speed")
        per_iter += ms
        rows.append({"channels": c, "spatial": list(sp), "ms": ms, "bound_ms": b_ms,
                     "bound_by": b_by, "launches_per_iteration": 1})
    log(f"F.interpolate trilinear forward ms/iteration over the four: {per_iter:.4f}")
    return rows


# the flagship's Norm inputs, (C, spatial, Norms of that shape an
# iteration): 70 Norms, 1.408e9 elements an iteration
NORM_SHAPES = [
    (4, _L[0], 2), (8, _L[0], 2), (13, _L[0], 2), (25, _L[0], 6), (16, _L[0], 3),
    (25, _L[1], 1), (8, _L[1], 2), (17, _L[1], 2), (26, _L[1], 2), (51, _L[1], 6),
    (32, _L[1], 3),
    (51, _L[2], 1), (17, _L[2], 2), (35, _L[2], 2), (53, _L[2], 2), (105, _L[2], 6),
    (64, _L[2], 3),
    (105, _L[3], 1), (35, _L[3], 2), (71, _L[3], 2), (106, _L[3], 2), (212, _L[3], 6),
    (128, _L[3], 3),
    (212, _L[4], 1), (71, _L[4], 1), (142, _L[4], 1), (213, _L[4], 1), (426, _L[4], 3),
]


def _device_launches(fn, calls: int = 4) -> int:
    """Kernels, copies and memsets one ``fn()`` puts on the card: the
    profiler's device events of ``calls`` calls over ``calls``, rounded (a
    session may drop an event)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return round(n / calls)


def check_norm_act(dev, dtypes=(torch.bfloat16, torch.float32)) -> dict:
    """The Norm's kernel pair (``ops/norm_act.py``) at the flagship's 28 Norm
    shapes: first held against the plain version in float32 from the same
    input (``check_against_plain`` of tests/test_torch_cuda_norm_act.py, its
    tolerances; LeakyReLU fused and the identity), then forward and backward timed (LeakyReLU fused, as ConvNormAct
    takes it) beside two bounds: the design's (6 + 10 bytes an element in
    bf16, 12 + 20 in float32: x is read twice a direction, dz twice
    backward) and the function's least traffic (4 + 6 in bf16, 8 + 12 in
    float32: read x, write z; read x and dz, write dx), the plain version (``norm_act_plain``, autograd's backward)
    and the library (``F.batch_norm(training=True)`` then ``F.leaky_relu``,
    timed here only, never called by the port); the kernels' device time
    from CUDA graphs of 20 calls, their eager time (events around
    back-to-back calls, the host's dispatch included) beside it, as the
    plain version's and the library's are timed; summed over each
    resolution's Norms (the 70 of an iteration) and over all. Launches of
    one Norm of each, forward and backward, from the profiler."""
    import torch.nn.functional as F
    from deep_prior_interpolation_tpu_torch.ops import norm_act as NA
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from test_torch_cuda_norm_act import check_against_plain
    from test_torch_norm_act import closed_backward

    out = {}
    for dt in dtypes:
        es = torch.tensor([], dtype=dt).element_size()
        rows, totals = [], collections.Counter()
        for k, (c, sp, count) in enumerate(NORM_SHAPES):
            g = torch.Generator(device=dev).manual_seed(k)
            x = (torch.randn((1, c, *sp), generator=g, device=dev) + 0.5).to(dt)
            dz = torch.randn((1, c, *sp), generator=g, device=dev).to(dt)
            scale = torch.rand(c, generator=g, device=dev) + 0.5
            bias = torch.randn(c, generator=g, device=dev)
            for leaky in (k % 2 == 0, k % 2 == 1):
                try:
                    z, stats, dx, *_ = check_against_plain(x, dz, scale, bias, leaky)
                except AssertionError as e:
                    fail(f"norm_act {c} x {sp} {dt} (leaky {leaky}) disagrees with its plain "
                         f"version: {e}")
                err_z = float((z.float() - NA.norm_act_plain(x.float(), scale, bias,
                                                             leaky=leaky)).abs().max())
                err_dx = float((dx.float() - closed_backward(x[None], dz[None], stats[None],
                                                              leaky)[0][0].float()).abs().max())
                del z, stats, dx
            z, stats = NA.norm_act_forward(x, scale, bias, leaky=True)
            fwd = lambda: NA.norm_act_forward(x, scale, bias, leaky=True)  # noqa: E731
            bwd = lambda: NA.norm_act_backward(x, dz, stats, True)  # noqa: E731
            # device time from CUDA graphs of the calls; eager adds the host's dispatch
            row = {"channels": c, "spatial": list(sp), "norms": count,
                   "max_abs_err_z": err_z, "max_abs_err_dx": err_dx,
                   "fwd_ms": graph_ms(fwd, 20), "bwd_ms": graph_ms(bwd, 20),
                   "fwd_eager_ms": time_ms(fwd), "bwd_eager_ms": time_ms(bwd)}
            n = x.numel()
            row["fwd_bound_ms"] = bound_ms(3 * es * n, 0, dt)[0]
            row["bwd_bound_ms"] = bound_ms(5 * es * n, 0, dt)[0]
            row["fwd_least_ms"] = bound_ms(2 * es * n, 0, dt)[0]
            row["bwd_least_ms"] = bound_ms(3 * es * n, 0, dt)[0]
            ins = [x.clone().requires_grad_(), scale.clone().requires_grad_(),
                   bias.clone().requires_grad_()]
            for name, fn in (("plain", lambda: NA.norm_act_plain(*ins, leaky=True)),
                             ("library", lambda: F.leaky_relu(F.batch_norm(
                                 ins[0], None, None, ins[1], ins[2], training=True,
                                 eps=1e-5), 0.2))):
                y = fn()
                row[f"{name}_fwd_ms"] = time_ms(fn)
                row[f"{name}_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                    y, ins, dz, retain_graph=True))
                if k in (0, len(NORM_SHAPES) - 1):
                    row[f"{name}_launches"] = [_device_launches(fn), _device_launches(
                        lambda: torch.autograd.grad(y, ins, dz, retain_graph=True))]
                del y
            if k in (0, len(NORM_SHAPES) - 1):
                row["launches"] = [_device_launches(lambda: NA.norm_act_forward(
                    x, scale, bias, leaky=True)), _device_launches(
                    lambda: NA.norm_act_backward(x, dz, stats, True))]
            for key in ("fwd_ms", "bwd_ms", "fwd_eager_ms", "bwd_eager_ms", "fwd_bound_ms",
                        "bwd_bound_ms", "fwd_least_ms", "bwd_least_ms", "plain_fwd_ms",
                        "plain_bwd_ms", "library_fwd_ms", "library_bwd_ms"):
                totals[f"{sp[0]}:{key}"] += count * row[key]
                totals[key] += count * row[key]
            rows.append(row)
            del x, dz, z, stats, ins
            log(f"norm_act {c} x {sp} {dt}: as its plain version (max abs err z {err_z:.3e}, "
                f"dx {err_dx:.3e}); fwd {row['fwd_ms']:.4f} bwd {row['bwd_ms']:.4f} "
                f"ms (eager {row['fwd_eager_ms']:.4f} / {row['bwd_eager_ms']:.4f}; bound "
                f"{row['fwd_bound_ms']:.4f} / {row['bwd_bound_ms']:.4f}, least "
                f"{row['fwd_least_ms']:.4f} / {row['bwd_least_ms']:.4f}); plain "
                f"{row['plain_fwd_ms']:.4f} / {row['plain_bwd_ms']:.4f}; library "
                f"{row['library_fwd_ms']:.4f} / {row['library_bwd_ms']:.4f}")
        for res in [sp[0] for sp in _L] + [None]:
            p = f"{res}:" if res else ""
            kern = totals[p + "fwd_ms"] + totals[p + "bwd_ms"]
            eager = totals[p + "fwd_eager_ms"] + totals[p + "bwd_eager_ms"]
            bnd = totals[p + "fwd_bound_ms"] + totals[p + "bwd_bound_ms"]
            least = totals[p + "fwd_least_ms"] + totals[p + "bwd_least_ms"]
            log(f"norm_act {dt} {'resolution D=' + str(res) if res else 'all 70 Norms'}: "
                f"kernels {kern:.4f} ms an iteration (fwd {totals[p + 'fwd_ms']:.4f}, bwd "
                f"{totals[p + 'bwd_ms']:.4f}; eager {eager:.4f}), design bound {bnd:.4f} "
                f"({bnd / kern:.1%} of it), least-traffic bound {least:.4f} "
                f"({least / kern:.1%}); plain "
                f"{totals[p + 'plain_fwd_ms'] + totals[p + 'plain_bwd_ms']:.4f}; library "
                f"{totals[p + 'library_fwd_ms'] + totals[p + 'library_bwd_ms']:.4f}")
        log(f"norm_act {dt} launches (fwd, bwd) a Norm: kernels {rows[0]['launches']}, plain "
            f"{rows[0]['plain_launches']}, library {rows[0]['library_launches']}")
        out[str(dt).split(".")[-1]] = {
            "rows": rows, "totals": dict(totals),
            "max_abs_err": max(max(r["max_abs_err_z"], r["max_abs_err_dx"]) for r in rows)}
    return out


def _valid_products(sp, k: int) -> int:
    """Positions x taps that read inside the volume (the padding taps do no work)."""
    p = (k - 1) // 2
    total = 0
    for a in range(-p, p + 1):
        for b in range(-p, p + 1):
            for c in range(-p, p + 1):
                total += (sp[0] - abs(a)) * (sp[1] - abs(b)) * (sp[2] - abs(c))
    return total


def wgrad_row(dev, ci: int, co: int, sp, dt, n: int, g, time_plain: bool,
              k: int = 3) -> dict:
    """One wgrad shape: the kernel against its plain version (1e-4 of max
    |dW| + 1e-4), then its time beside the plain version's (when asked),
    ``conv3d_weight``'s (TF32 off) and its bound."""
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

    x = torch.randn((1, ci) + tuple(sp), generator=g, device=dev).to(dt)
    dy = torch.randn((1, co) + tuple(sp), generator=g, device=dev).to(dt)
    got = WG.wgrad3d(x, dy, k)
    torch.cuda.synchronize()
    ref = WG.wgrad3d_plain(x, dy, k)
    err = float((got - ref).abs().max())
    # both sum float32 products of the same inputs, in other orders
    lim = 1e-4 * float(ref.abs().max()) + 1e-4
    name = str(dt).split(".")[-1]
    row = {"ci": ci, "co": co, "spatial": list(sp), "dtype": name,
           "launches_per_iteration": n, "max_abs_err": err, "tol": lim}
    log(f"wgrad {ci}->{co} {tuple(sp)} {name}: max abs err {err:.3e} "
        f"(tol {lim:.3e}, 1e-4 of max |dW| + 1e-4)")
    if not err <= lim:
        fail(f"wgrad {ci}->{co} {tuple(sp)} {name} disagrees with the plain version")
    del got, ref
    w = torch.empty((co, ci, k, k, k), device=dev, dtype=dt)
    row["ms"] = time_ms(lambda: WG.wgrad3d(x, dy, k))
    row["plain_ms"] = time_ms(lambda: WG.wgrad3d_plain(x, dy, k)) if time_plain else None
    # cuDNN with TF32 off: a float32 yardstick for the float32 kernel
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        row["library_ms"] = time_ms(lambda: torch.nn.grad.conv3d_weight(
            x, w.shape, dy, stride=1, padding=(k - 1) // 2))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    n_bytes = (ci + co) * math.prod(sp) * x.element_size() + co * ci * k ** 3 * 4
    n_flops = 2.0 * ci * co * _valid_products(sp, k)
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_flops, dt)
    plain = "not timed" if row["plain_ms"] is None else f"{row['plain_ms']:.4f}"
    log(f"  ms {row['ms']:.4f} plain {plain} conv3d_weight {row['library_ms']:.4f}"
        f"{' (TF32 off)' if dt == torch.float32 else ''} bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']}), {n} launches/iteration, "
        f"{'not slower' if row['ms'] <= row['library_ms'] else 'SLOWER'} than conv3d_weight")
    return row


def check_wgrad(dev):
    cases = [(ci, co, sp, n, torch.bfloat16) for ci, co, sp, n in WGRAD_SHAPES]
    cases += [(ci, co, sp, 0, torch.float32) for ci, co, sp in FLOAT32_SHAPES]
    g = torch.Generator(device=dev).manual_seed(5)
    rows, max_abs, per_iter = [], 0.0, 0.0
    for ci, co, sp, n, dt in cases:
        row = wgrad_row(dev, ci, co, sp, dt, n, g, (ci, co) in PLAIN_TIMED)
        max_abs = max(max_abs, row["max_abs_err"])
        per_iter += n * row["ms"]
        rows.append(row)
    log(f"wgrad ms/iteration: sum of launches x ms over the {len(WGRAD_SHAPES)} bf16 "
        f"shapes ({sum(n for *_, n in WGRAD_SHAPES)} launches) = {per_iter:.4f}")
    entry = {"name": "wgrad3d", "route": "cuda",
             "source": "deep_prior_interpolation_tpu_torch/csrc/wgrad3d.cu",
             "replaces": "deep_prior_interpolation_tpu/ops/pallas_wgrad.py:182",
             "max_abs_err": max_abs, "ms_per_iteration": per_iter,
             "tolerance": "1e-4 of max |dW| + 1e-4 per shape", "shapes": rows}
    # the headline numbers: the heaviest flagship shape, 67 -> 4 at full res
    head = rows[4]
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
        entry[key] = head[key]
    entry["shape"] = [head["ci"], head["co"]] + head["spatial"]
    return entry


# ----------------------------------------------------------------------
# phases 3 and 4: the solver
# ----------------------------------------------------------------------

FLAGSHIP = dict(datadim="3d", inputdepth=64, filters=[16, 32, 64, 128, 256],
                skip=[16, 32, 64, 128], upsample="linear", loss="mae", lr=1e-3,
                gain=40.0, reg_noise_std=0.03, dtype="bfloat16",
                phase_space=False, remat=False, fused_loss=True, epochs=9,
                scan_chunk=3)


def flagship_config(**kw):
    from deep_prior_interpolation_tpu_torch import Config
    return Config(**{**FLAGSHIP, **kw})


def flagship_flags() -> list:
    """The flagship's configuration as command-line flags."""
    flags = []
    for k, v in FLAGSHIP.items():
        if v is True:
            flags.append(f"--{k}")
        elif isinstance(v, list):
            flags += [f"--{k}"] + [str(x) for x in v]
        elif v is not False:
            flags += [f"--{k}", str(v)]
    return flags


@contextlib.contextmanager
def tensor_op_norms():
    """Every Norm on its tensor ops (``norm_act_plain``) within the block, as
    a list of spatial shards takes them: an unsharded reference of a sharded
    check then computes the shards' Norm arithmetic (the kernel pair rounds
    once less)."""
    from deep_prior_interpolation_tpu_torch.ops import norm_act as NA
    real = NA.takes_kernel
    NA.takes_kernel = lambda x, phase=1: False
    try:
        yield
    finally:
        NA.takes_kernel = real


def set_kernels(on: bool) -> None:
    os.environ["DPI_PALLAS_WGRAD"] = "1" if on else "0"


NORM_WRAPPERS = ("norm_act_forward", "norm_act_backward", "norm_act_forward_lanes",
                 "norm_act_backward_lanes")


def reset_counts() -> None:
    from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
    from deep_prior_interpolation_tpu_torch.ops import norm_act as NA
    from deep_prior_interpolation_tpu_torch.ops import upsample as U
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG
    FL.fused_sums.launches = 0
    FL.loss_sums_grad.launches = 0
    WG.wgrad3d.launches = 0
    U.upsample_bwd.launches = 0
    U.upsample_bwd.tma_launches = 0
    U.upsample_bwd.direct_launches = 0
    for fn in NORM_WRAPPERS:
        getattr(NA, fn).launches = 0


def read_norm_counts() -> dict:
    """The Norm kernel pair's launches, one-lane and lane, since the
    counters were last set to 0 (read apart from ``read_counts``, whose
    keys every phase compares whole)."""
    from deep_prior_interpolation_tpu_torch.ops import norm_act as NA
    return {fn: getattr(NA, fn).launches for fn in NORM_WRAPPERS}


def read_upsample_kernels() -> dict:
    """The launches of each of ``upsample_bwd``'s two kernels since the
    counters were last set to 0 (``upsample_bwd.launches`` is their sum)."""
    from deep_prior_interpolation_tpu_torch.ops import upsample as U
    return {"tma": U.upsample_bwd.tma_launches, "direct": U.upsample_bwd.direct_launches}


def read_counts() -> dict:
    from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
    from deep_prior_interpolation_tpu_torch.ops import upsample as U
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG
    return {"fused_loss": FL.fused_sums.launches,
            "fused_loss_grad": FL.loss_sums_grad.launches, "wgrad3d": WG.wgrad3d.launches,
            "upsample_bwd": U.upsample_bwd.launches}


def small_problem():
    """Phase 3's problem: a tiny 3D net in float32 on a 16^3 volume, with
    a canvas and initial weights shared by every device and formulation
    (the devices draw different random streams)."""
    from deep_prior_interpolation_tpu_torch import Config, DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.models import init_weights

    img, mask = flagship_problem(16, 16, 16)
    cfg = Config(datadim="3d", inputdepth=4, filters=[4, 8, 16], skip=[4, 4],
                 upsample="linear", epochs=6, scan_chunk=3, reg_noise_std=0.0,
                 fused_loss=True, dtype="float32")
    noise = (0.1 * np.random.RandomState(0).randn(16, 16, 16, 4)).astype(np.float32)
    cpu = DIPSolver(cfg, device="cpu")
    init_weights(cpu.model, torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    return cfg, img, mask, noise, init, cpu


def check_small_solve(dev) -> np.ndarray:
    """Tiny 3D solve, kernels on the card vs plain versions on the CPU;
    returns the card's loss history."""
    from deep_prior_interpolation_tpu_torch import DIPSolver

    cfg, img, mask, noise, init, cpu = small_problem()
    set_kernels(True)
    r_cpu = cpu.solve(img, mask, seed=0, init_params=init, noise=noise)
    reset_counts()
    r_gpu = DIPSolver(cfg, device=dev).solve(img, mask, seed=0, init_params=init,
                                             noise=noise)
    counts = read_counts()
    a, b = np.asarray(r_gpu.history.loss), np.asarray(r_cpu.history.loss)
    # float32 both sides (TF32 off), but cuDNN and the CPU sum in other
    # orders, and Adam's sign-like first steps blow ulp-level differences up
    # within a few iterations (measured on the card: 2e-5 after 4 steps, 7e-3
    # after 6 in one run, 2e-5 in another): hold the first 3 iterations
    err = float(np.max(np.abs(a[:3] - b[:3]) / np.abs(b[:3])))
    log(f"small solve: card {a.tolist()}\n             cpu  {b.tolist()}\n"
        f"             max rel err of iterations 0-2 {err:.3e} (tol 1e-4), "
        f"launches {counts}")
    if not err <= 1e-4:
        fail("the small solve on the card disagrees with the CPU")
    if counts["fused_loss"] != 6 or counts["fused_loss_grad"] != 6 or counts["wgrad3d"] == 0 \
            or counts["upsample_bwd"] != 6 * 2:
        fail(f"small solve did not go through the kernels: {counts}")
    return a


class hooked:
    """Within the block, hooks on the conv's weight gradient and the
    upsample's backward record the shapes they are asked for (at their
    callers: a wrapper counts its launches on its own name): ``wgrad``
    (Ci, Co, x's spatial) and ``upsample`` (C, the input's spatial)."""

    def __enter__(self):
        from deep_prior_interpolation_tpu_torch.ops import conv_vjp
        from deep_prior_interpolation_tpu_torch.ops import upsample as U

        self.wgrad, self.upsample = collections.Counter(), collections.Counter()
        self._real = conv_vjp.wgrad3d, U._LinearUpsample2x.backward
        real, real_up = self._real

        def hook(x, dy, k):
            self.wgrad[(x.shape[1], dy.shape[1], tuple(x.shape[2:]))] += 1
            return real(x, dy, k)

        def hook_up(ctx, g):
            self.upsample[(g.shape[1], tuple(s // 2 for s in g.shape[2:]))] += 1
            return real_up(ctx, g)
        conv_vjp.wgrad3d, U._LinearUpsample2x.backward = hook, staticmethod(hook_up)
        return self

    def __exit__(self, *exc):
        from deep_prior_interpolation_tpu_torch.ops import conv_vjp
        from deep_prior_interpolation_tpu_torch.ops import upsample as U
        conv_vjp.wgrad3d, U._LinearUpsample2x.backward = self._real[0], \
            staticmethod(self._real[1])


def traced_solve(solver, img, mask, **kw):
    """``solver.solve(img, mask, seed=0, **kw)`` with the launch counters set to 0
    just before and read just after, and the shapes ``hooked`` records.
    Returns (result, launches, wgrad shapes, upsample shapes)."""
    with hooked() as seen:
        reset_counts()
        res = solver.solve(img, mask, seed=0, **kw)
        counts = read_counts()
    return res, counts, seen.wgrad, seen.upsample


# the port's kernels in a device trace, by the counter of ``read_counts``
# (the upsample's by ``read_upsample_kernels``) and of ``read_norm_counts``
TRACE_KERNELS = (("fused_loss", r"\bloss_sums_kernel\b"),
                 ("fused_loss_grad", r"\bloss_grad_kernel\b"),
                 ("wgrad3d", r"\bwgrad3d_(mma|fma)\b"),
                 ("upsample_bwd", r"\bupsample_bwd_(tma|direct)\b"),
                 ("tma", r"\bupsample_bwd_tma\b"), ("direct", r"\bupsample_bwd_direct\b"),
                 ("norm_act_forward", r"\bnorm_(stats|apply)_kernel\b"),
                 ("norm_act_backward", r"\bnorm_(grad_sums|grad)_kernel\b"))


def traced_kernels(prof) -> dict:
    """The port's kernels that a ``torch.profiler`` session saw run on the
    card, by ``TRACE_KERNELS``' names."""
    import re
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {key: sum(1 for n in names if re.search(rx, n)) for key, rx in TRACE_KERNELS}


def main_path(dev) -> dict:
    import warnings
    from torch.profiler import ProfilerActivity, profile
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.engine import solver as S
    from deep_prior_interpolation_tpu_torch.ops import norm_act as NA

    img, mask = flagship_problem(256, 128, 128)
    cfg = flagship_config()
    set_kernels(True)
    solver = DIPSolver(cfg, outchannel=1, device=dev)
    DIPSolver(flagship_config(epochs=1, scan_chunk=1), outchannel=1, device=dev).solve(
        img, mask, seed=0)
    S._GRAPHS = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    norms, routes = dict(NA.routes), dict(S.graph_routes)
    try:
        with warnings.catch_warnings(record=True) as caught, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            warnings.simplefilter("always")
            res, counts, seen, seen_up = traced_solve(solver, img, mask)
            torch.cuda.synchronize()
    finally:
        S._GRAPHS = False
    kinds = read_upsample_kernels()
    norm_counts = read_norm_counts()
    norms = {k: NA.routes[k] - norms.get(k, 0) for k in ("kernel", "plain")}
    routes = {k: n - routes.get(k, 0) for k, n in S.graph_routes.items()
              if n != routes.get(k, 0)}
    traced = traced_kernels(prof)
    fell_back = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    log(f"main path: steps by route {routes} (expected eager 1, captured 1, replayed 7); "
        f"runtime warnings {fell_back}")
    if routes != {"eager": 1, "captured": 1, "replayed": 7} or fell_back:
        fail(f"the main path's steps took the routes {routes}, warnings {fell_back}")
    want_traced = {"fused_loss": 9, "fused_loss_grad": 9, "wgrad3d": 9 * 32,
                   "upsample_bwd": 9 * 4, "tma": 9 * 4, "direct": 0,
                   "norm_act_forward": 9 * 70 * 2, "norm_act_backward": 9 * 70 * 2}
    log(f"main path: the port's kernels in the device trace {traced} (expected {want_traced})")
    if traced != want_traced:
        fail(f"the main path's device trace holds the port's kernels {traced}")
    # below, what Python called: the eager step 0 and the captured step 1
    # plain: the solver's one shape pass of the net on the meta device
    log(f"main path: Norms by route {norms} (expected kernel {2 * 70}, plain 70)")
    if norms != {"kernel": 2 * 70, "plain": 70}:
        fail(f"the main path's Norms took the routes {norms}")
    want_norm = {"norm_act_forward": 2 * 70 * 2, "norm_act_backward": 2 * 70 * 2,
                 "norm_act_forward_lanes": 0, "norm_act_backward_lanes": 0}
    log(f"main path: Norm launches {norm_counts} (expected {want_norm})")
    if norm_counts != want_norm:
        fail(f"the main path's Norm launch counts are {norm_counts}")
    want = {(ci, co, sp): 2 * n for ci, co, sp, n in WGRAD_SHAPES}
    if dict(seen) != want:
        fail(f"the main path's wgrad shapes are {dict(seen)}, not {want}")
    want_up = {(c, sp): 2 for c, sp in UPSAMPLE_SHAPES}
    if dict(seen_up) != want_up:
        fail(f"the main path's upsample shapes are {dict(seen_up)}, not {want_up}")
    log(f"main path: wgrad and upsample shapes as listed in the kernel phase "
        f"({len(seen)} and {len(seen_up)} distinct)")
    peak = torch.cuda.max_memory_allocated()
    loss = np.asarray(res.history.loss)
    log(f"main path: losses {loss.tolist()}")
    log(f"main path: snr {np.asarray(res.history.snr).tolist()}")
    log(f"main path: launches called from Python {counts} (expected fused_loss 2, "
        f"fused_loss_grad 2, wgrad3d {2 * 32}, upsample_bwd {2 * 4})")
    if not (len(loss) == 9 and np.all(np.isfinite(loss))):
        fail("the flagship loss is not finite for 9 iterations")
    if res.out_best.shape != img.shape or not np.all(np.isfinite(res.out_best)):
        fail(f"out_best has shape {res.out_best.shape} or is not finite")
    if counts != {"fused_loss": 2, "fused_loss_grad": 2, "wgrad3d": 2 * 32,
                  "upsample_bwd": 2 * 4}:
        fail(f"the main path's launch counts are {counts}")
    log(f"main path: upsample_bwd launches by kernel {kinds} (expected tma {2 * 4}, direct 0)")
    if kinds != {"tma": 2 * 4, "direct": 0}:
        fail(f"the main path's upsample launches by kernel are {kinds}")
    steady = statistics.median(res.chunk_seconds[1:]) / cfg.scan_chunk
    log(f"main path: chunk seconds {res.chunk_seconds}")
    log(f"main path: steady s/iteration {steady:.4f} (median of chunks 2.., under the "
        f"profiler), peak memory {peak / 2**30:.2f} GiB, reserved "
        f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB")
    # the solve's launches, as the kernels' table reports them: the trace's
    counts = {k: traced[k] for k in counts}
    kinds = {k: traced[k] for k in kinds}
    norm_counts = {k: traced.get(k, 0) for k in norm_counts}
    del solver

    # the same solve with both kernels off: the same forward pass (the Norm
    # kernels on in both; phase 2 holds them against their plain version)
    set_kernels(False)
    off = DIPSolver(flagship_config(fused_loss=False, epochs=3), outchannel=1,
                    device=dev).solve(img, mask, seed=0)
    set_kernels(True)
    l_on, l_off = float(loss[0]), float(off.history.loss[0])
    rel = abs(l_on - l_off) / abs(l_off)
    log(f"kernels off: iteration-0 loss {l_off:.7g} vs on {l_on:.7g}, "
        f"rel err {rel:.3e} (tol 1e-5)")
    if not rel <= 1e-5:
        fail("iteration-0 loss differs with the kernels off")
    return {"counts": counts, "s_per_iter": steady, "peak_bytes": peak, "loss0": l_on,
            "upsample_kernels": kinds, "losses": loss.tolist(), "norm_counts": norm_counts}


# ----------------------------------------------------------------------
# phase 5: the CLI
# ----------------------------------------------------------------------

# the keys of the JAX package's run bundle, in its order (io/results.py)
BUNDLE_KEYS = ["device", "elapsed", "elapsed_seconds", "outpath", "history", "mask",
               "image", "output", "noise", "pocs"]


class solves:
    """Records every ``DIPSolver.solve`` result while the block runs."""

    def __enter__(self):
        from deep_prior_interpolation_tpu_torch.engine import DIPSolver
        self.results, self.real, cls = [], DIPSolver.solve, DIPSolver

        def spy(solver, *a, **k):
            res = self.real(solver, *a, **k)
            self.results.append(res)
            return res
        cls.solve = spy
        return self

    def __exit__(self, *exc):
        from deep_prior_interpolation_tpu_torch.engine import DIPSolver
        DIPSolver.solve = self.real


def cli_survey(dev, tmp: str) -> dict:
    """A 3D survey of two flagship-size patches through ``cli.run``."""
    from deep_prior_interpolation_tpu_torch import cli
    from deep_prior_interpolation_tpu_torch.config import parse_arguments
    from deep_prior_interpolation_tpu_torch.data import (hyperbolic_events,
                                                         random_trace_mask,
                                                         reconstruct_patches)
    from deep_prior_interpolation_tpu_torch.io import load_run
    from deep_prior_interpolation_tpu_torch.ops.pocs import fk_projection

    vol = hyperbolic_events(256, 256, 128)
    kept = random_trace_mask(vol.shape, 0.66, 1) > 0
    np.save(os.path.join(tmp, "original.npy"), vol)
    np.save(os.path.join(tmp, "corrupted.npy"), np.where(kept, vol, np.nan).astype(np.float32))
    cfg = parse_arguments(flagship_flags() + [
        "--imgdir", tmp, "--imgname", "original.npy", "--maskname", "corrupted.npy",
        "--outdir", "survey", "--datadim", "3d", "--patch_shape", "256", "128", "128",
        "--gain", "40", "--epochs", "6", "--scan_chunk", "3", "--save_every", "3",
        "--pocs", "--savemodel"])
    set_kernels(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with solves() as rec:
        out = cli.run(cfg, results_root=tmp)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"cli survey: launches {counts} (expected fused_loss 12, fused_loss_grad 12, "
        f"wgrad3d {2 * 6 * 32}, upsample_bwd {2 * 6 * 4})")
    if counts != {"fused_loss": 12, "fused_loss_grad": 12, "wgrad3d": 2 * 6 * 32,
                  "upsample_bwd": 2 * 6 * 4}:
        fail(f"the survey's launch counts are {counts}")
    if len(rec.results) != 2:
        fail(f"the survey solved {len(rec.results)} patches, not 2")

    files = set(os.listdir(out))
    for i, name in enumerate(("0", "1")):
        for f in (f"{name}_run.npz", f"{name}_output3.npy", f"{name}_model.msgpack"):
            if f not in files:
                fail(f"the survey did not write {f}: {sorted(files)}")
        with np.load(os.path.join(out, f"{name}_run.npz"), allow_pickle=True) as z:
            if list(z.files) != BUNDLE_KEYS:
                fail(f"bundle {name} has keys {z.files}, not {BUNDLE_KEYS}")
        b = load_run(os.path.join(out, f"{name}_run.npz"))
        hist = b["history"]
        if not all(len(v) == 6 and np.all(np.isfinite(v)) for v in hist.values()):
            fail(f"patch {name}'s history is not 6 finite iterations: {hist}")
        log(f"cli survey: patch {name} loss {hist['loss']}\n"
            f"            df {hist['df']}\n            reg {hist['reg']}\n"
            f"            eps {hist['eps']}\n            th {hist['th']}")
        if b["output"].shape != (256, 128, 128, 1) or not np.all(np.isfinite(b["pocs"])):
            fail(f"patch {name}: output {b['output'].shape}, pocs finite "
                 f"{np.all(np.isfinite(b['pocs']))}")
        if b["device"] != f"{torch.cuda.get_device_name(0)} (0)":
            fail(f"patch {name} was solved on {b['device']}")

    rec_vol = reconstruct_patches(cfg, results_dir=out)
    if rec_vol.shape != (256, 256, 128) or not np.all(np.isfinite(rec_vol)):
        fail(f"the reconstruction has shape {rec_vol.shape} or is not finite")
    rel = 0.0
    for i, name in enumerate(("0", "1")):
        want = load_run(os.path.join(out, f"{name}_run.npz"))["output"][..., 0] / 40.0
        w = want.shape[1]  # the patches tile the x axis
        got = rec_vol[:, w * i:w * (i + 1)]
        rel = max(rel, float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30))))
    log(f"cli survey: reconstruction {rec_vol.shape}, max rel err against each bundle's "
        f"output / 40 {rel:.3e} (tol 1e-6)")
    if not rel <= 1e-6:
        fail("the reconstruction disagrees with the bundles")

    reset_counts()
    with solves() as again:
        cli.run(cfg, results_root=tmp)
    if again.results or any(read_counts().values()):
        fail(f"the resumed survey solved {len(again.results)} patches, "
             f"launches {read_counts()}")
    log("cli survey: a second run on the same directory skipped both patches, "
        "launched nothing")

    steady = [r.chunk_seconds[1] / cfg.scan_chunk for r in rec.results]
    log(f"cli survey: chunk seconds {[r.chunk_seconds for r in rec.results]}, steady "
        f"s/iteration {steady}, peak memory {peak / 2**30:.2f} GiB")

    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((1, 1, 256, 128, 128), generator=g, device=dev)
    m = (torch.rand(x.shape, generator=g, device=dev) > 0.66).float()
    wd, wm = 0.1 * x * m, 1.0 - 0.1 * m
    fk_ms = time_ms(lambda: fk_projection(x, wd, wm, 5.0))
    log(f"cli survey: fk_projection (1, 1, 256, 128, 128) float32 {fk_ms:.4f} ms")
    return {"launches": counts, "s_per_iter": steady, "peak_memory_bytes": peak,
            "fk_projection_ms": fk_ms}


def lines_config(outdir: str, *extra):
    """The README's command on the bundled lines data, with POCS and the
    ``extra`` flags."""
    from deep_prior_interpolation_tpu_torch.config import parse_arguments
    from deep_prior_interpolation_tpu_torch.data import dataset_path

    return parse_arguments([
        "--imgdir", os.path.dirname(dataset_path("lines/original.npy")),
        "--imgname", "original.npy", "--maskname", "random66.npy", "--datadim", "2d",
        "--outdir", outdir, "--pocs", "--pocs_alpha", "0.1", "--pocs_thresh", "5",
        "--fused_loss", "--epochs", "9", "--gain", "1", *extra])


def cli_lines(tmp: str, extra=(), outdir: str = "lines", ups: int = 0) -> dict:
    """The README's command on the bundled lines data, with POCS (and the
    ``extra`` flags, such as another ``--net``, whose forward has ``ups``
    linear upsamples)."""
    from deep_prior_interpolation_tpu_torch import cli
    from deep_prior_interpolation_tpu_torch.engine import HistoryPOCS
    from deep_prior_interpolation_tpu_torch.io import load_run

    cfg = lines_config(outdir, *extra)
    reset_counts()
    out = cli.run(cfg, results_root=tmp)
    counts = read_counts()
    hist = load_run(os.path.join(out, "0_run.npz"))["history"]
    log(f"cli lines {' '.join(extra)}: launches {counts} (expected 9, 9, 0, {9 * ups}), "
        f"loss {hist['loss']}")
    if counts != {"fused_loss": 9, "fused_loss_grad": 9, "wgrad3d": 0, "upsample_bwd": 9 * ups}:
        fail(f"the lines run {extra}'s launch counts are {counts}")
    if set(hist) != set(HistoryPOCS.FIELDS) or not all(
            len(v) == 9 and np.all(np.isfinite(v)) for v in hist.values()):
        fail(f"the lines run {extra}'s history is not 9 finite POCS iterations: {hist}")
    return {"launches": counts, "loss": hist["loss"]}


def check_resume(dev, tmp: str, main: dict) -> dict:
    """5c: the flagship net and volume, 6 iterations straight with a
    checkpoint path, then 3 saved after each chunk and resumed to 6 in a
    fresh process (``resume_child``); history and out_best bit-equal."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem

    img, mask = flagship_problem(256, 128, 128)
    cfg = flagship_config(epochs=6, scan_chunk=3)
    set_kernels(True)
    reset_counts()
    straight = DIPSolver(cfg, device=dev).solve(
        img, mask, seed=0, checkpoint_path=os.path.join(tmp, "straight.npz"))
    straight_counts = read_counts()
    if torch.backends.cudnn.deterministic:
        fail("the solver left cudnn.deterministic set")
    steady = straight.chunk_seconds[1] / cfg.scan_chunk
    log(f"5c straight (deterministic cuDNN): launches {straight_counts}, chunk seconds "
        f"{straight.chunk_seconds}, steady s/iteration {steady:.4f} against phase 4's "
        f"{main['s_per_iter']:.4f} without")
    if straight_counts != SIX:
        fail(f"5c: the straight run's launch counts are {straight_counts}, not {SIX}")

    path = os.path.join(tmp, "resume.npz")
    DIPSolver(flagship_config(epochs=3, scan_chunk=3), device=dev).solve(
        img, mask, seed=0, checkpoint_path=path, checkpoint_every=1)
    with np.load(path) as z:
        plans = len(json.loads(str(z["__meta__"]))["wgrad_plans"])
    np.save(os.path.join(tmp, "img.npy"), img)
    np.save(os.path.join(tmp, "mask.npy"), mask)
    with open(os.path.join(tmp, "cfg.json"), "w") as fh:
        json.dump(cfg.to_dict(), fh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t = time.time()
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--resume-child", tmp],
                           capture_output=True, text=True, timeout=900)
    log("\n".join(f"  child: {line}" for line in child.stdout.splitlines()))
    if child.returncode != 0:
        fail(f"5c: the resuming process failed ({child.returncode}):\n{child.stderr[-4000:]}")
    with np.load(os.path.join(tmp, "resumed.npz")) as z:
        resumed = {k: z[k] for k in z.files}
    a, b = resumed["loss"], np.asarray(straight.history.loss)
    hist_equal = all(np.array_equal(resumed[f], np.asarray(getattr(straight.history, f)))
                     for f in straight.history.FIELDS)
    out_equal = np.array_equal(resumed["out_best"], straight.out_best)
    log(f"5c: {plans} wgrad grids in the checkpoint; the resuming process ran "
        f"{time.time() - t:.1f} s\n  straight {b.tolist()}\n  resumed  {a.tolist()}\n"
        f"  history bit-equal {hist_equal}, out_best bit-equal {out_equal}")
    if not (hist_equal and out_equal and len(a) == 6):
        fail("5c: the resumed solve is not bit-equal to the straight one")
    return {"straight_s_per_iter": steady, "phase4_s_per_iter": main["s_per_iter"],
            "wgrad_plans_pinned": int(resumed["pinned"]), "history_bit_equal": hist_equal,
            "out_best_bit_equal": out_equal, "child_launches": json.loads(str(resumed["counts"]))}


def resume_child(tmp: str) -> None:
    """The resuming process of 5c: a fresh interpreter, the wgrad tuner
    empty; the solve resumes from ``tmp/resume.npz`` to 6 iterations. Its
    tuner must time nothing: every grid comes pinned from the checkpoint."""
    from deep_prior_interpolation_tpu_torch import Config, DIPSolver
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

    dev = torch.device("cuda:0")
    with open(os.path.join(tmp, "cfg.json")) as fh:
        cfg = Config.from_dict(json.load(fh))
    img, mask = np.load(os.path.join(tmp, "img.npy")), np.load(os.path.join(tmp, "mask.npy"))
    tuned, pinned = [], []
    real_tune, real_pin = WG._tune, WG.pin_plans

    def spy_tune(x, dy, k):
        tuned.append((tuple(x.shape), tuple(dy.shape)))
        return real_tune(x, dy, k)

    def spy_pin(entries):
        pinned.append(real_pin(entries))
        return pinned[-1]
    WG._tune, WG.pin_plans = spy_tune, spy_pin
    reset_counts()
    res = DIPSolver(cfg, device=dev).solve(img, mask, seed=0,
                                           checkpoint_path=os.path.join(tmp, "resume.npz"))
    counts = read_counts()
    want = {k: v // 2 for k, v in SIX.items()}
    log(f"pinned {pinned} wgrad grids, timed {len(tuned)} shapes, launches {counts}, "
        f"iterations {res.iters_run}")
    if tuned or not pinned or not pinned[0]:
        fail(f"the resume timed {tuned} or pinned nothing ({pinned})")
    if counts != want:
        fail(f"the resume's launch counts are {counts}, not {want}")
    np.savez(os.path.join(tmp, "resumed.npz"), out_best=res.out_best, pinned=pinned[0],
             counts=json.dumps(counts),
             **{f: np.asarray(getattr(res.history, f)) for f in res.history.FIELDS})


# ----------------------------------------------------------------------
# phase 6: the solver options and the model zoo at full width
# ----------------------------------------------------------------------

# what was predicted for 6a's peak before the first card run of it (PERF.md)
PREDICTED_6A = ("remat frees the insides of every MultiResBlock and ResPath and the "
                "virtual canvas its 0.5 GiB: 6-9 GiB")
SIX = {"fused_loss": 6, "fused_loss_grad": 6, "wgrad3d": 6 * 32, "upsample_bwd": 6 * 4}


def option_solve(dev, label: str, cfg, img, mask, expect=None, seed: int = 0):
    """One solve, the launch counters set to 0 just before and read just
    after, with its peak memory and steady s/iteration (chunk 2); fails on a
    non-finite loss, or launch counts other than ``expect``."""
    from deep_prior_interpolation_tpu_torch import DIPSolver

    set_kernels(True)
    solver = DIPSolver(cfg, outchannel=1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = solver.solve(img, mask, seed=seed)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    loss = np.asarray(res.history.loss)
    steady = res.chunk_seconds[min(1, len(res.chunk_seconds) - 1)] / cfg.scan_chunk
    log(f"{label}: losses {loss.tolist()}\n  launches {counts}, peak memory "
        f"{peak / 2**30:.2f} GiB, chunk seconds {res.chunk_seconds}, steady s/iteration "
        f"{steady:.4f}")
    if not (len(loss) == cfg.epochs and np.all(np.isfinite(loss))):
        fail(f"{label}: the loss is not finite for {cfg.epochs} iterations")
    if expect is not None and counts != expect:
        fail(f"{label}: launch counts {counts}, expected {expect}")
    del solver
    return {"losses": loss.tolist(), "launches": counts, "peak_bytes": peak,
            "s_per_iter": steady}, res


def check_options(dev, main: dict) -> dict:
    """6a-6d: remat, the virtual canvas, dropout, parameter noise, input
    optimisation, data forgetting and the low-pass canvas on the flagship."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.engine import build_base_input
    from deep_prior_interpolation_tpu_torch.engine.solver import _generators

    img, mask = flagship_problem(256, 128, 128)
    out = {}
    six = dict(epochs=6, scan_chunk=3)
    r, _ = option_solve(dev, "6a remat + virtual_input",
                        flagship_config(remat=True, virtual_input=True, **six), img, mask, SIX)
    rel = abs(r["losses"][0] - main["loss0"]) / abs(main["loss0"])
    cut = main["peak_bytes"] - r["peak_bytes"]
    log(f"6a: iteration-0 loss {r['losses'][0]:.7g} vs phase 4's {main['loss0']:.7g}, rel "
        f"err {rel:.3e} (tol 1e-5); peak {r['peak_bytes'] / 2**30:.2f} GiB vs phase 4's "
        f"{main['peak_bytes'] / 2**30:.2f} GiB: {cut / 2**30:.2f} GiB less "
        f"(predicted: {PREDICTED_6A})")
    if not rel <= 1e-5:
        fail("6a: the iteration-0 loss differs from phase 4's")
    if not cut > 0:
        fail("6a: remat and the virtual canvas did not lower the peak memory")
    out["6a_remat_virtual"] = dict(r, loss0_rel_err=rel)

    r, _ = option_solve(dev, "6b remat + dropout 0.1 + param_noise",
                        flagship_config(remat=True, dropout=0.1, param_noise=True, **six),
                        img, mask, SIX)
    out["6b_remat_dropout_param_noise"] = r

    for remat in (False, True):
        r, _ = option_solve(dev, f"6d float32{' + remat' if remat else ''}",
                            flagship_config(dtype="float32", remat=remat, **six), img, mask,
                            SIX)
        out[f"6d_float32{'_remat' if remat else ''}"] = r

    # the JAX package refuses a bfloat16 canvas under optimisation
    try:
        DIPSolver(flagship_config(opt_over="net,input", **six), device=dev).solve(img, mask)
        fail("6c: opt_over='net,input' under bfloat16 did not raise TypeError")
    except TypeError as e:
        log(f"6c: under bfloat16 the options raise TypeError, as in the JAX package: {e}")
    cfg = flagship_config(dtype="float32", opt_over="net,input", data_forgetting_factor=5,
                          lowpass_fs=250.0, lowpass_fc=40.0, **six)
    r, res = option_solve(dev, "6c float32 opt_over=net,input + forgetting 5 + low-pass",
                          cfg, img, mask, SIX)
    first = build_base_input(cfg, _generators(0, dev)["canvas"], (256, 128, 128), dev)
    moved = float((torch.from_numpy(res.noise).to(dev)
                   - first[0].permute(1, 2, 3, 0)).abs().max())
    log(f"6c: the canvas moved by max |d| {moved:.4e} in 6 iterations")
    if not moved > 0:
        fail("6c: the optimised canvas did not move")
    out["6c_opt_input_forgetting_lowpass"] = dict(r, canvas_max_abs_change=moved)
    del res, first
    return out


class conv_spy:
    """Within the block, counts the card's ``conv_same`` calls by (x shape,
    w shape, stride, padding, dtype); ``admitted`` counts those that the
    wgrad gate takes to the kernel (``DPI_PALLAS_WGRAD=1``), ``away`` lists
    the others' shapes as (Ci, Co, k, stride, spatial)."""

    def __enter__(self):
        from deep_prior_interpolation_tpu_torch.ops import conv_vjp
        self.convs, real = collections.Counter(), conv_vjp._ConvSame.apply

        def spy(x, w, stride, padding, mode):
            if x.is_cuda:  # not a net's build pass on the CPU
                self.convs[(tuple(x.shape), tuple(w.shape), stride, padding,
                            str(x.dtype))] += 1
            return real(x, w, stride, padding, mode)
        conv_vjp._ConvSame.apply = spy
        return self

    def __exit__(self, *exc):
        from deep_prior_interpolation_tpu_torch.ops import conv_vjp
        del conv_vjp._ConvSame.apply

    @property
    def admitted(self) -> int:
        from deep_prior_interpolation_tpu_torch.ops import wgrad as WG
        return sum(n for (xs, ws, st, p, _), n in self.convs.items()
                   if WG.wgrad_supported(xs, ws, st, p))

    @property
    def away(self) -> list:
        from deep_prior_interpolation_tpu_torch.ops import wgrad as WG
        return sorted({(xs[1], ws[0], ws[2], st, xs[2:]) for xs, ws, st, p, _ in self.convs
                       if not WG.wgrad_supported(xs, ws, st, p)})


def check_zoo(dev) -> dict:
    """6e: skip, unet (bf16) and part (float32, which the JAX package runs
    only so) at the flagship volume and flags, 6 iterations each; every conv
    that reaches the wgrad kernel recorded, each new shape held against the
    plain version and timed."""
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.ops import conv_vjp

    img, mask = flagship_problem(256, 128, 128)
    flagship = {(ci, co, sp, "bfloat16") for ci, co, sp, _ in WGRAD_SHAPES}
    flagship |= {(ci, co, sp, "float32") for ci, co, sp in FLOAT32_SHAPES}
    g = torch.Generator(device=dev).manual_seed(6)
    out = {}
    # the linear upsamples of each net's forward
    for net, dtype, ups in (("skip", "bfloat16", 5), ("unet", "bfloat16", 4),
                            ("part", "float32", 0)):
        seen, real_wgrad = collections.Counter(), conv_vjp.wgrad3d

        def hook(x, dy, k):
            seen[(x.shape[1], dy.shape[1], tuple(x.shape[2:]),
                  str(x.dtype).split(".")[-1])] += 1
            return real_wgrad(x, dy, k)
        conv_vjp.wgrad3d = hook
        try:
            with conv_spy() as spy:
                r, _ = option_solve(dev, f"6e --net {net} ({dtype})",
                                    flagship_config(net=net, dtype=dtype, epochs=6,
                                                    scan_chunk=3), img, mask)
        finally:
            conv_vjp.wgrad3d = real_wgrad
        admitted, away = spy.admitted, spy.away
        log(f"6e --net {net}: {admitted // 6} of {sum(spy.convs.values()) // 6} conv_same calls "
            f"an iteration reach the wgrad kernel; turned away to conv3d_weight "
            f"(Ci, Co, k, stride, spatial): {away}")
        c = r["launches"]
        if c["wgrad3d"] != admitted or admitted % 6 or c["fused_loss"] != 6 \
                or c["fused_loss_grad"] != 6 or c["upsample_bwd"] != 6 * ups:
            fail(f"6e --net {net}: launches {c}, expected fused 6 / 6, wgrad "
                 f"{admitted} ({admitted // 6} admitted convs x 6), upsample_bwd {6 * ups}")
        rows = []
        for (ci, co, sp, dt), n in sorted(seen.items(), key=lambda kv: -math.prod(kv[0][2])):
            if (ci, co, sp, dt) in flagship:
                continue
            rows.append(wgrad_row(dev, ci, co, sp, getattr(torch, dt), n // 6, g, False))
        per_iter = sum(row["ms"] * row["launches_per_iteration"] for row in rows)
        log(f"6e --net {net}: {len(rows)} new wgrad shapes, their ms/iteration {per_iter:.4f}")
        out[net] = dict(r, dtype=dtype, wgrad_launches_per_iteration=admitted // 6,
                        turned_away=[list(map(str, a)) for a in away], wgrad_shapes=rows,
                        wgrad_calls=[[ci, co, list(sp), dt, n // 6]
                                     for (ci, co, sp, dt), n in sorted(seen.items())])
        torch.cuda.empty_cache()
    return out


def check_ensemble(dev) -> dict:
    """6g: the ConvGRU ensemble (a library net, outside the solver): one
    forward and backward on the card, float32 with TF32 off, against the
    same on the CPU in float64. Its gradients pass through ~40 Norms: in
    float32 they hold to ~1 % of the largest gradient only (measured on the
    CPU, float32 against float64: 0.96 % at the stem conv, the output
    2.4e-5 of its largest value)."""
    import copy

    from deep_prior_interpolation_tpu_torch.models import Ensemble, init_weights

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    m = Ensemble(1, 1, num_frames=2, hidden=16)
    init_weights(m, torch.Generator().manual_seed(0), "xavier", 0.02)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, 1, 128, 128), generator=gen)
    cot = torch.randn((2, 1, 128, 128), generator=gen)

    def run(d, dt):
        mm = copy.deepcopy(m).to(d, dt)
        o = mm(x.to(d, dt))
        (o * cot.to(d, dt)).sum().backward()
        return (o.detach().cpu().double(),
                {n: p.grad.detach().cpu().double() for n, p in mm.named_parameters()})
    o_gpu, g_gpu = run(dev, torch.float32)
    o_cpu, g_cpu = run("cpu", torch.float64)
    out_err = float((o_gpu - o_cpu).abs().max()) / float(o_cpu.abs().max())
    g_max = max(float(v.abs().max()) for v in g_cpu.values())
    g_err = max(float((g_gpu[k] - v).abs().max()) for k, v in g_cpu.items()) / g_max
    log(f"6g Ensemble (128 x 128, 2 frames, hidden 16): output max err {out_err:.3e} of its "
        f"max (tol 2e-4), gradients max err {g_err:.3e} of the largest (tol 3e-2)")
    if not (out_err <= 2e-4 and g_err <= 3e-2):
        fail("6g: the ensemble on the card disagrees with the CPU")
    return {"output_rel_err": out_err, "grad_rel_err": g_err}


# ----------------------------------------------------------------------
# phase 7: phase space and the alternative conv formulations
# ----------------------------------------------------------------------

# the phase flagship: bench.py's default (phase levels 2), phase 4's flags
PHASE7 = dict(phase_space=True, phase_levels=2, phase_deep_levels=0)
_P = [(128, 64, 64), (64, 32, 32)]
# its wgrad shapes (Ci, Co, spatial, launches an iteration): the 9 phase
# convs of resolutions 0 and 1 on their phase grids (channels x 8), new to
# the kernel, then the 13 plain convs of resolutions 2-4 that phase 2 checks
PHASE_WGRAD_NEW = [(536, 32, _P[0], 1), (200, 128, _P[0], 1), (200, 8, _P[0], 1),
                   (64, 104, _P[0], 2), (32, 64, _P[0], 2), (1096, 64, _P[1], 1),
                   (408, 256, _P[1], 1), (136, 208, _P[1], 2), (64, 136, _P[1], 2)]
PHASE_WGRAD_SHAPES = PHASE_WGRAD_NEW + [r for r in WGRAD_SHAPES if r[2] in _L[2:]]
# the two upsamples left plain (resolutions 3 and 4 are not phased)
PHASE_UPSAMPLE_SHAPES = UPSAMPLE_SHAPES[:2]
PHASE_COUNTS = {"fused_loss": 9, "fused_loss_grad": 9, "wgrad3d": 9 * 30, "upsample_bwd": 9 * 2}
# what was predicted before the first card run of phase 7 (PERF.md)
PREDICTED_7A = ("0.16-0.25 s/iteration (8x the MACs at resolutions 0-1, on wider "
                "channels), 13.4-15 GiB")
# bf16: the phase net rounds at other places than the plain one (the JAX
# package holds their outputs to 0.05 of the output's scale); the loss, a
# masked mean over 1.4 M voxels, averages that out: 5e-5 and 6e-5 measured
# on the CPU at (64, 32, 32) with two seeds
LOSS0_TOL_BF16 = 1e-3


def phase_flagship(dev, main: dict) -> dict:
    """7a: the phase flagship through ``DIPSolver.solve``, 9 iterations in
    chunks of 3, hooks on the wgrad kernel's and the upsample's callers."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem

    img, mask = flagship_problem(256, 128, 128)
    cfg = flagship_config(**PHASE7)
    set_kernels(True)
    solver = DIPSolver(cfg, outchannel=1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, counts, seen, seen_up = traced_solve(solver, img, mask)
    peak = torch.cuda.max_memory_allocated()
    want = {(ci, co, sp): 9 * n for ci, co, sp, n in PHASE_WGRAD_SHAPES}
    if dict(seen) != want:
        fail(f"7a: the phase path's wgrad shapes are {dict(seen)}, not {want}")
    want_up = {(c, sp): 9 for c, sp in PHASE_UPSAMPLE_SHAPES}
    if dict(seen_up) != want_up:
        fail(f"7a: the phase path's upsample shapes are {dict(seen_up)}, not {want_up}")
    loss = np.asarray(res.history.loss)
    log(f"7a phase flagship: losses {loss.tolist()}")
    log(f"7a: {len(seen)} distinct wgrad shapes ({len(PHASE_WGRAD_NEW)} new), "
        f"{len(seen_up)} upsample shapes; launches {counts} (expected {PHASE_COUNTS})")
    if not (len(loss) == 9 and np.all(np.isfinite(loss))):
        fail("7a: the phase flagship's loss is not finite for 9 iterations")
    if res.out_best.shape != img.shape or not np.all(np.isfinite(res.out_best)):
        fail(f"7a: out_best has shape {res.out_best.shape} or is not finite")
    if counts != PHASE_COUNTS:
        fail(f"7a: the phase path's launch counts are {counts}")
    steady = statistics.median(res.chunk_seconds[1:]) / cfg.scan_chunk
    rel = abs(float(loss[0]) - main["loss0"]) / abs(main["loss0"])
    log(f"7a: chunk seconds {res.chunk_seconds}; steady s/iteration {steady:.4f} against "
        f"phase 4's {main['s_per_iter']:.4f}; peak memory {peak / 2**30:.2f} GiB against "
        f"phase 4's {main['peak_bytes'] / 2**30:.2f} (predicted: {PREDICTED_7A})")
    log(f"7a: iteration-0 loss {float(loss[0]):.7g} against phase 4's {main['loss0']:.7g} "
        f"(same parameters and canvas), rel err {rel:.3e} (tol {LOSS0_TOL_BF16:g})")
    if not rel <= LOSS0_TOL_BF16:
        fail("7a: the phase flagship's iteration-0 loss differs from phase 4's")
    del solver
    return {"launches": counts, "s_per_iter": steady, "peak_bytes": peak,
            "phase4_s_per_iter": main["s_per_iter"], "phase4_peak_bytes": main["peak_bytes"],
            "loss0": float(loss[0]), "loss0_rel_err": rel, "losses": loss.tolist()}


def phase_exactness(dev) -> dict:
    """7b: one float32 forward of the plain and the phase flagship nets at
    (256, 128, 128), same parameters and canvas (TF32 off): outputs to 2e-5
    of the output's scale, masked L1 losses to rel 1e-5 (the JAX package's
    exactness tolerance); levels 2, then levels 3 with resolution 0 at depth 2."""
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.models import get_net, init_weights
    from deep_prior_interpolation_tpu_torch.ops import losses as L

    img_np, mask_np = flagship_problem(256, 128, 128)
    img = torch.from_numpy(img_np[..., 0])[None, None].to(dev)
    mask = torch.from_numpy(mask_np[..., 0])[None, None].to(dev)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        plain = get_net(flagship_config(dtype="float32"))
        init_weights(plain, torch.Generator().manual_seed(0))
        state = plain.state_dict()
        plain = plain.to(dev)
        g = torch.Generator(device=dev).manual_seed(11)
        x = 0.1 * torch.randn((1, 64, 256, 128, 128), generator=g, device=dev)
        with torch.no_grad():
            y0 = plain(x)
            del plain
            loss0 = float(L.masked_mae(y0, img, mask))
            scale = float(y0.abs().max())
            for levels, deep in ((2, 0), (3, 1)):
                net = get_net(flagship_config(dtype="float32", phase_space=True,
                                              phase_levels=levels, phase_deep_levels=deep))
                net.load_state_dict(state)
                net = net.to(dev)
                t = time.time()
                y = net(x)
                torch.cuda.synchronize()
                secs = time.time() - t
                err = float((y - y0).abs().max()) / scale
                lrel = abs(float(L.masked_mae(y, img, mask)) - loss0) / abs(loss0)
                log(f"7b float32 phase levels {levels}, deep {deep}: max |y - y_plain| / "
                    f"max |y_plain| {err:.3e} (tol 2e-5), masked L1 rel err {lrel:.3e} "
                    f"(tol 1e-5), forward {secs:.2f} s")
                if not (err <= 2e-5 and lrel <= 1e-5):
                    fail(f"7b: the float32 phase net (levels {levels}, deep {deep}) is not "
                         f"the plain net")
                out[f"levels{levels}_deep{deep}"] = {"out_rel_err": err, "loss_rel_err": lrel,
                                                     "forward_s": secs}
                del net, y
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return out


def phase_determinism(dev, tmp: str) -> dict:
    """7c: two 3-iteration phase-flagship solves from one seed with a
    checkpoint path (so deterministic cuDNN), the second after the wgrad
    tuner was emptied and given the first's grids from its checkpoint:
    nothing timed, history and out_best bit-equal."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

    img, mask = flagship_problem(256, 128, 128)
    cfg = flagship_config(**PHASE7, epochs=3, scan_chunk=3)
    set_kernels(True)
    new = {(ci, co, sp) for ci, co, sp, _ in PHASE_WGRAD_NEW}

    def grids():
        return {(e["key"][0][1], e["key"][1][1], tuple(e["key"][0][2:])): e["plan"]
                for e in WG.tuned_plans() if e["key"][3] == "bfloat16"
                and (e["key"][0][1], e["key"][1][1], tuple(e["key"][0][2:])) in new}
    first = DIPSolver(cfg, device=dev).solve(img, mask, seed=0, checkpoint_path=os.path.join(
        tmp, "phase_a.npz"), checkpoint_every=1)
    before = grids()
    with np.load(os.path.join(tmp, "phase_a.npz")) as z:
        saved = json.loads(str(z["__meta__"]))["wgrad_plans"]
    WG._tuned.clear()
    pinned = WG.pin_plans(saved)
    tuned, real_tune = [], WG._tune

    def spy_tune(x, dy, k):
        tuned.append((tuple(x.shape), tuple(dy.shape)))
        return real_tune(x, dy, k)
    WG._tune = spy_tune
    try:
        second = DIPSolver(cfg, device=dev).solve(img, mask, seed=0, checkpoint_path=os.path.join(
            tmp, "phase_b.npz"), checkpoint_every=1)
    finally:
        WG._tune = real_tune
    hist_equal = all(np.array_equal(getattr(first.history, f), getattr(second.history, f))
                     for f in first.history.FIELDS)
    out_equal = np.array_equal(first.out_best, second.out_best)
    log(f"7c: losses {first.history.loss} / {second.history.loss}; {pinned} grids pinned "
        f"from the first solve's checkpoint ({len(before)} of the 9 new shapes), shapes "
        f"timed by the second {len(tuned)}; history bit-equal {hist_equal}, out_best "
        f"bit-equal {out_equal}")
    if len(before) != len(new) or grids() != before or tuned:
        fail(f"7c: the new shapes' grids were not pinned across the two solves "
             f"({len(before)} kept, timed {tuned})")
    if not (hist_equal and out_equal):
        fail("7c: two phase-flagship solves from one seed are not bit-equal")
    return {"grids_pinned": pinned, "history_bit_equal": hist_equal,
            "out_best_bit_equal": out_equal}


def phase_wgrad(dev, wgrad: dict, counts: dict) -> dict:
    """7d: the wgrad kernel at the 9 phase shapes against its plain version,
    timed beside its bound and ``conv3d_weight``; and the one full-resolution
    weight gradient the phase path leaves to cuDNN, the entry conv's ((4, 4,
    4), stride 2, over (1, 64, 256, 128, 128)), against the folded form."""
    from deep_prior_interpolation_tpu_torch.ops import conv_vjp

    g = torch.Generator(device=dev).manual_seed(12)
    rows = [wgrad_row(dev, ci, co, sp, torch.bfloat16, n, g, True)
            for ci, co, sp, n in PHASE_WGRAD_NEW]
    old = {(r["ci"], r["co"], tuple(r["spatial"])): r["ms"] for r in wgrad["shapes"]
           if r["dtype"] == "bfloat16"}
    per_iter = sum(r["ms"] * r["launches_per_iteration"] for r in rows) + sum(
        n * old[(ci, co, sp)] for ci, co, sp, n in PHASE_WGRAD_SHAPES[len(PHASE_WGRAD_NEW):])
    log(f"7d: wgrad ms/iteration on the phase path, sum of launches x ms over its 22 shapes "
        f"(30 launches) = {per_iter:.4f} (plain flagship {wgrad['ms_per_iteration']:.4f})")

    x = torch.randn((1, 64, 256, 128, 128), generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn((1, 32, 128, 64, 64), generator=g, device=dev).to(torch.bfloat16)
    w_shape, pads = (32, 64, 4, 4, 4), ((1, 1),) * 3
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = torch.nn.grad.conv3d_weight(x.float(), w_shape, dy.float(), stride=2, padding=1)
        folded = conv_vjp._folded_wgrad(x, dy, w_shape, 2, pads)
        err = float((folded - ref).abs().max())
        # phase 2's tolerance: the same float32 products (bf16 products are
        # exact in float32) summed in other orders, here 0.5 M a term
        lim = 1e-4 * float(ref.abs().max()) + 1e-4
        entry = {"shape": [64, 32, 4, 2, 256, 128, 128], "max_abs_err_folded": err}
        entry["library_ms"] = time_ms(lambda: torch.nn.grad.conv3d_weight(
            x, w_shape, dy, stride=2, padding=1))
        entry["folded_ms"] = time_ms(lambda: conv_vjp._folded_wgrad(x, dy, w_shape, 2, pads))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    n_bytes = (x.numel() + dy.numel()) * 2 + math.prod(w_shape) * 4
    entry["bound_ms"], entry["bound_by"] = bound_ms(n_bytes, 2.0 * 64 * 32 * 64 * dy[0, 0].numel(),
                                                    torch.bfloat16)
    log(f"7d entry conv dW (64 -> 32, k 4, stride 2, (256, 128, 128)) bf16: conv3d_weight "
        f"{entry['library_ms']:.4f} ms, folded (float32 products) {entry['folded_ms']:.4f} ms, "
        f"bound {entry['bound_ms']:.4f} ({entry['bound_by']}); folded against the float32 "
        f"conv3d_weight: max abs err {err:.3e} (tol {lim:.3e}, 1e-4 of max |dW| + 1e-4)")
    if not err <= lim:
        fail("7d: the folded weight gradient disagrees with conv3d_weight")
    del x, dy, ref, folded
    wgrad["phase_shapes"] = rows
    wgrad["max_abs_err"] = max([wgrad["max_abs_err"]] + [r["max_abs_err"] for r in rows])
    wgrad["phase_ms_per_iteration"] = per_iter
    wgrad["phase_launches"] = counts["wgrad3d"]
    return {"ms_per_iteration": per_iter, "entry_conv_wgrad": entry}


def check_formulations(dev, small_losses: np.ndarray) -> dict:
    """7e: phase 3's small solve with ``vmap_conv_mode="tapmm"`` (kernels
    on), and with the packed and folded weight gradients (the wgrad kernel
    off), each against phase 3's card losses: iteration 0 to rel 1e-5 (the
    same forward, summed in another order or not at all), 1-2 to rel 1e-4
    (phase 3's tolerance through Adam's first steps)."""
    from deep_prior_interpolation_tpu_torch import Config, DIPSolver
    from deep_prior_interpolation_tpu_torch.ops import conv_vjp

    cfg, img, mask, noise, init, _ = small_problem()
    out = {}
    runs = (("tapmm", dict(vmap_conv_mode="tapmm"), {}, True, "_tap_conv"),
            ("packed_folded", {}, {"DPI_PACKED_WGRAD": "1", "DPI_FOLD_WGRAD": "1"}, False,
             "_folded_wgrad"))
    for label, kw, env, kernels, spied in runs:
        calls, real = [0], getattr(conv_vjp, spied)

        def spy(*a, _real=real):
            calls[0] += 1
            return _real(*a)
        setattr(conv_vjp, spied, spy)
        set_kernels(kernels)
        os.environ.update(env)
        reset_counts()
        try:
            r = DIPSolver(Config(**{**cfg.to_dict(), **kw}), device=dev).solve(
                img, mask, seed=0, init_params=init, noise=noise)
        finally:
            setattr(conv_vjp, spied, real)
            for key in env:
                del os.environ[key]
            set_kernels(True)
        a = np.asarray(r.history.loss)
        rel = np.abs(a[:3] - small_losses[:3]) / np.abs(small_losses[:3])
        log(f"7e {label}: losses {a.tolist()}; rel err to phase 3's iteration 0 {rel[0]:.3e} "
            f"(tol 1e-5), 1-2 {rel[1:].max():.3e} (tol 1e-4); {spied} ran {calls[0]} times, "
            f"launches {read_counts()}")
        if not (rel[0] <= 1e-5 and rel[1:].max() <= 1e-4 and calls[0] > 0):
            fail(f"7e: the {label} solve disagrees with phase 3's or did not run its form")
        out[label] = {"losses": a.tolist(), "rel_err_it0": float(rel[0]),
                      "rel_err_it12": float(rel[1:].max()), "calls": calls[0]}
    return out


# ----------------------------------------------------------------------
# phase 8: patch batches on one card (parallel/mesh.py)
# ----------------------------------------------------------------------

# 8a: the flagship volume cut into 8 patches of (128, 64, 64), one lane each
BATCH_PATCH = (128, 64, 64)
BATCH_LANES = 8
_H = [tuple(s // 2 for s in sp) for sp in _L]   # the levels of a (128, 64, 64) patch
# the lane launch's shapes: the flagship net's 24 wgrad shapes at the patch's
# levels, each as often an iteration as on the main path
BATCH_WGRAD_SHAPES = [(ci, co, _H[_L.index(sp)], n) for ci, co, sp, n in WGRAD_SHAPES]
BATCH_UPSAMPLE_SHAPES = [(BATCH_LANES * c, _H[_L.index(sp)]) for c, sp in UPSAMPLE_SHAPES]
# 8b: BENCH_2D.json's configuration (scripts/bench_2d.py) on the lines data
LINES_2D = dict(datadim="2d", loss="mae", lr=1e-3, inputdepth=64,
                filters=[16, 32, 64, 128, 256], skip=[16, 32, 64, 128], upsample="nearest",
                gain=1.0, reg_noise_std=0.03, dtype="bfloat16", fused_loss=True,
                epochs=50, scan_chunk=25)
V100_S_PER_1000 = 47.0   # the reference's V100 figure for the lines patch (README.md)


def reset_lane_counts() -> None:
    from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG
    reset_counts()
    FL.fused_sums_lanes.launches = 0
    FL.loss_sums_grad_lanes.launches = 0
    WG.wgrad3d_lanes.launches = 0


def read_lane_counts() -> dict:
    """The lane wrappers' launches, the upsample's, and the one-lane
    wrappers' (which a batch must not launch)."""
    from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG
    one = read_counts()
    return {"fused_loss_lanes": FL.fused_sums_lanes.launches,
            "fused_loss_grad_lanes": FL.loss_sums_grad_lanes.launches,
            "wgrad3d_lanes": WG.wgrad3d_lanes.launches, "upsample_bwd": one["upsample_bwd"],
            "one_lane": one["fused_loss"] + one["fused_loss_grad"] + one["wgrad3d"]}


class batches:
    """Records every ``solve_patches_batched`` result and the lane kernels'
    shapes (at their callers: a wrapper counts its launches on its own
    name) while the block runs."""

    def __enter__(self):
        from deep_prior_interpolation_tpu_torch import parallel
        from deep_prior_interpolation_tpu_torch.ops import conv_vjp
        from deep_prior_interpolation_tpu_torch.ops import upsample as U
        self.results, self.wgrad, self.up = [], collections.Counter(), collections.Counter()
        self.real = (parallel.solve_patches_batched, conv_vjp.wgrad3d_lanes,
                     U._LinearUpsample2x.backward)
        real_solve, real_wg, real_up = self.real

        def solve(*a, **k):
            res = real_solve(*a, **k)
            self.results.append(res)
            return res

        def wg(x, dy, k):
            self.wgrad[(x.shape[1], dy.shape[1], tuple(x.shape[2:]))] += 1
            return real_wg(x, dy, k)

        def up(ctx, g):
            self.up[(g.shape[0] * g.shape[1], tuple(s // 2 for s in g.shape[2:]))] += 1
            return real_up(ctx, g)
        parallel.solve_patches_batched, conv_vjp.wgrad3d_lanes = solve, wg
        U._LinearUpsample2x.backward = staticmethod(up)
        return self

    def __exit__(self, *exc):
        from deep_prior_interpolation_tpu_torch import parallel
        from deep_prior_interpolation_tpu_torch.ops import conv_vjp
        from deep_prior_interpolation_tpu_torch.ops import upsample as U
        parallel.solve_patches_batched, conv_vjp.wgrad3d_lanes = self.real[:2]
        U._LinearUpsample2x.backward = staticmethod(self.real[2])


def batch_survey(dev, tmp: str, main: dict) -> dict:
    """8a: the flagship volume as 8 patches of (128, 64, 64) through
    ``cli.run --batch_patches 8`` (one batch of 8 lanes), then the same
    patches one after another (``--batch_patches 0``): launch counts and
    shapes, bundles, each lane's iteration-0 loss against its solo solve,
    s/iteration and peak memory beside phase 4's."""
    from deep_prior_interpolation_tpu_torch import cli
    from deep_prior_interpolation_tpu_torch.config import parse_arguments
    from deep_prior_interpolation_tpu_torch.data import hyperbolic_events, random_trace_mask
    from deep_prior_interpolation_tpu_torch.io import load_run

    root = os.path.join(tmp, "batch")
    os.makedirs(root, exist_ok=True)
    vol = hyperbolic_events(256, 128, 128)
    kept = random_trace_mask(vol.shape, 0.66, 1) > 0
    np.save(os.path.join(root, "original.npy"), vol)
    np.save(os.path.join(root, "corrupted.npy"), np.where(kept, vol, np.nan).astype(np.float32))

    def flags(outdir, batch):
        return parse_arguments(flagship_flags() + [
            "--imgdir", root, "--imgname", "original.npy", "--maskname", "corrupted.npy",
            "--outdir", outdir, "--datadim", "3d", "--patch_shape", *map(str, BATCH_PATCH),
            "--gain", "40", "--epochs", "6", "--scan_chunk", "3",
            "--batch_patches", str(batch)])

    set_kernels(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_lane_counts()
    with batches() as rec:
        out = cli.run(flags("batched", BATCH_LANES), results_root=root)
    counts = read_lane_counts()
    kinds = read_upsample_kernels()
    norm_counts = read_norm_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"fused_loss_lanes": 6, "fused_loss_grad_lanes": 6, "wgrad3d_lanes": 6 * 32,
            "upsample_bwd": 6 * 4, "one_lane": 0}
    want_norm = {"norm_act_forward": 0, "norm_act_backward": 0,
                 "norm_act_forward_lanes": 6 * 70 * 2, "norm_act_backward_lanes": 6 * 70 * 2}
    log(f"8a batch: launches {counts} (expected {want}); upsample_bwd by kernel {kinds}; "
        f"Norm launches {norm_counts} (expected {want_norm}: vmap's lane pair)")
    if counts != want:
        fail(f"8a: the batch's launch counts are {counts}")
    if norm_counts != want_norm:
        fail(f"8a: the batch's Norm launch counts are {norm_counts}")
    if kinds != {"tma": 6 * 4, "direct": 0}:
        fail(f"8a: the batch's upsample launches by kernel are {kinds}")
    want_wg = {(ci, co, sp): 6 * n for ci, co, sp, n in BATCH_WGRAD_SHAPES}
    if dict(rec.wgrad) != want_wg:
        fail(f"8a: the batch's lane wgrad shapes are {dict(rec.wgrad)}, not {want_wg}")
    want_up = {(c, sp): 6 for c, sp in BATCH_UPSAMPLE_SHAPES}
    if dict(rec.up) != want_up:
        fail(f"8a: the batch's upsample shapes are {dict(rec.up)}, not {want_up}")
    if len(rec.results) != 1 or len(rec.results[0]) != BATCH_LANES:
        fail(f"8a: {len(rec.results)} batches, not one of {BATCH_LANES} patches")
    names = [str(i) for i in range(BATCH_LANES)]
    keys = [k for k in BUNDLE_KEYS if k != "pocs"]   # a run without --pocs has none
    for name in names:
        with np.load(os.path.join(out, f"{name}_run.npz"), allow_pickle=True) as z:
            if list(z.files) != keys:
                fail(f"8a: bundle {name} has keys {z.files}, not {keys}")
    batched = [load_run(os.path.join(out, f"{n}_run.npz")) for n in names]
    chunks = rec.results[0][0].chunk_seconds
    steady = statistics.median(chunks[1:]) / 3

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_lane_counts()
    with solves() as seq_rec:
        seq_out = cli.run(flags("sequential", 0), results_root=root)
    seq_counts = read_counts()
    seq_norms = read_norm_counts()
    seq_peak = torch.cuda.max_memory_allocated()
    seq = [load_run(os.path.join(seq_out, f"{n}_run.npz")) for n in names]
    seq_steady = [r.chunk_seconds[1] / 3 for r in seq_rec.results]
    log(f"8a sequential: launches {seq_counts} (expected 48, 48, {8 * 6 * 32}, {8 * 6 * 4})")
    if seq_counts != {"fused_loss": 48, "fused_loss_grad": 48, "wgrad3d": 8 * 6 * 32,
                      "upsample_bwd": 8 * 6 * 4}:
        fail(f"8a: the sequential run's launch counts are {seq_counts}")
    want_norm = {"norm_act_forward": 8 * 6 * 70 * 2, "norm_act_backward": 8 * 6 * 70 * 2,
                 "norm_act_forward_lanes": 0, "norm_act_backward_lanes": 0}
    log(f"8a sequential: Norm launches {seq_norms} (expected {want_norm})")
    if seq_norms != want_norm:
        fail(f"8a: the sequential run's Norm launch counts are {seq_norms}")
    rels = []
    for name, b, s in zip(names, batched, seq):
        lb, ls = np.asarray(b["history"]["loss"]), np.asarray(s["history"]["loss"])
        if not (len(lb) == 6 and np.all(np.isfinite(lb)) and np.all(np.isfinite(b["output"]))):
            fail(f"8a: lane {name}'s history or output is not finite: {lb}")
        rels.append(float(abs(lb[0] - ls[0]) / abs(ls[0])))
        log(f"8a lane {name}: batch loss {lb.tolist()}\n            solo  loss {ls.tolist()}")
    log(f"8a: iteration-0 loss rel err of each lane to its solo solve {rels} (tol 1e-3: "
        f"bf16, grouped against plain cuDNN convs)")
    if not max(rels) <= 1e-3:
        fail("8a: a lane's iteration-0 loss differs from its solo solve")
    log(f"8a: batch chunk seconds {chunks}, steady {steady:.4f} s/iteration for the "
        f"{BATCH_LANES} lanes = {steady / BATCH_LANES:.4f} s/iteration a patch; sequential "
        f"{statistics.median(seq_steady):.4f} s/iteration a patch (median of {seq_steady}); "
        f"phase 4 (one (256, 128, 128) patch, the same voxels) {main['s_per_iter']:.4f}")
    log(f"8a: peak memory batch {peak / 2**30:.2f} GiB, sequential {seq_peak / 2**30:.2f} GiB, "
        f"phase 4 {main['peak_bytes'] / 2**30:.2f} GiB")
    outputs = np.stack([b["output"][..., 0] for b in batched])
    return {"launches": counts, "upsample_kernels": kinds, "norm_launches": norm_counts,
            "s_per_iter": steady,
            "s_per_iter_per_patch": steady / BATCH_LANES,
            "sequential_s_per_iter_per_patch": statistics.median(seq_steady),
            "peak_memory_bytes": peak, "sequential_peak_memory_bytes": seq_peak,
            "rel_err_it0": rels, "wgrad_shapes": sorted(rec.wgrad), "outputs": outputs}


def lines_batches(dev) -> dict:
    """8b: BENCH_2D.json's configuration on the lines gather, B patches with
    B decimation masks (seeds 0..B-1) through ``solve_patches_batched``, 2
    chunks of 25 iterations each: B = 1, 32 (tapmm and grouped), 64
    (tapmm), after lane 0's patch through the one-lane solver; steady
    s/1000 iterations a patch beside the reference's V100."""
    from deep_prior_interpolation_tpu_torch import Config, DIPSolver
    from deep_prior_interpolation_tpu_torch.data import lines_dataset
    from deep_prior_interpolation_tpu_torch.parallel import solve_patches_batched

    img, _ = lines_dataset()
    nt, nx = img.shape[:2]
    mask0 = np.repeat((np.random.RandomState(0).rand(1, nx) > 0.66).astype(np.float32),
                      nt, 0)[..., None]
    # the lane-0 patch through the one-lane solver, no vmap: what a lane of
    # the batch pays against the solo step
    cfg = Config(**LINES_2D)
    reset_lane_counts()
    solo = DIPSolver(cfg, device=dev).solve(img, mask0, seed=0)
    counts = read_counts()
    per = statistics.median(solo.chunk_seconds[1:]) / cfg.scan_chunk * 1000.0
    log(f"8b solo (DIPSolver.solve): chunk seconds {solo.chunk_seconds}, {per:.3f} s / 1000 "
        f"iterations ({V100_S_PER_1000 / per:.2f}x the reference's V100), launches {counts}")
    iters = LINES_2D["epochs"]
    if counts["fused_loss"] != iters or counts["fused_loss_grad"] != iters:
        fail(f"8b solo: launches {counts}, not {iters} / {iters}")
    runs = {"solo": {"s_per_1000_per_patch": per, "chunk_seconds": solo.chunk_seconds}}
    for b, mode in ((1, "grouped"), (32, "tapmm"), (32, "grouped"), (64, "tapmm")):
        masks = [np.repeat((np.random.RandomState(i).rand(1, nx) > 0.66).astype(np.float32),
                           nt, 0)[..., None] for i in range(b)]
        patches = [{"image": img, "mask": m, "name": str(i)} for i, m in enumerate(masks)]
        cfg = Config(**LINES_2D, vmap_conv_mode=mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_lane_counts()
        res = solve_patches_batched(cfg, DIPSolver(cfg, device=dev), patches)
        counts = read_lane_counts()
        peak = torch.cuda.max_memory_allocated()
        chunks = res[0].chunk_seconds
        per = statistics.median(chunks[1:]) / cfg.scan_chunk / b * 1000.0
        loss = np.asarray([r.history.loss for r in res])
        label = f"b{b}_{mode}"
        log(f"8b {label}: chunk seconds {chunks}, {per:.3f} s / 1000 iterations a patch "
            f"({V100_S_PER_1000 / per:.2f}x the reference's V100 {V100_S_PER_1000} s), peak "
            f"{peak / 2**30:.2f} GiB, launches {counts}, lane 0 loss {loss[0, ::25].tolist()}")
        if counts["fused_loss_lanes"] != iters or counts["fused_loss_grad_lanes"] != iters \
                or counts["one_lane"] != 0:
            fail(f"8b {label}: launches {counts}, not {iters} / {iters} lane launches")
        if loss.shape != (b, iters) or not np.all(np.isfinite(loss)):
            fail(f"8b {label}: the losses are not {b} x {iters} finite values")
        runs[label] = {"s_per_1000_per_patch": per, "chunk_seconds": chunks,
                       "peak_memory_bytes": peak, "launches": counts}
    return runs


def _lane_loss_rows(dev, b: int, sp, dtype) -> dict:
    """8c: the lane fused loss at (b, *sp) against b one-lane launches (bit
    for bit) and its plain version; forward and backward timed by
    CUDA-graph replay beside their bounds."""
    from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL

    g = torch.Generator(device=dev).manual_seed(11)
    shape = (b, 1, 1) + tuple(sp)
    img = torch.randn(shape, generator=g, device=dev)
    out = (img + torch.randn(shape, generator=g, device=dev)).to(dtype)
    mask = (torch.rand(shape, generator=g, device=dev) > 0.66).float()
    gin = torch.randn((b, 8), generator=g, device=dev)
    sums = FL.fused_sums_lanes(out, img, mask)
    grad = FL.loss_sums_grad_lanes(out, img, mask, gin)
    one_s = torch.stack([FL.fused_sums(out[i].clone(), img[i].clone(), mask[i].clone())
                         for i in range(b)])
    one_g = torch.stack([FL.loss_sums_grad(out[i].clone(), img[i].clone(), mask[i].clone(),
                                           gin[i].clone()) for i in range(b)])
    ref = FL.fused_sums_lanes_plain(out, img, mask)
    rel = float(((sums - ref).abs() / ref.abs().clamp_min(1e-30)).max())
    abs_err = float((sums - ref).abs().max())
    gref = FL.loss_sums_grad_lanes_plain(out, img, mask, gin).float()
    gerr = float((grad.float() - gref).abs().max())
    same = torch.equal(sums, one_s) and torch.equal(grad, one_g)
    name = str(dtype).split(".")[-1]
    n = math.prod(sp) * b
    (fb, fby), (bb, bby) = _loss_bounds(n, dtype)
    copies = [(out.clone(), img.clone(), mask.clone()) for _ in range(2)]
    grads = [c + (gin,) for c in copies]
    row = {"lanes": b, "spatial": list(sp), "out_dtype": name, "bit_equal_to_one_lane": same,
           "max_rel_err": rel, "max_abs_err": abs_err, "grad_max_abs_err": gerr,
           "fwd": {"ms": graph_ms(cycling(FL.fused_sums_lanes, copies)),
                   "plain_ms": graph_ms(cycling(FL.fused_sums_lanes_plain, copies)),
                   "bound_ms": fb, "bound_by": fby},
           "bwd": {"ms": graph_ms(cycling(FL.loss_sums_grad_lanes, grads)),
                   "plain_ms": graph_ms(cycling(FL.loss_sums_grad_lanes_plain, grads)),
                   "bound_ms": bb, "bound_by": bby}}
    log(f"8c fused loss lanes {b} x {tuple(sp)} {name}: each lane bit-equal to a one-lane "
        f"launch {same}; sums max rel err to plain {rel:.3e} (tol 1e-4), grad max abs err "
        f"{gerr:.3e}; forward {row['fwd']['ms']:.4f} ms (plain {row['fwd']['plain_ms']:.4f}, "
        f"bound {fb:.4f} {fby}), backward {row['bwd']['ms']:.4f} ms (plain "
        f"{row['bwd']['plain_ms']:.4f}, bound {bb:.4f} {bby})")
    if not (same and rel <= 1e-4):
        fail(f"8c: the lane fused loss at {b} x {tuple(sp)} {name} is not each lane's "
             f"one-lane result or disagrees with the plain version")
    if not gerr <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) * float(gref.abs().max()):
        fail(f"8c: the lane fused loss gradient at {b} x {tuple(sp)} {name} disagrees")
    return row


def lane_wgrad_row(dev, ci: int, co: int, sp, n: int, g) -> dict:
    """8c: the lane wgrad launch (8 lanes, bf16) against its plain version
    (1e-4 of max |dW| + 1e-4), timed beside its bound, the plain version
    and the one library call, ``conv3d_weight`` with ``groups=8``."""
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

    b = BATCH_LANES
    x = torch.randn((b, ci) + tuple(sp), generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn((b, co) + tuple(sp), generator=g, device=dev).to(torch.bfloat16)
    got = WG.wgrad3d_lanes(x, dy, 3)
    torch.cuda.synchronize()
    ref = WG.wgrad3d_lanes_plain(x, dy, 3)
    err = float((got - ref).abs().max())
    lim = 1e-4 * float(ref.abs().max()) + 1e-4
    del got, ref
    row = {"lanes": b, "ci": ci, "co": co, "spatial": list(sp), "dtype": "bfloat16",
           "launches_per_iteration": n, "max_abs_err": err, "tol": lim,
           "ms": time_ms(lambda: WG.wgrad3d_lanes(x, dy, 3)),
           "plain_ms": time_ms(lambda: WG.wgrad3d_lanes_plain(x, dy, 3))}
    xg, dyg = x.reshape((1, b * ci) + tuple(sp)), dy.reshape((1, b * co) + tuple(sp))
    row["library_ms"] = time_ms(lambda: torch.nn.grad.conv3d_weight(
        xg, (b * co, ci, 3, 3, 3), dyg, stride=1, padding=1, groups=b))
    n_bytes = b * ((ci + co) * math.prod(sp) * 2 + co * ci * 27 * 4)
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, b * 2.0 * ci * co *
                                                _valid_products(sp, 3), torch.bfloat16)
    log(f"8c wgrad lanes {b} x {ci}->{co} {tuple(sp)}: max abs err {err:.3e} (tol {lim:.3e}); "
        f"ms {row['ms']:.4f} plain {row['plain_ms']:.4f} conv3d_weight(groups={b}) "
        f"{row['library_ms']:.4f} bound {row['bound_ms']:.4f} ({row['bound_by']}), "
        f"{n} launches/iteration")
    if not err <= lim:
        fail(f"8c: the lane wgrad at {ci}->{co} {tuple(sp)} disagrees with the plain version")
    return row


# 8c's lane Norms: the widest Norm of each of the patch's levels
LANE_NORMS = [(25, _H[0]), (51, _H[1]), (105, _H[2]), (212, _H[3]), (426, _H[4])]


def lane_norm_row(dev, c: int, sp) -> dict:
    """8c: the Norm's lane pair at (8 lanes, 1, C, *sp) in bf16, each lane
    with its own scale and bias, LeakyReLU fused: two launches a direction,
    each lane bit-equal to a one-lane call on its input; timed beside the
    8 one-lane calls it stands for."""
    from deep_prior_interpolation_tpu_torch.ops import norm_act as NA
    b = BATCH_LANES
    g = torch.Generator(device=dev).manual_seed(c)
    x = (torch.randn((b, 1, c) + sp, generator=g, device=dev) + 0.5).to(torch.bfloat16)
    dz = torch.randn((b, 1, c) + sp, generator=g, device=dev).to(torch.bfloat16)
    scale = torch.rand((b, c), generator=g, device=dev) + 0.5
    bias = torch.randn((b, c), generator=g, device=dev)
    before = read_norm_counts()
    z, stats = NA.norm_act_forward_lanes(x, scale, bias, leaky=True)
    grads = NA.norm_act_backward_lanes(x, dz, stats, True)
    launched = {k: v - before[k] for k, v in read_norm_counts().items()}
    same = launched == {"norm_act_forward": 0, "norm_act_backward": 0,
                        "norm_act_forward_lanes": 2, "norm_act_backward_lanes": 2}
    for i in range(b):
        zi, si = NA.norm_act_forward(x[i], scale[i], bias[i], leaky=True)
        gi = NA.norm_act_backward(x[i], dz[i], si, True)
        same = same and torch.equal(z[i], zi) and torch.equal(stats[i], si) and all(
            torch.equal(u[i], v) for u, v in zip(grads, gi))

    def one_lane():
        for i in range(b):
            NA.norm_act_backward(x[i], dz[i], NA.norm_act_forward(
                x[i], scale[i], bias[i], leaky=True)[1], True)
    row = {"lanes": b, "channels": c, "spatial": list(sp), "bit_equal_to_lanes": same,
           "launches": launched,
           "fwd_ms": graph_ms(lambda: NA.norm_act_forward_lanes(x, scale, bias, leaky=True), 20),
           "bwd_ms": graph_ms(lambda: NA.norm_act_backward_lanes(x, dz, stats, True), 20),
           "one_lane_ms": graph_ms(one_lane, 5)}
    log(f"8c norm_act lanes {b} x {c} x {sp} bf16: launches {launched}, each lane bit-equal to "
        f"a one-lane call {same}; fwd {row['fwd_ms']:.4f} bwd {row['bwd_ms']:.4f} ms, "
        f"{b} one-lane calls {row['one_lane_ms']:.4f} ms")
    if not same:
        fail(f"8c: the lane Norm at {b} x {c} x {sp} is not each lane's one-lane call")
    return row


def lane_kernels(dev, survey: dict) -> dict:
    """8c: the lane-batched kernels against their plain versions, timed."""
    from torch.func import vmap

    from deep_prior_interpolation_tpu_torch.ops import upsample as U

    fused = [_lane_loss_rows(dev, b, sp, dt)
             for b, sp in ((32, (170, 100)), (BATCH_LANES, BATCH_PATCH))
             for dt in (torch.bfloat16, torch.float32)]
    seen = set(survey["wgrad_shapes"])
    g = torch.Generator(device=dev).manual_seed(12)
    rows = [lane_wgrad_row(dev, ci, co, sp, n, g) for ci, co, sp, n in BATCH_WGRAD_SHAPES
            if (ci, co, sp) in seen]
    if len(rows) != len(seen):
        fail(f"8c: 8a saw wgrad shapes {sorted(seen)} beyond the listed ones")
    per_iter = sum(r["ms"] * r["launches_per_iteration"] for r in rows)
    lib_iter = sum(r["library_ms"] * r["launches_per_iteration"] for r in rows)
    log(f"8c wgrad lanes ms/iteration of 8a: sum of launches x ms over {len(rows)} shapes "
        f"({sum(r['launches_per_iteration'] for r in rows)} launches) = {per_iter:.4f} "
        f"(conv3d_weight groups={BATCH_LANES}: {lib_iter:.4f})")

    up_rows = []
    for c, sp in BATCH_UPSAMPLE_SHAPES:
        x = torch.randn((BATCH_LANES, 1, c // BATCH_LANES) + sp, device=dev,
                        dtype=torch.bfloat16, requires_grad=True)
        y = vmap(U.linear_upsample2x)(x)
        gy = torch.randn(y.shape, device=dev, dtype=torch.bfloat16)
        before = U.upsample_bwd.launches
        (dx,) = torch.autograd.grad(y, x, gy)
        launched = U.upsample_bwd.launches - before
        per_lane = torch.stack([U.upsample_bwd(gy[i], 3) for i in range(BATCH_LANES)])
        same = torch.equal(dx, per_lane) and launched == 1
        folded = gy.reshape((-1,) + tuple(gy.shape[2:]))
        plain = torch.equal(dx.reshape(folded.shape[:2] + dx.shape[3:]),
                            U.upsample_bwd_plain(folded, 3))
        kernel = U.plan(c, *sp, True, 2, folded.data_ptr() % 16 == 0).kernel
        ms = time_ms(lambda: U.upsample_bwd(folded, 3))
        plain_ms = time_ms(lambda: U.upsample_bwd_plain(folded, 3))
        lib = time_ms(lambda: torch.ops.aten.upsample_trilinear3d_backward(
            folded, list(folded.shape[2:]), [*folded.shape[:2], *sp], False, 2.0, 2.0, 2.0))
        b_ms, b_by = bound_ms(9 * folded.numel() // 8 * 2, 8.0 * folded.numel(), torch.float32)
        log(f"8c upsample_bwd lane-folded {c} planes x {sp} bf16 ({kernel} kernel): one launch, "
            f"bit-equal to per-lane calls {same} and to the plain version {plain}; ms {ms:.4f} "
            f"plain {plain_ms:.4f} atomic F.interpolate backward {lib:.4f} bound {b_ms:.4f} "
            f"({b_by}), {b_ms / ms:.0%} of the bound's speed")
        if not (same and plain):
            fail(f"8c: the lane-folded upsample backward at {c} x {sp} is not the per-lane one "
                 f"or not the plain one")
        if kernel != "tma":
            fail(f"8c: the lane-folded upsample backward at {c} x {sp} takes the {kernel} kernel")
        up_rows.append({"planes": c, "spatial": list(sp), "kernel": kernel, "ms": ms,
                        "plain_ms": plain_ms, "library_ms": lib, "bound_ms": b_ms,
                        "bound_by": b_by, "launches_per_iteration": 1, "bit_equal_to_lanes": same,
                        "bit_equal_to_plain": plain})
    norm_rows = [lane_norm_row(dev, c, sp) for c, sp in LANE_NORMS]
    return {"fused": fused, "wgrad": rows, "wgrad_ms_per_iteration": per_iter,
            "wgrad_library_ms_per_iteration": lib_iter, "upsample": up_rows,
            "norm": norm_rows}


def batch_assembly(dev, survey: dict) -> dict:
    """8d: ``overlap_add_sharded`` on the card at 8a's tiling (and the
    repaired ``overlap_add`` at an overlapping one): two calls bit-equal,
    within 1e-6 of a float64 numpy overlap-add."""
    from deep_prior_interpolation_tpu_torch.data import overlap_add
    from deep_prior_interpolation_tpu_torch.data.patcher import flat_index_map
    from deep_prior_interpolation_tpu_torch.parallel import make_mesh, overlap_add_sharded

    image = (256, 128, 128)
    out = {}
    for label, patches, stride in (
            ("8a tiling (exact)", survey["outputs"], BATCH_PATCH),
            ("overlapping (stride 64, 32, 32)", None, (64, 32, 32))):
        idx = flat_index_map(image, BATCH_PATCH, stride)
        if patches is None:
            patches = np.random.RandomState(13).randn(idx.shape[0], *BATCH_PATCH)
        patches = np.asarray(patches, np.float32)
        flat = np.zeros(math.prod(image))
        counts = np.zeros_like(flat)
        np.add.at(flat, idx.ravel(), patches.astype(np.float64).reshape(-1))
        np.add.at(counts, idx.ravel(), 1.0)
        want = (flat / np.maximum(counts, 1.0)).reshape(image)
        t = torch.from_numpy(patches).to(dev)
        mesh = make_mesh(1)
        a = overlap_add_sharded(t, image, BATCH_PATCH, stride, mesh)
        b = overlap_add_sharded(t, image, BATCH_PATCH, stride, mesh)
        c, d = overlap_add(t, image, BATCH_PATCH, stride), overlap_add(t, image, BATCH_PATCH, stride)
        err = float(np.max(np.abs(a.cpu().numpy() - want)) / max(np.max(np.abs(want)), 1e-30))
        err_c = float(np.max(np.abs(c.cpu().numpy() - want)) / max(np.max(np.abs(want)), 1e-30))
        same = torch.equal(a, b) and torch.equal(c, d)
        log(f"8d {label}, {idx.shape[0]} patches: overlap_add_sharded and overlap_add on the "
            f"card, two calls bit-equal {same}; max err to float64 numpy (of max |v|) "
            f"{err:.3e} and {err_c:.3e} (tol 1e-6)")
        if not (same and err <= 1e-6 and err_c <= 1e-6):
            fail(f"8d: the card's overlap-add at the {label} is not repeatable or disagrees")
        out[label] = {"patches": int(idx.shape[0]), "bit_equal": same, "rel_err": err,
                      "overlap_add_rel_err": err_c}
    return out


def lane_entries(survey: dict, kernels: dict) -> list:
    """The lane-batched kernels' entries of the kernels line: the 8a
    launches, headline figures at 8a's shapes."""
    fused = next(r for r in kernels["fused"] if r["lanes"] == BATCH_LANES
                 and r["out_dtype"] == "bfloat16")
    common = {"route": "cuda", "source": "deep_prior_interpolation_tpu_torch/csrc/fused_loss.cu",
              "shape": [BATCH_LANES, 1, 1] + list(BATCH_PATCH), "library_ms": None}
    fwd = {"name": "fused_loss_lanes", **common,
           "replaces": "deep_prior_interpolation_tpu/ops/pallas_kernels.py:85",
           "launches": survey["launches"]["fused_loss_lanes"],
           "max_abs_err": max(r["max_abs_err"] for r in kernels["fused"]),
           "tolerance": "each lane bit-equal to a one-lane launch; sums rel 1e-4 of plain",
           "variants": kernels["fused"], **{k: fused["fwd"][k] for k in
                                            ("ms", "plain_ms", "bound_ms", "bound_by")}}
    bwd = {"name": "fused_loss_grad_lanes", **common,
           "replaces": "deep_prior_interpolation_tpu/ops/pallas_kernels.py:128",
           "launches": survey["launches"]["fused_loss_grad_lanes"],
           "max_abs_err": max(r["grad_max_abs_err"] for r in kernels["fused"]),
           "tolerance": "each lane bit-equal to a one-lane launch; bf16 2^-7, float32 1e-5 "
                        "of max |plain|",
           **{k: fused["bwd"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}
    head = max(kernels["wgrad"], key=lambda r: r["ms"] * r["launches_per_iteration"])
    wg = {"name": "wgrad3d_lanes", "route": "cuda",
          "source": "deep_prior_interpolation_tpu_torch/csrc/wgrad3d.cu",
          "replaces": "deep_prior_interpolation_tpu/ops/pallas_wgrad.py:182",
          "launches": survey["launches"]["wgrad3d_lanes"],
          "max_abs_err": max(r["max_abs_err"] for r in kernels["wgrad"]),
          "tolerance": "1e-4 of max |dW| + 1e-4 per shape",
          "shape": [BATCH_LANES, head["ci"], head["co"]] + head["spatial"],
          "ms_per_iteration": kernels["wgrad_ms_per_iteration"],
          "library_ms_per_iteration": kernels["wgrad_library_ms_per_iteration"],
          "shapes": kernels["wgrad"], **{k: head[k] for k in
                                         ("ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by")}}
    norm = {"name": "norm_act_lanes", "route": "cuda",
            "source": "deep_prior_interpolation_tpu_torch/csrc/norm_act.cu", "replaces": None,
            "launches": {k: survey["norm_launches"][k] for k in
                         ("norm_act_forward_lanes", "norm_act_backward_lanes")},
            "tolerance": "each lane bit-equal to a one-lane launch", "shapes": kernels["norm"]}
    return [fwd, bwd, wg, norm]


def norm_entries(main: dict, checked: dict) -> list:
    """The Norm pair's entries of the kernels line: phase 4's launches, the
    figures of phase 2 summed over an iteration's 70 Norms (bf16, the
    flagship's dtype; float32 beside)."""
    out = []
    for d in ("fwd", "bwd"):
        name = "norm_act_forward" if d == "fwd" else "norm_act_backward"
        entry = {"name": name, "route": "cuda",
                 "source": "deep_prior_interpolation_tpu_torch/csrc/norm_act.cu",
                 "replaces": None, "launches": main["norm_counts"][name],
                 "shape": [1, 25, *_L[0]],
                 "max_abs_err": max(v["max_abs_err"] for v in checked.values()),
                 "tolerance": "z one ulp + 1e-5 of max |z|; statistics, dscale, dbias rel "
                              "1e-4; dx one ulp + 1e-4 of max |dx| (float32 plain version)"}
        for dt, v in checked.items():
            t = v["totals"]
            entry[dt] = {"ms_per_iteration": t[f"{d}_ms"],
                         "bound_ms_per_iteration": t[f"{d}_bound_ms"],
                         "least_ms_per_iteration": t[f"{d}_least_ms"],
                         "plain_ms_per_iteration": t[f"plain_{d}_ms"],
                         "library_ms_per_iteration": t[f"library_{d}_ms"]}
        out.append(entry)
    return out


# ----------------------------------------------------------------------
# phase 10: spatial shards (parallel/spatial.py)
# ----------------------------------------------------------------------

# the flagship's volume split along H (spatial axis 1: 128 planes in 16
# blocks of 2^4) over N shards of one card
SPATIAL_AXIS = 1
SPATIAL_SHARDS = (2, 4)
# what was predicted before the first card run of phase 10 (PERF.md)
PREDICTED_10A = ("N = 2: 0.25-0.35 s/iteration, N = 4: 0.45-0.65 (host-bound: about N "
                 "times phase 4's launches, plus a halo exchange a conv); peak 16-20 GiB "
                 "at N = 2, 17-22 at N = 4 (halo-extended copies kept for the backward)")


def spatial_counts(n: int, iters: int, phase: bool = False) -> dict:
    """The launches of ``iters`` flagship iterations over ``n`` shards (of
    the phase flagship, ``PHASE7``, with ``phase``): each kernel once a
    shard where the unsharded step launches it once."""
    wgrad, ups = (30, 2) if phase else (32, 4)   # an iteration, unsharded (PHASE_COUNTS)
    return {"fused_loss": n * iters, "fused_loss_grad": n * iters,
            "wgrad3d": wgrad * n * iters, "upsample_bwd": ups * n * iters}


def _shard_planes(extent: int, n: int) -> list:
    """The planes of each of ``n`` shards of an axis at one level: shards of
    whole 16-plane blocks of the padded volume, as ``shard_bounds`` cuts."""
    from deep_prior_interpolation_tpu_torch.parallel.spatial import shard_bounds
    scale = 128 // extent
    return [(a // scale, b // scale) for a, b in shard_bounds(128, n, 16)]


def spatial_wgrad_shapes(n: int, phase: bool = False) -> collections.Counter:
    """The wgrad shapes of one flagship iteration over ``n`` shards along H
    and their launches: each of ``WGRAD_SHAPES`` (``PHASE_WGRAD_SHAPES``
    with ``phase``, a phase conv's on its phase grid) on each shard, x
    holding the shard's planes and a halo plane on each side."""
    want = collections.Counter()
    for ci, co, sp, k in PHASE_WGRAD_SHAPES if phase else WGRAD_SHAPES:
        for a, b in _shard_planes(sp[1], n):
            want[(ci, co, (sp[0], b - a + 2, sp[2]))] += k
    return want


def spatial_upsample_shapes(n: int, phase: bool = False) -> collections.Counter:
    """The upsample backward's input shapes of one flagship iteration over
    ``n`` shards (of the phase flagship's plain levels with ``phase``): each
    shard's planes with a halo plane on each side."""
    return collections.Counter((c, (sp[0], b - a + 2, sp[2]))
                               for c, sp in (PHASE_UPSAMPLE_SHAPES if phase else UPSAMPLE_SHAPES)
                               for a, b in _shard_planes(sp[1], n))


def sharded_flagship(mesh, cfg, img, mask, label: str) -> tuple:
    """The flagship (``cfg``; the phase flagship where it is in phase
    space) through ``DIPSolver.solve(spatial_mesh=mesh)`` along H, traced as
    phase 4; fails unless every loss and ``out_best`` is finite, the
    launches are ``spatial_counts``, the wgrad and upsample hooks see
    ``spatial_wgrad_shapes``/``spatial_upsample_shapes`` as often as
    ``cfg.epochs`` iterations give them, and every upsample backward runs
    on the TMA kernel. Returns the result and its summary: launches,
    losses, s/iteration (the median of chunks 2..), each device's peak."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.ops import upsample as U

    set_kernels(True)
    n, iters, phase = len(mesh), cfg.epochs, cfg.phase_space
    devices = sorted({d.index for d in mesh})
    solver = DIPSolver(cfg, outchannel=1, device=mesh[0])
    for d in devices:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    res, counts, seen, seen_up = traced_solve(solver, img, mask, spatial_mesh=mesh,
                                              spatial_axis=SPATIAL_AXIS)
    peaks = {f"cuda:{d}": torch.cuda.max_memory_allocated(d) for d in devices}
    kinds = read_upsample_kernels()
    loss = np.asarray(res.history.loss)
    want = spatial_counts(n, iters, phase)
    steady = statistics.median(res.chunk_seconds[1:]) / cfg.scan_chunk
    ups = {f"{c} x {sp}": U.plan(c, *sp, True, 2).kernel for c, sp in sorted(seen_up)}
    log(f"{label}: chunk seconds {res.chunk_seconds}; steady s/iteration {steady:.4f}; peak "
        f"memory { {k: round(v / 2**30, 2) for k, v in peaks.items()} } GiB")
    log(f"{label}: launches {counts} (expected {want}); upsample_bwd by kernel {kinds}; the "
        f"{len(seen_up)} upsample shapes' kernels {ups}; {len(seen)} distinct wgrad shapes "
        f"({sum(seen.values()) // iters} launches an iteration)")
    if not (len(loss) == iters and np.all(np.isfinite(loss))):
        fail(f"{label}: the sharded flagship's loss is not finite for {iters} iterations")
    if res.out_best.shape != img.shape or not np.all(np.isfinite(res.out_best)):
        fail(f"{label}: out_best has shape {res.out_best.shape} or is not finite")
    if counts != want:
        fail(f"{label}: the sharded path's launch counts are {counts}, not {want}")
    want_wg = {key: iters * k for key, k in spatial_wgrad_shapes(n, phase).items()}
    if dict(seen) != want_wg:
        fail(f"{label}: the sharded path's wgrad shapes are {dict(seen)}, not {want_wg}")
    want_up = {key: iters * k for key, k in spatial_upsample_shapes(n, phase).items()}
    if dict(seen_up) != want_up:
        fail(f"{label}: the sharded path's upsample shapes are {dict(seen_up)}, not {want_up}")
    if kinds != {"tma": want["upsample_bwd"], "direct": 0}:
        fail(f"{label}: the upsample backward ran {kinds}, not all on the TMA kernel")
    del solver
    return res, {"shards": n, "devices": [str(d) for d in mesh], "launches": counts,
                 "upsample_kernels": kinds, "upsample_shape_kernels": ups,
                 "losses": loss.tolist(), "s_per_iter": steady,
                 "chunk_seconds": res.chunk_seconds, "peak_bytes": peaks,
                 "wgrad_shapes": [[ci, co, list(sp), c // iters]
                                  for (ci, co, sp), c in sorted(seen.items())]}


def spatial_solve(dev, mesh, label: str, main: dict) -> dict:
    """The flagship through ``DIPSolver.solve(spatial_mesh=mesh)``, 9
    iterations in chunks of 3, traced as phase 4 (``sharded_flagship``); the
    first loss against phase 4's (same seed: same parameters, canvas and
    noise), the s/iteration and each device's peak beside phase 4's."""
    from deep_prior_interpolation_tpu_torch.data import flagship_problem

    img, mask = flagship_problem(256, 128, 128)
    _, out = sharded_flagship(mesh, flagship_config(), img, mask, label)
    loss = out["losses"]
    rel = abs(loss[0] - main["loss0"]) / abs(main["loss0"])
    log(f"{label}: first 3 losses {loss[:3]} against phase 4's {main['losses'][:3]}; "
        f"iteration-0 rel err {rel:.3e} (tol {LOSS0_TOL_BF16:g}, bf16 sums in another order)")
    log(f"{label}: steady s/iteration {out['s_per_iter']:.4f} against phase 4's "
        f"{main['s_per_iter']:.4f}; peak against phase 4's {main['peak_bytes'] / 2**30:.2f} "
        f"GiB (predicted: {PREDICTED_10A})")
    if not rel <= LOSS0_TOL_BF16:
        fail(f"{label}: the iteration-0 loss differs from phase 4's")
    out["loss0_rel_err"] = rel
    return out


def spatial_flagship(dev, main: dict) -> dict:
    """10a: the flagship over [cuda:0] * 2 and [cuda:0] * 4 along axis 1."""
    from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh
    return {str(n): spatial_solve(dev, make_spatial_mesh(n, [dev] * n), f"10a {n} shards",
                                  main) for n in SPATIAL_SHARDS}


def _grad_errors(net, grads, ref) -> dict:
    """The worst conv kernel's max |g - g_ref| over its max |g_ref|, the
    whole gradient vector's error in norm, and the worst leaf's name."""
    worst, name = max((float((a - b).abs().max()) / float(b.abs().max()), n)
                      for (n, _), a, b in zip(net.named_parameters(), grads, ref)
                      if n.endswith("kernel"))
    if not all(bool(torch.isfinite(a).all()) for a in list(grads) + list(ref)):
        worst, name = math.nan, "a gradient that is not finite"
    flat = torch.cat([a.flatten() for a in grads]), torch.cat([b.flatten() for b in ref])
    return {"kernel_rel_err": worst, "worst_kernel": name,
            "norm_rel_err": float((flat[0] - flat[1]).norm()) / float(flat[1].norm())}


def spatial_gradients(dev, main: dict) -> dict:
    """10a: one flagship iteration's parameter gradients (the net and the
    fused loss; phase 4's parameters, a random canvas), over 2 and 4 shards
    against the unsharded net's, by the worst conv kernel (max error over
    its max entry) and the whole vector (in norm). The flagship amplifies
    rounding (a change of summation order in float32 moves a kernel's
    gradient by 1e-2 of its max on the CPU at small volumes), so each
    precision is held to its own error: float32 with TF32 off no further
    than TF32 (PyTorch's default for float32 convs) moves the unsharded
    gradients, bfloat16 (phase 4's dtype) no further than the unsharded
    bf16 gradients lie from the float32 ones (the unsharded nets on the
    Norm's tensor ops, the shards' arithmetic; the Norm kernels' bf16 error
    printed beside them); beside them, how far moving
    every canvas entry one float32 ulp moves the unsharded gradients. The
    tight check is the CPU's, in float64 at this width
    (``tests/test_torch_spatial_flagship.py``). Then the witness for 10a's
    trajectories: 3
    unsharded bf16 iterations with dW from cuDNN instead of the kernel
    (another summation order, and dW rounded to bf16: a change at rounding
    level, no shards), against phase 4's losses."""
    from types import SimpleNamespace

    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.models import get_net, init_weights
    from deep_prior_interpolation_tpu_torch.ops.fused_loss import fused_loss_metrics
    from deep_prior_interpolation_tpu_torch.parallel.spatial import ShardedStep, SpatialLayout

    img_np, mask_np = flagship_problem(256, 128, 128)
    img = torch.from_numpy(img_np[..., 0])[None, None].to(dev)
    mask = torch.from_numpy(mask_np[..., 0])[None, None].to(dev)
    g = torch.Generator(device=dev).manual_seed(13)
    x16 = (0.1 * torch.randn((1, 64) + _L[0], generator=g, device=dev)).to(torch.bfloat16)
    settings = SimpleNamespace(fused_loss=True, loss="mae")
    set_kernels(True)

    def grads(net, x, n, kernels=False):
        params = list(net.parameters())
        if n == 1:
            # the unsharded reference on the shards' Norm arithmetic, unless asked
            with contextlib.nullcontext() if kernels else tensor_op_norms():
                loss = fused_loss_metrics(net(x), img, mask)[0]
        else:
            layout = SpatialLayout([dev] * n, SPATIAL_AXIS, _L[0], _L[0], 16)
            step = ShardedStep(net, layout)
            data = {"img": layout.split(img, True), "mask": layout.split(mask, True)}
            loss = step.loss_terms(step(layout.split(x)), data, settings, x.dtype, dev)[1]
        out = [t.detach().float() for t in torch.autograd.grad(loss, params)]
        torch.cuda.empty_cache()
        return out

    def held(label, net, got, ref, bound):
        e = _grad_errors(net, got, ref)
        log(f"10a gradients {label}: worst conv kernel {e['kernel_rel_err']:.3e} of its max "
            f"({e['worst_kernel']}), vector {e['norm_rel_err']:.3e} in norm"
            + ("" if bound is None else f" (bound {bound['kernel_rel_err']:.3e} and "
                                        f"{bound['norm_rel_err']:.3e})"))
        if bound is not None and not (e["kernel_rel_err"] <= bound["kernel_rel_err"]
                                      and e["norm_rel_err"] <= bound["norm_rel_err"]):
            fail(f"10a: the sharded flagship's gradients ({label}) are further from the "
                 f"unsharded ones than the precision's own error")
        return e

    res = {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    net = get_net(flagship_config(dtype="float32"))
    init_weights(net, torch.Generator().manual_seed(0))
    net = net.to(dev)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        on = grads(net, x16.float(), 1)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        ref32 = grads(net, x16.float(), 1)
        own = res["float32_tf32"] = held("float32 unsharded, TF32 on against off (TF32's own "
                                         "error)", net, on, ref32, None)
        del on
        # the witness of the amplification: every canvas entry one ulp up
        up = torch.nextafter(x16.float(), torch.tensor(math.inf, device=dev))
        res["float32_ulp"] = held("float32 unsharded, the canvas one ulp up against as it is "
                                  "(a change at rounding level)", net, grads(net, up, 1), ref32,
                                  None)
        del up
        for n in SPATIAL_SHARDS:
            res[f"float32_{n}"] = held(f"float32 (TF32 off), {n} shards against unsharded", net,
                                       grads(net, x16.float(), n), ref32, own)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del net
    net = get_net(flagship_config())
    init_weights(net, torch.Generator().manual_seed(0))
    net = net.to(dev)
    ref16 = grads(net, x16, 1)
    own = res["bfloat16_own"] = held("bfloat16 unsharded against float32 (bf16's own error)",
                                     net, ref16, ref32, None)
    res["bfloat16_kernels"] = held("bfloat16 unsharded, the Norm kernels, against float32",
                                   net, grads(net, x16, 1, kernels=True), ref32, None)
    for n in SPATIAL_SHARDS:
        res[f"bfloat16_{n}"] = held(f"bfloat16, {n} shards against unsharded", net,
                                    grads(net, x16, n), ref16, own)
    del net, ref16, ref32
    torch.cuda.empty_cache()
    # the witness: phase 4's solve with dW changed at rounding level
    set_kernels(False)
    try:
        loss = DIPSolver(flagship_config(epochs=3), outchannel=1, device=dev).solve(
            img_np, mask_np, seed=0).history.loss
    finally:
        set_kernels(True)
    rel = [abs(float(a) - b) / abs(b) for a, b in zip(loss, main["losses"][:3])]
    res["reorder_losses"], res["reorder_rel_err"] = [float(v) for v in loss], rel
    log(f"10a witness: unsharded, dW from cuDNN (bf16) instead of the kernel: losses "
        f"{[float(v) for v in loss]} against phase 4's {main['losses'][:3]}, rel {rel}")
    return res


def spatial_exactness(dev, tmp: str) -> dict:
    """10b: phase 3's small float32 3D solve over 4 shards of the card
    against the unsharded card solve (first 3 losses rel 1e-4, as the CPU
    tests hold them); two sharded solves, and a sharded resume from a
    3-iteration checkpoint, bit-equal to a straight sharded solve (each
    with a checkpoint path, so deterministic cuDNN)."""
    import dataclasses

    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh

    cfg, img, mask, noise, init, _ = small_problem()
    set_kernels(True)
    mesh = make_spatial_mesh(4, [dev] * 4)
    kw = dict(seed=0, init_params=init, noise=noise)
    plain = DIPSolver(cfg, device=dev).solve(img, mask, **kw)
    reset_counts()
    sharded = DIPSolver(cfg, device=dev).solve(img, mask, spatial_mesh=mesh,
                                               spatial_axis=SPATIAL_AXIS, **kw)
    counts = read_counts()
    a, b = np.asarray(sharded.history.loss), np.asarray(plain.history.loss)
    err = float(np.max(np.abs(a[:3] - b[:3]) / np.abs(b[:3])))
    log(f"10b: sharded {a.tolist()}\n     unsharded {b.tolist()}\n     max rel err of "
        f"iterations 0-2 {err:.3e} (tol 1e-4); launches {counts}")
    if not err <= 1e-4:
        fail("10b: the sharded small solve disagrees with the unsharded one")
    if counts["fused_loss"] != 4 * 6 or counts["upsample_bwd"] != 4 * 2 * 6 \
            or counts["wgrad3d"] == 0:
        fail(f"10b: the sharded small solve did not launch the kernels on every shard: {counts}")

    def run(name, epochs):
        c = dataclasses.replace(cfg, epochs=epochs, scan_chunk=3)
        return DIPSolver(c, device=dev).solve(
            img, mask, spatial_mesh=mesh, spatial_axis=SPATIAL_AXIS,
            checkpoint_path=os.path.join(tmp, name), checkpoint_every=1, **kw)
    first, second = run("spatial_a.npz", 6), run("spatial_b.npz", 6)
    run("spatial_c.npz", 3)
    resumed = run("spatial_c.npz", 6)
    twice = (np.array_equal(first.history.loss, second.history.loss)
             and np.array_equal(first.out_best, second.out_best))
    resume = (resumed.iters_run == 6 and np.array_equal(first.history.loss, resumed.history.loss)
              and np.array_equal(first.out_best, resumed.out_best))
    log(f"10b: two sharded solves bit-equal {twice}; a resume from 3 iterations bit-equal to "
        f"the straight solve {resume} ({resumed.history.loss})")
    if not (twice and resume):
        fail("10b: sharded solves from one seed, or a sharded resume, are not bit-equal")
    return {"rel_err_first_3": err, "launches": counts, "two_runs_bit_equal": twice,
            "resume_bit_equal": resume}


def spatial_wgrad_row(dev, ci: int, co: int, sp, hs: int, n: int, k: int, g,
                      time_plain: bool, label: str = "10c", dt=torch.bfloat16) -> dict:
    """10c, 12d, 13e: the wgrad kernel on one shard's (x with its two halo
    planes, dy padded with zero planes) along H, against its plain version
    (1e-4 of max |dW| + 1e-4), timed beside its bound, the plain version
    (where ``time_plain``) and ``conv3d_weight`` of the shard's conv
    (unpadded along H; TF32 off for float32); ``k`` launches a shard an
    iteration."""
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

    d, h, w = sp
    x = torch.randn((1, ci, d, hs + 2, w), generator=g, device=dev).to(dt)
    dy = torch.randn((1, co, d, hs, w), generator=g, device=dev).to(dt)
    dyp = torch.nn.functional.pad(dy, (0, 0, 1, 1))
    got = WG.wgrad3d(x, dyp, 3)
    torch.cuda.synchronize()
    ref = WG.wgrad3d_plain(x, dyp, 3)
    err = float((got - ref).abs().max())
    lim = 1e-4 * float(ref.abs().max()) + 1e-4
    del got, ref
    row = {"ci": ci, "co": co, "spatial": list(sp), "shards": n, "x_shape": list(x.shape[2:]),
           "dy_shape": list(dyp.shape[2:]), "dtype": str(dt).split(".")[-1],
           "launches_per_iteration": n * k, "max_abs_err": err, "tol": lim,
           "ms": time_ms(lambda: WG.wgrad3d(x, dyp, 3)),
           "plain_ms": time_ms(lambda: WG.wgrad3d_plain(x, dyp, 3)) if time_plain else None}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        row["library_ms"] = time_ms(lambda: torch.nn.grad.conv3d_weight(
            x, (co, ci, 3, 3, 3), dy, stride=1, padding=(1, 0, 1)))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    # x and dy read once, dW written once; the products of the shard's own
    # (valid along H) conv
    n_bytes = (ci * x[0, 0].numel() + co * dy[0, 0].numel()) * x.element_size() \
        + co * ci * 27 * 4
    n_flops = 2.0 * ci * co * 3 * hs * _valid_products((d, 1, w), 3)
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_flops, dt)
    plain = "not timed" if row["plain_ms"] is None else f"{row['plain_ms']:.4f}"
    log(f"{label} wgrad {ci}->{co} {tuple(sp)} {row['dtype']}, shard of {hs} of {h} planes "
        f"(x {tuple(x.shape[2:])}, "
        f"padded dy), {n} shards: max abs err {err:.3e} (tol {lim:.3e}); ms {row['ms']:.4f} "
        f"plain {plain} conv3d_weight {row['library_ms']:.4f} bound {row['bound_ms']:.4f} "
        f"({row['bound_by']}), {n * k} launches/iteration")
    if not err <= lim:
        fail(f"{label}: wgrad on the shard of {ci}->{co} {tuple(sp)} ({n} shards) disagrees "
             f"with the plain one")
    return row


def spatial_kernels(dev) -> dict:
    """10c: each kernel at the shard shapes of 10a against its plain
    version: wgrad on (x with its halo, padded dy) at every one of 10a's
    shard shapes for 2 and 4 shards (each flagship conv at each shard's H
    extent), and the shards' dW summed in shard order against the
    unsharded kernel's dW; the fused loss on each shard's (256, 128 / N,
    128) bf16 output, forward and backward, and the shards' sums against
    the whole volume's; the upsample's backward at every shard shape of 10a
    (bit-equal)."""
    from deep_prior_interpolation_tpu_torch.ops import upsample as U
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

    g = torch.Generator(device=dev).manual_seed(10)
    rows = []
    for n in SPATIAL_SHARDS:
        for ci, co, sp, k in WGRAD_SHAPES:
            for hs in sorted({b - a for a, b in _shard_planes(sp[1], n)}):
                rows.append(spatial_wgrad_row(dev, ci, co, sp, hs, n, k, g,
                                              (ci, co) in PLAIN_TIMED))
        per_iter = sum(r["ms"] * r["launches_per_iteration"] for r in rows if r["shards"] == n)
        log(f"10c wgrad ms/iteration over {n} shards: sum of launches x ms over the "
            f"{sum(r['shards'] == n for r in rows)} shard shapes = {per_iter:.4f}")
    got = {(r["ci"], r["co"], tuple(r["x_shape"]), r["shards"]) for r in rows}
    if got != {key + (n,) for n in SPATIAL_SHARDS for key in spatial_wgrad_shapes(n)}:
        fail(f"10c: the wgrad rows {sorted(got)} are not 10a's shard shapes")
    out = {"wgrad": rows}
    # the shards' dW summed against the whole conv's, the heaviest shape
    x = torch.randn((1, 67) + _L[0], generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn((1, 4) + _L[0], generator=g, device=dev).to(torch.bfloat16)
    whole = WG.wgrad3d(x, dy, 3)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1))
    sums = {}
    for n in SPATIAL_SHARDS:
        total = None
        for a, b in _shard_planes(128, n):
            dw = WG.wgrad3d(xp[:, :, :, a:b + 2].contiguous(), torch.nn.functional.pad(
                dy[:, :, :, a:b], (0, 0, 1, 1)), 3)
            total = dw if total is None else total + dw
        err = float((total - whole).abs().max())
        lim = 1e-4 * float(whole.abs().max()) + 1e-4
        sums[str(n)] = {"max_abs_err": err, "tol": lim}
        log(f"10c wgrad 67->4 {_L[0]}: the {n} shards' dW summed in order against the "
            f"unsharded kernel's dW, max abs err {err:.3e} (tol {lim:.3e}, float32 sums in "
            f"another order)")
        if not err <= lim:
            fail(f"10c: the {n} shards' dW do not sum to the unsharded dW")
    out["wgrad_shard_sums"] = sums
    del x, dy, xp, whole
    # the fused loss at the shards' shapes
    out["fused"] = [fused_shard_row(dev, (1, 1, 256, 128 // n, 128), torch.bfloat16, g, "10c", n)
                    for n in SPATIAL_SHARDS]
    # the upsample's backward at every shard shape of 10a: a shard's input
    # planes with a halo plane on each side, along H
    ups = []
    for c, sp in UPSAMPLE_SHAPES:
        for n in SPATIAL_SHARDS:
            for hs in sorted({b - a for a, b in _shard_planes(sp[1], n)}):
                go = torch.randn((1, c, 2 * sp[0], 2 * (hs + 2), 2 * sp[2]), generator=g,
                                 device=dev).to(torch.bfloat16)
                got = U.upsample_bwd(go, 3)
                equal = torch.equal(got, U.upsample_bwd_plain(go, 3))
                kernel = U.plan(c, sp[0], hs + 2, sp[2], True, 2).kernel
                sizes = [1, c, sp[0], hs + 2, sp[2]]
                row = {"channels": c, "shards": n, "input": sizes[2:],
                       "kernel": kernel, "bit_equal_to_plain": equal,
                       "ms": time_ms(lambda: U.upsample_bwd(go, 3)),
                       "plain_ms": time_ms(lambda: U.upsample_bwd_plain(go, 3)),
                       "library_ms": time_ms(
                           lambda: torch.ops.aten.upsample_trilinear3d_backward(
                               go, list(go.shape[2:]), sizes, False, 2.0, 2.0, 2.0))}
                n_in = c * sp[0] * (hs + 2) * sp[2]
                row["bound_ms"], row["bound_by"] = bound_ms(9 * n_in * 2, 49.0 * n_in,
                                                            torch.float32)
                log(f"10c upsample_bwd {c} x {tuple(row['input'])} ({n} shards, {kernel}): "
                    f"bit-equal to the plain version {equal}; ms {row['ms']:.4f} bound "
                    f"{row['bound_ms']:.4f} plain {row['plain_ms']:.4f} atomic "
                    f"upsample_trilinear3d_backward {row['library_ms']:.4f}")
                if not equal:
                    fail(f"10c: upsample_bwd at the shard shape {c} x {row['input']} is not "
                         f"bit-equal to the plain version")
                ups.append(row)
                del go, got
    out["upsample"] = ups
    return out


def spatial_multicard(dev, main: dict) -> dict:
    """10d: 10a's 2-shard solve over cuda:0 and cuda:1, where there are two
    cards; each device's peak."""
    from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh

    if torch.cuda.device_count() < 2:
        log("10d: skipped, one card (a 2-card mesh needs two)")
        return {"skipped": "one card"}
    return spatial_solve(dev, make_spatial_mesh(2), "10d cuda:0 + cuda:1", main)


# ----------------------------------------------------------------------
# phase 11: the solver's options over spatial shards
# ----------------------------------------------------------------------

# 11a's options, each drawing from a generator of the step (the virtual
# canvas from the canvas's); the low-pass canvas runs in 11b, as a shaped
# canvas turns the virtual one off (StepSettings.from_config, as in the JAX
# package)
OPTIONS_11A = dict(param_noise=True, dropout=0.1, virtual_input=True, remat=True)
OPTIONS_11B = dict(dtype="float32", data_forgetting_factor=5, pocs=True, lowpass_fs=250.0,
                   lowpass_fc=40.0)
LOSS0_TOL_11 = 1e-4
# what was predicted before the first card run of phase 11 (PERF.md)
PREDICTED_11 = ("11a s/iteration 0.30-0.45 at N = 2, 0.50-0.75 at N = 4 (10a's plus remat's "
                "second forward and the canvas drawn again); peak 6-9 GiB at both; 11b peak "
                "17-21 GiB without remat, 7-10 with it")


def _rel(a: float, b: float) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def spatial_options(dev, phase10: dict) -> dict:
    """11a: the flagship with parameter noise, dropout 0.1, the virtual
    canvas and remat over [cuda:0] * 2 and * 4, 6 iterations each, traced
    as 10a (launches 32 N / N / N / 4 N an iteration, the shard shapes, all
    upsamples on TMA); the iteration-0 loss against the unsharded solve
    with the same options and seed (rel 1e-4); s/iteration and peak beside
    10a's."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh

    img, mask = flagship_problem(256, 128, 128)
    set_kernels(True)
    ref = DIPSolver(flagship_config(epochs=1, scan_chunk=1, **OPTIONS_11A), outchannel=1,
                    device=dev).solve(img, mask, seed=0).history.loss[0]
    out = {"unsharded_loss0": ref}
    for n in SPATIAL_SHARDS:
        label = f"11a {n} shards"
        _, r = sharded_flagship(make_spatial_mesh(n, [dev] * n),
                                flagship_config(epochs=6, **OPTIONS_11A), img, mask, label)
        r["loss0_rel_err"] = rel = _rel(r["losses"][0], ref)
        ten = phase10[str(n)]
        log(f"{label}: iteration-0 loss {r['losses'][0]:.7g} against the unsharded solve's "
            f"{ref:.7g}, rel err {rel:.3e} (tol {LOSS0_TOL_11:g}); s/iteration "
            f"{r['s_per_iter']:.4f} against 10a's {ten['s_per_iter']:.4f}; peak "
            f"{max(r['peak_bytes'].values()) / 2**30:.2f} GiB against 10a's "
            f"{max(ten['peak_bytes'].values()) / 2**30:.2f} (predicted: {PREDICTED_11})")
        if not rel <= LOSS0_TOL_11:
            fail(f"{label}: the iteration-0 loss differs from the unsharded solve's")
        out[str(n)] = r
    return out


def spatial_float32(dev) -> dict:
    """11b: the flagship in float32 (TF32 off) with data forgetting, POCS
    (adaptive eps) and the low-pass canvas over [cuda:0] * 2, 4 iterations
    without and with remat: the iteration-0 loss, df, reg and eps against
    the unsharded solve's (rel 1e-4), launches and shapes as 10a, and the
    peak memory of each."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh

    img, mask = flagship_problem(256, 128, 128)
    set_kernels(True)
    ref = DIPSolver(flagship_config(epochs=1, scan_chunk=1, **OPTIONS_11B), outchannel=1,
                    device=dev).solve(img, mask, seed=0).history
    out = {}
    for remat in (False, True):
        label = f"11b float32 2 shards{' + remat' if remat else ''}"
        res, r = sharded_flagship(make_spatial_mesh(2, [dev] * 2),
                                  flagship_config(epochs=4, scan_chunk=2, remat=remat,
                                                  **OPTIONS_11B), img, mask, label)
        errs = {f: _rel(getattr(res.history, f)[0], getattr(ref, f)[0])
                for f in ("loss", "df", "reg", "eps")}
        log(f"{label}: iteration 0 against the unsharded solve, rel err {errs} (tol "
            f"{LOSS0_TOL_11:g}); df {res.history.df[0]:.7g} reg {res.history.reg[0]:.7g} "
            f"eps {res.history.eps[0]:.7g}")
        if not all(e <= LOSS0_TOL_11 for e in errs.values()):
            fail(f"{label}: iteration 0 differs from the unsharded solve's")
        if res.pocs is None or not np.all(np.isfinite(res.pocs)):
            fail(f"{label}: the final projection is missing or not finite")
        out["remat" if remat else "plain"] = dict(r, iteration0_rel_err=errs)
        del res
        torch.cuda.empty_cache()
    log(f"11b: peak {max(out['plain']['peak_bytes'].values()) / 2**30:.2f} GiB without remat, "
        f"{max(out['remat']['peak_bytes'].values()) / 2**30:.2f} with it (predicted: "
        f"{PREDICTED_11})")
    return out


def spatial_options_exactness(dev, tmp: str) -> dict:
    """11c: phase 3's small float32 solve with dropout, parameter noise and
    remat over 4 shards of the card: two solves, and a resume from a
    3-iteration checkpoint, bit-equal (each with a checkpoint path, so
    deterministic cuDNN)."""
    import dataclasses

    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh

    cfg, img, mask, noise, init, _ = small_problem()
    cfg = dataclasses.replace(cfg, dropout=0.1, param_noise=True, remat=True, scan_chunk=3)
    set_kernels(True)
    mesh = make_spatial_mesh(4, [dev] * 4)

    def run(name, epochs):
        return DIPSolver(dataclasses.replace(cfg, epochs=epochs), device=dev).solve(
            img, mask, seed=0, init_params=init, noise=noise, spatial_mesh=mesh,
            spatial_axis=SPATIAL_AXIS, checkpoint_path=os.path.join(tmp, name),
            checkpoint_every=1)
    first, second = run("options_a.npz", 6), run("options_b.npz", 6)
    run("options_c.npz", 3)
    resumed = run("options_c.npz", 6)
    twice = (np.array_equal(first.history.loss, second.history.loss)
             and np.array_equal(first.out_best, second.out_best))
    resume = (resumed.iters_run == 6 and np.array_equal(first.history.loss, resumed.history.loss)
              and np.array_equal(first.out_best, resumed.out_best))
    log(f"11c: two sharded solves with dropout, parameter noise and remat bit-equal {twice}; a "
        f"resume from 3 iterations bit-equal to the straight solve {resume} "
        f"({resumed.history.loss})")
    if not (twice and resume):
        fail("11c: sharded solves with the options, or their resume, are not bit-equal")
    return {"two_runs_bit_equal": twice, "resume_bit_equal": resume,
            "losses": list(first.history.loss)}


# ----------------------------------------------------------------------
# phase 12: phase space, the optimised canvas and tapmm over spatial shards
# ----------------------------------------------------------------------

# 12b: the float32 flagship with its canvas optimised, and remat
OPTIONS_12B = dict(dtype="float32", opt_over="net,input", remat=True)
# the share of the max by which a canvas entry counts as apart (reported)
CANVAS_TOL_12 = 1e-5
# what was predicted before the first card run of phase 12 (PERF.md)
PREDICTED_12 = ("12a s/iteration 0.26-0.36 at N = 2, 0.42-0.60 at N = 4 (10a's plus a "
                "weight transform a phase conv a shard); peak 15.5-18 GiB at both; 12b "
                "peak 12-15 GiB at N = 2")


def spatial_phase(dev, phase7: dict) -> dict:
    """12a: the phase flagship (``PHASE7``) over [cuda:0] * 2 and * 4 along
    H, 9 iterations in chunks of 3, traced as 10a (launches 30 N / N / N /
    2 N an iteration, the hooks' wgrad and upsample shapes the phase
    path's shard shapes, every upsample backward on the TMA kernel); the
    iteration-0 loss against 7a's unsharded phase solve (rel 1e-3, bf16
    sums in another order); s/iteration and peak beside 7a's."""
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh

    img, mask = flagship_problem(256, 128, 128)
    ref = phase7["7a_flagship"]
    out = {}
    for n in SPATIAL_SHARDS:
        label = f"12a phase flagship {n} shards"
        _, r = sharded_flagship(make_spatial_mesh(n, [dev] * n), flagship_config(**PHASE7),
                                img, mask, label)
        r["loss0_rel_err"] = rel = _rel(r["losses"][0], ref["loss0"])
        log(f"{label}: iteration-0 loss {r['losses'][0]:.7g} against 7a's {ref['loss0']:.7g}, "
            f"rel err {rel:.3e} (tol {LOSS0_TOL_BF16:g}); s/iteration {r['s_per_iter']:.4f} "
            f"against 7a's {ref['s_per_iter']:.4f}; peak "
            f"{max(r['peak_bytes'].values()) / 2**30:.2f} GiB against 7a's "
            f"{ref['peak_bytes'] / 2**30:.2f} (predicted: {PREDICTED_12})")
        if not rel <= LOSS0_TOL_BF16:
            fail(f"{label}: the iteration-0 loss differs from 7a's")
        out[str(n)] = r
    return out


def _canvas_errors(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """max |got - ref| over max |ref|, the error in norm, and the H plane of
    the largest error."""
    diff = (got - ref).abs()
    plane = int(diff.flatten().argmax()) // (diff.shape[-1]) % diff.shape[-2]
    return {"max_rel_err": float(diff.max()) / float(ref.abs().max()),
            "norm_rel_err": float((got - ref).norm()) / float(ref.norm()), "worst_h": plane}


def spatial_canvas(dev) -> dict:
    """12b: the flagship in float32 (TF32 off) with its canvas optimised
    (``opt_over="net,input"``) and remat over [cuda:0] * 2. First one
    step's gradient by the canvas (the net, the fused loss; phase 4's
    parameters, a random canvas), sharded against unsharded, held as 10a
    holds the parameters' gradients: no further than TF32 moves the
    unsharded one. Then the solve, 4 iterations in chunks of 2, traced as
    10a, against the unsharded solve of the same configuration: the
    iteration-0 loss (rel 1e-4), each peak, and how far the gathered
    canvas lies from the unsharded one after 4 updates (reported: Adam's
    first step moves each canvas entry by lr times the sign of its
    gradient, so an entry whose gradient is at rounding level can part by
    2 lr)."""
    from types import SimpleNamespace

    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.models import get_net, init_weights
    from deep_prior_interpolation_tpu_torch.ops.fused_loss import fused_loss_metrics
    from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh
    from deep_prior_interpolation_tpu_torch.parallel.spatial import ShardedStep, SpatialLayout

    img_np, mask_np = flagship_problem(256, 128, 128)
    img = torch.from_numpy(img_np[..., 0])[None, None].to(dev)
    mask = torch.from_numpy(mask_np[..., 0])[None, None].to(dev)
    set_kernels(True)
    net = get_net(flagship_config(dtype="float32"))
    init_weights(net, torch.Generator().manual_seed(0))
    net = net.to(dev)
    x = 0.1 * torch.randn((1, 64) + _L[0], generator=torch.Generator(device=dev).manual_seed(14),
                          device=dev)
    settings = SimpleNamespace(fused_loss=True, loss="mae")

    def canvas_grad(n):
        xg = x.clone().requires_grad_()
        if n == 1:
            loss = fused_loss_metrics(net(xg), img, mask)[0]
        else:
            layout = SpatialLayout([dev] * n, SPATIAL_AXIS, _L[0], _L[0], 16)
            step = ShardedStep(net, layout)
            data = {"img": layout.split(img, True), "mask": layout.split(mask, True)}
            loss = step.loss_terms(step(layout.split(xg)), data, settings, torch.float32, dev)[1]
        g = torch.autograd.grad(loss, xg)[0]
        torch.cuda.empty_cache()
        return g

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        on = canvas_grad(1)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        ref = canvas_grad(1)
        own = _canvas_errors(on, ref)
        del on
        sharded = canvas_grad(2)
        got = _canvas_errors(sharded, ref)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    # Adam's first step from each gradient, g / (|g| + eps) an entry times
    # lr: how far apart one update puts the two canvases
    apart = (sharded / (sharded.abs() + 1e-8) - ref / (ref.abs() + 1e-8)).abs()
    lr = FLAGSHIP["lr"]
    got["first_step_max_rel"] = lr * float(apart.max()) / float(x.abs().max())
    got["first_step_share_apart"] = float((lr * apart > CANVAS_TOL_12 * x.abs().max()).float()
                                          .mean())
    del net, ref, sharded, apart, x
    torch.cuda.empty_cache()
    log(f"12b canvas gradient, float32 (TF32 off), 2 shards against unsharded: max "
        f"{got['max_rel_err']:.3e} of the max (at H plane {got['worst_h']}; shards meet at "
        f"64), {got['norm_rel_err']:.3e} in norm (bound, TF32's own error: "
        f"{own['max_rel_err']:.3e} and {own['norm_rel_err']:.3e}); Adam's first step from "
        f"each puts the canvases {got['first_step_max_rel']:.3e} of the canvas max apart, "
        f"{got['first_step_share_apart']:.3e} of the entries further than "
        f"{CANVAS_TOL_12:g}")
    if not (got["max_rel_err"] <= own["max_rel_err"]
            and got["norm_rel_err"] <= own["norm_rel_err"]):
        fail("12b: the sharded canvas gradient is further from the unsharded one than "
             "TF32's own error")

    cfg = flagship_config(epochs=4, scan_chunk=2, **OPTIONS_12B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ref = DIPSolver(cfg, outchannel=1, device=dev).solve(img_np, mask_np, seed=0)
    ref_peak = torch.cuda.max_memory_allocated(dev)
    label = "12b float32 canvas + remat, 2 shards"
    res, out = sharded_flagship(make_spatial_mesh(2, [dev] * 2), cfg, img_np, mask_np, label)
    rel = _rel(res.history.loss[0], ref.history.loss[0])
    diff = np.abs(res.noise - ref.noise)
    scale = float(np.abs(ref.noise).max())
    apart = float((diff > CANVAS_TOL_12 * scale).mean())
    out.update({"unsharded_peak_bytes": ref_peak, "unsharded_losses": list(ref.history.loss),
                "loss0_rel_err": rel, "canvas_gradient": got, "canvas_gradient_bound": own,
                "canvas_rel_err": float(diff.max()) / scale, "canvas_share_apart": apart})
    log(f"{label}: losses {list(res.history.loss)} against unsharded {list(ref.history.loss)}; "
        f"iteration-0 rel err {rel:.3e} (tol {LOSS0_TOL_11:g}); after 4 updates the canvas "
        f"lies {out['canvas_rel_err']:.3e} of its max from the unsharded one, {apart:.3e} of "
        f"its entries further than {CANVAS_TOL_12:g} (Adam's sign-like steps; lr "
        f"{cfg.lr:g} is {cfg.lr / scale:.3e} of the max)")
    log(f"12b: peak {max(out['peak_bytes'].values()) / 2**30:.2f} GiB over 2 shards, "
        f"{ref_peak / 2**30:.2f} unsharded; s/iteration {out['s_per_iter']:.4f} (predicted: "
        f"{PREDICTED_12})")
    if not rel <= LOSS0_TOL_11:
        fail(f"{label}: the iteration-0 loss differs from the unsharded solve's")
    return out


def spatial_phase_exactness(dev, tmp: str) -> dict:
    """12c: phase 3's small float32 solve in phase space (levels 2) with
    tapmm and the optimised canvas over 4 shards of the card: two solves,
    and a resume from a 3-iteration checkpoint, bit-equal (history,
    ``out_best`` and the optimised canvas; each with a checkpoint path, so
    deterministic cuDNN)."""
    import dataclasses

    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh

    cfg, img, mask, noise, init, _ = small_problem()
    cfg = dataclasses.replace(cfg, phase_space=True, phase_levels=2, vmap_conv_mode="tapmm",
                              opt_over="net,input", scan_chunk=3)
    set_kernels(True)
    mesh = make_spatial_mesh(4, [dev] * 4)

    def run(name, epochs):
        return DIPSolver(dataclasses.replace(cfg, epochs=epochs), device=dev).solve(
            img, mask, seed=0, init_params=init, noise=noise, spatial_mesh=mesh,
            spatial_axis=SPATIAL_AXIS, checkpoint_path=os.path.join(tmp, name),
            checkpoint_every=1)
    reset_counts()
    first = run("phase_shards_a.npz", 6)
    counts = read_counts()
    second = run("phase_shards_b.npz", 6)
    run("phase_shards_c.npz", 3)
    resumed = run("phase_shards_c.npz", 6)

    def same(a, b):
        return (np.array_equal(a.history.loss, b.history.loss)
                and np.array_equal(a.out_best, b.out_best) and np.array_equal(a.noise, b.noise))
    twice = same(first, second)
    resume = resumed.iters_run == 6 and same(first, resumed)
    moved = not np.array_equal(first.noise, noise)
    log(f"12c: phase space + tapmm + optimised canvas over 4 shards: losses "
        f"{first.history.loss}; launches {counts}; the canvas moved {moved}; two solves "
        f"bit-equal {twice}; a resume from 3 iterations bit-equal to the straight solve {resume}")
    if counts["fused_loss"] != 4 * 6 or counts["wgrad3d"] == 0:
        fail(f"12c: the sharded phase solve did not launch the kernels on every shard: {counts}")
    if not (moved and twice and resume):
        fail("12c: sharded phase solves with tapmm and the optimised canvas, or their resume, "
             "are not bit-equal")
    return {"two_runs_bit_equal": twice, "resume_bit_equal": resume, "launches": counts,
            "losses": list(first.history.loss)}


def spatial_phase_kernels(dev, phase10: dict) -> dict:
    """12d: the wgrad kernel at 12a's new shard shapes (the 9 phase convs on
    their phase grids, each shard's planes with a halo plane on each side,
    dy padded by zero planes) against its plain version, timed beside its
    bound, the plain version and ``conv3d_weight`` of the shard conv, as
    10c; and the phase path's wgrad ms an iteration over N shards, with
    10c's rows for its plain levels 2-4."""
    g = torch.Generator(device=dev).manual_seed(12)
    rows = []
    for n in SPATIAL_SHARDS:
        for ci, co, sp, k in PHASE_WGRAD_NEW:
            for hs in sorted({b - a for a, b in _shard_planes(sp[1], n)}):
                rows.append(spatial_wgrad_row(dev, ci, co, sp, hs, n, k, g, True, "12d"))
    want = {key + (n,) for n in SPATIAL_SHARDS for key in spatial_wgrad_shapes(n, True)}
    got = {(r["ci"], r["co"], tuple(r["x_shape"]), r["shards"])
           for r in rows + phase10["10c_kernels"]["wgrad"]}
    if not want <= got:
        fail(f"12d: no wgrad row at the phase path's shard shapes {sorted(want - got)}")
    per_iter = {}
    for n in SPATIAL_SHARDS:
        plain = [r for r in phase10["10c_kernels"]["wgrad"]
                 if r["shards"] == n and tuple(r["spatial"]) in _L[2:]]
        per_iter[str(n)] = sum(r["ms"] * r["launches_per_iteration"]
                               for r in plain + [r for r in rows if r["shards"] == n])
        log(f"12d wgrad ms/iteration on the phase path over {n} shards: sum of launches x ms "
            f"over its shard shapes = {per_iter[str(n)]:.4f}")
    return {"wgrad": rows, "ms_per_iteration": per_iter}


# ----------------------------------------------------------------------
# phase 13: the zoo nets over spatial shards (parallel/spatial_zoo.py)
# ----------------------------------------------------------------------

# 13a, 13b: the 3D zoo nets at 6e's configuration, and each forward's
# linear upsamples (6e counts them)
ZOO_3D = (("skip", "bfloat16", 5), ("unet", "bfloat16", 4), ("part", "float32", 0))
# 13c: the lines command's attention net, its four gates' bilinear upsamples
ZOO_2D_SHARDS = 2
# float32 iteration-0 loss of a sharded zoo solve against 6e's / 6f's
LOSS0_TOL_13 = 1e-5
# what was predicted before the first card run of phase 13 (PERF.md)
PREDICTED_13 = ("13a s/iteration skip 0.09-0.16 / 0.15-0.30, unet 0.08-0.14 / 0.13-0.26 at "
                "N = 2 / 4 (6e 0.058 / 0.045: the launches grow N times); peak within 1.5 "
                "GiB of 6e's (6.04 / 4.47); 13b part 0.85-1.2 s at N = 2, 0.9-1.4 at N = 4, "
                "peak 15-19 GiB (6e 0.81 s, 14.72 GiB)")


def zoo_shard_shapes(zoo_net: dict, n: int) -> dict:
    """6e's wgrad shapes of a zoo net (Ci, Co, spatial, launches an
    iteration) on ``n`` shards along H: each shard's H / n planes with a
    halo plane on each side, each shape ``n`` times as often (the nets'
    levels split H evenly on whole blocks: 128 / 32 planes at most)."""
    want = collections.Counter()
    for ci, co, sp, _, k in zoo_net["wgrad_calls"]:
        want[(ci, co, (sp[0], sp[1] // n + 2, sp[2]))] += n * k
    return dict(want)


def zoo_solve(mesh, cfg, img, mask, label: str, ref: dict, ups: int) -> dict:
    """One zoo net (``cfg``) through ``DIPSolver.solve(spatial_mesh=mesh)``
    along H, traced as 10a: launches fused N + N, wgrad N x 6e's admitted
    convs and ``upsample_bwd`` N x the net's linear upsamples an iteration;
    the wgrad hook's shard shapes those of 6e's shapes split
    (``zoo_shard_shapes``); its s/iteration (median of chunks 2..), peak
    and iteration-0 loss beside 6e's unsharded solve (``ref``)."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.ops import upsample as U

    set_kernels(True)
    n, iters = len(mesh), cfg.epochs
    solver = DIPSolver(cfg, outchannel=1, device=mesh[0])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, counts, seen, seen_up = traced_solve(solver, img, mask, spatial_mesh=mesh,
                                              spatial_axis=SPATIAL_AXIS)
    peak = torch.cuda.max_memory_allocated()
    kinds = read_upsample_kernels()
    loss = np.asarray(res.history.loss)
    steady = statistics.median(res.chunk_seconds[1:]) / cfg.scan_chunk
    want = {"fused_loss": n * iters, "fused_loss_grad": n * iters,
            "wgrad3d": n * ref["wgrad_launches_per_iteration"] * iters,
            "upsample_bwd": n * ups * iters}
    ups_kernels = {f"{c} x {sp}": U.plan(c, *sp, True, 2 if cfg.dtype == "bfloat16" else 4)
                   .kernel for c, sp in sorted(seen_up)}
    rel = _rel(loss[0], ref["losses"][0])
    log(f"{label}: chunk seconds {res.chunk_seconds}; steady s/iteration {steady:.4f} against "
        f"6e's {ref['s_per_iter']:.4f}; peak {peak / 2**30:.2f} GiB against 6e's "
        f"{ref['peak_bytes'] / 2**30:.2f} (predicted: {PREDICTED_13})")
    log(f"{label}: launches {counts} (expected {want}); upsample_bwd by kernel {kinds}, the "
        f"shapes' kernels {ups_kernels}; {len(seen)} distinct wgrad shapes; iteration-0 loss "
        f"{loss[0]:.7g} against 6e's {ref['losses'][0]:.7g}, rel err {rel:.3e}")
    if not (len(loss) == iters and np.all(np.isfinite(loss))):
        fail(f"{label}: the loss is not finite for {iters} iterations")
    if res.out_best.shape != img.shape or not np.all(np.isfinite(res.out_best)):
        fail(f"{label}: out_best has shape {res.out_best.shape} or is not finite")
    if counts != want:
        fail(f"{label}: launch counts {counts}, not {want}")
    want_wg = {key: iters * k for key, k in zoo_shard_shapes(ref, n).items()}
    if dict(seen) != want_wg:
        fail(f"{label}: the wgrad shapes are {dict(seen)}, not 6e's split {want_wg}")
    del solver
    return {"shards": n, "launches": counts, "upsample_kernels": kinds,
            "upsample_shape_kernels": ups_kernels, "losses": loss.tolist(),
            "s_per_iter": steady, "chunk_seconds": res.chunk_seconds, "peak_bytes": peak,
            "loss0_rel_err": rel,
            "wgrad_shapes": [[ci, co, list(sp), c // iters] for (ci, co, sp), c
                             in sorted(seen.items())],
            "upsample_shapes": [[c, list(sp), k // iters] for (c, sp), k
                                in sorted(seen_up.items())]}


def zoo_sharded(dev, zoo: dict) -> dict:
    """13a and 13b: ``--net skip``, ``unet`` (bf16) and ``part`` (float32,
    TF32 off) at 6e's configuration (the flagship volume and flags) over
    [cuda:0] x 2 and x 4 along H, 4 iterations in chunks of 2, traced by
    ``zoo_solve``; the iteration-0 loss against
    6e's (bf16 rel 1e-3, float32 rel 1e-5)."""
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh

    img, mask = flagship_problem(256, 128, 128)
    out = {}
    for net, dtype, ups in ZOO_3D:
        depth = dict(epochs=4, scan_chunk=2)
        tol = LOSS0_TOL_13 if dtype == "float32" else LOSS0_TOL_BF16
        for n in SPATIAL_SHARDS:
            label = f"13{'b' if net == 'part' else 'a'} --net {net} ({dtype}) {n} shards"
            r = zoo_solve(make_spatial_mesh(n, [dev] * n),
                          flagship_config(net=net, dtype=dtype, **depth), img, mask, label,
                          zoo[net], ups)
            if not r["loss0_rel_err"] <= tol:
                fail(f"{label}: the iteration-0 loss differs from 6e's by more than {tol:g}")
            out[f"{net}_{n}"] = r
            torch.cuda.empty_cache()
    return out


def zoo_partial_gradients(dev) -> dict:
    """13b: one iteration's parameter gradients of ``--net part`` at the
    flagship volume (the fused loss; 6e's parameters, a random canvas and
    the flagship's mask as the net's), over 2 shards against unsharded,
    held as 10a holds the flagship's: float32 with TF32 off no further than
    TF32 moves the unsharded gradients."""
    from types import SimpleNamespace

    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.models import get_net, init_weights
    from deep_prior_interpolation_tpu_torch.ops.fused_loss import fused_loss_metrics
    from deep_prior_interpolation_tpu_torch.parallel.spatial import ShardedStep, SpatialLayout

    img_np, mask_np = flagship_problem(256, 128, 128)
    img = torch.from_numpy(img_np[..., 0])[None, None].to(dev)
    mask = torch.from_numpy(mask_np[..., 0])[None, None].to(dev)
    nm = mask.expand(1, 64, *_L[0])
    x = 0.1 * torch.randn((1, 64) + _L[0], generator=torch.Generator(device=dev).manual_seed(15),
                          device=dev)
    settings = SimpleNamespace(fused_loss=True, loss="mae")
    set_kernels(True)
    net = get_net(flagship_config(net="part", dtype="float32"))
    init_weights(net, torch.Generator().manual_seed(0))
    net = net.to(dev)

    def grads(n):
        params = list(net.parameters())
        if n == 1:
            loss = fused_loss_metrics(net(x, nm), img, mask)[0]
        else:
            layout = SpatialLayout([dev] * n, SPATIAL_AXIS, _L[0], _L[0], 32)
            step = ShardedStep(net, layout)
            data = {"img": layout.split(img, True), "mask": layout.split(mask, True)}
            loss = step.loss_terms(step(layout.split(x), layout.split(nm)), data, settings,
                                   torch.float32, dev)[1]
        out = [t.detach() for t in torch.autograd.grad(loss, params)]
        torch.cuda.empty_cache()
        return out

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        on = grads(1)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        ref = grads(1)
        own = _grad_errors(net, on, ref)
        del on
        got = _grad_errors(net, grads(2), ref)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del net, ref, x
    torch.cuda.empty_cache()
    log(f"13b gradients, float32 (TF32 off), 2 shards against unsharded: worst conv kernel "
        f"{got['kernel_rel_err']:.3e} of its max ({got['worst_kernel']}), vector "
        f"{got['norm_rel_err']:.3e} in norm (bound, TF32's own error: "
        f"{own['kernel_rel_err']:.3e} and {own['norm_rel_err']:.3e})")
    if not (got["kernel_rel_err"] <= own["kernel_rel_err"]
            and got["norm_rel_err"] <= own["norm_rel_err"]):
        fail("13b: the sharded partial-conv U-Net's gradients are further from the unsharded "
             "ones than TF32's own error")
    return {"sharded_2": got, "tf32_own": own}


def zoo_lines(dev, zoo_2d: dict) -> dict:
    """13c: the README's 2D command with ``--net attmultiunet`` (the patch
    ``cli.run`` solves, its seed and flags) through ``DIPSolver.solve``
    over [cuda:0] x 2 along axis 1 (the CLI's ``--spatial_shards`` takes
    one card a shard; the padded (176, 112) holds 7 blocks of 16 along
    axis 1), traced as 10a: launches 18 / 18 / 0 / 72 (the four gates'
    bilinear upsamples on each shard), the kernel each one-channel shape
    takes, finite POCS terms, the iteration-0 loss against 6f's unsharded
    run (rel 1e-5)."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import extract_patches
    from deep_prior_interpolation_tpu_torch.ops import upsample as U

    set_kernels(True)
    cfg = lines_config("unused", "--net", "attmultiunet")
    patch = extract_patches(cfg)[0]
    solver = DIPSolver(cfg, outchannel=patch["image"].shape[-1], device=dev)
    n = ZOO_2D_SHARDS
    res, counts, _, seen_up = traced_solve(solver, patch["image"], patch["mask"],
                                           spatial_mesh=[dev] * n, spatial_axis=1)
    kinds = read_upsample_kernels()
    want = {"fused_loss": 9 * n, "fused_loss_grad": 9 * n, "wgrad3d": 0,
            "upsample_bwd": 9 * 4 * n}
    shapes = {f"{c} x {sp}": U.plan(c, 1, *sp, False, 4).kernel for c, sp in sorted(seen_up)}
    loss = [float(v) for v in res.history.loss]
    ref = float(zoo_2d["attmultiunet"]["loss"][0])
    rel = _rel(loss[0], ref)
    log(f"13c lines --net attmultiunet over {n} shards: losses {loss}; launches {counts} "
        f"(expected {want}); upsample_bwd by kernel {kinds}, each shape's kernel {shapes}; "
        f"iteration-0 loss against 6f's {ref:.7g}, rel err {rel:.3e} (tol {LOSS0_TOL_13:g})")
    if counts != want:
        fail(f"13c: launch counts {counts}, not {want}")
    if not (len(loss) == 9 and all(np.all(np.isfinite(getattr(res.history, f)))
                                   for f in ("loss", "df", "reg", "eps"))):
        fail("13c: the sharded lines run is not 9 finite POCS iterations")
    if not rel <= LOSS0_TOL_13:
        fail("13c: the sharded lines run's iteration-0 loss differs from 6f's")
    return {"launches": counts, "losses": loss, "upsample_kernels": kinds,
            "upsample_shape_kernels": shapes, "loss0_rel_err": rel,
            "upsample_shapes": [[c, list(sp), k // 9] for (c, sp), k in sorted(seen_up.items())]}


def zoo_exactness(dev, tmp: str) -> dict:
    """13d: phase 3's small float32 problem with ``--net skip`` (linear
    upsampling) over 2 shards of the card: two 3-iteration solves from one
    seed, each with a checkpoint path (so deterministic cuDNN), and a
    resume from a 3-iteration checkpoint to 6, bit-equal to a straight
    6-iteration solve (history and ``out_best``)."""
    import dataclasses

    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh

    cfg, img, mask, _, _, _ = small_problem()
    cfg = dataclasses.replace(cfg, net="skip", scan_chunk=3)
    set_kernels(True)
    mesh = make_spatial_mesh(2, [dev] * 2)

    def run(name, epochs):
        return DIPSolver(dataclasses.replace(cfg, epochs=epochs), device=dev).solve(
            img, mask, seed=0, spatial_mesh=mesh, spatial_axis=SPATIAL_AXIS,
            checkpoint_path=os.path.join(tmp, name), checkpoint_every=1)
    reset_counts()
    first = run("zoo_a.npz", 6)
    counts = read_counts()
    second = run("zoo_b.npz", 6)
    run("zoo_c.npz", 3)
    resumed = run("zoo_c.npz", 6)

    def same(a, b):
        return (np.array_equal(a.history.loss, b.history.loss)
                and np.array_equal(a.out_best, b.out_best))
    twice = same(first, second)
    resume = resumed.iters_run == 6 and same(first, resumed)
    log(f"13d: --net skip over 2 shards: losses {first.history.loss}; launches {counts}; two "
        f"solves bit-equal {twice}; a resume from 3 iterations bit-equal to the straight solve "
        f"{resume}")
    if counts["fused_loss"] != 2 * 6 or counts["wgrad3d"] == 0 or counts["upsample_bwd"] == 0:
        fail(f"13d: the sharded skip solve did not launch the kernels on every shard: {counts}")
    if not (twice and resume):
        fail("13d: sharded skip solves from one seed, or their resume, are not bit-equal")
    return {"two_runs_bit_equal": twice, "resume_bit_equal": resume, "launches": counts,
            "losses": list(first.history.loss)}


def fused_shard_row(dev, shape, out_dtype, g, label: str, shards: int) -> dict:
    """The fused loss on one shard's cropped output of ``shape`` (``out``
    in ``out_dtype``, float32 target and mask), forward and backward,
    against the plain version: the sums to rel 1e-4, the gradient to one
    rounding of ``out``'s dtype of its max; CUDA-graph times over three
    input copies beside the bounds."""
    from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL

    img = torch.randn(shape, generator=g, device=dev)
    o = (img + torch.randn(shape, generator=g, device=dev)).to(out_dtype)
    mask = (torch.rand(shape, generator=g, device=dev) > 0.66).float()
    gin = torch.randn(8, generator=g, device=dev)
    sk, sp_ = FL.fused_sums(o, img, mask), FL.fused_sums_plain(o, img, mask)
    rel = float(((sk - sp_).abs() / sp_.abs().clamp_min(1e-30)).max())
    gk, gp = FL.loss_sums_grad(o, img, mask, gin).float(), \
        FL.loss_sums_grad_plain(o, img, mask, gin).float()
    gerr = float((gk - gp).abs().max())
    glim = (2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-5) * float(gp.abs().max())
    (fb, fby), (bb, bby) = _loss_bounds(o.numel(), out_dtype)
    copies = [(o.clone(), img.clone(), mask.clone()) for _ in range(3)]
    row = {"shards": shards, "shape": list(shape), "dtype": str(out_dtype).split(".")[-1],
           "max_rel_err": rel, "max_abs_err": float((sk - sp_).abs().max()),
           "grad_max_abs_err": gerr,
           "fwd": {"ms": graph_ms(cycling(FL.fused_sums, copies)),
                   "plain_ms": graph_ms(cycling(FL.fused_sums_plain, copies)),
                   "bound_ms": fb, "bound_by": fby},
           "bwd": {"ms": graph_ms(cycling(FL.loss_sums_grad, [c + (gin,) for c in copies])),
                   "plain_ms": graph_ms(cycling(FL.loss_sums_grad_plain,
                                                [c + (gin,) for c in copies])),
                   "bound_ms": bb, "bound_by": bby}}
    log(f"{label} fused loss on a shard {tuple(shape)} {row['dtype']}: sums rel err {rel:.3e} "
        f"(tol 1e-4), grad max abs err {gerr:.3e} (tol {glim:.3e}); forward "
        f"{row['fwd']['ms']:.4f} ms (plain {row['fwd']['plain_ms']:.4f}, bound {fb:.4f}), "
        f"backward {row['bwd']['ms']:.4f} ms (plain {row['bwd']['plain_ms']:.4f}, bound "
        f"{bb:.4f})")
    if not (rel <= 1e-4 and gerr <= glim):
        fail(f"{label}: the fused loss on the shard {shape} disagrees with the plain version")
    return row


def upsample_shard_row(dev, c: int, sp, ndim: int, dt, k: int, g, label: str) -> dict:
    """``upsample_bwd`` at one shard's input ``sp`` (its halo planes
    included) of ``c`` channels, bit-equal to the plain version, timed
    beside it, the atomic library backward and its bound; ``k`` launches
    an iteration."""
    from deep_prior_interpolation_tpu_torch.ops import upsample as U

    go = torch.randn((1, c, *[2 * v for v in sp]), generator=g, device=dev).to(dt)
    got = U.upsample_bwd(go, ndim)
    equal = torch.equal(got, U.upsample_bwd_plain(go, ndim))
    kernel = U.plan(c, *(sp if ndim == 3 else (1, *sp)), ndim == 3, go.element_size()).kernel
    size = [1, c, *sp]
    if ndim == 3:
        lib = lambda: torch.ops.aten.upsample_trilinear3d_backward(  # noqa: E731
            go, list(go.shape[2:]), size, False, 2.0, 2.0, 2.0)
    else:
        lib = lambda: torch.ops.aten.upsample_bilinear2d_backward(  # noqa: E731
            go, list(go.shape[2:]), size, False, 2.0, 2.0)
    n_in = c * math.prod(sp)
    b_ms, b_by = bound_ms((1 + 2 ** ndim) * n_in * go.element_size(),
                          (49.0 if ndim == 3 else 21.0) * n_in, torch.float32)
    row = {"ndim": ndim, "channels": c, "input": list(sp), "dtype": str(dt)[6:],
           "kernel": kernel, "bit_equal_to_plain": equal, "launches_per_iteration": k,
           "ms": time_ms(lambda: U.upsample_bwd(go, ndim)),
           "plain_ms": time_ms(lambda: U.upsample_bwd_plain(go, ndim)),
           "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by}
    log(f"{label} upsample_bwd {c} x {tuple(sp)} {row['dtype']} ({kernel}): bit-equal to the "
        f"plain version {equal}; ms {row['ms']:.4f} bound {b_ms:.4f} plain "
        f"{row['plain_ms']:.4f} atomic {row['library_ms']:.4f}")
    if not equal:
        fail(f"{label}: upsample_bwd at {c} x {sp} is not bit-equal to the plain version")
    return row


def zoo_kernels(dev, p13: dict, phase10: dict, phase12: dict) -> dict:
    """13e: each kernel at the zoo's shard shapes that no earlier phase
    held against its plain version: wgrad at every shard shape 13a and 13b
    saw and 10c / 12d did not (bf16 for skip and unet, float32 for part's
    decoder), timed beside its bound, the plain version and
    ``conv3d_weight`` of the shard conv; ``upsample_bwd`` at every shard
    shape of 13a and 13c, bit-equal
    to the plain version, timed beside it and the atomic backward; the
    fused loss on part's float32 shard outputs and on 13c's 2D shards."""
    g = torch.Generator(device=dev).manual_seed(13)
    done = {(r["ci"], r["co"], tuple(r["x_shape"]))
            for r in phase10["10c_kernels"]["wgrad"] + phase12["12d_kernels"]["wgrad"]}
    rows, seen = [], set()
    for net, dtype, _ in ZOO_3D:
        for n in SPATIAL_SHARDS:
            per_iter = 0.0
            for ci, co, xs, k in p13["13ab"][f"{net}_{n}"]["wgrad_shapes"]:
                key = (ci, co, tuple(xs))
                if key in done or key in seen:
                    continue
                seen.add(key)
                sp = (xs[0], (xs[1] - 2) * n, xs[2])
                row = spatial_wgrad_row(dev, ci, co, sp, xs[1] - 2, n, k // n, g, True, "13e",
                                        getattr(torch, dtype))
                row["net"] = net
                rows.append(row)
                per_iter += row["ms"] * k
            log(f"13e --net {net} {n} shards: wgrad ms/iteration over its new shard shapes "
                f"{per_iter:.4f}")
    ups, seen = [], set()
    for ndim in (3, 2):
        runs = ([p13["13ab"][f"{net}_{n}"] for net, _, u in ZOO_3D if u
                 for n in SPATIAL_SHARDS] if ndim == 3 else [p13["13c"]])
        for r in runs:
            for c, sp, k in r["upsample_shapes"]:
                if (c, tuple(sp)) in seen:   # the U-Net's shapes are the skip net's
                    continue
                seen.add((c, tuple(sp)))
                dt = torch.bfloat16 if ndim == 3 else torch.float32
                ups.append(upsample_shard_row(dev, c, sp, ndim, dt, k, g, "13e"))
    fused = [fused_shard_row(dev, (1, 1, 256, 128 // n, 128), torch.float32, g, "13e", n)
             for n in SPATIAL_SHARDS]
    fused += [fused_shard_row(dev, (1, 1, 170, w), torch.float32, g, "13e", ZOO_2D_SHARDS)
              for w in (58, 42)]
    return {"wgrad": rows, "upsample": ups, "fused": fused}


# ----------------------------------------------------------------------
# phase 14: convergence against the JAX repository's goldens
# ----------------------------------------------------------------------

# what was predicted before the first card run of phase 14 (PERF.md)
PREDICTED_14 = {
    "14a": "best SNR 12-20 dB mean, accepted; 0.06-0.12 s/iteration",
    "14b": "best SNR 29.9-31.8 dB mean, accepted; 0.05-0.15 s a 5-lane iteration",
    "14c": "best SNR 5.0-5.5 dB mean, accepted; 0.06-0.2 s a 5-lane iteration",
    "14d": "0.14-0.22 s/iteration, iteration 0 within 1e-3 of phase 4's",
}
# phase_levels=3: resolution 2 joins the phase-resident ones (7a's are 0-1)
PHASE14 = dict(phase_space=True, phase_levels=3, phase_deep_levels=0)


def golden_module():
    """``scripts/torch_golden.py``: the goldens' workloads, runs and rule."""
    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import torch_golden
    return torch_golden


def golden_check(label: str, name: str, runner: str, dev, expect) -> dict:
    """One golden through ``scripts/torch_golden.py``'s runs with both kernel
    switches on, the launch counters set to 0 just before and read just
    after (``expect(counts, admitted)`` returns what is wrong, or None);
    fails unless the rule accepts the port against the JAX column the golden
    is judged by (``torch_golden.verdicts``) and every loss is finite.
    Prints the sub-phase's JSON line."""
    G = golden_module()
    golden = G.GOLDENS[name]
    with conv_spy() as spy:
        run = G.solve(golden.workload, golden.iters, golden.seeds, True, runner, dev)
    rec = G.summarise(name, golden, run)
    G.log_record(rec)
    losses = [v for r in run["per_seed"] for v in r["loss"]]
    wrong = expect(rec["launches"], spy.admitted)
    row = {"golden": name, "runner": runner, "iters": golden.iters, "seeds": golden.seeds,
           "port": rec["best_snr"], "jax": rec.get("jax"), "jax_f32": rec.get("jax_f32"),
           "reference": rec.get("reference"), "accept": rec.get("accept"),
           "judged_against": rec.get("judged_against"), "launches": rec["launches"],
           "admitted_convs_per_iteration": spy.admitted / (golden.iters * golden.seeds),
           "s_per_iter": rec["s_per_iter"], "peak_memory_bytes": rec["peak_memory_bytes"],
           "min_loss": rec["min_loss"], "snr_out_best": rec["snr_out_best"],
           "predicted": PREDICTED_14[label]}
    log(json.dumps({f"phase{label}": row}))
    log(f"{label}: predicted {PREDICTED_14[label]}")
    if not (len(losses) == golden.iters * golden.seeds and np.all(np.isfinite(losses))):
        fail(f"{label}: the losses are not {golden.iters} x {golden.seeds} finite values")
    if wrong:
        fail(f"{label}: launches {rec['launches']}: {wrong}")
    if not rec.get("accept"):
        judged = rec.get("judged_against")
        fail(f"{label}: the rule refuses the port's best SNR {rec['best_snr']['mean']:.3f} +- "
             f"{rec['best_snr']['std']:.3f} dB against the JAX package's column {judged}: "
             f"{rec.get(judged)}")
    return row


def _one_lane(n: int, ups: int):
    """Launches of ``n`` one-lane iterations: fused loss n / n, wgrad the
    admitted convs, ``upsample_bwd`` ``ups`` an iteration, no lane kernel."""
    def expect(c: dict, admitted: int):
        want = {"fused_loss": n, "fused_loss_grad": n, "wgrad3d": admitted,
                "upsample_bwd": ups * n, "fused_loss_lanes": 0, "fused_loss_grad_lanes": 0,
                "wgrad3d_lanes": 0}
        if c != want or admitted == 0:
            return f"expected {want} with a non-zero wgrad count"
        return None
    return expect


def _lanes_2d(n: int):
    """Launches of ``n`` lane iterations of a 2D net with nearest upsampling:
    fused loss n / n on the lane kernels, nothing else."""
    def expect(c: dict, admitted: int):
        want = {"fused_loss": 0, "fused_loss_grad": 0, "wgrad3d": 0, "upsample_bwd": 0,
                "fused_loss_lanes": n, "fused_loss_grad_lanes": n, "wgrad3d_lanes": 0}
        return None if c == want else f"expected {want}"
    return expect


def convergence_g3d(dev) -> dict:
    """14a: g3d, 8 problems x 150 iterations through ``DIPSolver.solve``,
    one lane; the 32^3 net's 4 linear upsamples an iteration."""
    return golden_check("14a", "g3d_150", "solve", dev, _one_lane(8 * 150, 4))


def convergence_25d(dev) -> dict:
    """14b: g25d, 5 seeds x 300 iterations as 5 lanes (the 2.5D mode's slab
    as 8 channels of a 2D net)."""
    return golden_check("14b", "g25d", "lanes", dev, _lanes_2d(300))


def convergence_pocs(dev) -> dict:
    """14c: gpocs (stop-grad eps), 5 seeds x 300 iterations as 5 lanes; the
    step's ``fk_projection`` is counted: once an iteration for all lanes."""
    from deep_prior_interpolation_tpu_torch.engine import solver as S
    calls, real = [0], S.fk_projection

    def spy(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    S.fk_projection = spy
    try:
        row = golden_check("14c", "gpocs", "lanes", dev, _lanes_2d(300))
    finally:
        S.fk_projection = real
    row["fk_projection_calls"] = calls[0]
    log(f"14c: the step's fk_projection ran {calls[0]} times (expected 300: one an "
        f"iteration for all lanes)")
    if calls[0] != 300:
        fail(f"14c: fk_projection ran {calls[0]} times in 300 iterations")
    return row


def convergence_flagship(dev, main: dict, wgrad: dict) -> dict:
    """14d: the flagship with ``phase_levels=3`` (quality_3d.py's net),
    9 iterations in chunks of 3, traced as 7a; every wgrad shape that
    phase 2 and 7d did not check held against its plain version and timed;
    iteration 0 against phase 4's (same parameters and canvas)."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem

    img, mask = flagship_problem(256, 128, 128)
    cfg = flagship_config(**PHASE14)
    set_kernels(True)
    solver = DIPSolver(cfg, outchannel=1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with conv_spy() as spy:
        res, counts, seen, seen_up = traced_solve(solver, img, mask)
    kinds = read_upsample_kernels()
    peak = torch.cuda.max_memory_allocated()
    loss = np.asarray(res.history.loss)
    want = {"fused_loss": 9, "fused_loss_grad": 9, "wgrad3d": spy.admitted,
            "upsample_bwd": sum(seen_up.values())}
    log(f"14d phase flagship (levels 3): losses {loss.tolist()}\n  launches {counts} "
        f"(expected {want}: {spy.admitted // 9} admitted convs and "
        f"{sum(seen_up.values()) // 9} plain upsamples an iteration), upsample kernels {kinds}")
    if not (len(loss) == 9 and np.all(np.isfinite(loss))):
        fail("14d: the loss is not finite for 9 iterations")
    if res.out_best.shape != img.shape or not np.all(np.isfinite(res.out_best)):
        fail(f"14d: out_best has shape {res.out_best.shape} or is not finite")
    if counts != want or spy.admitted == 0 or sum(seen.values()) != spy.admitted:
        fail(f"14d: launches {counts}, expected {want} (the wgrad hook saw "
             f"{sum(seen.values())})")
    steady = statistics.median(res.chunk_seconds[1:]) / cfg.scan_chunk
    rel = abs(float(loss[0]) - main["loss0"]) / abs(main["loss0"])
    log(f"14d: steady s/iteration {steady:.4f} (phase 4 {main['s_per_iter']:.4f}), peak "
        f"{peak / 2**30:.2f} GiB; iteration-0 loss {float(loss[0]):.7g} against phase 4's "
        f"{main['loss0']:.7g}, rel err {rel:.3e} (tol {LOSS0_TOL_BF16:g}); predicted "
        f"{PREDICTED_14['14d']}")
    if not rel <= LOSS0_TOL_BF16:
        fail("14d: the iteration-0 loss differs from phase 4's")
    del solver, res
    torch.cuda.empty_cache()
    known = {(r["ci"], r["co"], tuple(r["spatial"])): r["ms"]
             for r in wgrad["shapes"] + wgrad.get("phase_shapes", [])
             if r["dtype"] == "bfloat16"}
    g = torch.Generator(device=dev).manual_seed(14)
    rows = [wgrad_row(dev, ci, co, sp, torch.bfloat16, n // 9, g, True)
            for (ci, co, sp), n in sorted(seen.items(), key=lambda kv: -math.prod(kv[0][2]))
            if (ci, co, sp) not in known]
    per_iter = sum(r["ms"] * r["launches_per_iteration"] for r in rows) + sum(
        known[k] * n / 9 for k, n in seen.items() if k in known)
    log(f"14d: {len(seen)} wgrad shapes, {len(rows)} new; wgrad ms/iteration {per_iter:.4f} "
        f"(7d's levels-2 path {wgrad.get('phase_ms_per_iteration', float('nan')):.4f})")
    row = {"launches": counts, "upsample_kernels": kinds, "losses": loss.tolist(),
           "s_per_iter": steady, "peak_bytes": peak, "loss0_rel_err": rel,
           "phase4_s_per_iter": main["s_per_iter"], "wgrad_shapes": len(seen),
           "new_wgrad_shapes": rows, "wgrad_ms_per_iteration": per_iter,
           "upsample_shapes": [[c, list(sp), n // 9] for (c, sp), n in seen_up.items()],
           "predicted": PREDICTED_14["14d"]}
    log(json.dumps({"phase14d": {k: v for k, v in row.items() if k != "new_wgrad_shapes"}}))
    wgrad["convergence_shapes"] = rows
    wgrad["max_abs_err"] = max([wgrad["max_abs_err"]] + [r["max_abs_err"] for r in rows])
    return row


# ----------------------------------------------------------------------
# phase 15: the zoo's remaining constructor options over spatial shards
# ----------------------------------------------------------------------

# what was predicted before the first card run of phase 15 (PERF.md)
PREDICTED_15 = ("15a s/iteration at N = 1 / 2 / 4: skip (reflection, Lanczos) 0.05-0.09 / "
                "0.10-0.20 / 0.18-0.35, unet deconv + more_layers (float32) 0.10-0.25 / "
                "0.15-0.40 / 0.20-0.55, unet concat_x 0.035-0.07 / 0.06-0.12 / 0.09-0.20; "
                "15b lines cbam 0.02-0.08 / 0.04-0.15, ensemble 0.02-0.06 / 0.04-0.12; "
                "iteration-0 losses within 1e-4 (bf16) and 1e-6 (float32)")
# 15a: the 3D nets at the flagship volume, widths and flags: (label, the
# net's input channels, its dtype, its linear upsamples an iteration)
ZOO15_3D = (("skip_reflect_lanczos", 64, "bfloat16", 5),
            ("unet_deconv_more_layers", 64, "float32", 0),
            ("unet_concat_x", 8, "bfloat16", 4))
# 15b: the 2D nets on the lines gather padded to 32: (label, linear upsamples)
ZOO15_2D = (("cbam_unet", 4), ("ensemble", 0))
# iteration-0 loss of a sharded solve against the unsharded one's, by dtype;
# the CBAM U-Net's float32 forward amplifies a one-ulp change of its canvas
# to 2.2e-4 of its output's max (its gates' Norms of near-constant maps;
# measured on the CPU), and its sharded lines loss parted by 1.7e-5 there
LOSS0_TOL_15 = {"bfloat16": LOSS0_TOL_BF16, "float32": LOSS0_TOL_13}
LOSS0_TOL_15_CBAM = 1e-4


def zoo15_net(label: str, inputdepth: int):
    """A phase-15 net, given to the solver as ``model=``: 15a's at the
    flagship's filters (skip widths as ``get_net`` pads them), 15b's at the
    library's own widths."""
    from deep_prior_interpolation_tpu_torch.models import (AttentionUnet, Ensemble, SkipNet,
                                                          UNet)
    f, s = FLAGSHIP["filters"], FLAGSHIP["skip"]
    if label == "skip_reflect_lanczos":
        return SkipNet(inputdepth, 1, 3, f, s, pad="reflection", upsample_mode="linear",
                       downsample_mode=["lanczos2", "lanczos3", "lanczos2", "lanczos3",
                                        "lanczos2"])
    if label == "unet_deconv_more_layers":
        return UNet(inputdepth, 1, 3, f, more_layers=1, upsample_mode="deconv")
    if label == "unet_concat_x":
        return UNet(inputdepth, 1, 3, f, concat_x=True, upsample_mode="linear")
    if label == "cbam_unet":
        return AttentionUnet(inputdepth, 1, att="cbam")
    if label == "ensemble":
        return Ensemble(inputdepth, 1, num_frames=1, hidden=512)
    raise ValueError(label)


def zoo15_solve(dev, label: str, cfg, inputdepth: int, img, mask, mesh=None,
                make=None, tag: str = "15") -> dict:
    """One phase-15 net (or the module ``make()`` returns) through
    ``DIPSolver(model=...).solve``, unsharded or over ``mesh`` along axis
    1, traced: launches, wgrad and upsample shapes, losses (and POCS
    terms), steady s/iteration (median of chunks 2..), peak; fails on a
    non-finite loss or an ``out_best`` not of the image's shape."""
    from deep_prior_interpolation_tpu_torch import DIPSolver

    set_kernels(True)
    model = zoo15_net(label, inputdepth) if make is None else make()
    solver = DIPSolver(cfg, outchannel=img.shape[-1], device=dev, model=model)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kw = {} if mesh is None else {"spatial_mesh": mesh, "spatial_axis": SPATIAL_AXIS}
    res, counts, seen, seen_up = traced_solve(solver, img, mask, **kw)
    peak = torch.cuda.max_memory_allocated()
    kinds = read_upsample_kernels()
    loss = np.asarray(res.history.loss)
    steady = statistics.median(res.chunk_seconds[1:]) / cfg.scan_chunk
    n = 1 if mesh is None else len(mesh)
    log(f"{tag} {label} over {n} shard(s): losses {loss.tolist()}; launches {counts}, upsample "
        f"by kernel {kinds}; chunk seconds {res.chunk_seconds}, steady s/iteration "
        f"{steady:.4f}, peak {peak / 2**30:.2f} GiB")
    fields = ("loss", "df", "reg", "eps") if cfg.pocs else ("loss",)
    if not (len(loss) == cfg.epochs
            and all(np.all(np.isfinite(getattr(res.history, f))) for f in fields)):
        fail(f"{tag} {label} over {n} shard(s): the loss is not finite for {cfg.epochs} "
             f"iterations")
    if res.out_best.shape != img.shape or not np.all(np.isfinite(res.out_best)):
        fail(f"{tag} {label} over {n} shard(s): out_best has shape {res.out_best.shape} or is "
             f"not finite")
    del solver
    return {"shards": n, "launches": counts, "upsample_kernels": kinds,
            "losses": loss.tolist(), "s_per_iter": steady, "chunk_seconds": res.chunk_seconds,
            "peak_bytes": peak, "whole_ops": [list(o) for o in res.whole_ops],
            "wgrad_shapes": [[ci, co, list(sp), c // cfg.epochs]
                             for (ci, co, sp), c in sorted(seen.items())],
            "upsample_shapes": [[c, list(sp), k // cfg.epochs]
                                for (c, sp), k in sorted(seen_up.items())]}


def zoo15_sharded(dev, label: str, cfg, inputdepth: int, img, mask, ups: int,
                  shards, make=None, tag: str = "15", tol=None,
                  predicted: str = PREDICTED_15) -> dict:
    """A net (or the module ``make()`` returns) unsharded and over
    [dev] x N for each N of ``shards``: each sharded solve launches fused
    N x iterations (forward and backward), wgrad N x the unsharded solve's
    and ``upsample_bwd`` N x its linear upsamples an iteration; its
    iteration-0 loss within the precision's tolerance (or ``tol``) of the
    unsharded one's."""
    iters = cfg.epochs
    if tol is None:
        tol = LOSS0_TOL_15_CBAM if label == "cbam_unet" else LOSS0_TOL_15[cfg.dtype]
    ref = zoo15_solve(dev, label, cfg, inputdepth, img, mask, make=make, tag=tag)
    if ref["launches"]["upsample_bwd"] != ups * iters:
        fail(f"{tag} {label}: {ref['launches']['upsample_bwd']} upsample_bwd launches "
             f"unsharded, not {ups} an iteration")
    out = {"1": ref}
    for n in shards:
        r = zoo15_solve(dev, label, cfg, inputdepth, img, mask, [dev] * n, make, tag)
        want = {"fused_loss": n * iters, "fused_loss_grad": n * iters,
                "wgrad3d": n * ref["launches"]["wgrad3d"], "upsample_bwd": n * ups * iters}
        r["loss0_rel_err"] = _rel(r["losses"][0], ref["losses"][0])
        log(f"{tag} {label} over {n} shards: launches {r['launches']} (expected {want}); "
            f"iteration-0 loss {r['losses'][0]:.7g} against unsharded {ref['losses'][0]:.7g}, "
            f"rel err {r['loss0_rel_err']:.3e} (tol {tol:g}); s/iteration {r['s_per_iter']:.4f} "
            f"against {ref['s_per_iter']:.4f}, peak {r['peak_bytes'] / 2**30:.2f} against "
            f"{ref['peak_bytes'] / 2**30:.2f} GiB (predicted: {predicted})")
        if r["launches"] != want:
            fail(f"{tag} {label} over {n} shards: launch counts {r['launches']}, not {want}")
        if not r["loss0_rel_err"] <= tol:
            fail(f"{tag} {label} over {n} shards: the iteration-0 loss differs from the "
                 f"unsharded solve's by more than {tol:g}")
        out[str(n)] = r
        torch.cuda.empty_cache()
    return out


def zoo15_3d(dev) -> dict:
    """15a: ``ZOO15_3D`` at the flagship volume, unsharded and over
    [cuda:0] x 2 and x 4 along H, 4 iterations in chunks of 2; the deconv
    U-Net in float32 (TF32 off), as its ``ConvTranspose`` computes in
    float32 and both packages refuse a bfloat16 carry that turns float32;
    the U-Net's wgrad launches at least one a shard an admitted conv."""
    from deep_prior_interpolation_tpu_torch.data import flagship_problem

    img, mask = flagship_problem(256, 128, 128)
    out = {}
    for label, depth, dtype, ups in ZOO15_3D:
        cfg = flagship_config(inputdepth=depth, dtype=dtype, epochs=4, scan_chunk=2)
        out[label] = zoo15_sharded(dev, label, cfg, depth, img, mask, ups, SPATIAL_SHARDS)
        if label.startswith("unet") and out[label]["1"]["launches"]["wgrad3d"] == 0:
            fail(f"15a {label}: no conv reached the wgrad kernel")
    return out


def zoo15_lines(dev) -> dict:
    """15b: the lines command's patch (its flags, POCS on the step) padded
    with ``--pad_multiple 32``, ``ZOO15_2D`` unsharded and over
    [cuda:0] x 2 along axis 1 (4 blocks of 32 planes), 9 iterations in
    chunks of 3."""
    from deep_prior_interpolation_tpu_torch.data import extract_patches

    cfg = lines_config("unused", "--pad_multiple", "32", "--scan_chunk", "3")
    patch = extract_patches(cfg)[0]
    return {label: zoo15_sharded(dev, label, cfg, cfg.inputdepth, patch["image"],
                                 patch["mask"], ups, (ZOO_2D_SHARDS,))
            for label, ups in ZOO15_2D}


def zoo15_exactness(dev) -> dict:
    """15c: 15a's ``concat_x`` U-Net (bf16, all three kernels) over 2
    shards, 3 iterations twice with deterministic cuDNN (the wgrad grids
    15a tuned): history and ``out_best`` bit-equal."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem

    img, mask = flagship_problem(256, 128, 128)
    cfg = flagship_config(inputdepth=8, epochs=3, scan_chunk=3)
    set_kernels(True)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = [DIPSolver(cfg, device=dev, model=zoo15_net("unet_concat_x", 8)).solve(
            img, mask, seed=0, spatial_mesh=[dev] * 2, spatial_axis=SPATIAL_AXIS)
            for _ in range(2)]
    finally:
        torch.backends.cudnn.deterministic = det
    same = (np.array_equal(runs[0].history.loss, runs[1].history.loss)
            and np.array_equal(runs[0].out_best, runs[1].out_best))
    log(f"15c: unet concat_x over 2 shards, losses {list(runs[0].history.loss)}; two solves "
        f"bit-equal {same}")
    if not same:
        fail("15c: two sharded concat_x U-Net solves from one seed are not bit-equal")
    return {"two_runs_bit_equal": same, "losses": list(runs[0].history.loss)}


def zoo15_kernels(dev, p15: dict, done_wgrad: set, done_upsample: set) -> dict:
    """15d: each kernel at phase 15's shard shapes that no earlier phase
    held against its plain version: wgrad at every shard shape of 15a not
    in ``done_wgrad`` ((Ci, Co, x's shape, dtype): bf16 and the deconv
    U-Net's float32), timed beside its bound, the plain version and
    ``conv3d_weight`` of the shard conv; ``upsample_bwd`` at every shard
    shape of 15a (trilinear) and 15b (the CBAM U-Net's bilinear) not in
    ``done_upsample`` ((C, input, dtype)), bit-equal, beside the plain
    version and the atomic backward; the fused loss on 15b's 2D float32
    shard outputs."""
    g = torch.Generator(device=dev).manual_seed(15)
    rows, seen = [], set(done_wgrad)
    for label, _, dtype, _ in ZOO15_3D:
        for n in SPATIAL_SHARDS:
            per_iter = 0.0
            for ci, co, xs, k in p15["15a"][label][str(n)]["wgrad_shapes"]:
                key = (ci, co, tuple(xs), dtype)
                if key in seen:
                    continue
                seen.add(key)
                sp = (xs[0], (xs[1] - 2) * n, xs[2])
                row = spatial_wgrad_row(dev, ci, co, sp, xs[1] - 2, n, k // n, g, True, "15d",
                                        getattr(torch, dtype))
                row["net"] = label
                rows.append(row)
                per_iter += row["ms"] * k
            log(f"15d {label} {n} shards: wgrad ms/iteration over its new shard shapes "
                f"{per_iter:.4f}")
    ups, seen = [], set(done_upsample)
    runs = [(3, p15["15a"][label][str(n)]) for label, _, _, u in ZOO15_3D if u
            for n in SPATIAL_SHARDS]
    runs += [(2, p15["15b"][label][str(ZOO_2D_SHARDS)]) for label, u in ZOO15_2D if u]
    for ndim, r in runs:
        for c, sp, k in r["upsample_shapes"]:
            dt = torch.bfloat16 if ndim == 3 else torch.float32
            if (c, tuple(sp), str(dt)[6:]) in seen:
                continue
            seen.add((c, tuple(sp), str(dt)[6:]))
            ups.append(upsample_shard_row(dev, c, sp, ndim, dt, k, g, "15d"))
    fused = [fused_shard_row(dev, (1, 1, 170, 50), torch.float32, g, "15d", ZOO_2D_SHARDS)]
    return {"wgrad": rows, "upsample": ups, "fused": fused}


# ----------------------------------------------------------------------
# phase 16: a module of the caller's own over spatial shards
# ----------------------------------------------------------------------

# what was predicted before the first card run of phase 16 (PERF.md)
PREDICTED_16 = ("16a s/iteration at N = 1 / 2 / 4: 0.14-0.20 / 0.25-0.40 / 0.40-0.65, peak "
                "13.6-14.5 / 15.4-16.5 / 15.4-16.5 GiB; iteration-0 losses within 3e-5 of the "
                "unsharded one's; 16d: no new wgrad shape, the glue's upsample at 3 new shapes, "
                "50-80 % of its bound")
# the linear upsamples of an iteration: the body's 4, the glue's 1
CALLER16_UPS = 5
LOSS0_TOL_16 = 1e-4


class Halve(torch.autograd.Function):
    """A custom autograd Function of 18a's glue: half its input, its own
    backward half the cotangent."""

    @staticmethod
    def forward(ctx, x):
        return 0.5 * x

    @staticmethod
    def backward(ctx, g):
        return 0.5 * g


def caller16(refused: bool = False, routes: bool = False):
    """``Caller3D``, a module of the caller's own at the flagship's volume
    and widths, made from seed 0: the flagship MulResUnet as its child
    ``body``, and glue in the canvas's dtype: a 3 x 3 x 3 ``nn.Conv3d``
    (64 -> 8), a spatial mean into an ``nn.Linear`` gate, a 2 x 2 x 2
    average pool, the port's trilinear x2 ``upsample``, a 1 x 1 x 1
    ``nn.Conv3d`` head in float32 and a scalar ``scale``. With ``refused``
    the glue reads its map's mean with ``.item()``, a host read. With
    ``routes`` (``Caller18``) the pooled map also takes each of the
    walker's other routes along H before the upsample: a roll by 3 planes
    plus its flip, a slice re-padded circularly, a ``'valid'`` 3 x 3 x 3
    conv (8 -> 8, made after the other layers) re-padded by zeros, an
    ``rfft``/``irfft`` low-pass in float32, ``Halve``, a scale by
    ``1 / (1 + max |h|)`` taken under ``torch.no_grad()``, and
    ``randn_like`` noise."""
    import torch.nn.functional as F
    from torch import nn

    from deep_prior_interpolation_tpu_torch.models import get_net
    from deep_prior_interpolation_tpu_torch.models.blocks import upsample

    class Caller3D(nn.Module):
        def __init__(self):
            super().__init__()
            self.body = get_net(flagship_config(), 1)
            self.pre = nn.Conv3d(64, 8, 3, padding=1)
            self.gate = nn.Linear(8, 8)
            self.head = nn.Conv3d(8, 1, 1)
            self.scale = nn.Parameter(torch.tensor(0.1))
            if routes:
                self.mid = nn.Conv3d(8, 8, 3)

        def forward(self, x):
            dt = x.dtype
            h = F.conv3d(x, self.pre.weight.to(dt), self.pre.bias.to(dt), padding=1)
            h = F.leaky_relu(h, 0.2)
            if refused:
                h = h * h.mean().item()
            g = torch.sigmoid(self.gate(h.mean(dim=(2, 3, 4)).float()))
            h = F.avg_pool3d(h * g.to(dt)[:, :, None, None, None], 2)
            if routes:
                h = torch.roll(h, 3, dims=3) + h.flip(3)
                h = F.pad(h[..., 1:-1, :], (0, 0, 1, 1, 0, 0), mode="circular")
                h = F.pad(F.conv3d(h, self.mid.weight.to(dt), self.mid.bias.to(dt)),
                          (1, 1, 1, 1, 1, 1))
                spec = torch.fft.rfft(h.float(), dim=3)
                keep = (torch.arange(spec.shape[3], device=h.device) < CALLER18_KEEP).float()
                h = torch.fft.irfft(spec * keep[:, None], n=h.shape[3], dim=3).to(dt)
                h = Halve.apply(h)
                with torch.no_grad():
                    top = h.float().abs().amax()
                h = h / (1.0 + top).to(dt) + 0.01 * torch.randn_like(h)
            h = upsample(h, 2, "trilinear")
            return self.body(x) + (self.scale * self.head(h.float())).to(dt)

    torch.manual_seed(0)
    return Caller3D()


def custom16(dev) -> dict:
    """16a: ``Caller3D`` through ``DIPSolver(model=...)`` at the flagship
    volume and flags, unsharded and over [cuda:0] x 2 and x 4 along H, 6
    iterations in chunks of 3: launches N x the unsharded solve's, the
    iteration-0 loss within 1e-4 of the unsharded solve's."""
    from deep_prior_interpolation_tpu_torch.data import flagship_problem

    img, mask = flagship_problem(256, 128, 128)
    cfg = flagship_config(epochs=6, scan_chunk=3)
    return zoo15_sharded(dev, "caller3d", cfg, 64, img, mask, CALLER16_UPS, SPATIAL_SHARDS,
                         make=caller16, tag="16a", tol=LOSS0_TOL_16, predicted=PREDICTED_16)


def custom16_exactness(dev) -> dict:
    """16b: ``Caller3D`` over 2 shards, two 3-iteration solves with
    deterministic cuDNN (the wgrad grids 16a tuned): history and
    ``out_best`` bit-equal."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem

    img, mask = flagship_problem(256, 128, 128)
    cfg = flagship_config(epochs=3, scan_chunk=3)
    set_kernels(True)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = [DIPSolver(cfg, device=dev, model=caller16()).solve(
            img, mask, seed=0, spatial_mesh=[dev] * 2, spatial_axis=SPATIAL_AXIS)
            for _ in range(2)]
    finally:
        torch.backends.cudnn.deterministic = det
    same = (np.array_equal(runs[0].history.loss, runs[1].history.loss)
            and np.array_equal(runs[0].out_best, runs[1].out_best))
    log(f"16b: Caller3D over 2 shards, losses {list(runs[0].history.loss)}; two solves "
        f"bit-equal {same}")
    if not same:
        fail("16b: two sharded Caller3D solves from one seed are not bit-equal")
    return {"two_runs_bit_equal": same, "losses": list(runs[0].history.loss)}


def custom16_refused(dev) -> dict:
    """16c: ``Caller3D`` reading its map's mean with ``.item()``, walked
    over 2 shards of the flagship canvas on the card (``ShardedStep`` on
    the canvas's shards; a solve meets it earlier, in its unsharded meta
    forward, as the unsharded solve does): ``NotImplementedError`` naming
    the op and ROADMAP D.4, with every launch counter still 0."""
    from deep_prior_interpolation_tpu_torch.parallel import spatial as S

    model = caller16(refused=True).to(dev)
    layout = S.SpatialLayout([dev] * 2, SPATIAL_AXIS, (256, 128, 128), (256, 128, 128), 16)
    g = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn((1, 64, 256, 128, 128), generator=g, device=dev, dtype=torch.bfloat16)
    set_kernels(True)
    reset_counts()
    try:
        S.ShardedStep(model, layout)(layout.split(x))
    except NotImplementedError as e:
        message = str(e)
    else:
        fail("16c: a Caller3D that reads .item() of a shard list ran over 2 shards")
    counts = read_counts()
    log(f"16c: refused with {message!r}; launches {counts}")
    if any(counts.values()) or not ("Tensor.item" in message and "ROADMAP D.4" in message):
        fail(f"16c: the refusal {message!r} does not name the op and D.4, or kernels "
             f"launched first ({counts})")
    return {"message": message, "launches": counts}


def custom16_kernels(dev, p16: dict, done_wgrad: set, done_upsample: set) -> dict:
    """16d: each kernel at phase 16's shapes that no earlier phase held
    against its plain version, as 15d: wgrad at any shard shape of 16a not
    in ``done_wgrad`` (the body's are 10a's), ``upsample_bwd`` at 16a's
    upsample shapes not in ``done_upsample`` (the glue's, unsharded and
    sharded); the fused loss's shard shapes are 10a's."""
    g = torch.Generator(device=dev).manual_seed(16)
    rows, seen = [], set(done_wgrad)
    for n in SPATIAL_SHARDS:
        for ci, co, xs, k in p16["16a"][str(n)]["wgrad_shapes"]:
            if (ci, co, tuple(xs), "bfloat16") in seen:
                continue
            seen.add((ci, co, tuple(xs), "bfloat16"))
            sp = (xs[0], (xs[1] - 2) * n, xs[2])
            rows.append(spatial_wgrad_row(dev, ci, co, sp, xs[1] - 2, n, k // n, g, True,
                                          "16d", torch.bfloat16))
    ups, seen = [], set(done_upsample)
    for n in ("1",) + tuple(str(n) for n in SPATIAL_SHARDS):
        for c, sp, k in p16["16a"][n]["upsample_shapes"]:
            if (c, tuple(sp), "bfloat16") in seen:
                continue
            seen.add((c, tuple(sp), "bfloat16"))
            ups.append(upsample_shard_row(dev, c, sp, 3, torch.bfloat16, k, g, "16d"))
    log(f"16d: {len(rows)} new wgrad shapes, {len(ups)} new upsample shapes")
    return {"wgrad": rows, "upsample": ups}


# ----------------------------------------------------------------------
# phase 17: a mesh of the devices there are, and spatial shards that do
# not lie on the net's blocks
# ----------------------------------------------------------------------

# what was predicted before the first card run of phase 17 (PERF.md)
PREDICTED_17 = ("17b s/iteration 0.9-1.6 over 10 shards (host-bound), peak 16-22 GiB; 17c "
                "skip net s/iteration 0.05-0.09 / 0.12-0.25 / 0.20-0.45 at N = 1 / 2 / 4, peak "
                "within 2 GiB of the unsharded one's; iteration-0 losses within 3e-5 of the "
                "unsharded ones; phase 17 under 90 s")
# 17b: the flagship's 128 planes along H (8 of its 16-plane blocks) over 10
# shards of the card: 16 and 8 planes, 1 or none at its deepest level
UNEVEN_SHARDS = 10
# 17c: the skip net (32-plane blocks) on 112 planes along H, 3.5 blocks
SKIP17_VOLUME = (256, 112, 128)
SKIP17_SHARDS = (2, 4)
SKIP17_UPS = 5
LOSS0_TOL_17 = 1e-4


def level_bounds(bounds, levels: int) -> list:
    """The shard bounds along the sharded axis at each of ``levels`` + 1
    levels of a net whose stride-2 steps give each shard the output planes
    whose first input plane it holds (``parallel.spatial.owned``), each
    level's extent the last one's halved and rounded up."""
    from deep_prior_interpolation_tpu_torch.parallel.spatial import owned
    out = [list(bounds)]
    for _ in range(levels):
        n = out[-1][-1][1]
        out.append(owned(out[-1], 2, -(-n // 2)))
    return out


def uneven_expect(wgrad_calls, up_calls, levels, onto_skip: bool) -> tuple:
    """The wgrad and upsample shapes of one iteration over the shards of
    ``levels`` (``level_bounds``), from the unsharded ones (``wgrad_calls``:
    (Ci, Co, the level's spatial, launches); ``up_calls``: (C, the input's
    spatial, launches)): a conv once on each shard that holds planes at its
    level, x its planes and a halo plane on each side; an upsample once on
    each shard whose output holds planes, its input the planes that output
    reads and one more on each side, the output on the bounds of the level
    above (``onto_skip``: the MulResUnet's) or on its input's doubled."""
    ext = [lv[-1][1] for lv in levels]
    wg, up = collections.Counter(), collections.Counter()
    for ci, co, sp, k in wgrad_calls:
        for a, b in levels[ext.index(sp[1])]:
            if b > a:
                wg[(ci, co, (sp[0], b - a + 2, sp[2]))] += k
    for c, sp, k in up_calls:
        lv = ext.index(sp[1])
        if onto_skip:
            for lo, hi in levels[lv - 1]:
                if hi > lo:
                    up[(c, (sp[0], -(-hi // 2) - lo // 2 + 2, sp[2]))] += k
        else:
            for a, b in levels[lv]:
                if b > a:
                    up[(c, (sp[0], b - a + 2, sp[2]))] += k
    return wg, up


def _shapes_list(counter, iters: int) -> list:
    return [[*key[:-1], list(key[-1]), k // iters] for key, k in sorted(counter.items())]


def cli17(dev, tmp: str, zoo_2d: dict) -> dict:
    """17a: ``make_spatial_mesh`` past the cards that exist (the cards
    there are, and a warning), then the README's lines command through
    ``cli.run`` with ``--spatial_shards 2 --net part`` (one shard a card
    that exists: on one card a one-device mesh) against 6f's unsharded
    ``--net part`` run, and with ``--batch_patches 2 --mesh_shape 2`` (the
    lanes on the cards that exist) against the same command without
    ``--mesh_shape``: each writes its bundle, launches the fused loss on
    every shard or lane, and holds its iteration-0 loss to rel 1e-5
    (float32 sums in another order)."""
    import warnings

    from deep_prior_interpolation_tpu_torch import cli
    from deep_prior_interpolation_tpu_torch.io import load_run
    from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh

    cards = torch.cuda.device_count()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mesh = make_spatial_mesh(cards + 1)
    said = [str(w.message) for w in caught]
    log(f"17a: make_spatial_mesh({cards + 1}) on {cards} card(s): {mesh}; warnings {said}")
    if mesh != [torch.device("cuda", i) for i in range(cards)] or not any(
            f"{cards + 1} devices asked for, {cards} exist" in s for s in said):
        fail(f"17a: make_spatial_mesh({cards + 1}) gave {mesh} and warned {said}")
    set_kernels(True)
    out = {"mesh": [str(d) for d in mesh], "warnings": said}
    runs = (("spatial_part", ("--net", "part", "--spatial_shards", "2"), None, min(2, cards)),
            ("batch_mesh", ("--batch_patches", "2", "--mesh_shape", "2"),
             ("--batch_patches", "2"), 1))
    for label, flags, ref_flags, shards in runs:
        if ref_flags is None:
            ref = [float(v) for v in zoo_2d["part"]["loss"]]
        else:
            r = cli.run(lines_config(f"17a_{label}_ref", *ref_flags), results_root=tmp)
            ref = [float(v) for v in load_run(os.path.join(r, "0_run.npz"))["history"]["loss"]]
        reset_lane_counts()
        path = cli.run(lines_config(f"17a_{label}", *flags), results_root=tmp)
        counts = {**read_counts(), **read_lane_counts()}
        bundle = load_run(os.path.join(path, "0_run.npz"))
        loss = [float(v) for v in bundle["history"]["loss"]]
        fused = counts["fused_loss_lanes"] + counts["one_lane"]
        rel = _rel(loss[0], ref[0])
        log(f"17a cli.run {' '.join(flags)}: losses {loss}; against {ref[:3]}..., iteration-0 "
            f"rel err {rel:.3e} (tol {LOSS0_TOL_13:g}); launches {counts}; bundle keys "
            f"{sorted(bundle)}")
        if not (len(loss) == 9 and np.all(np.isfinite(loss))):
            fail(f"17a {label}: the run's loss is not 9 finite iterations")
        if label == "spatial_part" and (counts["one_lane"] != 2 * 9 * shards):
            fail(f"17a {label}: launches {counts}, not the fused loss 9 / 9 on each of "
                 f"{shards} shards")
        if label == "batch_mesh" and not (counts["fused_loss_lanes"] == 9
                                          and counts["fused_loss_grad_lanes"] == 9):
            fail(f"17a {label}: launches {counts}, not 9 / 9 lane launches")
        if not rel <= LOSS0_TOL_13:
            fail(f"17a {label}: the iteration-0 loss differs from the unsharded run's")
        out[label] = {"losses": loss, "launches": counts, "loss0_rel_err": rel,
                      "fused_launches": fused, "reference_losses": ref}
    return out


def flagship17(dev, main: dict) -> dict:
    """17b: the flagship (phase 4's configuration) over [cuda:0] x 10 along
    H, 3 iterations in chunks of 1, traced: its 128 planes split 16 x 6 and
    8 x 4 (16-plane blocks would give 8 shards), its deepest level's 8
    planes 1 a shard with 2 shards empty; the launches and the wgrad and
    upsample shapes those the layout gives (``uneven_expect``), the
    iteration-0 loss against phase 4's (same seed) to 1e-4."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.parallel.spatial import shard_bounds

    img, mask = flagship_problem(256, 128, 128)
    cfg = flagship_config(epochs=3, scan_chunk=1)
    n, iters = UNEVEN_SHARDS, cfg.epochs
    levels = level_bounds(shard_bounds(128, n, 16), 4)
    set_kernels(True)
    solver = DIPSolver(cfg, outchannel=1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, counts, seen, seen_up = traced_solve(solver, img, mask, spatial_mesh=[dev] * n,
                                              spatial_axis=SPATIAL_AXIS)
    peak = torch.cuda.max_memory_allocated()
    loss = np.asarray(res.history.loss)
    steady = statistics.median(res.chunk_seconds[1:])
    wg, up = uneven_expect(WGRAD_SHAPES, [(c, sp, 1) for c, sp in UPSAMPLE_SHAPES], levels,
                           True)
    want = {"fused_loss": n * iters, "fused_loss_grad": n * iters,
            "wgrad3d": iters * sum(wg.values()), "upsample_bwd": iters * sum(up.values())}
    rel = _rel(loss[0], main["loss0"])
    log(f"17b: layout along H by level {[[b - a for a, b in lv] for lv in levels]}")
    log(f"17b flagship over {n} shards: losses {loss.tolist()}; chunk seconds "
        f"{res.chunk_seconds}; steady s/iteration {steady:.4f} against phase 4's "
        f"{main['s_per_iter']:.4f}; peak {peak / 2**30:.2f} GiB against phase 4's "
        f"{main['peak_bytes'] / 2**30:.2f} (predicted: {PREDICTED_17})")
    log(f"17b: launches {counts} (expected from the layout {want}); iteration-0 loss "
        f"{loss[0]:.7g} against phase 4's {main['loss0']:.7g}, rel err {rel:.3e} (tol "
        f"{LOSS0_TOL_17:g})")
    if not (len(loss) == iters and np.all(np.isfinite(loss))):
        fail(f"17b: the loss is not finite for {iters} iterations")
    if res.out_best.shape != img.shape or not np.all(np.isfinite(res.out_best)):
        fail(f"17b: out_best has shape {res.out_best.shape} or is not finite")
    if counts != want:
        fail(f"17b: launch counts {counts}, not the layout's {want}")
    if dict(seen) != {k: iters * v for k, v in wg.items()}:
        fail(f"17b: the wgrad shapes {dict(seen)} are not the layout's {dict(wg)}")
    if dict(seen_up) != {k: iters * v for k, v in up.items()}:
        fail(f"17b: the upsample shapes {dict(seen_up)} are not the layout's {dict(up)}")
    if not rel <= LOSS0_TOL_17:
        fail("17b: the iteration-0 loss differs from phase 4's")
    del solver
    return {"shards": n, "layout": [[list(b) for b in lv] for lv in levels],
            "launches": counts, "expected_launches": want, "losses": loss.tolist(),
            "loss0_rel_err": rel, "s_per_iter": steady, "chunk_seconds": res.chunk_seconds,
            "peak_bytes": peak, "wgrad_shapes": _shapes_list(seen, iters),
            "upsample_shapes": _shapes_list(seen_up, iters)}


def skip17(dev) -> dict:
    """17c: the skip net at the flagship's widths and flags (bf16) on
    (256, 112, 128), unsharded and over [cuda:0] x 2 and x 4 along H, 4
    iterations in chunks of 2: the 112 planes are 3.5 of its 32-plane
    blocks, so the shards lie on 16-plane blocks (64 + 48; 32 x 3 + 16),
    its concats crop along H (its deepest level's 4 planes upsampled to 8
    for the 7 above) and its level of 7 planes splits 4 + 3; launches and
    shapes those the layout gives from the unsharded run's, the
    iteration-0 losses against the unsharded one's to 1e-4, and a second
    2-shard solve bit-equal to the first (deterministic cuDNN, the wgrad
    grids the first tuned)."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.parallel.spatial import shard_bounds

    img, mask = flagship_problem(*SKIP17_VOLUME)
    cfg = flagship_config(net="skip", epochs=4, scan_chunk=2)
    iters = cfg.epochs
    set_kernels(True)
    out = {}

    def solve(n: int, deterministic: bool = False) -> dict:
        solver = DIPSolver(cfg, outchannel=1, device=dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kw = {} if n == 1 else {"spatial_mesh": [dev] * n, "spatial_axis": SPATIAL_AXIS}
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = deterministic
        try:
            res, counts, seen, seen_up = traced_solve(solver, img, mask, **kw)
        finally:
            torch.backends.cudnn.deterministic = det
        loss = np.asarray(res.history.loss)
        r = {"shards": n, "launches": counts, "losses": loss.tolist(),
             "s_per_iter": statistics.median(res.chunk_seconds[1:]) / cfg.scan_chunk,
             "chunk_seconds": res.chunk_seconds, "peak_bytes": torch.cuda.max_memory_allocated(),
             "seen": seen, "seen_up": seen_up, "out_best": res.out_best}
        log(f"17c skip net on {SKIP17_VOLUME} over {n} shard(s): losses {loss.tolist()}; "
            f"launches {counts}; chunk seconds {res.chunk_seconds}, steady s/iteration "
            f"{r['s_per_iter']:.4f}, peak {r['peak_bytes'] / 2**30:.2f} GiB")
        if not (len(loss) == iters and np.all(np.isfinite(loss))):
            fail(f"17c over {n} shard(s): the loss is not finite for {iters} iterations")
        if res.out_best.shape != img.shape or not np.all(np.isfinite(res.out_best)):
            fail(f"17c over {n} shard(s): out_best has shape {res.out_best.shape} or is not "
                 f"finite")
        del solver
        return r

    ref = solve(1)
    if ref["launches"]["upsample_bwd"] != SKIP17_UPS * iters:
        fail(f"17c: {ref['launches']} unsharded, not {SKIP17_UPS} upsamples an iteration")
    wcalls = [(ci, co, sp, k // iters) for (ci, co, sp), k in ref["seen"].items()]
    ucalls = [(c, sp, k // iters) for (c, sp), k in ref["seen_up"].items()]
    for n in SKIP17_SHARDS:
        r = solve(n, deterministic=n == 2)
        levels = level_bounds(shard_bounds(SKIP17_VOLUME[1], n, 32), 5)
        wg, up = uneven_expect(wcalls, ucalls, levels, False)
        want = {"fused_loss": n * iters, "fused_loss_grad": n * iters,
                "wgrad3d": iters * sum(wg.values()), "upsample_bwd": iters * sum(up.values())}
        r["loss0_rel_err"] = _rel(r["losses"][0], ref["losses"][0])
        log(f"17c over {n} shards: layout along H by level "
            f"{[[b - a for a, b in lv] for lv in levels]}; launches {r['launches']} (expected "
            f"from the layout {want}); iteration-0 rel err {r['loss0_rel_err']:.3e} (tol "
            f"{LOSS0_TOL_17:g}); s/iteration {r['s_per_iter']:.4f} against "
            f"{ref['s_per_iter']:.4f}, peak {r['peak_bytes'] / 2**30:.2f} against "
            f"{ref['peak_bytes'] / 2**30:.2f} GiB (predicted: {PREDICTED_17})")
        if r["launches"] != want:
            fail(f"17c over {n} shards: launch counts {r['launches']}, not the layout's {want}")
        if dict(r["seen"]) != {k: iters * v for k, v in wg.items()} or \
                dict(r["seen_up"]) != {k: iters * v for k, v in up.items()}:
            fail(f"17c over {n} shards: the wgrad / upsample shapes {dict(r['seen'])} / "
                 f"{dict(r['seen_up'])} are not the layout's {dict(wg)} / {dict(up)}")
        if not r["loss0_rel_err"] <= LOSS0_TOL_17:
            fail(f"17c over {n} shards: the iteration-0 loss differs from the unsharded one's")
        r["layout"] = [[list(b) for b in lv] for lv in levels]
        out[str(n)] = r
    again = solve(2, deterministic=True)
    same = (np.array_equal(again["losses"], out["2"]["losses"])
            and np.array_equal(again["out_best"], out["2"]["out_best"]))
    log(f"17c: two 2-shard solves from one seed bit-equal {same}")
    if not same:
        fail("17c: two 2-shard skip net solves from one seed are not bit-equal")
    out["1"] = ref
    out["two_runs_bit_equal"] = same
    for r in out.values():
        if isinstance(r, dict):
            r["wgrad_shapes"] = _shapes_list(r.pop("seen"), iters)
            r["upsample_shapes"] = _shapes_list(r.pop("seen_up"), iters)
            r.pop("out_best")
    return out


def uneven17_kernels(dev, p17: dict, done_wgrad: set, done_upsample: set) -> dict:
    """17d: each kernel at phase 17's shard shapes that no earlier phase
    held against its plain version, as 16d: wgrad (bf16) at every shard
    shape of 17b and 17c not in ``done_wgrad``, ``upsample_bwd`` at every
    one of their upsample shapes not in ``done_upsample``, the fused loss
    on their new shard outputs (bf16), each timed beside its bound and the
    library call."""
    g = torch.Generator(device=dev).manual_seed(17)
    runs = [("17b", UNEVEN_SHARDS, p17["17b"])] + [
        ("17c", n, p17["17c"][str(n)]) for n in SKIP17_SHARDS]
    rows, seen = [], set(done_wgrad)
    for label, n, r in runs:
        per_iter = 0.0
        for ci, co, xs, k in r["wgrad_shapes"]:
            key = (ci, co, tuple(xs), "bfloat16")
            if key in seen:
                continue
            seen.add(key)
            row = spatial_wgrad_row(dev, ci, co, tuple(xs), xs[1] - 2, 1, k, g, False, "17d",
                                    torch.bfloat16)
            row["run"] = label
            rows.append(row)
            per_iter += row["ms"] * k
        log(f"17d {label} over {n} shards: wgrad ms/iteration over its new shard shapes "
            f"{per_iter:.4f}")
    ups, seen = [], set(done_upsample)
    for label, n, r in runs:
        for c, sp, k in r["upsample_shapes"]:
            if (c, tuple(sp), "bfloat16") in seen:
                continue
            seen.add((c, tuple(sp), "bfloat16"))
            ups.append(upsample_shard_row(dev, c, sp, 3, torch.bfloat16, k, g, "17d"))
    fused = [fused_shard_row(dev, (1, 1, 256, h, 128), torch.bfloat16, g, "17d", n)
             for h, n in ((16, UNEVEN_SHARDS), (8, UNEVEN_SHARDS), (48, 2), (16, 4))]
    log(f"17d: {len(rows)} new wgrad shapes, {len(ups)} new upsample shapes, "
        f"{len(fused)} fused-loss shard shapes")
    return {"wgrad": rows, "upsample": ups, "fused": fused}


# ----------------------------------------------------------------------
# phase 18: every op of a caller's module over spatial shards
# ----------------------------------------------------------------------

# what was predicted before the first card run of phase 18 (PERF.md)
PREDICTED_18 = ("18a s/iteration at N = 1 / 2 / 4: 0.16-0.22 / 0.32-0.42 / 0.50-0.65, peak "
                "13.8-14.6 / 16.2-17.2 / 16.3-17.4 GiB; iteration-0 losses within 3e-5 of the "
                "unsharded one's; launches and kernel shapes 16a's; phase 18 under 45 s")
CALLER18_KEEP = 16   # the low-pass keeps 16 of H's 33 frequencies
CALLER18_WHOLE = ["torch.fft.rfft", "torch.fft.irfft", "Halve.apply"]
LOSS0_TOL_18 = 1e-4


def caller18():
    """``Caller18``: ``caller16(routes=True)``."""
    return caller16(routes=True)


def custom18(dev, p16: dict) -> dict:
    """18a: ``Caller18`` through ``DIPSolver(model=...)`` at the flagship
    volume and flags, unsharded and over [cuda:0] x 2 and x 4 along H, 6
    iterations in chunks of 3: launches N x the unsharded solve's, the
    iteration-0 loss within 1e-4 of the unsharded solve's, ``whole_ops``
    the FFT pair and ``Halve`` (none unsharded), every wgrad and upsample
    shape one 16a held (16d)."""
    from deep_prior_interpolation_tpu_torch.data import flagship_problem

    img, mask = flagship_problem(256, 128, 128)
    cfg = flagship_config(epochs=6, scan_chunk=3)
    out = zoo15_sharded(dev, "caller18", cfg, 64, img, mask, CALLER16_UPS, SPATIAL_SHARDS,
                        make=caller18, tag="18a", tol=LOSS0_TOL_18, predicted=PREDICTED_18)
    for n, r in out.items():
        names = [o[0] for o in r["whole_ops"]]
        want = [] if n == "1" else CALLER18_WHOLE
        log(f"18a over {n} shard(s): whole route {r['whole_ops']} (expected {want})")
        if names != want:
            fail(f"18a over {n} shard(s): the whole route took {names}, not {want}")
        for key in ("wgrad_shapes", "upsample_shapes"):
            held = {json.dumps(v) for v in p16["16a"][n][key]}
            new = [v for v in r[key] if json.dumps(v) not in held]
            if new:
                fail(f"18a over {n} shard(s): {key} {new} that 16a's checks did not hold")
    return out


def custom18_exactness(dev) -> dict:
    """18b: ``Caller18`` over 2 shards, two 3-iteration solves with
    deterministic cuDNN: history and ``out_best`` bit-equal."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem

    img, mask = flagship_problem(256, 128, 128)
    cfg = flagship_config(epochs=3, scan_chunk=3)
    set_kernels(True)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = [DIPSolver(cfg, device=dev, model=caller18()).solve(
            img, mask, seed=0, spatial_mesh=[dev] * 2, spatial_axis=SPATIAL_AXIS)
            for _ in range(2)]
    finally:
        torch.backends.cudnn.deterministic = det
    same = (np.array_equal(runs[0].history.loss, runs[1].history.loss)
            and np.array_equal(runs[0].out_best, runs[1].out_best))
    log(f"18b: Caller18 over 2 shards, losses {list(runs[0].history.loss)}; two solves "
        f"bit-equal {same}")
    if not same:
        fail("18b: two sharded Caller18 solves from one seed are not bit-equal")
    return {"two_runs_bit_equal": same, "losses": list(runs[0].history.loss)}


# kernel families of the profile, by the first pattern a kernel name holds
FAMILIES = [
    ("wgrad3d (kernel 2)", ("wgrad3d",)),
    ("fused loss forward (kernel 1)", ("loss_sums_kernel",)),
    ("fused loss backward (kernel 1)", ("loss_grad_kernel",)),
    ("cuDNN conv forward", ("fprop",)),
    ("cuDNN conv dgrad", ("dgrad",)),
    ("cuDNN NCDHW<->NDHWC transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("trilinear upsample fwd + bwd", ("upsample",)),
    ("reductions (Norm statistics)", ("reduce_kernel",)),
    ("GEMMs (1x1 convs)", ("gemm",)),
    ("elementwise, casts, copies", ("elementwise", "copy", "Memset", "Memcpy")),
]


def profile_flagship(dev, out_dir: str, **kw) -> None:
    """Trace the second 3-iteration chunk of the flagship solve (with ``kw``
    over its configuration), kernels on, and print its device time an
    iteration by kernel family."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem

    img, mask = flagship_problem(256, 128, 128)
    set_kernels(True)
    cfg = flagship_config(epochs=6, **kw)
    res = DIPSolver(cfg, device=dev).solve(img, mask, seed=0, profile_dir=out_dir)
    log(f"profile {out_dir}: chunk seconds {res.chunk_seconds} (chunk 2 traced)")
    with open(os.path.join(out_dir, "ops.txt")) as fh:
        head, *rows = fh.read().splitlines()
    log(f"profile: {head}")
    total = float(head.split("device kernels ")[1].split(" ms")[0])
    fams = collections.Counter()
    for line in rows:  # "<ms> ms <count>x  <kernel>", the kernels by time
        ms, _, _, name = line.split(maxsplit=3)
        fam = next((f for f, pats in FAMILIES if any(p in name for p in pats)), "other")
        fams[fam] += float(ms)
    fams["below the listed kernels"] = total - sum(fams.values())
    per = cfg.scan_chunk
    log(f"profile: device ms an iteration by family ({per} iterations traced):")
    for fam, ms in fams.most_common():
        log(f"profile:   {fam:34s} {ms / per:9.3f} ms  {ms / total:6.1%}")


# the CUDA-only tests (each skips without a card), run by the smoke test on it
CUDA_TESTS = ["tests/test_torch_cuda.py", "tests/test_torch_cuda_wgrad.py",
              "tests/test_torch_cuda_norm_act.py",
              "tests/test_torch_cuda_upsample.py", "tests/test_torch_cuda_upsample_tma.py",
              "tests/test_torch_cuda_phase.py", "tests/test_torch_cuda_lanes.py",
              "tests/test_torch_cuda_spatial.py", "tests/test_torch_cuda_spatial_options.py",
              "tests/test_torch_cuda_spatial_phase.py", "tests/test_torch_cuda_spatial_zoo.py",
              "tests/test_torch_cuda_spatial_zoo_options.py", "tests/test_torch_cuda_skip3d.py",
              "tests/test_torch_cuda_step_graph.py"]


# the one skip reason the CUDA tests may give, and only on a one-card machine
TWO_CARDS = "needs two CUDA cards"


def run_cuda_tests() -> str:
    """The CUDA-only tests in a child pytest (``--noconftest``: the tests'
    conftest imports JAX, which the card's machine may lack); fails the run
    unless every test passes, but for the tests that need two cards where
    there is one. Returns pytest's summary line."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q", "-rs",
                          "-p", "no:cacheprovider", *CUDA_TESTS], cwd=here,
                         capture_output=True, text=True, timeout=900)
    lines = out.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    skips = [ln for ln in lines if ln.startswith("SKIPPED")]
    allowed = torch.cuda.device_count() < 2 and all(ln.endswith(TWO_CARDS) for ln in skips)
    log(f"CUDA tests: {summary}")
    for ln in skips:
        log(f"  {ln}")
    if out.returncode != 0 or ("skipped" in summary and not allowed):
        log("\n".join(lines[-60:]))
        fail(f"the CUDA tests did not all pass: {summary}")
    return summary


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from deep_prior_interpolation_tpu_torch.engine import solver as S
    # every solve's steps eagerly but the main path's (phase 4): the phases
    # count what the kernels' wrappers and hooks see from Python, which a
    # step replayed from a CUDA graph does not call
    S._GRAPHS = False
    if "--resume-child" in sys.argv[1:]:
        resume_child(sys.argv[sys.argv.index("--resume-child") + 1])
        return
    dev = torch.device("cuda:0")
    # fails here, before any output, when the port is not beside this script
    from deep_prior_interpolation_tpu_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.time()
    _build.start_builds()
    for name in _build.SOURCES:
        _build.load_library(name)
    torch.cuda.synchronize()
    log(f"kernel build: {time.time() - t0:.1f} s")
    for name, text in _build.build_log.items():
        log(f"nvcc {name}:\n{text.strip()}")

    seconds = {"1_build": time.time() - t0}

    def phase(name, fn, *args):
        t = time.time()
        result = fn(*args)
        torch.cuda.empty_cache()
        seconds[name] = time.time() - t
        log(f"phase {name}: {seconds[name]:.1f} s")
        return result

    fused, fused_grad = phase("2_fused_loss", check_fused_loss, dev)
    wgrad = phase("2_wgrad", check_wgrad, dev)
    upsample = phase("2_upsample", check_upsample, dev)
    upsample["lines_2d"] = phase("2_upsample_2d", check_upsample_2d, dev)
    upsample["forward"] = phase("2_upsample_forward", time_upsample_forward, dev)
    norm_act = phase("2_norm_act", check_norm_act, dev)
    small = phase("3_small_solve", check_small_solve, dev)
    main = phase("4_main_path", main_path, dev)
    if "--profile" in sys.argv[1:]:
        profile_flagship(dev, sys.argv[sys.argv.index("--profile") + 1])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        survey = phase("5_cli_survey", cli_survey, dev, tmp)
        lines = phase("5_cli_lines", cli_lines, tmp)
        checkpoint = phase("5c_resume", check_resume, dev, tmp, main)
        options = phase("6a-d_options", check_options, dev, main)
        zoo = phase("6e_zoo", check_zoo, dev)
        zoo_2d = {net: phase(f"6f_lines_{net}", cli_lines, tmp, ("--net", net), f"lines_{net}",
                             ups)
                  for net, ups in (("attmultiunet", 4), ("part", 0))}
        ensemble = phase("6g_ensemble", check_ensemble, dev)
        t7 = time.time()
        phase7 = {"7a_flagship": phase("7a_phase_flagship", phase_flagship, dev, main)}
        if "--profile" in sys.argv[1:]:
            profile_flagship(dev, os.path.join(sys.argv[sys.argv.index("--profile") + 1],
                                               "phase"), **PHASE7)
        phase7["7b_float32"] = phase("7b_phase_float32", phase_exactness, dev)
        phase7["7c_determinism"] = phase("7c_phase_determinism", phase_determinism, dev, tmp)
        phase7["7d_wgrad"] = phase("7d_phase_wgrad", phase_wgrad, dev, wgrad,
                                   phase7["7a_flagship"]["launches"])
        phase7["7e_formulations"] = phase("7e_formulations", check_formulations, dev, small)
        seconds["7_total"] = time.time() - t7
        log(f"phase 7: {seconds['7_total']:.1f} s")
        t8 = time.time()
        survey8 = phase("8a_batch_survey", batch_survey, dev, tmp, main)
        lines8 = phase("8b_lines_batches", lines_batches, dev)
        kernels8 = phase("8c_lane_kernels", lane_kernels, dev, survey8)
        assembly8 = phase("8d_assembly", batch_assembly, dev, survey8)
        seconds["8_total"] = time.time() - t8
        log(f"phase 8: {seconds['8_total']:.1f} s")
        t10 = time.time()
        phase10 = {"10a_flagship": phase("10a_spatial_flagship", spatial_flagship, dev, main),
                   "10a_gradients": phase("10a_spatial_gradients", spatial_gradients, dev,
                                          main),
                   "10b_exactness": phase("10b_spatial_exactness", spatial_exactness, dev, tmp),
                   "10c_kernels": phase("10c_spatial_kernels", spatial_kernels, dev),
                   "10d_multicard": phase("10d_spatial_multicard", spatial_multicard, dev,
                                          main)}
        seconds["10_total"] = time.time() - t10
        log(f"phase 10: {seconds['10_total']:.1f} s")
        t11 = time.time()
        phase11 = {"11a_options": phase("11a_spatial_options", spatial_options, dev,
                                        phase10["10a_flagship"]),
                   "11b_float32": phase("11b_spatial_float32", spatial_float32, dev),
                   "11c_exactness": phase("11c_spatial_exactness", spatial_options_exactness,
                                          dev, tmp)}
        seconds["11_total"] = time.time() - t11
        log(f"phase 11: {seconds['11_total']:.1f} s")
        t12 = time.time()
        phase12 = {"12a_phase": phase("12a_spatial_phase", spatial_phase, dev, phase7),
                   "12b_canvas": phase("12b_spatial_canvas", spatial_canvas, dev),
                   "12c_exactness": phase("12c_spatial_phase_exactness",
                                          spatial_phase_exactness, dev, tmp),
                   "12d_kernels": phase("12d_spatial_phase_kernels", spatial_phase_kernels,
                                        dev, phase10)}
        seconds["12_total"] = time.time() - t12
        log(f"phase 12: {seconds['12_total']:.1f} s")
        t13 = time.time()
        phase13 = {"13ab": phase("13ab_zoo_sharded", zoo_sharded, dev, zoo),
                   "13b_gradients": phase("13b_zoo_partial_gradients", zoo_partial_gradients,
                                          dev),
                   "13c": phase("13c_zoo_lines", zoo_lines, dev, zoo_2d),
                   "13d_exactness": phase("13d_zoo_exactness", zoo_exactness, dev, tmp)}
        phase13["13e_kernels"] = phase("13e_zoo_kernels", zoo_kernels, dev, phase13, phase10,
                                       phase12)
        seconds["13_total"] = time.time() - t13
        log(f"phase 13: {seconds['13_total']:.1f} s")
        t14 = time.time()
        phase14 = {"14a_g3d": phase("14a_convergence_g3d", convergence_g3d, dev),
                   "14b_g25d": phase("14b_convergence_25d", convergence_25d, dev),
                   "14c_gpocs": phase("14c_convergence_pocs", convergence_pocs, dev),
                   "14d_flagship": phase("14d_convergence_flagship", convergence_flagship,
                                         dev, main, wgrad)}
        seconds["14_total"] = time.time() - t14
        log(f"phase 14: {seconds['14_total']:.1f} s")
        t15 = time.time()
        phase15 = {"15a": phase("15a_zoo_options_3d", zoo15_3d, dev),
                   "15b": phase("15b_zoo_options_lines", zoo15_lines, dev),
                   "15c": phase("15c_zoo_options_exactness", zoo15_exactness, dev)}
        done_wgrad = {(r["ci"], r["co"], tuple(r["x_shape"]), r["dtype"])
                      for r in (phase10["10c_kernels"]["wgrad"] + phase12["12d_kernels"]["wgrad"]
                                + phase13["13e_kernels"]["wgrad"])}
        done_upsample = {(r["channels"], tuple(r["input"]), r.get("dtype", "bfloat16"))
                         for r in (phase10["10c_kernels"]["upsample"]
                                   + phase13["13e_kernels"]["upsample"])}
        phase15["15d_kernels"] = phase("15d_zoo_options_kernels", zoo15_kernels, dev, phase15,
                                       done_wgrad, done_upsample)
        seconds["15_total"] = time.time() - t15
        log(f"phase 15: {seconds['15_total']:.1f} s")
        t16 = time.time()
        phase16 = {"16a": phase("16a_custom_module", custom16, dev),
                   "16b": phase("16b_custom_exactness", custom16_exactness, dev),
                   "16c": phase("16c_custom_refused", custom16_refused, dev)}
        rows15 = phase15["15d_kernels"]
        done_wgrad |= {(r["ci"], r["co"], tuple(r["x_shape"]), r["dtype"])
                       for r in rows15["wgrad"]}
        done_upsample |= {(r["channels"], tuple(r["input"]), r["dtype"])
                          for r in rows15["upsample"]}
        phase16["16d_kernels"] = phase("16d_custom_kernels", custom16_kernels, dev, phase16,
                                       done_wgrad, done_upsample)
        seconds["16_total"] = time.time() - t16
        log(f"phase 16: {seconds['16_total']:.1f} s")
        t17 = time.time()
        phase17 = {"17a": phase("17a_cli_devices", cli17, dev, tmp, zoo_2d),
                   "17b": phase("17b_uneven_flagship", flagship17, dev, main),
                   "17c": phase("17c_uneven_skip", skip17, dev)}
        rows16 = phase16["16d_kernels"]
        done_wgrad |= {(r["ci"], r["co"], tuple(r["x_shape"]), r["dtype"])
                       for r in rows16["wgrad"]}
        done_upsample |= {(r["channels"], tuple(r["input"]), r["dtype"])
                          for r in rows16["upsample"]}
        phase17["17d_kernels"] = phase("17d_uneven_kernels", uneven17_kernels, dev, phase17,
                                       done_wgrad, done_upsample)
        seconds["17_total"] = time.time() - t17
        log(f"phase 17: {seconds['17_total']:.1f} s")
        t18 = time.time()
        phase18 = {"18a": phase("18a_whole_routes", custom18, dev, phase16),
                   "18b": phase("18b_whole_exactness", custom18_exactness, dev)}
        seconds["18_total"] = time.time() - t18
        log(f"phase 18: {seconds['18_total']:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cuda_tests = phase("9_cuda_tests", run_cuda_tests)
    log(f"phase seconds: {json.dumps(seconds)}")
    fused["launches"] = main["counts"]["fused_loss"]
    fused_grad["launches"] = main["counts"]["fused_loss_grad"]
    wgrad["launches"] = main["counts"]["wgrad3d"]
    upsample["launches"] = main["counts"]["upsample_bwd"]
    upsample["launches_by_kernel"] = main["upsample_kernels"]
    log(json.dumps({"main_path": {"s_per_iter": main["s_per_iter"],
                                  "peak_memory_bytes": main["peak_bytes"]}}))
    log(json.dumps({"cli": {"survey_3d": survey, "lines_2d": lines,
                            "checkpoint": checkpoint}}))
    log(json.dumps({"phase6": {"options": options, "zoo_3d": zoo, "zoo_2d": zoo_2d,
                               "ensemble": ensemble, "seconds": seconds}}))
    phase7["seconds"] = {k: v for k, v in seconds.items() if k.startswith("7")}
    log(json.dumps({"phase7": phase7}))
    phase8 = {"8a_batch": {k: v for k, v in survey8.items() if k != "outputs"},
              "8b_lines": lines8, "8d_assembly": assembly8,
              "seconds": {k: v for k, v in seconds.items() if k.startswith("8")}}
    phase8["cuda_tests"] = cuda_tests
    log(json.dumps({"phase8": phase8}))
    upsample["phase_launches"] = phase7["7a_flagship"]["launches"]["upsample_bwd"]
    upsample["lanes_launches"] = survey8["launches"]["upsample_bwd"]
    upsample["lanes_launches_by_kernel"] = survey8["upsample_kernels"]
    upsample["lanes_shapes"] = kernels8["upsample"]
    fused["phase_launches"] = phase7["7a_flagship"]["launches"]["fused_loss"]
    fused_grad["phase_launches"] = phase7["7a_flagship"]["launches"]["fused_loss_grad"]
    phase10["seconds"] = {k: v for k, v in seconds.items() if k.startswith("10")}
    log(json.dumps({"phase10": phase10}))
    phase11["seconds"] = {k: v for k, v in seconds.items() if k.startswith("11")}
    log(json.dumps({"phase11": phase11}))
    phase12["seconds"] = {k: v for k, v in seconds.items() if k.startswith("12")}
    log(json.dumps({"phase12": {k: v for k, v in phase12.items() if k != "12d_kernels"}}))
    phase13["seconds"] = {k: v for k, v in seconds.items() if k.startswith("13")}
    log(json.dumps({"phase13": {k: v for k, v in phase13.items() if k != "13e_kernels"}}))
    # each kernel's launches on 10a's sharded paths, by shard count, and its
    # rows at the shard shapes (10c)
    for entry, key in ((fused, "fused_loss"), (fused_grad, "fused_loss_grad"),
                       (wgrad, "wgrad3d"), (upsample, "upsample_bwd")):
        entry["spatial_launches"] = {n: r["launches"][key]
                                     for n, r in phase10["10a_flagship"].items()}
        entry["spatial_options_launches"] = {
            "11a": {n: phase11["11a_options"][str(n)]["launches"][key] for n in SPATIAL_SHARDS},
            "11b": {k: r["launches"][key] for k, r in phase11["11b_float32"].items()}}
        entry["spatial_phase_launches"] = {
            "12a": {n: phase12["12a_phase"][str(n)]["launches"][key] for n in SPATIAL_SHARDS},
            "12b": {2: phase12["12b_canvas"]["launches"][key]}}
        entry["spatial_zoo_launches"] = {
            "13ab": {k: r["launches"][key] for k, r in phase13["13ab"].items()},
            "13c": {ZOO_2D_SHARDS: phase13["13c"]["launches"][key]}}
    # 10a's shard shapes (10c), then the phase path's new ones (12d) and the
    # zoo's (13e)
    zoo_rows = phase13["13e_kernels"]
    fused["spatial_shapes"] = phase10["10c_kernels"]["fused"] + zoo_rows["fused"]
    wgrad["spatial_shapes"] = (phase10["10c_kernels"]["wgrad"] + phase12["12d_kernels"]["wgrad"]
                               + zoo_rows["wgrad"])
    wgrad["spatial_phase_ms_per_iteration"] = phase12["12d_kernels"]["ms_per_iteration"]
    upsample["spatial_shapes"] = phase10["10c_kernels"]["upsample"] + zoo_rows["upsample"]
    # phase 14's launches: the one-lane kernels in 14a and 14d, the lane
    # fused loss in 14b and 14c
    log(json.dumps({"phase14": {
        "accept": {k: r["accept"] for k, r in phase14.items() if "accept" in r},
        "s_per_iter": {k: r["s_per_iter"] for k, r in phase14.items()},
        "seconds": {k: v for k, v in seconds.items() if k.startswith("14")}}}))
    for entry, key in ((fused, "fused_loss"), (fused_grad, "fused_loss_grad"),
                       (wgrad, "wgrad3d"), (upsample, "upsample_bwd")):
        entry["convergence_launches"] = {"14a": phase14["14a_g3d"]["launches"][key],
                                         "14d": phase14["14d_flagship"]["launches"][key]}
    phase15["seconds"] = {k: v for k, v in seconds.items() if k.startswith("15")}
    log(json.dumps({"phase15": {k: v for k, v in phase15.items() if k != "15d_kernels"}}))
    # phase 15's launches: each net unsharded ("1") and by shard count, and
    # its rows at the new shard shapes (15d)
    for entry, key in ((fused, "fused_loss"), (fused_grad, "fused_loss_grad"),
                       (wgrad, "wgrad3d"), (upsample, "upsample_bwd")):
        entry["spatial_zoo_options_launches"] = {
            part: {f"{label} {n}": r["launches"][key] for label, runs in phase15[part].items()
                   for n, r in runs.items()} for part in ("15a", "15b")}
    fused["spatial_shapes"] += rows15["fused"]
    wgrad["spatial_shapes"] += rows15["wgrad"]
    upsample["spatial_shapes"] += rows15["upsample"]
    for entry, rows in ((fused, rows15["fused"]), (wgrad, rows15["wgrad"])):
        entry["max_abs_err"] = max([entry["max_abs_err"]] + [r["max_abs_err"] for r in rows])
    phase16["seconds"] = {k: v for k, v in seconds.items() if k.startswith("16")}
    log(json.dumps({"phase16": {k: v for k, v in phase16.items() if k != "16d_kernels"}}))
    # phase 16's launches: Caller3D unsharded ("1") and by shard count, and
    # its rows at the new shapes (16d)
    for entry, key in ((fused, "fused_loss"), (fused_grad, "fused_loss_grad"),
                       (wgrad, "wgrad3d"), (upsample, "upsample_bwd")):
        entry["spatial_custom_launches"] = {"16a": {n: r["launches"][key]
                                                    for n, r in phase16["16a"].items()}}
    wgrad["max_abs_err"] = max([wgrad["max_abs_err"]] + [r["max_abs_err"]
                                                          for r in rows16["wgrad"]])
    phase17["seconds"] = {k: v for k, v in seconds.items() if k.startswith("17")}
    log(json.dumps({"phase17": {k: v for k, v in phase17.items() if k != "17d_kernels"}}))
    # phase 17's launches: the CLI runs on the cards there are (17a), the
    # flagship over 10 uneven shards (17b), the skip net unsharded ("1") and
    # over uneven shards (17c); its rows at the new shard shapes (17d)
    for entry, key in ((fused, "fused_loss"), (fused_grad, "fused_loss_grad"),
                       (wgrad, "wgrad3d"), (upsample, "upsample_bwd")):
        entry["spatial_uneven_launches"] = {  # by shard count
            "17a": {k: phase17["17a"][k]["launches"][key]
                    + phase17["17a"][k]["launches"].get(f"{key}_lanes", 0)
                    for k in ("spatial_part", "batch_mesh")},
            "17b": {UNEVEN_SHARDS: phase17["17b"]["launches"][key]},
            "17c": {n: phase17["17c"][n]["launches"][key]
                    for n in ("1",) + tuple(str(n) for n in SKIP17_SHARDS)}}
    rows17 = phase17["17d_kernels"]
    fused["spatial_shapes"] += rows17["fused"]
    wgrad["spatial_shapes"] += rows16["wgrad"] + rows17["wgrad"]
    upsample["spatial_shapes"] += rows16["upsample"] + rows17["upsample"]
    for entry, rows in ((fused, rows17["fused"]), (wgrad, rows17["wgrad"])):
        entry["max_abs_err"] = max([entry["max_abs_err"]] + [r["max_abs_err"] for r in rows])
    phase18["seconds"] = {k: v for k, v in seconds.items() if k.startswith("18")}
    log(json.dumps({"phase18": phase18}))
    # phase 18's launches: Caller18 unsharded ("1") and by shard count (its
    # shapes are 16a's, held in 16d)
    for entry, key in ((fused, "fused_loss"), (fused_grad, "fused_loss_grad"),
                       (wgrad, "wgrad3d"), (upsample, "upsample_bwd")):
        entry["spatial_whole_launches"] = {"18a": {n: r["launches"][key]
                                                   for n, r in phase18["18a"].items()}}
    lanes = lane_entries(survey8, kernels8)
    for entry in lanes[:3]:
        entry["convergence_launches"] = {k: phase14[f"{k}_{g}"]["launches"][entry["name"]]
                                         for k, g in (("14b", "g25d"), ("14c", "gpocs"))}
    log(json.dumps({"norm_act": norm_act}))
    log(json.dumps({"kernels": [fused, fused_grad, wgrad, upsample] + norm_entries(main, norm_act)
                    + lanes}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
