#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card (an H100).

    python3 chip_smoke.py [--seed N] [--parent-kernels DIR]

Run from the repository root. Phases, one JSON line each:

1. ``device``: the card (``nvidia-smi`` name and power limit, torch's device
   name) and the build of every CUDA kernel of the port from ``csrc/``
   (one ``nvcc`` per source, all started together). With
   ``--parent-kernels DIR``, also the parent design's two kernels (the
   packed ``[rows, 128]`` B1 and B2, copied from git history into DIR),
   built beside them for a comparison in the same call.
2. ``kernel``: the fused LSLR update B1 (``csrc/fused_sgd.cu``) against its
   plain PyTorch twin on the card, at the trees of the main paths (the
   VGG-64 tree of 20-way Omniglot, 18 leaves over 8 tasks; its anil head,
   2 leaves over 8 tasks, also timed beside the floor; the ResNet-12
   tree, 86 leaves over 8 tasks, 34,872,480 elements, which takes the
   kernels' 256-leaf table), at a ragged tree whose leaves take the rest and
   element-by-element paths, and at 220 small leaves, in float32 and
   bfloat16; it must be bit-equal. Times are CUDA-event medians with the L2
   cache flushed before every launch, under two flushes (``time_ms``): at
   the VGG tree the kernel, the parent design (in turns: parent, kernel,
   kernel, parent), an empty kernel (the floor), the twin,
   ``torch.addcmul`` over a packed buffer and two ``torch._foreach`` calls;
   at the ResNet-12 tree the kernel, the twin and ``torch.addcmul`` beside
   the byte bound.
3. ``kernel_bwd``: its backward B2 (``csrc/fused_sgd_bwd.cu``) against its
   twin at the same trees: ``dg`` bit-equal, ``dlr`` within the bound of
   the kernel's summation tree from a float64 sum, and bit-equal across
   launches; its times likewise; then the ``FusedSGD``
   gradients on the card against the same Function on the CPU.
4. ``small`` (in the side process): the serving engine with the kernel
   against the same engine on
   the CPU at a small size (2 stages, 8 filters, 3-way), within 1e-5.
5. ``slice``: the serving path at ``configs/default.yaml`` with
   ``use_pallas_inner_update=true`` (Omniglot 20-way 5-shot, Conv-4 VGG with
   64 filters, 5 inner steps), seeded random weights: a flush of 8 requests
   at support 100, a flush of 3 requests at support 60 (padded to bucket 100
   and to a task batch of 4), the third of them again alone, and predictions
   on 40 and 15 queries. Checks: finite probabilities whose rows sum to 1, the
   lone request equal to its place in the flush, one kernel launch per inner
   step of every flush, and (in phase ``cross``) agreement with the same
   engine on the CPU, and how far each device's float32 is from a float64
   reference. It reports a ``torch.profiler`` breakdown of one adapt flush
   by kernel.
6. ``train``: ``MAMLSystem.train_step`` at the same config (meta-batch 8,
   second order, MSL on) on one class-structured batch: 10 steps at epoch
   0, one past the MSL window, 3 eval steps. Checks: finite losses, the loss
   lowered by 10 steps, B1 launched 5 times per train and eval step and B2 5
   times per train step, one leaf copied to make it contiguous per B2
   launch (the head weight's cotangent) and none on the serving paths, and
   (in phase ``cross``) the first step's loss against the CPU's and the
   meta-gradient at 2 tasks against the CPU's and a float64 one (with that
   loss, reported). It reports step times, peak memory and a
   ``torch.profiler`` breakdown of one step.
7. ``serve_trained``: the trained state saved with ``save_checkpoint``,
   loaded by ``AdaptationEngine.from_run_dir`` and served one flush.
7b. ``serve_programs``: the serving programs (``core/programs.py``
   ``ServingCall``: each flush ``(kind, strategy, bucket, batch)`` one
   CUDA graph) at the slice's config (budget 120 s). (a) Under the
   deterministic algorithms, for maml++, fomaml, anil and protonet an
   adapt flush of 8 requests at support 100 and its predictions on 8 x 40
   queries, and a refine flush but for protonet, each replayed (the
   program's second flush) against the system's eager call on the same
   inputs: bit-equal; each adapt and refine replay adds its graph's B1
   tally (5) to the replayed launches, a predict replay none; two tenants
   alternating through one program (a pager that holds one master, so
   each turn re-pages) against the eager calls on their own masters:
   bit-equal. (b) The strict engine at the config's grid with refine (48
   programs) prewarmed: every program captured, each one's capture
   seconds, the pool's bytes; then 50 requests at planned keys (flushes
   of 1 to 8 over every bucket, half of them refined): no ledger entry
   outside ``phase="prewarm"``, no program built, B1 5 times per adapt
   and refine flush, all replayed. (c) Adapt, refine and predict flushes
   at the VGG cell (8 requests at support 100), eager against replayed,
   20 of each in turns (the default algorithms): the medians.
8. ``http``: the trained state served over HTTP by ``python -m
   howtotrainyourmamlpytorch_tpu_torch.serve RUN_DIR`` in a subprocess on
   the card, with ``serving.refine_enabled=true``: 8 client threads of 4
   /adapt each at support 100, then /predict of 40 queries per adaptation
   id, a repeated /adapt (a cache hit, no launch), /adapt with refine,
   /adapt_predict, a malformed body (400) and an unknown id (404); SIGTERM
   (exit 0, the sessions spilled), then a restart (the sessions
   rehydrated, a cache hit, the same probabilities within 1e-5). Checks:
   adaptation ids equal to ``support_digest``, B1 launched 5 times per
   adapt and refine flush (the server's count in /metrics), and each
   answer within the float32 noise floor of the same request served alone
   in this process (1e-6, or the largest distance any of the 32 requests
   moves when its images move by 1e-6), which another request's weights
   exceed. It reports client and server
   p50/p99 of /adapt and /predict, the median ``timing`` breakdown, and
   flushes per /adapt.
9. ``tenancy``: multi-tenant serving at the same config: the trained state
   and 4 tenants (``synthetic_registry``: perturbed copies written as
   format-2 checkpoints) in a run directory with a ``tenants.yaml``, served
   by the same CLI with ``serving.tenant_budget_bytes`` = 2 masters and a
   resident-bytes quota; 3 rounds of /adapt and /predict over the default
   tenant and the 4 tenants in turn (every tenant access pages a master
   in), a quota breach (429 + Retry-After) beside another tenant's 200, a
   cross-tenant 404, an unknown tenant's 400, SIGTERM. Checks: page-ins,
   evictions and the resident set against the LRU arithmetic (/metrics and
   events.jsonl), each answer within phase ``http``'s noise floor of a
   single-tenant engine on that tenant's checkpoint (the exact ones
   counted), B1 launched 5 times per adapt flush. Then in this process:
   page-ins timed (cold against resident adapts), an eviction freeing the
   master's allocator blocks, an eviction through the memory watermark,
   ``clone_for_device(cuda:0)`` against the engine.
9b. ``bench`` (children started before ``http``, collected after
   ``tenancy``; budget 180 s): the port's two measurement entry points
   as a user runs them, ``python -m howtotrainyourmamlpytorch_tpu_torch.bench``
   (the JAX script's flagship recipe: 20-way 5-shot VGG-64, meta-batch 8,
   K=5, second order, the legacy bf16 cast; 6 timed steps, 4 phase steps,
   a K=3 chunk, 2 traced steps, the B=16 arm) and ``.bench_serving`` (its
   defaults, 4 adapts, 16 predicts, a 3 s staircase, 2 refines, 2
   tenants), and a third trainer child sent SIGTERM once its stage after
   ``measure`` begins. Checks: each prints one JSON line with rc 0, the
   JAX scripts' keys, a positive headline, ``platform`` naming the card,
   ``mfu`` and the K-step arm measured, the serving programs all built by
   the prewarm, B1/B2 launched no time (both recipes keep the fused update
   off, as the JAX scripts do), and the SIGTERM child's line with
   ``wedged_at`` and its headline (rc 0). Each line's headline and stages
   are printed.
9c. ``lint`` (two children started with ``bench``'s, collected after it;
   budget 180 s): the port's static gate and its runtime twin. (a) ``python
   -m howtotrainyourmamlpytorch_tpu_torch.lint --json`` over the package
   and this script on the card's host: rc 0, no finding, at most 20
   suppressed (its findings, suppressions and seconds reported). (b) The
   hot paths GL110 holds, driven once on the card under
   ``torch.cuda.set_sync_debug_mode("warn")`` with every synchronizing
   call recorded with its Python stack: a training chunk (K=2) captured
   and replayed (``train_step_multi``), an adapt flush and a predict flush
   built and replayed (the slice's 8 requests), and the frontend's guarded
   dispatch (``EngineReplica.dispatch``: an in-process frontend's /adapt
   and /predict). Checks: a known ``.item()`` is recorded at its line (the
   recorder works); none inside a capture; every sync whose innermost
   frame of the package lies in a hot function is at a suppressed GL110
   line; a sync with no frame of the repository counts against its path's
   suppressed sites (none here). Its sync sites, by path, are reported.
10. ``fleet``: the serving fleet at the same config and trained state,
   through the port's import-light CLIs (``scripts/gateway.py``,
   ``scripts/fleet_serve.py``, ``scripts/rolling_restart.py`` of the
   package, run by path) and the serve CLI: two backends in their own
   processes on the card behind the gateway, the supervisor (min 2, max 3
   backends over 3 slots), ``python -m
   howtotrainyourmamlpytorch_tpu_torch.loadgen --url`` through the gateway
   (3 stairs of 4 req/s, a quarter of them /adapt) with a kill -9 of one
   backend 6 s in. Checks: the gateway marks it OUT within its hysteresis
   window, the supervisor respawns its slot, every stair answers, the
   displaced session answers 404 and re-adapts bit-equal to its first
   answer (the serve CLI runs the deterministic algorithms); then with no load, each backend's B1 launches equal 5 x
   its flushes (its /metrics); the supervisor's SIGTERM (rc 0), a rolling
   restart from its journal under load (both drains clean, sessions
   rehydrated, a cache hit after it, the rehydrated answer bit-equal), the rolled backends' B1 counts, a clean stop of backends and
   gateway, no process left. It reports the load's stairs, kill to OUT,
   respawn to ``ok``, the respawned backend's first /adapt, the gateway hop
   (the same /predict through the gateway and direct) and the phase's
   seconds.
10b. ``cross`` (after ``fleet``): the card-against-CPU checks of phases
   ``slice`` and ``train`` on their card halves and the CPU halves the CPU
   twin made meanwhile, each CPU half checked to have run on the card's
   own weights and inputs.
11. ``strategies``: the strategy registry at the fleet row
   ``omniglot.20.5.vgg.gd.anil`` (the default config with
   ``strategy=anil``): 10 anil train steps and an eval step, B1 and B2 over
   the head's 2 leaves, K launches each per step; the anil step faster
   than phase ``train``'s maml++ step; one step under remat ``full`` (B1
   2 K, B2 K); the card against the CPU at a small size (1e-5) and, at full
   width, each device against float64 as in ``train``. Then the engine
   serves maml++, fomaml, anil and protonet from the trained state: per
   strategy a lone request against its place in a padded flush (cuDNN
   deterministic; within 1e-6, protonet 1e-5, or the distance the request
   moves when its images move by 1e-6, where that is larger) and timed flushes of 8 requests at support 100 with
   8 x 40 queries (finite probabilities whose rows sum to 1); maml++ and
   fomaml bit-equal; protonet's adapt flush faster than maml++'s; one
   refine flush each for maml++ and anil, K launches of B1.
12. ``precision`` (in the side process): the default config's train step under
   ``matmul_precision`` ``highest`` (IEEE float32) and ``high`` (TF32
   matmuls and convolutions): the flags read back, the first step's loss
   and the median step of each.
13. ``runner``: the experiment layer at the same config, on a generated
   image folder of Omniglot's layout and size (1,623 classes of 20 105x105
   1-bit PNGs in 50 alphabet folders, read and resized to 28x28 by the
   loader; the folder and its index cache are made by a process started
   after phase ``device``): ``ExperimentRunner`` in this process for 2 epochs of 5 steps
   with validation (5 batches) and the best checkpoint's test, then three
   CLI legs (the training CLI), each a subprocess started once the folder
   is written, importing and starting the card behind a gate while the
   runner works, then released all at once: one resuming the run to 3 epochs, one
   training ResNet-12 at the fleet row ``omniglot.20.1.resnet-12.gd`` for
   one epoch of one step on the same folder, one with ``strategy=anil``
   likewise (the CLI legs evaluate one batch of 8 tasks and read the images
   from disk), then the
   port's run analysis (``python -m howtotrainyourmamlpytorch_tpu_torch.analysis``;
   the tables alone, with a line saying so, where matplotlib does not
   import) over the three runs. Every CLI leg runs at the config's
   ``matmul_precision``, as this process does. Checks: the run directories' files
   and columns, finite losses, B1 launched 5 times per train and eval step
   and B2 5 times per train step through the runner, 5 leaf copies per
   train step, the native episode engine for every batch, the resumed
   process training only epoch 2 from the loader cursor at 80 episodes. It
   reports epoch times, the runner's step period beside phase ``train``'s
   bare step, the share of each telemetry phase, the loader's episodes per
   second alone and a ``torch.profiler`` breakdown of one runner step.
14. ``elastic``: data-parallel training at the same config (the mesh
   names cuda:0 several times: the dp=2 and dp=4 code paths on the one
   card), on phase ``runner``'s image folder and index cache. The sharded
   step at dp=1, 2 and 4 on one start state and one class-structured batch:
   the loss and the meta-gradient's cosine to dp=1 within twice the card's
   float32 floor (the larger of the same dp=1 step twice and the move under
   a 1e-6 change of the support images), B1 and B2 launched dp x K times
   per step, the median step of each width. Then an ``ExperimentRunner``
   at ``parallel.dp=2`` on ``[cuda:0, cuda:0]`` writes a format-3 ``latest``
   (2 shards and a manifest, async); the same checkpoint evaluated on dp=2
   and on a degraded one-device runner agree within twice the eval's own
   floor (the largest relative move of the dp=2 eval's loss run again and
   with the val images moved by 1e-6: +-1e-6 on every pixel, and 1e-6 with
   3 drawn sign patterns); the CLI
   resumes it on the one visible card (``degraded_mesh`` {requested [2, 1],
   granted [1, 1], visible 1}, an epoch trained, rc 0); a runner whose
   device probe walks 1 then 2 grows back at the epoch boundary
   (``mesh_grown``, the next steps at 2 x K launches). Beside that chain,
   from the start of the dp=2 runner, a run of its own: the CLI at the
   same settings with ``HTYMP_FAULTS=checkpoint.write=sigterm:nth=2``
   (SIGTERM on the writer thread during an async 2-shard save) exits 75,
   and a clean CLI resume from its ``latest`` exits 0 and finishes the
   run. The three CLI processes start before phase ``runner`` and wait
   behind gates until their turn. It
   reports the per-width loss, cosine and
   step times with their ratios, the floor, the launches, the shard files'
   bytes, the events, the rcs and the phase's seconds (under 90 s, the run
   under 900 s: both checked after the ``timing`` line).
14b. ``tensor_parallel``: tensor parallelism and buffer donation at the
   same config, on phase ``runner``'s image folder, in this process, on a
   dp=2 x mp=2 mesh naming cuda:0 four times. (1) The dp x mp step with
   ``tp_convs`` (each conv kernel split into two blocks of 32 output
   channels, the head into two of 10) and without (the head alone split)
   against dp=1 on one start state and batch: the loss and the
   meta-gradient's cosine within twice the card's float32 floor (as in
   ``elastic``), B1 and B2 launched dp x mp x K times per step, the step
   times beside dp=1's. (2) Under the deterministic algorithms a chunk of 3
   TP steps replayed from one CUDA graph (``train_step_multi`` on a
   sharded chunk) bit-equal to the eager TP steps and a second replay, B1
   and B2 dp x mp x K per replay. (3) An ``ExperimentRunner`` at dp=2 x
   mp=2 with ``tp_convs`` and ``donate_train_state``, 1 epoch of 2 steps:
   the ``donation_selfcheck`` event ``clean``, the ``donation_audit``
   event, every step in place, a synchronous format-3 ``latest`` of 4
   shards with bookkeeping mesh [2, 2]; the checkpoint evaluated on a
   one-device runner (``degraded_mesh`` granted [1, 1]) within twice the
   eval's own floor, then served one flush by
   ``AdaptationEngine.from_run_dir``. (4) The default config's eager train
   step donated and plain under the deterministic algorithms: bit-equal,
   the donated one in place, the peak memory of each. Under 60 s.
15. ``operations``: the operations layer on the card, on phase
   ``runner``'s image folder. (1) The sanitized chaos campaign
   (``run_campaign``, 8 episodes at the run's seed, in-process, the
   lock-discipline sanitizer armed) at the JAX package's toy sizes: ``ok``,
   zero violations, a sanitizer block armed with zero violations, each
   episode's seconds. (2) The serve CLI in a fresh process at the same
   config with ``strict_recompile_guard``, ``aot.enabled`` and
   ``resilience.sanitizer``: /healthz 503 ``warming`` then 200 ``ok`` (the
   seconds and the programs prewarmed), the first /adapt after ``ok``
   within 2x the median of 5 warm /adapts at the same bucket, 64 mixed
   /adapt and /predict requests over every bucket 8 at a time, the guard
   sealed with zero outside-prewarm dispatches, zero ``graftsan_violation``
   events (the thread-leak audit of ``close()`` among them) after SIGTERM,
   B1 launched 5 times per adapt flush (the server's count). (3) The
   runner at the same config, 1 epoch of 3 steps, in this process, unarmed
   then with ``resilience.sanitizer=true``: zero ``graftsan_violation``
   events, B1 and B2 K times per train step, the step period of each.
   (4) The training fleet (``resilience/fleet.py``): 2 cells, seeds 0 and
   1, at the same config cut to 1 epoch of 3 steps and 8 evaluation tasks,
   two at a time on the card, the real card gate
   (``scripts/wait_for_card.py``, rc 0) and the real launcher wrapped to
   set ``HTYMP_FAULTS=runner.step=sigterm:nth=2`` for the first attempt of
   one cell: its rcs [75, 0] with a resume in its own run directory, the
   other's [0], both ``done`` with obs rows from the port's
   ``obs_report``; beside them ``fleet_run --dry-run`` over the same jobs
   (rc 0, one JSON line, two cells). (5) One default-config support set adapted in
   two fresh engines, with the defaults and then under
   ``torch.use_deterministic_algorithms`` and ``cudnn.deterministic``:
   bit-equality, the largest difference and the adapt flush ms of each;
   then 6 pairs of adapt flushes at the VGG serving cell (8 requests at
   support 100), the settings toggled between flushes, an engine per
   setting (a replay runs what its capture ran under): both
   medians and ranges, the cost of the deterministic algorithms. It
   reports the phase's seconds (under 240 s, checked after ``timing``).
16. ``resnet`` (in the side process): the slice's full-width model,
   ResNet-12 at the fleet row
   ``omniglot.20.1.resnet-12.gd`` (28x28x1, 20-way 1-shot, meta-batch 8,
   K=5, second order, MSL on, fused, remat off): 5 train steps, an eval
   step and the engine serving the trained state, B1 and B2 over the
   86-leaf tree on every inner step; the first step against the CPU and
   float64 as in ``train``; then one bf16_inner train step (B1 and B2 in
   bfloat16).
17. ``remat`` (in the side process): ``configs/mini_imagenet_5way_5shot.yaml`` with
    ``net=resnet-12`` (84x84x3, 5-way 5-shot) under the remat policies
    none, full and dots_saveable: the first step's loss and meta-gradient
    equal across them, dots_saveable's peak memory between full's and
    none's, no Python dispatch call under dots_saveable; one eager step per
    policy, wall and host CPU ms; a chunk of 3 steps replayed from a CUDA
    graph under dots_saveable; the default
    config's VGG at none and full, peak memory.
18. ``breadth`` (in the side process): ``train_step`` for DenseNet-8 and
    DenseNet-12 (fused),
    inner Adam with learnable betas and the warm start, inner Rprop, and
    ``lslr_per_step`` (fused; its per-step lr meta-gradient against the
    CPU).
19. ``programs`` (after ``operations``, on phase ``runner``'s image folder):
    the program layer. B1 and B2 captured in one CUDA graph at the VGG-64
    and ResNet-12 trees, replayed on changed operands: bit-equal to their
    twins (``dlr`` within its bound). (a) The VGG train cell (the default
    config, meta-batch 8, K=5, second order, MSL on): a chunk of 3 steps
    replayed from a graph of the train step (``train_step_multi``) against
    3 eager steps from one state, five eager runs giving the floor (2x
    the largest difference over their 10 pairs) for the graph and for two replays; a fresh
    system under the deterministic algorithms: graph and eager bit-equal.
    (b) ResNet-12 (``omniglot.20.1.resnet-12.gd``), a chunk of 3 against 3
    eager steps under the deterministic algorithms (its float32 rollout is
    too chaotic for a default-run gate): the first loss within 2e-3, and
    graph and eager, and two replays, bit-equal (or, where an op warned,
    within 2x the difference of a second eager run). (c)
    ``eval_step_multi`` over 8 batches against 8 eval steps, deterministic:
    equal. (d) The runner with ``train_steps_per_dispatch=3``,
    ``eval_fused_dispatch`` and ``profile_dir``, 2 epochs of 3 steps (the
    profiled epoch keeps K=1): the ledger's ``train_multi``,
    ``eval_multi`` and ``nvcc/*`` lines, ``flops_per_step`` and ``mfu`` in
    the telemetry, the trace's breakdown with compute above half. It
    reports per-step periods graph against eager, capture seconds, pool
    bytes, kernels per step, busy shares (the union of the trace's device
    intervals over the wall time), B1/B2 per replay (the profiler's, which
    must equal the tally the capture recorded) and their ms per launch
    inside a replay (the profiler's), under 120 s.
20. ``prewarm`` (after ``programs``, on phase ``runner``'s image folder;
    budget 120 s): the training-side prewarm and the program layer on a
    mesh, at the default VGG config. (a) Two fresh training CLI processes,
    2 epochs of 3 steps at ``train_steps_per_dispatch=3`` with the MSL
    window closing after epoch 0 (epoch 1 flips the train variant), the
    fused eval and the strict guard, each under the deterministic
    algorithms (turned on in its own process): ``aot.enabled`` off and on.
    Per-step losses bit-equal, zero guard violations, and in the
    prewarmed leg no capture or first dispatch outside
    ``phase="prewarm"``; each leg's cold start, the prewarm's seconds per
    program, the first dispatch of epoch 1 (the flip), the ledger by
    phase, B1/B2 launches. (b) The prewarmed leg again on its run
    directory for a third epoch: the manifest's ``expected_warm``, every
    ``nvcc/*`` line a cache hit, the captures it pays again. (c) A dp=2
    mesh of ``[cuda:0, cuda:0]``: a chunk of 3 sharded steps replayed from
    one CUDA graph against the sharded eager steps, bit-equal (the
    deterministic algorithms), the replayed step beside the eager one, B1
    and B2 per replay, and the fused eval on the mesh.
20b. ``diagnostics`` (after ``prewarm``, on phase ``runner``'s run
    directory and image folder; budget 60 s): the card-against-CPU tools
    of ``howtotrainyourmamlpytorch_tpu_torch/scripts/`` through their
    ``main(argv)`` in this process. The precision probe's ``compare`` of
    the default model's meta-gradient (20-way 5-shot, 2 tasks) under
    ``highest`` and ``high`` against a CPU ``save`` made in the CPU twin
    (cosine under ``highest`` >= 0.98); the autopsy of every checkpoint on
    the card, and of checkpoint 0 on the CPU in the twin (accuracies within
    0.05); the stream replay from
    checkpoint 0, whose batches must be the ones the runner consumed after
    it (digests equal; losses beside the runner's); the descent probe (its
    loss falls); the donation probe (``clean``); ``imagenet_at_scale`` at
    84x84x3 with ResNet-12 5-way 5-shot, 2 steps, on a tree of 32 classes
    x 20 images; the sweep launcher's ``--dry-run`` (324 jobs) and its
    job 0 on the card (started before phase ``programs`` behind a gate and
    run during ``prewarm``, ``launch_all --select 0 --in-process``), then
    ``summarize_run`` on its run directory. B1 and B2 launch the counts each tool's steps imply.
21. ``kernels``: every kernel the run launched, with its launches on the
    paths (the wrappers' counts; a replay adds its graph's captured tally,
    ``core/programs.py``), its error against the twin and its times beside
    its bound and inside a replayed graph.

Fresh processes start early, behind gate files, so that their imports and
card start (10-25 s each) overlap the phases before them: phase ``http``'s
two servers and the side process from phase ``slice`` on, ``fleet``'s
first two backends during ``tenancy``, ``elastic``'s three CLI legs during
``runner``, ``operations``' strict serve CLI during ``tensor_parallel``,
``prewarm``'s three CLI legs and ``diagnostics``' sweep job during
``programs`` (and the runner's CLI legs within their phase). The side
process runs phases ``small`` and ``resnet`` on the card beside phases
``http`` and ``tenancy``, then ``remat``, ``breadth`` and ``precision``
beside phase ``runner`` (SIDE_BATCHES: card-bound, gating no time, needing
nothing of the phases before them; ``http``, ``tenancy`` and ``runner``
have no time budget, and their card mostly waits on processes, sockets and
the loader), and phase ``bench``'s three children and phase ``lint``'s two
beside ``http`` and ``tenancy``; this process waits for each batch before
phases ``fleet`` and ``elastic``, and prints the side's lines when it ends. Phase ``operations``' training fleet (its
leg 4: child processes behind the card gate) starts before phase
``elastic`` on a thread of this process and runs beside ``elastic`` and
``tensor_parallel``; ``operations`` checks it. Each is released where its phase used to start it; a
process whose parent is gone exits. Two processes start after phase
``device`` and work at once: the runner's image folder and index, and
the CPU twin, which makes the CPU halves of the cross-checks of phases
``slice``, ``train`` and ``strategies`` while the card runs the phases up
to ``fleet``, then ``diagnostics``' CPU half (its autopsy waits for the
runner's checkpoints).

A ``timing`` line before the ``kernels`` line gives each phase's wall
seconds and the run's wall time (``total_s``, from phase ``device`` to the
side process's end: the side phases overlap others, so it is not their
sum), which the run's budget holds. Then the card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line. Matmuls and convolutions run in IEEE float32 (no TF32)
throughout but in phase ``precision``: ``MAMLSystem`` applies the config's
``matmul_precision`` (``default``: IEEE float32), here and in the CLI
subprocesses alike, so the card computes the float32 the CPU cross-checks
compute.
"""

import argparse
import hashlib
import json
import os
import pickle
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
L2_FLUSH_BYTES = 64 << 20  # more than the 50 MB L2
FLUSHES = ("write", "read")
# Full width, card against CPU, both float32 with TF32 off. The sums run in
# other orders (cuDNN against the CPU's convolutions), and at a random init
# this model's early-layer gradients are ill-conditioned in float32 (each
# BN removes its channel's mean and scale, so they are small differences of
# large terms); 5 inner steps at lr 0.1 amplify the last-bit differences.
# So the float32 result of EITHER device is only ~1e-2 from a float64
# reference of the same requests (printed as float64_max_abs). The checks:
# card and CPU within CPU_TOLERANCE, and the card no further from float64
# than F64_FACTOR times the CPU's distance. The phase ``small`` holds the
# same code to SMALL_TOLERANCE where float32 is well conditioned.
CPU_TOLERANCE = 5e-2
F64_FACTOR = 3.0
# small, well-conditioned input (2 stages, 8 filters, 3-way, 2 steps)
SMALL_TOLERANCE = 1e-5
FLUSH_TOLERANCE = 1e-5
SUM_TOLERANCE = 1e-5
# Training at full width, card against CPU (float32 both, TF32 off) and
# each against the port's plain path in float64 on the CPU. At a random
# init the 5-step rollout amplifies last-bit differences (as in the serving
# phase): in the first measuring run each device's first-step loss was
# 3.6e-4 (CPU) and 9.2e-4 (card) from float64, and its meta-gradient at
# cosine 0.9936 (CPU) and 0.9997 (card) from float64. So the checks are:
# the losses within LOSS_RTOL of each other (two float32 results each ~1e-3
# from float64; 1e-4 is not attainable here); the meta-gradient, compared at
# CROSS_TASKS tasks (the CPU's second-order step at 8 tasks costs minutes),
# at cosine >= GRAD_COSINE_F64 from float64 on the card and >= GRAD_COSINE
# between card and CPU (two vectors each within angle t of the exact one
# can be 2t apart: cosine 0.975 for the CPU's 0.9936), and the card no
# further from float64 than F64_FACTOR times the CPU. No elementwise bound
# is stated: the conv biases' meta-grads are float32 noise (exactly zero in
# exact arithmetic under transductive BN).
LOSS_RTOL = 2e-3
GRAD_COSINE = 0.98
GRAD_COSINE_F64 = 0.99
CROSS_TASKS = 2
TRAIN_STEPS = 10
RESNET_STEPS = 3  # phase resnet's train steps (phase programs trains ResNet-12 too)
EVAL_STEPS = 3
# 10 outer steps on one batch must lower the loss at least this much
TRAIN_DROP = 0.9
TASKS = 8  # the main paths' task batch: an adapt flush, a train step
RAGGED = (1, 3, 20, 129, 4097)
# the runner phase: Omniglot's layout and sizes, the run's length
OMNIGLOT = {"classes": 1623, "per_class": 20, "alphabets": 50, "side": 105}
RUNNER_EPOCHS, RESUMED_EPOCHS, RUNNER_ITERS, RUNNER_EVAL_TASKS = 2, 3, 5, 40
# the runner phase's CLI legs, cut to make room for phase fleet: one batch
# of evaluation tasks each, one step for the fresh ResNet-12 and anil runs
# (the resume keeps RUNNER_ITERS: its loader cursor depends on it), and the
# resume reads images from disk (the in-process run tests the RAM cache)
CLI_ITERS, CLI_EVAL_TASKS = 1, 8
RUNNER_PROFILED_CALL = 5  # one train step of epoch 0 runs under the profiler
LOADER_BATCHES = 50
# the JAX package's summary_statistics.csv columns (tests/test_torch_runner.py
# holds the port's to the JAX runner's on the CPU)
SUMMARY_COLUMNS = [
    "epoch", "train_loss_mean", "train_loss_std", "train_accuracy_mean", "train_accuracy_std",
    "learning_rate", "epoch_run_time", "val_loss_mean", "val_loss_std", "val_accuracy_mean",
    "val_accuracy_std", "val_accuracy_ci95", "val_num_episodes",
]
DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "default.yaml")
MINI_IMAGENET_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "mini_imagenet_5way_5shot.yaml")
# the slice's full-width model: the fleet row omniglot.20.1.resnet-12.gd of
# configs/fleet_accuracy_omniglot.yaml (ResNet-12 at 32/64/128/256, 3
# BasicBlocks per stage; 28x28x1, 20-way 1-shot, 1 target per class;
# remat off, as the fleet's base overrides set it)
RESNET_OVERRIDES = ["net=resnet-12", "num_classes_per_set=20", "num_samples_per_class=1", "num_target_samples=1"]
RESNET_LEAVES = 86
MANY_LEAVES = 220  # the synthetic tree past 200 leaves: 1 to 3,000 elements each
# ResNet-12 card against CPU at K=1 (random init, class-structured batch).
# In the first measuring run the 8-task loss lay 1.1e-4 (card) and 3.1e-5
# (CPU) from float64 and the meta-gradient at cosine 0.999997 (card) and
# 0.999986 (CPU) from float64, 0.999988 apart; the gates are ~10x and
# ~100x those spreads. At the fleet row's K=5 the meta-gradient lay at
# cosine 0.72-0.87 from float64 on either device (once reported, never
# gated; no longer run: it took ~27 s of the run's time limit).
RESNET_CROSS = {"loss_rtol": 1e-3, "cosine": 0.999, "cosine_f64": 0.999}
REMAT_POLICIES = ("none", "full", "dots_saveable")
# the steps of dots_saveable's chunk replayed from a CUDA graph (its graph
# captures the recompute and the record/replay mode; phase programs
# replays graphs without remat; scripts/remat_probe.py times every
# policy's eager steps over rounds in turn and replays each policy's graph)
REMAT_CHUNK = 3
# remat against none on the card (cuDNN deterministic): the same forward,
# so the loss bit-equal; the recompute's gradient sums add the same terms
# in another order, so the meta-gradient within REMAT_GRAD_RTOL of its
# largest element
REMAT_GRAD_RTOL = 1e-5
# the strategies phase: the fleet row omniglot.20.5.vgg.gd.anil of
# configs/fleet_accuracy_omniglot.yaml, whose shape is configs/default.yaml
# (VGG-64, 20-way 5-shot, 1 target, meta-batch 8, K=5, second order, MSL;
# remat off, as the fleet's base overrides set it); the engine serves the
# four strategies from its trained state
STRATEGIES = ("maml++", "fomaml", "anil", "protonet")
HEAD_LEAVES = 2  # fc/b and fc/w: what B1 and B2 cover under anil
SERVE_REPS = 3  # timed flushes per strategy, after one untimed
# A lone request against its place in a padded flush, cuDNN deterministic:
# the two differ only in float32 rounding (cuDNN picks its algorithms, and
# so its summation orders, by the batch's shape), so the bound is the
# larger of ALONE_TOLERANCE and how far the same request moves when its
# support images move by NOISE_SCALE (the rollout's own float32 noise
# floor). The maml++ rollout at this config is chaotic: on the CPU such a
# 1e-6 change moved its probabilities by 5e-3 (anil's by 4e-7), and on an
# H100 its lone request lay 9.6e-4 from the flush in one of three runs. A
# padding fault (padded samples in the BN statistics or the loss) moves
# them by far more. protonet's logits are squared distances of ~1e2, so it
# takes the slice phase's FLUSH_TOLERANCE (1.8e-6 in the first run).
ALONE_TOLERANCE = {"maml++": 1e-6, "fomaml": 1e-6, "anil": 1e-6, "protonet": FLUSH_TOLERANCE}
NOISE_SCALE = 1e-6
# the anil step on the card against the CPU at a small size (2 stages, 8
# filters, 3-way 2-shot, K=2), where float32 is well conditioned: the loss
# relative, the meta-gradient of head and body of its largest element
SMALL_TRAIN_TOLERANCE = 1e-5
# the precision phase: train steps per Config.matmul_precision value, the
# first one untimed
PRECISION_STEPS = 6
# the http phase: concurrent clients, /adapt requests each (support 100 of
# 20-way 5-shot), queries per /predict; seconds to wait for a server to
# answer /healthz, and for one HTTP call
HTTP_CLIENTS, HTTP_PER_CLIENT, HTTP_QUERIES = 8, 4, 40
HTTP_READY_S, HTTP_CALL_S = 240, 120
# phase tenancy: the tenants, the round-robin rounds over them and the
# default tenant, and the in-process page-ins per tenant
TENANT_IDS = ("acme", "bravo", "charlie", "delta")
TENANT_ROUNDS = 3
PAGE_IN_REPS = 10
# phase fleet: where the backends run; loadgen's offered load through the
# gateway (req/s per stair, stairs, seconds in all) and when, after its
# clock starts, one backend is killed; /predict pairs timed through the
# gateway and direct
FLEET_DEVICE = "cuda"
FLEET_RPS, FLEET_STAIRS, FLEET_LOAD_S, FLEET_KILL_AT_S = 4.0, 3, 15.0, 6.0
FLEET_HOP_REPS = 4
FLEET_BUDGET_S = 150.0  # the phase's share of the run's time limit
# phase elastic: the data-parallel widths on the one card (dp=1 is the
# plain single-device step), timed steps per width after one untimed, the
# runner legs' steps per epoch, and the gate of the sharded step against
# dp=1: ELASTIC_FLOOR_FACTOR times the card's float32 floor, at least
# ELASTIC_MIN_RTOL; the fault drill of the SIGTERM-during-save leg
ELASTIC_DEVICE = "cuda"
ELASTIC_DPS = (1, 2, 4)
ELASTIC_STEPS = 2
ELASTIC_ITERS = 2
ELASTIC_FLOOR_FACTOR = 2.0
ELASTIC_MIN_RTOL = 1e-6
ELASTIC_FAULT = "checkpoint.write=sigterm:nth=2"
ELASTIC_FAULT_EPOCHS = 3  # the fault chain's run: the SIGTERM lands in its second save, the resume ends it
ELASTIC_BUDGET_S, RUN_BUDGET_S = 90.0, 900.0
# phase operations: the campaign's episodes, the full-width strict frontend's
# traffic (requests, client threads, warm single adapts and the gate of the
# first /adapt after ok against their median), the runner legs' steps, the
# fleet cells' depth and first-attempt fault, and the phase's time budget
OPS_DEVICE = "cuda"
OPS_EPISODES = 8
OPS_REQUESTS, OPS_CLIENTS, OPS_WARM_ADAPTS, OPS_FIRST_ADAPT_FACTOR = 64, 8, 5, 2.0
OPS_RUNNER_ITERS = 3
OPS_FLEET_DEPTH = ["total_epochs=1", "total_iter_per_epoch=3", "num_evaluation_tasks=8"]
OPS_FLEET_FAULT = "runner.step=sigterm:nth=2"
OPS_SERVE_OVERRIDES = ("use_pallas_inner_update=true", "remat_inner_steps=false", "strict_recompile_guard=true",
                       "aot.enabled=true", "resilience.sanitizer=true")
OPERATIONS_BUDGET_S = 240.0


class CheckFailed(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, phase: str, what: str, **detail) -> None:
    if not ok:
        emit({"phase": phase, "ok": False, "failed": what, **detail})
        raise CheckFailed(f"{phase}: {what} {detail}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 100, flush: str = "write") -> float:
    """Median device time of ``fn`` in ms: CUDA events around each call, the
    L2 cache flushed before each, all enqueued behind a sleep kernel so that
    host launch latency does not open gaps inside the timed intervals.
    ``flush="write"`` zeroes 64 MB (the parent design's yardstick; it leaves
    the L2 full of dirty lines, whose write-back the timed call may pay),
    ``"read"`` sums them (it leaves clean lines)."""
    scratch = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    clear = {"write": scratch.zero_, "read": scratch.sum}[flush]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        clear()
        fn()
    host_s = (time.perf_counter() - t0) / 5
    torch.cuda.synchronize()
    # long enough for the host to enqueue every call before the card gets there
    torch.cuda._sleep(int(max(200_000_000, 4e9 * reps * host_s)))
    events = []
    for _ in range(reps):
        clear()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def both_flushes(fn) -> dict:
    return {flush: time_ms(fn, flush=flush) for flush in FLUSHES}


def in_turns(first, second) -> tuple:
    """Two versions timed first, second, second, first under each flush;
    per flush the mean of each one's two medians."""
    a, b = {}, {}
    for flush in FLUSHES:
        t = [time_ms(f, flush=flush) for f in (first, second, second, first)]
        a[flush], b[flush] = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    return a, b


def start_parent_build(parent_dir: str):
    """Start ``nvcc`` on the parent design's two sources (the packed
    ``[rows, 128]`` B1 and B2, copies taken from git history into a
    directory outside the repository's files) with the port's flags, into a
    temporary directory; they build beside the port's own kernels."""
    from howtotrainyourmamlpytorch_tpu_torch.ops import _kernels

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_parent_")
    procs = {}
    for src in ("fused_sgd.cu", "fused_sgd_bwd.cu"):
        lib = os.path.join(out_dir, f"lib{os.path.splitext(src)[0]}.so")
        cmd = [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", lib, os.path.join(parent_dir, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return out_dir, procs


def finish_parent_build(out_dir: str, procs):
    """The parent's two C functions, loaded with their signatures."""
    import ctypes

    libs = {}
    for src, (proc, lib) in procs.items():
        output, _ = proc.communicate()
        check(proc.returncode == 0, "device", f"the parent's {src} did not build", output=output[-2000:])
        libs[src] = ctypes.CDLL(lib)
    shutil.rmtree(out_dir, ignore_errors=True)  # the loaded libraries stay mapped
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fwd = libs["fused_sgd.cu"].fused_sgd_forward  # (p, g, lr_rows, out, n_rows, dtype, stream)
    fwd.argtypes, fwd.restype = [ptr, ptr, ptr, ptr, i64, i32, ptr], i32
    bwd = libs["fused_sgd_bwd.cu"].fused_sgd_backward  # (ct, g, lr_rows, dg, dlr_rows, n_rows, dtype, stream)
    bwd.argtypes, bwd.restype = [ptr, ptr, ptr, ptr, ptr, i64, i32, ptr], i32
    return {"forward": fwd, "backward": bwd}


def phase_device(parent_dir=None):
    from howtotrainyourmamlpytorch_tpu_torch.ops import _kernels

    smi = nvidia_smi()
    t0 = time.perf_counter()
    parent_build = start_parent_build(parent_dir) if parent_dir else None
    report = _kernels.build()
    parent = finish_parent_build(*parent_build) if parent_build else None
    build_s = time.perf_counter() - t0
    ptxas = {
        src: [line.strip() for line in r["ptxas"].splitlines() if "registers" in line or "spill" in line]
        for src, r in report.items()
    }
    # the 256-leaf table's launches need CUDA 12.1 or later (toolkit and
    # NVIDIA driver): the parameter space past 4 KB
    nvcc = subprocess.run([_kernels.nvcc_path(), "--version"], capture_output=True, text=True, timeout=60).stdout
    nvidia_driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                                   capture_output=True, text=True, timeout=60).stdout.strip()
    emit({
        "phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": nvcc.strip().splitlines()[-1] if nvcc.strip() else "", "nvidia_driver": nvidia_driver,
        "build_s": build_s, "ptxas": ptxas, "parent_kernels": parent_dir, "ok": True,
    })
    return smi, parent


def full_width_system(seed: int, overrides=(), config: str = DEFAULT_CONFIG, device=None):
    """A repository config (default: configs/default.yaml) with the fused
    update and remat off, then ``overrides``, on the card (or ``device``),
    seeded. (Remat off is the program phases slice, train, serve_trained
    and runner measured before remat applied in the port.)"""
    from howtotrainyourmamlpytorch_tpu_torch.config import load_config
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem

    cfg = load_config(config, ["use_pallas_inner_update=true", "remat_inner_steps=false", *overrides])
    system = MAMLSystem(cfg, device=device)
    return cfg, system, system.init_train_state(seed)


def _digest(*trees) -> str:
    """sha256 of every tensor and array in ``trees`` (dicts by sorted key,
    sequences in order): the CPU twin's inputs against the card's."""
    h = hashlib.sha256()

    def walk(o):
        if isinstance(o, dict):
            for k in sorted(o):
                h.update(str(k).encode())
                walk(o[k])
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
        elif isinstance(o, torch.Tensor):
            h.update(o.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(np.ascontiguousarray(o).tobytes())

    walk(trees)
    return h.hexdigest()


def cpu_copy(state):
    """The same weights on the CPU."""
    from howtotrainyourmamlpytorch_tpu_torch.core.train_state import TrainState
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_map

    to_cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)  # noqa: E731
    return TrainState(to_cpu(state.params), to_cpu(state.bn_state), to_cpu(state.inner_hparams),
                      None, state.step.cpu())


def main_path_tree(seed: int, dtype, salt: int, cotangents: bool = False, overrides=()):
    """The tree B1 and B2 take on the main paths: the default model's
    parameters (or with ``overrides`` another's: RESNET_OVERRIDES, the
    ResNet-12 tree) stacked over TASKS tasks (an adapt flush, a train step),
    or random cotangents of their shapes, random grads (``salt`` varies
    them), and distinct lrs as 0-d views of one tensor."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    _, _, state = full_width_system(seed, overrides)
    gen = torch.Generator(device="cuda").manual_seed(seed + salt)
    ps = [a.unsqueeze(0).expand(TASKS, *a.shape).contiguous().to(dtype) for a in tree_leaves(state.params)]
    if cotangents:
        ps = [torch.randn(p.shape, device="cuda", generator=gen).to(dtype) for p in ps]
    gs = [torch.randn(p.shape, device="cuda", generator=gen).to(dtype) for p in ps]
    lrs = list(torch.linspace(0.01, 0.2, len(ps), device="cuda").unbind())
    return ps, gs, lrs


def head_tree(seed: int, dtype, salt: int, cotangents: bool = False):
    """The tree B1 and B2 take under anil: the default model's classifier
    head (``fc``: 2 leaves, 1,300 parameters at 20-way) over TASKS tasks,
    as ``main_path_tree`` makes it."""
    ps, gs, lrs = main_path_tree(seed, dtype, salt, cotangents)
    # sorted-key order puts the head's two leaves (fc/b, fc/w) first
    return ps[:HEAD_LEAVES], gs[:HEAD_LEAVES], lrs[:HEAD_LEAVES]


def ragged_tree(seed: int, dtype):
    """Leaves of RAGGED elements (every rest length): the 129-element
    leaf's two operands both start 4 bytes past a 16-byte boundary and the
    4,097-element leaf's first operand alone does: the two leaves the
    kernels read element by element."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)

    def leaf(n, offset):
        shift = 4 // torch.empty((), dtype=dtype).element_size() if offset else 0
        return torch.randn(n + shift, device="cuda", generator=gen).to(dtype)[shift:]

    ps = [leaf(n, n in (129, 4097)) for n in RAGGED]
    gs = [leaf(n, n == 129) for n in RAGGED]
    lrs = list(torch.rand(len(ps), device="cuda", generator=gen).unbind())
    return ps, gs, lrs


def many_tree(seed: int, dtype):
    """MANY_LEAVES leaves of 1 to 3,000 elements: past the 64-leaf table
    and most of the way to the 256-leaf one."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    sizes = [1 + (37 * i) % 3000 for i in range(MANY_LEAVES)]
    ps = [torch.randn(n, device="cuda", generator=gen).to(dtype) for n in sizes]
    gs = [torch.randn(n, device="cuda", generator=gen).to(dtype) for n in sizes]
    lrs = list(torch.rand(len(ps), device="cuda", generator=gen).unbind())
    return ps, gs, lrs


def kernel_trees(seed: int, dtype, salt: int, cotangents: bool = False) -> dict:
    """Every tree the kernel phases hold B1 and B2 to their twins on: the
    ragged tree, the main paths' VGG-64 tree, its anil head and the
    ResNet-12 tree over TASKS tasks, and MANY_LEAVES small leaves."""
    return {
        "ragged": ragged_tree(seed, dtype),
        "vgg64": main_path_tree(seed, dtype, salt, cotangents),
        "anil_head": head_tree(seed, dtype, salt, cotangents),
        "resnet12": main_path_tree(seed, dtype, salt, cotangents, RESNET_OVERRIDES),
        "many220": many_tree(seed + salt, dtype),
    }


def packed(leaves):
    """The leaves end to end in a ``[rows, 128]`` buffer (zero padded): the
    parent design's layout and the library calls' operand, the same
    elements up to the last row."""
    flat = torch.cat([t.reshape(-1) for t in leaves])
    rows = -(-flat.numel() // 128)
    return torch.nn.functional.pad(flat, (0, rows * 128 - flat.numel())).view(rows, 128)


def vectors_of(ps, gs):
    """Per leaf, whether the kernels read it in vectors: both operands (and
    the output, which the allocator aligns) on 16-byte boundaries."""
    return [p.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0 for p, g in zip(ps, gs)]


def _timing_gen():
    """The generator of a timed library call's learning-rate column (its
    values change no time)."""
    return torch.Generator(device="cuda").manual_seed(0)


def head_timing(ps, gs, lrs, launch, twin, backward: bool) -> dict:
    """B1 (or B2 where ``backward``) at the anil head tree under both
    flushes, beside an empty kernel (the floor), its twin, the byte bound
    and, for B1, ``torch.addcmul`` over the packed leaves."""
    n = sum(p.numel() for p in ps)
    moved = 3 * n * ps[0].element_size() + (8 if backward else 4) * len(lrs)
    out = {
        "ms": both_flushes(lambda: launch(ps, gs, lrs)),
        "plain_ms": both_flushes(lambda: twin(ps, gs, lrs)),
        "floor_ms": both_flushes(lambda: torch.cuda._sleep(0)),
        "library_ms": None, "bytes": moved, "elements": n, "leaves": len(ps),
        "bound_ms": max(moved / H100_BYTES_PER_S, (3 if backward else 2) * n / H100_F32_FLOPS) * 1e3,
    }
    if not backward:
        p_buf, g_buf = packed(ps), packed(gs)
        lr_col = torch.rand(p_buf.shape[0], device="cuda", generator=_timing_gen())[:, None]
        out["library_ms"] = both_flushes(lambda: torch.addcmul(p_buf, lr_col, g_buf, value=-1))
    return out


def phase_kernel(seed: int, parent):
    """B1 against its twin at every tree of ``kernel_trees`` (the ragged
    tree, the VGG-64 tree, its anil head and the ResNet-12 tree over 8
    tasks, 220 small leaves), in float32 and bfloat16: bit-equal. Then its
    times under both flushes: at the VGG-64 tree beside the parent design's
    (in turns), an empty kernel's, the twin's and two library yardsticks;
    at the ResNet-12 tree beside the twin's, ``torch.addcmul``'s and the
    byte bound; at the anil head beside the floor, the twin,
    ``torch.addcmul`` and the bound; at the 220-leaf tree alone."""
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu

    codes = {torch.float32: 0, torch.bfloat16: 1}
    result = {"tasks": TASKS}
    worst = 0.0
    fu.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        trees = kernel_trees(seed, dtype, 0)
        for tree, (ps, gs, lrs) in trees.items():
            ref = fu.fused_sgd_tree_reference(ps, gs, lrs)
            out = fu._launch_forward(ps, gs, lrs)
            torch.cuda.synchronize()
            err = max(float((o.float() - r.float()).abs().max()) for o, r in zip(out, ref))
            worst = max(worst, err)
            check(all(torch.equal(o, r) for o, r in zip(out, ref)), "kernel", "kernel differs from its twin",
                  dtype=name, tree=tree, max_abs_err=err, leaves=len(ps))
        check(fu.contiguous_copies == 0, "kernel", "a leaf was copied", contiguous_copies=fu.contiguous_copies)
        vectors = vectors_of(*trees["ragged"][:2])
        check(vectors.count(False) == 2, "kernel", "the ragged tree misses the element-by-element paths",
              vectors=vectors)
        ps, gs, lrs = trees["resnet12"]
        check(len(ps) == RESNET_LEAVES, "kernel", "the ResNet-12 tree", leaves=len(ps))
        deep = {
            "ms": both_flushes(lambda: fu._launch_forward(ps, gs, lrs)),
            "plain_ms": both_flushes(lambda: fu.fused_sgd_tree_reference(ps, gs, lrs)),
        }
        p_buf, g_buf = packed(ps), packed(gs)
        lr_col = torch.rand(p_buf.shape[0], device="cuda", generator=_timing_gen())[:, None]
        deep["library_ms"] = both_flushes(lambda: torch.addcmul(p_buf, lr_col, g_buf, value=-1))
        del p_buf, g_buf
        n = sum(p.numel() for p in ps)
        moved = 3 * n * ps[0].element_size() + 4 * len(lrs)
        deep.update(bytes=moved, elements=n, leaves=len(ps),
                    bound_ms=max(moved / H100_BYTES_PER_S, 2 * n / H100_F32_FLOPS) * 1e3)
        deep["reach"] = {flush: deep["bound_ms"] / deep["ms"][flush] for flush in FLUSHES}
        ps, gs, lrs = trees["many220"]
        many_ms = both_flushes(lambda: fu._launch_forward(ps, gs, lrs))
        head = trees["anil_head"]
        ps, gs, lrs = trees["vgg64"]
        del trees
        n = sum(p.numel() for p in ps)
        moved = 3 * n * ps[0].element_size() + 4 * len(lrs)  # read p, g, lr; write out
        p_buf, g_buf = packed(ps), packed(gs)
        lr_rows = torch.rand(p_buf.shape[0], device="cuda", generator=_timing_gen())
        lr_col, lr_values = lr_rows[:, None], [float(x) for x in lrs]
        new = lambda: fu._launch_forward(ps, gs, lrs)  # noqa: E731
        timing = {}
        if parent:
            out_buf = torch.empty_like(p_buf)
            stream = torch.cuda.current_stream().cuda_stream
            args = (p_buf.data_ptr(), g_buf.data_ptr(), lr_rows.data_ptr(), out_buf.data_ptr(),
                    p_buf.shape[0], codes[dtype], stream)
            check(parent["forward"](*args) == 0, "kernel", "the parent's B1 did not launch")
            torch.cuda.synchronize()
            check(torch.equal(out_buf, (p_buf.float() - lr_col * g_buf.float()).to(dtype)), "kernel",
                  "the parent's B1 differs from its twin", dtype=name)
            timing["parent_ms"], timing["ms"] = in_turns(lambda: parent["forward"](*args), new)

            # the parent design's forward as the port ran it: the tree packed
            # into [rows, 128] buffers (pad + cat), then its kernel
            def parent_with_pack():
                p_rows, g_rows = packed(ps), packed(gs)
                parent["forward"](p_rows.data_ptr(), g_rows.data_ptr(), lr_rows.data_ptr(), out_buf.data_ptr(),
                                  p_rows.shape[0], codes[dtype], stream)

            timing["parent_with_pack_ms"] = both_flushes(parent_with_pack)
        else:
            timing["ms"], timing["parent_ms"] = both_flushes(new), "not measured (no --parent-kernels)"
        timing.update({
            "plain_ms": both_flushes(lambda: fu.fused_sgd_tree_reference(ps, gs, lrs)),
            # the yardstick's own floor: an empty kernel timed the same way
            "floor_ms": both_flushes(lambda: torch.cuda._sleep(0)),
            # one PyTorch call of the same arithmetic at the same bytes over
            # the packed buffer (float32 result for bf16 operands: the f32 lr
            # column promotes it); timed only
            "library_ms": both_flushes(lambda: torch.addcmul(p_buf, lr_col, g_buf, value=-1)),
            # for information: two foreach calls over the tree (the product
            # rounded to the operand dtype: not the same arithmetic in bf16)
            "foreach_ms": both_flushes(lambda: torch._foreach_sub(ps, torch._foreach_mul(gs, lr_values))),
        })
        result[name] = {
            **timing,
            "bound_ms": max(moved / H100_BYTES_PER_S, 2 * n / H100_F32_FLOPS) * 1e3,
            "bytes": moved, "elements": n, "leaves": len(ps), "parent_rows": p_buf.shape[0],
            "ragged_vectors": vectors, "resnet12": deep,
            "many220": {"ms": many_ms, "leaves": MANY_LEAVES},
            "anil_head": head_timing(*head, fu._launch_forward, fu.fused_sgd_tree_reference, backward=False),
        }
    result["max_abs_err"] = worst
    emit({"phase": "kernel", "ok": True, **result})
    return result


def dlr_bound(cts, gs):
    """Per leaf, how far B2's ``dlr`` may lie from the exact sum:
    (longest chain + 1) * 2**-24 * sum|ct * g| (``fu.dlr_rounding_chain``:
    one rounding per link, the products exact in float64). Returns (exact
    ``dlr`` in float64, bound, sum|ct * g|)."""
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu

    exact, bound, mags = [], [], []
    starts = fu.chunk_starts(cts, gs)
    for i, (ct, g) in enumerate(zip(cts, gs)):
        prod = ct.double() * g.double()
        chain = fu.dlr_rounding_chain(starts[i + 1] - starts[i], ct.element_size())
        mag = float(prod.abs().sum())
        exact.append(-float(prod.sum()))
        mags.append(mag)
        bound.append((chain + 1) * 2.0**-24 * mag)
    return torch.tensor(exact, dtype=torch.float64), torch.tensor(bound, dtype=torch.float64), mags


def phase_kernel_bwd(seed: int, parent):
    """B2 against its twin at every tree of ``kernel_trees``, in float32 and
    bfloat16: ``dg`` bit-equal, ``dlr`` within the bound of its summation
    tree from a float64 sum and bit-equal across launches. Its times as
    B1's, at the anil head too (no single library call computes ``dg`` and
    ``dlr``).
    Then the FusedSGD gradients on the card
    against the same Function on the CPU for the objective sum(out * w)."""
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu

    codes = {torch.float32: 0, torch.bfloat16: 1}
    result = {"tasks": TASKS}
    worst = 0.0
    fu.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        trees = kernel_trees(seed, dtype, 1, cotangents=True)
        for tree, (cts, gs, lrs) in trees.items():
            ref_dg, ref_dlr = fu.fused_sgd_tree_bwd_reference(cts, gs, lrs)
            exact, bound, _ = dlr_bound(cts, gs)
            first = None
            for _ in range(2):
                dg, dlr = fu._launch_backward(cts, gs, lrs)
                torch.cuda.synchronize()
                dg_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(dg, ref_dg))
                check(all(torch.equal(a, b) for a, b in zip(dg, ref_dg)), "kernel_bwd", "dg differs from its twin",
                      dtype=name, tree=tree, max_abs_err=dg_err)
                err = (dlr.double().cpu() - exact).abs()
                check(bool((err <= bound).all()), "kernel_bwd", "dlr outside the bound of its summation tree",
                      dtype=name, tree=tree, err=err.tolist(), bound=bound.tolist())
                check(first is None or torch.equal(dlr, first), "kernel_bwd", "dlr differs between launches",
                      dtype=name, tree=tree)
                first = dlr
            check(fu.contiguous_copies == 0, "kernel_bwd", "a leaf was copied", contiguous_copies=fu.contiguous_copies)
            worst = max(worst, dg_err, float(err.max()))
            result.setdefault(name, {})[tree] = {
                "dg_max_abs_err": dg_err, "dlr_max_abs_err": float(err.max()),
                "dlr_err_over_bound": float((err / bound).max()),
                "dlr_twin_max_abs_err": float((ref_dlr.double().cpu() - exact).abs().max()),
                "leaves": len(cts),
            }
        cts, gs, lrs = trees["resnet12"]
        n = sum(c.numel() for c in cts)
        moved = 3 * n * cts[0].element_size() + 8 * len(lrs)
        deep = {
            "ms": both_flushes(lambda: fu._launch_backward(cts, gs, lrs)),
            "plain_ms": both_flushes(lambda: fu.fused_sgd_tree_bwd_reference(cts, gs, lrs)),
            "library_ms": None, "bytes": moved, "elements": n, "leaves": len(cts),
            "bound_ms": max(moved / H100_BYTES_PER_S, 3 * n / H100_F32_FLOPS) * 1e3,
        }
        deep["reach"] = {flush: deep["bound_ms"] / deep["ms"][flush] for flush in FLUSHES}
        result[name]["resnet12"].update(deep)
        cts, gs, lrs = trees["many220"]
        result[name]["many220"]["ms"] = both_flushes(lambda: fu._launch_backward(cts, gs, lrs))
        result[name]["anil_head"].update(head_timing(*trees["anil_head"], fu._launch_backward,
                                                     fu.fused_sgd_tree_bwd_reference, backward=True))
        cts, gs, lrs = trees["vgg64"]
        del trees
        n = sum(c.numel() for c in cts)
        moved = 3 * n * cts[0].element_size() + 8 * len(lrs)  # read ct, g, lr; write dg, dlr
        ct_buf, g_buf = packed(cts), packed(gs)
        lr_rows = torch.rand(ct_buf.shape[0], device="cuda", generator=_timing_gen())
        lr_col = lr_rows[:, None]
        new = lambda: fu._launch_backward(cts, gs, lrs)  # noqa: E731
        timing = {}
        if parent:
            dg_buf, dlr_rows = torch.empty_like(ct_buf), torch.empty_like(lr_rows)
            stream = torch.cuda.current_stream().cuda_stream
            args = (ct_buf.data_ptr(), g_buf.data_ptr(), lr_rows.data_ptr(), dg_buf.data_ptr(),
                    dlr_rows.data_ptr(), ct_buf.shape[0], codes[dtype], stream)
            check(parent["backward"](*args) == 0, "kernel_bwd", "the parent's B2 did not launch")
            torch.cuda.synchronize()
            check(torch.equal(dg_buf, (-lr_col * ct_buf.float()).to(dtype)), "kernel_bwd",
                  "the parent's B2 differs from its twin", dtype=name)
            timing["parent_ms"], timing["ms"] = in_turns(lambda: parent["backward"](*args), new)
            # the parent design's backward with the lr segment-sum it left
            # outside (autograd's transpose of the lr gather; here one
            # index_add_ of the row sums into their leaves, for timing only)
            row_leaf = torch.repeat_interleave(
                torch.arange(len(cts), device="cuda"),
                torch.tensor([-(-c[0].numel() // 128) for c in cts], device="cuda")).repeat(TASKS)
            per_leaf = torch.zeros(len(cts), device="cuda")

            def parent_with_lr_sum():
                parent["backward"](*args)
                return per_leaf.zero_().index_add_(0, row_leaf[: dlr_rows.numel()], dlr_rows)

            timing["parent_with_lr_sum_ms"] = both_flushes(parent_with_lr_sum)
        else:
            timing["ms"], timing["parent_ms"] = both_flushes(new), "not measured (no --parent-kernels)"
        timing.update({
            "floor_ms": both_flushes(lambda: torch.cuda._sleep(0)),
            "plain_ms": both_flushes(lambda: fu.fused_sgd_tree_bwd_reference(cts, gs, lrs)),
            "library_ms": None,
            "library_note": "no single PyTorch call computes dg and dlr together",
            # for information only: torch.mul + torch.linalg.vecdot over the
            # packed buffer, two calls (per-row sums, not per-leaf)
            "two_call_ms": both_flushes(lambda: (torch.mul(ct_buf, lr_col), torch.linalg.vecdot(ct_buf, g_buf))),
        })
        result[name].update({
            **timing,
            "bound_ms": max(moved / H100_BYTES_PER_S, 3 * n / H100_F32_FLOPS) * 1e3,
            "bytes": moved, "elements": n, "leaves": len(cts),
        })
    result["max_abs_err"] = worst

    # the Function: card (B1 forward, B2 backward) against the CPU (twins)
    ps, gs, lrs = main_path_tree(seed, torch.float32, 2)
    cpu_gen = torch.Generator().manual_seed(seed + 2)
    ws = [torch.randn(p.shape, generator=cpu_gen) for p in ps]

    def grads_on(device):
        args = [t.detach().to(device).requires_grad_(True) for t in (*ps, *gs, *lrs)]
        outs = fu.FusedSGD.apply(len(ps), *args)
        sum((o * w.to(device)).sum() for o, w in zip(outs, ws)).backward()
        return [a.grad.cpu() for a in args]

    card, cpu = grads_on("cuda"), grads_on("cpu")
    L = len(ps)
    check(all(torch.equal(a, b) for a, b in zip(card[: 2 * L], cpu[: 2 * L])), "kernel_bwd",
          "FusedSGD dp/dg on the card differ from the CPU's")
    exact, bound, mags = dlr_bound([w.cuda() for w in ws], gs)
    card_dlr, cpu_dlr = torch.stack(card[2 * L :]).double(), torch.stack(cpu[2 * L :]).double()
    # any float32 sum of n terms is within (n - 1) * 2**-24 * sum|x| of exact
    cpu_bound = torch.tensor([p.numel() * 2.0**-24 * m for p, m in zip(ps, mags)], dtype=torch.float64)
    check(bool(((card_dlr - exact).abs() <= bound).all()), "kernel_bwd", "FusedSGD dlr outside the bound")
    check(bool(((card_dlr - cpu_dlr).abs() <= bound + cpu_bound).all()), "kernel_bwd",
          "FusedSGD dlr on the card and the CPU further apart than their bounds")
    result["function_vs_cpu"] = {"dp_dg_equal": True, "dlr_max_abs_err": float((card_dlr - cpu_dlr).abs().max())}
    emit({"phase": "kernel_bwd", "ok": True, **result})
    return result


def _check_probs(phase, name, probs, queries, n_way):
    for i, (p, q) in enumerate(zip(probs, queries)):
        check(p.shape == (q, n_way), phase, f"{name}[{i}] shape", shape=list(p.shape))
        check(bool(torch.isfinite(torch.from_numpy(p)).all()), phase, f"{name}[{i}] not finite")
        dev = float(abs(p.sum(-1) - 1.0).max())
        check(dev <= SUM_TOLERANCE, phase, f"{name}[{i}] rows do not sum to 1", max_dev=dev)


def phase_small(seed: int):
    """The engine with the kernel against the same engine on the CPU at a
    small, well-conditioned size, where float32 agrees to 1e-5."""
    from howtotrainyourmamlpytorch_tpu_torch.config import Config, ServingConfig
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
    from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine

    cfg = Config(
        num_classes_per_set=3, num_samples_per_class=2, number_of_evaluation_steps_per_iter=2,
        use_pallas_inner_update=True,
        serving=ServingConfig(support_buckets=[8], query_buckets=[8], max_batch_size=4),
    )
    model = build_vgg((8, 8, 1), 3, num_stages=2, cnn_num_filters=8)
    gpu = MAMLSystem(cfg, model=model)
    state = gpu.init_train_state(seed)
    rng = np.random.RandomState(seed)
    supports = [(rng.rand(s, 8, 8, 1).astype(np.float32), np.arange(s) % 3) for s in (6, 6, 3)]
    queries = [rng.rand(q, 8, 8, 1).astype(np.float32) for q in (5, 8, 3)]
    probs = []
    for system, st in ((gpu, state), (MAMLSystem(cfg, model=model, device="cpu"), cpu_copy(state))):
        engine = AdaptationEngine(system, st)
        probs.append(engine.predict_batch(list(zip(engine.adapt_batch(supports), queries))))
    dev = max(float(abs(a - b).max()) for a, b in zip(*probs))
    check(dev <= SMALL_TOLERANCE, "small", "card and CPU disagree", max_abs=dev, tol=SMALL_TOLERANCE)
    emit({"phase": "small", "ok": True, "cpu_max_abs": dev, "tol": SMALL_TOLERANCE})


def float64_reference(system, state, x, y, q, steps):
    """The plain reference of one request: the model's apply, cross-entropy,
    ``torch.func.grad`` and ``p - lr * g``, ``steps`` times, unpadded, in
    float64 on the CPU (no engine, no buckets, no fused update)."""
    from torch.func import grad

    from howtotrainyourmamlpytorch_tpu_torch.ops.losses import cross_entropy
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_map

    f64 = lambda t: t.detach().cpu().double()  # noqa: E731
    params, bn, lr = tree_map(f64, state.params), tree_map(f64, state.bn_state), tree_map(f64, state.inner_hparams["lr"])
    xs = torch.from_numpy(np.asarray(x, np.float64).reshape(-1, *x.shape[-3:]))
    ys = torch.from_numpy(np.asarray(y).reshape(-1)).long()

    def loss(p):
        return cross_entropy(system.model.apply(p, bn, xs)[0], ys)

    for _ in range(steps):
        params = tree_map(lambda p, g, a: p - a * g, params, grad(loss)(params), lr)
    logits, _ = system.model.apply(params, bn, torch.from_numpy(np.asarray(q, np.float64)))
    return torch.softmax(logits, -1).numpy()


def profile_device(fn, top: int = 8):
    """Device time of one call of ``fn`` by kernel (``torch.profiler``): the
    call's wall time, the summed kernel time, their ratio (the device's
    busy share), the number of kernels, the largest by device time, and the
    time and share of B1 (``fused_sgd``) and B2 (``fused_sgd_bwd``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us == 0:
        return {"device_time": "not measured (the profiler saw no device time)", "wall_ms": wall_us / 1e3}
    kernels.sort(key=lambda e: -e.self_device_time_total)
    b2_us = sum(e.self_device_time_total for e in kernels if "fused_sgd_bwd" in e.key)
    b1_us = sum(e.self_device_time_total for e in kernels if "fused_sgd" in e.key) - b2_us
    return {
        "wall_ms": wall_us / 1e3,
        "device_ms": device_us / 1e3,
        "busy_share": device_us / wall_us,
        "kernel_launches": sum(e.count for e in kernels),
        "top": [
            {"name": e.key[:90], "ms": e.self_device_time_total / 1e3, "count": e.count,
             "share": e.self_device_time_total / device_us}
            for e in kernels[:top]
        ],
        "fused_sgd_ms": b1_us / 1e3,
        "fused_sgd_share": b1_us / device_us,
        "fused_sgd_bwd_ms": b2_us / 1e3,
        "fused_sgd_bwd_share": b2_us / device_us,
    }


def serve(engine, req):
    """The slice's requests through ``engine``: 2 adapt flushes, 1 lone
    adapt, 3 predict flushes."""
    fw_a = engine.adapt_batch(req["a"])
    fw_b = engine.adapt_batch(req["b"])
    fw_alone = engine.adapt(*req["b"][2])
    return {
        "a": engine.predict_batch(list(zip(fw_a, req["qa"]))),
        "b": engine.predict_batch(list(zip(fw_b, req["qb"]))),
        "alone": engine.predict(fw_alone, req["qb"][2]),
    }


def slice_requests(cfg, seed: int):
    """Class-structured support sets (each class its own mean image), as a
    real support set is: 8 requests at support 100 with 40 queries each
    (``a``), 3 at support 60 with 15 queries (``b``)."""
    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch

    n_way, img = cfg.num_classes_per_set, cfg.image_shape
    a = learnable_synthetic_batch(8, n_way, 5, 2, img, seed=seed + 1)
    b = learnable_synthetic_batch(3, n_way, 3, 1, img, seed=seed + 2)
    return {
        "a": [(a["x_support"][i], a["y_support"][i]) for i in range(8)],
        "qa": [a["x_target"][i].reshape(-1, *img) for i in range(8)],
        "b": [(b["x_support"][i], b["y_support"][i]) for i in range(3)],
        "qb": [b["x_target"][i].reshape(-1, *img)[:15] for i in range(3)],
    }


def slice_cpu(seed: int) -> dict:
    """Phase ``slice``'s CPU half, in the CPU twin: the same engine, weights
    and requests on the CPU (the twin, no kernel), and flush b's requests
    each adapted alone and unpadded in float64."""
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine

    cfg, system, state = full_width_system(seed, device="cpu")
    req = slice_requests(cfg, seed)
    engine = AdaptationEngine(system, cpu_copy(state))
    before = fu.launch_counts["fused_sgd"]
    t0 = time.perf_counter()
    probs = serve(engine, req)
    cpu_s = time.perf_counter() - t0
    launches = fu.launch_counts["fused_sgd"] - before
    ref = [float64_reference(system, state, x, y, q, engine.num_steps) for (x, y), q in zip(req["b"], req["qb"])]
    return {"digest": _digest(state.params, state.bn_state, state.inner_hparams, req), "steps": engine.num_steps,
            "probs": probs, "float64": ref, "launches": launches, "cpu_s": cpu_s}


def phase_slice(seed: int):
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine

    cfg, system, state = full_width_system(seed)
    engine = AdaptationEngine(system, state)
    n_way, img = cfg.num_classes_per_set, cfg.image_shape
    req = slice_requests(cfg, seed)
    steps = engine.num_steps
    check(engine.support_bucket(60) == 100 and engine.support_bucket(100) == 100, "slice", "support buckets")

    fu.reset_launch_counts()  # the serving path starts here
    t0 = time.perf_counter()
    # The checked pass runs cuDNN's deterministic algorithms: the lone
    # request against its place in a padded flush checks the engine's
    # padding, and the nondeterministic ones (atomics) add run-to-run noise
    # that 5 inner steps at a random init amplify to ~1e-5 (2.3e-5 in one
    # run of six). The timed flushes below run the defaults.
    torch.backends.cudnn.deterministic = True
    try:
        probs = serve(engine, req)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    first_s = time.perf_counter() - t0
    adapt_ms, predict_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        fws = engine.adapt_batch(req["a"])
        torch.cuda.synchronize()
        adapt_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        engine.predict_batch(list(zip(fws, req["qa"])))
        predict_ms.append((time.perf_counter() - t0) * 1e3)
    launches = fu.launch_counts["fused_sgd"]  # the serving path ends here
    copies = fu.contiguous_copies
    counts = engine.compile_counts()
    profile = profile_device(lambda: engine.adapt_batch(req["a"]))
    flushes = 3 + len(adapt_ms)
    check(launches == flushes * steps, "slice", "kernel launches != flushes x adapt_steps",
          launches=launches, flushes=flushes, steps=steps)
    check(copies == 0, "slice", "the fused update copied non-contiguous leaves", contiguous_copies=copies)

    _check_probs("slice", "a", probs["a"], [40] * 8, n_way)
    _check_probs("slice", "b", probs["b"], [15] * 3, n_way)
    _check_probs("slice", "alone", [probs["alone"]], [15], n_way)
    alone_dev = float(abs(probs["alone"] - probs["b"][2]).max())
    check(alone_dev <= FLUSH_TOLERANCE, "slice", "lone request differs from its place in the flush",
          max_abs=alone_dev)

    out = {
        "phase": "slice", "ok": True, "config": "configs/default.yaml + use_pallas_inner_update=true",
        "n_way": n_way, "adapt_steps": steps, "flushes": flushes, "launches": launches,
        "first_pass_s": first_s, "adapt_flush_ms_median": statistics.median(adapt_ms),
        "predict_flush_ms_median": statistics.median(predict_ms),
        "adapt_flush": {"tasks": 8, "support": 100}, "predict_flush": {"tasks": 8, "queries": 40},
        "alone_vs_flush_max_abs": alone_dev, "counts": counts, "contiguous_copies": copies,
        "adapt_flush_profile": profile,
    }
    emit(out)
    # the CPU half (phase cross): the same requests on the CPU, by the CPU twin
    pending = {"probs": probs, "steps": steps,
               "digest": _digest(state.params, state.bn_state, state.inner_hparams, req)}
    return out, pending


def slice_cross_check(pending: dict, cpu: dict) -> dict:
    """Phase ``slice``'s card-against-CPU check: the card's probabilities
    (``pending``) against the same engine, weights and requests on the CPU
    (the twin, no kernel: :func:`slice_cpu`) within CPU_TOLERANCE, and no
    further from float64 (flush b's requests, each adapted alone and
    unpadded) than F64_FACTOR times the CPU's distance."""
    check(cpu["digest"] == pending["digest"] and cpu["steps"] == pending["steps"], "slice",
          "the CPU twin served other weights or requests")
    check(cpu["launches"] == 0, "slice", "the CPU run launched the kernel", launches=cpu["launches"])
    probs, cpu_probs, ref = pending["probs"], cpu["probs"], cpu["float64"]
    cpu_dev = max(
        float(abs(g - c).max())
        for key in ("a", "b")
        for g, c in zip(probs[key], cpu_probs[key])
    )
    cpu_dev = max(cpu_dev, float(abs(probs["alone"] - cpu_probs["alone"]).max()))
    f64_dev = {
        name: max(float(abs(p - r).max()) for p, r in zip(got["b"], ref))
        for name, got in (("card", probs), ("cpu", cpu_probs))
    }
    check(cpu_dev <= CPU_TOLERANCE, "slice", "card and CPU disagree", max_abs=cpu_dev,
          tol=CPU_TOLERANCE, float64_max_abs=f64_dev)
    check(f64_dev["card"] <= F64_FACTOR * f64_dev["cpu"] + 1e-5, "slice",
          "card further from float64 than the CPU", float64_max_abs=f64_dev, factor=F64_FACTOR)
    return {"cpu_max_abs": cpu_dev, "cpu_tolerance": CPU_TOLERANCE, "float64_max_abs": f64_dev,
            "cpu_s": cpu["cpu_s"], "cpu_waited_s": cpu["waited_s"]}


def _flat(grads):
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    return torch.cat([t.detach().double().cpu().reshape(-1) for t in tree_leaves(grads)])


def _cosine(a, b) -> float:
    return float(a @ b / (a.norm() * b.norm()))


def float64_plain(cfg, state):
    """The port's plain path of ``cfg`` (unfused update, no remat, no
    precision casts) in float64 on the CPU, and ``state`` in float64
    there."""
    import copy

    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_map

    class Float64System(MAMLSystem):
        def _apply_forward(self, params, bn_state, x, sample_weight=None):
            return self.model.apply(params, bn_state, x, use_batch_stats=True)[0]

        def _batch(self, b, device=None):
            out = super()._batch(b, device)
            return dict(out, x_support=out["x_support"].double(), x_target=out["x_target"].double())

    cfg = copy.deepcopy(cfg)
    cfg.use_pallas_inner_update, cfg.remat_policy = False, "none"
    system = Float64System(cfg, device="cpu")
    f64 = lambda tree: tree_map(lambda t: t.detach().cpu().double(), tree)  # noqa: E731
    return system, state._replace(params=f64(state.params), bn_state=f64(state.bn_state),
                                   inner_hparams=f64(state.inner_hparams), opt_state=None,
                                   step=state.step.cpu())


def cross_check_cpu(cfg, start, batch) -> dict:
    """:func:`train_cross_check`'s CPU half: the full-width loss on the CPU
    in float32, and the meta-gradient at CROSS_TASKS tasks in float32 and
    (the plain path) in float64."""
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem

    t0 = time.perf_counter()
    cpu_system = MAMLSystem(cfg, device="cpu")
    cpu_state = cpu_copy(start)
    f64_system, f64_state = float64_plain(cfg, start)
    cpu_loss = float(cpu_system.meta_objective(cpu_state, batch, epoch=0)[0])
    small = {k: v[:CROSS_TASKS] for k, v in batch.items()}
    (cpu_small, _, cpu), (exact_small, _, exact) = (
        (float(loss), aux, _flat(grads)) for loss, aux, grads in (
            cpu_system.meta_gradients(cpu_state, small, epoch=0),
            f64_system.meta_gradients(f64_state, small, epoch=0)))
    return {"digest": _digest(start.params, start.bn_state, start.inner_hparams, batch), "loss": cpu_loss,
            "small_loss": cpu_small, "grad": cpu, "f64_small_loss": exact_small, "f64_grad": exact,
            "cpu_s": time.perf_counter() - t0}


def cross_check_twin(seed: int, overrides) -> dict:
    """:func:`cross_check_cpu` in the CPU twin, for the state
    ``full_width_system(seed, overrides)`` and the class-structured batch
    of seed + 3 that phases ``train`` and ``strategies`` step on."""
    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch

    cfg, _, start = full_width_system(seed, overrides, device="cpu")
    batch = learnable_synthetic_batch(cfg.batch_size, cfg.num_classes_per_set, cfg.num_samples_per_class,
                                      cfg.num_target_samples, cfg.image_shape, seed=seed + 3)
    return cross_check_cpu(cfg, start, batch)


def cross_check_card(cfg, start, batch) -> dict:
    """:func:`train_cross_check`'s card half: the meta-gradient at
    CROSS_TASKS tasks on the card (flat, on the host)."""
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem

    small = {k: v[:CROSS_TASKS] for k, v in batch.items()}
    loss, _, grads = MAMLSystem(cfg).meta_gradients(start, small, epoch=0)
    return {"digest": _digest(start.params, start.bn_state, start.inner_hparams, batch), "small_loss": float(loss),
            "grad": _flat(grads), "inner_steps": cfg.number_of_training_steps_per_iter}


def compare_halves(card_loss: float, card_half: dict, cpu_half: dict, phase: str, loss_rtol: float = LOSS_RTOL,
                   cosine: float = GRAD_COSINE, cosine_f64: float = GRAD_COSINE_F64) -> dict:
    """Card against CPU: the first step's loss at full width; card and CPU
    against float64: the meta-gradient (and its loss, reported) at
    CROSS_TASKS tasks; checked against the tolerances given."""
    check(cpu_half["digest"] == card_half["digest"], phase,
          "the CPU half of the cross-check ran on other weights or another batch")
    card_small, card = card_half["small_loss"], card_half["grad"]
    cpu_loss, cpu_small, cpu, exact_small, exact = (
        cpu_half[k] for k in ("loss", "small_loss", "grad", "f64_small_loss", "f64_grad"))
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    dist = lambda a: float((a - exact).norm() / exact.norm())  # noqa: E731
    out = {
        "inner_steps": card_half["inner_steps"],
        "loss_card": card_loss, "loss_cpu": cpu_loss,
        "loss_rel_card_cpu": rel(card_loss, cpu_loss), "loss_rtol": loss_rtol,
        "loss_float64_at_grad_tasks": exact_small,
        "loss_rel_from_f64_at_grad_tasks": {"card": rel(card_small, exact_small),
                                             "cpu": rel(cpu_small, exact_small)},
        "grad_tasks": CROSS_TASKS, "grad_cosine_card_cpu": _cosine(card, cpu), "grad_cosine_min": cosine,
        "grad_cosine_card_f64": _cosine(card, exact), "grad_cosine_cpu_f64": _cosine(cpu, exact),
        "grad_cosine_f64_min": cosine_f64,
        "grad_rel_l2_from_f64": {"card": dist(card), "cpu": dist(cpu)},
        "grad_max_abs_card_cpu": float((card - cpu).abs().max()), "cpu_s": cpu_half["cpu_s"],
        "cpu_waited_s": cpu_half["waited_s"],
    }
    check(out["loss_rel_card_cpu"] <= loss_rtol, phase, "card and CPU losses disagree", **out)
    check(out["grad_cosine_card_f64"] >= cosine_f64, phase, "card meta-gradient far from float64", **out)
    check(out["grad_cosine_card_cpu"] >= cosine, phase, "card and CPU meta-gradients disagree", **out)
    check(dist(card) <= F64_FACTOR * dist(cpu) + 1e-6, phase,
          "card meta-gradient further from float64 than the CPU's", **out)
    return out


def train_cross_check(cfg, start, batch, card_loss, phase: str = "train", cpu_half=None, **tolerances):
    """:func:`compare_halves` of the card's half and ``cpu_half`` (made
    in the CPU twin on the same inputs, or None to make it here)."""
    if cpu_half is None:
        cpu_half = dict(cross_check_cpu(cfg, start, batch), waited_s=0.0)
    return compare_halves(card_loss, cross_check_card(cfg, start, batch), cpu_half, phase, **tolerances)


def phase_train(seed: int):
    """The training path: train_step at the default config (second order,
    MSL on) on one class-structured meta-batch, then past the MSL window,
    then eval_step; launches, finiteness, the loss going down, step times,
    peak memory, a profile, and the card's half of the CPU cross-check
    (returned; phase cross compares it)."""
    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu

    cfg, system, state = full_width_system(seed)
    n_way, img = cfg.num_classes_per_set, cfg.image_shape
    batch = learnable_synthetic_batch(cfg.batch_size, n_way, cfg.num_samples_per_class,
                                      cfg.num_target_samples, img, seed=seed + 3)
    K, K_eval = cfg.number_of_training_steps_per_iter, cfg.number_of_evaluation_steps_per_iter
    start = state
    final_epoch = cfg.multi_step_loss_num_epochs
    check(system.use_second_order(0) and system.msl_active(0) and not system.msl_active(final_epoch),
          "train", "the default config is not second order with MSL over its window")
    torch.cuda.reset_peak_memory_stats()
    losses, train_ms, eval_ms = [], [], []
    fu.reset_launch_counts()  # the training path starts here
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, out = system.train_step(state, batch, epoch=0)
        torch.cuda.synchronize()
        train_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.loss))
    t0 = time.perf_counter()
    state, final = system.train_step(state, batch, epoch=final_epoch)
    torch.cuda.synchronize()
    final_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(EVAL_STEPS):
        t0 = time.perf_counter()
        ev = system.eval_step(state, batch)
        torch.cuda.synchronize()
        eval_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(fu.launch_counts)  # the training path ends here
    copies = fu.contiguous_copies
    peak = torch.cuda.max_memory_allocated()
    train_steps = TRAIN_STEPS + 1
    want = {"fused_sgd": K * train_steps + K_eval * EVAL_STEPS, "fused_sgd_bwd": K * train_steps}
    check(launches == want, "train", "kernel launches differ from 5 per step", launches=launches, want=want)
    # the head weight's cotangent reaches B2 transposed (the batched linear
    # layer's backward) and is copied, once per B2 launch; nothing else is
    check(copies == K * train_steps, "train", "the fused update copied other than one leaf per B2 launch",
          contiguous_copies=copies, want=K * train_steps)
    finite = all(map(lambda x: x == x and abs(x) != float("inf"), losses + [float(final.loss), float(ev.loss)]))
    check(finite and bool(torch.isfinite(ev.per_task_target_logits).all()), "train", "non-finite loss",
          losses=losses, final=float(final.loss), eval=float(ev.loss))
    queries = n_way * cfg.num_target_samples
    check(tuple(ev.per_task_target_logits.shape) == (cfg.batch_size, queries, n_way), "train",
          "eval logits shape", shape=list(ev.per_task_target_logits.shape))
    check(float(final.loss_importance_vector[-1]) == 1.0 and float(out.loss_importance_vector.sum()) > 0.999,
          "train", "MSL weights", msl=out.loss_importance_vector.tolist(), final=final.loss_importance_vector.tolist())
    check(losses[-1] <= TRAIN_DROP * losses[0], "train", "10 steps on one batch did not lower the loss",
          losses=losses, drop=TRAIN_DROP)
    profile = profile_device(lambda: system.train_step(state, batch, epoch=0))
    # the CPU half is compared in phase cross
    pending = (losses[0], cross_check_card(cfg, start, batch))
    result = {
        "phase": "train", "ok": True, "config": "configs/default.yaml + use_pallas_inner_update=true",
        "meta_batch": cfg.batch_size, "n_way": n_way, "support": n_way * cfg.num_samples_per_class,
        "target": queries, "inner_steps": K, "eval_steps": K_eval, "train_steps": train_steps,
        "eval_step_count": EVAL_STEPS, "launches": launches, "contiguous_copies": copies, "losses": losses, "loss_drop_max": TRAIN_DROP,
        "final_branch_loss": float(final.loss), "eval_loss": float(ev.loss), "eval_accuracy": float(ev.accuracy),
        "train_step_ms_median": statistics.median(train_ms), "train_step_ms": train_ms,
        "final_branch_step_ms": final_ms, "eval_step_ms_median": statistics.median(eval_ms),
        "max_memory_allocated": peak, "train_step_profile": profile, "num_params": system.num_params(start),
    }
    emit(result)
    return result, system, state, pending


def phase_cross(twin: dict, slice_pending: dict, train_pending: tuple):
    """The card-against-CPU checks of phases ``slice``
    (:func:`slice_cross_check`) and ``train`` (:func:`compare_halves`) on
    their card halves and the CPU halves the CPU twin made meanwhile."""
    loss, card_half = train_pending
    out = {"phase": "cross", "ok": True,
           "slice": slice_cross_check(slice_pending, twin_result(twin, "slice", "slice")),
           "train": compare_halves(loss, card_half, twin_result(twin, "train", "train"), "train")}
    emit(out)
    return out


def phase_serve_trained(seed: int, system, trained):
    """The trained state through a checkpoint: ``save_checkpoint`` into a
    run directory, ``AdaptationEngine.from_run_dir`` on the card, one adapt
    flush of 8 requests and its predictions."""
    from howtotrainyourmamlpytorch_tpu_torch.config import save_config
    from howtotrainyourmamlpytorch_tpu_torch.experiment.checkpoint import save_checkpoint
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    cfg = system.cfg
    req = slice_requests(cfg, seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_run_") as run_dir:
        save_config(cfg, os.path.join(run_dir, "config.yaml"))
        save_dir = os.path.join(run_dir, "saved_models")
        save_checkpoint(save_dir, trained, {"epoch": 0}, epoch=0, feature_shape=system.model.feature_shape)
        fu.reset_launch_counts()  # the serve-from-checkpoint path starts here
        engine = AdaptationEngine.from_run_dir(run_dir, "latest")
        probs = engine.predict_batch(list(zip(engine.adapt_batch(req["a"]), req["qa"])))
        launches = fu.launch_counts["fused_sgd"]  # and ends here
        copies = fu.contiguous_copies
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(engine.state.params), tree_leaves(trained.params)))
    check(same, "serve_trained", "the served params differ from the trained state's")
    check(launches == engine.num_steps, "serve_trained", "kernel launches != adapt steps", launches=launches)
    check(copies == 0, "serve_trained", "the fused update copied non-contiguous leaves", contiguous_copies=copies)
    _check_probs("serve_trained", "a", probs, [q.shape[0] for q in req["qa"]], cfg.num_classes_per_set)
    emit({"phase": "serve_trained", "ok": True, "launches": launches, "step": int(engine.state.step),
          "fingerprint": engine.fingerprint[:16]})
    return launches


SERVE_PROGRAM_REPS = 20  # timed flushes per arm (eager, replayed), in turns, after one untimed each
SERVE_PROGRAM_MIXED = 50  # requests at planned keys after the prewarm
SERVE_PROGRAMS_BUDGET_S = 120.0


def _tree_equal(a, b) -> bool:
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _rows(stacked, n: int):
    """A stacked tree's first ``n`` task rows, one tree each."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_map

    return [tree_map(lambda a, i=i: a[i], stacked) for i in range(n)]


def serve_programs_replay_vs_eager(cfg, system, state, req) -> dict:
    """Under the deterministic algorithms: per strategy, an adapt flush (8
    requests at support 100), its predictions (8 x 40 queries) and, but
    for protonet, a refine flush, each replayed from its program's graph
    (the program's second flush: its first is the warmup) against the same
    call made eagerly on the system from the same inputs: bit-equal. Each
    adapt and refine replay adds its graph's B1 tally (adapt steps) to the
    replayed launches, a predict replay none. Then two tenants alternate
    through one program (each evicted before its next turn, so re-paged)
    against the eager calls on their own masters."""
    import dataclasses

    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
    from howtotrainyourmamlpytorch_tpu_torch.serving.registry import synthetic_registry
    from howtotrainyourmamlpytorch_tpu_torch.serving.tenancy import master_bytes

    serving = dataclasses.replace(cfg.serving, strategies=list(STRATEGIES), refine_enabled=True)
    engine = AdaptationEngine(system, state, serving_cfg=serving)
    steps = engine.num_steps
    xs, ys, ws = engine._support_flush(req["a"])[:3]
    q = np.stack(req["qa"])
    qw = np.ones(q.shape[:2], np.float32)
    n = len(req["a"])
    rows, tallies = {}, {}

    def replayed(name, call):
        call()  # the program's first flush: its build
        before = fu.replayed_counts["fused_sgd"]
        out = call()
        tallies[name] = fu.replayed_counts["fused_sgd"] - before
        return out

    for strategy in STRATEGIES:
        if strategy == "protonet":
            eager_fw = system.protonet_adapt(state, xs, ys, support_weight=ws)
            eager_probs = torch.softmax(system.protonet_predict_logits(state.params, state.bn_state, eager_fw, q, qw),
                                        -1)
        else:
            eager_fw = system.adapt_fast_weights(state, xs, ys, num_steps=steps, support_weight=ws, strategy=strategy)
            eager_probs = torch.softmax(system.predict_logits(eager_fw, state.bn_state, q, qw), -1)
        fws = replayed(strategy, lambda: engine.adapt_batch(req["a"], strategy=strategy))
        adapt_equal = all(_tree_equal(g, w) for g, w in zip(fws, _rows(eager_fw, n)))
        probs = replayed(f"{strategy}/predict",
                         lambda: engine.predict_batch(list(zip(_rows(eager_fw, n), req["qa"])), strategy=strategy))
        predict_equal = all(np.array_equal(p, w) for p, w in zip(probs, eager_probs.cpu().numpy()))
        rows[strategy] = {"adapt_bit_equal": adapt_equal, "predict_bit_equal": predict_equal}
        if strategy != "protonet":
            eager_ref = system.refine_fast_weights(state, eager_fw, xs, ys, num_steps=steps, support_weight=ws,
                                                   strategy=strategy)
            refined = replayed(f"{strategy}/refine", lambda: engine.refine_batch([(fw, x, y) for fw, (x, y) in
                                                            zip(_rows(eager_fw, n), req["a"])], strategy=strategy))
            rows[strategy]["refine_bit_equal"] = all(_tree_equal(g, w) for g, w in zip(refined, _rows(eager_ref, n)))
    check(all(all(v for v in row.values()) for row in rows.values()), "serve_programs",
          "a replay differs from the eager call under the deterministic algorithms", rows=rows)
    want = {name: 0 if "predict" in name or name == "protonet" else steps for name in tallies}
    check(tallies == want, "serve_programs", "a replay's B1 tally", tallies=tallies, want=want)

    # two tenants through one program: a pager that holds one master
    tenant_ids = list(TENANT_IDS[:2])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_programs_") as root:
        registry = synthetic_registry(tenant_ids, state, root, seed=1, feature_shape=system.model.feature_shape)
        tenants = AdaptationEngine(system, state, registry=registry)
        tenants.pager.budget_bytes = master_bytes(state)
        x, y = req["a"][0]
        want_probs = {}
        for tenant in tenant_ids:
            host, _ = registry.host_state(tenant)
            own = host._replace(params=_to_card(host.params), bn_state=_to_card(host.bn_state),
                                inner_hparams=_to_card(host.inner_hparams), opt_state=None)
            one_x, one_y, one_w = engine._support_flush([(x, y)])[:3]
            adapted = system.adapt_fast_weights(own, one_x, one_y, num_steps=steps, support_weight=one_w)
            q_one = req["qa"][0][None]
            logits = system.predict_logits(adapted, own.bn_state, q_one, np.ones(q_one.shape[:2], np.float32))
            want_probs[tenant] = torch.softmax(logits, -1)[0].cpu().numpy()
        turns = []
        for turn in range(4):
            tenant = tenant_ids[turn % 2]
            got = tenants.predict(tenants.adapt(x, y, tenant=tenant), req["qa"][0], tenant=tenant)
            turns.append({"tenant": tenant, "bit_equal": bool(np.array_equal(got, want_probs[tenant])),
                          "max_abs": float(np.abs(got - want_probs[tenant]).max())})
        counts = tenants.compile_counts()
        stats = tenants.pager.stats()
    check(all(t["bit_equal"] for t in turns) and (counts["adapt_programs"], counts["predict_programs"]) == (1, 1)
          and stats["evictions"] >= 3, "serve_programs", "two tenants through one program",
          turns=turns, counts=counts, pager=stats)
    return {"strategies": rows, "replay_b1_tally": tallies, "tenants": {"turns": turns, "pager": stats,
                                                                        "adapt_programs": counts["adapt_programs"]}}


def _to_card(tree):
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_map

    return tree_map(lambda t: t.to("cuda"), tree)


def serve_programs_timing(cfg, system, state, req) -> dict:
    """At the VGG default cell (8 requests at support 100, 8 x 40 queries,
    5 steps): each flush eager (the system's call from the padded host
    arrays, then the split into requests or the copy to the host) against
    the engine's replay, in turns after one untimed each, SERVE_PROGRAM_REPS
    each; host clock to a card synchronize. The default algorithms."""
    import dataclasses

    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine

    engine = AdaptationEngine(system, state, serving_cfg=dataclasses.replace(cfg.serving, refine_enabled=True))
    steps, n = engine.num_steps, len(req["a"])
    fws = engine.adapt_batch(req["a"])
    items = [(fw, x, y) for fw, (x, y) in zip(fws, req["a"])]

    def eager_adapt():
        xs, ys, ws, _, _ = engine._support_flush(req["a"])
        return engine._split(system.adapt_fast_weights(state, xs, ys, num_steps=steps, support_weight=ws), n)

    def eager_refine():
        xs, ys, ws, _, _ = engine._support_flush(req["a"])
        return engine._split(system.refine_fast_weights(state, _stack(fws), xs, ys, num_steps=steps,
                                                        support_weight=ws), n)

    def eager_predict():
        q = np.stack(req["qa"])
        logits = system.predict_logits(_stack(fws), state.bn_state, q, np.ones(q.shape[:2], np.float32))
        return torch.softmax(logits, -1).cpu().numpy()

    arms = {
        "adapt": (eager_adapt, lambda: engine.adapt_batch(req["a"])),
        "refine": (eager_refine, lambda: engine.refine_batch(items)),
        "predict": (eager_predict, lambda: engine.predict_batch(list(zip(fws, req["qa"])))),
    }
    out = {}
    for kind, (eager, replay) in arms.items():
        ms = {"eager": [], "replayed": []}
        for turn in range(SERVE_PROGRAM_REPS + 1):
            for arm, fn in (("eager", eager), ("replayed", replay)) if turn % 2 else (("replayed", replay),
                                                                                     ("eager", eager)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if turn:
                    ms[arm].append((time.perf_counter() - t0) * 1e3)
        medians = {arm: statistics.median(v) for arm, v in ms.items()}
        out[kind] = {"ms": ms, "median_ms": medians, "eager_over_replayed": medians["eager"] / medians["replayed"]}
    out["cell"] = {"requests": n, "support": 100, "queries": 40, "steps": steps, "reps": SERVE_PROGRAM_REPS}
    return out


def _stack(trees):
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_map

    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def serve_programs_prewarmed(cfg, system, state, seed: int) -> dict:
    """The strict engine at the config's serving grid with refine, prewarmed
    (every program captured), then SERVE_PROGRAM_MIXED requests at planned
    keys, flushes of 1 to 8 requests over every support and query bucket
    and kind: no program built, no ledger entry outside the prewarm, no
    guard violation, and the B1 launches the flushes imply."""
    import dataclasses

    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
    from howtotrainyourmamlpytorch_tpu_torch.observability.compile_ledger import CompileLedger
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine

    n_way, img = cfg.num_classes_per_set, cfg.image_shape
    engine = AdaptationEngine(system, state, serving_cfg=dataclasses.replace(cfg.serving, refine_enabled=True),
                              strict=True)
    ledger, entries = CompileLedger(), []
    ledger.on_entry = entries.append
    engine.compile_ledger = ledger
    summary = engine.prewarm()
    check(summary["errors"] == 0 and all(row.get("graph") for row in summary["by_program"].values()),
          "serve_programs", "the prewarm did not capture every program", summary=summary)
    built = dict(engine.compile_counts())
    n_prewarm = len(entries)
    rng = np.random.RandomState(seed)
    fu.reset_launch_counts()  # the prewarmed serving path starts here
    served, flushes, adapt_flushes = 0, [], 0
    while served < SERVE_PROGRAM_MIXED:
        k = int(min(rng.randint(1, 9), SERVE_PROGRAM_MIXED - served))
        bucket = cfg.serving.support_buckets[rng.randint(len(cfg.serving.support_buckets))]
        query = cfg.serving.query_buckets[rng.randint(len(cfg.serving.query_buckets))]
        batch = learnable_synthetic_batch(k, n_way, bucket // n_way, max(1, query // n_way), img,
                                          seed=seed + 500 + served)
        supports = [(batch["x_support"][i], batch["y_support"][i]) for i in range(k)]
        queries = [batch["x_target"][i].reshape((-1,) + tuple(img))[:query] for i in range(k)]
        fws = engine.adapt_batch(supports)
        probs = engine.predict_batch(list(zip(fws, queries)))
        _check_probs("serve_programs", f"mixed {bucket}/{k}", probs, [q.shape[0] for q in queries], n_way)
        flushes.append((bucket, query, k))
        adapt_flushes += 1
        if rng.rand() < 0.5:
            engine.refine_batch([(fw, x, y) for fw, (x, y) in zip(fws, supports)])
            adapt_flushes += 1
        served += k
    torch.cuda.synchronize()
    launches = fu.launch_counts["fused_sgd"]  # and ends here
    after = engine.compile_counts()
    outside = entries[n_prewarm:]
    guard = after["recompile_guard"]
    check(outside == [] and all(e.get("phase") == "prewarm" for e in entries)
          and all(after[k] == built[k] for k in ("adapt_programs", "predict_programs", "refine_programs"))
          and guard["violations"] == [], "serve_programs", "a planned key built a program after the prewarm",
          outside=outside[:3], built=built, after={k: after[k] for k in built if k.endswith("_programs")})
    want = engine.num_steps * adapt_flushes
    check(launches == want and fu.replayed_counts["fused_sgd"] == launches, "serve_programs",
          "B1 launches != 5 x (adapt + refine flushes), all replayed", launches=launches, want=want,
          replayed=fu.replayed_counts["fused_sgd"])
    by_program = {name: {"seconds": row["seconds"], "capture_s": row["total_s"]}
                  for name, row in summary["by_program"].items()}
    capture = sorted(row["total_s"] for row in summary["by_program"].values())
    return {"programs": summary["programs"], "prewarm_s": summary["seconds"], "pool_bytes": summary["pool_bytes"],
            "static_bytes": summary["static_bytes"], "capture_s": {"min": capture[0], "median": statistics.median(capture),
                                                                "max": capture[-1], "sum": sum(capture)},
            "by_program": by_program, "requests": served, "flushes": len(flushes), "adapt_flushes": adapt_flushes,
            "launches": launches, "counts": {k: after[k] for k in built if k.endswith("_programs")}}


def phase_serve_programs(seed: int):
    """The serving programs on the card at the VGG default cell: replays
    against eager calls under the deterministic algorithms (and two
    tenants through one program), the prewarmed grid under mixed traffic,
    eager against replayed flush times."""
    cfg, system, state = full_width_system(seed)
    req = slice_requests(cfg, seed)
    with deterministic_algorithms():
        exact = serve_programs_replay_vs_eager(cfg, system, state, req)
    prewarmed = serve_programs_prewarmed(cfg, system, state, seed)
    timing = serve_programs_timing(cfg, system, state, req)
    out = {"phase": "serve_programs", "ok": True, "config": "configs/default.yaml + use_pallas_inner_update=true",
           "exact": exact, "prewarmed": prewarmed, "timing": timing}
    emit(out)
    return out


def _http(base: str, path: str, body=None, headers: bool = False):
    """One HTTP call -> (status, decoded JSON body, wall ms), and the
    response headers with ``headers``. ``body`` is the request's bytes
    (POST) or None (GET)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=body, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=HTTP_CALL_S) as resp:
            status, raw, head = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as exc:
        status, raw, head = exc.code, exc.read(), exc.headers
    out = (status, json.loads(raw), (time.perf_counter() - t0) * 1e3)
    return out + (head,) if headers else out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# ``python -m MODULE ARGS`` (the arguments after ``-c``) in a fresh process
# that imports the serving stack and starts the card, then waits for the
# file SMOKE_GATE names before it runs the module; it exits if the process
# that started it is gone. Its pid is the server's.
_GATED_MODULE = r"""
import os, runpy, sys, time
parent = os.getppid()
import torch
import torch._inductor.config  # noqa: F401 (the serve CLI's deterministic switch imports it)
from howtotrainyourmamlpytorch_tpu_torch import serving  # noqa: F401
from howtotrainyourmamlpytorch_tpu_torch.serving import engine  # noqa: F401
if torch.cuda.is_available():
    torch.zeros(1, device="cuda")
while not os.path.exists(os.environ["SMOKE_GATE"]):
    if os.getppid() != parent:
        sys.exit(3)
    time.sleep(0.02)
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def start_gated_server(argv, log_path: str, gate: str):
    """``argv`` (``python -m MODULE ...``) started now behind ``gate``
    (:data:`_GATED_MODULE`): its imports and card start (8-16 s) overlap
    the work before its release (``open(gate, "w")``). -> the process."""
    root = os.path.dirname(os.path.abspath(__file__))
    assert argv[:2] == [sys.executable, "-m"], argv
    log = open(log_path, "ab")
    proc = subprocess.Popen([sys.executable, "-c", _GATED_MODULE, *argv[2:]], cwd=root,
                            env=dict(os.environ, PYTHONPATH=root, SMOKE_GATE=gate), stdout=log,
                            stderr=subprocess.STDOUT)
    log.close()
    return proc


HTTP_SERVE_OVERRIDES = ("serving.refine_enabled=true",)


def _serve_argv(run_dir: str, port: int, overrides):
    return [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.serve", run_dir, "--port", str(port),
            *overrides]


def prestart_http() -> dict:
    """Phase ``http``'s first server and its restart, started before phase
    ``small`` behind gates on a run directory that phase ``http`` fills
    (the trained state) before it releases the first: their imports and
    card start overlap the phases between. The restart is released after
    the first server's drain, so it reads the sessions that drain spilled."""
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_http_")
    servers = {}
    for name in ("serve", "restart"):
        port, gate, log_path = _free_port(), os.path.join(run_dir, f"{name}.gate"), os.path.join(run_dir, f"{name}.log")
        servers[name] = {"port": port, "gate": gate, "log_path": log_path,
                         "proc": start_gated_server(_serve_argv(run_dir, port, HTTP_SERVE_OVERRIDES), log_path, gate)}
    return {"run_dir": run_dir, **servers["serve"], "restart": servers["restart"]}


def start_server(run_dir: str, log_path: str, overrides=HTTP_SERVE_OVERRIDES, phase: str = "http",
                 while_starting=None, gated=None):
    """``python -m howtotrainyourmamlpytorch_tpu_torch.serve RUN_DIR`` (on
    the card: no ``--device``) with the config ``overrides``, on a free
    port, or ``gated`` (:func:`prestart_http`) released; returns (process,
    base URL, /healthz body) once /healthz answers 200.
    ``while_starting()``, where given, runs here while the server process
    imports and starts."""
    if gated is None:
        port = _free_port()
        root = os.path.dirname(os.path.abspath(__file__))
        log = open(log_path, "a")
        proc = subprocess.Popen(_serve_argv(run_dir, port, overrides), cwd=root, env=dict(os.environ, PYTHONPATH=root),
                                stdout=log, stderr=subprocess.STDOUT)
        log.close()
    else:
        proc, port = gated["proc"], gated["port"]
        open(gated["gate"], "w").close()
    base = f"http://127.0.0.1:{port}"
    if while_starting is not None:
        try:
            while_starting()
        except BaseException:
            stop_server(proc)
            raise
    deadline = time.monotonic() + HTTP_READY_S
    while True:
        try:
            status, health, _ = _http(base, "/healthz")
            if status == 200:
                return proc, base, health
        except OSError:
            pass
        if proc.poll() is not None or time.monotonic() > deadline:
            stop_server(proc)
            with open(log_path) as f:
                check(False, phase, "the server did not come up", rc=proc.returncode, log=f.read()[-4000:])
        time.sleep(0.25)


def stop_server(proc, sig=None) -> int:
    """SIGTERM (graceful drain) and wait; kill what does not exit."""
    import signal

    if proc.poll() is None:
        proc.send_signal(sig or signal.SIGTERM)
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return proc.returncode


def _in_threads(calls, clients: int):
    """Run ``calls`` (zero-argument functions) on ``clients`` threads, each
    taking every ``clients``-th call in order -> results in call order."""
    import threading

    out = [None] * len(calls)

    def client(c):
        for i in range(c, len(calls), clients):
            out[i] = calls[i]()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _percentiles(values) -> dict:
    p50, p99 = np.percentile(np.asarray(values, np.float64), [50, 99])
    return {"p50_ms": float(p50), "p99_ms": float(p99), "n": len(values)}


def _alone_references(engine, supports, queries, probs, seed: int):
    """Each HTTP answer against the same request alone in this process ->
    (its distance, its noise floor, another request's distance) per
    request. The bound is the rollout's float32 noise floor at this
    config: the largest distance any request moves when its images move by
    NOISE_SCALE (one draw per request is too noisy an estimate to gate each
    request by its own: in the first card run one answer of 64 lay 6.1e-4
    from its lone twin against its own draw's 4.8e-4). Another request's
    weights on the same queries show how far a routing or padding fault
    would land."""
    n = len(supports)
    fws = [engine.adapt(x, y) for x, y in supports]
    devs, floors, wrong = [], [], []
    for i, ((x, y), q, p) in enumerate(zip(supports, queries, probs)):
        alone = engine.predict(fws[i], q)
        moved = (x + NOISE_SCALE * np.random.RandomState(seed + i).randn(*x.shape)).astype(np.float32)
        devs.append(float(abs(p - alone).max()))
        floors.append(float(abs(alone - engine.predict(engine.adapt(moved, y), q)).max()))
        wrong.append(float(abs(p - engine.predict(fws[(i + 1) % n], q)).max()))
    return devs, floors, wrong


def phase_http(seed: int, system, trained, pre: dict):
    """Serving over HTTP on the card through the CLI: the trained state in a
    run directory (``config.yaml``, ``save_checkpoint``), ``python -m
    howtotrainyourmamlpytorch_tpu_torch.serve`` in a subprocess with
    ``serving.refine_enabled=true``; one /adapt and /predict timed apart
    (the server's cold start), then HTTP_CLIENTS threads of HTTP_PER_CLIENT
    /adapt each at support 100, then /predict of 40 queries per adaptation
    id; one cache hit, one refine, one /adapt_predict, a 400 and a 404;
    SIGTERM (a clean drain, the sessions spilled), a restart (rehydrated,
    a cache hit with the same probabilities). B1 launches are the server
    process's count (zero at its start), read from /metrics before the
    drain. Each answer is held against the same request adapted and
    predicted alone in this process (the bound below). ``pre``: the first
    server, started behind a gate (:func:`prestart_http`)."""
    from howtotrainyourmamlpytorch_tpu_torch.config import save_config
    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
    from howtotrainyourmamlpytorch_tpu_torch.experiment.checkpoint import save_checkpoint
    from howtotrainyourmamlpytorch_tpu_torch.serving.cache import support_digest
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine

    cfg = system.cfg
    n_way, img = cfg.num_classes_per_set, cfg.image_shape
    n = HTTP_CLIENTS * HTTP_PER_CLIENT
    # n timed requests, one for /adapt_predict, one to warm the server up
    data = learnable_synthetic_batch(n + 2, n_way, 5, 2, img, seed=seed + 7)
    supports = [(data["x_support"][i], data["y_support"][i]) for i in range(n + 2)]
    queries = [data["x_target"][i].reshape(-1, *img)[:HTTP_QUERIES] for i in range(n + 2)]
    support_body = [json.dumps({"x_support": x.tolist(), "y_support": y.tolist()}).encode() for x, y in supports]
    # what the server does to a request body before the engine sees it
    decode_ms = []
    for body in support_body[:5]:
        t0 = time.perf_counter()
        req = json.loads(body)
        AdaptationEngine._flatten_support(req["x_support"], req["y_support"])
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    engine = AdaptationEngine(system, trained)  # the lone-request reference, in this process
    out = {"phase": "http", "clients": HTTP_CLIENTS, "adapts_per_client": HTTP_PER_CLIENT, "support": 100,
           "queries": HTTP_QUERIES}
    alone = {}
    run_dir, log_path = pre["run_dir"], pre["log_path"]
    try:
        save_config(cfg, os.path.join(run_dir, "config.yaml"))
        save_checkpoint(os.path.join(run_dir, "saved_models"), trained, {"epoch": 0}, epoch=0,
                        feature_shape=system.model.feature_shape)
        proc, base, health = start_server(run_dir, log_path, gated=pre)
        try:
            check(health["platform"] == "cuda" and health["status"] == "ok", "http", "healthz", health=health)
            # the server's first adapt and predict: its cold start, timed apart
            status, cold, cold_adapt_ms = _http(base, "/adapt", support_body[n + 1])
            status_p, _, cold_predict_ms = _http(base, "/predict", json.dumps(
                {"adaptation_id": cold.get("adaptation_id"), "x_query": queries[n + 1].tolist()}).encode())
            check(status == status_p == 200, "http", "the first /adapt and /predict", body=cold)
            adapts = _in_threads([lambda b=b: _http(base, "/adapt", b) for b in support_body[:n]], HTTP_CLIENTS)
            check(all(status == 200 for status, _, _ in adapts), "http", "an /adapt failed",
                  errors=[body for status, body, _ in adapts if status != 200][:3])
            ids = [body["adaptation_id"] for _, body, _ in adapts]
            want_ids = [support_digest(*engine._flatten_support(x, y), engine.num_steps, "maml++")
                        for x, y in supports[:n]]
            check(ids == want_ids, "http", "adaptation ids differ from support_digest")
            check(not any(body["cached"] for _, body, _ in adapts), "http", "a fresh /adapt was a cache hit")
            predict_body = [json.dumps({"adaptation_id": i, "x_query": q.tolist()}).encode()
                            for i, q in zip(ids, queries)]
            predicts = _in_threads([lambda b=b: _http(base, "/predict", b) for b in predict_body], HTTP_CLIENTS)
            check(all(status == 200 for status, _, _ in predicts), "http", "a /predict failed",
                  errors=[body for status, body, _ in predicts if status != 200][:3])
            probs = [np.asarray(body["probs"], np.float32) for _, body, _ in predicts]
            _check_probs("http", "predict", probs, [HTTP_QUERIES] * n, n_way)

            before = _http(base, "/metrics")[1]
            status, hit, _ = _http(base, "/adapt", support_body[0])
            after = _http(base, "/metrics")[1]
            hit_launches = after["compiled"]["fused_sgd_launches"] - before["compiled"]["fused_sgd_launches"]
            check(status == 200 and hit["cached"] and hit_launches == 0, "http",
                  "a repeated /adapt is not a cache hit without launches", body=hit, launches=hit_launches)
            x0, y0 = supports[0]
            refine_body = json.dumps({"refine": True, "session_id": ids[0], "x_support": x0.tolist(),
                                      "y_support": y0.tolist()}).encode()
            status, refined, refine_ms = _http(base, "/adapt", refine_body)
            check(status == 200 and refined["refined"], "http", "/adapt with refine", body=refined)
            xs, ys = supports[n]
            ap_body = json.dumps({"x_support": xs.tolist(), "y_support": ys.tolist(),
                                  "x_query": queries[n].tolist()}).encode()
            status, ap, ap_ms = _http(base, "/adapt_predict", ap_body)
            check(status == 200 and not ap["cached"], "http", "/adapt_predict", body={k: ap.get(k) for k in ap
                                                                                       if k != "probs"})
            _check_probs("http", "adapt_predict", [np.asarray(ap["probs"], np.float32)], [HTTP_QUERIES], n_way)
            bad = _http(base, "/adapt", b"{not json")[0]
            missing = _http(base, "/adapt", json.dumps({"x_support": x0.tolist()}).encode())[0]
            unknown = _http(base, "/predict", json.dumps({"adaptation_id": "deadbeef",
                                                          "x_query": queries[0].tolist()}).encode())[0]
            check((bad, missing, unknown) == (400, 400, 404), "http", "error statuses",
                  malformed=bad, missing_labels=missing, unknown_id=unknown)

            metrics = _http(base, "/metrics")[1]
            launches = metrics["compiled"]["fused_sgd_launches"]  # the HTTP serving path ends here
            adapt_b, refine_b = metrics["adapt_batcher"], metrics["refine_batcher"]
            flushes = adapt_b["flushes"] + refine_b["flushes"]
            check(launches == engine.num_steps * flushes, "http", "B1 launches != 5 x (adapt + refine flushes)",
                  launches=launches, adapt_flushes=adapt_b["flushes"], refine_flushes=refine_b["flushes"])
            entries = metrics["cache"]["entries"]
            rc = stop_server(proc)
            with open(log_path) as f:
                log = f.read()
            spilled = len(os.listdir(os.path.join(run_dir, "saved_models", "sessions")))
            check(rc == 0 and f"{entries} session(s) spilled" in log and spilled == entries, "http",
                  "SIGTERM drain", rc=rc, entries=entries, spilled_files=spilled, log=log[-2000:])

            # the in-process references below run while the restart (started
            # behind its gate with the first server) reads the spilled sessions
            proc, base, _ = start_server(run_dir, pre["restart"]["log_path"], gated=pre["restart"],
                                         while_starting=lambda: alone.update(zip(
                                             ("devs", "floors", "wrong"),
                                             _alone_references(engine, supports[:n], queries[:n], probs, seed))))
            again = _http(base, "/metrics")[1]
            status, hit2, _ = _http(base, "/adapt", support_body[1])
            status_p, pred2, _ = _http(base, "/predict", predict_body[1])
            restart_dev = float(abs(np.asarray(pred2["probs"], np.float32) - probs[1]).max())
            check(again["sessions"]["rehydrated"] == entries and status == 200 and hit2["cached"]
                  and status_p == 200 and restart_dev <= FLUSH_TOLERANCE, "http", "the restart",
                  sessions=again["sessions"], hit=hit2, restart_max_abs=restart_dev)
            rc2 = stop_server(proc)
            check(rc2 == 0, "http", "the second drain", rc=rc2)
        finally:
            stop_server(proc)
    finally:
        stop_server(pre["proc"])
        stop_server(pre["restart"]["proc"])
        shutil.rmtree(run_dir, ignore_errors=True)

    devs, floors, wrong = alone["devs"], alone["floors"], alone["wrong"]
    bound = max(ALONE_TOLERANCE["maml++"], max(floors))
    worst = max(range(n), key=lambda i: devs[i])
    check(devs[worst] <= bound, "http", "an HTTP answer differs from the request served alone", index=worst,
          max_abs=devs[worst], bound=bound)
    check(min(wrong) > bound, "http", "another request's weights answer within the bound", min_max_abs=min(wrong),
          bound=bound)

    timing = {key: statistics.median(body["timing"][key] for _, body, _ in adapts)
              for key in ("queue_wait_ms", "dispatch_ms", "total_ms")}
    predict_timing = {key: statistics.median(body["timing"][key] for _, body, _ in predicts)
                      for key in ("queue_wait_ms", "dispatch_ms", "total_ms")}
    server_latency = {phase: {k: metrics["latency"][phase][k] for k in ("p50_ms", "p99_ms", "count")}
                      for phase in ("adapt", "predict", "adapt_cached", "refine") if phase in metrics["latency"]}
    out.update({
        "ok": True, "launches": launches, "adapt_flushes": adapt_b["flushes"],
        "refine_flushes": refine_b["flushes"], "flushes_per_adapt_request": adapt_b["flushes"] / adapt_b["requests"],
        "adapt_mean_batch": adapt_b["mean_batch"], "flushes_continuous": adapt_b["flushes_continuous"],
        "predict_flushes": metrics["predict_batcher"]["flushes"],
        "client_adapt": _percentiles([ms for _, _, ms in adapts]),
        "client_predict": _percentiles([ms for _, _, ms in predicts]),
        # the timed requests' own timing.total_ms: /adapt from the frontend's
        # entry (after the body's parse), /predict from the handler's
        "server_adapt": _percentiles([body["timing"]["total_ms"] for _, body, _ in adapts]),
        "server_predict": _percentiles([body["timing"]["total_ms"] for _, body, _ in predicts]),
        "metrics_latency_with_cold_start": server_latency, "adapt_timing_median_ms": timing,
        "predict_timing_median_ms": predict_timing, "refine_ms": refine_ms, "adapt_predict_ms": ap_ms,
        "refine_rolled_back": refined["rolled_back"], "sessions_spilled": entries, "restart_max_abs": restart_dev,
        "alone_max_abs": max(devs), "alone_max_abs_median": statistics.median(devs), "alone_bound": bound,
        "alone_noise_floor_min": min(floors), "alone_noise_floor_median": statistics.median(floors),
        "answers_above_own_noise_draw": sum(d > f for d, f in zip(devs, floors)),
        "other_request_min_max_abs": min(wrong),
        "request_bytes": len(support_body[0]), "host_decode_ms_median": statistics.median(decode_ms),
        "cold_adapt_ms": cold_adapt_ms, "cold_predict_ms": cold_predict_ms,
    })
    emit(out)
    return out


def lru_paging(dispatches, capacity: int):
    """(page-ins, evictions, resident tenants in LRU order) of an LRU set of
    ``capacity`` masters over the tenants of a dispatch sequence (None: the
    default tenant, never paged) — what the pager must report."""
    resident = []
    page_ins = evictions = 0
    for tenant in dispatches:
        if tenant is None:
            continue
        if tenant in resident:
            resident.remove(tenant)
            resident.append(tenant)
            continue
        resident.append(tenant)
        page_ins += 1
        while len(resident) > capacity:
            resident.pop(0)
            evictions += 1
    return page_ins, evictions, resident


def _cuda_block_bytes(state) -> int:
    """The caching allocator's bytes of a master's served trees: each
    tensor rounded up to its 512-byte blocks."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    return sum(-(-leaf.numel() * leaf.element_size() // 512) * 512
               for tree in (state.params, state.bn_state, state.inner_hparams) for leaf in tree_leaves(tree))


def phase_tenancy(seed: int, system, trained, http_bound: float):
    """Multi-tenant serving on the card at the default config. The trained
    state and 4 tenants (``synthetic_registry``: perturbed copies, real
    format-2 checkpoints) in a run directory with a ``tenants.yaml``,
    served by ``python -m howtotrainyourmamlpytorch_tpu_torch.serve`` in a
    subprocess with a budget of 2 masters and a resident-bytes quota of
    TENANT_ROUNDS adapted trees per tenant: TENANT_ROUNDS rounds of /adapt
    and /predict over the default tenant and the 4 tenants in turn (every
    tenant access pages in), then a quota breach (429 + Retry-After) beside
    another tenant's 200, a cross-tenant 404, an unknown tenant's 400, and
    SIGTERM. Checks: page-ins, evictions and the resident set against the
    LRU arithmetic (/metrics and events.jsonl), adaptation ids against
    ``support_digest``, each answer against a single-tenant engine on that
    tenant's checkpoint in this process (within the float32 noise floor:
    phase ``http``'s, or the largest move of a control answer under a
    NOISE_SCALE image change, where that is larger; cuDNN's atomics make
    two processes differ; the exact ones counted), B1 launched 5 times per
    adapt flush (the server's count). Then in this process: a tenant's
    answer against its control with cuDNN deterministic (within 1e-6),
    page-ins timed (cold adapt against resident adapt), an eviction's drop
    in ``memory_allocated``, an eviction through the watermark
    (``min_headroom_frac`` 1.0), and ``clone_for_device`` on ``cuda:0``
    against the engine."""
    from howtotrainyourmamlpytorch_tpu_torch.config import save_config
    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
    from howtotrainyourmamlpytorch_tpu_torch.experiment.checkpoint import save_checkpoint
    from howtotrainyourmamlpytorch_tpu_torch.serving.cache import support_digest, tree_bytes
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
    from howtotrainyourmamlpytorch_tpu_torch.serving.registry import synthetic_registry
    from howtotrainyourmamlpytorch_tpu_torch.serving.tenancy import master_bytes

    cfg = system.cfg
    n_way, img = cfg.num_classes_per_set, cfg.image_shape
    tenants = (None,) + TENANT_IDS
    # one support set per round and 3 for the quota leg
    data = learnable_synthetic_batch(TENANT_ROUNDS + 3, n_way, 5, 2, img, seed=seed + 11)
    supports = [(data["x_support"][i], data["y_support"][i]) for i in range(TENANT_ROUNDS + 3)]
    queries = [data["x_target"][i].reshape(-1, *img)[:HTTP_QUERIES] for i in range(TENANT_ROUNDS + 3)]
    out = {"phase": "tenancy", "tenants": len(TENANT_IDS), "rounds": TENANT_ROUNDS, "support": 100,
           "queries": HTTP_QUERIES}

    def body(tenant, **fields):
        return json.dumps({**fields, **({"tenant": tenant} if tenant else {})}).encode()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tenancy_") as run_dir:
        save_config(cfg, os.path.join(run_dir, "config.yaml"))
        save_checkpoint(os.path.join(run_dir, "saved_models"), trained, {"epoch": 0}, epoch=0,
                        feature_shape=system.model.feature_shape)
        registry = synthetic_registry(TENANT_IDS, trained, os.path.join(run_dir, "tenants"), seed=seed,
                                      feature_shape=system.model.feature_shape)
        with open(os.path.join(run_dir, "tenants.yaml"), "w") as f:
            f.write("tenants:\n" + "".join(f"  {t}: {{run_dir: tenants/{t}, checkpoint: latest}}\n"
                                           for t in TENANT_IDS))
        one = master_bytes(registry.host_state(TENANT_IDS[0])[0])
        adapted = tree_bytes(trained.params)
        budget, quota = 2 * one, TENANT_ROUNDS * adapted
        # the single-tenant controls: one engine per checkpoint, in this
        # process while the server starts, and each answer's float32 noise
        # floor (how far it moves when the support images move by
        # NOISE_SCALE), as in phase http
        controls, control_ms, floors = {}, [], []

        def make_controls():
            for tenant in tenants:
                ctrl = AdaptationEngine(system, trained) if tenant is None else AdaptationEngine.from_run_dir(
                    os.path.join(run_dir, "tenants", tenant), "latest", cfg=cfg, system=system)
                check(ctrl.registry is None, "tenancy", "a control engine found a registry")
                for r in range(TENANT_ROUNDS):
                    (x, y), q = supports[r], queries[r]
                    t0 = time.perf_counter()
                    controls[tenant, r] = ctrl.predict(ctrl.adapt(x, y), q)
                    control_ms.append((time.perf_counter() - t0) * 1e3)
                    moved = (x + NOISE_SCALE * np.random.RandomState(seed + r).randn(*x.shape)).astype(np.float32)
                    floors.append(float(abs(controls[tenant, r] - ctrl.predict(ctrl.adapt(moved, y), q)).max()))

        log_path = os.path.join(run_dir, "serve.log")
        proc, base, health = start_server(
            run_dir, log_path, (f"serving.tenant_budget_bytes={budget}", f"serving.tenant_max_resident_bytes={quota}"),
            phase="tenancy", while_starting=make_controls)
        bound = max(http_bound, max(floors))
        dispatches, devs, wrong, cold_ms, resident_ms = [], [], [], [], []
        try:
            check(health["platform"] == "cuda", "tenancy", "healthz", health=health)
            for r in range(TENANT_ROUNDS):
                x, y = supports[r]
                for tenant in tenants:
                    status, got, ms = _http(base, "/adapt", body(tenant, x_support=x.tolist(), y_support=y.tolist()))
                    want_id = support_digest(*AdaptationEngine._flatten_support(x, y), cfg.number_of_evaluation_steps_per_iter,
                                             "maml++", tenant=tenant)
                    check(status == 200 and got["adaptation_id"] == want_id and not got["cached"]
                          and got.get("tenant") == tenant, "tenancy", "an /adapt", tenant=tenant, body=got)
                    (resident_ms if tenant is None else cold_ms).append(ms)
                    status, pred, _ = _http(base, "/predict", body(tenant, adaptation_id=got["adaptation_id"],
                                                                   x_query=queries[r].tolist()))
                    check(status == 200, "tenancy", "a /predict", tenant=tenant, body=pred)
                    dispatches += [tenant, tenant]
                    probs = np.asarray(pred["probs"], np.float32)
                    devs.append(float(abs(probs - controls[tenant, r]).max()))
                    wrong.append(min(float(abs(probs - controls[other, r]).max()) for other in tenants if other != tenant))
                    if tenant == TENANT_IDS[0]:
                        first_id = got["adaptation_id"]
            # the quota: a tenant holding more than TENANT_ROUNDS adapted
            # trees is refused before any dispatch; another tenant is not
            breach = TENANT_IDS[-1]
            statuses = []
            for i in (TENANT_ROUNDS, TENANT_ROUNDS + 1):
                x, y = supports[i]
                statuses.append(_http(base, "/adapt", body(breach, x_support=x.tolist(), y_support=y.tolist()),
                                      headers=True))
            dispatches.append(breach)
            x, y = supports[TENANT_ROUNDS + 2]
            other = _http(base, "/adapt", body(TENANT_IDS[0], x_support=x.tolist(), y_support=y.tolist()))
            dispatches.append(TENANT_IDS[0])
            (ok_status, _, _, _), (shed_status, shed, _, shed_headers) = statuses
            check(ok_status == 200 and shed_status == 429 and int(shed_headers["Retry-After"]) >= 1
                  and other[0] == 200, "tenancy", "the resident-bytes quota", statuses=[ok_status, shed_status],
                  shed=shed, other=other[0])
            cross = _http(base, "/predict", body(TENANT_IDS[1], adaptation_id=first_id,
                                                 x_query=queries[0].tolist()))[0]
            unknown = _http(base, "/adapt", body("nobody", x_support=x.tolist(), y_support=y.tolist()))[0]
            check((cross, unknown) == (404, 400), "tenancy", "cross-tenant id and unknown tenant", cross=cross,
                  unknown=unknown)
            metrics = _http(base, "/metrics")[1]
            rc = stop_server(proc)
            check(rc == 0, "tenancy", "SIGTERM drain", rc=rc)
        finally:
            stop_server(proc)
        with open(os.path.join(run_dir, "logs", "events.jsonl")) as f:
            events = [json.loads(line) for line in f]
        pager = metrics["tenants"]["pager"]
        page_ins, evictions, resident = lru_paging(dispatches, 2)
        paged = [e for e in events if e.get("event") == "tenant_paged_in"]
        evicted = [e for e in events if e.get("event") == "tenant_evicted"]
        check((pager["page_ins"], pager["evictions"], pager["resident_tenants"]) == (page_ins, evictions,
                                                                                     sorted(resident))
              and pager["resident_bytes"] == len(resident) * one and pager["budget_bytes"] == budget
              and (len(paged), len(evicted)) == (page_ins, evictions)
              and all(e["tenant"] in TENANT_IDS and e["reason"] == "byte_budget" for e in evicted),
              "tenancy", "page-ins and evictions differ from the LRU arithmetic", pager=pager,
              want={"page_ins": page_ins, "evictions": evictions, "resident": resident},
              events={"paged_in": len(paged), "evicted": len(evicted)})
        adapt_flushes = metrics["adapt_batcher"]["flushes"]
        launches = metrics["compiled"]["fused_sgd_launches"]
        check(launches == cfg.number_of_evaluation_steps_per_iter * adapt_flushes, "tenancy",
              "B1 launches != 5 x adapt flushes", launches=launches, adapt_flushes=adapt_flushes)
        worst = max(devs)
        check(worst <= bound, "tenancy", "a tenant's answer differs from its single-tenant control", max_abs=worst,
              bound=bound)
        out.update({
            "ok": True, "master_bytes": one, "budget_bytes": budget, "adapted_tree_bytes": adapted,
            "quota_resident_bytes": quota, "launches": launches, "adapt_flushes": adapt_flushes,
            "page_ins": page_ins, "evictions": evictions, "resident_bytes": pager["resident_bytes"],
            "server_page_in_p50_ms": pager["page_in_p50_ms"], "answers": len(devs),
            "answers_exact": sum(d == 0.0 for d in devs), "answers_max_abs": worst,
            "answers_max_abs_median": statistics.median(devs), "answers_bound": bound, "http_bound": http_bound,
            "noise_floor_max": max(floors), "noise_floor_median": statistics.median(floors),
            "other_tenant_min_max_abs": min(wrong), "other_tenant_above_bound": min(wrong) > bound,
            "client_adapt_cold_tenant": _percentiles(cold_ms), "client_adapt_default_tenant": _percentiles(resident_ms),
            "control_adapt_predict_ms_median": statistics.median(control_ms),
            "retry_after_s": shed["retry_after_s"],
            "memory_block": {k: metrics.get("memory", {}).get(k) for k in ("available_devices", "headroom_frac_min",
                                                                           "peak_bytes_in_use_max")},
        })
        out.update(tenancy_in_process(system, trained, registry, supports, queries,
                                      os.path.join(run_dir, "tenants", TENANT_IDS[3])))
    emit(out)
    return out


def tenancy_in_process(system, trained, registry, supports, queries, control_dir: str) -> dict:
    """The pager in this process on the card: the last tenant's answer
    against its single-tenant control (``control_dir``) with cuDNN
    deterministic; PAGE_IN_REPS x 2 tenants
    evicted and adapted cold, then adapted again resident (host clock
    around work that ends in a synchronize; the page-in's own time from
    the pager), the first eviction's drop in ``memory_allocated``; an
    eviction through the watermark; ``clone_for_device`` on ``cuda:0``.
    cuDNN's deterministic algorithms are on from the engine's first flush:
    a replay runs the algorithms its program was captured under, and the
    control and the clone are compared with the engine's replays."""
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
    from howtotrainyourmamlpytorch_tpu_torch.serving import ServingFrontend
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine

    engine = AdaptationEngine(system, trained, registry=registry)
    frontend = ServingFrontend(engine)
    x, y = supports[0]
    q = queries[0]
    adapts = 0
    torch.backends.cudnn.deterministic = True
    fu.reset_launch_counts()
    try:
        cold, warm, drops = [], [], []
        for rep in range(PAGE_IN_REPS):
            for tenant in TENANT_IDS[:2]:
                if engine.pager.is_resident(tenant):
                    blocks = _cuda_block_bytes(engine.pager.resident(tenant))
                    torch.cuda.synchronize()
                    before = torch.cuda.memory_allocated()
                    engine.pager.evict(tenant)
                    drops.append((before - torch.cuda.memory_allocated(), blocks))
                for times in (cold, warm):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    engine.adapt(x, y, tenant=tenant)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                    adapts += 1
        samples = engine.pager.page_in_ms()
        check(all(drop == blocks for drop, blocks in drops) and drops, "tenancy",
              "an eviction did not free the master's blocks", drops=drops[:4])
        # the watermark: a floor above any headroom evicts the LRU tenant
        # at the sweep after the next tenant dispatch
        engine.pager.min_headroom_frac = 1.0
        frontend.adapt(x, y, tenant=TENANT_IDS[1])
        adapts += 1
        engine.pager.min_headroom_frac = 0.0
        metrics = frontend.metrics()
        memory = metrics["memory"]
        check(metrics["resilience"].get("tenant_watermark_evictions") == 1
              and metrics["tenants"]["pager"]["resident_tenants"] == [TENANT_IDS[1]]
              and memory["available_devices"] == 1 and memory["headroom_frac_min"] < 1.0,
              "tenancy", "the watermark eviction", resilience=metrics["resilience"],
              pager=metrics["tenants"]["pager"], memory=memory)
        # a tenant against its control, and a clone on the engine's own card
        # against the engine
        ctrl = AdaptationEngine.from_run_dir(control_dir, "latest", cfg=system.cfg, system=system)
        paged = engine.predict(engine.adapt(x, y, tenant=TENANT_IDS[3]), q, tenant=TENANT_IDS[3])
        control_dev = float(abs(paged - ctrl.predict(ctrl.adapt(x, y), q)).max())
        clone = engine.clone_for_device(torch.device("cuda:0"), 1)
        mine = engine.predict(engine.adapt(x, y), q)
        theirs = clone.predict(clone.adapt(x, y), q)
        tmine = engine.predict(engine.adapt(x, y, tenant=TENANT_IDS[2]), q, tenant=TENANT_IDS[2])
        ttheirs = clone.predict(clone.adapt(x, y, tenant=TENANT_IDS[2]), q, tenant=TENANT_IDS[2])
        adapts += 6
        check(control_dev <= ALONE_TOLERANCE["maml++"], "tenancy",
              "a tenant's answer differs from its control under deterministic cuDNN", max_abs=control_dev)
        clone_dev = max(float(abs(mine - theirs).max()), float(abs(tmine - ttheirs).max()))
        check(clone_dev <= ALONE_TOLERANCE["maml++"] and clone.ledger_tag == "@r1" and clone.pager is not engine.pager
              and clone.pager.stats()["page_ins"] == 1, "tenancy", "clone_for_device(cuda:0) differs from the engine",
              max_abs=clone_dev)
        launches = fu.launch_counts["fused_sgd"]
        check(launches == system.cfg.number_of_evaluation_steps_per_iter * adapts, "tenancy",
              "in-process B1 launches != 5 x adapts", launches=launches, adapts=adapts)
    finally:
        torch.backends.cudnn.deterministic = False
        frontend.close()
    p50, p99 = np.percentile(np.asarray(samples, np.float64), [50, 99])
    return {
        "page_in_ms": {"p50": float(p50), "p99": float(p99), "n": len(samples), "max": max(samples)},
        "adapt_cold_ms": _percentiles(cold), "adapt_resident_ms": _percentiles(warm),
        "eviction_freed_bytes": drops[0][0], "watermark_headroom_frac_min": memory["headroom_frac_min"],
        "watermark_bytes_in_use": memory["devices"][0].get("bytes_in_use"), "clone_max_abs": clone_dev,
        "clone_exact": clone_dev == 0.0, "deterministic_control_max_abs": control_dev,
        "in_process_launches": launches, "in_process_adapts": adapts,
    }


def _subreaper(on: bool) -> bool:
    """Make this process the reaper of its orphaned descendants, or stop
    (Linux ``PR_SET_CHILD_SUBREAPER``): a backend the supervisor spawned
    outlives the supervisor's SIGTERM, and when a rolling restart drains it,
    only its parent can reap it. Unreaped, it stays a zombie that
    ``kill(pid, 0)`` still finds, and the drain would wait for its whole
    timeout."""
    import ctypes

    try:
        return ctypes.CDLL(None, use_errno=True).prctl(36, int(on), 0, 0, 0) == 0
    except (AttributeError, OSError):
        return False


class _Reaper:
    """Exit codes of fleet processes this one did not start: one thread per
    pid blocks in ``waitpid`` once the pid is our child (an orphan
    reparented to this subreaper); ``None`` where it never was."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self.rcs = {}
        self._threads = {}

    def watch(self, pid: int) -> None:
        import threading

        def wait():
            try:
                _, status = os.waitpid(pid, 0)
                rc = os.waitstatus_to_exitcode(status)
            except ChildProcessError:
                rc = None
            with self._lock:
                self.rcs[pid] = rc

        with self._lock:
            if pid in self._threads:
                return
            thread = self._threads[pid] = threading.Thread(target=wait, name=f"reap-{pid}", daemon=True)
        thread.start()

    def rc(self, pid: int, timeout_s: float = 30.0):
        thread = self._threads.get(pid)
        if thread is not None:
            thread.join(timeout_s)
        with self._lock:
            return self.rcs.get(pid)


def _wait_for(fn, timeout_s: float, phase: str, what: str, poll_s: float = 0.05):
    """Poll ``fn`` until it returns a truthy value; fail the phase after
    ``timeout_s``."""
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        value = fn()
        if value:
            return value
        time.sleep(poll_s)
    check(False, phase, f"timed out waiting for {what}", timeout_s=timeout_s)


def _b1_per_flush(metrics: dict, steps: int) -> dict:
    """One backend's B1 launches beside ``steps`` x its adapt and refine
    flushes, from its /metrics."""
    flushes = metrics["adapt_batcher"]["flushes"] + metrics.get("refine_batcher", {}).get("flushes", 0)
    launches = metrics["compiled"]["fused_sgd_launches"]
    return {"launches": launches, "flushes": flushes, "equal": launches == steps * flushes}


def prestart_fleet(system, trained) -> dict:
    """Phase ``fleet``'s slots, made before phase ``tenancy``: the trained
    state in a run directory per slot (3 slots, each on a free port) and
    the first two slots' backends started behind one gate, so that their
    imports and card start overlap phase ``tenancy``."""
    from howtotrainyourmamlpytorch_tpu_torch.config import save_config
    from howtotrainyourmamlpytorch_tpu_torch.experiment.checkpoint import save_checkpoint

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    template = os.path.join(tmp, "template")
    os.makedirs(template)
    save_config(system.cfg, os.path.join(template, "config.yaml"))
    save_checkpoint(os.path.join(template, "saved_models"), trained, {"epoch": 0}, epoch=0,
                    feature_shape=system.model.feature_shape)
    slots = []
    for i in range(3):
        run_dir = os.path.join(tmp, f"b{i}")
        shutil.copytree(template, run_dir)
        port = _free_port()
        slots.append({
            "url": f"http://127.0.0.1:{port}", "port": port, "run_dir": run_dir, "cwd": root,
            "log": os.path.join(run_dir, "serve.log"),
            "respawn": [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.serve", run_dir,
                        "--port", str(port), "--device", FLEET_DEVICE, "--checkpoint", "latest"],
        })
    gate = os.path.join(tmp, "backends.gate")
    procs = [start_gated_server(slot["respawn"], slot["log"], gate) for slot in slots[:2]]
    return {"tmp": tmp, "slots": slots, "procs": procs, "gate": gate}


def phase_fleet(seed: int, system, trained, http_bound: float, pre: dict):
    """The serving fleet on the card through the port's import-light CLIs
    (``scripts/gateway.py``, ``scripts/fleet_serve.py``,
    ``scripts/rolling_restart.py``) and the serve CLI: the trained state in
    a run directory per slot (3 pre-provisioned slots), two backends started
    together and handed to the supervisor (min 2, max 3) in its slots file,
    the gateway over the 3 slot URLs. Then loadgen through the gateway (FLEET_STAIRS stairs
    of FLEET_RPS req/s, adapt fraction 0.25) with a kill -9 of the backend
    that holds a warm session mid-load: the gateway marks it OUT within its
    hysteresis window, the supervisor respawns the slot, the displaced
    session answers 404 and re-adapts bit-equal to its first answer (the
    serve CLI's deterministic algorithms), every stair answers. Then the gateway hop (the same /predict through the
    gateway and direct), B1 launches per backend against 5 x its flushes
    (read with no load running), the supervisor stopped (its journal
    drives the roll), a rolling restart under load (drains clean, sessions
    rehydrated, a cache hit after it), the rolled backends' B1 counts, and
    the backends and the gateway stopped, no process left."""
    import signal

    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
    from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import _read_jsonl, spawn_gateway
    from howtotrainyourmamlpytorch_tpu_torch.serving.fleetctl import pid_alive

    t_phase = time.monotonic()
    cfg = system.cfg
    n_way, k_shot, img = cfg.num_classes_per_set, cfg.num_samples_per_class, cfg.image_shape
    steps = cfg.number_of_evaluation_steps_per_iter
    root = os.path.dirname(os.path.abspath(__file__))
    scripts = os.path.join(root, "howtotrainyourmamlpytorch_tpu_torch", "scripts")
    env = dict(os.environ, PYTHONPATH=root)
    data = learnable_synthetic_batch(FLEET_HOP_REPS + 6, n_way, k_shot, 2, img, seed=seed + 13)
    supports = [json.dumps({"x_support": data["x_support"][i].tolist(),
                            "y_support": data["y_support"][i].tolist()}).encode() for i in range(FLEET_HOP_REPS + 6)]
    queries = [data["x_target"][i].reshape(-1, *img)[:HTTP_QUERIES].tolist() for i in range(FLEET_HOP_REPS + 6)]
    subreaper = _subreaper(True)
    reaper = _Reaper()
    procs, pids = [], set()  # everything this phase started, to stop in the end
    out = {"phase": "fleet", "slots": 3, "min_backends": 2, "max_backends": 3, "rps": FLEET_RPS,
           "stairs": FLEET_STAIRS, "load_s": FLEET_LOAD_S, "adapt_frac": 0.25, "subreaper": subreaper}
    tmp, slots, early = pre["tmp"], pre["slots"], pre["procs"]
    try:
        urls = [s["url"] for s in slots]

        def http(url, path, body=None):
            try:
                return _http(url, path, body, headers=True)
            except OSError:
                return None, {}, None, {}

        # the gateway over every slot; the third stays OUT until spawned
        gw_proc, gw = spawn_gateway(urls, os.path.join(tmp, "gateway"))
        procs.append(gw_proc)
        # two backends started together before phase tenancy behind a gate,
        # released now and handed to the supervisor below
        for slot, proc in zip(slots[:2], early):
            procs.append(proc)
            slot["pid"] = proc.pid
            pids.add(proc.pid)
        t0 = time.monotonic()
        open(pre["gate"], "w").close()
        for slot, proc in zip(slots[:2], procs[1:]):
            _wait_for(lambda: http(slot["url"], "/healthz")[0] == 200 or proc.poll() is not None, HTTP_READY_S,
                      "fleet", "a backend's /healthz")
            check(proc.poll() is None, "fleet", "a backend died starting", rc=proc.returncode,
                  log=open(slot["log"]).read()[-3000:])
        out["start_two_backends_s"] = time.monotonic() - t0
        for proc in procs[1:3]:  # reap at exit, so a drain sees the pid go
            reaper.watch(proc.pid)
        slots_path, state_path = os.path.join(tmp, "slots.json"), os.path.join(tmp, "fleet_state.json")
        events_path = os.path.join(tmp, "supervisor_events.jsonl")
        with open(slots_path, "w") as f:
            json.dump(slots, f)
        sup_port_file = os.path.join(tmp, "supervisor_port")
        sup_log = open(os.path.join(tmp, "supervisor.log"), "ab")
        sup = subprocess.Popen(
            [sys.executable, os.path.join(scripts, "fleet_serve.py"), "--state", state_path, "--gateway-url", gw,
             "--slots", slots_path, "--events", events_path, "--metrics-port", "0", "--port-file", sup_port_file,
             "--min-backends", "2", "--max-backends", "3", "--poll-interval-s", "0.25", "--warm-poll-s", "0.25",
             "--warm-timeout-s", str(HTTP_READY_S), "--drain-timeout-s", "60"],
            cwd=root, env=env, stdout=sup_log, stderr=subprocess.STDOUT)
        sup_log.close()
        procs.append(sup)
        start = _wait_for(lambda: next((e for e in _read_jsonl(events_path) if e.get("event") == "supervisor_start"),
                                       None), 60, "fleet", "the supervisor's start")
        check(start["target"] == 2, "fleet", "the supervisor's target", event=start)
        _wait_for(lambda: http(gw, "/metrics")[1].get("backends_in") == 2, 30, "fleet",
                  "the gateway admitting both backends")
        out["fleet_up_s"] = time.monotonic() - t_phase

        # each backend's first /adapt (its cold start), together
        cold = _in_threads([lambda u=s["url"], b=supports[i]: http(u, "/adapt", b) for i, s in enumerate(slots[:2])],
                           2)
        check(all(c[0] == 200 for c in cold), "fleet", "a backend's first /adapt", statuses=[c[0] for c in cold])
        out["first_adapt_ms"] = [c[2] for c in cold]
        # the session the kill displaces: adapted and predicted through the gateway
        status, warm, _, head = http(gw, "/adapt", supports[2])
        check(status == 200, "fleet", "the warm /adapt through the gateway", body=warm)
        aid, owner = warm["adaptation_id"], head.get("X-Gateway-Backend")
        predict_body = json.dumps({"adaptation_id": aid, "x_query": queries[2]}).encode()
        status, before, _, _ = http(gw, "/predict", predict_body)
        check(status == 200, "fleet", "the warm /predict through the gateway", body=before)
        victim = slots[int(owner[1:])]

        # load through the gateway; kill -9 the session's backend mid-load
        load_err = os.path.join(tmp, "loadgen.err")
        load = subprocess.Popen(
            [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.loadgen", "--url", gw, "--seed", str(seed),
             "--duration-s", str(FLEET_LOAD_S), "--stairs", ",".join([str(FLEET_RPS)] * FLEET_STAIRS),
             "--adapt-frac", "0.25", "--n-way", str(n_way), "--k-shot", str(k_shot), "--max-workers", "16",
             "--slo-p99-ms", "30000"],
            cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=open(load_err, "w"), text=True)
        procs.append(load)
        _wait_for(lambda: "loadgen: warm" in open(load_err).read() or load.poll() is not None, 120, "fleet",
                  "loadgen's warm-up")
        check(load.poll() is None, "fleet", "loadgen exited before its load", err=open(load_err).read()[-3000:])
        time.sleep(FLEET_KILL_AT_S)
        kill_wall = time.time()
        os.kill(victim["pid"], signal.SIGKILL)
        out_event = _wait_for(lambda: next((e for e in _read_jsonl(os.path.join(tmp, "gateway", "events.jsonl"))
                                            if e.get("event") == "backend_out" and e.get("backend") == owner
                                            and e["ts"] >= kill_wall), None), 30, "fleet", "the gateway's OUT")
        kill_to_out_ms = (out_event["ts"] - kill_wall) * 1e3
        # the gateway's hysteresis window: fail_threshold probes, one poll
        # round apart, each probe bounded by its timeout
        window_ms = (2 * 0.25 + 3.0) * 1e3
        check(kill_to_out_ms <= window_ms, "fleet", "OUT later than the hysteresis window",
              kill_to_out_ms=kill_to_out_ms, window_ms=window_ms)
        status_404 = http(gw, "/predict", predict_body)[0]
        check(status_404 == 404, "fleet", "the displaced session did not answer 404", status=status_404)
        status, readapt, _, head = http(gw, "/adapt", supports[2])
        status_p, after, _, _ = http(gw, "/predict", predict_body)
        check(status == status_p == 200 and readapt["adaptation_id"] == aid and not readapt["cached"], "fleet",
              "the displaced session's re-adapt", status=status, predict_status=status_p)
        readapt_dev = float(np.abs(np.asarray(after["probs"], np.float32)
                                   - np.asarray(before["probs"], np.float32)).max())
        # the serve CLI runs the deterministic algorithms on the card: a
        # session re-adapted in another backend process is bit-equal
        check(readapt_dev == 0.0, "fleet", "the re-adapted session is not bit-equal across backend processes",
              max_abs=readapt_dev, noise_floor=http_bound)
        report_line, _ = load.communicate(timeout=FLEET_LOAD_S + 180)
        check(load.returncode == 0, "fleet", "loadgen failed", rc=load.returncode, err=open(load_err).read()[-3000:])
        report = json.loads(report_line.strip().splitlines()[-1])
        stairs = [{k: s[k] for k in ("offered_rps", "n_offered", "ok", "shed", "deadline", "error", "unresolved",
                                     "p50_ms", "p99_ms")} for s in report["stairs"]]
        check(all(s["ok"] > 0 for s in stairs) and report["unresolved"] == 0 and report["shed"] == 0
              and report["deadline"] == 0, "fleet", "availability through the kill", stairs=stairs)

        # the supervisor's replacement: the same slot, a new pid, admitted
        replaced = _wait_for(lambda: next((e for e in _read_jsonl(events_path) if e.get("event") == "scale_up"
                                           and e.get("slot") == slots.index(victim)), None), HTTP_READY_S, "fleet",
                             "the supervisor's replacement")
        died = [e for e in _read_jsonl(events_path) if e.get("event") == "backend_died"]
        check(len(died) == 1 and died[0]["slot"] == slots.index(victim), "fleet", "backend_died events", died=died)
        _wait_for(lambda: http(gw, "/metrics")[1].get("backends_in") == 2, 30, "fleet",
                  "the gateway admitting the replacement")
        victim["pid"] = replaced["pid"]
        pids.add(replaced["pid"])
        spawned_wall = replaced["ts"] - replaced["settle_s"]
        first = next((r for r in _read_jsonl(os.path.join(victim["run_dir"], "logs", "access.jsonl"))
                      if r["ts"] >= spawned_wall and r["verb"] == "adapt" and r["outcome"] == "ok"), None)
        if first is not None:
            respawned_first = {"ms": first["total_ms"], "source": "the backend's access log (server side)"}
        else:
            status, _, ms, _ = http(victim["url"], "/adapt", supports[3])
            check(status == 200, "fleet", "the respawned backend's first /adapt", status=status)
            respawned_first = {"ms": ms, "source": "a direct /adapt (client side)"}

        # the gateway hop: the same /predict through the gateway and direct
        survivor = slots[1 - slots.index(victim)] if slots.index(victim) < 2 else slots[0]
        status, hop, _, head = http(gw, "/adapt", supports[4])
        hop_owner = slots[int(head["X-Gateway-Backend"][1:])]
        hop_body = json.dumps({"adaptation_id": hop["adaptation_id"], "x_query": queries[4]}).encode()
        via, direct = [], []
        for _ in range(FLEET_HOP_REPS):
            via.append(http(gw, "/predict", hop_body)[2])
            direct.append(http(hop_owner["url"], "/predict", hop_body)[2])
        # fresh /adapt with two co-resident backends: through the gateway, direct
        adapt_via, adapt_direct = [], []
        for i in range(FLEET_HOP_REPS // 2):
            adapt_via.append(http(gw, "/adapt", supports[5 + 2 * i])[2])
            adapt_direct.append(http(hop_owner["url"], "/adapt", supports[6 + 2 * i])[2])
        check(None not in via + direct + adapt_via + adapt_direct, "fleet", "a hop request failed")

        # B1 per backend, no load running: 5 x its adapt and refine flushes
        live = [survivor, victim]
        b1 = {}
        for slot in live:
            b1[slot["url"]] = _b1_per_flush(http(slot["url"], "/metrics")[1], steps)
        check(all(v["equal"] for v in b1.values()), "fleet", "B1 launches != 5 x flushes", per_backend=b1)

        # the supervisor stops (its control loop only); its journal drives the roll
        sup.send_signal(signal.SIGTERM)
        sup_rc = sup.wait(timeout=60)
        check(sup_rc == 0, "fleet", "the supervisor's SIGTERM", rc=sup_rc)
        for slot in live:
            reaper.watch(slot["pid"])  # the orphaned replacement is ours now
        state = json.load(open(state_path))
        check(sorted(s["slot"] for s in state["slots"] if s["state"] == "up") == [0, 1] and state["intent"] is None,
              "fleet", "the supervisor's journal", slots=state["slots"])

        # a session to find again after the roll
        status, kept, _, head = http(gw, "/adapt", supports[1])
        kept_body = json.dumps({"adaptation_id": kept["adaptation_id"], "x_query": queries[1]}).encode()
        status_p, kept_before, _, _ = http(gw, "/predict", kept_body)
        check(status == status_p == 200, "fleet", "the session kept across the roll")

        # a rolling restart under load: a client thread through the gateway
        import threading

        stop, seen = threading.Event(), []

        def drive():
            k = 0
            while not stop.is_set():
                if k % 3 == 0:
                    seen.append(http(gw, "/adapt", supports[k % len(supports)])[0])
                else:
                    seen.append(http(gw, "/predict", kept_body)[0])
                k += 1
                stop.wait(0.15)

        client = threading.Thread(target=drive, daemon=True)
        client.start()
        t0, roll_wall = time.monotonic(), time.time()
        # each respawned backend is admitted by the gateway before the next drain
        roll = subprocess.run(
            [sys.executable, os.path.join(scripts, "rolling_restart.py"), "--fleet", state_path, "--gateway-url", gw,
             "--drain-timeout-s", "60", "--warm-timeout-s", str(HTTP_READY_S)],
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        roll_s = time.monotonic() - t0
        time.sleep(1.0)
        stop.set()
        client.join(timeout=120)
        verdict = json.loads(roll.stdout.strip().splitlines()[-1]) if roll.stdout.strip() else {}
        for row in verdict.get("rows", []):
            if row.get("new_pid"):
                pids.add(row["new_pid"])
        check(roll.returncode == 0 and verdict.get("ok") and verdict.get("restarted") == 2, "fleet",
              "the rolling restart", rc=roll.returncode, verdict=verdict, err=roll.stderr[-3000:])
        drain_rcs = [reaper.rc(slot["pid"]) for slot in live]
        check(all(rc in (0, None) for rc in drain_rcs) and all(row["drain"] == "sigterm_sent"
                                                               for row in verdict["rows"]),
              "fleet", "a drain of the roll", rcs=drain_rcs, rows=verdict["rows"])
        check(all("admit_s" in row for row in verdict["rows"]), "fleet", "the roll's gateway gate",
              rows=verdict["rows"])
        check(all(code in (200, 404) for code in seen) and seen.count(200) >= 5, "fleet",
              "the fleet through the roll", outcomes=seen,
              gateway_refusals=[r for r in _read_jsonl(os.path.join(tmp, "gateway", "access.jsonl"))
                                if r["ts"] >= roll_wall and r["status"] not in (200, 404)],
              gateway_flaps=[e for e in _read_jsonl(os.path.join(tmp, "gateway", "events.jsonl"))
                             if e["ts"] >= roll_wall])
        new_pid = {row["url"]: row["new_pid"] for row in verdict["rows"]}
        for slot in live:
            slot["pid"] = new_pid[slot["url"]]
            reaper.watch(slot["pid"])  # orphaned when rolling_restart exited
        rehydrated = [http(slot["url"], "/metrics")[1].get("sessions", {}).get("rehydrated", 0) for slot in live]
        check(all(n >= 1 for n in rehydrated), "fleet", "sessions rehydrated after the roll", rehydrated=rehydrated)
        status_p, kept_after, _, _ = http(gw, "/predict", kept_body)
        status, hit, _, _ = http(gw, "/adapt", supports[1])
        check(status == status_p == 200 and hit["cached"], "fleet", "a cache hit after the roll",
              status=status, predict_status=status_p, hit=hit)
        kept_dev = float(np.abs(np.asarray(kept_after["probs"], np.float32)
                                - np.asarray(kept_before["probs"], np.float32)).max())
        check(kept_dev == 0.0, "fleet", "a rehydrated session's answer is not bit-equal", max_abs=kept_dev,
              noise_floor=http_bound)

        # the rolled backends' B1, then everything stops: backends, gateway
        rolled = {}
        for slot in live:
            rolled[slot["url"]] = _b1_per_flush(http(slot["url"], "/metrics")[1], steps)
        check(all(v["equal"] for v in rolled.values()), "fleet", "B1 launches != 5 x flushes after the roll",
              per_backend=rolled)
        for slot in live:
            os.kill(slot["pid"], signal.SIGTERM)
        final_rcs = [reaper.rc(slot["pid"], timeout_s=90) for slot in live]
        gw_proc.send_signal(signal.SIGTERM)
        gw_rc = gw_proc.wait(timeout=30)
        clean = [open(slot["log"]).read().count("serving drain: clean") for slot in live]
        check(all(rc in (0, None) for rc in final_rcs) and gw_rc == 0 and clean == [2, 2], "fleet",
              "the final stop", backend_rcs=final_rcs, gateway_rc=gw_rc, clean_drains_per_slot=clean)
        left = sorted(pid for pid in pids if pid_alive(pid))
        check(not left, "fleet", "processes left running", pids=left)

        events = _read_jsonl(events_path)
        phase_s = time.monotonic() - t_phase
        check(phase_s <= FLEET_BUDGET_S, "fleet", "the phase outran its budget", phase_s=phase_s)
        out.update({
            "ok": True, "phase_s": phase_s, "load": {
                "stairs": stairs, "value": report["value"], "requests": report["requests"],
                "per_backend": report.get("per_backend"), "errors": report["error"]},
            "kill_to_out_ms": kill_to_out_ms, "hysteresis_window_ms": window_ms,
            "respawn_to_ok_s": replaced["settle_s"], "respawned_first_adapt": respawned_first,
            "readapt_max_abs": readapt_dev, "readapt_bit_equal": readapt_dev == 0.0, "noise_floor": http_bound,
            "gateway_hop": {"predict_via_p50_ms": statistics.median(via),
                            "predict_direct_p50_ms": statistics.median(direct),
                            "hop_p50_ms": statistics.median(via) - statistics.median(direct),
                            "adapt_via_p50_ms": statistics.median(adapt_via),
                            "adapt_direct_p50_ms": statistics.median(adapt_direct)},
            "b1_before_roll": b1, "b1_after_roll": rolled,
            "launches": sum(v["launches"] for v in list(b1.values()) + list(rolled.values())),
            "roll_s": roll_s, "roll_rows": verdict["rows"],
            "roll_outcomes": {str(c): seen.count(c) for c in dict.fromkeys(seen)},
            "drain_rcs": {"roll": drain_rcs, "final": final_rcs, "gateway": gw_rc, "supervisor": sup_rc},
            "rehydrated": rehydrated, "rehydrated_max_abs": kept_dev, "rehydrated_bit_equal": kept_dev == 0.0,
            "supervisor_events": {name: sum(e.get("event") == name for e in events)
                                  for name in ("backend_died", "scale_up", "scale_down", "spawn_crash")},
        })
        emit(out)
        return out
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for pid in pids:
            if pid_alive(pid):
                os.kill(pid, signal.SIGKILL)
        _subreaper(False)
        shutil.rmtree(tmp, ignore_errors=True)


def _write_omniglot_class(args):
    """One class of :func:`make_omniglot_folder`: its folder and images."""
    from PIL import Image

    root, seed, c, base_blocks = args
    side = OMNIGLOT["side"]
    noise = np.random.RandomState(seed * 100_003 + c)
    d = os.path.join(root, f"alphabet{c % OMNIGLOT['alphabets']:02d}", f"character{c // OMNIGLOT['alphabets']:02d}")
    os.makedirs(d)
    base = np.kron(base_blocks, np.ones((5, 5), bool))
    for i in range(OMNIGLOT["per_class"]):
        Image.fromarray(base ^ (noise.rand(side, side) > 0.95)).save(os.path.join(d, f"{c:04d}_{i:02d}.png"))


def make_omniglot_folder(root: str, seed: int) -> str:
    """An image folder of Omniglot's layout and size: OMNIGLOT["classes"]
    classes of OMNIGLOT["per_class"] 105x105 1-bit PNGs in
    ``alphabetNN/characterNN/`` folders. Each class is a seeded random
    binary base image (5x5-pixel blocks) and each image flips 5% of its
    pixels. Written by OMNIGLOT_WRITERS forked workers (PNG encoding holds
    the GIL: 4 processes took a fifth of 8 threads' time on a CPU); a
    worker only writes files and never touches the card."""
    import concurrent.futures
    import multiprocessing

    from PIL import Image

    Image.preinit()  # the PNG plugin loads before any worker starts
    rng = np.random.RandomState(seed)
    bases = rng.rand(OMNIGLOT["classes"], OMNIGLOT["side"] // 5, OMNIGLOT["side"] // 5) > 0.5
    jobs = [(root, seed, c, bases[c]) for c in range(OMNIGLOT["classes"])]
    fork = multiprocessing.get_context("fork")
    with concurrent.futures.ProcessPoolExecutor(OMNIGLOT_WRITERS, mp_context=fork) as pool:
        list(pool.map(_write_omniglot_class, jobs, chunksize=16))
    return root


# the image folder's writers: forked processes (PNG encoding holds the GIL)
OMNIGLOT_WRITERS = 4


def _finite(*values) -> bool:
    return all(np.isfinite(float(v)) for v in values)


def check_run_dir(run_dir: str, epochs: int, n_lrs: int) -> list:
    """The run directory's artifacts after ``epochs`` epochs -> its rows."""
    import csv

    from howtotrainyourmamlpytorch_tpu_torch.experiment.storage import load_statistics

    logs = os.path.join(run_dir, "logs")
    with open(os.path.join(logs, "summary_statistics.csv")) as f:
        header = next(csv.reader(f))
    check(header == SUMMARY_COLUMNS, "runner", "summary_statistics.csv columns", header=header)
    rows = load_statistics(logs)
    check([int(float(r["epoch"])) for r in rows] == list(range(epochs)), "runner", "summary rows",
          epochs=[r["epoch"] for r in rows])
    check(all(_finite(r["train_loss_mean"], r["val_loss_mean"]) for r in rows), "runner", "non-finite loss",
          rows=rows)
    with open(os.path.join(run_dir, "lrs.csv")) as f:
        lrs = list(csv.reader(f))
    check([len(r) for r in lrs] == [n_lrs] * epochs, "runner", "lrs.csv rows", shape=[len(r) for r in lrs])
    test = load_statistics(logs, "test_summary.csv")
    check(bool(test) and _finite(test[-1]["test_accuracy_mean"], test[-1]["test_loss_mean"]), "runner",
          "test_summary.csv", rows=test)
    for name in ("config.yaml", os.path.join("logs", "events.jsonl"), os.path.join("logs", "telemetry.jsonl")):
        check(os.path.exists(os.path.join(run_dir, name)), "runner", f"{name} missing")
    return rows


def runner_overrides(seed: int, tmp: str) -> list:
    """Phase ``runner``'s overrides of configs/default.yaml."""
    return [
        "use_pallas_inner_update=true", "remat_inner_steps=false",
        f"dataset.path={os.path.join(tmp, 'omniglot_dataset')}", f"index_cache_dir={os.path.join(tmp, 'index')}",
        f"experiment_root={os.path.join(tmp, 'exps')}", f"total_iter_per_epoch={RUNNER_ITERS}",
        f"num_evaluation_tasks={RUNNER_EVAL_TASKS}", f"seed={seed}",
    ]


# phase runner's image folder and its index, made by a process started
# after phase device (argv: the repository root, the config, the seed, the
# status file, the overrides as JSON); the status file holds the seconds
_RUNNER_DATA = r"""
import json, os, sys, time
root, config, seed, status = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
overrides = json.loads(sys.argv[5])
sys.path.insert(0, root)
import chip_smoke
from howtotrainyourmamlpytorch_tpu_torch.config import load_config
from howtotrainyourmamlpytorch_tpu_torch.data import FewShotDataset
cfg = load_config(config, overrides + ["load_into_memory=false"])
t0 = time.perf_counter()
chip_smoke.make_omniglot_folder(cfg.dataset.path, seed)
t1 = time.perf_counter()
FewShotDataset(cfg)
t2 = time.perf_counter()
with open(status + ".tmp", "w") as f:
    json.dump({"generate_s": t1 - t0, "index_s": t2 - t1}, f)
os.replace(status + ".tmp", status)
"""


def prestart_runner_data(seed: int, tmp: str) -> dict:
    """Phase ``runner``'s image folder and index cache, made in a process
    started after phase ``device``: the writers and the index bootstrap
    (16 and some 15 s of host work) overlap the kernel phases."""
    root = os.path.dirname(os.path.abspath(__file__))
    status = os.path.join(tmp, "runner_data.json")
    log = open(os.path.join(tmp, "runner_data.log"), "ab")
    proc = subprocess.Popen([sys.executable, "-c", _RUNNER_DATA, root, DEFAULT_CONFIG, str(seed), status,
                             json.dumps(runner_overrides(seed, tmp))], cwd=root, stdout=log, stderr=subprocess.STDOUT,
                            env=dict(os.environ, PYTHONPATH=root))
    log.close()
    return {"proc": proc, "status": status, "t0": time.perf_counter()}


def finish_runner_data(pre: dict) -> dict:
    """Wait for :func:`prestart_runner_data`'s process -> its seconds, and
    how long this process waited for it."""
    t0 = time.perf_counter()
    rc = pre["proc"].wait(timeout=600)
    check(rc == 0 and os.path.exists(pre["status"]), "runner", "the image folder's process failed", rc=rc)
    with open(pre["status"]) as f:
        return {**json.load(f), "waited_s": time.perf_counter() - t0}


def phase_runner(seed: int, bare_step_ms: float, tmp: str, data_pre: dict):
    """The experiment layer on the card at the default config: the runner
    in this process for RUNNER_EPOCHS epochs, then three CLI legs at once
    (the resume, ResNet-12, anil); see the module docstring. The generated
    image folder and its index cache (:func:`prestart_runner_data`) stay in
    ``tmp`` for the phases after it; the result names the run directory and
    the digests and losses of the batches epoch 1 consumed (phase
    ``diagnostics`` replays them)."""
    from howtotrainyourmamlpytorch_tpu_torch.config import load_config
    from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningDataLoader
    from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
    from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
    from howtotrainyourmamlpytorch_tpu_torch.scripts.stream_replay_probe import batch_digest
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    overrides = runner_overrides(seed, tmp)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    cli_overrides = [*overrides, f"num_evaluation_tasks={CLI_EVAL_TASKS}", "load_into_memory=false"]
    # three CLI legs, run at once after the runner below, each its own
    # process and run directory on the same folder and index cache (read
    # only): the CLI resuming this run; the slice's full-width model
    # (ResNet-12 at the fleet row's shape), reading the images from disk
    # (no second RAM cache); strategy=anil (the fleet row
    # omniglot.20.5.vgg.gd.anil), at the config's matmul precision like
    # every leg. They start once the folder is written and wait behind
    # their gates; each leg's seconds are its wall time from its release,
    # beside the others.
    resnet_overrides = [*cli_overrides, *RESNET_OVERRIDES, "total_epochs=1", f"total_iter_per_epoch={CLI_ITERS}",
                        "experiment_name=resnet12_cli"]
    anil_overrides = [*cli_overrides, "strategy=anil", "total_epochs=1", f"total_iter_per_epoch={CLI_ITERS}",
                      "experiment_name=anil_cli"]
    resnet_cfg, anil_cfg = load_config(DEFAULT_CONFIG, resnet_overrides), load_config(DEFAULT_CONFIG, anil_overrides)
    made = finish_runner_data(data_pre)
    legs = {name: GatedCli(["--config", DEFAULT_CONFIG, *leg_overrides], env, os.path.join(tmp, f"cli_{name}.gate"))
            for name, leg_overrides in (("resume", [*cli_overrides, f"total_epochs={RESUMED_EPOCHS}"]),
                                        ("resnet12", resnet_overrides), ("anil", anil_overrides))}
    cfg = load_config(DEFAULT_CONFIG, overrides + [f"total_epochs={RUNNER_EPOCHS}"])
    t0 = time.perf_counter()
    runner = ExperimentRunner(cfg)  # builds the index and the RAM cache
    init_s = time.perf_counter() - t0
    check(runner.start_epoch == 0, "runner", "the run directory was not fresh")
    real, calls, box, step_losses = runner.system.train_step, [], {}, []

    def step(state, batch, epoch=None):
        calls.append(time.perf_counter())
        if len(calls) != RUNNER_PROFILED_CALL:
            result = real(state, batch, epoch=epoch)
        else:
            box["profile"] = profile_device(lambda: box.setdefault("out", real(state, batch, epoch=epoch)))
            result = box["out"]
        step_losses.append(result[1].loss)  # read after the run: no sync here
        return result

    # the digest of every train batch the loader hands the runner
    real_batches, digests = runner.loader.train_batches, []

    def digested(*args, **kwargs):
        for b in real_batches(*args, **kwargs):
            digests.append(batch_digest(b))
            yield b

    runner.system.train_step = step
    runner.loader.train_batches = digested
    fu.reset_launch_counts()  # the runner's path starts here
    t0 = time.perf_counter()
    result = runner.run_experiment()
    run_s = time.perf_counter() - t0
    launches = dict(fu.launch_counts)  # and ends here
    copies = fu.contiguous_copies
    phases = runner.hub.registry.summaries("phase.")
    loader_stats = runner.loader.stats()
    K, K_eval = cfg.number_of_training_steps_per_iter, cfg.number_of_evaluation_steps_per_iter
    train_steps = RUNNER_EPOCHS * RUNNER_ITERS
    eval_batches = RUNNER_EVAL_TASKS // cfg.batch_size
    eval_steps = (RUNNER_EPOCHS + 1) * eval_batches  # val every epoch, then the test
    n_lrs = len(tree_leaves(runner.state.inner_hparams["lr"]))
    rows = check_run_dir(runner.run_dir, RUNNER_EPOCHS, n_lrs)
    check(n_lrs == 18, "runner", "the default model has 18 learned lrs", n_lrs=n_lrs)
    check(len(calls) == train_steps == len(digests), "runner", "train steps", calls=len(calls),
          digests=len(digests), want=train_steps)
    want = {"fused_sgd": K * train_steps + K_eval * eval_steps, "fused_sgd_bwd": K * train_steps}
    check(launches == want, "runner", "kernel launches through the runner", launches=launches, want=want)
    check(copies == K * train_steps, "runner", "leaf copies other than the head cotangent per B2 launch",
          contiguous_copies=copies, want=K * train_steps)
    batches = train_steps + eval_steps
    check(loader_stats["numpy_batches"] == 0 and loader_stats["native_batches"] == batches, "runner",
          "the native episode engine did not assemble every batch", stats=loader_stats, want=batches)
    check(_finite(result["test_loss_mean"]), "runner", "non-finite test loss", result=result)

    # the step period in epoch 1 (steady state, no profiler): from one
    # train_step call to the next, data wait and lagged settle included
    epoch1 = calls[RUNNER_ITERS:]
    period_ms = [(b - a) * 1e3 for a, b in zip(epoch1, epoch1[1:])]
    epoch_s = [float(r["epoch_run_time"]) for r in rows]
    share = {name: phases[name]["sum_ms"] / (run_s * 1e3) for name in
             ("data_wait", "dispatch", "settle", "eval", "checkpoint") if name in phases}

    # the loader alone on the same RAM cache: native path, meta-batch 8
    loader = MetaLearningDataLoader(cfg, dataset=runner.loader.dataset)
    list(loader.train_batches(2))
    t0 = time.perf_counter()
    for _ in loader.train_batches(LOADER_BATCHES):
        pass
    loader_s = time.perf_counter() - t0
    alone = loader.stats()
    loader.close()
    check(alone["numpy_batches"] == 0, "runner", "the loader fell back to numpy", stats=alone)

    _, book = ckpt.load_for_inference(runner.saved_models_dir, "latest")
    cursor = RUNNER_EPOCHS * RUNNER_ITERS * cfg.batch_size
    check(book["train_episodes_produced"] == cursor, "runner", "checkpoint cursor", bookkeeping=book)
    t0 = time.perf_counter()
    for leg in legs.values():
        leg.release()
    try:
        while None in [leg.poll() for leg in legs.values()] and time.perf_counter() - t0 < 600:
            time.sleep(0.2)
        check(all(leg.seconds is not None for leg in legs.values()), "runner", "a CLI leg ran past 600 s",
              finished=sorted(name for name, leg in legs.items() if leg.seconds is not None))
    finally:
        for leg in legs.values():
            leg.stop()
    done = {name: leg.result(timeout=LEG_EXIT_WAIT_S) for name, leg in legs.items()}
    cli_s, resnet_cli_s, anil_cli_s = (done[name][1] for name in ("resume", "resnet12", "anil"))

    rc, _, stdout, stderr = done["resume"]
    tail = (stdout[-3000:], stderr[-3000:])
    check(rc == 0, "runner", "the CLI resume failed", rc=rc, tail=tail)
    printed = [line.split(":")[0] for line in stdout.splitlines() if line.startswith("epoch ")]
    check(printed == [f"epoch {RUNNER_EPOCHS}"], "runner", "the resumed CLI trained other epochs",
          printed=printed)
    check(f"resumed: epoch {RUNNER_EPOCHS}, train episodes {cursor}" in stdout, "runner",
          "the resumed CLI's loader cursor", tail=tail)
    check_run_dir(runner.run_dir, RESUMED_EPOCHS, n_lrs)
    saved = sorted(os.listdir(runner.saved_models_dir))
    want_saved = [f"train_model_{i}" for i in (0, 1, 2, "best", "latest")]
    check(all(name in saved for name in want_saved), "runner", "checkpoints missing", saved=saved)
    _, book = ckpt.load_for_inference(runner.saved_models_dir, "latest")
    check(book["epoch"] == RUNNER_EPOCHS and book["train_episodes_produced"] == cursor + RUNNER_ITERS * cfg.batch_size,
          "runner", "resumed checkpoint bookkeeping", bookkeeping=book)

    rc, _, stdout, stderr = done["resnet12"]
    check(rc == 0, "runner", "the ResNet-12 CLI run failed", rc=rc, tail=(stdout[-3000:], stderr[-3000:]))
    resnet_rows = check_run_dir(resnet_cfg.run_dir(), 1, RESNET_LEAVES)
    resnet_saved = sorted(os.listdir(os.path.join(resnet_cfg.run_dir(), "saved_models")))
    check(all(name in resnet_saved for name in ("train_model_0", "train_model_best", "train_model_latest")),
          "runner", "ResNet-12 checkpoints missing", saved=resnet_saved)

    rc, _, stdout, stderr = done["anil"]
    check(rc == 0, "runner", "the anil CLI run failed", rc=rc, tail=(stdout[-3000:], stderr[-3000:]))
    anil_rows = check_run_dir(anil_cfg.run_dir(), 1, n_lrs)
    check(load_config(os.path.join(anil_cfg.run_dir(), "config.yaml")).strategy == "anil", "runner",
          "the anil run's config.yaml")
    report = analysis_report(os.path.join(tmp, "exps"), os.path.join(tmp, "analysis"), env,
                             [runner.run_dir, resnet_cfg.run_dir(), anil_cfg.run_dir()])
    out = {
        "phase": "runner", "ok": True,
        "config": f"configs/default.yaml + use_pallas_inner_update=true, total_iter_per_epoch={RUNNER_ITERS}, "
                  "num_evaluation_tasks=40",
        "data": {**OMNIGLOT, "writers": OMNIGLOT_WRITERS, **made, "runner_init_s": init_s},
        "run_dir": runner.run_dir, "index_cache_dir": cfg.index_cache_dir,
        "epoch1_batches": digests[RUNNER_ITERS:], "epoch1_losses": [float(x) for x in step_losses[RUNNER_ITERS:]],
        "epochs": RUNNER_EPOCHS, "resumed_to": RESUMED_EPOCHS, "train_steps": train_steps,
        "eval_steps": eval_steps, "launches": launches, "contiguous_copies": copies, "loader": loader_stats,
        "run_s": run_s, "epoch_train_s": epoch_s,
        "train_steps_per_s": RUNNER_ITERS / epoch_s[-1],
        "runner_step_period_ms_median": statistics.median(period_ms), "runner_step_period_ms": period_ms,
        "bare_step_ms_median": bare_step_ms,
        "phase_share_of_run": share, "phases": phases,
        "loader_episodes_per_s": LOADER_BATCHES * cfg.batch_size / loader_s,
        "loader_batches_per_s": LOADER_BATCHES / loader_s,
        "runner_step_profile": box.get("profile"),
        "losses": {"train": [float(r["train_loss_mean"]) for r in rows],
                   "val": [float(r["val_loss_mean"]) for r in rows], "test": result["test_loss_mean"]},
        "test_accuracy": result["test_accuracy_mean"], "cli_resume_s": cli_s,
        "cli_legs": {"num_evaluation_tasks": CLI_EVAL_TASKS, "load_into_memory": False, "concurrent": True},
        "resnet_cli": {"overrides": RESNET_OVERRIDES + ["total_epochs=1", f"total_iter_per_epoch={CLI_ITERS}"],
                       "s": resnet_cli_s, "train_loss": float(resnet_rows[0]["train_loss_mean"]),
                       "val_loss": float(resnet_rows[0]["val_loss_mean"])},
        "anil_cli": {"overrides": ["strategy=anil", "total_epochs=1", f"total_iter_per_epoch={CLI_ITERS}"],
                     "s": anil_cli_s, "train_loss": float(anil_rows[0]["train_loss_mean"]),
                     "val_loss": float(anil_rows[0]["val_loss_mean"])},
        "analysis": report,
    }
    emit(out)
    return out


def _perturbed(batch, scale: float):
    """``batch`` with its support images moved by ``scale``."""
    return dict(batch, x_support=batch["x_support"] + np.float32(scale))


# the training CLI (``python -m howtotrainyourmamlpytorch_tpu_torch.train``
# with the arguments after ``-c``) in a fresh process that imports and
# starts the card, then waits for the file SMOKE_GATE names before it runs;
# it exits if the process that started it is gone
_GATED_TRAIN = r"""
import importlib, os, sys, time
parent = os.getppid()
import torch
from howtotrainyourmamlpytorch_tpu_torch import train
main = importlib.import_module(os.environ.get("SMOKE_MAIN", train.__name__)).main
if torch.cuda.is_available():
    torch.zeros(1, device="cuda")
while not os.path.exists(os.environ["SMOKE_GATE"]):
    if os.getppid() != parent:
        sys.exit(3)
    time.sleep(0.02)
sys.exit(main(sys.argv[1:]))
"""


#: the seconds a stopped leg's exit is waited for before its result is read
LEG_EXIT_WAIT_S = 10.0


class GatedCli:
    """One training CLI leg (or another module's ``main(argv)``,
    ``main_module``) started now and run at :meth:`release`: its
    imports and its card start (16-20 s on the card machine) overlap the
    work before it instead of following it. ``seconds`` runs from the
    release to the exit. Every leg not yet stopped is in ``GatedCli.live``
    (:meth:`stop_all`)."""

    live: list = []

    def __init__(self, args, env, gate: str, main_module: str = ""):
        self.gate = gate
        self.out, self.err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        env = dict(env, SMOKE_GATE=gate, **({"SMOKE_MAIN": main_module} if main_module else {}))
        self.proc = subprocess.Popen([sys.executable, "-c", _GATED_TRAIN, *args], stdout=self.out,
                                     stderr=self.err, text=True, env=env,
                                     cwd=os.path.dirname(os.path.abspath(__file__)))
        self.t0 = self.seconds = None
        GatedCli.live.append(self)

    def release(self) -> None:
        self.t0 = time.perf_counter()
        open(self.gate, "w").close()

    def poll(self):
        rc = self.proc.poll()
        if rc is not None and self.t0 is not None and self.seconds is None:
            self.seconds = time.perf_counter() - self.t0
        return rc

    def run(self, timeout_s: float = 300.0):
        """Release and wait -> :meth:`result`."""
        self.release()
        try:
            self.proc.wait(timeout=timeout_s)
        finally:
            self.stop()
        return self.result(timeout=LEG_EXIT_WAIT_S)

    def result(self, timeout: float):
        """Wait up to ``timeout`` s for the exit (a stopped leg has exited)
        -> (rc, seconds, stdout, stderr); rc None if it is still running."""
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        self.poll()
        stdout, stderr = (f.seek(0) or f.read() for f in (self.out, self.err))
        return self.proc.returncode, self.seconds, stdout, stderr

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if self in GatedCli.live:
            GatedCli.live.remove(self)

    @classmethod
    def stop_all(cls) -> None:
        for leg in list(cls.live):
            leg.stop()


def _elastic_leg(args, env, gate: str) -> GatedCli:
    """One training CLI leg of phase ``elastic`` on the card, behind
    ``gate``."""
    return GatedCli(["--config", DEFAULT_CONFIG, "--device", ELASTIC_DEVICE, *args], env, gate)


def _elastic_run(leg: GatedCli):
    """Release ``leg`` and wait -> (rc, seconds, stdout, the ends of
    stdout and stderr)."""
    rc, seconds, stdout, stderr = leg.run()
    return rc, seconds, stdout, (stdout[-2000:], stderr[-2000:])


def _run_events(run_dir: str):
    with open(os.path.join(run_dir, "logs", "events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _last_cold_start(run_dir: str):
    """The newest ``cold_start`` event's seconds (a runner's init to its
    first settled step)."""
    starts = [e["cold_start_s"] for e in _run_events(run_dir) if e.get("event") == "cold_start"]
    return starts[-1] if starts else None


def elastic_overrides(seed: int, tmp: str) -> tuple:
    """Phase ``elastic``'s run settings on phase ``runner``'s folder and
    index cache -> (the dp=2 run's overrides, the fault run's, the CLI
    legs' environment)."""
    from howtotrainyourmamlpytorch_tpu_torch.config import load_config

    data = os.path.join(tmp, "omniglot_dataset")
    overrides = [
        "use_pallas_inner_update=true", "remat_inner_steps=false", f"dataset.path={data}",
        f"index_cache_dir={os.path.join(tmp, 'index')}", f"experiment_root={os.path.join(tmp, 'elastic')}",
        "experiment_name=elastic", f"total_iter_per_epoch={ELASTIC_ITERS}",
        f"num_evaluation_tasks={load_config(DEFAULT_CONFIG).batch_size}",
        "load_into_memory=false", f"seed={seed}", "parallel.dp=2", "checkpoint_async=true", "checkpoint_shards=0",
    ]
    fault_args = overrides + ["experiment_name=elastic_fault", f"total_epochs={ELASTIC_FAULT_EPOCHS}",
                              "checkpoint_shards=2"]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    env.pop("HTYMP_FAULTS", None)
    return overrides, fault_args, env


def prestart_elastic(seed: int, tmp: str) -> dict:
    """Phase ``elastic``'s three CLI legs, started before phase ``runner``:
    the fault run, its resume and the shrink each import and start the
    card behind a gate while the phases before them run."""
    overrides, fault_args, env = elastic_overrides(seed, tmp)
    gates = os.path.join(tmp, "elastic_gates")
    os.makedirs(gates, exist_ok=True)
    return {"fault": _elastic_leg(fault_args, dict(env, HTYMP_FAULTS=ELASTIC_FAULT), os.path.join(gates, "fault")),
            "resume": _elastic_leg(fault_args, env, os.path.join(gates, "resume")),
            "shrink": _elastic_leg(overrides + ["total_epochs=2"], env, os.path.join(gates, "shrink"))}


def phase_elastic(seed: int, tmp: str, legs: dict):
    """Elastic data-parallel training on the card at configs/default.yaml
    (fused update, remat off), on phase ``runner``'s image folder and index
    cache; see the module docstring. The mesh names cuda:0 several times:
    the dp=2 and dp=4 code paths on the one card. ``legs``: the three CLI
    legs (:func:`prestart_elastic`)."""
    from howtotrainyourmamlpytorch_tpu_torch.config import ParallelConfig, load_config
    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
    from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
    from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
    from howtotrainyourmamlpytorch_tpu_torch.parallel import make_mesh, replicate, shard_batch

    t_phase = time.perf_counter()
    card = torch.device("cuda", 0) if ELASTIC_DEVICE == "cuda" else torch.device(ELASTIC_DEVICE)
    cfg, system, start = full_width_system(seed)
    K, K_eval = cfg.number_of_training_steps_per_iter, cfg.number_of_evaluation_steps_per_iter
    batch = learnable_synthetic_batch(cfg.batch_size, cfg.num_classes_per_set, cfg.num_samples_per_class,
                                      cfg.num_target_samples, cfg.image_shape, seed=seed + 5)
    launches = {"fused_sgd": 0, "fused_sgd_bwd": 0}

    def add(counts):
        for key in launches:
            launches[key] += counts.get(key, 0)

    # 1. the sharded step against dp=1, beside the card's float32 floor
    fu.reset_launch_counts()
    loss1, g1, floor, gate = _dp1_floor(system, start, batch)
    add(fu.launch_counts)
    per_dp = {}
    for dp in ELASTIC_DPS:
        mesh = make_mesh(ParallelConfig(dp=dp), [card] * dp) if dp > 1 else None
        state = replicate(start, mesh) if mesh else start
        feed = (lambda b: shard_batch(b, mesh)) if mesh else (lambda b: b)
        entry = {}
        if mesh:
            fu.reset_launch_counts()
            loss, _, g = system.meta_gradients(state, feed(batch), epoch=0)
            add(fu.launch_counts)
            entry.update(loss=float(loss), loss_diff=abs(float(loss) - float(loss1)),
                         cosine=_cosine(_flat(g1), _flat(g)))
            check(entry["loss_diff"] <= gate["loss"] and 1.0 - entry["cosine"] <= gate["one_minus_cosine"],
                  "elastic", f"dp={dp} step off dp=1 beyond the floor", entry=entry, floor=floor, gate=gate)
        else:
            entry.update(loss=float(loss1), loss_diff=0.0, cosine=1.0)
        fu.reset_launch_counts()
        s, _, ms = _steps(system, state, feed(batch), ELASTIC_STEPS + 1)
        step_launches = dict(fu.launch_counts)
        add(step_launches)
        want = {"fused_sgd": dp * K * (ELASTIC_STEPS + 1), "fused_sgd_bwd": dp * K * (ELASTIC_STEPS + 1)}
        check(step_launches == want, "elastic", f"dp={dp}: B1 and B2 not dp x K per step",
              launches=step_launches, want=want)
        entry.update(step_ms_median=statistics.median(ms[1:]), step_ms=ms[1:], launches_per_step=dp * K)
        per_dp[dp] = entry
    base_ms = per_dp[1]["step_ms_median"]
    ratios = {f"dp{dp}/dp1": per_dp[dp]["step_ms_median"] / base_ms for dp in ELASTIC_DPS if dp > 1}
    steps_s = time.perf_counter() - t_phase

    # 2. write under dp=2 in this process (async, one shard per mesh entry)
    overrides, fault_args, env = elastic_overrides(seed, tmp)
    eval_launch = lambda dp, evals: dp * K_eval * evals  # noqa: E731
    run_cfg = load_config(DEFAULT_CONFIG, overrides + ["total_epochs=1"])

    # 5 (beside 2-4, a run of its own): SIGTERM on the writer thread during
    # an async 2-shard save, then a clean resume (its two CLI processes,
    # like the shrink's (3 below), started before phase runner, overlap the
    # chain below instead of following it)
    fault_dir = load_config(DEFAULT_CONFIG, fault_args).run_dir()
    fault_legs = {}

    def fault_chain():
        fault_legs["fault"] = _elastic_run(legs["fault"])
        fault_legs["fault_cold"] = _last_cold_start(fault_dir)
        if fault_legs["fault"][0] == 75:
            fault_legs["book"] = ckpt.load_for_inference(os.path.join(fault_dir, "saved_models"), "latest")[1]
            fault_legs["resume"] = _elastic_run(legs["resume"])
        else:
            legs["resume"].stop()

    fault_thread = threading.Thread(target=fault_chain, name="elastic-fault-chain", daemon=True)
    fault_thread.start()
    try:  # a failed check below still waits for the fault chain's processes
        fu.reset_launch_counts()
        runner = ExperimentRunner(run_cfg, devices=[card, card])
        check(runner.mesh is not None and runner.mesh.shape == {"dp": 2, "mp": 1}, "elastic", "no dp=2 mesh",
              mesh=repr(runner.mesh))
        runner.run_experiment()
        got = dict(fu.launch_counts)
        add(got)
        want = {"fused_sgd": 2 * K * ELASTIC_ITERS + eval_launch(2, 2), "fused_sgd_bwd": 2 * K * ELASTIC_ITERS}
        check(got == want, "elastic", "dp=2 runner launches", launches=got, want=want)
        save_dir = runner.saved_models_dir
        files = sorted(os.listdir(save_dir))
        shard_bytes = {name: os.path.getsize(os.path.join(save_dir, name)) for name in files
                       if name.startswith("train_model_latest")}
        check(set(shard_bytes) >= {"train_model_latest", "train_model_latest.shard0", "train_model_latest.shard1"}
              and "train_model_latest.shard2" not in shard_bytes, "elastic", "format-3 latest with 2 shards",
              files=files)
        with open(os.path.join(save_dir, "train_model_latest"), "rb") as f:
            manifest_format = ckpt._restore(f.read())["format"]
        check(manifest_format == ckpt.SHARDED_FORMAT, "elastic", "latest is not format 3", format=manifest_format)
        _, book = ckpt.load_for_inference(save_dir, "latest")
        check(book["mesh"] == [2, 1] and book["epoch"] == 0, "elastic", "dp=2 bookkeeping", bookkeeping=book)

        # the same checkpoint (the run's only epoch is its best, which the test
        # left in place) evaluated on dp=2 and on a runner shrunk to one device
        # the gate: twice the eval's own floor (the dp=2 eval again, and
        # with the val images moved by 1e-6)
        fu.reset_launch_counts()
        evals = {"dp2": runner._eval_split("val")}
        val_floor = eval_floor(runner, evals["dp2"]["val_loss_mean"])
        runner.loader.close()
        shrunk = ExperimentRunner(run_cfg, devices=[card], device_probe=lambda: 1)
        evals["one_device"], evals["one_device_degraded"] = shrunk._eval_split("val"), shrunk.degraded_mesh
        shrunk.loader.close()
        shrunk.events.close()
        add(fu.launch_counts)
        val_diff = (abs(evals["one_device"]["val_loss_mean"] - evals["dp2"]["val_loss_mean"])
                    / abs(evals["dp2"]["val_loss_mean"]))
        check(evals["one_device_degraded"] == {"requested": [2, 1], "granted": [1, 1], "visible_devices": 1}
              and val_diff <= val_floor["gate"], "elastic", "the degraded eval of the dp=2 checkpoint", evals=evals,
              val_loss_rel_diff=val_diff, floor=val_floor)

        # 3. shrink: the CLI resumes on the one visible card
        is_degraded = lambda e: e.get("event") == "degraded_mesh"  # noqa: E731
        n_degraded = len([e for e in _run_events(runner.run_dir) if is_degraded(e)])
        rc_shrink, shrink_s, stdout, tail = _elastic_run(legs["shrink"])
        check(rc_shrink == 0, "elastic", "the shrink CLI resume failed", rc=rc_shrink, tail=tail)
        cold = {"shrink_cli": _last_cold_start(runner.run_dir)}
        degraded = [e for e in _run_events(runner.run_dir) if is_degraded(e)][n_degraded:]
        check(len(degraded) == 1 and "DEGRADED MESH" in stdout
              and {k: degraded[0][k] for k in ("requested", "granted", "visible_devices")}
              == {"requested": [2, 1], "granted": [1, 1], "visible_devices": 1}, "elastic",
              "the CLI logged no degraded_mesh event", degraded=degraded, tail=tail)
        check("resumed: epoch 1" in stdout and "epoch 1:" in stdout, "elastic", "the shrink CLI did not train epoch 1",
              tail=tail)

        # 4. grow back in this process: the probe sees 1, then 2 at the epoch boundary
        probes = iter([1])
        fu.reset_launch_counts()
        grow = ExperimentRunner(load_config(DEFAULT_CONFIG, overrides + ["total_epochs=3"]), devices=[card, card],
                                device_probe=lambda: next(probes, 2))
        check(grow.start_epoch == 2 and grow.mesh is None, "elastic", "the grow run did not start degraded",
              start_epoch=grow.start_epoch, mesh=repr(grow.mesh))
        grow.run_experiment()
        got = dict(fu.launch_counts)
        add(got)
        grown = [e for e in _run_events(grow.run_dir) if e.get("event") == "mesh_grown"]
        check(bool(grown) and grown[-1]["previous"] == [1, 1] and grown[-1]["granted"] == [2, 1]
              and grow.mesh is not None and grow.mesh.shape["dp"] == 2, "elastic", "no mesh_grown", grown=grown)
        want = {"fused_sgd": 2 * K * ELASTIC_ITERS + eval_launch(2, 2), "fused_sgd_bwd": 2 * K * ELASTIC_ITERS}
        check(got == want, "elastic", "the grown mesh's launches are not 2 x K per step", launches=got, want=want)
    finally:
        fault_thread.join(timeout=600)
        legs["shrink"].stop()

    # 5: the fault chain's results
    check(not fault_thread.is_alive(), "elastic", "the fault chain's CLI legs ran past 600 s")
    rc_fault, fault_s, _, tail = fault_legs["fault"]
    check(rc_fault == 75, "elastic", "the SIGTERM-during-save leg did not exit 75", rc=rc_fault, tail=tail)
    cold["fault_cli"] = fault_legs["fault_cold"]
    check("resume" in fault_legs, "elastic", "the fault chain stopped before its resume (see stderr)")
    book = fault_legs["book"]
    rc_resume, resume_s, stdout, tail = fault_legs["resume"]
    check(rc_resume == 0 and f"resumed: epoch {book['epoch'] + 1}" in stdout, "elastic",
          "the clean resume after the fault failed", rc=rc_resume, bookkeeping=book, tail=tail)
    cold["resume_cli"] = _last_cold_start(fault_dir)
    _, final = ckpt.load_for_inference(os.path.join(fault_dir, "saved_models"), "latest")
    check(final["epoch"] == ELASTIC_FAULT_EPOCHS - 1, "elastic", "the resumed run did not finish its last epoch",
          bookkeeping=final)

    out = {
        "phase": "elastic", "ok": True,
        "config": "configs/default.yaml + use_pallas_inner_update=true, remat off; mesh entries cuda:0",
        "per_dp": per_dp, "step_ratios": ratios, "floor": floor, "gate": gate,
        "gate_rule": f"|loss - dp1| and 1 - cosine within {ELASTIC_FLOOR_FACTOR}x the floor (the larger of the "
                     f"same dp=1 step twice and a {NOISE_SCALE} move of the support images), at least "
                     f"{ELASTIC_MIN_RTOL} relative",
        "launches": launches, "shard_bytes": shard_bytes, "evals": evals, "val_loss_rel_diff": val_diff,
        "degraded_eval_gate": {"floor": val_floor["floor"], "value": val_diff, "gate": val_floor["gate"],
                               "eval_floor": val_floor},
        "degraded_event": degraded[0], "grown_event": grown[-1], "fault": ELASTIC_FAULT,
        "rcs": {"shrink": rc_shrink, "fault": rc_fault, "resume": rc_resume},
        "seconds": {"steps": steps_s, "shrink_cli": shrink_s, "fault_cli": fault_s, "resume_cli": resume_s,
                    "phase": time.perf_counter() - t_phase},
        "cli_cold_start_s": cold,
    }
    emit(out)
    # the dp=1 reference phase tensor_parallel holds its steps to (the same
    # config, start state and batch)
    return {**out, "reference": {"loss": loss1, "grads": g1, "floor": floor, "gate": gate,
                                 "step_ms": per_dp[1]["step_ms"]}}


TP_DEVICE = "cuda"
TP_DP, TP_MP = 2, 2
TP_STEPS = 2  # timed steps per width, after one untimed
TP_CHUNK = 3  # steps per multi-step dispatch of the graph leg
TP_ITERS = 2  # the runner leg's steps (one epoch)
TENSOR_PARALLEL_BUDGET_S = 60.0


def _dp1_floor(system, start, batch):
    """The card's float32 floor at dp=1: the larger of the same step twice
    and its move under a NOISE_SCALE change of the support images, for the
    loss and for 1 - cosine of the meta-gradient -> (loss, grads, floor,
    gate)."""
    loss1, _, g1 = system.meta_gradients(start, batch, epoch=0)
    loss1b, _, g1b = system.meta_gradients(start, batch, epoch=0)
    floor_loss, floor_cos = abs(float(loss1b) - float(loss1)), 1.0 - _cosine(_flat(g1), _flat(g1b))
    moved = []
    for sign in (1.0, -1.0):
        lp, _, gp = system.meta_gradients(start, _perturbed(batch, sign * NOISE_SCALE), epoch=0)
        moved.append((abs(float(lp) - float(loss1)), 1.0 - _cosine(_flat(g1), _flat(gp))))
    floor = {"loss": max([floor_loss] + [m[0] for m in moved]),
             "one_minus_cosine": max([floor_cos] + [m[1] for m in moved]),
             "same_step_twice": {"loss": floor_loss, "one_minus_cosine": floor_cos}, "noise_scale": NOISE_SCALE}
    gate = {"loss": max(ELASTIC_FLOOR_FACTOR * floor["loss"], ELASTIC_MIN_RTOL * abs(float(loss1))),
            "one_minus_cosine": max(ELASTIC_FLOOR_FACTOR * floor["one_minus_cosine"], ELASTIC_MIN_RTOL)}
    return loss1, g1, floor, gate


#: the moves of the val images an eval's floor samples: +-NOISE_SCALE on
#: every pixel, and NOISE_SCALE with the sign of each pixel drawn from
#: these seeds (the difference the degraded-eval gates bound is reorder
#: noise, which is not one uniform shift; the loss's move under a 1e-6
#: move is heavy-tailed over draws)
EVAL_FLOOR_SIGNS, EVAL_FLOOR_SEEDS = (1.0, -1.0), (0, 1, 2)


def _moved_images(batch, scale: float, seed=None):
    """``batch`` with its support and target images moved by ``scale``,
    every pixel alike, or with a sign per pixel drawn from ``seed``."""
    def move(x):
        if seed is None:
            return x + np.float32(scale)
        sign = np.sign(np.random.RandomState(seed).randn(*x.shape)).astype(np.float32)
        return x + np.float32(scale) * sign

    return dict(batch, x_support=move(batch["x_support"]), x_target=move(batch["x_target"]))


def eval_floor(runner, first: float) -> dict:
    """The float32 floor of a runner's val eval on its own state: the
    largest relative move of the val loss (``first``: one eval's) over the
    same eval again and over the val images (support and target) moved by
    NOISE_SCALE (EVAL_FLOOR_SIGNS uniformly, EVAL_FLOOR_SEEDS with a drawn
    sign per pixel); the gate is ELASTIC_FLOOR_FACTOR times it, at least
    ELASTIC_MIN_RTOL. The eval's own quantity under the algorithms the
    compared evals run (the default ones)."""
    rel = lambda x: abs(x - first) / max(abs(first), 1e-12)  # noqa: E731
    again = runner._eval_split("val")["val_loss_mean"]
    real = runner._eval_batches
    moved = {}
    for name, scale, seed in ([(f"uniform{s:+.0f}", s * NOISE_SCALE, None) for s in EVAL_FLOOR_SIGNS]
                              + [(f"signs{seed}", NOISE_SCALE, seed) for seed in EVAL_FLOOR_SEEDS]):
        runner._eval_batches = lambda split, sc=scale, sd=seed: (_moved_images(b, sc, sd) for b in real(split))
        try:
            moved[name] = rel(runner._eval_split("val")["val_loss_mean"])
        finally:
            del runner._eval_batches
    floor = max([rel(again)] + list(moved.values()))
    return {"val_loss": first, "same_eval_twice": rel(again), "images_moved": moved,
            "noise_scale": NOISE_SCALE, "floor": floor, "gate": max(ELASTIC_FLOOR_FACTOR * floor, ELASTIC_MIN_RTOL)}


def phase_tensor_parallel(seed: int, tmp: str, reference=None):
    """Tensor parallelism and buffer donation on the card at the default VGG
    config (fused update, remat off), on phase ``runner``'s image folder
    and index cache; see the module docstring. The mesh names cuda:0 four
    times: the dp=2 x mp=2 code paths on the one card. ``reference``: phase
    ``elastic``'s dp=1 loss, meta-gradient, floor and step times at the
    same config, start state and batch (measured here where not given)."""
    from howtotrainyourmamlpytorch_tpu_torch.config import ParallelConfig, load_config
    from howtotrainyourmamlpytorch_tpu_torch.core.programs import GraphProgram, clone_tree, tree_leaves_any
    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
    from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
    from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
    from howtotrainyourmamlpytorch_tpu_torch.parallel import make_mesh, placement, shard_batch, shard_train_state
    from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import shard_chunk, unreplicate
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine

    t_phase = time.perf_counter()
    card = torch.device("cuda", 0) if TP_DEVICE == "cuda" else torch.device(TP_DEVICE)
    entries = [card] * (TP_DP * TP_MP)
    launches = {"fused_sgd": 0, "fused_sgd_bwd": 0}
    graph_launches = {"fused_sgd": 0, "fused_sgd_bwd": 0}

    def add(counts, into=launches):
        for key in into:
            into[key] += counts.get(key, 0)

    cfg, system, start = full_width_system(seed)
    K, K_eval = cfg.number_of_training_steps_per_iter, cfg.number_of_evaluation_steps_per_iter
    filters, n_way = start.params["stage_0"]["conv"]["w"].shape[0], cfg.num_classes_per_set
    batch = learnable_synthetic_batch(cfg.batch_size, cfg.num_classes_per_set, cfg.num_samples_per_class,
                                      cfg.num_target_samples, cfg.image_shape, seed=seed + 5)
    seconds = {}

    # 1. the dp x mp step against dp=1, with tp_convs on and off
    if reference is None:
        fu.reset_launch_counts()
        loss1, g1, floor, gate = _dp1_floor(system, start, batch)
        _, _, ms1 = _steps(system, start, batch, TP_STEPS + 1)
        add(fu.launch_counts)
        reference = {"loss": loss1, "grads": g1, "floor": floor, "gate": gate, "step_ms": ms1[1:]}
    loss1, g1, floor, gate = (reference[k] for k in ("loss", "grads", "floor", "gate"))
    per_placement = {"dp1": {"loss": float(loss1), "step_ms": reference["step_ms"],
                             "step_ms_median": statistics.median(reference["step_ms"])}}
    for tp_convs in (True, False):
        name = "tp_convs" if tp_convs else "head_only"
        mesh = make_mesh(ParallelConfig(dp=TP_DP, mp=TP_MP, tp_convs=tp_convs), entries)
        placed = shard_train_state(start, mesh)
        rows = {"conv": placed.replicas[1].params["stage_0"]["conv"]["w"].shape[0],
                "head": placed.replicas[1].params["fc"]["w"].shape[0]}
        check(rows == {"conv": filters // TP_MP if tp_convs else filters, "head": n_way // TP_MP}, "tensor_parallel",
              f"{name}: the blocks an mp entry holds", rows=rows, filters=filters, n_way=n_way)
        fu.reset_launch_counts()
        loss, _, g = system.meta_gradients(placed, shard_batch(batch, mesh), epoch=0)
        s, losses, ms = _steps(system, placed, shard_batch(batch, mesh), TP_STEPS + 1)
        got = dict(fu.launch_counts)
        add(got)
        entry = {"loss": float(loss), "loss_diff": abs(float(loss) - float(loss1)),
                 "cosine": _cosine(_flat(g1), _flat(g)),
                 "blocks": rows, "step_ms": ms[1:], "step_ms_median": statistics.median(ms[1:]),
                 "over_dp1": statistics.median(ms[1:]) / per_placement["dp1"]["step_ms_median"],
                 "placement_conv_w": placement(s).params["stage_0"]["conv"]["w"]}
        check(entry["loss_diff"] <= gate["loss"] and 1.0 - entry["cosine"] <= gate["one_minus_cosine"],
              "tensor_parallel", f"{name}: the dp x mp step off dp=1 beyond the floor", entry=entry, floor=floor,
              gate=gate)
        want_fwd = TP_DP * TP_MP * K * (TP_STEPS + 2)  # the meta-gradient, then the steps
        want = {"fused_sgd": want_fwd, "fused_sgd_bwd": want_fwd}
        check(got == want and entry["placement_conv_w"] == (("mp", None, None, None) if tp_convs else ()),
              "tensor_parallel", f"{name}: B1 and B2 not dp x mp x K per step, or the placement changed",
              launches=got, want=want, placement=entry["placement_conv_w"])
        per_placement[name] = entry
    seconds["steps"] = time.perf_counter() - t_phase

    # 2. a chunk of TP steps replayed from one CUDA graph against the eager
    # TP steps, under the deterministic algorithms
    t0 = time.perf_counter()
    with deterministic_algorithms():
        _, dsystem, dstart = full_width_system(seed)
        mesh = make_mesh(ParallelConfig(dp=TP_DP, mp=TP_MP, tp_convs=True), entries)
        batches, stacked = _chunk(cfg, seed + 81, TP_CHUNK)
        fu.reset_launch_counts()
        eager, eager_losses = shard_train_state(clone_tree(dstart), mesh), []
        torch.cuda.synchronize()
        t_eager = time.perf_counter()
        for b in batches:
            eager, out = dsystem.train_step(eager, shard_batch(b, mesh), epoch=0)
            eager_losses.append(out.loss)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t_eager) * 1e3 / TP_CHUNK
        add(fu.launch_counts)
        fu.reset_launch_counts()
        graph, (graph_losses, _, _) = dsystem.train_step_multi(shard_train_state(clone_tree(dstart), mesh),
                                                               shard_chunk(stacked, mesh), 0)
        graph = clone_tree(graph)
        torch.cuda.synchronize()
        t_replay = time.perf_counter()
        again, (again_losses, _, _) = dsystem.train_step_multi(shard_train_state(clone_tree(dstart), mesh),
                                                               shard_chunk(stacked, mesh), 0)
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t_replay) * 1e3 / TP_CHUNK
        replayed = dict(fu.replayed_counts)
        add(replayed, graph_launches)
        add({k: n - replayed[k] for k, n in fu.launch_counts.items()})  # the capture's warmup: eager
        program = next(iter(dsystem._train_multi.values()))
        captures = program.captures if isinstance(program, GraphProgram) else []
        state_diff = _state_diff(unreplicate(graph), unreplicate(eager))
        loss_diff = float((torch.stack(eager_losses) - graph_losses).abs().max())
        replay_diff = float((graph_losses - again_losses).abs().max()) + _state_diff(unreplicate(graph),
                                                                                      unreplicate(again))
        del dsystem, program
    per_replay = {k: n / (2 * TP_CHUNK) for k, n in replayed.items()}
    want = {"fused_sgd": TP_DP * TP_MP * K, "fused_sgd_bwd": TP_DP * TP_MP * K}
    graph_out = {"chunk": TP_CHUNK, "loss_max_abs": loss_diff, "state_max_abs": state_diff,
                 "replay_vs_replay_max_abs": replay_diff, "eager_step_ms": eager_ms, "replayed_step_ms": replay_ms,
                 "replayed_over_eager": replay_ms / eager_ms, "graphs": len(captures),
                 "capture_launches": captures[0].launches if captures else None, "launches_per_replay": per_replay,
                 "losses": graph_losses.tolist()}
    check(loss_diff == 0.0 and state_diff == 0.0 and replay_diff == 0.0, "tensor_parallel",
          "the TP graph is not bit-equal to its eager steps under the deterministic algorithms", **graph_out)
    check(len(captures) == 1 and per_replay == want == captures[0].launches, "tensor_parallel",
          "the TP program was not one graph launching B1 and B2 dp x mp x K per replay", want=want, **graph_out)
    seconds["graph"] = time.perf_counter() - t0

    # 3. the runner at dp x mp with tp_convs and donation: 1 epoch of
    # TP_ITERS steps, a synchronous format-3 latest of dp x mp shards, the
    # checkpoint evaluated on a one-device runner, then served
    t0 = time.perf_counter()
    data = os.path.join(tmp, "omniglot_dataset")
    run_cfg = load_config(DEFAULT_CONFIG, [
        "use_pallas_inner_update=true", "remat_inner_steps=false", f"dataset.path={data}",
        f"index_cache_dir={os.path.join(tmp, 'index')}", f"experiment_root={os.path.join(tmp, 'tensor_parallel')}",
        "experiment_name=tp", "total_epochs=1", f"total_iter_per_epoch={TP_ITERS}",
        f"num_evaluation_tasks={cfg.batch_size}", "load_into_memory=false", f"seed={seed}",
        f"parallel.dp={TP_DP}", f"parallel.mp={TP_MP}", "parallel.tp_convs=true", "donate_train_state=true",
        "checkpoint_async=true", "checkpoint_shards=0",
    ])
    fu.reset_launch_counts()
    runner_s = {}
    runner = ExperimentRunner(run_cfg, devices=entries)
    runner_s["init"] = time.perf_counter() - t0
    check(runner.mesh is not None and runner.mesh.shape == {"dp": TP_DP, "mp": TP_MP} and runner._ckpt_writer is None,
          "tensor_parallel", "the runner's mesh, or its checkpoint writer is not synchronous under donation",
          mesh=repr(runner.mesh))
    in_place = []
    real_step = runner.system.train_step

    def step(state, batch, epoch=None):
        new, out = real_step(state, batch, epoch=epoch)
        in_place.append(new is state)
        return new, out

    runner.system.train_step = step
    runner.run_experiment()
    runner_s["run_experiment"] = time.perf_counter() - t0 - runner_s["init"]
    got = dict(fu.launch_counts)
    add(got)
    events = _run_events(runner.run_dir)
    selfcheck = [e for e in events if e.get("event") in ("donation_selfcheck", "donation_refused")]
    audit = [e for e in events if e.get("event") == "donation_audit"]
    check(len(selfcheck) == 1 and selfcheck[0]["event"] == "donation_selfcheck" and selfcheck[0]["verdict"] == "clean"
          and len(audit) == 1 and audit[0]["flags"]["donate_train_state"] and in_place == [True] * TP_ITERS,
          "tensor_parallel", "donation: the self-check, the audit, the steps in place", selfcheck=selfcheck,
          audit=audit, in_place=in_place)
    # B2 runs in train steps only: the runner's, and the self-check's two
    # arms of 6 steps at min(K, 2) inner steps on one device
    want_bwd = TP_DP * TP_MP * K * TP_ITERS + 2 * 6 * min(K, 2)
    check(got["fused_sgd_bwd"] == want_bwd and got["fused_sgd"] >= want_bwd + TP_DP * TP_MP * K_eval,
          "tensor_parallel", "the runner's B1/B2 launches", launches=got, want_bwd=want_bwd)
    save_dir = runner.saved_models_dir
    shards = sorted(n for n in os.listdir(save_dir) if n.startswith("train_model_latest.shard"))
    _, book = ckpt.load_for_inference(save_dir, "latest")
    check(shards == [f"train_model_latest.shard{k}" for k in range(TP_DP * TP_MP)] and book["mesh"] == [TP_DP, TP_MP],
          "tensor_parallel", "format-3 latest of dp x mp shards", shards=shards, bookkeeping=book)
    fu.reset_launch_counts()
    t1 = time.perf_counter()
    evals = {"dp2_mp2": runner._eval_split("val")}
    val_floor = eval_floor(runner, evals["dp2_mp2"]["val_loss_mean"])
    runner_s["evals_and_floor"] = time.perf_counter() - t1
    runner.loader.close()
    t1 = time.perf_counter()
    shrunk = ExperimentRunner(run_cfg, devices=[card], device_probe=lambda: 1)
    evals["one_device"], degraded = shrunk._eval_split("val"), shrunk.degraded_mesh
    runner_s["one_device"] = time.perf_counter() - t1
    shrunk.loader.close()
    shrunk.events.close()
    val_diff = (abs(evals["one_device"]["val_loss_mean"] - evals["dp2_mp2"]["val_loss_mean"])
                / abs(evals["dp2_mp2"]["val_loss_mean"]))
    check(degraded == {"requested": [TP_DP, TP_MP], "granted": [1, 1], "visible_devices": 1}
          and val_diff <= val_floor["gate"], "tensor_parallel", "the degraded eval of the dp x mp checkpoint",
          evals=evals, val_loss_rel_diff=val_diff, floor=val_floor, degraded=degraded)
    req = slice_requests(cfg, seed)
    engine = AdaptationEngine.from_run_dir(runner.run_dir, "latest")
    probs = engine.predict_batch(list(zip(engine.adapt_batch(req["a"]), req["qa"])))
    _check_probs("tensor_parallel", "a", probs, [q.shape[0] for q in req["qa"]], cfg.num_classes_per_set)
    add(fu.launch_counts)
    seconds["runner"] = time.perf_counter() - t0
    seconds["runner_legs"] = runner_s

    # 4. the default config's eager train step, donated and plain, under
    # the deterministic algorithms: bit-equal, and the peak memory of each
    t0 = time.perf_counter()
    donated = {}
    fu.reset_launch_counts()
    with deterministic_algorithms():
        for donate in (False, True):
            _, dsystem, state = full_width_system(seed, [f"donate_train_state={str(donate).lower()}"])
            given = tree_leaves_any(state)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            state, losses, ms = _steps(dsystem, state, batch, TP_STEPS)
            donated[donate] = {"losses": losses, "state": clone_tree(state), "step_ms": ms,
                               "peak_above_start_bytes": torch.cuda.max_memory_allocated() - base,
                               "in_place": all(a is b for a, b in zip(tree_leaves_any(state), given))}
            del dsystem, state, given
    add(fu.launch_counts)
    plain, don = donated[False], donated[True]
    donation_out = {"losses": don["losses"], "plain_losses": plain["losses"],
                    "state_max_abs": _state_diff(plain["state"], don["state"]),
                    "peak_above_start_bytes": {"plain": plain["peak_above_start_bytes"],
                                               "donated": don["peak_above_start_bytes"]},
                    "step_ms": {"plain": plain["step_ms"], "donated": don["step_ms"]},
                    "in_place": {"plain": plain["in_place"], "donated": don["in_place"]}}
    check(don["losses"] == plain["losses"] and donation_out["state_max_abs"] == 0.0 and don["in_place"]
          and not plain["in_place"], "tensor_parallel",
          "the donated step is not in place or not bit-equal to the plain one", **donation_out)
    seconds["donation"] = time.perf_counter() - t0
    seconds["phase"] = time.perf_counter() - t_phase
    out = {"phase": "tensor_parallel", "ok": True,
           "config": "configs/default.yaml + use_pallas_inner_update=true, remat off; mesh dp=2 x mp=2 of cuda:0",
           "per_placement": per_placement, "floor": floor, "gate": gate, "graph": graph_out,
           "runner": {"evals": evals, "val_loss_rel_diff": val_diff, "eval_floor": val_floor, "shards": shards,
                      "audit": {k: audit[0][k] for k in ("state_bytes", "batch_bytes", "donated_bytes",
                                                         "left_on_table_bytes")},
                      "selfcheck": {k: selfcheck[0].get(k) for k in ("verdict", "max_loss_dev", "global_param_rel")}},
           "donation": donation_out, "launches": launches, "launches_graph": graph_launches, "seconds": seconds,
           "budget_s": TENSOR_PARALLEL_BUDGET_S}
    emit(out)
    return out


def _graftsan_events(run_dir_logs: str) -> list:
    path = os.path.join(run_dir_logs, "events.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [e for e in (json.loads(line) for line in f if line.strip()) if e.get("event") == "graftsan_violation"]


def ops_campaign(seed: int, tmp: str) -> dict:
    """Leg 1: the sanitized in-process campaign at the JAX package's toy
    sizes, every episode on the card."""
    from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import run_campaign

    marks = []
    t0 = time.perf_counter()
    verdict = run_campaign(os.path.join(tmp, "campaign"), episodes=OPS_EPISODES, seed=seed, include_subprocess=False,
                           sanitize=True, device=OPS_DEVICE, log=lambda m: marks.append((time.perf_counter(), m)))
    end = time.perf_counter()
    ends = [t for t, _ in marks[1:]] + [end]
    episodes = [{"kind": r["kind"], "mode": r.get("mode"), "rcs": r.get("rcs"), "seconds": round(b - a, 3)}
                for r, (a, _), b in zip(verdict["episode_results"], marks, ends)]
    san = verdict["sanitizer"] or {}
    check(verdict["ok"] and len(verdict["episode_results"]) == OPS_EPISODES and not verdict["violations"]
          and san.get("armed") is True and san.get("violations") == 0, "operations",
          "the sanitized campaign is not green", violations=verdict["violations"][:10], sanitizer=san,
          episodes=episodes)
    return {"ok": verdict["ok"], "episodes": episodes, "sanitizer": san, "seconds": round(end - t0, 3)}


def _serve_run_dir(root: str, cfg, system, state) -> str:
    from howtotrainyourmamlpytorch_tpu_torch.config import save_config
    from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt

    os.makedirs(os.path.join(root, "logs"), exist_ok=True)
    save_config(cfg, os.path.join(root, "config.yaml"))
    ckpt.save_named(os.path.join(root, "saved_models"), state, {"epoch": 0}, "latest",
                    feature_shape=system.model.feature_shape)
    return root


def prestart_ops_frontend(seed: int, tmp: str) -> dict:
    """Leg 2's serve CLI, made before phase ``tensor_parallel``: its run
    directory at the default config and the process started behind a gate,
    so that its imports and card start overlap that phase."""
    cfg, system, state = full_width_system(seed)
    run_dir = _serve_run_dir(os.path.join(tmp, "ops_serve"), cfg, system, state)
    log_path, gate, port = os.path.join(tmp, "ops_serve.log"), os.path.join(tmp, "ops_serve.gate"), _free_port()
    proc = start_gated_server(
        [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.serve", run_dir, "--port", str(port),
         "--device", OPS_DEVICE, *OPS_SERVE_OVERRIDES], log_path, gate)
    return {"cfg": cfg, "run_dir": run_dir, "log_path": log_path, "gate": gate, "port": port, "proc": proc}


def ops_frontend(seed: int, tmp: str, pre: dict) -> dict:
    """Leg 2: the serve CLI in a fresh process (:func:`prestart_ops_frontend`,
    released here) at the default config with the strict guard, the
    serving prewarm and the sanitizer: the warm gate over HTTP, the first
    /adapt after ``ok`` against warm ones, mixed traffic over every bucket,
    the sealed guard, zero sanitizer findings after the drain, B1 launches
    from the server's /metrics."""
    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
    from howtotrainyourmamlpytorch_tpu_torch.utils.strictmode import serving_planned_programs

    cfg, run_dir, log_path, port, proc = (pre[k] for k in ("cfg", "run_dir", "log_path", "port", "proc"))
    n_way, img = cfg.num_classes_per_set, cfg.image_shape
    supports = {b: b // n_way for b in cfg.serving.support_buckets}  # bucket -> shots
    t_spawn = time.perf_counter()  # the release: imports and the card started before it
    open(pre["gate"], "w").close()
    base = f"http://127.0.0.1:{port}"

    def server_log():
        with open(log_path) as f:
            return f.read()[-4000:]

    def body(k_shot, seed_, n_query=None):
        b = learnable_synthetic_batch(1, n_way, k_shot, 1, img, seed=seed_)
        req = {"x_support": b["x_support"][0].tolist(), "y_support": b["y_support"][0].tolist()}
        return json.dumps(req).encode(), b["x_support"][0].reshape((-1,) + tuple(img))

    try:
        # the warm gate: 503 "warming" until the prewarm returns, then 200 "ok"
        statuses, t_bound, t_ok = [], None, None
        deadline = time.monotonic() + HTTP_READY_S
        while t_ok is None:
            try:
                status, health, _ = _http(base, "/healthz")
                if t_bound is None:
                    t_bound = time.perf_counter()
                if not statuses or statuses[-1] != (status, health["status"]):
                    statuses.append((status, health["status"]))
                if status == 200:
                    t_ok = time.perf_counter()
            except OSError:
                pass
            if t_ok is None and (proc.poll() is not None or time.monotonic() > deadline):
                check(False, "operations", "the strict server did not come up", rc=proc.poll(), log=server_log())
            if t_ok is None:
                time.sleep(0.05)
        prewarm = health["prewarm"]
        check(statuses[0] == (503, "warming") and statuses[-1] == (200, "ok") and prewarm["status"] == "warm"
              and prewarm["compile_errors"] == 0, "operations", "/healthz did not go warming -> ok",
              statuses=statuses, prewarm=prewarm)
        # the first /adapt after ok, against warm /adapts at the same bucket
        first_body, _ = body(supports[100], seed + 100)
        status, first, first_ms = _http(base, "/adapt", first_body)
        check(status == 200 and not first.get("cached"), "operations", "the first /adapt failed", status=status)
        warm_ms = []
        for i in range(OPS_WARM_ADAPTS):
            status, out, ms = _http(base, "/adapt", body(supports[100], seed + 101 + i)[0])
            check(status == 200 and not out.get("cached"), "operations", "a warm /adapt failed", status=status)
            warm_ms.append(ms)
        warm_median = statistics.median(warm_ms)
        check(first_ms <= OPS_FIRST_ADAPT_FACTOR * warm_median, "operations",
              f"the first /adapt after ok is over {OPS_FIRST_ADAPT_FACTOR}x the median warm /adapt",
              first_ms=first_ms, warm_ms=warm_ms)
        # 64 mixed requests over every support and query bucket, 8 at a time:
        # 8 adapts per support bucket, then 8 predicts per query bucket
        adapts, kept = [], []
        for j, (bucket, k_shot) in enumerate(sorted(supports.items())):
            for i in range(OPS_REQUESTS // 8):
                raw, images = body(k_shot, seed + 1000 + 100 * j + i)
                adapts.append(lambda raw=raw: _http(base, "/adapt", raw))
                kept.append(images)
        got = _in_threads(adapts, OPS_CLIENTS)
        check(all(r[0] == 200 for r in got), "operations", "a mixed /adapt failed",
              statuses=sorted({r[0] for r in got}))
        ids = [r[1]["adaptation_id"] for r in got]
        predicts = []
        for j, q in enumerate(cfg.serving.query_buckets):
            for i in range(OPS_REQUESTS // 8):
                n = 8 * j + i
                raw = json.dumps({"adaptation_id": ids[n], "x_query": kept[n][:q].tolist()}).encode()
                predicts.append(lambda raw=raw: _http(base, "/predict", raw))
        got_p = _in_threads(predicts, OPS_CLIENTS)
        check(all(r[0] == 200 and np.isfinite(np.asarray(r[1]["probs"])).all() for r in got_p), "operations",
              "a mixed /predict failed", statuses=sorted({r[0] for r in got_p}))
        _, metrics, _ = _http(base, "/metrics")
        guard = metrics["compiled"]["recompile_guard"]
        check(guard["prewarmed"] and guard["violations"] == [] and guard["lowerings"] == prewarm["programs"],
              "operations", "the sealed guard saw a dispatch outside the prewarm", guard=guard,
              programs=prewarm["programs"])
        adapt_flushes = metrics["adapt_batcher"]["flushes"]
        launches = metrics["compiled"]["fused_sgd_launches"]
        prewarmed_adapts = sum(1 for kind, _, _ in serving_planned_programs(cfg.serving) if kind == "adapt")
        want = cfg.number_of_evaluation_steps_per_iter * (adapt_flushes + prewarmed_adapts)
        check(launches == want, "operations", "B1 not 5 x (adapt flushes + prewarmed adapt programs)",
              launches=launches, want=want, adapt_flushes=adapt_flushes)
    finally:
        rc = stop_server(proc)
    check(rc == 0, "operations", "the strict server's drain failed", rc=rc, log=server_log())
    findings = _graftsan_events(os.path.join(run_dir, "logs"))
    check(findings == [], "operations", "graftsan_violation events from the armed server", findings=findings[:5])
    with open(os.path.join(run_dir, "logs", "access.jsonl")) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    flushes = sorted({(r.get("verb"), r.get("bucket"), r.get("flush_batch")) for r in lines if r.get("flush_batch")},
                     key=repr)
    return {
        "launches": launches, "adapt_flushes": adapt_flushes, "statuses": statuses,
        "release_to_bound_s": round(t_bound - t_spawn, 3), "warming_s": round(t_ok - t_bound, 3),
        "prewarm": prewarm, "first_adapt_ms": first_ms, "warm_adapt_ms": warm_ms,
        "warm_adapt_median_ms": warm_median,
        "first_adapt_gate": f"first /adapt after ok <= {OPS_FIRST_ADAPT_FACTOR} x the median of "
                            f"{OPS_WARM_ADAPTS} warm /adapts at support bucket 100",
        "guard": guard, "graftsan_violations": len(findings), "requests": len(got) + len(got_p),
        "flushes_seen": flushes,
    }


def ops_runner(seed: int, tmp: str) -> dict:
    """Leg 3: the runner at the default config in this process, 1 epoch of
    OPS_RUNNER_ITERS steps, unarmed and then under
    ``resilience.sanitizer=true``: zero ``graftsan_violation`` events, B1
    and B2 K times per train step, the step period of each."""
    from howtotrainyourmamlpytorch_tpu_torch.config import load_config
    from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
    from tools.graftsan import runtime as graftsan

    data = os.path.join(tmp, "omniglot_dataset")
    out = {}
    for name, extra in (("plain", []), ("armed", ["resilience.sanitizer=true"])):
        cfg = load_config(DEFAULT_CONFIG, [
            "use_pallas_inner_update=true", "remat_inner_steps=false", f"dataset.path={data}",
            f"index_cache_dir={os.path.join(tmp, 'index')}", f"experiment_root={os.path.join(tmp, 'ops_runner')}",
            f"experiment_name={name}", "total_epochs=1", f"total_iter_per_epoch={OPS_RUNNER_ITERS}",
            "num_evaluation_tasks=8", "load_into_memory=false", f"seed={seed}", *extra])
        graftsan.reset()
        runner = ExperimentRunner(cfg, device=None if OPS_DEVICE == "cuda" else OPS_DEVICE)
        check(graftsan.enabled() == bool(extra), "operations", f"the {name} runner's sanitizer state",
              armed=graftsan.enabled())
        real, calls = runner.system.train_step, []

        def step(state, batch, epoch=None, real=real, calls=calls):
            calls.append(time.perf_counter())
            return real(state, batch, epoch=epoch)

        runner.system.train_step = step
        fu.reset_launch_counts()
        t0 = time.perf_counter()
        runner.run_experiment()
        run_s = time.perf_counter() - t0
        launches = dict(fu.launch_counts)
        findings = _graftsan_events(runner.logs_dir)
        in_process = graftsan.violations()
        graftsan.disarm()
        graftsan.reset()
        K, K_eval = cfg.number_of_training_steps_per_iter, cfg.number_of_evaluation_steps_per_iter
        eval_batches = 2 * (cfg.num_evaluation_tasks // cfg.batch_size)  # the epoch's val, then the test
        want = {"fused_sgd": K * OPS_RUNNER_ITERS + K_eval * eval_batches, "fused_sgd_bwd": K * OPS_RUNNER_ITERS}
        check(launches == want, "operations", f"the {name} runner's launches", launches=launches, want=want)
        check(findings == [] and in_process == [], "operations", f"graftsan findings in the {name} runner",
              findings=(findings or in_process)[:5])
        periods = [(b - a) * 1e3 for a, b in zip(calls, calls[1:])]
        out[name] = {"launches": launches, "step_period_ms": periods, "run_s": round(run_s, 3),
                     "graftsan_violations": len(findings)}
    # the first period holds the epoch's first step (its cold start): the
    # ratio reads the steady periods after it
    out["armed_over_plain_steady_period"] = (statistics.median(out["armed"]["step_period_ms"][1:])
                                             / statistics.median(out["plain"]["step_period_ms"][1:]))
    return out


class _TimedChild:
    """A fleet child's process handle that notes its wall seconds when the
    scheduler first sees it exit."""

    def __init__(self, proc, cell: str):
        self.proc, self.cell, self.t0, self.seconds = proc, cell, time.perf_counter(), None

    def poll(self):
        rc = self.proc.poll()
        if rc is not None and self.seconds is None:
            self.seconds = round(time.perf_counter() - self.t0, 3)
        return rc

    def __getattr__(self, name):
        return getattr(self.proc, name)


def ops_fleet(seed: int, tmp: str, handle: dict) -> dict:
    """Leg 4: the training fleet on the card through the port's
    ``FleetScheduler``, its real card gate and its real launcher, wrapped
    to fault the first attempt of one cell (``handle["launched"]`` is set
    once that attempt has started; every process it starts is added to
    ``handle["procs"]``); then ``fleet_run --dry-run``."""
    from howtotrainyourmamlpytorch_tpu_torch.resilience import fleet as fleet_mod

    data = os.path.join(tmp, "omniglot_dataset")
    exps = os.path.join(tmp, "ops_fleet")
    overrides = ["use_pallas_inner_update=true", "remat_inner_steps=false", f"dataset.path={data}",
                 f"index_cache_dir={os.path.join(tmp, 'index')}", "load_into_memory=false", *OPS_FLEET_DEPTH]
    # both cells train at once (two processes on the one card): the matrix
    # takes one child's time plus the faulted cell's resume
    spec = fleet_mod.FleetSpec(name="operations", configs=[{"name": "vgg", "overrides": overrides}], seeds=[0, 1],
                               experiment_root=exps, poll_s=0.25, stall_deadline_s=300.0, max_parallel=2,
                               device=OPS_DEVICE)
    faulted = "vgg.s0"
    children, gates = [], []

    def gate():
        t0 = time.perf_counter()
        rc = fleet_mod._default_gate(spec.device)
        gates.append({"rc": rc, "seconds": round(time.perf_counter() - t0, 3)})
        return rc

    def launcher(cell, attempt):
        prior = os.environ.pop("HTYMP_FAULTS", None)
        if cell.name == faulted and attempt == 0 and not cell.restarts:
            os.environ["HTYMP_FAULTS"] = OPS_FLEET_FAULT
        try:
            proc, out_path = fleet_mod._default_launcher(cell, attempt, exps, spec.device)
        finally:
            os.environ.pop("HTYMP_FAULTS", None)
            if prior is not None:
                os.environ["HTYMP_FAULTS"] = prior
            if cell.name == faulted:
                handle["launched"].set()
        handle["procs"].append(proc)
        child = _TimedChild(proc, cell.name)
        children.append(child)
        return child, out_path

    # fleet_run --dry-run plans the same jobs over seeds 0 and 1; it touches
    # no card, so it runs beside the fleet
    root = os.path.dirname(os.path.abspath(__file__))
    dry = subprocess.Popen(
        [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.scripts.fleet_run", "--device", OPS_DEVICE,
         "--dry-run", "--job", " ".join(["vgg"] + overrides), "--seeds", "0,1", "--exps-root",
         os.path.join(tmp, "ops_fleet_plan")],
        cwd=root, env=dict(os.environ, PYTHONPATH=root), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    handle["procs"].append(dry)
    try:
        report = fleet_mod.FleetScheduler(spec, launcher=launcher, gate=gate, log=lambda m: None).run()
    finally:
        dry_out, dry_err = dry.communicate(timeout=120)
    cells = {c["name"]: c for c in report["cells"]}
    check(gates and all(g["rc"] == 0 for g in gates), "operations", "the card gate did not pass", gates=gates)
    check(report["ok"] and cells[faulted]["rcs"] == [75, 0] and cells["vgg.s1"]["rcs"] == [0]
          and all(c["status"] == "done" for c in cells.values()), "operations", "the fleet's rcs",
          cells={n: {k: c[k] for k in ("status", "rcs", "reason")} for n, c in cells.items()})
    check(all(c["obs"] and "error" not in c["obs"] for c in cells.values()), "operations",
          "a fleet cell has no obs row", obs={n: c["obs"] for n, c in cells.items()})
    events = [e.get("event") for e in _run_events(os.path.join(exps, faulted))]
    check("preempted" in events and os.path.exists(os.path.join(exps, faulted, "logs", "test_summary.csv")),
          "operations", "the faulted cell did not resume in its own run directory", events=events)
    lines = [line for line in dry_out.splitlines() if line.strip()]
    check(dry.returncode == 0 and len(lines) == 1 and len(json.loads(lines[0])["cells"]) == 2, "operations",
          "fleet_run --dry-run", rc=dry.returncode, stdout=dry_out[-2000:], stderr=dry_err[-2000:])
    return {
        "gates": gates, "children": [{"cell": c.cell, "rc": c.returncode, "seconds": c.seconds} for c in children],
        "cells": {n: {k: c[k] for k in ("status", "rcs", "restarts", "wall_s")} for n, c in cells.items()},
        "obs": {n: c["obs"] for n, c in cells.items()}, "fault": OPS_FLEET_FAULT, "cuts": OPS_FLEET_DEPTH,
        "dry_run_rc": dry.returncode, "elapsed_s": report["elapsed_s"],
    }


def start_ops_fleet(seed: int, tmp: str) -> dict:
    """Leg 4 of phase ``operations`` (:func:`ops_fleet`) on a thread, from
    before phase ``elastic`` on: its children and their gates run beside
    ``elastic`` and ``tensor_parallel``. Returns once the faulted cell's
    first attempt has started, so that no other process starts while the
    launcher sets ``HTYMP_FAULTS`` in this process's environment."""
    handle = {"launched": threading.Event(), "procs": [], "t0": time.perf_counter()}

    def run():
        try:
            handle["result"] = ops_fleet(seed, tmp, handle)
        except BaseException as exc:  # re-raised by finish_ops_fleet
            handle["error"] = exc
        finally:
            handle["launched"].set()
            handle["seconds"] = round(time.perf_counter() - handle["t0"], 3)

    handle["thread"] = threading.Thread(target=run, name="ops-fleet", daemon=True)
    handle["thread"].start()
    handle["launched"].wait(timeout=120.0)
    return handle


def stop_ops_fleet(handle: dict) -> None:
    """Kill what :func:`start_ops_fleet`'s thread started and still runs
    (a run that failed before phase ``operations``)."""
    for proc in handle["procs"]:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_ops_fleet(handle: dict) -> dict:
    """Wait for :func:`start_ops_fleet`'s thread -> leg 4's result, with
    its own seconds and how long phase ``operations`` waited for it."""
    t0 = time.perf_counter()
    handle["thread"].join(timeout=600.0)
    check(not handle["thread"].is_alive(), "operations", "the training fleet did not end")
    if "error" in handle:
        raise handle["error"]
    return {**handle["result"], "seconds": handle["seconds"], "waited_s": round(time.perf_counter() - t0, 3)}


def deterministic_algorithms(on: bool = True):
    """The port's switch (``utils/seeding.py``), imported when a phase
    runs."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.seeding import deterministic_algorithms as switch

    return switch(on)


DETERMINISM_PAIRS = 6  # alternating default / deterministic flushes at the VGG serving cell


def ops_determinism(seed: int) -> dict:
    """One default-config support set adapted in two fresh engines, with
    the defaults and then under ``torch.use_deterministic_algorithms`` and
    ``cudnn.deterministic``: bit-equality of the two engines'
    probabilities, their largest difference, and each engine's adapt flush
    ms (after one untimed flush). Then the cost: DETERMINISM_PAIRS pairs of
    adapt flushes at the VGG serving cell (8 requests at support 100), the
    settings toggled between flushes, each setting in an engine of its own
    (a flush replays the graph captured under its setting), after one
    untimed flush of each: both medians, their ranges and the ratio."""
    import warnings

    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
    from howtotrainyourmamlpytorch_tpu_torch.serving import AdaptationEngine

    cfg, system, state = full_width_system(seed)
    b = learnable_synthetic_batch(1, cfg.num_classes_per_set, cfg.num_samples_per_class, cfg.num_target_samples,
                                  cfg.image_shape, seed=seed + 3)
    x_s, y_s = b["x_support"][0], b["y_support"][0]
    x_q = b["x_target"][0].reshape((-1,) + tuple(cfg.image_shape))

    def pair():
        probs, ms = [], []
        for _ in range(2):
            engine = AdaptationEngine(system, state)
            engine.adapt(x_s, y_s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fw = engine.adapt(x_s, y_s)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            probs.append(engine.predict(fw, x_q))
        return probs, {"bit_equal": bool(np.array_equal(probs[0], probs[1])),
                       "max_abs_diff": float(np.abs(probs[0] - probs[1]).max()), "adapt_ms": ms}

    default_probs, default = pair()
    with deterministic_algorithms(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        det_probs, det = pair()
    det["nondeterministic_op_warnings"] = sorted({str(w.message)[:200] for w in caught})

    flush = learnable_synthetic_batch(TASKS, cfg.num_classes_per_set, cfg.num_samples_per_class,
                                      cfg.num_target_samples, cfg.image_shape, seed=seed + 4)
    requests = [(flush["x_support"][i], flush["y_support"][i]) for i in range(TASKS)]
    # an engine per setting: a flush replays the graph its program captured,
    # with the algorithms the capture ran under
    engines = {name: AdaptationEngine(system, state) for name in ("default", "deterministic")}
    ms = {"default": [], "deterministic": []}
    for turn in range(DETERMINISM_PAIRS + 1):
        for name in ("default", "deterministic"):
            with deterministic_algorithms(name == "deterministic"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engines[name].adapt_batch(requests)
                torch.cuda.synchronize()
                if turn:  # the first turn is each setting's untimed flush
                    ms[name].append((time.perf_counter() - t0) * 1e3)
    medians = {name: statistics.median(v) for name, v in ms.items()}
    cost = {"pairs": DETERMINISM_PAIRS, "flush_ms": ms, "median_ms": medians,
            "range_ms": {name: [min(v), max(v)] for name, v in ms.items()},
            "deterministic_over_default": medians["deterministic"] / medians["default"]}
    return {"default": default, "deterministic": det,
            "default_vs_deterministic_max_abs_diff": float(np.abs(default_probs[0] - det_probs[0]).max()),
            "support": int(x_s.shape[0] * x_s.shape[1]), "queries": int(x_q.shape[0]), "flush_cost": cost}


def phase_operations(seed: int, tmp: str, frontend_pre: dict, fleet_handle: dict):
    """The operations layer on the card (see the module docstring), on
    phase ``runner``'s image folder and index cache in ``tmp``;
    ``frontend_pre``: leg 2's gated serve CLI (:func:`prestart_ops_frontend`);
    ``fleet_handle``: leg 4, running since before phase ``elastic``
    (:func:`start_ops_fleet`)."""
    t_phase = time.perf_counter()
    seconds = {}

    def leg(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 3)
        return out

    campaign = leg("campaign", ops_campaign, seed, tmp)
    frontend = leg("frontend", ops_frontend, seed, tmp, frontend_pre)
    runner = leg("runner", ops_runner, seed, tmp)
    fleet = leg("fleet", finish_ops_fleet, fleet_handle)
    determinism = leg("determinism", ops_determinism, seed)
    launches = {"fused_sgd": frontend["launches"] + runner["armed"]["launches"]["fused_sgd"],
                "fused_sgd_bwd": runner["armed"]["launches"]["fused_sgd_bwd"]}
    out = {"phase": "operations", "ok": True, "campaign": campaign, "frontend": frontend, "runner": runner,
           "fleet": fleet, "determinism": determinism, "launches": launches,
           "seconds": {**seconds, "phase": round(time.perf_counter() - t_phase, 3)},
           "budget_s": OPERATIONS_BUDGET_S}
    emit(out)
    return out


def analysis_report(exps_root: str, out_dir: str, env, run_dirs) -> dict:
    """The port's run analysis (``python -m
    howtotrainyourmamlpytorch_tpu_torch.analysis``) over an experiment root:
    it must list ``run_dirs``. Its plots need matplotlib; where that does not
    import, a line says so and only the tables are made (``collect_runs``,
    ``aggregate_test_accuracy``, ``to_markdown``) in this process."""
    from howtotrainyourmamlpytorch_tpu_torch import analysis

    runs = analysis.collect_runs(exps_root)
    listed = sorted(os.path.abspath(r.run_dir) for r in runs)
    check(listed == sorted(os.path.abspath(d) for d in run_dirs), "runner", "the analysis does not list the runs",
          listed=listed, want=run_dirs)
    rows = analysis.aggregate_test_accuracy(runs)
    check(len(rows) >= 1 and "|" in analysis.to_markdown(rows), "runner", "the analysis aggregated no row")
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: matplotlib does not import ({exc}); the analysis holds the tables only", flush=True)
        return {"runs": len(runs), "table_rows": len(rows), "matplotlib": False}
    cmd = [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.analysis", exps_root, out_dir]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, "runner", "the analysis CLI failed", rc=proc.returncode,
          tail=(proc.stdout[-2000:], proc.stderr[-2000:]))
    summary = json.loads(proc.stdout[: proc.stdout.rindex("}") + 1])
    check(summary["runs"] == len(runs), "runner", "the analysis CLI's runs", summary=summary)
    plots = sorted(name for name in os.listdir(out_dir) if name.endswith(".png"))
    return {"runs": len(runs), "table_rows": len(rows), "matplotlib": True, "plots": plots}


def _steps(system, state, batch, n, epoch=0):
    """``n`` train steps -> (state, losses, step ms)."""
    losses, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, out = system.train_step(state, batch, epoch=epoch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.loss))
    return state, losses, ms


def _record_launches(fu):
    """Wrap the two launchers so that each launch records its kernel, its
    operand dtype and its number of leaves (the wrappers' counts stay as
    they are); returns the list and a function that undoes the wrapping."""
    seen = []
    fwd, bwd = fu._launch_forward, fu._launch_backward

    def launch_forward(ps, gs, lrs):
        seen.append(("fused_sgd", str(ps[0].dtype), len(ps)))
        return fwd(ps, gs, lrs)

    def launch_backward(cts, gs, lrs):
        seen.append(("fused_sgd_bwd", str(cts[0].dtype), len(cts)))
        return bwd(cts, gs, lrs)

    fu._launch_forward, fu._launch_backward = launch_forward, launch_backward

    def undo():
        fu._launch_forward, fu._launch_backward = fwd, bwd

    return seen, undo


def phase_resnet(seed: int):
    """The slice's full-width model on the card: ResNet-12 at the fleet row
    omniglot.20.1.resnet-12.gd (RESNET_OVERRIDES; meta-batch 8, K=5, second
    order, MSL on, the fused update, remat off). RESNET_STEPS train steps on
    one class-structured batch, an eval step, then the engine serving the
    trained state (one adapt flush of 8 requests and its predictions): B1
    and B2 over the 86-leaf tree on every inner step. Checks: finite
    losses, the last below the first, B1 and B2 K launches per train step
    and B1 K per eval step and per adapt flush, finite probabilities whose
    rows sum to 1, and the first step against the CPU and float64 as in
    phase ``train``. Then one bf16_inner train step: finite, B1 and B2 in
    bf16."""
    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    cfg, system, state = full_width_system(seed, RESNET_OVERRIDES)
    n_way, img = cfg.num_classes_per_set, cfg.image_shape
    check(len(tree_leaves(state.params)) == RESNET_LEAVES, "resnet", "the ResNet-12 tree",
          leaves=len(tree_leaves(state.params)))
    check(system.use_second_order(0) and system.msl_active(0) and system.remat_policy == "none",
          "resnet", "the fleet row is second order with MSL and no remat")
    batch = learnable_synthetic_batch(cfg.batch_size, n_way, cfg.num_samples_per_class,
                                      cfg.num_target_samples, img, seed=seed + 5)
    K, K_eval = cfg.number_of_training_steps_per_iter, cfg.number_of_evaluation_steps_per_iter
    start = state
    torch.cuda.reset_peak_memory_stats()
    fu.reset_launch_counts()  # the ResNet-12 path starts here
    state, losses, train_ms = _steps(system, state, batch, RESNET_STEPS)
    train_launches, copies = dict(fu.launch_counts), fu.contiguous_copies
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    ev = system.eval_step(state, batch)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    engine = AdaptationEngine(system, state)
    requests = [(batch["x_support"][i], batch["y_support"][i]) for i in range(cfg.batch_size)]
    queries = [batch["x_target"][i].reshape(-1, *img) for i in range(cfg.batch_size)]
    t0 = time.perf_counter()
    probs = engine.predict_batch(list(zip(engine.adapt_batch(requests), queries)))
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fu.launch_counts)  # and ends here
    want_train = {"fused_sgd": K * RESNET_STEPS, "fused_sgd_bwd": K * RESNET_STEPS}
    check(train_launches == want_train, "resnet", "kernel launches differ from K per train step",
          launches=train_launches, want=want_train)
    want = {"fused_sgd": K * RESNET_STEPS + K_eval + engine.num_steps, "fused_sgd_bwd": K * RESNET_STEPS}
    check(launches == want, "resnet", "kernel launches through eval and serving", launches=launches, want=want)
    check(_finite(*losses, ev.loss) and bool(torch.isfinite(ev.per_task_target_logits).all()), "resnet",
          "non-finite loss", losses=losses, eval=float(ev.loss))
    check(losses[-1] < losses[0], "resnet", f"{RESNET_STEPS} steps on one batch did not lower the loss", losses=losses)
    _check_probs("resnet", "served", probs, [q.shape[0] for q in queries], n_way)
    profile = profile_device(lambda: system.train_step(state, batch, epoch=0))
    # The cross-check runs at K=1, the same model, weights and batch: there
    # float32 is well conditioned, while at the fleet row's K=5 the rollout
    # amplifies last-bit differences until either device's meta-gradient is
    # far from float64, so K=5 is not cross-checked (its CPU and float64
    # objectives at full width took ~27 s of the run's time limit)
    cfg1, system1, _ = full_width_system(seed, RESNET_OVERRIDES + ["number_of_training_steps_per_iter=1"])
    loss1 = float(system1.meta_objective(start, batch, epoch=0)[0])
    cross = train_cross_check(cfg1, start, batch, loss1, phase="resnet", **RESNET_CROSS)

    # one bf16_inner train step: B1 and B2 on the bf16 fast weights
    cfg16, system16, state16 = full_width_system(seed, RESNET_OVERRIDES + ["precision.enabled=true"])
    check(system16.precision.name == "bf16_inner", "resnet", "bf16_inner policy", policy=system16.precision.name)
    seen, undo = _record_launches(fu)
    fu.reset_launch_counts()  # the bf16_inner ResNet-12 step starts here
    try:
        _, bf16_losses, bf16_ms = _steps(system16, state16, batch, 1)
    finally:
        undo()
    bf16_launches = dict(fu.launch_counts)  # and ends here
    check(bf16_launches == {"fused_sgd": K, "fused_sgd_bwd": K}, "resnet", "bf16_inner launches",
          launches=bf16_launches)
    check(_finite(*bf16_losses), "resnet", "non-finite bf16_inner loss", losses=bf16_losses)
    check({dtype for _, dtype, _ in seen} == {"torch.bfloat16"}, "resnet", "B1/B2 not in bf16", seen=seen[:4])
    result = {
        "phase": "resnet", "ok": True,
        "config": "configs/default.yaml + " + " ".join(RESNET_OVERRIDES) + " use_pallas_inner_update=true "
                  "remat_inner_steps=false (fleet row omniglot.20.1.resnet-12.gd)",
        "leaves": RESNET_LEAVES, "num_params": system.num_params(start), "meta_batch": cfg.batch_size,
        "inner_steps": K, "train_steps": RESNET_STEPS, "launches": launches, "train_launches": train_launches,
        "contiguous_copies_train": copies, "losses": losses, "eval_loss": float(ev.loss),
        "eval_accuracy": float(ev.accuracy), "train_step_ms_median": statistics.median(train_ms),
        "train_step_ms": train_ms, "eval_step_ms": eval_ms, "serve_flush_ms": serve_ms,
        "max_memory_allocated": peak, "train_step_profile": profile, "cross_check": cross,
"bf16_inner": {"loss": bf16_losses[0], "step_ms": bf16_ms[0], "launches": bf16_launches,
                       "launch_dtypes": sorted({dtype for _, dtype, _ in seen})},
    }
    emit(result)
    return result


def phase_remat(seed: int):
    """The remat policies on the card: configs/mini_imagenet_5way_5shot.yaml
    with net=resnet-12 (84x84x3, 5-way 5-shot, meta-batch 8, K=5, the
    ImageNet +-10 clamp; the fused update), the same batch and start state
    under each of REMAT_POLICIES, cuDNN deterministic: per policy the first
    step's loss, meta-gradient and peak memory, then one timed eager train
    step (wall and host CPU ms); then dots_saveable's chunk of REMAT_CHUNK
    steps as a CUDA graph (``train_step_multi``): the warmup's and the
    capture's seconds and the replayed chunk's ms per step. The first
    step's loss must be equal across policies, the meta-gradient within
    REMAT_GRAD_RTOL of its largest element, the peak memory of
    dots_saveable between full's and none's, and dots_saveable's record
    and replay (the C++ dispatch hook) make no ``__torch_dispatch__`` call
    in one more train step under the profiler's Python tracer; B1 launches K times per
    meta-gradient without remat and 2 K with it (the recompute), B2 K, and
    the chunk's warmup and replays REMAT_CHUNK + 1 times that. Times are
    reported, not gated (``scripts/remat_probe.py`` times the policies
    over rounds in turn). A policy that runs out of the card's memory is
    recorded and the others go on. Then configs/default.yaml (the VGG) at
    none and full: one train step's peak memory each."""
    import gc

    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
    from howtotrainyourmamlpytorch_tpu_torch.scripts.remat_probe import dispatch_host_ms

    out, first, launches_total = {}, {}, {"fused_sgd": 0, "fused_sgd_bwd": 0}
    graphed, batch = None, None

    def add(launches):
        for name in launches_total:
            launches_total[name] += launches[name]

    torch.backends.cudnn.deterministic = True
    try:
        for policy in REMAT_POLICIES:
            cfg, system, state = full_width_system(seed, ["net=resnet-12", f"remat_policy={policy}"],
                                                   config=MINI_IMAGENET_CONFIG)
            check(cfg.is_imagenet and system.remat_policy == policy, "remat", "config", policy=system.remat_policy)
            K = cfg.number_of_training_steps_per_iter
            if batch is None:
                batch = learnable_synthetic_batch(cfg.batch_size, cfg.num_classes_per_set,
                                                  cfg.num_samples_per_class, cfg.num_target_samples,
                                                  cfg.image_shape, seed=seed + 6)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:
                fu.reset_launch_counts()  # this policy's path starts here
                t0 = time.perf_counter()
                loss, _, grads = system.meta_gradients(state, batch, epoch=0)
                torch.cuda.synchronize()
                grad_ms = (time.perf_counter() - t0) * 1e3
                launches = dict(fu.launch_counts)
                peak = torch.cuda.max_memory_allocated()
                first[policy] = (float(loss), _flat(grads))
                del grads
                c0, t0 = time.thread_time(), time.perf_counter()
                _, step_out = system.train_step(state, batch, epoch=0)
                torch.cuda.synchronize()
                step_ms, host_ms = (time.perf_counter() - t0) * 1e3, (time.thread_time() - c0) * 1e3
                step_launches = {name: n - launches[name] for name, n in fu.launch_counts.items()}  # and ends here
            except torch.cuda.OutOfMemoryError as exc:
                out[policy] = {"oom": str(exc).splitlines()[0][:300]}
                continue
            per = 1 if policy == "none" else 2
            want = {"fused_sgd": per * K, "fused_sgd_bwd": K}
            check(launches == want and step_launches == want, "remat", "launches per meta-gradient and per step",
                  policy=policy, launches=launches, step_launches=step_launches, want=want)
            check(_finite(first[policy][0], float(step_out.loss)), "remat", "non-finite loss", policy=policy,
                  loss=first[policy][0], step_loss=float(step_out.loss))
            add(launches)
            add(step_launches)
            out[policy] = {"max_memory_allocated": peak, "first_meta_gradient_ms": grad_ms,
                           "first_loss": first[policy][0], "launches": launches, "step_ms": step_ms,
                           "host_cpu_ms": host_ms, "step_loss": float(step_out.loss)}
            if policy == "dots_saveable":
                graphed = (system, state, per)
                # the record and replay are the C++ hook's: no op of a step
                # reaches Python (one more step, under the profiler's tracer)
                fu.reset_launch_counts()
                calls = dispatch_host_ms(system, state, batch)
                add(fu.launch_counts)
                check(calls["calls"] == 0, "remat", "dots_saveable's step made Python dispatch calls", calls=calls)
                out[policy]["torch_dispatch"] = calls
            del system, state
        check(len(first) >= 2, "remat", "fewer than two policies ran", out=out)
        ref_policy = next(iter(first))
        ref_loss, ref_grad = first[ref_policy]
        scale = float(ref_grad.abs().max())
        for policy, (loss, g) in first.items():
            diff = float((g - ref_grad).abs().max())
            out[policy].update(first_loss_equal=loss == ref_loss, grad_max_abs_vs_ref=diff)
            check(loss == ref_loss and diff <= REMAT_GRAD_RTOL * scale, "remat", "policies disagree on the first step",
                  policy=policy, reference=ref_policy, loss=loss, ref_loss=ref_loss, diff=diff,
                  bound=REMAT_GRAD_RTOL * scale)
            check(out[policy]["step_loss"] == out[ref_policy]["step_loss"], "remat",
                  "a policy's train step changed the loss", policy=policy, loss=out[policy]["step_loss"],
                  reference=out[ref_policy]["step_loss"])
        if all(p in out and "oom" not in out[p] for p in REMAT_POLICIES):
            peaks = {p: out[p]["max_memory_allocated"] for p in REMAT_POLICIES}
            check(peaks["full"] < peaks["dots_saveable"] < peaks["none"], "remat",
                  "dots_saveable's peak memory is not between full's and none's", peaks=peaks)

        # dots_saveable's chunk as a CUDA graph: one multi-step dispatch,
        # which warms up (one eager step on a copy), captures and replays
        # the chunk; the replays' ms are its seconds less the warmup's and
        # the capture's (CapturedStep.lower_s, compile_s)
        if graphed is not None:
            _, stacked = _chunk(cfg, seed + 6, REMAT_CHUNK)
            system, state, per = graphed
            graphed = None
            try:
                fu.reset_launch_counts()  # the warmup and the replayed chunk start here
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, (graph_losses, _, _) = system.train_step_multi(state, stacked, 0)
                torch.cuda.synchronize()
                dispatch_s = time.perf_counter() - t0
                graph_launches = dict(fu.launch_counts)  # and end here
                graphs = [c for p in system._train_multi.values() for c in getattr(p, "_captured", {}).values()]
            except torch.cuda.OutOfMemoryError as exc:
                out["dots_saveable"]["graph"] = {"oom": str(exc).splitlines()[0][:300]}
                graphs = None
            finally:
                del system, state
                gc.collect()
                torch.cuda.empty_cache()
            if graphs is not None:
                check(len(graphs) == 1, "remat", "one CUDA graph per chunk", graphs=len(graphs))
                captured = graphs[0]
                replay_s = dispatch_s - captured.lower_s - captured.compile_s
                per_step = {"fused_sgd": per * K, "fused_sgd_bwd": K}
                want = {name: n * (REMAT_CHUNK + 1) for name, n in per_step.items()}
                check(graph_launches == want and captured.launches == per_step, "remat",
                      "launches of the warmup and the replayed chunk", launches=graph_launches,
                      captured=captured.launches, want=want)
                check(_finite(*graph_losses), "remat", "non-finite graph loss")
                add(graph_launches)
                out["dots_saveable"]["graph"] = {
                    "chunk": REMAT_CHUNK, "warmup_s": captured.lower_s, "capture_s": captured.compile_s,
                    "replay_ms_per_step": replay_s * 1e3 / REMAT_CHUNK, "losses": [float(x) for x in graph_losses],
                    "launches": graph_launches}
    finally:
        torch.backends.cudnn.deterministic = False
    vgg = {}
    for policy in ("none", "full"):
        cfg, system, state = full_width_system(seed, [f"remat_policy={policy}"])
        batch_vgg = learnable_synthetic_batch(cfg.batch_size, cfg.num_classes_per_set, cfg.num_samples_per_class,
                                              cfg.num_target_samples, cfg.image_shape, seed=seed + 3)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fu.reset_launch_counts()  # and the VGG's
        _, losses, ms = _steps(system, state, batch_vgg, 1)
        launches = dict(fu.launch_counts)
        add(launches)
        vgg[policy] = {"max_memory_allocated": torch.cuda.max_memory_allocated(), "step_ms": ms[0],
                       "loss": losses[0], "launches": launches}
    result = {"phase": "remat", "ok": True,
              "config": "configs/mini_imagenet_5way_5shot.yaml + net=resnet-12 use_pallas_inner_update=true",
              "reference_policy": ref_policy, "grad_bound": REMAT_GRAD_RTOL * scale, "policies": out,
              "vgg_default": vgg, "launches": launches_total}
    emit(result)
    return result


#: the breadth cells: (name, config, overrides, train steps)
BREADTH = (
    ("omniglot.5.1.densenet-8.gd", DEFAULT_CONFIG,
     ["net=densenet-8", "num_classes_per_set=5", "num_samples_per_class=1"], 3),
    ("omniglot.5.1.densenet-12.gd", DEFAULT_CONFIG,
     ["net=densenet-12", "num_classes_per_set=5", "num_samples_per_class=1"], 1),
    ("omniglot.20.5.vgg.adam", DEFAULT_CONFIG,
     ["inner_optim=adam", "use_pallas_inner_update=false", "num_samples_per_class=5"], 5),
    ("omniglot.20.5.vgg.rprop", DEFAULT_CONFIG, ["inner_optim=rprop", "use_pallas_inner_update=false"], 2),
    ("default.lslr_per_step", DEFAULT_CONFIG, ["lslr_per_step=true"], 1),
)


def phase_breadth(seed: int):
    """The training path's breadth through ``train_step`` on the card, each
    cell (BREADTH) from a fresh seeded state on one class-structured batch:
    DenseNet-8 (61 leaves) and DenseNet-12 (85) with the fused update, inner
    Adam (learnable betas, warm-started from the outer Adam) and Rprop
    unfused, and ``lslr_per_step`` with the fused update, whose ``[K]`` lr
    meta-gradient per tensor is held to the CPU's at CROSS_TASKS tasks
    (cosine >= GRAD_COSINE, phase ``train``'s bound). Checks: finite losses,
    K launches of B1 and B2 per step where fused and none where not, Adam's
    betas moved and within [1e-4, 0.99]."""
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    cells, launches_total = {}, {"fused_sgd": 0, "fused_sgd_bwd": 0}
    for name, config, overrides, steps in BREADTH:
        cfg, system, state = full_width_system(seed, overrides, config=config)
        K = cfg.number_of_training_steps_per_iter
        batch = learnable_synthetic_batch(cfg.batch_size, cfg.num_classes_per_set, cfg.num_samples_per_class,
                                          cfg.num_target_samples, cfg.image_shape, seed=seed + 7)
        start = state
        fu.reset_launch_counts()  # this cell's path starts here
        state, losses, ms = _steps(system, state, batch, steps)
        launches = dict(fu.launch_counts)  # and ends here
        for key in launches_total:
            launches_total[key] += launches[key]
        fused = cfg.use_pallas_inner_update
        want = {"fused_sgd": K * steps if fused else 0, "fused_sgd_bwd": K * steps if fused else 0}
        check(launches == want, "breadth", "kernel launches", cell=name, launches=launches, want=want)
        check(_finite(*losses), "breadth", "non-finite loss", cell=name, losses=losses)
        cell = {"leaves": len(tree_leaves(state.params)), "inner_optim": cfg.inner_optim.kind, "fused": fused,
                "steps": steps, "losses": losses, "step_ms": ms, "launches": launches}
        if cfg.inner_optim.kind == "adam":
            betas = torch.cat([b.reshape(-1) for k in ("beta1", "beta2") for b in tree_leaves(state.inner_hparams[k])])
            moved = float((betas - torch.cat([b.reshape(-1) for k in ("beta1", "beta2")
                                               for b in tree_leaves(start.inner_hparams[k])])).abs().max())
            check(moved > 0 and bool(((betas >= 1e-4) & (betas <= 0.99)).all()), "breadth", "Adam's betas",
                  moved=moved, lo=float(betas.min()), hi=float(betas.max()))
            cell.update(betas_moved_max=moved, betas_range=[float(betas.min()), float(betas.max())])
        if cfg.lslr_per_step:
            small = {k: v[:CROSS_TASKS] for k, v in batch.items()}
            card = MAMLSystem(cfg).meta_gradients(start, small, epoch=0)[2]["hparams"]
            cpu = MAMLSystem(cfg, device="cpu").meta_gradients(cpu_copy(start), small, epoch=0)[2]["hparams"]
            shapes = {tuple(t.shape) for t in tree_leaves(card)}
            check(shapes == {(K,)}, "breadth", "lslr_per_step lr meta-gradient shape", shapes=sorted(shapes))
            cosine = _cosine(_flat(card), _flat(cpu))
            check(cosine >= GRAD_COSINE, "breadth", "lslr_per_step lr meta-gradient: card and CPU disagree",
                  cosine=cosine, min=GRAD_COSINE)
            cell.update(lr_grad_cosine_card_cpu=cosine, lr_grad_shape=[K])
        cells[name] = cell
    result = {"phase": "breadth", "ok": True, "cells": cells, "launches": launches_total}
    emit(result)
    return result


def small_anil_cross_check(seed: int) -> dict:
    """One second-order anil meta-gradient (MSL on) of a small VGG (2
    stages, 8 filters, 8x8x1, 3-way 2-shot, K=2, the fused update) on the
    card against the same on the CPU: the loss within
    SMALL_TRAIN_TOLERANCE relative, the meta-gradient of head and body
    within SMALL_TRAIN_TOLERANCE of its largest element."""
    from howtotrainyourmamlpytorch_tpu_torch.config import Config
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
    from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg

    cfg = Config(num_classes_per_set=3, num_samples_per_class=2, num_target_samples=2, batch_size=2,
                 strategy="anil", number_of_training_steps_per_iter=2, use_pallas_inner_update=True,
                 remat_inner_steps=False)
    model = build_vgg((8, 8, 1), 3, num_stages=2, cnn_num_filters=8)
    gpu = MAMLSystem(cfg, model=model)
    state = gpu.init_train_state(seed)
    batch = learnable_synthetic_batch(2, 3, 2, 2, (8, 8, 1), seed=seed)
    loss, _, grads = gpu.meta_gradients(state, batch, epoch=0)
    cpu_loss, _, cpu_grads = MAMLSystem(cfg, model=model, device="cpu").meta_gradients(cpu_copy(state), batch, epoch=0)
    card, cpu = _flat(grads), _flat(cpu_grads)
    out = {"loss_rel": abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss)),
           "grad_max_abs_over_scale": float((card - cpu).abs().max() / cpu.abs().max()),
           "tolerance": SMALL_TRAIN_TOLERANCE}
    check(out["loss_rel"] <= SMALL_TRAIN_TOLERANCE and out["grad_max_abs_over_scale"] <= SMALL_TRAIN_TOLERANCE,
          "strategies", "the small anil step: card and CPU disagree", **out)
    return out


def serve_strategies(seed: int, cfg, system, state) -> dict:
    """The engine over the anil-trained state, serving STRATEGIES: per
    strategy, the checked pass under cuDNN's deterministic algorithms (the
    slice's flush of 3 requests at support 60 padded to 100 and a task batch
    of 4, and its third request alone), then 1 + SERVE_REPS timed flushes of
    8 requests at support 100 and their predictions on 8 x 40 queries; then
    one refine flush each for maml++ and anil."""
    import dataclasses

    from howtotrainyourmamlpytorch_tpu_torch.core.strategies import split_head_body
    from howtotrainyourmamlpytorch_tpu_torch.models.registry import build_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
    from howtotrainyourmamlpytorch_tpu_torch.utils.seeding import model_init_generator
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    engine = AdaptationEngine(system, state, serving_cfg=dataclasses.replace(cfg.serving, strategies=list(STRATEGIES)))
    n_way, steps = cfg.num_classes_per_set, engine.num_steps
    req = slice_requests(cfg, seed)
    out, adapted, checked = {}, {}, {}
    fu.reset_launch_counts()  # the serving path of the strategies starts here
    for strategy in STRATEGIES:
        torch.backends.cudnn.deterministic = True
        try:
            checked[strategy] = engine.adapt_batch(req["b"], strategy=strategy)
            probs_b = engine.predict_batch(list(zip(checked[strategy], req["qb"])), strategy=strategy)
            x, y = req["b"][2]
            alone = engine.predict(engine.adapt(x, y, strategy=strategy), req["qb"][2], strategy=strategy)
            moved = (x + NOISE_SCALE * np.random.RandomState(seed).randn(*x.shape)).astype(np.float32)
            noisy = engine.predict(engine.adapt(moved, y, strategy=strategy), req["qb"][2], strategy=strategy)
        finally:
            torch.backends.cudnn.deterministic = False
        adapt_ms, predict_ms = [], []
        for _ in range(1 + SERVE_REPS):
            t0 = time.perf_counter()
            fws = engine.adapt_batch(req["a"], strategy=strategy)
            torch.cuda.synchronize()
            adapt_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            probs_a = engine.predict_batch(list(zip(fws, req["qa"])), strategy=strategy)
            predict_ms.append((time.perf_counter() - t0) * 1e3)
        adapted[strategy] = fws
        _check_probs("strategies", f"{strategy} a", probs_a, [40] * 8, n_way)
        _check_probs("strategies", f"{strategy} b", probs_b, [15] * 3, n_way)
        _check_probs("strategies", f"{strategy} alone", [alone], [15], n_way)
        alone_dev = float(abs(alone - probs_b[2]).max())
        noise_floor = float(abs(alone - noisy).max())
        bound = max(ALONE_TOLERANCE[strategy], noise_floor)
        check(alone_dev <= bound, "strategies", "lone request differs from its place in the flush",
              strategy=strategy, max_abs=alone_dev, bound=bound, noise_floor=noise_floor)
        out[strategy] = {"adapt_flush_ms_median": statistics.median(adapt_ms[1:]), "adapt_flush_ms": adapt_ms,
                         "predict_flush_ms_median": statistics.median(predict_ms[1:]), "predict_flush_ms": predict_ms,
                         "alone_vs_flush_max_abs": alone_dev, "alone_vs_noisy_input_max_abs": noise_floor}
    # the checked passes (deterministic cuDNN): serving is first order, so
    # maml++ and fomaml are one rollout
    check(all(torch.equal(a, b) for fa, fb in zip(checked["maml++"], checked["fomaml"])
              for a, b in zip(tree_leaves(fa), tree_leaves(fb))),
          "strategies", "maml++ and fomaml adapt differ")
    check(out["protonet"]["adapt_flush_ms_median"] < out["maml++"]["adapt_flush_ms_median"], "strategies",
          "protonet's adapt flush is not faster than maml++'s", protonet=out["protonet"], maml=out["maml++"])
    head, body = split_head_body(adapted["anil"][0])
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(body), tree_leaves(split_head_body(state.params)[1]))),
          "strategies", "anil adapt changed the body")
    for strategy in ("maml++", "anil"):
        before = fu.launch_counts["fused_sgd"]
        t0 = time.perf_counter()
        refined = engine.refine_batch([(fw, x, y) for fw, (x, y) in zip(adapted[strategy], req["a"])],
                                      strategy=strategy)
        torch.cuda.synchronize()
        out[strategy]["refine_flush_ms"] = (time.perf_counter() - t0) * 1e3
        out[strategy]["refine_launches"] = fu.launch_counts["fused_sgd"] - before
        check(out[strategy]["refine_launches"] == steps, "strategies", "refine launches != adapt steps",
              strategy=strategy, launches=out[strategy]["refine_launches"])
        _check_probs("strategies", f"{strategy} refined",
                     engine.predict_batch(list(zip(refined, req["qa"])), strategy=strategy), [40] * 8, n_way)
    launches = fu.launch_counts["fused_sgd"]  # and ends here
    # per gradient strategy: the checked flush, the lone request, the one with
    # moved images, and the timed flushes
    flushes = 3 + 1 + SERVE_REPS
    want = 3 * flushes * steps + 2 * steps
    check(launches == want, "strategies", "serving launches", launches=launches, want=want)
    # what predict_batch's stack of the trees copies per request under
    # anil: the body, as under maml++ (its leaves are views of the masters)
    resnet, _ = build_model("resnet-12", (28, 28, 1), n_way).init(model_init_generator(seed))
    body_bytes = {name: sum(t.numel() * 4 for t in tree_leaves(split_head_body(p)[1]))
                  for name, p in (("vgg64", state.params), ("resnet12", resnet))}
    return {"strategies": out, "launches": launches, "flushes_per_strategy": flushes,
            "predict_stack_body_bytes_per_request": body_bytes,
            "head_leaves": len(tree_leaves(head))}


def phase_strategies(seed: int, maml_step_ms: float, twin: dict):
    """The strategy registry on the card at the fleet row
    omniglot.20.5.vgg.gd.anil: TRAIN_STEPS anil train steps and an eval
    step (B1 and B2 over the head's 2 leaves, K launches each per step),
    one step under remat ``full`` (B1 2 K, B2 K), the small and the
    full-width cross-checks, then the engine serving STRATEGIES from the
    trained state (``serve_strategies``). The anil step must be faster than
    phase ``train``'s maml++ step at the same shape."""
    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu

    cfg, system, state = full_width_system(seed, ["strategy=anil"])
    check(system.strategy == "anil" and system.use_second_order(0) and system.msl_active(0)
          and system.remat_policy == "none", "strategies", "the fleet row is second-order anil with MSL, no remat")
    n_way, img = cfg.num_classes_per_set, cfg.image_shape
    batch = learnable_synthetic_batch(cfg.batch_size, n_way, cfg.num_samples_per_class, cfg.num_target_samples, img,
                                      seed=seed + 3)
    K, K_eval = cfg.number_of_training_steps_per_iter, cfg.number_of_evaluation_steps_per_iter
    start = state
    seen, undo = _record_launches(fu)
    torch.cuda.reset_peak_memory_stats()
    fu.reset_launch_counts()  # the anil training path starts here
    try:
        state, losses, train_ms = _steps(system, state, batch, TRAIN_STEPS)
        train_launches, copies = dict(fu.launch_counts), fu.contiguous_copies
        t0 = time.perf_counter()
        ev = system.eval_step(state, batch)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3
    finally:
        undo()
    launches = dict(fu.launch_counts)  # and ends here
    peak = torch.cuda.max_memory_allocated()
    want = {"fused_sgd": K * TRAIN_STEPS, "fused_sgd_bwd": K * TRAIN_STEPS}
    check(train_launches == want, "strategies", "anil launches differ from K per train step",
          launches=train_launches, want=want)
    check(launches["fused_sgd"] == want["fused_sgd"] + K_eval, "strategies", "anil eval launches", launches=launches)
    check({n for _, _, n in seen} == {HEAD_LEAVES}, "strategies", "B1/B2 ran over other than the head's leaves",
          leaves=sorted({n for _, _, n in seen}))
    check(_finite(*losses, ev.loss) and bool(torch.isfinite(ev.per_task_target_logits).all()), "strategies",
          "non-finite loss", losses=losses, eval=float(ev.loss))
    check(losses[-1] < losses[0], "strategies", f"{TRAIN_STEPS} anil steps on one batch did not lower the loss",
          losses=losses)
    anil_ms = statistics.median(train_ms)
    check(anil_ms < maml_step_ms, "strategies", "the anil step is not faster than the maml++ step",
          anil_ms=anil_ms, maml_ms=maml_step_ms)
    profile = profile_device(lambda: system.train_step(state, batch, epoch=0))
    _, remat_system = full_width_system(seed, ["strategy=anil", "remat_policy=full"])[:2]
    fu.reset_launch_counts()  # the anil step under remat full starts here
    _, remat_losses, remat_ms = _steps(remat_system, start, batch, 1)
    remat_launches = dict(fu.launch_counts)  # and ends here
    check(remat_launches == {"fused_sgd": 2 * K, "fused_sgd_bwd": K}, "strategies", "anil remat launches",
          launches=remat_launches)
    check(remat_losses[0] == losses[0], "strategies", "remat changed the first step's loss",
          remat=remat_losses[0], none=losses[0])
    small = small_anil_cross_check(seed)
    cross = train_cross_check(cfg, start, batch, losses[0], phase="strategies",
                              cpu_half=twin_result(twin, "strategies", "strategies"))
    served = serve_strategies(seed, cfg, system, state)
    result = {
        "phase": "strategies", "ok": True,
        "config": "configs/default.yaml + strategy=anil use_pallas_inner_update=true remat_inner_steps=false "
                  "(fleet row omniglot.20.5.vgg.gd.anil)",
        "inner_steps": K, "train_steps": TRAIN_STEPS, "train_launches": train_launches,
        "launches_with_eval": launches, "launch_leaves": sorted({n for _, _, n in seen}),
        "contiguous_copies_train": copies, "contiguous_copies_per_step": copies / TRAIN_STEPS, "losses": losses,
        "eval_loss": float(ev.loss), "eval_accuracy": float(ev.accuracy), "eval_step_ms": eval_ms,
        "train_step_ms_median": anil_ms, "train_step_ms": train_ms, "maml_step_ms_median": maml_step_ms,
        "max_memory_allocated": peak, "train_step_profile": profile,
        "remat_full": {"launches": remat_launches, "step_ms": remat_ms[0], "loss": remat_losses[0]},
        "small_cross_check": small, "cross_check": cross, **served,
    }
    emit(result)
    return result


def phase_precision(seed: int):
    """``Config.matmul_precision`` on the card: the default config's VGG
    train step (second order, MSL, the fused update) from one start state
    under ``highest`` (IEEE float32) and ``high`` (TF32 matmuls and
    convolutions), PRECISION_STEPS steps each, the first untimed; the
    first step's loss and the median step. The flags are read back, and
    restored to IEEE float32 after."""
    import warnings

    from howtotrainyourmamlpytorch_tpu_torch.core.maml import apply_matmul_precision, fp32_precision_flags
    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch

    out, start, batch = {}, None, None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # each switch of the process-wide flags warns
        try:
            for value in ("highest", "high"):
                cfg, system, state = full_width_system(seed, [f"matmul_precision={value}"])
                flags = fp32_precision_flags()
                check(flags == (("tf32",) * 2 if value == "high" else ("ieee",) * 2), "precision",
                      "the flags do not follow matmul_precision", value=value, flags=list(flags))
                if start is None:
                    start = state
                    batch = learnable_synthetic_batch(cfg.batch_size, cfg.num_classes_per_set,
                                                      cfg.num_samples_per_class, cfg.num_target_samples,
                                                      cfg.image_shape, seed=seed + 3)
                _, losses, ms = _steps(system, start, batch, PRECISION_STEPS)
                check(_finite(*losses), "precision", "non-finite loss", value=value, losses=losses)
                out[value] = {"flags": list(flags), "first_loss": losses[0], "losses": losses,
                              "step_ms_median": statistics.median(ms[1:]), "step_ms": ms}
        finally:
            apply_matmul_precision("highest")
    result = {"phase": "precision", "ok": True, "config": "configs/default.yaml + use_pallas_inner_update=true",
              "values": out,
              "first_loss_rel_high_vs_highest": abs(out["high"]["first_loss"] - out["highest"]["first_loss"])
              / abs(out["highest"]["first_loss"]),
              "step_ms_high_over_highest": out["high"]["step_ms_median"] / out["highest"]["step_ms_median"]}
    emit(result)
    return result


PROGRAMS_CHUNK = 3  # train steps per multi-step dispatch (a)-(b)
PROGRAMS_EVAL_BATCHES = 8  # eval batches per fused dispatch (c)
PROGRAMS_RUNNER = ["total_epochs=2", "total_iter_per_epoch=3", "train_steps_per_dispatch=3",
                   "eval_fused_dispatch=true", "num_evaluation_tasks=8", "load_into_memory=false"]
PROGRAMS_BUDGET_S = 120.0
# the default algorithms' floor: the largest difference over every pair of
# PROGRAMS_EAGER eager runs of one chunk from one state (the rollout is
# chaotic: one pair is one draw of a spread of 0.5-3% of the loss; 5 runs
# give 10 pairs), times the factor phase elastic uses for its floor
PROGRAMS_EAGER, PROGRAMS_FLOOR_FACTOR = 5, 2.0


def _chunk(cfg, seed: int, n: int):
    """``n`` class-structured batches of the config -> (the list, their
    stack with a leading [n] axis)."""
    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch

    batches = [learnable_synthetic_batch(cfg.batch_size, cfg.num_classes_per_set, cfg.num_samples_per_class,
                                         cfg.num_target_samples, cfg.image_shape, seed=seed + i) for i in range(n)]
    return batches, {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _eager_chunk(system, state, batches):
    """The eager steps of a chunk from ``state`` -> (state, losses, the
    chunk's seconds per step, host and card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for b in batches:
        state, out = system.train_step(state, b, epoch=0)
        losses.append(out.loss)
    torch.cuda.synchronize()
    return state, torch.stack(losses), (time.perf_counter() - t0) * 1e3 / len(batches)


def _graph_chunk(system, state, stacked):
    """One multi-step dispatch (a CUDA graph replayed per step) -> (state
    copied out of the graph's buffers, losses, ms per step)."""
    from howtotrainyourmamlpytorch_tpu_torch.core.programs import clone_tree

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, (losses, _, _) = system.train_step_multi(state, stacked, 0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(losses)
    return clone_tree(state), losses, ms


def _state_diff(a, b) -> float:
    from howtotrainyourmamlpytorch_tpu_torch.core.programs import tree_leaves_any

    return max(float((x.float() - y.float()).abs().max()) for x, y in
               zip(tree_leaves_any((a.params, a.inner_hparams, a.opt_state)),
                   tree_leaves_any((b.params, b.inner_hparams, b.opt_state))) if torch.is_tensor(x))


def profile_replay(fn, trace_dir: str) -> dict:
    """``fn`` once under ``torch.profiler`` (CPU and CUDA), its Chrome trace
    written under ``trace_dir`` in the runner's layout: the wall ms; the
    card's busy ms as the union of the trace's device intervals
    (``device_busy``) over the wall time, beside their summed durations and
    ``key_averages``' summed kernel time (two measures that count
    overlapping events twice); the streams; ``device_time_breakdown``; the
    kernels, B1 (``fused_sgd_kernel``) and B2 (``fused_sgd_bwd_kernel``)
    counted by name with their ms per launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from howtotrainyourmamlpytorch_tpu_torch.utils.profiling import device_busy, device_time_breakdown, trace_path

    shutil.rmtree(trace_dir, ignore_errors=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    bwd = [e for e in kernels if "fused_sgd_bwd" in e.key]
    fwd = [e for e in kernels if "fused_sgd" in e.key and e not in bwd]
    path = trace_path(trace_dir, "replay")
    prof.export_chrome_trace(path)
    busy = device_busy(path) or {}
    per_launch = lambda es: (sum(e.self_device_time_total for e in es) / 1e3 / max(1, sum(e.count for e in es)))  # noqa: E731
    return {"wall_ms": wall_ms, "breakdown": device_time_breakdown(trace_dir),
            "busy_ms": busy.get("union_ms"), "busy_share": busy["union_ms"] / wall_ms if busy else None,
            "trace_sum_ms": busy.get("sum_ms"), "trace_span_ms": busy.get("span_ms"), "streams": busy.get("streams"),
            "key_averages_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "kernels": sum(e.count for e in kernels), "fused_sgd": sum(e.count for e in fwd),
            "fused_sgd_bwd": sum(e.count for e in bwd), "fused_sgd_ms_per_launch": per_launch(fwd),
            "fused_sgd_bwd_ms_per_launch": per_launch(bwd)}


def _graph_against_eager(system, start, batches, stacked, tmp: str, eager_runs: int,
                         profile_eager: bool = True) -> dict:
    """``eager_runs`` eager chunks and two graph dispatches (the first
    captures) from ``start``, each timed; one replay profiled, and one eager
    step where ``profile_eager``."""
    from howtotrainyourmamlpytorch_tpu_torch.core.programs import clone_tree

    runs = [_eager_chunk(system, clone_tree(start), batches) for _ in range(eager_runs)]
    eager_profile = (profile_replay(lambda: system.train_step(clone_tree(start), batches[0], epoch=0),
                                    os.path.join(tmp, "eager_trace")) if profile_eager else {})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graph1 = _graph_chunk(system, clone_tree(start), stacked)
    first_dispatch_s = time.perf_counter() - t0
    graph2 = _graph_chunk(system, clone_tree(start), stacked)
    peak = torch.cuda.max_memory_allocated()
    # one replay (a chunk of one step) under the profiler and its trace
    one = {key: value[:1] for key, value in stacked.items()}
    replay = profile_replay(lambda: system.train_step_multi(clone_tree(start), one, 0),
                            os.path.join(tmp, "graph_trace"))
    captured = next(iter(system._train_multi.values())).captures[0]
    return {"runs": runs, "graph1": graph1, "graph2": graph2, "eager_profile": eager_profile, "replay": replay,
            "first_dispatch_s": first_dispatch_s, "pool_bytes": captured.memory["peak_bytes"],
            "max_memory_allocated": peak,
            "warmup_s": captured.lower_s, "capture_s": captured.compile_s, "step_flops": captured.cost.get("flops"),
            "ledger_memory": captured.memory, "capture_launches": dict(captured.launches)}


def programs_train(seed: int, tmp: str, overrides=(), deterministic: bool = False) -> dict:
    """(a) or (b): a chunk of PROGRAMS_CHUNK steps replayed from a CUDA
    graph against the same eager steps from one start state. (a), with the
    default algorithms: PROGRAMS_EAGER eager runs, and the graph and two
    replays of it within PROGRAMS_FLOOR_FACTOR x the largest difference
    among them; then a fresh system under the deterministic algorithms
    (``warn_only``): graph and eager bit-equal unless an op warned (then
    within the floor). (b), ``deterministic``: the whole cell under the
    deterministic algorithms, one eager run (ResNet-12's float32 rollout at
    K=5 moves its first loss by up to 2e-3 between two default runs: the
    first-loss gate would be a coin toss there): graph and eager, and two
    replays, bit-equal unless an op warned, and then within
    PROGRAMS_FLOOR_FACTOR x the difference of a second eager run. Both:
    the profiler sees B1 and B2 K times in one replay, the tally the
    graph's capture recorded (what each replay adds to the counts)."""
    import warnings

    from howtotrainyourmamlpytorch_tpu_torch.core.programs import clone_tree

    with deterministic_algorithms(deterministic), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg, system, start = full_width_system(seed, overrides)
        batches, stacked = _chunk(cfg, seed + 11, PROGRAMS_CHUNK)
        cell = _graph_against_eager(system, start, batches, stacked, tmp, 1 if deterministic else PROGRAMS_EAGER,
                                    profile_eager=not deterministic)
        warned = sorted({str(w.message)[:200] for w in caught if "deterministic" in str(w.message).lower()})
        if deterministic and warned:  # the floor: a second eager run of the chunk
            cell["runs"].insert(0, _eager_chunk(system, clone_tree(start), batches))
        del system
    (eager, eager_losses, eager_ms), replay = cell["runs"][-1], cell["replay"]
    (graph1, graph_losses, first_ms), (graph2, graph2_losses, graph_ms) = cell["graph1"], cell["graph2"]
    check(bool(torch.isfinite(graph_losses).all()), "programs", "non-finite graph loss", losses=graph_losses.tolist())
    K = cfg.number_of_training_steps_per_iter
    seen = {k: replay[k] for k in ("fused_sgd", "fused_sgd_bwd")}
    check(seen == {"fused_sgd": K, "fused_sgd_bwd": K} == cell["capture_launches"], "programs",
          "the profiler did not see B1 and B2 K times in a replay, as the capture recorded", seen=seen,
          captured=cell["capture_launches"], want=K)
    loss_diff, state_diff = float((graph_losses - eager_losses).abs().max()), _state_diff(graph1, eager)
    replay_loss, replay_state = float((graph_losses - graph2_losses).abs().max()), _state_diff(graph1, graph2)
    out = {"config": "configs/default.yaml " + " ".join(overrides), "chunk": PROGRAMS_CHUNK,
           "deterministic_algorithms": deterministic, "nondeterministic_op_warnings": warned,
           "eager_losses": eager_losses.tolist(), "graph_losses": graph_losses.tolist(),
           "graph_vs_eager_loss_max_abs": loss_diff, "graph_vs_eager_state_max_abs": state_diff,
           "replay_vs_replay_loss_max_abs": replay_loss, "replay_vs_replay_state_max_abs": replay_state,
           "eager_step_ms": eager_ms, "graph_step_ms": graph_ms, "graph_over_eager": graph_ms / eager_ms,
           "first_dispatch_s": cell["first_dispatch_s"], "first_dispatch_ms_per_step": first_ms,
           **{k: cell[k] for k in ("warmup_s", "capture_s", "step_flops", "pool_bytes", "ledger_memory",
                                   "max_memory_allocated")},
           "kernels_per_eager_step": cell["eager_profile"].get("kernels"),
           "eager_step_busy_share": cell["eager_profile"].get("busy_share"),
           "eager_step_wall_ms": cell["eager_profile"].get("wall_ms"),
           "graph_replay_kernels": replay["kernels"], "graph_replay_wall_ms": replay["wall_ms"],
           "graph_busy_share": replay["busy_share"], "graph_breakdown": replay["breakdown"],
           **{f"{name}_busy": {k: prof.get(k) for k in ("busy_ms", "trace_sum_ms", "key_averages_ms", "trace_span_ms",
                                                         "streams")}
              for name, prof in (("eager_step", cell["eager_profile"]), ("graph_replay", replay))},
           "b1_per_replay": replay["fused_sgd"], "b2_per_replay": replay["fused_sgd_bwd"],
           "in_graph_ms": {k: replay[f"{k}_ms_per_launch"] for k in ("fused_sgd", "fused_sgd_bwd")},
           "eager_profiled_ms": {k: cell["eager_profile"].get(f"{k}_ms_per_launch") for k in ("fused_sgd", "fused_sgd_bwd")}}
    pairs = [(a, b) for i, a in enumerate(cell["runs"]) for b in cell["runs"][i + 1:]]
    if pairs:  # (b) has one eager run unless an op warned
        floor_loss = PROGRAMS_FLOOR_FACTOR * max(float((a[1] - b[1]).abs().max()) for a, b in pairs)
        floor_state = PROGRAMS_FLOOR_FACTOR * max(_state_diff(a[0], b[0]) for a, b in pairs)
        out.update(eager_floor_loss_max_abs=floor_loss, eager_floor_state_max_abs=floor_state,
                   replay_gate={"pairs": len(pairs), "floor": floor_loss / PROGRAMS_FLOOR_FACTOR,
                                "value": replay_loss, "gate": floor_loss})
    del cell, pairs
    if deterministic:
        out["bit_equal"] = loss_diff == 0.0 and state_diff == 0.0
        if warned:
            check(max(loss_diff, replay_loss) <= floor_loss and max(state_diff, replay_state) <= floor_state,
                  "programs", "deterministic graph beyond the eager floor (an op warned)", loss=loss_diff,
                  state=state_diff, replay_loss=replay_loss, replay_state=replay_state, floor_loss=floor_loss,
                  floor_state=floor_state, warned=warned)
        else:
            check(out["bit_equal"] and replay_loss == 0.0 and replay_state == 0.0, "programs",
                  "graph or replay not bit-equal to eager under the deterministic algorithms", loss=loss_diff,
                  state=state_diff, replay_loss=replay_loss, replay_state=replay_state)
        return out
    # with the default (nondeterministic) algorithms a replay differs from
    # eager, and from another replay, as two eager runs do
    check(replay_loss <= floor_loss and replay_state <= floor_state, "programs",
          "two replays of one graph from one state differ beyond the eager floor", loss=replay_loss,
          state=replay_state, floor_loss=floor_loss, floor_state=floor_state)
    check(loss_diff <= floor_loss and state_diff <= floor_state, "programs", "graph beyond the eager floor",
          loss=loss_diff, state=state_diff, floor_loss=floor_loss, floor_state=floor_state)
    with deterministic_algorithms(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, dsystem, dstart = full_width_system(seed, overrides)
        d_eager, d_eager_losses, _ = _eager_chunk(dsystem, clone_tree(dstart), batches)
        d_graph, d_graph_losses, _ = _graph_chunk(dsystem, clone_tree(dstart), stacked)
        d_graph2, d_graph2_losses, _ = _graph_chunk(dsystem, clone_tree(dstart), stacked)
        del dsystem
    check(torch.equal(d_graph_losses, d_graph2_losses) and _state_diff(d_graph, d_graph2) == 0.0, "programs",
          "two replays of one graph differ under the deterministic algorithms",
          loss=float((d_graph_losses - d_graph2_losses).abs().max()), state=_state_diff(d_graph, d_graph2))
    warned = sorted({str(w.message)[:200] for w in caught if "deterministic" in str(w.message).lower()})
    d_loss, d_state = float((d_graph_losses - d_eager_losses).abs().max()), _state_diff(d_graph, d_eager)
    out["deterministic"] = {"loss_max_abs": d_loss, "state_max_abs": d_state,
                            "bit_equal": d_loss == 0.0 and d_state == 0.0, "warned": warned}
    if warned:
        check(d_loss <= floor_loss and d_state <= floor_state, "programs",
              "deterministic graph beyond the eager floor (an op warned)", **out["deterministic"])
    else:
        check(d_loss == 0.0 and d_state == 0.0, "programs", "graph not bit-equal to eager under deterministic "
              "algorithms", **out["deterministic"])
    return out


def programs_eval(seed: int, floor: float) -> dict:
    """(c): ``eval_step_multi`` over PROGRAMS_EVAL_BATCHES batches (a graph
    of the eval step, replayed per batch) against the eager eval steps,
    under the deterministic algorithms: per-task losses equal, or within
    (a)'s loss floor ``floor`` where an op warned."""
    import warnings

    with deterministic_algorithms(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg, system, state = full_width_system(seed)
        batches, stacked = _chunk(cfg, seed + 31, PROGRAMS_EVAL_BATCHES)
        eager = torch.stack([system.eval_step(state, b).per_task_losses for b in batches])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = torch.stack([system.eval_step(state, b).per_task_losses for b in batches])
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        graph, _ = system.eval_step_multi(state, stacked)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph2, _ = system.eval_step_multi(state, stacked)
        torch.cuda.synchronize()
        graph_ms = (time.perf_counter() - t0) * 1e3
        del system
    warned = sorted({str(w.message)[:200] for w in caught if "deterministic" in str(w.message).lower()})
    diff = float((graph - eager).abs().max())
    check(tuple(graph.shape) == (PROGRAMS_EVAL_BATCHES, cfg.batch_size) and torch.equal(graph, graph2), "programs",
          "fused eval shape or replay", shape=list(graph.shape))
    check(diff == 0.0 or (warned and diff <= floor), "programs", "fused eval differs from the eager eval steps",
          diff=diff, floor=floor, warned=warned)
    return {"batches": PROGRAMS_EVAL_BATCHES, "graph_vs_eager_max_abs": diff, "bit_equal": diff == 0.0,
            "nondeterministic_op_warnings": warned, "eager_ms": eager_ms, "graph_ms": graph_ms}


def programs_runner(seed: int, tmp: str) -> dict:
    """(d): the runner with train_steps_per_dispatch 3, the fused eval and
    profile_dir, on phase ``runner``'s image folder: 2 epochs of 3 steps
    (the profiled epoch 0 keeps K = 1, as the JAX runner's does; epoch 1
    dispatches one chunk of 3). Gates: the ledger's train_multi, eval_multi
    and nvcc lines, a non-null flops_per_step and mfu in the telemetry, the
    trace's breakdown with compute_frac > 0.5."""
    from howtotrainyourmamlpytorch_tpu_torch.config import load_config
    from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
    from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import _read_jsonl
    from howtotrainyourmamlpytorch_tpu_torch.utils.profiling import device_time_breakdown

    prof_dir = os.path.join(tmp, "programs_profile")
    cfg = load_config(DEFAULT_CONFIG, [
        "use_pallas_inner_update=true", "remat_inner_steps=false",
        f"dataset.path={os.path.join(tmp, 'omniglot_dataset')}", f"index_cache_dir={os.path.join(tmp, 'index')}",
        f"experiment_root={os.path.join(tmp, 'programs_runner')}", f"profile_dir={prof_dir}", f"seed={seed}",
        *PROGRAMS_RUNNER])
    t0 = time.perf_counter()
    runner = ExperimentRunner(cfg)
    result = runner.run_experiment()
    run_s = time.perf_counter() - t0
    ledger = _read_jsonl(os.path.join(runner.logs_dir, "compile_ledger.jsonl"))
    names = sorted({e["program"] for e in ledger})
    snaps = [r for r in _read_jsonl(os.path.join(runner.logs_dir, "telemetry.jsonl")) if r.get("kind") == "epoch"]
    last = snaps[-1] if snaps else {}
    gauges = last.get("gauges", {})
    breakdown = device_time_breakdown(prof_dir)
    check(any(n.startswith("train_multi/") for n in names) and "eval_multi" in names
          and any(n.startswith("nvcc/") for n in names), "programs", "the ledger's program lines", names=names)
    check(gauges.get("flops_per_step") and last.get("mfu") is not None, "programs", "flops_per_step and mfu",
          flops_per_step=gauges.get("flops_per_step"), mfu=last.get("mfu"))
    check(breakdown is not None and breakdown["compute_frac"] > 0.5, "programs", "the profile's breakdown",
          breakdown=breakdown)
    check(_finite(result["test_loss_mean"]), "programs", "non-finite test loss", result=result)
    return {"run_s": run_s, "ledger": [{k: e.get(k) for k in ("program", "lower_s", "compile_s", "total_s", "cold",
                                                              "flops", "persistent_cache")} for e in ledger],
            "flops_per_step": gauges.get("flops_per_step"), "peak_flops_per_sec": gauges.get("peak_flops_per_sec"),
            "mfu": last.get("mfu"), "interval_steps_per_s": last.get("interval_steps_per_s"),
            "breakdown": breakdown, "test_loss": result["test_loss_mean"]}


def programs_kernels_in_graph(seed: int) -> dict:
    """B1 and B2 inside a captured CUDA graph, held against their plain
    twins at the main paths' trees (VGG-64 x 8, 18 leaves: the 64-leaf
    table; ResNet-12 x 8, 86 leaves: the 256-leaf table). Both launches are
    captured into one graph over static operands; the operands are then
    changed in place and the graph replayed, so the replay must read them:
    B1 and B2's ``dg`` bit-equal to the twins, ``dlr`` within its bound, and
    two replays bit-equal. These launches compare, so they count on no
    path."""
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu

    out = {}
    for name, overrides in (("vgg64", ()), ("resnet12", RESNET_OVERRIDES)):
        ps, gs, lrs = main_path_tree(seed, torch.float32, salt=41, overrides=overrides)
        cts, gs2, lrs2 = main_path_tree(seed, torch.float32, salt=43, cotangents=True, overrides=overrides)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):  # the libraries load outside the capture
            fu._launch_forward(ps, gs, lrs)
            fu._launch_backward(cts, gs2, lrs2)
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            outs = fu._launch_forward(ps, gs, lrs)
            dgs, dlr = fu._launch_backward(cts, gs2, lrs2)
        with torch.no_grad():
            for t in ps + cts:
                t.mul_(-0.5).add_(0.25)
        graph.replay()
        torch.cuda.synchronize()
        first = ([o.clone() for o in outs], [d.clone() for d in dgs], dlr.clone())
        graph.replay()
        torch.cuda.synchronize()
        twin = fu.fused_sgd_tree_reference(ps, gs, lrs)
        dg_twin, _ = fu.fused_sgd_tree_bwd_reference(cts, gs2, lrs2)
        exact, bound, _ = dlr_bound(cts, gs2)
        dlr_err = (dlr.double().cpu() - exact).abs()
        check(all(torch.equal(a, b) for a, b in zip(outs, twin)), "programs", f"B1 in a graph differs from its twin ({name})")
        check(all(torch.equal(a, b) for a, b in zip(dgs, dg_twin)), "programs", f"B2's dg in a graph differs ({name})")
        check(bool((dlr_err <= bound).all()), "programs", f"B2's dlr in a graph beyond its bound ({name})",
              worst=float((dlr_err - bound).max()))
        check(all(torch.equal(a, b) for a, b in zip(first[0] + first[1] + [first[2]], list(outs) + list(dgs) + [dlr])),
              "programs", f"two replays of the kernels differ ({name})")
        out[name] = {"leaves": len(ps), "elements": sum(p.numel() for p in ps), "b1_bit_equal": True,
                     "dg_bit_equal": True, "dlr_max_abs_err": float(dlr_err.max()),
                     "dlr_bound_min": float(bound.min())}
        del graph, outs, dgs, dlr, first
    return out


def phase_programs(seed: int, tmp: str):
    """The program layer on the card; see the module docstring. (a) the
    VGG train cell's chunk against eager steps, (b) ResNet-12's, (c) the
    fused eval, (d) the runner with K = 3, the fused eval and profile_dir.
    The kernels' launches on this path are the wrappers' counts from just
    before (a) to just after (d): the eager launches (warmups, eager steps,
    the runner's profiled epoch) and every replay's, which each replay adds
    as the tally its graph's capture recorded (``core/programs.py``); a
    capture itself launches nothing and adds nothing."""
    import gc

    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu

    t_phase = time.perf_counter()
    kernels = programs_kernels_in_graph(seed)
    fu.reset_launch_counts()  # the program layer's path starts here
    vgg = programs_train(seed, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    resnet = programs_train(seed, tmp, RESNET_OVERRIDES, deterministic=True)
    check(abs(resnet["graph_losses"][0] - resnet["eager_losses"][0]) <= LOSS_RTOL * abs(resnet["eager_losses"][0]),
          "programs", "ResNet-12's first graph loss", graph=resnet["graph_losses"][0], eager=resnet["eager_losses"][0])
    gc.collect()
    torch.cuda.empty_cache()
    ev = programs_eval(seed, vgg["eager_floor_loss_max_abs"])
    runner = programs_runner(seed, tmp)
    launches, replayed = dict(fu.launch_counts), dict(fu.replayed_counts)  # and ends here
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    in_graph = {k: {"vgg64": vgg["in_graph_ms"][k], "resnet12": resnet["in_graph_ms"][k]}
                for k in ("fused_sgd", "fused_sgd_bwd")}
    check(all(n > 0 for n in replayed.values()), "programs", "no replayed launch of B1 or B2", replayed=replayed)
    result = {"phase": "programs", "ok": True, "kernels_in_graph": kernels, "vgg": vgg, "resnet12": resnet,
              "eval": ev, "runner": runner, "launches": launches, "launches_replayed": replayed,
              "launches_eager": {k: launches[k] - replayed[k] for k in launches}, "in_graph_ms": in_graph,
              "seconds": round(seconds, 1), "budget_s": PROGRAMS_BUDGET_S}
    emit(result)
    return result


PREWARM_DEVICE = "cuda"
# (a)-(b): 2 epochs of 3 steps at K=3, the MSL window closing after epoch 0
# (epoch 1 flips the train variant), the fused eval, the strict guard
PREWARM_RUNNER = ["total_epochs=2", "total_iter_per_epoch=3", "train_steps_per_dispatch=3",
                  "multi_step_loss_num_epochs=1", "eval_fused_dispatch=true", "strict_recompile_guard=true",
                  "num_evaluation_tasks=8", "load_into_memory=false"]
PREWARM_MESH_DP, PREWARM_MESH_STEPS = 2, 3  # (c): the mesh's width and its chunk
# three fresh CLI processes, each with 7-9 s of imports and as much for its
# card start, overlapped (63.5-82.1 s on an NVIDIA H100 80GB HBM3)
PREWARM_BUDGET_S = 90.0

# one training CLI leg of phase prewarm, run as ``python -c`` with the CLI's
# arguments: the deterministic algorithms on in the leg's own process
# before the runner is built (as the serve CLI turns them on), each
# multi-step dispatch timed to the card's idle with its losses, the
# kernels' counts, and the wall clock at its start, after its imports and
# the card's start, at its release (``PREWARM_GATE``: a file to wait for)
# and around the runner's construction and run; one ``PREWARM_LEG {...}``
# line after the CLI returns
_PREWARM_LEG = r"""
import time
marks = {"start": time.time()}
import json, os, sys
parent = os.getppid()
import torch
from howtotrainyourmamlpytorch_tpu_torch import train
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
from howtotrainyourmamlpytorch_tpu_torch.utils.seeding import deterministic_algorithms

marks["imported"] = time.time()
dispatches, real = [], MAMLSystem.train_step_multi
real_init, real_run = ExperimentRunner.__init__, ExperimentRunner.run_experiment


def init(self, *args, **kwargs):
    marks["init"] = time.time()
    real_init(self, *args, **kwargs)
    marks["built"] = time.time()


def run(self):
    marks["run"] = time.time()
    try:
        return real_run(self)
    finally:
        marks["ran"] = time.time()


def timed(self, state, batches, epoch=None):
    cuda = self.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, outs = real(self, state, batches, epoch)
    if cuda:
        torch.cuda.synchronize()
    dispatches.append((epoch, (time.perf_counter() - t0) * 1e3, outs[0].clone()))
    return state, outs


MAMLSystem.train_step_multi = timed
ExperimentRunner.__init__, ExperimentRunner.run_experiment = init, run
# what the CLI pays before its runner, paid before the gate: the
# deterministic switch's imports (torch._inductor) and the card's start
with deterministic_algorithms():
    pass
if torch.cuda.is_available():
    torch.zeros(1, device="cuda")
marks["ready"] = time.time()
gate = os.environ.get("PREWARM_GATE")
while gate and not os.path.exists(gate):
    if os.getppid() != parent:
        sys.exit(3)
    time.sleep(0.02)
marks["released"] = time.time()
with deterministic_algorithms():
    rc = train.main(sys.argv[1:])
print("PREWARM_LEG " + json.dumps({
    "rc": rc, "launches": dict(fu.launch_counts), "marks": marks,
    "dispatches": [{"epoch": e, "ms": ms, "losses": l.tolist()} for e, ms, l in dispatches]}), flush=True)
sys.exit(rc)
"""


def _spawn_leg(name: str, overrides, env, gate: str) -> dict:
    """Start one CLI leg in a fresh process: it imports and starts the
    card, then waits for the file ``gate`` (:func:`_release_leg`) before
    it runs, so that its start overlaps the work before it instead of
    following it."""
    from howtotrainyourmamlpytorch_tpu_torch.config import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    leg = {"name": name, "run_dir": load_config(DEFAULT_CONFIG, overrides).run_dir(), "gate": gate}
    out = tempfile.TemporaryFile("w+")
    cmd = [sys.executable, "-c", _PREWARM_LEG, "--config", DEFAULT_CONFIG, "--device", PREWARM_DEVICE, *overrides]
    leg.update(out=out, wall0=time.time(), t0=time.perf_counter(),
               proc=subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, cwd=root,
                                     env=dict(env, PREWARM_GATE=gate)))
    return leg


def _note_leg_start(leg: dict) -> None:
    """The leg's run directory as it stands before the leg runs: what it
    appends from here on is this leg's."""
    from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import _read_jsonl

    logs = os.path.join(leg["run_dir"], "logs")
    leg["n_ledger"] = len(_read_jsonl(os.path.join(logs, "compile_ledger.jsonl")))
    leg["n_events"] = len(_read_jsonl(os.path.join(logs, "events.jsonl")))


def _release_leg(leg: dict) -> None:
    _note_leg_start(leg)
    open(leg["gate"], "w").close()


def _stop_leg(leg: dict) -> None:
    if leg["proc"].poll() is None:
        leg["proc"].kill()
        leg["proc"].wait()


def _finish_leg(leg: dict) -> dict:
    """Wait for one leg -> its ``PREWARM_LEG`` record, its seconds, and
    what its run directory says of this session: the cold start, the
    prewarm and manifest events, the ledger's new entries, the guard's last
    snapshot."""
    from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import _read_jsonl

    name, run_dir, proc = leg["name"], leg["run_dir"], leg["proc"]
    try:
        proc.wait(timeout=300)
    finally:
        _stop_leg(leg)
    wall_s, wall_end = time.perf_counter() - leg["t0"], time.time()
    leg["out"].seek(0)
    text = leg["out"].read()
    lines = [ln for ln in text.splitlines() if ln.startswith("PREWARM_LEG ")]
    check(proc.returncode == 0 and len(lines) == 1, "prewarm", f"leg {name} failed", rc=proc.returncode,
          out=text[-4000:])
    record = json.loads(lines[0][len("PREWARM_LEG "):])
    logs = os.path.join(run_dir, "logs")
    events = _read_jsonl(os.path.join(logs, "events.jsonl"))[leg["n_events"]:]
    entries = _read_jsonl(os.path.join(logs, "compile_ledger.jsonl"))[leg["n_ledger"]:]
    telemetry = _read_jsonl(os.path.join(logs, "telemetry.jsonl"))
    guards = [r["providers"]["recompile_guard"] for r in telemetry if (r.get("providers") or {}).get("recompile_guard")]
    by_phase = {}
    for e in entries:
        key = "nvcc" if e["program"].startswith("nvcc/") else (e.get("phase") or "run")
        by_phase[key] = by_phase.get(key, 0) + 1
    captures = [e for e in entries if e.get("graph")]
    first = lambda epoch: next((d["ms"] for d in record["dispatches"] if d["epoch"] == epoch), None)  # noqa: E731
    prewarm = next((e for e in events if e.get("event") == "prewarm"), None)
    marks = record["marks"]
    # where the leg's wall time went: interpreter start, imports, the wait
    # at its gate, the runner's construction, its run (the prewarm, the
    # epochs, the test), the exit; and the run's phases from its last
    # telemetry snapshot
    timeline = {"spawn_s": marks["start"] - leg["wall0"], "import_s": marks["imported"] - marks["start"],
                "card_start_s": marks["ready"] - marks["imported"], "gate_wait_s": marks["released"] - marks["ready"],
                "cli_to_runner_s": marks["init"] - marks["released"], "runner_init_s": marks["built"] - marks["init"],
                "run_s": marks["ran"] - marks["run"], "exit_s": wall_end - marks["ran"]}
    snaps = [r for r in telemetry if r.get("phases")]
    phases = {k: round(v.get("sum_ms", 0.0) / 1e3, 3) for k, v in (snaps[-1]["phases"] if snaps else {}).items()}
    return {
        "timeline": timeline, "run_phases_s": phases, "wall_s": wall_s,
        "released_to_exit_s": wall_end - marks["released"], "run_dir": run_dir,
        "cold_start_s": _last_cold_start(run_dir), "losses": [x for d in record["dispatches"] for x in d["losses"]],
        "dispatch_ms": [d["ms"] for d in record["dispatches"]], "epoch0_first_ms": first(0), "flip_ms": first(1),
        "epochs": [e["epoch"] for e in events if "train_loss_mean" in e],
        "val_losses": [e["val_loss_mean"] for e in events if "val_loss_mean" in e],
        "prewarm": {k: v for k, v in (prewarm or {}).items() if k != "ts"} or None,
        "manifest_events": [{k: e[k] for k in ("expected_warm", "reason")} for e in events
                            if e.get("event") == "prewarm_manifest"],
        "ledger_by_phase": by_phase, "entries": entries,
        "captures": [{"program": e["program"], "phase": e.get("phase"), "warmup_s": e["lower_s"],
                      "capture_s": e["compile_s"], "pool_bytes": (e.get("memory") or {}).get("peak_bytes")}
                     for e in captures],
        "guard": guards[-1] if guards else None, "launches": record["launches"],
    }


def prewarm_mesh(seed: int) -> dict:
    """(c): the VGG train cell on a dp=2 mesh of ``[cuda:0, cuda:0]`` under
    the deterministic algorithms: a chunk of PREWARM_MESH_STEPS sharded
    steps (one epoch of 3 steps) replayed from one CUDA graph of the
    sharded step against the same sharded eager steps, bit-equal losses
    and state; the replayed step's ms beside the eager one's; B1 and B2 per
    replay; the fused eval of the trained state over the mesh against the
    per-batch sharded eval, bit-equal."""
    from howtotrainyourmamlpytorch_tpu_torch.config import ParallelConfig
    from howtotrainyourmamlpytorch_tpu_torch.core.programs import GraphProgram, clone_tree
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
    from howtotrainyourmamlpytorch_tpu_torch.parallel import make_mesh, replicate, shard_batch, unreplicate
    from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import shard_chunk

    card = torch.device("cuda", 0) if PREWARM_DEVICE == "cuda" else torch.device(PREWARM_DEVICE)
    launches = {"fused_sgd": 0, "fused_sgd_bwd": 0}
    with deterministic_algorithms():
        cfg, system, start = full_width_system(seed)
        mesh = make_mesh(ParallelConfig(dp=PREWARM_MESH_DP), [card] * PREWARM_MESH_DP)
        batches, stacked = _chunk(cfg, seed + 61, PREWARM_MESH_STEPS)
        fu.reset_launch_counts()
        eager, losses = replicate(clone_tree(start), mesh), []
        system.train_step(clone_tree(eager), shard_batch(batches[0], mesh), epoch=0)  # the first dispatch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            eager, out = system.train_step(eager, shard_batch(b, mesh), epoch=0)
            losses.append(out.loss)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        t0 = time.perf_counter()
        graph, (graph_losses, _, _) = system.train_step_multi(replicate(clone_tree(start), mesh),
                                                              shard_chunk(stacked, mesh), 0)
        torch.cuda.synchronize()
        capture_dispatch_s = time.perf_counter() - t0
        for key in launches:
            launches[key] += fu.launch_counts[key]
        fu.reset_launch_counts()
        t0 = time.perf_counter()
        again, (again_losses, _, _) = system.train_step_multi(replicate(clone_tree(start), mesh),
                                                              shard_chunk(stacked, mesh), 0)
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) * 1e3 / PREWARM_MESH_STEPS
        per_replay = {k: n / PREWARM_MESH_STEPS for k, n in fu.replayed_counts.items()}
        for key in launches:
            launches[key] += fu.launch_counts[key]
        fu.reset_launch_counts()
        ev_batches, ev_stacked = _chunk(cfg, seed + 71, 2)
        ev_losses, _ = system.eval_step_multi(graph, shard_chunk(ev_stacked, mesh))
        ev_eager = torch.stack([system.eval_step(graph, shard_batch(b, mesh)).per_task_losses for b in ev_batches])
        torch.cuda.synchronize()
        for key in launches:
            launches[key] += fu.launch_counts[key]
        state_diff = _state_diff(unreplicate(graph), unreplicate(eager))
        loss_diff = float((torch.stack(losses) - graph_losses).abs().max())
        replay_diff = float((graph_losses - again_losses).abs().max())
        eval_diff = float((ev_losses - ev_eager).abs().max())
        program = next(iter(system._train_multi.values()))
        captures = program.captures if isinstance(program, GraphProgram) else []
        del system, program
    K = cfg.number_of_training_steps_per_iter
    capture = captures[0] if captures else None
    out = {"dp": PREWARM_MESH_DP, "steps": PREWARM_MESH_STEPS, "eager_step_ms": eager_ms,
           "replayed_step_ms": replay_ms, "replayed_over_eager": replay_ms / eager_ms,
           "capture_dispatch_s": capture_dispatch_s, "graphs": len(captures),
           "warmup_s": capture and capture.lower_s, "capture_s": capture and capture.compile_s,
           "pool_bytes": capture and capture.memory.get("peak_bytes"),
           "loss_max_abs": loss_diff, "state_max_abs": state_diff, "replay_loss_max_abs": replay_diff,
           "fused_eval_max_abs": eval_diff, "launches_per_replay": per_replay, "launches": launches,
           "losses": graph_losses.tolist()}
    check(loss_diff == 0.0 and state_diff == 0.0 and replay_diff == 0.0, "prewarm",
          "the mesh graph is not bit-equal to the sharded eager steps", **out)
    check(eval_diff == 0.0 and tuple(ev_losses.shape) == (2, cfg.batch_size), "prewarm",
          "the fused eval on the mesh differs from the sharded eval", diff=eval_diff, shape=list(ev_losses.shape))
    want = {"fused_sgd": PREWARM_MESH_DP * K, "fused_sgd_bwd": PREWARM_MESH_DP * K}
    check(len(captures) == 1 and per_replay == want == capture.launches, "prewarm",
          "the mesh program was not one graph launching B1 and B2 dp x K per replay", per_replay=per_replay,
          want=want, graphs=len(captures))
    return out


def prestart_prewarm(seed: int, tmp: str) -> list:
    """Phase ``prewarm``'s three CLI legs, started before phase
    ``programs``: each imports and starts the card (21-25 s) behind its
    gate while the phases before it run."""
    common = ["use_pallas_inner_update=true", "remat_inner_steps=false",
              f"dataset.path={os.path.join(tmp, 'omniglot_dataset')}", f"index_cache_dir={os.path.join(tmp, 'index')}",
              f"experiment_root={os.path.join(tmp, 'prewarm')}", f"seed={seed}", *PREWARM_RUNNER]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    env.pop("HTYMP_FAULTS", None)
    return [_spawn_leg(name, [*common, *extra], env, gate=os.path.join(tmp, f"prewarm_gate_{name}"))
            for name, extra in (
                ("cold", ["experiment_name=prewarm_cold", "aot.enabled=false"]),
                ("prewarmed", ["experiment_name=prewarm_prewarmed", "aot.enabled=true"]),
                ("restart", ["experiment_name=prewarm_prewarmed", "aot.enabled=true", "total_epochs=3"]))]


def phase_prewarm(seed: int, tmp: str, spawned: list):
    """The training-side prewarm and the program layer on a mesh, on phase
    ``runner``'s image folder; see the module docstring. (a) Two fresh CLI
    processes at the default VGG config (fused, remat off) plus
    PREWARM_RUNNER, ``aot.enabled`` off and on, under the deterministic
    algorithms: per-step losses bit-equal, zero guard violations, and in
    the prewarmed leg no build outside ``phase="prewarm"`` but the nvcc
    lines. (b) The prewarmed leg again on its run directory for a third
    epoch: the manifest promises a warm start, every ``nvcc/*`` line is a
    cache hit, and the captures it pays again are printed. (c) The mesh
    (:func:`prewarm_mesh`) runs in this process while the cold and the
    prewarmed legs run beside each other; the restart is released when the
    prewarmed leg has ended. The legs' processes (``spawned``,
    :func:`prestart_prewarm`) imported and started the card during phase
    ``programs``."""
    t_phase = time.perf_counter()
    legs = {}
    try:
        first = [leg for leg in spawned if leg["name"] != "restart"]
        restart = next(leg for leg in spawned if leg["name"] == "restart")
        for leg in first:
            _release_leg(leg)
        t_mesh = time.perf_counter()
        mesh = prewarm_mesh(seed)
        mesh_s = time.perf_counter() - t_mesh
        for leg in first:
            legs[leg["name"]] = _finish_leg(leg)
        _release_leg(restart)
        legs["restart"] = _finish_leg(restart)
    finally:
        for leg in spawned:
            _stop_leg(leg)
    cold, warm, restart = legs["cold"], legs["prewarmed"], legs["restart"]
    for name, leg in legs.items():
        violations = (leg["guard"] or {}).get("violations")
        check(violations == [] and (leg["guard"] or {}).get("prewarmed") == (name != "cold"), "prewarm",
              f"leg {name}: the strict guard", guard=leg["guard"])
        check(all(_finite(x) for x in leg["losses"]) and len(leg["losses"]) == 3 * len(leg["epochs"]), "prewarm",
              f"leg {name}: the losses", losses=leg["losses"], epochs=leg["epochs"])
    check(cold["losses"] == warm["losses"] and cold["epochs"] == warm["epochs"] == [0, 1], "prewarm",
          "the prewarmed leg's per-step losses are not bit-equal to the cold leg's", cold=cold["losses"],
          prewarmed=warm["losses"])
    outside = [(e["program"], e.get("phase")) for e in warm["entries"]
               if not e["program"].startswith("nvcc/") and e.get("phase") != "prewarm"]
    check(not outside and (warm["prewarm"] or {}).get("errors") == 0, "prewarm",
          "the prewarmed leg built a program outside the prewarm (or the prewarm failed)", outside=outside,
          prewarm=warm["prewarm"])
    nvcc = [e for e in restart["entries"] if e["program"].startswith("nvcc/")]
    check(restart["manifest_events"] and restart["manifest_events"][-1]["expected_warm"] is True
          and nvcc and all((e.get("persistent_cache") or {}).get("hit") for e in nvcc) and restart["epochs"] == [2],
          "prewarm", "the restart: the manifest's promise, the kernels' cache hits, the third epoch",
          manifest=restart["manifest_events"], nvcc=[(e["program"], e.get("persistent_cache")) for e in nvcc],
          epochs=restart["epochs"])
    manifest_path = os.path.join(warm["run_dir"], "saved_models", "prewarm_manifest.json")
    with open(manifest_path) as f:
        programs = json.load(f)["programs"]
    launches = {k: sum(leg["launches"].get(k, 0) for leg in legs.values()) for k in ("fused_sgd", "fused_sgd_bwd")}
    seconds = time.perf_counter() - t_phase
    pools = lambda leg: [c["pool_bytes"] for c in leg["captures"] if c["pool_bytes"]]  # noqa: E731
    summary = {name: {k: leg[k] for k in ("wall_s", "released_to_exit_s", "timeline", "run_phases_s", "cold_start_s",
                                          "epoch0_first_ms",
                                          "flip_ms", "dispatch_ms",
                                          "prewarm", "manifest_events", "ledger_by_phase", "captures", "guard",
                                          "launches", "val_losses")}
               for name, leg in legs.items()}
    result = {"phase": "prewarm", "ok": True, "config": "configs/default.yaml " + " ".join(PREWARM_RUNNER),
              "legs": summary, "losses": warm["losses"], "losses_bit_equal": True,
              "cold_start_prewarmed_minus_cold_s": warm["cold_start_s"] - cold["cold_start_s"],
              "flip_ms": {"cold": cold["flip_ms"], "prewarmed": warm["flip_ms"]},
              "prewarm_program_seconds": {name: row.get("seconds") for name, row in sorted(programs.items())},
              "pool_bytes_max": {name: max(pools(leg), default=None) for name, leg in legs.items()},
              "restart_captures": restart["captures"], "mesh": mesh, "mesh_s": mesh_s,
              "launches": launches, "launches_mesh": mesh["launches"],
              "seconds": round(seconds, 1), "budget_s": PREWARM_BUDGET_S}
    emit(result)
    return result


# phase diagnostics: the card-against-CPU tools on phase runner's run
# directory and image folder. The CPU half of the precision probe (its
# save at CROSS_TASKS tasks) and of the autopsy (one checkpoint) run in the
# CPU twin (see TWIN_JOBS), the autopsy on DIAG_CPU_THREADS threads; the
# sweep's selected job in a gated process started before phase programs.
DIAG_DEVICE = "cuda"
DIAG_BUDGET_S = 60.0
DIAG_CPU_THREADS = 1
DIAG_FUSED = ["--override", "use_pallas_inner_update=true"]
DIAG_PRECISION = ["20", "--k-shot", "5", "--batch-size", str(CROSS_TASKS), "--learnable", *DIAG_FUSED]
DIAG_EVAL_BATCHES = 2  # validation batches per checkpoint of the autopsy
DIAG_CPU_CHECKPOINT = "0"  # the checkpoint the CPU also evaluates, and the replay starts from
DIAG_REPLAY_STEPS = 2
DIAG_DESCENT = ["20", "6", "0", "2"]  # N_WAY STEPS UNROLL N_BATCHES: the JAX script's 1-shot, meta-batch 4
DIAG_DONATION = ["3", "20", "5", "8"]  # N_STEPS N_WAY K_SHOT BATCH_SIZE
DIAG_IMAGENET = {"classes": 32, "per_class": 20, "assembly_batches": 10, "steps": 2}
# the autopsy's card and CPU accuracies on one checkpoint: a fault of the
# card's execution moves them far apart; float32 noise flips a few of the
# 320 predictions
DIAG_ACCURACY_GAP = 0.05
SWEEP_JOB = 0  # omniglot.5.1.vgg.gd.0


# The CPU twin: one process, started after phase device, runs the CPU
# halves of the card-against-CPU checks of phases slice, train and
# strategies (TWIN_JOBS, on TWIN_THREADS threads) while the card runs the
# phases up to fleet (phase cross and phase strategies compare them), then
# phase diagnostics' precision save; then, once
# release_cpu_twin writes its gate, the diagnostics' CPU autopsy on
# DIAG_CPU_THREADS threads. Each job writes its result (a pickle) and then
# a status file. (argv: one JSON object)
TWIN_JOBS = ("slice", "train", "strategies")
TWIN_THREADS = 3
TWIN_WAIT_S = 300.0
_CPU_TWIN = r"""
import json, os, pickle, sys, time
parent = os.getppid()
spec = json.loads(sys.argv[1])
import torch
torch.set_num_threads(spec["threads"])
import chip_smoke
from howtotrainyourmamlpytorch_tpu_torch.scripts import checkpoint_autopsy, grad_precision_probe


def done(name, rc, t0, result=None):
    if result is not None:
        with open(spec[name] + ".pkl", "wb") as f:
            pickle.dump(result, f)
    with open(spec[name] + ".tmp", "w") as f:
        json.dump({"rc": rc, "seconds": time.perf_counter() - t0}, f)
    os.replace(spec[name] + ".tmp", spec[name])


for name in spec["jobs"]:
    t0 = time.perf_counter()
    done(name, 0, t0, chip_smoke.twin_job(name, spec["seed"]))
t0 = time.perf_counter()
done("saved", grad_precision_probe.main(spec["save"]), t0)
torch.set_num_threads(spec["autopsy_threads"])
while not os.path.exists(spec["gate"]):
    if os.getppid() != parent:
        sys.exit(3)
    time.sleep(0.05)
with open(spec["gate"]) as f:
    argv = json.load(f)
t0 = time.perf_counter()
done("autopsied", checkpoint_autopsy.main(argv), t0)
"""


#: the phases a second process on the card runs in two batches: the first
#: beside phases http and tenancy, the second beside phase runner (phases
#: whose card mostly waits on processes, sockets and the loader, and which
#: have no time budget of their own); this process waits for each batch to
#: end before the phase after that window (fleet, elastic: budgeted). Side
#: phases are card-bound, gate no time and need nothing the phases before
#: them make. Their seconds are their own; the run's total is its wall time.
SIDE_BATCHES = (("small", "resnet"), ("remat", "breadth", "precision"))
SIDE_PHASES = tuple(name for batch in SIDE_BATCHES for name in batch)
SIDE_WAIT_S = 600.0
_SIDE = r"""
import json, sys
spec = json.loads(sys.argv[1])
import torch
import chip_smoke
spec["remat_hook_s"] = chip_smoke.side_ready()
sys.exit(chip_smoke.side_main(spec))
"""


def side_ready() -> float:
    """The side process's card start, before its first gate: the precision
    main sets, the card, and the g++ build of the selective remat
    policies' dispatch hook (``csrc/remat_dots.cpp``, host C++; phase
    ``remat`` runs here) -> the hook's seconds."""
    from howtotrainyourmamlpytorch_tpu_torch.core import remat
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import apply_matmul_precision

    apply_matmul_precision("highest")
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    t0 = time.perf_counter()
    remat.dot_hook()
    return time.perf_counter() - t0


def _write_json(path: str, obj) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def side_main(spec: dict) -> int:
    """Run SIDE_BATCHES, each after its gate file appears (an orphan
    exits); each batch's end is marked in ``spec["done"][i]``. The phase
    lines go to this process's stdout, the results and seconds (or the
    check that failed) to ``spec["result"]``."""
    parent = os.getppid()
    phases = {"small": phase_small, "resnet": phase_resnet, "remat": phase_remat, "breadth": phase_breadth,
              "precision": phase_precision}
    results, seconds, failed = {}, {}, None
    for batch, gate, done in zip(SIDE_BATCHES, spec["gates"], spec["done"]):
        while not os.path.exists(gate):
            if os.getppid() != parent:
                return 3
            time.sleep(0.05)
        try:
            for name in batch:
                t0 = time.monotonic()
                results[name] = phases[name](spec["seed"])
                seconds[name] = round(time.monotonic() - t0, 1)
                print(f"chip_smoke: phase {name} took {seconds[name]} s (side process)", file=sys.stderr, flush=True)
        except CheckFailed as exc:
            failed = str(exc)
        _write_json(done, {"failed": failed})
        if failed:
            break
    _write_json(spec["result"], {"results": results, "seconds": seconds, "failed": failed,
                                 "remat_hook_s": spec["remat_hook_s"]})
    return 0 if failed is None else 1


def prestart_side(seed: int, tmp: str) -> dict:
    """Start the side process (:data:`_SIDE`): its imports and card start
    overlap the phases before ``http``."""
    root = os.path.dirname(os.path.abspath(__file__))
    spec = {"seed": seed, "result": os.path.join(tmp, "side.json"), "stdout": os.path.join(tmp, "side.out"),
            "gates": [os.path.join(tmp, f"side{i}.gate") for i in range(len(SIDE_BATCHES))],
            "done": [os.path.join(tmp, f"side{i}.done") for i in range(len(SIDE_BATCHES))]}
    out = open(spec["stdout"], "w")
    proc = subprocess.Popen([sys.executable, "-c", _SIDE, json.dumps(spec)], cwd=root, stdout=out,
                            env=dict(os.environ, PYTHONPATH=root))
    out.close()
    return {**spec, "proc": proc, "waited_s": []}


def release_side(side: dict, batch: int) -> None:
    open(side["gates"][batch], "w").close()


def wait_side(side: dict, batch: int) -> None:
    """Wait for the side process's ``batch`` to end (its seconds waited
    are noted); a batch that failed fails the run here."""
    t0 = time.monotonic()
    done = side["done"][batch]
    while not os.path.exists(done) and side["proc"].poll() is None:
        check(time.monotonic() - t0 < SIDE_WAIT_S, "side", f"batch {batch} of the side process did not end",
              timeout_s=SIDE_WAIT_S)
        time.sleep(0.05)
    side["waited_s"].append(round(time.monotonic() - t0, 1))
    failed = None
    if os.path.exists(done):
        with open(done) as f:
            failed = json.load(f)["failed"]
    if failed or not os.path.exists(done):
        finish_side(side)


def finish_side(side: dict) -> tuple:
    """Wait for the side process to exit: its phase lines onto this
    stdout, then (results, seconds, what the timing line reports). Fails
    the run where a side phase failed."""
    try:
        rc = side["proc"].wait(timeout=SIDE_WAIT_S)
    except subprocess.TimeoutExpired:
        rc = None
    with open(side["stdout"]) as f:
        for line in f:
            print(line, end="", flush=True)
    got = {}
    if os.path.exists(side["result"]):
        with open(side["result"]) as f:
            got = json.load(f)
    if got.get("failed"):
        raise CheckFailed(got["failed"])
    check(rc == 0 and set(got.get("results", {})) == set(SIDE_PHASES), "side", "the side process failed", rc=rc,
          phases=sorted(got.get("results", {})))
    return got["results"], got["seconds"], {"waited_s": side["waited_s"], "remat_hook_s": got["remat_hook_s"]}


def twin_job(name: str, seed: int) -> dict:
    """One job of TWIN_JOBS, in the CPU twin -> its result."""
    if name == "slice":
        return slice_cpu(seed)
    return cross_check_twin(seed, ["strategy=anil"] if name == "strategies" else [])


def prestart_cpu_twin(seed: int, tmp: str) -> dict:
    """Start the CPU twin (:data:`_CPU_TWIN`) after phase ``device``."""
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(tmp, "diagnostics")
    os.makedirs(work, exist_ok=True)
    spec = {"seed": seed, "jobs": list(TWIN_JOBS), "threads": TWIN_THREADS, "autopsy_threads": DIAG_CPU_THREADS,
            **{name: os.path.join(work, f"twin_{name}.json") for name in TWIN_JOBS},
            "saved": os.path.join(work, "saved.json"), "autopsied": os.path.join(work, "autopsied.json"),
            "gate": os.path.join(work, "cpu_autopsy.gate"), "npz": os.path.join(work, "grads_cpu.npz"),
            "autopsy_json": os.path.join(work, "autopsy_cpu.json"), "log": os.path.join(work, "cpu.log")}
    spec["save"] = ["save", spec["npz"], *DIAG_PRECISION, "--device", "cpu"]
    log = open(spec["log"], "ab")
    proc = subprocess.Popen([sys.executable, "-c", _CPU_TWIN, json.dumps(spec)], cwd=root, stdout=log,
                            stderr=subprocess.STDOUT,
                            env=dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS=str(TWIN_THREADS)))
    log.close()
    return {**spec, "proc": proc}


def release_cpu_twin(pre: dict, runner: dict) -> None:
    """Hand the CPU twin the autopsy of phase runner's checkpoint
    DIAG_CPU_CHECKPOINT (it runs during the phases after runner)."""
    argv = [runner["run_dir"], DIAG_CPU_CHECKPOINT, "--index-cache-dir", runner["index_cache_dir"],
            "--eval-batches", str(DIAG_EVAL_BATCHES), "--device", "cpu", "--json", pre["autopsy_json"]]
    with open(pre["gate"] + ".tmp", "w") as f:
        json.dump(argv, f)
    os.replace(pre["gate"] + ".tmp", pre["gate"])


def _wait_status(path: str, proc, timeout_s: float, what: str, phase: str = "diagnostics", log=None) -> dict:
    t0 = time.perf_counter()

    def tail():
        if log is None or not os.path.exists(log):
            return ""
        with open(log, "rb") as f:
            return f.read()[-3000:].decode(errors="replace")

    while not os.path.exists(path):
        if proc.poll() is not None or time.perf_counter() - t0 >= timeout_s:
            check(False, phase, what, rc=proc.poll(), waited_s=time.perf_counter() - t0, log_tail=tail())
        time.sleep(0.05)
    with open(path) as f:
        status = json.load(f)
    check(status["rc"] == 0, phase, what, status=status, log_tail=tail())
    return {**status, "waited_s": time.perf_counter() - t0}


def twin_result(twin: dict, name: str, phase: str) -> dict:
    """The CPU twin's result of job ``name`` (waiting for it), with
    ``waited_s``: the seconds this process waited."""
    status = _wait_status(twin[name], twin["proc"], TWIN_WAIT_S, f"the CPU twin's {name} half", phase, twin["log"])
    with open(twin[name] + ".pkl", "rb") as f:
        return dict(pickle.load(f), waited_s=status["waited_s"])


def sweep_job_overrides(tmp: str) -> list:
    """The selected job on phase runner's folder and index, 1 epoch of 1
    step, one evaluation batch, images from disk, the fused update."""
    return [f"dataset.path={os.path.join(tmp, 'omniglot_dataset')}", f"index_cache_dir={os.path.join(tmp, 'index')}",
            f"experiment_root={os.path.join(tmp, 'sweep')}", "total_epochs=1", "total_iter_per_epoch=1",
            f"num_evaluation_tasks={TASKS}", "load_into_memory=false", "use_pallas_inner_update=true"]


def prestart_sweep_job(tmp: str) -> "GatedCli":
    """The sweep launcher's job SWEEP_JOB (``launch_all --select``, run in
    its process with ``--in-process``) started before phase ``programs``
    behind a gate, released before phase ``prewarm``: it runs beside that
    phase, and phase ``diagnostics`` reads its run."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    env.pop("HTYMP_FAULTS", None)
    return GatedCli(["--select", str(SWEEP_JOB), "--in-process", "--device", DIAG_DEVICE, *sweep_job_overrides(tmp)],
                    env, os.path.join(tmp, "sweep.gate"), main_module="howtotrainyourmamlpytorch_tpu_torch.launch_all")


def phase_diagnostics(seed: int, tmp: str, runner: dict, cpu: dict, sweep: "GatedCli"):
    """The card-against-CPU diagnostics, the sweep and the data path at
    scale, each through its tool's ``main(argv)`` in this process (its
    printed tables to a log), on phase ``runner``'s run directory and image
    folder: the precision probe's ``compare`` of the card's meta-gradient
    (20-way 5-shot at CROSS_TASKS tasks, the class-structured batch) under
    ``highest`` and ``high`` against the CPU's ``save`` (whole-vector
    cosine under ``highest`` >= GRAD_COSINE, ``high``'s reported); the
    autopsy of every checkpoint on the card (finite, the statistics of the
    Adam moments present) and of DIAG_CPU_CHECKPOINT on the CPU (the
    accuracies within DIAG_ACCURACY_GAP); the stream replay on the card
    from checkpoint DIAG_CPU_CHECKPOINT for DIAG_REPLAY_STEPS steps, whose
    batch digests must equal those of the batches the runner consumed after
    it (its losses reported beside the runner's); the descent probe on the
    folder (its loss falls: the end mean below the first two steps');
    the donation probe's A/B (``clean``); ``imagenet_at_scale`` at 84x84x3
    with ResNet-12 5-way 5-shot on a tree of DIAG_IMAGENET's size; the
    sweep launcher's ``--dry-run`` (the 324 jobs of ``launch_all.jobs()``)
    and job SWEEP_JOB run on the card (rc 0, its run directory), then
    ``summarize_run`` on it. B1 and B2 launch the counts each tool's steps
    imply. Under DIAG_BUDGET_S (checked after ``timing``). ``sweep`` may be
    released already (``main`` releases it before phase ``prewarm``)."""
    import contextlib
    import io

    from howtotrainyourmamlpytorch_tpu_torch import launch_all
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import apply_matmul_precision
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
    from howtotrainyourmamlpytorch_tpu_torch.scripts import (checkpoint_autopsy, descent_probe, donation_probe,
                                                             grad_precision_probe, imagenet_at_scale,
                                                             stream_replay_probe, summarize_run)

    t_phase = time.perf_counter()
    if sweep.t0 is None:
        sweep.release()
    work = os.path.join(tmp, "diagnostics")
    run_dir, index = runner["run_dir"], runner["index_cache_dir"]
    K = 5  # every tool's config: number_of_training_steps_per_iter and _evaluation_
    tools, launches = {}, {}
    log = open(os.path.join(work, "tools.log"), "w")

    def run(name, module, argv, want):
        """``module.main(argv)`` with its report at ``work/name.json`` ->
        the report; B1/B2 launches against ``want``."""
        path = os.path.join(work, f"{name}.json")
        fu.reset_launch_counts()  # this tool's path starts here
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = module.main([*argv, "--json" if module is not imagenet_at_scale else "--out", path])
        seconds = time.perf_counter() - t0
        got = dict(fu.launch_counts)  # and ends here
        check(rc == 0, "diagnostics", f"{name} exited {rc}")
        check(got == want, "diagnostics", f"{name}'s kernel launches", launches=got, want=want)
        launches[name] = got
        with open(path) as f:
            report = json.load(f)
        tools[name] = {"seconds": seconds, "launches": got}
        return report

    # the precision probe against the CPU's save (2 meta-gradients under
    # remat full: B1 2K, B2 K each)
    saved = _wait_status(cpu["saved"], cpu["proc"], TWIN_WAIT_S, "the CPU save of the precision probe",
                         log=cpu["log"])
    try:
        prec = run("grad_precision_probe", grad_precision_probe,
                   ["compare", cpu["npz"], *DIAG_PRECISION, "--precision", "highest", "high"],
                   {"fused_sgd": 2 * 2 * K, "fused_sgd_bwd": 2 * K})
    finally:
        apply_matmul_precision("highest")
    cosines = {p: {"global": a["global_cosine"], "worst_tensor": a["worst_cosine"]} for p, a in prec["arms"].items()}
    check(cosines["highest"]["global"] >= GRAD_COSINE, "diagnostics", "the card's meta-gradient against the CPU's",
          cosines=cosines, bound=GRAD_COSINE)
    tools["grad_precision_probe"].update(cosines=cosines, cpu_save_s=saved["seconds"], waited_s=saved["waited_s"])

    # the autopsy of every checkpoint on the card (K eval steps per batch)
    names = [str(e) for e in sorted(int(n.split("_")[-1]) for n in os.listdir(os.path.join(run_dir, "saved_models"))
                                    if n.split("_")[-1].isdigit())] + ["best"]
    aut = run("checkpoint_autopsy", checkpoint_autopsy,
              [run_dir, "--index-cache-dir", index, "--eval-batches", str(DIAG_EVAL_BATCHES)],
              {"fused_sgd": len(names) * DIAG_EVAL_BATCHES * K, "fused_sgd_bwd": 0})
    card_evals = {idx: e["eval"]["card"] for idx, e in aut["checkpoints"].items()}
    check(sorted(aut["checkpoints"]) == sorted(names) and all(_finite(e["loss"]) for e in card_evals.values()),
          "diagnostics", "the autopsy's checkpoints", names=sorted(aut["checkpoints"]), evals=card_evals)
    check(all(any(r["norm"] > 0 for r in e["stats"]["outer adam nu"]) for e in aut["checkpoints"].values()),
          "diagnostics", "the autopsy read no Adam moments")
    tools["checkpoint_autopsy"]["evals"] = card_evals

    # the stream replay from the runner's epoch-0 checkpoint (remat off: K
    # of each per step)
    rep = run("stream_replay_probe", stream_replay_probe,
              [run_dir, DIAG_CPU_CHECKPOINT, str(DIAG_REPLAY_STEPS), "1", "--index-cache-dir", index],
              {"fused_sgd": DIAG_REPLAY_STEPS * K, "fused_sgd_bwd": DIAG_REPLAY_STEPS * K})
    digests = [st["digest"] for st in rep["steps"]]
    check(digests == runner["epoch1_batches"][:DIAG_REPLAY_STEPS], "diagnostics",
          "the replay did not see the batches the runner consumed", replay=[d[:16] for d in digests],
          runner=[d[:16] for d in runner["epoch1_batches"]])
    replay_losses = [st["loss"] for st in rep["steps"]]
    check(_finite(*replay_losses), "diagnostics", "non-finite replay loss", losses=replay_losses)
    tools["stream_replay_probe"].update(cursor=rep["cursor"], losses=replay_losses,
                                        runner_losses=runner["epoch1_losses"][:DIAG_REPLAY_STEPS])

    # the descent probe (remat off: K of each per step, and per end batch)
    n_batches, steps = int(DIAG_DESCENT[3]), int(DIAG_DESCENT[1])
    des = run("descent_probe", descent_probe,
              ["0", *DIAG_DESCENT, "--dataset-path", os.path.join(tmp, "omniglot_dataset"), "--index-cache-dir",
               index, *DIAG_FUSED],
              {"fused_sgd": (steps + n_batches) * K, "fused_sgd_bwd": (steps + n_batches) * K})
    first = statistics.mean(st["loss"] for st in des["steps"][:n_batches])
    end = statistics.mean(f["loss"] for f in des["final"])
    check(end < first, "diagnostics", "the descent probe did not descend", first=first, end=end)
    tools["descent_probe"].update(first_loss_mean=first, end_loss_mean=end,
                                  end_accuracy_mean=statistics.mean(f["accuracy"] for f in des["final"]))

    # the donation probe: two arms of N steps (remat off; each arm steps
    # under the deterministic algorithms, observability/donation.py)
    don = run("donation_probe", donation_probe, [*DIAG_DONATION, *DIAG_FUSED],
              {"fused_sgd": 2 * int(DIAG_DONATION[0]) * K, "fused_sgd_bwd": 2 * int(DIAG_DONATION[0]) * K})
    check(don["verdict"] == "clean", "diagnostics", "the donation probe's verdict", result=don)
    tools["donation_probe"].update({k: don[k] for k in ("verdict", "max_loss_dev", "global_param_rel")})

    # the Mini-ImageNet data path with 2 ResNet-12 steps (remat full: B1 2K)
    d = DIAG_IMAGENET
    img = run("imagenet_at_scale", imagenet_at_scale,
              ["--root", os.path.join(work, "mini_imagenet"), "--classes", str(d["classes"]), "--per-class",
               str(d["per_class"]), "--assembly-batches", str(d["assembly_batches"]), "--steps", str(d["steps"]),
               "--net", "resnet-12", *DIAG_FUSED],
              {"fused_sgd": d["steps"] * 2 * K, "fused_sgd_bwd": d["steps"] * K})
    check(img["ram_cache_images"] == d["classes"] * d["per_class"] and img["ram_cache_classes"] == img["split"]
          and img["episode_shapes"]["x_support"] == [8, 5, 5, 84, 84, 3] and img["meta_steps"]["finite"]
          and img["loader_stats"]["numpy_batches"] == 0, "diagnostics", "the Mini-ImageNet data path", report=img)
    tools["imagenet_at_scale"].update(stages=img["stages"], meta_steps=img["meta_steps"],
                                      episodes_per_s=img["assembly_episodes_per_s"])

    # the sweep: the dry run's grid, then the selected job and its row
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(launch_all.main(["--dry-run"]) == 0, "diagnostics", "the sweep's dry run")
    listed = [line.split(": ")[0].split("] ")[1] for line in buf.getvalue().splitlines()]
    check(listed == [name for name, _ in launch_all.jobs()] and len(listed) == 324, "diagnostics",
          "the sweep's dry run lists other jobs", listed=len(listed))
    t0 = time.perf_counter()
    try:
        sweep.proc.wait(timeout=300)
    finally:
        sweep.stop()
    rc, _, stdout, stderr = sweep.result(timeout=LEG_EXIT_WAIT_S)
    job_name = listed[SWEEP_JOB]
    job_dir = os.path.join(tmp, "sweep", job_name)
    check(rc == 0 and os.path.exists(os.path.join(job_dir, "logs", "test_summary.csv")), "diagnostics",
          "the sweep's selected job", rc=rc, tail=(stdout[-2000:], stderr[-2000:]))
    row = summarize_run.row(job_dir)
    check(row.startswith(f"| {job_name} |") and "%" in row, "diagnostics", "summarize_run's row", row=row)
    tools["sweep"] = {"jobs": len(listed), "selected": job_name, "waited_s": time.perf_counter() - t0, "row": row}

    # the CPU autopsy of one checkpoint, beside the card's
    autopsied = _wait_status(cpu["autopsied"], cpu["proc"], TWIN_WAIT_S, "the CPU autopsy", log=cpu["log"])
    with open(cpu["autopsy_json"]) as f:
        cpu_eval = json.load(f)["checkpoints"][DIAG_CPU_CHECKPOINT]["eval"]["cpu"]
    card_eval = card_evals[DIAG_CPU_CHECKPOINT]
    gap = abs(cpu_eval["accuracy"] - card_eval["accuracy"])
    check(_finite(cpu_eval["loss"]) and gap <= DIAG_ACCURACY_GAP, "diagnostics",
          "the checkpoint's CPU and card evaluations disagree", cpu=cpu_eval, card=card_eval)
    tools["cpu_autopsy"] = {"checkpoint": DIAG_CPU_CHECKPOINT, "cpu": cpu_eval, "card": card_eval, "accuracy_gap": gap,
                            "cpu_s": autopsied["seconds"], "waited_s": autopsied["waited_s"]}
    log.close()
    total = {name: sum(t[name] for t in launches.values()) for name in ("fused_sgd", "fused_sgd_bwd")}
    result = {"phase": "diagnostics", "ok": True, "tools": tools, "launches": total,
              "seconds": round(time.perf_counter() - t_phase, 1), "budget_s": DIAG_BUDGET_S}
    emit(result)
    return result


#: phase bench: the port's two measurement entry points (``python -m
#: howtotrainyourmamlpytorch_tpu_torch.bench`` / ``.bench_serving``) as
#: child processes on the card at the smoke's small counts, started before
#: the phases in BENCH_BESIDE (their card mostly waits on processes and
#: sockets) and collected after them; a third trainer child gets a SIGTERM
#: once its stage after ``measure`` begins and must salvage its headline.
#: The full-count lines are measured on their own (PERF.md, section 5).
BENCH_BESIDE = ("http", "tenancy")
BENCH_BUDGET_S = 180.0
BENCH_TRAIN_ENV = {"BENCH_MEASURE_ITERS": "6", "BENCH_PHASE_ITERS": "4", "BENCH_STEPS_PER_DISPATCH": "3",
                   "BENCH_TRACE_ITERS": "2", "BENCH_B16": "1"}
BENCH_SERVING_ARGS = ("--adapt-reps", "4", "--predict-reps", "16")
BENCH_SERVING_ENV = {"BENCH_SLO_DURATION_S": "3", "BENCH_REFINE": "2", "BENCH_TENANTS": "2"}
BENCH_SIGTERM_STAGE = "phase-breakdown"
#: the JAX scripts' report keys (tests/test_torch_bench.py and
#: tests/test_torch_bench_serving.py hold these sets against the JAX
#: scripts' own lines); the serving line's at the tiny engine with no
#: staircase and no refine, then what BENCH_SERVING_ENV's arms add
BENCH_KEYS = frozenset({
    "metric", "value", "unit", "vs_baseline", "platform", "matmul_precision", "conv_via_patches",
    "precision", "remat_policy", "strategy", "cold_start_s", "steps_per_dispatch",
    "steps_per_sec_single_dispatch", "phase_breakdown", "steps_per_sec_multi_dispatch", "multi_dispatch_error",
    "bytes_accessed_per_step", "flops_per_step", "flops_source", "peak_flops_per_sec", "mfu", "breakdown",
    "prewarm", "peak_program_bytes", "donated_bytes", "b16_steps_per_sec", "b16_tasks_per_sec_ratio",
})
BENCH_SERVING_KEYS = frozenset({
    "metric", "value", "unit", "vs_baseline", "platform", "adapt_p50_ms", "adapt_p95_ms", "cached_predict_p50_ms",
    "cached_predict_p95_ms", "strategy", "predict_p50_ms", "n_way", "k_shot", "n_query", "micro_batch", "model",
    "precision", "compiled", "phase_breakdown", "compile_tax_s", "remat_policy", "peak_program_bytes",
    "donated_bytes", "cold_start_s", "prewarm", "predict_flops_per_query", "sustained_rps", "replicas", "tenants",
    "page_in_p50_ms", "tenant_evictions", "scale_up_settle_s", "surge_recovery_s", "mfu",
})
BENCH_SERVING_ARM_KEYS = frozenset({"slo_breaker_trips", "refine_reps", "refine_p50_ms", "refine_p95_ms",
                                    "rollbacks"})
BENCH_WAIT_S = 300.0
#: the trainer child: the module's main, then the fused update's launch
#: counts to a file (the JAX script's line has no such key)
_BENCH_TRAIN = r"""
import json, sys
from howtotrainyourmamlpytorch_tpu_torch import bench
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update
bench.main([])
with open(sys.argv[1], "w") as f:
    json.dump(fused_update.launch_counts, f)
"""


def start_bench(tmp: str) -> dict:
    """Start phase ``bench``'s three children (their output to files under
    ``tmp``) and a thread that notes when each ends and sends the third
    its SIGTERM once it enters BENCH_SIGTERM_STAGE."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    counts = os.path.join(tmp, "bench_launches.json")
    t0 = time.monotonic()

    def spawn(name, argv, extra):
        paths = {"out": os.path.join(tmp, f"{name}.out"), "err": os.path.join(tmp, f"{name}.err")}
        with open(paths["out"], "w") as out, open(paths["err"], "w") as err:
            proc = subprocess.Popen([sys.executable, *argv], cwd=root, stdout=out, stderr=err, env={**env, **extra})
        return {"name": name, "proc": proc, **paths, "end_s": None}

    children = [
        spawn("bench", ["-c", _BENCH_TRAIN, counts], BENCH_TRAIN_ENV),
        spawn("bench_serving", ["-m", "howtotrainyourmamlpytorch_tpu_torch.bench_serving", *BENCH_SERVING_ARGS],
              BENCH_SERVING_ENV),
        spawn("bench_sigterm", ["-m", "howtotrainyourmamlpytorch_tpu_torch.bench"], BENCH_TRAIN_ENV),
    ]
    pre = {"children": children, "t0": t0, "counts": counts, "sigterm_s": None}

    def watch():
        marker = f"bench: stage {BENCH_SIGTERM_STAGE} "
        target = children[2]
        while any(c["end_s"] is None for c in children):
            for child in children:
                if child["end_s"] is None and child["proc"].poll() is not None:
                    child["end_s"] = round(time.monotonic() - t0, 1)
            if pre["sigterm_s"] is None and target["end_s"] is None:
                with open(target["err"]) as f:
                    if marker in f.read():
                        target["proc"].send_signal(signal.SIGTERM)
                        pre["sigterm_s"] = round(time.monotonic() - t0, 1)
            if time.monotonic() - t0 > BENCH_WAIT_S:
                return
            time.sleep(0.1)

    pre["watcher"] = threading.Thread(target=watch, daemon=True)
    pre["watcher"].start()
    return pre


def _tail(path: str, n: int = 15) -> list:
    with open(path) as f:
        return [line for line in f.read().splitlines() if not line.startswith("USDT")][-n:]


def _bench_line(child: dict) -> dict:
    """The child's one JSON line (rc 0, one stdout line)."""
    with open(child["out"]) as f:
        lines = f.read().strip().splitlines()
    rc = child["proc"].returncode
    check(rc == 0 and len(lines) == 1, "bench", f"{child['name']} did not print one line with rc 0", rc=rc,
          stdout=[line[:300] for line in lines[-3:]], stderr=_tail(child["err"]))
    return json.loads(lines[0])


def phase_bench(pre: dict) -> dict:
    """Collect phase ``bench``'s children (:func:`start_bench`) and check
    their lines: the JAX scripts' keys, a positive headline, the card named,
    ``mfu`` and the multi-step arm measured, the serving programs built by
    the prewarm alone, B1/B2 not launched (the recipes keep the fused
    update off, as the JAX scripts do), and the SIGTERM child's salvaged
    headline. -> the phase's seconds and launches."""
    t_wait = time.monotonic()
    pre["watcher"].join(timeout=max(1.0, BENCH_WAIT_S - (t_wait - pre["t0"])))
    for child in pre["children"]:
        if child["proc"].poll() is None:
            child["proc"].kill()
            child["proc"].wait()
        check(child["end_s"] is not None, "bench", f"{child['name']} did not end", timeout_s=BENCH_WAIT_S,
              stderr=_tail(child["err"]))
    waited_s = round(time.monotonic() - t_wait, 1)
    train_child, serving_child, sigterm_child = pre["children"]
    card = f"gpu:{torch.cuda.get_device_name(0)}"

    train = _bench_line(train_child)
    with open(pre["counts"]) as f:
        train_launches = json.load(f)
    stages = [line.split()[2] for line in _tail(train_child["err"], 10_000) if line.startswith("bench: stage ")]
    emit({"phase": "bench", "module": "howtotrainyourmamlpytorch_tpu_torch.bench", "env": BENCH_TRAIN_ENV,
          "seconds": train_child["end_s"], "stages": stages,
          "headline": {k: train[k] for k in ("metric", "value", "unit", "steps_per_dispatch", "mfu", "cold_start_s")},
          "launches": train_launches, "line": train})
    check(set(train) == BENCH_KEYS, "bench", "the trainer's keys are not the JAX script's",
          extra=sorted(set(train) - BENCH_KEYS), missing=sorted(BENCH_KEYS - set(train)))
    check(train["value"] > 0 and train["platform"] == card and train["mfu"] is not None
          and train["steps_per_sec_multi_dispatch"] is not None and train["multi_dispatch_error"] is None
          and train["breakdown"] is not None and train["b16_steps_per_sec"] is not None, "bench",
          "the trainer's line is not measured on the card", platform=train["platform"], mfu=train["mfu"],
          multi=train["steps_per_sec_multi_dispatch"], error=train["multi_dispatch_error"])
    check(train_launches == {"fused_sgd": 0, "fused_sgd_bwd": 0}, "bench",
          "the trainer's recipe launched B1/B2 (the JAX script keeps the fused update off)", launches=train_launches)

    serving = _bench_line(serving_child)
    counts = serving["compiled"]
    shown = {**serving, "compiled": {k: v for k, v in counts.items() if k != "compile_ledger"}}
    emit({"phase": "bench", "module": "howtotrainyourmamlpytorch_tpu_torch.bench_serving",
          "argv": BENCH_SERVING_ARGS, "env": BENCH_SERVING_ENV, "seconds": serving_child["end_s"],
          "stages": sorted(serving["phase_breakdown"]),
          "headline": {k: serving[k] for k in ("metric", "value", "unit", "mfu", "cold_start_s")},
          "launches": {"fused_sgd": counts.get("fused_sgd_launches")}, "line": shown})
    expected = BENCH_SERVING_KEYS | BENCH_SERVING_ARM_KEYS
    check(set(serving) == expected, "bench", "the serving line's keys are not the JAX script's",
          extra=sorted(set(serving) - expected), missing=sorted(expected - set(serving)))
    built = counts["adapt_programs"] + counts["predict_programs"] + counts.get("refine_programs", 0)
    check(serving["value"] > 0 and serving["platform"] == card and serving["mfu"] is not None, "bench",
          "the serving line is not measured on the card", platform=serving["platform"], mfu=serving["mfu"])
    check(built > 0 and built == serving["prewarm"]["programs"] == counts["compile_ledger"]["entries"]
          and "eager_programs" not in counts, "bench", "a serving program was built after the prewarm",
          built=built, prewarm=serving["prewarm"], entries=counts["compile_ledger"]["entries"])
    check(counts["fused_sgd_launches"] == 0, "bench",
          "the serving recipe launched B1 (the JAX script keeps the fused update off)",
          launches=counts["fused_sgd_launches"])

    salvaged = _bench_line(sigterm_child)
    emit({"phase": "bench", "module": "howtotrainyourmamlpytorch_tpu_torch.bench", "sigterm_after_s": pre["sigterm_s"],
          "seconds": sigterm_child["end_s"], "line": salvaged})
    check(pre["sigterm_s"] is not None and "sigterm" in str(salvaged.get("wedged_at"))
          and salvaged.get("value") is not None, "bench", "the SIGTERM child did not salvage its headline",
          wedged_at=salvaged.get("wedged_at"), value=salvaged.get("value"))
    seconds = max(child["end_s"] for child in pre["children"])
    return {"seconds": seconds, "waited_s": waited_s, "sigterm_s": pre["sigterm_s"],
            "launches": {"bench": train_launches, "bench_serving": {"fused_sgd": counts["fused_sgd_launches"]}}}


#: phase lint: the port's static gate over LINT_SCOPE, and its runtime twin
#: on LINT_DEVICE, as two children started beside http and tenancy (phase
#: bench's window) and collected after phase bench
LINT_SCOPE = ("howtotrainyourmamlpytorch_tpu_torch", "chip_smoke.py")
LINT_SUPPRESSION_BUDGET = 20
LINT_BUDGET_S = 180.0
LINT_DEVICE = "cuda"
LINT_CHUNK = 2
#: the twin: lint_sync_record's result (or the check that failed) to a file
_LINT_TWIN = r"""
import json, sys
import chip_smoke
from howtotrainyourmamlpytorch_tpu_torch.core.maml import apply_matmul_precision
apply_matmul_precision("highest")
try:
    result = chip_smoke.lint_sync_record(int(sys.argv[2]))
except chip_smoke.CheckFailed as exc:
    result = {"failed": str(exc)}
with open(sys.argv[1], "w") as f:
    json.dump(result, f)
"""


def _innermost(stack, root: str, package: bool):
    """The innermost frame of ``stack`` ((path, line, function), outermost
    first) in the package (``package``) or anywhere in the repository."""
    for path, line, name in reversed(stack):
        rel = os.path.relpath(path, root)
        if not rel.startswith("..") and (not package or rel.startswith(LINT_SCOPE[0] + os.sep)):
            return rel, line, name
    return None


def lint_sync_record(seed: int) -> dict:
    """Phase ``lint``'s runtime twin of GL101/GL110: the designated hot
    paths driven on LINT_DEVICE under ``set_sync_debug_mode("warn")``,
    every synchronizing call recorded with its Python stack (the thread's
    own: a batcher worker's for the frontend), then held against the
    static gate's view of the same code: hot functions and their
    suppressed GL110 lines (``lint.rules_torch.hot_functions``,
    ``run_lint(..., ["GL110"])``) -> the sync sites by path."""
    import contextlib
    import inspect
    import traceback
    import warnings

    from howtotrainyourmamlpytorch_tpu_torch.lint import rules_torch, run_lint
    from howtotrainyourmamlpytorch_tpu_torch.serving import ServingFrontend
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
    from tools.graftlint.engine import load_project

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    hot = {}
    for mod in load_project([LINT_SCOPE[0]]).modules:
        spans = [(fn.name, fn.lineno, fn.end_lineno) for fn in rules_torch.hot_functions(mod)]
        if spans:
            hot[mod.rel] = spans
    allowed = {(f.path, f.line) for f in run_lint([LINT_SCOPE[0]], ["GL110"])[1]}
    static_s = time.perf_counter() - t0

    records, current = [], {"path": None}

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        records.append({"path": current["path"], "thread": threading.current_thread().name,
                        "capturing": torch.cuda.is_current_stream_capturing(),
                        "stack": [(fr.filename, fr.lineno, fr.name) for fr in traceback.extract_stack()[:-1]]})

    @contextlib.contextmanager
    def recording(path):
        current["path"] = path
        previous = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode(previous)

    cfg, system, state = full_width_system(seed, device=LINT_DEVICE)
    _, stacked = _chunk(cfg, seed, LINT_CHUNK)
    req = slice_requests(cfg, seed)
    with recording("control"):
        control_line = inspect.currentframe().f_lineno + 1
        torch.ones(1, device=LINT_DEVICE).sum().item()
    drive_t0 = time.perf_counter()
    with recording("train_chunk"):
        for _ in range(2):  # the capture, then a replay
            state, (losses, _, _) = system.train_step_multi(state, stacked, 0)
    check(bool(torch.isfinite(losses).all()), "lint", "non-finite losses of the replayed chunk",
          losses=losses.tolist())
    engine = AdaptationEngine(system, state)
    with recording("adapt_flush"):
        for _ in range(2):
            adapted = engine.adapt_batch(req["a"])
    with recording("predict_flush"):
        for _ in range(2):
            probs = engine.predict_batch(list(zip(adapted, req["qa"])))
    _check_probs("lint", "predict_flush", probs, [len(q) for q in req["qa"]], cfg.num_classes_per_set)
    frontend = ServingFrontend(engine)
    try:
        with recording("frontend_dispatch"):
            for (x, y), q in zip(req["b"], req["qb"]):
                answer = frontend.predict(frontend.adapt(x, y)["adaptation_id"], q)
    finally:
        frontend.close()
    _check_probs("lint", "frontend_dispatch", [answer], [len(req["qb"][-1])], cfg.num_classes_per_set)
    drive_s = time.perf_counter() - drive_t0

    by_path, violations, in_capture, unplaced = {}, [], [], {}
    for rec in records:
        site = _innermost(rec["stack"], root, package=True)
        anywhere = _innermost(rec["stack"], root, package=False)
        where = f"{site[0]}:{site[1]} {site[2]}" if site else (f"{anywhere[0]}:{anywhere[1]}" if anywhere else
                                                               "no frame of the repository")
        sites = by_path.setdefault(rec["path"], {})
        sites[where] = sites.get(where, 0) + 1
        if rec["capturing"]:
            in_capture.append({"path": rec["path"], "site": where})
        if anywhere is None:
            unplaced[rec["path"]] = unplaced.get(rec["path"], 0) + 1
        elif site is not None:
            rel = site[0].replace(os.sep, "/")
            inside = [name for name, start, end in hot.get(rel, ()) if start <= site[1] <= end]
            if inside and (rel, site[1]) not in allowed:
                violations.append({"path": rec["path"], "site": where, "hot": inside[0], "thread": rec["thread"]})
    result = {"hot_functions": {rel: [name for name, _, _ in spans] for rel, spans in sorted(hot.items())},
              "allowed": sorted(f"{rel}:{line}" for rel, line in allowed), "syncs": len(records),
              "by_path": by_path, "in_capture": in_capture, "violations": violations, "unplaced": unplaced,
              "control_line": control_line, "static_s": static_s, "drive_s": drive_s,
              "seconds": time.perf_counter() - t0}
    control = by_path.get("control", {})
    check(any(where.startswith(f"chip_smoke.py:{control_line}") for where in control), "lint",
          "the recorder did not see a known .item() at its line", control=control, line=control_line)
    check(not in_capture, "lint", "a synchronizing call inside a capture", in_capture=in_capture)
    check(not violations, "lint", "a sync in a hot function at a line the static gate does not allow",
          violations=violations, allowed=result["allowed"])
    # a sync no Python line names counts against its path's allowed sites:
    # the hot functions the paths drive have none (adapt_batch,
    # predict_batch, EngineReplica.dispatch, the graphs' replays)
    check(not unplaced, "lint", "a sync that names no line of the repository", unplaced=unplaced)
    return result


def start_lint(tmp: str, seed: int) -> dict:
    """Start phase ``lint``'s two children (output under ``tmp``): the
    static gate's CLI and the runtime twin (:data:`_LINT_TWIN`)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    twin_json = os.path.join(tmp, "lint_twin.json")
    t0 = time.monotonic()
    children = []
    for name, argv in (("static", ["-m", "howtotrainyourmamlpytorch_tpu_torch.lint", "--json", *LINT_SCOPE]),
                       ("twin", ["-c", _LINT_TWIN, twin_json, str(seed)])):
        paths = {"out": os.path.join(tmp, f"lint_{name}.out"), "err": os.path.join(tmp, f"lint_{name}.err")}
        with open(paths["out"], "w") as out, open(paths["err"], "w") as err:
            proc = subprocess.Popen([sys.executable, *argv], cwd=root, stdout=out, stderr=err, env=env)
        children.append({"name": name, "proc": proc, **paths, "end_s": None})
    pre = {"children": children, "t0": t0, "twin_json": twin_json}

    def watch():
        while any(c["end_s"] is None for c in children) and time.monotonic() - t0 < LINT_BUDGET_S:
            for child in children:
                if child["end_s"] is None and child["proc"].poll() is not None:
                    child["end_s"] = round(time.monotonic() - t0, 1)
            time.sleep(0.1)

    pre["watcher"] = threading.Thread(target=watch, daemon=True)
    pre["watcher"].start()
    return pre


def phase_lint(pre: dict) -> dict:
    """Collect phase ``lint``'s children (:func:`start_lint`) and check
    them: the static gate clean within its suppression budget, the twin's
    checks passed. -> the phase's seconds."""
    t_wait = time.monotonic()
    pre["watcher"].join(timeout=max(1.0, LINT_BUDGET_S - (t_wait - pre["t0"])))
    for child in pre["children"]:
        if child["proc"].poll() is None:
            child["proc"].kill()
            child["proc"].wait()
        check(child["end_s"] is not None, "lint", f"the {child['name']} child did not end",
              timeout_s=LINT_BUDGET_S, stderr=_tail(child["err"]))
    waited_s = round(time.monotonic() - t_wait, 1)
    static, twin = pre["children"]
    with open(static["out"]) as f:
        text = f.read()
    try:
        payload = json.loads(text)
    except ValueError:
        payload = None
    check(payload is not None and static["proc"].returncode == 0 and payload["findings"] == []
          and len(payload["suppressed"]) <= LINT_SUPPRESSION_BUDGET, "lint", "the static gate is not clean",
          rc=static["proc"].returncode, findings=(payload or {}).get("findings"), stdout=text[-2000:],
          stderr=_tail(static["err"]))
    check(twin["proc"].returncode == 0 and os.path.exists(pre["twin_json"]), "lint", "the runtime twin failed",
          rc=twin["proc"].returncode, stderr=_tail(twin["err"]))
    with open(pre["twin_json"]) as f:
        record = json.load(f)
    check(record.get("failed") is None, "lint", f"the runtime twin: {record.get('failed')}")
    seconds = max(child["end_s"] for child in pre["children"])
    emit({"phase": "lint", "ok": True,
          "static": {"scope": LINT_SCOPE, "rc": static["proc"].returncode, "findings": payload["findings"],
                     "suppressed": [f"{f['path']}:{f['line']} {f['rule']}" for f in payload["suppressed"]],
                     "seconds": static["end_s"], "rule_times_ms": payload["rule_times_ms"]},
          "sync": {"device": torch.cuda.get_device_name(0), **{k: v for k, v in record.items() if k != "allowed"}},
          "twin_seconds": twin["end_s"], "seconds": seconds, "waited_s": waited_s, "budget_s": LINT_BUDGET_S})
    return {"seconds": seconds, "waited_s": waited_s}


def kernel_entry(name, source, replaces, launches_by_path, phase, in_graph=None):
    """One kernel's entry of the ``kernels`` line: float32 at the VGG-64
    tree under the write flush (the yardstick of the earlier slices) in the
    contract's keys, the ResNet-12 tree's (86 leaves, 34.9 M elements) and
    the anil head's (2 leaves, 10,400 elements) beside it under both
    flushes, then the read flush, the floor, the parent design and
    bfloat16."""
    f32 = phase["float32"]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "max_abs_err": phase["max_abs_err"],
        "ms": f32["ms"]["write"],
        "plain_ms": f32["plain_ms"]["write"],
        "bound_ms": f32["bound_ms"],
        "bound_by": "bytes",
        "library_ms": f32["library_ms"]["write"] if f32["library_ms"] else None,
        "dtype": "float32",
        "elements": f32["elements"],
        "leaves": f32["leaves"],
        "read_flush": {key: f32[key]["read"] for key in ("ms", "plain_ms", "floor_ms")},
        "resnet12": {key: f32["resnet12"][key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "reach",
                                                             "elements", "leaves")},
        "anil_head": {key: f32["anil_head"][key] for key in ("ms", "plain_ms", "library_ms", "floor_ms", "bound_ms",
                                                             "elements", "leaves")},
        "float32": f32,
        "bfloat16": phase["bfloat16"],
        # ms per launch inside a replayed graph (phase programs' profiler)
        "in_graph_ms": in_graph,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent-kernels", metavar="DIR",
                        help="a directory holding the parent design's fused_sgd.cu and fused_sgd_bwd.cu "
                             "(packed [rows, 128], from git history) to time in turns with the port's kernels")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs on the card", file=sys.stderr)
        return 2
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import apply_matmul_precision

    # IEEE float32 matmuls and convolutions (no TF32) until a system applies
    # its config's matmul_precision ("default" is the same)
    apply_matmul_precision("highest")
    torch.cuda.set_device(0)

    # each phase's wall seconds, and the run's wall time, for the time budget
    seconds = {}
    t_run = time.monotonic()

    def timed(name, fn, *fn_args):
        t0 = time.monotonic()
        out = fn(*fn_args)
        seconds[name] = round(time.monotonic() - t0, 1)
        # on stderr as each phase ends: a run the timing gate stops shows
        # where its time went
        print(f"chip_smoke: phase {name} took {seconds[name]} s", file=sys.stderr, flush=True)
        return out

    smi, parent = timed("device", phase_device, args.parent_kernels)
    # phase runner's image folder and index cache serve the phases after it;
    # the folder, its index and the CPU twin start now, in processes of
    # their own
    data_tmp = tempfile.mkdtemp(prefix="chip_smoke_runner_")
    early, prewarm_legs, ops_fleet_handle = [], [], None
    try:
        runner_data = prestart_runner_data(args.seed, data_tmp)
        twin = prestart_cpu_twin(args.seed, data_tmp)
        early += [runner_data["proc"], twin["proc"]]
        kernel = timed("kernel", phase_kernel, args.seed, parent)
        kernel_bwd = timed("kernel_bwd", phase_kernel_bwd, args.seed, parent)
        # phase http's two servers and the side process (SIDE_PHASES)
        # import and start the card from here on
        http_pre = prestart_http()
        side = prestart_side(args.seed, data_tmp)
        early.append(side["proc"])
        sl, slice_pending = timed("slice", phase_slice, args.seed)
        tr, system, trained, train_pending = timed("train", phase_train, args.seed)
        served = timed("serve_trained", phase_serve_trained, args.seed, system, trained)
        sp = timed("serve_programs", phase_serve_programs, args.seed)
        # the side process's first batch and phase bench's children run
        # beside http and tenancy
        release_side(side, 0)
        bench_pre = start_bench(data_tmp)
        lint_pre = start_lint(data_tmp, args.seed)
        early += [child["proc"] for child in bench_pre["children"] + lint_pre["children"]]
        http = timed("http", phase_http, args.seed, system, trained, http_pre)
        # the fleet's two first backends import and start the card during tenancy
        fleet_pre = prestart_fleet(system, trained)
        tn = timed("tenancy", phase_tenancy, args.seed, system, trained, http["alone_bound"])
        wait_side(side, 0)
        bench = phase_bench(bench_pre)
        seconds["bench"] = bench["seconds"]
        lint = phase_lint(lint_pre)
        seconds["lint"] = lint["seconds"]
        fl = timed("fleet", phase_fleet, args.seed, system, trained, http["alone_bound"], fleet_pre)
        # the CPU twin's halves of the slice's and train's checks are ready by now
        timed("cross", phase_cross, twin, slice_pending, train_pending)
        st = timed("strategies", phase_strategies, args.seed, tr["train_step_ms_median"], twin)
        # phase elastic's three CLI legs import and start the card during
        # phase runner
        elastic_legs = prestart_elastic(args.seed, data_tmp)
        # the side process's second batch runs beside runner
        release_side(side, 1)
        rn = timed("runner", phase_runner, args.seed, tr["train_step_ms_median"], data_tmp, runner_data)
        wait_side(side, 1)
        # the CPU autopsy of one of the runner's checkpoints runs from here on
        release_cpu_twin(twin, rn)
        # phase operations' training fleet runs beside elastic and tensor_parallel
        ops_fleet_handle = start_ops_fleet(args.seed, data_tmp)
        el = timed("elastic", phase_elastic, args.seed, data_tmp, elastic_legs)
        # operations' strict serve CLI imports and starts the card during
        # phase tensor_parallel
        ops_pre = prestart_ops_frontend(args.seed, data_tmp)
        tp = timed("tensor_parallel", phase_tensor_parallel, args.seed, data_tmp, el["reference"])
        ops = timed("operations", phase_operations, args.seed, data_tmp, ops_pre, ops_fleet_handle)
        # phase prewarm's three CLI legs and phase diagnostics' sweep job
        # import and start the card during phase programs
        prewarm_legs = prestart_prewarm(args.seed, data_tmp)
        sweep_job = prestart_sweep_job(data_tmp)
        pg = timed("programs", phase_programs, args.seed, data_tmp)
        # the sweep's job runs during phase prewarm (its result is read in
        # phase diagnostics)
        sweep_job.release()
        pw = timed("prewarm", phase_prewarm, args.seed, data_tmp, prewarm_legs)
        dg = timed("diagnostics", phase_diagnostics, args.seed, data_tmp, rn, twin, sweep_job)
        side_results, side_seconds, side_report = finish_side(side)
    finally:
        GatedCli.stop_all()
        if ops_fleet_handle is not None:
            stop_ops_fleet(ops_fleet_handle)
        for leg in prewarm_legs:
            _stop_leg(leg)
        for proc in early:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(data_tmp, ignore_errors=True)
    seconds.update(side_seconds)
    rs, rm, br = (side_results[name] for name in ("resnet", "remat", "breadth"))
    total_s = round(time.monotonic() - t_run, 1)
    emit({"phase": "timing", "seconds": seconds, "total_s": total_s,
          "side": {"batches": SIDE_BATCHES, "beside": [["http", "tenancy"], ["runner"]], **side_report,
                   "bench": {"beside": BENCH_BESIDE, "waited_s": bench["waited_s"]},
                   "lint": {"beside": BENCH_BESIDE, "waited_s": lint["waited_s"]}},
          "budget_s": {"serve_programs": SERVE_PROGRAMS_BUDGET_S, "bench": BENCH_BUDGET_S, "lint": LINT_BUDGET_S,
                       "elastic": ELASTIC_BUDGET_S,
                       "tensor_parallel": TENSOR_PARALLEL_BUDGET_S,
                       "operations": OPERATIONS_BUDGET_S, "programs": PROGRAMS_BUDGET_S,
                       "prewarm": PREWARM_BUDGET_S, "diagnostics": DIAG_BUDGET_S, "run": RUN_BUDGET_S}})
    check(seconds["serve_programs"] < SERVE_PROGRAMS_BUDGET_S and seconds["bench"] < BENCH_BUDGET_S
          and seconds["lint"] < LINT_BUDGET_S
          and seconds["elastic"] < ELASTIC_BUDGET_S and seconds["tensor_parallel"] < TENSOR_PARALLEL_BUDGET_S
          and seconds["operations"] < OPERATIONS_BUDGET_S
          and seconds["programs"] < PROGRAMS_BUDGET_S and seconds["prewarm"] < PREWARM_BUDGET_S
          and seconds["diagnostics"] < DIAG_BUDGET_S and total_s < RUN_BUDGET_S, "timing",
          "phase serve_programs, bench, lint, elastic, tensor_parallel, operations, programs, prewarm or diagnostics, "
          "or the run over its budget",
          seconds=seconds, total_s=total_s)
    fwd_paths = {"serving": sl["launches"], "train": tr["launches"]["fused_sgd"], "serve_trained": served,
                 "serve_programs": sp["prewarmed"]["launches"],
                 "http_serving": http["launches"], "tenancy": tn["launches"], "fleet": fl["launches"],
                 "anil_train": st["launches_with_eval"]["fused_sgd"],
                 "anil_remat": st["remat_full"]["launches"]["fused_sgd"], "strategies_serving": st["launches"],
                 "runner": rn["launches"]["fused_sgd"], "elastic": el["launches"]["fused_sgd"],
                 "operations": ops["launches"]["fused_sgd"], "resnet": rs["launches"]["fused_sgd"],
                 "resnet_bf16": rs["bf16_inner"]["launches"]["fused_sgd"], "remat": rm["launches"]["fused_sgd"],
                 "breadth": br["launches"]["fused_sgd"], "programs": pg["launches"]["fused_sgd"],
                 "prewarm": pw["launches"]["fused_sgd"], "mesh_programs": pw["launches_mesh"]["fused_sgd"],
                 "tensor_parallel": tp["launches"]["fused_sgd"], "tp_programs": tp["launches_graph"]["fused_sgd"],
                 "diagnostics": dg["launches"]["fused_sgd"]}
    bwd_paths = {"train": tr["launches"]["fused_sgd_bwd"], "anil_train": st["train_launches"]["fused_sgd_bwd"],
                 "anil_remat": st["remat_full"]["launches"]["fused_sgd_bwd"],
                 "runner": rn["launches"]["fused_sgd_bwd"], "elastic": el["launches"]["fused_sgd_bwd"],
                 "operations": ops["launches"]["fused_sgd_bwd"], "resnet": rs["launches"]["fused_sgd_bwd"],
                 "resnet_bf16": rs["bf16_inner"]["launches"]["fused_sgd_bwd"],
                 "remat": rm["launches"]["fused_sgd_bwd"], "breadth": br["launches"]["fused_sgd_bwd"],
                 "programs": pg["launches"]["fused_sgd_bwd"], "prewarm": pw["launches"]["fused_sgd_bwd"],
                 "mesh_programs": pw["launches_mesh"]["fused_sgd_bwd"],
                 "tensor_parallel": tp["launches"]["fused_sgd_bwd"],
                 "tp_programs": tp["launches_graph"]["fused_sgd_bwd"],
                 "diagnostics": dg["launches"]["fused_sgd_bwd"]}
    for paths in (fwd_paths, bwd_paths):
        check(all(n > 0 for n in paths.values()), "kernels", "a path launched a kernel no time", paths=paths)
    emit({"kernels": [
        kernel_entry("fused_sgd", "howtotrainyourmamlpytorch_tpu_torch/csrc/fused_sgd.cu",
                     "howtotrainyourmamlpytorch_tpu/ops/pallas_update.py:125", fwd_paths, kernel,
                     pg["in_graph_ms"]["fused_sgd"]),
        kernel_entry("fused_sgd_bwd", "howtotrainyourmamlpytorch_tpu_torch/csrc/fused_sgd_bwd.cu",
                     "howtotrainyourmamlpytorch_tpu/ops/pallas_update.py:134", bwd_paths, kernel_bwd,
                     pg["in_graph_ms"]["fused_sgd_bwd"]),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        sys.exit(1)
