#!/usr/bin/env python3
"""Drive the PyTorch port of AMB-DG on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and the script exits non-zero):

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
     ``nvcc`` per source, all started together) and print the time, each
     kernel's registers and spills, and the count of wgmma instructions
     (``HGMMA``) in the SASS of each flash kernel (``cuobjdump -sass``):
     every bf16 kernel must hold some, the f32 ones none, and each of
     the six is built at every head dim (64, 80, 128, 256); and the count
     of tensor-core instructions (``HMMA``) in each linear-scan kernel:
     every chunk-state and output kernel must hold some;
  2. hold each kernel against its plain PyTorch version on the card,
     bitwise, at the slice's arena (256 rows, one pod) and at an arena
     the size of qwen1.5-0.5b's 463,987,712 parameters (3,624,960 rows;
     one pod, and two for the ring rotates and the int8 variable pop);
     the variable pop on a ring of 9 slots with 0, 1 and 2 of them due,
     the v1 rotate on a ring of 4; time both over 25 launches
     after warm-up (device time from ``torch.profiler``, which must see
     the kernels; CUDA events around each call, host launch work
     included, beside it) against the least time the card could take
     (bytes moved at 3.35 TB/s; flops at 67 TFLOP/s f32), and, for the
     f32 variable pop, ``torch.tensordot`` of the mask with the ring
     (one library call computing the same function) as a yardstick;
  3. the main path: ``repro_torch.train.loop.train`` of ``amb-linreg``
     FULL (d = 10^4, the paper's Sec. VI-A setting: 10 workers x 150
     samples, tau = 4, l2-ball prox), 12 steps with pod compression int8
     and again with none, on the card and then on the CPU from the same
     seed. The kernels' launch counts, zeroed just before each run on
     the card and read just after, must equal the steps run; the two
     devices must agree (tolerances below). Where a step's time goes
     comes from the same run on the card: ``train``'s per-step host
     batch, copy and step times, and the card's kernel time over the
     run (profiler);
  4. the stochastic-delay path: the same runs under a heavy-tailed
     delay (tau_max = 8, seed 7) on the delay-tolerant ring. Its steps
     with no arrival, one and two (from ``core.delay_process`` and
     ``core.staleness``) must show in ``applied_count`` and
     ``tau_applied``, identically on the card and the CPU; the variable
     pop and the dual update launch once a step, the slot rotate never;
     one master update (ring push and pop, then dual averaging) runs
     under ``torch.cuda.set_sync_debug_mode("error")``: nothing is read
     back to the host;
  5. the v1 ring: ``core.arena.push_pop`` on a stacked (layout v1) ring
     beside a v2 ring for tau + 3 steps at the main path's arena, f32
     and int8: the same pops bit for bit, one v1 rotate launch a step,
     and ``convert_ring`` gives back the v2 ring's live slots;
  6. the LM slice at full width: qwen1.5-0.5b FULL cut to 8 of its 24
     layers (d_model 1024, vocab 151,936 padded to 152,064; the cut keeps
     the script within half its time limit) at the ``train_4k``
     length (4096 tokens). At the init weights, on one microbatch of 2
     sequences: the worker's gradient, leaf by leaf, and a no-grad eval
     (the forward without lse, once per layer), flash against xla in
     f32 and in bf16 compute (limits below). Then AMB-DG training,
     8 sequences a step (4
     workers x 2), 4 microbatches, tau = 2, int8 pod compression,
     ``block_remat="full"``, 5 steps through ``train`` with
     ``attn_impl="flash"`` (the flash kernels), then the same 5 steps
     with ``attn_impl="xla"`` (plain attention). Applied counts equal,
     per-step losses agree (bf16 tolerance below), w finite and in the
     l2 ball; the dq kernel launched once per layer, microbatch and
     step; the step split, the peak memory and the profiler's kernel
     time split (attention kernels, cuBLAS, the rest). A ``no_grad``
     evaluation at the final weights launches the forward without lse
     once per layer and agrees with the plain attention;
  7. the LM slice at full width with 2 layers: seq 256, 2 workers x 1
     sequence (2 x 2 until phase 17 came, cut for the time limit),
     3 steps, f32 compute, on the card (the flash kernels) against the
     CPU (the plain version), with phase 3's checks, and the worker's
     gradient at the init weights leaf by leaf;
  8. the hybrid slice at full width: zamba2-2.7b (d_model 2560, 80
     Mamba2 heads of 64, d_state 64, chunk 256, a shared attention block
     of 32 heads of 80 and d_ff 10240 after every 6 layers, vocab 32,000)
     cut to 6 layers (1 group; 0.51B parameters: all 54 would not fit
     the AMB-DG state on one card; 36, then 24 until phase 17 came, cut
     for the script's time limit), seq 4096. At the init weights, on one
     microbatch of 2 sequences: the worker's gradient leaf by leaf and a
     no-grad eval, the kernel route (``scan_impl="kernel"``, the scan
     kernel, and ``attn_impl="flash"``, the shared block on the flash
     kernels at head dim 80) against ``"xla"`` (the plain chunked scan
     and plain attention) in f32 and bf16 compute, and the flash kernels
     alone (on the plain scan) against plain attention at phase 6's
     limits. Then
     AMB-DG as in phase 6 (8 sequences, 4 microbatches, tau 2, int8,
     ``block_remat="full"``, l2 ball), 3 steps with each route (5 until
     phase 16 came: cut for the script's time limit): counts and
     losses agree, w in the ball; the scan kernel launched 2 x 6 x 4
     times a step forward and 3 x 6 x 4 in its backward forms, the
     forward with lse 2 x 1 x 4 times a step (one shared-block
     application a microbatch, recomputed under full remat) and dq and
     dk/dv 1 x 4, and no plain scan (``ssd_chunked`` or the recurrence)
     or plain attention called in that run (a scan call is three device
     kernels: the counts are calls);
     the step split, peak memory and the kernel time split, with the
     15 largest kernels of the rest by name;
  9. zamba2 at full width with one group of 6 layers: seq 512, 1
     worker x 1 sequence, tau 1, 2 steps (2 x 2 sequences, tau 2 and 3
     steps until phase 17 came; 2 workers until phase 20 came: cut for
     the script's time limit), f32,
     the card (the scan kernel) against the CPU
     (the plain recurrence), with phase 3's checks and the init-weight
     gradient; the CPU's side runs in a process of its own started
     after the build, beside phases 2-8 (the card busy, the host's
     cores idle);
 10. the cluster simulator (``repro_torch.sim``) with its gradients on
     the card, TF32 off: the golden traces of ``tests/golden/``
     (``sim_trace.json``, both halves of ``stochastic_trace.json``;
     bookkeeping columns exact, errors to rtol 1e-4, atol 1e-7), then
     the paper's Sec. VI-A comparison at d = 10^4 through
     ``api.simulate``: AMB-DG, AMB and K-batch over 200 simulated
     seconds (250 until phase 17 came; more than 3x AMB's updates for
     AMB-DG, finite errors, no
     clamped batch), with each scheme's host / device time split, each
     scheme in a process of its own started beside phase 9; the
     simulator's pytree master launches no kernel;
 11. ``master_impl="pytree"`` against ``"arena"``: amb-linreg FULL,
     12 steps, none and int8, through ``train`` with ``proximal="l2"``
     (at smoothness 20, where the loss falls), bit for bit; then the
     configuration's ``l2_ball`` with the two masters in lockstep on
     the same gradients, z bit for bit and the params at JAX's
     tolerance, the ball active; qwen1.5-0.5b at 2 layers (seq 256, 4
     sequences) in lockstep, bit for bit after every step. The arena master launches
     the dual update (and under int8 the slot rotate) once a step, the
     pytree master no kernel;
 12. ``strategy="kbatch"`` through ``train`` on amb-linreg FULL, 5
     steps: ``ref_epoch`` ends at 6, the staleness is 0, the dual update
     launches once a step, and the params equal the "amb" run's bit for
     bit;
 13. the paper's CNN at full width (amb-cnn FULL, 32x32x3, 6,805,642
     parameters; Sec. VI-B), TF32 off: the worker's gradient at the init
     weights on 128 images, card and CPU each against an f64 gradient on
     the card and against each other (limits below); AMB-DG through
     ``train`` (fig5_nn.py's 4 workers x 128, T_p = T_c = 10, tau 1, L 4,
     b_bar 240), 4 steps (12 until phase 17 came, 6 until phase 20), int8 and none, card
     then CPU: counts exact,
     losses, acc_sum and weights within the limits below, the dual
     update once a step and the int8 slot rotate once a step, the step
     split, the kernel split (cuDNN, cuBLAS, B.1/B.2, the rest) and the
     peak memory; then Fig. 5 through ``api.simulate``: AMB-DG against
     K-batch (60 a message, K 4) over 1000 simulated s (fig5_nn.py's
     2000 until phase 17 came), the update counts
     against the timeline, no clamp, finite held-out losses and
     fig5_nn.py's ``ambdg_beats_kbatch`` as a finding;
 14. the scenarios on amb-linreg: both halves of
     ``tests/golden/batch_schedule_trace.json`` through ``api.simulate``
     on the card (bookkeeping exact, errors to rtol 1e-4); ``train``
     under the adadamp and delay_aware batch schedules (the latter with
     phase 4's heavy-tailed delay) on the card and the CPU with phase 3's
     checks, the same drawn targets, the variable pop once a step under
     the delay; ``train`` under the churn and crash/restart worker
     processes with a checkpoint directory: evictions, readmissions and
     the checkpoint each eviction saves, and a run stopped at step 6 and
     restarted from its checkpoint equal to the uninterrupted 12-step run
     bit for bit (every state leaf and the host states).

 15. the decentralized gossip (the paper's Sec. V, ``strategy=
     "decentralized"``, the dense fold), TF32 off, no master and so no
     B.1/B.2 launch: (a) the setting of ``tests/golden/
     decentralized_trace.json`` (linreg d = 32, 4 workers, ring, r = 3,
     "none" and "int8", 8 steps) on the card and the CPU: rounds, times
     and steps equal the JSON, losses and consensus errors agree to rtol
     1e-5; (b) amb-linreg FULL through ``train``, 10 workers x 150 on a
     ring with eq. (24)'s 59 rounds, the l2 ball, 6 steps (12 until
     phase 17 came, cut for the time limit), "none" and
     "int8", 2 microbatches of 75, card then CPU (counts exact, losses
     rtol 1e-4, z and every worker's w to 1e-4 of the largest plus an
     int8 step; under int8 step by step from the CPU's state, the free
     runs' losses to 1e-2), one more step under
     ``torch.cuda.set_sync_debug_mode("error")``, the step split and the
     kernels a step; (c) the same under the churn worker process:
     ``active_workers`` equals the host's draw, a dead worker's z row and
     weights stay bit for bit; (d) amb-cnn FULL, 4 x 128 images, ring (11
     rounds) and a 2 x 2 torus (8), "none" and "int8", 3 steps on the
     card, the first on the CPU, with phase 13's limits, the kernel
     split with the gossip's kernels apart (a short spin kernel marks each
     gossip call), its ms a round against its bytes, the peak memory; (e) qwen1.5-0.5b at full
     width with 2 layers, seq 256, f32, flash attention, 4 workers x 2
     sequences, ring, int8, 2 steps on the card: the flash kernels launch
     workers x layers x microbatches times a step.

 16. train-while-serve (``repro_torch.serve``; no kernel of the port on
     the decode path, which is JAX's plain ``gqa_attend`` and Mamba2
     recurrence): (a) ``tests/test_serve.py``'s golden trace (qwen1.5-0.5b
     SMOKE, 3 slots, Poisson 0.7, publish every 3, bound 6, seed 5, 40
     steps) with the engine and the publisher on the card: every row of
     ``tests/golden/serve_trace.json`` exact; (b) the engine on the card
     against the CPU, f32, TF32 off, the same weights: qwen1.5-0.5b FULL
     at 2 layers and zamba2-2.7b FULL at 6, 3 slots of ragged prompts (5,
     7, 9 tokens), 16 steps: logits and caches within 1e-4 of the
     largest, tokens equal; (c) serving at full size, the configs' bf16:
     qwen1.5-0.5b FULL (24 layers, 16 slots of 512) and zamba2-2.7b at
     12 layers (8 slots), Poisson 0.5 requests a step, prompts of 16-128
     tokens, max_new 64, 32 warm-up steps then 64 (zamba2: 32; 256 and
     128 until phase 17 came, cut for the script's time limit) timed:
     the median step, prefill and decode tokens/s, kernels a step, idle
     share, peak memory and the kernel split (cuBLAS, casts, the rest);
     (d) train-while-serve: qwen1.5-0.5b at 2 layers, seq 512, 4 workers
     x 2, tau 2, int8, flash, publish every 2, bound 4, 6 master steps
     with a checkpoint at step 4; an engine attached to ``train``'s
     publisher refreshes at 6..10: staleness within the bound, the popped
     trees and the ring's bytes and scale bits bit for bit against the
     CPU's dequantize and quantize, the checkpoint and a resumed run
     carry the publisher bit for bit; B.1 and B.2 once a step, the flash
     kernels per layer and microbatch.

 17. the MoE slice (mixtral: top-2 of 8 experts, a sliding window of
     4096, the rolling KV cache; no new kernel): (a) mixtral-8x7b FULL
     widths (d_model 4096, 32/8 heads of 128, 8 experts of d_ff 14336,
     vocab 32,000) cut to 1 of its 32 layers (1.71B parameters; 2 would
     not fit the AMB-DG state on one card) at the init weights on one
     sequence of 8192 tokens: the worker's gradient leaf by leaf and a
     no-grad eval, flash (the window in the kernels) against xla (the
     windowed plain mask) in f32 and bf16, the gather dispatch against
     einsum in bf16, with phase 6's limits; the tokens whose first-layer
     experts differ between routes; the gather route twice bit for bit;
     (b) AMB-DG through ``train`` on that model at 8192 tokens with phase
     6's settings (4 workers x 2 sequences, 4 microbatches, tau 2, int8,
     full remat, l2 ball, flash), 3 steps with einsum dispatch, then 3
     with gather: counts and losses agree, w in the ball, B.1 and B.2
     once a step, the flash forward with lse twice, dq and dk/dv once per
     layer and microbatch, nothing else; the step split, the peak and the
     kernel split (flash, cuBLAS, the MoE dispatch by name, the rest);
     (c) the card against the CPU, f32, TF32 off: mixtral-8x7b and
     mixtral-8x22b SMOKE (window 32, plain attention: head dim 16), the
     init-weight gradient, 3 ``train`` steps at S = 128 with phase 3's
     checks, and the engine on 3 ragged slots for 48 steps (past the
     window: the rolling buffer wraps), as 16b; (d) serving 17a's model in
     bf16, 8 slots, Poisson 0.5, 16 warm-up then 64 timed steps, as 16c.

 18. the xLSTM slice (xlstm-125m FULL: d_model 768, 12 layers, 6 mLSTM
     blocks with heads of 384 and 6 sLSTM blocks with heads of 192,
     vocab 50,304; JAX computes both blocks outside Pallas, so no kernel
     is new and none but B.1/B.2 runs), every part from the init with
     the sLSTM's recurrent weights rescaled to fan-in head_dim (at the
     init's fan-in n_heads the recurrence is chaotic and its gradient at
     1024 tokens is not finite, in JAX as in the port, ROADMAP C.16):
     (a) f32, 4 of the 12 layers (6 until phase 20 came, cut for the
     script's time limit), one sequence of 1024 tokens (4 mLSTM
     chunks): the loss and the worker's gradient on the card against the
     CPU leaf by leaf and a prefill-by-decode over 512 tokens against the
     forward's last position (limits below); a no-grad forward at 4096
     tokens in bf16, timed; (b) AMB-DG through ``train`` in bf16 at 2 of
     the 12 layers (a step at 4 is ~210,000 eager kernels), 2 workers x 2
     sequences of 1024, 1 microbatch, tau 2, int8, full remat, 3 steps:
     B.1 and B.2 once a step, the step split, the kernel
     split and the peak; then one step with ``block_remat="dots"``
     and one with ``rc.remat="whole_loss"``, each step's peak (dots no
     lower than full); (c) serving xlstm-125m FULL in bf16, 8 slots of
     512, Poisson 0.5, 16 + 64 steps, as 17d; the SMOKE engine in f32 on
     the card against the CPU, 3 ragged slots, 24 steps, tokens equal.

 19. the encoder-decoder and the VLM (seamless-m4t-large-v2 FULL widths:
     d_model 1024, 16/16 heads of 64, d_ff 8192, vocab 256,206;
     paligemma-3b FULL widths: d_model 2048, 8 query heads on 1 kv head
     of 256, d_ff 16384, vocab 257,216, 256 stub patches, prefix-LM; JAX
     computes both outside Pallas, so no kernel is new), each from one
     seeded init on the card: (a) f32, the worker's gradient and loss on
     the card against the CPU leaf by leaf at seamless 2 + 2 layers
     (under "flash": the kernels, non-causal in the encoder and the
     cross-attention, against their plain version on the CPU; and against
     "xla" on the card) and paligemma 1 layer, one sequence of 512 tokens
     (phase 7's limits); seamless's no-grad forward at 4096 tokens, 6 + 6
     layers, bf16, flash against xla; (b) AMB-DG through ``train`` in
     bf16, 2 workers x 1 sequence of 4096 tokens, 2 microbatches, tau 2,
     int8, l2 ball, full remat, 3 steps, on seamless at 6 + 6 of its 24 +
     24 layers under "flash" (B.1 and B.2 once a step, the forward with
     lse twice and dq and dk/dv once per attention and microbatch) and
     paligemma at 4 of its 18 layers (the plain prefix-LM core: B.1 and
     B.2 only): the step split, the kernel split and the peak; (c)
     serving each (``api.serve``) in bf16, 8 slots of 512, Poisson 0.5,
     16 + 64 steps, as 17d; each SMOKE engine in f32 on the card against
     the CPU, 3 ragged slots, 24 steps, tokens equal.

 20. the launchers on the card (``repro_torch.launch``, called in
     process): ``launch.train.main`` on qwen1.5-0.5b FULL (all 24
     layers) at 1024 tokens, 2 workers x 1 sequence, 3 steps, with each
     of ``--optimizer dual_averaging``, ``sgd`` and ``adam``: finite
     losses, B.1 once a step under dual averaging and no kernel of the
     port under sgd and adam; each optimizer on amb-linreg SMOKE on the
     card against ``--device cpu`` (phase 7's limits on the loss and the
     weights); ``launch.serve.main`` on qwen1.5-0.5b FULL, 16 slots, 32
     steps, publishing every 4: staleness within the bound; and
     ``anytime_impl="while_dynamic"`` on phase 3's linreg, 3 steps, bit
     for bit the "scan_masked" run.

 21. the pod axis across processes (``torch.distributed``): (a) each
     sharded wrapper (``dual_update_arena_sharded``,
     ``ring_slot_rotate_int8_sharded``, ``ring_variable_pop_sharded`` f32
     and int8) at world size 1 on NCCL at qwen1.5-0.5b's arena (3,624,960
     rows), bitwise against the off-mesh route, one launch a call, timed
     beside the off-mesh route and phase 2's kernel alone; (b) two
     spawned ranks on gloo sharing the card (NCCL refuses two ranks on
     one device): which collectives gloo takes on CUDA tensors, the
     wrappers at 2 pods of 262,144 rows bitwise against the off-mesh
     route, and linreg FULL (phase 3's settings, int8, l2 ball) on
     ``--mesh 2x1x1`` for 6 steps through ``python -m
     torch.distributed.run -m repro_torch.launch.train``'s ``main``,
     twice, each run's state joined by ``checkpoint.save_sharded``, bit
     for bit (metrics and every state leaf) the same mesh's pods
     stacked in one process (``train(..., mesh=None)``) at n_pods = 2,
     run beside them in a process of its own with the ranks' one host
     BLAS thread (``torch.distributed.run`` sets OMP_NUM_THREADS=1, and
     the linreg stream's y = x w* rounds with OpenBLAS's thread split,
     ROADMAP C.18); the witness printed beside it: the ranks' two runs against each other,
     and the stacked run made in this process with its default BLAS
     threads against the reference; (c) the four ``examples_torch``
     scripts on the card, each within 10 s. (c) runs while (b)'s ranks
     run, (a) after both.

 22. the LMs on the mesh and the per-rank gossip, on gloo ranks sharing
     the card, started with 21b's before phase 20: (a) qwen1.5-0.5b FULL
     widths at 2 of its 24 layers, flash, 4096 tokens, int8 pod
     compression, tau 1, 2 steps of 4 sequences, through ``train(...,
     mesh=)`` on 2x1x1 and on 1x2x1 (two ranks), each held against its
     stacked run made twice in a process of its own: the params and the
     losses within the gap of the two stacked runs (printed), counts
     exact; each rank's ms a step, its launches of B.1, B.2 and flash
     (added to the kernels line with the stacked runs'), and the pod
     exchange's census against
     ``launch.wire_model.master_pod_exchange_bytes``; (b) decentralized
     linreg FULL (phase 3's settings) on a ring of 4, one worker a rank
     (four ranks, ``gossip_impl="auto"``), none, int8 and churn, 6 steps:
     every leaf of the checkpoint the ranks join, the loss and the
     applied count bit for bit the dense run at one BLAS thread in a
     process of its own (C.18), grad_norm and consensus_error to 1e-4
     (phase 3's limit; they sum whole messages in an all-reduce, C.19);
     each rank's "gossip" census equal to ``gossip_round_bytes`` times
     the rounds and steps; a gossip round's ms a rank; and what gloo's
     point-to-point does with a CUDA tensor that is not staged through
     the host (printed). NCCL across cards is not measured: one card
     takes one NCCL rank.

 23. tensor parallelism over ``model`` (``dist.tensor_parallel``), on
     two gloo ranks sharing the card, started once 22a's processes have
     ended (beside them and phase 20 the card's memory ran out), beside
     22b's check: qwen1.5-0.5b
     FULL widths at 2 of its 24 layers, f32, flash, 4096 tokens, int8 pod
     compression, tau 1, 2 steps of 4 sequences on 1x1x2, without and
     with ``seq_parallel``, each held against the 1x1x1 stacked run made
     in a process of its own: each step's loss to rtol 1e-4, every
     parameter leaf within 1e-4 of its largest element plus one int8
     step (the leaf's largest row scale over the applied count), the
     counts exact; each rank's ms a step, its launches of B.1 and B.2
     (inside their sharded wrappers, on rows over ``data x model``) and
     of flash (on its 8 of the 16 heads: as many calls as the stacked
     run's), added to the kernels line with the stacked run's; and the
     ``model`` axis's census against ``launch.wire_model.
     model_axis_bytes``.
 24. tensor parallelism for the MoE and the hybrid, on two gloo ranks
     sharing the card, f32, tau 1, int8, 2 steps of 2 sequences on
     1x1x2, each held against its 1x1x1 stacked run (a process of its
     own) to phase 23's limits: mixtral-8x7b FULL widths, 1 layer, the
     gather dispatch, flash, 4096 tokens; zamba2 FULL widths, 6 layers,
     the scan kernel on a rank's 40 of 80 heads, flash at D = 80,
     ``seq_parallel``. Each rank holds its parameter blocks against its
     blocks of the stacked run's and prints its peak memory, its ms a
     step and its launches (B.1, B.2, flash and, for zamba2, B.8 forward
     and backward: as many as the stacked run's), and its census against
     ``model_axis_bytes``. The zamba2 processes run beside phase 9 and
     on, the mixtral reference after them beside phases 10-14, the
     mixtral ranks ready themselves beside phase 23 and run alone.
 25. tensor parallelism for the encoder-decoder, the VLM and the xLSTM,
     as phase 24 (f32, tau 1, int8, 2 steps of 2 sequences on 1x1x2,
     each against its 1x1x1 stacked run, to phase 23's limits):
     seamless-m4t-large-v2 FULL widths, 2 + 2 layers, flash (8 of 16
     heads a rank; the encoder and the cross-attention non-causal),
     ``seq_parallel``, 2048 frames and 2048 tokens; paligemma-3b FULL
     widths, 1 layer, 256 patches + 1792 text tokens, ``seq_parallel``;
     xlstm-125m FULL widths, 2 layers (an mLSTM and an sLSTM block),
     ``w_h`` rescaled (C.16), 512 tokens. Each rank prints its peak, ms a
     step, launches (B.1, B.2 and, for seamless, flash: as many as the
     stacked run's) and census against ``model_axis_bytes``. The stages
     run beside phases 3-7, 15 and 16; the checks follow phase 24.
 26. serving over ``model`` (``api.serve`` on the serve profile's
     layout, ``dist.tensor_parallel``'s decode), on two gloo ranks
     sharing the card, 1x1x2, FULL widths, f32 with an f32 cache, at
     phases 23-25's depths: qwen1.5-0.5b 2 layers, mixtral-8x7b 1
     layer (gather), zamba2-2.7b 6, seamless-m4t-large-v2 2 + 2,
     paligemma-3b 1, xlstm-125m 2 (``w_h`` rescaled). Each serves 8
     slots for 24 engine steps under the seeded Poisson queue against
     the stacked 1x1x1 engine on the card (a process of its own): every
     emitted token and the trace equal, each step's joined logits within
     1e-4 of the largest element, the census equal to ``launch.
     wire_model.decode_axis_bytes`` to the byte, no kernel of the port
     launched (the decode runs ``gqa_attend`` and Mamba2's one-step
     recurrence, as JAX's does). One line a family: the median step a
     rank (gloo's host staging: no speed), the peak a process and the
     kernels a step. Its processes ready themselves beside phase 17 and
     run beside phases 18 and on; the checks follow phase 25.

``python3 chip_smoke.py --only=2,8,13,14,15,16,17,18,19,20,21,22,23,24,25,26``
runs the build and then only the phases named among 8 and 13-26 (``2``:
phase 2's mixtral, non-causal and head-dim 80/256 flash rows alone; a
short call while working on them; no kernels or ok line).

Phase 2 also holds the flash-attention kernels (the forward with and
without lse, dq, dk/dv) against their plain versions on the card, in
bf16 at the main path's shape (B = 2, 16 heads, S = 4096, D = 64,
causal), at qwen3-1.7b's and yi-6b's GQA shapes (16/8 and 32/4 heads,
D = 128, S = 4096), at mixtral-8x7b's (32/8 heads, D = 128, S = 8192, a
4096-token window; in f32 too), with a 1024-token window and with right-aligned
queries (Sq = 256, Skv = 512), untimed on rows with no valid key, at a
ragged GQA length and with a window at D = 128; and in f32 at the main
path's and the GQA shapes, on rows with no valid key and with a window
at D = 128. Non-causal (every query over every key): timed in bf16 at
seamless-m4t's encoder shape (B = 2, 16/16 heads, S = 4096, D = 64; SDPA
with ``is_causal=False`` the library time), untimed at the
cross-attention's Sq = 320 over Skv = 4096 and Sq = 4096 over Skv = 1000,
and in f32 at the encoder's shape. At the widened head dims, timed in
bf16 and in f32: zamba2-2.7b's shared block (B = 2, 32/32 heads, S =
4096, D = 80) and paligemma-3b's head layout (B = 1, 8/1 heads, S =
4096, D = 256), causal. bf16 runs the Hopper kernels (wgmma on TMA-loaded tiles),
f32 the exact CUDA-core kernels.
Each element is held on its own: within one ulp of its dtype (2^-7 of
the element in bf16) plus 1e-5 of the tensor's largest element. Two
launches of each give the same bits. Their yardstick is
``torch.nn.functional.scaled_dot_product_attention`` (forward; its
backward for dq and dk/dv), timed here and used nowhere in the port.

Phase 2 holds the linear-scan kernel against its plain recurrence at
the four calls of zamba2's main path (the forward with bf16 q, k and an
f32 v; the backward's dv, dk and dq forms on f32 operands, the latter
two strict), each timed with its bound, and at JAX's three test shapes
in f32 and bf16; each element within one ulp of y's dtype plus
SCAN_F32_TOL of the largest, bitwise repeatable. A call is three device
kernels (the chunk states, the state pass, the outputs: all named
``linear_scan_*``); its time is their sum. No single PyTorch call
computes the scan. The unnormalized dual update (the pytree wrapper's
kernel) is held bitwise at 256 and 3,624,960 rows.

The last lines are the ``{"kernels": [...]}`` record, the card's name
and power limit from ``nvidia-smi``, and ``{"ok": true, ...}``. Without
CUDA, or without the repository's ``src/repro_torch`` beside it, the
script fails before printing any result.
"""
import collections
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 on the tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM dense TF32 (f32 operands) on them
N_TIMED = 25
# a kernel's plain version is timed over this many calls: at the large
# rows it takes 3-110 ms a call, and 25 of them a row took half a minute
N_PLAIN_TIMED = 5
MAIN_STEPS = 12


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, n=N_TIMED, warmup=3):
    """Median milliseconds of ``fn()`` on the card over ``n`` calls, each
    bracketed by CUDA events, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


PROFILER_TRIES = 5
# spin kernels launched at the start of each profiling session, before
# the work timed: a CUPTI session can lose the records of the first
# kernels it sees; they are left out of the record
SENTINELS, SENTINEL_CYCLES = 8, 200_000


# phase 15 brackets each gossip call with two short spin kernels (MARK
# in a record), far shorter than a sentinel, to find its kernels
MARK, MARK_CYCLES, MARK_MAX_US = "gossip_mark", 1000, 20.0


def profiled(fn, marks=False):
    """Run ``fn()`` under ``torch.profiler`` (CUPTI); returns (its
    result, the device kernels recorded: a list of (name, microseconds),
    empty when the profiler saw no device time). On some hosts a CUPTI
    session now and then records nothing, or loses some of its records
    (the first kernels of a session: SENTINELS spin kernels run first
    and are dropped); callers run ``fn`` again, up to PROFILER_TRIES
    times, and raise if no try gave a complete record. With ``marks``
    the short spin kernels of ``gossip_marked`` stay in the record as
    MARK. The kernels are read from the profiler's raw records
    (``kineto_results.events()``), about 20x faster than parsing them
    into ``FunctionEvent``s: phase 18b records ~630,000 kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SENTINELS):
            torch.cuda._sleep(SENTINEL_CYCLES)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()

    def mark(name, us):
        return marks and "spin_kernel" in name and us < MARK_MAX_US

    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted((e.start_ns(), e.name(), e.duration_ns() / 1e3)
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cuda)
    kernels = [(MARK if mark(name, us) else name, us) for _, name, us in rows
               if "spin_kernel" not in name or mark(name, us)]
    if not sum(us for _, us in kernels):
        log("note: torch.profiler recorded no device time in one session")
        kernels = []
    return out, kernels


def profiled_kernels(fn, complete):
    """The device kernels of ``fn()`` (see ``profiled``), running it again
    while the profiler's record is empty or not ``complete(kernels)`` (a
    session that lost some of its records); raises after PROFILER_TRIES
    sessions."""
    for _ in range(PROFILER_TRIES):
        _, kernels = profiled(fn)
        if kernels and complete(kernels):
            return kernels
        if kernels:
            log(f"note: torch.profiler recorded {len(kernels)} kernels, an "
                "incomplete record, in one session")
    raise RuntimeError(f"torch.profiler recorded no complete record of "
                       f"the device in {PROFILER_TRIES} sessions")


def device_ms(fn, n=N_TIMED, warmup=3, match=None, per_call=1):
    """Device time of ``fn()`` from the profiler over ``n`` calls after
    ``warmup``: with ``match``, the median over the calls of the summed
    duration of a call's kernels whose name contains it (``per_call`` of
    them, in launch order, so the record must hold n * per_call);
    without, the summed duration of all kernels divided by ``n`` (the
    record must hold a multiple of n: every call launches the same
    kernels). Host time between launches is not counted. Also returns
    the kernels' names and counts."""
    for _ in range(warmup):
        fn()

    def calls():
        for _ in range(n):
            fn()

    def mine(kernels):
        return [(k, us) for k, us in kernels if match is None or match in k]

    def complete(kernels):
        m = len(mine(kernels))
        return m == n * per_call if match is not None else m % n == 0

    kernels = mine(profiled_kernels(calls, complete))
    us = [us for _, us in kernels]
    names = dict(collections.Counter(k for k, _ in kernels))
    if match is None:
        return sum(us) / n / 1e3, names
    return statistics.median(sum(us[i:i + per_call])
                             for i in range(0, len(us), per_call)) / 1e3, names


def timed(kernel_fn, plain_fn, symbol, n=N_TIMED):
    """Times of a kernel (``symbol``: its name in ``csrc``) and its plain
    version. ``ms``: the median device time of the kernel's launches;
    ``plain_ms``: the device time of all the plain version's kernels per
    call (both from the profiler); ``wrapper_ms``/``plain_wrapper_ms``:
    median CUDA-event time around each call, host launch work included.
    The kernel is timed over ``n`` calls, its plain version over at most
    N_PLAIN_TIMED."""
    n_plain = min(n, N_PLAIN_TIMED)
    ms, names = device_ms(kernel_fn, n=n, match=symbol)
    plain, plain_names = device_ms(plain_fn, n=n_plain)
    return dict(ms=ms, plain_ms=plain, kernels=names,
                plain_kernels=plain_names, wrapper_ms=cuda_ms(kernel_fn, n=n),
                plain_wrapper_ms=cuda_ms(plain_fn, n=n_plain))


def bound_ms(n_bytes, n_flops, flops_per_s=F32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_flops = n_flops / flops_per_s
    return 1e3 * max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                         else "operations")


def max_abs_err(got, want):
    import torch
    return max(0.0 if torch.equal(a, b) else
               float((a.to(torch.float32) - b.to(torch.float32)).abs().max())
               for a, b in zip(got, want))


def sass_counts(library, mnemonic):
    """{kernel name: how many instructions of ``mnemonic`` its SASS holds}
    for each kernel of a built library (``cuobjdump -sass``)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and mnemonic in line:
            counts[name] += 1
    return counts


def check_dual_update(rows, gen):
    """Kernel vs plain version on one (rows, 128) arena; returns a dict
    of the comparison and the times."""
    import torch
    from repro_torch.kernels.dual_update.ops import dual_update_arena
    from repro_torch.kernels.dual_update.ref import dual_update_fused_ref
    dev = torch.device("cuda")
    z = torch.randn((rows, 128), generator=gen, device=dev)
    g = torch.randn((rows, 128), generator=gen, device=dev) * 300
    count = torch.full((), 1377.0, device=dev)
    alpha = torch.full((), 1.0 / (1.0 + math.sqrt(11 / 800)), device=dev)
    zk, wk = dual_update_arena(z.clone(), g, count, alpha, impl="kernel")
    zr, wr = dual_update_arena(z.clone(), g, count, alpha, impl="ref")
    torch.cuda.synchronize()
    equal = torch.equal(zk, zr) and torch.equal(wk, wr)
    err = max_abs_err((zk, wk), (zr, wr))
    del zk, wk, zr, wr
    denom = torch.clamp(count, min=1e-12)
    times = timed(
        lambda: dual_update_arena(z, g, count, alpha, impl="kernel"),
        lambda: dual_update_fused_ref(z, g, denom, alpha),
        "dual_update_fused_kernel")
    n = rows * 128
    b_ms, by = bound_ms(16 * n + 8, 3 * n)
    return dict(rows=rows, pods=1, bitwise=equal, max_abs_err=err,
                bound_ms=b_ms, bound_by=by, **times)


def check_rotate(n_pods, rows, gen):
    """Kernel vs plain version of the int8 slot rotate on (n_pods, rows,
    128) slots; fed puts some values exactly on half-way points and
    some past the clip."""
    import torch
    from repro_torch.kernels.delay_ring.ops import ring_slot_rotate_int8
    from repro_torch.kernels.delay_ring.ref import ring_slot_rotate_int8_ref
    dev = torch.device("cuda")
    shape = (n_pods, rows, 128)
    slot_pop = torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
    scales_pop = torch.rand(shape[:2], generator=gen, device=dev) + 1e-3
    scale_new = torch.rand(shape[:2], generator=gen, device=dev) + 1e-3
    fed = torch.randn(shape, generator=gen, device=dev)
    scale_new[:, :64] = 2.0 ** -6          # fed / s exact on these rows
    k = torch.randint(-140, 140, (n_pods, 64, 128), generator=gen,
                      device=dev)
    fed[:, :64] = (k + 0.5) * 2.0 ** -6    # ties, and values past +-127
    slot_push = torch.zeros(shape, dtype=torch.int8, device=dev)
    scales_push = torch.zeros(shape[:2], device=dev)

    def run(impl):
        return ring_slot_rotate_int8(slot_pop, scales_pop, slot_push.clone(),
                                     scales_push.clone(), fed.clone(),
                                     scale_new, impl=impl)

    got = run("kernel")
    want = run("ref")
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max_abs_err(got, want)
    del got, want
    times = timed(
        lambda: ring_slot_rotate_int8(slot_pop, scales_pop, slot_push,
                                      scales_push, fed, scale_new,
                                      impl="kernel"),
        lambda: ring_slot_rotate_int8_ref(slot_pop, scales_pop, fed,
                                          scale_new),
        "slot_rotate_int8_kernel")
    n = n_pods * rows * 128
    b_ms, by = bound_ms(14 * n + 12 * n_pods * rows, 7 * n)
    return dict(rows=rows, pods=n_pods, bitwise=equal, max_abs_err=err,
                bound_ms=b_ms, bound_by=by, **times)


N_SLOTS = 9          # the stochastic main path's ring: tau_max = 8
DUE = {0: (), 1: (3,), 2: (2, 7)}


def check_variable_pop(int8, n_pods, rows, n_due, gen):
    """Kernel vs plain version of the masked pop (and its count /
    staleness epilogue) on a (9, n_pods, rows, 128) ring with ``n_due``
    slots due; slot 8, never due, holds an inf that must not reach the
    result. f32 also times ``torch.tensordot`` of the mask with the ring.
    """
    import torch
    from repro_torch.kernels.delay_ring.ops import ring_variable_pop
    from repro_torch.kernels.delay_ring.ref import (ring_variable_meta_ref,
                                                    ring_variable_pop_ref)
    dev = torch.device("cuda")
    shape = (N_SLOTS, n_pods, rows, 128)
    scales = None
    if int8:
        ring = torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
        scales = torch.rand(shape[:3], generator=gen, device=dev) + 1e-3
        scales[8, :, :2] = math.inf
    else:
        ring = torch.randn(shape, generator=gen, device=dev)
        ring[8, :, :2] = math.inf
    mask = torch.zeros(N_SLOTS, dtype=torch.bool, device=dev)
    mask[list(DUE[n_due])] = True
    cs = torch.stack([
        torch.randint(0, 300, (N_SLOTS,), generator=gen, device=dev),
        torch.randint(0, 9, (N_SLOTS,), generator=gen, device=dev)]).float()
    got = ring_variable_pop(ring, mask, scales, cs, impl="kernel")
    want = ring_variable_pop(ring, mask, scales, cs, impl="ref")
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    finite = bool(torch.isfinite(got[0]).all())
    err = max_abs_err(got, want)
    del got, want
    times = timed(
        lambda: ring_variable_pop(ring, mask, scales, cs, impl="kernel"),
        lambda: (ring_variable_pop_ref(ring, mask, scales),
                 ring_variable_meta_ref(mask, cs)),
        "variable_pop_kernel")
    library_ms = None
    if not int8:
        maskf = mask.float()
        library_ms = device_ms(lambda: torch.tensordot(maskf, ring,
                                                       dims=1))[0]
    n = n_pods * rows * 128
    slot_bytes = n + 4 * n_pods * rows if int8 else 4 * n
    b_ms, by = bound_ms(n_due * slot_bytes + 4 * n + 9 * N_SLOTS + 8,
                        n_due * n * (2 if int8 else 1))
    del ring, scales
    return dict(rows=rows, pods=n_pods, int8=int8, due=n_due, slots=N_SLOTS,
                bitwise=equal and finite, max_abs_err=err, bound_ms=b_ms,
                bound_by=by, library_ms=library_ms, **times)


def check_ring_rotate(int8, n_pods, rows, gen, tau=4):
    """Kernel vs plain version of the v1 rotate (pop ring[head], push in
    place) on a (tau, n_pods, rows, 128) ring, head on the card; under
    int8 fed puts some values on half-way points and past the clip."""
    import torch
    from repro_torch.kernels.delay_ring.ops import ring_push_pop
    from repro_torch.kernels.delay_ring.ref import ring_push_pop_ref
    dev = torch.device("cuda")
    shape = (tau, n_pods, rows, 128)
    head = torch.full((), 2, dtype=torch.int32, device=dev)
    fed = torch.randn(shape[1:], generator=gen, device=dev)
    scales = scale_new = None
    if int8:
        ring = torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
        scales = torch.rand(shape[:3], generator=gen, device=dev) + 1e-3
        scale_new = torch.rand(shape[1:3], generator=gen, device=dev) + 1e-3
        scale_new[:, :64] = 2.0 ** -6
        k = torch.randint(-140, 140, (n_pods, 64, 128), generator=gen,
                          device=dev)
        fed[:, :64] = (k + 0.5) * 2.0 ** -6
    else:
        ring = torch.randn(shape, generator=gen, device=dev)

    def run(impl):
        out = ring_push_pop(ring.clone(), fed.clone(), head,
                            None if scales is None else scales.clone(),
                            scale_new, impl=impl)
        return [x for x in out if x is not None]

    got, want = run("kernel"), run("ref")
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max_abs_err(got, want)
    del got, want
    times = timed(
        lambda: ring_push_pop(ring, fed, head, scales, scale_new,
                              impl="kernel"),
        lambda: ring_push_pop_ref(ring, fed, head, scales, scale_new),
        "ring_rotate_")
    n = n_pods * rows * 128
    n_bytes = (14 * n + 12 * n_pods * rows if int8 else 16 * n) + 4
    b_ms, by = bound_ms(n_bytes, 7 * n if int8 else 0)
    del ring, scales
    return dict(rows=rows, pods=n_pods, int8=int8, tau=tau, bitwise=equal,
                max_abs_err=err, bound_ms=b_ms, bound_by=by, library_ms=None,
                **times)


# the stochastic path's delay: heavy-tailed, capped at 8, with the seed
# benchmarks/delay_sweep.py uses
STOCHASTIC_DELAY = dict(process="heavy_tail", tau_max=8, seed=7)


def main_path_config(cfg=None):
    """The paper's linear regression at full width (Sec. VI-A), as
    ``examples/linreg_paper.py`` sets it up: (model config, (compression,
    delay) -> RunConfig); ``delay`` (DelayConfig fields) makes it the
    stochastic-delay path."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (AmbdgConfig, DelayConfig,
                                          MeshConfig, RunConfig, TRAIN_4K)
    cfg = cfg or get_config("amb-linreg")
    d = cfg.linreg_dim

    def rc(compression, delay=None):
        return RunConfig(
            model=cfg, shape=TRAIN_4K,
            mesh=MeshConfig(n_pods=1, data=1, model=1),
            ambdg=AmbdgConfig(t_p=2.5, t_c=10.0, tau=4, smoothness_L=1.0,
                              b_bar=800.0, proximal="l2_ball",
                              radius_C=1.05 * math.sqrt(d),
                              pod_compression=compression),
            delay=DelayConfig(**(delay or {})))
    return cfg, rc


def run_main_path(compression, device, cfg=None, delay=None):
    """One ``train`` run of the main path; returns (result, seconds)."""
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    cfg, rc = main_path_config(cfg)
    loop = LoopConfig(n_steps=MAIN_STEPS, n_workers=10,
                      samples_per_worker=150, use_timing_model=True,
                      log_every=1)
    t0 = time.perf_counter()
    out = train(build_model(cfg, device=device), rc(compression, delay),
                loop, device=device)
    return out, time.perf_counter() - t0


def arrivals(delay, tau=4):
    """(delays, arrivals per step) of the stochastic path's first
    MAIN_STEPS steps, from the port's delay process and delivery
    schedule (push s, 1-indexed, lands at step s + tau_s)."""
    from repro_torch.configs.base import DelayConfig
    from repro_torch.core.delay_process import make_delay_process
    from repro_torch.core.staleness import delivery_schedule
    delays = make_delay_process(DelayConfig(**delay),
                                tau).sequence(MAIN_STEPS).tolist()
    sched = delivery_schedule(delays)
    return delays, [len(sched.get(t + 1, [])) for t in range(MAIN_STEPS)]


def compare_devices(compression, gpu, cpu, arrived, radius, tau_max=None):
    """GPU vs CPU run of the same seed. ``arrived[t]``: the entries due
    at step t (``applied_count`` is 0 exactly where it is 0); under a
    stochastic delay ``tau_applied`` agrees exactly and is ``tau_max`` on
    the empty steps. applied_count is exact; loss and
    grad_norm agree to rtol 1e-4 (the f32 products sum their 10^4-term
    dot products in another order on each device, which moves the last
    bits); w to 1e-4 of its largest element, plus one quantization step
    (alpha * scale / count) under int8, where a last-bit difference can
    flip one rounding. w lies in the l2 ball of ``radius`` (the prox's
    constraint). With a fixed tau the loss falls over the run; under a
    stochastic delay it need not in 12 steps, and is not checked."""
    import numpy as np
    import torch
    hg, hc = gpu["history"], cpu["history"]
    assert len(hg) == len(hc) == MAIN_STEPS, (len(hg), len(hc))
    for t, (a, b) in enumerate(zip(hg, hc)):
        assert a["applied_count"] == b["applied_count"], (t, a, b)
        if not arrived[t]:
            assert a["applied_count"] == 0.0, (t, a)
        else:
            assert a["applied_count"] > 0.0, (t, a)
        if tau_max is not None:       # the stochastic path
            assert a["tau_applied"] == b["tau_applied"], (t, a, b)
            if not arrived[t]:
                assert a["tau_applied"] == tau_max, (t, a)
        for key in ("loss", "grad_norm"):
            assert math.isfinite(a[key]), (t, key, a)
            assert math.isclose(a[key], b[key], rel_tol=1e-4,
                                abs_tol=1e-30), (t, key, a[key], b[key])
    wg = gpu["state"].params["w"].cpu().numpy()
    wc = cpu["state"].params["w"].numpy()
    assert wg.shape == wc.shape == (gpu["state"].params["w"].numel(),)
    assert np.all(np.isfinite(wg))
    tol = 1e-4 * float(np.abs(wc).max())
    if compression == "int8":
        ar = cpu["state"].arena
        step = max(float(s.max()) for s in ar.scales) / min(
            h["applied_count"] for h in hc if h["applied_count"])
        tol += step          # alpha < 1
    diff = float(np.abs(wg - wc).max())
    assert diff <= tol, (compression, diff, tol)
    norm = float(np.linalg.norm(wg.astype(np.float64)))
    assert norm <= radius * (1 + 1e-5), (norm, radius)
    if tau_max is None:
        # the run learns: the loss falls once the delayed updates land
        assert hg[-1]["loss"] < hg[0]["loss"], (hg[0]["loss"],
                                                hg[-1]["loss"])
    return diff, tol


def step_split(out, kernels):
    """Where a main-path step's time goes, from that run's own history
    (every step logged): medians over the steps after the first of the
    host batch, its copy to the card and the step up to its metrics read
    back (host clock). From ``kernels``, the profiler's record of the
    whole run (state set-up included): the card's kernel time and its
    copy time (memcpy/memset) per step, and the share of the run's wall
    time in which no kernel ran (the device's idle share)."""
    hist = out["history"][1:]
    med = {k: statistics.median(h[k] for h in hist) * 1e3
           for k in ("batch_s", "h2d_s", "step_s")}
    copy_ms = sum(us for k, us in kernels
                  if k.startswith(("Memcpy", "Memset"))) / 1e3
    kernel_ms = sum(us for _, us in kernels) / 1e3 - copy_ms
    wall_ms = out["history"][-1]["wall_s"] * 1e3
    n_steps = len(out["history"])
    return dict(host_batch_ms=med["batch_s"], h2d_ms=med["h2d_s"],
                device_step_ms=med["step_s"], step_ms=sum(med.values()),
                device_kernel_ms=kernel_ms / n_steps,
                device_copy_ms=copy_ms / n_steps,
                device_idle_share=1.0 - kernel_ms / wall_ms,
                steps=len(hist))


def split_run(compression, delay=None):
    """A run of the main path again, for its step split, when the
    profiler recorded nothing in the run whose launches were counted:
    (result, seconds, kernels), running it up to PROFILER_TRIES times."""
    for _ in range(PROFILER_TRIES):
        (out, secs), kernels = profiled(
            lambda: run_main_path(compression, "cuda", delay=delay))
        if kernels:
            log(f"note: the step split of {compression} comes from a "
                "second run of the same seed")
            return out, secs, kernels
    raise RuntimeError(f"torch.profiler recorded no device time in "
                       f"{PROFILER_TRIES} runs of the main path")


def master_update_without_sync(out, compression, cfg=None):
    """One master update of the stochastic path on the card (the v3 ring
    push and pop, then dual averaging), continued from a run's final
    state, under ``torch.cuda.set_sync_debug_mode("error")``: any read
    back to the host raises. A first update outside the check warms the
    layout's device caches."""
    import torch
    from repro_torch.core import arena as arena_mod
    from repro_torch.optim import make_arena_optimizer
    cfg, rc = main_path_config(cfg)
    rc = rc(compression, STOCHASTIC_DELAY)
    state = out["state"]
    dev = state.arena.ring.device
    layout = arena_mod.make_layout(state.params)
    opt = make_arena_optimizer(rc, layout, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    arena, opt_state = state.arena, state.opt_state

    def update(delay, check):
        nonlocal arena, opt_state
        grads = {k: torch.randn((1,) + tuple(v.shape), generator=gen,
                                device=dev) for k, v in state.params.items()}
        counts = torch.full((1,), 1000.0, device=dev)
        delay = torch.full((), delay, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if check else 0)
        try:
            g_sum, count, tau_obs, arena = arena_mod.push_pop_variable(
                layout, arena, grads, counts, delay, compression)
            params, opt_state = opt.update(opt_state, state.params, g_sum,
                                           count, tau_obs=tau_obs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return params

    update(0, check=False)
    params = update(0, check=True)     # tau_t = 0: delivered at once
    assert all(bool(torch.isfinite(v).all()) for v in params.values())
    return True


def v1_phase(compression, device, cfg=None, tau=4):
    """``core.arena.push_pop`` on a v1 (stacked) ring beside a v2 ring at
    the main path's arena for tau + 3 steps from the same gradients:
    the pops and counts agree bit for bit; then ``convert_ring`` of the
    v1 ring gives back the v2 ring's live slots. Returns the number of
    steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import arena as arena_mod
    cfg = cfg or get_config("amb-linreg")
    params = {"b": torch.zeros((), device=device),
              "w": torch.zeros((cfg.linreg_dim,), device=device)}
    layout = arena_mod.make_layout(params)
    v1 = arena_mod.init_arena(layout, tau, 1, compression, device=device,
                              ring_version=1)
    v2 = arena_mod.init_arena(layout, tau, 1, compression, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    for t in range(tau + 3):
        grads = {k: torch.randn((1,) + tuple(v.shape), generator=gen,
                                device=device) * 30
                 for k, v in params.items()}
        counts = torch.full((1,), 100.0 + t, device=device)
        g1, c1, v1 = arena_mod.push_pop(layout, v1, grads, counts,
                                        compression)
        g2, c2, v2 = arena_mod.push_pop(layout, v2, grads, counts,
                                        compression)
        assert torch.equal(g1, g2) and torch.equal(c1, c2), (compression, t)
        assert (float(c1) == 0.0) == (t < tau), (t, float(c1))
    back = arena_mod.convert_ring(v1, 2)
    for k in range(1, tau + 1):
        src = (k + v2.phase) % (tau + 1)
        assert torch.equal(back.ring[k], v2.ring[src]), (compression, k)
        assert torch.equal(back.counts[k], v2.counts[src])
    return tau + 3


# -- flash attention (phase 2) -------------------------------------------------
N_FLASH_TIMED = 5
# mixtral-8x7b's attention at the length phase 17 trains (one sequence of
# 8192: 32 query heads on 8 kv heads of 128, a window of 4096), the
# kernels' first rows past S = 4096; timed in bf16, checked in f32 too
MIX_FLASH = ("mixtral-8x7b", 1, 32, 8, 8192, 8192, 128, 4096)
# (label, B, Hq, Hkv, Sq, Skv, D, window); causal, bf16. The first is the
# main path's (qwen1.5-0.5b at train_4k, one microbatch of 2 sequences)
FLASH_SHAPES = [
    ("qwen1.5-0.5b", 2, 16, 16, 4096, 4096, 64, None),
    ("qwen3-1.7b", 1, 16, 8, 4096, 4096, 128, None),
    ("yi-6b", 1, 32, 4, 4096, 4096, 128, None),
    ("window-1024", 1, 16, 16, 4096, 4096, 64, 1024),
    ("right-aligned", 2, 16, 16, 256, 512, 64, None),
    MIX_FLASH,
]
# correctness only, bf16: the edges of the Hopper kernels' tiles and
# masks, rows with no valid key (Sq > Skv), a ragged GQA length (192: a
# part-filled last tile of every kernel), a window at D = 128
FLASH_BF16_EDGES = [
    ("no-valid-key", 1, 2, 2, 256, 128, 64, None),
    ("gqa-ragged", 1, 8, 2, 192, 192, 128, None),
    ("gqa-d128", 1, 8, 2, 512, 512, 128, 200),
]
# non-causal (every query over every key), bf16, timed: seamless-m4t's
# encoder self-attention at train_4k (16/16 heads of 64, one microbatch
# of 2 sequences); its decoder's cross-attention has the same shape
FLASH_NONCAUSAL = [
    ("seamless-encoder", 2, 16, 16, 4096, 4096, 64, None),
]
# non-causal, correctness only: the cross-attention with a target shorter
# and longer than the source (ragged last tiles in both walks), bf16; the
# encoder's shape in f32
FLASH_NONCAUSAL_EDGES = [
    ("cross-short-target", 1, 16, 16, 320, 4096, 64, None),
    ("cross-long-target", 1, 16, 16, 4096, 1000, 64, None),
]
FLASH_NONCAUSAL_F32 = [
    ("seamless-encoder", 2, 16, 16, 4096, 4096, 64, None),
]
# correctness only, f32: the main path's shape and the GQA shapes, rows
# with no valid key (Sq > Skv), a window at D = 128
FLASH_F32 = [
    ("qwen1.5-0.5b", 2, 16, 16, 4096, 4096, 64, None),
    ("qwen3-1.7b", 1, 16, 8, 4096, 4096, 128, None),
    ("yi-6b", 1, 32, 4, 4096, 4096, 128, None),
    ("no-valid-key", 1, 2, 2, 256, 128, 64, None),
    ("gqa-d128", 1, 8, 2, 512, 512, 128, 200),
    MIX_FLASH,
]
# kernel vs plain version, element by element. Both compute in f32 and
# round each output once to its dtype, so an element may differ by the
# two f32 results' difference (summation order; at most FLASH_F32_TOL of
# the tensor's largest element: the f32 rows above read up to 1.2e-6)
# plus one ulp of the output's dtype (2^-7 of the element in bf16, none
# in f32). limit(x) = FLASH_ULP * |want(x)| + FLASH_F32_TOL * max |want|
FLASH_ULP = {"bfloat16": 2.0 ** -7, "float32": 0.0}
FLASH_F32_TOL = 1e-5
# the kernels' names in csrc: bf16 the Hopper kernels, f32 the CUDA-core
FLASH_SYMBOLS = {
    "bfloat16": {"fwd": "flash_fwd_wgmma", "fwd_lse": "flash_fwd_wgmma",
                 "dq": "flash_bwd_dq_wgmma", "dkv": "flash_bwd_dkv_wgmma"},
    "float32": {"fwd": "flash_fwd_kernel", "fwd_lse": "flash_fwd_kernel",
                "dq": "flash_bwd_dq_kernel", "dkv": "flash_bwd_dkv_kernel"}}
# the head dims the kernels were widened to, timed in bf16 and in f32:
# zamba2-2.7b's shared block at train_4k (one microbatch of 2 sequences,
# 32/32 heads of 80, the tile read as 128 columns) and paligemma-3b's
# head layout (8 query heads on 1 kv head of 256; causal, as the kernels
# take no prefix-LM mask, so no model path runs it yet)
FLASH_HEAD_DIMS = [
    ("zamba2-shared", 2, 32, 32, 4096, 4096, 80, None),
    ("paligemma", 1, 8, 1, 4096, 4096, 256, None),
]


def flash_err(got, want, ulp):
    """(the largest |got - want| over its element's limit (see FLASH_ULP;
    at most 1 passes), max |got - want|, that over max |want|)."""
    ratio = err = rel = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        top = float(w.abs().max()) or 1.0
        diff = (g - w).abs()
        ratio = max(ratio, float((diff / (ulp * w.abs()
                                          + FLASH_F32_TOL * top)).max()))
        err = max(err, float(diff.max()))
        rel = max(rel, float(diff.max()) / top)
    return ratio, err, rel


def flash_bound(kind, B, Hq, Hkv, Sq, Skv, D, n_pairs, elt):
    """The least time for one call: every input read once, every output
    written once, at 3.35 TB/s; the products it must do over the
    attended (query, key) pairs at 989 TFLOP/s bf16 on the tensor cores
    (67 TFLOP/s for the f32 kernels' CUDA-core FMAs) (forward 2 of them,
    4 n D flops; dq 3, as S = q k^T, dP = do v^T and dq = dS k; dk/dv 2,
    dv = P^T do and dk = dS^T q: the backward is 2.5x the forward)."""
    q_b, kv_b, row_b = B * Hq * Sq * D * elt, B * Hkv * Skv * D * elt, \
        B * Hq * Sq * 4
    n_bytes, n_mm = {
        "fwd": (2 * q_b + 2 * kv_b, 2),
        "fwd_lse": (2 * q_b + 2 * kv_b + row_b, 2),
        "dq": (3 * q_b + 2 * kv_b + 2 * row_b, 3),
        "dkv": (2 * q_b + 4 * kv_b + 2 * row_b, 2),
    }[kind]
    return bound_ms(n_bytes, 2 * n_mm * B * Hq * n_pairs * D,
                    BF16_FLOPS_PER_S if elt == 2 else F32_FLOPS_PER_S)


def log_flash_row(r):
    times = ("" if "ms" not in r else
             f" ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
             f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
             f"library_ms={r['library_ms']:.4f} library_fwd_bwd_ms="
             f"{r['library_fwd_bwd_ms']:.4f} wrapper_ms="
             f"{r['wrapper_ms']:.4f}")
    log(f"phase 2: flash {r['kernel']} {r['label']} {r['dtype']} "
        f"B={r['B']} H={r['Hq']}/{r['Hkv']} S={r['Sq']}/{r['Skv']} "
        f"D={r['D']} causal={r['causal']} window={r['window']}: "
        f"bitwise-repeat="
        f"{r['bitwise']} max_abs_err={r['max_abs_err']:.3e} rel_err="
        f"{r['rel_err']:.3e} err/limit={r['err_over_limit']:.3f} "
        f"<= 1{times}")


def check_flash(label, B, Hq, Hkv, Sq, Skv, D, window, dtype, gen,
                timed_run=True, causal=True):
    """The four flash kernels against their plain versions at one shape
    (causal, or every query over every key): errors, bitwise repeat, and
    (``timed_run``) the kernel, plain and SDPA times with the bound over
    the attended pairs. Returns one dict per kernel."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref
    dev = torch.device("cuda")
    q = torch.randn((B, Hq, Sq, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Hkv, Skv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Hkv, Skv, D), generator=gen, device=dev).to(dtype)
    do = torch.randn((B, Hq, Sq, D), generator=gen, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, scale=D ** -0.5)
    runs = {
        "fwd": (lambda: (fa.flash_attention_fwd(q, k, v, **kw),),
                lambda: (ref.attention_ref(q, k, v, causal=causal,
                                           window=window),)),
        "fwd_lse": (lambda: fa.flash_fwd_lse(q, k, v, **kw),
                    lambda: ref.flash_fwd_lse_ref(q, k, v, **kw)),
    }
    o, lse = fa.flash_fwd_lse(q, k, v, **kw)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    bargs = (q, k, v, lse, delta, do)
    runs["dq"] = (lambda: (fa.flash_bwd_dq(*bargs, **kw),),
                  lambda: (ref.flash_bwd_dq_ref(*bargs, **kw),))
    runs["dkv"] = (lambda: fa.flash_bwd_dkv(*bargs, **kw),
                   lambda: ref.flash_bwd_dkv_ref(*bargs, **kw))
    mask = ref.attention_mask(Sq, Skv, causal, window, dev)
    n_pairs = int(mask.sum())
    ulp = FLASH_ULP[str(dtype).split(".")[-1]]
    sdpa_kw = dict(enable_gqa=Hq != Hkv)
    if not causal and window is None:
        pass                # SDPA's default: every query over every key
    elif Sq == Skv and window is None:
        sdpa_kw["is_causal"] = True
    else:   # SDPA's is_causal is top-left aligned: pass the mask itself
        sdpa_kw["attn_mask"] = mask
    lib = {}
    if timed_run:
        lib["fwd"] = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, **sdpa_kw), n=N_FLASH_TIMED)[0]
        qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))
        o_s = F.scaled_dot_product_attention(qr, kr, vr, **sdpa_kw)
        lib["bwd"] = device_ms(lambda: torch.autograd.grad(
            o_s, (qr, kr, vr), do, retain_graph=True), n=N_FLASH_TIMED)[0]
        lib["fwd_bwd"] = device_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qr, kr, vr, **sdpa_kw),
            (qr, kr, vr), do), n=N_FLASH_TIMED)[0]
        del o_s, qr, kr, vr
    out = []
    for kind, (kern, plain) in runs.items():
        got = kern()
        again = kern()
        want = plain()
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        ratio, err, rel = flash_err(got, want, ulp)
        if kind == "fwd_lse":   # lse is f32 in both: its own check
            ratio, err, rel = flash_err(got[:1], want[:1], ulp)
            lse_err = float((got[1] - want[1]).abs().max())
            assert lse_err <= 1e-4 * max(1.0, float(want[1][want[1] > -1e29]
                                                    .abs().max())), lse_err
        del got, again, want
        r = dict(kernel=kind, label=label, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq,
                 Skv=Skv, D=D, window=window, dtype=str(dtype).split(".")[-1],
                 causal=causal, bitwise=bitwise, max_abs_err=err, rel_err=rel,
                 err_over_limit=ratio)
        if timed_run:
            r.update(timed(kern, plain, FLASH_SYMBOLS[r["dtype"]][kind],
                           n=N_FLASH_TIMED))
            b_ms, by = flash_bound(kind, B, Hq, Hkv, Sq, Skv, D, n_pairs,
                                   q.element_size())
            r.update(bound_ms=b_ms, bound_by=by, n_pairs=n_pairs,
                     library_ms=lib["fwd"] if kind.startswith("fwd")
                     else lib["bwd"], library_fwd_bwd_ms=lib["fwd_bwd"])
        torch.cuda.empty_cache()
        out.append(r)
    return out


def head_dim_flash_rows(gen):
    """Phase 2's rows at the widened head dims (FLASH_HEAD_DIMS), each
    timed in bf16 and in f32. Returns the rows."""
    import torch
    return [r for shape in FLASH_HEAD_DIMS
            for dtype in (torch.bfloat16, torch.float32)
            for r in check_flash(*shape, dtype, gen)]


def noncausal_flash_rows(gen):
    """Phase 2's non-causal rows: FLASH_NONCAUSAL timed in bf16 (SDPA
    with ``is_causal=False`` the library time), FLASH_NONCAUSAL_EDGES in
    bf16 and FLASH_NONCAUSAL_F32 in f32, untimed. Returns the rows."""
    import torch
    rows = []
    for shapes, dtype, timed_run in (
            (FLASH_NONCAUSAL, torch.bfloat16, True),
            (FLASH_NONCAUSAL_EDGES, torch.bfloat16, False),
            (FLASH_NONCAUSAL_F32, torch.float32, False)):
        for shape in shapes:
            rows += check_flash(*shape, dtype, gen, timed_run=timed_run,
                                causal=False)
    return rows


# -- the linear scan and the pytree dual update (phase 2) ---------------------
# the plain recurrence at the main shape is 4096 sequential steps, 0.47
# s a call of host launches: one call timed (it has just run once)
N_SCAN_TIMED, N_SCAN_PLAIN = 5, 1
SCAN_SYMBOL = "linear_scan_"   # every kernel of a call
# the main path's scan (zamba2 at train_4k, one microbatch of 2 sequences:
# 2 x 80 heads of 64, one B/C group of d_state 64, chunk 256; ssd_mamba2
# feeds bf16 q, k and an f32 v = x dt): (label, BH, BHG, S, ds, hd, chunk,
# q/k dtype, v dtype)
SCAN_MAIN = ("zamba2", 160, 2, 4096, 64, 64, 256, "bfloat16", "float32")
# JAX's test shapes (tests/test_kernels.py:41-45), f32 and bf16, untimed
SCAN_JAX = [("jax-a", 4, 4, 256, 32, 64, 128), ("jax-b", 6, 2, 256, 16, 32, 64),
            ("jax-c", 2, 2, 512, 64, 64, 128)]
# the edges of the chunk-parallel kernels, untimed: a chunk that is not a
# multiple of 8 at ds 128, hd 128 (two column slices), one chunk (no state
# pass), chunk 32, the largest tiles (f32 ds = hd = 128)
SCAN_EDGES = [("ragged", 3, 1, 90, 128, 16, 45, "float32", "float32"),
              ("hd128", 4, 2, 512, 64, 128, 128, "bfloat16", "float32"),
              ("one-chunk", 2, 2, 256, 32, 32, 256, "float32", "float32"),
              ("chunk32", 4, 1, 512, 16, 64, 32, "bfloat16", "bfloat16"),
              ("ds128", 2, 1, 384, 128, 128, 128, "float32", "float32")]
# kernel vs plain recurrence, element by element. Both keep an f32 state
# and round y once to its dtype; the chunked form sums in another order.
# limit(x) = SCAN_ULP * |want(x)| + SCAN_F32_TOL * max |want| (SCAN_F32_TOL
# about ten times the reading over the main path's four calls, 3.3e-7 of
# the largest element, NVIDIA H100 80GB HBM3, 700 W)
SCAN_ULP = {"bfloat16": 2.0 ** -7, "float32": 0.0}
SCAN_F32_TOL = 3e-6


def scan_err(got, want, ulp):
    """(max |got - want| over its element's limit, max |got - want|, that
    over max |want|)."""
    g, w = got.float(), want.float()
    top = float(w.abs().max()) or 1.0
    diff = (g - w).abs()
    return (float((diff / (ulp * w.abs() + SCAN_F32_TOL * top)).max()),
            float(diff.max()), float(diff.max()) / top)


def scan_bound(BH, BHG, S, ds, hd, chunk, strict, with_inter, q_elt, v_elt):
    """The least time for one call: g, q, k and v read once and y (and
    the f32 inter-chunk part) written once at 3.35 TB/s; the chunked form's products (per head and chunk of
    L: the L(L+1)/2 scores, L(L-1)/2 when strict, of ds each and their
    product with v, hd each; the inter-chunk term and the state update,
    L ds hd each) at the tensor-core rate of the operands: bf16 when all
    are bf16, else TF32."""
    n_bytes = (4 * BH * S + 2 * BHG * S * ds * q_elt + 2 * BH * S * hd * v_elt
               + (4 * BH * S * hd if with_inter else 0))
    pairs = chunk * (chunk - 1 if strict else chunk + 1) // 2
    flops = 2 * BH * (S // chunk) * (pairs * (ds + hd) + 2 * chunk * ds * hd)
    rate = BF16_FLOPS_PER_S if q_elt == v_elt == 2 else TF32_FLOPS_PER_S
    return bound_ms(n_bytes, flops, rate)


def scan_main_forms(gen):
    """The main path's four scan calls at SCAN_MAIN: the forward, and the
    backward's dv, dk and dq forms on the operands ``scan_backward``
    gives them for a random cotangent. Returns [(form, g, q, k, v,
    strict, with_inter)]."""
    import torch
    from repro_torch.kernels.linear_scan.ops import scan_backward
    _, BH, BHG, S, ds, hd, _, qd, vd = SCAN_MAIN
    dev = torch.device("cuda")
    g = -torch.rand((BH, S), generator=gen, device=dev) * 0.2
    q = torch.randn((BHG, S, ds), generator=gen, device=dev).to(
        getattr(torch, qd))
    k = (torch.randn((BHG, S, ds), generator=gen, device=dev) * 0.1).to(
        getattr(torch, qd))
    v = torch.randn((BH, S, hd), generator=gen, device=dev).to(
        getattr(torch, vd))
    dy = torch.randn((BH, S, hd), generator=gen, device=dev)
    calls = []

    def record(*a):   # (g, q, k, v, strict, with_inter): v stands for y
        calls.append(a)
        return (a[3], a[3]) if a[5] else a[3]

    scan_backward(record, g, q, k, v, dy, SCAN_MAIN[6])
    return [("fwd", g, q, k, v, False, False)] + [
        (form, *c) for form, c in zip(("bwd_dv", "bwd_dk", "bwd_dq"), calls)]


def check_scan(form, label, g, q, k, v, strict, with_inter, chunk, timed_run):
    """The scan kernel against its plain recurrence at one call's
    operands (y, and with ``with_inter`` its inter-chunk part): element
    errors, a bitwise repeat, and (``timed_run``) the kernel, wrapper and
    plain times with the bound."""
    import torch
    from repro_torch.kernels.linear_scan import kernel as sk
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref
    counter = sk.FWD if form in ("fwd", "strict") else sk.BWD

    def kern():
        out = sk.linear_scan_fwd(g, q, k, v, chunk=chunk, strict=strict,
                                 with_inter=with_inter, counter=counter)
        return out if with_inter else (out,)

    def plain():
        out = linear_scan_ref(g, q, k, v, strict,
                              chunk if with_inter else None)
        return out if with_inter else (out,)

    got, again, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    ulp = SCAN_ULP[str(v.dtype)[6:]]
    errs = [scan_err(a, b, u) for a, b, u in zip(got, want, (ulp, 0.0))]
    ratio, err, rel = (max(e[i] for e in errs) for i in range(3))
    BH, S = g.shape
    BHG, _, ds = q.shape
    hd = v.shape[-1]
    r = dict(kernel=form, label=label, BH=BH, BHG=BHG, S=S, ds=ds, hd=hd,
             chunk=chunk, strict=strict, qk_dtype=str(q.dtype)[6:],
             v_dtype=str(v.dtype)[6:], with_inter=with_inter,
             bitwise=all(torch.equal(a, b) for a, b in zip(got, again)),
             max_abs_err=err, rel_err=rel, err_over_limit=ratio,
             library_ms=None)
    del got, again, want
    if timed_run:
        per_call = sk.kernels_per_call(S, chunk)
        ms, names = device_ms(kern, n=N_SCAN_TIMED, match=SCAN_SYMBOL,
                              per_call=per_call)
        plain_ms, plain_names = device_ms(plain, n=N_SCAN_PLAIN, warmup=0)
        b_ms, by = scan_bound(BH, BHG, S, ds, hd, chunk, strict, with_inter,
                              q.element_size(), v.element_size())
        r.update(ms=ms, plain_ms=plain_ms, kernels=names,
                 kernels_per_call=per_call,
                 plain_kernels=len(plain_names),
                 wrapper_ms=cuda_ms(kern, n=N_SCAN_TIMED),
                 plain_wrapper_ms=cuda_ms(plain, n=N_SCAN_PLAIN, warmup=0),
                 bound_ms=b_ms, bound_by=by)
    torch.cuda.empty_cache()
    return r


def check_scan_rows(gen):
    """Every scan row of phase 2: the main path's four calls (timed), then
    JAX's shapes and the edge shapes (untimed), forward and strict with
    the inter-chunk part. Returns the results, the main forward first."""
    import torch
    rows = []
    for form, *ops in scan_main_forms(gen):
        rows.append(check_scan(form, SCAN_MAIN[0], *ops, SCAN_MAIN[6],
                               timed_run=True))
        del ops
        torch.cuda.empty_cache()
    shapes = ([(*s, dt, dt) for s in SCAN_JAX
               for dt in ("float32", "bfloat16")] + SCAN_EDGES)
    for label, BH, BHG, S, ds, hd, chunk, qd, vd in shapes:
        g = -torch.rand((BH, S), generator=gen, device="cuda") * 0.2
        q, k = (torch.randn((BHG, S, ds), generator=gen,
                            device="cuda").to(getattr(torch, qd))
                for _ in range(2))
        v = torch.randn((BH, S, hd), generator=gen, device="cuda").to(
            getattr(torch, vd))
        for strict in (False, True):
            rows.append(check_scan("fwd" if not strict else "strict",
                                   label, g, q, k, v, strict, strict,
                                   chunk, timed_run=False))
    return rows


def log_scan_row(phase, r):
    times = ("" if "ms" not in r else
             f" ms={r['ms']:.4f} ({r['kernels_per_call']} kernels) "
             f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
             f"({r['bound_by']}) wrapper_ms={r['wrapper_ms']:.4f} "
             f"plain_wrapper_ms={r['plain_wrapper_ms']:.4f}")
    log(f"{phase}: scan {r['kernel']} {r['label']} BH={r['BH']} "
        f"BHG={r['BHG']} S={r['S']} ds={r['ds']} hd={r['hd']} chunk="
        f"{r['chunk']} strict={r['strict']} with_inter={r['with_inter']} "
        f"{r['qk_dtype']}/"
        f"{r['v_dtype']}: bitwise-repeat={r['bitwise']} max_abs_err="
        f"{r['max_abs_err']:.3e} rel_err={r['rel_err']:.3e} "
        f"err/limit={r['err_over_limit']:.3f} <= 1{times}")


def check_dual_update_pytree(rows, gen):
    """The unnormalized update's kernel against its plain version on a
    (rows, 128) arena, bitwise, with the times; ``pytree_ms``: the
    pytree wrapper (flatten, the kernel, unflatten) on a two-leaf tree
    of as many elements."""
    import torch
    from repro_torch.kernels.dual_update.kernel import dual_update_fwd
    from repro_torch.kernels.dual_update.ops import dual_update
    from repro_torch.kernels.dual_update.ref import dual_update_ref
    dev = torch.device("cuda")
    z = torch.randn((rows, 128), generator=gen, device=dev)
    g = torch.randn((rows, 128), generator=gen, device=dev) * 300
    alpha = torch.full((), 1.0 / (1.0 + math.sqrt(11 / 800)), device=dev)
    zk, wk = dual_update_fwd(z.clone(), g, alpha)
    zr, wr = dual_update_ref(z, g, alpha)
    torch.cuda.synchronize()
    equal = torch.equal(zk, zr) and torch.equal(wk, wr)
    err = max_abs_err((zk, wk), (zr, wr))
    del zk, wk, zr, wr
    times = timed(lambda: dual_update_fwd(z, g, alpha),
                  lambda: dual_update_ref(z, g, alpha), "dual_update_kernel")
    flat_z, flat_g = z.view(-1), g.view(-1)
    tz = {"a": flat_z[:-1000], "b": flat_z[-1000:]}
    tg = {"a": flat_g[:-1000], "b": flat_g[-1000:]}
    pytree_ms = cuda_ms(lambda: dual_update(tz, tg, alpha))
    n = rows * 128
    b_ms, by = bound_ms(16 * n + 4, 2 * n)
    del z, g, tz, tg, flat_z, flat_g
    torch.cuda.empty_cache()
    return dict(rows=rows, pods=1, bitwise=equal, max_abs_err=err,
                bound_ms=b_ms, bound_by=by, library_ms=None,
                pytree_ms=pytree_ms, **times)


# -- the LM slice (phases 6 and 7) ---------------------------------------------
LM_STEPS = 5
LM_LAYERS = 8         # of the 24: full width, cut in depth for time
LM_RADIUS = 100.0     # the l2 ball of the dual-averaging prox
# Flash (the kernels) against xla (gqa_attend) on the card. After the
# first, empty pop dual averaging sets w = -alpha z = 0, so only step 0
# of a run sees the init weights: the worker's gradient and a no-grad
# eval are held at those weights, leaf by leaf. Each limit is about ten
# times the reading it was set from (NVIDIA H100 80GB HBM3, 700 W):
# f32 compute: both compute attention in f32 and differ in summation
# order only; gradient leaves to LM_F32_GRAD_TOL of the leaf's largest
# element (read: at most 8.6e-7), losses to LM_F32_RTOL (read: equal in
# phase 6, 2.9e-7 card vs CPU in phase 7).
LM_F32_GRAD_TOL = 1e-5
LM_F32_RTOL = 3e-6
# bf16 compute: gqa_attend rounds its scores and weights to bf16 where
# the kernels keep f32. Each gradient leaf's distance to the f32 xla
# gradient (over that leaf's largest element, read: 1.9e-3 to 2.2e-2
# for both) is at most LM_BF16_GRAD_RATIO times the bf16 xla gradient's
# (read: at most 1.34, ln_final); the per-step training loss and the
# eval losses agree to LM_BF16_RTOL (read: at most 2.2e-5, step 0).
LM_BF16_GRAD_RATIO = 2.0
LM_BF16_RTOL = 1e-4
# phase 7, f32, the card's flash kernels against the CPU's plain
# version: gradient leaves at the init weights (read: at most 1.07e-5)
LM_DEVICE_GRAD_TOL = 1e-4


def lm_config(attn_impl, **kw):
    """qwen1.5-0.5b FULL at LM_LAYERS layers with ``attn_impl`` (and any
    overrides)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen1.5-0.5b"),
                               attn_impl=attn_impl, block_remat="full",
                               **{"n_layers": LM_LAYERS, **kw})


def lm_run_config(cfg, seq_len, n_seqs, n_mb, tau=2):
    from repro_torch.configs.base import (AmbdgConfig, MeshConfig, RunConfig,
                                          ShapeConfig)
    return RunConfig(
        model=cfg, shape=ShapeConfig("train", seq_len, n_seqs, "train"),
        mesh=MeshConfig(n_pods=1, data=1, model=1),
        ambdg=AmbdgConfig(tau=tau, n_microbatches=n_mb, b_bar=float(n_seqs),
                          proximal="l2_ball", radius_C=LM_RADIUS,
                          pod_compression="int8"))


def run_lm(cfg, rc, n_steps, n_workers, device, samples_per_worker=2,
           model=None):
    """One ``train`` run of the LM slice (of ``model``, by default
    ``cfg``'s); returns (result, seconds)."""
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    loop = LoopConfig(n_steps=n_steps, n_workers=n_workers,
                      samples_per_worker=samples_per_worker, log_every=1)
    t0 = time.perf_counter()
    out = train(model or build_model(cfg, device=device), rc, loop,
                device=device)
    return out, time.perf_counter() - t0


def leaf_names(tree, prefix=""):
    """The paths of a nested dict's leaves, in ``tree_flatten``'s order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def model_grads(cfg, params, batch):
    """The worker's gradient sum of ``cfg``'s model at ``params`` on one
    microbatch (``accumulate_scan``, as a train step's worker computes
    it): (its f32 leaves in the arena's order, the loss per token or
    image)."""
    from repro_torch.core.anytime import accumulate_scan
    from repro_torch.core.arena import tree_flatten
    from repro_torch.models.api import build_model
    model = build_model(cfg, device=batch["weights"].device)
    g, count, m = accumulate_scan(model.loss, params, batch, 1)
    return tree_flatten(g)[0], float(m["loss_sum"]) / float(count)


# the key bias adds q . bk to every score of a row, which the softmax
# cancels: its exact gradient is 0 and what is computed is rounding
# noise, held against the query bias's largest element instead
SCALE_LEAF = {"layers/attn/bk": "layers/attn/bq"}


def leaf_gaps(got, want, names):
    """Per leaf: max |got - want| over the leaf's largest |want| (for
    the leaves of SCALE_LEAF, that of the leaf named there)."""
    top = {n: float(w.abs().max()) or 1.0 for n, w in zip(names, want)}
    return [float((g.float() - w.float().to(g.device)).abs().max())
            / top[SCALE_LEAF.get(n, n)] for n, g, w in zip(names, got, want)]


def lm_norm(params):
    import torch
    from repro_torch.core.arena import tree_flatten
    return math.sqrt(sum(float(torch.sum(torch.square(x.double())))
                         for x in tree_flatten(params)[0]))


def lm_weights_ok(params):
    """w finite and inside the l2 ball of LM_RADIUS."""
    import torch
    from repro_torch.core.arena import tree_flatten
    assert all(bool(torch.isfinite(x).all())
               for x in tree_flatten(params)[0])
    norm = lm_norm(params)
    assert norm <= LM_RADIUS * (1 + 1e-5), norm
    return norm


REST_TOP = 15          # the largest kernels of the rest, by name
REST_NAME_CHARS = 160  # a kernel's name in that list, cut to this


def kernel_split(kernels, n_steps):
    """The profiler's device time per step, split into the flash
    kernels, the linear-scan kernels (all ``linear_scan_*``),
    cuBLAS/CUTLASS products and the rest (copies apart); and the rest's
    REST_TOP largest kernels by name, ms per step and launches per
    step."""
    groups, rest, rest_n = (collections.Counter() for _ in range(3))
    for name, us in kernels:
        if name.startswith(("Memcpy", "Memset")):
            g = "copy"
        elif "flash_" in name:
            g = "attention"
        elif "linear_scan_" in name:
            g = "scan"
        elif any(t in name.lower() for t in ("gemm", "cutlass", "nvjet",
                                             "xmma", "cublas")):
            g = "cublas"
        else:
            g = "rest"
            rest[name[:REST_NAME_CHARS]] += us / 1e3 / n_steps
            rest_n[name[:REST_NAME_CHARS]] += 1 / n_steps
        groups[g] += us / 1e3 / n_steps
    total = sum(v for k, v in groups.items() if k != "copy")
    return dict({f"{k}_ms": groups.get(k, 0.0)
                 for k in ("attention", "scan", "cublas", "rest", "copy")},
                attention_share=groups.get("attention", 0.0) / total
                if total else 0.0,
                scan_share=groups.get("scan", 0.0) / total if total else 0.0,
                rest_top=[dict(name=k, ms=ms, launches=rest_n[k])
                          for k, ms in rest.most_common(REST_TOP)])


def log_kernel_split(phase, impl, split):
    """One line of the split, then one line for each of the rest's
    largest kernels."""
    top = split["rest_top"]
    log(f"{phase}: {impl}: kernel time per step " + json.dumps(
        {k: v for k, v in split.items() if k != "rest_top"}))
    for r in top:
        log(f"{phase}: {impl}: rest {r['ms']:.3f} ms/step "
            f"({r['launches']:.0f} launches/step): {r['name']}")


def lm_eval(cfg, params, batch):
    """The no-grad loss per token of ``cfg``'s model at ``params``."""
    import torch
    from repro_torch.models.api import build_model
    model = build_model(cfg, device=batch["tokens"].device)
    with torch.no_grad():
        loss_sum, aux = model.loss(params, batch)
    return float(loss_sum) / float(aux["count"])


def compare_lm_devices(gpu, cpu, tau=2):
    """Phase 7: the card's run (flash kernels) against the CPU's (plain
    attention), f32 compute, with phase 3's checks: applied counts
    exact (the first delayed update at step ``tau``), loss and grad norm
    to rtol 1e-4, every weight to 1e-4 of its leaf's largest element
    plus one int8 quantization step, w in the ball. Returns (largest
    difference, its tolerance)."""
    import numpy as np
    from repro_torch.core.arena import tree_flatten
    hg, hc = gpu["history"], cpu["history"]
    assert len(hg) == len(hc) > tau
    for t, (a, b) in enumerate(zip(hg, hc)):
        assert a["applied_count"] == b["applied_count"], (t, a, b)
        assert (a["applied_count"] == 0.0) == (t < tau), (t, a)
        for key in ("loss", "grad_norm"):
            assert math.isfinite(a[key]), (t, key, a)
            assert math.isclose(a[key], b[key], rel_tol=1e-4,
                                abs_tol=1e-30), (t, key, a[key], b[key])
    step = max(float(s.max()) for s in cpu["state"].arena.scales) / min(
        h["applied_count"] for h in hc if h["applied_count"])
    worst = (0.0, 0.0)
    for wg, wc in zip(tree_flatten(gpu["state"].params)[0],
                      tree_flatten(cpu["state"].params)[0]):
        wg, wc = wg.cpu().numpy(), wc.numpy()
        diff = float(np.abs(wg - wc).max())
        tol = 1e-4 * float(np.abs(wc).max()) + step
        assert diff <= tol, (diff, tol)
        worst = max(worst, (diff, tol))
    lm_weights_ok(gpu["state"].params)
    return worst


# -- phase 20: the launchers on the card ---------------------------------------
CLI_STEPS = 3
# qwen1.5-0.5b FULL, all 24 layers, through ``python -m
# repro_torch.launch.train``'s ``main`` (the CLI's defaults otherwise:
# tau 1, 2 microbatches, compression none, plain attention)
CLI_TRAIN = ["--arch", "qwen1.5-0.5b", "--seq-len", "1024", "--n-workers",
             "2", "--samples-per-worker", "1", "--steps", str(CLI_STEPS)]
# the card against ``--device cpu``: amb-linreg SMOKE (f32 arithmetic;
# the SMOKE LMs compute in bf16, where the two devices' matmuls round
# apart), 6 steps, phase 7's limits on the loss and the weights
CLI_SMOKE = ["--arch", "amb-linreg", "--smoke", "--steps", "6"]
CLI_SERVE = ["--arch", "qwen1.5-0.5b", "--slots", "16", "--n-steps", "32",
             "--publish-period", "4"]
CLI_STALENESS_BOUND = 4   # the serve CLI's default --staleness-bound


def cli_phase(drive, expect):
    """Phase 20: the launchers on the card, in process: the train CLI on
    qwen1.5-0.5b FULL with each optimizer (finite losses; B.1 once a
    step under dual averaging, no kernel of the port under sgd and
    adam: their updates are plain tensor code, as in JAX), each
    optimizer on the card against ``--device cpu``, the serve CLI with
    its stand-in master publishing every 4 steps (staleness within the
    bound), and ``anytime_impl="while_dynamic"`` on phase 3's linreg
    bit for bit against "scan_masked" (n_active = n_mb: the step reads
    no count back). Returns the record."""
    import contextlib
    import dataclasses
    import io

    import torch
    from repro_torch.core.arena import tree_flatten
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    rec = {}
    t0 = time.perf_counter()
    for opt in ("dual_averaging", "sgd", "adam"):
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            out, n = drive(lambda: train_cli.main(
                CLI_TRAIN + ["--optimizer", opt]))
        lines = text.getvalue().splitlines()
        hist = out["history"]
        assert lines[-1].startswith("done: "), lines
        assert len(lines) == len(hist) + 1, lines
        assert all(math.isfinite(h["loss"]) for h in hist), hist
        assert hist[-1]["step"] == CLI_STEPS, hist
        assert n == (expect(dual_update=CLI_STEPS) if opt == "dual_averaging"
                     else expect()), (opt, n)
        rec[f"train_{opt}"] = dict(seconds=time.perf_counter() - t1,
                                   launches=n, done=lines[-1],
                                   loss=[h["loss"] for h in hist])
        log(f"phase 20: train CLI qwen1.5-0.5b 24 layers --optimizer {opt}: "
            f"{lines[-1]}; {rec[f'train_{opt}']['seconds']:.2f} s; "
            f"launches {n}")
        del out
        torch.cuda.empty_cache()
    rec["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for opt in ("dual_averaging", "sgd", "adam"):
        runs = {}
        for dev in ("cuda", "cpu"):
            with contextlib.redirect_stdout(io.StringIO()):
                runs[dev] = train_cli.main(CLI_SMOKE + ["--optimizer", opt,
                                                        "--device", dev])
        hg, hc = runs["cuda"]["history"], runs["cpu"]["history"]
        assert len(hg) == len(hc) > 0
        for a, b in zip(hg, hc):
            assert a["applied_count"] == b["applied_count"], (a, b)
            for key in ("loss", "grad_norm"):
                assert math.isclose(a[key], b[key], rel_tol=1e-4,
                                    abs_tol=1e-30), (opt, key, a, b)
        worst = 0.0
        for wg, wc in zip(tree_flatten(runs["cuda"]["state"].params)[0],
                          tree_flatten(runs["cpu"]["state"].params)[0]):
            wc = wc.float()
            gap = float((wg.cpu().float() - wc).abs().max()) / max(
                float(wc.abs().max()), 1e-30)
            assert gap <= 1e-4, (opt, gap)
            worst = max(worst, gap)
        rec[f"smoke_{opt}"] = dict(loss=[hg[-1]["loss"], hc[-1]["loss"]],
                                   w_gap=worst)
        log(f"phase 20: train CLI amb-linreg SMOKE --optimizer {opt}: loss "
            f"{hg[-1]['loss']} (cuda), {hc[-1]['loss']} (cpu); weights "
            f"within {worst:.3e} <= 1e-4 of the leaf's largest")
    rec["smoke_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        served, n = drive(lambda: serve_cli.main(CLI_SERVE))
    lines = text.getvalue().splitlines()
    stats = served["engine"].stats
    assert n == expect(), n
    assert stats.steps == 32 and stats.publish_pops > 0, stats
    assert stats.staleness_max <= CLI_STALENESS_BOUND, stats
    rec["serve"] = dict(seconds=time.perf_counter() - t0, lines=lines,
                        publish_pops=stats.publish_pops,
                        staleness_max=stats.staleness_max)
    for line in lines:
        log(f"phase 20: serve CLI qwen1.5-0.5b 16 slots: {line}")
    del served
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, rc_of = main_path_config()
    rc = rc_of("none")
    params = {}
    for impl in ("scan_masked", "while_dynamic"):
        r = rc.replace(ambdg=dataclasses.replace(rc.ambdg, anytime_impl=impl))
        loop = LoopConfig(n_steps=CLI_STEPS, n_workers=10,
                          samples_per_worker=150, log_every=1)
        out, n = drive(lambda: train(build_model(cfg, device="cuda"), r,
                                     loop, device="cuda"))
        assert n == expect(dual_update=CLI_STEPS), (impl, n)
        params[impl] = (tree_flatten(out["state"].params)[0],
                        [h["loss"] for h in out["history"]])
    bitwise = all(torch.equal(a, b) for a, b in zip(
        params["scan_masked"][0], params["while_dynamic"][0])) and \
        params["scan_masked"][1] == params["while_dynamic"][1]
    assert bitwise, params
    rec["while_dynamic"] = dict(seconds=time.perf_counter() - t0,
                                bitwise=bitwise,
                                loss=params["while_dynamic"][1])
    log(f"phase 20: linreg FULL anytime_impl=while_dynamic {CLI_STEPS} "
        f"steps: bit for bit the scan_masked run ({bitwise}); loss "
        f"{params['while_dynamic'][1]}")
    return rec


# -- the hybrid slice (phases 8 and 9) ------------------------------------------
Z_LAYERS = 6        # 1 group of 6 Mamba2 layers: 0.51B parameters
Z_STEPS = 3         # the third applies the first delayed update (tau 2)
# the scan kernel ("kernel") against the plain chunked scan ("xla") on the
# card at the init weights, and the card against the CPU in phase 9. The
# backward of 36 random-init layers (phase 8's depth when these limits
# were set) amplifies rounding: two plain runs that differ only in the
# scan's chunk (128 against 256, the same function in exact arithmetic)
# already differ by up to 3.7e-3 of a leaf's largest
# element in f32, and a bf16 gradient lies as far from the f32 one as the
# gradient itself. So in f32 each leaf's kernel-vs-plain gap is held to
# Z_F32_RATIO times that chunk-to-chunk gap plus Z_F32_FLOOR (the two
# routes' summation orders at a shallow depth), and in bf16 each leaf's
# distance to the f32 gradient to Z_BF16_GRAD_RATIO times the plain
# route's; the losses and evals to Z_F32_RTOL / Z_BF16_RTOL. Each limit
# is about two to ten times its first reading (NVIDIA H100 80GB HBM3,
# 700 W): kernel over chunk-to-chunk gap at most 1.16 (ln_final, with the
# floor), bf16 ratio at most 1.60 (w_in), bf16 losses 9.3e-5 apart, f32
# losses equal.
Z_F32_RATIO = 3.0
Z_F32_FLOOR = 1e-5
Z_F32_RTOL = 1e-5
Z_BF16_GRAD_RATIO = 3.0
Z_BF16_RTOL = 1e-3
Z_DEVICE_GRAD_TOL = 1e-3
# phase 9's workers, one sequence each (2 until phase 20 came, cut for the
# script's time limit: the CPU's plain recurrence took 61 s for 2 x 2)
Z9_WORKERS = 1


def z_config(scan_impl, n_layers=Z_LAYERS, **kw):
    """zamba2-2.7b FULL at ``n_layers`` with ``scan_impl`` (and any
    overrides)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("zamba2-2.7b"), n_layers=n_layers,
                               scan_impl=scan_impl, block_remat="full", **kw)


class counting:
    """Count the calls of ``module.name`` inside the ``with`` block (the
    function is wrapped, and put back after)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        fn = self.original = getattr(self.module, self.name)

        def wrapped(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.original)


def z_route(impl, n_layers=Z_LAYERS, **kw):
    """Phase 8's routes: "kernel" runs the scan kernel and the shared
    block's attention on the flash kernels, "xla" the plain chunked scan
    and plain attention."""
    if impl == "kernel":
        kw.setdefault("attn_impl", "flash")
    return z_config(impl, n_layers=n_layers, **kw)


def hybrid_phase(drive, expect, n_mb, n_workers, seq):
    """Phase 8: zamba2 at full width, Z_LAYERS layers, ``seq`` tokens: the
    init-weight gradient and eval checks, then AMB-DG through ``train``
    with the scan kernel and the flash kernels (the shared block) and
    with the plain chunked scan and plain attention. ``drive`` and
    ``expect`` are main's launch-count helpers. Returns the record."""
    import dataclasses

    import torch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.kernels.linear_scan.kernel import kernels_per_call
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.api import build_model
    zb = {}
    per_step = Z_LAYERS * n_mb    # Mamba2 layers x microbatches
    # shared-block applications x microbatches: the forward with lse twice
    # (full remat recomputes it), dq and dk/dv once each
    attn_step = Z_LAYERS // z_config("xla").shared_attn_every * n_mb
    rcz = lm_run_config(z_route("kernel"), seq, 2 * n_workers, n_mb)
    params0 = build_model(z_route("kernel"), device="cuda").init(
        torch.Generator().manual_seed(rcz.seed))
    host = TokenStream(z_route("kernel"), seed=1).next_batch(2, seq)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in host.items()}
    names = leaf_names(params0)
    # the worker's gradient on one microbatch at the init weights: the
    # kernel route against the plain one, in f32 and bf16 compute, each
    # leaf held against the f32 plain gradient; the plain route at chunk
    # 128 gives the f32 noise floor. The flash kernels alone (the plain
    # scan) against plain attention at phase 6's limits
    ref32, loss_ref = model_grads(z_route("xla", compute_dtype="float32"),
                                  params0, batch)
    zgap, zloss = {}, {"xla_float32": loss_ref}
    chunk128 = dataclasses.replace(z_config("xla").ssm, chunk_size=128)
    for tag, cfg in (
            ("xla_chunk128_float32", z_route("xla", compute_dtype="float32",
                                             ssm=chunk128)),
            ("kernel_float32", z_route("kernel", compute_dtype="float32")),
            ("flash_float32", z_route("xla", compute_dtype="float32",
                                      attn_impl="flash")),
            ("kernel_bfloat16", z_route("kernel")),
            ("flash_bfloat16", z_route("xla", attn_impl="flash")),
            ("xla_bfloat16", z_route("xla"))):
        g_, zloss[tag] = model_grads(cfg, params0, batch)
        zgap[tag] = leaf_gaps(g_, ref32, names)
        del g_
        torch.cuda.empty_cache()
    del ref32
    torch.cuda.empty_cache()
    zev = {}
    zev["kernel_bfloat16"], n_zev = drive(lambda: lm_eval(
        z_route("kernel"), params0, batch))
    zev["flash_bfloat16"] = lm_eval(z_route("xla", attn_impl="flash"),
                                    params0, batch)
    zev["xla_bfloat16"] = lm_eval(z_route("xla"), params0, batch)
    del params0
    torch.cuda.empty_cache()
    zb["init_weights"] = dict(leaves=names, grad_gap_to_f32_xla=zgap,
                              loss=zloss, eval=zev, eval_launches=n_zev)
    for i, name in enumerate(names):
        log(f"phase 8: init weights, gradient {name} against the f32 xla "
            f"gradient: f32 kernel {zgap['kernel_float32'][i]:.3e}, flash "
            f"{zgap['flash_float32'][i]:.3e}, xla at chunk 128 "
            f"{zgap['xla_chunk128_float32'][i]:.3e}; bf16 kernel "
            f"{zgap['kernel_bfloat16'][i]:.3e}, flash "
            f"{zgap['flash_bfloat16'][i]:.3e}, xla "
            f"{zgap['xla_bfloat16'][i]:.3e} (of the leaf's largest element)")
    log(f"phase 8: init weights, loss per token of the gradient batch "
        f"{json.dumps(zloss)}; no-grad eval {json.dumps(zev)}; eval "
        f"launches {n_zev}")
    assert n_zev == expect(linear_scan_fwd=Z_LAYERS,
                           flash_fwd=attn_step // n_mb), n_zev
    for i, name in enumerate(names):
        assert zgap["kernel_float32"][i] <= (
            Z_F32_RATIO * zgap["xla_chunk128_float32"][i] + Z_F32_FLOOR), (
            name, zgap["kernel_float32"][i], zgap["xla_chunk128_float32"][i])
        assert zgap["kernel_bfloat16"][i] <= (
            Z_BF16_GRAD_RATIO * zgap["xla_bfloat16"][i]), (
            name, zgap["kernel_bfloat16"][i], zgap["xla_bfloat16"][i])
        # phase 6's limits: flash and plain attention on the same scan;
        # in f32 a leaf may also lie as far as the plain route's own
        # chunk-to-chunk gap, where that is larger (the Mamba layers'
        # backward amplifies one rounding of the shared block's output:
        # a_log and dt_bias read 3.2e-5 and 1.5e-5 against gaps of 6.1e-5
        # and 4.1e-5, every other leaf at most 2.5e-6; NVIDIA H100 80GB
        # HBM3, 700 W)
        assert zgap["flash_float32"][i] <= max(
            LM_F32_GRAD_TOL, zgap["xla_chunk128_float32"][i]), (
            name, zgap["flash_float32"][i], zgap["xla_chunk128_float32"][i])
        assert zgap["flash_bfloat16"][i] <= (
            LM_BF16_GRAD_RATIO * zgap["xla_bfloat16"][i]), (
            name, zgap["flash_bfloat16"][i], zgap["xla_bfloat16"][i])
    for a, b, rtol in (("kernel_float32", "xla_float32", Z_F32_RTOL),
                       ("kernel_bfloat16", "xla_bfloat16", Z_BF16_RTOL),
                       ("flash_float32", "xla_float32", LM_F32_RTOL),
                       ("flash_bfloat16", "xla_bfloat16", LM_BF16_RTOL)):
        assert math.isclose(zloss[a], zloss[b], rel_tol=rtol), (a, b, zloss)
    assert math.isclose(zev["kernel_bfloat16"], zev["xla_bfloat16"],
                        rel_tol=Z_BF16_RTOL), zev
    assert math.isclose(zev["flash_bfloat16"], zev["xla_bfloat16"],
                        rel_tol=LM_BF16_RTOL), zev
    zruns = {}
    for impl in ("kernel", "xla"):
        cfg = z_route(impl)
        rc = lm_run_config(cfg, seq, 2 * n_workers, n_mb)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with counting(ssm_mod, "ssd_chunked") as n_chunked, \
                counting(scan_ops, "linear_scan_ref") as n_plain, \
                counting(layers_mod, "gqa_attend") as n_plain_attn:
            ((out, secs), kernels), n = drive(lambda: profiled(
                lambda: run_lm(cfg, rc, Z_STEPS, n_workers, "cuda")))
        if impl == "kernel":
            # the forward and its recomputation under block_remat="full";
            # the backward's dv, dk and dq forms; no plain scan at all;
            # the shared block on the flash kernels, no plain attention
            assert n == expect(dual_update=Z_STEPS, slot_rotate=Z_STEPS,
                               linear_scan_fwd=2 * per_step * Z_STEPS,
                               linear_scan_bwd=3 * per_step * Z_STEPS,
                               flash_fwd_lse=2 * attn_step * Z_STEPS,
                               flash_bwd_dq=attn_step * Z_STEPS,
                               flash_bwd_dkv=attn_step * Z_STEPS), n
            assert n_chunked.calls == n_plain.calls == 0, (
                n_chunked.calls, n_plain.calls)
            assert n_plain_attn.calls == 0, n_plain_attn.calls
        else:
            assert n == expect(dual_update=Z_STEPS, slot_rotate=Z_STEPS), n
            assert n_chunked.calls == 2 * per_step * Z_STEPS, n_chunked.calls
        peak = torch.cuda.max_memory_allocated()
        norm = lm_weights_ok(out["state"].params)
        hist = out["history"]
        # a no-grad eval at the run's final weights, both routes
        ev = {i: lm_eval(z_route(i), out["state"].params, batch)
              for i in ("kernel", "xla")}
        assert math.isclose(ev["kernel"], ev["xla"], rel_tol=Z_BF16_RTOL), ev
        zruns[impl] = hist
        zb[impl] = dict(
            seconds=secs, launches=n, peak_gib=peak / 2 ** 30, w_norm=norm,
            loss=[h["loss"] for h in hist],
            applied_count=[h["applied_count"] for h in hist],
            final_eval=ev, plain_scan_calls=n_plain.calls,
            chunked_scan_calls=n_chunked.calls,
            split=step_split(out, kernels) if kernels else None,
            kernel_split=kernel_split(kernels, Z_STEPS) if kernels
            else None)
        del out
        per_call = kernels_per_call(seq, cfg.ssm.chunk_size)
        log(f"phase 8: zamba2 {Z_LAYERS} layers scan_impl={impl} "
            f"attn_impl={cfg.attn_impl}: "
            f"{Z_STEPS} steps in {secs:.2f} s; loss {zb[impl]['loss']}; "
            f"applied_count {zb[impl]['applied_count']}; |w| = {norm:.4f}; "
            f"peak {zb[impl]['peak_gib']:.2f} GiB; launches {n} (calls; a "
            f"scan call is {per_call} device kernels); final-weight eval "
            f"{json.dumps(ev)}")
        if kernels:
            log(f"phase 8: {impl}: step split {json.dumps(zb[impl]['split'])}")
            log_kernel_split("phase 8", impl, zb[impl]["kernel_split"])
        else:
            log(f"note: no step split for the {impl} run (the profiler "
                "recorded nothing)")
    for t, (a, b) in enumerate(zip(zruns["kernel"], zruns["xla"])):
        assert a["applied_count"] == b["applied_count"], (t, a, b)
        assert (a["applied_count"] == 0.0) == (t < 2), (t, a)
        assert a["local_count"] == 2 * n_workers * (seq - 1), (t, a)
        assert math.isfinite(a["loss"]), (t, a)
        assert math.isclose(a["loss"], b["loss"], rel_tol=Z_BF16_RTOL), (
            t, a["loss"], b["loss"])
    return zb


def z9_inputs():
    """Phase 9's config, run config, init weights (on the host) and
    batch."""
    import torch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.api import build_model
    cfg9 = z_config("kernel", n_layers=6, compute_dtype="float32")
    rc9 = lm_run_config(cfg9, 512, Z9_WORKERS, 1, tau=1)
    params9 = build_model(cfg9, device="cpu").init(
        torch.Generator().manual_seed(rc9.seed))
    host9 = TokenStream(cfg9, seed=1).next_batch(1, 512)
    return cfg9, rc9, params9, {k: torch.from_numpy(v)
                                for k, v in host9.items()}


def z9_cpu_main(out_dir):
    """Phase 9's CPU side (``--z9-cpu=DIR``): the init-weight gradient
    and the 2-step run on the CPU, saved to DIR/z9.pt. The script starts
    it after the build, so the CPU's plain recurrence runs beside phases
    2-8, which keep the card busy and the host's cores mostly idle."""
    import torch
    cfg9, rc9, params9, batch9 = z9_inputs()
    grads, loss = model_grads(cfg9, params9, batch9)
    cpu9, secs = run_lm(cfg9, rc9, 2, Z9_WORKERS, "cpu", 1)
    torch.save(dict(grads=grads, loss=loss, history=cpu9["history"],
                    params=cpu9["state"].params,
                    scales=list(cpu9["state"].arena.scales), secs=secs),
               f"{out_dir}/z9.tmp")
    Path(f"{out_dir}/z9.tmp").rename(f"{out_dir}/z9.pt")
    return 0


def start_z9_cpu():
    """Start phase 9's CPU side in a process of its own (6 of the host's
    threads; killed at exit if it still runs): (its directory, the
    process, its start time)."""
    import atexit
    import os
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="6")
    proc = subprocess.Popen(
        [sys.executable, str(root / "chip_smoke.py"), f"--z9-cpu={tmp}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    atexit.register(lambda: (stop_dist_ranks(proc),
                             shutil.rmtree(tmp, ignore_errors=True)))
    return tmp, proc, time.perf_counter()


def hybrid_device_phase(drive, expect, cpu_side):
    """Phase 9: zamba2 at full width with one group of 6 layers, seq 512,
    Z9_WORKERS worker(s) x 1 sequence, tau 1, 2 steps (the second
    applies the first delayed update), f32: the card (the scan kernel)
    against the CPU (the plain recurrence, ``cpu_side``:
    ``start_z9_cpu``'s process), with phase 3's checks and the
    init-weight gradient on one sequence.
    The CPU's plain recurrence (512 sequential steps a layer) takes
    about 12 s a worker's step. Returns the record."""
    import shutil
    import types

    import torch
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    cfg9, rc9, params9, batch9 = z9_inputs()
    tmp, proc, t_start = cpu_side
    try:
        wait_mesh_process("phase 9 CPU side", proc, t_start)
        cpu = torch.load(f"{tmp}/z9.pt", weights_only=False)
    finally:
        stop_dist_ranks(proc)
        shutil.rmtree(tmp, ignore_errors=True)
    g9_cpu, loss9_cpu = cpu["grads"], cpu["loss"]
    leaves9, def9 = tree_flatten(params9)
    g9_gpu, loss9_gpu = model_grads(
        cfg9, tree_unflatten(def9, [x.cuda() for x in leaves9]),
        {k: v.cuda() for k, v in batch9.items()})
    names9 = leaf_names(params9)
    gap9 = leaf_gaps(g9_gpu, g9_cpu, names9)
    log(f"phase 9: init weights, gradient card (kernel) vs cpu (plain), of "
        f"each leaf's largest element: {json.dumps(dict(zip(names9, gap9)))}"
        f"; loss per token {loss9_gpu} (card), {loss9_cpu} (cpu)")
    assert all(g <= Z_DEVICE_GRAD_TOL for g in gap9), gap9
    assert math.isclose(loss9_gpu, loss9_cpu, rel_tol=Z_F32_RTOL), (
        loss9_gpu, loss9_cpu)
    del g9_cpu, g9_gpu, params9, leaves9
    (gpu9, secs9), n = drive(lambda: run_lm(cfg9, rc9, 2, Z9_WORKERS,
                                            "cuda", 1))
    assert n == expect(dual_update=2, slot_rotate=2,
                       linear_scan_fwd=2 * 6 * 1 * 2,
                       linear_scan_bwd=3 * 6 * 1 * 2), n
    cpu9 = {"history": cpu["history"], "state": types.SimpleNamespace(
        params=cpu["params"],
        arena=types.SimpleNamespace(scales=cpu["scales"]))}
    cpu_secs9 = cpu["secs"]
    diff9, tol9 = compare_lm_devices(gpu9, cpu9, tau=1)
    out = dict(gpu_s=secs9, cpu_s=cpu_secs9, launches=n, init_grad_gap=gap9,
               loss=[h["loss"] for h in gpu9["history"]], w_max_diff=diff9,
               w_tol=tol9)
    log(f"phase 9: zamba2 6 layers f32, {Z9_WORKERS} worker(s), 2 steps on "
        f"cuda in {secs9:.2f} s, "
        f"on cpu in {cpu_secs9:.2f} s (a process of its own, beside "
        f"phases 2-8); loss {out['loss']}"
        f"; max |w_gpu - w_cpu| = {diff9:.3e} <= {tol9:.3e}; launches {n}")
    del gpu9, cpu9
    return out


# -- the simulator, the pytree master, the K-batch step (phases 10-12) --------
# simulated seconds of the Sec. VI-A comparison: past the last time_to
# target reached (K-batch's 0.1 at 184 s) and short of the 250 s of
# earlier runs, whose host batch draws took 70 s
SIM_TOTAL_S = 200.0
SIM_B_MAX = 160        # above the largest anytime draw b T_p / xi = 150
SIM_TARGETS = (0.5, 0.35, 0.1)
MASTER_STEPS = 12      # phase 11's linreg run; 3 for qwen1.5-0.5b
L2_SMOOTHNESS = 20.0   # phase 11's l2 runs of linreg (see master_phase)
KBATCH_STEPS = 5


def linreg_config(dim):
    from repro_torch.configs.base import LINREG, ModelConfig
    return ModelConfig(name="linreg", family=LINREG, n_layers=0, d_model=0,
                       n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
                       linreg_dim=dim)


def sim_golden_phase():
    """Phase 10a: ``tests/test_sim_golden.py``'s configurations on the card
    (d = 64, 3 workers, seed 7, b_max 128, T_p 2.5, T_c 10, 60 s,
    rng_seed 11): AMB-DG and AMB (``sim_trace.json``), and the
    heavy-tailed delay (tau_max 6, seed 13) on both engines
    (``stochastic_trace.json``). Times, epochs, minibatches, delays and
    staleness equal the committed JSON; the errors agree to rtol 1e-4,
    atol 1e-7. Returns {trace: (updates, largest relative error gap)}."""
    import numpy as np
    from repro_torch.configs.base import AmbdgConfig, DelayConfig
    from repro_torch.core.delay_process import make_delay_process
    from repro_torch.data.timing import ShiftedExponential
    from repro_torch.sim import SimProblem, simulate_anytime, simulate_kbatch
    root = Path(__file__).resolve().parent / "tests" / "golden"
    golden = {name: json.loads((root / f"{name}.json").read_text())
              for name in ("sim_trace", "stochastic_trace")}
    opt = AmbdgConfig(t_p=2.5, t_c=10.0, tau=4, smoothness_L=1.0,
                      b_bar=180.0, proximal="l2_ball",
                      radius_C=float(1.05 * np.sqrt(64)))
    common = dict(t_c=10.0, total_time=60.0, opt_cfg=opt, rng_seed=11,
                  timing=ShiftedExponential(lam=2 / 3, xi=1.0, b=60))

    def problem():
        return SimProblem(linreg_config(64), n_workers=3, seed=7, b_max=128,
                          device="cuda")

    def delay():
        return make_delay_process(DelayConfig(process="heavy_tail",
                                              tau_max=6, seed=13),
                                  opt.staleness)

    runs = {
        "sim_trace/ambdg": lambda: simulate_anytime(
            problem(), t_p=2.5, scheme="ambdg", **common),
        "sim_trace/amb": lambda: simulate_anytime(
            problem(), t_p=2.5, scheme="amb", **common),
        "stochastic_trace/ambdg": lambda: simulate_anytime(
            problem(), t_p=2.5, scheme="ambdg", delay_process=delay(),
            **common),
        "stochastic_trace/kbatch": lambda: simulate_kbatch(
            problem(), b_per_msg=32, K=3, t_p=2.5, delay_process=delay(),
            **common)}
    out = {}
    for label, run in runs.items():
        name, scheme = label.split("/")
        want = golden[name][scheme]
        tr = run()
        got = {"times": [round(t, 9) for t in tr.times],
               "epochs": list(tr.epochs),
               "minibatches": [float(b) for b in tr.minibatches],
               "staleness": [int(x) for x in tr.staleness],
               "delays": [int(d) for d in tr.delays]}
        for key in want:
            if key != "errors":
                assert got[key] == want[key], (label, key)
        err, ref = np.asarray(tr.errors), np.asarray(want["errors"])
        np.testing.assert_allclose(err, ref, rtol=1e-4, atol=1e-7,
                                   err_msg=label)
        out[label] = (len(tr.times),
                      float(np.max(np.abs(err - ref) / np.abs(ref))))
    g = golden["sim_trace"]
    assert len(g["ambdg"]["times"]) > 3 * len(g["amb"]["times"])
    return out


def time_to(trace, target):
    """Simulated seconds until the error first reaches ``target`` (None
    if it never does)."""
    return next((t for t, e in zip(trace.times, trace.errors)
                 if e <= target), None)


# phase 10b's schemes: AMB-DG and AMB at T_p 2.5, K-batch (b_per_msg 60, K 10)
SIM_SCHEMES = {"ambdg": dict(t_p=2.5), "amb": dict(t_p=2.5),
               "kbatch": dict(b_per_msg=60, K=10)}


def sim_paper_run(name):
    """One scheme of phase 10b (``sim_paper_phase``) on the card: its
    record, with finite errors and no clamped batch checked."""
    from repro_torch.data.timing import ShiftedExponential
    from repro_torch.sim import SimProblem
    cfg, rc = main_path_config()
    kw = dict(t_c=10.0, total_time=SIM_TOTAL_S, timing=ShiftedExponential(),
              opt_cfg=rc("none").ambdg)
    problem = SimProblem(cfg, n_workers=10, b_max=SIM_B_MAX, device="cuda")
    tr, rec = simulate_split(name, problem, **kw, **SIM_SCHEMES[name])
    assert all(math.isfinite(e) for e in tr.errors), name
    assert sum(tr.clamps) == 0, (name, tr.clamps)
    out = dict(rec, final_error=tr.errors[-1],
               time_to={str(e): time_to(tr, e) for e in SIM_TARGETS})
    if name == "kbatch":
        out["staleness_histogram"] = {
            str(k): v for k, v in sorted(
                collections.Counter(tr.staleness).items())}
    return out


def sim_paper_main(arg):
    """One scheme of phase 10b in a process of its own
    (``--sim-paper=DIR:SCHEME``): its record, and the launches of every
    kernel counter (none: the simulator's pytree master launches no
    kernel), to DIR/SCHEME.json."""
    import torch
    out_dir, name = arg.rsplit(":", 1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    rec = sim_paper_run(name)
    rec["launches"] = {n: k.launches for n, k in counters.items()}
    with open(f"{out_dir}/{name}.tmp", "w") as f:
        json.dump(rec, f)
    Path(f"{out_dir}/{name}.tmp").rename(f"{out_dir}/{name}.json")
    return 0


def start_sim_paper():
    """Start phase 10b's schemes, each in a process of its own with one
    host thread (killed at exit if it still runs; each is the host's
    numpy draws, one core; with the default threads the three processes'
    BLAS pools oversubscribed the host and each ran twice as long):
    (the directory, {scheme: (process, start time)})."""
    import atexit
    import os
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    procs = {name: (subprocess.Popen(
        [sys.executable, str(root / "chip_smoke.py"),
         f"--sim-paper={tmp}:{name}"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True),
        time.perf_counter()) for name in SIM_SCHEMES}
    atexit.register(lambda: ([stop_dist_ranks(p) for p, _ in procs.values()],
                             shutil.rmtree(tmp, ignore_errors=True)))
    return tmp, procs


def sim_paper_phase(bg):
    """Phase 10b: the paper's Sec. VI-A comparison (Fig. 2 and 3) through
    ``repro_torch.api.simulate`` at the full width d = 10^4 (amb-linreg
    FULL): n = 10 workers (seed 0, rng_seed 0, as
    ``examples/linreg_paper.py``), T_p 2.5, T_c 10, tau 4, b_bar 800,
    the l2 ball of radius 1.05 sqrt(d), SIM_TOTAL_S simulated seconds; AMB-DG,
    AMB and K-batch (b_per_msg 60, K 10). The batches are padded to
    b_max = 160 rows, where the example pads to 1024: the largest
    anytime draw is b T_p / xi = 150 and a K-batch job 60, so 160 clamps
    nothing (``trace.clamps`` reads 0) and the 864 extra rows of zero
    weight would only add host draws and device work. Checks the Fig. 2
    contract (AMB-DG's updates more than 3x AMB's), finite errors and no
    kernel launched. The split of each run: the host's numpy batch draws
    and its per update error (the read of w to the host, which waits for
    the card), against the card's kernel and copy time (profiler) and
    the wall time. The three schemes are independent and bound by the
    host's draws: each runs in a process of its own (``bg``, from
    ``start_sim_paper``, started a phase ahead). Returns {scheme:
    record}."""
    import shutil
    tmp, procs = bg
    out = {}
    try:
        for name, (proc, t0) in procs.items():
            wait_mesh_process(f"10b {name}", proc, t0)
            out[name] = read_json(f"{tmp}/{name}.json")
    finally:
        for proc, _ in procs.values():
            stop_dist_ranks(proc)
        shutil.rmtree(tmp, ignore_errors=True)
    for name, rec in out.items():
        assert not any(rec.pop("launches").values()), (name, rec)
    assert out["ambdg"]["updates"] > 3 * out["amb"]["updates"], out
    return out


def simulate_split(name, problem, profile=True, **kw):
    """``api.simulate(name, problem, **kw)`` on the card, under the
    profiler unless ``profile`` is False: (the trace, its split). The
    split: the host's numpy batch draws and its per-update error (the
    read of w to the host, which waits for the card), against the card's
    kernel and copy time (None without the profiler) and the wall
    time."""
    import torch
    from repro_torch import api
    host = dict(batch_s=0.0, error_s=0.0, batches=0)

    def timed_call(fn, key):
        def call(*a, **k):
            t0 = time.perf_counter()
            res = fn(*a, **k)
            host[key] += time.perf_counter() - t0
            host["batches"] += key == "batch_s"
            return res
        return call

    for stream in problem.streams:
        stream.next_batch = timed_call(stream.next_batch, "batch_s")
    problem.error = timed_call(problem.error, "error_s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if profile:
        tr, kernels = profiled(lambda: api.simulate(name, problem, **kw))
    else:
        tr, kernels = api.simulate(name, problem, **kw), []
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    copy_us = sum(us for k, us in kernels
                  if k.startswith(("Memcpy", "Memset")))
    return tr, dict(
        updates=len(tr.times), worker_grads=host["batches"], wall_s=wall,
        host_batch_s=host["batch_s"], host_error_s=host["error_s"],
        device_kernel_s=(sum(us for _, us in kernels) - copy_us) / 1e6
        if kernels else None,
        device_copy_s=copy_us / 1e6 if kernels else None)


def compare_masters(arena, pytree, layout):
    """Phase 11: the arena master's ``train`` run against the pytree
    master's: every step's applied count and loss equal (the loss at
    step t is taken at the weights of step t - 1, so equal losses mean
    equal weights at every step), the final params and z bit for bit.
    Returns the steps compared."""
    import torch
    from repro_torch.core.arena import tree_flatten, unflatten_tree
    ha, hp = arena["history"], pytree["history"]
    assert len(ha) == len(hp) > 0
    for t, (a, b) in enumerate(zip(ha, hp)):
        assert a["applied_count"] == b["applied_count"], (t, a, b)
        assert a["loss"] == b["loss"], (t, a["loss"], b["loss"])
        assert math.isfinite(a["loss"]), (t, a)
    sa, sp = arena["state"], pytree["state"]
    assert sp.arena is None and sa.buffer is None
    for x, y in zip(tree_flatten(sa.params)[0], tree_flatten(sp.params)[0]):
        assert torch.equal(x, y)
    z_arena = unflatten_tree(layout, sa.opt_state.z, cast=False)
    for x, y in zip(tree_flatten(z_arena)[0],
                    tree_flatten(sp.opt_state.z)[0]):
        assert torch.equal(x, y)
    assert int(sa.opt_state.t) == int(sp.opt_state.t) == len(ha)
    return len(ha)


def masters_lockstep(cfg, rc, n_steps, n_workers, per_worker, seq_len=0,
                     close=None):
    """The arena and the pytree master side by side on the same pod
    gradients (taken at the arena master's weights), ``n_steps`` steps of
    the anytime pipeline (one pod). z is compared bit for bit after
    every step, and so are the params, unless ``close`` = (rtol, atol)
    holds them to that tolerance (the ``l2_ball`` rule, whose ball norm
    the two masters sum in different orders). Returns the per-step
    applied counts, the steps at which the ball projected w, and the
    largest gap of the params."""
    import torch
    from repro_torch.core import ambdg, anytime, delayed
    from repro_torch.core import arena as arena_mod
    from repro_torch.core.arena import tree_flatten, tree_map, unflatten_tree
    from repro_torch.data.pipeline import AnytimePipeline
    from repro_torch.data.timing import ShiftedExponential
    from repro_torch.models.api import build_model
    from repro_torch.optim import make_arena_optimizer, make_optimizer
    dev = torch.device("cuda")
    model = build_model(cfg, device=dev)
    layout = arena_mod.make_layout(model.param_shapes())
    comp, tau = rc.ambdg.pod_compression, rc.ambdg.tau
    opt_a, opt_p = make_arena_optimizer(rc, layout, dev), make_optimizer(rc)
    pa = pp = model.init(torch.Generator().manual_seed(rc.seed))
    oa, op = opt_a.init(), opt_p.init(pp)
    ring = arena_mod.init_arena(layout, tau, 1, comp, device=dev)
    buf = delayed.init_buffer(pp, tau, 1, comp)
    pipe = AnytimePipeline(cfg, n_workers, per_worker, seq_len=seq_len,
                           seed=rc.seed, timing=ShiftedExponential(),
                           t_p=rc.ambdg.t_p)
    counts, projected, gap = [], [], 0.0
    for t in range(n_steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.next_global_batch().items()}
        g, c, _ = anytime.accumulate_scan(model.loss, pa, batch,
                                          rc.ambdg.n_microbatches)
        pod_g, pod_c = tree_map(lambda x: x[None], g), c[None]
        with torch.no_grad():
            pa, oa, ring, _, ca = ambdg.arena_master_update(
                layout, opt_a, pa, oa, ring, pod_g, pod_c, comp)
            pp, op, buf, _, cp = ambdg.pytree_master_update(
                opt_p, pp, op, buf, pod_g, pod_c, comp)
        assert ca.item() == cp.item(), (t, ca, cp)
        za = unflatten_tree(layout, oa.z, cast=False)
        for x, y in zip(tree_flatten(za)[0], tree_flatten(op.z)[0]):
            assert bool(torch.isfinite(x).all()) and torch.equal(x, y), t
        for x, y in zip(tree_flatten(pa)[0], tree_flatten(pp)[0]):
            assert bool(torch.isfinite(x).all()), t
            if close is None:
                assert torch.equal(x, y), t
            else:
                torch.testing.assert_close(x, y, rtol=close[0],
                                           atol=close[1])
            gap = max(gap, float((x - y).abs().max()))
        if rc.ambdg.proximal == "l2_ball":
            norm = math.sqrt(sum(float(torch.sum(torch.square(x)))
                                 for x in tree_flatten(pp)[0]))
            if abs(norm - rc.ambdg.radius_C) < 1e-5 * rc.ambdg.radius_C:
                projected.append(t)
        counts.append(ca.item())
    assert counts[-1] > 0, counts
    return dict(applied_count=counts, projected=projected, max_abs_gap=gap)


def master_phase(drive, expect):
    """Phase 11: ``master_impl="pytree"`` against ``"arena"`` on the card.
    amb-linreg FULL through ``train`` with ``proximal="l2"`` (the bitwise
    contract): tau 4, 12 steps, compression none and int8, one pod, at
    smoothness L = 20: at the configuration's L = 1 the 4-deep delayed
    steps overshoot and, with no ball to hold w, the loss grows without
    bound; at 20 it falls, which the phase checks. Then the
    configuration's own ``l2_ball`` rule (L = 1, the ball projecting w)
    with the two masters in lockstep on the same gradients: z bit for
    bit, the params at JAX's tolerance between its two masters (rtol
    2e-6, atol 1e-8, ``tests/test_arena.py``), since the masters sum the
    ball norm in different orders. Then qwen1.5-0.5b at full width
    (2 layers, seq 256, 4 sequences, f32, tau 2, int8, 3 steps), a nested
    tree, ``l2``, in lockstep: the model's own gradient need not repeat
    bit for bit from run to run (its embedding gradient is a
    scatter-add; on the CPU two runs differ by 6e-5), so two separate
    runs would compare the model, not the master. The arena master
    launches the dual update once a step (and the int8 slot rotate once
    a step); the pytree master launches no kernel. Returns {run:
    record}."""
    import dataclasses
    from repro_torch.core import arena as arena_mod
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    cfg, rc_of = main_path_config()
    loop = LoopConfig(n_steps=MASTER_STEPS, n_workers=10,
                      samples_per_worker=150, log_every=1)
    out = {}

    def l2(rc, master="arena", **ambdg):
        return rc.replace(master_impl=master, ambdg=dataclasses.replace(
            rc.ambdg, proximal="l2", **ambdg))

    for compression in ("none", "int8"):
        runs = {}
        for master in ("arena", "pytree"):
            rc = l2(rc_of(compression), master, smoothness_L=L2_SMOOTHNESS)
            runs[master], n = drive(lambda: train(
                build_model(cfg, device="cuda"), rc, loop, device="cuda"))
            steps = MASTER_STEPS if master == "arena" else 0
            assert n == expect(dual_update=steps, slot_rotate=steps if
                               compression == "int8" else 0), (master, n)
            out[f"linreg/{compression}/{master}"] = dict(launches=n)
        layout = arena_mod.make_layout(
            build_model(cfg, device="cuda").param_shapes())
        loss = [h["loss"] for h in runs["arena"]["history"]]
        assert loss[-1] < loss[0], loss
        out[f"linreg/{compression}"] = dict(
            steps=compare_masters(runs["arena"], runs["pytree"], layout),
            loss=loss)
        rec, n = drive(lambda: masters_lockstep(
            cfg, rc_of(compression), MASTER_STEPS, 10, 150,
            close=(2e-6, 1e-8)))
        assert n == expect(dual_update=MASTER_STEPS, slot_rotate=MASTER_STEPS
                           if compression == "int8" else 0), n
        assert rec["projected"], rec    # the ball was active
        out[f"linreg-l2_ball/{compression}"] = dict(rec, launches=n)
    cfg7 = lm_config("flash", n_layers=2, compute_dtype="float32")
    rc7 = l2(lm_run_config(cfg7, 256, 4, 2))
    rec, n = drive(lambda: masters_lockstep(cfg7, rc7, 3, 2, 2, seq_len=256))
    assert n == expect(dual_update=3, slot_rotate=3,
                       flash_fwd_lse=2 * 2 * 2 * 3, flash_bwd_dq=2 * 2 * 3,
                       flash_bwd_dkv=2 * 2 * 3), n
    out["qwen"] = dict(steps=3, applied_count=rec["applied_count"],
                       launches=n)
    return out


def kbatch_phase(drive, expect):
    """Phase 12: ``strategy="kbatch"`` through ``train`` (``api.build``)
    on amb-linreg FULL, 5 steps, no compression: ``ref_epoch`` ends at 6,
    every step's staleness is 0, the dual update launches once a step,
    and the params equal the "amb" strategy's run bit for bit (the
    K-batch device step is the tau = 0 degenerate). Returns the
    record."""
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    cfg, rc_of = main_path_config()
    loop = LoopConfig(n_steps=KBATCH_STEPS, n_workers=10,
                      samples_per_worker=150, log_every=1)
    runs, launches = {}, {}
    for strategy in ("kbatch", "amb"):
        rc = rc_of("none").replace(strategy=strategy)
        runs[strategy], n = drive(lambda: train(
            build_model(cfg, device="cuda"), rc, loop, device="cuda"))
        assert n == expect(dual_update=KBATCH_STEPS), (strategy, n)
        launches[strategy] = n
    kb, amb = runs["kbatch"], runs["amb"]
    assert int(kb["state"].ref_epoch) == KBATCH_STEPS + 1
    assert all(h["staleness"] == 0.0 for h in kb["history"]), kb["history"]
    assert torch.equal(kb["state"].base.params["w"],
                       amb["state"].params["w"])
    for a, b in zip(kb["history"], amb["history"]):
        assert a["loss"] == b["loss"] and a["applied_count"] == b[
            "applied_count"] > 0, (a, b)
    return dict(launches=launches, ref_epoch=int(kb["state"].ref_epoch),
                staleness=[h["staleness"] for h in kb["history"]],
                loss=[h["loss"] for h in kb["history"]])


# -- the CNN and the training scenarios (phases 13 and 14) ---------------------
# the CPU's reference run sets the phase's time (6 until phase 20 came,
# cut for the script's time limit; tau 1: the second step applies)
CNN_STEPS = 4
CNN_WORKERS, CNN_PER_WORKER = 4, 128   # fig5_nn.py: n = 4, 4 x 128 a step
# The card (cuDNN, cuBLAS; TF32 off) against the CPU, f32. The f32 gradient
# of the first convolutions is far from exact on both devices: at the init
# weights, on 128 images, the CPU's reads up to 1.4e-3 and the card's
# (cuDNN's Winograd and FFT weight-gradient kernels) up to 1.7e-3 of a
# leaf's largest element from the f64 gradient, the deeper layers and the
# fc ones 1e-7 to 1e-4 (NVIDIA H100 80GB HBM3, 700 W; cuDNN's
# deterministic and benchmark modes read the same:
# tools/cnn_grad_check.py). So each gradient leaf
# is held to CNN_GRAD_TOL of its largest element against the f64 gradient
# and against the CPU's. A run of n steps sums n - 1 such gradients into
# z: after 12 steps the first convolutions' weights read up to 4.4e-3 of
# the leaf's largest element apart (conv0_w, no compression; under int8
# every leaf lies within one quantization step), held to CNN_W_TOL plus one int8
# step; the per-step losses to phase 3's rtol 1e-4 (read: 2.1e-7); the
# per-step acc_sum of the 512 training images to CNN_ACC_TOL samples
# (read: equal; an argmax may flip where two logits lie within the two
# devices' rounding)
CNN_GRAD_TOL = 5e-3
CNN_W_TOL = 1e-2
CNN_LOSS_RTOL = 1e-4
CNN_ACC_TOL = 2.0
FIG5_TOTAL_S = 1000.0  # half fig5_nn.py's 2000 s at FULL, for time
# fig5_nn.py pads to 128 rows, below AMB-DG's largest anytime draw
# b T_p / xi = 60 * 10 / 4 = 150, so its AMB-DG run clamps some requests
# (this phase on the CPU at 128 rows: clamps in 7 of the first 9
# updates); 150 pads every draw and clamps nothing
FIG5_B_MAX = 150
FIG5_SAMPLE = 20       # worker gradients profiled after each Fig. 5 run
SCENARIO_STEPS = 12
# elastic processes that evict and readmit workers within 12 steps of a
# 10-worker fleet (eviction after 3 dead epochs)
ELASTIC = {"churn": dict(process="churn", p_fail=0.3, p_recover=0.3,
                         seed=1),
           "crash_restart": dict(process="crash_restart", mttf=4.0,
                                 mttr=4.0, seed=2)}


def cnn_run_config(compression):
    """amb-cnn FULL with ``fig5_nn.py``'s ``AmbdgConfig`` (T_p = T_c = 10,
    tau 1, L 4, b_bar 240), 4 microbatches of 128 images, one pod."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (AmbdgConfig, MeshConfig,
                                          RunConfig, TRAIN_4K)
    cfg = get_config("amb-cnn")
    return cfg, RunConfig(
        model=cfg, shape=TRAIN_4K, mesh=MeshConfig(n_pods=1, data=1, model=1),
        ambdg=AmbdgConfig(t_p=10.0, t_c=10.0, tau=1, smoothness_L=4.0,
                          b_bar=240.0, pod_compression=compression))


def run_cnn(compression, device):
    """One ``train`` run of the CNN (CNN_STEPS steps, 4 workers x 128):
    (result with the per-step ``acc_sum`` of the training images added,
    seconds). The model's loss keeps each microbatch's ``acc_sum`` (a
    device tensor: nothing is read back during the run)."""
    import dataclasses
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    cfg, rc = cnn_run_config(compression)
    model, acc = build_model(cfg, device=device), []

    def loss(params, batch):
        total, aux = model.loss_fn(params, batch)
        acc.append(aux["acc_sum"].detach())
        return total, aux

    loop = LoopConfig(n_steps=CNN_STEPS, n_workers=CNN_WORKERS,
                      samples_per_worker=CNN_PER_WORKER, log_every=1)
    t0 = time.perf_counter()
    out = train(dataclasses.replace(model, loss_fn=loss), rc, loop,
                device=device)
    secs = time.perf_counter() - t0
    n_mb = rc.ambdg.n_microbatches
    out["acc_sum"] = [float(sum(acc[i:i + n_mb]))
                      for i in range(0, len(acc), n_mb)]
    return out, secs


def compare_cnn_devices(gpu, cpu):
    """The CNN's card run against its CPU run: applied and local counts
    exact, losses to CNN_LOSS_RTOL, acc_sum to CNN_ACC_TOL, every weight
    to CNN_W_TOL of its leaf's largest element plus one int8 step, all
    finite. Returns the readings (logged by the caller before it
    asserts them)."""
    import numpy as np
    hg, hc = gpu["history"], cpu["history"]
    assert len(hg) == len(hc) == CNN_STEPS
    for t, (a, b) in enumerate(zip(hg, hc)):
        assert a["applied_count"] == b["applied_count"], (t, a, b)
        assert a["local_count"] == b["local_count"], (t, a, b)
        assert (a["applied_count"] == 0.0) == (t == 0), (t, a)
        assert math.isfinite(a["loss"]), (t, a)
    step = 0.0
    if cpu["state"].arena.scales is not None:
        step = max(float(s.max()) for s in cpu["state"].arena.scales) / min(
            h["applied_count"] for h in hc if h["applied_count"])
    w_gap = {}
    for k, wc in cpu["state"].params.items():
        wg = gpu["state"].params[k].cpu().numpy()
        wc = wc.numpy()
        assert np.all(np.isfinite(wg)), k
        top = float(np.abs(wc).max()) or 1.0
        w_gap[k] = (float(np.abs(wg - wc).max()) - step) / top
    return dict(
        loss_rel_gap=max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                         for a, b in zip(hg, hc)),
        acc_sum_gap=max(abs(a - b) for a, b in zip(gpu["acc_sum"],
                                                   cpu["acc_sum"])),
        w_gap_beyond_int8_step=w_gap, int8_step=step)


def cnn_kernel_split(kernels, n_steps):
    """The profiler's device time per CNN step: cuDNN's convolutions,
    cuBLAS products, the dual update (B.1) and the int8 slot rotate
    (B.2), the rest, copies apart; and the rest's 5 largest kernels."""
    groups, rest = collections.Counter(), collections.Counter()
    for name, us in kernels:
        low = name.lower()
        if name.startswith(("Memcpy", "Memset")):
            g = "copy"
        elif "dual_update" in name:
            g = "dual_update"
        elif "slot_rotate" in name:
            g = "slot_rotate"
        elif any(t in low for t in ("conv", "fprop", "dgrad", "wgrad",
                                    "cudnn", "implicit")):
            g = "cudnn_conv"
        elif any(t in low for t in ("gemm", "cutlass", "nvjet", "xmma",
                                    "cublas")):
            g = "cublas"
        else:
            g = "rest"
            rest[name[:REST_NAME_CHARS]] += us / 1e3 / n_steps
        groups[g] += us / 1e3 / n_steps
    total = sum(v for k, v in groups.items() if k != "copy")
    return dict({f"{k}_ms": groups.get(k, 0.0) for k in (
        "cudnn_conv", "cublas", "dual_update", "slot_rotate", "rest",
        "copy")}, conv_share=groups.get("cudnn_conv", 0.0) / total
        if total else 0.0,
        rest_top=[dict(name=k, ms=ms) for k, ms in rest.most_common(5)])


def cnn_phase(drive, expect):
    """Phase 13: the paper's CNN at full width (amb-cnn FULL: 32x32x3,
    9 convs and 5 fc, 6,805,642 parameters; Sec. VI-B), TF32 off.
    (a) at the init weights, on one batch of 128 images, the worker's
    gradient leaf by leaf on the card against the CPU; (b) AMB-DG
    through ``train``, CNN_STEPS steps of 4 workers x 128 images, int8 and
    none, on the card and then the CPU from the same seed, with the
    launch counts (B.1 once a step, B.2 once a step under int8), the
    step split, the kernel split and the peak memory; (c) Fig. 5
    through ``api.simulate``. Returns the record."""
    import torch
    from repro_torch.data.synthetic import ImageClassStream
    from repro_torch.models.api import build_model
    out = {}
    cfg, rc = cnn_run_config("none")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(rc.seed))
    host = ImageClassStream(32, 10, seed=1).next_batch(CNN_PER_WORKER)

    def on(device, dtype):
        return ({k: v.to(device, dtype) for k, v in params.items()},
                {k: torch.from_numpy(v).to(device, dtype if v.dtype.kind ==
                                          "f" else None)
                 for k, v in host.items()})

    # the reference: f64 on the card (the log-softmax in f32, as the
    # model computes it; the CPU's f64 agrees to 1e-7)
    g64, _ = model_grads(cfg, *on("cuda", torch.float64))
    g_gpu, loss_gpu = model_grads(cfg, *on("cuda", torch.float32))
    g_cpu, loss_cpu = model_grads(cfg, *on("cpu", torch.float32))
    names = leaf_names(params)
    gaps = {"card_vs_f64": leaf_gaps(g_gpu, g64, names),
            "cpu_vs_f64": leaf_gaps(g_cpu, g64, names),
            "card_vs_cpu": leaf_gaps(g_gpu, g_cpu, names)}
    for label, gap in gaps.items():
        log(f"phase 13: init weights, f32 gradient {label}, of each leaf's "
            f"largest element: {json.dumps(dict(zip(names, gap)))}")
    log(f"phase 13: loss per image {loss_gpu} (card), {loss_cpu} (cpu)")
    for label in ("card_vs_f64", "card_vs_cpu"):
        assert max(gaps[label]) <= CNN_GRAD_TOL, (label, gaps[label])
    assert math.isclose(loss_gpu, loss_cpu, rel_tol=1e-5), (loss_gpu,
                                                            loss_cpu)
    out["init_grad_gap"] = {k: dict(zip(names, v)) for k, v in gaps.items()}
    del g64, g_cpu, g_gpu
    for compression in ("int8", "none"):
        torch.cuda.reset_peak_memory_stats()
        ((gpu, secs), kernels), n = drive(lambda: profiled(
            lambda: run_cnn(compression, "cuda")))
        peak = torch.cuda.max_memory_allocated()
        want = expect(dual_update=CNN_STEPS, slot_rotate=CNN_STEPS
                      if compression == "int8" else 0)
        assert n == want, (compression, n, want)
        cpu, cpu_secs = run_cnn(compression, "cpu")
        gaps = compare_cnn_devices(gpu, cpu)
        rec = dict(gpu_s=secs, cpu_s=cpu_secs, launches=n,
                   loss=[h["loss"] for h in gpu["history"]],
                   acc_sum=gpu["acc_sum"], cpu_acc_sum=cpu["acc_sum"],
                   device_gaps=gaps, peak_mem_gb=peak / 1e9,
                   split=step_split(gpu, kernels) if kernels else None,
                   kernel_split=cnn_kernel_split(kernels, CNN_STEPS)
                   if kernels else None)
        out[compression] = rec
        log(f"phase 13: cnn {compression}: {CNN_STEPS} steps on cuda in "
            f"{secs:.2f} s, on cpu in {cpu_secs:.2f} s; launches {n}; loss "
            f"{[round(x, 4) for x in rec['loss']]}; acc_sum "
            f"{rec['acc_sum']} (cpu {rec['cpu_acc_sum']}); card vs cpu "
            f"{json.dumps(gaps)}; peak {rec['peak_mem_gb']:.2f} GB")
        log(f"phase 13: cnn {compression}: step split "
            f"{json.dumps(rec['split'])}; kernel time per step "
            f"{json.dumps(rec['kernel_split'])}")
        assert gaps["loss_rel_gap"] <= CNN_LOSS_RTOL, gaps
        assert gaps["acc_sum_gap"] <= CNN_ACC_TOL, gaps
        assert max(gaps["w_gap_beyond_int8_step"].values()) <= CNN_W_TOL, \
            gaps
        del gpu, cpu
    out["fig5"], n = drive(fig5_phase)
    assert n == expect(), n      # the simulator's pytree master
    return out


def fig5_phase():
    """Phase 13c: Fig. 5 (``benchmarks/fig5_nn.py`` at FULL) through
    ``api.simulate`` with the gradients on the card: AMB-DG against
    K-batch (b_per_msg 60, K 4) on amb-cnn FULL, n = 4, T_p = T_c = 10,
    the shifted exponential (lambda 2/3, xi 4, b 60), FIG5_TOTAL_S
    simulated s (fig5_nn.py runs 2000),
    b_max 150 (see FIG5_B_MAX). Hard checks: AMB-DG's updates equal its
    timeline model's, K-batch applies K messages an update, no clamp,
    finite held-out losses and weights. Findings: each scheme's final
    loss on a held-out batch of 128 (worker 0's stream, as fig5_nn.py)
    and fig5_nn.py's ``ambdg_beats_kbatch`` (AMB-DG's loss within 1.05x
    K-batch's). The runs go without the profiler, whose record of
    their ~300,000 kernels takes longer to read than the runs take; the
    card's share comes from FIG5_SAMPLE worker gradients profiled after
    each run (``device_kernel_s`` estimates the run's gradient kernels
    as that sample's time a gradient times the run's gradients)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import AmbdgConfig
    from repro_torch.core.strategy import get_strategy
    from repro_torch.data.timing import ShiftedExponential
    from repro_torch.sim import SimProblem
    cfg = get_config("amb-cnn")
    kw = dict(t_c=10.0, total_time=FIG5_TOTAL_S,
              timing=ShiftedExponential(lam=2 / 3, xi=4.0, b=60),
              opt_cfg=AmbdgConfig(t_p=10.0, t_c=10.0, tau=1, smoothness_L=4.0,
                                  b_bar=240.0))
    out = {}
    for name, extra in (("ambdg", dict(t_p=10.0)),
                        ("kbatch", dict(b_per_msg=60, K=4))):
        problem = SimProblem(cfg, 4, b_max=FIG5_B_MAX, device="cuda")
        tr, rec = simulate_split(name, problem, profile=False, **kw,
                                 **extra)
        assert sum(tr.clamps) == 0, (name, tr.clamps)
        if name == "ambdg":
            tm = get_strategy("ambdg").timeline_model()
            assert rec["updates"] == tm.n_updates(FIG5_TOTAL_S, 10.0, 10.0)
        else:
            assert len(tr.staleness) == 4 * rec["updates"] > 0
            rec["staleness_histogram"] = dict(sorted(
                collections.Counter(tr.staleness).items()))
        assert all(bool(torch.isfinite(v).all())
                   for v in tr.final_params.values()), name
        host = problem.streams[0].next_batch(128)
        with torch.no_grad():
            total, aux = problem.model.loss(tr.final_params, {
                k: torch.from_numpy(v).cuda() for k, v in host.items()})
        rec["final_loss"] = float(total) / float(aux["count"])
        rec["final_acc"] = float(aux["acc_sum"]) / float(aux["count"])
        _, kernels = profiled(lambda: [
            problem.worker_grad(i % 4, tr.final_params, FIG5_B_MAX)
            for i in range(FIG5_SAMPLE)])
        copy_us = sum(us for k, us in kernels
                      if k.startswith(("Memcpy", "Memset")))
        rec["grad_kernel_ms"] = (sum(us for _, us in kernels) - copy_us) \
            / 1e3 / FIG5_SAMPLE if kernels else None
        if kernels:
            rec["device_kernel_s"] = (rec["grad_kernel_ms"]
                                      * rec["worker_grads"] / 1e3)
        assert math.isfinite(rec["final_loss"]), (name, rec)
        out[name] = rec
        log(f"phase 13: fig5 {name}: {json.dumps(rec)}")
    out["ambdg_beats_kbatch"] = int(out["ambdg"]["final_loss"]
                                    <= out["kbatch"]["final_loss"] * 1.05)
    return out


def schedule_golden_phase():
    """Phase 14a: both halves of ``tests/golden/batch_schedule_trace.json``
    through ``api.simulate`` with the gradients on the card: AMB-DG under
    adadamp with the heavy-tailed delay, K-batch under the linear ramp
    (``tests/test_sim_golden.py``'s configurations). Targets, times,
    staleness, clamps, minibatches and delays equal the JSON; errors to
    rtol 1e-4, atol 1e-7. Returns {scheme: (updates, largest relative
    error gap)}."""
    import numpy as np
    from repro_torch import api
    from repro_torch.configs.base import (AmbdgConfig, BatchScheduleConfig,
                                          DelayConfig)
    from repro_torch.core.batch_schedule import make_batch_schedule
    from repro_torch.core.delay_process import make_delay_process
    from repro_torch.data.timing import ShiftedExponential
    from repro_torch.sim import SimProblem
    path = Path(__file__).resolve().parent / "tests" / "golden" / \
        "batch_schedule_trace.json"
    golden = json.loads(path.read_text())
    opt = AmbdgConfig(t_p=2.5, t_c=10.0, tau=4, smoothness_L=1.0,
                      b_bar=180.0, proximal="l2_ball",
                      radius_C=float(1.05 * np.sqrt(64)))
    kw = dict(t_c=10.0, total_time=60.0, opt_cfg=opt, rng_seed=11, t_p=2.5,
              timing=ShiftedExponential(lam=2 / 3, xi=1.0, b=60))
    ada = BatchScheduleConfig(schedule="adadamp", b0=12, b_cap=96,
                              growth_factor=2.0, ema=0.3, seed=5)
    lin = BatchScheduleConfig(schedule="linear", b0=16, b_cap=128,
                              growth_rate=2.0, seed=5)
    runs = {"ambdg": dict(delay_process=make_delay_process(
                DelayConfig(process="heavy_tail", tau_max=6, seed=13),
                opt.staleness),
                batch_schedule=make_batch_schedule(ada, opt.b_bar,
                                                   opt.staleness)),
            "kbatch": dict(b_per_msg=32, K=3,
                           batch_schedule=make_batch_schedule(
                               lin, opt.b_bar, opt.staleness))}
    out = {}
    for scheme, extra in runs.items():
        problem = SimProblem(linreg_config(64), n_workers=3, seed=7,
                             b_max=128, device="cuda")
        tr = api.simulate(scheme, problem, **kw, **extra)
        want = golden[scheme]
        got = {"times": [round(t, 9) for t in tr.times],
               "targets": list(tr.targets), "staleness": list(tr.staleness),
               "clamps": list(tr.clamps), "minibatches": list(tr.minibatches),
               "delays": list(tr.delays)}
        for key in want:
            if key != "errors":
                assert got[key] == want[key], (scheme, key)
        err, ref = np.asarray(tr.errors), np.asarray(want["errors"])
        np.testing.assert_allclose(err, ref, rtol=1e-4, atol=1e-7,
                                   err_msg=scheme)
        out[scheme] = (len(tr.times),
                       float(np.max(np.abs(err - ref) / np.abs(ref))))
    return out


def schedule_train_phase(drive, expect):
    """Phase 14b: ``train`` of amb-linreg FULL (the main path's config, no
    compression) under ``batch_schedule`` adadamp (fixed tau 4, at phase
    11's smoothness L = 20, where the loss falls within 12 steps, so
    adadamp's target grows) and under delay_aware with phase 4's
    heavy-tailed delay (L = 1), 12 steps on the card and the CPU: the
    same drawn targets, the same applied counts (phase 3's checks and
    tolerances: ``compare_devices``); the dual update once a step, the
    variable pop (B.3) once a step under the delay. Without compression:
    under int8 a last-bit difference of the two devices' gradients
    flipped an int8 rounding in both runs, and the loss moved 1.8e-4
    (L = 20) and 2.1e-4 (L = 1) relative, above phase 3's loss limit,
    which is set for f32 summation order (phases 13 and 14c run int8).
    Returns {schedule: record}."""
    import dataclasses
    from repro_torch.configs.base import BatchScheduleConfig
    cfg, rc_of = main_path_config()
    radius = rc_of("none").ambdg.radius_C
    out = {}
    compression = "none"
    for sched, delay, smooth in (("adadamp", None, L2_SMOOTHNESS),
                                 ("delay_aware", STOCHASTIC_DELAY, 1.0)):
        rc = rc_of(compression, delay)
        rc = rc.replace(
            ambdg=dataclasses.replace(rc.ambdg, smoothness_L=smooth),
            batch_schedule=BatchScheduleConfig(schedule=sched))
        runs = {}
        for dev in ("cuda", "cpu"):
            (runs[dev], secs), n = drive(lambda: run_scenario(rc, dev))
            if dev == "cuda":
                assert n == expect(dual_update=MAIN_STEPS,
                                   variable_pop=MAIN_STEPS if delay else 0
                                   ), (sched, n)
                launches = n
        targets = [h["b_target"] for h in runs["cuda"]["history"]]
        assert targets == [h["b_target"] for h in runs["cpu"]["history"]]
        assert len(set(targets)) > 1, targets
        if delay:
            arrived = arrivals(delay)[1]
        else:
            arrived = [t >= 4 for t in range(MAIN_STEPS)]
        diff, tol = compare_devices(compression, runs["cuda"], runs["cpu"],
                                    arrived, radius,
                                    tau_max=delay["tau_max"] if delay
                                    else None)
        out[sched] = dict(targets=targets, launches=launches,
                          applied_count=[h["applied_count"]
                                         for h in runs["cuda"]["history"]],
                          w_max_diff=diff, w_tol=tol)
        log(f"phase 14: train under {sched}: {json.dumps(out[sched])}")
    return out


def run_scenario(rc, device, n_steps=MAIN_STEPS, ckpt_dir=None):
    """``train`` of the main path's fleet (10 workers x 150) under ``rc``:
    (result, seconds)."""
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    loop = LoopConfig(n_steps=n_steps, n_workers=10, samples_per_worker=150,
                      log_every=1, ckpt_dir=ckpt_dir, ckpt_every=6)
    t0 = time.perf_counter()
    out = train(build_model(rc.model, device=device), rc, loop, device=device)
    return out, time.perf_counter() - t0


def elastic_restart_phase(drive, expect):
    """Phase 14c: ``train`` of amb-linreg FULL on the card under the churn
    (int8) and crash/restart (no compression) worker processes with a
    checkpoint directory (every 6 steps): evictions and readmissions
    appear in ``remesh_events``, each eviction saves a checkpoint after
    its step with the re-mesh plan; a run stopped at step 6 and restarted
    from its checkpoint ends where the uninterrupted 12-step run ends,
    bit for bit (every state leaf: params, z, ring, scales, residual,
    counts, head, step), and the step-12 checkpoints' host states
    (pipeline, worker process, health) are equal. Returns {process:
    record}."""
    import tempfile
    import torch
    from repro_torch.configs.base import ElasticConfig
    from repro_torch.train import checkpoint
    cfg, rc_of = main_path_config()
    out = {}
    saves = []
    save = checkpoint.save

    def spy(ckpt_dir, step, state, extra=None, keep=3):
        saves.append((Path(ckpt_dir).name, step,
                      (extra or {}).get("remesh_plan")))
        return save(ckpt_dir, step, state, extra=extra, keep=keep)

    checkpoint.save = spy
    try:
        for process, compression in (("churn", "int8"),
                                     ("crash_restart", "none")):
            rc = rc_of(compression).replace(
                elastic=ElasticConfig(**ELASTIC[process]))
            saves.clear()
            with tempfile.TemporaryDirectory() as d:
                def runs():
                    whole = run_scenario(rc, "cuda", ckpt_dir=f"{d}/whole")[0]
                    run_scenario(rc, "cuda", n_steps=6, ckpt_dir=f"{d}/split")
                    rest = run_scenario(rc, "cuda", ckpt_dir=f"{d}/split")[0]
                    manifests = [json.loads(Path(
                        f"{d}/{k}/step_{MAIN_STEPS:09d}/manifest.json"
                    ).read_text()) for k in ("whole", "split")]
                    return whole, rest, manifests

                (whole, rest, manifests), n = drive(runs)
            steps = 2 * MAIN_STEPS
            assert n == expect(dual_update=steps, slot_rotate=steps
                               if compression == "int8" else 0), n
            la = checkpoint._flatten_with_paths(whole["state"])
            lb = checkpoint._flatten_with_paths(rest["state"])
            assert [k for k, _ in la] == [k for k, _ in lb]
            for (k, x), (_, y) in zip(la, lb):
                assert torch.equal(x, y), k
            assert manifests[0] == manifests[1]
            assert {"pipeline", "elastic_process", "health"} <= set(
                manifests[0]["extra"])
            events = whole["remesh_events"]
            evicts = [e for e in events if e["event"] == "evict"]
            assert evicts and any(e["event"] == "readmit" for e in events), \
                events
            for e in evicts:
                assert ("whole", e["step"] + 1, e["plan"]) in saves, (e, saves)
            assert [e for e in rest["remesh_events"]] == [
                e for e in events if e["step"] >= 6]
            out[process] = dict(
                launches=n, leaves=len(la), remesh_events=events,
                active_workers=[h["active_workers"]
                                for h in whole["history"]],
                applied_count=[h["applied_count"]
                               for h in whole["history"]],
                checkpoints=sorted({s for k, s, _ in saves if k == "whole"}))
            log(f"phase 14: {process} {compression}: restart at 6 equals "
                f"the 12-step run bit for bit ({len(la)} leaves); "
                f"{json.dumps(out[process])}")
    finally:
        checkpoint.save = save
    return out


def scenario_phase(drive, expect):
    """Phase 14 on amb-linreg: 14a the schedule golden trace, 14b
    ``train`` under the schedules, 14c elastic workers and restarts."""
    import torch
    # the golden errors are held at rtol 1e-4: f32 products without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    out["golden"], n = drive(schedule_golden_phase)
    assert n == expect(), n       # the simulator's pytree master
    for scheme, (updates, rel) in out["golden"].items():
        log(f"phase 14: batch_schedule_trace {scheme}: {updates} updates, "
            f"exact columns equal, errors within rtol {rel:.3e} <= 1e-4")
    out["train"] = schedule_train_phase(drive, expect)
    out["elastic"] = elastic_restart_phase(drive, expect)
    return out


# -- the decentralized gossip (phase 15) ---------------------------------------
DEC_STEPS = 6          # 12 until phase 17 came (cut for the time limit)
# 3 CNN steps a run: the profiler's record of the ~5,000 kernels of a
# decentralized CNN step takes seconds to read, and 6 steps a run took
# phase 15 past 120 s
DEC_CNN_STEPS = 3
# the CNN's CPU references run the first of those steps: the CPU's
# gossip at 4 x 53,248 rows takes 2-6 s a step (the card's 5-20 ms), and
# phase 15 keeps within 120 s (the CPU's second steps took 20 s)
DEC_CNN_CPU_STEPS = 1
DEC_LM_STEPS = 2
DEC_FNS = ("run_consensus_fold", "run_consensus_fold_int8",
           "run_consensus_fold_masked")
# card against CPU, f32, TF32 off. The linreg runs hold phase 3's limits:
# counts exact, losses to DEC_RTOL; z and every worker's w to DEC_RTOL of
# their largest element plus, under int8, one quantization step of the
# row (a last-bit difference of the two devices' messages can flip one
# rounding of the gossip). A consensus error is the norm of a difference
# of nearly equal duals, so it is held to DEC_RTOL of itself plus
# DEC_RTOL of the largest dual's norm. 15a's golden setting (d = 32)
# holds 1e-5. The CNN holds phase 13's limits (CNN_LOSS_RTOL; z, like
# w = -alpha z, to CNN_W_TOL: its first convolutions' f32 gradients are
# 1e-3 of a leaf apart on the two devices, phase 13a).
# Under int8 those limits hold step by step (``dec_lockstep``: each card
# step starts from the CPU's state before it). Run freely, the two
# devices' trajectories part: a last-bit difference of the messages
# flips a rounding somewhere in 59 rounds x 12 steps, the flip moves w
# and so every later gradient. The free runs' losses read 1.06e-3 apart
# after 12 steps (15b; NVIDIA H100 80GB HBM3, 700 W) and are held to
# DEC_INT8_FREE_RTOL,
# ten times that; their z and w gaps are reported.
DEC_RTOL = 1e-4
DEC_INT8_FREE_RTOL = 1e-2


@contextlib.contextmanager
def gossip_marked():
    """Bracket every gossip call of the decentralized step with a short
    spin kernel before and after (``profiled(..., marks=True)`` keeps
    them as MARK), so a profiler record shows which kernels are the
    gossip's. Two spins of MARK_CYCLES a step; the step is otherwise the
    one a user runs."""
    import torch
    from repro_torch.core import consensus
    saved = {name: getattr(consensus, name) for name in DEC_FNS}

    def marked(fn):
        def call(*args, **kw):
            torch.cuda._sleep(MARK_CYCLES)
            out = fn(*args, **kw)
            torch.cuda._sleep(MARK_CYCLES)
            return out
        return call

    for name, fn in saved.items():
        setattr(consensus, name, marked(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(consensus, name, fn)


def gossip_split(kernels, n_steps):
    """The profiler's device time per step between the gossip's marks
    (``gossip``) and outside them: cuDNN's convolutions, cuBLAS
    products, the flash kernels, the rest; copies apart. Also the
    kernels launched per step (marks and copies apart)."""
    groups = collections.Counter()
    inside, n_marks, n_kernels = False, 0, 0
    for name, us in kernels:
        if name == MARK:
            inside, n_marks = not inside, n_marks + 1
            continue
        low = name.lower()
        if name.startswith(("Memcpy", "Memset")):
            g = "copy"
        elif inside:
            g = "gossip"
        elif "flash_" in name:
            g = "attention"
        elif any(t in low for t in ("conv", "fprop", "dgrad", "wgrad",
                                    "cudnn", "implicit")):
            g = "cudnn_conv"
        elif any(t in low for t in ("gemm", "cutlass", "nvjet", "xmma",
                                    "cublas")):
            g = "cublas"
        else:
            g = "rest"
        if g != "copy":
            n_kernels += 1
        groups[g] += us / 1e3 / n_steps
    assert n_marks == 2 * n_steps and not inside, (n_marks, n_steps)
    total = sum(v for k, v in groups.items() if k != "copy")
    return dict({f"{k}_ms": groups.get(k, 0.0) for k in (
        "gossip", "cudnn_conv", "cublas", "attention", "rest", "copy")},
        gossip_share=groups.get("gossip", 0.0) / total if total else 0.0,
        kernels_per_step=n_kernels / n_steps)


def profiled_kernels_of(run, n_steps):
    """(``run()``'s result, its kernels with the gossip's marks): the
    profiler's record of one marked run, run again while a record is
    empty or lost marks (see ``profiled``)."""
    for _ in range(PROFILER_TRIES):
        with gossip_marked():
            result, kernels = profiled(run, marks=True)
        if kernels and sum(k == MARK for k, _ in kernels) == 2 * n_steps:
            return result, kernels
        log("note: the profiler's record of a phase 15 run was empty or "
            "incomplete; running it again")
    raise RuntimeError(f"torch.profiler recorded no complete record in "
                       f"{PROFILER_TRIES} runs")


def dec_config(cfg, rc, n, compression="none", topology="ring",
               elastic=None, rounds=0):
    """(cfg, ``rc`` as the decentralized strategy): n workers on
    ``topology``, the dense fold, eq. (24)'s rounds unless ``rounds``."""
    from repro_torch.configs.base import ConsensusConfig, ElasticConfig
    rc = rc.replace(strategy="decentralized", consensus=ConsensusConfig(
        topology=topology, n_workers=n, rounds=rounds, gossip_impl="dense",
        compression=compression))
    if elastic is not None:
        rc = rc.replace(elastic=ElasticConfig(**elastic))
    return cfg, rc


def dec_train(cfg, rc, device, n_steps, n_workers, spw, spy=None):
    """One ``train`` run: (result, seconds). ``spy(state, batch, new
    state, metrics)`` sees every step of the strategy ``train`` builds."""
    from repro_torch import api
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    build = api.build

    def spied(*args, **kw):
        s = build(*args, **kw)
        step = s.train_step

        def call(state, batch):
            new, m = step(state, batch)
            spy(state, batch, new, m)
            return new, m

        s.train_step = call
        return s

    if spy is not None:
        api.build = spied
    loop = LoopConfig(n_steps=n_steps, n_workers=n_workers,
                      samples_per_worker=spw, log_every=1)
    t0 = time.perf_counter()
    try:
        out = train(build_model(cfg, device=device), rc, loop, device=device)
    finally:
        api.build = build
    return out, time.perf_counter() - t0


def state_gaps(sg, sc, compression, w_rtol):
    """A card DecentralizedState against a CPU one: (z's largest gap over
    ``w_rtol`` of z's largest element, the weights' largest gap over
    ``w_rtol`` of the leaf's largest, under int8 each limit plus one
    quantization step of the row (z: its largest magnitude / 127, the
    bf16 scale at most 2^-8 above) or of the worker's largest row (w);
    that step's largest; the largest dual's norm)."""
    import torch
    from repro_torch.core.arena import tree_flatten
    zg, zc = sg.z.cpu(), sc.z
    n = zc.shape[0]
    z_norm = float(torch.linalg.vector_norm(zc.reshape(n, -1), dim=1).max())
    q_row = (zc.abs().amax(dim=-1, keepdim=True) / 127.0 * (1 + 2.0 ** -8)
             if compression == "int8" else torch.zeros(zc.shape[:-1] + (1,)))
    z_gap = float(((zg - zc).abs()
                   / (w_rtol * zc.abs().max() + q_row)).max())
    q_worker = q_row.reshape(n, -1).amax(dim=1)
    w_gap = 0.0
    for k, wg, wc in zip(leaf_names(sc.params), tree_flatten(sg.params)[0],
                         tree_flatten(sc.params)[0]):
        wg = wg.cpu()
        assert bool(torch.isfinite(wg).all()), k
        lim = (w_rtol * wc.abs().max()
               + q_worker.reshape((n,) + (1,) * (wc.dim() - 1)))
        w_gap = max(w_gap, float(((wg - wc).abs() / lim).max()))
    return z_gap, w_gap, float(q_row.max()), z_norm


def compare_dec(gpu, cpu, compression, rtol, w_rtol):
    """A decentralized run on the card against the CPU: applied and local
    counts exact; the losses' largest relative gap; consensus errors
    against ``rtol`` of themselves plus ``rtol`` of the largest dual's
    norm (plus a quantization step under int8); the final z and weights
    to ``w_rtol`` (``state_gaps``). Returns the readings, the
    ``*_over_limit`` ones to be at most 1."""
    hg, hc = gpu["history"], cpu["history"]
    assert len(hg) == len(hc), (len(hg), len(hc))
    for t, (a, b) in enumerate(zip(hg, hc)):
        assert a["applied_count"] == b["applied_count"], (t, a, b)
        assert a["local_count"] == b["local_count"], (t, a, b)
        assert math.isfinite(a["loss"]) and math.isfinite(
            a["consensus_error"]), (t, a)
    z_gap, w_gap, q, z_norm = state_gaps(gpu["state"], cpu["state"],
                                         compression, w_rtol)
    return dict(
        loss_rel_gap=max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                         for a, b in zip(hg, hc)),
        consensus_error_over_limit=max(
            abs(a["consensus_error"] - b["consensus_error"])
            / (rtol * abs(b["consensus_error"]) + rtol * z_norm + q)
            for a, b in zip(hg, hc)),
        z_over_limit=z_gap, w_over_limit=w_gap, int8_step=q,
        dual_norm=z_norm)


def dec_lockstep(cfg, rc, record, compression, rtol, w_rtol):
    """Every step of a CPU run (``record``: (state, batch, new state,
    metrics) a step) run again on the card from the CPU's state before
    it, on the same batch: applied counts exact, and the largest loss,
    consensus-error, z and weight gaps of any step against the CPU's
    (``compare_dec``'s limits). Returns the readings."""
    import torch
    from repro_torch import api
    from repro_torch.core.arena import tree_map
    from repro_torch.models.api import build_model
    s = api.build(build_model(cfg, device="cuda"), rc, device="cuda")
    worst = dict(loss_rel_gap=0.0, consensus_error_over_limit=0.0,
                 z_over_limit=0.0, w_over_limit=0.0)
    for state, batch, new, m in record:
        sg, mg = s.train_step(
            type(state)(*[tree_map(lambda x: x.cuda(), f) for f in state]),
            {k: v.cuda() for k, v in batch.items()})
        assert float(mg["applied_count"]) == float(m["applied_count"])
        z_gap, w_gap, q, z_norm = state_gaps(sg, new, compression, w_rtol)
        ce = float(m["consensus_error"])
        gaps = dict(
            loss_rel_gap=abs(float(mg["loss"]) - float(m["loss"]))
            / abs(float(m["loss"])),
            consensus_error_over_limit=abs(float(mg["consensus_error"]) - ce)
            / (rtol * abs(ce) + rtol * z_norm + q),
            z_over_limit=z_gap, w_over_limit=w_gap)
        worst = {k: max(v, gaps[k]) for k, v in worst.items()}
    return worst


def assert_dec(gaps, rtol, label):
    assert gaps["loss_rel_gap"] <= rtol, (label, gaps)
    for k in ("consensus_error_over_limit", "z_over_limit", "w_over_limit"):
        assert gaps[k] <= 1.0, (label, k, gaps)


def gossip_round_ms(split, rounds, z):
    """The gossip's device time a round against the least bytes a round
    moves (the (n, rows, 128) f32 messages read once and written once)
    at HBM_BYTES_PER_S: (ms a round, bound ms a round, the array passes
    the measured time is worth)."""
    ms = split["gossip_ms"] / rounds
    array_ms = 1e3 * z.numel() * 4 / HBM_BYTES_PER_S
    return ms, 2 * array_ms, ms / array_ms


def dec_golden_phase(drive, expect):
    """Phase 15a: ``tests/golden/decentralized_trace.json``'s setting
    (linreg d = 32, 4 workers, ring, r = 3, dense, 8 steps) on the card
    and the CPU, on numpy batches (the golden's own come from JAX's
    threefry: the CPU tests hold those). rounds, times and steps equal
    the JSON; losses and consensus errors card vs CPU to rtol 1e-5 (the
    latter plus 1e-5 of the largest dual's norm). Returns {compression:
    record}."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.configs.base import (AmbdgConfig, MeshConfig, RunConfig,
                                          TRAIN_4K)
    from repro_torch.models.api import build_model
    golden = json.loads((Path(__file__).resolve().parent / "tests" /
                         "golden" / "decentralized_trace.json").read_text())
    cfg = linreg_config(32)
    batches = []
    for t in range(1, 9):
        rng = np.random.default_rng(1000 + t)
        w_star = rng.standard_normal(32).astype(np.float32)
        x = rng.standard_normal((32, 32)).astype(np.float32)
        y = (x @ w_star + np.sqrt(1e-3) * rng.standard_normal(32)).astype(
            np.float32)
        batches.append(dict(x=x, y=y, weights=np.ones(32, np.float32)))
    out = {}
    for compression in ("none", "int8"):
        _, rc = dec_config(cfg, RunConfig(
            model=cfg, shape=TRAIN_4K,
            mesh=MeshConfig(n_pods=1, data=1, model=1),
            ambdg=AmbdgConfig(t_p=2.5, t_c=10.0, tau=1, n_microbatches=2,
                              b_bar=32.0, smoothness_L=1.0)), 4,
            compression, rounds=3)
        runs = {}
        for dev in ("cuda", "cpu"):
            def run():
                s = api.build(build_model(cfg, device=dev), rc, device=dev)
                state, rows = s.init_state(), []
                for b in batches:
                    state, m = s.train_step(state, {
                        k: torch.from_numpy(v).to(dev) for k, v in b.items()})
                    rows.append((float(m["loss"]),
                                 float(m["consensus_error"]), int(m["step"]),
                                 float(torch.linalg.vector_norm(
                                     state.z.reshape(4, -1), dim=1).max())))
                return s, rows
            (s, rows), n = drive(run)
            assert n == expect(), n
            runs[dev] = rows
        tm = type(s).timeline_model()
        want = golden[compression]
        assert s.rounds == want["rounds"], (s.rounds, want["rounds"])
        assert [round(tm.update_time(t, 2.5, 10.0), 9)
                for t in range(1, 9)] == want["times"]
        assert [r[2] for r in runs["cuda"]] == want["steps"]
        assert [r[2] for r in runs["cpu"]] == want["steps"]
        loss_gap = max(abs(a[0] - b[0]) / abs(b[0])
                       for a, b in zip(runs["cuda"], runs["cpu"]))
        ce_gap = max(abs(a[1] - b[1]) / (1e-5 * abs(b[1]) + 1e-5 * b[3])
                     for a, b in zip(runs["cuda"], runs["cpu"]))
        out[compression] = dict(
            rounds=s.rounds, loss=[r[0] for r in runs["cuda"]],
            consensus_error=[r[1] for r in runs["cuda"]],
            loss_rel_gap=loss_gap, consensus_error_over_limit=ce_gap)
        log(f"phase 15a: golden setting {compression}: rounds, times and "
            f"steps equal the golden; card vs cpu: loss rel gap "
            f"{loss_gap:.3e} <= 1e-5, consensus error {ce_gap:.3f} of its "
            f"limit; losses {out[compression]['loss']}")
        assert loss_gap <= 1e-5 and ce_gap <= 1.0, out[compression]
    return out


def dec_linreg_phase(drive, expect):
    """Phases 15b-c: amb-linreg FULL (d = 10^4) through ``train``, 10
    workers x 150 samples on a ring with eq. (24)'s 59 rounds, the l2
    ball: DEC_STEPS steps with "none" and "int8" (15b), then "none" under the
    churn worker process (15c, ``ELASTIC["churn"]``), card then CPU
    (``compare_dec``). 15b runs one more step under
    ``torch.cuda.set_sync_debug_mode("error")``; under int8 the limits
    hold step by step (``dec_lockstep``) and the free runs' losses to
    DEC_INT8_FREE_RTOL. 15c checks every step's
    ``active_workers`` against the host's draw and that a dead worker's z
    row and weights equal the previous step's bit for bit. No port
    kernel launches (there is no master). Returns {label: record}."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core.worker_process import make_worker_process
    from repro_torch.data.pipeline import AnytimePipeline
    from repro_torch.data.timing import ShiftedExponential
    from repro_torch.models.api import build_model
    cfg, rc_of = main_path_config()
    out = {}
    for label, compression, elastic in (("none", "none", None),
                                        ("int8", "int8", None),
                                        ("churn", "none", ELASTIC["churn"])):
        # 150 samples a worker: 2 microbatches of 75
        rc0 = rc_of("none")
        _, rc = dec_config(cfg, rc0.replace(ambdg=dataclasses.replace(
            rc0.ambdg, n_microbatches=2)), 10, compression, elastic=elastic)
        seen = []

        def spy(state, batch, new, m):
            if "active" in batch:
                seen.append((batch["active"], state, new))

        def run():
            return dec_train(cfg, rc, "cuda", DEC_STEPS, 10, 150, spy)

        # 15c's step is 15b's with a mask: its run goes unprofiled
        ((gpu, secs), kernels), n = drive(
            (lambda: (run(), None)) if elastic else
            (lambda: profiled_kernels_of(run, DEC_STEPS)))
        assert n == expect(), (label, n)
        record = []
        cpu, cpu_secs = dec_train(
            cfg, rc, "cpu", DEC_STEPS, 10, 150,
            (lambda *a: record.append(a)) if compression == "int8" else None)
        gaps = compare_dec(gpu, cpu, compression, DEC_RTOL, DEC_RTOL)
        s = api.build(build_model(cfg, device="cuda"), rc, device="cuda")
        assert s.rounds == 59, s.rounds
        rec = dict(rounds=s.rounds, gpu_s=secs, cpu_s=cpu_secs, launches=n,
                   loss=[h["loss"] for h in gpu["history"]],
                   consensus_error=[h["consensus_error"]
                                    for h in gpu["history"]],
                   device_gaps=gaps)
        if kernels is not None:
            rec.update(split=step_split(gpu, kernels),
                       kernel_split=gossip_split(kernels, DEC_STEPS))
        if compression == "int8":
            rec["lockstep_gaps"] = dec_lockstep(cfg, rc, record, compression,
                                                DEC_RTOL, DEC_RTOL)
        if elastic is None and compression == "none":
            # one more step from the run's state, reading nothing back
            pipe = AnytimePipeline(cfg, 10, 150, seed=rc.seed + 1,
                                   timing=ShiftedExponential(),
                                   t_p=rc.ambdg.t_p)
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in pipe.next_global_batch().items()}
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                _, m = s.train_step(gpu["state"], batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert math.isfinite(float(m["loss"]))
            rec["step_without_sync"] = True
        if elastic is not None:
            draws = make_worker_process(rc.elastic, 10)
            assert len(seen) == DEC_STEPS
            dead_seen = 0
            for t, (active, old, new) in enumerate(seen):
                drawn = draws.step()[0]
                assert np.array_equal(active.cpu().numpy() > 0, drawn), t
                assert gpu["history"][t]["active_workers"] == float(
                    drawn.sum()), t
                dead = active == 0
                dead_seen += int(dead.sum())
                assert torch.equal(new.z[dead], old.z[dead]), t
                assert torch.equal(new.params["w"][dead],
                                   old.params["w"][dead]), t
            assert dead_seen, "the churn draw killed no worker"
            rec["active_workers"] = [h["active_workers"]
                                     for h in gpu["history"]]
        out[label] = rec
        sub = "c" if elastic else "b"
        shown = {k: rec[k] for k in ("lockstep_gaps", "loss",
                                     "consensus_error", "active_workers",
                                     "step_without_sync") if k in rec}
        log(f"phase 15{sub}: linreg FULL {label}: {s.rounds} rounds; "
            f"{DEC_STEPS} steps on cuda in {secs:.2f} s, on cpu in "
            f"{cpu_secs:.2f} s; launches {n}; card vs cpu "
            f"{json.dumps(gaps)}; {json.dumps(shown)}")
        if kernels is not None:
            log(f"phase 15{sub}: {label}: step split "
                f"{json.dumps(rec['split'])}; kernel time per step "
                f"{json.dumps(rec['kernel_split'])}")
        if compression == "int8":
            assert gaps["loss_rel_gap"] <= DEC_INT8_FREE_RTOL, (label, gaps)
            assert_dec(rec["lockstep_gaps"], DEC_RTOL, label)
        else:
            assert_dec(gaps, DEC_RTOL, label)
        del gpu, cpu, seen, record
    return out


def dec_cnn_phase(drive, expect):
    """Phase 15d: amb-cnn FULL (6,805,642 parameters) decentralized,
    fig5_nn.py's 4 workers x 128 images (4 microbatches of 32, phase 13's
    ``AmbdgConfig``), on a ring (eq. (24): 11 rounds) and a 2 x 2 torus (8
    rounds), "none" and "int8", 3 steps through ``train`` on the card, and
    the first DEC_CNN_CPU_STEPS of them on the CPU: counts exact, losses
    to CNN_LOSS_RTOL, z and every worker's weights within CNN_W_TOL of
    the largest element plus a quantization step
    (``compare_dec``; under int8 step by step, ``dec_lockstep``, and the
    free runs' losses to DEC_INT8_FREE_RTOL); the step split, the kernel
    split with the gossip's kernels apart, the gossip's ms a round against
    its bytes, and the peak memory. Returns {label: record}."""
    import torch
    from repro_torch import api
    from repro_torch.models.api import build_model
    out = {}
    for topology, compression in (("ring", "none"), ("ring", "int8"),
                                  ("torus", "none"), ("torus", "int8")):
        cfg, rc = dec_config(*cnn_run_config("none"), CNN_WORKERS,
                             compression, topology)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        early = []

        def keep(state, batch, new, m):
            if len(early) < DEC_CNN_CPU_STEPS:
                early.append(new)

        ((gpu, secs), kernels), n = drive(lambda: profiled_kernels_of(
            lambda: dec_train(cfg, rc, "cuda", DEC_CNN_STEPS, CNN_WORKERS,
                              CNN_PER_WORKER, keep), DEC_CNN_STEPS))
        peak = torch.cuda.max_memory_allocated()
        assert n == expect(), n
        record = []
        cpu, cpu_secs = dec_train(
            cfg, rc, "cpu", DEC_CNN_CPU_STEPS, CNN_WORKERS, CNN_PER_WORKER,
            (lambda *a: record.append(a)) if compression == "int8" else None)
        gaps = compare_dec(
            {"history": gpu["history"][:DEC_CNN_CPU_STEPS],
             "state": early[-1]}, cpu, compression, CNN_LOSS_RTOL, CNN_W_TOL)
        rounds = api.build(build_model(cfg, device="cuda"), rc,
                           device="cuda").rounds
        assert rounds == {"ring": 11, "torus": 8}[topology], rounds
        split = gossip_split(kernels, DEC_CNN_STEPS)
        ms, bound, passes = gossip_round_ms(split, rounds, gpu["state"].z)
        label = f"{topology}_{compression}"
        out[label] = rec = dict(
            rounds=rounds, gpu_s=secs, cpu_s=cpu_secs, launches=n,
            loss=[h["loss"] for h in gpu["history"]],
            consensus_error=[h["consensus_error"] for h in gpu["history"]],
            device_gaps=gaps, peak_mem_gb=peak / 1e9,
            split=step_split(gpu, kernels), kernel_split=split,
            gossip_ms_per_round=ms, gossip_bound_ms_per_round=bound,
            gossip_array_passes_per_round=passes)
        if compression == "int8":
            rec["lockstep_gaps"] = dec_lockstep(cfg, rc, record, compression,
                                                CNN_LOSS_RTOL, CNN_W_TOL)
        log(f"phase 15d: cnn {label}: {rounds} rounds; {DEC_CNN_STEPS} steps "
            f"on cuda in {secs:.2f} s, {DEC_CNN_CPU_STEPS} on cpu in "
            f"{cpu_secs:.2f} s; launches "
            f"{n}; loss {[round(x, 4) for x in rec['loss']]}; card vs cpu "
            f"{json.dumps(gaps)}; lockstep "
            f"{json.dumps(rec.get('lockstep_gaps'))}; peak "
            f"{rec['peak_mem_gb']:.2f} GB")
        log(f"phase 15d: cnn {label}: step split {json.dumps(rec['split'])}; "
            f"kernel time per step {json.dumps(split)}; gossip {ms:.4f} ms a "
            f"round against {bound:.4f} ms for one read and one write of the "
            f"messages ({passes:.1f} array passes)")
        held = gaps
        if compression == "int8":
            assert gaps["loss_rel_gap"] <= DEC_INT8_FREE_RTOL, (label, gaps)
            held = rec["lockstep_gaps"]
        assert held["loss_rel_gap"] <= CNN_LOSS_RTOL, (label, held)
        for k in ("z_over_limit", "w_over_limit"):
            assert held[k] <= 1.0, (label, k, held)
        del gpu, cpu, record, early
    return out


def dec_lm_phase(drive, expect):
    """Phase 15e: qwen1.5-0.5b at full width with 2 layers, seq 256, f32,
    ``attn_impl="flash"`` (no block remat), decentralized over 4 workers
    x 2 sequences (2 microbatches of one), ring, int8, eq. (24)'s 11
    rounds, 2 steps through ``train`` on the card: the flash forward
    (with lse), dq and dk/dv each launch workers x layers x microbatches
    times a step; losses and consensus errors finite; the peak memory
    and the gossip's share of the kernel time. Returns the record."""
    import dataclasses
    import torch
    cfg0 = dataclasses.replace(
        lm_config("flash", n_layers=2, compute_dtype="float32"),
        block_remat="none")
    cfg, rc = dec_config(cfg0, lm_run_config(cfg0, 256, 8, 2), 4, "int8")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ((gpu, secs), kernels), n = drive(lambda: profiled_kernels_of(
        lambda: dec_train(cfg, rc, "cuda", DEC_LM_STEPS, 4, 2),
        DEC_LM_STEPS))
    peak = torch.cuda.max_memory_allocated()
    want = DEC_LM_STEPS * 4 * cfg.n_layers * 2
    assert n == expect(flash_fwd_lse=want, flash_bwd_dq=want,
                       flash_bwd_dkv=want), n
    hist = gpu["history"]
    for h in hist:
        assert math.isfinite(h["loss"]) and math.isfinite(
            h["consensus_error"]), h
    split = gossip_split(kernels, DEC_LM_STEPS)
    ms, bound, passes = gossip_round_ms(split, 11, gpu["state"].z)
    rec = dict(gpu_s=secs, launches=n, peak_gib=peak / 2 ** 30,
               loss=[h["loss"] for h in hist],
               consensus_error=[h["consensus_error"] for h in hist],
               split=step_split(gpu, kernels), kernel_split=split,
               gossip_ms_per_round=ms, gossip_bound_ms_per_round=bound)
    shown = {k: v for k, v in rec.items()
             if k not in ("split", "kernel_split", "launches")}
    log(f"phase 15e: qwen1.5-0.5b 2 layers decentralized int8: "
        f"{DEC_LM_STEPS} steps in {secs:.2f} s; launches {n}; "
        f"{json.dumps(shown)}")
    log(f"phase 15e: step split {json.dumps(rec['split'])}; kernel time per "
        f"step {json.dumps(split)}; gossip {ms:.4f} ms a round against "
        f"{bound:.4f} ({passes:.1f} array passes)")
    del gpu
    torch.cuda.empty_cache()
    return rec


def decentralized_phase(drive, expect):
    """Phase 15: the decentralized gossip (15a-e), TF32 off; each part's
    seconds in ``parts_s``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, parts_s = {}, {}
    for part, key, fn in (("15a", "golden", dec_golden_phase),
                          ("15b-c", "linreg", dec_linreg_phase),
                          ("15d", "cnn", dec_cnn_phase),
                          ("15e", "lm", dec_lm_phase)):
        t0 = time.perf_counter()
        out[key] = fn(drive, expect)
        parts_s[part] = time.perf_counter() - t0
        log(f"phase {part}: {parts_s[part]:.1f} s")
    out["parts_s"] = parts_s
    return out


# -- phase 16: train-while-serve -------------------------------------------------
SERVE_DEVICE_TOL = 1e-4     # 16b: logits and caches, of the largest |value|
SERVE_SLOTS_ZAMBA = 8
SERVE_WARMUP, SERVE_TIMED, SERVE_TIMED_ZAMBA = 32, 64, 32
SERVE_PROFILED = 8          # engine steps under the profiler (16c)
SERVE_Z_LAYERS = 12         # zamba2 in 16c: 2 groups of 6 Mamba2 layers


def serve_golden_phase(drive, expect):
    """Phase 16a: ``tests/test_serve.py::_golden_trace`` with the engine
    and the publisher on the card (qwen1.5-0.5b SMOKE, 3 slots, max_len
    32, max_new 4, Poisson 0.7, publish every 3, bound 6, seed 5, 40
    steps): every row, ``completed`` and ``admitted`` equal
    ``tests/golden/serve_trace.json`` and every served staleness is within
    the bound. Returns the record."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.arena import make_layout
    from repro_torch.models.api import build_model
    from repro_torch.serve import Engine, RequestQueue, WeightPublisher

    def run():
        model = build_model(get_smoke_config("qwen1.5-0.5b"), device="cuda")
        sc = ServeConfig(slots=3, max_len=32, max_new=4, arrival="poisson",
                         arrival_rate=0.7, publish_period=3,
                         staleness_bound=6, prompt_len_min=2,
                         prompt_len_max=6, seed=5)
        engine = Engine(model, sc.slots, sc.max_len)
        queue = RequestQueue(sc, model.cfg.vocab_size)
        pub = WeightPublisher(make_layout(engine.params), sc, device="cuda")
        engine.attach_publisher(pub)
        rows = []
        for t in range(40):
            slot = pub.publish(engine.params, t) \
                if t % sc.publish_period == 0 else -1
            stale = engine.refresh_weights(t) if t % 5 == 0 else None
            arrived = queue.step()
            ev = engine.step(queue)
            rows.append({"step": t, "arrived": arrived,
                         "admits": ev["admits"], "evicts": ev["evicts"],
                         "active": ev["active"], "queued": ev["queued"],
                         "publish_slot": slot, "staleness": stale})
        return rows, engine, sc

    (rows, engine, sc), n = drive(run)
    assert n == expect(), n       # decoding launches no kernel of the port
    want = json.loads((Path(__file__).resolve().parent / "tests" / "golden"
                       / "serve_trace.json").read_text())
    assert rows == want["trace"]
    assert (engine.stats.completed, engine.stats.admitted) == (
        want["completed"], want["admitted"])
    served = [r["staleness"] for r in rows if r["staleness"] is not None]
    assert served and all(0 <= s <= sc.staleness_bound for s in served)
    rec = dict(steps=len(rows), completed=engine.stats.completed,
               admitted=engine.stats.admitted, served_staleness=served)
    log(f"phase 16a: golden serve trace on the card: {len(rows)} rows "
        f"equal; {json.dumps(rec)}")
    return rec


class RecordingModel:
    """A model whose ``decode_step`` also keeps each step's logits (f32,
    on the host); everything else is the wrapped model's."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, *args):
        logits, cache = self.model.decode_step(*args)
        self.logits.append(logits[:, -1].float().cpu())
        return logits, cache


def serve_device_run(cfg, device, prompts, n_steps):
    """16 engine steps of ``cfg`` (f32 compute, f32 KV cache) on
    ``device`` with ``prompts`` in 3 slots: (tokens fed back a step,
    logits a step, the final cache on the host)."""
    import torch
    from repro_torch.core.arena import tree_map
    from repro_torch.models.api import build_model
    from repro_torch.serve import Engine
    from repro_torch.serve.engine import _StaticQueue
    from repro_torch.serve.request_queue import Request
    model = build_model(cfg, device=device)
    engine = Engine(model, len(prompts), 64)
    for name in ("cache", "_cache0"):
        setattr(engine, name,
                model.init_decode_state(len(prompts), 64, torch.float32)[0])
    engine.model = RecordingModel(model)
    q = _StaticQueue(Request(i, p, max_new=64) for i, p in
                     enumerate(prompts))
    outs = []
    for _ in range(n_steps):
        engine.step(q)
        outs.append([list(o) for o in engine._out])
    return outs, engine.model.logits, tree_map(lambda a: a.cpu(),
                                               engine.cache)


def compare_serve_devices(drive, expect, phase, label, cfg, prompts,
                          n_steps):
    """The engine on the card against the CPU (``serve_device_run``):
    each step's logits and the final caches within SERVE_DEVICE_TOL of
    the largest |value|; the greedy tokens equal (where one differs: its
    step and the top-2 margin, which must lie under that limit); no
    kernel of the port launched. Returns the record."""
    import torch
    from repro_torch.core.arena import tree_flatten
    t0 = time.perf_counter()
    (gpu_out, gpu_logits, gpu_cache), n = drive(
        lambda: serve_device_run(cfg, "cuda", prompts, n_steps))
    gpu_s = time.perf_counter() - t0
    assert n == expect(), n
    t0 = time.perf_counter()
    cpu_out, cpu_logits, cpu_cache = serve_device_run(cfg, "cpu", prompts,
                                                      n_steps)
    cpu_s = time.perf_counter() - t0
    gaps = []
    for t, (a, b) in enumerate(zip(gpu_logits, cpu_logits)):
        gap = float((a - b).abs().max()) / float(b.abs().max())
        gaps.append(gap)
        assert gap <= SERVE_DEVICE_TOL, (label, t, gap)
        ta, tb = a.argmax(-1), b.argmax(-1)
        for i in torch.nonzero(ta != tb).flatten().tolist():
            top2 = torch.topk(b[i], 2).values
            margin = float(top2[0] - top2[1]) / float(b.abs().max())
            log(f"{phase}: {label}: step {t} slot {i}: card token "
                f"{int(ta[i])}, cpu {int(tb[i])}, top-2 margin "
                f"{margin:.3e} of the largest |logit|")
            assert margin <= SERVE_DEVICE_TOL, (label, t, i, margin)
    if gpu_out != cpu_out:
        log(f"{phase}: {label}: the token streams part (a tie within "
            "the limit, logged above)")
    cache_gaps = [float((a - b).abs().max()) / (float(b.abs().max())
                                                or 1.0)
                  for a, b in zip(tree_flatten(gpu_cache)[0],
                                  tree_flatten(cpu_cache)[0])]
    assert all(g <= SERVE_DEVICE_TOL for g in cache_gaps), cache_gaps
    rec = dict(layers=cfg.n_layers, steps=n_steps, gpu_s=gpu_s, cpu_s=cpu_s,
               max_logit_gap=max(gaps), cache_gaps=cache_gaps,
               tokens_equal=gpu_out == cpu_out, tokens=gpu_out[-1])
    log(f"{phase}: {label} {cfg.n_layers} layers f32, {n_steps} engine "
        f"steps: card {gpu_s:.2f} s, cpu {cpu_s:.2f} s; logits within "
        f"{max(gaps):.3e}, caches within {max(cache_gaps):.3e} of the "
        f"largest (limit {SERVE_DEVICE_TOL}); tokens equal: "
        f"{gpu_out == cpu_out}")
    return rec


def serve_device_phase(drive, expect):
    """Phase 16b: the engine on the card against the CPU, f32 compute,
    TF32 off, the same weights: qwen1.5-0.5b FULL at 2 layers and zamba2
    FULL at 6 layers (one shared block), 3 slots with ragged prompts of
    5, 7 and 9 tokens, 16 engine steps (``compare_serve_devices``).
    Returns the record."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch, layers in (("qwen1.5-0.5b", 2), ("zamba2-2.7b", 6)):
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  compute_dtype="float32")
        rng = np.random.default_rng(16)
        prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                   for n in (5, 7, 9)]
        out[arch] = compare_serve_devices(drive, expect, "phase 16b", arch,
                                          cfg, prompts, 16)
    return out


def serve_kernel_split(kernels, n_steps):
    """The profiler's record of ``n_steps`` engine steps split by name:
    cuBLAS/CUTLASS products, dtype-converting copies (the f32 -> bf16
    weight casts and the activations' casts: ``copy`` kernels), the
    rest (memcpy/memset apart); ms and launches per step, and the
    rest's largest kernels."""
    ms, n = collections.Counter(), collections.Counter()
    rest, rest_n = collections.Counter(), collections.Counter()
    for name, us in kernels:
        low = name.lower()
        if name.startswith(("Memcpy", "Memset")):
            g = "memcpy"
        elif any(t in low for t in ("gemm", "cutlass", "nvjet", "xmma",
                                    "cublas", "gemv")):
            g = "cublas"
        elif "copy" in low:
            g = "cast"
        else:
            g = "rest"
            rest[name[:REST_NAME_CHARS]] += us / 1e3 / n_steps
            rest_n[name[:REST_NAME_CHARS]] += 1 / n_steps
        ms[g] += us / 1e3 / n_steps
        n[g] += 1 / n_steps
    out = {f"{g}_ms": ms.get(g, 0.0) for g in ("cublas", "cast", "rest",
                                                "memcpy")}
    out.update({f"{g}_launches": n.get(g, 0.0) for g in
                ("cublas", "cast", "rest", "memcpy")})
    out["rest_top"] = [dict(name=k, ms=v, launches=rest_n[k])
                       for k, v in rest.most_common(8)]
    return out


def serve_load(cfg, slots, n_timed, warmup=SERVE_WARMUP, params=None):
    """Phase 16c for one model: the engine and its request queue from
    ``api.serve`` on the card (the config's bf16 compute, bf16 KV cache;
    the weights ``params``, by default the model's init from seed 0) at
    ``slots`` slots of 512 positions under Poisson traffic of 0.5
    requests a step (prompts of 16-128 tokens, max_new 64): ``warmup``
    steps, then ``n_timed`` timed steps (host clock; each step ends in
    its one read back), then SERVE_PROFILED steps under the profiler.
    Returns the record."""
    import dataclasses
    import torch
    from repro_torch import api
    from repro_torch.configs.base import (MeshConfig, RunConfig, ServeConfig,
                                          TRAIN_4K)
    from repro_torch.core.arena import tree_flatten
    from repro_torch.models.api import build_model
    sc = ServeConfig(slots=slots, max_len=512, max_new=64,
                     arrival="poisson", arrival_rate=0.5, prompt_len_min=16,
                     prompt_len_max=128, seed=16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda")
    if params is not None:
        model = dataclasses.replace(model, init_fn=lambda dev, gen: params)
    engine, queue = api.serve(model, RunConfig(
        model=cfg, shape=TRAIN_4K, mesh=MeshConfig(1, 1, 1), serve=sc),
        device="cuda")

    def steps(n):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            queue.step()
            engine.step(queue)
            times.append(time.perf_counter() - t0)
        return times

    steps(warmup)
    s0 = dataclasses.asdict(engine.stats)
    times = steps(n_timed)
    wall = sum(times)
    prefill = engine.stats.prefill_tokens - s0["prefill_tokens"]
    decode = engine.stats.decode_tokens - s0["decode_tokens"]
    completed = engine.stats.completed - s0["completed"]

    def window():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(SERVE_PROFILED)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for _ in range(PROFILER_TRIES):
        prof_wall, kernels = profiled(window)
        if kernels:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device time in the "
                           "serving window")
    kernel_ms = sum(us for k, us in kernels
                    if not k.startswith(("Memcpy", "Memset"))) / 1e3
    n_params = sum(x.numel() for x in tree_flatten(engine.params)[0])
    # the attention's KV cache (zamba2: the shared block's), or the
    # xLSTM's whole recurrent state
    kv = engine.cache["shared"] if "shared" in engine.cache else engine.cache
    kv_bytes = sum(x.numel() * x.element_size()
                   for x in tree_flatten(kv)[0])
    rec = dict(
        layers=cfg.n_layers, slots=slots, max_len=sc.max_len,
        n_params=n_params, timed_steps=n_timed,
        median_step_ms=statistics.median(times) * 1e3,
        p90_step_ms=sorted(times)[int(0.9 * len(times))] * 1e3,
        prefill_tok_s=prefill / wall, decode_tok_s=decode / wall,
        completed=completed, active_slots_last=engine.in_flight,
        queued_last=len(queue),
        kernels_per_step=len(kernels) / SERVE_PROFILED,
        device_kernel_ms_per_step=kernel_ms / SERVE_PROFILED,
        idle_share=1.0 - kernel_ms / (prof_wall * 1e3),
        # the least bytes a step must move: every f32 weight read once
        # and the whole KV cache (or recurrent state) read once, at
        # 3.35 TB/s
        hbm_floor_ms=(4 * n_params + kv_bytes) / HBM_BYTES_PER_S * 1e3,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        split=serve_kernel_split(kernels, SERVE_PROFILED))
    del engine, model
    torch.cuda.empty_cache()
    return rec


def serve_load_phase():
    """Phase 16c: serving at full size (``serve_load``): qwen1.5-0.5b FULL
    (24 layers, 16 slots, SERVE_TIMED steps) and zamba2-2.7b at full
    width and SERVE_Z_LAYERS layers (SERVE_SLOTS_ZAMBA slots,
    SERVE_TIMED_ZAMBA steps). Returns the record."""
    import dataclasses
    from repro_torch.configs import get_config
    out = {"qwen1.5-0.5b": serve_load(get_config("qwen1.5-0.5b"), 16,
                                      SERVE_TIMED),
           "zamba2-2.7b": serve_load(dataclasses.replace(
               get_config("zamba2-2.7b"), n_layers=SERVE_Z_LAYERS),
               SERVE_SLOTS_ZAMBA, SERVE_TIMED_ZAMBA)}
    for arch, r in out.items():
        split = r["split"]
        log(f"phase 16c: {arch} {r['layers']} layers, {r['slots']} slots: "
            f"median step {r['median_step_ms']:.3f} ms (p90 "
            f"{r['p90_step_ms']:.3f}); prefill {r['prefill_tok_s']:.1f} "
            f"tok/s, decode {r['decode_tok_s']:.1f} tok/s; "
            f"{r['kernels_per_step']:.1f} kernels a step, "
            f"{r['device_kernel_ms_per_step']:.3f} ms of kernels a step, "
            f"idle share {r['idle_share']:.3f}; HBM floor "
            f"{r['hbm_floor_ms']:.3f} ms; peak {r['peak_gib']:.2f} GiB")
        log(f"phase 16c: {arch}: kernel split per step " + json.dumps(
            {k: v for k, v in split.items() if k != "rest_top"}))
        for t in split["rest_top"]:
            log(f"phase 16c: {arch}: rest {t['ms']:.4f} ms/step "
                f"({t['launches']:.1f} launches/step): {t['name']}")
    return out


TWS_STEPS, TWS_PERIOD, TWS_BOUND = 6, 2, 4
TWS_SERVE_STEPS = 3         # engine steps after each refresh (16d)


def train_serve_phase(drive, expect):
    """Phase 16d: train-while-serve. qwen1.5-0.5b at full width, 2
    layers, seq 512, 4 workers x 2 sequences (4 microbatches), tau 2,
    int8, ``attn_impl="flash"``, ``publish_period=2``,
    ``staleness_bound=4``: 6 master steps through ``train`` with a
    checkpoint at step 4. An engine on the same config attaches the
    publisher and refreshes at now = 6..10, serving a step after each.
    Every served staleness within the bound and some > 0; each popped
    tree equals the CPU dequantize of its ring slot bit for bit; each
    slot's int8 bytes and bf16 scale bits equal the CPU quantize of the
    card's w at its publish step; the step-4 checkpoint restores the
    ring, the scales and the publish steps bit for bit, and a run resumed
    from it carries them on. Returns the record."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch import api
    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.arena import (flatten_tree, tree_flatten,
                                        tree_map, unflatten_tree)
    from repro_torch.models.api import build_model
    from repro_torch.optim.compression import (dequantize_int8_rows,
                                               quantize_int8_rows)
    from repro_torch.serve import WeightPublisher
    from repro_torch.train import checkpoint
    from repro_torch.train.loop import LoopConfig, train
    cfg = lm_config("flash", n_layers=2)
    rc = lm_run_config(cfg, 512, 8, 4).replace(serve=ServeConfig(
        slots=4, max_len=64, max_new=4, publish_period=TWS_PERIOD,
        staleness_bound=TWS_BOUND, arrival_rate=1.0, prompt_len_min=4,
        prompt_len_max=8, seed=3))
    published = {}
    publish = WeightPublisher.publish

    def spy(self, params, step):
        published[step] = tree_map(lambda a: a.detach().cpu().clone(),
                                   params)
        return publish(self, params, step)

    def run(d, n_steps):
        return train(build_model(cfg, device="cuda"), rc, LoopConfig(
            n_steps=n_steps, n_workers=4, samples_per_worker=2, log_every=1,
            ckpt_dir=d, ckpt_every=4), device="cuda")

    WeightPublisher.publish = spy
    torch.cuda.empty_cache()
    try:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            out, n_train = drive(lambda: run(f"{d}/run", TWS_STEPS))
            train_s = time.perf_counter() - t0
            # block_remat="full": the forward with lse runs twice a layer
            # and microbatch (the forward and its recomputation)
            want = expect(dual_update=TWS_STEPS, slot_rotate=TWS_STEPS,
                          flash_fwd_lse=2 * 2 * 4 * TWS_STEPS,
                          flash_bwd_dq=2 * 4 * TWS_STEPS,
                          flash_bwd_dkv=2 * 4 * TWS_STEPS)
            assert n_train == want, n_train
            pub = out["publisher"]
            assert pub.pub_step.tolist() == [2, 4, 6] and pub.seq == 3
            # the slots against the CPU quantize of the card's w
            layout = pub.layout
            for k, step in enumerate(pub.pub_step.tolist()):
                q, s = quantize_int8_rows(flatten_tree(layout,
                                                       published[step]),
                                          scale_dtype=torch.bfloat16)
                assert torch.equal(pub.ring[k].cpu(), q), step
                assert torch.equal(pub.scales[k].cpu().view(torch.int16),
                                   s.view(torch.int16)), step
            # the step-4 checkpoint restores the publisher bit for bit
            _, extra = checkpoint.restore(f"{d}/run", out["state"], step=4)
            p4 = WeightPublisher(layout, rc.serve, device="cuda")
            p4.load_state_dict(extra["publisher"])
            assert p4.pub_step.tolist() == [2, 4, -1] and p4.seq == 2
            assert torch.equal(p4.ring[:2], pub.ring[:2])
            assert torch.equal(p4.scales[:2].view(torch.int16),
                               pub.scales[:2].view(torch.int16))
            assert not p4.ring[2].any() and bool((p4.scales[2] == 1).all())
            published.clear()
            resumed, n_res = drive(lambda: run(f"{d}/run", TWS_STEPS))
            rp = resumed["publisher"]
            assert n_res["dual_update"] == TWS_STEPS - 4, n_res
            assert rp.pub_step.tolist() == [2, 4, 6] and rp.seq == 3
            assert torch.equal(rp.ring[:2], pub.ring[:2])
            assert torch.equal(rp.scales[:2].view(torch.int16),
                               pub.scales[:2].view(torch.int16))
            q, s = quantize_int8_rows(flatten_tree(layout, published[6]),
                                      scale_dtype=torch.bfloat16)
            assert torch.equal(rp.ring[2].cpu(), q)
            assert torch.equal(rp.scales[2].cpu().view(torch.int16),
                               s.view(torch.int16))
    finally:
        WeightPublisher.publish = publish
    # an engine on the same config serves what train published
    model = build_model(cfg, device="cuda")

    def serve():
        engine, queue = api.serve(model, rc, publisher=pub, device="cuda")
        stales = []
        for now in range(TWS_STEPS, TWS_STEPS + TWS_BOUND + 1):
            stale = engine.refresh_weights(now)
            stales.append(stale)
            k = pub.due_slot(now)
            w = dequantize_int8_rows(pub.ring[k].cpu(), pub.scales[k].cpu())
            want = unflatten_tree(layout, w, cast=True)
            for a, b in zip(tree_flatten(engine.params)[0],
                            tree_flatten(want)[0]):
                assert torch.equal(a.cpu(), b), now
            for _ in range(TWS_SERVE_STEPS):
                queue.step()
                engine.step(queue)
        return engine, stales

    (engine, stales), n = drive(serve)
    assert n == expect(), n
    assert all(s is not None and 0 <= s <= TWS_BOUND for s in stales)
    assert any(s > 0 for s in stales), stales
    hist = out["history"]
    rec = dict(train_s=train_s, launches=n_train,
               launches_resumed=n_res, loss=[h["loss"] for h in hist],
               pub_step=pub.pub_step.tolist(), served_staleness=stales,
               decode_tokens=engine.stats.decode_tokens,
               completions=engine.completions,
               w_norm=lm_norm(out["state"].params))
    log(f"phase 16d: qwen1.5-0.5b 2 layers train-while-serve: "
        f"{json.dumps(rec)}")
    del out, resumed, engine, model
    torch.cuda.empty_cache()
    return rec


def serve_phase(drive, expect):
    """Phase 16 (16a-d): the golden trace, card against CPU, serving at
    full size, train-while-serve; each part's seconds in ``parts_s``."""
    out, parts_s = {}, {}
    for part, key, fn in (
            ("16a", "golden", lambda: serve_golden_phase(drive, expect)),
            ("16b", "devices", lambda: serve_device_phase(drive, expect)),
            ("16c", "load", serve_load_phase),
            ("16d", "train_serve", lambda: train_serve_phase(drive,
                                                             expect))):
        t0 = time.perf_counter()
        out[key] = fn()
        parts_s[part] = time.perf_counter() - t0
        log(f"phase {part}: {parts_s[part]:.1f} s")
    out["parts_s"] = parts_s
    return out


# -- the MoE slice: mixtral (phase 17) ----------------------------------------
MIX_LAYERS = 1      # of mixtral-8x7b's 32 at full width: 1.71B parameters
MIX_SEQ = 8192      # twice the window of 4096, which masks only past 4096
MIX_STEPS = 3       # the third applies the first delayed update (tau 2)
MIX_MB = 4          # microbatches of 2 sequences a step (4 workers x 2)
MIX_DECODE_STEPS = 48   # 17c: past the SMOKE window of 32 (the buffer wraps)
MIX_SERVE_SLOTS, MIX_SERVE_WARMUP, MIX_SERVE_TIMED = 8, 16, 64


def mix_config(attn_impl, moe_impl="einsum", n_layers=MIX_LAYERS, **kw):
    """mixtral-8x7b FULL at ``n_layers`` layers with ``attn_impl`` and
    ``moe_impl`` (and any overrides)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mixtral-8x7b"), n_layers=n_layers,
                               attn_impl=attn_impl, moe_impl=moe_impl,
                               block_remat="full", **kw)


def router_choices(cfg, params, batch):
    """The experts each token of ``batch`` goes to in the first layer of
    ``cfg``'s model at ``params`` (a no-grad forward with the router
    watched): a (tokens, top_k) tensor, each row sorted."""
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.api import build_model
    seen, router = [], moe_mod._router

    def watched(*a):
        out = router(*a)
        seen.append(out[1])
        return out
    moe_mod._router = watched
    try:
        with torch.no_grad():
            build_model(cfg, device=batch["tokens"].device).loss(params, batch)
    finally:
        moe_mod._router = router
    idx = seen[0]
    return torch.sort(idx.reshape(-1, idx.shape[-1]), dim=-1).values


def moe_dispatch_ms(moe_impl, n_seqs=2):
    """The MoE dispatch's device time, apart from the experts' products:
    one MoE layer at mixtral-8x7b's widths (random weights, bf16 compute)
    on a microbatch of ``n_seqs`` x MIX_SEQ tokens, its forward and its
    forward + backward (the median CUDA-event time a call over
    N_FLASH_TIMED calls, idle gaps between its kernels included: the
    profiler's record of these calls came back incomplete in five
    sessions in a row), less the same for ``_expert_ffn`` alone on the
    (G, E, C, d) rows the dispatch fills. The difference is the router, the top-k,
    the ranks, the one-hot dispatch and combine (einsum) or the gathers,
    scatters and index adds (gather), and their backward. Returns ms a
    call."""
    import torch
    from repro_torch.models import moe as moe_mod
    cfg = mix_config("flash", moe_impl)
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    gen = torch.Generator(device="cuda").manual_seed(17)

    def normal(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).requires_grad_(True)
    p = {"w_router": normal(d, E, scale=d ** -0.5),
         "w_gate": normal(E, d, f, scale=E ** -0.5),
         "w_up": normal(E, d, f, scale=E ** -0.5),
         "w_down": normal(E, f, d, scale=E ** -0.5)}
    x = normal(n_seqs, MIX_SEQ, d).to(torch.bfloat16).detach() \
        .requires_grad_(True)
    xg, g = moe_mod._group(cfg, x)
    C = moe_mod._capacity(cfg, g)
    xe = normal(xg.shape[0], E, C, d).to(torch.bfloat16).detach() \
        .requires_grad_(True)
    weights = list(p.values())
    # fixed cotangents: the backward adds no kernel of its own
    dy, dye = torch.randn_like(x), torch.randn_like(xe)
    one = torch.ones((), device="cuda")

    def moe_fwd():
        with torch.no_grad():
            moe_mod.moe_apply(p, cfg, x)

    def moe_fwd_bwd():
        y, aux = moe_mod.moe_apply(p, cfg, x)
        torch.autograd.grad([y, aux], [x] + weights, [dy, one])

    def ffn_fwd():
        with torch.no_grad():
            moe_mod._expert_ffn(p, cfg, xe)

    def ffn_fwd_bwd():
        ye = moe_mod._expert_ffn(p, cfg, xe)
        torch.autograd.grad(ye, [xe] + weights[1:], dye)

    out = {k: cuda_ms(fn, n=N_FLASH_TIMED, warmup=2) for k, fn in (
        ("moe_fwd", moe_fwd), ("moe_fwd_bwd", moe_fwd_bwd),
        ("experts_fwd", ffn_fwd), ("experts_fwd_bwd", ffn_fwd_bwd))}
    out["dispatch_fwd"] = out["moe_fwd"] - out["experts_fwd"]
    out["dispatch_fwd_bwd"] = out["moe_fwd_bwd"] - out["experts_fwd_bwd"]
    del p, x, xe, weights, dy, dye
    torch.cuda.empty_cache()
    return out


def mixtral_init_phase(drive, expect):
    """Phase 17a: mixtral-8x7b at full width, MIX_LAYERS layer, at the init
    weights on one sequence of MIX_SEQ tokens: the worker's gradient leaf
    by leaf and a no-grad eval, flash (the window in the kernels) against
    xla (the windowed plain mask) in f32 and bf16, and the gather route
    against the einsum route in bf16, with phase 6's limits; the experts
    chosen in the first layer by each route; two launches of the gather
    route give the same bits. Returns the record."""
    import torch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import rmsnorm
    rec = {}
    params0 = build_model(mix_config("flash"), device="cuda").init(
        torch.Generator().manual_seed(0))
    host = TokenStream(mix_config("flash"), seed=1).next_batch(1, MIX_SEQ)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in host.items()}
    names = leaf_names(params0)
    ref32, loss_ref = model_grads(mix_config("xla", compute_dtype="float32"),
                                  params0, batch)
    gaps, losses = {}, {"xla_float32": loss_ref}
    for tag, cfg in (
            ("flash_float32", mix_config("flash", compute_dtype="float32")),
            ("flash_bfloat16", mix_config("flash")),
            ("xla_bfloat16", mix_config("xla")),
            ("flash_bfloat16_gather", mix_config("flash", "gather"))):
        g_, losses[tag] = model_grads(cfg, params0, batch)
        gaps[tag] = leaf_gaps(g_, ref32, names)
        if tag == "flash_bfloat16":
            einsum16 = g_
        elif tag == "flash_bfloat16_gather":
            gaps["gather_vs_einsum_bfloat16"] = leaf_gaps(g_, einsum16,
                                                          names)
            del einsum16
        del g_
        torch.cuda.empty_cache()
    del ref32
    torch.cuda.empty_cache()
    ev = {}
    ev["flash_bfloat16"], n_ev = drive(lambda: lm_eval(
        mix_config("flash"), params0, batch))
    for impl, dt in (("xla", "bfloat16"), ("flash", "float32"),
                     ("xla", "float32")):
        ev[f"{impl}_{dt}"] = lm_eval(mix_config(impl, compute_dtype=dt),
                                     params0, batch)
    ev["flash_bfloat16_gather"] = lm_eval(mix_config("flash", "gather"),
                                          params0, batch)
    # the experts each route picks in the first layer, against xla f32's
    picks = {tag: router_choices(cfg, params0, batch) for tag, cfg in (
        ("xla_float32", mix_config("xla", compute_dtype="float32")),
        ("flash_float32", mix_config("flash", compute_dtype="float32")),
        ("flash_bfloat16", mix_config("flash")),
        ("xla_bfloat16", mix_config("xla")))}
    moved = {f"{a}_vs_{b}": int((picks[a] != picks[b]).any(-1).sum())
             for a, b in (("flash_float32", "xla_float32"),
                          ("flash_bfloat16", "xla_bfloat16"),
                          ("flash_bfloat16", "xla_float32"),
                          ("xla_bfloat16", "xla_float32"))}
    # the gather route's combine (index_add_, atomics) twice: the same bits
    cfg16 = mix_config("flash", "gather")
    layer = {k: v[0] for k, v in params0["layers"]["moe"].items()}
    x = rmsnorm(torch.randn((1, MIX_SEQ, cfg16.d_model), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(17)).to(torch.bfloat16),
                params0["layers"]["ln2"][0], cfg16.norm_eps)
    with torch.no_grad():
        y1, _ = moe_mod.moe_apply_gather(layer, cfg16, x)
        y2, _ = moe_mod.moe_apply_gather(layer, cfg16, x)
    repeat = bool(torch.equal(y1, y2))
    del params0, y1, y2, x, layer
    torch.cuda.empty_cache()
    rec.update(leaves=names, grad_gap_to_f32_xla=gaps, loss=losses, eval=ev,
               eval_launches=n_ev, tokens_routed_elsewhere=moved,
               gather_bitwise_repeat=repeat)
    for i, name in enumerate(names):
        log(f"phase 17a: init weights, gradient {name} against the f32 xla "
            f"gradient: f32 flash {gaps['flash_float32'][i]:.3e}; bf16 flash "
            f"{gaps['flash_bfloat16'][i]:.3e}, xla "
            f"{gaps['xla_bfloat16'][i]:.3e}, flash gather "
            f"{gaps['flash_bfloat16_gather'][i]:.3e}; bf16 gather vs einsum "
            f"{gaps['gather_vs_einsum_bfloat16'][i]:.3e} (of the leaf's "
            f"largest element)")
    log(f"phase 17a: init weights, loss per token of the gradient batch "
        f"{json.dumps(losses)}; no-grad eval {json.dumps(ev)}; eval "
        f"launches {n_ev}; tokens whose first-layer experts differ "
        f"{json.dumps(moved)} of {MIX_SEQ}; gather route bitwise repeat "
        f"{repeat}")
    assert n_ev == expect(flash_fwd=MIX_LAYERS), n_ev
    assert repeat
    for i, name in enumerate(names):
        assert gaps["flash_float32"][i] <= LM_F32_GRAD_TOL, (
            name, gaps["flash_float32"][i])
        assert gaps["flash_bfloat16"][i] <= (
            LM_BF16_GRAD_RATIO * gaps["xla_bfloat16"][i]), (
            name, gaps["flash_bfloat16"][i], gaps["xla_bfloat16"][i])
        assert gaps["flash_bfloat16_gather"][i] <= (
            LM_BF16_GRAD_RATIO * gaps["flash_bfloat16"][i]), (
            name, gaps["flash_bfloat16_gather"][i], gaps["flash_bfloat16"][i])
    for a, b, rtol in (("flash_float32", "xla_float32", LM_F32_RTOL),
                       ("flash_bfloat16", "xla_bfloat16", LM_BF16_RTOL),
                       ("flash_bfloat16_gather", "flash_bfloat16",
                        LM_BF16_RTOL)):
        assert math.isclose(ev[a], ev[b], rel_tol=rtol), (a, b, ev)
        assert math.isclose(losses[a], losses[b], rel_tol=rtol), (
            a, b, losses)
    return rec


def mixtral_train_phase(drive, expect, n_mb=MIX_MB, n_workers=4):
    """Phase 17b: AMB-DG through ``train`` on phase 17a's model at MIX_SEQ
    tokens with phase 6's settings (4 workers x 2 sequences, ``n_mb``
    microbatches, tau 2, int8, full remat, l2 ball, flash), MIX_STEPS steps
    with the einsum dispatch, then with the gather dispatch: counts equal,
    losses within LM_BF16_RTOL, w finite and in the ball; B.1 and B.2 once
    a step, the flash forward with lse twice, dq and dk/dv once per layer
    and microbatch, nothing else; the step split, the peak memory and the
    kernel split (flash, cuBLAS, the rest), with the MoE dispatch's time
    apart (``moe_dispatch_ms``; a step runs each layer's MoE forward
    twice, under full remat, and its backward once, a microbatch).
    Returns the record."""
    import torch
    rec, hists = {}, {}
    per_step = MIX_LAYERS * n_mb
    for moe_impl in ("einsum", "gather"):
        cfg = mix_config("flash", moe_impl)
        rc = lm_run_config(cfg, MIX_SEQ, 2 * n_workers, n_mb)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ((out, secs), kernels), n = drive(lambda: profiled(
            lambda: run_lm(cfg, rc, MIX_STEPS, n_workers, "cuda")))
        assert n == expect(dual_update=MIX_STEPS, slot_rotate=MIX_STEPS,
                           flash_fwd_lse=2 * per_step * MIX_STEPS,
                           flash_bwd_dq=per_step * MIX_STEPS,
                           flash_bwd_dkv=per_step * MIX_STEPS), n
        peak = torch.cuda.max_memory_allocated()
        norm = lm_weights_ok(out["state"].params)
        hist = hists[moe_impl] = out["history"]
        rec[moe_impl] = dict(
            seconds=secs, launches=n, peak_gib=peak / 2 ** 30, w_norm=norm,
            loss=[h["loss"] for h in hist],
            applied_count=[h["applied_count"] for h in hist],
            split=step_split(out, kernels) if kernels else None,
            kernel_split=kernel_split(kernels, MIX_STEPS) if kernels
            else None)
        del out
        torch.cuda.empty_cache()
        disp = rec[moe_impl]["dispatch"] = moe_dispatch_ms(moe_impl)
        disp["per_step"] = MIX_LAYERS * n_mb * (disp["dispatch_fwd"]
                                                + disp["dispatch_fwd_bwd"])
        log(f"phase 17b: mixtral-8x7b {MIX_LAYERS} layer moe_impl={moe_impl}: "
            f"{MIX_STEPS} steps of {2 * n_workers} x {MIX_SEQ} tokens in "
            f"{n_mb} microbatches in {secs:.2f} s; loss "
            f"{rec[moe_impl]['loss']}; applied_count "
            f"{rec[moe_impl]['applied_count']}; |w| = {norm:.4f}; peak "
            f"{rec[moe_impl]['peak_gib']:.2f} GiB; launches {n}")
        if kernels:
            log(f"phase 17b: {moe_impl}: step split "
                f"{json.dumps(rec[moe_impl]['split'])}")
            log_kernel_split("phase 17b", moe_impl,
                             rec[moe_impl]["kernel_split"])
        log(f"phase 17b: {moe_impl}: one MoE layer on 2 x {MIX_SEQ} tokens, "
            f"ms a call {json.dumps(disp)} (dispatch = the layer less its "
            "experts' products; per_step: a step's forwards, remat "
            "forwards and backwards)")
        if not kernels:
            log(f"note: no step split for the {moe_impl} run (the profiler "
                "recorded nothing)")
    for t, (a, b) in enumerate(zip(hists["einsum"], hists["gather"])):
        assert a["applied_count"] == b["applied_count"], (t, a, b)
        assert (a["applied_count"] == 0.0) == (t < 2), (t, a)
        assert a["local_count"] == 2 * n_workers * (MIX_SEQ - 1), (t, a)
        assert math.isfinite(a["loss"]), (t, a)
        assert math.isclose(a["loss"], b["loss"], rel_tol=LM_BF16_RTOL), (
            t, a["loss"], b["loss"])
    return rec


def mixtral_device_phase(drive, expect):
    """Phase 17c: the card against the CPU, f32, TF32 off, plain attention
    (the SMOKE head dim of 16 is not the flash kernels'): mixtral-8x7b and
    mixtral-8x22b SMOKE (window 32). The worker's gradient at the init
    weights leaf by leaf (LM_DEVICE_GRAD_TOL); 3 AMB-DG steps through
    ``train`` at S = 128 with phase 3's checks (B.1 and B.2 once a step,
    nothing else); the engine on 3 ragged slots for MIX_DECODE_STEPS steps,
    past the window (``compare_serve_devices``). Returns the record."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.api import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch in ("mixtral-8x7b", "mixtral-8x22b"):
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32")
        rc = lm_run_config(cfg, 128, 4, 2)
        params = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(rc.seed))
        batch = {k: torch.from_numpy(v) for k, v in
                 TokenStream(cfg, seed=1).next_batch(2, 128).items()}
        g_cpu, loss_cpu = model_grads(cfg, params, batch)
        leaves, tdef = tree_flatten(params)
        g_gpu, loss_gpu = model_grads(
            cfg, tree_unflatten(tdef, [x.cuda() for x in leaves]),
            {k: v.cuda() for k, v in batch.items()})
        gap = leaf_gaps(g_gpu, g_cpu, leaf_names(params))
        assert all(g <= LM_DEVICE_GRAD_TOL for g in gap), gap
        assert math.isclose(loss_gpu, loss_cpu, rel_tol=LM_F32_RTOL), (
            loss_gpu, loss_cpu)
        (gpu, secs), n = drive(lambda: run_lm(cfg, rc, 3, 2, "cuda"))
        assert n == expect(dual_update=3, slot_rotate=3), n
        cpu, cpu_secs = run_lm(cfg, rc, 3, 2, "cpu")
        diff, tol = compare_lm_devices(gpu, cpu)
        rng = np.random.default_rng(17)
        prompts = [rng.integers(1, cfg.vocab_size, size=k).tolist()
                   for k in (5, 7, 9)]
        serve = compare_serve_devices(drive, expect, "phase 17c", arch, cfg,
                                      prompts, MIX_DECODE_STEPS)
        out[arch] = dict(init_grad_gap=max(gap), gpu_s=secs, cpu_s=cpu_secs,
                         launches=n,
                         loss=[h["loss"] for h in gpu["history"]],
                         w_max_diff=diff, w_tol=tol, serve=serve)
        log(f"phase 17c: {arch} SMOKE f32: init gradient card vs cpu within "
            f"{max(gap):.3e} of a leaf's largest; 3 steps on cuda in "
            f"{secs:.2f} s, on cpu in {cpu_secs:.2f} s; loss "
            f"{out[arch]['loss']}; max |w_gpu - w_cpu| = {diff:.3e} <= "
            f"{tol:.3e}; launches {n}")
    return out


def mixtral_serve_phase():
    """Phase 17d: serving phase 17a's model (bf16, ``serve_load``) in
    MIX_SERVE_SLOTS slots, MIX_SERVE_WARMUP warm-up steps, then
    MIX_SERVE_TIMED timed. Returns the record."""
    r = serve_load(mix_config("xla"), MIX_SERVE_SLOTS, MIX_SERVE_TIMED,
                   warmup=MIX_SERVE_WARMUP)
    split = r["split"]
    log(f"phase 17d: mixtral-8x7b {r['layers']} layer, {r['slots']} slots: "
        f"median step {r['median_step_ms']:.3f} ms (p90 "
        f"{r['p90_step_ms']:.3f}); prefill {r['prefill_tok_s']:.1f} tok/s, "
        f"decode {r['decode_tok_s']:.1f} tok/s; {r['kernels_per_step']:.1f} "
        f"kernels a step, {r['device_kernel_ms_per_step']:.3f} ms of kernels "
        f"a step, idle share {r['idle_share']:.3f}; HBM floor "
        f"{r['hbm_floor_ms']:.3f} ms; peak {r['peak_gib']:.2f} GiB")
    log("phase 17d: kernel split per step " + json.dumps(
        {k: v for k, v in split.items() if k != "rest_top"}))
    for t in split["rest_top"]:
        log(f"phase 17d: rest {t['ms']:.4f} ms/step ({t['launches']:.1f} "
            f"launches/step): {t['name']}")
    return r


def mixtral_phase(drive, expect):
    """Phase 17 (17a-d): the MoE slice; each part's seconds in
    ``parts_s``."""
    out, parts_s = {}, {}
    for part, key, fn in (
            ("17a", "init_weights", lambda: mixtral_init_phase(drive,
                                                               expect)),
            ("17b", "train", lambda: mixtral_train_phase(drive, expect)),
            ("17c", "devices", lambda: mixtral_device_phase(drive, expect)),
            ("17d", "serve", mixtral_serve_phase)):
        t0 = time.perf_counter()
        out[key] = fn()
        parts_s[part] = time.perf_counter() - t0
        log(f"phase {part}: {parts_s[part]:.1f} s")
    out["parts_s"] = parts_s
    return out


# -- the xLSTM slice (phase 18) -----------------------------------------------
XL_SEQ = 1024        # 18a/18b: 4 mLSTM chunks of 256, so the carry runs
XL_LONG = 4096       # train_4k's length: 18a's no-grad forward only
XL_PREFILL = 512     # 18a: prefill by decode over two chunks
XL_STEPS = 3         # 18b: the third applies the first delayed update
# 18b's depth, of 12 (an mLSTM and an sLSTM block): a training step at
# 4 x 1024 tokens is ~210,000 eager kernels at 4 layers (each sLSTM time
# step ~25 forward and ~50 backward), ~30 us of host work each, 6.3 s
XL_TRAIN_LAYERS = 2
# 18a's depth, of 12 (12 until phase 19 came, 6 until phase 20 came, cut
# for the script's time limit: the card's cold gradient and the CPU's
# took 15 + 22 s at 12); 4 keeps two blocks of each kind
XL_DEVICE_LAYERS = 4
XL_SERVE_SLOTS, XL_SERVE_WARMUP, XL_SERVE_TIMED = 8, 16, 64
XL_DEVICE_STEPS = 24     # 18c: SMOKE engine steps, card against CPU
# 18a: prefill-by-decode against the forward's last position, f32, of the
# largest |logit| (the recurrent and the chunked forms sum in other
# orders; read: 3.9e-6, NVIDIA H100 80GB HBM3, 700 W)
XL_DECODE_TOL = 1e-4
# 18a: the card's f32 gradient against the CPU's, of each leaf's largest
# element, 12 layers x 1024 tokens with w_h rescaled (read: 1.7e-5 to
# 2.0e-4; the gradient itself moves 1e-6 to 5e-5 of a leaf when every
# weight moves by 1e-7 of itself: the depth and the recurrences amplify
# each rounding, so phase 7's 1e-4 is below what two summation orders
# give here)
XL_DEVICE_GRAD_TOL = 1e-3


def xl_config(**kw):
    """xlstm-125m FULL (12 layers, d 768) with full block remat (and any
    overrides)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("xlstm-125m"),
                               **{"block_remat": "full", **kw})


def xl_rescale_(params, cfg):
    """``params`` with the sLSTM's recurrent weights ``w_h`` (nh, hd,
    4 hd) rescaled in place from the init's fan-in nh to fan-in hd. At
    the init's own scale the recurrence is chaotic: its f32 gradient
    moves by O(1) for a rounding and at 1024 tokens is not finite, in
    JAX as in the port (ROADMAP C.16); at this scale it is well
    conditioned."""
    from repro_torch.models.xlstm import slstm_dims
    nh, hd, _ = slstm_dims(cfg)
    params["slstm_layers"]["slstm"]["w_h"].mul_((nh / hd) ** 0.5)
    return params


def xl_model(cfg, device):
    """``cfg``'s model whose init draws are rescaled by ``xl_rescale_``."""
    import dataclasses
    from repro_torch.models.api import build_model
    model = build_model(cfg, device=device)
    return dataclasses.replace(model, init_fn=lambda dev, gen: xl_rescale_(
        model.init_fn(dev, gen), cfg))


def xlstm_init_phase(drive, expect):
    """Phase 18a: xlstm-125m FULL at XL_DEVICE_LAYERS of its 12 layers,
    f32, no block remat, one sequence of XL_SEQ tokens, at the init
    weights with the sLSTM's w_h rescaled (``xl_rescale_``): the loss and
    the worker's gradient on the card against the CPU, leaf by leaf
    (XL_DEVICE_GRAD_TOL; the loss to phase 7's LM_F32_RTOL), and the last
    position's logits of a prefill-by-decode over XL_PREFILL tokens
    against the forward's (XL_DECODE_TOL). Then one no-grad forward of
    all 12 layers at XL_LONG tokens in the config's bf16, timed. No kernel of the port launches (JAX's xLSTM has no Pallas
    call). Returns the record."""
    import torch
    from repro_torch.core.arena import tree_map
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import transformer as tf
    torch.backends.cuda.matmul.allow_tf32 = False
    # no block remat: the same gradient without the recompute's quarter
    # of the ~0.6 M eager kernels (18b runs the remat modes)
    cfg = xl_config(compute_dtype="float32", block_remat="none",
                    n_layers=XL_DEVICE_LAYERS)
    params = xl_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    host = TokenStream(cfg, seed=1).next_batch(1, XL_SEQ)
    cpu_batch = {k: torch.from_numpy(v) for k, v in host.items()}
    batch = {k: v.to("cuda") for k, v in cpu_batch.items()}
    names = leaf_names(params)
    p = tree_map(lambda a: a.to("cuda"), params)
    secs = {}
    t0 = time.perf_counter()
    (g_gpu, loss_gpu), n = drive(lambda: model_grads(cfg, p, batch))
    torch.cuda.synchronize()
    secs["grad_card"] = time.perf_counter() - t0
    assert n == expect(), n
    t0 = time.perf_counter()
    g_cpu, loss_cpu = model_grads(cfg, params, cpu_batch)
    secs["grad_cpu"] = time.perf_counter() - t0
    gaps = leaf_gaps(g_gpu, g_cpu, names)
    del g_gpu, g_cpu
    # prefill by decode against the forward, on the card
    model = xl_model(cfg, "cuda")
    toks = batch["tokens"][:, :XL_PREFILL]
    t0 = time.perf_counter()
    with torch.no_grad():
        full, _ = tf.forward(p, cfg, toks)
        cache, _ = model.init_decode_state(1, XL_PREFILL, torch.float32)
        for pos in range(XL_PREFILL):
            logits, cache = model.decode_step(p, cache, toks[:, pos:pos + 1],
                                              pos)
    torch.cuda.synchronize()
    secs["prefill_by_decode"] = time.perf_counter() - t0
    want = full[0, -1]
    decode_gap = float((logits[0, 0] - want).abs().max()) / float(
        want.abs().max())
    del full, cache, p
    # the no-grad forward at train_4k's length, in the config's bf16
    cfg16 = xl_config()
    p16 = xl_model(cfg16, "cuda").init(torch.Generator().manual_seed(0))
    long = torch.from_numpy(TokenStream(cfg16, seed=2).next_batch(
        1, XL_LONG)["tokens"]).to("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, _ = tf.forward(p16, cfg16, long)
    torch.cuda.synchronize()
    secs["forward_4k"] = time.perf_counter() - t0
    assert bool(torch.isfinite(logits).all())
    del p16, logits, long
    torch.cuda.empty_cache()
    rec = dict(leaves=names, grad_gap_card_vs_cpu=gaps, loss_card=loss_gpu,
               loss_cpu=loss_cpu, decode_gap=decode_gap, seconds=secs)
    for i, name in enumerate(names):
        log(f"phase 18a: gradient {name}: card vs cpu {gaps[i]:.3e} of the "
            "leaf's largest element")
    log(f"phase 18a: xlstm-125m {cfg.n_layers} layers f32, {XL_SEQ} tokens "
        f"(w_h rescaled): loss per token card {loss_gpu:.7f}, cpu "
        f"{loss_cpu:.7f}; prefill by decode over {XL_PREFILL} tokens "
        f"against the forward: {decode_gap:.3e} of the largest logit; "
        f"seconds {json.dumps(secs)} (forward_4k: the no-grad forward at "
        f"{XL_LONG} tokens, bf16)")
    assert all(g <= XL_DEVICE_GRAD_TOL for g in gaps), gaps
    assert math.isclose(loss_gpu, loss_cpu, rel_tol=LM_F32_RTOL), (
        loss_gpu, loss_cpu)
    assert decode_gap <= XL_DECODE_TOL, decode_gap
    return rec


def xlstm_train_phase(drive, expect):
    """Phase 18b: AMB-DG through ``train`` on xlstm-125m FULL widths at
    XL_TRAIN_LAYERS layers in bf16, from the init with w_h rescaled
    (``xl_rescale_``; at the init's own scale the first gradient is not
    finite, C.16): 2 workers x 2 sequences of XL_SEQ, 1 microbatch, tau
    2, int8, l2 ball, full block remat, XL_STEPS steps: B.1 and B.2 once
    a step and no other kernel of the port, counts and losses, w in the
    ball; the step split, the kernel split and the peak memory. Then one
    step with ``block_remat="dots"`` and one with
    ``rc.remat="whole_loss"``: B.1 and B.2 once, the first loss
    equal to the full run's, each step's peak memory; the dots step
    peaks no lower than the full one. Returns the record."""
    import torch
    rec = {}
    n_workers, n_seqs = 2, 4
    cfg = xl_config(n_layers=XL_TRAIN_LAYERS)
    rc = lm_run_config(cfg, XL_SEQ, n_seqs, 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ((out, secs), kernels), n = drive(lambda: profiled(
        lambda: run_lm(cfg, rc, XL_STEPS, n_workers, "cuda",
                       model=xl_model(cfg, "cuda"))))
    assert n == expect(dual_update=XL_STEPS, slot_rotate=XL_STEPS), n
    hist = out["history"]
    for t, h in enumerate(hist):
        assert (h["applied_count"] == 0.0) == (t < 2), (t, h)
        assert h["local_count"] == n_seqs * (XL_SEQ - 1), (t, h)
        assert math.isfinite(h["loss"]), (t, h)
    rec["full"] = dict(
        seconds=secs, launches=n, kernels=len(kernels),
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        w_norm=lm_weights_ok(out["state"].params),
        loss=[h["loss"] for h in hist],
        applied_count=[h["applied_count"] for h in hist],
        split=step_split(out, kernels) if kernels else None,
        kernel_split=kernel_split(kernels, XL_STEPS) if kernels else None)
    del out, kernels
    for tag, run_cfg, run_rc in (
            ("dots", xl_config(n_layers=XL_TRAIN_LAYERS, block_remat="dots"),
             None),
            ("whole_loss", cfg, rc.replace(remat="whole_loss"))):
        run_rc = run_rc or lm_run_config(run_cfg, XL_SEQ, n_seqs, 1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (one, secs), n = drive(lambda: run_lm(run_cfg, run_rc, 1, n_workers,
                                              "cuda",
                                              model=xl_model(run_cfg,
                                                             "cuda")))
        assert n == expect(dual_update=1, slot_rotate=1), n
        rec[tag] = dict(seconds=secs, launches=n,
                        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                        loss=one["history"][0]["loss"])
        assert math.isclose(rec[tag]["loss"], rec["full"]["loss"][0],
                            rel_tol=LM_BF16_RTOL), (tag, rec[tag],
                                                    rec["full"]["loss"])
        del one
    torch.cuda.empty_cache()
    full = rec["full"]
    log(f"phase 18b: xlstm-125m {cfg.n_layers} layers bf16: {XL_STEPS} "
        f"steps of {n_seqs} x {XL_SEQ} tokens in {full['seconds']:.2f} s; "
        "loss "
        f"{full['loss']}; applied_count {full['applied_count']}; |w| = "
        f"{full['w_norm']:.4f}; {full['kernels']} kernels recorded; "
        f"launches {full['launches']}")
    if full["split"]:
        log(f"phase 18b: step split {json.dumps(full['split'])}")
        log_kernel_split("phase 18b", "full", full["kernel_split"])
    else:
        log("note: no step split for phase 18b (the profiler recorded "
            "nothing)")
    log("phase 18b: peak memory of a step by remat: " + json.dumps(
        {k: rec[k]["peak_gib"] for k in ("full", "dots", "whole_loss")})
        + "; one-step seconds " + json.dumps(
            {k: rec[k]["seconds"] for k in ("dots", "whole_loss")}))
    assert rec["dots"]["peak_gib"] >= full["peak_gib"], rec
    return rec


def xlstm_serve_phase(drive, expect):
    """Phase 18c: serving xlstm-125m FULL in bf16 (``serve_load``:
    XL_SERVE_SLOTS slots, Poisson 0.5, XL_SERVE_WARMUP warm-up then
    XL_SERVE_TIMED timed steps); then the SMOKE engine in f32 on the card
    against the CPU (``compare_serve_devices``, 3 ragged slots,
    XL_DEVICE_STEPS steps), the tokens equal. Returns the record."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    r = serve_load(xl_config(), XL_SERVE_SLOTS, XL_SERVE_TIMED,
                   warmup=XL_SERVE_WARMUP)
    split = r["split"]
    log(f"phase 18c: xlstm-125m {r['layers']} layers, {r['slots']} slots: "
        f"median step {r['median_step_ms']:.3f} ms (p90 "
        f"{r['p90_step_ms']:.3f}); prefill {r['prefill_tok_s']:.1f} tok/s, "
        f"decode {r['decode_tok_s']:.1f} tok/s; {r['kernels_per_step']:.1f} "
        f"kernels a step, {r['device_kernel_ms_per_step']:.3f} ms of kernels "
        f"a step, idle share {r['idle_share']:.3f}; HBM floor "
        f"{r['hbm_floor_ms']:.3f} ms; peak {r['peak_gib']:.2f} GiB")
    log("phase 18c: kernel split per step " + json.dumps(
        {k: v for k, v in split.items() if k != "rest_top"}))
    for t in split["rest_top"]:
        log(f"phase 18c: rest {t['ms']:.4f} ms/step ({t['launches']:.1f} "
            f"launches/step): {t['name']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("xlstm-125m"),
                              compute_dtype="float32")
    rng = np.random.default_rng(18)
    prompts = [rng.integers(1, cfg.vocab_size, size=k).tolist()
               for k in (5, 7, 9)]
    dev = compare_serve_devices(drive, expect, "phase 18c", "xlstm-125m",
                                cfg, prompts, XL_DEVICE_STEPS)
    assert dev["tokens_equal"], dev
    return {"load": r, "devices": dev}


def xlstm_phase(drive, expect):
    """Phase 18 (18a-c): the xLSTM slice; each part's seconds in
    ``parts_s``."""
    out, parts_s = {}, {}
    for part, key, fn in (
            ("18a", "init_weights", lambda: xlstm_init_phase(drive, expect)),
            ("18b", "train", lambda: xlstm_train_phase(drive, expect)),
            ("18c", "serve", lambda: xlstm_serve_phase(drive, expect))):
        t0 = time.perf_counter()
        out[key] = fn()
        parts_s[part] = time.perf_counter() - t0
        log(f"phase {part}: {parts_s[part]:.1f} s")
    out["parts_s"] = parts_s
    return out


# -- the encoder-decoder and the VLM (phase 19) --------------------------------
SEAMLESS, PALIGEMMA = "seamless-m4t-large-v2", "paligemma-3b"
# 19b/19c depths at full width, for the AMB-DG state (~38 bytes a
# parameter) and the 256k-wide logits of a 4096-token sequence to fit one
# card: seamless 6 encoder + 6 decoder layers of 24 + 24 (0.90B
# parameters), paligemma 4 of its 18 layers (0.97B)
ED_LAYERS, PG_LAYERS = 6, 4
# 19a: f32, the card against the CPU (and seamless's flash against xla)
# at 2 + 2 seamless layers and 1 paligemma layer, one sequence of
# ED_SHORT tokens (paligemma: its 256 patches and 256 text tokens)
ED_DEVICE_LAYERS, PG_DEVICE_LAYERS, ED_SHORT = 2, 1, 512
ED_LONG = 4096       # train_4k's length: 19a's no-grad forward and 19b
ED_STEPS = 3         # 19b: the third applies the first delayed update
ED_SERVE_SLOTS, ED_SERVE_WARMUP, ED_SERVE_TIMED = 8, 16, 64
ED_DEVICE_STEPS = 24     # 19c: SMOKE engine steps, card against CPU


def ed_config(arch, n_layers, **kw):
    """``arch``'s FULL config at ``n_layers`` layers (seamless:
    ``n_layers`` encoder and ``n_layers`` decoder layers), with any
    overrides."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    depth = dict(n_layers=n_layers)
    if cfg.family == "encdec":
        depth["n_encoder_layers"] = n_layers
    return dataclasses.replace(cfg, **depth, **kw)


def stack_prefix(params, n):
    """``params`` with every stacked child (``encoder``, ``decoder``,
    ``layers``) cut to its first ``n`` layers (views)."""
    from repro_torch.core.arena import tree_map
    return {k: tree_map(lambda a: a[:n], v)
            if k in ("encoder", "decoder", "layers") else v
            for k, v in params.items()}


def fixed_model(cfg, params):
    """``cfg``'s model on the card whose ``init`` returns ``params``."""
    import dataclasses
    from repro_torch.models.api import build_model
    return dataclasses.replace(build_model(cfg, device="cuda"),
                               init_fn=lambda dev, gen: params)


def ed_flash_launches(n_enc, n_dec):
    """Flash calls of one seamless forward: the encoder's self-attention
    per encoder layer, the decoder's self- and cross-attention per decoder
    layer."""
    return n_enc + 2 * n_dec


def ed_device_check(drive, expect, arch, p0, n_layers, label):
    """19a for one family: at the FULL widths, ``n_layers`` layers of the
    seeded init ``p0``, f32, one sequence of ED_SHORT tokens: the worker's
    gradient and loss on the card against the CPU, leaf by leaf
    (LM_DEVICE_GRAD_TOL, LM_F32_RTOL); seamless under "flash" (the
    kernels, non-causal in its encoder and cross-attention, on the card;
    their plain version on the CPU) and also against "xla" on the card
    (LM_F32_GRAD_TOL). Returns the record."""
    import dataclasses
    import torch
    from repro_torch.core.arena import tree_map
    from repro_torch.data.synthetic import TokenStream
    encdec = arch == SEAMLESS
    cfg = ed_config(arch, n_layers, compute_dtype="float32",
                    block_remat="none",
                    **({"attn_impl": "flash"} if encdec else {}))
    params = stack_prefix(p0, n_layers)
    host = TokenStream(cfg, seed=1).next_batch(1, ED_SHORT)
    cpu_batch = {k: torch.from_numpy(v) for k, v in host.items()}
    batch = {k: v.to("cuda") for k, v in cpu_batch.items()}
    names = leaf_names(params)
    secs, rec = {}, {}
    t0 = time.perf_counter()
    (g_gpu, loss_gpu), n = drive(lambda: model_grads(cfg, params, batch))
    torch.cuda.synchronize()
    secs["grad_card"] = time.perf_counter() - t0
    per = ed_flash_launches(n_layers, n_layers) if encdec else 0
    assert n == (expect(flash_fwd_lse=per, flash_bwd_dq=per,
                        flash_bwd_dkv=per) if encdec else expect()), n
    if encdec:
        g_xla, loss_xla = model_grads(dataclasses.replace(cfg,
                                                          attn_impl="xla"),
                                      params, batch)
        rec["grad_gap_flash_vs_xla"] = leaf_gaps(g_gpu, g_xla, names)
        rec["loss_xla"] = loss_xla
        del g_xla
    t0 = time.perf_counter()
    g_cpu, loss_cpu = model_grads(cfg, tree_map(lambda a: a.cpu(), params),
                                  cpu_batch)
    secs["grad_cpu"] = time.perf_counter() - t0
    rec.update(leaves=names, layers=n_layers,
               grad_gap_card_vs_cpu=leaf_gaps(g_gpu, g_cpu, names),
               loss_card=loss_gpu, loss_cpu=loss_cpu, seconds=secs)
    del g_gpu, g_cpu
    torch.cuda.empty_cache()
    for i, name in enumerate(names):
        extra = (f"; flash vs xla {rec['grad_gap_flash_vs_xla'][i]:.3e}"
                 if encdec else "")
        log(f"{label}: {arch} gradient {name}: card vs cpu "
            f"{rec['grad_gap_card_vs_cpu'][i]:.3e}{extra} (of the leaf's "
            "largest element)")
    log(f"{label}: {arch} {n_layers} layers f32, {ED_SHORT} tokens: loss per "
        f"token card {loss_gpu:.7f}, cpu {loss_cpu:.7f}"
        + (f", card xla {rec['loss_xla']:.7f}" if encdec else "")
        + f"; launches {n}; seconds {json.dumps(secs)}")
    assert all(g <= LM_DEVICE_GRAD_TOL for g in rec["grad_gap_card_vs_cpu"]), \
        rec["grad_gap_card_vs_cpu"]
    assert math.isclose(loss_gpu, loss_cpu, rel_tol=LM_F32_RTOL), (
        loss_gpu, loss_cpu)
    if encdec:
        assert all(g <= LM_F32_GRAD_TOL
                   for g in rec["grad_gap_flash_vs_xla"]), \
            rec["grad_gap_flash_vs_xla"]
        assert math.isclose(loss_gpu, rec["loss_xla"], rel_tol=LM_F32_RTOL)
    return rec


def ed_long_forward(drive, expect, p0):
    """19a's no-grad forward: seamless at ED_LAYERS + ED_LAYERS layers,
    one sequence of ED_LONG source and target tokens, bf16: the loss per
    token under "flash" (one forward kernel per attention: the encoder's
    and the cross-attention's non-causal) against "xla", timed. Returns
    the record."""
    import dataclasses
    import torch
    from repro_torch.data.synthetic import TokenStream
    cfg = ed_config(SEAMLESS, ED_LAYERS, attn_impl="flash")
    host = TokenStream(cfg, seed=2).next_batch(1, ED_LONG)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in host.items()}
    secs, ev = {}, {}
    for impl in ("flash", "xla"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[impl], n = drive(lambda: lm_eval(
            dataclasses.replace(cfg, attn_impl=impl), p0, batch))
        secs[impl] = time.perf_counter() - t0
        want = ed_flash_launches(ED_LAYERS, ED_LAYERS) if impl == "flash" \
            else 0
        assert n == (expect(flash_fwd=want) if want else expect()), (impl, n)
    torch.cuda.empty_cache()
    log(f"phase 19a: {SEAMLESS} {ED_LAYERS} + {ED_LAYERS} layers bf16, "
        f"{ED_LONG} tokens, no-grad loss per token: flash {ev['flash']:.6f}, "
        f"xla {ev['xla']:.6f}; seconds {json.dumps(secs)}")
    assert math.isfinite(ev["flash"])
    assert math.isclose(ev["flash"], ev["xla"], rel_tol=LM_BF16_RTOL), ev
    return dict(eval=ev, seconds=secs)


def ed_train(drive, expect, arch, cfg, params):
    """19b for one family: AMB-DG through ``train`` (``api.build``) from
    ``params``, bf16, 2 workers x 1 sequence of ED_LONG tokens in 2
    microbatches, tau 2, int8, l2 ball, full remat, ED_STEPS steps: B.1
    and B.2 once a step; seamless under "flash" launches the forward with
    lse twice (remat) and dq and dk/dv once per attention and microbatch,
    paligemma (prefix-LM: the plain core) no flash kernel. Counts,
    finite losses, w in the ball; the step split, the kernel split and
    the peak memory. Returns the record."""
    import torch
    n_workers, n_mb = 2, 2
    rc = lm_run_config(cfg, ED_LONG, n_workers, n_mb)
    per = n_mb * ED_STEPS * (ed_flash_launches(cfg.n_encoder_layers,
                                               cfg.n_layers)
                             if arch == SEAMLESS else 0)
    want = expect(dual_update=ED_STEPS, slot_rotate=ED_STEPS,
                  **({"flash_fwd_lse": 2 * per, "flash_bwd_dq": per,
                      "flash_bwd_dkv": per} if per else {}))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = fixed_model(cfg, params)
    ((out, secs), kernels), n = drive(lambda: profiled(
        lambda: run_lm(cfg, rc, ED_STEPS, n_workers, "cuda",
                       samples_per_worker=1, model=model)))
    assert n == want, (arch, n, want)
    n_text = ED_LONG - (cfg.n_frontend_tokens if arch == PALIGEMMA else 0)
    hist = out["history"]
    for t, h in enumerate(hist):
        assert (h["applied_count"] == 0.0) == (t < 2), (t, h)
        assert h["local_count"] == n_workers * (n_text - 1), (t, h)
        assert math.isfinite(h["loss"]), (t, h)
    rec = dict(seconds=secs, launches=n, kernels=len(kernels),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               w_norm=lm_weights_ok(out["state"].params),
               loss=[h["loss"] for h in hist],
               applied_count=[h["applied_count"] for h in hist],
               split=step_split(out, kernels) if kernels else None,
               kernel_split=kernel_split(kernels, ED_STEPS) if kernels
               else None)
    del out, kernels
    torch.cuda.empty_cache()
    layers = (f"{cfg.n_encoder_layers} + {cfg.n_layers}" if arch == SEAMLESS
              else f"{cfg.n_layers}")
    log(f"phase 19b: {arch} {layers} layers attn_impl={cfg.attn_impl} bf16: "
        f"{ED_STEPS} steps of {n_workers} x {ED_LONG} tokens in {n_mb} "
        f"microbatches in {secs:.2f} s; loss {rec['loss']}; applied_count "
        f"{rec['applied_count']}; |w| = {rec['w_norm']:.4f}; peak "
        f"{rec['peak_gib']:.2f} GiB; launches {n}")
    if rec["split"]:
        log(f"phase 19b: {arch}: step split {json.dumps(rec['split'])}")
        log_kernel_split("phase 19b", arch, rec["kernel_split"])
    else:
        log(f"note: no step split for {arch} in phase 19b (the profiler "
            "recorded nothing)")
    return rec


def ed_serve(arch, cfg, params):
    """19c for one family: ``serve_load`` (through ``api.serve``) at
    ED_SERVE_SLOTS slots in bf16 from ``params``. Returns the record."""
    r = serve_load(cfg, ED_SERVE_SLOTS, ED_SERVE_TIMED,
                   warmup=ED_SERVE_WARMUP, params=params)
    split = r["split"]
    log(f"phase 19c: {arch} {r['layers']} decoder layers, {r['slots']} "
        f"slots: median step {r['median_step_ms']:.3f} ms (p90 "
        f"{r['p90_step_ms']:.3f}); prefill {r['prefill_tok_s']:.1f} tok/s, "
        f"decode {r['decode_tok_s']:.1f} tok/s; {r['kernels_per_step']:.1f} "
        f"kernels a step, {r['device_kernel_ms_per_step']:.3f} ms of kernels "
        f"a step, idle share {r['idle_share']:.3f}; HBM floor "
        f"{r['hbm_floor_ms']:.3f} ms; peak {r['peak_gib']:.2f} GiB")
    log(f"phase 19c: {arch}: kernel split per step " + json.dumps(
        {k: v for k, v in split.items() if k != "rest_top"}))
    for t in split["rest_top"]:
        log(f"phase 19c: {arch}: rest {t['ms']:.4f} ms/step "
            f"({t['launches']:.1f} launches/step): {t['name']}")
    return r


def encdec_vlm_phase(drive, expect):
    """Phase 19 (19a-c): the encoder-decoder (seamless-m4t-large-v2) and
    the VLM (paligemma-3b) at full width, each from one seeded init on the
    card cut to the phase's depths: 19a the card against the CPU in f32
    (and seamless's flash kernels against xla) and seamless's no-grad
    forward at ED_LONG tokens; 19b AMB-DG through ``train``; 19c serving
    through ``api.serve``, then each SMOKE engine in f32 on the card
    against the CPU (3 ragged slots, ED_DEVICE_STEPS steps, tokens
    equal). Each part's seconds in ``parts_s``. Returns the record."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.arena import tree_map
    from repro_torch.models.api import build_model
    out, parts_s = {}, collections.Counter()
    for arch, n_layers, n_device in (
            (SEAMLESS, ED_LAYERS, ED_DEVICE_LAYERS),
            (PALIGEMMA, PG_LAYERS, PG_DEVICE_LAYERS)):
        cfg = ed_config(arch, n_layers,
                        **({"attn_impl": "flash"} if arch == SEAMLESS
                           else {}))
        rec = out[arch] = {}
        t0 = time.perf_counter()
        p0 = build_model(cfg, device="cuda").init(
            torch.Generator().manual_seed(0))
        rec["init_s"] = time.perf_counter() - t0
        rec["devices"] = ed_device_check(drive, expect, arch, p0, n_device,
                                         "phase 19a")
        if arch == SEAMLESS:
            rec["long_forward"] = ed_long_forward(drive, expect, p0)
        parts_s["19a"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["train"] = ed_train(drive, expect, arch, cfg,
                                tree_map(torch.clone, p0))
        parts_s["19b"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["serve"] = ed_serve(arch, cfg, p0)
        del p0
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        smoke = dataclasses.replace(get_smoke_config(arch),
                                    compute_dtype="float32")
        rng = np.random.default_rng(19)
        prompts = [rng.integers(1, smoke.vocab_size, size=k).tolist()
                   for k in (5, 7, 9)]
        rec["serve_devices"] = compare_serve_devices(
            drive, expect, "phase 19c", arch, smoke, prompts, ED_DEVICE_STEPS)
        assert rec["serve_devices"]["tokens_equal"], rec["serve_devices"]
        parts_s["19c"] += time.perf_counter() - t0
    for part in ("19a", "19b", "19c"):
        log(f"phase {part}: {parts_s[part]:.1f} s")
    out["parts_s"] = dict(parts_s)
    return out


# -- phase 21: the pod axis across processes ----------------------------------
DIST_AXES = ("pod", "data", "model")
# (b)'s rows: the two ranks share the card and gloo stages every
# collective through host memory, so they run the wrappers on 2^18 rows
# (one pod each; 128 MiB of f32 rows a pod), not at qwen's arena
GLOO_ROWS = 262_144
# linreg FULL on 2x1x1 through ``python -m torch.distributed.run`` (the
# paper's Sec. VI-A settings, as phase 3: 10 workers x 150 samples, tau
# 4, b_bar 800, the l2 ball, int8), 6 steps
DIST_STEPS = 6
DIST_CLI = ["--arch", "amb-linreg", "--mesh", "2x1x1", "--steps",
            str(DIST_STEPS), "--n-workers", "10", "--samples-per-worker",
            "150", "--tau", "4", "--t-p", "2.5", "--t-c", "10", "--b-bar",
            "800", "--pod-compression", "int8", "--proximal", "l2_ball",
            "--radius-c", repr(1.05 * math.sqrt(10_000))]
# the ranks train it twice (the run is repeatable); the stacked run is made
# twice too: the reference with the ranks' BLAS threads, a witness here
DIST_RUNS = ("mesh", "mesh_again")
# (c): each example at a size that runs in a few seconds on the card
EXAMPLES = {"quickstart": ["--steps", "3", "--seq-len", "32"],
            "linreg_paper": ["--dim", "512", "--total-time", "15"],
            "decentralized": ["--epochs", "40"],
            "serve_batched": ["--steps", "24"]}
EXAMPLE_LIMIT_S = 10.0


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharded_inputs(kind, rows, n_pods, gen):
    """Stacked inputs of one sharded wrapper on the card: (kind, args)."""
    import torch
    dev = torch.device("cuda")
    if kind == "dual_update":
        return (torch.randn((rows, 128), generator=gen, device=dev),
                torch.randn((rows, 128), generator=gen, device=dev) * 300,
                torch.full((), 1377.0, device=dev),
                torch.full((), 0.0123, device=dev))
    if kind == "slot_rotate":
        q = [torch.randint(-127, 128, (n_pods, rows, 128), generator=gen,
                           device=dev, dtype=torch.int8) for _ in range(2)]
        s = [torch.rand((n_pods, rows), generator=gen, device=dev) * 1e-2
             + 1e-4 for _ in range(2)]
        fed = torch.randn((n_pods, rows, 128), generator=gen, device=dev)
        return (q[0], s[0], q[1], s[1], fed,
                torch.clamp(fed.abs().amax(-1), min=1e-12) / 127)
    int8 = kind.endswith("int8")
    shape = (N_SLOTS, n_pods, rows, 128)
    ring = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8) if int8 else
            torch.randn(shape, generator=gen, device=dev))
    scales = (torch.rand(shape[:3], generator=gen, device=dev) + 1e-3
              if int8 else None)
    mask = torch.zeros(N_SLOTS, dtype=torch.bool, device=dev)
    mask[list(DUE[2])] = True
    cs = torch.stack([
        torch.randint(0, 300, (N_SLOTS,), generator=gen, device=dev),
        torch.randint(0, 9, (N_SLOTS,), generator=gen, device=dev)]).float()
    return ring, mask, scales, cs


def sharded_call(kind, args, pod=None):
    """(the sharded wrapper on the rank's pod ``pod`` of ``args`` (all of
    it when None), the off-mesh route on the whole of ``args``): two
    callables, each returning the outputs compared (the pod-summed rows
    first). Each works on its own copy of the operands it updates in
    place, so their first calls see the same inputs; calls after that
    update them again (the timing loops: the same work)."""
    from repro_torch.core.delayed import pod_sum
    from repro_torch.kernels.delay_ring import ops as ring_ops
    from repro_torch.kernels.dual_update import ops as update_ops

    def own(t, dim=0):
        return t if pod is None else t.narrow(dim, pod, 1).contiguous()
    if kind == "dual_update":
        z, g, c, a = args
        z_s, z_p = z.clone(), z.clone()
        return (lambda: update_ops.dual_update_arena_sharded(z_s, g, c, a),
                lambda: update_ops.dual_update_arena(z_p, g, c, a))
    if kind == "slot_rotate":
        # in place: the push slot, its scales and fed
        mine = [own(t) for t in args]
        theirs = list(args)
        for i in (2, 3, 4):
            mine[i], theirs[i] = mine[i].clone(), theirs[i].clone()
        return (lambda: ring_ops.ring_slot_rotate_int8_sharded(*mine)[:1],
                lambda: (pod_sum(ring_ops.ring_slot_rotate_int8(
                    *theirs)[0]),))
    ring, mask, scales, cs = args
    ring_l = own(ring, 1)
    scales_l = None if scales is None else own(scales, 1)
    return (lambda: ring_ops.ring_variable_pop_sharded(
                ring_l, mask, scales=scales_l, counts_stale=cs),
            lambda: (lambda p, m: (pod_sum(p), m))(
                *ring_ops.ring_variable_pop(ring, mask, scales=scales,
                                            counts_stale=cs)))


SHARDED_KINDS = {"dual_update": "dual_update", "slot_rotate": "slot_rotate",
                 "variable_pop_f32": "variable_pop",
                 "variable_pop_int8": "variable_pop"}


def nccl_world_one(drive, expect, rows, phase2):
    """Phase 21a: each sharded wrapper at world size 1 on NCCL (a
    ("pod", "data", "model") DeviceMesh of one rank; the collectives run
    through NCCL) at ``rows``, bitwise against the off-mesh route on the
    same inputs, one launch of its kernel a call; the wrapper's time
    beside the off-mesh route's (CUDA events, both in this call) and
    phase 2's kernel alone at the same shape (``phase2``: its rows)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.context import use_device_mesh
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    out = {}
    try:
        dm = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=DIST_AXES)
        gen = torch.Generator(device="cuda").manual_seed(21)
        with use_device_mesh(dm):
            for kind, counter in SHARDED_KINDS.items():
                args = sharded_inputs(kind, rows, 1, gen)
                sharded, plain = sharded_call(kind, args)
                want = plain()
                got, n = drive(sharded)
                assert n == expect(**{counter: 1}), (kind, n)
                torch.cuda.synchronize()
                bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
                err = max_abs_err(got, want)
                assert bitwise, (kind, err)
                del got, want
                ms, off_ms = cuda_ms(sharded), cuda_ms(plain)
                lead = phase2.get(kind) or {}
                out[kind] = dict(rows=rows, bitwise=bitwise, max_abs_err=err,
                                 launches=n[counter], wrapper_ms=ms,
                                 off_mesh_ms=off_ms,
                                 phase2_kernel_ms=lead.get("ms"),
                                 phase2_wrapper_ms=lead.get("wrapper_ms"))
                log(f"phase 21a: {kind} rows={rows} NCCL world 1: bitwise="
                    f"{bitwise}; sharded wrapper {ms:.4f} ms, off-mesh "
                    f"route {off_ms:.4f} ms (CUDA events); phase 2 kernel "
                    f"alone {lead.get('ms')} ms, its wrapper "
                    f"{lead.get('wrapper_ms')} ms")
                del args, sharded, plain
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


GLOO_PROBES = ("all_gather_into_tensor int8", "all_gather_into_tensor f32",
               "all_reduce f32 sum", "all_reduce f32 max",
               "reduce_scatter_tensor f32")


def dist_rank_main(out_dir):
    """Phase 21b's ranks, each a ``python3 chip_smoke.py --dist-rank=DIR``
    process that ``torch.distributed.run`` starts: gloo on CUDA tensors
    of the shared card. Probes the collectives the sharded path uses;
    runs the sharded wrappers on its pod of 2 and holds each against the
    off-mesh route on the stacked inputs (drawn alike on both ranks from
    one seed); then trains linreg FULL on 2x1x1 through
    ``launch.train.main`` in the same world, twice (DIST_RUNS), and
    writes each run's whole state (``save_rank_state``). Writes its
    record (and the kernels' launches in each part) to ``out_dir``."""
    import os

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist import collectives as col
    from repro_torch.dist.context import use_device_mesh
    from repro_torch.kernels.delay_ring import kernel as rk
    from repro_torch.kernels.dual_update import kernel as uk
    from repro_torch.launch import train as train_cli
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    rank, world = dist.get_rank(), dist.get_world_size()
    counters = {"dual_update": uk.KERNEL, "slot_rotate": rk.KERNEL,
                "variable_pop": rk.VARIABLE_POP_KERNEL}
    rec = {"probes": {}, "wrappers": {}}
    try:
        x = torch.arange(8.0, device="cuda") + rank
        on = {"axis": "pod", "tag": "probe"}
        tries = {
            "all_gather_into_tensor int8": lambda: col.all_gather(
                x.to(torch.int8), None, world, **on),
            "all_gather_into_tensor f32": lambda: col.all_gather(
                x, None, world, **on),
            "all_reduce f32 sum": lambda: col.all_reduce(x.clone(), None,
                                                         **on),
            "all_reduce f32 max": lambda: col.all_reduce(
                x.clone(), None, op=dist.ReduceOp.MAX, **on),
            "reduce_scatter_tensor f32": lambda: col.reduce_scatter_rows(
                x, None, world, **on)}
        for name in GLOO_PROBES:
            try:
                tries[name]()
                torch.cuda.synchronize()
                rec["probes"][name] = "ok"
            except Exception as e:  # noqa: BLE001 - a refusal is recorded
                rec["probes"][name] = f"refused: {str(e).splitlines()[0]}"
        dm = init_device_mesh("cuda", (world, 1, 1),
                              mesh_dim_names=DIST_AXES)
        gen = torch.Generator(device="cuda").manual_seed(22)
        with use_device_mesh(dm):
            for kind, counter in SHARDED_KINDS.items():
                args = sharded_inputs(kind, GLOO_ROWS, world, gen)
                # the dual update's rows are whole on every rank
                sharded, plain = sharded_call(
                    kind, args, pod=None if kind == "dual_update" else rank)
                want = plain()
                before = counters[counter].launches
                got = sharded()
                launches = counters[counter].launches - before
                torch.cuda.synchronize()
                bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
                rec["wrappers"][kind] = dict(
                    bitwise=bitwise, max_abs_err=max_abs_err(got, want),
                    launches=launches, counter=counter, rows=GLOO_ROWS,
                    wrapper_ms=cuda_ms(sharded, n=3, warmup=1))
                del args, got, want, sharded, plain
                torch.cuda.empty_cache()
        for run in DIST_RUNS:
            for k in counters.values():
                k.launches = 0
            t0 = time.perf_counter()
            out = train_cli.main(DIST_CLI + ["--backend", "gloo"])
            rec[run] = dict(
                history=out["history"], seconds=time.perf_counter() - t0,
                launches={n: k.launches for n, k in counters.items()})
            save_rank_state(out["state"], f"{out_dir}/{run}")
    finally:
        dist.destroy_process_group()
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(rec, f)
    return 0


def start_dist_ranks(tmp):
    """Start phase 21b's two ranks (``dist_rank_main``) under ``python -m
    torch.distributed.run`` in the background: (the process, its start
    time)."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run",
         "--nproc-per-node=2", f"--master-port={free_port()}",
         "--monitor-interval=0.5", str(root / "chip_smoke.py"),
         f"--dist-rank={tmp}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    return proc, time.perf_counter()


def stop_dist_ranks(proc):
    """Kill phase 21b's agent and its ranks (one process group) if they
    still run."""
    import os
    import signal
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def save_rank_state(state, path):
    """Write a rank's 2x1x1 linreg state as the checkpoint the single
    process would write (``checkpoint.save_sharded``, as ``train.loop``
    writes one: the ranks' shards joined on rank 0's host). Every rank
    calls it."""
    from repro_torch.core.ambdg import shard_specs
    from repro_torch.core.arena import make_layout
    from repro_torch.dist.collectives import require_mesh
    from repro_torch.launch.mesh import make_mesh, parse_mesh
    from repro_torch.train import checkpoint as ckpt
    cfg = parse_mesh("2x1x1")
    with make_mesh(cfg, "cuda"):
        ckpt.save_sharded(path, DIST_STEPS, state,
                          shard_specs(make_layout(state.params), state, cfg),
                          cfg, require_mesh("phase 21b"))


def stacked_linreg(ckpt_dir):
    """Phase 21b's reference: linreg FULL with the 2x1x1 mesh's pods
    stacked in this process (``train(..., mesh=None)`` on the CLI's run
    config), every step logged, its step-6 state written to
    ``ckpt_dir``. Returns the loop's output."""
    from repro_torch.launch.train import parse_args, run_config
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    rc = run_config(parse_args(DIST_CLI))
    loop = LoopConfig(n_steps=DIST_STEPS, ckpt_dir=ckpt_dir,
                      ckpt_every=DIST_STEPS, log_every=1, n_workers=10,
                      samples_per_worker=150)
    return train(build_model(rc.model, device="cuda"), rc, loop,
                 device="cuda")


def start_reference(tmp):
    """Start phase 21b's reference: the stacked run in a process of its
    own (``python3 chip_smoke.py --stacked-ref=DIR``), beside the ranks,
    with the ranks' host BLAS threads: ``torch.distributed.run`` gives
    each rank OMP_NUM_THREADS=1, and the linreg stream's y = x w* is a
    numpy product whose rounding follows OpenBLAS's thread split
    (ROADMAP C.18). Returns (the process, its start time)."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(root / "chip_smoke.py"),
                             f"--stacked-ref={tmp}/fresh"], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    return proc, time.perf_counter()


def reference_result(tmp, proc, t_start):
    """Wait for ``start_reference``'s process: (its record: history and
    launches, its seconds)."""
    _, stderr = proc.communicate(timeout=600)
    if proc.returncode != 0:
        log(stderr[-8000:])
    assert proc.returncode == 0, proc.returncode
    with open(f"{tmp}/fresh.json") as f:
        return json.load(f), time.perf_counter() - t_start


def stacked_ref_main(ckpt_dir):
    """``--stacked-ref=DIR`` (``start_reference``'s process): the stacked
    run, its record written beside DIR."""
    from repro_torch.kernels.delay_ring import kernel as rk
    from repro_torch.kernels.dual_update import kernel as uk
    counters = {"dual_update": uk.KERNEL, "slot_rotate": rk.KERNEL,
                "variable_pop": rk.VARIABLE_POP_KERNEL}
    out = stacked_linreg(ckpt_dir)
    with open(f"{ckpt_dir}.json", "w") as f:
        json.dump({"history": out["history"],
                   "launches": {n: k.launches for n, k in counters.items()}},
                  f)
    return 0


def state_leaves(path):
    """The state leaves of the checkpoint under ``path``."""
    import numpy as np
    with np.load(next(Path(path).glob("step_*/state.npz"))) as f:
        return {k: f[k] for k in f.files}


def unequal_leaves(a, b):
    """{leaf: max |a - b|} of the leaves that differ."""
    import numpy as np
    assert sorted(a) == sorted(b)
    return {k: float(np.abs(a[k].astype(np.float64) - b[k]).max())
            for k in b if not np.array_equal(a[k], b[k])}


def dist_linreg(expect, tmp, proc, t_start, stacked):
    """Phase 21b: waits for the ranks (``start_dist_ranks``) and holds
    each of their linreg FULL runs on 2x1x1 against the stacked run at
    n_pods = 2 made with the ranks' BLAS threads (``start_reference``):
    bit for bit, the metrics at the logged step and every state leaf
    (D = 1: each pod's gradient is the same computation on the same
    rows, and the pod fold's order is fixed). The witness, printed:
    which leaves differ between the ranks' two runs, and between the
    reference and the stacked run made in this process beside the
    ranks (``stacked_linreg``, this process's default BLAS threads).
    Returns (record, the ranks' records)."""
    (fresh, fresh_s), (loaded, n), loaded_s = stacked
    stdout, stderr = proc.communicate(timeout=600)
    dist_s = time.perf_counter() - t_start
    if proc.returncode != 0:
        log(stdout[-4000:])
        log(stderr[-8000:])
    assert proc.returncode == 0, proc.returncode
    assert sum(ln.startswith("done:") for ln in stdout.splitlines()) == \
        len(DIST_RUNS)
    ranks = []
    for r in range(2):
        with open(f"{tmp}/rank{r}.json") as f:
            ranks.append(json.load(f))
    want = {"dual_update": DIST_STEPS, "slot_rotate": DIST_STEPS,
            "variable_pop": 0}
    assert n == expect(**want), n
    assert fresh["launches"] == want, fresh["launches"]
    hist_s = fresh["history"]
    assert len(hist_s) == DIST_STEPS, len(hist_s)
    states = {name: state_leaves(f"{tmp}/{name}")
              for name in DIST_RUNS + ("fresh", "loaded")}
    for run in DIST_RUNS:
        hist_d = ranks[0][run]["history"]
        assert [h["step"] for h in hist_d] == [hist_s[-1]["step"]], hist_d
        for key in ("applied_count", "loss", "grad_norm"):
            assert hist_d[-1][key] == hist_s[-1][key], (run, key)
        diff = unequal_leaves(states[run], states["fresh"])
        assert not diff, (run, diff)
        for r, got in enumerate(ranks):
            assert got[run]["launches"] == want, (r, run, got[run])
    witness = {"mesh_again_vs_mesh": unequal_leaves(states["mesh_again"],
                                                    states["mesh"]),
               "stacked_here_vs_reference": unequal_leaves(
                   states["loaded"], states["fresh"]),
               "stacked_here_metrics_bitwise": all(
                   a[k] == b[k] for a, b in zip(loaded["history"], hist_s)
                   for k in ("loss", "grad_norm", "applied_count"))}
    return dict(dist_s=dist_s,
                loop_s=[ranks[0][r]["history"][-1]["wall_s"]
                        for r in DIST_RUNS],
                rank_train_s=[ranks[0][r]["seconds"] for r in DIST_RUNS],
                fresh_s=fresh_s, stacked_here_s=loaded_s, steps=DIST_STEPS,
                witness=witness, loss=[h["loss"] for h in hist_s],
                applied_count=[h["applied_count"] for h in hist_s],
                reference_launches=fresh["launches"],
                stacked_here_launches=n), ranks


def examples_phase(strict=True):
    """Phase 21c: the four ``examples_torch`` scripts on the card (their
    ``main(argv)``, in process), each within EXAMPLE_LIMIT_S (``strict``;
    under ``--only`` no earlier phase has run the LM's kernels, whose
    first launches load their CUDA modules, so only the time is
    printed)."""
    import contextlib
    import importlib.util
    import io
    root = Path(__file__).resolve().parent / "examples_torch"
    out = {}
    for name, argv in EXAMPLES.items():
        spec = importlib.util.spec_from_file_location(
            f"examples_torch_{name}", root / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            res = mod.main(argv + ["--device", "cuda"])
        secs = time.perf_counter() - t0
        lines = text.getvalue().splitlines()
        if name == "quickstart":
            ok = all(math.isfinite(x) for x in res) and res[-1] < res[0]
        elif name == "linreg_paper":
            ok = all(len(tr.times) > 0 and all(map(math.isfinite, tr.errors))
                     for tr in res.values())
        elif name == "decentralized":
            ok = res[-1] < 0.05
        else:
            ok = res.stats.publish_pops > 0 and res.stats.staleness_max <= 8
        out[name] = dict(seconds=secs, ok=ok, last=lines[-1] if lines else "")
        log(f"phase 21c: examples_torch/{name}.py {' '.join(argv)} on the "
            f"card: {secs:.2f} s; {out[name]['last']}")
        assert ok, (name, lines[-5:])
        assert secs <= EXAMPLE_LIMIT_S or not strict, (name, secs)
    return out


def start_dist_background():
    """Start phase 21b's processes, the reference (``start_reference``)
    and the ranks (``start_dist_ranks``), in a temporary directory:
    (the directory, (the reference, its start), (the ranks' agent, its
    start))."""
    import tempfile
    tmp = tempfile.mkdtemp()
    return tmp, start_reference(tmp), start_dist_ranks(tmp)


def stop_dist_background(bg):
    """Kill ``start_dist_background``'s processes if they still run and
    remove their directory."""
    import shutil
    tmp, (ref, _), (proc, _) = bg
    stop_dist_ranks(proc)
    stop_dist_ranks(ref)
    shutil.rmtree(tmp, ignore_errors=True)


def dist_phase(drive, expect, launches, phase2, big_rows, strict=True,
               bg=None):
    """Phase 21: the pod axis across processes (see the module's
    docstring). 21b's reference (the stacked run in a process of its
    own) and ranks run in the background (``bg``, started before phase
    20 so that their start overlaps it; None starts them here); this
    process trains the witness's stacked run and runs the examples (21c)
    while they run; the NCCL checks (21a, timed) come once they are
    done. Returns the record; adds 21b's launches to ``launches``."""
    rec = {}
    t0 = time.perf_counter()
    bg = bg or start_dist_background()
    tmp, (ref, t_ref), (proc, t_proc) = bg
    try:
        t1 = time.perf_counter()
        here = drive(lambda: stacked_linreg(f"{tmp}/loaded"))
        here_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        rec["examples"] = examples_phase(strict)
        rec["examples_s"] = time.perf_counter() - t1
        fresh = reference_result(tmp, ref, t_ref)
        for name, k in fresh[0]["launches"].items():
            launches[name] += k
        rec["linreg_2x1x1"], ranks = dist_linreg(
            expect, tmp, proc, t_proc, (fresh, here, here_s))
    finally:
        stop_dist_background(bg)
    rec["gloo_s"] = time.perf_counter() - t0
    for r, got in enumerate(ranks):
        for name, res in got["probes"].items():
            log(f"phase 21b: rank {r} gloo on CUDA tensors, {name}: {res}")
        for kind, w in got["wrappers"].items():
            log(f"phase 21b: rank {r} {kind} 2 pods rows={w['rows']} gloo: "
                f"bitwise={w['bitwise']} (max |err| {w['max_abs_err']:.3e}); "
                f"launches {w['launches']}; {w['wrapper_ms']:.3f} ms a call "
                f"(CUDA events)")
            assert w["bitwise"] and w["launches"] == 1, (r, kind, w)
            launches[w["counter"]] += w["launches"]
        for run in DIST_RUNS:
            for name, n in got[run]["launches"].items():
                launches[name] += n
    rec["gloo_ranks"] = ranks
    r = rec["linreg_2x1x1"]
    log(f"phase 21b: linreg FULL 2x1x1 int8 l2-ball, {r['steps']} steps "
        f"under torch.distributed.run (gloo, 2 ranks on the card, after "
        f"the wrappers), twice, {r['dist_s']:.2f} s from their start (the "
        f"loops "
        f"{r['loop_s']} s): bit for bit, metrics and every state leaf, "
        f"the stacked run with the ranks' one BLAS thread (a process of "
        f"its own, {r['fresh_s']:.2f} s); applied_count "
        f"{r['applied_count']}; loss {r['loss']}")
    log(f"phase 21b: witness: {json.dumps(r['witness'])} (the stacked run "
        f"made here with this process's BLAS threads, "
        f"{r['stacked_here_s']:.2f} s)")
    t1 = time.perf_counter()
    rec["nccl_world_1"] = nccl_world_one(drive, expect, big_rows, phase2)
    rec["nccl_s"] = time.perf_counter() - t1
    log(f"phase 21: 21b with 21c beside it {rec['gloo_s']:.1f} s (21c "
        f"{rec['examples_s']:.1f} s, a rank's linreg runs "
        f"{r['rank_train_s']} s), 21a {rec['nccl_s']:.1f} s")
    return rec


# -- phase 22: the LMs on the mesh and the per-rank gossip -----------------
# 22a: qwen1.5-0.5b FULL widths cut to MESH_LM_LAYERS layers, flash, 4096
# tokens, int8 pod compression, tau 1, MESH_LM_STEPS steps of 4 sequences
# (4 workers x 1, 2 microbatches a pod) on 2x1x1 and 1x2x1: two gloo ranks
# sharing the card (``python -m torch.distributed.run``), each mesh held
# against its stacked run made twice in a process of its own
MESH_LM_LAYERS = 2
MESH_LM_STEPS = 2
MESH_LM_SEQ = 4096
MESH_LM_WORKERS = 4
MESH_LM = {"2x1x1": (2, 1, 1), "1x2x1": (1, 2, 1)}
# the mesh run's allowed gap (params, loss) over the two stacked runs'
MESH_LM_GAP_MULT = 1
# 22b: decentralized amb-linreg FULL, one worker a rank on 4 gloo ranks
# sharing the card, ring-4 (eq. (24)'s 11 rounds), DEC_RANK_STEPS steps of
# 4 x 150 samples, against the stacked dense run at one BLAS thread in a
# process of its own (ROADMAP C.18)
DEC_RANK_N = 4
DEC_RANK_SPW = 150
DEC_RANK_STEPS = 6
DEC_RANK_RUNS = {"none": {}, "int8": {"compression": "int8"},
                 "churn": {"elastic": ELASTIC["churn"]}}
GOSSIP_TIMED = 20     # per-rank gossip rounds timed after 3 of warm-up
# grad_norm and consensus_error sum whole messages in an all-reduce on the
# per-rank route (the dense fold sums them in one tensor): phase 3's
# card-vs-CPU limit (a consensus error is the norm of a difference of
# nearly equal duals)
DEC_RANK_METRIC_RTOL = DEC_RTOL


def mesh_counters():
    """The launch counters phase 22's processes read, by the kernels
    line's names."""
    from repro_torch.kernels.delay_ring import kernel as rk
    from repro_torch.kernels.dual_update import kernel as uk
    from repro_torch.kernels.flash_attention import kernel as fk
    return {"dual_update": uk.KERNEL, "slot_rotate": rk.KERNEL,
            "variable_pop": rk.VARIABLE_POP_KERNEL, "flash_fwd": fk.FWD,
            "flash_fwd_lse": fk.FWD_LSE, "flash_bwd_dq": fk.DQ,
            "flash_bwd_dkv": fk.DKV}


def mesh_lm_config(label):
    """22a's run config on the mesh ``label``."""
    from repro_torch.configs.base import MeshConfig
    cfg = lm_config("flash", n_layers=MESH_LM_LAYERS)
    rc = lm_run_config(cfg, MESH_LM_SEQ, MESH_LM_WORKERS, 2, tau=1)
    return rc.replace(mesh=MeshConfig(*MESH_LM[label]))


def mesh_lm_run(label, device, mesh=None):
    """One 22a run (on ``mesh``, or stacked in this process): (history,
    the params as one flat f32 array, launches)."""
    from repro_torch.core.arena import flatten_tree, make_layout
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    import torch
    counters = mesh_counters()
    rc = mesh_lm_config(label)
    model = build_model(rc.model, device=device)
    loop = LoopConfig(n_steps=MESH_LM_STEPS, n_workers=MESH_LM_WORKERS,
                      samples_per_worker=1, log_every=1)
    for k in counters.values():
        k.launches = 0
    out = train(model, rc, loop, device=device, mesh=mesh)
    launches = {n: k.launches for n, k in counters.items()}
    hist = out["history"]
    flat = flatten_tree(make_layout(model.param_shapes()),
                        out["state"].params).cpu().numpy()
    del out, model
    torch.cuda.empty_cache()
    return hist, flat, launches


def mesh_lm_rank_main(out_dir):
    """22a's ranks (``--mesh-lm-rank=DIR`` under torch.distributed.run):
    each mesh of MESH_LM in turn on the two ranks' world; rank 0 writes
    the params, each rank its record."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.dist.collectives import wire_census
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    rec = {}
    try:
        for label in MESH_LM:
            t0 = time.perf_counter()
            mesh = make_mesh(mesh_lm_config(label).mesh, "cuda")
            with wire_census() as census:
                hist, flat, launches = mesh_lm_run(label, "cuda", mesh)
            rec[label] = dict(history=hist, launches=launches,
                              seconds=time.perf_counter() - t0,
                              census=[[*k, n] for k, n in
                                      census.bytes.items()])
            if rank == 0:
                np.save(f"{out_dir}/mesh-{label}.npy", flat)
    finally:
        dist.destroy_process_group()
    with open(f"{out_dir}/lm-rank{rank}.json", "w") as f:
        json.dump(rec, f)
    return 0


def mesh_lm_ref_main(out_dir):
    """22a's reference (``--mesh-lm-ref=DIR``): each mesh's run stacked in
    this process, twice; the params and a record written to DIR."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {}
    for label in MESH_LM:
        for i in range(2):
            hist, flat, launches = mesh_lm_run(label, "cuda")
            rec[f"{label}-{i}"] = dict(history=hist, launches=launches)
            np.save(f"{out_dir}/ref-{label}-{i}.npy", flat)
    with open(f"{out_dir}/lm-ref.json", "w") as f:
        json.dump(rec, f)
    return 0


def dec_rank_config(knobs):
    """22b's run config: linreg FULL, the decentralized strategy on a
    ring of DEC_RANK_N, "auto" (one worker a rank in a world of
    DEC_RANK_N ranks, the dense fold in one process)."""
    import dataclasses
    from repro_torch.configs.base import ConsensusConfig, ElasticConfig
    cfg, rc = main_path_config()
    rc = rc("none")
    # 150 samples a worker: 2 microbatches of 75 (as phase 15b)
    rc = rc.replace(
        ambdg=dataclasses.replace(rc.ambdg, n_microbatches=2),
        strategy="decentralized", consensus=ConsensusConfig(
            topology="ring", n_workers=DEC_RANK_N,
            compression=knobs.get("compression", "none")))
    if "elastic" in knobs:
        rc = rc.replace(elastic=ElasticConfig(**knobs["elastic"]))
    return cfg, rc


def dec_rank_run(label, ckpt_dir):
    """One 22b run on the card through ``train``: (history, seconds)."""
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    cfg, rc = dec_rank_config(DEC_RANK_RUNS[label])
    loop = LoopConfig(n_steps=DEC_RANK_STEPS, n_workers=DEC_RANK_N,
                      samples_per_worker=DEC_RANK_SPW, log_every=1,
                      ckpt_dir=ckpt_dir, ckpt_every=DEC_RANK_STEPS)
    t0 = time.perf_counter()
    out = train(build_model(cfg, device="cuda"), rc, loop, device="cuda")
    return out["history"], time.perf_counter() - t0


def dec_rank_main(out_dir):
    """22b's ranks (``--dec-rank=DIR`` under torch.distributed.run, one
    worker a rank): each run of DEC_RANK_RUNS (the checkpoint joined on
    rank 0 under DIR) with its census, then a gossip round's time on
    this rank's message (f32 and int8; host clock around synchronised
    rounds). Each rank writes its record."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import consensus
    from repro_torch.core.arena import make_layout
    from repro_torch.dist.collectives import wire_census
    from repro_torch.models.api import build_model
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    rec = {}
    try:
        for label in DEC_RANK_RUNS:
            with wire_census() as census:
                hist, secs = dec_rank_run(label, f"{out_dir}/rank-{label}")
            rec[label] = dict(history=hist, seconds=secs,
                              census=[[*k, n] for k, n in
                                      census.bytes.items()])
        cfg, _ = dec_rank_config({})
        rows = make_layout(build_model(cfg, device="cuda").param_shapes()
                           ).rows
        group = dist.new_group(list(range(DEC_RANK_N)))
        gen = torch.Generator(device="cuda").manual_seed(22 + rank)
        x = torch.randn((1, rows, 128), generator=gen, device="cuda")
        res = torch.zeros_like(x)
        for compression in ("none", "int8"):
            def one_round():
                if compression == "int8":
                    return consensus.gossip_round_shard_int8(
                        x, res, group, "ring", DEC_RANK_N)
                return consensus.gossip_round_shard(x, group, "ring",
                                                    DEC_RANK_N)
            for _ in range(3):
                one_round()
            torch.cuda.synchronize()
            dist.barrier(group)
            t0 = time.perf_counter()
            for _ in range(GOSSIP_TIMED):
                one_round()
            torch.cuda.synchronize()
            rec[f"round_ms_{compression}"] = \
                1e3 * (time.perf_counter() - t0) / GOSSIP_TIMED
        rec["rows"] = rows
    finally:
        dist.destroy_process_group()
    with open(f"{out_dir}/dec-rank{rank}.json", "w") as f:
        json.dump(rec, f)
    return 0


def p2p_probe_main(out_dir):
    """22b's probe (``--p2p-probe=DIR``, two ranks under
    torch.distributed.run): gloo's point-to-point send and receive of a
    CUDA tensor as it is, unstaged (``dist.collectives.permute`` stages
    it through host copies on a gloo group). Each rank writes what it
    read: "ok", "wrong memory: ..." or "refused: ...". A crash shows as
    the process's exit code."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    x = torch.arange(8.0, device="cuda") + 100 * rank
    got = torch.full_like(x, -1.0)
    try:
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, 1 - rank),
                dist.P2POp(dist.irecv, got, 1 - rank)]):
            work.wait()
        torch.cuda.synchronize()
        want = torch.arange(8.0, device="cuda") + 100 * (1 - rank)
        res = ("ok" if torch.equal(got, want) else
               f"wrong memory: read {got.tolist()}")
    except Exception as e:  # noqa: BLE001 - a refusal is the result
        res = f"refused: {str(e).splitlines()[0]}"
    finally:
        dist.destroy_process_group()
    with open(f"{out_dir}/p2p-rank{rank}.json", "w") as f:
        json.dump(res, f)
    return 0


def dec_rank_ref_main(out_dir):
    """22b's reference (``--dec-ref=DIR``, one BLAS thread): each run of
    DEC_RANK_RUNS on the dense fold in this process, its checkpoint and
    record under DIR."""
    rec = {}
    for label in DEC_RANK_RUNS:
        hist, secs = dec_rank_run(label, f"{out_dir}/ref-{label}")
        rec[label] = dict(history=hist, seconds=secs)
    with open(f"{out_dir}/dec-ref.json", "w") as f:
        json.dump(rec, f)
    return 0


def start_mesh_background():
    """Start phase 22's processes in a temporary directory: 22a's two
    ranks and its stacked reference, 22b's four ranks and its dense
    reference (one BLAS thread, as ``torch.distributed.run`` gives each
    rank). Returns (the directory, {name: (process, start time)})."""
    import os
    import tempfile
    tmp = tempfile.mkdtemp()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    one = dict(env, OMP_NUM_THREADS="1")
    script = str(root / "chip_smoke.py")

    def ranks(n, flag):
        return [sys.executable, "-m", "torch.distributed.run",
                f"--nproc-per-node={n}", f"--master-port={free_port()}",
                "--monitor-interval=0.5", script, f"{flag}={tmp}"]

    procs = {}
    for name, cmd, e in (
            ("22a ranks", ranks(2, "--mesh-lm-rank"), env),
            ("22a reference", [sys.executable, script,
                               f"--mesh-lm-ref={tmp}"], env),
            ("22b ranks", ranks(DEC_RANK_N, "--dec-rank"), env),
            ("22b reference", [sys.executable, script, f"--dec-ref={tmp}"],
             one),
            ("22b probe", ranks(2, "--p2p-probe"), env)):
        procs[name] = (subprocess.Popen(
            cmd, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, start_new_session=True), time.perf_counter())
    return tmp, procs


def p2p_probe_result(tmp, proc):
    """What 22b's probe read on each rank, or how its processes ended."""
    proc.communicate(timeout=300)
    out = []
    for r in range(2):
        path = Path(f"{tmp}/p2p-rank{r}.json")
        out.append(read_json(path) if path.exists() else
                   f"no record (the ranks' agent exited {proc.returncode})")
    return out


def stop_mesh_background(bg):
    """Kill ``start_mesh_background``'s processes if they still run and
    remove their directory."""
    import shutil
    tmp, procs = bg
    for proc, _ in procs.values():
        stop_dist_ranks(proc)
    shutil.rmtree(tmp, ignore_errors=True)


def wait_mesh_process(name, proc, t_start, timeout=600):
    """Wait for one of phase 22's processes: its seconds from its start."""
    stdout, stderr = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        log(f"{name} stdout: {stdout[-4000:]}")
        log(f"{name} stderr: {stderr[-8000:]}")
    assert proc.returncode == 0, (name, proc.returncode)
    return time.perf_counter() - t_start


def read_json(path):
    with open(path) as f:
        return json.load(f)


def census_of(entries, tag):
    """{dtype: bytes} of a record's census entries under ``tag``, and
    the axes they crossed."""
    out, axes = {}, set()
    for axis, dtype, t, n in entries:
        if t == tag:
            out[dtype] = out.get(dtype, 0) + n
            axes.add(axis)
    return out, axes


def mesh_lm_phase(tmp, procs, launches):
    """Phase 22a: reads the ranks' and the reference's records, holds
    each mesh's params and losses against its stacked run at
    MESH_LM_GAP_MULT times the gap between the two stacked runs
    (printed), the counts exact; prints each rank's ms a step, the
    launches of B.1, B.2 and flash, and the pod exchange's census
    against the wire model. Adds the ranks' launches to ``launches``."""
    import numpy as np
    from repro_torch.core.arena import make_layout
    from repro_torch.launch.wire_model import master_pod_exchange_bytes
    from repro_torch.models.api import build_model
    secs = {n: wait_mesh_process(n, *procs[n])
            for n in ("22a ranks", "22a reference")}
    ranks = [read_json(f"{tmp}/lm-rank{r}.json") for r in range(2)]
    ref = read_json(f"{tmp}/lm-ref.json")
    rows = make_layout(build_model(mesh_lm_config("2x1x1").model,
                                   device="cpu").param_shapes()).rows
    out = {"seconds": secs}
    for label, (pods, data, _) in MESH_LM.items():
        got = np.load(f"{tmp}/mesh-{label}.npy")
        r0, r1 = (np.load(f"{tmp}/ref-{label}-{i}.npy") for i in range(2))
        gap = float(np.abs(r1 - r0).max())
        err = float(np.abs(got - r0).max())
        h_ref = [ref[f"{label}-{i}"]["history"] for i in range(2)]
        h = ranks[0][label]["history"]
        loss_gap = max(abs(a["loss"] - b["loss"]) for a, b in zip(*h_ref))
        loss_err = max(abs(a["loss"] - b["loss"])
                       for a, b in zip(h, h_ref[0]))
        for a, b in zip(h, h_ref[0]):
            assert a["applied_count"] == b["applied_count"], (label, a, b)
        assert err <= MESH_LM_GAP_MULT * gap, (label, err, gap)
        assert loss_err <= MESH_LM_GAP_MULT * loss_gap, (label, loss_err,
                                                         loss_gap)
        n = [ranks[r][label]["launches"] for r in range(2)]
        mb = 2 // data                    # a rank's microbatches a step
        want = {"dual_update": MESH_LM_STEPS, "slot_rotate": MESH_LM_STEPS,
                "variable_pop": 0, "flash_fwd": 0,
                "flash_fwd_lse": 2 * MESH_LM_LAYERS * mb * MESH_LM_STEPS,
                "flash_bwd_dq": MESH_LM_LAYERS * mb * MESH_LM_STEPS,
                "flash_bwd_dkv": MESH_LM_LAYERS * mb * MESH_LM_STEPS}
        for r in range(2):
            assert n[r] == want, (label, r, n[r])
            for name, k in n[r].items():
                launches[name] += k
        # the stacked runs: every pod's 2 microbatches in one process
        stacked = dict(want, **{
            k: want[k] * pods * data for k in
            ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")})
        for i in range(2):
            got_ref = ref[f"{label}-{i}"]["launches"]
            assert got_ref == stacked, (label, i, got_ref)
            for name, k in got_ref.items():
                launches[name] += k
        pod_pop, axes = census_of(ranks[0][label]["census"], "pod_pop")
        model = master_pod_exchange_bytes(rows // data, pods, "int8")
        assert pod_pop == {dt: MESH_LM_STEPS * b for dt, b in model.items()}
        assert axes <= {"pod"}, axes
        tags = {}
        for axis, dtype, tag, b in ranks[0][label]["census"]:
            tags[f"{axis}/{tag}/{dtype}"] = b
        step_ms = [[1e3 * s["step_s"] for s in ranks[r][label]["history"]]
                   for r in range(2)]
        out[label] = dict(params_err=err, params_gap=gap, loss_err=loss_err,
                          loss_gap=loss_gap, step_ms=step_ms, launches=n[0],
                          census=tags, loss=[s["loss"] for s in h],
                          grad_norm=[s["grad_norm"] for s in h],
                          grad_norm_ref=[s["grad_norm"] for s in h_ref[0]],
                          rank_s=[ranks[r][label]["seconds"]
                                  for r in range(2)])
        log(f"phase 22a: qwen1.5-0.5b FULL widths {MESH_LM_LAYERS} layers "
            f"flash int8 {MESH_LM_SEQ} tokens on {label} (2 gloo ranks on "
            f"the card), {MESH_LM_STEPS} steps: params max |mesh - stacked| "
            f"{err:.3e} against the two stacked runs' gap {gap:.3e}, loss "
            f"{loss_err:.3e} against {loss_gap:.3e} (x{MESH_LM_GAP_MULT}); "
            f"applied_count equal; ms a step, rank 0 / 1: {step_ms}; "
            f"launches a rank: B.1 {n[0]['dual_update']}, B.2 "
            f"{n[0]['slot_rotate']}, flash fwd_lse / dq / dkv "
            f"{n[0]['flash_fwd_lse']} / {n[0]['flash_bwd_dq']} / "
            f"{n[0]['flash_bwd_dkv']}; grad_norm mesh "
            f"{out[label]['grad_norm']} stacked "
            f"{out[label]['grad_norm_ref']}; census (bytes a rank "
            f"over the run) {json.dumps(tags)} = the wire model's pod_pop "
            f"{json.dumps(model)} x {MESH_LM_STEPS}")
    return out


def dec_rank_phase(tmp, procs):
    """Phase 22b: reads the ranks' and the reference's records: each
    run's joined checkpoint equals the dense run's leaf for leaf, loss
    and applied_count bit for bit, grad_norm and consensus_error to
    DEC_RANK_METRIC_RTOL; every rank's "gossip" census equals the wire
    model's round times the rounds and steps; prints a round's ms a
    rank."""
    import numpy as np
    from repro_torch.core import consensus
    from repro_torch.launch.wire_model import gossip_round_bytes
    secs = {n: wait_mesh_process(n, *procs[n])
            for n in ("22b ranks", "22b reference")}
    ranks = [read_json(f"{tmp}/dec-rank{r}.json") for r in range(DEC_RANK_N)]
    ref = read_json(f"{tmp}/dec-ref.json")
    _, rc = dec_rank_config({})
    cc = rc.consensus
    rounds = consensus.min_rounds(
        cc.delta, cc.n_workers, cc.msg_norm_J,
        consensus.lambda2(consensus.gossip_matrix(cc.topology, cc.n_workers)))
    rows = ranks[0]["rows"]
    out = {"seconds": secs, "rounds": rounds, "rows": rows}
    for label, knobs in DEC_RANK_RUNS.items():
        got = state_leaves(f"{tmp}/rank-{label}")
        want = state_leaves(f"{tmp}/ref-{label}")
        diff = unequal_leaves(got, want)
        h, hr = ranks[0][label]["history"], ref[label]["history"]
        assert not diff, (label, diff, [(a["loss"], b["loss"])
                                        for a, b in zip(h, hr)])
        assert len(h) == len(hr) == DEC_RANK_STEPS
        gaps = {}
        for a, b in zip(h, hr):
            for key in ("loss", "applied_count", "step"):
                assert a[key] == b[key], (label, key, a, b)
            for key in ("grad_norm", "consensus_error"):
                gap = abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
                gaps[key] = max(gaps.get(key, 0.0), gap)
                assert gap <= DEC_RANK_METRIC_RTOL, (label, key, a, b)
        one = gossip_round_bytes("ring", DEC_RANK_N, rows,
                                 knobs.get("compression", "none"))
        model = {dt: rounds * DEC_RANK_STEPS * b for dt, b in one.items()}
        for r in range(DEC_RANK_N):
            census, axes = census_of(ranks[r][label]["census"], "gossip")
            assert census == model and axes == {"worker"}, (label, r,
                                                            census, model)
        alive = [s.get("active_workers") for s in h]
        out[label] = dict(metric_rel_gaps=gaps, census=model,
                          loss=[s["loss"] for s in h], active=alive,
                          rank_s=[ranks[r][label]["seconds"]
                                  for r in range(DEC_RANK_N)],
                          ref_s=ref[label]["seconds"])
        log(f"phase 22b: decentralized linreg FULL ring-{DEC_RANK_N} "
            f"{label}, one worker a rank (4 gloo ranks on the card), "
            f"{DEC_RANK_STEPS} steps of {rounds} rounds: every leaf of the "
            f"joined checkpoint, loss and applied_count bit for bit the "
            f"dense run at one BLAS thread; grad_norm / consensus_error "
            f"relative gaps {gaps}; gossip census a rank {json.dumps(model)}"
            f" = gossip_round_bytes x {rounds} x {DEC_RANK_STEPS}; active "
            f"workers {alive}; a rank's run {out[label]['rank_s'][0]:.2f} s")
    out["p2p_probe"] = p2p_probe_result(tmp, procs["22b probe"][0])
    log(f"phase 22b: gloo point-to-point of a CUDA tensor as it is (not "
        f"staged), rank 0 / 1: {out['p2p_probe']}; the per-rank gossip "
        f"stages a CUDA payload through host copies on a gloo group "
        f"(dist.collectives.permute's rule on the group's backend)")
    for compression in ("none", "int8"):
        ms = [ranks[r][f"round_ms_{compression}"] for r in range(DEC_RANK_N)]
        out[f"round_ms_{compression}"] = ms
        wire = sum(gossip_round_bytes("ring", DEC_RANK_N, rows,
                                      compression).values())
        log(f"phase 22b: a gossip round, {compression}, {rows} rows a "
            f"worker (host clock over {GOSSIP_TIMED} synchronised rounds, "
            f"gloo through host copies): {['%.3f' % m for m in ms]} ms a "
            f"rank; {wire} bytes a rank a round")
    return out


def mesh_phase(launches, bg=None, after_lm=None):
    """Phase 22: the LMs on the mesh (22a) and the per-rank gossip (22b),
    from the processes ``start_mesh_background`` started (None starts
    them here). Adds 22a's launches to ``launches``. ``after_lm()`` runs
    once 22a's processes have ended."""
    bg = bg or start_mesh_background()
    tmp, procs = bg
    rec = {}
    try:
        t0 = time.perf_counter()
        rec["lm_mesh"] = mesh_lm_phase(tmp, procs, launches)
        rec["lm_mesh_s"] = time.perf_counter() - t0
        if after_lm is not None:
            after_lm()
        t0 = time.perf_counter()
        rec["gossip_rank"] = dec_rank_phase(tmp, procs)
        rec["gossip_rank_s"] = time.perf_counter() - t0
    finally:
        stop_mesh_background(bg)
    return rec


# -- phase 23: tensor parallelism over 'model' ------------------------------
# qwen1.5-0.5b FULL widths at MESH_LM_LAYERS layers (22a's run, in f32) on
# 1x1x2, without and with seq_parallel, against the 1x1x1 stacked run
TP_RUNS = {"1x1x2": False, "1x1x2-sp": True}
TP_RTOL = 1e-4        # loss; params: of the leaf's largest element


def tp_config(sp):
    """Phase 23's run config (``sp``: seq_parallel) on 1x1x2, in f32: a
    bf16 run's reductions (the norms' scale gradients over 16384 tokens)
    round apart by more than the limit wherever the partial sums are
    cut differently, as two bf16 implementations do (the CPU tests'
    bf16 limits are 2e-3 on the loss and 5e-2 on a gradient)."""
    from repro_torch.configs.base import MeshConfig
    cfg = lm_config("flash", n_layers=MESH_LM_LAYERS, seq_parallel=sp,
                    compute_dtype="float32")
    rc = lm_run_config(cfg, MESH_LM_SEQ, MESH_LM_WORKERS, 2, tau=1)
    return rc.replace(mesh=MeshConfig(1, 1, 2))


def tp_run(rc, device, mesh=None, n_steps=MESH_LM_STEPS,
           n_workers=MESH_LM_WORKERS, counters=None, join=True):
    """One run of phase 23 or 24 (on ``mesh``, or stacked in this
    process): (history, the whole params as one flat f32 array (None on
    a rank but 0; without ``join``, on a rank, its parameter leaves on
    the host instead), launches (of ``counters``, by default
    ``mesh_counters()``), each leaf's largest int8 row scale of the
    ring)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.arena import (flatten_tree, make_layout,
                                        tree_flatten, tree_unflatten)
    from repro_torch.dist.tensor_parallel import join_leaf, model_dims
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import LoopConfig, train
    counters = counters or mesh_counters()
    model = (xl_model(rc.model, device) if rc.model.xlstm is not None
             else build_model(rc.model, device=device))
    layout = make_layout(model.whole_param_shapes())
    loop = LoopConfig(n_steps=n_steps, n_workers=n_workers,
                      samples_per_worker=1, log_every=1)
    for k in counters.values():
        k.launches = 0
    out = train(model, rc, loop, device=device, mesh=mesh)
    launches = {n: k.launches for n, k in counters.items()}
    hist = out["history"]
    leaves, treedef = tree_flatten(out["state"].params)
    if mesh is not None and not join:
        leaves = [x.cpu() for x in leaves]
        del out, model
        torch.cuda.empty_cache()
        return hist, leaves, launches, None
    if mesh is not None:
        # join the model blocks (outside the census: the check's own)
        dims = model_dims(rc.model, layout, model.param_axes(), rc.mesh)
        group = mesh.device_mesh.get_group("model")
        for i, dim in enumerate(dims):
            if dim is not None:
                parts = [torch.empty_like(leaves[i])
                         for _ in range(rc.mesh.model)]
                dist.all_gather(parts, leaves[i].contiguous(), group=group)
                leaves[i] = join_leaf(parts, dim)
    flat = None
    if mesh is None or dist.get_rank() == 0:
        flat = flatten_tree(layout, tree_unflatten(treedef, leaves)
                            ).cpu().numpy()
    step = None
    if mesh is None:
        r2l = layout.row_to_leaf_on(device)
        smax = torch.stack([s[0] for s in out["state"].arena.scales]
                           ).amax(0)
        step = [float(smax[r2l == i].max()) for i in range(layout.n_leaves)]
    del out, model
    torch.cuda.empty_cache()
    return hist, flat, launches, step


def tp_rank_main(out_dir):
    """Phase 23's ranks (``--tp-rank=DIR`` under torch.distributed.run):
    each run of TP_RUNS on 1x1x2; rank 0 writes the params, each rank
    its record."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.dist.collectives import wire_census
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    rec = {}
    try:
        for label, sp in TP_RUNS.items():
            t0 = time.perf_counter()
            mesh = make_mesh(tp_config(sp).mesh, "cuda")
            with wire_census() as census:
                hist, flat, launches, _ = tp_run(tp_config(sp), "cuda",
                                                 mesh)
            rec[label] = dict(history=hist, launches=launches,
                              seconds=time.perf_counter() - t0,
                              census=[[*k, n] for k, n in
                                      census.bytes.items()])
            if rank == 0:
                np.save(f"{out_dir}/tp-{label}.npy", flat)
    finally:
        dist.destroy_process_group()
    with open(f"{out_dir}/tp-rank{rank}.json", "w") as f:
        json.dump(rec, f)
    return 0


def tp_ref_main(out_dir):
    """Phase 23's reference (``--tp-ref=DIR``): the 1x1x1 stacked run in
    this process; its params, each leaf's int8 step and its record
    written to DIR."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    hist, flat, launches, step = tp_run(tp_config(False), "cuda")
    np.save(f"{out_dir}/tp-ref.npy", flat)
    with open(f"{out_dir}/tp-ref.json", "w") as f:
        json.dump(dict(history=hist, launches=launches, int8_step=step,
                       seconds=time.perf_counter() - t0), f)
    return 0


def start_tp_background():
    """Start phase 23's processes in a temporary directory: the two ranks
    and the stacked reference. Returns (the directory, {name: (process,
    start time)})."""
    import os
    import tempfile
    tmp = tempfile.mkdtemp()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    script = str(root / "chip_smoke.py")
    procs = {}
    for name, cmd in (
            ("23 ranks", [sys.executable, "-m", "torch.distributed.run",
                          "--nproc-per-node=2", f"--master-port={free_port()}",
                          "--monitor-interval=0.5", script,
                          f"--tp-rank={tmp}"]),
            ("23 reference", [sys.executable, script, f"--tp-ref={tmp}"])):
        procs[name] = (subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, start_new_session=True), time.perf_counter())
    return tmp, procs


def tp_phase(launches, bg=None):
    """Phase 23: reads the ranks' and the reference's records; holds each
    run's losses, params and counts against the stacked run, each rank's
    launches against the stacked run's and its ``model`` census against
    ``model_axis_bytes``; prints each rank's ms a step, the launches and
    the census. Adds the launches to ``launches``."""
    import numpy as np
    from repro_torch.core.arena import make_layout
    from repro_torch.dist.tensor_parallel import model_dims
    from repro_torch.launch.wire_model import model_axis_bytes
    from repro_torch.models.api import build_model
    bg = bg or start_tp_background()
    tmp, procs = bg
    try:
        secs = {n: wait_mesh_process(n, *procs[n]) for n in procs}
        ranks = [read_json(f"{tmp}/tp-rank{r}.json") for r in range(2)]
        ref = read_json(f"{tmp}/tp-ref.json")
        want = np.load(f"{tmp}/tp-ref.npy")
        got_flat = {label: np.load(f"{tmp}/tp-{label}.npy")
                    for label in TP_RUNS}
    finally:
        stop_mesh_background(bg)
    rc = tp_config(False)
    model = build_model(rc.model, device="cpu")
    layout = make_layout(model.param_shapes())
    dims = model_dims(rc.model, layout, model.param_axes(), rc.mesh)
    h_ref = ref["history"]
    counts = [h["applied_count"] for h in h_ref if h["applied_count"]]
    for name, k in ref["launches"].items():
        launches[name] += k
    out = {"seconds": secs, "ref_s": ref["seconds"]}
    for label, sp in TP_RUNS.items():
        got = got_flat[label]
        worst = 0.0
        for i, (ofs, size) in enumerate(zip(layout.row_offsets,
                                            layout.sizes)):
            a = got.reshape(-1)[ofs * 128:ofs * 128 + size]
            b = want.reshape(-1)[ofs * 128:ofs * 128 + size]
            limit = TP_RTOL * float(np.abs(b).max()) + \
                ref["int8_step"][i] / min(counts)
            err = float(np.abs(a - b).max())
            assert err <= limit, (label, i, err, limit)
            worst = max(worst, err / limit)
        h = ranks[0][label]["history"]
        loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                       for a, b in zip(h, h_ref))
        assert loss_rel <= TP_RTOL, (label, loss_rel)
        for a, b in zip(h, h_ref):
            for key in ("applied_count", "local_count"):
                assert a[key] == b[key], (label, key, a, b)
        n = [ranks[r][label]["launches"] for r in range(2)]
        for r in range(2):
            assert n[r] == ref["launches"], (label, r, n[r], ref["launches"])
            for name, k in n[r].items():
                launches[name] += k
        cfg = tp_config(sp).model
        one = model_axis_bytes(cfg, layout, dims, MESH_LM_WORKERS // 2,
                               MESH_LM_SEQ, 2, 2, "int8")
        census = {}
        for r in range(2):
            census = {f"{tag}/{dt}": b for axis, dt, tag, b in
                      ranks[r][label]["census"] if axis == "model"}
            model_count = {f"{t}/{dt}": MESH_LM_STEPS * b
                           for (t, dt), b in one.items()}
            assert census == model_count, (label, r, census, model_count)
        step_ms = [[1e3 * s["step_s"] for s in ranks[r][label]["history"]]
                   for r in range(2)]
        out[label] = dict(loss_rel=loss_rel, params_err_over_limit=worst,
                          step_ms=step_ms, launches=n[0], census=census,
                          loss=[s["loss"] for s in h],
                          loss_ref=[s["loss"] for s in h_ref],
                          ref_step_ms=[1e3 * s["step_s"] for s in h_ref],
                          rank_s=[ranks[r][label]["seconds"]
                                  for r in range(2)])
        log(f"phase 23: qwen1.5-0.5b FULL widths {MESH_LM_LAYERS} layers "
            f"flash int8 {MESH_LM_SEQ} tokens on {label} (tensor parallel "
            f"over 2 gloo ranks on the card, seq_parallel={sp}), "
            f"{MESH_LM_STEPS} steps: loss rel gap {loss_rel:.3e} (limit "
            f"{TP_RTOL}); params worst leaf at {worst:.3f} of its limit "
            f"({TP_RTOL} of the leaf's largest element + one int8 step); "
            f"counts equal; ms a step, rank 0 / 1: {step_ms} (stacked "
            f"{out[label]['ref_step_ms']}); launches a rank (8 of 16 heads "
            f"a flash call): B.1 {n[0]['dual_update']}, B.2 "
            f"{n[0]['slot_rotate']}, flash fwd_lse / dq / dkv "
            f"{n[0]['flash_fwd_lse']} / {n[0]['flash_bwd_dq']} / "
            f"{n[0]['flash_bwd_dkv']} (the stacked run's); 'model' census "
            f"(bytes a rank over the run) {json.dumps(census)} = "
            f"model_axis_bytes x {MESH_LM_STEPS}")
    return out


# -- phase 24: tensor parallelism for the MoE and the hybrid ------------------
# Each run f32, tau 1, TP24_STEPS steps on 1x1x2 (two gloo ranks sharing
# the card), int8, held against its 1x1x1 stacked run on the same route
# (made in a process of its own) to phase 23's limits:
#   mixtral: mixtral-8x7b FULL widths (8 experts, top 2), TP24_MIX_LAYERS
#            layer, the gather dispatch, flash (16 of 32 query heads and 4
#            of 8 kv heads a rank), TP24_MIX_SEQ tokens a sequence;
#   zamba2:  zamba2-2.7b FULL widths, TP24_Z_LAYERS layers (one shared-block
#            application), the scan kernel on 40 of 80 heads a rank,
#            flash at D = 80 (16 of 32 heads), seq_parallel.
# A rank of the mixtral run holds ~0.92B f32 parameters and as many
# gradients, half the rows of the arena (z, the int8 ring and its
# residual, the gradient rows) and, in the w bridge, the whole f32 w a
# moment (6.9 GB): each process's peak is printed (on an H100 80GB: 37.2
# GiB a rank, 54.5 the stacked run; zamba2 11.2 a rank, 16.2 stacked). So
# the phase runs in TP24_STAGES, each once the one before has ended; in
# the whole script the first two run beside phases 9-14, whose card
# memory is small, and the mixtral ranks start (imports, the card, the
# process group) beside phase 23 and run alone at phase 24. Each rank holds its
# parameter blocks against its blocks of the stacked run's parameters
# (written by then), so no process gathers or writes the whole tree.
TP24_STEPS = 2
TP24_WORKERS = 2          # one sequence each, one microbatch each
TP24_MIX_LAYERS = 1
TP24_MIX_SEQ = 4096
TP24_Z_LAYERS = 6
TP24_Z_SEQ = 4096
TP24_RUNS = ("mixtral", "zamba2")
TP24_STAGES = (("zamba2 ranks", "zamba2 reference"), ("mixtral reference",),
               ("mixtral ranks",))
TP24_KINDS = {"ranks": "rank", "reference": "ref"}   # a process's --tp24

# -- phase 25: tensor parallelism for the encoder-decoder, the VLM and the
# xLSTM ------------------------------------------------------------------------
# Phase 24's machinery (processes, records, checks and limits) on three more
# runs, each f32, tau 1, int8, TP24_STEPS steps of TP24_WORKERS sequences on
# 1x1x2 against its 1x1x1 stacked run:
#   seamless:  seamless-m4t-large-v2 FULL widths, TP25_ED_LAYERS encoder and
#              as many decoder layers (~0.65B parameters), flash (8 of 16
#              heads a rank; the encoder and the cross-attention
#              non-causal), seq_parallel, TP25_ED_SEQ frames and tokens;
#   paligemma: paligemma-3b FULL widths, TP25_VLM_LAYERS layer (~0.64B
#              parameters), 256 patches + 1792 text tokens, seq_parallel
#              (the prefix-LM mask on the plain core; the whole-kv route);
#   xlstm:     xlstm-125m FULL widths, TP25_XL_LAYERS layers (an mLSTM and an
#              sLSTM block, ~55M parameters), the sLSTM's w_h rescaled
#              (xl_rescale_), TP25_XL_SEQ tokens.
TP25_RUNS = ("seamless", "paligemma", "xlstm")
TP25_ED_LAYERS = 2
TP25_ED_SEQ = 2048
TP25_VLM_LAYERS = 1
TP25_VLM_SEQ = 2048
TP25_XL_LAYERS = 2
TP25_XL_SEQ = 512
# Alone (``--only=25``) the stages run one after the other. In the whole
# script the first (the references and the xLSTM ranks) runs beside phases
# 3-7 (the host's cores idle there), phase 8 waiting for it; the seamless
# ranks beside phase 15 and the paligemma ranks beside 16, each readied
# (imports, the card, the process group) a phase ahead, phases 16 and 17
# waiting for the stage before them. Their peaks (on an H100 80GB): the
# references 20.8 (seamless) / 21.6 (paligemma) / 1.8 GiB (xlstm), the
# ranks 14.6 / 15.6 / 1.3 each; beside them phases 6 and 15 peak at 21.6
# and 30.6, phase 8 at 28.6, phase 17 at 56.2, phase 24's mixtral reference
# (beside 10-14) at 54.5.
TP25_STAGES = (("xlstm ranks", "xlstm reference", "seamless reference",
                "paligemma reference"),
               ("seamless ranks",),
               ("paligemma ranks",))


def tp24_config(label):
    """Phase 24's or 25's run config of ``label`` on 1x1x2."""
    from repro_torch.configs.base import MeshConfig
    if label == "mixtral":
        cfg = mix_config("flash", moe_impl="gather",
                         n_layers=TP24_MIX_LAYERS, compute_dtype="float32")
        seq = TP24_MIX_SEQ
    elif label == "zamba2":
        cfg = z_route("kernel", n_layers=TP24_Z_LAYERS,
                      compute_dtype="float32", seq_parallel=True)
        seq = TP24_Z_SEQ
    elif label == "seamless":
        cfg = ed_config("seamless-m4t-large-v2", TP25_ED_LAYERS,
                        attn_impl="flash", block_remat="full",
                        compute_dtype="float32", seq_parallel=True)
        seq = TP25_ED_SEQ
    elif label == "paligemma":
        cfg = ed_config("paligemma-3b", TP25_VLM_LAYERS, block_remat="full",
                        compute_dtype="float32", seq_parallel=True)
        seq = TP25_VLM_SEQ
    else:
        cfg = xl_config(n_layers=TP25_XL_LAYERS, compute_dtype="float32")
        seq = TP25_XL_SEQ
    rc = lm_run_config(cfg, seq, TP24_WORKERS, TP24_WORKERS, tau=1)
    return rc.replace(mesh=MeshConfig(1, 1, 2))


def tp24_counters():
    """Phase 24's launch counters: phase 22's and the scan's."""
    from repro_torch.kernels.linear_scan import kernel as sk
    return dict(mesh_counters(), linear_scan_fwd=sk.FWD,
                linear_scan_bwd=sk.BWD)


def wait_file(path, what, timeout=900):
    """Wait for ``path`` to exist (another process writes it last)."""
    t0 = time.perf_counter()
    while not Path(path).exists():
        assert time.perf_counter() - t0 < timeout, f"no {what} at {path}"
        time.sleep(0.2)


def tp24_record(label, rc, mesh, out_dir, rank, device="cuda"):
    """Run ``label`` (stacked without ``mesh``) and write its record:
    history, launches, seconds, the peak of the card's memory this
    process allocated and, on the mesh, the census and each leaf's (gap
    to the stacked run's block, limit); the stacked run writes its whole
    params (flat f32) and each leaf's int8 step."""
    import numpy as np
    import torch
    from repro_torch.dist.collectives import wire_census
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with wire_census() as census:
        hist, flat, launches, step = tp_run(
            rc, device, mesh, n_steps=TP24_STEPS, n_workers=TP24_WORKERS,
            counters=tp24_counters(), join=False)
    rec = dict(history=hist, launches=launches, int8_step=step,
               seconds=time.perf_counter() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               census=[[*k, n] for k, n in census.bytes.items()])
    name = "ref" if mesh is None else f"rank{rank}"
    if mesh is None:
        np.save(f"{out_dir}/tp24-{label}-ref.npy", flat)
    else:
        rec["leaves"] = tp24_leaf_gaps(label, rc, flat, hist, out_dir,
                                       mesh.coords["model"])
    with open(f"{out_dir}/tp24-{label}-{name}.json", "w") as f:
        json.dump(rec, f)


def tp24_leaf_gaps(label, rc, local, hist, out_dir, m):
    """[gap, limit] of each parameter leaf of model rank ``m`` (``local``,
    on the host): max |leaf - its block of the stacked run's|, and phase
    23's limit (TP_RTOL of the stacked leaf's largest element plus one
    int8 step of the leaf over the smallest applied count)."""
    import numpy as np
    import torch
    from repro_torch.core.arena import make_layout
    from repro_torch.dist.tensor_parallel import (ModelAxis, cut_leaf,
                                                  model_dims)
    from repro_torch.models.api import build_model
    wait_file(f"{out_dir}/tp24-{label}-ref.json", "stacked record")
    ref = read_json(f"{out_dir}/tp24-{label}-ref.json")
    flat = np.load(f"{out_dir}/tp24-{label}-ref.npy",
                   mmap_mode="r").reshape(-1)
    model = build_model(rc.model, device="cpu")
    layout = make_layout(model.whole_param_shapes())
    dims = model_dims(rc.model, layout, model.param_axes(), rc.mesh)
    ax = ModelAxis(None, rc.mesh.model, m)
    counts = [h["applied_count"] for h in ref["history"]
              if h["applied_count"]]
    assert [h["applied_count"] for h in hist] == \
        [h["applied_count"] for h in ref["history"]]
    out = []
    for i, (ofs, size, shape) in enumerate(zip(
            layout.row_offsets, layout.sizes, layout.shapes)):
        whole = torch.from_numpy(np.array(
            flat[ofs * 128:ofs * 128 + size])).reshape(shape)
        want = whole if dims[i] is None else cut_leaf(whole, dims[i], ax)
        gap = float((local[i] - want).abs().max())
        out.append([gap, TP_RTOL * float(whole.abs().max())
                    + ref["int8_step"][i] / min(counts)])
    return out


def tp24_main(arg):
    """A phase-24 process (``--tp24=DIR:LABEL:KIND``, KIND "rank" under
    torch.distributed.run or "ref"): readies itself (under "rank" the
    card, the process group and the mesh), waits for DIR/go.LABEL.KIND,
    then runs and writes its record."""
    import torch
    out_dir, label, kind = arg.rsplit(":", 2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    torch.cuda.init()
    rc = tp24_config(label)
    if kind == "ref":
        from repro_torch.configs.base import MeshConfig
        wait_file(f"{out_dir}/go.{label}.{kind}", "go")
        tp24_record(label, rc.replace(mesh=MeshConfig(1, 1, 1)), None,
                    out_dir, 0)
        return 0
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method="env://")
    try:
        mesh = make_mesh(rc.mesh, "cuda")
        wait_file(f"{out_dir}/go.{label}.{kind}", "go")
        tp24_record(label, rc, mesh, out_dir, dist.get_rank())
    finally:
        dist.destroy_process_group()
    return 0


class TP24Stages:
    """Phase 24's (or 25's, 26's) processes, stage by stage (``stages``,
    by default TP24_STAGES; each process runs this script with ``flag``),
    in a temporary directory. ``spawn`` starts a
    stage's processes, which ready themselves and wait; ``go`` lets them
    run. ``stop`` (also at exit) kills what still runs and removes the
    directory."""

    def __init__(self, stages=TP24_STAGES, flag="--tp24"):
        import atexit
        import tempfile
        self.stages, self.flag = stages, flag
        self.tmp = tempfile.mkdtemp()
        self.procs, self.secs, self.started = {}, {}, set()
        atexit.register(self.stop)

    def spawn(self, i):
        """Start stage ``i``'s processes (waiting for their go)."""
        import os
        root = Path(__file__).resolve().parent
        # expandable segments: the mixtral ranks' peaks leave little of
        # the card, where a fragmented cache ran out
        env = dict(os.environ, PYTHONPATH=str(root / "src"),
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        script = str(root / "chip_smoke.py")
        for name in self.stages[i]:
            if name in self.procs or name in self.secs:
                continue
            label, kind = name.split()
            flag = f"{self.flag}={self.tmp}:{label}:{TP24_KINDS[kind]}"
            if kind == "ranks":
                cmd = [sys.executable, "-m", "torch.distributed.run",
                       "--nproc-per-node=2", f"--master-port={free_port()}",
                       "--monitor-interval=0.5", script, flag]
            else:
                cmd = [sys.executable, script, flag]
            self.procs[name] = (subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, start_new_session=True), time.perf_counter())

    def go(self, i):
        """Spawn stage ``i`` if it is not, and let it run."""
        self.spawn(i)
        for name in self.stages[i]:
            label, kind = name.split()
            Path(f"{self.tmp}/go.{label}.{TP24_KINDS[kind]}").touch()
        self.started.add(i)

    def finished(self, i):
        """Whether every process of stage ``i`` has exited."""
        return all(self.procs[n][0].poll() is not None
                   for n in self.stages[i] if n in self.procs)

    def wait(self, i):
        """Wait for stage ``i``'s processes: each one's seconds."""
        for name in self.stages[i]:
            if name in self.procs:
                proc, t0 = self.procs.pop(name)
                self.secs[name] = wait_mesh_process(name, proc, t0)

    def advance(self, last):
        """Start the next stage up to ``last`` once the one before has
        ended (waited for); no waiting otherwise."""
        i = max(self.started, default=-1)
        if i < last and (i < 0 or self.finished(i)):
            if i >= 0:
                self.wait(i)
            self.go(i + 1)

    def finish(self, last):
        """Run the stages up to ``last`` to their end, each after the
        one before."""
        for i in range(last + 1):
            if i not in self.started:
                self.go(i)
            self.wait(i)

    def stop(self):
        import shutil
        for proc, _ in self.procs.values():
            stop_dist_ranks(proc)
        self.procs = {}
        shutil.rmtree(self.tmp, ignore_errors=True)


def tp24_phase(launches, stages=None):
    """Phase 24: every stage ``stages`` (a ``TP24Stages``) has not run,
    each after the one before; then each run held against its stacked
    run as phase 23 holds its own (losses, params, counts, launches a
    rank equal to the stacked run's, the ``model`` census equal to
    ``model_axis_bytes``); prints each process's peak, each rank's ms a
    step and the launches. Adds the launches to ``launches``."""
    stages = stages or TP24Stages()
    try:
        stages.finish(len(TP24_STAGES) - 1)
        return tp24_check(stages.tmp, launches, stages.secs)
    finally:
        stages.stop()


def tp25_phase(launches, stages=None):
    """Phase 25: ``tp24_phase`` on TP25_RUNS (every stage of ``stages``,
    a ``TP24Stages`` of TP25_STAGES, that has not run)."""
    stages = stages or TP24Stages(TP25_STAGES)
    try:
        stages.finish(len(TP25_STAGES) - 1)
        return tp24_check(stages.tmp, launches, stages.secs, TP25_RUNS,
                          "25")
    finally:
        stages.stop()


def tp24_check(tmp, launches, secs, labels=TP24_RUNS, phase="24"):
    """Phase 24's (or 25's) checks on the records in ``tmp``
    (``tp24_phase``)."""
    from repro_torch.core.arena import make_layout
    from repro_torch.dist.tensor_parallel import model_dims
    from repro_torch.launch.wire_model import model_axis_bytes
    from repro_torch.models.api import build_model
    out = {"seconds": secs}
    for label in labels:
        rc = tp24_config(label)
        model = build_model(rc.model, device="cpu")
        layout = make_layout(model.whole_param_shapes())
        dims = model_dims(rc.model, layout, model.param_axes(), rc.mesh)
        ref = read_json(f"{tmp}/tp24-{label}-ref.json")
        ranks = [read_json(f"{tmp}/tp24-{label}-rank{r}.json")
                 for r in range(2)]
        h_ref = ref["history"]
        worst = 0.0
        for r in range(2):
            assert len(ranks[r]["leaves"]) == layout.n_leaves
            for i, (gap, limit) in enumerate(ranks[r]["leaves"]):
                assert gap <= limit, (label, r, i, gap, limit)
                worst = max(worst, gap / limit)
        h = ranks[0]["history"]
        loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                       for a, b in zip(h, h_ref))
        assert loss_rel <= TP_RTOL, (label, loss_rel)
        for a, b in zip(h, h_ref):
            for key in ("applied_count", "local_count"):
                assert a[key] == b[key], (label, key, a, b)
        path = ((("linear_scan_fwd", "linear_scan_bwd") if label == "zamba2"
                 else ()) + ("dual_update", "slot_rotate")
                + (("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
                   if rc.model.attn_impl == "flash" else ()))
        for name in path:
            assert ref["launches"][name] > 0, (label, name, ref["launches"])
        for name, k in ref["launches"].items():
            launches[name] += k
        n = [r["launches"] for r in ranks]
        for r in range(2):
            assert n[r] == ref["launches"], (label, r, n[r], ref["launches"])
            for name, k in n[r].items():
                launches[name] += k
        one = model_axis_bytes(rc.model, layout, dims, 1, rc.shape.seq_len,
                               TP24_WORKERS, 2, "int8")
        model_count = {f"{t}/{dt}": TP24_STEPS * b for (t, dt), b in
                       one.items()}
        for r in range(2):
            census = {f"{tag}/{dt}": b for axis, dt, tag, b in
                      ranks[r]["census"] if axis == "model"}
            assert census == model_count, (label, r, census, model_count)
        step_ms = [[1e3 * s["step_s"] for s in r["history"]] for r in ranks]
        peaks = [r["peak_gib"] for r in ranks]
        out[label] = dict(loss_rel=loss_rel, params_err_over_limit=worst,
                          step_ms=step_ms, launches=n[0],
                          census=model_count, peak_gib=peaks,
                          ref_peak_gib=ref["peak_gib"],
                          loss=[s["loss"] for s in h],
                          loss_ref=[s["loss"] for s in h_ref],
                          ref_step_ms=[1e3 * s["step_s"] for s in h_ref],
                          rank_s=[r["seconds"] for r in ranks],
                          ref_s=ref["seconds"])
        depth = (f"{rc.model.n_encoder_layers} + {rc.model.n_layers}"
                 if rc.model.family == "encdec" else f"{rc.model.n_layers}")
        log(f"phase {phase} {label}: FULL widths {depth} layer(s) "
            f"f32 int8 {rc.shape.seq_len} tokens x {TP24_WORKERS} on 1x1x2 "
            f"(2 gloo ranks on the card, seq_parallel="
            f"{rc.model.seq_parallel}), {TP24_STEPS} steps: loss rel gap "
            f"{loss_rel:.3e} (limit {TP_RTOL}); params worst leaf at "
            f"{worst:.3f} of its limit; counts equal; peak GiB a rank "
            f"{[round(p, 2) for p in peaks]} (stacked "
            f"{ref['peak_gib']:.2f}); ms a step, rank 0 / 1: {step_ms} "
            f"(stacked {out[label]['ref_step_ms']}); launches a rank "
            f"(the stacked run's): {json.dumps(n[0])}; 'model' census "
            f"{json.dumps(model_count)} = model_axis_bytes x {TP24_STEPS}; "
            f"process seconds "
            f"{json.dumps({k: round(v, 1) for k, v in secs.items()})}")
    return out


# -- phase 26: serving over 'model' ------------------------------------------
# ``api.serve`` on 1x1x2 (two gloo ranks sharing the card) for each of
# TP26_RUNS at FULL widths and phases 23-25's depths, f32 with an f32
# cache, TP26_SLOTS slots for TP26_STEPS engine steps of the seeded Poisson
# queue, against the stacked 1x1x1 engine (a process of its own): tokens and
# trace equal, each step's joined logits within TP26_RTOL of the largest
# element, the census equal to ``decode_axis_bytes``. The processes ready
# themselves beside phase 17 and run beside phases 18 and on; each draws
# every family's whole tree on the host (~3.8B normal draws at ~100M/s), so
# the stacked process peaks at mixtral's whole 6.9 GB of f32 weights, a rank
# at half of it.
TP26_RUNS = ("qwen", "mixtral", "zamba2", "seamless", "paligemma", "xlstm")
TP26_SLOTS, TP26_STEPS, TP26_MAX_LEN = 8, 24, 64
TP26_PROFILED = 4        # the last steps, profiled: kernels a step
TP26_RTOL = 1e-4
TP26_STAGES = (("serve ranks", "serve reference"),)


def tp26_config(label):
    """Phase 26's run config of ``label`` (f32 compute; the mesh field is
    the ranks' 1x1x2)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (MeshConfig, RunConfig, ServeConfig,
                                          TRAIN_4K)
    if label == "qwen":
        cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                                  n_layers=MESH_LM_LAYERS)
    elif label == "mixtral":
        cfg = mix_config("xla", moe_impl="gather", n_layers=TP24_MIX_LAYERS)
    elif label == "zamba2":
        cfg = z_config("xla", n_layers=TP24_Z_LAYERS)
    elif label == "seamless":
        cfg = ed_config("seamless-m4t-large-v2", TP25_ED_LAYERS)
    elif label == "paligemma":
        cfg = ed_config("paligemma-3b", TP25_VLM_LAYERS)
    else:
        cfg = xl_config(n_layers=TP25_XL_LAYERS)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    return RunConfig(model=cfg, shape=TRAIN_4K, mesh=MeshConfig(1, 1, 2),
                     serve=ServeConfig(
                         slots=TP26_SLOTS, max_len=TP26_MAX_LEN, max_new=8,
                         arrival="poisson", arrival_rate=1.0,
                         prompt_len_min=4, prompt_len_max=16, seed=26))


class LogitsTap:
    """``model`` (a ``models.api.Model``) whose ``decode_step`` keeps each
    step's last-position logits on the device (``logits``)."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, params, cache, tokens, pos):
        logits, cache = self.model.decode_step(params, cache, tokens, pos)
        self.logits.append(logits[:, -1])
        return logits, cache


def tp26_serve(label, out_dir, name):
    """Serve ``label`` (under the active mesh, or stacked without one) and
    write its record and its logits (``name``: "ref" or "rankR"); the
    stacked engine and rank 0 profile the last TP26_PROFILED steps
    (kernels a step)."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core.arena import tree_flatten
    from repro_torch.dist.collectives import wire_census
    from repro_torch.models.api import build_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rc = tp26_config(label)
    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    model = LogitsTap(xl_model(rc.model, "cuda") if rc.model.xlstm
                      else build_model(rc.model, device="cuda"))
    engine, queue = api.serve(model, rc, device="cuda")
    slots, max_len = rc.serve.slots, rc.serve.max_len
    engine.cache, _ = model.init_decode_state(slots, max_len, torch.float32)
    engine._cache0, _ = model.init_decode_state(slots, max_len,
                                                torch.float32)
    init_s = time.perf_counter() - t0
    trace, times = [], []

    def step():
        arrived = queue.step()
        t1 = time.perf_counter()
        ev = engine.step(queue)
        times.append(time.perf_counter() - t1)
        trace.append(dict(ev, arrived=arrived))

    with wire_census() as census:
        for _ in range(TP26_STEPS - TP26_PROFILED):
            step()
        if name in ("ref", "rank0"):
            _, kernels = profiled(lambda: [step() for _ in
                                           range(TP26_PROFILED)])
        else:
            kernels = None
            for _ in range(TP26_PROFILED):
                step()
    logits = torch.stack(model.logits).cpu().numpy()
    np.save(f"{out_dir}/tp26-{label}-{name}.npy", logits)
    rec = dict(trace=trace, outs=[list(o) for o in engine._out],
               completions=engine.completions, init_s=init_s,
               step_ms=[1e3 * t for t in times],
               kernels_per_step=(len(kernels) / TP26_PROFILED if kernels
                                 else None),
               launches={n: k.launches for n, k in counters.items()},
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               census=[[*k, n] for k, n in census.bytes.items()],
               n_params=sum(x.numel() for x in
                            tree_flatten(engine.params)[0]))
    with open(f"{out_dir}/tp26-{label}-{name}.json", "w") as f:
        json.dump(rec, f)
    del engine, model, logits
    torch.cuda.empty_cache()


def tp26_main(arg):
    """A phase-26 process (``--tp26=DIR:LABEL:KIND``, KIND "rank" under
    torch.distributed.run or "ref"): readies itself (under "rank" the
    card, the process group and the 1x1x2 mesh), waits for
    DIR/go.LABEL.KIND, then serves every run of TP26_RUNS and writes its
    records."""
    import torch
    out_dir, label, kind = arg.rsplit(":", 2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    torch.cuda.init()
    if kind == "ref":
        wait_file(f"{out_dir}/go.{label}.{kind}", "go")
        for run in TP26_RUNS:
            tp26_serve(run, out_dir, "ref")
        return 0
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method="env://")
    try:
        mesh = make_mesh(tp26_config(TP26_RUNS[0]).mesh, "cuda")
        wait_file(f"{out_dir}/go.{label}.{kind}", "go")
        for run in TP26_RUNS:
            with mesh:
                tp26_serve(run, out_dir, f"rank{dist.get_rank()}")
    finally:
        dist.destroy_process_group()
    return 0


def tp26_phase(launches, stages=None):
    """Phase 26: the stage of ``stages`` (a ``TP24Stages`` of TP26_STAGES)
    run to its end if it has not; then each run's ranks held against the
    stacked engine: the trace, every slot's tokens and the completions
    equal, each step's joined logits within TP26_RTOL of the step's
    largest element, the census equal to ``decode_axis_bytes`` times the
    decode steps, no kernel of the port launched (none is on the decode
    path). Prints a line a run. Returns the record."""
    import numpy as np
    from repro_torch.launch.wire_model import decode_axis_bytes
    stages = stages or TP24Stages(TP26_STAGES, flag="--tp26")
    try:
        stages.finish(0)
        tmp = stages.tmp
        out = {"seconds": stages.secs}
        for label in TP26_RUNS:
            rc = tp26_config(label)
            ref = read_json(f"{tmp}/tp26-{label}-ref.json")
            ranks = [read_json(f"{tmp}/tp26-{label}-rank{r}.json")
                     for r in range(2)]
            want = np.load(f"{tmp}/tp26-{label}-ref.npy")
            got = np.concatenate([np.load(f"{tmp}/tp26-{label}-rank{r}.npy")
                                  for r in range(2)], axis=-1)
            assert got.shape == want.shape, (label, got.shape, want.shape)
            worst = 0.0
            for t in range(want.shape[0]):
                limit = TP26_RTOL * float(np.abs(want[t]).max())
                gap = float(np.abs(got[t] - want[t]).max())
                assert gap <= limit, (label, t, gap, limit)
                worst = max(worst, gap / limit)
            n_dec = sum(ev["active"] > 0 for ev in ref["trace"])
            assert n_dec == want.shape[0], (label, n_dec, want.shape)
            assert ref["completions"], label
            one = decode_axis_bytes(rc.model, rc.serve.slots, 2, 1)
            model_count = {f"{t}/{dt}": n_dec * b for (t, dt), b in
                           one.items()}
            for r in ranks:
                for key in ("trace", "outs", "completions"):
                    assert r[key] == ref[key], (label, key)
                census = {f"{tag}/{dt}": b for _, dt, tag, b in r["census"]}
                assert census == model_count, (label, census, model_count)
            for rec in [ref] + ranks:
                assert not any(rec["launches"].values()), (label,
                                                           rec["launches"])
            med = [statistics.median(r["step_ms"][1:TP26_STEPS
                                                  - TP26_PROFILED])
                   for r in ranks]
            out[label] = dict(
                logits_err_over_limit=worst, decode_steps=n_dec,
                tokens=sum(len(o) for _, o in ref["completions"]),
                median_step_ms=med,
                ref_median_step_ms=statistics.median(
                    ref["step_ms"][1:TP26_STEPS - TP26_PROFILED]),
                peak_gib=[r["peak_gib"] for r in ranks],
                ref_peak_gib=ref["peak_gib"],
                kernels_per_step=[r["kernels_per_step"] for r in ranks],
                ref_kernels_per_step=ref["kernels_per_step"],
                init_s=[r["init_s"] for r in ranks], ref_init_s=ref["init_s"],
                census=model_count, n_params=ranks[0]["n_params"],
                ref_n_params=ref["n_params"])
            o = out[label]
            depth = (f"{rc.model.n_encoder_layers} + {rc.model.n_layers}"
                     if rc.model.family == "encdec"
                     else f"{rc.model.n_layers}")
            kps = ("not measured" if o["kernels_per_step"][0] is None
                   else f"{o['kernels_per_step'][0]:.1f}")
            log(f"phase 26 {label}: FULL widths {depth} layer(s) f32, "
                f"api.serve {rc.serve.slots} slots x {TP26_STEPS} steps on "
                f"1x1x2 (2 gloo ranks on the card; {o['n_params']:,} of "
                f"{o['ref_n_params']:,} parameters a rank): tokens, trace "
                f"and completions equal the stacked engine's "
                f"({o['tokens']} tokens completed); logits worst step at "
                f"{worst:.3f} of {TP26_RTOL} of its largest element; "
                f"census {json.dumps(model_count)} = decode_axis_bytes x "
                f"{n_dec}; median step a rank {med[0]:.2f} / {med[1]:.2f} ms "
                f"(stacked {o['ref_median_step_ms']:.2f}); peak GiB a rank "
                f"{[round(p, 2) for p in o['peak_gib']]} (stacked "
                f"{o['ref_peak_gib']:.2f}); kernels a step rank 0 {kps} "
                f"(stacked {o['ref_kernels_per_step']}); init s a rank "
                f"{[round(x, 1) for x in o['init_s']]} (stacked "
                f"{o['ref_init_s']:.1f})")
        log(f"phase 26: process seconds "
            f"{json.dumps({k: round(v, 1) for k, v in stages.secs.items()})}")
        return out
    finally:
        stages.stop()


def kernel_counters():
    """{name: the launch counter of each kernel wrapper} (each wrapper
    adds one where it launches its kernel)."""
    from repro_torch.kernels.delay_ring import kernel as ring_kernel
    from repro_torch.kernels.dual_update import kernel as update_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.linear_scan import kernel as scan_kernel
    return {"dual_update": update_kernel.KERNEL,
            "slot_rotate": ring_kernel.KERNEL,
            "variable_pop": ring_kernel.VARIABLE_POP_KERNEL,
            "ring_rotate": ring_kernel.RING_KERNEL,
            "flash_fwd": flash_kernel.FWD,
            "flash_fwd_lse": flash_kernel.FWD_LSE,
            "flash_bwd_dq": flash_kernel.DQ,
            "flash_bwd_dkv": flash_kernel.DKV,
            "dual_update_pytree": update_kernel.UPDATE,
            "linear_scan_fwd": scan_kernel.FWD,
            "linear_scan_bwd": scan_kernel.BWD}


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repository)
    # the processes phases 21b, 22 and 23 start: 21b's ranks and
    # reference, 22a's ranks and reference, 22b's ranks, reference and
    # probe, 23's ranks and reference
    roles = {"--dist-rank": dist_rank_main, "--stacked-ref": stacked_ref_main,
             "--mesh-lm-rank": mesh_lm_rank_main,
             "--mesh-lm-ref": mesh_lm_ref_main,
             "--dec-rank": dec_rank_main, "--dec-ref": dec_rank_ref_main,
             "--p2p-probe": p2p_probe_main, "--tp-rank": tp_rank_main,
             "--tp-ref": tp_ref_main, "--tp24": tp24_main,
             "--tp26": tp26_main,
             "--z9-cpu": z9_cpu_main, "--sim-paper": sim_paper_main}
    for a in sys.argv[1:]:
        flag, _, value = a.partition("=")
        if flag in roles:
            return roles[flag](value)
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    t_script = time.perf_counter()
    phase_s = {}

    def phase_done(name, t0):
        phase_s[name] = time.perf_counter() - t0
        log(f"{name}: {phase_s[name]:.1f} s")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build()
    log(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Function prop" in \
                    line:
                log(f"  {name}: {line.strip()}")
    hgmma = sass_counts(build.library_path("flash_attention"), "HGMMA")
    for name, n in sorted(hgmma.items()):
        log(f"  flash_attention SASS: {n} HGMMA in {name}")
    assert any("_wgmma" in name for name in hgmma), hgmma
    for name, n in hgmma.items():
        assert (n > 0) == ("_wgmma" in name), (name, n)
    for d in flash_kernel.HEAD_DIMS:    # every head dim, each kernel
        for k in ("flash_fwd_wgmma", "flash_bwd_dq_wgmma",
                  "flash_bwd_dkv_wgmma", "flash_fwd_kernel",
                  "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
            assert any(k in name and f"ILi{d}E" in name
                       for name in hgmma), (k, d)
    hmma = sass_counts(build.library_path("linear_scan"), "HMMA")
    for name, n in sorted(hmma.items()):
        log(f"  linear_scan SASS: {n} HMMA in {name}")
    assert any("linear_scan_out" in name for name in hmma), hmma
    for name, n in hmma.items():
        assert (n > 0) == ("linear_scan_pass" not in name), (name, n)
    phase_done("phase 1", t0)

    counters = kernel_counters()
    launches = dict.fromkeys(counters, 0)

    def drive(fn):
        """Run ``fn()`` with every launch count set to 0 just before;
        returns (its result, the counts just after), the counts also
        added to the kernels line's ``launches``."""
        for k in counters.values():
            k.launches = 0
        out = fn()
        n = {name: k.launches for name, k in counters.items()}
        for name in n:
            launches[name] += n[name]
        return out, n

    def expect(**nonzero):
        """The counts of a run: those named, 0 for every other kernel."""
        return dict(dict.fromkeys(counters, 0), **nonzero)

    # ``--only=2,8,13,...,26``: after the build, run only those of phases
    # 8 and 13-26 (2: phase 2's mixtral, non-causal and
    # head-dim 80/256 flash rows alone; a short call while working on
    # them); prints no kernels or ok line
    only = [a.split("=", 1)[1] for a in sys.argv[1:]
            if a.startswith("--only=")]
    if only:
        picked = set(only[0].split(","))
        record = {}
        if "2" in picked:
            t0 = time.perf_counter()
            gen = torch.Generator(device="cuda").manual_seed(0)
            rows = (check_flash(*MIX_FLASH, torch.bfloat16, gen)
                    + check_flash(*MIX_FLASH, torch.float32, gen,
                                  timed_run=False)
                    + noncausal_flash_rows(gen) + head_dim_flash_rows(gen))
            for r in rows:
                log_flash_row(r)
            for r in rows:
                assert r["bitwise"] and r["err_over_limit"] <= 1.0, r
            record["flash_mixtral_noncausal"] = rows
            phase_done("phase 2 (mixtral and non-causal rows)", t0)
        if "8" in picked:
            t0 = time.perf_counter()
            record["zamba2"] = hybrid_phase(drive, expect, 4, 4, 4096)
            phase_done("phase 8", t0)
        if "13" in picked:
            t0 = time.perf_counter()
            record["cnn"] = cnn_phase(drive, expect)
            phase_done("phase 13", t0)
        if "14" in picked:
            t0 = time.perf_counter()
            record["scenarios"] = scenario_phase(drive, expect)
            phase_done("phase 14", t0)
        if "15" in picked:
            t0 = time.perf_counter()
            record["decentralized"] = decentralized_phase(drive, expect)
            phase_done("phase 15", t0)
        if "16" in picked:
            t0 = time.perf_counter()
            record["serve"] = serve_phase(drive, expect)
            phase_done("phase 16", t0)
        if "17" in picked:
            t0 = time.perf_counter()
            record["mixtral"] = mixtral_phase(drive, expect)
            phase_done("phase 17", t0)
        if "18" in picked:
            t0 = time.perf_counter()
            record["xlstm"] = xlstm_phase(drive, expect)
            phase_done("phase 18", t0)
        if "19" in picked:
            t0 = time.perf_counter()
            record["encdec_vlm"] = encdec_vlm_phase(drive, expect)
            phase_done("phase 19", t0)
        if "20" in picked:
            t0 = time.perf_counter()
            record["cli"] = cli_phase(drive, expect)
            phase_done("phase 20", t0)
        if "21" in picked:
            t0 = time.perf_counter()
            from repro_torch.configs import get_config
            n_params = get_config("qwen1.5-0.5b").n_params()
            record["dist"] = dist_phase(
                drive, expect, launches, {},
                -(-(-(-n_params // 128)) // 256) * 256, strict=False)
            phase_done("phase 21", t0)
        if "22" in picked:
            t0 = time.perf_counter()
            record["mesh"] = mesh_phase(launches)
            phase_done("phase 22", t0)
        if "23" in picked:
            t0 = time.perf_counter()
            record["tp"] = tp_phase(launches)
            phase_done("phase 23", t0)
        if "24" in picked:
            t0 = time.perf_counter()
            record["tp_families"] = tp24_phase(launches)
            phase_done("phase 24", t0)
        if "25" in picked:
            t0 = time.perf_counter()
            record["tp_zoo"] = tp25_phase(launches)
            phase_done("phase 25", t0)
        if "26" in picked:
            t0 = time.perf_counter()
            record["tp_serve"] = tp26_phase(launches)
            phase_done("phase 26", t0)
        log(json.dumps({"partial": record, "launches": launches,
                        "phase_s": phase_s}))
        log(card_line())
        return 0

    # phase 9's CPU side runs beside phases 2-8
    z9_cpu = start_z9_cpu()

    # -- 2. kernels against their plain versions ---------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    from repro_torch.configs import get_config
    n_params = get_config("qwen1.5-0.5b").n_params()   # 463,987,712
    big_rows = -(-(-(-n_params // 128)) // 256) * 256
    results = {"dual_update": [], "slot_rotate": [], "variable_pop": [],
               "ring_rotate": []}
    for rows in (256, big_rows):
        results["dual_update"].append(check_dual_update(rows, gen))
        torch.cuda.empty_cache()
    for pods, rows in ((1, 256), (1, big_rows), (2, big_rows)):
        results["slot_rotate"].append(check_rotate(pods, rows, gen))
        torch.cuda.empty_cache()
    # the first entry of each list is the one the kernels line leads with:
    # the main path's shape (f32 where a library call computes the same)
    for int8, pods, rows in ((False, 1, 256), (True, 1, 256),
                             (False, 1, big_rows), (True, 1, big_rows),
                             (True, 2, big_rows)):
        for n_due in ((1, 0, 2) if rows == 256 and not int8 else (0, 1, 2)):
            results["variable_pop"].append(
                check_variable_pop(int8, pods, rows, n_due, gen))
            torch.cuda.empty_cache()
    for int8, pods, rows in ((False, 1, 256), (True, 1, 256),
                             (False, 1, big_rows), (True, 1, big_rows),
                             (True, 2, big_rows)):
        results["ring_rotate"].append(check_ring_rotate(int8, pods, rows,
                                                        gen))
        torch.cuda.empty_cache()
    log(f"phase 2: the ring and update rows in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rs in results.items():
        for r in rs:
            form = ("" if "int8" not in r else
                    (" int8" if r["int8"] else " f32")
                    + (f" due={r['due']}/{r['slots']}" if "due" in r else ""))
            lib = ("" if r.get("library_ms") is None else
                   f" library_ms={r['library_ms']:.5f}")
            log(f"phase 2: {name}{form} P={r['pods']} rows={r['rows']}: "
                f"bitwise={r['bitwise']} ms={r['ms']:.5f} plain_ms="
                f"{r['plain_ms']:.5f} bound_ms={r['bound_ms']:.5f}{lib} "
                f"wrapper_ms={r['wrapper_ms']:.5f} plain_wrapper_ms="
                f"{r['plain_wrapper_ms']:.5f} (profiler: kernel "
                f"launches {sum(r['kernels'].values())} over {N_TIMED} "
                f"calls, plain version "
                f"{sum(r['plain_kernels'].values())} kernels over "
                f"{N_PLAIN_TIMED} calls)")
            assert r["bitwise"] and r["max_abs_err"] == 0.0, (name, r)
    t_part = time.perf_counter()
    flash = collections.defaultdict(list)   # kind -> results, lead first
    for shape in FLASH_SHAPES:
        for r in check_flash(*shape, torch.bfloat16, gen):
            flash[r["kernel"]].append(r)
    for shape in FLASH_BF16_EDGES:
        for r in check_flash(*shape, torch.bfloat16, gen, timed_run=False):
            flash[r["kernel"]].append(r)
    for shape in FLASH_F32:
        for r in check_flash(*shape, torch.float32, gen, timed_run=False):
            flash[r["kernel"]].append(r)
    for r in noncausal_flash_rows(gen) + head_dim_flash_rows(gen):
        flash[r["kernel"]].append(r)
    for rs in flash.values():
        for r in rs:
            log_flash_row(r)
    for kind, rs in flash.items():       # every reading logged first
        for r in rs:
            assert r["bitwise"] and r["err_over_limit"] <= 1.0, (kind, r)
    log(f"phase 2: the flash rows in {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()
    scan = check_scan_rows(gen)   # the main path's forward leads
    for r in scan:
        log_scan_row("phase 2", r)
    results["dual_update_pytree"] = [check_dual_update_pytree(rows, gen)
                                     for rows in (256, big_rows)]
    for r in results["dual_update_pytree"]:
        log(f"phase 2: dual_update_pytree rows={r['rows']}: bitwise="
            f"{r['bitwise']} ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
            f"bound_ms={r['bound_ms']:.5f} wrapper_ms={r['wrapper_ms']:.5f} "
            f"pytree_ms={r['pytree_ms']:.5f}")
    log(f"phase 2: the scan and pytree rows in "
        f"{time.perf_counter() - t_part:.1f} s")
    for r in scan:
        assert r["bitwise"] and r["err_over_limit"] <= 1.0, r
    for r in results["dual_update_pytree"]:
        assert r["bitwise"] and r["max_abs_err"] == 0.0, r
    phase_done("phase 2", t0)

    # -- 3. the main path: fixed tau ----------------------------------------
    t0 = time.perf_counter()
    # phase 25's references and xLSTM ranks run beside phases 3-7
    tp25_stages = TP24Stages(TP25_STAGES)
    tp25_stages.go(0)
    tau = 4
    radius = main_path_config()[1]("none").ambdg.radius_C
    main = {}
    for compression in ("int8", "none"):
        ((gpu, secs), kernels), n = drive(lambda: profiled(
            lambda: run_main_path(compression, "cuda")))
        want = expect(dual_update=MAIN_STEPS,
                      slot_rotate=MAIN_STEPS if compression == "int8" else 0)
        assert n == want, (compression, n, want)
        if not kernels:
            gpu, secs, kernels = split_run(compression)
        cpu, cpu_secs = run_main_path(compression, "cpu")
        diff, tol = compare_devices(compression, gpu, cpu,
                                    [t >= tau for t in range(MAIN_STEPS)],
                                    radius)
        main[compression] = dict(
            gpu_s=secs, cpu_s=cpu_secs, w_max_diff=diff, w_tol=tol,
            loss_first=gpu["history"][0]["loss"],
            loss_last=gpu["history"][-1]["loss"],
            launches=n, split=step_split(gpu, kernels))
        log(f"phase 3: {compression}: {MAIN_STEPS} steps on cuda in "
            f"{secs:.2f} s, on cpu in {cpu_secs:.2f} s; launches "
            f"{main[compression]['launches']}; loss "
            f"{main[compression]['loss_first']:.4f} -> "
            f"{main[compression]['loss_last']:.4f}; max |w_gpu - w_cpu| "
            f"= {diff:.3e} <= {tol:.3e}")
        log(f"phase 3: {compression}: step split "
            f"{json.dumps(main[compression]['split'])}")
    phase_done("phase 3", t0)

    # -- 4. the stochastic-delay path ---------------------------------------
    t0 = time.perf_counter()
    delays, arrived = arrivals(STOCHASTIC_DELAY, tau)
    assert {0, 1, 2} <= set(arrived), (delays, arrived)
    log(f"phase 4: delays {delays}, arrivals per step {arrived}")
    stochastic = {}
    for compression in ("int8", "none"):
        ((gpu, secs), kernels), n = drive(lambda: profiled(
            lambda: run_main_path(compression, "cuda",
                                  delay=STOCHASTIC_DELAY)))
        want = expect(dual_update=MAIN_STEPS, variable_pop=MAIN_STEPS)
        assert n == want, (compression, n, want)
        if not kernels:
            gpu, secs, kernels = split_run(compression, STOCHASTIC_DELAY)
        cpu, cpu_secs = run_main_path(compression, "cpu",
                                      delay=STOCHASTIC_DELAY)
        diff, tol = compare_devices(compression, gpu, cpu, arrived, radius,
                                    tau_max=STOCHASTIC_DELAY["tau_max"])
        no_sync = master_update_without_sync(gpu, compression)
        stochastic[compression] = dict(
            gpu_s=secs, cpu_s=cpu_secs, w_max_diff=diff, w_tol=tol,
            loss=[h["loss"] for h in gpu["history"]],
            applied_count=[h["applied_count"] for h in gpu["history"]],
            tau_applied=[h["tau_applied"] for h in gpu["history"]],
            launches=n, master_update_without_sync=no_sync,
            split=step_split(gpu, kernels))
        log(f"phase 4: {compression}: {MAIN_STEPS} steps on cuda in "
            f"{secs:.2f} s, on cpu in {cpu_secs:.2f} s; launches {n}; "
            f"applied_count {stochastic[compression]['applied_count']}; "
            f"tau_applied {stochastic[compression]['tau_applied']}; loss "
            f"{[round(x, 2) for x in stochastic[compression]['loss']]}; "
            f"max |w_gpu - "
            f"w_cpu| = {diff:.3e} <= {tol:.3e}; master update with no "
            f"host sync: {no_sync}")
        log(f"phase 4: {compression}: step split "
            f"{json.dumps(stochastic[compression]['split'])}")
    phase_done("phase 4", t0)

    # -- 5. the v1 ring -----------------------------------------------------
    t0 = time.perf_counter()
    v1 = {}
    for compression in ("int8", "none"):
        steps, n = drive(lambda: v1_phase(compression, "cuda"))
        want = expect(ring_rotate=steps,
                      slot_rotate=steps if compression == "int8" else 0)
        assert n == want, (compression, n, want)
        v1[compression] = dict(steps=steps, launches=n)
        log(f"phase 5: v1 {compression}: {steps} steps, pops equal to v2 "
            f"bit for bit; launches {n}")
    phase_done("phase 5", t0)

    # -- 6. the LM slice at full width: qwen1.5-0.5b, 8 layers, 4096 --------
    t0 = time.perf_counter()
    lm = {}
    n_mb, n_workers, seq = 4, 4, 4096
    n_layers = lm_config("flash").n_layers
    # at the init weights (the training runs' own, from the run's seed):
    # the worker's gradient on one microbatch and a no-grad eval, flash
    # against xla, in f32 and in bf16 compute, on a fresh batch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.api import build_model
    rc0 = lm_run_config(lm_config("flash"), seq, 2 * n_workers, n_mb)
    params0 = build_model(lm_config("flash"), device="cuda").init(
        torch.Generator().manual_seed(rc0.seed))
    host = TokenStream(lm_config("flash"), seed=1).next_batch(2, seq)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in host.items()}
    names = leaf_names(params0)
    grads = {}
    for impl in ("xla", "flash"):
        for dt in ("float32", "bfloat16"):
            grads[impl, dt] = model_grads(lm_config(impl, compute_dtype=dt),
                                       params0, batch)
            torch.cuda.empty_cache()
    ref32 = grads["xla", "float32"][0]
    f32_gap = leaf_gaps(grads["flash", "float32"][0], ref32, names)
    bf16_flash = leaf_gaps(grads["flash", "bfloat16"][0], ref32, names)
    bf16_xla = leaf_gaps(grads["xla", "bfloat16"][0], ref32, names)
    bf16_gap = leaf_gaps(grads["flash", "bfloat16"][0],
                         grads["xla", "bfloat16"][0], names)
    losses0 = {f"{i}_{d}": grads[i, d][1] for i, d in grads}
    del grads, ref32
    torch.cuda.empty_cache()
    ev0 = {}
    ev0["flash_bfloat16"], n_ev0 = drive(lambda: lm_eval(
        lm_config("flash"), params0, batch))
    for impl in ("xla", "flash"):
        for dt in ("float32", "bfloat16"):
            if (impl, dt) != ("flash", "bfloat16"):
                ev0[f"{impl}_{dt}"] = lm_eval(
                    lm_config(impl, compute_dtype=dt), params0, batch)
    del params0
    torch.cuda.empty_cache()
    lm["init_weights"] = dict(
        leaves=names, grad_f32_flash_vs_xla=f32_gap,
        grad_bf16_flash_vs_f32=bf16_flash, grad_bf16_xla_vs_f32=bf16_xla,
        grad_bf16_flash_vs_xla=bf16_gap, loss=losses0, eval=ev0,
        eval_launches=n_ev0)
    for i, name in enumerate(names):
        log(f"phase 6: init weights, gradient {name}: f32 flash vs xla "
            f"{f32_gap[i]:.3e}; bf16 vs the f32 xla gradient: flash "
            f"{bf16_flash[i]:.3e}, xla {bf16_xla[i]:.3e}; bf16 flash vs "
            f"xla {bf16_gap[i]:.3e} (of the leaf's largest element)")
    log(f"phase 6: init weights, loss per token of the gradient batch "
        f"{json.dumps(losses0)}; no-grad eval {json.dumps(ev0)}; eval "
        f"launches {n_ev0}")
    assert n_ev0 == expect(flash_fwd=n_layers), n_ev0
    for i, name in enumerate(names):
        assert f32_gap[i] <= LM_F32_GRAD_TOL, (name, f32_gap[i])
        assert bf16_flash[i] <= LM_BF16_GRAD_RATIO * bf16_xla[i], (
            name, bf16_flash[i], bf16_xla[i])
    for a, b, rtol in (("flash_float32", "xla_float32", LM_F32_RTOL),
                       ("flash_bfloat16", "xla_bfloat16", LM_BF16_RTOL)):
        assert math.isclose(ev0[a], ev0[b], rel_tol=rtol), (a, b, ev0)
        assert math.isclose(losses0[a], losses0[b], rel_tol=rtol), (
            a, b, losses0)
    runs = {}
    for impl in ("flash", "xla"):
        cfg = lm_config(impl)
        rc = lm_run_config(cfg, seq, 2 * n_workers, n_mb)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ((out, secs), kernels), n = drive(lambda: profiled(
            lambda: run_lm(cfg, rc, LM_STEPS, n_workers, "cuda")))
        if impl == "flash":
            per_step = n_layers * n_mb
            assert n["flash_bwd_dq"] == per_step * LM_STEPS, n
            assert n["flash_bwd_dkv"] == per_step * LM_STEPS, n
            # the forward and its recomputation under block_remat="full"
            assert n["flash_fwd_lse"] == 2 * per_step * LM_STEPS, n
            assert n == expect(dual_update=LM_STEPS, slot_rotate=LM_STEPS,
                               flash_fwd_lse=n["flash_fwd_lse"],
                               flash_bwd_dq=n["flash_bwd_dq"],
                               flash_bwd_dkv=n["flash_bwd_dkv"]), n
            for _ in range(PROFILER_TRIES - 1):
                if kernels:
                    break
                log("note: the LM step split comes from another run of the "
                    "same seed")
                (out, secs), kernels = profiled(
                    lambda: run_lm(cfg, rc, LM_STEPS, n_workers, "cuda"))
            assert kernels, "torch.profiler recorded no device time"
        else:
            assert n == expect(dual_update=LM_STEPS,
                               slot_rotate=LM_STEPS), n
            if not kernels:
                log("note: no step split for the xla run (the profiler "
                    "recorded nothing)")
        peak = torch.cuda.max_memory_allocated()
        norm = lm_weights_ok(out["state"].params)
        hist = out["history"]
        runs[impl] = dict(params=out["state"].params, history=hist)
        lm[impl] = dict(
            seconds=secs, launches=n, peak_gib=peak / 2 ** 30,
            w_norm=norm, loss=[h["loss"] for h in hist],
            applied_count=[h["applied_count"] for h in hist],
            split=step_split(out, kernels) if kernels else None,
            kernel_split=kernel_split(kernels, LM_STEPS) if kernels
            else None)
        del out
        log(f"phase 6: qwen1.5-0.5b attn_impl={impl}: {LM_STEPS} steps in "
            f"{secs:.2f} s; loss {lm[impl]['loss']}; applied_count "
            f"{lm[impl]['applied_count']}; |w| = {norm:.4f}; peak "
            f"{lm[impl]['peak_gib']:.2f} GiB; launches {n}")
        if kernels:
            log(f"phase 6: {impl}: step split "
                f"{json.dumps(lm[impl]['split'])}")
            log_kernel_split("phase 6", impl, lm[impl]["kernel_split"])
    hf, hx = runs["flash"]["history"], runs["xla"]["history"]
    for t, (a, b) in enumerate(zip(hf, hx)):
        assert a["applied_count"] == b["applied_count"], (t, a, b)
        assert (a["applied_count"] == 0.0) == (t < 2), (t, a)
        assert a["local_count"] == 2 * n_workers * (seq - 1), (t, a)
        assert math.isfinite(a["loss"]), (t, a)
        assert math.isclose(a["loss"], b["loss"], rel_tol=LM_BF16_RTOL), (
            t, a["loss"], b["loss"])
    # a no-grad evaluation at the flash run's final weights, on the
    # batch the init-weight checks used
    ev_flash, n = drive(lambda: lm_eval(lm_config("flash"),
                                        runs["flash"]["params"], batch))
    assert n == expect(flash_fwd=n_layers), n
    ev_xla = lm_eval(lm_config("xla"), runs["flash"]["params"], batch)
    ev_xla_own = lm_eval(lm_config("xla"), runs["xla"]["params"], batch)
    assert math.isclose(ev_flash, ev_xla, rel_tol=LM_BF16_RTOL), (
        ev_flash, ev_xla)
    assert math.isclose(ev_flash, ev_xla_own, rel_tol=LM_BF16_RTOL), (
        ev_flash, ev_xla_own)
    lm["eval"] = dict(flash=ev_flash, xla_same_weights=ev_xla,
                      xla_own_weights=ev_xla_own, launches=n)
    log(f"phase 6: no-grad eval loss/token {ev_flash:.6f} (flash), "
        f"{ev_xla:.6f} (xla, same weights), {ev_xla_own:.6f} (xla run's "
        f"weights); launches {n}")
    del runs, batch
    torch.cuda.empty_cache()
    phase_done("phase 6", t0)

    # -- 7. full width, 2 layers: the card against the CPU -------------------
    t0 = time.perf_counter()
    cfg7 = lm_config("flash", n_layers=2, compute_dtype="float32")
    rc7 = lm_run_config(cfg7, 256, 2, 1)   # the CPU run sets the time
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    # the worker's gradient at the init weights, the card's flash kernels
    # against the CPU's plain version, leaf by leaf
    params7 = build_model(cfg7, device="cpu").init(
        torch.Generator().manual_seed(rc7.seed))
    host7 = TokenStream(cfg7, seed=1).next_batch(2, 256)
    batch7 = {k: torch.from_numpy(v) for k, v in host7.items()}
    g7_cpu, loss7_cpu = model_grads(cfg7, params7, batch7)
    leaves7, def7 = tree_flatten(params7)
    g7_gpu, loss7_gpu = model_grads(
        cfg7, tree_unflatten(def7, [x.cuda() for x in leaves7]),
        {k: v.cuda() for k, v in batch7.items()})
    names7 = leaf_names(params7)
    gap7 = leaf_gaps(g7_gpu, g7_cpu, names7)
    log(f"phase 7: init weights, gradient card (flash) vs cpu (plain), "
        f"of each leaf's largest element: "
        f"{json.dumps(dict(zip(names7, gap7)))}; loss per "
        f"token {loss7_gpu} (card), {loss7_cpu} (cpu)")
    assert all(g <= LM_DEVICE_GRAD_TOL for g in gap7), gap7
    assert math.isclose(loss7_gpu, loss7_cpu, rel_tol=LM_F32_RTOL), (
        loss7_gpu, loss7_cpu)
    del g7_cpu, g7_gpu, params7, leaves7
    (gpu7, secs7), n = drive(lambda: run_lm(cfg7, rc7, 3, 2, "cuda", 1))
    assert n == expect(dual_update=3, slot_rotate=3,
                       flash_fwd_lse=2 * 2 * 1 * 3, flash_bwd_dq=2 * 1 * 3,
                       flash_bwd_dkv=2 * 1 * 3), n
    cpu7, cpu_secs7 = run_lm(cfg7, rc7, 3, 2, "cpu", 1)
    diff7, tol7 = compare_lm_devices(gpu7, cpu7)
    lm["two_layers"] = dict(gpu_s=secs7, cpu_s=cpu_secs7, launches=n,
                            init_grad_gap=gap7,
                            loss=[h["loss"] for h in gpu7["history"]],
                            w_max_diff=diff7, w_tol=tol7)
    log(f"phase 7: qwen1.5-0.5b 2 layers f32, 3 steps on cuda in "
        f"{secs7:.2f} s, on cpu in {cpu_secs7:.2f} s; loss "
        f"{lm['two_layers']['loss']}; max |w_gpu - w_cpu| = {diff7:.3e} "
        f"<= {tol7:.3e}; launches {n}")
    del gpu7, cpu7
    phase_done("phase 7", t0)

    # -- 8. the hybrid slice at full width: zamba2, 6 layers, 4096 ----------
    t0 = time.perf_counter()
    tp25_stages.finish(0)
    lm["zamba2"] = hybrid_phase(drive, expect, n_mb, n_workers, seq)
    phase_done("phase 8", t0)

    # -- 9. zamba2 at full width, one group of 6 layers: card against CPU ----
    t0 = time.perf_counter()
    # phase 24's zamba2 processes run beside phase 9, its mixtral reference
    # beside phases 10-14 (their card memory is small)
    torch.cuda.empty_cache()
    tp24_stages = TP24Stages()
    tp24_stages.go(0)
    sim_bg = start_sim_paper()      # phase 10b's schemes, beside 9-10a
    lm["zamba2_6_layers"] = hybrid_device_phase(drive, expect, z9_cpu)
    phase_done("phase 9", t0)
    tp24_stages.advance(1)

    # -- 10. the cluster simulator on the card ------------------------------
    t0 = time.perf_counter()
    # the simulator's errors are held at rtol 1e-4 to the golden traces:
    # its f32 products run without TF32, whatever an earlier phase set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    simulator = {}
    simulator["golden"], n = drive(sim_golden_phase)
    assert n == expect(), n       # the pytree master launches no kernel
    for label, (updates, rel) in simulator["golden"].items():
        log(f"phase 10: golden {label}: {updates} updates, exact columns "
            f"equal, errors within rtol {rel:.3e} <= 1e-4")
    simulator["paper"] = sim_paper_phase(sim_bg)
    for name, r in simulator["paper"].items():
        log(f"phase 10: Sec. VI-A d=10^4 {name}: {json.dumps(r)}")
    phase_done("phase 10", t0)
    tp24_stages.advance(1)

    # -- 11. the pytree master against the arena master ---------------------
    t0 = time.perf_counter()
    masters = master_phase(drive, expect)
    for label, r in masters.items():
        log(f"phase 11: {label}: {json.dumps(r)}")
    phase_done("phase 11", t0)
    tp24_stages.advance(1)

    # -- 12. the K-batch strategy's device step -----------------------------
    t0 = time.perf_counter()
    kbatch = kbatch_phase(drive, expect)
    log(f"phase 12: kbatch: {json.dumps(kbatch)}")
    phase_done("phase 12", t0)

    # -- 13. the CNN at full width, Fig. 5 ----------------------------------
    t0 = time.perf_counter()
    cnn = cnn_phase(drive, expect)
    phase_done("phase 13", t0)
    tp24_stages.advance(1)

    # -- 14. batch schedules, elastic workers, checkpoint/restart -----------
    t0 = time.perf_counter()
    tp25_stages.spawn(1)       # phase 25's seamless ranks ready themselves
    scenarios = scenario_phase(drive, expect)
    phase_done("phase 14", t0)

    # -- 15. the decentralized gossip ---------------------------------------
    t0 = time.perf_counter()
    tp24_stages.finish(1)
    # phase 25's seamless ranks run beside phase 15, its paligemma ranks
    # beside 16
    torch.cuda.empty_cache()
    tp25_stages.go(1)
    tp25_stages.spawn(2)
    decentralized = decentralized_phase(drive, expect)
    phase_done("phase 15", t0)

    # -- 16. train-while-serve ----------------------------------------------
    t0 = time.perf_counter()
    tp25_stages.finish(1)
    tp25_stages.go(2)
    serve = serve_phase(drive, expect)
    phase_done("phase 16", t0)

    # -- 17. the MoE slice: mixtral ------------------------------------------
    t0 = time.perf_counter()
    tp25_stages.finish(2)
    torch.cuda.empty_cache()
    # phase 26's processes ready themselves beside phase 17 and run beside
    # phases 18 and on
    tp26_stages = TP24Stages(TP26_STAGES, flag="--tp26")
    tp26_stages.spawn(0)
    mixtral = mixtral_phase(drive, expect)
    phase_done("phase 17", t0)

    # -- 18. the xLSTM slice --------------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    tp26_stages.go(0)
    xlstm = xlstm_phase(drive, expect)
    phase_done("phase 18", t0)

    # -- 19. the encoder-decoder and the VLM --------------------------------
    t0 = time.perf_counter()
    encdec_vlm = encdec_vlm_phase(drive, expect)
    phase_done("phase 19", t0)

    # -- 20. the launchers on the card --------------------------------------
    t0 = time.perf_counter()
    # phase 2's kernel alone at qwen's arena, one pod (2 due slots)
    phase2 = {
        "dual_update": results["dual_update"][1],
        "slot_rotate": results["slot_rotate"][1],
        "variable_pop_f32": next(
            r for r in results["variable_pop"] if not r["int8"]
            and r["pods"] == 1 and r["rows"] == big_rows and r["due"] == 2),
        "variable_pop_int8": next(
            r for r in results["variable_pop"] if r["int8"]
            and r["pods"] == 1 and r["rows"] == big_rows and r["due"] == 2)}
    # phases 21b's and 22's processes start now: their start overlaps
    # phase 20
    dist_bg = start_dist_background()
    mesh_bg = start_mesh_background()
    try:
        cli = cli_phase(drive, expect)
    except BaseException:
        stop_dist_background(dist_bg)
        stop_mesh_background(mesh_bg)
        raise
    phase_done("phase 20", t0)

    # -- 21. the pod axis across processes ----------------------------------
    t0 = time.perf_counter()
    try:
        dist = dist_phase(drive, expect, launches, phase2, big_rows,
                          bg=dist_bg)
    except BaseException:
        stop_mesh_background(mesh_bg)
        raise
    phase_done("phase 21", t0)

    # -- 22. the LMs on the mesh, the per-rank gossip -----------------------
    # phase 23's processes start once 22a's have ended: beside them (and
    # phase 20) the card's 80 GB ran out; this process's cached blocks
    # go back to the card first
    t0 = time.perf_counter()
    tp_bg = []

    def start_tp():
        torch.cuda.empty_cache()
        tp_bg.append(start_tp_background())
    try:
        mesh = mesh_phase(launches, bg=mesh_bg, after_lm=start_tp)
    except BaseException:
        for bg in tp_bg:
            stop_mesh_background(bg)
        raise
    phase_done("phase 22", t0)

    # -- 23. tensor parallelism over 'model' --------------------------------
    t0 = time.perf_counter()
    tp24_stages.spawn(2)     # phase 24's mixtral ranks ready themselves
    tp = tp_phase(launches, bg=tp_bg[0])
    phase_done("phase 23", t0)

    # -- 24. tensor parallelism for the MoE and the hybrid ------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"phase 24: the card's memory free before the mixtral ranks run: "
        f"{free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB (this process "
        f"reserves {torch.cuda.memory_reserved() / 2 ** 30:.2f})")
    tp_families = tp24_phase(launches, tp24_stages)
    phase_done("phase 24", t0)

    # -- 25. tensor parallelism for the encoder-decoder, VLM, xLSTM ---------
    t0 = time.perf_counter()
    tp_zoo = tp25_phase(launches, tp25_stages)
    phase_done("phase 25", t0)

    # -- 26. serving over 'model' ------------------------------------------
    t0 = time.perf_counter()
    tp_serve = tp26_phase(launches, tp26_stages)
    phase_done("phase 26", t0)
    log(json.dumps({"main_path": main, "stochastic_path": stochastic,
                    "v1": v1, "lm": lm, "simulator": simulator,
                    "masters": masters, "kbatch": kbatch, "cnn": cnn,
                    "scenarios": scenarios, "decentralized": decentralized,
                    "serve": serve, "mixtral": mixtral, "xlstm": xlstm,
                    "encdec_vlm": encdec_vlm, "cli": cli, "dist": dist,
                    "mesh": mesh, "tp": tp, "tp_families": tp_families,
                    "tp_zoo": tp_zoo, "tp_serve": tp_serve,
                    "phase_s": phase_s,
                    "total_s": time.perf_counter() - t_script}))

    def entry(name, source, replaces, rs, n_launch):
        lead = rs[0]
        keys = ("int8", "due", "slots", "tau", "pods", "rows", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms",
                "wrapper_ms", "plain_wrapper_ms", "max_abs_err")
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launch,
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": lead["ms"], "plain_ms": lead["plain_ms"],
            "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
            "library_ms": lead.get("library_ms"),
            "wrapper_ms": lead["wrapper_ms"],
            "plain_wrapper_ms": lead["plain_wrapper_ms"],
            "shape": {k: lead[k] for k in keys[:6] if k in lead},
            "other_shapes": [{k: r[k] for k in keys if k in r}
                             for r in rs[1:]],
        }

    def flash_entry(name, replaces, rs, n_launch, library):
        lead = rs[0]
        keys = ("kernel", "label", "dtype", "B", "Hq", "Hkv", "Sq", "Skv",
                "D", "window", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_fwd_bwd_ms", "wrapper_ms",
                "max_abs_err", "rel_err", "err_over_limit", "causal")
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": replaces, "launches": n_launch,
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": lead["ms"], "plain_ms": lead["plain_ms"],
            "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
            "library_ms": lead["library_ms"], "library": library,
            "library_fwd_bwd_ms": lead["library_fwd_bwd_ms"],
            "wrapper_ms": lead["wrapper_ms"],
            "plain_wrapper_ms": lead["plain_wrapper_ms"],
            "shape": {k: lead[k] for k in keys[:10]},
            "other_shapes": [{k: r[k] for k in keys if k in r}
                             for r in rs[1:]],
        }

    def scan_entry(rs, n_fwd, n_bwd):
        lead = rs[0]
        keys = ("kernel", "label", "BH", "BHG", "S", "ds", "hd", "chunk",
                "strict", "with_inter", "qk_dtype", "v_dtype", "ms",
                "plain_ms", "bound_ms", "bound_by", "wrapper_ms",
                "max_abs_err", "rel_err", "err_over_limit")
        return {
            "name": "linear_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
            "replaces": "src/repro/kernels/linear_scan/kernel.py:68",
            "launches": n_fwd + n_bwd, "launches_fwd": n_fwd,
            "launches_bwd": n_bwd,
            "kernels_per_call": lead["kernels_per_call"],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": lead["ms"], "plain_ms": lead["plain_ms"],
            "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
            "library_ms": None, "wrapper_ms": lead["wrapper_ms"],
            "plain_wrapper_ms": lead["plain_wrapper_ms"],
            "shape": {k: lead[k] for k in keys[:12]},
            "other_shapes": [{k: r[k] for k in keys if k in r}
                             for r in rs[1:]],
        }

    ring_py = "src/repro/kernels/delay_ring/kernel.py"
    fa_py = "src/repro/kernels/flash_attention"
    sdpa = "torch.nn.functional.scaled_dot_product_attention"
    log(json.dumps({"kernels": [
        entry("dual_update", "src/repro_torch/kernels/csrc/dual_update.cu",
              "src/repro/kernels/dual_update/kernel.py:38",
              results["dual_update"], launches["dual_update"]),
        entry("slot_rotate", "src/repro_torch/kernels/csrc/delay_ring.cu",
              f"{ring_py}:77", results["slot_rotate"],
              launches["slot_rotate"]),
        entry("variable_pop", "src/repro_torch/kernels/csrc/variable_pop.cu",
              f"{ring_py}:159", results["variable_pop"],
              launches["variable_pop"]),
        entry("ring_rotate", "src/repro_torch/kernels/csrc/delay_ring.cu",
              f"{ring_py}:231", results["ring_rotate"],
              launches["ring_rotate"]),
        # the training forward (with lse) leads; the forward without lse
        # is the same templated kernel
        flash_entry("flash_fwd", f"{fa_py}/kernel.py:79 and "
                    f"{fa_py}/bwd.py:82",
                    flash["fwd_lse"][:1] + flash["fwd"] + flash["fwd_lse"][1:],
                    launches["flash_fwd"] + launches["flash_fwd_lse"],
                    f"{sdpa} forward"),
        flash_entry("flash_bwd_dq", f"{fa_py}/bwd.py:199 (_dq_kernel)",
                    flash["dq"], launches["flash_bwd_dq"],
                    f"{sdpa} backward (dq, dk and dv in one call)"),
        flash_entry("flash_bwd_dkv", f"{fa_py}/bwd.py:199 (_dkv_kernel)",
                    flash["dkv"], launches["flash_bwd_dkv"],
                    f"{sdpa} backward (dq, dk and dv in one call)"),
        scan_entry(scan, launches["linear_scan_fwd"],
                   launches["linear_scan_bwd"]),
        entry("dual_update_pytree",
              "src/repro_torch/kernels/csrc/dual_update.cu",
              "src/repro/kernels/dual_update/kernel.py:73",
              results["dual_update_pytree"], launches["dual_update_pytree"]),
    ]}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
