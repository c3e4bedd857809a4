#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``).  It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc``, then:

1. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the main path, and times kernel, plain version and (for the
   stencil) one PyTorch library call with CUDA events, in turns plain,
   kernel, kernel, plain;
2. runs the Mandelbrot farm (4096 x 2048, 64 bands of 32 rows, 1000
   iterations) sequentially, fused and streaming, which must agree exactly;
3. runs the image pipeline (16 RGB 2048 x 2048 images, grey then EDGE5) in
   the three modes, which must agree exactly;
4. solves 4 Jacobi systems of n = 4096 on the MultiCoreEngine (4 nodes,
   tol 1e-6), which must land within 1e-3 of the true solutions;
5. model-checks the Monte-Carlo pi farm with ``csp.check``, then estimates pi
   from 256 x 10^6 points in the three modes, which must agree exactly, and
   prints a logged run's netlog report;
12. (run here, after phase 5) drives the cluster runtime on the card: one
   warm ``ClusterDeployment`` of the farm at phase 2's width each over 2
   and 4 thread hosts whose tensors stay on the card (``device``, 3
   batches each) and over 2 spawned host processes (``pipe``, and ``shm``
   with 8 MiB slots, 2 batches each), then the image pipeline at phase 3's
   size cut between its two engines over ``device`` (3 batches), ``pipe``
   (one cold batch) and ``shm`` (2 batches, at the largest
   microbatch up to 16 whose ring fits in the free ``/dev/shm``, which it
   prints): the partition must refine the network (CSP, both directions),
   every batch must equal phases 2 and 3 exactly, thread hosts must launch
   the kernel here once a band (64 ``mandelbrot``, 16 ``stencil`` a
   batch), each spawned host checks inside its own process that every
   band launched its own Mandelbrot kernel once and is a CUDA tensor, and
   over ``shm`` every chunk must go through a slot and every segment be
   unlinked after the close.  The farm's process-host deployments
   (``pipe`` and ``shm``) go on past their warm batch: host 1 killed, the
   next batch failing, and ``recover(mode="restart")`` replaying it equal
   to phase 2 at epoch 2 with host 1 restarted.  Then the farm over 4
   ``device`` hosts whose
   worker raises once in batch 1, ``recover(mode="rebalance")`` moving it
   onto a survivor, the new plan refining the network, the replay equal to
   phase 2 and launching here exactly the bands it re-streams.  It prints
   the walls, the bytes crossing the cut a batch, the ring's chunks by
   path, the recovery walls and events, the cluster reports and the
   phase's own wall; every deployment is closed and every host process
   gone before phase 6;
13. (run after phase 7, whose model it serves) durability on the card:
   13a the farm over 2 ``device`` hosts (microbatch 8) with fold snapshots
   every 2 chunks, beside the same deployment without, 5 batches each in
   turns, every batch equal to phase 2 and launching its 64 bands here;
   it prints the snapshot spans (count, median ms, bytes), the controller
   meta's persist spans and the warm walls' ratio (not gated); 13b the
   Collect raising once past its second snapshot, ``recover()`` equal to
   phase 2, the Collect's host replayed from its snapshot's chunk (> 0),
   a ``restore`` event, and exactly the re-streamed bands launched here;
   13c a fresh ``ClusterDeployment.adopt`` of 13a's closed deployment and
   a salvage adopt over a live one, each at epoch 2, refined, its next
   batch equal to phase 2 (the salvaged one building no stage); 13d
   ``python -m repro_torch.launch.cluster`` over 2 ``pipe`` hosts at
   2048², 64 bands, with ``--iters`` for a ~3 s batch, its whole process
   group SIGKILLed once the Collect's host wrote a snapshot, then
   ``--resume-from``: adopted at epoch 2 and refined, the pending batch
   replayed from the snapshot (a nonzero chunk for the Collect's host)
   and one batch more, the oracle equal, kill → adopted and kill → replayed result printed;
   13e qwen2-0.5b served with a store persisting every step, crashed with
   two requests done and two in flight, adopted on a fresh backend: every
   request answered once with the tokens of an uncrashed engine without a
   store; the persist span, its bytes, TPOT with and without the store and
   the adopt wall.  No host process and no new ``/dev/shm`` entry may be
   left; the phase prints its wall;
14. (run after phase 13) the fault-injection simulator on the card, its
   simulated hosts threads of this process on ``cuda``: 14a the
   JAX package's scenario families — ``run_scenario`` for seeds 0-19 but
   5, 7 and 9 (all five fault kinds; those three wait out two 8 s
   ``recv`` timeouts each and run in the CPU tests),
   ``run_kill_controller_scenario`` for each of its five variants,
   ``run_stall_race_scenario`` for seeds 0 and 1,
   ``run_coalesce_kill_scenario`` for seeds 0-5 and
   ``run_pipe_brick_scenario`` over real ``pipe`` host processes, every
   one ``ok`` (each family prints its scenarios, faults fired,
   recoveries, median and max virtual ticks and wall); 14b the Mandelbrot
   farm at phase 2's width over 2 simulated hosts (microbatch 16) under
   ``FaultSchedule.random`` for 4 seeds (a kill, a double kill, a
   controller-step kill and a kill during recovery; restart and rebalance
   in turns): a cold batch, then the schedule armed and 2 batches, each
   recovered as the faults demand, every batch equal to phase 2, every
   recovery refined, the epoch chain refining, no record delivered twice,
   no stage built on an untouched host, the merged trace conforming, and
   at least 64 launches here a batch; it prints the launches, the bands
   launched beyond one a band a batch, the kill -> recovered-result wall
   and what a result's round trip through host bytes costs.  No host
   thread, host process or new ``/dev/shm`` entry may be left; the phase
   prints its wall;
15. (run after phase 14) the cost model and the autoscaler on the card:
   15a ``calibrate`` of the Mandelbrot farm at phase 2's width (microbatch
   16) and of the image pipeline at phase 3's size (microbatch 4) on
   ``cuda``, with the ``device``, ``pipe`` and ``shm`` bandwidths: every
   stage measured, each profile printed, the farm's render stage beside
   16 x phase 1's band and the EDGE5 engine beside 4 x phase 1's EDGE5
   (ratios printed, not gated); then for each network the count cut and
   the cost cut over 2 and 4 ``device`` hosts, 3 batches each, every
   batch equal to phases 2 and 3, each plan refining the network, the
   launches of phase 12, the warm walls side by side and whether the two
   cuts differ; and the count cut hot-swapped to the cost cut through
   ``reconfigure(plan=)``, refined, its next batch equal; 15b ``python -m
   repro_torch.launch.cluster`` over 2 ``device`` hosts at 4096², 64
   bands, 1000 iterations, with ``--cut cost --calibrate --autoscale
   --batches 4``: every batch ``identical=True``, the oracle equal, its
   profile and autoscale events printed; 15c ``run_workload_scenario``
   for seeds 0-5 on ``cuda`` (two spikes, two stragglers, two slow
   starts), every one ``ok``, a spike and a straggler with one epoch bump
   each, a slow start with none. No host thread, host process or new
   ``/dev/shm`` entry may be left; the phase prints its wall;
16. (run after phase 15, on phase 6's weights) the clustered decode farm
   serving full-width qwen2-0.5b with phase 7's 8 requests (4 slots in 2
   shards of 2 rows, max_len 128, prefill chunks of 8): 16a the farm over
   2 ``device`` hosts and over 2 ``pipe`` host processes, whose token
   streams must be identical to each other and to a local engine of 2
   slots (the shards' decode shape) on the same weights (on a difference
   it prints the first differing request and step with the top-2 logit
   margin there), every request joining and leaving once; how many equal
   phase 7's 4-slot run and the one-slot oracle is printed, not gated;
   16b ``scale(3)`` over ``device`` after the first step: ``reconfigure``,
   refined, epoch 2, streams equal 16a; 16c host 1 of 16a's 2 ``pipe``
   hosts killed after step 3 of a second serving of the 8 requests (the
   same deployment, warm): the next step recovers, streams equal 16a, the
   kill → step-done wall printed; 16d a durable farm over ``device``
   closed after 4 steps and adopted by a fresh backend: every request
   answered once, streams equal 16a, the persist spans' bytes printed;
   16e ``python -m repro_torch.cluster.sim --serve-kill 12`` on the card,
   every scenario ok; 16f ``python -m repro_torch.launch.serve --arch
   qwen2-0.5b --hosts 2 --transport device --autoscale``.  For each run
   it prints tok/s, TTFT and TPOT p50/p99, the farm's decode step against
   phase 7's local step and the bytes across the cut a decode step.  No
   kernel may launch in the phase, and no host thread, host process or
   new ``/dev/shm`` entry may be left; the phase prints its wall;
6. runs ``Model.forward`` of the full-width qwen2-0.5b (24 layers, random
   weights from seed 0) on a (4, 2048) batch of seeded tokens: in bf16 (the
   default config) the logits must be finite; in float32 its logits at
   positions 1023 and 1024 must agree within 3e-3 with ``prefill`` of the
   first 1024 tokens and one ``decode_step`` (the reference's
   forward-against-decode gate, which holds the flash-kernel path against
   the KV-cache path); every forward must launch the flash kernel once per
   layer;
7. serves 8 requests through ``python -m repro_torch.launch.serve``'s
   ``main`` (full-width qwen2-0.5b, 4 slots, max_len 128, max_new 16): every
   request must complete with its token count and exactly one join and one
   leave; it prints tokens/s, TTFT and TPOT, and how many requests give the
   same tokens decoded alone in a one-slot engine (printed, not gated);
8. runs ``Model.forward`` of the full-width mamba2-2.7b (64 Mamba2 layers)
   and zamba2-1.2b (38 Mamba2 layers and one shared attention block applied
   6 times) on (4, 2048) seeded tokens, with the checks of phase 6: finite
   bf16 logits, f32 logits against ``prefill`` of 1024 tokens (which runs
   the SSD kernel and hands its final state to the decode recurrence) and
   one ``decode_step`` within 3e-3, and each forward launching the SSD
   kernel once per Mamba2 layer (64; 38) and the flash kernel once per
   shared-block application (0; 6);
9. serves mamba2-2.7b through the launcher's ``main`` as in phase 7.
   Serving launches no kernel: the engine feeds prompts one token a step,
   so every Mamba2 layer takes the O(1) decode recurrence and every
   attention layer the KV-cache einsums, as in the JAX package;
17. (run after phase 9) full-width whisper-tiny (4 encoder and 4 decoder
   layers, d=384, 6/6 heads, vocab 51865; f32 weights from seed 0, 4096
   decoder positions) on 4 utterances of 1500 seeded stub frames (30 s
   windows): a bf16 ``forward`` on (4, 448) tokens with finite logits and
   exactly 12 flash launches (encoder, decoder self- and
   cross-attention); the f32 forward against ``prefill`` of 224 tokens
   and one ``decode_step`` within 3e-3, and against the same forward on
   the CPU (the plain path) within 1e-3; then greedy decoding in bf16
   from whisper's 4-token start-of-transcript prompt, 124 steps, max_len
   448: ``prefill`` launching flash 8 times (encoder and cross-attention)
   and every decode step 4 (cross-attention), with encode and prefill ms,
   the decode step's p50 / p99, tokens/s and the phase's wall printed;
10. frees every earlier model, then runs ``Model.forward`` of the
   full-width deepseek-moe-16b (28 layers, d=2048, 16/16 heads, 64 routed
   experts of 1408 with top-6 and 2 shared, layer 0 dense at d_ff 10944,
   vocab 102400; f32 weights from seed 0, 61 GiB) on (4, 2048) seeded
   tokens, on the ragged path (``moe_ragged=True``), with the checks of
   phase 6: finite bf16 logits, f32 logits against ``prefill`` of 1024
   tokens and one ``decode_step`` within 3e-3 (the ragged path drops
   nothing; a row whose token 1023 the two route to other experts in some
   layer is left out of that gate, and the first such layer must show a
   tie, the k-th and (k+1)-th router logits within 1e-3), and each
   forward launching the grouped-matmul kernel 3 times a MoE layer (81)
   and the flash kernel once a layer (28); then one bf16 forward on the
   capacity path (the config's default, no grouped matmul), timed, with
   the share of token-choices it drops at capacity factor 1.25 (not
   gated: it is not dropless, so it differs from the ragged path);
11. serves deepseek-moe-16b on the ragged path through a ``ServeEngine``
   over ``LocalDecodeBackend`` (4 slots, max_len 128) on phase 10's
   weights (the launcher's ``main`` would build a second copy) with the
   checks of phase 7 (of the one-slot reruns, the first 2 requests only);
   every decode step launches the grouped matmul 81 times and nothing
   else.

22. (run after phase 18, on the card emptied of every earlier model, before
   phases 19 and 21 and the MoE phases) gemma-2b (18 layers, d=2048, 8/1
   heads of 256, GeGLU, vocab 256000), glm4-9b (40 layers, d=4096, 32/2
   heads, half the head dim rotated, vocab 151552; 37.6 GB of f32
   weights) and qwen2-vl-2b (28 layers, d=1536, 12/2 heads, M-RoPE
   sections (16, 24, 24), vocab 151936) in turn at their published
   configs (f32 params, bf16 compute), each freed before the next: 22a
   phase 6's forward checks on (4, 2048) seeded tokens, exactly 18 / 40 /
   28 flash launches a forward (gemma's at D = 256, the others' at 128)
   and no other kernel; 22b (qwen2-vl-2b) one bf16 forward through
   ``input_embeds`` (the text's embeddings with 1024 seeded patch
   embeddings, a 32 x 32 image at position 64) and 3-D positions whose
   t, h and w streams differ over the image: finite, 28 flash launches,
   logits moved by the image; 22c the first 4 of phase 7's 8 requests
   served as in phase 7 with no kernel launched (gemma and qwen2-vl
   through the launcher's ``main``,
   glm4 through a ``ServeEngine`` on the forward's weights; none rerun
   alone); 22d one traced bf16 forward (busy, idle, flash's share) and one
   traced decode step of 4 slots, and the peak memory;
   the phase prints its wall;
23. (run after phase 22, on the emptied card) bf16 weights, as the JAX
   package serves these models: yi-34b at its published config (60
   layers, d=7168, 56/8 heads of 128, d_ff 20480, vocab 64000; 68.8 GB)
   and phi3.5-moe-42b-a6.6b at its published widths cut to 24 of its 32
   layers (d=4096, 32/8 heads, 16 experts of 6400, top-2; 62.9 GB), one
   at a time: 23a phase 6's forward checks (the init's peak printed;
   exactly 60 flash launches a yi forward, its f32 check on one row; 24
   flash and 72 grouped matmuls, bf16 x and bf16 w, a ragged phi forward,
   its routing compared as phase 10's, then one capacity-path forward with
   24 flash launches), 23b the first 4 of phase 7's requests served on 4
   slots through a ``ServeEngine`` on the forward's weights (no launch a
   yi decode step, 72 grouped matmuls a phi step), 23c a traced forward
   and decode step, and the peak memory; 23d (yi-34b, on 23a's weights) a
   second model with ``kv_quant=True`` serves the same 4 requests on 2
   slots of 32,768 positions (the JAX package's decode_32k length) from
   an int8 KV cache of at most 0.55x the bf16 cache's bytes, with no
   kernel launched, printing the cache's bytes, the peak memory, TPOT p50
   and a traced decode step's idle share; then the int8 and the bf16
   cache on the same weights over a teacher-forced prefill of (2, 64)
   and 8 decode steps: the logits' relative norm within 0.08 (from the
   CPU readings of ``tools/lm_phase.py int8 cpu``), and how many greedy
   tokens agree; the phase prints its wall;
24. (run after phase 23, on the emptied card) training at full width
   beyond qwen2-0.5b, one model at a time, each freed before the next:
   24a mamba2-2.7b (64 Mamba2 layers, d=2560, 80 heads of 64, state 128;
   2.70 G parameters, 10.07 GiB of f32 weights), 24b zamba2-1.2b and 24c
   whisper-tiny trained as 18a trains qwen2-0.5b, through ``python -m
   repro_torch.launch.train``'s ``main`` (5 steps of (4, 1024), whisper
   (4, 448) over its 1500 stub frames), with the verified network line,
   finite losses and exactly 128 SSD launches a mamba2 step, 76 SSD and 6
   flash a zamba2 step (its shared block runs outside remat), 24 flash a
   whisper step, and no other kernel; each prints its losses, step wall
   p50, tokens/s, peak device memory and model FLOP utilisation (6·N·T);
   24e traces one more mamba2 step (busy, idle, the plain backwards' and
   the SSD kernel's shares); 24d holds the loss and gradients on the card
   against the CPU's at published widths with the depth cut (mamba2 2
   layers, zamba2 its first segment of 6 Mamba2 layers and one
   shared-block application, whisper uncut), in f32 on a (1, 128) batch,
   within 18b's gates; the phase prints its wall;
25. (run after phase 24, on the emptied card) the JAX package's two
   memory levers at full width: 25a gemma-2b at its published config with
   ``loss_chunk=512`` (the loss over 8 chunks, each under activation
   checkpointing, so the (4, 4096, 256000) f32 logits never exist at
   once) trained through ``repro_torch.train.train`` for 4 steps of (4,
   4096), train_4k's sequence: finite losses, exactly 36 flash launches a
   step, the step p50 over steps 1-3, tokens/s, peak memory and model
   FLOP utilisation; 25b qwen2-vl-2b trained as 24a-24c through the
   launcher, 5 steps of (4, 1024), 56 flash launches a step; 25c the card
   against the CPU at published widths with the depth cut to 2 layers,
   f32 compute on a (1, 128) batch within 18b's gates: gemma-2b's chunked
   loss (4 chunks of 32) and qwen2-vl-2b's (M-RoPE positions) with their
   gradients, and yi-34b's int8 cache (bf16 weights): a prefill of 64
   tokens and 4 decode steps, no element of the int8 payloads more than
   one step apart; layer 0's scales within 1e-5 of the largest and at most
   0.1 % of its elements one step apart (a k or v within its rounding of
   a half step); layer 1, which also carries what layer 0's flips moved,
   within 2e-3 and 2 %; the logits within 3e-3 in relative norm; the
   phase prints its wall;
26. (run after phase 25, on the emptied card, one model at a time) the
   JAX package's long-context cells on seeded tensors at published
   widths: 26a-26c ``prefill_32k``, ``Model.forward`` of one row of
   32,768 tokens (the cell's 32 rows are a mesh's) by mamba2-2.7b (64 SSD
   launches a forward), zamba2-1.2b (38 SSD, 6 flash) and qwen2-0.5b (24
   flash): a cold and a warm bf16 forward (finite logits; wall, tokens/s,
   peak), the f32 forward's first 2,048 rows against an f32 forward of
   those tokens alone within 3e-3 (the causal prefix), the bf16 logits of
   the last 3 rows within the arch's ``LONG_BF16_GATE`` of the f32 ones in
   relative norm, which a bf16 forward with layer 0's output dropped must
   exceed, and mamba2's f32 forward's last 3 rows against ``prefill`` of
   32,766 tokens and 2 decode steps within 3e-3 (the kernels at those
   lengths are held against their plain versions in phase 1);
   26d ``long_500k``: mamba2-2.7b's 8 decode steps from a cache of
   524,288 positions equal those from 128, whose cache has the same
   bytes; zamba2-1.2b serves one seeded request (16 prompt tokens fed
   one a step, 16 new) from a one-slot cache of 524,288 positions
   (exactly 25,769,803,776 B of shared k and v) with no kernel launched,
   TTFT, TPOT and the step's p50 and p99, the peak above the weights and
   cache under one f32 copy of an application's k, and a traced step
   (idle share, device kernels against a step at 128, peak); in f32 the
   same request from 524,288 positions and from 128 gives equal greedy
   tokens and logits within 1e-5 in relative norm; and the rotary angles
   of every position up to 524,288 on the card against the CPU; the
   phase prints its wall;
18. (run after phase 17 and the profiles below, on phase 6's weights)
   training on the card: 18a trains full-width qwen2-0.5b through
   ``python -m repro_torch.launch.train``'s ``main`` (8 steps of (4, 1024),
   the default config: f32 params, bf16 compute, ``remat="full"``), with
   the verified network line, finite losses, and exactly 48 flash launches
   a step (24 forward, 24 recompute) and no other kernel; it prints the
   losses, the step wall p50 from step 2 on, tokens/s, peak device memory
   and the model FLOP utilisation.  18b holds ``loss_fn``'s loss and
   gradients on the card against the CPU's: full-width qwen2-0.5b in f32 on
   a (1, 128) batch (loss within 1e-5 relative, each grad leaf within 1e-3
   of its max |grad|) and every architecture at reduced width in f32, plus
   deepseek on its ragged path (1e-4), each launching its kernels (flash a
   full-sequence attention, SSD a Mamba2 layer, three grouped matmuls a
   ragged MoE layer).  18c runs the reference's fault-tolerance case on the
   card (12 reduced steps, failures at 4 and 9, async saves every 3: two
   restarts, within 1e-6 of a clean run) and its loss-decreases case (40
   steps, lr 1e-2).  One full-width train step is then traced, with the
   plain backwards' share of the busy time.

20. (run last, after the MoE phases) the dry-run held against the card:
   20a, five cells of ``python -m repro_torch.launch.dryrun`` (qwen2-0.5b
   × train_4k, zamba2-1.2b × long_500k, deepseek-moe-16b × decode_32k,
   whisper-tiny × decode_32k on 16x16; phi3.5-moe-42b-a6.6b × train_4k on
   2x16x16, memory only) traced with fake CUDA tensors in a process of
   their own, started before the kernel builds: each ``ok``, no kernel
   launched and no device byte allocated by the traces; the same process
   traces 26d's one-device decode step (zamba2-1.2b from 524,288
   positions), printed beside the card's peak over that step (not gated);
   20b, 18a's step
   traced: its peak (argument + temp bytes) within 15 % of the card's
   peak over that step and its FLOPs within 2 % of the step's executed
   count (``dryrun_step_flops``); 20c, 19b's bf16 step traced in a fake
   world of 2: the same collective calls and result bytes of each kind
   as 19b's rank 0 counted on the card, exactly.  Phase 20 launches
   nothing.

Peak and free device memory are printed after each MoE phase.

Phase 1 times each Mandelbrot band on its own as well (the fastest and
slowest band beside the mean) and prints the share of lane-steps that do
work in the full image's 32-pixel chunks.  It holds the stencil kernel
exact at k = 1, 7, 9 (template instances) and 11 (the runtime-k kernel),
in float32, bfloat16 and float16, at widths whose rows are not whole
16-byte copies (element-wise tile loads), on one pixel and on fewer rows
than k, and times it on 2048 x 2048 images in the three types (EDGE5 and
random taps); the flash-attention kernel
against its plain version on the qwen2 forward's shape (B=4, H=14, K=2,
S=2048, D=64), deepseek's (B=4, H=16, K=16, D=128), gemma-2b's (B=4,
H=8, K=1, D=256), glm4-9b's, qwen2-vl-2b's, yi-34b's (B=4, H=56, K=8,
D=128) and phi3.5-moe's (B=4, H=32, K=8, D=128), whisper-tiny's
decoder self-attention in a train step (B=4, H=6, K=6, S=448, D=64),
gemma-2b's train step at S=4096 and qwen2-vl-2b's at S=1024, the
reference tests' shapes, and without causality at
an encoder's (Sq = Sk) and cross-attention's shapes (Sq = 1 and 1 < Sq <
Sk), in float32 (the FMA path) and bf16 (the tensor cores), timed at the
qwen2, deepseek, gemma and yi forward shapes (gemma's also in float16,
through the FMA path), gemma's train step's and
at whisper-tiny's encoder (4, 6, 6, 1500, 1500, 64) and decode-step
cross-attention (Sq = 1 against 1500 frames) without causality, beside
``scaled_dot_product_attention`` (the yardstick; the port never calls it);
the SSD-scan kernel, y and final state, on the mamba2 and zamba2
forwards' shapes, mamba2's training shape (4, 1024; timed, with the
plain backward), the reference tests' shapes, a ragged S, G = H, and P >
64 and N > 128 (split by the op into several launches), bf16 (the tensor
cores) also to gates scaled to the output (no PyTorch call computes the
scan, so it has no yardstick); and the grouped
expert matmul at deepseek-moe-16b's forward shape (8192 tokens, top-6 of
64 experts, D 2048 → F 1408, and the down product; f32 w), with uniform
and one-expert routing, at a decode step's 24 rows, at phi3.5-moe's
shapes with bf16 w (8192 tokens, top-2 of 16, D 4096 → F 6400 and back,
uniform and one-expert, and a decode step of 4 slots), at the reference
tests' shapes and at 4.3 M rows (past the 65,535 row blocks a grid.y
held), timed beside ``torch._grouped_mm`` (the yardstick) at deepseek's
forward and decode shapes and phi's gate/up shape, both as the op
(routing included) and as the kernel's
launch alone on the sorted rows (what ``torch._grouped_mm`` is timed on).
It holds uint8 and int32 2048 x 2048 stencil images (EDGE5 and random
k = 3 taps, sums out of the type's range both ways) exactly against the
plain version.  It counts the tensor-core instructions (HMMA/HGMMA lines
of ``cuobjdump -sass``) in the flash, grouped-matmul and SSD libraries,
which must be above 0.  It checks that each of the four kernel ops
(``mha``, ``ssd``, ``moe_apply``, ``stencil2d``) launches once under grad
mode and that its backward (the plain version's, recomputed) gives the
plain version's gradients on the card within the op's forward tolerance,
and times that plain backward beside the kernel's forward at the shapes
timed above and at the qwen2 training shape (4, 14, 2, 1024, 1024, 64).
It then holds, each
as one launch against the plain version, what the ops once refused on the
card: float16 flash attention (D = 48 padded, and the qwen2 shape, timed),
bf16 rows not 16-byte aligned and a strided head dim; the float16 SSD scan
with bf16 dt and A, strided P and N, at mamba2's shape (timed), and S = 0
(no launch); the float16 grouped matmul at deepseek's up shape with f32,
bf16 and f16 w (timed) and a strided w; and bool and transposed stencil
images.

Kernel launch counts are reset just before phase 2 and read after phase 9
(the thread hosts of phases 12, 13 and 15 and the simulated hosts of
phases 14 and 15 count with them; phase 16, which must launch nothing, is
counted apart, from 0; phases 17, 18, 22, 23, 24, 25 and 26 are counted
apart, from 0, and added),
and reset again just before phase 10 and read after phase 11: each kernel
must have been launched by one of the two paths.  One more fused run of
the farm, of the pipeline, one more bf16 forward and one decode step of
qwen2-0.5b and of mamba2-2.7b, one more zamba2-1.2b forward and one more
whisper-tiny decode step are traced with ``torch.profiler`` after phase
17, and one bf16 forward and one decode step of deepseek-moe-16b after
phase 11, to print the device's busy time, idle share and each of the
port's kernels' share of the busy time.  A ``phase walls:`` line gives
each phase's wall in the order run.  The last two lines are a JSON
summary of the kernels and ``{"ok": true, "device": ...}``.  Any failure
raises and the script exits non-zero; so does a machine without a CUDA
device, where nothing is printed on standard output.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

F32_PEAK = 67e12      # H100 SXM f32 FLOP/s outside the tensor cores
BF16_PEAK = 989e12    # H100 SXM dense bf16 tensor-core FLOP/s
HBM_RATE = 3.35e12    # H100 SXM device-memory bytes/s
L2_BYTES = 50 * 2**20
SLEEP_CYCLES = 200_000_000  # ~100 ms at the H100's ~2 GHz clock
LAUNCH_PREFILL_CHUNK = 8    # LocalDecodeBackend's default prefill_chunk


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- timing --------------------------------------------------------------------

def timed_turns(torch, fns: dict, reps: dict, flush=None) -> dict:
    """Median ms per call of each function, timed with CUDA events in turns
    plain, kernel, kernel, plain (library calls ride with the kernel turns).
    ``flush`` runs before every timed call, outside the events.

    Each turn starts behind a 100 ms device sleep, so the host queues the
    calls ahead of the device and the events time the device's work, not
    the host's Python between launches (a plain version that issues more
    launches than the sleep covers is timed with its launch cost)."""
    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    order = ["plain", "kernel", "kernel", "plain"]
    samples: dict = {k: [] for k in fns}
    for turn in order:
        names = [turn] + ([n for n in fns if n not in ("plain", "kernel")]
                          if turn == "kernel" else [])
        for name in names:
            events = []
            torch.cuda._sleep(SLEEP_CYCLES)
            for _ in range(reps[name]):
                if flush is not None:
                    flush()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fns[name]()
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            samples[name].extend(s.elapsed_time(e) for s, e in events)
    return {k: statistics.median(v) for k, v in samples.items()}


def host_cost_us(torch, fn, calls_per_fn: int, reps: int = 5) -> float:
    """Host microseconds per wrapper call, measured while the device sleeps
    (so no launch waits on a full queue)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / (reps * calls_per_fn) * 1e6


# the port's kernels by the names of their CUDA functions
KERNEL_SYMBOLS = {"flash_attention": ("flash_mma_kernel<", "flash_kernel<"),
                  "moe_gmm": ("gmm_mma_kernel<", "gmm_kernel<"),
                  "ssd_scan": ("ssd_mma_kernel<", "ssd_kernel<"),
                  "stencil": ("stencil_kernel<", "stencil_any_k_kernel<"),
                  "mandelbrot": ("mandelbrot_kernel",)}


def profile_run(torch, label: str, fn) -> tuple:
    """One run under ``torch.profiler``: its wall, the device's busy time
    (kernels and copies) and idle share, the host ops that took most time,
    the device kernels that took most time, and each of the port's
    kernels' time, launches and share of the busy time.  Returns
    (key averages, busy ms, wall ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in avgs
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)) / 1e3
    top = sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)[:4]
    print(f"[profile] {label}: wall {wall_ms:.1f} ms (profiled), device "
          f"busy {busy_ms:.2f} ms, idle {1 - busy_ms / wall_ms:.1%}; top "
          "host ops: " + ", ".join(
              f"{e.key} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}"
              for e in top))
    dev = sorted((e for e in avgs if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.self_device_time_total, reverse=True)[:4]
    print(f"[profile] {label}: top device kernels: " + ", ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
        for e in dev))
    shares = []
    for name, symbols in KERNEL_SYMBOLS.items():
        hits = [e for e in avgs if e.device_type == DeviceType.CUDA
                and any(sym in e.key for sym in symbols)]
        if hits:
            ms = sum(e.self_device_time_total for e in hits) / 1e3
            shares.append(f"{name} {ms:.2f} ms x{sum(e.count for e in hits)}"
                          f" ({ms / busy_ms:.1%} of busy)")
    if shares:
        print(f"[profile] {label}: kernel shares: " + ", ".join(shares))
    return avgs, busy_ms, wall_ms


def profile_model(torch, model, params, toks, note: str = "") -> None:
    """One traced bf16 forward on ``toks`` and one traced decode step of
    ``LocalDecodeBackend`` (4 slots, max_len 128, after a warm-up step),
    labelled with the arch's name and ``note``."""
    import numpy as np
    from repro_torch.serve import LocalDecodeBackend
    name, (B, S) = model.cfg.name, toks.shape
    with torch.inference_mode():
        profile_run(torch, f"{name} forward bf16 ({B}, {S}){note}",
                    lambda: model.forward(params, toks))
        backend = LocalDecodeBackend(model, params, n_slots=4, max_len=128)
        last, adv = np.arange(1, 5, dtype=np.int32), np.ones(4, bool)
        backend.decode(last, adv)  # warm-up
        profile_run(torch, f"{name} decode step (4 slots){note}",
                    lambda: backend.decode(last, adv))
        del backend


def bound(flops: float, nbytes: float,
          peak: float = F32_PEAK) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# -- phase 1: kernels against their plain versions -------------------------------

def check_mandelbrot(torch, dev, W, H, bands, iters) -> dict:
    from repro_torch.kernels.mandelbrot import ops, ref
    band_h, delta = H // bands, 3.0 / W
    kw = dict(x0=-2.2, y0=-1.15, pixel_delta=delta, max_iterations=iters)
    rows0 = [torch.tensor(b * band_h, dtype=torch.int32, device=dev)
             for b in range(bands)]
    err, escaped_work = 0, 0
    for r0 in rows0:
        got = ops.mandelbrot(band_h, W, row0=r0, **kw)
        want = ref.mandelbrot(band_h, W, row0=r0, **kw)
        err = max(err, int((got - want).abs().max()))
        escaped_work += int(got.sum()) + int((got < iters).sum())
    check(err == 0, f"mandelbrot kernel differs from its plain version "
                     f"(max |diff| {err})")

    def sweep(fn):  # every band of the farm, one call each
        return lambda: [fn(band_h, W, row0=r0, **kw) for r0 in rows0]

    t = timed_turns(torch, {"plain": sweep(ref.mandelbrot),
                            "kernel": sweep(ops.mandelbrot)},
                    {"plain": 1, "kernel": 5})
    ms, plain_ms = t["kernel"] / bands, t["plain"] / bands
    bound_ms, bound_by = bound(9.0 * escaped_work / bands,
                               band_h * W * 4)
    host_us = host_cost_us(torch, sweep(ops.mandelbrot), bands)
    # each band on its own (median of 5 sweeps), so imbalance between bands
    # shows beside the mean
    events = [[] for _ in rows0]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for _ in range(5):
        for evs, r0 in zip(events, rows0):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ops.mandelbrot(band_h, W, row0=r0, **kw)
            end.record()
            evs.append((start, end))
    torch.cuda.synchronize()
    band_ms = [statistics.median(s.elapsed_time(e) for s, e in evs)
               for evs in events]
    print(f"[kernel] mandelbrot band ({band_h}, {W}) x {bands} bands, "
          f"{iters} it: exact; kernel {ms:.4f} ms/band (fastest "
          f"{min(band_ms):.4f}, slowest {max(band_ms):.4f} ms), plain "
          f"{plain_ms:.3f} ms/band, library none, bound {bound_ms:.4f} ms "
          f"({bound_by}; {9 * escaped_work:.3e} f32 ops over the farm), "
          f"roofline {bound_ms / ms:.1%}; host {host_us:.1f} us/call")

    full_k = ops.mandelbrot(H, W, **kw, device=dev)
    full_p = ref.mandelbrot(H, W, **kw, device=dev)
    check(torch.equal(full_k, full_p), "full-image mandelbrot differs")
    work = int(full_k.sum()) + int((full_k < iters).sum())
    tf = timed_turns(torch, {"plain": lambda: ref.mandelbrot(
                                 H, W, **kw, device=dev),
                             "kernel": lambda: ops.mandelbrot(
                                 H, W, **kw, device=dev)},
                     {"plain": 1, "kernel": 5})
    fb, fby = bound(9.0 * work, H * W * 4)
    # a warp's 32 pixels of a row step until the slowest escapes: the share
    # of those lane-steps that do work
    chunks = full_k.view(H, W // 32, 32).double()
    busy = float(chunks.sum() / (32 * chunks.amax(-1).sum()))
    print(f"[kernel] mandelbrot full ({H}, {W}), {iters} it: exact; kernel "
          f"{tf['kernel']:.4f} ms, plain {tf['plain']:.3f} ms, bound "
          f"{fb:.4f} ms ({fby}), roofline {fb / tf['kernel']:.1%}; lanes "
          f"busy {busy:.1%} of their 32-pixel chunks' steps")
    return {"name": "mandelbrot", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mandelbrot.cu",
            "replaces": "src/repro/kernels/mandelbrot/kernel.py:20",
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_stencil(torch, dev) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.stencil import ops, ref
    from repro_torch.workloads import EDGE5
    torch.backends.cudnn.allow_tf32 = False
    flush_buf = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator().manual_seed(0)
    entry = None
    f16 = torch.float16
    cases = [((2048, 2048), 5, torch.float32, EDGE5),
             ((2048, 2048), 3, torch.float32, None),
             ((2048, 2048), 5, torch.bfloat16, None),
             ((2048, 2048), 3, torch.bfloat16, None),
             ((2047, 2048), 5, torch.float32, None),
             ((2048, 2048), 5, torch.bfloat16, EDGE5),
             ((2048, 2048), 5, f16, EDGE5),
             ((2048, 2048), 5, f16, None)]
    # every odd k is exact against the plain version: 1, 7 and 9 are
    # template instances, 11 takes the runtime-k kernel; rows that are not
    # whole 16-byte copies (W % 4 for f32, W % 8 for bf16 and f16) take
    # the element-wise tile loads; one pixel, H < k, and zero taps (the
    # skipping instance; EDGE5 takes the ring instance) (not timed)
    f32, bf16 = torch.float32, torch.bfloat16
    laplace = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))
    for (H, W), k, dtype, taps in (((2048, 2048), 1, f32, None),
                                   ((2048, 2048), 7, f32, None),
                                   ((2047, 2048), 9, bf16, None),
                                   ((1000, 777), 11, f32, None),
                                   ((2048, 2046), 5, f32, EDGE5),
                                   ((2047, 2044), 5, f16, None),
                                   ((1000, 777), 7, f16, None),
                                   ((1000, 777), 11, f16, None),
                                   ((1, 1), 5, f32, EDGE5),
                                   ((3, 2048), 9, f16, None),
                                   ((2048, 2048), 3, f32, laplace)):
        if taps is None:
            taps = ops.taps_of(torch.randn(k, k, generator=g))
        img = torch.randn(H, W, generator=g).to(dtype).to(dev)
        got, want = ops.stencil2d(img, taps), ref.stencil2d(img, taps)
        err = float((got.float() - want.float()).abs().max())
        check(torch.equal(got, want), f"stencil ({H}, {W}) k={k} {dtype}: "
                                      f"not exact, max |diff| {err}")
        print(f"[kernel] stencil ({H}, {W}) k={k} {str(dtype)[6:]}: exact")
    # integer images: converted to float32, the float32 kernel, converted
    # back saturating as XLA does; random images over the type's range, so
    # EDGE5's sums and random k = 3 taps x 3 leave it both ways (not timed)
    for dtype in (torch.uint8, torch.int32):
        info = torch.iinfo(dtype)
        for k, taps in ((5, EDGE5), (3, ops.taps_of(
                3.0 * torch.randn(3, 3, generator=g)))):
            img = torch.randint(info.min, info.max, (2048, 2048), generator=g,
                                dtype=torch.int64).to(dtype).to(dev)
            got, want = ops.stencil2d(img, taps), ref.stencil2d(img, taps)
            sat = (int((want == info.max).sum()), int((want == info.min).sum()))
            check(got.dtype == dtype and torch.equal(got, want),
                  f"stencil (2048, 2048) k={k} {dtype}: not exact")
            check(min(sat) > 0, f"stencil {dtype} k={k}: sums saturate "
                                f"only one way {sat}")
            print(f"[kernel] stencil (2048, 2048) k={k} {str(dtype)[6:]}: "
                  f"exact; {sat[0]} pixels at the type's max, {sat[1]} at "
                  "its min")
    for (H, W), k, dtype, taps in cases:
        if taps is None:
            taps = ops.taps_of(torch.randn(k, k, generator=g))
        img = torch.randn(H, W, generator=g).to(dtype).to(dev)
        got, want = ops.stencil2d(img, taps), ref.stencil2d(img, taps)
        err = float((got.float() - want.float()).abs().max())
        check(torch.equal(got, want),
              f"stencil ({H}, {W}) k={k} {dtype}: max |diff| {err}")
        weight = torch.tensor(taps, dtype=dtype, device=dev)[None, None]
        t = timed_turns(
            torch, {"plain": lambda: ref.stencil2d(img, taps),
                    "kernel": lambda: ops.stencil2d(img, taps),
                    "library": lambda: F.conv2d(img[None, None], weight,
                                                padding=k // 2)},
            {"plain": 10, "kernel": 20, "library": 20},
            flush=flush_buf.zero_)
        host_us = host_cost_us(torch, lambda: ops.stencil2d(img, taps), 1,
                               reps=20)
        nnz = sum(w != 0.0 for row in taps for w in row)
        bound_ms, bound_by = bound(2.0 * nnz * H * W,
                                   2.0 * H * W * img.element_size())
        print(f"[kernel] stencil ({H}, {W}) k={k} {str(dtype)[6:]}: "
              f"{'exact' if torch.equal(got, want) else f'max|diff| {err}'}"
              f"; kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
              f"library(conv2d) {t['library']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), roofline "
              f"{bound_ms / t['kernel']:.1%}; host {host_us:.1f} us/call")
        if entry is None:  # the main path's case: EDGE5 on f32 2048 x 2048
            entry = {"name": "stencil", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/stencil.cu",
                     "replaces": "src/repro/kernels/stencil/kernel.py:31",
                     "max_abs_err": err, "ms": t["kernel"],
                     "plain_ms": t["plain"], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": t["library"]}
    return entry


# Flash gates scaled to the output they compare.  Near-uniform softmax over
# ~1,000 keys leaves |o| ~ 0.03, below the absolute 5e-2: a kernel that
# dropped a kv tile or mis-scaled a rescale would pass that alone.
REL_MAX = 2e-2  # max |got - want| / max |want| (bf16 flash and SSD)
REL_RMS = 1e-2  # ||got - want|| / ||want||


def scaled_errors(got, want) -> tuple:
    """(max |got - want|, max |want|, ||got - want|| / ||want||), in f32."""
    got, want = got.float(), want.float()
    diff = got - want
    return (float(diff.abs().max()), float(want.abs().max()),
            float(diff.norm() / want.norm()))


def flash_gates(name, got, want, tol) -> tuple:
    """Holds a flash output to ``tol`` and to the gates scaled to the
    output; returns :func:`scaled_errors`."""
    err, scale, rel_rms = scaled_errors(got, want)
    check(err <= tol, f"{name}: max |diff| {err} > {tol}")
    check(err <= REL_MAX * scale,
          f"{name}: max |diff| {err} > {REL_MAX} x max|want| {scale}")
    check(rel_rms <= REL_RMS,
          f"{name}: |got - want| / |want| {rel_rms} > {REL_RMS}")
    return err, scale, rel_rms


def check_flash(torch, dev) -> dict:
    """The flash kernel against its plain version: the qwen2, deepseek,
    gemma, glm4, qwen2-vl, yi and phi3.5-moe forwards' shapes, whisper's
    decoder self-attention (4, 6, 6, 448, 448, 64), zamba2's shared block
    (4, 32, 32, 1024, 1024, 64), gemma's (4, 8, 1, 4096, 4096, 256) and
    qwen2-vl's (4, 12, 2, 1024, 1024, 128) in a train step and the
    reference tests' shapes, and zamba2's and qwen2's at one row of 32,768
    tokens (phase 26; against the plain version's query-chunked form, with
    the last query tile also alone), f32 and bf16, causal; an encoder's and
    cross-attention's shapes (whisper's train step's (4, 6, 6, 448, 1500,
    64) among them) without causality; times at the qwen2, deepseek, gemma
    and yi forwards' shapes (gemma's also in f16, the FMA path), the 32k
    shapes, gemma's
    train step's and whisper-tiny's encoder and cross-attention shapes
    (bf16: the tensor-core path)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    flush_buf = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator().manual_seed(0)
    path = (4, 14, 2, 2048, 2048, 64)  # qwen2-0.5b: GQA group of 7, D=64
    deepseek = (4, 16, 16, 2048, 2048, 128)  # deepseek-moe-16b: MHA, D=128
    gemma = (4, 8, 1, 2048, 2048, 256)  # gemma-2b: MQA, D=256
    glm4 = (4, 32, 2, 2048, 2048, 128)  # glm4-9b: GQA group of 16
    qwen2_vl = (4, 12, 2, 2048, 2048, 128)  # qwen2-vl-2b: GQA group of 6
    yi = (4, 56, 8, 2048, 2048, 128)  # yi-34b: GQA group of 7
    phi = (4, 32, 8, 2048, 2048, 128)  # phi3.5-moe: GQA group of 4
    # whisper-tiny's decoder self-attention in a train step (phase 24c)
    whisper_dec = (4, 6, 6, 448, 448, 64)
    # zamba2-1.2b's shared attention block in a train step (phase 24b)
    zamba2 = (4, 32, 32, 1024, 1024, 64)
    # gemma-2b's and qwen2-vl-2b's train steps (phases 25a and 25b)
    gemma_train = (4, 8, 1, 4096, 4096, 256)
    qwen2_vl_train = (4, 12, 2, 1024, 1024, 128)
    # one row of the JAX package's prefill_32k cell (phase 26): zamba2-1.2b's
    # shared block and qwen2-0.5b
    zamba2_long, qwen2_long = LONG_FLASH["zamba2-1.2b"], \
        LONG_FLASH["qwen2-0.5b"]
    causal_shapes = [path, deepseek, gemma, glm4, qwen2_vl, yi, phi,
                     whisper_dec, zamba2, gemma_train, qwen2_vl_train,
                     zamba2_long, qwen2_long,
                     (1, 4, 2, 64, 64, 32),
                     (2, 8, 1, 96, 96, 64), (2, 4, 4, 128, 128, 32),
                     (1, 2, 2, 33, 33, 16),  # ragged
                     (2, 4, 2, 1, 80, 32)]   # decode
    # without causality: an encoder (Sq = Sk) and cross-attention (Sq = 1
    # against 1500 frames; 1 < Sq < Sk), as whisper's encoder and decoder
    # would call it
    whisper_enc, whisper_cross = (4, 6, 6, 1500, 1500, 64), \
        (4, 6, 6, 1, 1500, 64)
    # whisper-tiny's decoder cross-attention in a train step (phase 24c)
    whisper_train_cross = (4, 6, 6, 448, 1500, 64)
    open_shapes = [whisper_enc, whisper_cross, whisper_train_cross,
                   (2, 8, 2, 77, 300, 128)]
    # the shapes timed in bf16, beside scaled_dot_product_attention: the
    # forwards of phases 6, 10, 22 (gemma-2b) and 23 (yi-34b, the heaviest
    # attention), gemma-2b's train step at 4096 positions (phase 25a), and
    # whisper-tiny's (phase 17) encoder and a decode step's cross-attention
    # over 1500 frames; gemma's forward also in f16, through the FMA path
    timed = {(path, True): "qwen2-0.5b", (deepseek, True): "deepseek-moe-16b",
             (gemma, True): "gemma-2b", (yi, True): "yi-34b",
             (gemma_train, True): "gemma-2b training",
             (zamba2_long, True): "zamba2-1.2b prefill_32k",
             (qwen2_long, True): "qwen2-0.5b prefill_32k",
             (whisper_enc, False): "whisper-tiny encoder",
             (whisper_cross, False): "whisper-tiny decode step's "
                                     "cross-attention"}
    cases = [(s, True) for s in causal_shapes] + \
        [(s, False) for s in open_shapes]
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        # bf16: the plain version rounds its normalised probabilities to
        # bf16 before the PV product (as the JAX oracle does), the kernel
        # its unnormalised ones -- hence the reference's looser bf16 gate,
        # kept as the outer bound beside the gates scaled to the output
        tol = 5e-2 if dtype == torch.bfloat16 else 2e-4
        for (B, H, K, Sq, Sk, D), causal in cases:
            q = (torch.randn(B, H, Sq, D, generator=g) * 0.3).to(dtype).to(dev)
            k = (torch.randn(B, K, Sk, D, generator=g) * 0.3).to(dtype).to(dev)
            v = torch.randn(B, K, Sk, D, generator=g).to(dtype).to(dev)
            # the plain version's whole (Sq, Sk) f32 logits past 4 GiB
            # (137 GB at zamba2's 32k shape): its query-chunked form
            chunked = B * H * Sq * Sk * 4 > 1 << 32

            def plain():
                if chunked:
                    return ref.mha_chunked(q, k, v, causal=causal,
                                           chunk=LONG_FLASH_CHUNK)
                return ref.mha(q, k, v, causal=causal)

            got = ops.mha(q, k, v, causal=causal)
            want = plain()
            name = (f"flash ({B}, {H}, {K}, {Sq}, {Sk}, {D}) causal={causal} "
                    f"{dtype}")
            err, scale, rel_rms = flash_gates(name, got, want, tol)
            tail = ""
            if chunked:
                # the last query tile, whose online softmax runs its maximum
                # over every key tile, and the worst row
                t_err, _, t_rms = flash_gates(f"{name} last query tile",
                                              got[:, :, -128:],
                                              want[:, :, -128:], tol)
                rows = (got.float() - want.float()).abs().amax(-1).flatten()
                worst = int(rows.argmax())
                tail = (f"; against mha_chunked (chunk {LONG_FLASH_CHUNK}); "
                        f"the last 128 query rows {t_err:.3e} / {t_rms:.3e}; "
                        f"the worst row (head {worst // Sq % H}, query "
                        f"{worst % Sq}) {float(rows[worst]):.3e}")
                del rows
            del got, want
            route = ("tensor cores" if kernel.tensor_core_path(dtype, D)
                     else "FMA")
            print(f"[kernel] flash_attention B={B} H={H} K={K} Sq={Sq} "
                  f"Sk={Sk} D={D} {str(dtype)[6:]} causal={causal} "
                  f"({route}): max|diff| {err:.3e} (gates {tol} and "
                  f"{REL_MAX} x max|want| {scale:.3e}), |got - want| / "
                  f"|want| {rel_rms:.3e} (gate {REL_RMS}){tail}")
            shape = (B, H, K, Sq, Sk, D)
            label = timed.get((shape, causal))
            if label is None or dtype != torch.bfloat16:
                continue
            fns = {"plain": plain,
                   "kernel": lambda: ops.mha(q, k, v, causal=causal),
                   "library": lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=causal, enable_gqa=True)}
            if shape == gemma:  # the same inputs in f16: the FMA path
                check(not kernel.tensor_core_path(torch.float16, D),
                      "flash f16 D=256 is no longer the FMA path")
                qh, kh, vh = (t.half() for t in (q, k, v))
                fns["fma"] = lambda: ops.mha(qh, kh, vh, causal=causal)
            reps = ({"plain": 1, "kernel": 3, "library": 3} if chunked else
                    {"plain": 3, "kernel": 10, "library": 10, "fma": 5})
            t = timed_turns(torch, fns, reps, flush=flush_buf.zero_)
            pairs = B * H * (sum(min(Sk, i + Sk - Sq + 1) for i in range(Sq))
                             if causal else Sq * Sk)
            flops = 4.0 * D * pairs
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
            print(f"[kernel] flash_attention {label} shape bf16: kernel "
                  f"{t['kernel']:.4f} ms ({flops / t['kernel'] / 1e9:.1f} "
                  f"TFLOP/s), plain {t['plain']:.4f} ms, library(sdpa) "
                  f"{t['library']:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}; {flops:.3e} "
                  f"{'causal ' if causal else ''}FLOP at the bf16 peak, "
                  f"{nbytes / 1e6:.2f} MB), "
                  f"roofline {bound_ms / t['kernel']:.1%}")
            if "fma" in t:
                print(f"[kernel] flash_attention {label} shape f16 (FMA "
                      f"path): {t['fma']:.4f} ms "
                      f"({flops / t['fma'] / 1e9:.1f} TFLOP/s), roofline "
                      f"{bound_ms / t['fma']:.1%}; bf16 tensor cores "
                      f"{t['fma'] / t['kernel']:.1f}x faster")
                del qh, kh, vh
            if shape == path:
                entry = {"name": "flash_attention", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/"
                                   "flash_attention.cu",
                         "replaces": "src/repro/kernels/flash_attention/"
                                     "kernel.py:32",
                         "max_abs_err": err, "ms": t["kernel"],
                         "plain_ms": t["plain"], "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": t["library"]}
    del flush_buf
    return entry


def ssd_work(b, S, H, P, G, N, chunk=64) -> float:
    """FLOP of the SSD scan: C·Bᵀ once per group over the causal pairs of
    each chunk, W·x over the same pairs per head, C·h and the state update
    N·P multiply-adds a step per head."""
    rows = [chunk] * (S // chunk) + ([S % chunk] if S % chunk else [])
    pairs = sum(r * (r + 1) // 2 for r in rows)
    return 2.0 * b * G * N * pairs + b * H * (2.0 * P * pairs
                                              + 4.0 * N * P * S)


def ssd_gates(name, y, hT, want_y, want_h, rtol, atol) -> tuple:
    """Holds an SSD scan's y to (rtol, atol) and its f32 final state to
    them (f32 y) or to 2e-4 (bf16 y); bf16 y also to the gates scaled to
    the output.  Returns (max |diff| of y, of hT, the scaled gates' text)."""
    import torch
    err = float((y.float() - want_y.float()).abs().max())
    err_h = float((hT - want_h).abs().max())
    htol = (rtol, atol) if y.dtype == torch.float32 else (2e-4, 2e-4)
    for got, want, (rt, at), what in ((y.float(), want_y.float(),
                                       (rtol, atol), "y"),
                                      (hT, want_h, htol, "hT")):
        excess = float(((got - want).abs() - (at + rt * want.abs())).max())
        check(excess <= 0, f"{name}: {what} outside rtol {rt} / atol {at} "
                           f"by {excess}")
    if y.dtype != torch.bfloat16:
        return err, err_h, ""
    _, scale, rel_rms = scaled_errors(y, want_y)
    check(err <= REL_MAX * scale,
          f"{name}: max |diff| {err} > {REL_MAX} x max|want| {scale}")
    check(rel_rms <= REL_RMS,
          f"{name}: |y - want| / |want| {rel_rms} > {REL_RMS}")
    return err, err_h, (f"; {err / scale:.2%} of max|want| {scale:.3e} "
                        f"(gate {REL_MAX:.0%}), |y - want| / |want| "
                        f"{rel_rms:.3e} (gate {REL_RMS})")


def check_ssd(torch, dev) -> dict:
    """The SSD kernel against its plain version, y and the final state: the
    mamba2 and zamba2 forwards' and train steps' shapes, the reference
    tests' shapes, ragged S, G = H, and P > 64 and N > 128 (several
    launches a call), and mamba2's and zamba2's at one row of 32,768
    tokens (phase 26; there also the last chunk's y); times at
    the mamba2 forward's shape and at its training step's (4, 1024, 80,
    64, 1, 128), there also the plain backward, and at both 32k shapes.
    bf16 y is also held to
    gates scaled to the output (as flash is): max |diff| <= 2e-2 max
    |want| and ||diff|| <= 1e-2 ||want||."""
    from repro_torch.kernels.ssd_scan import ops, ref
    flush_buf = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator().manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    path = (4, 2048, 80, 64, 1, 128)  # (batch, S, H, P, G, N) of mamba2-2.7b
    train = (4, 1024, 80, 64, 1, 128)  # its train step's (phase 24a)
    zamba = (4, 2048, 64, 64, 1, 64)
    zamba_train = (4, 1024, 64, 64, 1, 64)  # its train step's (phase 24b)
    ref_shape = (1, 64, 2, 8, 2, 4)   # tests/test_kernels.py: BH 2, own B, C
    # one row of the JAX package's prefill_32k cell (phase 26): 512 chunks
    # walked in series by each of batch x H blocks
    long, zamba_long = LONG_SSD["mamba2-2.7b"], LONG_SSD["zamba2-1.2b"]
    # (shape, dtype, chunk of the plain version, (rtol, atol)).  bf16: both
    # sides sum in f32 and round y to bf16 once, so a rounding flip costs one
    # ulp (2^-8 of |y|); the f32 state is then held to 2e-4
    cases = [(path, bf16, 64, (1e-2, 5e-2)), (train, bf16, 64, (1e-2, 5e-2)),
             (zamba, bf16, 64, (1e-2, 5e-2)),
             (zamba_train, bf16, 64, (1e-2, 5e-2)),
             (path, f32, 64, (2e-4, 2e-4)), (zamba, f32, 64, (2e-4, 2e-4)),
             (long, bf16, 64, (1e-2, 5e-2)), (long, f32, 64, (2e-4, 2e-4)),
             (zamba_long, bf16, 64, (1e-2, 5e-2)),
             (zamba_long, f32, 64, (2e-4, 2e-4)),
             (ref_shape, f32, 16, (1e-4, 1e-5)),
             (ref_shape, f32, 32, (1e-4, 1e-5)),
             ((1, 2047, 80, 64, 1, 128), bf16, 64, (1e-2, 5e-2)),  # ragged
             ((2, 33, 4, 16, 4, 16), f32, 16, (2e-4, 2e-4)),       # ragged
             ((2, 256, 8, 64, 8, 128), f32, 64, (2e-4, 2e-4)),     # G = H
             # wider than one launch: P-slices, N-blocks, both
             ((2, 512, 8, 130, 1, 128), bf16, 64, (1e-2, 5e-2)),
             ((2, 512, 8, 64, 2, 256), bf16, 64, (1e-2, 5e-2)),
             ((1, 300, 4, 80, 1, 160), f32, 64, (2e-4, 2e-4)),
             ((1, 300, 4, 80, 1, 160), bf16, 64, (1e-2, 5e-2))]
    entry = None
    for shape, dtype, chunk, (rtol, atol) in cases:
        b, S, H, P, G, N = shape
        x = torch.randn(b, S, H, P, generator=g).to(dtype).to(dev)
        dt = (torch.rand(b, S, H, generator=g) * 0.1).to(dev)
        A = (-torch.rand(H, generator=g) - 0.1).to(dev)
        B = (torch.randn(b, S, G, N, generator=g) * 0.3).to(dtype).to(dev)
        C = (torch.randn(b, S, G, N, generator=g) * 0.3).to(dtype).to(dev)
        before = ops.ssd.launches
        y, hT = ops.ssd(x, dt, A, B, C, chunk=chunk, return_state=True)
        pieces = ops.ssd.launches - before
        check(pieces == -(-P // 64) * -(-N // 128),
              f"ssd {shape}: {pieces} launches")
        want_y, want_h = ref.ssd(x, dt, A, B, C, chunk=chunk,
                                 return_state=True)
        name = f"ssd {shape} {dtype} chunk {chunk}"
        err, err_h, scaled = ssd_gates(name, y, hT, want_y, want_h, rtol,
                                       atol)
        if S >= LONG_SEQ:  # the last chunk's y, which carries every state
            last, _, last_scaled = ssd_gates(
                f"{name} last chunk", y[:, -chunk:], hT,
                want_y[:, -chunk:], want_h, rtol, atol)
            scaled += f"; the last of {S // chunk} chunks' y {last:.3e}" \
                + last_scaled
        htol = (rtol, atol) if dtype == f32 else (2e-4, 2e-4)
        print(f"[kernel] ssd_scan batch={b} S={S} H={H} P={P} G={G} N={N} "
              f"{str(dtype)[6:]} ({pieces} launch{'es' if pieces > 1 else ''}"
              f"): max|diff| y {err:.3e} (rtol {rtol}, atol {atol}), hT "
              f"{err_h:.3e} (rtol {htol[0]}, atol {htol[1]}){scaled}")
        del y, hT, want_y, want_h
        labels = {path: "path", train: "training", long: "prefill_32k",
                  zamba_long: "zamba2-1.2b prefill_32k"}
        if shape not in labels or dtype != bf16:
            continue
        t = timed_turns(
            torch, {"plain": lambda: ref.ssd(x, dt, A, B, C),
                    "kernel": lambda: ops.ssd(x, dt, A, B, C)},
            {"plain": 3, "kernel": 10}, flush=flush_buf.zero_)
        flops = ssd_work(*shape)
        nbytes = (2 * x.numel() + B.numel() + C.numel()) * x.element_size() \
            + (dt.numel() + A.numel()) * 4
        bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
        backward = ""
        if shape == train:
            _, b_ms = forward_and_backward_ms(
                torch, ops.ssd, [x.clone(), dt.clone(), A.clone(), B.clone(),
                                 C.clone()], g)
            backward = f", plain backward {b_ms:.4f} ms"
        print(f"[kernel] ssd_scan {labels[shape]} "
              f"shape {shape} bf16: kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms{backward}, library none, bound "
              f"{bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB, "
              f"{flops:.3e} FLOP at the bf16 peak), roofline "
              f"{bound_ms / t['kernel']:.1%}")
        if shape != path:
            continue
        entry = {"name": "ssd_scan", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "replaces": "src/repro/kernels/ssd_scan/kernel.py:25",
                 "max_abs_err": err, "ms": t["kernel"],
                 "plain_ms": t["plain"], "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None}
    del flush_buf
    return entry


def gmm_bound(x, eo, w) -> tuple[float, str]:
    """Bound of one grouped product: 2·rows·D·F operations at the peak of
    x's type; bytes of x, the routing, the experts this routing hits and y,
    each once."""
    rows, D = x.shape
    F = w.shape[2]
    hit = int(eo.unique().numel())
    nbytes = (rows * (D + F) * x.element_size()
              + eo.numel() * eo.element_size()
              + hit * D * F * w.element_size())
    peak = F32_PEAK if x.element_size() == 4 else BF16_PEAK
    return bound(2.0 * rows * D * F, nbytes, peak)


def grouped_mm_call(torch, x, eo, w):
    """``torch._grouped_mm`` on the same rows sorted by expert, bf16 (the
    yardstick; the port never calls it), or (None, why not)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "this PyTorch has no torch._grouped_mm"
    order = torch.argsort(eo, stable=True)
    xs = x[order].bfloat16().contiguous()
    counts = torch.zeros(w.shape[0], dtype=torch.long, device=x.device) \
        .scatter_add_(0, eo.long(), torch.ones_like(eo, dtype=torch.long))
    offs = torch.cumsum(counts, 0).to(torch.int32)
    wb = w.bfloat16()
    try:
        fn(xs, wb, offs=offs)
        torch.cuda.synchronize()
    except Exception as exc:  # a refused layout is reported, not fatal
        return None, f"torch._grouped_mm refused: {exc}"[:200]
    return (lambda: fn(xs, wb, offs=offs)), ""


def check_moe_gmm(torch, dev) -> dict:
    """The grouped-matmul kernel against its plain version: deepseek-moe-16b's
    products at its forward shape (8192 tokens, top-6 of 64 experts, D 2048
    → F 1408 and the down product F → D; f32 weights) with uniform and
    one-expert routing, a decode step's 24 rows, phi3.5-moe's products with
    bf16 weights (8192 tokens, top-2 of 16, D 4096 → F 6400 and back; the
    tensor cores' bf16-w instance) and a decode step of 4 slots, and the
    reference tests' shapes; times at deepseek's forward and decode shapes
    and phi's gate/up shape."""
    from repro_torch.kernels.moe_gmm import kernel, ops, ref
    flush_buf = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    up, down = (8192, 6, 64, 2048, 1408, 128), (8192, 6, 64, 1408, 2048, 128)
    dec = (4, 6, 64, 2048, 1408, 128)
    phi_up, phi_down = ((8192, 2, 16, 4096, 6400, 128),
                        (8192, 2, 16, 6400, 4096, 128))
    phi_dec = (4, 2, 16, 4096, 6400, 128)
    # (shape (T, k, E, D, F, tile_m), x dtype, w dtype, routing, timed).
    # Tolerances: bf16 x rtol 1e-2 and 1e-2 of max|y| (both sides sum in
    # f32 and round y once: a flip is one bf16 ulp); f32 at D >= 1408 rtol
    # 1e-4 and 1e-4 of max|y| (sums of 2048 products in another order); the
    # reference tests' shapes rtol = atol = 1e-5, their own gate
    cases = [(up, bf16, f32, "uniform", True),
             (down, bf16, f32, "uniform", True),
             (up, f32, f32, "uniform", False),
             (down, f32, f32, "uniform", False),
             (up, bf16, f32, "one expert", False),
             (dec, bf16, f32, "uniform", True),
             # phase 23's phi3.5-moe: bf16 x and bf16 w (tc::launch<bf16>)
             (phi_up, bf16, bf16, "uniform", True),
             (phi_down, bf16, bf16, "uniform", False),
             (phi_up, bf16, bf16, "one expert", False),
             (phi_down, bf16, bf16, "one expert", False),
             (phi_dec, bf16, bf16, "uniform", False),
             # a rank of phase 21's mesh: 32 of the 64 experts held, the
             # rows of the other 32 (ids >= 32) skipped and left 0
             ((8192, 6, 64, 2048, 1408, 128), bf16, f32, "half held", False),
             ((4, 6, 64, 1408, 2048, 128), bf16, f32, "uniform", False),
             ((64, 1, 4, 16, 32, 16), f32, f32, "uniform", False),
             ((200, 1, 8, 32, 64, 16), f32, f32, "uniform", False),
             ((33, 1, 2, 8, 16, 8), f32, f32, "uniform", False),
             ((32, 1, 4, 8, 16, 8), f32, f32, "one expert", False),
             # 33,600 row tiles: past the 65,535 row blocks of a grid.y
             ((4_300_000, 1, 8, 16, 16, 128), bf16, f32, "uniform", False),
             ((4_300_000, 1, 8, 16, 16, 128), f32, f32, "uniform", False)]
    entry = None
    for (T, k, E, D, F, tile), dtype, w_dtype, routing, timed in cases:
        x = torch.randn(T * k, D, generator=g, device=dev).to(dtype)
        eo = torch.randint(0, E, (T * k,), generator=g, device=dev)
        if routing == "one expert":
            eo.fill_(E // 2)
        w = (torch.randn(E, D, F, generator=g, device=dev)
             / D ** 0.5).to(w_dtype)
        if routing == "half held":
            w = w[:E // 2].contiguous()
        got = ops.moe_apply(x, eo, w, tile_m=tile)
        want = ref.gmm(x, eo, w)
        far = eo >= w.shape[0]
        check(not got[far].any(), f"moe_gmm {routing}: a row of no held "
              "expert is not 0")
        scale = float(want.float().abs().max())
        rtol, atol = ((1e-2, 1e-2 * scale) if dtype == bf16 else
                      (1e-5, 1e-5) if D <= 32 else (1e-4, 1e-4 * scale))
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        excess = float((diff - (atol + rtol * want.float().abs())).max())
        check(excess <= 0, f"moe_gmm T={T} k={k} E={E} D={D} F={F} {dtype} "
                           f"{routing}: outside rtol {rtol} / atol {atol} "
                           f"by {excess}")
        route = "tensor cores" if dtype == bf16 else "FMA"
        types = f"x {str(dtype)[6:]} ({route}), w {str(w_dtype)[6:]}"
        print(f"[kernel] moe_gmm rows={T * k} ({T} x top-{k}) E={E} D={D} "
              f"F={F} tile_m={tile} {types}, {routing}: max|diff| "
              f"{err:.3e} (rtol {rtol:.0e}, atol {atol:.3e})")
        del got, want, diff
        if not timed:
            continue
        lib, why = grouped_mm_call(torch, x, eo, w)
        # the launch alone, routed as the op routes it (torch._grouped_mm
        # is timed on rows already sorted)
        te, te_rows, row_src = ops.route(eo, E, tile)
        y_l = torch.empty((T * k, F), dtype=x.dtype, device=dev)
        fns = {"plain": lambda: ref.gmm(x, eo, w),
               "kernel": lambda: ops.moe_apply(x, eo, w),
               "launch": lambda: kernel.launch(x, te, te_rows, row_src, w,
                                               y_l, tile)}
        if lib is not None:
            fns["library"] = lib
        t = timed_turns(torch, fns, {"plain": 3, "kernel": 5, "launch": 10,
                                     "library": 10}, flush=flush_buf.zero_)
        bound_ms, bound_by = gmm_bound(x, eo, w)
        flops = 2.0 * T * k * D * F
        print(f"[kernel] moe_gmm rows={T * k} D={D} F={F} {types}: kernel "
              f"{t['kernel']:.4f} ms as the op, routing included "
              f"({flops / t['kernel'] / 1e9:.1f} TFLOP/s); the launch alone "
              f"{t['launch']:.4f} ms ({flops / t['launch'] / 1e9:.1f} "
              f"TFLOP/s), plain {t['plain']:.4f} ms, library"
              + (f"(torch._grouped_mm, bf16 w) {t['library']:.4f} ms"
                 if lib is not None else f" none ({why})")
              + f", bound {bound_ms:.4f} ms ({bound_by}; {flops:.3e} FLOP, "
              f"{int(eo.unique().numel())} experts hit), roofline "
              f"{bound_ms / t['kernel']:.1%}")
        if entry is None:  # the forward's gate/up product
            entry = {"name": "moe_gmm", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
                     "replaces": "src/repro/kernels/moe_gmm/kernel.py:25",
                     "max_abs_err": err, "ms": t["kernel"],
                     "plain_ms": t["plain"], "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "library_ms": t.get("library")}
        del lib, fns, y_l, te, te_rows, row_src
    del flush_buf
    return entry


def check_kernel_grads(torch, dev, entries) -> None:
    """Each of the four kernel ops under grad mode on the card: one launch
    forward, and gradients equal to its plain version's (the same inputs
    and cotangent through ``torch.autograd`` of the plain version on the
    card) within the op's forward tolerance; under ``no_grad`` it launches
    and builds no graph.  Then the plain backward (the recompute and its
    gradient, what the op's backward runs) is timed beside the kernel's
    forward at the shapes phase 1 timed, and the flash op's also at the
    qwen2 training shape (4, 14, 2, 1024, 1024, 64), all in bf16 but the
    stencil (f32 EDGE5)."""
    import numpy as np
    from repro_torch.kernels.flash_attention import ops as fa, ref as fa_ref
    from repro_torch.kernels.moe_gmm import ops as gmm, ref as gmm_ref
    from repro_torch.kernels.ssd_scan import ops as ssd, ref as ssd_ref
    from repro_torch.kernels.stencil import ops as st, ref as st_ref
    from repro_torch.workloads import EDGE5
    g = torch.Generator().manual_seed(3)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dtype).to(dev)

    eo = torch.randint(0, 4, (32,), generator=g).to(dev)
    taps = st.taps_of(np.arange(9.0).reshape(3, 3) / 9)
    # op: (counter, op, plain, inputs, forward tolerance)
    cases = {
        "mha": (fa.mha, fa.mha, fa_ref.mha,
                (rnd(2, 4, 40, 32, scale=0.5), rnd(2, 2, 40, 32, scale=0.5),
                 rnd(2, 2, 40, 32)), 2e-4),
        "ssd": (ssd.ssd, lambda *t: ssd.ssd(*t, chunk=16),
                lambda *t: ssd_ref.ssd(*t, chunk=16),
                (rnd(1, 40, 2, 8), (torch.rand(1, 40, 2, generator=g)
                                    * 0.2).to(dev),
                 (-torch.rand(2, generator=g) - 0.1).to(dev),
                 rnd(1, 40, 1, 4, scale=0.3), rnd(1, 40, 1, 4, scale=0.3)),
                2e-4),
        "moe_apply": (gmm.moe_apply, lambda x, w: gmm.moe_apply(x, eo, w),
                      lambda x, w: gmm_ref.gmm(x, eo, w),
                      (rnd(32, 32), rnd(4, 32, 16, scale=0.2)), 1e-5),
        "stencil2d": (st.stencil2d, lambda t: st.stencil2d(t, taps),
                      lambda t: st_ref.stencil2d(t, taps), (rnd(48, 40),),
                      1e-5)}
    for name, (counter, op, plain, inputs, tol) in cases.items():
        ours = [t.clone().requires_grad_() for t in inputs]
        theirs = [t.clone().requires_grad_() for t in inputs]
        before = counter.launches
        out = op(*ours)
        check(counter.launches == before + 1 and out.grad_fn is not None,
              f"{name}: {counter.launches - before} launches under grad "
              "mode, or no graph")
        want = plain(*theirs)
        cot = torch.randn(out.shape, generator=g).to(dev)
        got_g = torch.autograd.grad((out * cot).sum(), ours)
        want_g = torch.autograd.grad((want * cot).sum(), theirs)
        check(counter.launches == before + 1,
              f"{name}: the backward launched the kernel")
        err = max(float((a - b).abs().max()) for a, b in zip(got_g, want_g))
        scale = max(float(b.abs().max()) for b in want_g)
        check(err <= tol * max(1.0, scale),
              f"{name}: grads differ from the plain version's by {err} > "
              f"{tol} x max(1, {scale})")
        with torch.no_grad():
            out = op(*ours)
        check(counter.launches == before + 2 and not out.requires_grad,
              f"{name}: under no_grad: launches or a graph")
        print(f"[grad] {name}: one launch under grad mode, backward through "
              f"the plain version; grads max|diff| {err:.3e} vs the plain "
              f"version's autograd on the card (gate {tol} x max(1, "
              f"{scale:.3e})); no_grad: a launch, no graph")

    def timed(label, fwd, inputs):
        f_ms, b_ms = forward_and_backward_ms(torch, fwd, inputs, g)
        print(f"[grad] {label}: kernel forward {f_ms:.4f} ms, plain "
              f"backward {b_ms:.4f} ms ({b_ms / f_ms:.1f} x)")
        return f_ms, b_ms

    bf16 = torch.bfloat16
    by_name = {e["name"]: e for e in entries}
    for S in (1024, 2048):
        B, H, K, D = 4, 14, 2, 64
        f_ms, b_ms = timed(
            f"flash_attention ({B}, {H}, {K}, {S}, {S}, {D}) bf16 causal"
            + (" (the qwen2 training shape)" if S == 1024 else
               " (phase 1's timed shape)"), fa.mha,
            [rnd(B, H, S, D, scale=0.3, dtype=bf16),
             rnd(B, K, S, D, scale=0.3, dtype=bf16),
             rnd(B, K, S, D, dtype=bf16)])
        if S == 1024:
            by_name["flash_attention"]["train_shape"] = (f_ms, b_ms)
    b, S, H, P, G, N = 4, 2048, 80, 64, 1, 128
    timed(f"ssd_scan ({b}, {S}, {H}, {P}, {G}, {N}) bf16 (phase 1's timed "
          "shape)", ssd.ssd,
          [rnd(b, S, H, P, dtype=bf16),
           (torch.rand(b, S, H, generator=g) * 0.1).to(dev),
           (-torch.rand(H, generator=g) - 0.1).to(dev),
           rnd(b, S, G, N, scale=0.3, dtype=bf16),
           rnd(b, S, G, N, scale=0.3, dtype=bf16)])
    T, D, F = 8192 * 6, 2048, 1408
    eo_up = torch.randint(0, 64, (T,), generator=g).to(dev)
    timed(f"moe_gmm up ({T} rows, 64 experts, {D} -> {F}) bf16 (phase 1's "
          "timed shape)", lambda x, w: gmm.moe_apply(x, eo_up, w),
          [rnd(T, D, dtype=bf16), rnd(64, D, F, scale=D ** -0.5)])
    timed("stencil 2048 x 2048 f32 EDGE5 (phase 1's timed shape)",
          lambda t: st.stencil2d(t, st.taps_of(EDGE5)),
          [rnd(2048, 2048)])


def forward_and_backward_ms(torch, fwd, inputs, g) -> tuple:
    """(ms of the kernel op ``fwd``'s forward without a graph, ms of its
    backward: the plain version's recompute and gradient) on ``inputs``,
    made leaves that need their gradients, with a cotangent drawn from
    ``g``."""
    leaves = [t.requires_grad_() for t in inputs]
    out = fwd(*leaves)
    cot = torch.randn(out.shape, generator=g).to(out.dtype).to(out.device)
    args = [t for t in leaves if t.dtype.is_floating_point]

    def backward():
        torch.autograd.grad(out, args, cot, retain_graph=True)

    def forward():
        with torch.no_grad():
            fwd(*leaves)

    return event_ms(torch, forward, 5), event_ms(torch, backward, 3)


def event_ms(torch, fn, reps: int) -> float:
    """Median ms of ``fn`` over ``reps`` calls, each between two CUDA
    events, after one warm-up call."""
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
    return statistics.median(times)


def check_widened(torch, dev) -> None:
    """What the kernel ops once refused on the card, each call one launch
    held to its plain version: float16 flash attention (at D = 48, padded
    to 64, and at the qwen2 forward's shape), a strided head dim and bf16
    rows that are not 16-byte aligned (copied once); the float16 SSD scan
    with bf16 dt and A (cast to f32) and strided P and N, and S = 0 (no
    launch); the float16 grouped matmul with f32, bf16 and f16 w, and a
    strided w; bool and transposed stencil images.  float16 is timed at
    the main path's shapes beside the plain version (no repo config
    computes in f16: untuned).  Tolerances: flash f16 5e-3 (the plain
    version rounds its probabilities to f16, one f16 ulp of o), SSD and
    grouped-matmul f16 2e-3 and 2e-3 of max|want| (two f16 ulps once the
    f32 sums round), bf16 flash the reference's 5e-2."""
    from repro_torch.kernels.flash_attention import ops as fa, ref as fa_ref
    from repro_torch.kernels.moe_gmm import ops as gmm, ref as gmm_ref
    from repro_torch.kernels.ssd_scan import ops as ssd, ref as ssd_ref
    from repro_torch.kernels.stencil import ops as st, ref as st_ref
    flush_buf = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator().manual_seed(8)
    f16, bf16 = torch.float16, torch.bfloat16

    def one_launch(fn, call, label):
        before = fn.launches
        out = call()
        torch.cuda.synchronize()
        check(fn.launches == before + 1,
              f"{label}: {fn.launches - before} launches, not 1")
        return out

    def close(got, want, rtol, atol, label):
        diff = (got.float() - want.float()).abs()
        excess = float((diff - (atol + rtol * want.float().abs())).max())
        check(excess <= 0, f"{label}: outside rtol {rtol} / atol {atol} by "
                           f"{excess}")
        print(f"[kernel] {label}: one launch, max|diff| "
              f"{float(diff.max()):.3e} (rtol {rtol}, atol {atol:.3e})")

    def timed(label, plain, kernel, flops, nbytes):
        t = timed_turns(torch, {"plain": plain, "kernel": kernel},
                        {"plain": 3, "kernel": 10}, flush=flush_buf.zero_)
        bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
        print(f"[kernel] {label} f16: kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"roofline {bound_ms / t['kernel']:.1%}")

    # flash attention
    for (B, H, K, S, D), dtype in (((2, 4, 2, 70, 48), f16),
                                   ((4, 14, 2, 2048, 64), f16),
                                   ((1, 2, 1, 50, 200), torch.float32)):
        q = (torch.randn(B, H, S, D, generator=g) * 0.3).to(dtype).to(dev)
        k = (torch.randn(B, K, S, D, generator=g) * 0.3).to(dtype).to(dev)
        v = torch.randn(B, K, S, D, generator=g).to(dtype).to(dev)
        label = f"flash_attention ({B}, {H}, {K}, {S}, {S}, {D}) {dtype}"
        got = one_launch(fa.mha, lambda: fa.mha(q, k, v), label)
        tol = 5e-3 if dtype == f16 else 2e-4
        close(got, fa_ref.mha(q, k, v), tol, tol, label)
        if S == 2048:
            pairs = B * H * S * (S + 1) // 2
            timed("flash_attention qwen2-0.5b shape",
                  lambda: fa_ref.mha(q, k, v), lambda: fa.mha(q, k, v),
                  4.0 * D * pairs,
                  (2 * q.numel() + k.numel() + v.numel()) * 2)
    base = torch.randn(1, 2, 40, 68, generator=g).to(bf16).to(dev)
    for t, what in ((base[..., :64], "seq stride 68"),
                    (base[..., 1:65], "base 2 bytes off 16")):
        label = f"flash_attention bf16 unaligned rows ({what})"
        got = one_launch(fa.mha, lambda: fa.mha(t, t, t), label)
        close(got, fa_ref.mha(t, t, t), 5e-2, 5e-2, label)
    v = torch.randn(1, 2, 40, 64, 2, generator=g).to(dev)[..., 0]
    label = "flash_attention f32 head dim stride 2"
    got = one_launch(fa.mha, lambda: fa.mha(v, v, v), label)
    close(got, fa_ref.mha(v, v, v), 2e-4, 2e-4, label)
    # the SSD scan
    for (b, S, H, P, G, N) in ((2, 300, 4, 64, 1, 128),
                               (4, 2048, 80, 64, 1, 128)):
        x = torch.randn(b, S, H, P, generator=g).to(f16).to(dev)
        dt = (torch.rand(b, S, H, generator=g) * 0.1).to(bf16).to(dev)
        A = (-torch.rand(H, generator=g) - 0.1).to(bf16).to(dev)
        Bm = (torch.randn(b, S, G, N, generator=g) * 0.3).to(f16).to(dev)
        Cm = (torch.randn(b, S, G, N, generator=g) * 0.3).to(f16).to(dev)
        want = ssd_ref.ssd(x, dt, A, Bm, Cm)
        scale = float(want.float().abs().max())
        label = f"ssd_scan ({b}, {S}, {H}, {P}, {G}, {N}) f16, bf16 dt"
        got = one_launch(ssd.ssd, lambda: ssd.ssd(x, dt, A, Bm, Cm), label)
        close(got, want, 2e-3, 2e-3 * scale, label)
        if S == 2048:
            nbytes = (2 * x.numel() + Bm.numel() + Cm.numel()) * 2 \
                + (dt.numel() + A.numel()) * 2
            timed("ssd_scan mamba2-2.7b shape",
                  lambda: ssd_ref.ssd(x, dt, A, Bm, Cm),
                  lambda: ssd.ssd(x, dt, A, Bm, Cm),
                  ssd_work(b, S, H, P, G, N), nbytes)
        else:
            xs, Bs = (torch.empty(*t.shape, 2, dtype=t.dtype, device=dev)
                      [..., 0].copy_(t) for t in (x, Bm))  # strides 2
            label = label + ", strided P and N"
            got = one_launch(ssd.ssd, lambda: ssd.ssd(xs, dt, A, Bs, Cm),
                             label)
            close(got, want, 2e-3, 2e-3 * scale, label)
            before = ssd.ssd.launches
            y0, h0 = ssd.ssd(x[:, :0], dt[:, :0], A, Bm[:, :0], Cm[:, :0],
                             return_state=True)
            check(ssd.ssd.launches == before and y0.shape == (b, 0, H, P)
                  and h0.shape == (b * H, N, P) and not bool(h0.any()),
                  "ssd_scan S = 0: not an empty y and a zero state")
            print("[kernel] ssd_scan S = 0: empty y, zero state, no launch")
    # the grouped matmul
    T, k, E, D, F, tile = 8192, 6, 64, 2048, 1408, 128
    x = torch.randn(T * k, D, generator=g).to(f16).to(dev)
    eo = torch.randint(0, E, (T * k,), generator=g).to(dev)
    w32 = (torch.randn(E, D, F, generator=g) / D ** 0.5).to(dev)
    for w, what in ((w32, "f32 w"), (w32.to(bf16), "bf16 w"),
                    (w32.to(f16), "f16 w"),
                    (w32.transpose(1, 2).contiguous().transpose(1, 2),
                     "strided f32 w")):
        want = gmm_ref.gmm(x, eo, w)
        label = f"moe_gmm rows={T * k} D={D} F={F} f16 x, {what}"
        got = one_launch(gmm.moe_apply, lambda: gmm.moe_apply(x, eo, w),
                         label)
        close(got, want, 2e-3, 2e-3 * float(want.float().abs().max()),
              label)
        del got, want
        if what == "f16 w":
            nbytes = T * k * (D + F) * 2 + eo.numel() * 8 + E * D * F * 2
            timed("moe_gmm deepseek-moe-16b up shape",
                  lambda: gmm_ref.gmm(x, eo, w),
                  lambda: gmm.moe_apply(x, eo, w), 2.0 * T * k * D * F,
                  nbytes)
    # the stencil
    img = torch.randn(2048, 2048, generator=g).to(dev)
    taps = st.taps_of(torch.randn(5, 5, generator=g))
    for x, what in ((img.t(), "transposed f32"), (img > 0.5, "bool"),
                    ((img > 0.5).t(), "transposed bool")):
        label = f"stencil (2048, 2048) k=5 {what}"
        got = one_launch(st.stencil2d, lambda: st.stencil2d(x, taps), label)
        check(got.dtype == x.dtype and torch.equal(got, st_ref.stencil2d(
            x, taps)), f"{label}: not exact")
        print(f"[kernel] {label}: one launch, exact")
    del flush_buf


def tensor_core_instructions(torch, name: str) -> int:
    """HMMA (mma.sync) and HGMMA (wgmma) lines in the SASS of a built
    kernel library, by ``cuobjdump -sass``."""
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return sum("HMMA" in ln or "HGMMA" in ln for ln in sass.splitlines())


def entry_name(mangled: str) -> str:
    """The head of a mangled entry function's name without its anonymous
    namespace (``_ZN<n>_GLOBAL__N_...``, n characters long), e.g.
    ``2tc16flash_mma_kernelILi256EEEvPK13__nv_bf``."""
    m = re.match(r"_ZN(\d+)_GLOBAL__N_", mangled)
    if m:
        mangled = mangled[3 + len(m.group(1)) + int(m.group(1)):]
    return mangled[:44]


def build_kernels(torch, names) -> None:
    """Build ``names`` with one ``nvcc`` each, all at once; print ptxas's
    registers and any spill of each entry function, and the tensor-core
    instructions of the bf16 libraries' SASS, which must be above 0."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all(names)
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, in parallel)")
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = entry_name(line.split("'")[1])
            elif "registers" in line or re.search(r"[1-9]\d* bytes spill",
                                                  line):
                print(f"  {name} {entry}: {line.strip()}")
    for name in ("flash_attention", "moe_gmm", "ssd_scan"):  # bf16 paths
        if name not in names:
            continue
        n = tensor_core_instructions(torch, name)
        print(f"sass: {name}: {n} tensor-core instructions (HMMA/HGMMA "
              "lines of cuobjdump -sass)")
        check(n > 0, f"{name}: no tensor-core instruction in its SASS")


# -- phases 2-5: the main path ----------------------------------------------------

def three_modes(torch, net, n, mb, counts, kernel):
    """(sequential, fused, streaming) results; checks that ``kernel`` (if
    any) launched in every mode."""
    from repro_torch.core import build, run_sequential
    out = []
    cn = build(net)
    for mode, run in (("sequential", lambda: run_sequential(net, n)),
                      ("fused", lambda: cn.run(instances=n)),
                      ("streaming", lambda: cn.run_streaming(
                          instances=n, microbatch_size=mb))):
        before = counts()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in counts().items()}
        if kernel is not None:
            check(launched[kernel] > 0, f"{net.name} {mode}: {kernel} "
                                        "kernel never launched")
        print(f"[{net.name}] {mode}: {wall * 1e3:.1f} ms host wall, "
              f"launches {launched}")
        out.append(res)
    print(f"[{net.name}] {cn.stream_stats.summary()}")
    return out


def run_farm(torch, counts, W, H, bands, iters):
    import numpy as np
    from repro_torch import workloads
    net = workloads.mandelbrot_farm(width=W, height=H, bands=bands,
                                    iterations=iters)
    imgs = [workloads.assemble(r["collect"])
            for r in three_modes(torch, net, bands, 16, counts, "mandelbrot")]
    check(all(np.array_equal(imgs[0], im) for im in imgs[1:]),
          "mandelbrot farm: sequential, fused and streaming differ")
    img = imgs[0]
    check(img.shape == (H, W) and img.min() >= 0 and img.max() == iters,
          f"mandelbrot farm: image {img.shape} in [{img.min()}, {img.max()}]")
    print(f"[mandelbrot] sequential == fused == streaming: True; image "
          f"{img.shape}, {int((img == iters).sum())} interior pixels")
    return net, img


def run_pipeline(torch, dev, counts, n, size):
    import numpy as np
    from repro_torch import workloads
    from repro_torch.interop import tree_from_numpy
    from repro_torch.kernels.stencil import ref
    imgs = tree_from_numpy(workloads.synthetic_images(n, size), dev)
    net = workloads.image_pipeline(imgs)
    outs = [r["collector"]
            for r in three_modes(torch, net, n, 4, counts, "stencil")]
    check(all(np.array_equal(a, b) for o in outs[1:]
              for a, b in zip(outs[0], o)),
          "image pipeline: sequential, fused and streaming differ")
    grey = imgs[0] @ torch.tensor(workloads.GREY, device=dev)
    want = ref.stencil2d(grey, workloads.EDGE5).cpu().numpy()
    check(np.array_equal(outs[0][0], want),
          "image pipeline: image 0 differs from the plain stencil")
    edges = int((np.abs(outs[0][0]) > 1.0).sum())
    check(edges > 0, "image pipeline: no edges found")
    print(f"[image] sequential == fused == streaming: True; {n} images of "
          f"{size}x{size}; {edges} edge pixels in image 0")
    return net, outs[0]


def run_jacobi(torch, dev, counts, n_systems, n, nodes, tol):
    import numpy as np
    from repro_torch import workloads
    from repro_torch.interop import tree_from_numpy
    systems, truths = workloads.jacobi_systems(n_systems, n)
    net = workloads.jacobi(tree_from_numpy(systems, dev), n=n, nodes=nodes,
                           tol=tol)
    outs = [r["collector"]
            for r in three_modes(torch, net, n_systems, 2, counts, None)]
    check(all(np.array_equal(a, b) for o in outs[1:]
              for a, b in zip(outs[0], o)),
          "jacobi: sequential, fused and streaming differ")
    errs = [float(np.max(np.abs(x - t))) for x, t in zip(outs[0], truths)]
    check(max(errs) < 1e-3, f"jacobi: max|x - x_true| = {max(errs)}")
    print(f"[jacobi] {n_systems} systems n={n}, {nodes} nodes, tol={tol}: "
          f"max|x - x_true| = {max(errs):.2e} (OK < 1e-3)")


def run_pi(torch, counts, instances, points):
    from repro_torch import workloads
    from repro_torch.core import build, csp, netlog
    explicit = workloads.monte_carlo_pi(instances=instances, points=points,
                                        workers=2, explicit=True)
    r = csp.check(explicit, instances=3)
    print(f"[csp] states={r.n_states} deadlock_free={r.deadlock_free} "
          f"divergence_free={r.divergence_free} "
          f"deterministic={r.deterministic} "
          f"terminates={r.all_paths_terminate}")
    check(r.deadlock_free and r.deterministic and r.all_paths_terminate,
          "csp: the explicit pi farm failed its checks")
    net = workloads.monte_carlo_pi(instances=instances, points=points,
                                   workers=4)
    pis = [float(r["collect"])
           for r in three_modes(torch, net, instances, 32, counts, None)]
    check(pis[0] == pis[1] == pis[2], f"pi: modes differ {pis}")
    p = math.pi / 4
    sigma = 4 * math.sqrt(p * (1 - p) / (instances * points))
    check(abs(pis[0] - math.pi) < 4 * sigma,
          f"pi: {pis[0]} is more than 4 sigma from pi")
    print(f"[pi] sequential == fused == streaming: {pis[0]!r} "
          f"(|pi - estimate| = {abs(pis[0] - math.pi):.2e}, "
          f"sigma {sigma:.2e})")
    cn = build(net)
    cn.run(instances=instances, logged=True)
    print(netlog.report(cn))


# -- phase 12: the cluster on the card ------------------------------------------------

def checked_farm(width, height, bands, iterations):
    """The Mandelbrot farm as a spawned host process rebuilds it, its worker
    checking inside that process that each band launched the process's own
    Mandelbrot kernel exactly once and is a CUDA tensor (else the band
    raises, and the batch fails with ``ClusterError``)."""
    from repro_torch import workloads
    from repro_torch.core.dataflow import Kind
    from repro_torch.kernels.mandelbrot import ops
    net = workloads.mandelbrot_factory(width, height, bands, iterations)
    (worker,) = [p for p in net.procs.values() if p.kind is Kind.WORKER]
    render = worker.fn

    def render_checked(row0):
        before = ops.mandelbrot.launches
        row, band = render(row0)
        if ops.mandelbrot.launches != before + 1 or not band.is_cuda:
            raise RuntimeError(
                f"host process: band {int(row0)} launched "
                f"{ops.mandelbrot.launches - before} kernels, on "
                f"{band.device}")
        return row, band

    worker.fn = render_checked
    return net


def run_deployment(torch, label, net, plan, transport, factory, n, batches,
                   counts, kernel, per_batch, same_as, microbatch=16,
                   after=None):
    """One warm ``ClusterDeployment``: refinement, ``batches`` batches each
    checked by ``same_as`` and by the parent's ``kernel`` launches
    (``per_batch``), the walls, the bytes crossing the cut a batch and,
    over the shared-memory ring, each batch's chunks by path (every chunk
    must go through a slot); then ``after(dep)`` (its output replaces the
    last batch's in the report), and no host process and no ``/dev/shm``
    segment left after the close.  Prints the cluster report.  Returns the
    walls in ms (start, then one a batch)."""
    from repro_torch.cluster import ClusterDeployment, check_refinement
    from repro_torch.cluster.transport import SharedMemoryRing
    from repro_torch.core import netlog
    refined = check_refinement(net, plan)
    check(refined, f"[cluster] {label}: partitioned network does not refine")
    print(f"[cluster] {label}: partitioned [T= unpartitioned (CSP, both "
          f"directions): {refined}; cut "
          f"{[f'{c.src}->{c.dst}' for c in plan.cut]}")
    ring = transport if isinstance(transport, SharedMemoryRing) else None
    n_chunks = -(-n // microbatch)
    t0 = time.perf_counter()
    dep = ClusterDeployment(net, plan=plan, transport=transport,
                            microbatch_size=microbatch, factory=factory,
                            timeout_s=300)
    with dep:
        walls = [(time.perf_counter() - t0) * 1e3]
        for b in range(batches):
            before = counts()[kernel]
            t0 = time.perf_counter()
            out = dep.run(instances=n)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            launched = counts()[kernel] - before
            check(same_as(out), f"[cluster] {label}: batch {b} differs "
                                "from the single-host run")
            check(launched == per_batch,
                  f"[cluster] {label}: batch {b} launched {launched} "
                  f"{kernel} kernels in this process, not {per_batch}")
            sent = sum(v for r in out.reports
                       for v in r.metrics.get("sent_bytes", {}).values())
            paths = ""
            if ring is not None:
                by_path = [v for r in out.reports
                           for v in r.metrics.get("ring", {}).values()]
                slots, inline = (sum(v[i] for v in by_path) for i in (0, 1))
                check(inline == 0 and slots == n_chunks * len(plan.cut),
                      f"[cluster] {label}: batch {b} sent {slots} chunks "
                      f"through a slot and {inline} inline, not "
                      f"{n_chunks * len(plan.cut)} and 0")
                paths = f", ring chunks: {slots} through a slot, {inline} " \
                        "inline"
            print(f"[cluster] {label}: batch {b} "
                  f"({'cold' if b == 0 else 'warm'}) {walls[-1]:.1f} ms, "
                  f"exact: True, {kernel} launches here {launched}, cut "
                  f"bytes {sent}{paths}, stage builds "
                  f"{sum(r.jit_builds for r in out.reports)}")
        if after is not None:
            out = after(dep)
        procs = list(dep.controller._procs.values())
        names = ring.owned_names() if ring is not None else []
    check(not any(p.is_alive() for p in procs),
          f"[cluster] {label}: a host process outlived the deployment")
    if ring is not None:
        check_unlinked(ring, names, label)
    print(netlog.cluster_report(dep.plan, out.reports, events=dep.events))
    print(f"[cluster] {label}: start {walls[0]:.1f} ms, cold batch "
          f"{walls[1]:.1f} ms, warm batches "
          f"{', '.join(f'{w:.1f}' for w in walls[2:])} ms")
    return walls


def check_unlinked(ring, names, label) -> None:
    """Every ``/dev/shm`` segment the ring created is gone after close."""
    from multiprocessing import shared_memory
    check(bool(names) and not ring.owned_names(),
          f"[cluster] {label}: the ring still owns segments")
    for name in names:
        try:
            shared_memory.SharedMemory(name=name).close()
        except FileNotFoundError:
            continue
        raise SmokeFailure(f"[cluster] {label}: /dev/shm segment {name} "
                           "left after close")
    print(f"[cluster] {label}: {len(names)} /dev/shm segments unlinked")


def shm_free_bytes() -> int:
    st = os.statvfs("/dev/shm")
    return st.f_bavail * st.f_frsize


def kill_and_recover(torch, dep, label, farm_img, bands):
    """On a warm farm deployment over 2 process hosts: SIGKILL host 1 (the
    Collect's); the next batch fails with the dead host found, and
    ``recover(mode="restart")`` respawns it and replays the batch, which
    must equal phase 2's image bit for bit, at epoch >= 2, with host 1
    named as restarted and the plan re-proved.  Returns the replay's
    output."""
    import numpy as np
    from repro_torch import workloads
    from repro_torch.cluster import ClusterError
    label = f"{label} kill"
    t_kill = time.perf_counter()
    dep.kill_host(1)
    try:
        dep.run(instances=bands)
    except ClusterError as exc:
        dead = [r.host for r in exc.reports if not r.ok
                and "died" in (r.error or "")]
        check(dead == [1], f"[cluster] {label}: dead hosts {dead}")
    else:
        raise SmokeFailure(f"[cluster] {label}: a batch ran with host 1 "
                           "killed")
    t_detect = time.perf_counter()
    out = dep.recover(mode="restart")
    torch.cuda.synchronize()
    t_done = time.perf_counter()
    check(np.array_equal(workloads.assemble(out["collect"]), farm_img),
          f"[cluster] {label}: the replayed batch differs from phase 2")
    (ev,) = dep.events
    check(dep.epoch >= 2 and ev.restarted == [1] and ev.dead == [1]
          and ev.refined is True,
          f"[cluster] {label}: recovery event {ev.describe()}")
    print(f"[cluster] {label}: {ev.describe()}")
    print(f"[cluster] {label}: kill -> failure found "
          f"{(t_detect - t_kill) * 1e3:.1f} ms, recover() (restart + replay) "
          f"{(t_done - t_detect) * 1e3:.1f} ms, kill -> replayed result "
          f"{(t_done - t_kill) * 1e3:.1f} ms; replay exact: True, epoch "
          f"{dep.epoch}")
    return out


def failing_farm(args, state: dict):
    """The farm whose worker raises once, on the first band of batch 1
    (a transient host failure), before it launches anything."""
    from repro_torch import workloads
    from repro_torch.core.dataflow import Kind
    net = workloads.mandelbrot_factory(*args)
    (worker,) = [p for p in net.procs.values() if p.kind is Kind.WORKER]
    render = worker.fn

    def render_once_failing(row0):
        state["calls"] = state.get("calls", 0) + 1
        if state["calls"] == args[2] + 1:
            raise RuntimeError("transient worker failure (injected)")
        return render(row0)

    worker.fn = render_once_failing
    return net, worker.name


def run_rebalance(torch, counts, farm_img, args) -> float:
    """The farm over 4 thread hosts on the card (``device``): batch 0 ok,
    batch 1 fails in the worker's host, ``recover(mode="rebalance")``
    moves that host's processes onto survivors; the new plan must refine
    the network, the replay must equal phase 2, and this process must
    launch exactly the Mandelbrot kernels of the bands re-streamed.
    Returns the ``recover()`` wall in ms (a replay from chunk 0)."""
    import numpy as np
    from repro_torch import workloads
    from repro_torch.cluster import (ClusterDeployment, ClusterError,
                                     check_refinement, partition)
    from repro_torch.core import netlog
    label = "mandelbrot device x4 rebalance"
    net, worker = failing_farm(args, {})
    bands, mb = args[2], 16
    with ClusterDeployment(net, plan=partition(net, hosts=4),
                           transport="device", microbatch_size=mb,
                           timeout_s=300) as dep:
        out = dep.run(instances=bands)
        check(np.array_equal(workloads.assemble(out["collect"]), farm_img),
              f"[cluster] {label}: batch 0 differs")
        failed = dep.plan.assignment[worker]
        try:
            dep.run(instances=bands)
        except ClusterError as exc:
            erred = sorted(r.host for r in exc.reports
                           if not r.ok and not r.stalled)
            check(erred == [failed], f"[cluster] {label}: erred {erred}")
        else:
            raise SmokeFailure(f"[cluster] {label}: batch 1 did not fail")
        before = counts()["mandelbrot"]
        t0 = time.perf_counter()
        out = dep.recover(mode="rebalance")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launched = counts()["mandelbrot"] - before
        (ev,) = dep.events
        host = dep.plan.assignment[worker]
        want = max(bands - mb * ev.replay_from.get(host, -(-bands // mb)), 0)
        check(np.array_equal(workloads.assemble(out["collect"]), farm_img),
              f"[cluster] {label}: the replayed batch differs from phase 2")
        check(ev.refined is True and check_refinement(net, dep.plan)
              and failed not in dep.plan.hosts() and ev.moved,
              f"[cluster] {label}: {ev.describe()}")
        check(launched == want, f"[cluster] {label}: the replay launched "
                                f"{launched} kernels here, not {want}")
        after = dep.run(instances=bands)
        check(np.array_equal(workloads.assemble(after["collect"]), farm_img),
              f"[cluster] {label}: the batch after the rebalance differs")
    print(netlog.cluster_report(dep.plan, out.reports, events=dep.events))
    print(f"[cluster] {label}: {ev.describe()}")
    print(f"[cluster] {label}: host {failed} evacuated, plan "
          f"{dep.plan.hosts()} refines: True; recover() {wall:.1f} ms, "
          f"{launched} mandelbrot launches here (bands re-streamed from "
          f"chunk {ev.replay_from.get(host)}), replay exact: True")
    return wall


def run_cluster_phase(torch, counts, farm_img, pipe_outs, W, H, bands, iters,
                      n_img, size) -> float:
    """Phase 12: the farm at phase 2's width over 2 and 4 thread hosts on
    the card (``device``) and 2 spawned host processes (``pipe``, ``shm``),
    then the image pipeline at phase 3's size cut between its engines over
    ``device``, ``pipe`` (one cold batch) and ``shm``; a killed host of the
    farm recovered over ``pipe`` and ``shm``, and a failed worker's host
    rebalanced away over ``device``.  Returns the rebalance's ``recover()`` wall in ms."""
    import multiprocessing

    import numpy as np
    from repro_torch import workloads
    from repro_torch.cluster import (ExecConfig, derive_cut_capacities,
                                     partition)
    from repro_torch.cluster.transport import SharedMemoryRing
    t_phase = time.perf_counter()
    free = shm_free_bytes()
    print(f"[cluster] /dev/shm: {free} bytes free")
    args = (W, H, bands, iters)
    # a farm chunk: 16 row indices and 16 bands of int32 iteration counts
    farm_slot = SharedMemoryRing.slot_bytes_for(
        (torch.empty(16, dtype=torch.int32, device="meta"),
         torch.empty(16, H // bands, W, dtype=torch.int32, device="meta")))
    same_img = lambda out: np.array_equal(  # noqa: E731
        workloads.assemble(out["collect"]), farm_img)
    # over the process hosts, a cold and a warm batch, then host 1 killed
    # and the batch recovered, in the same deployment
    for transport, hosts, factory in (
            ("device", 2, workloads.mandelbrot_factory),
            ("device", 4, workloads.mandelbrot_factory),
            ("pipe", 2, checked_farm),
            (SharedMemoryRing(slot_bytes=farm_slot), 2, checked_farm)):
        name = getattr(transport, "name", transport)
        label = f"mandelbrot {name} x{hosts}"
        net = factory(*args)
        run_deployment(torch, label, net, partition(net, hosts=hosts),
                       transport, (factory, args), bands,
                       3 if name == "device" else 2, counts, "mandelbrot",
                       bands if name == "device" else 0, same_img,
                       after=None if name == "device" else
                       lambda dep, label=label: kill_and_recover(
                           torch, dep, label, farm_img, bands))

    def same_edges(out):
        got = out["collector"]
        return len(got) == len(pipe_outs) and all(
            np.array_equal(a, b) for a, b in zip(got, pipe_outs))

    factory = (workloads.image_pipeline_factory, (n_img, size))
    net = factory[0](*factory[1])
    assignment = {name: 0 for name in net.procs}
    assignment["engine2"] = assignment["collector"] = 1
    plan = partition(net, assignment=assignment)
    # over pipe one cold batch: its 16 pickled images take ~20 s a batch
    for transport, batches in (("device", 3), ("pipe", 1)):
        run_deployment(torch, f"image {transport} x2", net, plan, transport,
                       factory, n_img, batches, counts, "stencil",
                       n_img if transport == "device" else 0, same_edges)
    # the ring holds `capacity` chunks of mb grey f32 images: the largest
    # microbatch (up to 16) whose ring fits in what /dev/shm has free
    cap = max(derive_cut_capacities(plan, ExecConfig(16)).values())

    def grey_slot(mb):  # a pipeline chunk: mb grey f32 images
        return SharedMemoryRing.slot_bytes_for(torch.empty(
            mb, size, size, dtype=torch.float32, device="meta"))
    mb = 16
    while mb > 1 and cap * grey_slot(mb) > 0.8 * free:
        mb -= 1
    check(cap * grey_slot(mb) <= 0.8 * free,
          f"[cluster] image shm x2: /dev/shm ({free} bytes free) cannot "
          f"hold {cap} slots of one {size}^2 image")
    print(f"[cluster] image shm x2: microbatch {mb} ({cap} slots of "
          f"{grey_slot(mb)} bytes; 16 needs {cap * grey_slot(16)})")
    run_deployment(torch, f"image shm x2 mb {mb}", net, plan,
                   SharedMemoryRing(slot_bytes=grey_slot(mb)), factory,
                   n_img, 2, counts, "stencil", 0, same_edges,
                   microbatch=mb)
    rebalance_ms = run_rebalance(torch, counts, farm_img, args)
    check(not multiprocessing.active_children(),
          "[cluster] host processes still running after phase 12")
    print(f"[cluster] phase 12 wall: {time.perf_counter() - t_phase:.1f} s")
    return rebalance_ms


# -- phase 13: durability on the card -------------------------------------------------

_TRIP13: dict = {}  # module-level: the adopting controller rebuilds the farm


def tripping_farm(args, trip_at):
    """The farm whose host-side Collect raises once, on its ``trip_at``-th
    band (a transient failure landing after some fold snapshots)."""
    from repro_torch import workloads
    net = workloads.mandelbrot_factory(*args)
    coll = net.procs["collect"]
    fold = coll.fn

    def once(acc, item):
        _TRIP13["n"] = _TRIP13.get("n", 0) + 1
        if _TRIP13["n"] == trip_at:
            raise RuntimeError("transient collector failure (injected)")
        return fold(acc, item)

    coll.fn = once
    return net


def pct(xs, q):
    """Nearest-rank percentile of a non-empty list."""
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(len(ys) * q / 100.0))]


def run_durable_farm(torch, counts, farm_img, args, d) -> dict:
    """13a: the farm over 2 ``device`` hosts with fold snapshots every 2
    chunks, and the same deployment without snapshots, 5 batches each in
    turns; every batch equal to phase 2 and launching its 64 bands here.
    Leaves the durable deployment's state in ``d`` (closed)."""
    import numpy as np
    from repro_torch import workloads
    from repro_torch.cluster import ClusterDeployment
    label = "[durable] 13a farm device x2"
    bands = args[2]
    deps = {name: ClusterDeployment(
        workloads.mandelbrot_factory(*args), hosts=2, transport="device",
        microbatch_size=8, trace=True, timeout_s=300,
        snapshot_every=2 if name == "snapshots" else 0,
        snapshot_dir=d if name == "snapshots" else None)
        for name in ("snapshots", "plain")}
    walls: dict = {name: [] for name in deps}
    try:
        for turn in range(5):  # turn 0 is cold; then ABBA
            names = (["snapshots", "plain"] if turn % 2 else
                     ["plain", "snapshots"])
            for name in names:
                before = counts()["mandelbrot"]
                t0 = time.perf_counter()
                out = deps[name].run(instances=bands)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                check(np.array_equal(workloads.assemble(out["collect"]),
                                     farm_img),
                      f"{label} ({name}): batch {turn} differs from phase 2")
                launched = counts()["mandelbrot"] - before
                check(launched == bands, f"{label} ({name}): batch {turn} "
                                         f"launched {launched} kernels here")
                if turn:
                    walls[name].append(wall)
        dep = deps["snapshots"]
        kinds = {e.kind for e in dep.durable_events}
        check("snapshot" in kinds, f"{label}: durable events {kinds}")
        spans = [e for e in dep.merged_trace()
                 if e.kind == "span" and e.name == "snapshot"]
        persists = [e for e in dep.merged_trace()
                    if e.kind == "span" and e.name == "persist"]
    finally:
        for dep in deps.values():
            dep.close()
    check(bool(spans), f"{label}: no host wrote a fold snapshot")
    by_ci = {}
    for e in spans:
        by_ci.setdefault((e.host, e.args["ci"]), e.args["nbytes"])
    snap_ms = statistics.median(e.dur * 1e3 for e in spans)
    warm = {k: statistics.median(v) for k, v in walls.items()}
    print(f"{label}: 5 batches each, exact, 64 mandelbrot launches here a "
          f"batch; fold snapshots: {len(spans)} spans over 5 batches, "
          f"median {snap_ms:.2f} ms, bytes (host, chunk) {dict(sorted(by_ci.items()))}; "
          f"controller meta: {len(persists)} persist spans, median "
          f"{statistics.median(e.dur * 1e3 for e in persists):.2f} ms, "
          f"{max(e.args['nbytes'] for e in persists)} bytes at most")
    print(f"{label}: warm batch median {warm['snapshots']:.1f} ms with "
          f"snapshots ({', '.join(f'{w:.1f}' for w in walls['snapshots'])}) "
          f"vs {warm['plain']:.1f} ms without "
          f"({', '.join(f'{w:.1f}' for w in walls['plain'])}): ratio "
          f"{warm['snapshots'] / warm['plain']:.3f} (the JAX package holds "
          "its own to <= 1.05; not gated)")
    return {"snap_ms": snap_ms, "warm": warm}


def run_snapshot_replay(torch, counts, farm_img, args, d,
                        rebalance_ms) -> None:
    """13b: the Collect raises on the first band of chunk 5, past the fold
    snapshots at chunks 2 and 4; ``recover()`` must equal phase 2, replay
    the Collect's host from its snapshot (a chunk > 0), append a
    ``restore`` event, and launch here exactly the re-streamed bands."""
    import numpy as np
    from repro_torch import workloads
    from repro_torch.cluster import (ClusterDeployment, ClusterError,
                                     DeploymentStore)
    label = "[durable] 13b replay from a snapshot"
    bands, mb = args[2], 8
    _TRIP13.clear()
    with ClusterDeployment(tripping_farm(args, 5 * mb + 1), hosts=2,
                           transport="device", microbatch_size=mb,
                           snapshot_every=2, snapshot_dir=d,
                           timeout_s=300) as dep:
        try:
            dep.run(instances=bands)
        except ClusterError:
            pass
        else:
            raise SmokeFailure(f"{label}: the batch did not fail")
        coll = dep.plan.assignment["collect"]
        snap = DeploymentStore(d).load_host_snapshot(coll)
        check(snap is not None and snap["next_ci"] > 0,
              f"{label}: no fold snapshot past chunk 0")
        before = counts()["mandelbrot"]
        t0 = time.perf_counter()
        out = dep.recover()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launched = counts()["mandelbrot"] - before
        ev = dep.events[-1]
        kinds = [e.kind for e in dep.durable_events]
    want = bands - mb * snap["next_ci"]
    check(np.array_equal(workloads.assemble(out["collect"]), farm_img),
          f"{label}: the replayed batch differs from phase 2")
    check(ev.replay_from.get(coll) == snap["next_ci"] and ev.refined is True,
          f"{label}: {ev.describe()} (snapshot at chunk {snap['next_ci']})")
    check("restore" in kinds, f"{label}: durable events {kinds}")
    check(launched == want, f"{label}: recover() launched {launched} "
                            f"kernels here, not {want}")
    print(f"{label}: {ev.describe()}")
    print(f"{label}: the Collect's host {coll} resumed at chunk "
          f"{snap['next_ci']} of 8; recover() {wall:.1f} ms, {launched} "
          f"mandelbrot launches here (64 - 8 x {snap['next_ci']}), exact; "
          f"phase 12's rebalance (a replay from chunk 0) {rebalance_ms:.1f} "
          "ms")


def run_adoption(torch, counts, farm_img, args, d, d_live) -> None:
    """13c: a fresh adopt of 13a's closed deployment, and a salvage adopt
    over a live one; each at epoch 2, refined, its next batch equal to
    phase 2 (the salvaged one building no stage callable)."""
    import numpy as np
    from repro_torch import workloads
    from repro_torch.cluster import ClusterDeployment
    label = "[durable] 13c adopt"
    bands = args[2]
    factory = (workloads.mandelbrot_factory, args)
    walls = {}
    t0 = time.perf_counter()
    dep = ClusterDeployment.adopt(d, factory=factory, transport="device")
    walls["fresh"] = (time.perf_counter() - t0) * 1e3
    with dep:
        ev = dep.events[-1]
        check(dep.epoch == 2 and ev.mode == "adopt" and ev.refined is True,
              f"{label} fresh: epoch {dep.epoch}, {ev.describe()}")
        out = dep.run(instances=bands)
        check(np.array_equal(workloads.assemble(out["collect"]), farm_img),
              f"{label} fresh: the batch differs from phase 2")
    live = ClusterDeployment(workloads.mandelbrot_factory(*args), hosts=2,
                             transport="device", microbatch_size=8,
                             snapshot_every=2, snapshot_dir=d_live,
                             timeout_s=300)
    live.start()
    live.run(instances=bands)  # warm: every stage built
    t0 = time.perf_counter()
    dep = ClusterDeployment.adopt(d_live, factory=factory,
                                  transport="device",
                                  salvage=live.salvageable())
    walls["salvage"] = (time.perf_counter() - t0) * 1e3
    with dep:
        ev = dep.events[-1]
        check(dep.epoch == 2 and ev.mode == "adopt" and ev.refined is True,
              f"{label} salvage: epoch {dep.epoch}, {ev.describe()}")
        out = dep.run(instances=bands)
        builds = sum(r.jit_builds for r in out.reports)
        check(builds == 0, f"{label} salvage: {builds} stage builds")
        check(np.array_equal(workloads.assemble(out["collect"]), farm_img),
              f"{label} salvage: the batch differs from phase 2")
    print(f"{label}: fresh {walls['fresh']:.1f} ms (epoch 2, refined, hosts "
          f"spawned anew), salvage {walls['salvage']:.1f} ms (epoch 2, "
          "refined, 0 stage builds); both batches exact")


def group_alive(pgid: int) -> list:
    """Processes of group ``pgid`` that are not zombies."""
    alive = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] != "Z":
            alive.append(stat.parent.name)
    return alive


def run_launcher_kill(torch, d) -> None:
    """13d: the launcher over 2 ``pipe`` hosts with fold snapshots, its
    whole process group SIGKILLed once the Collect's host has written one,
    then ``--resume-from``: adopted at epoch 2 and refined, the pending
    batch replayed from the snapshot, and the oracle equal."""
    import signal
    from repro_torch.cluster import partition
    from repro_torch.kernels.mandelbrot import kernel
    from repro_torch.launch.cluster import make_mandelbrot
    label = "[durable] 13d launcher SIGKILL"
    size, bands = 2048, 64
    # iterations for a ~3 s batch, from the farm's 64 band launches one
    # after another (uncounted: the binding, not the op), as a host
    # renders them — a band alone cannot fill the card, so the whole
    # image in one launch would undercount
    band_h, n0 = size // bands, 20000
    out = torch.empty((bands, band_h, size), dtype=torch.int32,
                      device="cuda")
    rows = [torch.tensor(i * band_h, dtype=torch.int32, device="cuda")
            for i in range(bands)]

    def sweep():
        for i in range(bands):
            kernel.launch(out[i], x0=-2.2, y0=-1.15, pixel_delta=3.0 / size,
                          max_iterations=n0, row0=rows[i])

    sweep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep()
    torch.cuda.synchronize()
    t_img = time.perf_counter() - t0
    iters = int(n0 * 3.0 / t_img)
    del out, rows
    coll = partition(make_mandelbrot(bands, size, size, 1),
                     hosts=2).assignment["collect"]
    flags = ["--hosts", "2", "--transport", "pipe", "--workload",
             "mandelbrot", "--bands", str(bands), "--size", str(size),
             "--iters", str(iters), "--microbatch", "4"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.cluster", *flags]
    print(f"{label}: --iters {iters} ({t_img * 1e3:.1f} ms for the "
          f"{bands} bands of the {size}^2 image at {n0} iterations)")
    t_start = time.perf_counter()
    proc = subprocess.Popen(
        [*cmd, "--snapshot-every", "1", "--snapshot-dir", d, "--batches",
         "1"], env=env, cwd=ROOT, start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # a completed snapshot: the checkpointer writes LATEST after it renames
    # step_*.tmp into place, so a kill mid-write cannot count
    latest = os.path.join(d, f"host_{coll}", "LATEST")
    try:
        deadline = time.monotonic() + 300
        while (not os.path.exists(latest)
               and proc.poll() is None and time.monotonic() < deadline):
            time.sleep(0.02)
        if proc.poll() is not None:  # (the message reads its output)
            raise SmokeFailure(f"{label}: the first run ended before the "
                               f"kill:\n{proc.communicate()[0][-3000:]}")
        check(os.path.exists(latest),
              f"{label}: no fold snapshot of host {coll} within 300 s")
        t_kill = time.perf_counter()
        os.killpg(proc.pid, signal.SIGKILL)
        first = proc.communicate(timeout=60)[0]
        while group_alive(proc.pid) and time.perf_counter() < t_kill + 15:
            time.sleep(0.05)
        left = group_alive(proc.pid)
        check(not left, f"{label}: processes {left} of the group survived")
    finally:
        if proc.poll() is None or group_alive(proc.pid):
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    print(f"{label}: killed the group {(t_kill - t_start):.1f} s after its "
          f"start, once host {coll} had a fold snapshot; no process left")
    for line in first.splitlines():
        if line.startswith("[cluster]"):
            print(f"  first run: {line}")
    res = subprocess.Popen([*cmd, "--resume-from", d, "--batches", "1"],
                           env=env, cwd=ROOT, start_new_session=True,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, bufsize=1)
    stamped = []
    try:
        for line in res.stdout:
            stamped.append((time.perf_counter() - t_kill, line.rstrip()))
        rc = res.wait(timeout=600)
    finally:
        if res.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(res.pid, signal.SIGKILL)
            res.communicate()
    text = "\n".join(line for _, line in stamped)
    check(rc == 0, f"{label}: the resumed run exited {rc}:\n{text[-3000:]}")
    adopted = [(t, ln) for t, ln in stamped
               if "adopted durable deployment" in ln]
    replayed = [(t, ln) for t, ln in stamped
                if "replayed the pending batch" in ln]
    check(len(adopted) == 1 and "epoch 2, refined=True" in adopted[0][1],
          f"{label}: {adopted}")
    check(len(replayed) == 1 and "identical=True" in replayed[0][1],
          f"{label}: {replayed}")
    import ast
    replay_from = ast.literal_eval(replayed[0][1].split("replay_from=")[1])
    check(replay_from.get(coll, 0) > 0, f"{label}: replay_from {replay_from}")
    check("pipe over 2 hosts == sequential oracle: True" in text,
          f"{label}: no oracle line:\n{text[-3000:]}")
    for _, line in stamped:
        if line.startswith("[cluster]") or "adopt (epoch" in line:
            print(f"  resumed: {line.strip()}")
    print(f"{label}: kill -> adopted {adopted[0][0]:.1f} s, kill -> "
          f"replayed result {replayed[0][0]:.1f} s (the resumed launcher's "
          f"start and oracle included), replay_from {replay_from}; "
          f"group gone: True")


def run_durable_serving(torch, model, params, d) -> None:
    """13e: qwen2-0.5b (phase 6's model and weights) served with a store,
    persisting every step; crashed with two requests done and two in
    flight, then adopted on a fresh backend: every request answered once,
    with the tokens of an uncrashed engine without a store."""
    import gc
    from repro_torch.cluster import DeploymentStore
    from repro_torch.core import trace
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import LocalDecodeBackend, ServeEngine
    label = "[durable] 13e serving"
    reqs = launcher.requests(8, model.cfg.vocab, 16)

    def backend():
        return LocalDecodeBackend(model, params, n_slots=4, max_len=128)

    def drain(eng):
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return eng

    def tpot(eng):
        return pct([r.tpot * 1e3 for r in eng.completed
                    if len(r.tokens) > 1], 50)

    with torch.inference_mode():
        plain = drain(ServeEngine(backend()))
        want = {r.rid: r.tokens for r in plain.completed}
        rec = trace.enable(host="serve13")
        try:
            stored = drain(ServeEngine(
                backend(), store=DeploymentStore(os.path.join(d, "full")),
                persist_every=1))
            spans = [e for e in rec.events()
                     if e.kind == "span" and e.name == "persist"]
        finally:
            trace.disable()
        check(all(stored.poll(rid).tokens == t for rid, t in want.items()),
              f"{label}: the engine with a store gives other tokens")
        root = os.path.join(d, "crash")
        eng = ServeEngine(backend(), store=DeploymentStore(root),
                          persist_every=1)
        for r in reqs:
            eng.submit(r)
        while len(eng.completed) < 2 or len(eng._live) < 2:
            check(eng.step() > 0, f"{label}: drained before the crash")
        at = (len(eng.completed), len(eng._live), eng.steps_run)
        del eng  # the crash: engine and backend both go
        gc.collect()
        fresh = backend()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng2 = ServeEngine.adopt(fresh, DeploymentStore(root))
        torch.cuda.synchronize()
        adopt_ms = (time.perf_counter() - t0) * 1e3
        eng2.run_until_drained()
    answered = [r.rid for r in eng2.completed]
    check(sorted(answered) == sorted(want),
          f"{label}: answered {answered}, want each of {sorted(want)} once")
    for rid, toks in want.items():
        check(eng2.poll(rid).tokens == toks,
              f"{label}: request {rid} differs from the uncrashed run")
    nbytes = sorted({e.args["nbytes"] for e in spans})
    print(f"{label}: qwen2-0.5b, 4 slots, max_len 128, 8 requests; crashed "
          f"at step {at[2]} with {at[0]} done and {at[1]} in flight; the "
          f"adopted engine answered each rid once, tokens equal to the "
          f"uncrashed run (bf16, exact); adopt {adopt_ms:.1f} ms")
    print(f"{label}: persist span p50 {pct([e.dur * 1e3 for e in spans], 50):.2f} "
          f"ms over {len(spans)} steps, {nbytes[-1]} bytes a persist at most "
          f"({nbytes[0]} at least); tpot p50 {tpot(stored):.2f} ms with the "
          f"store vs {tpot(plain):.2f} ms without")


def run_durable_phase(torch, counts, farm_img, model, params, args,
                      rebalance_ms) -> None:
    """Phase 13: durability on the card (13a-13e)."""
    import multiprocessing
    import tempfile
    t_phase = time.perf_counter()
    shm_before = set(os.listdir("/dev/shm"))
    print(f"[durable] /dev/shm: {shm_free_bytes()} bytes free, "
          f"{len(shm_before)} entries")
    with tempfile.TemporaryDirectory() as tmp:
        farm_dir = os.path.join(tmp, "farm")
        run_durable_farm(torch, counts, farm_img, args, farm_dir)
        run_snapshot_replay(torch, counts, farm_img, args,
                            os.path.join(tmp, "replay"), rebalance_ms)
        run_adoption(torch, counts, farm_img, args, farm_dir,
                     os.path.join(tmp, "live"))
        run_launcher_kill(torch, os.path.join(tmp, "launcher"))
        run_durable_serving(torch, model, params, os.path.join(tmp, "serve"))
    left = sorted(set(os.listdir("/dev/shm")) - shm_before)
    check(not left, f"[durable] /dev/shm entries left: {left}")
    check(not multiprocessing.active_children(),
          "[durable] host processes still running after phase 13")
    print(f"[durable] /dev/shm: {shm_free_bytes()} bytes free, nothing "
          f"left; no host process left; phase 13 wall: "
          f"{time.perf_counter() - t_phase:.1f} s")


# -- phase 14: the fault-injection simulator on the card ------------------------------

# (seed, recovery mode) of 14b: FaultSchedule.random over the 2-host farm
# plan gives a kill, a double kill, a controller-step kill and a kill
# during recovery for these seeds
SIM_FARM_SEEDS = ((2, "restart"), (7, "rebalance"), (5, "restart"),
                  (11, "rebalance"))
SIM_FARM_KINDS = ("kill", "double-kill", "ctrl-step-kill",
                  "kill-during-recovery")
# run_scenario seeds that wait out two 8 s recv timeouts each (~17 s a seed
# on the CPU): 14a leaves them to the CPU tests and the CI's sim lane, which
# run every seed; the other 17 still fire all five fault kinds
SIM_RECV_TIMEOUT_SEEDS = (5, 7, 9)


def sim_family(label, runs) -> list:
    """14a: run one family's scenarios in turn, each must be ``ok``; print
    each and the family's counts, virtual ticks and wall."""
    t0 = time.perf_counter()
    results = []
    for run in runs:
        r = run()
        print(f"[sim] {label}: {r.describe()}")
        check(r.ok, f"[sim] {label}: scenario failed: {r.failures}")
        results.append(r)
    ticks = [r.ticks for r in results]
    print(f"[sim] {label}: {len(results)} scenarios, "
          f"{sum(r.fired for r in results)} faults fired, "
          f"{sum(r.recoveries for r in results)} recoveries, virtual ticks "
          f"median {statistics.median(ticks)} max {max(ticks)}, wall "
          f"{time.perf_counter() - t0:.1f} s")
    return results


def run_sim_farm(torch, counts, farm_img, args) -> None:
    """14b: the Mandelbrot farm at phase 2's width over 2 simulated hosts
    under seeded fault schedules (see the module docstring)."""
    import random

    import numpy as np
    from repro_torch import workloads
    from repro_torch.cluster import partition
    from repro_torch.cluster.sim import FaultSchedule, drive_scenario
    from repro_torch.cluster.transport import pack_raw, unpack_raw
    label = "[sim] 14b farm x2"
    bands = args[2]
    factory = (workloads.mandelbrot_factory, args)
    plan = partition(workloads.mandelbrot_factory(*args), hosts=2)

    def same(out):
        return (None if np.array_equal(workloads.assemble(out["collect"]),
                                       farm_img)
                else "the image differs from phase 2")

    kinds = []
    for seed, mode in SIM_FARM_SEEDS:
        sched = FaultSchedule.random(random.Random(seed), plan)
        kinds.append(sched.kind)
        before = counts()["mandelbrot"]
        t0 = time.perf_counter()
        run = drive_scenario(workloads.mandelbrot_factory(*args), factory,
                             plan, sched, mode, instances=bands, check=same,
                             microbatch_size=16, timeout_s=300)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()["mandelbrot"] - before
        check(not run.failures, f"{label} seed {seed}: {run.failures}")
        check(len(run.outs) == 3, f"{label} seed {seed}: "
                                  f"{len(run.outs)} batches completed")
        check(all(ev.refined is True for ev in run.events),
              f"{label} seed {seed}: a recovery did not refine")
        check(launched >= 3 * bands,
              f"{label} seed {seed}: {launched} launches here for 3 batches")
        fired = [ev for ev in sched.events if ev.fired]
        check(bool(fired) and bool(run.events),
              f"{label} seed {seed}: no fault fired or no recovery")
        back = []  # kill -> recovered result, each armed batch with a fire
        for t_start, t_end in run.spans[1:]:
            at = [ev.fired_at for ev in fired if t_start <= ev.fired_at
                  <= t_end]
            if at:
                back.append((t_end - min(at)) * 1e3)
        print(f"{label} seed {seed} ({sched.kind}, {mode}): "
              f"[{sched.describe()}] fired {len(fired)}, recoveries "
              f"{len(run.events)}, 3 batches equal to phase 2, merged trace "
              f"conforms, no duplicate delivery, chain refines; launches "
              f"here {launched} ({launched - 3 * bands} beyond one a band a "
              f"batch); kill -> recovered result "
              f"{', '.join(f'{w:.1f}' for w in back)} ms; batch walls "
              f"{', '.join(f'{(b - a) * 1e3:.1f}' for a, b in run.spans)} "
              f"ms; virtual ticks {run.ticks}; wall {wall:.2f} s")
        for ev in run.events:
            print(f"{label} seed {seed}:   {ev.describe()}")
    check(sorted(kinds) == sorted(SIM_FARM_KINDS),
          f"{label}: fault kinds {kinds}, not {SIM_FARM_KINDS}")
    # every result crosses from its simulated host to the controller as
    # raw bytes (the process-host path): what one batch's round trip costs
    result = {"collect": run.outs[-1]["collect"]}
    trips = []
    for _ in range(3):
        t0 = time.perf_counter()
        packed = pack_raw(result)
        unpack_raw(packed)
        trips.append((time.perf_counter() - t0) * 1e3)
    nbytes = sum(len(leaf.buf) for leaf in
                 packed["collect"].values())
    print(f"{label}: a result's round trip through host bytes "
          f"(pack_raw + unpack_raw, {nbytes} bytes): median "
          f"{statistics.median(trips):.1f} ms of 3")


def run_sim_phase(torch, counts, farm_img, args) -> None:
    """Phase 14: the fault-injection simulator on the card (14a, 14b)."""
    import multiprocessing
    import threading
    from repro_torch.cluster import sim
    t_phase = time.perf_counter()
    shm_before = set(os.listdir("/dev/shm"))
    threads_before = set(threading.enumerate())
    seeds = [s for s in range(20) if s not in SIM_RECV_TIMEOUT_SEEDS]
    scen = sim_family(
        "14a run_scenario seeds 0-19 but "
        + ", ".join(map(str, SIM_RECV_TIMEOUT_SEEDS)),
        [lambda s=s: sim.run_scenario(s) for s in seeds])
    kinds = {r.kind for r in scen}
    check(kinds == {"kill", "stall", "double-kill", "kill-during-recovery",
                    "ctrl-step-kill"}, f"[sim] 14a fault kinds {kinds}")
    crash = sim_family("14a kill-controller", [
        lambda s=s: sim.run_kill_controller_scenario(s) for s in range(5)])
    check(len({r.kind for r in crash}) == 5,
          f"[sim] 14a controller-crash variants {[r.kind for r in crash]}")
    sim_family("14a stall-race seeds 0-1",
               [lambda s=s: sim.run_stall_race_scenario(s) for s in (0, 1)])
    sim_family("14a coalesce-kill seeds 0-5",
               [lambda s=s: sim.run_coalesce_kill_scenario(s)
                for s in range(6)])
    sim_family("14a pipe-brick", [sim.run_pipe_brick_scenario])
    run_sim_farm(torch, counts, farm_img, args)
    deadline = time.monotonic() + 30.0
    while True:  # a killed host thread unwinds at its next poll
        left = [t.name for t in set(threading.enumerate()) - threads_before
                if t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    check(not left, f"[sim] host threads left after phase 14: {left}")
    check(not multiprocessing.active_children(),
          "[sim] host processes still running after phase 14")
    left = sorted(set(os.listdir("/dev/shm")) - shm_before)
    check(not left, f"[sim] /dev/shm entries left: {left}")
    print(f"[sim] no host thread, host process or /dev/shm entry left; "
          f"phase 14 wall: {time.perf_counter() - t_phase:.1f} s")


# -- phase 15: the cost model and the autoscaler on the card -------------------------

def warm_median(walls) -> float:
    """The median of a deployment's warm batch walls (start and the cold
    batch left out)."""
    return statistics.median(walls[2:])


def run_cost_cuts(torch, counts, label, net, factory, n, mb, kernel,
                  per_batch, same, expect_ms) -> None:
    """15a for one workload: ``calibrate`` on the card (every bandwidth of
    ``device``, ``pipe`` and ``shm``), the measured stages against phase 1
    (``expect_ms``: stage -> what phase 1's kernel times predict; the ratio
    is printed, not gated), then the count and the cost cut deployed over
    2 and 4 ``device`` hosts, 3 batches each, each batch equal to the
    single-host run (``same``), and the count plan hot-swapped to the cost
    plan through ``reconfigure(plan=)``."""
    from repro_torch.cluster import (ClusterDeployment, calibrate,
                                     check_refinement, cost_assignment,
                                     partition)
    t0 = time.perf_counter()
    prof = calibrate(net, instances=2 * mb, microbatch_size=mb,
                     transports=("device", "pipe", "shm"))
    wall = time.perf_counter() - t0
    print(f"[costs] 15a {label}: calibrated {len(prof.costs)} process "
          f"cost(s) in {wall * 1e3:.1f} ms (microbatch {mb})")
    for line in prof.describe().splitlines():
        print(f"[costs] 15a {label}:   {line}")
    check(bool(prof.costs) and all(
        c.source == "measured" and c.wall_s > 0 for c in prof.costs.values()),
        f"[costs] 15a {label}: a stage was not measured")
    check(set(prof.bandwidths) == {"device", "pipe", "shm"}
          and all(bw > 0 for bw in prof.bandwidths.values()),
          f"[costs] 15a {label}: bandwidths {prof.bandwidths}")
    for stage, (want_ms, what) in expect_ms.items():
        got_ms = prof.costs[stage].wall_s * 1e3
        print(f"[costs] 15a {label}: {stage} measured {got_ms:.4f} ms a "
              f"chunk against {what} {want_ms:.4f} ms: ratio "
              f"{got_ms / want_ms:.2f} (host dispatch included; not gated)")
    walls = {}
    for hosts in (2, 4):
        count = partition(net, hosts=hosts)
        cost = partition(net, assignment=cost_assignment(
            net, hosts, prof, transport="device"))
        same_cut = cost.assignment == count.assignment
        print(f"[costs] 15a {label} x{hosts}: count cut "
              f"{[f'{c.src}->{c.dst}' for c in count.cut]}, cost cut "
              f"{[f'{c.src}->{c.dst}' for c in cost.cut]} over "
              f"{len(cost.hosts())} host(s): "
              f"{'the same plan' if same_cut else 'different plans'}")
        for name, plan in (("count", count), ("cost", cost)):
            walls[(hosts, name)] = run_deployment(
                torch, f"15a {label} {name} cut device x{hosts}", net, plan,
                "device", factory, n, 3, counts, kernel, per_batch, same,
                microbatch=mb)
        print(f"[costs] 15a {label} x{hosts}: warm batch median, count cut "
              f"{warm_median(walls[(hosts, 'count')]):.1f} ms, cost cut "
              f"{warm_median(walls[(hosts, 'cost')]):.1f} ms")
    # the hot swap: a live count-cut deployment onto the cost cut
    count = partition(net, hosts=2)
    cost = partition(net, assignment=cost_assignment(net, 2, prof,
                                                     transport="device"))
    for plan in (count, cost):
        check(check_refinement(net, plan),
              f"[costs] 15a {label}: a plan does not refine the network")
    with ClusterDeployment(net, plan=count, transport="device",
                           microbatch_size=mb, factory=factory,
                           timeout_s=300) as dep:
        check(same(dep.run(instances=n)),
              f"[costs] 15a {label}: the count cut's batch differs")
        t0 = time.perf_counter()
        ev = dep.reconfigure(plan=cost)
        swap_ms = (time.perf_counter() - t0) * 1e3
        check(ev.mode == "reconfigure" and ev.refined is True
              and dep.plan.assignment == cost.assignment,
              f"[costs] 15a {label}: hot swap {ev.describe()}")
        before = counts()[kernel]
        check(same(dep.run(instances=n)),
              f"[costs] 15a {label}: the batch after the hot swap differs")
        torch.cuda.synchronize()
        launched = counts()[kernel] - before
        check(launched == per_batch, f"[costs] 15a {label}: {launched} "
                                     f"{kernel} launches after the swap")
    print(f"[costs] 15a {label}: hot swap count -> cost cut over 2 device "
          f"hosts: {ev.describe()}; reconfigure {swap_ms:.1f} ms; the next "
          f"batch equal, {launched} {kernel} launches")


def run_cost_launcher(torch) -> None:
    """15b: ``python -m repro_torch.launch.cluster`` over 2 ``device`` hosts
    with the cost cut, calibration and the default autoscale policy."""
    label = "[costs] 15b launcher"
    flags = ["--workload", "mandelbrot", "--bands", "64", "--size", "4096",
             "--iters", "1000", "--microbatch", "16", "--transport",
             "device", "--hosts", "2", "--cut", "cost", "--calibrate",
             "--autoscale", "--batches", "4"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.cluster",
                        *flags], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"{label}: exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
    lines = r.stdout.splitlines()
    batches = [ln for ln in lines if ln.startswith("[cluster] batch ")]
    check(len(batches) == 4 and all("identical=True" in ln
                                    for ln in batches),
          f"{label}: batches {batches}")
    check(any("sequential oracle: True" in ln for ln in lines),
          f"{label}: no oracle line:\n{r.stdout[-3000:]}")
    print(f"{label}: {' '.join(flags)}")
    for ln in lines:
        if (ln.startswith("[cluster]") or ln.startswith("group")
                or ln.startswith("collect") or ln.startswith("bandwidth")
                or ln.startswith("  host") or ln.startswith("  cut")):
            print(f"{label}:   {ln}")
    events = [ln for ln in lines if ln.startswith("[cluster] autoscale ")]
    print(f"{label}: {len(events)} autoscale event(s); every batch "
          f"identical=True; wall {wall:.1f} s (process start included)")


def run_workload_family(torch) -> None:
    """15c: ``run_workload_scenario`` for seeds 0-5 on the card, two of
    each kind: a spike scales out, a straggler is migrated away, a slow
    start causes no action."""
    from repro_torch.cluster import sim
    want = {"spike": 1, "straggler": 1, "slow-start": 0}
    for seed in range(6):
        t0 = time.perf_counter()
        r = sim.run_workload_scenario(seed)
        wall = time.perf_counter() - t0
        print(f"[costs] 15c {r.describe()}")
        check(r.ok, f"[costs] 15c seed {seed}: {r.failures}")
        kind = r.kind.split("/")[1]
        check(r.recoveries == want[kind],
              f"[costs] 15c seed {seed}: {r.recoveries} epoch bumps for "
              f"{kind}")
        print(f"[costs] 15c seed {seed} ({kind}): {r.fired} autoscale "
              f"decision(s), {r.recoveries} epoch bump(s), virtual ticks "
              f"{r.ticks}, wall {wall:.2f} s")


def run_costs_phase(torch, counts, farm_img, edge_maps, entries, args,
                    n_img, size) -> None:
    """Phase 15: the cost model and the autoscaler on the card (15a-15c)."""
    import multiprocessing
    import threading

    import numpy as np
    from repro_torch import workloads
    t_phase = time.perf_counter()
    shm_before = set(os.listdir("/dev/shm"))
    threads_before = set(threading.enumerate())
    W, H, bands, iters = args
    mb = 16
    band_ms, stencil_ms = entries[0]["ms"], entries[1]["ms"]
    same_img = lambda out: np.array_equal(  # noqa: E731
        workloads.assemble(out["collect"]), farm_img)
    run_cost_cuts(torch, counts, "mandelbrot", workloads.mandelbrot_factory(
        *args), (workloads.mandelbrot_factory, args), bands, mb,
        "mandelbrot", bands, same_img,
        {"group": (mb * band_ms, f"{mb} x phase 1's band")})

    def same_edges(out):
        got = out["collector"]
        return len(got) == len(edge_maps) and all(
            np.array_equal(a, b) for a, b in zip(got, edge_maps))

    factory = (workloads.image_pipeline_factory, (n_img, size))
    run_cost_cuts(torch, counts, "image", factory[0](*factory[1]), factory,
                  n_img, 4, "stencil", n_img, same_edges,
                  {"engine2": (4 * stencil_ms, "4 x phase 1's EDGE5")})
    run_cost_launcher(torch)
    run_workload_family(torch)
    deadline = time.monotonic() + 30.0
    while True:  # a simulated host thread unwinds at its next poll
        left = [t.name for t in set(threading.enumerate()) - threads_before
                if t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    check(not left, f"[costs] host threads left after phase 15: {left}")
    check(not multiprocessing.active_children(),
          "[costs] host processes still running after phase 15")
    left = sorted(set(os.listdir("/dev/shm")) - shm_before)
    check(not left, f"[costs] /dev/shm entries left: {left}")
    print(f"[costs] no host thread, host process or /dev/shm entry left; "
          f"phase 15 wall: {time.perf_counter() - t_phase:.1f} s")


# -- phase 16: the clustered decode farm on the card ----------------------------------

FARM_SPEC = ("model", "qwen2-0.5b", False)   # full width, seed-0 weights


def farm_backend(transport, hosts=2, **kw):
    """Phase 16's decode farm: 4 slots in 2 shards of 2 rows, max_len 128,
    prefill chunks of 8, on the card."""
    from repro_torch.serve import ClusterDecodeBackend
    return ClusterDecodeBackend(FARM_SPEC, n_slots=4, shards=2, hosts=hosts,
                                transport=transport, max_len=128,
                                prefill_chunk=LAUNCH_PREFILL_CHUNK, **kw)


def tree_bytes(tree) -> int:
    import torch.utils._pytree as pytree
    return sum(l.numel() * l.element_size() for l in pytree.tree_leaves(tree))


def serve_farm(torch, be, reqs, label, after_step=None,
               engine=None) -> dict:
    """Drive ``reqs`` through a ``ServeEngine`` over the farm backend
    ``be`` (or ``engine``, already holding them); ``after_step(eng)`` runs
    after every step.  Returns the responses by rid, the engine, the
    decode-step and persist spans, the wall, and the bytes that crossed the
    cut in each decode step.  The engine records into a recorder of its
    own: thread hosts drain the process-default one after every batch."""
    from repro_torch.core.trace import TraceRecorder
    from repro_torch.serve import ServeEngine
    cut_bytes = []
    inner = be.dep.run

    def run(*a, **k):  # the cut's bytes of every decode batch (2 items)
        out = inner(*a, **k)
        if len(out["collect"]) == be.shards:
            cut_bytes.append(sum(sum(r.metrics.get("sent_bytes", {})
                                     .values())
                                 for r in out.reports if r.metrics))
        return out

    be.dep.run = run
    try:
        t0 = time.perf_counter()
        eng = engine
        if eng is None:
            eng = ServeEngine(be, recorder=TraceRecorder(host="serve16"))
            for r in reqs:
                eng.submit(r)
        while eng.pending or eng._live:
            eng.step()
            if after_step is not None:
                after_step(eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = [e for e in eng.rec.events() if e.kind == "span"]
    finally:
        be.dep.run = inner
    done = list(eng.completed)
    check(sorted(r.rid for r in done) == sorted(r.rid for r in reqs),
          f"{label}: answered {sorted(r.rid for r in done)}")
    for r in reqs:
        resp = eng.poll(r.rid)
        check(len(resp.tokens) == r.max_new and resp.finish_reason == "length",
              f"{label}: request {r.rid} gave {len(resp.tokens)} tokens")
        check([e.kind for e in resp.slot_events] == ["join", "leave"],
              f"{label}: request {r.rid} slot events {resp.slot_events}")
    return {"tokens": {r.rid: eng.poll(r.rid).tokens for r in reqs},
            "eng": eng, "wall": wall, "cut_bytes": cut_bytes,
            "decode": sorted(e.dur * 1e3 for e in spans
                             if e.name == "decode_chunk"),
            "persist": [e for e in spans if e.name == "persist"]}


def report_farm(label, run, local_step_ms) -> None:
    """tok/s, TTFT and TPOT, the farm step against phase 7's local step,
    and the cut's bytes a decode step."""
    done = run["eng"].completed
    toks = sum(len(r.tokens) for r in done)
    span = (max(r.finished_at for r in done)
            - min(r.submitted_at for r in done))
    ttft = [r.ttft * 1e3 for r in done]
    tpot = [r.tpot * 1e3 for r in done if len(r.tokens) > 1]
    dec = run["decode"]
    cut = run["cut_bytes"]
    print(f"{label}: {len(done)} requests, {toks} tokens in "
          f"{span * 1e3:.1f} ms: {toks / span:.1f} tok/s; ttft p50 "
          f"{pct(ttft, 50):.1f} ms p99 {pct(ttft, 99):.1f} ms; tpot p50 "
          f"{pct(tpot, 50):.2f} ms p99 {pct(tpot, 99):.2f} ms")
    print(f"{label}: farm decode step p50 {pct(dec, 50):.2f} ms p99 "
          f"{pct(dec, 99):.2f} ms over {len(dec)} steps = "
          f"{pct(dec, 50) / local_step_ms:.2f} x phase 7's local step "
          f"({local_step_ms:.2f} ms); cut {pct(cut, 50)} bytes a decode "
          f"step (p50, {min(cut)}-{max(cut)}); wall {run['wall']:.2f} s")


def top2_margin(torch, model, params, prompt, prefix) -> float:
    """The top-2 logit margin of one request alone (one row, max_len 128)
    at the token after ``prompt`` + ``prefix``: how near the argmax was to
    flipping where two runs first differ."""
    import torch.utils._pytree as pytree
    dev = pytree.tree_leaves(params)[0].device
    cache = model.init_cache(1, 128, device=dev)
    logits = None
    for t in (*prompt, *prefix):
        logits, cache = model.decode_step(
            params, cache, torch.tensor([[t]], dtype=torch.int32,
                                        device=dev))
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def first_difference(got: dict, want: dict):
    """(rid, step) of the first request whose tokens differ, or None."""
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        for t, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return rid, t
        if len(a) != len(b):
            return rid, min(len(a), len(b))
    return None


def run_farm_phase(torch, model, params, phase7) -> None:
    """Phase 16: full-width qwen2-0.5b served by the clustered decode farm
    (16a-16f).  ``model``/``params`` are phase 6's (the farm's seed-0
    weights); ``phase7`` is what phase 7's 4-slot launcher run gave."""
    import gc
    import multiprocessing
    import tempfile
    import threading
    from repro_torch.cluster import DeploymentStore
    from repro_torch.core.trace import TraceRecorder
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import LocalDecodeBackend, ServeEngine
    t_phase = time.perf_counter()
    shm_before = set(os.listdir("/dev/shm"))
    threads_before = set(threading.enumerate())
    reqs = launcher.requests(8, model.cfg.vocab, 16)
    local_ms = phase7["step_ms"]

    def free(be):
        be.close()
        del be
        gc.collect()
        torch.cuda.empty_cache()

    # the reference the farm must equal: a local engine at the shards'
    # decode shape (M = 2 rows), on the same weights
    eng = ServeEngine(LocalDecodeBackend(model, params, n_slots=2,
                                         max_len=128))
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    m2 = {r.rid: eng.poll(r.rid).tokens for r in reqs}
    del eng

    # 16a: 2 device hosts, then 2 pipe hosts (kept warm for 16c)
    streams = {}
    for transport in ("device", "pipe"):
        label = f"[farm] 16a {transport}"
        t0 = time.perf_counter()
        be = farm_backend(transport)
        up = time.perf_counter() - t0
        cache_mb = tree_bytes(be.shard_cache[0]) / 1e6
        run = serve_farm(torch, be, reqs, label)
        streams[transport] = run["tokens"]
        report_farm(label, run, local_ms)
        print(f"{label}: backend built and deployment started in "
              f"{up:.1f} s; a shard's cache {cache_mb:.2f} MB; epoch "
              f"{be.dep.epoch}, recoveries {be.recoveries}")
        if transport == "device":
            free(be)
    pipe_be = be
    check(streams["device"] == streams["pipe"],
          "[farm] 16a: the device and pipe farms' streams differ")
    diff = first_difference(streams["device"], m2)
    if diff is not None:
        rid, t = diff
        r = next(q for q in reqs if q.rid == rid)
        margin = top2_margin(torch, model, params, r.prompt,
                             m2[rid][:t])
        print(f"[farm] 16a FAULT: request {rid} differs from the local "
              f"M = 2 engine at step {t} (farm {streams['device'][rid][t:t+1]}"
              f", local {m2[rid][t:t+1]}); top-2 logit margin alone there "
              f"{margin:.4f}")
    check(diff is None, "[farm] 16a: the farm's streams differ from the "
                        "local engine at the shards' decode shape (M = 2)")
    same4 = sum(streams["device"][rid] == t
                for rid, t in phase7["tokens"].items())
    alone = sum(streams["device"][rid] == t
                for rid, t in phase7["alone"].items())
    print(f"[farm] 16a: device == pipe == local M = 2 engine, bit for bit "
          f"(8 requests); {same4}/8 equal phase 7's 4-slot local run, "
          f"{alone}/8 the one-slot oracle (not gated: other decode shapes)")
    want = streams["device"]

    # 16b: scale-out to 3 device hosts after the first step
    label = "[farm] 16b device scale(3)"
    be = farm_backend("device")
    events = []

    def grow(eng):
        if eng.steps_run == 1 and not events:
            t0 = time.perf_counter()
            events.append((be.scale(3), time.perf_counter() - t0))

    run = serve_farm(torch, be, reqs, label, after_step=grow)
    ev, scale_s = events[0]
    check(ev.mode == "reconfigure" and ev.refined is True
          and be.dep.epoch == 2,
          f"{label}: event {ev.mode} refined={ev.refined} epoch "
          f"{be.dep.epoch}")
    check(all(e.refined is True for e in be.dep.events),
          f"{label}: an event did not refine")
    check(run["tokens"] == want, f"{label}: streams differ from 16a")
    report_farm(label, run, local_ms)
    print(f"{label}: reconfigure {scale_s * 1e3:.1f} ms, epoch 2, refined, "
          f"streams equal 16a")
    free(be)

    # 16c: host 1 of 16a's 2 pipe hosts killed after step 3 of a second
    # serving of the same requests
    label = "[farm] 16c pipe kill_host(1)"
    be = pipe_be
    killed = {}

    def kill(eng):
        if eng.steps_run == 3 and "at" not in killed:
            be.dep.kill_host(1)
            killed["at"] = time.perf_counter()
        elif "at" in killed and "wall" not in killed:
            killed["wall"] = time.perf_counter() - killed["at"]
            killed["recoveries"] = be.recoveries

    run = serve_farm(torch, be, reqs, label, after_step=kill)
    check(killed.get("recoveries", 0) >= 1,
          f"{label}: the step after the kill did not recover ({killed})")
    check(all(e.refined is True for e in be.dep.events),
          f"{label}: an event did not refine")
    check(run["tokens"] == want, f"{label}: streams differ from 16a")
    report_farm(label, run, local_ms)
    print(f"{label}: kill -> step completed {killed['wall']:.2f} s, "
          f"recoveries {be.recoveries}, events "
          + "; ".join(f"{e.mode} {e.epoch_from}->{e.epoch_to}"
                      for e in be.dep.events)
          + "; streams equal 16a")
    free(be)
    del pipe_be  # its queues' feeder threads end once it is collected

    # 16d: a durable farm closed after 4 steps, adopted by a fresh one
    label = "[farm] 16d device adopt"
    with tempfile.TemporaryDirectory() as d:
        be = farm_backend("device", snapshot_dir=d)
        eng = ServeEngine(be, store=be.store,
                          recorder=TraceRecorder(host="serve16d"))
        for r in reqs:
            eng.submit(r)
        for _ in range(4):
            eng.step()
        first = [e for e in eng.rec.events()
                 if e.kind == "span" and e.name == "persist"]
        at = (len(eng.completed), len(eng._live), eng.steps_run)
        del eng
        free(be)  # the crash: engine and backend both go
        be = farm_backend("device", snapshot_dir=d)
        t0 = time.perf_counter()
        eng2 = ServeEngine.adopt(be, DeploymentStore(d),
                                 recorder=TraceRecorder(host="serve16d"))
        adopt_ms = (time.perf_counter() - t0) * 1e3
        run = serve_farm(torch, be, reqs, label, engine=eng2)
        answered = [r.rid for r in eng2.completed]
        check(sorted(answered) == sorted(want),
              f"{label}: answered {answered}, want each rid once")
        check(run["tokens"] == want, f"{label}: streams differ from 16a")
        persist = first + run["persist"]
        nbytes = sorted(e.args["nbytes"] for e in persist)
        print(f"{label}: closed at step {at[2]} with {at[0]} done and "
              f"{at[1]} in flight; adopted in {adopt_ms:.1f} ms; every "
              f"request answered once, streams equal 16a; persist span "
              f"p50 {pct([e.dur * 1e3 for e in persist], 50):.2f} ms over "
              f"{len(persist)} steps, {nbytes[0]}-{nbytes[-1]} bytes each")
        free(be)

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    # 16e: the kill-during-serving sweep on the card
    label = "[farm] 16e sim --serve-kill 12"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.cluster.sim",
                        "--serve-kill", "12"], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("seed")]
    check(r.returncode == 0 and len(lines) == 12
          and all("[ok]" in ln for ln in lines),
          f"{label}: exited {r.returncode}:\n{r.stdout[-3000:]}"
          f"{r.stderr[-3000:]}")
    print(f"{label}: 12 scenarios ok, wall {wall:.1f} s (process start "
          f"included); {r.stdout.strip().splitlines()[-1]}")

    # 16f: the serve launcher over 2 device hosts with the autoscaler
    label = "[farm] 16f launcher"
    flags = ["--arch", "qwen2-0.5b", "--hosts", "2", "--transport",
             "device", "--autoscale"]
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        *flags], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(r.returncode == 0 and "(cluster[devicex2h/2 shards]" in r.stdout
          and ": 8 requests" in r.stdout,
          f"{label}: exited {r.returncode}:\n{r.stdout[-3000:]}"
          f"{r.stderr[-3000:]}")
    print(f"{label}: python -m repro_torch.launch.serve {' '.join(flags)}; "
          f"wall {wall:.1f} s (process start included)")
    for ln in r.stdout.splitlines():
        print(f"{label}:   {ln}")

    deadline = time.monotonic() + 30.0
    while True:  # a stopped host thread unwinds at its next poll
        left = [t.name for t in set(threading.enumerate()) - threads_before
                if t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    check(not left, f"[farm] host threads left after phase 16: {left}")
    check(not multiprocessing.active_children(),
          "[farm] host processes still running after phase 16")
    left = sorted(set(os.listdir("/dev/shm")) - shm_before)
    check(not left, f"[farm] /dev/shm entries left: {left}")
    print(f"[farm] no host thread, host process or /dev/shm entry left; "
          f"phase 16 wall: {time.perf_counter() - t_phase:.1f} s")


# -- phase 17: the encoder-decoder on the card ---------------------------------------

WHISPER_FRAMES = 1500  # whisper's n_audio_ctx: the frames of a 30 s window
WHISPER_TEXT = 448     # whisper's n_text_ctx
# <|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|>
WHISPER_PROMPT = (50258, 50259, 50359, 50363)
WHISPER_STEPS = 124    # greedy steps after the prompt
WHISPER_CPU_TOL = 1e-3  # f32 card forward against the CPU's plain path


def run_whisper_phase(torch, dev, counts) -> tuple:
    """Phase 17: full-width whisper-tiny (4 encoder and 4 decoder layers,
    d=384, 6/6 heads of 64, vocab 51865; f32 weights from seed 0, 4096
    learned decoder positions) on 4 utterances of 1500 seeded stub frames.

    - bf16 ``forward`` on (4, 448) seeded tokens: finite logits, flash
      launched exactly 12 times (4 encoder layers, 4 causal decoder
      self-attentions, 4 cross-attentions) and no other kernel;
    - f32 ``forward`` against ``prefill`` of the first 224 tokens and one
      ``decode_step`` at positions 223 and 224, within 3e-3 (the
      reference's gate), on the same frames;
    - the f32 card forward against the same forward on the CPU (the plain
      path, the same weights), within ``WHISPER_CPU_TOL`` (1e-3);
    - greedy decoding in bf16: the 4-token start-of-transcript prompt,
      ``max_len`` 448, then 124 greedy steps; ``prefill`` must launch flash
      8 times (encoder and cross-attention), each decode step exactly 4
      (the cross-attention; the self-attention takes the KV-cache
      einsums).  It prints encode and prefill ms, the decode step's p50
      and p99, tokens/s and launches a step.

    Returns (model, params, cache, tokens) of the last decode step, for
    the profile."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model, encdec
    t_phase = time.perf_counter()
    cfg = get_config("whisper-tiny")
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"[whisper] {cfg.name}: {model.param_count(params) / 1e6:.1f} M "
          f"params ({cfg.param_dtype}), {cfg.encdec.n_enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d={cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.hd}, vocab {cfg.vocab}, "
          f"{params['dec_pos'].shape[0]} decoder positions")
    rng = np.random.default_rng(0)
    B = 4
    frames = torch.from_numpy(rng.standard_normal(
        (B, WHISPER_FRAMES, cfg.d_model)).astype(np.float32)).to(dev)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, WHISPER_TEXT)).astype(np.int32)).to(dev)
    names = list(counts())

    def flash_only(n):
        return {k: (n if k == "flash_attention" else 0) for k in names}

    def launched(fn, want, what):
        before = counts()
        out = fn()
        got = {k: v - before[k] for k, v in counts().items()}
        check(got == want, f"[whisper] {what} launched {got}, not {want}")
        return out

    n_enc, n_dec = cfg.encdec.n_enc_layers, cfg.n_layers
    fwd_want = flash_only(n_enc + 2 * n_dec)
    with torch.inference_mode():
        walls = []
        for _ in range(4):  # the first warms cuBLAS up
            t0 = time.perf_counter()
            logits = launched(lambda: model.forward(params, toks,
                                                    frames=frames)[0],
                              fwd_want, "bf16 forward")
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        check(logits.shape == (B, WHISPER_TEXT, cfg.vocab)
              and logits.dtype == torch.bfloat16,
              f"[whisper] bf16 forward: {tuple(logits.shape)} {logits.dtype}")
        check(bool(torch.isfinite(logits).all()),
              "[whisper] bf16 forward: non-finite logits")
        del logits
        fwd_ms = statistics.median(walls[1:])
        print(f"[whisper] forward bf16 ({B}, {WHISPER_TEXT}) tokens over "
              f"({B}, {WHISPER_FRAMES}) frames: {fwd_ms:.1f} ms median of 3 "
              f"(first {walls[0]:.1f} ms); finite logits; flash launches "
              f"per forward {n_enc + 2 * n_dec}")

        m32 = Model(dataclasses.replace(cfg, compute_dtype="float32"))
        half = WHISPER_TEXT // 2
        t0 = time.perf_counter()
        full = launched(lambda: m32.forward(params, toks, frames=frames)[0],
                        fwd_want, "f32 forward")
        torch.cuda.synchronize()
        f32_ms = (time.perf_counter() - t0) * 1e3
        logits_p, cache = launched(
            lambda: m32.prefill(params, toks[:, :half], max_len=half + 1,
                                frames=frames),
            flash_only(n_enc + n_dec), "f32 prefill")
        logits_d, _ = launched(
            lambda: m32.decode_step(params, cache, toks[:, half:half + 1]),
            flash_only(n_dec), "f32 decode step")
        err_p = float((logits_p[:, -1] - full[:, half - 1]).abs().max())
        err_d = float((logits_d[:, -1] - full[:, half]).abs().max())
        del logits_p, logits_d, cache
        check(err_p < 3e-3 and err_d < 3e-3,
              f"[whisper] f32 forward vs prefill+decode: {err_p}, {err_d} "
              ">= 3e-3")
        print(f"[whisper] forward f32 {f32_ms:.1f} ms: logits at "
              f"{half - 1}/{half} vs prefill({half}) + decode_step: "
              f"max|diff| {err_p:.2e} / {err_d:.2e} (gate 3e-3)")

        cpu_params = torch.utils._pytree.tree_map(lambda t: t.cpu(), params)
        t0 = time.perf_counter()
        want, _ = m32.forward(cpu_params, toks.cpu(), frames=frames.cpu())
        cpu_ms = (time.perf_counter() - t0) * 1e3
        err_c = float((full.cpu() - want).abs().max())
        scale = float(want.abs().max())
        del full, want, cpu_params
        check(err_c <= WHISPER_CPU_TOL,
              f"[whisper] f32 card forward vs CPU: {err_c} > "
              f"{WHISPER_CPU_TOL}")
        print(f"[whisper] f32 card forward vs the CPU's plain path "
              f"({cpu_ms:.0f} ms there): max|diff| {err_c:.2e} (gate "
              f"{WHISPER_CPU_TOL}; max|logit| {scale:.3f})")

        prompt = torch.tensor([WHISPER_PROMPT] * B, dtype=torch.int32,
                              device=dev)
        encdec.encode(cfg, params, frames)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launched(lambda: encdec.encode(cfg, params, frames),
                 flash_only(n_enc), "encode")
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        logits, cache = launched(
            lambda: model.prefill(params, prompt, max_len=WHISPER_TEXT,
                                  frames=frames),
            flash_only(n_enc + n_dec), "prefill")
        tok = model.greedy_token(logits)[:, None]
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        steps, out = [], [tok]
        for _ in range(WHISPER_STEPS):
            t0 = time.perf_counter()
            step_in = tok
            logits, cache = launched(
                lambda: model.decode_step(params, cache, step_in),
                flash_only(n_dec), "decode step")
            tok = model.greedy_token(logits)[:, None]
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            out.append(tok)
        check(bool(torch.isfinite(logits).all()),
              "[whisper] greedy decoding: non-finite logits")
        n_tok = len(WHISPER_PROMPT) + WHISPER_STEPS
        check(int(cache["step"]) == n_tok
              and bool(cache["self"]["index"].eq(n_tok).all()),
              f"[whisper] the cache stands at step {int(cache['step'])}, "
              f"not {n_tok}")
        gen = torch.cat(out, dim=1)
        check(bool(((gen >= 0) & (gen < cfg.vocab)).all()),
              "[whisper] greedy tokens out of the vocabulary")
        print(f"[whisper] greedy bf16, {B} utterances, prompt "
              f"{len(WHISPER_PROMPT)} tokens, {WHISPER_STEPS} steps, "
              f"max_len {WHISPER_TEXT}: encode {enc_ms:.2f} ms, prefill "
              f"{prefill_ms:.2f} ms (encode included), decode step p50 "
              f"{pct(steps, 50):.2f} / p99 {pct(steps, 99):.2f} ms, "
              f"{B * WHISPER_STEPS / (sum(steps) / 1e3):.1f} tok/s; flash "
              f"launches: prefill {n_enc + n_dec}, {n_dec} a step; "
              f"{len(set(gen[0].tolist()))} distinct tokens in utterance 0")
    print(f"[whisper] phase 17 wall: {time.perf_counter() - t_phase:.1f} s")
    return model, params, cache, tok


# -- phases 6-9: the decoder LMs -----------------------------------------------------

def describe(cfg) -> str:
    if cfg.moe is not None:
        m = cfg.moe
        return (f"{cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads}/"
                f"{cfg.n_kv_heads} heads, {m.n_experts} routed experts of "
                f"{m.d_expert} (top-{m.top_k}) + {m.n_shared} shared"
                + (f", layer 0 dense d_ff {cfg.d_ff}" if m.layer0_dense
                   else "")
                + (", ragged path" if cfg.moe_ragged else ", capacity path"))
    if cfg.ssm is None:
        return (f"{cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads}/"
                f"{cfg.n_kv_heads} heads")
    s = cfg.ssm
    di = s.expand * cfg.d_model
    line = (f"{cfg.n_layers} Mamba2 layers, d={cfg.d_model}, d_inner {di}, "
            f"{di // s.head_dim} heads of P={s.head_dim}, N={s.d_state}, "
            f"{s.n_groups} group(s), chunk {s.chunk}")
    if cfg.hybrid is not None:
        line += (f", a shared attention block ({cfg.n_heads}/"
                 f"{cfg.n_kv_heads} heads, d_ff {cfg.hybrid.shared_d_ff}) "
                 f"every {cfg.hybrid.period}")
    return line


def run_forward(torch, dev, counts, arch, batch, seq, per_forward,
                f32_rows=None, **overrides):
    """Full-width ``Model.forward`` of ``arch`` (its config with
    ``overrides``) on (batch, seq) tokens: bf16 finite, f32 against
    prefill + decode (on the first ``f32_rows`` rows only, if given: f32
    matmuls run on the FP32 units; of a MoE model, on the rows whose
    compared token both route alike, see :func:`compare_routes`), and
    exactly ``per_forward`` kernel launches per forward (every other
    kernel: none)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    published = get_config(arch)
    cfg = dataclasses.replace(published, **overrides)
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in torch.utils._pytree.tree_leaves(params))
    cut = (f", depth cut to {cfg.n_layers} of {published.n_layers} layers "
           "(every width published)"
           if cfg.n_layers != published.n_layers else "")
    print(f"[lm] {cfg.name}: {model.param_count(params) / 1e6:.1f} M "
          f"params ({cfg.param_dtype}, {nbytes / 2**30:.2f} GiB), "
          f"{describe(cfg)}{cut}, vocab {cfg.vocab}, init "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    g = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                         device=dev, dtype=torch.int32)
    want = {k: per_forward.get(k, 0) for k in counts()}

    def forward(m, t=toks):
        before = counts()
        logits, _ = m.forward(params, t)
        launched = {k: v - before[k] for k, v in counts().items()}
        check(launched == want, f"{cfg.name} forward launched {launched}, "
                                f"not {want}")
        return logits

    walls = []
    with torch.inference_mode():
        for _ in range(4):  # the first warms cuBLAS up
            t0 = time.perf_counter()
            logits = forward(model)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        check(logits.shape == (batch, seq, cfg.vocab)
              and logits.dtype == torch.bfloat16,
              f"bf16 forward: logits {tuple(logits.shape)} {logits.dtype}")
        check(bool(torch.isfinite(logits).all()), "bf16 forward: non-finite")
        del logits
        fwd_ms = statistics.median(walls[1:])
        print(f"[lm] {cfg.name} forward bf16 ({batch}, {seq}): {fwd_ms:.1f} "
              f"ms median of 3 (first {walls[0]:.1f} ms), "
              f"{batch * seq / fwd_ms * 1e3:.0f} tok/s; finite logits; "
              f"launches per forward {per_forward}")

        m32 = Model(dataclasses.replace(cfg, compute_dtype="float32"))
        half = seq // 2
        rows = toks[:f32_rows]
        t0 = time.perf_counter()
        with routing_recorder(cfg) as routes_full:
            full = forward(m32, rows)[:, half - 1:half + 1].clone()
        torch.cuda.synchronize()
        f32_ms = (time.perf_counter() - t0) * 1e3
        with routing_recorder(cfg) as routes_prefill:
            logits_p, cache = m32.prefill(params, rows[:, :half],
                                          max_len=half + 1)
        logits_d, _ = m32.decode_step(params, cache,
                                      rows[:, half:half + 1])
        # a row whose token half - 1 the two paths route to different
        # experts (at a near-tie, gated in compare_routes) has other logits
        # there by design: its logits are not compared
        same = (~compare_routes(cfg, routes_full, routes_prefill, len(rows),
                                half) if routes_full
                else torch.ones(len(rows), dtype=torch.bool, device=dev))
        check(bool(same.any()), f"f32 forward vs prefill: every row's token "
                                f"{half - 1} routed differently")
        err_p = float((logits_p[same, -1] - full[same, 0]).abs().max())
        err_d = float((logits_d[same, -1] - full[same, 1]).abs().max())
        del logits_p, cache
        check(err_p < 3e-3 and err_d < 3e-3,
              f"f32 forward vs prefill+decode: {err_p}, {err_d} >= 3e-3")
        some = (f" (the f32 check on {len(rows)} of the {batch} rows, for "
                "time)" if len(rows) < batch else "")
        routed = (f", compared on the {int(same.sum())} rows routed alike"
                  if not same.all() else "")
        print(f"[lm] {cfg.name} forward f32 ({len(rows)}, {seq}) "
              f"{f32_ms:.1f} ms{some}: logits at {half - 1}/{half} vs "
              f"prefill({half}) + decode_step{routed}: max|diff| "
              f"{err_p:.2e} / {err_d:.2e} (gate 3e-3)")
    return model, params, toks


@contextlib.contextmanager
def routing_recorder(cfg):
    """Records each ragged MoE layer's top-k expert choices, (tokens, k),
    and each token's gap between its k-th and (k+1)-th router logits,
    while the block runs (an empty list for other models)."""
    from repro_torch.models import moe
    routes: list = []
    if cfg.moe is None or not cfg.moe_ragged:
        yield routes
        return
    ragged = moe.moe_apply_ragged

    def recording(p, cfg_, x):
        logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
        k = cfg_.moe.top_k
        top = logits.topk(k + 1, dim=-1).values
        routes.append((routed_experts(logits, k), top[:, k - 1] - top[:, k]))
        return ragged(p, cfg_, x)

    moe.moe_apply_ragged = recording
    try:
        yield routes
    finally:
        moe.moe_apply_ragged = ragged


def routed_experts(logits, k):
    """The routed experts, in ascending order (softmax keeps the order of
    the logits, so the top-k of either is the same set)."""
    return logits.topk(k, dim=-1).indices.sort(dim=-1).values


ROUTE_TIE = 1e-3  # f32 router logits: the k-th and (k+1)-th choice tied


def compare_routes(cfg, full, prefill, batch, half):
    """How many tokens of the first ``half`` positions the f32 forward and
    the f32 prefill route to different expert sets, by MoE layer (not
    gated: a near-tie of the k-th and (k+1)-th router logits flips with
    the order of a sum).  Returns which rows' token ``half - 1`` routes
    differently in some layer.  Gated: where such a token first does, its
    k-th and (k+1)-th router logits in the forward lie within
    ``ROUTE_TIE`` (up to that layer both paths computed the same sums in
    another order, so only a tie can route them apart)."""
    import torch
    k = cfg.moe.top_k
    differ = [(f.reshape(batch, -1, k)[:, :half]
               != p.reshape(batch, half, k)).any(-1)
              for (f, _), (p, _) in zip(full, prefill)]  # (batch, half)
    per_layer = [int(d.sum()) for d in differ]
    last = [int(d[:, -1].sum()) for d in differ]
    print(f"[lm] {cfg.name} routing f32, forward vs prefill({half}): "
          f"{sum(per_layer)} of {batch * half * len(per_layer)} token "
          f"routings differ over {len(per_layer)} MoE layers (by layer "
          f"{per_layer}); at position {half - 1}: {sum(last)} "
          f"(by layer {last})")
    apart = torch.zeros(batch, dtype=torch.bool, device=differ[0].device)
    for layer, (d, (_, gap)) in enumerate(zip(differ, full)):
        for r in (d[:, -1] & ~apart).nonzero().flatten().tolist():
            g = float(gap.reshape(batch, -1)[r, half - 1])
            print(f"[lm] {cfg.name}: row {r}'s token {half - 1} first "
                  f"routes differently in MoE layer {layer}, its k-th and "
                  f"(k+1)-th router logits {g:.3e} apart (gate "
                  f"{ROUTE_TIE:.0e})")
            check(g < ROUTE_TIE, f"{cfg.name}: row {r}'s token {half - 1} "
                                 f"routes differently in layer {layer} "
                                 f"without a tie ({g:.3e} apart)")
        apart |= d[:, -1]
    return apart


def run_serve(torch, model, params, counts, per_decode=None,
              launcher_main=True, alone=8, n_requests=8,
              backend=None, reqs=None) -> dict:
    """The launcher's defaults: ``n_requests`` requests (8), 4 slots,
    max_len 128, max_new 16, on the card, through the launcher's ``main``
    (which builds its own weights) or, with ``launcher_main=False``,
    through a ``ServeEngine`` over ``backend`` (by default a
    ``LocalDecodeBackend`` of 4 slots and max_len 128 on the given model
    and weights), serving ``reqs`` if given, else the launcher's.  Every
    ``decode_step`` call must launch exactly
    ``per_decode`` kernels (every other kernel: none).  Returns each
    request's tokens, the tokens of the first ``alone`` requests decoded
    alone in a one-slot engine (not gated; for a deep model all 8 are
    most of the decode steps, and 0 runs none), the decode step's p50 ms
    and the TPOT p50 ms."""
    from repro_torch.core import trace
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import LocalDecodeBackend, ServeEngine
    reqs = reqs or launcher.requests(n_requests, model.cfg.vocab, 16)
    before = counts()
    rec = trace.enable(host="serve")  # the engine's decode/prefill spans
    try:
        with torch.inference_mode():
            if launcher_main:
                done = launcher.main(["--arch", model.cfg.name,
                                      "--requests", str(n_requests)])
            else:
                be = backend or LocalDecodeBackend(model, params, n_slots=4,
                                                   max_len=128)
                t0 = time.perf_counter()
                with ServeEngine(be) as eng:
                    for r in reqs:
                        eng.submit(r)
                    done = eng.run_until_drained()
                print(f"[serve] {model.cfg.name} (ServeEngine over "
                      f"LocalDecodeBackend, {be.n_slots} slots, max_len "
                      f"{be.max_len}{', int8 KV cache' * model.cfg.kv_quant}"
                      f"): {time.perf_counter() - t0:.2f} s wall")
        spans = [e for e in rec.events() if e.kind == "span"]
    finally:
        trace.disable()
    launched = {k: v - before[k] for k, v in counts().items()}
    # prompts go in one token a step (a prefill chunk is
    # LAUNCH_PREFILL_CHUNK decode steps): decode recurrences and KV-cache
    # einsums, never a full-sequence kernel (as in the JAX package); a MoE
    # layer on the ragged path launches the grouped matmul 3 times a step
    n_steps = (sum(e.name == "decode_chunk" for e in spans)
               + LAUNCH_PREFILL_CHUNK * sum(e.name == "prefill"
                                            for e in spans))
    want_launched = {k: (per_decode or {}).get(k, 0) * n_steps
                     for k in launched}
    check(launched == want_launched,
          f"serve launched kernels {launched} over {n_steps} decode steps, "
          f"not {want_launched}")
    want = {r.rid: r.max_new for r in reqs}
    check(sorted(r.rid for r in done) == sorted(want),
          f"serve: completed {sorted(r.rid for r in done)}")
    for r in done:
        check(len(r.tokens) == want[r.rid] and r.finish_reason == "length",
              f"serve: request {r.rid} gave {len(r.tokens)} tokens "
              f"({r.finish_reason}), wanted {want[r.rid]}")
        check([e.kind for e in r.slot_events] == ["join", "leave"],
              f"serve: request {r.rid} slot events {r.slot_events}")
    toks = sum(len(r.tokens) for r in done)
    span = (max(r.finished_at for r in done)
            - min(r.submitted_at for r in done))
    ttft = sorted(r.ttft * 1e3 for r in done)
    tpot = sorted(r.tpot * 1e3 for r in done if len(r.tokens) > 1)
    decode = sorted(e.dur * 1e3 for e in spans if e.name == "decode_chunk")
    prefill = sorted(e.dur * 1e3 for e in spans if e.name == "prefill")
    print(f"[serve] engine spans: decode step p50 {pct(decode, 50):.2f} ms "
          f"p99 {pct(decode, 99):.2f} ms over {len(decode)} steps; prefill "
          f"chunk ({LAUNCH_PREFILL_CHUNK} single-token steps) p50 "
          f"{pct(prefill, 50):.2f} ms over {len(prefill)} chunks")
    tokens = {r.rid: r.tokens for r in done}
    # each request alone in a one-slot engine
    solo = {r.rid: serve_alone(torch, model, params, r, 128)[0]
            for r in reqs[:alone]}
    same = (f"{sum(solo[rid] == tokens[rid] for rid in solo)}/{len(solo)} "
            f"requests (of {len(reqs)}) give the same tokens decoded alone "
            "(n_slots=1; not gated)")
    print(f"[serve] {model.cfg.name}: {len(done)} requests complete, {toks} "
          f"tokens in "
          f"{span * 1e3:.1f} ms: {toks / span:.1f} tok/s; ttft p50 "
          f"{pct(ttft, 50):.1f} ms p99 {pct(ttft, 99):.1f} ms; tpot p50 "
          f"{pct(tpot, 50):.2f} ms p99 {pct(tpot, 99):.2f} ms; launches "
          f"{launched}; {same}")
    return {"tokens": tokens, "alone": solo, "step_ms": pct(decode, 50),
            "tpot_ms": pct(tpot, 50)}


def memory(torch, label: str) -> None:
    free, total = torch.cuda.mem_get_info()
    print(f"[memory] {label}: peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, free "
          f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB")


def run_capacity_forward(torch, model, params, toks, counts, per_forward):
    """One bf16 forward of the same weights on the capacity path (the
    config's default): its time, exactly ``per_forward`` kernel launches
    (no grouped matmul), and the share of token-choices it dropped at its
    capacity factor (counted in a second run, whose per-layer reads would
    disturb the timing)."""
    import dataclasses
    from repro_torch.models import Model, moe
    cap = Model(dataclasses.replace(model.cfg, moe_ragged=False))
    n_moe = model.cfg.n_layers - int(model.cfg.moe.layer0_dense)
    want = {k: per_forward.get(k, 0) for k in counts()}
    with torch.inference_mode():
        walls = []
        for _ in range(2):  # the first warms up
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, aux = cap.forward(params, toks)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            launched = {k: v - before[k] for k, v in counts().items()}
            check(launched == want, f"capacity forward launched {launched}, "
                                    f"not {want}")
        check(bool(torch.isfinite(logits).all()), "capacity forward: "
                                                  "non-finite logits")
        del logits
        kept, choices = [], []
        dispatch_combine = moe._dispatch_combine

        def counting(probs, k, C):
            out = dispatch_combine(probs, k, C)
            kept.append(out[0].sum())
            choices.append(probs.shape[0] * probs.shape[1] * k)
            return out

        moe._dispatch_combine = counting
        try:
            cap.forward(params, toks)
        finally:
            moe._dispatch_combine = dispatch_combine
    check(len(kept) == n_moe, f"capacity forward: {len(kept)} MoE layers")
    dropped = 1.0 - float(torch.stack(kept).sum()) / sum(choices)
    C = moe.capacity(model.cfg.moe, toks.shape[1])
    print(f"[lm] {model.cfg.name} forward bf16 {tuple(toks.shape)}, capacity "
          f"path (C={C} a batch row and expert, capacity factor "
          f"{model.cfg.moe.capacity_factor}): {walls[1]:.1f} ms (first "
          f"{walls[0]:.1f} ms), aux {float(aux):.4f}; dropped "
          f"{dropped:.2%} of the token-choices over {n_moe} MoE layers "
          "(not gated: not dropless, so it differs from the ragged path)")


# -- phase 22: the dense and VLM archs at full width ---------------------------

# (arch, flash launches a forward: one a layer) of phase 22
WIDE_ARCHS = (("gemma-2b", 18), ("glm4-9b", 40), ("qwen2-vl-2b", 28))
# requests served by each model of phases 22 and 23 (the launcher's first
# 4 of 8; phase 7 serves all 8 and reruns them one by one)
SERVED_REQUESTS = 4
# 22b's image: its first position and its (rows, columns) of patches
VLM_IMAGE = (64, (32, 32))


def run_vlm_embeds_forward(torch, dev, counts, model, params, toks,
                           per_forward) -> None:
    """22b: qwen2-vl-2b's bf16 ``forward(positions=, input_embeds=)``: the
    text's embeddings with a block of seeded patch embeddings (an image of
    ``VLM_IMAGE``'s grid) and 3-D positions whose t, h and w streams
    differ over the image, so the three M-RoPE sections rotate by
    different positions.  Finite logits, exactly ``per_forward`` launches,
    and logits that differ from the text-only forward's."""
    from repro_torch.models import layers, transformer
    B, S = toks.shape
    start, grid = VLM_IMAGE
    n = grid[0] * grid[1]
    want = {k: per_forward.get(k, 0) for k in counts()}
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.inference_mode():
        embeds = layers.embed(params["embedding"], model.cfg, toks)
        patches = torch.randn((B, n, embeds.shape[-1]), generator=g,
                              device=dev) * embeds.float().std()
        embeds[:, start:start + n] = patches.to(embeds.dtype)
        pos = transformer.mrope_positions(B, S, start, grid, device=dev)
        img = pos[:, start:start + n]
        check(bool((img[..., 0] != img[..., 1]).any()
                   and (img[..., 1] != img[..., 2]).any()),
              "22b: the image's t, h and w positions do not differ")
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.forward(params, toks, positions=pos,
                                  input_embeds=embeds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launched = {k: v - before[k] for k, v in counts().items()}
        check(launched == want, f"22b forward launched {launched}, not "
                                f"{want}")
        check(logits.shape == (B, S, model.cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              f"22b: logits {tuple(logits.shape)}, or not finite")
        text, _ = model.forward(params, toks)
        moved = float((logits[:, start:].float()
                       - text[:, start:].float()).abs().max())
        del logits, text
    check(moved > 0, "22b: the image left the logits unchanged")
    print(f"[lm] {model.cfg.name} forward bf16 ({B}, {S}) through "
          f"input_embeds + 3-D positions ({n} seeded patch embeddings, a "
          f"{grid[0]} x {grid[1]} image at position {start}; t/h/w "
          f"sections {model.cfg.mrope_sections}): {wall_ms:.1f} ms, finite "
          f"logits, launches {per_forward}; max |logits - text-only "
          f"logits| from the image on {moved:.3f}")


def run_wide_phase(torch, dev, counts) -> None:
    """Phase 22: gemma-2b, glm4-9b and qwen2-vl-2b in turn at their
    published configs (f32 params, bf16 compute): 22a phase 6's forward
    checks, 22b (qwen2-vl-2b) the forward through ``input_embeds`` and 3-D
    positions, 22c 8 requests served (glm4-9b on the forward's weights:
    the launcher's ``main`` would build a second 37.6 GB copy), 22d one
    traced bf16 forward and one traced decode step (4 slots); each model
    freed before the next.  The served requests (4 of the launcher's 8:
    ``SERVED_REQUESTS``) are not rerun one by one (phase 7 does that at
    qwen2-0.5b's cost)."""
    import gc
    t_phase = time.perf_counter()
    for arch, n_flash in WIDE_ARCHS:
        per_forward = {"flash_attention": n_flash}
        model, params, toks = run_forward(torch, dev, counts, arch, 4, 2048,
                                          per_forward)
        if model.cfg.mrope:
            run_vlm_embeds_forward(torch, dev, counts, model, params, toks,
                                   per_forward)
        run_serve(torch, model, params, counts,
                  launcher_main=arch != "glm4-9b", alone=0,
                  n_requests=SERVED_REQUESTS)
        profile_model(torch, model, params, toks)
        memory(torch, f"phase 22, {arch}")
        del model, params, toks
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[lm] phase 22 wall: {time.perf_counter() - t_phase:.1f} s")


# -- phase 23: yi-34b and phi3.5-moe with bf16 weights -------------------------

# (arch, config overrides, launches a forward, launches a decode step, rows
# of the f32 check (None: all 4)) of phase 23.  yi-34b is the published
# config (68.8 GB of bf16 weights); phi3.5-moe's 32 layers are 83.75 GB in
# bf16, more than the card holds, so its depth is cut to 24 (62.9 GB) with
# every width published.  yi's f32 check (5.6e14 FLOP on the FP32 units
# for all 4 rows) runs on one row.
BF16_ARCHS = (
    ("yi-34b", {}, {"flash_attention": 60}, {}, 1),
    ("phi3.5-moe-42b-a6.6b", {"n_layers": 24, "moe_ragged": True},
     {"flash_attention": 24, "moe_gmm": 72}, {"moe_gmm": 72}, None),
)


def run_bf16_phase(torch, dev, counts) -> None:
    """Phase 23: yi-34b and phi3.5-moe with bf16 weights, as the JAX package
    serves them (``param_dtype="bfloat16"``, as its dry-run sets for every
    serving cell), one at a time on the emptied card: 23a phase 6's forward
    checks (phi on the ragged path, its routing compared, then one
    capacity-path forward), 23b ``SERVED_REQUESTS`` requests served on 4
    slots through a ``ServeEngine`` on the forward's weights (not rerun
    one by one), 23c a traced forward and decode step, and the peak
    memory; then 23d serves yi-34b's weights from an int8 KV cache
    (:func:`run_int8_cache`)."""
    import gc
    t_phase = time.perf_counter()
    for arch, over, per_forward, per_decode, f32_rows in BF16_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()  # yi's MLP stack is one 17.6 GB block
        model, params, toks = run_forward(
            torch, dev, counts, arch, 4, 2048, per_forward, f32_rows=f32_rows,
            param_dtype="bfloat16", **over)
        memory(torch, f"phase 23, {arch}: init and forwards")
        if model.cfg.moe is not None:
            run_capacity_forward(
                torch, model, params, toks, counts,
                {"flash_attention": per_forward["flash_attention"]})
        run_serve(torch, model, params, counts, per_decode=per_decode,
                  launcher_main=False, alone=0, n_requests=SERVED_REQUESTS)
        profile_model(torch, model, params, toks,
                      ", ragged" if model.cfg.moe_ragged else "")
        memory(torch, f"phase 23, {arch}")
        del toks
        if arch == "yi-34b":
            run_int8_cache(torch, dev, counts, model, params)
        del model, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[lm] phase 23 wall: {time.perf_counter() - t_phase:.1f} s")


# -- phase 23d: yi-34b served from an int8 KV cache --------------------------

# 23d serves 4 requests on 2 slots of the JAX package's decode_32k length
# (src/repro/configs/base.py: 32,768 positions)
INT8_SLOTS, INT8_MAX_LEN = 2, 32768
# the int8 cache's bytes against the bf16 cache's: the JAX package's
# contract (tests/test_models.py, test_cache_half_size)
INT8_CACHE_RATIO = 0.55
# the two caches compared on the same weights: rows, prompt, teacher-forced
# decode steps (each position's logits compared)
INT8_COMPARE = (2, 64, 8)
# the gate on ||logits(int8 cache) - logits(bf16 cache)|| / ||logits(bf16
# cache)|| over every compared position, bf16 compute.  The CPU readings of
# `tools/lm_phase.py int8 cpu` (seed-0 yi-34b, INT8_COMPARE): 0.0153 /
# 0.0239 / 0.0303 / 0.0316 at reduced width and 2 / 8 / 30 / 60 layers,
# 0.0154 / 0.0182 at published widths with 1 / 2 layers (vocab 1024); the
# error grows with depth, so the gate is 2.5x the largest reading.  A cache
# quantised with a wrong scale, or its rows written at the wrong positions,
# is off by O(1).
INT8_LOGITS_GATE = 0.08


def teacher_forced(torch, model, params, toks, steps: int) -> tuple:
    """A prefill of ``toks[:, :-steps]`` on a cache of ``toks``' length,
    then ``steps`` decode steps feeding the rest of ``toks``: (the last
    position's logits of the prefill and of each step, (B, steps + 1, V)
    in f32, the cache)."""
    P, T = toks.shape[1] - steps, toks.shape[1]
    with torch.inference_mode():
        out, cache = model.prefill(params, toks[:, :P], max_len=T)
        got = [out[:, -1].float()]
        for t in range(P, T):
            out, cache = model.decode_step(params, cache, toks[:, t:t + 1])
            got.append(out[:, -1].float())
    return torch.stack(got, 1), cache


def compare_int8_cache(torch, model, params, toks, steps: int) -> dict:
    """``model`` (its cache in the compute dtype) against the same config
    with ``kv_quant`` on the same weights, each :func:`teacher_forced` on
    ``toks``.  Returns {"rel": the relative norm of the logits' difference
    over every compared position, "worst": the largest at one row and
    position, "same": how many greedy tokens agree, "of": how many were
    compared}."""
    import dataclasses
    from repro_torch.models import Model
    quant = Model(dataclasses.replace(model.cfg, kv_quant=True))
    plain = teacher_forced(torch, model, params, toks, steps)[0]
    q = teacher_forced(torch, quant, params, toks, steps)[0]
    diff = q - plain
    same = q.argmax(-1) == plain.argmax(-1)
    return {"rel": float(diff.norm() / plain.norm()),
            "worst": float((diff.norm(dim=-1) / plain.norm(dim=-1)).max()),
            "same": int(same.sum()), "of": same.numel()}


def int8_cpu_readings() -> list:
    """:func:`compare_int8_cache`'s readings on the CPU, from which
    ``INT8_LOGITS_GATE`` was set: seed-0 yi-34b with bf16 weights and
    compute, at reduced width with 2, 8, 30 and 60 layers, and at published
    widths with 1 and 2 layers (vocab cut to 1024, so the two unembedding
    tables stay small)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    rows, prompt, steps = INT8_COMPARE
    out = []
    cases = [(True, n, {}) for n in (2, 8, 30, 60)] + \
        [(False, n, {"vocab": 1024}) for n in (1, 2)]
    for reduced, n, over in cases:
        cfg = dataclasses.replace(get_config("yi-34b", reduced=reduced),
                                  n_layers=n, param_dtype="bfloat16",
                                  compute_dtype="bfloat16", **over)
        model = Model(cfg)
        params = model.init(seed=0, device="cpu")
        g = torch.Generator().manual_seed(0)
        toks = torch.randint(0, cfg.vocab, (rows, prompt + steps),
                             generator=g, dtype=torch.int32)
        r = compare_int8_cache(torch, model, params, toks, steps)
        label = (f"{'reduced' if reduced else 'published'} widths, {n} "
                 f"layer{'s' * (n > 1)}{', vocab 1024' if over else ''}")
        print(f"[int8] yi-34b {label}: logits ||int8 - bf16|| / ||bf16|| "
              f"{r['rel']:.4f} (worst position {r['worst']:.4f}); greedy "
              f"tokens agree {r['same']}/{r['of']}")
        out.append(r)
        del model, params
    return out


def int8_flip_readings() -> dict:
    """How far an int8 cache carries a difference of f32 rounding: yi-34b
    at published widths cut to 2 layers (vocab 1024, bf16 weights, f32
    compute, ``INT8_CARD_CPU``'s prefill and decode steps) on the CPU,
    against itself with its embedding table perturbed by 1e-6 relative
    noise.  Prints and returns the logits' relative norm and, for each
    layer, the int8 elements one step apart and the scales' error (the
    readings behind 25c's gates)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    rows, prompt, n_steps = INT8_CARD_CPU
    cfg = dataclasses.replace(get_config("yi-34b"), n_layers=2, vocab=1024,
                              param_dtype="bfloat16",
                              compute_dtype="float32", kv_quant=True)
    model = Model(cfg)
    params = model.init(seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (rows, prompt + n_steps),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)

    def run(p):
        logits, cache = teacher_forced(torch, model, p, toks, n_steps)
        return logits, cache["segments"][0]

    a, ca = run(params)
    table = params["embedding"]["embed"].float()
    noise = torch.randn(table.shape,
                        generator=torch.Generator().manual_seed(5))
    moved = dict(params, embedding=dict(params["embedding"],
                                        embed=table * (1 + 1e-6 * noise)))
    b, cb = run(moved)
    out = {"rel": float((a - b).norm() / b.norm()), "layers": []}
    for layer in range(cfg.n_layers):
        flips = sum(int(((ca[n][layer].int() - cb[n][layer].int()).abs()
                         == 1).sum()) for n in ("k", "v"))
        elems = sum(ca[n][layer].numel() for n in ("k", "v"))
        scale = max(float((ca[n][layer] - cb[n][layer]).abs().max()
                          / cb[n][layer].abs().max())
                    for n in ("k_scale", "v_scale"))
        out["layers"].append((flips, elems, scale))
    print(f"[int8] yi-34b published widths, 2 layers, vocab 1024, f32 "
          f"compute, against itself with the embedding table 1e-6 off: "
          f"logits {out['rel']:.3e} apart in relative norm; " + "; ".join(
              f"layer {i}: {f} of {e:,} int8 elements one step apart, "
              f"scales {sc:.2e} of the largest apart"
              for i, (f, e, sc) in enumerate(out["layers"])))
    return out


def run_int8_cache(torch, dev, counts, model, params) -> None:
    """23d: yi-34b (``model``, bf16 weights ``params``, phase 23's) served
    from an int8 KV cache: a second ``Model`` with ``kv_quant=True`` on the
    same weights serves ``SERVED_REQUESTS`` of the launcher's requests on
    ``INT8_SLOTS`` slots of ``INT8_MAX_LEN`` positions (no kernel
    launched: a decode step's attention reads the dequantised cache).  It
    prints the cache's bytes beside the bf16 cache's at that size (reckoned
    on the meta device; gate ``INT8_CACHE_RATIO``), the peak device memory,
    TPOT p50 and a traced decode step's device idle share; then it compares
    the two caches on the same weights at ``INT8_COMPARE``'s short length
    (:func:`compare_int8_cache`, gate ``INT8_LOGITS_GATE``) and prints how
    many greedy tokens agree (not gated)."""
    import dataclasses
    import gc
    from repro_torch.models import Model, transformer
    from repro_torch.serve import LocalDecodeBackend
    t0 = time.perf_counter()
    cfg = dataclasses.replace(model.cfg, kv_quant=True)
    quant = Model(cfg)
    bf16_bytes = tree_bytes(transformer.init_cache(
        model.cfg, INT8_SLOTS, INT8_MAX_LEN, torch.device("meta")))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    backend = LocalDecodeBackend(quant, params, n_slots=INT8_SLOTS,
                                 max_len=INT8_MAX_LEN)
    int8_bytes = tree_bytes(backend.cache)
    ratio = int8_bytes / bf16_bytes
    print(f"[lm] 23d yi-34b int8 KV cache, {INT8_SLOTS} slots x "
          f"{INT8_MAX_LEN} positions: {int8_bytes:,} B "
          f"({int8_bytes / 2**30:.2f} GiB; int8 k and v, f32 scales a "
          f"position and head), the bf16 cache's {bf16_bytes:,} B "
          f"({bf16_bytes / 2**30:.2f} GiB): "
          f"{ratio:.4f}x (gate {INT8_CACHE_RATIO}); weights "
          f"{resident / 2**30:.2f} GiB resident beside it")
    check(ratio <= INT8_CACHE_RATIO, f"23d: int8 cache {int8_bytes} B is "
          f"{ratio:.4f}x the bf16 cache's {bf16_bytes} B")
    check(all(t.dtype == torch.int8 for seg in backend.cache["segments"]
              for name, t in seg.items() if name in ("k", "v")),
          "23d: the cache's k and v are not int8")
    run = run_serve(torch, quant, params, counts, launcher_main=False,
                    alone=0, n_requests=SERVED_REQUESTS, backend=backend)
    memory(torch, "phase 23d, yi-34b from the int8 cache")
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        last = torch.ones((INT8_SLOTS, 1), dtype=torch.int32, device=dev)
        adv = torch.ones(INT8_SLOTS, dtype=torch.bool, device=dev)
        _, busy_ms, wall_ms = profile_run(
            torch, f"23d yi-34b decode step ({INT8_SLOTS} slots, int8 cache "
            f"of {INT8_MAX_LEN})", lambda: quant.decode_step(
                params, backend.cache, last, advance=adv))
    print(f"[lm] 23d yi-34b served from the int8 cache: TPOT p50 "
          f"{run['tpot_ms']:.2f} ms, decode step p50 {run['step_ms']:.2f} ms"
          f", a traced decode step {1 - busy_ms / wall_ms:.1%} idle; peak "
          f"device memory {peak / 2**30:.2f} GiB "
          f"({(peak - resident) / 2**30:.2f} GiB above the weights)")
    del backend, run
    gc.collect()
    torch.cuda.empty_cache()
    rows, prompt, steps = INT8_COMPARE
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, model.cfg.vocab, (rows, prompt + steps),
                         generator=g, device=dev, dtype=torch.int32)
    before = counts()
    r = compare_int8_cache(torch, model, params, toks, steps)
    launched = {k: v - before[k] for k, v in counts().items()}
    check(not any(launched.values()), f"23d: the cached attention launched "
                                      f"{launched}")
    print(f"[lm] 23d yi-34b int8 cache against the bf16 cache on the same "
          f"weights, teacher-forced prefill of ({rows}, {prompt}) + {steps} "
          f"decode steps: logits ||int8 - bf16|| / ||bf16|| {r['rel']:.4f} "
          f"(gate {INT8_LOGITS_GATE}; worst position {r['worst']:.4f}); "
          f"greedy tokens agree {r['same']}/{r['of']} (not gated); 23d "
          f"wall {time.perf_counter() - t0:.1f} s")
    check(r["rel"] <= INT8_LOGITS_GATE, f"23d: int8 against bf16 cache "
          f"logits {r['rel']} > {INT8_LOGITS_GATE}")


# -- phase 18: training on the card -------------------------------------------

QWEN2_PARAMS = 494_032_768  # qwen2-0.5b, tied embeddings


def expected_train_launches(cfg) -> dict:
    """Kernel launches of one ``loss_fn`` forward and backward of ``cfg``
    on the card: the flash kernel once per full-sequence attention, the SSD
    kernel once per Mamba2 layer, the grouped matmul three times per MoE
    layer on the ragged path; twice each with ``remat="full"`` (forward
    and recompute), but for a hybrid's shared attention block, which runs
    outside remat as in the reference (zamba2-1.2b: 76 SSD and 6 flash a
    step).  The backwards run the plain versions: no launch."""
    from repro_torch.models import transformer
    rep = 2 if cfg.remat == "full" else 1
    want = {"flash_attention": 0, "ssd_scan": 0, "moe_gmm": 0}
    if cfg.family == "audio":
        want["flash_attention"] = rep * (cfg.encdec.n_enc_layers
                                         + 2 * cfg.n_layers)
    else:
        for kind, n in transformer.structure(cfg):
            if kind == "mamba":
                want["ssd_scan"] += rep * n
            else:
                want["flash_attention"] += (1 if kind == "shared_attn"
                                            else rep) * n
                if kind == "attn_moe" and cfg.moe_ragged:
                    want["moe_gmm"] += rep * 3 * n
    return want


def loss_and_grads(torch, model, params, batch):
    """(loss, {key path: gradient}) of ``model.loss_fn`` on ``batch``."""
    import torch.utils._pytree as pytree
    leaves, spec = pytree.tree_flatten_with_path(params)
    live = [p.detach().requires_grad_(True) for _, p in leaves]
    loss, _ = model.loss_fn(
        pytree.tree_unflatten(live, pytree.tree_structure(params)), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return float(loss.detach()), {
        pytree.keystr(path): (torch.zeros_like(p) if gr is None else gr)
        for (path, p), gr in zip(leaves, grads)}


def card_against_cpu(torch, dev, counts, label, model, params, batch, *,
                     loss_rel=None, grad_rel=None, abs_tol=None) -> None:
    """Loss and gradients of ``model`` on the card against the same on the
    CPU (the plain path, the same weights and batch), with exactly the
    launches :func:`expected_train_launches` names on the card.  Gates:
    ``loss_rel`` and ``grad_rel`` (each leaf's max |diff| against that
    leaf's max |grad|), or ``abs_tol`` for both.  The key bias ``bk`` is
    held to its sibling ``bq``'s scale: its exact gradient is zero (a
    shift shared by every key of a softmax row changes nothing), so what
    both sides compute for it is rounding."""
    from repro_torch.device import to_device
    want = {k: expected_train_launches(model.cfg).get(k, 0)
            for k in counts()}
    before = counts()
    t0 = time.perf_counter()
    loss_g, grads_g = loss_and_grads(torch, model, params, batch)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    launched = {k: v - before[k] for k, v in counts().items()}
    check(launched == want, f"{label}: launched {launched}, not {want}")
    loss_c, grads_c = loss_and_grads(torch, model, to_device(params, "cpu"),
                                     to_device(batch, "cpu"))
    loss_gate = abs_tol if abs_tol is not None else loss_rel * abs(loss_c)
    check(abs(loss_g - loss_c) <= loss_gate,
          f"{label}: loss {loss_g} on the card, {loss_c} on the CPU")
    worst, worst_key = 0.0, ""
    for key, gc in grads_c.items():
        diff = float((grads_g[key].cpu() - gc).abs().max())
        scale_key = key.replace("['bk']", "['bq']")
        scale = float(grads_c[scale_key].abs().max())
        limit = abs_tol if abs_tol is not None else grad_rel * scale
        check(diff <= limit, f"{label}: grad {key} differs by {diff} > "
                             f"{limit} (max|grad| of {scale_key} {scale})")
        if diff / limit >= worst:
            worst, worst_key = diff / limit, key
    print(f"[train] {label}: loss card {loss_g:.6f} / CPU {loss_c:.6f} "
          f"(gate {loss_gate:.2e}); {len(grads_c)} grad leaves, the worst "
          f"{worst_key} at {worst:.1%} of its gate; card launches "
          f"{launched}; card forward+backward {card_ms:.1f} ms")


@contextlib.contextmanager
def per_step_records(torch, counts):
    """Records each train step's launches, loss and wall (the step waits
    for the device): wraps ``make_train_step`` in the training loop's
    module while the block runs."""
    from repro_torch.launch.dryrun import tree_bytes  # before the patch
    from repro_torch.train import train_loop
    real = train_loop.make_train_step
    steps: list = []

    def counted(*args, **kw):
        step = real(*args, **kw)

        def run(*a):
            before = counts()
            torch.cuda.synchronize()
            # the step's own peak (phase 20b): the bytes resident beside
            # its arguments are subtracted from the card's peak over it
            peak_before = torch.cuda.max_memory_allocated()
            other = torch.cuda.memory_allocated() - tree_bytes(a)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = step(*a)
            loss = float(out[2]["loss"])
            steps.append({"launches": {k: v - before[k]
                                       for k, v in counts().items()},
                          "loss": loss, "s": time.perf_counter() - t0,
                          "peak_before": peak_before,
                          "step_peak": torch.cuda.max_memory_allocated()
                          - other, "arg_bytes": tree_bytes(a)})
            return out

        return run

    train_loop.make_train_step = counted
    try:
        yield steps
    finally:
        train_loop.make_train_step = real


def checked_steps(torch, counts, label, cfg, what, fn, n_steps: int,
                  tokens: int, warm: int) -> dict:
    """Runs ``fn``, a training loop of ``n_steps`` steps of ``tokens``
    tokens each, with each step recorded (:func:`per_step_records`): finite
    losses, and in every step exactly the launches
    :func:`expected_train_launches` names for ``cfg`` and no other kernel.
    Prints ``what``, the losses, the step wall p50 from step ``warm`` on,
    tokens/s and the peak device memory.  Returns {"steps": each step's
    records, "p50": s, "result": what ``fn`` returned}."""
    want = {k: expected_train_launches(cfg).get(k, 0) for k in counts()}
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with per_step_records(torch, counts) as steps:
        res = fn()
    wall = time.perf_counter() - t0
    losses = [s["loss"] for s in steps]
    check(len(losses) == n_steps and all(math.isfinite(x) for x in losses),
          f"{label}: losses {losses}")
    check(all(s["launches"] == want for s in steps),
          f"{label}: launches a step {[s['launches'] for s in steps]}, not "
          f"{want}")
    p50 = statistics.median(s["s"] for s in steps[warm:])
    print(f"[train] {label} {cfg.name} full width, {what}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; launches a step "
          f"{({k: v for k, v in want.items() if v})} (forward and remat's "
          "recompute), no other kernel")
    peak = max([torch.cuda.max_memory_allocated()]
               + [s["peak_before"] for s in steps])
    print(f"[train] {label} step wall p50 (steps {warm}-{n_steps - 1}) "
          f"{p50 * 1e3:.1f} ms, {tokens / p50:.0f} tokens/s; peak device "
          f"memory {peak / 2**30:.2f} GiB, {(peak - resident) / 2**30:.2f} "
          f"GiB above the {resident / 2**30:.2f} GiB resident before; the "
          f"loop's wall {wall:.1f} s")
    return {"steps": steps, "p50": p50, "result": res}


def train_through_launcher(torch, counts, label, arch, batch, seq,
                           n_steps: int = 8) -> dict:
    """``arch`` at full width trained through ``python -m
    repro_torch.launch.train``'s ``main``: ``n_steps`` steps of
    (``batch``, ``seq``), the default config (f32 params, bf16 compute,
    ``remat="full"``), with the verified network line and
    :func:`checked_steps`' checks, its p50 from step 2 on.  Returns
    :func:`checked_steps`' record, ``result`` what ``main`` returned (the
    trained trees)."""
    import io
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    args = ["--arch", arch, "--steps", str(n_steps), "--batch", str(batch),
            "--seq", str(seq)]
    out = io.StringIO()

    def main():
        with contextlib.redirect_stdout(out):
            return launcher.main(args)

    run = checked_steps(torch, counts, label, get_config(arch),
                        f"launcher main {' '.join(args)}", main, n_steps,
                        batch * seq, warm=2)
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith("[train]"):
            print(line)
    check(f"network train[{arch}] verified" in text,
          f"{label}: the launcher printed no verified line")
    return run


def run_train_launcher(torch, counts) -> list:
    """18a: full-width qwen2-0.5b trained through the launcher's ``main``
    (:func:`train_through_launcher`, (4, 1024): 48 flash launches a step,
    24 forward and 24 recompute), and its model FLOP utilisation.  Returns
    each step's (arguments' bytes, the card's peak over the step less the
    bytes resident beside its arguments), for phase 20b."""
    run = train_through_launcher(torch, counts, "18a", "qwen2-0.5b", 4, 1024)
    p50, steps = run["p50"], run["steps"]
    del run
    B, S, T = 4, 1024, 4096
    L, H, hd = 24, 14, 64
    attn = 6.0 * L * B * H * hd * S * (S + 1)
    flops = 6.0 * QWEN2_PARAMS * T + attn
    print(f"[train] 18a model FLOP utilisation {flops / p50 / BF16_PEAK:.2%}"
          f" = (6·N·T + 6·L·B·H·hd·S·(S+1)) / wall / 989e12 with N = "
          f"{QWEN2_PARAMS:,}, T = {T}, L = {L}, B = {B}, H = {H}, hd = {hd},"
          f" S = {S}: {6.0 * QWEN2_PARAMS * T:.4e} + {attn:.4e} = "
          f"{flops:.4e} FLOP a step (remat's recompute not counted)")
    return [(s["arg_bytes"], s["step_peak"]) for s in steps]


def run_train_grads(torch, dev, counts, params) -> None:
    """18b: gradients on the card against the CPU: full-width qwen2-0.5b
    in f32 on a (1, 128) batch from phase 6's weights (loss 1e-5 relative,
    each grad leaf within 1e-3 of its max |grad|); every architecture at
    reduced width in f32, and deepseek on its ragged path (1e-4)."""
    import dataclasses
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.device import to_device
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("qwen2-0.5b"),
                              compute_dtype="float32")
    model = Model(cfg)
    batch = SyntheticLM(1, 128, cfg.vocab, device=dev).create(0)
    card_against_cpu(torch, dev, counts, "18b qwen2-0.5b full width f32 "
                     "(1, 128), remat full", model, params, batch,
                     loss_rel=1e-5, grad_rel=1e-3)
    variants = [(a, {}) for a in sorted(ARCHS)] + \
        [("deepseek-moe-16b", {"moe_ragged": True})]
    for arch, over in variants:
        cfg = dataclasses.replace(get_config(arch, reduced=True), **over)
        model = Model(cfg)
        p = to_device(model.init(seed=0, device="cpu"), dev)
        batch = SyntheticLM(2, 32, cfg.vocab, device=dev).create(0)
        card_against_cpu(torch, dev, counts,
                         f"18b {arch}{'/ragged' if over else ''} reduced f32",
                         model, p, batch, abs_tol=1e-4)


def run_train_runner(torch, dev, counts) -> None:
    """18c: the reference's ``test_injected_failures_recovered`` on the
    card (reduced qwen2-0.5b, 12 steps, failures at 4 and 9, saves every
    3, async) and its ``test_loss_decreases`` (40 steps, lr 1e-2)."""
    import tempfile
    import torch.utils._pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.train import (AdamW, Checkpointer, FaultInjector,
                                   FaultTolerantRunner, make_train_step,
                                   train)
    model = Model(get_config("qwen2-0.5b", reduced=True))
    opt = AdamW(lr=1e-3)
    src = SyntheticLM(batch=4, seq=16, vocab=model.cfg.vocab, device=dev)
    step = make_train_step(model, opt)

    def step_fn(i, st):
        p, o, _ = step(st["params"], st["opt_state"], src.create(i))
        return {"params": p, "opt_state": o}

    params = model.init(seed=0, device=dev)
    state = {"params": params, "opt_state": opt.init(params)}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        runner = FaultTolerantRunner(Checkpointer(d, async_save=True),
                                     max_restarts=3)
        final = runner.run(total_steps=12, state=state, step_fn=step_fn,
                           save_every=3,
                           injector=FaultInjector(fail_at=(4, 9)))
        runner.ckpt.wait()
    run_s = time.perf_counter() - t0
    clean = state
    for i in range(12):
        clean = step_fn(i, clean)
    ours = {pytree.keystr(k): v for k, v in
            pytree.tree_flatten_with_path(final["params"])[0]}
    diff = max(float((ours[pytree.keystr(k)] - v).abs().max()) for k, v in
               pytree.tree_flatten_with_path(clean["params"])[0])
    on_card = all(v.is_cuda for v in ours.values())
    check(runner.restarts == 2 and diff < 1e-6 and on_card,
          f"18c: restarts {runner.restarts}, max|diff| {diff} to the clean "
          f"run, restored on the card {on_card}")
    print(f"[train] 18c runner on the card: 12 steps, failures at 4 and 9, "
          f"async saves every 3: {runner.restarts} restarts, max|diff| "
          f"{diff:.2e} to a clean 12-step run (gate 1e-6), {run_s:.1f} s")
    src = SyntheticLM(batch=8, seq=32, vocab=model.cfg.vocab, device=dev)
    res = train(model, src, steps=40, opt=AdamW(lr=1e-2), device=dev,
                log_every=1)
    losses = [h["loss"] for h in res["history"]]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last < first - 0.25, f"18c: loss {first} -> {last}")
    print(f"[train] 18c loss decreases on the card: mean of the first 5 "
          f"{first:.4f}, of the last 5 {last:.4f} (gate: below first - "
          "0.25)")


def profile_train_step(torch, dev, params) -> None:
    """One full-width qwen2-0.5b train step (4, 1024) from ``params``,
    traced: the flash kernel's share and the plain backwards' share of the
    device's busy time (the device time of the kernels inside the
    backwards' profiler range)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.train import AdamW, make_train_step
    model = Model(get_config("qwen2-0.5b"))
    opt = AdamW()
    state = opt.init(params)
    batch = SyntheticLM(4, 1024, model.cfg.vocab, device=dev).create(0)
    step = make_train_step(model, opt)
    step(params, state, batch)  # warm-up
    profile_train_run(torch, "qwen2-0.5b train step (4, 1024)",
                      lambda: step(params, state, batch))


def profile_train_run(torch, label, fn) -> None:
    """:func:`profile_run` of a train step, and the plain backwards' share
    of its busy time (the device time of the kernels inside the
    backwards' profiler range)."""
    from repro_torch.kernels import _autograd
    avgs, busy_ms, wall_ms = profile_run(torch, label, fn)
    plain = [e for e in avgs if e.key == _autograd.PROFILE_LABEL]
    on_host = [e for e in plain if str(e.device_type).endswith("CPU")]
    backward_ms = sum(e.device_time_total for e in on_host) / 1e3
    print(f"[profile] {label}: the plain backwards take {backward_ms:.2f} ms"
          f" of device time in {sum(e.count for e in on_host)} calls, "
          f"{backward_ms / busy_ms:.1%} of busy {busy_ms:.2f} ms (wall "
          f"{wall_ms:.1f} ms)")


def run_train_phase(torch, dev, counts, params) -> list:
    """Phase 18 (18a-18c): training on the card, on phase 6's weights
    (``params``, f32, left unchanged); the caller counts its launches from
    0.  Returns 18a's step peaks (:func:`run_train_launcher`)."""
    import gc
    t_phase = time.perf_counter()
    peaks = run_train_launcher(torch, counts)
    gc.collect()
    torch.cuda.empty_cache()
    run_train_grads(torch, dev, counts, params)
    run_train_runner(torch, dev, counts)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] phase 18 wall: {time.perf_counter() - t_phase:.1f} s")
    return peaks


# -- phase 24: mamba2-2.7b, zamba2-1.2b and whisper-tiny trained at full width -

# steps of 24a-24c and 25b through the launcher (the step p50 over steps
# 2-4)
WIDE_TRAIN_STEPS = 5
# (label, arch, batch, seq, what 6·N·T leaves out) of 24a-24c
WIDE_TRAIN = (
    ("24a", "mamba2-2.7b", 4, 1024, "the SSD scans' FLOPs"),
    ("24b", "zamba2-1.2b", 4, 1024, "the SSD scans' and the shared "
                                    "block's attention FLOPs"),
    ("24c", "whisper-tiny", 4, 448, "the encoder's 1500 frames a row and "
                                    "the attention FLOPs"),
)
# (arch, config overrides, the cut as printed) of 24d: published widths
WIDE_TRAIN_CUTS = (
    ("mamba2-2.7b", {"n_layers": 2}, "cut to 2 of its 64 layers"),
    ("zamba2-1.2b", {"n_layers": 6}, "cut to its first segment: 6 of its "
                                     "38 Mamba2 layers and 1 of its 6 "
                                     "shared-block applications"),
    ("whisper-tiny", {}, "uncut: its published config"),
)


def print_mfu(label, params, tokens: int, p50: float, left_out: str) -> None:
    """The model FLOP utilisation of a train step of ``p50`` s over
    ``tokens`` tokens, by 6·N·T at the bf16 peak, and what that leaves
    out."""
    import torch.utils._pytree as pytree
    n = sum(t.numel() for t in pytree.tree_leaves(params))
    flops = 6.0 * n * tokens
    print(f"[train] {label} model FLOP utilisation "
          f"{flops / p50 / BF16_PEAK:.2%} = 6·N·T / wall / 989e12 with N = "
          f"{n:,}, T = {tokens}: {flops:.4e} FLOP a step ({left_out} and "
          f"remat's recompute not counted)")


def run_wide_train_phase(torch, dev, counts) -> None:
    """Phase 24: 24a-24c train mamba2-2.7b, zamba2-1.2b and whisper-tiny
    at full width through the launcher (:func:`train_through_launcher`),
    one at a time on the emptied card, and print each step's model FLOP
    utilisation by 6·N·T.  zamba2's launches a step are 76 SSD (38 Mamba2
    layers, forward and recompute) and 6 flash: its shared attention
    block runs outside remat, as in the reference, so it is not
    recomputed; whisper's 24 flash are 4 encoder layers and 4 decoder
    layers' self- and cross-attention, twice.  24e traces one more
    mamba2-2.7b step on 24a's trees (a donating step, as the loop runs it
    once it owns them).  24d holds each model's loss and gradients on the
    card against the CPU's at published widths, its depth cut, in f32 on
    a (1, 128) batch (loss within 1e-5 relative, each grad leaf within 1e-3
    of its max |grad|, as 18b holds qwen2)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.train import AdamW, make_train_step
    t_phase = time.perf_counter()
    for label, arch, batch, seq, left_out in WIDE_TRAIN:
        run = train_through_launcher(torch, counts, label, arch, batch, seq,
                                     n_steps=WIDE_TRAIN_STEPS)
        res = run["result"]
        print_mfu(label, res["params"], batch * seq, run["p50"], left_out)
        if arch == "mamba2-2.7b":  # 24e
            model = Model(get_config(arch))
            step = make_train_step(model, AdamW(), donate=True)
            toks = SyntheticLM(batch, seq, model.cfg.vocab,
                               device=dev).create(0)
            params, state = res["params"], res["opt_state"]
            profile_train_run(
                torch, f"24e {arch} train step ({batch}, {seq}), donating",
                lambda: step(params, state, toks))
            del model, step, toks, params, state
        memory(torch, f"phase 24, {arch}")
        del run, res
        gc.collect()
        torch.cuda.empty_cache()
    for arch, over, cut in WIDE_TRAIN_CUTS:
        cfg = dataclasses.replace(get_config(arch), compute_dtype="float32",
                                  **over)
        model = Model(cfg)
        params = model.init(seed=0, device=dev)
        batch = SyntheticLM(1, 128, cfg.vocab, device=dev).create(0)
        card_against_cpu(torch, dev, counts, f"24d {arch} published widths, "
                         f"{cut}; f32 (1, 128), remat full", model,
                         params, batch, loss_rel=1e-5, grad_rel=1e-3)
        del model, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] phase 24 wall: {time.perf_counter() - t_phase:.1f} s")


# -- phase 25: the chunked cross-entropy and the int8 cache at full width ----

# 25a: gemma-2b trained through `train` at train_4k's 4096 tokens a row with
# the loss over chunks of 512 positions; (batch, seq, loss_chunk, steps)
CHUNKED_TRAIN = (4, 4096, 512, 4)
# 25c: (arch, config overrides, the cut as printed); published widths, 2
# layers, f32 compute
LEVER_CUTS = (
    ("gemma-2b", {"n_layers": 2, "loss_chunk": 32},
     "cut to 2 of its 18 layers, the loss over 4 chunks of 32"),
    ("qwen2-vl-2b", {"n_layers": 2}, "cut to 2 of its 28 layers"),
)
# 25c's int8 cache on the card against the CPU: yi-34b at published widths
# cut to 2 layers, bf16 weights, f32 compute; (rows, prompt, decode steps)
INT8_CARD_CPU = (1, 64, 4)
# its gates: the logits' relative norm over every position, and for layer
# 0 and the layer after it the share of int8 payload elements one step
# apart (none may be further apart) and the f32 scales' error against the
# largest scale.  Layer 0's k and v come from the embeddings alone: the
# card's and the CPU's matmuls round in other orders, and an element
# within that rounding of a half step flips (the card read 2 of 147,456,
# scales 3.8e-7 apart, over 8 decode steps).  A flipped v moves layer 0's
# attention output by a step's share, so layer 1's k and v, and the
# logits, move by more: over 8 decode steps the card read 1031 flips
# (0.70 %), scales 3.5e-4 apart, logits 7.3e-4; the CPU against itself
# with its embedding table 1e-6 off (`tools/lm_phase.py int8 cpu`) reads
# 853 (0.58 %), 2.8e-4 and 6.9e-4 there, and 801 of 139,264 (0.58 %),
# 2.8e-4 and 7.2e-4 over these 4.  The gates are ~3-6x those readings; a
# wrong scale or row is off by O(1).
INT8_CARD_CPU_REL = 3e-3
INT8_CARD_CPU_FLIPS = (1e-3, 2e-2)
INT8_SCALE_REL = (1e-5, 2e-3)


def run_chunked_train(torch, dev, counts) -> None:
    """25a: gemma-2b at its published config with ``loss_chunk=512``
    trained through ``train`` on ``CHUNKED_TRAIN``'s (4, 4096) batches (the
    donating step; the first step is the warm-up), with
    :func:`checked_steps`' checks: 36 flash launches a step (18 layers,
    forward and remat's recompute; the chunked loss launches none); and
    the model FLOP utilisation by 6·N·T."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.train import train
    batch, seq, chunk, n_steps = CHUNKED_TRAIN
    cfg = dataclasses.replace(get_config("gemma-2b"), loss_chunk=chunk)
    src = SyntheticLM(batch, seq, cfg.vocab, device=dev)
    run = checked_steps(
        torch, counts, "25a", cfg, f"loss_chunk {chunk}, through train, "
        f"{n_steps} steps of ({batch}, {seq})",
        lambda: train(Model(cfg), src, steps=n_steps, device=dev,
                      log_every=1), n_steps, batch * seq, warm=1)
    walls = ", ".join(f"{s['s']:.3f}" for s in run["steps"])
    print(f"[train] 25a each step's wall: {walls} s")
    print_mfu("25a", run["result"]["params"], batch * seq, run["p50"],
              "the causal attention FLOPs")
    memory(torch, "phase 25a, gemma-2b")


def int8_card_against_cpu(torch, dev, counts) -> None:
    """25c: yi-34b at published widths cut to 2 layers with an int8 KV
    cache (bf16 weights, f32 compute): a prefill of ``INT8_CARD_CPU``'s
    prompt and its decode steps on the card and on the CPU from the same
    weights and tokens, no kernel launched on the card.  Layer 0's k and v
    come from the token embeddings alone, so its f32 scales are held to
    ``INT8_SCALE_REL[0]`` of the largest and its int8 payloads to at most
    ``INT8_CARD_CPU_FLIPS[0]`` of their elements one step apart (a value
    that the card's and the CPU's matmuls round to either side of a half
    step); layer 1's k and v also carry what layer 0's flips moved, so
    they get ``[1]``.  No element may be more than one step apart, and the
    logits are held to ``INT8_CARD_CPU_REL`` in relative norm over every
    position.  It prints each layer's flips and scale error."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.device import to_device
    from repro_torch.models import Model
    rows, prompt, n_steps = INT8_CARD_CPU
    cfg = dataclasses.replace(get_config("yi-34b"), n_layers=2,
                              param_dtype="bfloat16",
                              compute_dtype="float32", kv_quant=True)
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (rows, prompt + n_steps),
                         generator=g, device=dev, dtype=torch.int32)

    def run(p, t):
        logits, cache = teacher_forced(torch, model, p, t, n_steps)
        seg = to_device(cache["segments"][0], "cpu")  # (layer, B, T, K, hd)
        return logits.cpu(), seg

    before = counts()
    t0 = time.perf_counter()
    card, card_cache = run(params, toks)
    card_ms = (time.perf_counter() - t0) * 1e3
    launched = {k: v - before[k] for k, v in counts().items()}
    cpu, cpu_cache = run(to_device(params, "cpu"), toks.cpu())
    rel = float((card - cpu).norm() / cpu.norm())
    layers = []
    for layer in range(cfg.n_layers):
        r = {"flips": 0, "elems": 0, "gap": 0, "scale": 0.0, "by": []}
        for name in ("k", "v"):
            gap = (card_cache[name][layer].int()
                   - cpu_cache[name][layer].int()).abs()
            n = int((gap == 1).sum())
            r["flips"] += n
            r["elems"] += gap.numel()
            r["gap"] = max(r["gap"], int(gap.max()))
            r["by"].append(f"{name} {n}")
            want = cpu_cache[f"{name}_scale"][layer]
            err = (card_cache[f"{name}_scale"][layer] - want).abs().max()
            r["scale"] = max(r["scale"], float(err / want.abs().max()))
        layers.append(r)
    print(f"[train] 25c yi-34b int8 KV cache, published widths cut to 2 "
          f"layers, bf16 weights, f32 compute: prefill ({rows}, {prompt}) + "
          f"{n_steps} decode steps, card against CPU: logits ||diff|| / "
          f"||CPU|| {rel:.3e} (gate {INT8_CARD_CPU_REL}); " + "; ".join(
              f"layer {i}: {r['flips']} of {r['elems']:,} int8 elements one "
              f"step apart ({', '.join(r['by'])}; gate "
              f"{INT8_CARD_CPU_FLIPS[min(i, 1)]:.0e} of them), the largest "
              f"gap {r['gap']} step, scales {r['scale']:.2e} of the largest "
              f"apart (gate {INT8_SCALE_REL[min(i, 1)]:.0e})"
              for i, r in enumerate(layers))
          + f"; card {card_ms:.1f} ms, launches {launched}")
    check(not any(launched.values()), f"25c int8: launched {launched}")
    check(rel <= INT8_CARD_CPU_REL, f"25c int8: logits {rel}")
    for i, r in enumerate(layers):
        check(r["gap"] <= 1 and r["flips"]
              <= INT8_CARD_CPU_FLIPS[min(i, 1)] * r["elems"]
              and r["scale"] <= INT8_SCALE_REL[min(i, 1)],
              f"25c int8: layer {i}: {r}")


def run_lever_phase(torch, dev, counts) -> None:
    """Phase 25, the JAX package's two memory levers at full width, one
    model at a time on the emptied card: 25a gemma-2b trained with the
    chunked cross-entropy (:func:`run_chunked_train`); 25b qwen2-vl-2b
    trained through the launcher on (4, 1024) (:func:`train_through_launcher`,
    56 flash launches a step); 25c the card against the CPU at published
    widths with the depth cut, in f32 on (1, 128): gemma-2b's chunked loss
    and qwen2-vl-2b's loss with their gradients (18b's gates), and yi-34b's
    int8 cache (:func:`int8_card_against_cpu`)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    t_phase = time.perf_counter()
    run_chunked_train(torch, dev, counts)
    gc.collect()
    torch.cuda.empty_cache()
    run = train_through_launcher(torch, counts, "25b", "qwen2-vl-2b", 4, 1024,
                                 n_steps=WIDE_TRAIN_STEPS)
    print_mfu("25b", run["result"]["params"], 4 * 1024, run["p50"],
              "the causal attention FLOPs")
    memory(torch, "phase 25b, qwen2-vl-2b")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    for arch, over, cut in LEVER_CUTS:
        cfg = dataclasses.replace(get_config(arch), compute_dtype="float32",
                                  **over)
        model = Model(cfg)
        params = model.init(seed=0, device=dev)
        batch = SyntheticLM(1, 128, cfg.vocab, device=dev).create(0)
        card_against_cpu(torch, dev, counts, f"25c {arch} published widths, "
                         f"{cut}; f32 (1, 128), remat full", model, params,
                         batch, loss_rel=1e-5, grad_rel=1e-3)
        del model, params, batch
    int8_card_against_cpu(torch, dev, counts)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] phase 25 wall: {time.perf_counter() - t_phase:.1f} s")


# -- phase 26: the JAX package's long-context cells on real tensors -----------

# The JAX package's prefill_32k and long_500k cells (src/repro/configs/
# base.py:168, :170; what each runs: src/repro/launch/dryrun.py:197-221):
# ``Model.forward`` on rows of 32,768 tokens, and a decode step over a cache
# of 524,288 positions (long_500k is for the sub-quadratic archs only,
# :176-181).  prefill_32k's global batch of 32 rows is a mesh's; one card
# takes one row of it.  long_500k's batch of 1 is the JAX package's own.
LONG_SEQ = 32_768
LONG_ROWS, LONG_GLOBAL_ROWS = 1, 32
LONG_DECODE_LEN = 524_288
# (arch, launches a forward) of 26a-26c, one model at a time
LONG_ARCHS = (("mamba2-2.7b", {"ssd_scan": 64}),
              ("zamba2-1.2b", {"ssd_scan": 38, "flash_attention": 6}),
              ("qwen2-0.5b", {"flash_attention": 24}))
# the kernels' shapes in those forwards: SSD (batch, S, H, P, G, N), flash
# (B, H, K, Sq, Sk, D), causal
LONG_SSD = {"mamba2-2.7b": (1, LONG_SEQ, 80, 64, 1, 128),
            "zamba2-1.2b": (1, LONG_SEQ, 64, 64, 1, 64)}
LONG_FLASH = {"zamba2-1.2b": (1, 32, 32, LONG_SEQ, LONG_SEQ, 64),
              "qwen2-0.5b": (1, 14, 2, LONG_SEQ, LONG_SEQ, 64)}
# flash's plain version at 32,768 keys: query chunks of this many rows
# (mha_chunked: (1, 32, 1024, 32768) f32 logits a chunk; mha's whole
# logits would be 137 GB at zamba2's shape)
LONG_FLASH_CHUNK = 1024
# the causal-prefix check: the f32 forward's first rows against an f32
# forward of those tokens alone (gate 3e-3, as forward against decode)
PREFIX_ROWS = 2048
# the last rows compared: mamba2's f32 forward against prefill(S -
# LAST_ROWS) and LAST_ROWS decode steps (a prefill of an attention arch at
# this length forms (S, T) f32 logits: 68.7 GB for zamba2); every model's
# bf16 logits against its f32 ones there, in relative norm, within the
# arch's gate, which a bf16 forward with layer 0's output dropped must
# exceed.  Read on an H100 at 700 W: 0.0666, 0.0504 and 0.0226, the
# controls 1.393, 1.410 and 1.403; each gate is about 1.5x its reading
LAST_ROWS = 2
LONG_BF16_GATE = {"mamba2-2.7b": 0.1, "zamba2-1.2b": 0.08,
                  "qwen2-0.5b": 0.035}
# 26d: one seeded request of 16 prompt tokens (fed one a step, as serving
# does) and 16 new tokens, served from LONG_DECODE_LEN positions and from
# LONG_SHORT_LEN: f32 tokens equal, logits within LONG_LOGITS_GATE in
# relative norm (the masked positions add exact zeros; only the softmax's
# and the PV product's longer sums round otherwise)
LONG_REQUEST = (16, 16)
LONG_SHORT_LEN = 128
LONG_LOGITS_GATE = 1e-5
# mamba2-2.7b × long_500k: greedy decode steps from init_cache(1, 524,288)
# and from init_cache(1, 128)
MAMBA_LONG_STEPS = 8


def run_long_forward(torch, dev, counts, arch, per_forward) -> tuple:
    """26a-26c: ``arch`` at its published config (f32 weights, bf16
    compute) on a seeded (LONG_ROWS, LONG_SEQ) row: a cold and a warm bf16
    forward (finite logits of the right shape; wall, tokens/s and the peak
    above the weights), then the f32 forward, whose first PREFIX_ROWS rows
    must equal an f32 forward of those tokens alone (the causal-prefix
    check) and whose last LAST_ROWS + 1 rows the bf16 ones must follow
    within LONG_BF16_GATE; an SSM arch's also prefill(S - LAST_ROWS) and
    LAST_ROWS decode steps (:func:`teacher_forced`), within 3e-3.  Every
    forward and prefill launches exactly ``per_forward``.  Returns (model,
    weights)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(arch)
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    g = torch.Generator(device=dev).manual_seed(26)
    toks = torch.randint(0, cfg.vocab, (LONG_ROWS, LONG_SEQ), generator=g,
                         device=dev, dtype=torch.int32)
    want = {k: per_forward.get(k, 0) for k in counts()}
    R = LAST_ROWS + 1

    def launched_as_a_forward(fn, what):
        before = counts()
        out = fn()
        launched = {k: v - before[k] for k, v in counts().items()}
        check(launched == want, f"26 {arch} {what} launched {launched}, "
                                f"not {want}")
        return out

    walls = []
    with torch.inference_mode():
        for i in range(2):  # the first is cold
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = launched_as_a_forward(
                lambda: model.forward(params, toks), "bf16 forward")
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                del logits
        peak = torch.cuda.max_memory_allocated() - resident
        check(logits.shape == (LONG_ROWS, LONG_SEQ, cfg.vocab)
              and logits.dtype == torch.bfloat16,
              f"26 {arch}: logits {tuple(logits.shape)} {logits.dtype}")
        check(bool(torch.isfinite(logits).all()), f"26 {arch}: non-finite "
                                                  "bf16 logits")
        low = logits[:, -R:].float()
        del logits
        # the gate's control: the bf16 forward with the first layer's output
        # projection zeroed, so that its kernel's output is dropped
        seg = params["segments"][0]
        w = seg["attn"]["wo"] if "attn" in seg else seg["mamba"]["out_proj"]
        saved = w[0].clone()
        w[0].zero_()
        dropped, _ = launched_as_a_forward(
            lambda: model.forward(params, toks), "bf16 forward, layer 0 "
                                                 "dropped")
        w[0].copy_(saved)
        control = dropped[:, -R:].float()
        del dropped, saved
        tokens = LONG_ROWS * LONG_SEQ
        print(f"[long] 26 {arch} × prefill_32k forward bf16 ({LONG_ROWS}, "
              f"{LONG_SEQ}) (the cell's {LONG_GLOBAL_ROWS} rows are a mesh's;"
              f" one row on one card): {walls[1]:.1f} ms warm (cold "
              f"{walls[0]:.1f} ms), {tokens / walls[1] * 1e3:.0f} tok/s; "
              f"finite logits; launches a forward {per_forward}; peak "
              f"{peak / 2**30:.2f} GiB above the {resident / 2**30:.2f} GiB "
              f"of weights")
        m32 = Model(dataclasses.replace(cfg, compute_dtype="float32"))
        t0 = time.perf_counter()
        full, _ = launched_as_a_forward(lambda: m32.forward(params, toks),
                                        "f32 forward")
        head, tail = full[:, :PREFIX_ROWS].clone(), full[:, -R:].clone()
        del full
        torch.cuda.synchronize()
        f32_ms = (time.perf_counter() - t0) * 1e3
        alone, _ = launched_as_a_forward(
            lambda: m32.forward(params, toks[:, :PREFIX_ROWS]),
            f"f32 forward of {PREFIX_ROWS} tokens")
        err_prefix = float((alone - head).abs().max())
        del alone, head
        rel = float((low - tail).norm() / tail.norm())
        rel_control = float((control - tail).norm() / tail.norm())
        gate = LONG_BF16_GATE[arch]
        agree = int((low.argmax(-1) == tail.argmax(-1)).sum())
        print(f"[long] 26 {arch} forward f32 ({LONG_ROWS}, {LONG_SEQ}) "
              f"{f32_ms:.1f} ms: the first {PREFIX_ROWS} rows against an f32"
              f" forward of those tokens alone, max|diff| {err_prefix:.2e} "
              f"(gate 3e-3); the bf16 logits of the last {R} rows against "
              f"the f32 ones ||diff|| / ||f32|| {rel:.3e} (gate {gate}), "
              f"max|diff| {float((low - tail).abs().max()):.3e}, greedy "
              f"tokens agree {agree}/{R * LONG_ROWS}; the control (layer "
              f"0's output dropped) {rel_control:.3e} (must exceed the "
              f"gate)")
        check(err_prefix < 3e-3, f"26 {arch}: causal prefix {err_prefix}")
        check(rel <= gate < rel_control, f"26 {arch}: bf16 against f32 "
                                         f"{rel}, the control {rel_control}")
        if cfg.hybrid is None and cfg.ssm is not None:
            before = counts()
            got, cache = teacher_forced(torch, m32, params, toks, LAST_ROWS)
            launched = {k: v - before[k] for k, v in counts().items()}
            check(launched == want, f"26 {arch}: prefill and decode steps "
                                    f"launched {launched}, not {want}")
            del cache
            errs = (got - tail).abs().amax(dim=-1).flatten().tolist()
            print(f"[long] 26 {arch} f32 forward's last {R} rows against "
                  f"prefill({LONG_SEQ - LAST_ROWS}) + {LAST_ROWS} decode "
                  f"steps: max|diff| " + " / ".join(f"{e:.2e}" for e in errs)
                  + " (gate 3e-3)")
            check(max(errs) < 3e-3, f"26 {arch}: forward against prefill "
                                    f"and decode {errs}")
        del low, tail, control, toks
    return model, params


def run_mamba_long_decode(torch, dev, counts, model, params) -> None:
    """26d for mamba2-2.7b (no attention): MAMBA_LONG_STEPS greedy decode
    steps, bf16, from ``init_cache(1, LONG_DECODE_LEN)`` and from
    ``init_cache(1, LONG_SHORT_LEN)``: the caches' bytes are equal (the
    state does not grow with the length), so are the logits bit for bit,
    and no kernel is launched."""
    tok = torch.full((1, 1), 7, dtype=torch.int32, device=dev)
    sizes, runs = {}, {}
    before = counts()
    with torch.inference_mode():
        for max_len in (LONG_DECODE_LEN, LONG_SHORT_LEN):
            cache = model.init_cache(1, max_len, device=dev)
            sizes[max_len] = tree_bytes(cache)
            t, got, walls = tok, [], []
            for _ in range(MAMBA_LONG_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = model.decode_step(params, cache, t)
                t = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                got.append(logits[:, -1].float())
            runs[max_len] = (torch.cat(got), walls)
            del cache
    launched = {k: v - before[k] for k, v in counts().items()}
    same = torch.equal(runs[LONG_DECODE_LEN][0], runs[LONG_SHORT_LEN][0])
    print(f"[long] 26d mamba2-2.7b × long_500k: init_cache(1, "
          f"{LONG_DECODE_LEN}) {sizes[LONG_DECODE_LEN]:,} B, init_cache(1, "
          f"{LONG_SHORT_LEN}) {sizes[LONG_SHORT_LEN]:,} B; "
          f"{MAMBA_LONG_STEPS} greedy bf16 decode steps from each: logits "
          f"equal bit for bit {same}; step wall p50 "
          f"{statistics.median(runs[LONG_DECODE_LEN][1][1:]):.2f} ms; "
          f"launches {launched}")
    check(sizes[LONG_DECODE_LEN] == sizes[LONG_SHORT_LEN],
          f"26d mamba2: cache {sizes}")
    check(same, "26d mamba2: logits differ with the cache's length")
    check(not any(launched.values()), f"26d mamba2: launched {launched}")


class RecordingModel:
    """A model whose ``decode_step`` keeps each step's last-position
    logits in f32."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, params, cache, tokens, **kw):
        logits, cache = self.model.decode_step(params, cache, tokens, **kw)
        self.logits.append(logits[:, -1].float().clone())
        return logits, cache


def shared_kv_bytes(cfg, cache) -> int:
    """The bytes of the shared attention block's k and v in ``cache``."""
    from repro_torch.models import transformer
    return sum(seg[name].numel() * seg[name].element_size()
               for (kind, _), seg in zip(transformer.structure(cfg),
                                         cache["segments"])
               if kind == "shared_attn" for name in ("k", "v"))


def serve_alone(torch, model, params, req, max_len) -> tuple:
    """``req`` alone in a ``ServeEngine`` over a one-slot
    ``LocalDecodeBackend`` of ``max_len`` positions: (its tokens, each
    decode step's logits (steps, V) in f32, the shared k and v's bytes)."""
    from repro_torch.serve import LocalDecodeBackend, ServeEngine
    rec = RecordingModel(model)
    with torch.inference_mode():
        backend = LocalDecodeBackend(rec, params, n_slots=1, max_len=max_len)
        kv = shared_kv_bytes(model.cfg, backend.cache)
        with ServeEngine(backend) as eng:
            eng.submit(req)
            (done,) = eng.run_until_drained()
        del backend, eng
    return done.tokens, torch.cat(rec.logits), kv


def check_long_rope(torch, dev, cfg) -> None:
    """The rotary angles of every position up to LONG_DECODE_LEN
    (``rope_angles``' f32 angles reach 524,288 rad) on the card and on the
    CPU: each side's cos and sin within 1e-6 of float64's of its own f32
    angles, the inverse frequencies within two f32 ulps of each other
    (CUDA's powf is within 2 ulps), and the card's cos and sin within the
    CPU's plus the angles' difference."""
    from repro_torch.models import layers
    rot = int(cfg.hd * cfg.rope_fraction) // 2 * 2
    half = rot // 2
    sides = []
    for where in (dev, torch.device("cpu")):
        pos = torch.arange(LONG_DECODE_LEN, device=where)[None]
        cos, sin = layers.rope_angles(pos, rot, cfg.rope_theta)
        # the angles as rope_angles forms them (f32 inverse frequencies
        # times f32 positions)
        expo = torch.arange(0, half, dtype=torch.float32, device=where) / half
        inv = 1.0 / torch.pow(cfg.rope_theta, expo)
        ang = pos.float()[..., None] * inv
        err = max(float((cos.double() - torch.cos(ang.double())).abs().max()),
                  float((sin.double() - torch.sin(ang.double())).abs().max()))
        sides.append((cos.cpu(), sin.cpu(), inv.cpu(), ang.cpu(), err))
    (c_cos, c_sin, c_inv, c_ang, c_err), (h_cos, h_sin, h_inv, h_ang,
                                          h_err) = sides
    ulps = int((c_inv.view(torch.int32) - h_inv.view(torch.int32)).abs()
               .max())
    dang = float((c_ang - h_ang).abs().max())
    apart = max(float((c_cos - h_cos).abs().max()),
                float((c_sin - h_sin).abs().max()))
    print(f"[long] 26d rope_angles of positions 0-{LONG_DECODE_LEN - 1} "
          f"(rot {rot}, theta {cfg.rope_theta:g}): cos and sin against "
          f"float64's of the f32 angles: card {c_err:.2e}, CPU {h_err:.2e} "
          f"(gate 1e-6); inverse frequencies {ulps} ulp apart (gate 2); "
          f"card against CPU {apart:.2e} (gate: the angles' difference "
          f"{dang:.2e} + 1e-6)")
    check(c_err <= 1e-6 and h_err <= 1e-6, f"26d rope: {c_err}, {h_err}")
    check(ulps <= 2, f"26d rope: inverse frequencies {ulps} ulp apart")
    check(apart <= dang + 1e-6, f"26d rope: card against CPU {apart}")


def run_long_decode(torch, dev, counts, model, params) -> dict:
    """26d, zamba2-1.2b × long_500k: one seeded request (LONG_REQUEST)
    served by a ``ServeEngine`` over a one-slot ``LocalDecodeBackend`` of
    LONG_DECODE_LEN positions, bf16 compute on 26b's f32 weights, through
    :func:`run_serve` (TTFT, TPOT, the step's p50 and p99, no kernel
    launched a step); the shared k and v's bytes, exact; the peak above
    the resident weights and cache beside the float32 copies of fault 23;
    one traced decode step (device busy time, idle share, its device
    kernels against a step at LONG_SHORT_LEN, and its peak, returned for
    phase 20's dry-run); the bf16 tokens against the same request served
    from LONG_SHORT_LEN (not gated).  Then, with the bf16 cache freed, f32
    compute: the greedy tokens served from LONG_DECODE_LEN equal those from
    LONG_SHORT_LEN and the logits of every step agree within
    LONG_LOGITS_GATE.  And :func:`check_long_rope`."""
    import dataclasses
    import gc
    from torch.autograd import DeviceType
    from repro_torch.models import Model, layers, transformer
    from repro_torch.serve import LocalDecodeBackend, Request
    cfg = model.cfg
    n_shared = sum(kind == "shared_attn"
                   for kind, _ in transformer.structure(cfg))
    kv_want = n_shared * 2 * LONG_DECODE_LEN * cfg.n_kv_heads * cfg.hd
    g = torch.Generator().manual_seed(26)
    n_prompt, n_new = LONG_REQUEST
    req = Request(rid=0, prompt=tuple(torch.randint(
        1, cfg.vocab, (n_prompt,), generator=g).tolist()), max_new=n_new)
    gc.collect()
    torch.cuda.empty_cache()
    weights = torch.cuda.memory_allocated()
    with torch.inference_mode():
        backend = LocalDecodeBackend(model, params, n_slots=1,
                                     max_len=LONG_DECODE_LEN)
    torch.cuda.synchronize()
    kv, total = shared_kv_bytes(cfg, backend.cache), tree_bytes(backend.cache)
    resident = torch.cuda.memory_allocated()
    print(f"[long] 26d zamba2-1.2b × long_500k, bf16 cache of 1 row × "
          f"{LONG_DECODE_LEN} positions: {total:,} B, of which the shared "
          f"block's k and v ({n_shared} applications × 2 × "
          f"{LONG_DECODE_LEN} × {cfg.n_kv_heads} × {cfg.hd} × 2 B) "
          f"{kv:,} B and the Mamba2 states the rest; "
          f"{weights / 2**30:.2f} GiB of f32 weights beside it")
    check(kv == kv_want * 2, f"26d: shared k and v {kv} B, not "
                             f"{kv_want * 2}")
    # fault 23 cast each application's whole k and v to float32: one f32
    # copy of its k alone is the bf16 bytes of its k and v
    copy = kv // n_shared
    torch.cuda.reset_peak_memory_stats()
    run = run_serve(torch, model, params, counts, launcher_main=False,
                    alone=0, backend=backend, reqs=[req])
    peak = torch.cuda.max_memory_allocated() - resident
    print(f"[long] 26d served from {LONG_DECODE_LEN} positions: TPOT p50 "
          f"{run['tpot_ms']:.2f} ms, decode step p50 {run['step_ms']:.2f} ms;"
          f" peak {peak:,} B ({peak / 2**30:.2f} GiB) above the resident "
          f"weights and cache ({resident / 2**30:.2f} GiB), against one f32 "
          f"copy of an application's k, {copy:,} B (gate), and the "
          f"{2 * copy:,} B of f32 k and v that fault 23 cast")
    check(peak < copy, f"26d: peak {peak} above resident, not under one "
                       f"f32 copy of an application's k ({copy} B)")
    traced = {}
    with torch.inference_mode():
        last = torch.ones((1, 1), dtype=torch.int32, device=dev)
        adv = torch.ones(1, dtype=torch.bool, device=dev)
        for max_len in (LONG_DECODE_LEN, LONG_SHORT_LEN):
            be = backend if max_len == LONG_DECODE_LEN else \
                LocalDecodeBackend(model, params, n_slots=1, max_len=max_len)
            model.decode_step(params, be.cache, last, advance=adv)  # warm
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            avgs, busy, wall = profile_run(
                torch, f"26d zamba2-1.2b decode step, 1 slot of {max_len}",
                lambda: model.decode_step(params, be.cache, last,
                                          advance=adv))
            kernels = sum(e.count for e in avgs
                          if e.device_type == DeviceType.CUDA
                          and not getattr(e, "is_user_annotation", False))
            traced[max_len] = (kernels, busy, wall,
                               torch.cuda.max_memory_allocated() - base,
                               base)
            del be
    n_long, busy, wall, step_peak, step_base = traced[LONG_DECODE_LEN]
    print(f"[long] 26d a traced decode step from {LONG_DECODE_LEN} "
          f"positions: device busy {busy:.2f} ms of {wall:.2f} ms "
          f"({1 - busy / wall:.1%} idle), {n_long} device kernels against "
          f"{traced[LONG_SHORT_LEN][0]} from {LONG_SHORT_LEN} positions "
          f"(+{n_long - traced[LONG_SHORT_LEN][0]}: the cached attention "
          f"reads a bf16 cache in blocks of {layers.CAST_BLOCK_BYTES:,} B "
          f"of f32); its peak "
          f"{step_peak:,} B above the {step_base:,} B allocated before it")
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    short = serve_alone(torch, model, params, req, LONG_SHORT_LEN)[0]
    same = sum(a == b for a, b in zip(run["tokens"][0], short))
    print(f"[long] 26d bf16: {same}/{n_new} greedy tokens served from "
          f"{LONG_DECODE_LEN} positions equal those served from "
          f"{LONG_SHORT_LEN} (not gated)")
    m32 = Model(dataclasses.replace(cfg, compute_dtype="float32"))
    before = counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    toks_l, logits_l, kv32 = serve_alone(torch, m32, params, req,
                                         LONG_DECODE_LEN)
    peak32 = torch.cuda.max_memory_allocated() - base
    gc.collect()
    torch.cuda.empty_cache()
    toks_s, logits_s, _ = serve_alone(torch, m32, params, req,
                                      LONG_SHORT_LEN)
    launched = {k: v - before[k] for k, v in counts().items()}
    rel = float((logits_l - logits_s).norm() / logits_s.norm())
    print(f"[long] 26d f32: the same request from {LONG_DECODE_LEN} "
          f"positions (shared k and v {kv32:,} B; peak {peak32 / 2**30:.2f} "
          f"GiB above the weights) and from {LONG_SHORT_LEN}: greedy tokens "
          f"equal {toks_l == toks_s}; {logits_l.shape[0]} steps' logits "
          f"||diff|| / ||short|| {rel:.3e} (gate {LONG_LOGITS_GATE:.0e}), "
          f"max|diff| {float((logits_l - logits_s).abs().max()):.3e}; "
          f"launches {launched}")
    check(kv32 == kv_want * 4, f"26d f32: shared k and v {kv32} B")
    check(toks_l == toks_s, f"26d f32: tokens {toks_l} against {toks_s}")
    check(rel <= LONG_LOGITS_GATE, f"26d f32: logits {rel}")
    check(not any(launched.values()), f"26d f32: launched {launched}")
    del logits_l, logits_s
    check_long_rope(torch, dev, cfg)
    return {"peak": step_peak, "resident": step_base, "tpot_ms":
            run["tpot_ms"]}


def run_long_phase(torch, dev, counts) -> dict:
    """Phase 26, the JAX package's long-context cells on real, seeded
    tensors at published widths, one model at a time on the emptied card
    (its kernels at that length are checked in phase 1, by
    :func:`check_flash` and :func:`check_ssd`): 26a-26c each arch of LONG_ARCHS on
    prefill_32k's row (:func:`run_long_forward`); 26d mamba2-2.7b
    (:func:`run_mamba_long_decode`) and zamba2-1.2b
    (:func:`run_long_decode`) × long_500k.  Returns 26d's traced step for
    phase 20."""
    import gc
    t_phase = time.perf_counter()
    long = None
    for arch, per_forward in LONG_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        model, params = run_long_forward(torch, dev, counts, arch,
                                         per_forward)
        if arch == "mamba2-2.7b":
            run_mamba_long_decode(torch, dev, counts, model, params)
        if arch == "zamba2-1.2b":
            long = run_long_decode(torch, dev, counts, model, params)
        memory(torch, f"phase 26, {arch}")
        del model, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[long] phase 26 wall: {time.perf_counter() - t_phase:.1f} s")
    return long


def trace_long_step() -> dict:
    """26d's bf16 decode step (zamba2-1.2b at its published config: f32
    weights, bf16 compute; one row of a LONG_DECODE_LEN cache; one device)
    traced by the dry-run with fake CUDA tensors: its argument and temp
    bytes."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    tr = dryrun._trace_variant(
        get_config("zamba2-1.2b"),
        ShapeConfig("long_500k", LONG_DECODE_LEN, 1, "decode"), None, None,
        device="cuda")
    return {"ok": True, "argument_bytes": tr.argument_bytes,
            "temp_bytes": tr.temp_bytes, "seconds": tr.seconds}


def report_long_trace(rec: dict, card: dict) -> None:
    """Prints the dry-run's traced 26d step (``rec``: argument and temp
    bytes) beside the card's (``card``: its peak above what was allocated
    before it, and that), or why the dry-run could not trace it (not
    gated)."""
    if not rec["ok"]:
        print(f"[dryrun] 26d: the dry-run could not trace the step: "
              f"{rec['error']}")
        return
    print(f"[dryrun] 26d zamba2-1.2b decode step from {LONG_DECODE_LEN} "
          f"positions, one device: traced temp {rec['temp_bytes']:,} B "
          f"beside {rec['argument_bytes']:,} B of arguments (traced in "
          f"{rec['seconds']:.1f} s); the card's step peaked "
          f"{card['peak']:,} B above the {card['resident']:,} B allocated "
          f"before it; the traced temp is "
          f"{rec['temp_bytes'] / max(card['peak'], 1):.3f}x the card's (not "
          f"gated)")


# -- phase 19: the mesh, 2 ranks sharing the card ------------------------------

MESH_RANKS = 2
# 19b's gates on the bf16 step against one device, set from the readings
# of `tools/mesh_phase.py tp` on the card: as it is, the loss 2.7e-4 off,
# the gradients 7.2e-3 of a leaf's max, the AdamW update 6.0e-8 off;
# with the mesh's softmax scale 1 % too large, 1.4e-5, 2.0e-2, 1.2e-7;
# 10 % too large, 6.9e-4, 0.17, 1.2e-7.  The loss cannot tell a 1 % scale
# from bf16's rounding (nor can f32's 1e-4 gate: 3.8e-6); the gradients
# can.  The AdamW gate is f32 rounding: an ulp of 1.0 is 1.2e-7.
TP_STEP_LOSS_GATE = 4e-4
TP_STEP_GRAD_GATE = 1e-2
TP_STEP_ADAMW_GATE = 1e-6


def digest(arrays) -> str:
    """sha256 over the bytes of ``arrays`` in order (bit-for-bit gates
    across processes without shipping the images)."""
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _rank_grads(torch, model, params, batch):
    """(loss, {key path: gradient}) through the training step's own
    ``_value_and_grad`` (DTensor leaves stay sharded)."""
    import torch.utils._pytree as pytree
    from repro_torch.train.train_loop import _value_and_grad
    loss, _, grads = _value_and_grad(model, params, batch)
    flat, _ = pytree.tree_flatten_with_path(grads)
    return loss, {pytree.keystr(k): g for k, g in flat}


def _shard_rel(mesh_tree, one_tree) -> float:
    """The worst leaf of ``mesh_tree`` (DTensors) against the same tree on
    one device, each rank on its own shard (no collective): max |diff|
    over the whole one-device leaf's max |value|.  The key bias ``bk`` is
    held to its sibling ``bq``'s scale, as in phase 18b: its exact
    gradient is zero, so both sides hold rounding."""
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel.axes import is_dtensor
    got = dict((pytree.keystr(k), v) for k, v in
               pytree.tree_flatten_with_path(mesh_tree)[0])
    want = dict((pytree.keystr(k), v) for k, v in
                pytree.tree_flatten_with_path(one_tree)[0])
    worst = 0.0
    for key, leaf in got.items():
        one = want[key]
        if is_dtensor(leaf):
            one = distribute_tensor(one, leaf.device_mesh, leaf.placements,
                                    src_data_rank=None).to_local()
            leaf = leaf.to_local()
        scale = float(want[key.replace("['bk']", "['bq']")].abs().max())
        worst = max(worst, float((leaf - one).abs().max())
                    / max(scale, 1e-30))
    return worst


def tp_phase(rank: int, dev, reduced: bool, counted, out: dict) -> None:
    """19b in each rank: full-width qwen2-0.5b (``reduced``: the reduced
    one) on a (1, 2) ``data × model`` mesh.  In f32, the loss and the
    gradients of the mesh against one device (rank 0).  Then one training
    step of the default config (bf16 compute), timed, against the same
    step on one device (every rank): the loss, the step's gradients (its
    first moments, (1 - b1) times the clipped gradient) on each rank's
    shards, and its new parameters against the plain AdamW applied to the
    mesh's own gradients on each rank's shards."""
    import dataclasses

    import torch
    import torch.utils._pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM, shard_batch
    from repro_torch.launch.dryrun import CostCounter
    from repro_torch.launch.mesh import make_mesh, train_rules
    from repro_torch.models import Model
    from repro_torch.parallel.axes import is_dtensor, shard_ctx
    from repro_torch.train import AdamW
    from repro_torch.train.train_loop import make_train_step, place_state
    mesh2 = make_mesh((1, MESH_RANKS), ("data", "model"), device=dev.type)
    rules = train_rules()
    cfg = get_config("qwen2-0.5b", reduced=reduced)
    batch = SyntheticLM(4, 64 if reduced else 1024, cfg.vocab,
                        device=dev).create(0)
    db = shard_batch(batch, mesh2, rules.batch)
    model32 = Model(dataclasses.replace(cfg, compute_dtype="float32"))
    params = model32.init(seed=0, device=dev)  # phase 6's weights
    if rank == 0:
        loss1, grads1 = _rank_grads(torch, model32, params, batch)
    opt = AdamW()
    dp, dopt = place_state(params, opt.init(params), mesh2, rules)
    with shard_ctx(mesh2, rules):
        loss, grads = counted("tp_grads_f32", lambda: _rank_grads(
            torch, model32, dp, db))
    whole = {k: g.full_tensor() for k, g in grads.items()}  # every rank
    loss = float(loss.full_tensor())
    out["tp_loss"] = loss
    if rank == 0:
        out["tp_loss_err"] = abs(loss - float(loss1))
        out["tp_grad_rel"] = _shard_rel(whole, grads1)
        del grads1
    del whole, grads
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # one training step of the default config (bf16 compute), timed
    step = make_train_step(Model(cfg), opt)
    costs = CostCounter()  # phase 20c traces this step in a fake world
    with shard_ctx(mesh2, rules), costs:
        new_p, new_o, metrics = counted("tp_step", lambda: step(dp, dopt,
                                                                db))
    out["tp_step_costs"] = {"calls": costs.calls, "coll": costs.coll}
    out["tp_step_loss"] = float(metrics["loss"].full_tensor())
    _, one_o, one_m = step(params, opt.init(params), batch)
    out["tp_step_loss_one"] = float(one_m["loss"])
    out["tp_step_loss_err"] = abs(out["tp_step_loss"]
                                  - out["tp_step_loss_one"])
    out["tp_step_grad_rel"] = _shard_rel(new_o["m"], one_o["m"])
    del one_o
    local = lambda t: pytree.tree_map(  # noqa: E731
        lambda x: x.to_local() if is_dtensor(x) else x, t)
    plain = dataclasses.replace(opt, clip_norm=None)
    grads = pytree.tree_map(lambda m: m / (1 - opt.b1), local(new_o["m"]))
    want, _, _ = plain.update(grads, plain.init(grads), local(dp))
    out["tp_step_adamw_err"] = max(
        float((a - b).abs().max()) for a, b in
        zip(pytree.tree_leaves(local(new_p)), pytree.tree_leaves(want)))
    del dp, dopt, new_p, new_o, params, grads, want
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def mesh_counter(device: str):
    """(out, counted): ``counted(label, fn)`` runs ``fn()`` on the mesh and
    records in ``out`` its wall, its kernel launches and its collectives
    under ``label``."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.parallel import collectives as C
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out = {"launches": {k: 0 for k in launch_counts()}, "walls": {},
           "parts": {}, "stats": {}}

    def counted(label, fn):
        sync()
        reset_launch_counts()
        C.reset_stats()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out["walls"][label] = time.perf_counter() - t0
        got = launch_counts()
        out["parts"][label] = {k: v for k, v in got.items() if v}
        out["stats"][label] = C.stats()
        for k, v in got.items():
            out["launches"][k] += v
        return res

    return out, counted


def mesh_rank(rank: int, farm_digest: str, edge_digest: str,
              args: tuple, device: str = "cuda",
              reduced: bool = False) -> dict:
    """One rank of phase 19's world (every rank runs this, SPMD, on
    ``cuda:0``; ``device="cpu"`` and ``reduced`` (a reduced qwen2) make a
    quick dry run of the same code on the CPU).  Returns its gates, walls,
    launch counts (of the mesh runs only) and collectives."""
    import numpy as np
    import torch
    from repro_torch import workloads
    from repro_torch.core import build
    from repro_torch.interop import tree_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.pipeline import pipeline_forward, split_stages
    W, H, bands, iters, n_img, size = args
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    out, counted = mesh_counter(device)

    # 19a: the paper's networks, one block of the batch a rank
    mesh = make_mesh((MESH_RANKS,), ("data",), device=device)
    farm = build(workloads.mandelbrot_farm(width=W, height=H, bands=bands,
                                           iterations=iters, axis="data"),
                 mesh)
    img = counted("farm", lambda: workloads.assemble(
        farm.run(instances=bands)["collect"]))
    out["farm_equal"] = digest([img]) == farm_digest
    imgs = tree_from_numpy(workloads.synthetic_images(n_img, size), dev)
    pipe = build(workloads.image_pipeline(imgs, axis="data",
                                          nodes=MESH_RANKS), mesh)
    edges = counted("image", lambda: pipe.run(instances=n_img)["collector"])
    out["image_equal"] = digest(edges) == edge_digest
    del imgs, pipe, edges
    systems, truths = workloads.jacobi_systems(2, 4096)
    systems = tree_from_numpy(systems, dev)
    one = build(workloads.jacobi(systems, n=4096, nodes=MESH_RANKS,
                                 tol=1e-6), device=dev).run(
        instances=2)["collector"]
    jac = build(workloads.jacobi(systems, n=4096, nodes=MESH_RANKS,
                                 tol=1e-6, axis="data"), mesh)
    got = counted("jacobi", lambda: jac.run(instances=2)["collector"])
    out["jacobi_equal"] = all(np.array_equal(a, b) for a, b in zip(got, one))
    out["jacobi_err"] = max(float(np.max(np.abs(x - t)))
                            for x, t in zip(got, truths))
    del systems, jac

    # 19b: full-width qwen2-0.5b, tensor-parallel over a (1, 2) mesh
    tp_phase(rank, dev, reduced, counted, out)

    # 19c: GPipe over 2 stages and the int8 ring over 2 ranks
    stage = make_mesh((MESH_RANKS,), ("stage",), device=device)
    rng = np.random.default_rng(0)
    ws = torch.from_numpy((rng.normal(size=(8, 256, 256)) * 0.06).astype(
        np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=(16, 64, 256)).astype(
        np.float32)).to(dev)

    def block_fn(lp, h):
        for w in lp:
            h = torch.tanh(h @ w)
        return h

    got = counted("pipeline", lambda: pipeline_forward(
        block_fn, split_stages(ws, MESH_RANKS), x, mesh=stage,
        n_stages=MESH_RANKS, n_micro=4))
    # the layers in order on each microbatch (cuBLAS picks its kernel by
    # the row count, so the whole batch at once differs by rounding)
    seq = torch.cat([block_fn(ws, m) for m in x.chunk(4)])
    out["pipeline_err"] = float((got - seq).abs().max())
    out["pipeline_whole_err"] = float((got - block_fn(ws, x)).abs().max())
    g = torch.from_numpy((np.random.default_rng(2).normal(
        size=(MESH_RANKS, 1 << 20)) * 0.01).astype(np.float32)).to(dev)
    exact = g.sum(0)
    r1, err = counted("ring", lambda: C.ring_allreduce_int8(
        g[rank], mesh, "data", MESH_RANKS))
    r2, _ = C.ring_allreduce_int8(g[rank], mesh, "data", MESH_RANKS,
                                  error=err)
    scale = float(exact.abs().max())
    out["ring_rel"] = (float((r1 - exact).abs().max()) / scale,
                       float(((r1 + r2) / 2 - exact).abs().max()) / scale)
    return out


def _kinds(stats: dict) -> str:
    return ", ".join(f"{k} {v['calls']}x {v['bytes'] / 1e6:.1f} MB"
                     for k, v in sorted(stats.items())) or "none"


def staged_bytes(stats: dict) -> tuple:
    """(output bytes, bytes copied between the card and the host) of the
    collectives the ``hoststaged`` group ran in ``stats``
    (``collectives.stats()``), over every kind."""
    staged = [v for k, v in stats.items() if k.startswith("staged:")]
    return (sum(v["bytes"] for v in staged),
            sum(v["staged_bytes"] for v in staged))


def run_mesh_phase(torch, farm_digest, edge_digest, args) -> tuple:
    """Phase 19: a world of 2 ranks sharing ``cuda:0``, gated against the
    digests of phase 2's image and phase 3's edge maps; returns the kernel
    launches of its mesh runs, summed over the ranks, and rank 0's
    collectives of 19b's bf16 step counted at dispatch (phase 20c traces
    the same step and must count the same), as the staged group counted
    them, and the step's wall."""
    import multiprocessing
    import threading
    from repro_torch.launch.mesh import run_world, world_backend
    t_phase = time.perf_counter()
    shm_before = set(os.listdir("/dev/shm"))
    threads_before = set(threading.enumerate())
    backend = world_backend("cuda")
    print(f"[mesh] {MESH_RANKS} ranks on cuda:0, backend {backend}: gloo "
          "carries every collective, each CUDA tensor staged through host "
          "memory (NCCL refuses two ranks on one GPU)")
    res = run_world(mesh_rank, MESH_RANKS, farm_digest, edge_digest, args,
                    device="cuda", timeout=300, join_timeout=900)
    W, H, bands, iters, n_img, size = args
    for r, o in enumerate(res):
        print(f"[mesh] rank {r} walls: " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in o["walls"].items()))
        print(f"[mesh] rank {r} launches: {o['parts']}")
        check(o["farm_equal"], f"19a rank {r}: the farm differs from phase 2")
        check(o["parts"]["farm"] == {"mandelbrot": bands // MESH_RANKS},
              f"19a rank {r}: farm launches {o['parts']['farm']}")
        check(o["image_equal"], f"19a rank {r}: the pipeline differs from "
              "phase 3")
        check(o["parts"]["image"] == {"stencil": n_img},
              f"19a rank {r}: pipeline launches {o['parts']['image']}")
        check(o["jacobi_equal"], f"19a rank {r}: Jacobi differs from one "
              "device")
        check(o["jacobi_err"] < 1e-3, f"19a rank {r}: Jacobi error "
              f"{o['jacobi_err']}")
        for label in ("tp_grads_f32", "tp_step"):
            check(o["parts"][label] == {"flash_attention": 48},
                  f"19b rank {r}: {label} launches {o['parts'][label]}")
        check(math.isfinite(o["tp_step_loss"]), f"19b rank {r}: loss")
        check(o["tp_step_loss_err"] < TP_STEP_LOSS_GATE, f"19b rank {r}: "
              f"the bf16 step's loss differs by {o['tp_step_loss_err']}")
        check(o["tp_step_grad_rel"] < TP_STEP_GRAD_GATE, f"19b rank {r}: a "
              f"bf16 gradient leaf differs by {o['tp_step_grad_rel']} of "
              "its max")
        check(o["tp_step_adamw_err"] < TP_STEP_ADAMW_GATE, f"19b rank {r}: "
              f"the AdamW update differs by {o['tp_step_adamw_err']}")
        check(o["pipeline_err"] == 0.0, f"19c rank {r}: pipeline differs "
              f"by {o['pipeline_err']}")
        rel1, rel2 = o["ring_rel"]
        check(rel1 < 0.05 and rel2 < rel1, f"19c rank {r}: ring {rel1}, "
              f"{rel2}")
    o = res[0]
    print(f"[mesh] 19a farm (64 bands of (32, 4096), 1000 iterations) == "
          f"phase 2: True, {bands // MESH_RANKS} mandelbrot launches a rank; "
          f"image pipeline == phase 3: True, {n_img} stencil launches a "
          f"rank; Jacobi (2 systems, n=4096, 2 nodes) == one device: True, "
          f"max|x - x_true| {o['jacobi_err']:.2e}")
    print(f"[mesh] 19a collectives (rank 0): farm {_kinds(o['stats']['farm'])}"
          f"; image {_kinds(o['stats']['image'])}; Jacobi "
          f"{_kinds(o['stats']['jacobi'])}")
    print(f"[mesh] 19b qwen2-0.5b full width f32 on (1, 2), (4, 1024): loss "
          f"{o['tp_loss']:.6f}, against one device {o['tp_loss_err']:.3e} "
          f"(gate 1e-4); worst gradient leaf {o['tp_grad_rel']:.3e} of its "
          "max (gate 1e-3); 48 flash launches a rank")
    check(o["tp_loss_err"] < 1e-4, "19b: loss differs from one device by "
          f"{o['tp_loss_err']}")
    check(o["tp_grad_rel"] < 1e-3, "19b: a gradient leaf differs by "
          f"{o['tp_grad_rel']} of its max")
    worst = lambda k: max(r[k] for r in res)  # noqa: E731
    print(f"[mesh] 19b train step bf16 (default config): loss "
          f"{o['tp_step_loss']:.5f}, one device {o['tp_step_loss_one']:.5f}"
          f", {o['tp_step_loss_err']:.3e} off (gate {TP_STEP_LOSS_GATE}); "
          f"the worst gradient leaf (the step's first moments, each rank's "
          f"shards) {worst('tp_step_grad_rel'):.3e} of its max (gate "
          f"{TP_STEP_GRAD_GATE}); new weights against the plain AdamW of "
          f"the mesh's gradients {worst('tp_step_adamw_err'):.3e} (gate "
          f"{TP_STEP_ADAMW_GATE}); step wall {o['walls']['tp_step']:.3f} s "
          f"(the first on the mesh; f32 loss and grads "
          f"{o['walls']['tp_grads_f32']:.3f} s)")
    print(f"[mesh] 19b collectives a step (rank 0): "
          f"{_kinds(o['stats']['tp_step'])}; counted at dispatch (phase "
          f"20c's counter): {o['tp_step_costs']['calls']}")
    print(f"[mesh] 19c pipeline_forward over 2 stages == the layers in "
          f"order on each microbatch: True (0.0); against the whole batch "
          f"at once {o['pipeline_whole_err']:.3e}; int8 ring rel {o['ring_rel'][0]:.4f}, with error "
          f"feedback {o['ring_rel'][1]:.4f}; ring collectives "
          f"{_kinds(o['stats']['ring'])}")
    left = [p.name for p in multiprocessing.active_children()
            if p.name.startswith("rank")]
    check(not left, f"phase 19 left rank processes: {left}")
    threads = set(threading.enumerate()) - threads_before
    check(not threads, f"phase 19 left threads: {threads}")
    new_shm = set(os.listdir("/dev/shm")) - shm_before
    check(not new_shm, f"phase 19 left /dev/shm entries: {sorted(new_shm)}")
    launched = {k: sum(r["launches"][k] for r in res) for k in o["launches"]}
    print(f"[mesh] phase 19 launches (both ranks): {launched}; no rank "
          f"process, thread or /dev/shm entry left; phase 19 wall: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launched, dict(o["tp_step_costs"], stats=o["stats"]["tp_step"],
                          wall=o["walls"]["tp_step"])


# -- phase 20: the dry-run --------------------------------------------------------

# 20a: cells traced on the production meshes in a fresh process (the
# multi-pod cell records memory only, as in the reference's sweep)
DRYRUN_CELLS = (("qwen2-0.5b", "train_4k", False),
                ("zamba2-1.2b", "long_500k", False),
                ("deepseek-moe-16b", "decode_32k", False),
                ("whisper-tiny", "decode_32k", False),
                ("phi3.5-moe-42b-a6.6b", "train_4k", True))
# 20b's gates: the traced peak (argument + temp bytes) of 18a's step
# against the card's peak over that step, and the traced FLOPs against
# the step's executed FLOPs (dryrun_step_flops)
DRYRUN_PEAK_GATE = 0.15
DRYRUN_FLOP_GATE = 0.02


def dryrun_cells() -> int:
    """20a's process (``python3 chip_smoke.py --dryrun-cells``): trace
    :data:`DRYRUN_CELLS` with ``repro_torch.launch.dryrun`` (fake CUDA
    tensors in fake worlds of 256 and 512 ranks), printing each record as
    a ``[dryrun-cell]`` JSON line, then 26d's one-device decode step
    (:func:`trace_long_step`) as a ``[dryrun-long]`` line, then one
    ``[dryrun-end]`` line with the kernel launches and the device bytes
    this process allocated."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    # PyTorch's first fake CUDA tensor probes the CUDA context with one
    # real 1-element tensor (for autograd); counted apart, before the
    # traces
    with FakeTensorMode():
        torch.empty(1, device="cuda")
    probe = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for arch, shape, multi in DRYRUN_CELLS:
        try:
            rec = dryrun.lower_cell(arch, shape, multi_pod=multi,
                                    with_costs=not multi, verbose=False)
        except Exception as exc:  # reported, and failed by the parent
            rec = {"arch": arch, "shape": shape, "ok": False,
                   "error": repr(exc)[-1000:]}
        print("[dryrun-cell] " + json.dumps(rec), flush=True)
    try:
        rec = trace_long_step()
    except Exception as exc:  # printed by the parent, not gated
        rec = {"ok": False, "error": repr(exc)[-1000:]}
    print("[dryrun-long] " + json.dumps(rec), flush=True)
    print("[dryrun-end] " + json.dumps({
        "launches": launch_counts(),
        "allocated": torch.cuda.memory_allocated(),
        "max_allocated": torch.cuda.max_memory_allocated(),
        "context_probe": probe, "fake_cuda": torch.cuda.is_available(),
        "wall": time.perf_counter() - t0}), flush=True)
    return 0


def start_dryrun_cells():
    """Start 20a's process now (it is host work: it runs beside the
    kernel builds and phase 1); :func:`run_dryrun_phase` reads it."""
    import tempfile
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--dryrun-cells"], stdout=out, stderr=err,
                            cwd=ROOT, text=True)
    return proc, out, err


def stop(proc) -> None:
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def dryrun_step_flops(cfg, B: int, S: int) -> float:
    """The FLOPs one train step of ``cfg`` (dense, tied embeddings, remat
    full) executes on the card at (B, S), T = B·S, from 18a's count of
    6·N·T + 6·L·B·H·hd·S·(S+1) (:func:`run_train_launcher`):

    * the matmuls: 6·T·N_mm (forward 2, backward 4, with N_mm the matrix
      weights: the layers' N_layers and the tied embedding's V·D, used by
      the unembedding); remat's recompute adds the layers' forward,
      2·T·(N_layers − L·D·F): ``torch.utils.checkpoint`` stops
      recomputing at the last activation the backward saves, so each
      layer's down projection is not run again;
    * attention: the flash kernel's 2·B·H·hd·S·(S+1) in the forward and
      again in the recompute; its backward is the plain version's,
      recomputed and differentiated on the whole (S, S) logits:
      4·B·H·S²·hd forward and 8·B·H·S²·hd backward, 12·B·H·S²·hd a layer.
    """
    L, D, H, K, F = cfg.n_layers, cfg.d_model, cfg.n_heads, \
        cfg.n_kv_heads, cfg.d_ff
    hd, T = cfg.hd, B * S
    n_layers = L * (D * (H * hd + 2 * K * hd) + H * hd * D + 3 * D * F)
    n_mm = n_layers + cfg.vocab * D
    flash = 2.0 * B * H * hd * S * (S + 1)
    return (6.0 * T * n_mm + 2.0 * T * (n_layers - L * D * F)
            + L * (2 * flash + 12.0 * B * H * S * S * hd))


def trace_tp_step(torch):
    """19b's bf16 step (full-width qwen2-0.5b, (4, 1024), default config,
    on (1, 2)) traced in a fake world of 2 with fake CUDA tensors, its
    arguments made and placed as :func:`tp_phase` makes them: the
    dry-run's counter over it."""
    import torch.utils._pytree as pytree
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.data import shard_batch
    from repro_torch.launch.dryrun import CostCounter
    from repro_torch.launch.mesh import fake_world, make_mesh, train_rules
    from repro_torch.models import Model
    from repro_torch.parallel.axes import shard_ctx
    from repro_torch.train import AdamW
    from repro_torch.train.train_loop import make_train_step, place_state
    cfg = get_config("qwen2-0.5b")
    rules, opt = train_rules(), AdamW()
    with fake_world(MESH_RANKS):
        mesh2 = make_mesh((1, MESH_RANKS), ("data", "model"), device="cuda")
        mesh2.device_mesh()
        with FakeTensorMode():
            params = pytree.tree_map(lambda t: t.to("cuda"), Model(cfg).init(
                seed=0, device="cpu"))
            batch = {k: torch.zeros((4, 1024), dtype=torch.int32,
                                    device="cuda")
                     for k in ("tokens", "labels")}
            dp, dopt = place_state(params, opt.init(params), mesh2, rules)
            db = shard_batch(batch, mesh2, rules.batch)
            step = make_train_step(Model(cfg), opt)
            costs = CostCounter()
            with shard_ctx(mesh2, rules), costs:
                step(dp, dopt, db)
    return costs


def run_dryrun_phase(torch, counts, cells, step_peaks, tp_costs,
                     long_step) -> None:
    """Phase 20: the dry-run, held against the card.  20a reads the cells
    traced in their own process since the start (each ``ok``; no kernel
    launched, no device byte allocated there), and prints that process's
    trace of 26d's decode step beside the card's (``long_step``).  20b
    traces 18a's step and holds its peak against the card's over that
    step and its FLOPs against the executed count (``step_peaks``: 18a's).
    20c traces 19b's step in a fake world of 2 and holds its collectives,
    call for call and byte for byte, against what 19b's rank 0 ran
    (``tp_costs``)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    before = counts()
    proc, out, err = cells
    try:
        proc.wait(timeout=900)
    finally:
        stop(proc)
    out.seek(0)
    err.seek(0)
    lines = out.read().splitlines()
    errors = err.read()
    check(proc.returncode == 0, f"20a: the dry-run process exited "
          f"{proc.returncode}: {errors[-2000:]}")
    recs = [json.loads(x.split(" ", 1)[1]) for x in lines
            if x.startswith("[dryrun-cell] ")]
    ends = [json.loads(x.split(" ", 1)[1]) for x in lines
            if x.startswith("[dryrun-end] ")]
    longs = [json.loads(x.split(" ", 1)[1]) for x in lines
             if x.startswith("[dryrun-long] ")]
    check(len(recs) == len(DRYRUN_CELLS) and len(ends) == 1
          and len(longs) == 1,
          f"20a: {len(recs)} records: {lines[-5:]} {errors[-2000:]}")
    for rec in recs:
        check(rec["ok"], f"20a: {rec['arch']} × {rec['shape']} failed: "
              f"{rec.get('error')}")
        mem = rec["mem"]
        line = (f"[dryrun] 20a {rec['arch']} × {rec['shape']} × "
                f"{rec['mesh']}: mem(arg+tmp)="
                f"{(mem['argument_bytes'] + mem['temp_bytes']) / 2**30:.2f}"
                f"GiB (argument {mem['argument_bytes']:,} B, temp "
                f"{mem['temp_bytes']:,} B, output {mem['output_bytes']:,} B;"
                f" traced in {rec['lower_s']} s)")
        if "flops_per_dev" in rec:
            line += (f" flops/dev={rec['flops_per_dev']:.3e} bytes/dev="
                     f"{rec['bytes_per_dev']:.3e} coll/dev="
                     f"{rec['coll_bytes_per_dev']:.3e} "
                     f"{rec['coll_calls']}")
        print(line)
    end = ends[0]
    check(not any(end["launches"].values()),
          f"20a: the traces launched kernels: {end['launches']}")
    check(end["allocated"] == 0 and end["max_allocated"] == 0,
          f"20a: the traces allocated device memory: {end}")
    print(f"[dryrun] 20a: {len(recs)} cells ok, fake CUDA tensors: "
          f"{end['fake_cuda']}; no kernel launched and 0 device bytes "
          f"allocated by the traces in that process (PyTorch's context "
          f"probe for fake CUDA tensors before them: {end['context_probe']}"
          f" B); its wall {end['wall']:.1f} s (run beside phases 1-19)")
    report_long_trace(longs[0], long_step)

    # 20b: 18a's step, traced, against the card
    cfg = get_config("qwen2-0.5b")
    B, S = 4, 1024
    tr = dryrun._trace_variant(cfg, ShapeConfig("train_1k", S, B, "train"),
                               None, None, device="cuda")
    check(len(step_peaks) == 8, f"20b: 18a recorded {len(step_peaks)} "
          "steps")
    predicted = tr.argument_bytes + tr.temp_bytes
    arg_card, peak = step_peaks[2]  # a warm step
    rel = abs(predicted - peak) / peak
    print(f"[dryrun] 20b qwen2-0.5b full width (4, 1024) train step "
          f"(18a's, remat full): traced peak {predicted / 2**30:.3f} GiB "
          f"(argument {tr.argument_bytes:,} B, temp {tr.temp_bytes:,} B), "
          f"the card's {peak / 2**30:.3f} GiB (step 2: max_memory_allocated "
          f"over the step less the bytes resident beside its {arg_card:,} "
          f"argument bytes), off by {rel:.2%} (gate "
          f"{DRYRUN_PEAK_GATE:.0%}); steps 0-7: " + ", ".join(
              f"{p / 2**30:.3f}" for _, p in step_peaks) + " GiB")
    check(tr.argument_bytes == arg_card, f"20b: traced arguments "
          f"{tr.argument_bytes} B, the card's {arg_card} B")
    check(rel <= DRYRUN_PEAK_GATE, f"20b: traced peak {predicted} B against "
          f"the card's {peak} B")
    executed = dryrun_step_flops(cfg, B, S)
    frel = abs(tr.flops - executed) / executed
    print(f"[dryrun] 20b FLOPs: traced {tr.flops:.6e}, executed "
          f"{executed:.6e} = 6·T·N_mm + 2·T·(N_layers − L·D·F) + "
          f"L·(2·flash + 12·B·H·S²·hd) (18a's 6·N·T + 6·L·B·H·hd·S·(S+1) "
          f"with remat's recompute and the plain attention backward), off "
          f"by {frel:.3%} (gate {DRYRUN_FLOP_GATE:.0%}); traced in "
          f"{tr.seconds:.1f} s")
    check(frel <= DRYRUN_FLOP_GATE, f"20b: traced FLOPs {tr.flops} against "
          f"{executed}")

    # 20c: 19b's step in a fake world of 2 against its real ranks
    t0 = time.perf_counter()
    costs = trace_tp_step(torch)
    real = tp_costs
    staged = real["stats"]
    print(f"[dryrun] 20c 19b's bf16 step traced in a fake world of "
          f"{MESH_RANKS} ({time.perf_counter() - t0:.1f} s): calls "
          f"{costs.calls}, result bytes {costs.coll}; 19b's rank 0 on the "
          f"card: calls {real['calls']}, bytes {real['coll']}; the "
          f"host-staged group's own count there: {_kinds(staged)}")
    check(costs.calls == real["calls"], f"20c: calls {costs.calls} traced, "
          f"{real['calls']} on the card")
    check(costs.coll == real["coll"], f"20c: bytes {costs.coll} traced, "
          f"{real['coll']} on the card")
    launched = {k: v - before[k] for k, v in counts().items()}
    check(not any(launched.values()), f"phase 20 launched {launched}")
    print(f"[dryrun] phase 20 launches: {launched}; phase 20 wall: "
          f"{time.perf_counter() - t_phase:.1f} s")


# -- phase 21: the ragged MoE path on a mesh, 2 ranks sharing the card --------

# deepseek-moe-16b at full width with its depth cut to 4 layers (the dense
# layer 0 and 3 MoE layers; 32 of the 64 experts a rank): two ranks on one
# card each build the model before placing it, and the whole depth would
# be 2 x 33 GB in bf16.  Shapes (batch, seq) of 21a's f32 forward, loss and
# gradients and of 21b's bf16 forward; 21c's prefill (batch, prompt) and
# its decode steps.  The reduced ones are the CPU rehearsal's.
RAGGED_LAYERS = 4
RAGGED_SHAPES = ((2, 512), (2, 1024), (4, 32, 8))
RAGGED_SHAPES_REDUCED = ((2, 32), (2, 64), (4, 8, 4))
# the gates against one device, set from `tools/mesh_phase.py ragged`'s
# readings on the card: as it is, the f32 forward's logits 2.0e-6 off in
# norm (max|diff| 1.5e-5), the loss 1.9e-6, the worst gradient leaf
# 2.0e-6 of its max, the bf16 forward 2.3e-2 in norm (max|diff| 0.53: bf16
# rounding flips near-ties of the top-6 routing), the f32 prefill and
# decode 2.1e-6 in norm (max|diff| 1.3e-5); with one rank's expert offset
# off by one, 0.32, 1.0e-2, 1.98, 0.26 and 0.30.  The logits are gated in
# norm (||mesh - one|| / ||one||): their max|diff| in f32 is 1e-5 of
# logits up to ~10.
RAGGED_GATES = {"a_forward": 1e-4, "a_loss": 1e-4, "a_grad": 1e-3,
                "b_forward": 8e-2, "c_logits": 1e-4}


def ragged_cfg(reduced: bool, **over):
    """Phase 21's deepseek-moe-16b: its depth cut to ``RAGGED_LAYERS``, on
    the ragged path."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek-moe-16b",
                                          reduced=reduced),
                               n_layers=RAGGED_LAYERS, moe_ragged=True,
                               **over)


def ragged_launches(cfg, steps: int) -> dict:
    """Each stage's kernel launches on a rank: 3 grouped matmuls a MoE
    layer and one flash launch a layer in a forward (twice under remat,
    whose backward recomputes the forward); the prefill and the ``steps``
    decode steps attend through the cache and launch no flash."""
    moe, fwd = 3 * (cfg.n_layers - 1), cfg.n_layers
    again = 2 if cfg.remat == "full" else 1
    return {"a_forward_f32": {"moe_gmm": moe, "flash_attention": fwd},
            "a_grads_f32": {"moe_gmm": again * moe,
                            "flash_attention": again * fwd},
            "b_forward_bf16": {"moe_gmm": moe, "flash_attention": fwd},
            "c_prefill_f32": {"moe_gmm": moe},
            "c_decode_f32": {"moe_gmm": steps * moe}}


def _errs(got, want) -> tuple:
    """(max |got - want|, ||got - want|| / ||want||) in float32."""
    d = got.float() - want.float()
    return (float(d.abs().max()),
            float(d.norm() / want.float().norm().clamp_min(1e-30)))


def ragged_rank(rank: int, device: str = "cuda",
                reduced: bool = False) -> dict:
    """One rank of phase 21 (SPMD on ``cuda:0``; ``device="cpu"`` with
    ``reduced`` is the CPU rehearsal): ``ragged_cfg`` on a (1, 2) ``data ×
    model`` mesh, the experts split over the model axis.  21a: the f32
    forward, loss and every gradient leaf under ``train_rules()``; 21b:
    the bf16 forward; 21c: under ``serve_rules()``, a prefill and decode
    steps with the caches' positions over the model axis.  Rank 0 runs
    each on one device too and returns the errors and walls; every rank
    returns its launches, walls, collectives and peak memory."""
    import dataclasses

    import torch
    from repro_torch.data import SyntheticLM, shard_batch
    from repro_torch.launch.mesh import make_mesh, serve_rules, train_rules
    from repro_torch.models import Model
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.axes import shard_ctx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out, counted = mesh_counter(device)
    out["one_walls"], out["reduced"] = {}, reduced

    def one(label, fn):  # rank 0's one-device run, timed
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out["one_walls"][label] = time.perf_counter() - t0
        return res

    (Ba, Sa), (Bb, Sb), (Bc, Sc, steps) = (RAGGED_SHAPES_REDUCED if reduced
                                           else RAGGED_SHAPES)
    cfg = ragged_cfg(reduced)
    m32 = Model(dataclasses.replace(cfg, compute_dtype="float32"))
    params = m32.init(seed=0, device=dev)
    mesh = make_mesh((1, MESH_RANKS), ("data", "model"), device=device)
    rules = train_rules()
    dp = sh.place(params, sh.param_shardings(params, mesh, rules))
    out["experts_local"] = int(
        dp["segments"][1]["moe"]["experts"]["gate"].to_local().shape[1])

    # 21a: f32 forward, loss and gradients under train_rules()
    batch = SyntheticLM(Ba, Sa, cfg.vocab, device=dev).create(0)
    db = shard_batch(batch, mesh, rules.batch)
    with torch.no_grad():
        with shard_ctx(mesh, rules):
            logits, _ = counted("a_forward_f32", lambda: m32.forward(
                dp, db["tokens"]))
        logits = logits.full_tensor()
        if rank == 0:
            want, _ = one("a_forward_f32", lambda: m32.forward(
                params, batch["tokens"]))
            out["a_forward"] = _errs(logits, want)
            del want
        del logits
    with shard_ctx(mesh, rules):
        loss, grads = counted("a_grads_f32", lambda: _rank_grads(
            torch, m32, dp, db))
    out["a_loss"] = float(loss.full_tensor())
    if rank == 0:
        loss1, grads1 = one("a_grads_f32", lambda: _rank_grads(
            torch, m32, params, batch))
        out["a_loss_err"] = abs(out["a_loss"] - float(loss1))
    worst = (0.0, "")
    for key in sorted(grads):  # a leaf at a time: no whole second tree
        whole = grads.pop(key).full_tensor()
        if rank == 0:
            ref = grads1.pop(key)
            rel = float((whole - ref).abs().max()
                        / ref.abs().max().clamp_min(1e-30))
            worst = max(worst, (rel, key))
        del whole
    if rank == 0:
        out["a_grad"] = worst
        del grads1
    del grads, loss

    # 21b: the bf16 forward (the default config's compute dtype)
    mb = Model(cfg)
    toks = SyntheticLM(Bb, Sb, cfg.vocab, device=dev).create(1)["tokens"]
    dt = shard_batch({"tokens": toks}, mesh, rules.batch)["tokens"]
    with torch.no_grad():
        with shard_ctx(mesh, rules):
            logits, _ = counted("b_forward_bf16", lambda: mb.forward(dp, dt))
        logits = logits.full_tensor()
        if rank == 0:
            want, _ = one("b_forward_bf16", lambda: mb.forward(params, toks))
            out["b_forward"] = _errs(logits, want)
            del want
        del logits

    # 21c: prefill and decode steps under serve_rules(), f32
    srules = serve_rules()
    ds = sh.place(dp, sh.param_shardings(params, mesh, srules))
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab, (Bc, n), generator=g,
                             dtype=torch.int32).to(dev)
               for n in [Sc] + [1] * steps]
    cache = m32.init_cache(Bc, Sc + steps, device=dev)
    dc = sh.place(cache, sh.to_shardings(sh.cache_specs(cache, mesh, srules),
                                         mesh))
    dtoks = [sh.place(t, sh.to_shardings(sh.batch_specs(t, mesh, srules),
                                         mesh)) for t in prompts]

    def decode(p, c, tokens):
        got = []
        for t in tokens:
            logits, c = m32.decode_step(p, c, t)
            got.append(logits.full_tensor() if hasattr(logits, "full_tensor")
                       else logits)
        return got

    with torch.no_grad():
        with shard_ctx(mesh, srules):
            got = counted("c_prefill_f32", lambda: decode(ds, dc, dtoks[:1]))
            got += counted("c_decode_f32", lambda: decode(ds, dc, dtoks[1:]))
        if rank == 0:
            c1 = m32.init_cache(Bc, Sc + steps, device=dev)
            want = one("c_prefill_f32", lambda: decode(params, c1,
                                                       prompts[:1]))
            want += one("c_decode_f32", lambda: decode(params, c1,
                                                       prompts[1:]))
            out["c_logits"] = _errs(torch.cat(got, 1), torch.cat(want, 1))
    out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30 if cuda
                       else None)
    del dp, ds, dc, params
    if cuda:
        torch.cuda.empty_cache()
    return out


def report_ragged(res, gates=None) -> dict:
    """Phase 21's lines from its ranks' results, gated when ``gates`` (a
    dict like ``RAGGED_GATES``) is given; returns the launches summed over
    the ranks."""
    o = res[0]
    cfg = ragged_cfg(o["reduced"])
    want = ragged_launches(cfg, (RAGGED_SHAPES_REDUCED if o["reduced"]
                                 else RAGGED_SHAPES)[2][2])
    for r, x in enumerate(res):
        print(f"[ragged] rank {r} launches: {x['parts']}")
        print(f"[ragged] rank {r} walls: " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in x["walls"].items())
            + (f"; peak memory {x['peak_gib']:.2f} GiB"
               if x["peak_gib"] is not None else ""))
        print(f"[ragged] rank {r} collectives: " + "; ".join(
            f"{k} {_kinds(v)}" for k, v in x["stats"].items()))
        if gates is not None:
            for label, n in want.items():
                got = {k: v for k, v in x["parts"][label].items()
                       if k in n}
                check(got == n, f"21 rank {r}: {label} launched "
                      f"{x['parts'][label]}, not {n}")
    print(f"[ragged] one device (rank 0) walls: " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in o["one_walls"].items()))
    print(f"[ragged] {cfg.name} cut to {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k} "
          f"({o['experts_local']} a rank) on (1, {MESH_RANKS}): 21a f32 "
          f"forward max|diff| {o['a_forward'][0]:.3e}, rel "
          f"{o['a_forward'][1]:.3e}; loss {o['a_loss']:.6f}, "
          f"{o['a_loss_err']:.3e} off; worst gradient leaf "
          f"{o['a_grad'][0]:.3e} of its max ({o['a_grad'][1]})")
    print(f"[ragged] 21b bf16 forward max|diff| {o['b_forward'][0]:.3e}, "
          f"rel {o['b_forward'][1]:.3e}; 21c serve_rules prefill + decode "
          f"f32 logits max|diff| {o['c_logits'][0]:.3e}, rel "
          f"{o['c_logits'][1]:.3e}")
    if gates is not None:
        for key, val in (("a_forward", o["a_forward"][1]),
                         ("a_loss", o["a_loss_err"]),
                         ("a_grad", o["a_grad"][0]),
                         ("b_forward", o["b_forward"][1]),
                         ("c_logits", o["c_logits"][1])):
            check(val < gates[key], f"21: {key} {val} >= gate {gates[key]}")
            print(f"[ragged] gate {key}: {val:.3e} < {gates[key]}")
    return {k: sum(x["launches"][k] for x in res) for k in o["launches"]}


def run_ragged_phase(torch) -> tuple:
    """Phase 21: ``ragged_rank`` in a world of 2 ranks sharing ``cuda:0``,
    gated; returns its kernel launches summed over the ranks, and rank 0's
    collectives of 21c's decode steps and their wall."""
    import multiprocessing
    from repro_torch.launch.mesh import run_world
    t_phase = time.perf_counter()
    res = run_world(ragged_rank, MESH_RANKS, device="cuda", timeout=300,
                    join_timeout=900)
    launched = report_ragged(res, RAGGED_GATES)
    left = [p.name for p in multiprocessing.active_children()
            if p.name.startswith("rank")]
    check(not left, f"phase 21 left rank processes: {left}")
    print(f"[ragged] phase 21 launches (both ranks): {launched}; phase 21 "
          f"wall: {time.perf_counter() - t_phase:.1f} s")
    return launched, {"stats": res[0]["stats"]["c_decode_f32"],
                      "wall": res[0]["walls"]["c_decode_f32"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    cells = start_dryrun_cells()  # phase 20a, host work beside the rest
    try:
        return phases(torch, cells)
    finally:
        stop(cells[0])


def phases(torch, cells) -> int:
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t_start = time.perf_counter()
    card = gpu_name_and_power()
    print(f"gpu: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    walls: dict = {}  # each phase's wall, in the order run
    t_lap = t_start

    def lap(label: str) -> None:
        nonlocal t_lap
        now = time.perf_counter()
        walls[label] = now - t_lap
        t_lap = now

    build_kernels(torch, ["mandelbrot", "stencil", "flash_attention",
                          "ssd_scan", "moe_gmm"])
    lap("build")

    W, H, BANDS, ITERS = 4096, 2048, 64, 1000
    entries = [check_mandelbrot(torch, dev, W, H, BANDS, ITERS),
               check_stencil(torch, dev), check_flash(torch, dev),
               check_ssd(torch, dev), check_moe_gmm(torch, dev)]
    check_kernel_grads(torch, dev, entries)
    check_widened(torch, dev)
    lap("1")

    reset_launch_counts()  # the main path starts here
    farm, farm_img = run_farm(torch, launch_counts, W, H, BANDS, ITERS)
    pipeline, edge_maps = run_pipeline(torch, dev, launch_counts, 16, 2048)
    run_jacobi(torch, dev, launch_counts, 4, 4096, 4, 1e-6)
    run_pi(torch, launch_counts, 256, 10**6)
    lap("2-5")
    rebalance_ms = run_cluster_phase(torch, launch_counts, farm_img,
                                     edge_maps, W, H, BANDS, ITERS, 16, 2048)
    lap("12")
    model, params, toks = run_forward(torch, dev, launch_counts,
                                      "qwen2-0.5b", 4, 2048,
                                      {"flash_attention": 24})
    phase7 = run_serve(torch, model, params, launch_counts)
    lap("6-7")
    run_durable_phase(torch, launch_counts, farm_img, model, params,
                      (W, H, BANDS, ITERS), rebalance_ms)
    lap("13")
    run_sim_phase(torch, launch_counts, farm_img, (W, H, BANDS, ITERS))
    lap("14")
    run_costs_phase(torch, launch_counts, farm_img, edge_maps, entries,
                    (W, H, BANDS, ITERS), 16, 2048)
    lap("15")
    mesh_refs = (digest([farm_img]), digest(edge_maps))  # phase 19's gates
    del farm_img, edge_maps
    # phase 16 is its own path: it must launch no kernel
    before_farm = launch_counts()
    reset_launch_counts()
    run_farm_phase(torch, model, params, phase7)
    farm_launched = launch_counts()
    check(not any(farm_launched.values()),
          f"phase 16 launched kernels: {farm_launched}")
    lap("16")
    reset_launch_counts()
    ssm = run_forward(torch, dev, launch_counts, "mamba2-2.7b", 4, 2048,
                      {"ssd_scan": 64})
    hybrid = run_forward(torch, dev, launch_counts, "zamba2-1.2b", 4, 2048,
                         {"ssd_scan": 38, "flash_attention": 6})
    run_serve(torch, ssm[0], ssm[1], launch_counts)
    launched = {k: v + before_farm[k] for k, v in launch_counts().items()}
    lap("8-9")
    # phase 17 is counted apart, from 0, and added to the main path's counts
    reset_launch_counts()
    whisper = run_whisper_phase(torch, dev, launch_counts)
    whisper_launched = launch_counts()
    print(f"[whisper] phase 17 launches: {whisper_launched}")
    launched = {k: v + whisper_launched[k] for k, v in launched.items()}
    lap("17")

    # where the time goes: one more fused run of each kernel workload, one
    # more forward and one decode step of each served model, one more
    # zamba2 forward
    from repro_torch.core import build
    profile_run(torch, "mandelbrot fused", lambda: build(farm).run(
        instances=BANDS))
    profile_run(torch, "image fused", lambda: build(pipeline).run(
        instances=16))
    profile_model(torch, model, params, toks)
    profile_model(torch, *ssm)
    with torch.inference_mode():
        m, p, t = hybrid
        profile_run(torch, f"{m.cfg.name} forward bf16 (4, 2048)",
                    lambda: m.forward(p, t))
        m, p, c, t = whisper
        profile_run(torch, f"{m.cfg.name} decode step (4 utterances, "
                    f"{WHISPER_FRAMES} frames)",
                    lambda: m.decode_step(p, c, t))
    lap("profiles")

    # phase 18 (training, on phase 6's weights) is counted apart, from 0,
    # and added to the main path's counts
    reset_launch_counts()
    step_peaks = run_train_phase(torch, dev, launch_counts, params)
    train_launched = launch_counts()
    print(f"[train] phase 18 launches: {train_launched}")
    launched = {k: v + train_launched[k] for k, v in launched.items()}
    profile_train_step(torch, dev, params)
    memory(torch, "phase 18, training")
    lap("18")

    # the MoE path needs the card's memory: free every earlier model first
    del farm, pipeline, model, params, toks, ssm, hybrid, whisper, m, p, c, t
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    # phase 22 (the dense and VLM archs at full width, one model at a time
    # on the emptied card) is counted apart, from 0, and added
    reset_launch_counts()
    run_wide_phase(torch, dev, launch_counts)
    wide_launched = launch_counts()
    print(f"[lm] phase 22 launches: {wide_launched}")
    launched = {k: v + wide_launched[k] for k, v in launched.items()}
    lap("22")
    # phase 23 (yi-34b and phi3.5-moe with bf16 weights, one at a time on
    # the emptied card) likewise
    reset_launch_counts()
    run_bf16_phase(torch, dev, launch_counts)
    bf16_launched = launch_counts()
    print(f"[lm] phase 23 launches: {bf16_launched}")
    launched = {k: v + bf16_launched[k] for k, v in launched.items()}
    lap("23")
    # phase 24 (mamba2-2.7b, zamba2-1.2b and whisper-tiny trained at full
    # width, one at a time on the emptied card) likewise
    reset_launch_counts()
    run_wide_train_phase(torch, dev, launch_counts)
    wide_train_launched = launch_counts()
    print(f"[train] phase 24 launches: {wide_train_launched}")
    launched = {k: v + wide_train_launched[k] for k, v in launched.items()}
    lap("24")
    # phase 25 (the chunked loss and the int8 cache at full width, one model
    # at a time on the emptied card) likewise
    reset_launch_counts()
    run_lever_phase(torch, dev, launch_counts)
    lever_launched = launch_counts()
    print(f"[train] phase 25 launches: {lever_launched}")
    launched = {k: v + lever_launched[k] for k, v in launched.items()}
    lap("25")
    # phase 26 (the JAX package's long-context cells, one model at a time
    # on the emptied card; its kernels at that length are checked in phase
    # 1) likewise
    reset_launch_counts()
    long_step = run_long_phase(torch, dev, launch_counts)
    long_launched = launch_counts()
    print(f"[long] phase 26 launches: {long_launched}")
    launched = {k: v + long_launched[k] for k, v in launched.items()}
    lap("26")
    # phase 19 (2 ranks sharing the card) is counted apart, from 0, in its
    # ranks, and added
    launched_19, tp_costs = run_mesh_phase(torch, *mesh_refs,
                                 (W, H, BANDS, ITERS, 16, 2048))
    launched = {k: v + launched_19[k] for k, v in launched.items()}
    lap("19")
    # phase 21 (the ragged MoE path on 2 ranks) likewise
    launched_21, decode_costs = run_ragged_phase(torch)
    launched = {k: v + launched_21[k] for k, v in launched.items()}
    lap("21")
    torch.cuda.reset_peak_memory_stats()
    memory(torch, "before the MoE phases")
    reset_launch_counts()  # the MoE path starts here
    moe_model, moe_params, moe_toks = run_forward(
        torch, dev, launch_counts, "deepseek-moe-16b", 4, 2048,
        {"moe_gmm": 81, "flash_attention": 28}, moe_ragged=True)
    memory(torch, "phase 10, deepseek-moe-16b forwards (ragged)")
    run_capacity_forward(torch, moe_model, moe_params, moe_toks,
                         launch_counts, {"flash_attention": 28})
    memory(torch, "phase 10, deepseek-moe-16b forward (capacity)")
    run_serve(torch, moe_model, moe_params, launch_counts,
              per_decode={"moe_gmm": 81}, launcher_main=False, alone=2)
    memory(torch, "phase 11, deepseek-moe-16b serving")
    moe_launched = launch_counts()
    profile_model(torch, moe_model, moe_params, moe_toks, ", ragged")
    lap("10-11")

    del moe_model, moe_params, moe_toks
    run_dryrun_phase(torch, launch_counts, cells, step_peaks, tp_costs,
                     long_step)
    lap("20")

    for e in entries:
        e["launches"] = launched[e["name"]] + moe_launched[e["name"]]
        check(e["launches"] > 0, f"{e['name']}: never launched on the path")
    print("kernels: " + "; ".join(
        f"{e['name']} launches={e['launches']} check="
        f"{'exact' if e['max_abs_err'] == 0 else e['max_abs_err']}"
        for e in entries))
    staged = []
    for label, c in (("19b bf16 TP step", tp_costs),
                     (f"21c ragged decode, {RAGGED_SHAPES[2][2]} steps",
                      decode_costs)):
        out_b, copied = staged_bytes(c["stats"])
        staged.append(f"{label}: {out_b:,} B out, {copied:,} B copied "
                      f"between the card and the host, wall "
                      f"{c['wall']:.3f} s")
    print("[mesh] staged collectives (rank 0): " + "; ".join(staged))
    print("phase walls: " + ", ".join(f"{k} {v:.1f} s"
                                      for k, v in walls.items()))
    print(f"whole run: {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(dryrun_cells() if sys.argv[1:] == ["--dryrun-cells"]
             else main())
