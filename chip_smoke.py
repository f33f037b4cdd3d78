"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold it to its plain
versions.

    python3 chip_smoke.py [--seed N]

Phases (each raises on failure; the script then exits non-zero):
  card     nvidia-smi name and power limit, torch and CUDA versions
  build    libtpunet.so (make) and every csrc/*.cu kernel (nvcc, always
           rebuilt), in parallel from the sources of this checkout;
           ptxas's registers and spills per kernel function, and the count
           of tensor-core instructions (HGMMA, HMMA) per function from
           cuobjdump -sass. Fails if a bf16 or f16 flash_fwd, flash_dq or
           flash_dkv function (every head dim; the D = 256 and the wide
           (head dims above 256) ones and every f16 one must exist) has no
           HGMMA, no ptxas report or spills, if an f32
           flash_{fwd,dq,dkv}_f32_kernel<64/128/256> or a wide f32
           flash_fwd_wide_f32_kernel, flash_dq_wide_f32_kernel<2/4/8> or
           flash_dkv_wide_f32_kernel is missing or spills, or if a
           function of the replaced CUDA-core flash_dq_kernel,
           flash_dkv_kernel or flash_{fwd,dq,dkv}_wide_kernel exists
  kernels  flash_fwd against its plain version on the card at the serving
           shapes (B=1 and 8, S=512, 16 heads, 4 kv heads, D=128, causal,
           bf16 and f32), the training shape (B=4, S=2048, 16 kv heads;
           bf16, f32 and f16), a ragged length (401), a window (128),
           non-causal Sq != Sk, head dims 12 and 100 (zero-padded by the
           wrapper) and B*H = 65,552 (B=4097, S=64, D=8) in bf16 and f32,
           bf16 head dims 64, 96 and 256 with GQA-8 and ragged Sq != Sk,
           D=256 at the training shape's work (B=2, S=2048, 16 kv heads),
           f16 GQA-8 ragged and D=256, rows that see no key (Sq 517, Sk
           401, window 16; bf16, f32 and f16), the wide kernels at the
           wide path's shape (B2 S1024, 4 heads, 1 kv head, D=320), at
           D=320 (B1 S1024 GQA-4) and at D=512 (Sq 517, Sk 401, window 16:
           no-key rows) in bf16, f16 and f32, D=576 (B1 S1024 GQA-4: two
           chunk groups of the 16-bit wide forward, a cluster of 5 f32
           span blocks) in every dtype, f32 D=800, 1024 and 1160 (B1
           S300 GQA-4: clusters of 7 and 8 span blocks, and past the f32
           layout's boundary two clusters of 8), the serve
           configuration's attention (16 heads, 4 kv heads, D=128, bf16)
           at the sp reference's S=16384 and a pipe stage's S=2048, and
           a bf16 q sliced
           from a wider buffer at an odd offset, which the wrapper must
           copy (input_copies); each also bitwise equal on a second
           launch, and each shows that the row check sees two faults
           planted in its output (the causal loop one k tile short; above
           D=256 the last span on scores without the last 64-column
           chunk);
           then the backward kernels flash_dq and flash_dkv against theirs
           at the training shape (bf16, f32 and f16), GQA (4 kv heads), a
           ragged length (401), a window (128), non-causal Sq 384 / Sk 512,
           bf16 D=64 with GQA-8, f16 GQA-8, bf16 D=256 (B=1 S=1024 GQA-4;
           B=2 S=2048 MHA, the training shape's work; GQA-8 ragged
           Sq != Sk; the no-key rows), f16 D=256 GQA-8, the no-key rows at
           D=128 in bf16, f32 and f16, head dims 12 and 100 and B*H =
           65,552 in bf16 and f32, f32 at D=64 (B4 S2048) and D=256 (B2
           S2048), the wide cases above, bf16 D=576 (B1 S1024 GQA-4: three
           spans of the 16-bit wide kernels), and the misaligned bf16 q.
           Each output
           is held to a limit on its largest error and to one on every
           row's error relative to that row's norm, and must be finite;
           each dQ and dK/dV row also shows that the row check sees two
           planted faults (dQ: a k tile or the right kv head left out;
           dK/dV: a q tile or a GQA head left out). Errors, input copies,
           kernel time, bound, plain time and the time of
           scaled_dot_product_attention (its backward alone for the
           backward kernels; with an explicit boolean mask where there is
           a window) with the backend it ran, the rate in TFLOP/s, and
           the time of attention_delta at the training shape
  model    the 735M GQA Transformer (d2048, 12 layers, 16 heads, 4 kv
           heads, ff 8192, vocab 32000) on a 512-token prompt, flash impl
           against reference impl, in f32 and bf16
  serve    Router + PrefillEngine on this thread and a DecodeWorker on a
           thread, over loopback libtpunet comms, slots 8, max_len 1024:
           8 greedy requests of 64 tokens. On the f32 KV wire (the serving
           path; flash_fwd's launches are counted over exactly this run)
           the tokens must equal a single-host BatchServer's; on the int8
           wire the codec's wire ratio is read over a reset() window. Then
           the f32 tier once more with re-admission armed: the only decode
           rank serves one block and exits with requests in flight, a
           recovered rank on a new thread reconnects through the hello
           handshake; the tokens must equal the single host's, with one
           rank failure, one re-admission and one readmit event.
  swap     live weight updates on the serve phase's configuration (full
           width and depth, slots 8, max_len 1024, f32 KV wire, 8 greedy
           requests of 64 tokens): a frontend (Router round robin,
           PrefillEngine, WeightPublisher) and decode ranks A and B, each
           a spawned process on this card with the QoS gate armed
           (TPUNET_QOS_INFLIGHT_BYTES=wire=256K,
           TPUNET_QOS_WEIGHTS=latency=8,bulk=1), 64 MiB broadcast chunks
           and a 60 s swap deadline. v0 is phase_model's bf16 params, v1
           and v2 init_params(seed + 1 / + 2) cast the same way; each
           publication ships 2 bytes a parameter of bf16 wire. The
           frontend's swap script (swap:at_step=N:action=publish) times
           both publications. Window 1, v0 -> v1, published once the first
           FIRST frame is in: rank A's script
           (swap:at_step=1:action=corrupt) flips a received byte, so the
           fleet refuses the first attempt and the retry commits; the
           prompts again under v1. Window 2, v1 -> v2, published as soon
           as its requests are in flight: the frontend SIGKILLs B once the
           broadcast is, the retry commits on A (B's requests replay from
           their retained KV), the parent respawns B on v0, the router
           re-admits it and catch_up() brings it to v2; then the prompts
           under v2 on both ranks. Gates: every request's tokens bitwise a single-host
           BatchServer's on the version pinned at its admission; window 1
           1 abort, 1 retry, 1 commit and a CRC mismatch event; window 2
           >= 1 retry, 1 commit, 1 catch-up, 1 rank failure, 1
           re-admission, B killed by SIGKILL; the frontend at v2 with only
           v2's engine, both ranks at v2 with only v2 resident and the
           weight-version gauge 2; no swap event pending anywhere; the
           bulk class moved at least the wire's bytes; flash_fwd launched
           by the frontend's engine of every version and by both new
           engines' warm-ups (a decode rank adopts shipped KV and decodes
           on the cache's einsum branch: no flash launch), no input copy
           anywhere. Reports each
           publication's phase seconds and broadcast GB/s, TTFT before,
           during and after each swap, the longest serve-loop pass of a
           decode rank during a swap, the latency class's p99 queue wait,
           peak memory and flash_fwd launches per process and version
  spec     speculative serving, bf16, flash prefill, random weights from
           --seed: (a) benchmarks/chip_session.py's decode_spec, the 735M
           MHA target's widths (d2048, 16 heads, ff 8192, vocab 32000) at
           6 of its 12 layers, with a random draft of its widths at 2
           layers, batch 8, prompt
           512, 64 new tokens (cut from 256 for the script's time),
           gamma 4, greedy, lockstep and per row; (b)
           decode_bench.py --spec-draft quant: quantize_params of the
           target as its int8 self-draft, per row, greedy, then sampled
           (temperature 0.8, top_k 50) twice from one generator seed; (c)
           decode_window: the target at window 256 on the ring (the
           512-token prompt wraps it), generate on the ring against the
           masked cache, and speculation with the int8 self-draft; (d)
           serve_bench.py --spec-gamma 4: an int8 self-draft BatchServer on
           the serve phase's model and requests (slots 8, 64 tokens)
           against the plain BatchServer. Gates: greedy tokens equal to
           the port's generate (plain BatchServer for (d)), or diverging
           only at a tie: at the first differing position the reference's
           top-2 logit gap is no larger than the largest |difference|
           between that position's logits from a (b, gamma + 1) verify
           block and from the one-token step on the same prefix (for the
           masked cache against the ring: from the masked cache's step);
           flash_fwd launched once a layer in every target and draft
           prefill, with window 256 in (c), no input copy; the int8
           self-draft committing more than one token a round; the sampled
           runs bitwise equal with tokens in [0, vocab); ring leaves of
           256. Reports rounds, acceptance, tokens a round, tokens/s beside
           plain generate's, each cache's bytes, peak memory, wall time
  paths   the wide and f32 routes as users run them: 2 adamw steps
           (create_train_state, make_train_step) of a bf16 GQA-4 model of
           head dim 320 (d1280, 4 heads, 1 kv head, 2 layers, 2 x 1024
           tokens; the wide kernels) and of an f32 model of the training
           widths (d2048, 16 heads, 2 layers, 4 x 2048 tokens; the f32
           kernels), each held to the same steps with the reference
           attention (loss within 2e-2 bf16 / 1e-4 f32), and run once
           more with a planted dQ fault (each head given the next head's
           dQ), which must read above that limit; each kernel's launches
           are counted over its path's flash run and must be 4. The
           kernel phases hold the wide kernels at this path's attention
           shape (B2 S1024, 4 heads, 1 kv head, D320) in every dtype, and
           the f32 kernels at the f32 path's (the f32 training shape)
  train    the training path: the 735M MHA Transformer (d2048, 12 layers,
           16 heads, ff 8192, vocab 32000; bf16 compute, f32 master
           weights, flash attention, remat), adamw 3e-4, global batch
           8 x 2048 over 2 data-parallel ranks spawned on this card and
           joined by loopback tpunet_torch.distributed. fit() takes 4
           steps on a packed stream of token ramps read through
           prefetch_to_device; the gradients are averaged by the DCN
           all-reduce on the f32 wire. Every kernel counter is zeroed just
           before fit() and read just after, in each rank. The ranks' final
           params must be bitwise equal to each other and to a single
           process that applies the mean of the two half-batch gradients,
           and the loss must be finite and falling. One more step on a
           bf16-wire communicator with grad_compression="bf16" must leave
           the ranks bitwise equal, with a codec wire ratio of 0.5. The
           serve and train runs must copy no flash input (input_copies 0).
           The peak memory per rank must stay within the params, the
           optimizer state, two gradient-sized buffers and 1 GB (the flat
           gradient mean works in the flat vector's own memory).
  elastic  the train phase's run (same model, data, seed, ranks, steps,
           prefetch) under run_elastic, fit() checkpointing every 2 steps
           into one directory per member (max_to_keep 1) and each
           generation restoring the most advanced member's checkpoint.
           Member 1 runs with TPUNET_FAULT_SPEC's churn script and SIGKILLs
           itself once it has logged step 3; the parent respawns it
           without the script; the survivor's next all-reduce fails, it
           rebuilds at generation 1 and both replay steps 3-4. Member 0
           closes one data stream a few MB into its first all-reduce (a
           failover), and both bracket the last step with
           telemetry.profile; the parent merges the rank files. The free
           disk must hold the checkpoints (checked before the first save;
           they are deleted at the end). Gates: the victim died by
           SIGKILL, generation >= 1, both final CRCs and the replayed
           losses bitwise the train phase's, world 2 on both, no churn
           event pending in the replacement, a failover on member 0, the
           merged trace with both ranks' spans of one collective, the
           replacement's launches 2 steps' worth with no input copy, the
           survivor's peak within the train line's limit. Reports detect,
           rebuild, respawn and checkpoint seconds and bytes
  zero     the train phase's run (same model, data, seed, ranks and
           steps) with ZeRO-1: create_zero_train_state and
           make_zero_train_step through fit(), the gradient
           reduce-scattered, AdamW stepped on each rank's half of the flat
           params, the halves all-gathered. The ranks' params must be
           bitwise equal to each other and to the train phase's, the rank
           losses equal to the train phase's, the optimizer state (AdamW's
           moments) per rank at most half the train phase's (plus
           padding), the peak memory per rank at least 2 GB below the
           train phase's; one reduce-scatter and one all-gather a step (no
           all-reduce), the same flash launches as the train phase, no
           input copy. Reports the reduce-scatter's and all-gather's bytes
           and seconds (staging to host, the collective, in all)
  remat    benchmarks/mfu_sweep.py:29's configuration on this card in one
           process: the train widths, global batch 8 x 2048, flash, bf16
           compute, remat; 2 adamw steps for each remat_policy (None,
           "dots", "dots_no_batch") from the same seed. The params must be
           bitwise equal across the policies, the peak memory under None
           below "dots" and "dots_no_batch" at most "dots"; the forward
           launched twice a layer a step under every policy
  vgg      benchmarks/vgg_synthetic.py -n 2 at its defaults: VGG16 (width
           1.0, hidden 4096, 1000 classes, 224 x 224 NHWC images, bf16
           compute over f32 params, dropout 0), sgd(0.01, momentum=0.9),
           32 images per rank on 2 data-parallel ranks spawned on this
           card over loopback tpunet_torch.distributed (f32 wire), each
           rank's synthetic_batch (seed + rank) repeated, fit() with
           log_every=1 for 2 warmup and 6 timed steps. Under deterministic
           cuDNN the ranks' params must be bitwise equal to each other and
           to a single process applying the mean of the two half-batch
           gradients, with equal losses, the loss finite and falling; the
           same steps with 25 MiB buckets must give the flat path's
           params; 2 steps at dropout 0.5, run twice from one seed, must
           be bitwise equal and change the losses. The timed run (what
           users run: cudnn.benchmark) must leave the ranks bitwise equal.
           138,357,544 params (convs, fc1, fc2, head counted apart).
           Reports step seconds, img/s per rank and in all, FLOPs per
           image from the layer shapes and MFU, the all-reduce's seconds
           (staging and collective), the flat and bucketed gradient
           means' seconds, the peak memory per rank, and the img/s under
           deterministic cuDNN
  moe      MoE data-parallel training at the training widths:
           benchmarks/lm_synthetic.py --experts 4 --moe-top-k 2 (moe_every
           2, capacity factor 1.25) on MODEL_TRAIN, six MoE blocks,
           1,339,131,904 params; bf16 compute, f32 master weights, flash,
           remat, adamw 3e-4, moe_aux_weight 0.01; the train phase's ranks,
           batch and token ramps, 4 fit() steps. Gates: the params count;
           the ranks bitwise equal to each other and to one process
           applying the mean of the two half-batch gradients under the
           same objective (aux term included), with the same losses; the
           loss finite and falling; every step's aux loss finite; every
           router moved; flash launches 24 / 12 / 12 a rank-step; no input
           copy; each rank's peak at most 40 GB. Reports step seconds,
           tokens/s, each MoE block's dropped share, the all-reduce's
           seconds and bytes, the peak memory
  qlora    QLoRA fine-tuning at the serving widths: MODEL_735M (GQA-4)
           from --seed, quantize_params, graft_base under
           Transformer(weight_quant="int8", lora_rank=64, lora_alpha=16):
           28,131,328 adapter params; lora_optimizer(adamw(2e-4)), bf16,
           flash, remat, the train phase's ranks, batch and ramps, 4 fit()
           steps. Gates: before training the grafted model's logits on a
           512-token prompt equal the int8 base model's (B = 0); the ranks
           bitwise equal to each other and to the one-process half-batch
           mean; every int8 q and scale, embed and norm scale bitwise its
           start; every lora_b off zero; the loss finite and falling;
           flash launches 24 / 12 / 12 a rank-step, no input copy; then
           greedy generate with the trained model on the serve phase's 8
           prompts, 64 tokens each: tokens in [0, vocab), one flash
           forward a layer per prefill and no backward. Reports step
           seconds, tokens/s, the all-reduce's bytes a step, peak memory
  a2a      the all-to-alls on 4 ranks spawned on this card (loopback): (a)
           byte and typed all-to-all on the f32, bf16 and int8 wires
           (f32 bitwise the block transpose; each compressed non-self block
           bitwise the codec oracle, one encode at the source and one
           decode at the destination, the self block exact), iall_to_all
           beside an iall_reduce, and dcn_all_to_all of a CUDA tensor
           bitwise the host call's, on the card; (b)
           benchmarks/moe_bench.py's defaults through the port's
           MoeDispatcher (world 4, 256 tokens, d 64, capacity 192, skew
           1.0, f32 wire, 32 steps, a 256K wire window, a 4 MiB bulk
           tenant) held to tests/moe_smoke.py's gates: the latency class's
           p99 queue wait within 100 ms, the bulk class moving its budget,
           the a2a byte counters exactly the dispatches' bytes; (c) the
           MoE layer's widths (d 2048, 8192 tokens a rank, top-1 of 4 by
           route_tokens at skew 1.0, capacity 2560): the round trip through
           a stand-in expert x2 is 2x bitwise on kept rows and zero on
           dropped ones, the drop count pack's. Reports the round trip's
           p50 and p99, GB/s and drop fraction
  sp       sequence parallelism across processes at the serve widths
           (MODEL_735M, bf16, random weights from --seed): a global
           sequence of 16,384 tokens, batch 1, over 2 ranks spawned on
           this card, each rank's shard contiguous (dcn_ring, dcn_ulysses)
           or its zigzag chunk pair (dcn_zigzag, tokens through
           to_zigzag), each impl's forward in turn under no_grad. Gates:
           each rank's logits within 5e-2 x max(1, max |ref|) of the
           matching rows of one process running attn_impl="flash" over the
           whole sequence (12 flash launches, no copy), finite, of the
           shard's shape; the ring's and the zigzag's logits with no k/v
           crossing (_exchange_packed planted to return its input) above
           that limit; at 4,096 global tokens in f32 each rank within
           1e-3 x max(1, max |ref|) of the attn_impl="reference" model; no
           flash launch on the ranks; the exchange's calls and payload
           bytes exactly the shapes' (the ring and the zigzag one packed
           k/v exchange a layer, Ulysses two all-to-alls a layer); peak
           memory at most 38 GB a rank. Reports forward seconds and
           tokens/s per rank and impl, the exchange's bytes and seconds,
           and the score elements of each rank's block updates (the
           ring's imbalance against the zigzag's balance)
  pipe     the pipeline-stage workload on 4 stages spawned on this card:
           (a) benchmarks/pipeline_bench.py's base mode (32 microbatches
           of 1 MiB, +1 a stage, TPUNET_NSTREAMS=1,
           TPUNET_ASYNC_CHANNELS=1): the last stage must see every
           microbatch equal to its index + 4; (b) in a spawn of its own,
           at the transport's default streams, the same chain carrying
           8 microbatches of f32 activations (1, 2048, 2048) (embedded
           random tokens, 16 MiB a hop) through 3 consecutive blocks of
           the serve configuration a stage (bf16, flash; one warm-up
           transform a stage before the chain): the last
           stage's outputs bitwise equal to one process running the 12
           blocks in order, 24 flash launches a stage, no copy, each
           link's byte counters at least the chain's bytes. Reports, for
           both chains, the per-microbatch latency p50/p99 (the start of
           stage 0's transform to the end of the last stage's; a later
           microbatch's includes its wait behind the earlier ones), the
           first microbatch's (no queue ahead of it), microbatches/s,
           each stage's seconds inside its transform against its whole
           run (what is left is the wait on its links), and the
           isend/irecv byte counters per stage
  mesh     the in-pod mesh tier in ONE spawn of 4 ranks on this card (a
           mesh device is a rank; three meshes over the same ranks): (a)
           the train phase's model, seed, ramps and batch (8 x 2048, 4 a
           dp rank) with tensor parallelism over {dp: 2, mdl: 2}: bf16
           over f32 masters, flash on each rank's 8 of 16 heads, remat,
           adamw 3e-4, 3 fit() steps, the gradients meaned over dp only.
           Gates: the dp replicas of each mdl rank bitwise equal (CRC32C);
           the first loss (the mean over dp) within 2e-3 relative of the
           train phase's; the loss finite and falling; flash 24 / 12 / 12
           launches a rank-step, no input copy; the peak a rank within the
           TP shard's params, its adamw state, two gradient-sized buffers,
           the gathered f32 logits and 1 GB. (b) gpipe over {pp: 4}: 3
           blocks of the training widths a stage (f32 masters, bf16,
           flash), 8 microbatches of (1, 2048, 2048), forward and backward
           of mean(out ** 2): the output bitwise the 12 blocks run in
           order on one process over the same microbatches, each stage's
           gradients within 1e-1 of max(1, max|ref|) of that run's (the
           bits reported), 24 / 24 / 24 launches a stage (a stage computes
           its 8 ticks only), no copy. (c) {dp: 2, sp: 2} at the serve
           widths (16 heads, 4 kv heads, D 128): ring, zigzag and Ulysses
           on 8,192 tokens a dp replica, 4,096 a rank, forward and
           backward in bf16 against the one-process flash attention of
           the replica's sequence (outputs within 5e-2 x max(1, max|ref|),
           dq, dk, dv within 1e-1 relative), forward in f32 at 2,048
           tokens a replica within 1e-3 x max(1, max|ref|) of
           attention_reference, and a planted fault (no k/v crosses the
           ring) above the bf16 limit; then VGG16 (the vgg phase's
           defaults, dropout 0, deterministic cuDNN) with its classifier
           split over (a)'s mdl axis, 2 steps: the dp replicas bitwise,
           the first loss within 2e-3 relative of the vgg phase's. Reports
           each part's seconds, each axis collective's calls, bytes and
           seconds, the dp all-reduce's, step times and the peaks. The
           kernel phases hold the TP path's attention shape (bf16 B4 S2048
           8 heads, 8 kv heads, D128 causal) forward and backward
  dcn_mesh the DCN tier across meshes (ROADMAP A.6d) in ONE spawn of 4
           ranks on this card: 2 "hosts" of {mdl: 2}, each host a mesh
           and each mesh position's 2 ranks a DCN group (TP inside a host,
           DP across hosts). The train phase's model, seed and ramps (bf16
           over f32 masters, flash on each rank's 8 of 16 heads, remat,
           adamw 3e-4), host h on the train phase's rank-h batches (4 x
           2048: the global batch is train's), 3 fit() steps of
           make_train_step(cross_host=True) (the flat vector over the DCN
           group), then, from the same init and with the first state
           freed, 3 of ZeRO-1 (reduce-scatter and all-gather over the DCN
           group). Gates: the first loss (the mean over the hosts) within
           2e-3 relative of the train phase's; the losses finite and
           falling; the two hosts' blocks of each mdl rank bitwise equal;
           ZeRO's blocks (CRC32C) and losses bitwise cross_host's; the
           DCN calls one all-reduce a step (cross_host), one
           reduce-scatter and one all-gather a step and no all-reduce
           (ZeRO); ZeRO's adamw moments at most half of cross_host's plus
           padding; cross_host's peak within the mesh phase's (a) limit;
           cross_host's losses within 2e-3 relative of the mesh phase's
           (a), which runs the same global batch with dp inside one host
           (bitwise or not, with the gap, reported); flash 24 / 12 / 12 a
           rank-step, no copy. Reports step seconds, the DCN group's
           calls, bytes and seconds (staging, collective) and their share
           of fit(), the mdl collectives, peaks and optimizer bytes
  mesh6c   the mesh options of ROADMAP A.6c in ONE spawn of 4 ranks on
           this card over {dp: 2, mdl: 2}, random weights from --seed: (a)
           TP serving of the serve configuration at 6 of its 12 layers
           (bf16, flash on each rank's 8 heads and 2 kv heads, the decode
           cache of its kv heads): generate on 4 of the serve phase's prompt lengths cut
           to the shortest (2 rows a dp rank), 32 greedy tokens, in f32
           (the checkpoint widened) and in bf16; the serve phase's 8
           requests of 128..512 x 64 greedy tokens through the plain
           BatchServer (slots 8, every rank the whole server) and the
           int8 self-draft one (gamma 4); then the disaggregated tiers
           (ROADMAP A.12): the dp-0 group prefills the 8 requests (the
           Router on its leader) and ships them on the f32 KV wire to the
           dp-1 group, which decodes (slots 8, max_len 1024). Gates:
           every rank of a tp group holds the same tokens; f32 generate's
           tokens bitwise one process's f32 generate of the rank's rows
           (ROADMAP C.19: a bf16 near-tie may part either way with the
           batch, so bf16 generate's divergences are reported, not
           gated); both servers' tokens equal the one-process plain
           BatchServer's or a row diverges only at a tie (the spec
           phase's rule, the path under test's half on the ranks, the
           reference's here; at the first generated column the prefills'
           logits); the tiers' tokens bitwise the dp-1 group's plain
           server's, one digest of them on both decode ranks, every block
           adopted and none prefilled there, collectives over mdl alone;
           flash launched once a layer a prefill on (8, 2) heads (48 on
           each prefill rank of the tiers, none on a decode rank), no
           copy; the peak a rank within 8 GB; the self-draft commits
           more than one token a round. Reports the tiers' seconds,
           TTFT/TPOT p50 and KV wire bytes. (b) the qlora phase's
           configuration over the mesh (int8 q and scale and the adapters
           split by the partition rules), lora_optimizer(adamw(2e-4)), 4
           rows a dp rank of the train batches, 3 fit() steps, then 32
           greedy tokens of int8 generate under TP on (a)'s prompts.
           Gates: the dp replicas bitwise; the first loss within 2e-3
           relative of the qlora phase's; every frozen leaf bitwise its
           start; every lora_b off zero; flash 24 / 12 / 12 a rank-step;
           the int8 tokens in [0, vocab) with one flash launch a layer.
           (c) the moe phase's configuration (1,339,131,904 params) with
           its experts over ep = dp and their FFN over mdl, accum_steps 2,
           fused_xent_block 8192, 4 rows a dp rank, 3 fit() steps. Gates:
           the leaves replicated over dp bitwise equal across it; the
           first loss within 2e-3 relative of one process's no-grad
           forward of the same two global microbatches on the whole
           model; the losses and every block's aux finite; each block's
           dropped (token, choice)s exactly a one-process recount of the
           global microbatch's routing the ranks chose (flax's
           choice-major slots at the global capacity; against the
           one-process forward's own routing, which bf16 TP rounding
           flips for a few tokens at near-ties, the counts are
           reported); every psum_scatter on dp moving one whole (e, cap,
           d) bf16 buffer and every all_gather half of one. Reports tokens/s beside the
           one-process references', the acceptance, step seconds, each
           axis collective's calls, bytes and seconds, and the peaks. The
           kernel phases hold the rank's GQA shapes (bf16 8 heads, 2 kv
           heads, D128 causal: B4 S2048 forward and backward, B1 S512
           forward)
  dryrun   the multichip dry run of ROADMAP A.8b in ONE spawn of 8 ranks
           on this card: (a) tpunet_torch.dryrun's five programs as
           dryrun_multichip runs them (rank 0 prints JAX's six
           "dryrun_multichip OK" lines with the port's numbers); (b) the
           transformer program at full width (d 2048, 16 heads, 4 kv
           heads, swiglu ff 8192, vocab 32000, cut to 4 layers: 2 MoE
           layers of dp = 2 experts, top-2), bf16 over f32 masters, ring
           over sp, TP over mdl, experts over ep = dp, accum_steps 2,
           batch 4 x 2048 over {dp: 2, sp: 2, mdl: 2}, 2 steps. Gates:
           each step's loss within 2e-3 relative of one process's same
           steps (the program's step on the global batch, whose two
           microbatches are the mesh's); the leaves replicated over dp
           bitwise equal across it; the losses finite.
           Reports each MoE block's dropped share, the axis collectives,
           the peak a rank and the step seconds. (c) the serve program at
           full width over {dp: 2, mdl: 4}: the serve configuration at 6
           of 12 layers (16 heads, 4 kv heads: one kv head a rank), bf16,
           flash, window 256 on the ring cache, 3 requests of 512 / 301 /
           128 prompt tokens and 32 / 24 / 16 greedy tokens through the
           plain BatchServer (slots 2, 4 steps a call) and the int8
           self-draft one (gamma 3), pipeline 2. Gates: every rank of a tp
           group holds the same tokens, each request's tokens equal the
           one-process port's or a row diverges only at a tie (mesh6c's
           rule); flash launched once a layer a prefill on (4, 1) heads,
           no copy. The kernel phases hold the rank's prefill shape (bf16
           B1 S512, 4 heads, 1 kv head, D128, causal, window 256)
Then one JSON line describing each kernel: flash_fwd, flash_dq and
flash_dkv on the main (train) path, bf16 at D=128, and their _f32 and
_wide routes (launches from the paths phase; times from the kernel case
at each path's own shape: the f32 training shape, and bf16 B2 S1024 4
heads 1 kv head D320), with the tensor-core instructions of the function
each runs, and for the bf16 kernels the launches on each path (train,
moe, qlora, sp's one-process reference, pipe, mesh's TP x DP run,
dcn_mesh's two runs, mesh6c's three parts and dryrun's servers);
and, last, the device line.

TF32 is off throughout (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 are False), so f32 references are true f32.
Weights are random, drawn from --seed at the flax initialisers' scales.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import itertools
import json
import os
import queue
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

# Deterministic cuBLAS across the two serving threads' handles and across
# the training ranks and their single-process reference.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

DEVICE = "cuda"
CARD = None  # nvidia-smi's name and power limit, set by phase_card
MODEL_735M = dict(vocab=32000, d_model=2048, n_layers=12, n_heads=16,
                  n_kv_heads=4, d_ff=8192, mlp_impl="gelu")
# The headline training configuration of benchmarks/tpu_headline.py: MHA.
MODEL_TRAIN = dict(vocab=32000, d_model=2048, n_layers=12, n_heads=16,
                   d_ff=8192, mlp_impl="gelu")
TRAIN_RANKS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 4, 2048, 4, 3e-4
# ZeRO-1 halves AdamW's two f32 moments at 2 ranks: 2.94 GB of 5.88 at
# 735,102,976 params; the zero phase wants at least this much off the
# replicated step's peak per rank.
ZERO_MEM_SAVING_GB = 2.0
# The replicated step's peak per rank may hold the params, the optimizer
# state and two gradient-sized buffers (the gradients and the flat vector
# they are copied into), plus this much for everything else.
TRAIN_MEM_SLACK_GB = 1.0
# make_train_step's default weight of the MoE load-balancing loss, which
# the ranks train with and the single-process references use.
MOE_AUX_WEIGHT = 0.01
# The remat phase: benchmarks/mfu_sweep.py:29's configuration (the train
# widths, global batch 8 x 2048 on one card), every remat_policy.
REMAT_POLICIES, REMAT_BATCH, REMAT_STEPS = (None, "dots", "dots_no_batch"), 8, 2
# The vgg phase: benchmarks/vgg_synthetic.py -n 2 at its defaults: VGG16
# (width 1.0, hidden 4096, 1000 classes, 224 x 224 images, bf16 compute,
# dropout 0), sgd(0.01, momentum=0.9), 32 images per rank, 2 ranks. Steps:
# VGG_WARMUP, then the timed ones; the dropout runs take VGG_DROPOUT_STEPS
# at vgg16()'s default rate. Buckets: PyTorch DDP's default size.
VGG_RANKS, VGG_BATCH, VGG_IMAGE, VGG_CLASSES, VGG_LR = 2, 32, 224, 1000, 0.01
VGG_HIDDEN = 4096
VGG_STEPS, VGG_WARMUP, VGG_DROPOUT, VGG_DROPOUT_STEPS = 8, 2, 0.5, 2
VGG_BUCKET_BYTES = 25 << 20
# VGG16's params by layer group (convs, fc1, fc2, head).
VGG_PARAMS = {"conv": 14_714_688, "fc1": 102_764_544, "fc2": 16_781_312,
              "head": 4_097_000}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
PEAK_FLOPS = {BF16: 989e12, F16: 989e12,   # dense 16-bit tensor cores
              F32: 67e12}                  # f32 outside the tensor cores
# The forward's largest error, absolute: tests/test_ops.py's f32 and bf16
# limits; f16 rounds o and P to 11 significant bits where bf16 keeps 8, so
# its limit is a third of bf16's (1 ulp of f16 is <= 3.9e-3 below |o| = 8).
TOL = {BF16: 3e-2, F16: 1e-2, F32: 2e-5}
# Backward tolerances of tests/test_ops.py's gradient tests, relative to
# max(1, max|reference|); f16 a tenth of bf16's (its P and dS keep 3 more
# bits; sound f16 lines read <= 8e-4).
BWD_TOL = {BF16: 1e-1, F16: 1e-2, F32: 5e-5}
# A second check that scales with each output row (one position of one head,
# over D): the row's error norm over the reference row's norm. The limits
# sit between the largest reading of sound runs and the smallest reading of
# the planted faults (_planted_dq_faults, _planted_dkv_faults); PERF.md
# gives both. A row of (near) zero reference norm is held to ROW_FLOOR of
# the largest row instead of its own norm: a dQ row that sees one key is 0
# exactly (dP = delta there), and the cancellation leaves noise of up to
# 7e-7 of the largest row in bf16 on the tensor cores (PERF.md). f16 keeps
# bf16's row limit and floor: its dQ rows of near-zero norm carry the same
# order of cancellation noise (up to 1.45e-2 of the floor on the H100,
# PERF.md), though its other rows read 10x lower.
ROW_TOL = {BF16: 5e-2, F16: 5e-2, F32: 1e-4}
ROW_FLOOR = {BF16: 1e-4, F16: 1e-4, F32: 1e-6}


def _dkv_tile(d: int, dt) -> tuple:
    """The dK/dV kernel's k rows a block and q rows a step at head dim d:
    16-bit flash_dkv_bf16_kernel to 128, flash_dkv_bf16_dsplit_kernel
    to 256, flash_dkv_wide_bf16_kernel above; f32 flash_dkv_f32_kernel,
    flash_dkv_wide_f32_kernel above 256."""
    if dt == F32:
        return (64, 128) if d <= 128 else (32, 128)
    if d > 256:
        return (64, 64)
    return (128, 64) if d <= 128 else (64, 32)


def _dq_tile(d: int, dt) -> tuple:
    """The dQ kernel's q rows a block and keys a step at head dim d:
    flash_dq_bf16_kernel (16-bit) and flash_dq_f32_kernel (f32) to 256,
    flash_dq_wide_bf16_kernel and flash_dq_wide_f32_kernel above."""
    if dt == F32:
        return (64, 128) if d <= 128 or d > 256 else (32, 128)
    if d > 256:
        return (64, 64)
    return (128, 64) if d <= 128 else (128, 32)


def _fwd_tile(d: int, dt) -> tuple:
    """The forward kernel's q rows a block and keys a step at head dim d
    (after the pad to a multiple of 8): 16-bit flash_fwd_bf16_kernel to
    256, flash_fwd_wide_bf16_kernel above; f32 flash_fwd_f32_kernel to
    256, flash_fwd_wide_f32_kernel above."""
    d = -(-d // 8) * 8
    if dt == F32:
        return (128, 128) if d <= 128 else (64, 128)
    if d > 256:
        return (64, 64)
    return (128, 128) if d <= 128 else (128, 64)


def _fwd_spans(d: int, dt) -> list:
    """The column spans [lo, hi) of O above head dim 256, as the wide
    forward splits them: bf16/f16 one per consumer warpgroup (half of a
    block's group of at most eight 64-column chunks), f32 one per cluster
    block (128 columns)."""
    if dt == F32:
        return [(lo, min(lo + 128, d)) for lo in range(0, d, 128)]
    nch = -(-d // 64)
    nz = -(-nch // 8)
    spans = []
    for z in range(nz):
        gb, ge = z * nch // nz, (z + 1) * nch // nz
        mid = gb + (ge - gb) // 2
        spans += [(64 * gb, 64 * mid), (64 * mid, min(64 * ge, d))]
    return spans


COUNTERS = {"flash_fwd": "kernel_launches", "flash_dq": "flash_dq_launches",
            "flash_dkv": "flash_dkv_launches"}
# Kernel functions that must issue wgmma (every 16-bit forward, dQ and
# dK/dV, the wide ones too), the ones that must exist among them (the
# D = 256 and the wide ones, every f16 function), the f32 and wide f32
# (D > 256) CUDA-core functions that must exist without a spill, and the
# function each entry of the kernels line runs (the bf16 D = 128 main
# path, the f32 and the wide paths), by the _short names of csrc/*.cu's
# instantiations. No function of the replaced CUDA-core dQ and dK/dV
# kernels, nor of the wide kernels that ran every dtype on the CUDA cores,
# may exist.
TENSOR_CORE_KERNELS = ("flash_fwd_bf16_kernel<", "flash_dq_bf16_kernel<",
                       "flash_dkv_bf16_kernel<",
                       "flash_dkv_bf16_dsplit_kernel<",
                       "flash_fwd_wide_bf16_kernel<",
                       "flash_dq_wide_bf16_kernel<",
                       "flash_dkv_wide_bf16_kernel<")
D256_FUNCTIONS = ("flash_dq_bf16_kernel<bf16,256>",
                  "flash_dkv_bf16_dsplit_kernel<bf16>") + tuple(
    f"flash_{k}_wide_bf16_kernel<{t}>" for k in ("dq", "dkv")
    for t in ("bf16", "f16")) + tuple(
    f"flash_fwd_wide_bf16_kernel<{t}>" for t in ("bf16", "f16"))
F16_FUNCTIONS = tuple(
    [f"flash_fwd_bf16_kernel<f16,{dt},{bk}>"
     for dt, bk in ((64, 128), (128, 128), (256, 64))]
    + [f"flash_dq_bf16_kernel<f16,{dt}>" for dt in (64, 128, 256)]
    + [f"flash_dkv_bf16_kernel<f16,{dt}>" for dt in (64, 128)]
    + ["flash_dkv_bf16_dsplit_kernel<f16>"])
F32_FUNCTIONS = tuple(f"flash_{k}_f32_kernel<{dt}>"
                      for k in ("fwd", "dq", "dkv") for dt in (64, 128, 256))
WIDE_FUNCTIONS = ("flash_fwd_wide_f32_kernel",) + tuple(
    f"flash_dq_wide_f32_kernel<{n}>" for n in (2, 4, 8)) + (
    "flash_dkv_wide_f32_kernel",)
REPLACED = ("flash_dq_kernel<", "flash_dkv_kernel<", "flash_fwd_wide_kernel<",
            "flash_dq_wide_kernel<", "flash_dkv_wide_kernel<")
ENTRY_FUNCTIONS = {"flash_fwd": "flash_fwd_bf16_kernel<bf16,128,128>",
                   "flash_dq": "flash_dq_bf16_kernel<bf16,128>",
                   "flash_dkv": "flash_dkv_bf16_kernel<bf16,128>",
                   "flash_fwd_f32": "flash_fwd_f32_kernel<128>",
                   "flash_dq_f32": "flash_dq_f32_kernel<128>",
                   "flash_dkv_f32": "flash_dkv_f32_kernel<128>",
                   "flash_fwd_wide": "flash_fwd_wide_bf16_kernel<bf16>",
                   "flash_dq_wide": "flash_dq_wide_bf16_kernel<bf16>",
                   "flash_dkv_wide": "flash_dkv_wide_bf16_kernel<bf16>"}
SASS: dict = {}  # the build phase's tensor-core census, by _short name
# Kernel cases, (b, sq, sk, hk, causal, window, dtype, d) with 16 q heads;
# the kernel phases run PATH_CASES (the wide path's own shape, 4 q heads)
# before them (_kernel_cases). The kernels line reports the first case of
# each entry: the training shape for the bf16 entries, the f32 training
# shape (which the f32 path runs) for the f32 entries, the wide path's
# bf16 shape for the wide entries. Rows that see no key: Sq 517, Sk 401,
# window 16 (qpos >= 416). Head dims 12 and 100 run zero-padded to 16 and
# 104; B 4097 x 16 heads = 65,552 is above grid.y's 65,535 blocks. Head
# dims 320 and 512 run the wide kernels in every dtype; the forward also
# runs D = 576 in every dtype (16-bit: two groups of chunks, each forming
# its own scores, past the 512 columns one block covers; f32: 5 span
# blocks a cluster) and f32 D = 800 (7 span blocks a cluster), 1024 (a
# cluster of 8, the largest) and 1160 (past the f32 layout's boundary of
# eight spans: two clusters of 8, the second's six blocks past D).
WIDE_CASES = [c for dt in (BF16, F16, F32) for c in (
    (1, 1024, 1024, 4, True, None, dt, 320),
    (1, 517, 401, 4, True, 16, dt, 512))]
FWD_CASES = (
    [(4, 2048, 2048, 16, True, None, BF16, 128),
     (4, 2048, 2048, 16, True, None, F32, 128),   # the f32 training shape
     (4, 2048, 2048, 16, True, None, F16, 128)]
    + [c for dt in (BF16, F32) for c in (
        (1, 512, 512, 4, True, None, dt, 128),   # serving
        (8, 512, 512, 4, True, None, dt, 128),
        (1, 401, 401, 4, True, None, dt, 128),   # ragged
        (1, 512, 512, 4, True, 128, dt, 128),    # window
        (2, 384, 512, 4, False, None, dt, 128),
        (2, 401, 401, 4, True, None, dt, 12),    # head dims off the 8s
        (1, 517, 300, 2, True, 64, dt, 100),
        (4097, 64, 64, 16, True, None, dt, 8))]  # B*H = 65,552
    # The tensor-core kernel's other head dims, GQA-8 and ragged Sq != Sk.
    + [(2, 401, 517, 2, True, None, BF16, 64),
       (2, 137, 300, 2, True, 64, BF16, 96),
       (1, 300, 401, 2, False, None, BF16, 256),
       (1, 517, 401, 2, True, None, BF16, 256),
       (2, 2048, 2048, 16, True, None, BF16, 256)]
    # f16: GQA-8 ragged, head dim 256.
    + [(2, 401, 517, 2, True, None, F16, 128),
       (1, 517, 401, 2, True, None, F16, 256)]
    + [(1, 517, 401, 4, True, 16, dt, 128) for dt in (BF16, F32, F16)]
    + WIDE_CASES
    + [(1, 1024, 1024, 4, True, None, dt, 576) for dt in (BF16, F16, F32)]
    + [(1, 300, 300, 4, True, None, F32, d) for d in (800, 1024, 1160)]
    # The serve configuration's attention on the sp phase's one-process
    # reference (a 16,384-token sequence; the plain version's f32 scores
    # take 17 GB) and on each pipe stage (2,048 tokens).
    + [(1, 16384, 16384, 4, True, None, BF16, 128),
       (1, 2048, 2048, 4, True, None, BF16, 128)])
BWD_CASES = [
    (4, 2048, 2048, 16, True, None, BF16, 128),
    (4, 2048, 2048, 16, True, None, F32, 128),
    (4, 2048, 2048, 16, True, None, F16, 128),
    (1, 2048, 2048, 4, True, None, BF16, 128),
    (1, 401, 401, 4, True, None, BF16, 128),
    (1, 1024, 1024, 16, True, 128, BF16, 128),
    (2, 384, 512, 4, False, None, BF16, 128),
    (2, 384, 512, 4, False, None, F32, 128),
    (2, 401, 300, 2, True, None, BF16, 64),
    (2, 401, 300, 2, True, None, F16, 128),
    (1, 517, 401, 4, True, 16, BF16, 128),
    (1, 517, 401, 4, True, 16, F32, 128),
    (1, 517, 401, 4, True, 16, F16, 128),
    # D = 256: B1 S1024 GQA-4, the training shape's work, GQA-8 ragged, no
    # key.
    (1, 1024, 1024, 4, True, None, BF16, 256),
    (2, 2048, 2048, 16, True, None, BF16, 256),
    (2, 401, 300, 2, True, None, BF16, 256),
    (2, 401, 300, 2, True, None, F16, 256),
    (1, 517, 401, 4, True, 16, BF16, 256)] + [
    c for dt in (BF16, F32) for c in (
        (2, 401, 401, 4, True, None, dt, 12),    # head dims off the 8s
        (1, 517, 300, 2, True, 64, dt, 100),
        (4097, 64, 64, 16, True, None, dt, 8))] + [  # B*H = 65,552
    # flash_dq_f32_kernel's other tiles: D = 64, and D = 256 at the
    # training shape's work.
    (4, 2048, 2048, 16, True, None, F32, 64),
    (2, 2048, 2048, 16, True, None, F32, 256)] + WIDE_CASES + [
    # The wide tensor-core backward at three spans of three 64-column
    # chunks (f32: five 128-column spans, the last one half empty; dQ four
    # 192-column spans, the last one past D).
    (1, 1024, 1024, 4, True, None, BF16, 576),
    # f32 dQ in clusters of 8 (five 192-column spans and three past D).
    (1, 300, 300, 4, True, None, F32, 800)]
# A bf16 q that TMA cannot read as it is: sliced from a wider buffer at an
# odd element offset (b, sq, sk, hk, causal, window, d): the wrapper copies
# it (input_copies) and runs the same kernels.
MISALIGNED_CASE = (2, 401, 401, 4, True, None, 128)


def log(phase: str, **fields) -> None:
    print(f"{phase}: " + json.dumps(fields, default=str), flush=True)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn over `iters` launches, after a warmup."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_card() -> None:
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    CARD = smi
    print(smi, flush=True)
    log("card", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))


def phase_build() -> None:
    from tpunet_torch import _native
    from tpunet_torch.ops import _build

    times, errors = {}, []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
        times[name] = round(time.perf_counter() - t0, 3)

    # Every kernel library is rebuilt, so ptxas reports on each function.
    jobs = [("libtpunet.so", _native.build_native)] + [
        (f"lib{n}.so", lambda n=n: _build.build(n, force=True))
        for n in _build.sources()]
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    ptxas = _ptxas_report(_build.build_logs)
    SASS.update(_tensor_core_census(_build))
    log("build", seconds=times, ptxas=ptxas, tensor_core_instrs=SASS)
    log("build", f16_functions={f: dict(**SASS.get(f, {}),
                                         **ptxas.get(f, {}))
                                  for f in F16_FUNCTIONS},
        f32_functions={f: ptxas.get(f) for f in F32_FUNCTIONS},
        wide_functions={f: ptxas.get(f) for f in WIDE_FUNCTIONS})
    tc = [f for f in SASS if f.startswith(TENSOR_CORE_KERNELS)]
    cuda_core = list(F32_FUNCTIONS + WIDE_FUNCTIONS)
    missing = [f for f in tc if SASS[f]["HGMMA"] == 0]
    missing += [f for f in D256_FUNCTIONS + F16_FUNCTIONS + tuple(cuda_core)
                if f not in SASS]
    unreported = [f for f in tc + cuda_core if f not in ptxas]
    spills = [f for f in tc + cuda_core
              if f in ptxas and ptxas[f]["spill_bytes"]]
    replaced = [f for f in SASS if f.startswith(REPLACED)]
    if not tc or missing or unreported or spills or replaced:
        raise AssertionError(f"kernels missing or tensor-core kernels "
                             f"without HGMMA {missing}, without a ptxas "
                             f"report {unreported} or with register spills "
                             f"{spills}; replaced CUDA-core dQ or dK/dV "
                             f"kernels {replaced}")


def _short(fn: str) -> str:
    """A mangled kernel function as name<args>, e.g.
    flash_fwd_bf16_kernel<f16,128,128>, flash_dq_f32_kernel<128>,
    flash_dkv_bf16_dsplit_kernel<bf16>, flash_fwd_wide_f32_kernel."""
    m = re.search(r"(?<=\d)(flash_\w+?_kernel)(?:I(.+?)EEv)?", fn)
    if not m:
        return fn
    if m.group(2) is None:
        return m.group(1)
    args = m.group(2).replace("13__nv_bfloat16", "bf16,")
    args = args.replace("6__half", "f16,").replace("Li", "")
    args = args.replace("E", ",").strip(",")
    if args.startswith("f") and not args.startswith("f16"):
        args = ("f32," + args[1:]).strip(",")
    return f"{m.group(1)}<{args}>"


def _ptxas_report(logs: dict) -> dict:
    """{kernel: {"registers": n, "spill_bytes": n}} from nvcc's -Xptxas -v
    output. Registers are the launch allocation; the tensor-core kernels'
    consumer warpgroups raise theirs to 232 with setmaxnreg."""
    out, fn = {}, None
    for text in logs.values():
        for ln in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                fn = _short(m.group(1))
                out[fn] = {"registers": None, "spill_bytes": 0}
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and fn:
                out[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m and fn:
                out[fn]["registers"] = int(m.group(1))
    return out


def _cuobjdump() -> str:
    """cuobjdump from the CUDA toolkit, else the copy Triton ships."""
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        cand = Path(root) / "bin" / "cuobjdump"
        if root and cand.exists():
            return str(cand)
    import importlib.util

    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        cand = (Path(spec.origin).parent / "backends" / "nvidia" / "bin"
                / "cuobjdump")
        if cand.exists():
            return str(cand)
    raise RuntimeError("cuobjdump not found")


def _tensor_core_census(build) -> dict:
    """{kernel function: {"HGMMA": n, "HMMA": n}} from each kernel
    library's SASS: wgmma issues as HGMMA, mma.sync as HMMA."""
    census = {}
    for name in build.sources():
        lib = build.BUILD_DIR / f"lib{name}.so"
        sass = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        fn = None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                fn = _short(m.group(1))
                census[fn] = {"HGMMA": 0, "HMMA": 0}
            elif fn and "HGMMA" in ln:
                census[fn]["HGMMA"] += 1
            elif fn and "HMMA" in ln:
                census[fn]["HMMA"] += 1
    return census


def _tensor_core_instrs(entry: str) -> int:
    """HGMMA + HMMA instructions of the instantiation that an entry of the
    kernels line runs (ENTRY_FUNCTIONS)."""
    c = SASS[ENTRY_FUNCTIONS[entry]]
    return c["HGMMA"] + c["HMMA"]


def _pairs(sq, sk, causal, window) -> int:
    """Unmasked (q, k) pairs of one (batch, head)."""
    if not causal:
        return sq * sk
    qp = np.arange(sq)[:, None]
    kp = np.arange(sk)[None, :]
    keep = qp >= kp
    if window is not None:
        keep &= (qp - kp) < window
    return int(keep.sum())


def _bound(flops, nbytes, dtype) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak rate of their type and the bytes over HBM's rate."""
    t_flops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_flops, t_bytes) * 1e3,
                bound_by="operations" if t_flops >= t_bytes else "bytes")


def _attention_work(kind, b, sq, sk, h, hk, d, causal, window, dtype):
    """(flops, bytes) one kernel must do on these inputs; each input read
    once, each output written once. Per unmasked (q, k) pair: the forward
    4*D flops (q.k and p.v), dQ 6*D (q.k, dO.v, dS.k), dK/dV 8*D (q.k,
    dO.v, P^T.dO, dS^T.q)."""
    pair_flops = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}[kind] * d
    item = torch.tensor([], dtype=dtype).element_size()
    q_bytes, kv_bytes = b * sq * h * d * item, b * sk * hk * d * item
    rows_f32 = b * h * sq * 4  # one f32 per query row: lse, delta
    if kind == "flash_fwd":  # q, k, v in; o, lse out
        nbytes = 2 * q_bytes + 2 * kv_bytes + rows_f32
    elif kind == "flash_dq":  # q, k, v, dO, lse, delta in; dQ out
        nbytes = 3 * q_bytes + 2 * kv_bytes + 2 * rows_f32
    else:  # q, k, v, dO, lse, delta in; dK, dV out
        nbytes = 2 * q_bytes + 4 * kv_bytes + 2 * rows_f32
    return pair_flops * b * h * _pairs(sq, sk, causal, window), nbytes


def _row_err(got, want, floor=None) -> float:
    """max over rows of |got - want| / |want|, norms over the last dim; a
    reference row of (near) zero norm is held to `floor` (by default
    ROW_FLOOR[want's dtype]) of the largest."""
    g, w = got.float(), want.float()
    floor = ROW_FLOOR[want.dtype] if floor is None else floor
    den = w.norm(dim=-1)
    den = den.clamp_min(max(floor * float(den.max()), 1e-30))
    return float(((g - w).norm(dim=-1) / den).max())


def _planted_dkv_faults(q, k, v, do, lse, delta, causal, window, got,
                        want) -> dict:
    """Readings of two dK/dV faults, planted in the kernel's own outputs by
    taking away the exact f32 contribution of the work they skip: the row
    check's (_row_err) and the max-error check's (largest error over
    max(1, max|ref|), which BWD_TOL bounds). The faults:
      q_tile_start: every k tile after the first skips its first q tile
                    (a causal loop start one tile late; the kernel's tiles,
                    _dkv_tile);
      gqa_head:     the last q head of each GQA group is left out;
      grid_limit:   (B*Hkv > 65,535) the blocks past grid.y's 65,535
                    compute nothing, so those heads' dK and dV stay 0.
    A fault that cannot happen at this shape (one k tile; no GQA) is not
    planted."""
    from tpunet_torch.ops.flash_attention import _bwd_plain_parts

    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    group = h // hk
    p, ds, _ = _bwd_plain_parts(q, k, v, do, lse, delta, causal, window)
    bk, bq = _dkv_tile(d, q.dtype)
    tile = torch.zeros((sq, sk), device=q.device)
    for k0 in range(bk, sk, bk):
        q0 = (k0 // bq) * bq if causal else 0
        tile[q0:q0 + bq, k0:k0 + bk] = 1
    masks = {"q_tile_start": tile[None, None]} if sk > bk else {}
    if group > 1:
        heads = (torch.arange(h, device=q.device) % group) == group - 1
        masks["gqa_head"] = heads.float()[None, :, None, None]
    out = {}
    for name, mask in masks.items():
        row_err, max_err = 0.0, 0.0
        for g, w, x, y in zip(got, want, (ds, p), (q, do)):
            part = torch.einsum("bhqk,bqhd->bkhd", x * mask, y.float())
            bad = g.float() - part.reshape(b, sk, hk, group, d).sum(3)
            row_err = max(row_err, _row_err(bad, w))
            w = w.float()
            max_err = max(max_err, float((bad - w).abs().max())
                          / max(1.0, float(w.abs().max())))
        out[name] = dict(row_err=row_err, max_err=max_err)
    if b * hk > 65535:
        out["grid_limit"] = _grid_limit_fault(got, want)
    return out


def _grid_limit_fault(got, want) -> dict:
    """The row check's and max-error check's readings of outputs (B, S,
    heads, D) whose (batch, head) blocks past 65,535, the grid.y limit,
    computed nothing."""
    row_err, max_err = 0.0, 0.0
    for g, w in zip(got, want):
        b, _, h, _ = g.shape
        dead = (torch.arange(b * h, device=g.device) >= 65535).reshape(
            b, 1, h, 1)
        bad = g.float().masked_fill(dead, 0.0)
        row_err = max(row_err, _row_err(bad, w))
        max_err = max(max_err, float((bad - w.float()).abs().max())
                      / max(1.0, float(w.float().abs().max())))
    return dict(row_err=row_err, max_err=max_err)


def _planted_dq_faults(q, k, v, do, lse, delta, causal, window, got,
                       want) -> dict:
    """Readings of two dQ faults, planted in the kernel's own output as
    _planted_dkv_faults does: the row check's and the max-error check's.
    The faults:
      last_k_tile: every q tile leaves out the last key tile its loop
                   visits (the kernel's tiles, _dq_tile), a causal loop end
                   one tile early: the exact f32 dS.K of that tile is taken
                   away;
      kv_head:     every q head reads the next kv head's K and V
                   ((h // group + 1) % Hkv): the exact f32 change of dQ that
                   this makes is added;
      grid_limit:  (B*H > 65,535) the blocks past grid.y's 65,535 compute
                   nothing, so those heads' dQ stays 0.
    got and want are 1-tuples (dQ), as the row loop holds them."""
    from tpunet_torch.ops.flash_attention import _bwd_plain_parts

    (got,), (want,) = got, want
    sq, sk = q.shape[1], k.shape[1]
    _, ds, k_full = _bwd_plain_parts(q, k, v, do, lse, delta, causal, window)
    bq, bk = _dq_tile(q.shape[3], q.dtype)
    n_kt = -(-sk // bk)
    tile = torch.zeros((sq, sk), device=q.device)
    for q0 in range(0, sq, bq):
        kt_end = min(n_kt, -(-(q0 + bq) // bk)) if causal else n_kt
        tile[q0:q0 + bq, (kt_end - 1) * bk:kt_end * bk] = 1
    bad = {"last_k_tile": got.float() - torch.einsum(
        "bhqk,bkhd->bqhd", ds * tile, k_full.float())}
    del tile
    if k.shape[2] > 1:
        kr, vr = k.roll(-1, dims=2), v.roll(-1, dims=2)
        _, ds_w, k_w = _bwd_plain_parts(q, kr, vr, do, lse, delta, causal,
                                        window)
        bad["kv_head"] = got.float() + torch.einsum(
            "bhqk,bkhd->bqhd", ds_w, k_w.float()) - torch.einsum(
            "bhqk,bkhd->bqhd", ds, k_full.float())
        del ds_w, k_w
    w = want.float()
    scale = max(1.0, float(w.abs().max()))
    out = {name: dict(row_err=_row_err(x, want),
                      max_err=float((x - w).abs().max()) / scale)
           for name, x in bad.items()}
    if q.shape[0] * q.shape[2] > 65535:
        out["grid_limit"] = _grid_limit_fault((got,), (want,))
    return out


def _planted_fwd_faults(q, k, v, causal, window, got, want) -> dict:
    """Readings of two forward faults, planted in the kernel's own output o
    from the plain version's exact f32 parts: the row check's (_row_err)
    and the max-error check's (largest absolute error, which TOL bounds).
    The faults:
      k_tile_end:  every q tile's loop stops one k tile early (the kernel's
                   tiles, _fwd_tile): the exact P.V of the tile it leaves
                   out is taken away and the rest renormalised (a row that
                   keeps no key reads 0);
      span_scores: (D > 256) the columns of the last span (_fwd_spans) are
                   computed from scores that miss the head dim's last
                   64-column chunk (the plain attention on those scores).
    """
    from tpunet_torch.ops.flash_attention import (_gqa_group,
                                                  _masked_scores, _repeat_kv)

    b, sq, h, d = q.shape
    sk = k.shape[1]
    group = _gqa_group(q, k)
    kf, vf = _repeat_kv(k, group), _repeat_kv(v, group)
    p = torch.softmax(_masked_scores(q, kf, causal, window), dim=-1)
    bq, bk = _fwd_tile(d, q.dtype)
    n_kt = -(-sk // bk)
    tile = torch.zeros((sq, sk), device=q.device)
    for q0 in range(0, sq, bq):
        kt_end = min(n_kt, -(-(q0 + bq) // bk)) if causal else n_kt
        tile[q0:q0 + bq, (kt_end - 1) * bk:kt_end * bk] = 1
    p *= tile
    num = got.float() - torch.einsum("bhqk,bkhd->bqhd", p, vf.float())
    den = (1.0 - p.sum(-1)).transpose(1, 2)[..., None]
    del p, tile
    bad = {"k_tile_end": torch.where(den > 1e-6, num / den.clamp_min(1e-6),
                                     torch.zeros_like(num))}
    del num, den
    if d > 256:
        lo, hi = _fwd_spans(d, q.dtype)[-1]
        c = 64 * ((d - 1) // 64)
        p = torch.softmax(_masked_scores(q[..., :c], kf[..., :c], causal,
                                         window, 1.0 / d ** 0.5), dim=-1)
        x = got.float().clone()
        x[..., lo:hi] = torch.einsum("bhqk,bkhd->bqhd", p,
                                     vf[..., lo:hi].float())
        bad["span_scores"] = x
        del p
    w = want.float()
    return {name: dict(row_err=_row_err(x, want),
                       max_err=float((x - w).abs().max()))
            for name, x in bad.items()}


def _sdpa_inputs(q, k, v, causal, window):
    """(q, k, v, kwargs) for scaled_dot_product_attention in its (B, H, S,
    D) layout: is_causal and GQA where there is no window; with a window an
    explicit boolean mask and K/V repeated to q's heads beforehand (outside
    any timed call), since masked calls may not take GQA."""
    from tpunet_torch.ops.flash_attention import _keep

    if window is None:
        kw = dict(is_causal=causal, enable_gqa=True)
    else:
        group = q.shape[2] // k.shape[2]
        k, v = (x.repeat_interleave(group, dim=2) for x in (k, v))
        kw = dict(attn_mask=_keep(q.shape[1], k.shape[1], causal, window,
                                  q.device))
    return (*(x.transpose(1, 2) for x in (q, k, v)), kw)


SDPA_OPS = (("_cudnn_attention", "cudnn"), ("_flash_attention", "flash"),
            ("_efficient_attention", "efficient"), ("_math", "math"))


def _sdpa_backend(fn) -> str:
    """The backend scaled_dot_product_attention picked for fn's call, by the
    name of the ATen op that the profiler saw on the host."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = [e.key for e in prof.key_averages()]
    for op, backend in SDPA_OPS:
        if any(op in n for n in names):
            return backend
    return "unknown"


def _library(q, k, v, causal, window, do=None) -> dict:
    """scaled_dot_product_attention on the same inputs: the forward's time
    or, given the cotangent do, its backward's alone (dQ, dK and dV
    together), and the backend it ran. A call SDPA refuses (its own limits,
    e.g. on the batch) gives library_ms None and the reason."""
    import torch.nn.functional as F

    qt, kt, vt, kw = _sdpa_inputs(q, k, v, causal, window)
    try:
        if do is None:
            def call():
                return F.scaled_dot_product_attention(qt, kt, vt, **kw)
            backend = _sdpa_backend(call)
            return dict(library_ms=cuda_ms(call), library_backend=backend)
        qt, kt, vt = (x.detach().requires_grad_() for x in (qt, kt, vt))
        backend = _sdpa_backend(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw))
        out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
        dot = do.transpose(1, 2)
        return dict(library_ms=cuda_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True)),
            library_backend=backend)
    except RuntimeError as e:
        return dict(library_ms=None, library_backend=None,
                    library_error=str(e).splitlines()[0][:200])


def _qkv(gen, b, sq, sk, h, hk, d, dt, n_q=1):
    """Random q (and n_q - 1 more q-shaped tensors), k, v on the card."""
    qs = [torch.randn((b, sq, h, d), generator=gen, device=DEVICE).to(dt)
          for _ in range(n_q)]
    k = torch.randn((b, sk, hk, d), generator=gen, device=DEVICE).to(dt)
    v = torch.randn((b, sk, hk, d), generator=gen, device=DEVICE).to(dt)
    return (*qs, k, v)


def _misaligned(x):
    """x's values in a view TMA cannot read as it is: sliced from a buffer
    with 3 more elements in each row, at an odd element offset."""
    b, s, h, d = x.shape
    buf = torch.zeros((b, s, h, d + 3), dtype=x.dtype, device=x.device)
    view = buf[..., 1:d + 1]
    view.copy_(x)
    return view


def _case(b, sq, sk, h, hk, causal, window, dt) -> dict:
    return dict(b=b, sq=sq, sk=sk, h=h, hk=hk, causal=causal, window=window,
                dtype=str(dt).replace("torch.", ""))


def _fwd_row(q, k, v, causal, window, d, layout="contiguous") -> dict:
    """flash_fwd against its plain version on one input: errors, row error,
    determinism, input copies, times, bound and SDPA's time and backend."""
    from tpunet_torch.ops.flash_attention import (flash_attention,
                                                  flash_attention_fwd,
                                                  flash_attention_plain)

    b, sq, h, _ = q.shape
    sk, hk, dt = k.shape[1], k.shape[2], q.dtype
    copies = flash_attention.input_copies
    o, lse = flash_attention_fwd(q, k, v, causal, window)
    copies = flash_attention.input_copies - copies
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal, window)
    again = flash_attention_fwd(q, k, v, causal, window)
    torch.cuda.synchronize()
    deterministic = torch.equal(o, again[0]) and torch.equal(lse, again[1])
    err_o = float((o.float() - o_ref.float()).abs().max())
    err_lse = float((lse - lse_ref).abs().max())
    row_err = _row_err(o, o_ref)
    finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
    # The row check must see these faults, or it proves nothing.
    planted = _planted_fwd_faults(q, k, v, causal, window, o, o_ref)
    ok = (err_o <= TOL[dt] and err_lse <= TOL[dt]
          and row_err <= ROW_TOL[dt] and deterministic and finite
          and all(x["row_err"] > ROW_TOL[dt] for x in planted.values()))
    work = _attention_work("flash_fwd", b, sq, sk, h, hk, d, causal, window,
                           dt)
    row = dict(kernel="flash_fwd",
               **_case(b, sq, sk, h, hk, causal, window, dt),
               d=d, layout=layout, err_o=err_o, err_lse=err_lse,
               tol=TOL[dt], row_err=row_err, row_tol=ROW_TOL[dt],
               planted_fault_row_err=planted,
               deterministic=deterministic, finite=finite,
               input_copies=copies, ok=ok,
               ms=cuda_ms(lambda: flash_attention_fwd(q, k, v, causal,
                                                      window)),
               plain_ms=cuda_ms(lambda: flash_attention_plain(
                   q, k, v, causal, window)),
               **_bound(*work, dt), **_library(q, k, v, causal, window))
    row["tflops"] = work[0] / row["ms"] / 1e9
    log("kernels", **row)
    return row


def _entry(kernel: str, dt, d: int) -> str:
    """The kernels-line entry a row of `kernel` at dtype dt, head dim d
    reports under: the kernel itself (bf16/f16 to head dim 256), its f32
    or its wide (above 256) route."""
    return kernel + ("_wide" if d > 256 else "_f32" if dt == F32 else "")


def phase_kernels(seed: int) -> dict:
    """flash_fwd's rows; returns {entry: the first row of that entry}, the
    training shape's for flash_fwd."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    rows, first = [], {}
    for b, sq, sk, h, hk, causal, window, dt, d in _kernel_cases(
            FWD_CASES, forward=True):
        q, k, v = _qkv(gen, b, sq, sk, h, hk, d, dt)
        rows.append(_fwd_row(q, k, v, causal, window, d))
        first.setdefault(_entry("flash_fwd", dt, d), rows[-1])
        del q, k, v
    b, sq, sk, hk, causal, window, d = MISALIGNED_CASE
    q, k, v = _qkv(gen, b, sq, sk, 16, hk, d, BF16)
    row = _fwd_row(_misaligned(q), k, v, causal, window, d, "misaligned q")
    row["ok"] &= row["input_copies"] == 1
    rows.append(row)
    del q, k, v
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_fwd disagrees with its plain version: "
                             f"{bad}")
    return first


def _bwd_rows(q, k, v, do, causal, window, d, layout="contiguous") -> list:
    """flash_dq's and flash_dkv's rows on one input: errors, row errors,
    the planted faults' readings, determinism, input copies, times, bounds
    and SDPA's backward time and backend."""
    from tpunet_torch.ops.flash_attention import (_launch_dkv, _launch_dq,
                                                  attention_delta,
                                                  flash_attention,
                                                  flash_attention_dkv_plain,
                                                  flash_attention_dq_plain,
                                                  flash_attention_fwd)

    b, sq, h, _ = q.shape
    sk, hk, dt = k.shape[1], k.shape[2], q.dtype
    launch = {"flash_dq": _launch_dq, "flash_dkv": _launch_dkv}
    plain = {"flash_dq": flash_attention_dq_plain,
             "flash_dkv": flash_attention_dkv_plain}
    # The check must see these faults, or it proves nothing.
    planters = {"flash_dq": _planted_dq_faults,
                "flash_dkv": _planted_dkv_faults}
    o, lse = flash_attention_fwd(q, k, v, causal, window)
    delta = attention_delta(o, do)
    args = (q, k, v, do, lse, delta, causal, window)
    got, copies = {}, {}
    for name in launch:
        before = flash_attention.input_copies
        out = launch[name](*args)
        copies[name] = flash_attention.input_copies - before
        got[name] = out if isinstance(out, tuple) else (out,)
    want = {"flash_dq": (flash_attention_dq_plain(*args),),
            "flash_dkv": flash_attention_dkv_plain(*args)}
    torch.cuda.synchronize()
    library = _library(q, k, v, causal, window, do)
    rows = []
    for name in ("flash_dq", "flash_dkv"):
        err, scale, row_err, tight = 0.0, 1.0, 0.0, 0.0
        for g, w in zip(got[name], want[name]):
            err = max(err, float((g.float() - w.float()).abs().max()))
            scale = max(scale, float(w.float().abs().max()))
            row_err = max(row_err, _row_err(g, w))
            # Reported, not held: the f32 floor shows the cancellation
            # noise of rows that are exactly 0 (ROW_FLOOR's note).
            tight = max(tight, _row_err(g, w, ROW_FLOOR[F32]))
        finite = all(bool(torch.isfinite(g).all()) for g in got[name])
        again = launch[name](*args)
        deterministic = all(torch.equal(x, y) for x, y in zip(
            got[name], again if isinstance(again, tuple) else (again,)))
        del again
        planted = planters[name](*args, got[name], want[name])
        ok = (err <= BWD_TOL[dt] * scale and row_err <= ROW_TOL[dt]
              and all(x["row_err"] > ROW_TOL[dt] for x in planted.values())
              and deterministic and finite)
        work = _attention_work(name, b, sq, sk, h, hk, d, causal, window, dt)
        row = dict(kernel=name,
                   **_case(b, sq, sk, h, hk, causal, window, dt),
                   d=d, layout=layout, max_abs_err=err, ref_scale=scale,
                   tol=BWD_TOL[dt] * scale, row_err=row_err,
                   row_tol=ROW_TOL[dt], row_err_f32_floor=tight,
                   planted_fault_row_err=planted, ok=ok,
                   deterministic=deterministic, finite=finite,
                   input_copies=copies[name],
                   ms=cuda_ms(lambda: launch[name](*args)),
                   plain_ms=cuda_ms(lambda: plain[name](*args)),
                   **_bound(*work, dt), **library)
        row["tflops"] = work[0] / row["ms"] / 1e9
        rows.append(row)
        log("kernels", **row)
    return rows


def phase_bwd_kernels(seed: int) -> dict:
    """flash_dq's and flash_dkv's rows; returns {entry: the first row of
    that entry}, the training shape's for flash_dq and flash_dkv."""
    from tpunet_torch.ops.flash_attention import (attention_delta,
                                                  flash_attention_fwd)

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 1)
    rows, main = [], {}
    for b, sq, sk, h, hk, causal, window, dt, d in _kernel_cases(BWD_CASES):
        q, do, k, v = _qkv(gen, b, sq, sk, h, hk, d, dt, n_q=2)
        if (b, sq, sk, hk, causal, window, dt, d) == BWD_CASES[0]:
            # delta = rowsum(dO * O) at the training shape, a plain
            # reduction
            o, _ = flash_attention_fwd(q, k, v, causal, window)
            item = q.element_size()
            log("delta", **_case(b, sq, sk, h, hk, causal, window, dt), d=d,
                ms=cuda_ms(lambda: attention_delta(o, do)),
                **_bound(2 * b * h * sq * d, 2 * b * sq * h * d * item
                         + b * h * sq * 4, torch.float32))
            del o
        for row in _bwd_rows(q, k, v, do, causal, window, d):
            rows.append(row)
            main.setdefault(_entry(row["kernel"], dt, d), row)
        del q, do, k, v
    b, sq, sk, hk, causal, window, d = MISALIGNED_CASE
    q, do, k, v = _qkv(gen, b, sq, sk, 16, hk, d, BF16, n_q=2)
    for row in _bwd_rows(_misaligned(q), k, v, do, causal, window, d,
                         "misaligned q"):
        row["ok"] &= row["input_copies"] == 1
        rows.append(row)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"a backward kernel disagrees with its plain "
                             f"version: {bad}")
    return main


def _prompts(seed: int, n: int, vocab: int):
    rng = np.random.default_rng(seed)
    lens = rng.choice(np.arange(128, 513), size=n, replace=False)
    if all(x % 64 == 0 for x in lens):
        lens[0] -= 1
    return [rng.integers(0, vocab, int(x)).astype(np.int32) for x in lens]


def phase_model(seed: int):
    from tpunet_torch.models import Transformer, init_params

    meta = Transformer(compute_dtype=torch.float32, device="meta",
                       **MODEL_735M)
    p32 = init_params(meta, seed=seed, device=DEVICE)
    n_params = sum(t.numel() for t in p32.values())
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, MODEL_735M["vocab"], (1, 512)), device=DEVICE)
    out = {}
    for dt, min_agree in ((torch.float32, 0.99), (torch.bfloat16, 0.9)):
        params = {k: (t if k.endswith(".scale") else t.to(dt))
                  for k, t in p32.items()}
        logits = {}
        for impl in ("flash", "reference"):
            m = Transformer(compute_dtype=dt, attn_impl=impl, device="meta",
                            **MODEL_735M).bind(params)
            with torch.no_grad():
                logits[impl] = m(tokens)
        err = float((logits["flash"] - logits["reference"]).abs().max())
        agree = float((logits["flash"].argmax(-1)
                       == logits["reference"].argmax(-1)).float().mean())
        finite = bool(torch.isfinite(logits["flash"]).all())
        scale = float(logits["reference"].abs().max())
        name = str(dt).replace("torch.", "")
        log("model", dtype=name, params=n_params, max_abs_logit_err=err,
            max_abs_logit=scale, argmax_agreement=agree, finite=finite)
        if not finite or agree < min_agree or (
                dt == torch.float32 and err > 1e-3):
            raise AssertionError(f"{name} flash forward disagrees with the "
                                 f"reference impl: err {err}, agreement "
                                 f"{agree}")
        out[name] = params
        del logits
    return out["bfloat16"]


def _serve_tier(model, params, prompts, max_new, kv_codec, count=None):
    """One frontend (this thread) + one decode rank (a thread) over
    loopback comms. `count` runs just before the first submit (the kernel
    counters are zeroed there) and just after the last result."""
    from tpunet_torch import serve

    lsock = serve.Router.listen("127.0.0.1:0")
    addr = "127.0.0.1:%d" % lsock.getsockname()[1]
    box = {}

    def decode_main():
        try:
            worker = serve.connect_decode(addr, model, params, slots=8,
                                          max_len=1024, kv_codec=kv_codec,
                                          device=DEVICE)
            try:
                worker.serve()
            finally:
                worker.close()
        except BaseException as e:  # noqa: BLE001 — surfaced below
            box["err"] = e

    th = threading.Thread(target=decode_main, daemon=True)
    th.start()
    pe = serve.PrefillEngine(model, params, max_len=1024, device=DEVICE)
    router = serve.Router(pe, kv_codec=kv_codec)
    try:
        router.accept_ranks(lsock, 1)
        lsock.close()
        if count:
            count("start")
        t0 = time.perf_counter()
        ids = [router.submit(p, max_new) for p in prompts]
        results = router.run(timeout=600)
        wall = time.perf_counter() - t0
        if count:
            count("stop")
    finally:
        router.shutdown()
        th.join(timeout=120)
        router.close()
    if "err" in box:
        raise box["err"]
    if th.is_alive():
        raise RuntimeError("decode worker did not exit")
    return [results[i] for i in ids], router, wall


def _serve_readmission(model, params, prompts, max_new):
    """The f32 tier with re-admission armed: the only decode rank serves
    one block and exits with requests in flight; a recovered rank on a new
    thread reconnects through the hello handshake and the router's probe
    re-admits it. Returns (tokens by submit order, router stats, readmit
    events counted over the run, wall seconds)."""
    from tpunet_torch import serve, telemetry

    lsock = serve.Router.listen("127.0.0.1:0")
    addr = "127.0.0.1:%d" % lsock.getsockname()[1]
    flaky_done = threading.Event()
    box = {}

    def decode_main(max_blocks):
        try:
            if max_blocks is None:
                flaky_done.wait(timeout=600)
            worker = serve.connect_decode(addr, model, params, slots=8,
                                          max_len=1024, kv_codec="f32",
                                          device=DEVICE)
            try:
                worker.serve(max_blocks=max_blocks)
            finally:
                worker.close()
        except BaseException as e:  # noqa: BLE001 — surfaced below
            box[max_blocks] = e
        finally:
            if max_blocks is not None:
                flaky_done.set()

    def readmits() -> float:
        m = telemetry.metrics().get("tpunet_churn_events_total", {})
        return sum(v for k, v in m.items()
                   if telemetry.labels(k).get("kind") == "readmit")

    before = readmits()
    flaky = threading.Thread(target=decode_main, args=(1,), daemon=True)
    flaky.start()
    pe = serve.PrefillEngine(model, params, max_len=1024, device=DEVICE)
    # Every request is admitted up front, also while no rank is alive.
    router = serve.Router(pe, kv_codec="f32", retain_kv=True,
                          queue_limit=len(prompts))
    recovered = threading.Thread(target=decode_main, args=(None,),
                                 daemon=True)
    try:
        router.accept_ranks(lsock, 1)
        router.enable_readmission(lsock)
        recovered.start()
        t0 = time.perf_counter()
        ids = [router.submit(p, max_new) for p in prompts]
        results = router.run(timeout=600)
        wall = time.perf_counter() - t0
    finally:
        router.shutdown()
        flaky.join(timeout=120)
        recovered.join(timeout=120)
        router.close()
        lsock.close()
    if box:
        raise next(iter(box.values()))
    if flaky.is_alive() or recovered.is_alive():
        raise RuntimeError("a decode worker did not exit")
    return ([results[i] for i in ids], dict(router.stats),
            readmits() - before, wall)


def _latency(router, ntok: int, wall: float) -> dict:
    """TTFT/TPOT medians from the router's per-request samples, the decode
    rate of the concurrent streams (sum over requests of 1/TPOT) and the
    end-to-end rate (tokens over the tier's wall time)."""
    ttft, tpot = router.samples["ttft"], router.samples["tpot"]
    return {"ttft_p50_ms": float(np.percentile(ttft, 50)) / 1e3,
            "tpot_p50_ms": float(np.percentile(tpot, 50)) / 1e3,
            "decode_tokens_per_s": float(sum(1e6 / t for t in tpot)),
            "tokens": ntok, "wall_s": wall, "tokens_per_s": ntok / wall}


def phase_serve(seed: int, params_bf16) -> int:
    from tpunet_torch import telemetry
    from tpunet_torch.models import BatchServer, Transformer
    from tpunet_torch.ops.flash_attention import flash_attention

    model = Transformer(compute_dtype=torch.bfloat16, attn_impl="flash",
                        device="meta", **MODEL_735M)
    prompts = _prompts(seed + 2, 8, model.vocab)
    max_new = 64
    # Single-host reference first (it also warms every shape the tier runs).
    srv = BatchServer(model, params_bf16, slots=8, max_len=1024,
                      device=DEVICE)
    sids = [srv.submit(p, max_new) for p in prompts]
    t0 = time.perf_counter()
    single = srv.run()
    single_wall = time.perf_counter() - t0
    single = [single[i] for i in sids]

    counts = {}

    def count(event):
        if event == "start":
            flash_attention.kernel_launches = 0
            flash_attention.input_copies = 0
        else:
            counts["flash_fwd"] = flash_attention.kernel_launches
            counts["input_copies"] = flash_attention.input_copies

    telemetry.reset()
    tier, router, wall = _serve_tier(model, params_bf16, prompts, max_new,
                                     "f32", count)
    same = all(np.array_equal(a, b) for a, b in zip(tier, single))
    ntok = sum(len(t) for t in tier)
    log("serve", kv_codec="f32", prompt_lens=[len(p) for p in prompts],
        max_new=max_new, bitwise_equal_single_host=same,
        flash_fwd_launches=counts["flash_fwd"],
        input_copies=counts["input_copies"],
        **_latency(router, ntok, wall), single_host_wall_s=single_wall,
        single_host_tokens_per_s=ntok / single_wall, router=router.stats)
    if not same or any(len(t) != max_new for t in tier):
        raise AssertionError("f32-wire tier tokens differ from the "
                             "single-host BatchServer's")
    if counts["flash_fwd"] <= 0:
        raise AssertionError("the serving path never launched flash_fwd")
    if counts["input_copies"] != 0:
        raise AssertionError(f"the serving path copied "
                             f"{counts['input_copies']} flash inputs")

    telemetry.reset()
    tier8, router8, wall8 = _serve_tier(model, params_bf16, prompts, max_new,
                                        "int8")
    m = telemetry.metrics()
    ratio = next(iter(m["tpunet_codec_wire_ratio"].values()))
    agree = float(np.mean([np.mean(a == b) for a, b in zip(tier8, single)]))
    log("serve", kv_codec="int8", codec_wire_ratio=ratio,
        token_agreement_with_f32=agree,
        **_latency(router8, sum(len(t) for t in tier8), wall8))
    if abs(ratio - 0.25390625) > 1e-6 or any(len(t) != max_new
                                             for t in tier8):
        raise AssertionError(f"int8 tier: wire ratio {ratio}")

    readmit, stats, events, wall_r = _serve_readmission(
        model, params_bf16, prompts, max_new)
    same = all(np.array_equal(a, b) for a, b in zip(readmit, single))
    log("serve", kv_codec="f32", readmission=True,
        bitwise_equal_single_host=same, readmit_events=events,
        wall_s=wall_r, router=stats)
    if not same or any(len(t) != max_new for t in readmit):
        raise AssertionError("re-admission tier tokens differ from the "
                             "single-host BatchServer's")
    if (stats["rank_failures"], stats["readmissions"], events) != (1, 1, 1):
        raise AssertionError(
            f"re-admission: rank_failures {stats['rank_failures']}, "
            f"readmissions {stats['readmissions']}, readmit events "
            f"{events} (want 1 each)")
    return counts["flash_fwd"]


# -- swap: live weight updates on the serving fleet --------------------------

# The weight broadcast's chunk and the whole-swap deadline, set in every
# process of the swap phase (documented user knobs; the defaults stay 1 MiB
# and 30 s). A chunk of 64 native 1 MiB pieces, broadcast one piece per
# call, is the case where a call of many pieces deadlocked on the QoS wire
# window armed below (tpunet_torch/serve/publish.py, _pieces). The deadline
# also covers the receivers' decode of the wire, their new server's build
# and warm-up request, and the frontend's engine build.
SWAP_CHUNK_BYTES = 64 << 20
SWAP_TIMEOUT_MS = 60_000
SWAP_MAX_NEW = 64
SWAP_ENV = {
    # The QoS gate armed as tests/swap_smoke.py arms it, so the bulk-class
    # weight bytes contend with the latency-class tier traffic.
    "TPUNET_QOS_INFLIGHT_BYTES": "wire=256K",
    "TPUNET_QOS_WEIGHTS": "latency=8,bulk=1",
    "TPUNET_SWAP_CHUNK_BYTES": str(SWAP_CHUNK_BYTES),
    "TPUNET_SWAP_TIMEOUT_MS": str(SWAP_TIMEOUT_MS),
    # A killed peer must surface typed in a blocked broadcast (the
    # survivor's receive pump included), not park a serve loop.
    "TPUNET_PROGRESS_TIMEOUT_MS": "10000",
    "TPUNET_KEEPALIVE_IDLE_S": "3", "TPUNET_KEEPALIVE_INTVL_S": "2",
    "TPUNET_KEEPALIVE_CNT": "2",
}
SWAP_PUBLISH_SPEC = "swap:at_step=1:action=publish;swap:at_step=2:action=publish"
SWAP_CORRUPT_SPEC = "swap:at_step=1:action=corrupt"


def _bf16_checkpoint(seed: int, cfg: dict | None = None) -> dict:
    """phase_model's bf16 parameters for `seed` (norm scales stay f32), of
    the configuration `cfg` (default MODEL_735M)."""
    from tpunet_torch.models import Transformer, init_params

    meta = Transformer(compute_dtype=torch.float32, device="meta",
                       **(cfg or MODEL_735M))
    p32 = init_params(meta, seed=seed, device=DEVICE)
    return {k: (t if k.endswith(".scale") else t.to(torch.bfloat16))
            for k, t in p32.items()}


def _wire_crc(params: dict) -> tuple[int, int]:
    """(bytes, CRC32C) of the bf16 publication wire of `params`."""
    from tpunet_torch import transport
    from tpunet_torch.serve import flatten_params

    wire = transport.codec_encode(flatten_params(params), "bf16")
    return int(wire.size), transport.crc32c(wire)


def _swap_child_env(spec: str | None) -> None:
    """The swap phase's knobs, set in a spawned process before its first
    engine (the QoS gate and the fault script are read there, once)."""
    os.environ.update(SWAP_ENV)
    os.environ.pop("TPUNET_FAULT_SPEC", None)
    if spec:
        os.environ["TPUNET_FAULT_SPEC"] = spec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _tag_flash_launches(counts: dict, tls) -> None:
    """Attribute this process's flash_fwd launches to a version: a launch
    on a serving thread counts for the version in `tls.version`; one on a
    build thread (tpunet-flip-vN, tpunet-prefill-vN) is that version's
    warm-up. The module counter still counts every launch."""
    fa = sys.modules["tpunet_torch.ops.flash_attention"]
    count = fa._count

    def tagged(name, n=1):
        count(name, n)
        if name != "kernel_launches":
            return
        thread = threading.current_thread().name
        m = re.match(r"tpunet-(?:flip|prefill)-v(\d+)$", thread)
        key = (f"warm_v{m.group(1)}" if m
               else f"v{getattr(tls, 'version', '?')}")
        counts[key] = counts.get(key, 0) + n

    fa._count = tagged


def _tagged(fn, tls, version_of):
    def call(*args, **kw):
        tls.version = version_of(*args, **kw)
        try:
            return fn(*args, **kw)
        finally:
            tls.version = "?"
    return call


def _swap_phase_metrics(m: dict) -> dict:
    """{phase: [count, seconds]} of tpunet_weight_swap_duration_us."""
    from tpunet_torch import telemetry

    out = {}
    for fam, i, scale in (("_count", 0, 1), ("_sum", 1, 1e-6)):
        for k, v in m.get("tpunet_weight_swap_duration_us" + fam,
                          {}).items():
            ph = telemetry.labels(k).get("phase")
            out.setdefault(ph, [0, 0.0])[i] = v * scale
    return out


def _swap_events(m: dict) -> dict:
    from tpunet_torch import telemetry

    return {telemetry.labels(k).get("kind"): int(v)
            for k, v in m.get("tpunet_swap_events_total", {}).items()}


def _quantiles(us: list) -> dict:
    if not us:
        return {"n": 0}
    return {"n": len(us), "p50_ms": float(np.percentile(us, 50)) / 1e3,
            "p99_ms": float(np.percentile(us, 99)) / 1e3}


def _class_p99_us(m: dict, cls: str) -> float | None:
    """p99 (upper bucket bound) of tpunet_qos_queue_wait_us for `cls`."""
    from tpunet_torch import telemetry

    by_le: dict = {}
    for k, v in m.get("tpunet_qos_queue_wait_us_bucket", {}).items():
        lab = telemetry.labels(k)
        if lab.get("class") != cls:
            continue
        le = lab["le"]
        le = float("inf") if le in ("+Inf", "Inf") else float(le)
        by_le[le] = by_le.get(le, 0) + int(v)
    if not by_le or max(by_le.values()) == 0:
        return None
    total = max(by_le.values())
    for le, c in sorted(by_le.items()):
        if c >= 0.99 * total:
            return le
    return None


def _swap_decode(name: str, seed: int, spec: str | None, weight_version: int,
                 cmd, q) -> None:
    """A spawned decode rank of the swap phase: v0 from `seed`, the
    frontend's address from `cmd`; serves until SHUTDOWN, then reports."""
    try:
        _swap_child_env(spec)
        from tpunet_torch import serve, telemetry
        from tpunet_torch.models import Transformer
        from tpunet_torch.ops.flash_attention import flash_attention
        from tpunet_torch.serve import publish

        model = Transformer(compute_dtype=torch.bfloat16, attn_impl="flash",
                            device="meta", **MODEL_735M)
        v0 = _bf16_checkpoint(seed)
        crc = _wire_crc(v0)
        addr = cmd.get(timeout=600)
        worker = serve.connect_decode(addr, model, v0, slots=8,
                                      max_len=1024, kv_codec="f32",
                                      weight_version=weight_version,
                                      device=DEVICE, timeout=300)
        # Per-version launches, and the serve loop's pass times (a pass
        # starts at _poll_chaos) while a swap is live on this rank.
        tls, launches = threading.local(), {}
        _tag_flash_launches(launches, tls)
        build = worker._build_server

        def build_tagged(version, params):
            srv = build(version, params)
            srv.step = _tagged(srv.step, tls, lambda: version)
            return srv

        worker._build_server = build_tagged
        for v, srv in worker._servers.items():
            srv.step = _tagged(srv.step, tls, lambda v=v: v)
        passes = {"t": None, "swap": False, "max_swap_s": 0.0,
                  "max_other_s": 0.0, "n_swap": 0}
        chaos = worker._poll_chaos

        def timed_chaos():
            now = time.perf_counter()
            live = worker._receiver is not None or worker._flip is not None
            if passes["t"] is not None:
                dt = now - passes["t"]
                key = ("max_swap_s" if passes["swap"] or live
                       else "max_other_s")
                passes[key] = max(passes[key], dt)
                passes["n_swap"] += passes["swap"] or live
            passes["t"], passes["swap"] = now, live
            chaos()

        worker._poll_chaos = timed_chaos
        q.put((name, "ready", {"pid": os.getpid(), "wire": crc}))
        flash_attention.kernel_launches = 0
        flash_attention.input_copies = 0
        t0 = time.perf_counter()
        worker.serve()
        wall = time.perf_counter() - t0
        m = telemetry.metrics()
        report = {
            "version": worker.version, "resident": sorted(worker._servers),
            "stats": dict(worker.stats),
            "weight_version_gauge": int(next(iter(
                m["tpunet_weight_version"].values()))),
            "swap_events": _swap_events(m),
            "swap_phases": _swap_phase_metrics(m),
            "swap_pending": publish.swap_pending(),
            "flash_fwd": flash_attention.kernel_launches,
            "flash_fwd_by_version": launches,
            "input_copies": flash_attention.input_copies,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "passes": {k: v for k, v in passes.items()
                       if k not in ("t", "swap")},
            "serve_s": wall, "wire": crc}
        worker.close()
        q.put((name, "OK", report))
    except BaseException:  # noqa: BLE001 — reported to the parent
        q.put((name, "FAIL", traceback.format_exc()))


def _swap_frontend(seed: int, cmd, q) -> None:
    """The spawned frontend of the swap phase: Router + PrefillEngine +
    WeightPublisher, the publications scheduled by the swap script."""
    try:
        _swap_child_env(None)
        from tpunet_torch import serve, telemetry, transport
        from tpunet_torch.models import Transformer
        from tpunet_torch.ops.flash_attention import flash_attention
        from tpunet_torch.serve import publish

        model = Transformer(compute_dtype=torch.bfloat16, attn_impl="flash",
                            device="meta", **MODEL_735M)
        ckpt = {v: _bf16_checkpoint(seed + v) for v in (0, 1, 2)}
        crcs = {v: _wire_crc(p) for v, p in ckpt.items()}
        lsock = serve.Router.listen("127.0.0.1:0")
        q.put(("F", "addr", "127.0.0.1:%d" % lsock.getsockname()[1]))
        pe = serve.PrefillEngine(model, ckpt[0], max_len=1024, device=DEVICE)
        router = serve.Router(pe, kv_codec="f32", policy="round_robin")
        router.accept_ranks(lsock, 2, timeout=600)
        router.enable_readmission(lsock)
        pids = cmd.get(timeout=600)
        pub = serve.WeightPublisher(router)
        transport.fault_inject(SWAP_PUBLISH_SPEC)
        prompts = _prompts(seed + 2, 8, model.vocab)
        # Warm both ranks and this engine (a short request each), so the
        # windows below time serving, not first calls.
        for p in prompts[:2]:
            router.submit(p[:16], 2)
        router.run(timeout=600)
        tls, launches = threading.local(), {}
        _tag_flash_launches(launches, tls)
        router._build_payload = _tagged(router._build_payload, tls,
                                        lambda rec: rec["version"])
        telemetry.reset()
        flash_attention.kernel_launches = 0
        flash_attention.input_copies = 0
        t_phase = time.perf_counter()
        windows, tokens = [], {}

        def first_frame_in() -> None:
            while not any(r["t_first"] for r in router._recs.values()):
                router.poll()
                time.sleep(0.001)

        def window(n: int, params, pump=None, first=True) -> dict:
            """Submit the prompts, publish `n` (once the first FIRST frame
            is in, with `first`), drain them; returns the window's
            record."""
            samples = router.samples["ttft"]
            n_start = len(samples)
            stats0, m0 = dict(pub.stats), telemetry.metrics()
            ids = [router.submit(p, SWAP_MAX_NEW) for p in prompts]
            pinned = {router._recs[i]["version"] for i in ids}
            if first:
                first_frame_in()
            action = publish.swap_action(n)
            if action != "publish":
                raise AssertionError(f"swap script step {n}: {action}")
            n_before, t0 = len(samples), time.perf_counter()
            pub.publish(n, params, pump=pump or router.poll,
                        warm_lengths=(128,))
            t_pub = time.perf_counter() - t0
            n_during = len(samples)
            res = router.run(timeout=600)
            tokens[f"w{n}_inflight"] = [res[i].tolist() for i in ids]
            m1 = telemetry.metrics()
            ph0, ph1 = _swap_phase_metrics(m0), _swap_phase_metrics(m1)
            phases = {k: [ph1[k][0] - ph0.get(k, [0, 0])[0],
                          ph1[k][1] - ph0.get(k, [0, 0])[1]] for k in ph1}
            nb, sb = phases.get("broadcast", [0, 0.0])
            ev0, ev1 = _swap_events(m0), _swap_events(m1)
            return {"version": n, "pinned": sorted(pinned),
                    "publish_s": t_pub,
                    "pub_stats": {k: pub.stats[k] - stats0[k]
                                  for k in pub.stats},
                    "events": {k: ev1.get(k, 0) - ev0.get(k, 0)
                               for k in ev1},
                    "phases_count_s": phases,
                    "broadcast_gb_per_s": (crcs[n][0] * nb / sb / 1e9
                                           if sb else None),
                    "ttft_before": _quantiles(samples[n_start:n_before]),
                    "ttft_during": _quantiles(samples[n_before:n_during]),
                    "n_during": n_during}

        # Window 1: v0 -> v1; rank A's corrupt latch refuses the first
        # attempt fleet-wide, the retry commits.
        w1 = window(1, ckpt[1])
        ids = [router.submit(p, SWAP_MAX_NEW) for p in prompts]
        w1["after_pinned"] = sorted({router._recs[i]["version"]
                                     for i in ids})
        res = router.run(timeout=600)
        tokens["w1_after"] = [res[i].tolist() for i in ids]
        w1["ttft_after"] = _quantiles(
            router.samples["ttft"][w1.pop("n_during"):])
        windows.append(w1)

        # Window 2: v1 -> v2; rank B SIGKILLed once the broadcast is in
        # flight (the parent respawns it stale, on v0).
        killed = {}

        def pump_kill() -> None:
            if not killed and pub.phase in ("broadcast", "verify"):
                os.kill(pids["B"], signal.SIGKILL)
                killed["phase"] = pub.phase
            router.poll()

        # Published as soon as the requests are in flight, so that B holds
        # some of them when it dies (its 64 tokens take about 2 s, as long
        # as the publisher's flatten and encode).
        w2 = window(2, ckpt[2], pump=pump_kill, first=False)
        w2["ttft_after"] = _quantiles(
            router.samples["ttft"][w2.pop("n_during"):])
        w2["killed_in_phase"] = killed.get("phase")
        t0 = time.perf_counter()
        deadline = t0 + 600
        while router.stats["readmissions"] < 1:
            if time.perf_counter() > deadline:
                raise TimeoutError("the respawned rank never rejoined")
            router.poll_admissions(raise_on_mismatch=False)
            router.poll()
            time.sleep(0.01)
        w2["wait_for_readmission_s"] = time.perf_counter() - t0
        stale = [sorted(r.versions) for r in router._ranks if r.alive]
        t0 = time.perf_counter()
        caught = pub.catch_up()
        w2["catch_up_s"] = time.perf_counter() - t0
        w2["caught_up"], w2["versions_before_catch_up"] = caught, stale
        w2["pub_stats_total"] = dict(pub.stats)
        windows.append(w2)

        # Window 3: v2 on both ranks (round robin).
        n0 = len(router.samples["ttft"])
        ids = [router.submit(p, SWAP_MAX_NEW) for p in prompts]
        pinned = sorted({router._recs[i]["version"] for i in ids})
        ranks = sorted({router._recs[i]["rank"] for i in ids})
        res = router.run(timeout=600)
        tokens["w3"] = [res[i].tolist() for i in ids]
        windows.append({"version": 2, "pinned": pinned, "ranks": ranks,
                        "ttft": _quantiles(router.samples["ttft"][n0:])})
        for _ in range(50):  # let the retire sweeps go out
            router.poll()
            time.sleep(0.002)
        m = telemetry.metrics()
        bulk_tx = sum(v for k, v in m.get("tpunet_qos_bytes_total",
                                          {}).items()
                      if telemetry.labels(k).get("class") == "bulk"
                      and telemetry.labels(k).get("dir") == "tx")
        report = {
            "wire": crcs, "windows": windows, "tokens": tokens,
            "router_version": router.version,
            "prefills": sorted(router._prefills),
            "rank_versions": [sorted(r.versions) for r in router._ranks
                              if r.alive],
            "router": dict(router.stats), "pub": dict(pub.stats),
            "swap_pending": publish.swap_pending(),
            "bulk_tx_bytes": bulk_tx,
            "latency_queue_wait_p99_us": _class_p99_us(m, "latency"),
            "flash_fwd": flash_attention.kernel_launches,
            "flash_fwd_by_version": launches,
            "input_copies": flash_attention.input_copies,
            "tpot_p50_ms": (float(np.percentile(router.samples["tpot"], 50))
                            / 1e3 if router.samples["tpot"] else None),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "wall_s": time.perf_counter() - t_phase}
        router.shutdown()
        q.put(("F", "OK", report))
        cmd.get(timeout=600)  # the ranks have reported: tear down
        transport.fault_clear()
        router.close()
        lsock.close()
    except BaseException:  # noqa: BLE001 — reported to the parent
        q.put(("F", "FAIL", traceback.format_exc()))


def phase_swap(seed: int, params_v0) -> None:
    """Live weight swap on a serving fleet of this card: frontend and two
    decode ranks in spawned processes; see the module docstring."""
    import multiprocessing as mp

    from tpunet_torch.models import BatchServer, Transformer
    from tpunet_torch.serve import publish, roundtrip_params

    t_phase = time.perf_counter()
    model = Transformer(compute_dtype=torch.bfloat16, attn_impl="flash",
                        device="meta", **MODEL_735M)
    prompts = _prompts(seed + 2, 8, model.vocab)
    ckpt = {0: params_v0, 1: _bf16_checkpoint(seed + 1),
            2: _bf16_checkpoint(seed + 2)}
    n_params = sum(t.numel() for t in params_v0.values())
    refs, wires = {}, {}
    for v, p in ckpt.items():
        if v:  # what every rank holds after the wire: the identity on bf16
            rt = roundtrip_params(p, "bf16")
            if not all(torch.equal(rt[k], t) for k, t in p.items()):
                raise AssertionError(f"bf16 round trip of v{v} is not the "
                                     f"identity")
            del rt
        wires[v] = _wire_crc(p)
        srv = BatchServer(model, p, slots=8, max_len=1024, device=DEVICE)
        sids = [srv.submit(x, SWAP_MAX_NEW) for x in prompts]
        out = srv.run()
        refs[v] = [out[i].tolist() for i in sids]
        del srv
    if any(w[0] != 2 * n_params for w in wires.values()):
        raise AssertionError(f"wire bytes {wires} (want 2 x {n_params})")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    cmds = {n: ctx.Queue() for n in ("F", "A", "B", "B2")}
    procs = {"F": ctx.Process(target=_swap_frontend,
                              args=(seed, cmds["F"], q)),
             "A": ctx.Process(target=_swap_decode,
                              args=("A", seed, SWAP_CORRUPT_SPEC, 0,
                                    cmds["A"], q)),
             "B": ctx.Process(target=_swap_decode,
                              args=("B", seed, None, 0, cmds["B"], q))}
    for p in procs.values():
        p.start()
    got, ready, addr = {}, {}, None
    t_kill = t_b2_ready = None
    deadline = time.perf_counter() + 900
    try:
        while len(got) < 3:  # the reports of F, A and B2
            if time.perf_counter() > deadline:
                raise TimeoutError(f"swap phase: reports {sorted(got)}")
            if procs["B"].exitcode is not None and "B2" not in procs:
                # B died mid-broadcast: respawn it stale, on v0.
                t_kill = time.perf_counter()
                procs["B2"] = ctx.Process(
                    target=_swap_decode,
                    args=("B2", seed, None, 0, cmds["B2"], q))
                procs["B2"].start()
                cmds["B2"].put(addr)
            try:
                name, status, payload = q.get(timeout=0.2)
            except queue.Empty:
                dead = {n: p.exitcode for n, p in procs.items()
                        if n != "B" and n not in got
                        and p.exitcode is not None}
                if dead:
                    raise RuntimeError(f"swap processes exited {dead}")
                continue
            if status == "FAIL":
                raise RuntimeError(f"swap {name} failed:\n{payload}")
            if status == "addr":
                addr = payload
                cmds["A"].put(addr)
                cmds["B"].put(addr)
            elif status == "ready":
                ready[name] = payload
                if name == "B2":
                    t_b2_ready = time.perf_counter()
                elif "A" in ready and "B" in ready:
                    cmds["F"].put({n: ready[n]["pid"] for n in ("A", "B")})
            else:
                got[name] = payload
        cmds["F"].put("done")  # the ranks have reported: F may close
    finally:
        for p in procs.values():
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    f, a, b2 = got["F"], got["A"], got["B2"]
    wall = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 1e9
    # Tokens: each window's requests against the single host on the version
    # pinned at their admission.
    checks = {"w1_inflight": 0, "w1_after": 1, "w2_inflight": 1, "w3": 2}
    bitwise = {k: f["tokens"][k] == refs[v] for k, v in checks.items()}
    pinned = {"w1_inflight": f["windows"][0]["pinned"],
              "w1_after": f["windows"][0]["after_pinned"],
              "w2_inflight": f["windows"][1]["pinned"],
              "w3": f["windows"][2]["pinned"]}
    w1, w2 = f["windows"][0], f["windows"][1]
    log("swap", card=CARD, params=n_params, wire_bytes=wires[0][0],
        wire_crc32c={v: w[1] for v, w in wires.items()},
        chunk_bytes=SWAP_CHUNK_BYTES, timeout_ms=SWAP_TIMEOUT_MS,
        bitwise_equal_single_host=bitwise, pinned_versions=pinned,
        windows=f["windows"], frontend={
            k: f[k] for k in ("router_version", "prefills", "rank_versions",
                              "router", "pub", "swap_pending",
                              "bulk_tx_bytes", "latency_queue_wait_p99_us",
                              "flash_fwd", "flash_fwd_by_version",
                              "input_copies", "tpot_p50_ms", "peak_mem_gb",
                              "wall_s")},
        decode={"A": a, "B2": b2}, victim_exitcode=procs["B"].exitcode,
        respawn_to_ready_s=(t_b2_ready - t_kill) if t_b2_ready else None,
        parent_peak_mem_gb=peak, phase_wall_s=wall)
    errors = []
    if not all(bitwise.values()):
        errors.append(f"tokens differ from the single host's: {bitwise}")
    if pinned != {"w1_inflight": [0], "w1_after": [1], "w2_inflight": [1],
                  "w3": [2]}:
        errors.append(f"pinned versions {pinned}")
    if f["wire"] != wires:
        errors.append(f"frontend checkpoints {f['wire']} != {wires}")
    for n, r in (("A", a), ("B2", b2)):
        if tuple(r["wire"]) != wires[0]:
            errors.append(f"rank {n}'s v0 {r['wire']} != {wires[0]}")
    s1 = w1["pub_stats"]
    if (s1["aborts"], s1["retries"], s1["commits"]) != (1, 1, 1) or (
            w1["events"].get("mismatch", 0) < 1):
        errors.append(f"window 1: {s1}, events {w1['events']}")
    s2 = w2["pub_stats"]
    if s2["retries"] < 1 or s2["commits"] != 1 or f["pub"]["catch_ups"] != 1:
        errors.append(f"window 2: {s2}, catch-ups {f['pub']['catch_ups']}")
    if (f["router"]["rank_failures"], f["router"]["readmissions"]) != (1, 1):
        errors.append(f"router {f['router']}")
    if procs["B"].exitcode != -signal.SIGKILL:
        errors.append(f"rank B exited {procs['B'].exitcode}, not SIGKILL")
    if len(f["windows"][2]["ranks"]) != 2 or 2 not in f["windows"][2][
            "ranks"]:  # the respawned rank is the router's third
        errors.append(f"window 3 placed on ranks {f['windows'][2]['ranks']}")
    if f["router_version"] != 2 or f["prefills"] != [2]:
        errors.append(f"frontend at v{f['router_version']}, engines "
                      f"{f['prefills']}")
    for n, r in (("A", a), ("B2", b2)):
        if (r["version"], r["resident"], r["weight_version_gauge"]) != (
                2, [2], 2):
            errors.append(f"rank {n}: version {r['version']}, resident "
                          f"{r['resident']}, gauge "
                          f"{r['weight_version_gauge']}")
        if r["input_copies"] != 0:
            errors.append(f"rank {n} copied {r['input_copies']} flash "
                          f"inputs")
        if r["stats"]["results"] <= 0:
            errors.append(f"rank {n} served nothing")
    # flash_fwd runs in the prefills, all on the frontend: a decode rank
    # adopts shipped KV and its cached steps take the dense einsum branch
    # (as in the JAX model), so it launches none. Every version's engine
    # and both new engines' warm-ups must have launched it.
    by_ver = f["flash_fwd_by_version"]
    if (any(by_ver.get(k, 0) <= 0 for k in ("v0", "v1", "v2", "warm_v1",
                                             "warm_v2"))
            or f["flash_fwd"] != sum(by_ver.values())
            or f["input_copies"] != 0):
        errors.append(f"frontend: flash_fwd {f['flash_fwd']} "
                      f"({by_ver}), copies {f['input_copies']}")
    pending = {"F": f["swap_pending"], "A": a["swap_pending"],
               "B2": b2["swap_pending"], "parent": publish.swap_pending()}
    if any(pending.values()):
        errors.append(f"swap events pending {pending}")
    if f["bulk_tx_bytes"] < wires[0][0]:
        errors.append(f"bulk class moved {f['bulk_tx_bytes']} B, under the "
                      f"wire's {wires[0][0]}")
    if errors:
        raise AssertionError("swap phase: " + "; ".join(errors))



# -- spec: speculative serving -----------------------------------------------

# benchmarks/chip_session.py's decode_spec (:85-89; the target at the train
# widths, MHA, a random draft of the same widths at 2 layers) and
# decode_window (:81-84; window 256), decode_bench.py --spec-draft quant
# (:142-154; the target's int8 self-draft), serve_bench.py --spec-gamma 4
# (:112-118; an int8 self-draft BatchServer on the serve phase's model).
# SPEC_NEW is cut from decode_spec's 256 to 64 for the whole script's
# time.
SPEC_BATCH, SPEC_PROMPT, SPEC_NEW, SPEC_GAMMA = 8, 512, 64, 4
SPEC_DRAFT_LAYERS, SPEC_WINDOW = 2, 256
SPEC_SAMPLING = dict(temperature=0.8, top_k=50)
SPEC_SERVE_NEW, SPEC_SERVE_MAX_LEN = 64, 1024


def _spec_model() -> dict:
    """(a)-(c)'s target: the training configuration's widths at half its
    depth (6 of 12 layers). Its decode steps are host-bound, and the
    whole script shares one time limit."""
    return dict(MODEL_TRAIN, n_layers=MODEL_TRAIN["n_layers"] // 2)


# The 735,102,976 params of MODEL_TRAIN less 6 of its 12 layers of
# 50,335,744 (attention 4 x 2048^2, the MLP 2 x 2048 x 8192, two norms).
SPEC_TARGET_PARAMS = 735_102_976 - 6 * 50_335_744


def _spec_run(fn):
    """Run fn with the flash counters zeroed just before and read just
    after; also record the window of every flash_fwd launch and the KV
    leaves of every decode cache allocated inside. Returns (fn's result,
    {"flash_fwd", "input_copies", "windows", "caches", "s"})."""
    from tpunet_torch.ops.flash_attention import flash_attention

    # The modules (the packages re-export functions of the same names).
    gen = importlib.import_module("tpunet_torch.models.generate")
    fa = importlib.import_module("tpunet_torch.ops.flash_attention")
    launch, alloc = fa._launch_fwd, gen.init_cache
    windows, caches = [], []

    def rec_launch(q, k, v, causal, window, scale):
        windows.append(window)
        return launch(q, k, v, causal, window, scale=scale)

    def rec_alloc(*args, **kw):
        cache = alloc(*args, **kw)
        kv = [t for name, t in cache.items()
              if not name.endswith("cache_index")]
        caches.append({"kv_len": kv[0].shape[1], "bytes": sum(
            t.numel() * t.element_size() for t in kv)})
        return cache

    fa._launch_fwd, gen.init_cache = rec_launch, rec_alloc
    flash_attention.kernel_launches = 0
    flash_attention.input_copies = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        fa._launch_fwd, gen.init_cache = launch, alloc
    return out, {"flash_fwd": flash_attention.kernel_launches,
                 "input_copies": flash_attention.input_copies,
                 "windows": sorted({w or 0 for w in windows}),
                 "caches": caches, "s": time.perf_counter() - t0}


def _first_divergence(ref, got, plens) -> dict:
    """{row: first column past its prompt where two (b, L) token arrays
    differ}."""
    out = {}
    for r in range(ref.shape[0]):
        d = np.nonzero(ref[r, plens[r]:] != got[r, plens[r]:])[0]
        if d.size:
            out[r] = int(plens[r]) + int(d[0])
    return out


class _Teacher:
    """One decode path fed given tokens: `model` with a cache of capacity
    `cap` (per row or lockstep) that holds each row's prompt, prefilled
    as the path under test prefills (the rows of one prompt length
    together); `first` holds the prefills' last logits (b, vocab). Step k
    feeds each row's column plens + k."""

    @torch.no_grad()
    def __init__(self, model, params, seqs, plens, cap, per_row, gamma):
        from tpunet_torch.models import init_cache
        from tpunet_torch.models.generate import _prefill, _set_cache_index

        self.net = model.bind(params)
        seqs = torch.as_tensor(seqs, device=DEVICE)
        # Blocks near the end read past it; causal rows never look there.
        self.seqs = torch.cat([seqs, seqs[:, -1:].expand(-1, gamma + 1)], 1)
        self.plens = torch.as_tensor(plens, device=DEVICE)
        self.cache = init_cache(model, seqs.shape[0], cap, per_row=per_row,
                                device=DEVICE)
        self.first = None
        for plen in sorted(set(int(x) for x in plens)):
            if not per_row:  # lockstep: one prompt length, every row
                self.cache, last = _prefill(self.net, self.cache,
                                            self.seqs[:, :plen], None)
                self.first = last.float()
                continue
            rows = torch.nonzero(self.plens == plen)[:, 0]
            row = _set_cache_index({k: v[rows] for k, v in
                                    self.cache.items()}, 0)
            row, last = _prefill(self.net, row, self.seqs[rows, :plen], None)
            if self.first is None:
                self.first = last.new_zeros((seqs.shape[0], last.shape[-1]),
                                            dtype=torch.float32)
            self.first[rows] = last.float()
            for k, v in self.cache.items():
                v[rows] = row[k]

    def _cols(self, k: int, width: int):
        idx = self.plens[:, None] + k + torch.arange(width, device=DEVICE)
        return torch.gather(self.seqs, 1, idx)

    def step(self, k: int):
        """Feed column plens + k; the logits predicting the next one."""
        return self.net(self._cols(k, 1), cache=self.cache)[:, -1].float()

    def block(self, k: int, width: int):
        """(b, width, vocab) logits of a verify block over columns
        plens + k .., on a copy of the cache (before step k)."""
        blk = {name: t.clone() for name, t in self.cache.items()}
        return self.net(self._cols(k, width), cache=blk).float()


@torch.no_grad()
def _tie_gaps(ref_path, alt_path, cols: dict, plens, gamma) -> dict:
    """The tie rule, fixed before the phase's first run. For each row r
    whose tokens first differ at column c = cols[r]: gap, the reference
    path's top-2 logit gap at the position predicting c (its one-token
    step, or its prefill for the first generated column), and delta, the
    largest |logit difference| there between the reference and the path
    under test on the same prefix, each with its own cache (capacity, row
    mode): the latter's (b, gamma + 1) verify block at every alignment
    that holds position c - 1, or, with gamma None, its one-token step. A
    divergence is a tie when gap <= delta. The two halves (`_alt_logits`,
    `_ref_gaps`) may run in different processes."""
    return _ref_gaps(ref_path, cols, plens,
                     _alt_logits(alt_path, cols, plens, gamma))


@torch.no_grad()
def _alt_logits(alt_path, cols: dict, plens, gamma) -> dict:
    """The path under test's half of `_tie_gaps`: {row: [logit rows]} at
    the position predicting each row's first differing column."""
    due = {r: c - 1 - int(plens[r]) for r, c in cols.items()}
    seen = {r: [alt_path.first[r]] if d < 0 else [] for r, d in due.items()}
    due = {r: d for r, d in due.items() if d >= 0}
    for k in range(max(due.values(), default=-1) + 1):
        if gamma is not None:
            js = {r: d - k for r, d in due.items() if 0 <= d - k <= gamma}
            if js:
                blk = alt_path.block(k, gamma + 1)
                for r, j in js.items():
                    seen[r].append(blk[r, j])
        other = alt_path.step(k)
        for r in (r for r, d in due.items() if d == k and gamma is None):
            seen[r].append(other[r])
    return seen


@torch.no_grad()
def _ref_gaps(ref_path, cols: dict, plens, seen: dict) -> dict:
    """The reference's half of `_tie_gaps`: {row: (gap, delta)} against
    the path under test's logit rows `seen` (`_alt_logits`)."""
    due = {r: c - 1 - int(plens[r]) for r, c in cols.items()}

    def gap_delta(step, xs):
        top2 = torch.topk(step, 2).values
        return (float(top2[0] - top2[1]),
                max(float((torch.as_tensor(x, device=step.device)
                           - step).abs().max()) for x in xs))

    out = {r: gap_delta(ref_path.first[r], seen[r])
           for r, d in due.items() if d < 0}
    due = {r: d for r, d in due.items() if d >= 0}
    for k in range(max(due.values(), default=-1) + 1):
        step = ref_path.step(k)
        for r in (r for r, d in due.items() if d == k):
            out[r] = gap_delta(step[r], seen[r])
    return out


def _held(name, ref, got, plens, gamma, ref_path, alt_path,
          errors) -> dict:
    """Greedy tokens `got` against the reference's `ref` ((b, L) numpy):
    bitwise, or diverging only at ties (`_tie_gaps`; the paths are built
    only when a row diverges). Any other divergence goes to `errors`."""
    cols = _first_divergence(ref, got, plens)
    gaps = _tie_gaps(ref_path(), alt_path(), cols, plens, gamma) if cols \
        else {}
    rep = {"rows_bitwise_equal": ref.shape[0] - len(cols),
           "divergences": [{"row": r, "col": c, "gap": gaps[r][0],
                            "delta": gaps[r][1]}
                           for r, c in sorted(cols.items())]}
    bad = [d for d in rep["divergences"] if not d["gap"] <= d["delta"]]
    if bad:
        errors.append(f"{name}: divergences that are no tie (gap > delta): "
                      f"{bad}")
    return rep


def phase_spec(seed: int, params_serve) -> None:
    from tpunet_torch.models import (BatchServer, Transformer, generate,
                                     init_params, quantize_params,
                                     speculative_generate)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    b, p, new, g = SPEC_BATCH, SPEC_PROMPT, SPEC_NEW, SPEC_GAMMA
    length = p + new  # generate's cache capacity; speculation adds g + 1
    meta = Transformer(compute_dtype=BF16, attn_impl="flash", device="meta",
                       **_spec_model())
    params = init_params(meta, seed=seed + 3, device=DEVICE, dtype=BF16)
    n_params = sum(t.numel() for t in params.values())
    draft = meta.clone(n_layers=SPEC_DRAFT_LAYERS)
    dparams = init_params(draft, seed=seed + 4, device=DEVICE, dtype=BF16)
    qdraft = meta.clone(weight_quant="int8")
    qparams = quantize_params(params)
    vocab, layers = meta.vocab, meta.n_layers
    prompt = torch.as_tensor(np.random.default_rng(seed + 5).integers(
        0, vocab, (b, p)), dtype=torch.int32, device=DEVICE)
    plens = np.full(b, p)
    errors = []

    def check(name, counts, launches, window=None):
        want = {window or 0}
        if (counts["flash_fwd"] != launches or counts["input_copies"]
                or set(counts["windows"]) != want):
            errors.append(f"{name}: flash_fwd {counts['flash_fwd']} (want "
                          f"{launches}), copies {counts['input_copies']}, "
                          f"windows {counts['windows']} (want {want})")

    def teacher(model, prm, seqs, cap, per_row):
        return lambda: _Teacher(model, prm, seqs, plens, cap, per_row, g)

    def spec(name, model, prm, dmodel, dprm, ref, per_row=True, **kw):
        (out, st), c = _spec_run(lambda: speculative_generate(
            model, prm, dmodel, dprm, prompt, new, gamma=g, per_row=per_row,
            return_stats=True, **kw))
        out = out.cpu().numpy()
        row = {"s": c["s"], "tokens_per_s": b * new / c["s"],
               "rounds": st["rounds"],
               "draft_accept_rate": st["draft_accept_rate"],
               "tokens_per_round": 1 + g * st["draft_accept_rate"],
               "flash_fwd": c["flash_fwd"], "windows": c["windows"],
               "caches": c["caches"]}
        check(name, c, model.n_layers + dmodel.n_layers, model.attn_window)
        if ref is not None:
            row.update(_held(name, ref, out, plens, g,
                             teacher(model, prm, ref, length, False),
                             teacher(model, prm, ref, length + g + 1,
                                     per_row), errors))
        log("spec", run=name, **row)
        return out, row

    def plain(name, model):
        out, c = _spec_run(lambda: generate(model, params, prompt, new))
        check(name, c, layers, model.attn_window)
        row = {"s": c["s"], "tokens_per_s": b * new / c["s"],
               "flash_fwd": c["flash_fwd"], "caches": c["caches"]}
        return out.cpu().numpy(), row

    # The reference: the port's generate on the same target and prompt.
    ref, row = plain("generate", meta)
    log("spec", run="generate", **row)
    # (a) the shallow random draft, lockstep and per row.
    spec("a_lockstep", meta, params, draft, dparams, ref, per_row=False)
    spec("a_per_row", meta, params, draft, dparams, ref)
    # (b) the int8 self-draft, greedy, then sampled twice from one seed.
    _, row = spec("b_int8", meta, params, qdraft, qparams, ref)
    if not row["draft_accept_rate"] > 0:
        errors.append(f"b_int8: {row['tokens_per_round']} tokens a round")
    sampled = [spec(f"b_sampled_{i}", meta, params, qdraft, qparams, None,
                    generator=torch.Generator(device=DEVICE).manual_seed(
                        seed), **SPEC_SAMPLING)[0] for i in range(2)]
    if not np.array_equal(sampled[0], sampled[1]):
        errors.append("b_sampled: two runs from one seed differ")
    if not ((sampled[0] >= 0) & (sampled[0] < vocab)).all():
        errors.append("b_sampled: a token outside [0, vocab)")
    # (c) window 256 on the ring: generate against the masked cache, then
    # speculation on the ring with the int8 self-draft.
    wmeta = meta.clone(attn_window=SPEC_WINDOW)
    masked = wmeta.clone(decode_ring_cache=False)
    wref, ring_row = plain("c_generate_ring", wmeta)
    log("spec", run="c_generate_ring", **ring_row)
    mref, row = plain("c_generate_masked", masked)
    row.update(_held("c_generate_masked", wref, mref, plens, None,
                     teacher(wmeta, params, wref, length, False),
                     teacher(masked, params, wref, length, False), errors))
    log("spec", run="c_generate_masked", **row)
    _, row = spec("c_int8_ring", wmeta, params,
                  qdraft.clone(attn_window=SPEC_WINDOW), qparams, wref)
    lens = {x["kv_len"] for x in ring_row["caches"] + row["caches"]}
    if lens != {min(SPEC_WINDOW, length)}:
        errors.append(f"c: ring leaves of {lens}, want {SPEC_WINDOW}")
    if not row["draft_accept_rate"] > 0:
        errors.append(f"c_int8_ring: {row['tokens_per_round']} tokens a "
                      f"round")
    del qparams, dparams, params, sampled, mref
    torch.cuda.empty_cache()
    # (d) speculative continuous batching on the serve phase's model.
    smodel = Transformer(compute_dtype=BF16, attn_impl="flash",
                         device="meta", **MODEL_735M)
    prompts = _prompts(seed + 2, 8, smodel.vocab)
    qlens = np.array([len(q) for q in prompts])

    def serve(**kw):
        srv = BatchServer(smodel, params_serve, slots=8,
                          max_len=SPEC_SERVE_MAX_LEN, device=DEVICE, **kw)
        ids = [srv.submit(q, SPEC_SERVE_NEW) for q in prompts]
        res = srv.run()
        return [res[i] for i in ids], srv.stats

    def seqs(outs):  # prompt + tokens per request, zero-padded
        arr = np.zeros((len(prompts), max(qlens) + SPEC_SERVE_NEW), np.int32)
        for i, (q, t) in enumerate(zip(prompts, outs)):
            arr[i, :len(q) + len(t)] = np.concatenate([q, t])
        return arr

    (base, _), cp = _spec_run(serve)
    sq = quantize_params(params_serve)
    (got, st), c = _spec_run(lambda: serve(
        draft_model=smodel.clone(weight_quant="int8"), draft_params=sq,
        gamma=g))
    check("d_server", c, len(set(qlens)) * 2 * smodel.n_layers)
    ntok = sum(len(t) for t in got)
    per_round = st["spec_committed"] / max(st["spec_rounds"], 1)
    row = {"s": c["s"], "tokens_per_s": ntok / c["s"], "plain_s": cp["s"],
           "plain_tokens_per_s": ntok / cp["s"], "stats": st,
           "tokens_per_round": per_round, "flash_fwd": c["flash_fwd"],
           "plain_flash_fwd": cp["flash_fwd"]}
    ref_d = seqs(base)
    row.update(_held("d_server", ref_d, seqs(got), qlens, g,
                     lambda: _Teacher(smodel, params_serve, ref_d, qlens,
                                      SPEC_SERVE_MAX_LEN, True, g),
                     lambda: _Teacher(smodel, params_serve, ref_d, qlens,
                                      SPEC_SERVE_MAX_LEN + g + 1, True, g),
                     errors))
    log("spec", run="d_server", **row)
    if not per_round > 1 or any(len(t) != SPEC_SERVE_NEW for t in got):
        errors.append(f"d_server: {per_round} tokens a round, lengths "
                      f"{[len(t) for t in got]}")
    del sq
    log("spec", params=n_params, draft_layers=SPEC_DRAFT_LAYERS, batch=b,
        prompt=p, new=new, gamma=g, window=SPEC_WINDOW,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        wall_s=time.perf_counter() - t_phase, card=CARD)
    if n_params != SPEC_TARGET_PARAMS:
        errors.append(f"target has {n_params} params, want "
                      f"{SPEC_TARGET_PARAMS}")
    if errors:
        raise AssertionError("spec phase: " + "; ".join(errors))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ramp_data(seed: int) -> str:
    """A learnable token stream: ramps (t, t+1, ...) of random starts and
    lengths, packed into a flat file under build/ by pack_documents; about
    48 windows of TRAIN_SEQ + 1 tokens."""
    from tpunet_torch.data import pack_documents

    vocab = MODEL_TRAIN["vocab"]
    rng = np.random.default_rng(seed + 3)
    docs, total = [], 0
    while total < 48 * TRAIN_SEQ + 1:
        n = int(rng.integers(64, 1024))
        docs.append((int(rng.integers(0, vocab)) + np.arange(n)) % vocab)
        total += n
    path = Path(__file__).resolve().parent / "build" / "chip_smoke"
    path.mkdir(parents=True, exist_ok=True)
    path = str(path / "ramps.bin")
    pack_documents(iter(docs), path, vocab=vocab)
    return path


def _train_setup(seed: int, zero: bool = False, remat_policy=None):
    """(model, tx, state) of the headline training configuration; the f32
    master weights come from `seed`, identically in every process. zero:
    a ZeRO-1 state (create_zero_train_state; distributed initialized)."""
    from tpunet_torch.models import Transformer
    from tpunet_torch.train import (adamw, create_train_state,
                                    create_zero_train_state)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = Transformer(compute_dtype=torch.bfloat16, attn_impl="flash",
                        remat=True, remat_policy=remat_policy, device="meta",
                        **MODEL_TRAIN)
    tx = adamw(TRAIN_LR)
    create = create_zero_train_state if zero else create_train_state
    state, _ = create(model, seed, None, tx, device=DEVICE)
    return model, tx, state


def _opt_state_bytes(opt) -> int:
    """Bytes of the optimizer's per-parameter state tensors (AdamW's two
    moments), its step counts left out."""
    return sum(v.numel() * v.element_size() for st in opt.state.values()
               for k, v in st.items()
               if k != "step" and isinstance(v, torch.Tensor))


def _zero_counters() -> None:
    from tpunet_torch.ops.flash_attention import flash_attention

    for attr in (*COUNTERS.values(), "input_copies"):
        setattr(flash_attention, attr, 0)


def _read_counters() -> tuple[dict, int]:
    """({kernel: launches}, input_copies) since _zero_counters."""
    from tpunet_torch.ops.flash_attention import flash_attention

    return ({n: getattr(flash_attention, a) for n, a in COUNTERS.items()},
            flash_attention.input_copies)


def _fit_measured(state, step, batches, steps: int = TRAIN_STEPS):
    """fit() for `steps` steps with every kernel counter, the DCN stats
    and the peak-memory mark reset just before it; returns (state,
    measurements)."""
    from tpunet_torch import interop
    from tpunet_torch.train import fit

    logs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    interop.dcn_reduce_stats_reset()
    _zero_counters()
    t0 = time.perf_counter()
    state = fit(state, step, batches, steps=steps, log_every=1,
                log_fn=logs.append, prefetch=2, prefetch_device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, copies = _read_counters()
    return state, dict(
        params=sum(t.numel() for t in state.params.values()),
        losses=[m["loss"] for m in logs],
        step_s=[1.0 / m["steps_per_s"] for m in logs], fit_wall_s=wall,
        launches=launches, input_copies=copies,
        all_reduce=interop.dcn_reduce_stats(),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        opt_state_bytes=_opt_state_bytes(state.opt_state),
        crc=_params_crc(state.params))


def _params_crc(params: dict) -> int:
    """CRC32C of the flat f32 params, in state_dict order."""
    from tpunet_torch.transport import crc32c

    crc = 0
    for t in params.values():
        crc = crc32c(t.detach().contiguous().cpu().numpy(), crc)
    return crc


def _train_batches(path: str, rank: int, seed: int):
    from tpunet_torch.data import TokenDataset, token_batches

    ds = TokenDataset(path, seq=TRAIN_SEQ, vocab=MODEL_TRAIN["vocab"])
    return token_batches(ds, TRAIN_BATCH, rank=rank, world=TRAIN_RANKS,
                         seed=seed)


def _train_rank_body(rank: int, ports, path: str, seed: int) -> dict:
    from tpunet_torch import distributed, telemetry
    from tpunet_torch.train import make_train_step

    distributed.initialize(f"127.0.0.1:{ports[0]}", rank, TRAIN_RANKS)
    model, tx, state = _train_setup(seed)
    step = make_train_step(model, tx, cross_host=True)
    state, out = _fit_measured(state, step, _train_batches(path, rank, seed))
    out["rank"] = rank
    distributed.finalize()

    # One more step with bf16 on the wire: the trainer ships f32 and the
    # ring halves it at the hops.
    distributed.initialize(f"127.0.0.1:{ports[1]}", rank, TRAIN_RANKS,
                           wire_dtype="bf16")
    step16 = make_train_step(model, tx, cross_host=True,
                             grad_compression="bf16")
    x, y = next(_train_batches(path, rank, seed + 1))
    telemetry.reset()
    state, loss16 = step16(state, x, y, 0)
    m = telemetry.metrics()
    out.update(bf16_loss=float(loss16), bf16_crc=_params_crc(state.params),
               bf16_wire_ratio=next(iter(
                   m["tpunet_codec_wire_ratio"].values())))
    distributed.finalize()
    return out


def _zero_rank_body(rank: int, ports, path: str, seed: int) -> dict:
    """The train phase's run with the ZeRO-1 state and step."""
    from tpunet_torch import distributed
    from tpunet_torch.train import make_zero_train_step

    distributed.initialize(f"127.0.0.1:{ports[0]}", rank, TRAIN_RANKS)
    model, tx, state = _train_setup(seed, zero=True)
    step = make_zero_train_step(model, tx)
    state, out = _fit_measured(state, step, _train_batches(path, rank, seed))
    out["rank"] = rank
    distributed.finalize()
    return out


def _vgg_setup(seed: int, dropout: float = 0.0):
    """(model, state) of the vgg phase's configuration: VGG16 with f32
    master weights from `seed` (identically in every process), sgd with
    momentum."""
    from tpunet_torch.models import VGG, VGG16_CFG
    from tpunet_torch.train import create_train_state, sgd

    model = VGG(VGG16_CFG, num_classes=VGG_CLASSES, hidden=VGG_HIDDEN,
                compute_dtype=torch.bfloat16, classifier_dropout=dropout,
                image_size=VGG_IMAGE, device="meta")
    state, _ = create_train_state(model, seed, None,
                                  sgd(VGG_LR, momentum=0.9), device=DEVICE)
    return model, state


def _vgg_batch(seed: int, rank: int):
    """Rank `rank`'s batch, as benchmarks/vgg_synthetic.py draws it."""
    from tpunet_torch.train import synthetic_batch

    return synthetic_batch(np.random.default_rng(seed + rank), VGG_BATCH,
                           VGG_IMAGE, VGG_CLASSES)


def _cudnn(deterministic: bool) -> None:
    """Deterministic cuDNN (fixed algorithms, reproducible bits) or what
    users run: benchmark=True, the autotuned algorithms."""
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = not deterministic


def _timed_gradient_means(seconds: dict) -> None:
    """Wrap the trainer's two gradient means (flat and bucketed) so each
    call's host seconds, between two device synchronisations, land in
    seconds["flat"] / seconds["bucketed"]."""
    from tpunet_torch.train import trainer

    def timed(kind, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[kind].append(time.perf_counter() - t0)
            return out
        return run

    trainer._flat_dcn_pmean = timed("flat", trainer._flat_dcn_pmean)
    trainer._bucketed_dcn_pmean = timed("bucketed",
                                        trainer._bucketed_dcn_pmean)


# The vgg phase's runs in each rank: (name, deterministic cuDNN,
# make_train_step's bucket_bytes, dropout rate, steps). The timed run is
# last, with the autotuner on.
VGG_RUNS = (("flat", True, None, 0.0, VGG_STEPS),
            ("bucketed", True, VGG_BUCKET_BYTES, 0.0, VGG_STEPS),
            ("dropout_a", True, None, VGG_DROPOUT, VGG_DROPOUT_STEPS),
            ("dropout_b", True, None, VGG_DROPOUT, VGG_DROPOUT_STEPS),
            ("timed", False, None, 0.0, VGG_STEPS))


def _vgg_rank_body(rank: int, ports, path, seed: int) -> dict:
    """The vgg phase's runs (VGG_RUNS) on one rank, each from the same
    seed through fit() on this rank's batch, repeated."""
    from tpunet_torch import distributed
    from tpunet_torch.train import make_train_step

    del path
    distributed.initialize(f"127.0.0.1:{ports[0]}", rank, VGG_RANKS)
    batch = _vgg_batch(seed, rank)
    seconds = {"flat": [], "bucketed": []}
    _timed_gradient_means(seconds)
    out = {"rank": rank}
    for name, deterministic, bucket_bytes, dropout, steps in VGG_RUNS:
        _cudnn(deterministic)
        model, state = _vgg_setup(seed, dropout)
        step = make_train_step(model, cross_host=True,
                               bucket_bytes=bucket_bytes)
        for v in seconds.values():
            v.clear()
        state, out[name] = _fit_measured(state, step,
                                         itertools.repeat(batch), steps)
        out[name]["sync_s"] = list(
            seconds["bucketed" if bucket_bytes else "flat"])
        del model, state, step
    distributed.finalize()
    return out


def _rank_bodies() -> dict:
    return {"train": _train_rank_body, "zero": _zero_rank_body,
            "vgg": _vgg_rank_body, "moe": _moe_rank_body,
            "qlora": _qlora_rank_body, "a2a": _a2a_rank_body,
            "moe_bench": _moe_bench_rank_body, "sp": _sp_rank_body,
            "pipe_bench": _pipe_bench_rank_body,
            "pipe_model": _pipe_model_rank_body, "mesh": _mesh_rank_body,
            "dcn_mesh": _dcn_mesh_rank_body, "mesh6c": _mesh6c_rank_body,
            "dryrun": _dryrun_rank_body}


def _train_rank(kind: str, rank: int, ports, path: str, seed: int,
                q) -> None:
    """Entry point of a spawned training rank; reports to `q`."""
    try:
        q.put((rank, "OK", _rank_bodies()[kind](rank, ports, path, seed)))
    except Exception:  # noqa: BLE001 — reported to the parent
        q.put((rank, "FAIL", traceback.format_exc()))


def _spawn_ranks(kind: str, path: str, seed: int,
                 world: int = TRAIN_RANKS) -> tuple[list, float]:
    """Run `world` spawned ranks of `kind`; ([payload by rank], wall
    seconds), raising if any rank failed."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    ports = tuple(_free_port() for _ in range(4))
    procs = [ctx.Process(target=_train_rank,
                         args=(kind, r, ports, path, seed, q))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    res = {}
    try:
        deadline = time.monotonic() + 900
        while len(res) < world:
            try:
                rank, status, payload = q.get(timeout=5)
            except queue.Empty:
                # A rank that died without reporting (a crash in its
                # start-up) fails the phase now, not at the deadline.
                dead = [p.exitcode for p in procs if p.exitcode]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(f"{kind} ranks: {len(res)} of {world} "
                                       f"reported, exit codes {dead}")
                continue
            if status != "OK":
                raise RuntimeError(f"{kind} rank {rank} failed:\n{payload}")
            res[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return [res[r] for r in range(world)], time.perf_counter() - t0


def _half_batch_reference(model, state, rank_batches: list,
                          moe_aux_weight: float = MOE_AUX_WEIGHT):
    """Steps in one process: each rank's half-batch gradients computed
    apart, then (g0 + g1) / 2 applied; rank_batches[r][i] is rank r's
    (inputs, labels) of step i. The objective is the ranks' own
    (make_train_step's at `moe_aux_weight`: an MoE model's aux term
    included). Returns (params CRC, per-step [loss of rank 0's half, loss
    of rank 1's half])."""
    from tpunet_torch.train.trainer import (_as_batch, _make_loss_fn,
                                            _value_and_grads)

    loss_fn = _make_loss_fn(moe_aux_weight=moe_aux_weight, model=model)
    losses = []
    for step_batches in zip(*rank_batches):
        net = model.bind(state.params, trainable=True)
        halves, step_losses = [], []
        for batch in step_batches:
            x, y = (_as_batch(a, DEVICE) for a in batch)
            loss, grads = _value_and_grads(net, state.params, x, y, loss_fn,
                                           None)
            halves.append(grads)
            step_losses.append(float(loss))
        for n in halves[0]:
            state.params[n].grad = (halves[0][n] + halves[1][n]) / 2
        del halves
        state.opt_state.step()
        for p in state.params.values():
            p.grad = None
        losses.append(step_losses)
    return _params_crc(state.params), losses


def _train_reference(path: str, seed: int):
    """The train phase's steps in one process (_half_batch_reference)."""
    model, _, state = _train_setup(seed)
    return _half_batch_reference(model, state, [
        list(itertools.islice(_train_batches(path, r, seed), TRAIN_STEPS))
        for r in range(TRAIN_RANKS)])


def _mfu_flops_per_token(n_params: int) -> float:
    """Analytic train FLOPs per token of benchmarks/tpu_headline.py: 6 per
    matmul parameter (the embedding table is a lookup and excluded) plus
    attention's 12 * L * S * d."""
    cfg = MODEL_TRAIN
    n_matmul = n_params - cfg["vocab"] * cfg["d_model"]
    return 6 * n_matmul + 12 * cfg["n_layers"] * TRAIN_SEQ * cfg["d_model"]


def _steady(ranks: list) -> float:
    """Mean step time past the first step, over the ranks."""
    return float(np.mean([np.mean(r["step_s"][1:]) for r in ranks]))


def phase_train(seed: int) -> tuple[dict, dict]:
    """The training path on TRAIN_RANKS spawned ranks; returns the summed
    kernel launch counts of the ranks' fit() runs and the train line."""
    path = _ramp_data(seed)
    ranks, ranks_wall = _spawn_ranks("train", path, seed)
    ref_crc, ref_losses = _train_reference(path, seed)
    torch.cuda.empty_cache()

    n_params = ranks[0]["params"]
    steady = _steady(ranks)
    tokens_per_rank = TRAIN_BATCH * TRAIN_SEQ / steady
    flops_tok = _mfu_flops_per_token(n_params)
    global_loss = [float(np.mean(x)) for x in zip(*(r["losses"]
                                                      for r in ranks))]
    rank_losses = [list(x) for x in zip(*(r["losses"] for r in ranks))]
    summary = dict(
        params=n_params, ranks=TRAIN_RANKS, batch_per_rank=TRAIN_BATCH,
        seq=TRAIN_SEQ, steps=TRAIN_STEPS, losses=global_loss,
        rank_losses=rank_losses, reference_losses=ref_losses,
        step_s=[r["step_s"] for r in ranks], steady_step_s=steady,
        tokens_per_s_per_rank=tokens_per_rank,
        tokens_per_s=tokens_per_rank * TRAIN_RANKS,
        flops_per_token=flops_tok,
        mfu=tokens_per_rank * TRAIN_RANKS * flops_tok
        / PEAK_FLOPS[torch.bfloat16],
        peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in ranks],
        opt_state_bytes_per_rank=[r["opt_state_bytes"] for r in ranks],
        all_reduce=[r["all_reduce"] for r in ranks],
        all_reduce_s_per_step=[r["all_reduce"]["seconds"] / TRAIN_STEPS
                               for r in ranks],
        fit_wall_s=[r["fit_wall_s"] for r in ranks], ranks_wall_s=ranks_wall,
        launches=[r["launches"] for r in ranks],
        input_copies=[r["input_copies"] for r in ranks],
        crc=[r["crc"] for r in ranks], reference_crc=ref_crc,
        bf16_wire_ratio=[r["bf16_wire_ratio"] for r in ranks],
        bf16_crc=[r["bf16_crc"] for r in ranks],
        bf16_loss=[r["bf16_loss"] for r in ranks])
    # f32 params and gradients: params + optimizer state + 2 gradients.
    summary["peak_mem_limit_gb_per_rank"] = [
        (3 * 4 * n_params + opt) / 1e9 + TRAIN_MEM_SLACK_GB
        for opt in summary["opt_state_bytes_per_rank"]]
    log("train", **summary)
    if len(set(summary["crc"])) != 1:
        raise AssertionError("the data-parallel ranks' params differ")
    if summary["crc"][0] != ref_crc or rank_losses != ref_losses:
        raise AssertionError("the ranks differ from the single-process "
                             "half-batch-mean reference")
    if not all(np.isfinite(global_loss)) or global_loss[-1] >= global_loss[0]:
        raise AssertionError(f"loss not finite and falling: {global_loss}")
    if len(set(summary["bf16_crc"])) != 1 or any(
            r != 0.5 for r in summary["bf16_wire_ratio"]):
        raise AssertionError("bf16-wire step: ranks differ or wire ratio "
                             f"{summary['bf16_wire_ratio']} != 0.5")
    for got, limit in zip(summary["peak_mem_gb_per_rank"],
                          summary["peak_mem_limit_gb_per_rank"]):
        if got > limit:
            raise AssertionError(
                f"train peak memory {got:.3f} GB per rank above {limit:.3f} "
                "GB (params, optimizer state, two gradient buffers and "
                f"{TRAIN_MEM_SLACK_GB} GB)")
    launches = {n: sum(r["launches"][n] for r in ranks) for n in COUNTERS}
    want = _want_launches(TRAIN_RANKS, TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"kernel launches on the train path {launches}, "
                             f"expected {want}")
    if any(summary["input_copies"]):
        raise AssertionError(f"the train path copied flash inputs: "
                             f"{summary['input_copies']}")
    return launches, summary


# The elastic phase: the train phase's run under run_elastic. Member 1 is
# SIGKILLed by the churn script once it has logged step 3 and is respawned
# without the script; member 0 closes one data stream of its gradient
# all-reduce a few MB in (a failover, not a failure).
ELASTIC_KILL_SPEC = "churn:at_step=3:rank=1:action=kill"
ELASTIC_STREAM_FAULT = "stream=1:side=send:after_bytes=4M:action=close"
ELASTIC_VICTIM = 1
ELASTIC_CKPT_EVERY = 2
# A replacement that read a stale generation gives up on its dead port
# after the connect retry; the survivor parked at the new generation waits
# the longer bootstrap timeout.
ELASTIC_ENV = {"TPUNET_BOOTSTRAP_TIMEOUT_MS": "120000",
               "TPUNET_CONNECT_RETRY_MS": "5000"}


def _timed_checkpoints(record: list) -> None:
    """Wrap CheckpointManager.save and .restore so each call's seconds
    (between device synchronisations) and its step file's bytes land in
    `record`."""
    from tpunet_torch.train.checkpoint import CheckpointManager

    def timed(op, fn):
        def run(self, step, state, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(self, step, state, *args, **kwargs)
            torch.cuda.synchronize()
            record.append({"op": op, "step": int(step),
                           "seconds": time.perf_counter() - t0,
                           "bytes": self._path(step, state).stat().st_size})
            return res
        return run

    CheckpointManager.save = timed("save", CheckpointManager.save)
    CheckpointManager.restore = timed("restore", CheckpointManager.restore)


def _restore_most_advanced(base: Path, state):
    """`state` restored from the member checkpoint directory that holds
    the highest step (every member's holds the same bits at a step), or
    `state` itself when there is none."""
    from tpunet_torch.train import CheckpointManager

    best, best_dir = -1, None
    for d in sorted(base.glob("ckpt_m*")):
        latest = CheckpointManager(d).latest_step()
        if latest is not None and latest > best:
            best, best_dir = latest, d
    if best_dir is None:
        return state
    return CheckpointManager(best_dir).restore(best, state)


def _elastic_body(member: int, port: int, path: str, seed: int,
                  base: str) -> dict:
    """One member of the elastic run: run_elastic over a train_once that
    rebuilds the state and step from the comm it is given, restores the
    most advanced member's checkpoint and runs fit(); every kernel counter
    is zeroed just before fit() and read just after, per generation."""
    from tpunet_torch import telemetry, transport
    from tpunet_torch.elastic import churn_action, churn_pending
    from tpunet_torch.train import (fit, make_train_step, read_generation,
                                    run_elastic)

    started = time.time()
    base = Path(base)
    out = {"member": member, "generations": [], "checkpoints": []}
    _timed_checkpoints(out["checkpoints"])

    def train_once(comm, gen):
        rec = {"generation": gen, "entered": time.time(), "losses": {},
               "step_s": {}}
        out["generations"].append(rec)
        model, tx, state = _train_setup(seed)
        state = _restore_most_advanced(base, state)
        rec["start_step"] = int(state.step)
        step = make_train_step(model, tx, cross_host=True)
        trace_dir = str(base / "trace" / f"g{gen}")

        def traced_step(st, x, y, rng):
            if st.step == TRAIN_STEPS - 1:  # the last step
                with telemetry.profile(trace_dir):
                    return step(st, x, y, rng)
            return step(st, x, y, rng)

        def log_fn(m):
            rec.setdefault("first_step_at", time.time())
            rec["losses"][m["step"]] = m["loss"]
            rec["step_s"][m["step"]] = 1.0 / m["steps_per_s"]
            if churn_action(m["step"], member) == "kill":
                launches, copies = _read_counters()
                (base / "victim.json").write_text(json.dumps(dict(
                    killed_at=time.time(), step=m["step"], launches=launches,
                    input_copies=copies, losses=rec["losses"])))
                os.kill(os.getpid(), signal.SIGKILL)

        if member == 0 and gen == 0:
            transport.fault_inject(ELASTIC_STREAM_FAULT)
        torch.cuda.synchronize()
        _zero_counters()
        try:
            state = fit(state, traced_step,
                        _train_batches(path, comm.rank, seed),
                        steps=TRAIN_STEPS,
                        checkpoint_dir=str(base / f"ckpt_m{member}"),
                        checkpoint_every=ELASTIC_CKPT_EVERY, max_to_keep=1,
                        log_every=1, log_fn=log_fn,
                        skip_batches_on_resume=True, prefetch=2,
                        prefetch_device=DEVICE)
            torch.cuda.synchronize()
        except Exception as e:
            rec["failed_at"] = time.time()
            rec["error"] = f"{type(e).__name__}: {e}"
            raise
        finally:
            rec["launches"], rec["input_copies"] = _read_counters()
        return _params_crc(state.params), comm.world_size, gen

    crc, world, gen = run_elastic(
        train_once, coordinator=f"127.0.0.1:{port}", rank=member,
        world_size=TRAIN_RANKS, directory=str(base), max_restarts=2)
    m = telemetry.metrics()
    out.update(crc=crc, world=world, generation=gen,
               published_generation=read_generation(base),
               churn_pending=churn_pending(), started=started,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               stream_failovers=sum(m.get("tpunet_stream_failovers_total",
                                          {}).values()))
    return out


def _elastic_member(member: int, port: int, path: str, seed: int, base: str,
                    q, die: bool) -> None:
    """Entry point of a spawned elastic member; reports to `q` before the
    communicator is finalized. The trace file is named after TPUNET_RANK as
    the library loads, and the churn script is read when the first engine
    is made, so both are set before the port is imported."""
    os.environ["TPUNET_RANK"] = str(member)
    os.environ["TPUNET_FLIGHTREC_DIR"] = base
    os.environ.update(ELASTIC_ENV)
    if die:
        os.environ["TPUNET_FAULT_SPEC"] = ELASTIC_KILL_SPEC
    try:
        q.put((member, "OK", _elastic_body(member, port, path, seed, base)))
    except Exception:  # noqa: BLE001 — reported to the parent
        q.put((member, "FAIL", traceback.format_exc()))


def _supervise_elastic(path: str, seed: int, base: Path) -> tuple[dict, dict]:
    """Spawn the members; respawn the victim once it has died by SIGKILL
    (the scheduler's half of elastic training). The victim reports on a
    queue of its own: a process killed while writing to a queue can wedge
    it. Returns ({member: payload}, supervisor facts)."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q, vq = ctx.Queue(), ctx.Queue()
    port = _free_port()

    def spawn(member, die):
        p = ctx.Process(target=_elastic_member, args=(
            member, port, path, seed, str(base), vq if die else q, die))
        p.start()
        return p

    t0 = time.time()
    procs = {m: spawn(m, m == ELASTIC_VICTIM) for m in range(TRAIN_RANKS)}
    info = {"spawned_at": t0, "victim_exitcode": None, "respawned_at": None}
    results: dict = {}
    deadline = t0 + 900
    try:
        while len(results) < TRAIN_RANKS and time.time() < deadline:
            for qq in (q, vq):
                try:
                    member, status, payload = qq.get(timeout=0.25)
                except queue_mod.Empty:
                    continue
                if status != "OK":
                    raise RuntimeError(f"elastic member {member} failed:\n"
                                       f"{payload}")
                results[member] = payload
            victim = procs[ELASTIC_VICTIM]
            if info["victim_exitcode"] is None and not victim.is_alive():
                victim.join()
                info["victim_exitcode"] = victim.exitcode
                if victim.exitcode != -signal.SIGKILL:
                    raise RuntimeError(f"the victim exited with "
                                       f"{victim.exitcode}, not -SIGKILL")
                procs[ELASTIC_VICTIM] = spawn(ELASTIC_VICTIM, False)
                info["respawned_at"] = time.time()
    finally:
        for p in procs.values():
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if len(results) < TRAIN_RANKS:
        raise RuntimeError(f"elastic members {sorted(results)} reported "
                           "within 900 s")
    info["wall_s"] = time.time() - t0
    return results, info


def _trace_summary(trace_dir: Path) -> dict:
    """Merge the final generation's rank files; span counts per rank and
    the (comm_id, coll_seq) tags whose phase spans both ranks hold."""
    from tpunet_torch import telemetry

    merged = json.loads(Path(telemetry.merge_traces(
        str(trace_dir))).read_text())
    spans: dict = {}
    tags: dict = {}
    for ev in merged:
        if ev.get("ph") != "X":
            continue
        rank = int(ev.get("tid", 0)) // 1_000_000
        spans[rank] = spans.get(rank, 0) + 1
        args = ev.get("args") or {}
        if "comm_id" in args and "coll_seq" in args:
            tags.setdefault((args["comm_id"], args["coll_seq"]),
                            set()).add(rank)
    shared = sorted(k for k, v in tags.items() if len(v) == TRAIN_RANKS)
    return {"events": len(merged), "spans_per_rank": spans,
            "shared_collective_tags": len(shared)}


def phase_elastic(seed: int, train: dict) -> None:
    """The train phase's run under run_elastic with a scripted rank death,
    a respawned replacement and a stream failover, held to the train line
    `train`: the same final params and replayed losses, bitwise."""
    import shutil

    path = _ramp_data(seed)
    base = Path(__file__).resolve().parent / "build" / "chip_smoke" / "elastic"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    # A save holds the f32 params and AdamW's two moments; a member's
    # directory holds two while a new step is written and the old dropped.
    save_bytes = 4 * train["params"] + train["opt_state_bytes_per_rank"][0]
    need = 2 * TRAIN_RANKS * save_bytes + (2 << 30)
    free = shutil.disk_usage(base).free
    if free < need:
        raise AssertionError(
            f"elastic: {free / 1e9:.1f} GB free at {base}, the checkpoints "
            f"need {need / 1e9:.1f} GB")
    try:
        results, info = _supervise_elastic(path, seed, base)
        victim = json.loads((base / "victim.json").read_text())
        trace = _trace_summary(base / "trace" / "g1")
    finally:
        for d in base.glob("ckpt_m*"):
            shutil.rmtree(d, ignore_errors=True)
    survivor, repl = results[1 - ELASTIC_VICTIM], results[ELASTIC_VICTIM]
    s_fail = next(g for g in survivor["generations"] if "failed_at" in g)
    s_last, r_last = survivor["generations"][-1], repl["generations"][-1]
    replayed = range(ELASTIC_CKPT_EVERY + 1, TRAIN_STEPS + 1)
    summary = dict(
        victim_exitcode=info["victim_exitcode"], killed_at_step=victim["step"],
        generation=[r["generation"] for r in (survivor, repl)],
        published_generation=survivor["published_generation"],
        world=[r["world"] for r in (survivor, repl)],
        crc=[r["crc"] for r in (survivor, repl)], train_crc=train["crc"][0],
        restored_step=[s_last["start_step"], r_last["start_step"]],
        replayed_losses=[[r["losses"][s] for s in replayed]
                         for r in (s_last, r_last)],
        train_losses=[[train["rank_losses"][s - 1][m] for s in replayed]
                      for m in range(TRAIN_RANKS)],
        replacement_churn_pending=repl["churn_pending"],
        stream_failovers=[r["stream_failovers"] for r in (survivor, repl)],
        detect_s=s_fail["failed_at"] - victim["killed_at"],
        survivor_error=s_fail["error"][:200],
        survivor_rebuild_s=s_last["entered"] - s_fail["failed_at"],
        respawn_to_first_step_s=r_last["first_step_at"] - info["respawned_at"],
        replacement_start_to_first_step_s=r_last["first_step_at"]
        - repl["started"],
        checkpoints={m: r["checkpoints"] for m, r in results.items()},
        replayed_step_s=[[r["step_s"][s] for s in replayed]
                         for r in (s_last, r_last)],
        launches={"survivor": [g["launches"] for g in
                               survivor["generations"]],
                  "victim": victim["launches"],
                  "replacement": r_last["launches"]},
        input_copies=r_last["input_copies"],
        survivor_peak_mem_gb=survivor["peak_mem_gb"],
        replacement_peak_mem_gb=repl["peak_mem_gb"],
        peak_mem_limit_gb=train["peak_mem_limit_gb_per_rank"][0],
        trace=trace, wall_s=info["wall_s"])
    log("elastic", **summary)
    if info["victim_exitcode"] != -signal.SIGKILL or \
            summary["published_generation"] < 1:
        raise AssertionError("elastic: the victim was not SIGKILLed by the "
                             "churn script, or no new generation")
    if len(set(summary["crc"])) != 1 or summary["crc"][0] != train["crc"][0]:
        raise AssertionError(f"elastic: final params CRC {summary['crc']}, "
                             f"the train phase's {train['crc'][0]}")
    if summary["replayed_losses"] != summary["train_losses"]:
        raise AssertionError("elastic: the replayed losses differ from the "
                             "train phase's")
    if summary["world"] != [TRAIN_RANKS] * 2 or \
            summary["replacement_churn_pending"] != 0:
        raise AssertionError(f"elastic: final world {summary['world']}, "
                             "replacement churn events pending "
                             f"{summary['replacement_churn_pending']}")
    if summary["stream_failovers"][0] < 1:
        raise AssertionError("elastic: no stream failover on member 0")
    if summary["restored_step"] != [ELASTIC_CKPT_EVERY] * 2:
        raise AssertionError(f"elastic: restored steps "
                             f"{summary['restored_step']}")
    if trace["shared_collective_tags"] < 1 or \
            sorted(trace["spans_per_rank"]) != list(range(TRAIN_RANKS)):
        raise AssertionError(f"elastic: merged trace {trace}")
    want = _want_launches(1, TRAIN_STEPS - ELASTIC_CKPT_EVERY)
    if r_last["launches"] != want or r_last["input_copies"]:
        raise AssertionError(f"elastic: replacement launches "
                             f"{r_last['launches']} (want {want}), input "
                             f"copies {r_last['input_copies']}")
    if survivor["peak_mem_gb"] > summary["peak_mem_limit_gb"]:
        raise AssertionError(
            f"elastic: survivor peak {survivor['peak_mem_gb']:.3f} GB above "
            f"the train line's {summary['peak_mem_limit_gb']:.3f} GB: the "
            "failed generation's state outlived it")


def _want_launches(ranks: int, steps: int) -> dict:
    """flash launches of `steps` remat steps on `ranks` ranks: the forward
    twice a layer (once more in the recompute), dQ and dK/dV once."""
    layer_steps = ranks * steps * MODEL_TRAIN["n_layers"]
    return {"flash_fwd": 2 * layer_steps, "flash_dq": layer_steps,
            "flash_dkv": layer_steps}


def phase_zero(seed: int, train: dict) -> None:
    """The train phase's run with ZeRO-1 (create_zero_train_state,
    make_zero_train_step), held to the train line `train`: the same
    params bitwise, the same rank losses, half the optimizer state, at
    least ZERO_MEM_SAVING_GB less peak memory per rank."""
    path = _ramp_data(seed)
    ranks, ranks_wall = _spawn_ranks("zero", path, seed)
    torch.cuda.empty_cache()
    rank_losses = [list(x) for x in zip(*(r["losses"] for r in ranks))]
    steady = _steady(ranks)
    stats = [r["all_reduce"] for r in ranks]
    coll = {k: [{f: s[k][f] for f in ("calls", "bytes", "to_host_seconds",
                                      "collective_seconds", "seconds")}
                for s in stats] for k in ("reduce_scatter", "all_gather")}
    summary = dict(
        params=ranks[0]["params"], ranks=TRAIN_RANKS,
        batch_per_rank=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
        losses=[float(np.mean(x)) for x in rank_losses],
        rank_losses=rank_losses, train_rank_losses=train["rank_losses"],
        step_s=[r["step_s"] for r in ranks], steady_step_s=steady,
        train_steady_step_s=train["steady_step_s"],
        tokens_per_s=TRAIN_RANKS * TRAIN_BATCH * TRAIN_SEQ / steady,
        peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in ranks],
        train_peak_mem_gb_per_rank=train["peak_mem_gb_per_rank"],
        opt_state_bytes_per_rank=[r["opt_state_bytes"] for r in ranks],
        train_opt_state_bytes_per_rank=train["opt_state_bytes_per_rank"],
        reduce_scatter=coll["reduce_scatter"], all_gather=coll["all_gather"],
        all_reduce_calls=[s["calls"] for s in stats],
        fit_wall_s=[r["fit_wall_s"] for r in ranks], ranks_wall_s=ranks_wall,
        launches=[r["launches"] for r in ranks],
        input_copies=[r["input_copies"] for r in ranks],
        crc=[r["crc"] for r in ranks], train_crc=train["crc"][0])
    log("zero", **summary)
    if len(set(summary["crc"])) != 1 or summary["crc"][0] != train["crc"][0]:
        raise AssertionError(f"ZeRO params CRCs {summary['crc']} differ from "
                             f"each other or the train phase's "
                             f"{train['crc'][0]}")
    if rank_losses != train["rank_losses"]:
        raise AssertionError("the ZeRO rank losses differ from the train "
                             "phase's")
    pad = 2 * 4 * TRAIN_RANKS  # two f32 moments of < world padding elements
    for got, full in zip(summary["opt_state_bytes_per_rank"],
                         summary["train_opt_state_bytes_per_rank"]):
        if got > full / TRAIN_RANKS + pad:
            raise AssertionError(f"ZeRO optimizer state {got} B per rank, "
                                 f"replicated {full} B")
    for got, full in zip(summary["peak_mem_gb_per_rank"],
                         summary["train_peak_mem_gb_per_rank"]):
        if got > full - ZERO_MEM_SAVING_GB:
            raise AssertionError(f"ZeRO peak memory {got:.3f} GB per rank, "
                                 f"not {ZERO_MEM_SAVING_GB} GB below the "
                                 f"train phase's {full:.3f} GB")
    launches = {n: sum(r["launches"][n] for r in ranks) for n in COUNTERS}
    want = _want_launches(TRAIN_RANKS, TRAIN_STEPS)
    if launches != want or any(summary["input_copies"]):
        raise AssertionError(f"kernel launches on the zero path {launches}, "
                             f"expected {want}; input copies "
                             f"{summary['input_copies']}")
    if any(s["calls"] for s in stats) or any(
            c["calls"] != TRAIN_STEPS for k in coll.values() for c in k):
        raise AssertionError("the ZeRO step must run one reduce-scatter and "
                             "one all-gather a step and no all-reduce")


def phase_remat(seed: int) -> None:
    """benchmarks/mfu_sweep.py's selective-remat configuration in one
    process: REMAT_STEPS adamw steps per remat_policy from the same seed,
    held to bitwise the same params, with the policies' peak memory."""
    from tpunet_torch.data import TokenDataset, token_batches
    from tpunet_torch.train import make_train_step

    path = _ramp_data(seed)
    ds = TokenDataset(path, seq=TRAIN_SEQ, vocab=MODEL_TRAIN["vocab"])
    rows = {}
    for policy in REMAT_POLICIES:
        model, tx, state = _train_setup(seed, remat_policy=policy)
        step = make_train_step(model, tx)
        batches = itertools.islice(
            token_batches(ds, REMAT_BATCH, seed=seed), REMAT_STEPS)
        logs = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counters()
        for x, y in batches:
            t0 = time.perf_counter()
            state, loss = step(state, x, y, 0)
            logs.append((float(loss), time.perf_counter() - t0))
        launches, copies = _read_counters()
        rows[str(policy)] = dict(
            losses=[m[0] for m in logs], step_s=[m[1] for m in logs],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=launches, input_copies=copies,
            crc=_params_crc(state.params))
        del model, tx, state, step
        torch.cuda.empty_cache()
    log("remat", model=MODEL_TRAIN, batch=REMAT_BATCH, seq=TRAIN_SEQ,
        steps=REMAT_STEPS, policies=rows)
    crcs = {p: r["crc"] for p, r in rows.items()}
    if len(set(crcs.values())) != 1:
        raise AssertionError(f"remat policies changed the params: {crcs}")
    mem = {p: r["peak_mem_gb"] for p, r in rows.items()}
    if not mem["None"] < mem["dots"] or mem["dots_no_batch"] > mem["dots"]:
        raise AssertionError(f"remat peak memory {mem}: want None < dots "
                             f"and dots_no_batch <= dots")
    want = _want_launches(1, REMAT_STEPS)
    for p, r in rows.items():
        if r["launches"] != want or r["input_copies"]:
            raise AssertionError(f"remat_policy {p}: launches "
                                 f"{r['launches']}, expected {want}; input "
                                 f"copies {r['input_copies']}")


def _vgg_macs_per_image(model) -> int:
    """Multiply-adds of one image's forward, from the layer shapes: each
    conv's weight once per output pixel, each dense weight once."""
    side, macs, i = model.image_size, 0, 0
    for item in model.cfg:
        if item == "M":
            side //= 2
        else:
            macs += side * side * getattr(model, f"conv{i}").weight.numel()
            i += 1
    return macs + sum(getattr(model, n).weight.numel()
                      for n in ("fc1", "fc2", "head"))


def _vgg_steady(ranks: list, run: str) -> float:
    """Mean step time past the warmup, over the ranks."""
    return float(np.mean([np.mean(r[run]["step_s"][VGG_WARMUP:])
                          for r in ranks]))


def phase_vgg(seed: int) -> dict:
    """benchmarks/vgg_synthetic.py -n 2 on this card: VGG16 data-parallel
    on VGG_RANKS spawned ranks (VGG_RUNS), held to a single process that
    applies the mean of the two half-batch gradients; reports img/s, MFU,
    the gradient all-reduce's seconds and the peak memory per rank."""
    _cudnn(True)
    ranks, ranks_wall = _spawn_ranks("vgg", None, seed, VGG_RANKS)
    model, state = _vgg_setup(seed)
    groups = {g: sum(p.numel() for n, p in state.params.items()
                     if n.startswith(g)) for g in VGG_PARAMS}
    ref_crc, ref_losses = _half_batch_reference(
        model, state, [[_vgg_batch(seed, r)] * VGG_STEPS
                       for r in range(VGG_RANKS)])
    del state
    torch.cuda.empty_cache()
    runs = {name: [r[name] for r in ranks] for name, *_ in VGG_RUNS}
    flops_image = 6 * _vgg_macs_per_image(model)  # forward 2, backward 4
    steady = {k: _vgg_steady(ranks, k) for k in ("flat", "timed")}
    mean_s = {k: float(np.mean([np.mean(r["sync_s"][VGG_WARMUP:])
                                for r in runs[k]]))
              for k in ("flat", "bucketed", "timed")}
    img_s = {k: VGG_RANKS * VGG_BATCH / v for k, v in steady.items()}

    def per_step(run, key):
        return [r["all_reduce"][key] / VGG_STEPS for r in runs[run]]

    rank_losses = [list(x) for x in zip(*(r["losses"] for r in runs["flat"]))]
    losses = [float(np.mean(x)) for x in rank_losses]
    summary = dict(
        params=ranks[0]["flat"]["params"], params_by_group=groups,
        ranks=VGG_RANKS, batch_per_rank=VGG_BATCH, image=VGG_IMAGE,
        classes=VGG_CLASSES, steps=VGG_STEPS, warmup=VGG_WARMUP,
        losses=losses, rank_losses=rank_losses, reference_losses=ref_losses,
        crc={k: [r["crc"] for r in v] for k, v in runs.items()},
        reference_crc=ref_crc,
        dropout_rank_losses={k: [r["losses"] for r in runs[k]]
                             for k in ("dropout_a", "dropout_b")},
        step_s={k: [r["step_s"] for r in v] for k, v in runs.items()},
        steady_step_s=steady["timed"],
        img_per_s_per_rank=img_s["timed"] / VGG_RANKS,
        img_per_s=img_s["timed"],
        deterministic_steady_step_s=steady["flat"],
        deterministic_img_per_s=img_s["flat"],
        flops_per_image=flops_image,
        mfu=img_s["timed"] * flops_image / PEAK_FLOPS[BF16],
        all_reduce_s_per_step=per_step("timed", "seconds"),
        all_reduce_to_host_s_per_step=per_step("timed", "to_host_seconds"),
        all_reduce_collective_s_per_step=per_step("timed",
                                                  "collective_seconds"),
        gradient_mean_s={k: [r["sync_s"] for r in runs[k]]
                         for k in ("flat", "bucketed", "timed")},
        gradient_mean_steady_s=mean_s,
        # The rest of a steady step: forward, backward, the sgd update and
        # fit's loss read-back.
        outside_gradient_mean_s={k: steady[k] - mean_s[k]
                                 for k in ("flat", "timed")},
        peak_mem_gb_per_rank={k: [r["peak_mem_gb"] for r in v]
                              for k, v in runs.items()},
        opt_state_bytes_per_rank=[r["opt_state_bytes"]
                                  for r in runs["flat"]],
        launches=[r["launches"] for r in runs["flat"]],
        fit_wall_s={k: [r["fit_wall_s"] for r in v] for k, v in runs.items()},
        ranks_wall_s=ranks_wall)
    log("vgg", **summary)
    if summary["params"] != sum(VGG_PARAMS.values()) or groups != VGG_PARAMS:
        raise AssertionError(f"VGG16 has {summary['params']} params "
                             f"({groups}), expected {VGG_PARAMS}")
    crc = summary["crc"]
    if len(set(crc["flat"])) != 1 or crc["flat"][0] != ref_crc or (
            rank_losses != ref_losses):
        raise AssertionError("the VGG ranks differ from each other or from "
                             "the single-process half-batch-mean reference")
    if crc["bucketed"] != crc["flat"]:
        raise AssertionError(f"bucketed CRCs {crc['bucketed']} differ from "
                             f"the flat path's {crc['flat']}")
    if len(set(crc["timed"])) != 1:
        raise AssertionError("the autotuned (cudnn.benchmark) ranks differ")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"VGG loss not finite and falling: {losses}")
    drop = summary["dropout_rank_losses"]
    if (crc["dropout_a"] != crc["dropout_b"]
            or drop["dropout_a"] != drop["dropout_b"]
            or len(set(crc["dropout_a"])) != 1):
        raise AssertionError("two dropout runs from one seed differ")
    if any(a == r["losses"][:VGG_DROPOUT_STEPS]
           for a, r in zip(drop["dropout_a"], runs["flat"])):
        raise AssertionError("dropout changed no loss")
    return summary


# The moe phase: benchmarks/lm_synthetic.py --experts 4 --moe-top-k 2 at its
# default capacity factor and moe_every (:47-48, :161-165) on the training
# widths: six MoE blocks of 4 experts, top-2, 1,339,131,904 params
# (735,102,976 + 6 x (3 x 33,554,432 + 8,192)). A rank's step routes t =
# 4 x 2048 tokens a layer: capacity 5120 an expert. Each rank's peak is
# gated at MOE_MEM_LIMIT_GB (its params, AdamW's moments, the gradients and
# their flat vector are 26.8 GB).
MOE_OPTIONS = dict(n_experts=4, moe_every=2, moe_top_k=2,
                   capacity_factor=1.25)
MOE_PARAMS = 1_339_131_904
MOE_MEM_LIMIT_GB = 40.0
# The qlora phase: the serve configuration (MODEL_735M, GQA-4) quantised
# with quantize_params and grafted under the QLoRA paper's adapters (r 64,
# alpha 16 on every linear layer; Dettmers et al., 2023): 28,131,328
# adapter params, trained by lora_optimizer(adamw(2e-4)).
QLORA_OPTIONS = dict(weight_quant="int8", lora_rank=64, lora_alpha=16.0)
QLORA_ADAPTER_PARAMS = 28_131_328
QLORA_LR = 2e-4
QLORA_MAX_NEW = 64
# The a2a phase: 4 ranks spawned on this card over loopback. (a) the
# all-to-alls on odd blocks (the int8 codec's scale blocks restart per
# (src, dst) block); (b) benchmarks/moe_bench.py's defaults (its env, a
# latency-class dispatcher beside a bulk all-reduce tenant); (c) the MoE
# layer's own widths: d 2048, 8192 tokens a rank, top-1 of 4 experts,
# capacity ceil(8192 / 4 x 1.25) = 2560: an 84 MB dispatch buffer.
A2A_WORLD, A2A_N = 4, 1031
MOE_BENCH = dict(tokens=256, d_model=64, capacity=192, skew=1.0, steps=32,
                 bulk_bytes=4 << 20, bulk_min_iters=4, p99_budget_us=100_000)
MOE_BENCH_ENV = {"TPUNET_NSTREAMS": "1", "TPUNET_ASYNC_CHANNELS": "1",
                 "TPUNET_QOS_INFLIGHT_BYTES": "wire=256K",
                 "TPUNET_MOE_SKEW": "1.0"}
A2A_LAYER = dict(d_model=2048, tokens=8192, capacity=2560, skew=1.0,
                 rounds=8)


def _moe_setup(seed: int):
    """(model, state) of the moe phase: MODEL_TRAIN with MOE_OPTIONS, bf16
    compute, flash, remat, f32 master weights from `seed`, adamw."""
    from tpunet_torch.models import Transformer
    from tpunet_torch.train import adamw, create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = Transformer(compute_dtype=BF16, attn_impl="flash", remat=True,
                        device="meta", **MODEL_TRAIN, **MOE_OPTIONS)
    state, _ = create_train_state(model, seed, None, adamw(TRAIN_LR),
                                  device=DEVICE)
    return model, state


def _record_moe(records: list, choices: list | None = None):
    """Wrap Transformer.forward in this process so each forward that hands
    out its MoE blocks' aux losses (the trainer's) appends a (2, blocks)
    tensor to `records`: the aux losses and the dropped shares, read
    before the backward's recompute. With `choices`, each MoE layer's
    routing in those forwards (its (tokens, top_k) experts, recomputed from
    its input by the layer's own ops) is appended too, in call order.
    Returns a function that undoes the wrapping."""
    from tpunet_torch.models import MoeMlp, Transformer

    forward, moe_forward = Transformer.forward, MoeMlp.forward
    inside = [False]

    def recorded(self, *args, **kwargs):
        inside[0] = True
        try:
            out = forward(self, *args, **kwargs)
        finally:
            inside[0] = False
        if kwargs.get("moe_aux"):
            dropped = [b.moe.dropped for b in self.children()
                       if getattr(b, "is_moe", False)]
            records.append(torch.stack([torch.stack(kwargs["moe_aux"]),
                                        torch.stack(dropped)]).detach())
        return out

    def routed(self, x):
        if inside[0]:
            with torch.no_grad():
                probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                      @ self.router.float(), dim=-1)
                choices.append(torch.topk(probs, self.top_k, dim=-1)
                               .indices.to(torch.int8).cpu().numpy())
        return moe_forward(self, x)

    Transformer.forward = recorded
    if choices is not None:
        MoeMlp.forward = routed

    def undo():
        Transformer.forward, MoeMlp.forward = forward, moe_forward

    return undo


def _moe_rank_body(rank: int, ports, path: str, seed: int) -> dict:
    from tpunet_torch import distributed
    from tpunet_torch.train import make_train_step

    distributed.initialize(f"127.0.0.1:{ports[0]}", rank, TRAIN_RANKS)
    records: list = []
    _record_moe(records)
    model, state = _moe_setup(seed)
    routers = {k: v.detach().clone() for k, v in state.params.items()
               if k.endswith(".router")}
    step = make_train_step(model, cross_host=True,
                           moe_aux_weight=MOE_AUX_WEIGHT)
    state, out = _fit_measured(state, step, _train_batches(path, rank, seed))
    rec = torch.stack(records).cpu()  # (step, aux / dropped, block)
    out.update(rank=rank, aux=rec[:, 0].tolist(), dropped=rec[:, 1].tolist(),
               router_moved=[not torch.equal(v, state.params[k].detach())
                             for k, v in routers.items()])
    distributed.finalize()
    return out


def phase_moe(seed: int) -> dict:
    """MoE data-parallel training at the training widths on TRAIN_RANKS
    spawned ranks, held to one process applying the mean of the two
    half-batch gradients under the ranks' own objective (the aux term
    included); returns the summed kernel launch counts of the ranks'
    fit() runs."""
    from tpunet_torch.models import MoeMlp

    path = _ramp_data(seed)
    ranks, ranks_wall = _spawn_ranks("moe", path, seed)
    model, state = _moe_setup(seed)
    ref_crc, ref_losses = _half_batch_reference(model, state, [
        list(itertools.islice(_train_batches(path, r, seed), TRAIN_STEPS))
        for r in range(TRAIN_RANKS)])
    del model, state
    torch.cuda.empty_cache()
    n = ranks[0]["params"]
    steady = _steady(ranks)
    rank_losses = [list(x) for x in zip(*(r["losses"] for r in ranks))]
    losses = [float(np.mean(x)) for x in rank_losses]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    summary = dict(
        params=n, options=MOE_OPTIONS, ranks=TRAIN_RANKS,
        batch_per_rank=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
        capacity=MoeMlp(
            MODEL_TRAIN["d_model"], MOE_OPTIONS["n_experts"],
            MODEL_TRAIN["d_ff"], MOE_OPTIONS["capacity_factor"],
            top_k=MOE_OPTIONS["moe_top_k"], device="meta").capacity(tokens),
        losses=losses, rank_losses=rank_losses, reference_losses=ref_losses,
        aux_per_block=[r["aux"] for r in ranks],
        dropped_share_per_block=[r["dropped"] for r in ranks],
        router_moved=[r["router_moved"] for r in ranks],
        step_s=[r["step_s"] for r in ranks], steady_step_s=steady,
        tokens_per_s=TRAIN_RANKS * tokens / steady,
        all_reduce=[r["all_reduce"] for r in ranks],
        all_reduce_s_per_step=[r["all_reduce"]["seconds"] / TRAIN_STEPS
                               for r in ranks],
        all_reduce_bytes_per_step=[r["all_reduce"]["bytes"] / TRAIN_STEPS
                                   for r in ranks],
        peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in ranks],
        peak_mem_limit_gb=MOE_MEM_LIMIT_GB,
        # f32 params, AdamW's two moments, the gradients and their flat
        # vector: 20 bytes a parameter.
        reckoned_state_gb=20 * n / 1e9,
        opt_state_bytes_per_rank=[r["opt_state_bytes"] for r in ranks],
        fit_wall_s=[r["fit_wall_s"] for r in ranks], ranks_wall_s=ranks_wall,
        launches=[r["launches"] for r in ranks],
        input_copies=[r["input_copies"] for r in ranks],
        crc=[r["crc"] for r in ranks], reference_crc=ref_crc)
    log("moe", **summary)
    if n != MOE_PARAMS:
        raise AssertionError(f"the MoE model has {n} params, expected "
                             f"{MOE_PARAMS}")
    if len(set(summary["crc"])) != 1:
        raise AssertionError("the MoE ranks' params differ")
    if summary["crc"][0] != ref_crc or rank_losses != ref_losses:
        raise AssertionError("the MoE ranks differ from the single-process "
                             "half-batch-mean reference (aux term included)")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"MoE loss not finite and falling: {losses}")
    aux = np.asarray(summary["aux_per_block"])
    if aux.shape != (TRAIN_RANKS, TRAIN_STEPS, len(
            summary["router_moved"][0])) or not np.isfinite(aux).all():
        raise AssertionError(f"MoE aux losses not finite, or not one a "
                             f"block a step: {aux.tolist()}")
    if not all(all(r) for r in summary["router_moved"]):
        raise AssertionError(f"a router did not move: "
                             f"{summary['router_moved']}")
    for got in summary["peak_mem_gb_per_rank"]:
        if got > MOE_MEM_LIMIT_GB:
            raise AssertionError(f"MoE peak memory {got:.3f} GB per rank "
                                 f"above {MOE_MEM_LIMIT_GB} GB")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in COUNTERS}
    want = _want_launches(1, TRAIN_STEPS)  # each rank's
    if any(r["launches"] != want for r in ranks) or any(
            summary["input_copies"]):
        raise AssertionError(f"kernel launches on the moe path "
                             f"{summary['launches']}, expected {want} a "
                             f"rank; input copies "
                             f"{summary['input_copies']}")
    return launches


def _qlora_setup(seed: int):
    """(model, state, int8 base) of the qlora phase: MODEL_735M's params
    from `seed`, quantised, grafted under QLORA_OPTIONS (adapters from
    seed + 1), bf16 compute, flash, remat; lora_optimizer(adamw)."""
    from tpunet_torch.models import (Transformer, graft_base, init_params,
                                     lora_optimizer, quantize_params)
    from tpunet_torch.train import adamw, create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = Transformer(compute_dtype=torch.float32, device="meta",
                       **MODEL_735M)
    qbase = quantize_params(init_params(base, seed=seed, device=DEVICE))
    model = Transformer(compute_dtype=BF16, attn_impl="flash", remat=True,
                        device="meta", **MODEL_735M, **QLORA_OPTIONS)
    params = graft_base(init_params(model, seed=seed + 1, device=DEVICE),
                        qbase)
    state, _ = create_train_state(
        model, seed, None, lora_optimizer(adamw(QLORA_LR), params),
        params=params, device=DEVICE)
    return model, state, qbase


def _frozen(params: dict) -> dict:
    """Every leaf but the adapters: the int8 q and its scale, embed, the
    norm scales."""
    return {k: v for k, v in params.items() if ".lora_" not in k}


def _qlora_generate(model, params: dict, seed: int) -> dict:
    """Greedy generate with the adapted model on the serve phase's 8
    prompts, QLORA_MAX_NEW tokens each, the kernel counters zeroed just
    before and read just after."""
    from tpunet_torch.models import generate

    params = {k: v.detach() for k, v in params.items()}
    prompts = _prompts(seed + 2, 8, model.vocab)
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    outs = [generate(model, params, torch.as_tensor(p[None], device=DEVICE),
                     QLORA_MAX_NEW) for p in prompts]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, copies = _read_counters()
    new = [o[0, len(p):] for o, p in zip(outs, prompts)]
    return dict(
        prompts=[len(p) for p in prompts], wall_s=wall,
        tokens_per_s=len(prompts) * QLORA_MAX_NEW / wall,
        launches=launches, input_copies=copies,
        shapes_ok=all(tuple(o.shape) == (1, len(p) + QLORA_MAX_NEW)
                      for o, p in zip(outs, prompts)),
        in_vocab=all(bool(((t >= 0) & (t < model.vocab)).all())
                     for t in new),
        first_tokens=[t[:8].tolist() for t in new])


def _qlora_rank_body(rank: int, ports, path: str, seed: int) -> dict:
    from tpunet_torch import distributed
    from tpunet_torch.train import make_train_step

    distributed.initialize(f"127.0.0.1:{ports[0]}", rank, TRAIN_RANKS)
    model, state, qbase = _qlora_setup(seed)
    del qbase
    crc0 = _params_crc(_frozen(state.params))
    step = make_train_step(model, cross_host=True)
    state, out = _fit_measured(state, step, _train_batches(path, rank, seed))
    lora_b = [v for k, v in state.params.items() if k.endswith(".lora_b")]
    out.update(
        rank=rank,
        adapter_params=sum(v.numel() for k, v in state.params.items()
                           if ".lora_" in k),
        int8_leaves=sum(v.dtype == torch.int8
                        for v in state.params.values()),
        frozen_crc=[crc0, _params_crc(_frozen(state.params))],
        lora_b_off_zero=all(bool(v.detach().abs().max() > 0)
                            for v in lora_b))
    distributed.finalize()
    if rank == 0:
        out["generate"] = _qlora_generate(model, state.params, seed)
    return out


def phase_qlora(seed: int) -> dict:
    """QLoRA fine-tuning of the serve configuration on TRAIN_RANKS spawned
    ranks, held to one process applying the mean of the two half-batch
    gradients; before training the grafted model must be the int8 base
    (B = 0), after it every frozen leaf bitwise its start; then greedy
    generate with the adapted model. Returns the summed kernel launch
    counts of the ranks' fit() runs and the first step's loss (the mean
    over the ranks)."""
    from tpunet_torch.models import Transformer

    path = _ramp_data(seed)
    model, state, qbase = _qlora_setup(seed)
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, MODEL_735M["vocab"], (1, 512)), device=DEVICE)
    base = Transformer(compute_dtype=BF16, attn_impl="flash", device="meta",
                       weight_quant="int8", **MODEL_735M)
    with torch.no_grad():
        graft_is_base = bool(torch.equal(
            model.bind({k: v.detach() for k, v in state.params.items()})(
                tokens), base.bind(qbase)(tokens)))
    del state, qbase
    torch.cuda.empty_cache()
    ranks, ranks_wall = _spawn_ranks("qlora", path, seed)
    model, state, _ = _qlora_setup(seed)
    ref_crc, ref_losses = _half_batch_reference(model, state, [
        list(itertools.islice(_train_batches(path, r, seed), TRAIN_STEPS))
        for r in range(TRAIN_RANKS)])
    del model, state
    torch.cuda.empty_cache()
    steady = _steady(ranks)
    rank_losses = [list(x) for x in zip(*(r["losses"] for r in ranks))]
    losses = [float(np.mean(x)) for x in rank_losses]
    gen = ranks[0]["generate"]
    summary = dict(
        params=ranks[0]["params"], options=QLORA_OPTIONS,
        adapter_params=[r["adapter_params"] for r in ranks],
        int8_leaves=[r["int8_leaves"] for r in ranks],
        ranks=TRAIN_RANKS, batch_per_rank=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=TRAIN_STEPS, graft_is_base=graft_is_base, losses=losses,
        rank_losses=rank_losses, reference_losses=ref_losses,
        frozen_crc=[r["frozen_crc"] for r in ranks],
        lora_b_off_zero=[r["lora_b_off_zero"] for r in ranks],
        step_s=[r["step_s"] for r in ranks], steady_step_s=steady,
        tokens_per_s=TRAIN_RANKS * TRAIN_BATCH * TRAIN_SEQ / steady,
        all_reduce_s_per_step=[r["all_reduce"]["seconds"] / TRAIN_STEPS
                               for r in ranks],
        all_reduce_bytes_per_step=[r["all_reduce"]["bytes"] / TRAIN_STEPS
                                   for r in ranks],
        peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in ranks],
        opt_state_bytes_per_rank=[r["opt_state_bytes"] for r in ranks],
        fit_wall_s=[r["fit_wall_s"] for r in ranks], ranks_wall_s=ranks_wall,
        launches=[r["launches"] for r in ranks],
        input_copies=[r["input_copies"] for r in ranks],
        crc=[r["crc"] for r in ranks], reference_crc=ref_crc, generate=gen)
    log("qlora", **summary)
    if summary["adapter_params"] != [QLORA_ADAPTER_PARAMS] * TRAIN_RANKS:
        raise AssertionError(f"adapter params {summary['adapter_params']}, "
                             f"expected {QLORA_ADAPTER_PARAMS}")
    if not graft_is_base:
        raise AssertionError("the grafted model's logits differ from the "
                             "int8 base model's before training (B = 0)")
    if len(set(summary["crc"])) != 1 or summary["crc"][0] != ref_crc or (
            rank_losses != ref_losses):
        raise AssertionError("the QLoRA ranks differ from each other or "
                             "from the single-process half-batch mean")
    if any(a != b for a, b in summary["frozen_crc"]):
        raise AssertionError("a frozen leaf (int8 q or scale, embed, a "
                             "norm) moved")
    if not all(summary["lora_b_off_zero"]):
        raise AssertionError("a lora_b stayed at zero")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"QLoRA loss not finite and falling: {losses}")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in COUNTERS}
    want = _want_launches(1, TRAIN_STEPS)  # each rank's
    if any(r["launches"] != want for r in ranks) or any(
            summary["input_copies"]):
        raise AssertionError(f"kernel launches on the qlora path "
                             f"{summary['launches']}, expected {want} a "
                             f"rank; input copies "
                             f"{summary['input_copies']}")
    prefills = len(gen["prompts"]) * MODEL_735M["n_layers"]
    if gen["launches"] != {"flash_fwd": prefills, "flash_dq": 0,
                           "flash_dkv": 0} or gen["input_copies"]:
        raise AssertionError(f"adapted generate launched {gen['launches']} "
                             f"(want {prefills} forwards), input copies "
                             f"{gen['input_copies']}")
    if not (gen["shapes_ok"] and gen["in_vocab"]):
        raise AssertionError("adapted generate gave tokens outside the "
                             "vocab or of the wrong shape")
    return launches, losses[0]


def _a2a_send(seed: int, rank: int) -> np.ndarray:
    rng = np.random.default_rng(seed * 100 + rank)
    return (rng.standard_normal((A2A_WORLD, A2A_N)) * (rank + 1)).astype(
        np.float32)


def _a2a_rank_body(rank: int, ports, path, seed: int) -> dict:
    """(a) every all-to-all against its oracle and (c) the MoE layer's
    dispatch round trip, on one rank; returns what failed, if anything,
    and the round trip's times."""
    from tpunet_torch import distributed, interop, transport
    from tpunet_torch.collectives import Communicator
    from tpunet_torch.workloads import MoeDispatcher, route_tokens

    del path
    w = A2A_WORLD
    sends = [_a2a_send(seed, r) for r in range(w)]
    mine = sends[rank]
    bad = []

    def check(name, got, want):
        if np.asarray(got).tobytes() != np.asarray(want).tobytes():
            bad.append(name)

    for i, wire in enumerate(("f32", "bf16", "int8")):
        with Communicator(f"127.0.0.1:{ports[i]}", rank, w,
                          wire_dtype=wire) as comm:
            got = comm.all_to_all_typed(mine)
            for j in range(w):
                want = sends[j][rank]
                if j != rank and wire != "f32":
                    want = transport.codec_decode(transport.codec_encode(
                        np.ascontiguousarray(want), wire), wire, A2A_N)
                check(f"typed {wire} block {j}", got[j], want)
            if wire == "f32":
                transpose = np.stack([s[rank] for s in sends])
                check("bytes f16", comm.all_to_all(mine.astype(np.float16)),
                      transpose.astype(np.float16))
                red = comm.iall_reduce(mine[0].copy())
                pend = comm.iall_to_all(mine)
                check("iall_to_all", pend.wait(), transpose)
                total = sum(s[0].astype(np.float64) for s in sends)
                if not np.allclose(red.wait(), total, rtol=1e-5, atol=1e-5):
                    bad.append("iall_reduce beside iall_to_all")
    distributed.initialize(f"127.0.0.1:{ports[3]}", rank, w)
    dev = interop.dcn_all_to_all(torch.as_tensor(mine, device=DEVICE))
    if dev.device.type != torch.device(DEVICE).type:
        bad.append("dcn_all_to_all left the card")
    check("dcn_all_to_all", dev.cpu().numpy(),
          distributed.global_communicator().all_to_all(mine))

    # (c) The MoE layer's widths through the dispatcher, f32 wire.
    cfg = A2A_LAYER
    comm = distributed.global_communicator()
    disp = MoeDispatcher(comm, d_model=cfg["d_model"],
                         capacity=cfg["capacity"])
    rng = np.random.default_rng(seed * 100 + 50 + rank)
    toks = rng.standard_normal((cfg["tokens"], cfg["d_model"])).astype(
        np.float32)
    times, drops = [], []
    for _ in range(cfg["rounds"]):
        experts = route_tokens(cfg["tokens"], w, cfg["skew"], rng)
        dropped0 = disp.tokens_dropped
        comm.barrier()
        t0 = time.perf_counter()
        recv, _ = disp.dispatch(toks, experts)
        out = disp.combine(recv * 2.0)
        times.append(time.perf_counter() - t0)
        kept = disp._kept
        check("round trip kept rows", out[kept], toks[kept] * 2.0)
        if out[~kept].any():
            bad.append("a dropped row came back non-zero")
        # Each expert keeps its first `capacity` tokens in token order.
        over = np.bincount(experts, minlength=w) - cfg["capacity"]
        drops.append(disp.tokens_dropped - dropped0)
        if not drops[-1] == int((~kept).sum()) == int(np.maximum(over,
                                                                 0).sum()):
            bad.append("drop count differs from pack's")
    distributed.finalize()
    buf_bytes = w * cfg["capacity"] * cfg["d_model"] * 4
    return dict(rank=rank, failed=bad, round_trip_s=times, dropped=drops,
                drop_fraction=disp.drop_fraction, buffer_bytes=buf_bytes)


def _moe_bench_rank_body(rank: int, ports, path, seed: int) -> dict:
    """(b) benchmarks/moe_bench.py's rank at its defaults through the
    port's MoeDispatcher: a latency-class dispatcher beside a bulk-class
    all-reduce tenant under the QoS gate. The bulk loop stops by a vote
    carried in its own all-reduce, so every rank runs the same count."""
    os.environ.update(MOE_BENCH_ENV)
    import threading as th

    from tpunet_torch import telemetry
    from tpunet_torch.collectives import Communicator
    from tpunet_torch.workloads import MoeDispatcher, route_tokens

    del path, seed
    b, w = MOE_BENCH, A2A_WORLD
    lat = Communicator(f"127.0.0.1:{ports[0]}", rank, w, wire_dtype="f32",
                       traffic_class="latency")
    blk = Communicator(f"127.0.0.1:{ports[1]}", rank, w,
                       traffic_class="bulk")
    rng = np.random.default_rng(123 + rank)
    disp = MoeDispatcher(lat, d_model=b["d_model"], capacity=b["capacity"])
    grad = np.full(b["bulk_bytes"] // 4, 0.5, np.float32)
    disp.dispatch(rng.standard_normal((8, b["d_model"])).astype(np.float32),
                  route_tokens(8, w, b["skew"], rng))
    disp.combine(np.zeros((w, b["capacity"], b["d_model"]), np.float32))
    blk.all_reduce(np.ones(1024, np.float32))
    lat.barrier()
    telemetry.reset()
    disp.tokens_routed = disp.tokens_dropped = 0
    stop = th.Event()
    bulk_iters = [0]

    def bulk_loop():
        while True:
            grad[-1] = 1.0 if stop.is_set() else 0.0
            blk.all_reduce(grad, inplace=True)
            bulk_iters[0] += 1
            if grad[-1] > 0 and bulk_iters[0] >= b["bulk_min_iters"]:
                return

    bt = th.Thread(target=bulk_loop, daemon=True)
    bt.start()
    lat_us = []
    for _ in range(b["steps"]):
        toks = rng.standard_normal((b["tokens"], b["d_model"])).astype(
            np.float32)
        experts = route_tokens(b["tokens"], w, b["skew"], rng)
        t0 = time.perf_counter()
        expert_toks, _ = disp.dispatch(toks, experts)
        disp.combine(expert_toks * 2.0)
        lat_us.append((time.perf_counter() - t0) * 1e6)
    stop.set()
    bt.join(timeout=120)
    wedged = bt.is_alive()
    m = telemetry.metrics()
    a2a, by_class = {}, {}
    for key, v in m.get("tpunet_a2a_bytes_total", {}).items():
        lab = telemetry.labels(key)
        a2a[f"{lab['stage']}.{lab['dir']}"] = int(v)
    for key, v in m.get("tpunet_qos_bytes_total", {}).items():
        lab = telemetry.labels(key)
        by_class[f"{lab['class']}.{lab['dir']}"] = int(v)
    if not wedged:
        lat.close()
        blk.close()
    return dict(rank=rank, steps=len(lat_us), bulk_iters=bulk_iters[0],
                bulk_wedged=wedged,
                p99_queue_wait_us=_class_p99_us(m, "latency"),
                a2a_bytes=a2a, qos_bytes=by_class,
                dispatch_us=_quantiles(lat_us),
                drop_fraction=disp.drop_fraction)


def phase_a2a(seed: int) -> None:
    """The all-to-alls and the MoE dispatcher on A2A_WORLD ranks spawned on
    this card: (a) and (c) in one spawn, (b) in another with
    benchmarks/moe_bench.py's env (the QoS gate is read at a process's
    first engine)."""
    t0 = time.perf_counter()
    ranks, _ = _spawn_ranks("a2a", None, seed, A2A_WORLD)
    bench, _ = _spawn_ranks("moe_bench", None, seed, A2A_WORLD)
    b = MOE_BENCH
    rt = [s for r in ranks for s in r["round_trip_s"]]
    buf = ranks[0]["buffer_bytes"]
    # A typed block is capacity x d f32; each dispatch and each combine
    # ships W - 1 of them, and the counts' byte all-to-all W - 1 x 8 bytes.
    blk_bytes = b["capacity"] * b["d_model"] * 4
    a2a_tx = b["steps"] * (A2A_WORLD - 1) * (2 * blk_bytes + 8)
    bulk_tx = b["bulk_min_iters"] * b["bulk_bytes"] * 2 * (
        A2A_WORLD - 1) // A2A_WORLD
    summary = dict(
        world=A2A_WORLD, failed={r["rank"]: r["failed"] for r in ranks},
        layer=A2A_LAYER, buffer_bytes=buf,
        round_trip_p50_s=float(np.percentile(rt, 50)),
        round_trip_p99_s=float(np.percentile(rt, 99)),
        # Both buffers (dispatch and combine) of one rank over its round
        # trip, and the off-rank share the wire carries.
        round_trip_gb_per_s=2 * buf / float(np.percentile(rt, 50)) / 1e9,
        wire_gb_per_s=2 * buf * (A2A_WORLD - 1) / A2A_WORLD
        / float(np.percentile(rt, 50)) / 1e9,
        layer_drop_fraction=[r["drop_fraction"] for r in ranks],
        layer_dropped=[r["dropped"] for r in ranks],
        bench=dict(config=b, env=MOE_BENCH_ENV,
                   per_rank=[{k: v for k, v in r.items() if k != "rank"}
                             for r in bench]),
        bench_a2a_tx_expected=a2a_tx, bench_bulk_tx_min=bulk_tx,
        wall_s=time.perf_counter() - t0)
    log("a2a", **summary)
    if any(summary["failed"].values()):
        raise AssertionError(f"all-to-all checks failed: {summary['failed']}")
    for r in bench:
        p99 = r["p99_queue_wait_us"]
        if r["bulk_wedged"] or r["steps"] != b["steps"]:
            raise AssertionError(f"moe_bench rank {r['rank']} wedged or "
                                 f"short: {r['steps']} steps")
        if p99 is None or p99 > b["p99_budget_us"]:
            raise AssertionError(f"moe_bench rank {r['rank']}: latency p99 "
                                 f"queue wait {p99} us")
        if r["bulk_iters"] < b["bulk_min_iters"] or r["qos_bytes"].get(
                "bulk.tx", 0) < bulk_tx:
            raise AssertionError(f"moe_bench rank {r['rank']}: bulk tenant "
                                 f"starved: {r['bulk_iters']} iters, "
                                 f"{r['qos_bytes']}")
        if r["qos_bytes"].get("latency.tx", 0) <= 0 or r["a2a_bytes"].get(
                "flat.tx") != a2a_tx:
            raise AssertionError(f"moe_bench rank {r['rank']}: a2a bytes "
                                 f"{r['a2a_bytes']}, expected flat.tx "
                                 f"{a2a_tx}; {r['qos_bytes']}")


# Sequence parallelism across processes (ROADMAP A.6a) at the serve
# configuration's widths: a global sequence of SP_SEQ tokens, batch 1, over
# SP_RANKS ranks spawned on this card, each impl's forward in turn; then a
# tight f32 check at SP_F32_SEQ tokens. Logit tolerances relative to
# max(1, max |ref|): bf16 against the flash model on the whole sequence
# (its attention rounds P to bf16, the dcn impls fold f32 blocks), f32
# against the reference-attention model.
SP_RANKS = 2
SP_SEQ = 16384
SP_F32_SEQ = 4096
SP_IMPLS = ("dcn_ring", "dcn_zigzag", "dcn_ulysses")
SP_TOL = {BF16: 5e-2, F32: 1e-3}
SP_MEM_LIMIT_GB = 38.0


def _sp_wire(impl: str, dt, seq: int) -> dict:
    """What a rank's forward must move: {collective: (calls, payload
    bytes)}. The ring and zigzag exchange the GQA-repeated k and v of the
    rank's shard once a layer and step; Ulysses all-to-alls q, k and v
    stacked, then the output, each once a layer."""
    cfg, w = MODEL_735M, SP_RANKS
    layers, s = cfg["n_layers"], seq // w
    elem = torch.tensor([], dtype=dt).element_size()
    d = cfg["d_model"]
    if impl == "dcn_ulysses":
        return {"all_to_all": (2 * layers, layers * (3 + 1) * s * d * elem)}
    return {"neighbor_exchange": (layers * (w - 1),
                                  layers * (w - 1) * 2 * s * d * elem)}


def _sp_rank_body(rank: int, ports, ref: dict, seed: int) -> dict:
    """The three impls' forwards on this rank's shard (bf16 at SP_SEQ, a
    planted fault in the ring's and zigzag's exchange, f32 at SP_F32_SEQ),
    each held to its reference's rows."""
    from sp_shards import shard
    from tpunet_torch import distributed, interop
    from tpunet_torch.models import Transformer, init_params
    from tpunet_torch.parallel import to_zigzag

    ring_mod = importlib.import_module(
        "tpunet_torch.parallel.dcn_ring_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(f"127.0.0.1:{ports[0]}", rank, SP_RANKS)
    comm = distributed.global_communicator()
    # Score elements (b * sq * sk * h) of every block update: the ring's
    # imbalance against the zigzag's balance.
    scores = []
    update = ring_mod._block_update

    def counted(q, k, *args, **kw):
        scores.append(q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2])
        return update(q, k, *args, **kw)

    ring_mod._block_update = counted

    def forward(params, dt, impl, seq):
        zig = impl == "dcn_zigzag"
        toks = torch.as_tensor(ref["tokens"][:, :seq], device=DEVICE)
        if zig:
            toks = to_zigzag(toks, SP_RANKS)
        s = seq // SP_RANKS
        toks = toks[:, rank * s:(rank + 1) * s]
        model = Transformer(compute_dtype=dt, attn_impl=impl, device="meta",
                            **MODEL_735M).bind(params)
        scores.clear()
        interop.dcn_reduce_stats_reset()
        _zero_counters()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        comm.barrier()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = model(toks)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches, copies = _read_counters()
        stats = interop.dcn_reduce_stats()
        name = "f32" if dt == F32 else "bf16"
        want = torch.from_numpy(np.array(shard(
            np.load(ref[name], mmap_mode="r"), SP_RANKS, rank, zig))).to(
                DEVICE)
        err = float((logits - want).abs().max())
        finite = bool(torch.isfinite(logits).all())
        shape = tuple(logits.shape)
        del logits, want, model
        torch.cuda.empty_cache()
        wire = {k: dict(calls=stats[k]["calls"], bytes=stats[k]["bytes"],
                        seconds=stats[k]["seconds"],
                        collective_seconds=stats[k]["collective_seconds"])
                for k in _sp_wire(impl, dt, seq)}
        return dict(seconds=sec, tokens_per_s=s / sec, max_abs_err=err,
                    finite=finite, shape=shape, peak_mem_gb=peak,
                    launches=launches, input_copies=copies, wire=wire,
                    block_updates=len(scores), score_elements=sum(scores))

    out = {"rank": rank, "bf16": {}, "fault": {}, "f32": {}}
    params = _bf16_checkpoint(seed)
    for impl in SP_IMPLS:
        out["bf16"][impl] = forward(params, BF16, impl, SP_SEQ)
    # The planted fault: no k/v crosses, every rank folds its own block.
    exchange = ring_mod._exchange_packed
    ring_mod._exchange_packed = lambda kc, vc: (kc, vc)
    try:
        for impl in ("dcn_ring", "dcn_zigzag"):
            out["fault"][impl] = forward(params, BF16, impl, SP_SEQ)[
                "max_abs_err"]
    finally:
        ring_mod._exchange_packed = exchange
    del params
    torch.cuda.empty_cache()
    p32 = init_params(Transformer(compute_dtype=F32, device="meta",
                                  **MODEL_735M), seed=seed, device=DEVICE)
    for impl in SP_IMPLS:
        out["f32"][impl] = forward(p32, F32, impl, SP_F32_SEQ)
    distributed.finalize()
    return out


def phase_sp(seed: int) -> dict:
    """Sequence parallelism across processes on the card; returns the flash
    launches of its one-process reference (its kernel path)."""
    from tpunet_torch.models import Transformer, init_params

    t0 = time.perf_counter()
    base = Path(__file__).resolve().parent / "build" / "chip_smoke"
    base.mkdir(parents=True, exist_ok=True)
    tokens = np.random.default_rng(seed + 16).integers(
        0, MODEL_735M["vocab"], (1, SP_SEQ))
    ref = {"tokens": tokens, "bf16": str(base / "sp_ref_bf16.npy"),
           "f32": str(base / "sp_ref_f32.npy")}
    scale, ref_s = {}, {}
    for dt, impl, seq in ((BF16, "flash", SP_SEQ),
                          (F32, "reference", SP_F32_SEQ)):
        name = "f32" if dt == F32 else "bf16"
        p32 = init_params(Transformer(compute_dtype=F32, device="meta",
                                      **MODEL_735M), seed=seed, device=DEVICE)
        params = {k: (t if k.endswith(".scale") else t.to(dt))
                  for k, t in p32.items()}
        del p32
        model = Transformer(compute_dtype=dt, attn_impl=impl, device="meta",
                            **MODEL_735M).bind(params)
        _zero_counters()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            logits = model(torch.as_tensor(tokens[:, :seq], device=DEVICE))
        torch.cuda.synchronize()
        ref_s[name] = time.perf_counter() - t1
        if dt == BF16:
            launches, copies = _read_counters()
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"sp: the {name} reference is not finite")
        scale[name] = max(1.0, float(logits.abs().max()))
        np.save(ref[name], logits.cpu().numpy())
        del logits, model, params
        torch.cuda.empty_cache()
    ranks, wall = _spawn_ranks("sp", ref, seed, SP_RANKS)
    for name in ("bf16", "f32"):
        os.remove(ref[name])
    tol = {"bf16": SP_TOL[BF16] * scale["bf16"],
           "f32": SP_TOL[F32] * scale["f32"]}
    rows = {}
    for name in ("bf16", "f32"):
        for impl in SP_IMPLS:
            per = [r[name][impl] for r in ranks]
            rows[f"{name}/{impl}"] = dict(
                max_abs_err=max(p["max_abs_err"] for p in per),
                seconds=[p["seconds"] for p in per],
                tokens_per_s=(SP_SEQ if name == "bf16" else SP_F32_SEQ)
                / max(p["seconds"] for p in per),
                peak_mem_gb=[p["peak_mem_gb"] for p in per],
                wire=[p["wire"] for p in per],
                block_updates=[p["block_updates"] for p in per],
                score_elements=[p["score_elements"] for p in per],
                launches=[p["launches"] for p in per],
                input_copies=[p["input_copies"] for p in per])
    fault = {impl: max(r["fault"][impl] for r in ranks)
             for impl in ("dcn_ring", "dcn_zigzag")}
    log("sp", model=MODEL_735M, ranks=SP_RANKS, seq=SP_SEQ,
        f32_seq=SP_F32_SEQ, reference_launches=launches,
        reference_input_copies=copies, reference_s=ref_s,
        max_abs_ref=scale, tol=tol, planted_fault_err=fault,
        mem_limit_gb=SP_MEM_LIMIT_GB, rank_wall_s=wall, runs=rows,
        wall_s=time.perf_counter() - t0, card=CARD)
    if launches["flash_fwd"] != MODEL_735M["n_layers"] or copies or any(
            launches[k] for k in ("flash_dq", "flash_dkv")):
        raise AssertionError(f"sp reference: launches {launches} (want "
                             f"{MODEL_735M['n_layers']} forwards), copies "
                             f"{copies}")
    for r in ranks:
        for name, dt, seq in (("bf16", BF16, SP_SEQ),
                              ("f32", F32, SP_F32_SEQ)):
            for impl, p in r[name].items():
                where = f"sp rank {r['rank']} {name} {impl}"
                if not (p["finite"] and p["max_abs_err"] <= tol[name]):
                    raise AssertionError(f"{where}: logits off the "
                                         f"reference by {p['max_abs_err']} "
                                         f"(tol {tol[name]})")
                if p["shape"] != (1, seq // SP_RANKS, MODEL_735M["vocab"]):
                    raise AssertionError(f"{where}: logits {p['shape']}")
                if any(p["launches"].values()) or p["input_copies"]:
                    raise AssertionError(f"{where}: flash launched "
                                         f"{p['launches']}")
                for k, (calls, nbytes) in _sp_wire(impl, dt, seq).items():
                    got = p["wire"][k]
                    if (got["calls"], got["bytes"]) != (calls, nbytes):
                        raise AssertionError(f"{where}: {k} moved {got}, "
                                             f"want {calls} calls, "
                                             f"{nbytes} B")
                if name == "bf16" and p["peak_mem_gb"] > SP_MEM_LIMIT_GB:
                    raise AssertionError(f"{where}: peak {p['peak_mem_gb']} "
                                         f"GB")
    for impl, err in fault.items():
        if not err > tol["bf16"]:
            raise AssertionError(f"sp: the check cannot see a planted "
                                 f"{impl} exchange fault ({err})")
    return launches


# The pipeline-stage workload (ROADMAP A.11b) on PIPE_STAGES stages
# spawned on this card: (a) benchmarks/pipeline_bench.py's base mode at
# its defaults (with its env, PIPE_BENCH_ENV), (b) in a spawn of its own at
# the transport's default env, the same chain carrying f32 activations of
# (1, PIPE_SEQ, d) through PIPE_STAGES groups of consecutive blocks of the
# serve configuration (bf16, flash).
PIPE_STAGES = 4
PIPE_BENCH = dict(n_micro=32, mb_bytes=1 << 20)
PIPE_BENCH_ENV = {"TPUNET_NSTREAMS": "1", "TPUNET_ASYNC_CHANNELS": "1"}
PIPE_MICRO, PIPE_SEQ = 8, 2048


def _pipe_blocks(params: dict, layers) -> list:
    """The blocks `layers` of the serve configuration, bound to `params`
    (a meta Block loaded by assignment: nothing else of the model)."""
    from tpunet_torch.models import Transformer

    meta = Transformer(compute_dtype=BF16, attn_impl="flash", device="meta",
                       **MODEL_735M)
    out = []
    for i in layers:
        blk, pre = getattr(meta, f"block{i}"), f"block{i}."
        blk.load_state_dict({k[len(pre):]: t for k, t in params.items()
                             if k.startswith(pre)}, strict=True, assign=True)
        out.append(blk.requires_grad_(False))
    return out


def _pipe_inputs(params: dict, seed: int) -> list:
    """PIPE_MICRO microbatches of embedded random tokens, f32 on the host."""
    import torch.nn.functional as F

    toks = np.random.default_rng(seed + 17).integers(
        0, MODEL_735M["vocab"], (PIPE_MICRO, 1, PIPE_SEQ))
    with torch.no_grad():
        return [F.embedding(torch.as_tensor(t, device=DEVICE),
                            params["embed"]).float().cpu().numpy()
                for t in toks]


def _pipe_apply(blocks: list):
    """A stage's transform: f32 activations in, through `blocks` in bf16,
    f32 out (the cast to bf16 and back is exact on bf16 values)."""
    def fn(x):
        h = torch.from_numpy(x).to(DEVICE).to(BF16)
        with torch.no_grad():
            for blk in blocks:
                h = blk(h)
        return h.float().cpu().numpy()
    return fn


def _pipe_run(rank: int, port: int, fn, inputs, n_micro, shape) -> dict:
    """One PipelineStage chain on this stage: its seconds, the seconds
    inside its transforms, its byte counters, the host clock at the start
    and the end of each microbatch's transform, the last stage's
    outputs."""
    from tpunet_torch import telemetry
    from tpunet_torch.collectives import Communicator
    from tpunet_torch.workloads import PipelineStage

    starts, ends = [], []

    def stamped(x):
        starts.append(time.perf_counter())
        y = fn(x)
        ends.append(time.perf_counter())
        return y

    with Communicator(f"127.0.0.1:{port}", rank, PIPE_STAGES) as comm, \
            PipelineStage(comm) as st:
        telemetry.reset()
        comm.barrier()
        t0 = time.perf_counter()
        if st.is_first:
            outs = st.run(stamped, microbatches=inputs)
        else:
            outs = st.run(stamped, n_micro=n_micro, mb_shape=shape)
        sec = time.perf_counter() - t0
        m = telemetry.metrics()
    return dict(seconds=sec, mb_per_s=n_micro / sec, starts=starts,
                ends=ends, transform_s=float(np.sum(np.subtract(ends,
                                                                starts))),
                outputs=outs,
                isend_bytes=int(sum(m.get("tpunet_isend_nbytes_sum",
                                          {}).values())),
                irecv_bytes=int(sum(m.get("tpunet_irecv_nbytes_sum",
                                          {}).values())))


def _pipe_bench_rank_body(rank: int, ports, path, seed: int) -> dict:
    """(a) the bench's chain of +1 stages, under the bench's env."""
    del path, seed
    os.environ.update(PIPE_BENCH_ENV)
    n = PIPE_BENCH["mb_bytes"] // 4
    n_micro = PIPE_BENCH["n_micro"]
    bench = _pipe_run(rank, ports[0], lambda x: x + 1.0,
                      [np.full(n, float(i), np.float32)
                       for i in range(n_micro)], n_micro, (n,))
    outs = bench.pop("outputs")
    if outs is not None:
        bench["verified"] = sum(bool(np.all(y == i + PIPE_STAGES))
                                for i, y in enumerate(outs))
        bench["outputs"] = len(outs)
    return dict(rank=rank, bench=bench)


def _pipe_model_rank_body(rank: int, ports, path, seed: int) -> dict:
    """(b) this stage's 3 blocks of the serve configuration."""
    del path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = _bf16_checkpoint(seed)
    per = MODEL_735M["n_layers"] // PIPE_STAGES
    blocks = _pipe_blocks(params, range(rank * per, (rank + 1) * per))
    inputs = _pipe_inputs(params, seed) if rank == 0 else None
    del params
    torch.cuda.empty_cache()
    # One transform before the chain, so no microbatch's latency holds the
    # stage's first kernels' and libraries' set-up.
    apply = _pipe_apply(blocks)
    apply(np.zeros((1, PIPE_SEQ, MODEL_735M["d_model"]), np.float32))
    _zero_counters()
    model = _pipe_run(rank, ports[0], apply, inputs,
                      PIPE_MICRO, (1, PIPE_SEQ, MODEL_735M["d_model"]))
    torch.cuda.synchronize()
    model["launches"], model["input_copies"] = _read_counters()
    model["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return dict(rank=rank, model=model)


def _pipe_latency(stages: list, key: str) -> dict:
    """Per-microbatch latency from the start of stage 0's transform to the
    end of the last stage's, on the host's monotonic clock (shared by the
    processes): p50/p99 over the microbatches (a later one's includes its
    wait behind the earlier ones) and the first's (nothing ahead of it);
    microbatches/s at the last stage; each stage's share of its run spent
    inside its transform (the rest is the wait on its links)."""
    lat = [b - a for a, b in zip(stages[0][key]["starts"],
                                 stages[-1][key]["ends"])]
    return {"p50_s": float(np.percentile(lat, 50)),
            "p99_s": float(np.percentile(lat, 99)), "first_s": lat[0],
            "microbatches_per_s": stages[-1][key]["mb_per_s"],
            "transform_share": [s[key]["transform_s"] / s[key]["seconds"]
                                for s in stages]}


def phase_pipe(seed: int) -> dict:
    """The pipeline workload; returns the flash launches of its model
    chain, summed over the stages."""
    t0 = time.perf_counter()
    benches, bench_wall = _spawn_ranks("pipe_bench", None, seed, PIPE_STAGES)
    stages, wall = _spawn_ranks("pipe_model", None, seed, PIPE_STAGES)
    for s, b in zip(stages, benches):
        s["bench"] = b["bench"]
    last = stages[-1]
    params = _bf16_checkpoint(seed)
    ref = [_pipe_apply(_pipe_blocks(params, range(MODEL_735M["n_layers"])))(
        x) for x in _pipe_inputs(params, seed)]
    del params
    torch.cuda.empty_cache()
    outs = last["model"].pop("outputs")
    equal = len(outs) == PIPE_MICRO and all(
        a.tobytes() == b.tobytes() for a, b in zip(outs, ref))
    finite = all(np.isfinite(a).all() for a in outs)
    launches = {k: sum(s["model"]["launches"][k] for s in stages)
                for k in COUNTERS}
    per = MODEL_735M["n_layers"] // PIPE_STAGES
    hop = PIPE_SEQ * MODEL_735M["d_model"] * 4
    log("pipe", stages=PIPE_STAGES, bench=PIPE_BENCH,
        bench_env=PIPE_BENCH_ENV, model_env="the transport's defaults",
        bench_latency=_pipe_latency(stages, "bench"),
        model_latency=_pipe_latency(stages, "model"),
        micro=PIPE_MICRO, hop_bytes=hop, bitwise_equal_one_process=equal,
        per_stage=[{"rank": s["rank"],
                    **{key: {k: v for k, v in s[key].items()
                             if k not in ("starts", "ends")}
                       for key in ("bench", "model")}} for s in stages],
        launches=launches, rank_wall_s={"bench": bench_wall, "model": wall},
        wall_s=time.perf_counter() - t0, card=CARD)
    b = last["bench"]
    if b.get("outputs") != PIPE_BENCH["n_micro"] or b.get(
            "verified") != PIPE_BENCH["n_micro"]:
        raise AssertionError(f"pipe (a): {b.get('verified')} of "
                             f"{PIPE_BENCH['n_micro']} microbatches verified")
    for s in stages:
        sent = s["rank"] < PIPE_STAGES - 1
        for key, n, size in (("bench", PIPE_BENCH["n_micro"],
                              PIPE_BENCH["mb_bytes"]),
                             ("model", PIPE_MICRO, hop)):
            got = s[key]["isend_bytes" if sent else "irecv_bytes"]
            if got < n * size:
                raise AssertionError(f"pipe stage {s['rank']} {key}: "
                                     f"{got} B moved, want {n * size}")
        if s["model"]["launches"]["flash_fwd"] != per * PIPE_MICRO or s[
                "model"]["input_copies"]:
            raise AssertionError(f"pipe stage {s['rank']}: launches "
                                 f"{s['model']['launches']}")
    if not (equal and finite):
        raise AssertionError("pipe (b): the last stage's outputs differ "
                             "from one process running the blocks in order")
    return launches

# The mesh phase (ROADMAP A.6b): the in-pod mesh tier in ONE spawn of
# MESH_RANKS ranks on this card, a mesh device being a rank. (a) the train
# phase's model, data and seed under tensor parallelism over {dp: 2, mdl:
# 2} for MESH_STEPS steps; (b) GPipe over {pp: 4}, 3 blocks of the
# training widths a stage, MESH_PIPE_MICRO microbatches of (1, TRAIN_SEQ,
# d); (c) ring, zigzag and Ulysses attention over {dp: 2, sp: 2} at the
# serve widths (16 heads, 4 kv heads, D 128) on MESH_SP_SEQ tokens a dp
# replica (MESH_SP_F32_SEQ in f32), and VGG16's TP classifier over (a)'s
# mesh for MESH_VGG_STEPS steps.
MESH_RANKS, MESH_STEPS, MESH_VGG_STEPS = 4, 3, 2
MESH_LOSS_RTOL = 2e-3
MESH_PIPE_MICRO = 8
MESH_SP_SEQ, MESH_SP_F32_SEQ = 8192, 2048
MESH_SP_GRAD_TOL = 1e-1
# The TP x DP path's attention: a rank's 8 of the 16 heads at the training
# shape, as (b, sq, sk, h, hk, causal, window, dtype, d); held to the plain
# versions in the kernels phases.
MESH_CASES = [(TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 8, 8, True, None, BF16,
               128)]


def _mesh_tp(mesh, path: str, seed: int) -> dict:
    """(a): make_train_step over the TP model, fit() on dp rank d's train
    batches; the train phase's measurements plus the axis collectives."""
    from tpunet_torch.models import Transformer
    from tpunet_torch.parallel import smap
    from tpunet_torch.train import adamw, create_train_state, make_train_step

    model = Transformer(compute_dtype=BF16, attn_impl="flash", remat=True,
                        mesh=mesh, tp_axis="mdl", device="meta",
                        **MODEL_TRAIN)
    tx = adamw(TRAIN_LR)
    state, _ = create_train_state(model, seed, None, tx, device=DEVICE)
    step = make_train_step(model, tx)
    dp = mesh.axis_index("dp")
    smap.axis_stats_reset()
    state, out = _fit_measured(state, step, _train_batches(path, dp, seed),
                               MESH_STEPS)
    out.update(axis=smap.axis_stats(), dp=dp, mdl=mesh.axis_index("mdl"))
    del state, step
    torch.cuda.empty_cache()
    return out


def _mesh_gpipe(mesh, seed: int) -> dict:
    """(b): gpipe over pp of this stage's 3 blocks (f32 masters, bf16
    compute, flash), forward and backward of mean(out ** 2); then the 12
    blocks in order on this process over the same microbatches (in
    reverse order, the order autograd sums the pipeline's ticks in)."""
    import torch.nn.functional as F
    from torch import nn
    from torch.func import functional_call

    from tpunet_torch.models import Transformer, init_params
    from tpunet_torch.parallel import gpipe, smap

    meta = Transformer(compute_dtype=BF16, attn_impl="flash", device="meta",
                       **MODEL_TRAIN)
    p32 = init_params(meta, seed=seed, device=DEVICE)
    per = MODEL_TRAIN["n_layers"] // mesh.shape["pp"]
    stage = mesh.axis_index("pp")
    seq = nn.Sequential(*(getattr(meta, f"block{i}") for i in range(per)))

    def stage_params(s: int) -> dict:
        return {f"{i - s * per}.{n.split('.', 1)[1]}": t
                for n, t in p32.items() for i in range(s * per, (s + 1) * per)
                if n.startswith(f"block{i}.")}

    def stage_fn(params, x):
        return functional_call(seq, params, (x,))

    toks = np.random.default_rng(seed + 18).integers(
        0, MODEL_TRAIN["vocab"], (MESH_PIPE_MICRO, TRAIN_SEQ))
    x = F.embedding(torch.as_tensor(toks, device=DEVICE),
                    p32["embed"]).to(BF16)
    local = {k: v[None].clone().requires_grad_()
             for k, v in stage_params(stage).items()}
    smap.axis_stats_reset()
    _zero_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    y = gpipe(stage_fn, local, x, mesh, MESH_PIPE_MICRO)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    (y.float() ** 2).mean().backward()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches, copies = _read_counters()
    out = dict(seconds=sec, forward_s=fwd_s, launches=launches,
               input_copies=copies, axis=smap.axis_stats(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    # The reference: microbatch by microbatch through the 12 blocks.
    mine = {k: v.detach().clone().requires_grad_()
            for k, v in stage_params(stage).items()}
    params = [mine if s == stage else stage_params(s)
              for s in range(mesh.shape["pp"])]
    ref = [None] * MESH_PIPE_MICRO
    for m in reversed(range(MESH_PIPE_MICRO)):
        h = x[m:m + 1]
        for s, p in enumerate(params):
            h = stage_fn(p, h)
        (h.float() ** 2).sum().div(y.numel()).backward()
        ref[m] = h.detach()
    ref = torch.cat(ref)
    out["forward_bitwise"] = bool(torch.equal(y.detach(), ref))
    out["forward_max_abs_err"] = float((y.detach().float()
                                        - ref.float()).abs().max())
    errs, bitwise = {}, True
    for k, v in mine.items():
        g, want = local[k].grad[0], v.grad
        bitwise &= bool(torch.equal(g, want))
        errs[k] = float((g - want).abs().max()) / max(
            1.0, float(want.abs().max()))
    out["grad_rel_err"] = max(errs.values())
    out["grad_bitwise"] = bitwise
    del p32, x, y, ref, local, mine, params
    torch.cuda.empty_cache()
    return out


def _mesh_rows(x, n: int, i: int, zigzag: bool):
    """Rank i's rows (axis 1) of `x` over n sequence ranks: contiguous, or
    its zigzag chunk pair (sp_shards.shard's rule, on the card)."""
    if zigzag:
        c = x.shape[1] // (2 * n)
        lo, hi = i * c, (2 * n - 1 - i) * c
        return torch.cat([x[:, lo:lo + c], x[:, hi:hi + c]], dim=1)
    s = x.shape[1] // n
    return x[:, i * s:(i + 1) * s]


def _mesh_sp(mesh, seed: int) -> dict:
    """(c): ring, zigzag and Ulysses over sp, forward and backward in bf16
    against the one-process flash attention of the dp replica's whole
    sequence (each rank computes it), forward in f32 against
    attention_reference, and the planted fault (no k/v crosses)."""
    from tpunet_torch.ops.flash_attention import (_repeat_kv,
                                                  attention_reference,
                                                  flash_attention)
    from tpunet_torch.parallel import (ring_self_attention, smap,
                                       ulysses_self_attention,
                                       zigzag_self_attention)

    h, hk, d = MODEL_735M["n_heads"], MODEL_735M["n_kv_heads"], 128
    n, i = mesh.shape["sp"], mesh.axis_index("sp")
    dp = mesh.axis_index("dp")

    def data(seq, dt):
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(seed + 19 + dp)
        shapes = ((1, seq, h, d), (1, seq, hk, d), (1, seq, hk, d),
                  (1, seq, h, d))
        return [torch.randn(s, generator=gen, device=DEVICE).to(dt)
                for s in shapes]

    def run(impl, q, k, v):
        k, v = _repeat_kv(k, h // hk), _repeat_kv(v, h // hk)
        if impl == "zigzag":
            return zigzag_self_attention(q, k, v, mesh)
        fn = ring_self_attention if impl == "ring" else ulysses_self_attention
        return fn(q, k, v, mesh, causal=True)

    out = {"bf16": {}, "f32": {}, "fault": {}}
    q, k, v, w = data(MESH_SP_SEQ, BF16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o_ref = flash_attention(*leaves, True)
    (o_ref.float() * w.float()).sum().backward()
    ref = {"out": o_ref.detach(), "dq": leaves[0].grad,
           "dk": leaves[1].grad, "dv": leaves[2].grad}
    scale = {key: max(1.0, float(t.float().abs().max()))
             for key, t in ref.items()}
    del leaves, o_ref
    for impl in ("ring", "zigzag", "ulysses"):
        zig = impl == "zigzag"
        mine = [_mesh_rows(t, n, i, zig).contiguous().requires_grad_()
                for t in (q, k, v)]
        smap.axis_stats_reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        o = run(impl, *mine)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        (o.float() * _mesh_rows(w, n, i, zig).float()).sum().backward()
        torch.cuda.synchronize()
        got = {"out": o.detach(), "dq": mine[0].grad, "dk": mine[1].grad,
               "dv": mine[2].grad}
        out["bf16"][impl] = dict(
            forward_s=fwd_s, seconds=time.perf_counter() - t0,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            axis=smap.axis_stats(), finite=all(
                bool(torch.isfinite(t).all()) for t in got.values()),
            err={key: float((got[key].float() - _mesh_rows(
                ref[key], n, i, zig).float()).abs().max()) / (
                    1.0 if key == "out" else scale[key])
                for key in got})
        del o, mine, got
        torch.cuda.empty_cache()
    # The planted fault: every ring step hands a rank its own block back.
    permute = smap._permute
    smap._permute = lambda x, *args: x.clone()
    try:
        with torch.no_grad():
            for impl in ("ring", "zigzag"):
                zig = impl == "zigzag"
                o = run(impl, *(_mesh_rows(t, n, i, zig) for t in (q, k, v)))
                out["fault"][impl] = float((o.float() - _mesh_rows(
                    ref["out"], n, i, zig).float()).abs().max())
    finally:
        smap._permute = permute
    out["scale"] = scale
    del q, k, v, w, ref
    torch.cuda.empty_cache()
    q, k, v, _ = data(MESH_SP_F32_SEQ, F32)
    with torch.no_grad():
        want = attention_reference(q, _repeat_kv(k, h // hk),
                                   _repeat_kv(v, h // hk), True)
        out["f32_scale"] = max(1.0, float(want.abs().max()))
        for impl in ("ring", "zigzag", "ulysses"):
            zig = impl == "zigzag"
            o = run(impl, *(_mesh_rows(t, n, i, zig) for t in (q, k, v)))
            out["f32"][impl] = float((o - _mesh_rows(want, n, i,
                                                     zig)).abs().max())
    return out


def _mesh_vgg(mesh, seed: int) -> dict:
    """VGG16 (the vgg phase's configuration) with its classifier over
    mdl, data over dp, deterministic cuDNN, dp rank d on the vgg phase's
    rank-d batch."""
    from tpunet_torch.models import VGG, VGG16_CFG
    from tpunet_torch.parallel import smap
    from tpunet_torch.train import create_train_state, make_train_step, sgd

    _cudnn(True)
    model = VGG(VGG16_CFG, num_classes=VGG_CLASSES, hidden=VGG_HIDDEN,
                compute_dtype=BF16, classifier_dropout=0.0,
                image_size=VGG_IMAGE, mesh=mesh, tp_axis="mdl",
                device="meta")
    state, _ = create_train_state(model, seed, None,
                                  sgd(VGG_LR, momentum=0.9), device=DEVICE)
    step = make_train_step(model)
    dp = mesh.axis_index("dp")
    smap.axis_stats_reset()
    state, out = _fit_measured(state, step,
                               itertools.repeat(_vgg_batch(seed, dp)),
                               MESH_VGG_STEPS)
    out.update(axis=smap.axis_stats(), dp=dp, mdl=mesh.axis_index("mdl"))
    del state, step
    torch.cuda.empty_cache()
    return out


def _mesh_rank_body(rank: int, ports, path: str, seed: int) -> dict:
    """The three meshes over this spawn's ranks, built in one order on
    every rank, and the parts (a), (b), (c) in turn."""
    from tpunet_torch import distributed
    from tpunet_torch.parallel import make_named_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(f"127.0.0.1:{ports[0]}", rank, MESH_RANKS)
    t0 = time.perf_counter()
    tp = make_named_mesh({"dp": 2, "mdl": 2})
    pp = make_named_mesh({"pp": 4})
    sp = make_named_mesh({"dp": 2, "sp": 2})
    out = {"rank": rank, "wire_s": time.perf_counter() - t0, "seconds": {}}
    for part, fn, mesh, arg in (("tp", _mesh_tp, tp, path),
                                ("pipe", _mesh_gpipe, pp, None),
                                ("sp", _mesh_sp, sp, None),
                                ("vgg", _mesh_vgg, tp, None)):
        distributed.global_communicator().barrier()
        t0 = time.perf_counter()
        out[part] = fn(mesh, arg, seed) if arg else fn(mesh, seed)
        out["seconds"][part] = time.perf_counter() - t0
    for m in (tp, pp, sp):
        m.close()
    distributed.finalize()
    return out


def phase_mesh(seed: int, train: dict, vgg: dict) -> tuple[dict, list]:
    """The in-pod mesh tier on MESH_RANKS ranks; returns the flash
    launches of (a), the TP x DP training path, summed over the ranks, and
    (a)'s global losses."""
    t0 = time.perf_counter()
    ranks, wall = _spawn_ranks("mesh", _ramp_data(seed), seed, MESH_RANKS)
    tp = [r["tp"] for r in ranks]
    n_local = [p["params"] for p in tp]
    logits_bytes = 4 * TRAIN_BATCH * TRAIN_SEQ * MODEL_TRAIN["vocab"]
    limits = [(3 * 4 * n + p["opt_state_bytes"] + logits_bytes) / 1e9
              + TRAIN_MEM_SLACK_GB for n, p in zip(n_local, tp)]
    # The global loss: the mean over dp of each dp group's (mdl 0's).
    by_dp = {p["dp"]: p["losses"] for p in tp if p["mdl"] == 0}
    losses = [float(np.mean(x)) for x in zip(*by_dp.values())]
    vg = [r["vgg"] for r in ranks]
    vgg_by_dp = {p["dp"]: p["losses"] for p in vg if p["mdl"] == 0}
    vgg_losses = [float(np.mean(x)) for x in zip(*vgg_by_dp.values())]
    pipe = [r["pipe"] for r in ranks]
    sp = [r["sp"] for r in ranks]
    tol = {"bf16": SP_TOL[BF16] * max(r["scale"]["out"] for r in sp),
           "f32": SP_TOL[F32] * max(r["f32_scale"] for r in sp)}
    summary = dict(
        ranks=MESH_RANKS, wall_s=time.perf_counter() - t0, ranks_wall_s=wall,
        part_s=[r["seconds"] for r in ranks],
        wire_s=[r["wire_s"] for r in ranks],
        tp=dict(mesh={"dp": 2, "mdl": 2}, steps=MESH_STEPS, losses=losses,
                rank_losses=[p["losses"] for p in tp],
                train_first_loss=train["losses"][0],
                first_loss_rel=abs(losses[0] - train["losses"][0])
                / abs(train["losses"][0]),
                crc=[p["crc"] for p in tp], params=n_local,
                step_s=[p["step_s"] for p in tp],
                launches=[p["launches"] for p in tp],
                input_copies=[p["input_copies"] for p in tp],
                peak_mem_gb=[p["peak_mem_gb"] for p in tp],
                peak_mem_limit_gb=limits,
                dp_all_reduce=[p["all_reduce"] for p in tp],
                axis=[p["axis"] for p in tp]),
        pipe=dict(mesh={"pp": 4}, microbatches=MESH_PIPE_MICRO,
                  **{k: [p[k] for p in pipe] for k in pipe[0]}),
        sp=dict(mesh={"dp": 2, "sp": 2}, seq=MESH_SP_SEQ,
                f32_seq=MESH_SP_F32_SEQ, tol=tol,
                grad_tol=MESH_SP_GRAD_TOL,
                bf16=[r["bf16"] for r in sp], f32=[r["f32"] for r in sp],
                planted_fault_err=[r["fault"] for r in sp]),
        vgg=dict(mesh={"dp": 2, "mdl": 2}, steps=MESH_VGG_STEPS,
                 losses=vgg_losses, vgg_first_loss=vgg["losses"][0],
                 first_loss_rel=abs(vgg_losses[0] - vgg["losses"][0])
                 / abs(vgg["losses"][0]),
                 crc=[p["crc"] for p in vg],
                 step_s=[p["step_s"] for p in vg],
                 peak_mem_gb=[p["peak_mem_gb"] for p in vg],
                 axis=[p["axis"] for p in vg]),
        card=CARD)
    log("mesh", **summary)
    s = summary["tp"]
    for a in range(2):
        for b in range(2, 4):
            if tp[a]["mdl"] == tp[b]["mdl"] and tp[a]["crc"] != tp[b]["crc"]:
                raise AssertionError(f"mesh (a): the dp replicas of mdl "
                                     f"{tp[a]['mdl']} differ")
    if s["first_loss_rel"] > MESH_LOSS_RTOL:
        raise AssertionError(f"mesh (a): first loss {losses[0]} off the "
                             f"train phase's {train['losses'][0]}")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"mesh (a): loss not finite and falling: "
                             f"{losses}")
    want = _want_launches(1, MESH_STEPS)
    for p, limit in zip(tp, limits):
        if p["launches"] != want or p["input_copies"]:
            raise AssertionError(f"mesh (a): launches {p['launches']} "
                                 f"(want {want}), copies "
                                 f"{p['input_copies']}")
        if p["peak_mem_gb"] > limit:
            raise AssertionError(f"mesh (a): peak {p['peak_mem_gb']} GB "
                                 f"above {limit} GB")
    per_stage = MESH_PIPE_MICRO * MODEL_TRAIN["n_layers"] // 4
    for p in pipe:
        if not p["forward_bitwise"]:
            raise AssertionError("mesh (b): the pipeline's output is not "
                                 "the sequential run's, bitwise")
        if p["grad_rel_err"] > BWD_TOL[BF16]:
            raise AssertionError(f"mesh (b): stage gradients off by "
                                 f"{p['grad_rel_err']}")
        if p["launches"] != {k: per_stage for k in COUNTERS} or (
                p["input_copies"]):
            raise AssertionError(f"mesh (b): launches {p['launches']}, "
                                 f"want {per_stage} each")
    for r in sp:
        for impl, row in r["bf16"].items():
            e = row["err"]
            if not row["finite"] or e["out"] > tol["bf16"] or max(
                    e["dq"], e["dk"], e["dv"]) > MESH_SP_GRAD_TOL:
                raise AssertionError(f"mesh (c): bf16 {impl} off: {e}")
        for impl, err in r["f32"].items():
            if err > tol["f32"]:
                raise AssertionError(f"mesh (c): f32 {impl} off: {err}")
    # A causal ring's first rank folds only its own block: the fault shows
    # on the others.
    for impl in ("ring", "zigzag"):
        err = max(r["fault"][impl] for r in sp)
        if not err > tol["bf16"]:
            raise AssertionError(f"mesh (c): the check cannot see a planted "
                                 f"{impl} fault ({err})")
    v = summary["vgg"]
    for a in range(2):
        for b in range(2, 4):
            if vg[a]["mdl"] == vg[b]["mdl"] and vg[a]["crc"] != vg[b]["crc"]:
                raise AssertionError("mesh vgg: the dp replicas differ")
    if v["first_loss_rel"] > MESH_LOSS_RTOL or not all(
            np.isfinite(vgg_losses)):
        raise AssertionError(f"mesh vgg: first loss {vgg_losses} off the "
                             f"vgg phase's {vgg['losses'][0]}")
    return {k: sum(p["launches"][k] for p in tp) for k in COUNTERS}, losses


# -- dcn_mesh: the DCN tier across meshes (ROADMAP A.6d) ---------------------

# One spawn of MESH_RANKS ranks on this card as DCN_MESH_HOSTS "hosts" of
# DCN_MESH (a mesh is one host's ranks): TP over mdl inside a host, DP
# across the hosts over each position's DCN group. Host h trains on the
# train phase's rank-h batches (TRAIN_BATCH x TRAIN_SEQ), so the global
# batch is the train phase's; MESH_STEPS steps of cross_host=True (the flat
# vector), then ZeRO-1 from the same init.
DCN_MESH_HOSTS, DCN_MESH = 2, {"mdl": 2}
DCN_MESH_RUNS = ("cross_host", "zero")


def _dcn_mesh_rank_body(rank: int, ports, path: str, seed: int) -> dict:
    """Both runs on this rank's host mesh; the first state is freed
    before the second is made."""
    from tpunet_torch import distributed
    from tpunet_torch.models import Transformer
    from tpunet_torch.parallel import make_named_mesh, smap
    from tpunet_torch.train import (adamw, create_train_state,
                                    create_zero_train_state, make_train_step,
                                    make_zero_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(f"127.0.0.1:{ports[0]}", rank, MESH_RANKS)
    t0 = time.perf_counter()
    mesh = make_named_mesh(DCN_MESH)
    out = {"rank": rank, "host": mesh.host, "mdl": mesh.axis_index("mdl"),
           "wire_s": time.perf_counter() - t0,
           "dcn_wire": mesh.dcn_comm().wire_dtype}
    model = Transformer(compute_dtype=BF16, attn_impl="flash", remat=True,
                        mesh=mesh, tp_axis="mdl", device="meta",
                        **MODEL_TRAIN)
    tx = adamw(TRAIN_LR)
    for run in DCN_MESH_RUNS:
        zero = run == "zero"
        create = create_zero_train_state if zero else create_train_state
        state, _ = create(model, seed, None, tx, device=DEVICE)
        step = (make_zero_train_step(model, tx) if zero
                else make_train_step(model, tx, cross_host=True))
        distributed.global_communicator().barrier()
        smap.axis_stats_reset()
        state, out[run] = _fit_measured(
            state, step, _train_batches(path, mesh.host, seed), MESH_STEPS)
        out[run]["axis"] = smap.axis_stats()
        del state, step
        torch.cuda.empty_cache()
    mesh.close()
    distributed.finalize()
    return out


def _dcn_calls(stats: dict) -> dict:
    """{collective: {calls, bytes, staging, collective and all seconds}}
    of a rank's dcn_reduce_stats()."""
    kinds = {"all_reduce": stats, "reduce_scatter": stats["reduce_scatter"],
             "all_gather": stats["all_gather"]}
    return {k: {f: v[f] for f in ("calls", "bytes", "to_host_seconds",
                                  "collective_seconds", "seconds")}
            for k, v in kinds.items()}


def phase_dcn_mesh(seed: int, train: dict, mesh_losses: list) -> dict:
    """The DCN tier across host meshes on MESH_RANKS ranks, held to the
    train line `train` and the mesh phase's (a) losses; returns the flash
    launches of both runs, summed over the ranks."""
    t0 = time.perf_counter()
    ranks, wall = _spawn_ranks("dcn_mesh", _ramp_data(seed), seed,
                               MESH_RANKS)
    torch.cuda.empty_cache()
    runs = {}
    for run in DCN_MESH_RUNS:
        rs = [r[run] for r in ranks]
        # The global loss: the mean over the hosts of each host's (its mdl
        # ranks hold the same loss).
        by_host = {r["host"]: r[run]["losses"] for r in ranks if r["mdl"] == 0}
        losses = [float(np.mean(x)) for x in zip(*by_host.values())]
        dcn = [_dcn_calls(p["all_reduce"]) for p in rs]
        tier = [sum(d[k]["seconds"] for k in d) for d in dcn]
        runs[run] = dict(
            losses=losses, rank_losses=[p["losses"] for p in rs],
            crc=[p["crc"] for p in rs], params=[p["params"] for p in rs],
            step_s=[p["step_s"] for p in rs],
            fit_wall_s=[p["fit_wall_s"] for p in rs], dcn=dcn,
            dcn_share=[t / p["fit_wall_s"] for t, p in zip(tier, rs)],
            launches=[p["launches"] for p in rs],
            input_copies=[p["input_copies"] for p in rs],
            peak_mem_gb=[p["peak_mem_gb"] for p in rs],
            opt_state_bytes=[p["opt_state_bytes"] for p in rs],
            axis=[p["axis"] for p in rs])
    ch, zr = runs["cross_host"], runs["zero"]
    logits_bytes = 4 * TRAIN_BATCH * TRAIN_SEQ * MODEL_TRAIN["vocab"]
    limits = [(3 * 4 * n + o + logits_bytes) / 1e9 + TRAIN_MEM_SLACK_GB
              for n, o in zip(ch["params"], ch["opt_state_bytes"])]
    first_rel = abs(ch["losses"][0] - train["losses"][0]) / abs(
        train["losses"][0])
    mesh_gap = [abs(a - b) for a, b in zip(ch["losses"], mesh_losses)]
    summary = dict(
        hosts=DCN_MESH_HOSTS, mesh=DCN_MESH, ranks=MESH_RANKS,
        steps=MESH_STEPS, wall_s=time.perf_counter() - t0, ranks_wall_s=wall,
        wire_s=[r["wire_s"] for r in ranks],
        dcn_wire=[r["dcn_wire"] for r in ranks],
        host=[r["host"] for r in ranks], mdl=[r["mdl"] for r in ranks],
        train_first_loss=train["losses"][0], first_loss_rel=first_rel,
        mesh_losses=mesh_losses, mesh_bitwise=ch["losses"] == mesh_losses,
        mesh_gap=mesh_gap,
        zero_bitwise=zr["crc"] == ch["crc"] and zr["losses"] == ch["losses"],
        peak_mem_limit_gb=limits, card=CARD, **runs)
    log("dcn_mesh", **summary)
    if first_rel > MESH_LOSS_RTOL:
        raise AssertionError(f"dcn_mesh: first loss {ch['losses'][0]} off "
                             f"the train phase's {train['losses'][0]}")
    want = _want_launches(1, MESH_STEPS)
    for run, r in runs.items():
        if not all(np.isfinite(r["losses"])) or (
                r["losses"][-1] >= r["losses"][0]):
            raise AssertionError(f"dcn_mesh {run}: loss not finite and "
                                 f"falling: {r['losses']}")
        # The ranks of one position in the two hosts: the DCN tier keeps
        # their blocks equal.
        for a, b in itertools.combinations(range(MESH_RANKS), 2):
            if ranks[a]["mdl"] == ranks[b]["mdl"] and (
                    r["crc"][a] != r["crc"][b]):
                raise AssertionError(f"dcn_mesh {run}: the hosts' blocks of "
                                     f"mdl {ranks[a]['mdl']} differ")
        if any(n != want for n in r["launches"]) or any(r["input_copies"]):
            raise AssertionError(f"dcn_mesh {run}: launches {r['launches']} "
                                 f"(want {want} a rank), copies "
                                 f"{r['input_copies']}")
    # A DCN group's collectives: one all-reduce a step for cross_host; one
    # reduce-scatter and one all-gather a step, and no all-reduce, for
    # ZeRO (no data axis inside a host: no in-host mean).
    for run, calls in (("cross_host", (MESH_STEPS, 0, 0)),
                       ("zero", (0, MESH_STEPS, MESH_STEPS))):
        for d in runs[run]["dcn"]:
            got = tuple(d[k]["calls"] for k in ("all_reduce",
                                                "reduce_scatter",
                                                "all_gather"))
            if got != calls:
                raise AssertionError(f"dcn_mesh {run}: DCN calls (all-reduce, "
                                     f"reduce-scatter, all-gather) {got}, "
                                     f"want {calls}")
    if not summary["zero_bitwise"]:
        raise AssertionError(f"dcn_mesh: ZeRO's CRCs {zr['crc']} and losses "
                             f"{zr['losses']} are not cross_host's "
                             f"{ch['crc']} {ch['losses']}")
    pad = 2 * 4 * DCN_MESH_HOSTS  # two f32 moments of < H padding elements
    for got, full in zip(zr["opt_state_bytes"], ch["opt_state_bytes"]):
        if got > full / DCN_MESH_HOSTS + pad:
            raise AssertionError(f"dcn_mesh: ZeRO optimizer state {got} B a "
                                 f"rank, cross_host {full} B")
    for got, limit in zip(ch["peak_mem_gb"], limits):
        if got > limit:
            raise AssertionError(f"dcn_mesh: peak {got} GB above {limit} GB")
    if any(g > MESH_LOSS_RTOL * abs(m) for g, m in zip(mesh_gap,
                                                      mesh_losses)):
        raise AssertionError(f"dcn_mesh: cross_host losses {ch['losses']} "
                             f"off the mesh phase's (a) {mesh_losses}")
    return {k: sum(p[k] for r in runs.values() for p in r["launches"])
            for k in COUNTERS}


# -- mesh6c: the mesh options of ROADMAP A.6c --------------------------------

# One spawn of MESH_RANKS ranks over {dp: 2, mdl: 2}: (a) TP serving of the
# serve configuration (generate on MESH6C_GEN_ROWS prompts cut to one
# length, rows over dp, MESH6C_GEN_NEW greedy tokens, in bf16 and in f32;
# the serve phase's 8 requests through the plain and the int8 self-draft
# BatchServer, and through the disaggregated tiers: the dp-0 group
# prefills, the dp-1 group decodes, on the f32 KV wire); (b) the
# qlora phase's configuration trained over the mesh for MESH6C_STEPS steps,
# then MESH6C_INT8_NEW greedy tokens of int8 generate under TP; (c) the moe
# phase's configuration with the experts over ep = dp, accum_steps
# MESH6C_ACCUM and the fused cross-entropy (MESH6C_XENT_BLOCK).
MESH6C_MESH = {"dp": 2, "mdl": 2}
MESH6C_GEN_ROWS, MESH6C_GEN_NEW, MESH6C_INT8_NEW = 4, 32, 32
MESH6C_STEPS, MESH6C_ACCUM, MESH6C_XENT_BLOCK = 3, 2, 8192
# (a)'s peak a rank: its blocks of the bf16 params (0.66 GB), the int8
# self-draft's, the caches and a prefill's gathered f32 logits, with room.
MESH6C_SERVE_MEM_GB = 8.0


def _mesh6c_serve_model() -> dict:
    """(a)'s configuration: the serve configuration's widths at half its
    depth (6 of 12 layers, its own weights from the seed). A TP decode
    step waits on host-staged collectives a layer, and the whole script
    shares one time limit."""
    return dict(MODEL_735M, n_layers=MODEL_735M["n_layers"] // 2)
# The attention of a rank's 8 of 16 heads and 2 of 4 kv heads (the serve
# configuration at mdl 2; GQA 4 a kv head): the TP QLoRA training shape
# (forward and backward) and the TP prefill shape (forward), as (b, sq,
# sk, h, hk, causal, window, dtype, d).
MESH6C_CASES = [(TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 8, 2, True, None, BF16,
                 128)]
MESH6C_FWD_CASES = [(1, 512, 512, 8, 2, True, None, BF16, 128)]


def _mesh6c_file() -> Path:
    return (Path(__file__).resolve().parent / "build" / "chip_smoke"
            / "mesh6c_refs.npz")


def _mesh6c_prompts(seed: int, vocab: int) -> np.ndarray:
    """(a)'s generate prompts: 4 of the serve phase's lengths, cut to the
    shortest, as one (4, L) batch."""
    ps = _prompts(seed + 6, MESH6C_GEN_ROWS, vocab)
    n = min(len(p) for p in ps)
    return np.stack([p[:n] for p in ps])


def _flash_heads(fn):
    """fn() with every flash_fwd launch's (q heads, kv heads) recorded and
    the counters zeroed just before and read just after: (fn's result,
    {"launches", "input_copies", "heads", "s"})."""
    fa = importlib.import_module("tpunet_torch.ops.flash_attention")
    launch, heads = fa._launch_fwd, set()

    def rec(q, k, v, causal, window, scale):
        heads.add((int(q.shape[2]), int(k.shape[2])))
        return launch(q, k, v, causal, window, scale=scale)

    fa._launch_fwd = rec
    _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        fa._launch_fwd = launch
    launches, copies = _read_counters()
    return out, {"launches": launches, "input_copies": copies,
                 "heads": sorted(heads), "s": time.perf_counter() - t0}


def _mesh6c_held(mesh, name, model, params, ref, got, plens, cap, per_row,
                 gamma) -> dict:
    """The path under test's half of the tie rule over the mesh: the tp
    group's tokens gathered (every rank must hold the same), and, where
    mdl rank 0's first differ from `ref` ((b, L) numpy), that path's
    logit rows at each first differing column (`_alt_logits` on a
    `_Teacher` of the TP model fed `ref`; every rank of the group runs
    it, since its steps are collective)."""
    from tpunet_torch.parallel import smap

    mine = torch.as_tensor(got, device=DEVICE)
    group = smap.all_gather(mine, "mdl", mesh=mesh).cpu().numpy()
    same = all(np.array_equal(g, group[0]) for g in group)
    cols = _first_divergence(ref, group[0], plens)
    seen = {}
    if cols:
        teacher = _Teacher(model, params, ref, plens, cap, per_row,
                           gamma or 0)
        seen = {r: [x.cpu().numpy() for x in xs] for r, xs in
                _alt_logits(teacher, cols, plens, gamma).items()}
        del teacher
    return {"run": name, "tp_group_equal": same, "cols": cols,
            "seen": seen if mesh.axis_index("mdl") == 0 else {}}


def _server_seqs(model, params, prompts, news, width: int, slots: int,
                 pipeline: int, **kw):
    """A BatchServer of `model` (slots `slots`, the spec phase's max_len)
    on `prompts`, each its `news` greedy tokens, run with `pipeline`
    windows in flight: ((n, width) prompt + tokens, its stats)."""
    from tpunet_torch.models import BatchServer

    srv = BatchServer(model, params, slots=slots, max_len=SPEC_SERVE_MAX_LEN,
                      device=DEVICE, **kw)
    ids = [srv.submit(q, m) for q, m in zip(prompts, news)]
    res = srv.run(pipeline=pipeline)
    seqs = np.zeros((len(prompts), width), np.int32)
    for i, (q, rid) in enumerate(zip(prompts, ids)):
        seqs[i, :len(q) + len(res[rid])] = np.concatenate([q, res[rid]])
    return seqs, srv.stats


def _tp_servers(mesh, model, local, draft, dlocal, ref, prompts, news,
                slots: int, pipeline: int, gamma: int, keep_seqs=False,
                **plain) -> dict:
    """The plain (`plain`: its options) and the int8 self-draft (gamma
    `gamma`) BatchServer over the mesh, each against the one-process
    references `ref` ((n, L) prompt + tokens) with the path's half of the
    tie rule: {"server": row, "spec_server": row}; with `keep_seqs` the
    plain row keeps its (n, L) prompt + tokens under "seqs"."""
    qlens = np.array([len(q) for q in prompts])
    out = {}
    for name, kw, g in (
            ("server", plain, None),
            ("spec_server", dict(draft_model=draft, draft_params=dlocal,
                                 gamma=gamma), gamma)):
        (seqs, st), c = _flash_heads(lambda kw=kw: _server_seqs(
            model, local, prompts, news, ref.shape[1], slots, pipeline,
            **kw))
        cap = SPEC_SERVE_MAX_LEN + (g + 1 if g else 0)
        out[name] = dict(c, stats=st, tokens_per_s=sum(news) / c["s"],
                         **_mesh6c_held(mesh, name, model, local, ref, seqs,
                                        qlens, cap, True, g))
        if keep_seqs and not g:
            out[name]["seqs"] = seqs
        if g:
            out[name]["tokens_per_round"] = (
                st["spec_committed"] / max(st["spec_rounds"], 1))
    return out


def _tp_ties(ranks: list, cfg: dict, seed: int, runs, errors: list,
             part: str, ungated: tuple = ()) -> None:
    """The tie rule's reference half in this process, for the serve rows
    of every mdl-0 rank: `runs(row)` gives {run: (ref, plens, cap,
    per_row)}, the one-process references that run is held to and how a
    `_Teacher` steps them (the batch the references were made from).
    Adds `divergences` to each run's row and an error for a tp group
    whose ranks differ or a divergence that is no tie (a run in
    `ungated` reports its divergences without that error)."""
    from tpunet_torch.models import Transformer

    model = Transformer(compute_dtype=BF16, attn_impl="flash",
                        device="meta", **cfg)
    params = _bf16_checkpoint(seed, cfg)
    for r in ranks:
        s = r["serve"]
        for name, (ref, plens, cap, per_row) in runs(s).items():
            row = s[name]
            row["divergences"] = []
            if not row["tp_group_equal"]:
                errors.append(f"{part} {name}: the ranks of rank "
                              f"{r['rank']}'s tp group differ")
            if s["mdl"] != 0 or not row["cols"]:
                continue
            teacher = _Teacher(model, params, ref, plens, cap, per_row, 0)
            gaps = _ref_gaps(teacher, row["cols"], plens, row["seen"])
            del teacher
            row["divergences"] = [{"row": k, "col": c, "gap": gaps[k][0],
                                   "delta": gaps[k][1]}
                                  for k, c in sorted(row["cols"].items())]
            bad = [d for d in row["divergences"]
                   if not d["gap"] <= d["delta"]]
            if bad and name not in ungated:
                errors.append(f"{part} {name} on {s['coords']}: "
                              f"divergences that are no tie: {bad}")
    del params
    torch.cuda.empty_cache()


def _mesh6c_serve(mesh, path: str, seed: int) -> dict:
    """(a): generate, the plain and the speculative BatchServer over the
    mesh, each against the one-process references of the file the parent
    wrote."""
    from tpunet_torch.models import Transformer, generate, quantize_params

    ref = np.load(_mesh6c_file())
    cfg = _mesh6c_serve_model()
    model = Transformer(compute_dtype=BF16, attn_impl="flash", mesh=mesh,
                        tp_axis="mdl", device="meta", **cfg)
    full = _bf16_checkpoint(seed, cfg)
    local = model.local_params(full)
    draft = model.clone(weight_quant="int8")
    dlocal = draft.local_params(quantize_params(full))
    model32 = Transformer(compute_dtype=torch.float32, attn_impl="flash",
                          mesh=mesh, tp_axis="mdl", device="meta", **cfg)
    local32 = model32.local_params({k: v.float() for k, v in full.items()})
    del full
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dp = mesh.axis_index("dp")
    n = MESH6C_GEN_ROWS // mesh.shape["dp"]
    rows = slice(dp * n, (dp + 1) * n)
    prompt = torch.as_tensor(ref["gen_prompts"][rows], device=DEVICE)
    out = {"dp": dp, "mdl": mesh.axis_index("mdl"),
           "coords": dict(mesh.coords)}
    # C.19: f32 TP decoding is held bitwise to one process's f32 generate.
    gen32, c = _flash_heads(lambda: generate(model32, local32, prompt,
                                             MESH6C_GEN_NEW))
    gen32 = gen32.cpu().numpy()
    diff = np.argwhere(gen32 != ref["gen_ref_f32"][rows])
    out["generate_f32"] = dict(
        c, tokens_per_s=n * MESH6C_GEN_NEW / c["s"],
        bitwise_equal_one_process=not len(diff),
        first_difference=diff[0].tolist() if len(diff) else None)
    del local32
    torch.cuda.empty_cache()
    gen, c = _flash_heads(lambda: generate(model, local, prompt,
                                           MESH6C_GEN_NEW))
    plen = prompt.shape[1]
    out["generate"] = dict(c, tokens_per_s=n * MESH6C_GEN_NEW / c["s"],
                           **_mesh6c_held(
                               mesh, "generate", model, local,
                               ref["gen_ref"][rows], gen.cpu().numpy(),
                               np.full(n, plen), plen + MESH6C_GEN_NEW,
                               False, None))
    prompts = [ref[f"srv_prompt{i}"] for i in range(int(ref["n_srv"]))]
    out.update(_tp_servers(mesh, model, local, draft, dlocal, ref["srv_ref"],
                           prompts, [SPEC_SERVE_NEW] * len(prompts), 8, 1,
                           SPEC_GAMMA, keep_seqs=True))
    out["tiers"] = _mesh6c_tiers(mesh, model, local, prompts)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del local, dlocal
    torch.cuda.empty_cache()
    return out


def _mesh6c_tiers(mesh, model, local, prompts) -> dict:
    """(a)'s tiers part (ROADMAP A.12): the dp-0 group is the prefill tier
    (the Router on its leader, world rank 0) and ships each of `prompts`
    (SPEC_SERVE_NEW greedy tokens) on the f32 KV wire to the dp-1 group,
    which decodes with the plain server's slots and max_len. Each rank:
    its flash launches around the whole part, its role's stats and the
    axes its collectives ran over; rank 0 also the tokens, TTFT/TPOT and
    the wire's bytes."""
    from tpunet_torch import distributed, serve
    from tpunet_torch.parallel import smap

    world = distributed.global_communicator()
    lsock = serve.Router.listen("127.0.0.1:0") if mesh.rank == 0 else None
    port = int(world.broadcast(np.array(
        [lsock.getsockname()[1] if lsock else 0], np.int64), 0)[0])
    dp = mesh.axis_index("dp")
    routers = []

    def prefill_tier():
        pe = serve.PrefillEngine(model, local, max_len=SPEC_SERVE_MAX_LEN,
                                 device=DEVICE)
        if not pe.group.leader:
            pe.follow()
            return {"prefills": pe.stats["prefills"]}
        # Closed after the world barrier: the decode leader, another
        # process, must have read its SHUTDOWN frame before the link goes.
        routers.append(serve.Router(pe, kv_codec="f32"))
        router = routers[0]
        try:
            router.accept_ranks(lsock, 1)
            lsock.close()
            t0 = time.perf_counter()
            ids = [router.submit(q, SPEC_SERVE_NEW) for q in prompts]
            res = router.run(timeout=600)
            wall = time.perf_counter() - t0
        finally:
            router.shutdown()
        toks = np.stack([res[i] for i in ids])
        return dict(_latency(router, int(toks.size), wall),
                    prefills=pe.stats["prefills"], tokens=toks,
                    kv_wire_bytes=sum(serve.kv_wire_bytes(
                        "f32", pe.kv_leaf_shapes(len(q))) for q in prompts))

    def decode_tier():
        kw = dict(slots=8, max_len=SPEC_SERVE_MAX_LEN, device=DEVICE)
        if mesh.axis_index("mdl") == 0:
            worker = serve.connect_decode(f"127.0.0.1:{port}", model, local,
                                          kv_codec="f32", **kw)
            try:
                worker.serve()
            finally:
                worker.close()
        else:
            worker = serve.follow_decode(model, local, **kw)
        return {"decode_stats": dict(worker.stats, **{
            f"srv_{k}": v for k, v in worker.srv.stats.items()})}

    smap.axis_stats_reset()
    got, c = _flash_heads(prefill_tier if dp == 0 else decode_tier)
    world.barrier()
    for router in routers:
        router.close()
    return dict(got, **c, role="prefill" if dp == 0 else "decode",
                axes=sorted(smap.axis_stats()))


def _mesh6c_qlora(mesh, path: str, seed: int) -> dict:
    """(b): the qlora phase's model over the mesh, MESH6C_STEPS fit()
    steps on dp rank d's train batches, then int8 generate under TP."""
    from tpunet_torch.models import (Transformer, generate, graft_base,
                                     init_params, lora_optimizer,
                                     quantize_params)
    from tpunet_torch.parallel import smap
    from tpunet_torch.train import adamw, create_train_state, make_train_step

    base = Transformer(compute_dtype=torch.float32, device="meta",
                       **MODEL_735M)
    qbase = quantize_params(init_params(base, seed=seed, device=DEVICE))
    model = Transformer(compute_dtype=BF16, attn_impl="flash", remat=True,
                        mesh=mesh, tp_axis="mdl", device="meta",
                        **MODEL_735M, **QLORA_OPTIONS)
    params = graft_base(init_params(model, seed=seed + 1, device=DEVICE),
                        qbase)
    state, _ = create_train_state(
        model, seed, None, lora_optimizer(adamw(QLORA_LR), params),
        params=params, device=DEVICE)
    del params
    torch.cuda.empty_cache()
    crc0 = _params_crc(_frozen(state.params))
    step = make_train_step(model)
    dp = mesh.axis_index("dp")
    smap.axis_stats_reset()
    state, out = _fit_measured(state, step, _train_batches(path, dp, seed),
                               MESH6C_STEPS)
    out.update(
        dp=dp, mdl=mesh.axis_index("mdl"), axis=smap.axis_stats(),
        frozen_crc=[crc0, _params_crc(_frozen(state.params))],
        lora_b_off_zero=all(bool(v.detach().abs().max() > 0)
                            for k, v in state.params.items()
                            if k.endswith(".lora_b")))
    del state, step
    torch.cuda.empty_cache()
    qmodel = Transformer(compute_dtype=BF16, attn_impl="flash", mesh=mesh,
                         tp_axis="mdl", weight_quant="int8", device="meta",
                         **MODEL_735M)
    qlocal = qmodel.local_params(qbase)
    del qbase
    n = MESH6C_GEN_ROWS // mesh.shape["dp"]
    prompt = torch.as_tensor(np.load(_mesh6c_file())["gen_prompts"][
        dp * n:(dp + 1) * n], device=DEVICE)
    toks, c = _flash_heads(lambda: generate(qmodel, qlocal, prompt,
                                            MESH6C_INT8_NEW))
    new = toks[:, prompt.shape[1]:]
    out["int8_generate"] = dict(
        c, tokens_per_s=n * MESH6C_INT8_NEW / c["s"],
        shape=list(toks.shape),
        in_vocab=bool(((new >= 0) & (new < model.vocab)).all()),
        first_tokens=new[:, :8].tolist())
    del qlocal
    torch.cuda.empty_cache()
    return out


def _mesh6c_moe(mesh, path: str, seed: int) -> dict:
    """(c): the moe phase's model over the mesh, experts over ep = dp,
    accum_steps and the fused cross-entropy, MESH6C_STEPS fit() steps on
    dp rank d's train batches; each microbatch's aux losses and dropped
    shares recorded (`_record_moe`)."""
    from tpunet_torch.models import Transformer, transformer_partition_rules
    from tpunet_torch.parallel import smap
    from tpunet_torch.train import adamw, create_train_state, make_train_step
    from tpunet_torch.train.trainer import _reduce_groups

    model = Transformer(compute_dtype=BF16, attn_impl="flash", remat=True,
                        mesh=mesh, tp_axis="mdl", device="meta",
                        **MODEL_TRAIN, **MOE_OPTIONS)
    rules = transformer_partition_rules(tp_axis="mdl", ep_axis="dp")
    state, _ = create_train_state(model, seed, None, adamw(TRAIN_LR),
                                  device=DEVICE, rules=rules)
    step = make_train_step(model, moe_aux_weight=MOE_AUX_WEIGHT,
                           accum_steps=MESH6C_ACCUM,
                           fused_xent_block=MESH6C_XENT_BLOCK)
    records, choices = [], []
    _record_moe(records, choices)
    dp = mesh.axis_index("dp")
    smap.axis_stats_reset()
    state, out = _fit_measured(state, step, _train_batches(path, dp, seed),
                               MESH6C_STEPS)
    n_moe = MODEL_TRAIN["n_layers"] // MOE_OPTIONS["moe_every"]
    replicated = _reduce_groups(model, ("dp",)).get(("dp",), set())
    out.update(
        dp=dp, mdl=mesh.axis_index("mdl"), axis=smap.axis_stats(),
        dp_replicated_crc=_params_crc({k: v for k, v in state.params.items()
                                       if k in replicated}),
        expert_shape=list(state.params["block1.moe.wi"].shape),
        aux=[r[0].tolist() for r in records],
        dropped=[r[1].tolist() for r in records],
        choices=choices[:MESH6C_ACCUM * n_moe])
    del state, step
    torch.cuda.empty_cache()
    return out


def _mesh6c_rank_body(rank: int, ports, path: str, seed: int) -> dict:
    """One {dp: 2, mdl: 2} mesh over this spawn's ranks and the parts
    (a), (b), (c) in turn."""
    from tpunet_torch import distributed
    from tpunet_torch.parallel import make_named_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(f"127.0.0.1:{ports[0]}", rank, MESH_RANKS)
    mesh = make_named_mesh(MESH6C_MESH)
    out = {"rank": rank, "seconds": {}}
    for part, fn in (("serve", _mesh6c_serve), ("qlora", _mesh6c_qlora),
                     ("moe", _mesh6c_moe)):
        distributed.global_communicator().barrier()
        t0 = time.perf_counter()
        out[part] = fn(mesh, path, seed)
        out["seconds"][part] = time.perf_counter() - t0
    mesh.close()
    distributed.finalize()
    return out


def _mesh6c_references(seed: int) -> dict:
    """The one-process port on (a)'s inputs: generate's tokens and the
    plain BatchServer's on the serve phase's requests, written to the
    file the ranks read; returns their timings."""
    from tpunet_torch.models import Transformer, generate

    cfg = _mesh6c_serve_model()
    model = Transformer(compute_dtype=BF16, attn_impl="flash",
                        device="meta", **cfg)
    params = _bf16_checkpoint(seed, cfg)
    prompts4 = _mesh6c_prompts(seed, model.vocab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = generate(model, params, torch.as_tensor(prompts4, device=DEVICE),
                   MESH6C_GEN_NEW).cpu().numpy()
    gen_s = time.perf_counter() - t0
    # C.19: the f32 reference, from the same checkpoint widened, on each
    # dp rank's rows (the batch the rank decodes).
    model32 = Transformer(compute_dtype=torch.float32, attn_impl="flash",
                          device="meta", **cfg)
    params32 = {k: v.float() for k, v in params.items()}
    n = MESH6C_GEN_ROWS // MESH6C_MESH["dp"]
    gen32 = np.concatenate([generate(model32, params32, torch.as_tensor(
        prompts4[d * n:(d + 1) * n], device=DEVICE), MESH6C_GEN_NEW
    ).cpu().numpy() for d in range(MESH6C_MESH["dp"])])
    del params32
    prompts = _prompts(seed + 2, 8, model.vocab)
    qlens = np.array([len(q) for q in prompts])
    t0 = time.perf_counter()
    seqs, _ = _server_seqs(model, params, prompts,
                           [SPEC_SERVE_NEW] * len(prompts),
                           max(qlens) + SPEC_SERVE_NEW, 8, 1)
    srv_s = time.perf_counter() - t0
    _mesh6c_file().parent.mkdir(parents=True, exist_ok=True)
    np.savez(_mesh6c_file(), gen_prompts=prompts4, gen_ref=gen,
             gen_ref_f32=gen32, srv_ref=seqs, n_srv=len(prompts),
             **{f"srv_prompt{i}": q for i, q in enumerate(prompts)})
    del params
    torch.cuda.empty_cache()
    return {"generate_tokens_per_s": prompts4.shape[0] * MESH6C_GEN_NEW
            / gen_s, "server_tokens_per_s": len(prompts) * SPEC_SERVE_NEW
            / srv_s, "prompt_len": prompts4.shape[1]}


@torch.no_grad()
def _mesh6c_moe_reference(path: str, seed: int) -> dict:
    """One process, the whole moe model at (c)'s init, no grad: the loss
    of the first step's two global microbatches (the two dp ranks' first
    batches stacked, microbatch j its rows j::2) under make_train_step's
    objective, and each microbatch's aux losses and dropped shares."""
    from tpunet_torch.models import Transformer, init_params
    from tpunet_torch.train.trainer import _as_batch, _make_loss_fn

    model = Transformer(compute_dtype=BF16, attn_impl="flash", device="meta",
                        **MODEL_TRAIN, **MOE_OPTIONS)
    net = model.bind(init_params(model, seed=seed, device=DEVICE))
    batches = [next(_train_batches(path, d, seed))
               for d in range(MESH6C_MESH["dp"])]
    x, y = (torch.cat([_as_batch(b[i], DEVICE) for b in batches])
            for i in (0, 1))
    loss_fn = _make_loss_fn(MESH6C_XENT_BLOCK, moe_aux_weight=MOE_AUX_WEIGHT,
                            model=model)
    records, choices = [], []
    undo = _record_moe(records, choices)
    try:
        losses = [float(loss_fn(net, x[j::MESH6C_ACCUM],
                                y[j::MESH6C_ACCUM]))
                  for j in range(MESH6C_ACCUM)]
    finally:
        undo()
    del net
    torch.cuda.empty_cache()
    return {"loss": float(np.mean(losses)), "microbatch_losses": losses,
            "aux": [r[0].tolist() for r in records],
            "dropped": [r[1].tolist() for r in records], "choices": choices}


def _dropped_count(choices: np.ndarray, cap: int) -> int:
    """The (token, choice)s over capacity when `choices` ((t, k) experts,
    flax's global token order) claim slots choice-major: flax MoeMlp's
    rule, counted in one process."""
    e = MOE_OPTIONS["n_experts"]
    oh = (choices.T.reshape(-1)[:, None] == np.arange(e)).astype(np.int64)
    return int(((np.cumsum(oh, 0) * oh).sum(-1) > cap).sum())


def _mesh6c_ties(ranks: list, seed: int, errors: list) -> None:
    """(a)'s tie rule, the reference's half in this process: each mdl-0
    rank's divergences against the one-process references, gap against
    delta (`_tp_ties`); generate's on the dp rank's rows in lockstep."""
    ref = np.load(_mesh6c_file())
    n = MESH6C_GEN_ROWS // MESH6C_MESH["dp"]
    plen = ref["gen_prompts"].shape[1]
    qlens = np.array([len(ref[f"srv_prompt{i}"])
                      for i in range(int(ref["n_srv"]))])

    def runs(s):
        server = (ref["srv_ref"], qlens, SPEC_SERVE_MAX_LEN, True)
        return {"generate": (ref["gen_ref"][s["dp"] * n:(s["dp"] + 1) * n],
                             np.full(n, plen), plen + MESH6C_GEN_NEW, False),
                "server": server, "spec_server": server}

    # C.19: bf16 TP generate is gated on its tp group's equality alone
    # (its f32 twin is held bitwise); its divergences are reported.
    _tp_ties(ranks, _mesh6c_serve_model(), seed, runs, errors, "(a)",
             ungated=("generate",))


def phase_mesh6c(seed: int, qlora_first_loss: float) -> dict:
    """The mesh options of ROADMAP A.6c on MESH_RANKS ranks; returns the
    flash launches of its three parts, summed over the ranks."""
    t0 = time.perf_counter()
    path = _ramp_data(seed)
    refs = _mesh6c_references(seed)
    ranks, wall = _spawn_ranks("mesh6c", path, seed, MESH_RANKS)
    errors = []
    _mesh6c_ties(ranks, seed, errors)
    layers, serve_layers = (MODEL_735M["n_layers"],
                            _mesh6c_serve_model()["n_layers"])
    n_lens = int(np.load(_mesh6c_file())["n_srv"])
    want = {"generate": serve_layers, "server": n_lens * serve_layers,
            "spec_server": 2 * n_lens * serve_layers}
    for r in ranks:
        s = r["serve"]
        for name, n_fwd in want.items():
            row = s[name]
            if (row["launches"] != {"flash_fwd": n_fwd, "flash_dq": 0,
                                    "flash_dkv": 0} or row["input_copies"]
                    or row["heads"] != [(8, 2)]):
                errors.append(f"(a) {name}: launches {row['launches']} "
                              f"(want {n_fwd} forwards), heads "
                              f"{row['heads']}, copies "
                              f"{row['input_copies']}")
        g32 = s["generate_f32"]
        if not g32["bitwise_equal_one_process"] or (
                g32["launches"] != {"flash_fwd": serve_layers, "flash_dq": 0,
                                    "flash_dkv": 0}
                or g32["heads"] != [(8, 2)] or g32["input_copies"]):
            errors.append(f"(a) f32 generate on {s['coords']}: equal "
                          f"{g32['bitwise_equal_one_process']} (first "
                          f"difference {g32['first_difference']}), launches "
                          f"{g32['launches']}, heads {g32['heads']}")
        t = s["tiers"]
        n_fwd = n_lens * serve_layers if t["role"] == "prefill" else 0
        if (t["launches"] != {"flash_fwd": n_fwd, "flash_dq": 0,
                              "flash_dkv": 0} or t["input_copies"]
                or t["heads"] != ([(8, 2)] if n_fwd else [])
                or t["axes"] != ["mdl"]):
            errors.append(f"(a) tiers on {s['coords']} ({t['role']}): "
                          f"launches {t['launches']} (want {n_fwd} "
                          f"forwards), heads {t['heads']}, copies "
                          f"{t['input_copies']}, collectives over "
                          f"{t['axes']}")
        if t["role"] == "decode" and (
                t["decode_stats"]["srv_kv_adopts"] != n_lens
                or t["decode_stats"]["srv_prefills"]):
            errors.append(f"(a) tiers: decode stats {t['decode_stats']}")
        if s["peak_mem_gb"] > MESH6C_SERVE_MEM_GB:
            errors.append(f"(a): peak {s['peak_mem_gb']} GB above "
                          f"{MESH6C_SERVE_MEM_GB} GB")
        if not s["spec_server"]["tokens_per_round"] > 1:
            errors.append(f"(a) spec_server: "
                          f"{s['spec_server']['tokens_per_round']} tokens "
                          f"a round")
    # (a)'s tiers: the dp-1 group's tokens, reported by the router on rank
    # 0, against the plain mesh server's on the dp-1 ranks; one digest of
    # the finished tokens on both decode ranks.
    ref = np.load(_mesh6c_file())
    qlens = [len(ref[f"srv_prompt{i}"]) for i in range(n_lens)]
    tier_tokens = ranks[0]["serve"]["tiers"]["tokens"]
    decoders = [r for r in ranks if r["serve"]["tiers"]["role"] == "decode"]
    tiers_bitwise = [bool(np.array_equal(
        tier_tokens[i], r["serve"]["server"]["seqs"][
            i, qlens[i]:qlens[i] + SPEC_SERVE_NEW]))
        for r in decoders for i in range(n_lens)]
    crcs = {r["serve"]["tiers"]["decode_stats"]["tokens_crc"]
            for r in decoders}
    if not all(tiers_bitwise) or len(crcs) != 1:
        errors.append(f"(a) tiers: tokens bitwise the dp-1 plain server's "
                      f"{tiers_bitwise}, decode ranks' digests {crcs}")
    # (b) TP QLoRA and int8 generate.
    ql = [r["qlora"] for r in ranks]
    by_dp = {p["dp"]: p["losses"] for p in ql if p["mdl"] == 0}
    q_losses = [float(np.mean(x)) for x in zip(*by_dp.values())]
    q_rel = abs(q_losses[0] - qlora_first_loss) / abs(qlora_first_loss)
    for a in ql:
        if any(a["mdl"] == b["mdl"] and a["crc"] != b["crc"] for b in ql):
            errors.append("(b): the dp replicas of an mdl rank differ")
        if a["frozen_crc"][0] != a["frozen_crc"][1]:
            errors.append(f"(b): a frozen leaf moved on dp {a['dp']} mdl "
                          f"{a['mdl']}")
        if not a["lora_b_off_zero"]:
            errors.append("(b): a lora_b stayed at zero")
        if a["launches"] != _want_launches(1, MESH6C_STEPS) or (
                a["input_copies"]):
            errors.append(f"(b): launches {a['launches']}, copies "
                          f"{a['input_copies']}")
        g = a["int8_generate"]
        if not g["in_vocab"] or g["launches"]["flash_fwd"] != layers or (
                g["heads"] != [(8, 2)] or g["input_copies"]):
            errors.append(f"(b) int8 generate: in vocab {g['in_vocab']}, "
                          f"launches {g['launches']}, heads {g['heads']}")
    if not q_rel <= MESH_LOSS_RTOL or not all(np.isfinite(q_losses)):
        errors.append(f"(b): first loss {q_losses} off the qlora phase's "
                      f"{qlora_first_loss} ({q_rel})")
    # (c) EP MoE with accum_steps and the fused cross-entropy.
    moe_ref = _mesh6c_moe_reference(path, seed)
    mo = [r["moe"] for r in ranks]
    by_dp = {p["dp"]: p["losses"] for p in mo if p["mdl"] == 0}
    m_losses = [float(np.mean(x)) for x in zip(*by_dp.values())]
    m_rel = abs(m_losses[0] - moe_ref["loss"]) / abs(moe_ref["loss"])
    e, d = MOE_OPTIONS["n_experts"], MODEL_TRAIN["d_model"]
    tokens = TRAIN_BATCH * MESH6C_MESH["dp"] // MESH6C_ACCUM * TRAIN_SEQ
    cap = int(np.ceil(MOE_OPTIONS["moe_top_k"] * tokens / e
                      * MOE_OPTIONS["capacity_factor"]))
    buf = e * cap * d * 2   # the (e, cap, d) bf16 dispatch buffer
    # Each MoE layer's routing of a global microbatch: the mdl-0 ranks'
    # choices in dp order (flax's token order), recounted in one process;
    # the one-process forward's own routing, and how many choices differ.
    n_moe = len(moe_ref["dropped"][0])
    firsts = [p["choices"] for p in sorted(
        (p for p in mo if p["mdl"] == 0), key=lambda p: p["dp"])]
    routing = [np.concatenate([c[i] for c in firsts])
               for i in range(MESH6C_ACCUM * n_moe)]
    recount = [[_dropped_count(routing[j * n_moe + i], cap)
                for i in range(n_moe)] for j in range(MESH6C_ACCUM)]
    ref_counts = [[_dropped_count(moe_ref["choices"][j * n_moe + i], cap)
                   for i in range(n_moe)] for j in range(MESH6C_ACCUM)]
    flipped = [[int((np.sort(routing[j * n_moe + i], 1) != np.sort(
        moe_ref["choices"][j * n_moe + i], 1)).any(1).sum())
                for i in range(n_moe)] for j in range(MESH6C_ACCUM)]
    for a in mo:
        if any(a["mdl"] == b["mdl"]
               and a["dp_replicated_crc"] != b["dp_replicated_crc"]
               for b in mo):
            errors.append("(c): the dp replicas of an mdl rank differ")
        dp_ax = a["axis"].get("dp", {})
        ps, ag = dp_ax.get("psum_scatter"), dp_ax.get("all_gather")
        if not ps or not ag or ps["calls"] != ag["calls"] or (
                ps["bytes"] != ps["calls"] * buf
                or ag["bytes"] != ag["calls"] * buf // MESH6C_MESH["dp"]):
            errors.append(f"(c): dp psum_scatter {ps} / all_gather {ag}, "
                          f"want whole (e, cap, d) buffers of {buf} B")
        counts = np.rint(np.array(a["dropped"][:MESH6C_ACCUM])
                         * MOE_OPTIONS["moe_top_k"] * tokens).astype(int)
        if counts.tolist() != recount:
            errors.append(f"(c): dropped choices {counts.tolist()}, the "
                          f"global recount of the ranks' routing {recount}")
        if not np.isfinite(a["aux"]).all() or not all(
                np.isfinite(a["losses"])):
            errors.append("(c): a loss or an aux loss is not finite")
    if not m_rel <= MESH_LOSS_RTOL:
        errors.append(f"(c): first loss {m_losses[0]} off the one-process "
                      f"forward's {moe_ref['loss']} ({m_rel})")
    for r in ranks:
        for name in ("generate", "server", "spec_server"):
            r["serve"][name].pop("seen", None)
        r["serve"]["server"].pop("seqs")
        r["serve"]["tiers"].pop("tokens", None)
        r["moe"].pop("choices")
    moe_ref.pop("choices")
    summary = dict(
        ranks=MESH_RANKS, mesh=MESH6C_MESH, wall_s=time.perf_counter() - t0,
        ranks_wall_s=wall, part_s=[r["seconds"] for r in ranks],
        serve=dict(reference=refs, runs=[r["serve"] for r in ranks],
                   tiers_bitwise_plain_server=all(tiers_bitwise)),
        qlora=dict(steps=MESH6C_STEPS, losses=q_losses,
                   qlora_first_loss=qlora_first_loss, first_loss_rel=q_rel,
                   ranks=ql),
        moe=dict(steps=MESH6C_STEPS, accum_steps=MESH6C_ACCUM,
                 fused_xent_block=MESH6C_XENT_BLOCK, losses=m_losses,
                 reference=moe_ref, first_loss_rel=m_rel, capacity=cap,
                 dispatch_buffer_bytes=buf, dropped_recount=recount,
                 reference_dropped_count=ref_counts,
                 tokens_routed_differently=flipped, ranks=mo),
        card=CARD)
    log("mesh6c", **summary)
    if errors:
        raise AssertionError("mesh6c phase: " + "; ".join(errors))
    launches = {k: 0 for k in COUNTERS}
    for r in ranks:
        for row in (r["serve"]["generate"], r["serve"]["server"],
                    r["serve"]["spec_server"], r["serve"]["tiers"], r["qlora"],
                    r["qlora"]["int8_generate"], r["moe"]):
            for k in COUNTERS:
                launches[k] += row["launches"][k]
    return launches


# The multichip dry run (ROADMAP A.8b): one spawn of DRYRUN_RANKS ranks runs
# (a) tpunet_torch.dryrun's five programs, (b) its transformer program at
# full width and (c) its serve program at full width.
DRYRUN_RANKS = 8
# (b): the transformer program's model at the serve configuration's widths
# (swiglu, as the program's), cut to 4 layers for the script's time: blocks
# 1 and 3 are MoE layers of n_experts = dp = 2, top-2. Global batch 4 x 2048
# over {dp: 2, sp: 2, mdl: 2}: 2 rows of 1,024 tokens a rank, one a
# microbatch.
DRYRUN_MODEL = dict(vocab=32000, d_model=2048, n_layers=4, n_heads=16,
                    n_kv_heads=4, d_ff=8192, mlp_impl="swiglu", moe_every=2)
DRYRUN_BATCH, DRYRUN_SEQ, DRYRUN_STEPS = 4, 2048, 2
# (c): the serve program's mesh and servers (slots 2, the plain one 4 steps
# a call, the self-draft gamma 3, pipeline 2) on the serve configuration
# at mesh6c (a)'s 6 layers with the spec phase's window on the ring cache;
# (prompt tokens, new tokens) of its 3 requests.
DRYRUN_SERVE_MESH = {"dp": 2, "mdl": 4}
DRYRUN_WINDOW, DRYRUN_SLOTS, DRYRUN_GAMMA = 256, 2, 3
DRYRUN_REQUESTS = ((512, 32), (301, 24), (128, 16))
# The rank's prefill attention in (c): 4 of 16 heads, 1 of 4 kv heads.
DRYRUN_FWD_CASES = [(1, 512, 512, 4, 1, True, DRYRUN_WINDOW, BF16, 128)]


def _dryrun_serve_model() -> dict:
    return dict(_mesh6c_serve_model(), attn_window=DRYRUN_WINDOW)


def _dryrun_file() -> Path:
    return (Path(__file__).resolve().parent / "build" / "chip_smoke"
            / "dryrun_refs.npz")


def _dryrun_tokens():
    """(b)'s global batch as the transformer program draws it."""
    toks = np.random.default_rng(0).integers(
        0, DRYRUN_MODEL["vocab"], size=(DRYRUN_BATCH, DRYRUN_SEQ))
    return toks, np.roll(toks, -1, axis=1)


def _dryrun_programs(rank: int, seed: int) -> dict:
    """(a): the five programs as dryrun_multichip's ranks run them; rank 0
    prints their lines."""
    from tpunet_torch import dryrun

    out = dryrun.run_programs(DRYRUN_RANKS, DEVICE,
                              printer=(lambda x: print(x, flush=True))
                              if rank == 0 else None)
    return {"lines": [x for r in out.values()
                      for x in r.get("lines", [r.get("line")])],
            "vgg_loss": out["vgg"]["loss"],
            "transformer_loss": out["transformer"]["loss"],
            "pipeline_losses": out["pipeline"]["losses"],
            "qlora_loss": out["qlora"]["loss"],
            "tokens_per_round": out["serve"]["tokens_per_round"],
            "seconds": {k: r["s"] for k, r in out.items()}}


def _dryrun_transformer(rank: int, seed: int) -> dict:
    """(b): the transformer program at DRYRUN_MODEL's widths."""
    from tpunet_torch import dryrun
    from tpunet_torch.parallel import smap
    from tpunet_torch.train.trainer import _reduce_groups

    def inspect(model, state, step):
        records = []
        undo = _record_moe(records)
        smap.axis_stats_reset()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh = model.mesh
        shared = _reduce_groups(model, model.data_axes())
        over_dp = {k for axes, names in shared.items() if "dp" in axes
                   for k in names}

        def after(state):
            undo()
            return dict(
                coords=dict(mesh.coords), axis=smap.axis_stats(),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                aux=[r[0].tolist() for r in records],
                dropped=[r[1].tolist() for r in records],
                dp_replicated_crc=_params_crc(
                    {k: v for k, v in state.params.items() if k in over_dp}),
                expert_shape=list(state.params["block1.moe.wi"].shape))
        return after

    out = dryrun.transformer(DRYRUN_RANKS, None, DEVICE, cfg=DRYRUN_MODEL,
                             dtype=BF16, batch=DRYRUN_BATCH, seq=DRYRUN_SEQ,
                             steps=DRYRUN_STEPS, inspect=inspect)
    out.pop("line")
    torch.cuda.empty_cache()
    return out


def _dryrun_serve(rank: int, seed: int) -> dict:
    """(c): the plain and the speculative BatchServer over {dp: 2, mdl:
    4}, each against the one-process references of the file the parent
    wrote."""
    from tpunet_torch.models import Transformer, quantize_params
    from tpunet_torch.parallel import make_named_mesh

    ref = np.load(_dryrun_file())
    cfg = _dryrun_serve_model()
    mesh = make_named_mesh(DRYRUN_SERVE_MESH)
    model = Transformer(compute_dtype=BF16, attn_impl="flash", mesh=mesh,
                        dp_axis="dp", tp_axis="mdl", device="meta", **cfg)
    full = _bf16_checkpoint(seed, cfg)
    local = model.local_params(full)
    draft = model.clone(weight_quant="int8")
    dlocal = draft.local_params(quantize_params(full))
    del full
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prompts = [ref[f"prompt{i}"] for i in range(len(DRYRUN_REQUESTS))]
    out = {"coords": dict(mesh.coords), "mdl": mesh.axis_index("mdl"),
           "kv_heads": model.local_kv_heads()}
    out.update(_tp_servers(mesh, model, local, draft, dlocal, ref["ref"],
                           prompts, [m for _, m in DRYRUN_REQUESTS],
                           DRYRUN_SLOTS, 2, DRYRUN_GAMMA, steps_per_call=4))
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del local, dlocal
    mesh.close()
    torch.cuda.empty_cache()
    return out


def _dryrun_rank_body(rank: int, ports, path: str, seed: int) -> dict:
    """The parts (a), (b), (c) in turn on this rank of the spawn."""
    from tpunet_torch import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(f"127.0.0.1:{ports[0]}", rank, DRYRUN_RANKS)
    out = {"rank": rank, "seconds": {}}
    for part, fn in (("programs", _dryrun_programs),
                     ("transformer", _dryrun_transformer),
                     ("serve", _dryrun_serve)):
        distributed.global_communicator().barrier()
        t0 = time.perf_counter()
        out[part] = fn(rank, seed)
        out["seconds"][part] = time.perf_counter() - t0
    distributed.finalize()
    return out


def _dryrun_references(seed: int) -> dict:
    """The one-process port on (c)'s requests through the plain
    BatchServer, written to the file the ranks read; returns its
    tokens/s."""
    from tpunet_torch.models import Transformer

    cfg = _dryrun_serve_model()
    model = Transformer(compute_dtype=BF16, attn_impl="flash",
                        device="meta", **cfg)
    params = _bf16_checkpoint(seed, cfg)
    rng = np.random.default_rng(seed + 20)
    prompts = [rng.integers(0, model.vocab, n).astype(np.int32)
               for n, _ in DRYRUN_REQUESTS]
    news = [m for _, m in DRYRUN_REQUESTS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs, _ = _server_seqs(model, params, prompts, news,
                           max(n + m for n, m in DRYRUN_REQUESTS),
                           DRYRUN_SLOTS, 2, steps_per_call=4)
    wall = time.perf_counter() - t0
    _dryrun_file().parent.mkdir(parents=True, exist_ok=True)
    np.savez(_dryrun_file(), ref=seqs,
             **{f"prompt{i}": q for i, q in enumerate(prompts)})
    del params
    torch.cuda.empty_cache()
    return {"server_tokens_per_s": sum(news) / wall}


def _dryrun_transformer_reference() -> dict:
    """One process, (b)'s whole model from the program's init (seed 0):
    DRYRUN_STEPS steps of the program's own step (adamw 1e-3 with no
    weight decay, accum_steps 2) on the global batch, whose microbatches
    are the mesh's global ones (rows j::2). Returns each step's loss and
    the first step's microbatches' aux losses and dropped shares."""
    from tpunet_torch.models import Transformer
    from tpunet_torch.train import adamw, create_train_state, make_train_step

    dp = DRYRUN_RANKS // 4
    model = Transformer(compute_dtype=BF16, attn_impl="flash", device="meta",
                        n_experts=dp, moe_top_k=2, **DRYRUN_MODEL)
    tx = adamw(1e-3, weight_decay=0.0)
    state, _ = create_train_state(model, 0, None, tx, device=DEVICE)
    step = make_train_step(model, tx, accum_steps=2)
    x, y = (torch.as_tensor(a, device=DEVICE) for a in _dryrun_tokens())
    records, losses = [], []
    undo = _record_moe(records)
    try:
        for _ in range(DRYRUN_STEPS):
            state, loss = step(state, x, y, 1)
            losses.append(float(loss))
    finally:
        undo()
    del state, step
    torch.cuda.empty_cache()
    return {"losses": losses, "aux": [r[0].tolist() for r in records[:2]],
            "dropped": [r[1].tolist() for r in records[:2]]}


def phase_dryrun(seed: int) -> dict:
    """The multichip dry run on DRYRUN_RANKS ranks of this card; returns
    the flash launches of (c)'s servers, summed over the ranks."""
    t0 = time.perf_counter()
    refs = _dryrun_references(seed)
    ranks, wall = _spawn_ranks("dryrun", "", seed, DRYRUN_RANKS)
    errors = []
    # (a) the five programs: every rank ran them to the end (each raises as
    # its JAX counterpart does); rank 0 printed the lines.
    lines = ranks[0]["programs"]["lines"]
    if len(lines) != 6 or not all(x.startswith("dryrun_multichip OK: ")
                                  for x in lines):
        errors.append(f"(a): lines {lines}")
    # (b) the transformer program at full width, each step's loss against
    # one process's same steps.
    ref = _dryrun_transformer_reference()
    tr = [r["transformer"] for r in ranks]
    rel = [abs(a - b) / abs(b) for a, b in zip(tr[0]["losses"],
                                                ref["losses"])]
    if not all(r <= MESH_LOSS_RTOL for r in rel):
        errors.append(f"(b): losses {tr[0]['losses']} off one process's "
                      f"{ref['losses']} ({rel})")
    for a in tr:
        if not all(np.isfinite(a["losses"])):
            errors.append(f"(b): losses {a['losses']} on {a['coords']}")
        same = [b for b in tr if {k: v for k, v in b["coords"].items()
                                  if k != "dp"} == {k: v for k, v in
                                                    a["coords"].items()
                                                    if k != "dp"}]
        if any(b["dp_replicated_crc"] != a["dp_replicated_crc"]
               for b in same):
            errors.append(f"(b): the dp replicas of {a['coords']} differ")
    # (c) the serve program at full width.
    ref_seqs = np.load(_dryrun_file())["ref"]
    qlens = np.array([n for n, _ in DRYRUN_REQUESTS])
    server = (ref_seqs, qlens, SPEC_SERVE_MAX_LEN, True)
    _tp_ties(ranks, _dryrun_serve_model(), seed,
             lambda s: {"server": server, "spec_server": server}, errors,
             "(c)")
    layers = _dryrun_serve_model()["n_layers"]
    n_req = len(DRYRUN_REQUESTS)
    want = {"server": n_req * layers, "spec_server": 2 * n_req * layers}
    for r in ranks:
        s = r["serve"]
        if s["kv_heads"] != 1:
            errors.append(f"(c): {s['kv_heads']} kv heads a rank")
        for name, n_fwd in want.items():
            row = s[name]
            if (row["launches"] != {"flash_fwd": n_fwd, "flash_dq": 0,
                                    "flash_dkv": 0} or row["input_copies"]
                    or row["heads"] != [(4, 1)]):
                errors.append(f"(c) {name}: launches {row['launches']} "
                              f"(want {n_fwd} forwards), heads "
                              f"{row['heads']}, copies "
                              f"{row['input_copies']}")
    for r in ranks:
        for name in ("server", "spec_server"):
            r["serve"][name].pop("seen", None)
    summary = dict(
        ranks=DRYRUN_RANKS, wall_s=time.perf_counter() - t0,
        ranks_wall_s=wall, part_s=[r["seconds"] for r in ranks],
        programs=ranks[0]["programs"],
        transformer=dict(model=DRYRUN_MODEL, batch=DRYRUN_BATCH,
                         seq=DRYRUN_SEQ, steps=DRYRUN_STEPS,
                         reference=ref, loss_rel=rel, ranks=tr),
        serve=dict(mesh=DRYRUN_SERVE_MESH, requests=DRYRUN_REQUESTS,
                   reference=refs, runs=[r["serve"] for r in ranks]),
        card=CARD)
    out = _dryrun_file().with_name("dryrun.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, default=str))
    log("dryrun", **{k: v for k, v in summary.items()
                     if k not in ("transformer", "serve")},
        transformer_losses=tr[0]["losses"],
        reference_losses=ref["losses"], loss_rel=rel,
        step_s=[a["step_s"] for a in tr],
        peak_mem_gb=[a["peak_mem_gb"] for a in tr],
        dropped=tr[0]["dropped"],
        serve_tokens_per_s={n: [r["serve"][n]["tokens_per_s"] for r in ranks]
                            for n in want},
        serve_divergences={n: [r["serve"][n]["divergences"] for r in ranks]
                           for n in want},
        tokens_per_round=[r["serve"]["spec_server"]["tokens_per_round"]
                          for r in ranks])
    if errors:
        raise AssertionError("dryrun phase: " + "; ".join(errors))
    launches = {k: 0 for k in COUNTERS}
    for r in ranks:
        for name in want:
            for k in COUNTERS:
                launches[k] += r["serve"][name]["launches"][k]
    return launches


# The paths of the other kernel routes, each a user's training run through
# the trainer's entry points (create_train_state, make_train_step; adamw,
# no remat) for PATH_STEPS steps on one batch of random tokens, held to the
# same steps with the reference attention: "wide" is a bf16 GQA-4 model of
# head dim 320 (the wide kernels), "f32" an f32 model of the training
# configuration's widths at one training rank's batch (head dim 128, the
# f32 CUDA-core kernels: the f32 training-shape kernel case). Depth cut to
# 2 layers. Every launch on a path runs that path's route, so the entry
# points' counters, zeroed just before it, count the route. (model, dtype,
# batch x seq.)
MODEL_WIDE = dict(vocab=32000, d_model=1280, n_layers=2, n_heads=4,
                  n_kv_heads=1, d_ff=5120, mlp_impl="gelu")
PATHS = {"wide": (MODEL_WIDE, BF16, (2, 1024)),
         "f32": (dict(MODEL_TRAIN, n_layers=2), F32,
                 (TRAIN_BATCH, TRAIN_SEQ))}
PATH_STEPS = 2
# The largest difference of a step's loss between the flash and the
# reference attention: bf16 attention rounds P and dS (and the reference
# its own operands) at 8 bits; f32 differs by summation order only. Each
# path also runs once with a planted fault (_planted_path_fault), whose
# loss difference must read above the limit.
PATH_LOSS_TOL = {BF16: 2e-2, F32: 1e-4}
# The wide path's attention shape as kernel cases, in each dtype, with its
# head count: (b, sq, sk, h, hk, causal, window, dtype, d).
PATH_CASES = [(b, s, s, MODEL_WIDE["n_heads"], MODEL_WIDE["n_kv_heads"],
               True, None, dt, MODEL_WIDE["d_model"] // MODEL_WIDE["n_heads"])
              for b, s in [PATHS["wide"][2]] for dt in (BF16, F16, F32)]


def _kernel_cases(cases, forward: bool = False) -> list:
    """PATH_CASES, then `cases` with their 16 q heads, then MESH_CASES and
    MESH6C_CASES (and, for the forward, MESH6C_FWD_CASES and
    DRYRUN_FWD_CASES), as (b, sq, sk, h, hk, causal, window, dtype, d)."""
    return (PATH_CASES + [(b, sq, sk, 16, *rest) for b, sq, sk, *rest in cases]
            + MESH_CASES + MESH6C_CASES
            + (MESH6C_FWD_CASES + DRYRUN_FWD_CASES if forward else []))


def _path_losses(cfg, dt, shape, impl, seed) -> list:
    from tpunet_torch.models import Transformer
    from tpunet_torch.train import adamw, create_train_state, make_train_step

    model = Transformer(compute_dtype=dt, attn_impl=impl, device="meta",
                        **cfg)
    state, _ = create_train_state(model, seed, None, adamw(TRAIN_LR),
                                  device=DEVICE)
    step = make_train_step(model)
    x = np.random.default_rng(seed).integers(0, cfg["vocab"], shape)
    y = np.roll(x, -1, axis=1)
    losses = []
    for i in range(PATH_STEPS):
        state, loss = step(state, x, y, i)
        losses.append(float(loss))
    del state
    torch.cuda.empty_cache()
    return losses


@contextlib.contextmanager
def _planted_path_fault():
    """The flash backward with a planted dQ fault: every q head gets the
    next q head's dQ (a head index off by one), so the loss check of a
    path must see it."""
    fa = importlib.import_module("tpunet_torch.ops.flash_attention")
    launch = fa._launch_dq
    fa._launch_dq = lambda *a: launch(*a).roll(1, dims=2)
    try:
        yield
    finally:
        fa._launch_dq = launch


def phase_paths(seed: int) -> dict:
    """The wide and f32 paths; returns {entry: launches}, counted over each
    path's flash run (every counter zeroed just before it, read just
    after)."""
    launches = {}
    for name, (cfg, dt, shape) in PATHS.items():
        ref = _path_losses(cfg, dt, shape, "reference", seed)
        _zero_counters()
        got = _path_losses(cfg, dt, shape, "flash", seed)
        torch.cuda.synchronize()
        counts, copies = _read_counters()
        counts = {f"{e}_{name}": n for e, n in counts.items()}
        with _planted_path_fault():
            bad = _path_losses(cfg, dt, shape, "flash", seed)
        err = max(abs(a - b) for a, b in zip(got, ref))
        fault = max(abs(a - b) for a, b in zip(bad, ref))
        log("paths", path=name, model=cfg, dtype=str(dt), batch_seq=shape,
            head_dim=cfg["d_model"] // cfg["n_heads"], steps=PATH_STEPS,
            losses=got, reference_losses=ref, max_loss_err=err,
            tol=PATH_LOSS_TOL[dt], planted_dq_fault_loss_err=fault,
            launches=counts, input_copies=copies)
        want = PATH_STEPS * cfg["n_layers"]
        if not (np.isfinite(got).all() and err <= PATH_LOSS_TOL[dt]):
            raise AssertionError(f"{name} path: losses {got} differ from "
                                 f"the reference attention's {ref}")
        if not fault > PATH_LOSS_TOL[dt]:
            raise AssertionError(f"{name} path: the loss check cannot see "
                                 f"a planted dQ fault ({fault})")
        if any(n != want for n in counts.values()) or copies:
            raise AssertionError(f"{name} path: launches {counts} (want "
                                 f"{want} each), input copies {copies}")
        launches.update(counts)
    return launches


def _kernel_entry(name, source, replaces, launches, row, err_key) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row[err_key], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_backend": row["library_backend"],
            "tensor_core_instrs": _tensor_core_instrs(name)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import tpunet_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}

    def timed(fn, *a):
        """fn(*a), its seconds kept under the phase's name."""
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            seconds[fn.__name__.removeprefix("phase_")] = (
                time.perf_counter() - t0)

    seed = args.seed
    timed(phase_card)
    timed(phase_build)
    fwd_rows = timed(phase_kernels, seed)
    bwd_rows = timed(phase_bwd_kernels, seed)
    params = timed(phase_model, seed)
    timed(phase_serve, seed, params)
    timed(phase_swap, seed, params)
    timed(phase_spec, seed, params)
    del params
    torch.cuda.empty_cache()
    launches = timed(phase_paths, seed)
    train_launches, train = timed(phase_train, seed)
    launches.update(train_launches)
    timed(phase_elastic, seed, train)
    timed(phase_zero, seed, train)
    timed(phase_remat, seed)
    vgg = timed(phase_vgg, seed)
    by_path = {"train": train_launches, "moe": timed(phase_moe, seed)}
    by_path["qlora"], qlora_first_loss = timed(phase_qlora, seed)
    timed(phase_a2a, seed)
    by_path["sp"] = timed(phase_sp, seed)
    by_path["pipe"] = timed(phase_pipe, seed)
    by_path["mesh"], mesh_losses = timed(phase_mesh, seed, train, vgg)
    by_path["dcn_mesh"] = timed(phase_dcn_mesh, seed, train, mesh_losses)
    by_path["mesh6c"] = timed(phase_mesh6c, seed, qlora_first_loss)
    by_path["dryrun"] = timed(phase_dryrun, seed)
    log("seconds", **seconds)
    src = "tpunet_torch/csrc/"
    rows = {**fwd_rows, **bwd_rows}
    kernels = []
    for route in ("", "_f32", "_wide"):
        for kernel, source, line, err_key in (
                ("flash_fwd", "flash_fwd.cu", 73, "err_o"),
                ("flash_dq", "flash_bwd.cu", 136, "max_abs_err"),
                ("flash_dkv", "flash_bwd.cu", 183, "max_abs_err")):
            name = kernel + route
            entry = _kernel_entry(
                name, src + source, f"tpunet/ops/flash_attention.py:{line}",
                launches[name], rows[name], err_key)
            if not route:
                entry["launches_by_path"] = {
                    path: counts[name] for path, counts in by_path.items()}
            kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
