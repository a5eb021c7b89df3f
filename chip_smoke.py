"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's eleven CUDA kernels from ``src/repro_torch/kernels/csrc``
with nvcc (one nvcc per source, all started together), then drives the
paths of the port below, each with every launch counter zeroed just before
it and read just after it:

1. dense serve phase — llama-7b at full width cut to ``LLAMA_DEPTH`` (16)
   of its 32 layers in bf16 (random weights from a seeded generator) behind
   the port's ``ServingEngine``: the default ``EngineConfig`` but
   ``max_slots=4, max_len=4096, cost_arch="llama-7b"`` (every plan and
   modelled time is the whole model's, while the host store moves half its
   bytes and bills storage on them), H100 ``PerfModel`` and prices,
   ``CostAwarePlanner``.
   Phases 1-10 serve this cut.  Two ~2,000-token
   contexts arrive in four waves of two requests: the first recomputes and
   writes back, the second loads, the third loads one context and partially
   reuses a variant of the other, the fourth loads one context twice.  The
   same traffic is then served with reuse off, and each reused request's
   first-token logits are held against it.
2. paged serve phase — the same traffic through ``EngineConfig(
   paged_decode=True, kv_block=128)``, after the dense engines are dropped:
   the same actions, first-token logits and every decode step's logits as
   the dense run, bit for bit, 16 paged-decode launches per decode step and
   no dense-decode launch; the fourth wave's two loads share the stored
   context's full pool blocks.  Then one copy-on-write split, built by hand
   (engine traffic never needs one: the shared blocks lie below every
   decode write), is copied on the card and held bit for bit.
3. unified serve phase — the same traffic through ``EngineConfig(
   paged_decode=True, unified_step=True, kv_block=128)``: every step is one
   launch over the pool that mixes decode rows with 128-token prefill
   chunks (16 chunked-prefill launches per mixed step, none of the packed
   kernel), or a paged decode step when no chunk is ready.  The same
   actions as the paged run, first-token logits within ``LOGIT_ATOL`` of
   it, and its tokens, but where a request's tokens first part, the paged
   run's logits there must be a near-tie (top two within ``LOGIT_ATOL``).
4. per-request prefill phase — ``ModelApi.prefill`` of each request's
   context and prompt into a fresh batch-1 state (16 flash launches per
   call), held against the engine's first-token logits of the recompute
   run; then one load request's stored context inserted into a fresh slot
   and its prompt suffix-prefilled after it (twice), held against the reuse
   run.
5. fused reuse phase — a RAG mix over eight 256-token documents (wave 0
   asks in the stored order and is recomputed and written back; wave 1
   asks twice with the documents permuted, once with one document
   swapped for a fresh one) behind ``BlendPlanner(recompute_frac=0.16,
   always=True)`` and ``fusion_enabled=True``, served with dense decode,
   with paged decode (16 fused-prefill launches per fused admission, the
   reused rows of each launch's buffer equal before and after it), and
   with the unified step (the fused streams land through the chunked
   kernel, no fused launch), each fused serve's first-token logits within
   ``FUSED_LOGIT_ATOL`` of the dense one's; one fused admission's launch
   rebuilt from the store held against the dense serve's logits within
   ``FUSED_LOGIT_ATOL``, and the same launch with delta-RoPE skipped (the
   control) outside it; then once with reuse off, the token agreement
   reported (r < 1 approximates, so it is not gated); and at r = 1.0
   ``lm.prefill_fused`` held against ``lm.prefill`` of the same sequence
   within ``FUSED_LOGIT_ATOL``.
6. compressed (int8) tier phase — the prefix mix again with
   ``compress_tier="io2"`` (the default write-back tier), under dense decode
   and under ``paged_decode=True, unified_step=True``: every write-back is
   quantised on the card (2 ``kv_quant`` launches, K and V) and every fetch
   dequantised there (2 ``kv_dequant`` launches); each stored entry is int8
   rows and f32 scales, (hd + 4) / (2 hd) of the uncompressed entry; every
   request that loaded uncompressed loads here; the attention launch counts
   equal the uncompressed serve's; the loads' first-token logits lie within
   ``COMPRESSED_LOGIT_ATOL`` of the uncompressed serve's.  Then, against
   the dense serve's store: context A's int8 rows and scales equal
   ``kv_quant_plain`` of the uncompressed serve's stored rows of A, bit for
   bit, and dequantised to f32 lie within half a scale of them; wave 1's
   loads rebuilt as one packed launch over the stored int8 rows give the
   served logits, and the control, the same rebuild with every scale
   doubled, lands outside ``COMPRESSED_LOGIT_ATOL``.
7. fault and latency-hiding phase — the prefix mix again on the cut
   llama, under faults, then under the latency-hiding options.  A faulted
   serve with dense decode (``FaultInjector(seed=7,
   fail_rate=0.4, corrupt_rate=0.2)``, ``RetryPolicy(max_attempts=2,
   cost_aware=False)``, a brownout of the write-back tier over the last
   wave): some fetch attempts fail; the drained stream's ``FetchFailed`` and
   ``DegradedToRecompute`` events count what ``fault_stats()`` counts; every
   degraded request is recorded as a recompute; the last wave plans
   recomputes and attempts no fetch; every request's first-token logits lie
   within ``LOGIT_ATOL`` of the fault-free dense serve's.  A latency-hiding
   serve (``overlap_load=True``, ``hedge=HedgePolicy(threshold_s=0.1)``,
   ``prefetch_lookahead=4``, ``migration_interval_s=0.5``): the dense
   serve's tokens where both loaded from the same batch, each
   ``KVLoaded.load_s`` equal to ``max(0, delay - prefill_s)`` of its
   admission, at least one admission whose store read the hedge cut and
   whose ``KVLoaded`` delay before the overlap lies below the unhedged
   read, at least one ``TierMigrated``, and a modelled mean TTFT below
   the dense serve's.  The same options once more under
   ``paged_decode=True, unified_step=True`` (the chunked kernel; the
   unified intake charges the whole fetch, as in the reference), held to
   the unified serve the same way; and once more with dense decode and
   ``admit_batch=1``, where each wave's second request waits a step, so its
   fetch is prefetched and its trie walk carried to its admission.  Each
   serve's step wall times on the
   card are logged beside the modelled ones.  Then one Fig. 2(a) row from
   the port's simulator (host code), printed, not gated.
8. cluster phase — the prefix mix through ``ServingCluster`` on the cut
   llama (dense decode, ``CostAwarePlanner``, H100 prices and
   ``PerfModel``), the replicas' steps timed on the card beside the
   modelled ones.  One replica behind ``AffinityRouter`` on the dense
   serve's tiers replays the dense serve: actions, matched tokens, tokens,
   first-token logits bit for bit, every record field and the summary
   within 1e-9, the same launch counts.  Two replicas behind the affinity
   router, each with ``host_dram`` and one shared, deduplicating ``s3``
   (write-backs land there) and a gossip tick every half modelled second:
   one ``RequestRouted`` per request before the landing replica's
   admission, every request routed on a digest hit finding that many tokens
   stored, no ``FetchFailed``, first-token logits within ``LOGIT_ATOL`` of
   the dense serve's.  Two replicas behind ``RoundRobinRouter``, replica 1
   crashing halfway through its decode of request 7 (which recomputes
   context A and writes it back, a dedup hit): one ``ReplicaCrashed`` with
   work harvested, its released keys the ones that left the core, none
   left under ``r1:``, replica 0's s3 entries readable, every request
   recorded once, logits within ``LOGIT_ATOL`` and the dense serve's
   tokens up to a near-tie.  The affinity serve counts 4 reuse hits and
   the round-robin serve 5, the counts the reference cluster gives on this
   mix (affinity's ring owner is full when wave 3 arrives).  The two-replica
   serves run with ``obs.Telemetry`` and a JSONL ``TraceWriter``: the
   ledger conserves against each replica's summary at 1e-9, the telemetry
   sees each ``RequestRouted`` and ``ReplicaCrashed`` exactly once, and the
   trace's per-replica audit equals the live one.
9. telemetry phase — the dense serve of phase 1 once more with
   ``obs.Telemetry`` and a JSONL trace on: tokens, records, summary and
   launch counts equal to the dense serve's, first-token logits bit for
   bit; the ledger conserves at 1e-9; the trace read back gives the
   summary (1e-9), the audit rows and the span trees of the live stream.
   It logs the console dashboard, the trace's events and bytes,
   telemetry's own host ms per step (``on_events`` and the trace write)
   and each step's card wall beside the dense serve's.
10. market phase — four tenants of one ``Marketplace(verify_rate=1.0,
   seed=0)`` on the cut llama (dense decode, H100 ``PerfModel`` and
   prices), each behind ``MarketPlanner(AlwaysReusePlanner())``, with
   ``MARKET_NEW_TOKENS`` decode tokens a request.  Seller ``s`` recomputes
   the prefix mix's contexts A, B and B's variant and writes them back;
   buyer ``b``'s first A request buys A from ``s`` (one ``KVPurchased``,
   one ``SellerVerified(ok=True, deep=True)``; the spot check's
   ``lm.prefill`` adds one ``flash_attention`` launch per layer, the only
   ones of the serve, and the first layer's inputs are kept for the kernel
   phase) with first-token logits within ``LOGIT_ATOL`` of the same request
   served with reuse off, and its second A request loads the absorbed entry
   locally; the settlement conserves at 1e-9, ``b``'s account is minus its
   spend, and ``s``'s stored A still hashes to its catalog stamp.  A seller
   under ``paged_decode=True, unified_step=True, kv_block=128`` stores the
   same three contexts through the chunked kernel.  Seller ``t``, armed
   through ``arm_adversary`` to corrupt every delivery, sells a 512-token
   context C to buyer ``u``: ``SellerVerified(ok=False)``,
   ``SellerBlacklisted``, ``DegradedToRecompute(reason=
   "market:verify_failed")``, nothing settled, and ``u``'s tokens and
   first-token logits those of C served with reuse off.  Then the spot
   check's readings: every honest artifact (A, B and the variant from both
   sellers, C from ``t``) under its own tokens must lie within the bf16
   ``SPOT_CHECK_TOL``, and each of A's and B's rows under the other's
   tokens (the controls) at least ten times above it.  A witness logs where
   A's honest reading comes from: the bought rows and the kernel's fresh
   rows against a fresh side with plain attention and one computed in f32.
   It logs the phase's wall and each step's card wall beside the modelled
   step.
11. the serving launcher — ``repro_torch.launch.serve`` with ``--requests 8
   --contexts 2 --policy always --compress --json`` (reduced compute,
   full-size economics) on the card: int8 launches and at least four reuse
   hits; then with ``--overlap --hedge``.
12. SSM serve phase — after the llama engines and weights are freed,
   full-width, full-depth mamba2-1.3b in bf16 (random weights from a seeded
   generator) serves the prefix mix behind the same ``ServingEngine``
   settings, H100 ``PerfModel`` and prices and ``CostAwarePlanner``.  It
   cannot be packed, so every admission runs through ``ModelApi.prefill``
   one request per step: wave 0 recomputes A and B in two phases (context,
   write-back of the ~100 MB state, prompt), waves 1 and 3 load, wave 2
   loads A and recomputes B's variant (never ``partial``: SSM state is all
   or nothing).  ``ssd_chunked`` launches 48 times per prefill call and no
   attention or int8 kernel launches.  Each load's first-token logits lie
   within ``SSM_LOGIT_ATOL`` of the same request served with reuse off,
   and the control, the same load with the stored SSD state zeroed (conv
   tail kept), lands outside it; one load rebuilt by hand from the stored
   artifact (``insert_slot``, then ``prefill`` of the prompt) repeats the
   engine's load and is held to its own ``SSM_REBUILD_ATOL``;
   ``ModelApi.prefill`` of a request's context and prompt in one call
   agrees with the engine's recompute; and
   the same traffic with ``paged_decode=True`` keeps the dense decode
   (``decode_stats()["paged"]`` False) with the dense run's tokens.
13. other families — after the mamba2 engines and weights are freed, the
   prefix mix behind the same ``ServingEngine`` settings, H100 ``PerfModel``
   and prices and ``CostAwarePlanner`` on two more full-width, full-depth
   bf16 archs with random weights from a seeded generator.  First
   mistral-nemo-12b (40 layers, d_model 5120, 32 query heads of width 128 on
   8 kv heads: H·hd 4096 against d_model 5120), served dense with reuse on
   and off: each reused request's first-token logits within ``LOGIT_ATOL``
   of reuse off.  It is freed, then olmoe-1b-7b (16 layers, d_model 2048,
   64 experts of width 1024, top-8, capacity factor 1.25) serves the mix
   dense, paged (``paged_decode=True``), unified (``unified_step=True``) and
   with reuse off.  The MoE FFN routes each launch's T tokens, padding
   included, into experts of capacity C (``moe.expert_capacity``); for each
   admission launch the phase logs T, C, the MoE FFN's card time and the
   pairs dropped in each layer, real tokens' apart from padding's (decode
   launches, T = 4 and C = 8, can drop none).  The same actions in all three
   serves, the paged serve's tokens equal to the dense serve's, and each
   serve's reused requests' first-token logits within ``LOGIT_ATOL`` of
   reuse off, except a request whose tokens lost pairs on either side,
   which is logged beside its drops, not gated.  With random weights the
   router sends most tokens to a few experts, so at 1.25 nearly every
   request loses pairs: the same weights then serve dense, unified and with
   reuse off at the dropless capacity factor n_experts / top_k (C >= T),
   where no pair may drop and every reused request is gated.
14. sliding window — after the olmoe weights are freed, mixtral-8x22b at
   full width (d_model 6144, 48 query heads of width 128 on 8 kv heads, 8
   experts of width 16384, top-2, vocabulary 32768) in bf16 with random
   weights from a seeded generator, cut to ``SWA_DEPTH`` (8) of its 56
   layers: one layer holds ~2.5 B parameters (~5.0 GB), so eight layers,
   the embedding and the head take ~41 GB and the whole model (~282 GB) does
   not fit the card.  The serves run at the dropless capacity factor
   n_experts / top_k = 4.  The ring serve: ``max_len=8192``, so the slotted
   cache is a ring of 4,096 rows (the window) and the arch is not packable:
   every admission runs through ``ModelApi.prefill``, one request per step,
   and decode is dense.  Two 6,000-token contexts A and B arrive in four
   waves (``swa_traffic``): wave 0 recomputes and writes back, wave 1
   loads both, wave 2 sends A extended by 256 tokens (``partial``, all 6,000
   stored tokens matched) and a variant of B sharing its first 1,600
   tokens (recomputed: a partial match below the stored length of a
   wrapped ring cannot be served, ROADMAP C11), wave 3 loads A twice; then
   the decode steps, every one writing past the ring's wrap.  The plans
   are ``SWA_PLANS``; 8 ``flash_attention`` launches per ``prefill`` call,
   8 ``decode_attention`` launches per decode step and no other kernel; A's
   and B's stored artifacts each hold 4,096 rows a layer (134,217,728 bytes
   of K/V).  The same traffic with reuse off: each reused request's
   first-token logits within ``LOGIT_ATOL`` of it, and the control, B's
   variant rebuilt the reference's way (rows ``[:1600]`` of B's wrapped
   ring inserted as positions 0-1,599, its suffix prefilled after them),
   outside it.  Then the packable serves at ``max_len=4096`` (the window):
   the prefix mix of phase 1 dense, unified and with reuse off, the same
   actions and reused logits within ``LOGIT_ATOL`` of reuse off, and once
   more dense at the capacity factor 1.25 with each launch's T, C and drops
   logged, not gated (ROADMAP C10).
15. hybrid — after the mixtral weights are freed, jamba-1.5-large-398b at
   full width (d_model 8192; Mamba layers of 128 SSD heads of width 128,
   d_state 16, one group, d_inner 16,384; an attention layer of 64 query
   heads of width 128 on 8 kv heads with no positional embedding; MoE of 16
   experts of width 24,576, top-2, on every other layer; vocabulary 65,536)
   in bf16 with random weights from a seeded generator, cut to
   ``HYBRID_CUT``: Jamba's first five layers as a period of their own, four
   Mamba layers (MoE on the second and fourth) then the attention layer,
   23.98 B parameters (44.67 GiB); one whole 8-layer period (84.05 GiB)
   does not fit the card.  ``PerfModel`` models the cut.  The prefix mix of
   phase 1 at the dropless capacity factor n_experts / top_k = 8: the stack
   cannot be packed, so every admission runs through ``ModelApi.prefill``
   one request per step (4 ``ssd_chunked`` and 1 ``flash_attention`` launch
   a call) and decode is dense (1 ``decode_attention`` launch a step), no
   other kernel; the plans are mamba2's (``SSM_ACTIONS``: loads, B's variant
   recomputed, no partial reuse from SSM state).  The stored artifact of A
   holds the attention layer's K/V (4,096 bytes a token) and four Mamba
   states (f32 SSD and bf16 conv tail, 1,147,072 bytes each), logged beside
   the cost model's ``s_storage_bytes``, which prices the state at 2 bytes
   an element.  With reuse off: each load's first-token logits within
   ``LOGIT_ATOL`` of it; one load rebuilt from the store repeats the served
   one within ``SSM_REBUILD_ATOL``; the control, that load with every
   stored SSD state zeroed, outside ``LOGIT_ATOL``.  Then once more at the
   capacity factor 1.25, each launch's T, C and drops logged, not gated.
16. MQA and the GELU MLP — after the jamba weights are freed, granite-34b
   at full width and full depth (88 layers, d_model 6144, 48 query heads of
   width 128 on one kv head, the two-matrix GELU MLP of width 24,576 with
   biases, an untied 49,152-entry vocabulary; 33.97 B parameters, 63.26
   GiB) in bf16 with random weights from a seeded generator.  A token's
   K/V is 45,056 bytes (88 layers x K and V x 128 x 2 B), so the dense
   cache of 4 slots x 4,096 rows is 0.74 GB and a stored 2,000-token
   context 90 MB.  The prefix mix of phase 1 dense, paged, unified and with
   reuse off (the same actions; each reused request's first-token logits
   within ``LOGIT_ATOL`` of reuse off; the control, a load's prompt after
   the other context's stored rows, outside it; A's stored bytes), then
   ``ModelApi.prefill`` per request as in phase 4 (full and suffix), then
   the RAG mix of phase 5 once, fused over dense decode, against its
   serve with reuse off (reported: r < 1 approximates).  Its peak memory
   is logged.
17. VLM — internvl2-1b at full width and depth (24 layers, d_model 896, 14
   query heads of width 64 on 2 kv heads, QKV bias, tied embeddings, 256
   image positions) in bf16, random weights: three images (seeded ``[1,
   256, 896]`` embeddings x 0.02 on the card, each named by a 256-token
   identity proxy) with two requests each and two text-only requests over
   one 512-token context, ``AlwaysReusePlanner`` (``VLM_PLAN``; the plans
   ``VLM_ACTIONS``): an image request runs through ``ModelApi.prefill``
   (the flash kernel), stores its image's rows and later loads them; the
   text-only requests pack.  Served dense, paged, unified (an image
   request admitted whole, landed in the pool) and with reuse off: every
   load within ``LOGIT_ATOL`` of reuse off; the control, request 3's
   prompt after another image's stored rows, outside it.
18. encoder-decoder — whisper-tiny at full width and depth (4 encoder and
   4 decoder layers, d_model 384, 6 heads of width 64, LayerNorm, GELU,
   1,500 frames, 448 decoder rows) in bf16, random weights: two audios
   (seeded ``[1, 1500, 384]`` frames on the card, each named by a 32-token
   identity proxy), three requests each with prompts of 8-32 tokens and
   16 new tokens, ``AlwaysReusePlanner``, ``max_len`` 448: a recompute
   encodes the frames (4 non-causal ``flash_attention`` launches over
   1,500 rows) and stores every decoder layer's cross K/V; a load inserts
   them and prefills the prompt from position 0; each decoder layer runs
   its self-attention (``flash_attention`` causal in a prefill,
   ``decode_attention`` at a step) and its cross-attention
   (``flash_attention`` non-causal over the 1,500 rows: the prompt's rows,
   and one query row at each decode step).  With reuse off: every load
   within ``ENCDEC_LOAD_ATOL`` of it (the same bits: ``LOGIT_ATOL`` is too
   wide to tell two audios apart with random weights); the control,
   request 2's prompt after the other audio's cross K/V, outside it.

19. training — qwen2-0.5b (the reference launcher's default arch; 24
   layers, d_model 896, 14 heads on 2 kv heads of width 64, qkv bias, the
   tied 151,936-row embedding) through ``training.train_step``: first at
   full width cut to ``TRAIN_CUT`` layers in f32, one step's loss and
   gradients on the card (the forward kernel with its ``lse`` and the
   backward kernel, one launch each a layer) against the same step on the
   CPU (their plain versions), within ``TRAIN_GRAD_RTOL``; then at full
   width and depth in bf16, ``TRAIN_STEPS`` steps of ``token_batches`` at
   ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens (token ids drawn from the first
   ``TRAIN_DATA_VOCAB`` of the vocabulary, so that 30 steps can show
   learning): every loss finite, the mean of the last three at least
   ``TRAIN_LOSS_DROP`` below the mean of the first three, 24 forward and 24
   backward launches a step and no other kernel; it logs the step wall
   median, tokens/s, peak memory and the parameter count.  Last, a
   ``ResilientLoop`` at ``TRAIN_CUT`` layers (bf16, checkpoints in the
   reference's layout) preempted by its failure hook after its first
   checkpoint and re-invoked ends with the parameters, moments and step of
   an uninterrupted run, bit for bit, under
   ``torch.use_deterministic_algorithms(True)`` (the cross-entropy's
   ``gather`` backward is a ``scatter_add_`` on CUDA, which PyTorch counts
   as nondeterministic).
20. training of the SSM, hybrid and encoder-decoder families — the Mamba
   layers' scan gets its gradient through ``ops.SSDChunkedFn``: the forward
   kernel, then ``ssd_chunked_bwd`` (``csrc/ssd_backward.cu``).  First one
   f32 step of mamba2-1.3b at full width cut to ``TRAIN_CUT`` layers and
   one of whisper-tiny whole, on the card and on the CPU (the plain
   versions), loss and every gradient within ``TRAIN_GRAD_RTOL``; then
   mamba2-1.3b at full width and depth in bf16, ``SSM_TRAIN_STEPS`` steps at
   ``SSM_TRAIN_BATCH`` x ``SSM_TRAIN_SEQ`` (ids from the first
   ``TRAIN_DATA_VOCAB``): every loss finite, the drop of the 3-step means at
   least ``SSM_TRAIN_LOSS_DROP`` (predicted from a CPU rehearsal,
   ``scripts/train_loss_rehearsal.py``), 48 forward and 48 backward SSD
   launches a step and no other kernel, the step wall, tokens/s and peak
   memory logged; a preempted ``ResilientLoop`` of mamba2 at ``TRAIN_CUT``
   layers resuming bit for bit; one train step of jamba-1.5-large-398b at
   full width cut to ``JAMBA_TRAIN_CUT`` (its first layer: Mamba and a
   dense MLP, with the 65,536-row embedding; the bytes reckoned and logged
   before the run), its loss finite and its parameters moved; and
   ``WHISPER_TRAIN_STEPS`` steps of whisper-tiny at full width and depth
   over ``frame_batches`` (random frames ``[B, 1,500, 384]``), the loss
   falling.
21. distribution — ``make_host_mesh(data=1, model=1)`` on the card: a
   single-rank NCCL group and its (data, model) ``DeviceMesh``.  On it,
   qwen2-0.5b at full width cut to ``TRAIN_CUT`` layers in bf16 trains
   ``DIST_STEPS`` steps through ``make_sharded_train_step`` (the whole
   batch's loss from NLL sums, the ZeRO-1 update; one batch rank sums
   nothing over the batch axes) and through ``make_train_step`` from the
   same weights, under
   ``torch.use_deterministic_algorithms(True)``: parameters, moments and
   losses equal bit for bit.  Then the KV-length-sharded attention at
   llama-7b's width (32 heads of 128, bf16): ``DIST_Q`` queries at positions
   ``DIST_KV - DIST_Q`` to ``DIST_KV - 1`` over ``DIST_KV`` rows, split into
   ``DIST_SHARDS`` shards as a 4-way model axis splits them: one flash
   launch with ``lse`` a shard (``ops.flash_pieces``) and one merge
   (``ops.combine_pieces``), held within ``BF16_ATOL`` of one unsharded
   launch, causal, with a window of ``DIST_WINDOW`` (whole shards empty for
   every row) and at the decode shape (``DIST_DECODE_B`` sequences, one
   query each, also against ``decode_attention``); through the one-rank
   NCCL group ``ops.flash_attention(..., kv_group=g)`` and
   ``ops.decode_attention(..., kv_group=g)`` give the unsharded launch's
   bits.  The walls of the sharded launches and merge and of the unsharded
   launch are logged side by side.  Last, ``compressed_pmean`` over the
   group on the cut model's gradients: every leaf within its scale (max|g|
   / 127) of the gradient.
22. dry run — (a) ``repro_torch.launch.dryrun.run_cell`` on a one-card
   mesh (a fake process group of one rank, ``meta`` tensors) for three
   qwen2-0.5b cells cut only in global batch (``DRYRUN_CELLS``:
   ``train_4k`` at 2, ``decode_32k`` at 8, ``prefill_32k`` at 1), then the
   same steps for real on the card in bf16 at full width and depth
   (``make_train_step`` with AdamW; ``lm.decode`` over a full cache of
   32,768 rows; ``lm.prefill`` of 32,768 tokens): each step's wall and
   ``torch.cuda.max_memory_allocated()`` (after ``reset_peak_memory_stats``)
   logged beside the record's ``argument_bytes + temp_bytes`` and its
   roofline time; every step runs with finite outputs, and a cell the
   record says fits in 80 GB runs without running out of memory.  (b) The
   models' KV-length-sharded decode: llama-7b at full width cut to
   ``KVDEC_DEPTH`` layers (a B 4 cache of 32,768 rows is 2.1 GB a layer:
   the whole depth's 68.7 GB beside its 13.5 GB of weights does not fit),
   its key projections ``KVDEC_KEY_SCALE`` times the init's (each step's
   own row carries weight against the random rows), ``KVDEC_STEPS`` greedy
   steps at B ``KVDEC_B`` over a seeded random cache whose last
   ``KVDEC_STEPS`` rows the steps write, unsharded (``decode`` launches)
   and then, from the same cache, through ``lm.decode(..., kv_group=g)`` on
   the one-rank NCCL group of ``host_mesh`` (each layer a flash launch with
   ``lse`` through ``ops.flash_pieces`` and the merge), fed the unsharded
   run's tokens: logits within ``LOGIT_ATOL`` of the unsharded ones each
   step, argmax tokens equal wherever the unsharded top-two gap exceeds the
   logits' difference; walls per step of both.  The control, the sharded
   steps again with every row's position one later (each step's newest row
   masked), lands outside ``LOGIT_ATOL``.
23. tensor parallelism — qwen2-0.5b at full width cut to ``TRAIN_CUT``
   layers in bf16, ``TP_STEPS`` steps at B ``TP_BATCH`` x ``TP_SEQ`` under
   ``torch.use_deterministic_algorithms(True)``.  (a) On the one-rank NCCL
   ``host_mesh(1, 1)``, ``make_sharded_train_step`` takes the model group
   down (``attention._forward_tp`` a layer, the vocab-sharded
   ``lm._nll_sharded`` a step, each call counted) and is held against
   ``make_train_step`` from the same weights: parameters, moments and
   losses equal bit for bit.  (b) Two processes of this script
   (``--tp-rank``) on the card, joined in a gloo group (NCCL refuses two
   ranks on one device) with their own ``(data 1, model 2)`` mesh: layout
   (a), each rank's 7 query heads on its kv head through the flash kernel
   with ``lse`` and its backward; (c) four at ``(data 1, model 4)``, layout
   (c) (14 and 2 heads do not divide 4: ``q``, ``k``, ``v`` gathered on
   head_dim).  Each is held against (a)'s ``make_train_step`` run: the
   loss within ``TP_LOSS_ATOL``, the parameters gathered from the ranks'
   shards within ``tp_param_bound`` (the furthest AdamW moves a weight:
   it cannot see a wrong gradient), the first moments gathered after step
   1, ``(1 - b1)`` times the clipped gradient, within ``TP_MOMENT_RTOL`` of
   each leaf's largest magnitude, the leaves the specs replicate equal on
   every rank bit for bit, each rank's launches ``TRAIN_CUT`` forward and
   backward flash launches a step; the ranks' walls and
   ``max_memory_allocated`` are logged.  The control, (b)'s ranks for one
   step with ``copy_to_model``'s backward all-reduce left out, must miss
   ``TP_MOMENT_RTOL``.  A collective gloo cannot run on a CUDA tensor fails
   the phase.

Then the kernel phase: each kernel is called on the inputs one of its
launches on those paths received (first layer) and held against its plain
PyTorch version: in bf16 at atol 1e-2, and cast to f32 (TF32 off) at the
CPU tests' atol 2e-5; ``kv_quant`` and ``kv_dequant`` (on the first leaf
the compressed serve quantised and the first it dequantised) bit for bit;
``flash_attention`` on the per-request prefill's 2,032-token launch, its
32-token suffix launch and the market's spot check (16 tokens over an
empty 4,096-row cache), the kernels line carrying the first with the
per-request phase's launches; ``ssd_chunked`` on the 2,000-token launch
and a 32-token launch after a stored state (see ``check_ssd`` for its tolerances; two bf16 launches must
give the same bits, and the host enqueue and the compiler's registers and
spills of its kernels are logged).  The four prefill
attention kernels run bf16 on the tensor-core tile of
``csrc/flash_mma.cuh`` and f32 on the CUDA-core tile of
``csrc/flash_tile.cuh``: for each, two launches on the recorded inputs must
give the same bits (bf16 and f32), and the split S of the kv tiles, the
compiler's registers and spills from the build log and the f32 time beside
the bf16 one are logged.  Both decode kernels split each sequence's rows into
fixed parts of 256 positions (``csrc/decode_block.cuh``): two launches on
the recorded inputs must give the same bits (bf16 and f32), and the part
count, the host enqueue time and the compiler's registers and spills are
logged.  The packed and decode kernels are held against their plain
versions on nemo's recorded first-layer inputs too, the packed, decode,
paged and chunked ones on olmoe's, and on mixtral's: ``flash_attention`` on
the ring serve's wave-0 launch (6,000 queries past the window over the
empty ring and the new rows) and on its first load's suffix launch (over
a stored, wrapped ring whose oldest rows the window masks),
``decode_attention`` on a decode step past the wrap, and the packed, paged
and chunked kernels on the packable serves' inputs; the kernels line counts
their launches on those serves beside llama's.  On jamba's: ``ssd_chunked``
on its 2,000-token and 32-token launches (H 128, P 128, S 16),
``flash_attention`` on its wave-0 and suffix launches (G 8, no RoPE) and
``decode_attention`` on a decode step, the three appended to the kernels
line with an ``at`` key naming the cut and their launches on its serve.
On granite's: the packed, decode, flash (full and suffix), paged, chunked
and fused kernels at 48 query heads on one kv head, the first prefill
launches at that grouping, appended with ``at`` "granite-34b"; on
internvl's: flash (an image request's prefill and a load's prompt),
decode, paged and chunked; on whisper's: ``flash_attention`` non-causal on
the encoder (1,500 x 1,500), on a prompt's cross-attention and on a decode
step's (one query row over 1,500), and ``decode_attention`` on the
decoder's self-attention, appended with ``at`` "whisper-tiny, <which
launch>", each with its own kind's launches (the serve's flash total split
by its checked decomposition).  The main entries' launches count
granite's, internvl's and whisper's serves too.
Times come from CUDA events after warm-up, beside the plain version's, one
PyTorch library call's (``scaled_dot_product_attention`` with an explicit
boolean mask, timed here only; for the paged kernels on rows gathered
beforehand, the gather excluded; none computes the int8 kernels' or the
SSD scan's function)
and the card's bound for the same work.  Last, both decode kernels run at
granite-34b's heads (48 query heads on one kv head) against their plain
versions, the paged kernel bit for bit equal to the dense one, two launches
equal.  Then the device time per call of the tile and combine of each
prefill kernel, of each decode kernel and of the three bf16 ``ssd_chunked``
kernels (``torch.profiler``), profiled after every wall and host timing,
and the decode and SSD wrappers' host enqueue once more.
The flash-attention backward (``flash_attention_bwd``, the training phase's
kernel: bf16 on the tensor cores, f32 on the CUDA cores) is held against
its plain backward on the full model's first
recorded backward launch (B 4, S 2,048, 14 heads on 2, hd 64, causal),
on llama's heads (hd 128, G 1), on mixtral's G 6 with a window shorter
than the sequence, and in f32 at a small shape: bf16 within ``BF16_ATOL``
of max|·| (each side rounds its f32 sums to bf16: at most one ulp, 2^-7 of
the value), f32 within ``F32_ATOL`` of max(1, max|·|); two launches give the
same bits, the forward with ``lse`` gives the output bits of the forward
without it and an ``lse`` within ``LSE_ATOL`` of the plain forward's (the
same -inf rows; at the training shape the bf16 launch splits its kv tiles,
so the combine writes it), and in f32 ``FlashAttentionFn`` on the card matches autograd
of the plain forward.  It is timed beside its plain version and SDPA's
forward and backward with an explicit boolean mask, and appended to the
kernels line with the full run's launches, as is the forward at the
training shape (``at`` "qwen2-0.5b training").
The SSD backward (``ssd_chunked_bwd``, phase 20's kernel) is held against
its plain backward (``ssd_scan.ssd_chunked_bwd_plain``, f64, at the
model's chunk of 256) on the full mamba2 run's first recorded backward
launch (B 2, L 2,048, H 64, P 64, S 128, G 1), in bf16 and cast to
f32, each with and without a seeded initial state and final-state
gradient, and on the jamba step's recorded backward launch (B 1, L 2,048,
H 128, P 128, S 16, G 1) in the same way: each
output within ``SSD_BWD_BF16_RTOL`` (bf16 dx, dB, dC) or
``SSD_BWD_F32_RTOL`` (every f32 output) of its largest magnitude, set
before the first chip run from the kernel's arithmetic emulated on the CPU
(``tests/test_torch_ssd_bwd_numerics.py``); two launches give the same
bits.  It is timed beside its plain version and its bound (no PyTorch
call computes the scan's gradient) and appended to the kernels line
twice, each entry with its own run's launches.  The flash kernel is held
against its plain version on the last KV shard's launch of phase 21 and
appended with ``at`` naming the sharded route and that phase's launches.
The flash forward with ``lse`` and its backward are held against their
plain versions on phase 23 (b)'s rank 0's first recorded launches (7 query
heads on 1) and appended with ``at`` naming that route and the phase's
launches (every rank's).

Any failed check raises, so the script exits non-zero.  The line before the
last is ``{"kernels": [...]}``; the last is the ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import types

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this script runs on the GPU only")

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.core import simulator  # noqa: E402
from repro_torch.core.cost_model import s_storage_bytes  # noqa: E402
from repro_torch.core.perf_model import V100_X4_HF, PerfModel  # noqa: E402
from repro_torch.core.pricing import AWS_PAPER  # noqa: E402
from repro_torch.data.synthetic import frame_batches, token_batches  # noqa: E402
from repro_torch.distributed import tensor_parallel  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import chunked_prefill as cpk  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import flash_backward as fbk  # noqa: E402
from repro_torch.kernels import flash_prefill as fk  # noqa: E402
from repro_torch.kernels import fused_prefill as fuk  # noqa: E402
from repro_torch.kernels import kv_quant as kq  # noqa: E402
from repro_torch.kernels import packed_prefill as pk  # noqa: E402
from repro_torch.kernels import paged_decode as pdk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_backward as sbk  # noqa: E402
from repro_torch.kernels import ssd_scan as ssk  # noqa: E402
from repro_torch.kvcache import compression, fusion, paged  # noqa: E402
from repro_torch.kvcache.faults import FaultInjector, RetryPolicy, payload_checksum  # noqa: E402
from repro_torch.kvcache.hierarchy import TierSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.mesh import host_mesh  # noqa: E402
from repro_torch.market import Marketplace, MarketPlanner  # noqa: E402
from repro_torch.models import attention, lm, moe  # noqa: E402
from repro_torch.models.registry import count_active_params, count_params, get_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AffinityRouter,
    AlwaysReusePlanner,
    BlendPlanner,
    ClusterConfig,
    CostAwarePlanner,
    EngineConfig,
    Request,
    RoundRobinRouter,
    ServingCluster,
    ServingEngine,
)
from repro_torch.obs import Telemetry, build_spans, chrome_trace  # noqa: E402
from repro_torch.obs.console import render  # noqa: E402
from repro_torch.serving import TraceWriter, read_events  # noqa: E402
from repro_torch.serving import events as ev  # noqa: E402
from repro_torch.serving.engine import SPOT_CHECK_TOL  # noqa: E402
from repro_torch.serving.audit import (  # noqa: E402
    audit,
    audit_from_trace,
    cluster_audit,
    cluster_audit_from_trace,
)
from repro_torch.serving.metrics import summarize_events  # noqa: E402
from repro_torch.serving.scheduler import HedgePolicy  # noqa: E402
from repro_torch.training.checkpoint import latest_step  # noqa: E402
from repro_torch.training.compression import compressed_pmean  # noqa: E402
from repro_torch.training.fault import LoopConfig, Preempted, ResilientLoop  # noqa: E402
from repro_torch.training.optimizer import AdamW, cosine_schedule  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    make_sharded_train_step,
    make_train_step,
    value_and_grad,
)
from repro_torch.training.tree import tree_leaves, tree_map  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the peak
# rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BF16_ATOL = 1e-2
F32_ATOL = 2e-5
# Reused vs recomputed first-token logits, bf16 model: the stored rows are
# the same bf16 values either way, but the packed launches differ in length,
# so the matmuls round differently and the difference compounds over 32
# layers.  Logits of this random-weight model are O(1) (unit-variance final
# norm into a 1/sqrt(d) head); 0.25 is a quarter of that scale.
LOGIT_ATOL = 0.25
# The fused phase's gates compare launches over the same stored bf16 rows:
# the fused serves across decode modes, a rebuilt fused launch against the
# dense serve, and r = 1.0 against ``lm.prefill``.  They read below 5e-5 on
# the H100; the control (the same r = 0.16 launch with the stored K left at
# its source rotation, i.e. delta-RoPE skipped) must move the logits by more.
FUSED_LOGIT_ATOL = 1e-2
# The compressed phase's gate: a load from the int8 tier against the same
# load of the uncompressed bf16 rows.  Each stored value moves by at most
# half its row's scale (amax / 254), and that error passes through 32
# layers.  On the H100 the loads read 0.088-0.109 and the control (the same
# wave-1 loads with every scale doubled) 2.44-2.72; 0.2 sits 1.8x above the
# reading and 12x below the control.
COMPRESSED_LOGIT_ATOL = 0.2
# The SSM phase's gate: a load from the stored (conv tail, SSD state)
# snapshot against the same request recomputed in one prefill call.  The
# stored state is the bf16 model's own, but the load prefills the prompt in
# a launch of its own, so the scan's chunks and the bf16 roundings of the
# activations fall differently over 48 layers.  On the H100 the five loads
# read 0.127-0.157 and the two-phase recomputes against one call 0.154; the
# control (a load with the stored SSD state zeroed) 3.905.  0.25 sits 1.6x
# above the reading and 15x below the control.
SSM_LOGIT_ATOL = 0.25
# A load rebuilt from the store (insert the stored snapshot, prefill the
# prompt) repeats the engine's own load on the same inputs, and a one-call
# prefill repeats the engine's one-call recompute: the same launches on the
# same bits, none with atomics.  On the H100 both read 0.  The logits are
# bf16, so any difference at an O(1) logit is at least 2^-8: this gate asks
# for the same bits.
SSM_REBUILD_ATOL = 1e-5
# The encoder-decoder phase's gate: a load of a stored audio's cross K/V
# against the same request served with reuse off.  The stored rows are the
# bits the recompute's own call computed, and the load prefills the prompt
# from position 0 in the recompute's launch shape, so the two give the same
# bits (on the H100 every load read 0).  ``LOGIT_ATOL`` cannot tell two
# audios apart there: with random weights the cross-attention averages
# 1,500 random frames, and the other audio's cross K/V moved the logits by
# 0.1165 only.  This gate asks for the same bits.
ENCDEC_LOAD_ATOL = 1e-5
# The forward kernel's lse against the plain forward's, absolute: both sum
# the same f32 products of the inputs (bf16 upcast exactly), in another
# order and in base 2 (exp2f, log2f) in place of exp and log
LSE_ATOL = 1e-4
# The reference's SSD tolerance (tests/test_kernels.py), f32
SSD_ATOL = 5e-5
SEED = 0
DEVICE = "cuda"
# the fault and latency-hiding phase's options (the reference's fault test's
# injector and retry policy; a migration pass every half modelled second,
# so passes fall inside the one-second gaps between waves)
FAULTS = dict(seed=7, fail_rate=0.4, corrupt_rate=0.2)
MIGRATION_INTERVAL_S = 0.5
# hedged reads: a threshold below this phase's modelled io2 reads (about a
# quarter second each; the default 0.5 s would leave every read as it is)
HEDGE_THRESHOLD_S = 0.1
# the cluster phase's replicas: the default tiers with the cold tier s3,
# which every replica mounts as one shared, deduplicating core (write-backs
# land in the last tier), and a gossip tick every half modelled second
CLUSTER_TIERS = [TierSpec("host_dram", 64), TierSpec("s3", 1024)]
GOSSIP_INTERVAL_S = 0.5
CLUSTER_EVENTS = (ev.RequestRouted, ev.ReplicaRebalanced, ev.ReplicaCrashed)

SERVE = dict(max_slots=4, max_len=4096)
# the llama serves (phases 1-10): llama-7b at full width cut to LLAMA_DEPTH
# of its 32 layers, planned and timed as the whole model (``priced``; the
# storage fee follows the bytes stored): the host store's
# copies of each context's K/V (0.52 GB a 2,000-token context at 16 layers,
# 1.05 at 32) set most of those phases' walls
LLAMA_DEPTH = 16
LLAMA = dataclasses.replace(get_config("llama-7b"), n_layers=LLAMA_DEPTH)
CTX_LEN, PROMPT_LEN, NEW_TOKENS = 2000, 32, 16
VARIANT_SHARED = 1600  # leading tokens the variant of context B shares with it
# the launch counter of each kernel, by the name the JSON line gives it
COUNTERS = {"packed_flash_attention": pk.packed_flash_attention,
            "decode_attention": dk.decode_attention,
            "flash_attention": fk.flash_attention,
            "paged_decode_attention": pdk.paged_decode_attention,
            "chunked_prefill_attention": cpk.chunked_prefill_attention,
            "fused_flash_attention": fuk.fused_flash_attention,
            "kv_quant": kq.kv_quant,
            "kv_dequant": kq.kv_dequant,
            "ssd_chunked": ssk.ssd_chunked,
            "flash_attention_bwd": fbk.flash_attention_bwd,
            "ssd_chunked_bwd": sbk.ssd_chunked_bwd}
# the market phase: decode tokens per request (the phase's gates are its
# purchase and first-token logits; few decode steps keep it short) and the
# length of the adversary's context C
MARKET_NEW_TOKENS, MARKET_C_LEN = 4, 512
# the sliding-window phase: mixtral-8x22b cut to SWA_DEPTH of its 56 layers
# (one layer holds ~2.5 B parameters, ~5.0 GB in bf16: eight fit the card,
# the whole model does not), contexts of SWA_CTX_LEN tokens past its window
# of 4,096 and the extension of A in wave 2, served at SWA_MAX_LEN (a ring of
# 4,096 rows); the contexts are whole chunks of the store (16 tokens), so a
# request that extends a stored context matches all of it
SWA_DEPTH, SWA_CTX_LEN, SWA_EXTEND, SWA_MAX_LEN = 8, 6000, 256, 8192
# the hybrid phase: jamba-1.5-large-398b cut to Jamba's first five layers as
# a period of their own (four Mamba layers, MoE FFNs on the second and the
# fourth, then the attention layer): one 8-layer period at full width holds
# 45.12 B parameters (84.05 GiB in bf16) and does not fit the card, the cut
# 23.98 B (44.67 GiB)
HYBRID_CUT = dict(n_layers=5, hybrid_period=("m", "m", "m", "m", "a"))
HYBRID_AT = "jamba-1.5-large-398b, 5-layer cut"
# the prefix mix's plans on a stack with Mamba layers: loads, and B's
# variant recomputed (SSM state is all or nothing: no partial reuse)
SSM_ACTIONS = ["recompute", "recompute", "load", "load", "load", "recompute", "load", "load"]
# the training phase: qwen2-0.5b at full width and depth in bf16, TRAIN_STEPS
# steps of ``token_batches`` at TRAIN_BATCH x TRAIN_SEQ tokens whose ids come
# from the first TRAIN_DATA_VOCAB of the 151,936 (over the whole vocabulary
# the modular-bigram language is not learnable in 30 steps: the loss stays
# at ~ln 151,936), AdamW at TRAIN_LR with a cosine schedule; the card-vs-CPU
# step (f32, B TRAIN_CPU_BATCH x TRAIN_CPU_SEQ) and the preemption run at full
# width cut to TRAIN_CUT layers
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_DATA_VOCAB = 4, 2048, 30, 1024
TRAIN_LR, TRAIN_WARMUP = 3e-4, 5
TRAIN_CUT, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 2, 512
# the loss's fall over the full run (mean of the first three steps less the
# mean of the last three), predicted before the first run on the card
# (PERF.md §6, the training entry)
TRAIN_LOSS_DROP = 2.0
# card vs CPU, f32: the loss relative to its value, each gradient relative
# to its leaf's largest magnitude (the same sums in another order; the CPU
# tests read at most 1.6e-6 against the JAX package at reduced width)
TRAIN_GRAD_RTOL = 1e-4
# the SSM, hybrid and encoder-decoder training phase: mamba2-1.3b at full
# width and depth in bf16, SSM_TRAIN_STEPS steps at SSM_TRAIN_BATCH x
# SSM_TRAIN_SEQ (the data, optimizer and schedule of the qwen2-0.5b run; at
# B 4 the forward ran out of the card's 79.18 GiB: a Mamba layer keeps ~1.8
# GB of activations at 8,192 tokens, most of it the conv's f32 terms);
# the loss's fall of the 3-step means predicted before the first run on the
# card from a CPU rehearsal at full width cut to two layers
# (scripts/train_loss_rehearsal.py; PERF.md §6, the SSM training entry);
# jamba-1.5-large-398b cut to its first layer (Mamba, dense MLP) for one
# step at JAMBA_TRAIN_BATCH x JAMBA_TRAIN_SEQ; whisper-tiny whole,
# WHISPER_TRAIN_STEPS steps at WHISPER_TRAIN_BATCH x WHISPER_TRAIN_SEQ
# decoder tokens over 1,500 frames
SSM_TRAIN_ARCH = "mamba2-1.3b"
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 2, 2048, 20
SSM_TRAIN_LOSS_DROP = 3.0
JAMBA_TRAIN_CUT = dict(n_layers=1, hybrid_period=("m",))
JAMBA_TRAIN_BATCH, JAMBA_TRAIN_SEQ = 1, 2048
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_STEPS = 4, 128, 8
# the SSD backward against its plain version (f64), relative to each
# output's largest magnitude, set before its first chip run from its
# arithmetic emulated on the CPU (tests/test_torch_ssd_bwd_numerics.py,
# which reads <= 1.6e-3 and <= 1.7e-5): a bf16 output (dx, dB, dC) within
# one bf16 step at its largest magnitude, every f32 output within 1e-4
SSD_BWD_BF16_RTOL = 2.0**-7
SSD_BWD_F32_RTOL = 1e-4
# the distribution phase: DIST_STEPS steps of the sharded and the plain
# step; the KV-sharded attention's DIST_Q queries at the end of DIST_KV rows
# in DIST_SHARDS shards, a window of DIST_WINDOW and DIST_DECODE_B decode
# sequences
DIST_STEPS, DIST_SHARDS, DIST_Q, DIST_KV, DIST_WINDOW, DIST_DECODE_B = 3, 4, 2032, 4096, 1024, 4
# the dry-run phase: qwen2-0.5b cells cut only in global batch (shape, batch),
# and the KV-length-sharded decode of llama-7b cut to KVDEC_DEPTH layers:
# KVDEC_STEPS steps at B KVDEC_B over a cache of KVDEC_LEN rows, its key
# projections KVDEC_KEY_SCALE times the init's, so that a step's own K row
# (scores ~N(0, scale^2)) carries weight against the KVDEC_LEN random rows
# (~N(0, 1)) and a row written or masked wrong moves the logits.  Read on
# the card at scales 1 / 2 / 3 / 4 / 16 / 64 (PERF.md, PR 40): sharded vs
# unsharded 0.1198 / 0.1297 / 0.1269 / 0.1930 / 2.13 / 3.33, the control
# 0.1518 / 2.06 / 5.44 / 5.79 / 7.39 / 6.55; past 4 the scaled keys amplify
# the routes' bf16 differences from layer to layer
DRYRUN_ARCH = "qwen2-0.5b"
DRYRUN_CELLS = (("train_4k", 2), ("decode_32k", 8), ("prefill_32k", 1))
KVDEC_B, KVDEC_LEN, KVDEC_STEPS, KVDEC_DEPTH = 4, 32768, 8, 16
KVDEC_KEY_SCALE = 3.0
# the tensor-parallel phase: qwen2-0.5b at full width cut to TRAIN_CUT layers
# in bf16, TP_STEPS steps at B TP_BATCH x TP_SEQ; (a) one rank through the
# model-axis route, bit for bit with make_train_step (the loss too: on one
# rank the vocab-sharded log-sum-exp adds log(exp(0)) = 0); (b) and (c) the
# gloo ranks of TP_RANKS on the card against that single-process step: the
# loss within TP_LOSS_ATOL, each gathered parameter within
# tp_param_bound (PERF.md: both set before the first run), and each
# gathered first moment after step 1 ((1 - b1) times the clipped gradient)
# within TP_MOMENT_RTOL of its leaf's largest magnitude; the control, (b)'s
# ranks with copy_to_model's backward all-reduce left out, must exceed it
TP_STEPS, TP_BATCH, TP_SEQ, TP_LOSS_ATOL = 2, 2, 2048, 0.02
TP_MOMENT_RTOL = 0.1
TP_RANKS = (("(b)", 2, "layout (a), 7 query heads on 1 kv head a rank"),
            ("(c)", 4, "layout (c), 14 on 2 heads, head_dim 64 split 4 ways"))
# the fused phase's RAG traffic: documents of DOC_LEN tokens, a 32-token
# prompt per request, the reference's default chunk_tokens of 16, and
# CacheBlend's default recompute fraction
N_DOCS, DOC_LEN, RECOMPUTE_FRAC = 8, 256, 0.16


def zero_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------- #
# Traffic
# --------------------------------------------------------------------------- #
def traffic(vocab: int):
    """Eight requests over two ~2,000-token contexts A and B, in four waves
    one modelled second apart (each wave finishes well inside a second on
    the H100 model, so later waves find the earlier contexts stored):
    wave 0 recomputes A and B and writes them back, wave 1 loads them, wave
    2 loads A and reuses the first 1,600 tokens of a variant of B, wave 3
    loads A twice (the paged engine's shared-prefix dedup)."""
    rng = np.random.default_rng(SEED)
    a = rng.integers(0, vocab, CTX_LEN).tolist()
    b = rng.integers(0, vocab, CTX_LEN).tolist()
    b_variant = b[:VARIANT_SHARED] + rng.integers(
        0, vocab, CTX_LEN - VARIANT_SHARED + 16).tolist()
    contexts = [a, b, a, b, a, b_variant, a, a]
    return [
        dict(req_id=i, context_tokens=ctx,
             prompt_tokens=rng.integers(0, vocab, PROMPT_LEN).tolist(),
             max_new_tokens=NEW_TOKENS, arrival_s=float(i // 2), expected_reuses=3)
        for i, ctx in enumerate(contexts)
    ]


def fused_traffic(vocab: int):
    """A RAG mix over eight 256-token documents D: wave 0 asks with D in its
    stored order (recomputed and written back); wave 1, one modelled second
    later, asks twice with D's documents permuted (neither starting with
    D's first), the second time with one document swapped for a fresh one.
    The prefix trie misses both; the chunk-content index finds every stored
    document."""
    rng = np.random.default_rng(SEED + 1)
    docs = [rng.integers(0, vocab, DOC_LEN).tolist() for _ in range(N_DOCS)]
    fresh = rng.integers(0, vocab, DOC_LEN).tolist()
    perm = [5, 2, 7, 0, 3, 6, 1, 4]
    contexts = [sum(docs, []), sum((docs[i] for i in perm), []),
                sum((fresh if i == 3 else docs[i] for i in perm), [])]
    return [
        dict(req_id=i, context_tokens=ctx,
             prompt_tokens=rng.integers(0, vocab, PROMPT_LEN).tolist(),
             max_new_tokens=NEW_TOKENS, arrival_s=float(i > 0), expected_reuses=3)
        for i, ctx in enumerate(contexts)
    ]


def keep(args, kw):
    """Copies of a kernel call's arguments, kept for the kernel phase."""
    return [a.clone() for a in args], {
        k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in kw.items()
    }


class Recorder:
    """Wraps the model's attention entry points, the engine's model calls and
    its host-side storage steps to record what the main path did: the first
    layer's inputs of one launch of each kernel, every logits tensor, and
    the wall time of each part of a step (each timed part synchronises the
    card before and after, so device work is charged to the part that
    queued it)."""

    def __init__(self, eng: ServingEngine, cfg):
        # launches of each kind per model call: one per attention layer, or
        # one per Mamba layer (a hybrid stack has both)
        self.eng = eng
        self.n_attn, self.n_ssm = max(1, cfg.n_attn_layers), max(1, cfg.n_ssm_layers)
        self.packed_inputs, self.decode_inputs, self.chunked_inputs = None, None, None
        self.fused_inputs = None  # the first layer of the fused launch with most queries
        self.step_logits = []  # every decode step's logits of the active slots
        self.last_logits = None  # the last model call's logits [rows, V], on the host
        self.step_fused = []  # this step's fused launches' logits [1, V], in order
        self.reused_rows_equal = []  # per fused launch: reused rows untouched (torch.equal)
        self.quant_input = None  # the first leaf the int8 tier quantised
        self.dequant_inputs = None  # the first (q, scale, dtype) it dequantised
        self.ssd_inputs = {}  # first layer: the first long launch, the first short one
        self.prefill_calls = 0  # ModelApi.prefill calls (per-request admissions)
        # request of the per-request admission running, and each such
        # request's last ModelApi.prefill logits, until its first token
        self._single_req, self.single_first = None, {}
        self.events = []  # every event of the serve, in order
        self.spent = {}
        # filled by ``note_step``: per-step rows, slot of each request, the
        # logits of each of its tokens and each token's wall instant
        self.steps, self.slot_of, self.req_logits, self.token_wall = [], {}, {}, {}
        self.writebacks = 0
        self._calls = {"packed": 0, "decode": 0, "chunked": 0, "fused": 0, "ssd": 0}
        self._patched = [
            (ops, "packed_attention", self._packed),
            (ops, "decode_attention", self._decode),
            (ops, "paged_decode", self._paged),
            (ops, "chunked_prefill", self._chunked),
            (ops, "fused_prefill", self._fused_attn),
            (eng, "api", eng.api._replace(prefill=self._prefill_single,
                                          prefill_packed=self._prefill, decode=self._step,
                                          decode_paged=self._step_paged,
                                          prefill_chunked=self._step_chunked,
                                          prefill_fused=self._step_fused)),
            (eng, "_admit_single", self._admit_single),
        ]
        self._quant, self._dequant, self._ssd = ops.kv_quant, ops.kv_dequant, ops.ssd_chunked
        self._patched += [(ops, "kv_quant", self._kv_quant), (ops, "kv_dequant", self._kv_dequant),
                          (ops, "ssd_chunked", self._ssd_scan)]
        for name in ("fetch", "put"):
            self._patched.append((eng.store, name, self._timed(f"store_{name}",
                                                               getattr(eng.store, name))))
        for name in ("build_packed_caches", "artifact_to_host", "insert_slot"):
            self._patched.append((paged, name, self._timed(name, getattr(paged, name))))
        self._patched.append((fusion, "build_fused_caches", self._timed(
            "build_fused_caches", fusion.build_fused_caches)))
        if eng._paged_on:
            self._patched.append((eng, "_land_packed_in_pool", self._timed(
                "land_in_pool", eng._land_packed_in_pool)))
            self._patched.append((eng, "_land_state_in_pool", self._timed(
                "land_in_pool", eng._land_state_in_pool)))
            self._patched.append((eng, "_pool_slot_artifact", self._timed(
                "pool_gather", eng._pool_slot_artifact)))
        self._orig = [(obj, name, getattr(obj, name)) for obj, name, _ in self._patched]
        self._orig_api, self._orig_admit = eng.api, eng._admit_single
        for obj, name, fn in self._patched:
            setattr(obj, name, fn)

    def close(self):
        for obj, name, fn in self._orig:
            setattr(obj, name, fn)

    def note_step(self, events, wall, modelled, t_end):
        """Record one engine step: its events, the logits each emitted token
        was taken from, the token's wall instant ``t_end`` (seconds from the
        serve's first step) and the step's row (see ``serve``)."""
        self.writebacks += sum(isinstance(e, ev.StoreWriteBack) for e in events)
        self.events += events
        self.slot_of.update((e.req_id, e.slot) for e in events
                            if isinstance(e, ev.RequestAdmitted))
        batch = [e for e in events if isinstance(e, ev.BatchAdmitted)]
        mixed = [e for e in events if isinstance(e, ev.UnifiedStep)]
        tokens = [e for e in events if isinstance(e, ev.TokenEmitted)]
        fused = [e for e in events if isinstance(e, ev.FusedAdmitted)]
        done = [e for e in events if isinstance(e, ev.PrefillDone)]
        # the fused launches of this step, in admission order (under the
        # unified step a fused admission launches none: its tokens land
        # through chunks)
        launched = [e.req_id for e in fused] if self.step_fused else []
        assert len(launched) == len(self.step_fused), (launched, len(self.step_fused))
        # a per-request admission (an arch that cannot be packed): one
        # request, its logits from its last ModelApi.prefill call
        single = done and not batch and not launched and not mixed
        for e in tokens:
            # a fused launch's logits are its own, a packed batch's in
            # batch order, a step's by slot
            if e.index == 0 and e.req_id in launched:
                lg = self.step_fused[launched.index(e.req_id)][0]
            elif e.index == 0 and e.req_id in self.single_first:
                # a per-request admission, also one inside a unified intake
                # whose step then launches a mixed step
                lg = self.single_first.pop(e.req_id)[0]
            elif batch and e.req_id in batch[0].req_ids:
                lg = self.last_logits[batch[0].req_ids.index(e.req_id)]
            else:
                lg = self.last_logits[self.slot_of[e.req_id]]
            self.req_logits.setdefault(e.req_id, []).append(lg)
            self.token_wall.setdefault(e.req_id, []).append(t_end)
        self.step_fused = []
        if batch:
            prefill_s = next(e.prefill_s for e in events
                             if isinstance(e, ev.PrefillDone) and e.req_id in batch[0].req_ids)
            self.steps.append(("prefill", wall, modelled - prefill_s, prefill_s,
                               batch[0].q_len, batch[0].kv_len, dict(self.spent)))
        elif launched:
            prefill_s = sum(e.prefill_s for e in events if isinstance(e, ev.PrefillDone))
            self.steps.append(("fused", wall, modelled - prefill_s, prefill_s,
                               [e.q_len for e in fused], [e.kv_len for e in fused],
                               dict(self.spent)))
        elif mixed:
            self.steps.append(("mixed", wall, 0.0, mixed[0].step_s, mixed[0].n_decode,
                               mixed[0].chunk_tokens, dict(self.spent)))
        elif single:
            load_s = sum(e.load_s for e in events if isinstance(e, ev.KVLoaded))
            plan = next(e.plan for e in events if isinstance(e, ev.PlanChosen))
            self.steps.append(("single", wall, load_s, done[0].prefill_s, done[0].n_tokens,
                               plan.action + (" + write-back" if plan.store_after else ""),
                               dict(self.spent)))
        elif tokens:
            self.steps.append(("decode", wall, 0.0, modelled, 0, 0, dict(self.spent)))
        elif any(isinstance(e, ev.RequestAdmitted) for e in events):
            # a unified intake with no chunk ready yet: plan, fetch, land
            self.steps.append(("intake", wall, 0.0, 0.0, 0, 0, dict(self.spent)))
        elif any(isinstance(e, ev.TierMigrated) for e in events):
            # an idle clock jump that ran migration passes on its way
            self.steps.append(("migrate", wall, 0.0, 0.0,
                               sum(isinstance(e, ev.TierMigrated) for e in events), 0,
                               dict(self.spent)))
        self.spent.clear()

    def _timed(self, part, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.spent[part] = self.spent.get(part, 0.0) + time.perf_counter() - t0
            return out
        return run

    def _kv_quant(self, x):
        if self.quant_input is None:
            self.quant_input = x.clone()
        return self._quant(x)

    def _kv_dequant(self, q, scale, dtype):
        if self.dequant_inputs is None:
            self.dequant_inputs = (q.clone(), scale.clone(), dtype)
        return self._dequant(q, scale, dtype)

    def _ssd_scan(self, *args, **kw):
        # the first layer of the first context-length launch and of the first
        # prompt-length one
        if self._calls["ssd"] % self.n_ssm == 0:
            label = "long" if args[0].shape[1] >= CTX_LEN else "short"
            if label not in self.ssd_inputs:
                self.ssd_inputs[label] = keep(args, kw)
        self._calls["ssd"] += 1
        return self._ssd(*args, **kw)

    def _admit_single(self, req, *args, **kw):
        self._single_req = req.req_id
        try:
            return self._orig_admit(req, *args, **kw)
        finally:
            self._single_req = None

    def _prefill_single(self, *args, **kw):
        logits, state = self._timed("model", self._orig_api.prefill)(*args, **kw)
        assert torch.isfinite(logits).all(), "non-finite prefill logits"
        self.prefill_calls += 1
        self.last_logits = logits.float().cpu()
        if self._single_req is not None:
            self.single_first[self._single_req] = self.last_logits
        return logits, state

    def _packed(self, *args, **kw):
        # the first wave's first layer: the largest packed launch of the run
        if self._calls["packed"] == 0:
            self.packed_inputs = keep(args, kw)
        self._calls["packed"] += 1
        return self._orig[0][2](*args, **kw)

    def _decode(self, *args, **kw):
        return self._decoded(self._orig[1][2], args, kw)

    def _paged(self, *args, **kw):
        return self._decoded(self._orig[2][2], args, kw)

    def _decoded(self, fn, args, kw):
        # the first layer of the first wave's last decode step (the kernel
        # takes the entry point's arguments but its process group, None
        # on a serve: the unsharded launch)
        if self._calls["decode"] == self.n_attn * (NEW_TOKENS - 2):
            self.decode_inputs = keep(args, {k: v for k, v in kw.items() if k != "kv_group"})
        self._calls["decode"] += 1
        return fn(*args, **kw)

    def _chunked(self, *args, **kw):
        # the first layer of the first launch that holds a decode row, a
        # prefill chunk and an idle row
        if self.chunked_inputs is None and self._calls["chunked"] % self.n_attn == 0:
            valid = (kw["q_pos"] >= 0).sum(dim=1).tolist()
            if 1 in valid and 0 in valid and max(valid) > 1:
                self.chunked_inputs = keep(args, kw)
        self._calls["chunked"] += 1
        return self._orig[3][2](*args, **kw)

    def _fused_attn(self, *args, **kw):
        # the first layer of the fused launch with the most valid queries
        if self._calls["fused"] % self.n_attn == 0:
            n_valid = int((kw["q_pos"] >= 0).sum())
            best = self.fused_inputs
            if best is None or n_valid > int((best[1]["q_pos"] >= 0).sum()):
                self.fused_inputs = keep(args, kw)
        self._calls["fused"] += 1
        return self._orig[4][2](*args, **kw)

    def _step_fused(self, params, cfg, tokens, caches, **kw):
        # the rows the launch must leave alone: valid rows no query lands on
        buf = caches[0].attn
        reused = kw["kv_pos"][0] >= 0
        reused[kw["q_rows"][0][kw["q_pos"][0] >= 0]] = False
        idx = reused.nonzero()[:, 0]
        before = (buf.k[:, 0, idx].clone(), buf.v[:, 0, idx].clone())
        logits, caches = self._timed("model", self._orig_api.prefill_fused)(
            params, cfg, tokens, caches, **kw)
        assert torch.isfinite(logits).all(), "non-finite fused prefill logits"
        self.reused_rows_equal.append(
            (int(idx.numel()), torch.equal(buf.k[:, 0, idx], before[0])
             and torch.equal(buf.v[:, 0, idx], before[1])))
        self.step_fused.append(logits.float().cpu())
        return logits, caches

    def _prefill(self, *args, **kw):
        logits, caches = self._timed("model", self._orig_api.prefill_packed)(*args, **kw)
        assert torch.isfinite(logits).all(), "non-finite prefill logits"
        self.last_logits = logits.float().cpu()
        return logits, caches

    def _step_chunked(self, *args, **kw):
        logits, caches = self._timed("model", self._orig_api.prefill_chunked)(*args, **kw)
        self.last_logits = logits.float().cpu()
        return logits, caches

    def _step(self, *args, **kw):
        return self._stepped(self._orig_api.decode, *args, **kw)

    def _step_paged(self, *args, **kw):
        return self._stepped(self._orig_api.decode_paged, *args, **kw)

    def _stepped(self, fn, *args, **kw):
        active = [s.index for s in self.eng.slots if s.active]
        logits, state = self._timed("model", fn)(*args, **kw)
        assert torch.isfinite(logits[active]).all(), "non-finite decode logits"
        self.step_logits.append((active, logits[active].float().cpu()))
        self.last_logits = logits.float().cpu()
        return logits, state


def of_type(events, cls, req_ids=None):
    """The events of type ``cls`` (of the requests ``req_ids``), in order."""
    return [e for e in events if isinstance(e, cls) and (req_ids is None or e.req_id in req_ids)]


def priced(cfg) -> dict:
    """The engine settings that model a serve of ``cfg``: the cut llama's
    plans and times as the whole llama-7b's (``cost_arch``), every other
    model as itself."""
    return {"cost_arch": "llama-7b"} if cfg == LLAMA else {}


def serve(cfg, params, *, reuse: bool = True, planner=None, make_traffic=traffic,
          setup=None, telemetry=None, market=None, **ec_kw):
    """Serve the traffic once; returns (engine, records by id, recorder,
    per-step rows (kind, wall_s, modelled load_s, modelled step s, q_len or
    decode rows or tokens prefilled, kv_len or chunk tokens or the plan of a
    per-request admission, wall s by part), write-back count).
    The recorder keeps, per request, the logits each of its tokens was
    taken from (``req_logits``, ``first_logits``) and the wall-clock instant
    of each token (``token_wall``, seconds from the first step).  ``setup``,
    if given, is called with the engine before the traffic is submitted;
    ``telemetry`` is the engine's ``obs.Telemetry`` and ``market`` its
    ``MarketSession`` (both off by default)."""
    eng = ServingEngine(
        cfg, params, engine_cfg=EngineConfig(**{**SERVE, **priced(cfg), "reuse_enabled": reuse,
                                                **ec_kw}),
        planner=planner or CostAwarePlanner(), device=DEVICE, telemetry=telemetry,
        market=market,
    )
    if setup is not None:
        setup(eng)
    for r in make_traffic(cfg.vocab):
        eng.submit(Request(**r))
    rec = Recorder(eng, cfg)
    start = time.perf_counter()
    try:
        while not eng.idle:
            busy0 = eng.admission_busy_s + eng.decode_busy_s
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events = eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rec.note_step(events, wall, eng.admission_busy_s + eng.decode_busy_s - busy0,
                          t0 + wall - start)
    finally:
        rec.close()
    rec.first_logits = {i: lg[0] for i, lg in rec.req_logits.items()}
    return eng, {r.req_id: r for r in eng.records}, rec, rec.steps, rec.writebacks


# --------------------------------------------------------------------------- #
# Timing and bounds
# --------------------------------------------------------------------------- #
def release() -> None:
    """Return the memory of dropped engines to the card: an engine is freed
    by the cycle collector, not when its last name is deleted."""
    gc.collect()
    torch.cuda.empty_cache()


def time_ms(fn, reps: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernels: dict, reps: int = 10) -> dict:
    """Device time per call of each kernel whose name contains one of
    ``kernels``' values (``torch.profiler``, CUDA activity only), by its key;
    empty when the profiler saw no device time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        for key, part in kernels.items():
            if t and part in e.key:
                out[key] = out.get(key, 0.0) + t / reps / 1e3
    return out


# (label, fn, kernels, reps, host): profiled by ``log_device_times``
DEVICE_RUNS = []


def device_ms_later(label, fn, kernels: dict, reps: int = 10, host: bool = False) -> None:
    """Queue ``fn`` for ``device_ms`` under ``label``; ``host`` also times
    its host enqueue once more after the profiler sessions."""
    DEVICE_RUNS.append((label, fn, kernels, reps, host))


def log_device_times() -> None:
    """Device time per call of each queued ``fn``'s kernels, profiled after
    every wall and host timing of the script, so that none of those is
    taken after a ``torch.profiler`` session, which may leave the host's
    launches dearer."""
    for label, fn, kernels, reps, host in DEVICE_RUNS:
        d = device_ms(fn, kernels, reps)
        on_device = ", ".join(f"{k} {v:.4f}" for k, v in d.items()) or "not measured"
        after = f"; host enqueue ms after profiling={host_ms(fn):.4f}" if host else ""
        log(f"{label}: device ms per call: {on_device}{after}")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound_ms(bytes_: float, flops: float, dtype) -> tuple:
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernel(name, source, replaces, launches, inputs, kernel, plain, *, mask4,
                 index, kv_rows, pairs, note, label="", reps=10, plain_reps=3,
                 q_rows=None, sdpa_kv=lambda t: t, sdpa_note="", times=None):
    """Hold one kernel against its plain version on the inputs one of its
    launches received, in bf16 at ``BF16_ATOL`` and cast to f32 at
    ``F32_ATOL``, and time it, its plain version and SDPA with the explicit
    boolean mask ``mask4`` (on ``sdpa_kv`` of the K/V operands).  The bound
    counts the bytes of q (only its ``q_rows`` valid query rows where given),
    the output, the ``index`` tensors and ``kv_rows`` K/V rows, and 4·hd·H
    operations per kept (query, kv row) pair.  Each dtype's kernel time goes
    to ``times[dtype]`` when ``times`` is given.  Returns
    the kernel's entry of the ``{"kernels": [...]}`` line, from the bf16 run."""
    (q, k, v), kw = inputs
    H, hd, KV = q.shape[2], q.shape[3], k.shape[-2]
    rows = {}
    for dtype, atol in ((torch.bfloat16, BF16_ATOL), (torch.float32, F32_ATOL)):
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        got = kernel(qq, kk, vv, **kw)
        want = plain(qq, kk, vv, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= atol, f"{name} {label} {dtype}: max err {err} > {atol}"
        ms = time_ms(lambda: kernel(qq, kk, vv, **kw), reps=reps)
        plain_ms = time_ms(lambda: plain(qq, kk, vv, **kw), reps=plain_reps)
        qt = qq.transpose(1, 2)
        kt, vt = (sdpa_kv(t).repeat_interleave(H // KV, -2).transpose(1, 2) for t in (kk, vv))
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask4), reps=reps)
        kv_bytes = 2 * kv_rows * KV * hd * qq.element_size()
        q_bytes = nbytes(qq) if q_rows is None else q_rows * H * hd * qq.element_size()
        b, by = bound_ms(q_bytes + nbytes(got, *index) + kv_bytes, 4.0 * hd * H * pairs, dtype)
        rows[dtype] = dict(err=err, ms=ms, plain=plain_ms, lib=lib, bound=b, by=by)
        if times is not None:
            times[dtype] = ms
        log(f"kernel {name}{' ' + label if label else ''} {str(dtype)[6:]} "
            f"q{tuple(q.shape)} {note}: max_err={err:.3e} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} sdpa_ms={lib:.4f}{sdpa_note} bound_ms={b:.4f} ({by})")
    r = rows[torch.bfloat16]
    return dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
                replaces=replaces, launches=launches, max_abs_err=r["err"], ms=r["ms"],
                plain_ms=r["plain"], bound_ms=r["bound"], bound_by=r["by"],
                library_ms=r["lib"])


def check_packed(inputs, launches, label=""):
    (q, k, _), kw = inputs
    qp, kp = kw["q_pos"][0].long(), kw["kv_pos"][0].long()
    qs, ks = kw["q_seg"][0].long(), kw["kv_seg"][0].long()
    mask = (kp[None] >= 0) & (qs[:, None] == ks[None]) & (kp[None] <= qp[:, None])
    pairs = int(mask.sum())
    # the packed kernel reads every K/V row of the buffer
    times = {}
    entry = check_kernel(
        "packed_flash_attention", "packed_prefill.cu",
        "src/repro/kernels/packed_prefill.py:99", launches, inputs,
        pk.packed_flash_attention, pk.packed_flash_attention_plain,
        mask4=mask[None, None], index=[kw[n] for n in ("q_pos", "kv_pos", "q_seg", "kv_seg")],
        kv_rows=k.shape[0] * k.shape[1], pairs=pairs,
        note=f"kv{tuple(k.shape)} kept_pairs/head={pairs}", label=label, times=times)
    mma_tile_notes(f"packed_flash_attention {label}".strip(), "packed_prefill", inputs,
                   pk.packed_flash_attention, pk.split_count(q.to(torch.bfloat16), k), times)
    return entry


def check_decode(inputs, launches, label=""):
    (q, k, _), kw = inputs
    mask = (kw["kv_pos"].long() >= 0) & (kw["kv_pos"].long() <= kw["q_pos"].long())
    kept = int(mask.sum())  # [B, L] rows each sequence's query keeps
    times = {}
    entry = check_kernel(
        "decode_attention", "decode_attention.cu", "src/repro/kernels/decode_attention.py:83",
        launches, inputs, dk.decode_attention, dk.decode_attention_plain,
        mask4=mask[:, None, None, :], index=[kw["q_pos"], kw["kv_pos"]], kv_rows=kept,
        pairs=kept, note=f"cache{tuple(k.shape)} kept_rows={kept}", reps=20, plain_reps=5,
        label=label, times=times)
    decode_notes(f"decode_attention {label}".strip(), "decode_attention", "decode_kernel",
                 lambda q, k, v: dk.decode_attention(q, k, v, **kw), inputs[0], times,
                 dk.part_count(k.shape[1]))
    return entry


def check_flash(inputs, launches, label):
    (q, k, _), kw = inputs
    qp, kp = kw["q_pos"].long()[:, :, None], kw["kv_pos"].long()[:, None, :]
    mask = (kp >= 0).expand(qp.shape[0], qp.shape[1], kp.shape[2])  # [B, Sq, Skv]
    if kw.get("causal", True):
        mask = mask & (kp <= qp)
    if kw.get("window") is not None:
        mask = mask & (kp > qp - kw["window"])
    if kw.get("kv_valid") is not None:
        mask = mask & kw["kv_valid"][:, None, :]
    pairs = int(mask.sum())  # [B, Sq, Skv]; per head
    rows = int(mask.any(dim=1).sum())  # kv rows some query keeps
    times = {}
    entry = check_kernel(
        "flash_attention", "flash_prefill.cu", "src/repro/kernels/flash_prefill.py:91",
        launches, inputs, fk.flash_attention, fk.flash_attention_plain,
        mask4=mask[:, None], index=[kw["q_pos"], kw["kv_pos"]], kv_rows=rows, pairs=pairs,
        note=f"cache{tuple(k.shape)} kept_pairs/head={pairs} kept_rows={rows}", label=label,
        times=times)
    mma_tile_notes(f"flash_attention {label}", "flash_prefill", inputs, fk.flash_attention,
                   fk.split_count(q.to(torch.bfloat16), k), times)
    return entry


def check_paged(inputs, launches, label=""):
    (q, k_pool, _), kw = inputs
    B = q.shape[0]
    table, block = kw["block_table"], kw["block"]
    L = table.shape[1] * block
    rows = (table.long()[:, :, None] * block
            + torch.arange(block, device=q.device)[None, None]).reshape(B, L)
    idx = torch.arange(L, device=q.device)[None]
    mask = idx <= kw["q_pos"]  # [B, L]: validity is positional
    if kw.get("window") is not None:
        mask = mask & (idx > kw["q_pos"] - kw["window"])
    kept = int(mask.sum())
    # SDPA runs on the rows gathered beforehand (the gather is not timed)
    times = {}
    entry = check_kernel(
        "paged_decode_attention", "paged_decode.cu", "src/repro/kernels/paged_decode.py:101",
        launches, inputs, pdk.paged_decode_attention, pdk.paged_decode_attention_plain,
        mask4=mask[:, None, None, :], index=[table, kw["q_pos"]], kv_rows=kept, pairs=kept,
        note=f"pool{tuple(k_pool.shape)} table{tuple(table.shape)} kept_rows={kept}",
        reps=20, plain_reps=5, sdpa_kv=lambda t: t[rows], sdpa_note=" (gather excluded)",
        label=label, times=times)
    decode_notes(f"paged_decode_attention {label}".strip(), "paged_decode",
                 "paged_decode_kernel",
                 lambda q, k, v: pdk.paged_decode_attention(q, k, v, **kw), inputs[0], times,
                 pdk.part_count(table.shape[1], block))
    return entry


def host_ms(fn, reps: int = 20) -> float:
    """Host time per call of ``fn``: the enqueue alone, after warm-up and
    with the device idle, so no call waits on the queue."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / reps


def ptxas_notes(lib, kernels) -> str:
    """Registers and spill bytes of each kernel of library ``lib`` whose name
    matches ``kernels`` (a regex alternation), from the compiler's report
    (``-Xptxas -v`` in the build log), with its template arguments."""
    notes = []
    for e in build.ptxas_report(lib):
        m = re.search(rf"({kernels})(?:I(f|13__nv_bfloat16)?((?:L[ib]\d+E)*))?",
                      e["function"])
        if m is None:
            continue
        kind, elem, ints = m.groups()
        args = [{"f": "f32", "13__nv_bfloat16": "bf16"}[elem]] if elem else []
        args += [{"Lb0": "false", "Lb1": "true"}.get(a[:-1], a[2:-1])
                 for a in re.findall(r"L[ib]\d+E", ints or "")]
        notes.append(f"{kind}<{','.join(args)}>: {e.get('registers')} regs, "
                     f"spill {e.get('spill_stores')}/{e.get('spill_loads')} B")
    return "; ".join(notes) or "no build log"


def decode_notes(name, lib, kernel_name, call, qkv, times, parts):
    """Two launches of a decode kernel on the recorded inputs must give the
    same bits, in bf16 and in f32.  Logs the part size P and the launch's
    part count, the bf16 wall time per call beside its host enqueue time
    (both before any profiler session), and the compiler's registers and
    spills (template arguments: dtype, head_dim bucket, heads a block); the
    device time of the kernel and of its combine is logged last
    (``log_device_times``)."""
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.to(dtype) for t in qkv]
        first, second = call(*args), call(*args)
        torch.cuda.synchronize()
        assert torch.equal(first, second), f"{name} {dtype}: two launches differ"
    bf16 = functools.partial(call, *args)
    device_ms_later(f"{name} bf16", bf16, {"kernel": kernel_name, "combine": "combine_kernel"},
                    reps=20, host=True)
    log(f"{name}: P={dk.PART} positions a part, {parts} parts; two launches equal bit for "
        f"bit (bf16 and f32); bf16 wall ms={times[torch.bfloat16]:.4f}, host enqueue ms="
        f"{host_ms(bf16):.4f}; f32 wall ms={times[torch.float32]:.4f}; "
        f"ptxas: {ptxas_notes(lib, 'paged_decode_kernel|decode_combine_kernel|decode_kernel')}")


def mma_tile_notes(name, lib, inputs, kernel, splits, times):
    """The bf16 launches of the four prefill attention kernels run on the
    tensor-core tile (``csrc/flash_mma.cuh``), which splits the kv tiles
    into S parts across blocks and combines the parts in split order: two
    launches on the recorded inputs must give the same bits, in bf16 and in
    f32.  Logs S, the registers and spills of the library's kernels from the
    compiler's report (``-Xptxas -v`` in the build log), and the f32 time
    (the CUDA-core tile) beside the bf16 one."""
    (q, k, v), kw = inputs
    for dtype in (torch.float32, torch.bfloat16):
        qkv = [t.to(dtype) for t in (q, k, v)]
        first, second = kernel(*qkv, **kw), kernel(*qkv, **kw)
        torch.cuda.synchronize()
        assert torch.equal(first, second), f"{name} {dtype}: two launches differ"
    device_ms_later(f"{name} bf16", functools.partial(kernel, *qkv, **kw),
                    {"tile": "attn_kernel", "combine": "combine_kernel"})
    log(f"{name}: bf16 tile splits the kv tiles into S={splits} parts; two launches equal "
        f"bit for bit (bf16 and f32); bf16 ms={times[torch.bfloat16]:.4f} "
        f"f32 ms={times[torch.float32]:.4f}; ptxas (attn_kernel: the "
        f"mma bf16 tile <hd, source, full>; tile_kernel: the cuda-core f32 tile): "
        f"{ptxas_notes(lib, 'attn_kernel|tile_kernel|combine_kernel')}")


def check_chunked(inputs, launches, label=""):
    (q, k_pool, _), kw = inputs
    B = q.shape[0]
    table, block = kw["block_table"], kw["block"]
    L = table.shape[1] * block
    rows = (table.long()[:, :, None] * block
            + torch.arange(block, device=q.device)[None, None]).reshape(B, L)
    idx = torch.arange(L, device=q.device)[None, None]
    qp = kw["q_pos"].long()[:, :, None]
    mask = idx <= qp  # [B, C, L]: validity is positional, padding keeps nothing
    if kw.get("window") is not None:
        mask = mask & (idx > qp - kw["window"])
    pairs = int(mask.sum())  # per head
    kept = int(mask.any(dim=1).sum())  # pool rows some query keeps
    n_valid = (kw["q_pos"] >= 0).sum(dim=1).tolist()
    # the kernel reads no padding query's row of q, so the bound counts only
    # the valid query rows; SDPA runs on the rows gathered beforehand (the
    # gather is not timed)
    times = {}
    entry = check_kernel(
        "chunked_prefill_attention", "chunked_prefill.cu",
        "src/repro/kernels/chunked_prefill.py:104", launches, inputs,
        cpk.chunked_prefill_attention, cpk.chunked_prefill_attention_plain,
        mask4=mask[:, None], index=[table, kw["q_pos"]], kv_rows=kept, pairs=pairs,
        q_rows=sum(n_valid),
        note=f"pool{tuple(k_pool.shape)} table{tuple(table.shape)} valid queries/row "
             f"{n_valid} kept_pairs/head={pairs} kept_rows={kept}",
        reps=20, plain_reps=5, sdpa_kv=lambda t: t[rows], sdpa_note=" (gather excluded)",
        label=label, times=times)
    mma_tile_notes(f"chunked_prefill_attention {label}".strip(), "chunked_prefill", inputs,
                   cpk.chunked_prefill_attention,
                   cpk.split_count(q.to(torch.bfloat16), table, block), times)
    return entry


def check_fused(inputs, launches, label=""):
    (q, k, _), kw = inputs
    qp, kp = kw["q_pos"].long()[:, :, None], kw["kv_pos"].long()[:, None, :]
    mask = (kp >= 0) & (kp <= qp)  # [B, Sq, Skv]: padding queries keep nothing
    if kw.get("window") is not None:
        mask = mask & (kp > qp - kw["window"])
    pairs = int(mask.sum())  # per head
    n_q = int((kw["q_pos"] >= 0).sum())
    total = int((kw["kv_pos"] >= 0).sum())
    # the kernel reads no padding query's q row and skips every kv tile past
    # the valid rows, so the bound counts the n_q valid queries and the
    # total valid K/V rows, not the q_len and kv_len buckets
    times = {}
    entry = check_kernel(
        "fused_flash_attention", "fused_prefill.cu", "src/repro/kernels/fused_prefill.py:105",
        launches, inputs, fuk.fused_flash_attention, fuk.fused_flash_attention_plain,
        mask4=mask[:, None], index=[kw["q_pos"], kw["kv_pos"]], kv_rows=total, pairs=pairs,
        q_rows=n_q,
        note=f"buffer{tuple(k.shape)} valid queries {n_q} of {q.shape[1]}, valid rows "
             f"{total} of {k.shape[1]}, kept_pairs/head={pairs}", label=label, times=times)
    mma_tile_notes(f"fused_flash_attention {label}".strip(), "fused_prefill", inputs,
                   fuk.fused_flash_attention, fuk.split_count(q.to(torch.bfloat16), k), times)
    return entry


def check_wide_group(H=48, KV=1, hd=128, lens=(2050, 1, 2047, 700), block=128,
                     max_len=4096):
    """Both decode kernels at granite-34b's heads (48 query heads on one kv
    head, split over tiles of 8), on seeded random rows: each against its
    plain version (bf16 at ``BF16_ATOL``, f32 at ``F32_ATOL``), and the paged
    kernel against the dense kernel over the same rows, bit for bit; each
    kernel's time beside the bytes bound of q, the output and the kept
    K/V rows."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED)
    B, nb = len(lens), max_len // block
    n_blocks = 1 + B * nb
    order = (torch.randperm(n_blocks - 1, generator=g, device=DEVICE) + 1).tolist()
    table = torch.zeros(B, nb, dtype=torch.int32)
    for b, L in enumerate(lens):
        for j in range(-(-L // block)):
            table[b, j] = order.pop()
    table = table.to(DEVICE)
    q_pos = torch.tensor([[L - 1] for L in lens], dtype=torch.int32, device=DEVICE)
    rows = (table.long()[:, :, None] * block
            + torch.arange(block, device=DEVICE)[None, None]).reshape(B, max_len)
    idx = torch.arange(max_len, device=DEVICE, dtype=torch.int32)[None]
    kv_pos = torch.where(idx <= q_pos, idx, -1).to(torch.int32)
    q32 = torch.randn(B, 1, H, hd, generator=g, device=DEVICE)
    kp32 = torch.randn(n_blocks * block, KV, hd, generator=g, device=DEVICE)
    vp32 = torch.randn(n_blocks * block, KV, hd, generator=g, device=DEVICE)
    for dtype, atol in ((torch.bfloat16, BF16_ATOL), (torch.float32, F32_ATOL)):
        q, kp, vp = (t.to(dtype) for t in (q32, kp32, vp32))
        k, v = kp[rows].contiguous(), vp[rows].contiguous()
        dense = dk.decode_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos)
        dense_err = (dense.float() - dk.decode_attention_plain(
            q, k, v, q_pos=q_pos, kv_pos=kv_pos).float()).abs().max().item()
        kw = dict(block_table=table, q_pos=q_pos, block=block)
        pool = pdk.paged_decode_attention(q, kp, vp, **kw)
        paged_err = (pool.float() - pdk.paged_decode_attention_plain(
            q, kp, vp, **kw).float()).abs().max().item()
        torch.cuda.synchronize()
        dense_fn = functools.partial(dk.decode_attention, q, k, v, q_pos=q_pos, kv_pos=kv_pos)
        paged_fn = functools.partial(pdk.paged_decode_attention, q, kp, vp, **kw)
        dense_ms, paged_ms = time_ms(dense_fn, reps=20), time_ms(paged_fn, reps=20)
        label = f"decode at G {H // KV} {str(dtype)[6:]}"
        keys = {"kernel": "decode_kernel", "combine": "combine_kernel"}
        device_ms_later(f"{label} dense", dense_fn, keys, reps=20)
        device_ms_later(f"{label} paged", paged_fn, keys, reps=20)
        b, by = bound_ms(2 * nbytes(q) + 2 * sum(lens) * KV * hd * q.element_size(),
                         4.0 * hd * H * sum(lens), dtype)
        again = torch.equal(dense, dense_fn()) and torch.equal(pool, paged_fn())
        log(f"decode at H {H}, KV {KV} (G {H // KV}) {str(dtype)[6:]} q{tuple(q.shape)} "
            f"lens {list(lens)}, {pdk.part_count(nb, block)} parts: dense max_err="
            f"{dense_err:.3e} ms={dense_ms:.4f}, paged max_err={paged_err:.3e} "
            f"ms={paged_ms:.4f}, bound_ms={b:.4f} ({by}); paged == dense bit for bit: "
            f"{torch.equal(pool, dense)}; two launches equal: {again}")
        assert dense_err <= atol and paged_err <= atol, (dtype, dense_err, paged_err)
        assert torch.equal(pool, dense), f"G {H // KV} {dtype}: paged differs from dense"
        assert again, f"G {H // KV} {dtype}: two launches differ"


def check_kv_quant(x, launches):
    """Hold ``kv_quant`` against its plain version on the leaf the int8 tier
    quantised first, bit for bit (int8 bytes and scales), and time both.
    The bound counts the leaf read once and the int8 rows and scales
    written once, and ~5 f32 operations per value (abs, max, divide, round,
    clamp) at the f32 peak."""
    q, s = kq.kv_quant(x)
    pq, ps = kq.kv_quant_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(q, pq), "kv_quant: int8 bytes differ from the plain version's"
    assert torch.equal(s.view(torch.int32), ps.view(torch.int32)), "kv_quant: scales differ"
    err = float(max((q.int() - pq.int()).abs().max().item(), (s - ps).abs().max().item()))
    ms = time_ms(lambda: kq.kv_quant(x), reps=20)
    plain_ms = time_ms(lambda: kq.kv_quant_plain(x), reps=5)
    b, by = bound_ms(nbytes(x, q, s), 5.0 * x.numel(), torch.float32)
    log(f"kernel kv_quant {str(x.dtype)[6:]} x{tuple(x.shape)} ({x.numel() // x.shape[-1]} rows): "
        f"int8 bytes and scales equal bit for bit, max_err={err:.3e} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={b:.4f} ({by}); no single library call")
    return dict(name="kv_quant", route="cuda", source="src/repro_torch/kernels/csrc/kv_quant.cu",
                replaces="src/repro/kernels/kv_quant.py:49", launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=None)


def check_kv_dequant(inputs, launches):
    """Hold ``kv_dequant`` against its plain version on the first (q, scale)
    a fetch from the int8 tier dequantised, bit for bit, and time both.  The
    bound counts q and the scales read once and the output written once,
    and 2 f32 operations per value (product, rounding)."""
    q, s, dtype = inputs
    got = kq.kv_dequant(q, s, dtype)
    want = kq.kv_dequant_plain(q, s, dtype)
    torch.cuda.synchronize()
    bits = torch.int16 if got.element_size() == 2 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits)), "kv_dequant: values differ"
    err = (got.float() - want.float()).abs().max().item()
    ms = time_ms(lambda: kq.kv_dequant(q, s, dtype), reps=20)
    plain_ms = time_ms(lambda: kq.kv_dequant_plain(q, s, dtype), reps=5)
    b, by = bound_ms(nbytes(q, s, got), 2.0 * q.numel(), torch.float32)
    log(f"kernel kv_dequant {str(dtype)[6:]} q{tuple(q.shape)}: values equal bit for bit, "
        f"max_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b:.4f} ({by}); "
        f"no single library call")
    return dict(name="kv_dequant", route="cuda",
                source="src/repro_torch/kernels/csrc/kv_dequant.cu",
                replaces="src/repro/kernels/kv_quant.py:78", launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=None)


# the bf16 ``ssd_chunked`` kernels, by phase (csrc/ssd_scan.cu)
SSD_KERNELS = {"chunk states": "chunk_state_kernel", "state pass": "state_pass_kernel",
               "chunk outputs": "chunk_output_kernel"}


def check_ssd(inputs, launches, label=""):
    """Hold ``ssd_chunked`` against its plain version on two recorded first-
    layer launches of a serve (``inputs["long"]``, a 2,000-token context
    with a fresh state, run here with no initial state: the engine passed
    zeros; ``inputs["short"]``, a 32-token prompt after a stored state), and
    time both; ``label`` names the serve (mamba2's when empty).

    One rule, the one ``tests/test_torch_kernels_gpu.py`` applies: each f32
    output (y in the f32 run, with inputs cast and TF32 off, and the state
    in both runs) lies no further from the f64 scan of the same inputs
    (``ref.ssd_scan_ref`` in f64) than max(5e-5, the plain version's error
    against it), 5e-5 being the reference's SSD atol; both readings are
    printed.  A bf16 y lies within one bf16 ulp (2^-7 of the plain
    version's magnitude) plus 5e-5 of the plain version's: both round f32
    sums of the same bf16 inputs.

    The bound counts x, B, C, dt, A and the initial state read once and y
    and the final state written once (the kernel's scratch is not the
    function's), and the operations of the chunked form at the caller's
    chunk (the reference's 256), whatever chunk the kernel runs: per chunk
    of n tokens the causal half of C·Bᵀ once per group, of the score times
    X per head, and C·h and the state update per head, at the inputs' peak.
    Two bf16 launches must give the same bits.  Logs the bf16 launch's
    host enqueue and the compiler's registers and spills of the kernels,
    and queues the device time of each bf16 kernel (the chunk states, the
    state pass, the chunk outputs) for ``log_device_times``.  Returns the
    kernel's entry of the ``{"kernels": [...]}`` line, from the bf16
    2,000-token run."""
    entry = None
    for part in ("long", "short"):
        (x, dt, A, Bm, Cm), kw = inputs[part]
        h0, chunk = kw["initial_state"], kw["chunk"]
        where = f"{label} {part}".strip()
        if part == "long":
            assert h0 is None or not h0.any(), "the context launch started from a stored state"
            h0 = None
        Bsz, L, H, P = x.shape
        G, S = Bm.shape[2], Bm.shape[3]
        want64 = ref.ssd_scan_ref(x.double(), dt.double(), A.double(), Bm.double(),
                                  Cm.double(), initial_state=None if h0 is None else h0.double())
        for dtype in (torch.bfloat16, torch.float32):
            xx, bb, cc = (t.to(dtype) for t in (x, Bm, Cm))
            y, hT = ssk.ssd_chunked(xx, dt, A, bb, cc, chunk=chunk, initial_state=h0)
            yp, hp = ssk.ssd_chunked_plain(xx, dt, A, bb, cc, chunk=chunk, initial_state=h0)
            torch.cuda.synchronize()
            err = {"y": (y.float() - yp.float()).abs(), "h": (hT - hp).abs()}
            notes = []
            if dtype == torch.bfloat16:
                ulp = (err["y"] - yp.float().abs() * 2.0**-7).max().item()
                notes.append(f"y max err {err['y'].max().item():.3e}, over one bf16 ulp by "
                             f"{max(ulp, 0.0):.3e} (gate {SSD_ATOL})")
                assert ulp <= SSD_ATOL, (where, ulp)
            # f32 outputs: y in the f32 run, the state in both
            f32_out = {"h": (hT, hp, want64[1])}
            if dtype == torch.float32:
                f32_out["y"] = (y, yp, want64[0])
            for name, (got, plain_out, exact) in f32_out.items():
                k64 = (got.double() - exact).abs().max().item()
                p64 = (plain_out.double() - exact).abs().max().item()
                notes.append(f"{name} max err against the f64 scan: kernel {k64:.3e}, plain "
                             f"{p64:.3e} (gate max({SSD_ATOL}, plain)); kernel - plain "
                             f"{err[name].max().item():.3e}")
                assert k64 <= max(SSD_ATOL, p64), (where, dtype, name, k64, p64)
            ms = time_ms(lambda: ssk.ssd_chunked(xx, dt, A, bb, cc, chunk=chunk,
                                                 initial_state=h0), reps=20)
            plain_ms = time_ms(lambda: ssk.ssd_chunked_plain(xx, dt, A, bb, cc, chunk=chunk,
                                                             initial_state=h0), reps=5)
            ns = [min(chunk, L - t) for t in range(0, L, chunk)]
            tri = sum(n * (n + 1) // 2 for n in ns)
            flops = 2.0 * Bsz * (G * tri * S + H * tri * P + 2 * H * L * P * S)
            b, by = bound_ms(nbytes(xx, dt, A, bb, cc, h0, y, hT), flops, dtype)
            if dtype == torch.bfloat16:
                call = functools.partial(ssk.ssd_chunked, xx, dt, A, bb, cc, chunk=chunk,
                                         initial_state=h0)
                again = call()
                torch.cuda.synchronize()
                assert torch.equal(again[0], y) and torch.equal(again[1], hT), (
                    f"ssd_chunked {where}: two bf16 launches differ")
                notes.append(f"two launches equal bit for bit; kernel chunk {ssk.CHUNK}, "
                             f"{ssk.chunk_count(L)} chunks; host enqueue ms={host_ms(call):.4f}")
                device_ms_later(f"ssd_chunked {where} bf16", call, SSD_KERNELS, reps=20,
                                host=True)
            log(f"kernel ssd_chunked {where} {str(dtype)[6:]} x{tuple(x.shape)} G {G} S {S} "
                f"chunk {chunk} initial state {h0 is not None}: {'; '.join(notes)}; "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b:.4f} ({by}); no single "
                f"library call")
            if part == "long" and dtype == torch.bfloat16:
                entry = dict(name="ssd_chunked", route="cuda",
                             source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                             replaces="src/repro/kernels/ssd_scan.py:91", launches=launches,
                             max_abs_err=err["y"].max().item(), ms=ms, plain_ms=plain_ms,
                             bound_ms=b, bound_by=by, library_ms=None)
    log(f"ssd_chunked ptxas (bf16: chunk_state_kernel, state_pass_kernel, "
        f"chunk_output_kernel; f32: ssd_kernel): "
        f"{ptxas_notes('ssd_scan', '|'.join(SSD_KERNELS.values()) + '|ssd_kernel')}")
    return entry


def log_steps(label, steps):
    for kind, wall, load_s, modelled, q_len, kv_len, parts in steps:
        parts = " ".join(f"{k}={1e3 * v:.2f}" for k, v in sorted(parts.items()))
        if kind == "prefill":
            log(f"{label} step prefill q_len={q_len} kv_len={kv_len}: "
                f"wall_ms={1e3 * wall:.2f} modelled_prefill_ms={1e3 * modelled:.3f} "
                f"modelled_load_ms={1e3 * load_s:.3f} | wall ms by part: {parts}")
        elif kind == "fused":
            log(f"{label} step fused q_len={q_len} kv_len={kv_len}: "
                f"wall_ms={1e3 * wall:.2f} modelled_prefill_ms={1e3 * modelled:.3f} "
                f"modelled_load_ms={1e3 * load_s:.3f} | wall ms by part: {parts}")
        elif kind == "single":
            log(f"{label} step {kv_len} ({q_len} tokens prefilled): wall_ms={1e3 * wall:.2f} "
                f"modelled_prefill_ms={1e3 * modelled:.3f} modelled_load_ms={1e3 * load_s:.3f} "
                f"| wall ms by part: {parts}")
        elif kind == "intake":
            log(f"{label} step intake (no launch): wall_ms={1e3 * wall:.2f} | {parts}")
        elif kind == "migrate":
            log(f"{label} step idle clock jump with {q_len} migrations: "
                f"wall_ms={1e3 * wall:.2f} | {parts}")
        elif kind == "mixed":
            log(f"{label} step mixed decode_rows={q_len} chunk_tokens={kv_len}: "
                f"wall_ms={1e3 * wall:.2f} t_step_unified_ms={1e3 * modelled:.3f} | {parts}")
        else:
            log(f"{label} step decode: wall_ms={1e3 * wall:.2f} "
                f"modelled_ms={1e3 * modelled:.3f} | {parts}")


def log_decode_gaps(label, recs, rec):
    """Each request's gaps between consecutive tokens: modelled (the
    engine's clock) and wall (host clock at the end of each step)."""
    for i, r in sorted(recs.items()):
        wall = np.diff(rec.token_wall[i]) * 1e3
        if len(wall) == 0:
            continue
        log(f"{label} request {i} decode gaps: wall ms median {np.median(wall):.2f} "
            f"max {wall.max():.2f}; modelled ms per token "
            f"{1e3 * r.decode_s / max(len(r.tokens) - 1, 1):.3f}")


def top2_gap(logits) -> float:
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def check_cow(eng) -> None:
    """Copy one pool block onto another through the engine's copy-on-write
    path and hold the copied rows against the source rows, bit for bit."""
    pool = eng._pool_caches[0].attn
    block = eng.ec.kv_block
    src, dst = 1, eng._paged.pool.n_blocks - 1
    rows = lambda b: torch.arange(b * block, (b + 1) * block, device=pool.k.device)  # noqa: E731
    before = pool.k[:, rows(src)].clone()
    assert before.abs().sum() > 0, "the source block holds no rows"
    eng._copy_pool_blocks([paged.CowSplit(src=src, dst=dst)])
    torch.cuda.synchronize()
    assert torch.equal(pool.k[:, rows(dst)], before), "copy-on-write: K rows differ"
    assert torch.equal(pool.v[:, rows(dst)], pool.v[:, rows(src)]), "copy-on-write: V rows differ"
    assert torch.equal(pool.k[:, rows(src)], before), "copy-on-write changed its source"
    log(f"copy-on-write: pool block {src} copied onto block {dst} on the card, "
        f"{2 * before.numel()} elements equal bit for bit")


def stored_artifact(eng, tokens):
    """The artifact the engine's store holds for ``tokens`` (a full match)."""
    match, entry = eng.store.lookup(tokens)
    assert entry is not None and match.matched_tokens == len(tokens), "context not stored"
    artifact, _ = eng.store.fetch(entry.entry_id, fraction=1.0)
    return artifact


def per_request_prefill(cfg, params, reqs, recompute_logits, load_req, artifact,
                        reuse_logits):
    """``ModelApi.prefill`` per request: each request's context + prompt into
    a fresh batch-1 state, held against the engine's recompute-run
    first-token logits; then ``load_req``'s stored context inserted into a
    fresh slot and its prompt prefilled after it (the ``_execute_load``
    shape), held against the reuse run.  Returns the first layer's flash
    inputs of the first full call and of the suffix call."""
    api = get_model(cfg)
    recorded = {}
    label = [None]  # the call whose first layer's inputs are kept
    flash = ops.flash_attention

    def record(*args, **kw):
        if label[0] is not None and label[0] not in recorded:
            recorded[label[0]] = keep(args, kw)
        return flash(*args, **kw)

    ops.flash_attention = record
    try:
        for r in reqs:
            label[0] = None if recorded else "full"
            before = fk.flash_attention.launches
            tokens = r["context_tokens"] + r["prompt_tokens"]
            state = api.init_state(cfg, 1, SERVE["max_len"], device=DEVICE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                logits, state = api.prefill(
                    params, cfg, torch.tensor([tokens], device=DEVICE), state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = fk.flash_attention.launches - before
            diff = (logits[0].float().cpu() - recompute_logits[r["req_id"]]).abs().max().item()
            log(f"prefill request {r['req_id']} ({len(tokens)} tokens): wall_ms="
                f"{1e3 * wall:.2f} flash launches {n}, last-token logits "
                f"max|prefill - engine| = {diff:.4f}")
            assert n == cfg.n_layers, n
            assert int(state.pos[0]) == len(tokens)
            assert diff <= LOGIT_ATOL, (r["req_id"], diff)
            del state
        # the load path's shape: stored context rows, then the prompt alone
        # (twice: the first call of a new shape pays for its warm-up)
        prompt = load_req["prompt_tokens"]
        for attempt in range(2):
            label[0] = "suffix"
            before = fk.flash_attention.launches
            state = api.init_state(cfg, 1, SERVE["max_len"], device=DEVICE)
            paged.insert_slot(cfg, state, 0, artifact)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                logits, state = api.prefill(
                    params, cfg, torch.tensor([prompt], device=DEVICE), state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = fk.flash_attention.launches - before
            diff = (logits[0].float().cpu()
                    - reuse_logits[load_req["req_id"]]).abs().max().item()
            log(f"suffix prefill request {load_req['req_id']} call {attempt} ({len(prompt)} "
                f"tokens after {len(load_req['context_tokens'])} stored): wall_ms="
                f"{1e3 * wall:.2f} flash launches {n}, last-token logits "
                f"max|prefill - engine (load)| = {diff:.4f}")
            assert n == cfg.n_layers, n
            assert diff <= LOGIT_ATOL, diff
            del state
    finally:
        ops.flash_attention = flash
    return recorded["full"], recorded["suffix"]


def fused_last_logits(cfg, params, sched, req, sources, cache_cfg):
    """``lm.prefill_fused`` of one fused admission as the engine launches it
    (its default layout), over buffers ``build_fused_caches`` assembles under
    ``cache_cfg``; returns the last token's logits as f32 on the host."""
    ec = EngineConfig()
    layout = fusion.fused_layout(sched, len(req["prompt_tokens"]), align=ec.pack_align,
                                 bucket_min=ec.pack_bucket_min)
    a = {n: torch.from_numpy(x).to(DEVICE) for n, x in fusion.fused_arrays(
        sched, req["context_tokens"], req["prompt_tokens"], layout).items()}
    caches = fusion.build_fused_caches(cache_cfg, sched, sources, layout.kv_len, DEVICE)
    with torch.inference_mode():
        logits, _ = lm.prefill_fused(
            params, cfg, a["tokens"], caches, q_pos=a["q_pos"], q_rows=a["q_rows"],
            kv_pos=a["kv_pos"], last_idx=a["last_idx"])
    return logits[0].float().cpu()


def fused_phase(cfg, params):
    """Serve the RAG mix fused (``BlendPlanner(recompute_frac=0.16,
    always=True)``, ``fusion_enabled=True``) three times — dense decode,
    paged decode, and the unified step, whose fused streams land through
    the chunked kernel — and once with reuse off.  Returns the fused
    kernel's recorded inputs and its launches in the dense serve."""
    reqs = fused_traffic(cfg.vocab)
    log(f"fused phase: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on the card "
        f"at its start")
    planner = lambda: BlendPlanner(recompute_frac=RECOMPUTE_FRAC, always=True)  # noqa: E731
    runs, counts_by = {}, {}
    for label, ec in (("fused dense", {}), ("fused paged", dict(paged_decode=True)),
                      ("fused unified", dict(paged_decode=True, unified_step=True))):
        zero_counts()
        eng, recs, rec, steps, _ = serve(cfg, params, planner=planner(),
                                         make_traffic=fused_traffic, fusion_enabled=True,
                                         kv_block=128, **ec)
        c = counts_by[label] = counts()
        stats = eng.fused_stats()
        log(f"{label} serve launches: {c}")
        log_steps(label, steps)
        log(f"{label} fused_stats: {json.dumps(stats)}")
        actions = {i: (r.action, r.matched_tokens) for i, r in sorted(recs.items())}
        log(f"{label} actions (action, reused tokens): {actions}")
        assert [a for a, _ in actions.values()] == ["recompute", "fused", "fused"], actions
        assert stats["admissions"] == 2 and stats["reused_tokens"] > 0, stats
        assert all(len(r.tokens) == NEW_TOKENS for r in recs.values())
        assert all(e.pins == 0 for e in eng.store.entries.values())
        n_fused = c["fused_flash_attention"]
        if ec.get("unified_step"):
            assert n_fused == 0 and c["packed_flash_attention"] == 0, c
            assert c["chunked_prefill_attention"] == cfg.n_layers * eng.unified_stats()["steps"]
        else:
            assert n_fused == 2 * cfg.n_layers, c
            assert c["packed_flash_attention"] == cfg.n_layers, c
            assert all(n for n, eq in rec.reused_rows_equal) and len(rec.reused_rows_equal) == 2
            assert all(eq for _, eq in rec.reused_rows_equal), rec.reused_rows_equal
            log(f"{label}: reused rows untouched by the fused launch (torch.equal): "
                f"{rec.reused_rows_equal}")
        if ec.get("paged_decode"):
            eng._paged.audit()
            assert eng._paged.pool.n_used == 0
        runs[label] = (recs, rec.first_logits)
        if label == "fused dense":
            fused_inputs = rec.fused_inputs
            # fused admissions write nothing back: the store still holds
            # only wave 0's context, as when request 1 was planned
            comp = eng.store.lookup_composite(reqs[1]["context_tokens"])
            sched = fusion.select_recompute(comp, RECOMPUTE_FRAC)
            sources = {eid: eng.store.fetch(eid, fraction=1.0)[0]
                       for eid in sched.rows_by_entry()}
            no_rope = dataclasses.replace(cfg, rope_theta=None)
            rebuilt, skipped = (fused_last_logits(cfg, params, sched, reqs[1], sources, c)
                                for c in (cfg, no_rope))
            del sources
        del eng, rec
        release()
        log(f"{label}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on the card "
            f"after the engine is dropped")
    dense_recs, dense_first = runs["fused dense"]
    for label in ("fused paged", "fused unified"):
        recs, first = runs[label]
        for i in sorted(recs):
            diff = (first[i] - dense_first[i]).abs().max().item()
            same = sum(x == y for x, y in zip(recs[i].tokens, dense_recs[i].tokens))
            log(f"{label} request {i}: first-token logits max|{label[6:]} - dense| = "
                f"{diff:.3e}, tokens agreeing {same}/{NEW_TOKENS}")
            assert diff <= FUSED_LOGIT_ATOL, (label, i, diff)
    diff, control = ((x - dense_first[1]).abs().max().item()
                     for x in (rebuilt, skipped))
    log(f"request 1's fused launch rebuilt from the store: first-token logits "
        f"max|rebuilt - dense serve| = {diff:.3e}; control with delta-RoPE skipped: "
        f"{control:.3e} (gate {FUSED_LOGIT_ATOL})")
    assert diff <= FUSED_LOGIT_ATOL < control, (diff, control)
    # the fused serve against exact recompute: r < 1 approximates, so this
    # is reported, not gated
    _, base_recs, base_rec, _, _ = serve(cfg, params, reuse=False, make_traffic=fused_traffic)
    for i in (1, 2):
        diff = (dense_first[i] - base_rec.first_logits[i]).abs().max().item()
        same = sum(x == y for x, y in zip(dense_recs[i].tokens, base_recs[i].tokens))
        log(f"fused (r={RECOMPUTE_FRAC}) vs recompute, request {i}: first-token logits "
            f"max diff {diff:.4f}, tokens agreeing {same}/{NEW_TOKENS}")
    del base_rec, runs
    release()

    # r = 1.0: every matched token recomputes, so the fused launch is a full
    # prefill of the sequence
    r1 = reqs[1]
    sched = fusion.select_recompute(comp, 1.0)
    fused_logits = fused_last_logits(cfg, params, sched, r1, {}, cfg)
    with torch.inference_mode():
        state = lm.init_state(cfg, 1, SERVE["max_len"], device=DEVICE)
        full_logits, _ = lm.prefill(params, cfg, torch.tensor(
            [r1["context_tokens"] + r1["prompt_tokens"]], device=DEVICE), state)
    diff = (fused_logits - full_logits[0].float().cpu()).abs().max().item()
    log(f"r=1.0: lm.prefill_fused ({sched.recompute_tokens + PROMPT_LEN} queries) vs "
        f"lm.prefill of the same tokens: last-token logits max diff {diff:.3e}")
    assert diff <= FUSED_LOGIT_ATOL, diff
    del state
    release()
    assert counts_by["fused paged"]["fused_flash_attention"] > 0
    return fused_inputs, counts_by["fused dense"]["fused_flash_attention"]


def stored_nbytes(eng, contexts):
    """Each context's stored entry nbytes (full matches only)."""
    out = {}
    for ctx in contexts:
        match, entry = eng.store.lookup(ctx)
        if entry is not None and match.matched_tokens == len(ctx):
            out[tuple(ctx)] = entry.nbytes
    return out


def doubled_scales(payload):
    """A stored int8 artifact with every row's scale doubled (the control)."""
    return paged.LMState(pos=payload.pos, caches=tuple(
        paged.BlockCache(paged.KVCache(*(dataclasses.replace(x, scale=x.scale * 2)
                                         for x in c.attn)))
        for c in payload.caches))


def rebuild_wave(cfg, params, reqs, matched, artifacts):
    """One packed admission launch of ``reqs`` over the stored ``artifacts``
    (their first ``matched`` rows), laid out as the engine lays out a wave;
    returns each request's last-token logits as f32 on the host."""
    ec = EngineConfig(**SERVE)
    layout = paged.pack_layout(
        list(range(len(reqs))), matched, [len(r["prompt_tokens"]) for r in reqs],
        align=ec.pack_align, bucket_min=ec.pack_bucket_min)
    arrays = paged.pack_arrays(layout, [r["context_tokens"][m:] + r["prompt_tokens"]
                                        for r, m in zip(reqs, matched)])
    caches = paged.build_packed_caches(cfg, layout, artifacts, DEVICE)
    t = {n: torch.from_numpy(a).to(DEVICE) for n, a in arrays.items()}
    last = torch.tensor([seg.q_last for seg in layout.segments], device=DEVICE)
    with torch.inference_mode():
        logits, _ = lm.prefill_packed(
            params, cfg, t["tokens"], caches, q_pos=t["q_pos"], q_seg=t["q_seg"],
            q_rows=t["q_rows"], kv_pos=t["kv_pos"], kv_seg=t["kv_seg"], last_idx=last)
    return logits.float().cpu()


def compressed_phase(cfg, params, ref):
    """Serve the prefix mix with ``compress_tier="io2"`` under dense decode
    and under the unified step, each held against the uncompressed serve of
    the same mode (``ref[mode]``: its actions, launch counts, first-token
    logits and stored nbytes by context).  Returns the int8 kernels'
    recorded inputs and their launches in the dense compressed serve."""
    reqs = traffic(cfg.vocab)
    contexts = [r["context_tokens"] for r in reqs]
    hd, width = cfg.resolved_head_dim, getattr(torch, cfg.dtype).itemsize
    out = {}
    for mode, ec in (("dense", {}),
                     ("unified", dict(paged_decode=True, unified_step=True, kv_block=128))):
        label = f"compressed {mode}"
        actions, ref_counts, ref_first, ref_nbytes = ref[mode]
        zero_counts()
        eng, recs, rec, steps, writebacks = serve(cfg, params, compress_tier="io2", **ec)
        c = counts()
        loaded = of_type(rec.events, ev.KVLoaded)
        io2_loads = [e for e in loaded if e.tier == "io2"]
        log(f"{label} serve launches: {c} (write-backs {writebacks}, fetches from io2 "
            f"{len(io2_loads)})")
        log_steps(label, steps)
        cactions = {i: (r.action, r.matched_tokens) for i, r in sorted(recs.items())}
        log(f"{label} actions (action, matched tokens): {cactions}; uncompressed: {actions}")
        assert len(recs) == 8 and all(len(r.tokens) == NEW_TOKENS for r in recs.values())
        for i, (a, _) in actions.items():
            if a == "load":
                assert cactions[i][0] == "load", (label, i, cactions[i], actions[i])
        assert c["kv_quant"] == 2 * writebacks > 0, (c, writebacks)
        assert c["kv_dequant"] == 2 * len(io2_loads) > 0, (c, len(io2_loads))
        assert len(io2_loads) == len(loaded), "a load came from another tier"
        for name in ("packed_flash_attention", "decode_attention", "chunked_prefill_attention"):
            assert c[name] == ref_counts[name], (label, name, c[name], ref_counts[name])
        # a cheaper fetch makes a unified stream ready sooner, so fewer steps
        # are decode-only: the paged count follows the engine's own steps
        n_decode = eng.decode_stats()["decode_steps"]
        assert c["paged_decode_attention"] == (cfg.n_layers * n_decode if ec else 0), (c, n_decode)
        # every entry is int8 rows and f32 scales: hd + 4 bytes a row, plus
        # the 4-byte pos leaf; (hd + 4) / (2 hd) of the bf16 entry
        nbytes_c = stored_nbytes(eng, contexts)
        assert nbytes_c.keys() == ref_nbytes.keys(), "other contexts stored"
        for e in eng.store.entries.values():
            assert e.compressed, e
            payload = eng.store.backends[e.tier].peek(e.entry_id)
            leaves = [x for cc in payload.caches for x in cc.attn]
            rows = sum(x.q.size // hd for x in leaves)
            assert all(x.scale.nbytes == 4 * (x.q.size // hd) for x in leaves)
            assert e.nbytes == sum(x.q.nbytes for x in leaves) + 4 * rows + 4, e
        for ctx, nb in nbytes_c.items():
            assert (nb - 4) * width * hd == (ref_nbytes[ctx] - 4) * (hd + 4), (nb, ref_nbytes[ctx])
        log(f"{label}: {len(eng.store.entries)} entries, all int8; nbytes "
            f"{sorted(nbytes_c.values())} against {sorted(ref_nbytes.values())} uncompressed "
            f"({(hd + 4) / (width * hd):.4f}x)")
        reused = [i for i, (a, _) in cactions.items() if a in ("load", "partial")]
        reading = 0.0
        for i in reused:
            diff = (rec.first_logits[i] - ref_first[i]).abs().max().item()
            reading = max(reading, diff)
            log(f"{label} request {i} ({cactions[i][0]}): first-token logits "
                f"max|int8 - bf16| = {diff:.4f}")
        assert reading <= COMPRESSED_LOGIT_ATOL, (label, reading)
        out[mode] = dict(counts=c, reading=reading)
        if mode == "dense":
            out["quant_input"], out["dequant_inputs"] = rec.quant_input, rec.dequant_inputs
            out["first"] = rec.first_logits
            out["store"], out["cactions"] = eng.store, cactions  # host-side: int8 payloads
        del eng, rec
        release()
    return out


def compressed_checks(cfg, params, out, artifact_a, tokens_a):
    """Against the dense compressed serve's store: context A's int8 rows and
    scales equal ``kv_quant_plain`` of the uncompressed serve's stored bf16
    rows of A on the card, bit for bit; dequantised to f32 they lie within
    half a scale (+1e-6) of those rows; and the control: wave 1's loads
    rebuilt as one packed launch over the stored int8 rows with every scale
    doubled must move the first-token logits outside
    ``COMPRESSED_LOGIT_ATOL`` (the same rebuild with the true scales is
    reported beside it)."""
    store, first, cactions = out.pop("store"), out.pop("first"), out.pop("cactions")
    match, entry = store.lookup(tokens_a)
    assert entry is not None and match.matched_tokens == len(tokens_a)
    payload = store.backends[entry.tier].peek(entry.entry_id)
    for name, stored, dense in zip(("k", "v"), payload.caches[0].attn, artifact_a.caches[0].attn):
        x = paged.to_device(dense, getattr(torch, cfg.dtype), DEVICE)
        pq, ps = kq.kv_quant_plain(x)
        q, sc = torch.from_numpy(stored.q).to(DEVICE), torch.from_numpy(stored.scale).to(DEVICE)
        assert torch.equal(q, pq), f"{name}: stored int8 bytes differ from kv_quant_plain"
        assert torch.equal(sc.view(torch.int32), ps.view(torch.int32)), f"{name}: scales differ"
        err = (kq.kv_dequant(q, sc, torch.float32) - x.float()).abs()
        worst = (err - sc / 2).max().item()
        log(f"compressed: context A's stored {name} ({stored.q.size // stored.q.shape[-1]} rows) "
            f"equals kv_quant_plain of the bf16 rows bit for bit; dequantised to f32, "
            f"max |x - x'| - scale/2 = {worst:.3e} (gate 1e-6), max |x - x'| "
            f"{err.max().item():.4f}")
        assert worst <= 1e-6, (name, worst)
        del x, pq, ps, q, sc, err
    reqs = traffic(cfg.vocab)
    wave = [r for r in reqs if r["arrival_s"] == 1.0]
    assert all(cactions[r["req_id"]][0] == "load" for r in wave), cactions
    payloads = []
    for r in wave:
        _, e = store.lookup(r["context_tokens"])
        payloads.append(store.backends[e.tier].peek(e.entry_id))
    matched = [cactions[r["req_id"]][1] for r in wave]
    rows = {}
    for label, arts in (("true", payloads), ("doubled", [doubled_scales(p) for p in payloads])):
        dev = [compression.decompress_tree(p, DEVICE) for p in arts]
        rows[label] = rebuild_wave(cfg, params, wave, matched, dev)
        del dev
    for i, r in enumerate(wave):
        served = first[r["req_id"]]
        same = (rows["true"][i] - served).abs().max().item()
        control = (rows["doubled"][i] - out["dense_first"][r["req_id"]]).abs().max().item()
        log(f"compressed: request {r['req_id']}'s load rebuilt from the int8 store: "
            f"max|rebuilt - served| = {same:.3e}; control with every scale doubled, "
            f"max|control - bf16 serve| = {control:.4f} (gate {COMPRESSED_LOGIT_ATOL}, reading "
            f"{out['dense']['reading']:.4f})")
        assert same <= COMPRESSED_LOGIT_ATOL < control, (same, control)
    del store, payloads
    release()


def faulted_serve(cfg, params, ref_first, card):
    """The prefix mix under seeded fault injection, with the write-back tier
    browned out from the last wave's arrival on."""
    reqs = traffic(cfg.vocab)
    t_last = max(r["arrival_s"] for r in reqs)
    last = {r["req_id"] for r in reqs if r["arrival_s"] == t_last}
    inj = FaultInjector(**FAULTS)
    inj.add_brownout("io2", t_last, float("inf"))  # io2: the default write-back tier
    zero_counts()
    eng, recs, rec, steps, _ = serve(
        cfg, params, faults=inj, retry_policy=RetryPolicy(max_attempts=2, cost_aware=False))
    c = counts()
    fs, events = eng.fault_stats(), rec.events
    actions = {i: (r.action, r.matched_tokens, r.degraded) for i, r in sorted(recs.items())}
    log(f"faulted serve launches: {c}")
    log(f"faulted serve actions (action, matched tokens, degraded): {actions}")
    log(f"faulted serve fault_stats: {json.dumps(fs)}")
    log(f"faulted serve steps, card wall beside modelled ({card}):")
    log_steps("faulted", steps)
    assert len(recs) == 8 and all(len(r.tokens) == NEW_TOKENS for r in recs.values())
    assert c["packed_flash_attention"] > 0 and c["decode_attention"] > 0, c
    assert fs["fetch_failures"] > 0, fs
    assert len(of_type(events, ev.FetchFailed)) == fs["fetch_failures"], fs
    degraded = of_type(events, ev.DegradedToRecompute)
    assert len(degraded) == fs["degraded_requests"], fs
    assert {e.req_id for e in degraded} == {i for i, r in recs.items() if r.degraded}
    assert all(r.action == "recompute" for r in recs.values() if r.degraded), actions
    # the last wave plans around the browned-out tier: no fetch is attempted
    plans = {e.req_id: e.plan.action for e in of_type(events, ev.PlanChosen, last)}
    assert set(plans.values()) == {"recompute"}, plans
    assert all(recs[i].action == "recompute" for i in last), actions
    for cls in (ev.FetchFailed, ev.FetchRetried, ev.KVLoaded):
        assert not of_type(events, cls, last), cls.__name__
    assert fs["injector"]["brownout_rejections"] > 0, fs
    reading = 0.0
    for i in sorted(recs):
        diff = (rec.first_logits[i] - ref_first[i]).abs().max().item()
        reading = max(reading, diff)
        log(f"faulted request {i} ({recs[i].action}{', degraded' if recs[i].degraded else ''}): "
            f"first-token logits max|faulted - fault-free| = {diff:.4f}")
    assert reading <= LOGIT_ATOL, reading
    del eng, rec
    release()


def hiding_serve(cfg, params, label, ref, card, **ec_kw):
    """The prefix mix under overlapped, hedged loads, lookahead prefetch and
    clock-driven migrations, held to ``ref`` = (records, each request's
    per-token logits, each request's packed launch (req_ids, q_len, kv_len),
    summary) of the serve without those options in the same decode mode."""
    ref_recs, ref_req_logits, ref_batches, ref_summary = ref
    ref_first = {i: lg[0] for i, lg in ref_req_logits.items()}
    delays = {}  # req_id -> the fetch delay of its admission, before any overlap
    asked = []  # (delay, hedged delay) of every read the hedge policy was asked about
    reads = {}  # req_id -> the (delay, hedged delay) of its admission's store reads

    class TracedHedge(HedgePolicy):
        def effective_delay(self, delay_s):
            out = super().effective_delay(delay_s)
            asked.append((delay_s, out))
            return out

    def setup(eng):
        fetch = eng._fetch_kv_resilient

        def recorded(a, events):
            n = len(asked)
            fetch(a, events)
            delays[a.req.req_id] = a.delay
            reads[a.req.req_id] = asked[n:]
        eng._fetch_kv_resilient = recorded

    zero_counts()
    eng, recs, rec, steps, _ = serve(
        cfg, params, setup=setup, overlap_load=True, hedge=TracedHedge(threshold_s=HEDGE_THRESHOLD_S),
        prefetch_lookahead=4,
        migration_interval_s=MIGRATION_INTERVAL_S, **ec_kw)
    c = counts()
    events = rec.events
    summary = eng.summary().as_dict()
    actions = {i: (r.action, r.matched_tokens) for i, r in sorted(recs.items())}
    migrated = of_type(events, ev.TierMigrated)
    log(f"{label} serve launches: {c}")
    log(f"{label} actions (action, matched tokens): {actions}")
    log(f"{label}: {len(migrated)} migrations "
        f"{[(m.entry_id, m.from_tier, m.to_tier, m.reason, round(m.t_s, 3)) for m in migrated]}; "
        f"lookup walks {eng.lookup_walks}, carried {eng.lookup_reuses}")
    log(f"{label} steps, card wall beside modelled ({card}):")
    log_steps(label, steps)
    assert len(recs) == 8 and all(len(r.tokens) == NEW_TOKENS for r in recs.values())
    if eng._unified_on:
        assert c["chunked_prefill_attention"] > 0 and c["packed_flash_attention"] == 0, c
    else:
        assert c["packed_flash_attention"] > 0 and c["decode_attention"] > 0, c
    # where both serves loaded: the same tokens if the admission was the same
    # packed launch (the same bits); otherwise (a unified stream's chunks
    # fall into other steps) the first-token logits within LOGIT_ATOL, and
    # where the tokens first part, a near-tie in the serve without options
    batch_of = {i: (b.req_ids, b.q_len, b.kv_len)
                for b in of_type(events, ev.BatchAdmitted) for i in b.req_ids}
    both = [i for i, r in recs.items() if r.action == ref_recs[i].action == "load"]
    same = [i for i in both if i in batch_of and batch_of[i] == ref_batches.get(i)]
    assert both, (actions, ref_recs)
    if not eng._unified_on and eng.ec.admit_batch is None:
        assert same, (batch_of, ref_batches)
    if eng.ec.admit_batch == 1:
        # a wave's second request waits a step in the queue: its fetch is
        # prefetched and its trie walk carried to its admission
        assert eng.lookup_reuses > 0, (eng.lookup_walks, eng.lookup_reuses)
    for i in both:
        diff = (rec.first_logits[i] - ref_first[i]).abs().max().item()
        assert diff <= LOGIT_ATOL, (label, i, diff)
        if i in same:
            assert recs[i].tokens == ref_recs[i].tokens, (label, i)
            continue
        part = next((n for n, (x, y) in enumerate(zip(recs[i].tokens, ref_recs[i].tokens))
                     if x != y), None)
        if part is not None:
            assert top2_gap(ref_req_logits[i][part]) < LOGIT_ATOL, (label, i, part)
    # each KVLoaded carries the delay charged after the overlap
    done = {e.req_id: e.prefill_s for e in of_type(events, ev.PrefillDone)}
    loaded = of_type(events, ev.KVLoaded)
    assert loaded, actions
    for e in loaded:
        want = delays[e.req_id] if eng._unified_on else max(0.0, delays[e.req_id] - done[e.req_id])
        assert abs(e.load_s - want) <= 1e-12, (label, e.req_id, e.load_s, want)
    # hedged reads: some admission's store read was cut, and the delay its
    # KVLoaded was charged before the overlap lies below the unhedged read
    cut = {i: (sum(x for x, _ in r), sum(y for _, y in r))
           for i, r in reads.items() if any(y < x for x, y in r)}
    shown = {i: (round(x, 4), round(y, 4), round(delays[i], 4)) for i, (x, y) in cut.items()}
    log(f"{label}: hedge threshold {HEDGE_THRESHOLD_S} s; reads (modelled s, unhedged, hedged) "
        f"{[(round(x, 4), round(y, 4)) for x, y in asked]}; admissions cut (unhedged, hedged, "
        f"charged before the overlap) {shown}")
    assert cut, (label, asked)
    assert any(delays[e.req_id] < cut[e.req_id][0] for e in loaded if e.req_id in cut), \
        (label, cut, delays)
    assert migrated, label
    assert all(e.pins == 0 for e in eng.store.entries.values()), "a prefetch pin was kept"
    reading = max((rec.first_logits[i] - ref_first[i]).abs().max().item() for i in recs)
    log(f"{label}: {len(both)} requests loaded in both serves, {len(same)} of them in the same "
        f"packed launch (tokens equal); "
        f"first-token logits max|with - without| over all requests {reading:.4f}; "
        f"modelled mean TTFT {summary['mean_ttft_s']:.6f} s against "
        f"{ref_summary['mean_ttft_s']:.6f} s, total cost ${summary['total_cost']:.6f} "
        f"against ${ref_summary['total_cost']:.6f}")
    assert summary["mean_ttft_s"] < ref_summary["mean_ttft_s"], (summary, ref_summary)
    del eng, rec
    release()


def fault_phase(cfg, params, dense, unified, card):
    """The faulted serve and the latency-hiding serves (dense; dense admitting
    one request a step, so a wave's second request is prefetched while the
    first is admitted; unified), against the serves without those options;
    then one Fig. 2(a) row from the port's simulator.  ``card`` is the
    card's name and power limit, as nvidia-smi gives them."""
    faulted_serve(cfg, params, {i: lg[0] for i, lg in dense[1].items()}, card)
    hiding_serve(cfg, params, "latency-hiding dense", dense, card)
    hiding_serve(cfg, params, "latency-hiding dense one-a-step", dense, card, admit_batch=1)
    hiding_serve(cfg, params, "latency-hiding unified", unified, card, paged_decode=True,
                 unified_step=True, kv_block=128)
    trace = simulator.make_trace(n_contexts=40, reuses_per_context=5, L_context=10_000,
                                 L_prompt=32, L_output=32, arrival_rate_per_s=0.02, seed=0)
    row = simulator.compare_pipelines(get_config("llama-7b"), trace, PerfModel(V100_X4_HF),
                                      AWS_PAPER)
    log(f"simulator (host, Fig. 2(a) at L=10000, 40 contexts): {json.dumps(row)}")


# --------------------------------------------------------------------------- #
# Cluster phase
# --------------------------------------------------------------------------- #
def serve_cluster(cfg, params, n_replicas, router, *, setup=None, cc_kw=None,
                  telemetry=None, trace=None, **ec_kw):
    """Serve the prefix mix once through a ``ServingCluster`` of
    ``n_replicas`` dense engines behind ``router``, ``CostAwarePlanner``,
    H100 ``PerfModel`` and prices (the engine's defaults); returns (cluster,
    one recorder per replica).  A cluster step steps at most one replica:
    its events, card wall time and modelled time go to that replica's
    recorder (``Recorder.note_step``).  ``setup``, if given, is called with
    the cluster before the traffic is submitted; ``telemetry`` and
    ``trace`` (a ``TraceWriter``) are the cluster's, off by default."""
    cl = ServingCluster(
        cfg, params, cluster_cfg=ClusterConfig(n_replicas=n_replicas, **(cc_kw or {})),
        engine_cfg=EngineConfig(**SERVE, **priced(cfg), **ec_kw), router=router,
        planner_factory=CostAwarePlanner, device=DEVICE, telemetry=telemetry, trace=trace,
    )
    if setup is not None:
        setup(cl)
    for r in traffic(cfg.vocab):
        cl.submit(Request(**r))
    recs = []
    start = time.perf_counter()
    try:
        for eng in cl.replicas:
            recs.append(Recorder(eng, cfg))
        while not cl.idle:
            busy0 = [e.admission_busy_s + e.decode_busy_s for e in cl.replicas]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cl.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stepped = {i for i, e in out if not isinstance(e, CLUSTER_EVENTS)}
            assert len(stepped) <= 1, stepped
            for i in stepped:
                eng = cl.replicas[i]
                recs[i].note_step([e for j, e in out if j == i], wall,
                                  eng.admission_busy_s + eng.decode_busy_s - busy0[i],
                                  t0 + wall - start)
            # the recorders' module-level timers are chained: each saw the
            # stepped replica's calls, which only its own recorder keeps
            for rec in recs:
                rec.spent.clear()
    finally:
        for rec in reversed(recs):
            rec.close()
    for rec in recs:
        rec.first_logits = {i: lg[0] for i, lg in rec.req_logits.items()}
    return cl, recs


def assert_close(got, want, where, tol=1e-9):
    """Equal, floats within ``tol`` (NaN where the other is NaN), recursing
    into dataclasses, dicts and sequences."""
    if dataclasses.is_dataclass(got):
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    if isinstance(got, dict):
        assert got.keys() == want.keys(), (where, got.keys(), want.keys())
        for k in got:
            assert_close(got[k], want[k], f"{where}.{k}", tol)
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), where
        for n, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{where}[{n}]", tol)
    elif isinstance(got, float):
        assert abs(got - want) <= tol or (math.isnan(got) and math.isnan(want)), (
            where, got, want)
    else:
        assert got == want, (where, got, want)


def landed(cl, recs):
    """Each request's record and the logits of each of its tokens, from the
    replica whose records hold it (a request harvested from a crashed
    replica also left a partial generation in that replica's recorder)."""
    out = {}
    for i, eng in enumerate(cl.replicas):
        for r in eng.records:
            assert r.req_id not in out, f"request {r.req_id} recorded twice"
            out[r.req_id] = (i, r, recs[i].req_logits[r.req_id])
    return out


def check_cluster_serve(label, cl, recs, ref_recs, ref_logits, card):
    """Gates of a two-replica serve: one ``RequestRouted`` per request (and
    one more per request a crash harvested), the last one before each
    ``RequestAdmitted`` of it naming the admitting replica; every request
    recorded once, with ``NEW_TOKENS`` tokens; no ``FetchFailed``; each
    first-token logits within ``LOGIT_ATOL`` of the dense serve's, and its
    tokens the dense serve's up to a near-tie of the dense run's logits
    where they first part.  Logs the routing, the shared core and each
    replica's steps."""
    c = counts()
    got = landed(cl, recs)
    log(f"{label} launches: {c}")
    assert sorted(got) == sorted(ref_recs), sorted(got)
    routed = [(i, e) for i, e in cl.events if isinstance(e, ev.RequestRouted)]
    harvested = sum(e.inflight + e.queued for _, e in cl.events
                    if isinstance(e, ev.ReplicaCrashed))
    assert {e.req_id for _, e in routed} == set(ref_recs), routed
    assert len(routed) == len(ref_recs) + harvested, (routed, harvested)
    for n, (i, e) in enumerate(cl.events):
        if isinstance(e, ev.RequestAdmitted):
            # the last routing of the request before its admission names this replica
            last = [j for j, r in cl.events[:n]
                    if isinstance(r, ev.RequestRouted) and r.req_id == e.req_id]
            assert last and last[-1] == i, (label, e.req_id, i, last)
    failed = [e for _, e in cl.events if isinstance(e, ev.FetchFailed)]
    assert not failed, (label, failed)
    predicted = {e.req_id: (i, e.matched_tokens) for i, e in routed}
    for i in sorted(got):
        rep, r, lgs = got[i]
        diff = (lgs[0] - ref_logits[i][0]).abs().max().item()
        part = next((n for n, (x, y) in enumerate(zip(r.tokens, ref_recs[i].tokens))
                     if x != y), None)
        note = "tokens all equal"
        if part is not None:
            gap = top2_gap(ref_logits[i][part])
            note = f"tokens first differ at {part}, dense top-two gap there {gap:.4f}"
            assert gap < LOGIT_ATOL, (label, i, part, gap)
        log(f"{label} request {i}: routed to replica {predicted[i][0]} (predicted matched "
            f"tokens {predicted[i][1]}), landed on replica {rep}, {r.action} with "
            f"{r.matched_tokens} matched tokens; first-token logits max|cluster - dense| "
            f"= {diff:.4f}; {note}")
        assert len(r.tokens) == NEW_TOKENS and diff <= LOGIT_ATOL, (label, i, diff)
    # a dedup'd write-back keeps the first writer's bytes under the second
    # writer's own stamp: the two agree only if both replicas computed the
    # context to the same bits (a read under a stamp that differs fails as
    # corrupt; logged, and gated above only through FetchFailed)
    stamps = [(i, eid, payload_checksum(eng.backends["s3"].peek(eid))
               == eng.backends["s3"]._checksums[eid])
              for i, eng in enumerate(cl.replicas) if cl._alive[i]
              for eid, e in eng.store.entries.items() if e.tier == "s3"]
    log(f"{label}: s3 entries (replica, entry, stamp equal to the shared bytes): {stamps}")
    log(f"{label}: shared core {json.dumps(cl.core.stats())}; gossip ticks "
        f"{cl.gossip_ticks} (full syncs {cl.gossip_full_syncs}, delta hashes "
        f"{cl.gossip_delta_hashes}); summary {json.dumps(cl.summary().as_dict())}")
    for i, rec in enumerate(recs):
        log(f"{label} replica {i} steps, card wall beside modelled ({card}):")
        log_steps(f"{label} r{i}", rec.steps)
    assert c["packed_flash_attention"] > 0 and c["decode_attention"] > 0, c


def check_cluster_telemetry(label, cl, tel, trace):
    """The telemetry gates of a cluster serve: the ledger conserves per
    replica at 1e-9, the telemetry saw the cluster's stream, each
    ``RequestRouted`` and ``ReplicaCrashed`` exactly once, and the trace
    read back gives the live per-replica audit."""
    trace.close()
    residuals = tel.check_cluster(cl.summary())
    assert all(v <= 1e-9 for per in residuals.values() for v in per.values()), residuals
    assert tel.events == cl.events, label
    by_replica = cluster_audit(cl.events_by_replica)
    assert cluster_audit_from_trace(trace.path) == by_replica, label
    acts = tel.ledger.by_activity()
    log(f"{label} telemetry: conservation residuals {residuals}; "
        f"{sum(isinstance(e, ev.RequestRouted) for _, e in tel.events)} RequestRouted and "
        f"{sum(isinstance(e, ev.ReplicaCrashed) for _, e in tel.events)} ReplicaCrashed seen "
        f"once each; ledger by activity {json.dumps(acts)}; trace {trace.n_events} events, "
        f"{trace.path.stat().st_size} bytes; its audit equals the live one "
        f"({sum(len(r) for r in by_replica.values())} rows)")


def cluster_phase(cfg, params, dense, card, tmp):
    """Three cluster serves of the prefix mix on the cut llama (dense
    decode), held to the dense serve ``dense`` = (records by request, each
    request's per-token logits, launch counts, summary).  ``card`` is the
    card's name and power limit, as nvidia-smi gives them; the traces of
    serves 2 and 3 go to the directory ``tmp``."""
    ref_recs, ref_logits, ref_counts, ref_summary = dense
    n_reqs = len(traffic(cfg.vocab))

    # 1. one replica behind the affinity router, on the dense serve's tiers
    # (no shared tier): the reference's golden-parity invariant on the card
    zero_counts()
    cl, (rec,) = serve_cluster(cfg, params, 1, AffinityRouter())
    c = counts()
    log(f"cluster serve 1 (one replica, affinity) launches: {c}")
    log(f"cluster serve 1 steps, card wall beside modelled ({card}):")
    log_steps("cluster 1", rec.steps)
    got = landed(cl, [rec])
    assert c == ref_counts, (c, ref_counts)
    assert sorted(got) == sorted(ref_recs) and cl.core is None
    assert len(of_type([e for _, e in cl.events], ev.RequestRouted)) == n_reqs
    for i, (_, r, lgs) in got.items():
        assert (r.action, r.matched_tokens, r.tokens) == (
            ref_recs[i].action, ref_recs[i].matched_tokens, ref_recs[i].tokens), i
        assert_close(r, ref_recs[i], f"cluster 1 record {i}")
        assert torch.equal(lgs[0], ref_logits[i][0]), f"cluster 1 request {i}: logits differ"
    assert_close(cl.replicas[0].summary().as_dict(), ref_summary, "cluster 1 summary")
    log(f"cluster serve 1: actions, matched tokens, tokens, first-token logits and launch "
        f"counts equal to the dense serve's; every record field and the summary within 1e-9")
    del cl, rec, got
    release()

    # 2. two replicas behind the affinity router over one shared s3 tier,
    # with telemetry and a trace on
    zero_counts()
    tel, tw = Telemetry(), TraceWriter(tmp / "cluster2.jsonl")
    cl, recs = serve_cluster(cfg, params, 2, AffinityRouter(), tier_specs=CLUSTER_TIERS,
                             cc_kw=dict(gossip_interval_s=GOSSIP_INTERVAL_S, shared_tier="s3"),
                             telemetry=tel, trace=tw)
    check_cluster_serve("cluster serve 2 (two replicas, affinity)", cl, recs, ref_recs,
                        ref_logits, card)
    check_cluster_telemetry("cluster serve 2", cl, tel, tw)
    # the gossiped digests were fresh: every request routed on a digest hit
    # found that many tokens stored where it landed
    realised = {r.req_id: r.matched_tokens for r in cl.records}
    hits = [(e.req_id, e.matched_tokens, realised[e.req_id]) for _, e in cl.events
            if isinstance(e, ev.RequestRouted) and e.matched_tokens > 0]
    assert hits and all(p == m for _, p, m in hits), hits
    affinity = cl.summary().as_dict()
    del cl, recs
    release()

    # 3. two replicas behind round robin, replica 1 crashing inside wave 3.
    # Round robin sends request 7 (context A) to replica 1, which does not
    # hold A: it recomputes A and writes it back, a dedup hit in the shared
    # core.  Replica 1 runs behind replica 0 (its loads from s3 are long), so
    # the crash time is read off its own modelled clock: when its admission
    # of request 7 ends, the crash is scheduled halfway through the dense
    # serve's modelled decode of request 7, while request 7 is in flight.
    inj = FaultInjector(seed=SEED)
    crash_at = []
    left = []  # (released keys reported, keys that left the core) per removal
    released = []  # (entry, payload, stamp) of the crashed replica's s3 entries

    def hooks(cl):
        eng, step, remove = cl.replicas[1], cl.replicas[1].step, cl.remove_replica

        def stepped():
            events = step()
            if not crash_at and any(isinstance(e, ev.PrefillDone) and e.req_id == 7
                                    for e in events):
                crash_at.append(eng.clock.now + 0.5 * ref_recs[7].decode_s)
                inj.schedule_crash(1, crash_at[0])
                log(f"cluster serve 3: replica 1 admitted request 7 by modelled t = "
                    f"{eng.clock.now:.6f} s; crash of replica 1 scheduled at "
                    f"{crash_at[0]:.6f} s")
            return events

        def tracked(idx):
            # kept, and checked after the serve, outside its timed steps
            b = cl.replicas[idx].backends["s3"]
            released.extend((k, b.peek(k), b._checksums[k])
                            for k in b._checksums if b.contains(k))
            before = set(cl.core._keys)
            n = remove(idx)
            left.append((n, before - set(cl.core._keys)))
            return n
        eng.step, cl.remove_replica = stepped, tracked

    zero_counts()
    tel, tw = Telemetry(), TraceWriter(tmp / "cluster3.jsonl")
    cl, recs = serve_cluster(cfg, params, 2, RoundRobinRouter(), setup=hooks,
                             tier_specs=CLUSTER_TIERS, faults=inj,
                             cc_kw=dict(gossip_interval_s=GOSSIP_INTERVAL_S, shared_tier="s3"),
                             telemetry=tel, trace=tw)
    check_cluster_serve("cluster serve 3 (two replicas, round robin, crash)", cl, recs,
                        ref_recs, ref_logits, card)
    check_cluster_telemetry("cluster serve 3", cl, tel, tw)
    log(f"cluster serve 3: replica 1's s3 entries at its release (entry, stamp equal "
        f"to the shared bytes): {[(k, payload_checksum(p) == c) for k, p, c in released]}")
    released.clear()
    stats = cl.core.stats()
    crashed = [e for _, e in cl.events if isinstance(e, ev.ReplicaCrashed)]
    log(f"cluster serve 3: {crashed}; keys that left the core "
        f"{[sorted(k) for _, k in left]}; injector {json.dumps(inj.stats())}")
    assert stats["dedup_hits"] >= 1, stats
    assert len(crashed) == 1 and crashed[0].replica == 1, crashed
    assert crashed[0].inflight + crashed[0].queued >= 1, crashed
    assert len(left) == 1 and crashed[0].released_keys == left[0][0] == len(left[0][1]), left
    assert all(k.startswith("r1:") for k in left[0][1]), left
    assert not [k for k in cl.core._keys if k.startswith("r1:")], cl.core._keys
    # replica 0's stored bytes, A's among them, survive replica 1's release
    r0 = cl.replicas[0].store
    held = [eid for eid, e in r0.entries.items() if e.tier == "s3"]
    assert held, r0.entries
    for eid in held:
        b = r0.backends["s3"]
        assert payload_checksum(b.peek(eid)) == b._checksums[eid], eid
    rr = cl.summary().as_dict()
    log(f"cluster reuse hits: affinity {affinity['reuse_hits']} (hit rate "
        f"{affinity['hit_rate']:.3f}), round robin with the crash {rr['reuse_hits']} "
        f"(hit rate {rr['hit_rate']:.3f}); replica 0 holds {len(held)} readable s3 entries")
    # the counts the reference cluster gives on this mix, at reduced width
    # priced as llama-7b (tests/test_torch_cluster.py::
    # test_smoke_mix_affinity_trails_round_robin): affinity keeps A and B on
    # their ring owner, whose four slots are full when wave 3 arrives (its s3
    # loads take ~1.4 modelled s), so the capacity rule sends wave 3 to the
    # other replica, which recomputes; round robin loses one hit fewer
    assert (affinity["reuse_hits"], rr["reuse_hits"]) == (4, 5), (affinity, rr)
    del cl, recs
    release()


# --------------------------------------------------------------------------- #
# Telemetry phase
# --------------------------------------------------------------------------- #
def telemetry_phase(cfg, params, dense, card, tmp):
    """The dense serve once more with ``obs.Telemetry`` and a JSONL trace on,
    held to the dense serve ``dense`` = (records by request, first-token
    logits, launch counts, summary, step rows): the same tokens, records,
    summary and launch counts, the first-token logits bit for bit; the
    ledger conserves at 1e-9; the trace read back gives the summary, the
    audit and the span trees of the live stream.  Logs the dashboard, the
    trace's size, telemetry's own host time per step and the step walls
    beside the dense serve's."""
    ref_recs, ref_first, ref_counts, ref_summary, ref_steps = dense
    tel = Telemetry()
    path = tmp / "telemetry.jsonl"
    # per step call: [kind, telemetry's own host seconds (on_events + trace write)]
    host = []
    observe = tel.on_events

    def timed_observe(events, **kw):
        t0 = time.perf_counter()
        observe(events, **kw)
        host[-1][1] += time.perf_counter() - t0
    tel.on_events = timed_observe

    with TraceWriter(path) as tw:
        def traced(eng):
            step = eng.step

            def stepped():
                host.append(["idle", 0.0])
                events = step()
                t0 = time.perf_counter()
                tw.write_all(events)
                host[-1][1] += time.perf_counter() - t0
                if any(isinstance(e, ev.BatchAdmitted) for e in events):
                    host[-1][0] = "admission"
                elif any(isinstance(e, ev.TokenEmitted) for e in events):
                    host[-1][0] = "decode"
                return events
            eng.step = stepped

        zero_counts()
        eng, recs, rec, steps, _ = serve(cfg, params, setup=traced, telemetry=tel)
        c = counts()
    log(f"telemetry serve launches: {c}")
    assert c == ref_counts, (c, ref_counts)
    assert sorted(recs) == sorted(ref_recs)
    for i, r in recs.items():
        assert r == ref_recs[i], f"telemetry serve request {i}: record differs"
        assert torch.equal(rec.first_logits[i], ref_first[i]), f"request {i}: logits differ"
    summary = eng.summary()
    assert summary.as_dict() == ref_summary, (summary.as_dict(), ref_summary)
    log("telemetry serve: tokens, records, summary and launch counts equal to the dense "
        "serve's, first-token logits bit for bit")

    residuals = tel.check(summary)
    assert max(residuals.values()) <= 1e-9, residuals
    log(f"telemetry ledger: conservation residuals {residuals}; by activity "
        f"{json.dumps(tel.ledger.by_activity())}; {len(tel.ledger.all_entries())} entries")

    live = rec.events
    replayed = read_events(path)
    assert replayed == live
    assert_close(summarize_events(replayed, storage_cost=summary.storage_cost,
                                  transfer_cost=summary.transfer_cost).as_dict(),
                 summary.as_dict(), "replayed summary")
    rows = audit(live)
    assert audit_from_trace(path) == rows
    spans = build_spans(live)
    assert build_spans(replayed) == spans == tel.engine_spans()
    doc = chrome_trace(spans)
    log(f"telemetry trace: {tw.n_events} events, {path.stat().st_size} bytes; the replay "
        f"gives the summary, the {len(rows)} audit rows and the {len(spans)} span trees "
        f"({sum(1 for s in spans for _ in s.walk())} spans; Chrome trace "
        f"{sum(e['ph'] == 'X' for e in doc['traceEvents'])} complete events, "
        f"{sum(e['ph'] == 'i' for e in doc['traceEvents'])} instants)")
    tel.collect_engine(eng)
    for line in render(tel, summary).splitlines():
        log(f"telemetry dashboard | {line}")
    for line in tel.registry.to_prometheus().splitlines():
        if line.startswith(("jit_bucket_calls", "kv_cache_hit_rate", "store_entries")):
            log(f"telemetry prometheus | {line}")
    for kind in ("admission", "decode", "idle", "all"):
        ms = np.array([h for k, h in host if kind in (k, "all")]) * 1e3
        if len(ms):
            log(f"telemetry host ms per {kind} step (on_events + trace write, perf_counter; "
                f"{len(ms)} steps): median {np.median(ms):.4f}, mean {ms.mean():.4f}, "
                f"max {ms.max():.4f}, total {ms.sum():.3f}")
    log(f"telemetry serve steps, card wall with telemetry and the trace beside the dense "
        f"serve's ({card}):")
    assert len(steps) == len(ref_steps), (len(steps), len(ref_steps))
    for n, (row, ref_row) in enumerate(zip(steps, ref_steps)):
        assert row[0] == ref_row[0], (n, row[0], ref_row[0])
        log(f"telemetry step {n} {row[0]}: wall_ms={1e3 * row[1]:.2f} "
            f"dense wall_ms={1e3 * ref_row[1]:.2f}")
    walls = [(r[1], d[1]) for r, d in zip(steps, ref_steps) if r[0] == "decode"]
    log(f"telemetry decode step wall ms median {1e3 * np.median([w for w, _ in walls]):.2f} "
        f"beside the dense serve's {1e3 * np.median([d for _, d in walls]):.2f}")
    del eng, rec
    release()


# --------------------------------------------------------------------------- #
# Market phase
# --------------------------------------------------------------------------- #
def rows_of(state, n):
    """The first ``n`` positions of batch-1 ``state``, copied on the card
    (so the state itself can be freed)."""
    return compression.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                                paged.slot_artifact(state, 0, n))


def fresh_rows(api, cfg, params, tokens):
    """The spot check's fresh side: ``tokens`` prefilled through
    ``ModelApi.prefill`` into an empty batch-1 state of the serve's length."""
    state = api.init_state(cfg, 1, SERVE["max_len"], device=DEVICE)
    with torch.inference_mode():
        _, state = api.prefill(params, cfg, torch.tensor([tokens], device=DEVICE), state)
    return rows_of(state, len(tokens))


def bought_rows(api, cfg, artifact, n):
    """The spot check's bought side: ``artifact``'s first ``n`` positions
    inserted into an empty batch-1 state."""
    state = api.init_state(cfg, 1, SERVE["max_len"], device=DEVICE)
    paged.insert_slot(cfg, state, 0, artifact, n_tokens=n)
    return rows_of(state, n)


def reading_detail(got, want):
    """The spot check's rule, max over leaves of max|got - want| / max(1,
    max|want|), with where it is read: (reading, leaf index, the leaf's
    max|want|, the largest difference, that difference in bf16 ulps of the
    leaf's max|want|)."""
    best = (0.0, -1, 0.0, 0.0, 0.0)
    for i, (g, w) in enumerate(zip(compression.tree_leaves(got),
                                   compression.tree_leaves(want))):
        g, w = torch.as_tensor(g).double(), torch.as_tensor(w).double()
        d, top = (g - w).abs().max().item(), w.abs().max().item()
        r = d / max(1.0, top)
        if r > best[0]:
            ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 2.0 ** -133
            best = (r, i, top, d, d / ulp)
    return best


def spot_check_witness(api, cfg, params, sample, art, honest):
    """Where the honest reading comes from: the bought rows and the kernel's
    fresh rows each read against a fresh side whose attention is the plain
    version (``flash_attention_plain``) and against one computed in f32
    (weights and activations), and the kernel's fresh rows against the
    plain one's.  Logs each reading with the leaf and magnitude it is read
    at; returns {name: reading}."""
    n = len(sample)
    got = bought_rows(api, cfg, art, n)
    fresh = fresh_rows(api, cfg, params, sample)
    flash = ops.flash_attention
    ops.flash_attention = lambda q, k, v, **kw: fk.flash_attention_plain(q, k, v, **kw)
    try:
        plain = fresh_rows(api, cfg, params, sample)
    finally:
        ops.flash_attention = flash
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = compression.tree_map(lambda t: t.float(), params)
    f32 = fresh_rows(api, cfg32, params32, sample)
    del params32
    release()
    out = {}
    for name, a, b in (("bought vs fresh (kernel)", got, fresh),
                       ("bought vs fresh (plain attention)", got, plain),
                       ("fresh (kernel) vs fresh (plain attention)", fresh, plain),
                       ("bought vs fresh f32", got, f32),
                       ("fresh (kernel) vs fresh f32", fresh, f32)):
        r, leaf, mag, d, ulps = reading_detail(a, b)
        out[name] = r
        log(f"market spot check witness: {name}: reading {r:.6g} at leaf {leaf} "
            f"(leaf max|ref| {mag:.4g}, max|diff| {d:.4g}, {ulps:.2f} bf16 ulps of the "
            f"leaf's max|ref|)")
    assert out["bought vs fresh (kernel)"] == honest, (out, honest)
    return out


def market_phase(cfg, params, card):
    """Two sellers and two buyers of one ``Marketplace`` on the cut llama,
    and a unified-step seller outside it (see the module docstring, phase
    10).  Returns the first layer's inputs of the honest purchase's spot
    check and the ``flash_attention`` launches of that serve."""
    t_phase = time.perf_counter()
    base = traffic(cfg.vocab)
    ctx_a, ctx_b, ctx_bv = (base[i]["context_tokens"] for i in (0, 1, 5))
    rng = np.random.default_rng(SEED + 2)
    ctx_c = rng.integers(0, cfg.vocab, MARKET_C_LEN).tolist()

    def req(i, ctx, arrival_s=0.0):
        return dict(req_id=i, context_tokens=ctx,
                    prompt_tokens=rng.integers(0, cfg.vocab, PROMPT_LEN).tolist(),
                    max_new_tokens=MARKET_NEW_TOKENS, arrival_s=arrival_s, expected_reuses=3)

    sold = [req(0, ctx_a), req(1, ctx_b), req(6, ctx_bv)]
    bought = [req(2, ctx_a), req(3, ctx_a, 1.0)]
    cheat_sold, cheat_bought = [req(4, ctx_c)], [req(5, ctx_c)]
    mp = Marketplace(verify_rate=1.0, seed=0)
    executed = []  # wall s of each Marketplace.execute (delivery, checks, settlement)
    execute = mp.execute

    def timed_execute(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = execute(*args, **kw)
        torch.cuda.synchronize()
        executed.append(time.perf_counter() - t0)
        return out
    mp.execute = timed_execute

    def market_serve(tenant, reqs):
        return serve(cfg, params, planner=MarketPlanner(AlwaysReusePlanner()),
                     market=mp.join(tenant), make_traffic=lambda vocab: reqs)

    def stored(eng, contexts):
        """Each context's stored artifact (host payload) in ``eng``'s store."""
        out = []
        for ctx in contexts:
            e = eng.store.lookup(ctx)[1]
            assert e is not None and e.n_tokens == len(ctx), (e, len(ctx))
            out.append(eng.store.backends[e.tier].peek(e.entry_id))
        return out

    s, _, s_rec, s_steps, s_writebacks = market_serve("s", sold)
    log_steps("market seller s", s_steps)
    assert s_writebacks == 3 and len(s.store.entries) == 3, (s_writebacks, s.store.entries)
    art_a, art_b, art_bv = stored(s, (ctx_a, ctx_b, ctx_bv))
    e_a = s.store.lookup(ctx_a)[1]
    stamp = mp.tenants["s"].checksum(e_a.entry_id)  # the catalog's, before any sale
    del s_rec

    # the buyer's serve; its only flash launches are the spot check's, whose
    # first layer's inputs are kept for the kernel phase
    spot = {}
    flash = ops.flash_attention

    def record_spot(*args, **kw):
        spot.setdefault("inputs", keep(args, kw))
        return flash(*args, **kw)

    zero_counts()
    ops.flash_attention = record_spot
    try:
        b, recs, rec, steps, writebacks = market_serve("b", bought)
    finally:
        ops.flash_attention = flash
    c = counts()
    log(f"market buyer launches: {c} (decode steps {b.decode_stats()['decode_steps']})")
    log_steps("market buyer b", steps)
    log(f"market execute wall ms (delivery, checksum, spot check, settlement): "
        f"{[round(1e3 * w, 2) for w in executed]}")
    purchased = of_type(rec.events, ev.KVPurchased)
    verified = of_type(rec.events, ev.SellerVerified)
    assert [(e.req_id, e.seller, e.buyer) for e in purchased] == [(2, "s", "b")], purchased
    assert [(e.req_id, e.ok, e.deep) for e in verified] == [(2, True, True)], verified
    assert (recs[2].action, recs[2].plan.tier) == ("load", "market:s"), recs[2].plan
    assert recs[3].action == "load" and not recs[3].plan.tier.startswith("market"), recs[3].plan
    assert b.market_purchases == 1 and b.market_failed == 0 and writebacks == 1
    assert c["flash_attention"] == cfg.n_layers, c  # the spot check's lm.prefill
    assert c["packed_flash_attention"] > 0 and c["decode_attention"] > 0, c
    led = mp.settlement
    residual = led.assert_conserved(1e-9)
    assert led.accounts["b"] == -b.market_spend and b.market_spend > 0, led.accounts
    assert payload_checksum(s.store.backends[e_a.tier].peek(e_a.entry_id)) == stamp
    log(f"market purchase: price ${b.market_spend:.6g}, fee ${led.fees_collected:.6g}, "
        f"accounts {led.accounts}, conservation residual {residual}; the seller's stored A "
        f"hashes to its catalog stamp")
    bought_first = rec.first_logits[2]
    del rec, s
    release()

    # the purchase against the same request served with reuse off
    _, off_recs, off_rec, _, _ = serve(cfg, params, reuse=False,
                                       make_traffic=lambda vocab: bought[:1])
    diff = (bought_first - off_rec.first_logits[2]).abs().max().item()
    same = sum(x == y for x, y in zip(recs[2].tokens, off_recs[2].tokens))
    log(f"market purchase: first-token logits max|bought - recompute| = {diff:.4f}, "
        f"tokens agreeing {same}/{MARKET_NEW_TOKENS}")
    assert diff <= LOGIT_ATOL, diff
    del off_rec
    release()

    # a seller whose rows come out of the unified step (the chunked kernel)
    # instead of a packed admission
    v, _, v_rec, _, v_writebacks = serve(
        cfg, params, planner=AlwaysReusePlanner(), make_traffic=lambda vocab: sold,
        paged_decode=True, unified_step=True, kv_block=128)
    assert v_writebacks == 3, v_writebacks
    unified_arts = stored(v, (ctx_a, ctx_b, ctx_bv))
    del v, v_rec
    release()

    # a dishonest seller: its deliveries are corrupted in flight
    t, _, _, _, _ = market_serve("t", cheat_sold)
    (art_c,) = stored(t, (ctx_c,))
    injector = FaultInjector(seed=0)
    injector.arm(corrupt_rate=1.0)
    mp.arm_adversary("t", injector)
    u, u_recs, u_rec, u_steps, _ = market_serve("u", cheat_bought)
    log_steps("market buyer u (adversary)", u_steps)
    kinds = [(type(e).__name__, getattr(e, "ok", None)) for e in u_rec.events
             if isinstance(e, (ev.KVPurchased, ev.SellerVerified, ev.SellerBlacklisted,
                               ev.DegradedToRecompute))]
    assert kinds == [("SellerVerified", False), ("SellerBlacklisted", None),
                     ("DegradedToRecompute", None)], kinds
    assert of_type(u_rec.events, ev.DegradedToRecompute)[0].reason == "market:verify_failed"
    assert mp.reputation.is_blacklisted("t") and led.n_purchases == 1 and mp.purchases == 1
    assert u.market_failed == 1 and u_recs[5].action == "recompute"
    u_first = u_rec.first_logits[5]
    del u_rec, t, u
    release()
    _, off_recs, off_rec, _, _ = serve(cfg, params, reuse=False,
                                       make_traffic=lambda vocab: cheat_bought)
    assert u_recs[5].tokens == off_recs[5].tokens, (u_recs[5].tokens, off_recs[5].tokens)
    assert torch.equal(u_first, off_rec.first_logits[5])
    log(f"market adversary: {kinds}; nothing settled, the buyer's tokens and first-token "
        f"logits those of reuse off; stats {json.dumps({k: v for k, v in mp.stats().items() if k not in ('settlement', 'reputation')})}")
    del off_rec
    release()

    # the spot check's readings: every honest artifact under its own
    # tokens, packed and unified sellers alike; the controls, each
    # context's rows under the other's tokens
    n = mp.verify_sample_tokens
    tol = SPOT_CHECK_TOL[cfg.dtype]
    honest = {}
    for seller, arts in (("packed", (art_a, art_b, art_bv)), ("unified", unified_arts)):
        for name, ctx, art in zip(("A", "B", "B variant"), (ctx_a, ctx_b, ctx_bv), arts):
            honest[f"{name} ({seller} seller)"] = b.spot_check_reading(ctx[:n], art)
    honest["C (packed seller t)"] = b.spot_check_reading(ctx_c[:n], art_c)
    control = {"B's rows under A's tokens": b.spot_check_reading(ctx_a[:n], art_b),
               "A's rows under B's tokens": b.spot_check_reading(ctx_b[:n], art_a)}
    ok_honest = b.market_spot_check(ctx_a, art_a, n)[0]
    ok_control = b.market_spot_check(ctx_a, art_b, n)[0]
    check_ms = time_ms(lambda: b.market_spot_check(ctx_a, art_a, n), reps=5)
    worst, least = max(honest.values()), min(control.values())
    log(f"market spot check ({n} tokens, {card}): honest readings "
        f"{ {k: float(f'{r:.6g}') for k, r in honest.items()} }, largest {worst:.6g}; "
        f"control readings { {k: float(f'{r:.6g}') for k, r in control.items()} }, "
        f"least {least:.6g}; {cfg.dtype} tol {tol:g} (tol / largest honest "
        f"{tol / worst if worst else math.inf:.2f}, least control / tol {least / tol:.1f}); "
        f"{check_ms:.3f} ms a check")
    assert ok_honest and not ok_control, (ok_honest, ok_control)
    assert worst <= tol and least >= 10 * tol, (honest, control, tol)
    # the sessions hold every tenant's engine: free them for the f32 weights
    del b, mp, execute, timed_execute
    release()
    spot_check_witness(get_model(cfg), cfg, params, ctx_a[:n], art_a,
                       honest["A (packed seller)"])
    log(f"market phase wall: {time.perf_counter() - t_phase:.1f} s")
    return spot["inputs"], c["flash_attention"]


def launcher_phase():
    """``python -m repro_torch.launch.serve --requests 8 --contexts 2 --policy
    always --compress --json`` on the card (reduced compute, full-size
    economics): its write-backs and loads go through the int8 kernels."""
    zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve_cli.main(["--requests", "8", "--contexts", "2", "--policy", "always",
                        "--compress", "--json"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts()
    out = json.loads(buf.getvalue())
    log(f"launcher --compress: {wall:.1f} s, reuse_hits {out['reuse_hits']}, store entries "
        f"{out['store']['entries']}, io2 used_gb {out['store']['tiers']['io2']['used_gb']}, "
        f"total_cost {out['total_cost']}; launches {c}")
    assert c["kv_quant"] > 0 and c["kv_dequant"] > 0, c
    assert out["reuse_hits"] >= 4 and out["n_requests"] == 8, out
    zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_cli.main(["--requests", "8", "--contexts", "2", "--overlap", "--hedge", "--json"])
    c = counts()
    out = json.loads(buf.getvalue())
    log(f"launcher --overlap --hedge: reuse_hits {out['reuse_hits']}, mean_ttft_s "
        f"{out['mean_ttft_s']}, total_cost {out['total_cost']}; launches {c}")
    assert c["packed_flash_attention"] > 0 and out["n_requests"] == 8, (c, out)


def zeroed_ssd(artifact):
    """A stored artifact with every Mamba layer's SSD state zeroed, the conv
    tails and any attention layer's K/V kept (the control of the SSM and
    hybrid phases)."""
    return paged.LMState(pos=artifact.pos, caches=tuple(
        c if c.mamba is None else
        paged.BlockCache(None, c.mamba._replace(ssd=np.zeros_like(c.mamba.ssd)))
        for c in artifact.caches))


def prompt_after(cfg, params, artifact, prompt):
    """``ModelApi.prefill`` of ``prompt`` after ``artifact`` inserted into a
    fresh slot (the load path's shape); the last token's logits on the host."""
    api = get_model(cfg)
    state = api.init_state(cfg, 1, SERVE["max_len"], device=DEVICE)
    paged.insert_slot(cfg, state, 0, artifact)
    with torch.inference_mode():
        logits, _ = api.prefill(params, cfg, torch.tensor([prompt], device=DEVICE), state)
    return logits[0].float().cpu()


def ssm_phase():
    """Serve the prefix mix on full-width mamba2-1.3b (bf16, random weights)
    with reuse on, with reuse off and with ``paged_decode=True``, and run the
    per-request prefill and the zeroed-state control.  Returns the SSD
    kernel's recorded inputs and its launches in the reuse-on serve."""
    cfg = get_config("mamba2-1.3b")
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    log(f"mamba2-1.3b bf16: {sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B params "
        f"drawn in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on the card")
    reqs = traffic(cfg.vocab)
    zero_counts()
    eng, recs, rec, steps, writebacks = serve(cfg, params)
    c = counts()
    n_prefill = rec.prefill_calls
    log(f"ssm serve launches: {c} (ModelApi.prefill calls {n_prefill}, decode steps "
        f"{eng.decode_stats()['decode_steps']})")
    log_steps("ssm", steps)
    actions = {i: (r.action, r.matched_tokens) for i, r in sorted(recs.items())}
    log(f"ssm actions (action, matched tokens): {actions}; write-backs {writebacks}")
    assert [a for a, _ in actions.values()] == SSM_ACTIONS, actions
    assert all(recs[i].plan.store_after for i in (0, 1)) and writebacks == 2, writebacks
    assert len(recs) == 8 and all(len(r.tokens) == NEW_TOKENS for r in recs.values())
    # two calls per recompute that writes back, one per load or plain recompute
    assert n_prefill == 2 * 2 + 6, n_prefill
    assert c["ssd_chunked"] == cfg.n_layers * n_prefill, c
    assert sum(c.values()) == c["ssd_chunked"], c
    assert eng.batches == 0 and eng.decode_stats()["paged"] is False
    tokens_a = reqs[0]["context_tokens"]
    artifact = stored_artifact(eng, tokens_a)
    log(f"ssm store: {len(eng.store.entries)} entries of "
        f"{sorted(e.nbytes for e in eng.store.entries.values())} bytes; summary "
        f"{json.dumps(eng.summary().as_dict())}")
    first, ssd_inputs, launches = rec.first_logits, rec.ssd_inputs, c["ssd_chunked"]
    del eng, rec
    release()

    zero_counts()
    _, base_recs, base_rec, _, _ = serve(cfg, params, reuse=False)
    base_counts = counts()
    assert base_counts["ssd_chunked"] == cfg.n_layers * len(reqs), base_counts
    loads = [i for i, (a, _) in actions.items() if a == "load"]
    reading, agree = 0.0, 0
    for i in loads:
        diff = (first[i] - base_rec.first_logits[i]).abs().max().item()
        same = sum(x == y for x, y in zip(recs[i].tokens, base_recs[i].tokens))
        reading, agree = max(reading, diff), agree + same
        log(f"ssm request {i} (load): first-token logits max|reuse - recompute| = {diff:.4f}, "
            f"tokens agreeing {same}/{NEW_TOKENS}")
    log(f"ssm reuse vs recompute: token agreement {agree}/{NEW_TOKENS * len(loads)}")

    # the per-request entry point: context and prompt in one call, against
    # the engine's recomputes (two-phase with the write-back; one call
    # without it); then the control
    api = get_model(cfg)
    for i in (0, 1, 5):
        r = reqs[i]
        state = api.init_state(cfg, 1, SERVE["max_len"], device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, state = api.prefill(params, cfg, torch.tensor(
                [r["context_tokens"] + r["prompt_tokens"]], device=DEVICE), state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        diff = (logits[0].float().cpu() - first[i]).abs().max().item()
        # the two-phase recompute splits the scan at the context's end, as a
        # load does; request 5's recompute is the same one call
        gate = SSM_LOGIT_ATOL if i < 2 else SSM_REBUILD_ATOL
        log(f"ssm prefill request {i} ({int(state.pos[0])} tokens in one call): wall_ms="
            f"{1e3 * wall:.2f}, last-token logits max|prefill - engine recompute"
            f"{' (two-phase)' if i < 2 else ''}| = {diff:.3e} (gate {gate})")
        assert diff <= gate, (i, diff)
        del state
    load_req = reqs[loads[0]]
    assert load_req["context_tokens"] == tokens_a
    rebuilt = prompt_after(cfg, params, artifact, load_req["prompt_tokens"])
    control = prompt_after(cfg, params, zeroed_ssd(artifact), load_req["prompt_tokens"])
    same = (rebuilt - first[loads[0]]).abs().max().item()
    ctrl = (control - base_rec.first_logits[loads[0]]).abs().max().item()
    log(f"ssm request {loads[0]}'s load rebuilt from the store: max|rebuilt - served| = "
        f"{same:.3e} (gate {SSM_REBUILD_ATOL}); control with the stored SSD state zeroed "
        f"(conv tail kept): "
        f"max|control - recompute| = {ctrl:.4f} (gate {SSM_LOGIT_ATOL}, reading {reading:.4f})")
    assert reading <= SSM_LOGIT_ATOL < ctrl, (reading, ctrl)
    assert same <= SSM_REBUILD_ATOL, same
    del base_rec, artifact
    release()

    zero_counts()
    peng, precs, _, _, _ = serve(cfg, params, paged_decode=True, kv_block=128)
    pc = counts()
    log(f"ssm paged_decode=True serve: decode_stats {json.dumps(peng.decode_stats())}; "
        f"launches {pc}")
    assert peng.decode_stats()["paged"] is False and pc == c, (pc, c)
    assert {i: (r.action, r.tokens) for i, r in precs.items()} == {
        i: (r.action, r.tokens) for i, r in recs.items()}
    del peng, params
    release()
    return ssd_inputs, launches


# --------------------------------------------------------------------------- #
# Other families: mistral-nemo-12b (dense GQA) and olmoe-1b-7b (MoE)
# --------------------------------------------------------------------------- #
PAD_OWNER, DECODE_OWNER = -1, -2  # token owners that are not a prefilling request


class DropRecorder:
    """The MoE routing of every launch of one serve (``moe.dispatch``): each
    layer's token count T, capacity C and kept pairs, the card time of each
    layer's MoE FFN (CUDA events around ``moe.apply_moe``), and who owns each
    token of the launch: a prefilling request, a decode row, or padding.
    Nothing is read back until ``resolve``, so recording adds no sync to the
    steps the serve times.  ``install`` is ``serve``'s setup hook."""

    def __init__(self):
        self.launches = []  # dict(kind, owner [T] np, layers [(T, C, keep, token)], events)
        self._single = PAD_OWNER
        self._dispatch, self._apply = moe.dispatch, moe.apply_moe
        moe.dispatch, moe.apply_moe = self._record_dispatch, self._timed_apply

    def close(self):
        moe.dispatch, moe.apply_moe = self._dispatch, self._apply

    def install(self, eng):
        self.eng = eng
        api = eng.api
        admit = eng._admit_single

        def admit_single(req, *args, **kw):
            self._single = req.req_id  # the request the next prefill calls serve
            return admit(req, *args, **kw)
        eng._admit_single = admit_single
        eng.api = api._replace(
            prefill=self._launch("single", api.prefill),
            prefill_packed=self._launch("packed", api.prefill_packed),
            prefill_chunked=self._launch("chunked", api.prefill_chunked),
            decode=self._launch("decode", api.decode),
            decode_paged=self._launch("decode", api.decode_paged))

    def _owner(self, kind, tokens, kw):
        if kind == "single":  # a per-request ``prefill`` call: one request
            return np.full(tokens.shape[1], self._single, np.int64)
        if kind == "packed":  # segment index (mapped to a request in resolve)
            return kw["q_seg"][0].cpu().numpy().astype(np.int64)
        slots = self.eng.slots
        if kind == "decode":
            return np.array([DECODE_OWNER if s.active else PAD_OWNER for s in slots])
        prefilling = {c.a.slot.index: c.a.req.req_id for c in self.eng._chunks.values()}
        valid = kw["q_pos"].cpu().numpy() >= 0
        owner = np.full(valid.shape, PAD_OWNER, np.int64)
        for b in range(valid.shape[0]):
            owner[b][valid[b]] = prefilling.get(b, DECODE_OWNER)
        return owner.reshape(-1)

    def _launch(self, kind, fn):
        def run(params, cfg, tokens, caches, **kw):
            self.launches.append(dict(kind=kind, owner=self._owner(kind, tokens, kw),
                                      layers=[], events=[]))
            return fn(params, cfg, tokens, caches, **kw)
        return run

    def _record_dispatch(self, p, cfg, xf):
        d = self._dispatch(p, cfg, xf)
        self.launches[-1]["layers"].append((xf.shape[0], d.capacity, d.keep, d.token))
        return d

    def _timed_apply(self, p, cfg, x):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self._apply(p, cfg, x)
        end.record()
        self.launches[-1]["events"].append((start, end))
        return out

    def resolve(self, events, label):
        """Read the routing back and log it: for each prefill launch its T,
        C, the MoE FFN's card ms and the pairs dropped in each layer, real
        tokens' (by request) apart from padding's; the decode launches in
        one line.  Returns each request's real pairs dropped before its
        first token (in the launches that prefilled it)."""
        torch.cuda.synchronize()
        batches = iter([e.req_ids for e in events if isinstance(e, ev.BatchAdmitted)])
        first = {}
        decode = dict(n=0, T=set(), C=set(), dropped=0, moe_ms=[])
        for n, L in enumerate(self.launches):
            owner = L["owner"]
            if L["kind"] == "packed":
                ids = np.asarray(next(batches))
                owner = np.where(owner >= 0, ids[owner.clip(0)], owner)
            moe_ms = sum(a.elapsed_time(b) for a, b in L["events"])
            real, pad, rows = [], [], []
            for T, C, keep, token in L["layers"]:
                own = owner[token[~keep].cpu().numpy()]
                by_req = {int(r): int((own == r).sum()) for r in np.unique(own[own >= 0])}
                for r, k in by_req.items():
                    first[r] = first.get(r, 0) + k
                real.append(sum(by_req.values()))
                pad.append(int((own == PAD_OWNER).sum()))
                rows.append(int((own == DECODE_OWNER).sum()))
            T, C = L["layers"][0][:2]
            if L["kind"] == "decode":
                decode["n"] += 1
                decode["T"].add(T)
                decode["C"].add(C)
                decode["dropped"] += sum(real) + sum(pad) + sum(rows)
                decode["moe_ms"].append(moe_ms)
                continue
            reqs = sorted({int(r) for r in owner if r >= 0})
            log(f"{label} launch {n} {L['kind']} requests {reqs}: T={T} C={C} "
                f"moe_ms={moe_ms:.2f}; pairs dropped per layer: real tokens {real}, "
                f"padding {pad}" + (f", decode rows {rows}" if any(rows) else ""))
        if decode["n"]:
            log(f"{label} decode launches {decode['n']}: T={sorted(decode['T'])} "
                f"C={sorted(decode['C'])}, pairs dropped {decode['dropped']}; moe_ms median "
                f"{np.median(decode['moe_ms']):.2f}")
            assert decode["dropped"] == 0, decode  # C >= T*k/E*cf >= T: none can drop
        return first


def gate_reuse(label, runs, mode, base="reuse off", atol=LOGIT_ATOL):
    """Reused against recomputed first-token logits within ``atol``, for
    every reused request whose tokens dropped no pair on either side; one
    that did is logged beside its drops, not gated.  Returns the number of
    requests gated."""
    got, want = runs[mode], runs[base]
    gated = 0
    for i, (action, _) in sorted(got["actions"].items()):
        if action not in ("load", "partial"):
            continue
        diff = (got["first"][i] - want["first"][i]).abs().max().item()
        same = sum(x == y for x, y in zip(got["recs"][i].tokens, want["recs"][i].tokens))
        drops = (got["drops"].get(i, 0), want["drops"].get(i, 0))
        if any(drops):
            log(f"{label} {mode} request {i} ({action}): first-token logits max|reuse - "
                f"recompute| = {diff:.4f}, tokens agreeing {same}/{NEW_TOKENS}; real pairs "
                f"dropped (reuse, recompute) {drops}: not gated")
            continue
        log(f"{label} {mode} request {i} ({action}): first-token logits max|reuse - "
            f"recompute| = {diff:.4g} (gate {atol}), tokens agreeing {same}/{NEW_TOKENS}")
        assert diff <= atol, (label, mode, i, diff)
        gated += 1
    log(f"{label} {mode}: {gated} reused requests gated")
    return gated


def family_params(name, **cut):
    cfg = dataclasses.replace(get_config(name), **cut)
    t0 = time.perf_counter()
    params = get_model(cfg).init(cfg, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    log(f"{name}{f' cut to {cut}' if cut else ''} bf16: "
        f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B params "
        f"({count_active_params(cfg) / 1e9:.3f} B active a token) drawn in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated on the card")
    return cfg, params


def family_serve(label, cfg, params, mode, keep_stored=(), flash=False, **kw):
    """One serve of the prefix mix (or of ``make_traffic``'s, passed on to
    ``serve`` with the planner), its routing recorded where the arch has
    experts and, with ``flash``, the first layer's ``flash_attention``
    inputs of its per-request admissions (one launch a layer a
    ``ModelApi.prefill`` call); returns its run (records, actions, logits,
    launches, drops, and the stored artifacts of the contexts
    ``keep_stored`` names, on the host) and the recorders' kernel inputs."""
    drops = DropRecorder() if cfg.moe is not None else None
    recorder = FlashRecorder(cfg.n_layers) if flash else None
    hooks = [h for h in (drops, recorder) if h is not None]

    def setup(eng):
        for h in hooks:
            h.install(eng)

    zero_counts()
    try:
        eng, recs, rec, steps, writebacks = serve(cfg, params, setup=setup, **kw)
    finally:
        for h in hooks:
            h.close()
    c = counts()
    n_decode = eng.decode_stats()["decode_steps"]
    mixed = eng.unified_stats()["steps"]
    actions = {i: (r.action, r.matched_tokens) for i, r in sorted(recs.items())}
    log(f"{label} {mode} serve launches: {c} (ModelApi.prefill calls {rec.prefill_calls}, "
        f"decode steps {n_decode}, mixed steps {mixed}, packed batches {eng.batches}); actions "
        f"{actions}; write-backs {writebacks}")
    log_steps(f"{label} {mode}", steps)
    assert len(recs) == 8 and all(len(r.tokens) == NEW_TOKENS for r in recs.values())
    L = cfg.n_layers
    assert c["flash_attention"] == (L * rec.prefill_calls if flash else 0), c
    assert not flash or rec.prefill_calls > 0, rec.prefill_calls
    assert c["fused_flash_attention"] == c["ssd_chunked"] == 0, c
    assert c["kv_quant"] == c["kv_dequant"] == 0, c
    if kw.get("unified_step"):
        assert c["chunked_prefill_attention"] == L * mixed > 0, c
        assert c["paged_decode_attention"] == L * n_decode and c["packed_flash_attention"] == 0
    elif kw.get("paged_decode"):
        assert c["paged_decode_attention"] == L * n_decode > 0 and c["decode_attention"] == 0
        assert c["packed_flash_attention"] > 0 and c["chunked_prefill_attention"] == 0, c
    else:
        assert c["decode_attention"] == L * n_decode > 0 and c["paged_decode_attention"] == 0
        assert c["packed_flash_attention"] > 0 and c["chunked_prefill_attention"] == 0, c
    if kw.get("paged_decode"):
        eng._paged.audit()
        assert eng._paged.pool.n_used == 0
    if kw.get("reuse", True):
        assert any(a in ("load", "partial") for a, _ in actions.values()), actions
    run = dict(recs=recs, actions=actions, first=rec.first_logits, steps=rec.step_logits,
               counts=c, drops=drops.resolve(rec.events, f"{label} {mode}") if drops else {},
               stored={tuple(t): stored_artifact(eng, list(t)) for t in keep_stored})
    inputs = dict(packed=rec.packed_inputs, decode=rec.decode_inputs,
                  chunked=rec.chunked_inputs, flash=recorder.inputs if flash else None)
    assert inputs["chunked" if kw.get("unified_step") else "decode"] is not None, inputs
    del eng, rec
    release()
    return run, inputs


def nemo_phase():
    """Full-width mistral-nemo-12b (bf16, random weights; H·hd 4096 against
    d_model 5120, 4 query heads a kv head) serves the prefix mix dense with
    reuse on and off; returns its first layer's packed and decode inputs
    and the dense serve's launches."""
    cfg, params = family_params("mistral-nemo-12b")
    runs = {}
    runs["dense"], inputs = family_serve("nemo", cfg, params, "dense")
    runs["reuse off"], _ = family_serve("nemo", cfg, params, "reuse off", reuse=False)
    assert gate_reuse("nemo", runs, "dense") > 0, "nemo: no reused request gated"
    del params
    release()
    return inputs, runs["dense"]["counts"]


MOE_MODES = (("dense", {}), ("paged", dict(paged_decode=True, kv_block=128)),
             ("unified", dict(paged_decode=True, unified_step=True, kv_block=128)),
             ("reuse off", dict(reuse=False)))
# the dropless serves: capacity factor n_experts / top_k, so C >= T and no
# pair drops (the rule of the reference's reduced configs)
DROPLESS_MODES = ("dense", "unified", "reuse off")


def moe_phase():
    """Full-width olmoe-1b-7b (bf16, random weights, 64 experts, top-8)
    serves the prefix mix dense, paged and unified and with reuse off at its
    capacity factor 1.25, then dense, unified and with reuse off dropless
    (see the module docstring, phase 13).  Returns its first layer's kernel
    inputs of each capacity-1.25 serve and the launches of every serve."""
    cfg, params = family_params("olmoe-1b-7b")
    dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    runs, inputs = {}, {}
    for mode, kw in MOE_MODES:
        runs[mode], inputs[mode] = family_serve("olmoe", cfg, params, mode, **kw)
    for mode in DROPLESS_MODES:
        runs[f"dropless {mode}"], _ = family_serve("olmoe", dropless, params,
                                                   f"dropless {mode}", **dict(MOE_MODES)[mode])
        assert not runs[f"dropless {mode}"]["drops"], runs[f"dropless {mode}"]["drops"]
    dense = runs["dense"]
    for mode in ("paged", "unified", "dropless dense", "dropless unified"):
        assert runs[mode]["actions"] == dense["actions"], (mode, runs[mode]["actions"])
    paged_run = runs["paged"]
    same_first = all(torch.equal(paged_run["first"][i], dense["first"][i]) for i in dense["first"])
    same_steps = sum(torch.equal(a[1], b[1]) for a, b in zip(paged_run["steps"], dense["steps"]))
    log(f"olmoe paged vs dense: first-token logits equal bit for bit {same_first}; decode steps "
        f"with equal logits {same_steps}/{len(dense['steps'])}")
    assert {i: r.tokens for i, r in paged_run["recs"].items()} == {
        i: r.tokens for i, r in dense["recs"].items()}, "olmoe: paged tokens differ from dense"
    for mode in ("dense", "paged", "unified"):
        gate_reuse("olmoe", runs, mode)
    n_reused = sum(a in ("load", "partial") for a, _ in dense["actions"].values())
    for mode in ("dropless dense", "dropless unified"):
        gated = gate_reuse("olmoe", runs, mode, base="dropless reuse off")
        assert gated == n_reused > 0, (mode, gated, n_reused)
    del params
    release()
    return inputs, {mode: runs[mode]["counts"] for mode in runs}


# --------------------------------------------------------------------------- #
# Sliding-window phase (mixtral-8x22b's ring-buffer KV cache)
# --------------------------------------------------------------------------- #
def swa_traffic(vocab: int):
    """Eight requests over two ``SWA_CTX_LEN``-token contexts A and B, each
    longer than the window, in four waves one modelled second apart: wave 0
    recomputes A and B and writes them back, wave 1 loads them, wave 2
    sends A extended by ``SWA_EXTEND`` tokens (a ``partial`` of A's whole
    stored context) and a variant of B that shares only its first
    ``VARIANT_SHARED`` tokens (no usable match: ROADMAP C11), wave 3 loads A
    twice."""
    rng = np.random.default_rng(SEED + 2)
    a = rng.integers(0, vocab, SWA_CTX_LEN).tolist()
    b = rng.integers(0, vocab, SWA_CTX_LEN).tolist()
    a_ext = a + rng.integers(0, vocab, SWA_EXTEND).tolist()
    b_variant = b[:VARIANT_SHARED] + rng.integers(
        0, vocab, SWA_CTX_LEN - VARIANT_SHARED + 16).tolist()
    contexts = [a, b, a, b, a_ext, b_variant, a, a]
    return [
        dict(req_id=i, context_tokens=ctx,
             prompt_tokens=rng.integers(0, vocab, PROMPT_LEN).tolist(),
             max_new_tokens=NEW_TOKENS, arrival_s=float(i // 2), expected_reuses=3)
        for i, ctx in enumerate(contexts)
    ]


# the ring serve's expected plans: (action, matched tokens) by request
SWA_PLANS = {0: ("recompute", 0), 1: ("recompute", 0), 2: ("load", 6000), 3: ("load", 6000),
             4: ("partial", 6000), 5: ("recompute", 0), 6: ("load", 6000), 7: ("load", 6000)}


class FlashRecorder:
    """The first attention layer's ``flash_attention`` inputs of two
    launches of a per-request serve: its first (wave 0's context; on
    mixtral's ring, queries past the window) and the first one inside a load
    (the suffix over stored rows; on a stored ring the window masks its
    oldest rows).  ``n_attn`` is the stack's attention layers, one launch
    each per ``prefill`` call.  ``install`` is ``serve``'s setup hook."""

    def __init__(self, n_attn):
        self.n_attn, self.inputs, self._calls, self._loading = n_attn, {}, 0, False
        self._flash = ops.flash_attention
        ops.flash_attention = self._record

    def close(self):
        ops.flash_attention = self._flash

    def install(self, eng):
        load = eng._execute_load

        def run(*args, **kw):
            self._loading = True
            try:
                return load(*args, **kw)
            finally:
                self._loading = False
        eng._execute_load = run

    def _record(self, *args, **kw):
        if self._calls % self.n_attn == 0:
            label = "wave 0" if self._calls == 0 else "suffix" if self._loading else None
            if label is not None and label not in self.inputs:
                self.inputs[label] = keep(args, kw)
        self._calls += 1
        return self._flash(*args, **kw)


def ring_serve(cfg, params, reuse=True):
    """One serve of ``swa_traffic`` with ``max_len=SWA_MAX_LEN`` (a ring of
    ``window`` rows): per-request admissions through ``ModelApi.prefill``
    and dense decode.  Returns its run (records, actions, logits, launches),
    the recorded flash and decode inputs and the engine."""
    flash = FlashRecorder(cfg.n_layers)
    zero_counts()
    try:
        eng, recs, rec, steps, writebacks = serve(
            cfg, params, reuse=reuse, make_traffic=swa_traffic, setup=flash.install,
            max_len=SWA_MAX_LEN)
    finally:
        flash.close()
    c = counts()
    n_decode = eng.decode_stats()["decode_steps"]
    actions = {i: (r.action, r.matched_tokens) for i, r in sorted(recs.items())}
    mode = "ring" if reuse else "ring reuse off"
    log(f"mixtral {mode} serve launches: {c} (decode steps {n_decode}, prefill calls "
        f"{rec.prefill_calls}); actions {actions}; write-backs {writebacks}")
    log_steps(f"mixtral {mode}", steps)
    L = cfg.n_layers
    assert len(recs) == 8 and all(len(r.tokens) == NEW_TOKENS for r in recs.values())
    assert c["flash_attention"] == L * rec.prefill_calls > 0, c
    assert c["decode_attention"] == L * n_decode > 0, c
    others = sum(v for k, v in c.items() if k not in ("flash_attention", "decode_attention"))
    assert others == 0, c
    assert eng.packed_stats()["batches"] == 0 and not eng.decode_stats()["paged"]
    assert eng._state.caches[0].attn.k.shape[2] == cfg.sliding_window  # the ring
    run = dict(recs=recs, actions=actions, first=rec.first_logits, steps=rec.step_logits,
               counts=c, drops={})
    inputs = dict(flash=flash.inputs, decode=rec.decode_inputs)
    return run, inputs, eng


def swa_phase():
    """Full-width mixtral-8x22b cut to ``SWA_DEPTH`` layers (bf16, random
    weights): the ring serve with reuse on and off, its gates and the C11
    control, then the packable serves at ``max_len == window`` (see the
    module docstring, phase 14).  Returns the recorded kernel inputs and the
    launches of every serve."""
    cfg, params = family_params("mixtral-8x22b", n_layers=SWA_DEPTH)
    # the dropless capacity factor n_experts / top_k: C >= T, no pair drops
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    W = cfg.sliding_window
    runs, inputs = {}, {}
    runs["ring"], inputs["ring"], eng = ring_serve(cfg, params)
    reqs = swa_traffic(cfg.vocab)
    assert runs["ring"]["actions"] == SWA_PLANS, runs["ring"]["actions"]
    assert set(inputs["ring"]["flash"]) == {"wave 0", "suffix"}, inputs["ring"]["flash"].keys()
    assert int(inputs["ring"]["flash"]["wave 0"][1]["q_pos"].max()) >= W
    # every stored artifact is the ring: W rows a layer, whatever the context
    kv_bytes = {}
    for i in (0, 1):
        art = stored_artifact(eng, reqs[i]["context_tokens"])
        a = art.caches[0].attn
        kv_bytes[i] = int(a.k.nbytes + a.v.nbytes)
        assert a.k.shape == (SWA_DEPTH, 1, W, cfg.n_kv_heads, cfg.resolved_head_dim), a.k.shape
        assert paged.artifact_length(art) == SWA_CTX_LEN
    size = a.k.dtype.itemsize  # bf16 rows are kept as their 2-byte pattern
    want = W * SWA_DEPTH * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * size
    log(f"mixtral stored K/V bytes of A and B: {kv_bytes} (want {want} each: {W} rows x "
        f"{SWA_DEPTH} layers x K, V x {cfg.n_kv_heads} x {cfg.resolved_head_dim} x {size} B)")
    assert kv_bytes == {0: want, 1: want}, kv_bytes
    # the control: B's variant rebuilt the reference's way, reading rows
    # [:VARIANT_SHARED] of B's wrapped stored ring as positions 0..1599
    api = get_model(cfg)
    art_b = stored_artifact(eng, reqs[1]["context_tokens"])
    del eng
    release()
    state = api.init_state(cfg, 1, SWA_MAX_LEN, device=DEVICE)
    paged.insert_slot(cfg, state, 0, art_b, n_tokens=VARIANT_SHARED)
    variant = reqs[5]
    suffix = variant["context_tokens"][VARIANT_SHARED:] + variant["prompt_tokens"]
    control, _ = api.prefill(params, cfg, torch.tensor([suffix], device=DEVICE), state)
    control = control[0].float().cpu()
    del state, art_b
    release()

    runs["ring reuse off"], _, eng = ring_serve(cfg, params, reuse=False)
    del eng
    release()
    n_reused = sum(a in ("load", "partial") for a, _ in SWA_PLANS.values())
    assert gate_reuse("mixtral", runs, "ring", base="ring reuse off") == n_reused
    off5 = runs["ring reuse off"]["first"][5]
    served5 = (runs["ring"]["first"][5] - off5).abs().max().item()
    diff = (control - off5).abs().max().item()
    log(f"mixtral C11 control (request 5, B's variant, its first {VARIANT_SHARED} rows read "
        f"from B's wrapped ring as positions 0..{VARIANT_SHARED - 1}): first-token logits "
        f"max|control - recompute| = {diff:.4f} (must exceed {LOGIT_ATOL}); the served "
        f"request (recomputed) {served5:.4f}")
    assert diff > LOGIT_ATOL, diff
    assert served5 <= LOGIT_ATOL, served5

    # the packable serves: max_len == window, the prefix mix of phase 1
    assert SERVE["max_len"] == W and paged.packable_arch(cfg, SERVE["max_len"])
    for mode, kw in (("dense", {}), ("unified", dict(paged_decode=True, unified_step=True,
                                                     kv_block=128)),
                     ("reuse off", dict(reuse=False))):
        runs[mode], inputs[mode] = family_serve("mixtral", cfg, params, mode, **kw)
        assert not runs[mode]["drops"], runs[mode]["drops"]
    assert runs["unified"]["actions"] == runs["dense"]["actions"], runs["unified"]["actions"]
    for mode in ("dense", "unified"):
        assert gate_reuse("mixtral", runs, mode) > 0, mode
    # once at the capacity factor 1.25, the drops logged and not gated (C10)
    c125 = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
    runs["dense cf 1.25"], _ = family_serve("mixtral", c125, params, "dense cf 1.25")
    del params
    release()
    return inputs, {mode: runs[mode]["counts"] for mode in runs}


# --------------------------------------------------------------------------- #
# Hybrid phase (jamba-1.5-large-398b: Mamba, attention and MoE in one stack)
# --------------------------------------------------------------------------- #
def hybrid_serve(cfg, params, mode, **kw):
    """One serve of the prefix mix on the hybrid stack: per-request
    admissions through ``ModelApi.prefill`` (four ``ssd_chunked`` and one
    ``flash_attention`` launch a call at the cut) and dense decode (one
    ``decode_attention`` a step), each launch's routing recorded.  Returns
    its run (records, actions, logits, launches, drops), the recorded kernel
    inputs and the engine."""
    flash, drops = FlashRecorder(cfg.n_attn_layers), DropRecorder()

    def setup(eng):
        flash.install(eng)
        drops.install(eng)

    zero_counts()
    try:
        eng, recs, rec, steps, writebacks = serve(cfg, params, setup=setup, **kw)
    finally:
        flash.close()
        drops.close()
    c = counts()
    n_calls, n_decode = rec.prefill_calls, eng.decode_stats()["decode_steps"]
    actions = {i: (r.action, r.matched_tokens) for i, r in sorted(recs.items())}
    log(f"jamba {mode} serve launches: {c} (ModelApi.prefill calls {n_calls}, decode steps "
        f"{n_decode}); actions {actions}; write-backs {writebacks}")
    log_steps(f"jamba {mode}", steps)
    assert len(recs) == 8 and all(len(r.tokens) == NEW_TOKENS for r in recs.values())
    assert c["ssd_chunked"] == cfg.n_ssm_layers * n_calls > 0, c
    assert c["flash_attention"] == cfg.n_attn_layers * n_calls, c
    assert c["decode_attention"] == cfg.n_attn_layers * n_decode > 0, c
    assert sum(c.values()) == sum(c[k] for k in (
        "ssd_chunked", "flash_attention", "decode_attention")), c
    assert eng.batches == 0 and eng.decode_stats()["paged"] is False
    run = dict(recs=recs, actions=actions, first=rec.first_logits, steps=rec.step_logits,
               counts=c, drops=drops.resolve(rec.events, f"jamba {mode}"))
    inputs = dict(flash=flash.inputs, decode=rec.decode_inputs, ssd=rec.ssd_inputs)
    return run, inputs, eng


def hybrid_phase():
    """Full-width jamba-1.5-large-398b cut to ``HYBRID_CUT`` (bf16, random
    weights): the prefix mix dropless with reuse on and off, the reuse gate,
    the stored artifact's bytes beside the cost model's, a rebuilt load and
    the zeroed-SSD control, then once at capacity factor 1.25 (see the
    module docstring, phase 15).  Returns the recorded kernel inputs of the
    dropless reuse-on serve and the launches of every serve."""
    cfg, params = family_params("jamba-1.5-large-398b", **HYBRID_CUT)
    # the dropless capacity factor n_experts / top_k: C >= T, no pair drops
    dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    reqs = traffic(cfg.vocab)
    runs = {}
    runs["dense"], inputs, eng = hybrid_serve(dropless, params, "dense")
    actions = runs["dense"]["actions"]
    assert [a for a, _ in actions.values()] == SSM_ACTIONS, actions
    assert set(inputs["flash"]) == {"wave 0", "suffix"}, inputs["flash"].keys()
    assert set(inputs["ssd"]) == {"long", "short"} and inputs["decode"] is not None
    # the stored artifact of A: the attention layer's K/V rows and each Mamba
    # layer's (f32 SSD state, bf16 conv tail), against the cost model's
    # bytes, which price the state at 2 bytes an element
    tokens_a = reqs[0]["context_tokens"]
    artifact = stored_artifact(eng, tokens_a)
    entry = eng.store.lookup(tokens_a)[1]
    kv = sum(int(c.attn.k.nbytes + c.attn.v.nbytes) for c in artifact.caches
             if c.attn is not None)
    states = [int(c.mamba.conv.nbytes + c.mamba.ssd.nbytes) for c in artifact.caches
              if c.mamba is not None]
    s = cfg.ssm
    ssd_b = s.n_ssm_heads(cfg.d_model) * s.head_dim * s.d_state * 4
    conv_b = (s.d_conv - 1) * (s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state) * 2
    kv_want = CTX_LEN * cfg.kv_bytes_per_token()
    log(f"jamba stored artifact of A ({CTX_LEN} tokens): K/V {kv} bytes (want {kv_want}: "
        f"{cfg.kv_bytes_per_token()} B a token), Mamba states {states} (want {ssd_b + conv_b} "
        f"each: SSD f32 {ssd_b} + conv bf16 {conv_b}); the entry's nbytes {entry.nbytes}; the "
        f"cost model's s_storage_bytes {s_storage_bytes(cfg, CTX_LEN):.0f} (K/V {kv_want} + "
        f"fixed state {cfg.fixed_state_bytes()}, at 2 bytes an element)")
    assert kv == kv_want and states == [ssd_b + conv_b] * cfg.n_ssm_layers, (kv, states)
    del eng
    release()

    runs["reuse off"], _, eng = hybrid_serve(dropless, params, "reuse off", reuse=False)
    del eng
    release()
    assert gate_reuse("jamba", runs, "dense") == SSM_ACTIONS.count("load")
    # a load rebuilt from the store repeats the engine's (the same launches on
    # the same bits); the control, the same load with every Mamba layer's SSD
    # state zeroed (conv tails and K/V kept), must leave the reuse gate
    load = next(i for i, (a, _) in actions.items() if a == "load")
    assert reqs[load]["context_tokens"] == tokens_a
    rebuilt = prompt_after(dropless, params, artifact, reqs[load]["prompt_tokens"])
    control = prompt_after(dropless, params, zeroed_ssd(artifact), reqs[load]["prompt_tokens"])
    same = (rebuilt - runs["dense"]["first"][load]).abs().max().item()
    ctrl = (control - runs["reuse off"]["first"][load]).abs().max().item()
    log(f"jamba request {load}'s load rebuilt from the store: max|rebuilt - served| = "
        f"{same:.3e} (gate {SSM_REBUILD_ATOL}); control with the stored SSD states zeroed: "
        f"max|control - recompute| = {ctrl:.4f} (must exceed {LOGIT_ATOL})")
    assert same <= SSM_REBUILD_ATOL, same
    assert ctrl > LOGIT_ATOL, ctrl
    del artifact
    release()
    # once at the capacity factor 1.25, the drops logged and not gated (C10)
    c125 = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
    runs["dense cf 1.25"], _, eng = hybrid_serve(c125, params, "dense cf 1.25")
    assert runs["dense cf 1.25"]["actions"] == actions, runs["dense cf 1.25"]["actions"]
    del eng, params
    release()
    return inputs, {mode: runs[mode]["counts"] for mode in runs}


# --------------------------------------------------------------------------- #
# Granite phase (granite-34b: MQA, the GELU MLP)
# --------------------------------------------------------------------------- #
SERVE_MODES = (("dense", {}), ("paged", dict(paged_decode=True, kv_block=128)),
               ("unified", dict(paged_decode=True, unified_step=True, kv_block=128)),
               ("reuse off", dict(reuse=False)))


def other_context_control(label, cfg, params, reqs, runs, req, artifact, base="reuse off",
                          atol=LOGIT_ATOL):
    """The control of a reuse gate: request ``req``'s prompt prefilled after
    another context's stored ``artifact`` (the load path's shape), whose
    first-token logits must fall outside ``atol`` of ``req`` served with
    reuse off."""
    control = prompt_after(cfg, params, artifact, reqs[req]["prompt_tokens"])
    diff = (control - runs[base]["first"][req]).abs().max().item()
    log(f"{label} control: request {req}'s prompt after another context's stored state: "
        f"first-token logits max|control - recompute| = {diff:.4f} (must exceed {atol}; "
        f"{LOGIT_ATOL} {'exceeded' if diff > LOGIT_ATOL else 'not exceeded'})")
    assert diff > atol, (label, diff)


def granite_phase():
    """Full-width, full-depth granite-34b (bf16, random weights; 48 query
    heads on one kv head, the GELU MLP) serves the prefix mix dense, paged,
    unified and with reuse off, then ``ModelApi.prefill`` per request and
    the RAG mix fused (see the module docstring, phase 16).  Returns the
    recorded kernel inputs and the launches of every serve."""
    torch.cuda.reset_peak_memory_stats()
    cfg, params = family_params("granite-34b")
    reqs = traffic(cfg.vocab)
    a_ctx, b_ctx = reqs[0]["context_tokens"], reqs[1]["context_tokens"]
    runs, inputs = {}, {}
    for mode, kw in SERVE_MODES:
        keep = (a_ctx, b_ctx) if mode == "dense" else ()
        runs[mode], inputs[mode] = family_serve("granite", cfg, params, mode, keep_stored=keep,
                                                **kw)
    dense = runs["dense"]
    for mode in ("paged", "unified"):
        assert runs[mode]["actions"] == dense["actions"], (mode, runs[mode]["actions"])
    for mode in ("dense", "paged", "unified"):
        assert gate_reuse("granite", runs, mode) > 0, mode
    art = dense["stored"][tuple(a_ctx)].caches[0].attn
    want = CTX_LEN * cfg.kv_bytes_per_token()
    log(f"granite stored K/V of A: {int(art.k.nbytes + art.v.nbytes)} bytes ({CTX_LEN} tokens x "
        f"{cfg.kv_bytes_per_token()} B: 88 layers x K, V x 1 kv head x 128 x 2 B)")
    assert int(art.k.nbytes + art.v.nbytes) == want
    load = next(i for i, (a, m) in dense["actions"].items()
                if a == "load" and m == len(reqs[i]["context_tokens"]))
    own = tuple(reqs[load]["context_tokens"])
    other = tuple(b_ctx) if own == tuple(a_ctx) else tuple(a_ctx)
    other_context_control("granite", cfg, params, reqs, runs, load, dense["stored"][other])
    release()

    zero_counts()
    flash_full, flash_suffix = per_request_prefill(
        cfg, params, reqs, runs["reuse off"]["first"], reqs[load], dense["stored"][own],
        dense["first"])
    runs["prefill"] = dict(counts=counts())
    assert runs["prefill"]["counts"]["flash_attention"] == cfg.n_layers * (len(reqs) + 2)
    del dense["stored"]
    release()

    # the RAG mix once, fused over the dense decode, beside its recompute
    zero_counts()
    eng, recs, rec, steps, _ = serve(
        cfg, params, planner=BlendPlanner(recompute_frac=RECOMPUTE_FRAC, always=True),
        make_traffic=fused_traffic, fusion_enabled=True, kv_block=128)
    runs["fused"] = dict(counts=counts())
    c = runs["fused"]["counts"]
    log(f"granite fused serve launches: {c}; fused_stats {json.dumps(eng.fused_stats())}")
    log_steps("granite fused", steps)
    actions = [r.action for _, r in sorted(recs.items())]
    assert actions == ["recompute", "fused", "fused"], actions
    assert c["fused_flash_attention"] == 2 * cfg.n_layers and c["packed_flash_attention"] > 0
    assert all(n and eq for n, eq in rec.reused_rows_equal), rec.reused_rows_equal
    fused_inputs, fused_first = rec.fused_inputs, rec.first_logits
    del eng, rec
    release()
    _, base_recs, base_rec, _, _ = serve(cfg, params, reuse=False, make_traffic=fused_traffic)
    for i in (1, 2):
        diff = (fused_first[i] - base_rec.first_logits[i]).abs().max().item()
        same = sum(x == y for x, y in zip(recs[i].tokens, base_recs[i].tokens))
        log(f"granite fused (r={RECOMPUTE_FRAC}) vs recompute, request {i}: first-token logits "
            f"max diff {diff:.4f}, tokens agreeing {same}/{NEW_TOKENS} (r < 1 approximates: "
            f"reported, not gated)")
    del base_rec, params
    release()
    log(f"granite phase: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated "
        f"of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} GiB")
    inputs.update(flash_full=flash_full, flash_suffix=flash_suffix, fused=fused_inputs)
    return inputs, {mode: run["counts"] for mode, run in runs.items()}


# --------------------------------------------------------------------------- #
# VLM phase (internvl2-1b: image embeddings before the prompt)
# --------------------------------------------------------------------------- #
VLM_TEXT_CTX = 512  # the text-only requests' context
# (image, arrival): three images, the first request of each recomputes and
# stores, a later one loads; two text-only requests over one context
VLM_PLAN = [(0, 0.0), (1, 0.0), (None, 0.0), (0, 1.0), (2, 1.0), (None, 1.0), (1, 2.0),
            (2, 2.0)]
VLM_ACTIONS = ["recompute", "recompute", "recompute", "load", "recompute", "load", "load",
               "load"]


def vlm_traffic(cfg):
    """Eight requests with their own 32-token prompts: three images (seeded
    ``[1, 256, 896]`` embeddings x 0.02 drawn on the card, each named by a
    256-token identity proxy as its context), two requests each, and two
    text-only requests over one 512-token context (the packed path)."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 2)
    images = [torch.randn(1, cfg.frontend_tokens, cfg.d_model, generator=g, device=DEVICE) * 0.02
              for _ in range(3)]
    rng = np.random.default_rng(SEED + 2)
    proxies = [rng.integers(0, cfg.vocab, cfg.frontend_tokens).tolist() for _ in images]
    text = rng.integers(0, cfg.vocab, VLM_TEXT_CTX).tolist()
    reqs = []
    for i, (img, t) in enumerate(VLM_PLAN):
        r = dict(req_id=i, context_tokens=text if img is None else proxies[img],
                 prompt_tokens=rng.integers(0, cfg.vocab, PROMPT_LEN).tolist(),
                 max_new_tokens=NEW_TOKENS, arrival_s=t, expected_reuses=3)
        if img is not None:
            r["embeds"] = images[img]
        reqs.append(r)
    return reqs


def vlm_phase():
    """Full-width, full-depth internvl2-1b (bf16, random weights): the image
    and text mix dense, paged, unified and with reuse off, its gates and
    the other-image control (see the module docstring, phase 17).  Returns
    the recorded kernel inputs and the launches of every serve."""
    cfg, params = family_params("internvl2-1b")
    reqs = vlm_traffic(cfg)
    image_ctx = [tuple(reqs[i]["context_tokens"]) for i in (0, 1)]
    runs, inputs = {}, {}
    for mode, kw in SERVE_MODES:
        # the image requests through ModelApi.prefill (the flash kernel),
        # the text-only ones packed (or chunked under the unified step)
        runs[mode], inputs[mode] = family_serve(
            "internvl", cfg, params, mode, keep_stored=image_ctx if mode == "dense" else (),
            flash=True, planner=AlwaysReusePlanner(), make_traffic=lambda v: vlm_traffic(cfg),
            **kw)
    for mode in ("dense", "paged", "unified"):
        assert [a for a, _ in runs[mode]["actions"].values()] == VLM_ACTIONS, (
            mode, runs[mode]["actions"])
        assert gate_reuse("internvl", runs, mode) == VLM_ACTIONS.count("load"), mode
    # the control: request 3 (image 0) loads image 1's stored rows instead
    other_context_control("internvl", cfg, params, reqs, runs, 3,
                          runs["dense"]["stored"][image_ctx[1]])
    del runs["dense"]["stored"], params
    release()
    return inputs, {mode: run["counts"] for mode, run in runs.items()}


# --------------------------------------------------------------------------- #
# Encoder-decoder phase (whisper-tiny: cross-attention K/V as the context)
# --------------------------------------------------------------------------- #
WHISPER_CTX_LEN, WHISPER_MAX_LEN = 32, 448  # an audio's identity proxy; decoder rows


def audio_traffic(cfg):
    """Six requests over two audios (seeded ``[1, 1500, 384]`` frames drawn
    on the card, each named by a 32-token identity proxy as its context),
    three each, one wave a modelled second: wave 0 recomputes both, waves 1
    and 2 load them; prompts of 8-32 tokens, 16 new tokens."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 3)
    audios = [torch.randn(1, cfg.encoder_seq_len, cfg.d_model, generator=g, device=DEVICE)
              for _ in range(2)]
    rng = np.random.default_rng(SEED + 3)
    proxies = [rng.integers(0, cfg.vocab, WHISPER_CTX_LEN).tolist() for _ in audios]
    return [dict(req_id=i, context_tokens=proxies[i % 2], embeds=audios[i % 2],
                 prompt_tokens=rng.integers(0, cfg.vocab, int(rng.integers(8, 33))).tolist(),
                 max_new_tokens=NEW_TOKENS, arrival_s=float(i // 2), expected_reuses=3)
            for i in range(6)]


class CrossRecorder:
    """The first decoder (or encoder) layer's ``flash_attention`` inputs of
    the first launch of each non-causal kind of a whisper serve: the
    encoder's self-attention (frames over frames), a prompt's
    cross-attention and a decode step's (one query row)."""

    def __init__(self):
        self.inputs = {}
        self._flash = ops.flash_attention
        ops.flash_attention = self._record

    def close(self):
        ops.flash_attention = self._flash

    def _record(self, q, k, v, **kw):
        if not kw.get("causal", True):
            Sq, Skv = q.shape[1], k.shape[1]
            kind = "encoder" if Sq == Skv else "cross step" if Sq == 1 else "cross prompt"
            if kind not in self.inputs:
                self.inputs[kind] = keep((q, k, v), kw)
        return self._flash(q, k, v, **kw)


def whisper_serve(cfg, params, mode, **kw):
    """One serve of ``audio_traffic`` with ``AlwaysReusePlanner`` at
    ``max_len`` 448: every admission through ``ModelApi.prefill`` (the
    encoder on the recomputes), dense decode.  Returns its run and the
    recorded kernel inputs."""
    cross = CrossRecorder()
    zero_counts()
    try:
        eng, recs, rec, steps, writebacks = serve(
            cfg, params, planner=AlwaysReusePlanner(), make_traffic=lambda v: audio_traffic(cfg),
            max_len=WHISPER_MAX_LEN, **kw)
    finally:
        cross.close()
    c = counts()
    n_decode = eng.decode_stats()["decode_steps"]
    actions = {i: (r.action, r.matched_tokens) for i, r in sorted(recs.items())}
    n_enc = sum(a == "recompute" for a, _ in actions.values())
    log(f"whisper {mode} serve launches: {c} (ModelApi.prefill calls {rec.prefill_calls}, "
        f"encoder runs {n_enc}, decode steps {n_decode}); actions {actions}; write-backs "
        f"{writebacks}")
    log_steps(f"whisper {mode}", steps)
    L = cfg.n_layers
    assert len(recs) == 6 and all(len(r.tokens) == NEW_TOKENS for r in recs.values())
    # the flash launches by kind: the encoder's layers on a recompute, per
    # prefill call a decoder layer's causal self- and its cross-attention,
    # a cross-attention a layer a decode step
    kinds = {"encoder": cfg.n_encoder_layers * n_enc, "self prompt": L * rec.prefill_calls,
             "cross prompt": L * rec.prefill_calls, "cross step": L * n_decode}
    assert c["flash_attention"] == sum(kinds.values()), (c, kinds)
    assert c["decode_attention"] == L * n_decode > 0, c
    assert sum(c.values()) == c["flash_attention"] + c["decode_attention"], c
    assert eng.batches == 0 and eng.decode_stats()["paged"] is False
    reqs = audio_traffic(cfg)
    stored = ({i: stored_artifact(eng, reqs[i]["context_tokens"]) for i in (0, 1)}
              if kw.get("reuse", True) else {})
    run = dict(recs=recs, actions=actions, first=rec.first_logits, counts=c, drops={},
               stored=stored, flash_kinds=kinds)
    inputs = dict(cross.inputs, decode=rec.decode_inputs)
    del eng, rec
    release()
    return run, inputs


def whisper_phase():
    """Full whisper-tiny (bf16, random weights; 4 encoder and 4 decoder
    layers, 1,500 frames): the audio mix with reuse on and off, the gate and
    the other-audio control (see the module docstring, phase 18).  Returns
    the recorded kernel inputs, the launches of both serves and the
    reuse-on serve's ``flash_attention`` launches by kind."""
    cfg, params = family_params("whisper-tiny")
    runs, inputs = {}, {}
    runs["dense"], inputs = whisper_serve(cfg, params, "dense")
    runs["reuse off"], _ = whisper_serve(cfg, params, "reuse off", reuse=False)
    actions = [a for a, _ in runs["dense"]["actions"].values()]
    assert actions == ["recompute", "recompute", "load", "load", "load", "load"], actions
    art = runs["dense"]["stored"][0]
    log(f"whisper stored artifact of audio 0: pos {paged.artifact_length(art)}, self K/V rows "
        f"{art.self_kv.k.shape[2]}, cross K/V {tuple(art.cross_kv.k.shape)}, "
        f"{compression.tree_nbytes(art)} bytes")
    assert paged.artifact_length(art) == 0 and art.cross_kv.k.shape[2] == cfg.encoder_seq_len
    assert gate_reuse("whisper", runs, "dense", atol=ENCDEC_LOAD_ATOL) == 4
    # the control: request 2 (audio 0) loads audio 1's stored cross K/V
    other_context_control("whisper", cfg, params, audio_traffic(cfg), runs, 2,
                          runs["dense"]["stored"][1], atol=ENCDEC_LOAD_ATOL)
    assert set(inputs) == {"encoder", "cross prompt", "cross step", "decode"}, inputs.keys()
    del runs["dense"]["stored"], params
    release()
    return (inputs, {mode: run["counts"] for mode, run in runs.items()},
            runs["dense"]["flash_kinds"])


# --------------------------------------------------------------------------- #
# Training (qwen2-0.5b through training.train_step)
# --------------------------------------------------------------------------- #
def train_cfg(**cut):
    return dataclasses.replace(get_config(TRAIN_ARCH), **cut)


def grad_errors(got, want):
    """Each leaf's largest |got - want| over its largest |want|."""
    return [((g.float().cpu() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30))
            .item() for g, w in zip(tree_leaves(got), tree_leaves(want))]


def train_card_vs_cpu(cfg, batch, expect):
    """One train step's two halves (``value_and_grad``, then
    ``AdamW.update``: ``make_train_step``) of ``cfg`` (f32), on the card and
    on the CPU from the same weights and batch: the loss and every gradient
    within ``TRAIN_GRAD_RTOL``, and the card's launches exactly ``expect``
    (the kernels that launched, by name).  The new parameters are logged,
    not gated: at step 1 the update is g / (|g| + eps), so a near-zero
    gradient of either sign moves a weight by +-lr."""
    cpu_params = get_model(cfg).init(cfg, seed=SEED, device="cpu")
    card_params = tree_map(lambda t: t.to(DEVICE), cpu_params)
    opt = AdamW(lr=TRAIN_LR, weight_decay=0.01)
    zero_counts()
    t0 = time.perf_counter()
    (loss, _), grads = value_and_grad(card_params, cfg, batch)
    new_card, state = opt.update(grads, opt.init(card_params), card_params)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    c = counts()
    shape = " x ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items() if k != "mask")
    log(f"train step card vs cpu ({cfg.name}, {cfg.n_layers} layers at full width, f32, "
        f"{shape}): card launches {c}, card wall {card_s:.2f} s")
    assert {k: v for k, v in c.items() if v} == expect, (c, expect)
    t0 = time.perf_counter()
    (cpu_loss, _), cpu_grads = value_and_grad(cpu_params, cfg, batch)
    new_cpu, _ = opt.update(cpu_grads, opt.init(cpu_params), cpu_params)
    cpu_s = time.perf_counter() - t0
    loss_err = abs(loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    errs = grad_errors(grads, cpu_grads)
    moved = [(a.cpu() - b).abs().max().item() for a, b in zip(tree_leaves(new_card),
                                                                tree_leaves(new_cpu))]
    log(f"train step card vs cpu ({cfg.name}): loss {loss.item():.6f} / {cpu_loss.item():.6f} "
        f"(rel {loss_err:.3e}); gradients: max rel err {max(errs):.3e}, median "
        f"{sorted(errs)[len(errs) // 2]:.3e} over {len(errs)} leaves; new parameters: max "
        f"|card - cpu| {max(moved):.3e} (lr {TRAIN_LR}; not gated); cpu wall {cpu_s:.2f} s; "
        f"step {int(state.step)}")
    assert loss_err <= TRAIN_GRAD_RTOL and max(errs) <= TRAIN_GRAD_RTOL, (loss_err, max(errs))


class TrainRecorder:
    """Keeps copies of the inputs of the training forward's first
    ``flash_attention`` call (the first layer's) and of the first backward
    (the last layer's: ``FlashAttentionFn``'s saved tensors and dO) while
    installed.  It wraps ``ops.flash_attention`` and the backward of
    ``ops.FlashAttentionFn``; the kernels' wrappers and counters are left as
    they are."""

    def __init__(self):
        self.fwd = self.bwd = None
        self._orig = (ops.flash_attention, ops.FlashAttentionFn.backward)

    def __enter__(self):
        flash, backward = self._orig

        def record_fwd(*args, **kw):
            if self.fwd is None:
                self.fwd = keep([a.detach() for a in args], kw)
            return flash(*args, **kw)

        def record_bwd(ctx, dout):
            if self.bwd is None:
                q, k, v, out, lse, q_pos, kv_pos, kv_valid = ctx.saved_tensors
                self.bwd = keep([t.detach() for t in (q, k, v, out, dout, lse)], dict(
                    q_pos=q_pos, kv_pos=kv_pos, causal=ctx.causal, window=ctx.window,
                    kv_valid=kv_valid))
            return backward(ctx, dout)

        ops.flash_attention = record_fwd
        ops.FlashAttentionFn.backward = staticmethod(record_bwd)
        return self

    def __exit__(self, *exc):
        ops.flash_attention = self._orig[0]
        ops.FlashAttentionFn.backward = staticmethod(self._orig[1])


def train_full():
    """qwen2-0.5b at full width and depth in bf16: ``TRAIN_STEPS`` steps of
    ``make_train_step``.  Returns the recorded forward and backward inputs
    and the run's launches."""
    cfg = get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=SEED, device=DEVICE)
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt = AdamW(lr=TRAIN_LR, weight_decay=0.01,
                schedule=cosine_schedule(warmup=TRAIN_WARMUP, total=TRAIN_STEPS))
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    it = token_batches(dataclasses.replace(cfg, vocab=TRAIN_DATA_VOCAB), batch=TRAIN_BATCH,
                       seq_len=TRAIN_SEQ, seed=SEED)
    batches = [{k: torch.as_tensor(v, device=DEVICE) for k, v in next(it).items()}
               for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    log(f"{TRAIN_ARCH} {cfg.param_dtype}: {n_params} params ({n_params / 1e9:.3f} B), AdamW state and "
        f"{TRAIN_STEPS} batches set up in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    zero_counts()
    with TrainRecorder() as rec:
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batches[i])
            losses.append(metrics["loss"].item())
            walls.append(time.perf_counter() - t0)
    c = counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = sorted(walls[1:])
    median = steady[len(steady) // 2]
    log(f"train {TRAIN_ARCH} full width and depth, bf16, B {TRAIN_BATCH} x S {TRAIN_SEQ}, "
        f"{TRAIN_STEPS} steps: launches {c}")
    log(f"train losses: {[round(x, 4) for x in losses]}")
    drop = sum(losses[:3]) / 3 - sum(losses[-3:]) / 3
    log(f"train step wall: first {walls[0] * 1e3:.1f} ms, median of the rest "
        f"{median * 1e3:.1f} ms (min {steady[0] * 1e3:.1f}, max {steady[-1] * 1e3:.1f}); "
        f"{tokens / median:.0f} tokens/s; peak memory {peak / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}; {n_params} params; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, drop of the 3-step means {drop:.4f} "
        f"(predicted >= {TRAIN_LOSS_DROP})")
    assert all(math.isfinite(x) for x in losses), losses
    assert c["flash_attention"] == c["flash_attention_bwd"] == cfg.n_layers * TRAIN_STEPS, c
    assert sum(c.values()) == 2 * cfg.n_layers * TRAIN_STEPS, c
    assert int(state.step) == TRAIN_STEPS
    assert drop >= TRAIN_LOSS_DROP, (drop, losses)
    assert rec.fwd is not None and rec.bwd is not None
    del params, state, batches
    release()
    return rec.fwd, rec.bwd, c


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block (the
    cross-entropy's ``gather`` backward is a ``scatter_add_`` on CUDA, which
    PyTorch counts as nondeterministic), with the cuBLAS workspace setting
    it needs; both restored after."""
    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas


def train_resume(tmp: pathlib.Path, cfg):
    """A ``ResilientLoop`` of ``cfg`` (bf16, checkpoints in the reference's
    layout): preempted at step 6, after the step-4 checkpoint, and
    re-invoked, it ends as an uninterrupted run does, bit for bit."""
    params0 = lm.init(cfg, seed=SEED, device=DEVICE)
    opt = AdamW(lr=TRAIN_LR, weight_decay=0.01, schedule=cosine_schedule(warmup=2, total=8))
    step = make_train_step(cfg, opt)
    it = token_batches(dataclasses.replace(cfg, vocab=TRAIN_DATA_VOCAB),
                       batch=TRAIN_CPU_BATCH, seq_len=TRAIN_CPU_SEQ, seed=SEED + 1)
    batches = [{k: torch.as_tensor(v, device=DEVICE) for k, v in next(it).items()}
               for _ in range(8)]

    def loop(path, **kw):
        return ResilientLoop(step, lambda i: batches[i],
                             LoopConfig(total_steps=8, ckpt_every=4, ckpt_dir=str(path)),
                             model_cfg=cfg, **kw)

    def bomb(i):
        if i == 6:
            raise Preempted("simulated preemption")

    with deterministic():
        t0 = time.perf_counter()
        whole = loop(tmp / "whole").run(params0, opt.init(params0))
        cut = loop(tmp / "preempted", failure_hook=bomb)
        try:
            cut.run(params0, opt.init(params0))
            raise AssertionError("the failure hook did not preempt the loop")
        except Preempted:
            cut.ckpt.wait()
        assert latest_step(tmp / "preempted") == 4
        resumed = loop(tmp / "preempted").run(params0, opt.init(params0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    same = [torch.equal(a, b) for a, b in zip(
        tree_leaves((whole["params"], whole["opt_state"])),
        tree_leaves((resumed["params"], resumed["opt_state"])))]
    log(f"train resume ({cfg.name}, {cfg.n_layers} layers at full width, bf16; preempted at step 6, "
        f"resumed from the step-4 checkpoint): {sum(same)}/{len(same)} leaves equal bit for "
        f"bit, final loss {float(whole['metrics']['loss']):.4f} / "
        f"{float(resumed['metrics']['loss']):.4f}, three runs {wall:.1f} s")
    assert all(same) and int(resumed["opt_state"].step) == 8


def training_phase():
    """Phase 19 (see the module docstring).  Returns the full run's recorded
    forward and backward inputs and its launches."""
    t0 = time.perf_counter()
    cfg = train_cfg(n_layers=TRAIN_CUT, param_dtype="float32", dtype="float32")
    batch = next(token_batches(dataclasses.replace(cfg, vocab=TRAIN_DATA_VOCAB),
                               batch=TRAIN_CPU_BATCH, seq_len=TRAIN_CPU_SEQ, seed=SEED))
    train_card_vs_cpu(cfg, batch, {"flash_attention": cfg.n_layers,
                                   "flash_attention_bwd": cfg.n_layers})
    release()
    fwd_inputs, bwd_inputs, c = train_full()
    with tempfile.TemporaryDirectory() as tmp:
        train_resume(pathlib.Path(tmp), train_cfg(n_layers=TRAIN_CUT))
    release()
    log(f"training phase wall: {time.perf_counter() - t0:.1f} s")
    return fwd_inputs, bwd_inputs, c


def check_flash_bwd(inputs, launches, label):
    """Hold ``flash_attention_bwd`` against its plain backward on
    ``inputs`` (``(q, k, v, out, dout, lse), kw``; see the module docstring
    for the tolerances), hold the forward kernel's ``lse`` in ``inputs``
    (at the training shape bf16 splits, so the combine wrote it) against
    the plain forward's within ``LSE_ATOL`` with the same -inf rows, check
    two launches' bits and the forward's bits with and without ``lse``,
    and time it beside its plain version and
    SDPA's forward and backward with an explicit boolean mask.  The bound
    counts q, k, v, out, dout, lse and the positions read once and dq, dk,
    dv written once, and the five products of 2·hd operations per kept
    (query, key) pair and head (dP, and S recomputed, dQ, dK, dV).  Returns
    the kernels line's entry."""
    (q, k, v, out, dout, lse), kw = inputs
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    got = fbk.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    again = fbk.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    want = fbk.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    fresh_lse = torch.empty_like(lse)
    with_lse = fk.flash_attention(q, k, v, lse=fresh_lse, **kw)
    without = fk.flash_attention(q, k, v, **kw)
    _, plain_lse = fbk.flash_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{label}: bits differ"
    assert torch.equal(with_lse, without) and torch.equal(fresh_lse, lse), label
    finite = torch.isfinite(plain_lse)
    assert torch.equal(finite, torch.isfinite(lse)), f"{label}: lse's -inf rows differ"
    lse_err = (lse[finite] - plain_lse[finite]).abs().max().item() if finite.any() else 0.0
    assert lse_err <= LSE_ATOL, f"flash_attention lse {label}: {lse_err} > {LSE_ATOL}"
    f32 = q.dtype == torch.float32
    abs_errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
    errs = [e / max(b.float().abs().max().item(), 1.0 if f32 else 1e-30)
            for e, b in zip(abs_errs, want)]
    tol = F32_ATOL if f32 else BF16_ATOL
    assert max(errs) <= tol, f"flash_attention_bwd {label}: rel errs {errs} > {tol}"
    ms = time_ms(lambda: fbk.flash_attention_bwd(q, k, v, out, dout, lse, **kw))
    plain_ms = time_ms(lambda: fbk.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw),
                       reps=3)
    mask = fbk._mask(kw["q_pos"], kw["kv_pos"], kw.get("causal", True), kw.get("window"),
                     kw.get("kv_valid"))
    pairs = int(mask.sum())  # kept (query, key) pairs per head, over the batch
    qt = q.transpose(1, 2).detach().requires_grad_(True)
    kt, vt = (t.repeat_interleave(H // KV, -2).transpose(1, 2).detach().requires_grad_(True)
              for t in (k, v))
    dt = dout.transpose(1, 2)

    def sdpa():
        o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None])
        torch.autograd.grad(o, (qt, kt, vt), dt)

    lib = time_ms(sdpa)
    b, by = bound_ms(nbytes(q, k, v, out, dout, lse, kw["q_pos"], kw["kv_pos"], *got),
                     10.0 * hd * H * pairs, q.dtype)
    log(f"kernel flash_attention_bwd {label} {str(q.dtype)[6:]} q{tuple(q.shape)} "
        f"kv{tuple(k.shape)} window {kw.get('window')} kept_pairs/head={pairs}: rel errs "
        f"(dq, dk, dv) {', '.join(f'{e:.3e}' for e in errs)} (abs "
        f"{', '.join(f'{e:.3e}' for e in abs_errs)}; max|plain| "
        f"{', '.join(f'{b.float().abs().max().item():.3e}' for b in want)}); the forward's lse "
        f"max|kernel - plain| {lse_err:.3e} over {int(finite.sum())} finite rows "
        f"({int((~finite).sum())} -inf rows in both); two launches and the forward "
        f"with and without lse give the same bits; ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"sdpa_fwd_bwd_ms={lib:.4f} bound_ms={b:.4f} ({by})")
    # bf16 runs the tensor-core kernels (and the reduce of the per-head
    # partials when G > 1), f32 the CUDA-core ones
    device_ms_later(f"flash_attention_bwd {label}",
                    lambda: fbk.flash_attention_bwd(q, k, v, out, dout, lse, **kw),
                    {"rowsum": "dot_kernel", "dK dV": "dkdv_kernel", "dQ": "dq_kernel"} if f32
                    else {"rowsum": "dot_kernel", "dK dV": "dkdv_mma_kernel",
                          "reduce": "dkdv_reduce_kernel", "dQ": "dq_mma_kernel"})
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_backward.cu",
                replaces="src/repro/kernels/flash_prefill.py:91 (its gradient: no Pallas "
                         "backward exists; JAX differentiates through the call)",
                launches=launches, max_abs_err=max(abs_errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=lib)


def bwd_inputs(B, S, H, KV, hd, dtype, window=None, seed=0):
    """Seeded training-shaped backward inputs on the card (queries and keys
    at the same positions, causal), the forward run for ``out`` and ``lse``."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    q, dout = (torch.randn(B, S, H, hd, generator=g, device=DEVICE).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, S, KV, hd, generator=g, device=DEVICE).to(dtype) for _ in range(2))
    pos = torch.arange(S, device=DEVICE, dtype=torch.int32)[None].expand(B, S).contiguous()
    kw = dict(q_pos=pos, kv_pos=pos, causal=True, window=window)
    lse = torch.empty(B, S, H, dtype=torch.float32, device=DEVICE)
    out = fk.flash_attention(q, k, v, lse=lse, **kw)
    return (q, k, v, out, dout, lse), kw


def check_flash_fn_f32(inputs):
    """``FlashAttentionFn`` on the card (the forward and backward kernels)
    against autograd of the plain forward, f32, within ``F32_ATOL`` of
    max(1, max|·|)."""
    (q, k, v, _, dout, _), kw = inputs
    grads = []
    for fn in (ops.flash_attention, fk.flash_attention_plain):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*qkv, **kw)
        grads.append(torch.autograd.grad(o, qkv, dout))
    torch.cuda.synchronize()
    errs = [((a - b).abs().max() / b.abs().max().clamp_min(1.0)).item()
            for a, b in zip(*grads)]
    log(f"FlashAttentionFn (kernels) vs autograd of the plain forward, f32 "
        f"q{tuple(q.shape)}: rel errs (dq, dk, dv) {', '.join(f'{e:.3e}' for e in errs)}")
    assert max(errs) <= F32_ATOL, errs


# --------------------------------------------------------------------------- #
# Training the SSM, hybrid and encoder-decoder families (phase 20)
# --------------------------------------------------------------------------- #
class SSDRecorder:
    """Keeps copies of the inputs of the first ``ops.SSDChunkedFn`` backward
    (the last Mamba layer's: its saved tensors and dy) while installed; the
    kernels' wrappers and counters are left as they are.  The saved tensors
    are unpacked once and handed on, since under remat they unpack once."""

    def __init__(self):
        self.bwd = None
        self._orig = ops.SSDChunkedFn.backward

    def __enter__(self):
        backward = self._orig

        def record(ctx, dy, dhT):
            saved = ctx.saved_tensors
            if self.bwd is None:
                dy_ = torch.zeros_like(saved[0]) if dy is None else dy
                self.bwd = tuple(t.detach().clone() for t in (*saved[:5], dy_))
            return backward(types.SimpleNamespace(saved_tensors=saved, chunk=ctx.chunk),
                            dy, dhT)

        ops.SSDChunkedFn.backward = staticmethod(record)
        return self

    def __exit__(self, *exc):
        ops.SSDChunkedFn.backward = staticmethod(self._orig)


def run_steps(cfg, batches, steps, warmup):
    """``steps`` steps of ``make_train_step`` (AdamW at ``TRAIN_LR``, cosine
    schedule) over ``batches`` from the arch's seeded weights on the card
    (drawn here, so that only the stepped weights stay alive); returns the
    losses, the walls (s), the launches, the final AdamW step and the
    parameter count."""
    params = get_model(cfg).init(cfg, seed=SEED, device=DEVICE)
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt = AdamW(lr=TRAIN_LR, weight_decay=0.01,
                schedule=cosine_schedule(warmup=warmup, total=steps))
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    walls, losses = [], []
    zero_counts()
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batches[i])
        losses.append(metrics["loss"].item())
        walls.append(time.perf_counter() - t0)
    return losses, walls, counts(), int(state.step), n_params


def log_run(label, losses, walls, tokens, peak, n_params, predicted):
    steady = sorted(walls[1:])
    median = steady[len(steady) // 2]
    drop = sum(losses[:3]) / 3 - sum(losses[-3:]) / 3
    log(f"{label} losses: {[round(x, 4) for x in losses]}")
    log(f"{label} step wall: first {walls[0] * 1e3:.1f} ms, median of the rest "
        f"{median * 1e3:.1f} ms (min {steady[0] * 1e3:.1f}, max {steady[-1] * 1e3:.1f}); "
        f"{tokens / median:.0f} tokens/s; peak memory {peak / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}; {n_params} params; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, drop of the 3-step means {drop:.4f} "
        f"(predicted {predicted})")
    assert all(math.isfinite(x) for x in losses), losses
    return drop


def train_ssm_full():
    """mamba2-1.3b at full width and depth in bf16: ``SSM_TRAIN_STEPS``
    steps.  Returns the first recorded SSD backward's inputs and the run's
    launches."""
    cfg = get_config(SSM_TRAIN_ARCH)
    it = token_batches(dataclasses.replace(cfg, vocab=TRAIN_DATA_VOCAB), batch=SSM_TRAIN_BATCH,
                       seq_len=SSM_TRAIN_SEQ, seed=SEED)
    batches = [{k: torch.as_tensor(v, device=DEVICE) for k, v in next(it).items()}
               for _ in range(SSM_TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    with SSDRecorder() as rec:
        losses, walls, c, n_steps, n_params = run_steps(cfg, batches, SSM_TRAIN_STEPS,
                                                        TRAIN_WARMUP)
    peak = torch.cuda.max_memory_allocated()
    log(f"train {SSM_TRAIN_ARCH} full width and depth, bf16, B {SSM_TRAIN_BATCH} x S "
        f"{SSM_TRAIN_SEQ}, {SSM_TRAIN_STEPS} steps: launches {c}")
    drop = log_run(f"train {SSM_TRAIN_ARCH}", losses, walls, SSM_TRAIN_BATCH * SSM_TRAIN_SEQ,
                   peak, n_params, f">= {SSM_TRAIN_LOSS_DROP}")
    n = cfg.n_layers * SSM_TRAIN_STEPS
    assert {k: v for k, v in c.items() if v} == {"ssd_chunked": n, "ssd_chunked_bwd": n}, c
    assert n_steps == SSM_TRAIN_STEPS
    assert drop >= SSM_TRAIN_LOSS_DROP, (drop, losses)
    assert rec.bwd is not None
    x, B_ = rec.bwd[0], rec.bwd[3]
    log(f"train {SSM_TRAIN_ARCH}: the SSD backward's scratch "
        f"{4 * sbk.scratch_floats(*x.shape, *B_.shape[2:], x.dtype) / 2**30:.3f} GiB a launch "
        f"({str(x.dtype)[6:]}, x{tuple(x.shape)}, G {B_.shape[2]}, S {B_.shape[3]})")
    del batches
    release()
    return rec.bwd, c


def train_jamba_step():
    """One train step of jamba-1.5-large-398b at full width cut to
    ``JAMBA_TRAIN_CUT``, its bytes reckoned first: the loss finite; one SSD
    backward launch and one forward launch, two under the config's remat
    ("dots": the period's forward runs again in the backward); every leaf's
    first moment nonzero (its gradient arrived) and every leaf moved but a
    bf16 leaf that an update of ``TRAIN_LR`` cannot move (below half a bf16
    step at its smallest magnitude: the norm scales at 1.0).  Returns the
    recorded SSD backward's inputs and the launches."""
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b"), **JAMBA_TRAIN_CUT)
    n = count_params(cfg)
    d_in = cfg.ssm.d_inner(cfg.d_model)
    tokens = JAMBA_TRAIN_BATCH * JAMBA_TRAIN_SEQ
    log(f"train jamba-1.5-large-398b cut to {cfg.n_layers} layer ({cfg.hybrid_period}), bf16, "
        f"B {JAMBA_TRAIN_BATCH} x S {JAMBA_TRAIN_SEQ}: {n} params; reckoned bf16 weights "
        f"{2 * n / 2**30:.2f} GiB + bf16 gradients {2 * n / 2**30:.2f} + f32 moments "
        f"{8 * n / 2**30:.2f} = {12 * n / 2**30:.2f} GiB, plus the step's weights before it "
        f"{2 * n / 2**30:.2f} GiB and ~{tokens * (cfg.vocab * 12 + d_in * 64) / 2**30:.2f} GiB "
        f"of activations (f32 logits and their gradient, the Mamba layer's f32 conv terms)")
    params = lm.init(cfg, seed=SEED, device=DEVICE)
    before = [t.clone() for t in tree_leaves(params)]
    batch = next(token_batches(dataclasses.replace(cfg, vocab=TRAIN_DATA_VOCAB),
                               batch=JAMBA_TRAIN_BATCH, seq_len=JAMBA_TRAIN_SEQ, seed=SEED))
    opt = AdamW(lr=TRAIN_LR, weight_decay=0.01)
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with SSDRecorder() as rec:
        params, state, metrics = make_train_step(cfg, opt)(params, state, batch)
        loss = metrics["loss"].item()
    wall = time.perf_counter() - t0
    c = counts()
    leaves = tree_leaves(params)
    moved = [not torch.equal(a, b) for a, b in zip(before, leaves)]
    stuck = [t.dtype == torch.bfloat16 and TRAIN_LR < 2.0**-9 * t.float().abs().min().item()
             for t in leaves]
    fed = [bool(m.any()) for m in tree_leaves(state.m)]
    log(f"train jamba step: loss {loss:.4f}, wall {wall * 1e3:.1f} ms, launches {c}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {sum(moved)}/{len(moved)} "
        f"parameter leaves moved, {sum(stuck)} bf16 leaves an update of {TRAIN_LR} cannot move; "
        f"{sum(fed)}/{len(fed)} leaves with a nonzero first moment")
    assert math.isfinite(loss) and all(fed), (loss, fed)
    assert all(m or s for m, s in zip(moved, stuck)), (moved, stuck)
    fwd = 1 if cfg.remat == "none" else 2
    assert {k: v for k, v in c.items() if v} == {"ssd_chunked": fwd, "ssd_chunked_bwd": 1}, c
    assert rec.bwd is not None
    del params, state, before
    release()
    return rec.bwd, c


def train_whisper():
    """whisper-tiny at full width and depth in bf16: ``WHISPER_TRAIN_STEPS``
    steps over ``frame_batches``, the loss falling (the mean of the last
    three below the mean of the first three)."""
    cfg = get_config("whisper-tiny")
    it = frame_batches(dataclasses.replace(cfg, vocab=TRAIN_DATA_VOCAB),
                       batch=WHISPER_TRAIN_BATCH, seq_len=WHISPER_TRAIN_SEQ, seed=SEED)
    batches = [{k: torch.as_tensor(v, device=DEVICE) for k, v in next(it).items()}
               for _ in range(WHISPER_TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    losses, walls, c, n_steps, n_params = run_steps(cfg, batches, WHISPER_TRAIN_STEPS, 2)
    log(f"train whisper-tiny full width and depth, bf16, B {WHISPER_TRAIN_BATCH} x "
        f"{cfg.encoder_seq_len} frames x {WHISPER_TRAIN_SEQ} decoder tokens, "
        f"{WHISPER_TRAIN_STEPS} steps: launches {c}")
    drop = log_run("train whisper-tiny", losses, walls, WHISPER_TRAIN_BATCH * WHISPER_TRAIN_SEQ,
                   torch.cuda.max_memory_allocated(), n_params, "> 0")
    n = (cfg.n_encoder_layers + 2 * cfg.n_layers) * WHISPER_TRAIN_STEPS
    assert {k: v for k, v in c.items() if v} == {"flash_attention": n,
                                                  "flash_attention_bwd": n}, c
    assert n_steps == WHISPER_TRAIN_STEPS and drop > 0, (drop, losses)
    del batches
    release()


def ssm_training_phase():
    """Phase 20 (see the module docstring).  Returns the full mamba2 run's
    first recorded SSD backward inputs and launches, and the jamba step's
    recorded SSD backward inputs and launches."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(SSM_TRAIN_ARCH), n_layers=TRAIN_CUT,
                              param_dtype="float32", dtype="float32")
    batch = next(token_batches(dataclasses.replace(cfg, vocab=TRAIN_DATA_VOCAB),
                               batch=TRAIN_CPU_BATCH, seq_len=TRAIN_CPU_SEQ, seed=SEED))
    train_card_vs_cpu(cfg, batch, {"ssd_chunked": cfg.n_layers,
                                   "ssd_chunked_bwd": cfg.n_layers})
    release()
    cfg = dataclasses.replace(get_config("whisper-tiny"), param_dtype="float32",
                              dtype="float32")
    batch = next(frame_batches(dataclasses.replace(cfg, vocab=TRAIN_DATA_VOCAB),
                               batch=TRAIN_CPU_BATCH, seq_len=WHISPER_TRAIN_SEQ, seed=SEED))
    n = cfg.n_encoder_layers + 2 * cfg.n_layers
    train_card_vs_cpu(cfg, batch, {"flash_attention": n, "flash_attention_bwd": n})
    release()
    bwd_inputs, c = train_ssm_full()
    with tempfile.TemporaryDirectory() as tmp:
        train_resume(pathlib.Path(tmp), dataclasses.replace(get_config(SSM_TRAIN_ARCH),
                                                            n_layers=TRAIN_CUT))
    release()
    jamba_bwd, jamba = train_jamba_step()
    train_whisper()
    log(f"SSM, hybrid and encoder-decoder training phase wall: "
        f"{time.perf_counter() - t0:.1f} s")
    return bwd_inputs, c, jamba_bwd, jamba


# the SSD backward's bf16 kernels, by phase (csrc/ssd_backward.cu; the chunk
# states and the local dh terms are the forward's chunk_state_kernel)
def sharded_training(mesh):
    """Phase 21 (b): ``DIST_STEPS`` steps of ``make_sharded_train_step`` on
    ``mesh`` and of ``make_train_step``, from the same weights and batches,
    equal bit for bit.  Returns the sharded run's launches and its first
    batch's gradients."""
    cfg = train_cfg(n_layers=TRAIN_CUT)
    params0 = lm.init(cfg, seed=SEED, device=DEVICE)
    opt = AdamW(lr=TRAIN_LR, weight_decay=0.01,
                schedule=cosine_schedule(warmup=1, total=DIST_STEPS))
    it = token_batches(dataclasses.replace(cfg, vocab=TRAIN_DATA_VOCAB),
                       batch=TRAIN_CPU_BATCH, seq_len=TRAIN_CPU_SEQ, seed=SEED + 2)
    batches = [{k: torch.as_tensor(v, device=DEVICE) for k, v in next(it).items()}
               for _ in range(DIST_STEPS)]
    sharded = make_sharded_train_step(cfg, opt, mesh)
    plain = make_train_step(cfg, opt)
    with deterministic():
        zero_counts()
        t0 = time.perf_counter()
        p1, s1, l1 = params0, sharded.init(params0), []
        for b in batches:
            p1, s1, m = sharded(p1, s1, b)
            l1.append(m["loss"].item())
        c = counts()
        wall = time.perf_counter() - t0
        p2, s2, l2 = params0, opt.init(params0), []
        for b in batches:
            p2, s2, m = plain(p2, s2, b)
            l2.append(m["loss"].item())
        (_, _), grads = value_and_grad(p1, cfg, batches[0])
    same = [torch.equal(a, b) for a, b in zip(tree_leaves((p1, sharded.gather_state(s1))),
                                              tree_leaves((p2, s2)))]
    log(f"distribution: sharded train step ({cfg.name}, {cfg.n_layers} layers at full width, "
        f"bf16, B {TRAIN_CPU_BATCH} x S {TRAIN_CPU_SEQ}, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
        f", {dist.get_backend()}): {DIST_STEPS} steps in {wall:.2f} s, launches {c}; losses "
        f"{l1} / plain {l2}; {sum(same)}/{len(same)} leaves (parameters and moments) equal "
        f"bit for bit")
    assert all(same) and l1 == l2, (same, l1, l2)
    assert c["flash_attention"] == c["flash_attention_bwd"] == cfg.n_layers * DIST_STEPS, c
    assert sum(c.values()) == 2 * cfg.n_layers * DIST_STEPS, c
    return c, grads


def sharded_attention(group):
    """Phase 21 (c): the KV-length-sharded attention at llama-7b's width.
    Returns the launches of the sharded route and the last shard's flash
    launch inputs (for the kernel phase)."""
    cfg = get_config("llama-7b")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)

    def positions(B, lo, hi):
        return torch.arange(lo, hi, dtype=torch.int32, device=DEVICE)[None].expand(B, -1)

    rows = DIST_KV // DIST_SHARDS
    cases = {}
    for label, B, n_q, window in (("prefill", 1, DIST_Q, None),
                                  (f"prefill, window {DIST_WINDOW}", 1, DIST_Q, DIST_WINDOW),
                                  ("decode", DIST_DECODE_B, 1, None)):
        q, k, v = randn(B, n_q, H, hd), randn(B, DIST_KV, KV, hd), randn(B, DIST_KV, KV, hd)
        kw = dict(q_pos=positions(B, DIST_KV - n_q, DIST_KV).contiguous(),
                  kv_pos=positions(B, 0, DIST_KV).contiguous(), window=window)
        cases[label] = (q, k, v, kw)

    def shards(q, k, v, kw):
        return [((q, k[:, i * rows:(i + 1) * rows].contiguous(),
                  v[:, i * rows:(i + 1) * rows].contiguous()),
                 dict(kw, kv_pos=kw["kv_pos"][:, i * rows:(i + 1) * rows].contiguous()))
                for i in range(DIST_SHARDS)]

    def sharded_run(q, k, v, kw):
        pieces = [ops.flash_pieces(*t, causal=True, **skw) for t, skw in shards(q, k, v, kw)]
        return ops.combine_pieces([o for o, _ in pieces], [lse for _, lse in pieces])

    def group_run(label, q, k, v, kw):
        if label == "decode":
            return ops.decode_attention(q, k, v, kv_group=group, **kw)
        return ops.flash_attention(q, k, v, causal=True, kv_group=group, **kw)

    # the driven path: each case's shards and merge, and the one-rank group
    zero_counts()
    got = {label: (sharded_run(*c), group_run(label, *c)) for label, c in cases.items()}
    torch.cuda.synchronize()
    c = counts()
    assert c["flash_attention"] == (DIST_SHARDS + 1) * len(cases), c
    assert sum(c.values()) == c["flash_attention"], c
    # against one unsharded launch of the same kernel (and, at the decode
    # shape, the decode kernel); walls of both routes
    for label, (q, k, v, kw) in cases.items():
        want = fk.flash_attention(q, k, v, causal=True, **kw)
        sharded, one_rank = got[label]
        err = (sharded.float() - want.float()).abs().max().item()
        line = (f"distribution: KV-sharded attention ({label}; q{tuple(q.shape)} over "
                f"{DIST_KV} rows in {DIST_SHARDS} shards of {rows}, bf16): max|sharded - "
                f"unsharded| {err:.3e} (atol {BF16_ATOL}); one-rank group equal bit for bit "
                f"{torch.equal(one_rank, want)}")
        assert err <= BF16_ATOL, (label, err)
        assert torch.equal(one_rank, want), label
        if label == "decode":
            dec = dk.decode_attention(q, k, v, **kw)
            derr = (sharded.float() - dec.float()).abs().max().item()
            line += f"; max|sharded - decode_attention| {derr:.3e}"
            assert derr <= BF16_ATOL, derr
        sharded_ms = time_ms(lambda: sharded_run(q, k, v, kw))
        one_ms = time_ms(lambda: fk.flash_attention(q, k, v, causal=True, **kw))
        log(f"{line}; wall ms: {DIST_SHARDS} sharded launches + merge {sharded_ms:.4f}, one "
            f"unsharded launch {one_ms:.4f}")
    (q, k, v, kw) = cases["prefill"]
    last = shards(q, k, v, kw)[-1]
    return c, ([t.clone() for t in last[0]], dict(last[1], causal=True))


def distribution_phase():
    """Phase 21 (see the module docstring).  Returns its launches and the
    last KV shard's flash inputs."""
    t0 = time.perf_counter()
    with host_mesh(1, 1, device="cuda") as mesh:
        assert dist.get_backend() == "nccl", dist.get_backend()
        group = mesh.get_group("data")
        log(f"distribution: host mesh {mesh} over {dist.get_backend()}, world size "
            f"{dist.get_world_size()}, set up in {time.perf_counter() - t0:.1f} s")
        train_counts, grads = sharded_training(mesh)
        release()
        attn_counts, shard_inputs = sharded_attention(group)
        ratios = []
        for g in tree_leaves(grads):
            scale = g.float().abs().max().item() / 127.0
            err = (compressed_pmean(g, group).float() - g.float()).abs().max().item()
            ratios.append(err / max(scale, 1e-30))
        log(f"distribution: compressed_pmean over the one-rank group on {len(ratios)} gradient "
            f"leaves: max err / scale {max(ratios):.4f} (median "
            f"{sorted(ratios)[len(ratios) // 2]:.4f}; gate 1)")
        assert max(ratios) <= 1.0, max(ratios)
    assert not dist.is_initialized()
    release()
    log(f"distribution phase wall: {time.perf_counter() - t0:.1f} s")
    return {k: train_counts[k] + attn_counts[k] for k in train_counts}, shard_inputs


def dryrun_cells():
    """Phase 22 (a): each cut cell's dry-run record on a one-card mesh and
    the same step run on the card.  Returns the phase's launches."""
    assert not dist.is_initialized()
    cfg = get_config(DRYRUN_ARCH)
    records = {}
    for shape_name, gb in DRYRUN_CELLS:
        shape = dataclasses.replace(SHAPES[shape_name], global_batch=gb)
        rec = dryrun.run_cell(DRYRUN_ARCH, shape_name, False, None, shape=shape,
                              mesh_shape=((1, 1), ("data", "model")))
        assert rec["ok"], rec.get("traceback")
        records[shape_name] = (shape, rec)
    log(f"dry run: {DRYRUN_ARCH} cells on a one-rank fake group, cut only in global batch "
        f"({', '.join(f'{n} {SHAPES[n].global_batch} -> {b}' for n, b in DRYRUN_CELLS)})")
    params = lm.init(cfg, seed=SEED, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    total = {name: 0 for name in COUNTERS}

    def ids(*shape):
        return torch.randint(0, cfg.vocab, shape, generator=gen, device=DEVICE,
                             dtype=torch.int32)

    def measure(shape_name, shape, rec):
        """The cell's step on the card (its tensors die with the call)."""
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            opt = AdamW(lr=TRAIN_LR)
            step, state = make_train_step(cfg, opt), opt.init(params)
            batch = {"tokens": ids(B, S), "labels": ids(B, S),
                     "mask": torch.ones(B, S, device=DEVICE)}

            def run():
                p, _, m = step(params, state, batch)
                return [m["loss"]] + list(tree_leaves(p))[:2]
        elif shape.kind == "decode":
            st = lm.init_state(cfg, B, S, device=DEVICE)
            st = lm.LMState(pos=torch.full((B,), S - 1, dtype=torch.int32, device=DEVICE),
                            caches=st.caches)
            tok = ids(B, 1)

            def run():
                with torch.inference_mode():
                    return [lm.decode(params, cfg, tok, st)[0]]
        else:
            st = lm.init_state(cfg, B, S, device=DEVICE)
            tok = ids(B, S)

            def run():
                with torch.inference_mode():
                    return [lm.prefill(params, cfg, tok, st)[0]]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        outs = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts()
        peak = torch.cuda.max_memory_allocated()
        assert all(torch.isfinite(o.float()).all() for o in outs), shape_name
        del outs
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        m = rec["memory"]
        predicted = m["argument_bytes"] + m["temp_bytes"]
        roof = max(rec["flops"] / PEAK_FLOPS[torch.bfloat16],
                   rec["bytes_accessed"] / HBM_BYTES_PER_S)
        log(f"dry run {DRYRUN_ARCH} {shape_name} (B {B} x S {S}): record argument_bytes "
            f"{m['argument_bytes'] / 2**30:.3f} GiB + temp_bytes {m['temp_bytes'] / 2**30:.3f} "
            f"GiB = {predicted / 2**30:.3f} GiB (fits 80 GB: {predicted <= 80e9}), flops "
            f"{rec['flops']:.4e}, bytes {rec['bytes_accessed']:.4e}, roofline ms "
            f"{roof * 1e3:.3f}, traced in {rec['trace_s']:.1f} s; on the card: allocated "
            f"before {before / 2**30:.3f} GiB, max_memory_allocated {peak / 2**30:.3f} GiB "
            f"(above the allocated before: {(peak - before) / 2**30:.3f} GiB), predicted / "
            f"measured bytes {predicted / peak:.4f}; wall ms first {wall * 1e3:.1f}, second "
            f"{wall2 * 1e3:.1f}; launches {c}")
        return c

    for shape_name, (shape, rec) in records.items():
        release()
        c = measure(shape_name, shape, rec)
        for k in total:
            total[k] += c[k]
        release()
    del params
    release()
    return total


def kv_sharded_decode(key_scale: float = KVDEC_KEY_SCALE):
    """Phase 22 (b): llama-7b's KV-length-sharded decode through the
    models' route on a one-rank NCCL group, against the unsharded decode
    from the same cache, and the control: the sharded steps with every
    row's position one later, so each step's newest row drops out of
    attention, which must land outside the gate.  Returns the phase's
    launches and the recorded inputs of the last layer's flash and decode
    launches."""
    cfg = dataclasses.replace(get_config("llama-7b"), n_layers=KVDEC_DEPTH)
    params = lm.init(cfg, seed=SEED, device=DEVICE)
    for lp in params["layers"]:
        lp["attn"]["wk"].mul_(key_scale)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    state = lm.init_state(cfg, KVDEC_B, KVDEC_LEN, device=DEVICE)
    pos0 = KVDEC_LEN - KVDEC_STEPS
    for c in state.caches:
        for t in c.attn:
            for i in range(t.shape[0]):
                t[i].copy_(torch.randn(t[i].shape, generator=gen, device=DEVICE))
    saved = [tuple(t[:, :, pos0:].clone() for t in c.attn) for c in state.caches]

    def restore():
        for c, kv in zip(state.caches, saved):
            for t, rows in zip(c.attn, kv):
                t[:, :, pos0:].copy_(rows)

    pos = torch.full((KVDEC_B,), pos0, dtype=torch.int32, device=DEVICE)
    # the last call's inputs of each route's launch (the kernels' own
    # wrappers keep their counters: the entry points above them are wrapped)
    recorded = {}
    pieces, decode = ops.flash_pieces, ops.decode_attention

    def keep_last(name, fn):
        def call(*args, **kw):
            recorded[name] = (args, {k: v for k, v in kw.items() if k != "kv_group"})
            return fn(*args, **kw)
        return call

    def steps(group, toks=None):
        st = lm.LMState(pos=pos.clone(), caches=state.caches)
        if group is not None:
            st = lm.shard_state(st, group)
        tok = torch.randint(0, cfg.vocab, (KVDEC_B, 1), generator=torch.Generator(
            device=DEVICE).manual_seed(SEED + 24), device=DEVICE, dtype=torch.int32)
        logits, tokens, walls = [], [tok], []
        with torch.inference_mode():
            for i in range(KVDEC_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, st = lm.decode(params, cfg, tokens[-1] if toks is None else toks[i], st,
                                   kv_group=group)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                logits.append(lg.float())
                tokens.append(lg.argmax(-1)[:, None].to(torch.int32))
        return logits, tokens, walls

    zero_counts()
    ops.decode_attention = keep_last("decode", decode)
    try:
        want, want_tokens, want_walls = steps(None)
    finally:
        ops.decode_attention = decode
    plain_counts = counts()
    restore()
    t0 = time.perf_counter()
    with host_mesh(1, 1, device="cuda") as mesh:
        group = mesh.get_group("model")
        zero_counts()
        ops.flash_pieces = keep_last("flash", pieces)
        try:
            got, got_tokens, got_walls = steps(group, want_tokens)
        finally:
            ops.flash_pieces = pieces
        shard_counts = counts()
        restore()

        def shifted(q, k, v, *, kv_pos, **kw):
            return pieces(q, k, v, kv_pos=torch.where(kv_pos >= 0, kv_pos + 1, kv_pos), **kw)
        ops.flash_pieces = shifted
        try:
            control, _, _ = steps(group, want_tokens)
        finally:
            ops.flash_pieces = pieces
    assert not dist.is_initialized()
    n = KVDEC_DEPTH * KVDEC_STEPS
    assert plain_counts["decode_attention"] == n and sum(plain_counts.values()) == n, plain_counts
    assert shard_counts["flash_attention"] == n and sum(shard_counts.values()) == n, shard_counts
    worst, parted = 0.0, []
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all()
        for r in range(KVDEC_B):
            diff = (a[r] - b[r]).abs().max().item()
            worst = max(worst, diff)
            if int(a[r].argmax()) != int(b[r].argmax()):
                gap = top2_gap(b[r])
                parted.append((i, r, round(gap, 4), round(diff, 4)))
                assert gap <= diff, (i, r, gap, diff)
    missed = max((a - b).abs().max().item() for a, b in zip(control, want))
    log(f"kv-sharded decode: llama-7b cut to {KVDEC_DEPTH} layers, bf16, keys x{key_scale:g}, "
        f"B {KVDEC_B} over {KVDEC_LEN} rows (seeded random cache, steps at {pos0}.."
        f"{KVDEC_LEN - 1}), one-rank NCCL group (host mesh set up and run in "
        f"{time.perf_counter() - t0:.1f} s): max|sharded - unsharded logits| {worst:.4f} over "
        f"{KVDEC_STEPS} steps (atol {LOGIT_ATOL}); the control (positions one later, each "
        f"step's newest row masked) {missed:.4f}, which must exceed it; argmax parted at "
        f"(step, row, top-two gap, diff) {parted}; step wall ms sharded "
        f"{[round(w, 2) for w in got_walls]} / unsharded {[round(w, 2) for w in want_walls]}; "
        f"launches sharded {shard_counts}, unsharded {plain_counts}")
    assert worst <= LOGIT_ATOL < missed, (worst, missed)
    inputs = {k: keep(list(args), kw) for k, (args, kw) in recorded.items()}
    total = {k: plain_counts[k] + shard_counts[k] for k in plain_counts}
    del params, state, saved, recorded, control
    release()
    return total, shard_counts, plain_counts, inputs


def dryrun_phase():
    """Phase 22 (see the module docstring).  Returns its launches, (b)'s
    by route, and (b)'s recorded last-layer inputs."""
    t0 = time.perf_counter()
    cell_counts = dryrun_cells()
    kv_total, kv_shard, kv_plain, kv_inputs = kv_sharded_decode()
    log(f"dry-run phase wall: {time.perf_counter() - t0:.1f} s; launches: cells {cell_counts}, "
        f"kv-sharded decode {kv_total}")
    return cell_counts, kv_shard, kv_plain, kv_inputs


# --------------------------------------------------------------------------- #
# Tensor parallelism (phase 23)
# --------------------------------------------------------------------------- #
def tp_setup():
    """Phase 23's model, weights, optimizer and batches, the same in every
    process (a seeded generator on the card)."""
    cfg = train_cfg(n_layers=TRAIN_CUT)
    params = lm.init(cfg, seed=SEED, device=DEVICE)
    opt = AdamW(lr=TRAIN_LR, weight_decay=0.01,
                schedule=cosine_schedule(warmup=1, total=TP_STEPS))
    it = token_batches(dataclasses.replace(cfg, vocab=TRAIN_DATA_VOCAB), batch=TP_BATCH,
                       seq_len=TP_SEQ, seed=SEED + 3)
    batches = [{k: torch.as_tensor(v, device=DEVICE) for k, v in next(it).items()}
               for _ in range(TP_STEPS)]
    return cfg, params, opt, batches


def tp_param_bound(opt, want: torch.Tensor) -> float:
    """The largest |Δ| a parameter may show after ``TP_STEPS`` steps whose
    gradients differ only in their sums' order: a gradient element near 0
    may flip its sign, and AdamW moves it by up to 2 lr on the first step
    (m / sqrt(v) = ±1) and 2 x 2 lr on each later one (|m / sqrt(v)| < 2
    at b1 0.9, b2 0.95), and each side rounds to bf16 (one ulp of the
    leaf's largest magnitude each)."""
    lrs = [TRAIN_LR * float(opt.schedule(torch.tensor(i + 1))) for i in range(TP_STEPS)]
    top = want.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    return 2 * lrs[0] + 4 * sum(lrs[1:]) + 2 * ulp


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def tp_one_rank():
    """Phase 23 (a).  Returns its launches and ``make_train_step``'s run
    (losses and parameters, on the host): (b) and (c)'s reference."""
    calls = {"_forward_tp": 0, "_nll_sharded": 0}
    originals = {"_forward_tp": attention._forward_tp, "_nll_sharded": lm._nll_sharded}

    def counted(mod, name):
        def call(*args, **kw):
            calls[name] += args[-1] is not None  # the model group, last
            return originals[name](*args, **kw)
        setattr(mod, name, call)

    with host_mesh(1, 1, device="cuda") as mesh:
        assert dist.get_backend() == "nccl", dist.get_backend()
        cfg, params0, opt, batches = tp_setup()
        sharded = make_sharded_train_step(cfg, opt, mesh)
        plain = make_train_step(cfg, opt)
        assert sharded.model_group is not None
        counted(attention, "_forward_tp")
        counted(lm, "_nll_sharded")
        try:
            with deterministic():
                zero_counts()
                t0 = time.perf_counter()
                p1, s1, l1 = sharded.shard_params(params0), sharded.init(params0), []
                for b in batches:
                    p1, s1, m = sharded(p1, s1, b)
                    l1.append(m["loss"].item())
                c = counts()
                wall = time.perf_counter() - t0
                p2, s2, l2 = params0, opt.init(params0), []
                for b in batches:
                    p2, s2, m = plain(p2, s2, b)
                    l2.append(m["loss"].item())
                    if len(l2) == 1:
                        m1 = _cpu(tree_leaves(s2.m))
        finally:
            attention._forward_tp, lm._nll_sharded = (originals["_forward_tp"],
                                                      originals["_nll_sharded"])
        same = [torch.equal(a, b) for a, b in zip(
            tree_leaves((sharded.gather_params(p1), sharded.gather_state(s1))),
            tree_leaves((p2, s2)))]
        log(f"tensor parallelism (a): the model-axis route on {dist.get_backend()}'s one-rank "
            f"mesh ({cfg.name}, {cfg.n_layers} layers at full width, bf16, B {TP_BATCH} x S "
            f"{TP_SEQ}): {TP_STEPS} steps in {wall:.2f} s, route calls {calls}, launches {c}; "
            f"losses {l1} / make_train_step {l2}; {sum(same)}/{len(same)} leaves (parameters "
            f"and moments) equal bit for bit")
        assert all(same) and l1 == l2, (same, l1, l2)
        assert calls == {"_forward_tp": cfg.n_layers * TP_STEPS, "_nll_sharded": TP_STEPS}, calls
        assert c["flash_attention"] == c["flash_attention_bwd"] == cfg.n_layers * TP_STEPS, c
        assert sum(c.values()) == 2 * cfg.n_layers * TP_STEPS, c
        reference = (l2, [t.cpu() for t in tree_leaves(p2)], opt, m1)
        del p1, s1, p2, s2, params0, batches
    assert not dist.is_initialized()
    release()
    return c, reference


def tp_rank(rank: int, world: int, workdir: str, control: bool = False) -> None:
    """One gloo rank of phase 23 (b) or (c), in its own process on the
    card: ``TP_STEPS`` steps of ``make_sharded_train_step`` on a ``(data 1,
    model world)`` mesh; its losses, walls, peak memory, launches,
    parameter shards and first moments' shards after step 1 (and rank 0's
    first recorded flash launches) go to ``workdir``.  The ``control`` runs
    one step with ``copy_to_model``'s backward all-reduce left out on every
    rank (a wrong gradient the gate must catch)."""
    workdir = pathlib.Path(workdir)
    torch.cuda.set_device(0)
    if control:
        tensor_parallel._CopyToModel.backward = staticmethod(lambda ctx, g: (g, None))
    dist.init_process_group("gloo", store=dist.FileStore(str(workdir / "store"), world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
        cfg, params, opt, batches = tp_setup()
        step = make_sharded_train_step(cfg, opt, mesh)
        params = step.shard_params(params)
        state = step.init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, walls = [], []
        with deterministic(), TrainRecorder() as rec:
            zero_counts()
            for b in batches[:1] if control else batches:
                t0 = time.perf_counter()
                params, state, m = step(params, state, b)
                losses.append(m["loss"].item())
                walls.append(time.perf_counter() - t0)
                if len(losses) == 1:
                    m1 = _cpu(tree_leaves(state.m))  # data 1: ZeRO-1 slices are whole
            c = counts()
        out = dict(losses=losses, walls=walls, peak=torch.cuda.max_memory_allocated(),
                   counts=c, local=_cpu(tree_leaves(params)), m1=m1,
                   specs=[tuple(sp) for sp in tree_leaves(step.param_specs)])
        if rank == 0:
            out["fwd"], out["bwd"] = _cpu(rec.fwd), _cpu(rec.bwd)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, workdir / f"out_{rank}.pt")


def tp_spawn(world, workdir, control=False):
    """``world`` processes of ``tp_rank`` in ``workdir``; returns their
    outputs and the processes' wall."""
    workdir.mkdir()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--tp-rank",
                               str(r), str(world), str(workdir)] + ["control"] * control)
             for r in range(world)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0] * world, f"tensor parallelism: ranks' exit codes {rcs}"
    return [torch.load(workdir / f"out_{r}.pt") for r in range(world)], time.perf_counter() - t0


def tp_gathered(outs, key):
    """The whole leaves from the ranks' shards under ``key``, and whether
    every leaf the specs replicate is equal on every rank."""
    got, replicated_equal = [], True
    for i, spec in enumerate(outs[0]["specs"]):
        parts = [o[key][i] for o in outs]
        if "model" in spec:
            got.append(torch.cat(parts, dim=spec.index("model")))
        else:
            got.append(parts[0])
            replicated_equal &= all(torch.equal(parts[0], q) for q in parts[1:])
    return got, replicated_equal


def tp_moment_error(outs, want_m):
    """The worst leaf's largest |Δ| of the first moments after step 1 over
    that leaf's largest magnitude, and the leaf's index."""
    got, _ = tp_gathered(outs, "m1")
    errs = [((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
            for g, w in zip(got, want_m)]
    return max(errs), errs.index(max(errs))


def tp_gloo_ranks(label, world, what, reference, tmp):
    """Phase 23 (b) or (c): ``world`` processes of ``tp_rank``, held to
    the single-process step.  Returns every rank's launches summed and rank
    0's recorded flash launches."""
    want_losses, want_params, opt, want_m = reference
    outs, wall = tp_spawn(world, pathlib.Path(tmp) / f"tp{world}")
    got, replicated_equal = tp_gathered(outs, "local")
    errs = [((g.float() - w.float()).abs().max().item(), tp_param_bound(opt, w))
            for g, w in zip(got, want_params)]
    moved = sum(int((g != w).sum()) for g, w in zip(got, want_params))
    worst = max(errs, key=lambda e: e[0] / e[1])
    loss_err = max(abs(a - b) for o in outs for a, b in zip(o["losses"], want_losses))
    m_err, m_leaf = tp_moment_error(outs, want_m)
    n = outs[0]["counts"]
    log(f"tensor parallelism {label}: {world} gloo ranks on the card, mesh (data 1, model "
        f"{world}), {what}: processes' wall {wall:.1f} s; losses "
        f"{[o['losses'] for o in outs]} / make_train_step {want_losses}, max |Δ| {loss_err:.3e} "
        f"(atol {TP_LOSS_ATOL}); gathered parameters: worst leaf max |Δ| {worst[0]:.3e} "
        f"against its bound {worst[1]:.3e} ({moved} of {sum(w.numel() for w in want_params)} "
        f"elements differ); first moments after step 1: worst leaf (#{m_leaf}) max |Δ| / max "
        f"|m| {m_err:.4e} (rtol {TP_MOMENT_RTOL}); replicated leaves equal on every rank "
        f"{replicated_equal}; launches a rank {n}")
    for r, o in enumerate(outs):
        log(f"tensor parallelism {label} rank {r}: step walls ms "
            f"{[round(x * 1e3, 1) for x in o['walls']]}, max_memory_allocated "
            f"{o['peak'] / 2**30:.3f} GiB")
    assert loss_err <= TP_LOSS_ATOL, loss_err
    assert all(e <= b for e, b in errs), errs
    assert m_err <= TP_MOMENT_RTOL, (m_err, m_leaf)
    assert replicated_equal
    layers = TRAIN_CUT * TP_STEPS
    for o in outs:
        c = o["counts"]
        assert c["flash_attention"] == c["flash_attention_bwd"] == layers, c
        assert sum(c.values()) == 2 * layers, c
    total = {k: sum(o["counts"][k] for o in outs) for k in n}
    return total, outs[0]["fwd"], outs[0]["bwd"]


def tp_control(reference, tmp):
    """Phase 23's control: (b)'s two ranks for one step with
    ``copy_to_model``'s backward all-reduce left out; its first moments
    must miss ``TP_MOMENT_RTOL``."""
    outs, wall = tp_spawn(2, pathlib.Path(tmp) / "control", control=True)
    m_err, m_leaf = tp_moment_error(outs, reference[3])
    log(f"tensor parallelism control (b) without copy_to_model's backward all-reduce: "
        f"processes' wall {wall:.1f} s; losses {[o['losses'] for o in outs]}; first moments "
        f"after step 1: worst leaf (#{m_leaf}) max |Δ| / max |m| {m_err:.4e} (must exceed "
        f"{TP_MOMENT_RTOL})")
    assert m_err > TP_MOMENT_RTOL, (m_err, m_leaf)


def tensor_parallel_phase():
    """Phase 23 (see the module docstring).  Returns its launches (every
    process's) and (b)'s rank 0's first recorded flash launches."""
    t0 = time.perf_counter()
    total, reference = tp_one_rank()
    recorded = None
    with tempfile.TemporaryDirectory() as tmp:
        for label, world, what in TP_RANKS:
            c, fwd, bwd = tp_gloo_ranks(label, world, what, reference, tmp)
            total = {k: total[k] + c[k] for k in total}
            recorded = recorded or (fwd, bwd)
        tp_control(reference, tmp)
    log(f"tensor-parallel phase wall: {time.perf_counter() - t0:.1f} s; launches {total}")
    fwd, bwd = recorded
    to_card = lambda t: t.to(DEVICE) if isinstance(t, torch.Tensor) else t  # noqa: E731
    fwd = ([to_card(t) for t in fwd[0]], {k: to_card(v) for k, v in fwd[1].items()})
    bwd = ([to_card(t) for t in bwd[0]], {k: to_card(v) for k, v in bwd[1].items()})
    return total, fwd, bwd


SSD_BWD_KERNELS = {"chunk states": "chunk_state_kernel<false>",
                   "state pass": "state_pass_kernel", "local dh": "chunk_state_kernel<true>",
                   "reverse pass": "reverse_pass_kernel", "x grads": "x_grad_kernel",
                   "dB dC": "bc_grad_kernel", "d dt": "dt_grad_kernel",
                   "dB dC reduce": "bc_reduce_kernel", "dA": "dA_reduce_kernel"}
# ... as a pattern of the compiler's report, which names templates mangled
SSD_BWD_PTXAS = "|".join(dict.fromkeys(v.split("<")[0] for v in SSD_BWD_KERNELS.values()))
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")


def ssd_bwd_states(B, H, P, S, seed=1):
    """A seeded initial state and final-state gradient ``[B, H, P, S]`` f32."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    return tuple(torch.randn(B, H, P, S, generator=g, device=DEVICE) for _ in range(2))


def check_ssd_bwd(inputs, launches, label):
    """Hold ``ssd_chunked_bwd`` against ``ssd_chunked_bwd_plain`` (f64, at
    the model's chunk of 256) on ``inputs`` (x, dt, A, B, C, dy) in bf16
    and cast to f32, each without and with a seeded initial state and
    final-state gradient: every output within ``SSD_BWD_BF16_RTOL`` (bf16
    dx, dB, dC) or ``SSD_BWD_F32_RTOL`` of its largest magnitude, and two
    launches giving the same bits.  Times the kernel and its plain version
    without the states.  The bound counts x, dt, A, B, C, dy read once and
    dx, d dt, dA, dB, dC written once, and the operations of the chunked
    backward at the kernel's chunk (``ssk.CHUNK``) at the inputs' peak: per
    chunk of n tokens the causal half (n(n+1)/2 pairs) of C·Bᵀ once per
    group and of dY·Xᵀ, Mᵀ dY, dM B and dMᵀ C per head, and five [P, S]
    products a token and head (the rebuilt state, the local dh term, dh_out
    B, dY h_in, X dh_out; dy_t·y_off_t needs no sixth, being C_t·(e_t
    dy_tᵀ h_in), the dC term's own product).  Queues the bf16 launch's device time per kernel.  Returns the
    kernel's entry of the ``{"kernels": [...]}`` line, from the bf16 run
    without the states."""
    x, dt, A, Bm, Cm, dy = inputs
    Bsz, L, H, P = x.shape
    G, S = Bm.shape[2], Bm.shape[3]
    states = ssd_bwd_states(Bsz, H, P, S)
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        xx, bb, cc, dd = (t.to(dtype) for t in (x, Bm, Cm, dy))
        for h0, dhT in ((None, None), states):
            got = sbk.ssd_chunked_bwd(xx, dt, A, bb, cc, dd, dhT, initial_state=h0)
            again = sbk.ssd_chunked_bwd(xx, dt, A, bb, cc, dd, dhT, initial_state=h0)
            want = ssk.ssd_chunked_bwd_plain(xx, dt, A, bb, cc, dd, dhT, chunk=256,
                                             initial_state=h0)
            torch.cuda.synchronize()
            assert all(a is b or torch.equal(a, b) for a, b in zip(got, again)), (
                f"ssd_chunked_bwd {label}: two launches differ")
            errs, abs_err = [], 0.0
            for name, g, w in zip(SSD_BWD_NAMES, got, want):
                if w is None:
                    continue
                diff = (g.float() - w.float()).abs().max().item()
                abs_err = max(abs_err, diff)
                err = diff / w.float().abs().max().item()
                tol = (SSD_BWD_BF16_RTOL if dtype == torch.bfloat16 and name in ("dx", "dB", "dC")
                       else SSD_BWD_F32_RTOL)
                errs.append(f"{name} {err:.3e} (gate {tol:.3e})")
                assert err <= tol, (label, dtype, h0 is not None, name, err, tol)
            del want, again
            note = ""
            if h0 is None:
                call = functools.partial(sbk.ssd_chunked_bwd, xx, dt, A, bb, cc, dd)
                ms = time_ms(call, reps=5)
                plain_ms = time_ms(lambda: ssk.ssd_chunked_bwd_plain(xx, dt, A, bb, cc, dd,
                                                                    chunk=256), reps=2)
                ns = [min(ssk.CHUNK, L - t) for t in range(0, L, ssk.CHUNK)]
                tri = sum(n * (n + 1) // 2 for n in ns)
                flops = 2.0 * Bsz * (G * tri * S + H * tri * (2 * P + 2 * S) + 5 * H * L * P * S)
                b, by = bound_ms(nbytes(xx, dt, A, bb, cc, dd, *got), flops, dtype)
                note = (f"; ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b:.4f} ({by}); no "
                        f"single library call")
                if dtype == torch.bfloat16:
                    device_ms_later(f"ssd_chunked_bwd {label} bf16", call, SSD_BWD_KERNELS,
                                    reps=5)
                    entry = dict(name="ssd_chunked_bwd", route="cuda",
                                 source="src/repro_torch/kernels/csrc/ssd_backward.cu",
                                 replaces="src/repro/kernels/ssd_scan.py:91 (its gradient: no "
                                          "Pallas backward exists; JAX differentiates through "
                                          "the scan)",
                                 launches=launches, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                                 library_ms=None)
            log(f"kernel ssd_chunked_bwd {label} {str(dtype)[6:]} x{tuple(x.shape)} G {G} S {S} "
                f"initial state and dhT {h0 is not None}: rel errs {', '.join(errs)}; two "
                f"launches give the same bits{note}")
            del got
            torch.cuda.empty_cache()
    log(f"ssd_chunked_bwd ptxas: {ptxas_notes('ssd_backward', SSD_BWD_PTXAS)}")
    return entry


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; kernels built in "
        f"{time.perf_counter() - t0:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- dense serve phase ------------------------------------------------
    cfg = LLAMA
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    log(f"llama-7b cut to {cfg.n_layers} layers, bf16, priced as the whole model: "
        f"{sum(p.numel() for p in _leaves(params)) / 1e9:.2f} B params drawn in "
        f"{time.perf_counter() - t0:.1f} s")

    zero_counts()
    eng, recs, rec, steps, writebacks = serve(cfg, params)
    dense_counts = counts()
    n_decode = eng.decode_stats()["decode_steps"]
    log(f"dense serve launches: {dense_counts} (decode steps {n_decode}, "
        f"packed batches {eng.batches})")
    log_steps("dense", steps)
    actions = {i: (r.action, r.matched_tokens) for i, r in sorted(recs.items())}
    log(f"actions (action, matched tokens): {actions}")
    log(f"write-backs: {writebacks}, store entries: {len(eng.store.entries)}")
    assert len(recs) == 8 and all(len(r.tokens) == NEW_TOKENS for r in recs.values())
    assert any(a in ("load", "partial") for a, _ in actions.values()), actions
    assert any(a == "recompute" for a, _ in actions.values()) and writebacks >= 1, (
        actions, writebacks)
    assert dense_counts["packed_flash_attention"] > 0, dense_counts
    assert dense_counts["decode_attention"] == cfg.n_layers * n_decode > 0, dense_counts
    assert dense_counts["flash_attention"] == dense_counts["paged_decode_attention"] == 0
    assert dense_counts["kv_quant"] == dense_counts["kv_dequant"] == 0, dense_counts
    first_logits, step_logits = rec.first_logits, rec.step_logits
    packed_inputs, decode_inputs = rec.packed_inputs, rec.decode_inputs
    reqs = traffic(cfg.vocab)
    load_req = next(reqs[i] for i, (a, m) in actions.items()
                    if a == "load" and m == len(reqs[i]["context_tokens"]))
    artifact = stored_artifact(eng, load_req["context_tokens"])
    dense_nbytes = stored_nbytes(eng, [r["context_tokens"] for r in traffic(cfg.vocab)])
    summary = eng.summary().as_dict()
    log(f"summary: {json.dumps(summary)}")
    dense_batches = {i: (e.req_ids, e.q_len, e.kv_len)
                     for e in rec.events if isinstance(e, ev.BatchAdmitted) for i in e.req_ids}
    dense_logits = rec.req_logits
    del eng, rec
    release()

    base, base_recs, base_rec, _, _ = serve(cfg, params, reuse=False)
    reused = [i for i, (a, _) in actions.items() if a in ("load", "partial")]
    agree = total = 0
    for i in reused:
        diff = (first_logits[i] - base_rec.first_logits[i]).abs().max().item()
        same = sum(x == y for x, y in zip(recs[i].tokens, base_recs[i].tokens))
        agree, total = agree + same, total + NEW_TOKENS
        log(f"request {i} ({actions[i][0]}): first-token logits max|reuse - recompute| "
            f"= {diff:.4f}, tokens agreeing {same}/{NEW_TOKENS}")
        assert diff <= LOGIT_ATOL, (i, diff)
    log(f"reuse vs recompute token agreement: {agree}/{total}")
    recompute_logits = base_rec.first_logits
    del base, base_rec
    release()

    # ---- paged serve phase ------------------------------------------------
    zero_counts()
    peng, precs, prec, psteps, _ = serve(cfg, params, paged_decode=True, kv_block=128)
    paged_counts = counts()
    pn_decode = peng.decode_stats()["decode_steps"]
    log(f"paged serve launches: {paged_counts} (decode steps {pn_decode})")
    log_steps("paged", psteps)
    log(f"paged decode_stats: {json.dumps(peng.decode_stats())}")
    pactions = {i: (r.action, r.matched_tokens) for i, r in sorted(precs.items())}
    assert pactions == actions, (pactions, actions)
    assert paged_counts["paged_decode_attention"] == cfg.n_layers * pn_decode > 0, paged_counts
    assert paged_counts["decode_attention"] == paged_counts["flash_attention"] == 0
    assert paged_counts["packed_flash_attention"] > 0, paged_counts
    assert paged_counts["chunked_prefill_attention"] == 0, paged_counts
    assert peng.decode_stats()["shared_block_hits"] > 0, peng.decode_stats()
    for i in first_logits:
        assert torch.equal(prec.first_logits[i], first_logits[i]), f"first logits {i} differ"
    assert len(prec.step_logits) == len(step_logits), (len(prec.step_logits), len(step_logits))
    # the paged kernel gives the dense kernel's bits over the same rows
    for n, ((pa, pl), (da, dl)) in enumerate(zip(prec.step_logits, step_logits)):
        assert pa == da, (pa, da)
        assert torch.equal(pl, dl), f"decode step {n}: paged logits differ from dense"
    agree = sum(x == y for i in recs for x, y in zip(precs[i].tokens, recs[i].tokens))
    log(f"paged vs dense: first-token and all {len(step_logits)} decode steps' logits "
        f"equal, tokens agreeing {agree}/{NEW_TOKENS * len(recs)}")
    assert peng._paged.pool.n_used == 0
    paged_inputs = prec.decode_inputs
    check_cow(peng)
    del peng
    release()

    # ---- unified serve phase ----------------------------------------------
    zero_counts()
    ueng, urecs, urec, usteps, _ = serve(cfg, params, paged_decode=True, unified_step=True,
                                         kv_block=128)
    unified_counts = counts()
    ustats = ueng.unified_stats()
    un_decode = ueng.decode_stats()["decode_steps"]
    log(f"unified serve launches: {unified_counts} (mixed steps {ustats['steps']}, "
        f"decode-only steps {un_decode})")
    log_steps("unified", usteps)
    log_decode_gaps("unified", urecs, urec)
    log_decode_gaps("paged", precs, prec)
    log(f"unified_stats: {json.dumps(ustats)}")
    log(f"unified decode_stats: {json.dumps(ueng.decode_stats())}")
    uactions = {i: (r.action, r.matched_tokens) for i, r in sorted(urecs.items())}
    assert uactions == actions, (uactions, actions)
    assert unified_counts["chunked_prefill_attention"] == cfg.n_layers * ustats["steps"] > 0, (
        unified_counts, ustats)
    assert unified_counts["packed_flash_attention"] == 0, unified_counts
    assert unified_counts["paged_decode_attention"] == cfg.n_layers * un_decode, unified_counts
    assert unified_counts["decode_attention"] == unified_counts["flash_attention"] == 0
    assert ustats["jit"]["misses"] == 1, ustats
    agree = same_requests = 0
    for i in sorted(urecs):
        diff = (urec.first_logits[i] - prec.first_logits[i]).abs().max().item()
        assert diff <= LOGIT_ATOL, (i, diff)
        ut, pt = urecs[i].tokens, precs[i].tokens
        part = next((n for n, (x, y) in enumerate(zip(ut, pt)) if x != y), None)
        note = "all equal"
        if part is not None:
            gap = top2_gap(prec.req_logits[i][part])
            note = f"first differ at token {part}, paged top-two gap there {gap:.4f}"
            assert gap < LOGIT_ATOL, (i, part, gap)
        agree += sum(x == y for x, y in zip(ut, pt))
        same_requests += part is None
        log(f"unified request {i}: first-token logits max|unified - paged| = {diff:.4f}; "
            f"tokens {note}")
    log(f"unified vs paged: {same_requests}/{len(urecs)} requests' tokens equal, "
        f"tokens agreeing {agree}/{NEW_TOKENS * len(urecs)}")
    ueng._paged.audit()
    assert ueng._paged.pool.n_used == 0
    chunked_inputs = urec.chunked_inputs
    assert chunked_inputs is not None, "no launch held a decode, a chunk and an idle row"
    unified_first = urec.first_logits
    unified_nbytes = stored_nbytes(ueng, [r["context_tokens"] for r in reqs])
    unified_summary = ueng.summary().as_dict()
    unified_logits = urec.req_logits
    del ueng, urec, prec
    release()

    # ---- per-request prefill phase ----------------------------------------
    zero_counts()
    flash_full, flash_suffix = per_request_prefill(
        cfg, params, reqs, recompute_logits, load_req, artifact, first_logits)
    prefill_counts = counts()
    log(f"per-request prefill launches: {prefill_counts}")
    assert prefill_counts["flash_attention"] == cfg.n_layers * (len(reqs) + 2), prefill_counts
    assert sum(prefill_counts.values()) == prefill_counts["flash_attention"], prefill_counts
    release()

    # ---- fused (CacheBlend-style) reuse phase ------------------------------
    fused_inputs, fused_launches = fused_phase(cfg, params)
    release()

    # ---- compressed (int8) tier phase -------------------------------------
    comp = compressed_phase(cfg, params, {
        "dense": (actions, dense_counts, first_logits, dense_nbytes),
        "unified": (uactions, unified_counts, unified_first, unified_nbytes)})
    comp["dense_first"] = first_logits
    compressed_checks(cfg, params, comp, artifact, load_req["context_tokens"])
    release()

    # ---- fault and latency-hiding phase -------------------------------------
    fault_phase(cfg, params, (recs, dense_logits, dense_batches, summary),
                (urecs, unified_logits, {}, unified_summary), smi)

    # ---- cluster phase ----------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        cluster_phase(cfg, params, (recs, dense_logits, dense_counts, summary), smi,
                      pathlib.Path(tmp))

        # ---- telemetry phase ----------------------------------------------
        telemetry_phase(cfg, params, (recs, first_logits, dense_counts, summary, steps), smi,
                        pathlib.Path(tmp))

    # ---- market phase -----------------------------------------------------
    spot_inputs, market_flash = market_phase(cfg, params, smi)
    del params, artifact
    release()
    launcher_phase()

    # ---- SSM serve phase --------------------------------------------------
    ssd_inputs, ssd_launches = ssm_phase()

    # ---- other families: dense GQA nemo, then the MoE olmoe --------------
    t_phase = time.perf_counter()
    nemo_inputs, nemo_counts = nemo_phase()
    log(f"nemo phase wall: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    moe_inputs, moe_counts = moe_phase()
    log(f"olmoe phase wall: {time.perf_counter() - t_phase:.1f} s")

    # ---- sliding-window phase: mixtral-8x22b's ring ----------------------
    t_phase = time.perf_counter()
    swa_inputs, swa_counts = swa_phase()
    log(f"mixtral phase wall: {time.perf_counter() - t_phase:.1f} s")

    # ---- hybrid phase: jamba-1.5-large-398b's Mamba, attention and MoE ----
    t_phase = time.perf_counter()
    hybrid_inputs, hybrid_counts = hybrid_phase()
    log(f"jamba phase wall: {time.perf_counter() - t_phase:.1f} s")

    # ---- the rest of the model zoo: granite-34b, internvl2-1b, whisper-tiny --
    t_phase = time.perf_counter()
    granite_inputs, granite_counts = granite_phase()
    log(f"granite phase wall: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    vlm_inputs, vlm_counts = vlm_phase()
    log(f"internvl phase wall: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    whisper_inputs, whisper_counts, whisper_flash = whisper_phase()
    log(f"whisper phase wall: {time.perf_counter() - t_phase:.1f} s")

    # ---- training: qwen2-0.5b's train steps through the backward kernel ----
    train_fwd, train_bwd, train_counts = training_phase()

    # ---- training: mamba2-1.3b, jamba and whisper through the SSD backward --
    ssm_bwd, ssm_train_counts, jamba_bwd, jamba_train_counts = ssm_training_phase()

    # ---- distribution: the host mesh, the sharded step, KV-sharded attention --
    dist_counts, dist_shard = distribution_phase()

    # ---- dry run: records against real steps, the models' KV-sharded decode --
    dry_counts, kv_shard_counts, kv_plain_counts, kv_inputs = dryrun_phase()

    # ---- tensor parallelism: the model axis on one rank and on gloo ranks ---
    tp_counts, tp_fwd, tp_bwd = tensor_parallel_phase()

    # ---- kernel phase -----------------------------------------------------
    # the kernels line counts each kernel's launches on its llama path and
    # on the same path of nemo's, olmoe's, mixtral's, granite's, internvl's
    # and whisper's serves
    def launches(name, *runs):
        return sum(c[name] for c in runs)

    dense_runs = (dense_counts, nemo_counts, moe_counts["dense"], swa_counts["ring"],
                  swa_counts["dense"], granite_counts["dense"], vlm_counts["dense"],
                  whisper_counts["dense"])
    kernels = [check_packed(packed_inputs, launches("packed_flash_attention", *dense_runs)),
               check_decode(decode_inputs, launches("decode_attention", *dense_runs)),
               check_flash(flash_full, launches("flash_attention", prefill_counts,
                                                swa_counts["ring"], granite_counts["prefill"],
                                                vlm_counts["dense"], whisper_counts["dense"]),
                           "full"),
               check_paged(paged_inputs, launches("paged_decode_attention", paged_counts,
                                                  moe_counts["paged"], swa_counts["unified"],
                                                  granite_counts["paged"],
                                                  granite_counts["unified"],
                                                  vlm_counts["paged"], vlm_counts["unified"])),
               check_chunked(chunked_inputs, launches("chunked_prefill_attention",
                                                      unified_counts, moe_counts["unified"],
                                                      swa_counts["unified"],
                                                      granite_counts["unified"],
                                                      vlm_counts["unified"])),
               check_fused(fused_inputs, fused_launches + granite_counts["fused"][
                   "fused_flash_attention"]),
               check_kv_quant(comp["quant_input"], comp["dense"]["counts"]["kv_quant"]),
               check_kv_dequant(comp["dequant_inputs"], comp["dense"]["counts"]["kv_dequant"]),
               check_ssd(ssd_inputs, ssd_launches)]
    check_flash(flash_suffix, prefill_counts["flash_attention"], "suffix")
    check_flash(spot_inputs, market_flash, "spot check")
    # the same kernels on nemo's (G 4, hd 128, H·hd != d_model) and olmoe's
    # recorded first-layer inputs, each beside its launches on that serve
    check_packed(nemo_inputs["packed"], nemo_counts["packed_flash_attention"], "nemo")
    check_decode(nemo_inputs["decode"], nemo_counts["decode_attention"], "nemo")
    check_packed(moe_inputs["dense"]["packed"],
                 moe_counts["dense"]["packed_flash_attention"], "olmoe")
    check_decode(moe_inputs["dense"]["decode"], moe_counts["dense"]["decode_attention"],
                 "olmoe")
    check_paged(moe_inputs["paged"]["decode"], moe_counts["paged"]["paged_decode_attention"],
                "olmoe")
    check_chunked(moe_inputs["unified"]["chunked"],
                  moe_counts["unified"]["chunked_prefill_attention"], "olmoe")
    # mixtral's (G 6, hd 128): flash and decode over the wrapped ring, the
    # packable serve's packed, paged and chunked launches
    ring = swa_counts["ring"]
    check_flash(swa_inputs["ring"]["flash"]["wave 0"], ring["flash_attention"],
                "mixtral ring wave 0")
    check_flash(swa_inputs["ring"]["flash"]["suffix"], ring["flash_attention"],
                "mixtral ring suffix")
    check_decode(swa_inputs["ring"]["decode"], ring["decode_attention"], "mixtral ring")
    check_packed(swa_inputs["dense"]["packed"], swa_counts["dense"]["packed_flash_attention"],
                 "mixtral")
    check_paged(swa_inputs["unified"]["decode"],
                swa_counts["unified"]["paged_decode_attention"], "mixtral")
    check_chunked(swa_inputs["unified"]["chunked"],
                  swa_counts["unified"]["chunked_prefill_attention"], "mixtral")
    # jamba's (G 8, no RoPE; the SSD at H 128, P 128, S 16, G 1): timed
    # beside their bound and SDPA, the kernels line carrying each with its
    # launches on the hybrid serve
    hybrid = hybrid_counts["dense"]
    kernels += [
        dict(check_ssd(hybrid_inputs["ssd"], hybrid["ssd_chunked"], "jamba"), at=HYBRID_AT),
        dict(check_flash(hybrid_inputs["flash"]["wave 0"], hybrid["flash_attention"],
                         "jamba wave 0"), at=HYBRID_AT),
        dict(check_decode(hybrid_inputs["decode"], hybrid["decode_attention"], "jamba"),
             at=HYBRID_AT)]
    check_flash(hybrid_inputs["flash"]["suffix"], hybrid["flash_attention"], "jamba suffix")
    # granite's (G 48, hd 128): the first prefill launches at 48 query heads
    # a kv head, each on its served inputs and beside its launches there
    g = granite_counts
    kernels += [dict(entry, at="granite-34b") for entry in (
        check_packed(granite_inputs["dense"]["packed"], g["dense"]["packed_flash_attention"],
                     "granite"),
        check_decode(granite_inputs["dense"]["decode"], g["dense"]["decode_attention"],
                     "granite"),
        check_flash(granite_inputs["flash_full"], g["prefill"]["flash_attention"],
                    "granite full"),
        check_paged(granite_inputs["paged"]["decode"], g["paged"]["paged_decode_attention"],
                    "granite"),
        check_chunked(granite_inputs["unified"]["chunked"],
                      g["unified"]["chunked_prefill_attention"], "granite"),
        check_fused(granite_inputs["fused"], g["fused"]["fused_flash_attention"], "granite"))]
    check_flash(granite_inputs["flash_suffix"], g["prefill"]["flash_attention"],
                "granite suffix")
    # internvl's (G 7, hd 64, qkv bias): an image request's prefill and a
    # load's prompt after the stored image, decode dense and paged, chunked
    v = vlm_counts
    check_flash(vlm_inputs["dense"]["flash"]["wave 0"], v["dense"]["flash_attention"],
                "internvl image")
    check_flash(vlm_inputs["dense"]["flash"]["suffix"], v["dense"]["flash_attention"],
                "internvl suffix")
    check_decode(vlm_inputs["dense"]["decode"], v["dense"]["decode_attention"], "internvl")
    check_paged(vlm_inputs["paged"]["decode"], v["paged"]["paged_decode_attention"],
                "internvl")
    check_chunked(vlm_inputs["unified"]["chunked"], v["unified"]["chunked_prefill_attention"],
                  "internvl")
    # whisper's (G 1, hd 64): the first served non-causal launches, the
    # kernels line carrying each with its own kind's launches on the serve
    # (the causal self-attention prefills are in the main flash entry's)
    wf = whisper_flash
    kernels += [dict(entry, at=f"whisper-tiny, {at}") for at, entry in (
        ("encoder", check_flash(whisper_inputs["encoder"], wf["encoder"], "whisper encoder")),
        ("a prompt's cross-attention", check_flash(
            whisper_inputs["cross prompt"], wf["cross prompt"], "whisper cross prompt")),
        ("a decode step's cross-attention", check_flash(
            whisper_inputs["cross step"], wf["cross step"], "whisper cross decode step")),
        ("self-attention", check_decode(whisper_inputs["decode"],
                                        whisper_counts["dense"]["decode_attention"],
                                        "whisper")))]
    # the training phase's (qwen2-0.5b, G 7, hd 64): the forward with its
    # lse and the backward on the full run's first recorded launches, each
    # with that run's launches; the backward also on llama's heads (G 1, hd
    # 128), on mixtral's G 6 with a window shorter than the sequence and in
    # f32, where FlashAttentionFn is held to autograd of the plain forward
    kernels += [
        dict(check_flash(train_fwd, train_counts["flash_attention"], "qwen2-0.5b training"),
             at="qwen2-0.5b training"),
        check_flash_bwd(train_bwd, train_counts["flash_attention_bwd"]
                        + dist_counts["flash_attention_bwd"], "qwen2-0.5b training")]
    check_flash_bwd(bwd_inputs(1, 2048, 32, 32, 128, torch.bfloat16), 0, "llama heads")
    check_flash_bwd(bwd_inputs(1, 2048, 48, 8, 128, torch.bfloat16, window=1024), 0,
                    "mixtral heads, window 1024")
    f32_inputs = bwd_inputs(1, 512, 14, 2, 64, torch.float32)
    check_flash_bwd(f32_inputs, 0, "f32")
    check_flash_fn_f32(f32_inputs)
    check_wide_group()
    # the SSD backward on the full mamba2 run's recorded launch and on the
    # jamba step's, each with its launches there
    kernels += [
        check_ssd_bwd(ssm_bwd, ssm_train_counts["ssd_chunked_bwd"], "mamba2-1.3b training"),
        dict(check_ssd_bwd(jamba_bwd, jamba_train_counts["ssd_chunked_bwd"],
                           "jamba-1.5-large-398b training"),
             at="jamba-1.5-large-398b training, 1-layer cut, B 1 x L 2,048")]
    # the distribution phase's: the last KV shard's launch, with the
    # phase's launches (the sharded training's forwards and the shards')
    kernels.append(dict(check_flash(dist_shard, dist_counts["flash_attention"],
                                    "llama-7b KV shard"),
                        at=f"llama-7b, KV-sharded over {DIST_SHARDS} shards (phase 21)"))
    # the dry-run phase's: the KV-sharded decode's last flash launch (one
    # query row over the cache, with lse) and the unsharded decode's, each
    # with its route's launches
    kernels += [
        dict(check_flash(kv_inputs["flash"], kv_shard_counts["flash_attention"],
                         "llama-7b KV-sharded decode"),
             at=f"llama-7b, {KVDEC_DEPTH} layers, KV-sharded decode over {KVDEC_LEN} rows "
                "(phase 22)"),
        dict(check_decode(kv_inputs["decode"], kv_plain_counts["decode_attention"],
                          "llama-7b 32k decode"),
             at=f"llama-7b, {KVDEC_DEPTH} layers, decode over {KVDEC_LEN} rows (phase 22)")]
    log(f"dry-run phase cells' launches (qwen2-0.5b): {dry_counts}")
    # the tensor-parallel phase's: rank 0 of the model axis of 2 (7 query
    # heads on 1), its first forward with lse and first backward, with the
    # phase's launches (every process's)
    tp_at = "qwen2-0.5b, model rank 0 of 2 (layout (a), 7 on 1 heads; phase 23)"
    kernels += [
        dict(check_flash(tp_fwd, tp_counts["flash_attention"], "tensor-parallel rank"),
             at=tp_at),
        dict(check_flash_bwd(tp_bwd, tp_counts["flash_attention_bwd"], "tensor-parallel rank"),
             at=tp_at)]
    log_device_times()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"]:
        tp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5:6] == ["control"])
    else:
        main()
