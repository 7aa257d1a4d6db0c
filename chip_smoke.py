#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # all phases, one card

1. Header: the card's name and power limit, torch / CUDA versions, and the
   time to build the hand-written kernels from ``omchat_torch/csrc``.
2. Kernel phases: each kernel of the main path (K1-K4) at the main path's
   shapes, in bf16, held against its plain PyTorch version; kernel, plain,
   library (one PyTorch call computing the same function) and bound times.
   K1, K2 and K3 (and, in phases 6, 17, 22 and 23, batched K2, e4m3 K2 and
   K3, K5 and K6) are read as phase 13 reads K16: the median of
   ``READINGS`` readings of 30 launches, kernel and library in turns, with
   the achieved TFLOP/s and the share of the bound; the K1 line also times
   its prepass alone, and holds it against its plain version
   (``PREPASS_TOL``, with two planted faults).  K3 walks the 28 layers and
   the decode lengths, so that every launch reads from HBM; a K3 or K6 call
   takes the card less time than the host takes to issue it, so they and
   their library calls are read as device time (the 28 calls of a walk
   captured in a CUDA graph, ``device_times``) beside the time of a call
   issued eagerly.  The K3 line gives how the split-KV kernel cut the cache
   (splits, rows a split, grids); its check plants keys at a split's edge and
   catches one split's rows dropped.  K4 and its ``index_put_`` are read as
   graphed device time too (``GRAPH_CALLS`` calls), beside the eager call
   and K4's launch floor (an empty kernel on its grid, read the same way).
3. End to end: ``OmChatConfig()`` at full width and depth (InternViT-6B +
   Qwen2-7B, random bf16 weights from a seeded generator), one 448x448 image
   (3 anyres tiles) and a question, greedy decode of 32 tokens through
   ``OmChatEngine.generate``, each decode step one CUDA-graph replay (as in
   every phase: the engines decode through graphs by default); every kernel
   must have launched.
4. Kernel vs plain: the same model at full width and reduced depth, prefill
   through the kernels and through ``attn_impl="plain"``; first-token logits
   compared.
5. Serving: ``PagedBatchEngine`` at full width and depth on the repo's mixed
   workload (``dev/bench_serving.py:27-47`` rebuilt from
   ``numpy.random.default_rng(0)``: 16 requests of 64-512 text tokens, a 2-tile
   image on every 4th, 64 new tokens each); a warm-up at 4 new tokens, then
   the timed run: tokens/s, TTFT and inter-token percentiles, the wall time of
   a decode step and of the ViT, short-prefill and chunk dispatches on the
   card's timeline; every request must return 64 tokens, every page must come
   back, and K12, K14 and K15 must launch.  The run records what each paged
   kernel was handed.  The four image prompts then prefill again, alternately
   with K14 and with the gather + K2 chunk attention it replaced: the chunk
   dispatch time on each, and first-token logits that must agree.
6. Paged kernel phases: K12, K14 and K15 (and K2 at its batched-prefill
   shape) at what the timed serving run handed them, held against their plain
   versions with planted boundary keys and planted faults, as in phase 2;
   K14 is also timed against gather + K2; K12 and its gather + SDPA call are
   read graphed over a walk of the 28 layers, as K3 is.
7. Paged vs single-request engine at full width and 2+2 layers: 4 requests
   (1 image, 3 text); first-token logits within phase 4's limits, greedy
   tokens identical up to the first step whose reference top-2 margin is
   under 0.1.
8. w8a8: the full-width full-depth random model quantized to int8 and its
   ViT fc1 scales calibrated (``api.quantize_model``, what
   ``load_pretrained_model(w8a8=True)`` runs): int8 weight GiB, quantize and
   calibrate seconds.
9. w8a8 end to end: phase 3's request on the quantized model (TTFT, ViT,
   prefill and decode spans, peak memory); K7, K8, K9 and K11 must launch.
   The run records what each w8a8 kernel was handed.
10. w8a8 serving: phase 5's workload through ``PagedBatchEngine`` on the
    quantized model; the glue kernels must launch on the short-prefill and
    chunk routes.
11. w8a8 kernel phases: K7, K8, K9 and K11 at the shapes phase 9 handed
    them, held against their plain versions (int8 codes, x', row scales; K11's
    x' bitwise) with planted faults that must fall outside the limits;
    kernel, plain, library (``torch._int_mm`` on the same GEMM, for K9 and
    K11) and bound times.  K7 and K8 are read as graphed device time from
    HBM (``GRAPH_CALLS`` calls cycling over ``hbm_set_count`` input sets)
    beside the eager call, with the share of the bound.
12. w8a8 kernels vs plain at full width and 2+2 layers: first-token logits
    through the glue kernels and through ``attn_impl="plain"`` (the unfused
    chain), no further apart than w8a8 moves the plain chain from bf16.
13. Training kernel phases: K16a (forward + lse), K16b (dQ) and K16c (dK/dV)
    at the shapes phase 14 hands them (the LLM's causal GQA 28/4 over 2 x 3328
    rows, the ViT's non-causal 25/25 over 6 x 1025) and on a packed 4096-row
    batch of four documents and a -1 tail, with keys planted at the tile and
    segment boundaries, held against their plain versions; planted faults (di
    dropped, the causal mask shifted, lse from the wrong row, a q head left
    out of dK/dV, segment isolation broken) must fall outside the limits;
    kernel, plain, library (SDPA forward; SDPA backward for dQ + dK/dV) and
    bound times, the achieved TFLOP/s and the share of the bound.  A kernel's
    time is the median of ``READINGS`` readings of 30 launches, the three
    kernels and the SDPA forward and backward read in turns (K16b and K16c
    given the one prescaled q the backward hands them); the ``q * scale``
    pass is timed beside; a second dQ launch must be bitwise the same.
14. Stage-1 at full width and depth: ``OmChatConfig()`` with random bf16
    weights, B=2 samples of one seeded 448x448 image and a 64-token answer
    (2 x 3328 merged rows), three ``train_step``s training the projector alone
    (lr 1e-3, no warmup, clip 1.0): finite losses, step 3 below step 1, only
    projector leaves changed, K16a/b/c launched the expected counts; step
    wall ms (CUDA events, mean of steps 2-3), trained tokens/s, peak GiB,
    ``mfu`` (``training.train_step.model_flops`` / step time / 989 TFLOP/s)
    and ``hfu`` (the same with the remat recompute counted).
15. LoRA rank 16 on q/k/v/o over the bf16 base, then QLoRA over the trunk
    quantized to int8: three steps each, the same checks (only adapter
    leaves move) and numbers.
16. Training kernels vs plain at full width and 2+2 layers: the stage-1 loss
    and projector gradients and the LoRA adapter gradients through the
    kernels and through ``attn_impl="plain"``, and again through kernels
    with one of five planted faults (a q head left out of dK/dV, di dropped,
    the wrong kv head, the causal mask ignored or shifted), each of which
    must fall outside a limit in one comparison; then two full-parameter
    stage-2 steps, whose backward runs K16b/K16c through the ViT too.
17. The fp8 KV cache's kernels: K13 (the manual-copy paged decode) over a
    bf16 and an e4m3 pool and the e4m3 variants of K12 and K14 at what phase
    5 handed K12 and K14, of K2 and K3 at phase 2's shapes, against their
    plain versions with phase 6's planted keys; planted faults (a page-table
    entry off by one, the self column or p rounded to e4m3, phase 6's) must
    fall outside the limits.  K13 and K12 on the e4m3 pool, and their gather
    + SDPA calls, are read as device time (a walk over the 28 layers
    graphed, ``device_times``) beside the eager call; K13 must equal K12
    bit for bit on the same inputs, on both pools (they share chunks and
    arithmetic).  The e4m3 stores of K4 and K15 bitwise at those
    shapes, and on all 65536 bf16 bit patterns against ``ops.fp8.to_e4m3``;
    their times graphed (``device_times``) beside the eager call (K15's
    352 MB a call read from HBM).
18. Serving at full width and depth, phase 5's workload, three more runs:
    bf16 pool on K13, e4m3 pool on K12, e4m3 pool on K13 (pool GiB, the
    first step leaving phase 5's tokens); each K13 run must give every
    request the K12 run's tokens on its pool; then phase 3's request with an
    e4m3 cache (TTFT, decode tokens/s, peak GiB).
19. fp8 at full width and 2+2 layers: first-token logits, e4m3 vs bf16 cache
    and kernels vs plain on e4m3, within FP8_LOGIT_GAP_REL of max |logit|; a
    fault planted in K2 (q heads on the next kv head) must fall outside.

20. Page sizes 16, 32, 64: K12 and K13 (bf16 and e4m3 pools) and K14 (both
    pools) at what phase 5 handed K12 and K14, the same logical caches cut
    into pages of each size, against their plain versions (a page-table
    entry off by one page must fall outside the limits); K12 / K13 at page
    size 32 bitwise against 128; kernel times at page size 64 beside 128's
    (K12 and K13 read graphed, 28 calls, in turns, with the eager calls).
    Then phase 5's workload at ``page_size=64`` (384 pages; line
    ``serving (page_size=64)``: tokens/s, every page back, the first step
    leaving the page-size-128 tokens), and ``PagedBatchEngine(page_size=48)``
    refused on CUDA before it allocates.
21. The calibrated w8a8 MLP (K10): ``calibrate_swiglu_scales`` over phase
    8's quantized 28-layer trunk on the request's merged prompt embeddings
    (line ``w8a8 swiglu calibrate``), the request again (``w8a8 e2e
    (calibrated MLP)``, 28 K10 launches, beside phase 9's numbers) and the
    serving workload (K10 on the batched-shorts and chunk routes); phase 11
    holds K10 against its plain version at every recorded shape (planted
    faults: gate and up swapped, row scales shifted), phase 12 also compares
    the calibrated 2+2-layer model's logits through the kernels with the
    plain route.
22. The InternViT-6B geometry without qk-norm (45 layers, random bf16
    weights, the request's 3 tiles): the packed route runs K5 in every layer
    (line ``vit without qk-norm (K5)``: ViT ms, launches, max |diff| against
    the plain route); K5 against its plain version at (3, 1032, 25*128)
    valid 1025 and unpadded, planted faults (no prescale, valid_len off by
    one) outside the limits.
23. Decode over a per-layer cache (K6), on phase 3's model: one decode step
    after the request's prefill with every layer through ``cache_attend``
    (S == 1: the token written into the layer cache, K6 over it) against the
    same step through ``decode_scan`` (K3 + K4), bf16 and e4m3 caches; per
    layer, K6 against K3 with the self column on one q; K6 against its plain
    version at B=16 ragged lengths and at the request's shape, keys planted
    at a split's edge (cache_len off by one and one split's rows dropped
    caught), timed at the request's shape over 28 caches walked in turn.
24. Decode as one dispatch, on phase 3's model and request: ``generate`` and
    ``generate_ondevice`` through an engine replaying a CUDA graph of the
    decode step and one running the same step eagerly
    (``decode_graphs=False``), in turns, on bf16, the e4m3 cache and (after
    phase 9) w8a8: tokens bitwise equal and the same launches in every run;
    decode tokens/s, step wall ms, capture ms, launches and peak GiB of each.
    Then phase 5's workload, graphed after ``precompile()`` and eager, on
    K12 and on K13: every request the eager run's tokens, every roll
    graphed, the same launches; tokens/s, TTFT and inter-token percentiles,
    the 16-slot decode step wall, rolls graphed / eager and pages free.
25. The single-request surface through the entry points (right after phase
    24), on phase 3's model as an ``OmChatModel`` (``api.omchat_model``, the
    ``MockTokenizer``), 32 greedy tokens each: a 3-turn chat on one 448x448
    image with history threaded (turns 2-3 must hit the encoded-image cache),
    a 1344x1344 image (1 + 9 tiles, 10240 image tokens), three 448x448
    images interleaved with text, and a 32-frame video (``VIDEO_WRITTEN``
    JPEG frames written by PIL, sampled by ``load_video_frames``, through
    ``chat_video``: ~32.9k merged rows); each line gives TTFT, decode
    tokens/s, ViT tiles/s, prefill ms, peak GiB and K1-K4 launches, and the
    entry point's tokens must equal ``engine.generate``'s on the same ids
    and tiles.  K2 at the video prompt's rows: its last query rows against
    the plain version, timed beside SDPA.
26. ``generate``'s options and the single-request runtimes on that model:
    sampling on the graph (``generate_ondevice(do_sample=True)`` twice
    graphed and once eager from one seed, bitwise equal, every token in its
    step's top 50, one replay a step), a +100 bias, a frequency penalty,
    log-probs of the biased logits, guided choices / JSON mode /
    ``chat_tools(tool_choice="required")``, ``prefill_chunked`` against the
    one-shot prefill on bf16 and e4m3 caches, speculative decoding (an
    oracle draft, whose verify logits must track the decode steps' at 2+2
    layers, and prompt lookup on an echo prompt), beam search (4 beams, 16
    tokens; at 2+2 layers each step's addition to a beam's score within
    ``BEAM_STEP_GAP`` of the plain route's), with planted faults that both
    limits must catch, the device preprocessing pipeline against the host
    path; K2 at a verify step's 9 rows and K3 at B = 4 and over the video's
    cache against their plain versions (planted faults), timed graphed with
    their bounds.  After phase 9 (and phase 21) one speculative run under
    w8a8 must launch K7 and K11 (and K10) at M = 9 and nowhere else; phase
    11 holds them at those shapes too (rows ``[M=9]``).  C4: the verify
    (9 rows), decode and one-shot prefill routes of the same tokens read at
    full depth on the kernels and on the plain route (``c4_route_gaps``);
    the full-depth verify is held to ``C4_LIMIT`` (1.5x the largest plain
    gap an H100 run read), which both planted verify faults must fail.
27. The server over HTTP, in process on 127.0.0.1, on phase 3's model
    (right after phase 26): the default route (the single-request engine)
    with phase 3's image request as a base64 PNG (its tokens bitwise
    ``engine.generate``'s, the SSE deltas the same text, HTTP TTFT beside
    the engine's, K1-K4 launches) and one request of each option; the
    ``--paged`` route serving phase 5's workload from 16 client threads
    (sampled, log-prob, SSE and greedy requests; tokens/s, SSE TTFT and
    inter-chunk percentiles, every roll graphed after ``precompile`` of
    all four pick modes, capture ms, pages back, K12 / K14 / K15 / K4
    launches; request 0 alone bitwise the in-process run); the paged
    log-probs against the single-request engine's on the same tokens
    (``C4_LIMIT`` at full depth, phase 4's limits at 2+2 layers, where
    three planted faults must fail); a graphed sampled roll bitwise the
    eager one, every draw in its top 50; a LoRA bank of two rank-16
    adapters (adapter 0 the base engine's tokens; adapter 1 against
    ``merge_lora``; decode tokens/s with and without the bank).
28. The paged engine's routes at full width and depth on phase 3's weights
    (right after phase 27): (a) phase 5's requests behind one 1024-token
    system prompt, served cold and with ``prefix_cache=True`` after a wave
    that published the prompt's pages (hits, prefill dispatch wall ms by
    kind, TTFT, tokens/s, pages free + evictable = the pool); the hit
    requests' first-token logits against the cold ones within 1.5x the gap
    the plain route reads (``PREFIX_PLAIN_GAP``), which a hit resumed one
    page late and decode rows written onto the shared pages must fail;
    multi-turn VQA (turn 2 hits every page turn 1 published, the ViT
    skipped; TTFT of both turns).  (b) The verify's logits
    (``_paged_verify``: K2 over gathered pages, K4) against the decode
    route's at full depth, fed the same tokens, within 1.5x the gap the
    kernels' plain versions read between the two routes
    (``SPEC_PLAIN_GAP``; write_pos + 1 and the draft a row late must fail
    it), that gap and the plain route's read beside it, and against
    ``attn_impl="plain"`` at 2+2 layers within phase 4's limits; an echo workload at 16 slots on plain rolls
    and with speculative verify in turns (verify dispatches, tokens, mean
    accepted drafts, tokens/s, verifies eager 0), the graphed verify's ms
    beside the graphed roll's ms a step.  (c) Phase 27 (b) over HTTP with
    ``--streaming-roll 4``: SSE inter-chunk p50 / p99 beside the same engine
    without it and phase 27's, the roll lengths run, a request alone over
    SSE bitwise its 16-step run.  (d) Phase 5's workload in process, then
    phase 27 (b) over HTTP, with and without ``pipeline_rolls`` in turns:
    tokens bitwise equal, every roll graphed, the card's busy share
    between rolls.  Kernel rows: K2 at the largest verify (16 slots x 5
    rows over the gathered blocks, SDPA with the same mask), K4 at its
    L*S*T = 2240 rows (``index_put_``), K14 on the prefix run's largest
    resumed chunk (gather + SDPA).
29. The slot engine (``runtime/batch_engine.py:BatchEngine``, the server's
    ``--continuous-batching`` route) at full width and depth on phase 3's
    weights (right after phase 28): phase 5's workload on 16 slots of 4096
    rows, chunks of 512, after ``precompile`` (line ``slot engine``:
    tokens/s, TTFT p50 / p99, the 16-slot step's wall ms, the graphed step
    beside the same body eager (``step_ms``), chunk dispatch ms, K1-K4
    launches; every request 64 tokens, every step a replay); a late joiner
    (request 1's tokens bitwise with and without request 0 joining); the
    e4m3 rerun (K2, K3, K4 on the e4m3 cache; the first step leaving the
    bf16 tokens); at 2+2 layers 4 requests against the single-request engine
    and a LoRA bank of two rank-16 adapters (ids 0 / 1 / 2) against merged
    weights, both by phase 7's rule, the bank's planted faults (adapters 1
    and 2 swapped, the bank ignored) outside phase 4's limits;
    ``process_anyres_image(use_native=True)``
    on a seeded 1000x700 image within ``NATIVE_TOL`` of the numpy path, ms
    of each.  Kernel rows at what the timed run handed them: K2 on its
    largest 512-row chunk into one slot, K3 at 16 rows of unequal lengths
    with parked rows of 0 cache rows (planted faults: a row's length from its
    neighbour, a parked row given cache rows), K4 on that step's 448 rows,
    parked rows at row 4095 (bitwise).
30. The eval entry point (``omchat_torch/cli/eval.py``'s ``run`` on phase
    3's model with ``id_tokenizer``): 8 questions (4 with a seeded PNG)
    serial and with 4 in flight (the paged engine), samples/s of each, then
    ``--perplexity`` on a seeded text (K2 on cacheless windows); at 2+2
    layers the serial answers must be ``engine.generate``'s tokens, the
    concurrent ones agree up to the first step whose top-2 margin is under
    0.1, and each counted token's nll be within ``PPL_TOKEN_GAP`` of
    ``attn_impl="plain"``'s, where the plain route with a planted fault
    (non-causal attention, one future column) must fall outside it.
31. The other towers (right after phase 30): CLIP-L/336, CLIP-L with
    clip_smoe (4 experts, top-2), SigLIP so400m/384 and InternViT-300M/448
    at full width and depth on 5 seeded images through
    ``build_vision_tower(name).forward``, and CLIP-L through S2 at (336,
    672, 1008); each against ``attn_impl="plain"`` within
    ``TOWER_REL_LIMIT`` of max |out| (the CLIP-SMoE plain run on the kernel
    run's routing), K2 launched once a layer run; then K2 at the towers'
    shapes, D = 64 at 577 and 1025 rows and D = 72 at 729, against its plain
    version with planted keys, where two planted faults (the softmax scale of
    a 128-wide head; q and k read past column D) must fall outside.
32. The OmChat variants through ``OmChatModel.chat`` on phase 3's 7B and 6B
    weights, one seeded image and 32 greedy tokens each: InternViT-300M with
    a 1024 -> 3584 mlp2x_gelu projector (K2 at D = 64 in the encode), the v1
    spatial_unpad merge with an image_newline on a 1000x700 image, the
    cabstract projector (144 queries, depth 3), the mlp_smoe projector (4
    experts, top-2): TTFT, decode tokens/s, tokens per sentinel; at 2+2
    layers each variant's kernels against the plain route by phase 7's rule.
33. The Qwen1.5-MoE-A2.7B trunk (``MOE_TEXT``, 14.3 B parameters) behind the
    resident InternViT-6B, after phase 3's 7B weights are released: phase
    3's request through the single-request engine (graphed steps, beside
    the step's weight-read floor), phase 5's workload through the paged
    engine after ``precompile`` (every roll a replay), 4 of its requests
    through the slot engine; K2-K4 and K12 / K14 / K15 at group 1 (16 / 16
    heads) at those runs' shapes against their plain versions (phases 2 and
    6's keys and faults); at 2+2 layers kernels vs plain within phase 4's
    limits and ``moe_impl="gmm"`` against dense within ``MOE_GMM_REL``.
34. K2's segment-ids entry (``omchat_flash_attention_seg``) at the packed
    forward's shape: 28 / 4 heads of 128 over one 4096-row pack of five
    documents and a -1 tail, causal (the kernels line's row) and
    non-causal, and at D = 64 over 16 / 16 heads; keys planted at every
    document boundary and tile edge; against its plain version on every row
    (the -1 rows zeros), with two planted faults (a boundary off by one,
    padding allowed to attend) outside the limit; timed in turns beside SDPA
    with the same boolean block-diagonal mask.
35. The packed forward: ``loss_fn(attn_impl=None)`` over the full-depth
    Qwen2-7B trunk on that pack, against the plain route's packed loss and
    against the five documents run one at a time, within ``PACKED_LIMITS``
    (1.5 x the plain route's own packed-vs-one-at-a-time gaps in the mean
    loss and in max |logit|), which the pack without its segment ids must
    fail; K2's segment entry launched once a layer.
36. The HF export round trip: the full-width model at 2 + 2 layers through
    ``export_hf_bundle`` into a temporary directory and back through
    ``load_pretrained_model``: every tensor bitwise, the config equal, phase
    3's request giving the in-memory engine's greedy tokens through K1-K4;
    write and load seconds, the bundle's GiB.
37. Parity: ``run_parity`` on that bundle, its own remote-code twin in fp32
    on the card against the port's engine on the kernels (bf16), the plain
    route (bf16) and the plain route (fp32): argmax match rate, first
    divergence, max |logit diff| (printed; argmax flips on random weights);
    the kernels held to 1.5 x the plain bf16 route's gap and the fp32 route
    to ``PARITY_FP32_LIMIT``; layer 0's q_proj transposed in the twin must
    fail the kernels' limit.

38. The sharded train step (``make_sharded_train_step``) at full width on
    1 ViT + 1 trunk layer (``PARALLEL_LAYERS``), two ranks spawned on the
    one card over gloo
    (``run_ranks``): tp 2 (14 / 2 trunk heads and 13 or 12 ViT heads a
    rank), dp 2, dp 2 with FSDP, three full fine-tune steps each on one
    batch of two samples whose answers differ in length, on the kernel route
    (K16 on each rank's heads) and on the plain route, against the
    single-device ``train_step`` on the same weights and batch.  Two
    distances to world 1: the RMS gap of the per-token losses after the last
    step, and the largest relative L2 gap of a leaf's AdamW first moments.
    The kernel route's must stay within ``PARALLEL_BAR`` x the plain route's
    in the same mode; a planted fault in each mode (down_proj's row-parallel
    reduce dropped, the ranks' mean loss, the FSDP gradient unscattered) and
    a control step whose update is skipped must fall outside; every rank's
    K16a/b/c launches must match the per-layer formula.  Step
    wall ms at world 1 and 2, the collectives' share of a step and each
    rank's peak GiB are printed: the ranks share one card, so they show the
    collectives' overhead, not scaling.
39. Tensor-parallel serving, two ranks spawned on the one card over gloo
    (``run_ranks``), each holding its shard of seeded weights built one
    layer at a time (``layerwise_model``: the same weights at any tp).
    (a) Full width, 2 ViT + 2 trunk layers: ``OmChatEngine`` on phase 3's
    request, ``PagedBatchEngine`` and ``BatchEngine`` on phase 7's 4
    requests, at tp 2 on the kernels and on ``attn_impl="plain"``, against
    the same engines on one device and the same route: first-token logits
    within phase 4's limits, tokens by phase 7's rule; every rank's
    launches by the per-layer formula (the one-device counts, each ViT
    layer's K1 a K2 on the rank's heads); three planted faults (o_proj's
    row-parallel reduce dropped, the cache written with the other rank's kv
    heads, the vocabulary blocks gathered in reversed rank order) must leave
    phase 4's limits.  (b) Full width at 3 ViT + 2 trunk layers
    (``SERVING_TP_DEEP``): phase 3's
    request at tp 2 (TTFT, ViT / prefill / decode ms, eager decode ms a
    step, each rank's peak GiB, the collectives' share of a decode step)
    and phase 5's workload through ``PagedBatchEngine`` (tokens/s, TTFT p50
    / p99), printed beside world 1's phase 3 / 5 numbers, which are taken
    at full depth and so are not comparable with them; the first-token
    logits' gap to world 1 on the kernels within ``SERVING_TP_BAR`` x the
    plain route's gap (C4's rule), and the o_proj fault outside it.
40. The rest of tensor-parallel serving at 2 + 2 layers: w8a8, a LoRA bank
    and the MoE trunk at tp 2 in phase 39's world, Qwen2-7B's 4 kv heads
    replicated at tp 8 in a world of 8 (``serving_tp_remainder``).
41. The trainer's sequence modes and an indivisible tp, phase 38's setup
    with the embedding, lm_head and trunk MLP frozen: the ring (cp 2: blocks of 1664
    rows, rank 0 one K16a a trunk layer, rank 1 two), Ulysses (P 2: 14
    heads a rank over 3328 rows), Megatron sequence parallelism at tp 2 and
    the ring over phase 35's 4096-row pack (the gathered route) on two
    ranks, Qwen2-7B's trunk at tp 3 (q heads 10 / 9 / 9 over all 4 kv
    heads, runs of 7 + 3 / 4 + 5 / 2 + 7) on three, each on the kernel and
    the plain route against the single-device ``train_step``: the largest
    relative loss gap over the steps and of the gradients' global norm,
    the kernel route's within ``SEQ_BAR`` x the plain route's (each at least
    its floor), a planted fault in each case outside it, every rank's K16
    launches by the per-layer formula; step ms, the collectives' share and
    each rank's peak GiB printed.  Then K16a/b/c timed at the shapes these
    modes hand them, beside their plain versions, SDPA and their bounds.
42. GPipe pipeline training (``make_pp_train_step``) at pp 2 on two ranks
    sharing the card over gloo, full width at 2 ViT + 4 trunk layers (two a
    stage), phase 38's batch in two one-row microbatches and a packed batch
    of two 4096-row rows (segment ids ride the schedule as ``static``), the
    embedding and trunk MLP frozen, on the kernel and the plain route against the
    single-device ``train_step``: phase 41's bar on the loss and
    gradient-norm gaps, three planted faults (the handoff's backward
    zeroed, the head's gradients summed over the stages, the input path's
    left on stage 0) past it, the stages' replicated leaves bitwise equal,
    every rank's K16 launches by the per-layer formula (a stage's own
    layers once a microbatch, the ViT on stage 0); step ms, the handoff's
    and the broadcasts' share and each rank's peak GiB printed (line
    ``pipeline training (phase 42, this call)``).  Then K16a/b/c checked at
    a microbatch's shape.
43. Head width 64: Qwen/Qwen2-0.5B's trunk widths (``QWEN2_05B_TEXT``: 14 /
    2 heads of 64, tied embeddings) behind InternViT-300M/448 and a 1024 ->
    896 mlp2x_gelu projector (InternVL2-1B's geometry), full width and
    depth, random bf16 weights (``head_width_64``): phase 3's request
    through ``OmChatModel.chat`` on a bf16 and an e4m3 cache (TTFT, decode
    tokens/s, peak GiB; K2 a ViT and trunk layer, K3 a step and layer, K4 a
    step, every step a graph replay), phase 5's workload through
    ``PagedBatchEngine`` after ``precompile`` on K12 and K13 over a bf16 and
    an e4m3 pool (tokens/s, TTFT p50 / p99; every request 64 tokens, every
    page back, every roll a replay, K13 K12's tokens), 4 of its requests
    through ``BatchEngine``, phase 23's decode step through
    ``cache_attend`` (K6).  Then phases 2, 6, 17 and 23's kernel checks
    and times at the shapes these runs handed the kernels (rows tagged
    ``[D=64]``), and ``width_checks`` at D = 64, 72 and 16 (bf16; e4m3 at
    64 and 16) at phase 2's lengths: K3, K6, K12, K13, K14 and K2 on e4m3
    against their plain versions, a fault model at (D, D) within the limit
    and its two planted faults (the scale of a 128-wide head; q and k read
    past column D) outside it, K12 bitwise K13.  At 2 + 2 layers the
    single-request and paged engines on the kernels against
    ``attn_impl="plain"`` by phase 7's rule.  Alone: ``python3
    chip_probes/head_width.py``.
44. Training at head width 64 on phase 43's weights (``head64_training``),
    full width and depth, phase 14's batch: stage-1 (the projector alone),
    LoRA rank 16, stage-2 (every weight, lr ``HW_STAGE2_LR``; K16b / K16c
    through the ViT too), three steps each, and ``HW_PACKED_STEPS`` trunk
    steps on phase 35's 4096-row pack (K16 in its segment mode): step ms,
    tokens/s, ``mfu``, peak GiB, losses (which must fall), the leaves that
    changed, K16 launches held to the expected counts.  Then phase 13's
    checks and times at D = 64 at the shapes these runs handed K16 (the
    trunk 2 x 3328 at 14 / 2 causal, the ViT 6 x 1025 at 16 / 16, the pack;
    rows tagged ``[D=64]``) and its checks alone at D = 72 and 16 at phase
    13's shapes, each with three width faults (the scale of a 128-wide
    head, q and k read 128 columns a head, dK / dV stored at a 128-column
    stride) outside the limits; phase 16's rule at 2 + 2 layers of the
    geometry; the train CLI's default (``--synthetic 2 --warmup 0``: the
    tiny model in bf16 on the card, head widths 16).  Alone: ``python3
    chip_probes/train_head_width.py``.

Prints one JSON line of per-kernel numbers before the last line, and as the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero (printing no
result) when CUDA is unavailable, when the package is missing beside this
file, or when any phase fails.  Imports nothing of JAX or of omchat_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3

# Tolerances, bf16 on the card.  K1-K3 against their plain versions: the inputs
# plant high-scoring keys at the mask boundaries (phase 2), so outputs are O(1)
# there and a bf16 ulp is 0.0078 at |x| in [1, 2): rtol 1e-2 is about one ulp,
# atol covers the small outputs.  Each phase also checks that the plain version
# with a planted fault (a boundary column dropped or let in) falls outside.
# K12 and K14 take the limits of their contiguous siblings K3 and K2.
ATTN_TOL = {"K1": (4e-3, 1e-2), "K2": (8e-3, 1e-2), "K3": (4e-3, 1e-2),
            "K12": (4e-3, 1e-2), "K14": (8e-3, 1e-2),
            # K16 (phase 13): outputs and dQ as K2; dK/dV sum a whole GQA group's
            # rows in fp32 before one bf16 rounding, up to |13| (ulp 0.0625)
            "K16a": (8e-3, 1e-2), "K16b": (8e-3, 1e-2), "K16c": (1.6e-2, 1e-2)}  # (atol, rtol)
# phase 2, K1's prepass against its plain version: qn and kn within two bf16
# ulps (the rstd sums run in another order), as tests/test_torch_cuda_kernels.py
# holds it; a planted fault (k's gamma left out, k normalised by q's rstd) must
# fall outside.
PREPASS_TOL = (1e-6, 8e-3)  # (atol, rtol)
# phases 2, 6, 13, 17, 22, 23: a kernel's time is the median of READINGS readings of
# READING_LAUNCHES launches, the kernels of a case (and their library call) read in turns
READINGS, READING_LAUNCHES = 5, 30
# K4, K7, K8 and K15[e4m3] (phases 2, 11, 17), whose calls the host may issue slower
# than the card runs them: GRAPH_CALLS calls in one CUDA graph (``device_times``); K7
# and K8 cycle over input sets moving HBM_CYCLE_BYTES (4 x the L2) together
# (``hbm_set_count``)
GRAPH_CALLS, HBM_CYCLE_BYTES = 30, 200e6
# phase 20, K12 / K13 at page sizes 128 and 64: a decode step's 28 calls (one a layer) graphed
PAGE_SIZE_GRAPH_CALLS = 28
LSE_ATOL = 1e-3  # K16a's fp32 log-sum-exp: exp2 / log2 and sums in another order
NEW_TOKENS = 32
# phase 4, first-token logits through 2+2 layers, kernels vs the plain reference
# attention: the logits are bf16 values (ulp 0.031 at |x| in [4, 8)) and the two
# paths round softmax and q differently, so a few ulps at the largest logits.
LOGITS_ATOL, LOGITS_RTOL = 1e-1, 2e-2
# phases 5-7: the serving engine's settings (dev/bench_serving.py's, with the
# engine's default prefill chunk, which sends the image prompts through the
# chunked route) and its workload
SERVING = dict(max_slots=16, num_pages=192, page_size=128, prompt_bucket=128, max_len=4096, decode_roll=16,
               prefill_chunk=1024, prefill_batch_tokens=8192)
SERVING_REQUESTS, SERVING_NEW_TOKENS, SERVING_WORKLOAD_SEED = 16, 64, 0
# phase 20: the same workload at page size 64, the pool's rows unchanged
SERVING_PS64 = {**SERVING, "page_size": 64, "num_pages": 384}
PARITY_NEW_TOKENS, PARITY_MARGIN = 16, 0.1
DEVICE = "cuda"  # phases 5-12 place their tensors and engines here
CARD = ""  # the card's name and power limit (nvidia-smi), set by main; phases 25-26 print it on every line
# phase 11, the w8a8 kernels against their plain versions: int8 codes within one
# and at least 99% equal (fp32 sums in another order move a code next to a
# rounding boundary), x' within one bf16 ulp, row scales rtol 1e-2 (the JAX
# package's limit, tests/test_pallas_kernels.py:314).  Each planted fault must
# break one of them.
CODE_MAX_DIFF, CODE_EQUAL_SHARE, X_ULPS, SCALE_RTOL = 1, 0.99, 1.0, 1e-2
# phases 13-16, training: B=2 samples of one 448x448 image (3 tiles) and a
# 64-token answer; lr 1e-3 without warmup, clip 1.0; LoRA rank 16 on q/k/v/o
TRAIN_BATCH, TRAIN_ANSWER, TRAIN_LR, TRAIN_STEPS, LORA_STEPS, LORA_RANK = 2, 64, 1e-3, 3, 3, 16
# phase 13's packed case: one 4096-row pack of four documents and a -1 tail
PACKED_ROWS, PACKED_DOCS = 4096, ((0, 700), (700, 1900), (1900, 2600), (2600, 3900))
# phase 16, kernels ("vjp") vs the plain autograd reference at 2+2 layers: the
# bf16 model rounds every activation, and the two routes round p and dS
# (kernels) or the fp32 softmax (plain) at other places.  Sound readings on
# the H100: loss 4.3e-5 / 2.1e-5, gradients 0.012 / 0.029 of max |g|
# (projector / LoRA); faults planted in K16a/b/c read loss 2.7e-4 and up
# (forward faults; backward ones leave the loss) and gradients 0.12 and up.
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL = 1e-4, 5e-2
# Phase 17, the fp8 KV cache: K2 over an e4m3 cache rounds p to e4m3 (as the
# TPU kernel's p.astype(v.dtype)) against the running row max, its plain version
# against the row's global max; p below 2^-6 lands on e4m3's subnormal steps, so
# the two differ by a few per cent of the output (the TPU kernel and its XLA
# reference differ alike).  The other e4m3 variants keep their bf16 limits.
K2_E4M3_TOL = (5e-2, 5e-2)
# Phases 25-26, the single-request surface: a video of VIDEO_WRITTEN frames on disk,
# VIDEO_FRAMES sampled (one tile each); K2 at the video's rows checked on its last
# VIDEO_CHECK_ROWS query rows; a speculative verify step of 1 + SPEC_DRAFT rows; the
# sampled graph drawn from SAMPLE_SEED; a +100 bias on BIAS_TOKEN, +3 on
# LOGPROB_BIAS_TOKEN (neither is eos); PENALTY_TOKENS greedy tokens for the frequency
# penalty's count, JSON_TOKENS for json_mode; chunked prefill in chunks of CHUNK;
# BEAMS beams for BEAM_TOKENS tokens.
VIDEO_WRITTEN, VIDEO_FRAMES, VIDEO_CHECK_ROWS = 96, 32, 256
SPEC_DRAFT, SAMPLE_SEED, BIAS_TOKEN, LOGPROB_BIAS_TOKEN = 8, 0, 1000, 2000
PENALTY_TOKENS, JSON_TOKENS, CHUNK, BEAMS, BEAM_TOKENS = 64, 48, 1024, 4, 16
# Phase 26's beam search at 2+2 layers, kernels vs the plain route: a beam score
# sums one log-prob a step, a log-prob is a logit less the log-sum-exp, so what
# each step adds to a beam's score (its score less its parent's) is held to
# phase 4's absolute logit limit.  The first step's log-probs are the prefill's,
# whose logits phase 4 lets differ by 1e-1: an H100 run read 0.031 there, past
# 1e-2.  The order of the cache first matters to the third step's scores (the
# beams start identical), so the routes' beams must agree for BEAM_MIN_AGREE
# steps.  Planted faults (beam_faults) must fail one or the other.
BEAM_STEP_GAP, BEAM_MIN_AGREE = LOGITS_ATOL, 3
# C4, phase 26 at full depth: the verify route (9 rows past q_offset) against the
# decode (1 row) and one-shot prefill (3k rows) routes of the same tokens.  An H100
# run (NVIDIA H100 80GB HBM3, 700.00 W; chip_probes/c4_route_gaps.py) read the three
# routes 0.176-0.204 apart on attn_impl="plain" and 0.203-0.219 on the kernels, 1.23x
# the plain gap at most, at max |logit| 5.97: bf16 rounding of the 9-, 1- and 3k-row
# products over 28 layers, not a fault of K2 or K3.  So the routes are held to 1.5x
# the largest plain gap read (0.2041); the planted verify faults read 0.52
# (write_pos + 1) and 5.86 (the draft one row late) there.
C4_PLAIN_GAP = 0.2041015625
C4_LIMIT = 1.5 * C4_PLAIN_GAP

# Phase 19, first-token logits at 2+2 layers: e4m3 cache vs bf16 cache, and
# kernels vs plain on the e4m3 cache, each within this share of max |logit|.
FP8_LOGIT_GAP_REL = 0.15
# Phase 23, one decode step at full depth through cache_attend (K6) vs through
# decode_scan (K3): 28 layers of bf16 activations, and the two kernels sum the
# token's own column in another order (an H100 run read 0.125 at max |logit|
# 5.53: a few bf16 ulps of the largest logits), so a share of max |logit|.
STEP_LOGIT_REL = 5e-2
# Phase 22, the 45-layer ViT without qk-norm, packed route (K5) vs the plain
# route: bf16 rounds every activation over 45 layers and the two routes round
# q and p at other places; max |diff| within this share of max |out|.
VIT_REL_LIMIT = 5e-2
# Phase 12, w8a8 prefill through the glue kernels vs attn_impl="plain" (the
# unfused chain): the first-token logits may differ by no more than w8a8
# quantization itself moves the plain chain's from the bf16 model's, measured in
# the same phase.  (The JAX package's trunk limit, 2e-2 of max |logit|,
# tests/test_llm_glue.py:109, holds at its tiny widths and in the CPU tests;
# at full width on random weights any ±1 code moves these small logits by
# 4-6% of their max, whatever the path: 0.048 kernels vs plain, 0.049 static vs
# dynamic fc1 scales, 0.056 w8a8 vs bf16; bf16 kernels vs plain 0.009.)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(fns: dict) -> tuple:
    """``READINGS`` readings of ``READING_LAUNCHES`` launches of each callable
    of ``fns`` (``time_ms``), taken in turns: ({name: median ms}, {name: readings})."""
    got = {name: [] for name in fns}
    for _ in range(READINGS):
        for name, fn in fns.items():
            got[name].append(time_ms(fn, iters=READING_LAUNCHES))
    return {name: sorted(r)[len(r) // 2] for name, r in got.items()}, got


def graphed(fn, calls: int):
    """``calls`` calls of ``fn`` captured once into a CUDA graph (after a
    warm-up on a side stream); returns the graph's replay.  A replay runs
    those launches back to back on the card with no host work between them,
    so its time / ``calls`` is one call's device time, also where the host
    takes longer to issue a call than the card takes to run it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(calls):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph.replay


def device_times(kernel, library, calls: int) -> tuple:
    """Kernels read as device time (K3, K4, K6, K7, K8, K12 and K13, whose
    calls take the card less time than the host takes to issue them, and
    K15[e4m3]): the kernel and its library call (None: no single call
    computes it) read in turns as ``time_in_turns`` reads them, each as one
    call's device time (``calls`` calls graphed, e.g. a walk over the
    layers) and as the time of one call issued eagerly ("kernel_eager",
    "library_eager")."""
    fns = {"kernel": kernel} if library is None else {"kernel": kernel, "library": library}
    ms, readings = time_in_turns({**{name: graphed(fn, calls) for name, fn in fns.items()},
                                  **{f"{name}_eager": fn for name, fn in fns.items()}})
    for name in fns:
        ms[name] /= calls
        readings[name] = [r / calls for r in readings[name]]
    return ms, readings


def k4_floor_ms(n: int, kvh: int, d: int) -> float:
    """K4's launch floor: a kernel that does nothing, launched on the grid K4
    takes for ``n`` rows of ``kvh`` x ``d`` (``omchat_commit_rows_floor``),
    read as K4 is read (graphed device time, ``GRAPH_CALLS`` calls)."""
    import ctypes

    from omchat_torch.ops import kernel_lib

    args = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    ms, _ = device_times(lambda: kernel_lib.launch("commit_rows.cu", "omchat_commit_rows_floor", args, n, kvh, d,
                                                   kernel_lib.stream_ptr()),
                         None, GRAPH_CALLS)
    return ms["kernel"]


def cycling(call, sets: list):
    """A callable running ``call`` on the next of ``sets`` each time (see
    ``hbm_set_count``)."""
    turns = itertools.cycle(sets)
    return lambda: call(*next(turns))


def hbm_set_count(nbytes: float) -> int:
    """How many input sets a call moving ``nbytes`` cycles over so that a set
    has left the 50 MB L2 before it comes round again: each call then reads
    from HBM, as the path's calls do."""
    return max(2, math.ceil(HBM_CYCLE_BYTES / nbytes))


def eager_text(ms: dict) -> str:
    lib = f"library {ms['library_eager']:.4f}: " if "library_eager" in ms else ""
    return (f" eager_ms={ms['kernel_eager']:.4f} ({lib}a call issued from the host, "
            f"the device times above from graphed calls)")


def rate_text(flops: float, ms: float, b_ms: float, readings: list) -> str:
    """The achieved rate and share of the bound beside a kernel's readings."""
    tflops = f" tflops={flops / ms / 1e9:.1f}" if flops else ""
    return f"{tflops} share_of_bound={b_ms / ms:.3f} readings={[round(x, 5) for x in readings]}"


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_close(name, got, ref, atol, rtol) -> float:
    import torch

    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside atol={atol} rtol={rtol}; "
                             f"max_abs_err={float(err.max()):.4g}")
    return float(err.max())


def check_fault_caught(name, fault, faulty, ref, atol, rtol) -> float:
    """The plain version with a planted fault must fall outside the tolerance,
    or the tolerance would pass a kernel with that fault."""
    dev = (faulty.float() - ref.float()).abs()
    if not (dev > atol + rtol * ref.float().abs()).any():
        raise AssertionError(f"{name}: the tolerance would pass a kernel that has {fault} (max dev {float(dev.max()):.4g})")
    return float(dev.max())


def _randn(gen, *shape, scale=1.0):
    import torch

    return (torch.randn(shape, generator=gen, device=DEVICE, dtype=torch.float32) * scale).to(torch.bfloat16)


def _direction(gen, *shape):
    """±1 vectors: a query direction shared by q and the planted keys."""
    import torch

    return (torch.randint(0, 2, shape, generator=gen, device=DEVICE) * 2 - 1).to(torch.bfloat16)


def split_edge(B, KVH, T, length) -> tuple:
    """(splits, rows, edge): how K3 and K6 cut a cache of T rows on this card
    (``decode_splits``) and a chunk edge below ``length``, near its middle,
    where phases 2, 17 and 23 plant keys."""
    import torch

    from omchat_torch.ops.decode_attention import decode_splits

    splits, rows = decode_splits(B, KVH, T, torch.cuda.get_device_properties(0).multi_processor_count)
    return splits, rows, max(1, length // rows // 2) * rows


def split_text(splits, rows, B, KVH, H) -> str:
    return f" splits={splits}x{rows}rows grid=({splits},{KVH},{B})+merge({H},{B})"


def drop_rows(k, v, start, n) -> tuple:
    """k and v [..., T, D] (widened to bf16: the plain versions read the cache
    so) without rows start..start+n-1: the planted fault "one split's rows
    dropped"."""
    import torch

    return tuple(torch.cat([t[..., :start, :], t[..., start + n:, :]], dim=-2).to(torch.bfloat16) for t in (k, v))


# ---------------------------------------------------------------------------
# Phase 2: kernels at the main path's shapes
# ---------------------------------------------------------------------------


def main_path_shapes(seed: int) -> dict:
    """The attention shapes of the phase-3 request, from its own tiles and merge plan."""
    from omchat_torch.config import OmChatConfig
    from omchat_torch.models.omchat import plan_multimodal_merge, round_up_to_bucket
    from omchat_torch.runtime.generate import PROMPT_BUCKET

    cfg = OmChatConfig()
    ids, tiles = make_request(cfg, seed)
    plan = plan_multimodal_merge([ids], cfg.image_seq_len, bucket=PROMPT_BUCKET,
                                 max_length=cfg.tokenizer_model_max_length)
    valid = cfg.vision.seq_len
    kvl = int(plan.lengths[0])
    return {
        "tiles": int(tiles.shape[0]), "vit_valid": valid, "vit_sp": (valid + 7) // 8 * 8,
        "prompt_rows": int(plan.max_len), "prompt_len": kvl,
        "cache_rows": int(plan.max_len) + round_up_to_bucket(NEW_TOKENS, PROMPT_BUCKET),
        # decode step j attends over kvl + j cached rows and commits row kvl + j
        "decode_lens": [kvl + j for j in range(NEW_TOKENS - 1)],
    }


def kernel_phases(gen, shapes: dict, cfg=None, tag: str = "") -> list:
    """Phase 2: K1-K4 at the main path's shapes; with ``cfg`` (phase 33: the
    MoE trunk's heads) K2-K4 at that trunk's, their rows named with ``tag``."""
    import torch
    import torch.nn.functional as F

    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops import decode_attention as da
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    bf = torch.bfloat16
    with_k1 = cfg is None
    cfg = cfg or OmChatConfig()
    rows = []

    def randn(*shape, scale=1.0):
        return _randn(gen, *shape, scale=scale)

    def direction(*shape):
        return _direction(gen, *shape)

    if with_k1:
        # K1 — ViT packed qk-norm attention over the 3 tiles, padded rows SP, valid rows VALID.
        # q carries a per-head direction u; the keys at the last valid column (VALID-1)
        # and the first pad column (VALID) are 0.8 u + 0.6 noise, so after the qk-norm
        # each takes about a quarter of every row's softmax when it is let in.
        B, SP, VALID = shapes["tiles"], shapes["vit_sp"], shapes["vit_valid"]
        H, D = cfg.vision.num_attention_heads, cfg.vision.head_dim
        HD = H * D
        u = direction(HD)
        qkv = randn(B, SP, 3 * HD)
        qkv[..., :HD] += u
        for col in (VALID - 1, VALID):
            qkv[:, col, HD:2 * HD] = 0.8 * u + 0.6 * randn(B, HD)
        qg = (1.0 + 0.1 * randn(HD).float()).to(bf) * fa.packed_prescale(D)
        kg = (1.0 + 0.1 * randn(HD).float()).to(bf)
        eps = 1e-6
        out = fa.packed_qkv_norm_attention(qkv, num_heads=H, q_gamma=qg, k_gamma=kg, eps=eps, valid_len=VALID)
        torch.cuda.synchronize()
        rq, rk, gq32, gk32 = fa.qk_norm_stats(qkv, qg, kg, eps)

        def k1_plain(valid):
            return fa.packed_qkv_norm_attention_plain(qkv, rq, rk, gq32, gk32, num_heads=H, valid_len=valid)[:, :VALID]

        ref = k1_plain(VALID)
        err = check_close("K1 packed_qkv_norm_attention", out[:, :VALID], ref, *ATTN_TOL["K1"])
        faults = {"last valid column dropped": check_fault_caught("K1", "the last valid column dropped",
                                                                  k1_plain(VALID - 1), ref, *ATTN_TOL["K1"]),
                  "first pad column let in": check_fault_caught("K1", "the first pad column let in",
                                                                k1_plain(VALID + 1), ref, *ATTN_TOL["K1"])}
        # the prepass alone, against its plain version, and two planted faults
        want = torch.stack(fa.qk_norm_prepass_plain(qkv, qg, kg, eps))
        pre_err = check_close("K1 qk_norm_prepass", torch.stack(fa.qk_norm_prepass(qkv, qg, kg, eps)), want,
                              *PREPASS_TOL)
        kx = qkv[..., HD:2 * HD].float()
        for fault, kn_bad in (("k's gamma left out", kx * rk[..., None]),
                              ("k normalised by q's rstd", kx * rq[..., None] * gk32)):
            faults[f"prepass: {fault}"] = check_fault_caught("K1 qk_norm_prepass", fault,
                                                             torch.stack((want[0], kn_bad.to(bf))), want, *PREPASS_TOL)
        del want, kx, kn_bad
        ref_mag = float(ref.float().abs().mean())
        p_ms = time_ms(lambda: fa.packed_qkv_norm_attention_plain(qkv, rq, rk, gq32, gk32, num_heads=H,
                                                                  valid_len=VALID), iters=5, warmup=1)
        # library yardstick: SDPA over the already-normalised heads (no qk-norm)
        qn = (qkv[:, :VALID, :HD].float() * rq[:, :VALID, None] * gq32).to(bf).view(B, VALID, H, D).transpose(1, 2)
        kn = (qkv[:, :VALID, HD:2 * HD].float() * rk[:, :VALID, None] * gk32).to(bf).view(B, VALID, H, D).transpose(1, 2)
        vn = qkv[:, :VALID, 2 * HD:].reshape(B, VALID, H, D).transpose(1, 2)
        # the kernel (its prepass included), the prepass alone and SDPA, read in turns
        ms, readings = time_in_turns({
            "kernel": lambda: fa.packed_qkv_norm_attention(qkv, num_heads=H, q_gamma=qg, k_gamma=kg, eps=eps,
                                                           valid_len=VALID),
            "prepass": lambda: fa.qk_norm_prepass(qkv, qg, kg, eps),
            "library": lambda: F.scaled_dot_product_attention(qn, kn, vn)})
        flops = 4.0 * B * H * VALID * VALID * D
        nbytes = qkv.numel() * 2 + 2 * HD * 4 + B * SP * HD * 2
        rows.append(dict(name="packed_qkv_norm_attention", source="omchat_torch/csrc/packed_qkv_norm_attention.cu",
                         replaces="omchat_tpu/ops/flash_attention.py:559", max_abs_err=err, ms=ms["kernel"],
                         plain_ms=p_ms, library_ms=ms["library"], flops=flops, bytes=nbytes, ref_mean_abs=ref_mag,
                         faults=faults, readings=readings["kernel"],
                         extra=f" prepass_ms={ms['prepass']:.4f} (bound {bound_ms(0.0, 2 * B * SP * 2 * HD * 2)[0]:.4f}, "
                               f"bytes) prepass_max_abs_err={pre_err:.4g}"))
        del qkv, out, ref, qn, kn, vn

    # K2 — causal GQA prefill over the bntd cache layer: the merged prompt's S rows
    # (KVL valid) against a cache of T rows.  q carries its kv head's direction u; a
    # sink key 0.6 u at column 0 is seen by every row, and the last valid column
    # (KVL-1) holds 0.8 u, about half of row KVL-1's softmax.
    S, T, KVL = shapes["prompt_rows"], shapes["cache_rows"], shapes["prompt_len"]
    H, KVH, D = cfg.text.num_attention_heads, cfg.text.num_key_value_heads, cfg.text.attn_head_dim
    u = direction(KVH, D)
    q = randn(1, S, H, D) + u.repeat_interleave(H // KVH, dim=0)
    k = randn(1, KVH, T, D)
    v = randn(1, KVH, T, D)
    k[0, :, 0] = 0.6 * u
    k[0, :, KVL - 1] = 0.8 * u
    q_off = torch.zeros(1, dtype=torch.int32, device=dev)
    kvl = torch.full((1,), KVL, dtype=torch.int32, device=dev)
    kw = dict(causal=True, q_offset=q_off, kv_len=kvl, kv_format="bntd")
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()

    def k2_plain(q_offset, kv_len):
        return fa.flash_attention_plain(q, k, v, causal=True, q_offset=q_offset, kv_len=kv_len)[:, :KVL]

    ref = k2_plain(q_off, kvl)
    err = check_close("K2 flash_attention", out[:, :KVL], ref, *ATTN_TOL["K2"])
    faults = {"last valid column dropped": check_fault_caught("K2", "the last valid column dropped",
                                                              k2_plain(q_off, kvl - 1), ref, *ATTN_TOL["K2"]),
              "diagonal shifted by one": check_fault_caught("K2", "the causal diagonal shifted by one",
                                                            k2_plain(q_off + 1, kvl), ref, *ATTN_TOL["K2"])}
    ref_mag = float(ref.float().abs().mean())
    p_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True, q_offset=q_off, kv_len=kvl),
                   iters=3, warmup=1)
    qt = q[:, :KVL].transpose(1, 2)
    ms, readings = time_in_turns({
        "kernel": lambda: fa.flash_attention(q, k, v, **kw),
        "library": lambda: F.scaled_dot_product_attention(qt, k[:, :, :KVL], v[:, :, :KVL], is_causal=True,
                                                          enable_gqa=True)})
    cols = sum(min(i + 1, KVL) for i in range(S))  # causal columns this data needs
    flops = 4.0 * H * D * cols
    nbytes = (q.numel() + 2 * KVH * KVL * D + q.numel()) * 2
    rows.append(dict(name="flash_attention", source="omchat_torch/csrc/flash_attention.cu",
                     replaces="omchat_tpu/ops/flash_attention.py:246", max_abs_err=err, ms=ms["kernel"],
                     plain_ms=p_ms, library_ms=ms["library"], flops=flops, bytes=nbytes, ref_mean_abs=ref_mag,
                     faults=faults, readings=readings["kernel"]))
    del q, k, v, out, ref, qt

    # K3 — decode against the stacked cache [L, B=1, KVH, T, D] at the decode steps'
    # lengths.  Checked at the first step's length LEN: a sink at row 0, 0.8 u at the
    # last valid row (LEN-1), at the first row past it (LEN), at the last row of one
    # split and the first of the next (the kernel's chunk edge), and in the self column.
    L, lens = cfg.text.num_hidden_layers, shapes["decode_lens"]
    LEN = lens[0]
    splits, srows, edge = split_edge(1, KVH, T, LEN)
    kc = randn(L, 1, KVH, T, D)
    vc = randn(L, 1, KVH, T, D)
    qd = randn(1, 1, H, D) + u.repeat_interleave(H // KVH, dim=0)
    for row, w in ((0, 0.6), (edge - 1, 0.8), (edge, 0.8), (LEN - 1, 0.8), (LEN, 0.8)):
        kc[:, 0, :, row] = w * u
    kn_ = (0.8 * u)[None]
    vn_ = randn(1, KVH, D)
    clen = torch.full((1,), LEN, dtype=torch.int32, device=dev)
    out = da.flash_decode_stacked(qd, kc, vc, clen, L - 1, kn_, vn_)
    torch.cuda.synchronize()
    ref = da.flash_decode_stacked_plain(qd, kc, vc, clen, L - 1, kn_, vn_)
    err = check_close("K3 flash_decode_stacked", out, ref, *ATTN_TOL["K3"])
    faults = {
        f"cache_len{d:+d}": check_fault_caught("K3", f"cache_len{d:+d}", da.flash_decode_stacked_plain(
            qd, kc, vc, clen + d, L - 1, kn_, vn_), ref, *ATTN_TOL["K3"]) for d in (-1, 1)}
    # a self key of -8 u gets weight exp(-90): the self column dropped
    faults["self column dropped"] = check_fault_caught(
        "K3", "the self column dropped", da.flash_decode_stacked_plain(qd, kc, vc, clen, L - 1, -10 * kn_, vn_),
        ref, *ATTN_TOL["K3"])
    faults["one split's rows dropped"] = check_fault_caught(
        "K3", "one split's rows dropped", da.flash_decode_stacked_plain(
            qd, *drop_rows(kc[L - 1:], vc[L - 1:], edge, srows), clen - srows, 0, kn_, vn_), ref, *ATTN_TOL["K3"])
    ref_mag = float(ref.float().abs().mean())
    # walk the layers and the decode lengths, so every launch reads its cache from HBM, as decode does
    clens = [torch.full((1,), n, dtype=torch.int32, device=dev) for n in lens]
    it = iter(range(10**9))
    qs = qd.transpose(1, 2)

    def walk(fn):
        i = next(it)
        return fn(qd, kc, vc, clens[i % len(lens)], i % L, kn_, vn_)

    def library_decode():
        i = next(it)
        li, n = i % L, lens[i % len(lens)]
        return F.scaled_dot_product_attention(qs, kc[li][:, :, :n], vc[li][:, :, :n], enable_gqa=True)

    for _ in range(len(lens)):  # warm up over every length: the library call plans once per shape
        walk(da.flash_decode_stacked)
        library_decode()
    p_ms = time_ms(lambda: walk(da.flash_decode_stacked_plain), iters=len(lens), warmup=len(lens))
    ms, readings = device_times(lambda: walk(da.flash_decode_stacked), library_decode, L)
    mean_len = sum(lens) / len(lens)
    flops = 4.0 * H * D * (mean_len + 1)
    nbytes = (2 * KVH * (mean_len + 1) * D + 2 * H * D) * 2
    rows.append(dict(name="flash_decode_stacked", source="omchat_torch/csrc/flash_decode_stacked.cu",
                     replaces="omchat_tpu/ops/decode_attention.py:109", max_abs_err=err, ms=ms["kernel"],
                     plain_ms=p_ms, library_ms=ms["library"], flops=flops, bytes=nbytes, ref_mean_abs=ref_mag,
                     faults=faults, readings=readings["kernel"],
                     extra=split_text(splits, srows, 1, KVH, H) + eager_text(ms)))

    # K4 — commit the L new rows into the cache seen as [L*B, KVH, T, D] at the first step's row
    kf = kc.view(L, KVH, T, D)
    vf = vc.view(L, KVH, T, D)
    pages = torch.arange(L, dtype=torch.int32, device=dev)
    offs = torch.full((L,), LEN, dtype=torch.int32, device=dev)
    k_rows = randn(L, KVH, D)
    v_rows = randn(L, KVH, D)
    k_ref, v_ref = kf.clone(), vf.clone()
    pa.commit_rows(kf, vf, pages, offs, k_rows, v_rows)
    torch.cuda.synchronize()
    pa.commit_rows_plain(k_ref, v_ref, pages, offs, k_rows, v_rows)
    if not (torch.equal(kf.view(torch.int16), k_ref.view(torch.int16))
            and torch.equal(vf.view(torch.int16), v_ref.view(torch.int16))):
        raise AssertionError("K4 commit_rows: cache differs from the plain commit (bitwise, all rows)")
    p_ms = time_ms(lambda: pa.commit_rows_plain(k_ref, v_ref, pages, offs, k_rows, v_rows), iters=100)
    idx = (pages.long()[:, None], torch.arange(KVH, device=dev)[None, :], offs.long()[:, None])

    def library_commit():
        kf.index_put_(idx, k_rows)
        vf.index_put_(idx, v_rows)

    ms, readings = device_times(lambda: pa.commit_rows(kf, vf, pages, offs, k_rows, v_rows), library_commit,
                                GRAPH_CALLS)
    nbytes = 2 * (2 * L * KVH * D * 2) + 2 * L * 4
    rows.append(dict(name="commit_rows", source="omchat_torch/csrc/commit_rows.cu",
                     replaces="omchat_tpu/ops/paged_attention.py:619", max_abs_err=0.0, ms=ms["kernel"],
                     plain_ms=p_ms, library_ms=ms["library"], flops=0.0, bytes=nbytes, ref_mean_abs=None, faults={},
                     readings=readings["kernel"],
                     extra=f" launch_floor_ms={k4_floor_ms(L, KVH, D):.5f} (an empty kernel on K4's grid, graphed)"
                           + eager_text(ms)))
    del kc, vc, kf, vf, k_ref, v_ref

    for r in rows:
        r["name"] += tag
    report_rows(rows)
    torch.cuda.empty_cache()
    return rows


def report_rows(rows: list) -> None:
    """Each kernel row's bound from its operations and bytes, and its line."""
    for r in rows:
        flops = r.pop("flops")
        r["bound_ms"], r["bound_by"] = bound_ms(flops, r.pop("bytes"))
        mag = "" if r["ref_mean_abs"] is None else f" ref_mean_abs={r['ref_mean_abs']:.3g}"
        caught = "".join(f"; fault '{f}' max_dev={d:.3g} (caught)" for f, d in r["faults"].items())
        rate = rate_text(flops, r["ms"], r["bound_ms"], r.pop("readings")) if "readings" in r else ""
        log(f"kernel {r['name']}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}){rate}"
            f"{r.pop('extra', '')} max_abs_err={r['max_abs_err']:.3g}{mag}{caught}")


# ---------------------------------------------------------------------------
# Phases 3 and 4: end to end
# ---------------------------------------------------------------------------


def full_model(seed: int) -> tuple:
    """``OmChatConfig()`` at full width and depth with random bf16 weights:
    (cfg, params)."""
    import torch

    from omchat_torch.config import OmChatConfig

    cfg = OmChatConfig()  # omchat-v2.0-13B: InternViT-6B (45 layers) + Qwen2-7B (28 layers)
    t0 = time.perf_counter()
    params = build_model(cfg, seed)
    torch.cuda.synchronize()
    log(f"e2e: built full-width full-depth weights in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return cfg, params


def build_model(cfg, seed: int):
    import torch

    from omchat_torch.models import intern_vit, projector, qwen2

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    bf = torch.bfloat16
    return {
        "vision_tower": intern_vit.init_params(cfg.vision, g, bf),
        "projector": projector.init_params(cfg.projector, cfg.vision.hidden_size, cfg.text.hidden_size, g, bf),
        "language_model": qwen2.init_params(cfg.text, g, bf),
    }


REQUEST_QUESTION = "What is shown in this picture? Describe it."


def request_image(seed: int):
    """Phase 3's image: 448x448 seeded noise."""
    import numpy as np
    from PIL import Image

    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (448, 448, 3), dtype=np.uint8))


def make_request(cfg, seed: int):
    from omchat_torch.processing.chat import image_prompt, make_context
    from omchat_torch.processing.image_processor import process_anyres_image
    from omchat_torch.utils.testing import MockTokenizer

    tiles = process_anyres_image(request_image(seed), cfg.image_grid_pinpoints, cfg.vision.image_size)
    _, ids = make_context(MockTokenizer(), image_prompt(REQUEST_QUESTION, len(tiles)), None,
                          "You are a helpful assistant.")
    return ids, tiles


def counters():
    from omchat_torch.ops import decode_attention as da
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import paged_attention as pa

    return {
        "packed_qkv_norm_attention": fa.packed_qkv_norm_attention,
        "qk_norm_prepass": fa.qk_norm_prepass,  # K1's first step, launched by its wrapper
        "flash_attention": fa.flash_attention,
        "flash_decode_stacked": da.flash_decode_stacked,
        "commit_rows": pa.commit_rows,
    }


def end_to_end(seed: int, model: tuple, new_tokens: int = NEW_TOKENS, counted=None, label: str = "e2e",
               cache_dtype=None) -> dict:
    """Phase 3 on ``model`` = (cfg, params) (bf16) or, with the kernels that
    must launch in ``counted``, phase 9 (w8a8), phase 18 (``cache_dtype``
    e4m3: the fp8 KV cache) and phase 21 (the calibrated w8a8 MLP)."""
    import torch

    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.generate import OmChatEngine

    cfg, params = model
    counted = counted or counters()
    ids, tiles = make_request(cfg, seed)
    # no image cache: the timed run encodes its image again
    engine = OmChatEngine(cfg, params, image_cache_size=0, cache_dtype=cache_dtype)
    gen = GenerationConfig(max_new_tokens=new_tokens, eos_token_id=-1)  # no early stop on random weights

    bad = []

    def finite(step, logits):
        if logits.shape != (1, cfg.text.vocab_size) or not torch.isfinite(logits).all():
            bad.append(step)

    # warm-up (cuBLAS / allocator first calls), and the logits check: kept out of the timed run
    warm = engine.generate([ids], tiles, gen, logits_callback=finite)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    for c in counted.values():
        c.launches = 0
    out = engine.generate([ids], tiles, gen)
    launches = {name: c.launches for name, c in counted.items()}
    sp = engine.spans
    res = {
        "tiles": int(tiles.shape[0]),
        "merged_len": int(out.prompt_len[0]),
        "cache_len": sp["cache_len"],
        "new_tokens": len(out.token_ids[0]),
        "vit_ms": sp["encode_images"] * 1e3,
        "vit_images_per_s": tiles.shape[0] / sp["encode_images"],
        "prefill_ms": sp["prefill"] * 1e3,
        "ttft_ms": sp["ttft"] * 1e3,
        "decode_tokens_per_s": sp["decode_steps"] / sp["decode"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "resident_before_gib": resident,
        "launches": launches,
    }
    log(f"{label}: " + json.dumps(res))
    if bad:
        raise AssertionError(f"{label}: non-finite or mis-shaped logits at steps {bad}")
    if out.token_ids != warm.token_ids:
        raise AssertionError(f"{label}: the timed run's tokens differ from the checked warm-up run's")
    if len(out.token_ids[0]) != new_tokens:
        raise AssertionError(f"{label}: generated {len(out.token_ids[0])} tokens, expected {new_tokens}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the main path: {missing}")
    del engine, params
    torch.cuda.empty_cache()
    return res


def kernel_vs_plain(seed: int) -> dict:
    import torch

    from omchat_torch.config import OmChatConfig
    from omchat_torch.runtime.generate import OmChatEngine

    full = OmChatConfig()
    cfg = dataclasses.replace(
        full,
        vision=dataclasses.replace(full.vision, num_hidden_layers=2),
        text=dataclasses.replace(full.text, num_hidden_layers=2),
    )
    params = build_model(cfg, seed)
    ids, tiles = make_request(cfg, seed)
    logits = {}
    for impl in (None, "plain"):
        eng = OmChatEngine(cfg, params, attn_impl=impl, image_cache_size=0)
        feats = eng.encode_images(tiles)
        plan = eng.plan([ids])
        logits[impl], _ = eng.prefill(plan, feats, 32)
    torch.cuda.synchronize()
    got, ref = logits[None], logits["plain"]
    diff = float((got - ref).abs().max())
    res = {"logits_max_abs_diff": diff, "logits_max_abs": float(ref.abs().max()),
           "argmax_equal": bool(torch.equal(got.argmax(-1), ref.argmax(-1)))}
    log("kernel-vs-plain (2 ViT + 2 LLM layers, full width): " + json.dumps(res))
    check_close("kernel-vs-plain logits", got, ref, LOGITS_ATOL, LOGITS_RTOL)
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phases 5-7: the paged serving engine
# ---------------------------------------------------------------------------


def serving_workload(cfg) -> list:
    """``dev/bench_serving.py:27-47``'s mixed workload rebuilt from the same
    seed: SERVING_REQUESTS text prompts of 64-512 tokens, two image sentinels
    and a 2-tile image (standard_normal pixels) on every 4th.  [(ids, tiles)]."""
    import numpy as np

    from omchat_torch.constants import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(SERVING_WORKLOAD_SEED)
    lengths = [int(rng.integers(64, 513)) for _ in range(SERVING_REQUESTS)]
    work = []
    for i, n in enumerate(lengths):
        ids = [151644] + [int(t) for t in rng.integers(2000, 20000, n - 1)]
        tiles = None
        if i % 4 == 0:
            ids = ids[:2] + [IMAGE_TOKEN_INDEX, IMAGE_TOKEN_INDEX] + ids[2:]
            size = cfg.vision.image_size
            tiles = rng.standard_normal((2, 3, size, size)).astype(np.float32)
        work.append((ids, tiles))
    return work


def gather_k2_attention(q, k_pages, v_pages, kv_len, page_tables, q_offset, *, impl=None):
    """The chunk attention K14 replaced on the engine's path (the JAX
    engine's default route): the page-mapped K/V gathered contiguous, then
    K2.  Phases 5 and 6 time it beside K14."""
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import paged_attention as pa

    k, v = pa._gather_pages(k_pages, v_pages, page_tables)
    return fa.flash_attention(q, k, v, causal=True, q_offset=q_offset, kv_len=kv_len, kv_format="bntd")


def record_dispatches(eng) -> tuple:
    """Wrap the serving engine's dispatch points so that a run records what
    each paged kernel is handed — the decode rolls' lengths and sliced tables
    (K12), the chunk dispatches' starts, lengths and tables (K14), the page
    commits' scratch shapes, tables and page counts (K15), the contiguous
    prefills' plans (K2) — and CUDA events around the ViT dispatch, the
    short prefills, the chunk dispatches and the decode rolls.  Each entry
    carries ``rec["label"]`` at its time.  Returns the record and a function
    that restores the module's functions."""
    import numpy as np
    import torch

    from omchat_torch.runtime import paged_engine as pe

    rec = {"label": None, "rolls": [], "chunks": [], "commits": [], "prefills": [], "spans": []}
    saved = {n: getattr(pe, n) for n in ("_paged_prefill_chunk", "_commit_pages", "paged_prefill_attention")}

    def spanned(kind, fn, extra=lambda *a, **kw: None):
        def wrapped(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            rec["spans"].append(dict(label=rec["label"], kind=kind, start=start, end=end, extra=extra(*a, **kw)))
            return out
        return wrapped

    def on_roll(decoding, roll, active, tables, *a, **kw):
        rec["rolls"].append(dict(label=rec["label"], n=len(decoding), tables=np.array(tables),
                                 lengths=np.where(active, eng._lengths, 0).astype(np.int32)))
        return len(decoding), roll

    def chunk(params, cfg, token_ids, is_image, image_index, feats, positions, start, clen, tables, *rest):
        rec["chunks"].append(dict(label=rec["label"], shape=tuple(token_ids.shape), start=np.array(start),
                                  len=np.array(clen), tables=np.array(tables)))
        return saved["_paged_prefill_chunk"](params, cfg, token_ids, is_image, image_index, feats, positions, start,
                                             clen, tables, *rest)

    def commit(slot_k, slot_v, k_pool, v_pool, tables, n_pages, *a):
        rec["commits"].append(dict(label=rec["label"], shape=tuple(slot_k.shape), tables=np.array(tables),
                                   n_pages=np.array(n_pages)))
        return saved["_commit_pages"](slot_k, slot_v, k_pool, v_pool, tables, n_pages, *a)

    prefill = eng._prefiller.prefill

    def on_prefill(plan, feats, new_tokens):
        rec["prefills"].append(dict(label=rec["label"], lengths=[int(n) for n in plan.lengths],
                                    rows=int(plan.max_len)))
        return prefill(plan, feats, new_tokens)

    pe._paged_prefill_chunk, pe._commit_pages = chunk, commit
    eng._prefiller.prefill = on_prefill
    eng._encode_pending = spanned("vit", eng._encode_pending)
    eng._prefill_shorts = spanned("shorts", eng._prefill_shorts)
    eng._run_chunk = spanned("chunk", eng._run_chunk)
    eng._dispatch_roll = spanned("roll", eng._dispatch_roll, on_roll)

    def undo():
        for n, f in saved.items():
            setattr(pe, n, f)

    return rec, undo


def span_ms(rec, label, kind) -> list:
    """Elapsed ms of the recorded spans (call after a synchronize)."""
    return [s["start"].elapsed_time(s["end"]) for s in rec["spans"] if s["label"] == label and s["kind"] == kind]


def paged_counters():
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import paged_attention as pa

    return {
        "packed_qkv_norm_attention": fa.packed_qkv_norm_attention,
        "qk_norm_prepass": fa.qk_norm_prepass,  # K1's first step, launched by its wrapper
        "flash_attention": fa.flash_attention,
        "commit_rows": pa.commit_rows,
        "paged_flash_decode": pa.paged_flash_decode,
        "paged_flash_prefill": pa.paged_flash_prefill,
        "commit_pages": pa.commit_pages,
    }


def capture_first_logits(engine) -> dict:
    """Record, per request id, the fp32 logits the engine picks each
    request's first token from (every prefill route ends in
    ``_finish_with_token``)."""
    store = {}
    finish = engine._finish_with_token

    def wrapped(req, first, logits_row=None):
        store[req.request_id] = logits_row.float()
        finish(req, first, logits_row)

    engine._finish_with_token = wrapped
    return store


def drive(engine, work, new_tokens: int) -> list:
    rids = [engine.submit(ids, tiles, max_new_tokens=new_tokens, eos_token_id=-1) for ids, tiles in work]
    engine.run_to_completion()
    return rids


def timed_serving(eng, work, rec, counts: dict, label: str) -> dict:
    """A warm-up at 4 new tokens, then the timed run of ``work`` at
    SERVING_NEW_TOKENS with the kernels in ``counts`` counted: tokens/s,
    latency percentiles, decode-step and dispatch wall times.  Every request
    must return all its tokens, every page come back and every counted
    kernel launch."""
    import torch

    rec["label"] = "warm-up"
    drive(eng, work, 4)  # cuBLAS plans, the allocator, the kernels' first launches
    eng.reset_latency_stats()
    for c in counts.values():
        c.launches = 0
    rec["label"] = "timed"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = drive(eng, work, SERVING_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counts.items()}
    done = [eng.pop_result(r) for r in rids]  # (tokens, prompt length)
    rolls = [(s["extra"][0], s["start"].elapsed_time(s["end"]) / s["extra"][1])
             for s in rec["spans"] if s["label"] == "timed" and s["kind"] == "roll"]
    full = [ms for n, ms in rolls if n == SERVING["max_slots"]]
    res = {
        "requests": len(work), "images": sum(t is not None for _, t in work),
        "prompt_tokens": sum(p for _, p in done), "generated_tokens": sum(len(t) for t, _ in done),
        "wall_s": wall, "tokens_per_s": sum(len(t) for t, _ in done) / wall, **eng.latency_stats(),
        # CUDA events around each host-dispatched roll / step count: the
        # card's timeline, host launch gaps included
        "decode_step_wall_ms_16_slots": sum(full) / len(full) if full else None, "rolls_at_16_slots": len(full),
        "decode_step_wall_ms_all_rolls": [round(ms, 3) for _, ms in rolls],
        "span_ms": {k: sum(span_ms(rec, "timed", k)) for k in ("vit", "shorts", "chunk", "roll")},
        "chunk_dispatches": len(span_ms(rec, "timed", "chunk")),
        "pages_free": eng.allocator.available, "launches": launches,
    }
    log(f"{label}: " + json.dumps(res))
    res["tokens"] = [t for t, _ in done]
    short = [i for i, (t, _) in enumerate(done) if len(t) != SERVING_NEW_TOKENS]
    if short:
        raise AssertionError(f"{label}: requests {short} did not return {SERVING_NEW_TOKENS} tokens")
    if eng.allocator.available != eng.allocator.num_pages:
        raise AssertionError(f"{label}: {eng.allocator.num_pages - eng.allocator.available} pages never came back")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the serving path: {missing}")
    return res


def serving(seed: int) -> tuple:
    """Phase 5: the paged engine at full width and depth on the mixed
    workload, recording what each paged kernel is handed; then the image
    prompts again, first tokens only, alternately on the engine's K14 route
    and on gather + K2, to time a chunk dispatch on each and compare their
    first-token logits.  Returns (results, the timed run's record)."""
    import torch

    from omchat_torch.config import OmChatConfig
    from omchat_torch.runtime import paged_engine as pe

    cfg = OmChatConfig()
    params = build_model(cfg, seed)
    work = serving_workload(cfg)
    # no image cache: the timed run encodes its images again, as the warm-up did
    eng = pe.PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, **SERVING)
    first = capture_first_logits(eng)
    rec, undo = record_dispatches(eng)
    try:
        res = timed_serving(eng, work, rec, paged_counters(), "serving")

        # The two chunk-attention routes differ only there, so the image
        # prompts' first-token logits carry the whole difference.
        images = [w for w in work if w[1] is not None]
        routes = {"k14": pe.paged_prefill_attention, "gather_k2": gather_k2_attention}
        reruns = []
        for route in ("k14", "gather_k2", "gather_k2", "k14"):
            pe.paged_prefill_attention = routes[route]
            rec["label"] = f"{route}-{len(reruns)}"
            reruns.append((route, rec["label"], drive(eng, images, 1)))
    finally:
        undo()
    torch.cuda.synchronize()
    chunk_ms = {r: [sum(span_ms(rec, label, "chunk")) for rr, label, _ in reruns if rr == r] for r in routes}
    n_chunks = {len(span_ms(rec, label, "chunk")) for _, label, _ in reruns}
    (_, _, k14_rids), (_, _, gk_rids) = reruns[0], reruns[1]
    diffs = [check_close(f"K14 vs gather + K2 first-token logits (image request {i})", first[a], first[b],
                         LOGITS_ATOL, LOGITS_RTOL) for i, (a, b) in enumerate(zip(k14_rids, gk_rids))]
    res["routes"] = {"chunk_dispatches_per_rerun": sorted(n_chunks), "chunk_ms_per_rerun": chunk_ms,
                     "first_token_logits_max_abs_diff": max(diffs)}
    log("serving, chunk-attention routes on the image prompts: " + json.dumps(res["routes"]))
    if len(n_chunks) != 1:
        raise AssertionError(f"serving: the reruns made different chunk dispatch counts {n_chunks}")
    del eng, params
    torch.cuda.empty_cache()
    timed = {k: [e for e in rec[k] if e["label"] == "timed"] for k in ("rolls", "chunks", "commits", "prefills")}
    log("serving dispatches (timed run): rolls (slots decoding, table width) "
        f"{[(r['n'], r['tables'].shape[1]) for r in timed['rolls']]}; chunks (B, C, start, len) "
        f"{[(*c['shape'], c['start'].tolist(), c['len'].tolist()) for c in timed['chunks']]}; commits "
        f"{[c['shape'][:2] + (c['shape'][3],) for c in timed['commits']]}; contiguous prefills (lengths, rows) "
        f"{[(p['lengths'], p['rows']) for p in timed['prefills']]}")
    return res, timed


def paged_kernel_phases(gen, timed: dict, tc=None, tag: str = "") -> list:
    """Phase 6: K12, K14 and K15 (and K2 at the batched-prefill shape,
    printed only) at what the timed serving run handed them, against their
    plain versions; returns their rows.  Keys are planted at the length and
    causal boundaries as in phase 2, and each check shows that a faulted
    plain version falls outside it.  With ``tc`` (phase 33: the MoE trunk's
    text config) at that trunk's heads, the rows named with ``tag``."""

    import numpy as np
    import torch
    import torch.nn.functional as F

    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import paged_attention as pa
    from omchat_torch.runtime.paged_engine import commit_page_ids

    dev = torch.device(DEVICE)
    i32 = dict(dtype=torch.int32, device=dev)
    tc = tc or OmChatConfig().text
    L, H, KVH, D = tc.num_hidden_layers, tc.num_attention_heads, tc.num_key_value_heads, tc.attn_head_dim
    G = H // KVH
    PS, P = SERVING["page_size"], SERVING["num_pages"]
    NP = P + 1  # pages per layer, the parking page last
    LI = L - 1  # the layer checked; timing walks all of them, as the engine does
    rows = []
    # the layered pool [L, P+1, KVH, PS, D], seen flat by K12 and K15 and per layer by K14
    pool_k, pool_v = _randn(gen, L, NP, KVH, PS, D), _randn(gen, L, NP, KVH, PS, D)
    kflat, vflat = pool_k.view(L * NP, KVH, PS, D), pool_v.view(L * NP, KVH, PS, D)
    u = _direction(gen, KVH, D)
    uq = u.repeat_interleave(G, dim=0)
    it = itertools.count()

    def plant(table_row, layer, pos, scale):
        kflat[layer * NP + int(table_row[pos // PS]), :, pos % PS] = scale * u

    # K12 — the middle one of the decode rolls with the most slots decoding:
    # its lengths (0 for idle slots) and its sliced table.  A sink at column
    # 0, 0.8 u at the last valid column, at the first one past it and in the
    # self column.
    busiest = max(r["n"] for r in timed["rolls"])
    full = [r for r in timed["rolls"] if r["n"] == busiest]
    roll = full[len(full) // 2]
    tab_np, lens_np = roll["tables"], roll["lengths"]
    S, W = tab_np.shape
    for b, n in enumerate(lens_np):
        if n:
            for pos, scale in ((0, 0.6), (n - 1, 0.8), (n, 0.8)):
                plant(tab_np[b], LI, pos, scale)
    tab = torch.as_tensor(tab_np, device=dev)
    lens = torch.as_tensor(lens_np, device=dev)
    q = _randn(gen, S, 1, H, D) + uq
    kn = (0.8 * u)[None].expand(S, KVH, D).contiguous()
    vn = _randn(gen, S, KVH, D)
    out = pa.paged_flash_decode(q, kflat, vflat, lens, tab, kn, vn, page_offset=LI * NP)
    torch.cuda.synchronize()

    def k12_plain(lengths, k_new):
        return pa.paged_flash_decode_plain(q, kflat, vflat, lengths, tab, k_new, vn, page_offset=LI * NP)

    ref = k12_plain(lens, kn)
    err = check_close("K12 paged_flash_decode", out, ref, *ATTN_TOL["K12"])
    live = lens > 0
    faults = {f"lengths{d:+d}": check_fault_caught("K12", f"lengths{d:+d}", k12_plain(lens + d * live, kn), ref,
                                                   *ATTN_TOL["K12"]) for d in (-1, 1)}
    faults["self column dropped"] = check_fault_caught("K12", "the self column dropped", k12_plain(lens, -10 * kn),
                                                       ref, *ATTN_TOL["K12"])
    ref_mag = float(ref.float().abs().mean())

    def walk(fn):
        return fn(q, kflat, vflat, lens, tab, kn, vn, page_offset=(next(it) % L) * NP)

    p_ms = time_ms(lambda: walk(pa.paged_flash_decode_plain), iters=L // 4, warmup=1)
    qs = q.transpose(1, 2)
    cols = torch.arange(W * PS + 1, device=dev)
    mask = ((cols[None] < lens[:, None]) | (cols[None] == W * PS))[:, None, None, :]

    def k12_library():  # the pages gathered by index_select, the self column appended, SDPA
        idx = (tab.long() + (next(it) % L) * NP).reshape(-1)
        kv = [torch.cat([p.index_select(0, idx).view(S, W, KVH, PS, D).transpose(1, 2).reshape(S, KVH, W * PS, D),
                         n[:, :, None]], dim=2) for p, n in ((kflat, kn), (vflat, vn))]
        return F.scaled_dot_product_attention(qs, *kv, attn_mask=mask, enable_gqa=True)

    # a call takes the card less time than the host takes to issue it: graphed walks over the layers
    dms, drd = device_times(lambda: walk(pa.paged_flash_decode), k12_library, L)
    cached = int(lens_np.sum())
    rows.append(dict(name="paged_flash_decode", source="omchat_torch/csrc/paged_flash_decode.cu",
                     replaces="omchat_tpu/ops/paged_attention.py:110", max_abs_err=err, ms=dms["kernel"],
                     plain_ms=p_ms, library_ms=dms["library"], readings=drd["kernel"], eager=eager_text(dms),
                     flops=4.0 * H * D * (cached + S),
                     bytes=2 * KVH * cached * D * 2 + 2 * S * H * D * 2 + 2 * S * KVH * D * 2 + S * 4 + S * W * 4,
                     ref_mean_abs=ref_mag, faults=faults, shape=f"S={S} decoding={busiest} cached={cached} W={W}"))
    del out, ref, qs, mask

    # K14 — the timed run's chunk dispatch with the most causal columns: its
    # rows' page-aligned starts, chunk lengths and full-width tables.  A sink
    # at column 0 and 0.8 u at each row's last valid column.
    def causal_cols(c):
        return sum(int(n) * int(s) + int(n) * (int(n) + 1) // 2 for s, n in zip(c["start"], c["len"]))

    c14 = max(timed["chunks"], key=causal_cols)
    (B, C), starts, clen, t14_np = c14["shape"], c14["start"], c14["len"], c14["tables"]
    kv14 = starts + clen
    for b in range(B):
        for pos, scale in ((0, 0.6), (int(kv14[b]) - 1, 0.8)):
            plant(t14_np[b], LI, pos, scale)
    t14 = torch.as_tensor(t14_np, device=dev)
    q14 = _randn(gen, B, C, H, D) + uq
    qo, kl = torch.as_tensor(starts, **i32), torch.as_tensor(kv14, **i32)
    out = pa.paged_flash_prefill(q14, pool_k[LI], pool_v[LI], kl, t14, qo)
    torch.cuda.synchronize()
    rowmask = (torch.arange(C, device=dev)[None] < torch.as_tensor(clen, device=dev)[:, None])[..., None, None]

    def k14_plain(q_offset, kv_len):  # rows past a row's chunk length are padding
        return pa.paged_flash_prefill_plain(q14, pool_k[LI], pool_v[LI], kv_len, t14, q_offset) * rowmask

    ref = k14_plain(qo, kl)
    err = check_close("K14 paged_flash_prefill", out * rowmask, ref, *ATTN_TOL["K14"])
    faults = {"last valid column dropped": check_fault_caught("K14", "the last valid column dropped",
                                                              k14_plain(qo, kl - 1), ref, *ATTN_TOL["K14"]),
              "diagonal shifted by one": check_fault_caught("K14", "the causal diagonal shifted by one",
                                                            k14_plain(qo + 1, kl), ref, *ATTN_TOL["K14"])}
    ref_mag = float(ref.float().abs().mean())

    def walk14(fn):
        li = next(it) % L
        return fn(q14, pool_k[li], pool_v[li], kl, t14, qo)

    k_ms = time_ms(lambda: walk14(pa.paged_flash_prefill), iters=L, warmup=3)
    p_ms = time_ms(lambda: walk14(pa.paged_flash_prefill_plain), iters=3, warmup=1)
    gk_ms = time_ms(lambda: walk14(gather_k2_attention), iters=L, warmup=3)
    T14 = t14_np.shape[1] * PS
    idx14 = t14.long().reshape(-1)
    ar = torch.arange(T14, device=dev)
    mask14 = ((ar[None, None] <= qo[:, None, None] + torch.arange(C, device=dev)[None, :, None])
              & (ar[None, None] < kl[:, None, None]))[:, None]
    q14t = q14.transpose(1, 2)

    def k14_library():  # the pages gathered, SDPA with an explicit offset-causal mask
        li = next(it) % L
        kv = [p[li].index_select(0, idx14).view(B, -1, KVH, PS, D).transpose(1, 2).reshape(B, KVH, T14, D)
              for p in (pool_k, pool_v)]
        return F.scaled_dot_product_attention(q14t, *kv, attn_mask=mask14, enable_gqa=True)

    lib_ms = time_ms(k14_library, iters=L, warmup=3)
    rows.append(dict(name="paged_flash_prefill", source="omchat_torch/csrc/paged_flash_prefill.cu",
                     replaces="omchat_tpu/ops/paged_attention.py:442", max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                     library_ms=lib_ms, flops=4.0 * H * D * causal_cols(c14),
                     bytes=2 * B * C * H * D * 2 + 2 * KVH * int(kv14.sum()) * D * 2 + t14_np.size * 4 + 8 * B,
                     ref_mean_abs=ref_mag, faults=faults, gather_k2_ms=gk_ms,
                     shape=f"B={B} C={C} q_offset={starts.tolist()} kv_len={kv14.tolist()}"))
    del out, ref, q14, q14t, mask14, rowmask

    # K15 — the timed run's largest page commit: the scratch cache
    # [L, B, KVH, T, D] into its requests' pages, chunks past a prompt and
    # replica pad rows onto the parking page (the engine's own page ids).
    c15 = max(timed["commits"], key=lambda c: c["shape"][1] * c["shape"][3])
    _, B, _, T, _ = c15["shape"]
    CH = T // PS
    pages15 = torch.as_tensor(commit_page_ids(c15["tables"], c15["n_pages"], L, CH, NP), device=dev)
    scratch_k, scratch_v = _randn(gen, L, B, KVH, T, D), _randn(gen, L, B, KVH, T, D)
    view_k = scratch_k.view(L * B, KVH, CH, PS, D).transpose(1, 2)
    view_v = scratch_v.view(L * B, KVH, CH, PS, D).transpose(1, 2)
    ref_k, ref_v = kflat.clone(), vflat.clone()
    pa.commit_pages(kflat, vflat, pages15, view_k, view_v)
    torch.cuda.synchronize()
    pa.commit_pages_plain(ref_k, ref_v, pages15, view_k, view_v)
    # the parking pages take duplicate writes in no defined order: each of their
    # 16-byte vectors must come from one of the chunks sent there
    for got, want, chunks in ((kflat, ref_k, view_k), (vflat, ref_v, view_v)):
        flat_chunks = chunks.reshape(-1, KVH * PS * D // 8, 8)
        for li in range(L):
            park = li * NP + P
            sent = (pages15 == park).nonzero()[:, 0]
            if len(sent) and not bool((got[park].reshape(1, -1, 8) == flat_chunks[sent]).all(-1).any(0).all()):
                raise AssertionError(f"K15 commit_pages: parking page {park} holds a vector no chunk sent there")
            want[park] = got[park]
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError("K15 commit_pages: the pool differs from the plain commit (bitwise, all pages)")
    k_ms = time_ms(lambda: pa.commit_pages(kflat, vflat, pages15, view_k, view_v), iters=20)
    p_ms = time_ms(lambda: pa.commit_pages_plain(ref_k, ref_v, pages15, view_k, view_v), iters=20)
    src_k, src_v = view_k.reshape(-1, KVH, PS, D), view_v.reshape(-1, KVH, PS, D)
    idx15 = pages15.long()

    def k15_library():
        kflat.index_copy_(0, idx15, src_k)
        vflat.index_copy_(0, idx15, src_v)

    lib_ms = time_ms(k15_library, iters=20)
    M = int(pages15.numel())
    rows.append(dict(name="commit_pages", source="omchat_torch/csrc/commit_pages.cu",
                     replaces="omchat_tpu/ops/paged_attention.py:695", max_abs_err=0.0, ms=k_ms, plain_ms=p_ms,
                     library_ms=lib_ms, flops=0.0, bytes=4 * M * KVH * PS * D * 2 + M * 4, ref_mean_abs=None,
                     faults={}, shape=f"M={M} (L={L} x B={B} x {CH} pages)"))
    del ref_k, ref_v, scratch_k, scratch_v, view_k, view_v, src_k, src_v, pool_k, pool_v, kflat, vflat

    # K2 at the timed run's largest batched contiguous prefill: its plan's
    # rows and lengths (pad rows replicate the first prompt), bntd scratch
    # cache; a sink at column 0 and 0.8 u at each row's last valid column.
    p2 = max((p for p in timed["prefills"] if len(p["lengths"]) > 1), key=lambda p: len(p["lengths"]) * p["rows"])
    kvl2, width = p2["lengths"], p2["rows"]
    B = len(kvl2)
    q2 = _randn(gen, B, width, H, D) + uq
    k2, v2 = _randn(gen, B, KVH, width, D), _randn(gen, B, KVH, width, D)
    for b, n in enumerate(kvl2):
        k2[b, :, 0] = 0.6 * u
        k2[b, :, n - 1] = 0.8 * u
    q0, kl2 = torch.zeros(B, **i32), torch.as_tensor(kvl2, **i32)
    out = fa.flash_attention(q2, k2, v2, causal=True, q_offset=q0, kv_len=kl2, kv_format="bntd")
    torch.cuda.synchronize()
    valid = (torch.arange(width, device=dev)[None] < kl2[:, None])[..., None, None]

    def k2_plain(q_offset, kv_len):
        return fa.flash_attention_plain(q2, k2, v2, causal=True, q_offset=q_offset, kv_len=kv_len) * valid

    ref = k2_plain(q0, kl2)
    err = check_close("K2 flash_attention (batched prefill)", out * valid, ref, *ATTN_TOL["K2"])
    faults = {"last valid column dropped": check_fault_caught("K2 batched", "the last valid column dropped",
                                                              k2_plain(q0, kl2 - 1), ref, *ATTN_TOL["K2"]),
              "diagonal shifted by one": check_fault_caught("K2 batched", "the causal diagonal shifted by one",
                                                            k2_plain(q0 + 1, kl2), ref, *ATTN_TOL["K2"])}
    ref_mag = float(ref.float().abs().mean())
    p_ms = time_ms(lambda: fa.flash_attention_plain(q2, k2, v2, causal=True, q_offset=q0, kv_len=kl2),
                   iters=3, warmup=1)
    ar = torch.arange(width, device=dev)
    mask2 = ((ar[None, :] <= ar[:, None])[None] & (ar[None, None, :] < kl2[:, None, None]))[:, None]
    q2t = q2.transpose(1, 2)
    ms, readings = time_in_turns({
        "kernel": lambda: fa.flash_attention(q2, k2, v2, causal=True, q_offset=q0, kv_len=kl2, kv_format="bntd"),
        "library": lambda: F.scaled_dot_product_attention(q2t, k2, v2, attn_mask=mask2, enable_gqa=True)})
    cols2 = sum(n * (n + 1) // 2 for n in kvl2)  # the causal columns of the valid rows
    k2_batched = dict(name="flash_attention", source="omchat_torch/csrc/flash_attention.cu",
                      replaces="omchat_tpu/ops/flash_attention.py:246", max_abs_err=err, ms=ms["kernel"],
                      plain_ms=p_ms, library_ms=ms["library"], flops=4.0 * H * D * cols2,
                      bytes=(2 * q2.numel() + 2 * KVH * sum(kvl2) * D) * 2 + 8 * B, ref_mean_abs=ref_mag,
                      faults=faults, shape=f"B={B} width={width} kv_len={kvl2}", readings=readings["kernel"])
    del q2, k2, v2, q2t, mask2, out, ref

    for r in rows + [k2_batched]:
        r["name"] += tag
        flops = r.pop("flops")
        r["bound_ms"], r["bound_by"] = bound_ms(flops, r.pop("bytes"))
        mag = "" if r["ref_mean_abs"] is None else f" ref_mean_abs={r['ref_mean_abs']:.3g}"
        caught = "".join(f"; fault '{f}' max_dev={d:.3g} (caught)" for f, d in r["faults"].items())
        gk = f" gather_k2_ms={r['gather_k2_ms']:.4f}" if "gather_k2_ms" in r else ""
        rate = rate_text(flops, r["ms"], r["bound_ms"], r.pop("readings")) if "readings" in r else ""
        rate += r.pop("eager", "")
        log(f"kernel {r['name']} [{r['shape']}]: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f}{gk} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}){rate} "
            f"max_abs_err={r['max_abs_err']:.3g}{mag}{caught}")
    torch.cuda.empty_cache()
    return rows


def paged_parity(seed: int) -> dict:
    """Phase 7: the first 4 workload requests (1 image, 3 text) through the
    paged engine and, one at a time, the single-request engine, both on
    kernels, at full width and 2 ViT + 2 LLM layers."""
    import torch

    from omchat_torch.config import GenerationConfig, OmChatConfig
    from omchat_torch.runtime.generate import OmChatEngine
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    full = OmChatConfig()
    cfg = dataclasses.replace(full, vision=dataclasses.replace(full.vision, num_hidden_layers=2),
                              text=dataclasses.replace(full.text, num_hidden_layers=2))
    params = build_model(cfg, seed)
    work = serving_workload(cfg)[:4]
    eng = PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, **SERVING)
    first = capture_first_logits(eng)
    rids = drive(eng, work, PARITY_NEW_TOKENS)
    ref = OmChatEngine(cfg, params, image_cache_size=0, device=DEVICE)
    gen = GenerationConfig(max_new_tokens=PARITY_NEW_TOKENS, eos_token_id=-1)
    out = []
    for i, ((ids, tiles), rid) in enumerate(zip(work, rids)):
        steps = []
        want = ref.generate([ids], tiles, gen, logits_callback=lambda s, lg: steps.append(lg[0].float())).token_ids[0]
        diff = check_close(f"paged vs single-request first-token logits (request {i})", first[rid][0], steps[0],
                           LOGITS_ATOL, LOGITS_RTOL)
        margins = [float(t[0] - t[1]) for t in (torch.topk(lg, 2).values for lg in steps)]
        upto = next((j for j, m in enumerate(margins) if m < PARITY_MARGIN), len(margins))
        got = eng.result(rid)
        if got[:upto] != want[:upto]:
            raise AssertionError(f"paged parity, request {i}: tokens {got[:upto]} != {want[:upto]} "
                                 f"(compared up to step {upto}, the first top-2 margin under {PARITY_MARGIN})")
        out.append({"image": tiles is not None, "logits_max_abs_diff": diff, "tokens_compared": upto,
                    "tokens_equal_beyond": got == want})
    log("paged vs single-request (2 ViT + 2 LLM layers, full width): " + json.dumps(out))
    del eng, ref, params
    torch.cuda.empty_cache()
    return {"requests": out}


# ---------------------------------------------------------------------------
# Phases 8-12: the w8a8 serving mode
# ---------------------------------------------------------------------------


def w8a8_counters():
    from omchat_torch.ops import norms
    from omchat_torch.ops import quant_matmul as qm

    return {
        "rmsnorm_quant": norms.rmsnorm_quant,
        "add_rmsnorm_quant": norms.add_rmsnorm_quant,
        "dense_prequant_gelu_quant": qm.dense_prequant_gelu_quant_cuda,
        "attn_proj_glue_quant": qm.attn_proj_glue_quant,
    }


def swiglu_counters():
    from omchat_torch.ops import quant_matmul as qm

    return {"dense_prequant_swiglu_quant": qm.dense_prequant_swiglu_quant_cuda}


# the C entry point of each w8a8 kernel, and where its sizes sit among its launch arguments
W8A8_ENTRY = {"omchat_rmsnorm_quant": ("rmsnorm_quant", slice(4, 6)),
              "omchat_add_rmsnorm_quant": ("add_rmsnorm_quant", slice(7, 9)),
              "omchat_fc1_gelu_quant": ("dense_prequant_gelu_quant", slice(7, 10)),
              "omchat_swiglu_quant": ("dense_prequant_swiglu_quant", slice(8, 11)),
              "omchat_proj_glue_quant": ("attn_proj_glue_quant", slice(13, 15))}


def record_w8a8_launches():
    """Wrap ``kernel_lib.launch`` so a run records the sizes each w8a8
    kernel was handed (rows, D / M, N, K / M, N); returns the record (name →
    {sizes: count}) and a function that restores the launcher."""
    from omchat_torch.ops import kernel_lib

    rec = {name: {} for name, _ in W8A8_ENTRY.values()}
    launch = kernel_lib.launch

    def recording(source, fn_name, argtypes, *args):
        if fn_name in W8A8_ENTRY:
            name, sizes = W8A8_ENTRY[fn_name]
            key = tuple(args[sizes])
            rec[name][key] = rec[name].get(key, 0) + 1
        return launch(source, fn_name, argtypes, *args)

    kernel_lib.launch = recording

    def undo():
        kernel_lib.launch = launch

    return rec, undo


def quantize_full_model(seed: int):
    """Phase 8: the random full model in bf16, then ``api.quantize_model``
    (per-layer int8 quantization on the card, fc1 calibration); returns
    (cfg, params, results)."""
    import torch

    from omchat_torch import api
    from omchat_torch.config import OmChatConfig

    gc.collect()  # earlier phases' engines hold their models through reference cycles (wrapped methods)
    torch.cuda.empty_cache()
    cfg = OmChatConfig()
    params = build_model(cfg, seed)
    torch.cuda.synchronize()
    calibrate = api.calibrate_fc1_scales
    spans = {}

    def timed_calibrate(*a, **kw):
        t = time.perf_counter()
        out = calibrate(*a, **kw)
        torch.cuda.synchronize()
        spans["calibrate_s"] = time.perf_counter() - t
        return out

    api.calibrate_fc1_scales = timed_calibrate
    try:
        t0 = time.perf_counter()
        cfg8, qparams = api.quantize_model(cfg, params, w8a8=True)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        api.calibrate_fc1_scales = calibrate
    del params
    torch.cuda.empty_cache()

    def nbytes(tree, int8_only):
        if isinstance(tree, dict):
            return sum(nbytes(v, int8_only) for v in tree.values())
        return tree.numel() * tree.element_size() if (tree.dtype == torch.int8 or not int8_only) else 0

    scales = qparams["vision_tower"]["layers"]["mlp"]["fc1_out_scale"]
    res = {"int8_weights_gib": nbytes(qparams, True) / 2**30, "all_weights_gib": nbytes(qparams, False) / 2**30,
           "quantize_s": total - spans["calibrate_s"], "calibrate_s": spans["calibrate_s"],
           "fc1_out_scale_min_max": [float(scales.min()), float(scales.max())],
           "memory_allocated_gib": torch.cuda.memory_allocated() / 2**30}
    log("w8a8 quantize + calibrate: " + json.dumps(res))
    if not (torch.isfinite(scales).all() and (scales > 0).all()):
        raise AssertionError("w8a8: calibrated fc1 scales are not finite and positive")
    return cfg8, qparams, res


def w8a8_serving(cfg, params, label: str = "w8a8 serving",
                 must_launch=("rmsnorm_quant", "attn_proj_glue_quant")) -> dict:
    """Phase 10 (and phase 21 over the calibrated MLP): phase 5's workload on
    the w8a8 model; the kernels ``must_launch`` names must launch on the
    short-prefill and the chunk routes."""
    import torch

    from omchat_torch.runtime import paged_engine as pe

    work = serving_workload(cfg)
    eng = pe.PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, **SERVING)
    rec, undo = record_dispatches(eng)
    counts = {**paged_counters(), **w8a8_counters(), **swiglu_counters()}
    per_route = {"shorts": {}, "chunk": {}}  # launches inside the short-prefill and chunk dispatches
    for kind, name in (("shorts", "_prefill_shorts"), ("chunk", "_run_chunk")):
        fn = getattr(eng, name)

        def counted(*a, _fn=fn, _kind=kind, **kw):
            before = {n: c.launches for n, c in counts.items()}
            out = _fn(*a, **kw)
            if rec["label"] == "timed":
                for n, c in counts.items():
                    if c.launches > before[n]:
                        per_route[_kind][n] = per_route[_kind].get(n, 0) + c.launches - before[n]
            return out

        setattr(eng, name, counted)
    if "dense_prequant_swiglu_quant" not in must_launch:  # K10 runs only over a calibrated MLP
        del counts["dense_prequant_swiglu_quant"]
    try:
        res = timed_serving(eng, work, rec, counts, label)
    finally:
        undo()
    res["launches_by_route"] = per_route
    log(f"{label}, launches by prefill route: " + json.dumps(per_route))
    for route in ("shorts", "chunk"):
        missing = [n for n in must_launch if not per_route[route].get(n)]
        if missing:
            raise AssertionError(f"{label}: {missing} never launched on the {route} route")
    del eng, fn, counted  # the loop's bound method and wrapper hold the engine and its pool too
    gc.collect()
    torch.cuda.empty_cache()
    return res


def quant_compare(got: dict, ref: dict) -> dict:
    """Codes, x' and row scales of a w8a8 kernel against a reference."""
    import torch

    d = (got["codes"].int() - ref["codes"].int()).abs()
    st = {"code_max_diff": int(d.max()), "code_equal": float((d == 0).float().mean())}
    if "rs" in ref:
        st["scale_rel"] = float(((got["rs"] - ref["rs"]).abs() / ref["rs"].abs()).max())
    if "x" in ref:
        ulp = torch.exp2(torch.floor(torch.log2(ref["x"].float().abs().clamp(min=1e-30))) - 7)
        st["x_ulps"] = float(((got["x"].float() - ref["x"].float()).abs() / ulp).max())
    return st


def quant_ok(st: dict) -> bool:
    return (st["code_max_diff"] <= CODE_MAX_DIFF and st["code_equal"] >= CODE_EQUAL_SHARE
            and st.get("scale_rel", 0.0) <= SCALE_RTOL and st.get("x_ulps", 0.0) <= X_ULPS)


def check_quant(name, got, ref) -> dict:
    st = quant_compare(got, ref)
    if not quant_ok(st):
        raise AssertionError(f"{name}: outside the limits (codes ±{CODE_MAX_DIFF} on all, equal on "
                             f"{CODE_EQUAL_SHARE:.0%}, x' {X_ULPS} ulp, scales rtol {SCALE_RTOL}): {st}")
    return st


def quant_fault_caught(name, fault, faulty, ref) -> dict:
    st = quant_compare(faulty, ref)
    if quant_ok(st):
        raise AssertionError(f"{name}: the limits would pass a kernel that has {fault}: {st}")
    return st


def w8a8_kernel_phases(gen, shapes: dict, verify_shapes: dict) -> list:
    """Phase 11: K7, K8, K9 and K11 at the shapes the w8a8 request handed
    them (``shapes``: name → {sizes: launches}), and K7, K10 and K11 at the
    speculative verify's M = 9 (``verify_shapes``, rows ``<name>[M=9]``), on
    inputs drawn like the path's (unit-normal activations, int8 weights
    quantized from normal(0, 0.02), LayerScale near 0.1), against their plain
    versions."""
    import torch

    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops import linear as lin
    from omchat_torch.ops import norms
    from omchat_torch.ops import quant_matmul as qm

    rows_out = []
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, off=0.0):
        return (torch.randn(shape, generator=gen, device=DEVICE) * scale + off).to(bf)

    def qlinear(n, k):
        return lin.quantize_linear({"kernel": randn(k, n, scale=0.02)})

    def top(name):  # the most launched shape
        return max(shapes[name].items(), key=lambda kv: kv[1])[0]

    def weighted_row(name, source, replaces, parts, lib_name):
        """One row for a kernel checked at several shapes: the worst stats,
        every fault, launch-weighted times, ops and bytes."""
        total = sum(pt["launches"] for pt in parts)

        def mean(key):
            return sum(pt[key] * pt["launches"] for pt in parts) / total

        worst = max((pt["stats"] for pt in parts), key=lambda st: (st["code_max_diff"], -st["code_equal"]))
        # torch._int_mm takes more than 16 rows: a part of fewer has no library time, nor then the row
        lib = None if any(pt["library_ms"] is None for pt in parts) else mean("library_ms")
        row(name, source, replaces, worst, {f"{pt['shape']}: {f}": d for pt in parts for f, d in pt["faults"].items()},
            mean("ms"), mean("plain_ms"), lib, mean("ops"), mean("nbytes"),
            "; ".join(f"{pt['shape']} x{pt['launches']}: {pt['ms']:.4f} ms, plain {pt['plain_ms']:.4f}, "
                      + (f"{lib_name} {pt['library_ms']:.4f}, " if pt["library_ms"] is not None
                         else f"{lib_name} none (it takes more than 16 rows), ")
                      + f"bound {bound_ms(pt['ops'], pt['nbytes'], PEAK_INT8_OPS)[0]:.4f}" for pt in parts)
            + " (launch-weighted means)", lib_none="none (torch._int_mm takes more than 16 rows)")

    def unfused(xn, gamma):  # the chain: the norm rounded to bf16, then quantized
        q, rs = lin.quantize_activations(norms.rms_norm(xn, gamma))
        return {"codes": q, "rs": rs}

    def row(name, source, replaces, stats, faults, ms, plain_ms, lib_ms, ops, nbytes, shape, peak=PEAK_INT8_OPS,
            lib_none="none (no single call computes it)"):
        """One kernel's row and log line; ``ms`` a time, or what
        ``device_times`` read (logged with the share of the bound, the
        readings and the eager call's time)."""
        b, by = bound_ms(ops, nbytes, peak)
        timing = ""
        if isinstance(ms, tuple):  # (ms, readings) from device_times
            timing = rate_text(ops, ms[0]["kernel"], b, ms[1]["kernel"]) + eager_text(ms[0])
            ms = ms[0]["kernel"]
        r = dict(name=name, source=source, replaces=replaces, max_abs_err=float(stats["code_max_diff"]), ms=ms,
                 plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b, bound_by=by, stats=stats, faults=faults,
                 shape=shape)
        rows_out.append(r)
        caught = "".join(f"; fault '{f}' {json.dumps(d)} (caught)" for f, d in faults.items())
        lib = lib_none if lib_ms is None else f"{lib_ms:.4f} (torch._int_mm, the GEMMs alone)"
        log(f"kernel {name} [{shape}]: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} "
            f"bound_ms={b:.4f} ({by}){timing} {json.dumps(stats)}{caught}")

    # K7 — the LLM prefill's input norm + quantize, and the verify's at M = 9;
    # timed over input sets that together pass the L2, graphed (the host
    # issues a call slower than the card runs it)
    def k7_row(name, rows, D):
        x, gamma = randn(rows, D), randn(D, scale=0.1, off=1.0)
        nbytes = rows * D * 3 + D * 2 + rows * 4
        q, rs = norms.rmsnorm_quant(x, gamma)
        torch.cuda.synchronize()
        rq, rrs = norms.rmsnorm_quant_plain(x, gamma)
        ref = {"codes": rq, "rs": rrs}
        tag = f"K7 rmsnorm_quant rows={rows}"
        st = check_quant(tag, {"codes": q, "rs": rs}, ref)
        faults = {"gamma dropped": quant_fault_caught(tag, "gamma dropped", dict(zip(
            ("codes", "rs"), norms.rmsnorm_quant_plain(x, torch.ones_like(gamma)))), ref),
            "the bf16-rounded norm quantized (the unfused chain)": quant_fault_caught(
                tag, "the unfused chain", unfused(x, gamma), ref)}
        sets = [(x,)] + [(randn(rows, D),) for _ in range(hbm_set_count(nbytes) - 1)]
        row(name, "omchat_torch/csrc/norm_quant.cu", "omchat_tpu/ops/norms.py:98", st, faults,
            device_times(cycling(lambda x: norms.rmsnorm_quant(x, gamma), sets), None, GRAPH_CALLS),
            time_ms(lambda: norms.rmsnorm_quant_plain(x, gamma)), None, 0.0, nbytes, f"rows={rows} D={D}")

    k7_row("rmsnorm_quant", *top("rmsnorm_quant"))
    ((verify_k7, _),) = verify_shapes["rmsnorm_quant"].items()
    k7_row("rmsnorm_quant[M=9]", *verify_k7)

    # K8 — the ViT MLP glue: x' = x + y * ls2, then the next layer's norm1 + quantize
    rows, D = top("add_rmsnorm_quant")
    x, delta, ls, gamma = randn(rows, D), randn(rows, D), randn(D, scale=0.02, off=0.1), randn(D, scale=0.1, off=1.0)
    nbytes = rows * D * 7 + 2 * D * 2 + rows * 4
    xn, q, rs = norms.add_rmsnorm_quant(x, delta, ls, gamma)
    torch.cuda.synchronize()
    ref = dict(zip(("x", "codes", "rs"), norms.add_rmsnorm_quant_plain(x, delta, ls, gamma)))
    st = check_quant("K8 add_rmsnorm_quant", {"x": xn, "codes": q, "rs": rs}, ref)
    faults = {f: quant_fault_caught("K8", f, dict(zip(("x", "codes", "rs"), fn())), ref) for f, fn in (
        ("LayerScale dropped", lambda: norms.add_rmsnorm_quant_plain(x, delta, None, gamma)),
        ("residual skipped", lambda: norms.add_rmsnorm_quant_plain(torch.zeros_like(x), delta, ls, gamma)))}
    faults["the bf16-rounded norm quantized (the unfused chain)"] = quant_fault_caught(
        "K8", "the unfused chain", {"x": ref["x"], **unfused(ref["x"], gamma)}, ref)
    sets = [(x, delta)] + [(randn(rows, D), randn(rows, D)) for _ in range(hbm_set_count(nbytes) - 1)]
    row("add_rmsnorm_quant", "omchat_torch/csrc/norm_quant.cu", "omchat_tpu/ops/norms.py:148", st, faults,
        device_times(cycling(lambda x, delta: norms.add_rmsnorm_quant(x, delta, ls, gamma), sets), None, GRAPH_CALLS),
        time_ms(lambda: norms.add_rmsnorm_quant_plain(x, delta, ls, gamma)), None, 0.0, nbytes, f"rows={rows} D={D}")
    del x, delta, xn, q, ref, sets

    # K9 — the ViT fc1: codes of a unit-normal activation, a bias near h's
    # spread and the static scale a calibration would set (max |gelu(h)| / 127)
    M, N, K = top("dense_prequant_gelu_quant")
    xq, rs = lin.quantize_activations(randn(M, K))
    p = qlinear(N, K)
    h = lin.int8_matmul(xq, p["kernel_q"].t()).float() * rs * p["scale"].float()
    p["bias"] = randn(N, scale=float(h.std()))
    os_ = lin.div127(lin.gelu_tanh(h + p["bias"].float()).abs().amax())
    del h
    out = qm.dense_prequant_gelu_quant_cuda(xq, rs, p, os_)
    torch.cuda.synchronize()
    ref = {"codes": qm.dense_prequant_gelu_quant_plain(xq, rs, p, os_)}
    st = check_quant("K9 fc1_gelu_quant", {"codes": out}, ref)
    nobias = {k: v for k, v in p.items() if k != "bias"}
    faults = {"bias dropped": quant_fault_caught("K9", "bias dropped", {
        "codes": qm.dense_prequant_gelu_quant_plain(xq, rs, nobias, os_)}, ref),
        "row scales shifted by one row": quant_fault_caught("K9", "row scales shifted by one row", {
            "codes": qm.dense_prequant_gelu_quant_plain(xq, rs.roll(1, 0), p, os_)}, ref)}
    row("dense_prequant_gelu_quant", "omchat_torch/csrc/fc1_gelu_quant.cu", "omchat_tpu/ops/quant_matmul.py:62", st,
        faults, time_ms(lambda: qm.dense_prequant_gelu_quant_cuda(xq, rs, p, os_)),
        time_ms(lambda: qm.dense_prequant_gelu_quant_plain(xq, rs, p, os_), iters=5, warmup=1),
        time_ms(lambda: torch._int_mm(xq, p["kernel_q"].t())), 2.0 * M * N * K,
        M * K + N * K + M * 4 + 2 * N * 2 + 4 + M * N, f"M={M} N={N} K={K}")
    del xq, out, ref, p

    # K10 — the calibrated Qwen2 MLP's gate and up at each shape the path gave
    # it (the request's prefill, the serving run's batched shorts and chunks),
    # reported as one row weighted by launches, and at the verify's M = 9.  Codes of a unit-normal
    # activation and the static scale a calibration would set (max |silu(g) *
    # u| / 127).
    def swiglu_parts(shape_launches):
        parts = []
        for (M, N, K), n_launch in sorted(shape_launches.items()):
            xq, rs = lin.quantize_activations(randn(M, K))
            gp, up = qlinear(N, K), qlinear(N, K)
            g = lin.int8_matmul(xq, gp["kernel_q"].t()).float() * rs * gp["scale"].float()
            u = lin.int8_matmul(xq, up["kernel_q"].t()).float() * rs * up["scale"].float()
            os_ = lin.div127((lin.silu(g) * u).abs().amax())
            del g, u
            out = qm.dense_prequant_swiglu_quant_cuda(xq, rs, gp, up, os_)
            torch.cuda.synchronize()
            ref = {"codes": qm.dense_prequant_swiglu_quant_plain(xq, rs, gp, up, os_)}
            tag = f"K10 swiglu_quant M={M} N={N} K={K}"
            st = check_quant(tag, {"codes": out}, ref)
            faults = {f: quant_fault_caught(tag, f, {"codes": fn()}, ref) for f, fn in (
                ("gate and up swapped", lambda: qm.dense_prequant_swiglu_quant_plain(xq, rs, up, gp, os_)),
                ("row scales shifted by one row",
                 lambda: qm.dense_prequant_swiglu_quant_plain(xq, rs.roll(1, 0), gp, up, os_)))}

            def both_gemms():
                torch._int_mm(xq, gp["kernel_q"].t())
                torch._int_mm(xq, up["kernel_q"].t())

            parts.append(dict(
                launches=n_launch, stats=st, faults=faults, shape=f"M={M} N={N} K={K}",
                ms=time_ms(lambda: qm.dense_prequant_swiglu_quant_cuda(xq, rs, gp, up, os_)),
                plain_ms=time_ms(lambda: qm.dense_prequant_swiglu_quant_plain(xq, rs, gp, up, os_), iters=3,
                                 warmup=1),
                library_ms=time_ms(both_gemms) if M > 16 else None, ops=4.0 * M * N * K,
                nbytes=M * K + 2 * N * K + M * 4 + 2 * N * 2 + 4 + M * N))
            del xq, rs, gp, up, out, ref
        return parts

    for name, shape_launches in (("dense_prequant_swiglu_quant", shapes["dense_prequant_swiglu_quant"]),
                                 ("dense_prequant_swiglu_quant[M=9]", verify_shapes["dense_prequant_swiglu_quant"])):
        weighted_row(name, "omchat_torch/csrc/swiglu_quant.cu", "omchat_tpu/ops/quant_matmul.py:131",
                     swiglu_parts(shape_launches), "torch._int_mm on the two GEMMs")

    # K11 — at each shape the path gave it (the ViT proj with bias and LayerScale
    # ls1; the Qwen2 o_proj with neither), reported as one row weighted by
    # launches, and at the verify's M = 9
    vit_width = OmChatConfig().vision.hidden_size

    def glue_parts(shape_launches):
        parts = []
        for (M, N), n_launch in sorted(shape_launches.items()):
            vit = N == vit_width  # the ViT proj (bias, LayerScale); else the Qwen2 o_proj
            a, x, gamma = randn(M, N, scale=0.5), randn(M, N), randn(N, scale=0.1, off=1.0)
            p = qlinear(N, N)
            ls = randn(N, scale=0.02, off=0.1) if vit else None
            if vit:
                aq, sa = lin.quantize_activations(a)
                y = lin.int8_matmul(aq, p["kernel_q"].t()).float() * sa * p["scale"].float()
                p["bias"] = randn(N, scale=float(y.std()))
                del y
            xn, q, rs = qm.attn_proj_glue_quant(a, x, p, ls, gamma)
            torch.cuda.synchronize()
            ref = dict(zip(("x", "codes", "rs"), qm.attn_proj_glue_quant_plain(a, x, p, ls, gamma)))
            tag = f"K11 attn_proj_glue_quant M={M} N={N}"
            st = check_quant(tag, {"x": xn, "codes": q, "rs": rs}, ref)
            if not torch.equal(xn, ref["x"]):  # an exact int32 product and an elementwise epilogue
                raise AssertionError(f"{tag}: x' must equal the plain version's bit for bit ({st['x_ulps']} ulps)")
            cases = [("residual skipped",
                      lambda: qm.attn_proj_glue_quant_plain(a, torch.zeros_like(x), p, ls, gamma))]
            if vit:
                nob = {k: v for k, v in p.items() if k != "bias"}
                cases += [("LayerScale dropped", lambda: qm.attn_proj_glue_quant_plain(a, x, p, None, gamma)),
                          ("bias dropped", lambda: qm.attn_proj_glue_quant_plain(a, x, nob, ls, gamma))]
            faults = {f: quant_fault_caught(tag, f, dict(zip(("x", "codes", "rs"), fn())), ref) for f, fn in cases}
            faults["the bf16-rounded norm quantized"] = quant_fault_caught(
                tag, "the bf16-rounded norm quantized", {"x": ref["x"], **unfused(ref["x"], gamma)}, ref)
            aq, _ = lin.quantize_activations(a)
            parts.append(dict(
                launches=n_launch, stats=st, faults=faults, shape=f"M={M} N=K={N}",
                ms=time_ms(lambda: qm.attn_proj_glue_quant(a, x, p, ls, gamma)),
                plain_ms=time_ms(lambda: qm.attn_proj_glue_quant_plain(a, x, p, ls, gamma), iters=5, warmup=1),
                library_ms=time_ms(lambda: torch._int_mm(aq, p["kernel_q"].t())) if M > 16 else None,
                ops=2.0 * M * N * N, nbytes=M * N * 2 * 3 + N * N + M * N + 4 * N * 2 + M * 4))
            del a, x, xn, q, ref, aq, p
        return parts

    for name, shape_launches in (("attn_proj_glue_quant", shapes["attn_proj_glue_quant"]),
                                 ("attn_proj_glue_quant[M=9]", verify_shapes["attn_proj_glue_quant"])):
        weighted_row(name, "omchat_torch/csrc/proj_glue_quant.cu", "omchat_tpu/ops/quant_matmul.py:255",
                     glue_parts(shape_launches), "_int_mm")
    torch.cuda.empty_cache()
    return rows_out


def w8a8_kernel_vs_plain(seed: int) -> dict:
    """Phase 12: the model at full width and 2 ViT + 2 LLM layers; first-token
    logits of the w8a8 model through the glue kernels and through
    ``attn_impl="plain"`` (the unfused w8a8 chain, plain attention), and of
    the bf16 model through the plain route; then (phase 21) the calibrated
    MLP's glue trunk through the kernels and through their plain versions."""
    import torch

    from omchat_torch import api
    from omchat_torch.config import OmChatConfig
    from omchat_torch.models import qwen2
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import norms
    from omchat_torch.ops import quant_matmul as qm
    from omchat_torch.runtime.generate import OmChatEngine

    full = OmChatConfig()
    cfg = dataclasses.replace(full, vision=dataclasses.replace(full.vision, num_hidden_layers=2),
                              text=dataclasses.replace(full.text, num_hidden_layers=2))
    bf16 = build_model(cfg, seed)
    cfg8, params = api.quantize_model(cfg, bf16, w8a8=True)
    ids, tiles = make_request(cfg, seed)
    logits = {}
    for key, c, p, impl in (("kernels", cfg8, params, None), ("plain", cfg8, params, "plain"),
                            ("bf16_plain", cfg, bf16, "plain")):
        eng = OmChatEngine(c, p, attn_impl=impl, image_cache_size=0)
        logits[key], _ = eng.prefill(eng.plan([ids]), eng.encode_images(tiles), 32)
    torch.cuda.synchronize()
    # The calibrated MLP (K10): the same glue trunk through the kernels and
    # through their plain versions (K7, K11, K10 and K2 swapped for theirs in
    # the trunk; the ViT runs its kernels on both sides).  The plain route
    # above has no static scales: it runs the dynamic chain.
    calib = swiglu_calibrate(cfg8, params, seed, label="w8a8 swiglu calibrate (2+2 layers)")
    eng = OmChatEngine(cfg8, calib, image_cache_size=0)
    plan, feats = eng.plan([ids]), eng.encode_images(tiles)
    logits["kernels_calibrated"], _ = eng.prefill(plan, feats, 32)

    def plain_attention(q, k, v, *, causal=False, q_offset=None, kv_len=None, impl=None, kv_format="btnd",
                        segment_ids=None):
        if kv_format == "btnd":
            k, v = k.transpose(1, 2), v.transpose(1, 2)
        return fa.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)

    swapped = {"rmsnorm_quant": norms.rmsnorm_quant_plain, "attn_proj_glue_quant": qm.attn_proj_glue_quant_plain,
               "swiglu_quant": qm.dense_prequant_swiglu_quant_plain, "attention": plain_attention}
    saved = {n: getattr(qwen2, n) for n in swapped}
    for n, f in swapped.items():
        setattr(qwen2, n, f)
    try:
        logits["plain_calibrated"], _ = eng.prefill(plan, feats, 32)
    finally:
        for n, f in saved.items():
            setattr(qwen2, n, f)
    torch.cuda.synchronize()
    got, ref = logits["kernels"], logits["plain"]
    diff, top = float((got - ref).abs().max()), float(ref.abs().max())
    quant = float((ref - logits["bf16_plain"]).abs().max())
    calibrated = float((logits["kernels_calibrated"] - logits["plain_calibrated"]).abs().max())
    res = {"logits_max_abs_diff": diff, "logits_max_abs": top, "rel": diff / top,
           "w8a8_vs_bf16_max_abs_diff": quant, "argmax_equal": bool(torch.equal(got.argmax(-1), ref.argmax(-1))),
           "calibrated_mlp_kernels_vs_plain_max_abs_diff": calibrated,
           "calibrated_mlp_kernels_vs_dynamic_plain_chain_max_abs_diff":
               float((logits["kernels_calibrated"] - ref).abs().max())}
    log("w8a8 kernels vs plain (2 ViT + 2 LLM layers, full width): " + json.dumps(res))
    for name, d, lg in (("kernels", diff, got), ("kernels over the calibrated MLP", calibrated,
                                                 logits["kernels_calibrated"])):
        if not torch.isfinite(lg).all() or d > quant:
            raise AssertionError(f"w8a8 {name} vs plain: logits differ by {d:.4g}, more than w8a8 moves the plain "
                                 f"chain from bf16 ({quant:.4g})")
    del params, bf16, calib, eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phases 13-16: training
# ---------------------------------------------------------------------------


def train_counters():
    from omchat_torch.ops import flash_attention_bwd as fb

    return {"flash_attention_fwd": fb.flash_fwd, "flash_attention_bwd_dq": fb.flash_bwd_dq,
            "flash_attention_bwd_dkv": fb.flash_bwd_dkv}


def training_batch(cfg, seed: int) -> dict:
    """Phase 14's batch, on the card: TRAIN_BATCH samples, each one seeded
    448x448 image (3 anyres tiles) and phase 3's question with a
    TRAIN_ANSWER-token answer (seeded ids), merged and bucketed to 128; labels
    on the answer only."""
    import numpy as np
    import torch

    from omchat_torch.cli.train import pack_batch

    ids_all, spans, tiles_all = [], [], []
    for i in range(TRAIN_BATCH):
        ids, tiles = make_request(cfg, seed + i)
        answer = np.random.default_rng(seed + 100 + i).integers(10, cfg.text.vocab_size, TRAIN_ANSWER).tolist()
        ids = ids + answer
        merged = len(ids) + sum(t == -200 for t in ids) * (cfg.image_seq_len - 1)
        ids_all.append(ids)
        spans.append((merged - TRAIN_ANSWER, merged))
        tiles_all.append(tiles)
    batch = pack_batch(cfg, ids_all, spans, np.concatenate(tiles_all))
    return {k: v.to(DEVICE, dtype=torch.bfloat16 if k == "pixel_values" else v.dtype) for k, v in batch.items()}


def train_kernel_shapes(cfg, batch) -> dict:
    """The attention shapes phase 14 hands K16 (LLM trunk and ViT), and the packed case."""
    t, v = cfg.text, cfg.vision
    return {"llm": (int(batch["token_ids"].shape[0]), int(batch["token_ids"].shape[1]), t.num_attention_heads,
                    t.num_key_value_heads, True),
            "vit": (int(batch["pixel_values"].shape[0]), v.seq_len, v.num_attention_heads, v.num_attention_heads,
                    False),
            "packed": (1, PACKED_ROWS, t.num_attention_heads, t.num_key_value_heads, True)}


def _planted_case(gen, B, S, H, KVH, causal, seg=None, D=128):
    """q carries its kv head's direction u; keys 0.8 u at the columns on either
    side of every 64-column tile edge and of every segment boundary, so each
    of them takes most of the softmax of the rows that may see it.  D: the
    head width."""
    import torch

    u = _direction(gen, KVH, D)
    q = _randn(gen, B, S, H, D) + u.repeat_interleave(H // KVH, dim=0)
    k, v, do = _randn(gen, B, S, KVH, D), _randn(gen, B, S, KVH, D), _randn(gen, B, S, H, D)
    cols = set(range(63, S - 1, 64)) | set(range(64, S, 64))
    if seg is not None:
        edges = (torch.nonzero(seg[0, 1:] != seg[0, :-1]).flatten() + 1).tolist()
        cols |= {c for e in edges for c in (e - 1, e) if 0 <= c < S}
    idx = torch.tensor(sorted(cols), dtype=torch.long, device=DEVICE)
    k[:, idx] = (0.8 * u).to(k.dtype)
    return q, k, v, do


def _shifted_mask(s, causal, segment_ids, device):
    """The planted fault: the causal diagonal shifted one column right."""
    import torch

    mask = torch.ones((s, s), dtype=torch.bool, device=device).tril(diagonal=1)[None]
    if segment_ids is not None:
        seg = segment_ids
        mask = mask & (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] >= 0)
    return mask


def read_128_columns(x):
    """Phase 44's planted fault: [B, S, N, D] read as a kernel built for
    128-wide heads reads it, 128 columns from each head's first (the
    neighbour heads' columns, then the next row's; zeros past the end)."""
    import torch

    B, S, N, D = x.shape
    flat = torch.cat([x.reshape(-1), x.new_zeros(128)])
    idx = (torch.arange(B * S * N, device=x.device) * D)[:, None] + torch.arange(128, device=x.device)
    return flat[idx].view(B, S, N, 128)


def stored_at_128_stride(x):
    """Phase 44's planted fault: [B, S, N, D] stored with a row of 128 columns
    a head, as a kernel built for 128-wide heads stores it, into x's bytes
    (what falls past them dropped, the rest of the bytes zero)."""
    import torch

    B, S, N, D = x.shape
    idx = (torch.arange(B * S * N, device=x.device) * 128)[:, None] + torch.arange(D, device=x.device)
    keep = idx < x.numel()
    out = x.new_zeros(x.numel())
    out[idx[keep]] = x.reshape(-1, D)[keep]
    return out.view(x.shape)


def width_faults(q, k, v, seg, causal, ro, rk, rv, valid, tag) -> dict:
    """Phase 44's width faults against K16's function at head width D < 128:
    the softmax scale of a 128-wide head, q and k read 128 columns a head,
    dK / dV stored at a 128-column stride; each must fall outside its limit."""
    import torch

    from omchat_torch.ops import flash_attention_bwd as fb

    D = q.shape[-1]
    saved = fb.softmax_scale
    faults = {}
    try:
        fb.softmax_scale = lambda x: torch.tensor(128 ** -0.5, dtype=x.dtype, device=x.device)
        faults["the softmax scale of D = 128"] = check_fault_caught(
            tag, "the scale of D=128", fb.flash_fwd_plain(q, k, v, causal, seg)[0][valid], ro[valid],
            *ATTN_TOL["K16a"])
        fb.softmax_scale = lambda x: torch.tensor(D ** -0.5, dtype=x.dtype, device=x.device)
        faults["q and k read 128 columns a head"] = check_fault_caught(
            tag, "q and k read past column D",
            fb.flash_fwd_plain(read_128_columns(q), read_128_columns(k), v, causal, seg)[0][valid], ro[valid],
            *ATTN_TOL["K16a"])
    finally:
        fb.softmax_scale = saved
    faults["dK / dV stored at a 128-column stride"] = max(
        check_fault_caught(tag, "dK at a 128-column stride", stored_at_128_stride(rk), rk, *ATTN_TOL["K16c"]),
        check_fault_caught(tag, "dV at a 128-column stride", stored_at_128_stride(rv), rv, *ATTN_TOL["K16c"]))
    return faults


def train_kernel_phases(gen, shapes: dict, row_case: str = "llm", D: int = 128, tag: str = "", timed: bool = True,
                        docs=PACKED_DOCS) -> list:
    """Phase 13: K16a/b/c at the shapes phase 14 hands them and on a packed
    batch (``docs`` and a -1 tail), against their plain versions, with
    planted faults; the kernels line's rows (named with ``tag``) from
    ``row_case``'s shape (None: no rows, the shapes' lines only, as phase 41
    times K16 at its modes' shapes).  Phase 44 runs it at head width D < 128
    with the width faults too, and ``timed=False`` for the checks alone."""
    import torch
    import torch.nn.functional as F

    from omchat_torch.ops import flash_attention_bwd as fb

    rows_out, parts = [], {}
    for case, (B, S, H, KVH, causal) in shapes.items():
        seg = None
        if case == "packed":  # the documents and a -1 tail
            seg = torch.full((B, S), -1, dtype=torch.int32, device=DEVICE)
            for i, (a, b) in enumerate(docs):
                seg[:, a:b] = i
        q, k, v, do = _planted_case(gen, B, S, H, KVH, causal, seg, D=D)
        valid = torch.ones((B, S), dtype=torch.bool, device=DEVICE) if seg is None else seg >= 0
        out, lse = fb.flash_fwd(q, k, v, causal, seg)
        torch.cuda.synchronize()
        ro, rl = fb.flash_fwd_plain(q, k, v, causal, seg)
        di = fb.flash_di(do, ro)
        qs = fb._prescaled(q)  # as the backward hands it to K16b and K16c
        dq = fb.flash_bwd_dq(q, k, v, do, rl, di, causal, seg, q_scaled=qs)
        dk, dv = fb.flash_bwd_dkv(q, k, v, do, rl, di, causal, seg, q_scaled=qs)
        dq2 = fb.flash_bwd_dq(q, k, v, do, rl, di, causal, seg, q_scaled=qs)
        torch.cuda.synchronize()
        if not torch.equal(dq, dq2):
            raise AssertionError(f"K16{tag} {case}: a second dQ launch differs (a block owns its rows: no atomics)")
        del dq2
        rq = fb.flash_bwd_dq_plain(q, k, v, do, rl, di, causal, seg)
        rk, rv = fb.flash_bwd_dkv_plain(q, k, v, do, rl, di, causal, seg)
        name = f"K16{tag} {case} B={B} S={S} H={H}/{KVH} causal={causal}"
        err = {"fwd": check_close(f"{name} out", out[valid], ro[valid], *ATTN_TOL["K16a"]),
               "dq": check_close(f"{name} dq", dq, rq, *ATTN_TOL["K16b"]),
               "dkv": max(check_close(f"{name} dk", dk, rk, *ATTN_TOL["K16c"]),
                          check_close(f"{name} dv", dv, rv, *ATTN_TOL["K16c"]))}
        lse_err = check_close(f"{name} lse", lse.transpose(1, 2)[valid], rl.transpose(1, 2)[valid], LSE_ATOL, 0.0)
        if seg is not None and not bool(torch.isneginf(lse.transpose(1, 2)[~valid]).all()):
            raise AssertionError(f"{name}: padding rows must get lse = -inf")
        faults = {}
        if causal:
            saved = fb.attention_mask
            fb.attention_mask = _shifted_mask
            try:
                faults["causal mask shifted by one column"] = check_fault_caught(
                    name, "the causal mask shifted", fb.flash_fwd_plain(q, k, v, causal, seg)[0][valid], ro[valid],
                    *ATTN_TOL["K16a"])
            finally:
                fb.attention_mask = saved
        faults["di dropped"] = check_fault_caught(
            name, "the di term dropped", fb.flash_bwd_dq_plain(q, k, v, do, rl, torch.zeros_like(di), causal, seg),
            rq, *ATTN_TOL["K16b"])
        faults["lse from the wrong row"] = check_fault_caught(
            name, "lse from the wrong row", fb.flash_bwd_dq_plain(q, k, v, do, rl.roll(1, dims=2), di, causal, seg),
            rq, *ATTN_TOL["K16b"])
        if H > KVH:
            do1, di1 = do.clone(), di.clone()
            do1[:, :, H // KVH - 1] = 0  # the last q head of kv head 0's group left out
            di1[:, H // KVH - 1] = 0
            faults["a q head of the group left out of dK/dV"] = check_fault_caught(
                name, "one q head's share left out", fb.flash_bwd_dkv_plain(q, k, v, do1, rl, di1, causal, seg)[1], rv,
                *ATTN_TOL["K16c"])
        if seg is not None:
            faults["segment isolation broken"] = check_fault_caught(
                name, "segment isolation broken", fb.flash_fwd_plain(q, k, v, causal, None)[0][valid], ro[valid],
                *ATTN_TOL["K16a"])
        if D < 128:
            faults.update(width_faults(q, k, v, seg, causal, ro, rk, rv, valid, name))
        log(f"{name}: lse max_abs_err={lse_err:.3g}; max_abs_err out / dq / dk,dv "
            f"{err['fwd']:.3g} / {err['dq']:.3g} / {err['dkv']:.3g}; " + "; ".join(
                f"fault '{f}' max_dev={d:.3g} (caught)" for f, d in faults.items()))
        del ro, rl, rq, rk, rv
        torch.cuda.empty_cache()
        if not timed:
            del q, qs, k, v, do, out, lse, dq, dk, dv, di
            torch.cuda.empty_cache()
            continue
        # library yardstick: SDPA forward, and its backward (dQ, dK, dV together); the packed case as a mask
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        kw = dict(is_causal=causal, enable_gqa=True) if seg is None else dict(
            attn_mask=fb.attention_mask(S, causal, seg, q.device)[:, None], enable_gqa=True)
        o = F.scaled_dot_product_attention(qt, kt, vt, **kw)
        dot = do.transpose(1, 2)
        # the kernels and SDPA in turns; K16b and K16c take the backward's one prescaled q
        launch = {"fwd": lambda: fb.flash_fwd(q, k, v, causal, seg),
                  "dq": lambda: fb.flash_bwd_dq(q, k, v, do, lse, di, causal, seg, q_scaled=qs),
                  "dkv": lambda: fb.flash_bwd_dkv(q, k, v, do, lse, di, causal, seg, q_scaled=qs),
                  "sdpa_fwd": lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw),
                  "sdpa_bwd": lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)}
        ms, readings = time_in_turns(launch)
        lib_fwd, lib_bwd = ms["sdpa_fwd"], ms["sdpa_bwd"]
        del o, qt, kt, vt, dot
        prescale_ms = time_ms(lambda: fb._prescaled(q), iters=30)  # inside every K16a call, once a backward
        plain = {"fwd": time_ms(lambda: fb.flash_fwd_plain(q, k, v, causal, seg), iters=2, warmup=1),
                 "dq": time_ms(lambda: fb.flash_bwd_dq_plain(q, k, v, do, lse, di, causal, seg), iters=2, warmup=1),
                 "dkv": time_ms(lambda: fb.flash_bwd_dkv_plain(q, k, v, do, lse, di, causal, seg), iters=2,
                                warmup=1)}
        torch.cuda.empty_cache()
        # the work these inputs need: causal pairs, packed pairs within each document
        if seg is not None:
            pairs = sum((b - a) * (b - a + 1) / 2 for a, b in docs) * B
        else:
            pairs = B * (S * (S + 1) / 2 if causal else S * S)
        qo = 2 * B * S * H * D  # one [B, S, H, D] bf16 tensor (q, dO, out, dq)
        kvo = 2 * B * S * KVH * D  # one [B, S, KVH, D] bf16 tensor (k, v, dk, dv)
        rowf = 4 * B * H * S  # one [B, H, S] fp32 tensor (lse, di)
        parts[case] = {
            "fwd": dict(ms=ms["fwd"], plain_ms=plain["fwd"], library_ms=lib_fwd, flops=4.0 * pairs * H * D,
                        bytes=2 * qo + 2 * kvo + rowf, err=err["fwd"]),
            "dq": dict(ms=ms["dq"], plain_ms=plain["dq"], library_ms=lib_bwd, flops=6.0 * pairs * H * D,
                       bytes=3 * qo + 2 * kvo + 2 * rowf, err=err["dq"]),
            "dkv": dict(ms=ms["dkv"], plain_ms=plain["dkv"], library_ms=lib_bwd, flops=8.0 * pairs * H * D,
                        bytes=2 * qo + 4 * kvo + 2 * rowf, err=err["dkv"]),
        }
        for kname, p in parts[case].items():
            b_ms, by = bound_ms(p["flops"], p["bytes"])
            p["bound_ms"], p["bound_by"] = b_ms, by
            # achieved rate: the operations these inputs need over the kernel's time
            log(f"kernel K16 {kname}{tag} [{case}: B={B} S={S} H={H}/{KVH} causal={causal}]: kernel_ms={p['ms']:.4f} "
                f"plain_ms={p['plain_ms']:.4f} library_ms={p['library_ms']:.4f} bound_ms={b_ms:.4f} ({by}) "
                f"tflops={p['flops'] / p['ms'] / 1e9:.1f} share_of_bound={b_ms / p['ms']:.3f} "
                f"max_abs_err={p['err']:.3g} readings={[round(x, 4) for x in readings[kname]]} "
                f"library_readings={[round(x, 4) for x in readings['sdpa_bwd' if kname != 'fwd' else 'sdpa_fwd']]}")
        log(f"{name}: q * scale ms={prescale_ms:.4f}")
        del q, qs, k, v, do, out, lse, dq, dk, dv, di
        torch.cuda.empty_cache()
    if row_case is None:
        return rows_out
    # one row per kernel, at the LLM trunk's shape (the most launched and the most work)
    for kname, name, replaces in (("fwd", "flash_attention_fwd", "omchat_tpu/ops/flash_attention_bwd.py:327"),
                                  ("dq", "flash_attention_bwd_dq", "omchat_tpu/ops/flash_attention_bwd.py:421"),
                                  ("dkv", "flash_attention_bwd_dkv", "omchat_tpu/ops/flash_attention_bwd.py:421")):
        p = parts[row_case][kname]
        rows_out.append(dict(name=name + tag, source="omchat_torch/csrc/flash_attention_bwd.cu", replaces=replaces,
                             max_abs_err=max(parts[c][kname]["err"] for c in parts), ms=p["ms"],
                             plain_ms=p["plain_ms"], library_ms=p["library_ms"], bound_ms=p["bound_ms"],
                             bound_by=p["bound_by"]))
    return rows_out


def _leaf_sums(params) -> dict:
    """An exact fingerprint of every leaf: the int64 sum of its bit patterns."""
    import torch

    from omchat_torch.utils.tree import tree_items

    out = {}
    for path, t in tree_items(params):
        if t.is_floating_point():
            bits = t.detach().view(torch.int16) if t.element_size() == 2 else t.detach().view(torch.int32)
        else:
            bits = t
        out[path] = int(bits.to(torch.int64).sum())
    return out


def _run_steps(label, step_fn, n_steps, batch, cfg, flops) -> dict:
    """n_steps training steps on the fixed batch with the K16 counts set to 0
    just before; per-step CUDA-event wall time, losses, peak memory, launches.
    ``flops``: (model, hardware) FLOPs a step (``model_flops`` without and
    with the remat recompute), for ``mfu`` and ``hfu``."""
    import torch

    counts = train_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counts.values():
        c.launches = 0
    losses, times = [], []
    for _ in range(n_steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step_fn()
        end.record()
        torch.cuda.synchronize()
        losses.append(float(loss))
        times.append(start.elapsed_time(end))
    launches = {n: c.launches for n, c in counts.items()}
    step_ms = sum(times[1:]) / (n_steps - 1) if n_steps > 1 else times[0]
    tokens = int((batch["positions"] > 0).sum() + batch["positions"].shape[0])  # merged rows that are not padding
    model, hardware = flops
    res = {"losses": losses, "step_ms": times, "step_wall_ms_mean_after_first": step_ms,
           "trained_tokens_per_s": tokens / (step_ms / 1e3), "label_tokens": int((batch["labels"] != -100).sum()),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "model_tflop": model / 1e12,
           "hardware_tflop": hardware / 1e12, "mfu": model / (step_ms / 1e3) / PEAK_BF16_FLOPS,
           "hfu": hardware / (step_ms / 1e3) / PEAK_BF16_FLOPS, "launches": launches}
    log(f"{label}: " + json.dumps(res))
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    return res


def _expect_launches(label, res, per_step: dict, n_steps: int):
    want = {n: k * n_steps for n, k in per_step.items()}
    if res["launches"] != want:
        raise AssertionError(f"{label}: K16 launches {res['launches']}, expected {want}")


def _leaves_changed(label: str, before: dict, after: dict, parts: tuple) -> list:
    """The leaves whose bits changed; raises unless each of ``parts`` (top-level
    keys) has one at least, and no other part has any."""
    changed = sorted(".".join(p) for p in before if before[p] != after[p])
    tops = {c.split(".")[0] for c in changed}
    if tops != set(parts):
        raise AssertionError(f"{label}: leaves changed in {sorted(tops)}, expected in {sorted(parts)} alone")
    return changed


def _loss_falls(label: str, res: dict) -> None:
    if not res["losses"][-1] < res["losses"][0]:
        raise AssertionError(f"{label}: the loss did not fall: {res['losses']}")


def training(seed: int) -> dict:
    """Phases 14 and 15: stage-1, then LoRA and QLoRA, at full width and
    depth on one fixed batch.  Returns the results by mode (stage-1's
    launches are the K16 rows' launches)."""
    import torch

    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops.linear import quantize_tree
    from omchat_torch.training import lora as tl
    from omchat_torch.training import train_step as ts

    gc.collect()
    torch.cuda.empty_cache()
    cfg = OmChatConfig()
    params = build_model(cfg, seed)
    batch = training_batch(cfg, seed)
    t_layers, v_layers = cfg.text.num_hidden_layers, cfg.vision.num_hidden_layers
    # forward, the trunk's remat recompute and the ViT forward; the backward
    # kernels once per trunk layer (the frozen ViT takes no backward)
    frozen_vit = {"flash_attention_fwd": 2 * t_layers + v_layers, "flash_attention_bwd_dq": t_layers,
                  "flash_attention_bwd_dkv": t_layers}
    log(f"training batch: B={batch['token_ids'].shape[0]} rows={batch['token_ids'].shape[1]} "
        f"tiles={batch['pixel_values'].shape[0]} label tokens={int((batch['labels'] != -100).sum())}")

    # phase 14: stage-1, the projector alone
    before = _leaf_sums(params)
    opt = ts.AdamW(TRAIN_LR, grad_clip=1.0)
    state = ts.init_train_state(params, opt, lambda path: path[0] == "projector")
    flops = tuple(ts.model_flops(cfg, batch, vit_backward=False, trunk_weights_grad=False, recompute=r)
                  for r in (False, True))
    s1 = _run_steps("stage-1 (full width and depth)", lambda: ts.train_step(state, cfg, batch, opt)[1], TRAIN_STEPS,
                    batch, cfg, flops)
    _expect_launches("stage-1", s1, frozen_vit, TRAIN_STEPS)
    s1["changed_leaves"] = _leaves_changed("stage-1", before, _leaf_sums(params), ("projector",))
    _loss_falls("stage-1", s1)
    ts.set_trainable(params, lambda path: False)
    del state, opt
    gc.collect()
    torch.cuda.empty_cache()

    # phase 15: LoRA rank 16 on q/k/v/o over the bf16 base, then over the int8 trunk
    results = {"stage1": s1}
    for label, base in (("lora", params), ("qlora", None)):
        if base is None:  # QLoRA: quantize_tree on the trunk's layers only; the ViT stays bf16
            lm = dict(params["language_model"])
            lm["layers"] = quantize_tree(lm["layers"])
            base = {**params, "language_model": lm}
        before = _leaf_sums(base)
        lora = tl.init_lora(torch.Generator(device=DEVICE).manual_seed(seed), base, rank=LORA_RANK)
        a0 = _leaf_sums(lora["layers"])
        opt = ts.AdamW(TRAIN_LR, grad_clip=1.0)
        opt_state = opt.init(tl.lora_leaves(lora))
        res = _run_steps(f"{label} rank {LORA_RANK} (full width and depth)",
                         lambda: tl.lora_train_step(lora, opt_state, base, cfg, batch, opt)[2], LORA_STEPS, batch,
                         cfg, flops)
        _expect_launches(label, res, frozen_vit, LORA_STEPS)
        if _leaf_sums(base) != before:
            raise AssertionError(f"{label}: the frozen base changed")
        moved = [p for p, s in _leaf_sums(lora["layers"]).items() if s != a0[p]]
        if not any(p[-1] == "b" for p in moved):
            raise AssertionError(f"{label}: no adapter leaf moved")
        _loss_falls(label, res)
        results[label] = res
        del lora, opt, opt_state, base
        gc.collect()
        torch.cuda.empty_cache()
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return results


def _train_faults() -> dict:
    """Phase 16's control: faults planted in the training path's kernels,
    each by swapping one K16 wrapper for its plain version with the fault.
    Returns {fault: (wrapper name, planted function)}."""
    import torch

    from omchat_torch.ops import flash_attention_bwd as fb

    kernel_fwd = fb.flash_fwd

    def dkv_head_dropped(q, k, v, dout, lse, di, causal, segment_ids=None, *, q_scaled=None):
        g = q.shape[2] // k.shape[2]
        dout, di = dout.clone(), di.clone()
        dout[:, :, g - 1] = 0  # the last q head of kv head 0's group left out
        di[:, g - 1] = 0
        return fb.flash_bwd_dkv_plain(q, k, v, dout, lse, di, causal, segment_ids)

    def dq_di_dropped(q, k, v, dout, lse, di, causal, segment_ids=None, *, q_scaled=None):
        return fb.flash_bwd_dq_plain(q, k, v, dout, lse, torch.zeros_like(di), causal, segment_ids)

    def fwd_wrong_kv_head(q, k, v, causal, segment_ids=None):
        return fb.flash_fwd_plain(q, k.roll(1, dims=2), v.roll(1, dims=2), causal, segment_ids)

    def fwd_not_causal(q, k, v, causal, segment_ids=None):
        return (fb.flash_fwd_plain if causal else kernel_fwd)(q, k, v, False, segment_ids)

    def fwd_diagonal_shifted(q, k, v, causal, segment_ids=None):
        if not causal:  # the ViT's attention has no diagonal
            return kernel_fwd(q, k, v, causal, segment_ids)
        saved = fb.attention_mask
        fb.attention_mask = _shifted_mask
        try:
            return fb.flash_fwd_plain(q, k, v, causal, segment_ids)
        finally:
            fb.attention_mask = saved

    planted = (dkv_head_dropped, dq_di_dropped, fwd_wrong_kv_head, fwd_not_causal, fwd_diagonal_shifted)
    for fn in planted:  # the kernel wrappers count their launches on the module's names, which now hold these
        fn.launches = 0
    return {"a q head of the group left out of dK/dV (K16c)": ("flash_bwd_dkv", dkv_head_dropped),
            "di dropped from dS (K16b)": ("flash_bwd_dq", dq_di_dropped),
            "q heads read the next kv head (K16a)": ("flash_fwd", fwd_wrong_kv_head),
            "the causal mask ignored (K16a)": ("flash_fwd", fwd_not_causal),
            "the causal diagonal shifted one column (K16a)": ("flash_fwd", fwd_diagonal_shifted)}


def _train_gaps(got, ref, paths) -> dict:
    """Loss and gradient gaps of one route against the plain one: the loss's
    relative gap, the largest gradient gap over the largest |g| of all
    leaves, the gap's L2 norm over the gradient's, and per leaf its own gap
    over its own largest |g|."""
    (lk, gk), (lp, gp) = got, ref
    diffs = [float((a - b).abs().max()) for a, b in zip(gk, gp)]
    tops = [float(b.abs().max()) for b in gp]
    l2 = math.sqrt(sum(float((a - b).square().sum()) for a, b in zip(gk, gp)) / sum(float(b.square().sum()) for b in gp))
    return {"loss": lk, "loss_rel": abs(lk - lp) / abs(lp), "grad_max_abs_diff": max(diffs),
            "grad_max_abs": max(tops), "grad_rel": max(diffs) / max(tops), "grad_l2_rel": l2,
            "grad_rel_by_leaf": {".".join(p): d / t for p, d, t in zip(paths, diffs, tops)}}


def train_kernel_vs_plain(seed: int) -> dict:
    """Phase 16: full width, 2 ViT + 2 LLM layers.  The stage-1 loss and
    projector gradients, and the LoRA adapter gradients, through the kernels
    ("vjp") and through the plain autograd reference ("plain"), with a
    control: the same through kernels with a planted fault must fall outside
    a limit.  Then two full-parameter stage-2 steps, whose backward runs
    K16b/K16c through the ViT's non-causal attention too."""
    import torch

    from omchat_torch.config import OmChatConfig
    from omchat_torch.training import train_step as ts

    full = OmChatConfig()
    cfg = dataclasses.replace(full, vision=dataclasses.replace(full.vision, num_hidden_layers=2),
                              text=dataclasses.replace(full.text, num_hidden_layers=2))
    params = build_model(cfg, seed)
    batch = training_batch(cfg, seed)
    out = train_route_gaps(cfg, params, batch, seed, "2 ViT + 2 LLM layers, full width")
    # stage-2: every weight trains
    opt = ts.AdamW(1e-5, grad_clip=1.0)
    state = ts.init_train_state(params, opt)
    flops = tuple(ts.model_flops(cfg, batch, vit_backward=True, trunk_weights_grad=True, recompute=r)
                  for r in (False, True))
    s2 = _run_steps("stage-2, every weight (2 ViT + 2 LLM layers, full width)",
                    lambda: ts.train_step(state, cfg, batch, opt)[1], 2, batch, cfg, flops)
    n_t, n_v = cfg.text.num_hidden_layers, cfg.vision.num_hidden_layers
    _expect_launches("stage-2", s2, {"flash_attention_fwd": 2 * (n_t + n_v), "flash_attention_bwd_dq": n_t + n_v,
                                     "flash_attention_bwd_dkv": n_t + n_v}, 2)
    out["stage2"] = s2
    del state, opt, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_route_gaps(cfg, params, batch, seed: int, what_model: str, by_leaf: bool = False,
                     unseen: tuple = ()) -> dict:
    """Phase 16's rule on one model (phase 44 runs it at head width 64): the
    stage-1 loss and projector gradients, and the LoRA adapter gradients,
    through the kernels ("vjp") and through the plain autograd reference
    ("plain") within TRAIN_LOSS_RTOL / TRAIN_GRAD_REL, and each of
    ``_train_faults``' planted faults outside them in one comparison.
    ``by_leaf``: every leaf's gradient gap over its own max |g| is held to
    TRAIN_GRAD_REL as well, and a fault is outside where one leaf's is (at
    head width 64 the q_proj adapters' gradients, which dropping di moves
    most, are a small share of the largest leaf's).  ``unseen``: faults
    reported but not required outside, which the caller holds elsewhere.
    Returns the gaps by comparison."""
    import torch

    from omchat_torch.ops import flash_attention_bwd as fb
    from omchat_torch.training import lora as tl
    from omchat_torch.training import train_step as ts
    from omchat_torch.utils.tree import tree_items

    out = {}
    ts.set_trainable(params, lambda path: path[0] == "projector")
    lora = tl.init_lora(torch.Generator(device=DEVICE).manual_seed(seed), params, rank=LORA_RANK)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    with torch.no_grad():  # b = 0 would give the adapters' a no gradient
        for ab in lora["layers"]["self_attn"].values():
            ab["b"].normal_(0.0, 0.02, generator=g)
    projector_paths = [p for p, t in tree_items(params) if isinstance(t, torch.Tensor) and t.requires_grad]
    lora_paths = [p for p, _ in tree_items(lora["layers"])]
    for what, paths, leaves, fn in (
            ("stage-1 projector", projector_paths, ts.trainable_leaves(params),
             lambda impl: ts.loss_fn(params, cfg, batch, attn_impl=impl)[0]),
            ("lora adapters", lora_paths, tl.lora_leaves(lora),
             lambda impl: tl.lora_loss_fn(lora, params, cfg, batch, attn_impl=impl)[0])):
        def run(impl):
            loss = fn(impl)
            return loss.item(), [x.float() for x in ts.gradients(loss, leaves)]

        ref = run("plain")
        res = _train_gaps(run("vjp"), ref, paths)
        faulted = {}
        for fault, (name, planted) in _train_faults().items():
            saved = getattr(fb, name)
            setattr(fb, name, planted)
            try:
                faulted[fault] = _train_gaps(run("vjp"), ref, paths)
            finally:
                setattr(fb, name, saved)
        res["faults"] = faulted
        log(f"training kernels vs plain, {what} ({what_model}): " + json.dumps(res))
        out[what] = res
    def grad_gap(res) -> float:
        return max([res["grad_rel"], *(res["grad_rel_by_leaf"].values() if by_leaf else ())])

    for what, res in out.items():  # checked once both are read
        if not (res["loss_rel"] <= TRAIN_LOSS_RTOL and grad_gap(res) <= TRAIN_GRAD_REL):
            raise AssertionError(f"training kernels vs plain, {what}: loss rel {res['loss_rel']:.3g} (limit "
                                 f"{TRAIN_LOSS_RTOL}), gradients {grad_gap(res):.3g} of max |g| (limit "
                                 f"{TRAIN_GRAD_REL}{', by leaf' if by_leaf else ''})")
    # each planted fault must fall outside a limit in one comparison at least:
    # a shifted diagonal moves the projector's gradients less than bf16 does
    # (on random weights a row's attention spreads over thousands of keys),
    # the q/k adapters' gradients, which read the attention pattern, far more
    for fault in _train_faults():
        if fault in unseen:
            continue
        seen = {what: (res["faults"][fault]["loss_rel"], grad_gap(res["faults"][fault])) for what, res in out.items()}
        if all(lr <= TRAIN_LOSS_RTOL and gr <= TRAIN_GRAD_REL for lr, gr in seen.values()):
            raise AssertionError(f"training kernels vs plain ({what_model}): the limits would pass a kernel with "
                                 f"{fault} (loss rel, gradients: {seen})")
    ts.set_trainable(params, lambda path: False)
    del lora
    return out


# ---------------------------------------------------------------------------
# Phases 17-19: the fp8 (e4m3) KV cache and the manual-copy paged decode (K13)
# ---------------------------------------------------------------------------


def paged_decode_p_e4m3(q, k_pages, v_pages, lengths, page_tables, k_new, v_new, page_offset):
    """K12's plain version with the fault the fp8 slice repaired (phase 17's
    planted fault): p rounded to e4m3, not to q's dtype, for the PV product."""
    import torch

    from omchat_torch.ops import paged_attention as pa
    from omchat_torch.ops.flash_attention import LOG2E
    from omchat_torch.ops.fp8 import to_e4m3

    B, _, H, D = q.shape
    KVH = k_pages.shape[1]
    k, v = pa._gather_pages(k_pages, v_pages, page_tables.long() + page_offset)
    qg = q[:, 0].reshape(B, KVH, H // KVH, D).float()
    s = torch.einsum("bngd,bntd->bngt", qg, k.float()) * (D**-0.5 * LOG2E)
    valid = torch.arange(k.shape[2], device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.tensor(float("-inf"), device=q.device))
    s = torch.cat([s, torch.einsum("bngd,bnd->bng", qg, k_new.float())[..., None] * (D**-0.5 * LOG2E)], dim=-1)
    v = torch.cat([v.to(q.dtype), v_new[:, :, None]], dim=2)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bngt,bntd->bngd", to_e4m3(p).float(), v.float()) / p.sum(dim=-1, keepdim=True)
    return o.reshape(B, 1, H, D).to(q.dtype)


def fp8_kernel_phases(gen, shapes: dict, timed: dict, tc=None, tag: str = "") -> list:
    """Phase 17: K13 over a bf16 and an e4m3 pool and the e4m3 variants of
    K12 and K14 at what the timed serving run (phase 5) handed K12 and K14,
    K2 and K3 on an e4m3 cache at the single request's shapes (phase 2),
    with phase 6's planted keys, held against their plain versions; planted
    faults must fall outside the limits.  The e4m3 stores of K4 and K15
    bitwise at those shapes and on every bf16 bit pattern (the in-kernel
    cast against ``ops.fp8.to_e4m3``).  Times as in phases 2 and 6; the
    library line upcasts the e4m3 operands to bf16 inside the timed call.
    With ``tc`` (phase 43: the Qwen2-0.5B trunk's text config) at that
    trunk's heads, its rows named with ``tag``, without the bit-pattern
    sweep (which does not depend on the heads)."""

    import numpy as np
    import torch
    import torch.nn.functional as F

    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops import decode_attention as da
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import paged_attention as pa
    from omchat_torch.ops.fp8 import E4M3, to_e4m3
    from omchat_torch.runtime.paged_engine import commit_page_ids

    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    i32 = dict(dtype=torch.int32, device=dev)
    tc = tc or OmChatConfig().text
    L, H, KVH, D = tc.num_hidden_layers, tc.num_attention_heads, tc.num_key_value_heads, tc.attn_head_dim
    G = H // KVH
    PS, P = SERVING["page_size"], SERVING["num_pages"]
    NP, LI = P + 1, L - 1
    u = _direction(gen, KVH, D)
    uq = u.repeat_interleave(G, dim=0)
    it = itertools.count()
    rows = []

    def add(name, source, replaces, got, ref, tol, faults, fns, flops, nbytes, shape, iters, warmup=3,
            in_turns=False, graph_calls=0):
        """Check ``got`` against ``ref`` and each planted fault against
        ``ref``; time the kernel, plain and library callables ``fns`` (the
        kernel and library ``in_turns``: medians of ``time_in_turns``, or
        of ``device_times`` over ``graph_calls`` graphed calls)."""
        err = check_close(name, got, ref, *tol)
        caught = {f: check_fault_caught(name, f, bad, ref, *tol) for f, bad in faults.items()}
        k_fn, p_fn, lib_fn = fns
        k_it, p_it = iters
        row = dict(name=name, source=source, replaces=replaces, max_abs_err=err, ref_mean_abs=float(ref.float().abs().mean()),
                   plain_ms=time_ms(p_fn, iters=p_it, warmup=1), faults=caught, shape=shape)
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
        if in_turns:
            ms, readings = (device_times(k_fn, lib_fn, graph_calls) if graph_calls
                            else time_in_turns({"kernel": k_fn, "library": lib_fn}))
            row.update(ms=ms["kernel"], library_ms=ms["library"],
                       rate=rate_text(flops, ms["kernel"], row["bound_ms"], readings["kernel"])
                       + (eager_text(ms) if graph_calls else ""))
        else:
            row.update(ms=time_ms(k_fn, iters=k_it, warmup=warmup),
                       library_ms=time_ms(lib_fn, iters=k_it, warmup=warmup) if lib_fn else None)
        rows.append(row)
        return row

    def upcast(t):
        return t.to(bf) if t.dtype == E4M3 else t

    # The layered pool [L, P+1, KVH, PS, D] in bf16, phase 6's keys planted in
    # layer LI for the busiest decode roll (K12, K13) and the largest chunk
    # (K14), then rounded to e4m3 as the pool stores it.
    kflat, vflat = _randn(gen, L * NP, KVH, PS, D), _randn(gen, L * NP, KVH, PS, D)

    def plant(table_row, pos, scale):
        kflat[LI * NP + int(table_row[pos // PS]), :, pos % PS] = scale * u

    busiest = max(r["n"] for r in timed["rolls"])
    full = [r for r in timed["rolls"] if r["n"] == busiest]
    roll = full[len(full) // 2]
    tab_np, lens_np = roll["tables"], roll["lengths"]
    S, W = tab_np.shape
    for b, n in enumerate(lens_np):
        if n:
            for pos, scale in ((0, 0.6), (n - 1, 0.8), (n, 0.8)):
                plant(tab_np[b], pos, scale)

    def causal_cols(c):
        return sum(int(n) * int(s) + int(n) * (int(n) + 1) // 2 for s, n in zip(c["start"], c["len"]))

    c14 = max(timed["chunks"], key=causal_cols)
    (B14, C), starts, clen, t14_np = c14["shape"], c14["start"], c14["len"], c14["tables"]
    kv14 = starts + clen
    for b in range(B14):
        for pos, scale in ((0, 0.6), (int(kv14[b]) - 1, 0.8)):
            plant(t14_np[b], pos, scale)
    pools = {"bf16": (kflat, vflat), "e4m3": (to_e4m3(kflat), to_e4m3(vflat))}

    # K12 (e4m3) and K13 (bf16, e4m3): the roll's lengths and sliced table; a
    # sink at 0, 0.8 u at the last valid column, the first one past it and
    # the self column.  Faults: one live page-table entry off by one, the self
    # column rounded to e4m3, p rounded to e4m3.
    tab, lens = torch.as_tensor(tab_np, device=dev), torch.as_tensor(lens_np, device=dev)
    bad_tab = tab.clone()
    bad_tab[int(np.argmax(lens_np)), 0] += 1
    q = _randn(gen, S, 1, H, D) + uq
    kn = (0.8 * u)[None].expand(S, KVH, D).contiguous()
    vn = _randn(gen, S, KVH, D)
    kn8, vn8 = to_e4m3(kn).to(bf), to_e4m3(vn).to(bf)
    cached = int(lens_np.sum())
    cols = torch.arange(W * PS + 1, device=dev)
    mask = ((cols[None] < lens[:, None]) | (cols[None] == W * PS))[:, None, None, :]
    qs = q.transpose(1, 2)
    names = {"auto": ("paged_flash_decode", "paged_flash_decode.cu", "omchat_tpu/ops/paged_attention.py:110"),
             "manual": ("paged_flash_decode_manual", "paged_flash_decode_manual.cu",
                        "omchat_tpu/ops/paged_attention.py:270")}
    outs = {}
    for kernel, pool in (("manual", "bf16"), ("auto", "e4m3"), ("manual", "e4m3")):
        kp, vp = pools[pool]
        fn = pa.DECODE_KERNELS[kernel]
        name, src, replaces = names[kernel]

        def plain(tables=tab, k_new=kn, v_new=vn, kp=kp, vp=vp):
            return pa.paged_flash_decode_plain(q, kp, vp, lens, tables, k_new, v_new, page_offset=LI * NP)

        def walk(f, kp=kp, vp=vp):
            return f(q, kp, vp, lens, tab, kn, vn, page_offset=(next(it) % L) * NP)

        def library(kp=kp, vp=vp):  # the pages gathered (and upcast), the self column appended, SDPA
            idx = (tab.long() + (next(it) % L) * NP).reshape(-1)
            kv = [torch.cat([upcast(p.index_select(0, idx)).view(S, W, KVH, PS, D).transpose(1, 2)
                             .reshape(S, KVH, W * PS, D), n[:, :, None]], dim=2) for p, n in ((kp, kn), (vp, vn))]
            return F.scaled_dot_product_attention(qs, *kv, attn_mask=mask, enable_gqa=True)

        out = fn(q, kp, vp, lens, tab, kn, vn, page_offset=LI * NP)
        torch.cuda.synchronize()
        outs[(kernel, pool)] = out
        faults = {"a page-table entry off by one": plain(tables=bad_tab),
                  "the self column rounded to e4m3": plain(k_new=kn8, v_new=vn8),
                  "p rounded to e4m3": paged_decode_p_e4m3(q, kp, vp, lens, tab, kn, vn, LI * NP)}
        add(name if pool == "bf16" else f"{name}[e4m3]", f"omchat_torch/csrc/{src}", replaces, out, plain(),
            ATTN_TOL["K12"], faults, (lambda: walk(fn), lambda: walk(pa.paged_flash_decode_plain), library),
            4.0 * H * D * (cached + S),
            2 * KVH * cached * D * kp.element_size() + 2 * S * H * D * 2 + 2 * S * KVH * D * 2 + S * 4 + S * W * 4,
            f"S={S} decoding={busiest} cached={cached} W={W}", (2 * L, L // 4), in_turns=True, graph_calls=L)
    outs[("auto", "bf16")] = pa.paged_flash_decode(q, *pools["bf16"], lens, tab, kn, vn, page_offset=LI * NP)
    torch.cuda.synchronize()
    splits, chunk = pa.paged_splits(S, KVH, W * PS, torch.cuda.get_device_properties(0).multi_processor_count)
    diffs = {pool: float((outs[("manual", pool)].float() - outs[("auto", pool)].float()).abs().max())
             for pool in ("bf16", "e4m3")}
    log(f"K13 vs K12{tag} on the same inputs (both split-KV: {splits} chunks of {chunk} rows, then a merge), "
        f"max |diff|: "
        f"bf16 pool {diffs['bf16']:.4g}, e4m3 pool {diffs['e4m3']:.4g}")
    if any(not torch.equal(outs[("manual", pool)], outs[("auto", pool)]) for pool in ("bf16", "e4m3")):
        raise AssertionError(f"K13 and K12 must compute the same bits on the same inputs: max |diff| {diffs}")
    del q, qs, kn, vn, kn8, vn8, mask, outs

    # K14 (e4m3): the largest chunk's starts, lengths and tables; faults as phase 6's.
    kp8, vp8 = (p.view(L, NP, KVH, PS, D) for p in pools["e4m3"])
    t14 = torch.as_tensor(t14_np, device=dev)
    q14 = _randn(gen, B14, C, H, D) + uq
    qo, kl = torch.as_tensor(starts, **i32), torch.as_tensor(kv14, **i32)
    rowmask = (torch.arange(C, device=dev)[None] < torch.as_tensor(clen, device=dev)[:, None])[..., None, None]
    out = pa.paged_flash_prefill(q14, kp8[LI], vp8[LI], kl, t14, qo)
    torch.cuda.synchronize()

    def k14_plain(q_offset=qo, kv_len=kl, li=LI):
        return pa.paged_flash_prefill_plain(q14, kp8[li], vp8[li], kv_len, t14, q_offset) * rowmask

    def walk14(fn):
        li = next(it) % L
        return fn(q14, kp8[li], vp8[li], kl, t14, qo)

    T14 = t14_np.shape[1] * PS
    idx14 = t14.long().reshape(-1)
    ar = torch.arange(T14, device=dev)
    mask14 = ((ar[None, None] <= qo[:, None, None] + torch.arange(C, device=dev)[None, :, None])
              & (ar[None, None] < kl[:, None, None]))[:, None]
    q14t = q14.transpose(1, 2)

    def k14_library():
        li = next(it) % L
        kv = [upcast(p[li].index_select(0, idx14)).view(B14, -1, KVH, PS, D).transpose(1, 2)
              .reshape(B14, KVH, T14, D) for p in (kp8, vp8)]
        return F.scaled_dot_product_attention(q14t, *kv, attn_mask=mask14, enable_gqa=True)

    add("paged_flash_prefill[e4m3]", "omchat_torch/csrc/paged_flash_prefill.cu",
        "omchat_tpu/ops/paged_attention.py:442", out * rowmask, k14_plain(), ATTN_TOL["K14"],
        {"the last valid column dropped": k14_plain(kv_len=kl - 1),
         "the causal diagonal shifted by one": k14_plain(q_offset=qo + 1)},
        (lambda: walk14(pa.paged_flash_prefill), lambda: k14_plain(li=next(it) % L), k14_library),
        4.0 * H * D * causal_cols(c14), 2 * B14 * C * H * D * 2 + 2 * KVH * int(kv14.sum()) * D + t14_np.size * 4 + 8 * B14,
        f"B={B14} C={C} q_offset={starts.tolist()} kv_len={kv14.tolist()}", (L, 3))
    del q14, q14t, mask14, rowmask, out

    # K15 (e4m3): the largest page commit, bf16 scratch pages rounded into the
    # e4m3 pool; bitwise against the plain commit, parking pages as phase 6.
    c15 = max(timed["commits"], key=lambda c: c["shape"][1] * c["shape"][3])
    _, B15, _, T15, _ = c15["shape"]
    CH = T15 // PS
    pages15 = torch.as_tensor(commit_page_ids(c15["tables"], c15["n_pages"], L, CH, NP), device=dev)
    view_k = _randn(gen, L, B15, KVH, T15, D).view(L * B15, KVH, CH, PS, D).transpose(1, 2)
    view_v = _randn(gen, L, B15, KVH, T15, D).view(L * B15, KVH, CH, PS, D).transpose(1, 2)
    k8, v8 = pools["e4m3"]
    ref_k, ref_v = k8.clone(), v8.clone()
    pa.commit_pages(k8, v8, pages15, view_k, view_v)
    torch.cuda.synchronize()
    pa.commit_pages_plain(ref_k, ref_v, pages15, view_k, view_v)
    for got, want, chunks in ((k8, ref_k, view_k), (v8, ref_v, view_v)):
        sent_vecs = to_e4m3(chunks).view(torch.uint8).reshape(-1, KVH * PS * D // 8, 8)
        for li in range(L):
            park = li * NP + P
            sent = (pages15 == park).nonzero()[:, 0]
            if len(sent) and not bool((got[park].view(torch.uint8).reshape(1, -1, 8) == sent_vecs[sent])
                                      .all(-1).any(0).all()):
                raise AssertionError(f"K15 commit_pages[e4m3]: parking page {park} holds a vector no chunk sent there")
            want[park] = got[park]
        if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError("K15 commit_pages[e4m3]: the pool differs from the plain commit (bitwise, all pages)")
    M = int(pages15.numel())
    ms, readings = device_times(lambda: pa.commit_pages(k8, v8, pages15, view_k, view_v), None, GRAPH_CALLS)
    row = dict(name="commit_pages[e4m3]", source="omchat_torch/csrc/commit_pages.cu",
               replaces="omchat_tpu/ops/paged_attention.py:695", max_abs_err=0.0, ref_mean_abs=None, faults={},
               ms=ms["kernel"],
               plain_ms=time_ms(lambda: pa.commit_pages_plain(ref_k, ref_v, pages15, view_k, view_v), iters=20),
               library_ms=None, shape=f"M={M} (L={L} x B={B15} x {CH} pages)")
    row["bound_ms"], row["bound_by"] = bound_ms(0.0, 2 * M * KVH * PS * D * (2 + 1) + M * 4)
    row["rate"] = rate_text(0.0, row["ms"], row["bound_ms"], readings["kernel"]) + eager_text(ms)
    rows.append(row)
    del pools, kflat, vflat, k8, v8, kp8, vp8, ref_k, ref_v, view_k, view_v

    # K2 (e4m3): phase 2's prompt against an e4m3 cache layer, phase 2's keys.
    # p is rounded to e4m3 against the running row max in the kernel and the
    # row's global max in the plain version (as the TPU kernel and its XLA
    # reference differ), so the limit is K2_E4M3_TOL, not K2's.
    S2, T, KVL = shapes["prompt_rows"], shapes["cache_rows"], shapes["prompt_len"]
    q2 = _randn(gen, 1, S2, H, D) + uq
    k2, v2 = _randn(gen, 1, KVH, T, D), _randn(gen, 1, KVH, T, D)
    k2[0, :, 0] = 0.6 * u
    k2[0, :, KVL - 1] = 0.8 * u
    k2, v2 = to_e4m3(k2), to_e4m3(v2)
    q_off = torch.zeros(1, **i32)
    kvl = torch.full((1,), KVL, **i32)
    out = fa.flash_attention(q2, k2, v2, causal=True, q_offset=q_off, kv_len=kvl, kv_format="bntd")
    torch.cuda.synchronize()

    def k2_plain(q_offset=q_off, kv_len=kvl):
        return fa.flash_attention_plain(q2, k2, v2, causal=True, q_offset=q_offset, kv_len=kv_len)[:, :KVL]

    q2t = q2[:, :KVL].transpose(1, 2)
    add("flash_attention[e4m3]", "omchat_torch/csrc/flash_attention.cu", "omchat_tpu/ops/flash_attention.py:246",
        out[:, :KVL], k2_plain(), K2_E4M3_TOL,
        {"the last valid column dropped": k2_plain(kv_len=kvl - 1),
         "the causal diagonal shifted by one": k2_plain(q_offset=q_off + 1)},
        (lambda: fa.flash_attention(q2, k2, v2, causal=True, q_offset=q_off, kv_len=kvl, kv_format="bntd"),
         k2_plain, lambda: F.scaled_dot_product_attention(q2t, k2[:, :, :KVL].to(bf), v2[:, :, :KVL].to(bf),
                                                         is_causal=True, enable_gqa=True)),
        4.0 * H * D * sum(min(i + 1, KVL) for i in range(S2)), (2 * q2.numel()) * 2 + 2 * KVH * KVL * D,
        f"S={S2} T={T} kv_len={KVL}", (20, 3), in_turns=True)
    del q2, k2, v2, q2t, out

    # K3 (e4m3): phase 2's decode over an e4m3 stacked cache at the decode
    # lengths, phase 2's keys and faults; K4 (e4m3) commits the step's rows.
    lens3 = shapes["decode_lens"]
    LEN = lens3[0]
    splits, srows, edge = split_edge(1, KVH, T, LEN)
    kc, vc = _randn(gen, L, 1, KVH, T, D), _randn(gen, L, 1, KVH, T, D)
    for row, w in ((0, 0.6), (edge - 1, 0.8), (edge, 0.8), (LEN - 1, 0.8), (LEN, 0.8)):
        kc[:, 0, :, row] = w * u
    kc, vc = to_e4m3(kc), to_e4m3(vc)
    qd = _randn(gen, 1, 1, H, D) + uq
    kn_, vn_ = (0.8 * u)[None], _randn(gen, 1, KVH, D)
    clen = torch.full((1,), LEN, **i32)
    out = da.flash_decode_stacked(qd, kc, vc, clen, L - 1, kn_, vn_)
    torch.cuda.synchronize()

    def k3_plain(cache_len=clen, k_new=kn_):
        return da.flash_decode_stacked_plain(qd, kc, vc, cache_len, L - 1, k_new, vn_)

    clens = [torch.full((1,), n, **i32) for n in lens3]

    def walk3(fn):
        i = next(it)
        return fn(qd, kc, vc, clens[i % len(lens3)], i % L, kn_, vn_)

    qds = qd.transpose(1, 2)

    def k3_library():
        i = next(it)
        li, n = i % L, lens3[i % len(lens3)]
        return F.scaled_dot_product_attention(qds, kc[li][:, :, :n].to(bf), vc[li][:, :, :n].to(bf), enable_gqa=True)

    for _ in range(len(lens3)):  # warm up over every length: the library call plans once per shape
        walk3(da.flash_decode_stacked)
        k3_library()
    mean_len = sum(lens3) / len(lens3)
    add("flash_decode_stacked[e4m3]", "omchat_torch/csrc/flash_decode_stacked.cu",
        "omchat_tpu/ops/decode_attention.py:109", out, k3_plain(), ATTN_TOL["K3"],
        {"cache_len-1": k3_plain(cache_len=clen - 1), "cache_len+1": k3_plain(cache_len=clen + 1),
         "the self column dropped": k3_plain(k_new=-10 * kn_),
         "one split's rows dropped": da.flash_decode_stacked_plain(
             qd, *drop_rows(kc[L - 1:], vc[L - 1:], edge, srows), clen - srows, 0, kn_, vn_)},
        (lambda: walk3(da.flash_decode_stacked), lambda: walk3(da.flash_decode_stacked_plain), k3_library),
        4.0 * H * D * (mean_len + 1), 2 * KVH * (mean_len + 1) * D + 2 * H * D * 2,
        f"T={T} cache_len={lens3[0]}..{lens3[-1]}, {L} layers walked;{split_text(splits, srows, 1, KVH, H)}",
        (None, len(lens3)), in_turns=True, graph_calls=L)

    kf, vf = kc.view(L, KVH, T, D), vc.view(L, KVH, T, D)
    pages = torch.arange(L, **i32)
    offs = torch.full((L,), LEN, **i32)
    k_rows, v_rows = _randn(gen, L, KVH, D, scale=8.0), _randn(gen, L, KVH, D, scale=8.0)
    k_ref, v_ref = kf.clone(), vf.clone()
    pa.commit_rows(kf, vf, pages, offs, k_rows, v_rows)
    torch.cuda.synchronize()
    pa.commit_rows_plain(k_ref, v_ref, pages, offs, k_rows, v_rows)
    if not (torch.equal(kf.view(torch.uint8), k_ref.view(torch.uint8))
            and torch.equal(vf.view(torch.uint8), v_ref.view(torch.uint8))):
        raise AssertionError("K4 commit_rows[e4m3]: cache differs from the plain commit (bitwise, all rows)")
    ms, readings = device_times(lambda: pa.commit_rows(kf, vf, pages, offs, k_rows, v_rows), None, GRAPH_CALLS)
    row = dict(name="commit_rows[e4m3]", source="omchat_torch/csrc/commit_rows.cu",
               replaces="omchat_tpu/ops/paged_attention.py:619", max_abs_err=0.0, ref_mean_abs=None, faults={},
               ms=ms["kernel"],
               plain_ms=time_ms(lambda: pa.commit_rows_plain(k_ref, v_ref, pages, offs, k_rows, v_rows), iters=100),
               library_ms=None, shape=f"N={L} rows into [L, KVH, {T}, D]")
    row["bound_ms"], row["bound_by"] = bound_ms(0.0, 2 * L * KVH * D * (2 + 1) + 2 * L * 4)
    row["rate"] = (rate_text(0.0, row["ms"], row["bound_ms"], readings["kernel"])
                   + f" launch_floor_ms={k4_floor_ms(L, KVH, D):.5f}" + eager_text(ms))
    rows.append(row)
    del kc, vc, kf, vf, k_ref, v_ref

    # The in-kernel cast: every bf16 bit pattern through K4 (as rows) and K15
    # (as a page) into e4m3 pools, against to_e4m3 bitwise (NaN past 464).
    if not tag:
        patterns = torch.arange(-32768, 32768, dtype=torch.int32, device=dev).to(torch.int16).view(bf)
        want = to_e4m3(patterns).view(torch.uint8)
        kp, vp = (torch.zeros(2, KVH, PS, D, dtype=E4M3, device=dev) for _ in range(2))
        prow = patterns.view(PS, KVH, D)
        pa.commit_rows(kp, vp, torch.ones(PS, **i32), torch.arange(PS, **i32), prow, prow)
        pa.commit_pages(kp, vp, torch.zeros(1, **i32), patterns.view(1, KVH, PS, D), patterns.view(1, KVH, PS, D))
        torch.cuda.synchronize()
        cast = {"K4": int((kp[1].transpose(0, 1).reshape(-1).view(torch.uint8) != want).sum()),
                "K15": int((kp[0].reshape(-1).view(torch.uint8) != want).sum())}
        nan_share = float(((want & 0x7F) == 0x7F).float().mean())
        log(f"e4m3 store, every bf16 bit pattern: bytes differing from to_e4m3 {cast} (NaN share {nan_share:.4f})")
        if any(cast.values()):
            raise AssertionError(f"the e4m3 stores differ from to_e4m3 on {cast} of the 65536 bf16 patterns")

    for r in rows:
        r["name"] += tag
        mag = "" if r["ref_mean_abs"] is None else f" ref_mean_abs={r['ref_mean_abs']:.3g}"
        caught = "".join(f"; fault '{f}' max_dev={d:.3g} (caught)" for f, d in r["faults"].items())
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"kernel {r['name']} [{r['shape']}]: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={lib} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}){r.pop('rate', '')} "
            f"max_abs_err={r['max_abs_err']:.3g}{mag}{caught}")
    torch.cuda.empty_cache()
    return rows


def first_divergence(tokens: list, base: list) -> list:
    """Per request, the first step whose greedy token leaves ``base``'s (None: never)."""
    return [next((j for j, (a, b) in enumerate(zip(t, w)) if a != b), None) for t, w in zip(tokens, base)]


def fp8_serving(seed: int, base_tokens: list) -> dict:
    """Phase 18 at full width and depth, one model: phase 5's workload with
    the decode on K13 over the bf16 pool, then on K12 and on K13 over an e4m3
    pool (each must launch its decode kernel and not the other one); each
    run's first step leaving phase 5's greedy tokens; a K13 run must give
    every request the K12 run's tokens on its pool (``base_tokens``, phase
    5's, on bf16); then phase 3's request with an e4m3 cache (K2, K3, K4 on
    their e4m3 variants)."""
    import torch

    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops import paged_attention as pa
    from omchat_torch.ops.fp8 import E4M3
    from omchat_torch.runtime import paged_engine as pe

    gc.collect()
    torch.cuda.empty_cache()
    cfg = OmChatConfig()
    params = build_model(cfg, seed)
    work = serving_workload(cfg)
    decode = {"auto": "paged_flash_decode", "manual": "paged_flash_decode_manual"}
    runs, tokens = {}, {}
    for pool, kernel in (("bf16", "manual"), ("e4m3", "auto"), ("e4m3", "manual")):
        label = f"fp8 serving ({pool} pool, decode_kernel={kernel})"
        eng = pe.PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, decode_kernel=kernel,
                                  cache_dtype=E4M3 if pool == "e4m3" else None, **SERVING)
        rec, undo = record_dispatches(eng)
        counts = {n: c for n, c in paged_counters().items() if n != "paged_flash_decode"}
        counts[decode[kernel]] = pa.DECODE_KERNELS[kernel]
        other = pa.DECODE_KERNELS["manual" if kernel == "auto" else "auto"]
        other.launches = 0
        try:
            res = timed_serving(eng, work, rec, counts, label)
        finally:
            undo()
        tokens[(pool, kernel)] = res.pop("tokens")
        steps = first_divergence(tokens[(pool, kernel)], base_tokens)
        res.update(pool_gib=(eng.k_pool.numel() * eng.k_pool.element_size() * 2) / 2**30,
                   first_divergence_step=min((s for s in steps if s is not None), default=None),
                   divergence_steps=steps, requests_identical_to_bf16_auto=steps.count(None))
        log(f"{label}: pool {res['pool_gib']:.3f} GiB, first step leaving the bf16 K12 run's tokens "
            f"{res['first_divergence_step']} (per request {steps})")
        if other.launches:
            raise AssertionError(f"{label}: the other decode kernel launched {other.launches} times")
        if kernel == "manual":  # K13 computes K12's bits: the same greedy tokens as the K12 run on this pool
            same = first_divergence(tokens[(pool, kernel)], base_tokens if pool == "bf16" else tokens[(pool, "auto")])
            if any(s is not None for s in same):
                raise AssertionError(f"{label}: the tokens leave the {pool} K12 run's (first step per request {same})")
            log(f"{label}: every request's tokens equal the {pool}-pool K12 run's")
        if eng.k_pool.dtype != (E4M3 if pool == "e4m3" else torch.bfloat16):
            raise AssertionError(f"{label}: the pool is {eng.k_pool.dtype}")
        runs[(pool, kernel)] = res
        del eng
        gc.collect()
    torch.cuda.empty_cache()
    e2e8 = end_to_end(seed, model=(cfg, params), label="fp8 e2e (e4m3 cache)", cache_dtype=E4M3)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"serving": runs, "e2e": e2e8}


def fp8_logit_gaps(seed: int) -> dict:
    """Phase 19, full width and 2 ViT + 2 LLM layers: the request's first-token
    logits with an e4m3 cache against a bf16 cache (both on the kernels), and
    through the kernels against ``attn_impl="plain"`` on the e4m3 cache, each
    within FP8_LOGIT_GAP_REL of the bf16 logits' max |logit|; a fault planted
    in K2 (every q head reads the next kv head) must fall outside both."""
    import torch

    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops.fp8 import E4M3
    from omchat_torch.runtime.generate import OmChatEngine

    full = OmChatConfig()
    cfg = dataclasses.replace(full, vision=dataclasses.replace(full.vision, num_hidden_layers=2),
                              text=dataclasses.replace(full.text, num_hidden_layers=2))
    params = build_model(cfg, seed)
    ids, tiles = make_request(cfg, seed)

    def first_logits(impl, cache_dtype):
        eng = OmChatEngine(cfg, params, attn_impl=impl, cache_dtype=cache_dtype, image_cache_size=0)
        logits, _ = eng.prefill(eng.plan([ids]), eng.encode_images(tiles), NEW_TOKENS)
        return logits.float()

    bf16, e4m3, e4m3_plain = first_logits(None, None), first_logits(None, E4M3), first_logits("plain", E4M3)
    k2 = fa.flash_attention

    def next_kv_head(q, k, v, **kw):
        dim = 1 if kw.get("kv_format") == "bntd" else 2
        return k2(q, *(t.view(torch.uint8).roll(1, dims=dim).view(t.dtype) for t in (k, v)), **kw)

    next_kv_head.launches = 0  # K2 counts its launches on the module's flash_attention
    fa.flash_attention = next_kv_head
    try:
        faulty = first_logits(None, E4M3)
    finally:
        fa.flash_attention = k2
    limit = FP8_LOGIT_GAP_REL * float(bf16.abs().max())

    def gap(a, b):
        return float((a - b).abs().max())

    res = {"logits_max_abs": float(bf16.abs().max()), "limit": limit,
           "e4m3_vs_bf16": gap(e4m3, bf16), "e4m3_kernels_vs_plain": gap(e4m3, e4m3_plain),
           "fault_vs_bf16": gap(faulty, bf16), "fault_vs_plain": gap(faulty, e4m3_plain),
           "argmax_equal_e4m3_vs_bf16": bool(torch.equal(e4m3.argmax(-1), bf16.argmax(-1)))}
    log("fp8 logit gaps (2 ViT + 2 LLM layers, full width): " + json.dumps(res))
    for k in ("e4m3_vs_bf16", "e4m3_kernels_vs_plain"):
        if not (torch.isfinite(e4m3).all() and res[k] <= limit):
            raise AssertionError(f"fp8 logits: {k} {res[k]:.4g} outside the limit {limit:.4g}")
    for k in ("fault_vs_bf16", "fault_vs_plain"):
        if res[k] <= limit:
            raise AssertionError(f"fp8 logits: the limit would pass K2 reading the next kv head ({k} {res[k]:.4g})")
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phases 20-23: page sizes 16-64 (C1), K10 (the calibrated w8a8 MLP), K5 (the
# ViT without qk-norm), K6 (decode over a per-layer cache)
# ---------------------------------------------------------------------------


def repage(k, v, ps: int, gen):
    """A logical cache k/v [B, KVH, T, D] (T a multiple of ps) as a pool of
    pages of ``ps`` rows in a shuffled order, and the tables that map it."""
    import torch

    B, KVH, T, D = k.shape
    n = B * T // ps
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(ps)).to(k.device)
    pools = []
    for x in (k, v):
        pages = x.view(B, KVH, T // ps, ps, D).transpose(1, 2).reshape(n, KVH, ps, D)
        pool = torch.empty(pages.shape, dtype=pages.dtype, device=pages.device)  # contiguous, whatever B is
        pool[perm] = pages
        pools.append(pool)
    return pools[0], pools[1], perm.to(torch.int32).view(B, T // ps)


def page_size_kernel_phases(gen, timed: dict) -> list:
    """Phase 20: K12 and K13 (bf16 and e4m3 pools) and K14 (both pools) at
    page sizes 16, 32 and 64 against their plain versions, at what the timed
    serving run (phase 5) handed K12 and K14 — the same logical caches, in
    pages of each size, phase 6's keys planted; a page-table entry off by one
    page must fall outside the limits.  K12 / K13 at page size 32 bitwise
    against 128 on the same logical cache, and each kernel's time at page
    size 64 beside 128's.  Returns the page-size-64 rows of K12 and K14."""
    import numpy as np
    import torch

    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops import paged_attention as pa
    from omchat_torch.ops.fp8 import to_e4m3

    dev = torch.device(DEVICE)
    i32 = dict(dtype=torch.int32, device=dev)
    tc = OmChatConfig().text
    H, KVH, D = tc.num_attention_heads, tc.num_key_value_heads, tc.attn_head_dim
    u = _direction(gen, KVH, D)
    uq = u.repeat_interleave(H // KVH, dim=0)
    rows, times, timed_calls = [], {}, {}

    # K12 / K13: the busiest decode roll's lengths over its table width.
    busiest = max(r["n"] for r in timed["rolls"])
    roll = [r for r in timed["rolls"] if r["n"] == busiest]
    roll = roll[len(roll) // 2]
    lens_np = roll["lengths"]
    S, W = roll["tables"].shape
    T = W * 128
    k, v = _randn(gen, S, KVH, T, D), _randn(gen, S, KVH, T, D)
    for b, n in enumerate(lens_np):
        if n:
            for pos, scale in ((0, 0.6), (n - 1, 0.8), (n, 0.8)):
                k[b, :, pos] = scale * u
    lens = torch.as_tensor(lens_np, device=dev)
    q = _randn(gen, S, 1, H, D) + uq
    kn = (0.8 * u)[None].expand(S, KVH, D).contiguous()
    vn = _randn(gen, S, KVH, D)
    longest = int(np.argmax(lens_np))
    cached = int(lens_np.sum())
    outs = {}
    for ps in (128, 64, 32, 16):
        kp, vp, tab = repage(k, v, ps, gen)
        bad = tab.clone()
        bad[longest, 0] = (bad[longest, 0] + 1) % kp.shape[0]  # one live entry off by one page
        for pool in ("bf16", "e4m3"):
            kpp, vpp = (kp, vp) if pool == "bf16" else (to_e4m3(kp), to_e4m3(vp))
            for kernel, name in (("auto", "K12"), ("manual", "K13")):
                fn = pa.DECODE_KERNELS[kernel]
                out = fn(q, kpp, vpp, lens, tab, kn, vn)
                torch.cuda.synchronize()
                outs[(ps, pool, kernel)] = out
                if pool == "bf16" and ps in (128, 64):  # timed below, graphed
                    timed_calls[(name, ps)] = functools.partial(fn, q, kpp, vpp, lens, tab, kn, vn)
                if ps == 128:
                    continue
                tag = f"{name}[{pool}, page_size={ps}]"
                ref = pa.paged_flash_decode_plain(q, kpp, vpp, lens, tab, kn, vn)
                err = check_close(tag, out, ref, *ATTN_TOL["K12"])
                dev_ = check_fault_caught(tag, "a page-table entry off by one page",
                                          pa.paged_flash_decode_plain(q, kpp, vpp, lens, bad, kn, vn), ref,
                                          *ATTN_TOL["K12"])
                log(f"kernel {tag} [S={S} decoding={busiest} cached={cached} W={T // ps}]: max_abs_err={err:.3g}; "
                    f"fault 'a page-table entry off by one page' max_dev={dev_:.3g} (caught)")
                if ps == 64 and pool == "bf16":
                    if name == "K12":
                        rows.append(dict(name="paged_flash_decode[page_size=64]",
                                         source="omchat_torch/csrc/paged_flash_decode.cu",
                                         replaces="omchat_tpu/ops/paged_attention.py:110", max_abs_err=err,
                                         plain_ms=time_ms(lambda: pa.paged_flash_decode_plain(
                                             q, kpp, vpp, lens, tab, kn, vn), iters=3, warmup=1),
                                         library_ms=None, flops=4.0 * H * D * (cached + S),
                                         bytes=2 * KVH * cached * D * 2 + 2 * S * H * D * 2 + 2 * S * KVH * D * 2
                                         + S * 4 + S * (T // ps) * 4))
        del kp, vp, tab, bad
    # K12 / K13 at page sizes 128 and 64, in turns: a call takes the card less time than the host takes to
    # issue it, so each is read as device time (PAGE_SIZE_GRAPH_CALLS calls graphed) with the eager call beside
    ms, readings = time_in_turns({**{key: graphed(fn, PAGE_SIZE_GRAPH_CALLS) for key, fn in timed_calls.items()},
                                  **{(name, ps, "eager"): fn for (name, ps), fn in timed_calls.items()}})
    for key in timed_calls:
        times[key] = ms[key] / PAGE_SIZE_GRAPH_CALLS
        log(f"{key[0]} at page size {key[1]} (bf16 pool): graphed_ms={times[key]:.4f} "
            f"readings={[round(x / PAGE_SIZE_GRAPH_CALLS, 4) for x in readings[key]]} "
            f"eager_ms={ms[(*key, 'eager')]:.4f}")
    rows[0]["ms"] = times[("K12", 64)]
    del timed_calls
    same = {f"{name}[{pool}]": bool(torch.equal(outs[(32, pool, kernel)], outs[(128, pool, kernel)]))
            for pool in ("bf16", "e4m3") for kernel, name in (("auto", "K12"), ("manual", "K13"))}
    log("K12 / K13 at page size 32 vs 128 on the same logical cache, bitwise equal: " + json.dumps(same))
    if not all(same.values()):
        raise AssertionError(f"page size 32 differs from 128 on the same logical cache: {same}")
    del k, v, q, kn, vn, outs

    # K14: the chunk dispatch with the most causal columns, its starts and lengths.
    def causal_cols(c):
        return sum(int(n) * int(s) + int(n) * (int(n) + 1) // 2 for s, n in zip(c["start"], c["len"]))

    c14 = max(timed["chunks"], key=causal_cols)
    (B, C), starts, clen, t14 = c14["shape"], c14["start"], c14["len"], c14["tables"]
    kv14 = starts + clen
    T = t14.shape[1] * 128
    k, v = _randn(gen, B, KVH, T, D), _randn(gen, B, KVH, T, D)
    for b in range(B):
        k[b, :, 0] = 0.6 * u
        k[b, :, int(kv14[b]) - 1] = 0.8 * u
    q14 = _randn(gen, B, C, H, D) + uq
    qo, kl = torch.as_tensor(starts, **i32), torch.as_tensor(kv14, **i32)
    rowmask = (torch.arange(C, device=dev)[None] < torch.as_tensor(clen, device=dev)[:, None])[..., None, None]
    longest = int(np.argmax(kv14))
    for ps in (128, 64, 32, 16):
        kp, vp, tab = repage(k, v, ps, gen)
        bad = tab.clone()
        bad[longest, 0] = (bad[longest, 0] + 1) % kp.shape[0]
        for pool in ("bf16", "e4m3"):
            kpp, vpp = (kp, vp) if pool == "bf16" else (to_e4m3(kp), to_e4m3(vp))
            if ps == 128:
                if pool == "bf16":
                    times[("K14", 128)] = time_ms(lambda: pa.paged_flash_prefill(q14, kpp, vpp, kl, tab, qo))
                continue
            tag = f"K14[{pool}, page_size={ps}]"
            out = pa.paged_flash_prefill(q14, kpp, vpp, kl, tab, qo) * rowmask
            torch.cuda.synchronize()
            ref = pa.paged_flash_prefill_plain(q14, kpp, vpp, kl, tab, qo) * rowmask
            err = check_close(tag, out, ref, *ATTN_TOL["K14"])
            dev_ = check_fault_caught(tag, "a page-table entry off by one page",
                                      pa.paged_flash_prefill_plain(q14, kpp, vpp, kl, bad, qo) * rowmask, ref,
                                      *ATTN_TOL["K14"])
            log(f"kernel {tag} [B={B} C={C} q_offset={starts.tolist()} kv_len={kv14.tolist()}]: "
                f"max_abs_err={err:.3g}; fault 'a page-table entry off by one page' max_dev={dev_:.3g} (caught)")
            if ps == 64 and pool == "bf16":
                times[("K14", 64)] = time_ms(lambda: pa.paged_flash_prefill(q14, kpp, vpp, kl, tab, qo))
                rows.append(dict(name="paged_flash_prefill[page_size=64]",
                                 source="omchat_torch/csrc/paged_flash_prefill.cu",
                                 replaces="omchat_tpu/ops/paged_attention.py:442", max_abs_err=err,
                                 ms=times[("K14", 64)],
                                 plain_ms=time_ms(lambda: pa.paged_flash_prefill_plain(q14, kpp, vpp, kl, tab, qo),
                                                  iters=3, warmup=1),
                                 library_ms=None, flops=4.0 * H * D * causal_cols(c14),
                                 bytes=2 * B * C * H * D * 2 + 2 * KVH * int(kv14.sum()) * D * 2
                                 + tab.numel() * 4 + 8 * B))
        del kp, vp, tab, bad
    del k, v, q14
    log("page size 64 beside 128, kernel ms (bf16 pool, the same logical caches; K12 / K13 graphed): " + json.dumps(
        {name: {"page_size_128": times[(name, 128)], "page_size_64": times[(name, 64)]}
         for name in ("K12", "K13", "K14")}))
    for r in rows:
        r["bound_ms"], r["bound_by"] = bound_ms(r.pop("flops"), r.pop("bytes"))
        log(f"kernel {r['name']}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms=null "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) max_abs_err={r['max_abs_err']:.3g}")
    torch.cuda.empty_cache()
    return rows


def page_size_serving(seed: int, base_tokens: list) -> dict:
    """Phase 20, serving: phase 5's workload at page_size=64 (384 pages, the
    same pool rows) — tokens/s, every page back, the first step leaving the
    page-size-128 run's tokens; and an engine at a page size no kernel is
    built for (48) must refuse on CUDA before it allocates."""
    import torch

    from omchat_torch.config import OmChatConfig
    from omchat_torch.runtime import paged_engine as pe

    gc.collect()
    torch.cuda.empty_cache()
    cfg = OmChatConfig()
    params = build_model(cfg, seed)
    before = torch.cuda.memory_allocated()
    try:
        pe.PagedBatchEngine(cfg, params, image_cache_size=0, device="cuda",
                            **{**SERVING, "page_size": 48, "prompt_bucket": 96, "prefill_chunk": 960})
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("PagedBatchEngine(page_size=48) on CUDA did not refuse")
    if torch.cuda.memory_allocated() != before:
        raise AssertionError("PagedBatchEngine(page_size=48) allocated before it refused")
    log(f"page_size=48 on CUDA: refused before allocating ({refused})")
    eng = pe.PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, **SERVING_PS64)
    rec, undo = record_dispatches(eng)
    try:
        res = timed_serving(eng, serving_workload(cfg), rec, paged_counters(), "serving (page_size=64)")
    finally:
        undo()
    steps = first_divergence(res.pop("tokens"), base_tokens)
    res.update(first_divergence_step=min((s for s in steps if s is not None), default=None), divergence_steps=steps,
               requests_identical_to_page_size_128=steps.count(None))
    log(f"serving (page_size=64): first step leaving the page-size-128 run's tokens {res['first_divergence_step']} "
        f"(per request {steps})")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def swiglu_calibrate(cfg8, params8, seed: int, label: str = "w8a8 swiglu calibrate") -> dict:
    """Phase 21: ``calibrate_swiglu_scales`` over the quantized trunk (full
    width, 28 layers) on the single request's merged prompt embeddings (its
    valid rows); returns the params with ``swiglu_out_scale`` set."""
    import torch

    from omchat_torch.models.omchat import fuse_embeddings
    from omchat_torch.models.qwen2 import calibrate_swiglu_scales
    from omchat_torch.runtime.generate import OmChatEngine

    ids, tiles = make_request(cfg8, seed)
    eng = OmChatEngine(cfg8, params8, image_cache_size=0)
    plan = eng.plan([ids])
    t = lambda a: torch.as_tensor(a, device=DEVICE)  # noqa: E731
    with torch.no_grad():
        embeds = fuse_embeddings(params8, t(plan.token_ids), t(plan.is_image), t(plan.image_index),
                                 eng.encode_images(tiles))
    n = int(plan.lengths[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm = calibrate_swiglu_scales(params8["language_model"], cfg8.text, embeds[:, :n], t(plan.positions)[:, :n])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    scales = lm["layers"]["mlp"]["swiglu_out_scale"]
    res = {"seconds": secs, "rows": n, "layers": int(scales.numel()),
           "swiglu_out_scale_min_max": [float(scales.min()), float(scales.max())]}
    log(f"{label}: " + json.dumps(res))
    if not (scales.dtype == torch.float32 and torch.isfinite(scales).all() and (scales > 0).all()):
        raise AssertionError("w8a8: calibrated SwiGLU scales are not finite, positive fp32")
    del eng, embeds
    return {**params8, "language_model": lm}


def vit_without_qk_norm(gen, seed: int, shapes: dict) -> tuple:
    """Phase 22: the InternViT-6B geometry (45 layers, d=3200, 25 heads of
    128) with ``qk_normalization=False``, random bf16 weights, on the
    request's 3 tiles: the packed route runs K5 in every layer (ViT ms,
    launches) and is held against the same tower on the plain route.  Then
    K5 against its plain version at (3, 1032, 25*128) valid 1025 and at an
    unpadded (3, 1024, 25*128), keys planted at the mask boundary; planted
    faults (valid_len off by one, no prescale) must fall outside the limits.
    Returns (result, K5's row)."""
    import torch
    import torch.nn.functional as F

    from omchat_torch.config import OmChatConfig
    from omchat_torch.models import intern_vit
    from omchat_torch.ops import flash_attention as fa

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(OmChatConfig().vision, qk_normalization=False)
    params = intern_vit.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed), torch.bfloat16)
    _, tiles = make_request(OmChatConfig(), seed)
    px = torch.as_tensor(tiles, device=DEVICE)
    with torch.no_grad():
        intern_vit.intern_vit_forward(params, cfg, px)  # warm-up
        fa.packed_self_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = intern_vit.intern_vit_forward(params, cfg, px)
        torch.cuda.synchronize()
        vit_ms = (time.perf_counter() - t0) * 1e3
        launches = fa.packed_self_attention.launches
        plain = intern_vit.intern_vit_forward(params, cfg, px, attn_impl="plain")
    diff, top = float((out.float() - plain.float()).abs().max()), float(plain.float().abs().max())
    res = {"tiles": int(px.shape[0]), "layers": cfg.num_hidden_layers, "vit_ms": vit_ms,
           "packed_self_attention_launches": launches, "max_abs_diff_vs_plain_route": diff, "max_abs_plain": top,
           "rel": diff / top}
    log("vit without qk-norm (K5): " + json.dumps(res))
    if not torch.isfinite(out).all() or launches != cfg.num_hidden_layers:
        raise AssertionError(f"vit without qk-norm: non-finite output or {launches} K5 launches")
    if diff > VIT_REL_LIMIT * top:
        raise AssertionError(f"vit without qk-norm: kernels vs plain {diff:.4g} over {VIT_REL_LIMIT} of {top:.4g}")
    del params, out, plain
    torch.cuda.empty_cache()

    # K5 at the path's shape and unpadded: q carries a per-head direction, the
    # keys at the last valid column and the first pad column 0.8 u + 0.6 noise.
    B, SP, VALID = shapes["tiles"], shapes["vit_sp"], shapes["vit_valid"]
    H, D = cfg.num_attention_heads, cfg.head_dim
    HD = H * D
    row = None
    for sp, valid in ((SP, VALID), (SP - 8, SP - 8)):
        u = _direction(gen, HD) * 0.5
        qkv = _randn(gen, B, sp, 3 * HD)
        qkv[..., :HD] += u
        for col in (valid - 1, valid):  # each takes about a quarter of every row's softmax when let in
            if col < sp:
                qkv[:, col, HD:2 * HD] = 2.4 * u + 0.6 * _randn(gen, B, HD)
        q, k, v = qkv.chunk(3, dim=-1)
        out = fa.packed_self_attention(q, k, v, num_heads=H, valid_len=valid)
        torch.cuda.synchronize()

        def plain(valid_len=valid, qq=q, prescaled=False):
            return fa.packed_self_attention_plain(qq, k, v, num_heads=H, valid_len=valid_len,
                                                  prescaled=prescaled)[:, :valid]

        ref = plain()
        tag = f"K5 packed_self_attention [B={B} SP={sp} valid={valid}]"
        err = check_close(tag, out[:, :valid], ref, *ATTN_TOL["K1"])
        faults = {"no prescale": check_fault_caught(tag, "no prescale", plain(prescaled=True), ref, *ATTN_TOL["K1"]),
                  "last valid column dropped": check_fault_caught(tag, "the last valid column dropped",
                                                                  plain(valid_len=valid - 1), ref, *ATTN_TOL["K1"])}
        if valid < sp:
            faults["first pad column let in"] = check_fault_caught(tag, "the first pad column let in",
                                                                   plain(valid_len=valid + 1), ref, *ATTN_TOL["K1"])
        caught = "".join(f"; fault '{f}' max_dev={d:.3g} (caught)" for f, d in faults.items())
        log(f"kernel {tag}: max_abs_err={err:.3g} ref_mean_abs={float(ref.float().abs().mean()):.3g}{caught}")
        if row is None:  # the path's shape: times, library, bound
            qs, ks_, vs_ = (t[:, :valid].reshape(B, valid, H, D).transpose(1, 2) for t in (q, k, v))
            ms, readings = time_in_turns({
                "kernel": lambda: fa.packed_self_attention(q, k, v, num_heads=H, valid_len=valid),
                "library": lambda: F.scaled_dot_product_attention(qs, ks_, vs_)})
            flops = 4.0 * B * H * valid * valid * D
            row = dict(name="packed_self_attention", source="omchat_torch/csrc/packed_qkv_norm_attention.cu",
                       replaces="omchat_tpu/ops/flash_attention.py:624", max_abs_err=err, ms=ms["kernel"],
                       plain_ms=time_ms(plain, iters=5, warmup=1), library_ms=ms["library"])
            row["bound_ms"], row["bound_by"] = bound_ms(flops, qkv.numel() * 2 + B * sp * HD * 2)
            log(f"kernel packed_self_attention: kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_ms={row['library_ms']:.4f} (SDPA) bound_ms={row['bound_ms']:.4f} ({row['bound_by']})"
                + rate_text(flops, row["ms"], row["bound_ms"], readings["kernel"]))
        del qkv, q, k, v, out, ref
    torch.cuda.empty_cache()
    return res, row


def decode_layer_cache(gen, cfg, params, seed: int) -> tuple:
    """Phase 23 on phase 3's model: the request's prefill, then one decode
    step whose layers attend through ``cache_attend`` with one query row —
    the token written into each layer cache, K6 over it (28 launches) —
    against the same step through ``decode_scan`` (K3 with the self column,
    K4) on a copy of the cache; bf16 and e4m3 caches.  Per layer of the real
    cache, K6 (cache_len + 1) against K3 (cache_len, self column) on the same
    q.  Then K6 against its plain version at B=16 ragged lengths (1, 512,
    3189, ...) and at the request's shape, with keys planted at the length
    boundary and at a chunk edge of the split; a cache_len off by one and one
    split's rows dropped must fall outside.  K6's time at the request's
    shape, over ``L`` caches walked in turn, in turns with its SDPA call.
    Returns (result, K6's row)."""
    import torch
    import torch.nn.functional as F

    from omchat_torch.models import qwen2
    from omchat_torch.ops import decode_attention as da
    from omchat_torch.ops.fp8 import E4M3, cast_to
    from omchat_torch.ops.rope import rope_cos_sin
    from omchat_torch.runtime.generate import OmChatEngine
    from omchat_torch.utils.tree import layer_slice

    tc = cfg.text
    lm = params["language_model"]
    L, H, KVH, D = tc.num_hidden_layers, tc.num_attention_heads, tc.num_key_value_heads, tc.attn_head_dim
    ids, tiles = make_request(cfg, seed)
    res, launches = {}, None
    for cache_dtype in (None, E4M3):
        label = "bf16" if cache_dtype is None else "e4m3"
        eng = OmChatEngine(cfg, params, image_cache_size=0, cache_dtype=cache_dtype)
        plan = eng.plan([ids])
        logits, cache = eng.prefill(plan, eng.encode_images(tiles), NEW_TOKENS)
        tok = logits.argmax(-1).to(torch.int32)
        n = int(plan.lengths[0])
        wp = torch.full((1,), n, dtype=torch.int32, device=DEVICE)
        ref_cache = qwen2.KVCache(cache.k.clone(), cache.v.clone())
        ref_logits, _ = eng.decode_step(tok, wp, ref_cache)  # decode_scan: K3 + K4
        # the same step, each layer through cache_attend (S == 1: K6 on the written layer cache)
        with torch.no_grad():
            x = qwen2.embed_tokens(lm, tok[:, None])
            cos, sin = rope_cos_sin(wp[:, None], D, theta=tc.rope_theta, scaling=tc.rope_scaling,
                                    max_position_embeddings=tc.max_position_embeddings, dtype=x.dtype)
            da.flash_decode.launches = 0
            for li in range(L):
                def attend(q, k, v, li=li):
                    return qwen2.cache_attend(None, wp, [n], wp + 1, cache.k[li], cache.v[li], q, k, v)

                x = qwen2.decoder_layer(tc, x, layer_slice(lm["layers"], li), cos, sin, attend)
            got = qwen2.lm_head(lm, tc, qwen2.rms_norm(x, lm["norm"]["scale"], tc.rms_norm_eps))[:, 0]
            torch.cuda.synchronize()
        if launches is None:
            launches = da.flash_decode.launches
        diff, top = float((got - ref_logits).abs().max()), float(ref_logits.abs().max())
        # on an e4m3 cache K6 reads the token rounded to e4m3, K3 its bf16 self column
        limit = (STEP_LOGIT_REL if cache_dtype is None else FP8_LOGIT_GAP_REL) * top
        if not (torch.isfinite(got).all() and diff <= limit):
            raise AssertionError(f"decode step through cache_attend (K6) vs decode_scan (K3) [{label} cache]: "
                                 f"logits differ by {diff:.4g}, over {limit:.4g}")
        # per layer of the real cache: K6 over the written row vs K3 with the self column, on one q;
        # the row's values are ones the cache holds exactly, so both read the same numbers
        q = _randn(gen, 1, 1, H, D)
        kn, vn = (cast_to(_randn(gen, 1, KVH, D), cache.k.dtype).to(torch.bfloat16) for _ in range(2))
        clen = wp.clone()
        worst = 0.0
        for li in range(L):
            k3 = da.flash_decode_stacked(q, ref_cache.k, ref_cache.v, clen, li, kn, vn)
            kw, vw = ref_cache.k[li].clone(), ref_cache.v[li].clone()
            kw[:, :, n], vw[:, :, n] = cast_to(kn, kw.dtype), cast_to(vn, vw.dtype)
            k6 = da.flash_decode(q, kw, vw, clen + 1)
            worst = max(worst, check_close(f"K6 vs K3 + self column, layer {li} [{label} cache]", k6, k3,
                                           *ATTN_TOL["K3"]))
        res[label] = {"step_logits_max_abs_diff": diff, "step_logits_max_abs": top, "k6_vs_k3_max_abs_diff": worst,
                      "argmax_equal": bool(torch.equal(got.argmax(-1), ref_logits.argmax(-1)))}
        del eng, cache, ref_cache, kw, vw
        torch.cuda.empty_cache()
    res["flash_decode_launches"] = launches
    log("decode over the layer cache (K6): " + json.dumps(res))
    if launches != L:
        raise AssertionError(f"K6 launched {launches} times in a {L}-layer decode step through cache_attend")

    # K6 against its plain version: B=16 ragged lengths, keys planted at each
    # length's last valid row and the first row past it, and at a chunk edge.
    lens = [1, 2, 17, 128, 512, 640, 1000, 1024, 1536, 2047, 2048, 2500, 3000, 3188, 3189, 3328]
    B, T = len(lens), 3328
    u = _direction(gen, KVH, D)
    q = _randn(gen, B, 1, H, D) + u.repeat_interleave(H // KVH, dim=0)
    kc, vc = _randn(gen, B, KVH, T, D), _randn(gen, B, KVH, T, D)
    splits16, srows16, _ = split_edge(B, KVH, T, T)
    for b, n in enumerate(lens):
        kc[b, :, 0] = 0.6 * u
        kc[b, :, n - 1] = 0.8 * u
        if n < T:
            kc[b, :, n] = 0.8 * u
        if srows16 < T:
            kc[b, :, srows16 - 1] = kc[b, :, srows16] = 0.8 * u
    cl = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    out = da.flash_decode(q, kc, vc, cl)
    torch.cuda.synchronize()
    ref = da.flash_decode_plain(q, kc, vc, cl)
    err = check_close("K6 flash_decode [B=16 ragged]", out, ref, *ATTN_TOL["K3"])
    faults = {f"cache_len{d:+d}": check_fault_caught("K6", f"cache_len{d:+d}", da.flash_decode_plain(
        q, kc, vc, (cl + d).clamp(1, T)), ref, *ATTN_TOL["K3"]) for d in (-1, 1)}
    log(f"kernel flash_decode [B=16 lengths {lens[0]}..{lens[-1]};{split_text(splits16, srows16, B, KVH, H)}]: "
        f"max_abs_err={err:.3g}" + "".join(f"; fault '{f}' max_dev={d:.3g} (caught)" for f, d in faults.items()))
    del kc, vc, out, ref
    # at the request's shape: one request, length n + 1 of T rows, over L caches walked in
    # turn so that every launch reads from HBM; phase 2's keys, at a chunk edge too
    n = int(wp[0]) + 1
    splits, srows, edge = split_edge(1, KVH, T, n)
    kcs, vcs = _randn(gen, L, 1, KVH, T, D), _randn(gen, L, 1, KVH, T, D)
    for row, w in ((0, 0.6), (edge - 1, 0.8), (edge, 0.8), (n - 1, 0.8), (n, 0.8)):
        kcs[:, 0, :, row] = w * u
    q1 = _randn(gen, 1, 1, H, D) + u.repeat_interleave(H // KVH, dim=0)
    c1 = torch.full((1,), n, dtype=torch.int32, device=DEVICE)
    out = da.flash_decode(q1, kcs[0], vcs[0], c1)
    torch.cuda.synchronize()
    ref = da.flash_decode_plain(q1, kcs[0], vcs[0], c1)
    err = max(err, check_close("K6 flash_decode [B=1]", out, ref, *ATTN_TOL["K3"]))
    faults = {f"cache_len{d:+d}": check_fault_caught("K6", f"cache_len{d:+d}", da.flash_decode_plain(
        q1, kcs[0], vcs[0], c1 + d), ref, *ATTN_TOL["K3"]) for d in (-1, 1)}
    faults["one split's rows dropped"] = check_fault_caught("K6", "one split's rows dropped", da.flash_decode_plain(
        q1, *drop_rows(kcs[0], vcs[0], edge, srows), c1 - srows), ref, *ATTN_TOL["K3"])
    it = iter(range(10**9))
    qs = q1.transpose(1, 2)

    def walk(fn):
        i = next(it) % L
        return fn(q1, kcs[i], vcs[i], c1)

    def library():
        i = next(it) % L
        return F.scaled_dot_product_attention(qs, kcs[i][:, :, :n], vcs[i][:, :, :n], enable_gqa=True)

    ms, readings = device_times(lambda: walk(da.flash_decode), library, L)
    row = dict(name="flash_decode", source="omchat_torch/csrc/flash_decode_stacked.cu",
               replaces="omchat_tpu/ops/decode_attention.py:198", max_abs_err=err, ms=ms["kernel"],
               plain_ms=time_ms(lambda: walk(da.flash_decode_plain)), library_ms=ms["library"])
    flops = 4.0 * H * D * n
    row["bound_ms"], row["bound_by"] = bound_ms(flops, (2 * KVH * n * D + 2 * H * D) * 2 + 4)
    log(f"kernel flash_decode [B=1 T={T} cache_len={n}, {L} caches walked]: kernel_ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} (SDPA over the valid rows) "
        f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})"
        f"{rate_text(flops, row['ms'], row['bound_ms'], readings['kernel'])}"
        f"{split_text(splits, srows, 1, KVH, H)}{eager_text(ms)} max_abs_err={err:.3g}"
        + "".join(f"; fault '{f}' max_dev={d:.3g} (caught)" for f, d in faults.items()))
    del kcs, vcs, out, ref
    torch.cuda.empty_cache()
    return res, row


# ---------------------------------------------------------------------------
# Phase 24: decode as one dispatch (CUDA graphs of the decode step and roll)
# ---------------------------------------------------------------------------


def graph_counters() -> dict:
    """The kernels a single request's decode step launches (K3, K4)."""
    from omchat_torch.ops import decode_attention as da
    from omchat_torch.ops import paged_attention as pa

    return {"flash_decode_stacked": da.flash_decode_stacked, "commit_rows": pa.commit_rows}


def single_request_graphs(seed: int, model: tuple, label: str, cache_dtype=None) -> dict:
    """Phase 24, single request: phase 3's request on ``model`` through an
    engine that replays a CUDA graph a decode step and one that runs the same
    step eagerly (``decode_graphs=False``), through ``generate`` and
    ``generate_ondevice``, in turns (eager, graphed, graphed, eager) after a
    warm-up of each (the graphed one captures there).  Every run's tokens
    must equal the first eager run's bit for bit, and every run must launch
    what it did.  Returns decode tokens/s and step wall ms (medians of the
    two turns), capture ms, launches and peak GiB of each route and API, and
    what the graphed engine's kept decode states hold on the card after
    requests of one, two and three shapes (batch 1, batch 2, batch 1 with a
    longer budget) and after ``release_decode_states``."""
    import numpy as np
    import torch

    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.generate import OmChatEngine

    cfg, params = model
    ids, tiles = make_request(cfg, seed)
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1)
    engines = {graphs: OmChatEngine(cfg, params, image_cache_size=0, cache_dtype=cache_dtype, decode_graphs=graphs)
               for graphs in (False, True)}
    counted = graph_counters()
    capture_ms = None
    for graphs, eng in engines.items():  # warm-up: cuBLAS plans, the kernels' first launches, the capture
        eng.generate([ids], tiles, gen)
        if graphs:
            capture_ms = eng.spans["capture"] * 1e3
    runs, want = {}, None
    for graphs in (False, True, True, False):
        eng = engines[graphs]
        for api in ("generate", "generate_ondevice"):
            for c in counted.values():
                c.launches = 0
            torch.cuda.reset_peak_memory_stats()
            tokens = getattr(eng, api)([ids], tiles, gen).token_ids
            sp = eng.spans
            run = {"decode_tokens_per_s": sp["decode_steps"] / sp["decode"],
                   "step_wall_ms": sp["decode"] / sp["decode_steps"] * 1e3,
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "launches": {n: c.launches for n, c in counted.items() if c.launches}}
            if "capture" in sp:
                raise AssertionError(f"{label}: the graphed engine captured again on a request of a kept shape")
            want = want if want is not None else (tokens, run["launches"])
            if tokens != want[0]:
                raise AssertionError(f"{label}: {api} with decode_graphs={graphs} gave other tokens than the eager "
                                     f"generate: {tokens} vs {want[0]}")
            if run["launches"] != want[1]:
                raise AssertionError(f"{label}: {api} with decode_graphs={graphs} launched {run['launches']}, the "
                                     f"eager generate {want[1]}")
            runs.setdefault(("graphed" if graphs else "eager", api), []).append(run)
    res = {"capture_ms": capture_ms, "new_tokens": len(want[0][0]), "tokens_bitwise_equal": True}
    for (route, api), rs in runs.items():
        mid = lambda k: sorted(r[k] for r in rs)[len(rs) // 2]  # noqa: E731
        res[f"{route}/{api}"] = {"decode_tokens_per_s": mid("decode_tokens_per_s"),
                                 "decode_tokens_per_s_runs": [r["decode_tokens_per_s"] for r in rs],
                                 "step_wall_ms": mid("step_wall_ms"), "peak_mem_gib": max(r["peak_mem_gib"] for r in rs),
                                 "launches": rs[0]["launches"]}
    eng = engines[True]
    engines[False].release_decode_states()
    kept = [torch.cuda.memory_allocated()]
    eng.generate([ids, ids], np.concatenate([tiles, tiles]), gen)
    kept.append(torch.cuda.memory_allocated())
    eng.generate([ids], tiles, GenerationConfig(max_new_tokens=NEW_TOKENS + eng.prompt_bucket, eos_token_id=-1))
    kept.append(torch.cuda.memory_allocated())
    if len(eng._states) != 3:
        raise AssertionError(f"{label}: requests of three shapes left {len(eng._states)} decode states")
    eng.release_decode_states()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    res["kept_states_gib"] = {f"{n} states": (m - base) / 2**30 for n, m in enumerate(kept, 1)}
    if not base < kept[0] < kept[1] < kept[2]:
        raise AssertionError(f"{label}: the kept decode states do not hold and release memory as they should: "
                             f"{res['kept_states_gib']}")
    log(f"decode as one dispatch, single request ({label}): " + json.dumps(res))
    del engines
    torch.cuda.empty_cache()
    return res


def serving_graphs(cfg, params) -> dict:
    """Phase 24, serving: phase 5's workload through ``PagedBatchEngine``
    with greedy rolls replayed from CUDA graphs after ``precompile()`` and
    with every roll eager (``decode_graphs=False``), on K12 and on K13, in
    turns; each run as phase 5's (``timed_serving``: a warm-up, then the
    timed run).  Every request must get the eager run's tokens on the same
    kernel, the graphed runs must replay every roll and launch what the
    eager ones did, and every page must come back."""
    import torch

    from omchat_torch.ops import paged_attention as pa
    from omchat_torch.runtime import paged_engine as pe

    work = serving_workload(cfg)
    res = {}
    for kernel, order in (("auto", (False, True)), ("manual", (True, False))):
        got = {}
        for graphs in order:
            eng = pe.PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, decode_kernel=kernel,
                                      decode_graphs=graphs, **SERVING)
            t0 = time.perf_counter()
            widths = eng.precompile(variants=(pe.PICK_MODES[0],)) if graphs else []  # greedy traffic
            precompile_s = time.perf_counter() - t0
            rec, undo = record_dispatches(eng)
            decode = pa.DECODE_KERNELS[kernel]
            counts = {**{n: c for n, c in paged_counters().items() if n != "paged_flash_decode"},
                      decode.__name__: decode}
            route = "graphed" if graphs else "eager"
            try:
                r = timed_serving(eng, work, rec, counts, f"decode as one dispatch, serving ({route}, "
                                                          f"decode_kernel={kernel})")
            finally:
                undo()
            got[graphs] = r
            res[f"{route}/{kernel}"] = {**{k: r[k] for k in ("tokens_per_s", "ttft_p50_s", "ttft_p99_s",
                                                              "intertoken_p50_s", "intertoken_p99_s",
                                                              "decode_step_wall_ms_16_slots", "rolls_graphed",
                                                              "rolls_eager", "pages_free", "launches")},
                                        "precompile_s": precompile_s if graphs else None, "widths": widths}
            if graphs and (r["rolls_eager"] or not r["rolls_graphed"]):
                raise AssertionError(f"serving ({route}, {kernel}): rolls graphed {r['rolls_graphed']}, "
                                     f"eager {r['rolls_eager']}")
            del eng
            torch.cuda.empty_cache()
        if got[True]["tokens"] != got[False]["tokens"]:
            bad = [i for i, (a, b) in enumerate(zip(got[True]["tokens"], got[False]["tokens"])) if a != b]
            raise AssertionError(f"serving on {kernel}: the graphed rolls gave requests {bad} other tokens than "
                                 f"the eager rolls")
        if got[True]["launches"] != got[False]["launches"]:
            raise AssertionError(f"serving on {kernel}: graphed launches {got[True]['launches']} != eager "
                                 f"{got[False]['launches']}")
    log("decode as one dispatch, serving (16 slots, this call): " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# Phases 25-26: the single-request surface (entry points, generate's options)
# ---------------------------------------------------------------------------


def surface_model(cfg, params, **engine_kw):
    """An ``OmChatModel`` over in-memory params, built as
    ``load_pretrained_model`` builds it (``api.omchat_model``), with the
    ``MockTokenizer`` (no tokenizer files: ids are bytes)."""
    from omchat_torch.api import omchat_model
    from omchat_torch.runtime.generate import OmChatEngine
    from omchat_torch.utils.testing import MockTokenizer

    return omchat_model(MockTokenizer(), OmChatEngine(cfg, params, **engine_kw))


def seeded_image(rng, h: int, w: int):
    import numpy as np
    from PIL import Image

    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def write_video(directory: str, seed: int, n: int) -> None:
    """``n`` synthetic 480x640 frames written by PIL as JPEG files: a seeded
    low-resolution field upsampled (smooth content, as camera frames have)
    with a bright square moving across it."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    base = Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)).resize((640, 480), Image.BILINEAR)
    for i in range(n):
        frame = np.asarray(base).copy()
        x, y = (17 * i) % 560, (11 * i) % 400
        frame[y: y + 80, x: x + 80] = (255, 240, 32)
        Image.fromarray(frame).save(os.path.join(directory, f"frame{i:04d}.jpg"), quality=90)


def surface_run(model, label: str, route, ids, tiles, gen, extra=None, want=None) -> dict:
    """One entry-point run of phase 25: ``engine.generate`` on the same ids
    and tiles first (the reference tokens, and the warm-up of this shape;
    ``want``: the reference, computed by the caller, whose image cache the
    run then keeps), the encoded-image cache emptied, then
    ``route(stream_callback)`` timed; the streamed tokens must equal the
    reference's.  One line: TTFT, decode tokens/s, ViT tiles/s, prefill ms,
    peak GiB, K1-K4 launches."""
    import torch

    from omchat_torch.runtime.feature_cache import ImageFeatureCache

    eng = model.engine
    if want is None:
        want = eng.generate([ids], tiles, gen).token_ids[0]
        eng.image_cache = ImageFeatureCache(eng.image_cache.capacity)
    counted = counters()
    for c in counted.values():
        c.launches = 0
    hits = eng.image_cache.hits
    torch.cuda.reset_peak_memory_stats()
    got = []
    route(got.append)
    sp = dict(eng.spans)
    n_tiles = 0 if tiles is None else int(tiles.shape[0])
    res = {"card": CARD, **(extra or {}), "tiles": n_tiles, "image_tokens": n_tiles * model.config.image_seq_len,
           "prompt_ids": len(ids), "merged_len": int(eng.plan([ids]).lengths[0]), "cache_rows": sp["cache_len"], "new_tokens": len(got),
           "ttft_ms": sp["ttft"] * 1e3, "prefill_ms": sp["prefill"] * 1e3, "vit_ms": sp["encode_images"] * 1e3,
           "vit_tiles_per_s": n_tiles / sp["encode_images"] if n_tiles else None,
           "image_cache_hit": eng.image_cache.hits > hits,
           "decode_tokens_per_s": sp["decode_steps"] / sp["decode"],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": {n: c.launches for n, c in counted.items()}}
    log(f"entry point, {label}: " + json.dumps(res))
    if got != want:
        raise AssertionError(f"{label}: the entry point's tokens {got} differ from engine.generate's {want}")
    if len(got) != gen.max_new_tokens:
        raise AssertionError(f"{label}: {len(got)} tokens, expected {gen.max_new_tokens}")
    res["tokens"] = got
    return res


def entry_points(seed: int, model) -> dict:
    """Phase 25: BASELINE.json configs 2-5 through the entry points at full
    width and depth: a 3-turn chat on one 448x448 image with history
    threaded (turns 2-3 image-cache hits), a 1344x1344 image (1 + 9 tiles),
    three 448x448 images interleaved with text, and a 32-frame video
    (``VIDEO_WRITTEN`` frames written by PIL, sampled by
    ``load_video_frames``, through ``chat_video``); each with K2 checked at
    the video's rows (the last ``VIDEO_CHECK_ROWS`` query rows against their
    plain version)."""
    import tempfile

    import numpy as np

    from omchat_torch.config import GenerationConfig
    from omchat_torch.processing.chat import make_context
    from omchat_torch.processing.video import load_video_frames, process_video_frames, video_prompt
    from omchat_torch.runtime.feature_cache import ImageFeatureCache

    rng = np.random.default_rng(seed)
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1)
    out = {}

    # multi-turn chat: the references first, turn by turn (history from their replies); then, the image
    # cache emptied, the timed turns: turn 1 encodes the image, turns 2-3 must find it in the cache
    image = seeded_image(rng, 448, 448)
    questions = ["What is shown in this picture? Describe it.", "What colours stand out?",
                 "Summarise both answers in one line."]
    history, refs = [], []
    for q in questions:
        inputs = model.processor(q, images=image, history=list(history))
        ids = inputs["input_ids"][0].tolist()
        want = model.engine.generate([ids], inputs["images"], gen).token_ids[0]
        refs.append((q, list(history), ids, inputs["images"], want))
        history.append((q, model.tokenizer.decode(want, skip_special_tokens=True)))
    model.engine.image_cache = ImageFeatureCache(model.engine.image_cache.capacity)
    turns = [surface_run(model, f"multi-turn chat, turn {turn}", lambda cb, q=q, h=h: model.chat(
        q, image=image, history=h, generation=gen, stream_callback=cb), ids, tiles, gen, extra={"turn": turn},
        want=want) for turn, (q, h, ids, tiles, want) in enumerate(refs, 1)]
    hits = sum(r["image_cache_hit"] for r in turns[1:])
    if hits != 2 or turns[0]["image_cache_hit"]:
        raise AssertionError(f"multi-turn chat: image-cache hits on turns 2-3: {hits}, on turn 1: "
                             f"{turns[0]['image_cache_hit']}")
    out["multi-turn chat"] = turns

    # high-res: one 1344x1344 image, the (1344, 1344) grid: 1 + 9 tiles
    big = seeded_image(rng, 1344, 1344)
    inputs = model.processor("Describe every region of this picture.", images=big)
    out["high-res"] = surface_run(model, "high-res 1344x1344", lambda cb: model.chat(
        "Describe every region of this picture.", image=big, generation=gen, stream_callback=cb),
        inputs["input_ids"][0].tolist(), inputs["images"], gen)
    if model.config.vision.image_size == 448 and out["high-res"]["tiles"] != 10:
        raise AssertionError(f"high-res: {out['high-res']['tiles']} tiles, the (1344, 1344) grid gives 1 + 9")

    # multi-image interleave: three 448x448 images with text between the sentinels
    imgs = [seeded_image(rng, 448, 448) for _ in range(3)]
    text = "First: <image> then the second: <image> and the last: <image> What changes from one to the next?"
    inputs = model.processor(text, images=imgs)
    out["multi-image"] = surface_run(model, "multi-image interleave (3 images)", lambda cb: model.chat(
        text, image=imgs, generation=gen, stream_callback=cb), inputs["input_ids"][0].tolist(), inputs["images"],
        gen)

    # video: VIDEO_WRITTEN frames on disk, 32 sampled, one tile and sentinel a frame
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        write_video(d, seed, VIDEO_WRITTEN)
        frames = load_video_frames(d, num_samples=VIDEO_FRAMES)
        load_s = time.perf_counter() - t0
    question = "What happens in this video?"
    t0 = time.perf_counter()
    tiles = process_video_frames(frames, tile_size=model.config.vision.image_size, num_samples=VIDEO_FRAMES)
    host_prep_s = time.perf_counter() - t0
    _, ids = make_context(model.tokenizer, video_prompt(question, tiles.shape[0]), None,
                          "You are a helpful assistant.")
    res = surface_run(model, f"video ({VIDEO_FRAMES} frames)", lambda cb: model.chat_video(
        question, frames, num_samples=VIDEO_FRAMES, generation=gen, stream_callback=cb), ids, tiles, gen,
        extra={"frames_written": VIDEO_WRITTEN, "write_and_load_s": load_s, "host_preprocess_s": host_prep_s})
    res["prefill_share_of_ttft"] = res["prefill_ms"] / res["ttft_ms"]
    log(f"entry point, video: prefill share of TTFT {res['prefill_share_of_ttft']:.4f} ({CARD})")
    out["video"] = res
    out["video_frames"] = frames
    return out


def video_k2_rows(gen, rows: int, kv_len: int) -> dict:
    """K2 at the video prompt's shape (``rows`` query rows over as many cache
    rows, ``kv_len`` valid): the kernel over all rows, its last
    ``VIDEO_CHECK_ROWS`` query rows against the plain version over those
    rows (the plain version over every row needs the full score matrix,
    122 GB), keys planted at the last valid column; timed beside SDPA."""
    import torch
    import torch.nn.functional as F

    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops import flash_attention as fa

    cfg = OmChatConfig().text
    H, KVH, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.attn_head_dim
    u = _direction(gen, KVH, D)
    q = _randn(gen, 1, rows, H, D) + u.repeat_interleave(H // KVH, dim=0)
    k, v = _randn(gen, 1, KVH, rows, D), _randn(gen, 1, KVH, rows, D)
    k[0, :, kv_len - 1] = 0.8 * u
    zero = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    kvl = torch.full((1,), kv_len, dtype=torch.int32, device=DEVICE)
    out = fa.flash_attention(q, k, v, causal=True, q_offset=zero, kv_len=kvl, kv_format="bntd")
    torch.cuda.synchronize()
    n = VIDEO_CHECK_ROWS
    start = kv_len - n
    qo = torch.full((1,), start, dtype=torch.int32, device=DEVICE)
    ref = fa.flash_attention_plain(q[:, start:kv_len], k, v, causal=True, q_offset=qo, kv_len=kvl)
    err = check_close("K2 at the video's rows", out[:, start:kv_len], ref, *ATTN_TOL["K2"])
    fault = check_fault_caught("K2 at the video's rows", "the last valid column dropped", fa.flash_attention_plain(
        q[:, start:kv_len], k, v, causal=True, q_offset=qo, kv_len=kvl - 1), ref, *ATTN_TOL["K2"])
    qt = q[:, :kv_len].transpose(1, 2)
    ms, readings = time_in_turns({
        "kernel": lambda: fa.flash_attention(q, k, v, causal=True, q_offset=zero, kv_len=kvl, kv_format="bntd"),
        "library": lambda: F.scaled_dot_product_attention(qt, k[:, :, :kv_len], v[:, :, :kv_len], is_causal=True,
                                                          enable_gqa=True)})
    flops = 4.0 * H * D * kv_len * (kv_len + 1) / 2
    b_ms, by = bound_ms(flops, (2 * q.numel() + 2 * KVH * kv_len * D) * 2)
    res = {"card": CARD, "rows": rows, "kv_len": kv_len, "checked_rows": n, "max_abs_err": err,
           "fault_last_column_dropped": fault, "kernel_ms": ms["kernel"], "library_ms": ms["library"],
           "bound_ms": b_ms, "bound_by": by, "share_of_bound": b_ms / ms["kernel"],
           "readings": [round(x, 4) for x in readings["kernel"]]}
    log("kernel K2 at the video's rows (causal, one prompt): " + json.dumps(res))
    del q, k, v, out, ref, qt
    torch.cuda.empty_cache()
    return res


def surface_kernel_rows(gen, prompt_len: int, video_len: int) -> list:
    """Phase 26's kernel rows: K2 at a verify step's 9 rows at ``q_offset =
    prompt_len`` (3328-row cache), K3 at B = 4 (a beam search, 3328 rows) and
    at B = 1 over the video's cache, each held against its plain version
    with planted keys and faults, timed beside the library call (K3 read
    graphed), with their bounds."""
    import torch
    import torch.nn.functional as F

    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops import decode_attention as da
    from omchat_torch.ops import flash_attention as fa

    cfg = OmChatConfig().text
    H, KVH, D, L = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.attn_head_dim, cfg.num_hidden_layers
    rows = []

    # K2, S = 1 + draft_len rows at the prompt's end; keys planted on each row's causal edge and one past it
    S, T = SPEC_DRAFT + 1, 3328
    u = _direction(gen, KVH, D)
    q = _randn(gen, 1, S, H, D) + u.repeat_interleave(H // KVH, dim=0)
    k, v = _randn(gen, 1, KVH, T, D), _randn(gen, 1, KVH, T, D)
    k[0, :, prompt_len: prompt_len + S + 1] = 0.8 * u[:, None]
    qo = torch.full((1,), prompt_len, dtype=torch.int32, device=DEVICE)
    kvl = qo + S
    kw = dict(causal=True, q_offset=qo, kv_len=kvl)
    out = fa.flash_attention(q, k, v, kv_format="bntd", **kw)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k, v, **kw)
    err = check_close("K2 verify rows", out, ref, *ATTN_TOL["K2"])
    faults = {"causal edge one column late": check_fault_caught(
        "K2 verify rows", "the causal edge one column late",
        fa.flash_attention_plain(q, k, v, causal=True, q_offset=qo + 1, kv_len=kvl + 1), ref, *ATTN_TOL["K2"])}
    p_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), iters=5, warmup=1)
    qt = q.transpose(1, 2)
    mask = (torch.arange(prompt_len + S, device=DEVICE)[None, :]
            <= (prompt_len + torch.arange(S, device=DEVICE))[:, None])
    ms, readings = device_times(lambda: fa.flash_attention(q, k, v, kv_format="bntd", **kw),
                                lambda: F.scaled_dot_product_attention(qt, k[:, :, :prompt_len + S],
                                                                       v[:, :, :prompt_len + S], attn_mask=mask,
                                                                       enable_gqa=True), GRAPH_CALLS)
    cols = sum(prompt_len + i + 1 for i in range(S))
    rows.append(dict(name=f"flash_attention[S={S},q_offset={prompt_len}]", source="omchat_torch/csrc/flash_attention.cu",
                     replaces="omchat_tpu/ops/flash_attention.py:246", max_abs_err=err, ms=ms["kernel"],
                     plain_ms=p_ms, library_ms=ms["library"], flops=4.0 * H * D * cols,
                     bytes=(2 * q.numel() + 2 * KVH * (prompt_len + S) * D) * 2, faults=faults,
                     readings=readings["kernel"], extra=eager_text(ms)))
    del q, k, v, out, ref, qt

    # K3 at a beam search's B = 4 and at the video's length
    for name, B, T, lens in (("flash_decode_stacked[B=4]", 4, 3328, [prompt_len] * 4),
                             ("flash_decode_stacked[video]", 1, round_up(video_len + 1, 128), [video_len])):
        splits, srows, edge = split_edge(B, KVH, T, lens[0])
        kc, vc = _randn(gen, L, B, KVH, T, D), _randn(gen, L, B, KVH, T, D)
        u = _direction(gen, KVH, D)
        qd = _randn(gen, B, 1, H, D) + u.repeat_interleave(H // KVH, dim=0)
        for row, w in ((0, 0.6), (edge - 1, 0.8), (edge, 0.8), (lens[0] - 1, 0.8), (lens[0], 0.8)):
            kc[:, :, :, row] = w * u
        kn_, vn_ = (0.8 * u)[None].expand(B, KVH, D).contiguous(), _randn(gen, B, KVH, D)
        clen = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        out = da.flash_decode_stacked(qd, kc, vc, clen, L - 1, kn_, vn_)
        torch.cuda.synchronize()
        ref = da.flash_decode_stacked_plain(qd, kc, vc, clen, L - 1, kn_, vn_)
        err = check_close(name, out, ref, *ATTN_TOL["K3"])
        faults = {"cache_len-1": check_fault_caught(name, "cache_len-1", da.flash_decode_stacked_plain(
            qd, kc, vc, clen - 1, L - 1, kn_, vn_), ref, *ATTN_TOL["K3"]),
                  "one split's rows dropped": check_fault_caught(name, "one split's rows dropped",
                                                                 da.flash_decode_stacked_plain(
                      qd, *drop_rows(kc[L - 1:], vc[L - 1:], edge, srows), clen - srows, 0, kn_, vn_), ref,
                      *ATTN_TOL["K3"])}
        it = iter(range(10**9))
        qs = qd.transpose(1, 2)

        def library_decode():
            li = next(it) % L
            return F.scaled_dot_product_attention(qs, kc[li][:, :, :lens[0]], vc[li][:, :, :lens[0]],
                                                  enable_gqa=True)

        p_ms = time_ms(lambda: da.flash_decode_stacked_plain(qd, kc, vc, clen, next(it) % L, kn_, vn_), iters=L,
                       warmup=2)
        ms, readings = device_times(lambda: da.flash_decode_stacked(qd, kc, vc, clen, next(it) % L, kn_, vn_),
                                    library_decode, L)
        rows.append(dict(name=name, source="omchat_torch/csrc/flash_decode_stacked.cu",
                         replaces="omchat_tpu/ops/decode_attention.py:109", max_abs_err=err, ms=ms["kernel"],
                         plain_ms=p_ms, library_ms=ms["library"], flops=4.0 * B * H * D * (lens[0] + 1),
                         bytes=(2 * B * KVH * (lens[0] + 1) * D + 2 * B * H * D) * 2, faults=faults,
                         readings=readings["kernel"], extra=split_text(splits, srows, B, KVH, H) + eager_text(ms)))
        del kc, vc, out, ref
        torch.cuda.empty_cache()

    for r in rows:
        flops = r.pop("flops")
        r["bound_ms"], r["bound_by"] = bound_ms(flops, r.pop("bytes"))
        caught = "".join(f"; fault '{f}' max_dev={d:.3g} (caught)" for f, d in r.pop("faults").items())
        log(f"kernel {r['name']}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']})"
            f"{rate_text(flops, r['ms'], r['bound_ms'], r.pop('readings'))}{r.pop('extra')} "
            f"max_abs_err={r['max_abs_err']:.3g}{caught} ({CARD})")
    return rows


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def sampling_on_the_graph(model, ids, tiles) -> dict:
    """Phase 26, sampling: ``generate_ondevice(do_sample=True,
    temperature=0.8, top_k=50)`` twice from one seed on the graphed engine
    and once through ``generate`` on an eager engine (its raw logits read a
    step): the three token lists bitwise equal, every sampled token in its
    step's top 50, one replay a step; tokens/s beside the greedy graphed
    step's."""
    import torch

    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.generate import OmChatEngine

    eng = model.engine
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1, do_sample=True, temperature=0.8, top_k=50)
    greedy = GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1)
    eager = OmChatEngine(model.config, eng.params, image_cache_size=0, decode_graphs=False, device=DEVICE)
    logits = []
    want = eager.generate([ids], tiles, gen, rng_key=SAMPLE_SEED,
                          logits_callback=lambda step, lg: logits.append(lg[0].clone())).token_ids[0]
    outside = [t for t, (tok, lg) in enumerate(zip(want, logits)) if tok not in torch.topk(lg, 50).indices.tolist()]
    runs, rates = [], []
    for _ in range(2):
        got = eng.generate_ondevice([ids], tiles, gen, rng_key=SAMPLE_SEED)
        runs.append(got.token_ids[0])
        rates.append(eng.spans["decode_steps"] / eng.spans["decode"])
    st = eng._states[next(k for k in eng._states if k[0] == 1 and k[1] == eng.spans["cache_len"])]
    run = st.runs[(True, False)]
    replays = run.replays
    eng.generate_ondevice([ids], tiles, gen, rng_key=SAMPLE_SEED)
    steps = eng.spans["decode_steps"]
    replay_delta = run.replays - replays
    eng.generate_ondevice([ids], tiles, greedy)
    res = {"card": CARD, "new_tokens": len(want), "tokens_bitwise_equal": runs[0] == runs[1] == want,
           "outside_top50": outside, "sampled_decode_tokens_per_s": rates,
           "greedy_decode_tokens_per_s": eng.spans["decode_steps"] / eng.spans["decode"],
           "replays_per_step": replay_delta / steps, "distinct_tokens": len(set(want))}
    log("options, sampling on the graph (generate_ondevice, T=0.8, top-k 50, one seed): " + json.dumps(res))
    if not res["tokens_bitwise_equal"]:
        raise AssertionError(f"sampling: graphed runs {runs} and the eager run {want} differ")
    if outside:
        raise AssertionError(f"sampling: steps {outside} drew a token outside their top 50")
    if replay_delta != steps:
        raise AssertionError(f"sampling: {replay_delta} replays for {steps} steps")
    del eager
    return res


def bias_penalties_logprobs(model, ids, tiles) -> dict:
    """Phase 26: a +100 bias on one token (not eos) gives it at every step; a
    frequency penalty of 2.0 lowers the count of the greedy run's most
    repeated token; each chosen log-prob equals log_softmax of that step's
    biased logits within 1e-3."""
    import torch

    from omchat_torch.config import GenerationConfig

    eng = model.engine
    gen = GenerationConfig(max_new_tokens=PENALTY_TOKENS, eos_token_id=-1)
    forced = eng.generate([ids], tiles, GenerationConfig(max_new_tokens=16, eos_token_id=-1),
                          logit_bias={BIAS_TOKEN: 100.0}).token_ids[0]
    base = eng.generate([ids], tiles, gen).token_ids[0]
    top, count = max(((t, base.count(t)) for t in set(base)), key=lambda tc: tc[1])
    pen = eng.generate([ids], tiles, GenerationConfig(max_new_tokens=PENALTY_TOKENS, eos_token_id=-1,
                                                      frequency_penalty=2.0)).token_ids[0]
    logits = []
    bias = {LOGPROB_BIAS_TOKEN: 3.0}
    out = eng.generate([ids], tiles, GenerationConfig(max_new_tokens=16, eos_token_id=-1), logit_bias=bias,
                       return_logprobs=True, top_logprobs=5, logits_callback=lambda s, lg: logits.append(lg[0]))
    gaps = []
    for tok, lp, lg in zip(out.token_ids[0], out.logprobs[0], logits):
        lg = lg.clone()
        lg[LOGPROB_BIAS_TOKEN] += 3.0
        gaps.append(abs(float(torch.log_softmax(lg, -1)[tok]) - lp))
    res = {"card": CARD, "bias_token": BIAS_TOKEN, "biased_tokens": forced,
           "greedy_most_repeated": [top, count], "with_frequency_penalty_2": pen.count(top),
           "logprob_max_gap": max(gaps), "top_logprobs_first": out.top_logprobs[0][0]}
    log("options, bias / penalties / logprobs: " + json.dumps(res))
    if forced != [BIAS_TOKEN] * 16:
        raise AssertionError(f"bias: +100 on {BIAS_TOKEN} gave {forced}")
    if count < 2 or pen.count(top) >= count:
        raise AssertionError(f"frequency penalty: the greedy run's most repeated token {top} ({count} times) "
                             f"appears {pen.count(top)} times with the penalty")
    if max(gaps) > 1e-3:
        raise AssertionError(f"logprobs: {max(gaps):.3g} from log_softmax of the biased logits")
    return res


def constrained_on_the_card(model) -> dict:
    """Phase 26: ``guided_choices`` returns one of them; ``json_mode``'s
    output is a prefix the automaton accepts (parsed when it closed);
    ``chat_tools(tool_choice="required")`` returns a well-formed call."""
    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.json_mode import get_json_mode

    tok = model.tokenizer
    choices = ["yes", "no", "maybe"]
    choice = model.chat("Is the sky green? Answer yes, no or maybe.", guided_choices=choices,
                        generation=GenerationConfig(max_new_tokens=8, eos_token_id=-1))
    ids = []
    text = model.chat("Describe a cat as a JSON object.", json_mode=True, stream_callback=ids.append,
                      generation=GenerationConfig(max_new_tokens=JSON_TOKENS, eos_token_id=-1))
    fn = get_json_mode(tok).mask_fn()
    rejected = [i for i in range(len(ids)) if fn(ids[:i]) is None or ids[i] not in set(fn(ids[:i]).tolist())]
    closed = fn(ids) is None
    parsed = None
    if closed:
        parsed = json.loads(text)
    tools = [{"type": "function", "function": {"name": "set_unit", "parameters": {
        "type": "object", "properties": {"unit": {"type": "string", "enum": ["celsius", "fahrenheit"]},
                                         "rounded": {"type": "boolean"}}, "required": ["unit", "rounded"]}}},
             {"type": "function", "function": {"name": "stop", "parameters": {"type": "object", "properties": {}}}}]
    call = model.chat_tools("Switch to celsius.", tools, tool_choice="required",
                            generation=GenerationConfig(max_new_tokens=64, eos_token_id=-1))
    res = {"card": CARD, "guided_choice": choice, "json_mode": text, "json_closed": closed,
           "json_tokens": len(ids), "json_rejected_steps": rejected, "tool_call": call}
    log("options, constrained decoding: " + json.dumps(res))
    if choice not in choices:
        raise AssertionError(f"guided_choices returned {choice!r}")
    if rejected or not text.startswith("{"):
        raise AssertionError(f"json_mode: steps {rejected} the automaton rejects, output {text!r}")
    if not call["tool_calls"]:
        raise AssertionError(f"chat_tools(required): no tool call in {call}")
    fc = call["tool_calls"][0]["function"]
    if fc["name"] not in ("set_unit", "stop") or not isinstance(json.loads(fc["arguments"]), dict):
        raise AssertionError(f"chat_tools(required): malformed call {call}")
    del parsed
    return res


def chunked_prefill_on_the_card(cfg, params, ids, tiles) -> dict:
    """Phase 26: ``prefill_chunked`` (chunk 1024) against the one-shot
    prefill at the single request's shape, on a bf16 and an e4m3 cache:
    last-token logits within phase 4's limits, the cache rows of the prompt
    within K2's check limits (per layer, the largest gap printed)."""
    import torch

    from omchat_torch.ops.fp8 import E4M3
    from omchat_torch.runtime.generate import OmChatEngine

    res = {"card": CARD}
    for label, dtype in (("bf16", None), ("e4m3", E4M3)):
        eng = OmChatEngine(cfg, params, image_cache_size=0, cache_dtype=dtype, device=DEVICE)
        plan = eng.plan([ids])
        feats = eng.encode_images(tiles)
        one, full = eng.prefill(plan, feats, NEW_TOKENS)
        got, cache = eng.prefill_chunked(plan, feats, NEW_TOKENS, chunk_size=CHUNK)
        n = int(plan.lengths[0])
        gaps = [max(float((cache.k[li, :, :, :n].float() - full.k[li, :, :, :n].float()).abs().max()),
                    float((cache.v[li, :, :, :n].float() - full.v[li, :, :, :n].float()).abs().max()))
                for li in range(cfg.text.num_hidden_layers)]
        err = check_close(f"chunked prefill logits ({label})", got, one, LOGITS_ATOL, LOGITS_RTOL)
        atol, rtol = ATTN_TOL["K2"] if dtype is None else K2_E4M3_TOL
        for t, f in ((cache.k, full.k), (cache.v, full.v)):
            check_close(f"chunked prefill cache rows ({label})", t[:, :, :, :n], f[:, :, :, :n], atol, rtol)
        res[label] = {"prompt_rows": n, "chunks": round_up(plan.max_len, CHUNK) // CHUNK, "cache_rows": cache.max_len,
                      "logits_max_abs_err": err, "argmax_equal": bool(torch.equal(got.argmax(-1), one.argmax(-1))),
                      "cache_max_gap_by_layer": [round(g, 5) for g in gaps]}
        del eng, full, cache
        torch.cuda.empty_cache()
    log(f"options, chunked prefill (chunk {CHUNK}) vs one-shot: " + json.dumps(res))
    return res


def verify_logit_gaps(verify: list, step_logits: list, greedy: list, got: list, plen: int):
    """The speculative verify rows against the decode steps' logits: a
    verify row's logits are a decode step's while the speculative run's
    tokens before the step (``got``), the row's input and every row's input
    before it are the greedy run's tokens.  Returns (rows compared, max
    |gap|, logits outside phase 4's limits)."""
    worst, rows, outside = 0.0, 0, 0
    for kv, toks, lg in verify:
        n = kv - plen + 1  # tokens generated before this verify step
        if got[: n - 1] != greedy[: n - 1]:
            break
        for r, t in enumerate(toks):
            if n + r >= len(step_logits) or t != greedy[n - 1 + r]:
                break
            got_r, ref = lg[r].float(), step_logits[n + r].float()
            worst = max(worst, float((got_r - ref).abs().max()))
            outside += int(((got_r - ref).abs() > LOGITS_ATOL + LOGITS_RTOL * ref.abs()).sum())
            rows += 1
    return rows, worst, outside


def counted_from_first_verify(counted: dict, rec: dict = None):
    """Wrap ``speculative.verify_step`` so that its first call sets the
    counts of ``counted`` (name → counted wrapper) to 0 and empties ``rec``
    (a ``record_w8a8_launches`` record): read after the run, they are the
    verify steps' launches alone, the prefill's left out.  Returns a function
    that restores ``verify_step``."""
    from omchat_torch.runtime import speculative as sp

    verify, first = sp.verify_step, [True]

    def counting(*a, **kw):
        if first[0]:
            first[0] = False
            for c in counted.values():
                c.launches = 0
            for d in (rec or {}).values():
                d.clear()
        return verify(*a, **kw)

    sp.verify_step = counting
    return lambda: setattr(sp, "verify_step", verify)


def verify_faults(verify) -> dict:
    """Wrong verify routes that phase 26's 2+2-layer limits must catch:
    ``verify_step`` off by one where a port could be."""
    import torch

    return {
        "the rows written and read one position late (write_pos + 1)":
            lambda eng, toks, wp, cache: verify(eng, toks, wp + 1, cache),
        "the draft fed one row late": lambda eng, toks, wp, cache: verify(
            eng, torch.cat([toks[:, :1], toks[:, :-1]], 1), wp, cache),
    }


def route_logits(engine, ids, feats, toks: list) -> dict:
    """The logits after each of ``toks`` (the greedy continuation of
    ``ids``) on three routes of ``engine``'s trunk, [len(toks), V] fp32
    each: one speculative verify step over all of them ("verify", K2 at
    len(toks) rows past ``q_offset``), one decode step a token ("decode",
    K3 and K4) and, for each token, a one-shot prefill of the prompt and the
    tokens up to it ("prefill", K2 over the whole prompt)."""
    import torch

    from omchat_torch.runtime.speculative import verify_step

    dev = engine.device
    plan = engine.plan([ids])
    plen = int(plan.lengths[0])
    _, cache = engine.prefill(plan, feats, len(toks) + 1)
    verify = verify_step(engine, torch.tensor([toks], dtype=torch.int32, device=dev),
                         torch.tensor([plen], dtype=torch.int32, device=dev), cache)[0]
    _, cache = engine.prefill(plan, feats, len(toks) + 1)
    decode = []
    for r, t in enumerate(toks):
        lg, cache = engine.decode_step(torch.tensor([t], dtype=torch.int32, device=dev),
                                       torch.tensor([plen + r], dtype=torch.int32, device=dev), cache)
        decode.append(lg[0])
    prefill = [engine.prefill(engine.plan([list(ids) + toks[: r + 1]]), feats, 0)[0][0] for r in range(len(toks))]
    return {"verify": verify.float(), "decode": torch.stack(decode).float(), "prefill": torch.stack(prefill).float()}


def c4_route_gaps(model, ids, tiles) -> dict:
    """C4 (ROADMAP §C): at full depth in bf16, the logits of the same
    ``1 + SPEC_DRAFT`` greedy tokens of phase 3's request on the three
    routes of ``route_logits`` (a verify step of that many rows, a decode
    step a token, a one-shot prefill of the prompt and the tokens), read on
    the kernels and on ``attn_impl="plain"`` over the same weights and image
    features.  Prints ``C4, route gaps at full depth (kernels | plain)``:
    each pair of routes' max |logit| gap on both, the kernels' gap over the
    plain one's, and each route's kernels-vs-plain gap."""
    import torch

    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.generate import OmChatEngine

    eng = model.engine
    n = 1 + SPEC_DRAFT
    toks = eng.generate([ids], tiles, GenerationConfig(max_new_tokens=n, eos_token_id=-1)).token_ids[0]
    feats = eng.encode_images(tiles)
    plain = OmChatEngine(model.config, eng.params, attn_impl="plain", image_cache_size=0, device=DEVICE)
    routes = {"kernels": route_logits(eng, ids, feats, toks), "plain": route_logits(plain, ids, feats, toks)}
    del plain
    pairs = (("verify", "decode"), ("verify", "prefill"), ("prefill", "decode"))
    gap = lambda a, b: float((a - b).abs().max())  # noqa: E731
    res = {"card": CARD, "rows": n, "max_abs_logit": float(routes["plain"]["decode"].abs().max())}
    for a, b in pairs:
        k, p = gap(routes["kernels"][a], routes["kernels"][b]), gap(routes["plain"][a], routes["plain"][b])
        res[f"{a} vs {b}"] = {"kernels": k, "plain": p, "kernels_over_plain": k / p if p else None}
    res["kernels vs plain, same route"] = {r: gap(routes["kernels"][r], routes["plain"][r])
                                           for r in ("verify", "decode", "prefill")}
    res["largest plain gap"] = max(res[f"{a} vs {b}"]["plain"] for a, b in pairs)
    res["largest kernels gap"] = max(res[f"{a} vs {b}"]["kernels"] for a, b in pairs)
    del routes
    torch.cuda.empty_cache()
    log("C4, route gaps at full depth (kernels | plain): " + json.dumps(res))
    return res


def speculative_on_the_card(model, small, ids, tiles) -> dict:
    """Phase 26: ``generate_speculative`` with an oracle draft (the greedy
    continuation of ``generate``) and with prompt lookup on an echo prompt,
    at full depth, and with the oracle on ``small`` (the model at 2+2
    layers).  At 2+2 layers every verify row whose inputs are the greedy
    run's must be within phase 4's limits of the decode step's logits
    (``verify_logit_gaps``), and a run on each of ``verify_faults`` must put
    some of them outside.  K2's launches are the verify steps' (counted from
    the first), which must be layers x device steps.  At full depth the
    verify logits are held to ``C4_LIMIT`` of the decode steps' and of the
    prefill route's on the same tokens (the first verify step's rows, each
    the last-row logits of a one-shot prefill of the prompt and the rows up
    to it), and so is the prefill route's gap from the decode step: over 28
    layers of bf16 activations the three routes (9-row, 1-row and 3k-row
    products) round apart by 3-4% of the largest logit on random weights,
    past phase 4's 2+2-layer limits, on the plain route as on the kernels
    (``c4_route_gaps``, whose kernel gaps are held to ``C4_LIMIT`` too).
    The oracle runs also run ``verify_faults``, which must fail phase 4's
    limits at 2+2 layers and ``C4_LIMIT`` at full depth.  Device steps against
    tokens, steps saved and the first step leaving the greedy run are
    readings: on random weights the top logits lie within hundredths of each
    other, so the verify's argmax may leave the decode route's and a draft is
    rejected there (ROADMAP §C)."""
    import torch

    from omchat_torch.config import GenerationConfig
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.runtime import speculative as sp
    from omchat_torch.runtime.speculative import draft_context, generate_speculative

    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1)
    res, missed = {"card": CARD}, []  # missed: planted faults the limits passed
    echo = "Repeat this twice: the quick brown fox jumps over the lazy dog, the quick brown fox jumps over the lazy dog."
    echo_ids = model.processor(echo)["input_ids"][0].tolist()
    for label, (eng, req_ids, req_tiles, oracle) in (
            ("oracle draft", (model.engine, ids, tiles, True)),
            ("oracle draft, 2+2 layers", (small.engine, ids, tiles, True)),
            ("prompt lookup, echo prompt", (model.engine, echo_ids, None, False))):
        step_logits = []
        greedy = eng.generate([req_ids], req_tiles, gen,
                              logits_callback=lambda s, lg: step_logits.append(lg[0].clone())).token_ids[0]
        plen = int(eng.plan([req_ids]).lengths[0])
        ctx0 = len(draft_context(req_ids))
        verify = []
        kw = {"draft_fn": (lambda ctx: greedy[len(ctx) - ctx0:])} if oracle else {}
        torch.cuda.synchronize()
        undo = counted_from_first_verify({"flash_attention": fa.flash_attention})
        try:
            t0 = time.perf_counter()
            got, steps = generate_speculative(
                eng, req_ids, req_tiles, gen, draft_len=SPEC_DRAFT,
                logits_callback=lambda kv, toks, lg: verify.append((kv, toks, lg.clone())), **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            undo()
        k2 = fa.flash_attention.launches
        if k2 != eng.cfg.text.num_hidden_layers * steps:
            raise AssertionError(f"speculative, {label}: K2 launched {k2} times over {steps} verify steps")
        rows, worst, outside = verify_logit_gaps(verify, step_logits, greedy, got, plen)
        run = {"tokens": len(got), "device_steps": steps, "steps_saved": len(got) - 1 - steps, "k2_launches": k2,
               "wall_s": wall,
               "first_step_leaving_greedy": next((i for i, (a, b) in enumerate(zip(got, greedy)) if a != b), None),
               "verify_rows_vs_decode": rows, "verify_vs_decode_max_gap": worst,
               "verify_vs_decode_outside_phase4_limits": outside}
        if eng is small.engine:
            if outside:
                raise AssertionError(f"speculative, {label}: {outside} verify logits outside phase 4's limits of "
                                     f"the decode steps' ({worst:.4g} max)")
        else:
            _, toks, lg = verify[0]
            feats = eng.encode_images(req_tiles) if req_tiles is not None else None
            one_shot = torch.stack([eng.prefill(eng.plan([list(req_ids) + toks[: r + 1]]), feats, 0)[0][0]
                                    for r in range(len(toks))])
            run["verify_vs_prefill_max_gap"] = float((lg.float() - one_shot.float()).abs().max())
            run["prefill_vs_decode_step1_max_gap"] = float((one_shot[0] - step_logits[1]).abs().max())
            run["max_abs_logit"] = float(step_logits[1].abs().max())
            # C4's limit was read on the first verify step's rows: it holds those
            rows1, worst1, _ = verify_logit_gaps(verify[:1], step_logits, greedy, got, plen)
            run["c4_limit"], run["first_verify_step_vs_decode_max_gap"] = C4_LIMIT, worst1
            gaps = (worst1, run["verify_vs_prefill_max_gap"], run["prefill_vs_decode_step1_max_gap"])
            if not rows1 or not all(g <= C4_LIMIT for g in gaps):
                raise AssertionError(f"speculative, {label}: {rows1} verify rows compared; route gaps {gaps} "
                                     f"past C4's limit {C4_LIMIT:.4g}")
        if oracle:  # the planted faults: at 2+2 layers against phase 4's limits, at full depth against C4's
            run["faults"] = {}
            for fault, faulty in verify_faults(sp.verify_step).items():
                seen, real = [], sp.verify_step
                sp.verify_step = faulty
                try:
                    bad, _ = generate_speculative(
                        eng, req_ids, req_tiles, gen, draft_len=SPEC_DRAFT,
                        logits_callback=lambda kv, toks, lg: seen.append((kv, toks, lg.clone())), **kw)
                finally:
                    sp.verify_step = real
                f_rows, f_worst, f_outside = verify_logit_gaps(seen if eng is small.engine else seen[:1],
                                                               step_logits, greedy, bad, plen)
                run["faults"][fault] = {"rows": f_rows, "max_gap": f_worst, "outside_phase4_limits": f_outside}
                caught = f_outside if eng is small.engine else f_worst > C4_LIMIT
                if not caught:
                    limits = "phase 4's limits" if eng is small.engine else f"C4's limit {C4_LIMIT:.4g}"
                    missed.append(f"speculative, {label}: {limits} would pass a verify with {fault} "
                                  f"({f_rows} rows, {f_worst:.4g} max)")
        res[label] = run
    res["C4"] = c4_route_gaps(model, ids, tiles)
    over = {k: v["kernels"] for k, v in res["C4"].items() if isinstance(v, dict) and "kernels" in v
            and v["kernels"] > C4_LIMIT}
    if over:
        missed.append(f"C4: the kernels' route gaps {over} are past {C4_LIMIT:.4g}")
    log("options, speculative decoding: " + json.dumps(res))
    if missed:
        raise AssertionError(" | ".join(missed))
    return res


def speculative_w8a8(model, ids, tiles, label: str, must: tuple) -> dict:
    """Under w8a8 the verify step is an S > 1 trunk pass on the glue kernels:
    one speculative run (an oracle draft), whose verify steps (counted from
    the first, ``counted_from_first_verify``) must launch each of ``must``
    and hand every w8a8 kernel M = 9 rows only; their logits must be finite.
    Returns the run's readings with ``launches`` (name → the verify steps'
    launches) and ``shapes`` (name → {sizes: launches}, for phase 11).
    Whether the tokens equal the greedy run's is a reading: the decode step
    (S = 1) runs the weight-only int8 route and the verify the w8a8 glue, two
    roundings of the activations, and on random weights the top logits lie
    within hundredths of each other (ROADMAP §C)."""
    import torch

    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.speculative import draft_context, generate_speculative

    eng = model.engine
    gen = GenerationConfig(max_new_tokens=12, eos_token_id=-1)
    greedy = eng.generate([ids], tiles, gen).token_ids[0]
    ctx0 = len(draft_context(ids))
    counted = {n: c for n, c in {**w8a8_counters(), **swiglu_counters()}.items() if n in must}
    verify = []
    rec, undo_rec = record_w8a8_launches()
    undo = counted_from_first_verify(counted, rec)
    try:
        got, steps = generate_speculative(eng, ids, tiles, gen, draft_len=SPEC_DRAFT,
                                          draft_fn=lambda ctx: greedy[len(ctx) - ctx0:],
                                          logits_callback=lambda kv, toks, lg: verify.append(lg))
        torch.cuda.synchronize()
    finally:
        undo()
        undo_rec()
    shapes = {n: d for n, d in rec.items() if d}
    res = {"card": CARD, "tokens": len(got), "device_steps": steps,
           "launches": {n: c.launches for n, c in counted.items()},
           "shapes": shapes, "tokens_equal_greedy": got == greedy}
    log(f"options, speculative verify under {label}: "
        + json.dumps({**res, "shapes": {n: {str(k): v for k, v in d.items()} for n, d in shapes.items()}}))
    missing = [n for n, c in res["launches"].items() if not c]
    if missing:
        raise AssertionError(f"speculative verify under {label}: {missing} never launched")
    other = {n: [k for k in d if k[0] != SPEC_DRAFT + 1] for n, d in shapes.items()}
    if any(other.values()):
        raise AssertionError(f"speculative verify under {label}: rows other than {SPEC_DRAFT + 1}: {other}")
    if not all(bool(torch.isfinite(lg).all()) for lg in verify):
        raise AssertionError(f"speculative verify under {label}: non-finite verify logits")
    return res


def beam_step_gaps(kernel: list, plain: list) -> tuple:
    """Two routes' beam searches (``score_callback``'s (scores, tokens) a
    step) while their beams agree: what each step adds to a beam's score (its
    score less its parent's) on one route against the other.  Returns
    (steps agreeing, max |gap| of a step's addition)."""
    import numpy as np

    agree, worst, prev = 0, 0.0, None
    for (sk, tk), (sp, tp) in zip(kernel, plain):
        if tk != tp:
            break
        d = sk - sp
        if prev is not None:
            parents = {tuple(t): i for i, t in enumerate(prev[1])}
            d = d - prev[0][[parents[tuple(t[:-1])] for t in tk]]
        worst = max(worst, float(np.abs(d).max()))
        prev = (sk - sp, tk)
        agree += 1
    return agree, worst


def beam_faults() -> dict:
    """Wrong beam routes that phase 26's 2+2-layer limit must catch: each
    a (module attribute, replacement) of ``runtime.beam_search``."""
    import torch

    return {
        "the cache not reordered to the surviving parents": ("gather_beams", lambda cache, parent: None),
        "log-probs rounded to bf16": ("_log_softmax", lambda logits: torch.log_softmax(
            logits.float(), dim=-1).bfloat16().float().cpu().numpy()),
        "the log-sum-exp dropped (logits as log-probs)": ("_log_softmax", lambda logits: logits.float().cpu().numpy()),
    }


def beam_on_the_card(model, small, ids, tiles) -> dict:
    """Phase 26: ``beam_search(num_beams=4)``, 16 tokens, at full width and
    depth (timed; K3 launched at B = 4 through the decode state's graph);
    then at 2+2 layers the kernel route's beams must agree with
    ``attn_impl="plain"``'s for ``BEAM_MIN_AGREE`` steps, and while they
    agree what each step adds to a beam's score must be within
    ``BEAM_STEP_GAP`` of the plain route's (``beam_step_gaps``); each of
    ``beam_faults`` on the kernel route must fail that."""
    import torch

    from omchat_torch.ops import decode_attention as da
    from omchat_torch.runtime import beam_search as bs
    from omchat_torch.runtime.generate import OmChatEngine

    eng = model.engine
    kw = dict(num_beams=BEAMS, max_new_tokens=BEAM_TOKENS, eos_token_id=-1)
    bs.beam_search(eng, ids, tiles, **kw)  # warm-up and the capture at B = 4
    da.flash_decode_stacked.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = bs.beam_search(eng, ids, tiles, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = da.flash_decode_stacked.launches
    state_batches = sorted({k[0] for k in eng._states})

    def scores(impl, fault=None):
        e = OmChatEngine(small.config, small.engine.params, attn_impl=impl, image_cache_size=0, device=DEVICE)
        seen = []
        name, fn = fault or (None, None)
        real = getattr(bs, name) if name else None
        if name:
            setattr(bs, name, fn)
        try:
            bs.beam_search(e, ids, tiles, score_callback=lambda s, sc, toks: seen.append((sc, toks)), **kw)
        finally:
            if name:
                setattr(bs, name, real)
        return seen

    plain = scores("plain")
    agree, worst = beam_step_gaps(scores(None), plain)
    def fails(steps, gap):
        return steps < BEAM_MIN_AGREE or gap > BEAM_STEP_GAP

    faults = {}
    for fault, patch in beam_faults().items():
        f_agree, f_worst = beam_step_gaps(scores(None, patch), plain)
        faults[fault] = {"steps_agreeing": f_agree, "max_step_gap": f_worst, "caught": fails(f_agree, f_worst)}
    res = {"card": CARD, "num_beams": BEAMS, "tokens": len(best), "wall_s": wall,
           "k3_launches": launches, "decode_state_batches": state_batches,
           "reduced_depth_steps_agreeing": agree, "reduced_depth_max_step_gap": worst, "faults": faults}
    log("options, beam search: " + json.dumps(res))
    if launches != model.config.text.num_hidden_layers * (BEAM_TOKENS - 1) or BEAMS not in state_batches:
        raise AssertionError(f"beam search: K3 launched {launches} times (states {state_batches})")
    if fails(agree, worst):
        raise AssertionError(f"beam search at 2+2 layers: a step's score additions {worst:.3g} apart over {agree} "
                             f"agreeing steps (at least {BEAM_MIN_AGREE})")
    missed = [f for f, r in faults.items() if not r["caught"]]
    if missed:
        raise AssertionError(f"beam search at 2+2 layers: the limit would pass {missed}: {faults}")
    return res


def device_pipeline_on_the_card(frames) -> dict:
    """Phase 26: ``device_preprocess_frames`` on the video's 32 frames
    against the host ``process_video_frames`` (mean |diff| under 0.05, the
    JAX package's limit), timed by CUDA events (uint8 upload included) beside
    the host path's wall time."""
    import torch

    from omchat_torch.processing.device_pipeline import device_preprocess_frames, frames_to_device_batch
    from omchat_torch.processing.video import process_video_frames

    t0 = time.perf_counter()
    host = process_video_frames(frames, num_samples=VIDEO_FRAMES)
    host_s = time.perf_counter() - t0
    batch = frames_to_device_batch(frames, num_samples=VIDEO_FRAMES)
    dev = device_preprocess_frames(batch)
    torch.cuda.synchronize()
    diff = (dev.cpu() - torch.from_numpy(host)).abs()
    ms, readings = time_in_turns({"device": lambda: device_preprocess_frames(batch)})
    res = {"card": CARD, "frames": int(batch.shape[0]), "frame_hw": list(batch.shape[1:3]),
           "mean_abs_diff": float(diff.mean()), "max_abs_diff": float(diff.max()),
           "device_ms": ms["device"], "host_ms": host_s * 1e3}
    log("options, device preprocessing pipeline vs host: " + json.dumps(res))
    if res["mean_abs_diff"] >= 0.05:
        raise AssertionError(f"device pipeline: mean |diff| {res['mean_abs_diff']:.4g} from the host path")
    return res


def small_surface(full, seed: int):
    """``surface_model`` at full width and 2 ViT + 2 LLM layers, random
    weights from ``seed``, without an image cache."""
    cfg = dataclasses.replace(full, vision=dataclasses.replace(full.vision, num_hidden_layers=2),
                              text=dataclasses.replace(full.text, num_hidden_layers=2))
    return surface_model(cfg, build_model(cfg, seed), image_cache_size=0, device=DEVICE)


def options_on_the_card(gen, model, seed: int) -> dict:
    """Phase 26 on the full model: sampling on the graph, bias / penalties /
    logprobs, constrained decoding, chunked prefill, speculative decoding,
    beam search; the last two also on the model at 2+2 layers (random
    weights from ``seed``), where phase 4's limits hold."""
    import torch

    ids, tiles = make_request(model.config, seed)
    small = small_surface(model.config, seed)
    # every option runs and prints its line; the phase then raises with every check that failed
    res, failed = {}, []
    for name, run in (("sampling", lambda: sampling_on_the_graph(model, ids, tiles)),
                      ("bias", lambda: bias_penalties_logprobs(model, ids, tiles)),
                      ("constrained", lambda: constrained_on_the_card(model)),
                      ("chunked", lambda: chunked_prefill_on_the_card(model.config, model.engine.params, ids, tiles)),
                      ("speculative", lambda: speculative_on_the_card(model, small, ids, tiles)),
                      ("beam", lambda: beam_on_the_card(model, small, ids, tiles))):
        try:
            res[name] = run()
        except AssertionError as e:
            failed.append(f"{name}: {e}")
    del small
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("phase 26 failed: " + " | ".join(failed))
    return res


# ---------------------------------------------------------------------------
# Phase 27: the server over HTTP on both routes, the paged engine's log-probs
# and sampled rolls on the graph, the LoRA bank at full width
# ---------------------------------------------------------------------------

# Phase 27: the default route's requests generate HTTP_NEW_TOKENS tokens (the
# image request NEW_TOKENS); the paged route serves phase 5's workload over HTTP
# with these requests sampled (T 0.8, top-p 0.9), these asking for log-probs
# (top 5; two are image requests, prefilled by chunks) and these streamed over
# SSE, the rest plain greedy; phase 27's sampled rolls draw top-k 50.
HTTP_NEW_TOKENS = 12
HTTP_SAMPLED, HTTP_LOGPROBS, HTTP_SSE = (1, 5, 9, 13), (2, 4, 10, 12), (3, 7, 11, 15)
LORA_RANK, LORA_B_STD = 16, 1e-3


def id_tokenizer(bytes_as_text: bool = True):
    """The ``MockTokenizer`` with every token id readable in text: an id past
    the byte range decodes to ``<id>`` and ``<id>`` in text encodes to it, so
    prompts of any ids go over HTTP and replies carry their ids
    (``bytes_as_text=False``: byte ids decode to ``<id>`` too)."""
    import re

    from omchat_torch.utils.testing import MockTokenizer

    class IdTokenizer(MockTokenizer):
        def encode(self, text):
            out, pos = [], 0
            for m in re.finditer(r"<(\d+)>", text):
                out += super().encode(text[pos: m.start()]) + [int(m.group(1))]
                pos = m.end()
            return out + super().encode(text[pos:])

        def decode(self, ids, **kw):
            parts, run = [], []
            for t in (int(i) for i in ids):
                if bytes_as_text and 0 <= t < 256:
                    run.append(t)
                    continue
                parts.append(bytes(run).decode("utf-8", errors="replace"))
                run = []
                parts.append(f"<{t}>")
            return "".join(parts) + bytes(run).decode("utf-8", errors="replace")

    return IdTokenizer()


def ids_of(text: str) -> list:
    import re

    return [int(t) for t in re.findall(r"<(\d+)>", text)]


def png_url(image) -> str:
    import base64
    import io

    buf = io.BytesIO()
    image.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def http_call(port: int, path: str, body=None, stream: bool = False):
    """One request to the in-process server: (reply, seconds); a stream's
    reply is [(seconds since the request, event)] as the events arrived."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as resp:
        if not stream:
            raw = resp.read().decode()
            return (json.loads(raw) if resp.headers["Content-Type"].startswith("application/json") else raw,
                    time.perf_counter() - t0)
        events = []
        for line in resp:
            line = line.decode().strip()
            if line.startswith("data: "):
                events.append((time.perf_counter() - t0, line[6:] if line == "data: [DONE]" else
                               json.loads(line[6:])))
    return events, time.perf_counter() - t0


def sse_text(events) -> str:
    return "".join(e["choices"][0]["delta"].get("content", "") for _, e in events
                   if isinstance(e, dict) and e.get("choices"))


def start_http(model, engine=None):
    """The port's server on 127.0.0.1:0 in this process: (port, stop)."""
    import threading

    from omchat_torch.cli.serve import make_server

    srv, loop = make_server(model, engine, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True, name="phase27-http")
    thread.start()

    def stop():
        srv.shutdown()
        srv.server_close()
        loop.close()
        thread.join(30)
        if thread.is_alive() or loop._thread.is_alive():
            raise AssertionError("phase 27: the server's threads did not stop")
        if loop.error is not None:
            raise AssertionError(f"phase 27: the scheduler failed: {loop.error!r}")

    return srv.server_address[1], stop


def forced_logprobs(engine, ids, tiles, toks: list):
    """log_softmax of the single-request engine's logits before each of
    ``toks`` on the decode route (the prefill's last row, then a decode step
    a token, fed ``toks``): [len(toks), V] fp32, what ``generate``'s
    ``return_logprobs`` reads on those tokens."""
    import torch

    dev = engine.device
    feats = engine.encode_images(tiles) if tiles is not None else None
    plan = engine.plan([ids])
    plen = int(plan.lengths[0])
    logits, cache = engine.prefill(plan, feats, len(toks) + 1)
    rows = [logits[0]]
    for r, t in enumerate(toks[:-1]):
        lg, cache = engine.decode_step(torch.tensor([t], dtype=torch.int32, device=dev),
                                       torch.tensor([plen + r], dtype=torch.int32, device=dev), cache)
        rows.append(lg[0])
    return torch.log_softmax(torch.stack(rows).float(), dim=-1)


def logprob_gaps(ref, toks, chosen, tops) -> tuple:
    """A request's paged log-probs (chosen [n], tops [n] of [(id, lp)])
    against ``ref`` ([n, V] log-probs on the same tokens): (max |gap|, values
    outside phase 4's limits)."""
    import torch

    ids = torch.tensor([[t] + [i for i, _ in top] for t, top in zip(toks, tops)], device=ref.device)
    got = torch.tensor([[c] + [v for _, v in top] for c, top in zip(chosen, tops)], device=ref.device)
    want = ref[: len(toks)].gather(1, ids)
    gap = (got - want).abs()
    return float(gap.max()), int((gap > LOGITS_ATOL + LOGITS_RTOL * want.abs()).sum())


def http_default_route(model, seed: int) -> dict:
    """Phase 27 (a): the server's default route (the single-request engine
    under the lock) over HTTP on phase 3's model.  Phase 3's image request as
    a base64 PNG: the reply's tokens must be ``model.engine.generate``'s and
    the SSE deltas must spell the same text; HTTP TTFT (the reply at
    max_tokens 1, the first SSE content chunk) beside the engine's in the
    same call (both image-cache hits); K1-K4 launches of the first HTTP
    request, which encodes its image.  Then one request of each
    option, each checked as ``tests/test_serve.py`` checks it, and /metrics
    must count every request."""
    import torch

    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.json_mode import START, advance
    from omchat_torch.runtime.json_schema import JsonSchemaMode

    tok = model.tokenizer
    image = request_image(seed)
    inputs = model.processor(REQUEST_QUESTION, images=[image])
    ids, tiles = inputs["input_ids"][0].tolist(), inputs["images"]
    if ids != make_request(model.config, seed)[0]:
        raise AssertionError("serve, default route: the server's prompt is not phase 3's")
    image_body = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": REQUEST_QUESTION}, {"type": "image_url", "image_url": {"url": png_url(image)}}]}]}
    port, stop = start_http(model)
    posts = 0
    res, failed = {"card": CARD}, []
    try:
        model.engine.image_cache.clear()  # the first request encodes its image (K1); the later ones hit the cache
        counted = counters()
        for c in counted.values():
            c.launches = 0
        out, wall = http_call(port, "/v1/chat/completions", {**image_body, "max_tokens": NEW_TOKENS})
        posts += 1
        launches = {n: c.launches for n, c in counted.items()}
        text = out["choices"][0]["message"]["content"]
        want = model.engine.generate([ids], tiles, GenerationConfig(max_new_tokens=NEW_TOKENS)).token_ids[0]
        engine_ttft = model.engine.spans["ttft"]
        events, _ = http_call(port, "/v1/chat/completions", {**image_body, "max_tokens": NEW_TOKENS, "stream": True},
                              stream=True)
        posts += 1
        first_chunk = next(t for t, e in events if isinstance(e, dict) and e["choices"]
                           and e["choices"][0]["delta"].get("content"))
        one, one_wall = http_call(port, "/v1/chat/completions", {**image_body, "max_tokens": 1})
        posts += 1
        res["image request"] = {
            "new_tokens": len(want), "tokens_bitwise_engine": text == tok.decode(want),
            "sse_text_equal": sse_text(events) == text, "http_reply_s": wall,
            "http_ttft_ms_nonstream_max_tokens_1": 1e3 * one_wall, "http_ttft_ms_sse_first_content": 1e3 * first_chunk,
            "engine_ttft_ms": 1e3 * engine_ttft, "image_cache": model.engine.image_cache.stats(),
            "launches": launches}
        if not res["image request"]["tokens_bitwise_engine"]:
            failed.append(f"the image request's reply {ids_of(text)} is not the engine's {want}")
        if not res["image request"]["sse_text_equal"]:
            failed.append("the SSE deltas do not spell the reply's text")
        if one["usage"]["completion_tokens"] != 1:
            failed.append(f"max_tokens 1 gave {one['usage']['completion_tokens']} tokens")
        missing = [n for n in ("qk_norm_prepass", "flash_attention", "flash_decode_stacked", "commit_rows")
                   if not launches[n]]
        if missing:
            failed.append(f"the HTTP request launched no {missing}")

        def chat(text, **kw):
            nonlocal posts
            posts += 1
            return http_call(port, "/v1/chat/completions",
                             {"messages": [{"role": "user", "content": text}], "max_tokens": HTTP_NEW_TOKENS, **kw})[0]

        opts = {}
        n2 = chat("Hello there", n=2)
        opts["n=2"] = [c["message"]["content"] for c in n2["choices"]]
        if len(opts["n=2"]) != 2 or opts["n=2"][0] != opts["n=2"][1]:
            failed.append(f"n=2 (greedy) gave {opts['n=2']}")
        seeded = [chat("Hello there", temperature=0.9, seed=5)["choices"][0]["message"]["content"] for _ in range(2)]
        opts["seed twice equal"] = seeded[0] == seeded[1]
        if not opts["seed twice equal"]:
            failed.append(f"seed 5 twice gave {seeded}")
        base = opts["n=2"][0]
        stop_at = f"<{ids_of(base)[2]}>" if len(ids_of(base)) > 2 else None
        if stop_at:
            cut = chat("Hello there", stop=stop_at)["choices"][0]
            opts["stop"] = {"stop": stop_at, "finish_reason": cut["finish_reason"],
                            "cut_at_first": cut["message"]["content"] == base[: base.find(stop_at)]}
            if cut["finish_reason"] != "stop" or not opts["stop"]["cut_at_first"]:
                failed.append(f"stop {stop_at}: {cut}")
        biased = chat("Hello there", logit_bias={str(BIAS_TOKEN): 100})["choices"][0]["message"]["content"]
        opts["logit_bias"] = ids_of(biased)
        if ids_of(biased) != [BIAS_TOKEN] * HTTP_NEW_TOKENS:
            failed.append(f"logit_bias +100 on {BIAS_TOKEN} gave {ids_of(biased)}")
        pen = ids_of(chat("Hello there", logit_bias={str(BIAS_TOKEN): 100},
                          frequency_penalty=1000.0)["choices"][0]["message"]["content"])
        opts["bias + frequency_penalty"] = pen
        if not pen or pen[0] != BIAS_TOKEN or pen.count(BIAS_TOKEN) != 1:
            failed.append(f"bias + a frequency penalty of 1000 gave {pen}")
        lp = chat("Hello there", logprobs=True, top_logprobs=5)["choices"][0]["logprobs"]["content"]
        chosen_top1 = max(abs(e["logprob"] - e["top_logprobs"][0]["logprob"]) for e in lp)
        opts["logprobs"] = {"n": len(lp), "max_chosen": max(e["logprob"] for e in lp),
                            "chosen_vs_top1_max_gap": chosen_top1,
                            "tops_sorted": all([t["logprob"] for t in e["top_logprobs"]]
                                               == sorted((t["logprob"] for t in e["top_logprobs"]), reverse=True)
                                               for e in lp)}
        if opts["logprobs"]["max_chosen"] > 0 or chosen_top1 > 1e-6 or not opts["logprobs"]["tops_sorted"]:
            failed.append(f"logprobs: {opts['logprobs']}")
        js = chat("give me json", max_tokens=24, response_format={"type": "json_object"})["choices"][0]
        opts["json_object"] = js["message"]["content"]
        if advance(START, js["message"]["content"]) is None:
            failed.append(f"json_object gave {js['message']['content']!r}")
        schema = {"type": "object", "properties": {"ok": {"type": "boolean"}}, "required": ["ok"]}
        sj = chat("go", max_tokens=24, response_format={"type": "json_schema",
                                                         "json_schema": {"name": "t", "schema": schema}})
        opts["json_schema"] = sj["choices"][0]["message"]["content"]
        mode = JsonSchemaMode(tok, schema)
        if mode.advance(mode.START, opts["json_schema"]) is None:
            failed.append(f"json_schema gave {opts['json_schema']!r}")
        gc_text = chat("yes or no?", guided_choice=["yes", "no"])["choices"][0]["message"]["content"]
        opts["guided_choice"] = gc_text
        if gc_text not in ("yes", "no"):
            failed.append(f"guided_choice gave {gc_text!r}")
        tools = [{"type": "function", "function": {"name": "get_weather", "parameters": {
            "type": "object", "properties": {"city": {"type": "string"}}, "required": ["city"]}}}]
        call = chat("weather in paris?", max_tokens=48, tools=tools,
                    tool_choice={"type": "function", "function": {"name": "get_weather"}})["choices"][0]
        opts["forced tool call"] = {"finish_reason": call["finish_reason"],
                                    "tool_calls": call["message"].get("tool_calls"),
                                    "content": call["message"]["content"]}
        ok = (call["finish_reason"] == "tool_calls" and call["message"]["tool_calls"][0]["function"]["name"]
              == "get_weather") or (call["finish_reason"] == "length" and call["message"]["content"].startswith("{"))
        if not ok:
            failed.append(f"the forced tool call gave {call}")
        posts += 1
        echo = http_call(port, "/v1/completions", {"prompt": "abc<151644>", "max_tokens": 4, "echo": True})[0]
        opts["/v1/completions echo"] = echo["choices"][0]["text"]
        if not echo["choices"][0]["text"].startswith("abc<151644>") or echo["usage"]["prompt_tokens"] != 4:
            failed.append(f"/v1/completions with echo gave {echo}")
        res["options"] = opts
        metrics, _ = http_call(port, "/metrics")
        rows = dict(line.split(" ", 1) for line in metrics.splitlines() if line and not line.startswith("#"))
        res["metrics_requests_total"] = int(rows["omchat_requests_total"])
        res["requests_sent"] = posts
        if res["metrics_requests_total"] != posts or int(rows["omchat_requests_failed_total"]):
            failed.append(f"/metrics counts {rows} for {posts} requests")
    finally:
        stop()
    torch.cuda.synchronize()
    log("serve, default route: " + json.dumps(res))
    if failed:
        raise AssertionError("serve, default route: " + " | ".join(failed))
    return res


def http_workload(cfg, tokenizer, seed: int) -> list:
    """Phase 5's workload (``serving_workload``) as chat requests: each
    request's ids after its first as ``<id>`` text, and a seeded 448x448 PNG
    (thumbnail + one tile, the workload's two) on its image requests.
    [(body, ids, tiles)], ids and tiles as the server's processor makes
    them."""
    import numpy as np

    from omchat_torch.constants import IMAGE_TOKEN_INDEX
    from omchat_torch.processing.image_processor import OmChatImageProcessor
    from omchat_torch.processing.processor import OmChatProcessor

    processor = OmChatProcessor(tokenizer, OmChatImageProcessor(
        crop_size=cfg.vision.image_size, shortest_edge=cfg.vision.image_size,
        image_grid_pinpoints=cfg.image_grid_pinpoints))
    rng = np.random.default_rng(seed)
    out = []
    for ids, tiles in serving_workload(cfg):
        text = "".join(f"<{t}>" for t in ids[1:] if t != IMAGE_TOKEN_INDEX)
        if tiles is None:
            content, images = text, None
        else:
            image = seeded_image(rng, 448, 448)
            content = [{"type": "text", "text": text}, {"type": "image_url", "image_url": {"url": png_url(image)}}]
            images = [image]
        inputs = processor(text, images=images)
        out.append(({"messages": [{"role": "user", "content": content}], "max_tokens": SERVING_NEW_TOKENS},
                    inputs["input_ids"][0].tolist(), inputs.get("images")))
    return out


def http_paged_route(model, seed: int) -> dict:
    """Phase 27 (b) and (c) at full depth: the server's ``--paged`` route
    (``PagedBatchEngine`` with phase 5's options over phase 3's weights,
    ``precompile()`` first) serving phase 5's workload over HTTP from 16
    client threads at once: ``HTTP_SAMPLED`` sampled, ``HTTP_LOGPROBS`` with
    log-probs, ``HTTP_SSE`` streamed, the rest greedy.  Before that, request
    0 alone over HTTP must be bitwise the in-process engine's run of it, and
    the whole workload runs in process (greedy) for the tokens/s beside.
    Every roll must replay a graph and every page come back; each log-prob
    request's log-probs must hold ``logprob_gaps`` against the
    single-request engine's on the same tokens within C4's limit.  Returns
    the results and the engine (for phase 27 (d))."""
    import threading

    import numpy as np
    import torch

    from omchat_torch.api import omchat_model, paged_batch_engine
    from omchat_torch.config import GenerationConfig

    tok = id_tokenizer(bytes_as_text=False)
    http_model = omchat_model(tok, model.engine)
    eng = paged_batch_engine(http_model, image_cache_size=0, **SERVING)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    widths = eng.precompile()
    torch.cuda.synchronize()
    res = {"card": CARD, "precompile_s": time.perf_counter() - t0, "capture_ms": eng.capture_ms(),
           "graphs": len(eng._rolls), "widths": widths,
           "precompile_alloc_gib": (torch.cuda.memory_allocated() - mem0) / 2**30}
    work = http_workload(model.config, tok, seed)
    failed = []
    # in process: request 0 alone, then the workload (greedy), each after a warm-up at 4 tokens
    gen = GenerationConfig(max_new_tokens=SERVING_NEW_TOKENS)
    for rid in drive(eng, [(ids, tiles) for _, ids, tiles in work], 4):
        eng.pop_result(rid)
    alone = eng.submit(work[0][1], work[0][2], max_new_tokens=SERVING_NEW_TOKENS, eos_token_id=gen.eos_token_id)
    eng.run_to_completion()
    alone_tokens = eng.pop_result(alone)[0]
    torch.cuda.synchronize()
    eng.reset_latency_stats()
    t0 = time.perf_counter()
    rids = [eng.submit(ids, tiles, max_new_tokens=SERVING_NEW_TOKENS, eos_token_id=gen.eos_token_id)
            for _, ids, tiles in work]
    eng.run_to_completion()
    torch.cuda.synchronize()
    in_wall = time.perf_counter() - t0
    in_process = [eng.pop_result(r)[0] for r in rids]
    st = eng.latency_stats()
    res.update({"in_process_tokens_per_s": sum(map(len, in_process)) / in_wall,
                "in_process_ttft_p50_s": st["ttft_p50_s"], "in_process_ttft_p99_s": st["ttft_p99_s"],
                "in_process_rolls": st["rolls_graphed"] + st["rolls_eager"]})
    counted = paged_counters()
    port, stop = start_http(http_model, eng)
    try:
        one, _ = http_call(port, "/v1/chat/completions", work[0][0])
        res["request_0_alone_bitwise_in_process"] = ids_of(one["choices"][0]["message"]["content"]) == alone_tokens
        if not res["request_0_alone_bitwise_in_process"]:
            failed.append("request 0 alone over HTTP is not the in-process run of it")
        eng.reset_latency_stats()
        for c in counted.values():
            c.launches = 0
        replies = [None] * len(work)

        def client(i):
            body = dict(work[i][0])
            if i in HTTP_SAMPLED:
                body.update(temperature=0.8, top_p=0.9)
            if i in HTTP_LOGPROBS:
                body.update(logprobs=True, top_logprobs=5)
            replies[i] = http_call(port, "/v1/chat/completions", {**body, "stream": True} if i in HTTP_SSE
                                   else body, stream=i in HTTP_SSE)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(work))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or any(r is None for r in replies):
            raise AssertionError("serve, paged route: a client did not finish")
        launches = {n: c.launches for n, c in counted.items()}
        stats = eng.latency_stats()
    finally:
        stop()
    # the same traffic from 16 threads straight into the serving loop (no
    # HTTP, no tokenizing or tiling): what the server's own layer costs
    from omchat_torch.cli.serve import ServingLoop

    loop = ServingLoop(eng).start()
    counts = [0] * len(work)

    def direct(i):
        g = (GenerationConfig(max_new_tokens=SERVING_NEW_TOKENS, do_sample=True, temperature=0.8, top_p=0.9)
             if i in HTTP_SAMPLED else gen)
        counts[i] = len(loop.run_n(work[i][1], work[i][2], g, logprobs=i in HTTP_LOGPROBS,
                                   top_logprobs=5 if i in HTTP_LOGPROBS else 0)[0][0])

    eng.reset_latency_stats()
    threads = [threading.Thread(target=direct, args=(i,)) for i in range(len(work))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    direct_wall = time.perf_counter() - t0
    loop.close()
    if any(t.is_alive() for t in threads) or loop.error is not None:
        raise AssertionError(f"serve, paged route: the threads into the serving loop did not finish ({loop.error!r})")
    res["threads_into_loop"] = {"tokens_per_s": sum(counts) / direct_wall, "rolls": eng.rolls_graphed + eng.rolls_eager,
                                "ttft_p50_s": eng.latency_stats()["ttft_p50_s"]}
    texts = [sse_text(r[0]) if i in HTTP_SSE else r[0]["choices"][0]["message"]["content"]
             for i, r in enumerate(replies)]
    tokens = [ids_of(t) for t in texts]
    ttft = [next(t for t, e in replies[i][0] if isinstance(e, dict) and e.get("choices")
                 and e["choices"][0]["delta"].get("content")) for i in HTTP_SSE]
    chunks = [[t for t, e in replies[i][0] if isinstance(e, dict) and e.get("choices")
               and e["choices"][0]["delta"].get("content")] for i in HTTP_SSE]
    gaps = [b - a for c in chunks for a, b in zip(c, c[1:])]
    greedy = [i for i in range(len(work)) if i not in HTTP_SAMPLED]
    res.update({
        "requests": len(work), "clients": len(work), "generated_tokens": sum(map(len, tokens)), "wall_s": wall,
        "tokens_per_s": sum(map(len, tokens)) / wall,
        "sse_ttft_p50_s": float(np.percentile(ttft, 50)), "sse_ttft_p99_s": float(np.percentile(ttft, 99)),
        "sse_interchunk_p50_s": float(np.percentile(gaps, 50)) if gaps else None,
        "sse_interchunk_p99_s": float(np.percentile(gaps, 99)) if gaps else None,
        "rolls_graphed": stats["rolls_graphed"], "rolls_eager": stats["rolls_eager"],
        "engine_ttft_p50_s": stats["ttft_p50_s"], "engine_ttft_p99_s": stats["ttft_p99_s"],
        "pages_free": eng.allocator.available, "pages_total": eng.allocator.num_pages,
        "launches": {"K12 paged_flash_decode": launches["paged_flash_decode"],
                     "K14 paged_flash_prefill": launches["paged_flash_prefill"],
                     "K15 commit_pages": launches["commit_pages"], "K4 commit_rows": launches["commit_rows"],
                     "K1 / K2": [launches["packed_qkv_norm_attention"], launches["flash_attention"]]},
        "greedy_first_step_leaving_in_process": {i: first_divergence([tokens[i]], [in_process[i]])[0]
                                                 for i in greedy},
        "short_replies": [i for i, t in enumerate(tokens) if len(t) != SERVING_NEW_TOKENS and i not in HTTP_LOGPROBS]})
    if stats["rolls_eager"] or not stats["rolls_graphed"]:
        failed.append(f"rolls graphed {stats['rolls_graphed']}, eager {stats['rolls_eager']} after precompile")
    if eng.allocator.available != eng.allocator.num_pages:
        failed.append(f"{eng.allocator.num_pages - eng.allocator.available} pages never came back")
    if any(not launches[n] for n in ("paged_flash_decode", "paged_flash_prefill", "commit_pages", "commit_rows")):
        failed.append(f"a paged kernel never launched: {launches}")
    # (c) at full depth: the log-prob requests against the single-request engine on their tokens
    lp = {}
    for i in HTTP_LOGPROBS:
        content = replies[i][0]["choices"][0]["logprobs"]["content"]
        chosen = [e["logprob"] for e in content]
        tops = [[(ids_of(t["token"])[0], t["logprob"]) for t in e["top_logprobs"]] for e in content]
        ref = forced_logprobs(model.engine, work[i][1], work[i][2], tokens[i])
        worst, outside = logprob_gaps(ref, tokens[i], chosen, tops)
        lp[i] = {"tokens": len(chosen), "max_gap_vs_single_request": worst, "outside_phase4_limits": outside,
                 "max_chosen": max(chosen), "chosen_vs_top1_max_gap": max(abs(c - t[0][1]) for c, t in
                                                                         zip(chosen, tops)),
                 "tops_sorted": all([v for _, v in t] == sorted((v for _, v in t), reverse=True) for t in tops)}
        if worst > C4_LIMIT or lp[i]["max_chosen"] > 0 or lp[i]["chosen_vs_top1_max_gap"] > 1e-6 \
                or not lp[i]["tops_sorted"] or len(chosen) != len(tokens[i]):
            failed.append(f"paged log-probs of request {i}: {lp[i]} (C4's limit {C4_LIMIT:.4g})")
    res["logprobs_full_depth"] = lp
    log("serve, paged route: " + json.dumps(res))
    if failed:
        raise AssertionError("serve, paged route: " + " | ".join(failed))
    return res, eng, work


def sampled_rolls_on_the_graph(model, eng, work) -> dict:
    """Phase 27 (d): the first 8 requests of the HTTP workload in process,
    the ``HTTP_SAMPLED`` ones sampled (T 0.8, top-k 50), on the graphed
    engine of (b) and on an engine whose rolls run eagerly
    (``decode_graphs=False``), each generator seeded with ``SAMPLE_SEED``:
    every request's tokens must be equal, and every sampled slot's draw must
    be in its row's top 50 (read on the eager engine)."""
    import torch

    from omchat_torch.api import paged_batch_engine
    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime import paged_engine as pe

    hot = GenerationConfig(max_new_tokens=16, eos_token_id=-1, do_sample=True, temperature=0.8, top_k=50)
    batch = [(ids, tiles, hot if i in HTTP_SAMPLED else None) for i, (_, ids, tiles) in enumerate(work[:8])]

    def run(engine):
        engine._generator.manual_seed(SAMPLE_SEED)
        rids = [engine.submit(ids, tiles, max_new_tokens=16, eos_token_id=-1, generation=g) for ids, tiles, g in batch]
        engine.run_to_completion()
        return [engine.pop_result(r)[0] for r in rids]

    eng.reset_latency_stats()
    graphed = run(eng)
    g_stats = eng.latency_stats()
    eager_eng = paged_batch_engine(model, image_cache_size=0, decode_graphs=False, **SERVING)
    draws, real = [], pe.sample_batch

    def recording(logits, generator, do_sample, **kw):
        out = real(logits, generator, do_sample=do_sample, **kw)
        draws.append((logits.float().clone(), do_sample.clone(), out.clone()))
        return out

    pe.sample_batch = recording
    try:
        eager = run(eager_eng)
    finally:
        pe.sample_batch = real
    outside = 0
    for logits, do_sample, out in draws:
        top = torch.topk(logits, 50, dim=-1).indices
        hit = (top == out[:, None].long()).any(dim=1)
        outside += int((do_sample & ~hit).sum())
    res = {"card": CARD, "requests": len(batch), "sampled": [i for i in range(8) if i in HTTP_SAMPLED],
           "tokens_bitwise_equal": graphed == eager, "rolls_graphed": g_stats["rolls_graphed"],
           "rolls_eager": g_stats["rolls_eager"], "eager_engine_rolls_eager": eager_eng.rolls_eager,
           "sampled_steps_read": len(draws), "draws_outside_top50": outside,
           "distinct_sampled_tokens": len({t for i, t_ in enumerate(graphed) if i in HTTP_SAMPLED for t in t_})}
    log("serve, sampled rolls on the graph (graphed vs eager, one seed): " + json.dumps(res))
    del eager_eng
    torch.cuda.empty_cache()
    if not res["tokens_bitwise_equal"] or outside or g_stats["rolls_eager"] or not draws:
        raise AssertionError(f"sampled rolls on the graph: {res}")
    return res


def paged_logprob_faults() -> dict:
    """Wrong paged log-prob routes phase 27's 2+2-layer limits must catch,
    each a function of the engine that plants the fault in it."""
    import torch

    from omchat_torch.runtime import paged_engine as pe

    def slot_shifted(eng):  # each slot reads its neighbour's rows of the roll's log-probs
        process = eng._process_roll

        def shifted(h):  # in the host copies the engine reads, once they have landed
            if h["ready"] is not None:
                h["ready"].synchronize()
            h["host"] = (h["host"][0], *(torch.roll(t, 1, dims=1) for t in h["host"][1:])) if len(h["host"]) > 1 \
                else h["host"]
            return process(h)

        eng._process_roll = shifted

    def temperature_scaled(eng):  # log_softmax of the logits over each slot's temperature
        real = pe._roll_pick

        def scaled(logits, sampling, generator, logprobs):
            out = real(logits, sampling, generator, logprobs)
            if not logprobs or sampling is None:
                return out
            lp = torch.log_softmax(logits.float() / sampling["temperature"][:, None], dim=-1)
            top = torch.topk(lp, pe.LOGPROBS_K, dim=-1)
            return out[0], lp.gather(1, out[0][:, None].long())[:, 0], top.values, top.indices

        pe._roll_pick = scaled
        return lambda: setattr(pe, "_roll_pick", real)

    def wrong_prefill_row(eng):  # a request's first log-probs from the previous request's prefill row
        finish, last = eng._finish_with_token, []

        def swapped(req, first, logits_row=None):
            row = last[-1] if last else logits_row
            last.append(logits_row)
            finish(req, first, row)

        eng._finish_with_token = swapped

    return {"a slot's log-prob rows shifted by one slot": slot_shifted,
            "log_softmax over temperature-scaled logits": temperature_scaled,
            "the first token's log-probs from another request's prefill row": wrong_prefill_row}


def paged_logprobs_small(small) -> dict:
    """Phase 27 (c) at 2+2 layers: four short text requests with log-probs
    (top 5) in one batch of the graphed paged engine, two greedy and two
    sampled (T 0.7): every chosen and top log-prob within phase 4's limits
    of the single-request engine's on the same tokens (``forced_logprobs``);
    each of ``paged_logprob_faults`` (on an eager engine) must put some
    outside."""
    import numpy as np
    import torch

    from omchat_torch.api import paged_batch_engine
    from omchat_torch.config import GenerationConfig

    prompts = [[151644] + [int(t) for t in np.random.default_rng(i).integers(1, 500, 40 + 9 * i)] for i in range(4)]
    warm = GenerationConfig(max_new_tokens=16, eos_token_id=-1, do_sample=True, temperature=0.7)

    def run(engine, plant=None):
        undo = plant(engine) if plant else None
        try:
            engine._generator.manual_seed(SAMPLE_SEED)
            rids = [engine.submit(p, None, max_new_tokens=16, eos_token_id=-1, generation=warm if i % 2 else None,
                                  logprobs=True, top_logprobs=5) for i, p in enumerate(prompts)]
            engine.run_to_completion()
            out = []
            for r in rids:
                chosen, tops = engine.request_logprobs(r)
                out.append((engine.pop_result(r)[0], chosen, tops))
            return out
        finally:
            if undo:
                undo()

    def gaps(out):
        worst, outside = 0.0, 0
        for p, (toks, chosen, tops) in zip(prompts, out):
            w, o = logprob_gaps(forced_logprobs(small.engine, p, None, toks), toks, chosen, tops)
            worst, outside = max(worst, w), outside + o
        return worst, outside

    eng = paged_batch_engine(small, image_cache_size=0, **SERVING)
    eng.precompile()
    worst, outside = gaps(run(eng))
    res = {"card": CARD, "requests": len(prompts), "max_gap": worst, "outside_phase4_limits": outside,
           "rolls_graphed": eng.rolls_graphed, "rolls_eager": eng.rolls_eager, "faults": {}}
    missed = []
    for fault, plant in paged_logprob_faults().items():
        f_worst, f_outside = gaps(run(paged_batch_engine(small, image_cache_size=0, decode_graphs=False, **SERVING),
                                      plant))
        res["faults"][fault] = {"max_gap": f_worst, "outside_phase4_limits": f_outside}
        if not f_outside:
            missed.append(f"phase 4's limits would pass paged log-probs with {fault} ({f_worst:.4g} max)")
    log("serve, paged log-probs at 2+2 layers: " + json.dumps(res))
    torch.cuda.empty_cache()
    if outside or eng.rolls_eager:
        raise AssertionError(f"paged log-probs at 2+2 layers: {outside} values outside phase 4's limits "
                             f"({worst:.4g} max), {eng.rolls_eager} eager rolls")
    if missed:
        raise AssertionError(" | ".join(missed))
    return res


def seeded_adapters(params, seed: int, n: int = 2) -> list:
    """``n`` rank-``LORA_RANK`` adapters on q / k / v / o from ``seed``: A as
    ``init_lora`` draws it, B ~ N(0, LORA_B_STD^2) (``init_lora`` zeroes it)."""
    import torch

    from omchat_torch.training.lora import init_lora

    out = []
    for i in range(n):
        g = torch.Generator(device=DEVICE).manual_seed(seed + 1 + i)
        lora = init_lora(g, params, rank=LORA_RANK)
        for group in lora["layers"].values():
            for ab in group.values():
                ab["a"] = ab["a"].detach()
                ab["b"] = (torch.randn(ab["b"].shape, generator=g, device=DEVICE) * LORA_B_STD).to(ab["b"].dtype)
        out.append(lora)
    return out


def lora_bank_on_the_card(model, small, seed: int) -> dict:
    """Phase 27 (e): a bank of two seeded rank-16 adapters on q / k / v / o
    (``build_lora_bank``) on an engine over phase 3's weights.
    ``generate(adapter_id=0)`` must give the bank-free engine's tokens and
    its logits within phase 4's limits (bitwise expected); adapter 1's
    first-token logits against a ``merge_lora`` model within phase 4's limits
    at 2+2 layers, read at full depth; graphed decode tokens/s with and
    without the bank."""
    import torch

    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.generate import OmChatEngine
    from omchat_torch.training.lora import build_lora_bank, merge_lora

    ids, tiles = make_request(model.config, seed)
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1)
    res = {"card": CARD, "adapters": 2, "rank": LORA_RANK, "targets": "q_proj k_proj v_proj o_proj"}
    failed = []
    for label, m in (("full depth", model), ("2+2 layers", small)):
        params = m.engine.params
        adapters = seeded_adapters(params, seed)
        bank = build_lora_bank(adapters, dtype=torch.bfloat16)
        banked = OmChatEngine(m.config, params, lora_bank=bank, image_cache_size=0, device=DEVICE)
        base = OmChatEngine(m.config, params, image_cache_size=0, device=DEVICE)
        plan = base.plan([ids])
        feats = base.encode_images(tiles)
        merged = OmChatEngine(m.config, merge_lora(params, adapters[0]), image_cache_size=0, device=DEVICE)
        first = banked.prefill(plan, feats, 0, adapter_ids=torch.tensor([1], device=DEVICE))[0][0].float()
        want = merged.prefill(plan, feats, 0)[0][0].float()
        del merged
        gap = (first - want).abs()
        run = {"adapter1_vs_merged_first_token_max_gap": float(gap.max()),
               "adapter1_vs_merged_outside_phase4_limits": int((gap > LOGITS_ATOL + LOGITS_RTOL * want.abs()).sum()),
               "adapter1_vs_base_first_token_max_gap": float(
                   (first - base.prefill(plan, feats, 0)[0][0].float()).abs().max())}
        if label == "2+2 layers" and run["adapter1_vs_merged_outside_phase4_limits"]:
            failed.append(f"{label}: adapter 1 vs merge_lora outside phase 4's limits ({run})")
        if label == "full depth":
            lg_base, lg_bank, rates = [], [], {}
            for name, eng, kw, store in (("base", base, {}, lg_base), ("bank, adapter 0", banked, {"adapter_id": 0},
                                                                          lg_bank)):
                eng.generate([ids], tiles, gen, **kw)  # the decode state's capture
                toks = eng.generate([ids], tiles, gen, logits_callback=lambda s, lg, st=store: st.append(lg[0]),
                                    **kw).token_ids[0]
                rates[name] = (toks, eng.spans["decode_steps"] / eng.spans["decode"])
            banked.generate([ids], tiles, gen, adapter_id=1)
            rates["bank, adapter 1"] = (None, banked.spans["decode_steps"] / banked.spans["decode"])
            worst = max(float((a.float() - b.float()).abs().max()) for a, b in zip(lg_base, lg_bank))
            run.update({"adapter0_tokens_equal_base": rates["base"][0] == rates["bank, adapter 0"][0],
                        "adapter0_vs_base_logits_max_gap": worst,
                        "decode_tokens_per_s": {k: v[1] for k, v in rates.items()}})
            if not run["adapter0_tokens_equal_base"] or worst > LOGITS_ATOL:
                failed.append(f"{label}: adapter 0 leaves the base engine ({run})")
        res[label] = run
        del banked, base
        torch.cuda.empty_cache()
    log("serve, LoRA bank: " + json.dumps(res))
    if failed:
        raise AssertionError("LoRA bank: " + " | ".join(failed))
    return res


def serving_on_the_card(model, small, seed: int) -> dict:
    """Phase 27 on phase 3's model (``model``, the same weights under
    ``id_tokenizer``) and ``small`` (2+2 layers): the default route over
    HTTP, the ``--paged`` route over HTTP with the full-depth log-prob check,
    the 2+2-layer log-prob check with its planted faults, sampled rolls on
    the graph and the LoRA bank; every part runs and prints its line, then
    the phase raises with every check that failed."""
    import torch

    from omchat_torch.api import omchat_model

    http_model = omchat_model(id_tokenizer(), model.engine)
    res, failed, paged = {}, [], None
    for name, run in (("default", lambda: http_default_route(http_model, seed)),
                      ("paged", lambda: http_paged_route(model, seed)),
                      ("logprobs 2+2", lambda: paged_logprobs_small(small)),
                      ("sampled", lambda: sampled_rolls_on_the_graph(model, *paged[1:])),
                      ("lora", lambda: lora_bank_on_the_card(model, small, seed))):
        try:
            if name == "sampled" and paged is None:
                raise AssertionError("the paged route failed before its engine was ready")
            out = run()
            if name == "paged":
                paged = out
                out = out[0]
            res[name] = out
        except AssertionError as e:
            failed.append(f"{name}: {e}")
    del paged
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("phase 27 failed: " + " | ".join(failed))
    return res


# ---------------------------------------------------------------------------
# Phase 28: the paged engine's routes (prefix cache, speculative verify in the
# batch, streaming and pipelined rolls) at full width and depth
# ---------------------------------------------------------------------------

# Phase 28 (a): phase 5's requests behind one shared system prompt of
# PREFIX_PAGES pages (PREFIX_PAGES * 128 tokens); the pool holds the cold run
# (each request its own copy of the prompt), and prompts up to ROUTES's
# prefill_chunk take the one-shot route cold (K2 + K15; a hit resumes on the
# chunked route, K14 over pages another request wrote).  PREFIX_SUBSET: the
# requests whose first-token logits are read on attn_impl="plain" too; the
# fault runs seed PREFIX_FAULT_SEEDS requests that decode PREFIX_FAULT_TOKENS.
PREFIX_PAGES, PREFIX_SUBSET, PREFIX_FAULT_SEEDS, PREFIX_FAULT_TOKENS = 8, (0, 1, 2, 3), 4, 32
ROUTES = {**SERVING, "num_pages": 320, "prefill_chunk": 2048}
# The prefix-hit request's first-token logits against the same request served
# cold: the resumed route (K14 over the cached pages) and the one-shot route (K2
# over the whole prompt) round bf16 products of other shapes over 28 layers, as
# C4's routes do.  The limit is 1.5x the plain route's gap on the same requests, as
# an H100 run read it (NVIDIA H100 80GB HBM3, 700.00 W; chip_probes/paged_routes.py):
# plain 0.1797, kernels 0.1582 over all 16 requests, at max |logit| 6.06; the
# planted faults read 6.63 (a page late) and 7.77 (decode rows on shared pages).
PREFIX_PLAIN_GAP = 0.1796875
# Phase 28 (b): the verify checks run SPEC_SLOTS requests through SPEC_DRAFT_LEN + 1
# verify rows; the repetitive workload has ECHO_REQUESTS prompts of a ECHO_BLOCK-token
# block said ECHO_REPEATS times (tests/test_paged_engine.py:553's shape, at 16 slots).
SPEC_SLOTS, SPEC_DRAFT_LEN, ECHO_REQUESTS, ECHO_BLOCK, ECHO_REPEATS = 4, 4, 16, 32, 4
# Phase 28 (c): the roll while an SSE request decodes (--streaming-roll 4 beside
# --decode-roll 16); timing replays of the graphed verify and roll
STREAMING_ROLL, STEP_REPLAYS = 4, 10
PLAIN_IMPL, PICK_MODES_GREEDY = "plain", (False, False)
# Phase 28 (b), the batch's verify (4 slots x 5 rows, K2 over gathered pages) against
# the paged decode route (K12) at full depth, fed the same tokens: C4's method on this
# comparison.  An H100 run (NVIDIA H100 80GB HBM3, 700.00 W; teacher-forced, max |logit|
# 5.88) read the two routes 0.330 apart on the kernels, 0.335 apart on the kernels'
# plain versions (the functions the JAX kernels compute, no CUDA kernel involved) and
# 0.211 on attn_impl="plain", which rounds p nowhere; each kernel against its own
# plain version 0.26 (K2) and 0.31 (K12) over 28 layers.  So the gap is the two
# functions' bf16 rounding, not a fault, and C4's 0.306 (read on a single request's
# 9 rows) is too tight for it: the limit is 1.5x the plain versions' gap; the planted
# faults read 6.30 (write_pos + 1) and 8.45 (the draft a row late).
SPEC_PLAIN_GAP = 0.335
# what phase 28's runs hand the kernels of its rows, and their launches there
# (filled before the runs' checks, so that a failed check still times them)
ROUTES_SEEN: dict = {}


def routes_workload(cfg, tails_seed: int) -> list:
    """Phase 5's requests (``serving_workload``; with ``tails_seed`` other
    than its own seed, other ids of the same lengths) behind one
    ``PREFIX_PAGES``-page system prompt: [(ids, tiles)]."""
    import numpy as np

    sys_ids = [int(t) for t in np.random.default_rng(1000).integers(2000, 20000, PREFIX_PAGES * 128 - 1)]
    rng = np.random.default_rng(tails_seed)
    out = []
    for ids, tiles in serving_workload(cfg):
        if tails_seed != SERVING_WORKLOAD_SEED:
            ids = [t if t < 0 else int(rng.integers(2000, 20000)) for t in ids]
        out.append(([151644] + sys_ids + ids[1:], tiles))
    return out


def lone_prefill_spans(eng) -> list:
    """CUDA events around each lone one-shot prefill (``_prefill_tick`` on
    its contiguous route: a prompt with an image, or a text prompt alone):
    [(start, end)]."""
    import torch

    spans, tick = [], eng._prefill_tick

    def wrapped(req):
        if req.chunk_pos or int(req.plan.lengths[0]) > eng.prefill_chunk:
            return tick(req)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = tick(req)
        end.record()
        spans.append((start, end))
        return out

    eng._prefill_tick = wrapped
    return spans


def roll_timeline(eng) -> dict:
    """CUDA events around each roll dispatch, each beside the count of
    prefill and ViT dispatches before it, and the roll lengths: what
    ``busy_between_rolls`` reads."""
    import torch

    rec = {"rolls": [], "other": 0}
    dispatch = eng._dispatch_roll

    def roll(decoding, n, *a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        h = dispatch(decoding, n, *a, **kw)
        end.record()
        rec["rolls"].append((start, end, rec["other"], n))
        return h

    def counting(fn):
        def wrapped(*a, **kw):
            rec["other"] += 1
            return fn(*a, **kw)
        return wrapped

    eng._dispatch_roll = roll
    for name in ("_prefill_shorts", "_run_chunk", "_prefill_tick"):
        setattr(eng, name, counting(getattr(eng, name)))
    eng._prefiller.encode_tiles = counting(eng._prefiller.encode_tiles)
    return rec


def busy_between_rolls(rec) -> dict:
    """From ``roll_timeline``'s events (after a synchronize): the card's
    busy share over the stretches where rolls follow rolls with no other
    dispatch between them (each roll's device time over itself plus the gap
    from the previous roll's end), and those gaps' median."""
    rolls = rec["rolls"]
    busy, gaps = [], []
    for (s0, e0, n0, _), (s1, e1, n1, _) in zip(rolls, rolls[1:]):
        if n0 == n1:
            busy.append(s1.elapsed_time(e1))
            gaps.append(max(0.0, e0.elapsed_time(s1)))
    total = sum(busy) + sum(gaps)
    return {"busy_share_between_rolls": sum(busy) / total if total else None,
            "roll_gap_ms_p50": sorted(gaps)[len(gaps) // 2] if gaps else None, "roll_pairs": len(gaps)}


def prefix_serving(cfg, params, prefix_cache: bool, label: str) -> tuple:
    """Phase 28 (a), one engine: a warm-up wave (the system prompt before
    other tails, 4 tokens: it publishes the system prompt's pages when
    ``prefix_cache``), then the timed wave at SERVING_NEW_TOKENS.  Returns
    (results, the first-token logits by request index, the timed run's
    recorded chunk dispatches)."""
    import torch

    from omchat_torch.runtime import paged_engine as pe

    eng = pe.PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, prefix_cache=prefix_cache, **ROUTES)
    first = capture_first_logits(eng)
    rec, undo = record_dispatches(eng)
    lone = lone_prefill_spans(eng)
    try:
        rec["label"] = "warm-up"
        for rid in drive(eng, routes_workload(cfg, 7), 4):
            eng.pop_result(rid)
        torch.cuda.synchronize()
        eng.reset_latency_stats()
        for c in paged_counters().values():
            c.launches = 0
        lone.clear()
        hits0 = eng.prefix_cache.stats()["hits"] if prefix_cache else 0
        rec["label"] = "timed"
        work = routes_workload(cfg, SERVING_WORKLOAD_SEED)
        t0 = time.perf_counter()
        rids = drive(eng, work, SERVING_NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        undo()
    launches = {n: c.launches for n, c in paged_counters().items()}
    tokens = [eng.pop_result(r)[0] for r in rids]
    st = eng.latency_stats()
    cache = eng.prefix_cache.stats() if prefix_cache else {}
    free = eng.allocator.available
    rows = [int(eng._prefiller.plan([w[0]]).lengths[0]) for w in work]
    res = {"card": CARD, "requests": len(work), "prompt_rows_min_max": [min(rows), max(rows)],
           "tokens_per_s": sum(map(len, tokens)) / wall, "wall_s": wall,
           "ttft_p50_s": st["ttft_p50_s"], "ttft_p99_s": st["ttft_p99_s"],
           "intertoken_p99_s": st.get("intertoken_p99_s"),
           "prefill_dispatch_wall_ms": {k: sum(span_ms(rec, "timed", k)) for k in ("vit", "shorts", "chunk")},
           "chunk_dispatches": len(span_ms(rec, "timed", "chunk")),
           "pages_free": free, "pages_evictable": cache.get("evictable", 0),
           "hits_pages": cache.get("hits", 0) - hits0, "pages_cached": cache.get("pages_cached", 0),
           "rolls_graphed": st["rolls_graphed"], "rolls_eager": st["rolls_eager"],
           "launches": {n: launches[n] for n in ("flash_attention", "paged_flash_prefill", "commit_pages",
                                                  "paged_flash_decode", "commit_rows")}}
    torch.cuda.synchronize()
    res["prefill_dispatch_wall_ms"]["lone one-shot"] = sum(s.elapsed_time(e) for s, e in lone)
    logits = {i: first[r] for i, r in enumerate(rids)}
    chunks = [c for c in rec["chunks"] if c["label"] == "timed"]
    log(f"routes, prefix cache, {label}: " + json.dumps(res))
    if any(len(t) != SERVING_NEW_TOKENS for t in tokens):
        raise AssertionError(f"{label}: a request did not return {SERVING_NEW_TOKENS} tokens")
    if free + cache.get("evictable", 0) != eng.allocator.num_pages:
        raise AssertionError(f"{label}: {free} pages free + {cache.get('evictable', 0)} evictable != "
                             f"{eng.allocator.num_pages}")
    res["tokens"] = tokens
    del eng
    torch.cuda.empty_cache()
    return res, logits, chunks


def first_logits(cfg, params, prefix_cache: bool, attn_impl=None, fault=None) -> dict:
    """The first-token logits of ``PREFIX_SUBSET``'s timed requests (one
    token each), cold or (``prefix_cache``) after a seed wave published the
    system prompt's pages; ``fault`` plants one in the hit route: "late" (a
    hit resumes one page past the cached ones), "shared write" (the seed
    requests' decode rows land on the system prompt's pages)."""
    import numpy as np
    import torch

    from omchat_torch.runtime import paged_engine as pe

    eng = pe.PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, prefix_cache=prefix_cache,
                              attn_impl=attn_impl, **ROUTES)
    seeds = routes_workload(cfg, 7)[:PREFIX_FAULT_SEEDS]
    if fault == "shared write":
        dispatch = eng._dispatch_roll

        def onto_shared_pages(decoding, roll, active, tables, *a, **kw):
            tables = np.array(tables)
            for r in decoding:  # the decode page -> a published page of the system prompt
                shared = [eng.prefix_cache.by_hash[h] for h in r.page_hashes[:PREFIX_PAGES]]
                for pos in (eng._lengths[r.slot], eng._lengths[r.slot] + roll - 1):
                    col = min(int(pos) // eng.page_size, tables.shape[1] - 1)
                    tables[r.slot, col] = shared[col % PREFIX_PAGES]
            return dispatch(decoding, roll, active, tables, *a, **kw)

        eng._dispatch_roll = onto_shared_pages
    if prefix_cache:
        for rid in drive(eng, seeds, PREFIX_FAULT_TOKENS):
            eng.pop_result(rid)
    if fault == "shared write":
        del eng._dispatch_roll
    if fault == "late":
        admit = eng._admit

        def late():
            before = {r.request_id for r in eng.slots if r is not None}
            admit()
            for r in eng.slots:
                if (r is not None and r.request_id not in before and r.cache_refs
                        and r.chunk_pos + eng.page_size < int(r.plan.lengths[0])):
                    r.chunk_pos += eng.page_size

        eng._admit = late
    first = capture_first_logits(eng)
    work = routes_workload(cfg, SERVING_WORKLOAD_SEED)
    rids = drive(eng, [work[i] for i in PREFIX_SUBSET], 1)
    torch.cuda.synchronize()
    out = {i: first[r] for i, r in zip(PREFIX_SUBSET, rids)}
    hits = eng.prefix_cache.stats()["hits"] if prefix_cache else 0
    del eng
    torch.cuda.empty_cache()
    return out, hits


def logit_gap(a: dict, b: dict) -> float:
    return max(float((a[i] - b[i]).abs().max()) for i in a)


def vqa_turns(model) -> dict:
    """Phase 28 (a), multi-turn VQA on the paged engine with the prefix
    cache: turn 1 is phase 3's request (3 tiles, 3187 rows); turn 2 sends
    turn 1's image and text again, turn 1's answer and a new question.  Turn
    2 must hit the pages over the image's rows and skip the ViT."""
    import torch

    from omchat_torch.runtime import paged_engine as pe

    cfg, params = model.config, model.engine.params
    ids, tiles = make_request(cfg, 0)
    eng = pe.PagedBatchEngine(cfg, params, device=DEVICE, prefix_cache=True, **ROUTES)
    rid = eng.submit(ids, tiles, max_new_tokens=NEW_TOKENS, eos_token_id=-1)
    eng.run_to_completion()
    torch.cuda.synchronize()
    t1 = eng.requests[rid].ttft
    answer = eng.pop_result(rid)[0]
    follow = model.processor("And what colours does it have?")["input_ids"][0].tolist()
    ids2 = list(ids) + answer + follow
    hits0 = eng.prefix_cache.stats()["hits"]
    rid = eng.submit(ids2, tiles.copy(), max_new_tokens=NEW_TOKENS, eos_token_id=-1)
    eng.run_to_completion()
    torch.cuda.synchronize()
    t2 = eng.requests[rid].ttft
    tokens2 = eng.pop_result(rid)[0]
    plan = eng._prefiller.plan([ids])
    img_end = int(plan.is_image[0].nonzero()[0].max()) + 1
    hit = eng.prefix_cache.stats()["hits"] - hits0
    res = {"card": CARD, "turn1_rows": int(plan.lengths[0]), "turn2_rows": int(eng._prefiller.plan([ids2]).lengths[0]),
           "turn1_ttft_ms": 1e3 * t1, "turn2_ttft_ms": 1e3 * t2, "turn2_hit_pages": hit, "image_rows_end": img_end,
           "image_cache": eng._prefiller.image_cache.stats(), "turn2_tokens": len(tokens2)}
    log("routes, prefix cache, multi-turn VQA (turn 2 resends turn 1's image and text): " + json.dumps(res))
    del eng
    torch.cuda.empty_cache()
    # every page turn 1 published (all but the one its first decode step wrote) is hit
    if hit != res["turn1_rows"] // ROUTES["page_size"] or res["image_cache"]["hits"] < 1:
        raise AssertionError(f"VQA turn 2: the hit ({hit} pages) is not turn 1's {res['turn1_rows']} rows' "
                             f"pages, or the ViT ran again ({res['image_cache']})")
    return res


def prefix_cache_routes(model) -> tuple:
    """Phase 28 (a): cold and prefix-cache serving, the route gaps of the
    first-token logits (kernels and plain), the limit and its two planted
    faults, then multi-turn VQA.  The prefix run's chunk dispatches and K14
    launches go into ``ROUTES_SEEN``."""
    cfg, params = model.config, model.engine.params
    cold, cold_first, _ = prefix_serving(cfg, params, False, "cold")
    warm, warm_first, chunks = prefix_serving(cfg, params, True, "prefix cache")
    ROUTES_SEEN.update(chunks=chunks, paged_flash_prefill=warm["launches"]["paged_flash_prefill"])
    res = {"card": CARD, "cold_vs_cache": {k: [cold[k], warm[k]] for k in (
        "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "prefill_dispatch_wall_ms", "chunk_dispatches", "hits_pages",
        "pages_free", "pages_evictable")}}
    subset = {i: cold_first[i] for i in PREFIX_SUBSET}
    plain_cold, _ = first_logits(cfg, params, False, attn_impl=PLAIN_IMPL)
    plain_hit, plain_hits = first_logits(cfg, params, True, attn_impl=PLAIN_IMPL)
    gaps = {"kernels, all requests": logit_gap(cold_first, warm_first),
            "kernels, subset": logit_gap(subset, {i: warm_first[i] for i in PREFIX_SUBSET}),
            "plain, subset": logit_gap(plain_cold, plain_hit),
            "kernels vs plain, cold": logit_gap(subset, plain_cold)}
    plain_gap = PREFIX_PLAIN_GAP if PREFIX_PLAIN_GAP is not None else gaps["plain, subset"]
    limit = 1.5 * plain_gap
    res.update({"first_token_logit_gaps_hit_vs_cold": gaps, "plain_hit_pages": plain_hits,
                "limit": limit, "limit_from": "PREFIX_PLAIN_GAP" if PREFIX_PLAIN_GAP is not None else "this run",
                "max_abs_logit": max(float(v.abs().max()) for v in cold_first.values())})
    faults = {}
    for fault in ("late", "shared write"):
        got, _ = first_logits(cfg, params, True, fault=fault)
        faults[fault] = logit_gap(subset, got)
    res["faults"] = faults
    res["vqa"] = vqa_turns(model)
    log("routes, prefix cache: " + json.dumps(res))
    failed = []
    if gaps["kernels, all requests"] > limit:
        failed.append(f"hit vs cold first-token logits {gaps['kernels, all requests']:.4g} past {limit:.4g}")
    failed += [f"the limit {limit:.4g} passes the fault '{f}' ({g:.4g})" for f, g in faults.items() if g <= limit]
    if warm["hits_pages"] < PREFIX_PAGES * len(cold["tokens"]):
        failed.append(f"the timed wave hit {warm['hits_pages']} pages, not {PREFIX_PAGES} a request")
    if failed:
        raise AssertionError("prefix cache: " + " | ".join(failed))
    return res


def verify_snapshot(eng, work, new_tokens: int) -> tuple:
    """Serve ``work`` on an eager engine (decode_roll 1): the pools, lengths,
    active flags, tables and tokens staged for the first roll (right after
    the prefills), the decode route's logits of each step ([S, V] fp32 a
    step, from ``_roll_pick``), and the tokens."""
    import numpy as np

    from omchat_torch.runtime import paged_engine as pe

    snap, steps = {}, []
    dispatch, pick = eng._dispatch_roll, pe._roll_pick

    def first(decoding, roll, active, tables, *a, **kw):
        if not snap:
            snap.update(k=eng.k_pool.clone(), v=eng.v_pool.clone(), lengths=np.array(eng._lengths),
                        active=np.array(active), tokens=np.array(eng._tokens),
                        tables=np.where(active[:, None], eng._tables, eng._parking))  # the full width
        return dispatch(decoding, roll, active, tables, *a, **kw)

    eng._dispatch_roll = first
    pe._roll_pick = lambda logits, *a, **kw: (steps.append(logits.float().clone()), pick(logits, *a, **kw))[1]
    try:
        rids = drive(eng, work, new_tokens)
    finally:
        pe._roll_pick = pick
        del eng._dispatch_roll
    return snap, steps, [eng.pop_result(r)[0] for r in rids]


def verify_logits(eng, snap, tokens, lengths=None, impl=None, plain_k2: bool = False):
    """``_paged_verify`` over a copy of the snapshot's pools: [S, T, V]
    (``plain_k2``: K2's plain version in K2's place, on the card)."""
    import torch

    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.runtime import paged_engine as pe

    dev = eng.device
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    k2 = fa.flash_attention
    if plain_k2:
        fa.flash_attention = lambda q, k, v, *, kv_format, **kw: fa.flash_attention_plain(q, k, v, **kw)
    try:
        return pe._paged_verify(eng.params, eng.cfg, t(tokens), t(snap["lengths"] if lengths is None else lengths),
                                t(snap["active"]), t(snap["tables"]), snap["k"].clone(), snap["v"].clone(),
                                eng.page_size, impl).float()
    finally:
        fa.flash_attention = k2


def decode_logits(eng, snap, tokens, impl=None, plain_k12: bool = False):
    """The decode route from the snapshot's pools fed ``tokens`` [S, T], one
    step a column (``_decode_step_core``; ``plain_k12``: K12's plain version
    in K12's place): each step's logits, [S, T, V]."""
    import torch

    from omchat_torch.ops import paged_attention as pa
    from omchat_torch.runtime import paged_engine as pe

    dev, out = eng.device, []
    pick, kernels = pe._roll_pick, dict(pa.DECODE_KERNELS)
    pe._roll_pick = lambda logits, *a, **kw: (out.append(logits.float().clone()), pick(logits, *a, **kw))[1]
    if plain_k12:
        pa.DECODE_KERNELS["auto"] = pa.paged_flash_decode_plain
    try:
        kp, vp = snap["k"].clone(), snap["v"].clone()
        act = torch.as_tensor(snap["active"], device=dev)
        lengths, tables = torch.as_tensor(snap["lengths"], device=dev), torch.as_tensor(snap["tables"], device=dev)
        for r in range(tokens.shape[1]):
            pe._decode_step_core(eng.params, eng.cfg, torch.as_tensor(tokens[:, r], device=dev),
                                 lengths + r * act.int(), act, tables, kp, vp, eng.page_size, impl)
    finally:
        pe._roll_pick = pick
        pa.DECODE_KERNELS.update(kernels)
    return torch.stack(out, dim=1)


def verify_vs_decode(model, small) -> dict:
    """Phase 28 (b), the verify's logits: SPEC_SLOTS requests prefilled, then
    decoded SPEC_DRAFT_LEN + 1 steps on the decode route (K12 + K4); the
    verify of those tokens from the same pools (``_paged_verify``: K2 over
    the gathered pages, K4) must give each row the decode step's logits
    within 1.5x ``SPEC_PLAIN_GAP`` at full depth, and a verify with its rows
    written and read one position late or its draft fed one row late must
    not.  The two routes' gap on the kernels' plain versions and on
    ``attn_impl="plain"``, fed the same tokens from the same pools, is read
    every run beside it.  At 2+2 layers the verify on the kernels against
    the plain route within phase 4's limits."""
    import numpy as np
    import torch

    from omchat_torch.runtime import paged_engine as pe

    t = SPEC_DRAFT_LEN + 1
    limit = 1.5 * max(C4_PLAIN_GAP, SPEC_PLAIN_GAP)
    res = {"card": CARD, "rows": t}
    for label, m in (("full depth", model), ("2+2 layers", small)):
        cfg, params = m.config, m.engine.params
        eng = pe.PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, max_slots=SPEC_SLOTS, num_pages=48,
                                  page_size=128, max_len=1024, decode_roll=1, decode_graphs=False)
        work = [w for w in serving_workload(cfg) if w[1] is None][:SPEC_SLOTS]
        snap, steps, toks = verify_snapshot(eng, work, t + 1)
        feed = np.zeros((SPEC_SLOTS, t), np.int32)
        for s_, tk in zip(np.nonzero(snap["active"])[0], toks):
            feed[s_] = tk[:t]  # the first token, then the decode route's
        decode = torch.stack(steps[:t], dim=1)  # [S, T, V]
        live = torch.as_tensor(snap["active"], device=eng.device)
        gap = lambda a, b: float((a - b)[live].abs().max())  # noqa: E731
        verify = verify_logits(eng, snap, feed)
        if label == "full depth":
            late = verify_logits(eng, snap, feed, lengths=snap["lengths"] + snap["active"].astype(np.int32))
            shifted = np.concatenate([feed[:, :1], feed[:, :-1]], axis=1)
            res[label] = {
                "verify_vs_decode_max_gap": gap(verify, decode), "limit": limit, "c4_limit": C4_LIMIT,
                "max_abs_logit": float(decode[live].abs().max()),
                "kernels' plain versions, verify vs decode": gap(verify_logits(eng, snap, feed, plain_k2=True),
                                                                 decode_logits(eng, snap, feed, plain_k12=True)),
                "attn_impl plain, verify vs decode": gap(verify_logits(eng, snap, feed, impl=PLAIN_IMPL),
                                                         decode_logits(eng, snap, feed, impl=PLAIN_IMPL)),
                "faults": {"write_pos + 1": gap(late, decode),
                           "the draft one row late": gap(verify_logits(eng, snap, shifted), decode)}}
        else:
            plain = verify_logits(eng, snap, feed, impl=PLAIN_IMPL)
            err = (verify - plain)[live].abs()
            outside = int((err > LOGITS_ATOL + LOGITS_RTOL * plain[live].abs()).sum())
            res[label] = {"kernels_vs_plain_max_gap": float(err.max()), "outside_phase4_limits": outside,
                          "verify_vs_decode_max_gap": gap(verify, decode)}
        del eng, snap, steps, decode, verify
        torch.cuda.empty_cache()
    log("routes, speculative verify in the batch, logits: " + json.dumps(res))
    full, small_res = res["full depth"], res["2+2 layers"]
    failed = []
    if full["verify_vs_decode_max_gap"] > limit:
        failed.append(f"full-depth verify vs decode {full['verify_vs_decode_max_gap']:.4g} past {limit:.4g}")
    failed += [f"the limit {limit:.4g} passes the fault '{f}' ({g:.4g})" for f, g in full["faults"].items()
               if g <= limit]
    if small_res["outside_phase4_limits"]:
        failed.append(f"2+2 layers: {small_res['outside_phase4_limits']} verify logits outside phase 4's limits")
    if failed:
        raise AssertionError("speculative verify: " + " | ".join(failed))
    return res


def echo_workload(cfg) -> list:
    """ECHO_REQUESTS text prompts, each a seeded ECHO_BLOCK-token block said
    ECHO_REPEATS times and its first two tokens again."""
    import numpy as np

    rng = np.random.default_rng(SERVING_WORKLOAD_SEED + 1)
    out = []
    for _ in range(ECHO_REQUESTS):
        block = [int(t) for t in rng.integers(2000, 20000, ECHO_BLOCK)]
        out.append(([151644] + block * ECHO_REPEATS + block[:2], None))
    return out


def speculative_in_the_batch(model) -> dict:
    """Phase 28 (b) at 16 slots: the echo workload served on plain rolls, with
    speculative verify by prompt lookup (which drafts only where the model
    repeats itself: random weights may never), and with an oracle draft (the
    rolls run's own tokens, accepted as far as the verify's argmax keeps
    them), all graphed after ``precompile``, in turns after a warm-up; verify
    dispatches, tokens, mean accepted drafts a slot verify, tokens/s; then
    the graphed verify's ms beside the graphed roll's ms a step at the
    largest verify's lengths and tables.  The largest verify dispatch's
    inputs and K2's and K4's launches in the oracle runs' verify ticks go
    into ``ROUTES_SEEN``."""
    import numpy as np
    import torch

    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import paged_attention as pa
    from omchat_torch.runtime import paged_engine as pe

    cfg, params = model.config, model.engine.params
    work = echo_workload(cfg)
    rolls = pe.PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, **SERVING)
    spec = pe.PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, speculative=True,
                               draft_len=SPEC_DRAFT_LEN, **SERVING)
    res = {"card": CARD, "requests": len(work), "prompt_rows": len(work[0][0])}
    for eng in (rolls, spec):
        eng.precompile(variants=(PICK_MODES_GREEDY,))
        for rid in drive(eng, work, 4):
            eng.pop_result(rid)
    staged, in_verify = [], {"flash_attention": 0, "commit_rows": 0}
    stage, tick = spec._stage_verify, spec._speculative_tick

    def record_stage(tokens, lengths, active, tables):
        staged.append((np.array(lengths), np.array(active), np.array(tables)))
        return stage(tokens, lengths, active, tables)

    def counted_tick(decoding):
        before = (fa.flash_attention.launches, pa.commit_rows.launches)
        ran = tick(decoding)
        in_verify["flash_attention"] += fa.flash_attention.launches - before[0]
        in_verify["commit_rows"] += pa.commit_rows.launches - before[1]
        return ran

    spec._stage_verify, spec._speculative_tick = record_stage, counted_tick
    cont, tokens, oracle_staged, oracle_launches = {}, {}, [], {"flash_attention": 0, "commit_rows": 0}
    for name in ("rolls", "prompt lookup", "oracle draft", "oracle draft", "prompt lookup", "rolls"):
        eng = rolls if name == "rolls" else spec
        spec.draft_fn = (lambda ctx: cont.get(tuple(ctx), [])[:SPEC_DRAFT_LEN]) if name == "oracle draft" else None
        eng.reset_latency_stats()
        d0, t0_spec, s0 = eng.spec_dispatches, eng.spec_tokens, len(staged)
        for k in in_verify:
            in_verify[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = drive(eng, work, SERVING_NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        toks = [eng.pop_result(r)[0] for r in rids]
        if name == "rolls" and not cont:
            cont = {tuple(ids + t[:i]): t[i:] for (ids, _), t in zip(work, toks) for i in range(len(t))}
        st = eng.latency_stats()
        run = res.setdefault(name, {"runs_tokens_per_s": []})
        run["runs_tokens_per_s"].append(sum(map(len, toks)) / wall)
        run.update({k: st[k] for k in ("rolls_graphed", "rolls_eager", "verifies_graphed", "verifies_eager")},
                   pages_free=eng.allocator.available)
        if eng is spec:
            slot_verifies = sum(int(a.sum()) for _, a, _ in staged[s0:])
            run.update({"verify_dispatches": eng.spec_dispatches - d0, "spec_tokens": eng.spec_tokens - t0_spec,
                        "slot_verifies": slot_verifies,
                        "accepted_drafts_per_slot_verify": (eng.spec_tokens - t0_spec) / slot_verifies - 1
                        if slot_verifies else None, "launches_in_verify_ticks": dict(in_verify)})
            if name == "oracle draft":
                oracle_staged += staged[s0:]
                oracle_launches = dict(in_verify)
        tokens[name] = toks
    res["first_step_leaving_rolls"] = {n: first_divergence(tokens[n], tokens["rolls"])
                                       for n in ("prompt lookup", "oracle draft")}
    spec._stage_verify, spec._speculative_tick = stage, tick
    failed = []
    if not oracle_staged:
        failed.append("no verify dispatch with the oracle draft")
    else:
        # the graphed verify and the graphed roll over the largest verify's lengths and tables
        lengths, active, tables = max(oracle_staged, key=lambda v: (int(v[1].sum()), v[2].shape[1]))
        ROUTES_SEEN.update(verify=(lengths, active, tables), **oracle_launches)
        width = tables.shape[1]
        toks = np.zeros((spec.max_slots, SPEC_DRAFT_LEN + 1), np.int32)
        vstep = spec._verify_step(width)
        roll = spec._roll_step(width, PICK_MODES_GREEDY, spec.decode_roll)
        times = {}
        for _ in range(3):  # in turns
            for label, fn, stage_fn in (
                    ("verify", vstep, lambda: spec._stage_verify(toks, lengths, active, tables)),
                    ("roll", roll, lambda: spec._stage_roll(np.zeros(spec.max_slots, np.int32), lengths, active,
                                                            tables, spec._sampling_rows([])))):
                stage_fn()
                fn()
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(STEP_REPLAYS):
                    fn()
                end.record()
                torch.cuda.synchronize()
                times.setdefault(label, []).append(start.elapsed_time(end) / STEP_REPLAYS)
        verify_ms = sorted(times["verify"])[1]
        roll_step_ms = sorted(times["roll"])[1] / spec.decode_roll
        res["graphed"] = {"verify_ms": verify_ms, "roll_ms_a_step": roll_step_ms,
                          "verify_over_roll_step": verify_ms / roll_step_ms, "slots": int(active.sum()),
                          "table_width": width, "mean_length": float(lengths[active].mean()),
                          "verify_graphs": len(spec._verifies), "capture_ms": spec.capture_ms()}
    log("routes, speculative verify in the batch, echo workload at 16 slots: " + json.dumps(res))
    del rolls, spec
    torch.cuda.empty_cache()
    for name in ("rolls", "prompt lookup", "oracle draft"):
        r = res[name]
        if r["verifies_eager"] or r["rolls_eager"] or r["pages_free"] != SERVING["num_pages"]:
            failed.append(f"{name}: eager dispatches after precompile or pages lost: {r}")
    if failed:
        raise AssertionError("speculative in the batch: " + " | ".join(failed))
    return res


def http_mix(http_model, eng, work, label: str, alone: int = None) -> dict:
    """Phase 27 (b)'s traffic over HTTP on ``eng`` (already precompiled):
    16 clients at once, ``HTTP_SAMPLED`` sampled, ``HTTP_LOGPROBS`` with
    log-probs, ``HTTP_SSE`` streamed; tokens/s, SSE TTFT and inter-chunk
    percentiles, rolls by length, busy share between rolls.  ``alone``: a
    request index first sent alone over SSE, whose tokens are returned."""
    import threading

    import numpy as np
    import torch

    port, stop = start_http(http_model, eng)
    res = {"card": CARD, "pipeline_rolls": eng.pipeline_rolls, "streaming_roll": eng.streaming_roll}
    try:
        if alone is not None:
            events, _ = http_call(port, "/v1/chat/completions", {**work[alone][0], "stream": True}, stream=True)
            res["alone_tokens"] = ids_of(sse_text(events))
        torch.cuda.synchronize()
        timeline = roll_timeline(eng)
        eng.reset_latency_stats()
        replies = [None] * len(work)

        def client(i):
            body = dict(work[i][0])
            if i in HTTP_SAMPLED:
                body.update(temperature=0.8, top_p=0.9)
            if i in HTTP_LOGPROBS:
                body.update(logprobs=True, top_logprobs=5)
            replies[i] = http_call(port, "/v1/chat/completions", {**body, "stream": True} if i in HTTP_SSE
                                   else body, stream=i in HTTP_SSE)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(work))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        wall = time.perf_counter() - t0
        if any(th.is_alive() for th in threads) or any(r is None for r in replies):
            raise AssertionError(f"{label}: a client did not finish")
        stats = eng.latency_stats()
    finally:
        stop()
        for name in ("_dispatch_roll", "_prefill_shorts", "_run_chunk", "_prefill_tick"):
            eng.__dict__.pop(name, None)
        eng._prefiller.__dict__.pop("encode_tiles", None)
    torch.cuda.synchronize()
    texts = [sse_text(r[0]) if i in HTTP_SSE else r[0]["choices"][0]["message"]["content"]
             for i, r in enumerate(replies)]
    chunks = [[t for t, e in replies[i][0] if isinstance(e, dict) and e.get("choices")
               and e["choices"][0]["delta"].get("content")] for i in HTTP_SSE]
    gaps = [b - a for c in chunks for a, b in zip(c, c[1:])]
    lengths = [n for *_, n in timeline["rolls"]]
    res.update({"tokens_per_s": sum(len(ids_of(t)) for t in texts) / wall, "wall_s": wall,
                "sse_ttft_p50_s": float(np.percentile([c[0] for c in chunks], 50)),
                "sse_interchunk_p50_s": float(np.percentile(gaps, 50)),
                "sse_interchunk_p99_s": float(np.percentile(gaps, 99)),
                "rolls_by_length": {n: lengths.count(n) for n in sorted(set(lengths))},
                "rolls_graphed": stats["rolls_graphed"], "rolls_eager": stats["rolls_eager"],
                "pages_free": eng.allocator.available, **busy_between_rolls(timeline)})
    log(f"routes, {label}: " + json.dumps({k: v for k, v in res.items() if k != "alone_tokens"}))
    if stats["rolls_eager"] or eng.allocator.available != eng.allocator.num_pages:
        raise AssertionError(f"{label}: rolls eager {stats['rolls_eager']}, pages free {eng.allocator.available}")
    return res


def streaming_and_pipelined(model, seed: int, phase27: dict = None) -> dict:
    """Phase 28 (c) and (d) on one engine (phase 5's options, ``--streaming-roll
    4``, ``--pipeline-rolls``; all 32 roll graphs captured by ``precompile``),
    whose ``streaming_roll`` and ``pipeline_rolls`` are switched between runs
    (the headroom and the graphs stay those of the engine built with both).
    (d): phase 5's workload in process with and without pipelining, in
    turns (tokens bitwise equal, every roll graphed, the busy share between
    rolls), then phase 27 (b) over HTTP each way; (c): phase 27 (b) over HTTP
    with streaming rolls, the SSE inter-chunk percentiles beside the run
    without them (and phase 27's, ``phase27``), and a request alone over SSE
    (4-step rolls) bitwise the same request in process (16-step rolls)."""
    import torch

    from omchat_torch.api import omchat_model, paged_batch_engine

    tok = id_tokenizer(bytes_as_text=False)
    http_model = omchat_model(tok, model.engine)
    eng = paged_batch_engine(http_model, image_cache_size=0, streaming_roll=STREAMING_ROLL, pipeline_rolls=True,
                             **SERVING)
    t0 = time.perf_counter()
    eng.precompile()
    torch.cuda.synchronize()
    res = {"card": CARD, "precompile_s": time.perf_counter() - t0, "graphs": len(eng._rolls),
           "capture_ms": eng.capture_ms()}
    work = serving_workload(model.config)
    for rid in drive(eng, work, 4):
        eng.pop_result(rid)
    # (d) in process, pipelined and not in turns
    runs, tokens = [], {}
    for pipelined in (True, False, False, True):
        eng.pipeline_rolls, eng.streaming_roll = pipelined, None
        eng.reset_latency_stats()
        timeline = roll_timeline(eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = drive(eng, work, SERVING_NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name in ("_dispatch_roll", "_prefill_shorts", "_run_chunk", "_prefill_tick"):
            eng.__dict__.pop(name, None)
        eng._prefiller.__dict__.pop("encode_tiles", None)
        toks = [eng.pop_result(r)[0] for r in rids]
        st = eng.latency_stats()
        runs.append({"pipeline_rolls": pipelined, "tokens_per_s": sum(map(len, toks)) / wall,
                     "rolls_graphed": st["rolls_graphed"], "rolls_eager": st["rolls_eager"],
                     "ttft_p50_s": st["ttft_p50_s"], "pages_free": eng.allocator.available,
                     **busy_between_rolls(timeline)})
        tokens.setdefault(pipelined, []).append(toks)
    res["in_process"] = runs
    log("routes, pipelined rolls, phase 5's workload in process (pipelined / not, in turns): " + json.dumps(runs))
    failed = []
    if any(t != tokens[False][0] for ts in tokens.values() for t in ts):
        failed.append(f"pipelined tokens differ from the unpipelined run's: first steps leaving it "
                      f"{first_divergence(tokens[True][0], tokens[False][0])}")
    if any(r["rolls_eager"] or r["pages_free"] != SERVING["num_pages"] for r in runs):
        failed.append("an in-process run rolled eagerly or lost pages")
    # (d) over HTTP, then (c)
    http_work = http_workload(model.config, tok, seed)
    for pipelined in (True, False):
        eng.pipeline_rolls, eng.streaming_roll = pipelined, None
        res[f"http, pipeline_rolls={pipelined}"] = http_mix(http_model, eng, http_work,
                                                            f"pipelined rolls over HTTP ({pipelined})")
    # (c): a request alone whose table width is the same at 4- and 16-step rolls
    alone = next(i for i, (_, ids, tiles) in enumerate(http_work) if tiles is None and len(
        {eng._table_width(n + r, eng.max_pages) for n in range(len(ids), len(ids) + SERVING_NEW_TOKENS)
         for r in (STREAMING_ROLL, SERVING["decode_roll"])}) == 1)
    eng.pipeline_rolls, eng.streaming_roll = False, STREAMING_ROLL
    streamed = http_mix(http_model, eng, http_work, "streaming rolls over HTTP (--streaming-roll 4)", alone=alone)
    eng.streaming_roll = None
    rid = eng.submit(http_work[alone][1], None, max_new_tokens=SERVING_NEW_TOKENS, eos_token_id=151645)
    eng.run_to_completion()
    in_process = eng.pop_result(rid)[0]
    res["streaming"] = {k: v for k, v in streamed.items() if k != "alone_tokens"}
    res["streaming"]["alone_request"] = alone
    res["streaming"]["alone_bitwise_decode_roll_16"] = streamed["alone_tokens"] == in_process
    plain = res["http, pipeline_rolls=False"]
    res["sse_interchunk_p50_p99_s"] = {
        "streaming_roll 4": [streamed["sse_interchunk_p50_s"], streamed["sse_interchunk_p99_s"]],
        "decode_roll 16 (this phase)": [plain["sse_interchunk_p50_s"], plain["sse_interchunk_p99_s"]],
        "phase 27": [phase27.get("sse_interchunk_p50_s"), phase27.get("sse_interchunk_p99_s")] if phase27 else None}
    res["http_tokens_per_s"] = {"pipelined": res["http, pipeline_rolls=True"]["tokens_per_s"],
                                "not pipelined": plain["tokens_per_s"], "streaming": streamed["tokens_per_s"],
                                "phase 27": phase27.get("tokens_per_s") if phase27 else None}
    log("routes, streaming and pipelined rolls: " + json.dumps({k: v for k, v in res.items() if not k.startswith(
        "http, ") and k != "streaming"}))
    if not res["streaming"]["alone_bitwise_decode_roll_16"]:
        failed.append(f"request {alone} alone over SSE (4-step rolls) is not its 16-step run in process")
    if STREAMING_ROLL not in streamed["rolls_by_length"]:
        failed.append(f"no {STREAMING_ROLL}-step roll while SSE requests decoded: {streamed['rolls_by_length']}")
    del eng
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("streaming and pipelined rolls: " + " | ".join(failed))
    return res


def routes_kernel_rows(gen, verify_inputs: tuple, chunks: list) -> list:
    """Phase 28's kernel rows: K2 over a paged verify step's gathered blocks
    (the largest verify dispatch of the echo run: 16 slots x 5 rows, per-slot
    q_offset and kv_len), K4 committing that verify's L*S*T rows, and K14
    on the prefix run's largest resumed chunk; each held against its plain
    version (K2 and K14 with planted keys and a planted fault, K4 bitwise),
    timed beside its library call, with its bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import paged_attention as pa

    dev = torch.device(DEVICE)
    i32 = dict(dtype=torch.int32, device=dev)
    tc = OmChatConfig().text
    L, H, KVH, D = tc.num_hidden_layers, tc.num_attention_heads, tc.num_key_value_heads, tc.attn_head_dim
    PS = SERVING["page_size"]
    rows = []
    lengths, active, tables = verify_inputs
    if not active.any():
        raise AssertionError("routes kernel rows: the verify handed no active slot")
    S, T = len(lengths), SPEC_DRAFT_LEN + 1
    W = tables.shape[1] * PS
    # K2 over the verify's blocks [S, KVH, W, D]: q_offset = length, kv_len = length + T (0 for idle slots);
    # a sink at column 0 and the direction u planted on each row's causal edge
    qo = torch.as_tensor(np.where(active, lengths, 0), **i32)
    kvl = torch.as_tensor(np.where(active, lengths + T, 0), **i32)
    u = _direction(gen, KVH, D)
    q = _randn(gen, S, T, H, D) + u.repeat_interleave(H // KVH, dim=0)
    k, v = _randn(gen, S, KVH, W, D), _randn(gen, S, KVH, W, D)
    for s in np.nonzero(active)[0]:
        k[s, :, 0] = 0.6 * u
        k[s, :, int(lengths[s]): int(lengths[s]) + T] = 0.8 * u[:, None]
    kw = dict(causal=True, q_offset=qo, kv_len=kvl)
    out = fa.flash_attention(q, k, v, kv_format="bntd", **kw)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k, v, **kw)
    err = check_close("K2 paged verify", out, ref, *ATTN_TOL["K2"])
    faults = {"causal edge one column late": check_fault_caught(
        "K2 paged verify", "the causal edge one column late",
        fa.flash_attention_plain(q, k, v, causal=True, q_offset=qo + 1, kv_len=torch.where(kvl > 0, kvl + 1, kvl)),
        ref, *ATTN_TOL["K2"])}
    p_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), iters=3, warmup=1)
    col = torch.arange(W, device=dev)
    mask = ((col[None, None] <= qo[:, None, None] + torch.arange(T, device=dev)[None, :, None])
            & (col[None, None] < kvl[:, None, None]))[:, None]
    qt = q.transpose(1, 2)
    ms, readings = device_times(lambda: fa.flash_attention(q, k, v, kv_format="bntd", **kw),
                                lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask, enable_gqa=True),
                                GRAPH_CALLS)
    live = np.nonzero(active)[0]
    cols = sum(int(lengths[s]) * T + T * (T + 1) // 2 for s in live)
    rows.append(dict(name=f"flash_attention[paged verify, S={S}x{T}]", source="omchat_torch/csrc/flash_attention.cu",
                     replaces="omchat_tpu/ops/flash_attention.py:246", max_abs_err=err, ms=ms["kernel"], plain_ms=p_ms,
                     library_ms=ms["library"], flops=4.0 * H * D * cols,
                     bytes=2 * q.numel() * 2 + sum(2 * KVH * (int(lengths[s]) + T) * D * 2 for s in live),
                     faults=faults, readings=readings["kernel"],
                     extra=f" slots={len(live)} width={W} mean_length={float(lengths[live].mean()):.0f}"
                           + eager_text(ms)))
    del q, k, v, out, ref, qt, mask

    # K4: the verify's L*S*T rows into a pool of the serving engine's pages, at its pages and offsets
    NP = SERVING["num_pages"] + 1
    kf, vf = _randn(gen, L * NP, KVH, PS, D), _randn(gen, L * NP, KVH, PS, D)
    pos = np.where(active[:, None], lengths[:, None] + np.arange(T)[None], np.arange(T)[None])
    page = np.where(active[:, None], np.take_along_axis(tables, np.minimum(pos // PS, tables.shape[1] - 1), 1),
                    SERVING["num_pages"])
    pages = torch.as_tensor((np.arange(L)[:, None, None] * NP + page[None]).reshape(-1), **i32)
    offs = torch.as_tensor(np.broadcast_to(pos % PS, (L, S, T)).reshape(-1), **i32)
    n = L * S * T
    k_rows, v_rows = _randn(gen, n, KVH, D), _randn(gen, n, KVH, D)
    k_ref, v_ref = kf.clone(), vf.clone()
    pa.commit_rows(kf, vf, pages, offs, k_rows, v_rows)
    torch.cuda.synchronize()
    pa.commit_rows_plain(k_ref, v_ref, pages, offs, k_rows, v_rows)
    if not (torch.equal(kf.view(torch.int16), k_ref.view(torch.int16))
            and torch.equal(vf.view(torch.int16), v_ref.view(torch.int16))):
        raise AssertionError(f"K4 commit_rows[L*S*T={n}]: the pool differs from the plain commit (bitwise)")
    p_ms = time_ms(lambda: pa.commit_rows_plain(k_ref, v_ref, pages, offs, k_rows, v_rows), iters=20)
    idx = (pages.long()[:, None], torch.arange(KVH, device=dev)[None, :], offs.long()[:, None])

    def library_commit():
        kf.index_put_(idx, k_rows)
        vf.index_put_(idx, v_rows)

    ms, readings = device_times(lambda: pa.commit_rows(kf, vf, pages, offs, k_rows, v_rows), library_commit,
                                GRAPH_CALLS)
    rows.append(dict(name=f"commit_rows[L*S*T={n}]", source="omchat_torch/csrc/commit_rows.cu",
                     replaces="omchat_tpu/ops/paged_attention.py:619", max_abs_err=0.0, ms=ms["kernel"], plain_ms=p_ms,
                     library_ms=ms["library"], flops=0.0, bytes=2 * (2 * n * KVH * D * 2) + 2 * n * 4, faults={},
                     readings=readings["kernel"],
                     extra=f" launch_floor_ms={k4_floor_ms(n, KVH, D):.5f} (an empty kernel on K4's grid, graphed)"
                           + eager_text(ms)))
    del kf, vf, k_ref, v_ref
    torch.cuda.empty_cache()

    # K14 on the prefix run's resumed chunk with the most causal columns: its starts (past the hit),
    # lengths and tables over a pool of ROUTES's pages; a sink at column 0 and u at each row's last column
    def causal_cols(c):
        return sum(int(m) * int(s) + int(m) * (int(m) + 1) // 2 for s, m in zip(c["start"], c["len"]))

    c14 = max((c for c in chunks if (c["start"] > 0).all()), key=causal_cols)
    (B, C), starts, clen, t14_np = c14["shape"], c14["start"], c14["len"], c14["tables"]
    NP = ROUTES["num_pages"] + 1
    pool_k, pool_v = _randn(gen, NP, KVH, PS, D), _randn(gen, NP, KVH, PS, D)
    kv14 = starts + clen
    for b in range(B):
        for p_, scale in ((0, 0.6), (int(kv14[b]) - 1, 0.8)):
            pool_k[int(t14_np[b][p_ // PS]), :, p_ % PS] = scale * u
    t14 = torch.as_tensor(t14_np, device=dev)
    q14 = _randn(gen, B, C, H, D) + u.repeat_interleave(H // KVH, dim=0)
    qo, kl = torch.as_tensor(starts, **i32), torch.as_tensor(kv14, **i32)
    out = pa.paged_flash_prefill(q14, pool_k, pool_v, kl, t14, qo)
    torch.cuda.synchronize()
    rowmask = (torch.arange(C, device=dev)[None] < torch.as_tensor(clen, device=dev)[:, None])[..., None, None]

    def k14_plain(q_offset, kv_len):
        return pa.paged_flash_prefill_plain(q14, pool_k, pool_v, kv_len, t14, q_offset) * rowmask

    ref = k14_plain(qo, kl)
    err = check_close("K14 prefix resume", out * rowmask, ref, *ATTN_TOL["K14"])
    faults = {"resumed one page late": check_fault_caught("K14 prefix resume", "the chunk resumed one page late",
                                                          k14_plain(qo + PS, kl + PS), ref, *ATTN_TOL["K14"])}
    k_ms = time_ms(lambda: pa.paged_flash_prefill(q14, pool_k, pool_v, kl, t14, qo), iters=L, warmup=3)
    p_ms = time_ms(lambda: pa.paged_flash_prefill_plain(q14, pool_k, pool_v, kl, t14, qo), iters=3, warmup=1)
    T14 = t14_np.shape[1] * PS
    idx14 = t14.long().reshape(-1)
    ar = torch.arange(T14, device=dev)
    mask14 = ((ar[None, None] <= qo[:, None, None] + torch.arange(C, device=dev)[None, :, None])
              & (ar[None, None] < kl[:, None, None]))[:, None]
    q14t = q14.transpose(1, 2)

    def k14_library():
        kv = [p.index_select(0, idx14).view(B, -1, KVH, PS, D).transpose(1, 2).reshape(B, KVH, T14, D)
              for p in (pool_k, pool_v)]
        return F.scaled_dot_product_attention(q14t, *kv, attn_mask=mask14, enable_gqa=True)

    lib_ms = time_ms(k14_library, iters=L, warmup=3)
    rows.append(dict(name="paged_flash_prefill[prefix resume]", source="omchat_torch/csrc/paged_flash_prefill.cu",
                     replaces="omchat_tpu/ops/paged_attention.py:442", max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                     library_ms=lib_ms, flops=4.0 * H * D * causal_cols(c14),
                     bytes=2 * B * C * H * D * 2 + 2 * KVH * int(kv14.sum()) * D * 2 + t14_np.size * 4 + 8 * B,
                     faults=faults, readings=None,
                     extra=f" B={B} C={C} q_offset={starts.tolist()} kv_len={kv14.tolist()}"))
    del q14, q14t, pool_k, pool_v, out, ref, mask14
    torch.cuda.empty_cache()

    for r in rows:
        flops = r.pop("flops")
        r["bound_ms"], r["bound_by"] = bound_ms(flops, r.pop("bytes"))
        caught = "".join(f"; fault '{f}' max_dev={d:.3g} (caught)" for f, d in r.pop("faults").items())
        readings = r.pop("readings")
        rate = rate_text(flops, r["ms"], r["bound_ms"], readings) if readings else \
            f" share_of_bound={r['bound_ms'] / r['ms']:.3f}"
        log(f"kernel {r['name']}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}){rate}"
            f"{r.pop('extra')} max_abs_err={r['max_abs_err']:.3g}{caught} ({CARD})")
    return rows


def paged_routes_on_the_card(gen, model, seed: int, phase27: dict = None) -> tuple:
    """Phase 28 at full width and depth on phase 3's weights: (a) the prefix
    cache, (b) speculative verify in the batch, (c) streaming rolls and (d)
    pipelined rolls, then the three kernel rows of their new regimes.  Every
    part runs and prints its lines; then the phase raises with every check
    that failed.  Returns (results, kernel rows, the rows' launches)."""
    import torch

    res, failed, rows, counts = {}, [], [], {}
    ROUTES_SEEN.clear()
    for name, run in (("prefix cache", lambda: prefix_cache_routes(model)),
                      ("verify logits", lambda: verify_vs_decode(model, small_surface(model.config, seed))),
                      ("speculative", lambda: speculative_in_the_batch(model)),
                      ("streaming and pipelined", lambda: streaming_and_pipelined(model, seed, phase27))):
        try:
            res[name] = run()
        except AssertionError as e:
            failed.append(f"{name}: {e}")
        torch.cuda.empty_cache()
    if "chunks" in ROUTES_SEEN and "verify" in ROUTES_SEEN:
        rows = routes_kernel_rows(gen, ROUTES_SEEN["verify"], ROUTES_SEEN["chunks"])
        # K2 and K4 counted in the verify ticks, K14 in the prefix run's timed wave
        counts = {r["name"]: ROUTES_SEEN[r["name"].split("[")[0]] for r in rows}
        missing = [n for n, c in counts.items() if not c]
        if missing:
            failed.append(f"kernels never launched on phase 28's paths: {missing}")
    else:
        failed.append("the kernel rows need the prefix and speculative runs' dispatches")
    if failed:
        raise AssertionError("phase 28 failed: " + " | ".join(failed))
    return res, rows, counts


# ---------------------------------------------------------------------------
# Phases 29-30: the slot engine (BatchEngine) and the eval entry point
# ---------------------------------------------------------------------------

# Phase 29: the slot engine's settings (the JAX server's --continuous-batching
# engine at phase 5's 16 slots and 4096 rows, chunks of 512 rows), the late
# joiner's budget, the image of the native tile pipeline's check and its limit
# (the fused pass computes x * (1/255/std) - mean/std where the numpy path
# computes (x/255 - mean)/std: one or two float32 ulps at |x| <= 2.7).
SLOT_ENGINE = dict(max_slots=16, max_len=4096, chunk_size=512, image_cache_size=0)
SLOT_JOIN_TOKENS, SLOT_STEP_READINGS, SLOT_STEP_CALLS = 32, 3, 10
NATIVE_IMAGE, NATIVE_TOL = (1000, 700), 1e-6
# Phase 30: EVAL_SAMPLES questions, the first EVAL_IMAGES with a seeded
# 448x448 PNG, EVAL_NEW_TOKENS greedy tokens each, serial and with
# EVAL_CONCURRENCY in flight; perplexity over PPL_WORDS seeded words (about
# 3900 byte tokens in two 2048-token windows).  At 2+2 layers each counted
# token's nll, kernels against the plain route, must be within PPL_TOKEN_GAP,
# and the plain route with each of PPL_FAULTS planted must leave it: a mean
# over thousands of tokens of random weights moves little under a wrong mask,
# so the check is a token's, and its limit lies between the sound gaps and
# the faults' (chip_probes/slot_eval_faults.py, three seeded texts on an H100:
# kernels vs plain at most 0.063 a token, the faults at least 3.96 and 1.29;
# their mean-nll gaps 0.146 and 0.002 would pass a limit of 0.2 on the mean).
EVAL_SAMPLES, EVAL_IMAGES, EVAL_NEW_TOKENS, EVAL_CONCURRENCY = 8, 4, 32, 4
PPL_WORDS, PPL_TOKEN_GAP = 700, 2 * LOGITS_ATOL
PPL_FAULTS = ("non-causal", "one future column")


def record_slot_run(eng) -> dict:
    """Wrap the slot engine's two dispatch points, the prefill chunk and the
    decode step, so that a run records each chunk's slot, start and length
    (what K2 is handed), each decode step's lengths and active flags (what K3
    and K4 are handed), each request's first-token logits (its last chunk's)
    and the time they were ready (the engine picks the first token from them
    at once), and CUDA events around both dispatches (a step's stage, replay
    and readback).  Each entry carries ``rec["label"]`` at its time."""
    import numpy as np
    import torch

    rec = {"label": None, "steps": [], "chunks": [], "spans": [], "first": {}, "logits": {}}
    chunk, decode = eng._prefill_chunk, eng._decode

    def timed(kind, fn, *a):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a)
        end.record()
        rec["spans"].append(dict(label=rec["label"], kind=kind, start=start, end=end))
        return out

    def on_chunk(req):
        n = min(eng.chunk_size, int(req.plan.lengths[0]) - req.prefill_pos)
        rec["chunks"].append(dict(label=rec["label"], slot=req.slot, start=req.prefill_pos, len=n))
        logits = timed("chunk", chunk, req)
        if req.prefill_pos + n >= int(req.plan.lengths[0]):
            rec["logits"][req.request_id] = logits[0].float()
            torch.cuda.synchronize()
            rec["first"][req.request_id] = time.perf_counter()
        return logits

    def on_decode(decoding):
        active = np.zeros(eng.max_slots, bool)
        active[[r.slot for r in decoding]] = True
        rec["steps"].append(dict(label=rec["label"], lengths=eng._lengths.copy(), active=active))
        return timed("step", decode, decoding)

    eng._prefill_chunk, eng._decode = on_chunk, on_decode
    return rec


def slot_spans(rec, label, kind) -> list:
    return [s["start"].elapsed_time(s["end"]) for s in rec["spans"] if s["label"] == label and s["kind"] == kind]


def slot_timed_run(cfg, params, work, label: str, cache_dtype=None, precompile: bool = True,
                   counted=None) -> tuple:
    """Phase 29's timed run of ``work`` on a fresh slot engine (``cache_dtype``
    e4m3 for the rerun): ``precompile`` (both decode graphs), a warm-up at 4
    new tokens, then SERVING_NEW_TOKENS with K1-K4 (or ``counted``) counted
    from 0: tokens/s, TTFT percentiles, the step and chunk dispatch wall ms,
    steps graphed / eager.  Every request must return all its tokens, every
    step be a replay and every kernel launch.  Returns (results, engine,
    record)."""
    import numpy as np
    import torch

    from omchat_torch.runtime.batch_engine import BatchEngine

    eng = BatchEngine(cfg, params, device=DEVICE, cache_dtype=cache_dtype, **SLOT_ENGINE)
    rec = record_slot_run(eng)
    t0 = time.perf_counter()
    if precompile:
        eng.precompile()
    capture_s = time.perf_counter() - t0
    rec["label"] = "warm-up"
    drive(eng, work, 4)
    eng.reset_latency_stats()
    counted = counted or counters()
    for c in counted.values():
        c.launches = 0
    graph = eng._steps[False]
    replays = graph.replays
    rec["label"] = "timed"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = drive(eng, work, SERVING_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counted.items()}
    ttfts = [rec["first"][r] - t0 for r in rids]
    done = [eng.pop_result(r) for r in rids]
    steps = [s for s in rec["steps"] if s["label"] == "timed"]
    step_ms = slot_spans(rec, "timed", "step")
    full = [ms for s, ms in zip(steps, step_ms) if s["active"].all()]
    res = {
        "card": CARD, "cache": str(eng.cache.k.dtype).replace("torch.", ""), "requests": len(work),
        "generated_tokens": sum(len(t) for t, _ in done), "wall_s": wall,
        "tokens_per_s": sum(len(t) for t, _ in done) / wall,
        "ttft_p50_s": float(np.percentile(ttfts, 50)), "ttft_p99_s": float(np.percentile(ttfts, 99)),
        "decode_steps": len(steps), "steps_graphed": eng.steps_graphed, "steps_eager": eng.steps_eager,
        "step_wall_ms_16_slots": sum(full) / len(full) if full else None, "steps_at_16_slots": len(full),
        "step_wall_ms_mean": sum(step_ms) / len(step_ms),
        "chunk_dispatches": len(slot_spans(rec, "timed", "chunk")),
        "chunk_dispatch_ms_mean": float(np.mean(slot_spans(rec, "timed", "chunk"))),
        "chunk_dispatch_ms_sum": sum(slot_spans(rec, "timed", "chunk")),
        "capture_s": capture_s if precompile else None, "launches": launches,
    }
    failed = []
    short = [i for i, (t, _) in enumerate(done) if len(t) != SERVING_NEW_TOKENS]
    if short:
        failed.append(f"requests {short} did not return {SERVING_NEW_TOKENS} tokens")
    if eng.steps_eager or graph.replays - replays != len(steps):
        failed.append(f"{eng.steps_eager} steps eager, {graph.replays - replays} replays of {len(steps)} steps")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        failed.append(f"kernels never launched on the slot engine's path: {missing}")
    res["tokens"] = [t for t, _ in done]
    if failed:
        log(f"{label}: " + json.dumps({k: v for k, v in res.items() if k != "tokens"}))
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return res, eng, rec


def slot_step_ms(eng, rec) -> dict:
    """The 16-slot decode step graphed (one replay) beside the same body run
    eagerly, in turns (``SLOT_STEP_READINGS`` readings of ``SLOT_STEP_CALLS``
    calls, CUDA events: the card's timeline, the host's issue gaps
    included), on the staged lengths of the timed run's last step with every
    slot decoding."""
    import numpy as np

    steps = [s for s in rec["steps"] if s["label"] == "timed" and s["active"].all()]
    snap = steps[-1] if steps else [s for s in rec["steps"] if s["label"] == "timed"][-1]
    n = eng.max_slots
    eng._stage(np.full(n, 1000, np.int32), snap["lengths"], snap["active"].astype(np.int32), np.zeros(n, np.int32),
               eng._sampling_rows([]))
    graph = eng._steps[False].graph
    got = {"graphed": [], "eager": []}
    for _ in range(SLOT_STEP_READINGS):
        got["graphed"].append(time_ms(graph.replay, iters=SLOT_STEP_CALLS, warmup=1))
        got["eager"].append(time_ms(lambda: eng._decode_body(False), iters=SLOT_STEP_CALLS, warmup=1))
    return {f"{k}_ms": sorted(v)[len(v) // 2] for k, v in got.items()} | {"readings": got,
                                                                           "active": int(snap["active"].sum())}


def late_joiner(eng, work) -> dict:
    """A running request's tokens with and without a late joiner, bitwise, on
    the timed run's engine: request 1 (text) alone, then again with request 0
    (an image prompt: its ViT and chunk run between request 1's steps)
    submitted once request 1 has decoded 4 tokens."""
    a, b = work[1], work[0]
    alone = eng.result(drive(eng, [a], SLOT_JOIN_TOKENS)[0])
    ra = eng.submit(a[0], a[1], max_new_tokens=SLOT_JOIN_TOKENS, eos_token_id=-1)
    while len(eng.requests[ra].generated) < 4:
        eng.step()
    rb = eng.submit(b[0], b[1], max_new_tokens=SLOT_JOIN_TOKENS, eos_token_id=-1)
    eng.run_to_completion()
    joined, other = eng.result(ra), eng.result(rb)
    res = {"tokens": len(joined), "bitwise_equal": joined == alone, "joiner_tokens": len(other)}
    if joined != alone:
        raise AssertionError(f"late joiner: request 1's tokens changed ({first_divergence([joined], [alone])})")
    return res


def parity_by_phase7(label, got: list, got_first: list, ref_engine, work, gens, ref_first=None) -> list:
    """Phase 7's rule for each request: its first-token logits within phase 4's
    limits of the single-request engine's (``ref_engine``, or one engine a
    request), and its greedy tokens equal up to the first step whose
    reference top-2 margin is under PARITY_MARGIN.  The reference's
    first-token logits are appended to ``ref_first`` when it is given."""
    import torch

    out = []
    for i, ((ids, tiles), toks, first, gen) in enumerate(zip(work, got, got_first, gens)):
        ref = ref_engine[i] if isinstance(ref_engine, list) else ref_engine
        steps = []
        want = ref.generate([ids], tiles, gen, logits_callback=lambda s, lg: steps.append(lg[0].float())).token_ids[0]
        if ref_first is not None:
            ref_first.append(steps[0])
        diff = check_close(f"{label} first-token logits (request {i})", first, steps[0], LOGITS_ATOL, LOGITS_RTOL)
        margins = [float(t[0] - t[1]) for t in (torch.topk(lg, 2).values for lg in steps)]
        upto = next((j for j, m in enumerate(margins) if m < PARITY_MARGIN), len(margins))
        if toks[:upto] != want[:upto]:
            raise AssertionError(f"{label}, request {i}: tokens {toks[:upto]} != {want[:upto]} (compared up to "
                                 f"step {upto}, the first top-2 margin under {PARITY_MARGIN})")
        out.append({"image": tiles is not None, "logits_max_abs_diff": diff, "tokens_compared": upto,
                    "tokens_equal_beyond": toks == want})
    return out


def slot_parity_small(small, work, seed: int) -> dict:
    """At full width and 2+2 layers: 4 requests (1 image, 3 text) through the
    slot engine against the single-request engine, by phase 7's rule; then a
    LoRA bank of two seeded rank-16 adapters, requests under ids 0 / 1 / 2 in
    one batch against the base engine and ``merge_lora`` engines.  The same
    batch with adapters 1 and 2 swapped, and with the bank ignored (every id
    0), must put the first-token logits of the requests it moves outside
    phase 4's limits of their merged engines', or those limits would pass a
    bank that mixes up or drops adapters."""
    import torch

    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.batch_engine import BatchEngine
    from omchat_torch.runtime.generate import OmChatEngine
    from omchat_torch.training.lora import build_lora_bank, merge_lora

    cfg, params = small.config, small.engine.params
    gen = GenerationConfig(max_new_tokens=PARITY_NEW_TOKENS, eos_token_id=-1)
    eng = BatchEngine(cfg, params, device=DEVICE, **SLOT_ENGINE)
    rec = record_slot_run(eng)
    rids = drive(eng, work[:4], PARITY_NEW_TOKENS)
    ref = OmChatEngine(cfg, params, image_cache_size=0, device=DEVICE)
    res = {"vs single-request": parity_by_phase7("slot vs single-request", [eng.result(r) for r in rids],
                                                 [rec["logits"][r] for r in rids], ref, work[:4], [gen] * 4)}
    del eng
    adapters = seeded_adapters(params, seed)
    eng = BatchEngine(cfg, params, device=DEVICE, lora_bank=build_lora_bank(adapters, dtype=torch.bfloat16),
                      **SLOT_ENGINE)
    rec = record_slot_run(eng)
    lora_work = work[1:4]
    rids = [eng.submit(ids, tiles, max_new_tokens=PARITY_NEW_TOKENS, eos_token_id=-1, adapter_id=a)
            for (ids, tiles), a in zip(lora_work, (0, 1, 2))]
    eng.run_to_completion()
    refs = [ref] + [OmChatEngine(cfg, merge_lora(params, ad), image_cache_size=0, device=DEVICE) for ad in adapters]
    want = []
    res["lora bank, adapters 0 / 1 / 2"] = parity_by_phase7(
        "slot LoRA bank vs merged weights", [eng.result(r) for r in rids], [rec["logits"][r] for r in rids], refs,
        lora_work, [gen] * 3, ref_first=want)
    faults, missed = {}, []
    for fault, ids_ in (("adapters 1 and 2 swapped", (0, 2, 1)), ("bank ignored", (0, 0, 0))):
        rids = [eng.submit(ids, tiles, max_new_tokens=1, eos_token_id=-1, adapter_id=a)
                for (ids, tiles), a in zip(lora_work, ids_)]
        eng.run_to_completion()
        faults[fault] = {}
        for i, (r, a) in enumerate(zip(rids, ids_)):
            if a != i:
                dev = (rec["logits"][r] - want[i]).abs()
                outside = int((dev > LOGITS_ATOL + LOGITS_RTOL * want[i].abs()).sum())
                faults[fault][f"id {i} run as {a}"] = {"max_dev": float(dev.max()), "logits_outside": outside}
                if not outside:
                    missed.append(f"{fault}: request under id {i} run as {a} stays within phase 4's limits "
                                  f"(max dev {float(dev.max()):.4g})")
    res["lora bank, planted faults"] = faults
    del eng, refs, ref
    torch.cuda.empty_cache()
    if missed:
        raise AssertionError(f"the limits would pass a faulty LoRA bank: {missed} ({json.dumps(res)})")
    return res


def native_pipeline_check(seed: int) -> dict:
    """``anyres_process_native`` (built from ``omchat_torch/csrc_host`` by
    ``use_native=True``) against the numpy path on a seeded 1000x700 image:
    within NATIVE_TOL, with both paths' host ms (median of 5)."""
    import numpy as np
    from PIL import Image

    from omchat_torch.processing.image_processor import process_anyres_image

    w, h = NATIVE_IMAGE
    img = Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8))
    t0 = time.perf_counter()
    native = process_anyres_image(img, use_native=True)
    first_s = time.perf_counter() - t0
    ref = process_anyres_image(img, use_native=False)
    diff = float(np.abs(native - ref).max())

    def ms(fn):
        got = []
        for _ in range(5):
            t = time.perf_counter()
            fn()
            got.append((time.perf_counter() - t) * 1e3)
        return sorted(got)[2]

    res = {"tiles": int(native.shape[0]), "max_abs_diff": diff, "first_call_s (build or load)": first_s,
           "native_ms": ms(lambda: process_anyres_image(img, use_native=True)),
           "numpy_ms": ms(lambda: process_anyres_image(img, use_native=False))}
    if native.shape != ref.shape or diff > NATIVE_TOL:
        raise AssertionError(f"native tile pipeline vs numpy: {res}")
    return res


def slot_kernel_rows(gen, seen: dict) -> list:
    """Phase 29's kernel rows at what the timed run handed the kernels: K2 on
    its largest chunk (512 rows at q_offset = the chunk's start, one slot of
    a [16, 4, 4096, 128] layer cache, keys planted on the causal edge; the
    edge a column late must fall outside), K3 on a step with 16 rows of
    unequal lengths and parked rows of 0 cache rows (keys planted at each
    row's last valid row, the first past it, a split's edge and on parked
    rows' row 0; one row's length taken from its neighbour, and a parked row
    given its neighbour's length, must fall outside), K4 committing that
    step's 28 x 16 rows, parked rows at the last row (bitwise); kernel,
    plain, library and bound times."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops import decode_attention as da
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import paged_attention as pa

    cfg = OmChatConfig().text
    H, KVH, D, L = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.attn_head_dim, cfg.num_hidden_layers
    B, T, S = SLOT_ENGINE["max_slots"], SLOT_ENGINE["max_len"], SLOT_ENGINE["chunk_size"]
    rows = []

    # K2: the chunk reaching the most cache rows
    ch = max(seen["chunks"], key=lambda c: c["start"] + c["len"])
    s, c0, clen = ch["slot"], ch["start"], ch["len"]
    u = _direction(gen, KVH, D)
    q = _randn(gen, 1, S, H, D) + u.repeat_interleave(H // KVH, dim=0)
    k, v = _randn(gen, B, KVH, T, D), _randn(gen, B, KVH, T, D)
    k[s, :, c0: min(c0 + S + 1, T)] = 0.8 * u[:, None]
    ks, vs = k[s: s + 1], v[s: s + 1]
    qo = torch.full((1,), c0, dtype=torch.int32, device=DEVICE)
    kvl = qo + clen
    kw = dict(causal=True, q_offset=qo, kv_len=kvl)
    # the chunk's padding rows sit past kv_len, where K2's output is unspecified (the engine reads none of them)
    valid = (torch.arange(S, device=DEVICE) < clen)[None, :, None, None]
    out = fa.flash_attention(q, ks, vs, kv_format="bntd", **kw)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, ks, vs, **kw) * valid
    err = check_close("K2 slot chunk", out * valid, ref, *ATTN_TOL["K2"])
    faults = {"causal edge one column late": check_fault_caught(
        "K2 slot chunk", "the causal edge one column late",
        fa.flash_attention_plain(q, ks, vs, causal=True, q_offset=qo + 1, kv_len=kvl + 1) * valid, ref,
        *ATTN_TOL["K2"])}
    p_ms = time_ms(lambda: fa.flash_attention_plain(q, ks, vs, **kw), iters=3, warmup=1)
    kv_rows = c0 + clen
    qt = q.transpose(1, 2)
    mask = ((torch.arange(kv_rows, device=DEVICE)[None, :] <= (c0 + torch.arange(S, device=DEVICE))[:, None])
            & (torch.arange(kv_rows, device=DEVICE)[None, :] < kv_rows))
    ms, readings = time_in_turns({
        "kernel": lambda: fa.flash_attention(q, ks, vs, kv_format="bntd", **kw),
        "library": lambda: F.scaled_dot_product_attention(qt, ks[:, :, :kv_rows], vs[:, :, :kv_rows],
                                                          attn_mask=mask, enable_gqa=True)})
    # the work the engine needs: the chunk's clen valid rows (the padding rows' output is read by no one)
    cols = sum(min(c0 + i + 1, kv_rows) for i in range(clen))
    rows.append(dict(name=f"flash_attention[slot chunk S={S}]", source="omchat_torch/csrc/flash_attention.cu",
                     replaces="omchat_tpu/ops/flash_attention.py:246", max_abs_err=err, ms=ms["kernel"],
                     plain_ms=p_ms, library_ms=ms["library"], flops=4.0 * H * D * cols,
                     bytes=(2 * clen * H * D + 2 * KVH * kv_rows * D) * 2, faults=faults, readings=readings["kernel"],
                     extra=f" slot={s} q_offset={c0} chunk_len={clen} kv_len={kv_rows} (a [{B}, {KVH}, {T}, {D}] "
                           f"layer cache)"))
    del q, k, v, out, ref, qt, ks, vs

    # K3: the step with the most decoding rows that still has a parked row
    step = max((st for st in seen["steps"] if not st["active"].all()), key=lambda st: int(st["active"].sum()))
    lens = np.where(step["active"], step["lengths"], 0).astype(np.int32)
    parked = [b for b in range(B) if not step["active"][b]]
    kc, vc = _randn(gen, L, B, KVH, T, D), _randn(gen, L, B, KVH, T, D)
    u = _direction(gen, KVH, D)
    qd = _randn(gen, B, 1, H, D) + u.repeat_interleave(H // KVH, dim=0)
    splits, srows, _ = split_edge(B, KVH, T, int(lens.max()))
    for b in range(B):
        n = int(lens[b])
        plant = (0,) if n == 0 else tuple({0, max(n - 1, 0), n, max(1, n // srows) * srows} - {T})
        for row in plant:
            kc[:, b, :, row] = 0.8 * u
    kn_, vn_ = (0.8 * u)[None].expand(B, KVH, D).contiguous(), _randn(gen, B, KVH, D)
    clen = torch.as_tensor(lens, dtype=torch.int32, device=DEVICE)
    out = da.flash_decode_stacked(qd, kc, vc, clen, L - 1, kn_, vn_)
    torch.cuda.synchronize()
    ref = da.flash_decode_stacked_plain(qd, kc, vc, clen, L - 1, kn_, vn_)
    err = check_close("K3 at 16 slots", out, ref, *ATTN_TOL["K3"])
    live = [b for b in range(B) if lens[b]]
    nb, nc = next((b, c) for b, c in zip(live, live[1:]) if lens[b] != lens[c])
    wrong = clen.clone()
    wrong[nb] = clen[nc]
    faults = {f"row {nb}'s length from row {nc}": check_fault_caught(
        "K3 at 16 slots", "one row's length taken from its neighbour",
        da.flash_decode_stacked_plain(qd, kc, vc, wrong, L - 1, kn_, vn_), ref, *ATTN_TOL["K3"])}
    pb = parked[0]
    wrong = clen.clone()
    wrong[pb] = int(lens.max())
    faults[f"parked row {pb} given {int(lens.max())} rows"] = check_fault_caught(
        "K3 at 16 slots", "a parked row attending to cache rows",
        da.flash_decode_stacked_plain(qd, kc, vc, wrong, L - 1, kn_, vn_), ref, *ATTN_TOL["K3"])
    it = iter(range(10**9))
    p_ms = time_ms(lambda: da.flash_decode_stacked_plain(qd, kc, vc, clen, next(it) % L, kn_, vn_), iters=4,
                   warmup=1)
    # the library call: SDPA over each row's valid cache rows and its self column (masked to the row's length)
    m = int(lens.max())
    kx = torch.cat([kc[:, :, :, :m], kn_[None, :, :, None].expand(L, B, KVH, 1, D)], dim=3)
    vx = torch.cat([vc[:, :, :, :m], vn_[None, :, :, None].expand(L, B, KVH, 1, D)], dim=3)
    col = torch.arange(m + 1, device=DEVICE)
    xmask = ((col[None, :] < clen[:, None]) | (col[None, :] == m))[:, None, None, :]
    qs = qd.transpose(1, 2)

    def library_decode():
        li = next(it) % L
        return F.scaled_dot_product_attention(qs, kx[li], vx[li], attn_mask=xmask, enable_gqa=True)

    ms, readings = device_times(lambda: da.flash_decode_stacked(qd, kc, vc, clen, next(it) % L, kn_, vn_),
                                library_decode, L)
    total = int(lens.sum()) + B
    rows.append(dict(name=f"flash_decode_stacked[B={B} slots]", source="omchat_torch/csrc/flash_decode_stacked.cu",
                     replaces="omchat_tpu/ops/decode_attention.py:109", max_abs_err=err, ms=ms["kernel"],
                     plain_ms=p_ms, library_ms=ms["library"], flops=4.0 * H * D * total,
                     bytes=(2 * KVH * total * D + 2 * B * H * D) * 2, faults=faults, readings=readings["kernel"],
                     extra=f" cache_len={lens.tolist()} parked={parked}" + split_text(splits, srows, B, KVH, H)
                           + eager_text(ms)))
    del kx, vx

    # K4: the step's L x B rows, parked rows at the cache's last row
    n = L * B
    kf, vf = kc.view(n, KVH, T, D), vc.view(n, KVH, T, D)
    pages = torch.arange(n, dtype=torch.int32, device=DEVICE)
    wp = np.where(step["active"], step["lengths"], T - 1).astype(np.int32)
    offs = torch.as_tensor(np.tile(wp, L), dtype=torch.int32, device=DEVICE)
    k_rows, v_rows = _randn(gen, n, KVH, D), _randn(gen, n, KVH, D)
    k_ref, v_ref = kf.clone(), vf.clone()
    pa.commit_rows(kf, vf, pages, offs, k_rows, v_rows)
    torch.cuda.synchronize()
    pa.commit_rows_plain(k_ref, v_ref, pages, offs, k_rows, v_rows)
    if not (torch.equal(kf.view(torch.int16), k_ref.view(torch.int16))
            and torch.equal(vf.view(torch.int16), v_ref.view(torch.int16))):
        raise AssertionError("K4 at 16 slots: the cache differs from the plain commit (bitwise, all rows)")
    del k_ref, v_ref
    p_ms = time_ms(lambda: pa.commit_rows_plain(kf, vf, pages, offs, k_rows, v_rows), iters=20)
    idx = (pages.long()[:, None], torch.arange(KVH, device=DEVICE)[None, :], offs.long()[:, None])

    def library_commit():
        kf.index_put_(idx, k_rows)
        vf.index_put_(idx, v_rows)

    ms, readings = device_times(lambda: pa.commit_rows(kf, vf, pages, offs, k_rows, v_rows), library_commit,
                                GRAPH_CALLS)
    rows.append(dict(name=f"commit_rows[L*B={n} slots]", source="omchat_torch/csrc/commit_rows.cu",
                     replaces="omchat_tpu/ops/paged_attention.py:619", max_abs_err=0.0, ms=ms["kernel"],
                     plain_ms=p_ms, library_ms=ms["library"], flops=0.0, bytes=2 * (2 * n * KVH * D * 2) + 2 * n * 4,
                     faults={}, readings=readings["kernel"],
                     extra=f" parked rows at {T - 1}: {L * len(parked)}; launch_floor_ms="
                           f"{k4_floor_ms(n, KVH, D):.5f} (an empty kernel on K4's grid, graphed)" + eager_text(ms)))
    del kc, vc, kf, vf

    for r in rows:
        flops = r.pop("flops")
        r["bound_ms"], r["bound_by"] = bound_ms(flops, r.pop("bytes"))
        caught = "".join(f"; fault '{f}' max_dev={d:.3g} (caught)" for f, d in r.pop("faults").items())
        log(f"kernel {r['name']}: kernel_ms={r['ms']:.5f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.5f} bound_ms={r['bound_ms']:.5f} ({r['bound_by']})"
            f"{rate_text(flops, r['ms'], r['bound_ms'], r.pop('readings'))}{r.pop('extra')} "
            f"max_abs_err={r['max_abs_err']:.3g}{caught} ({CARD})")
    torch.cuda.empty_cache()
    return rows


def slot_engine_on_the_card(gen, model, small, seed: int) -> tuple:
    """Phase 29 at full width and depth on phase 3's weights: the slot engine's
    timed run of phase 5's workload (bf16, then an e4m3 rerun), its graphed
    step beside the eager one, a late joiner, the 2+2-layer parity and LoRA
    bank checks, the native tile pipeline and the three kernel rows.  Every
    part runs and prints its line; then the phase raises with every check
    that failed.  Returns (results, kernel rows, the rows' launches)."""
    import torch

    from omchat_torch.ops.fp8 import E4M3

    cfg, params = model.config, model.engine.params
    work = serving_workload(cfg)
    res, failed, rows, counts, seen = {}, [], [], {}, None
    try:
        timed, eng, rec = slot_timed_run(cfg, params, work, "slot engine")
        timed["step_ms"] = slot_step_ms(eng, rec)
        seen = dict(steps=[s for s in rec["steps"] if s["label"] == "timed"],
                    chunks=[c for c in rec["chunks"] if c["label"] == "timed"], launches=timed["launches"])
        log("slot engine (16 slots, 4096 rows, chunks of 512; phase 5's workload): " + json.dumps(
            {k: v for k, v in timed.items() if k != "tokens"}))
        res["timed"] = timed
        rec["label"] = "late joiner"
        res["late joiner"] = late_joiner(eng, work)
        log("slot engine, late joiner: " + json.dumps(res["late joiner"]))
        del eng, rec
        torch.cuda.empty_cache()
    except AssertionError as e:
        failed.append(f"timed run: {e}")
    for name, run in (("e4m3", lambda: slot_timed_run(cfg, params, work, "slot engine (e4m3 cache)", E4M3,
                                                      precompile=False)[0]),
                      ("2+2 layers", lambda: slot_parity_small(small, work, seed)),
                      ("native tile pipeline", lambda: native_pipeline_check(seed))):
        try:
            out = run()
            if name == "e4m3":
                base = res.get("timed", {}).get("tokens")
                out["first_step_leaving_bf16"] = first_divergence(out.pop("tokens"), base) if base else None
            res[name] = out
            log(f"slot engine, {name}: " + json.dumps(out))
        except AssertionError as e:
            failed.append(f"{name}: {e}")
        torch.cuda.empty_cache()
    if seen is not None:
        rows = slot_kernel_rows(gen, seen)
        la = seen["launches"]
        counts = {rows[0]["name"]: la["flash_attention"], rows[1]["name"]: la["flash_decode_stacked"],
                  rows[2]["name"]: la["commit_rows"]}
    if failed:
        raise AssertionError("phase 29 failed: " + " | ".join(failed))
    return res, rows, counts


def eval_files(directory: str, seed: int) -> tuple:
    """Phase 30's question file (EVAL_SAMPLES questions, the first EVAL_IMAGES
    with a seeded 448x448 PNG), its truths and a seeded text for perplexity:
    (question file, truths file, text file, the questions)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    questions = []
    for i in range(EVAL_SAMPLES):
        q = {"question_id": i, "text": f"Question {i}: what is shown, and what colour is it?"}
        if i < EVAL_IMAGES:
            name = f"img{i}.png"
            Image.fromarray(rng.integers(0, 256, (448, 448, 3), dtype=np.uint8)).save(os.path.join(directory, name))
            q["image"] = name
        questions.append(q)
    paths = [os.path.join(directory, n) for n in ("questions.jsonl", "truths.json", "text.txt")]
    with open(paths[0], "w") as f:
        f.writelines(json.dumps(q) + "\n" for q in questions)
    with open(paths[1], "w") as f:
        json.dump({str(i): "red" for i in range(EVAL_SAMPLES)}, f)
    words = ["".join(chr(97 + c) for c in rng.integers(0, 26, int(rng.integers(2, 8)))) for _ in range(PPL_WORDS)]
    with open(paths[2], "w") as f:
        f.write(" ".join(words))
    return (*paths, questions)


def eval_runs(model, directory: str, files: tuple, label: str) -> dict:
    """``cli/eval.run`` on ``model`` over phase 30's files, serial, then with
    EVAL_CONCURRENCY in flight, then ``--perplexity``: samples/s of each
    (wall, the model's synchronize included), the answers' token ids, the
    perplexity, K2's launches in the perplexity run."""
    import torch

    from omchat_torch.cli import eval as cli_eval
    from omchat_torch.ops import flash_attention as fa

    q, truths, text, _ = files
    res = {}
    for name, extra in (("serial", []), (f"concurrency {EVAL_CONCURRENCY}", ["--concurrency", str(EVAL_CONCURRENCY)])):
        answers = os.path.join(directory, f"answers-{label}-{extra[-1] if extra else 1}.jsonl")
        args = cli_eval.build_parser().parse_args([
            "--model-path", "(in process)", "--benchmark", "gqa", "--question-file", q, "--image-folder", directory,
            "--answers-file", answers, "--truths-file", truths, "--max-new-tokens", str(EVAL_NEW_TOKENS), *extra])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cli_eval.run(args, model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(answers) as f:
            toks = [ids_of(json.loads(line)["text"]) for line in f]
        res[name] = {"samples_per_s": EVAL_SAMPLES / wall, "wall_s": wall, "accuracy": out["accuracy"],
                     "answer_tokens": [len(t) for t in toks], "tokens": toks}
    # the same concurrent eval on a caller-built paged engine whose rolls were captured first (the CLI's
    # call builds its engine, and captures each roll shape at its first use, within its wall time)
    from omchat_torch.eval.harness import read_question_file, run_eval_concurrent
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    eng = PagedBatchEngine(model.config, model.engine.params, max_slots=EVAL_CONCURRENCY, num_pages=264,
                           max_len=8192, decode_roll=8, prefill_chunk=4096, device=DEVICE)
    eng.precompile()
    t0 = time.perf_counter()
    run_eval_concurrent(model, read_question_file(q, directory), os.path.join(directory, f"answers-{label}-pc.jsonl"),
                        max_new_tokens=EVAL_NEW_TOKENS, concurrency=EVAL_CONCURRENCY, progress=False, engine=eng)
    torch.cuda.synchronize()
    res[f"concurrency {EVAL_CONCURRENCY}, precompiled engine"] = {"samples_per_s": EVAL_SAMPLES / (time.perf_counter() - t0),
                                                "capture_ms": eng.capture_ms(), "rolls_eager": eng.rolls_eager,
                                                "rolls_graphed": eng.rolls_graphed}
    del eng
    args = cli_eval.build_parser().parse_args(["--model-path", "(in process)", "--perplexity", text])
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    ppl = cli_eval.run(args, model)
    torch.cuda.synchronize()
    res["perplexity"] = {k: ppl[k] for k in ("value", "nll", "tokens", "windows")} | {
        "wall_s": time.perf_counter() - t0, "flash_attention_launches": fa.flash_attention.launches}
    return res


def perplexity_per_token(model, text: str, fault=None) -> tuple:
    """The entry point's ``perplexity`` of ``text`` on ``model``, and the
    negative log-likelihood of each token it counts ([N] fp32, in order;
    ``cross_entropy_loss`` is wrapped to keep its terms).  ``fault`` plants
    one in the causal attention of the plain route: "non-causal" (each row
    sees its whole window) or "one future column" (each row also sees the
    next token, its own target)."""
    import torch

    from omchat_torch.eval.harness import perplexity
    from omchat_torch.models import qwen2
    from omchat_torch.training import train_step

    attention, ce, kept = qwen2.attention, train_step.cross_entropy_loss, []

    def faulty(q, k, v, *, causal=False, q_offset=None, **kw):
        if causal and fault == "non-causal":
            causal = False
        elif causal:
            q_offset = (k.shape[1] - q.shape[1] if q_offset is None else q_offset) + 1
        return attention(q, k, v, causal=causal, q_offset=q_offset, **kw)

    def keeping(logits, labels):
        valid = (labels >= 0) & (labels < logits.shape[-1])
        lg = logits.float()[valid]
        kept.append(torch.logsumexp(lg, -1) - lg.gather(-1, labels[valid].long()[:, None])[:, 0])
        return ce(logits, labels)

    train_step.cross_entropy_loss = keeping
    if fault is not None:
        qwen2.attention = faulty
    try:
        res = perplexity(model, text)
    finally:
        train_step.cross_entropy_loss, qwen2.attention = ce, attention
    return res, torch.cat(kept)


def perplexity_gaps(model, plain, text: str) -> dict:
    """The perplexity of ``text`` through the kernels (``model``) and the
    plain route (``plain``), and the plain route with each of PPL_FAULTS
    planted: each one's largest per-token nll gap to the plain route's and
    the gap of their mean nll."""
    base, base_tok = perplexity_per_token(plain, text)
    out = {"plain_nll": base["nll"], "tokens": base["tokens"]}
    for name, fault, m in [("kernels", None, model)] + [(f, f, plain) for f in PPL_FAULTS]:
        res, tok = perplexity_per_token(m, text, fault)
        out[name] = {"nll": res["nll"], "mean_nll_gap": abs(res["nll"] - base["nll"]),
                     "token_nll_gap_max": float((tok - base_tok).abs().max())}
    return out


def eval_on_the_card(model, small, seed: int) -> dict:
    """Phase 30: the eval entry point (``cli/eval.run``, the port's
    ``omchat_torch/cli/eval.py`` on an in-process model) on phase 3's weights
    with ``id_tokenizer`` (answers carry their token ids): EVAL_SAMPLES
    questions serial and with EVAL_CONCURRENCY in flight (the paged engine),
    samples/s of each; ``--perplexity`` (K2 on cacheless windows).  At 2+2
    layers the serial answers must be the single-request engine's tokens, the
    concurrent ones agree with them up to the first step whose top-2 margin
    is under PARITY_MARGIN, and the perplexity through the kernels be finite
    with each counted token's nll within PPL_TOKEN_GAP of
    ``attn_impl="plain"``'s, which the plain route with each of PPL_FAULTS
    planted must leave."""
    import shutil
    import tempfile

    import torch
    from PIL import Image

    from omchat_torch.api import omchat_model
    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.generate import OmChatEngine

    directory = tempfile.mkdtemp(prefix="chip-smoke-eval-")
    res, failed = {}, []
    try:
        files = eval_files(directory, seed)
        full = eval_runs(omchat_model(id_tokenizer(False), model.engine), directory, files, "full")
        serial, conc = full["serial"]["tokens"], full[f"concurrency {EVAL_CONCURRENCY}"]["tokens"]
        full["answers_equal"] = sum(a == b for a, b in zip(serial, conc))
        full["first_step_leaving_serial"] = first_divergence(conc, serial)
        res["full depth"] = full
        if not (full["perplexity"]["value"] < float("inf") and full["perplexity"]["flash_attention_launches"]):
            failed.append(f"full-depth perplexity {full['perplexity']}")

        sm = omchat_model(id_tokenizer(False), small.engine)
        two = eval_runs(sm, directory, files, "2+2")
        gen = GenerationConfig(max_new_tokens=EVAL_NEW_TOKENS)
        compared = []
        for i, q in enumerate(files[3]):
            image = Image.open(os.path.join(directory, q["image"])).convert("RGB") if "image" in q else None
            inputs = sm.processor(q["text"], images=image)
            steps = []
            want = small.engine.generate([inputs["input_ids"][0].tolist()], inputs.get("images"), gen,
                                         logits_callback=lambda s, lg: steps.append(lg[0].float())).token_ids[0]
            margins = [float(t[0] - t[1]) for t in (torch.topk(lg, 2).values for lg in steps)]
            upto = next((j for j, m in enumerate(margins) if m < PARITY_MARGIN), len(margins))
            got_s, got_c = two["serial"]["tokens"][i], two[f"concurrency {EVAL_CONCURRENCY}"]["tokens"][i]
            if got_s != want:
                failed.append(f"2+2 layers, sample {i}: serial answer {got_s} is not engine.generate's {want}")
            if got_c[:upto] != want[:upto]:
                failed.append(f"2+2 layers, sample {i}: concurrent answer {got_c[:upto]} != {want[:upto]} "
                              f"(compared up to step {upto})")
            compared.append(upto)
        two["tokens_compared"] = compared
        plain = omchat_model(id_tokenizer(False), OmChatEngine(small.config, small.engine.params, attn_impl="plain",
                                                               image_cache_size=0, device=DEVICE))
        with open(files[2]) as f:
            gaps = perplexity_gaps(sm, plain, f.read())
        ppl = two["perplexity"]
        ppl.update(plain_nll=gaps["plain_nll"], nll_gap=abs(ppl["nll"] - gaps["plain_nll"]), limit=PPL_TOKEN_GAP,
                   per_token=gaps)
        if not (gaps["kernels"]["token_nll_gap_max"] <= PPL_TOKEN_GAP and ppl["nll_gap"] <= PPL_TOKEN_GAP
                and math.isfinite(ppl["value"])):
            failed.append(f"2+2 layers perplexity, kernels vs plain: {ppl} (limit {PPL_TOKEN_GAP} a token)")
        if not all(gaps[fault]["token_nll_gap_max"] > PPL_TOKEN_GAP for fault in PPL_FAULTS):
            failed.append(f"2+2 layers perplexity: the limit {PPL_TOKEN_GAP} would pass a planted fault ({gaps})")
        res["2+2 layers"] = two
    except AssertionError as e:
        failed.append(str(e))
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    for label, r in res.items():
        log(f"eval entry point, {label}: " + json.dumps({"card": CARD, **{
            k: ({kk: vv for kk, vv in v.items() if kk != "tokens"} if isinstance(v, dict) else v)
            for k, v in r.items()}}))
    if failed:
        raise AssertionError("phase 30 failed: " + " | ".join(failed))
    return res


# ---------------------------------------------------------------------------
# Phases 31-33: the other towers and decoders (A11): CLIP / SigLIP /
# InternViT-300M through K2 at head widths 64 and 72, the OmChat variants
# (InternViT-300M, the v1 spatial merge, the cabstract and sparse
# projectors), the Qwen2-MoE trunk in every engine
# ---------------------------------------------------------------------------

# Phase 31: TOWER_IMAGES images a tower (tiles for InternViT-300M), S2 at
# S2_SIZES (1 + 4 + 9 crops an image).  A tower through the kernels (K2) against
# attn_impl="plain" on the same weights: max |diff| within TOWER_REL_LIMIT of
# max |out|, phase 22's limit for a ViT (bf16 rounds every activation and the
# routes round q and p at other places).  The CLIP-SMoE tower has TOWER_EXPERTS
# experts, TOWER_SELECTED picked a token; its plain run takes the kernel run's
# routing weights (``routed_pair``: an H100 run read 1.8% of the routing
# decisions broken apart by the two routes' roundings of near-ties, and the
# unpinned outputs 0.555 of max |out| apart, a token sent to another expert).
TOWER_IMAGES, S2_SIZES, TOWER_EXPERTS, TOWER_SELECTED = 5, (336, 672, 1008), 4, 2
TOWER_REL_LIMIT = VIT_REL_LIMIT
# Phase 32: the v1 variant's image (width, height); the cabstract projector's
# queries and depth; the sparse projector's experts.
V1_IMAGE, CABSTRACT_QUERIES, CABSTRACT_DEPTH = (1000, 700), 144, 3
# Phase 33: Qwen1.5-MoE-A2.7B (Qwen/Qwen1.5-MoE-A2.7B config.json: hidden 2048, 24
# layers, 16 / 16 heads of 128, 60 experts, top-4, moe_intermediate_size 1408,
# shared_expert_intermediate_size 5632, vocab 151936, norm_topk_prob false, rope
# theta 1e6, qkv bias; dev/exp_moe_gmm.py:3 names the geometry), behind the
# InternViT-6B tower and a 3200 -> 2048 mlp2x_gelu projector.  MOE_SLOT_REQUESTS
# of phase 5's requests go through the slot engine.  At 2+2 layers the expert
# routes "gmm" and "dense" compute the same function in bf16 with other
# roundings (dense rounds the routing weights to bf16 and sums the experts in
# one product, gmm scales each replica's output and adds them one by one), so
# their first-token logits are held within MOE_GMM_REL of max |logit|.
MOE_TEXT = dict(vocab_size=151936, hidden_size=2048, intermediate_size=5632, num_hidden_layers=24,
                num_attention_heads=16, num_key_value_heads=16, max_position_embeddings=8192, rms_norm_eps=1e-6,
                rope_theta=1000000.0, attention_bias=True, tie_word_embeddings=False, num_experts=60,
                num_experts_per_tok=4, moe_intermediate_size=1408, shared_expert_intermediate_size=5632,
                decoder_sparse_step=1, norm_topk_prob=False)
MOE_SLOT_REQUESTS, MOE_GMM_REL = 4, 5e-2


def hf_clip_state(gen, cfg) -> dict:
    """A HF CLIPVisionModel / SiglipVisionModel state dict of ``cfg``'s
    geometry on the card, bf16: normal(0, 0.02) matrices, unit norms, zero
    biases; with ``cfg.clip_smoe`` every layer's experts and router too."""
    import torch

    d, f, n, p = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers, cfg.patch_size

    def w(*shape, scale=0.02):
        return _randn(gen, *shape, scale=scale)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=DEVICE)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16, device=DEVICE)

    pre = "vision_model."
    s = {pre + "embeddings.patch_embedding.weight": w(d, 3, p, p),
         pre + "embeddings.position_embedding.weight": w(cfg.grid ** 2 + int(cfg.use_class_token), d)}
    if cfg.use_class_token:
        s[pre + "embeddings.class_embedding"] = w(d, scale=1.0)
        s[pre + "pre_layrnorm.weight"], s[pre + "pre_layrnorm.bias"] = ones(d), zeros(d)
    else:
        s[pre + "embeddings.patch_embedding.bias"] = zeros(d)
    if cfg.post_layernorm:
        s[pre + "post_layernorm.weight"], s[pre + "post_layernorm.bias"] = ones(d), zeros(d)
    for i in range(n):
        lay = f"{pre}encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            s[lay + ln + ".weight"], s[lay + ln + ".bias"] = ones(d), zeros(d)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[lay + f"self_attn.{proj}.weight"], s[lay + f"self_attn.{proj}.bias"] = w(d, d), zeros(d)
        mlps = [lay + "mlp."] + ([f"{lay}experts.{e}." for e in range(cfg.num_experts)] if cfg.clip_smoe else [])
        for m in mlps:
            s[m + "fc1.weight"], s[m + "fc1.bias"] = w(f, d), zeros(f)
            s[m + "fc2.weight"], s[m + "fc2.bias"] = w(d, f), zeros(d)
        if cfg.clip_smoe:
            s[lay + "router.weight"], s[lay + "router.bias"] = w(cfg.num_experts, d), zeros(cfg.num_experts)
    return s


def rel_gap(got, ref) -> float:
    """max |got - ref| over max |ref|, both finite, or raises."""
    import torch

    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite output")
    return float((got - ref).abs().max() / ref.abs().max())


def narrow_k2_plain(q, k, v, scale_width: int, read_cols: int):
    """K2's non-causal function over btnd q, k, v [B, S, H, D] with the two
    knobs of phase 31's planted faults: the softmax scale of a head
    ``scale_width`` wide, and q and k read ``read_cols`` columns from each
    head's first, the columns past D being the ones that follow in memory
    (the next head's, the next row's for the last heads), as a tensor map
    declared over the wrong width would read them.  (scale_width, read_cols)
    = (D, D) is the kernel's function."""
    import torch

    B, S, H, D = q.shape

    def widen(t):
        if read_cols == D:
            return t
        flat = t.reshape(B * S, H * D)
        ext = torch.cat([flat, flat.roll(-1, 0)], dim=1)
        return torch.stack([ext[:, h * D: h * D + read_cols] for h in range(H)], dim=1).view(B, S, H, read_cols)

    qw = widen(q)
    qs = qw * torch.full((), scale_width ** -0.5 * 1.4426950408889634, dtype=q.dtype, device=q.device)
    s = torch.einsum("bshd,bthd->bhst", qs.float(), widen(k).float())
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhst,bthd->bshd", p.to(v.dtype).float(), v.float()) / p.sum(dim=-1)[..., None].transpose(1, 2)
    return o.to(q.dtype)


def narrow_k2_row(gen, B: int, S: int, H: int, D: int, launches_from: str) -> dict:
    """K2 at a tower's shape (B images of S rows, H heads of D, non-causal,
    btnd): q carries a per-head direction u, the keys at columns 0, S // 2
    and S - 1 hold 0.8 u; held against its plain version, with the two
    planted faults (the scale of D = 128; q and k read past column D) outside
    the limit, and timed beside SDPA."""
    import torch
    import torch.nn.functional as F

    from omchat_torch.ops import flash_attention as fa

    u = _direction(gen, H, D)
    q = _randn(gen, B, S, H, D) + u
    k, v = _randn(gen, B, S, H, D), _randn(gen, B, S, H, D)
    for col in (0, S // 2, S - 1):
        k[:, col] = 0.8 * u
    out = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k.transpose(1, 2), v.transpose(1, 2), causal=False, q_offset=None, kv_len=None)
    name = f"flash_attention[D={D}, {S} rows]"
    err = check_close(f"K2 {name}", out, ref, *ATTN_TOL["K2"])
    check_close(f"K2 {name}: the fault model at (D, D) is the plain version", narrow_k2_plain(q, k, v, D, D), ref,
                *ATTN_TOL["K2"])
    faults = {"scale of D=128": check_fault_caught(f"K2 {name}", "the scale of a 128-wide head",
                                                   narrow_k2_plain(q, k, v, 128, D), ref, *ATTN_TOL["K2"]),
              "reads past column D": check_fault_caught(f"K2 {name}", "q and k read past column D",
                                                        narrow_k2_plain(q, k, v, D, 128), ref, *ATTN_TOL["K2"])}
    p_ms = time_ms(lambda: fa.flash_attention_plain(q, k.transpose(1, 2), v.transpose(1, 2), causal=False,
                                                    q_offset=None, kv_len=None), iters=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms, readings = time_in_turns({"kernel": lambda: fa.flash_attention(q, k, v, causal=False),
                                  "library": lambda: F.scaled_dot_product_attention(qt, kt, vt)})
    row = dict(name=name, source="omchat_torch/csrc/flash_attention.cu",
               replaces="omchat_tpu/ops/flash_attention.py:246", max_abs_err=err, ms=ms["kernel"], plain_ms=p_ms,
               library_ms=ms["library"], flops=4.0 * B * H * S * S * D, bytes=4 * B * S * H * D * 2,
               ref_mean_abs=float(ref.float().abs().mean()), faults=faults, readings=readings["kernel"],
               extra=f" (B={B} S={S} H={H} D={D}, launches from the {launches_from} run)")
    del q, k, v, qt, kt, vt, out, ref
    return row


def routed_pair(tower, params, cfg, pixels) -> tuple:
    """A CLIP-SMoE tower on the kernels and on ``attn_impl="plain"`` with
    the plain run taking the kernel run's routing weights layer by layer:
    the two routes round differently, so a token whose router probabilities
    nearly tie goes to another expert on each, and that is the router's
    tie, not an attention kernel's fault.  Returns (kernels out, plain out,
    the share of routing decisions the unpinned plain run makes apart and
    its gap)."""
    from omchat_torch.models import smoe

    route = smoe.smoe_route
    picks = []

    def record(router, x, k):
        got = route(router, x, k)
        picks.append(got)
        return got

    try:
        smoe.smoe_route = record
        out = tower.forward(params, cfg, pixels)
        kernel_picks, picks = picks, []
        free = tower.forward(params, cfg, pixels, attn_impl="plain")
        replay = iter(kernel_picks)
        smoe.smoe_route = lambda router, x, k: next(replay)
        ref = tower.forward(params, cfg, pixels, attn_impl="plain")
    finally:
        smoe.smoe_route = route
    apart = sum(int(((a[0] > 0) != (b[0] > 0)).any(-1).sum()) for a, b in zip(kernel_picks, picks))
    total = sum(int(a[0].shape[:-1].numel()) for a in kernel_picks)
    return out, ref, {"routing_decisions_apart_unpinned": apart / total,
                      "kernels_vs_plain_rel_unpinned": rel_gap(out, free)}


def towers_on_the_card(gen, seed: int) -> tuple:
    """Phase 31: CLIP-L/336, CLIP-L with clip_smoe, CLIP-L through S2,
    SigLIP so400m and InternViT-300M at full width and depth on seeded bf16
    weights, each through ``build_vision_tower(name).forward`` on the kernels
    against ``attn_impl="plain"``, K2 launched once a layer run; then K2 at
    the three towers' shapes (D = 64 at 577 and 1025 rows, D = 72 at 729).
    Returns (kernel rows, the rows' launches)."""
    import torch

    from omchat_torch.models.intern_vit import init_params as vit_init
    from omchat_torch.models.multiscale import multiscale_forward
    from omchat_torch.models.tower import build_vision_tower
    from omchat_torch.ops import flash_attention as fa

    bf = torch.bfloat16
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    towers = (("CLIP-L/336", "openai/clip-vit-large-patch14-336", {}),
              ("CLIP-L/336 clip_smoe", "openai/clip-vit-large-patch14-336",
               dict(clip_smoe=True, num_experts=TOWER_EXPERTS, num_selected=TOWER_SELECTED)),
              ("SigLIP so400m/384", "google/siglip-so400m-patch14-384", {}),
              ("InternViT-300M/448", "OpenGVLab/InternViT-300M-448px", {}))
    res, launches, shapes = {}, {}, {}
    for label, name, kw in towers:
        tower = build_vision_tower(name, **kw)
        cfg = tower.config
        t0 = time.perf_counter()
        params = (vit_init(cfg, g, bf) if "internvit" in name.lower()
                  else tower.convert(hf_clip_state(gen, cfg), cfg, bf))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        pixels = _randn(gen, TOWER_IMAGES, 3, cfg.image_size, cfg.image_size)
        layers = cfg.num_hidden_layers - (1 if tower.forward.__name__ == "clip_vit_forward" else 0)  # feature layer
        tower.forward(params, cfg, pixels)  # warm-up: cuBLAS plans, the kernels' first launches
        fa.flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tower.forward(params, cfg, pixels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_k2 = fa.flash_attention.launches
        extra = {}
        if getattr(cfg, "clip_smoe", False):
            out, ref, extra = routed_pair(tower, params, cfg, pixels)
        else:
            ref = tower.forward(params, cfg, pixels, attn_impl="plain")
        gap = rel_gap(out, ref)
        seq = out.shape[1]
        res[label] = {"layers_run": layers, "head_dim": cfg.head_dim, "rows": seq, "out_shape": list(out.shape),
                      "k2_launches": n_k2, "forward_ms": wall * 1e3, "images_per_s": TOWER_IMAGES / wall,
                      "kernels_vs_plain_rel": gap, "weights_built_s": build_s, **extra}
        if n_k2 != layers:
            raise AssertionError(f"towers, {label}: K2 launched {n_k2} times for {layers} layers")
        if gap > TOWER_REL_LIMIT:
            raise AssertionError(f"towers, {label}: kernels vs plain {gap:.4g} of max |out|, past {TOWER_REL_LIMIT}")
        if "clip_smoe" not in label:
            shapes.setdefault((cfg.head_dim, seq, cfg.num_attention_heads), (label, n_k2))
        if label == "CLIP-L/336":  # S2 over the same tower: 1 + 4 + 9 crops an image
            def feature(x):
                return tower.forward(params, cfg, x)[:, 1:]

            fa.flash_attention.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s2 = multiscale_forward(feature, pixels.float(), S2_SIZES, cfg.image_size)
            torch.cuda.synchronize()
            s2_wall = time.perf_counter() - t0
            n_s2 = fa.flash_attention.launches
            s2_ref = multiscale_forward(lambda x: tower.forward(params, cfg, x, attn_impl="plain")[:, 1:],
                                        pixels.float(), S2_SIZES, cfg.image_size)
            crops = sum(max(sz // cfg.image_size, 1) ** 2 for sz in S2_SIZES)
            res["CLIP-L/336 S2"] = {"scales": list(S2_SIZES), "crops_per_image": crops, "out_shape": list(s2.shape),
                                    "k2_launches": n_s2, "forward_ms": s2_wall * 1e3,
                                    "crops_per_s": TOWER_IMAGES * crops / s2_wall,
                                    "kernels_vs_plain_rel": rel_gap(s2, s2_ref)}
            if n_s2 != layers * len(S2_SIZES) or res["CLIP-L/336 S2"]["kernels_vs_plain_rel"] > TOWER_REL_LIMIT:
                raise AssertionError(f"towers, S2: {res['CLIP-L/336 S2']}")
            del s2, s2_ref
        log(f"towers, {label}: " + json.dumps({"card": CARD, **res[label]}))
        del params, out, ref, pixels
        torch.cuda.empty_cache()
    log("towers, CLIP-L/336 S2: " + json.dumps({"card": CARD, **res["CLIP-L/336 S2"]}))
    rows = []
    for (d, seq, h), (label, n) in sorted(shapes.items()):
        rows.append(narrow_k2_row(gen, TOWER_IMAGES, seq, h, d, label))
        launches[rows[-1]["name"]] = n
    report_rows(rows)
    torch.cuda.empty_cache()
    return rows, launches


def variant_params(name: str, full: tuple, small: bool, seed: int) -> tuple:
    """(cfg, params) of one of phase 32's OmChat variants over phase 3's
    config: at full depth its Qwen2-7B and InternViT-6B weights (``full``)
    with the variant's own parts; ``small``: full width, 2 ViT + 2 LLM
    layers, every part seeded anew."""
    import torch

    from omchat_torch.config import ProjectorConfig, VisionConfig
    from omchat_torch.models import intern_vit, projector, qwen2

    cfg, params = full
    if small:
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, num_hidden_layers=2),
                                  text=dataclasses.replace(cfg.text, num_hidden_layers=2))
        params = build_model(cfg, seed)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 31)
    bf = torch.bfloat16
    if name == "InternViT-300M + mlp2x_gelu":
        vision = VisionConfig.internvit_300m()
        if small:
            vision = dataclasses.replace(vision, num_hidden_layers=2)
        cfg = dataclasses.replace(cfg, vision=vision)
        params = {**params, "vision_tower": intern_vit.init_params(vision, g, bf),
                  "projector": projector.init_params(cfg.projector, vision.hidden_size, cfg.text.hidden_size, g, bf)}
    elif name == "v1 spatial_unpad":
        cfg = dataclasses.replace(cfg, mm_patch_merge_type="spatial_unpad")
        params = {**params, "image_newline": _randn(g, cfg.text.hidden_size)}
    else:
        pc = (ProjectorConfig(projector_type="cabstract", n_query=CABSTRACT_QUERIES, depth=CABSTRACT_DEPTH)
              if name == "cabstract" else ProjectorConfig.from_type("mlp2x_gelu", mlp_smoe=True,
                                                                    num_experts=TOWER_EXPERTS,
                                                                    num_selected=TOWER_SELECTED))
        cfg = dataclasses.replace(cfg, projector=pc)
        params = {**params, "projector": projector.init_params(pc, cfg.vision.hidden_size, cfg.text.hidden_size, g,
                                                               bf)}
    return cfg, params


VARIANTS = ("InternViT-300M + mlp2x_gelu", "v1 spatial_unpad", "cabstract", "mlp_smoe")


def variant_image(name: str, seed: int):
    import numpy as np

    if name == "v1 spatial_unpad":
        return seeded_image(np.random.default_rng(seed), V1_IMAGE[1], V1_IMAGE[0])
    return request_image(seed)


def variant_inputs(model, image) -> tuple:
    """What ``OmChatModel.chat`` hands the engine: (ids, tiles, extra)."""
    inputs = model.processor(REQUEST_QUESTION, images=image)
    extra = {}
    if model.config.mm_patch_merge_type.startswith("spatial"):
        extra = {"num_patches": inputs["num_patches"].tolist(), "image_sizes": inputs["image_sizes"]}
    return inputs["input_ids"][0].tolist(), inputs["images"], extra


def variants_on_the_card(full: tuple, seed: int) -> dict:
    """Phase 32: the four OmChat variants through ``OmChatModel.chat`` at
    full depth, one seeded image and NEW_TOKENS greedy tokens each (TTFT,
    decode tokens/s, the image's tokens), then at 2+2 layers each variant's
    first-token logits on the kernels within phase 4's limits of
    ``attn_impl="plain"`` and its greedy tokens by phase 7's rule."""
    import torch

    from omchat_torch.config import GenerationConfig
    from omchat_torch.ops import flash_attention as fa

    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1)
    res = {}
    for name in VARIANTS:
        cfg, params = variant_params(name, full, False, seed)
        model = surface_model(cfg, params, image_cache_size=0)
        image = variant_image(name, seed)
        model.chat(REQUEST_QUESTION, image=image, generation=gen)  # warm-up, the decode graph's capture
        fa.flash_attention.launches = 0
        reply = model.chat(REQUEST_QUESTION, image=image, generation=gen)
        n_k2 = fa.flash_attention.launches
        sp = model.engine.spans
        ids, tiles, extra = variant_inputs(model, image)
        feats = model.engine.encode_images(tiles)
        if feats.shape[0] != tiles.shape[0] * cfg.image_seq_len:
            raise AssertionError(f"variants, {name}: {feats.shape[0]} feature rows for {tiles.shape[0]} tiles of "
                                 f"{cfg.image_seq_len}")
        per_sentinel = ([cfg.image_seq_len] * int(tiles.shape[0]) if not extra else
                        model.engine.merge_spatial_features(feats, extra["num_patches"], extra["image_sizes"])[1])
        r = {"card": CARD, "tiles": int(tiles.shape[0]), "image_tokens_per_sentinel": per_sentinel,
             "tokens_per_tile": cfg.image_seq_len, "ttft_ms": sp["ttft"] * 1e3, "vit_ms": sp["encode_images"] * 1e3,
             "decode_tokens_per_s": sp["decode_steps"] / sp["decode"], "new_tokens": sp["decode_steps"] + 1,
             "k2_launches": n_k2, "reply_chars": len(reply)}
        if name.startswith("InternViT-300M"):
            want = cfg.vision.num_hidden_layers + cfg.text.num_hidden_layers  # the encode's and the prefill's
            if r["k2_launches"] != want:
                raise AssertionError(f"variants, {name}: K2 launched {r['k2_launches']} times, not {want}")
        if r["new_tokens"] != NEW_TOKENS:
            raise AssertionError(f"variants, {name}: {r['new_tokens']} tokens, not {NEW_TOKENS}")
        del model, params, feats
        torch.cuda.empty_cache()
        small = {}
        cfg_s, params_s = variant_params(name, full, True, seed)
        for impl in (None, "plain"):
            m = surface_model(cfg_s, params_s, image_cache_size=0, attn_impl=impl, decode_graphs=impl is None)
            ids, tiles, extra = variant_inputs(m, image)
            steps = []
            toks = m.engine.generate([ids], tiles, GenerationConfig(max_new_tokens=PARITY_NEW_TOKENS, eos_token_id=-1),
                                     logits_callback=lambda s, lg: steps.append(lg[0].float()), **extra).token_ids[0]
            small[impl] = (toks, steps)
        (toks, steps), (want, ref_steps) = small[None], small["plain"]
        r["small_logits_max_abs_diff"] = check_close(f"variants, {name}: 2+2 layers first-token logits", steps[0],
                                                     ref_steps[0], LOGITS_ATOL, LOGITS_RTOL)
        margins = [float(t[0] - t[1]) for t in (torch.topk(lg, 2).values for lg in ref_steps)]
        upto = next((j for j, m in enumerate(margins) if m < PARITY_MARGIN), len(margins))
        if toks[:upto] != want[:upto]:
            raise AssertionError(f"variants, {name}: 2+2 layers tokens {toks[:upto]} != {want[:upto]} (compared up "
                                 f"to step {upto}, the first top-2 margin under {PARITY_MARGIN})")
        r["small_tokens_compared"], r["small_tokens_equal_beyond"] = upto, toks == want
        res[name] = r
        log(f"variants, {name}: " + json.dumps(r))
        del params_s
        torch.cuda.empty_cache()
    return res


def moe_model(vision_tower, seed: int, layers=None) -> tuple:
    """(cfg, params): phase 3's config with the Qwen1.5-MoE-A2.7B trunk
    (``MOE_TEXT``; ``layers``: 2 ViT + 2 LLM layers, all seeded), behind
    ``vision_tower`` (the resident InternViT-6B) and a seeded 3200 -> 2048
    mlp2x_gelu projector; bf16."""
    import torch

    from omchat_torch.config import OmChatConfig, TextConfig
    from omchat_torch.models import intern_vit, projector, qwen2

    full = OmChatConfig()
    cfg = dataclasses.replace(full, text=TextConfig(**MOE_TEXT))
    g = torch.Generator(device=DEVICE).manual_seed(seed + 33)
    bf = torch.bfloat16
    if layers is not None:
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, num_hidden_layers=layers),
                                  text=dataclasses.replace(cfg.text, num_hidden_layers=layers))
        vision_tower = intern_vit.init_params(cfg.vision, g, bf)
    return cfg, {"vision_tower": vision_tower,
                 "projector": projector.init_params(cfg.projector, cfg.vision.hidden_size, cfg.text.hidden_size, g, bf),
                 "language_model": qwen2.init_params(cfg.text, g, bf)}


def moe_small_checks(seed: int) -> dict:
    """Phase 33 at full width and 2+2 layers: phase 3's request's
    first-token logits on the kernels within phase 4's limits of
    ``attn_impl="plain"``, and its first-token logits through
    ``qwen2_moe_forward`` with ``moe_impl="gmm"`` within MOE_GMM_REL of
    max |logit| of the dense route's."""
    import torch

    from omchat_torch.models.omchat import fuse_embeddings
    from omchat_torch.models.qwen2 import lm_head
    from omchat_torch.models.qwen2_moe import qwen2_moe_forward
    from omchat_torch.runtime.generate import OmChatEngine

    cfg, params = moe_model(None, seed, layers=2)
    ids, tiles = make_request(cfg, seed)
    logits, embeds = {}, None
    for impl in (None, "plain"):
        eng = OmChatEngine(cfg, params, attn_impl=impl, image_cache_size=0)
        feats = eng.encode_images(tiles)
        plan = eng.plan([ids])
        logits[impl], _ = eng.prefill(plan, feats, NEW_TOKENS)
        if impl is None:
            t = lambda a: torch.as_tensor(a, device=DEVICE)  # noqa: E731
            embeds = fuse_embeddings(params, t(plan.token_ids), t(plan.is_image), t(plan.image_index), feats)
            pos, n = t(plan.positions), int(plan.lengths[0])
    res = {"logits_max_abs_diff": check_close("moe, 2+2 layers: kernels vs plain first-token logits", logits[None],
                                              logits["plain"], LOGITS_ATOL, LOGITS_RTOL),
           "argmax_equal": bool(torch.equal(logits[None].argmax(-1), logits["plain"].argmax(-1)))}
    routes = {}
    for impl in ("dense", "gmm"):  # the prompt through the trunk, the last row's logits
        h, _ = qwen2_moe_forward(params["language_model"], cfg.text, embeds[:, :n], pos[:, :n], moe_impl=impl)
        routes[impl] = lm_head(params["language_model"], cfg.text, h[:, -1])
    res["gmm_vs_dense_rel"] = rel_gap(routes["gmm"], routes["dense"])
    res["gmm_vs_dense_rows"] = n
    log("moe, 2+2 layers: " + json.dumps({"card": CARD, **res}))
    if res["gmm_vs_dense_rel"] > MOE_GMM_REL:
        raise AssertionError(f"moe, 2+2 layers: gmm vs dense {res['gmm_vs_dense_rel']:.4g} of max |logit|, past "
                             f"{MOE_GMM_REL}")
    del params
    torch.cuda.empty_cache()
    return res


def moe_on_the_card(gen, vision_tower, seed: int, shapes: dict) -> tuple:
    """Phase 33: the Qwen1.5-MoE-A2.7B trunk at full width and depth behind
    the resident InternViT-6B: (a) phase 3's request through the
    single-request engine, every step a graph replay, beside the step's
    weight-read floor; (b) phase 5's workload through the paged engine after
    ``precompile`` (every roll a replay); (c) MOE_SLOT_REQUESTS of its
    requests through the slot engine; then K2-K4 and K12 / K14 / K15 at group
    1 (16 / 16 heads) against their plain versions, and the 2+2-layer checks.
    Returns (kernel rows, the rows' launches)."""
    import torch

    from omchat_torch.runtime import paged_engine as pe
    from omchat_torch.utils.tree import tree_items

    gc.collect()  # the earlier phases' engines, graph pools and caches
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = moe_model(vision_tower, seed)
    torch.cuda.synchronize()
    lm = params["language_model"]
    leaves = [t for _, t in tree_items(lm)]
    lm_bytes = sum(t.numel() * t.element_size() for t in leaves)
    step_bytes = lm_bytes - lm["embed_tokens"].numel() * lm["embed_tokens"].element_size()  # one row of it is read
    log("moe: built full-width full-depth weights in " + json.dumps({
        "card": CARD, "build_s": time.perf_counter() - t0, "trunk_params": sum(t.numel() for t in leaves),
        "trunk_gib": lm_bytes / 2**30, "allocated_gib": torch.cuda.memory_allocated() / 2**30}))
    e2e = end_to_end(seed, model=(cfg, params), label="moe e2e (single request, graphed steps)")
    if (e2e["tiles"], e2e["merged_len"], e2e["cache_len"]) != (shapes["tiles"], shapes["prompt_len"],
                                                                 shapes["cache_rows"]):
        raise AssertionError(f"moe e2e: the request's shapes differ from phase 2's: {shapes}")
    floor_ms = step_bytes / PEAK_BYTES * 1e3
    log("moe e2e, decode step against its weight-read floor: " + json.dumps({
        "card": CARD, "graphed_step_wall_ms": 1e3 / e2e["decode_tokens_per_s"], "weight_read_floor_ms": floor_ms,
        "weights_read_per_step_gb": step_bytes / 1e9, "floor_share": floor_ms * e2e["decode_tokens_per_s"] / 1e3}))

    work = serving_workload(cfg)
    eng = pe.PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, **SERVING)
    t0 = time.perf_counter()
    widths = eng.precompile(variants=(pe.PICK_MODES[0],))
    precompile_s = time.perf_counter() - t0
    rec, undo = record_dispatches(eng)
    try:
        serve = timed_serving(eng, work, rec, paged_counters(), "moe serving (paged engine, graphed rolls)")
    finally:
        undo()
    log("moe serving, rolls: " + json.dumps({"card": CARD, "precompile_s": precompile_s, "widths": widths,
                                             "rolls_graphed": serve["rolls_graphed"],
                                             "rolls_eager": serve["rolls_eager"]}))
    if serve["rolls_eager"] or not serve["rolls_graphed"]:
        raise AssertionError(f"moe serving: rolls graphed {serve['rolls_graphed']}, eager {serve['rolls_eager']}")
    del eng
    torch.cuda.empty_cache()
    timed = {k: [e for e in rec[k] if e["label"] == "timed"] for k in ("rolls", "chunks", "commits", "prefills")}
    slot, slot_eng, _ = slot_timed_run(cfg, params, work[:MOE_SLOT_REQUESTS], "moe slot engine")
    log(f"moe slot engine ({MOE_SLOT_REQUESTS} of phase 5's requests): " + json.dumps(
        {k: v for k, v in slot.items() if k != "tokens"}))
    del slot_eng
    torch.cuda.empty_cache()
    log("moe, peak memory: " + json.dumps({"card": CARD, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                                           "allocated_gib": torch.cuda.memory_allocated() / 2**30}))
    del params, lm, leaves
    torch.cuda.empty_cache()
    rows = kernel_phases(gen, shapes, cfg=cfg, tag="[group 1]")
    rows += paged_kernel_phases(gen, timed, tc=cfg.text, tag="[group 1]")
    la = {**serve["launches"], **e2e["launches"]}  # K2-K4 on the single request, K12 / K14 / K15 in serving
    launches = {r["name"]: la[r["name"][: -len("[group 1]")]] for r in rows}
    moe_small_checks(seed)
    return rows, launches


# ---------------------------------------------------------------------------
# Phases 34-37 (A12): K2 with segment ids and the packed forward, the HF
# export round trip, the parity runbook against the bundle's own twin
# ---------------------------------------------------------------------------

# Phases 34-35: a pack of PACKED_ROWS rows holding five documents of mixed lengths
# (SEG_DOCS, row spans) and a -1 tail; SEG_TARGET of each document's last rows
# carry labels.  Phase 34 also reads K2's segment entry at head width 64 over
# SEG_NARROW_HEADS (q, kv) heads.
SEG_DOCS = ((0, 310), (310, 1410), (1410, 1650), (1650, 3300), (3300, 3950))
SEG_TARGET, SEG_NARROW_HEADS = 128, (16, 16)
# Phase 35, the packed forward at full depth (loss_fn, attn_impl=None: K2's
# segment entry in every layer) against the plain route's packed loss and the
# documents run one at a time.  Derived as C4's limit was: an H100 run (NVIDIA H100
# 80GB HBM3, 700.00 W; chip_probes/packed_forward_gaps.py, token seeds 0-3 over
# the seed-0 weights) read the plain route's own packed-vs-one-at-a-time gaps at
# up to 0.00278 in the mean loss and 0.250 in max |logit| over the labelled rows
# (the kernels 0.00389 and 0.297, K16a's training route 0.00266 and 0.310: bf16
# rounding over 28 layers; one layer apart, each route is 2-2.5 bf16 ulps from
# the plain route's hidden states).  The kernel route is held to 1.5 x the
# plain route's largest reading on each measure.
PACKED_PLAIN_GAPS = {"loss": 0.0027801513671867895, "logit": 0.25}
PACKED_LIMITS = {k: 1.5 * v for k, v in PACKED_PLAIN_GAPS.items()}
# Phases 36-37: the full-width model at EXPORT_LAYERS (ViT, LLM) layers exported
# and loaded back; PARITY_NEW_TOKENS greedy steps of the parity runbook.  The
# kernel route's max |logit diff| against the fp32 twin is held to 1.5 x the
# plain route's in bf16 (the same report, the same prompt: bf16 rounding of the
# same products), and the plain route in fp32 to PARITY_FP32_LIMIT, the JAX
# runbook's fp32 limit (tests/test_trust_remote_code.py; an H100 run read
# 2.5e-5 at full width, NVIDIA H100 80GB HBM3, 700.00 W).
EXPORT_LAYERS, PARITY_STEPS = (2, 2), 16
PARITY_FP32_LIMIT = 1e-4


def packed_segments(docs, rows: int):
    """[1, rows] int32 segment ids on the card: document i over its span, -1
    past the last."""
    import torch

    seg = torch.full((1, rows), -1, dtype=torch.int32, device=DEVICE)
    for i, (s, e) in enumerate(docs):
        seg[:, s:e] = i
    return seg


def seg_k2_plain(q, k, v, seg, causal, fault=None):
    """K2's plain version over btnd q, k, v with segment ids; ``fault``
    plants "boundary": each document's first row counted in the document
    before it, or "padding": the -1 rows a segment of their own that attends
    (kv_len the whole pack)."""
    import torch

    from omchat_torch.ops import flash_attention as fa

    kv_len = (seg >= 0).sum(1, dtype=torch.int32)
    if fault == "boundary":
        seg = seg.clone()
        starts = (torch.nonzero(seg[0, 1:] != seg[0, :-1]).flatten() + 1).tolist()
        for e in starts:
            if seg[0, e] > 0:
                seg[0, e] = seg[0, e - 1]
    elif fault == "padding":
        seg = torch.where(seg < 0, seg.max() + 1, seg)
        kv_len = torch.full_like(kv_len, seg.shape[1])
    return fa.flash_attention_plain(q, k.transpose(1, 2), v.transpose(1, 2), causal=causal, q_offset=None,
                                    kv_len=kv_len, segment_ids=seg)


def seg_k2_row(gen, H: int, KVH: int, D: int, causal: bool, name: str) -> dict:
    """K2's segment entry over the phase-35 pack: q carries its kv head's
    direction u, the keys on both sides of every document boundary and of
    every 64-column tile edge hold 0.8 u; held against its plain version on
    every row (the -1 rows zeros in both), with the planted faults
    ("boundary", "padding") outside the limit, and timed in turns beside SDPA
    with the same boolean block-diagonal mask.  The bound counts each
    document's own causal triangle (or square)."""
    import torch
    import torch.nn.functional as F

    from omchat_torch.ops import flash_attention as fa

    S = PACKED_ROWS
    seg = packed_segments(SEG_DOCS, S)
    u = _direction(gen, KVH, D)
    q = _randn(gen, 1, S, H, D) + u.repeat_interleave(H // KVH, dim=0)
    k, v = _randn(gen, 1, S, KVH, D), _randn(gen, 1, S, KVH, D)
    edges = (torch.nonzero(seg[0, 1:] != seg[0, :-1]).flatten() + 1).tolist()
    cols = {c for e in edges for c in (e - 1, e)} | set(range(63, S - 1, 64)) | set(range(64, S, 64))
    k[:, torch.tensor(sorted(cols), device=DEVICE)] = (0.8 * u).to(k.dtype)
    out = fa.flash_attention(q, k, v, causal=causal, segment_ids=seg)
    torch.cuda.synchronize()
    ref = seg_k2_plain(q, k, v, seg, causal)
    label = f"K2 {name}"
    err = check_close(label, out, ref, *ATTN_TOL["K2"])
    if not bool((out[seg < 0] == 0).all()):
        raise AssertionError(f"{label}: a -1 row is not zero")
    faults = {f: check_fault_caught(label, what, seg_k2_plain(q, k, v, seg, causal, fault=f), ref, *ATTN_TOL["K2"])
              for f, what in (("boundary", "a document boundary off by one"),
                              ("padding", "padding allowed to attend"))}
    mask = (seg[:, :, None] == seg[:, None, :]) & (seg >= 0)[:, None, :]
    if causal:
        mask = mask & torch.ones((S, S), dtype=torch.bool, device=DEVICE).tril()
    qt, kt, vt, mt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask[:, None]
    p_ms = time_ms(lambda: seg_k2_plain(q, k, v, seg, causal), iters=3, warmup=1)
    ms, readings = time_in_turns({
        "kernel": lambda: fa.flash_attention(q, k, v, causal=causal, segment_ids=seg),
        "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mt, enable_gqa=True)})
    pairs = sum((e - s) * (e - s + 1) // 2 if causal else (e - s) ** 2 for s, e in SEG_DOCS)
    row = dict(name=name, source="omchat_torch/csrc/flash_attention.cu",
               replaces="omchat_tpu/ops/flash_attention.py:208", max_abs_err=err, ms=ms["kernel"], plain_ms=p_ms,
               library_ms=ms["library"], flops=4.0 * H * D * pairs, bytes=2 * S * (2 * H + 2 * KVH) * D + 4 * S,
               ref_mean_abs=float(ref.float().abs().mean()), faults=faults, readings=readings["kernel"],
               extra=f" (S={S}, {len(SEG_DOCS)} documents + a {S - SEG_DOCS[-1][1]}-row -1 tail, H={H} KVH={KVH} "
                     f"D={D}, {'causal' if causal else 'non-causal'}; {pairs} (q, k) pairs)")
    del q, k, v, qt, kt, vt, mt, mask, out, ref
    torch.cuda.empty_cache()
    return row


def segment_kernel_rows(gen) -> list:
    """Phase 34: K2's segment entry at the packed forward's shape, causal
    (the row of the kernels line) and non-causal, and at D = 64."""
    H, KVH = 28, 4
    rows = [seg_k2_row(gen, H, KVH, 128, True, "flash_attention[segments]"),
            seg_k2_row(gen, H, KVH, 128, False, "flash_attention[segments, non-causal]"),
            seg_k2_row(gen, *SEG_NARROW_HEADS, 64, True, "flash_attention[segments, D=64]")]
    report_rows(rows)
    return rows[:1]


def packed_batch(cfg, seed: int) -> dict:
    """``pack_rows`` of seeded documents at SEG_DOCS' lengths (labels on
    their last SEG_TARGET tokens) into one row of PACKED_ROWS."""
    import numpy as np

    from omchat_torch.cli.train import pack_rows

    rng = np.random.default_rng(seed)
    row = [(rng.integers(10, cfg.text.vocab_size, e - s).tolist(), SEG_TARGET) for s, e in SEG_DOCS]
    return {k: v.to(DEVICE) for k, v in pack_rows([row], PACKED_ROWS).items()}


def packed_forward(seed: int) -> dict:
    """Phase 35: ``loss_fn(attn_impl=None)`` over the full-depth Qwen2-7B trunk
    (random bf16 weights) on one packed 4096-row text batch, against the plain
    route's packed loss and each route's documents run one at a time (the
    label-weighted mean of their losses; the max |logit| gap over the
    labelled rows), within ``PACKED_LIMITS``; the planted fault (the pack
    without its segment ids: every document attends to the ones before it)
    must read past them."""
    import torch

    from omchat_torch.config import OmChatConfig
    from omchat_torch.models import qwen2
    from omchat_torch.models.omchat import fuse_embeddings
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.training.train_step import loss_fn, shift_labels

    cfg = OmChatConfig()
    params = {"language_model": qwen2.init_params(cfg.text, torch.Generator(device=DEVICE).manual_seed(seed),
                                                  torch.bfloat16)}
    batch = packed_batch(cfg, seed)
    labelled = shift_labels(batch["labels"])[0] >= 0

    def logits(b, impl):
        embeds = fuse_embeddings(params, b["token_ids"], b["is_image"], b["image_index"], None)
        hidden, _ = qwen2.qwen2_forward(params["language_model"], cfg.text, embeds, b["positions"], attn_impl=impl,
                                        segment_ids=b.get("segment_ids"))
        return qwen2.lm_head(params["language_model"], cfg.text, hidden)[0]

    def one_at_a_time(impl, packed_logits):
        """Each document alone, without segment ids: (label-weighted mean
        loss, labels, max |logit| gap from ``packed_logits`` on its labelled
        rows)."""
        total, count, gap = 0.0, 0, 0.0
        for s, e in SEG_DOCS:
            single = {k: v[:, s:e] for k, v in batch.items() if k != "segment_ids"}
            one, m = loss_fn(params, cfg, single, attn_impl=impl, remat=False)
            total += float(one) * int(m)
            count += int(m)
            rows = labelled[s:e]
            gap = max(gap, float((logits(single, impl)[rows] - packed_logits[s:e][rows]).abs().max()))
        return total / count, count, gap

    res, ms = {}, {}
    with torch.no_grad():
        for route, impl in (("kernels", None), ("plain", "plain")):
            loss_fn(params, cfg, batch, attn_impl=impl, remat=False)  # warm-up
            fa.flash_attention.seg_launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, n = loss_fn(params, cfg, batch, attn_impl=impl, remat=False)
            torch.cuda.synchronize()
            ms[route] = (time.perf_counter() - t0) * 1e3
            if route == "kernels":
                seg_launches = fa.flash_attention.seg_launches
            packed_logits = logits(batch, impl)
            mean, count, gap = one_at_a_time(impl, packed_logits)
            if count != int(n) or not math.isfinite(float(loss)):
                raise AssertionError(f"packed forward ({route}): {count} labels one at a time vs {int(n)} packed, "
                                     f"loss {float(loss)}")
            res[route] = {"packed": float(loss), "one_at_a_time": mean, "max_logit_gap": gap}
            del packed_logits
        unsegmented = {k: v for k, v in batch.items() if k != "segment_ids"}
        fault_loss, _ = loss_fn(params, cfg, unsegmented, attn_impl=None, remat=False)
        fault_logits = logits(unsegmented, None)
        _, _, fault_gap = one_at_a_time(None, fault_logits)
    k, p = res["kernels"], res["plain"]
    gaps = {"plain: packed vs one at a time": {"loss": abs(p["packed"] - p["one_at_a_time"]),
                                               "logit": p["max_logit_gap"]},
            "kernels: packed vs one at a time": {"loss": abs(k["packed"] - k["one_at_a_time"]),
                                                 "logit": k["max_logit_gap"]},
            "kernels packed vs plain packed": {"loss": abs(k["packed"] - p["packed"])},
            "fault, segment ids dropped: vs one at a time": {"loss": abs(float(fault_loss) - k["one_at_a_time"]),
                                                             "logit": fault_gap}}
    out = {"card": CARD, "losses": res, "gaps": gaps, "limits": PACKED_LIMITS, "k2_segment_launches": seg_launches,
           "loss_fn_ms": ms, "rows": PACKED_ROWS, "documents": [e - s for s, e in SEG_DOCS],
           "labels": int(n), "layers": cfg.text.num_hidden_layers}
    log("packed forward (full depth, loss_fn attn_impl=None vs plain): " + json.dumps(out))
    del params, batch, fault_logits
    torch.cuda.empty_cache()
    if seg_launches != cfg.text.num_hidden_layers:
        raise AssertionError(f"packed forward: K2's segment entry launched {seg_launches} times, not once a layer")
    for what in ("kernels: packed vs one at a time", "kernels packed vs plain packed"):
        for metric, gap in gaps[what].items():
            if gap > PACKED_LIMITS[metric]:
                raise AssertionError(f"packed forward: {what}, {metric} gap {gap:.4g} past {PACKED_LIMITS[metric]:.4g}")
    fault = gaps["fault, segment ids dropped: vs one at a time"]
    if all(fault[m] <= PACKED_LIMITS[m] for m in fault):
        raise AssertionError(f"packed forward: the planted fault (segment ids dropped) reads {fault}, within "
                             f"{PACKED_LIMITS}")
    return out


def write_byte_tokenizer(directory: str) -> None:
    """A byte-level BPE tokenizer in HF format (256 byte tokens, the ChatML
    markers after them), built locally: what ``load_pretrained_model`` reads
    beside the weights.  Its ids stay below every vocab of the repo."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {ch: i for i, ch in enumerate(sorted(pre_tokenizers.ByteLevel.alphabet()))}
    vocab["<|im_start|>"], vocab["<|im_end|>"] = len(vocab), len(vocab) + 1
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[]))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="<|im_end|>").save_pretrained(directory)


def export_round_trip(seed: int, directory: str) -> dict:
    """Phase 36: the full-width model at EXPORT_LAYERS layers (random bf16
    weights) through ``export_hf_bundle`` into ``directory`` and back through
    ``load_pretrained_model`` on the card: every tensor bitwise, the config
    equal, and phase 3's request giving the in-memory engine's greedy tokens
    through the kernels (K1-K4 launched)."""
    import torch

    from omchat_torch.api import load_pretrained_model
    from omchat_torch.checkpoint.save import export_hf_bundle
    from omchat_torch.config import GenerationConfig, OmChatConfig
    from omchat_torch.runtime.generate import OmChatEngine
    from omchat_torch.utils.tree import tree_items

    full = OmChatConfig()
    cfg = dataclasses.replace(full, vision=dataclasses.replace(full.vision, num_hidden_layers=EXPORT_LAYERS[0]),
                              text=dataclasses.replace(full.text, num_hidden_layers=EXPORT_LAYERS[1]))
    params = build_model(cfg, seed)
    src, bundle = os.path.join(directory, "tokenizer"), os.path.join(directory, "bundle")
    write_byte_tokenizer(src)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export_hf_bundle(cfg, params, bundle, source_dir=src)
    write_s = time.perf_counter() - t0
    gib = sum(os.path.getsize(os.path.join(bundle, f)) for f in os.listdir(bundle)) / 2**30
    t0 = time.perf_counter()
    model = load_pretrained_model(bundle, dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if model.config != cfg:
        raise AssertionError(f"export: the bundle's config differs: {model.config} vs {cfg}")
    got = dict(tree_items(model.engine.params))
    want = dict(tree_items(params))
    if got.keys() != want.keys():
        raise AssertionError(f"export: the loaded tree's leaves differ: {sorted(set(got) ^ set(want))}")
    differ = [".".join(p) for p, t in want.items() if not torch.equal(got[p], t)]
    if differ:
        raise AssertionError(f"export: {len(differ)} tensors not bitwise after the round trip: {differ[:5]}")
    ids, tiles = make_request(cfg, seed)
    gen = GenerationConfig(max_new_tokens=PARITY_STEPS, eos_token_id=-1)
    want_tokens = OmChatEngine(cfg, params, image_cache_size=0, device=DEVICE).generate([ids], tiles, gen).token_ids
    counted = counters()
    for c in counted.values():
        c.launches = 0
    got_tokens = model.engine.generate([ids], tiles, gen).token_ids
    launches = {name: c.launches for name, c in counted.items()}
    res = {"card": CARD, "layers": EXPORT_LAYERS, "bundle_gib": gib, "files": sorted(os.listdir(bundle)),
           "write_s": write_s, "load_s": load_s, "tensors_bitwise": len(want), "tokens": got_tokens[0],
           "launches": launches}
    log("export round trip (export_hf_bundle -> load_pretrained_model): " + json.dumps(res))
    if got_tokens != want_tokens:
        raise AssertionError(f"export: the loaded engine's tokens {got_tokens} differ from the in-memory "
                             f"engine's {want_tokens}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"export: kernels never launched on the loaded model's request: {missing}")
    del model, params
    torch.cuda.empty_cache()
    return {"bundle": bundle, "cfg": cfg, "ids": ids, "tiles": tiles}


def parity_on_the_card(exported: dict) -> dict:
    """Phase 37: ``run_parity`` on phase 36's bundle: the bundle's own
    remote-code twin in fp32 on the card against the port's engine on the
    kernels in bf16, on the plain route in bf16 and on the plain route in
    fp32; then layer 0's q_proj transposed in the twin, which must fail the
    kernels' limit."""
    import torch

    from omchat_torch.api import load_pretrained_model
    from omchat_torch.eval.parity import load_torch_twin, run_parity

    bundle, ids, tiles = exported["bundle"], exported["ids"], exported["tiles"]
    t0 = time.perf_counter()
    twin, source = load_torch_twin(bundle, device=DEVICE)
    twin_s = time.perf_counter() - t0
    if source != "remote_code":
        raise AssertionError(f"parity: the bundle's twin came from {source}, not its own code")
    reports = {}
    for route, impl, dtype in (("kernels bf16", None, torch.bfloat16), ("plain bf16", "plain", torch.bfloat16),
                               ("plain fp32", "plain", torch.float32)):
        model = load_pretrained_model(bundle, dtype=dtype, attn_impl=impl, device=DEVICE)
        t0 = time.perf_counter()
        reports[route] = run_parity(model, twin, ids, tiles, max_new_tokens=PARITY_STEPS, per_module=True)
        reports[route]["s"] = time.perf_counter() - t0
        if route == "kernels bf16":
            kernels_model = model
        else:
            del model
    q_proj = twin.get_submodule("language_model.model.layers.0.self_attn.q_proj")
    w = q_proj.weight.data.clone()
    q_proj.weight.data = w.t().contiguous()
    fault = run_parity(kernels_model, twin, ids, tiles, max_new_tokens=PARITY_STEPS)
    q_proj.weight.data = w
    limit = 1.5 * reports["plain bf16"]["max_logit_diff"]
    keys = ("argmax_match_rate", "first_divergence_step", "max_logit_diff", "mean_logit_diff",
            "engine_matches_torch", "s")
    res = {"card": CARD, "twin": source, "twin_load_s": twin_s, "steps": PARITY_STEPS,
           **{route: {k: r[k] for k in keys} | {"per_module": r["per_module"]} for route, r in reports.items()},
           "kernels_limit": limit, "fp32_limit": PARITY_FP32_LIMIT,
           "fault q_proj transposed": {k: fault[k] for k in keys if k != "s"}}
    log("parity (run_parity on the bundle, remote-code twin fp32 on the card): " + json.dumps(res))
    del kernels_model, twin
    torch.cuda.empty_cache()
    if reports["kernels bf16"]["max_logit_diff"] > limit:
        raise AssertionError(f"parity: the kernels' max |logit diff| {reports['kernels bf16']['max_logit_diff']:.4g}"
                             f" past 1.5 x the plain route's {limit:.4g}")
    if reports["plain fp32"]["max_logit_diff"] > PARITY_FP32_LIMIT:
        raise AssertionError(f"parity: the fp32 plain engine's max |logit diff| "
                             f"{reports['plain fp32']['max_logit_diff']:.4g} past {PARITY_FP32_LIMIT:.4g}")
    if fault["max_logit_diff"] <= limit:
        raise AssertionError(f"parity: the planted fault (q_proj transposed) reads {fault['max_logit_diff']:.4g}, "
                             f"within the limit {limit:.4g}")
    return res


def a12_on_the_card(gen, seed: int) -> tuple:
    """Phases 34-37; returns (kernel rows, {row name: launches on the packed
    forward})."""
    import tempfile

    rows = segment_kernel_rows(gen)
    packed = packed_forward(seed)
    with tempfile.TemporaryDirectory(prefix="omchat_export_") as d:
        parity_on_the_card(export_round_trip(seed, d))
    return rows, {rows[0]["name"]: packed["k2_segment_launches"]}


# ---------------------------------------------------------------------------
# Phase 38 (A13a): the sharded train step on two ranks sharing the card
# ---------------------------------------------------------------------------

# Full width (InternViT-6B 3200 / 25 heads, Qwen2-7B 3584 / 28 / 4, vocab 152064),
# PARALLEL_LAYERS (ViT, trunk) layers (1 + 1, which keeps the whole run with phase 43
# inside its time limit): a data-parallel rank holds the whole train state (1.47 B
# parameters: 2.9 GB bf16, 11.8 GB of fp32 moments, 2.9 GB of gradients), two of them
# share the card, and gloo carries every collective through host memory (~0.8 GB/s for
# a 59 MB all-reduce on the card, chip_probes/gloo_cuda_collectives.py), so each
# data-parallel step all-reduces 2.9 GB of gradients in seconds.  The two samples' answers differ in length
# (PARALLEL_ANSWERS), so the data ranks' label counts differ and the ranks' mean
# loss is not the global one.  PARALLEL_STEPS full fine-tune steps a run (lr
# PARALLEL_LR, the trainer's default and phase 16's stage-2 rate, clip 1.0: at
# 1e-3 the loss falls 12.7 -> 5.3 in three steps and a bf16 difference at step 1
# grows 4x by step 2), PARALLEL_FAULT_STEPS a planted fault's.
#
# Two distances to world 1, each an average over many elements, so that one run
# reads them steadily (a max over bf16 values reads a count of ulps, and one loss
# a single draw of rounding noise):
# - the token losses: the RMS gap of the per-token losses that the step's params
#   give after the last step (the step's own loss, one token at a time);
# - the update: over the trainable leaves, the largest relative L2 gap
#   ||mu - mu_ref|| / ||mu_ref|| of AdamW's fp32 first moments after the last step
#   (the clipped gradients' running mean: the update before its normalisation,
#   where the bf16 params themselves move by less than an ulp at this lr).  The
#   reference's moments are kept in bf16, so a gap under 2^-9 (PARALLEL_MU_FLOOR)
#   is the reference's own rounding.
# The kernel route ("vjp": K16 on each rank's heads) is held, mode by mode, to
# PARALLEL_BAR x what the plain route (attn_impl="plain") reads in the same mode
# and run (a token gap under PARALLEL_TOKEN_FLOOR, a world that adds in world 1's
# order, counts as that floor).  Each planted fault, and a step whose update is
# skipped (the control: the params and moments left as they were), must read a
# distance past its mode's bar.  (The qk-norm without its cross-rank sum is
# caught in the CPU tests, on 5 heads split 3 + 2: on random weights at full
# width each rank's mean square over its 12-13 heads is close to the whole
# width's, so the loss barely moves.)
PARALLEL_LAYERS, PARALLEL_ANSWERS = (1, 1), (64, 32)
PARALLEL_STEPS, PARALLEL_FAULT_STEPS, PARALLEL_BAR, PARALLEL_LR = 3, 1, 1.5, 1e-5
PARALLEL_TOKEN_FLOOR, PARALLEL_MU_FLOOR = 1e-5, 2.0 ** -9
PARALLEL_MODES = {"tp2": (2, False), "dp2": (1, False), "fsdp": (1, True)}  # (tp, fsdp) on a world of 2
PARALLEL_FAULTS = (("tp2", "down_proj's row-parallel reduce dropped"), ("dp2", "the ranks' mean loss for the global one"),
                   ("fsdp", "the FSDP gradient left unscattered"), ("tp2", "the optimizer update skipped"))


def parallel_cfg():
    from omchat_torch.config import OmChatConfig

    full = OmChatConfig()
    v, t = PARALLEL_LAYERS
    return dataclasses.replace(full, vision=dataclasses.replace(full.vision, num_hidden_layers=v),
                               text=dataclasses.replace(full.text, num_hidden_layers=t))


def parallel_batch(cfg, seed: int) -> dict:
    """Phase 14's samples (one seeded 448x448 image, 3 tiles, each), with
    answers of PARALLEL_ANSWERS tokens: a global batch of 2 rows on the CPU."""
    import numpy as np

    from omchat_torch.cli.train import pack_batch

    ids_all, spans, tiles_all = [], [], []
    for i, n in enumerate(PARALLEL_ANSWERS):
        ids, tiles = make_request(cfg, seed + i)
        ids = ids + np.random.default_rng(seed + 100 + i).integers(10, cfg.text.vocab_size, n).tolist()
        merged = len(ids) + sum(t == -200 for t in ids) * (cfg.image_seq_len - 1)
        ids_all.append(ids)
        spans.append((merged - n, merged))
        tiles_all.append(tiles)
    return pack_batch(cfg, ids_all, spans, np.concatenate(tiles_all))


def _on_card(batch: dict) -> dict:
    import torch

    return {k: v.to(DEVICE, dtype=torch.bfloat16 if k == "pixel_values" else v.dtype) for k, v in batch.items()}


@contextlib.contextmanager
def parallel_fault(fault):
    """Swap a planted fault into the modules the sharded step reaches."""
    import torch

    from omchat_torch.models import intern_vit, qwen2
    from omchat_torch.parallel import comm
    from omchat_torch.training import train_step as ts

    saved = []

    def swap(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    if fault == "down_proj's row-parallel reduce dropped":
        mlp = qwen2._mlp
        swap(qwen2, "_mlp", lambda y, p, *args, mesh=None: mlp(comm.copy_to_axis(y, mesh), p))
    elif fault == "the qk-norm without its cross-rank sum":
        swap(intern_vit, "_qk_norm", lambda x, scale, eps, width, mesh: intern_vit.rms_norm(x, scale, eps))
    elif fault == "the ranks' mean loss for the global one":
        swap(ts, "_data_loss", lambda s, n, mesh: s / n.clamp(min=1) / mesh.axis_size("data"))
    elif fault == "the FSDP gradient left unscattered":
        class Unscattered(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, mesh, dim):
                ctx.n, ctx.i, ctx.dim = mesh.axis_size("data"), mesh.axis_index("data"), dim
                return comm._gather(x, mesh.group("data"), dim)

            @staticmethod
            def backward(ctx, g):  # the rank's own gradient, not the sum over the data ranks
                return g.chunk(ctx.n, ctx.dim)[ctx.i].contiguous(), None, None

        swap(comm, "_fsdp_gather", lambda x, mesh, dim: Unscattered.apply(x, mesh, dim))
    elif fault == "the optimizer update skipped":
        swap(ts.AdamW, "update", lambda self, *args, **kw: False)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def _timed_steps(step, n_steps: int, after=None) -> tuple:
    """(losses, host wall ms of each step): every step ends in the loss's
    ``float``, which waits for the card.  ``after(i)`` runs untimed after
    step i (counted from 1)."""
    import torch

    losses, ms = [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if after is not None:
            after(i + 1)
    return losses, ms


def _trainable_paths(params) -> list:
    """The trainable leaves' paths, in the order of AdamW's moments."""
    import torch

    from omchat_torch.utils.tree import tree_items

    return [p for p, t in tree_items(params) if isinstance(t, torch.Tensor) and t.requires_grad]


def _token_losses(params, cfg, batch: dict, mesh, route: str, fsdp_dims=None):
    """(per-token losses, valid mask) of ``params`` on ``batch``: the
    sharded step's own loss, one token at a time (no gradient)."""
    import torch

    from omchat_torch.training import train_step as ts

    with torch.no_grad():
        return ts.sharded_token_losses(params, cfg, batch, mesh, attn_impl=route, remat=False, fsdp_dims=fsdp_dims)


def parallel_reference(cfg, batch: dict, seed: int, directory: str) -> dict:
    """World 1: PARALLEL_STEPS ``train_step``s on each route from the seeded
    weights.  After the last step (and after PARALLEL_FAULT_STEPS on the
    kernel route, for the planted faults) AdamW's first moments are saved in
    bf16 to ``directory/<route>.mu<step>.pt`` and the per-token losses
    kept.  Returns {route: {"losses", "step_ms", "peak_gib", "token_losses":
    {step: [B, M] on the CPU}}}."""
    import torch

    from omchat_torch.parallel.mesh import create_mesh
    from omchat_torch.training import train_step as ts

    out = {}
    for route in ("plain", "vjp"):
        params = build_model(cfg, seed)
        opt = ts.AdamW(PARALLEL_LR, grad_clip=1.0)
        state = ts.init_train_state(params, opt)
        paths = _trainable_paths(state.params)
        keep = {PARALLEL_STEPS} | ({PARALLEL_FAULT_STEPS} if route == "vjp" else set())
        tokens = {}

        def snapshot(i):
            if i in keep:
                torch.save({".".join(p): m.to(torch.bfloat16).cpu() for p, m in zip(paths, state.opt_state["mu"])},
                           os.path.join(directory, f"{route}.mu{i}.pt"))
                tokens[i] = _token_losses(state.params, cfg, batch, create_mesh(), route)[0].cpu()

        torch.cuda.reset_peak_memory_stats()
        losses, ms = _timed_steps(lambda: ts.train_step(state, cfg, batch, opt, attn_impl=route)[1], PARALLEL_STEPS,
                                  snapshot)
        out[route] = {"losses": losses, "step_ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "token_losses": tokens}
        del state, opt, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _moment_gap(state, specs: dict, mesh, path: str) -> float:
    """The largest relative L2 gap, over the trainable leaves that moved,
    between this world's fp32 first moments and the reference's (bf16, read
    from ``path`` memory-mapped): each rank adds the squares over its shard
    of a leaf (a leaf that ranks replicate counts once), summed over the
    world, a chunk on the card at a time."""
    import torch
    import torch.distributed as dist

    from omchat_torch.parallel.sharding import leaf_specs, shard_leaf

    ref = torch.load(path, mmap=True, weights_only=True)
    by_path = leaf_specs(state.params, specs)
    coords = mesh.coords()
    paths = _trainable_paths(state.params)
    sums = torch.zeros((len(paths), 2), dtype=torch.float64, device=DEVICE)
    chunk = 1 << 26
    for i, (p, mu) in enumerate(zip(paths, state.opt_state["mu"])):
        spec = by_path[p]
        want = shard_leaf(ref[".".join(p)], spec, coords, mesh.shape).reshape(-1)
        have = mu.reshape(-1)
        for lo in range(0, have.numel(), chunk):
            w = want[lo:lo + chunk].to(DEVICE).float()
            sums[i, 0] += (have[lo:lo + chunk] - w).double().square().sum()
            sums[i, 1] += w.double().square().sum()
        sums[i] /= (1 if "model" in spec else mesh.axis_size("model")) * (1 if "data" in spec else
                                                                          mesh.axis_size("data"))
    sums = sums.cpu()
    dist.all_reduce(sums)
    moved = sums[:, 1] > 0
    return float(torch.sqrt(sums[moved, 0] / sums[moved, 1]).max())


def _token_gap(tok, valid, ref_tok, mesh) -> float:
    """RMS over the global batch's valid labels of this world's per-token
    losses less the reference's (this rank's rows of them)."""
    import torch

    from omchat_torch.parallel import comm

    rows = ref_tok.chunk(mesh.axis_size("data"))[mesh.axis_index("data")].to(tok.device)
    sq = comm.sum_value(torch.where(valid, tok - rows, 0.0).double().square().sum().cpu(), mesh, "data")
    n = comm.sum_value(valid.sum().double().cpu(), mesh, "data")
    return float(torch.sqrt(sq / n))


def parallel_rank(seed: int, directory: str, ref: dict, jobs: list) -> dict:
    """Phase 38 in one rank of the world: each job (mode, route, fault) from
    the seeded weights, placed by ``make_sharded_train_step``; per job the
    losses, step wall ms, the collectives' share of it, peak GiB, the rank's
    local head counts and its K16 launches, then the distances to world 1
    (``ref``: {route: {"losses", "token_losses"}}): the per-step loss gaps,
    the token-loss RMS gap and the first moments' gap."""
    import torch
    import torch.distributed as dist

    from omchat_torch.parallel import comm
    from omchat_torch.parallel.mesh import create_mesh
    from omchat_torch.parallel.sharding import omchat_param_specs
    from omchat_torch.training import train_step as ts

    # two ranks share the card: segments that grow in place leave less of it reserved and unused
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = parallel_cfg()
    meshes = {tp: create_mesh(tp=tp) for tp in (1, 2)}
    batch = parallel_batch(cfg, seed)
    out = {}
    for mode, route, fault in jobs:
        tp, fsdp = PARALLEL_MODES[mode]
        mesh = meshes[tp]
        params = build_model(cfg, seed)
        specs = omchat_param_specs(cfg, params, fsdp=fsdp)
        opt = ts.AdamW(PARALLEL_LR, grad_clip=1.0)
        step, shard_batch, place = ts.make_sharded_train_step(cfg, mesh, specs, opt, attn_impl=route)
        state = ts.init_train_state(place(params), opt)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        local = _on_card(shard_batch(batch))
        layers = state.params["language_model"]["layers"]["self_attn"]
        heads = {"trunk_q": layers["q_proj"]["kernel"].shape[-1] // 128,
                 "trunk_kv": layers["k_proj"]["kernel"].shape[-1] // 128,
                 "vit": state.params["vision_tower"]["layers"]["attn"]["qkv"]["kernel"].shape[-1] // 3 // 128}
        n_steps = PARALLEL_FAULT_STEPS if fault else PARALLEL_STEPS
        counts = train_counters()
        for c in counts.values():
            c.launches = 0
        comm.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with parallel_fault(fault):
            with comm.timing():
                losses, ms = _timed_steps(lambda: step(state, cfg, local)[1], n_steps)
            res = {"losses": losses, "step_ms": ms, "collective_s": dict(comm.SECONDS),
                   "collectives": dict(comm.CALLS), "collective_share": sum(comm.SECONDS.values()) / (sum(ms) / 1e3),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "heads": heads,
                   "launches": {n: c.launches for n, c in counts.items()},
                   "loss_gaps": [abs(a - b) for a, b in zip(losses, ref[route]["losses"])]}
            tok, valid = _token_losses(state.params, cfg, local, mesh, route, ts.layer_gather_dims(specs))
        res["token_gap"] = _token_gap(tok, valid, ref[route]["token_losses"][n_steps], mesh)
        res["moment_gap"] = _moment_gap(state, specs, mesh, os.path.join(directory, f"{route}.mu{n_steps}.pt"))
        out[f"{mode}/{route}" + (f"/{fault}" if fault else "")] = res
        log(f"parallel training rank {dist.get_rank()} [{mode} {route}{' + ' + fault if fault else ''}]: "
            + json.dumps({k: res[k] for k in ("heads", "launches", "losses", "step_ms", "collective_share",
                                              "peak_gib", "token_gap", "moment_gap")}))
        del state, opt, step, local, tok, valid
        gc.collect()
        torch.cuda.empty_cache()
    return out


def parallel_training(seed: int) -> dict:
    """Phase 38: the sharded train step at full width on two ranks sharing
    the card (gloo), in three modes (tp 2; dp 2; dp 2 with FSDP), against
    the single-device ``train_step`` on the same weights and batch."""
    import tempfile

    import torch

    from omchat_torch.parallel.launch import run_ranks

    cfg = parallel_cfg()
    gc.collect()
    torch.cuda.empty_cache()
    batch = parallel_batch(cfg, seed)
    n_t, n_v = cfg.text.num_hidden_layers, cfg.vision.num_hidden_layers
    log(f"parallel training: full width, {n_v} ViT + {n_t} trunk layers (cut from 45 + 28), B=2 rows of "
        f"{batch['token_ids'].shape[1]}, {batch['pixel_values'].shape[0]} tiles, label tokens "
        f"{[int((r != -100).sum()) for r in batch['labels']]}; two ranks share one card over gloo, so the "
        "times show the collectives' overhead, not scaling")
    jobs = [(mode, route, None) for mode in PARALLEL_MODES for route in ("plain", "vjp")]
    jobs += [(mode, "vjp", fault) for mode, fault in PARALLEL_FAULTS]
    with tempfile.TemporaryDirectory(prefix="omchat_phase38_") as d:
        ref = parallel_reference(cfg, _on_card(batch), seed, d)
        log("parallel training, world 1 (train_step): "
            + json.dumps({r: {k: v[k] for k in ("losses", "step_ms", "peak_gib")} for r, v in ref.items()}))
        gc.collect()
        torch.cuda.empty_cache()
        ref_args = {r: {"losses": v["losses"], "token_losses": v["token_losses"]} for r, v in ref.items()}
        t0 = time.perf_counter()
        ranks = run_ranks(parallel_rank, 2, seed, d, ref_args, jobs, timeout=900)
        log(f"parallel training: the world of 2 ran {len(jobs)} jobs in {time.perf_counter() - t0:.1f} s")
    failed = []
    want = {"flash_attention_fwd": 2 * (n_t + n_v), "flash_attention_bwd_dq": n_t + n_v,
            "flash_attention_bwd_dkv": n_t + n_v}  # a step: forward, remat recompute; backward once a layer
    keys = ("token_gap", "moment_gap")
    summary = {"card": CARD, "world1_step_ms": ref["vjp"]["step_ms"], "world1_peak_gib": ref["vjp"]["peak_gib"]}
    for mode in PARALLEL_MODES:
        plain, kern = ranks[0][f"{mode}/plain"], ranks[0][f"{mode}/vjp"]
        bar = {"token_gap": PARALLEL_BAR * max(plain["token_gap"], PARALLEL_TOKEN_FLOOR),
               "moment_gap": PARALLEL_BAR * max(plain["moment_gap"], PARALLEL_MU_FLOOR)}
        row = {"bar": bar, "plain": {k: plain[k] for k in keys}, "kernel": {k: kern[k] for k in keys},
               "loss_gaps": {"plain": plain["loss_gaps"], "kernel": kern["loss_gaps"]},
               "world2_step_ms": [r[f"{mode}/vjp"]["step_ms"] for r in ranks],
               "collective_share": [r[f"{mode}/vjp"]["collective_share"] for r in ranks],
               "collective_s": [r[f"{mode}/vjp"]["collective_s"] for r in ranks],
               "peak_gib": [r[f"{mode}/vjp"]["peak_gib"] for r in ranks],
               "heads": [r[f"{mode}/vjp"]["heads"] for r in ranks], "faults": {}}
        if any(kern[k] > bar[k] for k in keys):
            failed.append(f"{mode}: the kernel route's gaps {row['kernel']} past the bar {bar}")
        for r, res in enumerate(ranks):
            for key, job in res.items():
                if not key.startswith(f"{mode}/"):
                    continue
                steps = len(job["losses"])
                expect = {n: k * steps for n, k in want.items()} if "/vjp" in key else {n: 0 for n in want}
                if job["launches"] != expect:
                    failed.append(f"{key} rank {r}: K16 launches {job['launches']}, expected {expect}")
        for fmode, fault in PARALLEL_FAULTS:
            if fmode != mode:
                continue
            job = ranks[0][f"{mode}/vjp/{fault}"]
            row["faults"][fault] = {k: job[k] for k in (*keys, "loss_gaps")}
            if not any(job[k] > bar[k] for k in keys):
                failed.append(f"{mode}: the bar would pass a step with {fault} ({row['faults'][fault]})")
        summary[mode] = row
    heads = summary["tp2"]["heads"]
    if [h["trunk_q"] for h in heads] != [14, 14] or [h["trunk_kv"] for h in heads] != [2, 2] or \
            sorted(h["vit"] for h in heads) != [12, 13]:
        failed.append(f"tp2: local heads {heads}, expected 14 / 2 trunk heads and 13 + 12 ViT heads")
    log("parallel training (phase 38, this call): " + json.dumps(summary))
    if failed:
        raise AssertionError("phase 38 failed: " + " | ".join(failed))
    return summary


# ---------------------------------------------------------------------------
# Phase 39: tensor-parallel serving
# ---------------------------------------------------------------------------

SERVING_TP_LAYERS = (2, 2)
# (b)'s depth, a fifteenth of InternViT-6B's 45 layers and a fourteenth of Qwen2-7B's 28: at tp 2 over
# gloo every layer's all-reduces cost more than its compute, and at full depth (b) took most of the 172 s
# its world of two ran on a slow host (its serving run alone 45.6 s); 3 + 2 (6 + 4 until phase 44 came)
# keeps the whole run with phases 43 and 44 inside its time limit
SERVING_TP_DEEP = (3, 2)
SERVING_TP_FAULTS = ("o_proj_reduce_dropped", "kv_heads_of_the_other_rank", "vocab_blocks_reversed")
SERVING_TP_FAULT_STEPS = 4  # a fault's step logits are compared over this many steps
# (b): the kernels' first-token logit gap, tp 2 against world 1, within this many
# times the plain route's gap on the same weights (how C4 was settled)
SERVING_TP_BAR = 1.5
SERVING_TP_WARM = 4  # new tokens of the warm-up requests


def layerwise_model(cfg, seed: int, mesh=None) -> dict:
    """Random bf16 weights whose every layer is drawn from a generator of
    its own (seed, tower, layer), built one layer at a time: with ``mesh``
    this rank's shard (``parallel.sharding.shard_stacked``), so no rank
    holds the whole tree.  The same weights at any tp."""
    import torch

    from omchat_torch.models import intern_vit, projector, qwen2
    from omchat_torch.parallel.sharding import omchat_param_specs, shard_params, shard_stacked

    bf = torch.bfloat16

    def gen(tower: int, i: int):
        return torch.Generator(device=DEVICE).manual_seed(seed * 1_000_003 + tower * 10_007 + i)

    one_v = dataclasses.replace(cfg.vision, num_hidden_layers=1)
    one_t = dataclasses.replace(cfg.text, num_hidden_layers=1)
    vit, text = intern_vit.init_params(one_v, gen(1, 0), bf), qwen2.init_params(one_t, gen(2, 0), bf)
    del vit["layers"], text["layers"]
    rest = {"vision_tower": vit, "language_model": text,
            "projector": projector.init_params(cfg.projector, cfg.vision.hidden_size, cfg.text.hidden_size,
                                               gen(3, 0), bf)}
    specs = omchat_param_specs(cfg, rest)
    params = rest if mesh is None else shard_params(rest, mesh, specs)
    del rest
    params["vision_tower"]["layers"] = shard_stacked(
        lambda i: intern_vit.init_params(one_v, gen(1, i + 1), bf)["layers"], cfg.vision.num_hidden_layers, mesh,
        specs["vision_tower"]["layers"], DEVICE)
    params["language_model"]["layers"] = shard_stacked(
        lambda i: qwen2.init_params(one_t, gen(2, i + 1), bf)["layers"], cfg.text.num_hidden_layers, mesh,
        specs["language_model"]["layers"], DEVICE)
    return params


@contextlib.contextmanager
def serving_tp_fault(fault, mesh):
    """Swap a planted serving fault into the modules the engines reach:
    o_proj's row-parallel reduce dropped in every layer (down_proj still
    reduces), the cache written
    with the next rank's kv heads (the prefill's write, which its attention
    then reads, and the decode's row commit), the vocabulary blocks gathered
    in reversed rank order."""
    import torch

    from omchat_torch.models import qwen2
    from omchat_torch.parallel import comm

    saved = []

    def swap(name, fn):
        saved.append((name, getattr(qwen2, name)))
        setattr(qwen2, name, fn)

    if fault == "o_proj_reduce_dropped":
        row = qwen2._row_lora_dense
        swap("_row_lora_dense", lambda y, p, a8, lora, name, ids, m, seq=None: row(
            y, p, a8, lora, name, ids, None if name == "o_proj" else m, seq))
    elif fault == "kv_heads_of_the_other_rank":
        commit, attend = qwen2.commit_decode_rows, qwen2.cache_attend
        tp, me = mesh.axis_size("model"), mesh.axis_index("model")

        def other(rows):  # [..., KVH/tp, D] at dim 2: the next rank's kv heads
            return comm._gather(rows.contiguous(), mesh.group("model"), 2).chunk(tp, 2)[(me + 1) % tp].contiguous()

        swap("commit_decode_rows", lambda cache, wp, k, v, impl=None: commit(cache, wp, other(k), other(v), impl))
        swap("cache_attend", lambda impl, wp, starts, kv_len, kc, vc, q, k, v, seg=None, runs=None: attend(
            impl, wp, starts, kv_len, kc, vc, q, other(k), other(v), seg, runs))
    elif fault == "vocab_blocks_reversed":
        swap("gather_vocab", lambda logits, vocab_size, m: torch.cat(
            comm._gather(logits.contiguous(), m.group("model"), 0).chunk(m.axis_size("model"), 0)[::-1], dim=-1))
    try:
        yield
    finally:
        for name, fn in reversed(saved):
            setattr(qwen2, name, fn)


def serving_tp_cfg(layers=None):
    from omchat_torch.config import OmChatConfig

    full = OmChatConfig()
    if layers is None:
        return full
    v, t = layers
    return dataclasses.replace(full, vision=dataclasses.replace(full.vision, num_hidden_layers=v),
                               text=dataclasses.replace(full.text, num_hidden_layers=t))


def serving_tp_engines(cfg, params, seed: int, impl, mesh=None, fault=None, engines=("single", "paged", "slot"),
                       lora_bank=None, adapters=None, moe_impl="dense") -> dict:
    """The three engines on one route at 2+2 layers: the single-request
    engine on phase 3's request (each step's logits), the paged and the slot
    engine on phase 7's 4 requests (first-token logits), each with the
    launches of its run; eager decode steps, so that a launch count is a
    count of steps.  ``engines``: which of them run; ``lora_bank`` with
    ``adapters`` (the single request's adapter, then the slot requests'
    ones); ``moe_impl``: the paged engine's experts route; ``fault``: the
    single-request engine alone under a planted fault (phase 39's or phase
    40's)."""
    import torch

    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.batch_engine import BatchEngine
    from omchat_torch.runtime.generate import OmChatEngine
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    adapters = adapters or [None] * 5
    bank = {} if lora_bank is None else {"lora_bank": lora_bank}

    counted = paged_counters()
    counted["flash_decode_stacked"] = counters()["flash_decode_stacked"]

    def run(fn):
        for c in counted.values():
            c.launches = 0
        res = fn()
        torch.cuda.synchronize()
        res["launches"] = {n: c.launches for n, c in counted.items()}
        return res

    ids, tiles = make_request(cfg, seed)
    work = serving_workload(cfg)[:4]
    gen = GenerationConfig(max_new_tokens=PARITY_NEW_TOKENS, eos_token_id=-1)

    def single():
        eng = OmChatEngine(cfg, params, attn_impl=impl, image_cache_size=0, decode_graphs=False, mesh=mesh,
                           device=DEVICE, **bank)
        steps = []
        out = eng.generate([ids], tiles, gen, logits_callback=lambda s, lg: steps.append(lg[0].float().cpu()),
                           adapter_id=adapters[0])
        return {"tokens": out.token_ids[0], "logits": steps}

    if fault is not None:
        with (serving_tp_fault if fault in SERVING_TP_FAULTS else remainder_fault)(fault, mesh):
            return single()

    def paged():
        eng = PagedBatchEngine(cfg, params, attn_impl=impl, image_cache_size=0, device=DEVICE, decode_graphs=False,
                               mesh=mesh, moe_impl=moe_impl, **SERVING)
        first = capture_first_logits(eng)
        rids = drive(eng, work, PARITY_NEW_TOKENS)
        return {"tokens": [eng.result(r) for r in rids], "first": [first[r][0].cpu() for r in rids]}

    def slot():
        eng = BatchEngine(cfg, params, attn_impl=impl, device=DEVICE, decode_graphs=False, mesh=mesh, **SLOT_ENGINE,
                          **bank)
        rec = record_slot_run(eng)
        rids = [eng.submit(w_ids, w_tiles, max_new_tokens=PARITY_NEW_TOKENS, eos_token_id=-1, adapter_id=a or 0)
                for (w_ids, w_tiles), a in zip(work, adapters[1:])]
        eng.run_to_completion()
        return {"tokens": [eng.result(r) for r in rids], "first": [rec["logits"][r].cpu() for r in rids]}

    res = {name: run({"single": single, "paged": paged, "slot": slot}[name]) for name in engines}
    if mesh is None:  # phase 7's rule reads the single-request engine's step margins of each request
        eng = OmChatEngine(cfg, params, attn_impl=impl, image_cache_size=0, decode_graphs=False, device=DEVICE, **bank)
        res["margins"] = []
        for (w_ids, w_tiles), a in zip(work, adapters[1:] if "slot" in engines and bank else [None] * len(work)):
            steps = []
            eng.generate([w_ids], w_tiles, gen, logits_callback=lambda s, lg: steps.append(lg[0].float()),
                         adapter_id=a)
            res["margins"].append([float(t[0] - t[1]) for t in (torch.topk(lg, 2).values for lg in steps)])
    return res


def serving_tp_full(cfg, params, seed: int, mesh=None) -> dict:
    """Phase 39 (b) on this rank (or world 1 without ``mesh``): phase 3's
    request's first-token logits on the kernels and on the plain route;
    with ``mesh`` also the o_proj fault's, the timed request (eager steps),
    the collectives' share of a decode step and phase 5's workload through
    the paged engine."""
    import numpy as np
    import torch

    from omchat_torch.config import GenerationConfig
    from omchat_torch.ops.sampling import greedy
    from omchat_torch.parallel import comm
    from omchat_torch.runtime.generate import OmChatEngine
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    ids, tiles = make_request(cfg, seed)

    def first_logits(impl, fault=None):
        eng = OmChatEngine(cfg, params, attn_impl=impl, image_cache_size=0, mesh=mesh, device=DEVICE)
        with serving_tp_fault(fault, mesh) if fault else contextlib.nullcontext():
            logits, _ = eng.prefill(eng.plan([ids]), eng.encode_images(tiles), 0)
        return logits[0].float().cpu()

    out = {"logits": {"kernel": first_logits(None), "plain": first_logits("plain")}}
    if mesh is None:
        return out
    out["logits"]["fault"] = first_logits(None, "o_proj_reduce_dropped")
    counted = {**paged_counters(), "flash_decode_stacked": counters()["flash_decode_stacked"]}

    def launches():
        torch.cuda.synchronize()
        got = {n: c.launches for n, c in counted.items()}
        for c in counted.values():
            c.launches = 0
        return got

    eng = OmChatEngine(cfg, params, image_cache_size=0, mesh=mesh, device=DEVICE)
    eng.generate([ids], tiles, GenerationConfig(max_new_tokens=SERVING_TP_WARM, eos_token_id=-1))
    torch.cuda.reset_peak_memory_stats()
    launches()
    got = eng.generate([ids], tiles, GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1))
    sp = eng.spans
    out["request"] = {"new_tokens": len(got.token_ids[0]), "ttft_ms": sp["ttft"] * 1e3,
                      "vit_ms": sp["encode_images"] * 1e3, "prefill_ms": sp["prefill"] * 1e3,
                      "decode_ms": sp["decode"] * 1e3, "decode_ms_a_step": sp["decode"] * 1e3 / sp["decode_steps"],
                      "graphed": eng.graphed(), "launches": launches()}
    plan = eng.plan([ids])
    logits, cache = eng.prefill(plan, eng.encode_images(tiles), 16)
    tok, kv_len = greedy(logits), torch.as_tensor(plan.lengths, device=DEVICE)
    comm.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with comm.timing():
        for _ in range(8):
            logits, cache = eng.decode_step(tok, kv_len, cache)
            tok, kv_len = greedy(logits), kv_len + 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["decode_collectives"] = {"share": sum(comm.SECONDS.values()) / wall, "ms_a_step": wall * 1e3 / 8,
                                 "calls_a_step": {k: v / 8 for k, v in comm.CALLS.items()}}
    del eng, cache
    gc.collect()
    torch.cuda.empty_cache()
    pe = PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, mesh=mesh, **SERVING)
    work = serving_workload(cfg)
    drive(pe, work[:3], SERVING_TP_WARM)
    pe.reset_latency_stats()
    launches()
    t0 = time.perf_counter()
    rids = drive(pe, work, SERVING_NEW_TOKENS)
    wall = time.perf_counter() - t0
    counts = launches()
    lat = pe.latency_stats()
    toks = [pe.result(r) for r in rids]
    out["serving"] = {"tokens_per_s": sum(map(len, toks)) / wall, "wall_s": wall,
                      "ttft_p50_s": lat.get("ttft_p50_s"), "ttft_p99_s": lat.get("ttft_p99_s"),
                      "rolls_eager": lat["rolls_eager"], "rolls_graphed": lat["rolls_graphed"],
                      "launches": counts, "all_tokens": all(len(t) == SERVING_NEW_TOKENS for t in toks),
                      "pages_back": pe.allocator.available == SERVING["num_pages"]}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del pe
    return out


def serving_tp_rank(seed: int, small_ref: dict, remainder=()) -> dict:
    """Phase 39 in one rank of the world of 2: (a) at 2+2 layers on both
    routes and the faults, then (b) at SERVING_TP_DEEP layers; then phase 40's tp-2
    cases ``remainder``, which share this world."""
    import torch
    import torch.distributed as dist

    from omchat_torch.parallel.mesh import create_mesh

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh(tp=2)
    cfg = serving_tp_cfg(SERVING_TP_LAYERS)
    params = layerwise_model(cfg, seed, mesh)
    out = {"heads": {"trunk_q": params["language_model"]["layers"]["self_attn"]["q_proj"]["kernel"].shape[-1] // 128,
                     "trunk_kv": params["language_model"]["layers"]["self_attn"]["k_proj"]["kernel"].shape[-1] // 128,
                     "vit": params["vision_tower"]["layers"]["attn"]["qkv"]["kernel"].shape[-1] // 3 // 128}}
    t0 = time.perf_counter()
    out["small"] = {route: serving_tp_engines(cfg, params, seed, impl, mesh)
                    for route, impl in (("kernel", None), ("plain", "plain"))}
    out["faults"] = {f: serving_tp_engines(cfg, params, seed, None, mesh, fault=f) for f in SERVING_TP_FAULTS}
    out["small_s"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = serving_tp_cfg(SERVING_TP_DEEP)
    params = layerwise_model(cfg, seed, mesh)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["shard_gib"] = torch.cuda.memory_allocated() / 2**30
    out["full"] = serving_tp_full(cfg, params, seed, mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["remainder"] = remainder_rank(seed, remainder, 2) if remainder else None
    log(f"serving tp rank {dist.get_rank()}: " + json.dumps(
        {"heads": out["heads"], "build_s": out["build_s"], "shard_gib": out["shard_gib"],
         "peak_gib": out["full"]["peak_gib"], "request": out["full"]["request"],
         "decode_collectives": out["full"]["decode_collectives"], "serving": out["full"]["serving"]}))
    if dist.get_rank() != 0:  # rank 0 brings the logits back; every rank its launches and tokens
        for route in out["small"].values():
            for res in route.values():
                res.pop("logits", None)
                res.pop("first", None)
        out["faults"] = None
        out["full"].pop("logits")
    return out


def _tp_launch_rule(world1: dict) -> dict:
    """The launches a rank must make for a run world 1 made with
    ``world1``: the same counts, each ViT layer's K1 (and its prepass) a K2
    on the rank's heads."""
    want = dict(world1)
    want["flash_attention"] = world1["flash_attention"] + world1["packed_qkv_norm_attention"]
    want["packed_qkv_norm_attention"] = want["qk_norm_prepass"] = 0
    return want


REMAINDER_TP2_CASES = ("w8a8", "lora", "moe")


def serving_tp(seed: int, e2e: dict, serve: dict, remainder=REMAINDER_TP2_CASES) -> tuple:
    """Phase 39: tensor-parallel serving on two ranks sharing the card.
    Returns (its summary, its world-1 references at 2+2 layers, each rank's
    results of phase 40's tp-2 cases ``remainder``, run in the same
    world)."""
    import torch

    from omchat_torch.parallel.launch import run_ranks

    failed = []
    cfg = serving_tp_cfg(SERVING_TP_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = layerwise_model(cfg, seed)
    ref = {route: serving_tp_engines(cfg, params, seed, impl) for route, impl in (("kernel", None), ("plain", "plain"))}
    del params
    params = layerwise_model(serving_tp_cfg(SERVING_TP_DEEP), seed)
    full_ref = serving_tp_full(serving_tp_cfg(SERVING_TP_DEEP), params, seed)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    world1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = run_ranks(serving_tp_rank, 2, seed, {}, remainder, timeout=900)
    world2_s = time.perf_counter() - t0
    log(f"serving tp: world 1 references {world1_s:.1f} s, the world of 2 {world2_s:.1f} s; two ranks share one "
        "card over gloo, so the times show the collectives' overhead, not scaling")
    # (a): parity, launches and faults at 2+2 layers
    small = {}
    for route in ("kernel", "plain"):
        for name in ("single", "paged", "slot"):
            got, want = ranks[0]["small"][route][name], ref[route][name]
            key = f"{route}/{name}"
            if name == "single":
                firsts, wants, toks, want_toks = [got["logits"][0]], [want["logits"][0]], [got["tokens"]], \
                    [want["tokens"]]
                margins = [[float(t[0] - t[1]) for t in (torch.topk(lg, 2).values for lg in want["logits"])]]
            else:
                firsts, wants, toks, want_toks = got["first"], want["first"], got["tokens"], want["tokens"]
                margins = ref[route]["margins"]
            row = []
            for i, (a, b, t, w, m) in enumerate(zip(firsts, wants, toks, want_toks, margins)):
                dev = (a - b).abs()
                outside = int((dev > LOGITS_ATOL + LOGITS_RTOL * b.abs()).sum())
                upto = next((j for j, x in enumerate(m) if x < PARITY_MARGIN), len(m))
                row.append({"logits_max_abs_diff": float(dev.max()), "tokens_compared": upto,
                            "tokens_equal_beyond": t == w})
                if outside:
                    failed.append(f"(a) {key} request {i}: first-token logits {outside} outside phase 4's limits "
                                  f"(max diff {float(dev.max()):.4g})")
                if t[:upto] != w[:upto]:
                    failed.append(f"(a) {key} request {i}: tokens {t[:upto]} != world 1's {w[:upto]}")
            small[key] = row
            for r, res in enumerate(ranks):
                mine = res["small"][route][name]
                if route == "kernel" and mine["launches"] != _tp_launch_rule(want["launches"]):
                    failed.append(f"(a) {key} rank {r}: launches {mine['launches']}, expected "
                                  f"{_tp_launch_rule(want['launches'])} (world 1: {want['launches']})")
                if route == "plain" and any(mine["launches"].values()):
                    failed.append(f"(a) {key} rank {r}: the plain route launched {mine['launches']}")
                if mine["tokens"] != ranks[0]["small"][route][name]["tokens"]:
                    failed.append(f"(a) {key}: rank {r}'s tokens differ from rank 0's")
    faults = {}
    sound = ranks[0]["small"]["kernel"]["single"]["logits"][:SERVING_TP_FAULT_STEPS]
    for fault, res in ranks[0]["faults"].items():
        bad = res["logits"][:SERVING_TP_FAULT_STEPS]
        outside = [int(((a - b).abs() > LOGITS_ATOL + LOGITS_RTOL * b.abs()).sum()) for a, b in zip(bad, sound)]
        faults[fault] = {"logits_outside_by_step": outside,
                         "max_abs_diff_by_step": [float((a - b).abs().max()) for a, b in zip(bad, sound)]}
        if not any(outside):
            failed.append(f"(a) the limits would pass {fault}: {faults[fault]}")
    heads = [r["heads"] for r in ranks]
    if [h["trunk_q"] for h in heads] != [14, 14] or [h["trunk_kv"] for h in heads] != [2, 2] or \
            sorted(h["vit"] for h in heads) != [12, 13]:
        failed.append(f"local heads {heads}, expected 14 / 2 trunk heads and 13 + 12 ViT heads")
    # (b): SERVING_TP_DEEP layers
    full = ranks[0]["full"]
    gaps = {route: float((full["logits"][route] - full_ref["logits"][route]).abs().max())
            for route in ("kernel", "plain")}
    gaps["fault"] = float((full["logits"]["fault"] - full_ref["logits"]["kernel"]).abs().max())
    bar = SERVING_TP_BAR * gaps["plain"]
    if gaps["kernel"] > bar:
        failed.append(f"(b) tp 2 vs world 1 first-token logits on the kernels {gaps['kernel']:.4g} past "
                      f"{SERVING_TP_BAR} x the plain route's {gaps['plain']:.4g}")
    if gaps["fault"] <= bar:
        failed.append(f"(b) the bar {bar:.4g} would pass o_proj's dropped reduce ({gaps['fault']:.4g})")
    n_v, n_t = SERVING_TP_DEEP
    steps = NEW_TOKENS - 1  # the request's eager decode steps: K3 on every layer, one K4 commit
    want = {"flash_attention": n_t + n_v, "flash_decode_stacked": n_t * steps, "commit_rows": steps,
            "packed_qkv_norm_attention": 0, "qk_norm_prepass": 0}
    for r, res in enumerate(ranks):
        sv, rq = res["full"]["serving"], res["full"]["request"]
        if not (sv["all_tokens"] and sv["pages_back"]) or sv["rolls_graphed"] or rq["graphed"]:
            failed.append(f"(b) rank {r}: serving {sv}, request {rq}")
        if any(rq["launches"][n] != k for n, k in want.items()):
            failed.append(f"(b) rank {r}: the request's launches {rq['launches']}, expected {want}")
        if sv["launches"] != ranks[0]["full"]["serving"]["launches"] or not all(
                sv["launches"][n] for n in ("flash_attention", "commit_rows", "paged_flash_decode",
                                            "paged_flash_prefill", "commit_pages")):
            failed.append(f"(b) rank {r}: serving launches {sv['launches']}")
    summary = {
        "card": CARD,
        "(a) parity": small, "(a) faults": faults, "heads": heads,
        "(b) first-token logit gaps to world 1": {**gaps, "bar": bar},
        "(b) request tp 2": [r["full"]["request"] for r in ranks],
        "(b) request world 1 at full depth (phase 3, graphed; not comparable)": {
            k: e2e.get(k) for k in ("ttft_ms", "vit_ms", "prefill_ms", "decode_tokens_per_s", "peak_mem_gib")},
        "(b) decode collectives tp 2": [r["full"]["decode_collectives"] for r in ranks],
        "(b) serving tp 2": [r["full"]["serving"] for r in ranks],
        "(b) serving world 1 at full depth (phase 5, graphed; not comparable)": {
            k: serve.get(k) for k in ("tokens_per_s", "ttft_p50_s", "ttft_p99_s")},
        "(b) peak GiB tp 2": [r["full"]["peak_gib"] for r in ranks], "(b) shard GiB": [r["shard_gib"] for r in ranks],
        "(b) build s": [r["build_s"] for r in ranks], "world1_s": world1_s, "world2_s": world2_s,
    }
    log("serving tp (phase 39, this call): " + json.dumps(summary))
    if failed:
        raise AssertionError("phase 39 failed: " + " | ".join(failed))
    return summary, ref, [r["remainder"] for r in ranks] if remainder else None


# ---------------------------------------------------------------------------
# Phase 40: the rest of tensor-parallel serving
# ---------------------------------------------------------------------------

# each case's planted fault: the row-parallel amax unreduced, a row-parallel
# LoRA delta added after the reduce, a rank's experts indexed from expert 0,
# a rank's q heads reading the kv head of the next group.  The limits are
# phase 4's, widened where world 1 itself moves by more on the same function
# computed with other roundings: w8a8 to SERVING_TP_BAR x the gap between
# world 1's glue route and its unfused chain (an int8 code flips where a
# bf16 input moves by an ulp; the sharp check there is the codes' and
# accumulators' bitwise equality), the MoE trunk to MOE_GMM_REL of max
# |logit| (phase 33's rule for its two expert routes: the experts' sum is
# taken in another order across the ranks, and a top-k pick may flip)
REMAINDER_FAULTS = {"w8a8": "amax_not_reduced", "lora": "lora_delta_after_reduce", "moe": "experts_from_zero",
                    "tp8": "next_kv_head"}
REMAINDER_ADAPTERS = [2, 1, 2, 3, 0]  # the single request's adapter, then the slot requests' (mixed)
REMAINDER_TP8 = 8
REMAINDER_STEPS = 8  # timed eager decode steps a case


@contextlib.contextmanager
def remainder_fault(fault, mesh=None):
    """Swap one of phase 40's planted faults into the modules it reaches."""
    from omchat_torch.models import qwen2, qwen2_moe
    from omchat_torch.parallel import comm, tp_attention

    saved = []

    def swap(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    if fault == "amax_not_reduced":
        swap(comm, "max_over_axis", lambda x, m, axis="model": x.detach().contiguous().clone())
    elif fault == "lora_delta_after_reduce":
        def after(y, p, a8, lora, name, ids, m, seq=None):
            out = comm.row_parallel_dense(y, p, m, a8=a8)
            return out + qwen2.lora_delta(y, lora[name], ids) if lora is not None and name in lora else out

        swap(qwen2, "_row_lora_dense", after)
    elif fault == "experts_from_zero":
        block = qwen2_moe.expert_block
        swap(qwen2_moe, "expert_block", lambda cfg, m=None: (lambda b: slice(0, b.stop - b.start))(block(cfg, m)))
    elif fault == "next_kv_head":
        swap(tp_attention, "_kv_head", lambda j, h, kvh: (j // (h // kvh) + 1) % kvh)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def unfused_w8a8():
    """The one-device kernels route on the unfused w8a8 chain, the chain a
    mesh runs (and the JAX package under a mesh): the trunk's glue layer
    and the ViT's packed path (its glue scan) off, so every product is
    ``dense(a8=True)`` and the ViT's attention is K2 on the split path."""
    from omchat_torch.models import intern_vit, qwen2
    from omchat_torch.runtime import paged_engine

    saved = [(qwen2, "quant_glue_ok"), (paged_engine, "quant_glue_ok"), (intern_vit, "packed_seq_supported")]
    saved = [(m, n, getattr(m, n)) for m, n in saved]
    for m, n, _ in saved:
        setattr(m, n, lambda *a: False)
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def remainder_model(case: str, seed: int, mesh=None):
    """(cfg, params, lora bank) of a phase 40 case at full width and 2+2
    layers, bf16, the same weights on every rank and on world 1: the whole
    tree (the tp-8 case's with ``mesh``: this rank's shard, built a layer at
    a time).  The bank is whole (the engines shard it).  w8a8 is
    ``api.quantize_model`` on the whole model, as a one-device load
    quantizes and calibrates; the MoE case is phase 33's
    Qwen1.5-MoE-A2.7B trunk."""
    import torch

    from omchat_torch import api
    from omchat_torch.training.lora import build_lora_bank

    bank = None
    if case == "moe":
        cfg, params = moe_model(None, seed, layers=2)
    elif case == "tp8":
        cfg = serving_tp_cfg(SERVING_TP_LAYERS)
        return cfg, layerwise_model(cfg, seed, mesh), None
    else:
        cfg = serving_tp_cfg(SERVING_TP_LAYERS)
        params = layerwise_model(cfg, seed)
        if case == "w8a8":
            cfg, params = api.quantize_model(cfg, params, w8a8=True)
        else:  # phase 27's seeded rank-16 adapters on q / k / v / o, three of them
            bank = build_lora_bank(seeded_adapters(params, seed + 40, n=3), dtype=torch.bfloat16)
    return cfg, params, bank


def remainder_case_runs(case: str, cfg, params, bank, seed: int, mesh=None) -> dict:
    """A case's engines on the kernels and on the plain route (each its
    launches), and with ``mesh`` the planted fault's run."""
    runs = {"w8a8": dict(engines=("single", "paged")),
            "lora": dict(engines=("single", "slot"), lora_bank=bank, adapters=REMAINDER_ADAPTERS),
            "moe": dict(engines=("single", "paged", "slot")),
            "tp8": dict(engines=("single", "paged"))}[case]
    ctx = unfused_w8a8 if case == "w8a8" and mesh is None else contextlib.nullcontext
    out = {}
    with ctx():
        for route, impl in (("kernel", None), ("plain", "plain")):
            out[route] = serving_tp_engines(cfg, params, seed, impl, mesh, **runs)
        if case == "moe":  # the paged engine on the gmm experts route
            out["kernel"]["paged_gmm"] = serving_tp_engines(cfg, params, seed, None, mesh, engines=("paged",),
                                                            moe_impl="gmm")["paged"]
    if mesh is not None:
        out["fault"] = serving_tp_engines(cfg, params, seed, None, mesh, fault=REMAINDER_FAULTS[case],
                                          lora_bank=bank, adapters=runs.get("adapters"))
    return out


def remainder_timing(cfg, params, bank, seed: int, mesh) -> dict:
    """The single-request engine's eager decode step on the kernels: ms a
    step and the collectives' share of it (each collective waits for the
    card before and after it, :func:`omchat_torch.parallel.comm.timing`)."""
    import torch

    from omchat_torch.ops.sampling import greedy
    from omchat_torch.parallel import comm
    from omchat_torch.runtime.generate import OmChatEngine

    ids, tiles = make_request(cfg, seed)
    eng = OmChatEngine(cfg, params, image_cache_size=0, mesh=mesh, device=DEVICE, decode_graphs=False,
                       **({} if bank is None else {"lora_bank": bank}))
    plan = eng.plan([ids])
    logits, cache = eng.prefill(plan, eng.encode_images(tiles), 16)
    tok, kv_len = greedy(logits), torch.as_tensor(plan.lengths, device=DEVICE)
    out = {}
    for timed in (False, True):
        comm.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with comm.timing() if timed else contextlib.nullcontext():
            for _ in range(REMAINDER_STEPS):
                logits, cache = eng.decode_step(tok, kv_len, cache)
                tok, kv_len = greedy(logits), kv_len + 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if timed:
            out.update(collectives_share=sum(comm.SECONDS.values()) / wall,
                       calls_a_step={k: v / REMAINDER_STEPS for k, v in comm.CALLS.items()})
        else:
            out["step_ms"] = wall * 1e3 / REMAINDER_STEPS
    return out


def remainder_rank(seed: int, cases, tp: int) -> dict:
    """Phase 40's cases in one rank of a world of ``tp``: each case's
    engines on both routes, its fault, its eager step and this rank's peak
    GiB; for w8a8 also the row-parallel codes, row scales and int32
    accumulators of layer 0 against world 1's, bitwise."""
    import torch
    import torch.distributed as dist

    from omchat_torch.parallel.mesh import create_mesh
    from omchat_torch.parallel.sharding import omchat_param_specs, shard_params
    from omchat_torch.parallel.tp_attention import head_runs
    from omchat_torch.runtime.generate import OmChatEngine

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh(tp=tp)
    out = {}
    for case in cases:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg, params, bank = remainder_model(case, seed, mesh)
        res = {}
        if case != "tp8":  # the whole tree, then this rank's shard
            whole, params = params, shard_params(params, mesh, omchat_param_specs(cfg, params))
            if case == "w8a8":
                res["codes"] = remainder_codes(cfg, seed, mesh, whole, params)
            del whole
            gc.collect()
            torch.cuda.empty_cache()
        res.update(build_s=time.perf_counter() - t0, runs=head_runs(cfg.text, mesh))
        if case == "lora":  # bank row 0 adds exactly nothing: the base model's logits, bitwise
            ids, tiles = make_request(cfg, seed)
            first = []
            for kw in ({"lora_bank": bank}, {}):
                eng = OmChatEngine(cfg, params, image_cache_size=0, mesh=mesh, device=DEVICE, **kw)
                logits, _ = eng.prefill(eng.plan([ids]), eng.encode_images(tiles), 0,
                                        adapter_ids=eng._adapter_ids(1, 0))
                first.append(logits)
            res["adapter0_bitwise_base"] = bool(torch.equal(*first))
            del eng, first
        res.update(remainder_case_runs(case, cfg, params, bank, seed, mesh))
        res["timing"] = remainder_timing(cfg, params, bank, seed, mesh)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res["s"] = time.perf_counter() - t0
        del params, bank
        gc.collect()
        torch.cuda.empty_cache()
        if dist.get_rank() != 0:  # rank 0 brings the logits back; every rank its launches and tokens
            for route in ("kernel", "plain"):
                for run in res[route].values():
                    if isinstance(run, dict):
                        run.pop("logits", None)
                        run.pop("first", None)
            res["fault"] = None
        out[case] = res
    return out


def remainder_codes(cfg, seed: int, mesh, whole, local) -> dict:
    """Layer 0's o_proj (over the rank's heads) and down_proj (over its
    slice of the width) on seeded bf16 activations: each rank's int8 codes,
    row scales and int32 accumulator against world 1's from the whole
    quantized layer, bitwise (sound and with the unreduced amax)."""
    import torch

    from omchat_torch.ops.linear import _int8_product, quantize_activations
    from omchat_torch.parallel.comm import model_slice, row_parallel_int8
    from omchat_torch.utils.tree import layer_slice

    tc = cfg.text
    full, mine = (layer_slice(t["language_model"]["layers"], 0) for t in (whole, local))
    g = torch.Generator(device=DEVICE).manual_seed(seed + 41)
    out = {}
    for name, group, width, units in (("o_proj", "self_attn", tc.num_attention_heads * tc.attn_head_dim,
                                       tc.num_attention_heads), ("down_proj", "mlp", tc.intermediate_size, None)):
        x = torch.randn((2, 700, width), generator=g, device=DEVICE).to(torch.bfloat16)
        cols = model_slice(width, mesh, units=units)
        wq, wrs = quantize_activations(x)
        wacc = _int8_product(wq, full[group][name])
        for label, ctx in (("sound", contextlib.nullcontext), ("fault", lambda: remainder_fault("amax_not_reduced"))):
            with ctx():
                xq, rs, acc = row_parallel_int8(x[..., cols], mine[group][name], mesh)
            out[f"{name}/{label}"] = [bool(torch.equal(xq, wq[..., cols])), bool(torch.equal(rs, wrs)),
                                      bool(torch.equal(acc, wacc))]
    return out


def _remainder_launch_rule(world1: dict, runs) -> dict:
    """The launches a rank must make for a run world 1 made with
    ``world1`` (:func:`_tp_launch_rule`), the trunk's attention kernels
    once per run of q heads that share a kv head where the kv heads
    replicate (``runs`` of ``head_runs``; None: one call as on one device).
    World 1's K2 launches are the trunk's (its ViT takes K1, or K2 on the
    unfused w8a8 chain, which the caller folds in)."""
    want = _tp_launch_rule(world1)
    r = 1 if runs is None else len(runs)
    for name in ("flash_decode_stacked", "paged_flash_decode", "paged_flash_prefill"):
        if name in want:
            want[name] = world1[name] * r
    want["flash_attention"] = world1["flash_attention"] * r + world1["packed_qkv_norm_attention"]
    return want


def serving_tp_remainder(seed: int, tp2=None, tp8_ref=None) -> dict:
    """Phase 40: w8a8, a LoRA bank and the MoE trunk at tp 2, Qwen2-7B's 4
    kv heads replicated at tp 8 (eight ranks sharing the card), each against
    the same engines on world 1 on the same weights and route.  ``tp2``:
    the tp-2 cases' rank results from phase 39's world (run here without
    it); ``tp8_ref``: phase 39's world-1 references of the same 2+2-layer
    model (computed here without them)."""
    import torch

    from omchat_torch.parallel.launch import run_ranks

    failed, summary = [], {"card": CARD}
    t0 = time.perf_counter()
    if tp2 is None:
        tp2 = run_ranks(remainder_rank, 2, seed, ("w8a8", "lora", "moe"), 2, timeout=900)
    tp8 = run_ranks(remainder_rank, REMAINDER_TP8, seed, ("tp8",), REMAINDER_TP8, timeout=900)
    ranks_s = time.perf_counter() - t0
    worlds = {case: [r[case] for r in tp2] for case in ("w8a8", "lora", "moe")}
    worlds["tp8"] = [r["tp8"] for r in tp8]
    for case, got in worlds.items():
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        if case == "tp8" and tp8_ref is not None:
            ref = tp8_ref
        else:
            cfg, params, bank = remainder_model(case, seed)
            ref = remainder_case_runs(case, cfg, params, bank, seed)
            if case == "w8a8":  # the glue route's gap beside the unfused chain's
                ref["glue"] = serving_tp_engines(cfg, params, seed, None, engines=("single",))["single"]
            del params, bank
        ref_s = time.perf_counter() - t1
        floor = 0.0
        if case == "w8a8":
            floor = SERVING_TP_BAR * float((ref["glue"]["logits"][0] - ref["kernel"]["single"]["logits"][0]).abs().max())

        def outside_of(a, b):
            limit = LOGITS_ATOL + LOGITS_RTOL * b.abs()
            if case == "moe":
                limit = limit.clamp(min=MOE_GMM_REL * float(b.abs().max()))
            return (a - b).abs() > limit.clamp(min=floor)

        rows, faults = {}, {}
        for route in ("kernel", "plain"):
            for name, want in ref[route].items():
                if name == "margins" or name not in got[0][route]:
                    continue
                mine = got[0][route][name]
                if name == "single":
                    pairs = [(mine["logits"][0], want["logits"][0], mine["tokens"], want["tokens"],
                              [float(t[0] - t[1]) for t in (torch.topk(lg, 2).values for lg in want["logits"])])]
                else:
                    pairs = list(zip(mine["first"], want["first"], mine["tokens"], want["tokens"],
                                     ref[route]["margins"]))
                row = []
                for i, (a, b, t, w, m) in enumerate(pairs):
                    dev = (a - b).abs()
                    outside = int(outside_of(a, b).sum())
                    upto = next((j for j, x in enumerate(m) if x < PARITY_MARGIN), len(m))
                    row.append({"logits_max_abs_diff": float(dev.max()), "logits_max_abs": float(b.abs().max()),
                                "tokens_compared": upto, "tokens_equal_beyond": t == w})
                    if outside:
                        failed.append(f"{case} {route}/{name} request {i}: first-token logits {outside} outside "
                                      f"the case's limits (max diff {float(dev.max()):.4g})")
                    if t[:upto] != w[:upto]:
                        failed.append(f"{case} {route}/{name} request {i}: tokens {t[:upto]} != world 1's {w[:upto]}")
                rows[f"{route}/{name}"] = row
                for r, res in enumerate(got):
                    launches = res[route][name]["launches"]
                    if route == "kernel":
                        expect = _remainder_launch_rule(want["launches"], res["runs"])
                        if launches != expect:
                            failed.append(f"{case} {route}/{name} rank {r}: launches {launches}, expected {expect} "
                                          f"(world 1: {want['launches']}, runs {res['runs']})")
                    elif any(launches.values()):
                        failed.append(f"{case} plain/{name} rank {r}: the plain route launched {launches}")
                    if res[route][name]["tokens"] != mine["tokens"]:
                        failed.append(f"{case} {route}/{name}: rank {r}'s tokens differ from rank 0's")
        sound = got[0]["kernel"]["single"]["logits"][:SERVING_TP_FAULT_STEPS]
        bad = got[0]["fault"]["logits"][:SERVING_TP_FAULT_STEPS]
        outside = [int(outside_of(a, b).sum()) for a, b in zip(bad, sound)]
        faults[REMAINDER_FAULTS[case]] = {"logits_outside_by_step": outside,
                                          "max_abs_diff_by_step": [float((a - b).abs().max()) for a, b in
                                                                   zip(bad, sound)]}
        if not any(outside) and not (case == "w8a8" and not all(got[0]["codes"]["o_proj/fault"])):
            failed.append(f"{case}: the limits would pass {REMAINDER_FAULTS[case]}: {faults}")
        entry = {"parity": rows, "faults": faults, "w8a8_floor": floor, "runs_by_rank": [res["runs"] for res in got],
                 "eager_step": [res["timing"] for res in got], "peak_gib": [res["peak_gib"] for res in got],
                 "rank_s": [res["s"] for res in got], "world1_ref_s": ref_s,
                 "launches_by_rank": [{n: res["kernel"][n]["launches"] for n in res["kernel"] if n != "margins"}
                                      for res in got]}
        if case == "w8a8":
            codes = got[0]["codes"]
            entry["codes"] = {r: res["codes"] for r, res in enumerate(got)}
            if not all(all(v) for r in got for k, v in r["codes"].items() if k.endswith("/sound")):
                failed.append(f"w8a8: row-parallel codes / scales / accumulators not bitwise world 1's: {entry['codes']}")
            if all(codes["o_proj/fault"]) or all(codes["down_proj/fault"]):
                failed.append(f"w8a8: the unreduced amax left the codes bitwise: {codes}")
            glue = ref["glue"]["logits"][0]
            entry["glue_route_gap_to_unfused_world1"] = float((glue - ref["kernel"]["single"]["logits"][0]).abs().max())
            entry["tp2_gap_to_unfused_world1"] = rows["kernel/single"][0]["logits_max_abs_diff"]
        if case == "lora":
            base = [res["adapter0_bitwise_base"] for res in got]
            entry["adapter0_bitwise_base"] = base
            if not all(base):
                failed.append(f"lora: adapter 0's logits are not bitwise the base model's on every rank: {base}")
        summary[case] = entry
        log(f"serving tp remainder, {case} (phase 40, this call): " + json.dumps({"card": CARD, **entry}))
    summary["ranks_s"] = ranks_s
    log("serving tp remainder (phase 40, this call): " + json.dumps(
        {"card": CARD, "ranks_s": ranks_s, "note": "ranks share one card over gloo: the times show the "
         "collectives' overhead, not scaling",
         **{case: {"step_ms": [t["step_ms"] for t in e["eager_step"]],
                   "collectives_share": [t["collectives_share"] for t in e["eager_step"]],
                   "peak_gib": e["peak_gib"]} for case, e in summary.items() if isinstance(e, dict) and
            "eager_step" in e}}))
    if failed:
        raise AssertionError("phase 40 failed: " + " | ".join(failed))
    return summary


# ---------------------------------------------------------------------------
# Phase 41: the trainer's sequence modes and an indivisible tp
# ---------------------------------------------------------------------------

# phase 38's setup (full width, PARALLEL_LAYERS layers, B = 2 x 3328 rows, lr 1e-5, 3 steps), with the
# embedding, lm_head and the trunk's MLP frozen (at 2 + 2 layers 1.50 of the 1.83 B parameters, so a
# context rank's gradient sync moved the ViT, the projector and the trunk's attention and norms, 0.33 B,
# a step; at 1 + 1 about half of that)
SEQ_CASES = {  # case: (world, mesh kind, n, batch)
    "ring": (2, "cp", 2, "mm"), "ulysses": (2, "cp", 2, "mm"), "sp": (2, "tp", 2, "mm"),
    "ring_pack": (2, "cp", 2, "pack"), "tp3": (3, "tp", 3, "mm")}
SEQ_FAULTS = (("ring", "the ring's diagonal block run non-causal"),
              ("ring", "dK / dV kept on the rank that computed them"),
              ("ring", "the ViT's gradients summed over context twice"),
              ("ulysses", "Ulysses' received heads interleaved rank by rank"),
              ("sp", "o_proj's and down_proj's reduce-scatter without the sum"),
              ("ring_pack", "the gathered route keeping another rank's rows"),
              ("tp3", "the whole k / v gradients left unsummed over model"))
# a case passes where its kernel route's gaps to world 1 (the largest relative loss gap over the
# steps, the largest relative gap of the gradients' global norm) are within SEQ_BAR times its plain
# route's gaps, each at least its floor; a planted fault must leave one of them past its bar.  The
# floors: bf16 rounding in another order moves a sharded step's mean loss by up to 2.5e-4 and its
# norm by up to 7.4e-4 of world 1's on either route (chip_probes/train_seq_parallel.py on the H100)
SEQ_BAR, SEQ_LOSS_FLOOR, SEQ_NORM_FLOOR = 1.5, 5e-4, 2e-3
# K16 at the shapes phase 41's modes hand it (B, S, H, KVH, causal): a ring block of 1664 rows, causal
# (the diagonal) and not (an earlier shard); Ulysses' 14 heads over 3328 rows; a run of 7 q heads over
# one kv head at tp 3
SEQ_KERNEL_SHAPES = {"ring block, diagonal": (2, 1664, 28, 4, True), "ring block, earlier shard": (2, 1664, 28, 4, False),
                     "ulysses, 14 heads": (2, 3328, 14, 2, True), "tp 3 run of 7": (2, 3328, 7, 1, True)}


def _seq_trainable(path) -> bool:
    return path[:2] not in (("language_model", "embed_tokens"), ("language_model", "lm_head")) and \
        path[:3] != ("language_model", "layers", "mlp")


@contextlib.contextmanager
def seq_fault(fault, vit=()):
    """Swap one of phase 41's planted faults into the modules it reaches
    (``vit``: the ViT's positions among the trainable leaves)."""
    import torch.distributed as dist

    from omchat_torch.ops import attention
    from omchat_torch.parallel import comm, ring_attention
    from omchat_torch.training import train_step as ts

    saved = []

    def swap(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    if fault == "the ring's diagonal block run non-causal":
        mask = ring_attention.block_mask
        swap(ring_attention, "block_mask", lambda c, s, i: None if mask(c, s, i) is None else False)
    elif fault == "dK / dV kept on the rank that computed them":
        swap(ring_attention, "carry_home", lambda dkv, mesh, axis: dkv)
    elif fault == "the ViT's gradients summed over context twice":
        sync = ts._sync_gradients

        def twice(grads, specs, mesh):
            sync(grads, specs, mesh)
            for i in vit:
                comm.all_reduce_(grads[i], comm._group(mesh, "context"))

        swap(ts, "_sync_gradients", twice)
    elif fault == "Ulysses' received heads interleaved rank by rank":
        a2a = comm._all_to_all

        def interleaved(x, group, split_dim, concat_dim):
            out = a2a(x, group, split_dim, concat_dim)
            if concat_dim != 2:
                return out
            n = dist.get_world_size(group)
            return out.unflatten(2, (n, out.shape[2] // n)).transpose(2, 3).flatten(2, 3)

        swap(comm, "_all_to_all", interleaved)
    elif fault == "o_proj's and down_proj's reduce-scatter without the sum":
        leave = comm.tp_leave

        def unsummed(x, mesh, seq=None):  # the rank's rows of its own partial sums
            return leave(x, mesh, seq) if seq is None else x.narrow(1, sum(seq[:mesh.axis_index("model")]),
                                                                     seq[mesh.axis_index("model")])

        swap(comm, "tp_leave", unsummed)
    elif fault == "the gathered route keeping another rank's rows":
        gathered = attention.gathered_attention

        def next_rows(q, k, v, mesh, axis, **kw):
            out = gathered(q, k, v, mesh, axis, **kw)
            return comm.ring_pass(out, mesh, axis)

        swap(attention, "gathered_attention", next_rows)
    elif fault == "the whole k / v gradients left unsummed over model":
        sync = ts._sync_gradients

        class WithoutModel:  # the mesh seen with one rank on `model`
            def __init__(self, mesh):
                self.mesh, self.shape = mesh, {**mesh.shape, "model": 1}

            def __getattr__(self, name):
                return getattr(self.mesh, name)

            def axis_size(self, axis):
                return self.shape.get(axis, 1)

        swap(ts, "_sync_gradients", lambda grads, specs, mesh: sync(grads, specs, WithoutModel(mesh)))
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def recording_norms(norms: list, sharded: bool):
    """Each step's global gradient norm appended to ``norms``: after the
    sharded step's sync (whatever sync is in place), or of one device's
    gradients."""
    import torch

    from omchat_torch.training import train_step as ts

    name = "_sync_gradients" if sharded else "gradients"
    fn = getattr(ts, name)

    def sync(grads, specs, mesh):
        fn(grads, specs, mesh)
        norms.append(float(ts._global_norm(specs, mesh)(grads)))

    def grads_of(loss, leaves):
        grads = fn(loss, leaves)
        norms.append(float(torch.sqrt(sum(g.float().square().sum() for g in grads))))
        return grads

    setattr(ts, name, sync if sharded else grads_of)
    try:
        yield
    finally:
        setattr(ts, name, fn)


def seq_batches(cfg, seed: int) -> dict:
    """{"mm": phase 38's batch (2 x 3328 rows, six tiles), "pack": phase 35's
    4096-row pack of five documents}, on the CPU."""
    return {"mm": parallel_batch(cfg, seed), "pack": {k: v.cpu() for k, v in packed_batch(cfg, seed).items()}}


def seq_reference(cfg, batches: dict, seed: int, trainable=_seq_trainable, steps: int = PARALLEL_STEPS) -> dict:
    """World 1: ``steps`` ``train_step``s per batch and route from the
    seeded weights (``trainable``: phase 41 freezes the embedding, lm_head
    and trunk MLP): {batch: {route: {"losses", "norms", "step_ms",
    "peak_gib"}}}."""
    import torch

    from omchat_torch.training import train_step as ts

    out = {}
    for key, batch in batches.items():
        local = _on_card(batch)
        for route in ("plain", "vjp"):
            opt = ts.AdamW(PARALLEL_LR, grad_clip=1.0)
            state = ts.init_train_state(build_model(cfg, seed), opt, trainable)
            norms = []
            torch.cuda.reset_peak_memory_stats()
            with recording_norms(norms, sharded=False):
                losses, ms = _timed_steps(lambda: ts.train_step(state, cfg, local, opt, attn_impl=route)[1], steps)
            out.setdefault(key, {})[route] = {"losses": losses, "norms": norms, "step_ms": ms,
                                              "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            del state, opt
            gc.collect()
            torch.cuda.empty_cache()
    return out


def seq_launch_rule(case: str, rank: int, n_v: int, n_t: int, vit: bool) -> dict:
    """K16 launches a kernel-route step makes on ``rank``: the forward twice
    a layer (remat), each backward kernel once.  A trunk layer's calls: the
    ring's visible blocks (rank i sees shards 0..i), one for Ulysses, SP and
    the gathered route, one per run of q heads at tp 3 (two on every rank);
    the ViT's layers one each where the batch has tiles."""
    calls = {"ring": rank + 1, "tp3": 2}.get(case, 1) * n_t + (n_v if vit else 0)
    return {"flash_attention_fwd": 2 * calls, "flash_attention_bwd_dq": calls, "flash_attention_bwd_dkv": calls}


def seq_rank(seed: int, ref: dict, jobs: list) -> dict:
    """Phase 41 in one rank of the world: each job (case, route, fault) from
    the seeded weights, placed by ``make_sharded_train_step``; per job the
    losses and gradient norms and their gaps to world 1, step wall ms, the
    collectives' share, peak GiB, the rank's local heads and its K16
    launches."""
    import torch
    import torch.distributed as dist

    from omchat_torch.parallel import comm
    from omchat_torch.parallel.mesh import create_cp_mesh, create_mesh
    from omchat_torch.parallel.sharding import omchat_param_specs, specs_without_axis
    from omchat_torch.training import train_step as ts
    from omchat_torch.utils.tree import tree_items

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = parallel_cfg()
    batches = seq_batches(cfg, seed)
    meshes = {}
    out = {}
    for case, route, fault in jobs:
        _, kind, n, bkey = SEQ_CASES[case]
        if (kind, n) not in meshes:
            meshes[(kind, n)] = create_cp_mesh(cp=n) if kind == "cp" else create_mesh(tp=n)
        mesh = meshes[(kind, n)]
        params = build_model(cfg, seed)
        specs = omchat_param_specs(cfg, params)
        if kind == "cp":
            specs = specs_without_axis(specs, "model")
        opt = ts.AdamW(PARALLEL_LR, grad_clip=1.0)
        step, shard_batch, place = ts.make_sharded_train_step(
            cfg, mesh, specs, opt, attn_impl=route, sequence_parallel=case == "sp",
            context_parallel=case in ("ring", "ring_pack"), ulysses=case == "ulysses")
        state = ts.init_train_state(place(params), opt, _seq_trainable)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        local = _on_card(shard_batch(batches[bkey]))
        paths = [p for p, t in tree_items(state.params) if t.requires_grad]
        vit = [i for i, p in enumerate(paths) if p[0] == "vision_tower"]
        layers = state.params["language_model"]["layers"]["self_attn"]
        heads = {"trunk_q": layers["q_proj"]["kernel"].shape[-1] // 128,
                 "trunk_kv": layers["k_proj"]["kernel"].shape[-1] // 128}
        n_steps = PARALLEL_FAULT_STEPS if fault else PARALLEL_STEPS
        counts = train_counters()
        for c in counts.values():
            c.launches = 0
        comm.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        norms = []
        with seq_fault(fault, vit), recording_norms(norms, sharded=True), comm.timing():
            losses, ms = _timed_steps(lambda: step(state, cfg, local)[1], n_steps)
        want = ref[bkey][route]
        res = {"losses": losses, "norms": norms, "step_ms": ms, "collective_s": dict(comm.SECONDS),
               "collectives": dict(comm.CALLS), "collective_share": sum(comm.SECONDS.values()) / (sum(ms) / 1e3),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "heads": heads,
               "rows": int(local["token_ids"].shape[1]), "launches": {n: c.launches for n, c in counts.items()},
               "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, want["losses"])),
               "norm_gap": max(abs(a - b) / abs(b) for a, b in zip(norms, want["norms"]))}
        out[f"{case}/{route}" + (f"/{fault}" if fault else "")] = res
        log(f"seq parallel rank {dist.get_rank()} [{case} {route}{' + ' + fault if fault else ''}]: "
            + json.dumps({k: res[k] for k in ("heads", "rows", "launches", "losses", "norms", "loss_gap", "norm_gap",
                                              "step_ms", "collective_share", "peak_gib")}))
        del state, opt, step, local
        gc.collect()
        torch.cuda.empty_cache()
    return out


def seq_parallel_training(seed: int, gen=None) -> dict:
    """Phase 41: the trainer's sequence modes (ring cp 2, Ulysses P 2,
    Megatron SP at tp 2, the ring over a packed batch on the gathered route)
    on two ranks and Qwen2-7B's trunk at tp 3 on three, sharing the card
    over gloo, each against the single-device ``train_step`` on the same
    weights and batch; then K16 timed at the shapes the modes hand it."""
    import torch

    from omchat_torch.parallel.launch import run_ranks

    cfg = parallel_cfg()
    batches = seq_batches(cfg, seed)
    n_t, n_v = cfg.text.num_hidden_layers, cfg.vision.num_hidden_layers
    log(f"seq parallel training: full width, {n_v} ViT + {n_t} trunk layers, B=2 x "
        f"{batches['mm']['token_ids'].shape[1]} rows and a {batches['pack']['token_ids'].shape[1]}-row pack, the "
        "embedding, lm_head and trunk MLP frozen; ranks share one card over gloo, so the times show the collectives' "
        "overhead, not scaling")
    t0 = time.perf_counter()
    ref = seq_reference(cfg, batches, seed)
    log(f"seq parallel training, world 1 ({time.perf_counter() - t0:.1f} s): " + json.dumps(
        {b: {r: {k: v[k] for k in ("losses", "norms", "step_ms", "peak_gib")} for r, v in rv.items()}
         for b, rv in ref.items()}))
    gc.collect()
    torch.cuda.empty_cache()
    ref_args = {b: {r: {"losses": v["losses"], "norms": v["norms"]} for r, v in rv.items()} for b, rv in ref.items()}
    ranks = {}
    for world in (2, 3):
        jobs = [(case, route, None) for case, (w, *_) in SEQ_CASES.items() if w == world for route in ("plain", "vjp")]
        jobs += [(case, "vjp", fault) for case, fault in SEQ_FAULTS if SEQ_CASES[case][0] == world]
        t0 = time.perf_counter()
        for r, res in enumerate(run_ranks(seq_rank, world, seed, ref_args, jobs, timeout=600)):
            ranks.setdefault(r, {}).update(res)
        log(f"seq parallel training: the world of {world} ran {len(jobs)} jobs in {time.perf_counter() - t0:.1f} s")
    failed = []
    summary = {"card": CARD}
    for case, (world, _, _, bkey) in SEQ_CASES.items():
        plain, kern = ranks[0][f"{case}/plain"], ranks[0][f"{case}/vjp"]
        bar = {"loss_gap": SEQ_BAR * max(plain["loss_gap"], SEQ_LOSS_FLOOR),
               "norm_gap": SEQ_BAR * max(plain["norm_gap"], SEQ_NORM_FLOOR)}
        row = {"bar": bar, "plain": {k: plain[k] for k in bar}, "kernel": {k: kern[k] for k in bar},
               "step_ms": [ranks[r][f"{case}/vjp"]["step_ms"] for r in range(world)],
               "world1_step_ms": ref[bkey]["vjp"]["step_ms"],
               "collective_share": [ranks[r][f"{case}/vjp"]["collective_share"] for r in range(world)],
               "peak_gib": [ranks[r][f"{case}/vjp"]["peak_gib"] for r in range(world)],
               "heads": [ranks[r][f"{case}/vjp"]["heads"] for r in range(world)],
               "launches": [ranks[r][f"{case}/vjp"]["launches"] for r in range(world)], "faults": {}}
        if any(kern[k] > bar[k] for k in bar):
            failed.append(f"{case}: the kernel route's gaps {row['kernel']} past the bar {bar}")
        for r in range(world):
            for key, job in ranks[r].items():
                if not key.startswith(f"{case}/"):
                    continue
                per_step = seq_launch_rule(case, r, n_v, n_t, bkey == "mm")
                expect = ({n: k * len(job["losses"]) for n, k in per_step.items()} if "/vjp" in key
                          else {n: 0 for n in per_step})
                if job["launches"] != expect:
                    failed.append(f"{key} rank {r}: K16 launches {job['launches']}, expected {expect}")
        for fcase, fault in SEQ_FAULTS:
            if fcase != case:
                continue
            job = ranks[0][f"{case}/vjp/{fault}"]
            row["faults"][fault] = {k: job[k] for k in bar}
            if not any(job[k] > bar[k] for k in bar):
                failed.append(f"{case}: the bar would pass a step with {fault} ({row['faults'][fault]})")
        summary[case] = row
        log(f"seq parallel training, {case} (phase 41, this call): " + json.dumps({"card": CARD, **row}))
    heads = summary["tp3"]["heads"]
    if [h["trunk_q"] for h in heads] != [10, 9, 9] or [h["trunk_kv"] for h in heads] != [4, 4, 4]:
        failed.append(f"tp3: local heads {heads}, expected 10 / 9 / 9 q heads over all 4 kv heads")
    if gen is not None:
        gc.collect()
        torch.cuda.empty_cache()
        train_kernel_phases(gen, SEQ_KERNEL_SHAPES, row_case=None)
    if failed:
        raise AssertionError("phase 41 failed: " + " | ".join(failed))
    return summary


# ---------------------------------------------------------------------------
# Phase 42: GPipe pipeline training
# ---------------------------------------------------------------------------

# phase 41's setup at 2 ViT + 4 trunk layers, two a stage at pp 2 (each rank builds the whole tree before
# it takes its stage, so the trunk is cut as phases 38-41 cut it): B = 2 rows in PP_MICRO microbatches
# of one row, lr 1e-5, PP_STEPS steps, the embedding and the trunk's MLP frozen (the two ranks and
# the main process share the card's 80 GB); two ranks share the card over gloo.  lm_head trains: under
# the pipeline no collective moves its gradient, and with it frozen the head's only leaf would be the
# final norm's scale, 1.2e-5 of the squared global norm (H100 probe), too small for the bar to see the
# head's gradients summed over the stages.  The bar is phase 41's (SEQ_BAR x the plain route's gaps to
# world 1, each at least its floor)
PP_LAYERS, PP_STAGES, PP_MICRO, PP_STEPS = (2, 4), 2, 2, 3
PP_FAULTS = ("the handoff's backward giving zeros", "the final norm's and lm_head's gradients summed over the stages",
             "the ViT's, projector's and embedding's gradients left on stage 0")


def pp_cfg():
    from omchat_torch.config import OmChatConfig

    full = OmChatConfig()
    v, t = PP_LAYERS
    return dataclasses.replace(full, vision=dataclasses.replace(full.vision, num_hidden_layers=v),
                               text=dataclasses.replace(full.text, num_hidden_layers=t))


def _pp_trainable(path) -> bool:
    return path[:2] != ("language_model", "embed_tokens") and path[:3] != ("language_model", "layers", "mlp")


def pp_batches(cfg, seed: int) -> dict:
    """{"mm": phase 38's batch (2 x 3328 rows, six tiles), "pack": two rows
    of phase 35's 4096-row pack (SEG_DOCS' documents, seeded ids)}, on the
    CPU."""
    import numpy as np

    from omchat_torch.cli.train import pack_rows

    rows = []
    for i in range(2):
        rng = np.random.default_rng(seed + i)
        rows.append([(rng.integers(10, cfg.text.vocab_size, e - s).tolist(), SEG_TARGET) for s, e in SEG_DOCS])
    return {"mm": parallel_batch(cfg, seed), "pack": pack_rows(rows, PACKED_ROWS)}


@contextlib.contextmanager
def pp_fault(fault):
    """Swap one of phase 42's planted faults into the modules the pipeline
    step reaches."""
    import torch

    from omchat_torch.parallel import comm
    from omchat_torch.training import train_step as ts

    saved = []

    def swap(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    if fault == PP_FAULTS[0]:
        handoff = comm.stage_pass

        def zeros_back(x, mesh, axis, *, take=None, reverse=False):
            out = handoff(x, mesh, axis, take=take, reverse=reverse)
            return torch.zeros_like(out) if reverse and out is not None else out

        swap(comm, "stage_pass", zeros_back)
    elif fault == PP_FAULTS[1]:
        sync = ts._sync_stage_gradients

        def summed(grads, paths, mesh):
            sync(grads, paths, mesh)
            for g, path in zip(grads, paths):
                if ts._head_path(path):
                    comm.all_reduce_(g, comm._group(mesh, "stage"))

        swap(ts, "_sync_stage_gradients", summed)
    elif fault == PP_FAULTS[2]:
        swap(ts, "_sync_stage_gradients", lambda grads, paths, mesh: None)
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def pp_recording(norms: list, groups: list):
    """Each step's global gradient norm (the pipeline step's, whatever norm
    and sync are in place) appended to ``norms``, and each step's squared
    gradient norm by group of leaves on this rank after the sync to
    ``groups``."""
    from omchat_torch.training import train_step as ts

    make, sync = ts._global_norm, ts._sync_stage_gradients

    def recording(specs, mesh):
        fn = make(specs, mesh)

        def norm(grads):
            value = fn(grads)
            norms.append(float(value))
            return value

        return norm

    def by_group(grads, paths, mesh):
        sync(grads, paths, mesh)
        sq = {}
        for g, path in zip(grads, paths):
            key = path[0] if path[0] != "language_model" else ".".join(path[:2])
            sq[key] = sq.get(key, 0.0) + float(g.float().square().sum())
        groups.append(sq)

    ts._global_norm, ts._sync_stage_gradients = recording, by_group
    try:
        yield
    finally:
        ts._global_norm, ts._sync_stage_gradients = make, sync


def pp_launch_rule(rank: int, n_v: int, n_t: int, vit: bool) -> dict:
    """K16 launches a kernel-route pipeline step makes on ``rank``: each of
    the stage's layers once a microbatch (the forward twice: remat), and on
    stage 0 each ViT layer once over all the tiles where the batch has
    them."""
    calls = n_t // PP_STAGES * PP_MICRO + (n_v if vit and rank == 0 else 0)
    return {"flash_attention_fwd": 2 * calls, "flash_attention_bwd_dq": calls, "flash_attention_bwd_dkv": calls}


def _replica_checksum(params) -> int:
    """A checksum of the bits of the replicated trainable leaves (equal
    bits, equal sums; the stages' replicas must agree)."""
    import torch

    from omchat_torch.utils.tree import tree_items

    return sum(int(t.detach().view(torch.int16).to(torch.int64).sum()) for p, t in tree_items(params)
               if t.requires_grad and p[:2] != ("language_model", "layers"))


def pp_rank(seed: int, ref: dict, jobs: list) -> dict:
    """Phase 42 in one rank of the world: each job (batch, route, fault)
    from the seeded weights, this rank's stage placed by
    ``make_pp_train_step``; per job the losses and gradient norms and their
    gaps to world 1, step wall ms, the handoff's and the broadcasts' share
    of the steps, peak GiB, K16 launches, the replicas' checksum and the
    squared gradient norm by group of leaves."""
    import torch
    import torch.distributed as dist

    from omchat_torch.parallel import comm
    from omchat_torch.parallel.mesh import create_pp_mesh
    from omchat_torch.training import train_step as ts

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = pp_cfg()
    batches = pp_batches(cfg, seed)
    mesh = create_pp_mesh(PP_STAGES)
    out = {}
    for case, route, fault in jobs:
        params = build_model(cfg, seed)
        opt = ts.AdamW(PARALLEL_LR, grad_clip=1.0)
        step, shard_batch, place = ts.make_pp_train_step(cfg, mesh, opt, microbatches=PP_MICRO, attn_impl=route)
        state = ts.init_train_state(place(params), opt, _pp_trainable)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        local = _on_card(shard_batch(batches[case]))
        n_steps = PARALLEL_FAULT_STEPS if fault else PP_STEPS
        counts = train_counters()
        for c in counts.values():
            c.launches = 0
        comm.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        norms, groups = [], []
        with pp_fault(fault), pp_recording(norms, groups), comm.timing():
            losses, ms = _timed_steps(lambda: step(state, cfg, local)[1], n_steps)
        want = ref[case][route]
        total_s = sum(ms) / 1e3
        res = {"losses": losses, "norms": norms, "step_ms": ms, "collective_s": dict(comm.SECONDS),
               "collectives": dict(comm.CALLS),
               "handoff_share": comm.SECONDS["stage_pass"] / total_s,
               "broadcast_share": comm.SECONDS["stage_broadcast"] / total_s,
               "collective_share": sum(comm.SECONDS.values()) / total_s,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": {n: c.launches for n, c in counts.items()}, "grad_sq_by_group": groups[0],
               "replica_checksum": _replica_checksum(state.params),
               "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, want["losses"])),
               "norm_gap": max(abs(a - b) / abs(b) for a, b in zip(norms, want["norms"]))}
        out[f"{case}/{route}" + (f"/{fault}" if fault else "")] = res
        log(f"pipeline training rank {dist.get_rank()} [{case} {route}{' + ' + fault if fault else ''}]: "
            + json.dumps({k: res[k] for k in ("launches", "losses", "norms", "loss_gap", "norm_gap", "step_ms",
                                              "handoff_share", "broadcast_share", "collective_share", "peak_gib",
                                              "grad_sq_by_group")}))
        del state, opt, step, local
        gc.collect()
        torch.cuda.empty_cache()
    return out


def pipeline_training(seed: int, gen=None) -> dict:
    """Phase 42: ``make_pp_train_step`` at pp 2 on two ranks sharing the
    card over gloo, at full width and 2 ViT + 4 trunk layers, on phase 38's
    multimodal batch and a packed batch (segment ids in ``static``), each
    on the kernel and the plain route against the single-device
    ``train_step`` on the same weights and batch; three planted faults; then
    K16 checked at a microbatch's shape."""
    import torch

    from omchat_torch.parallel.launch import run_ranks

    cfg = pp_cfg()
    batches = pp_batches(cfg, seed)
    n_t, n_v = cfg.text.num_hidden_layers, cfg.vision.num_hidden_layers
    log(f"pipeline training: full width, {n_v} ViT + {n_t} trunk layers at pp {PP_STAGES} ({n_t // PP_STAGES} a "
        f"stage), {PP_MICRO} microbatches of B=2 x {batches['mm']['token_ids'].shape[1]} rows and of a 2 x "
        f"{batches['pack']['token_ids'].shape[1]}-row pack, the embedding and trunk MLP frozen; ranks share one card "
        "over gloo, so the times show the handoffs' overhead, not scaling")
    t0 = time.perf_counter()
    ref = seq_reference(cfg, batches, seed, _pp_trainable, PP_STEPS)
    log(f"pipeline training, world 1 ({time.perf_counter() - t0:.1f} s): " + json.dumps(
        {b: {r: {k: v[k] for k in ("losses", "norms", "step_ms", "peak_gib")} for r, v in rv.items()}
         for b, rv in ref.items()}))
    gc.collect()
    torch.cuda.empty_cache()
    ref_args = {b: {r: {"losses": v["losses"], "norms": v["norms"]} for r, v in rv.items()} for b, rv in ref.items()}
    jobs = [(case, route, None) for case in batches for route in ("plain", "vjp")]
    jobs += [("mm", "vjp", fault) for fault in PP_FAULTS]
    t0 = time.perf_counter()
    ranks = run_ranks(pp_rank, PP_STAGES, seed, ref_args, jobs, timeout=600)
    log(f"pipeline training: the world of {PP_STAGES} ran {len(jobs)} jobs in {time.perf_counter() - t0:.1f} s")
    failed = []
    summary = {"card": CARD}
    for case in batches:
        plain, kern = ranks[0][f"{case}/plain"], ranks[0][f"{case}/vjp"]
        bar = {"loss_gap": SEQ_BAR * max(plain["loss_gap"], SEQ_LOSS_FLOOR),
               "norm_gap": SEQ_BAR * max(plain["norm_gap"], SEQ_NORM_FLOOR)}
        rows = [r[f"{case}/vjp"] for r in ranks]
        row = {"bar": bar, "plain": {k: plain[k] for k in bar}, "kernel": {k: kern[k] for k in bar},
               "step_ms_steps_2_3": [r["step_ms"][1:] for r in rows], "world1_step_ms": ref[case]["vjp"]["step_ms"],
               "handoff_share": [r["handoff_share"] for r in rows],
               "broadcast_share": [r["broadcast_share"] for r in rows],
               "collective_share": [r["collective_share"] for r in rows],
               "peak_gib": [r["peak_gib"] for r in rows],
               "k16_launches_a_step": [{n: k // len(r["losses"]) for n, k in r["launches"].items()} for r in rows],
               "faults": {}}
        if any(kern[k] > bar[k] for k in bar):
            failed.append(f"{case}: the kernel route's gaps {row['kernel']} past the bar {bar}")
        for route in ("plain", "vjp"):
            sums = {r[f"{case}/{route}"]["replica_checksum"] for r in ranks}
            if len(sums) != 1:
                failed.append(f"{case}/{route}: the stages' replicated leaves differ after the steps")
        for r, res in enumerate(ranks):
            for key, job in res.items():
                if not key.startswith(f"{case}/"):
                    continue
                per_step = pp_launch_rule(r, n_v, n_t, case == "mm")
                expect = ({n: k * len(job["losses"]) for n, k in per_step.items()} if "/vjp" in key
                          else {n: 0 for n in per_step})
                if job["launches"] != expect:
                    failed.append(f"{key} rank {r}: K16 launches {job['launches']}, expected {expect}")
        for fault in PP_FAULTS:
            if case != "mm":
                continue
            job = ranks[0][f"mm/vjp/{fault}"]
            row["faults"][fault] = {k: job[k] for k in bar}
            if not any(job[k] > bar[k] for k in bar):
                failed.append(f"{case}: the bar would pass a step with {fault} ({row['faults'][fault]})")
        summary[case] = row
    log("pipeline training (phase 42, this call): " + json.dumps(summary))
    if gen is not None:
        gc.collect()
        torch.cuda.empty_cache()
        train_kernel_phases(gen, {"pipeline microbatch": (1, batches["mm"]["token_ids"].shape[1], 28, 4, True)},
                            row_case=None)
    if failed:
        raise AssertionError("phase 42 failed: " + " | ".join(failed))
    return summary


# ---------------------------------------------------------------------------
# Phase 43: head width 64 — a Qwen2-0.5B-width trunk behind InternViT-300M
# ---------------------------------------------------------------------------

# Qwen/Qwen2-0.5B's config.json (vocab 151936, hidden 896, intermediate 4864, 24
# layers, 14 / 2 heads of 64, rope theta 1e6, qkv bias, tied embeddings) behind
# InternViT-300M/448 (``VisionConfig.internvit_300m()``: 24 layers of 16 heads of
# 64, layer norm, no qk-norm) and a 1024 -> 896 mlp2x_gelu projector: InternVL2-1B's
# geometry.  Random bf16 weights from the seed, full width and depth; the 2 + 2
# layer checks cut the depth alone.
QWEN2_05B_TEXT = dict(vocab_size=151936, hidden_size=896, intermediate_size=4864, num_hidden_layers=24,
                      num_attention_heads=14, num_key_value_heads=2, max_position_embeddings=32768, rms_norm_eps=1e-6,
                      rope_theta=1000000.0, attention_bias=True, tie_word_embeddings=True)
HW_TAG = "[D=64]"
HW_SLOT_REQUESTS = 4
HW_CHATS = 3  # timed chats a cache dtype; the median by TTFT is reported (one chat's TTFT read 97 and 255 ms)
# the other head widths phase 43 holds the kernels at, at phase 2's lengths, with
# their cache dtypes (e4m3 takes multiples of 16 only)
HW_WIDTHS = {64: ("bf16", "e4m3"), 72: ("bf16",), 16: ("bf16", "e4m3")}


def head64_model(seed: int, layers=None) -> tuple:
    """(cfg, params) of phase 43's model; ``layers``: that many ViT and LLM
    layers, every part seeded."""
    from omchat_torch.config import OmChatConfig, TextConfig, VisionConfig

    vision, text = VisionConfig.internvit_300m(), TextConfig(**QWEN2_05B_TEXT)
    if layers is not None:
        vision = dataclasses.replace(vision, num_hidden_layers=layers)
        text = dataclasses.replace(text, num_hidden_layers=layers)
    cfg = OmChatConfig(vision=vision, text=text)
    return cfg, build_model(cfg, seed + 43)


def width_fault_model(q, k, v, valid, scale_width: int, read_cols: int, prescale: bool, p_dtype):
    """Attention of q [B, S, H, D] over k, v [B, KVH, T, D] at the columns
    where ``valid`` [B, S, T], in the kernels' arithmetic (fp32 scores in the
    exp2 domain, p rounded to ``p_dtype`` for the P V product, a row with no
    column zeros), with the two knobs of phase 43's planted faults: the
    softmax scale of a head ``scale_width`` wide, and q and k read
    ``read_cols`` columns from each row's first, the columns past D being the
    ones that follow in memory (the next head's, the next row's), as a kernel
    built for a wider head reads them.  (D, D) is the kernels' function;
    ``prescale``: q carries the scale in its own dtype (K2, K14's wrappers)."""
    import torch

    from omchat_torch.ops.flash_attention import LOG2E
    from omchat_torch.ops.fp8 import cast_to

    B, S, H, D = q.shape
    KVH = k.shape[1]

    def widen(t):
        flat = t.to(torch.bfloat16).reshape(-1, D)
        ext = torch.cat([flat.roll(-i, 0) for i in range(-(-read_cols // D))], dim=1)[:, :read_cols]
        return ext.reshape(*t.shape[:-1], read_cols)

    scale = scale_width ** -0.5 * LOG2E
    qw = widen(q)
    if prescale:
        qw, scale = qw * torch.full((), scale, dtype=q.dtype, device=q.device), 1.0
    s = torch.einsum("bsngd,bntd->bngst", qw.float().view(B, S, KVH, H // KVH, read_cols), widen(k).float()) * scale
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bngst,bntd->bngsd", cast_to(p, p_dtype).float(), v.to(torch.bfloat16).float())
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def width_checks(gen, tc, shapes: dict, D: int, cache: str) -> dict:
    """Phase 43 at head width D on a ``cache`` ("bf16" or "e4m3") cache, at
    phase 2's lengths and ``tc``'s heads, with phases 2 and 6's planted keys:
    K3 (the stacked cache, the self column), K6 (its layer as a per-layer
    cache holding the token), K12 and K13 (its rows as shuffled pages of
    128), K14 (the prompt's last chunk through those pages) and, on e4m3, K2
    (the prompt against the cache), each against its plain version at its
    limit; the fault model (``width_fault_model``) at (D, D) within that
    limit, and its two planted faults (the scale of a 128-wide head; q and
    k read past column D) outside it; K12 bitwise K13.  Returns each check's
    max |err| and the faults' max deviations."""
    import torch

    from omchat_torch.ops import decode_attention as da
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import paged_attention as pa
    from omchat_torch.ops.fp8 import E4M3, to_e4m3

    dev, bf = torch.device(DEVICE), torch.bfloat16
    i32 = dict(dtype=torch.int32, device=dev)
    H, KVH, PS = tc.num_attention_heads, tc.num_key_value_heads, SERVING["page_size"]
    G = H // KVH
    T, LEN, KVL, S2 = shapes["cache_rows"], shapes["decode_lens"][0], shapes["prompt_len"], shapes["prompt_rows"]
    W = T // PS
    store = to_e4m3 if cache == "e4m3" else (lambda t: t)
    u = _direction(gen, KVH, D)
    uq = u.repeat_interleave(G, dim=0)
    _, srows, edge = split_edge(1, KVH, T, LEN)
    kc, vc = _randn(gen, 2, 1, KVH, T, D), _randn(gen, 2, 1, KVH, T, D)
    for row, w in ((0, 0.6), (edge - 1, 0.8), (edge, 0.8), (LEN - 1, 0.8), (LEN, 0.8), (KVL - 1, 0.8)):
        kc[:, 0, :, row] = w * u
    # layer 1's rows as W pages of PS, stored in a shuffled order behind a table (K12, K13, K14)
    perm = torch.randperm(W, generator=torch.Generator().manual_seed(D)).to(dev)
    pages_k, pages_v = (store(c[1, 0].view(KVH, W, PS, D).transpose(0, 1)[perm].contiguous()) for c in (kc, vc))
    table = torch.argsort(perm).to(torch.int32)[None]
    kc, vc = store(kc), store(vc)
    q1 = _randn(gen, 1, 1, H, D) + uq
    kn, vn = (0.8 * u)[None], _randn(gen, 1, KVH, D)
    res, tag = {}, f"[D={D}, {cache} cache]"

    def held(name, out, ref, tol, model, rows=None):
        """out against ref; model(scale_width, read_cols) at (D, D) too, and its two faults outside."""
        cut = (lambda t: t) if rows is None else (lambda t: t[:, :rows])
        err = check_close(f"{name}{tag}", cut(out), cut(ref), *tol)
        check_close(f"{name}{tag}: the fault model at (D, D) is the plain version", cut(model(D, D)), cut(ref), *tol)
        res[name] = {"max_abs_err": err, "faults": {
            "scale of D=128": check_fault_caught(f"{name}{tag}", "the scale of a 128-wide head", cut(model(128, D)),
                                                 cut(ref), *tol),
            "reads past column D": check_fault_caught(f"{name}{tag}", "q and k read past column D",
                                                      cut(model(D, 128)), cut(ref), *tol)}}

    # K3: layer 1 of the stack at the first decode step's length, the self column
    ck = torch.full((1,), LEN, **i32)
    col = torch.arange(T + 1, device=dev)
    valid3 = ((col < LEN) | (col == T))[None, None]
    k3k, k3v = torch.cat([kc[1].to(bf), kn[:, :, None]], 2), torch.cat([vc[1].to(bf), vn[:, :, None]], 2)
    k3 = da.flash_decode_stacked(q1, kc, vc, ck, 1, kn, vn)
    held("K3 flash_decode_stacked", k3, da.flash_decode_stacked_plain(q1, kc, vc, ck, 1, kn, vn), ATTN_TOL["K3"],
         lambda sw, rc: width_fault_model(q1, k3k, k3v, valid3, sw, rc, False, bf))
    # K6: layer 1 as a per-layer cache whose row LEN holds the token (0.8 u), LEN + 1 rows
    c6 = ck + 1
    valid6 = (col[:T] < LEN + 1)[None, None]
    held("K6 flash_decode", da.flash_decode(q1, kc[1], vc[1], c6), da.flash_decode_plain(q1, kc[1], vc[1], c6),
         ATTN_TOL["K3"], lambda sw, rc: width_fault_model(q1, kc[1], vc[1], valid6, sw, rc, False, bf))
    # K12 and K13 over the pages
    outs = {}
    for kernel in ("auto", "manual"):
        fn = pa.DECODE_KERNELS[kernel]
        outs[kernel] = fn(q1, pages_k, pages_v, ck, table, kn, vn)
        held(f"{'K12' if kernel == 'auto' else 'K13'} {fn.__name__}", outs[kernel],
             pa.paged_flash_decode_plain(q1, pages_k, pages_v, ck, table, kn, vn), ATTN_TOL["K12"],
             lambda sw, rc: width_fault_model(q1, k3k, k3v, valid3, sw, rc, False, bf))
    torch.cuda.synchronize()
    if not torch.equal(outs["auto"], outs["manual"]):
        raise AssertionError(f"K12 and K13{tag}: not bitwise equal, max |diff| "
                             f"{float((outs['auto'].float() - outs['manual'].float()).abs().max()):.4g}")
    res["K12 bitwise K13"] = True
    # K14: the prompt's last chunk (page-aligned start, rows past the prompt padding) through the pages
    start = (KVL - 1) // 1024 * 1024
    C = -(-(KVL - start) // 128) * 128
    q14 = _randn(gen, 1, C, H, D) + uq
    qo, kl = torch.full((1,), start, **i32), torch.full((1,), KVL, **i32)
    pos = start + torch.arange(C, device=dev)[:, None]
    valid14 = ((col[None, :T] <= pos) & (col[None, :T] < KVL))[None]
    held("K14 paged_flash_prefill", pa.paged_flash_prefill(q14, pages_k, pages_v, kl, table, qo),
         pa.paged_flash_prefill_plain(q14, pages_k, pages_v, kl, table, qo), ATTN_TOL["K14"],
         lambda sw, rc: width_fault_model(q14, kc[1], vc[1], valid14, sw, rc, True, bf), rows=KVL - start)
    if cache == "e4m3":  # K2: the merged prompt against the cache layer (p rounded to e4m3, as its P V takes it)
        q2 = _randn(gen, 1, S2, H, D) + uq
        zero, kvl = torch.zeros(1, **i32), torch.full((1,), KVL, **i32)
        valid2 = ((col[None, :T] <= torch.arange(S2, device=dev)[:, None]) & (col[None, :T] < KVL))[None]
        held("K2 flash_attention", fa.flash_attention(q2, kc[1], vc[1], causal=True, q_offset=zero, kv_len=kvl,
                                                      kv_format="bntd"),
             fa.flash_attention_plain(q2, kc[1], vc[1], causal=True, q_offset=zero, kv_len=kvl), K2_E4M3_TOL,
             lambda sw, rc: width_fault_model(q2, kc[1], vc[1], valid2, sw, rc, True, E4M3), rows=KVL)
        del q2
    torch.cuda.synchronize()
    log(f"head width {D}, {cache} cache, at phase 2's lengths (T={T} len={LEN} prompt={KVL}, {H} / {KVH} heads): "
        + json.dumps(res))
    del kc, vc, pages_k, pages_v, q14
    torch.cuda.empty_cache()
    return res


def head64_chats(cfg, params, seed: int) -> dict:
    """Phase 43 (1): phase 3's request through ``OmChatModel.chat`` with a
    bf16 and an e4m3 cache (the reference ``generate``, its logits finite,
    then HW_CHATS timed chats through ``surface_run``, streamed, each
    encoding its image anew and giving the reference's tokens; the median by
    TTFT kept), each decode step a graph replay; K2 launched once a ViT and
    an LLM layer, K3 a decode step and layer, K4 a step."""
    import torch

    from omchat_torch.config import GenerationConfig
    from omchat_torch.ops.fp8 import E4M3
    from omchat_torch.runtime.feature_cache import ImageFeatureCache

    image = request_image(seed)
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1)
    L, V = cfg.text.num_hidden_layers, cfg.vision.num_hidden_layers
    out = {}
    for cache, dtype in (("bf16", None), ("e4m3", E4M3)):
        model = surface_model(cfg, params, cache_dtype=dtype)
        ids, tiles, _ = variant_inputs(model, image)
        bad = []

        def finite(step, logits):
            if logits.shape != (1, cfg.text.vocab_size) or not torch.isfinite(logits).all():
                bad.append(step)

        want = model.engine.generate([ids], tiles, gen, logits_callback=finite).token_ids[0]
        label = f"head width 64, chat ({cache} cache)"
        runs = []
        for _ in range(HW_CHATS):  # each chat encodes its image anew
            model.engine.image_cache = ImageFeatureCache(model.engine.image_cache.capacity)
            runs.append(surface_run(model, label, lambda cb: model.chat(REQUEST_QUESTION, image=image, generation=gen,
                                                                        stream_callback=cb), ids, tiles, gen,
                                    want=want))
        r = sorted(runs, key=lambda x: x["ttft_ms"])[HW_CHATS // 2]  # the median chat by TTFT
        r["ttft_ms_runs"] = [x["ttft_ms"] for x in runs]
        steps = NEW_TOKENS - 1
        expect = {"flash_attention": V + L, "flash_decode_stacked": steps * L, "commit_rows": steps}
        failed = [f"logits not finite at steps {bad}"] if bad else []
        failed += [f"{n} launched {x['launches'][n]} times in a chat, not {n_}" for x in runs
                   for n, n_ in expect.items() if x["launches"][n] != n_]
        if not model.engine.graphed() or "capture" in model.engine.spans:
            failed.append("the timed chat's decode steps were not replays of the captured graph")
        if any(x["image_cache_hit"] for x in runs):
            failed.append("a timed chat found its image in the cache")
        if failed:
            raise AssertionError(f"{label}: " + "; ".join(failed))
        out[cache] = r
        del model
        torch.cuda.empty_cache()
    return out


def head64_serving(cfg, params) -> tuple:
    """Phase 43 (2): phase 5's workload through ``PagedBatchEngine`` after
    ``precompile`` on K12 and on K13 over a bf16 and an e4m3 pool
    (``timed_serving``: every request 64 tokens, every page back, every
    counted kernel launched), every roll a replay, K13 giving every request
    K12's tokens on its pool.  Returns (runs, the K12 bf16 run's record)."""
    import torch

    from omchat_torch.ops import paged_attention as pa
    from omchat_torch.ops.fp8 import E4M3
    from omchat_torch.runtime import paged_engine as pe

    work = serving_workload(cfg)
    decode = {"auto": "paged_flash_decode", "manual": "paged_flash_decode_manual"}
    runs, record = {}, None
    for pool in ("bf16", "e4m3"):
        for kernel in ("auto", "manual"):
            label = f"head width 64, serving ({pool} pool, decode_kernel={kernel})"
            eng = pe.PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, decode_kernel=kernel,
                                      cache_dtype=E4M3 if pool == "e4m3" else None, **SERVING)
            t0 = time.perf_counter()
            eng.precompile(variants=(pe.PICK_MODES[0],))
            precompile_s = time.perf_counter() - t0
            counts = {n: c for n, c in paged_counters().items()
                      if n not in ("paged_flash_decode", "packed_qkv_norm_attention", "qk_norm_prepass")}
            counts[decode[kernel]] = pa.DECODE_KERNELS[kernel]
            rec, undo = record_dispatches(eng)
            try:
                res = timed_serving(eng, work, rec, counts, label)
            finally:
                undo()
            res["precompile_s"] = precompile_s
            if res["rolls_eager"] or not res["rolls_graphed"]:
                raise AssertionError(f"{label}: rolls graphed {res['rolls_graphed']}, eager {res['rolls_eager']}")
            if kernel == "manual" and res["tokens"] != runs[(pool, "auto")]["tokens"]:
                raise AssertionError(f"{label}: the tokens leave the {pool}-pool K12 run's "
                                     f"({first_divergence(res['tokens'], runs[(pool, 'auto')]['tokens'])})")
            if (pool, kernel) == ("bf16", "auto"):
                record = {k: [e for e in rec[k] if e["label"] == "timed"] for k in ("rolls", "chunks", "commits",
                                                                                     "prefills")}
            runs[(pool, kernel)] = res
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    log("head width 64, serving by pool and decode kernel: " + json.dumps({
        f"{pool}/{kernel}": {k: r[k] for k in ("tokens_per_s", "ttft_p50_s", "ttft_p99_s", "intertoken_p50_s",
                                               "intertoken_p99_s", "decode_step_wall_ms_16_slots", "pages_free",
                                               "rolls_graphed", "precompile_s")}
        for (pool, kernel), r in runs.items()} | {"card": CARD}))
    return runs, record


def head64_small(seed: int) -> dict:
    """Phase 43 at full width and 2 + 2 layers: phase 3's request through
    the single-request engine on the kernels against ``attn_impl="plain"``,
    and phase 7's four requests through the paged engine (K12, K14) against
    the plain single-request engine, each by phase 7's rule."""
    import torch

    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.generate import OmChatEngine
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    cfg, params = head64_model(seed, layers=2)
    ids, tiles = make_request(cfg, seed)
    gen = GenerationConfig(max_new_tokens=PARITY_NEW_TOKENS, eos_token_id=-1)
    plain = OmChatEngine(cfg, params, attn_impl="plain", image_cache_size=0, device=DEVICE)
    kern = OmChatEngine(cfg, params, image_cache_size=0, device=DEVICE)
    steps = []
    toks = kern.generate([ids], tiles, gen, logits_callback=lambda s, lg: steps.append(lg[0].float())).token_ids[0]
    res = {"single": parity_by_phase7("head width 64, 2+2 layers, single request (K2, K3) vs plain", [toks],
                                      [steps[0]], plain, [(ids, tiles)], [gen])}
    work = serving_workload(cfg)[:4]
    eng = PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, **SERVING)
    first = capture_first_logits(eng)
    rids = drive(eng, work, PARITY_NEW_TOKENS)
    res["paged"] = parity_by_phase7("head width 64, 2+2 layers, paged (K12, K14) vs plain single request",
                                    [eng.result(r) for r in rids], [first[r][0] for r in rids], plain, work,
                                    [gen] * len(work))
    log("head width 64, 2+2 layers, kernels vs plain by phase 7's rule: " + json.dumps({"card": CARD, **res}))
    del plain, kern, eng, params
    torch.cuda.empty_cache()
    return res


def head_width_64(gen, seed: int, shapes: dict) -> tuple:
    """Phase 43: the Qwen2-0.5B-width trunk (head width 64, group 7) behind
    InternViT-300M at full width and depth: (1) phase 3's request through
    ``OmChatModel.chat`` on a bf16 and an e4m3 cache, (2) phase 5's workload
    through the paged engine on K12 and K13 over both pools, (3)
    HW_SLOT_REQUESTS of its requests through the slot engine, (4) phase 23's
    decode step through ``cache_attend`` (K6); then K2-K4, K12 / K14 / K15,
    the fp8 phase's kernels and K6 at D = 64 at the shapes these runs handed
    them, timed beside their library calls; the kernels at D = 64, 72 and 16
    at phase 2's lengths with the width faults (``width_checks``); the 2 + 2
    layer checks.  Returns (kernel rows, the rows' launches, the model's (cfg,
    params), which phase 44 trains)."""
    import torch

    from omchat_torch.utils.tree import tree_items

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = head64_model(seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_items(params))
    log("head width 64: built " + json.dumps({"card": CARD, "build_s": time.perf_counter() - t0, "params": n_params,
                                              "allocated_gib": torch.cuda.memory_allocated() / 2**30,
                                              "text": QWEN2_05B_TEXT, "vision": "InternViT-300M/448"}))
    chats = head64_chats(cfg, params, seed)
    if (chats["bf16"]["tiles"], chats["bf16"]["merged_len"], chats["bf16"]["cache_rows"]) != (
            shapes["tiles"], shapes["prompt_len"], shapes["cache_rows"]):
        raise AssertionError(f"head width 64: the request's shapes differ from phase 2's: {shapes}")
    runs, timed = head64_serving(cfg, params)
    no_k1 = {n: c for n, c in counters().items() if n not in ("packed_qkv_norm_attention", "qk_norm_prepass")}
    slot, slot_eng, _ = slot_timed_run(cfg, params, serving_workload(cfg)[:HW_SLOT_REQUESTS],
                                       "head width 64, slot engine", counted=no_k1)
    log(f"head width 64, slot engine ({HW_SLOT_REQUESTS} of phase 5's requests): " + json.dumps(
        {k: v for k, v in slot.items() if k != "tokens"}))
    del slot_eng
    k6, k6_row = decode_layer_cache(gen, cfg, params, seed)
    peak = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    rows = kernel_phases(gen, shapes, cfg=cfg, tag=HW_TAG)
    rows += paged_kernel_phases(gen, timed, tc=cfg.text, tag=HW_TAG)
    rows += fp8_kernel_phases(gen, shapes, timed, tc=cfg.text, tag=HW_TAG)
    k6_row["name"] += HW_TAG
    rows.append(k6_row)
    widths = {f"D={D}, {c}": width_checks(gen, cfg.text, shapes, D, c) for D, cs in HW_WIDTHS.items() for c in cs}
    small = head64_small(seed)
    chat, e4 = chats["bf16"]["launches"], chats["e4m3"]["launches"]
    by_run = {("bf16", "auto"): ("paged_flash_decode", "paged_flash_prefill", "commit_pages"),
              ("bf16", "manual"): ("paged_flash_decode_manual",), ("e4m3", "auto"): (
                  "paged_flash_decode", "paged_flash_prefill", "commit_pages"),
              ("e4m3", "manual"): ("paged_flash_decode_manual",)}
    launches = {f"{n}{HW_TAG}": chat[n] for n in ("flash_attention", "flash_decode_stacked", "commit_rows")}
    launches |= {f"{n}[e4m3]{HW_TAG}": e4[n] for n in ("flash_decode_stacked", "commit_rows")}
    # the e4m3 chat's K2 launches over the e4m3 cache: the prefill's, one a trunk layer (the ViT's are bf16)
    launches[f"flash_attention[e4m3]{HW_TAG}"] = e4["flash_attention"] - cfg.vision.num_hidden_layers
    for (pool, kernel), names in by_run.items():
        suffix = "[e4m3]" if pool == "e4m3" else ""
        launches |= {f"{n}{suffix}{HW_TAG}": runs[(pool, kernel)]["launches"][n] for n in names}
    launches[k6_row["name"]] = k6["flash_decode_launches"]
    summary = {"card": CARD, "peak_gib": peak, "ttft_ms": chats["bf16"]["ttft_ms"],
               "decode_tokens_per_s": chats["bf16"]["decode_tokens_per_s"],
               "ttft_ms_runs": chats["bf16"]["ttft_ms_runs"],
               "e4m3_cache": {k: chats["e4m3"][k] for k in ("ttft_ms", "ttft_ms_runs", "decode_tokens_per_s",
                                                            "peak_mem_gib")},
               "serving_tokens_per_s": {f"{p}/{k}": r["tokens_per_s"] for (p, k), r in runs.items()},
               "ttft_p50_s": runs[("bf16", "auto")]["ttft_p50_s"], "ttft_p99_s": runs[("bf16", "auto")]["ttft_p99_s"],
               "slot_tokens_per_s": slot["tokens_per_s"], "launches": launches,
               "widths_checked": list(widths), "small_requests_checked": len(small["paged"]) + 1}
    log("head width 64 (phase 43, this call): " + json.dumps(summary))
    missing = [n for n, c in launches.items() if not c]
    if missing or {r["name"] for r in rows} != set(launches):
        raise AssertionError(f"head width 64: kernels never launched on the path {missing}, or rows without "
                             f"launches {sorted({r['name'] for r in rows} ^ set(launches))}")
    return rows, launches, (cfg, params)


# Phase 44: K16 at head width 64 on phase 43's model, then at these widths at
# phase 13's shapes; stage-2 (every weight) and the packed steps at this lr
HW_TRAIN_WIDTHS = (72, 16)
HW_STAGE2_LR = 1e-4
HW_PACKED_STEPS = 2
HW_CLI_STEPS = 2
# At 2 + 2 layers of this geometry a causal diagonal shifted one column moves
# the loss and every gradient less than the limits (an H100 run read loss 1.5e-5
# and 5.5e-6, gradients 0.015 and 0.016 of max |g|, projector and adapters,
# beside the sound route's 1.3e-5 / 0.012): a row spreads its attention over
# thousands of random keys.  Phase 44 holds that fault where it shows, at the
# kernel: K16a's output at the trunk's shape (``train_kernel_phases``' "causal
# mask shifted by one column", read 3.58 against an atol of 8e-3).
HW_UNSEEN_FAULT = "the causal diagonal shifted one column (K16a)"


def tiny_cli_on_the_card(seed: int) -> dict:
    """Phase 44's last part: ``python -m omchat_torch.cli.train --synthetic
    HW_CLI_STEPS --warmup 0 --batch-size 2`` run in process, no
    ``--model-path``: the tiny model in bf16 on the card, every weight
    training through K16 at head width 16 (2 ViT + 2 trunk layers)."""
    import tempfile

    import torch

    from omchat_torch.cli import train as tcli

    cfg, dtype = tcli.random_model_spec(torch.device(DEVICE))
    counts = train_counters()
    for c in counts.values():
        c.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        tcli.main(["--synthetic", str(HW_CLI_STEPS), "--warmup", "0", "--batch-size", "2", "--output-dir", d])
        with open(os.path.join(d, "metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f if line.strip()]
    launches = {n: c.launches for n, c in counts.items()}
    layers = cfg.text.num_hidden_layers + cfg.vision.num_hidden_layers
    res = {"card": CARD, "seconds": time.perf_counter() - t0, "dtype": str(dtype),
           "head_widths": [cfg.vision.head_dim, cfg.text.attn_head_dim], "losses": losses, "launches": launches}
    log("head width 64, train CLI default (tiny model on the card): " + json.dumps(res))
    if dtype != torch.bfloat16 or len(losses) != HW_CLI_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train CLI on the card: {res}")
    _expect_launches("train CLI", res, {"flash_attention_fwd": 2 * layers, "flash_attention_bwd_dq": layers,
                                        "flash_attention_bwd_dkv": layers}, HW_CLI_STEPS)
    return res


def head64_training(gen, seed: int, model: tuple, phase13_shapes: dict) -> tuple:
    """Phase 44: training at head width 64 on phase 43's model (its weights,
    full width and depth) through ``training/train_step.py`` and
    ``training/lora.py`` on phase 14's batch: stage-1 (the projector alone),
    LoRA rank 16 over the bf16 base, stage-2 (every weight; K16b / K16c
    through the ViT too) and HW_PACKED_STEPS trunk steps on phase 35's
    4096-row pack (K16 in its segment mode), each with its launches held to
    the expected counts and a falling loss; then K16a / b / c at the shapes
    these runs handed them (D 64: the trunk, the ViT, the pack), timed beside
    SDPA, and at HW_TRAIN_WIDTHS at phase 13's shapes, with the width faults;
    phase 16's rule at 2 + 2 layers of the geometry; the train CLI's default
    on the card.  Returns (kernel rows, the rows' launches)."""
    import torch

    from omchat_torch.training import lora as tl
    from omchat_torch.training import train_step as ts
    from omchat_torch.utils.tree import tree_items

    t0 = time.perf_counter()
    cfg, params = model
    batch, packed = training_batch(cfg, seed), packed_batch(cfg, seed)
    n_params = sum(t.numel() for _, t in tree_items(params))
    t_layers, v_layers = cfg.text.num_hidden_layers, cfg.vision.num_hidden_layers
    # stage-2's train state: bf16 weights and gradients, the fp32 AdamW moments
    log("head width 64, training: " + json.dumps({
        "card": CARD, "params": n_params, "train_state_gib_reckoned": n_params * (2 + 2 + 4 + 4) / 2**30,
        "rows": list(batch["token_ids"].shape), "tiles": int(batch["pixel_values"].shape[0]),
        "packed_rows": list(packed["token_ids"].shape), "label_tokens": int((batch["labels"] != -100).sum())}))
    frozen_vit = {"flash_attention_fwd": 2 * t_layers + v_layers, "flash_attention_bwd_dq": t_layers,
                  "flash_attention_bwd_dkv": t_layers}
    every = {"flash_attention_fwd": 2 * (t_layers + v_layers), "flash_attention_bwd_dq": t_layers + v_layers,
             "flash_attention_bwd_dkv": t_layers + v_layers}
    trunk = {"flash_attention_fwd": 2 * t_layers, "flash_attention_bwd_dq": t_layers,
             "flash_attention_bwd_dkv": t_layers}
    res = {}

    def flops(b, vit: bool, trunk_w: bool):
        return tuple(ts.model_flops(cfg, b, vit_backward=vit, trunk_weights_grad=trunk_w, recompute=r)
                     for r in (False, True))

    # 1. stage-1: the projector alone
    before = _leaf_sums(params)
    opt = ts.AdamW(TRAIN_LR, grad_clip=1.0)
    state = ts.init_train_state(params, opt, lambda path: path[0] == "projector")
    res["stage1"] = _run_steps("head width 64, stage-1 (full width and depth)",
                               lambda: ts.train_step(state, cfg, batch, opt)[1], TRAIN_STEPS, batch, cfg,
                               flops(batch, False, False))
    _expect_launches("head width 64, stage-1", res["stage1"], frozen_vit, TRAIN_STEPS)
    _leaves_changed("head width 64, stage-1", before, _leaf_sums(params), ("projector",))
    _loss_falls("head width 64, stage-1", res["stage1"])
    ts.set_trainable(params, lambda path: False)
    del state, opt
    # 2. LoRA rank 16 on q / k / v / o over the bf16 base
    before = _leaf_sums(params)
    lora = tl.init_lora(torch.Generator(device=DEVICE).manual_seed(seed), params, rank=LORA_RANK)
    a0 = _leaf_sums(lora["layers"])
    opt = ts.AdamW(TRAIN_LR, grad_clip=1.0)
    opt_state = opt.init(tl.lora_leaves(lora))
    res["lora"] = _run_steps(f"head width 64, lora rank {LORA_RANK} (full width and depth)",
                             lambda: tl.lora_train_step(lora, opt_state, params, cfg, batch, opt)[2], LORA_STEPS,
                             batch, cfg, flops(batch, False, False))
    _expect_launches("head width 64, lora", res["lora"], frozen_vit, LORA_STEPS)
    if _leaf_sums(params) != before:
        raise AssertionError("head width 64, lora: the frozen base changed")
    if not any(p[-1] == "b" for p, v in _leaf_sums(lora["layers"]).items() if v != a0[p]):
        raise AssertionError("head width 64, lora: no adapter leaf moved")
    _loss_falls("head width 64, lora", res["lora"])
    del lora, opt, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    # 3. stage-2: every weight, full depth
    opt = ts.AdamW(HW_STAGE2_LR, grad_clip=1.0)
    state = ts.init_train_state(params, opt)
    res["stage2"] = _run_steps("head width 64, stage-2, every weight (full width and depth)",
                               lambda: ts.train_step(state, cfg, batch, opt)[1], TRAIN_STEPS, batch, cfg,
                               flops(batch, True, True))
    _expect_launches("head width 64, stage-2", res["stage2"], every, TRAIN_STEPS)
    changed = _leaves_changed("head width 64, stage-2", before, _leaf_sums(params),
                              ("vision_tower", "projector", "language_model"))
    res["stage2"]["changed_leaves"] = f"{len(changed)} of {len(before)}"
    _loss_falls("head width 64, stage-2", res["stage2"])
    ts.set_trainable(params, lambda path: False)
    del state, opt
    gc.collect()
    torch.cuda.empty_cache()
    # 4. the packed steps: the trunk on one 4096-row pack of phase 35's documents
    opt = ts.AdamW(HW_STAGE2_LR, grad_clip=1.0)
    state = ts.init_train_state(params, opt, lambda path: path[0] == "language_model")
    res["packed"] = _run_steps(f"head width 64, packed ({PACKED_ROWS} rows, {len(SEG_DOCS)} documents)",
                               lambda: ts.train_step(state, cfg, packed, opt)[1], HW_PACKED_STEPS, packed, cfg,
                               flops(packed, False, True))
    _expect_launches("head width 64, packed", res["packed"], trunk, HW_PACKED_STEPS)
    _loss_falls("head width 64, packed", res["packed"])
    ts.set_trainable(params, lambda path: False)
    del state, opt, params, model
    gc.collect()
    torch.cuda.empty_cache()
    train_s = time.perf_counter() - t0

    # the kernels at the shapes these runs handed them, then at the other widths
    shapes = train_kernel_shapes(cfg, batch)
    log("head width 64, training kernel shapes (B, S, H, KVH, causal): " + json.dumps(shapes))
    rows = train_kernel_phases(gen, shapes, D=64, tag=HW_TAG, docs=SEG_DOCS)
    for D in HW_TRAIN_WIDTHS:
        train_kernel_phases(gen, phase13_shapes, row_case=None, D=D, tag=f"[D={D}]", timed=False)
    gc.collect()
    torch.cuda.empty_cache()
    cfg2, params2 = head64_model(seed, layers=2)
    small = train_route_gaps(cfg2, params2, training_batch(cfg2, seed), seed,
                             "head width 64, 2 ViT + 2 LLM layers, full width", by_leaf=True,
                             unseen=(HW_UNSEEN_FAULT,))
    del params2
    gc.collect()
    torch.cuda.empty_cache()
    cli = tiny_cli_on_the_card(seed)
    launches = {f"{n}{HW_TAG}": k for n, k in res["stage2"]["launches"].items()}
    log("head width 64, training (phase 44, this call): " + json.dumps({
        "card": CARD, "seconds": time.perf_counter() - t0, "train_s": train_s,
        **{mode: {k: r[k] for k in ("losses", "step_wall_ms_mean_after_first", "trained_tokens_per_s", "mfu",
                                    "peak_mem_gib", "launches")} for mode, r in res.items()},
        "route_gaps_2_2": {what: {"loss_rel": r["loss_rel"], "grad_rel": r["grad_rel"],
                                  "grad_rel_worst_leaf": max(r["grad_rel_by_leaf"].values())}
                           for what, r in small.items()},
        "cli_losses": cli["losses"], "rows_launches": launches}))
    return rows, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights, inputs and image")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "omchat_torch")):
        print(f"chip_smoke: no omchat_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from omchat_torch.ops import kernel_lib

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi failed"
    global CARD
    CARD = card
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    build_s = kernel_lib.build_all()
    log(f"kernel build: {build_s:.1f} s ({len(kernel_lib.SOURCES)} sources, parallel nvcc)")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    shapes = main_path_shapes(args.seed)
    log("main-path shapes: " + json.dumps({k: v for k, v in shapes.items() if k != "decode_lens"})
        + f" decode_lens {shapes['decode_lens'][0]}..{shapes['decode_lens'][-1]}")
    rows = kernel_phases(gen, shapes)
    full = full_model(args.seed)
    e2e = end_to_end(args.seed, model=full)
    if (e2e["tiles"], e2e["merged_len"], e2e["cache_len"]) != (shapes["tiles"], shapes["prompt_len"],
                                                                 shapes["cache_rows"]):
        raise AssertionError(f"e2e: the request's shapes differ from those phase 2 measured: {shapes}")
    k6, k6_row = decode_layer_cache(gen, *full, args.seed)
    from omchat_torch.ops.fp8 import E4M3

    one_dispatch = {"bf16": single_request_graphs(args.seed, full, "bf16"),
                    "e4m3 cache": single_request_graphs(args.seed, full, "e4m3 cache", cache_dtype=E4M3),
                    "serving": serving_graphs(*full)}
    surface = surface_model(*full)
    entry = entry_points(args.seed, surface)
    video_frames = entry.pop("video_frames")
    video_k2 = video_k2_rows(gen, round_up(entry["video"]["merged_len"], 128), entry["video"]["merged_len"])
    options = options_on_the_card(gen, surface, args.seed)
    options["device pipeline"] = device_pipeline_on_the_card(video_frames)
    served = serving_on_the_card(surface, small_surface(surface.config, args.seed), args.seed)
    surface.engine.release_decode_states()
    _, routes_rows, routes_launches = paged_routes_on_the_card(gen, surface, args.seed, served["paged"])
    small = small_surface(surface.config, args.seed)
    slot, slot_rows, slot_launches = slot_engine_on_the_card(gen, surface, small, args.seed)
    eval_on_the_card(surface, small, args.seed)
    del surface, small, video_frames
    surface_rows = surface_kernel_rows(gen, shapes["prompt_len"], entry["video"]["merged_len"])
    tower_rows, tower_launches = towers_on_the_card(gen, args.seed)
    variants_on_the_card(full, args.seed)
    vit6b = full[1]["vision_tower"]
    del full
    moe_rows, moe_launches = moe_on_the_card(gen, vit6b, args.seed, shapes)
    del vit6b
    gc.collect()
    kernel_vs_plain(args.seed)

    serve, timed = serving(args.seed)
    log("serve, paged route over HTTP beside phase 5 in process (this call): " + json.dumps({
        "card": CARD, "http_tokens_per_s": served["paged"]["tokens_per_s"],
        "phase27_in_process_tokens_per_s": served["paged"]["in_process_tokens_per_s"],
        "phase5_in_process_tokens_per_s": serve["tokens_per_s"]}))
    log("slot engine (phase 29) beside the paged engine (phase 5), this call: " + json.dumps({
        "card": CARD, "tokens_per_s": [slot["timed"]["tokens_per_s"], serve["tokens_per_s"]],
        "ttft_p50_s": [slot["timed"]["ttft_p50_s"], serve.get("ttft_p50_s")],
        "ttft_p99_s": [slot["timed"]["ttft_p99_s"], serve.get("ttft_p99_s")],
        "decode_step_wall_ms_16_slots": [slot["timed"]["step_wall_ms_16_slots"],
                                         serve["decode_step_wall_ms_16_slots"]],
        "prefill_ms_slot_chunks_vs_paged_vit_shorts_chunks": [slot["timed"]["chunk_dispatch_ms_sum"],
                                sum(serve["span_ms"][k] for k in ("vit", "shorts", "chunk"))]}))
    paged_rows = paged_kernel_phases(gen, timed)
    paged_parity(args.seed)

    cfg8, params8, _ = quantize_full_model(args.seed)
    shapes8, undo = record_w8a8_launches()
    try:
        e2e8 = end_to_end(args.seed, model=(cfg8, params8), counted={**counters(), **w8a8_counters()},
                          label="w8a8 e2e")
    finally:
        undo()
    log("w8a8 kernel shapes (timed and warm-up runs, launches per shape): "
        + json.dumps({n: {str(k): v for k, v in d.items()} for n, d in shapes8.items()}))
    one_dispatch["w8a8"] = single_request_graphs(args.seed, (cfg8, params8), "w8a8")
    ids, tiles = make_request(cfg8, args.seed)
    spec8 = speculative_w8a8(surface_model(cfg8, params8), ids, tiles, "w8a8",
                             ("rmsnorm_quant", "attn_proj_glue_quant"))
    log("decode as one dispatch, decode tokens/s eager vs graphed (this call): " + json.dumps(
        {k: [r[f"{route}/{api}"]["decode_tokens_per_s"] for route in ("eager", "graphed")
             for api in ("generate", "generate_ondevice")] for k, r in one_dispatch.items() if k != "serving"}))
    bf16_vs_w8a8 = {k: [e2e[k], e2e8[k]] for k in ("ttft_ms", "vit_ms", "prefill_ms", "decode_tokens_per_s",
                                                   "peak_mem_gib")}
    log("bf16 vs w8a8, single request (this call): " + json.dumps(bf16_vs_w8a8))
    w8a8_serving(cfg8, params8)
    calib8 = swiglu_calibrate(cfg8, params8, args.seed)
    del params8
    shapes10, undo = record_w8a8_launches()
    try:
        e2e10 = end_to_end(args.seed, model=(cfg8, calib8),
                           counted={**counters(), **w8a8_counters(), **swiglu_counters()},
                           label="w8a8 e2e (calibrated MLP)")
        w8a8_serving(cfg8, calib8, label="w8a8 serving (calibrated MLP)",
                     must_launch=("rmsnorm_quant", "attn_proj_glue_quant", "dense_prequant_swiglu_quant"))
    finally:
        undo()
    spec10 = speculative_w8a8(surface_model(cfg8, calib8), ids, tiles, "w8a8 (calibrated MLP)",
                              ("rmsnorm_quant", "attn_proj_glue_quant", "dense_prequant_swiglu_quant"))
    del calib8
    shapes8["dense_prequant_swiglu_quant"] = shapes10["dense_prequant_swiglu_quant"]
    log("K7, K8 and K10 shapes (calibrated request and serving runs, timed and warm-up, launches per shape): "
        + json.dumps({n: {str(k): v for k, v in shapes10[n].items()}
                      for n in ("rmsnorm_quant", "add_rmsnorm_quant", "dense_prequant_swiglu_quant")}))
    n_layers = cfg8.text.num_hidden_layers
    if e2e10["launches"]["dense_prequant_swiglu_quant"] != n_layers:
        raise AssertionError(f"w8a8 e2e (calibrated MLP): K10 launched "
                             f"{e2e10['launches']['dense_prequant_swiglu_quant']} times, not {n_layers}")
    log("w8a8 vs w8a8 with the calibrated MLP, single request (this call): " + json.dumps(
        {k: [e2e8[k], e2e10[k]] for k in ("ttft_ms", "prefill_ms", "decode_tokens_per_s", "peak_mem_gib")}))
    w8a8_rows = w8a8_kernel_phases(gen, shapes8, {**spec8["shapes"], "dense_prequant_swiglu_quant":
                                                  spec10["shapes"]["dense_prequant_swiglu_quant"]})
    w8a8_kernel_vs_plain(args.seed)

    from omchat_torch.config import OmChatConfig

    train_shapes = train_kernel_shapes(OmChatConfig(), training_batch(OmChatConfig(), args.seed))
    log("training kernel shapes (B, S, H, KVH, causal): " + json.dumps(train_shapes))
    train_rows = train_kernel_phases(gen, train_shapes)
    trained = training(args.seed)
    log("training (this call): " + json.dumps({k: {m: r[m] for m in ("step_wall_ms_mean_after_first",
                                                                     "trained_tokens_per_s", "peak_mem_gib", "mfu",
                                                                     "hfu", "losses")} for k, r in trained.items()}))
    train_kernel_vs_plain(args.seed)

    fp8_rows = fp8_kernel_phases(gen, shapes, timed)
    fp8 = fp8_serving(args.seed, serve["tokens"])
    fp8_logit_gaps(args.seed)
    fp8_runs = fp8["serving"]
    log("serving by pool and decode kernel (this call): " + json.dumps({
        f"{pool}/{kernel}": {k: r[k] for k in ("tokens_per_s", "ttft_p50_s", "ttft_p99_s", "intertoken_p50_s",
                                               "intertoken_p99_s", "decode_step_wall_ms_16_slots", "pages_free")}
        for (pool, kernel), r in (((("bf16", "auto"), serve),) + tuple(fp8_runs.items()))}))
    log("bf16 vs e4m3 cache, single request (this call): " + json.dumps(
        {k: [e2e[k], fp8["e2e"][k]] for k in ("ttft_ms", "prefill_ms", "decode_tokens_per_s", "peak_mem_gib")}))

    ps_rows = page_size_kernel_phases(gen, timed)
    ps64 = page_size_serving(args.seed, serve["tokens"])
    log("serving by page size (this call): " + json.dumps(
        {ps: {k: r[k] for k in ("tokens_per_s", "ttft_p50_s", "ttft_p99_s", "intertoken_p50_s", "intertoken_p99_s",
                                "decode_step_wall_ms_16_slots", "pages_free")}
         for ps, r in ((128, serve), (64, ps64))}))
    vit5, k5_row = vit_without_qk_norm(gen, args.seed, shapes)
    gc.collect()
    torch.cuda.empty_cache()
    a12_rows, a12_launches = a12_on_the_card(gen, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    parallel_training(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    _, tp_ref, tp2_remainder = serving_tp(args.seed, e2e, serve)
    gc.collect()
    torch.cuda.empty_cache()
    serving_tp_remainder(args.seed, tp2_remainder, tp_ref)
    gc.collect()
    torch.cuda.empty_cache()
    seq_parallel_training(args.seed, gen)
    gc.collect()
    torch.cuda.empty_cache()
    pipeline_training(args.seed, gen)
    gc.collect()
    torch.cuda.empty_cache()
    hw_rows, hw_launches, hw_model = head_width_64(gen, args.seed, shapes)
    t44_rows, t44_launches = head64_training(gen, args.seed, hw_model, train_shapes)
    del hw_model

    # each kernel's launches on its own main path: K1-K4 on the single-image
    # request (phase 3), K12, K14 and K15 in the timed serving run (phase 5),
    # K7, K8, K9 and K11 on the w8a8 single-image request (phase 9), K16a/b/c
    # in the three stage-1 steps (phase 14); the e4m3 variants of K2, K3 and K4
    # on the e4m3-cache request, K13 in the manual-decode serving runs, the
    # e4m3 variants of K12, K14 and K15 in the e4m3 serving run on K12 (phase 18)
    paged = ("paged_flash_decode", "paged_flash_prefill", "commit_pages")
    launches = {**e2e["launches"], **{n: serve["launches"][n] for n in paged},
                **{n: e2e8["launches"][n] for n in w8a8_counters()},
                **trained["stage1"]["launches"],
                **{f"{n}[e4m3]": fp8["e2e"]["launches"][n] for n in ("flash_attention", "flash_decode_stacked",
                                                                      "commit_rows")},
                **{f"{n}[e4m3]": fp8_runs[("e4m3", "auto")]["launches"][n] for n in paged},
                "paged_flash_decode_manual": fp8_runs[("bf16", "manual")]["launches"]["paged_flash_decode_manual"],
                "paged_flash_decode_manual[e4m3]":
                    fp8_runs[("e4m3", "manual")]["launches"]["paged_flash_decode_manual"],
                # K10 on the calibrated w8a8 request (phase 21), K5 in the 45-layer ViT without
                # qk-norm (phase 22), K6 in the decode step through cache_attend (phase 23), the
                # page-size-64 K12 and K14 in the page-size-64 serving run (phase 20)
                "dense_prequant_swiglu_quant": e2e10["launches"]["dense_prequant_swiglu_quant"],
                "packed_self_attention": vit5["packed_self_attention_launches"],
                "flash_decode": k6["flash_decode_launches"],
                **{f"{n}[page_size=64]": ps64["launches"][n] for n in ("paged_flash_decode", "paged_flash_prefill")},
                # phase 26: K2 at a verify step's rows (the oracle-draft speculative run's verify steps), K3
                # at B = 4 (the timed beam search); K3 over the video's cache (phase 25's timed video
                # request); K7, K11 and K10 at M = 9 in the w8a8 speculative runs' verify steps
                surface_rows[0]["name"]: options["speculative"]["oracle draft"]["k2_launches"],
                **{f"{n}[M=9]": spec8["launches"][n] for n in ("rmsnorm_quant", "attn_proj_glue_quant")},
                "dense_prequant_swiglu_quant[M=9]": spec10["launches"]["dense_prequant_swiglu_quant"],
                "flash_decode_stacked[B=4]": options["beam"]["k3_launches"],
                "flash_decode_stacked[video]": entry["video"]["launches"]["flash_decode_stacked"],
                # phase 28: K2 and K4 in the echo run's verify ticks, K14 in the prefix-cache run's timed wave
                **routes_launches,
                # phase 29: K2, K3 and K4 in the slot engine's timed run
                **slot_launches,
                # phase 31: K2 at D = 64 / 72 in the CLIP-L, InternViT-300M and SigLIP runs; phase 33: K2-K4
                # at group 1 on the MoE trunk's single request, K12 / K14 / K15 in its serving run
                **tower_launches, **moe_launches,
                # phase 35: K2's segment entry in the packed forward at full depth
                **a12_launches,
                # phase 43: the kernels at head width 64 on that phase's chats, serving runs and K6 step;
                # phase 44: K16a / b / c at head width 64 in the three full-depth stage-2 steps
                **hw_launches, **t44_launches}
    kernels = [{
        "name": r["name"], "route": "cuda", "source": r["source"], "replaces": r["replaces"],
        "launches": launches[r["name"]], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
    } for r in rows + paged_rows + w8a8_rows + train_rows + fp8_rows + ps_rows + [k5_row, k6_row] + surface_rows
        + routes_rows + slot_rows + tower_rows + moe_rows + a12_rows + hw_rows + t44_rows]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
