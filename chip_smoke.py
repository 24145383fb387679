#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each on stdout, any failure exits non-zero before the
result line:

1. the card: ``device_info()`` (name, memory, nvidia-smi name and power limit);
2. the build: every ``gofr_tpu_torch/csrc/*.cu`` compiled by its own nvcc
   for sm_90a, all started together, and linked into
   ``gofr_tpu_torch/build/libgofr_kernels.so``; seconds and the compiler's
   register/spill lines;
3. the kernels at the slice's own shapes (Llama-3-8B heads: Hq 32, Hkv 8,
   D 128; 8 slots of live length 100..2000 and one empty slot, on bf16,
   int8 and int4 pools of page 128, the quantized ones written by the
   port's own writes from random bf16 K/V, and on a bf16 slot cache of
   2176 positions per slot, with a lane past the slot; lanes on and one
   past the split boundaries of the slot and paged decodes; 4 x 512
   and 4 x 1024 prefills, full and ragged, a chunk of 200 queries after
   cached offsets and one of 512 at offset 512 (phase 4's chunk), and the
   verify forward of speculative decoding, 5 queries at each live slot's
   length against 2176 keys, and the quality plane's teacher-forced
   forward, one sequence of 1088 keys in a bucket of 2048; the five appends, bf16 and quantizing, on
   edge lanes: a position of -1, past the table, through an OOB or
   negative entry, at and past Smax, an all-zero row and a row whose max
   is one element; the W8A16 linear at Llama-3-8B's five (N, K) for M =
   8, 40 and 2048 rows, ``W8_SHAPES`` x ``W8_ROWS``; and C's head-dim-64
   build, ``flash_attention_d64``, at ``D64_SHAPES``: a full BERT-base
   step of the batch engine, 256 rows of 64 keys masked by lengths 8..64
   with 16 padded rows of length 1, a batch of 32 ViT-L/16 images of 197
   positions, GPT-2's causal 4 x 512, full and ragged with offsets and
   a fully masked row, and GPT-2's prefill chunk of 512 at offset 256);
   the head-dim-64 builds of A and B at Llama one_b's decode step (Hq 32,
   Hkv 4, the pool of page 128 and the 8 live slots and empty one above)
   and of F and G at GPT-2 small's (Hq = Hkv 12, a slot cache of 1024
   positions, 8 live lengths of 256..1024 and an empty slot), with the
   same edge lanes and split boundaries as their 128 builds, each on layer
   0 of a stack of layers (``D64_DECODE``); the head-dim-64 builds of D, E,
   B-q and B-q4 at one_b's step on int8 and int4 pools written by the
   port's own quantizing writes, and of G-q on an 8 x 1024 int8 slot cache
   of one_b's KV heads at GPT-2's lengths: each held against its
   plain PyTorch version on the same inputs (the appends bit for bit,
   values and scales), timed with
   CUDA events and by device time beside the plain version, a library
   yardstick where one PyTorch call computes the same function, and the
   least time the card could take (its bound); and the split decode
   kernels A, D, E and F at every plan the warmup autotuner races
   (``split_candidates``), each pinned by a decision scope, held against
   their split plain versions at that plan and timed (``plans``); and
   the f32 builds of C, F and G on unit-scale inputs drawn in f32 (the
   ``*_f32`` rows): C at Llama-3-8B's heads on 4 x 512 (full and ragged)
   and 4 x 1024 causal prompts and a chunk of 512 at offset 512, its 64
   build at BERT's step, ViT's 32 x 197 and GPT-2's causal and chunked
   calls, both beside a batch row of 200 or 197 positions whose next row
   is fully masked with NaN in its first keys and values (the row must
   hold, the masked row read zero), each row with its build's registers,
   spills and shared bytes (``build``); F at the slot case's step and at
   GPT-2's, with a lane past the
   slot, the split's boundaries and every plan; G on the slot appends'
   edge lanes; held to their launchers' f32 limits (``F32``) against the
   f32 plain versions, G bit for bit, and timed beside SDPA in f32, their
   bounds counting f32 bytes and C's operations at the TF32 peak over
   three; and the f32 builds of A, B, D and B-q: A on f32 pool slices of
   the decode case's pages, table and lengths (its 64 build at one_b's
   heads), with the split's edges and every plan; B on the same f32 pools
   on the pool appends' edge lanes; D with an f32 q on the int8 pools
   above, split edges and plans; B-q on f32 rows on the same edge lanes;
   held to the launchers' ``F32`` limits against the f32 plain versions
   (B and B-q bit for bit), A beside SDPA in f32 on gathered views, their
   bounds counting f32 bytes and operations at the f32 peak; and the f32
   builds of E, B-q4, G-q and W8A16: E with an f32 q on the int4 pools
   above at Llama-3-8B's step and one_b's, split edges and plans, before
   the quantizing appends' timed launches write those pools; B-q4 and G-q
   on f32 rows on their edge lanes at both head dims, bit for bit; W8A16
   on f32 rows at Llama-3-8B's five (N, K) for M = 8 and 2048
   (``W8_ROWS_F32``), held to its ``F32`` limits relative to max |y|
   against the f32 ``qdot_plain``, timed beside cuBLAS's f32 ``F.linear``
   on the dequantized f32 weight (TF32 off), its bound's operations at
   three bf16 products each;
4. the main path, once per cache (``RUNS``): a full-width, full-depth
   Llama-3-8B engine with random bf16 weights from a seed serves 8
   concurrent requests (prompts of 64..1024 tokens, 64 new greedy tokens
   each) on a bf16 pool, then the same model on an int8 and an int4 pool
   (``kv_quantize``) and on a bf16 and an int8 slot cache
   (``kv_layout="slot"``); every launch counter is set to 0 just before
   each run and read just after it, and each kernel of that cache's path
   (``ON_PATH``) must be > 0, the decode-step kernels equally often, and
   every other kernel 0. Then the speculative runs (``SPEC_RUNS``, g = 4)
   on the same prompts: ``paged_spec``, prompt lookup on the bf16 pool,
   must launch C alone (on verify rows once a layer a round), and
   ``slot_spec_draft``, a draft of Llama-3-8B's widths cut to 2 layers on
   the bf16 slot cache, C, F and G (the draft's steps); each prints its
   accept rate, tokens per lane and verify forward, and the share of
   requests whose tokens equal the plain run's on its cache with the logit
   margins at the first differences, the share not held; at each first
   difference the token the spec run chose must lie within ``SPEC_TIE_GAP``
   of the top logit of a whole-sequence forward (a bf16 near tie, not a
   wrong acceptance); one request of ``paged_spec`` is streamed, and its
   ids must equal that request's own result. Then
   ``paged_admission``: the same model on a
   bf16 pool of 40 pages (``ADMISSION``), where a warm request leaves a
   768-token system prefix in the prefix cache and a burst of 8 prompts
   that share it (896..1408 tokens, so all chunk) and 4 that do not must
   preempt; it must launch the bf16 pool's kernels, C on chunked rows among
   them, every request must end with 64 tokens, each of the 8 must be
   served 6 pages from the cache, and the pool's audit must pass. The
   share of requests whose tokens equal an unconstrained run's (no prefix
   cache, no chunking, the full pool) is printed with the margins, not held.
   Then ``paged_prefix_host``: the same traffic on an engine with a host
   tier of 512 MiB (``HOST_TIER``), then 4 prompts that need the whole
   pool, then the 8 shared prompts again; the pressure must spill pages,
   the second wave must swap pages in, serve each of its prompts the
   768-token prefix from the cache and at least those 6 pages from the host
   tier, every burst's tokens must equal the same traffic's with the tier
   off by the tie rule, and the pool and tier audit must pass after each
   burst; it prints the swap-ins' pages, bytes, ms on the card and GB/s
   beside the host link's raw rate (the data sheet's PCIe Gen5 x16 where
   nvidia-smi reports none). Then ``paged_pipeline``: pipeline depth
   1 against 2 on the bf16 pool, in turns 1, 2, 2, 1, 16 prompts in 4 waves
   of 4, each wave submitted once the previous one's first tokens are out;
   each arm must launch A, B, C and no other kernel, carry at most depth -
   1 calls across a loop turn (1 at depth 2), and give the first arm's
   tokens by the tie rule; it prints each arm's tok/s, TTFT p50 and max,
   host ms a loop turn, the folds' wait on their events, and the device's
   idle share over one more wave run under ``torch.profiler`` after the
   timed ones, holding none.
   Then ``paged_lora``: ``bf16``'s traffic on an engine with the adapter
   plane (4 pool slots of rank 16; three random adapters of ranks 8, 12
   and 16), the requests on the base model and the three adapters in turn;
   it must launch the ``bf16`` run's kernels, end every request with 64
   tokens, give every adapter request other tokens than the ``bf16`` run's
   on the same prompt, and leave 3 adapters resident and none referenced;
   the share of base requests whose tokens equal the ``bf16`` run's and
   tok/s beside it are printed. Last the adoption check: on Llama-3-8B's
   widths cut to 2 layers, ``adopt_weights`` swaps in new random weights
   while 4 requests decode; all 4 must end with 64 tokens, each preempted once,
   ``weights_epoch`` must be 1, and a request after the swap must equal,
   token for token, the same request on an engine built on the new
   weights. Then ``http_generate``: the port's App on localhost, its
   engine built from a ``ModelSpec`` and ``ENGINE_*`` config
   (``HTTP_CONFIG``; random weights from the seed, the phase's model),
   takes the 8 prompts as 8 concurrent ``POST /generate`` (each 201, 64
   tokens, compared with ``bf16``'s by the spec runs' tie rule), two
   streamed over ``POST /generate/stream`` (``token`` frames, then
   ``done``; ids held against the unary result by the same rule), a
   0.001 s timeout (408) and an unknown path (404), each with its
   envelope; alive and health answer, ``app_http_response`` counts the
   POSTs, the launch counters show ``bf16``'s kernels and no other, and
   after ``stop`` the engine's thread has ended; it prints the HTTP
   overhead per request, the SSE first event against the engine's TTFT
   and decode tok/s beside ``bf16``'s. Then ``paged_w8``: the engine
   built from a ``ModelSpec`` of the phase's bf16 model and a container
   whose config is ``W8_CONFIG`` (``bf16``'s knobs, ``ENGINE_QUANTIZE=
   int8``) serves ``bf16``'s traffic; the int8 model must hold
   ``W8_BYTES``, the bf16 model stay as it was, every request end with 64
   tokens, A, B and C launch and the W8A16 kernel 7 x 32 + 1 times a model
   forward (it launches in no other run); it prints the share of requests
   whose tokens equal ``bf16``'s (not held: int8 weights move the logits)
   and tok/s and TTFT beside ``bf16``'s. Then ``paged_warmup``: on
   ``bf16``'s knobs and model, ``warmup()`` after a request left pages in
   the prefix cache must run JAX's count of calls, launch A, B and C, and
   leave the pool's bytes and books and the prefix cache as they were;
   ``bf16``'s prompts after it end with ``bf16``'s tokens by the tie rule.
   Then ``paged_restart``:
   ``bf16``'s knobs and model with a host-side fault planted in the decode
   dispatch once the 8 requests are in slots; they must fail with it,
   health read DEGRADED inside the backoff, the 8 prompts submitted after
   the fault end with 64 tokens, equal to ``bf16``'s by the tie rule,
   ``app_tpu_engine_restarts`` read 1, the pool's audit pass and A, B, C
   launch; it prints the seconds from the fault to the next token. Then
   ``paged_quality`` and ``int8_quality``: the engine from a ``ModelSpec``
   and ``QUALITY_CONFIG`` (every finished request shadow-scored) on the
   bf16 and the int8 pool serves the 8 prompts and drains its plane: 8
   samples, no error, the tokens of the run without the plane by the tie
   rule, each arm launching C once a layer, on the bf16 pool the arms
   equal (KL 0), at every top-1 disagreement the emitted token within
   ``SPEC_TIE_GAP`` of the serving arm's top logit; on the bf16 pool the App
   serves the engine under ``CAPTURE_CONFIG``, and the capture bundle a 1
   ms interactive TTFT objective writes, and a ``/debug/profile`` taken
   during a second wave, must each hold a trace with C's and A's kernel
   events; it prints each sample's bucket, each arm's device ms and C's
   share. Last ``cold_start``: ``scripts/torch_cold_start.py`` in two fresh
   processes, ``ENGINE_WARMUP`` false and true, prints warmup's seconds and
   count and the first and a second request's TTFT. Before it
   ``paged_control`` (``serve_control``): ``bf16``'s pool from a
   ``ModelSpec`` with the step controller on (``CONTROL_CONFIG``), under
   ``paged_pipeline``'s waves for 15 s, then a wave of ``bf16``'s prompts
   with pipeline depth 1, chunk 128 and batch 1 queued mid-wave, the boot
   values queued in the next, and a spec engine (g 4) moved to g 2
   mid-wave: at least one trial and one commit or revert, every knob of
   every decision and flight step within its boot envelope, the waves'
   tokens ``bf16``'s by the tie rule, the decisions counter equal to the
   ring; and ``paged_handoff`` (``serve_handoff``): a prefill worker and a
   decode worker of ``bf16``'s knobs in one process, streamed, blob, an
   int8 pair and 2 prompts of 1536 tokens in 3 chunks each: each prompt of
   a page or more ends on the prefill worker with ``finish_reason=
   "handoff"`` and one token, the decode worker's tokens are its cache's
   run's by the tie rule, pages exported = imported = Σ⌊len/128⌋ (pinned
   on the import), bytes = pages × page bytes, host-tier tokens 128 ×
   Σ⌊(len−1)/128⌋, both pools audit clean; it prints each arm's readback
   and wire GB/s, overlap ratio and the decode worker's TTFT p50. After
   ``cold_start``, ``paged_autotune`` (``serve_autotune``): the split-plan
   autotuner at warmup on four engines of Llama-3-8B's widths cut to 2
   layers (bf16, int8 and int4 pools, bf16 slot cache); each pins one of
   its candidates from its own timings with none disqualified (another
   plan than the rule's only past the timer's spread), a second
   engine of the same shapes pins from the cache file without timing, and
   under ``GOFR_AUTOTUNE=0`` there is no report; it prints each
   candidate's ms and spread and the winner beside ``split_plan``'s. Last
   ``app_transports``: the App's other entry points on the phase's model
   behind Basic auth (``TRANSPORTS_CONFIG``, warmed, so A runs on the plan
   pinned at 32 layers): 8 concurrent ``/ws/generate`` clients and a ninth
   that leaves mid-stream (cancelled, its slot freed), 4 unary gRPC calls
   and a stream, 4 prompts through pub/sub (generate, publish, collect), a
   cron job, 401 / 201 / 101 and a static file and the OpenAPI spec; every
   path's tokens are ``bf16``'s by the tie rule, a stream is one frame per
   token then ``{"done": true}``, ``app_pubsub_*`` read 8 each, the pool
   audits clean, A, B and C launch and A only on the pinned plan, and after
   ``stop`` no thread the App started is left; it prints the websocket
   first frame against the engine's TTFT, the frame gap against its TPOT,
   the gRPC overhead and pub/sub publish to completion. Then
   ``app_services``: a model App on the phase's model (``SERVICES_CONFIG``:
   ``HTTP_CONFIG`` with SQLite and a KV store in a temporary directory)
   migrates a ``completion`` table at boot (versions 1 and 2), gives it
   CRUD routes and answers ``POST /complete`` by generating 64 tokens and
   storing them; a gateway App (``GATEWAY_CONFIG``, no model) reaches it
   through ``register_service`` with a circuit breaker, a retry and a
   retry budget; ``bf16``'s 8 prompts go to the gateway as 8 concurrent
   ``POST /ask`` with a deadline, then each row comes back through the
   gateway's ``GET /completion/{id}``, then the model App stops and calls
   go on until the breaker opens. Held: 64 tokens each, ``bf16``'s by the
   tie rule, the rows and KV entries equal to what ``/ask`` returned,
   ``gofr_migrations`` at 1 and 2, the model App's health with sql, kv,
   file, tpu (platform gpu, one device, memory in use, the card's total
   as its limit) and the model UP, the gateway's ``service:model`` UP
   and, after the stop, DOWN with the aggregate DEGRADED, the breaker open
   within its threshold plus the retries of refused connections and then
   failing fast, one trace id across both Apps' server spans, the
   caller's deadline read by the model App, A, B and C launched and no
   other kernel, the pool audit clean and no thread left after both stop;
   it prints the gateway's overhead a request, the insert's seconds, the
   migrations' seconds and the failures before the breaker opened. Then
   the encoders
   on the batch engine, built by the App from a ``ModelSpec`` with random
   bf16 weights from the seed: ``bert_embed`` (BASELINE.md configuration
   #1: BERT-base, 12 layers of 768, ``ENGINE_MAX_BATCH=256``,
   ``ENGINE_MAX_WAIT_MS=2``, warmed on the 64 bucket) takes 512 unary
   JSON-over-gRPC calls of 64 token ids from 64 client threads, and
   ``vit_classify`` (configuration #3: ViT-L/16 at 224, 24 layers of 1024,
   ``ENGINE_MAX_BATCH=32``) 64 uint8 images through the in-memory broker
   to 32 consumer threads: every call answers (embeddings of norm 1 within
   1e-3), every message is handled and committed, a BERT step holds 8
   requests or more, C's 64 build launches once a layer a step and no
   other kernel launches (every Llama run holds it at 0), and the outputs
   agree with the plain path on the same inputs, and a request alone with
   one inside a batch, within 5% of the plain outputs' range; each prints
   its rate, latency and step occupancy. Last the head-dim-64 generate
   runs: ``gpt2_generate``, GPT-2 small (12 layers of 768, 12 heads of 64)
   with random bf16 weights from the seed, built by the App from a
   ``ModelSpec`` and ``GPT2_CONFIG`` onto the family's bf16 slot cache of
   1024 positions, 8 concurrent ``POST /generate`` of 64..768-token
   prompts (those past the 512 bucket in chunks at an offset), 64 new
   tokens each: C, F and G's 64 builds and no other kernel launch, F and G
   equally often, whole decode steps x 12 layers, and the tokens equal the
   plain path's on the card (``plain_tokens``, every kernel off) by the
   tie rule; ``gpt2_w8``, the same with ``ENGINE_QUANTIZE=int8``: W8A16
   6 x 12 times a model forward besides (the tied head stays bf16), fewer
   weight bytes, tokens against ``gpt2_generate``'s printed, not held; and
   ``one_b_bf16``, Llama one_b (22 layers of 2048, 32 heads of 64, 4 KV
   heads) on ``bf16``'s pool and knobs and prompts: A, B and C's 64 builds,
   A and B equally often, whole steps x 22 layers, no 128 build, tokens
   the plain path's by the tie rule; then the same model on the int8 pool
   (``one_b_int8``: D, B-q and C's 64 builds), the int4 pool
   (``one_b_int4``: E, B-q4 and C's 64 builds) and the int8 slot cache
   (``one_b_slot_int8``: G-q and C's 64 builds, its decode attention plain
   PyTorch as at 128), each with its decode-step kernels equally often in
   whole steps x 22 layers, no other kernel, the cache's bytes a position
   at ``ONE_B_KV_BYTES``, and tokens the plain path's on the same cache by
   the tie rule read on that path's own logits (against ``one_b_bf16``'s
   printed, not held). Then the f32 models in their configs' own dtype,
   each launching its f32 builds of C, F and G and no other kernel (and
   every run before them none of those): ``bert_embed_f32`` and
   ``vit_classify_f32``, the two encoder runs in f32 with
   ``BERT_REQUESTS_F32`` calls and ``VIT_IMAGES_F32`` images, outputs
   within ``ENCODER_RTOL_F32`` of the plain path's range, alone and in a
   batch; ``gpt2_f32``, GPT-2 small in f32 through the same App,
   ``/generate`` and prompts as ``gpt2_generate``, C, F and G's 64 f32
   builds (F = G, whole steps x 12), ``GPT2_KV_BYTES`` a position of the f32
   slot cache, and tokens the f32 plain path's by the tie rule at
   ``F32_TIE_GAP`` on that path's logits; and ``llama_slot_f32``,
   Llama-3-8B's widths cut to ``LLAMA_F32_LAYERS`` layers in f32 on the
   slot cache with ``bf16``'s knobs and prompts, the 128 f32 builds, held
   the same way; ``gpt2_w8_f32``, GPT-2 small in f32 with
   ``ENGINE_QUANTIZE=int8`` through the same App: W8A16's f32 build 6 x 12
   times a model forward besides C, F and G's 64 f32 builds (the tied head
   stays f32), tokens the f32 plain path's on its int8 model at
   ``F32_TIE_GAP``; and an f32 Llama on every cache and with int8 weights
   (``F32_LLAMA_RUNS``): ``one_b_f32`` (one_b at full width and depth,
   random f32 weights, on the f32 pool: A, B and C's 64 f32 builds),
   ``one_b_int8_f32`` (the same model on the int8 pool: D, B-q and C's 64
   f32 builds), ``one_b_int4_f32`` (the int4 pool: E, B-q4 and C's),
   ``one_b_slot_int8_f32`` (the int8 slot cache: G-q and C's, its decode
   attention plain PyTorch as in bf16), and Llama-3-8B's widths cut to
   ``LLAMA_F32_LAYERS`` layers on the same caches (``llama_paged_f32``,
   ``llama_int8_f32``, ``llama_int4_f32``, ``llama_slot_int8_f32``: the
   128 f32 builds) and with int8 weights on the f32 pool
   (``llama_w8_f32``: A, B, C and W8A16's f32 builds, 7 x 2 + 1 W8A16
   launches a forward), each with ``bf16``'s knobs and prompts, its
   decode-step builds equally often in whole steps x layers, no other
   kernel, the cache's own bytes a position at ``F32_LLAMA_KV_BYTES``, and
   tokens the f32 plain path's by the tie rule at ``F32_TIE_GAP`` (on a
   quantized cache the plain decode's after C's prefill at
   ``INT8_F32_TIE_RTOL`` or ``INT4_F32_TIE_RTOL`` of the largest |logit|,
   and the whole plain path's at the cache's phase-5 limit);
5. the model on the card, on each cache: three prompts through
   ``prefill`` and four ``decode_step`` steps with the kernels, with
   their plain versions, with the kernels in prefill only and in decode
   only, and with the kernels and the prompt prefilled in two chunks of
   128 (``PHASE5_RUNS``); the kernel runs' logits, the chunked one's too,
   must agree with the plain whole-prompt run's within the limits below,
   and each step's error of every run is reported; a ``verify_step`` of 5
   tokens after the prompt, with the kernels, must agree with its plain
   version within the same limits, and the plain verify with the plain
   decode steps' logits within ``DECODE_RTOL``; then on each cache one
   ``decode_step`` and one ``verify_step`` over 5 lanes on the base model
   and the adapters (``LORA_SEL``): the base lanes' logits must be
   bit-identical to the same call's without adapters, the adapter lanes'
   within ``LOGITS_RTOL`` of the plain path's with adapters; then
   ``phase5_model_w8``, the runs above on the int8-weight model on the bf16
   pool, W8A16 against ``qdot_plain`` end to end, within the same limits;
   and ``phase5_model_one_b_int8`` / ``_int4``, the runs above on one_b on
   the int8 and int4 pools (D, E and the appends at 64), within the same
   limits; and ``phase5_model_gpt2_f32``, the runs above on GPT-2 small in
   f32 on its slot cache (C, F and G's f32 builds), every error taken over
   the plain logits' range and held to ``F32_TIE_GAP``; the same on one_b
   in f32 on the f32 pool (``phase5_model_one_b_f32``: A, B and C's 64 f32
   builds) and on the int8 and int4 pools at those pools' limits
   (``phase5_model_one_b_int8_f32``: D and B-q's;
   ``phase5_model_one_b_int4_f32``: E and B-q4's); and GPT-2 small in f32
   with int8 weights (``phase5_model_gpt2_w8_f32``: W8A16's f32 build
   against ``qdot_plain``, at ``F32_TIE_GAP`` of the logit range);
6. no host sync: a prefill of two 128-token chunks, two ``decode_step``
   steps and one speculative round with a sampled lane on each cache, then
   an adapter upload, a ``decode_step`` and a speculative round with the
   lanes on the base model and adapters, inside
   ``torch.cuda.set_sync_debug_mode("error")``, which raises on any call
   that makes the host wait on the card; then on a stopped engine of each
   cache the engine's own dispatches under the same check: a batched
   prefill, two prefill chunks, two decode chunks (the second from the
   device carry), a swap-in on the pool (the page swapped in must equal its
   source bit for bit), on the pool a prefill worker's handoff export (the
   page copies staged at a chunk fold and at activation, each equal to its
   pool page bit for bit) and two speculative rounds, the folds outside it;
   both checks also on the int8-weight model on the bf16 pool; and GPT-2's
   slot path: a prefill in two chunks of 128 (C's 64 build once a layer
   each) and two ``decode_step`` steps (F and G's 64 builds once a layer
   each) under the same check, the same on GPT-2 in f32 (the f32 builds)
   and in f32 with int8 weights (W8A16's f32 build besides, 6 x 12 a
   forward), and the same on one_b's int8 and int4 pools (C's 64 build for
   the chunks, D or E and B-q or B-q4 at 64 for the steps) and on one_b in
   f32 on the f32, int8 and int4 pools (their f32 builds).

Then the ``wall_time`` line (seconds of each phase), the ``kernels`` line,
the ``nvidia-smi`` name and power limit line and, last, ``{"ok": true,
"device": {...}}``. Without a card, or run outside a checkout of the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

SEED = 0
# Kernel vs plain: each kernel's limits (MAX_ABS on any element, RMS_REL on
# the RMS of the difference over the RMS of the output) are stated beside
# its launcher (ops/cuda/*.py); the KV append is held to bit equality.
# Model on the card: 32 layers of bf16 rounding at different points move
# the logits by a small fraction of their range. On a quantized pool such a
# rounding can also flip a stored code, which moves that K/V element by a
# whole step of max|x|/127 (int8) or max|x|/7 (int4). Phase 5 splits the
# step: with the plain prefill and the kernels in decode only, every pool
# reads like bf16 (under 2% of the logit range on the H100) and is held to
# DECODE_RTOL. The int4 pool's larger error (up to 6.3%) comes with the
# flash prefill: the K/V it stores differ from the plain run's by 13% RMS,
# against 1.9% on int8, as flipped 4-bit codes feed the next layer. So its
# served-path limit is twice the others'; a masked causal diagonal in the
# flash kernel reads 60% there (PERF.md, scripts/torch_kernel_mutants.py).
LOGITS_RTOL = {"": 5e-2, "int8": 5e-2, "int4": 1e-1}
DECODE_RTOL = 5e-2
# A spec run and the plain run round bf16 logits through different kernels
# (C over a dense view against A/F), so a near tie can flip: at a first
# difference the spec run's token must lie within four bf16 ulps of the top
# logit (one ulp is 1/32 at |logit| in [4, 8), where these logits lie).
SPEC_TIE_GAP = 0.125
PHASE5_PROMPTS = 3


def emit(phase: str, payload) -> None:
    print(f"{phase} {json.dumps(payload, sort_keys=True)}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls (CUDA events)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int) -> float:
    """Device time of one ``fn(i)``: the time of the GPU activity (kernels,
    memsets, copies) that ``iters`` calls leave in a ``torch.profiler``
    trace, over ``iters``. Unlike ``time_ms`` it leaves out the host's time
    between launches, which a short kernel behind a Python wrapper can wait
    on."""
    from torch.profiler import ProfilerActivity

    from gofr_tpu_torch.gpu.launch_gate import quiet_profile

    fn(0)
    torch.cuda.synchronize()
    with quiet_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
    total_us = sum(e.device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / 1e3 / iters


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# The H100 SXM's peaks for the f32 builds' operations (NVIDIA's data sheet,
# dense, at 700 W): C's f32 products run as three TF32 tensor-core products
# each (3xTF32), so an f32 multiply-add costs three at 495 TFLOP/s; W8A16's
# f32 build and D's and E's f32-q q.k run three bf16 tensor-core products
# for each (x or q split into three bf16 pieces), three at 989 TFLOP/s;
# F's f32 build, and D's and E's P.V, multiply on the CUDA cores, 67
# TFLOP/s in f32.
H100_SXM_TF32X3_FLOPS = 495e12 / 3
H100_SXM_BF16X3_FLOPS = 989e12 / 3
H100_SXM_F32_FLOPS = 67e12


def bound_ms(nbytes: float, flops, peak: float | None = None) -> tuple[float, str]:
    """The least time the card could take: bytes over the H100 SXM's HBM
    rate or operations over its dense peak for their type (bf16 unless
    ``peak`` says otherwise), whichever is longer (the data-sheet pair the
    perf plane's ``device_peaks`` prices it by). ``flops`` may instead be
    (operations, peak) pairs, for work of several types: their times add."""
    from gofr_tpu_torch.metrics.perf import H100_SXM_BF16_FLOPS, H100_SXM_HBM_BYTES_PER_S

    t_bytes = nbytes / H100_SXM_HBM_BYTES_PER_S
    t_ops = (sum(ops / rate for ops, rate in flops) if isinstance(flops, (list, tuple))
             else flops / (peak or H100_SXM_BF16_FLOPS))
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ptxas_usage(report: str, fragment: str) -> dict:
    """Registers, spills and stack of each entry whose name holds
    ``fragment``, from ``nvcc -Xptxas -v``'s report (``cuda.build``)."""
    usage, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            name = m.group(1)
            continue
        if name is None or fragment not in name:
            continue
        row = usage.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            row.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
    return usage


# C's f32 build by head dim, under its phase-3 names
F32_FLASH_DIMS = {"flash_attention_f32": 128, "flash_attention_d64_f32": 64}


def flash_f32_build(report: str, d: int) -> dict:
    """C's f32 body at head dim ``d``: ptxas's registers, spills and stack,
    and the dynamic shared memory a block takes."""
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda.flash_attention import shared_bytes

    usage = [u for name, u in ptxas_usage(report, "flash_kernel_f32").items() if f"ILi{d}E" in name]
    require(len(usage) == 1, f"ptxas reported {len(usage)} f32 flash kernels at head dim {d}")
    # the consumers' setmaxnreg.inc must not ask for fewer registers than
    # the launch gives them
    consumer = int(re.search(r"kConsumerRegs = (\d+)",
                             (cuda.CSRC / "flash_attention_f32.cu").read_text()).group(1))
    require(usage[0]["registers"] <= consumer,
            f"the f32 flash kernel at head dim {d} takes {usage[0]['registers']} registers, past "
            f"its consumers' setmaxnreg of {consumer}")
    return {**usage[0], "shared_bytes": shared_bytes(d)}


def agreement(name: str, got, want, module) -> dict:
    """Hold a kernel's output against its plain version's under the two
    limits its launcher module states: no element off by more than
    ``MAX_ABS`` (a local fault), and the RMS of the difference under
    ``RMS_REL`` of the output's RMS (a small fault spread over many rows)."""
    got, want = got.float(), want.float()
    require(bool(got.isfinite().all()), f"{name} produced non-finite values")
    diff = got - want
    err, rms = diff.abs().max().item(), diff.pow(2).mean().sqrt().item()
    out_rms = want.pow(2).mean().sqrt().item()
    rel = rms / max(out_rms, 1e-30)
    numbers = {"max_abs_err": err, "rms_rel_err": rel, "out_rms": out_rms}
    if not (err <= module.MAX_ABS and rel <= module.RMS_REL):
        failure = SystemExit(f"chip_smoke FAILED: {name} disagrees with plain: max err {err} "
                             f"(limit {module.MAX_ABS}), RMS err / RMS out {rel} "
                             f"(limit {module.RMS_REL})")
        failure.numbers = numbers
        raise failure
    return numbers


def _decode_case(torch) -> dict:
    """The decode kernels' inputs at the slice's shapes: 8 slots of live
    length 100..2000 on pages of 128 in a random order (OOB entries == P),
    a ninth slot that is empty (length 0, its table row all OOB), and
    ``layers`` layer slices of each pool, cycled while timing so each
    launch finds its pages cold in L2, as a decode step through 32 layers
    does. The int8 and int4 pools are written by the port's own
    ``write_prompts_paged_q``/``_q4`` from random bf16 K/V, so their scales
    are those of real rows."""
    from gofr_tpu_torch.ops.paged import (
        Q4PagedKVCache,
        QPagedKVCache,
        write_prompts_paged_q,
        write_prompts_paged_q4,
    )

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cpu_rng = torch.Generator().manual_seed(SEED)
    hq, hkv, d, page, n, maxp, layers = 32, 8, 128, 128, 9, 16, 8
    lengths_cpu = torch.randint(100, 2001, (n,), generator=cpu_rng, dtype=torch.int32)
    lengths_cpu[-1] = 0
    pages_needed = [math.ceil(int(x) / page) for x in lengths_cpu]
    pool = sum(pages_needed)
    perm = torch.randperm(pool, generator=cpu_rng).to(torch.int32)
    table_cpu = torch.full((n, maxp), pool, dtype=torch.int32)  # OOB == pool
    used = 0
    for i, need in enumerate(pages_needed):
        table_cpu[i, :need] = perm[used:used + need]
        used += need
    table = table_cpu.to(dev)
    k_pool = torch.randn(layers, pool, hkv, page, d, device=dev, generator=gen).to(bf)
    v_pool = torch.randn(layers, pool, hkv, page, d, device=dev, generator=gen).to(bf)
    pools = {8: QPagedKVCache.create(layers, pool, page, hkv, d, device=dev),
             4: Q4PagedKVCache.create(layers, pool, page, hkv, d, device=dev)}
    for layer in range(layers):
        for plane in ("k", "v"):
            rows = torch.randn(n, maxp * page, hkv, d, device=dev, generator=gen).to(bf)
            for bits, write in ((8, write_prompts_paged_q), (4, write_prompts_paged_q4)):
                cache = pools[bits]
                write(getattr(cache, plane)[layer], getattr(cache, plane + "s")[layer], table, rows)
    return {"hq": hq, "hkv": hkv, "d": d, "page": page, "n": n, "layers": layers,
            "lengths_cpu": lengths_cpu, "lengths": lengths_cpu.to(dev), "table": table,
            "k_pool": k_pool, "v_pool": v_pool, "pools": pools,
            "q": torch.randn(n, hq, d, device=dev, generator=gen).to(bf),
            "live": int(lengths_cpu.sum()), "gen": gen}


def _slot_case(torch, c: dict) -> dict:
    """The slot kernels' inputs at the slice's shapes: ``_decode_case``'s
    q and lengths (8 live slots and an empty one) over slot-cache layer
    slices [9, Hkv, Smax, D] of Smax 2176, the cache length the engine
    gives ``max_len`` 2048 and ``decode_chunk`` 8 (not a multiple of the
    kernel's 64-row tile), ``layers`` slices cycled while timing. Every row
    is random, so a lane read past its length reads data."""
    smax, shape = 2176, (c["layers"], c["n"], c["hkv"], 2176, c["d"])
    k = torch.randn(shape, device="cuda", generator=c["gen"]).to(torch.bfloat16)
    v = torch.randn(shape, device="cuda", generator=c["gen"]).to(torch.bfloat16)
    return {"smax": smax, "k": k, "v": v}


def check_kernels(torch, timed: bool = True, keep_going: bool = False,
                  only: set | None = None, skip: set = frozenset()) -> list[dict]:
    """Each kernel (those of ``only`` when given, none of ``skip``) against
    its plain version at the slice's shapes, and (if ``timed``) its time
    beside the plain version's, the library yardstick's and its bound. A
    kernel that fails its check ends the run, or, with ``keep_going``, is
    recorded (``passed`` False, its failure and numbers) and the next
    kernel is checked."""
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.attention import (
        decode_attention_plain,
        decode_attention_split_plain,
        mha_attention_plain,
        paged_decode_attention_plain,
        paged_decode_attention_q4_plain,
        paged_decode_attention_q_plain,
        paged_decode_attention_q_split_plain,
        paged_decode_attention_split_plain,
    )
    from gofr_tpu_torch.ops.cuda import decode_attention as slot_decode_mod
    from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
    from gofr_tpu_torch.ops.cuda import paged_decode as decode_mod
    from gofr_tpu_torch.ops.cuda import paged_decode_q as decode_q_mod
    from gofr_tpu_torch.ops.cuda import paged_decode_q4 as decode_q4_mod
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention
    from gofr_tpu_torch.ops.cuda import kv_append as append_mod
    from gofr_tpu_torch.ops.cuda.kv_append import (
        kv_append,
        kv_append_d64,
        kv_append_d64_f32,
        kv_append_f32,
        kv_append_slot,
        kv_append_slot_d64,
        kv_append_slot_d64_f32,
        kv_append_slot_f32,
    )
    from gofr_tpu_torch.ops.cuda.paged_decode import paged_decode, paged_decode_d64
    from gofr_tpu_torch.ops.kvcache import QSlotKVCache, append_tokens_plain, append_tokens_q
    from gofr_tpu_torch.ops.paged import (
        append_tokens_paged_plain,
        append_tokens_paged_q,
        append_tokens_paged_q4,
        gather_kv,
    )
    from gofr_tpu_torch.ops import autotune
    from gofr_tpu_torch.ops.quant import unpack_int4

    def timing(kernel, plain, library=None, iters: int = 50, plain_iters: int = 10) -> dict:
        """Each of ``fn(i)`` kernel, plain version and library yardstick
        timed with CUDA events over back-to-back calls (``ms``), and the
        kernel and yardstick also by their device time (``device_ms``)."""
        if not timed:
            return {}
        return {"ms": time_ms(torch, kernel, iters), "device_ms": device_ms(torch, kernel, iters),
                "plain_ms": time_ms(torch, plain, plain_iters),
                "library_ms": library and time_ms(torch, library, iters),
                "library_device_ms": library and device_ms(torch, library, iters)}

    c = _decode_case(torch)
    f32 = torch.float32
    hq, hkv, d, page, n, layers = (c[k] for k in ("hq", "hkv", "d", "page", "n", "layers"))
    q, table, lengths, k_pool, v_pool, gen = (c[k] for k in ("q", "table", "lengths", "k_pool",
                                                             "v_pool", "gen"))
    dev, bf = q.device, q.dtype
    decode_shape = {"slots": n, "hq": hq, "hkv": hkv, "d": d, "page": page,
                    "lengths": c["lengths_cpu"].tolist()}
    # bytes every decode kernel moves besides K/V: q and out, table, lengths
    decode_io = 2 * q.numel() * 2 + table.numel() * 4 + n * 4

    def plan_holds(op: str, mod, launch, split_plain, span: int, dims: tuple,
                   qx=None, kv_heads: int | None = None) -> dict:
        """Split decode kernel ``op`` (A, D, E or F) at every plan the warmup
        autotuner races (``split_candidates``), each pinned by a decision
        scope at the launch's own shape key and cache dtype (``dims``: the
        key's numbers, then the dtype's name): the plan must be the one the
        launcher takes, its output is held against the split's plain
        version at that plan within the launcher's limits (``mod``'s, or
        a ``cuda.Limits``), and (if ``timed``) it is timed with CUDA events
        over the layers. ``qx`` and ``kv_heads`` are the launch's q and KV
        heads (the phase's Llama-3-8B shapes when None)."""
        qx, kv_heads = (q if qx is None else qx), (hkv if kv_heads is None else kv_heads)
        key, out = autotune.shape_key(*dims[:-1]), {}
        for rows in slot_decode_mod.split_candidates(qx.shape[0], kv_heads, span):
            name = autotune.plan_name(rows)
            with autotune.decision_scope({op: name}, {op: key}, {op: dims[-1]}):
                require(slot_decode_mod.split_scratch(qx, kv_heads, span, op, dims)[0] == rows,
                        f"{op}: the pinned plan {name} is not the one its launcher takes")
                agree = agreement(f"{op} (plan {name})", launch(0), split_plain(rows), mod)
                ms = time_ms(torch, launch, 50) if timed else None
            out[name] = {**agree, "ms": ms}
        return out

    def edge_case(pool: int, maxp: int, kv_heads: int | None = None) -> tuple:
        """(split_rows, splits, lengths, table) of a paged decode's split
        edges: lanes on and one past the first three split boundaries, the
        whole table row, the empty slot and past the table, through a table
        of pages drawn in scrambled order with repeats and OOB entries
        inside two live lanes. Lanes this short are held against the split's
        plain version, which keeps the scores in f32 and splits as the
        kernels do."""
        r, splits = slot_decode_mod.split_plan(n, hkv if kv_heads is None else kv_heads, maxp * page)
        edges = torch.tensor([r, r + 1, 2 * r, 2 * r + 1, maxp * page, 0, maxp * page + 5, 3 * r,
                              3 * r + 1], device=dev, dtype=torch.int32)
        edge_table = torch.randint(0, pool, (n, maxp), generator=torch.Generator().manual_seed(SEED + 2),
                                   dtype=torch.int32)
        edge_table[1, 1] = edge_table[4, maxp - 1] = pool
        edge_table[5] = pool
        return r, splits, edges, edge_table.to(dev)

    def check_paged_decode() -> dict:  # A
        got = paged_decode(q, k_pool[0], v_pool[0], table, lengths)
        want = paged_decode_attention_plain(q, k_pool[0], v_pool[0], table, lengths)
        agree = agreement("paged_decode", got, want, decode_mod)
        require(torch.all(got[c["lengths_cpu"] == 0] == 0).item(), "paged_decode: empty slots not zero")
        r, splits, edges, edge_table = edge_case(k_pool.shape[1], table.shape[1])
        got_e = paged_decode(q, k_pool[0], v_pool[0], edge_table, edges)
        agree_e = agreement("paged_decode (split boundaries)", got_e,
                            paged_decode_attention_split_plain(q, k_pool[0], v_pool[0], edge_table,
                                                               edges, r), decode_mod)
        require(torch.all(got_e[5] == 0).item(), "paged_decode: the empty slot is not zero")
        b_ms, b_by = bound_ms(c["live"] * hkv * d * 2 * 2 + decode_io, 4 * c["live"] * hq * d)
        # yardstick only (never called by the port): SDPA with a length mask
        # and enable_gqa on each layer's logical view, gathered through the
        # table outside the timed call; it returns NaN for the empty slot
        views = [gather_kv(k_pool[layer], v_pool[layer], table) for layer in range(layers)] if timed else []
        mask = (torch.arange(table.shape[1] * page, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        q1 = q[:, :, None]
        return {
            "name": "paged_decode", "route": "cuda", "source": "gofr_tpu_torch/csrc/paged_decode_q.cu",
            "replaces": "gofr_tpu/ops/pallas/paged_decode.py:94",
            "max_abs_err": max(a["max_abs_err"] for a in (agree, agree_e)),
            "rms_rel_err": max(a["rms_rel_err"] for a in (agree, agree_e)),
            "checks": {"ragged": agree, "split_boundaries": agree_e},
            "split": {"split_rows": r, "splits": splits},
            "plans": plan_holds(
                "paged_decode", decode_mod,
                lambda i: paged_decode(q, k_pool[i % layers], v_pool[i % layers], table, lengths),
                lambda rows: paged_decode_attention_split_plain(q, k_pool[0], v_pool[0], table,
                                                                lengths, rows),
                table.shape[1] * page,
                (n, hq, hkv, d, page, table.shape[1], k_pool.shape[1], "bfloat16")),
            "tolerance": {"max_abs": decode_mod.MAX_ABS, "rms_rel": decode_mod.RMS_REL},
            **timing(lambda i: paged_decode(q, k_pool[i % layers], v_pool[i % layers], table,
                                            lengths),
                     lambda i: paged_decode_attention_plain(q, k_pool[i % layers], v_pool[i % layers],
                                                            table, lengths),
                     lambda i: F.scaled_dot_product_attention(q1, *views[i % layers], attn_mask=mask,
                                                              enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by, "shape": decode_shape,
        }

    def flash_case(s: int) -> tuple:
        """q, k, v of a batch of 4 x ``s`` prompts and the bound of a full
        causal call over them."""
        qf = torch.randn(4, s, hq, d, device=dev, generator=gen).to(bf)
        kf = torch.randn(4, s, hkv, d, device=dev, generator=gen).to(bf)
        vf = torch.randn(4, s, hkv, d, device=dev, generator=gen).to(bf)
        pairs = 4 * s * (s + 1) // 2
        return qf, kf, vf, bound_ms(2 * (2 * qf.numel() + 2 * kf.numel()), 4 * hq * d * pairs)

    def sdpa(qf, kf, vf):
        """Yardstick only (never called by the port): SDPA on head-major
        views, KV heads repeated outside the timed call."""
        qh = qf.transpose(1, 2)
        kh, vh = (t.transpose(1, 2).repeat_interleave(hq // hkv, dim=1) for t in (kf, vf))
        return lambda i: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    def flash_agree(label: str, qf, kf, vf, **kw) -> tuple:
        """(agreement with the plain version, the kernel's output)."""
        got = flash_attention(qf, kf, vf, causal=True, **kw)
        return agreement(f"flash_attention ({label})", got,
                         mha_attention_plain(qf, kf, vf, causal=True, **kw), flash_mod), got

    def check_flash() -> dict:  # C: batches of 4 x 512 and 4 x 1024 full prompts (causal)
        qf, kf, vf, (b_ms, b_by) = flash_case(512)
        checks = {"causal": flash_agree("causal", qf, kf, vf)[0]}
        # ragged lengths, offsets and a fully masked row: same agreement, zeros
        lens = torch.tensor([512, 300, 77, 0], device=dev, dtype=torch.int32)
        offs = torch.tensor([0, 40, 0, 0], device=dev, dtype=torch.int32)
        checks["ragged"], got_r = flash_agree("ragged", qf, kf, vf, q_offset=offs, kv_lengths=lens)
        require(torch.all(got_r[3] == 0).item(), "flash_attention: fully masked rows are not zero")
        # the longest prefill phase 4 pads to, where the bound is operations
        q2, k2, v2, (b_ms_l, b_by_l) = flash_case(1024)
        checks["causal_1024"] = flash_agree("causal 4 x 1024", q2, k2, v2)[0]
        lens = torch.tensor([1024, 700, 129, 0], device=dev, dtype=torch.int32)
        offs = torch.tensor([0, 40, 0, 0], device=dev, dtype=torch.int32)
        checks["ragged_1024"] = flash_agree("ragged 4 x 1024", q2, k2, v2, q_offset=offs,
                                            kv_lengths=lens)[0]
        # chunked prefill (models/llama.py, prefill with offsets): a chunk of
        # 200 queries (not a multiple of the 64-row tile) after offsets of up
        # to 824 cached positions, keys up to offset + chunk length
        offs = torch.tensor([512, 300, 0, 824], device=dev, dtype=torch.int32)
        lens = offs + torch.tensor([200, 131, 77, 200], device=dev, dtype=torch.int32)
        checks["chunked"] = flash_agree("chunked", q2[:, :200].contiguous(), k2, v2, q_offset=offs,
                                        kv_lengths=lens)[0]
        # the engine's chunked prefill at phase 4's chunk: 512 queries at
        # offset 512 against the 1024 keys of the dense view
        qc = torch.randn(1, 512, hq, d, device=dev, generator=gen).to(bf)
        kc, vc = (torch.randn(1, 1024, hkv, d, device=dev, generator=gen).to(bf) for _ in range(2))
        offc = torch.tensor([512], device=dev, dtype=torch.int32)
        lenc = torch.tensor([1024], device=dev, dtype=torch.int32)
        checks["chunk_512_at_512"] = flash_agree("chunk 512 at 512", qc, kc, vc, q_offset=offc,
                                                 kv_lengths=lenc)[0]
        # speculative decoding's verify forward (Llama.verify_step, phase 4's
        # paged_spec): g + 1 = 5 queries a lane at each of the 8 live lanes'
        # lengths, against the dense view of its 17 pages (2176 keys)
        nv, gp1, view = 8, 5, 17 * page
        qv = torch.randn(nv, gp1, hq, d, device=dev, generator=gen).to(bf)
        kv, vv = (torch.randn(nv, view, hkv, d, device=dev, generator=gen).to(bf) for _ in range(2))
        offv = lengths[:nv].contiguous()
        lenv = offv + gp1
        checks["verify"] = flash_agree("verify", qv, kv, vv, q_offset=offv, kv_lengths=lenv)[0]
        # bound: the keys each lane attends read once (K and V), q and out, and
        # query i of a lane at length L attending L + i + 1 keys
        live = c["lengths_cpu"][:nv].long()
        keys, pairs = int((live + gp1).sum()), int((gp1 * live + gp1 * (gp1 + 1) // 2).sum())
        b_ms_v, b_by_v = bound_ms(2 * 2 * qv.numel() + 2 * keys * hkv * d * 2 + 2 * nv * 4,
                                  4 * hq * d * pairs)
        # yardstick only: SDPA with the rows' causal mask as a bool mask and
        # enable_gqa, on head-major views made outside the timed call
        verify_mask = (torch.arange(view, device=dev)[None, None, :]
                       <= (offv[:, None] + torch.arange(gp1, device=dev)[None, :])[:, :, None])
        qvh, kvh, vvh = (t.transpose(1, 2) for t in (qv, kv, vv))
        verify = {"shape": {"batch": nv, "queries": gp1, "offsets": offv.tolist(), "keys": view},
                  "bound_ms": b_ms_v, "bound_by": b_by_v,
                  **timing(lambda i: flash_attention(qv, kv, vv, causal=True, q_offset=offv,
                                                     kv_lengths=lenv),
                           lambda i: mha_attention_plain(qv, kv, vv, causal=True, q_offset=offv,
                                                         kv_lengths=lenv),
                           lambda i: F.scaled_dot_product_attention(
                               qvh, kvh, vvh, attn_mask=verify_mask[:, None], enable_gqa=True),
                           iters=50, plain_iters=5)}
        # query i at position 512 + i attends keys 0 .. 512 + i
        b_ms_c, b_by_c = bound_ms(2 * (2 * qc.numel() + 2 * kc.numel()),
                                  4 * hq * d * (512 * 513 + 512 * 511 // 2))
        # yardstick only: SDPA with the chunk's causal mask as a bool mask
        # and KV heads repeated, built outside the timed call
        chunk_mask = (torch.arange(1024, device=dev)[None, :]
                      <= 512 + torch.arange(512, device=dev)[:, None])
        qch = qc.transpose(1, 2)
        kch, vch = (t.transpose(1, 2).repeat_interleave(hq // hkv, dim=1) for t in (kc, vc))
        chunk = {"shape": {"batch": 1, "queries": 512, "offset": 512, "keys": 1024},
                 "bound_ms": b_ms_c, "bound_by": b_by_c,
                 **timing(lambda i: flash_attention(qc, kc, vc, causal=True, q_offset=offc,
                                                    kv_lengths=lenc),
                          lambda i: mha_attention_plain(qc, kc, vc, causal=True, q_offset=offc,
                                                        kv_lengths=lenc),
                          lambda i: F.scaled_dot_product_attention(qch, kch, vch,
                                                                   attn_mask=chunk_mask),
                          iters=50, plain_iters=5)}
        # the quality plane's teacher-forced forward (metrics/quality.py,
        # phase 4's quality runs): batch 1, a bucket of 2048 padded
        # positions, keys masked by the sequence's length (phase 4's
        # longest, 1024 + 64); every query row attends min(i + 1, length)
        # keys, the padded rows included
        tf = 1024 + 64
        qt = torch.randn(1, 2048, hq, d, device=dev, generator=gen).to(bf)
        kt, vt = (torch.randn(1, 2048, hkv, d, device=dev, generator=gen).to(bf) for _ in range(2))
        lent = torch.tensor([tf], device=dev, dtype=torch.int32)
        checks["teacher_forced_2048"] = flash_agree("teacher-forced 2048", qt, kt, vt,
                                                    kv_lengths=lent)[0]
        b_ms_t, b_by_t = bound_ms(2 * 2 * qt.numel() + 2 * tf * hkv * d * 2 + 4,
                                  4 * hq * d * (tf * (tf + 1) // 2 + (2048 - tf) * tf))
        # yardstick only: SDPA with the causal and length mask as a bool mask
        # and enable_gqa, on head-major views made outside the timed call
        pos = torch.arange(2048, device=dev)
        tf_mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] < tf)
        qth, kth, vth = (t.transpose(1, 2) for t in (qt, kt, vt))
        teacher = {"shape": {"batch": 1, "bucket": 2048, "kv_length": tf, "causal": True},
                   "bound_ms": b_ms_t, "bound_by": b_by_t,
                   **timing(lambda i: flash_attention(qt, kt, vt, causal=True, kv_lengths=lent),
                            lambda i: mha_attention_plain(qt, kt, vt, causal=True,
                                                          kv_lengths=lent),
                            lambda i: F.scaled_dot_product_attention(
                                qth, kth, vth, attn_mask=tf_mask, enable_gqa=True),
                            iters=20, plain_iters=3)}
        long = {"shape": {"batch": 4, "seq": 1024, "causal": True}, "bound_ms": b_ms_l,
                "bound_by": b_by_l,
                **timing(lambda i: flash_attention(q2, k2, v2, causal=True),
                         lambda i: mha_attention_plain(q2, k2, v2, causal=True), sdpa(q2, k2, v2),
                         iters=20, plain_iters=3)}
        return {
            "name": "flash_attention", "route": "cuda",
            "source": "gofr_tpu_torch/csrc/flash_attention.cu",
            "replaces": "gofr_tpu/ops/pallas/flash_attention.py:108",
            "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
            "rms_rel_err": max(c["rms_rel_err"] for c in checks.values()),
            "checks": checks,
            "tolerance": {"max_abs": flash_mod.MAX_ABS, "rms_rel": flash_mod.RMS_REL},
            **timing(lambda i: flash_attention(qf, kf, vf, causal=True),
                     lambda i: mha_attention_plain(qf, kf, vf, causal=True), sdpa(qf, kf, vf),
                     iters=20, plain_iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "seq_1024": long, "chunk_512_at_512": chunk,
            "verify_5_at_live": verify, "teacher_forced_2048": teacher,
            "shape": {"batch": 4, "seq": 512, "hq": hq, "hkv": hkv, "d": d, "causal": True},
        }

    def check_flash_d64() -> dict:  # C's head-dim-64 build: BERT-base's, ViT-L/16's, GPT-2's calls
        d64 = D64_SHAPES
        cpu_rng = torch.Generator().manual_seed(SEED + 5)

        def qkv(b: int, s: int, h: int) -> tuple:
            return tuple(torch.randn(b, s, h, 64, device=dev, generator=gen).to(bf) for _ in range(3))

        def agree64(label: str, qx, kx, vx, **kw) -> dict:
            got = flash_attention(qx, kx, vx, **kw)
            return agreement(f"flash_attention_d64 ({label})", got,
                             mha_attention_plain(qx, kx, vx, **kw), flash_mod), got

        checks = {}
        # configuration #1: a full BatchEngine step of BERT-base (batch bucket
        # 256, length bucket 64, 12 heads, keys masked by each request's
        # length), ragged lengths 8..64 and the padded rows the engine gives
        # length 1
        b, s, h = d64["bert"]["batch"], d64["bert"]["seq"], d64["bert"]["heads"]
        lens_cpu = torch.randint(8, s + 1, (b,), generator=cpu_rng, dtype=torch.int32)
        lens_cpu[-d64["bert"]["padded_rows"]:] = 1
        lens_b = lens_cpu.to(dev)
        qb, kb, vb = qkv(b, s, h)
        checks["bert"], _ = agree64("BERT", qb, kb, vb, causal=False, kv_lengths=lens_b)
        live = int(lens_cpu.sum())
        # q and out whole, K and V up to each row's length, the lengths; every
        # query attends its row's keys
        b_ms, b_by = bound_ms(2 * 2 * qb.numel() + 2 * live * h * 64 * 2 + b * 4,
                              4 * h * 64 * s * live)
        # yardstick only (never called by the port): SDPA with the length
        # mask as a bool mask, on head-major views made outside the timed call
        bert_mask = (torch.arange(s, device=dev)[None, :] < lens_b[:, None])[:, None, None, :]
        qbh, kbh, vbh = (t.transpose(1, 2) for t in (qb, kb, vb))
        # configuration #3: a batch of 32 ViT-L/16 images, 197 positions (the
        # last query and key tiles partial), 16 heads, no mask
        b, s, h = d64["vit"]["batch"], d64["vit"]["seq"], d64["vit"]["heads"]
        qv, kv, vv = qkv(b, s, h)
        checks["vit"], _ = agree64("ViT", qv, kv, vv, causal=False)
        v_ms, v_by = bound_ms(4 * 2 * qv.numel(), 4 * h * 64 * s * s * b)
        qvh, kvh, vvh = (t.transpose(1, 2) for t in (qv, kv, vv))
        vit = {"shape": d64["vit"], "bound_ms": v_ms, "bound_by": v_by,
               **timing(lambda i: flash_attention(qv, kv, vv, causal=False),
                        lambda i: mha_attention_plain(qv, kv, vv, causal=False),
                        lambda i: F.scaled_dot_product_attention(qvh, kvh, vvh),
                        iters=50, plain_iters=5)}
        # GPT-2's causal prefill (the next family), 4 x 512 at 12 heads: full,
        # and ragged with offsets and a fully masked row
        b, s, h = d64["gpt2"]["batch"], d64["gpt2"]["seq"], d64["gpt2"]["heads"]
        qg, kg, vg = qkv(b, s, h)
        checks["gpt2_causal"], _ = agree64("GPT-2 causal", qg, kg, vg, causal=True)
        lens = torch.tensor([512, 300, 77, 0], device=dev, dtype=torch.int32)
        offs = torch.tensor([0, 40, 0, 0], device=dev, dtype=torch.int32)
        checks["gpt2_ragged"], got_r = agree64("GPT-2 ragged", qg, kg, vg, causal=True,
                                               q_offset=offs, kv_lengths=lens)
        require(torch.all(got_r[3] == 0).item(), "flash_attention_d64: fully masked rows are not zero")
        # GPT-2's chunked prefill in phase 4 (buckets 128/256/512): a chunk of
        # 512 queries at offset 256 against the 768 keys of the slot's view
        ch = d64["gpt2_chunk"]
        c_gen = torch.Generator(device=dev).manual_seed(SEED + 10)
        sq, off, h = ch["queries"], ch["offset"], ch["heads"]
        qc = torch.randn(1, sq, h, 64, device=dev, generator=c_gen).to(bf)
        kc, vc = (torch.randn(1, off + sq, h, 64, device=dev, generator=c_gen).to(bf) for _ in range(2))
        offc = torch.tensor([off], device=dev, dtype=torch.int32)
        lenc = torch.tensor([off + sq], device=dev, dtype=torch.int32)
        checks["gpt2_chunk_512_at_256"], _ = agree64("GPT-2 chunk 512 at 256", qc, kc, vc,
                                                     causal=True, q_offset=offc, kv_lengths=lenc)
        # query i at position off + i attends keys 0 .. off + i
        c_ms, c_by = bound_ms(2 * (2 * qc.numel() + 2 * kc.numel()),
                              4 * h * 64 * (sq * off + sq * (sq + 1) // 2))
        chunk_mask = (torch.arange(off + sq, device=dev)[None, :]
                      <= off + torch.arange(sq, device=dev)[:, None])
        qch, kch, vch = (t.transpose(1, 2) for t in (qc, kc, vc))
        gpt2_chunk = {"shape": ch, "bound_ms": c_ms, "bound_by": c_by,
                      **timing(lambda i: flash_attention(qc, kc, vc, causal=True, q_offset=offc,
                                                         kv_lengths=lenc),
                               lambda i: mha_attention_plain(qc, kc, vc, causal=True, q_offset=offc,
                                                             kv_lengths=lenc),
                               lambda i: F.scaled_dot_product_attention(qch, kch, vch,
                                                                        attn_mask=chunk_mask),
                               iters=50, plain_iters=5)}
        return {
            "name": "flash_attention_d64", "route": "cuda",
            "source": "gofr_tpu_torch/csrc/flash_attention.cu",
            "replaces": "gofr_tpu/ops/pallas/flash_attention.py:108",
            "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
            "rms_rel_err": max(c["rms_rel_err"] for c in checks.values()),
            "checks": checks,
            "tolerance": {"max_abs": flash_mod.MAX_ABS, "rms_rel": flash_mod.RMS_REL},
            **timing(lambda i: flash_attention(qb, kb, vb, causal=False, kv_lengths=lens_b),
                     lambda i: mha_attention_plain(qb, kb, vb, causal=False, kv_lengths=lens_b),
                     lambda i: F.scaled_dot_product_attention(qbh, kbh, vbh, attn_mask=bert_mask),
                     iters=50, plain_iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "vit_197": vit,
            "gpt2_chunk_512_at_256": gpt2_chunk,
            "shape": {**d64["bert"], "d": 64, "causal": False,
                      "kv_lengths": {"min": int(lens_cpu.min()), "max": int(lens_cpu.max()),
                                     "live_keys": live}},
        }

    def check_decode_q(bits: int, d64: bool = False) -> dict:  # D (int8) and E (int4)
        """D or E at Llama-3-8B's step, or (``d64``) its 64 build at Llama
        one_b's (``_d64_case``)."""
        op, mod, plain, replaces = (
            ("paged_decode_q", decode_q_mod, paged_decode_attention_q_plain,
             "gofr_tpu/ops/pallas/paged_decode.py:195")
            if bits == 8 else
            ("paged_decode_q4", decode_q4_mod, paged_decode_attention_q4_plain,
             "gofr_tpu/ops/pallas/paged_decode.py:314"))
        name = op + ("_d64" if d64 else "")
        launch = getattr(mod, name)
        qx, cache, kv_heads = ((q1b, dc["pools_one_b"][bits], hkv1b) if d64
                               else (q, c["pools"][bits], hkv))
        hqx, dim = qx.shape[1], qx.shape[2]

        def args(layer: int) -> tuple:
            return (qx, cache.k[layer], cache.v[layer], cache.ks[layer], cache.vs[layer], table,
                    lengths)

        got, want = launch(*args(0)), plain(*args(0))
        agree = agreement(name, got, want, mod)
        require(torch.all(got[c["lengths_cpu"] == 0] == 0).item(), f"{name}: empty slots not zero")
        # the split's edges (edge_case); the split's plain version keeps p * vs
        # in f32 as the kernel does
        r, splits, edges, edge_table = edge_case(cache.k.shape[1], table.shape[1], kv_heads)
        edge_args = (*args(0)[:5], edge_table, edges)
        got_e = launch(*edge_args)
        agree_e = agreement(f"{name} (split boundaries)", got_e,
                            paged_decode_attention_q_split_plain(*edge_args, r, bits=bits), mod)
        require(torch.all(got_e[5] == 0).item(), f"{name}: the empty slot is not zero")
        # K and V rows of D (int8) or D/2 (packed) bytes plus two bf16 scales
        row_bytes = 2 * cache.k.shape[-1] + 2 * 2
        io = 2 * qx.numel() * 2 + table.numel() * 4 + n * 4
        b_ms, b_by = bound_ms(c["live"] * kv_heads * row_bytes + io, 4 * c["live"] * hqx * dim)
        return {
            "name": name, "route": "cuda", "source": "gofr_tpu_torch/csrc/paged_decode_q.cu",
            "replaces": replaces,
            "max_abs_err": max(a["max_abs_err"] for a in (agree, agree_e)),
            "rms_rel_err": max(a["rms_rel_err"] for a in (agree, agree_e)),
            "checks": {"ragged": agree, "split_boundaries": agree_e},
            "split": {"split_rows": r, "splits": splits},
            "plans": plan_holds(
                op, mod, lambda i: launch(*args(i % layers)),
                lambda rows: paged_decode_attention_q_split_plain(*args(0), rows, bits=bits),
                table.shape[1] * page, (n, hqx, kv_heads, dim, page, table.shape[1],
                                        cache.k.shape[1],
                                        decode_q_mod.pin_dtype("int8" if bits == 8 else "int4",
                                                               qx.dtype)),
                qx=qx, kv_heads=kv_heads),
            "tolerance": {"max_abs": mod.MAX_ABS, "rms_rel": mod.RMS_REL},
            # no one PyTorch call computes attention over quantized rows
            **timing(lambda i: launch(*args(i % layers)), lambda i: plain(*args(i % layers))),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {**(one_b_shape if d64 else decode_shape), "kv_bits": bits},
        }

    sc = _slot_case(torch, c)
    smax, sk, sv = sc["smax"], sc["k"], sc["v"]
    slot_shape = {**{k: v for k, v in decode_shape.items() if k != "page"}, "smax": smax}

    def check_slot_decode() -> dict:  # F: the slot cache's decode attention
        slot_decode = slot_decode_mod.decode_attention
        got = slot_decode(q, sk[0], sv[0], lengths)
        agree = agreement("decode_attention", got, decode_attention_plain(q, sk[0], sv[0], lengths),
                          slot_decode_mod)
        require(torch.all(got[c["lengths_cpu"] == 0] == 0).item(), "decode_attention: empty slots not zero")
        # lane 0 past the slot, as an idle engine lane asks for cache_len + 1 + k:
        # the kernel clamps it to the slot, the plain version attends the whole slot
        over = lengths.clone()
        over[0] = smax + 5
        got_o = slot_decode(q, sk[0], sv[0], over)
        want_o = decode_attention_plain(q, sk[0], sv[0], over)
        agree_o = agreement("decode_attention (length past the slot)", got_o[:1], want_o[:1],
                            slot_decode_mod)
        # the split's edges: on and one past the first three split
        # boundaries, the whole slot, the empty slot, past the slot. Lanes
        # this short have outputs up to ~0.9, where the plain version's bf16
        # scores alone move an output by up to two bf16 ulps (7.8e-3 between
        # the two plain versions, past MAX_ABS); so they are held against the
        # split's plain version, which takes the scores in f32 and splits as
        # the kernel does
        rows_per_split, splits = slot_decode_mod.split_plan(n, hkv, smax)
        r = rows_per_split
        edges = torch.tensor([r, r + 1, 2 * r, 2 * r + 1, smax, 0, smax + 5, 3 * r, 3 * r + 1],
                             device=dev, dtype=torch.int32)
        got_e = slot_decode(q, sk[0], sv[0], edges)
        agree_e = agreement("decode_attention (split boundaries)", got_e,
                            decode_attention_split_plain(q, sk[0], sv[0], edges, r), slot_decode_mod)
        require(torch.all(got_e[5] == 0).item(), "decode_attention: the empty slot is not zero")
        b_ms, b_by = bound_ms(c["live"] * hkv * d * 2 * 2 + 2 * q.numel() * 2 + n * 4,
                              4 * c["live"] * hq * d)
        # yardstick only (never called by the port): SDPA with a length mask
        # built outside the timed call; it returns NaN for the empty slot
        mask = (torch.arange(smax, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        q1 = q[:, :, None]
        return {
            "name": "decode_attention", "route": "cuda", "source": "gofr_tpu_torch/csrc/paged_decode.cu",
            "replaces": "gofr_tpu/ops/pallas/decode_attention.py:85",
            "max_abs_err": max(a["max_abs_err"] for a in (agree, agree_o, agree_e)),
            "rms_rel_err": max(a["rms_rel_err"] for a in (agree, agree_o, agree_e)),
            "checks": {"ragged": agree, "past_the_slot": agree_o, "split_boundaries": agree_e},
            "split": {"split_rows": rows_per_split, "splits": splits},
            "plans": plan_holds(
                "decode", slot_decode_mod,
                lambda i: slot_decode(q, sk[i % layers], sv[i % layers], lengths),
                lambda rows: decode_attention_split_plain(q, sk[0], sv[0], lengths, rows),
                smax, (n, hq, hkv, d, smax, "bfloat16")),
            "tolerance": {"max_abs": slot_decode_mod.MAX_ABS, "rms_rel": slot_decode_mod.RMS_REL},
            **timing(lambda i: slot_decode(q, sk[i % layers], sv[i % layers], lengths),
                     lambda i: decode_attention_plain(q, sk[i % layers], sv[i % layers], lengths),
                     lambda i: F.scaled_dot_product_attention(q1, sk[i % layers], sv[i % layers],
                                                              attn_mask=mask, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by, "shape": slot_shape,
        }

    # -- the appends: B, G and the quantizing B-q, B-q4, G-q, bit-exact ----------------
    rows_gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    pool_pages = k_pool.shape[1]
    table_cpu = table.cpu()

    def append_rows(kv_heads: int = hkv, dim: int = d, dtype=bf) -> tuple:
        """k_new, v_new [N, Hkv, D] bf16 (or ``dtype``), rows of max |x|
        0.01..30; lane 4 all zero (codes 0, scale bf16(1e-8 / qmax)) and
        lane 5 a row whose max |x| is one element (its code reaches +-qmax),
        in the row's first half on K and its second half on V, the sign
        alternating by head."""
        mag = torch.rand(2, n, kv_heads, 1, device=dev, generator=rows_gen) * 30 + 0.01
        k_new, v_new = (torch.randn(2, n, kv_heads, dim, device=dev, generator=rows_gen)
                        * mag).to(dtype)
        for new, half in ((k_new, 0), (v_new, dim // 2)):
            new[4] = 0
            new[5] *= 1e-3
            for h in range(kv_heads):
                new[5, h, half + (h * 37) % (dim // 2)] = (1 + h) * (-1) ** h
        return k_new, v_new

    def pool_edges(pool: int) -> tuple:
        """(positions, table) on the card and on the CPU for the pool appends'
        edge lanes: 0, 3, 4, 5 live at their length; 1 at -1; 2 at MaxP x page,
        past the table (lane 3's first entry, which a fault that forgets the
        drop would read, is a live page); 6 through an OOB entry (== P); 7
        through a negative entry; 8, the empty slot, at 0 through its all-OOB
        row."""
        pos = c["lengths_cpu"].clone()
        pos[1], pos[2] = -1, table.shape[1] * page
        etable = table_cpu.clone()
        etable[6, int(pos[6]) // page], etable[7, int(pos[7]) // page] = pool, -1
        return pos.to(dev), etable.to(dev), pos, etable

    def kept_pool(pos, tbl, pool: int) -> int:
        """Lanes the pool appends write (the drop rule, on the CPU)."""
        logical = pos.long() // page
        entry = tbl.long().gather(1, logical.clamp(0, tbl.shape[1] - 1)[:, None])[:, 0]
        return int(((pos >= 0) & (logical < tbl.shape[1]) & (entry >= 0) & (entry < pool)).sum())

    def same_bits(got, want) -> bool:
        return all(torch.equal(*(t.view(torch.int16) if t.dtype == bf else t for t in pair))
                   for pair in zip(got, want))

    def check_edge_rows(name: str, values, scales, qmax: int, where) -> None:
        """Lane 4 (all zero) stored as codes 0 with scale bf16(1e-8 / qmax),
        lane 5 (one element holds the max) reaching +-qmax in every head, on
        both planes; ``where(lane)`` indexes the lane's stored row."""
        zero_scale = (torch.tensor(1e-8) / qmax).to(bf).view(torch.int16).item()
        for vals, sc in zip(values, scales):
            codes = {lane: vals[where(lane)] for lane in (4, 5)}
            if vals.dtype == torch.uint8:
                codes = {lane: unpack_int4(x) for lane, x in codes.items()}
            require(torch.all(codes[4] == 0).item()
                    and torch.all(sc[where(4)].view(torch.int16) == zero_scale).item(),
                    f"{name}: an all-zero row is not stored as codes 0 with scale bf16(1e-8/{qmax})")
            require(torch.all(codes[5].abs().amax(dim=-1) == qmax).item(),
                    f"{name}: a row's single largest element does not reach +-{qmax}")

    def append_entry(name: str, source: str, replaces: str, timed_fns: tuple, n_bytes: float,
                     shape: dict) -> dict:
        b_ms, b_by = bound_ms(n_bytes, 0)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "max_abs_err": 0.0, "tolerance": "bit-exact, values and scales",
                **timing(*timed_fns, iters=200, plain_iters=50),
                "bound_ms": b_ms, "bound_by": b_by, "shape": shape}

    append_src = "gofr_tpu_torch/csrc/kv_append.cu"
    append_shape = {"slots": n, "hkv": hkv, "d": d, "page": page}
    kept_timed = kept_pool(c["lengths_cpu"], table_cpu, pool_pages)
    # the table entries the timed pool appends read: one per lane whose
    # position lies in [0, MaxP x page)
    entries_timed = int(((c["lengths_cpu"] >= 0) & (c["lengths_cpu"] < table.shape[1] * page)).sum())

    def append_bytes(entries: int, kept: int, row_out: int, scale: int, kv_heads: int = hkv,
                     dim: int = d, row_in: int | None = None) -> int:
        """What an append must move: the N positions, ``entries`` table
        entries, and for each of the ``kept`` lanes' Hkv rows of both planes
        the row read (``row_in`` bytes, a bf16 row's by default) and the
        ``row_out``-byte row and ``scale``-byte scale written (a dropped
        lane's row need not be read)."""
        row_in = dim * 2 if row_in is None else row_in
        return n * 4 + entries * 4 + 2 * kept * kv_heads * (row_in + row_out + scale)

    def check_kv_append() -> dict:  # B
        k_new, v_new = append_rows()
        pos, etable, _, _ = pool_edges(pool_pages)
        got = [k_pool[0].clone(), v_pool[0].clone()]
        want = [t.clone() for t in got]
        kv_append(*got, etable, pos, k_new, v_new)
        append_tokens_paged_plain(*want, etable, pos, k_new, v_new)
        require(same_bits(got, want), "kv_append pool differs from the plain write")
        require(not torch.equal(got[0], k_pool[0]) and not torch.equal(got[1], v_pool[0]),
                "kv_append wrote nothing")
        del got, want
        return append_entry(
            "kv_append", append_src, "gofr_tpu/ops/pallas/kv_append.py:110",
            (lambda i: kv_append(k_pool[i % layers], v_pool[i % layers], table, lengths, k_new, v_new),
             lambda i: append_tokens_paged_plain(k_pool[i % layers], v_pool[i % layers], table, lengths,
                                                 k_new, v_new)),
            append_bytes(entries_timed, kept_timed, d * 2, 0), append_shape)

    def check_append_q(bits: int, d64: bool = False, f32_rows: bool = False) -> dict:
        """B-q (int8) or B-q4 (int4) at Llama-3-8B's step, or (``d64``) its
        64 build at Llama one_b's, on bf16 rows or (the ``f32_rows``
        builds, an f32 model's) f32 rows; layer 0 of a two-layer copy, held
        whole, so a write off its slice lands in layer 1 and is seen
        there."""
        base, plain, qmax = (("kv_append_q", append_tokens_paged_q, 127) if bits == 8 else
                             ("kv_append_q4", append_tokens_paged_q4, 7))
        name = base + ("_d64" if d64 else "") + ("_f32" if f32_rows else "")
        launch = getattr(append_mod, name)
        cache, kv_heads, dim = ((dc["pools_one_b"][bits], hkv1b, 64) if d64
                                else (c["pools"][bits], hkv, d))
        k_new, v_new = append_rows(kv_heads, dim, f32 if f32_rows else bf)
        pos, etable, pos_cpu, etable_cpu = pool_edges(cache.k.shape[1])
        got = [t[:2].clone() for t in (cache.k, cache.v, cache.ks, cache.vs)]
        want = [t.clone() for t in got]
        launch(*(t[0] for t in got), etable, pos, k_new, v_new)
        for values, scales, new in ((want[0], want[2], k_new), (want[1], want[3], v_new)):
            plain(values[0], scales[0], etable, pos, new)
        require(same_bits(got, want), f"{name} differs from the plain append (values or scales)")
        require(not torch.equal(got[0][0], cache.k[0]), f"{name} wrote nothing")
        check_edge_rows(name, [t[0] for t in got[:2]], [t[0] for t in got[2:]], qmax,
                        lambda lane: (int(etable_cpu[lane, int(pos_cpu[lane]) // page]), slice(None),
                                      int(pos_cpu[lane]) % page))
        del got, want

        def planes(i: int) -> tuple:
            return cache.k[i % layers], cache.v[i % layers], cache.ks[i % layers], cache.vs[i % layers]

        def plain_both(i: int) -> None:
            kq, vq, ks, vs = planes(i)
            plain(kq, ks, table, lengths, k_new)
            plain(vq, vs, table, lengths, v_new)

        return append_entry(
            name, append_src, "port-only (XLA in JAX: gofr_tpu/ops/paged.py:"
                              f"{344 if bits == 8 else 438})",
            (lambda i: launch(*planes(i), table, lengths, k_new, v_new), plain_both),
            append_bytes(entries_timed, kept_timed, cache.k.shape[-1], 2, kv_heads, dim,
                         row_in=dim * k_new.element_size()),
            {**append_shape, "hkv": kv_heads, "d": dim, "kv_bits": bits,
             "rows": "f32" if f32_rows else "bf16"})

    def slot_edges() -> torch.Tensor:
        """Positions of the slot appends' edge lanes: 0 at Smax, 1 at -1, 2 at
        Smax + 7 (dropped), the others live at their length (8, the empty
        slot, at 0)."""
        pos = lengths.clone()
        pos[0], pos[1], pos[2] = smax, -1, smax + 7
        return pos

    kept_slot = int(((c["lengths_cpu"] >= 0) & (c["lengths_cpu"] < smax)).sum())
    slot_append_shape = {"slots": n, "hkv": hkv, "d": d, "smax": smax}

    def check_kv_append_slot() -> dict:  # G
        k_new, v_new = append_rows()
        pos = slot_edges()
        got = [sk[0].clone(), sv[0].clone()]
        want = [t.clone() for t in got]
        kv_append_slot(*got, pos, k_new, v_new)
        append_tokens_plain(*want, pos, k_new, v_new)
        require(same_bits(got, want), "kv_append_slot cache differs from the plain write")
        require(all(torch.equal(a[i], b[0][i]) for a, b in zip(got, (sk, sv)) for i in (0, 1, 2)),
                "kv_append_slot wrote a lane whose position lies outside the slot")
        require(not torch.equal(got[0], sk[0]), "kv_append_slot wrote nothing")
        del got, want
        return append_entry(
            "kv_append_slot", append_src, "gofr_tpu/ops/pallas/kv_append.py:61",
            (lambda i: kv_append_slot(sk[i % layers], sv[i % layers], lengths, k_new, v_new),
             lambda i: append_tokens_plain(sk[i % layers], sv[i % layers], lengths, k_new, v_new)),
            append_bytes(0, kept_slot, d * 2, 0), slot_append_shape)

    def check_append_slot_q(d64: bool = False, f32_rows: bool = False) -> dict:  # G-q
        """G-q at Llama-3-8B's step (``_slot_case``'s 9 lanes of Smax 2176),
        or (``d64``) its 64 build on an 8 x 1024 slot cache of Llama one_b's
        KV heads at ``_d64_case``'s GPT-2 lengths, on bf16 rows or (the
        ``f32_rows`` build, an f32 model's) f32 rows; layer 0 of a two-layer
        copy, held whole."""
        name = "kv_append_slot_q" + ("_d64" if d64 else "") + ("_f32" if f32_rows else "")
        launch = getattr(append_mod, name)
        if d64:
            lanes, smax_q, kv_heads, dim, live = 8, gsmax, hkv1b, 64, glen[:8]
        else:
            lanes, smax_q, kv_heads, dim, live = n, smax, hkv, d, lengths
        cache = QSlotKVCache.create(layers, lanes, smax_q, kv_heads, dim, device=dev)
        k_new, v_new = (t[:lanes].contiguous()
                        for t in append_rows(kv_heads, dim, f32 if f32_rows else bf))
        # lane 0 at Smax, 1 at -1, 2 at Smax + 7 (dropped), the others live
        pos = live.clone()
        pos[0], pos[1], pos[2] = smax_q, -1, smax_q + 7
        pos_cpu = pos.cpu()
        got = [t[:2].clone() for t in (cache.k, cache.v, cache.ks, cache.vs)]
        want = [t.clone() for t in got]
        launch(*(t[0] for t in got), pos, k_new, v_new)
        for values, scales, new in ((want[0], want[2], k_new), (want[1], want[3], v_new)):
            append_tokens_q(values[0], scales[0], pos, new)
        require(same_bits(got, want), f"{name} differs from the plain append (values or scales)")
        require(not torch.equal(got[0][0], cache.k[0]), f"{name} wrote nothing")
        check_edge_rows(name, [t[0] for t in got[:2]], [t[0] for t in got[2:]], 127,
                        lambda lane: (lane, slice(None), int(pos_cpu[lane])))
        del got, want

        def planes(i: int) -> tuple:
            return cache.k[i % layers], cache.v[i % layers], cache.ks[i % layers], cache.vs[i % layers]

        def plain_both(i: int) -> None:
            kq, vq, ks, vs = planes(i)
            append_tokens_q(kq, ks, live, k_new)
            append_tokens_q(vq, vs, live, v_new)

        live_cpu = live.cpu()
        kept = int(((live_cpu >= 0) & (live_cpu < smax_q)).sum())
        return append_entry(
            name, append_src, "port-only (XLA in JAX: gofr_tpu/ops/kvcache.py:132)",
            (lambda i: launch(*planes(i), live, k_new, v_new), plain_both),
            lanes * 4 + 2 * kept * kv_heads * (dim * k_new.element_size() + dim + 2),
            {"slots": lanes, "hkv": kv_heads, "d": dim, "smax": smax_q, "kv_bits": 8,
             "rows": "f32" if f32_rows else "bf16"})

    # -- the head-dim-64 builds: A and B at Llama one_b's decode step, F and G
    # at GPT-2 small's (``_d64_case``) ------------------------------------------------
    dc = _d64_case(torch, c)
    q1b, k1b, v1b, hkv1b = dc["q_one_b"], dc["k_one_b"], dc["v_one_b"], dc["hkv_one_b"]
    qg, gk, gv, glen, glen_cpu = (dc[k] for k in ("q_gpt2", "k_gpt2", "v_gpt2", "lengths_gpt2",
                                                  "lengths_gpt2_cpu"))
    gsmax, hg = gk.shape[3], qg.shape[1]
    live_g = int(glen_cpu.sum())
    one_b_shape = {**decode_shape, "hq": q1b.shape[1], "hkv": hkv1b, "d": 64}
    gpt2_shape = {"slots": n, "hq": hg, "hkv": hg, "d": 64, "smax": gsmax,
                  "lengths": glen_cpu.tolist()}

    def check_paged_decode_d64() -> dict:  # A's 64 build (Llama one_b)
        hq1b = q1b.shape[1]
        got = paged_decode_d64(q1b, k1b[0], v1b[0], table, lengths)
        agree = agreement("paged_decode_d64", got,
                          paged_decode_attention_plain(q1b, k1b[0], v1b[0], table, lengths), decode_mod)
        require(torch.all(got[c["lengths_cpu"] == 0] == 0).item(),
                "paged_decode_d64: empty slots not zero")
        r, splits, edges, edge_table = edge_case(k1b.shape[1], table.shape[1], hkv1b)
        got_e = paged_decode_d64(q1b, k1b[0], v1b[0], edge_table, edges)
        agree_e = agreement("paged_decode_d64 (split boundaries)", got_e,
                            paged_decode_attention_split_plain(q1b, k1b[0], v1b[0], edge_table,
                                                               edges, r), decode_mod)
        require(torch.all(got_e[5] == 0).item(), "paged_decode_d64: the empty slot is not zero")
        io = 2 * q1b.numel() * 2 + table.numel() * 4 + n * 4
        b_ms, b_by = bound_ms(c["live"] * hkv1b * 64 * 2 * 2 + io, 4 * c["live"] * hq1b * 64)
        # yardstick only (never called by the port): SDPA with a length mask
        # and enable_gqa on each layer's view, gathered outside the timed call
        views = ([gather_kv(k1b[layer], v1b[layer], table) for layer in range(layers)]
                 if timed else [])
        mask = (torch.arange(table.shape[1] * page, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        q1 = q1b[:, :, None]
        return {
            "name": "paged_decode_d64", "route": "cuda",
            "source": "gofr_tpu_torch/csrc/paged_decode_q.cu",
            "replaces": "gofr_tpu/ops/pallas/paged_decode.py:94",
            "max_abs_err": max(a["max_abs_err"] for a in (agree, agree_e)),
            "rms_rel_err": max(a["rms_rel_err"] for a in (agree, agree_e)),
            "checks": {"ragged": agree, "split_boundaries": agree_e},
            "split": {"split_rows": r, "splits": splits},
            "plans": plan_holds(
                "paged_decode", decode_mod,
                lambda i: paged_decode_d64(q1b, k1b[i % layers], v1b[i % layers], table, lengths),
                lambda rows: paged_decode_attention_split_plain(q1b, k1b[0], v1b[0], table,
                                                                lengths, rows),
                table.shape[1] * page,
                (n, hq1b, hkv1b, 64, page, table.shape[1], k1b.shape[1], "bfloat16"),
                qx=q1b, kv_heads=hkv1b),
            "tolerance": {"max_abs": decode_mod.MAX_ABS, "rms_rel": decode_mod.RMS_REL},
            **timing(lambda i: paged_decode_d64(q1b, k1b[i % layers], v1b[i % layers], table,
                                                lengths),
                     lambda i: paged_decode_attention_plain(q1b, k1b[i % layers], v1b[i % layers],
                                                            table, lengths),
                     lambda i: F.scaled_dot_product_attention(q1, *views[i % layers], attn_mask=mask,
                                                              enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by, "shape": one_b_shape,
        }

    def check_kv_append_d64() -> dict:  # B's 64 build (Llama one_b)
        k_new, v_new = append_rows(hkv1b, 64)
        pos, etable, _, _ = pool_edges(pool_pages)
        # layer 0 of a two-layer copy, held whole: a write off its slice
        # lands in layer 1 and is seen there
        got = [k1b[:2].clone(), v1b[:2].clone()]
        want = [t.clone() for t in got]
        kv_append_d64(got[0][0], got[1][0], etable, pos, k_new, v_new)
        append_tokens_paged_plain(want[0][0], want[1][0], etable, pos, k_new, v_new)
        require(same_bits(got, want), "kv_append_d64 pool differs from the plain write")
        require(not torch.equal(got[0][0], k1b[0]), "kv_append_d64 wrote nothing")
        del got, want
        return append_entry(
            "kv_append_d64", append_src, "gofr_tpu/ops/pallas/kv_append.py:110",
            (lambda i: kv_append_d64(k1b[i % layers], v1b[i % layers], table, lengths, k_new, v_new),
             lambda i: append_tokens_paged_plain(k1b[i % layers], v1b[i % layers], table, lengths,
                                                 k_new, v_new)),
            append_bytes(entries_timed, kept_timed, 64 * 2, 0, hkv1b, 64),
            {**append_shape, "hkv": hkv1b, "d": 64})

    def check_slot_decode_d64() -> dict:  # F's 64 build (GPT-2)
        got = slot_decode_mod.decode_attention_d64(qg, gk[0], gv[0], glen)
        agree = agreement("decode_attention_d64", got,
                          decode_attention_plain(qg, gk[0], gv[0], glen), slot_decode_mod)
        require(torch.all(got[glen_cpu == 0] == 0).item(), "decode_attention_d64: empty slots not zero")
        over = glen.clone()
        over[0] = gsmax + 5
        agree_o = agreement("decode_attention_d64 (length past the slot)",
                            slot_decode_mod.decode_attention_d64(qg, gk[0], gv[0], over)[:1],
                            decode_attention_plain(qg, gk[0], gv[0], over)[:1], slot_decode_mod)
        r, splits = slot_decode_mod.split_plan(n, hg, gsmax)
        edges = torch.tensor([r, r + 1, 2 * r, 2 * r + 1, gsmax, 0, gsmax + 5, 3 * r, 3 * r + 1],
                             device=dev, dtype=torch.int32)
        got_e = slot_decode_mod.decode_attention_d64(qg, gk[0], gv[0], edges)
        agree_e = agreement("decode_attention_d64 (split boundaries)", got_e,
                            decode_attention_split_plain(qg, gk[0], gv[0], edges, r), slot_decode_mod)
        require(torch.all(got_e[5] == 0).item(), "decode_attention_d64: the empty slot is not zero")
        b_ms, b_by = bound_ms(live_g * hg * 64 * 2 * 2 + 2 * qg.numel() * 2 + n * 4,
                              4 * live_g * hg * 64)
        # yardstick only (never called by the port): SDPA with a length mask
        mask = (torch.arange(gsmax, device=dev)[None, :] < glen[:, None])[:, None, None, :]
        q1 = qg[:, :, None]
        launch = slot_decode_mod.decode_attention_d64
        return {
            "name": "decode_attention_d64", "route": "cuda",
            "source": "gofr_tpu_torch/csrc/paged_decode.cu",
            "replaces": "gofr_tpu/ops/pallas/decode_attention.py:85",
            "max_abs_err": max(a["max_abs_err"] for a in (agree, agree_o, agree_e)),
            "rms_rel_err": max(a["rms_rel_err"] for a in (agree, agree_o, agree_e)),
            "checks": {"ragged": agree, "past_the_slot": agree_o, "split_boundaries": agree_e},
            "split": {"split_rows": r, "splits": splits},
            "plans": plan_holds(
                "decode", slot_decode_mod,
                lambda i: launch(qg, gk[i % layers], gv[i % layers], glen),
                lambda rows: decode_attention_split_plain(qg, gk[0], gv[0], glen, rows),
                gsmax, (n, hg, hg, 64, gsmax, "bfloat16"), qx=qg, kv_heads=hg),
            "tolerance": {"max_abs": slot_decode_mod.MAX_ABS, "rms_rel": slot_decode_mod.RMS_REL},
            **timing(lambda i: launch(qg, gk[i % layers], gv[i % layers], glen),
                     lambda i: decode_attention_plain(qg, gk[i % layers], gv[i % layers], glen),
                     lambda i: F.scaled_dot_product_attention(q1, gk[i % layers], gv[i % layers],
                                                              attn_mask=mask, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by, "shape": gpt2_shape,
        }

    kept_g = int(((glen_cpu >= 0) & (glen_cpu < gsmax)).sum())

    def check_kv_append_slot_d64() -> dict:  # G's 64 build (GPT-2)
        k_new, v_new = append_rows(hg, 64)
        pos = glen.clone()
        pos[0], pos[1], pos[2] = gsmax, -1, gsmax + 7
        got = [gk[:2].clone(), gv[:2].clone()]
        want = [t.clone() for t in got]
        kv_append_slot_d64(got[0][0], got[1][0], pos, k_new, v_new)
        append_tokens_plain(want[0][0], want[1][0], pos, k_new, v_new)
        require(same_bits(got, want), "kv_append_slot_d64 cache differs from the plain write")
        require(all(torch.equal(a[0][i], b[0][i]) for a, b in zip(got, (gk, gv)) for i in (0, 1, 2)),
                "kv_append_slot_d64 wrote a lane whose position lies outside the slot")
        require(not torch.equal(got[0][0], gk[0]), "kv_append_slot_d64 wrote nothing")
        del got, want
        return append_entry(
            "kv_append_slot_d64", append_src, "gofr_tpu/ops/pallas/kv_append.py:61",
            (lambda i: kv_append_slot_d64(gk[i % layers], gv[i % layers], glen, k_new, v_new),
             lambda i: append_tokens_plain(gk[i % layers], gv[i % layers], glen, k_new, v_new)),
            append_bytes(0, kept_g, 64 * 2, 0, hg, 64),
            {"slots": n, "hkv": hg, "d": 64, "smax": gsmax})

    # -- the f32 builds of C, F and G (the f32 models in their own dtype: GPT-2
    # small, BERT-base and ViT-L/16 at head dim 64, Llama at 128 on the slot
    # cache): unit-scale inputs drawn in f32 (values rounded to bf16 would
    # leave the 3xTF32 split's lo terms 0 and hide a dropped lo product),
    # held to the launchers' f32 limits (``F32``) against the f32 plain
    # versions, whose products run in full f32 (allow_tf32 False). The
    # bounds count f32 bytes, and C's operations at the TF32 peak over
    # three, F's at the f32 peak of the CUDA cores.
    g32 = torch.Generator(device=dev).manual_seed(SEED + 21)

    def randn32(*shape):
        return torch.randn(*shape, device=dev, generator=g32, dtype=f32)

    def flash32_agree(label: str, qx, kx, vx, **kw) -> tuple:
        """(agreement of C's f32 build with the f32 plain version, the
        kernel's output, which must be f32)."""
        got = flash_attention(qx, kx, vx, **kw)
        require(got.dtype == f32, f"{label}: the output is {got.dtype}, not f32")
        return agreement(label, got, mha_attention_plain(qx, kx, vx, **kw), flash_mod.F32), got

    def flash32_timed(qx, kx, vx, n_bytes: float, pairs: int, library, iters: int = 20,
                      plain_iters: int = 3, **kw) -> dict:
        """An f32 C call timed beside its plain version and ``library``,
        with its bound: ``n_bytes``, and 4 x Hq x D operations for each of
        the ``pairs`` (query, key) pairs it attends at the 3xTF32 peak."""
        b_ms, b_by = bound_ms(n_bytes, 4 * qx.shape[2] * qx.shape[3] * pairs, H100_SXM_TF32X3_FLOPS)
        return {"bound_ms": b_ms, "bound_by": b_by,
                **timing(lambda i: flash_attention(qx, kx, vx, **kw),
                         lambda i: mha_attention_plain(qx, kx, vx, **kw), library, iters=iters,
                         plain_iters=plain_iters)}

    def flash32_row(name: str, checks: dict, main: dict, shape: dict, **subs) -> dict:
        return {"name": name, "route": "cuda", "source": "gofr_tpu_torch/csrc/flash_attention_f32.cu",
                "replaces": "gofr_tpu/ops/pallas/flash_attention.py:108",
                "max_abs_err": max(a["max_abs_err"] for a in checks.values()),
                "rms_rel_err": max(a["rms_rel_err"] for a in checks.values()),
                "checks": checks,
                "tolerance": {"max_abs": flash_mod.F32.MAX_ABS, "rms_rel": flash_mod.F32.RMS_REL},
                **main, **subs, "shape": shape}

    def flash32_isolated(label: str, b: int, s: int, h: int, kv_heads: int, dim: int,
                         causal: bool) -> dict:
        """Two batch rows of ``s`` positions (not a multiple of the 64-row
        tile), the second fully masked and its first 64 keys and values NaN:
        the first row's last partial tiles must read its positions past
        ``s`` as zeros (the 4-D maps), not the next row's, so its output
        holds the plain version's; the second row is 0."""
        qx, kx, vx = randn32(b, s, h, dim), randn32(b, s, kv_heads, dim), randn32(b, s, kv_heads, dim)
        kx[1, :64] = float("nan")
        vx[1, :64] = float("nan")
        lens = torch.tensor([s] + [0] * (b - 1), device=dev, dtype=torch.int32)
        got = flash_attention(qx, kx, vx, causal=causal, kv_lengths=lens)
        require(torch.all(got[1:] == 0).item(), f"{label}: the fully masked row is not zero")
        return agreement(label, got[:1], mha_attention_plain(qx[:1], kx[:1], vx[:1], causal=causal),
                         flash_mod.F32)

    def check_flash_f32() -> dict:  # C's f32 build at 128: Llama-3-8B's heads, 4 x 512 and 4 x 1024
        qf, kf, vf = randn32(4, 512, hq, d), randn32(4, 512, hkv, d), randn32(4, 512, hkv, d)
        checks = {"causal": flash32_agree("flash_attention_f32 (causal)", qf, kf, vf,
                                          causal=True)[0]}
        lens = torch.tensor([512, 300, 77, 0], device=dev, dtype=torch.int32)
        offs = torch.tensor([0, 40, 0, 0], device=dev, dtype=torch.int32)
        checks["ragged"], got_r = flash32_agree("flash_attention_f32 (ragged)", qf, kf, vf,
                                                causal=True, q_offset=offs, kv_lengths=lens)
        require(torch.all(got_r[3] == 0).item(), "flash_attention_f32: fully masked rows are not zero")
        q2, k2, v2 = randn32(4, 1024, hq, d), randn32(4, 1024, hkv, d), randn32(4, 1024, hkv, d)
        checks["causal_1024"] = flash32_agree("flash_attention_f32 (causal 4 x 1024)", q2, k2, v2,
                                              causal=True)[0]
        # a chunk of 512 queries at offset 512 against 1024 keys
        qc, kc, vc = randn32(1, 512, hq, d), randn32(1, 1024, hkv, d), randn32(1, 1024, hkv, d)
        offc = torch.tensor([512], device=dev, dtype=torch.int32)
        lenc = torch.tensor([1024], device=dev, dtype=torch.int32)
        checks["chunk_512_at_512"] = flash32_agree("flash_attention_f32 (chunk 512 at 512)", qc, kc,
                                                   vc, causal=True, q_offset=offc,
                                                   kv_lengths=lenc)[0]
        checks["s_200_next_row_nan"] = flash32_isolated(
            "flash_attention_f32 (Sq 200, the next row NaN)", 2, 200, hq, hkv, d, causal=True)
        chunk_mask = (torch.arange(1024, device=dev)[None, :]
                      <= 512 + torch.arange(512, device=dev)[:, None])
        qch = qc.transpose(1, 2)
        kch, vch = (t.transpose(1, 2).repeat_interleave(hq // hkv, dim=1) for t in (kc, vc))
        return flash32_row(
            "flash_attention_f32", checks,
            flash32_timed(qf, kf, vf, 4 * (2 * qf.numel() + 2 * kf.numel()), 4 * 512 * 513 // 2,
                          sdpa(qf, kf, vf), iters=20, plain_iters=5, causal=True),
            {"batch": 4, "seq": 512, "hq": hq, "hkv": hkv, "d": d, "causal": True, "dtype": "f32"},
            seq_1024={"shape": {"batch": 4, "seq": 1024, "causal": True},
                      **flash32_timed(q2, k2, v2, 4 * (2 * q2.numel() + 2 * k2.numel()),
                                      4 * 1024 * 1025 // 2, sdpa(q2, k2, v2), causal=True)},
            chunk_512_at_512={"shape": {"batch": 1, "queries": 512, "offset": 512, "keys": 1024},
                              **flash32_timed(qc, kc, vc, 4 * (2 * qc.numel() + 2 * kc.numel()),
                                              512 * 513 + 512 * 511 // 2,
                                              lambda i: F.scaled_dot_product_attention(
                                                  qch, kch, vch, attn_mask=chunk_mask),
                                              causal=True, q_offset=offc, kv_lengths=lenc)})

    def check_flash_d64_f32() -> dict:  # C's f32 build at 64: BERT-base's, ViT-L/16's, GPT-2's calls
        d64, cpu_rng = D64_SHAPES, torch.Generator().manual_seed(SEED + 22)

        def qkv(b: int, s: int, h: int) -> tuple:
            return tuple(randn32(b, s, h, 64) for _ in range(3))

        name = "flash_attention_d64_f32"
        b, s, h = d64["bert"]["batch"], d64["bert"]["seq"], d64["bert"]["heads"]
        lens_cpu = torch.randint(8, s + 1, (b,), generator=cpu_rng, dtype=torch.int32)
        lens_cpu[-d64["bert"]["padded_rows"]:] = 1
        lens_b = lens_cpu.to(dev)
        qb, kb, vb = qkv(b, s, h)
        checks = {"bert": flash32_agree(f"{name} (BERT)", qb, kb, vb, causal=False,
                                        kv_lengths=lens_b)[0]}
        live = int(lens_cpu.sum())
        bert_mask = (torch.arange(s, device=dev)[None, :] < lens_b[:, None])[:, None, None, :]
        qbh, kbh, vbh = (t.transpose(1, 2) for t in (qb, kb, vb))
        main = flash32_timed(qb, kb, vb, 2 * 4 * qb.numel() + 2 * live * h * 64 * 4 + b * 4,
                             s * live, lambda i: F.scaled_dot_product_attention(
                                 qbh, kbh, vbh, attn_mask=bert_mask),
                             iters=50, plain_iters=5, causal=False, kv_lengths=lens_b)
        b, s, h = d64["vit"]["batch"], d64["vit"]["seq"], d64["vit"]["heads"]
        qv, kv, vv = qkv(b, s, h)
        checks["vit"] = flash32_agree(f"{name} (ViT)", qv, kv, vv, causal=False)[0]
        checks["vit_next_row_nan"] = flash32_isolated(f"{name} (ViT, the next row NaN)", 2, s, h, h,
                                                      64, causal=False)
        qvh, kvh, vvh = (t.transpose(1, 2) for t in (qv, kv, vv))
        vit = {"shape": d64["vit"],
               **flash32_timed(qv, kv, vv, 4 * 4 * qv.numel(), s * s * b,
                               lambda i: F.scaled_dot_product_attention(qvh, kvh, vvh),
                               iters=50, plain_iters=5, causal=False)}
        b, s, h = d64["gpt2"]["batch"], d64["gpt2"]["seq"], d64["gpt2"]["heads"]
        qg2, kg2, vg2 = qkv(b, s, h)
        checks["gpt2_causal"] = flash32_agree(f"{name} (GPT-2 causal)", qg2, kg2, vg2,
                                              causal=True)[0]
        lens = torch.tensor([512, 300, 77, 0], device=dev, dtype=torch.int32)
        offs = torch.tensor([0, 40, 0, 0], device=dev, dtype=torch.int32)
        checks["gpt2_ragged"], got_r = flash32_agree(f"{name} (GPT-2 ragged)", qg2, kg2, vg2,
                                                     causal=True, q_offset=offs, kv_lengths=lens)
        require(torch.all(got_r[3] == 0).item(), f"{name}: fully masked rows are not zero")
        ch = d64["gpt2_chunk"]
        sq, off, h = ch["queries"], ch["offset"], ch["heads"]
        qc, kc, vc = randn32(1, sq, h, 64), randn32(1, off + sq, h, 64), randn32(1, off + sq, h, 64)
        offc = torch.tensor([off], device=dev, dtype=torch.int32)
        lenc = torch.tensor([off + sq], device=dev, dtype=torch.int32)
        checks["gpt2_chunk_512_at_256"] = flash32_agree(f"{name} (GPT-2 chunk 512 at 256)", qc, kc,
                                                        vc, causal=True, q_offset=offc,
                                                        kv_lengths=lenc)[0]
        chunk_mask = (torch.arange(off + sq, device=dev)[None, :]
                      <= off + torch.arange(sq, device=dev)[:, None])
        qch, kch, vch = (t.transpose(1, 2) for t in (qc, kc, vc))
        gpt2_chunk = {"shape": ch,
                      **flash32_timed(qc, kc, vc, 4 * (2 * qc.numel() + 2 * kc.numel()),
                                      sq * off + sq * (sq + 1) // 2,
                                      lambda i: F.scaled_dot_product_attention(
                                          qch, kch, vch, attn_mask=chunk_mask),
                                      iters=50, plain_iters=5, causal=True, q_offset=offc,
                                      kv_lengths=lenc)}
        return flash32_row(name, checks, main,
                           {**d64["bert"], "d": 64, "causal": False, "dtype": "f32",
                            "kv_lengths": {"min": int(lens_cpu.min()), "max": int(lens_cpu.max()),
                                           "live_keys": live}},
                           vit_197=vit, gpt2_chunk_512_at_256=gpt2_chunk)

    def check_slot_decode_f32(d64: bool = False) -> dict:  # F's f32 builds
        """F's f32 build at Llama-3-8B's step (``_slot_case``'s 9 lanes of
        Smax 2176, Hq 32, Hkv 8), or (``d64``) at GPT-2 small's (Hq = Hkv
        12, Smax 1024, ``_d64_case``'s lengths): ragged, a lane past the
        slot, the split's boundaries, every plan the autotuner races."""
        heads, kv_heads, dim, span = (hg, hg, 64, gsmax) if d64 else (hq, hkv, d, smax)
        lens, lens_cpu = (glen, glen_cpu) if d64 else (lengths, c["lengths_cpu"])
        name = "decode_attention_d64_f32" if d64 else "decode_attention_f32"
        launch = slot_decode_mod.decode_attention_d64_f32 if d64 else slot_decode_mod.decode_attention_f32
        lim = slot_decode_mod.F32
        qx = randn32(n, heads, dim)
        kx, vx = randn32(layers, n, kv_heads, span, dim), randn32(layers, n, kv_heads, span, dim)
        got = launch(qx, kx[0], vx[0], lens)
        require(got.dtype == f32, f"{name}: the output is {got.dtype}, not f32")
        agree = agreement(name, got, decode_attention_plain(qx, kx[0], vx[0], lens), lim)
        require(torch.all(got[lens_cpu == 0] == 0).item(), f"{name}: empty slots not zero")
        over = lens.clone()
        over[0] = span + 5
        agree_o = agreement(f"{name} (length past the slot)", launch(qx, kx[0], vx[0], over)[:1],
                            decode_attention_plain(qx, kx[0], vx[0], over)[:1], lim)
        r, splits = slot_decode_mod.split_plan(n, kv_heads, span)
        edges = torch.tensor([r, r + 1, 2 * r, 2 * r + 1, span, 0, span + 5, 3 * r, 3 * r + 1],
                             device=dev, dtype=torch.int32)
        got_e = launch(qx, kx[0], vx[0], edges)
        agree_e = agreement(f"{name} (split boundaries)", got_e,
                            decode_attention_split_plain(qx, kx[0], vx[0], edges, r), lim)
        require(torch.all(got_e[5] == 0).item(), f"{name}: the empty slot is not zero")
        live = int(lens_cpu.clamp(0, span).sum())
        b_ms, b_by = bound_ms(live * kv_heads * dim * 4 * 2 + 2 * qx.numel() * 4 + n * 4,
                              4 * live * heads * dim, H100_SXM_F32_FLOPS)
        # yardstick only (never called by the port): SDPA in f32 with a length
        # mask built outside the timed call
        mask = (torch.arange(span, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        q1 = qx[:, :, None]
        return {
            "name": name, "route": "cuda", "source": "gofr_tpu_torch/csrc/paged_decode.cu",
            "replaces": "gofr_tpu/ops/pallas/decode_attention.py:85",
            "max_abs_err": max(a["max_abs_err"] for a in (agree, agree_o, agree_e)),
            "rms_rel_err": max(a["rms_rel_err"] for a in (agree, agree_o, agree_e)),
            "checks": {"ragged": agree, "past_the_slot": agree_o, "split_boundaries": agree_e},
            "split": {"split_rows": r, "splits": splits},
            "plans": plan_holds(
                "decode", lim, lambda i: launch(qx, kx[i % layers], vx[i % layers], lens),
                lambda rows: decode_attention_split_plain(qx, kx[0], vx[0], lens, rows),
                span, (n, heads, kv_heads, dim, span, "float32"), qx=qx, kv_heads=kv_heads),
            "tolerance": {"max_abs": lim.MAX_ABS, "rms_rel": lim.RMS_REL},
            **timing(lambda i: launch(qx, kx[i % layers], vx[i % layers], lens),
                     lambda i: decode_attention_plain(qx, kx[i % layers], vx[i % layers], lens),
                     lambda i: F.scaled_dot_product_attention(q1, kx[i % layers], vx[i % layers],
                                                              attn_mask=mask, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {**(gpt2_shape if d64 else slot_shape), "dtype": "f32"},
        }

    def check_kv_append_slot_f32(d64: bool = False) -> dict:  # G's f32 builds
        """G's f32 build on an f32 slot cache of Llama-3-8B's KV heads (Smax
        2176) or (``d64``) of GPT-2 small's (Smax 1024): layer 0 of a
        two-layer copy, held whole, bit for bit against the plain append,
        on the slot appends' edge lanes."""
        kv_heads, dim, span = (hg, 64, gsmax) if d64 else (hkv, d, smax)
        lens, lens_cpu = (glen, glen_cpu) if d64 else (lengths, c["lengths_cpu"])
        name = "kv_append_slot_d64_f32" if d64 else "kv_append_slot_f32"
        launch = kv_append_slot_d64_f32 if d64 else kv_append_slot_f32
        kx, vx = randn32(layers, n, kv_heads, span, dim), randn32(layers, n, kv_heads, span, dim)
        mag = torch.rand(2, n, kv_heads, 1, device=dev, generator=g32) * 30 + 0.01
        k_new, v_new = (randn32(n, kv_heads, dim) * m for m in mag)
        pos = lens.clone()
        pos[0], pos[1], pos[2] = span, -1, span + 7
        got = [kx[:2].clone(), vx[:2].clone()]
        want = [t.clone() for t in got]
        launch(got[0][0], got[1][0], pos, k_new, v_new)
        append_tokens_plain(want[0][0], want[1][0], pos, k_new, v_new)
        require(all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want)),
                f"{name} cache differs from the plain write")
        require(all(torch.equal(a[0][i], b[0][i]) for a, b in zip(got, (kx, vx)) for i in (0, 1, 2)),
                f"{name} wrote a lane whose position lies outside the slot")
        require(not torch.equal(got[0][0], kx[0]), f"{name} wrote nothing")
        del got, want
        kept = int(((lens_cpu >= 0) & (lens_cpu < span)).sum())
        return append_entry(
            name, append_src, "gofr_tpu/ops/pallas/kv_append.py:61",
            (lambda i: launch(kx[i % layers], vx[i % layers], lens, k_new, v_new),
             lambda i: append_tokens_plain(kx[i % layers], vx[i % layers], lens, k_new, v_new)),
            append_bytes(0, kept, dim * 4, 0, kv_heads, dim, row_in=dim * 4),
            {"slots": n, "hkv": kv_heads, "d": dim, "smax": span, "dtype": "f32"})

    # -- the f32 builds of A, B, D and B-q (an f32 Llama on the paged pool and
    # on the int8 pool): A and B at Llama-3-8B's step on f32 pool slices of
    # ``_decode_case``'s pages, table and lengths (page 128), D with an f32 q
    # on its int8 pool and B-q on f32 rows; their 64 builds at Llama one_b's
    # (Hq 32, Hkv 4). Unit-scale inputs drawn in f32 (``g32``), held to the
    # launchers' f32 limits against the f32 plain versions (B and B-q bit
    # for bit), A and D also against their split plain versions at the
    # split's edges and at every plan; the bounds count f32 bytes (int8 rows
    # and bf16 scales for D) and the operations at the f32 peak.
    pools32: dict = {}

    def pool32(d64: bool) -> tuple:
        """(q, K, V) of A's and B's f32 checks: q [9, Hq, D] and ``layers``
        f32 pool slices of ``_decode_case``'s pages, drawn once a head dim."""
        if d64 not in pools32:
            heads, kv_heads, dim = (q1b.shape[1], hkv1b, 64) if d64 else (hq, hkv, d)
            shape = (layers, k_pool.shape[1], kv_heads, page, dim)
            pools32[d64] = (randn32(n, heads, dim), randn32(*shape), randn32(*shape))
        return pools32[d64]

    def check_paged_decode_f32(d64: bool = False) -> dict:  # A's f32 builds
        """A's f32 build at Llama-3-8B's step, or (``d64``) at Llama
        one_b's: ragged, the split's edges (with OOB and repeated table
        entries), every plan the autotuner races; SDPA in f32 on views
        gathered outside the timed call as the yardstick."""
        qx, kx, vx = pool32(d64)
        heads, kv_heads, dim = qx.shape[1], kx.shape[2], qx.shape[2]
        name = "paged_decode_d64_f32" if d64 else "paged_decode_f32"
        launch = decode_mod.paged_decode_d64_f32 if d64 else decode_mod.paged_decode_f32
        lim, pool, maxp = decode_mod.F32, kx.shape[1], table.shape[1]
        got = launch(qx, kx[0], vx[0], table, lengths)
        require(got.dtype == f32, f"{name}: the output is {got.dtype}, not f32")
        agree = agreement(name, got, paged_decode_attention_plain(qx, kx[0], vx[0], table, lengths),
                          lim)
        require(torch.all(got[c["lengths_cpu"] == 0] == 0).item(), f"{name}: empty slots not zero")
        r, splits, edges, edge_table = edge_case(pool, maxp, kv_heads)
        got_e = launch(qx, kx[0], vx[0], edge_table, edges)
        agree_e = agreement(f"{name} (split boundaries)", got_e,
                            paged_decode_attention_split_plain(qx, kx[0], vx[0], edge_table, edges,
                                                               r), lim)
        require(torch.all(got_e[5] == 0).item(), f"{name}: the empty slot is not zero")
        io = 2 * qx.numel() * 4 + table.numel() * 4 + n * 4
        b_ms, b_by = bound_ms(c["live"] * kv_heads * dim * 4 * 2 + io, 4 * c["live"] * heads * dim,
                              H100_SXM_F32_FLOPS)
        # yardstick only (never called by the port): SDPA in f32 with a length
        # mask and enable_gqa on each layer's view, gathered outside the timed
        # call; it returns NaN for the empty slot
        views = [gather_kv(kx[layer], vx[layer], table) for layer in range(layers)] if timed else []
        mask = (torch.arange(maxp * page, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        q1 = qx[:, :, None]
        return {
            "name": name, "route": "cuda", "source": "gofr_tpu_torch/csrc/paged_decode.cu",
            "replaces": "gofr_tpu/ops/pallas/paged_decode.py:94",
            "max_abs_err": max(a["max_abs_err"] for a in (agree, agree_e)),
            "rms_rel_err": max(a["rms_rel_err"] for a in (agree, agree_e)),
            "checks": {"ragged": agree, "split_boundaries": agree_e},
            "split": {"split_rows": r, "splits": splits},
            "plans": plan_holds(
                "paged_decode", lim, lambda i: launch(qx, kx[i % layers], vx[i % layers], table,
                                                      lengths),
                lambda rows: paged_decode_attention_split_plain(qx, kx[0], vx[0], table, lengths,
                                                                rows),
                maxp * page, (n, heads, kv_heads, dim, page, maxp, pool, "float32"),
                qx=qx, kv_heads=kv_heads),
            "tolerance": {"max_abs": lim.MAX_ABS, "rms_rel": lim.RMS_REL},
            **timing(lambda i: launch(qx, kx[i % layers], vx[i % layers], table, lengths),
                     lambda i: paged_decode_attention_plain(qx, kx[i % layers], vx[i % layers],
                                                            table, lengths),
                     lambda i: F.scaled_dot_product_attention(q1, *views[i % layers],
                                                              attn_mask=mask, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {**(one_b_shape if d64 else decode_shape), "dtype": "f32"},
        }

    def check_kv_append_f32(d64: bool = False) -> dict:  # B's f32 builds
        """B's f32 build on A's f32 pool slices (layer 0 of a two-layer
        copy, held whole) on the pool appends' edge lanes, bit for bit
        against the plain append."""
        _, kx, vx = pool32(d64)
        kv_heads, dim = kx.shape[2], kx.shape[4]
        name = "kv_append_d64_f32" if d64 else "kv_append_f32"
        launch = kv_append_d64_f32 if d64 else kv_append_f32
        k_new, v_new = append_rows(kv_heads, dim, f32)
        pos, etable, _, _ = pool_edges(kx.shape[1])
        got = [kx[:2].clone(), vx[:2].clone()]
        want = [t.clone() for t in got]
        launch(got[0][0], got[1][0], etable, pos, k_new, v_new)
        append_tokens_paged_plain(want[0][0], want[1][0], etable, pos, k_new, v_new)
        require(all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want)),
                f"{name} pool differs from the plain write")
        require(not torch.equal(got[0][0], kx[0]), f"{name} wrote nothing")
        del got, want
        return append_entry(
            name, append_src, "gofr_tpu/ops/pallas/kv_append.py:110",
            (lambda i: launch(kx[i % layers], vx[i % layers], table, lengths, k_new, v_new),
             lambda i: append_tokens_paged_plain(kx[i % layers], vx[i % layers], table, lengths,
                                                 k_new, v_new)),
            append_bytes(entries_timed, kept_timed, dim * 4, 0, kv_heads, dim, row_in=dim * 4),
            {**append_shape, "hkv": kv_heads, "d": dim, "dtype": "f32"})

    def check_decode_q_f32(d64: bool = False, bits: int = 8) -> dict:  # D's and E's f32-q builds
        """D (``bits`` 8) or E (4) with an f32 q on ``check_decode_q``'s int8
        or int4 pools at Llama-3-8B's step, or (``d64``) at Llama one_b's:
        ragged, the split's edges, every plan, at the launcher's f32 limits
        against the f32 plain version (q.k and p * vs in f32)."""
        op, mod, plain, replaces = (
            ("paged_decode_q", decode_q_mod, paged_decode_attention_q_plain,
             "gofr_tpu/ops/pallas/paged_decode.py:195") if bits == 8 else
            ("paged_decode_q4", decode_q4_mod, paged_decode_attention_q4_plain,
             "gofr_tpu/ops/pallas/paged_decode.py:314"))
        name = op + ("_d64" if d64 else "") + "_f32"
        launch = getattr(mod, name)
        cache, heads, kv_heads, dim = ((dc["pools_one_b"][bits], q1b.shape[1], hkv1b, 64) if d64
                                       else (c["pools"][bits], hq, hkv, d))
        lim = mod.F32
        qx = randn32(n, heads, dim)

        def args(layer: int) -> tuple:
            return (qx, cache.k[layer], cache.v[layer], cache.ks[layer], cache.vs[layer], table,
                    lengths)

        got = launch(*args(0))
        require(got.dtype == f32, f"{name}: the output is {got.dtype}, not f32")
        agree = agreement(name, got, plain(*args(0)), lim)
        require(torch.all(got[c["lengths_cpu"] == 0] == 0).item(), f"{name}: empty slots not zero")
        r, splits, edges, edge_table = edge_case(cache.k.shape[1], table.shape[1], kv_heads)
        edge_args = (*args(0)[:5], edge_table, edges)
        agree_e = agreement(f"{name} (split boundaries)", launch(*edge_args),
                            paged_decode_attention_q_split_plain(*edge_args, r, bits=bits), lim)
        io = 2 * qx.numel() * 4 + table.numel() * 4 + n * 4
        # K and V rows of D (int8) or D/2 (packed) bytes plus two bf16 scales;
        # q.k as three bf16 products on the tensor cores (the exact codes
        # against q's pieces), P.V in f32 on the CUDA cores
        qk = pv = 2 * c["live"] * heads * dim
        b_ms, b_by = bound_ms(c["live"] * kv_heads * (2 * cache.k.shape[-1] + 2 * 2) + io,
                              [(qk, H100_SXM_BF16X3_FLOPS), (pv, H100_SXM_F32_FLOPS)])
        return {
            "name": name, "route": "cuda", "source": "gofr_tpu_torch/csrc/paged_decode_q.cu",
            "replaces": replaces,
            "max_abs_err": max(a["max_abs_err"] for a in (agree, agree_e)),
            "rms_rel_err": max(a["rms_rel_err"] for a in (agree, agree_e)),
            "checks": {"ragged": agree, "split_boundaries": agree_e},
            "split": {"split_rows": r, "splits": splits},
            "plans": plan_holds(
                op, lim, lambda i: launch(*args(i % layers)),
                lambda rows: paged_decode_attention_q_split_plain(*args(0), rows, bits=bits),
                table.shape[1] * page, (n, heads, kv_heads, dim, page, table.shape[1],
                                        cache.k.shape[1],
                                        decode_q_mod.pin_dtype("int8" if bits == 8 else "int4",
                                                               f32)),
                qx=qx, kv_heads=kv_heads),
            "tolerance": {"max_abs": lim.MAX_ABS, "rms_rel": lim.RMS_REL},
            # no one PyTorch call computes attention over quantized rows
            **timing(lambda i: launch(*args(i % layers)),
                     lambda i: plain(*args(i % layers))),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {**(one_b_shape if d64 else decode_shape), "kv_bits": bits, "dtype": "f32"},
        }

    checks = [("paged_decode", check_paged_decode), ("kv_append", check_kv_append),
              ("paged_decode_q", lambda: check_decode_q(8)),
              ("paged_decode_q4", lambda: check_decode_q(4)),
              # D's f32-q builds before the quantizing appends' timed launches
              # write rows of up to 30 into the same int8 pools (the other
              # f32 rows follow the f32 checks of C, F and G below)
              ("paged_decode_q_f32", check_decode_q_f32),
              ("paged_decode_q_d64_f32", lambda: check_decode_q_f32(d64=True)),
              # and E's, before the quantizing appends write the int4 pools
              ("paged_decode_q4_f32", lambda: check_decode_q_f32(bits=4)),
              ("paged_decode_q4_d64_f32", lambda: check_decode_q_f32(d64=True, bits=4)),
              ("flash_attention", check_flash), ("flash_attention_d64", check_flash_d64),
              ("decode_attention", check_slot_decode), ("kv_append_slot", check_kv_append_slot),
              ("kv_append_q", lambda: check_append_q(8)), ("kv_append_q4", lambda: check_append_q(4)),
              ("kv_append_slot_q", check_append_slot_q),
              ("paged_decode_d64", check_paged_decode_d64), ("kv_append_d64", check_kv_append_d64),
              ("decode_attention_d64", check_slot_decode_d64),
              ("kv_append_slot_d64", check_kv_append_slot_d64),
              ("paged_decode_q_d64", lambda: check_decode_q(8, d64=True)),
              ("paged_decode_q4_d64", lambda: check_decode_q(4, d64=True)),
              ("kv_append_q_d64", lambda: check_append_q(8, d64=True)),
              ("kv_append_q4_d64", lambda: check_append_q(4, d64=True)),
              ("kv_append_slot_q_d64", lambda: check_append_slot_q(d64=True)),
              ("flash_attention_f32", check_flash_f32),
              ("flash_attention_d64_f32", check_flash_d64_f32),
              ("decode_attention_f32", check_slot_decode_f32),
              ("decode_attention_d64_f32", lambda: check_slot_decode_f32(d64=True)),
              ("kv_append_slot_f32", check_kv_append_slot_f32),
              ("kv_append_slot_d64_f32", lambda: check_kv_append_slot_f32(d64=True)),
              ("paged_decode_f32", check_paged_decode_f32),
              ("paged_decode_d64_f32", lambda: check_paged_decode_f32(d64=True)),
              ("kv_append_f32", check_kv_append_f32),
              ("kv_append_d64_f32", lambda: check_kv_append_f32(d64=True)),
              ("kv_append_q_f32", lambda: check_append_q(8, f32_rows=True)),
              ("kv_append_q_d64_f32", lambda: check_append_q(8, d64=True, f32_rows=True)),
              ("kv_append_q4_f32", lambda: check_append_q(4, f32_rows=True)),
              ("kv_append_q4_d64_f32", lambda: check_append_q(4, d64=True, f32_rows=True)),
              ("kv_append_slot_q_f32", lambda: check_append_slot_q(f32_rows=True)),
              ("kv_append_slot_q_d64_f32", lambda: check_append_slot_q(d64=True, f32_rows=True)),
              ("w8a16", lambda: check_w8a16(torch, timing if timed else None)),
              ("w8a16_f32", lambda: check_w8a16(torch, timing if timed else None, f32=True))]
    results = []
    for name, check in checks:
        if (only is not None and name not in only) or name in skip:
            continue
        try:
            results.append({**check(), "passed": True})
        except SystemExit as failure:
            if not keep_going:
                raise
            results.append({"name": name, "passed": False, "failure": str(failure),
                            **getattr(failure, "numbers", {})})
    return results


# Phase 3's shapes for C's head-dim-64 build: a full step of configuration
# #1 (BERT-base: batch bucket 256, length bucket 64, 12 heads; 16 of the
# rows padded, length 1), a batch of configuration #3 (ViT-L/16 at 224: 32
# images, 197 positions, 16 heads) and GPT-2's causal prefill (4 x 512, 12
# heads).
D64_SHAPES = {"bert": {"batch": 256, "seq": 64, "heads": 12, "padded_rows": 16},
              "vit": {"batch": 32, "seq": 197, "heads": 16},
              "gpt2": {"batch": 4, "seq": 512, "heads": 12},
              "gpt2_chunk": {"queries": 512, "offset": 256, "heads": 12}}
# Phase 3's shapes for the head-dim-64 builds of the decode kernels and
# appends: Llama one_b's heads (A, B) on ``_decode_case``'s pool layout, and
# GPT-2 small's (F, G) on a slot cache of the length phase 4's GPT-2 engine
# gives it (max_len 1016 + a decode chunk of 8).
D64_DECODE = {"one_b": {"hq": 32, "hkv": 4}, "gpt2": {"heads": 12, "smax": 1024}}


def _d64_case(torch, c: dict) -> dict:
    """The 64 builds' inputs, from their own seed: q and ``layers`` bf16
    pool slices of Llama one_b's heads over ``_decode_case``'s pages, table
    and lengths (8 live slots, an empty one), and int8 and int4 pools of
    the same shape written by the port's own ``write_prompts_paged_q`` /
    ``_q4`` from random bf16 K/V; and q, lengths and ``layers`` slot-cache
    slices [9, 12, 1024, 64] of GPT-2 small's heads, the 8 live lengths
    drawn over the slot's last three quarters, the ninth slot empty. Every
    row is random, so a lane read past its length reads data."""
    from gofr_tpu_torch.ops.paged import (
        Q4PagedKVCache,
        QPagedKVCache,
        write_prompts_paged_q,
        write_prompts_paged_q4,
    )

    dev, bf, layers, n = torch.device("cuda"), torch.bfloat16, c["layers"], c["n"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    ob, g2 = D64_DECODE["one_b"], D64_DECODE["gpt2"]
    pool_shape = (layers, c["k_pool"].shape[1], ob["hkv"], c["page"], 64)
    # lengths of a quarter of the slot and more: at shorter ones the plain
    # version's bf16 scores alone move an output by more than an ulp (the
    # split-boundary lanes, held against the split's plain version, are short)
    lengths_cpu = torch.randint(g2["smax"] // 4, g2["smax"] + 1, (n,),
                                generator=torch.Generator().manual_seed(SEED + 9), dtype=torch.int32)
    lengths_cpu[-1] = 0
    slot_shape = (layers, n, g2["heads"], g2["smax"], 64)
    table, span = c["table"], c["table"].shape[1] * c["page"]
    pools = {bits: cls.create(layers, pool_shape[1], c["page"], ob["hkv"], 64, device=dev)
             for bits, cls in ((8, QPagedKVCache), (4, Q4PagedKVCache))}
    for layer in range(layers):
        for plane in ("k", "v"):
            rows = torch.randn(n, span, ob["hkv"], 64, device=dev, generator=gen).to(bf)
            for bits, write in ((8, write_prompts_paged_q), (4, write_prompts_paged_q4)):
                cache = pools[bits]
                write(getattr(cache, plane)[layer], getattr(cache, plane + "s")[layer], table, rows)
    return {"q_one_b": torch.randn(n, ob["hq"], 64, device=dev, generator=gen).to(bf),
            "pools_one_b": pools,
            "k_one_b": torch.randn(pool_shape, device=dev, generator=gen).to(bf),
            "v_one_b": torch.randn(pool_shape, device=dev, generator=gen).to(bf),
            "hkv_one_b": ob["hkv"],
            "q_gpt2": torch.randn(n, g2["heads"], 64, device=dev, generator=gen).to(bf),
            "k_gpt2": torch.randn(slot_shape, device=dev, generator=gen).to(bf),
            "v_gpt2": torch.randn(slot_shape, device=dev, generator=gen).to(bf),
            "lengths_gpt2_cpu": lengths_cpu, "lengths_gpt2": lengths_cpu.to(dev), "gen": gen}


def w8_agreement(label: str, got, want, f32: bool = False) -> dict:
    """Hold the W8A16 kernel against ``qdot_plain`` under its launcher's
    limits, relative to the output's scale: max |err| over max |y|, the
    RMS of the difference over the output's RMS, and (bf16) the share of
    outputs not bit-equal to the plain version's; ``f32``: the f32
    build's limits (``F32``), max |err| over max |y| and the RMS ratio."""
    from gofr_tpu_torch.ops.cuda import w8a16 as w8_mod

    got, want = got.float(), want.float()
    require(bool(got.isfinite().all()), f"{label} produced non-finite values")
    diff = (got - want).abs()
    top = want.abs().max().item()
    err = diff.max().item()
    numbers = {"max_abs_err": err, "max_rel_err": err / top,
               "rms_rel_err": (diff.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item(),
               "mismatch_share": (diff > 0).float().mean().item(), "out_max": top}
    limits = ((w8_mod.F32.MAX_ABS, w8_mod.F32.RMS_REL, 1.0) if f32 else
              (w8_mod.MAX_REL, w8_mod.RMS_REL, w8_mod.MISMATCH_SHARE))
    if not (numbers["max_rel_err"] <= limits[0] and numbers["rms_rel_err"] <= limits[1]
            and numbers["mismatch_share"] <= limits[2]):
        failure = SystemExit(f"chip_smoke FAILED: {label} disagrees with qdot_plain: {numbers} "
                             f"(limits {limits})")
        failure.numbers = numbers
        raise failure
    return numbers


def int8pack(torch, x, qs, copies: int, iters: int) -> dict:
    """Yardstick only (never called by the port): PyTorch's own
    weight-only int8 product, ``torch._weight_int8pack_mm``, where this
    torch has a CUDA implementation of it, timed over ``iters`` calls."""
    scales = [w.s.to(torch.bfloat16) for w in qs]
    try:
        torch._weight_int8pack_mm(x, qs[0].q, scales[0])
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return {"ms": None, "device_ms": None, "unavailable": str(e).splitlines()[0][:160]}
    fn = lambda i: torch._weight_int8pack_mm(x, qs[i % copies].q, scales[i % copies])  # noqa: E731
    return {"ms": time_ms(torch, fn, iters, warmup=1), "device_ms": device_ms(torch, fn, iters)}


def check_w8a16(torch, timing=None, f32: bool = False) -> dict:  # port: the weight-only int8 linear
    """At Llama-3-8B's five (N, K) and the rows of a decode step, a
    verify forward and a prefill (``W8_ROWS``): bf16 weights from the
    seed with std K^-1/2 quantized by the port's ``quantize`` and bf16
    rows of RMS 1, against ``qdot_plain`` on the same inputs (cuBLAS
    reducing in f32). Timed on ``W8_COLD_BYTES`` of weight copies
    cycled, so each launch finds its weight cold in L2 as a step
    through 32 layers does; the yardsticks are cuBLAS on the bf16
    weight (``F.linear``, the product without int8) and
    ``torch._weight_int8pack_mm``. With ``f32``, the f32-activation build
    (``w8a16_f32``) at ``W8_ROWS_F32`` on f32 weights and rows, held to its
    ``F32`` limits against the f32 ``qdot_plain`` (cuBLAS in f32, TF32
    off), the yardstick cuBLAS's f32 ``F.linear`` on the dequantized f32
    weight (TF32 off), the bound's operations at three bf16 products
    each. The row's ``ms``, ``device_ms``, ``plain_ms``, ``library_ms``
    and ``bound_ms`` are one decode step's 225 products at M = 8
    (``W8_PER_STEP``), summed over the shapes; ``prefill_*`` and (bf16)
    ``verify_*`` sum a forward's products at M = 2048 and M = 40 the same
    way (device time, bound, cuBLAS's device time). The bf16 check also
    holds the tiles at ``W8_EDGES`` (untimed). ``timing`` is
    ``check_kernels``' timer; None leaves the check untimed."""
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.cuda import w8a16 as w8_mod
    from gofr_tpu_torch.ops.quant import qdot_plain, quantize

    dev, timed = torch.device("cuda"), timing is not None
    dtype = torch.float32 if f32 else torch.bfloat16
    launch = w8_mod.w8a16_f32 if f32 else w8_mod.w8a16
    wgen = torch.Generator(device=dev).manual_seed(SEED + (10 if f32 else 9))
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    shapes = {}
    try:
        for name, (n_out, k_in) in W8_SHAPES.items():
            copies = max(1, math.ceil(W8_COLD_BYTES / (n_out * k_in))) if timed else 1
            ws = [(torch.randn(n_out, k_in, device=dev, generator=wgen) * k_in ** -0.5).to(dtype)
                  for _ in range(copies)]
            qs = [quantize(w) for w in ws]
            if f32:  # the library's operand: the dequantized f32 weight
                ws = [w.q.float() * w.s[:, None] for w in qs]
            for m in W8_ROWS_F32 if f32 else W8_ROWS:
                x = torch.randn(m, k_in, device=dev, generator=wgen).to(dtype)
                label = f"{launch.__name__} {name} M={m}"
                entry = {**w8_agreement(label, launch(x, qs[0].q, qs[0].s), qdot_plain(x, qs[0]), f32),
                         "n": n_out, "k": k_in, "m": m,
                         "plan": w8_mod.plan(m, n_out, k_in, x.element_size())}
                entry["bound_ms"], entry["bound_by"] = bound_ms(
                    n_out * k_in + 4 * n_out + x.element_size() * (m * k_in + m * n_out),
                    2 * m * n_out * k_in, H100_SXM_BF16X3_FLOPS if f32 else None)
                if timed:
                    entry.update(timing(
                        lambda i: launch(x, qs[i % copies].q, qs[i % copies].s),
                        lambda i: qdot_plain(x, qs[i % copies]),
                        lambda i: F.linear(x, ws[i % copies]), iters=20, plain_iters=5))
                    if not f32:  # seconds a call at prefill rows: two calls there
                        entry["int8pack_mm"] = int8pack(torch, x, qs, copies, 20 if m <= 64 else 2)
                shapes[f"{name}_m{m}"] = entry
            del ws, qs
            torch.cuda.empty_cache()
        # the bf16 tiles' ragged edges at each token width: M past a whole
        # tile, N past a whole 128-channel tile, K past a whole 64 (untimed)
        for m, n_out, k_in in (() if f32 else W8_EDGES):
            w = quantize((torch.randn(n_out, k_in, device=dev, generator=wgen) * k_in ** -0.5)
                         .to(dtype))
            x = torch.randn(m, k_in, device=dev, generator=wgen).to(dtype)
            shapes[f"edge_{m}x{n_out}x{k_in}"] = {
                **w8_agreement(f"{launch.__name__} edge M={m} N={n_out} K={k_in}",
                               launch(x, w.q, w.s), qdot_plain(x, w)),
                "n": n_out, "k": k_in, "m": m, "plan": w8_mod.plan(m, n_out, k_in)}
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    lim = w8_mod.F32 if f32 else None
    row = {"name": launch.__name__, "route": "cuda", "source": "gofr_tpu_torch/csrc/w8a16.cu",
           "replaces": "port-only (XLA in JAX: gofr_tpu/ops/quant.py:61 qdot)",
           **{key: max(e[key] for e in shapes.values())
              for key in ("max_abs_err", "max_rel_err", "rms_rel_err", "mismatch_share")},
           "tolerance": ({"max_rel": lim.MAX_ABS, "rms_rel": lim.RMS_REL} if f32 else
                         {"max_rel": w8_mod.MAX_REL, "rms_rel": w8_mod.RMS_REL,
                          "mismatch_share": w8_mod.MISMATCH_SHARE}),
           "shapes": shapes, "bound_by": "bytes",
           "per_call": "one decode step: the 225 products at M = 8, summed over the shapes"}
    for key in ("bound_ms", *(("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms")
                              if timed else ())):
        row[key] = sum(W8_PER_STEP[name] * shapes[f"{name}_m8"][key] for name in W8_SHAPES)
    # a forward's products at the prefill rows and (bf16) the verify rows,
    # beside their bound and cuBLAS's device time on the same weights
    for label, m in (("prefill", 2048), *(() if f32 else (("verify", 40),))):
        for key in ("bound_ms", *(("device_ms", "library_device_ms") if timed else ())):
            row[f"{label}_{key}"] = sum(W8_PER_STEP[name] * shapes[f"{name}_m{m}"][key]
                                        for name in W8_SHAPES)
    return row


# Phase 3's W8A16 shapes: Llama-3-8B's linears as (N, K), the launches of
# each in one decode step (7 x 32 + the head), the rows of a decode step (8
# slots), a verify forward (8 lanes x 5) and a prefill (4 x 512), and the
# bytes of int8 weight copies cycled while timing (past the 50 MB L2).
W8_SHAPES = {"wq_wo": (4096, 4096), "wk_wv": (1024, 4096), "gate_up": (14336, 4096),
             "down": (4096, 14336), "head": (128256, 4096)}
W8_PER_STEP = {"wq_wo": 64, "wk_wv": 64, "gate_up": 64, "down": 32, "head": 1}
W8_ROWS = (8, 40, 2048)
# The bf16 tiles' edges (M, N, K) at token widths 64, 128 and 256: M, N and
# K each past a whole tile.
W8_EDGES = ((129, 1000, 4112), (2000, 1000, 4112), (600, 4200, 4112))
# The f32 build's rows: a decode step and a prefill.
W8_ROWS_F32 = (8, 2048)
W8_COLD_BYTES = 150e6
# Phase 4's ``paged_w8``: ``bf16``'s engine knobs as a user sets them, and
# weight-only int8; the int8 Llama-3-8B holds this many bytes.
W8_CONFIG = {"ENGINE_SLOTS": "8", "ENGINE_MAX_LEN": "2048", "ENGINE_PREFILL_BATCH": "4",
             "ENGINE_DECODE_CHUNK": "8", "ENGINE_KV_DTYPE": "bf16", "ENGINE_QUANTIZE": "int8"}
W8_BYTES = 8_561_882_112


def llama_w8_bytes(cfg) -> int:
    """The bytes an int8-weight Llama holds, in closed form, apart from the
    quantizer under test: each layer's seven products and the untied head
    as N x K int8 codes and N f32 scales, the embedding and the RMS norms'
    weights in the model's dtype. Llama-3-8B in bf16: ``W8_BYTES``."""
    h, hd = cfg.hidden_size, cfg.head_dim or cfg.hidden_size // cfg.num_heads
    q_out, kv_out, inter = cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.intermediate_size
    layer = ((q_out, h), (kv_out, h), (kv_out, h), (h, q_out), (inter, h), (inter, h), (h, inter))
    products = (*layer * cfg.num_layers, (cfg.vocab_size, h))
    plain = cfg.vocab_size * h + (2 * cfg.num_layers + 1) * h
    return sum(n * k + 4 * n for n, k in products) + cfg.dtype.itemsize * plain

# The serving runs of phase 4 and the checks of phase 5, one per cache:
# (kv_layout, kv_quantize).
RUNS = (("paged", ""), ("paged", "int8"), ("paged", "int4"), ("slot", ""), ("slot", "int8"))
# The kernels each run must launch; every other kernel must launch no time
# in that run. The int8 slot cache's decode attention is plain PyTorch (the
# TPU ran it as XLA). Every kernel but the flash prefill runs once per layer
# and decode step, so those of one run launch equally often.
ON_PATH = {("paged", ""): ("paged_decode", "kv_append", "flash_attention"),
           ("paged", "int8"): ("paged_decode_q", "kv_append_q", "flash_attention"),
           ("paged", "int4"): ("paged_decode_q4", "kv_append_q4", "flash_attention"),
           ("slot", ""): ("decode_attention", "kv_append_slot", "flash_attention"),
           ("slot", "int8"): ("kv_append_slot_q", "flash_attention"),
           # the int8-weight model on the bf16 pool: every product through W8A16
           "paged_w8": ("paged_decode", "kv_append", "flash_attention", "w8a16"),
           # the step controller on the bf16 pool, and on a spec engine (C alone)
           "paged_control": ("paged_decode", "kv_append", "flash_attention"),
           "paged_control_spec": ("flash_attention",),
           # a prefill worker (C; its pool's decode kernels only for a prompt
           # under a page, served colocated) and a decode worker, bf16 pool
           "paged_handoff_prefill": ("flash_attention",),
           "paged_handoff_decode": ("paged_decode", "kv_append", "flash_attention"),
           # each autotuned engine's warmup (the tuner's candidates, then the
           # warmup body), on its cache's kernels; the App's other entry
           # points on the bf16 pool
           "paged_autotune_bf16": ("paged_decode", "kv_append", "flash_attention"),
           "paged_autotune_int8": ("paged_decode_q", "kv_append_q", "flash_attention"),
           "paged_autotune_int4": ("paged_decode_q4", "kv_append_q4", "flash_attention"),
           "paged_autotune_slot_bf16": ("decode_attention", "kv_append_slot", "flash_attention"),
           "app_transports": ("paged_decode", "kv_append", "flash_attention"),
           # a gateway App in front of a model App on the bf16 pool
           "app_services": ("paged_decode", "kv_append", "flash_attention"),
           # the encoders on the BatchEngine: C's head-dim-64 build alone
           "bert_embed": ("flash_attention_d64",),
           "vit_classify": ("flash_attention_d64",),
           # the head-dim-64 generate runs: GPT-2 small on the bf16 slot
           # cache (and in int8 weights), Llama one_b on the bf16 pool
           "gpt2_generate": ("decode_attention_d64", "kv_append_slot_d64", "flash_attention_d64"),
           "gpt2_w8": ("decode_attention_d64", "kv_append_slot_d64", "flash_attention_d64",
                       "w8a16"),
           "one_b_bf16": ("paged_decode_d64", "kv_append_d64", "flash_attention_d64"),
           # Llama one_b on the int8 and int4 pools and the int8 slot cache,
           # whose decode attention is plain PyTorch, as at 128
           "one_b_int8": ("paged_decode_q_d64", "kv_append_q_d64", "flash_attention_d64"),
           "one_b_int4": ("paged_decode_q4_d64", "kv_append_q4_d64", "flash_attention_d64"),
           "one_b_slot_int8": ("kv_append_slot_q_d64", "flash_attention_d64"),
           # the f32 models in their own dtype: GPT-2 small on the f32 slot
           # cache, BERT-base and ViT-L/16 on the BatchEngine, Llama-3-8B's
           # widths cut to 2 layers on the f32 slot cache: the f32 builds of
           # C, F and G alone (every bf16 run holds them at 0, and they hold
           # every bf16 build at 0)
           "gpt2_f32": ("decode_attention_d64_f32", "kv_append_slot_d64_f32",
                        "flash_attention_d64_f32"),
           "bert_embed_f32": ("flash_attention_d64_f32",),
           "vit_classify_f32": ("flash_attention_d64_f32",),
           "llama_slot_f32": ("decode_attention_f32", "kv_append_slot_f32", "flash_attention_f32"),
           # an f32 Llama on the f32 pool and on the int8 pool: one_b at full
           # width and depth (the 64 f32 builds), Llama-3-8B's widths cut to
           # 2 layers (the 128 ones): A and B, or D and B-q, and C in f32
           "one_b_f32": ("paged_decode_d64_f32", "kv_append_d64_f32", "flash_attention_d64_f32"),
           "one_b_int8_f32": ("paged_decode_q_d64_f32", "kv_append_q_d64_f32",
                              "flash_attention_d64_f32"),
           "llama_paged_f32": ("paged_decode_f32", "kv_append_f32", "flash_attention_f32"),
           "llama_int8_f32": ("paged_decode_q_f32", "kv_append_q_f32", "flash_attention_f32"),
           # the f32 models on the rest: one_b at full width and depth on the
           # int4 pool (E and B-q4's 64 f32 builds) and the int8 slot cache
           # (G-q's; its decode attention plain PyTorch, as in bf16),
           # Llama-3-8B's widths cut to 2 layers on the same caches and with
           # int8 weights on the f32 pool, and GPT-2 small with int8 weights
           # on its f32 slot cache: W8A16's f32 build for every product
           "one_b_int4_f32": ("paged_decode_q4_d64_f32", "kv_append_q4_d64_f32",
                              "flash_attention_d64_f32"),
           "one_b_slot_int8_f32": ("kv_append_slot_q_d64_f32", "flash_attention_d64_f32"),
           "llama_int4_f32": ("paged_decode_q4_f32", "kv_append_q4_f32", "flash_attention_f32"),
           "llama_slot_int8_f32": ("kv_append_slot_q_f32", "flash_attention_f32"),
           "llama_w8_f32": ("paged_decode_f32", "kv_append_f32", "flash_attention_f32",
                            "w8a16_f32"),
           "gpt2_w8_f32": ("decode_attention_d64_f32", "kv_append_slot_d64_f32",
                           "flash_attention_d64_f32", "w8a16_f32")}
# one_b's runs, by (kv_layout, kv_quantize), and the KV bytes a position
# of its cache formats (22 layers x 4 KV heads x K and V x a row of 64 bf16,
# of 64 int8 + a bf16 scale, or of 32 packed bytes + a bf16 scale)
ONE_B_RUNS = {("paged", ""): "one_b_bf16", ("paged", "int8"): "one_b_int8",
              ("paged", "int4"): "one_b_int4", ("slot", "int8"): "one_b_slot_int8"}
ONE_B_KV_BYTES = {"": 22_528, "int8": 11_616, "int4": 5_984}
# The f32 Llama runs: name -> (model, kv_layout, kv_quantize, quantize),
# and the KV bytes a position of their caches, read from the caches' own
# planes: one_b's f32 pool 22 x 4 x 64 x 2 x 4 B, its int8 pool and int8
# slot cache as in bf16 (int8 rows, bf16 scales), its int4 pool 22 x 4 x
# (2 x 32 + 4) B; the same at Llama-3-8B's widths cut to 2 layers, 2 x 8
# x 128 x 2 x 4 B (the f32 pool, with int8 weights too), 2 x 8 x (2 x 128
# + 4) B and 2 x 8 x (2 x 64 + 4) B. ``ops.paged.kv_plane_bytes_per_
# position`` mirrors the JAX package's function, which has no f32 case and
# reports bf16 bytes for an f32 pool (ROADMAP Queue C); it is printed
# beside them.
F32_LLAMA_RUNS = {"one_b_f32": ("one_b", "paged", "", ""),
                  "one_b_int8_f32": ("one_b", "paged", "int8", ""),
                  "llama_paged_f32": ("llama", "paged", "", ""),
                  "llama_int8_f32": ("llama", "paged", "int8", ""),
                  "one_b_int4_f32": ("one_b", "paged", "int4", ""),
                  "one_b_slot_int8_f32": ("one_b", "slot", "int8", ""),
                  "llama_int4_f32": ("llama", "paged", "int4", ""),
                  "llama_slot_int8_f32": ("llama", "slot", "int8", ""),
                  "llama_w8_f32": ("llama", "paged", "", "int8")}
F32_LLAMA_KV_BYTES = {"one_b_f32": 45_056, "one_b_int8_f32": 11_616, "llama_paged_f32": 16_384,
                      "llama_int8_f32": 4_160, "one_b_int4_f32": 5_984,
                      "one_b_slot_int8_f32": 11_616, "llama_int4_f32": 2_112,
                      "llama_slot_int8_f32": 4_160, "llama_w8_f32": 16_384}
PREFILL_KERNELS = ("flash_attention", "flash_attention_d64", "flash_attention_f32",
                   "flash_attention_d64_f32")
# The f32 runs' tie rule: f32 logits through the kernels and through the
# plain path differ by a few f32 ulps, so at a first difference from the
# plain path's tokens the run's token lies within this of that path's top
# logit (a near tie, not a wrong token).
F32_TIE_GAP = 1e-3
# The same rule on the int8 pool under an f32 model, relative to the
# largest |logit|: two prefills of one prompt in other batches (the
# engine's buckets against ``plain_tokens``' one batch) round their
# activations apart in the last f32 bits, which flips int8 codes, and a
# flipped code moves one_b's f32 logits by up to 9.1e-4 of max |logit|
# (phase 5's chunked run on that pool, H100, 700 W); twice that. At
# F32_TIE_GAP one_b's run chose a token 9.4e-4 (plain decode after C's
# prefill) and 1.19e-3 (whole plain path) below a near tie's top logit.
# The int8 slot cache under an f32 model is held the same way.
INT8_F32_TIE_RTOL = 2e-3
# The same rule on the int4 pool under an f32 model: a flipped 4-bit code
# moves its element by max |x| / 7 where an int8 code moves it by
# max |x| / 127, 18 times as far, so a flip there may move the logits by
# about 18 x 9.1e-4 of max |logit|; 2e-2 (a prediction written before the
# pool's first f32 run; the pool's phase-5 limit, LOGITS_RTOL["int4"],
# holds the whole plain path).
INT4_F32_TIE_RTOL = 2e-2
# Phase 4's speculative runs (spec_tokens g = 4), each on the model of the
# runs above and the prompts of the plain run on its cache: prompt lookup
# on the bf16 pool, and a draft model on the bf16 slot cache, Llama-3-8B's
# widths cut to ``DRAFT_LAYERS`` layers with random weights from seed 1.
# The target's decode step gives way to one verify forward a round, C over
# g + 1 queries a lane: the pool's A and B never launch; the draft's decode
# steps launch F and G.
SPEC_G = 4
DRAFT_LAYERS = 2
SPEC_RUNS = {"paged_spec": ("paged", ""), "slot_spec_draft": ("slot", "")}
ON_PATH_SPEC = {"paged_spec": ("flash_attention",),
                "slot_spec_draft": ("flash_attention", "decode_attention", "kv_append_slot")}
# The adapter plane: phase 4's ``paged_lora`` run is ``bf16`` with a pool of
# 4 adapter slots of rank 16 and three random adapters of ranks 8, 12 and 16
# (``random_adapter`` from seeds 40, 41, 42), the 8 requests on the base
# model, ad0, ad1 and ad2 in turn; it must launch the ``bf16`` run's
# kernels. Phases 5 and 6 use the same adapters over lanes ``LORA_SEL``.
LORA_SLOTS = 4
LORA_RANK = 16
LORA_RANKS = (8, 12, 16)
LORA_SEED = 40
LORA_LANES = (None, "ad0", "ad1", "ad2")
LORA_SEL = (0, 1, 2, 3, 0)
# Phase 4's adoption check: Llama-3-8B's widths cut to ``ADOPT_LAYERS``
# layers, old and new random weights from seeds 20 and 21.
ADOPT_LAYERS = 2


def run_name(kv_layout: str, kv_quantize: str) -> str:
    pool = kv_quantize or "bf16"
    return pool if kv_layout == "paged" else f"slot_{pool}"


def phase4_prompts(torch, vocab: int) -> list[list[int]]:
    """The 8 prompts of phase 4's runs, 64..1024 tokens, from the seed."""
    rng = torch.Generator().manual_seed(SEED)
    lens = torch.randint(64, 1025, (8,), generator=rng).tolist()
    return [torch.randint(0, vocab, (n,), generator=rng).tolist() for n in lens]


def token_agreement(torch, model, prompts, outs, want, logits=None) -> dict:
    """How a run's greedy tokens compare with another run's on the same
    prompts: the share of requests whose tokens are equal, the index of each
    request's first difference (None: equal), and there the top-2 margin of
    the logits of one whole-sequence forward over the prompt and the other
    run's tokens before it (bf16 runs that round differently flip a near
    tie), with the gap between the two tokens the runs chose, how far this
    run's token lies below the top logit and the largest |logit|. Given
    ``logits`` [steps, N, V], the other run's own logits at each step, the
    margins read those instead of a forward."""
    first = [next((j for j, (a, b) in enumerate(zip(o["tokens"], w["tokens"])) if a != b), None)
             for o, w in zip(outs, want)]
    margins = []
    for i, (p, o, w, j) in enumerate(zip(prompts, outs, want, first)):
        if j is None:
            margins.append(None)
            continue
        row = (model.forward(torch.tensor([p + w["tokens"][:j]], device="cuda"))[0, -1]
               if logits is None else logits[j, i])
        top = row.topk(2).values
        margins.append({"top2_margin": (top[0] - top[1]).item(),
                        "chosen_gap": (row[w["tokens"][j]] - row[o["tokens"][j]]).item(),
                        "chosen_below_top1": (top[0] - row[o["tokens"][j]]).item(),
                        "top1": top[0].item(), "max_abs_logit": row.abs().max().item()})
        del row
    return {"tokens_equal": sum(j is None for j in first) / len(first), "first_difference": first,
            "margin_at_first_difference": margins}


def lora_specs(cfg) -> list:
    """The smoke run's adapters at the model's widths (``LORA_RANKS``)."""
    from gofr_tpu_torch.adapters import random_adapter

    return [random_adapter(f"ad{i}", cfg.hidden_size, cfg.vocab_size, rank=r, seed=LORA_SEED + i)
            for i, r in enumerate(LORA_RANKS)]


def serve(torch, cuda, model=None, kv_quantize: str = "", kv_layout: str = "paged",
          spec: str | None = None, draft=None, lora: bool = False, w8: bool = False,
          run: str | None = None) -> tuple[object, dict, dict, list]:
    """Serve 8 concurrent greedy requests on a Llama-3-8B engine with the
    cache ``kv_layout`` in the format ``kv_quantize``; a new model with
    random weights from the seed, or ``model`` when given. ``spec`` names a
    run of ``SPEC_RUNS``: speculative decoding, with ``draft`` as its draft
    model if given. With ``lora`` the engine has the adapter plane and the
    requests name ``LORA_LANES`` in turn. With ``w8`` (the run
    ``paged_w8``) the engine is built as a user builds it, from a
    ``ModelSpec`` of ``model`` and a container whose config is
    ``W8_CONFIG``: ``bf16``'s knobs with ``ENGINE_QUANTIZE=int8``; every
    product must then go through the W8A16 kernel, 7 x 32 + 1 launches a
    model forward. ``run`` names another model's run of ``ON_PATH``
    (``one_b_bf16``: the kernels of that run, its model's layers).
    Returns (engine, launches, metrics, the results)."""
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention

    cfg = LlamaConfig.llama3_8b() if model is None else model.cfg
    spec_kw = {} if spec is None else {"spec_tokens": SPEC_G}
    if draft is not None:
        spec_kw["spec_draft"] = (draft.cfg, draft)
    if lora:
        spec_kw.update(adapter_slots=LORA_SLOTS, adapter_rank=LORA_RANK)
    t0 = time.perf_counter()
    if w8:
        from gofr_tpu_torch.config import DictConfig
        from gofr_tpu_torch.container import Container
        from gofr_tpu_torch.models import ModelSpec

        eng = build_engine(ModelSpec("llama", cfg, weights=model, dtype=cfg.dtype),
                           Container(DictConfig(W8_CONFIG)), device="cuda", seed=SEED)
    else:
        eng = build_engine(cfg, params=model, device="cuda", seed=SEED, slots=8, max_len=2048,
                           max_prefill_batch=4, decode_chunk=8, kv_quantize=kv_quantize,
                           kv_layout=kv_layout, **spec_kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warm = eng.generate(list(range(1, 65)), max_new_tokens=2, timeout=600)
    require(warm["finish_reason"] == "length", f"warm-up request: {warm}")
    lanes = [None] * 8
    if lora:
        for spec_ in lora_specs(cfg):
            eng.register_adapter(spec_)
        lanes = [LORA_LANES[i % len(LORA_LANES)] for i in range(8)]

    prompts = phase4_prompts(torch, cfg.vocab_size)
    lens = [len(p) for p in prompts]
    torch.cuda.synchronize()
    before = dict(eng.counters)
    cuda.reset_launch_counts()
    t_submit = time.monotonic()
    reqs = [eng.submit(p, max_new_tokens=64, temperature=0.0, adapter_id=a)
            for p, a in zip(prompts, lanes)]
    outs = [r.result(timeout=900) for r in reqs]
    wait_idle(eng)
    torch.cuda.synchronize()
    t_done = time.monotonic()
    counts, offset_launches = cuda.launch_counts(), flash_attention.offset_launches
    did = {k: v - before[k] for k, v in eng.counters.items()}
    pool = (f"{kv_layout} {kv_quantize or 'bf16'}" + (f" ({spec})" if spec else "")
            + (" (lora)" if lora else "") + (" (int8 weights)" if w8 else ""))
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                f"{pool} request {i}: {o['finish_reason']}, {len(o['tokens'])} tokens")
        require(all(0 <= t < cfg.vocab_size for t in o["tokens"]),
                f"{pool} request {i}: token out of range")
    on_path = (ON_PATH[run] if run else ON_PATH["paged_w8"] if w8
               else ON_PATH[kv_layout, kv_quantize] if spec is None else ON_PATH_SPEC[spec])
    sfx = "_f32" if cfg.dtype == torch.float32 else ""
    for name, launches in counts.items():
        if name in on_path:
            require(launches > 0, f"kernel {name} was not launched on the {pool} cache's path")
        else:
            require(launches == 0, f"kernel {name} was launched {launches} times on the {pool} "
                                   f"cache's path")
    per_step = {counts[name] for name in on_path
                if name not in (*PREFILL_KERNELS, "w8a16", "w8a16_f32")}
    if w8:
        # a forward is a prefill or chunk call (C once a layer) or a decode
        # step (A once a layer); each makes 7 products a layer and the head's
        forwards = (counts["paged_decode" + sfx] + counts["flash_attention" + sfx]) // cfg.num_layers
        require(counts["w8a16" + sfx] == forwards * (7 * cfg.num_layers + 1),
                f"{pool}: W8A16 launched {counts['w8a16' + sfx]} times for {forwards} model "
                f"forwards, not {7 * cfg.num_layers + 1} each")
    if spec is None:
        require(len(per_step) == 1 and per_step.pop() % cfg.num_layers == 0,
                f"{pool} cache: the decode-step kernels' launches differ or are not whole steps: "
                f"{counts}")
    else:
        # C on verify rows once a layer a round (no prompt here chunks), and
        # the draft's F and G once a layer for each of its g + 1 steps a round
        rounds = did["spec_rounds"]
        require(did["prefill_chunks"] == 0 and rounds > 0 and
                offset_launches == rounds * cfg.num_layers,
                f"{pool}: C launched {offset_launches} times on verify rows for {rounds} rounds")
        if draft is not None:
            require(per_step == {rounds * (SPEC_G + 1) * draft.cfg.num_layers},
                    f"{pool}: the draft's kernels launched {counts} for {rounds} rounds")
    from gofr_tpu_torch.ops.paged import kv_plane_bytes_per_position

    cache = eng.cache
    positions = cache.k.shape[1] * cache.k.shape[3]  # pages x page size, or slots x Smax
    pool_bytes = sum(t.nbytes for t in vars(cache).values())
    # a position's bytes read from the cache's own planes: a K and a V row
    # of its row type, and a K and a V scale on a quantized cache
    per = cfg.num_layers * cfg.num_kv_heads * (
        2 * cache.k.shape[-1] * cache.k.element_size()
        + (2 * cache.ks.element_size() if hasattr(cache, "ks") else 0))
    mirrored = kv_plane_bytes_per_position(cfg.num_layers, cfg.num_kv_heads, cfg.head_size,
                                           kv_quantize or "bf16")
    require(pool_bytes == per * positions,
            f"{pool} cache holds {pool_bytes} B for {positions} positions, not {per} B each")
    # the JAX function's bytes, which it gives for bf16 K/V whatever the
    # model's dtype (mirrored; ROADMAP Queue C), hold on every other cache
    require(per == mirrored or (not kv_quantize and cfg.dtype == torch.float32),
            f"{pool} cache: {per} B a position, kv_plane_bytes_per_position says {mirrored}")
    first = [t_submit + o["ttft_s"] for o in outs]
    done = [f + o["decode_s"] for f, o in zip(first, outs)]
    decoded = sum(len(o["tokens"]) - 1 for o in outs)
    ttft = sorted(o["ttft_s"] for o in outs)
    metrics = {
        "model": ((run or "llama3_8b") + " (random "
                  + ("f32" if cfg.dtype == torch.float32 else "bf16") + " weights, seed 0"
                  + (", served in int8)" if w8 else ")")),
        "layers": cfg.num_layers,
        "kv_layout": kv_layout,
        "kv_pool": kv_quantize or ("f32" if cfg.dtype == torch.float32 else "bf16"),
        "pool_bytes": pool_bytes, "pool_positions": positions, "kv_bytes_per_position": per,
        "kv_plane_bytes_per_position": mirrored,
        "requests": len(outs), "prompt_lens": lens, "new_tokens": 64,
        "engine_build_s": build_s, "wall_s": t_done - t_submit,
        "ttft_s": [o["ttft_s"] for o in outs], "ttft_p50_s": ttft[len(ttft) // 2],
        "ttft_max_s": ttft[-1],
        "decode_tok_s": decoded / (max(done) - min(first)),
        "output_tok_s": sum(len(o["tokens"]) for o in outs) / (t_done - t_submit),
        "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "note": "smoke run, not a benchmark",
    }
    if w8:
        from gofr_tpu_torch.ops.quant import quantized_bytes

        held = quantized_bytes(eng.model)
        expect = llama_w8_bytes(cfg)
        require(run is not None or expect == W8_BYTES,
                f"{pool}: the closed form gives {expect} B for Llama-3-8B, not {W8_BYTES}")
        require(held == expect, f"{pool}: the int8 model holds {held} B, not {expect}")
        require(model is None or type(model.blocks[0].wq).__name__ == "Linear",
                f"{pool}: quantizing changed the bf16 model it was given")
        metrics.update({"weights": "int8", "quantized_bytes": held,
                        "w8a16_launches_per_forward": 7 * cfg.num_layers + 1,
                        "model_forwards": forwards})
    if lora:
        stats = eng.adapter_stats()
        require(stats["pool"]["resident"] == len(LORA_RANKS) and stats["pool"]["referenced"] == 0
                and not stats["registry"]["inflight"],
                f"{pool}: the adapter plane after the run: {stats}")
        metrics.update({"adapter_lanes": lanes, "adapter_ranks": list(LORA_RANKS),
                        "adapter_pool": stats["pool"]})
    if spec is not None:
        # one lane-round proposes g tokens and emits acc + 1
        lane_rounds = did["spec_proposed"] / SPEC_G
        metrics.update({
            "spec_tokens": SPEC_G, "draft_layers": draft.cfg.num_layers if draft else None,
            "spec": {k: v for k, v in did.items() if k.startswith("spec_")},
            "verify_launches_of_c": offset_launches,
            "accept_rate": did["spec_accepted"] / did["spec_proposed"],
            "tokens_per_lane_verify": (did["spec_accepted"] + lane_rounds) / lane_rounds,
        })
    return eng, counts, metrics, outs


# Phase 4's admission run: a pool too small for the burst unshared, so the
# prefix cache, chunked prefill and preemption all run. The tails span
# 128..640 and lean to 507..512, the longest that prefill in one chunk, so
# the 8 shared prompts decode at once and outgrow the pool together.
ADMISSION = {"page_size": 128, "total_pages": 40, "prefill_buckets": [128, 256, 512],
             "prefix": 768, "warm_tail": 16, "tails": [128, 640, 512, 511, 510, 509, 508, 507],
             "others": [64, 170, 277, 384]}


def admission_traffic(torch, vocab: int) -> tuple[list, list]:
    """(warm request, burst) of the admission run from the seed: the warm
    prompt is the 768-token system prefix and a tail of 16; the burst is 8
    prompts of that prefix and a distinct tail, then 4 unshared prompts."""
    rng = torch.Generator().manual_seed(SEED + 5)

    def draw(n: int) -> list:
        return torch.randint(0, vocab, (n,), generator=rng).tolist()

    prefix = draw(ADMISSION["prefix"])
    warm = prefix + draw(ADMISSION["warm_tail"])
    burst = [prefix + draw(n) for n in ADMISSION["tails"]] + [draw(n) for n in ADMISSION["others"]]
    return warm, burst


def admission_run(torch, model, warm, **kw) -> object:
    """A new admission engine on ``model`` that has served the warm
    request alone; ``kw`` sizes its pool, buckets and cache."""
    from gofr_tpu_torch.gpu.engine import build_engine

    eng = build_engine(model.cfg, params=model, device="cuda", seed=SEED, slots=8, max_len=2048,
                       max_prefill_batch=4, decode_chunk=8, page_size=ADMISSION["page_size"], **kw)
    out = eng.generate(warm, max_new_tokens=64, timeout=600)
    require(out["finish_reason"] == "length", f"admission warm request: {out['finish_reason']}")
    return eng


def serve_admission(torch, cuda, model) -> dict:
    """Phase 4 ``paged_admission``: the burst on a 40-page bf16 pool through
    the admission the JAX engine runs (EDF planner, chunked prefill, pages on
    demand, preemption by recompute, the prefix cache), the launch counters
    set to 0 just before the burst and read just after; then the same
    traffic unconstrained, for the token-equality share."""
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention

    cfg = model.cfg
    warm, burst = admission_traffic(torch, cfg.vocab_size)
    n_shared = len(ADMISSION["tails"])
    eng = admission_run(torch, model, warm, total_pages=ADMISSION["total_pages"],
                        prefill_buckets=ADMISSION["prefill_buckets"])
    before = dict(eng.counters)
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t_submit = time.monotonic()
    outs = [r.result(timeout=900) for r in [eng.submit(p, max_new_tokens=64) for p in burst]]
    wait_idle(eng)
    torch.cuda.synchronize()
    t_done = time.monotonic()
    counts, offset_launches = cuda.launch_counts(), flash_attention.offset_launches
    did = {k: v - before[k] for k, v in eng.counters.items()}
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                f"admission request {i}: {o['finish_reason']}, {len(o['tokens'])} tokens")
        require(all(0 <= t < cfg.vocab_size for t in o["tokens"]),
                f"admission request {i}: token out of range")
        if i < n_shared:
            require(o["prefix_hit_tokens"] >= ADMISSION["prefix"],
                    f"admission request {i}: {o['prefix_hit_tokens']} tokens from the prefix cache")
    require(did["preemptions"] >= 1, f"the admission burst preempted nothing: {did}")
    for name, launches in counts.items():
        if name in ON_PATH["paged", ""]:
            require(launches > 0, f"kernel {name} was not launched on the admission run")
        else:
            require(launches == 0, f"kernel {name} was launched {launches} times on the "
                                   f"admission run")
    require(did["prefill_chunks_at_offset"] >= 1 and
            offset_launches == did["prefill_chunks"] * cfg.num_layers,
            f"flash_attention launched {offset_launches} times on chunked rows for "
            f"{did['prefill_chunks']} chunks ({did['prefill_chunks_at_offset']} at an offset)")
    eng.check_page_refs()
    pool = eng.page_pool_stats()
    require(pool["slot_pages"] == 0 and
            pool["free_pages"] + pool["prefix_pages"] == ADMISSION["total_pages"],
            f"admission pool after the drain: {pool}")
    eng.stop()
    del eng
    torch.cuda.empty_cache()

    # the unconstrained run: no prefix cache, no chunking, the full pool
    free_eng = admission_run(torch, model, warm, prefix_cache=False, prefill_buckets=[2048])
    free_outs = [r.result(timeout=900) for r in [free_eng.submit(p, max_new_tokens=64)
                                                 for p in burst]]
    require(free_eng.counters["preemptions"] == 0 and free_eng.counters["prefill_chunks"] == 0,
            f"the unconstrained run preempted or chunked: {free_eng.counters}")
    free_eng.stop()
    del free_eng
    torch.cuda.empty_cache()

    first = [t_submit + o["ttft_s"] for o in outs]
    done = [f + o["decode_s"] for f, o in zip(first, outs)]
    ttft = sorted(o["ttft_s"] for o in outs)
    return {
        "model": "llama3_8b (random bf16 weights, seed 0)", "layers": cfg.num_layers,
        "kv_layout": "paged", "kv_pool": "bf16", **ADMISSION, "requests": len(outs),
        "prompt_lens": [len(p) for p in burst], "new_tokens": 64,
        "wall_s": t_done - t_submit, "ttft_s": [o["ttft_s"] for o in outs],
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "decode_tok_s": sum(len(o["tokens"]) - 1 for o in outs) / (max(done) - min(first)),
        "preemptions": did["preemptions"],
        "preemptions_by_request": [o["preemptions"] for o in outs],
        "prefix_hit_tokens": did["prefix_hit_tokens"],
        "prefix_hit_tokens_by_request": [o["prefix_hit_tokens"] for o in outs],
        "prefix_evicted_pages": did["prefix_evicted_pages"],
        "prefill_chunks": did["prefill_chunks"],
        "chunk_launches_at_offset": did["prefill_chunks_at_offset"] * cfg.num_layers,
        "flash_offset_launches": offset_launches, "launches": counts, "pool_after": pool,
        # against the unconstrained run: the equal share, per request the
        # index of the first token that differs (None: equal) and the margin
        **{f"{k}_unconstrained" if k == "tokens_equal" else k: v
           for k, v in token_agreement(torch, model, burst, outs, free_outs).items()},
        "note": "smoke run, not a benchmark",
    }


def serve_spec(torch, cuda, model, results: dict) -> dict:
    """Phase 4's speculative runs (``SPEC_RUNS``), each held to its
    ``ON_PATH_SPEC`` and compared with the plain run on its cache: the
    equal share and the margins at the first differences are printed, the
    share not held (C over a dense view rounds otherwise than the decode
    kernels); at each first difference the spec run's token must lie within
    ``SPEC_TIE_GAP`` of the top logit. On the first, one request is also
    streamed: its ids, joined, must equal that request's own result."""
    from gofr_tpu_torch.models.llama import LlamaConfig, init

    prompts = phase4_prompts(torch, model.cfg.vocab_size)
    out = {}
    for name, (kv_layout, kv_quantize) in SPEC_RUNS.items():
        t0 = time.perf_counter()
        draft = None
        if name == "slot_spec_draft":
            draft = init(LlamaConfig.llama3_8b(num_layers=DRAFT_LAYERS),
                         torch.Generator(device="cuda").manual_seed(SEED + 1), "cuda")
        eng, counts, metrics, outs = serve(torch, cuda, model, kv_quantize, kv_layout, spec=name,
                                           draft=draft)
        if name == "paged_spec":
            prompt = prompts[0][:128]
            it = eng.generate(prompt, max_new_tokens=32, timeout=600, stream=True)
            streamed = list(it)
            whole = it.result()["tokens"]
            require(streamed == whole and len(whole) == 32,
                    f"{name}: the streamed ids {streamed} differ from the result {whole}")
            metrics["stream"] = {"prompt_len": len(prompt), "tokens": len(whole),
                                 "equal_to_result": True}
        eng.stop()
        del eng, draft
        torch.cuda.empty_cache()
        metrics.update(token_agreement(torch, model, prompts, outs, results[kv_layout, kv_quantize]))
        metrics["compared_with"] = run_name(kv_layout, kv_quantize)
        emit(f"phase4_serve_{name}", {**metrics, "launches": counts,
                                      "run_wall_s": time.perf_counter() - t0})
        gaps = [m["chosen_below_top1"] for m in metrics["margin_at_first_difference"] if m]
        require(all(gap <= SPEC_TIE_GAP for gap in gaps),
                f"{name}: at a first difference from the plain run the spec run chose a token "
                f"{gaps} below the top logit (limit {SPEC_TIE_GAP})")
        out[name] = {"metrics": metrics, "launches": counts}
    return out


def serve_lora(torch, cuda, model, base: dict, base_outs: list) -> dict:
    """Phase 4 ``paged_lora``: ``bf16``'s traffic with the requests on
    ``LORA_LANES`` in turn, held as ``serve`` holds a run (the ``bf16`` run's
    kernels, 64 tokens a request), to its adapter pool at the end (3
    resident, none referenced), and to every adapter request's tokens
    differing from the ``bf16`` run's on the same prompt (the adapters move
    the logits far past bf16 ties, so a lane routed to the wrong slot shows).
    Printed beside the ``bf16`` run of the same call: the share of base
    requests whose tokens equal it, and tok/s."""
    eng, counts, metrics, outs = serve(torch, cuda, model, lora=True)
    eng.stop()
    del eng
    torch.cuda.empty_cache()
    lanes = metrics["adapter_lanes"]
    same = [o["tokens"] == w["tokens"] for o, w in zip(outs, base_outs)]
    on_base = [eq for eq, a in zip(same, lanes) if a is None]
    on_adapters = [eq for eq, a in zip(same, lanes) if a is not None]
    metrics.update({
        "base_tokens_equal_bf16": sum(on_base) / len(on_base),
        "adapter_tokens_differ_from_bf16": sum(not eq for eq in on_adapters) / len(on_adapters),
        "bf16_decode_tok_s": base["decode_tok_s"], "bf16_output_tok_s": base["output_tok_s"],
    })
    require(metrics["adapter_tokens_differ_from_bf16"] == 1.0,
            f"paged_lora: only {metrics['adapter_tokens_differ_from_bf16']} of the adapter "
            f"requests differ from the bf16 run's tokens on the same prompt, so some lane "
            f"was not routed to its adapter")
    return {"metrics": metrics, "launches": counts}


def serve_w8(torch, cuda, model, base: dict, base_outs: list) -> tuple[dict, object]:
    """Phase 4 ``paged_w8``: ``bf16``'s traffic on the engine built from a
    ``ModelSpec`` of phase 4's bf16 model with ``ENGINE_QUANTIZE=int8``
    (``serve`` with ``w8``), held as ``serve`` holds it (A, B, C and W8A16,
    W8A16 7 x 32 + 1 times a model forward, 64 tokens a request, the int8
    model's ``W8_BYTES``), the bf16 model left as it was. Printed beside the
    ``bf16`` run of the same call, not held (int8 weights move the logits):
    the share of requests whose tokens equal it, and tok/s and TTFT.
    Returns (the run's record, the int8 model, its pool freed)."""
    eng, counts, metrics, outs = serve(torch, cuda, model, w8=True)
    eng.stop()
    w8_model = eng.model
    del eng
    torch.cuda.empty_cache()
    agree = token_agreement(torch, model, phase4_prompts(torch, model.cfg.vocab_size), outs,
                            base_outs)
    metrics.update({"tokens_equal_bf16": agree["tokens_equal"],
                    "first_difference_vs_bf16": agree["first_difference"],
                    "margin_at_first_difference_bf16_model": agree["margin_at_first_difference"],
                    "bf16_decode_tok_s": base["decode_tok_s"],
                    "bf16_output_tok_s": base["output_tok_s"],
                    "bf16_ttft_p50_s": base["ttft_p50_s"], "bf16_ttft_max_s": base["ttft_max_s"]})
    return {"metrics": metrics, "launches": counts}, w8_model


def adopt_check(torch, cuda) -> dict:
    """Phase 4's adoption check: a bf16-pool engine on Llama-3-8B's widths
    cut to ``ADOPT_LAYERS`` layers, random weights from seed 20, takes new
    random weights (seed 21) by ``adopt_weights`` while 4 requests decode.
    Held: all 4 end with 64 tokens, each preempted once and recomputed,
    ``weights_epoch`` is 1, and a request after the swap equals, token for
    token, the same request on an engine built on the new weights."""
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models.llama import LlamaConfig, init

    cfg = LlamaConfig.llama3_8b(num_layers=ADOPT_LAYERS)
    old, new = (init(cfg, torch.Generator(device="cuda").manual_seed(SEED + s), "cuda")
                for s in (20, 21))
    knobs = dict(device="cuda", seed=SEED, slots=8, max_len=2048, max_prefill_batch=4,
                 decode_chunk=8)
    prompts = phase4_prompts(torch, cfg.vocab_size)
    eng = build_engine(cfg, params=old, **knobs)
    reqs = [eng.submit(p, max_new_tokens=64) for p in prompts[:4]]
    deadline = time.monotonic() + 300
    while sum(s is not None and bool(s.generated) for s in eng.slots) < 4:
        require(time.monotonic() < deadline, "adoption: the 4 requests never all decoded")
        time.sleep(0.001)
    t0 = time.perf_counter()
    epoch = eng.adopt_weights(new, timeout_s=300)
    swap_s = time.perf_counter() - t0
    outs = [r.result(timeout=600) for r in reqs]
    require(all(o["finish_reason"] == "length" and len(o["tokens"]) == 64 for o in outs),
            f"adoption: a request in flight did not complete: {[o['finish_reason'] for o in outs]}")
    require(epoch == eng.weights_epoch == 1, f"adoption: weights epoch {eng.weights_epoch}")
    require([o["preemptions"] for o in outs] == [1] * 4,
            f"adoption: preemptions {[o['preemptions'] for o in outs]}")
    after = eng.generate(prompts[4], max_new_tokens=32, timeout=600)["tokens"]
    eng.check_page_refs()
    eng.stop()
    fresh = build_engine(cfg, params=new, **knobs)
    want = fresh.generate(prompts[4], max_new_tokens=32, timeout=600)["tokens"]
    fresh.stop()
    del eng, fresh, old, new
    torch.cuda.empty_cache()
    require(after == want, f"adoption: tokens after the swap {after} differ from an engine built "
                           f"on the new weights {want}")
    return {"layers": ADOPT_LAYERS, "requests_in_flight": 4, "weights_epoch": epoch,
            "adopt_s": swap_s, "preemptions": [o["preemptions"] for o in outs],
            "after_swap_equals_new_engine": True, "tokens_compared": len(want)}


# Phase 4's ``paged_pipeline``: ``pipeline_depth`` 1 against 2 (the default)
# on the bf16 pool, one engine per arm on the phase's model, in turns
# ``DEPTHS``. 16 prompts of 64..1024 tokens from the seed, 64 greedy tokens
# each, go in 4 waves of 4, each wave submitted once the previous wave's
# first tokens are out, so its prefill lands while those lanes decode (the
# requests stream, and the wait blocks on each one's first token: a loop
# polling for it would take the interpreter lock from the engine's thread
# every time it wakes). After the timed waves each arm
# repeats a wave pair under ``torch.profiler``: the device's busy time over
# the second wave, from its submit to its first tokens (the profiler's
# stop and event processing hold the interpreter lock for seconds, so they
# come after the timed part).
PIPELINE = {"requests": 16, "waves": 4, "new_tokens": 64}
DEPTHS = (1, 2, 2, 1)


def wait_idle(eng, timeout: float = 120.0, allow_dropped: bool = False) -> dict:
    """Wait until the engine has folded every call it dispatched (a
    speculative round can go out for a lane that an older round's fold then
    ends, and its launches are counted); returns ``pipeline_stats()``. A
    call settled without a fold fails the hold, unless ``allow_dropped``
    says that a crash in this run dropped the calls in flight."""
    deadline = time.monotonic() + timeout
    while True:
        st = eng.pipeline_stats()
        dropped = st["dropped"] if allow_dropped else 0
        require(allow_dropped or st["dropped"] == 0, f"calls dropped without a crash: {st}")
        if st["folds"] + dropped == sum(st["dispatched"].values()):
            return st
        require(time.monotonic() < deadline, f"calls still in flight after the requests: {st}")
        time.sleep(0.001)


def pipeline_prompts(torch, vocab: int) -> list[list[int]]:
    """The timed waves' prompts, then two more waves' for the profiled
    pair (new prompts: the timed ones sit in the prefix cache)."""
    n = PIPELINE["requests"] + 2 * PIPELINE["requests"] // PIPELINE["waves"]
    rng = torch.Generator().manual_seed(SEED + 6)
    lens = torch.randint(64, 1025, (n,), generator=rng).tolist()
    return [torch.randint(0, vocab, (k,), generator=rng).tolist() for k in lens]


def submit_wave(eng, prompts: list) -> list:
    """Submit a wave of streamed requests and block until each has its
    first token (its first streamed id)."""
    wave = [eng.submit(p, max_new_tokens=PIPELINE["new_tokens"], stream=True) for p in prompts]
    for r in wave:
        require(r.stream_q.get(timeout=600) is not None, "a wave's request ended before a token")
    return wave


def profiled_wave(torch, eng, prompts: list, marks: list | None = None) -> dict:
    """Two waves after the timed ones, the second under torch.profiler:
    the device's busy ms (kernels and copies) over the second wave's
    window, its submit to its first tokens, and the idle share. ``marks``
    gets the window's start and end on the monotonic clock."""
    from torch.profiler import ProfilerActivity

    from gofr_tpu_torch.gpu.launch_gate import quiet_profile

    per = PIPELINE["requests"] // PIPELINE["waves"]
    first = submit_wave(eng, prompts[:per])
    # started and stopped between the engine's turns: a session started or
    # stopped while the engine's thread launches can trace no kernel
    with quiet_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if marks is not None:
            marks.append(time.monotonic())
        second = submit_wave(eng, prompts[per:2 * per])
        # the trace closes once the card has run what was launched in the
        # window, so the window ends there too
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        if marks is not None:
            marks.append(time.monotonic())
    for r in first + second:
        r.result(timeout=900)
    busy_ms = sum(e.device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    require(busy_ms >= 0.01 * window_s * 1e3,
            f"the profiled wave traced {busy_ms} ms of device time in {window_s} s")
    return {"profiled_wave_s": window_s, "profiled_wave_device_busy_ms": busy_ms,
            "profiled_wave_device_idle_share": 1.0 - busy_ms / (window_s * 1e3)}


def pipeline_arm(torch, cuda, model, depth: int, prompts: list) -> tuple[list, dict, dict]:
    """One arm of ``paged_pipeline``: (results, metrics, launches)."""
    from gofr_tpu_torch.gpu.engine import build_engine

    eng = build_engine(model.cfg, params=model, device="cuda", seed=SEED, slots=8, max_len=2048,
                       max_prefill_batch=4, decode_chunk=8, pipeline_depth=depth)
    warm = eng.generate(list(range(1, 65)), max_new_tokens=2, timeout=600)
    require(warm["finish_reason"] == "length", f"pipeline depth {depth} warm-up: {warm}")
    before = wait_idle(eng)
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    per = PIPELINE["requests"] // PIPELINE["waves"]
    reqs = []
    t_submit = time.monotonic()
    for w in range(PIPELINE["waves"]):
        reqs += submit_wave(eng, prompts[w * per:(w + 1) * per])
    outs = [r.result(timeout=900) for r in reqs]
    st = wait_idle(eng)
    torch.cuda.synchronize()
    t_done = time.monotonic()
    counts = cuda.launch_counts()
    profiled = profiled_wave(torch, eng, prompts[PIPELINE["requests"]:])
    eng.stop()
    del eng
    torch.cuda.empty_cache()
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == PIPELINE["new_tokens"],
                f"pipeline depth {depth} request {i}: {o['finish_reason']}, "
                f"{len(o['tokens'])} tokens")
    for name, launches in counts.items():
        if name in ON_PATH["paged", ""]:
            require(launches > 0, f"kernel {name} was not launched at pipeline depth {depth}")
        else:
            require(launches == 0, f"kernel {name} was launched {launches} times at pipeline "
                                   f"depth {depth}")
    # a turn leaves at most depth - 1 calls in flight while the host plans
    # the next; within a turn the queue also takes that turn's dispatches
    require(st["dq_carried_max"] == depth - 1 and (depth == 1 or st["dq_max"] >= depth),
            f"pipeline depth {depth}: the queue carried {st['dq_carried_max']} calls across a "
            f"turn at most, held {st['dq_max']} at most")
    turns = st["busy_turns"] - before["busy_turns"]
    folds = st["folds"] - before["folds"]
    first = [t_submit + o["ttft_s"] for o in outs]
    done = [f + o["decode_s"] for f, o in zip(first, outs)]
    ttft = sorted(o["ttft_s"] for o in outs)
    return outs, {
        "pipeline_depth": depth, "requests": len(outs), "waves": PIPELINE["waves"],
        "new_tokens": PIPELINE["new_tokens"], "wall_s": t_done - t_submit,
        "output_tok_s": sum(len(o["tokens"]) for o in outs) / (t_done - t_submit),
        "decode_tok_s": sum(len(o["tokens"]) - 1 for o in outs) / (max(done) - min(first)),
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "host_ms_per_turn": (st["busy_turn_s"] - before["busy_turn_s"]) / turns * 1e3,
        "turns": turns, "folds": folds,
        "fold_wait_ms": (st["fold_wait_s"] - before["fold_wait_s"]) * 1e3,
        "fold_wait_ms_per_fold": (st["fold_wait_s"] - before["fold_wait_s"]) / folds * 1e3,
        "dq_max": st["dq_max"], "dq_carried_max": st["dq_carried_max"],
        "dispatched": {k: v - before["dispatched"].get(k, 0) for k, v in st["dispatched"].items()},
        **profiled,
    }, counts


def serve_pipeline(torch, cuda, model) -> dict:
    """Phase 4 ``paged_pipeline``: the arms in turns ``DEPTHS``; every arm's
    tokens against the first depth-1 arm's by the tie rule. Nothing about
    speed is held."""
    prompts = pipeline_prompts(torch, model.cfg.vocab_size)
    timed = prompts[:PIPELINE["requests"]]
    arms, base = [], None
    for depth in DEPTHS:
        outs, metrics, counts = pipeline_arm(torch, cuda, model, depth, prompts)
        if base is None:
            base = outs
        else:
            agree = token_agreement(torch, model, timed, outs, base)
            gaps = [m["chosen_below_top1"] for m in agree["margin_at_first_difference"] if m]
            require(all(gap <= SPEC_TIE_GAP for gap in gaps),
                    f"paged_pipeline depth {depth}: at a first difference from depth 1 the run "
                    f"chose a token {gaps} below the top logit (limit {SPEC_TIE_GAP})")
            metrics.update(agree)
        arms.append({**metrics, "launches": counts})
    return {"model": "llama3_8b (random bf16 weights, seed 0)", "layers": model.cfg.num_layers,
            "kv_layout": "paged", "kv_pool": "bf16", "prompt_lens": [len(p) for p in timed],
            "order": list(DEPTHS), "arms": arms, "nvidia_smi": smi_line(),
            "note": "an A/B in one call, not a benchmark; nothing about speed is held"}


# Phase 4's ``paged_prefix_host``: ``paged_admission``'s warm request and burst
# on its 40-page pool with a host tier of ``prefix_host_mb`` (the
# ENGINE_PREFIX_HOST_MB knob; 512 MiB holds 32 of Llama-3-8B's 16 MiB bf16
# pages, the shared prefix's 6 five times over), then a pressure burst that
# needs the whole pool (4 prompts of 1025 tokens, 8 full pages, 200 new
# tokens: 10 pages a request), which spills every page the cache holds,
# and leaves 2 pages a request free when it ends; then the 8 shared prompts
# again. The same traffic with the host tier off is the comparison.
HOST_TIER = {"prefix_host_mb": 512, "pressure_prompt": 1025, "pressure_requests": 4,
             "pressure_new": 200}
# The card's host link, where nvidia-smi reports none: PCIe Gen5 x16 (H100
# SXM data sheet), 32 GT/s a lane, 128b/130b, one direction.
PCIE5_X16_BYTES_PER_S = 32e9 * 16 * 128 / 130 / 8


def host_link_gb_s() -> tuple[float, str]:
    """The host link's raw rate in GB/s, one direction, at the generation
    and width nvidia-smi reports (``pcie.link.gen.max``,
    ``pcie.link.width.max``), and where it came from; the data sheet's
    Gen5 x16 where nvidia-smi answers N/A."""
    line = subprocess.run(["nvidia-smi", "--query-gpu=pcie.link.gen.max,pcie.link.width.max",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    try:
        gen, width = (int(x) for x in line.split(","))
    except ValueError:
        return PCIE5_X16_BYTES_PER_S / 1e9, f"nvidia-smi: {line}; H100 SXM data sheet: Gen5 x16"
    gt_s = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0}[gen]
    return gt_s * width * (0.8 if gen < 3 else 128 / 130) / 8, f"nvidia-smi: {line}"


def prefix_host_run(torch, model, host_mb: float) -> dict:
    """The three bursts on one admission engine with a host tier of
    ``host_mb`` MiB (0: off); the pool audit after each."""
    cfg = model.cfg
    warm, burst = admission_traffic(torch, cfg.vocab_size)
    rng = torch.Generator().manual_seed(SEED + 7)
    pressure = [torch.randint(0, cfg.vocab_size, (HOST_TIER["pressure_prompt"],),
                              generator=rng).tolist()
                for _ in range(HOST_TIER["pressure_requests"])]
    second = burst[:len(ADMISSION["tails"])]
    eng = admission_run(torch, model, warm, total_pages=ADMISSION["total_pages"],
                        prefill_buckets=ADMISSION["prefill_buckets"], prefix_host_mb=host_mb)
    outs, counters, pools = {}, {}, {}
    for name, prompts, n_new in (("burst", burst, 64),
                                 ("pressure", pressure, HOST_TIER["pressure_new"]),
                                 ("second", second, 64)):
        before = dict(eng.counters)
        t0 = time.monotonic()
        outs[name] = [r.result(timeout=900)
                      for r in [eng.submit(p, max_new_tokens=n_new) for p in prompts]]
        wait_idle(eng)
        torch.cuda.synchronize()
        counters[name] = {k: v - before[k] for k, v in eng.counters.items()}
        counters[name]["wall_s"] = time.monotonic() - t0
        eng.check_page_refs()
        pools[name] = eng.page_pool_stats()
        for i, o in enumerate(outs[name]):
            require(o["finish_reason"] == "length" and len(o["tokens"]) == n_new,
                    f"prefix_host ({host_mb} MiB) {name} request {i}: {o['finish_reason']}")
    stats = eng.pipeline_stats()
    eng.stop()
    del eng
    torch.cuda.empty_cache()
    return {"outs": outs, "counters": counters, "pools": pools, "stats": stats,
            "prompts": {"burst": burst, "pressure": pressure, "second": second}}


def serve_prefix_host(torch, cuda, model) -> dict:
    """Phase 4 ``paged_prefix_host``: the traffic with the host tier on,
    then off, the launch counters over both. Held: the pressure spilled
    pages; the second wave swapped pages in, served the shared 768-token
    prefix to each of its prompts from the cache and at least those 6 pages
    from the host tier (its first prompt swaps them in; the others share
    the swapped pages); every run's tokens against the host-tier-off run's
    by the tie rule; the pool and tier audit after each burst; the bf16
    pool's kernels and no other. Printed: the swap-ins' pages, bytes, time
    on the card and GB/s beside the host link's raw rate."""
    cuda.reset_launch_counts()
    on = prefix_host_run(torch, model, HOST_TIER["prefix_host_mb"])
    off = prefix_host_run(torch, model, 0.0)
    counts = cuda.launch_counts()
    prefix = ADMISSION["prefix"]
    spilled = on["counters"]["pressure"]["prefix_spilled_pages"]
    wave = on["counters"]["second"]
    require(spilled > 0, f"paged_prefix_host: the pressure spilled nothing: {on['counters']}")
    require(wave["prefix_swapin_pages"] > 0 and wave["prefix_host_hit_tokens"] >= prefix
            and all(o["prefix_hit_tokens"] >= prefix for o in on["outs"]["second"]),
            f"paged_prefix_host: the second wave's hits {[o['prefix_hit_tokens'] for o in on['outs']['second']]}, "
            f"host {[o['prefix_host_tokens'] for o in on['outs']['second']]}: {wave}")
    for name, launches in counts.items():
        if name in ON_PATH["paged", ""]:
            require(launches > 0, f"kernel {name} was not launched on the prefix_host runs")
        else:
            require(launches == 0, f"kernel {name} was launched {launches} times on the "
                                   f"prefix_host runs")
    agree = {}
    for name in ("burst", "pressure", "second"):
        agree[name] = token_agreement(torch, model, on["prompts"][name], on["outs"][name],
                                      off["outs"][name])
        gaps = [m["chosen_below_top1"] for m in agree[name]["margin_at_first_difference"] if m]
        require(all(gap <= SPEC_TIE_GAP for gap in gaps),
                f"paged_prefix_host {name}: at a first difference from the host-tier-off run "
                f"the run chose a token {gaps} below the top logit (limit {SPEC_TIE_GAP})")
    swap_s = on["stats"]["swapin_s"]
    nbytes = sum(c["prefix_swapin_bytes"] for c in on["counters"].values())
    link, link_line = host_link_gb_s()
    second_ttft = {arm: sorted(o["ttft_s"] for o in run["outs"]["second"])
                   for arm, run in (("host_tier", on), ("off", off))}
    return {
        "model": "llama3_8b (random bf16 weights, seed 0)", "layers": model.cfg.num_layers,
        "kv_pool": "bf16", **HOST_TIER, "total_pages": ADMISSION["total_pages"],
        "counters": on["counters"], "counters_host_tier_off": off["counters"],
        "pool_after": on["pools"], "host_pages_after": on["pools"]["second"]["prefix_host_pages"],
        "second_wave_hit_tokens": [o["prefix_hit_tokens"] for o in on["outs"]["second"]],
        "second_wave_host_tokens": [o["prefix_host_tokens"] for o in on["outs"]["second"]],
        "second_wave_ttft_p50_s": {k: v[len(v) // 2] for k, v in second_ttft.items()},
        "second_wave_ttft_max_s": {k: v[-1] for k, v in second_ttft.items()},
        "swapin_pages": sum(c["prefix_swapin_pages"] for c in on["counters"].values()),
        "swapin_bytes": nbytes, "swapin_ms": swap_s * 1e3,
        "swapin_gb_s": nbytes / swap_s / 1e9 if swap_s else None,
        "swapin_share_of_host_link": nbytes / swap_s / 1e9 / link if swap_s else None,
        "host_link_gb_s": link, "host_link_source": link_line,
        "tokens_equal_host_tier_off": {k: v["tokens_equal"] for k, v in agree.items()},
        "first_difference": {k: v["first_difference"] for k, v in agree.items()},
        "launches": counts, "nvidia_smi": smi_line(),
        "note": "smoke run, not a benchmark",
    }


# Phase 4's ``http_generate``: the bf16 run's traffic over localhost through
# the port's App, the engine built from a ModelSpec and this config, as an
# operator builds it (random weights from the seed: the phase's model).
HTTP_CONFIG = {"HTTP_PORT": "0", "METRICS_PORT": "0", "ENGINE_SLOTS": "8",
               "ENGINE_MAX_LEN": "2048", "ENGINE_PREFILL_BATCH": "4",
               "ENGINE_DECODE_CHUNK": "8", "ENGINE_KV_DTYPE": "bf16", "LOG_LEVEL": "ERROR"}
HTTP_STREAMS = 2


def http_call(port: int, method: str, path: str, body: dict | None = None,
              headers: dict | None = None) -> tuple[int, dict, float, float, dict]:
    """One request on its own connection: (status, JSON body, client
    seconds, the monotonic time it started, the response's headers)."""
    import http.client

    t0 = time.monotonic()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        data = json.loads(resp.read())
        return resp.status, data, time.monotonic() - t0, t0, dict(resp.getheaders())
    finally:
        conn.close()


class AppThread:
    """An App's servers on an event loop of their own thread, as
    ``app.run()`` serves them; leaving the block stops the App (its servers,
    then the container: the engines and the tracer) and joins the thread."""

    def __init__(self, app, name: str):
        import asyncio
        import threading

        self.app, self.failed, self.ready = app, [], threading.Event()
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, name=name, daemon=True)

    def _run(self) -> None:
        import asyncio

        async def main() -> None:
            started = asyncio.Event()
            task = asyncio.ensure_future(self.app.arun(ready=started))
            await started.wait()
            self.ready.set()
            await task

        try:
            self.loop.run_until_complete(main())
        except BaseException as e:  # noqa: BLE001 - reported by the caller
            self.failed.append(e)
            self.ready.set()
        finally:
            self.loop.close()

    def __enter__(self) -> "AppThread":
        self.thread.start()
        require(self.ready.wait(120) and not self.failed,
                f"{self.thread.name}: the App did not start: {self.failed}")
        return self

    def __exit__(self, *exc) -> None:
        self.loop.call_soon_threadsafe(self.app.stop)
        self.thread.join(120)
        require(not self.thread.is_alive() and not self.failed,
                f"{self.thread.name}: the App did not stop cleanly: {self.failed}")


def http_stream(port: int, body: dict) -> dict:
    """One ``POST /generate/stream``: the frames as (event, data), the
    seconds to the first data frame and to the end, at the client."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        conn.request("POST", "/generate/stream", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        require(resp.status == 200 and resp.getheader("Content-Length") is None
                and resp.getheader("Content-Type") == "text/event-stream",
                f"http_generate stream: {resp.status} {resp.getheaders()}")
        frames, event, first = [], None, None
        while line := resp.readline():
            line = line.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: "):
                if first is None:
                    first = time.perf_counter() - t0
                frames.append((event, json.loads(line[len("data: "):])))
        return {"frames": frames, "first_event_s": first, "wall_s": time.perf_counter() - t0}
    finally:
        conn.close()


def http_generate(torch, cuda, model, base: dict, base_outs: list) -> dict:
    """Phase 4 ``http_generate``: the port's App on localhost, its engine
    built by ``serve_model("lm", ModelSpec(llama3_8b, bf16), seed=0)`` from
    ``HTTP_CONFIG``. Held: alive and health (``model:lm`` UP); the 8 prompts
    as 8 concurrent ``POST /generate``, each 201 with 64 tokens ended by
    length, compared with the ``bf16`` run by ``token_agreement`` (at a
    first difference the token within ``SPEC_TIE_GAP`` of the top logit:
    HTTP arrival can batch otherwise); two prompts streamed, ``token``
    frames then ``done``, their ids held against the same prompt's unary
    result by the same rule; a 0.001 s timeout is a 408 and an unknown path
    a 404, each with the error envelope; ``app_http_response`` counts >= 10
    for ``POST /generate``; the launch counters, zeroed after the warm-up,
    show the ``bf16`` run's kernels and no other; after ``stop`` the
    engine's thread has ended. Printed, not held: per request the client
    wall time, the engine's ttft and decode seconds and the HTTP overhead
    (wall less both), the part before the submit split at the server's
    times (accepted, read, handler entered, body bound) and as a share of
    the TTFT the client sees, the SSE first event against the engine's
    ttft, and decode tok/s beside ``bf16``'s."""
    import threading

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.models import ModelSpec
    from gofr_tpu_torch.models.llama import LlamaConfig

    app = App(config=DictConfig(HTTP_CONFIG))
    t0 = time.perf_counter()
    engine = app.serve_model("lm", ModelSpec("llama", LlamaConfig.llama3_8b(), dtype=torch.bfloat16),
                             seed=SEED, eos_token_id=-1)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    submitted, submit = [], engine.submit

    def record(*a, **kw):
        submitted.append(submit(*a, **kw))
        return submitted[-1]

    engine.submit = record
    server_stamps: dict[tuple, tuple] = {}

    async def generate(ctx):
        t_handler = time.monotonic()
        body = ctx.bind(dict)
        stamps = ctx.request.context()
        server_stamps[tuple(body["prompt"])] = (stamps["accepted_at"], stamps["read_at"], t_handler,
                                                time.monotonic())
        return await ctx.agenerate("lm", body["prompt"], max_new_tokens=int(body["max_new_tokens"]),
                                   timeout=body.get("timeout", 900))

    def generate_stream(ctx):
        from gofr_tpu_torch.http.streaming import StreamingResponse

        body = ctx.bind(dict)
        return StreamingResponse(ctx.generate("lm", body["prompt"],
                                              max_new_tokens=int(body["max_new_tokens"]),
                                              timeout=900, stream=True), event="token")

    app.post("/generate", generate)
    app.post("/generate/stream", generate_stream)
    with AppThread(app, "http-generate"):
        port = app.http_port
        status, alive, *_ = http_call(port, "GET", "/.well-known/alive")
        require(status == 200 and alive == {"data": {"status": "UP"}}, f"alive: {status} {alive}")
        status, health, *_ = http_call(port, "GET", "/.well-known/health")
        require(status == 200 and health["data"]["services"]["model:lm"]["status"] == "UP",
                f"health: {status} {health}")
        status, warm, *_ = http_call(port, "POST", "/generate",
                                    {"prompt": list(range(1, 65)), "max_new_tokens": 2})
        require(status == 201 and warm["data"]["finish_reason"] == "length",
                f"http warm-up: {status} {warm}")
        prompts = phase4_prompts(torch, model.cfg.vocab_size)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        del submitted[:]
        replies = [None] * len(prompts)

        def one(i: int) -> None:
            replies[i] = http_call(port, "POST", "/generate",
                                   {"prompt": prompts[i], "max_new_tokens": 64})

        t_submit = time.monotonic()
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        t_done = time.monotonic()
        reqs = list(submitted)
        stamps = [server_stamps[tuple(p)] for p in prompts]
        for i, r in enumerate(replies):
            require(r is not None and r[0] == 201, f"http request {i}: {r and r[:2]}")
            o = r[1]["data"]
            require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                    f"http request {i}: {o['finish_reason']}, {len(o['tokens'])} tokens")
        outs = [r[1]["data"] for r in replies]
        streams = [http_stream(port, {"prompt": prompts[i], "max_new_tokens": 64})
                   for i in range(HTTP_STREAMS)]
        stream_reqs = submitted[len(reqs):]
        status, late, *_ = http_call(port, "POST", "/generate",
                                    {"prompt": prompts[0], "max_new_tokens": 64, "timeout": 0.001})
        require(status == 408 and late == {"error": {"message": "request timed out"}},
                f"a 0.001 s timeout: {status} {late}")
        status, lost, *_ = http_call(port, "GET", "/no/such/route")
        require(status == 404 and lost == {"error": {"message": "route not registered"}},
                f"an unknown path: {status} {lost}")
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{app.metrics_port}/metrics",
                                    timeout=60) as r:
            exposition = r.read().decode()
        posts = sum(float(line.rsplit(" ", 1)[1]) for line in exposition.splitlines()
                    if line.startswith("app_http_response_count{")
                    and 'method="POST"' in line and 'path="/generate"' in line)
        require(posts >= 10, f"app_http_response counts {posts} POST /generate")
    require(not engine._thread.is_alive(), "http_generate: the engine's thread outlived stop()")
    for name, launches in counts.items():
        if name in ON_PATH["paged", ""]:
            require(launches > 0, f"kernel {name} was not launched on the http_generate run")
        else:
            require(launches == 0, f"kernel {name} was launched {launches} times on the "
                                   f"http_generate run")
    agreement_ = token_agreement(torch, model, prompts, outs, base_outs)
    gaps = [m["chosen_below_top1"] for m in agreement_["margin_at_first_difference"] if m]
    require(all(gap <= SPEC_TIE_GAP for gap in gaps),
            f"http_generate: at a first difference from the bf16 run the token lies {gaps} below "
            f"the top logit (limit {SPEC_TIE_GAP})")
    stream_outs, first_event = [], []
    for s, req in zip(streams, stream_reqs):
        frames = s["frames"]
        require(len(frames) == 65 and frames[-1] == ("done", {})
                and all(e == "token" and isinstance(d, int) for e, d in frames[:-1]),
                f"http stream: {len(frames)} frames, last {frames[-1:]}")
        result = req.outcome()[0]
        stream_outs.append({"tokens": [d for _, d in frames[:-1]]})
        first_event.append({"client_first_event_s": s["first_event_s"], "engine_ttft_s":
                            result["ttft_s"], "gap_s": s["first_event_s"] - result["ttft_s"],
                            "client_wall_s": s["wall_s"]})
    stream_agreement = token_agreement(torch, model, prompts[:HTTP_STREAMS], stream_outs,
                                       outs[:HTTP_STREAMS])
    gaps = [m["chosen_below_top1"] for m in stream_agreement["margin_at_first_difference"] if m]
    require(all(gap <= SPEC_TIE_GAP for gap in gaps),
            f"http_generate: a streamed request's first difference from its unary result lies "
            f"{gaps} below the top logit (limit {SPEC_TIE_GAP})")
    walls = [r[2] for r in replies]
    overhead = sorted(w - (o["ttft_s"] + o["decode_s"]) for w, o in zip(walls, outs))
    # the overhead's two halves: client start to the engine's submit, and
    # the engine's finish to the client's last byte
    reqs = [next(q for q in reqs if q.inputs == p) for p in prompts]
    to_submit = [q.enqueued_at - r[3] for q, r in zip(reqs, replies)]
    # the part before the submit, broken down at the server's own times:
    # the client's start, the connection accepted, the request read, the
    # handler entered, the body bound, the engine's submit
    marks = [(r[3], *s, q.enqueued_at) for r, s, q in zip(replies, stamps, reqs)]
    spans = {name: [m[i + 1] - m[i] for m in marks] for i, name in enumerate(
        ("client_to_accept_s", "accept_to_read_s", "read_to_handler_s", "handler_to_bind_s",
         "bind_to_submit_s"))}
    # each client thread's start after the first's: a span that falls as
    # this rises ends at one moment for all
    client_start = [r[3] - min(q[3] for q in replies) for r in replies]
    # the user's TTFT is the client's start to the first token
    pre_submit_share = [t / (t + o["ttft_s"]) for t, o in zip(to_submit, outs)]
    after_finish = [r[3] + r[2] - (q.enqueued_at + o["ttft_s"] + o["decode_s"])
                    for q, r, o in zip(reqs, replies, outs)]
    first = [req.enqueued_at + o["ttft_s"] for req, o in zip(reqs, outs)]
    done = [f + o["decode_s"] for f, o in zip(first, outs)]
    decode_tok_s = sum(len(o["tokens"]) - 1 for o in outs) / (max(done) - min(first))
    del engine, app
    torch.cuda.empty_cache()
    return {
        "model": "llama3_8b (random bf16 weights, seed 0)", "config": HTTP_CONFIG,
        "engine_build_s": build_s, "requests": len(outs), "new_tokens": 64,
        "client_wall_s": walls, "ttft_s": [o["ttft_s"] for o in outs],
        "decode_s": [o["decode_s"] for o in outs],
        "http_overhead_p50_s": overhead[len(overhead) // 2], "http_overhead_max_s": overhead[-1],
        "client_to_submit_s": to_submit, "client_start_s": client_start,
        "pre_submit_spans": spans,
        "pre_submit_share_of_ttft": pre_submit_share, "finish_to_client_s": after_finish,
        "sse_first_event": first_event, "wall_s": t_done - t_submit,
        "decode_tok_s": decode_tok_s, "bf16_decode_tok_s": base["decode_tok_s"],
        "decode_tok_s_vs_bf16": decode_tok_s / base["decode_tok_s"],
        **agreement_, "compared_with": "bf16",
        "stream_tokens_equal_unary": stream_agreement["tokens_equal"],
        "metrics_post_generate": posts, "launches": counts, "nvidia_smi": smi_line(),
        "note": "smoke run, not a benchmark",
    }


# Phase 4's ``http_planes``: ``http_generate``'s App with the request planes
# on (``PLANES_CONFIG``: spans in memory, QoS with a tenant limit, the SLO
# engine and the debug routes) against ``HTTP_CONFIG`` alone (the planes a
# container always has: metrics, flight recorder, perf plane, SLO), in turns
# off, on, on, off. The engine serves the phase's bf16 model
# (``ModelSpec(weights=model)``, no second draw). Each arm sends
# ``phase4_prompts`` as batch work and, without waiting, the first 8 of
# ``pipeline_prompts`` as interactive work, 64 new tokens each.
PLANES_CONFIG = {**HTTP_CONFIG, "APP_ENV": "DEBUG", "TRACE_EXPORTER": "memory",
                 "SLO_ENABLED": "true", "QOS_ENABLED": "true", "QOS_TENANT_RPS": "1"}
PLANES_ARMS = ("off", "on", "on", "off")
PLANES_NEW = 64
# the tenant whose second request in a second is past QOS_TENANT_RPS
PLANES_TENANT = "burst"
SPAN_ORDER = ["engine.queue_wait", "engine.prefill", "engine.decode", "engine.finish"]
# the perf plane's MFU / MBU must read at most this (1 + a rounding margin)
PLANES_MAX_RATIO = 1.05


def scrape(port: int) -> dict[str, float]:
    """The metrics server's exposition: {series with its labels: value}."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
        text = r.read().decode()
    return {line.rpartition(" ")[0]: float(line.rpartition(" ")[2])
            for line in text.splitlines() if line and not line.startswith("#")}


def series_sum(metrics: dict, name: str, **labels: str) -> float:
    """The sum of ``name``'s series that carry ``labels``."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    return sum(v for k, v in metrics.items()
               if (k == name or k.startswith(name + "{")) and all(w in k for w in want))


def planes_arm(torch, cuda, model, arm: str, base_outs: list) -> dict:
    """One arm of ``http_planes``; the holds are ``http_planes``'."""
    import threading

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.models import ModelSpec

    on = arm == "on"
    vocab = model.cfg.vocab_size
    batch, others = phase4_prompts(torch, vocab), pipeline_prompts(torch, vocab)
    interactive, profiled = others[:8], others[PIPELINE["requests"]:]
    app = App(config=DictConfig(PLANES_CONFIG if on else HTTP_CONFIG))
    engine = app.serve_model("lm", ModelSpec("llama", model.cfg, weights=model,
                                             dtype=model.cfg.dtype), seed=SEED, eos_token_id=-1)
    require(engine.perf is not None and engine.flight is not None,
            f"http_planes {arm}: the engine has no perf plane or flight recorder")
    submitted, submit = [], engine.submit

    def record(*a, **kw):
        submitted.append(submit(*a, **kw))
        return submitted[-1]

    engine.submit = record

    async def generate(ctx):
        body = ctx.bind(dict)
        return await ctx.agenerate("lm", body["prompt"], max_new_tokens=int(body["max_new_tokens"]),
                                   timeout=body.get("timeout", 900))

    app.post("/generate", generate)
    out: dict = {"arm": arm}
    with AppThread(app, f"http-planes-{arm}"):
        port = app.http_port
        status, warm, *_ = http_call(port, "POST", "/generate",
                                     {"prompt": list(range(1, 65)), "max_new_tokens": 2})
        require(status == 201, f"http_planes {arm} warm-up: {status} {warm}")
        wait_idle(engine)
        if on:
            burst = [http_call(port, "GET", "/no/such/route", headers={"X-Tenant-ID": PLANES_TENANT})
                     for _ in range(2)]
            require(burst[0][0] == 404 and burst[1][0] == 429 and burst[1][1] == {
                "error": {"message": "rate limit exceeded; retry later"}}
                and burst[1][4].get("Retry-After") == "1",
                    f"http_planes: a tenant burst past QOS_TENANT_RPS: {[b[:2] for b in burst]} "
                    f"{burst[1][4]}")
        torch.cuda.synchronize()
        before, st0 = scrape(app.metrics_port), engine.pipeline_stats()
        cuda.reset_launch_counts()
        del submitted[:]
        replies: dict = {}

        def one(key, prompt, cls):
            replies[key] = http_call(port, "POST", "/generate",
                                     {"prompt": prompt, "max_new_tokens": PLANES_NEW},
                                     headers={"X-QoS-Class": cls})

        jobs = [(("batch", i), p, "batch") for i, p in enumerate(batch)] + [
            (("interactive", i), p, "interactive") for i, p in enumerate(interactive)]
        threads = [threading.Thread(target=one, args=job) for job in jobs]
        t_submit = time.monotonic()
        for th in threads:
            th.start()
        if on:
            # while the 16 queue, a request whose deadline is below the
            # predicted wait: the JAX verdict, 504 before it takes a slot
            # (qos/__init__.py: admit_engine)
            deadline, wait = time.monotonic() + 60, 0.0
            while wait <= 0 and time.monotonic() < deadline:
                wait = app.container.qos.predicted_wait(engine)
                time.sleep(0.001)
            require(wait > 0, "http_planes: the predicted wait stayed 0 while 16 requests queued")
            probe = http_call(port, "POST", "/generate", {
                "prompt": interactive[0][:100], "max_new_tokens": PLANES_NEW, "timeout": wait / 4},
                headers={"X-QoS-Class": "interactive"})
            require(probe[0] == 504 and probe[1]["error"]["message"].startswith(
                "predicted queue wait") and "Retry-After" not in probe[4],
                    f"http_planes: the request past its deadline: {probe[:2]} {probe[4]}")
            out["deadline_probe"] = {"predicted_wait_s": wait, "timeout_s": wait / 4,
                                     "status": probe[0], "message": probe[1]["error"]["message"]}
        for th in threads:
            th.join(900)
        st1 = wait_idle(engine)
        torch.cuda.synchronize()
        t_done = time.monotonic()
        counts = cuda.launch_counts()
        after = scrape(app.metrics_port)
        reqs = list(submitted)
        require(len(reqs) == len(jobs), f"http_planes {arm}: {len(reqs)} engine requests for "
                                        f"{len(jobs)} POSTs (the probe took a slot?)")
        for key, *_ in jobs:
            r = replies.get(key)
            require(r is not None and r[0] == 201 and len(r[1]["data"]["tokens"]) == PLANES_NEW
                    and r[1]["data"]["finish_reason"] == "length",
                    f"http_planes {arm} request {key}: {r and (r[0], r[1].get('error'))}")
        outs = {key: replies[key][1]["data"] for key, *_ in jobs}
        for name in ("app_tpu_ttft_seconds_count", "app_tpu_queue_wait_seconds_count"):
            n = series_sum(after, name) - series_sum(before, name)
            require(n == len(jobs), f"http_planes {arm}: {name} counted {n} samples")
        tokens = series_sum(after, "app_tpu_tokens_total") - series_sum(before, "app_tpu_tokens_total")
        want_tokens = sum(len(p) for _, p, _ in jobs) + len(jobs) * PLANES_NEW
        require(tokens == want_tokens, f"http_planes {arm}: app_tpu_tokens_total rose {tokens}, "
                                       f"prompts + folded tokens are {want_tokens}")
        for name, launches in counts.items():
            if name in ON_PATH["paged", ""]:
                require(launches > 0, f"kernel {name} was not launched on http_planes {arm}")
            else:
                require(launches == 0, f"kernel {name} was launched {launches} times on "
                                       f"http_planes {arm}")
        if on:
            out.update(planes_holds(app, jobs, replies, outs, after))
        turns = st1["busy_turns"] - st0["busy_turns"]
        req_of = {tuple(q.inputs): q for q in reqs}
        first = {key: req_of[tuple(p)].enqueued_at + outs[key]["ttft_s"] for key, p, _ in jobs}
        done = [first[k] + outs[k]["decode_s"] for k in first]
        out.update({
            "wall_s": t_done - t_submit, "requests": len(jobs),
            "ttft_p50_s": {c: sorted(o["ttft_s"] for k, o in outs.items() if k[0] == c)[4]
                           for c in ("batch", "interactive")},
            "decode_tok_s": sum(len(o["tokens"]) - 1 for o in outs.values())
            / (max(done) - min(first.values())),
            "host_ms_per_busy_turn": (st1["busy_turn_s"] - st0["busy_turn_s"]) / turns * 1e3,
            "busy_turns": turns, "launches": counts,
            **{f"batch_{k}": v for k, v in token_agreement(
                torch, model, batch, [outs["batch", i] for i in range(len(batch))],
                base_outs).items()},
        })
        gaps = [m["chosen_below_top1"] for m in out["batch_margin_at_first_difference"] if m]
        require(all(gap <= SPEC_TIE_GAP for gap in gaps),
                f"http_planes {arm}: at a first difference from the bf16 run the token lies "
                f"{gaps} below the top logit (limit {SPEC_TIE_GAP})")
        out.update(plane_vs_profiler(torch, engine, profiled))
    tracer_worker = app.container.tracer._worker
    require(not engine._thread.is_alive() and (tracer_worker is None or not tracer_worker.is_alive()),
            f"http_planes {arm}: the engine's or the tracer's thread outlived stop()")
    del engine, app
    torch.cuda.empty_cache()
    return out


def planes_holds(app, jobs, replies, outs, metrics) -> dict:
    """The on arm's holds on the planes themselves: each request's trace,
    its flight entry, the steps, the perf plane's ratios, the QoS and SLO
    series, and health."""
    spans = list(app.container.tracer._exporter.spans)
    port = app.http_port
    for key, *_ in jobs:
        tid = replies[key][4].get("X-Trace-Id")
        servers = [s for s in spans if s.trace_id == tid and s.kind == "SERVER"]
        require(len(servers) == 1, f"http_planes {key}: {len(servers)} server spans for X-Trace-Id "
                                   f"{tid}")
        children = sorted((s for s in spans if s.parent_id == servers[0].span_id),
                          key=lambda s: s.start)
        require([s.name for s in children] == SPAN_ORDER and all(
            s.trace_id == tid for s in children),
                f"http_planes {key}: engine spans {[s.name for s in children]}")
    _, flight, *_ = http_call(port, "GET", "/debug/requests?n=256")
    by_trace = {e["trace_id"]: e for e in flight["data"]["requests"]}
    ttft_gap = []
    for key, *_ in jobs:
        entry = by_trace.get(replies[key][4]["X-Trace-Id"])
        require(entry is not None, f"http_planes {key}: no /debug/requests entry")
        ttft_gap.append(abs(entry["ttft_s"] - outs[key]["ttft_s"]))
    require(max(ttft_gap) <= 1e-3, f"http_planes: flight ttft_s vs the result's, gaps {ttft_gap}")
    _, steps, *_ = http_call(port, "GET", "/debug/engine?n=512")
    kinds = {s["kind"] for s in steps["data"]["steps"]}
    require({"prefill", "decode"} <= kinds, f"http_planes: /debug/engine step kinds {kinds}")
    _, perf, *_ = http_call(port, "GET", "/debug/perf")
    plane = perf["data"]["engines"]["lm"]
    mbu = plane["kinds"]["decode"]["mbu"]
    mfu = plane["kinds"]["prefill"]["mfu"]
    require(plane["peaks"]["flops"] == 989e12 and plane["peaks"]["hbm_bytes_per_s"] == 3.35e12,
            f"http_planes: /debug/perf peaks {plane['peaks']} (device {plane['device_kind']})")
    require(mbu is not None and 0 < mbu <= PLANES_MAX_RATIO and mfu is not None
            and 0 < mfu <= PLANES_MAX_RATIO, f"http_planes: decode MBU {mbu}, prefill MFU {mfu}")
    admitted = series_sum(metrics, "app_qos_admitted_total")
    require(admitted >= len(jobs), f"http_planes: app_qos_admitted_total {admitted}")
    for cls in ("batch", "interactive"):
        require(any(k.startswith("app_slo_attainment{") and f'class="{cls}"' in k
                    for k in metrics), f"http_planes: no app_slo_attainment series for {cls}")
    _, health, *_ = http_call(port, "GET", "/.well-known/health")
    require({"qos", "slo", "model:lm"} <= set(health["data"]["services"]),
            f"http_planes: health lists {sorted(health['data']['services'])}")
    return {"plane_decode_mbu": mbu, "plane_prefill_mfu": mfu,
            "plane_bubble_ratio": plane["bubble"]["ratio"],
            "flight_ttft_gap_max_s": max(ttft_gap), "qos_admitted": admitted,
            "health": health["data"]["status"], "step_kinds": sorted(kinds)}


def plane_vs_profiler(torch, engine, prompts: list) -> dict:
    """Over ``profiled_wave``'s window: the perf plane's device seconds per
    step (residency, dispatch to readback, clipped) and the MBU it gives,
    beside torch.profiler's device busy per step and the MBU that gives,
    the same steps' bytes over the H100's 3.35 TB/s."""
    from gofr_tpu_torch.metrics.perf import H100_SXM_HBM_BYTES_PER_S

    noted, note, marks = [], engine.perf.note, []

    def recording(p, now, band=None):
        out = note(p, now, band)
        noted.append((now, p.kind, p.device_s, p.bytes))
        return out

    engine.perf.note = recording
    try:
        wave = profiled_wave(torch, engine, prompts, marks)
    finally:
        engine.perf.note = note
    steps = [n for n in noted if marks[0] <= n[0] <= marks[1]]
    decode = [n for n in steps if n[1] == "decode"]
    plane_s = sum(n[2] for n in steps)
    busy_s = wave["profiled_wave_device_busy_ms"] / 1e3
    nbytes = sum(n[3] for n in steps)
    return {**wave, "window_steps": len(steps), "window_decode_steps": len(decode),
            "plane_device_ms_per_step": plane_s / len(steps) * 1e3 if steps else None,
            "plane_decode_device_ms_per_step": (sum(n[2] for n in decode) / len(decode) * 1e3
                                                if decode else None),
            "profiler_busy_ms_per_step": busy_s / len(steps) * 1e3 if steps else None,
            "plane_mbu": nbytes / plane_s / H100_SXM_HBM_BYTES_PER_S if plane_s else None,
            "profiler_mbu": nbytes / busy_s / H100_SXM_HBM_BYTES_PER_S}


def http_planes(torch, cuda, model, base_outs: list) -> dict:
    """Phase 4 ``http_planes``: the arms in turns ``PLANES_ARMS``. Held in
    every arm: each of the 16 POSTs answers 201 with 64 tokens; the 8 batch
    requests' tokens agree with the ``bf16`` run's by the tie rule;
    ``app_tpu_ttft_seconds`` and ``app_tpu_queue_wait_seconds`` take 16
    samples; ``app_tpu_tokens_total`` rises by the prompts' tokens plus the
    64 each request's folds emitted; the launch counters show ``bf16``'s
    kernels and no other; after ``stop`` the engine's and the tracer's
    threads have ended. Held in the on arm: a tenant's second request in a
    second answers 429 with ``Retry-After`` and the envelope; a request
    sent while the 16 queue, its deadline a quarter of the predicted wait,
    answers 504 (the JAX verdict) and takes no slot; each request's trace
    (``X-Trace-Id``) has the server span with ``engine.queue_wait``,
    ``engine.prefill``, ``engine.decode`` and ``engine.finish`` under it in
    that order; each has a ``/debug/requests`` entry whose ``ttft_s`` is
    its result's within 1 ms; ``/debug/engine`` has prefill and decode
    steps; ``/debug/perf`` prices against the H100 row, decode MBU and
    prefill MFU in (0, 1.05]; ``app_qos_admitted_total`` >= 16;
    ``app_slo_attainment`` has both classes; health lists ``qos`` and
    ``slo``. Printed: TTFT p50 by class, decode tok/s, host ms per busy loop
    turn, and over one profiled wave the plane's device ms per step and MBU
    beside the profiler's."""
    arms = [planes_arm(torch, cuda, model, arm, base_outs) for arm in PLANES_ARMS]
    return {"model": "llama3_8b (random bf16 weights, seed 0)", "order": list(PLANES_ARMS),
            "config_on": PLANES_CONFIG, "arms": arms, "nvidia_smi": smi_line(),
            "note": "an A/B in one call, not a benchmark; nothing about speed is held"}


# Phase 4's life cycle and quality runs. ``paged_restart``: ``bf16``'s
# knobs and model with one host-side fault planted in the decode dispatch
# once the 8 requests are all in slots; the loop fails them, backs off,
# restarts and serves the same 8 prompts submitted after the fault.
# ``paged_quality`` / ``int8_quality``: ``bf16``'s and ``int8``'s pools
# with ``QUALITY_CONFIG`` (every finished request shadow-scored, up to 64
# emitted tokens), and on the bf16 pool an SLO capture with a trace and a
# ``/debug/profile`` through the App. ``cold_start``: two fresh processes of
# ``scripts/torch_cold_start.py``.
RESTART_FAULT = "planted host-side fault in the decode dispatch"
QUALITY_CONFIG = {**HTTP_CONFIG, "QUALITY_SHADOW_RATE": "1", "QUALITY_MAX_TOKENS": "64"}
# the capture run: an interactive TTFT objective of 1 ms that no request
# meets, judged from the first sample on (the other latency objectives
# off, so no other sample breaches first); the wave's second half is sent
# once the capture's trace runs, so the trace takes its prefill and decode
CAPTURE_CONFIG = {"APP_ENV": "DEBUG", "SLO_CAPTURE": "true", "SLO_CAPTURE_TRACE_S": "3",
                  "SLO_INTERACTIVE_TTFT_MS": "1", "SLO_MIN_SAMPLES": "1",
                  "SLO_CHECK_INTERVAL_S": "0",
                  **{f"SLO_{cls}_{obj}_MS": "0" for cls, obj in (
                      ("DEFAULT", "TTFT"), ("DEFAULT", "TPOT"), ("DEFAULT", "E2E"),
                      ("INTERACTIVE", "TPOT"), ("INTERACTIVE", "E2E"))}}
PROFILE_S = 2
# the kernels' names in a trace: C and, on the bf16 pool, A
TRACE_KERNELS = {"flash_attention": "flash_kernel", "paged_decode": "paged_decode_kernel"}
COLD_START = {"layers": 2, "prompt": 512, "new": 16}


def serve_warmup(torch, cuda, model, base_outs: list) -> dict:
    """Phase 4 ``paged_warmup``: ``bf16``'s knobs and model; a 300-token
    request leaves two pages in the prefix cache, then ``warmup()``. Held:
    it runs JAX's count for the knobs (every length bucket x batch bucket,
    every chunk, one decode chunk), launches A, B and C and no other
    kernel, and leaves the pool's bytes, refcounts, free list, table and
    prefix cache as they were and the pool's audit clean; then ``bf16``'s 8
    prompts end with 64 tokens, equal to ``bf16``'s (a cold engine's) by
    the tie rule. Printed: warmup's seconds and count."""
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.gpu.planner import pow2_buckets

    eng = build_engine(model.cfg, params=model, device="cuda", seed=SEED, slots=8, max_len=2048,
                       max_prefill_batch=4, decode_chunk=8)
    prompts = phase4_prompts(torch, model.cfg.vocab_size)
    try:
        first = eng.generate(list(range(1, 301)), max_new_tokens=2, timeout=600)
        require(first["finish_reason"] == "length", f"paged_warmup first request: {first}")
        wait_idle(eng)
        torch.cuda.synchronize()
        pool = [t.clone() for t in vars(eng.cache).values()]
        books = (eng._page_refs.copy(), eng._table.copy(), sorted(eng._free_pages),
                 sorted(eng._prefix._nodes))
        require(books[3], "paged_warmup: the prefix cache holds nothing to keep")
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        count = eng.warmup()
        warm_s = time.perf_counter() - t0
        counts = cuda.launch_counts()
        same_pool = all(torch.equal(a, b) for a, b in zip(pool, vars(eng.cache).values()))
        del pool
        after = (eng._page_refs, eng._table, sorted(eng._free_pages), sorted(eng._prefix._nodes))
        same_books = (all((a == b).all() for a, b in zip(books[:2], after[:2]))
                      and books[2:] == after[2:])
        eng.check_page_refs()
        reqs = [eng.submit(p, max_new_tokens=64) for p in prompts]
        outs = [r.result(timeout=900) for r in reqs]
        wait_idle(eng)
    finally:
        eng.stop()
    del eng
    torch.cuda.empty_cache()
    want = len(pow2_buckets(16, 2048)) * (len(pow2_buckets(1, 4)) + 1) + 1
    require(count == want, f"paged_warmup: warmup ran {count} calls, JAX's count is {want}")
    require(same_pool and same_books,
            f"paged_warmup: warmup changed the pool's bytes ({not same_pool}) or its books "
            f"({not same_books})")
    for name, launches in counts.items():
        require((launches > 0) == (name in ON_PATH["paged", ""]),
                f"paged_warmup: warmup launched kernel {name} {launches} times")
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                f"paged_warmup request {i}: {o['finish_reason']}, {len(o['tokens'])} tokens")
    agree = token_agreement(torch, model, prompts, outs, base_outs)
    gaps = [m["chosen_below_top1"] for m in agree["margin_at_first_difference"] if m]
    require(all(gap <= SPEC_TIE_GAP for gap in gaps),
            f"paged_warmup: at a first difference from bf16 the run chose a token {gaps} below "
            f"the top logit (limit {SPEC_TIE_GAP})")
    return {"model": "llama3_8b (random bf16 weights, seed 0)", "kv_pool": "bf16",
            "warmup_s": warm_s, "warmup_count": count, "warmup_launches": counts,
            "pool_unchanged": same_pool, "books_unchanged": same_books, **agree,
            "nvidia_smi": smi_line()}


def serve_restart(torch, cuda, model, base_outs: list) -> dict:
    """Phase 4 ``paged_restart``. Held: the 8 slot-resident requests fail
    with the planted error; health reads DEGRADED with ``restarting`` inside
    the backoff (read from the restart hook); the 8 prompts submitted after
    the fault all end with 64 tokens, equal to the ``bf16`` run's by the tie
    rule; ``app_tpu_engine_restarts`` is 1, health UP with ``restarts`` 1,
    the pool's audit passes; A, B and C launch and no other kernel. Printed:
    the seconds from the fault to the first token served after it."""
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.gpu import decode
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    c = Container.create(DictConfig({"LOG_LEVEL": "ERROR"}))
    eng = GenerateEngine(model, device="cuda", seed=SEED, slots=8, max_len=2048,
                         max_prefill_batch=4, decode_chunk=8, container=c)
    prompts = phase4_prompts(torch, model.cfg.vocab_size)
    real, fault, seen = decode.dispatch_decode, {}, []

    def planted(e):
        if not fault and len(e._active()) == len(prompts):
            fault["t"] = time.monotonic()
            raise RuntimeError(RESTART_FAULT)
        return real(e)

    eng._restart_hook = lambda attempt: seen.append(eng.health_check())
    try:
        warm = eng.generate(list(range(1, 65)), max_new_tokens=2, timeout=600)
        require(warm["finish_reason"] == "length", f"paged_restart warm-up: {warm}")
        wait_idle(eng)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        decode.dispatch_decode = planted
        try:
            first, errors = [eng.submit(p, max_new_tokens=64) for p in prompts], []
            for r in first:
                try:
                    r.result(timeout=900)
                    errors.append(None)
                except RuntimeError as e:
                    errors.append(str(e))
            t_resubmit = time.monotonic()
            second = [eng.submit(p, max_new_tokens=64) for p in prompts]
            outs = [r.result(timeout=900) for r in second]
        finally:
            decode.dispatch_decode = real
        wait_idle(eng, allow_dropped=True)
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        health = eng.health_check()
        st = eng.pipeline_stats()
        eng.check_page_refs()
        restarts = c.metrics.get("app_tpu_engine_restarts").value()
    finally:
        eng.stop()
    del eng
    torch.cuda.empty_cache()
    require(errors == [RESTART_FAULT] * len(prompts),
            f"paged_restart: the slot-resident requests ended {errors}")
    require(seen[:1] == [{"status": "DEGRADED", "details": {"restarting": True, "restarts": 1}}],
            f"paged_restart: health inside the backoff read {seen}")
    require(restarts == 1 and health == {"status": "UP",
                                         "details": {"queue_depth": 0, "restarts": 1}},
            f"paged_restart: {restarts} restarts, health {health}")
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                f"paged_restart request {i} after the fault: {o['finish_reason']}, "
                f"{len(o['tokens'])} tokens")
    for name, launches in counts.items():
        on = name in ON_PATH["paged", ""]
        require((launches > 0) == on, f"paged_restart: kernel {name} launched {launches} times")
    agree = token_agreement(torch, model, prompts, outs, base_outs)
    gaps = [m["chosen_below_top1"] for m in agree["margin_at_first_difference"] if m]
    require(all(gap <= SPEC_TIE_GAP for gap in gaps),
            f"paged_restart: at a first difference from bf16 the run chose a token {gaps} below "
            f"the top logit (limit {SPEC_TIE_GAP})")
    first_token = min(r.enqueued_at + o["ttft_s"] for r, o in zip(second, outs))
    return {"model": "llama3_8b (random bf16 weights, seed 0)", "kv_pool": "bf16",
            "fault": RESTART_FAULT, "failed_in_slots": len(errors),
            "health_in_backoff": seen[0], "health_after": health, "restarts": restarts,
            "resubmitted_after_fault_s": t_resubmit - fault["t"],
            "fault_to_first_token_s": first_token - fault["t"],
            "ttft_after_fault_s": sorted(o["ttft_s"] for o in outs),
            "host_ms_per_busy_turn": st["busy_turn_s"] / st["busy_turns"] * 1e3,
            "busy_turns": st["busy_turns"], "calls_dropped": st["dropped"],
            "launches": counts, **agree, "nvidia_smi": smi_line()}


# Phase 4's ``paged_control``: ``bf16``'s pool from a ``ModelSpec`` with the
# step controller on (``CONTROL_CONFIG``: a tick every 0.5 s on at least 4
# steps; sustain, cooldown and backoff keep their interval-scaled defaults),
# served by the App under ``APP_ENV=DEBUG`` for ``/debug/control``.
CONTROL_CONFIG = {**HTTP_CONFIG, "APP_ENV": "DEBUG", "CONTROL_ENABLE": "1",
                  "CONTROL_INTERVAL_S": "0.5", "CONTROL_MIN_STEPS": "4"}
CONTROL_TRAFFIC_S = 15.0
# the drill's knob moves, restored to the boot values in the next wave
CONTROL_DRILL = {"pipeline_depth": 1, "prefill_chunk": 128, "prefill_batch": 1}
CONTROL_SPEC_G = (SPEC_G, 2)


def knob_envelope(eng) -> dict:
    """Each knob's allowed values: 1 up to the boot value, a bucket for
    ``prefill_chunk``."""
    env = {"pipeline_depth": set(range(1, eng._boot_pipeline_depth + 1)),
           "prefill_chunk": set(eng.prefill_buckets),
           "prefill_batch": set(range(1, eng._boot_prefill_batch + 1))}
    if eng._boot_spec_tokens:
        env["spec_tokens"] = set(range(1, eng._boot_spec_tokens + 1))
    return env


def hold_knobs(label: str, eng, flight) -> dict:
    """Every decision's and every flight step's knob values within the
    engine's boot envelope; returns the knob values the steps ran under."""
    env = knob_envelope(eng)
    for d in flight.controls():
        if d.get("knob"):
            require(d["from"] in env[d["knob"]] and d["to"] in env[d["knob"]],
                    f"{label}: decision {d} moves {d['knob']} outside {sorted(env[d['knob']])}")
    seen: dict = {k: set() for k in env}
    for st in flight.steps():
        knobs = st.get("knobs")
        require(knobs is not None and set(knobs) == set(env),
                f"{label}: a flight step without the knob vector: {st}")
        for k, v in knobs.items():
            require(v in env[k], f"{label}: a step ran at {k}={v}, outside {sorted(env[k])}")
            seen[k].add(v)
    return {k: sorted(v) for k, v in seen.items()}


def timed_ticks(ctl) -> list:
    """Wrap the controller's evaluating tick (``maybe_tick`` between ticks
    returns at once) so each one's host seconds are kept."""
    spent, tick = [], ctl._tick

    def timed(now):
        t0 = time.perf_counter()
        try:
            return tick(now)
        finally:
            spent.append(time.perf_counter() - t0)

    ctl._tick = timed
    return spent


def drill_wave(eng, prompts: list, knobs: dict) -> list:
    """Submit ``prompts``, queue ``knobs`` once half of them are in, and
    return the results."""
    reqs = []
    for i, p in enumerate(prompts):
        reqs.append(eng.submit(p, max_new_tokens=64))
        if i == len(prompts) // 2 - 1:
            eng.request_knobs(**knobs)
    return [r.result(timeout=900) for r in reqs]


def hold_tie(label: str, torch, model, prompts, outs, want, logits=None,
             rtol: float | None = None, gap: float = SPEC_TIE_GAP) -> dict:
    """Every request 64 tokens; tokens against ``want`` by the tie rule: at
    a first difference the run's token lies within ``gap`` (``SPEC_TIE_GAP``
    unless given) of the top logit (``token_agreement``'s, of ``logits``
    when given), or with ``rtol`` within ``rtol`` of the largest |logit|
    (phase 5's measure)."""
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                f"{label} request {i}: {o['finish_reason']}, {len(o['tokens'])} tokens")
    agree = token_agreement(torch, model, prompts, outs, want, logits)
    over = []
    for m in agree["margin_at_first_difference"]:
        if m:
            m["limit"] = gap if rtol is None else rtol * m["max_abs_logit"]
            if m["chosen_below_top1"] > m["limit"]:
                over.append((m["chosen_below_top1"], m["limit"]))
    require(not over, f"{label}: at a first difference the run chose a token below the top logit "
                      f"by more than the limit: (gap, limit) {over}")
    return agree


def serve_control(torch, cuda, model, base_outs: list) -> dict:
    """Phase 4 ``paged_control``. ``paged_pipeline``'s 16 prompts in waves of
    4 for ``CONTROL_TRAFFIC_S`` with the controller on, then the drill: a
    wave of ``bf16``'s 8 prompts with ``CONTROL_DRILL`` queued after the
    fourth, and the next wave of the same prompts with the boot values
    queued there; then, on a second engine of the same config with
    ``ENGINE_SPEC_TOKENS=4``, ``bf16``'s 8 prompts with ``spec_tokens`` moved
    to 2 after the fourth. Held: at least one ``try`` and one ``commit`` or
    ``revert``; every knob value in every decision and flight step within
    the boot envelope (1..boot, a bucket for the chunk size); each drill
    wave's and the spec wave's tokens equal to ``bf16``'s by the tie rule;
    the spec engine's steps ran at g 2 after the move; no call dropped and
    both pools' audits clean; ``app_tpu_control_decisions_total`` equal to
    the flight ring's count; A, B and C launch on the first engine and no
    other kernel, C alone on the spec engine. Printed: the decisions, the
    host ms of a controller tick, ``/debug/control``'s payload size."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models import ModelSpec

    vocab = model.cfg.vocab_size
    traffic, drill = pipeline_prompts(torch, vocab)[:PIPELINE["requests"]], phase4_prompts(
        torch, vocab)
    spec = ModelSpec("llama", model.cfg, weights=model, dtype=model.cfg.dtype)
    app = App(config=DictConfig(CONTROL_CONFIG))
    eng = app.serve_model("lm", spec, seed=SEED, eos_token_id=-1)
    require(eng._control is not None, "paged_control: CONTROL_ENABLE=1 built no controller")
    ticks = timed_ticks(eng._control)
    boot = dict(eng.knob_vector())
    out: dict = {"model": "llama3_8b (random bf16 weights, seed 0)", "kv_pool": "bf16",
                 "config": {k: v for k, v in CONTROL_CONFIG.items() if k.startswith("CONTROL")},
                 "boot_knobs": boot}
    with AppThread(app, "paged-control"):
        warm = eng.generate(list(range(1, 65)), max_new_tokens=2, timeout=600)
        require(warm["finish_reason"] == "length", f"paged_control warm-up: {warm}")
        wait_idle(eng)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        per, t0, waves, reqs = PIPELINE["requests"] // PIPELINE["waves"], time.monotonic(), 0, []
        while time.monotonic() - t0 < CONTROL_TRAFFIC_S:
            w = waves % PIPELINE["waves"]
            reqs += submit_wave(eng, traffic[w * per:(w + 1) * per])
            waves += 1
        traffic_outs = [r.result(timeout=900) for r in reqs]
        traffic_s = time.monotonic() - t0
        drilled = drill_wave(eng, drill, CONTROL_DRILL)
        restored = drill_wave(eng, drill, boot)
        st = wait_idle(eng)
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        eng.check_page_refs()
        status, payload, *_ = http_call(app.http_port, "GET", "/debug/control")
        require(status == 200, f"paged_control: /debug/control answered {status}")
    # the engine stopped with the App: the ring and the counter hold still
    decisions = app.container.flight.controls()
    counted = sum(app.container.metrics.get("app_tpu_control_decisions_total")._values.values())
    seen = hold_knobs("paged_control", eng, app.container.flight)
    final = eng.knob_vector()
    del eng, app
    torch.cuda.empty_cache()
    verdicts = [d["verdict"] for d in decisions]
    require("try" in verdicts and ("commit" in verdicts or "revert" in verdicts),
            f"paged_control: the decisions were {verdicts}")
    require(counted == len(decisions),
            f"paged_control: app_tpu_control_decisions_total counted {counted}, the ring holds "
            f"{len(decisions)}")
    # newest first: decisions made after the GET lead the ring
    shown = payload["data"]["decisions"]
    require(payload["data"]["engines"]["lm"]["enabled"] is True and shown
            and shown == decisions[len(decisions) - len(shown):],
            "paged_control: /debug/control's decisions differ from the flight ring")
    require(st["dropped"] == 0, f"paged_control: calls dropped {st}")
    for i, o in enumerate(traffic_outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == PIPELINE["new_tokens"],
                f"paged_control traffic request {i}: {o['finish_reason']}")
    for name, launches in counts.items():
        require((launches > 0) == (name in ON_PATH["paged_control"]),
                f"paged_control: kernel {name} launched {launches} times")
    out.update({
        "traffic_s": traffic_s, "traffic_waves": waves, "traffic_requests": len(traffic_outs),
        "decisions": decisions, "verdicts": {v: verdicts.count(v) for v in sorted(set(verdicts))},
        "decisions_counted": counted, "ticks": len(ticks),
        "tick_host_ms": {"mean": sum(ticks) / len(ticks) * 1e3, "max": max(ticks) * 1e3}
        if ticks else None,
        "debug_control_bytes": len(json.dumps(payload).encode()),
        "knob_values_stepped": seen, "final_knobs": final,
        "drill": {k: v for k, v in hold_tie("paged_control drill", torch, model, drill, drilled,
                                            base_outs).items()
                  if k != "margin_at_first_difference"},
        "restored": {k: v for k, v in hold_tie("paged_control restore", torch, model, drill,
                                               restored, base_outs).items()
                     if k != "margin_at_first_difference"},
        "launches": counts})
    # the spec engine: g moved from 4 to 2 in the middle of a wave
    c = Container(DictConfig({**CONTROL_CONFIG, "ENGINE_SPEC_TOKENS": str(CONTROL_SPEC_G[0]),
                              "LOG_LEVEL": "ERROR"}))
    eng = build_engine(spec, c, device="cuda", seed=SEED, eos_token_id=-1)
    try:
        warm = eng.generate(list(range(1, 65)), max_new_tokens=2, timeout=600)
        require(warm["finish_reason"] == "length", f"paged_control spec warm-up: {warm}")
        wait_idle(eng)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        spec_outs = drill_wave(eng, drill, {"spec_tokens": CONTROL_SPEC_G[1]})
        st = wait_idle(eng)
        torch.cuda.synchronize()
        spec_counts = cuda.launch_counts()
        eng.check_page_refs()
        spec_seen = hold_knobs("paged_control spec", eng, c.flight)
        spec_decisions = c.flight.controls()
    finally:
        eng.stop()
    del eng
    torch.cuda.empty_cache()
    require(st["dropped"] == 0, f"paged_control spec: calls dropped {st}")
    require(CONTROL_SPEC_G[1] in spec_seen["spec_tokens"],
            f"paged_control spec: no step ran at g {CONTROL_SPEC_G[1]}: {spec_seen}")
    for name, launches in spec_counts.items():
        require((launches > 0) == (name in ON_PATH["paged_control_spec"]),
                f"paged_control spec: kernel {name} launched {launches} times")
    out["spec"] = {"boot_g": CONTROL_SPEC_G[0], "moved_to": CONTROL_SPEC_G[1],
                   "knob_values_stepped": spec_seen, "decisions": spec_decisions,
                   **{k: v for k, v in hold_tie("paged_control spec", torch, model, drill,
                                                spec_outs, base_outs).items()
                      if k != "margin_at_first_difference"},
                   "launches": spec_counts}
    out["nvidia_smi"] = smi_line()
    return out


# Phase 4's ``paged_handoff``: a prefill worker and a decode worker of
# ``bf16``'s knobs in one process on one card, both on the phase's model,
# built from a ``ModelSpec`` and their ``ENGINE_ROLE`` / ``HANDOFF_*``
# config. The decode worker's host tier is ``HANDOFF_DECODE_HOST_MB``: the
# default 256 MiB holds 16 of Llama-3-8B's 16 MiB bf16 pages, and the 8
# prompts ship 32. Each arm: its prompts at once to the prefill worker,
# then the same prompts at once to the decode worker.
HANDOFF_BASE = {"LOG_LEVEL": "ERROR", "ENGINE_SLOTS": "8", "ENGINE_MAX_LEN": "2048",
                "ENGINE_PREFILL_BATCH": "4", "ENGINE_DECODE_CHUNK": "8"}
HANDOFF_DECODE_HOST_MB = 1024
HANDOFF_LONG = {"prompts": 2, "tokens": 1536, "buckets": [128, 256, 512]}
HANDOFF_ARMS = {
    "stream": {"HANDOFF_STREAMS": "2", "HANDOFF_CHUNK_PAGES": "4"},
    "blob": {"HANDOFF_STREAMS": "0"},
    "int8_stream": {"HANDOFF_STREAMS": "2", "HANDOFF_CHUNK_PAGES": "4", "ENGINE_KV_DTYPE": "int8"},
    "long_stream": {"HANDOFF_STREAMS": "2", "HANDOFF_CHUNK_PAGES": "4"},
}


def long_prompts(torch, vocab: int) -> list[list[int]]:
    rng = torch.Generator().manual_seed(SEED + 9)
    return [torch.randint(0, vocab, (HANDOFF_LONG["tokens"],), generator=rng).tolist()
            for _ in range(HANDOFF_LONG["prompts"])]


def handoff_arm(torch, cuda, model, arm: str, prompts: list, want: list) -> dict:
    """One arm of ``paged_handoff``; returns its numbers, holds inside."""
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models import ModelSpec

    spec = ModelSpec("llama", model.cfg, weights=model, dtype=model.cfg.dtype)
    kw = {"prefill_buckets": HANDOFF_LONG["buckets"]} if arm == "long_stream" else {}
    conf = {**HANDOFF_BASE, **HANDOFF_ARMS[arm]}
    page = 128
    n_pages = [len(p) // page for p in prompts]
    dec = build_engine(spec, Container(DictConfig({**conf, "ENGINE_ROLE": "decode",
                                                   "ENGINE_PREFIX_HOST_MB": str(
                                                       HANDOFF_DECODE_HOST_MB)})),
                       device="cuda", seed=SEED, eos_token_id=-1, **kw)
    pre = None
    try:
        pre = build_engine(spec, Container(DictConfig({**conf, "ENGINE_ROLE": "prefill",
                                                       "HANDOFF_TARGET": dec.handoff_addr})),
                           device="cuda", seed=SEED, eos_token_id=-1, **kw)
        require(pre.role == "prefill" and dec.role == "decode" and pre._handoff_exporter,
                f"paged_handoff {arm}: the workers' roles {pre.role}/{dec.role}")
        for e in (pre, dec):
            warm = e.generate(list(range(1, 65)), max_new_tokens=2, timeout=600)
            require(warm["finish_reason"] == "length", f"paged_handoff {arm} warm-up: {warm}")
            wait_idle(e)
        kicks, kick = [], pre._handoff_exporter.kick
        pre._handoff_exporter.kick = lambda t: (kicks.append(t.staged_pages), kick(t))
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t0 = time.monotonic()
        first = [r.result(timeout=900) for r in [pre.submit(p, max_new_tokens=64)
                                                 for p in prompts]]
        pre_s = time.monotonic() - t0
        wait_idle(pre)
        torch.cuda.synchronize()
        pre_counts = cuda.launch_counts()
        exported = pre._handoff_exporter.stats()
        imported = dec._handoff_server.stats()
        pinned = all(t.is_pinned() for node in dec._prefix._nodes.values() if node.page_id < 0
                     for t in node.host)
        host_pages = dec._prefix.host_pages
        perf = pre.perf.window_totals(time.monotonic())["kinds"]
        seconds = pre.metrics.get("app_tpu_kv_handoff_seconds")
        cuda.reset_launch_counts()
        t0 = time.monotonic()
        outs = [r.result(timeout=900) for r in [dec.submit(p, max_new_tokens=64)
                                                for p in prompts]]
        dec_s = time.monotonic() - t0
        wait_idle(dec)
        torch.cuda.synchronize()
        dec_counts = cuda.launch_counts()
        pre.check_page_refs()
        dec.check_page_refs()
        page_bytes = dec._page_bytes
    finally:
        if pre is not None:
            pre.stop()
        dec.stop()
    del pre, dec
    torch.cuda.empty_cache()
    label = f"paged_handoff {arm}"
    for i, (o, n) in enumerate(zip(first, n_pages)):
        if n:
            require(o["finish_reason"] == "handoff" and len(o["tokens"]) == 1,
                    f"{label} prefill request {i} ({len(prompts[i])} tokens): "
                    f"{o['finish_reason']}, {len(o['tokens'])} tokens")
        else:
            require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                    f"{label} prefill request {i} (under a page): served {o['finish_reason']}")
    firsts = token_agreement(torch, model, prompts, first, want)
    gaps = [m["chosen_below_top1"] for m in firsts["margin_at_first_difference"] if m]
    require(all(gap <= SPEC_TIE_GAP for gap in gaps),
            f"{label}: a prefill worker's first token lies {gaps} below the top logit")
    agree = hold_tie(f"{label} decode", torch, model, prompts, outs, want)
    pages = sum(n_pages)
    require(exported["exported"] == sum(1 for n in n_pages if n) and exported["failed"] == 0
            and exported["pages"] == pages,
            f"{label}: exported {exported}, want {pages} pages")
    require(imported["imported"] == exported["exported"] and imported["pages"] == pages
            and imported["bytes"] == pages * page_bytes and host_pages == pages,
            f"{label}: imported {imported} ({host_pages} host pages), want {pages} pages of "
            f"{page_bytes} B")
    require(pinned, f"{label}: the imported pages are not in pinned host memory")
    hit = sum(o["prefix_host_tokens"] for o in outs)
    want_hit = page * sum((len(p) - 1) // page for p in prompts)
    require(hit == want_hit, f"{label}: the decode worker served {hit} host-tier tokens, want "
                             f"{want_hit}")
    pool = "int8" if "int8" in arm else ""
    # C on every prompt; the pool's decode kernels only for a prompt under a
    # page, which the prefill worker serves colocated
    on_pre = set(ON_PATH["paged_handoff_prefill"]) | (
        set(ON_PATH["paged", pool]) if 0 in n_pages else set())
    for name, launches in pre_counts.items():
        require((launches > 0) == (name in on_pre),
                f"{label}: the prefill worker launched {name} {launches} times")
    for name, launches in dec_counts.items():
        require((launches > 0) == (name in ON_PATH["paged", pool]),
                f"{label}: the decode worker launched {name} {launches} times")
    if HANDOFF_ARMS[arm].get("HANDOFF_STREAMS") != "0":
        require(exported["mode"] == "stream" and exported["streams"] == 2,
                f"{label}: the exporter runs {exported['mode']} over {exported['streams']}")
    if arm == "long_stream":
        # each prompt's pages staged at its two non-final chunk folds, 4 at
        # each (the staged count after the first and the second)
        require(sorted(kicks) == sorted([4, 8] * len(prompts)),
                f"{label}: pages staged at the chunk folds: {kicks}")
    rb = perf.get(f"handoff_export|{pool or 'bf16'}", {})
    wire = perf.get(f"handoff_stream|{pool or 'bf16'}", {})
    ttft = sorted(o["ttft_s"] for o in outs)
    return {"arm": arm, "config": HANDOFF_ARMS[arm], "prompt_lens": [len(p) for p in prompts],
            "pages": pages, "page_bytes": page_bytes, "pinned_import": pinned,
            "export": exported, "import": imported, "kicks": kicks,
            "readback_ms": rb.get("device_s", 0.0) * 1e3,
            "readback_gb_s": rb["bytes"] / rb["device_s"] / 1e9 if rb.get("device_s") else None,
            "wire_s": wire.get("device_s"),
            "wire_gb_s": wire["bytes"] / wire["device_s"] / 1e9 if wire.get("device_s") else None,
            "handoff_s_sum": seconds.sum(), "handoff_count": seconds.count(),
            "prefill_wall_s": pre_s, "decode_wall_s": dec_s,
            "decode_ttft_p50_s": ttft[len(ttft) // 2], "decode_ttft_s": ttft,
            "host_hit_tokens": hit, "first_tokens": {k: v for k, v in firsts.items()
                                                     if k != "margin_at_first_difference"},
            **{k: v for k, v in agree.items() if k != "margin_at_first_difference"},
            "launches_prefill": pre_counts, "launches_decode": dec_counts}


def serve_handoff(torch, cuda, model, results: dict, served: dict) -> dict:
    """Phase 4 ``paged_handoff``: the arms of ``HANDOFF_ARMS``, streamed
    (2 streams, 4 pages a chunk), blob, an int8 pair, and 2 prompts of 1536
    tokens on ``paged_admission``'s buckets (each prefilled in 3 chunks,
    its pages staged at the chunk folds). Held in each arm: every prompt of
    a full page or more ends on the prefill worker with ``finish_reason=
    "handoff"`` and one token, ``bf16``'s first (``int8``'s on the int8
    pair; the long arm's against an unsplit engine's) by the tie rule, and
    a shorter one is served there colocated; the decode worker's tokens
    equal the same by the tie rule; pages exported = pages imported =
    Σ⌊len/128⌋, the import's bytes = pages × the pool's page bytes, the
    imported planes in pinned memory; the decode worker's host-tier tokens
    = 128 × Σ⌊(len−1)/128⌋ (a prompt of whole pages re-prefills its last
    page, so its last token's logits are computed); both pools' audits
    clean, no call dropped; the prefill worker launches C (and the decode
    kernels only for a prompt it serves colocated), the decode worker its
    pool's decode kernels and C. Printed per arm: the export's readback ms
    and GB/s on the card's events, wire seconds and GB/s over loopback,
    the overlap ratio, the decode worker's TTFT p50 beside ``bf16``'s."""
    from gofr_tpu_torch.gpu.engine import build_engine

    vocab = model.cfg.vocab_size
    prompts = phase4_prompts(torch, vocab)
    longs = long_prompts(torch, vocab)
    eng = build_engine(model.cfg, params=model, device="cuda", seed=SEED, slots=8, max_len=2048,
                       max_prefill_batch=4, decode_chunk=8)
    try:
        long_want = [r.result(timeout=900) for r in [eng.submit(p, max_new_tokens=64)
                                                     for p in longs]]
    finally:
        eng.stop()
    del eng
    torch.cuda.empty_cache()
    arms = []
    for arm in HANDOFF_ARMS:
        if arm == "long_stream":
            arms.append(handoff_arm(torch, cuda, model, arm, longs, long_want))
        else:
            pool = "int8" if "int8" in arm else ""
            arms.append(handoff_arm(torch, cuda, model, arm, prompts, results["paged", pool]))
    launches = {"prefill": {}, "decode": {}}
    for a in arms:
        for side in launches:
            for k, v in a[f"launches_{side}"].items():
                launches[side][k] = launches[side].get(k, 0) + v
    return {"model": "llama3_8b (random bf16 weights, seed 0)", "layers": model.cfg.num_layers,
            "decode_host_mb": HANDOFF_DECODE_HOST_MB, "arms": arms,
            "colocated_ttft_p50_s": {"bf16": served["paged", ""]["metrics"]["ttft_p50_s"],
                                     "int8": served["paged", "int8"]["metrics"]["ttft_p50_s"]},
            "launches": launches, "nvidia_smi": smi_line(),
            "note": "one call, not a benchmark; nothing about speed is held"}


def trace_kernels(path: str) -> dict[str, int]:
    """Kernel events of a Chrome trace by name prefix (up to the template
    arguments)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    names: dict[str, int] = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = e.get("name", "")
            names[name[:60]] = names.get(name[:60], 0) + 1
    return names


def hold_trace(label: str, path: str) -> dict:
    """Hold that the trace at ``path`` has C's and A's kernel events;
    returns their counts and the trace's kernel events."""
    names = trace_kernels(path)
    found = {k: sum(v for n, v in names.items() if pat in n) for k, pat in TRACE_KERNELS.items()}
    require(all(found.values()), f"{label}: the trace at {path} lacks kernel events of "
                                 f"{[k for k, v in found.items() if not v]}: {names}")
    return {"kernel_events": sum(names.values()), "events_of": found,
            "trace_mb": os.path.getsize(path) / 1e6}


def arm_device_ms(torch, model, sample: dict, kv_quantize: str) -> dict:
    """One shadow sample's two arms again, each under ``torch.profiler``:
    the bucket, each arm's device ms and C's share of it; and each arm's
    rows, for the tie rule."""
    from torch.profiler import ProfilerActivity

    from gofr_tpu_torch.gpu.launch_gate import quiet_profile
    from gofr_tpu_torch.metrics.quality import (
        _pow2_bucket,
        make_serving_attn_fn,
        teacher_forced_rows,
    )

    out = {"bucket": _pow2_bucket(len(sample["prompt"]) + len(sample["emitted"]),
                                  model.cfg.max_seq_len)}
    rows = {}
    for arm, attn_fn in (("serving", make_serving_attn_fn(kv_quantize)), ("reference", None)):
        with quiet_profile(activities=[ProfilerActivity.CUDA]) as prof:
            rows[arm] = teacher_forced_rows(model, sample["prompt"], sample["emitted"],
                                            attn_fn=attn_fn)
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.device_time_total for e in events) / 1e3
        flash = sum(e.device_time_total for e in events if "flash_kernel" in e.key) / 1e3
        out[f"{arm}_device_ms"] = total
        out[f"{arm}_c_share"] = flash / total if total else None
    return out, rows


def quality_run(torch, cuda, model, kv_quantize: str, base_outs: list, capture: bool) -> dict:
    """Phase 4 ``paged_quality`` (``capture``) or ``int8_quality``: the
    engine built from a ``ModelSpec`` of the phase's model and
    ``QUALITY_CONFIG`` on the pool ``kv_quantize``, ``bf16``'s 8 prompts,
    then ``drain()``. Held: 8 samples scored, ``errors`` 0; tokens equal to
    the run of the same pool without the plane by the tie rule; each arm
    launched C once a layer; on the bf16 pool the arms equal (KL and log-prob
    delta 0, one computation); at every ``top1`` disagreement the emitted
    token's reference logit within ``SPEC_TIE_GAP`` of the top. With
    ``capture`` the engine is served by the App under ``CAPTURE_CONFIG``:
    the 8 requests, interactive, breach the 1 ms TTFT objective; exactly one
    bundle is written, with the quality snapshot and a trace whose kernel
    events hold C and A; then ``GET /debug/profile?seconds=2`` while a
    second wave of 8 is prefilled and decoded, its trace held the same.
    Printed: each sample's bucket, each arm's device ms and C's share, its
    KL mean and top-1 agreement."""
    import shutil
    import tempfile
    import threading

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.models import ModelSpec
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention

    pool = kv_quantize or "bf16"
    tmp = tempfile.mkdtemp(prefix="gofr-smoke-quality-")
    conf = {**QUALITY_CONFIG, "ENGINE_KV_DTYPE": pool, "PROFILER_DIR": tmp,
            "SLO_CAPTURE_DIR": os.path.join(tmp, "capture"),
            **(CAPTURE_CONFIG if capture else {})}
    c = Container.create(DictConfig(conf))
    app = App(config=DictConfig(conf), container=c)
    eng = app.serve_model("lm", ModelSpec("llama", model.cfg, weights=model, dtype=model.cfg.dtype),
                          device="cuda", seed=SEED)
    plane = eng._quality
    real_score, arms = plane._score, []

    def scored(s, *, serving):
        before = flash_attention.launches
        rows = real_score(s, serving=serving)
        arms.append({"serving": serving, "request_id": s["request_id"],
                     "c_launches": flash_attention.launches - before})
        return rows

    plane._score = scored
    prompts = phase4_prompts(torch, model.cfg.vocab_size)
    out: dict = {"model": "llama3_8b (random bf16 weights, seed 0)", "kv_pool": pool,
                 "config": {k: v for k, v in conf.items() if k.startswith(("QUALITY", "SLO"))}}
    try:
        with AppThread(app, f"{pool}_quality"):
            warm = eng.generate(list(range(1, 65)), max_new_tokens=2, timeout=600)
            require(warm["finish_reason"] == "length", f"{pool}_quality warm-up: {warm}")
            require(plane.drain(300), f"{pool}_quality: the warm request was not scored")
            wait_idle(eng)
            torch.cuda.synchronize()
            cuda.reset_launch_counts()
            arms.clear()
            base = plane.samples
            t0 = time.monotonic()
            if capture:
                # the first half's first token breaches the objective; the
                # second half goes out once the capture's trace runs
                half = len(prompts) // 2
                reqs = [eng.submit(p, max_new_tokens=64, qos_class="interactive")
                        for p in prompts[:half]]
                out["capture_trace_started_after_s"] = wait_for_profiler(torch, 120)
                reqs += [eng.submit(p, max_new_tokens=64, qos_class="interactive")
                         for p in prompts[half:]]
            else:
                reqs = [eng.submit(p, max_new_tokens=64, qos_class="interactive")
                        for p in prompts]
            outs = [r.result(timeout=900) for r in reqs]
            t_done = time.monotonic()
            require(plane.drain(600), f"{pool}_quality: the plane did not drain")
            scored_s = time.monotonic() - t_done
            # wave 1's (the profiled wave is scored too)
            scorer, scored = list(arms), plane.samples - base
            wait_idle(eng)
            torch.cuda.synchronize()
            counts = cuda.launch_counts()
            snap, st = eng.quality_snapshot(), eng.pipeline_stats()
            if capture:
                watcher = c.slo_capture
                if watcher._trace_thread is not None:
                    watcher._trace_thread.join(120)
                bundles = sorted(os.listdir(conf["SLO_CAPTURE_DIR"]))
                require(len(bundles) == 1, f"paged_quality: {len(bundles)} capture bundles")
                bdir = os.path.join(conf["SLO_CAPTURE_DIR"], bundles[0])
                with open(os.path.join(bdir, "bundle.json")) as f:
                    bundle = json.load(f)
                require([(r["class"], r["objective"]) for r in bundle["reason"]]
                        == [("interactive", "ttft")] and bundle["quality"]["lm"]["rate"] == 1.0,
                        f"paged_quality: the bundle's reason {bundle['reason']} or quality "
                        f"{bundle.get('quality')}")
                out["capture"] = {"bundle_keys": sorted(bundle), "reason": bundle["reason"],
                                  "files": sorted(os.listdir(bdir)),
                                  **hold_trace("the capture trace",
                                               os.path.join(bdir, "trace", "trace.json"))}
                out["debug_profile"] = profile_during_wave(torch, app, eng, prompts)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    samples = snap["recent"][-len(prompts):]
    require(snap["errors"] == 0 and scored == len(prompts),
            f"{pool}_quality: {scored} samples scored, {snap['errors']} errors")
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                f"{pool}_quality request {i}: {o['finish_reason']}, {len(o['tokens'])} tokens")
    require(len(scorer) == 2 * len(prompts)
            and all(a["c_launches"] == model.cfg.num_layers for a in scorer),
            f"{pool}_quality: the scorer's arms launched C {[a['c_launches'] for a in scorer]}")
    on_path = ON_PATH["paged", kv_quantize]
    for name, launches in counts.items():
        require((launches > 0) == (name in on_path),
                f"{pool}_quality: kernel {name} launched {launches} times")
    agree = token_agreement(torch, model, prompts, outs, base_outs)
    gaps = [m["chosen_below_top1"] for m in agree["margin_at_first_difference"] if m]
    require(all(gap <= SPEC_TIE_GAP for gap in gaps),
            f"{pool}_quality: at a first difference from the run without the plane the run "
            f"chose a token {gaps} below the top logit (limit {SPEC_TIE_GAP})")
    per_sample = []
    for s in samples:
        rep = s["report"]
        if not kv_quantize:
            require(rep["kl_max"] == 0.0 and rep["logprob_delta_max_abs"] == 0.0,
                    f"bf16_quality: the arms differ on the bf16 pool: {rep}")
        timing, rows = arm_device_ms(torch, model, s, kv_quantize)
        # where the reference's argmax is not the emitted token, how far the
        # emitted token lies below the top logit in each arm; the tie rule
        # holds the serving arm, the one that computes what served the
        # request (on the bf16 pool it is the reference)
        below = {arm: [float(r[j].max() - r[j][tok]) for j, (tok, ok) in
                       enumerate(zip(s["emitted"], rep["agree"])) if not ok]
                 for arm, r in rows.items()}
        require(all(b <= SPEC_TIE_GAP for b in below["serving"]),
                f"{pool}_quality: at a top-1 disagreement the emitted token lies "
                f"{below['serving']} below the serving arm's top logit (limit {SPEC_TIE_GAP})")
        per_sample.append({**timing, "prompt_len": len(s["prompt"]), "tokens": rep["tokens"],
                           "kl_mean": rep["kl_mean"], "top1_agree": rep["top1_agree"],
                           "first_divergence": rep["first_divergence"],
                           "disagreement_below_top1": below})
    out.update({"samples": len(samples), "errors": snap["errors"],
                "good": sum(bool(s["ok"]) for s in samples),
                "backend": snap["backend"],
                "scorer_c_launches": sum(a["c_launches"] for a in scorer),
                "scoring_wall_s": scored_s, "serve_wall_s": t_done - t0,
                "host_ms_per_busy_turn": st["busy_turn_s"] / st["busy_turns"] * 1e3,
                "per_sample": per_sample, "launches": counts, **agree,
                "nvidia_smi": smi_line()})
    return out


def wait_for_profiler(torch, timeout: float) -> float:
    """Wait until a ``torch.profiler`` session another thread started runs,
    then a margin; returns the seconds waited. The profiler's start flag is
    a module global (its own enabled check answers for the starting thread
    only) and flips just before the profiler starts."""
    import torch.autograd.profiler as autograd_profiler

    t0 = time.monotonic()
    if not hasattr(autograd_profiler, "_is_profiler_enabled"):
        time.sleep(1.0)
        return time.monotonic() - t0
    while not autograd_profiler._is_profiler_enabled:
        require(time.monotonic() - t0 < timeout, "no profiler started")
        time.sleep(0.002)
    time.sleep(0.3)
    return time.monotonic() - t0


def profile_during_wave(torch, app, eng, prompts: list) -> dict:
    """``GET /debug/profile?seconds=PROFILE_S`` through the App, with a wave
    of 8 new prompts submitted once the profiler runs; the trace it wrote
    must hold C's and A's kernel events."""
    import threading

    reply = {}

    def get() -> None:
        reply["r"] = http_call(app.http_port, "GET", f"/debug/profile?seconds={PROFILE_S}")

    t = threading.Thread(target=get, name="debug-profile")
    t.start()
    started_s = wait_for_profiler(torch, 30)
    wave = pipeline_prompts(torch, eng.cfg.vocab_size)[:len(prompts)]
    reqs = [eng.submit(p, max_new_tokens=64) for p in wave]
    t.join(120)
    for r in reqs:
        r.result(timeout=900)
    status, body = reply["r"][:2]
    require(status == 200, f"/debug/profile answered {status}: {body}")
    return {"seconds": body["data"]["seconds"], "wave_sent_after_s": started_s,
            **hold_trace("/debug/profile", os.path.join(body["data"]["trace_dir"], "trace.json"))}


def cold_start(torch) -> dict:
    """Phase 4 ``cold_start``: ``scripts/torch_cold_start.py`` in two fresh
    processes, ``ENGINE_WARMUP`` false then true (``COLD_START``: Llama-3-8B's
    widths cut to 2 layers, one request of 512 tokens, then a second as the
    warm reference). Held: each ends with its requests' tokens and warmup
    runs its calls; printed: warmup's seconds and count and both TTFTs."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "torch_cold_start.py")
    runs = {}
    for warm in ("false", "true"):
        done = subprocess.run([sys.executable, script, "--warmup", warm,
                               "--layers", str(COLD_START["layers"]),
                               "--prompt", str(COLD_START["prompt"]),
                               "--new", str(COLD_START["new"])],
                              capture_output=True, text=True, timeout=600)
        require(done.returncode == 0, f"cold_start --warmup {warm}: exit {done.returncode}\n"
                                      f"{done.stdout[-2000:]}{done.stderr[-4000:]}")
        runs[warm] = json.loads(done.stdout.strip().splitlines()[-1])
    require(runs["true"]["warmup_count"] > 0 and runs["false"]["warmup_count"] == 0,
            f"cold_start: warmup counts {runs}")
    return {"warmup_false": runs["false"], "warmup_true": runs["true"],
            "first_ttft_cold_over_warmed": runs["false"]["first_ttft_s"]
            / runs["true"]["first_ttft_s"]}


def lora_check(torch, model, kv_layout: str, kv_quantize: str) -> dict:
    """Phase 5's adapter holds on one cache: 5 lanes of 128-token prompts
    prefilled together, then one ``decode_step`` and one ``verify_step`` of
    5 tokens with the lanes on ``LORA_SEL`` (base, ad0, ad1, ad2, base),
    each on its own copy of the cache: with the kernels and no adapters,
    with the kernels and the adapters, and with the plain versions and the
    adapters. The base lanes' logits must be bit-identical with and without
    the adapters, and the adapter lanes' within the cache's
    ``LOGITS_RTOL`` of the plain path's (max error over max |logit|)."""
    import copy

    from gofr_tpu_torch.adapters import AdapterPool
    from gofr_tpu_torch.gpu.engine import make_pool

    cfg, n, page, plen = model.cfg, len(LORA_SEL), 128, 128
    rng = torch.Generator().manual_seed(SEED + 6)
    prompts = torch.randint(0, cfg.vocab_size, (n, plen), generator=rng).cuda()
    tokens = torch.randint(0, cfg.vocab_size, (n,), generator=rng).cuda()
    seq = torch.randint(0, cfg.vocab_size, (n, 5), generator=rng).cuda()
    if kv_layout == "paged":
        cache = make_pool(model, kv_quantize, 2 * n, page)
        table = torch.arange(2 * n, dtype=torch.int32, device="cuda").view(n, 2)
        rows = table
    else:
        cache, table = make_pool(model, kv_quantize, n, 2 * page, "slot"), None
        rows = torch.arange(n, dtype=torch.int32, device="cuda")
    model.prefill(prompts, torch.full((n,), plen, device="cuda"), cache, rows)
    pool = AdapterPool(LORA_SLOTS, cfg.hidden_size, cfg.vocab_size, LORA_RANK, device="cuda")
    for spec in lora_specs(cfg):
        pool.acquire(spec)
    sel = torch.tensor(LORA_SEL, device="cuda")
    ad = (sel, pool.a, pool.b, pool.scale)
    base = sel == 0
    pos = torch.full((n,), plen, device="cuda")
    copies = [copy.deepcopy(cache) for _ in range(3)]
    out = {"kv_layout": kv_layout, "kv_pool": kv_quantize or "bf16", "sel": list(LORA_SEL),
           "tol_rel": LOGITS_RTOL[kv_quantize]}
    pool_name = f"{kv_layout} {kv_quantize or 'bf16'}"
    for name, call in (("decode", lambda c, **kw: model.decode_step(tokens, pos, c, table, **kw)),
                       ("verify", lambda c, **kw: model.verify_step(seq, pos + 1, c, table, **kw))):
        plain, _ = call(copies[0])
        with_ad, _ = call(copies[1], adapters=ad)
        ref, _ = call(copies[2], adapters=ad, kernels=False)
        require(bool(with_ad.isfinite().all()), f"{pool_name} {name}: non-finite logits")
        rel = ((with_ad[~base] - ref[~base]).abs().max() / ref[~base].abs().max()).item()
        moved = (with_ad[~base] - plain[~base]).abs().max().item()
        require(torch.equal(with_ad[base], plain[base]),
                f"{pool_name} {name}: base lanes' logits differ with the adapters on")
        require(rel < LOGITS_RTOL[kv_quantize] and moved > 0,
                f"{pool_name} {name}: adapter lanes vs plain {rel} (limit "
                f"{LOGITS_RTOL[kv_quantize]}), moved by the adapters {moved}")
        out[name] = {"base_bit_identical": True, "adapter_rel_err": rel,
                     "adapter_max_logit_move": moved}
    del copies, cache
    return out


def fresh_cache(torch, model, kv_quantize: str, kv_layout: str) -> tuple:
    """(cache, prefill rows, decode table) of one lane of 512 positions: 4
    pages of 128, or one slot."""
    from gofr_tpu_torch.gpu.engine import make_pool

    if kv_layout == "paged":
        rows = table = torch.arange(4, dtype=torch.int32, device="cuda")[None]
        return make_pool(model, kv_quantize, 4, 128), rows, table
    rows = torch.zeros(1, dtype=torch.int32, device="cuda")
    return make_pool(model, kv_quantize, 1, 512, "slot"), rows, None


def verify_logits(torch, model, kv_quantize: str, prompt, seq, kernels: bool,
                  kv_layout: str):
    """Logits [T, V] of one ``verify_step`` over ``seq`` (1 x T) right after
    ``prompt`` was prefilled into a fresh cache, the kernels or their plain
    versions in both."""
    cache, rows, table = fresh_cache(torch, model, kv_quantize, kv_layout)
    model.prefill(prompt, torch.tensor([prompt.shape[1]], device="cuda"), cache, rows,
                  kernels=kernels)
    logits, _ = model.verify_step(seq, torch.tensor([prompt.shape[1]], device="cuda"), cache,
                                  table, kernels=kernels)
    return logits[0]


def model_steps(torch, model, kv_quantize: str, prompt, prefill_kernels: bool,
                decode_kernels: bool, fed=None, kv_layout: str = "paged", chunks: int = 1):
    """Logits [5, 1, V] of ``prompt`` (1 x 256) through ``prefill`` (whole,
    or in ``chunks`` equal chunks at their offsets, as the engine's chunked
    prefill runs them) and four ``decode_step`` steps on a fresh cache of
    512 positions (4 pages of 128, or one slot), ``kv_layout`` in the
    format ``kv_quantize``, the kernels or their plain versions in each.
    Each step is fed ``fed``'s tokens when given, else the run's own greedy
    tokens. Returns (logits, the tokens fed, the K/V the cache holds at the
    end as its read path returns them, f32 [L, 2, Hkv, written positions,
    D])."""
    cache, rows, table = fresh_cache(torch, model, kv_quantize, kv_layout)
    if chunks == 1:
        lengths = torch.tensor([prompt.shape[1]], device="cuda")
        logits, _ = model.prefill(prompt, lengths, cache, rows, kernels=prefill_kernels)
    else:
        width = prompt.shape[1] // chunks
        lengths = torch.tensor([width], device="cuda")
        for c in range(chunks):
            logits, _ = model.prefill(prompt[:, c * width:(c + 1) * width], lengths, cache, rows,
                                      torch.tensor([c * width], device="cuda"),
                                      kernels=prefill_kernels)
    seq, chosen = [logits], []
    for step in range(4):
        tokens = logits.argmax(-1).to(torch.int32) if fed is None else fed[step]
        chosen.append(tokens)
        pos = torch.tensor([prompt.shape[1] + step], device="cuda")
        logits, _ = model.decode_step(tokens, pos, cache, table, kernels=decode_kernels)
        seq.append(logits)
    written = prompt.shape[1] + 4
    stored = torch.stack([torch.stack(cache.read(layer, rows, torch.float32))[:, 0, :, :written]
                          for layer in range(cache.num_layers)]).float()
    return torch.stack(seq), chosen, stored


def no_sync_check(torch, cuda, model, kv_layout: str, kv_quantize: str) -> dict:
    """A prefill of 256 tokens in two chunks of 128 at their offsets (the
    engine's chunked path), then two ``decode_step`` steps, on a fresh
    cache of the layout and format, each inside
    ``torch.cuda.set_sync_debug_mode("error")``: any call that makes the
    host wait on the card raises there, and nothing catches it. The chunks
    go to lane 0's table row (or slot). Eight lanes decode with int64
    positions, as the engine hands them; the last lane is idle as the engine
    parks one (its table row all OOB at position 0 on the pool, at the
    slot's end on the slot cache), so its writes drop. Then one
    speculative round (``spec_chunk``, g = 4, prompt lookup in a random
    history) over those lanes, lane 0 sampled with top-k and top-p. The
    chunks must launch C once per layer each, the decode steps the decode
    kernels of the cache's path once per layer and step, the round C on
    verify rows once per layer and nothing else, and on a model of int8
    weights each forward (a chunk, a step, a round's verify) the W8A16
    kernel 7 x 32 + 1 times besides; the logits must be finite and the
    round's tokens and accept counts in range."""
    from gofr_tpu_torch.gpu.engine import make_pool
    from gofr_tpu_torch.gpu.programs import new_history, spec_chunk
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention

    n, page, pages = 8, 128, 4
    rng = torch.Generator().manual_seed(SEED + 4)
    tokens = torch.randint(0, model.cfg.vocab_size, (n,), generator=rng).cuda()
    positions = torch.randint(0, pages * page - 2 - 2 * SPEC_G, (n,), generator=rng)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, 256), generator=rng).cuda()
    if kv_layout == "paged":
        cache = make_pool(model, kv_quantize, n * pages, page)
        table = torch.arange(n * pages, dtype=torch.int32).view(n, pages)
        table[n - 1], positions[n - 1] = n * pages, 0
        table = table.cuda()
        rows = table[:1]
    else:
        cache, table = make_pool(model, kv_quantize, n, pages * page, "slot"), None
        positions[n - 1] = pages * page
        rows = torch.zeros(1, dtype=torch.int32, device="cuda")
    positions = positions.cuda()
    chunk_len = torch.tensor([128], device="cuda")
    offsets = [torch.tensor([c * 128], device="cuda") for c in range(2)]
    int8 = type(model.blocks[0].wq).__name__ == "QLinear"
    pool = f"{kv_layout} {kv_quantize or 'bf16'}" + (" (int8 weights)" if int8 else "")
    layers = model.cfg.num_layers
    # W8A16 launches of one model forward (0 on bf16 weights)
    lin = (7 * layers + 1) if int8 else 0

    def unsynced(fn) -> dict:
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        require(bool(out.isfinite().all()), f"{pool}: non-finite logits under the sync check")
        return cuda.launch_counts()

    def chunked():
        for c in range(2):
            logits, _ = model.prefill(prompt[:, c * 128:(c + 1) * 128], chunk_len, cache, rows,
                                      offsets[c])
        return logits

    counts = unsynced(chunked)
    require(counts["flash_attention"] == flash_attention.offset_launches == 2 * layers
            and counts["w8a16"] == 2 * lin and sum(counts.values()) == 2 * (layers + lin),
            f"{pool}: the chunked prefill did not launch C once per layer and chunk: {counts}")
    chunk_launches = counts["flash_attention"]

    steps = 2

    def decode():
        for step in range(steps):
            logits, _ = model.decode_step(tokens, positions + step, cache, table)
        return logits

    counts = counts_decode = unsynced(decode)
    decode_kernels = [k for k in ON_PATH[kv_layout, kv_quantize] if k not in PREFILL_KERNELS]
    require(all(counts[k] == steps * layers for k in decode_kernels)
            and counts["w8a16"] == steps * lin
            and sum(counts.values()) == steps * (layers * len(decode_kernels) + lin),
            f"{pool}: decode_step did not go through its kernels once per layer: {counts}")

    # one speculative round (prompt lookup in a random history) over the same
    # lanes, the idle lane's history length past the history, lane 0
    # sampled with top-k and top-p, the others greedy
    width = pages * page
    hist = new_history(n, width, "cuda")
    hist[:, :width] = torch.randint(0, model.cfg.vocab_size, (n, width), generator=rng).cuda()
    hlen = positions + 1
    hlen[n - 1] = width + 1
    temps = torch.zeros(n, device="cuda")
    temps[0] = 0.8
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    emitted = []

    def spec_round():
        toks, accs, _ = spec_chunk(model, cache, hist, tokens, hlen, table, temps, 1, SPEC_G,
                                   gen, top_k=50, top_p=0.95)
        emitted.append((toks, accs))
        return toks.float()

    counts = unsynced(spec_round)
    require(counts["flash_attention"] == flash_attention.offset_launches == layers
            and counts["w8a16"] == lin and sum(counts.values()) == layers + lin,
            f"{pool}: a spec round did not launch C on verify rows once per layer alone: {counts}")
    toks, accs = (t.cpu() for t in emitted[0])
    require(bool(((toks >= 0) & (toks < model.cfg.vocab_size)).all())
            and bool(((accs >= 0) & (accs <= SPEC_G)).all()),
            f"{pool}: a spec round emitted {toks.tolist()}, accepted {accs.tolist()}")
    spec_launches = counts["flash_attention"]

    # the adapter plane: one upload (the third adapter into a pool holding
    # two), then a decode step and a spec round with the lanes on base and
    # adapters in turn
    from gofr_tpu_torch.adapters import AdapterPool

    specs = lora_specs(model.cfg)
    lora_pool = AdapterPool(LORA_SLOTS, model.cfg.hidden_size, model.cfg.vocab_size, LORA_RANK,
                            device="cuda")
    for spec in specs[:-1]:
        lora_pool.acquire(spec)
    sel = torch.tensor([i % LORA_SLOTS for i in range(n)], device="cuda")
    ad = (sel, lora_pool.a, lora_pool.b, lora_pool.scale)
    torch.cuda.synchronize()

    def lora_round():
        lora_pool.acquire(specs[-1])
        logits, _ = model.decode_step(tokens, positions + steps, cache, table, adapters=ad)
        toks, _, _ = spec_chunk(model, cache, hist, tokens, hlen + steps, table, temps, 1,
                                SPEC_G, gen, top_k=50, top_p=0.95, adapters=ad)
        return torch.cat([logits.flatten(), toks.float().flatten()])

    counts = unsynced(lora_round)
    require(all(counts[k] == layers for k in decode_kernels)
            and counts["flash_attention"] == flash_attention.offset_launches == layers
            and counts["w8a16"] == 2 * lin
            and sum(counts.values()) == layers * (len(decode_kernels) + 1) + 2 * lin
            and lora_pool.uploads == len(specs),
            f"{pool}: a decode step and a spec round with adapters launched {counts}")
    return {"kv_layout": kv_layout, "kv_pool": kv_quantize or "bf16",
            "weights": "int8" if int8 else "bf16", "chunks": 2, "steps": steps, "spec_rounds": 1,
            "spec_sampled_lanes": 1, "sync_debug_mode": "error",
            "adapters": {"uploads_in_check": 1, "decode_steps": 1, "spec_rounds": 1,
                         "sel": sel.tolist()},
            "launches": {"flash_attention (chunks)": chunk_launches,
                         **{k: counts_decode[k] for k in (*decode_kernels, "w8a16")},
                         "flash_attention (verify)": spec_launches,
                         "with adapters": counts}}


class StagingExporter:
    """A handoff exporter that keeps what a prefill worker stages (its page
    readbacks) and ships nothing: phase 6's stand-in for the wire."""

    def __init__(self):
        self.finished = []

    def known_blob(self) -> bool:
        return False

    def begin_stream(self, request, prompt_tokens, nbytes_page, t0):
        from gofr_tpu_torch.gpu.handoff import StreamTransfer

        return StreamTransfer(request, prompt_tokens, nbytes_page, t0, "phase6")

    def kick(self, transfer) -> None:
        pass

    def finish(self, transfer, first_token, now) -> None:
        self.finished.append(transfer)

    def abort(self, transfer) -> None:
        pass

    def close(self) -> None:
        pass


def export_sync_check(torch, engine, submit, unsynced, fold, pool: str) -> None:
    """A prefill worker's export calls under ``dispatch_sync_check``'s
    check: a 400-token prompt prefilled in chunks of 256, the copies of the
    pages its first chunk made whole staged as its fold would
    (``_stream_handoff_chunk``), then at its activation the tail's and the
    slot freed (``_export_handoff``), each under the state lock, with the
    folds outside the check; every staged page must equal its pool page bit
    for bit."""
    from gofr_tpu_torch.ops.paged import page_planes

    eng = engine(role="prefill")
    exp = eng._handoff_exporter = StagingExporter()
    rng = torch.Generator().manual_seed(SEED + 10)
    submit(eng, torch.randint(0, eng.cfg.vocab_size, (400,), generator=rng).tolist())
    eng._admit_prefill()
    idx, s = 0, eng.slots[0]

    def chunk_then_fold() -> None:
        # the fold without its role's staging, which runs checked below
        eng.role = "both"
        try:
            eng._advance_chunked()
            fold(eng)
        finally:
            eng.role = "prefill"

    def locked(fn):
        def call():
            with eng._state_lock:
                return fn()
        return call

    chunk_then_fold()
    unsynced("stream_handoff_chunk", locked(lambda: eng._stream_handoff_chunk(idx, s)))
    require(s.handoff is not None and s.handoff.staged_pages == 2,
            f"{pool}: the first chunk's fold staged no whole page")
    chunk_then_fold()
    pages = list(eng._slot_pages[idx][:3])
    unsynced("export_handoff", locked(lambda: eng._export_handoff(idx, s, s.last_token)))
    t = exp.finished[0]
    require(t.staged_pages == 3 and eng.slots[idx] is None,
            f"{pool}: the export staged {t.staged_pages} pages, want 3, and kept its slot")
    for p, rb in zip(pages, t.staged):
        host = rb.wait()
        require(all(torch.equal(h, plane[:, p].cpu()) for h, plane in
                    zip(host, page_planes(eng.cache))),
                f"{pool}: a staged handoff page differs from pool page {p}")
    eng.check_page_refs()


def dispatch_sync_check(torch, model, kv_layout: str, kv_quantize: str,
                        planes: bool = False) -> dict:
    """The engine's dispatches on one cache, each inside
    ``torch.cuda.set_sync_debug_mode("error")``: a batched prefill (one lane
    sampled with top-k and top-p) with a long prompt's claim
    (``dispatch_prefill``), that prompt's two chunks (``dispatch_chunk``),
    two decode chunks, the second from the device carry
    (``dispatch_decode``), and on the pool a swap-in of one page into a free
    page (``dispatch_swapins``) and a prefill worker's handoff export
    (``export_sync_check``), then two speculative rounds on an engine
    with ``spec_tokens`` (``dispatch_spec`` / ``dispatch_spec_paged``). Each
    runs on a stopped engine of 2 slots, from this thread; the folds, whose
    waits on their events are the intended ones, run outside the check. The
    page swapped in must equal the page it was copied from, bit for bit.
    With ``planes`` each engine has every request plane on: a container
    with spans kept in memory, the flight recorder, the SLO engine and the
    perf plane, and a QoS controller bound; each request opens its span
    timeline as ``submit`` would."""
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.gpu import decode, executor
    from gofr_tpu_torch.gpu.engine import GenerateEngine, Request
    from gofr_tpu_torch.ops.paged import gather_page, page_planes
    from gofr_tpu_torch.qos import AdmissionController, QoSPolicy

    pool = f"{kv_layout} {kv_quantize or 'bf16'}"
    rng = torch.Generator().manual_seed(SEED + 8)
    short, long = (torch.randint(0, model.cfg.vocab_size, (n,), generator=rng).tolist()
                   for n in (100, 300))
    checked = []

    def engine(**kw):
        container = None
        if planes:
            container = Container.create(DictConfig({"TRACE_EXPORTER": "memory",
                                                     "SLO_ENABLED": "true", "LOG_LEVEL": "ERROR"}))
        eng = GenerateEngine(model, device="cuda", slots=2, max_len=1024, max_prefill_batch=2,
                             decode_chunk=2, prefill_buckets=[128, 256], top_k=50, top_p=0.95,
                             kv_layout=kv_layout, kv_quantize=kv_quantize, container=container,
                             **kw)
        eng.stop()  # its loop ends: the dispatches below run from this thread
        if planes:
            container.register_engine("lm", eng)
            container.register_qos(AdmissionController(QoSPolicy(), container.metrics))
            require(eng.perf is not None and eng.qos is not None and eng.tracer.enabled,
                    f"{pool}: a plane is off on the planes check")
        return eng

    def submit(eng, prompt, temperature=0.0):
        req = Request(prompt, {"max_new_tokens": 16, "temperature": temperature}, None)
        if planes:
            eng._observe_submit(req, None)
        eng._accept(req)

    def unsynced(name, fn) -> None:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            did = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        require(did is None or did, f"{pool}: {name} dispatched nothing")
        checked.append(name)

    def fold(eng) -> None:
        while eng._dq:
            decode.process_decode(eng)

    eng = engine()
    submit(eng, short, temperature=0.8)
    submit(eng, long)
    unsynced("dispatch_prefill", eng._admit_prefill)
    unsynced("dispatch_chunk", eng._advance_chunked)
    unsynced("dispatch_chunk", eng._advance_chunked)
    fold(eng)
    unsynced("dispatch_decode", lambda: decode.dispatch_decode(eng))
    unsynced("dispatch_decode (carry)", lambda: decode.dispatch_decode(eng))
    fold(eng)
    if kv_layout == "paged":
        src, dst = eng._slot_pages[0][0], eng._free_pages[-1]
        host = executor.Readback(eng.device, *gather_page(eng.cache, src)).wait()
        eng._pending_swapins = [(0, eng.slots[0], [], [dst], [tuple(host)])]
        unsynced("dispatch_swapins", lambda: executor.dispatch_swapins(eng))
        fold(eng)
        require(all(bool((plane[:, dst] == plane[:, src]).all()) for plane in page_planes(eng.cache)),
                f"{pool}: the page swapped in differs from the page it was copied from")
        export_sync_check(torch, engine, submit, unsynced, fold, pool)
    eng = engine(spec_tokens=SPEC_G)
    submit(eng, short, temperature=0.8)
    submit(eng, long[:200])
    eng._admit_prefill()
    fold(eng)
    name = "dispatch_spec_paged" if kv_layout == "paged" else "dispatch_spec"
    unsynced(name, lambda: getattr(decode, name)(eng))
    unsynced(f"{name} (carry)", lambda: getattr(decode, name)(eng))
    fold(eng)
    require(eng.counters["spec_rounds"] == 2 * eng.decode_chunk,
            f"{pool}: {eng.counters['spec_rounds']} spec rounds folded")
    return {"kv_layout": kv_layout, "kv_pool": kv_quantize or "bf16",
            "weights": "int8" if type(model.blocks[0].wq).__name__ == "QLinear" else "bf16",
            "planes": planes, "sync_debug_mode": "error", "dispatches": checked}


# Phase 5's runs besides the plain one: (prefill kernels, decode kernels,
# prefill chunks). "kernels" is the served path and "chunked" the engine's
# chunked prefill through the kernels; both are held to LOGITS_RTOL. The
# two splits show which half of the step an error comes from.
PHASE5_RUNS = {"kernels": (True, True, 1), "plain_prefill": (False, True, 1),
               "plain_decode": (True, False, 1), "chunked": (True, True, 2)}


def model_check(torch, model, kv_quantize: str = "", enforce: bool = True,
                kv_layout: str = "paged", tol: float | None = None) -> dict:
    """Kernels vs plain versions, end to end through the model, on a cache
    ``kv_layout`` of the format ``kv_quantize``: each of ``PHASE5_PROMPTS``
    prompts of 256 tokens through ``prefill`` and four ``decode_step`` steps
    with the plain versions, with the kernels, and with the kernels in one
    half of the step only, every run fed the kernel run's greedy tokens;
    and through ``prefill`` and one ``verify_step`` over five of those
    tokens, with the kernels and with the plain versions.
    Reports, for each run and step, max |logits - plain logits| over max
    |plain logit|, and how the K/V stored by the kernel run differ from the
    plain run's (the share of elements that differ, and the RMS of the
    difference over the RMS of the stored values). With ``enforce``, the
    kernel run's and the kernel verify's largest errors must stay under the
    pool's limit, and the decode-only run's and the plain verify's against
    the plain decode steps under ``DECODE_RTOL``. With ``tol`` (the f32
    models) every error is taken over the range of the plain logits instead
    and every run is held to ``tol``."""
    pool = f"{kv_layout} {kv_quantize or 'bf16'}"
    lim, dlim = (LOGITS_RTOL[kv_quantize], DECODE_RTOL) if tol is None else (tol, tol)
    rng = torch.Generator().manual_seed(SEED + 1)
    steps = {name: [] for name in PHASE5_RUNS}
    agree, differ, stored_rel, verify_errs, verify_vs_decode = [], [], [], [], []
    for _ in range(PHASE5_PROMPTS):
        prompt = torch.randint(0, model.cfg.vocab_size, (1, 256), generator=rng).cuda()
        k_run, fed, k_kv = model_steps(torch, model, kv_quantize, prompt, True, True,
                                       kv_layout=kv_layout)
        p_run, _, p_kv = model_steps(torch, model, kv_quantize, prompt, False, False, fed,
                                     kv_layout)
        require(torch.isfinite(k_run).all().item(), f"non-finite logits with the kernels ({pool})")
        top = (p_run.abs().max() if tol is None else p_run.max() - p_run.min()).item()
        for name, (pk, dk, chunks) in PHASE5_RUNS.items():
            run = k_run if name == "kernels" else model_steps(
                torch, model, kv_quantize, prompt, pk, dk, fed, kv_layout, chunks)[0]
            steps[name].append(((run - p_run).abs().amax(dim=(1, 2)) / top).tolist())
        # speculative decoding's verify forward over the 5 tokens the kernel
        # run chose (g + 1 = 5): the kernels against the plain versions, and
        # the plain verify against the plain decode steps' logits
        seq = torch.stack(fed + [k_run[4].argmax(-1).to(torch.int32)], dim=1)
        k_ver, p_ver = (verify_logits(torch, model, kv_quantize, prompt, seq, kernels, kv_layout)
                        for kernels in (True, False))
        verify_errs.append(((k_ver - p_ver).abs().amax(dim=-1) / top).tolist())
        verify_vs_decode.append(((p_ver[:4] - p_run[1:, 0]).abs().amax(dim=-1) / top).tolist())
        agree.append((k_run.argmax(-1) == p_run.argmax(-1)).float().mean().item())
        differ.append((k_kv != p_kv).float().mean().item())
        stored_rel.append(((k_kv - p_kv).pow(2).mean() / p_kv.pow(2).mean()).sqrt().item())
        del k_kv, p_kv
    rel_errs = [max(s) for s in steps["kernels"]]
    chunked_errs = [max(s) for s in steps["chunked"]]
    decode_errs = [max(s[1:]) for s in steps["plain_prefill"]]
    out = {"kv_layout": kv_layout,
           "kv_pool": kv_quantize or ("f32" if model.cfg.dtype == torch.float32 else "bf16"),
           "prompts": PHASE5_PROMPTS,
           "steps": 5, "rel_err": rel_errs, "chunked_rel_err": chunked_errs,
           "tol_rel": lim, "decode_only_rel_err": decode_errs, "decode_only_tol_rel": dlim,
           "rel_to": "max |logit|" if tol is None else "logit range",
           "argmax_agree": agree, "rel_err_by_step": steps,
           "stored_differ": differ, "stored_rms_rel": stored_rel,
           "verify_rel_err": [max(e) for e in verify_errs], "verify_rel_err_by_row": verify_errs,
           "plain_verify_vs_plain_decode_rel_err": [max(e) for e in verify_vs_decode]}
    if enforce:
        require(max(rel_errs) < lim,
                f"kernel vs plain logits ({pool}): max err / max |logit| {rel_errs} "
                f"(limit {lim})")
        require(max(chunked_errs) < lim,
                f"chunked prefill through the kernels vs plain logits ({pool}): {chunked_errs} "
                f"(limit {lim})")
        require(max(decode_errs) < dlim,
                f"kernel vs plain logits, kernels in decode only ({pool}): {decode_errs} "
                f"(limit {dlim})")
        require(max(out["verify_rel_err"]) < lim,
                f"verify_step with the kernels vs plain ({pool}): {out['verify_rel_err']} "
                f"(limit {lim})")
        ver_dec = out["plain_verify_vs_plain_decode_rel_err"]
        require(max(ver_dec) < dlim,
                f"plain verify_step vs plain decode steps ({pool}): {ver_dec} "
                f"(limit {dlim})")
    return out


# Phase 4's ``paged_autotune``: the warmup autotuner (ops/autotune.py) on
# four engines of Llama-3-8B's widths cut to ``COLD_START``'s 2 layers (what
# it measures is one layer's decode attention, at the engine's real slots,
# heads and positions), ``bf16``'s other knobs, one per cache with a split
# kernel: the op it tunes and the kernel that op launches.
AUTOTUNE_RUNS = {("paged", ""): "paged_decode", ("paged", "int8"): "paged_decode_q",
                 ("paged", "int4"): "paged_decode_q4", ("slot", ""): "decode"}


def serve_autotune(torch, cuda) -> dict:
    """Phase 4 ``paged_autotune``: each engine of ``AUTOTUNE_RUNS`` runs
    ``warmup()`` (one length and one batch bucket: the tuner runs first in
    any warmup) with ``GOFR_AUTOTUNE_CACHE`` in a temporary directory, then
    a second engine of the same shapes. Held: the first pins one of its
    candidates (``split_candidates``, ``split_plan``'s first) from its own
    timings, with none disqualified, and another plan than the rule's
    only when it beats the rule by more than the larger spread; the
    second reports ``source:
    "cache"`` and times nothing (its timer raises); each warmup launches
    only kernels of its cache's path, the tuned op's among them; and under
    ``GOFR_AUTOTUNE=0`` the report is None. Printed: every candidate's ms
    (best of 3 bursts on CUDA events) and spread, and the winner beside
    ``split_plan``'s."""
    import tempfile

    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models.llama import LlamaConfig, init
    from gofr_tpu_torch.ops import autotune
    from gofr_tpu_torch.ops.cuda.decode_attention import split_candidates

    cfg = LlamaConfig.llama3_8b(num_layers=COLD_START["layers"])
    model = init(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    knobs = dict(params=model, device="cuda", seed=SEED, slots=8, max_len=2048,
                 max_prefill_batch=4, decode_chunk=8)

    def refuse(fn):
        raise AssertionError("paged_autotune: a cached engine timed a candidate")

    saved = {k: os.environ.get(k) for k in ("GOFR_AUTOTUNE", "GOFR_AUTOTUNE_CACHE")}
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.environ.pop("GOFR_AUTOTUNE", None)
            os.environ["GOFR_AUTOTUNE_CACHE"] = os.path.join(tmp, "autotune.json")
            for (layout, quant), op in AUTOTUNE_RUNS.items():
                name = run_name(layout, quant)
                reports, counts = [], None
                for arm in ("measured", "cache"):
                    eng = build_engine(cfg, kv_layout=layout, kv_quantize=quant, **knobs)
                    if arm == "cache":
                        eng._autotune_timer = refuse
                    try:
                        torch.cuda.synchronize()
                        cuda.reset_launch_counts()
                        t0 = time.perf_counter()
                        eng.warmup(len_buckets=[128], batch_buckets=[1])
                        torch.cuda.synchronize()
                        warm_s = time.perf_counter() - t0
                        if arm == "measured":
                            counts = cuda.launch_counts()
                        reports.append((eng.autotune_report(), warm_s))
                        span = (eng.pages_per_slot * eng.page_size if layout == "paged"
                                else eng.cache_len)
                    finally:
                        eng.stop()
                    del eng
                plans = [autotune.plan_name(r) for r in split_candidates(8, cfg.num_kv_heads, span)]
                (rep, warm_s), (rep2, warm2_s) = reports
                rec, rec2 = rep["decisions"][op], rep2["decisions"][op]
                require(rec["source"] == "measured" and rec["backend"] in plans
                        and list(rec["timings_ms"]) == plans and rep["rule"] == plans[0],
                        f"paged_autotune {name}: {rep}")
                require(not rec.get("errors"), f"paged_autotune {name}: candidates disqualified: "
                                               f"{rec.get('errors')}")
                # a pin other than the rule's beats it by more than the spread
                t, spread = rec["timings_ms"], rec.get("spread_ms", {})
                require(rec["backend"] == plans[0] or t[rec["backend"]] + max(
                    spread.get(rec["backend"], 0.0), spread.get(plans[0], 0.0)) < t[plans[0]],
                        f"paged_autotune {name}: pinned {rec['backend']} inside the spread: {rec}")
                require(rec2["source"] == "cache" and rec2["backend"] == rec["backend"],
                        f"paged_autotune {name}: the second engine's report {rep2}")
                kernel = {"decode": "decode_attention"}.get(op, op)
                require(counts[kernel] > 0, f"paged_autotune {name}: {kernel} never launched")
                for k, launches in counts.items():
                    require(launches == 0 or k in ON_PATH[f"paged_autotune_{name}"],
                            f"paged_autotune {name}: warmup launched kernel {k} {launches} times")
                out[name] = {"op": op, "span": span, "rule": plans[0], "pinned": rec["backend"],
                             "timings_ms": rec["timings_ms"], "spread_ms": rec.get("spread_ms"),
                             "pinned_over_rule": (rec["timings_ms"][rec["backend"]]
                                                  / rec["timings_ms"][plans[0]]),
                             "warmup_s": warm_s, "cached_warmup_s": warm2_s,
                             "tune_s": rep["elapsed_s"], "cached_tune_s": rep2["elapsed_s"],
                             "launches": counts}
            os.environ["GOFR_AUTOTUNE"] = "0"
            eng = build_engine(cfg, **knobs)
            try:
                eng.warmup(len_buckets=[128], batch_buckets=[1])
                off = eng.autotune_report()
            finally:
                eng.stop()
            require(off is None, f"paged_autotune: GOFR_AUTOTUNE=0 still reported {off}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    del model
    torch.cuda.empty_cache()
    return {"model": f"llama3_8b widths, {COLD_START['layers']} layers (random bf16, seed 0)",
            "runs": out, "gofr_autotune_0_report": None, "nvidia_smi": smi_line()}


# Phase 4's ``app_transports``: the App's other entry points on the phase's
# Llama-3-8B (32 layers, ``ModelSpec(weights=model)``), all in one App.
TRANSPORTS_CONFIG = {**HTTP_CONFIG, "APP_ENV": "DEBUG", "ENGINE_WARMUP": "true",
                     "PUBSUB_BACKEND": "inmemory", "GRPC_PORT": "0", "SUBSCRIBER_WORKERS": "4"}
TRANSPORTS_USER = ("smoke", "s3cret")
# a schedule the cron thread's own ticks never meet; the phase fires it by
# ``app.cron.tick`` at the minute it names
TRANSPORTS_CRON = ("0 0 1 1 *", (2027, 1, 1, 0, 0, 30, 0, 0, -1))


class WSClient:
    """A websocket client on a stdlib socket: the RFC 6455 upgrade, masked
    text frames out, the server's unmasked frames in."""

    def __init__(self, port: int, path: str, headers: dict | None = None):
        import base64
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=900)
        key = base64.b64encode(os.urandom(16)).decode()
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        self.sock.sendall((f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nUpgrade: websocket\r\n"
                           f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                           f"Sec-WebSocket-Version: 13\r\n{extra}\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:
            chunk = self.sock.recv(1)
            if not chunk:
                break
            head += chunk
        self.status = int(head.split(b" ", 2)[1]) if head else 0

    def send_text(self, text: str) -> None:
        import struct

        payload, mask = text.encode(), os.urandom(4)
        n = len(payload)
        if n < 126:
            head = bytes([0x81, 0x80 | n])
        elif n < 1 << 16:
            head = bytes([0x81, 0x80 | 126]) + struct.pack("!H", n)
        else:
            head = bytes([0x81, 0x80 | 127]) + struct.pack("!Q", n)
        key = (mask * (n // 4 + 1))[:n]
        body = (int.from_bytes(payload, "big") ^ int.from_bytes(key, "big")).to_bytes(n, "big")
        self.sock.sendall(head + mask + body)

    def _exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("the server closed the connection")
            buf += chunk
        return buf

    def recv_text(self) -> str:
        import struct

        b0, b1 = self._exact(2)
        n = b1 & 0x7F
        if n == 126:
            n = struct.unpack("!H", self._exact(2))[0]
        elif n == 127:
            n = struct.unpack("!Q", self._exact(8))[0]
        payload = self._exact(n)
        require(b0 & 0x0F == 0x1 and not b1 & 0x80, f"websocket: frame opcode {b0 & 0x0F}")
        return payload.decode()

    def close(self) -> None:
        self.sock.close()


def _basic(user: tuple) -> dict:
    import base64

    return {"Authorization": "Basic " + base64.b64encode(":".join(user).encode()).decode()}


def _grpc_service(grpc, current):
    """A JSON-over-gRPC ``gen.Gen`` service (as examples/grpc-server
    registers its own): unary ``Generate`` and server-streaming
    ``GenerateStream``, each through ``current_grpc_context().generate``."""
    def generate(request, context):
        o = current().generate("lm", request["prompt"], max_new_tokens=request["n"], timeout=900)
        return {"tokens": o["tokens"], "ttft_s": o["ttft_s"], "decode_s": o["decode_s"]}

    def generate_stream(request, context):
        for tok in current().generate("lm", request["prompt"], max_new_tokens=request["n"],
                                      timeout=900, stream=True):
            yield {"token": tok}

    def add(server):
        codec = dict(request_deserializer=lambda b: json.loads(b.decode()),
                     response_serializer=lambda o: json.dumps(o).encode())
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler("gen.Gen", {
            "Generate": grpc.unary_unary_rpc_method_handler(generate, **codec),
            "GenerateStream": grpc.unary_stream_rpc_method_handler(generate_stream, **codec),
        }),))

    return add


def p50(xs: list) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def app_transports(torch, cuda, model, base_outs: list) -> dict:
    """Phase 4 ``app_transports``: the port's App on localhost serving the
    phase's Llama-3-8B (``TRANSPORTS_CONFIG``: ``HTTP_CONFIG``,
    ``APP_ENV=DEBUG``, ``ENGINE_WARMUP=true`` so the autotuner pins A's
    plan at 32 layers, in-memory pub/sub with 4 consumers a topic, gRPC on
    a free port) behind Basic auth, its entry points in turn: ``bf16``'s 8
    prompts as 8 concurrent ``/ws/generate`` clients (stdlib sockets,
    masked frames), 64 new tokens each, then a ninth that closes after two
    frames; 4 unary gRPC ``Generate`` calls at once and one
    ``GenerateStream``; prompts 4..7 published to ``prompts``, whose
    subscriber generates and publishes to ``completions``, whose subscriber
    collects them; a cron job fired by ``app.cron.tick``; and auth, a
    static file and the OpenAPI spec. Held: every websocket, gRPC, pub/sub
    and cron request's tokens equal ``bf16``'s by the tie rule; a stream is
    one frame per token then ``{"done": true}``; the ninth request ends
    cancelled and the slots empty; the pool audit clean and nothing
    dropped; the four ``app_pubsub_*`` counters 8 each; the engine launched
    A, B and C and nothing else, A only on the plan it pinned at warmup;
    401 without credentials (``/generate`` and the upgrade), 201 / 101 with
    them, health open, the static file served, the spec listing the
    routes; and after ``stop`` every thread the App started has ended.
    Printed: the websocket first frame's p50 less the engine's TTFT p50,
    the frame gap's p50 beside the engine's TPOT p50, the gRPC overhead
    p50 (client wall less ``ttft_s`` and ``decode_s``), pub/sub publish to
    completion p50, and A's pinned plan."""
    import tempfile
    import threading
    import urllib.request

    import grpc

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.gpu.engine import RequestCancelled
    from gofr_tpu_torch.grpc.server import current_grpc_context
    from gofr_tpu_torch.http.streaming import StreamingResponse
    from gofr_tpu_torch.models import ModelSpec
    from gofr_tpu_torch.ops import autotune
    from gofr_tpu_torch.ops.cuda import paged_decode as paged_decode_mod

    threads_before = set(threading.enumerate())
    prompts = phase4_prompts(torch, model.cfg.vocab_size)
    app = App(config=DictConfig(TRANSPORTS_CONFIG))
    engine = app.serve_model("lm", ModelSpec("llama", model.cfg, weights=model,
                                             dtype=model.cfg.dtype), seed=SEED, eos_token_id=-1)
    submitted, submit = [], engine.submit

    def record(*a, **kw):
        submitted.append(submit(*a, **kw))
        return submitted[-1]

    engine.submit = record
    app.enable_basic_auth(dict([TRANSPORTS_USER]))

    async def generate(ctx):
        body = ctx.bind(dict)
        return await ctx.agenerate("lm", body["prompt"], max_new_tokens=int(body["max_new_tokens"]),
                                   timeout=900)

    def ws_generate(ctx):
        body = ctx.bind(dict)
        return StreamingResponse(ctx.generate("lm", body["prompt"],
                                              max_new_tokens=int(body["max_new_tokens"]),
                                              timeout=900, stream=True))

    completions, lock = {}, threading.Lock()

    def on_prompt(ctx):
        body = ctx.bind(dict)
        o = ctx.generate("lm", body["prompt"], max_new_tokens=64, timeout=900)
        ctx.publish("completions", {"i": body["i"], "sent": body["sent"], "tokens": o["tokens"]})

    def on_completion(ctx):
        body = ctx.bind(dict)
        with lock:
            completions[body["i"]] = {**body, "arrived": time.monotonic()}

    cron_out = []
    static_dir = tempfile.TemporaryDirectory(prefix="gofr-smoke-static-")
    static = static_dir.name
    with open(os.path.join(static, "index.html"), "w") as f:
        f.write("<h1>gofr_tpu_torch</h1>")
    app.post("/generate", generate)
    app.websocket("/ws/generate", ws_generate)
    app.subscribe("prompts", on_prompt)
    app.subscribe("completions", on_completion)
    app.add_cron_job(TRANSPORTS_CRON[0], "smoke", lambda ctx: cron_out.append(
        ctx.generate("lm", prompts[0], max_new_tokens=64, timeout=900)))
    app.add_static_files("/static", static)
    app.register_grpc_service(_grpc_service(grpc, current_grpc_context))
    auth = _basic(TRANSPORTS_USER)
    pinned_rows, real_scratch = [], paged_decode_mod.split_scratch

    def watch_scratch(q, hkv, smax, op=None, dims=()):
        rows, splits, scratch = real_scratch(q, hkv, smax, op, dims)
        pinned_rows.append(rows)
        return rows, splits, scratch

    with static_dir, AppThread(app, "app-transports"):
        port = app.http_port
        report = engine.autotune_report()
        require(report is not None and "paged_decode" in report["decisions"],
                f"app_transports: warmup pinned nothing: {report}")
        pin = report["decisions"]["paged_decode"]
        _, dbg, *_ = http_call(port, "GET", "/debug/engine", headers=auth)
        require(dbg["data"]["engines"]["lm"]["autotune"]["decisions"]["paged_decode"]["backend"]
                == pin["backend"], "app_transports: /debug/engine lacks the pin")
        # auth, health, the spec and a static file
        status_plain = http_call(port, "POST", "/generate",
                                 {"prompt": prompts[1], "max_new_tokens": 2})[0]
        status_auth = http_call(port, "POST", "/generate",
                                {"prompt": prompts[1], "max_new_tokens": 2}, auth)[0]
        ws_plain, ws_auth = WSClient(port, "/ws/generate"), WSClient(port, "/ws/generate", auth)
        statuses = {"generate": (status_plain, status_auth), "upgrade": (ws_plain.status,
                                                                         ws_auth.status)}
        ws_plain.close()
        ws_auth.close()
        status, health, *_ = http_call(port, "GET", "/.well-known/health")
        statuses["health"] = status
        status, spec, *_ = http_call(port, "GET", "/.well-known/openapi.json")
        statuses["openapi"] = status
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/static/index.html", headers=auth), timeout=60) as r:
            statuses["static"], static_body = r.status, r.read().decode()
        require(statuses == {"generate": (401, 201), "upgrade": (401, 101), "health": 200,
                             "openapi": 200, "static": 200}, f"app_transports: {statuses}")
        require("/generate" in spec["paths"] and static_body == "<h1>gofr_tpu_torch</h1>",
                f"app_transports: spec {spec} static {static_body!r}")

        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        paged_decode_mod.split_scratch = watch_scratch
        del submitted[:]
        try:
            # 8 websocket clients at once
            streams = [None] * len(prompts)

            def ws_one(i: int) -> None:
                c = WSClient(port, "/ws/generate", auth)
                t0 = time.perf_counter()
                c.send_text(json.dumps({"prompt": prompts[i], "max_new_tokens": 64}))
                frames, stamps = [], []
                while True:
                    frames.append(json.loads(c.recv_text()))
                    stamps.append(time.perf_counter() - t0)
                    if isinstance(frames[-1], dict):
                        break
                c.close()
                streams[i] = (frames, stamps)

            threads = [threading.Thread(target=ws_one, args=(i,)) for i in range(len(prompts))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(900)
            ws_reqs = [next(q for q in submitted if q.inputs == p) for p in prompts]
            wait_idle(engine)
            # the ninth: two frames, then gone
            ninth = WSClient(port, "/ws/generate", auth)
            ninth.send_text(json.dumps({"prompt": pipeline_prompts(torch, model.cfg.vocab_size)[0],
                                        "max_new_tokens": 512}))
            ninth_frames = [json.loads(ninth.recv_text()) for _ in range(2)]
            ninth.close()
            ninth_req = submitted[-1]
            try:
                ninth_req.result(timeout=300)
                ninth_error = None
            except RequestCancelled as e:
                ninth_error = e
            wait_idle(engine)
            slots_free = all(s is None for s in engine.slots)

            # gRPC: 4 unary calls at once, then one stream
            grpc_replies = [None] * 4
            with grpc.insecure_channel(f"127.0.0.1:{app.grpc_port}") as ch:
                codec = dict(request_serializer=lambda o: json.dumps(o).encode(),
                             response_deserializer=lambda b: json.loads(b.decode()))
                unary = ch.unary_unary("/gen.Gen/Generate", **codec)
                stream = ch.unary_stream("/gen.Gen/GenerateStream", **codec)

                def grpc_one(i: int) -> None:
                    t0 = time.perf_counter()
                    reply = unary({"prompt": prompts[i], "n": 64}, timeout=900)
                    grpc_replies[i] = (reply, time.perf_counter() - t0)

                threads = [threading.Thread(target=grpc_one, args=(i,)) for i in range(4)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(900)
                grpc_stream = [m["token"] for m in stream({"prompt": prompts[4], "n": 64},
                                                          timeout=900)]

            # pub/sub: prompts 4..7 through both topics
            for i in range(4, 8):
                app.container.publish("prompts", {"i": i, "prompt": prompts[i],
                                                  "sent": time.monotonic()})
            deadline = time.monotonic() + 900
            while len(completions) < 4 and time.monotonic() < deadline:
                time.sleep(0.01)
            # cron: the job at the minute its schedule names
            fired = app.cron.tick(time.mktime(TRANSPORTS_CRON[1]))
            while not cron_out and time.monotonic() < deadline:
                time.sleep(0.01)
            wait_idle(engine)
            torch.cuda.synchronize()
            counts = cuda.launch_counts()
        finally:
            paged_decode_mod.split_scratch = real_scratch
        engine.check_page_refs()
        dropped = engine.pipeline_stats()["dropped"]
        m = app.container.metrics
        pubsub_counts = {name: sum(m.get(name).value(topic=t) for t in ("prompts", "completions"))
                         for name in ("app_pubsub_publish_total_count",
                                      "app_pubsub_publish_success_count",
                                      "app_pubsub_subscribe_total_count",
                                      "app_pubsub_subscribe_success_count")}
    # every thread the App started has ended (the handler pool's idle
    # threads leave as its shutdown reaches them)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        left = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
        if not left:
            break
        time.sleep(0.1)
    require(not left, f"app_transports: threads outlived stop(): {left}")
    require(not engine._thread.is_alive(), "app_transports: the engine's thread outlived stop()")

    # the holds on what came back
    ws_outs, ws_first, ws_gaps = [], [], []
    for i, (frames, stamps) in enumerate(streams):
        require(len(frames) == 65 and frames[-1] == {"done": True}
                and all(isinstance(t, int) for t in frames[:-1]),
                f"app_transports websocket {i}: {len(frames)} frames, last {frames[-1:]}")
        ws_outs.append({"tokens": frames[:-1]})
        ws_first.append(stamps[0])
        ws_gaps += [b - a for a, b in zip(stamps[:-2], stamps[1:-1])]
    ws_results = [q.outcome()[0] for q in ws_reqs]
    require(all(isinstance(f, int) for f in ninth_frames) and ninth_error is not None
            and ninth_req.cancelled and slots_free,
            f"app_transports: the ninth client's request ended {ninth_error!r}, cancelled "
            f"{ninth_req.cancelled}, slots free {slots_free}")
    require(all(r is not None for r in grpc_replies), "app_transports: a gRPC call failed")
    grpc_outs = [r[0] for r in grpc_replies]
    require(len(grpc_stream) == 64 and all(len(o["tokens"]) == 64 for o in grpc_outs),
            f"app_transports gRPC: {[len(o['tokens']) for o in grpc_outs]}, stream "
            f"{len(grpc_stream)}")
    require(sorted(completions) == [4, 5, 6, 7]
            and all(len(c["tokens"]) == 64 for c in completions.values()),
            f"app_transports pub/sub: {sorted(completions)}")
    require(fired == ["smoke"] and len(cron_out) == 1 and len(cron_out[0]["tokens"]) == 64,
            f"app_transports cron: fired {fired}, {len(cron_out)} results")
    require(all(v == 8 for v in pubsub_counts.values()), f"app_transports: {pubsub_counts}")
    require(dropped == 0, f"app_transports: {dropped} calls dropped")
    for name, launches in counts.items():
        require((launches > 0) == (name in ON_PATH["app_transports"]),
                f"app_transports: kernel {name} launched {launches} times")
    pinned = autotune.plan_rows(pin["backend"])
    require(pinned_rows and set(pinned_rows) == {pinned},
            f"app_transports: A ran on plans {sorted(set(pinned_rows))}, pinned {pinned}")
    by_path = {
        "websocket": token_agreement(torch, model, prompts, ws_outs, base_outs),
        "grpc": token_agreement(torch, model, prompts[:4], grpc_outs, base_outs[:4]),
        "grpc_stream": token_agreement(torch, model, prompts[4:5], [{"tokens": grpc_stream}],
                                       base_outs[4:5]),
        "pubsub": token_agreement(torch, model, prompts[4:8],
                                  [completions[i] for i in range(4, 8)], base_outs[4:8]),
        "cron": token_agreement(torch, model, prompts[:1], cron_out, base_outs[:1]),
    }
    for path, agree in by_path.items():
        gaps = [mm["chosen_below_top1"] for mm in agree["margin_at_first_difference"] if mm]
        require(all(gap <= SPEC_TIE_GAP for gap in gaps),
                f"app_transports {path}: at a first difference from bf16 the token lies {gaps} "
                f"below the top logit (limit {SPEC_TIE_GAP})")
    ttft = [r["ttft_s"] for r in ws_results]
    tpot = [r["decode_s"] / (len(r["tokens"]) - 1) for r in ws_results]
    grpc_overhead = [wall - (o["ttft_s"] + o["decode_s"]) for o, wall in
                     ((r[0], r[1]) for r in grpc_replies)]
    pub_to_done = [c["arrived"] - c["sent"] for c in completions.values()]
    del engine, app
    torch.cuda.empty_cache()
    return {
        "model": "llama3_8b (random bf16 weights, seed 0)", "config": TRANSPORTS_CONFIG,
        "autotune": report, "pinned_plan": pin["backend"], "rule_plan": report["rule"],
        "statuses": statuses,
        "ws_first_frame_p50_s": p50(ws_first), "engine_ttft_p50_s": p50(ttft),
        "ws_first_frame_minus_ttft_p50_s": p50(ws_first) - p50(ttft),
        "ws_frame_gap_p50_s": p50(ws_gaps), "engine_tpot_p50_s": p50(tpot),
        "ws_frame_gap_max_s": max(ws_gaps),
        "grpc_overhead_p50_s": p50(grpc_overhead), "grpc_overhead_s": grpc_overhead,
        "pubsub_publish_to_completion_p50_s": p50(pub_to_done),
        "pubsub_counts": pubsub_counts, "cron_fired": fired,
        "ninth_client": {"frames_read": len(ninth_frames), "ended": repr(ninth_error)},
        "tokens_equal_bf16": {k: v["tokens_equal"] for k, v in by_path.items()},
        "first_difference": {k: v["first_difference"] for k, v in by_path.items()},
        "a_launches_by_plan": {autotune.plan_name(r): pinned_rows.count(r)
                               for r in sorted(set(pinned_rows))},
        "launches": counts, "nvidia_smi": smi_line(), "note": "smoke run, not a benchmark",
    }


# Phase 4's ``app_services``: an ordinary GoFr service moved onto the card.
# A model App serves the phase's Llama-3-8B (32 layers, ``ModelSpec(weights=
# model)``), migrates its schema at boot, stores each completion in SQLite
# and the KV store and gives the table its CRUD routes; a gateway App that
# serves no model reaches it through the service client (circuit breaker,
# retry, retry budget). ``SERVICES_CONFIG`` is the model App's (its
# ``DB_NAME`` and ``KV_PATH`` go in a temporary directory), ``GATEWAY_CONFIG``
# the gateway's.
SERVICES_CONFIG = {**HTTP_CONFIG, "DB_DIALECT": "sqlite", "TRACE_EXPORTER": "memory"}
GATEWAY_CONFIG = {"HTTP_PORT": "0", "METRICS_PORT": "0", "TRACE_EXPORTER": "memory",
                  "LOG_LEVEL": "ERROR"}
# the gateway's options: the breaker opens after THRESHOLD failures and
# probes every INTERVAL seconds; one retry, from a shared budget
SERVICES_BREAKER = {"threshold": 3, "interval": 5.0}
SERVICES_RETRIES = 1
SERVICES_MIGRATIONS = (
    "CREATE TABLE completion (id INTEGER PRIMARY KEY, prompt TEXT, tokens TEXT, ttft_s REAL)",
    "ALTER TABLE completion ADD COLUMN decode_s REAL",
)


def _completion_entity():
    """The ``completion`` table's row, as ``add_rest_handlers`` reflects it."""
    import dataclasses

    @dataclasses.dataclass
    class Completion:
        id: int
        prompt: str
        tokens: str
        ttft_s: float
        decode_s: float

    return Completion


def app_services(torch, cuda, model, base_outs: list) -> dict:
    """Phase 4 ``app_services``: ``bf16``'s 8 prompts as 8 concurrent
    ``POST /ask`` to the gateway, each with a deadline, forwarded as
    ``POST /complete`` to the model App, which awaits ``ctx.agenerate`` for
    64 greedy tokens, inserts them and ``ttft_s`` through ``ctx.sql`` and
    sets a key in ``ctx.kv``; then ``GET /completion/{id}`` for each through
    the gateway; then the model App stops and calls go on until the breaker
    opens. Held: every request 64 tokens, ``bf16``'s by the tie rule, and
    each row read back through CRUD equal to what ``/ask`` returned;
    ``gofr_migrations`` holds versions 1 and 2; the model App's health shows
    sql, kv, file, tpu and ``model:lm`` UP, ``tpu`` on platform gpu with one
    device, bytes in use above 0 and a limit of the card's total memory; the
    gateway's shows ``service:model`` UP before the stop, and after it DOWN
    with the aggregate DEGRADED; the breaker opens within its threshold plus
    the retries of failed connections and then fails fast without one; the
    gateway's and the model App's server spans share each request's trace
    id and the model App reads the caller's deadline; the launch counters,
    zeroed after a warm-up call, show A, B and C and no other kernel; the
    pool audits clean; after both stop, no thread either App started is
    left. Printed: the gateway's overhead a request (client wall less the
    model App's ``ttft_s`` and ``decode_s``) and where it lies on the one
    monotonic clock the process shares (client to gateway, gateway to
    model App, the insert, the KV set, the way back), the insert's and the
    KV set's seconds (``app_sql_stats`` and ``app_kv_stats`` count the same
    calls), the migrations' seconds and the failures before the breaker
    opened."""
    import tempfile
    import threading

    from gofr_tpu_torch import deadline as deadline_mod
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.models import ModelSpec
    from gofr_tpu_torch.service import CircuitBreaker, Retry
    from gofr_tpu_torch.service.budget import RetryBudget

    threads_before = set(threading.enumerate())
    prompts = phase4_prompts(torch, model.cfg.vocab_size)
    tmp = tempfile.TemporaryDirectory(prefix="gofr-smoke-services-")
    conf = {**SERVICES_CONFIG, "DB_NAME": os.path.join(tmp.name, "completions.db"),
            "KV_PATH": os.path.join(tmp.name, "kv.db")}
    app = App(config=DictConfig(conf))
    t0 = time.perf_counter()
    app.migrate({v + 1: (lambda d, q=q: d.sql.execute(q))
                 for v, q in enumerate(SERVICES_MIGRATIONS)})
    migrate_s = time.perf_counter() - t0
    app.add_rest_handlers(_completion_entity())
    engine = app.serve_model("lm", ModelSpec("llama", model.cfg, weights=model,
                                             dtype=model.cfg.dtype), seed=SEED, eos_token_id=-1)
    seen = {}

    async def complete(ctx):
        t_in = time.monotonic()
        body = ctx.bind(dict)
        o = await ctx.agenerate("lm", body["prompt"], max_new_tokens=64, timeout=900)
        t_gen = time.monotonic()
        ctx.sql.execute("INSERT INTO completion (id, prompt, tokens, ttft_s, decode_s) "
                        "VALUES (?, ?, ?, ?, ?)", (body["id"], json.dumps(body["prompt"]),
                                                   json.dumps(o["tokens"]), o["ttft_s"],
                                                   o["decode_s"]))
        t_sql = time.monotonic()
        ctx.kv.set(f"completion:{body['id']}", json.dumps(o["tokens"]))
        # one process, one monotonic clock: the handler's marks line up
        # with the gateway's and the client's
        seen[body["id"]] = {"trace_id": ctx.span.trace_id, "deadline_s": ctx.deadline_remaining(),
                            "t_in": t_in, "t_gen": t_gen, "t_sql": t_sql,
                            "t_kv": time.monotonic()}
        return {"id": body["id"], "tokens": o["tokens"], "ttft_s": o["ttft_s"],
                "decode_s": o["decode_s"]}

    app.post("/complete", complete)
    gateway = App(config=DictConfig(GATEWAY_CONFIG))
    gw_seen = {}

    def forward(ctx, method, path, body=None):
        headers = {"Content-Type": "application/json"}
        rem = ctx.deadline_remaining()
        if rem is not None:
            headers[deadline_mod.DEADLINE_HEADER] = deadline_mod.header_value(
                time.monotonic() + rem)
        with ctx.trace(f"forward {path}"):
            resp = ctx.http_service("model").request(method, path, body=body, headers=headers)
        return resp.json()["data"]

    def ask(ctx):
        t_in = time.monotonic()
        body = ctx.bind(dict)
        out = forward(ctx, "POST", "/complete", json.dumps(body).encode())
        gw_seen[body["id"]] = {"trace_id": ctx.span.trace_id, "t_in": t_in,
                               "t_out": time.monotonic()}
        return out

    gateway.post("/ask", ask)
    gateway.get("/completion/{id}", lambda ctx: forward(ctx, "GET",
                                                        f"/completion/{ctx.path_param('id')}"))
    model_thread = None
    try:
        model_thread = AppThread(app, "services-model").__enter__()
        model_url = f"http://127.0.0.1:{app.http_port}"
        budget = RetryBudget(metrics=gateway.container.metrics)
        gateway.register_service("model", model_url, CircuitBreaker(**SERVICES_BREAKER),
                                 Retry(max_retries=SERVICES_RETRIES, backoff=0.05, budget=budget))
        with tmp, AppThread(gateway, "services-gateway"):
            port = gateway.http_port
            status, warm, *_ = http_call(app.http_port, "POST", "/complete",
                                         {"id": 0, "prompt": list(range(1, 65))})
            require(status == 201 and len(warm["data"]["tokens"]) == 64,
                    f"app_services warm-up: {status} {warm}")
            torch.cuda.synchronize()
            cuda.reset_launch_counts()
            replies = [None] * len(prompts)
            budget_ms = str(int((time.time() + 900) * 1000))

            def one(i: int) -> None:
                replies[i] = http_call(port, "POST", "/ask", {"id": i + 1, "prompt": prompts[i]},
                                       {deadline_mod.DEADLINE_HEADER: budget_ms})

            threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(900)
            wait_idle(engine)
            torch.cuda.synchronize()
            counts = cuda.launch_counts()
            for i, r in enumerate(replies):
                require(r is not None and r[0] == 201, f"app_services /ask {i}: {r and r[:2]}")
            outs = [r[1]["data"] for r in replies]
            rows = [http_call(port, "GET", f"/completion/{i + 1}") for i in range(len(prompts))]
            model_health = http_call(app.http_port, "GET", "/.well-known/health")
            gateway_health = http_call(port, "GET", "/.well-known/health")
            engine.check_page_refs()
            sql = app.container.sql
            versions = [r["version"] for r in sql.query(
                "SELECT version FROM gofr_migrations ORDER BY version")]
            kv_tokens = [json.loads(app.container.kv.get(f"completion:{i + 1}"))
                         for i in range(len(prompts))]
            sql_stats = app.container.metrics.get("app_sql_stats")
            sql_exec = (sql_stats.count(type="exec"), sql_stats.sum(type="exec"))
            card_total = torch.cuda.get_device_properties(0).total_memory

            # the model App goes away: the gateway fails until its breaker
            # opens, then fails fast
            model_thread.__exit__(None, None, None)
            model_thread = None
            hist = gateway.container.metrics.get("app_http_service_response")
            stopped, opened_after = [], None
            for i in range(2 * SERVICES_BREAKER["threshold"]):
                t = time.perf_counter()
                status, body, *_ = http_call(port, "POST", "/ask", {"id": 100 + i, "prompt": [1]})
                stopped.append({"status": status, "message": body["error"]["message"],
                                "wall_s": time.perf_counter() - t,
                                "connections": hist.count(service=model_url, method="POST",
                                                          status="0")})
                if opened_after is None and body["error"]["message"] == "circuit breaker is open":
                    opened_after = i
            down_health = http_call(port, "GET", "/.well-known/health")
            retries = gateway.container.metrics.get("app_retry_budget_spent_total").value()
    finally:
        if model_thread is not None:
            model_thread.__exit__(None, None, None)
    exported = {name: a.container.tracer._exporter.spans for name, a in (("model", app),
                                                                         ("gateway", gateway))}
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        left = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
        if not left:
            break
        time.sleep(0.1)
    require(not left, f"app_services: threads outlived stop(): {left}")
    require(not engine._thread.is_alive(), "app_services: the engine's thread outlived stop()")

    # the holds on what came back
    for i, (o, r) in enumerate(zip(outs, rows)):
        require(len(o["tokens"]) == 64, f"app_services /ask {i}: {len(o['tokens'])} tokens")
        require(r[0] == 200 and json.loads(r[1]["data"]["tokens"]) == o["tokens"]
                and kv_tokens[i] == o["tokens"] and json.loads(r[1]["data"]["prompt"]) == prompts[i],
                f"app_services: row {i + 1} read back {r[0]} {str(r[1])[:200]}")
    require(versions == [1, 2], f"app_services: gofr_migrations holds {versions}")
    m_services = model_health[1]["data"]["services"]
    require(model_health[0] == 200 and all(m_services.get(k, {}).get("status") == "UP"
                                           for k in ("sql", "kv", "file", "tpu", "model:lm")),
            f"app_services: model App health {model_health[:2]}")
    tpu = m_services["tpu"]["details"]
    mem = tpu["memory"]["0"]
    require(tpu["platform"] == "gpu" and tpu["devices"] == 1 and mem["bytes_in_use"] > 0
            and mem["bytes_limit"] == card_total,
            f"app_services: tpu health {tpu} (card total {card_total})")
    require(gateway_health[0] == 200
            and gateway_health[1]["data"]["services"]["service:model"]["status"] == "UP",
            f"app_services: gateway health {gateway_health[:2]}")
    down = down_health[1]["data"]
    require(down_health[0] == 200 and down["status"] == "DEGRADED"
            and down["services"]["service:model"]["status"] == "DOWN",
            f"app_services: gateway health after the stop {down_health[:2]}")
    limit = SERVICES_BREAKER["threshold"] + SERVICES_RETRIES
    require(opened_after is not None and all(s["status"] == 503 for s in stopped)
            and stopped[-1]["connections"] <= limit
            and stopped[opened_after]["connections"] == stopped[-1]["connections"],
            f"app_services: after the stop {stopped}")
    trace_ids = {name: {s.trace_id for s in ss if s.name == f"POST /{path}"}
                 for (name, ss), path in zip(exported.items(), ("complete", "ask"))}
    ids = range(1, len(prompts) + 1)
    require(all(seen[i]["trace_id"] == gw_seen[i]["trace_id"] for i in ids)
            and {gw_seen[i]["trace_id"] for i in ids} <= trace_ids["model"] & trace_ids["gateway"],
            f"app_services: trace ids gateway { {i: gw_seen[i]['trace_id'] for i in ids} } model "
            f"{ {i: seen[i]['trace_id'] for i in ids} }")
    require(all(seen[i]["deadline_s"] is not None and 0 < seen[i]["deadline_s"] <= 900
                for i in ids), f"app_services: deadlines { {i: seen[i]['deadline_s'] for i in ids} }")
    for name, launches in counts.items():
        require((launches > 0) == (name in ON_PATH["app_services"]),
                f"app_services: kernel {name} launched {launches} times")
    agreement_ = token_agreement(torch, model, prompts, outs, base_outs)
    gaps = [mm["chosen_below_top1"] for mm in agreement_["margin_at_first_difference"] if mm]
    require(all(gap <= SPEC_TIE_GAP for gap in gaps),
            f"app_services: at a first difference from bf16 the token lies {gaps} below the "
            f"top logit (limit {SPEC_TIE_GAP})")
    walls = [r[2] for r in replies]
    overhead = sorted(w - (o["ttft_s"] + o["decode_s"]) for w, o in zip(walls, outs))
    # where the overhead lies, on the one clock: the client's start, the
    # gateway's handler, the model App's handler (generated, inserted, KV
    # set), the gateway's return and the client's last byte
    marks = [(r[3], gw_seen[i]["t_in"], seen[i]["t_in"], seen[i]["t_gen"], seen[i]["t_sql"],
              seen[i]["t_kv"], gw_seen[i]["t_out"], r[3] + r[2]) for i, r in zip(ids, replies)]
    spans = {name: [m[k + 1] - m[k] for m in marks] for k, name in enumerate(
        ("client_to_gateway_s", "gateway_to_model_s", "model_handler_generate_s", "insert_s",
         "kv_set_s", "model_to_gateway_return_s", "gateway_to_client_s"))}
    # the model App's handler outside the engine's own ttft + decode
    model_side = [m[3] - m[2] - (o["ttft_s"] + o["decode_s"]) for m, o in zip(marks, outs)]
    kv_stats = app.container.metrics.get("app_kv_stats")
    del engine, app, gateway
    torch.cuda.empty_cache()
    return {
        "model": "llama3_8b (random bf16 weights, seed 0)", "config": SERVICES_CONFIG,
        "gateway_config": GATEWAY_CONFIG, "breaker": SERVICES_BREAKER,
        "retries": SERVICES_RETRIES, "requests": len(outs), "new_tokens": 64,
        "client_wall_s": walls, "ttft_s": [o["ttft_s"] for o in outs],
        "decode_s": [o["decode_s"] for o in outs],
        "gateway_overhead_p50_s": p50(overhead), "gateway_overhead_max_s": overhead[-1],
        "insert_s_p50": p50(spans["insert_s"]), "kv_set_s_p50": p50(spans["kv_set_s"]),
        "overhead_spans": spans, "model_handler_outside_engine_s": model_side,
        "app_sql_stats_exec": {"count": sql_exec[0], "sum_s": sql_exec[1]},
        "app_kv_stats_set": {"count": kv_stats.count(op="set"), "sum_s": kv_stats.sum(op="set")},
        "migrations_s": migrate_s, "migrations": versions,
        "tpu_health": tpu, "card_total_bytes": card_total,
        "after_stop": stopped, "failures_before_open": opened_after,
        "retries_granted": retries, "gateway_health_after_stop": down["status"],
        **agreement_, "compared_with": "bf16",
        "launches": counts, "nvidia_smi": smi_line(), "note": "smoke run, not a benchmark",
    }


# Phase 4's encoder runs, on the BatchEngine (the port's embed and classify
# path). ``bert_embed``, BASELINE.md configuration #1: BERT-base at full
# width and depth (12 layers, 768 wide, 12 heads of 64), random bf16
# weights from the seed, served by the App from a ``ModelSpec`` with
# ``ENCODER_CONFIG`` and ``ENGINE_MAX_BATCH`` 256, warmed on the 64 bucket,
# takes ``BERT_REQUESTS`` unary JSON-over-gRPC calls of 64 token ids each
# from ``BERT_CLIENTS`` client threads. ``vit_classify``, configuration
# #3: ViT-L/16 at 224 (24 layers, 1024 wide, 16 heads of 64), random bf16
# weights from the seed, ``ENGINE_MAX_BATCH`` 32, takes ``VIT_IMAGES``
# 224 x 224 x 3 uint8 images published to the in-memory broker and read by
# ``SUBSCRIBER_WORKERS`` 32 consumer threads. Each run's outputs are held
# against the plain path (``kernels=False``) on the same inputs within
# ``ENCODER_RTOL`` of the plain outputs' range, the rule phase 5 holds the
# Llama logits to.
ENCODER_CONFIG = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR"}
BERT_CONFIG = {**ENCODER_CONFIG, "GRPC_PORT": "0", "GRPC_THREADS": "64",
               "ENGINE_MAX_BATCH": "256", "ENGINE_MAX_WAIT_MS": "2"}
BERT_REQUESTS, BERT_CLIENTS, BERT_TOKENS = 512, 64, 64
VIT_CONFIG = {**ENCODER_CONFIG, "PUBSUB_BACKEND": "inmemory", "SUBSCRIBER_WORKERS": "32",
              "ENGINE_MAX_BATCH": "32", "ENGINE_MAX_WAIT_MS": "2"}
VIT_IMAGES = 64
ENCODER_RTOL = 5e-2
# The encoders in f32 (their configs' own dtype): ``bert_embed_f32`` and
# ``vit_classify_f32`` serve less traffic over the same transports, and
# their outputs are held within ``ENCODER_RTOL_F32`` of the plain path's
# range (f32 through the kernels and through the plain path differ by a few
# f32 ulps a layer).
BERT_REQUESTS_F32, VIT_IMAGES_F32 = 128, 32
ENCODER_RTOL_F32 = 1e-4


def range_err(got, want) -> dict:
    """Largest |got - want| over the range of ``want``."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    span = (want.max() - want.min()).item()
    return {"max_abs_err": err, "range": span, "rel_to_range": err / max(span, 1e-30)}


def step_recorder(engine) -> list:
    """The real requests of each step the engine runs from now on."""
    sizes, step = [], engine._step

    def record(batch):
        sizes.append(len(batch))
        return step(batch)

    engine._step = record
    return sizes


def step_seconds(app, steps: int) -> dict:
    """The wall seconds of the last ``steps`` batch steps (the flight
    recorder's, encode to readback on the engine's thread), p50 and max,
    and their mean occupancy."""
    recorded = [s for s in app.container.flight.steps() if s["kind"] == "batch"][:steps]
    wall = [s["seconds"] for s in recorded]
    return {"step_wall_p50_s": p50(wall), "step_wall_max_s": max(wall),
            "mean_occupancy": sum(s["occupancy"] for s in recorded) / len(recorded)}


def forward_alone_ms(torch, fn) -> float:
    """One forward's time on CUDA events with nothing else running (the
    mean of 5 after 2 untimed)."""
    with torch.inference_mode():
        return time_ms(torch, lambda i: fn(), 5, warmup=2)


def encoder_holds(name: str, counts: dict, sizes: list, layers: int) -> None:
    """The run's build of C at 64 (bf16, or f32) once a layer a step, and no
    other kernel."""
    for kernel, launches in counts.items():
        require((launches > 0) == (kernel in ON_PATH[name]),
                f"{name}: kernel {kernel} launched {launches} times")
    build = ON_PATH[name][0]
    require(counts[build] == layers * len(sizes),
            f"{name}: {build} launched {counts[build]} times for {len(sizes)} "
            f"steps of {layers} layers")


def bert_embed(torch, cuda, dtype=None) -> dict:
    """Phase 4 ``bert_embed``, or in f32 (``dtype``) ``bert_embed_f32``
    with ``BERT_REQUESTS_F32`` calls, C's f32 build and ``ENCODER_RTOL_F32``
    (configuration #1, see above). Held: every
    call answers with an embedding of norm 1 within 1e-3; at least one step
    holds 8 requests or more; C's 64 build launches 12 times a step and no
    other kernel launches; a full batch of the requests through the plain
    path, and one request alone through the kernels (batch invariance),
    agree with the served embeddings within ``ENCODER_RTOL``. Printed:
    requests a second, client latency p50 and p99, the steps' mean size,
    occupancy and wall seconds, and a forward of ``BERT_CLIENTS`` requests
    alone on CUDA events."""
    import threading

    import grpc

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.grpc.server import current_grpc_context
    from gofr_tpu_torch.models import BertConfig, ModelSpec

    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    name, n_req = ("bert_embed_f32", BERT_REQUESTS_F32) if f32 else ("bert_embed", BERT_REQUESTS)
    rtol = ENCODER_RTOL_F32 if f32 else ENCODER_RTOL
    cfg = BertConfig.base(dtype=dtype)
    gen = torch.Generator().manual_seed(SEED + 7)
    requests = torch.randint(1000, cfg.vocab_size, (n_req, BERT_TOKENS),
                             generator=gen).tolist()
    app = App(config=DictConfig(BERT_CONFIG))
    engine = app.serve_model("bert", ModelSpec("bert", cfg, task="embed", dtype=dtype), seed=SEED)

    def embed(request, context):
        return {"embedding": current_grpc_context().infer("bert", request["tokens"],
                                                          timeout=300).tolist()}

    def add(server):
        codec = dict(request_deserializer=lambda b: json.loads(b.decode()),
                     response_serializer=lambda o: json.dumps(o).encode())
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler("embed.Embed", {
            "Embed": grpc.unary_unary_rpc_method_handler(embed, **codec)}),))

    app.register_grpc_service(add)
    replies, latency = [None] * n_req, [0.0] * n_req
    with AppThread(app, "bert-embed"):
        warmed = engine.warmup(requests[0], len_buckets=[BERT_TOKENS])
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        sizes = step_recorder(engine)
        with grpc.insecure_channel(f"127.0.0.1:{app.grpc_port}") as ch:
            call = ch.unary_unary("/embed.Embed/Embed",
                                  request_serializer=lambda o: json.dumps(o).encode(),
                                  response_deserializer=lambda b: json.loads(b.decode()))

            def client(c: int) -> None:
                for i in range(c, n_req, BERT_CLIENTS):
                    t0 = time.perf_counter()
                    replies[i] = call({"tokens": requests[i]}, timeout=300)["embedding"]
                    latency[i] = time.perf_counter() - t0

            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(c,)) for c in range(BERT_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        del engine._step  # the recorder off: the class method again
        model = engine.model
        require(all(r is not None for r in replies), f"{name}: a call did not answer")
        served = torch.tensor(replies, dtype=torch.float32)
        norms = served.norm(dim=-1)
        require(bool(((norms - 1).abs() <= 1e-3).all()),
                f"{name}: embedding norms {norms.min().item()}..{norms.max().item()}")
        require(max(sizes) >= 8, f"{name}: no step held 8 requests: {sizes}")
        encoder_holds(name, counts, sizes, cfg.num_layers)
        # the plain path on a full batch of the same requests, and one
        # request alone through the kernels
        n = min(engine.max_batch, n_req)
        tokens = torch.tensor(requests[:n], device="cuda")
        lengths = torch.full((n,), BERT_TOKENS, dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            plain = model.embed_pooled(tokens, lengths, kernels=False).cpu()
            alone = model.embed_pooled(tokens[:1], lengths[:1]).cpu()
        agree = {"plain_full_batch": range_err(served[:n], plain),
                 "alone_vs_in_batch": range_err(alone, served[:1])}
        for label, a in agree.items():
            require(a["rel_to_range"] <= rtol,
                    f"{name} {label}: {a} (limit {rtol} of the range)")
        walls = step_seconds(app, len(sizes))
        # a step of the clients' count alone, beside the served steps' wall
        alone_ms = forward_alone_ms(torch, lambda: model.embed_pooled(tokens[:BERT_CLIENTS],
                                                                      lengths[:BERT_CLIENTS]))
    require(not engine._thread.is_alive(), f"{name}: the engine's thread outlived stop()")
    del engine, app, model
    torch.cuda.empty_cache()
    return {"model": f"bert-base (random {'f32' if f32 else 'bf16'} weights, seed 0)",
            "config": BERT_CONFIG, "requests": n_req, "clients": BERT_CLIENTS,
            "tokens": BERT_TOKENS, "tolerance_rel_to_range": rtol,
            "warmup_steps": warmed, "steps": len(sizes), "step_sizes": sizes,
            "mean_step_size": sum(sizes) / len(sizes), **walls,
            f"forward_alone_ms_batch_{BERT_CLIENTS}": alone_ms,
            "req_per_s": n_req / wall, "latency_p50_s": p50(latency),
            "latency_p99_s": sorted(latency)[int(0.99 * len(latency))],
            "agreement": agree, "launches": counts, "nvidia_smi": smi_line(),
            "note": "smoke run, not a benchmark"}


def vit_classify(torch, cuda, dtype=None) -> dict:
    """Phase 4 ``vit_classify``, or in f32 (``dtype``) ``vit_classify_f32``
    with ``VIT_IMAGES_F32`` images, C's f32 build and ``ENCODER_RTOL_F32``
    (configuration #3, see above). Held: every
    message is handled and committed (``app_pubsub_*``: ``VIT_IMAGES``
    published, received and handled); every logit row is finite and within
    ``ENCODER_RTOL`` of the plain path's range on a batch of the same
    images; C's 64 build launches 24 times a step and no other kernel.
    Printed: messages a second, the steps' mean size, occupancy and wall
    seconds, and a forward of 32 images alone on CUDA events."""
    import base64
    import threading

    import numpy as np

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.models import ModelSpec, ViTConfig

    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    name, n_img = ("vit_classify_f32", VIT_IMAGES_F32) if f32 else ("vit_classify", VIT_IMAGES)
    rtol = ENCODER_RTOL_F32 if f32 else ENCODER_RTOL
    cfg = ViTConfig.large(dtype=dtype)
    gen = torch.Generator().manual_seed(SEED + 8)
    images = torch.randint(0, 256, (n_img, cfg.image_size, cfg.image_size, 3),
                           generator=gen, dtype=torch.uint8).numpy()
    app = App(config=DictConfig(VIT_CONFIG))
    engine = app.serve_model("vit", ModelSpec("vit", cfg, task="classify", dtype=dtype), seed=SEED)
    logits, done, lock = {}, {}, threading.Lock()

    def pixels(raw: bytes):
        """uint8 HWC → float32 in [-1, 1], ViT's normalisation."""
        img = np.frombuffer(raw, np.uint8).reshape(cfg.image_size, cfg.image_size, 3)
        return (img.astype(np.float32) / 255.0 - 0.5) / 0.5

    def on_image(ctx):
        body = ctx.bind(dict)
        out = ctx.infer("vit", pixels(base64.b64decode(body["image"])), timeout=300)
        with lock:
            logits[body["i"]] = out
            done[body["i"]] = time.perf_counter()

    app.subscribe("images", on_image)
    payloads = [{"i": i, "image": base64.b64encode(images[i].tobytes()).decode()}
                for i in range(n_img)]
    with AppThread(app, "vit-classify"):
        warmed = engine.warmup(pixels(images[0].tobytes()))
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        sizes = step_recorder(engine)
        t0 = time.perf_counter()
        for body in payloads:
            app.container.publish("images", body)
        deadline = time.monotonic() + 600
        while len(logits) < n_img and time.monotonic() < deadline:
            time.sleep(0.01)
        wall = max(done.values(), default=t0) - t0
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        del engine._step  # the recorder off: the class method again
        model = engine.model
        m = app.container.metrics
        pubsub_counts = {name: m.get(name).value(topic="images")
                         for name in ("app_pubsub_publish_total_count",
                                      "app_pubsub_publish_success_count",
                                      "app_pubsub_subscribe_total_count",
                                      "app_pubsub_subscribe_success_count")}
        require(sorted(logits) == list(range(n_img)),
                f"{name}: {len(logits)} of {n_img} images classified")
        require(all(v == n_img for v in pubsub_counts.values()), f"{name}: {pubsub_counts}")
        served = torch.tensor(np.stack([logits[i] for i in range(n_img)]))
        require(served.shape == (n_img, cfg.num_classes) and bool(served.isfinite().all()),
                f"{name}: logits {tuple(served.shape)}, finite {bool(served.isfinite().all())}")
        encoder_holds(name, counts, sizes, cfg.num_layers)
        n = min(engine.max_batch, n_img)
        batch = torch.tensor(np.stack([pixels(images[i].tobytes()) for i in range(n)]),
                             device="cuda")
        with torch.inference_mode():
            plain = model(batch, kernels=False).cpu()
        agree = range_err(served[:n], plain)
        require(agree["rel_to_range"] <= rtol,
                f"{name}: served logits vs plain {agree} (limit {rtol} of the range)")
        walls = step_seconds(app, len(sizes))
        alone_ms = forward_alone_ms(torch, lambda: model(batch))
    require(not engine._thread.is_alive(), f"{name}: the engine's thread outlived stop()")
    del engine, app, model
    torch.cuda.empty_cache()
    return {"model": f"vit-large-16-224 (random {'f32' if f32 else 'bf16'} weights, seed 0)",
            "config": VIT_CONFIG, "images": n_img, "tolerance_rel_to_range": rtol,
            "warmup_steps": warmed, "steps": len(sizes),
            "step_sizes": sizes, "mean_step_size": sum(sizes) / len(sizes), **walls,
            f"forward_alone_ms_batch_{n}": alone_ms,
            "msgs_per_s": n_img / max(wall, 1e-9), "agreement": agree,
            "pubsub_counts": pubsub_counts, "launches": counts, "nvidia_smi": smi_line(),
            "note": "smoke run, not a benchmark"}


# Phase 4's head-dim-64 generate runs. ``gpt2_generate``: GPT-2 small
# (``GPT2Config.small``: 12 layers of 768, 12 heads of 64, MHA), random
# bf16 weights from the seed, served by the App's ``/generate`` from a
# ``ModelSpec`` and ``GPT2_CONFIG`` on the family's default layout, the bf16
# slot cache: ``ENGINE_MAX_LEN`` 1016 puts each slot at GPT-2's 1024
# positions (1016 + a decode chunk of 8), the prefill buckets are
# ``GPT2_BUCKETS``, so a prompt past 512 tokens prefills in chunks, the
# second at an offset. ``gpt2_w8``: the same with ``ENGINE_QUANTIZE=int8``.
# ``one_b_bf16``: Llama one_b (22 layers of 2048, 32 heads of 64, 4 KV
# heads) on the bf16 pool with ``bf16``'s knobs and prompts. The tokens of
# the bf16 runs are held by the tie rule against the plain path's on the
# card (``plain_tokens``).
GPT2_CONFIG = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR", "ENGINE_SLOTS": "8",
               "ENGINE_MAX_LEN": "1016", "ENGINE_PREFILL_BATCH": "4", "ENGINE_DECODE_CHUNK": "8"}
GPT2_BUCKETS = [128, 256, 512]
GPT2_NEW = 64
# ``gpt2_f32``: the same App, knobs and prompts with GPT-2 small in its own
# f32 (``ModelSpec("gpt2", dtype=torch.float32)``) on the f32 slot cache.
# The KV bytes of one position of each run's cache: 12 layers x 12 heads x
# K and V x 64 elements of 2 or 4 bytes.
GPT2_KV_BYTES = {False: 36_864, True: 73_728}


def gpt2_prompts(torch, vocab: int) -> list[list[int]]:
    """8 prompts of 64..768 tokens from the seed; at least one past the
    largest bucket, so it prefills in chunks."""
    rng = torch.Generator().manual_seed(SEED + 11)
    lens = torch.randint(64, 769, (8,), generator=rng).tolist()
    require(max(lens) > GPT2_BUCKETS[-1], f"gpt2 prompts {lens}: none chunks")
    return [torch.randint(0, vocab, (n,), generator=rng).tolist() for n in lens]


def plain_tokens(torch, model, prompts: list, new: int, kv_quantize: str = "",
                 kv_layout: str = "slot", prefill_kernels: bool = False) -> tuple[list[dict], object]:
    """Greedy tokens of ``prompts`` on the plain path on the card: one
    padded prefill and ``new`` - 1 decode steps with ``kernels=False`` (no
    kernel, plain attention, appends and products) on a cache of the
    layout and format, one slot (or one table row of pages of 128) a
    prompt; with ``prefill_kernels`` the prefill runs the kernels, as the
    engine's does, and only the decode steps are plain. Returns the tokens
    and the logits of every step, [new, N, V]."""
    from gofr_tpu_torch.gpu.engine import make_pool

    n, width = len(prompts), max(len(p) for p in prompts)
    tokens = torch.zeros(n, width, dtype=torch.long)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p)
    lengths = torch.tensor([len(p) for p in prompts], device="cuda")
    if kv_layout == "paged":
        maxp = math.ceil((width + new) / 128)
        cache = make_pool(model, kv_quantize, n * maxp, 128)
        rows = table = torch.arange(n * maxp, dtype=torch.int32, device="cuda").view(n, maxp)
    else:
        cache, table = make_pool(model, kv_quantize, n, width + new, "slot"), None
        rows = torch.arange(n, device="cuda")
    with torch.inference_mode():
        logits, _ = model.prefill(tokens.cuda(), lengths, cache, rows, kernels=prefill_kernels)
        steps = [logits]
        for step in range(new - 1):
            logits, _ = model.decode_step(steps[-1].argmax(-1), lengths + step, cache, table,
                                          kernels=False)
            steps.append(logits)
    steps = torch.stack(steps)
    ids = steps.argmax(-1).T.cpu().tolist()
    del cache
    return [{"tokens": t} for t in ids], steps


def gpt2_serve(torch, cuda, w8: bool = False, base: dict | None = None,
               f32: bool = False) -> dict:
    """Phase 4 ``gpt2_generate``, ``gpt2_w8`` (``w8``), ``gpt2_f32``
    (``f32``: GPT-2 small in its own f32, C, F and G's 64 f32 builds, the
    cache at ``GPT2_KV_BYTES`` a position, the tokens the f32 plain path's
    by the tie rule at ``F32_TIE_GAP`` on that path's logits) or
    ``gpt2_w8_f32`` (both: the f32 model with int8 weights, W8A16's f32
    build). Held: every POST is a 201 with ``GPT2_NEW`` tokens ended by
    length; the launches are the run's ``ON_PATH`` kernels and no other:
    C, F and G's 64 builds, F and G equally often, a whole number of decode
    steps x 12 layers, C on chunk rows at an offset too; with ``w8`` the
    W8A16 kernel 6 x 12 times a model forward, on prefill and decode rows
    (the tied head stays in the model's dtype), and the int8 model smaller
    than ``base``'s. The bf16 run's tokens equal the plain path's on the
    card by the tie rule; the bf16 w8 run's are compared with ``base``'s
    (the bf16 run), not held; the f32 w8 run's are held against the f32
    plain path's on its own int8 model at ``F32_TIE_GAP``, and compared
    with ``base``'s (``gpt2_f32``). Printed: TTFT, decode tok/s, weight
    bytes."""
    import threading

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.models import GPT2Config, ModelSpec
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention
    from gofr_tpu_torch.ops.quant import quantized_bytes

    name = ("gpt2_w8" if w8 else "gpt2") + ("_f32" if f32 else "" if w8 else "_generate")
    config = {**GPT2_CONFIG, **({"ENGINE_QUANTIZE": "int8"} if w8 else {})}
    cfg = GPT2Config.small() if f32 else GPT2Config.small(dtype=torch.bfloat16)
    # the run's builds of F, G and C at 64
    f_64, g_64, c_64 = (k + ("_f32" if f32 else "") for k in (
        "decode_attention_d64", "kv_append_slot_d64", "flash_attention_d64"))
    app = App(config=DictConfig(config))
    t0 = time.perf_counter()
    engine = app.serve_model("gpt2", ModelSpec("gpt2", cfg, dtype=cfg.dtype), seed=SEED,
                             eos_token_id=-1, prefill_buckets=GPT2_BUCKETS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    async def generate(ctx):
        body = ctx.bind(dict)
        return await ctx.agenerate("gpt2", body["prompt"], max_new_tokens=int(body["max_new_tokens"]),
                                   timeout=900)

    app.post("/generate", generate)
    prompts = gpt2_prompts(torch, cfg.vocab_size)
    with AppThread(app, name):
        port = app.http_port
        status, warm, *_ = http_call(port, "POST", "/generate",
                                    {"prompt": list(range(1, 65)), "max_new_tokens": 2})
        require(status == 201 and warm["data"]["finish_reason"] == "length",
                f"{name} warm-up: {status} {warm}")
        wait_idle(engine)
        torch.cuda.synchronize()
        before = dict(engine.counters)
        cuda.reset_launch_counts()
        replies = [None] * len(prompts)

        def one(i: int) -> None:
            replies[i] = http_call(port, "POST", "/generate",
                                   {"prompt": prompts[i], "max_new_tokens": GPT2_NEW})

        t_submit = time.monotonic()
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        wait_idle(engine)
        torch.cuda.synchronize()
        t_done = time.monotonic()
        counts, offset_launches = cuda.launch_counts(), flash_attention.offset_launches
        did = {k: v - before[k] for k, v in engine.counters.items()}
        model, cache_len, kv_layout = engine.model, engine.cache_len, engine.kv_layout
        kv_bytes = (sum(t.nbytes for t in vars(engine.cache).values())
                    / (engine.cache.k.shape[1] * engine.cache.k.shape[3]))
    require(not engine._thread.is_alive(), f"{name}: the engine's thread outlived stop()")
    for i, r in enumerate(replies):
        require(r is not None and r[0] == 201, f"{name} request {i}: {r and r[:2]}")
        o = r[1]["data"]
        require(o["finish_reason"] == "length" and len(o["tokens"]) == GPT2_NEW,
                f"{name} request {i}: {o['finish_reason']}, {len(o['tokens'])} tokens")
    outs = [r[1]["data"] for r in replies]
    require(kv_layout == "slot" and cache_len == cfg.max_seq_len,
            f"{name}: served on {kv_layout} of {cache_len} positions, not GPT-2's slot of "
            f"{cfg.max_seq_len}")
    for kernel, launches in counts.items():
        require((launches > 0) == (kernel in ON_PATH[name]),
                f"{name}: kernel {kernel} launched {launches} times")
    layers = cfg.num_layers
    require(counts[f_64] == counts[g_64] and counts[f_64] % layers == 0,
            f"{name}: F and G's 64 builds launched {counts[f_64]} and {counts[g_64]} times, not "
            f"decode steps x {layers}")
    require(kv_bytes == GPT2_KV_BYTES[f32],
            f"{name}: {kv_bytes} KV bytes a position, not {GPT2_KV_BYTES[f32]}")
    require(did["prefill_chunks_at_offset"] > 0 and offset_launches > 0,
            f"{name}: no prompt prefilled in chunks at an offset ({did}, C {offset_launches})")
    forwards = (counts[f_64] + counts[c_64]) // layers
    held = quantized_bytes(model)
    metrics = {"model": f"gpt2 small (random {'f32' if f32 else 'bf16'} weights, seed 0"
                        + (", served in int8)" if w8 else ")"),
               "config": config, "prefill_buckets": GPT2_BUCKETS, "layers": layers,
               "kv_layout": kv_layout, "slot_positions": cache_len, "engine_build_s": build_s,
               "requests": len(outs), "prompt_lens": [len(p) for p in prompts],
               "new_tokens": GPT2_NEW, "decode_steps": counts[f_64] // layers,
               "kv_bytes_per_position": kv_bytes,
               "prefill_chunks_at_offset": did["prefill_chunks_at_offset"],
               "flash_offset_launches": offset_launches, "weight_bytes": held}
    if w8:
        per_forward = 6 * layers
        w8_name = "w8a16" + ("_f32" if f32 else "")
        require(counts[w8_name] == forwards * per_forward,
                f"{name}: W8A16 launched {counts[w8_name]} times for {forwards} model forwards, "
                f"not {per_forward} each")
        require(type(model.blocks[0].w_fc).__name__ == "QLinear" and model.wte.dtype == cfg.dtype,
                f"{name}: the served model is not int8 with a {cfg.dtype} head")
        metrics.update({"w8a16_launches_per_forward": per_forward, "model_forwards": forwards})
        if base is not None:
            require(held < base["metrics"]["weight_bytes"],
                    f"{name}: the int8 model holds {held} B, the bf16 one "
                    f"{base['metrics']['weight_bytes']}")
            metrics["weight_bytes_vs_" + ("f32" if f32 else "bf16")] = (
                held / base["metrics"]["weight_bytes"])
            metrics["vs_gpt2_" + ("f32" if f32 else "generate")] = token_agreement(
                torch, model, prompts, outs, base["outs"])
        if f32:
            want, logits = plain_tokens(torch, model, prompts, GPT2_NEW)
            metrics["vs_plain_path"] = hold_tie(name, torch, model, prompts, outs, want, logits,
                                                gap=F32_TIE_GAP)
            del logits
    elif f32:
        want, logits = plain_tokens(torch, model, prompts, GPT2_NEW)
        metrics["vs_plain_path"] = hold_tie(name, torch, model, prompts, outs, want, logits,
                                            gap=F32_TIE_GAP)
        del logits
    else:
        want, _ = plain_tokens(torch, model, prompts, GPT2_NEW)
        metrics["vs_plain_path"] = hold_tie(name, torch, model, prompts, outs, want)
    first = [t_submit + o["ttft_s"] for o in outs]
    done = [f + o["decode_s"] for f, o in zip(first, outs)]
    ttft = sorted(o["ttft_s"] for o in outs)
    metrics.update({"ttft_s": [o["ttft_s"] for o in outs], "ttft_p50_s": ttft[len(ttft) // 2],
                    "decode_tok_s": sum(len(o["tokens"]) - 1 for o in outs) / (max(done) - min(first)),
                    "wall_s": t_done - t_submit, "nvidia_smi": smi_line(),
                    "note": "smoke run, not a benchmark"})
    result = {"metrics": metrics, "launches": counts, "outs": outs, "model": model}
    del engine, app
    torch.cuda.empty_cache()
    return result


# Phase 4's ``llama_slot_f32``: Llama-3-8B's widths (32 heads, 8 KV heads
# of 128) cut to ``LLAMA_F32_LAYERS`` layers (a kernel's first-use costs go
# by shape, not by layer), random f32 weights from the seed, on the f32 slot
# cache with ``serve``'s knobs and ``bf16``'s prompts: the 128 f32 builds of
# C, F and G on a served path.
LLAMA_F32_LAYERS = 2


def llama_slot_f32(torch, cuda) -> dict:
    """Phase 4 ``llama_slot_f32``. Held (``serve``): C, F and G's 128 f32
    builds and no other kernel, F and G equally often in whole steps x 2
    layers, the f32 cache's bytes a position; and the tokens the f32 plain
    path's on the slot cache by the tie rule at ``F32_TIE_GAP`` on that
    path's own logits."""
    import dataclasses

    from gofr_tpu_torch.models.llama import LlamaConfig, init

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=LLAMA_F32_LAYERS,
                              dtype=torch.float32)
    model = init(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    eng, counts, metrics, outs = serve(torch, cuda, model, "", "slot", run="llama_slot_f32")
    eng.stop()
    del eng
    prompts = phase4_prompts(torch, cfg.vocab_size)
    want, logits = plain_tokens(torch, model, prompts, 64)
    metrics["vs_plain_path"] = hold_tie("llama_slot_f32", torch, model, prompts, outs, want, logits,
                                        gap=F32_TIE_GAP)
    metrics["nvidia_smi"] = smi_line()
    del logits, model
    torch.cuda.empty_cache()
    return {"metrics": metrics, "launches": counts}


def f32_llama_run(torch, cuda, model, name: str) -> dict:
    """Phase 4's f32 Llama runs (``F32_LLAMA_RUNS``): an f32 Llama
    (``model``: one_b at full width and depth, or Llama-3-8B's widths cut
    to ``LLAMA_F32_LAYERS`` layers) on the run's cache, with int8 weights
    for ``llama_w8_f32`` (``serve``'s ``w8`` route: a ``ModelSpec`` and
    ``ENGINE_QUANTIZE=int8``), with ``serve``'s knobs and prompts. Held
    (``serve``): the run's ``ON_PATH`` f32 builds and no other kernel, its
    decode-step builds equally often in whole steps x layers (W8A16's 7 x
    layers + 1 a forward); the cache's bytes a position at
    ``F32_LLAMA_KV_BYTES``; and the tokens the f32 plain path's on the same
    cache (and weights) by the tie rule at ``F32_TIE_GAP`` on that path's
    own logits; on a quantized cache the plain decode's after C's prefill at
    ``INT8_F32_TIE_RTOL`` (int8) or ``INT4_F32_TIE_RTOL`` (int4), and the
    whole plain path's at the cache's phase-5 limit."""
    _, kv_layout, kv_quantize, weights = F32_LLAMA_RUNS[name]
    eng, counts, metrics, outs = serve(torch, cuda, model, kv_quantize, kv_layout, run=name,
                                       w8=bool(weights))
    served_model = eng.model
    eng.stop()
    del eng
    per = metrics["kv_bytes_per_position"]
    require(per == F32_LLAMA_KV_BYTES[name],
            f"{name}: {per} KV bytes a position, not {F32_LLAMA_KV_BYTES[name]}")
    prompts = phase4_prompts(torch, model.cfg.vocab_size)
    want, logits = plain_tokens(torch, served_model, prompts, 64, kv_quantize, kv_layout)
    if kv_quantize:
        # prefills in other batches store K/V from activations a few f32
        # ulps apart, which flips stored codes (2-3% of the int8 elements
        # between C's prefill and the plain one on one_b): so the decode
        # kernels are held by the tie rule against the plain decode after
        # C's prefill, and the whole plain path by phase 5's limit for this
        # cache
        rtol = INT8_F32_TIE_RTOL if kv_quantize == "int8" else INT4_F32_TIE_RTOL
        want_d, logits_d = plain_tokens(torch, served_model, prompts, 64, kv_quantize, kv_layout,
                                        prefill_kernels=True)
        metrics["vs_plain_decode"] = hold_tie(f"{name} (C's prefill, plain decode)", torch,
                                              served_model, prompts, outs, want_d, logits_d,
                                              rtol=rtol)
        del logits_d
        metrics["vs_plain_path"] = hold_tie(name, torch, served_model, prompts, outs, want, logits,
                                            rtol=LOGITS_RTOL[kv_quantize])
    else:
        metrics["vs_plain_path"] = hold_tie(name, torch, served_model, prompts, outs, want, logits,
                                            gap=F32_TIE_GAP)
    metrics["nvidia_smi"] = smi_line()
    del logits, served_model
    torch.cuda.empty_cache()
    return {"metrics": metrics, "launches": counts}


def one_b_run(torch, cuda, model, kv_quantize: str = "", kv_layout: str = "paged",
              base: dict | None = None) -> dict:
    """Phase 4 ``one_b_bf16``, ``one_b_int8``, ``one_b_int4`` or
    ``one_b_slot_int8`` (``ONE_B_RUNS``): Llama one_b (``model``, random
    bf16 weights from the seed) on the cache of the layout and format with
    ``serve``'s knobs and prompts. Held: the run's ``ON_PATH`` 64 builds
    and no other kernel, its decode-step kernels equally often in whole
    steps x 22 layers, the cache's bytes a position, and the tokens the
    plain path's on the same cache by the tie rule (on the bf16 pool read
    on a whole-sequence forward, on a quantized cache on the plain path's
    own logits; on the int4 pool the tie rule holds them against the plain
    decode steps after C's prefill, and phase 5's limit against the whole
    plain path). Against ``base`` (``one_b_bf16``) the tokens are
    reported, not held."""
    name = ONE_B_RUNS[kv_layout, kv_quantize]
    eng, counts, metrics, outs = serve(torch, cuda, model, kv_quantize, kv_layout, run=name)
    eng.stop()
    del eng
    per = metrics["pool_bytes"] / metrics["pool_positions"]
    require(per == ONE_B_KV_BYTES[kv_quantize],
            f"{name}: {per} KV bytes a position, not {ONE_B_KV_BYTES[kv_quantize]}")
    prompts = phase4_prompts(torch, model.cfg.vocab_size)
    want, logits = plain_tokens(torch, model, prompts, 64, kv_quantize, kv_layout)
    if kv_quantize == "int4":
        # C's prefill rounds otherwise than the plain one, which flips 4-bit
        # codes and moves one_b's logits past the tie gap (on an H100, 700 W:
        # a token 0.14 below the top, at the same first differences as with
        # C alone in the prefill and plain decode steps); so the decode
        # kernels are held by the tie rule against the plain decode after
        # C's prefill, and the whole plain path by phase 5's limit for this
        # pool
        want_d, logits_d = plain_tokens(torch, model, prompts, 64, kv_quantize, kv_layout,
                                        prefill_kernels=True)
        metrics["vs_plain_decode"] = hold_tie(f"{name} (C's prefill, plain decode)", torch, model,
                                              prompts, outs, want_d, logits_d)
        del logits_d
        metrics["vs_plain_path"] = hold_tie(name, torch, model, prompts, outs, want, logits,
                                            rtol=LOGITS_RTOL[kv_quantize])
    elif kv_quantize:
        metrics["vs_plain_path"] = hold_tie(name, torch, model, prompts, outs, want, logits)
    else:
        metrics["vs_plain_path"] = hold_tie(name, torch, model, prompts, outs, want)
    del logits
    if base is not None:
        metrics["vs_one_b_bf16"] = token_agreement(torch, model, prompts, outs, base["outs"])
    metrics["nvidia_smi"] = smi_line()
    torch.cuda.empty_cache()
    return {"metrics": metrics, "launches": counts, "outs": outs}


def one_b_no_sync_check(torch, cuda, model, kv_quantize: str) -> dict:
    """Phase 6 on one_b's pools: a prefill of 256 tokens in two chunks of
    128 at their offsets, then two ``decode_step`` steps over 8 lanes (the
    last idle, its table row all OOB, so its writes drop), each inside
    ``torch.cuda.set_sync_debug_mode("error")``; the chunks launch C's 64
    build once a layer each, the steps the pool's decode kernel and append
    at 64 once a layer each, and nothing else launches; on the f32 model
    (the f32 pool and the int8 pool under f32) the f32 builds."""
    from gofr_tpu_torch.gpu.engine import make_pool

    n, page, pages = 8, 128, 4
    layers = model.cfg.num_layers
    rng = torch.Generator().manual_seed(SEED + 13)
    tokens = torch.randint(0, model.cfg.vocab_size, (n,), generator=rng).cuda()
    positions = torch.randint(0, pages * page - 2, (n,), generator=rng)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, 256), generator=rng).cuda()
    cache = make_pool(model, kv_quantize, n * pages, page)
    table = torch.arange(n * pages, dtype=torch.int32).view(n, pages)
    table[n - 1], positions[n - 1] = n * pages, 0
    table, positions = table.cuda(), positions.cuda()
    chunk_len = torch.tensor([128], device="cuda")
    offsets = [torch.tensor([c * 128], device="cuda") for c in range(2)]

    def unsynced(fn) -> dict:
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        require(bool(out.isfinite().all()), f"one_b {kv_quantize}: non-finite logits under the "
                                            "sync check")
        return {k: v for k, v in cuda.launch_counts().items() if v}

    def chunked():
        for c in range(2):
            logits, _ = model.prefill(prompt[:, c * 128:(c + 1) * 128], chunk_len, cache, table[:1],
                                      offsets[c])
        return logits

    def decode():
        for step in range(2):
            logits, _ = model.decode_step(tokens, positions + step, cache, table)
        return logits

    chunks, steps = unsynced(chunked), unsynced(decode)
    f32 = model.cfg.dtype == torch.float32
    run = (next(r for r, spec in F32_LLAMA_RUNS.items() if spec == ("one_b", "paged", kv_quantize, ""))
           if f32 else ONE_B_RUNS["paged", kv_quantize])
    require(chunks == {"flash_attention_d64" + ("_f32" if f32 else ""): 2 * layers},
            f"one_b {kv_quantize}: the chunked prefill launched {chunks}")
    require(steps == {k: 2 * layers for k in ON_PATH[run] if k not in PREFILL_KERNELS},
            f"one_b {kv_quantize}: two decode steps launched {steps}")
    del cache
    return {"model": "one_b" + (" (f32)" if f32 else ""), "kv_layout": "paged",
            "kv_pool": kv_quantize or ("f32" if f32 else "bf16"), "chunks": 2,
            "steps": 2, "sync_debug_mode": "error", "launches": {"chunks": chunks, "steps": steps}}


def gpt2_no_sync_check(torch, cuda, model) -> dict:
    """Phase 6 on GPT-2's slot path: a prefill of 256 tokens in two chunks of
    128 at their offsets, then two ``decode_step`` steps over 8 lanes (the
    last idle at the slot's end, so its writes drop), each inside
    ``torch.cuda.set_sync_debug_mode("error")``; the chunks launch C's 64
    build once a layer each, the steps F's and G's 64 builds once a layer
    each, and nothing else launches; on the f32 model, the f32 builds; on
    an int8-weight model, W8A16 too, 6 x 12 times a forward."""
    n, smax = 8, 1024
    layers = model.cfg.num_layers
    sfx = "_f32" if model.cfg.dtype == torch.float32 else ""
    rng = torch.Generator().manual_seed(SEED + 12)
    tokens = torch.randint(0, model.cfg.vocab_size, (n,), generator=rng).cuda()
    positions = torch.randint(0, smax - 4, (n,), generator=rng)
    positions[n - 1] = smax
    positions = positions.cuda()
    prompt = torch.randint(0, model.cfg.vocab_size, (1, 256), generator=rng).cuda()
    cache = model.make_cache(n, smax)
    rows = torch.zeros(1, dtype=torch.int32, device="cuda")
    chunk_len = torch.tensor([128], device="cuda")
    offsets = [torch.tensor([c * 128], device="cuda") for c in range(2)]

    def unsynced(fn) -> dict:
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        require(bool(out.isfinite().all()), "gpt2: non-finite logits under the sync check")
        return {k: v for k, v in cuda.launch_counts().items() if v}

    def chunked():
        for c in range(2):
            logits, _ = model.prefill(prompt[:, c * 128:(c + 1) * 128], chunk_len, cache, rows,
                                      offsets[c])
        return logits

    def decode():
        for step in range(2):
            logits, _ = model.decode_step(tokens, positions + step, cache)
        return logits

    chunks, steps = unsynced(chunked), unsynced(decode)
    # with int8 weights W8A16 too, 6 x 12 times a forward
    w8 = type(model.blocks[0].w_fc).__name__ == "QLinear"
    products = {"w8a16" + sfx: 2 * 6 * layers} if w8 else {}
    require(chunks == {"flash_attention_d64" + sfx: 2 * layers, **products},
            f"gpt2: the chunked prefill launched {chunks}")
    require(steps == {"decode_attention_d64" + sfx: 2 * layers,
                      "kv_append_slot_d64" + sfx: 2 * layers, **products},
            f"gpt2: two decode steps launched {steps}")
    del cache
    return {"model": "gpt2 small" + (" (int8 weights)" if w8 else ""), "kv_layout": "slot",
            "kv_pool": "f32" if sfx else "bf16",
            "chunks": 2,
            "steps": 2, "sync_debug_mode": "error", "launches": {"chunks": chunks, "steps": steps}}


def launches_by_run(served: dict) -> dict[str, dict[str, int]]:
    """Each phase-4 run's launch counts by kernel: the runs that record one
    set, the spec engine of ``paged_control`` and the two sides of
    ``paged_handoff`` (summed over its arms)."""
    out = {}
    for r, v in served.items():
        counts = v.get("launches") if isinstance(v, dict) else None
        if isinstance(counts, dict) and counts and all(isinstance(n, int)
                                                       for n in counts.values()):
            out[r if isinstance(r, str) else run_name(*r)] = counts
    if "paged_control" in served:
        out["paged_control_spec"] = served["paged_control"]["spec"]["launches"]
    for side, counts in served.get("paged_handoff", {}).get("launches", {}).items():
        out[f"paged_handoff_{side}"] = counts
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gofr_tpu_torch.gpu.device import device_info
    from gofr_tpu_torch.ops import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wall, start = {}, time.perf_counter()

    def lap(name: str) -> None:
        wall[name] = time.perf_counter() - start - sum(wall.values())

    def report(phase: str, payload: dict, name: str | None = None) -> None:
        """A phase-4 run's result line, with the run's wall seconds (``lap``
        under ``name``, by default the line's own name)."""
        lap(name or phase)
        emit(phase, {**payload, "run_wall_s": wall[name or phase]})

    emit("phase1_device", device_info())

    built = cuda.build()
    notes = [ln.strip() for ln in built["ptxas"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("phase2_build", {"seconds": built["seconds"], "ptxas": notes})
    lap("phases_1_2")

    kernels = check_kernels(torch)
    for row in kernels:
        if row["name"] in F32_FLASH_DIMS:
            row["build"] = flash_f32_build(built["ptxas"], F32_FLASH_DIMS[row["name"]])
    emit("phase3_kernels", kernels)
    torch.cuda.empty_cache()
    lap("phase3")

    # the same 8 requests on each cache, one model
    model, served, results = None, {}, {}
    for kv_layout, kv_quantize in RUNS:
        eng, counts, metrics, outs = serve(torch, cuda, model, kv_quantize, kv_layout)
        eng.stop()
        model = eng.model
        served[kv_layout, kv_quantize] = {"metrics": metrics, "launches": counts}
        results[kv_layout, kv_quantize] = outs
        del eng
        torch.cuda.empty_cache()
        report(f"phase4_serve_{run_name(kv_layout, kv_quantize)}", {**metrics, "launches": counts},
               f"phase4_{run_name(kv_layout, kv_quantize)}")

    served.update(serve_spec(torch, cuda, model, results))
    lap("phase4_spec")

    admission = serve_admission(torch, cuda, model)
    served["paged_admission"] = admission
    report("phase4_serve_paged_admission", admission, "phase4_paged_admission")

    served["paged_prefix_host"] = serve_prefix_host(torch, cuda, model)
    report("phase4_serve_paged_prefix_host", {k: v for k, v in served["paged_prefix_host"].items()
                                              if k not in ("counters_host_tier_off", "pool_after")},
           "phase4_paged_prefix_host")

    served["paged_pipeline"] = serve_pipeline(torch, cuda, model)
    report("phase4_serve_paged_pipeline", {**served["paged_pipeline"], "arms": [
        {k: v for k, v in arm.items() if k != "margin_at_first_difference"}
        for arm in served["paged_pipeline"]["arms"]]}, "phase4_paged_pipeline")

    served["paged_lora"] = serve_lora(torch, cuda, model, served["paged", ""]["metrics"],
                                      results["paged", ""])
    report("phase4_serve_paged_lora", {**served["paged_lora"]["metrics"],
                                     "launches": served["paged_lora"]["launches"]},
           "phase4_paged_lora")

    adoption = adopt_check(torch, cuda)
    served["adopt_weights"] = adoption
    report("phase4_adopt_weights", adoption)

    served["http_generate"] = http_generate(torch, cuda, model, served["paged", ""]["metrics"],
                                            results["paged", ""])
    report("phase4_http_generate", served["http_generate"])

    served["http_planes"] = http_planes(torch, cuda, model, results["paged", ""])
    report("phase4_http_planes", {**served["http_planes"], "arms": [
        {k: v for k, v in arm.items() if k != "batch_margin_at_first_difference"}
        for arm in served["http_planes"]["arms"]]})

    served["paged_w8"], w8_model = serve_w8(torch, cuda, model, served["paged", ""]["metrics"],
                                            results["paged", ""])
    report("phase4_serve_paged_w8", {**served["paged_w8"]["metrics"],
                                   "launches": served["paged_w8"]["launches"]}, "phase4_paged_w8")

    served["paged_warmup"] = serve_warmup(torch, cuda, model, results["paged", ""])
    report("phase4_serve_paged_warmup", {k: v for k, v in served["paged_warmup"].items()
                                       if k != "margin_at_first_difference"}, "phase4_paged_warmup")

    served["paged_restart"] = serve_restart(torch, cuda, model, results["paged", ""])
    report("phase4_serve_paged_restart", {k: v for k, v in served["paged_restart"].items()
                                        if k != "margin_at_first_difference"},
           "phase4_paged_restart")

    for kv_quantize, capture in (("", True), ("int8", False)):
        name = f"{kv_quantize or 'paged'}_quality"
        served[name] = quality_run(torch, cuda, model, kv_quantize, results["paged", kv_quantize],
                                   capture)
        report(f"phase4_serve_{name}", {k: v for k, v in served[name].items()
                                      if k != "margin_at_first_difference"}, f"phase4_{name}")

    served["paged_control"] = serve_control(torch, cuda, model, results["paged", ""])
    report("phase4_serve_paged_control", served["paged_control"], "phase4_paged_control")

    served["paged_handoff"] = serve_handoff(torch, cuda, model, results, served)
    report("phase4_serve_paged_handoff", served["paged_handoff"], "phase4_paged_handoff")

    served["cold_start"] = cold_start(torch)
    report("phase4_cold_start", served["cold_start"])

    autotuned = serve_autotune(torch, cuda)
    for name, run in autotuned["runs"].items():
        served[f"paged_autotune_{name}"] = run
    report("phase4_serve_paged_autotune", autotuned, "phase4_paged_autotune")

    served["app_transports"] = app_transports(torch, cuda, model, results["paged", ""])
    report("phase4_app_transports", served["app_transports"])

    served["app_services"] = app_services(torch, cuda, model, results["paged", ""])
    report("phase4_app_services", served["app_services"])

    served["bert_embed"] = bert_embed(torch, cuda)
    report("phase4_bert_embed",
           {k: v for k, v in served["bert_embed"].items() if k != "step_sizes"})

    served["vit_classify"] = vit_classify(torch, cuda)
    report("phase4_vit_classify", served["vit_classify"])

    # the f32 models in their own dtype: the encoders, then GPT-2 small
    for name, run in (("bert_embed_f32", bert_embed), ("vit_classify_f32", vit_classify)):
        served[name] = run(torch, cuda, torch.float32)
        report(f"phase4_{name}", {k: v for k, v in served[name].items() if k != "step_sizes"})
    gpt2_32 = gpt2_serve(torch, cuda, f32=True)
    served["gpt2_f32"] = {"metrics": gpt2_32["metrics"], "launches": gpt2_32["launches"]}
    report("phase4_gpt2_f32", served["gpt2_f32"])

    gpt2 = gpt2_serve(torch, cuda)
    served["gpt2_generate"] = {"metrics": gpt2["metrics"], "launches": gpt2["launches"]}
    report("phase4_gpt2_generate", served["gpt2_generate"])
    gpt2_w8 = gpt2_serve(torch, cuda, w8=True, base=gpt2)
    served["gpt2_w8"] = {"metrics": gpt2_w8["metrics"], "launches": gpt2_w8["launches"]}
    del gpt2_w8
    report("phase4_gpt2_w8", served["gpt2_w8"])
    # GPT-2 small in its own f32 with int8 weights: W8A16's f32 build
    gpt2_w8_32 = gpt2_serve(torch, cuda, w8=True, base=gpt2_32, f32=True)
    served["gpt2_w8_f32"] = {"metrics": gpt2_w8_32["metrics"], "launches": gpt2_w8_32["launches"]}
    report("phase4_gpt2_w8_f32", served["gpt2_w8_f32"])

    from gofr_tpu_torch.models.llama import LlamaConfig, init

    one_b = init(LlamaConfig.one_b(), torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    for (kv_layout, kv_quantize), name in ONE_B_RUNS.items():
        served[name] = one_b_run(torch, cuda, one_b, kv_quantize, kv_layout,
                                 served.get("one_b_bf16"))
        report(f"phase4_serve_{name}", {k: v for k, v in served[name].items() if k != "outs"},
               f"phase4_{name}")
    served["llama_slot_f32"] = llama_slot_f32(torch, cuda)
    report("phase4_serve_llama_slot_f32", served["llama_slot_f32"], "phase4_llama_slot_f32")
    # an f32 Llama on every cache and with int8 weights: one_b at full
    # width and depth, and Llama-3-8B's widths cut to 2 layers
    one_b32 = init(LlamaConfig.one_b(dtype=torch.float32),
                   torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    llama32 = init(LlamaConfig.llama3_8b(num_layers=LLAMA_F32_LAYERS, dtype=torch.float32),
                   torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    for name, (which, *_) in F32_LLAMA_RUNS.items():
        served[name] = f32_llama_run(torch, cuda, one_b32 if which == "one_b" else llama32, name)
        report(f"phase4_serve_{name}", served[name], f"phase4_{name}")
    del llama32
    torch.cuda.empty_cache()

    for kv_layout, kv_quantize in RUNS:
        emit(f"phase5_model_{run_name(kv_layout, kv_quantize)}",
             model_check(torch, model, kv_quantize, kv_layout=kv_layout))
        lap(f"phase5_{run_name(kv_layout, kv_quantize)}")
    emit("phase5_lora", [lora_check(torch, model, *run) for run in RUNS])
    lap("phase5_lora")
    # the int8-weight model on the bf16 pool: W8A16 against qdot_plain end to end
    emit("phase5_model_w8", {"weights": "int8", **model_check(torch, w8_model, "")})
    lap("phase5_w8")
    # one_b on the quantized pools: D64, E64 and the appends at 64 end to end
    for kv_quantize in ("int8", "int4"):
        emit(f"phase5_model_one_b_{kv_quantize}",
             {"model": "one_b", **model_check(torch, one_b, kv_quantize)})
        lap(f"phase5_one_b_{kv_quantize}")
    # GPT-2 small in f32 on its slot cache: C, F and G's f32 builds end to end,
    # within 1e-3 of the plain path's logit range
    emit("phase5_model_gpt2_f32", {"model": "gpt2 small (f32)", **model_check(
        torch, gpt2_32["model"], kv_layout="slot", tol=F32_TIE_GAP)})
    lap("phase5_gpt2_f32")
    # one_b in f32 on the f32 pool (A, B and C's 64 f32 builds: within
    # F32_TIE_GAP of the plain logits' range) and on the int8 pool (D and
    # B-q's f32 builds: the int8 pool's limit)
    emit("phase5_model_one_b_f32", {"model": "one_b (f32)", **model_check(
        torch, one_b32, "", tol=F32_TIE_GAP)})
    emit("phase5_model_one_b_int8_f32", {"model": "one_b (f32)", **model_check(
        torch, one_b32, "int8")})
    lap("phase5_one_b_f32")
    # one_b in f32 on the int4 pool (E and B-q4's 64 f32 builds: the int4
    # pool's limit) and GPT-2 small in f32 with int8 weights on its slot
    # cache (W8A16's f32 build: within F32_TIE_GAP of the plain logits' range)
    emit("phase5_model_one_b_int4_f32", {"model": "one_b (f32)", **model_check(
        torch, one_b32, "int4")})
    emit("phase5_model_gpt2_w8_f32", {"model": "gpt2 small (f32, int8 weights)", **model_check(
        torch, gpt2_w8_32["model"], kv_layout="slot", tol=F32_TIE_GAP)})
    lap("phase5_f32_int4_w8")

    emit("phase6_no_sync", [no_sync_check(torch, cuda, m, *run)
                            for m, run in [(model, r) for r in RUNS] + [(w8_model, ("paged", ""))]])
    emit("phase6_dispatch_no_sync", [dispatch_sync_check(torch, m, *run) for m, run in
                                     [(model, r) for r in RUNS] + [(w8_model, ("paged", ""))]]
         + [dispatch_sync_check(torch, model, "paged", "", planes=True)])
    emit("phase6_gpt2_no_sync", [gpt2_no_sync_check(torch, cuda, m["model"])
                                 for m in (gpt2, gpt2_32, gpt2_w8_32)])
    emit("phase6_one_b_no_sync", [one_b_no_sync_check(torch, cuda, m, q) for m, q in (
        (one_b, "int8"), (one_b, "int4"), (one_b32, ""), (one_b32, "int8"), (one_b32, "int4"))])
    del gpt2, gpt2_32, gpt2_w8_32, one_b, one_b32
    lap("phase6")

    # each kernel's launches from the first serving run whose path it is on,
    # and from every run that launched it
    by_run = launches_by_run(served)
    for k in kernels:
        run = next(r for r in (*RUNS, "paged_w8", "bert_embed", "gpt2_generate",
                               *ONE_B_RUNS.values(), "gpt2_f32", "llama_slot_f32",
                               *F32_LLAMA_RUNS, "gpt2_w8_f32")
                   if k["name"] in ON_PATH[r])
        k["launches"] = served[run]["launches"][k["name"]]
        k["launches_by_run"] = {r: lc[k["name"]] for r, lc in by_run.items() if lc.get(k["name"])}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "wall_s": wall,
                   "serve": {r if isinstance(r, str) else run_name(*r):
                             {k: v for k, v in run.items() if k != "outs"} if isinstance(run, dict)
                             else run for r, run in served.items()}}, f, indent=1)
    emit("wall_time", {"seconds": time.perf_counter() - start, "by_phase": wall})
    print(json.dumps({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms", "launches_by_run")} for k in kernels]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
