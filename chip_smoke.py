"""On-card smoke test of the PyTorch/CUDA port (``tpu_engine_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc builds the seven kernels of tpu_engine_torch/csrc
              (five sources, one process per source, all started together)
              into one library;
3. parity   — each kernel against its plain PyTorch version on the card:
              f32 at the JAX package's parity-check and flash-test shapes
              and the flash forward at the train phase's shape (tolerance
              1e-5), bf16 at the main path's shapes (2e-2 on unit
              normals; for the flash forward on out and lse), int8 pools at
              both (2e-4, the JAX package's bound for its int8 kernels);
              the split reads also against the plain repetition of their
              own split arithmetic (#2 bf16 8e-3, about one bf16 ulp; #3
              1e-5, f32 at the same rounding points; #4 2e-4); the flash
              forward and the split reads (#1-#4)
              bit-identical over two runs, and each row of a split read
              bit-identical alone and in its batch (its split plan depends
              on its own data only); #1 and #4 also at the speculative
              lanes' shapes (spec_k 4: eight verify windows of q_len 1..5
              at contexts about 1700, W = 5, and seven beside a 256-token
              chunk, W = 256; a window across a block edge and one across
              the 512-key split) over f32, bf16 and int8 pools, against
              the plain and the split versions; #5 at the draft model's
              prefill (one row of buckets 16, 32 and 64, left padding
              masked, f32) and at the one-shot forwards of a TinyLlama
              lane (/infer: 32 rows of 128, causal; /score: 8 rows
              right-padded in 128; f32, 1e-5); the
              flash backward (#6 dq, #7 dk and dv) at
              tests/test_flash_backward.py's shapes, its window case and
              the train phase's shape in f32 (1e-4 of the gradient's
              largest magnitude; also the
              FlashAttention autograd Function as a whole) and at TinyLlama
              prefill rows in bf16 (2e-2), each bit-identical over two runs;
              mlp, resnet50 and resnet50-v1 at 224 x 224 x 3 on the card
              against the CPU on the same weights, in f32 (1e-4 of the
              largest logit) and in the served bf16 with cuDNN's TF32 on
              and off (1e-2), each model's bucket-1 engine output
              bit-identical over two runs in f32 and bf16;
              then a small llama (f32, TF32 off) served on the card through
              a mixed, a two-path, two int8 and a dense lane, and a small
              mistral (sliding window) through a dense lane, agrees token
              for token with the same weights served on the CPU through the
              plain versions; so do three speculative lanes of the small
              llama (spec_k 4: mixed, two-path over the int8 pool, and
              mixed with a draft model), whose streams also equal the
              card's plain lane of their mode; three training steps of the small llama on
              the card give the CPU's losses (f32 1e-4 relative; bf16
              compute 2e-2); the train
              command trains it with --out, --resume continues the step
              count, and the port's worker serving <out>/params gives the
              in-process generator's greedy tokens;
4. server   — first two resnet50 /infer lanes, the JAX worker's default
              configuration (224 x 224 x 3, bf16, 32-row batches, random
              weights from seed 0): the unified lane (single-tick rows of
              the continuous scheduler) and the batch lane
              (--no-unified-stateless), each answering a burst of 16
              concurrent distinct requests, 16 repeats (cached), 8
              identical new requests (coalesced into fewer dispatched
              rows) and the reference's 3-float payload, every answer
              equal to the lane's engine alone (2e-2 of the largest
              logit), the stateless counters balanced and /health's
              batch_processor counting the dispatches; a single request
              bit-identical on both lanes. Then
              the port's worker over HTTP on localhost serving
              TinyLlama-1.1B's width at cut depth (4 of its 22 layers,
              CUT_LLAMA; random weights from seed 0, bf16,
              shared by every lane, 256-token prefill chunks) in five lanes,
              each driven with the launch counts set to 0 just before it
              and read just after: over 16-token KV blocks, mixed stepping
              over the bf16 pool (the ragged kernel), two-path with 16-step
              decode chunks (the decode kernel), mixed over the int8 pool
              (the int8 ragged kernel) and two-path over the int8 pool (the
              int8 decode kernel, which runs the decode kernel's split and
              merge kernels over int8 rows and scales); each answers a
              burst of concurrent /generate requests and one
              /generate/stream (16 new tokens each, as on the gateway
              phase's lanes), a shared-prefix
              request and a greedy repeat: every request completes, the
              repeat is token-identical, ticks == dispatches (mixed) or
              chunks > 0 (two-path), no block leaks once idle. The fifth,
              the worker's default lane (dense cache, 16-step chunks, a
              64 MB prefix cache), answers six prompts of at most 256 tokens
              (one flash prefill each), a 600-token prompt (prefill windows,
              no flash), an exact repeat (a prefix-cache hit, no flash), a
              greedy repeat and one stream, and beside the burst five
              /infer token-id payloads and four /score requests (one flash
              forward of 4 layers per one-shot dispatch): flash launches
              == 4 x (the one-shot dispatches + the monolithic prefills
              that missed the cache). Then three
              speculative lanes (spec_k 4): spec-mixed-bf16 (the n-gram
              drafter, mixed, bf16 pool), spec-two-path-int8 (n-gram,
              two-path, int8 pool) and spec-model-gpt2 (gpt2's 12 layers
              at d 768 with its auto draft distilgpt2, both random from
              seeds 0 and 1, mixed, bf16 pool; 8 new tokens a request,
              16 on the others), each answering the burst, the stream, a
              shared-prefix request, a repetitive prompt and its greedy
              repeat: spec ticks == dispatches, the ragged
              kernel's launches == dispatches x layers, the flash
              forward's == draft dispatches x the draft's 6 layers (zero
              on the n-gram lanes), no decode read (#2, #3) launched.
              In every lane the lane's kernels, and no plain version,
              served its attention;
5. gateway  — the port's gateway (serve_gateway) in front of port
              workers on the card: three resnet50 workers (the default
              WorkerConfig, bf16) under the reference benchmark's load
              (2000 /infer from 50 closed-loop threads over 10 distinct
              3-float inputs): req/s, p50/p99, each worker's cache hit
              rate, the load split equal to the ring's over the
              request_ids, no request failed, and 200 cache hits one at a
              time direct to their owner and through the gateway (the
              hop's p50/p99); then two mixed-bf16 lanes of TinyLlama's
              width at cut depth (one weight tree) behind a gateway with a 1 s
              breaker timeout: 16 streams, 8 /generate and 8 decoder
              /infer at once, each answered by its request_id's ring
              owner, and four streams one at a time token-identical
              through the gateway and direct; faults: a lane's server
              stopped (its requests fail over, its breaker OPEN after 5
              failures), served again on its port (HALF_OPEN, then CLOSED
              after two successes), drained (failover with no breaker
              penalty, counted in its /health admission.shed_draining),
              an expired deadline (503 deadline_exceeded, no worker counts
              it), and a resnet50 /infer miss whose budget is below every
              lane's warm service-time estimate (503 overloaded, shed by
              each lane); and the gateway command as a process (one
              /infer, one /generate, SIGTERM). The launch counts are set
              to 0 before the generation lanes start and read at the
              phase's end: the ragged kernel's == 4 x the lanes' mixed
              ticks, the flash forward's == 4 x their one-shot
              dispatches, no other kernel, no plain call;
6. kvtier   — the host KV tier and the KV chain wire format at TinyLlama
              geometry (bf16 weights from seed 0, 16-token blocks): a pool
              on the card with a 64-block pinned host tier, where a
              64-block prefix of random data is demoted and promoted
              (bf16, and int8 with its scales) and its chain exported into
              a second pool, each held with torch.equal, the copies timed
              beside their PCIe bound and one 256 MiB pinned copy's rate,
              the swap-in beside the device time of recomputing the
              prefix's prefill (four W = 256 ticks); at cut depth, a
              mixed-bf16 and a
              two-path-int8 worker with --kv-blocks 192 --kv-host-blocks
              512, each beside an untiered control (the auto pool), served
              six 1024-token prompts and then each with a new 32-token
              tail, one at a time: streams, prefix-hit and prefilled
              tokens equal to the control's, swap_ins > 0 with no
              deferral, no host eviction and no leaked scale slot, the
              lane's kernel launched 4 x its ticks; then for each mode two
              workers A and B: a greedy 64-token stream of a 1024-token
              prompt on A, exported by /admin/migrate after >= 16 tokens
              and continued on B by migrate_import, token-identical to the
              same request's uninterrupted run alone on A, no token
              prefilled on B, imported_chain_tokens == 16 x the chain's
              blocks, no block leaked;
7. refmodels — the reference's other /infer deployments (BASELINE.json
              configs 1-4), random weights from seed 0 at full width:
              #5 at the bert lane's shape (B 32 x S 384 x 12 heads x D 64,
              non-causal, varied right padding and an all-pad row) against
              its plain version in f32 (as the lane launches it) and bf16
              (out and lse; the all-pad row 0 and lse -inf; bit-identical
              over two runs), timed beside its bound, the plain version
              and SDPA over the same mask; a bert worker (bf16, 32-row
              one-shot ticks) answering 40 distinct token-id payloads of
              1-384 tokens and the 3-float all-pad payload at once and 8
              repeats from the cache, with the launch counts set to 0
              before and read after: #5 launched 12 x the dispatches, no
              other kernel, no plain call, every answer as close to the
              same forward with the plain attention as BERT_BF16_FACTOR x
              bf16's own distance from f32, the same burst through a
              worker in f32 within BERT_F32_TOL of the plain f32 forward,
              the forward's times at B 1 and 32; a yolov8n worker (bf16,
              shape buckets 320, 480, 640) answering 3 distinct 16-float
              requests, one a shape: n_anchors x 144 values
              each, within YOLO_TOL of the plain f32 forward of each
              canvas, the same burst through a worker in f32 within
              YOLO_F32_TOL of it, the forward at every bucket at B 1
              and 8, its times at 640, and one 640 answer's JSON
              encoding; a
              ResNet-50 v2 ONNX graph (seeded, in resnet50-v2-7.onnx's
              shape) served by `worker_node <port> worker_1 <file>.onnx` as
              a process, answering the 3-float payload and a full image
              within ONNX_TOL of the port's executor on the CPU in f32, and
              its forward's times; two gpt2 HF-layout checkpoints at 4 of
              its 12 layers (d 768, vocab 50257) of seeded tensors
              (config.json + model.safetensors; config.json +
              pytorch_model.bin), the first served by `worker_node` as a
              process, /admin/reload to the second (timed): the cache
              empties, /infer changes, and a greedy stream equals a fresh
              worker's on the second checkpoint;
8. train    — after the server phase has stopped its lanes: full-width
              training of TinyLlama-1.1B geometry (22 layers, f32 weights
              from seed 0, AdamW) on the train command's synthetic batch,
              4 steps at B 4 x S 1024 with an f32 forward (lr 1e-4; the
              loss must fall), 3 at the same shape in make_train_step's
              default bf16 compute (the loss must fall) and 2 at
              B 8 x S 2048 with remat in f32, the launch counts
              set to 0 before the phase and read after every step: 22 flash
              forwards (44 with remat) and 22 launches of each backward
              kernel per step, no plain call; per step wall, host issue and
              device busy time, the idle share, the flash kernels' shares
              (and the device time of their f32 and bf16 variants),
              tokens/s and peak memory;
9. numbers  — each kernel's time at the main path's shapes (with events
              and as device time) beside its bound, the plain version's
              time and the library's (scaled_dot_product_attention; for the
              paged reads over K/V gathered dense, and dequantized for
              int8, beforehand; for the flash forward over q, k, v
              transposed beforehand, its backend forced, in f32 at the
              dense prefill's and the train phase's shapes and in bf16 at
              prefill rows, and for the
              backward the device time of its autograd backward, beside
              which #6 and #7 are also timed as device time, both robust to
              the profiler dropping a session's first events; no copy is
              timed, and the port never calls the library); one full-width
              forward per step the lanes run (the two-path prefill window
              and the dense prefill at 256 and 2048 tokens included), the
              host's time to issue it, the card's busy time in it
              (torch.profiler) and the attention kernel's share (22
              launches at its isolated device time; for the dense prefill
              the f32 flash variant, which that path launches). The paged
              reads' device times are also given per kernel (split and
              merge). #1 and #4 also at the spec ticks' shapes, the spec
              ticks' forwards among the forward rows, and the spec tick's
              accept/emit loop apart from its forward (host issue time,
              and time to the host copy). #5 also at the decoder /infer
              shape (B 32 x S 128, f32) and a full /score bucket (B 8 x
              S 128, f32); the resnet50 bf16 forward at
              buckets 1, 8 and 32 by the forward rows' harness
              (images/s beside it), at cuDNN's default TF32 setting as
              served;
10. overload — last, so that its processes and profiler sessions
              come after every earlier timing: overload control and
              crash-tolerant serving at TinyLlama's width at cut depth
              (CUT_LLAMA, random weights from seed 0; the tick readings
              at all 22 layers), each part with the
              launch counts set to 0 before and read after: a mixed-bf16
              spec_k 4 worker with --priority-admission --adaptive-depth
              --brownout (max_queue_depth 8, the AIMD limit's start; a
              brownout evaluation every 0.1 s) opens held streams in a
              ladder against the tier caps (background sheds at depth 5,
              batch at 6, interactive at 8) and fires a burst of each tier
              beyond the limit: every shed a 503 overloaded with
              Retry-After, shed_overloaded == the causes' sum, the
              brownout climbing past stage 2 and restoring in reverse once
              the streams end (escalations == restores), the spec
              proposals flat while suspended and moving again after, the
              AIMD limit moved by the 8 requests that follow, the prefill
              tokens of a tick <= max(1, budget_frac x the budget) (the
              widest at 1.0 above the widest at 0.5), the ragged kernel's
              launches == the layers x the spec ticks (== the mixed
              ticks); a
              mixed-bf16 worker with --kv-blocks 160 --kv-host-blocks 256
              whose demoted prompt promotes nothing under swap-in
              deferral and swaps in once released; the mixed tick's
              forward at budget_frac 1.0 and 0.25 (wall, host issue,
              device busy, #1 alone) and #5 at a /score row; a mixed f32
              spec_k 4 worker (TF32 off) whose greedy streams are
              token-identical with spec running and suspended; then two
              f32 mixed workers, P (the worker command as a process) and
              L (in process), behind the gateway command as a process
              with --failover-streams --health-probe-interval 0.2
              --overload-control --tenant-rate 5: tenant A's burst of 20
              sheds 503 with Retry-After while tenant B is untouched; P
              stopped (SIGSTOP): a hedged /score through an in-process
              gateway with hedge_enabled answered by L (hedge_wins, #5
              launched on L), P ejected by the prober within 3 x (0.2 s
              + the 5 s probe timeout) + 0.2 s with no breaker failure,
              and restored after SIGCONT; two streams owned by P (greedy
              and seeded sampled), P killed (SIGKILL) after 8 tokens of
              each: both resume once on L, token for token the unbroken
              runs, the kill to the first resumed token timed, the dead P
              ejected within 0.8 s; on L the ragged kernel's launches ==
              the layers x its mixed ticks and the flash forward's == the
              layers x its one-shot dispatches, no plain call; its #1 and #5 readings
              (device time, bound, SDPA's device time) at the 249- and
              57-token ticks and the /score row;
11. observe — last: spans, /metrics, the flight recorder and the
              tick-bounded profile at TinyLlama's width at cut depth
              (CUT_LLAMA, random weights from seed 0); the lanes' processes
              load while the in-process parts run. A mixed-bf16 spec_k 4
              lane as a worker_node
              process of its own (``--serve-worker-node``, which writes
              its launch counts when it exits) with --flight-recorder 256
              and a --profile-dir: a burst of 16 streams and 8 /score, then
              each stream has one generate_stream root and its queue_wait,
              radix_lookup, kv_alloc and decode spans, each /score its
              admission, queue_wait, batch_form and device_compute,
              mixed_step == spec_verify spans == the ticks, the /metrics
              exposition parses with tpu_engine_ttft_seconds_count == the
              streams and the tpu_engine_spec_* counters == stats(); POST
              /admin/profile {"ticks": 8} during a second burst (8 streams
              of 112 tokens): the capture's Chrome trace holds 4 x 8
              launches of each of #1's split and merge kernels (up to
              three captures while one keeps no device event, then a
              failure), the kernels' device time a tick beside the tick
              spans' walls; POST /admin/timeline {"dump": "smoke"}: the
              dump exists and its records have walls > 0; at exit #1's
              launches == 4 x the ticks and #5's == 4 x the one-shot
              dispatches, no plain call. A two-path-bf16 lane (in process,
              counts from 0): no tick span (the JAX two-path lane records
              none), each /generate's stage spans, #2 == 4 x 16 x the
              chunks. A resnet50 /infer burst of 64 distinct misses: the
              p50 and p99 of cache_lookup, queue_wait, batch_form,
              device_compute and serialize. The mixed W = 1 tick's wall
              (the flight recorder's eight-decode-row ticks) with
              trace_capacity 2048 and 0, and one record()'s host time.
              Two f32 workers (P the worker command as a process, L in
              process) behind the gateway command with --trace-stitch and
              two SLO objectives: P killed (SIGKILL) while a greedy stream
              it owns runs; the stream resumes on L, the gateway's
              /admin/trace/<rid> has zero orphans and the admit and
              resume hops, /admin/slo answers, /metrics has
              tpu_engine_slo_*.
12. handoff — after observe: the handoff family. Three worker_node
              processes of TinyLlama-1.1B's width at cut depth (bf16, random
              weights from seed 0, mixed stepping, 16-token blocks,
              256-token chunks, --prefix-fetch): P of --role prefill, D1
              and D2 of --role decode, behind the port's gateway
              (serve_gateway, in this process) with disagg,
              migrate_streams, prefix_affinity and prefix_directory on.
              A burst of 16 greedy streams (8 sharing a 512-token prefix,
              8 distinct, prompts of 520-600 tokens, 32 new tokens): all
              16 spliced from P to a decode lane with no fallback, the
              decode lanes' prefilled tokens unmoved, P's decode tokens
              0, the handoff counters equal to the kv_handoff spans.
              Three streams one at a time through the handoff equal the
              same requests sent straight to P. One handoff by hand
              (/generate/stream with handoff, /admin/migrate with
              wait_prefill, migrate_import on D1): the chain's wire bytes,
              export and import times. A migrate-mode drain: a 128-token
              stream on D1 behind a gateway of D1 and D2 with
              migrate_streams; remove_worker(D1, drain=True) after 16
              tokens splices it onto D2, equal to the undrained run, with
              nothing replayed; D1 goes back. POST /admin/role flips D2
              to prefill (a stream then decodes on D1) and back:
              role_flips 2. A gateway with the prefix directory alone: A
              (a new 512-token prefix + a suffix) on D1, then A' with an
              id the ring sends to D2, which fetches the prefix from D1,
              prefills only its suffix, and equals A' on D1; with prefix
              affinity on, 8 requests of the prefix land on one lane.
              Each lane ends idle with no leaked block and #1 launches ==
              4 x its ticks (the process's counts, written at its exit).
              In this process, two int8 mixed generators hand a row off
              with export_row(wait_prefill=True) and submit_import: the
              stream equals the colocated int8 run (sent twice, the
              second resuming from the radix as the handoff's prefill
              does), the adopted chain's bytes equal the exported ones,
              #4 launches == 4 x ticks. Readings: TTFT, the handoff gap,
              the chain's bytes and times, the prefix fetch against the
              local prefill, the drain's splice gap.
11. recurrent — the state_slab family (mamba2: 24 layers, d_model 768,
              d_inner 1536, 24 heads of 64, d_state 64, d_conv 4, vocab
              50257; f32) and its window-scan kernel (#8,
              csrc/ssd_scan.cu), which replaces no Pallas kernel (JAX
              runs the recurrence as XLA's lax.scan). #8 against its plain
              version (the loop over the slots) at mamba2's shapes: B 8 x
              W 1 (a decode tick), B 1 x W 256 (a prefill window) and a
              mixed B 8 x W 256 batch with ragged qlen (1e-4 of
              max(1, the plain version's largest magnitude), on y and the
              states), bit-identical over two runs, partition-invariant
              (one W-slot launch against W one-slot launches, bit-equal),
              qlen-0 rows and the null row untouched; ssd-small-test
              served on the card through a mixed and a two-path lane
              gives the CPU's greedy streams (plain versions there); then
              mamba2 at full width as a worker_node process (mixed,
              256-token budget, 8 slots): 16 /generate streams (prompts of
              100 to 600 tokens, 32 new) and 8 /infer rows of 128 at once,
              every answer complete and finite, ticks == dispatches, no
              leaked slab row, #8 launches == 24 x window scans and no
              plain call; in this process at full width, a two-path lane
              migrates one live row to a second one, and a mixed prefill
              lane hands one row off to a mixed decode lane (0 prefill
              tokens there), each stream token-identical to the unmoved
              one under the same batch composition. Readings: #8's device
              ms against its bound, a B 8 decode tick's wall, host issue
              and device busy, a 512-token prompt's TTFT with #8 and with
              the plain loop, the slab row's bytes.
13. moe    — last: the mixture-of-experts family and weight-only int8
              (no kernel of their own: plain products). gpt2-moe at full
              width and depth (12 layers, d_model 768, 12 heads of 64,
              d_ff 3072, 8 experts, top-2, capacity factor 1.25, vocab
              50257; random weights from seed 0) as a worker_node process
              (bf16, mixed, 16-token blocks, 256-token budget, 8 slots):
              16 /generate/stream streams (prompts of 100 to 600 tokens,
              32 new) and 8 /score rows of 128 at once, every answer
              complete; four greedy streams sent alone three times, the
              second and third passes token-identical (the first fills
              the prefix cache, so those two tick the same compositions);
              ticks == dispatches, 0 leaked blocks, #1 launches == 12 x
              ticks and #5 launches == 12 x one-shot dispatches (the
              process's counts), no plain call. In this process, a
              WorkerNode with quantize="int8" over int8 KV blocks (mixed):
              8 streams, #4 launches == 12 x ticks, 0 leaked blocks; its
              int8 trees, quantized on the card, bit-equal to
              quantize_params on the CPU from the same f32 draw, the
              router gates f32. A 2 x 128 f32 forward at full width
              through the int8 tree against its dequantized tree and on
              the card against the CPU: within 1e-4 of max(1, |ref|),
              the same routing (a difference fails with its layer,
              tokens and router margins). Readings: the param bytes of
              the f32, bf16 and int8 trees, moe_apply alone at a mixed
              tick's 8 x 256 tokens (640 slots an expert: device and host
              issue ms, the share of dropped (token, choice) pairs), a B
              8 decode tick of the bf16 and of the int8 forward (wall,
              host issue, device busy and idle).
14. batch  — last: the batch lanes (gen_scheduler batch and
              speculative; no kernel of their own: #5 at every prefill
              and /score forward, plain decode steps and verify windows).
              llama-small-test in f32 (TF32 off) on the card against the
              same weights on the CPU: the Generator with and without
              fused (one decode loop serves both; greedy, seeded at
              temperature 0.8 with top_p 0.9, a repetition penalty of 1.2
              with stop tokens), beam width 4, score (1e-4), the
              SpeculativeGenerator (k 3) with a self-draft and a random
              draft, token for token; on the card fused == chunked and
              speculative greedy == plain greedy. #5 at the batch
              prefill: B 8 with 3 live rows left-padded at 512 (5 rows
              fully masked), 12 heads of 64, f32 (1e-5) and bf16 (2e-2)
              on out and lse, the masked rows 0 and lse -inf, no NaN,
              bit-identical over two runs, timed beside its plain
              version, scaled_dot_product_attention with the same mask
              and the bound. gpt2 at full width and
              depth (random weights from seed 0, bf16) as a worker_node
              process with --gen-scheduler batch (8 rows a group, 200 ms
              window): 8 /generate (prompts of 100-480 tokens, 32 new,
              half greedy, half seeded at 0.8, two with stop tokens and a
              penalty of 1.2), 4 streams, 4 beam-4 requests of 16 tokens
              and 8 /score rows of 128 at once; then a 600-token prompt
              alone (exactly 1 token: the 1024 bucket's clamp), a group
              of four greedy requests twice (identical), a stream against
              its blocking answer, beam_width 9 (a 400), /health's
              generator block with JAX's Generator.stats() keys, and the
              process's counts: #5 only, a multiple of 12, no plain call.
              In this process on the same weights: fused == chunked over
              8 prompts greedy and seeded, #5 launches == 12 x the
              prefill and score forwards. The speculative lane as two
              f32 worker_node processes (--gen-spec-k 4): one serving
              gpt2 from a checkpoint of the port's format with the same
              checkpoint as its draft (--gen-draft-model gpt2
              --gen-draft-path), whose tokens per live round must pass
              0.9 x k, and one with the auto draft (distilgpt2, random),
              whose accept ratio is printed; each answers 8 greedy
              requests (32 new), reads lane="batch" in /health and
              /metrics and refuses top_p with a 400, and its streams are
              held against an in-process f32 Generator: a stream may part
              only at a top-2 margin of at most 1e-3. Readings: a B 8
              decode step (wall, host issue, device busy and idle), the
              decode loop's done-flag reads (8 x 64 tokens reading it
              every 16 steps against every 64), one beam-4 step and the
              bytes of its cache gather, one speculative round.
15. combined — after batch: the combined serve command (in-process lanes behind
              the gateway and the C++ front, its library built from
              tpu_engine_torch/native by g++) as a process of its own.
              First resnet50 at full width (bf16, 224 x 224 x 3, --lanes
              2 --native-front on --breaker-timeout 1): 200 /infer
              requests from 8 client threads over 10 distinct inputs with
              fresh request ids (the reference benchmark's load): the
              C++ front answers at least 180 of them from the lanes'
              native caches (/health's requests less the gateway's),
              /health counts 200 requests and cache_hits equal to the
              cached answers, every hit's output_data is byte for byte
              its (input, lane)'s miss fragment; then
              /admin/fault fails worker_1: its requests fail over to
              worker_2 and its /health counters stand still, and after
              heal (and the breaker's timeout) its hits are C++ hits
              again. Then TinyLlama at full width and depth (llama: 22
              layers, bf16, random weights from seed 0) on two mixed
              lanes split prefill/decode with --disagg: 8 streams
              (prompts 64-512, 32 new tokens) each handed off in
              process to the decode lane with no token prefilled there,
              8 /score rows, 4 greedy streams sent alone twice
              token-identical; the process's counts: #1 == 22 x the
              lanes' mixed ticks, #5 == 22 x their one-shot dispatches,
              no other kernel and no plain call.
16. elastic — after combined: the elastic fleet and the stall watchdog,
              in this process: serve_combined over TinyLlama's width at
              cut depth (4 of 22 layers, f32, paged mixed lanes, C++
              front) with
              the controller on (2 to 3 lanes, pressure up 0.30, down
              0.20, ticks of 0.25 s, cooldown 0.5 s, spawn timeout 5 s,
              prober every 0.1 s). Every request first runs on a static
              two-lane fleet of the same seeded weights (the control).
              A burst of 12 streams (4 sampled with seeds) mints
              worker_3 on the static lanes' weight tensors, through its
              /health probe, onto the gateway's and the C++ front's
              rings; one long stream on each lane as the burst drains
              retires a lane through the drain and the live migration
              of its stream. Every stream equals the control token for
              token, no block leaks on any pool, and the memory the card
              holds after the retire is within one lane's KV pool of the
              reading before the spawn. /admin/fleet add of a dead
              address latches spawn-wedged while a stream completes, and
              clear answers cleared; a standby worker served over HTTP
              in this process joins a second gateway through
              StandbyLaneProvider's probe gate and serves a stream. One
              lane's scheduler_stall_s at 1e-9 s and its prefill
              wedged (so no read lands within the tick age's rounding
              of a heartbeat): /health reads
              scheduler_stalled, the prober ejects it, its streams
              complete on the peer, and back at 0 it is restored. Fleet
              counters == fleet spans, /stats carries fleet.lanes,
              pressure and degraded, the C++ ring equals the gateway's
              membership at every step, and #1 == 4 x the mixed ticks
              of every lane, minted, retired and standby alike.
17. tp      — last: tensor-parallel serving, in this process, every rank
              on the one card (cuda:0; one scheduler drives its ranks,
              so no process group is needed). #1-#4 at the ranks' shapes
              of tp 2 and 4 (TinyLlama: 16/2 and 8/1 query/KV heads a
              rank) on every rank's heads against their plain versions
              (bf16 2e-2, int8 2e-4), with rank 0's device time, plain
              time, bound and SDPA's device time. The bf16 mixed tick
              (7 decode rows + a 249-token chunk) and decode tick (8
              rows) at 22 layers at tp 1, 2 and 4: wall, host issue,
              device busy, and each rank's param and pool bytes. A bf16
              tp 2 forward over int8 blocks against tp 1 (mixed #4,
              decode #3): max|diff| / max|tp 1| within 5e-2. TinyLlama
              (llama, 22 layers, random weights from seed 0) lanes, each
              prompt (24, 100, 300 tokens) sent alone, 8 new tokens:
              f32 mixed at tp 1, 2, 4 and f32 two-path at tp 1, 2 give
              token-identical greedy streams across degrees; bf16 mixed
              and two-path lanes over int8 blocks at tp 2; on every lane
              #1 (#2, #3, #4) == tp x 22 x its ticks (two-path: chunks x
              8), no other kernel, no plain call, no block leaked. A
              parked row of a tp 2 lane moves to another tp 2 lane (its
              tokens the destination's own run, 0 prefilled there) and
              the snapshot is refused by a tp 1 lane by name. A
              WorkerNode(tp=2, device="cuda:0") behind its HTTP server
              streams /generate/stream (the in-process tp 2 tokens, #1 ==
              2 x 22 x its ticks), its /health carries topology, and a
              gateway over it and a tp 1 lane reads ring_weights 2 and 1.
18. mesh    — last: mesh-sharded serving and training, every rank on the
              one card (cuda:0). `serve --mesh data=2` without --device
              refuses (one card; JAX's message). resnet50 /infer at 224 x
              224 x 3 under `serve --mesh data=2 --device cuda:0` (bf16)
              and `--mesh model=2,data=2 --device cuda:0` (f32 and bf16)
              behind the C++ front: one lane worker_1, the reference wire
              schema, 8 concurrent images against the single-rank engine
              on the same card and weights (f32 within 1e-4 of the
              largest logit, TF32 off; bf16 within 1e-2, the served
              bound), a repeat answered from the cache (in C++),
              /health healthy. TinyLlama width at 4 layers (f32) under
              `--mesh model=2,data=2`: 8 concurrent /infer rows of 128
              token ids against the single-rank engine (1e-4), #5 ==
              4 x 2 data ranks x the engine's dispatches. `train --mesh
              data=2,model=2 --device cuda:0` at TinyLlama width and 4
              layers, B 4 x S 256, 3 steps in f32 (TF32 off): losses
              within 1e-4 relative of the unsharded train command's on
              the card, #5, #6 and #7 == 4 x 2 a step each (4 a step
              unsharded), no plain call; on llama-small-test --out then
              --resume continues the step count and the unsharded run's
              losses. No speed is claimed: on one card the ranks free
              nothing.
19. seqpar  — last: sequence parallelism, GPipe and expert-parallel MoE,
              every rank on the one card (cuda:0), #5 the attention of
              every path. The ring's hop-merge (one #5 call a hop, the
              hops merged in f32 by their lse) against the plain ring
              (JAX's accumulation step) on the same inputs, f32 within
              1e-5 and bf16 within 2e-2: B 2 x S 32 x H 4 x D 64 causal,
              masked and both over seq=8, B 1 x S 2048 x H 32 causal
              over seq=4; #5 == n(n+1)/2 hops causal, n² otherwise.
              TinyLlama (22 layers, random weights from seed 0) with the
              ring and with Ulysses over seq=4 as every block's
              attention, B 1 x S 2048 and B 2 right-padded through the
              mask, f32 (TF32 off, within 2e-4 of the largest logit)
              and bf16 (2e-2), against the single-rank forward through
              #5, argmax equal where the top-2 margin exceeds the bound;
              #5 == 22 x 10 (ring) and 22 x 4 (Ulysses) a forward.
              GPipe: TinyLlama's 22 blocks (f32) over stage=2, B 8 x S
              256, M 4 and 8, against the plain loop (2e-4); #5 == 22 x
              M. gpt2-moe (12 layers, d 768, 8 experts, top-2, capacity
              1.25) with each block's bank split over expert=4, B 4 x S
              128, f32 (1e-4), bf16 and int8 weights (2e-2), against the
              unsharded forward with the same routing (pairs, slots,
              drops); #5 == 12 a forward. Each path's peak memory beside
              the unsharded run's, and #5's times at the ring's hop shape
              (B 1 x S 512 x H 32). Who: an operator whose context or
              model outgrows one card; on one card the ranks free
              nothing, so no speed or memory saving is claimed.

The last line of standard output is the JSON result; the line before it
the card's name and power limit; the line before that the kernels' JSON
("ms" and "library_ms" there are device times of one call).

    python3 chip_smoke.py --kernel-times [--package-root DIR]

runs only the kernels' device times (#1-#4 and #5 at the main path's
shapes, #6/#7 at the train shape and a bf16 S 2048 row; #3 also at 64-
and 128-key splits; and the bf16 decode read's difference from this
checkout's split plain version) through the package under DIR (default:
this checkout), so that two trees (a parent commit unpacked
under build/, and this one) can be timed in turns in one call.

    python3 chip_smoke.py --resnet-times [--package-root DIR]

does the same for the resnet50 bf16 forward at buckets 1, 8 and 32 and
the bf16 resnets' card vs CPU errors, at torch's default TF32 settings.

    python3 chip_smoke.py --phase handoff|observe|overload|recurrent|moe
    python3 chip_smoke.py --phase batch|combined|elastic|tp|mesh|seqpar
    python3 chip_smoke.py --phase server|refmodels|parity|gateway|kvtier

runs the build and that one phase (or several, comma-separated, in
turn), and writes its readings to chiprun_out/phase_<name>.json (no
result lines).

    python3 chip_smoke.py --profiler-probe

counts the device events torch.profiler sessions keep, by the thread
that runs them (one JSON line).
"""

from __future__ import annotations

import contextlib
import faulthandler
import functools
import http.client
import json
import os
import queue
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
# H100 SXM float32 outside the tensor cores: the roof of the port's f32
# products, which run without TF32.
PEAK_F32_FLOPS = 67e12
F32_TOL = 1e-5
# The flash backward, as max|got - ref| / max|ref| per gradient: f32 sums
# in another order (1e-4); bf16 p and ds rounded from f32 values that
# differ in their last bits (2e-2).
BWD_F32_TOL = 1e-4
BF16_TOL = 2e-2
QUANT_TOL = 2e-4
# The bf16 decode read against its split plain version: about one bf16 ulp
# of an output of magnitude 1-2 (the weights round at the same points).
PAGED_SPLIT_BF16_TOL = 8e-3
OUT_DIR = Path("chiprun_out")
# (key, B, S, dtype) of the flash forward's readings: the dense lane's
# prefill (f32, as every main path launches it: q, k, v come out of
# nn.dense as f32) first, for the kernels line, then the train phase's
# shape and the bf16 variant.
FLASH_SHAPES = (("prefill S=256 f32", 1, 256, "float32"),
                ("train B=4 S=1024 f32", 4, 1024, "float32"),
                ("prefill S=2048 f32", 1, 2048, "float32"),
                ("prefill S=256", 1, 256, "bfloat16"),
                ("prefill S=2048", 1, 2048, "bfloat16"),
                ("infer B=32 S=128 f32", 32, 128, "float32"),
                ("score B=8 S=128 f32", 8, 128, "float32"))
MAX_NEW = 16
# A spec_k = 4 tick's verify windows at the main path's geometry: q_len
# 1..5 at contexts about 1700, row 1 across a 16-token block edge, row 3
# across the 512-key split at 1536.
SPEC_K = 4
SPEC_QLEN = np.array([5, 5, 3, 5, 1, 5, 2, 5], np.int32)
SPEC_POS0 = np.array([1700, 1694, 1710, 1533, 1699, 1721, 1730, 1689],
                     np.int32)
# The TPU kernel each CUDA kernel replaces, and the lane whose path
# launches it.
KERNELS = {
    "ragged_paged_attention": dict(
        source="tpu_engine_torch/csrc/ragged_paged_attention.cu",
        replaces="tpu_engine/ops/paged_attention.py:226", lane="mixed-bf16"),
    "paged_attention": dict(
        source="tpu_engine_torch/csrc/paged_attention.cu",
        replaces="tpu_engine/ops/paged_attention.py:83",
        lane="two-path-bf16"),
    "quant_paged_attention": dict(
        source="tpu_engine_torch/csrc/paged_attention.cu",
        replaces="tpu_engine/ops/paged_attention.py:427",
        lane="two-path-int8"),
    "quant_ragged_paged_attention": dict(
        source="tpu_engine_torch/csrc/quant_ragged_paged_attention.cu",
        replaces="tpu_engine/ops/paged_attention.py:516",
        lane="mixed-int8"),
    "flash_attention": dict(
        source="tpu_engine_torch/csrc/flash_attention.cu",
        replaces="tpu_engine/ops/flash.py:53", lane="dense-bf16"),
    "flash_attention_bwd_dq": dict(
        source="tpu_engine_torch/csrc/flash_attention_bwd.cu",
        replaces="tpu_engine/ops/flash.py:208", lane="train"),
    "flash_attention_bwd_dkv": dict(
        source="tpu_engine_torch/csrc/flash_attention_bwd.cu",
        replaces="tpu_engine/ops/flash.py:255", lane="train"),
}
# The recurrent family's kernel: it replaces no Pallas kernel (the JAX
# package runs the recurrence as XLA's lax.scan in ssd_window_scan), and
# its lane is the recurrent phase's.
RECURRENT_KERNELS = {
    "ssd_scan": dict(
        source="tpu_engine_torch/csrc/ssd_scan.cu",
        replaces="tpu_engine/models/ssd.py:218 (no Pallas kernel: the "
                 "lax.scan of ssd_window_scan)", lane="recurrent"),
}
# The TinyLlama lanes of the server, gateway, kvtier, overload, observe,
# handoff and elastic phases run at cut depth: 4 of TinyLlama-1.1B's 22
# layers at its full width (d 2048, 32/4 heads, d_ff 5632, vocab 32000),
# so that the whole smoke keeps to half its time. The numbers, train and
# combined phases, the kvtier phase's pool readings and the overload
# phase's tick readings run all 22.
CUT_LLAMA = "llama-cut-depth"
TP_DEGREES = (1, 2, 4)
CUT_LAYERS = 4
PAGED = dict(gen_kv_block_size=16)
LANES = {
    "mixed-bf16": dict(PAGED, gen_mixed_step=True,
                       gen_mixed_token_budget=256),
    "two-path-bf16": dict(PAGED, gen_step_chunk=16),
    "mixed-int8": dict(PAGED, gen_mixed_step=True,
                       gen_mixed_token_budget=256, gen_kv_quantize="int8"),
    "two-path-int8": dict(PAGED, gen_step_chunk=16, gen_kv_quantize="int8"),
    # The worker's defaults: dense cache, 16-step chunks, 64 MB prefix
    # cache.
    "dense-bf16": dict(gen_step_chunk=16),
}
# The speculative lanes (spec_k 4): (model, the ragged kernel they launch,
# worker overrides). The model-drafted lane's draft is the auto draft of
# gpt2, distilgpt2 (6 layers), randomly initialised from seed 1.
# The one-shot /infer lanes: the JAX worker's default configuration
# (resnet50 at 224 x 224 x 3, bf16, 32-row batches, unified stateless
# rows), and the same with the dedicated batch lane.
INFER_LANES = {"infer-resnet50": dict(unified_stateless=True),
               "infer-resnet50-batch-lane": dict(unified_stateless=False)}
INFER_BURST = 16
# mlp and the resnets in f32 on the card (TF32 off) against the CPU, as
# max|card - cpu| / max|cpu|: the same products summed in another order
# by cuDNN and by the CPU's convolutions, through 53 conv layers.
INFER_F32_TOL = 1e-4
# The served bf16 models on the card (cuDNN at its default TF32 setting,
# as a worker process runs it, and with TF32 off) against the CPU's bf16
# forward on the same weights, which the CPU tests hold against JAX: both
# multiply the bf16-rounded operands exactly and sum in f32, so they
# differ where a sum that differs in its last f32 bits rounds the next
# conv's bf16 input the other way. Also the infer lanes' answers against
# the lane's engine alone (another batch, another cuDNN algorithm).
# Readings on the H100: resnet50 2.7e-3, v1 2.5e-3, the lanes' answers
# 3.2e-3 (convs with a bf16 output, as cuDNN's bf16 conv gives, read
# 5.3e-3 and 4.7e-3); a wrong padding or layout differs by > 0.1.
INFER_BF16_TOL = 1e-2
# TinyLlama one-shot rows answered over HTTP (co-batched with others)
# against the same row alone, bf16, as max|diff| / max|alone| (/infer
# logits) and |diff| / max(|alone|, 1e-3) per log-probability (/score).
# Readings on the H100: /infer 8.8e-7, /score 4.9e-3; a wrong row,
# position or mask differs by the order of the values themselves.
ONESHOT_INFER_TOL = 1e-3
ONESHOT_SCORE_TOL = 2e-2
SPEC = dict(PAGED, gen_continuous_spec_k=SPEC_K)
SPEC_LANES = {
    "spec-mixed-bf16": ("llama", "ragged_paged_attention",
                        dict(SPEC, gen_mixed_step=True,
                             gen_mixed_token_budget=256)),
    "spec-two-path-int8": ("llama", "quant_ragged_paged_attention",
                           dict(SPEC, gen_step_chunk=16,
                                gen_kv_quantize="int8")),
    "spec-model-gpt2": ("gpt2", "ragged_paged_attention",
                        dict(SPEC, gen_mixed_step=True,
                             gen_mixed_token_budget=256,
                             gen_spec_draft="model")),
}
# New tokens a request on a spec lane other than MAX_NEW: the model-drafted
# lane's draft forwards make its ticks the slowest (cut from 16 for the
# smoke's time before the seqpar phase).
SPEC_LANE_NEW = {"spec-model-gpt2": 8}


def wrapper(name: str):
    """The counted wrapper that launches kernel ``name``."""
    from tpu_engine_torch.ops import flash, paged_attention, ssd

    if name == "ssd_scan":
        return ssd.ssd_scan
    if name == "flash_attention":
        return flash.flash_attention_fwd
    if name.startswith("flash_attention_bwd"):
        return getattr(flash, name)
    return getattr(paged_attention, name)


def launch_counts() -> dict:
    return {k: (wrapper(k).launches, wrapper(k).plain_calls)
            for k in (*KERNELS, *RECURRENT_KERNELS)}


# Every thread's stack goes to stderr if the whole run is still going
# this long after it started (a whole run must end within 1200 s).
SMOKE_STACKS_AFTER_S = 1000


class SmokeFailure(RuntimeError):
    pass


_CHILDREN = []


def popen(*args, **kwargs):
    """subprocess.Popen, remembered so that ``kill_children`` can end any
    process a failed phase left running."""
    proc = subprocess.Popen(*args, **kwargs)
    _CHILDREN.append(proc)
    return proc


def kill_children() -> None:
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def lap_timer(walls: dict):
    """A function that records, under each name it is given, the seconds
    since its previous call (or since it was made)."""
    t0 = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        walls[name] = now - t0[0]
        t0[0] = now
    return lap


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- kernel inputs at the main path's shapes ----------------------------------

def main_path_inputs(torch, dev, decode_only: bool, int8: bool = False,
                     seed: int = 1, spec: bool = False, pool_dtype=None):
    """The batch a TinyLlama step hands the kernels: 8 rows, 32 query / 4
    KV heads, D 64, 16-token blocks, tables 128 wide (max_seq 2048). Mixed
    (W = 256): seven decode rows at contexts up to 2047 and one 256-token
    chunk at pos0 1700; decode only: eight q_len-1 rows. With ``spec``, a
    spec_k = 4 tick: the decode rows are verify windows of q_len 1..5 at
    contexts about 1700 (SPEC_QLEN, SPEC_POS0: one across a 16-token block
    edge, one across the 512-key split at 1536), W = 5 decode only, or
    seven windows beside the 256-token chunk at W = 256. A bf16 pool
    (``pool_dtype`` another), or the int8 pool and scales the port's
    quantize_kv makes of the same f32 values. Returns (q, k, v, [k_scale,
    v_scale,] tables, pos0, qlen)."""
    from tpu_engine_torch.ops.quant import quantize_kv

    rng = np.random.default_rng(seed)
    b, h, h_kv, d, bs, nb = 8, 32, 4, 64, 16, 128
    w = (SPEC_K + 1 if spec else 1) if decode_only else 256
    n_pool = b * nb + 1
    q = torch.from_numpy(rng.standard_normal((b, w, h, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((n_pool, bs, h_kv, d),
                                             np.float32)).to(dev)
    v = torch.from_numpy(rng.standard_normal((n_pool, bs, h_kv, d),
                                             np.float32)).to(dev)
    tables = (1 + rng.permutation(n_pool - 1)[:b * nb]).reshape(b, nb)
    pos0 = np.array([100, 500, 1000, 2046, 17, 1500, 0, 1700], np.int32)
    qlen = np.ones((b,), np.int32)
    if spec:
        pos0, qlen = SPEC_POS0.copy(), SPEC_QLEN.copy()
    if not decode_only:
        qlen[7], pos0[7] = 256, 1700
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        pools = (k, v, ks, vs)
    else:
        dt = pool_dtype or torch.bfloat16
        pools = (k.to(dt), v.to(dt))
    return (q.to(dev), *pools,
            torch.from_numpy(tables.astype(np.int32)).to(dev),
            torch.from_numpy(pos0).to(dev), torch.from_numpy(qlen).to(dev))


def decode_args(inp):
    """Decode-only ragged inputs as the decode read's (q, pools...,
    tables, pos): the W = 1 rows' pos0 is their pos."""
    return inp[:-1]


def bound_ms(q, k_pool, tables, pos0, qlen, out_item: int,
             scale_bytes: int = 0) -> tuple:
    """Least time the card could take for this call: the larger of the
    bytes the function must move (valid query slots read in f32, the K/V
    blocks each row's queries reach read once, with ``scale_bytes`` of
    scales per (slot, kv-head) for each of K and V, valid output slots
    written) over 3.35 TB/s, and its multiply-adds (QK and PV, 4*D flops
    per (query head, key) pair attended) over the bf16 tensor-core rate."""
    _, _, h, d = q.shape
    bs, h_kv = k_pool.shape[1], k_pool.shape[2]
    p0 = pos0.cpu().numpy().astype(np.int64)
    ql = qlen.cpu().numpy().astype(np.int64)
    live = ql > 0
    blocks = np.where(live, (p0 + ql - 1) // bs + 1, 0).sum()
    kv_bytes = blocks * 2 * bs * h_kv * (d * k_pool.element_size()
                                         + scale_bytes)
    io_bytes = ql.sum() * h * d * (q.element_size() + out_item)
    meta_bytes = tables.numel() * 4 + 2 * pos0.numel() * 4
    pairs = sum(int(ql[r] * (p0[r] + 1) + ql[r] * (ql[r] - 1) // 2)
                for r in range(len(ql)))
    flops = pairs * h * 4 * d
    t_bytes = (kv_bytes + io_bytes + meta_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of fn() with a cold L2: a 64 MB write between
    launches evicts the 50 MB cache, and CUDA events bracket each call."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def issue_ms(torch, fn, iters: int = 10) -> float:
    """Mean host time to issue fn() (no synchronise inside it): where it
    comes near the device time, the card waits on the host."""
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / iters * 1e3


def device_events(torch, prof) -> list:
    """(name, us) of each device-side event (kernel, copy, fill) of a
    finished torch.profiler session, read off the session's raw results
    as ``prof.events()`` reads them (synchronous events only, names
    demangled), without building its tree of every host op, which takes
    seconds of host time for a session over a whole forward."""
    from torch.autograd import DeviceType

    return [(torch._C._demangle(e.name()), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and not e.is_async()
            and e.start_thread_id() == e.end_thread_id()]


def busy_ms(torch, fn, iters: int = 3):
    """Mean device-busy time of fn(): the durations of the device-side
    events (kernels, copies, fills) under torch.profiler, summed; host
    ops are left out, since their device time repeats their kernels'.
    Against the wall time of fn() it gives the share of a step the card
    sits idle. The profiler can keep no device event in a session: up to
    three sessions are run; None where none kept one (the reading is
    then "not measured", see ``busy_text``)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(d for _, d in device_events(torch, prof))
        if us > 0:
            return us / iters / 1e3
    log("busy_ms: three profiler sessions kept no device event; the busy "
        "time is not measured")
    return None


def idle_share(busy, ms: float):
    """The share of ms the card sat idle, or None where busy was not
    measured."""
    return None if busy is None else max(0.0, 1 - busy / ms)


def busy_text(busy, idle) -> str:
    if busy is None:
        return "device busy not measured: the profiler kept no device event"
    return f"device busy {busy:.3f} ms, idle {100 * idle:.1f}%"


def device_call_ms(torch, fn, iters: int = 20, by_kernel=None) -> tuple:
    """Device time of one fn() call under torch.profiler, and the number of
    calls whose device events it saw whole. The profiler can drop the first
    events of a session, so a sum over the session would undercount: each
    device event name (kernel, copy, fill) counts its mean duration times
    its occurrences per call (its count over the fewest count of any name),
    summed. A session that saw fewer than half the calls whole (it once
    kept one of 20, and once none) is run again, up to three sessions;
    the reading of the session that saw the most calls is returned; with
    ``by_kernel`` (a dict) also its device time per event name, per call.
    Where no session kept a device event at all (it happened to all three
    sessions of an SDPA call), the time is taken with CUDA events over
    ``iters`` calls issued back to back instead, and the count of calls
    seen is 0: that reading also holds the host's gaps between launches
    where the card outpaces the host."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = defaultdict(list)
        for name, us in device_events(torch, prof):
            by_name[name].append(us)
        if not by_name:  # a session that kept no device event: run again
            continue
        calls = min(len(v) for v in by_name.values())
        per_name = {k: sum(v) / len(v) * round(len(v) / calls) / 1e3
                    for k, v in by_name.items()}
        if best is None or calls > best[1]:
            best = (sum(per_name.values()), calls)
            if by_kernel is not None:
                by_kernel.clear()
                by_kernel.update(per_name)
        if calls >= iters // 2:
            break
    if best is None:
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = (start.elapsed_time(end) / iters, 0)
        log(f"device_call_ms: three profiler sessions kept no device "
            f"event; CUDA events over {iters} calls read {best[0]:.4f} ms")
    return best


def sdpa_yardstick(torch, inp, int8: bool):
    """scaled_dot_product_attention over K/V gathered dense (and, for the
    int8 pool, dequantized to f32) BEFOREHAND, with the causal mask of
    the paged read: the library's time for the same function (the gather
    is outside the timed call)."""
    import torch.nn.functional as F

    from tpu_engine_torch.ops.quant import dequantize_kv

    q, tables, pos0 = inp[0], inp[-3], inp[-2]
    b, w, h, d = q.shape
    bs, h_kv = inp[1].shape[1], inp[1].shape[2]
    nb = tables.shape[1]
    idx = tables.long()

    def dense(pool, scale):
        g = pool[idx]
        if int8:
            g = dequantize_kv(g, scale[idx])
        return g.reshape(b, nb * bs, h_kv, d).transpose(1, 2).contiguous()

    kk = dense(inp[1], inp[3] if int8 else None)
    vv = dense(inp[2], inp[4] if int8 else None)
    qq = q.to(kk.dtype).transpose(1, 2).contiguous()
    qpos = pos0.long()[:, None] + torch.arange(w, device=q.device)[None]
    mask = (torch.arange(nb * bs, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None]           # (B, 1, W, S)

    def call():
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                              enable_gqa=True)
    return call


def flash_inputs(torch, dev, s: int, h: int, d: int, pad: int = 0,
                 seed: int = 2, dtype=None, b: int = 1):
    """A prefill's flash call as the dense lane makes it: one row (B 1) of
    unit-normal q, k, v (b, s, h, d), bf16 unless ``dtype`` says otherwise,
    with a left-padding mask whose first ``pad`` columns are padding (None
    for pad 0); ``b`` rows for the train phase's shape."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d),
                                                    np.float32))
               .to(dev, dtype or torch.bfloat16) for _ in range(3))
    mask = None
    if pad:
        m = np.ones((b, s), np.int32)
        m[:, :pad] = 0
        mask = torch.from_numpy(m).to(dev)
    return q, k, v, mask


def flash_bound_ms(q, causal: bool = True, mask=None) -> tuple:
    """Least time for a flash forward over (B, S, H, D) inputs: the larger
    of the bytes over 3.35 TB/s and the flops over the card's peak in the
    inputs' type (bf16 tensor cores, or f32 CUDA cores: the port's f32
    products run without TF32). Bytes, in the inputs' dtype: q read once
    for each query row with at least one key to attend (a row with none
    gives 0 and -inf whatever its q holds), out written once for every
    row, k and v read once for each key the (B, S) mask keeps (every key
    without a mask), the f32 lse written, the int32 mask read. Flops: 4*D
    per (query, key) pair the function needs: each query with each key
    the mask keeps, causal ones only up to the query. A padded key adds
    nothing to any output, so its pairs are not counted, whatever the
    kernel itself computes."""
    b, s, h, d = q.shape
    es = q.element_size()
    if mask is None:
        kept = live = b * s
        rows = b * (s * (s + 1) // 2 if causal else s * s)
    else:
        m = (mask != 0).long()
        kept = int(m.sum())
        if causal:
            seen = m.cumsum(1)
            rows, live = int(seen.sum()), int((seen > 0).sum())
        else:
            rows, live = s * kept, s * int((m.sum(1) > 0).sum())
    nbytes = ((live + b * s + 2 * kept) * h * d) * es + b * h * s * 4
    if mask is not None:
        nbytes += mask.numel() * 4
    peak = PEAK_BF16_FLOPS if es == 2 else PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 4 * d * h * rows / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


# -- HTTP client ---------------------------------------------------------------

def post(port: int, path: str, body, timeout: float = 600.0) -> dict:
    """POST ``body`` (a dict, or JSON bytes already serialized); the
    answer must be a 200."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body if isinstance(body, bytes)
                     else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        check(resp.status == 200, f"{path} answered {resp.status}: "
                                  f"{data[:300]!r}")
        return json.loads(data)
    finally:
        conn.close()


def get(port: int, path: str) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        check(resp.status == 200, f"{path} answered {resp.status}")
        return json.loads(data)
    finally:
        conn.close()


def stream(port: int, body: dict) -> tuple:
    """POST /generate/stream; returns (streamed tokens, terminal event,
    seconds to the first token event)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    ttft = None
    toks, final = [], None
    try:
        conn.request("POST", "/generate/stream", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        check(resp.status == 200, f"stream answered {resp.status}")
        buf = b""
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                frame, buf = buf.split(b"\n\n", 1)
                ev = json.loads(frame[len(b"data: "):])
                if ev.get("done"):
                    final = ev
                else:
                    if ttft is None:
                        ttft = time.perf_counter() - t0
                    toks.extend(ev["tokens"])
    finally:
        conn.close()
    return toks, final, ttft


# -- phases --------------------------------------------------------------------

def _valid_err(torch, out, ref, qlen):
    valid = (torch.arange(out.shape[1], device=out.device)[None]
             < qlen[:, None])[:, :, None, None]
    return float(((out.float() - ref.float()).abs() * valid).max())


def rows_identical(torch, pa, kernel: str, t, out, shape: str) -> None:
    """A split kernel (#1-#4) gives the same bits over two runs, and
    each row's output run alone (a batch of one; for a ragged read W its
    own qlen) equals its output in the batch bit for bit: a row's split
    plan and arithmetic depend on its own data only."""
    fn = getattr(pa, kernel)
    check(torch.equal(out, fn(*t)), f"{kernel} {shape}: two runs differ")
    if kernel in ("paged_attention", "quant_paged_attention"):
        q, pools, (tables, pos) = t[0], t[1:-2], t[-2:]
        for r in range(q.shape[0]):
            alone = fn(q[r:r + 1].contiguous(), *pools, tables[r:r + 1],
                       pos[r:r + 1])
            check(torch.equal(alone[0], out[r]),
                  f"{kernel} {shape}: row {r} alone differs from the batch")
    else:
        q, pools, (tables, pos0, qlen) = t[0], t[1:-3], t[-3:]
        for r, ql in enumerate(qlen.tolist()):
            alone = fn(q[r:r + 1, :max(ql, 1)].contiguous(), *pools,
                       tables[r:r + 1], pos0[r:r + 1], qlen[r:r + 1])
            check(torch.equal(alone[0, :ql], out[r, :ql]),
                  f"{kernel} {shape}: row {r} alone differs from the batch")
    log(f"parity {kernel} {shape}: bit-identical over two runs and row by "
        f"row alone")


def phase_parity(torch, pa) -> dict:
    dev = torch.device("cuda")
    errs = {name: {} for name in KERNELS}

    def record(kernel, case, err, tol, ref_max=None):
        """``ref_max``: the tolerance is ``tol`` times the reference's
        largest magnitude (the backward's gradients), else absolute."""
        bound = tol if ref_max is None else tol * ref_max
        scope = "" if ref_max is None else f" x max|ref| {ref_max:.3e}"
        log(f"parity {kernel} {case}: max_abs_err {err:.3e} (tol "
            f"{tol:g}{scope})")
        check(err <= bound, f"{kernel} parity {case}: {err} > {bound}")
        errs[kernel][case] = err

    def run(kernel, t):
        out = getattr(pa, kernel)(*t)
        ref = getattr(pa, kernel + "_reference")(*t)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out.float()).all()),
              f"{kernel}: non-finite output")
        return out, ref

    on = (lambda arrs: [torch.from_numpy(a).to(dev) for a in arrs])
    # The JAX package's parity-check shapes: f32 pools (int8 for quant).
    for name, q_lens in (("ragged_parity_check", (1, 7, 16, 17)),
                         ("spec_verify_parity_check", (1, 5, 5, 16, 17))):
        t = on(pa.ragged_parity_inputs(q_lens=q_lens))
        out, ref = run("ragged_paged_attention", t)
        record("ragged_paged_attention", f"f32 {name}",
               _valid_err(torch, out, ref, t[-1]), F32_TOL)
    decode_cases = (("parity_check", {}),
                    ("parity_check G4 D16 bs8",
                     dict(n_heads=8, n_kv_heads=2, d_head=16, block_size=8,
                          n_blocks=17, table_len=6)))
    for name, kw in decode_cases:
        out, ref = run("paged_attention", on(pa.parity_inputs(**kw)))
        record("paged_attention", f"f32 {name}",
               float((out - ref).abs().max()), F32_TOL)
    for name, kw in (("quant_parity_check", {}),
                     ("quant_parity_check G4 D64 nb33",
                      dict(n_heads=8, n_kv_heads=2, d_head=64,
                           n_blocks=33, table_len=8))):
        t = on(pa.parity_inputs(quant=True, **kw))
        out, ref = run("quant_paged_attention", t)
        record("quant_paged_attention", f"int8 {name}",
               float((out - ref).abs().max()), QUANT_TOL)
        split = pa.quant_paged_attention_split_reference(*t)
        record("quant_paged_attention", f"int8 {name} against its split "
               "version", float((out - split).abs().max()), F32_TOL)
    for name, kw in (("quant_ragged_parity_check", {}),
                     ("quant_ragged_parity_check G4 D32",
                      dict(q_lens=(1, 3, 16, 17), n_heads=8, n_kv_heads=2,
                           d_head=32, table_len=8))):
        t = on(pa.ragged_parity_inputs(quant=True, **kw))
        out, ref = run("quant_ragged_paged_attention", t)
        record("quant_ragged_paged_attention", f"int8 {name}",
               _valid_err(torch, out, ref, t[-1]), QUANT_TOL)
    # The main path's shapes: bf16 and int8 pools; the split kernels also
    # against the plain repetition of their own split arithmetic.
    for decode_only in (False, True):
        shape = "decode W=1" if decode_only else "mixed W=256"
        t = main_path_inputs(torch, dev, decode_only)
        out, ref = run("ragged_paged_attention", t)
        record("ragged_paged_attention", f"bf16 main path {shape}",
               _valid_err(torch, out, ref, t[-1]), BF16_TOL)
        rows_identical(torch, pa, "ragged_paged_attention", t, out, shape)
        t = main_path_inputs(torch, dev, decode_only, int8=True)
        out, ref = run("quant_ragged_paged_attention", t)
        record("quant_ragged_paged_attention", f"int8 main path {shape}",
               _valid_err(torch, out, ref, t[-1]), QUANT_TOL)
        split = pa.quant_ragged_paged_attention_split_reference(*t)
        record("quant_ragged_paged_attention",
               f"int8 main path {shape} against its split version",
               _valid_err(torch, out, split, t[-1]), QUANT_TOL)
        rows_identical(torch, pa, "quant_ragged_paged_attention", t, out,
                       f"int8 {shape}")
    t = decode_args(main_path_inputs(torch, dev, True))
    out, ref = run("paged_attention", t)
    record("paged_attention", "bf16 main path decode",
           float((out.float() - ref.float()).abs().max()), BF16_TOL)
    split = pa.paged_attention_split_reference(*t)
    record("paged_attention", "bf16 main path decode against its split "
           "version", float((out.float() - split.float()).abs().max()),
           PAGED_SPLIT_BF16_TOL)
    rows_identical(torch, pa, "paged_attention", t, out, "bf16 decode")
    t = decode_args(main_path_inputs(torch, dev, True, True))
    out, ref = run("quant_paged_attention", t)
    record("quant_paged_attention", "int8 main path decode",
           float((out - ref).abs().max()), QUANT_TOL)
    split = pa.quant_paged_attention_split_reference(*t)
    record("quant_paged_attention", "int8 main path decode against its "
           "split version", float((out - split).abs().max()), F32_TOL)
    rows_identical(torch, pa, "quant_paged_attention", t, out, "int8 decode")
    # The speculative lanes' shapes: verify windows alone (W = 5) and
    # beside a 256-token chunk, over f32, bf16 and int8 pools.
    for decode_only in (True, False):
        shape = ("spec verify W=5" if decode_only
                 else "spec mixed W=256")
        for pool, tol in ((torch.float32, F32_TOL),
                          (torch.bfloat16, BF16_TOL)):
            name = str(pool).split(".")[-1]
            t = main_path_inputs(torch, dev, decode_only, spec=True,
                                 pool_dtype=pool)
            out, ref = run("ragged_paged_attention", t)
            record("ragged_paged_attention", f"{name} {shape}",
                   _valid_err(torch, out, ref, t[-1]), tol)
            split = pa.ragged_paged_attention_split_reference(*t)
            record("ragged_paged_attention",
                   f"{name} {shape} against its split version",
                   _valid_err(torch, out, split, t[-1]), tol)
            rows_identical(torch, pa, "ragged_paged_attention", t, out,
                           f"{name} {shape}")
        t = main_path_inputs(torch, dev, decode_only, int8=True, spec=True)
        out, ref = run("quant_ragged_paged_attention", t)
        record("quant_ragged_paged_attention", f"int8 {shape}",
               _valid_err(torch, out, ref, t[-1]), QUANT_TOL)
        split = pa.quant_ragged_paged_attention_split_reference(*t)
        record("quant_ragged_paged_attention",
               f"int8 {shape} against its split version",
               _valid_err(torch, out, split, t[-1]), QUANT_TOL)
        rows_identical(torch, pa, "quant_ragged_paged_attention", t, out,
                       f"int8 {shape}")
    parity_flash(torch, dev, record)
    parity_flash_bwd(torch, dev, record)
    return errs


# (case, parity_inputs kwargs, causal, valid leading keys or None, window):
# the shapes of tests/test_flash_attention.py and the window cases of
# tests/test_sliding_window.py.
FLASH_F32_CASES = (
    ("causal", {}, True, None, None),
    ("non-causal", {}, False, None, None),
    ("ragged 37/53", dict(sq=37, sk=53), False, None, None),
    ("causal ragged 45", dict(sq=45), True, None, None),
    ("padding mask", {}, False, 40, None),
    ("causal + mask", {}, True, 50, None),
    ("fully masked", {}, False, 0, None),
    ("window 7 S200", dict(sq=200, n_heads=2, d_head=32), True, None, 7),
    ("window 64 S200", dict(sq=200, n_heads=2, d_head=32), True, None, 64),
    ("train shape (4, 1024, 32, 64)",
     dict(batch=4, sq=1024, n_heads=32, d_head=64), True, None, None),
)
# (case, S, H, D, left padding, window): TinyLlama prefills and a
# Mistral-width band.
FLASH_BF16_CASES = (
    ("TinyLlama prefill S256", 256, 32, 64, 37, None),
    ("TinyLlama prefill S2048", 2048, 32, 64, 300, None),
    ("Mistral band S1024 window 256", 1024, 8, 128, 100, 256),
)


def flash_err(torch, out, lse, ref, ref_lse) -> float:
    """Largest difference on out and on lse (rows with a valid key; both
    must be -inf, and out 0, on the others)."""
    dead = torch.isinf(ref_lse)
    check(torch.equal(torch.isinf(lse), dead)
          and not bool(torch.isnan(out.float()).any()),
          "flash_attention: lse -inf rows differ or NaN output")
    lse_err = torch.where(dead, 0.0, lse - ref_lse).abs().max()
    return max(float((out.float() - ref.float()).abs().max()),
               float(lse_err))


def flash_identical(torch, fl, q, k, v, args, out, lse, case) -> None:
    """#5 gives the same bits over two runs."""
    again = fl.flash_attention_fwd(q, k, v, **args)
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          f"flash_attention {case}: two runs differ")


def parity_flash(torch, dev, record) -> None:
    from tpu_engine_torch.ops import flash as fl

    for case, kw, causal, valid, window in FLASH_F32_CASES:
        q, k, v = (torch.from_numpy(a).to(dev) for a in fl.parity_inputs(
            **kw))
        mask = None
        if valid is not None:
            m = np.zeros((q.shape[0], k.shape[1]), np.int32)
            m[:, :valid] = 1
            mask = torch.from_numpy(m).to(dev)
        args = dict(causal=causal, mask=mask, window=window)
        out, lse = fl.flash_attention_fwd(q, k, v, **args)
        ref, ref_lse = fl.flash_attention_reference(q, k, v, **args)
        torch.cuda.synchronize()
        record("flash_attention", f"f32 {case}",
               flash_err(torch, out, lse, ref, ref_lse), F32_TOL)
        flash_identical(torch, fl, q, k, v, args, out, lse, f"f32 {case}")
    for case, s, h, d, pad, window in FLASH_BF16_CASES:
        q, k, v, mask = flash_inputs(torch, dev, s, h, d, pad)
        # bf16 out, and the f32 out the ring's hops take.
        for out_dtype, tag in ((None, "bf16"),
                               (torch.float32, "bf16 in, f32 out")):
            args = dict(causal=True, mask=mask, window=window,
                        out_dtype=out_dtype)
            out, lse = fl.flash_attention_fwd(q, k, v, **args)
            ref, ref_lse = fl.flash_attention_reference(q, k, v, **args)
            torch.cuda.synchronize()
            check(out.dtype == (out_dtype or q.dtype),
                  f"flash_attention {tag} {case}: out {out.dtype}")
            record("flash_attention", f"{tag} {case}",
                   flash_err(torch, out, lse, ref, ref_lse), BF16_TOL)
            flash_identical(torch, fl, q, k, v, args, out, lse,
                            f"{tag} {case}")
            del ref, ref_lse
    # The draft model's prefill on the model-drafted spec lane: one row of
    # distilgpt2 width (12 heads, D 64) in its bucket, left padding masked,
    # f32 q, k, v as nn.dense gives them.
    for pb, pad in ((16, 3), (32, 20), (64, 20)):
        q, k, v, mask = flash_inputs(torch, dev, pb, 12, 64, pad,
                                     dtype=torch.float32)
        args = dict(causal=True, mask=mask)
        out, lse = fl.flash_attention_fwd(q, k, v, **args)
        ref, ref_lse = fl.flash_attention_reference(q, k, v, **args)
        torch.cuda.synchronize()
        case = f"f32 draft prefill pb={pb} pad {pad}"
        record("flash_attention", case,
               flash_err(torch, out, lse, ref, ref_lse), F32_TOL)
        flash_identical(torch, fl, q, k, v, args, out, lse, case)
    # The one-shot forwards of a TinyLlama lane, f32 as nn.dense gives q,
    # k, v: /infer's (32 rows of seq_len 128, causal, no mask) and a
    # /score bucket's (8 rows right-padded in 128 columns).
    lengths = (128, 100, 77, 50, 31, 17, 5, 1)
    m = np.zeros((len(lengths), 128), np.int32)
    for r, n in enumerate(lengths):
        m[r, :n] = 1
    for case, b, mask in (("f32 /infer B=32 S=128", 32, None),
                          ("f32 /score B=8 S=128 right padding", 8,
                           torch.from_numpy(m).to(dev))):
        q, k, v, _ = flash_inputs(torch, dev, 128, 32, 64,
                                  dtype=torch.float32, b=b)
        args = dict(causal=True, mask=mask)
        out, lse = fl.flash_attention_fwd(q, k, v, **args)
        ref, ref_lse = fl.flash_attention_reference(q, k, v, **args)
        torch.cuda.synchronize()
        record("flash_attention", case,
               flash_err(torch, out, lse, ref, ref_lse), F32_TOL)
        flash_identical(torch, fl, q, k, v, args, out, lse, case)


# (case, parity_inputs kwargs, causal, mask, window): the shapes of
# tests/test_flash_backward.py (mask: the valid leading keys of every row,
# or "row 1 dead", a batch row with no valid key), the window case of
# tests/test_sliding_window.py, and the train phase's shape.
FLASH_BWD_F32_CASES = (
    ("causal (2, 64, 2, 32)", dict(sq=64, n_heads=2, d_head=32), True, None,
     None),
    ("causal (1, 200, 4, 64)", dict(batch=1, sq=200, n_heads=4, d_head=64),
     True, None, None),
    ("padding mask (2, 96, 2, 32)", dict(sq=96, n_heads=2, d_head=32), True,
     70, None),
    ("non-causal (2, 48, 2, 32)", dict(sq=48, n_heads=2, d_head=32), False,
     None, None),
    ("fully masked row (2, 32, 2, 16)", dict(sq=32, n_heads=2, d_head=16),
     True, "row 1 dead", None),
    ("window 9 (1, 96, 2, 16)", dict(batch=1, sq=96, n_heads=2, d_head=16),
     True, None, 9),
    ("train shape (4, 1024, 32, 64)",
     dict(batch=4, sq=1024, n_heads=32, d_head=64), True, None, None),
)
# (case, S, H, D, left padding): TinyLlama prefill rows, as the forward's.
FLASH_BWD_BF16_CASES = (
    ("TinyLlama S256", 256, 32, 64, 37),
    ("TinyLlama S2048", 2048, 32, 64, 300),
)


def _bwd_mask(torch, dev, b, s, spec):
    if spec is None:
        return None
    m = np.ones((b, s), np.int32)
    if spec == "row 1 dead":
        m[1] = 0
    else:
        m[:, spec:] = 0
    return torch.from_numpy(m).to(dev)


def parity_flash_bwd(torch, dev, record) -> None:
    """#6 and #7 against their plain versions on the same inputs (the
    forward kernel's out and lse, a unit-normal do), bit-identical over two
    runs; then FlashAttention's autograd as a whole against the plain
    backward (f32 cases)."""
    from tpu_engine_torch.ops import flash as fl

    def held(kernel, case, pairs, tol):
        """Record the (got, want) pair whose error, relative to its
        reference's largest magnitude, is the largest."""
        errs = []
        for got, want in pairs:
            e = float((got.float() - want.float()).abs().max())
            m = max(float(want.float().abs().max()), 1e-30)
            errs.append((e / m, e, m))
        _, e, m = max(errs)
        record(kernel, case, e, tol, m)

    def one(case, q, k, v, mask, causal, window, tol, function):
        args = dict(causal=causal, window=window)
        out, lse = fl.flash_attention_fwd(q, k, v, mask=mask, **args)
        rng = np.random.default_rng(9)
        do = torch.from_numpy(rng.standard_normal(q.shape, np.float32)).to(
            dev, q.dtype)
        a = (q, k, v, mask, lse, fl.bwd_delta(do, out), do)
        runs = [(fl.flash_attention_bwd_dq(*a, **args),
                 *fl.flash_attention_bwd_dkv(*a, **args)) for _ in range(2)]
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(*runs)),
              f"flash backward {case}: two runs differ")
        check(all(bool(torch.isfinite(g.float()).all()) for g in runs[0]),
              f"flash backward {case}: non-finite gradient")
        dq, dk, dv = runs[0]
        ref = (fl.flash_attention_bwd_dq_reference(*a, **args),
               *fl.flash_attention_bwd_dkv_reference(*a, **args))
        held("flash_attention_bwd_dq", case, [(dq, ref[0])], tol)
        held("flash_attention_bwd_dkv", case, [(dk, ref[1]), (dv, ref[2])],
             tol)
        if function:
            t = [x.detach().requires_grad_() for x in (q, k, v)]
            o = fl.flash_attention(*t, mask=mask, **args)
            check(o.grad_fn is not None, "FlashAttention: no grad_fn")
            got = torch.autograd.grad(o, t, do)
            ref_o, ref_lse = fl.flash_attention_reference(q, k, v, mask=mask,
                                                          **args)
            want = fl.flash_attention_bwd_reference(q, k, v, mask, ref_o,
                                                    ref_lse, do, **args)
            held("flash_attention_bwd_dq", f"FlashAttention {case}",
                 [(got[0], want[0])], tol)
            held("flash_attention_bwd_dkv", f"FlashAttention {case}",
                 list(zip(got[1:], want[1:])), tol)

    for case, kw, causal, mask, window in FLASH_BWD_F32_CASES:
        q, k, v = (torch.from_numpy(x).to(dev)
                   for x in fl.parity_inputs(seed=5, **kw))
        one(f"f32 {case}", q, k, v,
            _bwd_mask(torch, dev, q.shape[0], q.shape[1], mask), causal,
            window, BWD_F32_TOL, True)
    for case, s, h, d, pad in FLASH_BWD_BF16_CASES:
        q, k, v, mask = flash_inputs(torch, dev, s, h, d, pad)
        one(f"bf16 {case}", q, k, v, mask, True, None, BF16_TOL, False)
        torch.cuda.empty_cache()


@contextlib.contextmanager
def served_conv_precision(torch):
    """cuDNN's default TF32 setting, the one a worker process serves with
    (``main`` turns TF32 off for the f32 parity checks): the bf16 convs'
    f32 convolutions run on the TF32 tensor cores."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def infer_model_errs(torch, name: str, dtype: str) -> dict:
    """``name`` at 224 x 224 x 3 (two rows) on the card against the CPU on
    the same weights (drawn on the CPU in f32) and inputs, in ``dtype``:
    max|card - cpu| / max|cpu| at the current TF32 settings, and in bf16
    also with cuDNN's TF32 on and off."""
    from tpu_engine_torch.models.convert import params_to
    from tpu_engine_torch.models.registry import create_model

    spec = create_model(name)
    params = spec.init(0, device="cpu", dtype="float32")
    dt = getattr(torch, dtype)
    x = np.random.default_rng(11).standard_normal(
        (2,) + spec.input_shape).astype(np.float32)
    card = params_to(params, "cuda")

    def err():
        with torch.inference_mode():
            got = spec.apply(card, torch.from_numpy(x).cuda(), dtype=dt)
        got = got.cpu()
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
              f"{name} {dtype}: non-finite or misshapen card output")
        return float((got - want).abs().max() / want.abs().max())

    with torch.inference_mode():
        want = spec.apply(params, torch.from_numpy(x), dtype=dt)
    if dtype == "float32":
        return {"": err()}
    out = {}
    for tf32 in (True, False):
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            out[f" tf32 {'on' if tf32 else 'off'}"] = err()
        finally:
            torch.backends.cudnn.allow_tf32 = prev
    return out


def parity_infer_models(torch) -> dict:
    """mlp, resnet50 and resnet50-v1 at 224 x 224 x 3 on the card against
    the CPU on the same weights and inputs (two rows): in f32 (cuDNN and
    cuBLAS without TF32) within INFER_F32_TOL of the largest logit, and in
    the served bf16, with cuDNN's TF32 on (its default) and off, within
    INFER_BF16_TOL; and each model's bucket-1 output through the engine
    bit-identical over two runs, in f32 and in bf16."""
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.runtime.engine import InferenceEngine

    out = {}
    for name in ("mlp", "resnet50", "resnet50-v1"):
        spec = create_model(name)
        for dtype, tol in (("float32", INFER_F32_TOL),
                           ("bfloat16", INFER_BF16_TOL)):
            short = "f32" if dtype == "float32" else "bf16"
            for case, err in infer_model_errs(torch, name, dtype).items():
                log(f"parity {name} {short}{case} (B 2, {spec.input_shape}): "
                    f"card vs CPU max|diff|/max|cpu| {err:.3e} (tol {tol:g})")
                check(err <= tol, f"{name} {short}{case} card vs CPU: {err}")
                out[f"{name} {short}{case} card vs cpu"] = err
        x = np.random.default_rng(11).standard_normal(
            spec.input_shape).astype(np.float32)
        for dtype in ("float32", "bfloat16"):
            eng = InferenceEngine(spec, dtype=dtype, device="cuda",
                                  rng_seed=0, batch_buckets=(1,))
            first, again = (eng.predict(x) for _ in range(2))
            check(np.array_equal(first, again) and np.isfinite(first).all(),
                  f"{name} {dtype}: bucket-1 output differs over two runs")
            log(f"parity {name} {dtype}: bucket-1 output bit-identical over "
                f"two runs")
            del eng
    torch.cuda.empty_cache()
    return out


def phase_small_model(torch) -> None:
    """A small llama served on the card (kernels) against the same f32
    weights served on the CPU (plain versions), in every lane's mode and
    through three speculative lanes (spec_k 4: mixed over the f32 pool,
    two-path over the int8 pool, and mixed with a draft model, itself a
    small llama of other seeded weights): greedy streams equal, and each
    spec lane's equal the card's plain lane of its mode."""
    from tpu_engine_torch.models.convert import init_params, params_to
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.runtime.scheduler import ContinuousGenerator

    base = dict(dtype="float32", n_slots=4, max_seq=128, prefill_chunk=16)
    paged = dict(kv_block_size=16)
    # Dense lanes prefill monolithically (prefill_chunk 0): every prompt's
    # attention goes through the flash kernel on the card.
    dense = dict(step_chunk=4, prefill_chunk=0)
    runs = [("llama-small-test", "mixed",
             dict(paged, mixed_step=True, mixed_token_budget=16)),
            ("llama-small-test", "two-path", dict(paged, step_chunk=4)),
            ("llama-small-test", "mixed int8",
             dict(paged, mixed_step=True, mixed_token_budget=16,
                  kv_quantize="int8")),
            ("llama-small-test", "two-path int8",
             dict(paged, step_chunk=4, kv_quantize="int8")),
            ("llama-small-test", "dense", dense),
            ("mistral-small-test", "dense (window 8)", dense),
            ("llama-small-test", "spec mixed",
             dict(paged, mixed_step=True, mixed_token_budget=16,
                  spec_k=SPEC_K)),
            ("llama-small-test", "spec two-path int8",
             dict(paged, step_chunk=4, kv_quantize="int8", spec_k=SPEC_K)),
            ("llama-small-test", "spec mixed model-drafted",
             dict(paged, mixed_step=True, mixed_token_budget=16,
                  spec_k=SPEC_K, spec_draft="model"))]
    shared = [(i * 11) % 200 + 1 for i in range(32)]
    prompts = [[5, 9, 3], [(i * 7) % 200 + 1 for i in range(40)],
               shared + [91, 92, 93], shared + [81, 82], [5, 6, 7] * 6]
    flash = wrapper("flash_attention")
    plain_card = {}
    for name, mode, kw in runs:
        spec = create_model(name, max_seq=128)
        params = init_params(spec.config, seed=3, device="cpu",
                             dtype="float32")
        draft = (init_params(spec.config, seed=4, device="cpu",
                             dtype="float32")
                 if kw.get("spec_draft") == "model" else None)
        outs = {}
        for dev in ("cpu", "cuda"):
            launches = flash.launches
            extra = {}
            if draft is not None:
                extra = dict(spec_draft_model=spec,
                             spec_draft_params=params_to(draft, dev))
            gen = ContinuousGenerator(spec, params=params_to(params, dev),
                                      device=dev, **dict(base, **kw),
                                      **extra)
            try:
                outs[dev] = [gen.generate([p], max_new_tokens=8)[0]
                             for p in prompts]
                # A penalty under 1 makes the random model repeat the
                # prompt's tokens, so the n-gram drafter's windows hold
                # (accepted proposals move a row several columns a tick).
                outs[dev].append(gen.generate(
                    [[5, 6, 7, 8] * 6], max_new_tokens=16,
                    repetition_penalty=0.1)[0])
                st = gen.stats()
            finally:
                gen.stop()
            if dev == "cuda" and (mode.startswith("dense")
                                  or draft is not None):
                check(flash.launches > launches,
                      f"small model {name} {mode}: no flash launch")
        log(f"small model {name} f32 {mode}: card {outs['cuda']} cpu "
            f"{outs['cpu']}")
        check(outs["cuda"] == outs["cpu"],
              f"small-model greedy streams ({name} {mode}) differ between "
              f"card and CPU")
        if not mode.startswith("spec"):
            plain_card[(name, mode)] = outs["cuda"]
            continue
        sp = st["spec"]
        check(sp["ticks"] == sp["dispatches"] > 0
              and sp["proposed_tokens"] > 0
              and (draft is not None or sp["accepted_tokens"] > 0),
              f"small model {mode}: {sp}")
        plain_mode = mode[len("spec "):].replace(" model-drafted", "")
        check(outs["cuda"] == plain_card[(name, plain_mode)],
              f"small model {mode}: the spec lane's streams differ from "
              f"the card's plain {plain_mode} lane")
        log(f"small model {name} f32 {mode}: equal to the card's plain "
            f"{plain_mode} lane; spec {json.dumps(sp)}")


def run_train(argv, params=None) -> str:
    """The port's train command in-process; returns what it printed."""
    import io

    from tpu_engine_torch.serving import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.train(argv, params=params)
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  train: {line}")
    check(rc == 0, f"train {argv}: exit code {rc}")
    return text


def phase_train_small(torch) -> dict:
    """llama-small-test, f32 weights: three make_train_step steps on the
    card (the flash forward and backward kernels) against the same steps on
    the CPU (plain versions), in f32 (TF32 off; losses within 1e-4
    relative) and in bf16 compute (within BF16_TOL); then
    the train command with --out and --resume on the card, and the port's
    worker serving <out>/params with a generator's greedy tokens."""
    from tpu_engine_torch.models.convert import init_params
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models.transformer import transformer_apply
    from tpu_engine_torch.runtime.scheduler import ContinuousGenerator
    from tpu_engine_torch.serving import cli
    from tpu_engine_torch.serving.app import serve_worker
    from tpu_engine_torch.training.train import (
        adamw,
        cross_entropy_loss,
        make_train_step,
        tree_map,
    )
    from tpu_engine_torch.utils.config import WorkerConfig

    spec = create_model("llama-small-test")
    cfg = spec.config
    params = init_params(cfg, seed=3, device="cpu", dtype="float32")
    rng = np.random.default_rng(5)
    batches = [rng.integers(1, cfg.vocab, (4, 65)).astype(np.int32)
               for _ in range(3)]
    bwd = wrapper("flash_attention_bwd_dq")
    small = {}
    # f32 (TF32 off): f32 sums in another order, 1e-4. bf16 compute
    # (make_train_step's default): a value rounded to bf16 on one device may
    # round one ulp (2^-8) away on the other, BF16_TOL.
    for dtype, tol in (("float32", 1e-4), ("bfloat16", BF16_TOL)):
        losses = {}
        for dev in ("cpu", "cuda"):
            init_state, step = make_train_step(
                lambda p, x, dtype: transformer_apply(p, x, cfg,
                                                      dtype=dtype),
                loss_fn=cross_entropy_loss, optimizer=adamw(1e-3),
                dtype=getattr(torch, dtype))
            state = init_state(tree_map(lambda t: t.clone().to(dev), params))
            launches = bwd.launches
            losses[dev] = []
            for b in batches:
                t = torch.from_numpy(b).to(dev)
                state, loss = step(state, t[:, :-1], t[:, 1:])
                losses[dev].append(float(loss))
            if dev == "cuda":
                check(bwd.launches == launches + 3 * cfg.n_layers,
                      "small train: the dq kernel did not run once per "
                      "layer")
            del state
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
        log(f"train small llama {dtype}: card losses {losses['cuda']} cpu "
            f"{losses['cpu']} (max rel diff {rel:.2e}, tol {tol})")
        check(rel <= tol and all(np.isfinite(losses["cuda"])),
              f"small train {dtype}: card and CPU losses differ by {rel}")
        small[dtype] = {"card_losses": losses["cuda"],
                        "cpu_losses": losses["cpu"], "max_rel_loss_diff": rel}

    root = OUT_DIR / "train_small"
    common = ["--model", "llama-small-test", "--batch", "4", "--seq", "64",
              "--log-every", "1"]
    text = run_train([*common, "--steps", "6", "--out", str(root / "ck1")])
    cli_losses = [float(ln.split()[-1]) for ln in text.splitlines()
                  if ln.startswith("step ")]
    check(len(cli_losses) == 6 and cli_losses[-1] < cli_losses[0],
          f"train command: the loss did not fall: {cli_losses}")
    trained = spec.init(0, device="cuda", dtype="float32")
    text = run_train([*common, "--steps", "2", "--resume",
                      str(root / "ck1" / "state"), "--out",
                      str(root / "ck2")], params=trained)
    check("resumed at step 6" in text and "step 8:" in text,
          f"train command: resume did not continue the step count: {text}")
    name, served = cli.resolve_model(str(root / "ck2" / "params"),
                                     device="cuda", dtype="float32")
    check(name == "llama-small-test", f"sidecar names {name}")
    worker, server = serve_worker(WorkerConfig(
        port=0, node_id="chip-smoke-trained", model=name, dtype="float32",
        device="cuda"), params=served)
    gen = ContinuousGenerator(spec, device="cuda", dtype="float32",
                              step_chunk=16,
                              params=tree_map(lambda t: t.detach(), trained))
    try:
        prompt = [5, 9, 3, 7, 11]
        got = post(server.port, "/generate", {
            "request_id": "trained", "prompt_tokens": prompt,
            "max_new_tokens": 8})["tokens"]
        want = gen.generate([prompt], max_new_tokens=8)[0]
    finally:
        server.stop()
        worker.stop()
        gen.stop()
    log(f"train small: worker on <out>/params greedy {got}, in-process "
        f"{want}")
    check(got == want, "the worker on the trained params differs from the "
                       "in-process generator")
    return {**small, "cli_losses": cli_losses, "served_tokens": got}


def measured_step(torch, fn) -> dict:
    """One training step under torch.profiler: wall ms (to the end of the
    card's work), host issue ms (until fn returns), device busy ms (the
    device events summed), and the flash kernels' device ms by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, loss = fn()
        issue = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(torch, prof)
    busy = sum(us for _, us in events) / 1e3

    def kernel_ms(*prefixes):
        return sum(us for name, us in events
                   if any(p in name for p in prefixes)) / 1e3

    # The element type each flash kernel ran in, from its template
    # arguments (flash_attention_bwd_dq_kernel<float, 64>, or
    # <__nv_bfloat16, 64>).
    names = {"fwd": ("flash_attention_kernel",),
             "bwd": ("flash_attention_bwd_dq_kernel",
                     "flash_attention_bwd_dkv_kernel")}
    variants = {f"{k} {t}": kernel_ms(*(f"{n}<{ct}" for n in names[k]))
                for k in names
                for t, ct in (("f32", "float"), ("bf16", "__nv_bfloat16"))}
    return {"loss": float(loss), "wall_ms": wall * 1e3,
            "issue_ms": issue * 1e3, "busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / (wall * 1e3)),
            "flash_fwd_ms": kernel_ms("flash_attention_kernel<"),
            "flash_bwd_ms": kernel_ms("flash_attention_bwd_dq_kernel<",
                                      "flash_attention_bwd_dkv_kernel<"),
            "flash_variant_ms": variants}


# The full-width training runs: (name, steps, batch, seq, lr, remat,
# compute dtype); f32 weights in all. The loss must fall in the runs
# without remat.
TRAIN_RUNS = (("B4 S1024", 4, 4, 1024, 1e-4, False, "float32"),
              ("B4 S1024 bf16", 3, 4, 1024, 1e-4, False, "bfloat16"),
              ("B8 S2048 remat", 2, 8, 2048, 1e-3, True, "float32"))


def phase_train(torch) -> dict:
    """TinyLlama-1.1B geometry (llama, 22 layers), f32 weights from seed 0
    and AdamW, on the train command's fixed synthetic batch: 4 steps at
    B 4 x S 1024 (lr 1e-4) with an f32 forward, 3 at the same shape with
    make_train_step's default bf16 compute dtype, and 2 steps at the
    command's defaults, B 8 x S 2048 with remat, in f32. The launch counts
    are set to 0 before the phase and read after each step: 22 flash
    forwards per step (44 with remat), 22 launches of each backward kernel,
    no plain call; the device time of each flash kernel's f32 and bf16
    variants is read off the profiler."""
    import gc

    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models.transformer import transformer_apply
    from tpu_engine_torch.ops import kernels
    from tpu_engine_torch.training.train import (
        adamw,
        cross_entropy_loss,
        make_train_step,
    )

    spec = create_model("llama")
    cfg = spec.config
    out = {"runs": {}}
    kernels.reset_counts()  # the train phase: counts from 0, read after
    for name, steps, batch, seq, lr, remat, dtype in TRAIN_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        def apply_fn(p, x, dtype, remat=remat):
            return transformer_apply(p, x, cfg, dtype=dtype, remat=remat)

        init_state, train_step = make_train_step(
            apply_fn, loss_fn=cross_entropy_loss, optimizer=adamw(lr),
            dtype=getattr(torch, dtype))
        state = init_state(spec.init(0, device="cuda", dtype="float32"))
        # The train command's fixed synthetic batch (seed 0, offset 0).
        tokens = np.random.default_rng(0).integers(
            1, cfg.vocab, (batch, seq + 1)).astype(np.int32)
        window = torch.from_numpy(tokens).cuda()
        x, y = window[:, :-1], window[:, 1:]
        recs = []
        for k in range(steps):
            before = launch_counts()
            rec = measured_step(torch, lambda: train_step(state, x, y))
            after = launch_counts()
            n = {kk: after[kk][0] - before[kk][0] for kk in after}
            want_fwd = cfg.n_layers * (2 if remat else 1)
            check(n["flash_attention"] == want_fwd
                  and n["flash_attention_bwd_dq"] == cfg.n_layers
                  and n["flash_attention_bwd_dkv"] == cfg.n_layers
                  and all(v == 0 for kk, v in n.items()
                          if not kk.startswith("flash")),
                  f"train {name} step {k + 1}: launches {n}")
            check(np.isfinite(rec["loss"]),
                  f"train {name} step {k + 1}: loss {rec['loss']}")
            rec.update(launches=n, tokens_per_s=batch * seq
                       / (rec["wall_ms"] / 1e3))
            recs.append(rec)
            log(f"train {name} step {k + 1}: loss {rec['loss']:.4f}, "
                f"{rec['wall_ms']:.1f} ms (host issue "
                f"{rec['issue_ms']:.1f} ms, device busy "
                f"{rec['busy_ms']:.1f} ms, idle "
                f"{100 * rec['idle_share']:.1f}%), flash forward "
                f"{rec['flash_fwd_ms']:.1f} ms "
                f"({100 * rec['flash_fwd_ms'] / rec['wall_ms']:.1f}%), "
                f"backward {rec['flash_bwd_ms']:.1f} ms "
                f"({100 * rec['flash_bwd_ms'] / rec['wall_ms']:.1f}%), "
                f"{rec['tokens_per_s']:.0f} tokens/s; launches flash "
                f"{n['flash_attention']}, dq {n['flash_attention_bwd_dq']}, "
                f"dkv {n['flash_attention_bwd_dkv']}; device ms by variant "
                + ", ".join(f"{k} {v:.1f}"
                            for k, v in rec["flash_variant_ms"].items()))
        peak = torch.cuda.max_memory_allocated()
        log(f"train {name}: max_memory_allocated {peak / 2**30:.2f} GiB")
        if not remat:
            check(recs[-1]["loss"] < recs[0]["loss"],
                  f"train {name}: the loss did not fall")
        out["runs"][name] = {"steps": recs, "max_memory_allocated": peak,
                             "batch": batch, "seq": seq, "lr": lr,
                             "remat": remat, "dtype": dtype}
        del state, x, y, window
    counts = launch_counts()
    check(all(p == 0 for _, p in counts.values()),
          f"train: plain versions ran: {counts}")
    out["launches"] = {k: n for k, (n, _) in counts.items()}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def cut_llama() -> str:
    """The registry name of TinyLlama's geometry at cut depth (CUT_LAYERS),
    registered at first use."""
    from tpu_engine_torch.models import llama, registry

    if CUT_LLAMA not in registry.available_models():
        registry.register(CUT_LLAMA)(lambda **kw: llama.make_llama(
            **{"n_layers": CUT_LAYERS, **kw}))
    return CUT_LLAMA


def start_lane(torch, params, lane: str, model: str = "llama",
               overrides=None, node_id=None, dtype: str = "bfloat16"):
    """A worker of the main path's geometry for ``lane``, over HTTP."""
    from tpu_engine_torch.serving.app import serve_worker
    from tpu_engine_torch.utils.config import WorkerConfig

    cfg = WorkerConfig(port=0, node_id=node_id or f"chip-smoke-{lane}",
                       model=model,
                       dtype=dtype, gen_max_batch_size=8,
                       gen_prefill_chunk=256, device="cuda", seed=0,
                       **(LANES[lane] if overrides is None else overrides))
    t0 = time.perf_counter()
    worker, server = serve_worker(cfg, params=params)
    torch.cuda.synchronize()
    geometry = {"llama": "TinyLlama-1.1B geometry",
                CUT_LLAMA: f"TinyLlama-1.1B width, "
                           f"{CUT_LAYERS} of its 22 layers"}.get(
        model, f"{worker.generator.cfg.n_layers} layers, d "
               f"{worker.generator.cfg.d_model}")
    log(f"server {lane}: {model} ({geometry}) ready in "
        f"{time.perf_counter() - t0:.1f} s on port {server.port}")
    return worker, server


def burst(port: int, lane: str, reqs: dict, stream_prompt,
          vocab: int = 32000, max_new: int = MAX_NEW) -> tuple:
    """The requests of ``reqs`` on /generate and ``stream_prompt`` on
    /generate/stream, all at once. Checks that every one completes with
    ``max_new`` tokens; returns (results by name, stream tokens, stream
    TTFT, the burst's seconds, its tokens)."""
    results, errors = {}, []

    def run(name, prompt):
        try:
            results[name] = post(port, "/generate", {
                "request_id": name, "prompt_tokens": prompt,
                "max_new_tokens": max_new})
        except Exception as exc:  # reported below, fails the phase
            errors.append(f"{name}: {exc!r}")

    def run_stream():
        try:
            results["stream"] = stream(port, {
                "request_id": "stream", "prompt_tokens": stream_prompt,
                "max_new_tokens": max_new})
        except Exception as exc:
            errors.append(f"stream: {exc!r}")

    threads = [threading.Thread(target=run, args=kv) for kv in reqs.items()]
    threads.append(threading.Thread(target=run_stream))
    t_burst = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    burst_s = time.perf_counter() - t_burst
    check(not errors and not any(t.is_alive() for t in threads),
          f"{lane} burst failed: {errors}")
    s_toks, s_final, ttft = results.pop("stream")
    check(s_final is not None and "error" not in s_final
          and s_final["tokens"] == s_toks and len(s_toks) == max_new,
          f"{lane} stream: {s_final}")
    n_tokens = len(s_toks)
    for name, res in results.items():
        check(len(res["tokens"]) == max_new
              and all(0 <= t < vocab for t in res["tokens"]),
              f"{lane} {name}: {res}")
        n_tokens += len(res["tokens"])
    return results, s_toks, ttft, burst_s, n_tokens


def generator_stats(port: int) -> dict:
    """The lane's scheduler stats: /health's generator block."""
    return get(port, "/health")["generator"]


def wait_idle(port: int, paged: bool) -> tuple:
    """(the scheduler's stats once the lane is idle, whether it got there
    in 30 s): no active row and, over the paged pool, every block free or
    held by a radix node resident on the card (a node demoted to the host
    tier holds none)."""
    deadline = time.time() + 30
    while True:
        st = generator_stats(port)
        idle = st["active"] == 0
        if paged:
            pool = st["kv_pool"]
            demoted = pool.get("host", {}).get("blocks_used", 0)
            idle = idle and (pool["blocks_free"] + pool["radix_nodes"]
                             - demoted == pool["blocks_total"])
        if idle or time.time() > deadline:
            return st, idle
        time.sleep(0.05)


def check_counts(lane: str, kernel: str, also=()) -> int:
    """The lane's launches of its kernel; no plain call, and no other
    kernel than those of ``also``."""
    counts = launch_counts()
    check(all(p == 0 for _, p in counts.values()),
          f"{lane}: plain versions served attention: {counts}")
    check(all(n == 0 for k, (n, _) in counts.items()
              if k != kernel and k not in also),
          f"{lane}: other kernels launched: {counts}")
    return counts[kernel][0]


def serve_lane(torch, params, lane: str) -> dict:
    """Drive one paged lane of the main path over HTTP with the launch
    counts set to 0 just before and read just after; check its
    invariants."""
    from tpu_engine_torch.ops import kernels

    overrides = LANES[lane]
    kernel = next(k for k, v in KERNELS.items() if v["lane"] == lane)
    mixed = bool(overrides.get("gen_mixed_step"))
    worker, server = start_lane(torch, params, lane, cut_llama())
    port = server.port
    gcfg = worker.generator.cfg
    vocab, n_layers = gcfg.vocab, gcfg.n_layers
    rng = np.random.default_rng(0)

    def toks(n):
        return [int(t) for t in rng.integers(1, vocab, n)]

    prefix = toks(64)
    reqs = {"long": toks(300), "prefix_a": prefix + toks(20),
            "mid": toks(100), "short": toks(17), "one": toks(1)}
    stream_prompt = toks(200)
    try:
        kernels.reset_counts()  # the lane's run: counts from 0, read after
        warm = post(port, "/generate", {"request_id": "warm",
                                        "prompt_tokens": reqs["short"],
                                        "max_new_tokens": 4})
        check(len(warm["tokens"]) == 4, f"{lane} warm-up: {warm}")
        _, _, ttft, burst_s, n_tokens = burst(port, lane, reqs,
                                              stream_prompt)
        hit0 = generator_stats(port)["kv_pool"]["prefix_hit_tokens"]
        shared = post(port, "/generate", {
            "request_id": "prefix_b", "prompt_tokens": prefix + toks(40),
            "max_new_tokens": MAX_NEW})
        hit = generator_stats(port)["kv_pool"]["prefix_hit_tokens"] - hit0
        check(len(shared["tokens"]) == MAX_NEW and hit >= 64,
              f"{lane} shared prefix: {hit} prefix-hit tokens")
        # Greedy repeat under the same batch composition (alone, both
        # resuming from the same radix hit): token-identical. In a mixed
        # lane a co-batched stream may differ from the same prompt alone:
        # a decode row riding a prefill tick goes through a 2048-row GEMM
        # instead of an 8-row one, and bf16 rounds differently.
        first, again = (post(port, "/generate", {
            "request_id": f"long-repeat-{i}", "prompt_tokens": reqs["long"],
            "max_new_tokens": MAX_NEW})["tokens"] for i in range(2))
        check(first == again, f"{lane} greedy repeat differs: {first} "
                              f"{again}")
        st, idle = wait_idle(port, paged=True)
        pool = st["kv_pool"]
        launches = check_counts(lane, kernel)
        check(idle, f"{lane}: not idle or blocks leaked: {pool}")
        check(bool(pool.get("quantized")) == ("int8" in lane),
              f"{lane}: pool {pool}")
        out = {"kernel": kernel, "launches": launches,
               "burst_tokens": n_tokens, "burst_s": burst_s,
               "tokens_per_s": n_tokens / burst_s, "stream_ttft_s": ttft,
               "prefix_hit_tokens": hit, "pool": pool}
        if mixed:
            m = st["mixed"]
            check(m["ticks"] == m["dispatches"] > 0, f"{lane}: {m}")
            check(launches == n_layers * m["dispatches"],
                  f"{lane}: {launches} launches for {m['dispatches']} "
                  f"dispatches of {n_layers} layers")
            out.update(ticks=m["ticks"], dispatches=m["dispatches"])
            steps = f"ticks {m['ticks']} == dispatches {m['dispatches']}"
        else:
            chunks = st["chunks"]
            step_chunk = overrides["gen_step_chunk"]
            check(chunks > 0, f"{lane}: no decode chunk ran")
            check(launches == n_layers * step_chunk * chunks,
                  f"{lane}: {launches} launches for {chunks} chunks of "
                  f"{step_chunk} steps of {n_layers} layers")
            out.update(chunks=chunks,
                       admission_dispatches=st["admission_dispatches"])
            steps = f"chunks {chunks} of {step_chunk} steps"
        health = get(port, "/health")
        check(health["healthy"] and health["generator"]["completed"] >= 8,
              f"{lane} health: {health}")
        log(f"server {lane}: {n_tokens} tokens in {burst_s:.3f} s "
            f"({n_tokens / burst_s:.1f} tokens/s, 6 concurrent requests), "
            f"stream TTFT {ttft * 1e3:.1f} ms; {steps}; {kernel} launches "
            f"{launches}, plain calls 0; prefix hit {hit} tokens; greedy "
            f"repeat identical; blocks free {pool['blocks_free']} + radix "
            f"{pool['radix_nodes']} == total {pool['blocks_total']}")
    finally:
        server.stop()
        worker.stop()
    return out


def oneshot_traffic(port: int, vocab: int, rng) -> tuple:
    """Threads that send /infer token-id payloads (seq_len 128: shorter
    ones zero-pad, a longer one truncates) and /score requests to a
    decoder lane; returns (threads, results by name, errors). Start them
    beside a /generate burst."""
    results, errors = {}, []
    infer = {f"infer{n}": [float(t) for t in rng.integers(1, vocab, n)]
             for n in (1, 5, 40, 128, 200)}
    score = {f"score{i}": ([int(t) for t in rng.integers(1, vocab, p)],
                           [int(t) for t in rng.integers(1, vocab, c)])
             for i, (p, c) in enumerate(((30, 10), (0, 5), (100, 20),
                                         (7, 1)))}

    def run(name, path, body):
        try:
            results[name] = post(port, path, dict(body, request_id=name))
        except Exception as exc:  # reported by the caller
            errors.append(f"{name}: {exc!r}")

    threads = [threading.Thread(target=run, args=(
        n, "/infer", {"input_data": x})) for n, x in infer.items()]
    threads += [threading.Thread(target=run, args=(
        n, "/score", {"prompt_tokens": p, "completion_tokens": c}))
        for n, (p, c) in score.items()]
    return threads, results, errors, infer, score


def check_oneshot(lane: str, worker, results, errors, infer, score,
                  vocab: int) -> dict:
    """The one-shot answers of ``oneshot_traffic``: /infer logits of the
    vocab's width equal the lane's engine on the same input alone within
    ONESHOT_INFER_TOL of the largest, /score log-probabilities of the
    completion's length that are <= 0 and equal the lane's scorer alone
    within ONESHOT_SCORE_TOL of their magnitude (at least 1e-3). Runs
    forwards of its own: call after the launch counts are read."""
    check(not errors, f"{lane} one-shot requests failed: {errors}")
    worst = {"infer": 0.0, "score": 0.0}
    for name, x in infer.items():
        got = np.asarray(results[name]["output_data"], np.float32)
        want = worker.engine.batch_predict([x])[0]
        check(got.shape == (vocab,) and np.isfinite(got).all(),
              f"{lane} {name}: {got.shape}")
        err = float(np.abs(got - want).max() / np.abs(want).max())
        worst["infer"] = max(worst["infer"], err)
    scorer = worker._get_scorer()
    for name, (p, c) in score.items():
        got = np.asarray(results[name]["logprobs"])
        want = np.asarray(scorer.score([p], [c])[0])
        check(got.shape == (len(c),) and (got <= 0).all(),
              f"{lane} {name}: {got}")
        err = float((np.abs(got - want)
                     / np.maximum(np.abs(want), 1e-3)).max())
        worst["score"] = max(worst["score"], err)
    check(worst["infer"] <= ONESHOT_INFER_TOL
          and worst["score"] <= ONESHOT_SCORE_TOL,
          f"{lane}: one-shot answers differ from the engine's: {worst}")
    return worst


def serve_dense_lane(torch, params) -> dict:
    """Drive the worker's default lane (dense cache) over HTTP with the
    launch counts set to 0 just before and read just after: six prompts of
    at most 256 tokens and a stream at once (each a monolithic prefill
    through the flash kernel), beside them five /infer token-id payloads
    and four /score requests (single-tick rows: one flash forward of 22
    layers per one-shot dispatch), an exact repeat (a prefix-cache hit),
    then a 600-token prompt (prefill windows, no flash) and its greedy
    repeat (a hit). Flash launches == layers x (the one-shot dispatches +
    the monolithic prefills that missed the prefix cache)."""
    from tpu_engine_torch.ops import kernels

    lane, kernel = "dense-bf16", "flash_attention"
    worker, server = start_lane(torch, params, lane, cut_llama())
    port = server.port
    gcfg = worker.generator.cfg
    vocab, n_layers = gcfg.vocab, gcfg.n_layers
    prefill_chunk = worker.generator._prefill_chunk
    rng = np.random.default_rng(1)

    def toks(n):
        return [int(t) for t in rng.integers(1, vocab, n)]

    warm_prompt = toks(16)
    reqs = {f"len{n}": toks(n) for n in (1, 17, 64, 100, 200, 256)}
    stream_prompt = toks(180)
    long_prompt = toks(600)
    oneshot, os_results, os_errors, infer, score = oneshot_traffic(
        port, vocab, rng)
    try:
        kernels.reset_counts()  # the lane's run: counts from 0, read after
        warm = post(port, "/generate", {"request_id": "warm",
                                        "prompt_tokens": warm_prompt,
                                        "max_new_tokens": 4})
        check(len(warm["tokens"]) == 4, f"{lane} warm-up: {warm}")
        for t in oneshot:
            t.start()
        results, _, ttft, burst_s, n_tokens = burst(port, lane, reqs,
                                                    stream_prompt)
        for t in oneshot:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in oneshot),
              f"{lane}: one-shot requests hung")
        repeat = post(port, "/generate", {
            "request_id": "len100-repeat", "prompt_tokens": reqs["len100"],
            "max_new_tokens": MAX_NEW})["tokens"]
        check(repeat == results["len100"]["tokens"],
              f"{lane} exact repeat differs: {repeat} "
              f"{results['len100']['tokens']}")
        first, again = (post(port, "/generate", {
            "request_id": f"long-{i}", "prompt_tokens": long_prompt,
            "max_new_tokens": MAX_NEW})["tokens"] for i in range(2))
        check(first == again and len(first) == MAX_NEW,
              f"{lane} greedy repeat differs: {first} {again}")
        st, idle = wait_idle(port, paged=False)
        launches = check_counts(lane, kernel)
        check(idle and "kv_pool" not in st, f"{lane}: not idle: {st}")
        prompts = [warm_prompt, *reqs.values(), stream_prompt, long_prompt]
        monolithic = sum(len(p) <= prefill_chunk for p in prompts)
        pc = st["prefix_cache"]
        check(pc["misses"] == len(prompts) and pc["hits"] == 2,
              f"{lane}: prefix cache {pc}")
        sl = st["stateless"]
        check(sl["infer_rows"] == len(infer) and sl["score_rows"]
              == len(score) and sl["failed"] == 0
              and sl["admitted"] == sl["completed"]
              == len(infer) + len(score) and sl["dispatches"] > 0,
              f"{lane}: stateless {sl}")
        check(launches == n_layers * (monolithic + sl["dispatches"]),
              f"{lane}: {launches} flash launches for {monolithic} "
              f"monolithic prefills and {sl['dispatches']} one-shot "
              f"dispatches of {n_layers} layers")
        check(st["chunks"] > 0, f"{lane}: no decode chunk ran")
        health = get(port, "/health")
        check(health["healthy"] and health["generator"]["completed"] >= 20,
              f"{lane} health: {health}")
        worst = check_oneshot(lane, worker, os_results, os_errors, infer,
                              score, vocab)
        out = {"kernel": kernel, "launches": launches,
               "burst_tokens": n_tokens, "burst_s": burst_s,
               "tokens_per_s": n_tokens / burst_s, "stream_ttft_s": ttft,
               "chunks": st["chunks"],
               "admission_dispatches": st["admission_dispatches"],
               "monolithic_prefills": monolithic, "prefix_cache": pc,
               "stateless": sl, "oneshot_err": worst}
        log(f"server {lane}: {n_tokens} tokens in {burst_s:.3f} s "
            f"({n_tokens / burst_s:.1f} tokens/s, 7 concurrent requests), "
            f"stream TTFT {ttft * 1e3:.1f} ms; chunks {st['chunks']}, "
            f"admission dispatches {st['admission_dispatches']}; one-shot "
            f"rows beside them: {json.dumps(sl)}, against the engine and "
            f"scorer alone {json.dumps(worst)}; {kernel} launches "
            f"{launches} == {n_layers} x ({monolithic} monolithic prefills "
            f"+ {sl['dispatches']} one-shot dispatches), plain calls 0; "
            f"prefix cache {pc}; exact and greedy repeats identical")
    finally:
        server.stop()
        worker.stop()
    return out


def serve_spec_lane(torch, params, lane: str) -> dict:
    """Drive one speculative lane over HTTP with the launch counts set to
    0 just before and read just after: a burst of concurrent /generate
    requests and one /generate/stream, a shared-prefix request, a
    repetitive prompt the n-gram drafter can match, three times (the last
    two a greedy repeat, from the same radix hit). That prompt is a 12-token motif repeated to 230 tokens, sent
    with repetition_penalty 0.1: a penalty under 1 multiplies the seen
    tokens' positive logits by 10, so the random model's greedy tokens
    come from the motif, the drafter finds them in the history and
    proposes, and the verify loop runs its penalty path.
    Checks: every request completes, the repeat is token-identical,
    spec ticks == dispatches (and mixed ticks == dispatches), the lane's
    ragged kernel launched spec dispatches x layers times, the decode
    reads (#2, #3) not at all and no plain version was called, the flash
    forward (the draft's prefill) draft dispatches x the draft's layers
    times, accepted <= proposed tokens, tokens per row dispatch >= 1, and
    no block leaked once idle."""
    from tpu_engine_torch.ops import kernels

    model, kernel, overrides = SPEC_LANES[lane]
    max_new = SPEC_LANE_NEW.get(lane, MAX_NEW)
    if model == "llama":
        model = cut_llama()
    worker, server = start_lane(torch, params if model == CUT_LLAMA
                                else None, lane, model, overrides)
    port = server.port
    gen = worker.generator
    vocab, n_layers = gen.cfg.vocab, gen.cfg.n_layers
    draft = gen._drafter
    draft_layers = draft.cfg.n_layers if draft.name == "model" else 0
    rng = np.random.default_rng(2)

    def toks(n):
        return [int(t) for t in rng.integers(1, vocab, n)]

    prefix = toks(64)
    motif = toks(12)
    reqs = {"long": toks(300), "prefix_a": prefix + toks(20),
            "mid": toks(100), "short": toks(17), "one": toks(1),
            "motif": motif * 2}
    repetitive = (motif * 20)[:230]
    stream_prompt = toks(200)
    try:
        kernels.reset_counts()  # the lane's run: counts from 0, read after
        warm = post(port, "/generate", {"request_id": "warm",
                                        "prompt_tokens": reqs["short"],
                                        "max_new_tokens": 4})
        check(len(warm["tokens"]) == 4, f"{lane} warm-up: {warm}")
        _, _, ttft, burst_s, n_tokens = burst(port, lane, reqs,
                                              stream_prompt, vocab, max_new)
        hit0 = generator_stats(port)["kv_pool"]["prefix_hit_tokens"]
        shared = post(port, "/generate", {
            "request_id": "prefix_b", "prompt_tokens": prefix + toks(40),
            "max_new_tokens": max_new})
        hit = generator_stats(port)["kv_pool"]["prefix_hit_tokens"] - hit0
        check(len(shared["tokens"]) == max_new and hit >= 64,
              f"{lane} shared prefix: {hit} prefix-hit tokens")
        # A spec lane in bf16 is held to its own greedy repeat, alone and
        # from the same radix hit (a verify window changes the GEMM's M,
        # so its tokens need not be the plain lane's; and the first run's
        # prompt attends its own fresh K/V, the repeats' the pool's).
        sp0 = generator_stats(port)["spec"]
        _, first, again = (post(port, "/generate", {
            "request_id": f"repetitive-{i}", "prompt_tokens": repetitive,
            "max_new_tokens": max_new, "repetition_penalty": 0.1})["tokens"]
            for i in range(3))
        check(first == again and len(first) == max_new,
              f"{lane} greedy repeat differs: {first} {again}")
        sp1 = generator_stats(port)["spec"]
        rep_proposed = sp1["proposed_tokens"] - sp0["proposed_tokens"]
        rep_accepted = sp1["accepted_tokens"] - sp0["accepted_tokens"]
        check(rep_proposed > 0, f"{lane}: the drafter proposed nothing on "
                                f"the repetitive prompt: {sp0} {sp1}")
        st, idle = wait_idle(port, paged=True)
        counts = launch_counts()
        pool, sp = st["kv_pool"], st["spec"]
        check(idle, f"{lane}: not idle or blocks leaked: {pool}")
        check(all(p == 0 for _, p in counts.values()),
              f"{lane}: plain versions served attention: {counts}")
        launches = counts[kernel][0]
        flash_launches = counts["flash_attention"][0]
        others = {k: n for k, (n, _) in counts.items()
                  if k not in (kernel, "flash_attention") and n}
        check(not others, f"{lane}: other kernels launched: {others}")
        check(sp["ticks"] == sp["dispatches"] > 0, f"{lane}: {sp}")
        check(launches == n_layers * sp["dispatches"],
              f"{lane}: {launches} {kernel} launches for "
              f"{sp['dispatches']} dispatches of {n_layers} layers")
        check(flash_launches == draft_layers * sp["draft_dispatches"],
              f"{lane}: {flash_launches} flash launches for "
              f"{sp['draft_dispatches']} draft dispatches of "
              f"{draft_layers} layers")
        check(sp["proposed_tokens"] > 0
              and sp["accepted_tokens"] <= sp["proposed_tokens"]
              and sp["tokens_per_row_dispatch"] >= 1.0, f"{lane}: {sp}")
        if "mixed" in st:
            m = st["mixed"]
            check(m["ticks"] == m["dispatches"] == sp["ticks"],
                  f"{lane}: mixed {m} spec {sp}")
        check(bool(pool.get("quantized")) == ("int8" in lane),
              f"{lane}: pool {pool}")
        health = get(port, "/health")
        check(health["healthy"] and "spec" in health["generator"]
              and health["generator"]["completed"] >= 12,
              f"{lane} health: {health}")
        out = {"model": model, "kernel": kernel, "launches": launches,
               "flash_launches": flash_launches, "spec": sp,
               "repetitive_proposed": rep_proposed,
               "repetitive_accepted": rep_accepted,
               "burst_tokens": n_tokens, "burst_s": burst_s,
               "tokens_per_s": n_tokens / burst_s, "stream_ttft_s": ttft,
               "prefix_hit_tokens": hit, "pool": pool}
        log(f"server {lane}: {n_tokens} tokens in {burst_s:.3f} s "
            f"({n_tokens / burst_s:.1f} tokens/s, 7 concurrent requests), "
            f"stream TTFT {ttft * 1e3:.1f} ms; {kernel} launches "
            f"{launches} == {n_layers} x {sp['dispatches']} dispatches, "
            f"flash launches {flash_launches} == {draft_layers} x "
            f"{sp['draft_dispatches']} draft dispatches, #2/#3 and plain "
            f"calls 0; the repetitive prompt 3 times: {rep_proposed} "
            f"proposed, "
            f"{rep_accepted} accepted, greedy repeat identical; blocks free "
            f"{pool['blocks_free']} + radix {pool['radix_nodes']} == total "
            f"{pool['blocks_total']}; spec {json.dumps(sp)}")
    finally:
        server.stop()
        worker.stop()
    return out


@functools.lru_cache(maxsize=None)
def infer_traffic() -> tuple:
    """The resnet50 lanes' requests (seed 5), encoded once for both lanes:
    (the warm-up input, the burst's INFER_BURST inputs and bodies, the 16
    repeats' bodies, the identical input and its 8 bodies)."""
    rng = np.random.default_rng(5)
    n_in = 224 * 224 * 3

    def image():
        return np.round(rng.random(n_in, np.float32), 3)

    def body(rid, x):
        return json.dumps({"request_id": rid,
                           "input_data": x.tolist()}).encode()

    warm_x = image()
    inputs = [image() for _ in range(INFER_BURST)]
    bodies = [body(f"img{i}", x) for i, x in enumerate(inputs)]
    reps = {f"rep{i}": body(f"rep{i}", inputs[i]) for i in range(16)}
    same = image()
    same_bodies = {f"same{i}": body(f"same{i}", same) for i in range(8)}
    return warm_x, inputs, bodies, reps, same, same_bodies


def serve_infer_lane(torch, lane: str, single) -> dict:
    """Drive one resnet50 /infer lane over HTTP (INFER_LANES; the weights
    from seed 0): a warm-up, a burst of INFER_BURST concurrent requests
    with distinct 224 x 224 x 3 inputs, 16 repeats of them (cache hits),
    8 concurrent identical new inputs (they coalesce: fewer dispatched rows
    than requests), the reference benchmark's 3-float payload and then
    ``single`` alone. Every answer equals the lane's engine on the same
    input alone within INFER_BF16_TOL of the largest logit; the stateless
    counters balance (unified lane); /health's batch_processor block
    counts the dispatches. Returns the readings and ``single``'s output."""
    from tpu_engine_torch.serving.app import serve_worker
    from tpu_engine_torch.utils.config import WorkerConfig

    cfg = WorkerConfig(port=0, node_id=f"chip-smoke-{lane}",
                       model="resnet50", dtype="bfloat16", max_batch_size=32,
                       device="cuda", seed=0, **INFER_LANES[lane])
    t0 = time.perf_counter()
    worker, server = serve_worker(cfg)
    port = server.port
    log(f"server {lane}: resnet50 (224 x 224 x 3, bf16, max batch 32, "
        f"unified {cfg.unified_stateless}) ready in "
        f"{time.perf_counter() - t0:.1f} s on port {port}")
    warm_x, inputs, bodies, reps_bodies, same, same_bodies = infer_traffic()
    unified = cfg.unified_stateless

    def dispatched_rows():
        if unified:
            return worker.generator.stats()["stateless"]["infer_rows"]
        return worker.batch_processor.get_metrics().processed_requests

    def fire(bodies_by_name):
        res, errors, lat = {}, [], {}

        def run(name, body):
            t = time.perf_counter()
            try:
                res[name] = post(port, "/infer", body)
                lat[name] = time.perf_counter() - t
            except Exception as exc:  # reported below
                errors.append(f"{name}: {exc!r}")

        threads = [threading.Thread(target=run, args=kv)
                   for kv in bodies_by_name.items()]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t
        check(not errors and not any(th.is_alive() for th in threads),
              f"{lane}: /infer failed: {errors}")
        return res, wall, lat

    try:
        warm = post(port, "/infer", {"request_id": "warm",
                                     "input_data": warm_x.tolist()})
        check(len(warm["output_data"]) == 1000, f"{lane} warm-up")
        res, burst_s, lat = fire({f"img{i}": b for i, b in enumerate(bodies)})
        check(all(not r["cached"] for r in res.values()),
              f"{lane}: a burst input came back cached")
        reps, _, _ = fire(reps_bodies)
        check(all(r["cached"] and r["inference_time_us"] == 50
                  and r["output_data"] == res[f"img{i}"]["output_data"]
                  for i, r in ((int(k[3:]), v) for k, v in reps.items())),
              f"{lane}: repeats not served from the cache")
        rows0 = dispatched_rows()
        coalesced, _, _ = fire(same_bodies)
        rows = dispatched_rows() - rows0
        check(rows < 8 and len({json.dumps(r["output_data"])
                                for r in coalesced.values()}) == 1,
              f"{lane}: 8 identical misses dispatched {rows} rows")
        small = post(port, "/infer", {"request_id": "bench",
                                      "input_data": [1.0, 2.0, 3.0]})
        alone = post(port, "/infer", {"request_id": "single",
                                      "input_data": single.tolist()})
        health = get(port, "/health")
        stats = worker.generator.stats() if unified else None
        # Every answer against the lane's engine alone (bucket 1).
        worst = 0.0
        pairs = [(res[f"img{i}"], x) for i, x in enumerate(inputs)]
        pairs += [(coalesced["same0"], same), (small, [1.0, 2.0, 3.0]),
                  (alone, single)]
        for r, x in pairs:
            got = np.asarray(r["output_data"], np.float32)
            want = worker.engine.batch_predict([x])[0]
            check(got.shape == (1000,) and np.isfinite(got).all(),
                  f"{lane}: misshapen or non-finite output")
            worst = max(worst, float(np.abs(got - want).max()
                                     / np.abs(want).max()))
        check(worst <= INFER_BF16_TOL,
              f"{lane}: answers differ from the engine alone by {worst}")
        bp = health["batch_processor"]
        check(health["model"] == "resnet50" and "generator" not in health
              and bp["total_batches"] > 0, f"{lane} health: {health}")
        out = {"burst_s": burst_s, "images_per_s": INFER_BURST / burst_s,
               "latency_p50_s": float(np.percentile(list(lat.values()), 50)),
               "latency_max_s": max(lat.values()),
               "coalesced_rows": rows, "max_rel_err": worst,
               "health": health}
        if unified:
            sl = stats["stateless"]
            check(sl["admitted"] == sl["completed"] + sl["failed"]
                  and sl["failed"] == 0 and sl["ticks"] == sl["dispatches"]
                  and bp["total_batches"] == sl["dispatches"],
                  f"{lane}: stateless {sl} health {bp}")
            out["stateless"] = sl
        log(f"server {lane}: {INFER_BURST} concurrent /infer in "
            f"{burst_s:.3f} s ({INFER_BURST / burst_s:.1f} images/s, p50 "
            f"{out['latency_p50_s'] * 1e3:.1f} ms); 16 repeats cached; 8 "
            f"identical misses -> {rows} dispatched rows; answers vs the "
            f"engine alone max rel err {worst:.3e}; batch_processor "
            f"{json.dumps(bp)}"
            + (f"; stateless {json.dumps(out['stateless'])}" if unified
               else ""))
    finally:
        server.stop()
        worker.stop()
    torch.cuda.empty_cache()
    return out, alone["output_data"]


def phase_server(torch) -> dict:
    from tpu_engine_torch.models.convert import init_params
    from tpu_engine_torch.models.registry import create_model

    single = np.round(np.random.default_rng(6).random(224 * 224 * 3,
                                                      np.float32), 3)
    out, singles = {}, {}
    with served_conv_precision(torch):
        for lane in INFER_LANES:
            out[lane], singles[lane] = serve_infer_lane(torch, lane, single)
    check(len({json.dumps(o) for o in singles.values()}) == 1,
          "a single /infer request differs between the unified and the "
          "batch lane")
    log("server: a single request's output is bit-identical on the "
        "unified and the batch lane")
    params = init_params(create_model(cut_llama()).config, seed=0,
                         device="cuda", dtype="bfloat16")
    walls = {}
    for lane in (*LANES, *SPEC_LANES):
        t0 = time.perf_counter()
        out[lane] = (serve_dense_lane(torch, params) if lane == "dense-bf16"
                     else serve_spec_lane(torch, params, lane)
                     if lane in SPEC_LANES
                     else serve_lane(torch, params, lane))
        walls[lane] = round(time.perf_counter() - t0, 1)
    log(f"server lane walls (s): {json.dumps(walls)}")
    return out


# -- gateway phase -------------------------------------------------------------

# The reference benchmark's load (bench.py, BASELINE.md): closed-loop client
# threads, one request outstanding each; request i is "req_i" carrying the
# (i % 10)-th of ten distinct 3-float inputs.
GATEWAY_THREADS = 50
GATEWAY_REQUESTS = 2000
GATEWAY_DISTINCT = 10
HOP_SAMPLES = 200
# An /infer miss's budget against the resnet lanes' service-time
# estimates (WorkerNode.service_estimate_us), warm from the reference
# load: this share of the smallest, which must be at least
# MIN_OVERLOAD_BUDGET_US to outlive three lanes' shed round trips through
# the gateway (~2 ms each in one process).
OVERLOAD_BUDGET_SHARE = 0.8
MIN_OVERLOAD_BUDGET_US = 10000.0


def call(port: int, method: str, path: str, body=None,
         timeout: float = 120.0) -> tuple:
    """(status, body bytes, Retry-After header) of one request, whatever
    its status."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("Retry-After")
    finally:
        conn.close()


def reference_body(i: int) -> dict:
    k = i % GATEWAY_DISTINCT
    return {"request_id": f"req_{i}",
            "input_data": [float(k), float(k + 1), float(k + 2)]}


def ring_of(urls):
    """The port's ring over the gateway's lane names."""
    from tpu_engine_torch.core.consistent_hash import ConsistentHash

    ring = ConsistentHash()
    for u in urls:
        ring.add_node(u)
    return ring


def owned(ring, url: str, n: int, prefix: str) -> list:
    """``n`` request ids whose ring owner is ``url``."""
    out, i = [], 0
    while len(out) < n:
        rid = f"{prefix}{i}"
        if ring.get_node(rid) == url:
            out.append(rid)
        i += 1
    return out


def spread(ring, urls, n: int, prefix: str) -> list:
    """``n`` request ids owned by the lanes of ``urls`` in turn. The ring
    hashes ids that differ in their last characters close together, so
    a run of ``{prefix}{i}`` may fall on one lane for some ports."""
    per = [owned(ring, u, -(-n // len(urls)), prefix) for u in urls]
    return [per[k % len(urls)][k // len(urls)] for k in range(n)]


def p50_p99_ms(seconds) -> tuple:
    a = np.asarray(seconds) * 1e3
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def closed_loop(port: int, n_requests: int, n_threads: int) -> tuple:
    """The reference load against ``port``: (latencies s, failed request
    indices, wall s). Each thread keeps one keep-alive connection and
    takes the next index until ``n_requests`` are sent."""
    lock = threading.Lock()
    state = {"next": 0}
    lat, failed = [], []

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            while True:
                with lock:
                    i = state["next"]
                    state["next"] += 1
                if i >= n_requests:
                    return
                t = time.perf_counter()
                try:
                    conn.request("POST", "/infer",
                                 json.dumps(reference_body(i)),
                                 {"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    data = resp.read()
                    ok = (resp.status == 200 and json.loads(data)
                          ["request_id"] == f"req_{i}")
                except Exception:  # counted as failed
                    ok = False
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", port,
                                                      timeout=120)
                dt = time.perf_counter() - t
                with lock:
                    if ok:
                        lat.append(dt)
                    else:
                        failed.append(i)
        finally:
            conn.close()

    threads = [threading.Thread(target=client) for _ in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return lat, failed, time.perf_counter() - t0


def timed_hits(port: int, bodies) -> list:
    """Seconds of each request of ``bodies``, sent one at a time over one
    keep-alive connection; each must be a cache hit."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    out = []
    try:
        for body in bodies:
            raw = json.dumps(body)
            t = time.perf_counter()
            conn.request("POST", "/infer", raw,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            out.append(time.perf_counter() - t)
            check(resp.status == 200 and json.loads(data)["cached"],
                  f"hop timing: {resp.status} {data[:200]!r}")
    finally:
        conn.close()
    return out


def gateway_reference(torch) -> dict:
    """Three resnet50 port workers (the default WorkerConfig: bf16, seed-0
    weights) behind the port's gateway under the reference load; then
    200 cache hits one at a time, direct to their owner and through the
    gateway. Returns the readings and the fleet (left running)."""
    from tpu_engine_torch.serving.app import serve_gateway, serve_worker
    from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig

    workers, servers = [], []
    for i in range(3):
        w, s = serve_worker(WorkerConfig(port=0, node_id=f"worker_{i + 1}",
                                         device="cuda"))
        workers.append(w)
        servers.append(s)
    urls = [f"127.0.0.1:{s.port}" for s in servers]
    node = {u: w.node_id for u, w in zip(urls, workers)}
    gw, gsrv = serve_gateway(urls, GatewayConfig(port=0))
    fleet = {"workers": workers, "servers": servers, "urls": urls,
             "node": node, "gateway": gw, "gateway_server": gsrv}
    # A warm-up miss per lane on an input the load never sends.
    for s in servers:
        post(s.port, "/infer", {"request_id": "warm",
                                "input_data": [100.0, 101.0, 102.0]})
    before = {w.node_id: get(s.port, "/health")["total_requests"]
              for w, s in zip(workers, servers)}
    lat, failed, wall = closed_loop(gsrv.port, GATEWAY_REQUESTS,
                                    GATEWAY_THREADS)
    check(not failed, f"gateway reference load: {len(failed)} requests "
                      f"failed (first {failed[:5]})")
    health = {w.node_id: get(s.port, "/health")
              for w, s in zip(workers, servers)}
    split = {n: health[n]["total_requests"] - before[n] for n in health}
    ring = ring_of(urls)
    want = {node[u]: c for u, c in ring.get_distribution(
        [f"req_{i}" for i in range(GATEWAY_REQUESTS)]).items()}
    stats = get(gsrv.port, "/stats")
    check(split == want and stats["failovers"] == 0
          and stats["total_requests"] == GATEWAY_REQUESTS,
          f"gateway load split {split} != the ring's {want} "
          f"(stats {stats})")
    p50, p99 = p50_p99_ms(lat)
    rate = {n: h["cache_hit_rate"] for n, h in health.items()}
    # The hop: the same hits, direct to their owner and via the gateway,
    # in turns.
    hop_bodies = [dict(reference_body(j), request_id=f"hop_{j}")
                  for j in range(HOP_SAMPLES)]
    port_of = {u: s.port for u, s in zip(urls, servers)}
    direct, via = [], []
    for body in hop_bodies:
        owner = port_of[ring.get_node(body["request_id"])]
        direct += timed_hits(owner, [body])
        via += timed_hits(gsrv.port, [body])
    d50, d99 = p50_p99_ms(direct)
    g50, g99 = p50_p99_ms(via)
    out = {"requests": GATEWAY_REQUESTS, "threads": GATEWAY_THREADS,
           "distinct_inputs": GATEWAY_DISTINCT, "failed": len(failed),
           "wall_s": wall, "req_per_s": GATEWAY_REQUESTS / wall,
           "p50_ms": p50, "p99_ms": p99, "cache_hit_rate": rate,
           "load_split": split, "ring_split": want,
           "direct_hit_p50_ms": d50, "direct_hit_p99_ms": d99,
           "gateway_hit_p50_ms": g50, "gateway_hit_p99_ms": g99,
           "hop_p50_ms": g50 - d50, "hop_p99_ms": g99 - d99}
    log(f"gateway reference: 3 resnet50 workers (bf16), {GATEWAY_REQUESTS} "
        f"/infer from {GATEWAY_THREADS} closed-loop threads over "
        f"{GATEWAY_DISTINCT} distinct 3-float inputs: {out['req_per_s']:.1f}"
        f" req/s, p50 {p50:.3f} ms, p99 {p99:.3f} ms, 0 failed; cache hit "
        f"rate {json.dumps(rate)}; load split {json.dumps(split)} == the "
        f"ring's; {HOP_SAMPLES} hits one at a time: direct p50 {d50:.3f} / "
        f"p99 {d99:.3f} ms, via the gateway p50 {g50:.3f} / p99 {g99:.3f} "
        f"ms, the hop +{g50 - d50:.3f} / +{g99 - d99:.3f} ms")
    return out, fleet


def gateway_generation(torch, params) -> tuple:
    """Two mixed-bf16 lanes (TinyLlama geometry, one weight tree) behind
    a gateway with a 1 s breaker timeout: 16 streams, 8 /generate and 8
    decoder /infer at once, each answered by its request_id's ring owner;
    then four streams one at a time, through the gateway and direct to
    the owner, token-identical. Returns the readings and the fleet."""
    from tpu_engine_torch.serving.app import serve_gateway
    from tpu_engine_torch.utils.config import GatewayConfig

    workers, servers = [], []
    for i in range(2):
        w, s = start_lane(torch, params, "mixed-bf16", cut_llama(),
                          node_id=f"gen_{i}")
        workers.append(w)
        servers.append(s)
    urls = [f"127.0.0.1:{s.port}" for s in servers]
    node = {u: w.node_id for u, w in zip(urls, workers)}
    gw, gsrv = serve_gateway(urls, GatewayConfig(port=0,
                                                 breaker_timeout_s=1.0))
    fleet = {"workers": workers, "servers": servers, "urls": urls,
             "node": node, "gateway": gw, "gateway_server": gsrv}
    ring = ring_of(urls)
    vocab = workers[0].generator.cfg.vocab
    rng = np.random.default_rng(3)

    def toks(n):
        return [int(t) for t in rng.integers(1, vocab, n)]

    # Every lane owns a share of each kind, so both run mixed ticks.
    streams = {n: toks(int(rng.integers(8, 300)))
               for n in spread(ring, urls, 16, "gs")}
    gens = {n: toks(int(rng.integers(8, 300)))
            for n in spread(ring, urls, 8, "gg")}
    infers = {n: [float(t) for t in toks(int(rng.integers(4, 128)))]
              for n in spread(ring, urls, 8, "gi")}
    results, errors = {}, []

    def run(name, fn):
        try:
            results[name] = fn()
        except Exception as exc:  # reported below
            errors.append(f"{name}: {exc!r}")

    jobs = [(n, lambda n=n, p=p: stream(gsrv.port, {
        "request_id": n, "prompt_tokens": p, "max_new_tokens": MAX_NEW}))
        for n, p in streams.items()]
    jobs += [(n, lambda n=n, p=p: post(gsrv.port, "/generate", {
        "request_id": n, "prompt_tokens": p, "max_new_tokens": MAX_NEW}))
        for n, p in gens.items()]
    jobs += [(n, lambda n=n, x=x: post(gsrv.port, "/infer", {
        "request_id": n, "input_data": x})) for n, x in infers.items()]
    threads = [threading.Thread(target=run, args=j) for j in jobs]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    burst_s = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads),
          f"gateway generation burst failed: {errors}")
    for name in streams:
        toks_, final, _ttft = results[name]
        check(final is not None and "error" not in final
              and final["tokens"] == toks_ and len(toks_) == MAX_NEW,
              f"gateway stream {name}: {final}")
    for name in gens:
        check(len(results[name]["tokens"]) == MAX_NEW,
              f"gateway /generate {name}: {results[name]}")
    for name in infers:
        got = np.asarray(results[name]["output_data"], np.float32)
        check(got.shape == (vocab,) and np.isfinite(got).all(),
              f"gateway /infer {name}: {got.shape}")

    def served_by(name):
        res = results[name]
        return (res[1] if name in streams else res)["node_id"]

    misplaced = [n for n in results if served_by(n) != node[ring.get_node(n)]]
    check(not misplaced, f"gateway: answered off their ring owner: "
                         f"{misplaced}")
    split = {n: sum(served_by(r) == n for r in results)
             for n in node.values()}
    # Four streams one at a time, each after a warm run of its prompt on
    # its owner, so both compared runs resume from the same prefix hit.
    port_of = {u: s.port for u, s in zip(urls, servers)}
    solos = []
    for i in range(4):
        rid, prompt = f"solo{i}", toks(40 + 37 * i)
        body = {"request_id": rid, "prompt_tokens": prompt,
                "max_new_tokens": MAX_NEW}
        owner = port_of[ring.get_node(rid)]
        stream(owner, body)
        via = stream(gsrv.port, body)[0]
        direct = stream(owner, body)[0]
        check(via == direct and len(via) == MAX_NEW,
              f"gateway stream {rid}: {via} != direct {direct}")
        solos.append(node[ring.get_node(rid)])
    out = {"streams": len(streams), "generates": len(gens),
           "infers": len(infers), "burst_s": burst_s, "split": split,
           "solo_owners": solos}
    log(f"gateway generation: 2 mixed-bf16 lanes (TinyLlama geometry), "
        f"{len(streams)} streams + {len(gens)} /generate + {len(infers)} "
        f"decoder /infer through the gateway in {burst_s:.3f} s, each "
        f"answered by its ring owner (split {json.dumps(split)}); 4 streams "
        f"one at a time identical via the gateway and direct (owners "
        f"{solos})")
    return out, fleet


def breaker_of(port: int, url: str) -> dict:
    stats = get(port, "/stats")
    return next(b for b in stats["circuit_breakers"] if b["node"] == url)


def gateway_faults(gen: dict, ref: dict) -> dict:
    """On the generation fleet: a stopped server's requests fail over and
    its breaker opens after 5 failures, a server restarted on the same
    port heals it (1 s timeout, two successes), a drained lane's requests
    fail over with no penalty and count as shed_draining, an expired
    deadline is a 503 that no worker counts. On the resnet fleet: a miss
    whose budget is below every lane's warm service-time estimate is a 503
    overloaded from every lane."""
    from tpu_engine_torch.serving.app import worker_server

    workers, servers, urls = gen["workers"], gen["servers"], gen["urls"]
    node, gport = gen["node"], gen["gateway_server"].port
    ring = ring_of(urls)
    victim, heir = urls[0], urls[1]
    vport = servers[0].port
    rids = owned(ring, victim, 10, "fault")
    body = {"input_data": [5.0, 6.0, 7.0]}

    def via(rid):
        return post(gport, "/infer", dict(body, request_id=rid))["node_id"]

    out = {}
    f0 = get(gport, "/stats")["failovers"]
    servers[0].stop()
    try:
        served = [via(r) for r in rids[:5]]
        br = breaker_of(gport, victim)
        failovers = get(gport, "/stats")["failovers"] - f0
        check(served == [node[heir]] * 5 and br["state"] == "OPEN"
              and br["failures"] == 5 and failovers == 5,
              f"gateway fault: served {served}, breaker {br}, failovers "
              f"{failovers}")
    finally:
        servers[0] = worker_server(workers[0], vport)
        servers[0].start()
    time.sleep(1.05)  # past the breaker's 1 s timeout
    heal = []
    for rid in rids[5:7]:
        check(via(rid) == node[victim], f"gateway heal: {rid} not served "
                                        f"by its owner")
        heal.append(breaker_of(gport, victim)["state"])
    check(heal == ["HALF_OPEN", "CLOSED"], f"gateway heal: {heal}")
    out["breaker"] = {"tripped_after": 5, "heal": heal}

    def shed_draining():
        return get(vport, "/health").get("admission", {}).get(
            "shed_draining", 0)

    d0 = shed_draining()
    check(post(vport, "/admin/drain", {"action": "drain"})["status"]
          == "draining", "gateway drain refused")
    try:
        served = [via(r) for r in rids[7:10]]
        br = breaker_of(gport, victim)
        drain_sheds = shed_draining() - d0
        check(served == [node[heir]] * 3 and br["state"] == "CLOSED"
              and br["failures"] == 0 and drain_sheds == 3,
              f"gateway drain: served {served}, breaker {br}, "
              f"shed_draining +{drain_sheds}")
    finally:
        undrain = post(vport, "/admin/drain", {"action": "undrain"})
    check(undrain["status"] == "undrained", f"gateway undrain: {undrain}")
    out["drain"] = {"failed_over": 3, "shed_draining": drain_sheds}

    totals = [get(s.port, "/health")["total_requests"] for s in servers]
    status, raw, _ = call(gport, "POST", "/infer",
                       dict(body, request_id="late", deadline_ms=0))
    after = [get(s.port, "/health")["total_requests"] for s in servers]
    check(status == 503 and json.loads(raw)["kind"] == "deadline_exceeded"
          and after == totals,
          f"gateway expired deadline: {status} {raw!r}, totals {totals} -> "
          f"{after}")
    out["expired"] = {"status": status, "kind": "deadline_exceeded"}

    # A miss below every resnet lane's estimate, warm from the reference
    # load.
    est_us = [w.service_estimate_us for w in ref["workers"]]
    check(all(e is not None for e in est_us)
          and OVERLOAD_BUDGET_SHARE * min(est_us) >= MIN_OVERLOAD_BUDGET_US,
          f"resnet lanes' service-time estimates {est_us} us leave no "
          f"budget of {MIN_OVERLOAD_BUDGET_US} us under them")
    budget_ms = OVERLOAD_BUDGET_SHARE * min(est_us) / 1e3

    def shed_deadline(s):
        return get(s.port, "/health").get("admission", {}).get(
            "shed_deadline", 0)

    s0 = [shed_deadline(s) for s in ref["servers"]]
    status, raw, _ = call(ref["gateway_server"].port, "POST", "/infer", {
        "request_id": "tight", "input_data": [77.0, 78.0, 79.0],
        "deadline_ms": budget_ms})
    lane_sheds = [shed_deadline(s) - b for s, b in zip(ref["servers"], s0)]
    check(status == 503 and json.loads(raw)["kind"] == "overloaded"
          and lane_sheds == [1, 1, 1],
          f"gateway overload: {status} {raw!r}, lanes shed {lane_sheds}, "
          f"budget {budget_ms:.3f} ms, estimates {est_us} us")
    out["overloaded"] = {"budget_ms": budget_ms, "estimates_us": est_us,
                         "lanes_shed": lane_sheds}
    log(f"gateway faults: a stopped lane's 5 requests failed over to "
        f"{node[heir]}, its breaker OPEN after 5 failures, healed "
        f"{' -> '.join(heal)} after 1 s; a drained lane's 3 requests failed "
        f"over with no breaker penalty (shed_draining +{drain_sheds}); an "
        f"expired deadline 503 deadline_exceeded with no worker counting "
        f"it; a {budget_ms:.3f} ms budget under the resnet lanes' estimates "
        f"{[round(e) for e in est_us]} us: 503 overloaded, shed by all 3")
    return out


def gateway_cli(gen: dict) -> dict:
    """The gateway command as a process in front of the generation
    fleet: one /infer and one /generate through it, then SIGTERM."""
    import signal
    import socket

    urls = gen["urls"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = popen(
        [sys.executable, "-m", "tpu_engine_torch.serving.cli", "gateway",
         *urls, "--port", str(port)], cwd=str(Path(__file__).resolve()
                                             .parent),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while True:
            try:
                check(get(port, "/stats")["total_workers"] == 2,
                      "gateway command: lanes")
                break
            except (OSError, http.client.HTTPException):
                check(proc.poll() is None and time.perf_counter() - t0 < 120,
                      f"gateway command did not start: {proc.poll()}")
                time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        ring = ring_of(urls)
        inf = post(port, "/infer", {"request_id": "cli-i",
                                    "input_data": [3.0, 4.0, 5.0]})
        gen_ = post(port, "/generate", {"request_id": "cli-g",
                                        "prompt_tokens": [1, 2, 3, 4],
                                        "max_new_tokens": 8})
        check(inf["node_id"] == gen["node"][ring.get_node("cli-i")]
              and gen_["node_id"] == gen["node"][ring.get_node("cli-g")]
              and len(gen_["tokens"]) == 8,
              f"gateway command: {inf['node_id']} {gen_}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        stdout = proc.stdout.read()
        check(rc == 0 and "Ready!" in stdout,
              f"gateway command exited {rc}: {stdout[-500:]} "
              f"{proc.stderr.read()[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    log(f"gateway command: `python -m tpu_engine_torch.serving.cli gateway "
        f"{' '.join(urls)} --port {port}` up in {ready_s:.1f} s, served "
        f"one /infer and one /generate, exited 0 on SIGTERM")
    return {"ready_s": ready_s, "rc": rc}


def stop_fleet(fleet: dict) -> None:
    fleet["gateway_server"].stop()
    for w, s in zip(fleet["workers"], fleet["servers"]):
        s.stop()
        w.stop()


def phase_gateway(torch) -> dict:
    """The port's gateway in front of port workers on the card: the
    reference deployment under the reference load, generation through a
    gateway (the ragged kernel's and the one-shot rows' flash launches
    counted from 0 over the phase and read at its end), faults, and the
    gateway command."""
    from tpu_engine_torch.models.convert import init_params
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.ops import kernels

    ref = gen = None
    try:
        with served_conv_precision(torch):
            reference, ref = gateway_reference(torch)
            params = init_params(create_model(cut_llama()).config,
                                 seed=0, device="cuda", dtype="bfloat16")
            kernels.reset_counts()  # the phase: counts from 0, read at end
            generation, gen = gateway_generation(torch, params)
            faults = gateway_faults(gen, ref)
            cli_run = gateway_cli(gen)
        idle = [wait_idle(s.port, paged=True) for s in gen["servers"]]
        check(all(ok for _, ok in idle),
              f"gateway lanes not idle or blocks leaked: {idle}")
        ragged = check_counts("gateway", "ragged_paged_attention",
                              also=("flash_attention",))
        flash = launch_counts()["flash_attention"][0]
        n_layers = gen["workers"][0].generator.cfg.n_layers
        mixed = [st["mixed"] for st, _ in idle]
        oneshot = [st["stateless"]["dispatches"] for st, _ in idle]
        check(all(m["ticks"] == m["dispatches"] > 0 for m in mixed)
              and ragged == n_layers * sum(m["dispatches"] for m in mixed)
              and flash == n_layers * sum(oneshot) and sum(oneshot) > 0,
              f"gateway: {ragged} ragged launches for mixed {mixed}, "
              f"{flash} flash launches for one-shot dispatches {oneshot}, "
              f"of {n_layers} layers")
        log(f"gateway: ragged_paged_attention launches {ragged} == "
            f"{n_layers} x {sum(m['dispatches'] for m in mixed)} mixed "
            f"ticks, flash_attention {flash} == {n_layers} x {sum(oneshot)} "
            f"one-shot dispatches, plain calls 0")
    finally:
        for fleet in (gen, ref):
            if fleet is not None:
                stop_fleet(fleet)
        torch.cuda.empty_cache()
    return {"reference": reference, "generation": generation,
            "faults": faults, "cli": cli_run,
            "launches": {"ragged_paged_attention": ragged,
                         "flash_attention": flash},
            "mixed_ticks": [m["ticks"] for m in mixed],
            "oneshot_dispatches": oneshot}


# -- kvtier phase -------------------------------------------------------------

# The host KV tier and the KV chain wire format at TinyLlama geometry.
# PCIe Gen5 x16's nominal rate in each direction: the bound of a host-tier
# copy (the phase also measures one large pinned copy's rate).
PCIE_BYTES_PER_S = 64e9
KVTIER_BLOCKS = 64            # a 1024-token prefix of 16-token blocks
KVTIER_PROMPTS = 6
KVTIER_PROMPT_LEN = 1024
KVTIER_TAIL = 32
KVTIER_MAX_NEW = 16
# The tiered workers' pool: 192 device blocks (three 1024-token prompts'
# worth) over a 512-block host tier; their controls take the auto pool
# (8 rows x 128 blocks + the null block) and no tier.
KVTIER_TIER = dict(gen_kv_blocks=192, gen_kv_host_blocks=512)
KVTIER_LANES = {
    "kvtier-mixed-bf16": ("ragged_paged_attention", "mixed-bf16"),
    "kvtier-two-path-int8": ("quant_paged_attention", "two-path-int8"),
}
MIGRATE_MAX_NEW = 64
MIGRATE_AT = 16


def sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def pinned_copy_rates(torch, nbytes: int = 256 << 20) -> dict:
    """One large pinned copy's rate in each direction (GB/s, events over
    five copies): the practical roof of the host tier's copies."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    out = {}
    for name, dst, src in (("h2d", card, host), ("d2h", host, card)):
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(5):
            dst.copy_(src, non_blocking=True)
        e1.record()
        e1.synchronize()
        out[name + "_gb_s"] = 5 * nbytes / (e0.elapsed_time(e1) / 1e3) / 1e9
    return out


def kvtier_pool(torch, params, cfg, dev="cuda",
                card: str = "") -> dict:
    """Pool-level round trips at the main path's geometry: a 64-block
    prefix of random data demoted to a 64-block host tier and promoted
    back (bf16, and int8 with its scales), each held with torch.equal;
    the chain exported and imported into a second pool, bit-exact; the
    copies timed beside their PCIe bound, and (bf16) the 64-block swap-in
    beside the device time of recomputing that prefix's prefill in the
    mixed lane's four 256-token ticks."""
    from tpu_engine_torch.runtime.kv_blocks import BlockPool

    n, bs = KVTIER_BLOCKS, 16
    toks = list(range(1, n * bs + 1))
    out = {}
    for quant in ("", "int8"):
        key = "int8" if quant else "bf16"
        src, dst = (BlockPool(cfg, 2 * n + 1, bs, torch.bfloat16, dev,
                              host_blocks=n, quantize=quant)
                    for _ in range(2))
        check(all(h.is_pinned() for h in src._host)
              == (torch.device(dev).type == "cuda"),
              f"kvtier pool {key}: host tier not pinned")
        gen = torch.Generator(device=dev).manual_seed(0)
        with src.lock:
            ids = src.alloc(n)
            idx = torch.tensor(ids, device=dev)
            for t in src._pool_tensors():
                shape = (t.shape[0], n) + tuple(t.shape[2:])
                if t.dtype == torch.int8:
                    vals = torch.randint(-127, 128, shape, device=dev,
                                         generator=gen, dtype=torch.int8)
                elif t.dtype == torch.float32:  # int8 scales: positive
                    vals = torch.rand(shape, device=dev, generator=gen) + 0.01
                else:
                    vals = torch.randn(shape, device=dev, generator=gen,
                                       dtype=t.dtype)
                t[:, idx] = vals
            want = [t[:, idx].clone() for t in src._pool_tensors()]
            src.radix.insert(toks, ids)
            src.release_many(ids)
            sync(torch, dev)
            t0 = time.perf_counter()
            demoted = src.radix.evict(n)
            sync(torch, dev)
            demote_ms = (time.perf_counter() - t0) * 1e3
            check(demoted == n == src.demotions,
                  f"kvtier pool {key}: {demoted} of {n} blocks demoted")
            for t in src._pool_tensors():  # the bytes must come back
                t[:, idx] = 0
            sync(torch, dev)
            t0 = time.perf_counter()
            got = src.radix.lookup(toks, promote_reserve=0)
            sync(torch, dev)
            promote_ms = (time.perf_counter() - t0) * 1e3
            gidx = torch.tensor(got, device=dev)
            check(len(got) == n == src.swap_ins
                  and src.swap_in_deferred == 0,
                  f"kvtier pool {key}: {src.stats()['host']}")
            check(all(torch.equal(t[:, gidx], w)
                      for t, w in zip(src._pool_tensors(), want)),
                  f"kvtier pool {key}: demote/promote not bit-exact")
            t0 = time.perf_counter()
            chain = src.export_chain(got)
            export_ms = (time.perf_counter() - t0) * 1e3
        wire = len(json.dumps(chain))
        with dst.lock:
            check(dst.chain_compatible(chain) is None
                  and dst.verify_chain(chain),
                  f"kvtier pool {key}: chain refused")
            dids = dst.alloc(n)
            sync(torch, dev)
            t0 = time.perf_counter()
            dst.import_chain(chain, chain["blocks"], dids)
            sync(torch, dev)
            import_ms = (time.perf_counter() - t0) * 1e3
            didx = torch.tensor(dids, device=dev)
            check(all(torch.equal(t[:, didx], w)
                      for t, w in zip(dst._pool_tensors(), want)),
                  f"kvtier pool {key}: chain round trip not bit-exact")
        bpb = src.bytes_per_block()
        res = {"bytes_per_block": bpb, "blocks": n,
               "demote_ms_per_block": demote_ms / n,
               "promote_ms_per_block": promote_ms / n,
               "swap_in_ms": promote_ms,
               "bound_ms_per_block": bpb / PCIE_BYTES_PER_S * 1e3,
               "export_ms": export_ms, "import_ms": import_ms,
               "wire_bytes": wire, "raw_bytes": n * bpb}
        if not quant:
            res.update(recompute_prefill(torch, params, cfg, src, gidx, dev))
        out[key] = res
        line = (f"kvtier pool {key}: {n} blocks of {bpb} B demoted "
                f"{res['demote_ms_per_block']:.5f} ms/block (D2H) and "
                f"promoted {res['promote_ms_per_block']:.5f} ms/block "
                f"(H2D), bound {res['bound_ms_per_block']:.5f} ms/block at "
                f"64 GB/s; swap-in of the {n}-block prefix {promote_ms:.3f}"
                f" ms")
        if not quant:
            busy = res["recompute_busy_ms"]
            line += (" vs recomputing its prefill "
                     + ("(device busy not measured)" if busy is None
                        else f"{busy:.3f} ms device busy")
                     + f" ({res['recompute_ms']:.3f} ms events, 4 ticks of "
                     f"W = 256)")
        log(line + f"; chain export {export_ms:.3f} ms, import "
            f"{import_ms:.3f} ms, wire {wire} B for {n * bpb} B raw "
            f"({wire / (n * bpb):.4f}x); round trips bit-exact [{card}]")
        src.release_many(got)
    return out


def recompute_prefill(torch, params, cfg, pool, blocks, dev) -> dict:
    """Device time of recomputing a 64-block prefix as the mixed lane
    prefills it: four ticks of W = 256 over 8 rows, one of them taking
    256 prompt tokens a tick into ``blocks``."""
    from tpu_engine_torch.models.transformer import \
        transformer_step_rows_ragged

    b, w = 8, min(256, len(blocks) * 16)
    tables = torch.zeros((b, cfg.max_seq // 16), dtype=torch.int32,
                         device=dev)
    tables[0, :len(blocks)] = blocks.to(torch.int32)
    tokens = torch.randint(1, cfg.vocab, (b, w), dtype=torch.int32,
                           device=dev)
    qlen = torch.zeros((b,), dtype=torch.int32, device=dev)
    qlen[0] = w
    slot = torch.zeros((b,), dtype=torch.int32, device=dev)
    slot[0] = w - 1
    pos0s = []
    for c in range(len(blocks) * 16 // w):
        p = torch.zeros((b,), dtype=torch.int32, device=dev)
        p[0] = c * w
        pos0s.append(p)

    def prefill():
        for p in pos0s:
            logits = transformer_step_rows_ragged(
                params, tokens, pool.caches, tables, p, qlen, cfg,
                dtype=torch.bfloat16, sample_slot=slot)[0]
        return logits

    check(bool(torch.isfinite(prefill()).all()),
          "kvtier recompute: non-finite logits")
    return {"recompute_ms": time_ms(torch, prefill, iters=5),
            "recompute_busy_ms": busy_ms(torch, prefill)}


def kvtier_prompts(vocab: int) -> list:
    """Six distinct 1024-token prompts, then each with a new 32-token
    tail."""
    rng = np.random.default_rng(12)
    first = [[int(t) for t in rng.integers(1, vocab, KVTIER_PROMPT_LEN)]
             for _ in range(KVTIER_PROMPTS)]
    return first + [p + [int(t) for t in rng.integers(1, vocab, KVTIER_TAIL)]
                    for p in first]


def kvtier_lane(torch, params, lane: str, tier: bool) -> dict:
    """One worker of ``lane`` (with the host tier, or its control) served
    the kvtier prompts one at a time, the launch counts set to 0 before
    and read after."""
    from tpu_engine_torch.ops import kernels

    kernel, base = KVTIER_LANES[lane]
    overrides = dict(LANES[base], **(KVTIER_TIER if tier else {}))
    name = lane if tier else lane + "-control"
    worker, server = start_lane(torch, params, name, cut_llama(),
                                overrides=overrides)
    port = server.port
    try:
        n_layers = worker.generator.cfg.n_layers
        prompts = kvtier_prompts(worker.generator.cfg.vocab)
        kernels.reset_counts()
        t0 = time.perf_counter()
        toks = [post(port, "/generate", {
            "request_id": f"{name}-{i}", "prompt_tokens": p,
            "max_new_tokens": KVTIER_MAX_NEW})["tokens"]
            for i, p in enumerate(prompts)]
        seconds = time.perf_counter() - t0
        st, idle = wait_idle(port, paged=True)
        launches = check_counts(name, kernel)
        check(idle, f"{name}: not idle or blocks leaked: {st['kv_pool']}")
        check(all(len(t) == KVTIER_MAX_NEW for t in toks),
              f"{name}: short streams {[len(t) for t in toks]}")
        if overrides.get("gen_mixed_step"):
            steps = st["mixed"]["dispatches"]
            check(st["mixed"]["ticks"] == steps > 0
                  and launches == n_layers * steps,
                  f"{name}: {launches} launches for mixed {st['mixed']}")
        else:
            steps = st["chunks"] * overrides["gen_step_chunk"]
            check(steps > 0 and launches == n_layers * steps,
                  f"{name}: {launches} launches for {st['chunks']} chunks")
        return {"tokens": toks, "pool": st["kv_pool"], "kernel": kernel,
                "launches": launches, "steps": steps, "seconds": seconds}
    finally:
        server.stop()
        worker.stop()


def stream_migrate(port: int, body: dict, at: int, action) -> tuple:
    """POST /generate/stream and call ``action()`` once ``at`` tokens have
    streamed; returns (tokens, terminal event)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    toks, final, fired = [], None, False
    try:
        conn.request("POST", "/generate/stream", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        check(resp.status == 200, f"stream answered {resp.status}")
        buf = b""
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                frame, buf = buf.split(b"\n\n", 1)
                ev = json.loads(frame[len(b"data: "):])
                if ev.get("done"):
                    final = ev
                    continue
                toks.extend(ev["tokens"])
                if action is not None and not fired and len(toks) >= at:
                    fired = True
                    action()
    finally:
        conn.close()
    return toks, final


def kvtier_migration(torch, params, lane: str, card: str = "") -> dict:
    """A live row migrated between two workers of ``lane``: a greedy
    64-token stream from a 1024-token prompt alone on A, exported by
    /admin/migrate after >= 16 tokens and continued on B by
    migrate_import, against the same request's uninterrupted run alone on
    A (run first, twice: the second resumes from the first's radix hit,
    as the migrated run does)."""
    _kernel, base = KVTIER_LANES[lane]
    workers = [start_lane(torch, params, f"{lane}-migrate-{x}",
                          cut_llama(), overrides=LANES[base])
               for x in "AB"]
    (wa, sa), (wb, sb) = workers
    try:
        prompt = [int(t) for t in np.random.default_rng(13).integers(
            1, wa.generator.cfg.vocab, KVTIER_PROMPT_LEN)]
        body = {"prompt_tokens": prompt, "max_new_tokens": MIGRATE_MAX_NEW}
        runs = [post(sa.port, "/generate", dict(body, request_id=f"ctl{i}"))
                ["tokens"] for i in range(2)]
        want = runs[1]
        pool_b = generator_stats(sb.port)["kv_pool"]
        snap, rt = {}, []

        def migrate():
            t0 = time.perf_counter()
            snap.update(post(sa.port, "/admin/migrate",
                             {"request_id": "mig"}))
            rt.append((time.perf_counter() - t0) * 1e3)

        got, final = stream_migrate(sa.port, dict(body, request_id="mig"),
                                    MIGRATE_AT, migrate)
        check(snap.get("ok") and final is not None and final.get("migrated")
              and final["tokens_emitted"] == len(got) == snap["streamed"]
              and len(got) >= MIGRATE_AT,
              f"{lane} migrate: {snap.get('reason')} {final}")
        cont, done = stream_migrate(sb.port, {
            "request_id": "mig-b", "prompt_tokens": [],
            "migrate_import": snap}, 0, None)
        check(done is not None and "error" not in done,
              f"{lane} migrate_import: {done}")
        st_b, idle_b = wait_idle(sb.port, paged=True)
        st_a, idle_a = wait_idle(sa.port, paged=True)
        n_chain = len(snap["chain"]["blocks"])
        mig = st_b["migration"]
        check(got + cont == want and done["tokens"] == want,
              f"{lane} migrated stream differs: {got} + {cont} vs {want}")
        check(st_b["kv_pool"]["prefilled_tokens"]
              == pool_b["prefilled_tokens"],
              f"{lane}: the importing worker prefilled "
              f"{st_b['kv_pool']['prefilled_tokens']} tokens")
        check(mig["imported_chain_tokens"] == 16 * n_chain
              and mig["imported_rows"] == 1,
              f"{lane}: imported {mig} for a {n_chain}-block chain")
        check(idle_a and idle_b, f"{lane} migrate: blocks leaked "
                                 f"{st_a['kv_pool']} {st_b['kv_pool']}")
        res = {"streamed_before": len(got), "chain_blocks": n_chain,
               "wire_bytes": len(json.dumps(snap["chain"])),
               "migrate_ms": rt[0], "cold_equals_warm": runs[0] == runs[1],
               "exported": st_a["migration"], "imported": mig}
        log(f"kvtier migrate {lane}: {len(got)} tokens on A, /admin/migrate "
            f"{rt[0]:.3f} ms round trip ({n_chain} blocks, "
            f"{res['wire_bytes']} B of chain), {len(cont)} more on B "
            f"token-identical to the uninterrupted run; B prefilled 0 "
            f"tokens, imported_chain_tokens {mig['imported_chain_tokens']} "
            f"== 16 x {n_chain}; no block leaked [{card}]")
        return res
    finally:
        for w, s in workers:
            s.stop()
            w.stop()


def phase_kvtier(torch, card: str) -> dict:
    """The host KV tier and the chain wire format on the card at TinyLlama
    geometry (bf16 weights from seed 0, 16-token blocks): the pool's round
    trips and copy times, a mixed-bf16 and a two-path-int8 worker with a
    host tier against untiered controls, and a live row migrated between
    two workers of each. Each reading's line ends with ``card`` (the
    card's name and power limit)."""
    from tpu_engine_torch.models.convert import init_params
    from tpu_engine_torch.models.registry import create_model

    cfg = create_model("llama").config
    params = init_params(cfg, seed=0, device="cuda", dtype="bfloat16")
    out = {"pinned_copy": pinned_copy_rates(torch)}
    log(f"kvtier: one 256 MiB pinned copy "
        f"{out['pinned_copy']['h2d_gb_s']:.2f} GB/s H2D, "
        f"{out['pinned_copy']['d2h_gb_s']:.2f} GB/s D2H [{card}]")
    out["pool"] = kvtier_pool(torch, params, cfg, card=card)
    del params
    params = init_params(create_model(cut_llama()).config, seed=0,
                         device="cuda", dtype="bfloat16")
    for lane in KVTIER_LANES:
        tiered = kvtier_lane(torch, params, lane, tier=True)
        control = kvtier_lane(torch, params, lane, tier=False)
        tp, cp = tiered["pool"], control["pool"]
        host = tp["host"]
        check(tiered["tokens"] == control["tokens"],
              f"{lane}: streams differ from the control's")
        check(tp["prefix_hit_tokens"] == cp["prefix_hit_tokens"] > 0
              and tp["prefilled_tokens"] == cp["prefilled_tokens"],
              f"{lane}: tier {tp} vs control {cp}")
        check(host["swap_ins"] > 0 and host["swap_in_deferred"] == 0
              and host["host_evictions"] == 0
              and host.get("scale_slots_leaked", 0) == 0,
              f"{lane}: host tier {host}")
        log(f"kvtier {lane}: {len(tiered['tokens'])} requests (6 x 1024 "
            f"tokens, then each + 32) token-identical to the control "
            f"(auto pool, no tier); prefix hit {tp['prefix_hit_tokens']} "
            f"and prefilled {tp['prefilled_tokens']} tokens == the "
            f"control's; host {host}; {tiered['kernel']} launches "
            f"{tiered['launches']} == {CUT_LAYERS} x "
            f"{tiered['steps']} (control "
            f"{control['launches']}); {tiered['seconds']:.3f} s vs "
            f"{control['seconds']:.3f} s [{card}]")
        out[lane] = {"tiered": tiered, "control": control}
        out[lane + "-migrate"] = kvtier_migration(torch, params, lane, card)
    torch.cuda.empty_cache()
    return out


# -- refmodels phase -----------------------------------------------------------
#
# The reference's other /infer deployments (BASELINE.json configs 1-4):
# bert (BERT-base-squad, variable sequence lengths, the result LRU),
# yolov8n with shape buckets (mixed input shapes), a raw ONNX graph served
# by the reference's command line, and HF checkpoints with /admin/reload.

BERT_SEQ = 384
BERT_HEADS, BERT_D = 12, 64
BERT_LAYERS = 12
# The bert lane (bf16) against the same forward with the flash kernel's
# plain version on the card, as max |diff| over the burst. The kernel and
# the plain version differ in their f32 sums' last bits (~1e-6), and in
# bf16 any such difference flips some residual-stream roundings at the
# blocks' ends: with random weights from seed 0 the logits are small
# (max ~0.2-0.7, the final hidden states' large entries cancel in the QA
# head), and the plain forward in bf16 itself differs from the f32 forward
# by 3-15% of them, on the card and on the CPU alike (measured). So the
# bound is stated against bf16's own error: the lane may differ from the
# plain bf16 forward by at most BERT_BF16_FACTOR x the largest difference
# between the plain bf16 and the plain f32 forward (measured: 1.3x); a
# wrong mask or a wrong row differs by the order of the logits themselves.
# The same burst through a worker in f32 (f32 weights, TF32 off; its
# ticks, rows and padding as the bf16 lane's) against the plain f32
# forward is held to BERT_F32_TOL of each request's largest logit (the f32
# sums' order only; card vs CPU read 1e-5).
BERT_BF16_FACTOR = 3.0
BERT_F32_TOL = 1e-4
YOLO_SIZES = (320, 480, 640)
# 1 request a bucket (16 before the observe phase came, 8 before the
# combined phase, 4 before the tp phase, 2 before the seqpar phase, cut
# for the smoke's time: a 640 answer is 9 MB of JSON to encode on the
# host).
YOLO_REQUESTS = 3
YOLO_HEAD = 144
# The yolov8n lane (bf16: every conv's operands rounded to bf16, f32
# sums) against the plain f32 forward of each request's canvas on the same
# weights (TF32 off), as max|diff| / max|ref| per request: bf16's own error, which depends on the
# random weights (the card draws other numbers than the CPU; the bert
# lane's bf16 reads 3-15% at seed 0). Measured on the CPU's weights at 320
# and 480 on such inputs: up to 8.4e-3; a wrong padding, canvas, crop or
# bucket differs by the order of the maps themselves (1).
YOLO_TOL = 1e-1
# The same burst through a worker in f32 (f32 wire, TF32 off) against the
# plain f32 forward, as above: the f32 sums' order only, so a wrong row,
# bucket or canvas shows at the order of the maps.
YOLO_F32_TOL = 1e-4
# The ONNX ResNet-50 v2 worker (the reference's command line: bf16, the
# port's default) against the port's executor on the CPU in f32 on the same
# graph, as max|diff| / max|ref|: bf16 operands in every conv and the
# Gemm through 53 layers. Measured on the CPU (the worker in bf16 against
# the executor in f32, these inputs): 3.8e-3.
ONNX_TOL = 3e-2
# The gpt2 HF checkpoints of the reload check: HF's geometry at 4 of its 12
# layers (cut for the smoke's time before the seqpar phase: two checkpoints
# written and loaded; the importers read the depth from config.json).
GPT2_HF = dict(vocab_size=50257, n_layer=4, n_embd=768, n_head=12,
               n_positions=1024)


def concurrent_posts(port: int, path: str, bodies: dict) -> tuple:
    """POST every body of ``bodies`` (name -> dict) at once; returns
    (answers by name, the burst's seconds)."""
    res, errors = {}, []

    def run(name, body):
        try:
            res[name] = post(port, path, body)
        except Exception as exc:  # reported below
            errors.append(f"{name}: {exc!r}")

    threads = [threading.Thread(target=run, args=kv)
               for kv in bodies.items()]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not errors and not any(th.is_alive() for th in threads),
          f"{path}: requests failed: {errors}")
    return res, wall


def forward_reading(torch, key: str, fwd, card: str, share=None) -> dict:
    """One forward's ms (events, cold L2), the host's time to issue it,
    the card's busy time in it and the idle share; ``share``: (kernel
    name, launches, device ms of one launch) for the kernel's part."""
    ms = time_ms(torch, fwd, iters=10)
    host = issue_ms(torch, fwd)
    busy = busy_ms(torch, fwd)
    res = {"forward_ms": ms, "issue_ms": host, "busy_ms": busy,
           "idle_share": idle_share(busy, ms)}
    line = (f"refmodels forward ({key}): {ms:.3f} ms (host issue "
            f"{host:.3f} ms, {busy_text(busy, res['idle_share'])})")
    if share is not None:
        name, n, dev_ms = share
        res["kernel_ms"] = n * dev_ms
        line += (f"; {name} {n} x {dev_ms:.4f} ms = {n * dev_ms:.3f} ms, "
                 f"{100 * n * dev_ms / ms:.1f}% of the forward")
    log(f"{line} [{card}]")
    return res


def bert_masks(b: int, s: int, seed: int) -> np.ndarray:
    """(b, s) int32 padding masks of the bert lane: valid prefixes of
    varied lengths (1, 17, 63, s, random), the last row all pad."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, s + 1, b)
    lens[:4] = [1, 17, 63, s][:min(4, b)]
    lens[-1] = 0
    return (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)


def refmodels_flash(torch, card: str, errs: dict) -> dict:
    """#5 at the bert lane's shape (B 32 x S 384, 12 heads, D 64,
    non-causal, varied right padding, an all-pad row) against its plain
    version, in f32 (what the lane launches: q, k, v come out of nn.dense
    as f32) and bf16: out and lse within F32_TOL / BF16_TOL, the all-pad
    row 0 with lse -inf, bit-identical over two runs; then its times
    beside the bound, the plain version and SDPA over the same mask."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from tpu_engine_torch.ops import flash as fl

    b, s = 32, BERT_SEQ
    mask = torch.from_numpy(bert_masks(b, s, 3)).cuda()
    out = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype).split(".")[-1]
        q, k, v, _ = flash_inputs(torch, torch.device("cuda"), s, BERT_HEADS,
                                  BERT_D, dtype=dtype, b=b, seed=7)
        kw = dict(causal=False, mask=mask)
        got, lse = fl.flash_attention_fwd(q, k, v, **kw)
        ref, ref_lse = fl.flash_attention_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        dead = torch.isinf(ref_lse)
        err = max(float((got.float() - ref.float()).abs().max()),
                  float(torch.where(dead, 0.0, lse - ref_lse).abs().max()))
        again = fl.flash_attention_fwd(q, k, v, **kw)
        check(bool(torch.isfinite(got).all()) and err <= tol
              and torch.equal(torch.isinf(lse), dead)
              and bool(dead[-1].all())
              and torch.equal(got[-1], torch.zeros_like(got[-1]))
              and torch.equal(got, again[0]) and torch.equal(lse, again[1]),
              f"flash at the bert shape ({name}): err {err}")
        key = f"bert B=32 S=384 H=12 {name}"
        errs["flash_attention"][key] = err
        call = (lambda: fl.flash_attention(q, k, v, **kw))
        ms = time_ms(torch, call)
        device, seen = device_call_ms(torch, call)
        plain = time_ms(torch, lambda: fl.flash_attention_reference(
            q, k, v, **kw), iters=3)
        qq, kk, vv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        amask = (mask > 0)[:, None, None, :]

        def library_call():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(qq, kk, vv,
                                                      attn_mask=amask)
        library = time_ms(torch, library_call)
        library_device, _ = device_call_ms(torch, library_call)
        bound, by = flash_bound_ms(q, causal=False, mask=mask)
        out[key] = {"max_abs_err": err, "ms": ms, "device_ms": device,
                    "device_calls": seen, "plain_ms": plain,
                    "library_ms": library,
                    "library_device_ms": library_device,
                    "library_backend": "EFFICIENT_ATTENTION",
                    "bound_ms": bound, "bound_by": by}
        log(f"refmodels flash_attention (B 32, S 384, H 12, D 64, "
            f"non-causal, padding mask with an all-pad row, {name}): max "
            f"abs err {err:.2e} (out and lse), all-pad row 0, bit-identical"
            f" over two runs; kernel {ms:.4f} ms (device time {device:.4f} "
            f"ms), plain {plain:.4f} ms, sdpa EFFICIENT_ATTENTION "
            f"{library:.4f} ms (device time {library_device:.4f} ms), "
            f"bound {bound:.5f} ms ({by}) [{card}]")
    return out


def bert_reference(torch, params, cfg, x, dtype):
    """The bert forward of float token ids ``x`` (B, 384) on the card with
    the flash kernel's plain version as attention: the lane's function
    without the kernel."""
    from tpu_engine_torch.models.transformer import transformer_apply
    from tpu_engine_torch.ops.flash import flash_attention_reference

    tokens = torch.clamp(torch.trunc(x), 0, cfg.vocab - 1).to(torch.int32)
    with torch.inference_mode():
        return transformer_apply(
            params, tokens, cfg, mask=(tokens > 0).to(torch.int32),
            dtype=dtype,
            attn_fn=lambda *a, **kw: flash_attention_reference(*a, **kw)[0])


def refmodels_bert(torch, card: str, flash_dev_ms: float) -> dict:
    """The bert lane (BASELINE config 3: BERT-base-squad, 384-token
    requests zero-padded, the result LRU): a worker with model "bert",
    bf16, 32-row one-shot ticks, random weights from seed 0. With the
    launch counts set to 0 just before and read just after: a burst of 40
    distinct token-id payloads of 1-384 tokens (24 under 64, one of 384)
    and the reference's 3-float payload (all pad) at once, then 8 repeats
    (cache hits): #5 launched 12 x the lane's dispatches (one forward a
    dispatch), no other kernel, no plain call. Every answer against the
    same forward with the plain attention on the card (BERT_BF16_FACTOR),
    the all-pad answer finite; the same burst through a worker in f32 on
    the same weights against the plain f32 forward (BERT_F32_TOL). Then
    the forward's
    ms, host issue, device busy and idle share at B 1 and B 32."""
    from tpu_engine_torch.ops import kernels
    from tpu_engine_torch.serving.app import serve_worker
    from tpu_engine_torch.training.train import tree_map
    from tpu_engine_torch.utils.config import WorkerConfig

    cfg = WorkerConfig(port=0, node_id="chip-smoke-bert", model="bert",
                       dtype="bfloat16", max_batch_size=32, device="cuda",
                       seed=0)
    t0 = time.perf_counter()
    worker, server = serve_worker(cfg)
    port = server.port
    log(f"refmodels bert: 12 layers, d 768, 384-token rows, bf16, ready in "
        f"{time.perf_counter() - t0:.1f} s on port {port}")
    rng = np.random.default_rng(13)
    short = BERT_SEQ // 6  # 64 at 384
    lens = ([int(n) for n in rng.integers(1, short, 24)]
            + [int(n) for n in rng.integers(short, BERT_SEQ, 15)]
            + [BERT_SEQ])
    payloads = [rng.integers(1, 30522, n).astype(np.float32).tolist()
                for n in lens] + [[0.1, 0.2, 0.3]]
    try:
        warm = post(port, "/infer", {"request_id": "bert-warm",
                                     "input_data": [101.0, 2054.0, 102.0]})
        check(len(warm["output_data"]) == 2 * BERT_SEQ, "bert warm-up")
        eng, gen = worker.engine, worker.generator
        st0, ex0 = gen.stats()["stateless"], eng.stats()["execute_count"]
        kernels.reset_counts()  # the lane's run: counts from 0, read after
        res, burst_s = concurrent_posts(port, "/infer", {
            f"q{i}": {"request_id": f"bert{i}", "input_data": p}
            for i, p in enumerate(payloads)})
        reps, _ = concurrent_posts(port, "/infer", {
            f"r{i}": {"request_id": f"bert-rep{i}", "input_data": payloads[i]}
            for i in range(8)})
        torch.cuda.synchronize()
        launches = check_counts("refmodels bert", "flash_attention")
        st1, ex1 = gen.stats()["stateless"], eng.stats()["execute_count"]
        dispatches = st1["dispatches"] - st0["dispatches"]
        check(all(not r["cached"] for r in res.values())
              and all(r["cached"] and r["output_data"]
                      == res[f"q{int(k[1:])}"]["output_data"]
                      for k, r in reps.items()),
              "bert: burst answers cached, or repeats not from the cache")
        check(dispatches > 0 and ex1 - ex0 == dispatches
              and launches == BERT_LAYERS * dispatches
              and st1["failed"] == st0["failed"],
              f"bert: {launches} flash launches for {dispatches} dispatches "
              f"({ex1 - ex0} forwards)")
        health = get(port, "/health")
        check(health["cache_hits"] >= 8 and "generator" not in health,
              f"bert health {health}")
        # Every answer against the plain-attention forward on the card.
        x = np.zeros((len(payloads), BERT_SEQ), np.float32)
        for i, p in enumerate(payloads):
            x[i, :len(p)] = p
        p32 = tree_map(lambda t: t.float(), eng.params)

        def plain(params, dtype):
            return torch.cat([bert_reference(
                torch, params, eng.spec.config,
                torch.from_numpy(x[c:c + 16]).cuda(), dtype)
                for c in range(0, len(x), 16)]).float().cpu().reshape(
                    len(x), -1).numpy()

        ref16, ref32 = plain(eng.params, torch.bfloat16), plain(
            p32, torch.float32)
        lane = np.stack([np.asarray(res[f"q{i}"]["output_data"], np.float32)
                         for i in range(len(payloads))])
        check(lane.shape == ref16.shape and np.isfinite(lane).all(),
              "bert answers misshapen or non-finite")
        lane_err = float(np.abs(lane - ref16).max())
        bf16_err = float(np.abs(ref16 - ref32).max())
        check(lane_err <= BERT_BF16_FACTOR * bf16_err,
              f"bert answers vs the plain bf16 forward: {lane_err} > "
              f"{BERT_BF16_FACTOR} x bf16's own {bf16_err}")
        # The same burst through a worker in f32 on the same weights (its
        # ticks, rows and padding as the bf16 lane's), held tightly.
        w32, s32 = serve_worker(WorkerConfig(
            port=0, node_id="chip-smoke-bert-f32", model="bert",
            dtype="float32", max_batch_size=32, device="cuda", seed=0),
            params=p32)
        try:
            res32, _ = concurrent_posts(s32.port, "/infer", {
                f"q{i}": {"request_id": f"bert32-{i}", "input_data": p}
                for i, p in enumerate(payloads)})
            d32 = w32.generator.stats()["stateless"]["dispatches"]
        finally:
            s32.stop()
            w32.stop()
        k32 = np.stack([np.asarray(res32[f"q{i}"]["output_data"],
                                   np.float32) for i in range(len(payloads))])
        scale = np.maximum(np.abs(ref32).max(axis=1), 1e-30)
        f32_err = float((np.abs(k32 - ref32).max(axis=1) / scale).max())
        check(f32_err <= BERT_F32_TOL and np.isfinite(k32).all(),
              f"bert f32 worker vs the plain f32 forward: {f32_err}")
        del p32
        log(f"refmodels bert: {len(payloads)} distinct /infer (lengths "
            f"1-384, the 3-float all-pad payload among them) in "
            f"{burst_s:.3f} s, 8 repeats cached; {dispatches} one-shot "
            f"dispatches, flash_attention launches {launches} == 12 x "
            f"{dispatches}, no other kernel, no plain call; answers vs the "
            f"plain-attention bf16 forward max |diff| {lane_err:.3e} "
            f"(bf16's own vs f32: {bf16_err:.3e}; the all-pad answer "
            f"finite); the same burst through an f32 worker ({d32} "
            f"dispatches) vs the plain f32 forward max rel err "
            f"{f32_err:.3e} [{card}]")
        out = {"burst_s": burst_s, "requests": len(payloads),
               "dispatches": dispatches, "launches": launches,
               "lane_vs_plain_bf16_abs": lane_err,
               "plain_bf16_vs_f32_abs": bf16_err,
               "f32_worker_rel_err": f32_err, "stateless": st1}
        spec, params = eng.spec, eng.params
        for b in (1, 32):
            xb = torch.from_numpy(x[:b] if b <= len(x) else np.resize(
                x, (b, BERT_SEQ))).cuda()

            def fwd():
                with torch.inference_mode():
                    return spec.apply(params, xb, dtype=torch.bfloat16)

            check(bool(torch.isfinite(fwd()).all()), f"bert forward B {b}")
            out[f"forward B={b}"] = forward_reading(
                torch, f"bert bf16, B {b} x 384", fwd, card,
                share=(("flash_attention f32", BERT_LAYERS, flash_dev_ms)
                       if b == 32 else None))
    finally:
        server.stop()
        worker.stop()
    torch.cuda.empty_cache()
    return out


def refmodels_yolo(torch, card: str) -> dict:
    """yolov8n with shape buckets (BASELINE config 4; bench.py's mixed-shape
    sizes 320, 480 and 640): a worker with model "yolov8n", bf16, random
    weights from seed 0, shape_buckets (320, 320, 3), (480, 480, 3) and
    (640, 640, 3), under cuDNN's default TF32 setting as served.
    YOLO_REQUESTS distinct 16-float /infer requests at once, cycling the
    three shapes
    (each zero-padded onto its shape's canvas by the engine): every answer
    has n_anchors x 144 values for its shape, finite, within YOLO_TOL of
    the plain f32 forward of its canvas on the same weights (TF32 off);
    the lane's forwards are one per (dispatch, bucket). Then the forward
    per bucket at B 1 and B 8 (its shape, finite), timed at 640; the same
    burst through a worker in f32 on
    the same weights, each answer within YOLO_F32_TOL of the plain f32
    forward; and the host's JSON encoding of one 640 answer. (The burst is
    YOLO_REQUESTS requests.)"""
    from tpu_engine_torch.models.yolo import n_anchors
    from tpu_engine_torch.serving.app import serve_worker
    from tpu_engine_torch.serving.worker import _encode_output
    from tpu_engine_torch.training.train import tree_map
    from tpu_engine_torch.utils.config import WorkerConfig

    buckets = tuple((s, s, 3) for s in YOLO_SIZES)
    rng = np.random.default_rng(21)
    inputs = [rng.standard_normal(16).astype(np.float32)
              for _ in range(YOLO_REQUESTS)]
    shapes = [buckets[i % 3] for i in range(YOLO_REQUESTS)]
    out = {}
    with served_conv_precision(torch):
        cfg = WorkerConfig(port=0, node_id="chip-smoke-yolo",
                           model="yolov8n", dtype="bfloat16",
                           max_batch_size=32, device="cuda", seed=0,
                           shape_buckets=buckets)
        t0 = time.perf_counter()
        worker, server = serve_worker(cfg, warmup=True)
        port = server.port
        log(f"refmodels yolo: yolov8n bf16, shape buckets {YOLO_SIZES}, "
            f"warmed up and ready in {time.perf_counter() - t0:.1f} s")
        try:
            eng, gen = worker.engine, worker.generator
            st0, ex0 = gen.stats()["stateless"], eng.stats()["execute_count"]
            res, burst_s = concurrent_posts(port, "/infer", {
                i: {"request_id": f"yolo{i}", "input_data": x.tolist(),
                    "shape": list(s)}
                for i, (x, s) in enumerate(zip(inputs, shapes))})
            st1, ex1 = gen.stats()["stateless"], eng.stats()["execute_count"]
            dispatches = st1["dispatches"] - st0["dispatches"]
            check(dispatches <= ex1 - ex0 <= 3 * dispatches,
                  f"yolo: {ex1 - ex0} forwards for {dispatches} dispatches")
            for i, s in enumerate(shapes):
                n = len(res[i]["output_data"])
                check(n == n_anchors(s[0], s[1]) * YOLO_HEAD,
                      f"yolo answer {i} at {s}: {n} values")
            stats = eng.stats()
            check(stats["shape_buckets"] == [list(b) for b in buckets],
                  f"yolo engine stats {stats}")
            params = eng.params
        finally:
            server.stop()
            worker.stop()
        spec = eng.spec
        for s in YOLO_SIZES:
            for b in (1, 8):
                x = torch.rand((b, s, s, 3), device="cuda")

                def fwd():
                    with torch.inference_mode():
                        return spec.apply(params, x, dtype=torch.bfloat16)

                y = fwd()
                check(tuple(y.shape) == (b, n_anchors(s, s), YOLO_HEAD)
                      and bool(torch.isfinite(y).all()),
                      f"yolo forward {s} B {b}")
                # Timed at the largest bucket only (every bucket before
                # the seqpar phase).
                if s == YOLO_SIZES[-1]:
                    out[f"forward {s} B={b}"] = forward_reading(
                        torch, f"yolov8n bf16, {s} x {s}, B {b}", fwd, card)
    # The plain f32 forward (TF32 off) of each request's canvas, built here
    # as bench.py builds it: the 16 floats first, zeros to (s, s, 3).
    p32 = tree_map(lambda t: t.float(), params)
    want = [None] * YOLO_REQUESTS
    for b in buckets:
        idx = [i for i, s in enumerate(shapes) if s == b]
        canvas = np.zeros((len(idx), *b), np.float32)
        for j, i in enumerate(idx):
            canvas[j].flat[:inputs[i].size] = inputs[i]
        with torch.inference_mode():
            y = spec.apply(p32, torch.from_numpy(canvas).cuda(),
                           dtype=torch.float32)
        for j, i in enumerate(idx):
            want[i] = y[j].reshape(-1).cpu().numpy()
    # The same burst through a worker in f32 on the same weights.
    w32, s32 = serve_worker(WorkerConfig(
        port=0, node_id="chip-smoke-yolo-f32", model="yolov8n",
        dtype="float32", max_batch_size=32, device="cuda", seed=0,
        shape_buckets=buckets), params=p32)
    try:
        res32, _ = concurrent_posts(s32.port, "/infer", {
            i: {"request_id": f"yolo32-{i}", "input_data": x.tolist(),
                "shape": list(s)}
            for i, (x, s) in enumerate(zip(inputs, shapes))})
    finally:
        s32.stop()
        w32.stop()
    worst, worst32 = {}, {}
    for i, s in enumerate(shapes):
        got = np.asarray(res[i]["output_data"], np.float32)
        got32 = np.asarray(res32[i]["output_data"], np.float32)
        check(np.isfinite(got).all() and got32.shape == want[i].shape,
              f"yolo answer {i}: non-finite or misshapen")
        scale = np.abs(want[i]).max()
        worst[s[0]] = max(worst.get(s[0], 0.0),
                          float(np.abs(got - want[i]).max() / scale))
        worst32[s[0]] = max(worst32.get(s[0], 0.0),
                            float(np.abs(got32 - want[i]).max() / scale))
    check(max(worst.values()) <= YOLO_TOL,
          f"yolo answers vs the plain f32 forward: {worst}")
    check(max(worst32.values()) <= YOLO_F32_TOL,
          f"yolo f32 worker vs the plain f32 forward: {worst32}")
    big = want[2]
    t0 = time.perf_counter()
    frag = _encode_output(big)
    enc_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    json.loads(frag)
    dec_ms = (time.perf_counter() - t0) * 1e3
    log(f"refmodels yolo: {YOLO_REQUESTS} distinct 16-float /infer cycling "
        f"{YOLO_SIZES} at once in {burst_s:.3f} s; {dispatches} dispatches, "
        f"{ex1 - ex0} bucket forwards; every answer n_anchors x 144 values "
        f"(2100, 4725, 8400 anchors); vs the plain f32 forward max rel "
        f"err {json.dumps(worst)}, the same burst through an f32 worker "
        f"{json.dumps(worst32)}; one 640 answer ({big.size} floats) encodes "
        f"to {len(frag)} JSON bytes in {enc_ms:.1f} ms, parses in "
        f"{dec_ms:.1f} ms (host) [{card}]")
    out.update({"burst_s": burst_s, "dispatches": dispatches,
                "bucket_forwards": ex1 - ex0, "max_rel_err": worst,
                "f32_worker_max_rel_err": worst32,
                "answer_640": {"floats": int(big.size), "json_bytes":
                               len(frag), "encode_ms": enc_ms,
                               "parse_ms": dec_ms}})
    del p32, params
    torch.cuda.empty_cache()
    return out


def onnx_writer():
    """``tests/onnx_writer.py`` (a protobuf writer of ONNX ModelProtos that
    imports only numpy and struct), loaded by its path beside this script:
    an installed package may own the name ``tests``."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "onnx_writer.py"
    spec = importlib.util.spec_from_file_location("onnx_writer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_resnet50_v2_onnx(path: Path, seed: int = 0) -> None:
    """A ResNet-50 v2 graph in the shape of the reference's
    resnet50-v2-7.onnx (input "data" (N, 3, 224, 224), output (N, 1000),
    NCHW, pre-activation bottlenecks [3, 4, 6, 3] at widths 64-512 x 4,
    bias-free convs, BatchNormalization, MaxPool, GlobalAveragePool,
    Flatten, Gemm), seeded random initializers (``onnx_writer``)."""
    ow = onnx_writer()
    rng = np.random.default_rng(seed)
    inits, nodes = {}, []

    def conv(x, cin, cout, k, stride, name, scale=1.0):
        w = rng.standard_normal((cout, cin, k, k), np.float32)
        inits[name + "_w"] = (w * scale * np.sqrt(2.0 / (cin * k * k))
                              ).astype(np.float32)
        p = k // 2
        nodes.append(ow.node("Conv", [x, name + "_w"], [name], [
            ow.attr_ints("kernel_shape", [k, k]),
            ow.attr_ints("strides", [stride, stride]),
            ow.attr_ints("pads", [p, p, p, p])]))
        return name

    def bn_relu(x, c, name):
        inits[name + "_g"] = (1 + 0.1 * rng.standard_normal(c)).astype(
            np.float32)
        inits[name + "_b"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        inits[name + "_m"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        inits[name + "_v"] = (1 + 0.1 * rng.random(c)).astype(np.float32)
        nodes.append(ow.node("BatchNormalization", [
            x, name + "_g", name + "_b", name + "_m", name + "_v"],
            [name + "_bn"], [ow.attr_float("epsilon", 1e-5)]))
        nodes.append(ow.node("Relu", [name + "_bn"], [name + "_relu"]))
        return name + "_relu"

    x = conv("data", 3, 64, 7, 2, "stem")
    x = bn_relu(x, 64, "stem_bn")
    nodes.append(ow.node("MaxPool", [x], ["pool0"], [
        ow.attr_ints("kernel_shape", [3, 3]), ow.attr_ints("strides", [2, 2]),
        ow.attr_ints("pads", [1, 1, 1, 1])]))
    x, cin = "pool0", 64
    for s, (n, mid) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for blk in range(n):
            stride = 2 if (blk == 0 and s > 0) else 1
            name = f"stage{s + 1}_unit{blk + 1}"
            act = bn_relu(x, cin, name + "_bn1")
            short = x
            if blk == 0:
                short = conv(act, cin, 4 * mid, 1, stride, name + "_sc")
            h = conv(act, cin, mid, 1, 1, name + "_conv1")
            h = bn_relu(h, mid, name + "_bn2")
            h = conv(h, mid, mid, 3, stride, name + "_conv2")
            h = bn_relu(h, mid, name + "_bn3")
            h = conv(h, mid, 4 * mid, 1, 1, name + "_conv3", scale=0.3)
            nodes.append(ow.node("Add", [h, short], [name + "_out"]))
            x, cin = name + "_out", 4 * mid
    x = bn_relu(x, cin, "final_bn")
    nodes.append(ow.node("GlobalAveragePool", [x], ["gap"]))
    nodes.append(ow.node("Flatten", ["gap"], ["flat"]))
    inits["fc_w"] = (rng.standard_normal((1000, cin), np.float32)
                     * np.sqrt(1.0 / cin)).astype(np.float32)
    inits["fc_b"] = np.zeros(1000, np.float32)
    nodes.append(ow.node("Gemm", ["flat", "fc_w", "fc_b"],
                         ["resnetv24_dense0_fwd"],
                         [ow.attr_int("transB", 1)]))
    path.write_bytes(ow.model(nodes, inits,
                              ow.value_info("data", ["N", 3, 224, 224]),
                              ow.value_info("resnetv24_dense0_fwd",
                                            ["N", 1000])))


def spawn_worker_node(args, timeout: float = 300.0) -> tuple:
    """``python -m tpu_engine_torch.serving.cli worker_node <port> *args``
    as a process on a free port; returns (process, port) once /health
    answers."""
    proc, port = start_worker_node(args)
    return await_worker_node(proc, port, args, timeout)


def start_worker_node(args) -> tuple:
    """The process of ``spawn_worker_node``, not waited for: (process,
    port). Its output goes to a file, so that nobody need read it while
    it loads."""
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    err = tempfile.TemporaryFile("w+")
    proc = popen(
        [sys.executable, "-m", "tpu_engine_torch.serving.cli",
         "worker_node", str(port), *args],
        cwd=str(Path(__file__).resolve().parent),
        stdout=subprocess.DEVNULL, stderr=err, text=True)
    proc.err_file = err
    return proc, port


def await_worker_node(proc, port: int, args, timeout: float = 300.0) -> tuple:
    """(process, port) of ``start_worker_node`` once /health answers."""
    t0 = time.perf_counter()
    while True:
        try:
            get(port, "/health")
            return proc, port
        except (OSError, http.client.HTTPException, SmokeFailure):
            if proc.poll() is not None or time.perf_counter() - t0 > timeout:
                proc.kill()
                proc.wait(timeout=30)
                proc.err_file.seek(0)
                err = proc.err_file.read()
                raise SmokeFailure(f"worker_node {args} did not start "
                                   f"({proc.returncode}): {err[-2000:]}")
            time.sleep(0.2)


def stop_process(proc) -> int:
    """SIGTERM, then the exit code (killed after 60 s)."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        return -9


def start_onnx(tmp: Path) -> dict:
    """The graph written to <tmp>/resnet50-v2-7.onnx and the worker_node
    process of ``refmodels_onnx`` started on it (not waited for)."""
    path = tmp / "resnet50-v2-7.onnx"
    t0 = time.perf_counter()
    write_resnet50_v2_onnx(path)
    write_s = time.perf_counter() - t0
    proc, port = start_worker_node(["worker_1", str(path)])
    return {"path": path, "write_s": write_s, "proc": proc, "port": port,
            "args": ["worker_1", str(path)]}


def refmodels_onnx(torch, card: str, started: dict) -> dict:
    """The reference's command line (BASELINE configs 1-2): `worker_node
    <port> worker_1 <tmp>/resnet50-v2-7.onnx` as a process (``start_onnx``
    starts it), serving the
    graph (bf16, the port's default) on the card; the reference payload
    (3 floats, zero-padded to 150,528) and a full 224 x 224 x 3 image over
    /infer, each within ONNX_TOL of the port's executor on the CPU in f32;
    SIGTERM ends it with 0. Then the graph's forward on the card (bf16)
    at B 1 and B 32."""
    from tpu_engine_torch.models.onnx_graph import build_onnx_model

    path, write_s = started["path"], started["write_s"]
    n_in = 3 * 224 * 224
    image = np.round(np.random.default_rng(8).random(n_in, np.float32), 3)
    payloads = {"reference": [1.0, 2.0, 3.0], "image": image.tolist()}
    cpu_spec, cpu_params = build_onnx_model(str(path), device="cpu")
    check(cpu_spec.input_shape == (3, 224, 224)
          and cpu_spec.output_shape == (1000,), f"onnx spec {cpu_spec}")
    x = np.zeros((2, n_in), np.float32)
    x[0, :3] = payloads["reference"]
    x[1] = image
    with torch.inference_mode():
        want = cpu_spec.apply(cpu_params, torch.from_numpy(x).reshape(
            2, 3, 224, 224), dtype=torch.float32).numpy()
    out = {"graph_bytes": path.stat().st_size, "write_s": write_s}
    t0 = time.perf_counter()
    proc, port = await_worker_node(started["proc"], started["port"],
                                   started["args"])
    out["ready_s"] = time.perf_counter() - t0
    try:
        worst = 0.0
        for i, (name, data) in enumerate(payloads.items()):
            r = post(port, "/infer", {"request_id": f"onnx-{name}",
                                      "input_data": data})
            got = np.asarray(r["output_data"], np.float32)
            check(got.shape == (1000,) and np.isfinite(got).all()
                  and r["node_id"] == "worker_1",
                  f"onnx worker answer {name}")
            err = float(np.abs(got - want[i]).max() / np.abs(want[i]).max())
            out[f"{name}_rel_err"] = err
            worst = max(worst, err)
        health = get(port, "/health")
        check(health["model"] == "onnx:resnet50-v2-7.onnx",
              f"onnx worker health {health}")
    finally:
        rc = stop_process(proc)
    check(worst <= ONNX_TOL and rc == 0,
          f"onnx worker: rel err {worst}, exit code {rc}")
    log(f"refmodels onnx: `worker_node <port> worker_1 "
        f"<tmp>/resnet50-v2-7.onnx` ({out['graph_bytes']} bytes, ResNet-50 "
        f"v2, 1000 classes) up after a further {out['ready_s']:.1f} s; "
        f"the 3-float "
        f"payload and a full image vs the CPU executor in f32: max rel err "
        f"{out['reference_rel_err']:.3e} / {out['image_rel_err']:.3e}; "
        f"exited 0 on SIGTERM [{card}]")
    spec, params = build_onnx_model(str(path), device="cuda")
    with served_conv_precision(torch):
        for b in (1, 32):
            xb = torch.rand((b, 3, 224, 224), device="cuda")

            def fwd():
                with torch.inference_mode():
                    return spec.apply(params, xb, dtype=torch.bfloat16)

            check(bool(torch.isfinite(fwd()).all()), f"onnx forward B {b}")
            out[f"forward B={b}"] = forward_reading(
                torch, f"ONNX ResNet-50 v2 bf16, B {b}", fwd, card)
    del params
    torch.cuda.empty_cache()
    return out


def gpt2_hf_state(seed: int) -> dict:
    """A gpt2 (124M) state dict under HF's names (GPT2LMHeadModel, the LM
    head tied to wte), seeded: weights N(0, 0.02^2), LayerNorm scales 1,
    biases 0."""
    rng = np.random.default_rng(seed)
    d, v, L = GPT2_HF["n_embd"], GPT2_HF["vocab_size"], GPT2_HF["n_layer"]

    def w(*shape):
        return (rng.standard_normal(shape, np.float32) * 0.02).astype(
            np.float32)

    sd = {"transformer.wte.weight": w(v, d),
          "transformer.wpe.weight": w(GPT2_HF["n_positions"], d),
          "transformer.ln_f.weight": np.ones(d, np.float32),
          "transformer.ln_f.bias": np.zeros(d, np.float32)}
    for i in range(L):
        p = f"transformer.h.{i}."
        sd.update({p + "ln_1.weight": np.ones(d, np.float32),
                   p + "ln_1.bias": np.zeros(d, np.float32),
                   p + "attn.c_attn.weight": w(d, 3 * d),
                   p + "attn.c_attn.bias": w(3 * d),
                   p + "attn.c_proj.weight": w(d, d),
                   p + "attn.c_proj.bias": w(d),
                   p + "ln_2.weight": np.ones(d, np.float32),
                   p + "ln_2.bias": np.zeros(d, np.float32),
                   p + "mlp.c_fc.weight": w(d, 4 * d),
                   p + "mlp.c_fc.bias": w(4 * d),
                   p + "mlp.c_proj.weight": w(4 * d, d),
                   p + "mlp.c_proj.bias": w(d)})
    return sd


def write_safetensors(path: Path, sd: dict) -> None:
    """``sd`` (name -> f32 ndarray) as a .safetensors file: a little-endian
    u64 header length, the JSON header, the tensors' raw bytes."""
    header, offset, blobs = {}, 0, []
    for name, arr in sd.items():
        raw = np.ascontiguousarray(arr, np.float32).tobytes()
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blobs.append(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def start_reload(torch, tmp: Path) -> dict:
    """The two checkpoints of ``refmodels_reload`` written under ``tmp``
    and its worker_node process started on the first (not waited for)."""
    first, second = tmp / "gpt2-hf-safetensors", tmp / "gpt2_hf_bin"
    first.mkdir()
    second.mkdir()
    t0 = time.perf_counter()
    # Both carry config.json: the fresh worker on the second reads its
    # geometry there (the registry's gpt2 has 12 layers).
    for d in (first, second):
        (d / "config.json").write_text(json.dumps(
            {"model_type": "gpt2", "n_inner": None, **GPT2_HF}))
    write_safetensors(first / "model.safetensors", gpt2_hf_state(1))
    torch.save({k: torch.from_numpy(v) for k, v in gpt2_hf_state(2).items()},
               second / "pytorch_model.bin")
    write_s = time.perf_counter() - t0
    proc, port = start_worker_node(["w_hf", str(first)])
    return {"first": first, "second": second, "write_s": write_s,
            "proc": proc, "port": port, "args": ["w_hf", str(first)]}


def refmodels_reload(torch, card: str, started: dict) -> dict:
    """The HF importers and /admin/reload: two gpt2 HF-layout checkpoints
    (GPT2_HF's geometry) of seeded tensors under HF's names, one a
    directory with config.json and model.safetensors, the other with
    config.json and pytorch_model.bin.
    `worker_node <port> w_hf <first>` (a process, which ``start_reload``
    starts; the model and geometry from config.json, bf16) serves the
    first; POST /admin/reload swaps in
    the second: the answer is ok, the result cache is empty, an /infer
    answered before now answers otherwise (not cached), and a greedy
    /generate/stream equals a fresh worker's on the second checkpoint (in
    process), as does its /infer answer."""
    from tpu_engine_torch.serving.app import serve_worker
    from tpu_engine_torch.utils.config import WorkerConfig

    first, second = started["first"], started["second"]
    out = {"write_s": started["write_s"]}
    prompt = [464, 2068, 7586, 21831, 18045, 625, 262, 16931, 3290, 13]
    infer = {"request_id": "hf-infer",
             "input_data": [float(t) for t in prompt]}
    gen = {"request_id": "hf-gen", "prompt_tokens": prompt,
           "max_new_tokens": 16}
    t0 = time.perf_counter()
    proc, port = await_worker_node(started["proc"], started["port"],
                                   started["args"])
    out["ready_s"] = time.perf_counter() - t0
    try:
        health = get(port, "/health")
        check(health["model"] == "gpt2", f"hf worker health {health}")
        before = post(port, "/infer", dict(infer))
        check(post(port, "/infer", dict(infer))["cached"], "hf: no cache hit")
        toks_before, _, _ = stream(port, dict(gen))
        t0 = time.perf_counter()
        rel = post(port, "/admin/reload", {"model_path": str(second)})
        out["reload_ms"] = (time.perf_counter() - t0) * 1e3
        check(rel == {"ok": True, "node_id": "w_hf",
                      "model_path": str(second)}, f"reload answered {rel}")
        check(get(port, "/health")["cache_size"] == 0,
              "the result cache survived the reload")
        after = post(port, "/infer", dict(infer))
        check(not after["cached"]
              and after["output_data"] != before["output_data"],
              "hf: /infer unchanged by the reload")
        toks_after, final, _ = stream(port, dict(gen))
        check(final is not None and final.get("done")
              and final.get("tokens") == toks_after, f"hf stream {final}")
    finally:
        rc = stop_process(proc)
    check(rc == 0, f"hf worker_node exited {rc}")
    worker, server = serve_worker(WorkerConfig(
        port=0, node_id="w_fresh", model="gpt2", model_path=str(second),
        dtype="bfloat16", device="cuda"))
    try:
        fresh_toks, _, _ = stream(server.port, dict(gen))
        fresh_inf = post(server.port, "/infer", dict(infer))
    finally:
        server.stop()
        worker.stop()
    a = np.asarray(after["output_data"], np.float32)
    f = np.asarray(fresh_inf["output_data"], np.float32)
    inf_err = float(np.abs(a - f).max() / np.abs(f).max())
    check(fresh_toks == toks_after and toks_after != toks_before
          and inf_err <= ONESHOT_INFER_TOL,
          f"reloaded stream {toks_after} vs fresh {fresh_toks} (before "
          f"{toks_before}); /infer vs fresh {inf_err}")
    out["infer_vs_fresh_rel_err"] = inf_err
    log(f"refmodels reload: `worker_node <port> w_hf <gpt2 HF dir: "
        f"config.json + model.safetensors>` up after a further "
        f"{out['ready_s']:.1f} s; "
        f"/admin/reload of <pytorch_model.bin dir> in "
        f"{out['reload_ms']:.1f} ms; the cache emptied, /infer changed, the "
        f"greedy stream ({len(toks_after)} tokens) equals a fresh worker's "
        f"on the second checkpoint, /infer within {inf_err:.2e} of its "
        f"answer [{card}]")
    out.update({"tokens_before": toks_before, "tokens_after": toks_after})
    torch.cuda.empty_cache()
    return out


def phase_refmodels(torch, card: str, errs: dict) -> dict:
    """The reference's other /infer deployments on the card (see
    the module docstring's refmodels entry)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    walls = {}
    lap = lap_timer(walls)
    out = {"flash": refmodels_flash(torch, card, errs), "walls_s": walls}
    lap("flash")
    flash_dev = out["flash"]["bert B=32 S=384 H=12 float32"]["device_ms"]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_refmodels_"))
    started = []
    try:
        # The onnx and reload workers load while bert and yolo run.
        onnx = start_onnx(tmp)
        started.append(onnx["proc"])
        reload = start_reload(torch, tmp)
        started.append(reload["proc"])
        lap("start workers")
        out["bert"] = refmodels_bert(torch, card, flash_dev)
        lap("bert")
        out["yolo"] = refmodels_yolo(torch, card)
        lap("yolo")
        out["onnx"] = refmodels_onnx(torch, card, onnx)
        lap("onnx")
        out["reload"] = refmodels_reload(torch, card, reload)
        lap("reload")
    finally:
        for proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"refmodels: every check passed in {out['seconds']:.1f} s, walls "
        f"(s) {json.dumps({k: round(v, 1) for k, v in walls.items()})} "
        f"[{card}]")
    return out


# -- overload phase -------------------------------------------------------------

# The burst worker: max_queue_depth 8, which the AIMD limit starts from,
# so the tiers' caps are 5 (background), 6 (batch) and 8 (interactive);
# a brownout evaluation every 0.1 s.
OVERLOAD_DEPTH = 8
OVERLOAD_INTERVAL_S = 0.1
# Each held stream: a 12-token motif repeated to 230 tokens and sent with
# repetition_penalty 0.1, so the n-gram drafter proposes from it (see
# serve_spec_lane), generating 256 tokens.
OVERLOAD_PROMPT = 230
OVERLOAD_HOLD_NEW = 256
# Per tier, the streams fired at once beyond the limit.
OVERLOAD_BURST = 4
# Requests after the burst, one at a time (300-token prompts, 4 new
# tokens): they feed the AIMD limit and prefill under the shrunk budget.
OVERLOAD_FEED = 8
# The ladder of stream openings against the tier caps: (tier, admitted).
OVERLOAD_LADDER = (("interactive", True),) * 5 + (
    ("background", False), ("batch", True), ("batch", False),
    ("interactive", True), ("interactive", True), ("interactive", False))
# The gateway command's prober: --health-probe-interval 0.2 and the
# default 3 failures; a probe waits up to HttpWorkerClient.probe_health's
# 5 s, which a stopped (not dead) process makes it wait in full.
PROBE_INTERVAL_S = 0.2
PROBE_FAILURES = 3
PROBE_TIMEOUT_S = 5.0
TENANT_RATE = 5.0
# The failover streams: 48 new tokens of a 64-token prompt, the serving
# worker killed once each stream has 8.
FAILOVER_NEW = 48
FAILOVER_AT = 8


class StreamReader(threading.Thread):
    """One /generate/stream request in its own thread: the status and
    Retry-After of the answer, the 503 body, and each token event with its
    arrival time. ``ready`` is set once the status is known."""

    def __init__(self, port: int, body: dict):
        super().__init__(daemon=True)
        self.port, self.body = port, body
        self.status = None
        self.retry_after = None
        self.shed = {}
        self.tokens, self.times = [], []
        self.final = None
        self.error = None
        self.ready = threading.Event()

    def run(self):
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=600)
        try:
            conn.request("POST", "/generate/stream", json.dumps(self.body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            self.status = resp.status
            self.retry_after = resp.getheader("Retry-After")
            if resp.status != 200:
                self.shed = json.loads(resp.read())
                return
            self.ready.set()
            buf = b""
            while True:
                chunk = resp.read1(65536)
                if not chunk:
                    break
                buf += chunk
                while b"\n\n" in buf:
                    frame, buf = buf.split(b"\n\n", 1)
                    ev = json.loads(frame[len(b"data: "):])
                    if ev.get("done"):
                        self.final = ev
                    else:
                        now = time.perf_counter()
                        for t in ev["tokens"]:
                            self.tokens.append(t)
                            self.times.append(now)
        except Exception as exc:  # reported by the caller's checks
            self.error = repr(exc)
        finally:
            self.ready.set()
            conn.close()


def motif_prompt(rng, vocab: int) -> list:
    motif = [int(t) for t in rng.integers(1, vocab, 12)]
    return (motif * (OVERLOAD_PROMPT // 12 + 1))[:OVERLOAD_PROMPT]


def overload_worker(torch, params) -> dict:
    """The worker's overload control on a mixed-bf16 spec_k 4 lane of
    TinyLlama geometry (priority admission, the AIMD limit from depth 8,
    brownout every 0.1 s), launch counts set to 0 just before and read
    just after: the tier ladder, a burst beyond the limit, the held
    streams' end, the ladder's restore and the AIMD feed."""
    from tpu_engine_torch.ops import kernels

    overrides = dict(PAGED, gen_mixed_step=True, gen_mixed_token_budget=256,
                     gen_continuous_spec_k=SPEC_K,
                     max_queue_depth=OVERLOAD_DEPTH, priority_admission=True,
                     adaptive_depth=True, brownout=True,
                     brownout_interval_s=OVERLOAD_INTERVAL_S)
    worker, server = start_lane(torch, params, "overload-bf16",
                                model=CUT_LLAMA, overrides=overrides)
    port = server.port
    gen = worker.generator
    vocab, n_layers = gen.cfg.vocab, gen.cfg.n_layers
    budget = gen._mixed_budget
    # Each mixed tick's prefill tokens under the budget fraction in force
    # (an observer wrapped around the scheduler's split, nothing else).
    chunks, real = [], gen._prefill_chunks

    def observed(prefill_rows, n_decode):
        f = gen._bo_budget_frac
        chunk = real(prefill_rows, n_decode)
        if f == gen._bo_budget_frac and prefill_rows:
            chunks.append((f, int(chunk.sum())))
        return chunk

    gen._prefill_chunks = observed
    rng = np.random.default_rng(14)
    samples, sample_errors = [], []
    stop_sampling = threading.Event()

    def sampler():
        while not stop_sampling.is_set():
            try:
                h = get(port, "/health")
                g = h["generator"]
                samples.append({
                    "t": time.perf_counter(), "stage": h["brownout"]["stage"],
                    "brownout": g.get("brownout"),
                    "proposed": g["spec"]["proposed_tokens"],
                    "depth": h["admission"]["queue_depth"],
                    "limit": h["admission"]["adaptive"]["limit"]})
            except Exception as exc:  # reported below, fails the phase
                sample_errors.append(repr(exc))
            stop_sampling.wait(0.05)

    held, sheds = [], []
    sampling = threading.Thread(target=sampler, daemon=True)
    try:
        kernels.reset_counts()  # the lane's run: counts from 0, read after
        # The lane's first tick pays one-time costs that the brownout may
        # read as a stalled loop: a short request first, and the warm-up
        # once the ladder is back at stage 0.
        post(port, "/generate", {"request_id": "first",
                                 "prompt_tokens": [1, 2, 3],
                                 "max_new_tokens": 2})
        wait_for(lambda: get(port, "/health")["brownout"]["stage"] == 0,
                 "the brownout did not settle before the warm-up", 30.0,
                 phase="overload")
        first_bo = get(port, "/health")["brownout"]
        # Warm-up at stage 0 on a repetitive prompt: the drafter proposes.
        warm = post(port, "/generate", {
            "request_id": "warm", "prompt_tokens": motif_prompt(rng, vocab),
            "max_new_tokens": 32, "repetition_penalty": 0.1})
        warm_proposed = generator_stats(port)["spec"]["proposed_tokens"]
        check(len(warm["tokens"]) == 32 and warm_proposed > 0,
              f"overload warm-up: {warm}, {warm_proposed} proposals; "
              f"brownout before it {first_bo}, after it "
              f"{get(port, '/health')['brownout']}")
        t0 = time.perf_counter()
        sampling.start()
        for i, (tier, admitted) in enumerate(OVERLOAD_LADDER):
            depth = get(port, "/health")["admission"]["queue_depth"]
            r = StreamReader(port, {
                "request_id": f"hold-{i}",
                "prompt_tokens": motif_prompt(rng, vocab),
                "max_new_tokens": OVERLOAD_HOLD_NEW,
                "repetition_penalty": 0.1, "priority": tier})
            r.start()
            check(r.ready.wait(120), f"overload ladder {i}: no answer")
            check((r.status == 200) == admitted,
                  f"overload ladder {i} ({tier} at depth {depth}): "
                  f"{r.status} {r.shed}")
            (held if admitted else sheds).append((tier, depth, r))
        burst = []
        for i in range(OVERLOAD_BURST * 3):
            tier = ("background", "batch", "interactive")[i % 3]
            r = StreamReader(port, {
                "request_id": f"burst-{i}", "prompt_tokens": [1, 2, 3],
                "max_new_tokens": 8, "priority": tier})
            r.start()
            burst.append((tier, OVERLOAD_DEPTH, r))
        for _, _, r in burst:
            r.join(timeout=120)
        sheds.extend(burst)
        for tier, depth, r in sheds:
            check(r.status == 503 and r.shed.get("kind") == "overloaded"
                  and r.retry_after is not None,
                  f"overload shed of {tier} at depth {depth}: {r.status} "
                  f"{r.retry_after} {r.shed} {r.error}")
        first = {t: min(d for tt, d, _ in sheds if tt == t)
                 for t in ("background", "batch", "interactive")}
        check(first["background"] < first["batch"] < first["interactive"],
              f"overload: tiers shed out of order: {first}")
        per_tier = {t: sum(1 for tt, _, _ in sheds if tt == t)
                    for t in first}
        adm = get(port, "/health")["admission"]
        check(adm["shed_overloaded"] == len(sheds)
              == adm["shed_depth"] + adm["shed_tier"] + adm["shed_adaptive"]
              and "adaptive" in adm,
              f"overload admission block: {adm} for {len(sheds)} sheds")
        for _, _, r in held:
            r.join(timeout=600)
            check(r.error is None and r.final is not None
                  and "error" not in r.final
                  and r.final["tokens"] == r.tokens
                  and len(r.tokens) == OVERLOAD_HOLD_NEW,
                  f"overload held stream: {r.error} {r.final}")
        hold_s = time.perf_counter() - t0
        limit0 = get(port, "/health")["admission"]["adaptive"]
        feed = []
        for i in range(OVERLOAD_FEED):
            t1 = time.perf_counter()
            out = post(port, "/generate", {
                "request_id": f"feed-{i}",
                "prompt_tokens": [int(t) for t in rng.integers(1, vocab,
                                                               300)],
                "max_new_tokens": 4, "priority": "interactive"})
            check(len(out["tokens"]) == 4, f"overload feed {i}: {out}")
            feed.append(time.perf_counter() - t1)
        deadline = time.perf_counter() + 30
        while get(port, "/health")["brownout"]["stage"] and \
                time.perf_counter() < deadline:
            time.sleep(0.05)
        stop_sampling.set()
        sampling.join(timeout=30)
        health = get(port, "/health")
        bo, aimd = health["brownout"], health["admission"]["adaptive"]
        check(bo["stage"] == 0 and bo["escalations"] == bo["restores"] >= 3
              and "brownout" not in health["generator"],
              f"overload: the brownout did not restore: {bo}")
        check(not sample_errors, f"overload sampler: {sample_errors[:3]}")
        stages = [s["stage"] for s in samples]
        timeline = []
        for s in samples:
            if not timeline or timeline[-1][1] != s["stage"]:
                timeline.append((round(s["t"] - t0, 3), s["stage"]))
        steps = [b - a for (_, a), (_, b) in zip(timeline, timeline[1:])]
        check(max(stages) >= 3 and set(steps) <= {1, -1},
              f"overload: brownout climbed to {max(stages)} in {timeline}")
        # Spec suspended: from the third sample of each suspended run (a
        # tick already drafting when the stage moved may still count),
        # the proposal count stays where it was.
        flat, runs, run = True, [], []
        for s in samples + [{"brownout": None}]:
            if (s["brownout"] or {}).get("spec_suspended"):
                run.append(s["proposed"])
                continue
            if run:
                runs.append(run)
                flat = flat and len(set(run[2:])) <= 1
            run = []
        check(flat and max((len(r) for r in runs), default=0) >= 4,
              f"overload: proposals moved while spec was suspended: {runs}")
        # After the restore, spec proposes again.
        p0 = generator_stats(port)["spec"]["proposed_tokens"]
        post(port, "/generate", {
            "request_id": "resumed", "prompt_tokens": motif_prompt(rng, vocab),
            "max_new_tokens": 32, "repetition_penalty": 0.1})
        p1 = generator_stats(port)["spec"]["proposed_tokens"]
        check(p1 > p0 >= warm_proposed,
              f"overload: spec did not resume: {p0} {p1}")
        check(aimd["increases"] + aimd["decreases"] > 0,
              f"overload: the AIMD limit never moved: {aimd}")
        st, idle = wait_idle(port, paged=True)
        check(idle, f"overload: not idle or blocks leaked: {st['kv_pool']}")
        launches = check_counts("overload", "ragged_paged_attention")
        sp, m = st["spec"], st["mixed"]
        check(sp["ticks"] == sp["dispatches"] == m["ticks"]
              == m["dispatches"] > 0
              and launches == n_layers * sp["dispatches"],
              f"overload: {launches} ragged launches for spec {sp}, mixed "
              f"{m}, of {n_layers} layers")
        widest = {f: max(c for ff, c in chunks if ff == f)
                  for f in sorted({f for f, _ in chunks})}
        check(all(c <= max(1, int(f * budget)) for f, c in chunks)
              and any(f < 1.0 for f in widest) and 1.0 in widest
              and widest[1.0] > max(widest[f] for f in widest if f < 1.0),
              f"overload: prefill tokens per tick by budget fraction "
              f"{widest} (budget {budget})")
    finally:
        stop_sampling.set()
        gen._prefill_chunks = real
        server.stop()
        worker.stop()
    out = {"launches": launches, "spec_dispatches": sp["dispatches"],
           "mixed_ticks": m["ticks"], "sheds_per_tier": per_tier,
           "first_shed_depth": first, "admission": adm,
           "aimd_before_feed": limit0, "aimd": aimd, "brownout": bo,
           "stage_timeline_s": timeline, "suspended_runs": len(runs),
           "widest_prefill_by_frac": widest, "hold_s": hold_s,
           "feed_ms": [x * 1e3 for x in feed]}
    log(f"overload worker: tier ladder shed background at depth "
        f"{first['background']}, batch at {first['batch']}, interactive at "
        f"{first['interactive']} of {OVERLOAD_DEPTH}; sheds per tier "
        f"{per_tier}, every one 503 overloaded with Retry-After; admission "
        f"{json.dumps(adm)}; brownout stages (s, stage) {timeline}, "
        f"escalations {bo['escalations']} == restores {bo['restores']}; "
        f"proposals flat over {len(runs)} suspended runs, resumed after; "
        f"AIMD {limit0['limit']} -> {aimd['limit']} ({aimd['increases']} "
        f"increases, {aimd['decreases']} decreases); widest prefill per "
        f"tick by budget fraction {widest} of budget {budget}; "
        f"ragged_paged_attention launches {launches} == {n_layers} x "
        f"{sp['dispatches']} spec ticks (== mixed ticks), plain calls 0")
    return out


def overload_identity(torch, params32) -> dict:
    """A mixed f32 spec_k 4 worker (TF32 off): greedy streams of a
    repetitive prompt (the drafter proposes) and a random one, with spec
    running and under the spec_off stage's degradations (budget halved,
    spec suspended), token-identical; no proposal while suspended; the
    ragged kernel launched once a layer for each spec tick."""
    from tpu_engine_torch.ops import kernels

    overrides = dict(PAGED, gen_mixed_step=True, gen_mixed_token_budget=256,
                     gen_continuous_spec_k=SPEC_K)
    worker, server = start_lane(torch, params32, "overload-f32-spec",
                                model=CUT_LLAMA, overrides=overrides,
                                dtype="float32")
    port = server.port
    gen = worker.generator
    vocab, n_layers = gen.cfg.vocab, gen.cfg.n_layers
    rng = np.random.default_rng(15)
    bodies = [{"prompt_tokens": motif_prompt(rng, vocab),
               "repetition_penalty": 0.1},
              {"prompt_tokens": [int(t) for t in rng.integers(1, vocab,
                                                              200)]}]
    try:
        kernels.reset_counts()
        runs = {}
        for key, stage in (("spec", {}),
                           ("spec_off", dict(budget_frac=0.5,
                                             suspend_spec=True))):
            gen.set_brownout(**stage)
            p0 = generator_stats(port)["spec"]["proposed_tokens"]
            runs[key] = [post(port, "/generate", dict(
                b, request_id=f"{key}-{i}", max_new_tokens=64))["tokens"]
                for i, b in enumerate(bodies)]
            runs[key + "_proposed"] = (generator_stats(port)["spec"]
                                       ["proposed_tokens"] - p0)
        gen.set_brownout()
        check(runs["spec"] == runs["spec_off"],
              f"overload f32: greedy streams differ with spec suspended: "
              f"{runs}")
        check(runs["spec_proposed"] > 0 and runs["spec_off_proposed"] == 0,
              f"overload f32: proposals {runs['spec_proposed']} with spec, "
              f"{runs['spec_off_proposed']} suspended")
        st, idle = wait_idle(port, paged=True)
        check(idle, f"overload f32: blocks leaked: {st['kv_pool']}")
        launches = check_counts("overload-f32", "ragged_paged_attention")
        sp = st["spec"]
        check(launches == n_layers * sp["dispatches"] > 0,
              f"overload f32: {launches} launches for {sp}")
    finally:
        gen.set_brownout()
        server.stop()
        worker.stop()
    log(f"overload f32: greedy streams (64 tokens, a repetitive and a "
        f"random prompt) identical with spec running ({runs['spec_proposed']}"
        f" proposals) and suspended (0 proposals, budget 0.5); "
        f"ragged_paged_attention launches {launches} == {n_layers} x "
        f"{sp['dispatches']} spec ticks")
    return {"launches": launches, "spec_dispatches": sp["dispatches"],
            "proposed": runs["spec_proposed"]}


def overload_swap_defer(torch, params) -> dict:
    """A mixed-bf16 worker with --kv-blocks 160 --kv-host-blocks 256: four
    1024-token prompts (64 blocks each) demote the first ones to the
    host; under the swap_defer stage's degradations a demoted prompt's
    repeat promotes nothing (swap_in_deferred grows), and once released
    another demoted prompt's repeat swaps in."""
    from tpu_engine_torch.ops import kernels

    overrides = dict(PAGED, gen_mixed_step=True, gen_mixed_token_budget=256,
                     gen_kv_blocks=160, gen_kv_host_blocks=256)
    worker, server = start_lane(torch, params, "overload-swap-defer",
                                model=CUT_LLAMA, overrides=overrides)
    port = server.port
    gen = worker.generator
    vocab, n_layers = gen.cfg.vocab, gen.cfg.n_layers
    rng = np.random.default_rng(16)
    prompts = [[int(t) for t in rng.integers(1, vocab, 1024)]
               for _ in range(4)]

    def host():
        return generator_stats(port)["kv_pool"]["host"]

    def ask(name, prompt):
        out = post(port, "/generate", {"request_id": name,
                                       "prompt_tokens": prompt,
                                       "max_new_tokens": 8})
        check(len(out["tokens"]) == 8, f"overload swap {name}: {out}")

    try:
        kernels.reset_counts()
        for i, p in enumerate(prompts):
            ask(f"churn-{i}", p)
        h0 = host()
        check(h0["demotions"] > 0, f"overload swap: nothing demoted: {h0}")
        gen.set_brownout(budget_frac=0.5, suspend_spec=True,
                         defer_swap_in=True)
        ask("deferred", prompts[0] + [int(t) for t in
                                      rng.integers(1, vocab, 32)])
        h1 = host()
        gen.set_brownout()
        ask("released", prompts[1] + [int(t) for t in
                                      rng.integers(1, vocab, 32)])
        h2 = host()
        check(h1["swap_ins"] == h0["swap_ins"]
              and h1["swap_in_deferred"] > h0["swap_in_deferred"]
              and h2["swap_ins"] > h1["swap_ins"],
              f"overload swap: before {h0}, deferred {h1}, released {h2}")
        st, idle = wait_idle(port, paged=True)
        check(idle, f"overload swap: blocks leaked: {st['kv_pool']}")
        launches = check_counts("overload-swap", "ragged_paged_attention")
        m = st["mixed"]
        check(launches == n_layers * m["dispatches"] > 0,
              f"overload swap: {launches} launches for {m}")
    finally:
        gen.set_brownout()
        server.stop()
        worker.stop()
    log(f"overload swap-in deferral: {h0['demotions']} demotions; deferred: "
        f"swap_ins {h0['swap_ins']} -> {h1['swap_ins']}, swap_in_deferred "
        f"{h0['swap_in_deferred']} -> {h1['swap_in_deferred']}; released: "
        f"swap_ins -> {h2['swap_ins']}; ragged launches {launches} == "
        f"{n_layers} x {m['dispatches']} mixed ticks")
    return {"before": h0, "deferred": h1, "released": h2,
            "launches": launches}


def spawn_worker(args, log_path: Path) -> tuple:
    """The worker command (``cli worker <port> *args``, through
    ``chip_smoke.py --serve-worker``, so that CUT_LLAMA names a model) as
    a process on a free port, its output to ``log_path``: (process, port,
    the log's file)."""
    port = free_port()
    out = open(log_path, "w")
    proc = popen(
        [sys.executable, str(Path(__file__).resolve()), "--serve-worker",
         str(port), *args], cwd=str(Path(__file__).resolve().parent),
        stdout=out, stderr=subprocess.STDOUT)
    return proc, port, out


def main_serve_worker(argv) -> int:
    """``--serve-worker <worker argv>``: the worker command, with the
    cut-depth TinyLlama registered."""
    from tpu_engine_torch.serving import cli

    cut_llama()
    return cli.main(["worker", *argv])


def wait_health(proc, port: int, timeout: float = 300.0) -> float:
    """Seconds until the process's /health answers."""
    t0 = time.perf_counter()
    while True:
        try:
            get(port, "/health")
            return time.perf_counter() - t0
        except (OSError, http.client.HTTPException, SmokeFailure):
            check(proc.poll() is None and time.perf_counter() - t0 < timeout,
                  f"process on port {port} did not start ({proc.poll()})")
            time.sleep(0.2)


def wait_stats(port: int, pred, timeout: float) -> tuple:
    """(seconds until ``pred(/stats)`` holds, or None, the last /stats)."""
    t0 = time.perf_counter()
    while True:
        st = get(port, "/stats")
        if pred(st):
            return time.perf_counter() - t0, st
        if time.perf_counter() - t0 > timeout:
            return None, st
        time.sleep(0.02)


def overload_gateway(torch, params32, proc, p_port: int) -> dict:
    """Two f32 mixed workers (P: the worker command as a process, started
    by the caller; L: in process, the same seeded weights) behind the
    gateway command as a process with --failover-streams
    --health-probe-interval 0.2 --overload-control --tenant-rate 5, the
    launch counts set to 0 before and read after (L's): the tenant
    bucket, P stopped (a hedged /score through an in-process gateway
    with hedge_enabled answered by L; the prober's ejection with no
    breaker penalty; restored once continued), then two streams owned by
    P (greedy and seeded) with P killed after 8 tokens of each: both
    continue on L, token for token the unbroken runs, and the dead P is
    ejected."""
    import signal
    import socket

    from tpu_engine_torch.ops import kernels
    from tpu_engine_torch.serving.gateway import Gateway
    from tpu_engine_torch.utils.config import GatewayConfig

    worker, server = start_lane(torch, params32, "overload-gw-l",
                                model=CUT_LLAMA,
                                overrides=dict(PAGED, gen_mixed_step=True,
                                               gen_mixed_token_budget=256),
                                dtype="float32", node_id="ov-l")
    l_port = server.port
    gen = worker.generator
    n_layers, vocab = gen.cfg.n_layers, gen.cfg.vocab
    p_url, l_url = f"127.0.0.1:{p_port}", f"127.0.0.1:{l_port}"
    urls = [p_url, l_url]
    ring = ring_of(urls)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        g_port = s.getsockname()[1]
    g_log = open(OUT_DIR / "overload_gateway.log", "w")
    gproc = popen(
        [sys.executable, "-m", "tpu_engine_torch.serving.cli", "gateway",
         *urls, "--port", str(g_port), "--failover-streams",
         "--health-probe-interval", str(PROBE_INTERVAL_S),
         "--overload-control", "--tenant-rate", str(TENANT_RATE)],
        cwd=str(Path(__file__).resolve().parent), stdout=g_log,
        stderr=subprocess.STDOUT)
    hedger = None
    stopped = False
    try:
        p_ready_s = wait_health(proc, p_port)
        t0 = time.perf_counter()
        while True:
            try:
                get(g_port, "/stats")
                break
            except (OSError, http.client.HTTPException, SmokeFailure):
                check(gproc.poll() is None and time.perf_counter() - t0 < 120,
                      f"gateway command did not start: {gproc.poll()}")
                time.sleep(0.1)
        g_ready_s = time.perf_counter() - t0
        kernels.reset_counts()  # L's run: counts from 0, read after
        base = generator_stats(l_port)
        base_oneshot = base["stateless"]["dispatches"]
        base_mixed = base["mixed"]["dispatches"]
        # Warm both lanes directly.
        for port in (p_port, l_port):
            post(port, "/generate", {"request_id": "ov-warm",
                                     "prompt_tokens": [1, 2, 3],
                                     "max_new_tokens": 2})
        rng = np.random.default_rng(17)

        def score_body(rid, **extra):
            return {"request_id": rid,
                    "prompt_tokens": [int(t) for t in
                                      rng.integers(1, vocab, 16)],
                    "completion_tokens": [int(t) for t in
                                          rng.integers(1, vocab, 4)],
                    **extra}

        # -- the tenant bucket (5/s, 10 deep): tenant A's burst of 20
        # sheds with Retry-After, tenant B is untouched.
        tenant = {}
        threads, answers = [], []
        rids = spread(ring, urls, 23, "tenant-")
        for i, rid in enumerate(rids):
            t = "A" if i < 20 else "B"
            th = threading.Thread(target=lambda r=rid, tt=t: answers.append(
                (tt, call(g_port, "POST", "/score",
                          score_body(r, tenant=tt)))))
            threads.append(th)
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        for t in ("A", "B"):
            codes = [a for tt, a in answers if tt == t]
            tenant[t] = {"ok": sum(1 for c, _, _ in codes if c == 200),
                         "shed": sum(1 for c, _, _ in codes if c == 503)}
            check(all(c == 200 or (c == 503 and ra is not None
                                   and json.loads(b).get("kind")
                                   == "overloaded")
                      for c, b, ra in codes),
                  f"overload tenant {t}: {codes}")
        ov = get(g_port, "/stats")["overload"]
        check(tenant["A"]["shed"] >= 8 and tenant["B"]["shed"] == 0
              and ov["rate_limited"] == tenant["A"]["shed"]
              and tenant["A"]["ok"] + tenant["A"]["shed"] == 20,
              f"overload tenant bucket: {tenant} {ov}")
        # -- P stopped: a hedged /score answered by L.
        hedger = Gateway(urls, GatewayConfig(hedge_enabled=True,
                                             gen_timeout_s=60.0))
        for rid in owned(ring, l_url, 3, "hwarm-"):
            hedger.route_score(score_body(rid))
        res0 = hedger.get_stats()["resilience"]
        os.kill(proc.pid, signal.SIGSTOP)
        stopped = True
        t_stop = time.perf_counter()
        f0 = launch_counts()["flash_attention"][0]
        t1 = time.perf_counter()
        hedged = hedger.route_score(score_body(owned(ring, p_url, 1,
                                                     "hedge-")[0]))
        hedge_s = time.perf_counter() - t1
        hedge_flash = launch_counts()["flash_attention"][0] - f0
        res = hedger.get_stats()["resilience"]
        check(hedged["node_id"] == "ov-l"
              and res["hedges"] - res0["hedges"] == 1
              and res["hedge_wins"] - res0["hedge_wins"] == 1
              and hedge_flash >= n_layers,
              f"overload hedge: {hedged.get('node_id')} {res0} -> {res}, "
              f"{hedge_flash} flash launches")
        # -- the prober ejects the stopped P, with no breaker penalty.
        bound_stop = (PROBE_FAILURES * (PROBE_INTERVAL_S + PROBE_TIMEOUT_S)
                      + PROBE_INTERVAL_S)
        eject_s, st = wait_stats(
            g_port, lambda s: p_url in s["failover"]["ejected_lanes"],
            bound_stop + 5)
        check(eject_s is not None and time.perf_counter() - t_stop
              <= bound_stop + 1.0, f"overload prober: P not ejected "
              f"within {bound_stop} s: {st}")
        eject_stop_s = time.perf_counter() - t_stop
        routed = post(g_port, "/generate", {
            "request_id": owned(ring, p_url, 1, "ejected-")[0],
            "prompt_tokens": [5, 6, 7], "max_new_tokens": 4})
        st = get(g_port, "/stats")
        breaker = next(b for b in st["circuit_breakers"]
                       if b["node"] == p_url)
        check(routed["node_id"] == "ov-l" and breaker["failures"] == 0
              and breaker["state"] == "CLOSED",
              f"overload prober: {routed.get('node_id')} {breaker}")
        os.kill(proc.pid, signal.SIGCONT)
        stopped = False
        t_cont = time.perf_counter()
        restore_s, st = wait_stats(
            g_port, lambda s: not s["failover"]["ejected_lanes"], 30)
        check(restore_s is not None, f"overload prober: no restore: {st}")
        restore_s = time.perf_counter() - t_cont
        # -- failover: two streams owned by P, P killed after 8 tokens.
        bodies = [{"prompt_tokens": [int(t) for t in
                                     rng.integers(1, vocab, 64)],
                   "max_new_tokens": FAILOVER_NEW, **extra}
                  for extra in ({}, {"temperature": 0.9, "seed": 11})]
        controls = [StreamReader(l_port, dict(b, request_id=f"ctl-{i}"))
                    for i, b in enumerate(bodies)]
        for r in controls:
            r.start()
        for r in controls:
            r.join(timeout=600)
            check(r.final is not None and len(r.tokens) == FAILOVER_NEW,
                  f"overload failover control: {r.final} {r.error}")
        rids = owned(ring, p_url, 2, "failover-")
        readers = [StreamReader(g_port, dict(b, request_id=rid))
                   for b, rid in zip(bodies, rids)]
        for r in readers:
            r.start()
        deadline = time.perf_counter() + 120
        while (min(len(r.tokens) for r in readers) < FAILOVER_AT
               and time.perf_counter() < deadline):
            time.sleep(0.002)
        at_kill = [len(r.tokens) for r in readers]
        check(min(at_kill) >= FAILOVER_AT and max(at_kill) < FAILOVER_NEW,
              f"overload failover: streamed {at_kill} before the kill")
        proc.kill()
        t_kill = time.perf_counter()
        dead_s, st = wait_stats(
            g_port, lambda s: p_url in s["failover"]["ejected_lanes"], 10)
        dead_eject_s = time.perf_counter() - t_kill
        for r in readers:
            r.join(timeout=600)
        resumed_ms = []
        for r, ctl, n in zip(readers, controls, at_kill):
            check(r.final is not None and r.final.get("resumed") == 1
                  and r.tokens == ctl.tokens == r.final["tokens"],
                  f"overload failover: {r.tokens} vs unbroken {ctl.tokens}: "
                  f"{r.final} {r.error}")
            # The resumed segment's first token: the first arrival after
            # the largest gap since the kill.
            after = [i for i, t in enumerate(r.times) if t >= t_kill]
            gaps = [(r.times[i] - (r.times[i - 1] if i else t_kill), i)
                    for i in after]
            first = max(gaps)[1]
            resumed_ms.append((r.times[first] - t_kill) * 1e3)
        bound_dead = PROBE_INTERVAL_S * (PROBE_FAILURES + 1)
        check(dead_s is not None and dead_eject_s <= bound_dead + 0.1,
              f"overload prober: the dead P ejected after {dead_eject_s} s "
              f"(bound {bound_dead}): {st}")
        fo = get(g_port, "/stats")["failover"]
        check(fo["resumes_succeeded"] == fo["resumes_attempted"] == 2
              and fo["prober_ejections"] == 2 and fo["prober_restores"] == 1,
              f"overload failover block: {fo}")
        l_st, idle = wait_idle(l_port, paged=True)
        check(idle, f"overload L: blocks leaked: {l_st['kv_pool']}")
        counts = launch_counts()
        check(all(p == 0 for _, p in counts.values()),
              f"overload L: plain versions served attention: {counts}")
        ragged = counts["ragged_paged_attention"][0]
        flash = counts["flash_attention"][0]
        mixed = l_st["mixed"]["dispatches"] - base_mixed
        oneshot = l_st["stateless"]["dispatches"] - base_oneshot
        check(ragged == n_layers * mixed and flash == n_layers * oneshot
              and oneshot > 0,
              f"overload L: {ragged} ragged launches for {mixed} mixed "
              f"ticks, {flash} flash for {oneshot} one-shot dispatches")
        gproc.send_signal(signal.SIGTERM)
        g_rc = gproc.wait(timeout=60)
        check(g_rc == 0, f"gateway command exited {g_rc}")
    finally:
        if stopped and proc.poll() is None:
            os.kill(proc.pid, signal.SIGCONT)
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
        if gproc.poll() is None:
            gproc.kill()
            gproc.wait(timeout=30)
        g_log.close()
        if hedger is not None:
            hedger.stop()
        server.stop()
        worker.stop()
    hedge = {"threshold_ms": res.get("hedge_threshold_ms"), "s": hedge_s,
             "hedges": res["hedges"], "wins": res["hedge_wins"],
             "losses": res["hedge_losses"],
             "win_rate": res["hedge_wins"] / res["hedges"],
             "flash_launches": hedge_flash}
    out = {"p_ready_s": p_ready_s, "gateway_ready_s": g_ready_s,
           "tenant": tenant, "overload": ov, "hedge": hedge,
           "eject_stopped_s": eject_stop_s, "eject_stopped_bound_s":
           bound_stop, "restore_s": restore_s, "eject_dead_s": dead_eject_s,
           "eject_dead_bound_s": bound_dead, "streamed_at_kill": at_kill,
           "kill_to_resumed_token_ms": resumed_ms, "failover": fo,
           "launches": {"ragged_paged_attention": ragged,
                        "flash_attention": flash},
           "mixed_ticks": mixed, "oneshot_dispatches": oneshot}
    log(f"overload gateway: P up in {p_ready_s:.1f} s, the gateway command "
        f"in {g_ready_s:.1f} s; tenant A {tenant['A']} and B {tenant['B']} "
        f"(rate {TENANT_RATE:g}/s); P stopped: hedged /score answered by L "
        f"in {hedge_s * 1e3:.1f} ms (threshold {hedge['threshold_ms']} ms, "
        f"hedges {hedge['hedges']}, wins {hedge['wins']}, {hedge_flash} "
        f"flash launches), ejected after {eject_stop_s:.3f} s (bound "
        f"{bound_stop:.1f} s: 3 probes of up to 5 s), breaker CLOSED with 0 "
        f"failures, restored {restore_s:.3f} s after SIGCONT; P killed after "
        f"{at_kill} tokens: both streams (greedy, seeded) resumed once on L, "
        f"token-identical to their unbroken runs, kill -> first resumed "
        f"token {[round(x, 1) for x in resumed_ms]} ms; the dead P ejected "
        f"after {dead_eject_s:.3f} s (bound {bound_dead:.1f} s); L's "
        f"ragged_paged_attention {ragged} == {n_layers} x {mixed} mixed "
        f"ticks, flash_attention {flash} == {n_layers} x {oneshot} one-shot "
        f"dispatches, plain calls 0")
    return out


def overload_tick_times(torch, params, pa) -> dict:
    """The mixed tick at the main path's shape (seven decode rows beside a
    prefill chunk, width 256, bf16) with the chunk the budget leaves at
    budget_frac 1.0 (249 tokens) and 0.25 (57): the forward's time, host
    issue and device busy time, and #1 alone at that tick's rows (events,
    device time, its bound and SDPA's device time over the same rows);
    #5 at a hedged /score's dispatch (one row of 128, f32, causal), the
    same four readings."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models.transformer import (
        KVCache,
        transformer_step_rows_ragged,
    )
    from tpu_engine_torch.ops import flash as fl

    cfg = create_model("llama").config
    dev = torch.device("cuda")
    q, k, v, tables, pos0, qlen = main_path_inputs(torch, dev, False)
    shape = (cfg.n_layers, 8 * 128 + 1, 16, cfg.kv_heads, cfg.d_head)
    caches = KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                     torch.zeros(shape, dtype=torch.bfloat16, device=dev))
    tokens = torch.randint(0, cfg.vocab, (8, 256), device=dev,
                           dtype=torch.int32)
    out = {}
    for frac in (1.0, 0.25):
        chunk = max(1, int(256 * frac) - 7)
        ql = qlen.clone()
        ql[7] = chunk
        slot = (ql - 1).clamp(min=0)

        def fwd():
            return transformer_step_rows_ragged(
                params, tokens, caches, tables, pos0, ql, cfg,
                dtype=torch.bfloat16, sample_slot=slot)[0]

        logits = fwd()
        check(bool(torch.isfinite(logits).all()),
              f"overload tick at {frac}: non-finite logits")
        ms = time_ms(torch, fwd, iters=10)
        busy = busy_ms(torch, fwd)
        call = (lambda ql=ql: pa.ragged_paged_attention(
            q, k, v, tables, pos0, ql))
        kernel = time_ms(torch, call)
        device, seen = device_call_ms(torch, call)
        bound, by = bound_ms(q, k, tables, pos0, ql, k.element_size())
        sdpa_dev, _ = device_call_ms(
            torch, sdpa_yardstick(torch, (q, k, v, tables, pos0, ql),
                                  False))
        out[f"budget_frac {frac}"] = {
            "prefill_chunk": chunk, "forward_ms": ms,
            "issue_ms": issue_ms(torch, fwd), "busy_ms": busy,
            "idle_share": idle_share(busy, ms), "ragged_ms": kernel,
            "ragged_device_ms": device, "ragged_device_calls": seen,
            "ragged_bound_ms": bound, "ragged_bound_by": by,
            "ragged_sdpa_device_ms": sdpa_dev}
    fq = torch.randn((1, 128, cfg.n_heads, cfg.d_head), device=dev)
    fk = torch.randn((1, 128, cfg.n_heads, cfg.d_head), device=dev)
    fv = torch.randn((1, 128, cfg.n_heads, cfg.d_head), device=dev)
    score_call = (lambda: fl.flash_attention_fwd(fq, fk, fv, causal=True))
    out["flash score row f32"] = time_ms(torch, score_call)
    qq, kk, vv = (t.transpose(1, 2).contiguous() for t in (fq, fk, fv))

    def score_sdpa():
        with sdpa_kernel(sdpa_backend(torch, torch.float32)):
            return F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
    fbound, fby = flash_bound_ms(fq)
    out["flash score row f32 readings"] = {
        "device_ms": device_call_ms(torch, score_call)[0],
        "bound_ms": fbound, "bound_by": fby,
        "sdpa_device_ms": device_call_ms(torch, score_sdpa)[0]}
    for key in ("budget_frac 1.0", "budget_frac 0.25"):
        r = out[key]
        log(f"overload tick ({key}: 7 decode rows + a {r['prefill_chunk']}-"
            f"token chunk, width 256, bf16): {r['forward_ms']:.3f} ms "
            f"(host issue {r['issue_ms']:.3f} ms, "
            f"{busy_text(r['busy_ms'], r['idle_share'])}), "
            f"#1 {r['ragged_ms']:.4f} ms (device {r['ragged_device_ms']:.4f}"
            f" ms, bound {r['ragged_bound_ms']:.5f} ms "
            f"({r['ragged_bound_by']}), sdpa device "
            f"{r['ragged_sdpa_device_ms']:.4f} ms)")
    fr = out["flash score row f32 readings"]
    log(f"overload: #5 at a /score row (1 x 128, f32) "
        f"{out['flash score row f32']:.4f} ms (device {fr['device_ms']:.4f} "
        f"ms, bound {fr['bound_ms']:.5f} ms ({fr['bound_by']}), sdpa "
        f"device {fr['sdpa_device_ms']:.4f} ms)")
    return out


def phase_overload(torch, card: str, pa) -> dict:
    """Overload control and crash-tolerant serving (see the module
    docstring's overload entry). The gateway's P worker starts first, as
    a process, and loads while the in-process parts run."""
    from tpu_engine_torch.models.convert import init_params
    from tpu_engine_torch.models.registry import create_model

    t0 = time.perf_counter()
    OUT_DIR.mkdir(exist_ok=True)
    proc, p_port, p_log = spawn_worker(
        ["ov-p", CUT_LLAMA, "--dtype", "float32", "--kv-block-size", "16",
         "--mixed-step", "--mixed-token-budget", "256", "--prefill-chunk",
         "256", "--n-slots", "8"], OUT_DIR / "overload_worker.log")
    out = {}
    try:
        cfg = create_model(cut_llama()).config
        params = init_params(cfg, seed=0, device="cuda", dtype="bfloat16")
        out["worker"] = overload_worker(torch, params)
        out["swap_defer"] = overload_swap_defer(torch, params)
        del params
        torch.cuda.empty_cache()
        # The tick readings stay at all 22 layers: one full-depth forward.
        params = init_params(create_model("llama").config, seed=0,
                             device="cuda", dtype="bfloat16")
        out["ticks"] = overload_tick_times(torch, params, pa)
        del params
        torch.cuda.empty_cache()
        params32 = init_params(cfg, seed=0, device="cuda", dtype="float32")
        out["identity"] = overload_identity(torch, params32)
        out["gateway"] = overload_gateway(torch, params32, proc, p_port)
        del params32
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        p_log.close()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"overload: every check passed in {out['seconds']:.1f} s [{card}]")
    return out


# -- observe: spans, /metrics, the flight recorder and the profile ------------

OBSERVE_STREAMS = 16
OBSERVE_SCORES = 8
OBSERVE_NEW = 32
OBSERVE_PROFILE_TICKS = 8
OBSERVE_PROFILE_STREAMS = 8
OBSERVE_PROFILE_NEW = 112
OBSERVE_INFER_BURST = 64
# The /infer stage split's model and its input size.
OBSERVE_INFER = ("resnet50", 224 * 224 * 3)
OBSERVE_STAGES = ("cache_lookup", "queue_wait", "batch_form",
                  "device_compute", "serialize")
# #1's two CUDA kernels, as the profiler names them.
RAGGED_KERNELS = ("ragged_split_kernel", "ragged_merge_kernel")
OBSERVE_COST_NEW = 48
_SAMPLE_LINE = (r'^[a-z_:][a-z0-9_:]*(\{[^}]*\})? '
                r'(-?[0-9.]+(e[+-]?[0-9]+)?|NaN|[+-]Inf)$')


def get_text(port: int, path: str) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        check(resp.status == 200, f"{path} answered {resp.status}")
        return data.decode()
    finally:
        conn.close()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_counted_worker_node(args, log_path: Path, counts_path: Path):
    """The worker_node command as a process of its own (``chip_smoke.py
    --serve-worker-node``) that writes its kernels' launch counts to
    ``counts_path`` when it exits: (process, port, the log's file)."""
    port = free_port()
    out = open(log_path, "w")
    proc = popen(
        [sys.executable, str(Path(__file__).resolve()),
         "--serve-worker-node", str(counts_path), str(port), *args],
        cwd=str(Path(__file__).resolve().parent), stdout=out,
        stderr=subprocess.STDOUT)
    return proc, port, out


def start_counted_worker_node(args, log_name: str, counts_name: str):
    """``spawn_counted_worker_node`` with its log and counts under OUT_DIR
    (the counts file cleared first): (process, port, the log's file, the
    counts' path)."""
    OUT_DIR.mkdir(exist_ok=True)
    counts_path = OUT_DIR / counts_name
    counts_path.unlink(missing_ok=True)
    return (*spawn_counted_worker_node(args, OUT_DIR / log_name,
                                       counts_path), counts_path)


def main_serve_worker_node(argv) -> int:
    """``--serve-worker-node COUNTS <worker_node argv>``: serve until
    SIGTERM, then write the launch counts (kernel -> [launches, plain
    calls]) to COUNTS."""
    from tpu_engine_torch.serving import cli

    from tpu_engine_torch.models.ssd import ssd_window_scan_rows

    cut_llama()  # the cut-depth TinyLlama, by its registry name
    code = cli.main(["worker_node", *argv[1:]])
    Path(argv[0]).write_text(json.dumps(launch_counts()))
    # The recurrent family's window scans: each launches #8 per layer.
    Path(argv[0] + ".scans").write_text(str(ssd_window_scan_rows.calls))
    return code


def spans_of(port: int) -> list:
    """The lane's spans (the X events of /trace/export)."""
    return [e for e in get(port, "/trace/export")["traceEvents"]
            if e.get("ph") == "X"]


def parse_metrics(text: str) -> dict:
    """{series: value} of a Prometheus exposition; every line must be a
    comment or a sample."""
    import re

    out = {}
    for ln in text.splitlines():
        if ln.startswith("#") or not ln:
            continue
        check(re.match(_SAMPLE_LINE, ln) is not None,
              f"/metrics: malformed line {ln!r}")
        key, val = ln.rsplit(" ", 1)
        out[key] = float(val)
    return out


def stage_p50_p99(stages: dict, ops) -> dict:
    return {op: {"count": stages[op]["count"],
                 "p50_ms": stages[op]["p50_us"] / 1e3,
                 "p99_ms": stages[op]["p99_us"] / 1e3} for op in ops}


def profile_capture(port: int, ticks: int, readers) -> dict:
    """POST /admin/profile {"ticks"} while ``readers`` stream, wait for
    the capture to end and read its Chrome trace: #1's split and merge
    kernels' launches, each device event name's count and summed
    microseconds. Up to three captures while one keeps no device event;
    none keeping one fails the phase."""
    for attempt in range(1, 4):
        check(all(r.final is None for r in readers),
              "observe profile: the burst ended before the capture")
        t_start = time.perf_counter()
        res = post(port, "/admin/profile", {"ticks": ticks})
        check(res.get("ok") and res.get("ticks") == ticks,
              f"observe profile: {res}")
        log(f"observe profile: capture {attempt} opened in "
            f"{(time.perf_counter() - t_start) * 1e3:.1f} ms")
        t0 = time.perf_counter()
        while True:
            st = get(port, "/admin/profile")
            if st["ticks_left"] == 0 and st["last_result"]:
                break
            check(time.perf_counter() - t0 < 120,
                  f"observe profile: capture did not end: {st}")
            time.sleep(0.05)
        last = st["last_result"]
        check(last.get("ok"), f"observe profile: {last}")
        log(f"observe profile: capture {attempt}: {last['events']} events, "
            f"{last['device_events']} on the card ({last['trace_file']})")
        if last["device_events"] > 0:
            break
    check(last["device_events"] > 0,
          "observe profile: three captures kept no device event")
    with open(last["trace_file"]) as f:
        events = json.load(f)["traceEvents"]
    by_name = {}
    for ev in events:
        if ev.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        c = by_name.setdefault(ev["name"], [0, 0.0])
        c[0] += 1
        c[1] += float(ev.get("dur", 0))
    ragged = {k: sum(c[0] for n, c in by_name.items() if k in n)
              for k in RAGGED_KERNELS}
    return {"captures": attempt, "trace_file": last["trace_file"],
            "events": last["events"], "device_events": last["device_events"],
            "by_name": by_name, "ragged_launches": ragged,
            "host_self_us": host_self_us(events)}


def host_self_us(events) -> dict:
    """Summed self time (microseconds) per CPU op name on the thread with
    the most CPU ops (the decode thread, which opened the capture): each
    op's duration less that of the ops nested in it."""
    ops = [e for e in events if e.get("cat") == "cpu_op" and "dur" in e]
    if not ops:
        return {}
    tids = {}
    for e in ops:
        tids[e["tid"]] = tids.get(e["tid"], 0) + 1
    tid = max(tids, key=tids.get)
    mine = sorted((e for e in ops if e["tid"] == tid),
                  key=lambda e: (e["ts"], -e["dur"]))
    self_us, stack = {}, []
    for e in mine:
        end = e["ts"] + e["dur"]
        while stack and stack[-1][1] <= e["ts"]:
            stack.pop()
        if stack:  # nested: its time is not its parent's own
            parent = stack[-1][0]
            self_us[parent["name"]] = (self_us.get(parent["name"], 0.0)
                                       - e["dur"])
        self_us[e["name"]] = self_us.get(e["name"], 0.0) + e["dur"]
        stack.append((e, end))
    return self_us


def start_observe_spec_lane() -> tuple:
    return start_counted_worker_node(
        ["obs-spec", CUT_LLAMA, "--kv-block-size", "16", "--mixed-step",
         "--mixed-token-budget", "256", "--prefill-chunk", "256",
         "--n-slots", "8", "--spec-k", str(SPEC_K),
         "--flight-recorder", "256",
         "--flight-dump-dir", str((OUT_DIR / "flight").resolve()),
         "--profile-dir", str((OUT_DIR / "profile").resolve())],
        "observe_worker.log", "observe_counts.json")


def observe_spec_lane(card: str, cfg, started: tuple) -> dict:
    """Parts 1-3: the mixed-bf16 spec lane as a worker_node process
    (``start_observe_spec_lane`` starts it; ``cfg``: the llama registry
    entry's geometry)."""
    proc, port, out_f, counts_path = started
    out = {}
    try:
        out["ready_s"] = wait_health(proc, port)
        rng = np.random.default_rng(7)
        vocab, n_layers = cfg.vocab, cfg.n_layers

        def toks(n):
            return [int(t) for t in rng.integers(1, vocab, n)]
        # Part 1: a burst of streams and /score rows.
        streams = [StreamReader(port, {
            "request_id": f"os{i}", "max_new_tokens": OBSERVE_NEW,
            "prompt_tokens": toks(int(rng.integers(64, 200)))})
            for i in range(OBSERVE_STREAMS)]
        scores = {f"oc{i}": {"request_id": f"oc{i}",
                             "prompt_tokens": toks(64),
                             "completion_tokens": toks(16)}
                  for i in range(OBSERVE_SCORES)}
        t0 = time.perf_counter()
        for r in streams:
            r.start()
        score_res, _ = concurrent_posts(port, "/score", scores)
        for r in streams:
            r.join(timeout=600)
        out["burst_s"] = time.perf_counter() - t0
        for r in streams:
            check(r.final is not None and "error" not in r.final
                  and len(r.tokens) == OBSERVE_NEW,
                  f"observe stream {r.body['request_id']}: {r.final} "
                  f"{r.error}")
        check(all(len(s["logprobs"]) == 16 for s in score_res.values()),
              "observe: /score answers")
        st, idle = wait_idle(port, paged=True)
        check(idle, f"observe: blocks leaked: {st['kv_pool']}")
        spans = spans_of(port)
        ops = {}
        for e in spans:
            ops.setdefault(e["args"]["request_id"], {}).setdefault(
                e["name"], 0)
            ops[e["args"]["request_id"]][e["name"]] += 1
        for r in streams:
            mine = ops.get(r.body["request_id"], {})
            check(all(mine.get(op) == 1 for op in (
                "generate_stream", "queue_wait", "radix_lookup",
                "kv_alloc", "decode")),
                f"observe: stream {r.body['request_id']} spans {mine}")
        check(sum(m.get("generate_stream", 0) for m in ops.values())
              == OBSERVE_STREAMS, f"observe: root spans {ops}")
        for rid in scores:
            mine = ops.get(rid, {})
            check(all(mine.get(op) == 1 for op in (
                "score", "admission", "queue_wait", "batch_form",
                "device_compute")), f"observe: /score {rid} spans {mine}")
        tick_ops = ops.get("tick", {})
        mixed, spec = st["mixed"], st["spec"]
        check(tick_ops.get("mixed_step") == mixed["ticks"]
              == tick_ops.get("spec_verify") == spec["ticks"] > 0,
              f"observe: tick spans {tick_ops} vs mixed {mixed['ticks']}, "
              f"spec {spec['ticks']}")
        metrics = parse_metrics(get_text(port, "/metrics"))
        node = '{node="obs-spec"}'
        lane = '{node="obs-spec",lane="continuous"}'
        check(metrics[f"tpu_engine_ttft_seconds_count{node}"]
              == OBSERVE_STREAMS, "observe: ttft count "
              f"{metrics.get(f'tpu_engine_ttft_seconds_count{node}')}")
        for key in ("dispatches", "proposed_tokens", "accepted_tokens",
                    "emitted_tokens"):
            name = f"tpu_engine_spec_{key}_total{lane}"
            check(metrics[name] == spec[key],
                  f"observe: {name} {metrics[name]} != {spec[key]}")
        out["burst"] = {"ticks": mixed["ticks"],
                        "spec": {k: spec[k] for k in (
                            "dispatches", "proposed_tokens",
                            "accepted_tokens", "emitted_tokens")},
                        "metrics": len(metrics), "spans": len(spans)}
        log(f"observe burst: {OBSERVE_STREAMS} streams and "
            f"{OBSERVE_SCORES} /score in {out['burst_s']:.2f} s; "
            f"{len(spans)} spans, mixed_step == spec_verify == "
            f"{mixed['ticks']} ticks; /metrics {len(metrics)} series, "
            f"ttft count {OBSERVE_STREAMS}, spec counters == stats")
        # Part 2: a tick-bounded capture during a second burst.
        b2_wall = time.time()
        readers = [StreamReader(port, {
            "request_id": f"op{i}", "max_new_tokens": OBSERVE_PROFILE_NEW,
            "prompt_tokens": toks(128)})
            for i in range(OBSERVE_PROFILE_STREAMS)]
        for r in readers:
            r.start()
        t0 = time.perf_counter()
        while min(len(r.tokens) for r in readers) < 2:
            check(time.perf_counter() - t0 < 120,
                  "observe profile: the second burst did not start")
            time.sleep(0.005)
        cap = profile_capture(port, OBSERVE_PROFILE_TICKS, readers)
        for r in readers:
            r.join(timeout=600)
            check(r.final is not None and "error" not in r.final,
                  f"observe profile stream: {r.final} {r.error}")
        want = n_layers * OBSERVE_PROFILE_TICKS
        check(all(cap["ragged_launches"][k] == want
                  for k in RAGGED_KERNELS),
              f"observe profile: #1 launches in the trace "
              f"{cap['ragged_launches']}, want {want} of each")
        st, idle = wait_idle(port, paged=True)
        check(idle, f"observe: blocks leaked: {st['kv_pool']}")
        walls = [e["dur"] / 1e3 for e in spans_of(port)
                 if e["name"] == "spec_verify"
                 and e["ts"] / 1e6 >= b2_wall]
        per_tick = {n: {"launches": c[0],
                        "ms_per_tick": c[1] / 1e3 / OBSERVE_PROFILE_TICKS}
                    for n, c in cap["by_name"].items()}
        host = {n: us / 1e3 / OBSERVE_PROFILE_TICKS
                for n, us in cap["host_self_us"].items()}
        busy = sum(v["ms_per_tick"] for v in per_tick.values())
        ragged_ms = sum(v["ms_per_tick"] for n, v in per_tick.items()
                        if any(k in n for k in RAGGED_KERNELS))
        wall = float(np.mean(walls))
        out["profile"] = {
            "captures": cap["captures"], "events": cap["events"],
            "device_events": cap["device_events"],
            "ragged_launches": cap["ragged_launches"],
            "tick_wall_ms_mean": wall, "tick_wall_ms_p50_p99":
                p50_p99_ms(np.array(walls) / 1e3),
            "ticks_in_burst": len(walls), "device_busy_ms_per_tick": busy,
            "ragged_ms_per_tick": ragged_ms,
            "top_kernels_ms_per_tick": dict(sorted(
                ((n, v["ms_per_tick"]) for n, v in per_tick.items()),
                key=lambda kv: -kv[1])[:8]),
            "host_ops_self_ms_per_tick": sum(host.values()),
            "top_host_ops_self_ms_per_tick": dict(sorted(
                host.items(), key=lambda kv: -kv[1])[:10])}
        log(f"observe profile: {OBSERVE_PROFILE_TICKS} ticks of "
            f"{OBSERVE_PROFILE_STREAMS} decode rows (spec_k {SPEC_K}, "
            f"bf16): #1 split/merge launches "
            f"{cap['ragged_launches']} == {n_layers} x "
            f"{OBSERVE_PROFILE_TICKS}; "
            f"device busy {busy:.3f} ms a tick (#1 {ragged_ms:.3f} ms) "
            f"against a tick span wall of {wall:.3f} ms (mean of "
            f"{len(walls)} ticks; idle {100 * max(0, 1 - busy / wall):.1f}"
            f"%); the decode thread's CPU ops {sum(host.values()):.3f} ms "
            f"a tick (self time), the largest "
            + ", ".join(f"{n} {v:.3f}" for n, v in sorted(
                host.items(), key=lambda kv: -kv[1])[:5]) + f" [{card}]")
        # Part 3: a forced flight-recorder dump.
        tl = get(port, "/admin/timeline")
        check(tl["enabled"] and tl["capacity"] == 256 and tl["ticks"] > 0,
              f"observe timeline: {dict(tl, timeline=len(tl['timeline']))}")
        dump = post(port, "/admin/timeline", {"dump": "smoke"})["dumped"]
        check(dump is not None and dump["path"]
              and os.path.exists(dump["path"]), f"observe dump: {dump}")
        with open(dump["path"]) as f:
            ring = json.load(f)["timeline"]
        busy_ticks = [r for r in ring if r["active"] > 0]
        check(busy_ticks and all(r["tick_wall_ms"] > 0 for r in ring),
              f"observe dump: {len(ring)} records, {len(busy_ticks)} busy")
        out["dump"] = {"path": dump["path"], "records": len(ring),
                       "busy_records": len(busy_ticks)}
        health = get(port, "/health")["generator"]
        oneshot = health["stateless"]["dispatches"]
        ticks = health["mixed"]["ticks"]
        check(health["spec"]["ticks"] == ticks, f"observe: {health}")
        proc.send_signal(__import__("signal").SIGTERM)
        check(proc.wait(timeout=120) == 0, "observe: worker exit code")
        counts = json.loads(counts_path.read_text())
        check(all(p == 0 for _n, p in counts.values()),
              f"observe: plain versions served attention: {counts}")
        ragged = counts["ragged_paged_attention"][0]
        flash = counts["flash_attention"][0]
        check(all(n == 0 for k, (n, _p) in counts.items()
                  if k not in ("ragged_paged_attention", "flash_attention")),
              f"observe: other kernels launched: {counts}")
        check(ragged == n_layers * ticks and flash == n_layers * oneshot
              and oneshot > 0,
              f"observe: {ragged} #1 launches for {ticks} ticks, {flash} "
              f"#5 for {oneshot} one-shot dispatches")
        out.update(launches={"ragged_paged_attention": ragged,
                             "flash_attention": flash},
                   ticks=ticks, oneshot_dispatches=oneshot)
        log(f"observe lane: #1 launches {ragged} == {n_layers} x {ticks} "
            f"ticks, #5 {flash} == {n_layers} x {oneshot} one-shot "
            f"dispatches, no plain "
            f"call; flight dump {len(ring)} records")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        out_f.close()
    return out


def observe_two_path(torch, params, cfg) -> dict:
    """Part 4: the two-path-bf16 lane with spans on, counts from 0: JAX's
    two-path scheduler records no tick span (its ticks are decode chunks),
    each stream's decode span covers its chunks, and #2 launches layers x
    the chunk's steps per chunk."""
    from tpu_engine_torch.ops import kernels

    worker, server = start_lane(torch, params, "two-path-bf16",
                                model=cut_llama(), node_id="obs-two-path")
    port = server.port
    rng = np.random.default_rng(8)
    try:
        kernels.reset_counts()
        bodies = {f"ot{i}": {"request_id": f"ot{i}",
                             "prompt_tokens": [int(t) for t in
                                               rng.integers(1, cfg.vocab,
                                                            100)],
                             "max_new_tokens": OBSERVE_NEW}
                  for i in range(4)}
        res, wall = concurrent_posts(port, "/generate", bodies)
        st, idle = wait_idle(port, paged=True)
        check(idle, f"observe two-path: blocks leaked: {st['kv_pool']}")
        launches = check_counts("observe two-path", "paged_attention")
        spans = spans_of(port)
        ops = {}
        for e in spans:
            key = (e["args"]["request_id"], e["name"])
            ops[key] = ops.get(key, 0) + 1
        check(not [k for k in ops if k[0] == "tick"],
              f"observe two-path: tick spans {ops}")
        for rid in bodies:
            check(all(ops.get((rid, op)) == 1 for op in (
                "generate", "queue_wait", "radix_lookup", "prefill",
                "kv_alloc", "decode")), f"observe two-path {rid}: {ops}")
        chunks = st["chunks"]
        check(chunks > 0 and launches == cfg.n_layers * 16 * chunks,
              f"observe two-path: {launches} #2 launches for {chunks} "
              f"chunks of 16 steps")
        decode_ms = [e["dur"] / 1e3 for e in spans if e["name"] == "decode"]
    finally:
        server.stop()
        worker.stop()
    log(f"observe two-path: #2 launches {launches} == {cfg.n_layers} x 16 "
        f"x {chunks} "
        f"chunks; no tick span (as JAX's two-path lane); decode spans "
        f"{np.mean(decode_ms):.1f} ms mean over {len(decode_ms)} streams")
    return {"launches": launches, "chunks": chunks, "burst_s": wall,
            "decode_span_ms_mean": float(np.mean(decode_ms))}


def observe_infer_stages(torch) -> dict:
    """Part 5: a resnet50 /infer miss burst and its stage split."""
    from tpu_engine_torch.serving.app import serve_worker
    from tpu_engine_torch.utils.config import WorkerConfig

    model, n_in = OBSERVE_INFER
    with served_conv_precision(torch):
        worker, server = serve_worker(WorkerConfig(
            port=0, node_id="obs-infer", model=model,
            dtype="bfloat16", max_batch_size=32, device="cuda", seed=0))
        port = server.port
        rng = np.random.default_rng(9)
        try:
            post(port, "/infer", {"request_id": "warm", "input_data":
                                  np.round(rng.random(n_in), 3).tolist()})
            bodies = {f"oi{i}": json.dumps({
                "request_id": f"oi{i}",
                "input_data": np.round(rng.random(n_in, np.float32),
                                       3).tolist()
            }).encode() for i in range(OBSERVE_INFER_BURST)}
            res, wall = concurrent_posts(port, "/infer", bodies)
            n_out = int(np.prod(worker.engine.spec.output_shape))
            check(all(len(r["output_data"]) == n_out and not r["cached"]
                      for r in res.values()), "observe /infer answers")
            stages = get(port, "/trace")["stages"]["obs-infer"]
        finally:
            server.stop()
            worker.stop()
    split = stage_p50_p99(stages, OBSERVE_STAGES + ("infer",))
    for op in OBSERVE_STAGES:
        check(split[op]["count"] >= OBSERVE_INFER_BURST,
              f"observe /infer: {op} {split[op]}")
    log(f"observe /infer ({model} bf16, a burst of 64 distinct misses, "
        f"{wall:.2f} s): " + ", ".join(
            f"{op} p50 {v['p50_ms']:.3f} / p99 {v['p99_ms']:.3f} ms"
            for op, v in split.items()))
    return {"burst_s": wall, "stages": split}


def observe_span_cost(torch, params, cfg) -> dict:
    """Part 6: the mixed W = 1 tick (eight decode rows) with spans on
    (trace_capacity 2048) and off (0), one lane after the other: the mean
    wall of the flight recorder's ticks with eight decode rows and no
    prefill."""
    rng = np.random.default_rng(10)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, 16)]
               for _ in range(8)]
    out = {}
    for cap in (2048, 0):
        worker, server = start_lane(
            torch, params, "mixed-bf16", model=cut_llama(),
            node_id=f"obs-cost-{cap}",
            overrides=dict(LANES["mixed-bf16"], trace_capacity=cap,
                           flight_recorder=1024))
        try:
            concurrent_posts(server.port, "/generate", {
                f"w{i}": {"request_id": f"w{i}", "prompt_tokens": p,
                          "max_new_tokens": OBSERVE_COST_NEW}
                for i, p in enumerate(prompts)})
            ring = worker.generator.flight_timeline()["timeline"]
        finally:
            server.stop()
            worker.stop()
        w1 = [r["tick_wall_ms"] for r in ring
              if r["active"] == 8 and r.get("prefilling") == 0
              and r.get("decode_tokens") == 8]
        check(len(w1) >= OBSERVE_COST_NEW // 2,
              f"observe span cost: {len(w1)} W = 1 ticks at {cap}")
        out[f"trace_capacity {cap}"] = {
            "ticks": len(w1), "tick_ms_mean": float(np.mean(w1)),
            "tick_ms_p50": float(np.median(w1))}
    from tpu_engine_torch.utils.tracing import SpanRecorder

    rec = SpanRecorder(2048)
    t0 = time.perf_counter()
    for i in range(20000):
        rec.record("r", "decode", "n", 10.0, trace_id="t", span_id="s",
                   parent_id="p", start_ts=1.0, attrs={"tokens": i})
    out["record_us"] = (time.perf_counter() - t0) / 20000 * 1e6
    on, off = (out[f"trace_capacity {c}"] for c in (2048, 0))
    log(f"observe span cost: the mixed W = 1 tick {on['tick_ms_mean']:.3f} "
        f"ms with spans (mean of {on['ticks']}), {off['tick_ms_mean']:.3f} "
        f"ms without ({off['ticks']}); one record() "
        f"{out['record_us']:.2f} us on the host")
    return out


def observe_gateway(torch, params32, cfg, proc, p_port: int) -> dict:
    """Part 7: two f32 mixed workers (P the worker command as a process,
    L in process) behind the gateway command with --trace-stitch and SLO
    objectives; P killed (SIGKILL) while a greedy stream it owns runs: the
    stream resumes on L and the gateway's stitch of it has zero
    orphans; /admin/slo answers, /metrics has tpu_engine_slo_*."""
    import signal

    worker, server = start_lane(
        torch, params32, "observe-gw-l", model=cut_llama(), node_id="obs-l",
        dtype="float32",
        overrides=dict(PAGED, gen_mixed_step=True,
                       gen_mixed_token_budget=256, trace_stitch=True))
    l_port = server.port
    p_url, l_url = f"127.0.0.1:{p_port}", f"127.0.0.1:{l_port}"
    ring = ring_of([p_url, l_url])
    g_port = free_port()
    g_log = open(OUT_DIR / "observe_gateway.log", "w")
    gproc = popen(
        [sys.executable, "-m", "tpu_engine_torch.serving.cli", "gateway",
         p_url, l_url, "--port", str(g_port), "--failover-streams",
         "--health-probe-interval", str(PROBE_INTERVAL_S),
         "--trace-stitch", "--slo-ttft-p99-ms", "500",
         "--slo-completion-p99-ms", "5000"],
        cwd=str(Path(__file__).resolve().parent), stdout=g_log,
        stderr=subprocess.STDOUT)
    try:
        wait_health(proc, p_port)
        t0 = time.perf_counter()
        while True:
            try:
                get(g_port, "/stats")
                break
            except (OSError, http.client.HTTPException, SmokeFailure):
                check(gproc.poll() is None and time.perf_counter() - t0 < 120,
                      f"gateway command did not start: {gproc.poll()}")
                time.sleep(0.1)
        post(p_port, "/generate", {"request_id": "warm-p",
                                   "prompt_tokens": [5, 6, 7],
                                   "max_new_tokens": 4})
        rng = np.random.default_rng(11)
        rid = owned(ring, p_url, 1, "obs-failover-")[0]
        body = {"request_id": rid, "max_new_tokens": FAILOVER_NEW,
                "prompt_tokens": [int(t) for t in rng.integers(1, cfg.vocab,
                                                               64)]}
        reader = StreamReader(g_port, body)
        reader.start()
        t0 = time.perf_counter()
        while len(reader.tokens) < FAILOVER_AT:
            check(time.perf_counter() - t0 < 120 and reader.final is None,
                  f"observe failover: {len(reader.tokens)} tokens")
            time.sleep(0.002)
        proc.kill()
        reader.join(timeout=600)
        check(reader.final is not None and reader.final.get("resumed") == 1
              and len(reader.tokens) == FAILOVER_NEW,
              f"observe failover: {reader.final} {reader.error}")
        stitched = get(g_port, f"/admin/trace/{rid}")
        ops = {}
        for s in stitched["spans"]:
            ops[s["op"]] = ops.get(s["op"], 0) + 1
        check(stitched["orphans"] == 0
              and [h["kind"] for h in stitched["hops"]] == ["admit",
                                                            "resume"]
              and stitched["lanes"] == sorted(["gateway", l_url])
              and ops.get("stream") == 1 and ops.get("resume") == 1
              and ops.get("generate_stream") == 1,
              f"observe stitch: orphans {stitched['orphans']}, hops "
              f"{stitched['hops']}, lanes {stitched['lanes']}, ops {ops}")
        slo = get(g_port, "/admin/slo")
        check(set(slo.get("objectives", {})) == {"ttft", "completion"},
              f"observe /admin/slo: {slo}")
        metrics = parse_metrics(get_text(g_port, "/metrics"))
        slo_series = sorted(k for k in metrics
                            if k.startswith("tpu_engine_slo_"))
        check(any(k.startswith("tpu_engine_slo_target") for k in slo_series)
              and any(k.startswith("tpu_engine_slo_burn_rate")
                      for k in slo_series),
              f"observe: slo metrics {slo_series}")
        gproc.send_signal(signal.SIGTERM)
        check(gproc.wait(timeout=60) == 0, "observe gateway exit code")
    finally:
        if gproc.poll() is None:
            gproc.kill()
            gproc.wait(timeout=60)
        g_log.close()
        server.stop()
        worker.stop()
    log(f"observe gateway: a stream owned by the killed P resumed on L; "
        f"its stitch has {len(stitched['spans'])} spans from "
        f"{stitched['lanes']}, 0 orphans, hops admit + resume; /admin/slo "
        f"objectives {sorted(slo['objectives'])}; {len(slo_series)} "
        f"tpu_engine_slo_* series")
    return {"spans": len(stitched["spans"]), "ops": ops,
            "slo": slo, "slo_series": slo_series}


def phase_observe(torch, card: str) -> dict:
    """Spans, /metrics, the flight recorder and the tick-bounded profile
    on the card (see the module docstring's observe entry)."""
    from tpu_engine_torch.models.convert import init_params
    from tpu_engine_torch.models.registry import create_model

    t0 = time.perf_counter()
    OUT_DIR.mkdir(exist_ok=True)
    # P of part 7 starts first and loads while the other parts run.
    proc, p_port, p_log = spawn_worker(
        ["obs-p", CUT_LLAMA, "--dtype", "float32", "--kv-block-size", "16",
         "--mixed-step", "--mixed-token-budget", "256", "--prefill-chunk",
         "256", "--n-slots", "8", "--trace-stitch"],
        OUT_DIR / "observe_p_worker.log")
    out = {}
    cfg = create_model(cut_llama()).config
    try:
        # The spec lane's process loads while parts 4-6 run in process.
        started = start_observe_spec_lane()
        params = init_params(cfg, seed=0, device="cuda", dtype="bfloat16")
        out["two_path"] = observe_two_path(torch, params, cfg)
        out["span_cost"] = observe_span_cost(torch, params, cfg)
        del params
        out["infer"] = observe_infer_stages(torch)
        torch.cuda.empty_cache()
        out["spec_lane"] = observe_spec_lane(card, cfg, started)
        params32 = init_params(cfg, seed=0, device="cuda", dtype="float32")
        out["gateway"] = observe_gateway(torch, params32, cfg, proc, p_port)
        del params32
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        p_log.close()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"observe: every check passed in {out['seconds']:.1f} s [{card}]")
    return out


# -- the handoff phase ---------------------------------------------------------

HANDOFF_PREFIX = 512          # the shared prefix of half the burst
HANDOFF_STREAMS = 16
HANDOFF_NEW = 32
HANDOFF_IDENTITY = 3
HANDOFF_DRAIN_NEW = 128
HANDOFF_DRAIN_AT = 16
HANDOFF_AFFINITY = 8
HANDOFF_LANES = (("hand-p", "prefill"), ("hand-d1", "decode"),
                 ("hand-d2", "decode"))
HANDOFF_LANE_ARGS = (CUT_LLAMA, "--kv-block-size", "16", "--mixed-step",
                     "--mixed-token-budget", "256", "--prefill-chunk",
                     "256", "--n-slots", "8", "--prefix-fetch")


def kv_handoff_spans_match(gw) -> dict:
    """The gateway's handoff counters, each checked equal to its
    kv_handoff marker spans."""
    from tpu_engine_torch.serving.resilience import HandoffCounters

    ho = gw.get_stats()["handoff"]
    spans = [s["attrs"]["decision"] for s in gw.tracer.snapshot()
             if s["op"] == "kv_handoff"]
    for field in HandoffCounters.SPAN_FIELDS:
        check(spans.count(field) == ho[field],
              f"handoff: {field} {ho[field]} != {spans.count(field)} spans")
    return ho


def gateway_stream(gw, body: dict, out=None) -> dict:
    """One stream through an in-process gateway: tokens, their arrival
    times, the terminal event, filled into ``out`` as they arrive."""
    out = {} if out is None else out
    out.update(tokens=[], times=[], final=None)
    for frame in gw.route_generate_stream(dict(body)):
        ev = json.loads(frame[len(b"data: "):])
        if ev.get("done"):
            out["final"] = ev
            break
        now = time.perf_counter()
        for t in ev.get("tokens", ()):
            out["tokens"].append(t)
            out["times"].append(now)
    return out


def handoff_burst(gw, g_port: int, ports: dict, toks) -> dict:
    """16 greedy streams through the disaggregating gateway: 8 share a
    512-token prefix, 8 are distinct, prompts of 520-600 tokens."""
    rng = np.random.default_rng(16)
    shared = toks(HANDOFF_PREFIX)
    prompts = ([shared + toks(int(rng.integers(8, 89))) for _ in range(8)]
               + [toks(int(rng.integers(520, 601))) for _ in range(8)])
    before = {n: generator_stats(p) for n, p in ports.items()}
    readers = [StreamReader(g_port, {"request_id": f"hb{i}",
                                     "prompt_tokens": p,
                                     "max_new_tokens": HANDOFF_NEW})
               for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for r in readers:
        r.t0 = time.perf_counter()
        r.start()
    for r in readers:
        r.join(timeout=600)
    wall = time.perf_counter() - t0
    for r in readers:
        check(r.final is not None and "error" not in r.final
              and len(r.tokens) == HANDOFF_NEW
              and r.final.get("node_id") in ("hand-d1", "hand-d2"),
              f"handoff burst {r.body['request_id']}: {r.final} {r.error}")
    ho = kv_handoff_spans_match(gw)
    check(ho["handoffs_attempted"] == HANDOFF_STREAMS
          and ho["handoffs_spliced"] == HANDOFF_STREAMS
          and ho["prefill_routed"] == HANDOFF_STREAMS
          and all(ho[f] == 0 for f in (
              "handoff_fallbacks", "export_refusals", "dispatch_failed",
              "destination_unavailable", "prefill_unavailable")),
          f"handoff burst: {ho}")
    after = {n: generator_stats(p) for n, p in ports.items()}
    for n in ("hand-d1", "hand-d2"):
        moved = (after[n]["kv_pool"]["prefilled_tokens"]
                 - before[n]["kv_pool"]["prefilled_tokens"])
        check(moved == 0, f"handoff: {n} re-prefilled {moved} tokens")
    p_decode = (after["hand-p"]["mixed"]["decode_tokens"]
                - before["hand-p"]["mixed"]["decode_tokens"])
    check(p_decode == 0, f"handoff: P decoded {p_decode} tokens")
    held = after["hand-p"]["handoff"]
    check(held["holds"] >= HANDOFF_STREAMS and held["held_rows"] == 0
          and held["park_expired"] == 0, f"handoff: P holds {held}")
    ttft = [r.times[0] - r.t0 for r in readers]
    gap = [r.times[1] - r.times[0] for r in readers]
    decoded_on = {}
    for r in readers:
        decoded_on[r.final["node_id"]] = (
            decoded_on.get(r.final["node_id"], 0) + 1)
    return {"wall_s": wall, "ttft_ms": p50_p99_ms(ttft)
            + (float(max(ttft)) * 1e3,),
            "handoff_gap_ms": {"p50": float(np.median(gap)) * 1e3,
                               "max": float(max(gap)) * 1e3},
            "decoded_on": decoded_on, "counters": ho, "p_holds": held}


def handoff_identity(gw, ports: dict, toks) -> list:
    """Three streams one at a time through the handoff, each equal to the
    same request straight to P without the handoff flag (sent twice: the
    second, the control, resumes from P's radix as the handoff's prefill
    does)."""
    rng = np.random.default_rng(17)
    out = []
    for i in range(HANDOFF_IDENTITY):
        prompt = toks(int(rng.integers(520, 601)))
        body = {"prompt_tokens": prompt, "max_new_tokens": HANDOFF_NEW}
        post(ports["hand-p"], "/generate", dict(body, request_id=f"hw{i}"))
        control = post(ports["hand-p"], "/generate",
                       dict(body, request_id=f"hc{i}"))["tokens"]
        got = gateway_stream(gw, dict(body, request_id=f"hi{i}"))
        check(got["tokens"] == control and got["final"]["node_id"]
              in ("hand-d1", "hand-d2"),
              f"handoff identity {i}: {got['tokens']} != {control} "
              f"({got['final']})")
        out.append(got["final"]["node_id"])
    return out


def handoff_chain(ports: dict, toks) -> dict:
    """One handoff by hand over HTTP: a parked row's export after prefill
    from P (its wire bytes and round trip) and its import on D1 (to the
    first continued token)."""
    prompt = toks(560)
    rid = "hx-chain"
    src = StreamReader(ports["hand-p"], {
        "request_id": rid, "prompt_tokens": prompt,
        "max_new_tokens": HANDOFF_NEW, "handoff": True,
        "handoff_park_ms": 60000.0})
    src.start()
    t0 = time.perf_counter()
    snap = post(ports["hand-p"], "/admin/migrate",
                {"request_id": rid, "wait_prefill": True, "timeout_s": 60})
    export_ms = (time.perf_counter() - t0) * 1e3
    check(snap.get("ok") and len(snap["emitted"]) == 1,
          f"handoff chain: export {str(snap)[:300]}")
    src.join(timeout=60)
    check(src.final is not None and src.final.get("migrated"),
          f"handoff chain: source stream {src.final}")
    cont = {k: v for k, v in snap.items() if k not in ("ok", "node_id")}
    body = json.dumps({"request_id": rid + "-b", "prompt_tokens": [],
                       "migrate_import": cont})
    pre = generator_stats(ports["hand-d1"])["kv_pool"]["prefilled_tokens"]
    dst = StreamReader(ports["hand-d1"], json.loads(body))
    t1 = time.perf_counter()
    dst.start()
    dst.join(timeout=120)
    check(dst.final is not None and "error" not in dst.final
          and len(src.tokens) + len(dst.tokens) == HANDOFF_NEW,
          f"handoff chain: import {dst.final} {dst.error}")
    check(generator_stats(ports["hand-d1"])["kv_pool"]["prefilled_tokens"]
          == pre, "handoff chain: the import prefilled")
    return {"prompt_tokens": len(prompt),
            "chain_blocks": len(snap["chain"]["blocks"]),
            "wire_bytes": len(json.dumps(snap)),
            "export_ms": export_ms,
            "import_to_first_token_ms": (dst.times[0] - t1) * 1e3}


def handoff_drain(urls: dict, ports: dict, toks) -> dict:
    """A 128-token stream on D1 behind a gateway of D1 and D2 with
    migrate_streams; remove_worker(D1, drain=True) after 16 tokens: the
    stream splices onto D2 and equals the undrained run (sent to D2
    first); then D1 goes back."""
    from tpu_engine_torch.serving.gateway import Gateway
    from tpu_engine_torch.utils.config import GatewayConfig

    d1, d2 = urls["hand-d1"], urls["hand-d2"]
    gw = Gateway([d1, d2], GatewayConfig(failover_streams=True,
                                         migrate_streams=True,
                                         migrate_timeout_s=60.0))
    try:
        prompt = toks(300)
        control = post(ports["hand-d2"], "/generate", {
            "request_id": "hd-ctl", "prompt_tokens": prompt,
            "max_new_tokens": HANDOFF_DRAIN_NEW})["tokens"]
        rid = owned(gw._ring, d1, 1, "hd-")[0]
        res = {"tokens": []}

        def run():
            gateway_stream(gw, {"request_id": rid, "prompt_tokens": prompt,
                                "max_new_tokens": HANDOFF_DRAIN_NEW}, res)
        pre = generator_stats(ports["hand-d2"])["kv_pool"][
            "prefilled_tokens"]
        th = threading.Thread(target=run, daemon=True)
        t0 = time.perf_counter()
        th.start()
        while len(res.get("tokens", ())) < HANDOFF_DRAIN_AT:
            check(time.perf_counter() - t0 < 120 and th.is_alive(),
                  f"handoff drain: {len(res.get('tokens', ()))} tokens")
            time.sleep(0.002)
        check(gw.active_streams().get(rid) == d1,
              f"handoff drain: stream on {gw.active_streams()}")
        t_drain = time.perf_counter()
        gw.remove_worker(d1, drain=True)
        drain_s = time.perf_counter() - t_drain
        th.join(timeout=600)
        final = res["final"]
        st = gw.get_stats()
        check(final is not None and "error" not in final
              and "resumed" not in final and res["tokens"] == control
              and final["node_id"] == "hand-d2",
              f"handoff drain: {final}; equal {res['tokens'] == control}")
        check(st["migration"]["streams_migrated"] == 1
              and st["migration"]["migration_fallbacks"] == 0
              and st["failover"]["tokens_replayed"] == 0,
              f"handoff drain: {st['migration']} {st['failover']}")
        check(generator_stats(ports["hand-d2"])["kv_pool"][
            "prefilled_tokens"] == pre, "handoff drain: D2 re-prefilled")
        gaps = np.diff(res["times"])
        at = int(np.argmax(gaps))
        out = {"remove_worker_s": drain_s, "splice_gap_ms":
               float(gaps[at]) * 1e3, "splice_after_token": at + 1,
               "median_itl_ms": float(np.median(gaps)) * 1e3,
               "migration": st["migration"]}
    finally:
        gw.stop()
    post(ports["hand-d1"], "/admin/drain", {"action": "undrain"})
    return out


def handoff_role_flip(gw, g_port: int, urls: dict, toks) -> dict:
    """POST /admin/role on the gateway flips D2 to prefill and back; while
    flipped, a stream hands off to D1, the only decode lane."""
    d2 = urls["hand-d2"]
    flip = post(g_port, "/admin/role", {"node": d2, "role": "prefill"})
    check(flip == {"ok": True, "node_id": d2, "role": "prefill",
                   "drained": True}, f"role flip: {flip}")
    check(gw.worker_roles()[d2] == "prefill",
          f"role flip: {gw.worker_roles()}")
    got = gateway_stream(gw, {"request_id": "hr1", "prompt_tokens":
                              toks(300), "max_new_tokens": 8})
    check(got["final"] is not None and got["final"].get("node_id")
          == "hand-d1" and len(got["tokens"]) == 8,
          f"role flip: the stream {got['final']}")
    back = post(g_port, "/admin/role", {"node": d2, "role": "decode"})
    check(back.get("ok"), f"role flip back: {back}")
    ho = kv_handoff_spans_match(gw)
    check(ho["role_flips"] == 2
          and ho["roles"] == {u: r for (n, r), u in
                              zip(HANDOFF_LANES, urls.values())},
          f"role flip: {ho}")
    return {"role_flips": ho["role_flips"], "flipped_stream_on":
            got["final"]["node_id"]}


def span_ms(port: int, rid: str, op: str) -> float:
    hits = [e for e in spans_of(port) if e["name"] == op
            and e["args"].get("request_id") == rid]
    check(len(hits) == 1, f"{op} spans of {rid}: {len(hits)}")
    return float(hits[0]["dur"]) / 1e3


def handoff_prefix_tier(urls: dict, ports: dict, toks) -> dict:
    """A gateway with the prefix directory (no disagg, no affinity): A
    (a new 512-token prefix + a suffix) on X = D1, then A' (the prefix +
    another suffix) with an id the ring sends to Y = D2: Y fetches the
    prefix from X and prefills only its suffix, and A' equals its run on
    X. Then with affinity on, 8 requests of the prefix land on one
    lane."""
    from tpu_engine_torch.serving.gateway import Gateway
    from tpu_engine_torch.utils.config import GatewayConfig

    lanes = list(urls.values())
    x, y = urls["hand-d1"], urls["hand-d2"]
    prefix = toks(HANDOFF_PREFIX)
    a, a2 = prefix + toks(40), prefix + toks(44)
    gw = Gateway(lanes, GatewayConfig(prefix_directory=True))
    try:
        rx = owned(gw._ring, x, 1, "hpx-")[0]
        ry = owned(gw._ring, y, 1, "hpy-")[0]
        out_x = gw.route_generate({"request_id": rx, "prompt_tokens": a,
                                   "max_new_tokens": 16})
        check(out_x["node_id"] == "hand-d1", f"prefix tier: A {out_x}")
        before = generator_stats(ports["hand-d2"])
        out_y = gw.route_generate({"request_id": ry, "prompt_tokens": a2,
                                   "max_new_tokens": 16})
        after = generator_stats(ports["hand-d2"])
        pf0 = before.get("prefix_fetch") or {}
        pf = after["prefix_fetch"]
        spliced = pf["spliced"] - pf0.get("spliced", 0)
        prefilled = (after["kv_pool"]["prefilled_tokens"]
                     - before["kv_pool"]["prefilled_tokens"])
        check(out_y["node_id"] == "hand-d2" and spliced == 1
              and prefilled == len(a2) - HANDOFF_PREFIX,
              f"prefix tier: A' on {out_y['node_id']}, spliced {spliced}, "
              f"prefilled {prefilled} of {len(a2)}")
        pd = gw.get_stats()["prefix_directory"]
        check(pd["hints_attached"] == 1, f"prefix tier: {pd}")
        colocated = post(ports["hand-d1"], "/generate", {
            "request_id": "hp-ctl", "prompt_tokens": a2,
            "max_new_tokens": 16})["tokens"]
        check(out_y["tokens"] == colocated,
              f"prefix tier: A' {out_y['tokens']} != {colocated}")
        readings = {"fetch_ms": span_ms(ports["hand-d2"], ry,
                                        "prefix_fetch"),
                    "fetched_blocks": pf["blocks_spliced"]
                    - pf0.get("blocks_spliced", 0),
                    "local_prefill_ms": span_ms(ports["hand-d1"], rx,
                                                "prefill"),
                    "local_prefill_tokens": len(a), "directory": pd}
    finally:
        gw.stop()
    gw = Gateway(lanes, GatewayConfig(prefix_directory=True,
                                      prefix_affinity=True))
    try:
        served = [gw.route_generate({
            "request_id": f"ha{i}", "prompt_tokens": prefix + toks(8 + i),
            "max_new_tokens": 4})["node_id"]
            for i in range(HANDOFF_AFFINITY)]
        aff = gw.get_stats()["affinity"]
        check(len(set(served)) == 1
              and aff["affinity_routed"] == HANDOFF_AFFINITY,
              f"prefix tier affinity: {served} {aff}")
        readings["affinity_lane"] = served[0]
    finally:
        gw.stop()
    return readings


def handoff_int8(torch, cfg) -> dict:
    """Two int8 mixed generators in this process: a row handed off with
    export_row(wait_prefill=True) and submit_import equals the colocated
    run, its chain is adopted verbatim, and #4 launches == layers x
    ticks."""
    import queue as queue_mod

    from tpu_engine_torch.models.convert import init_params
    from tpu_engine_torch.ops import kernels
    from tpu_engine_torch.runtime.scheduler import ContinuousGenerator

    params = init_params(cfg, seed=0, device="cuda", dtype="bfloat16")
    kw = dict(dtype="bfloat16", n_slots=8, kv_block_size=16,
              kv_quantize="int8", mixed_step=True, mixed_token_budget=256,
              prefill_chunk=256)
    a = ContinuousGenerator(cut_llama(), params=params, **kw)
    b = ContinuousGenerator(cut_llama(), params=params, **kw)
    try:
        rng = np.random.default_rng(18)
        prompt = [int(t) for t in rng.integers(1, cfg.vocab, 560)]
        kernels.reset_counts()  # the part: counts from 0, read after
        # The control twice: the second resumes from A's radix, as the
        # handoff's prefill does.
        a.generate([prompt], max_new_tokens=HANDOFF_NEW)
        control = a.generate([prompt], max_new_tokens=HANDOFF_NEW)[0]
        q: "queue_mod.Queue" = queue_mod.Queue()
        a.submit(prompt, max_new_tokens=HANDOFF_NEW, stream=q, tag="h8",
                 handoff=True, handoff_park_s=60.0)
        t0 = time.perf_counter()
        while (a.stats().get("handoff") or {}).get("held_rows", 0) == 0:
            check(time.perf_counter() - t0 < 60, "int8 handoff: no hold")
            time.sleep(0.002)
        t0 = time.perf_counter()
        snap = a.export_row("h8", timeout_s=30.0, wait_prefill=True)
        export_ms = (time.perf_counter() - t0) * 1e3
        check(snap.get("ok") and len(snap["emitted"]) == 1,
              f"int8 handoff: {str(snap)[:200]}")
        got = []
        while True:
            item = q.get(timeout=60)
            if item is None:
                break
            got.extend(item)
        q2: "queue_mod.Queue" = queue_mod.Queue()
        t0 = time.perf_counter()
        b.submit_import(snap, stream=q2, tag="h8-b")
        first = None
        while True:
            item = q2.get(timeout=120)
            if item is None:
                break
            if first is None:
                first = time.perf_counter()
            got.extend(item)
        check(got == control, f"int8 handoff: {got} != {control}")
        st_b = b.stats()
        check(st_b["migration"]["imported_rows"] == 1
              and st_b["kv_pool"]["prefilled_tokens"] == 0,
              f"int8 handoff: {st_b['migration']}")
        # Verbatim: B's radix now serves the prompt's blocks with the
        # exported bytes and scales.
        chain = b.export_prefix(prompt)["chain"]
        n = len(prompt) // 16
        check(chain["quantized"] and chain["blocks"][:n]
              == snap["chain"]["blocks"][:n],
              "int8 handoff: the adopted chain differs from the export")
        ticks = a.stats()["mixed"]["ticks"] + b.stats()["mixed"]["ticks"]
        launches = check_counts("int8 handoff",
                                "quant_ragged_paged_attention")
        check(launches == cfg.n_layers * ticks,
              f"int8 handoff: #4 launches {launches} != "
              f"{cfg.n_layers} x {ticks} ticks")
        return {"launches": launches, "ticks": ticks,
                "export_ms": export_ms,
                "import_to_first_token_ms": (first - t0) * 1e3,
                "wire_bytes": len(json.dumps(snap)),
                "chain_blocks": len(snap["chain"]["blocks"])}
    finally:
        a.stop()
        b.stop()
        del params
        torch.cuda.empty_cache()


def phase_handoff(torch, card: str) -> dict:
    """The handoff family on the card (see the module docstring's handoff
    entry): three worker_node processes of TinyLlama-1.1B's width at cut
    depth (CUT_LLAMA, bf16, mixed, 16-token blocks, --prefix-fetch), P of
    role prefill, D1 and D2 of role decode, behind the port's gateway with
    disagg, migrate_streams, prefix_affinity and prefix_directory on."""
    import signal

    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.serving.app import serve_gateway
    from tpu_engine_torch.utils.config import GatewayConfig

    t0 = time.perf_counter()
    OUT_DIR.mkdir(exist_ok=True)
    cfg = create_model(cut_llama()).config
    lanes = {}
    for name, role in HANDOFF_LANES:
        counts_path = OUT_DIR / f"handoff_counts_{name}.json"
        counts_path.unlink(missing_ok=True)
        proc, port, log_f = spawn_counted_worker_node(
            [name, *HANDOFF_LANE_ARGS, "--role", role],
            OUT_DIR / f"handoff_{name}.log", counts_path)
        lanes[name] = (proc, port, log_f, counts_path)
    out = {}
    gsrv = None
    try:
        # The in-process int8 part runs while the three lanes load.
        out["int8"] = handoff_int8(torch, cfg)
        torch.cuda.empty_cache()
        ports = {n: lanes[n][1] for n, _ in HANDOFF_LANES}
        urls = {n: f"127.0.0.1:{p}" for n, p in ports.items()}
        out["ready_s"] = max(wait_health(lanes[n][0], p)
                             for n, p in ports.items())
        rng = np.random.default_rng(15)

        def toks(n):
            return [int(t) for t in rng.integers(1, cfg.vocab, n)]
        gw, gsrv = serve_gateway(list(urls.values()), GatewayConfig(
            port=0, disagg=True, migrate_streams=True,
            prefix_affinity=True, prefix_directory=True,
            handoff_timeout_s=60.0))
        check(gw.worker_roles() == {urls[n]: r for n, r in HANDOFF_LANES},
              f"handoff: roles {gw.worker_roles()}")
        out["burst"] = handoff_burst(gw, gsrv.port, ports, toks)
        out["identity"] = handoff_identity(gw, ports, toks)
        out["chain"] = handoff_chain(ports, toks)
        out["drain"] = handoff_drain(urls, ports, toks)
        out["role_flip"] = handoff_role_flip(gw, gsrv.port, urls, toks)
        out["prefix"] = handoff_prefix_tier(urls, ports, toks)
        out["gateway"] = gw.get_stats()
        gsrv.stop()
        gw.stop()
        gsrv = None
        # Every lane idle with no leaked block; #1 == layers x its ticks.
        ticks = {}
        for name, port in ports.items():
            st, idle = wait_idle(port, paged=True)
            check(idle, f"handoff: {name} leaked blocks: {st['kv_pool']}")
            ticks[name] = st["mixed"]["ticks"]
            check(st["mixed"]["ticks"] == st["mixed"]["dispatches"],
                  f"handoff: {name} {st['mixed']}")
        launches = {}
        for name, (proc, port, log_f, counts_path) in lanes.items():
            proc.send_signal(signal.SIGTERM)
            check(proc.wait(timeout=120) == 0, f"handoff: {name} exit code")
            counts = json.loads(counts_path.read_text())
            check(all(p == 0 for _, p in counts.values()),
                  f"handoff {name}: plain versions served: {counts}")
            check(all(c[0] == 0 for k, c in counts.items()
                      if k != "ragged_paged_attention"),
                  f"handoff {name}: other kernels launched: {counts}")
            launches[name] = counts["ragged_paged_attention"][0]
            check(launches[name] == cfg.n_layers * ticks[name],
                  f"handoff {name}: #1 launches {launches[name]} != "
                  f"{cfg.n_layers} x {ticks[name]} ticks")
        out["launches"], out["ticks"] = launches, ticks
    finally:
        if gsrv is not None:
            gsrv.stop()
        for proc, _port, log_f, _c in lanes.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
            log_f.close()
    out["seconds"] = time.perf_counter() - t0
    b, ch, dr, pr = (out["burst"], out["chain"], out["drain"],
                     out["prefix"])
    log(f"handoff: {HANDOFF_STREAMS}/{HANDOFF_STREAMS} spliced in "
        f"{b['wall_s']:.1f} s (decoded on {b['decoded_on']}); TTFT p50/p99 "
        f"{b['ttft_ms'][0]:.1f}/{b['ttft_ms'][1]:.1f} ms; handoff gap p50 "
        f"{b['handoff_gap_ms']['p50']:.1f} max "
        f"{b['handoff_gap_ms']['max']:.1f} ms; chain {ch['chain_blocks']} "
        f"blocks {ch['wire_bytes']} wire bytes, export {ch['export_ms']:.1f}"
        f" ms, import to first token {ch['import_to_first_token_ms']:.1f} "
        f"ms; prefix fetch {pr['fetch_ms']:.1f} ms ({pr['fetched_blocks']} "
        f"blocks) against a {pr['local_prefill_tokens']}-token local "
        f"prefill {pr['local_prefill_ms']:.1f} ms; drain splice gap "
        f"{dr['splice_gap_ms']:.1f} ms (median ITL "
        f"{dr['median_itl_ms']:.1f}); #1 launches {out['launches']} == "
        f"{cfg.n_layers} x ticks {out['ticks']}; int8: #4 "
        f"{out['int8']['launches']} == {cfg.n_layers} x "
        f"{out['int8']['ticks']}; every check passed in "
        f"{out['seconds']:.1f} s [{card}]")
    return out


# -- the recurrent phase ----------------------------------------------------

RECURRENT_LANE_ARGS = ("mamba2", "--mixed-step", "--mixed-token-budget",
                       "256", "--prefill-chunk", "256", "--n-slots", "8",
                       "--dtype", "float32")
RECURRENT_STREAMS = 16
RECURRENT_NEW = 32
RECURRENT_INFER = 8
# #8 against its plain version: 1e-4 of max(1, the plain version's
# largest magnitude), on y and on the states. The two sum the conv, the
# state update and the readout in other orders (the kernel contracts
# multiply-adds; the plain version's einsum reduces by its own tree).
SCAN_TOL = 1e-4
# mamba2's mixer geometry: d_inner, d_state, heads, d_conv.
SCAN_GEOMETRY = (1536, 64, 24, 4)
SCAN_CASES = {"B8 W1": (8, 1, [1] * 8),
              "B1 W256": (1, 256, [256]),
              "B8 W256 ragged": (8, 256, [256, 1, 0, 100, 37, 1, 256, 5])}
H100_BYTES_S = 3.35e12
H100_F32_FLOPS = 67e12


def scan_bound_ms(b: int, w: int, qlen) -> tuple:
    """Least time of one #8 call: the larger of its bytes (each live row's
    state read and written once, the valid slots' projections read, y
    written, the weights and the row vectors) over 3.35 TB/s and its f32
    operations (per valid slot, four per state value for the update and
    the readout, and the conv, softplus, gate and skip per channel) over
    67 TFLOP/s, the H100's peak outside the tensor cores."""
    di, n, h, k = SCAN_GEOMETRY
    sd = (k - 1) * di + di * n
    slots = int(sum(min(int(q), w) for q in qlen))
    live = sum(1 for q in qlen if q > 0)
    pw = 2 * di + 2 * n + h
    nbytes = 4 * (2 * live * sd + slots * pw + b * w * di
                  + k * di + di + 3 * h + 2 * b)
    ops = slots * (4 * di * n + di * (2 * k + 12))
    t_bytes, t_ops = nbytes / H100_BYTES_S, ops / H100_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def recurrent_kernel(torch) -> dict:
    """#8 at mamba2's shapes against its plain version: error, two runs,
    partition invariance, untouched rows, and the device times."""
    from tpu_engine_torch.ops import ssd as so

    di, n, h, k = SCAN_GEOMETRY
    out = {}
    for seed, (case, (b, w, qlen)) in enumerate(SCAN_CASES.items()):
        arrs = so.scan_parity_inputs(b, w, di, n, h, k, seed=seed)
        proj, state, ids, *weights = (torch.from_numpy(a).cuda()
                                      for a in arrs)
        ql = torch.tensor(qlen, dtype=torch.int32, device="cuda")

        def run(fn, st):
            return fn(proj, st, ids, ql, *weights, n, h)

        st_k, st_p = state.clone(), state.clone()
        y_k, y_p = run(so.ssd_scan, st_k), run(so.ssd_scan_reference, st_p)
        torch.cuda.synchronize()
        err = 0.0
        for got, want in ((y_k, y_p), (st_k, st_p)):
            e = float((got - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            check(e <= SCAN_TOL * scale,
                  f"recurrent: #8 {case} differs from its plain version by "
                  f"{e} (bound {SCAN_TOL * scale})")
            err = max(err, e)
        st2 = state.clone()
        check(torch.equal(run(so.ssd_scan, st2), y_k)
              and torch.equal(st2, st_k),
              f"recurrent: #8 {case} not bit-identical over two runs")
        steps, ys = state.clone(), []
        for j in range(w):
            ys.append(so.ssd_scan(proj[:, j:j + 1].contiguous(), steps, ids,
                                  (ql > j).to(torch.int32), *weights, n, h))
        torch.cuda.synchronize()
        check(torch.equal(steps, st_k) and torch.equal(torch.cat(ys, 1), y_k),
              f"recurrent: #8 {case}: {w} one-slot launches differ from "
              f"one {w}-slot launch")
        live = set(ids[ql > 0].tolist())
        check(all(torch.equal(st_k[r], state[r])
                  for r in range(state.shape[0]) if r not in live),
              f"recurrent: #8 {case} wrote a qlen-0 or outside row")
        scratch = state.clone()
        ms, seen = device_call_ms(torch, lambda: run(so.ssd_scan, scratch))
        events_ms = time_ms(torch, lambda: run(so.ssd_scan, scratch))
        plain_ms = time_ms(torch, lambda: run(so.ssd_scan_reference, scratch),
                           iters=3)
        bound, by, nbytes, ops = scan_bound_ms(b, w, qlen)
        out[case] = {"max_abs_err": err, "device_ms": ms,
                     "profiled_calls": seen, "events_ms": events_ms,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                     "bytes": nbytes, "ops": ops, "library_ms": None}
        log(f"recurrent: #8 {case}: err {err:.2e}, device {ms:.4f} ms "
            f"(cold-L2 events {events_ms:.4f}), plain {plain_ms:.3f} ms, "
            f"bound {bound:.4f} ms by {by}")
    return out


def recurrent_small_lanes(torch) -> dict:
    """ssd-small-test (seeded f32 weights) through a mixed and a two-path
    lane on the card (#8) and on the CPU (plain versions): greedy streams
    equal, 2 launches (its layers) per window scan on the card."""
    from tpu_engine_torch.models import ssd as tssd
    from tpu_engine_torch.models.convert import params_to
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.ops import kernels as kl
    from tpu_engine_torch.runtime.scheduler import ContinuousGenerator

    spec = create_model("ssd-small-test")
    params = spec.init(3, "cpu", "float32")
    prompts = [[5, 9, 3], [(i * 7) % 200 + 1 for i in range(40)], [7] * 20]
    scan = wrapper("ssd_scan")
    out = {}
    for mode, kw in (("mixed", dict(mixed_step=True, mixed_token_budget=8)),
                     ("two-path", dict(step_chunk=4))):
        streams = {}
        for dev in ("cpu", "cuda"):
            kl.reset_counts()
            tssd.ssd_window_scan_rows.calls = 0
            gen = ContinuousGenerator(spec, params=params_to(params, dev),
                                      device=dev, dtype="float32", n_slots=4,
                                      prefill_chunk=8, **kw)
            try:
                streams[dev] = gen.generate(prompts, max_new_tokens=12)
            finally:
                gen.stop()
        calls = tssd.ssd_window_scan_rows.calls
        check(scan.plain_calls == 0 and scan.launches == 2 * calls > 0,
              f"recurrent small {mode}: #8 launches {scan.launches}, plain "
              f"{scan.plain_calls}, window scans {calls}")
        check(streams["cuda"] == streams["cpu"],
              f"recurrent small {mode}: card {streams['cuda']} != CPU "
              f"{streams['cpu']}")
        out[mode] = {"launches": scan.launches, "window_scans": calls}
        log(f"recurrent small {mode}: card == CPU {streams['cuda']}")
    return out


def start_recurrent_worker() -> tuple:
    return start_counted_worker_node(["mamba2-w", *RECURRENT_LANE_ARGS],
                                     "recurrent_worker.log",
                                     "recurrent_counts.json")


def recurrent_worker(torch, card: str, started: tuple) -> dict:
    """mamba2 at full width as a worker_node process (mixed, f32;
    ``start_recurrent_worker`` starts it): 16 /generate streams and 8
    /infer rows at once, then the lane's counts."""
    import signal

    proc, port, log_f, counts_path = started
    rng = np.random.default_rng(17)
    vocab = 50257
    out = {}
    try:
        out["ready_s"] = wait_health(proc, port)
        gens = {f"g{i}": [int(t) for t in rng.integers(
            1, vocab, int(rng.integers(100, 601)))]
            for i in range(RECURRENT_STREAMS)}
        infers = {f"i{i}": [float(t) for t in rng.integers(1, vocab, 128)]
                  for i in range(RECURRENT_INFER)}
        results, errors, walls = {}, [], {}

        def send(name, path, body):
            t0 = time.perf_counter()
            try:
                results[name] = post(port, path, body)
            except Exception as exc:  # reported below, never swallowed
                errors.append(f"{name}: {exc}")
            walls[name] = time.perf_counter() - t0

        threads = [threading.Thread(target=send, args=(
            name, "/generate", {"request_id": name, "prompt_tokens": p,
                                "max_new_tokens": RECURRENT_NEW}))
            for name, p in gens.items()]
        threads += [threading.Thread(target=send, args=(
            name, "/infer", {"request_id": name, "input_data": x}))
            for name, x in infers.items()]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out["burst_wall_s"] = time.perf_counter() - t0
        check(not errors, f"recurrent worker: {errors[:3]}")
        for name in gens:
            check(len(results[name]["tokens"]) == RECURRENT_NEW,
                  f"recurrent worker: {name} gave "
                  f"{len(results[name]['tokens'])} tokens")
        for name in infers:
            o = np.asarray(results[name]["output_data"], np.float32)
            check(o.shape == (vocab,) and np.isfinite(o).all(),
                  f"recurrent worker: /infer {name} shape {o.shape}")
        deadline = time.time() + 30
        while True:
            st = generator_stats(port)
            sp = st["state_pool"]
            idle = st["active"] == 0 and sp["rows_free"] == sp["rows_total"]
            if idle or time.time() > deadline:
                break
            time.sleep(0.05)
        check(idle, f"recurrent worker: leaked slab rows: {sp}")
        m = st["mixed"]
        check(m["ticks"] == m["dispatches"] > 0,
              f"recurrent worker: ticks {m}")
        check("kv_pool" not in st, "recurrent worker: a kv_pool block")
        out.update(stats=st, generate_wall_s=walls)
        proc.send_signal(signal.SIGTERM)
        check(proc.wait(timeout=120) == 0, "recurrent worker: exit code")
        counts = json.loads(counts_path.read_text())
        scans = int(Path(str(counts_path) + ".scans").read_text())
        check(all(p == 0 for _, p in counts.values()),
              f"recurrent worker: plain versions served: {counts}")
        check(all(c[0] == 0 for k, c in counts.items() if k != "ssd_scan"),
              f"recurrent worker: other kernels launched: {counts}")
        launches = counts["ssd_scan"][0]
        check(launches == 24 * scans > 0,
              f"recurrent worker: #8 launches {launches} != 24 x {scans} "
              f"window scans")
        out.update(launches=launches, window_scans=scans,
                   ticks=m["ticks"])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        log_f.close()
    log(f"recurrent worker: {RECURRENT_STREAMS} streams and "
        f"{RECURRENT_INFER} /infer rows in {out['burst_wall_s']:.1f} s; "
        f"ticks {out['ticks']} == dispatches; #8 launches "
        f"{out['launches']} == 24 x {out['window_scans']} window scans; "
        f"rows_free == rows_total [{card}]")
    return out


def _stream_of(q) -> list:
    out = []
    while True:
        item = q.get(timeout=300)
        if item is None:
            return out
        out.extend(item)


def recurrent_moves(torch, params) -> dict:
    """At full width in this process: a two-path row migrated between two
    two-path lanes, and a handoff from a mixed prefill lane to a mixed
    decode lane, each token-identical to the unmoved stream."""
    import queue

    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.runtime.scheduler import ContinuousGenerator

    spec = create_model("mamba2")
    rng = np.random.default_rng(5)
    out = {}
    two = dict(dtype="float32", n_slots=4, prefill_chunk=256, step_chunk=8)
    a = ContinuousGenerator(spec, params=params, **two)
    b = ContinuousGenerator(spec, params=params, **two)
    try:
        prompt = [int(t) for t in rng.integers(1, spec.config.vocab, 300)]
        control = a.generate([prompt], max_new_tokens=32)[0]
        q = queue.Queue()
        a.submit(prompt, max_new_tokens=32, stream=q, tag="mv")
        got = []
        while len(got) < 8:
            got += q.get(timeout=300)
        snap = a.export_row("mv", timeout_s=60)
        check(snap.get("ok"), f"recurrent migrate: {snap.get('reason')}")
        got += _stream_of(q)
        q2 = queue.Queue()
        fut = b.submit_import(snap, stream=q2)
        got += _stream_of(q2)
        check(got == control and fut.result(timeout=60) == control,
              f"recurrent migrate: spliced {got} != unmoved {control}")
        check(b.stats()["admission_dispatches"] == 1,
              f"recurrent migrate: the import prefilled "
              f"({b.stats()['admission_dispatches']} dispatches)")
        out["migrate"] = {"exported_at": snap["pos"],
                          "chain_bytes": len(snap["chain"]["blocks"][0]["k"])}
    finally:
        a.stop()
        b.stop()
    mixed = dict(dtype="float32", n_slots=4, prefill_chunk=256,
                 mixed_step=True, mixed_token_budget=256)
    p = ContinuousGenerator(spec, params=params, **mixed)
    d = ContinuousGenerator(spec, params=params, **mixed)
    try:
        prompt = [int(t) for t in rng.integers(1, spec.config.vocab, 400)]
        control = p.generate([prompt], max_new_tokens=32)[0]
        q = queue.Queue()
        p.submit(prompt, max_new_tokens=32, stream=q, tag="ho",
                 handoff=True, handoff_park_s=60.0)
        snap = p.export_row("ho", timeout_s=120, wait_prefill=True)
        check(snap.get("ok"), f"recurrent handoff: {snap.get('reason')}")
        got = _stream_of(q)
        on_p = len(got)
        pre = d.stats()["mixed"]["prefill_tokens"]
        q2 = queue.Queue()
        fut = d.submit_import(snap, stream=q2)
        got += _stream_of(q2)
        check(got == control and fut.result(timeout=60) == control,
              f"recurrent handoff: {got} != colocated {control}")
        re_prefilled = d.stats()["mixed"]["prefill_tokens"] - pre
        check(re_prefilled == 0,
              f"recurrent handoff: {re_prefilled} tokens re-prefilled")
        check(p.stats()["handoff"]["holds"] == 1, "recurrent handoff: hold")
        for g in (p, d):
            sp = g.stats()["state_pool"]
            check(sp["rows_free"] == sp["rows_total"],
                  f"recurrent handoff: leaked rows {sp}")
        out["handoff"] = {"tokens_on_prefill_lane": on_p,
                          "re_prefilled_tokens": re_prefilled}
    finally:
        p.stop()
        d.stop()
    return out


def recurrent_readings(torch, params) -> dict:
    """A B 8 decode tick of mamba2 (one-slot window scan over 8 slab
    rows) and a 512-token prompt's TTFT through a two-path lane, with #8
    and with the plain loop in its place."""
    import queue

    from tpu_engine_torch.models import ssd as tssd
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.ops import ssd as so
    from tpu_engine_torch.runtime.scheduler import ContinuousGenerator

    spec = create_model("mamba2")
    cfg = spec.config
    sd = tssd.ssd_state_dim(cfg)
    slab = torch.zeros((cfg.n_layers, 9, sd), device="cuda")
    tok = torch.randint(1, cfg.vocab, (8, 1), device="cuda")
    ids = torch.arange(1, 9, dtype=torch.int32, device="cuda")
    ones = torch.ones((8,), dtype=torch.int32, device="cuda")
    zero = torch.zeros((8,), dtype=torch.long, device="cuda")

    def tick():
        return tssd.ssd_window_scan_rows(params, tok, slab, ids, ones, zero,
                                         cfg)

    tick()
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls))
    issue = issue_ms(torch, tick)
    busy = busy_ms(torch, tick)
    out = {"decode_tick_B8": {"wall_ms": wall, "issue_ms": issue,
                              "busy_ms": busy,
                              "idle_share": idle_share(busy, wall),
                              "launches_per_tick": cfg.n_layers}}
    log(f"recurrent: mamba2 B 8 decode tick wall {wall:.3f} ms, host issue "
        f"{issue:.3f} ms, {busy_text(busy, idle_share(busy, wall))}")
    rng = np.random.default_rng(9)
    prompt = [int(t) for t in rng.integers(1, cfg.vocab, 512)]
    ttft = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            tssd.ssd_scan = so.ssd_scan_reference
        try:
            gen = ContinuousGenerator(spec, params=params, dtype="float32",
                                      n_slots=2, prefill_chunk=256,
                                      step_chunk=4)
            try:
                q = queue.Queue()
                t0 = time.perf_counter()
                gen.submit(prompt, max_new_tokens=1, stream=q)
                first = q.get(timeout=600)
                ttft[route] = ((time.perf_counter() - t0) * 1e3, first)
            finally:
                gen.stop()
        finally:
            tssd.ssd_scan = so.ssd_scan
    check(ttft["kernel"][1] == ttft["plain"][1],
          f"recurrent TTFT: first tokens {ttft}")
    out["ttft_512_ms"] = {k: v[0] for k, v in ttft.items()}
    out["slab_row_bytes"] = cfg.n_layers * sd * 4
    log(f"recurrent: 512-token TTFT {ttft['kernel'][0]:.1f} ms with #8, "
        f"{ttft['plain'][0]:.1f} ms with the plain loop; a slab row "
        f"{out['slab_row_bytes']} bytes")
    return out


def phase_recurrent(torch, card: str) -> dict:
    """The state_slab family on the card (the module docstring's recurrent
    entry)."""
    from tpu_engine_torch.models import ssd as tssd
    from tpu_engine_torch.models.convert import init_ssd_params
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.ops import kernels as kl

    t0 = time.perf_counter()
    out = {"kernel": recurrent_kernel(torch)}
    # The worker process loads while the in-process parts run.
    started = start_recurrent_worker()
    out["small"] = recurrent_small_lanes(torch)
    params = init_ssd_params(create_model("mamba2").config, seed=0,
                             device="cuda")
    kl.reset_counts()
    tssd.ssd_window_scan_rows.calls = 0
    out["moves"] = recurrent_moves(torch, params)
    scan = wrapper("ssd_scan")
    calls = tssd.ssd_window_scan_rows.calls
    check(scan.plain_calls == 0 and scan.launches == 24 * calls > 0,
          f"recurrent moves: #8 launches {scan.launches} != 24 x {calls}")
    out["moves"]["launches"] = scan.launches
    out["readings"] = recurrent_readings(torch, params)
    del params
    torch.cuda.empty_cache()
    # The main path: counts to 0 just before the worker, read just after.
    kl.reset_counts()
    out["worker"] = recurrent_worker(torch, card, started)
    out["seconds"] = time.perf_counter() - t0
    log(f"recurrent: every check passed in {out['seconds']:.1f} s [{card}]")
    return out


# -- the moe phase ---------------------------------------------------------

MOE_LAYERS = 12
MOE_LANE_ARGS = ("gpt2-moe", "--kv-block-size", "16", "--mixed-step",
                 "--mixed-token-budget", "256", "--prefill-chunk", "256",
                 "--n-slots", "8", "--dtype", "bfloat16")
MOE_STREAMS = 16
MOE_SCORES = 8
MOE_NEW = 32
MOE_IDENTITY = 4
MOE_INT8_STREAMS = 8
# The full-width f32 forwards of the exactness and card-vs-CPU checks:
# 2 x 128 tokens, within 1e-4 of max(1, the reference's largest logit).
MOE_TOL = 1e-4


@contextlib.contextmanager
def recorded_routing():
    """Every ``ops.moe.route`` call of the block: (router probabilities,
    dispatch tensor), in call order (one per layer of a forward)."""
    from tpu_engine_torch.ops import moe as tmoe

    calls = []
    route = tmoe.route

    def rec(probs, cfg, n_tokens):
        d, c = route(probs, cfg, n_tokens)
        calls.append((probs.detach(), d.detach()))
        return d, c

    tmoe.route = rec
    try:
        yield calls
    finally:
        tmoe.route = route


def router_margins(probs, k: int = 2):
    """Per token, the smallest gap between consecutive sorted router
    probabilities among the top k + 1 (a choice or a rank another rounding
    could flip)."""
    s = probs.float().sort(dim=-1, descending=True).values[:, :k + 1]
    return (s[:, :-1] - s[:, 1:]).amin(-1)


def routing_diff(torch, what: str, a, b) -> float:
    """Fail where two forwards' routings differ, naming the layer, the
    tokens and their margins; return the smallest margin of ``a``."""
    check(len(a) == len(b), f"{what}: {len(a)} against {len(b)} routings")
    for li, ((pa, da), (_, db)) in enumerate(zip(a, b)):
        da, db = da.cpu(), db.cpu()
        if not torch.equal(da, db):
            bad = (da != db).flatten(1).any(-1).nonzero()[:, 0]
            m = router_margins(pa.cpu())[bad]
            check(False, f"{what}: routing differs in layer {li} at tokens "
                         f"{bad[:8].tolist()} (margins {m[:8].tolist()})")
    return min(float(router_margins(p.cpu()).min()) for p, _ in a)


def moe_worker(torch, card: str, started: tuple) -> dict:
    """gpt2-moe at full width as a worker_node process (bf16, mixed,
    16-token blocks; ``phase_moe`` starts it): a burst of streams and /score rows, then greedy
    streams one at a time, then the lane's counts."""
    import signal

    proc, port, log_f, counts_path = started
    rng = np.random.default_rng(18)
    vocab = 50257

    def toks(n):
        return [int(t) for t in rng.integers(1, vocab, n)]
    out = {}
    try:
        out["ready_s"] = wait_health(proc, port)
        streams = [StreamReader(port, {
            "request_id": f"ms{i}", "max_new_tokens": MOE_NEW,
            "prompt_tokens": toks(int(rng.integers(100, 601)))})
            for i in range(MOE_STREAMS)]
        scores = {f"mc{i}": {"request_id": f"mc{i}",
                             "prompt_tokens": toks(112),
                             "completion_tokens": toks(16)}
                  for i in range(MOE_SCORES)}
        t0 = time.perf_counter()
        for r in streams:
            r.start()
        score_res, _ = concurrent_posts(port, "/score", scores)
        for r in streams:
            r.join(timeout=600)
        out["burst_s"] = time.perf_counter() - t0
        for r in streams:
            check(r.final is not None and "error" not in r.final
                  and len(r.tokens) == MOE_NEW,
                  f"moe stream {r.body['request_id']}: {r.final} "
                  f"{r.error}")
        for name, s in score_res.items():
            lp = np.asarray(s["logprobs"], np.float64)
            check(lp.shape == (16,) and np.isfinite(lp).all()
                  and (lp <= 0).all(), f"moe /score {name}: {s}")
        # Greedy streams, each alone. The first pass fills the prefix
        # cache, so the second and third admit through the same radix hit
        # and tick the same compositions: they must be token-identical.
        prompts = [toks(int(rng.integers(100, 400)))
                   for _ in range(MOE_IDENTITY)]
        passes = []
        for _ in range(3):
            passes.append([post(port, "/generate", {
                "request_id": f"mi{i}", "prompt_tokens": p,
                "max_new_tokens": MOE_NEW})["tokens"]
                for i, p in enumerate(prompts)])
        check(passes[1] == passes[2],
              f"moe identity: repeats differ: {passes[1]} != {passes[2]}")
        out["identity"] = {"streams": MOE_IDENTITY,
                           "first_pass_equal": passes[0] == passes[1]}
        st, idle = wait_idle(port, paged=True)
        check(idle, f"moe worker: blocks leaked: {st['kv_pool']}")
        m = st["mixed"]
        check(m["ticks"] == m["dispatches"] > 0, f"moe worker: ticks {m}")
        sl = st["stateless"]
        out.update(ticks=m["ticks"], oneshot_dispatches=sl["dispatches"],
                   score_rows=sl["score_rows"], kv_pool=st["kv_pool"])
        proc.send_signal(signal.SIGTERM)
        check(proc.wait(timeout=120) == 0, "moe worker: exit code")
        counts = json.loads(counts_path.read_text())
        check(all(p == 0 for _, p in counts.values()),
              f"moe worker: plain versions served: {counts}")
        lane = ("ragged_paged_attention", "flash_attention")
        check(all(c[0] == 0 for k, c in counts.items() if k not in lane),
              f"moe worker: other kernels launched: {counts}")
        ragged = counts["ragged_paged_attention"][0]
        flash = counts["flash_attention"][0]
        check(ragged == MOE_LAYERS * m["ticks"],
              f"moe worker: #1 launches {ragged} != {MOE_LAYERS} x "
              f"{m['ticks']} ticks")
        check(flash == MOE_LAYERS * sl["dispatches"] > 0,
              f"moe worker: #5 launches {flash} != {MOE_LAYERS} x "
              f"{sl['dispatches']} one-shot dispatches")
        out["launches"] = {"ragged_paged_attention": ragged,
                           "flash_attention": flash}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        log_f.close()
    log(f"moe worker: {MOE_STREAMS} streams and {MOE_SCORES} /score in "
        f"{out['burst_s']:.1f} s; {MOE_IDENTITY} greedy streams alone "
        f"identical on repeat; ticks {out['ticks']} == dispatches; #1 "
        f"{out['launches']['ragged_paged_attention']} == {MOE_LAYERS} x "
        f"ticks, #5 {out['launches']['flash_attention']} == {MOE_LAYERS} x "
        f"{out['oneshot_dispatches']} one-shot dispatches; 0 leaked blocks "
        f"[{card}]")
    return out


def moe_int8_lane(torch, card: str):
    """A quantized worker in this process: int8 weights (the router gate
    full precision) and int8 KV blocks, mixed. Returns (its readings, the
    worker, still running)."""
    from tpu_engine_torch.ops import kernels
    from tpu_engine_torch.serving.worker import WorkerNode
    from tpu_engine_torch.utils.config import WorkerConfig

    kernels.reset_counts()  # the lane: counts from 0, read after
    w = WorkerNode(WorkerConfig(
        node_id="moe-q8", model="gpt2-moe", dtype="bfloat16",
        quantize="int8", gen_kv_block_size=16, gen_kv_quantize="int8",
        gen_mixed_step=True, gen_mixed_token_budget=256,
        gen_prefill_chunk=256, gen_max_batch_size=8))
    try:
        rng = np.random.default_rng(19)
        res, errors = {}, []

        def run(i, prompt):
            try:
                res[i] = w.handle_generate({
                    "request_id": f"mq{i}", "prompt_tokens": prompt,
                    "max_new_tokens": MOE_NEW})["tokens"]
            except Exception as exc:  # reported below
                errors.append(f"mq{i}: {exc!r}")

        threads = [threading.Thread(target=run, args=(i, [
            int(t) for t in rng.integers(1, 50257,
                                         int(rng.integers(100, 601)))]))
            for i in range(MOE_INT8_STREAMS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        burst = time.perf_counter() - t0
        check(not errors and all(len(res.get(i, [])) == MOE_NEW
                                 for i in range(MOE_INT8_STREAMS)),
              f"moe int8: {errors[:3]} {sorted(res)}")
        deadline = time.time() + 30
        while True:
            st = w.generator.stats()
            pool = st["kv_pool"]
            idle = st["active"] == 0 and (pool["blocks_free"]
                                          + pool["radix_nodes"]
                                          == pool["blocks_total"])
            if idle or time.time() > deadline:
                break
            time.sleep(0.05)
        check(idle, f"moe int8: blocks leaked: {pool}")
        m = st["mixed"]
        check(m["ticks"] == m["dispatches"] > 0, f"moe int8: ticks {m}")
        launches = check_counts("moe int8", "quant_ragged_paged_attention")
        check(launches == MOE_LAYERS * m["ticks"],
              f"moe int8: #4 launches {launches} != {MOE_LAYERS} x "
              f"{m['ticks']} ticks")
        check(pool.get("quantized"), f"moe int8: pool {pool}")
        log(f"moe int8: {MOE_INT8_STREAMS} streams in {burst:.1f} s; #4 "
            f"{launches} == {MOE_LAYERS} x {m['ticks']} ticks; 0 leaked "
            f"blocks [{card}]")
        return {"burst_s": burst, "ticks": m["ticks"], "launches": launches,
                "bytes_per_block": pool.get("bytes_per_block")}, w
    except BaseException:
        w.stop()
        raise


def moe_trees(torch, w) -> dict:
    """The lane's int8 trees (quantized on the card) against
    ``quantize_params`` on the CPU from the same f32 draw, bit for bit;
    the router gate in f32; the three trees' bytes. Returns the readings
    and the bf16 tree (for the tick readings)."""
    from tpu_engine_torch.models.convert import init_params, params_to
    from tpu_engine_torch.ops import quant as tq
    from tpu_engine_torch.training.train import tree_leaves

    cfg = w.engine.spec.config
    q = w.engine.params
    f32 = init_params(cfg, seed=0, device="cuda", dtype="float32")
    cpu = tq.quantize_params(params_to(f32, "cpu"))
    got, want = tree_leaves(q), tree_leaves(cpu)
    check(len(got) == len(want), "moe trees: leaf counts differ")
    n_int8 = 0
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.dtype == b.dtype and torch.equal(a.cpu(), b),
              f"moe trees: leaf {i} ({a.dtype}) differs from the CPU's")
        n_int8 += a.dtype == torch.int8
    check(tq.tree_is_quantized(q), "moe trees: the lane is not quantized")
    for li, bp in enumerate(q["blocks"]):
        check(bp["mlp"]["gate"]["kernel"].dtype == torch.float32
              and "kernel_q" not in bp["mlp"]["gate"]
              and bp["mlp"]["wi_q"].dtype == torch.int8,
              f"moe trees: layer {li}'s router or experts")
    bf16 = init_params(cfg, seed=0, device="cuda", dtype="bfloat16")
    out = {"leaves": len(got), "int8_leaves": int(n_int8),
           "param_bytes": {"f32": tq.param_bytes(f32),
                           "bf16": tq.param_bytes(bf16),
                           "int8": tq.param_bytes(q)}}
    del f32, cpu
    torch.cuda.empty_cache()
    log(f"moe trees: {n_int8} int8 leaves of {len(got)} bit-equal to the "
        f"CPU's quantize_params; router gates f32; param bytes "
        f"{out['param_bytes']}")
    return out, bf16


def moe_exactness(torch, q) -> dict:
    """A full-width 2 x 128 f32 forward: through the int8 tree against
    its dequantized tree (X @ (Wq s) == (X @ Wq) s), and on the card
    against the CPU (#5 there, its plain version here)."""
    from tpu_engine_torch.models.convert import params_to
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models.transformer import transformer_apply
    from tpu_engine_torch.ops import quant as tq

    cfg = create_model("gpt2-moe").config
    tokens = torch.from_numpy(np.random.default_rng(20).integers(
        1, cfg.vocab, (2, 128)).astype(np.int32))

    def forward(params, dev):
        with recorded_routing() as calls, torch.no_grad():
            out = transformer_apply(params, tokens.to(dev), cfg,
                                    dtype=torch.float32)
        return out.float().cpu(), calls

    got, r_q = forward(q, "cuda")
    deq = tq.dequantize_params(q)
    ref, r_deq = forward(deq, "cuda")
    del deq
    margin = routing_diff(torch, "moe exactness", r_q, r_deq)
    err = float((got - ref).abs().max())
    bound = MOE_TOL * max(1.0, float(ref.abs().max()))
    check(err <= bound, f"moe exactness: int8 {err} from dequantized "
                        f"(bound {bound})")
    cpu, r_cpu = forward(params_to(q, "cpu"), "cpu")
    cpu_margin = routing_diff(torch, "moe card vs CPU", r_q, r_cpu)
    cerr = float((got - cpu).abs().max())
    cbound = MOE_TOL * max(1.0, float(cpu.abs().max()))
    check(cerr <= cbound, f"moe card vs CPU: {cerr} (bound {cbound})")
    log(f"moe exactness: int8 forward vs dequantized {err:.3e} (bound "
        f"{bound:.3e}), card vs CPU {cerr:.3e} (bound {cbound:.3e}); "
        f"routing equal, smallest top-2 router margin {margin:.3e}")
    return {"int8_vs_dequantized": err, "bound": bound,
            "card_vs_cpu": cerr, "cpu_bound": cbound,
            "min_router_margin": margin, "cpu_min_router_margin": cpu_margin}


def moe_readings(torch, bf16, q, card: str) -> dict:
    """moe_apply alone at a mixed tick's shape, and a B 8 decode tick of
    the bf16 and of the int8 lane's forward."""
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models.transformer import (
        KVCache,
        transformer_step_rows_ragged,
    )
    from tpu_engine_torch.ops import moe as tmoe
    from tpu_engine_torch.ops.quant import quantize_kv

    from tpu_engine_torch.models import transformer as tt

    cfg = create_model("gpt2-moe").config
    mc = cfg.moe
    # A bf16 forward of 8 x 256 tokens (a mixed tick's shape): each
    # layer's dropped share, and layer 0's FFN input for moe_apply alone.
    tokens = torch.from_numpy(np.random.default_rng(21).integers(
        1, cfg.vocab, (8, 256)).astype(np.int32)).cuda()
    inputs = []
    apply = tt.moe_apply

    def captured(params, x, moe_cfg, dtype):
        inputs.append(x)
        return apply(params, x, moe_cfg, dtype=dtype)

    tt.moe_apply = captured
    try:
        with recorded_routing() as calls, torch.no_grad():
            tt.transformer_apply(bf16, tokens, cfg, dtype=torch.bfloat16)
    finally:
        tt.moe_apply = apply
    pairs = tokens.numel() * mc.top_k
    dropped = [1.0 - float(d.sum()) / pairs for _, d in calls]
    x, mlp = inputs[0], bf16["blocks"][0]["mlp"]

    def moe():
        return tmoe.moe_apply(mlp, x, mc, dtype=torch.bfloat16)

    with torch.no_grad():
        ms, seen = device_call_ms(torch, moe)
        issue = issue_ms(torch, moe)
    out = {"moe_apply_8x256": {"capacity": mc.capacity(tokens.numel()),
                               "dropped_share_by_layer": dropped,
                               "device_ms": ms, "profiled_calls": seen,
                               "issue_ms": issue}}
    log(f"moe: moe_apply at 8 x 256 tokens ({mc.capacity(tokens.numel())} "
        f"slots an expert): device {ms:.3f} ms, host issue {issue:.3f} ms; "
        f"(token, choice) pairs dropped by layer "
        f"{', '.join(f'{100 * v:.1f}%' for v in dropped)} [{card}]")
    rng = np.random.default_rng(22)
    b, bs, h, dh = 8, 16, cfg.n_heads, cfg.d_head
    ctx = rng.integers(100, 600, b)
    nb = int(ctx.max()) // bs + 2
    n_pool = b * nb + 1
    tables = torch.from_numpy((1 + np.arange(b * nb)).reshape(b, nb).astype(
        np.int32)).cuda()
    pos0 = torch.from_numpy(ctx.astype(np.int32)).cuda()
    qlen = torch.ones((b,), dtype=torch.int32, device="cuda")
    slot = torch.zeros((b,), dtype=torch.int32, device="cuda")
    tok = torch.from_numpy(rng.integers(1, cfg.vocab, (b, 1)).astype(
        np.int32)).cuda()
    shape = (cfg.n_layers, n_pool, bs, h, dh)
    kf = torch.randn(shape, device="cuda")
    vf = torch.randn(shape, device="cuda")
    for lane, params in (("bf16", bf16), ("int8", q)):
        if lane == "bf16":
            caches = KVCache(kf.bfloat16(), vf.bfloat16())
            scales = None
        else:
            (qk, sk), (qv, sv) = quantize_kv(kf), quantize_kv(vf)
            caches, scales = KVCache(qk, qv), KVCache(sk, sv)

        def tick():
            return transformer_step_rows_ragged(
                params, tok, caches, tables, pos0, qlen, cfg,
                dtype=torch.bfloat16, sample_slot=slot, scales=scales)

        with torch.no_grad():
            tick()
            torch.cuda.synchronize()
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                tick()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            wall = float(np.median(walls))
            issue = issue_ms(torch, tick)
            busy = busy_ms(torch, tick)
        idle = idle_share(busy, wall)
        out[f"decode_tick_B8_{lane}"] = {"wall_ms": wall, "issue_ms": issue,
                                         "busy_ms": busy, "idle_share": idle}
        log(f"moe: {lane} lane's B 8 decode tick wall {wall:.3f} ms, host "
            f"issue {issue:.3f} ms, {busy_text(busy, idle)} [{card}]")
        del caches, scales
    return out


def phase_moe(torch, card: str) -> dict:
    """The mixture-of-experts family and weight-only int8 on the card (the
    module docstring's moe entry)."""
    from tpu_engine_torch.ops import kernels as kl

    t0 = time.perf_counter()
    # The worker process loads while the in-process parts run.
    started = start_counted_worker_node(["moe-w", *MOE_LANE_ARGS],
                                        "moe_worker.log", "moe_counts.json")
    out = {}
    int8, w = moe_int8_lane(torch, card)
    out["int8"] = int8
    try:
        out["trees"], bf16 = moe_trees(torch, w)
        out["exactness"] = moe_exactness(torch, w.engine.params)
        out["readings"] = moe_readings(torch, bf16, w.engine.params, card)
    finally:
        w.stop()
    del bf16
    torch.cuda.empty_cache()
    # The main path: counts to 0 just before the worker, read just after.
    kl.reset_counts()
    out["worker"] = moe_worker(torch, card, started)
    out["seconds"] = time.perf_counter() - t0
    log(f"moe: every check passed in {out['seconds']:.1f} s [{card}]")
    return out


# -- the batch lanes -----------------------------------------------------------

# gpt2 at full width and depth (12 layers, d 768, 12 heads of 64, d_ff 3072,
# vocab 50257, max_seq 1024), random weights from seed 0.
BATCH_LAYERS = 12
BATCH_VOCAB = 50257
# A 200 ms batching window: four requests sent at once form one group.
BATCH_LANE_ARGS = ("gpt2", "--gen-scheduler", "batch", "--n-slots", "8",
                   "--batch-timeout-ms", "200", "--dtype", "bfloat16")
SPEC_LANE_ARGS = ("--gen-scheduler", "speculative", "--gen-spec-k", "4",
                  "--n-slots", "8", "--batch-timeout-ms", "200",
                  "--dtype", "float32")
# 8 /generate in the burst (16 before the seqpar phase).
BATCH_GENERATE = 8
BATCH_NEW = 32
BATCH_STREAMS = 4
BATCH_BEAMS = 4
BATCH_BEAM_NEW = 16
BATCH_SCORES = 8
BATCH_IDENTITY = 4
# Prompts of 100-480 tokens keep every group in the 512 bucket; the one
# 600-token prompt lands in the 1024 bucket and gets one token.
BATCH_PROMPT = (100, 481)
BATCH_CLAMP_PROMPT = 600
BATCH_SPEC_K = 4
# Where the lanes' greedy streams may part from the in-process f32
# Generator's: the verify window and the single step are other GEMM
# shapes, so a top-2 margin below this can flip.
BATCH_SPEC_MARGIN = 1e-3
# The keys of the JAX Generator's stats() (tpu_engine/runtime/
# generator.py:862), /health's generator block on a batch lane.
JAX_GENERATOR_STATS_KEYS = {"model", "max_seq", "batch_buckets",
                            "prompt_buckets", "step_chunk",
                            "compiled_prefill", "compiled_decode"}
# llama-small-test on the card against the CPU (f32, TF32 off): the
# /score log-probabilities of a 2-layer forward summed in another order.
BATCH_SCORE_TOL = 1e-4


def batch_small(torch) -> dict:
    """llama-small-test in f32 on the card (kernels) against the same
    weights on the CPU (plain versions): the Generator with and without
    fused (one loop; greedy; seeded at temperature 0.8, top_p 0.9; a
    repetition penalty with stops), beam width 4, score, and the
    SpeculativeGenerator (k 3) with a self-draft and a random draft."""
    from tpu_engine_torch.models.convert import params_to
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.runtime.generator import Generator
    from tpu_engine_torch.runtime.speculative import SpeculativeGenerator

    spec = create_model("llama-small-test")
    cpu_p = spec.init(0, device="cpu", dtype="float32")
    draft_p = spec.init(1, device="cpu", dtype="float32")
    gpu_p, gpu_d = params_to(cpu_p, "cuda"), params_to(draft_p, "cuda")
    gen = {"cuda": Generator(spec, params=gpu_p, dtype="float32",
                             step_chunk=4, device="cuda"),
           "cpu": Generator(spec, params=cpu_p, dtype="float32",
                            step_chunk=4, device="cpu")}
    rng = np.random.default_rng(23)
    prompts = [[int(t) for t in rng.integers(1, spec.config.vocab, n)]
               for n in (5, 12, 3, 30, 9)]
    greedy = gen["cpu"].generate(prompts, max_new_tokens=24)
    cases = {"greedy": {},
             "seeded": dict(temperature=0.8, top_p=0.9,
                            seed=[31, 32, 33, 34, 35]),
             "penalty+stops": dict(repetition_penalty=1.2,
                                   stop_tokens=[greedy[0][6],
                                                greedy[2][9]])}
    out = {}
    for case, kw in cases.items():
        want = gen["cpu"].generate(prompts, max_new_tokens=24, **kw)
        got = gen["cuda"].generate(prompts, max_new_tokens=24, **kw)
        fused = gen["cuda"].generate(prompts, max_new_tokens=24, fused=True,
                                     **kw)
        check(got == want, f"batch small {case}: card {got} != CPU {want}")
        check(fused == got, f"batch small {case}: fused {fused} != "
                            f"chunked {got}")
        out[case] = sum(len(r) for r in got)
    beams = [g.beam_search(prompts[1], beam_width=4, max_new_tokens=16)
             for g in (gen["cuda"], gen["cpu"])]
    check(beams[0] == beams[1], f"batch small beam: {beams}")
    completions = [p[:4] for p in prompts]
    sc = [np.concatenate(g.score(prompts, completions))
          for g in (gen["cuda"], gen["cpu"])]
    out["score_err"] = float(np.abs(sc[0] - sc[1]).max())
    check(out["score_err"] <= BATCH_SCORE_TOL,
          f"batch small score: {out['score_err']} > {BATCH_SCORE_TOL}")
    for draft, (dc, dg) in (("self", (cpu_p, gpu_p)),
                            ("random", (draft_p, gpu_d))):
        sg = {d: SpeculativeGenerator(spec, spec, params=p, draft_params=q,
                                      k=3, dtype="float32", device=d)
              for d, p, q in (("cuda", gpu_p, dg), ("cpu", cpu_p, dc))}
        for case, kw in (("greedy", {}),
                         ("t0.8", dict(temperature=0.8, seed=7))):
            want = sg["cpu"].generate(prompts, max_new_tokens=24, **kw)
            got = sg["cuda"].generate(prompts, max_new_tokens=24, **kw)
            check(got == want, f"batch small spec {draft} {case}: card "
                               f"{got} != CPU {want}")
            if case == "greedy":
                check(got == gen["cuda"].generate(prompts,
                                                  max_new_tokens=24),
                      f"batch small spec {draft}: greedy != plain greedy")
        out[f"spec_{draft}"] = sg["cuda"].last_stats
    log(f"batch: llama-small-test f32 on the card == CPU: Generator "
        f"with and without fused ({', '.join(cases)}), beam 4, score (max err "
        f"{out['score_err']:.2e}), SpeculativeGenerator k 3 self-draft "
        f"and random draft; fused == chunked, spec greedy == plain greedy")
    return out


def batch_flash(torch, card: str) -> dict:
    """#5 at the batch lanes' prefill: a bucket of 8 rows with 3 live ones
    left-padded at 512 (5 rows fully masked), 12 heads of 64, in f32 (as
    the served lanes launch it) and bf16, against the plain version; the
    kernel's device time beside the plain version's, the library's and
    the bound."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from tpu_engine_torch.ops import flash as fl
    from tpu_engine_torch.runtime.generator import left_pad_batch

    _, mask, _, _ = left_pad_batch([[1] * n for n in (480, 300, 100)], 8,
                                   512)
    m = torch.from_numpy(mask).cuda()
    out = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        q, k, v, _ = flash_inputs(torch, "cuda", 512, 12, 64, dtype=dtype,
                                  b=8, seed=24)
        args = dict(causal=True, mask=m)
        got, lse = fl.flash_attention_fwd(q, k, v, **args)
        ref, ref_lse = fl.flash_attention_reference(q, k, v, **args)
        torch.cuda.synchronize()
        name = "f32" if dtype == torch.float32 else "bf16"
        err = flash_err(torch, got, lse, ref, ref_lse)
        check(err <= tol, f"#5 batch prefill {name}: err {err} > {tol}")
        dead = m.sum(1) == 0
        check(int(dead.sum()) == 5 and bool((got[dead] == 0).all())
              and bool((lse[dead] == float("-inf")).all()),
              f"#5 batch prefill {name}: fully masked rows not 0 / -inf")
        check(not bool(torch.isnan(got.float()).any())
              and not bool(torch.isnan(lse).any()),
              f"#5 batch prefill {name}: NaN")
        flash_identical(torch, fl, q, k, v, args, got, lse,
                        f"batch prefill {name}")
        ms, seen = device_call_ms(
            torch, lambda: fl.flash_attention_fwd(q, k, v, **args))
        plain = time_ms(torch, lambda: fl.flash_attention_reference(
            q, k, v, **args), iters=5)
        # The library: scaled_dot_product_attention on the memory-efficient
        # backend (the flash backend takes no mask) with the causal and
        # key mask as one dense (B, 1, S, S) bool mask, built and the
        # inputs transposed beforehand (not timed). It gives out only, no
        # lse; its fully masked rows are recorded, not checked.
        qq, kk, vv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        amask = (torch.ones(512, 512, dtype=torch.bool, device="cuda")
                 .tril()[None, None] & (m > 0)[:, None, None, :])

        def library_call():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(qq, kk, vv,
                                                      attn_mask=amask)
        lib_dead = library_call()[dead].float()
        library, _ = device_call_ms(torch, library_call)
        bound, by = flash_bound_ms(q, causal=True, mask=m)
        out[name] = {"max_abs_err": err, "device_ms": ms,
                     "profiled_calls": seen, "plain_ms": plain,
                     "library_ms": library,
                     "library_backend": "EFFICIENT_ATTENTION",
                     "library_masked_rows": (
                         "nan" if bool(torch.isnan(lib_dead).any()) else
                         "0" if bool((lib_dead == 0).all()) else "other"),
                     "bound_ms": bound, "bound_by": by}
        log(f"#5 at the batch prefill (B 8, 3 live rows, pb 512, 12 x 64, "
            f"{name}): err {err:.2e}, masked rows 0 and lse -inf, "
            f"bit-identical; device {ms:.4f} ms, plain {plain:.3f} ms, "
            f"sdpa EFFICIENT_ATTENTION {library:.4f} ms (device time; its "
            f"fully masked rows {out[name]['library_masked_rows']}), bound "
            f"{bound:.5f} ms ({by}) [{card}]")
        del q, k, v, got, lse, ref, ref_lse, qq, kk, vv, amask
    return out


def batch_tokens(rng, n: int) -> list:
    return [int(t) for t in rng.integers(1, BATCH_VOCAB, n)]


def batch_worker(torch, card: str, started: tuple) -> dict:
    """gpt2 at full width as a worker_node process on the batch lane (bf16,
    8 rows a group; ``phase_batch`` starts it): a burst of /generate, /generate/stream, beam and
    /score requests at once, the 1024 bucket's clamp, repeats of one
    group of four, a stream against its blocking answer, an invalid beam;
    then the process's launch counts."""
    import signal

    proc, port, log_f, counts_path = started
    rng = np.random.default_rng(25)

    def prompt():
        return batch_tokens(rng, int(rng.integers(*BATCH_PROMPT)))
    out = {}
    try:
        out["ready_s"] = wait_health(proc, port)
        gens = {}
        for i in range(BATCH_GENERATE):
            b = {"request_id": f"bg{i}", "prompt_tokens": prompt(),
                 "max_new_tokens": BATCH_NEW}
            if i % 2:
                b.update(temperature=0.8, seed=1000 + i)
            if i in (3, 4):
                b.update(repetition_penalty=1.2,
                         stop_tokens=batch_tokens(rng, 2))
            gens[b["request_id"]] = b
        beams = {f"bb{i}": {"request_id": f"bb{i}",
                            "prompt_tokens": prompt(), "beam_width": 4,
                            "max_new_tokens": BATCH_BEAM_NEW}
                 for i in range(BATCH_BEAMS)}
        scores = {f"bc{i}": {"request_id": f"bc{i}",
                             "prompt_tokens": batch_tokens(rng, 112),
                             "completion_tokens": batch_tokens(rng, 16)}
                  for i in range(BATCH_SCORES)}
        streams = [StreamReader(port, {"request_id": f"bs{i}",
                                       "prompt_tokens": prompt(),
                                       "max_new_tokens": BATCH_NEW})
                   for i in range(BATCH_STREAMS)]
        res = {}

        def burst(name, path, bodies):
            res[name] = concurrent_posts(port, path, bodies)[0]
        posts = [threading.Thread(target=burst, args=a) for a in
                 (("gens", "/generate", gens), ("beams", "/generate", beams),
                  ("scores", "/score", scores))]
        t0 = time.perf_counter()
        for th in [*streams, *posts]:
            th.start()
        for th in [*streams, *posts]:
            th.join(timeout=600)
        out["burst_s"] = time.perf_counter() - t0
        check(len(res) == 3, f"batch burst: {sorted(res)}")
        answers = {k: v for r in res.values() for k, v in r.items()}
        for name, b in gens.items():
            n = len(answers[name]["tokens"])
            check(n == BATCH_NEW or ("stop_tokens" in b and n < BATCH_NEW),
                  f"batch /generate {name}: {n} tokens")
        for name in beams:
            check(len(answers[name]["tokens"]) == BATCH_BEAM_NEW,
                  f"batch beam {name}: {answers[name]}")
        for name in scores:
            lp = np.asarray(answers[name]["logprobs"], np.float64)
            check(lp.shape == (16,) and np.isfinite(lp).all()
                  and (lp <= 0).all(), f"batch /score {name}")
        for r in streams:
            check(r.final is not None and "error" not in r.final
                  and r.tokens == r.final["tokens"]
                  and len(r.tokens) == BATCH_NEW,
                  f"batch stream {r.body['request_id']}: {r.final} "
                  f"{r.error}")
        # The 1024 bucket: max_new clamps to max_seq - 1024 = 0, so 1.
        clamp = post(port, "/generate", {
            "request_id": "bclamp", "max_new_tokens": BATCH_NEW,
            "prompt_tokens": batch_tokens(rng, BATCH_CLAMP_PROMPT)})
        check(len(clamp["tokens"]) == 1,
              f"batch clamp: {len(clamp['tokens'])} tokens")
        # One group of four greedy requests, twice: the same composition.
        # An idle batcher dispatches what has queued at once, so four
        # requests sent together may split; each pass sends them while a
        # blocker holds the batcher, and they queue into one batch.
        group = {f"bi{i}": {"request_id": f"bi{i}",
                            "prompt_tokens": prompt(),
                            "max_new_tokens": BATCH_NEW}
                 for i in range(BATCH_IDENTITY)}
        blocker = {"request_id": "bblock", "prompt_tokens": prompt(),
                   "max_new_tokens": BATCH_NEW}

        def one_batch():
            ended = []
            th = threading.Thread(target=lambda: (
                post(port, "/generate", blocker),
                ended.append(time.perf_counter())))
            th.start()
            time.sleep(0.1)
            sent = time.perf_counter()
            answers = concurrent_posts(port, "/generate", group)[0]
            th.join(timeout=600)
            check(ended and ended[0] - sent > 0.2,
                  "batch identity: the blocker ended before the group "
                  "had queued")
            return answers
        passes = [one_batch() for _ in range(2)]
        check(all(passes[0][k]["tokens"] == passes[1][k]["tokens"]
                  for k in group), "batch identity: repeats differ")
        # A stream against the same request's blocking answer (alone).
        body = {"request_id": "bsx", "prompt_tokens": prompt(),
                "max_new_tokens": BATCH_NEW, "temperature": 0.8,
                "seed": 77}
        toks, final, _ = stream(port, body)
        check(final is not None and toks == final["tokens"]
              == post(port, "/generate", body)["tokens"],
              "batch stream != blocking answer")
        st, raw, _ = call(port, "POST", "/generate", {
            "request_id": "bad", "prompt_tokens": [1, 2],
            "beam_width": 9})
        check(st == 400 and b"beam_width" in raw,
              f"batch invalid beam: {st} {raw[:200]!r}")
        gstats = get(port, "/health")["generator"]
        check(set(gstats) == JAX_GENERATOR_STATS_KEYS,
              f"batch /health generator keys {sorted(gstats)}")
        out.update(compiled_prefill=gstats["compiled_prefill"],
                   compiled_decode=gstats["compiled_decode"])
        proc.send_signal(signal.SIGTERM)
        check(proc.wait(timeout=120) == 0, "batch worker: exit code")
        counts = json.loads(counts_path.read_text())
        check(all(p == 0 for _, p in counts.values()),
              f"batch worker: plain versions served: {counts}")
        check(all(c[0] == 0 for k, c in counts.items()
                  if k != "flash_attention"),
              f"batch worker: other kernels launched: {counts}")
        flash = counts["flash_attention"][0]
        check(flash > 0 and flash % BATCH_LAYERS == 0,
              f"batch worker: #5 launches {flash}")
        out["launches"] = flash
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        log_f.close()
    log(f"batch worker (gpt2 bf16): {BATCH_GENERATE} /generate, "
        f"{BATCH_STREAMS} streams, {BATCH_BEAMS} beam-4 and {BATCH_SCORES} "
        f"/score at once in {out['burst_s']:.1f} s; the 600-token prompt "
        f"got 1 token; a group of {BATCH_IDENTITY} identical on repeat; a "
        f"stream == its blocking answer; beam_width 9 a 400; #5 "
        f"{out['launches']} launches = {BATCH_LAYERS} x "
        f"{out['launches'] // BATCH_LAYERS} forwards, no plain call [{card}]")
    return out


def batch_in_process(torch, card: str, params) -> dict:
    """An in-process Generator on gpt2 bf16 (the worker's weights): fused
    == chunked over 8 prompts, greedy and seeded; #5 launched exactly
    12 x the prefill and score forwards; then the readings."""
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models.transformer import init_caches
    from tpu_engine_torch.ops import flash as fl
    from tpu_engine_torch.ops import kernels as kl
    from tpu_engine_torch.runtime import generator as tg

    spec = create_model("gpt2")
    gen = tg.Generator(spec, params=params, dtype="bfloat16", step_chunk=16,
                       device="cuda")
    rng = np.random.default_rng(26)
    prompts = [batch_tokens(rng, int(rng.integers(*BATCH_PROMPT)))
               for _ in range(8)]
    kl.reset_counts()
    forwards = 0
    out = {}
    for case, kw in (("greedy", {}),
                     ("seeded", dict(temperature=0.8,
                                     seed=list(range(50, 58))))):
        chunked = gen.generate(prompts, max_new_tokens=BATCH_NEW, **kw)
        fused = gen.generate(prompts, max_new_tokens=BATCH_NEW, fused=True,
                             **kw)
        forwards += 2
        same = sum(a == b for a, b in zip(chunked, fused))
        check(same == len(prompts), f"batch fused != chunked ({case}): "
                                    f"{same} of {len(prompts)} equal")
        out[f"fused_equal_{case}"] = same
    gen.beam_search(prompts[0], beam_width=4, max_new_tokens=BATCH_BEAM_NEW)
    gen.score([p[:112] for p in prompts], [p[112:128] for p in prompts])
    forwards += 2
    launches, plain = fl.flash_attention_fwd.launches, \
        fl.flash_attention_fwd.plain_calls
    check(plain == 0 and launches == BATCH_LAYERS * forwards,
          f"batch in process: #5 launches {launches} != {BATCH_LAYERS} x "
          f"{forwards} forwards (plain {plain})")
    out["launches"], out["forwards"] = launches, forwards
    log(f"batch in process (gpt2 bf16): fused == chunked over 8 prompts "
        f"greedy and seeded; #5 {launches} == {BATCH_LAYERS} x {forwards} "
        f"prefill and score forwards [{card}]")

    # Readings. A B 8 chunked decode step (decode, sampling, bookkeeping).
    caches = init_caches(spec.config, 8, spec.config.max_seq,
                         torch.bfloat16, "cuda")
    start = np.full((8,), 100, np.int32)
    rows = tg._Rows(gen, 8, 8, 512, start, -1, [0.0] * 8, [0] * 8,
                    [1.0] * 8, [0] * 8, [1.0] * 8, [[]] * 8, [0.0] * 8)
    tok = torch.ones((8,), dtype=torch.int64, device="cuda")
    done = torch.zeros((8,), dtype=torch.bool, device="cuda")

    def step():
        return tg._decode_step_sampled(params, spec.config, torch.bfloat16,
                                       rows, tok, caches, 600, done, None)
    with torch.inference_mode():
        step()
        torch.cuda.synchronize()
        walls = []
        for _ in range(20):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = float(np.median(walls))
        issue = issue_ms(torch, step)
        busy = busy_ms(torch, step)
    idle = idle_share(busy, wall)
    out["decode_step_B8"] = {"wall_ms": wall, "issue_ms": issue,
                             "busy_ms": busy, "idle_share": idle}
    log(f"batch: gpt2 bf16 B 8 decode step (pos 600) wall {wall:.3f} ms, "
        f"host issue {issue:.3f} ms, {busy_text(busy, idle)} [{card}]")
    del caches
    # The decode loop's host reads, 8 x 64 tokens: the done flag read every
    # 16 steps (the lane's step_chunk: 5 reads) against every 64 (2 reads:
    # before the first step and after the last), once each (twice before
    # the seqpar phase). Both run the same 64 steps. The second
    # Generator's cache is warmed first.
    few = tg.Generator(spec, params=params, dtype="bfloat16",
                       step_chunk=64, device="cuda")
    few.generate(prompts, max_new_tokens=2)
    walls = {"every_16": [], "every_64": []}
    for mode, g in (("every_16", gen), ("every_64", few)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.generate(prompts, max_new_tokens=64)
        torch.cuda.synchronize()
        walls[mode].append((time.perf_counter() - t0) * 1e3)
    del few
    out["done_reads_8x64_ms"] = walls
    log(f"batch: 8 x 64 tokens with the done flag read every 16 steps (5 "
        f"reads) {walls['every_16']} ms, every 64 (2 reads) "
        f"{walls['every_64']} ms [{card}]")
    # One beam-4 step: the wall of 32 - 16 steps over 16, and its gather.
    bw = {}
    for n in (17, 33):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.beam_search(prompts[1], beam_width=4, max_new_tokens=n)
        torch.cuda.synchronize()
        bw.setdefault(n, []).append((time.perf_counter() - t0) * 1e3)
    step_ms = (min(bw[33]) - min(bw[17])) / 16
    cfg = spec.config
    gather = 2 * cfg.n_layers * 4 * cfg.max_seq * cfg.kv_heads * cfg.d_head \
        * 2
    out["beam4_step"] = {"wall_ms": step_ms, "gather_bytes": gather,
                         "gather_bound_ms": 2 * gather / PEAK_BYTES_PER_S
                         * 1e3}
    log(f"batch: one beam-4 step {step_ms:.3f} ms; its cache gather moves "
        f"{gather / 2**20:.1f} MiB (read and written: bound "
        f"{out['beam4_step']['gather_bound_ms']:.3f} ms) [{card}]")
    return out


def start_spec_lanes(torch, tmp: Path) -> tuple:
    """The two speculative lanes' worker_node processes of
    ``batch_spec_lanes``, started (not waited for) after the target's f32
    weights are saved under ``tmp``: (the lanes, their processes, the
    weights, their checkpoint's path)."""
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.utils.checkpoint import SIDECAR, save_params

    p32 = create_model("gpt2").init(0, device="cuda", dtype="float32")
    ckpt = tmp / "gpt2-f32"
    save_params(str(ckpt), p32)
    (ckpt / SIDECAR).write_text(json.dumps({"model": "gpt2"}))
    lanes = {"self": (["spec-self", str(ckpt), "--gen-draft-model", "gpt2",
                       "--gen-draft-path", str(ckpt)], BATCH_LAYERS),
             "auto": (["spec-auto", "gpt2"], 6)}
    procs = {lane: start_counted_worker_node(
        [*args, *SPEC_LANE_ARGS], f"spec_{lane}.log",
        f"spec_{lane}_counts.json") for lane, (args, _) in lanes.items()}
    return lanes, procs, p32, ckpt


def batch_spec_lanes(torch, card: str, started: tuple) -> dict:
    """The speculative lane with draft weights from a path (the target's
    own, in the port's checkpoint format: a perfect draft) and with the
    auto draft (distilgpt2, random), each a worker_node process in f32
    (``start_spec_lanes`` starts them);
    both lanes' greedy streams against an in-process f32 Generator."""
    import signal

    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models.transformer import transformer_apply
    from tpu_engine_torch.runtime.generator import Generator
    from tpu_engine_torch.runtime.speculative import SpeculativeGenerator

    spec = create_model("gpt2")
    lanes, procs, p32, ckpt = started
    rng = np.random.default_rng(27)
    prompts = [batch_tokens(rng, int(rng.integers(*BATCH_PROMPT)))
               for _ in range(8)]
    ref = Generator(spec, params=p32, dtype="float32", device="cuda")
    want = ref.generate(prompts, max_new_tokens=BATCH_NEW)
    out = {}
    try:
        for lane, (proc, port, log_f, counts_path) in procs.items():
            out[lane] = {"ready_s": wait_health(proc, port)}
            bodies = {f"sp{i}": {"request_id": f"sp{i}", "prompt_tokens": p,
                                 "max_new_tokens": BATCH_NEW}
                      for i, p in enumerate(prompts)}
            got = concurrent_posts(port, "/generate", bodies)[0]
            streams = [got[f"sp{i}"]["tokens"] for i in range(8)]
            gst = get(port, "/health")["generator"]
            sp = gst["spec"]
            check(sp["lane"] == "batch", f"spec {lane}: {sp}")
            metrics = get_text(port, "/metrics")
            node = "spec-self" if lane == "self" else "spec-auto"
            check(f'tpu_engine_spec_k{{node="{node}",lane="batch"}} '
                  f'{BATCH_SPEC_K}' in metrics,
                  f"spec {lane}: /metrics has no batch spec_k line")
            st, raw, _ = call(port, "POST", "/generate", {
                "request_id": "tp", "prompt_tokens": [1, 2, 3],
                "top_p": 0.9})
            check(st == 400, f"spec {lane}: top_p answered {st}")
            out[lane].update(
                mean_tokens_per_round=gst.get("mean_tokens_per_round"),
                tokens_per_row_dispatch=sp["tokens_per_row_dispatch"],
                accept_ratio=sp["accept_ratio"],
                dispatches=sp["dispatches"])
            if lane == "self":
                # JAX's bar for a perfect draft (tests/test_speculative.py:
                # 52); a draft left random advances about 1 a round.
                for key in ("tokens_per_row_dispatch",
                            "mean_tokens_per_round"):
                    check(out[lane][key] > 0.9 * BATCH_SPEC_K,
                          f"spec self-draft: {key} {out[lane][key]} <= "
                          f"0.9 x {BATCH_SPEC_K}")
            # Streams that part from the in-process Generator's: the
            # top-2 margin at the first difference.
            margins = []
            for p, w, g in zip(prompts, want, streams):
                if w == g:
                    continue
                i = next((j for j, (a, b) in enumerate(zip(w, g))
                          if a != b), min(len(w), len(g)))
                seq = torch.tensor([p + w[:i]], device="cuda")
                with torch.inference_mode():
                    lg = transformer_apply(p32, seq, spec.config,
                                           dtype=torch.float32,
                                           head_rows=torch.tensor(
                                               [seq.shape[1] - 1],
                                               device="cuda"))[0]
                top2 = torch.topk(lg.float(), 2).values
                margins.append(float(top2[0] - top2[1]))
            out[lane]["streams_differing"] = len(margins)
            out[lane]["margins_at_first_difference"] = margins
            check(all(m <= BATCH_SPEC_MARGIN for m in margins),
                  f"spec {lane}: a stream parts at top-2 margins "
                  f"{margins} > {BATCH_SPEC_MARGIN}")
            proc.send_signal(signal.SIGTERM)
            check(proc.wait(timeout=120) == 0, f"spec {lane}: exit code")
            counts = json.loads(counts_path.read_text())
            check(all(p == 0 for _, p in counts.values()),
                  f"spec {lane}: plain versions served: {counts}")
            flash = counts["flash_attention"][0]
            per_group = BATCH_LAYERS + lanes[lane][1]
            check(flash > 0 and flash % per_group == 0,
                  f"spec {lane}: #5 launches {flash} not a multiple of "
                  f"{per_group}")
            out[lane]["launches"] = flash
            log(f"spec lane {lane} (gpt2 f32, k {BATCH_SPEC_K}, "
                f"{'draft weights from ' + str(ckpt.name) if lane == 'self' else 'distilgpt2 random'}): "
                f"{sp['tokens_per_row_dispatch']} tokens a live round, "
                f"accept ratio {sp['accept_ratio']}; {len(margins)} of 8 "
                f"greedy streams part from the in-process Generator's "
                f"(margins {margins}); spec block lane=batch in /health "
                f"and /metrics; top_p a 400; #5 {flash} launches [{card}]")
    finally:
        for proc, _, log_f, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
            log_f.close()
    # One speculative round in this process (self-draft, f32).
    sg = SpeculativeGenerator(spec, spec, params=p32, draft_params=p32,
                              k=BATCH_SPEC_K, dtype="float32",
                              device="cuda")
    sg.generate(prompts, max_new_tokens=BATCH_NEW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sg.generate(prompts, max_new_tokens=BATCH_NEW)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rounds = sg.last_stats["rounds"]
    out["round"] = {"call_ms": wall, "rounds": rounds,
                    "ms_per_round": wall / max(1, rounds),
                    "mean_tokens_per_round":
                        sg.last_stats["mean_tokens_per_round"]}
    log(f"batch: one speculative round (gpt2 f32 self-draft, k "
        f"{BATCH_SPEC_K}, B 8) {out['round']['ms_per_round']:.2f} ms, "
        f"{sg.last_stats['mean_tokens_per_round']} tokens a round "
        f"(prefills included in the call's {wall:.1f} ms) [{card}]")
    return out


def phase_batch(torch, card: str) -> dict:
    """The batch lanes on the card (the module docstring's batch entry)."""
    import shutil
    import tempfile

    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.ops import kernels as kl

    t0 = time.perf_counter()
    walls = {}
    lap = lap_timer(walls)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_batch_"))
    try:
        # The three worker processes load while the in-process parts run.
        started = start_counted_worker_node(
            ["batch-w", *BATCH_LANE_ARGS], "batch_worker.log",
            "batch_counts.json")
        spec_started = start_spec_lanes(torch, tmp)
        lap("start workers")
        out = {"small": batch_small(torch), "walls_s": walls}
        lap("small")
        out["flash"] = batch_flash(torch, card)
        lap("flash")
        params = create_model("gpt2").init(0, device="cuda",
                                           dtype="bfloat16")
        out["in_process"] = batch_in_process(torch, card, params)
        del params
        lap("in process")
        # The main path: counts to 0 just before the worker, read just
        # after.
        kl.reset_counts()
        out["worker"] = batch_worker(torch, card, started)
        lap("worker")
        out["spec"] = batch_spec_lanes(torch, card, spec_started)
        lap("spec lanes")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"batch: every check passed in {out['seconds']:.1f} s, walls (s) "
        f"{json.dumps({k: round(v, 1) for k, v in walls.items()})} "
        f"[{card}]")
    return out


# -- the combined serve command ----------------------------------------------

# The one-shot load: the reference benchmark's (200 requests, 8 threads,
# 10 distinct inputs) at resnet50's full width.
COMBINED_INFER_ARGS = ("--model", "resnet50", "--lanes", "2",
                       "--native-front", "on", "--breaker-timeout", "1",
                       "--warmup")
COMBINED_REQUESTS = 200
COMBINED_THREADS = 8
COMBINED_DISTINCT = 10
# Fault check: requests owned by worker_1 while it is faulted, and after.
COMBINED_FAULT_REQUESTS = 8
COMBINED_DECODER_ARGS = (
    "--model", "llama", "--lanes", "2", "--lane-roles", "prefill,decode",
    "--disagg", "--kv-block-size", "16", "--mixed-step", "--native-front",
    "on", "--default-deadline-ms", "60000", "--retry-backoff-ms", "5")
COMBINED_STREAMS = 8
COMBINED_PROMPT = (64, 513)
COMBINED_NEW = 32
COMBINED_SCORES = 8
COMBINED_IDENTITY = 4


def spawn_counted_serve(args, log_path: Path, counts_path: Path):
    """The serve command as a process of its own (``chip_smoke.py
    --serve-combined``) on a free port, writing its kernels' launch counts
    to ``counts_path`` when it exits: (process, port, the log's file)."""
    port = free_port()
    out = open(log_path, "w")
    proc = popen(
        [sys.executable, str(Path(__file__).resolve()), "--serve-combined",
         str(counts_path), "--port", str(port), *args],
        cwd=str(Path(__file__).resolve().parent), stdout=out,
        stderr=subprocess.STDOUT)
    return proc, port, out


def main_serve_combined(argv) -> int:
    """``--serve-combined COUNTS <serve argv>``: serve until SIGTERM, then
    write the launch counts (kernel -> [launches, plain calls])."""
    from tpu_engine_torch.serving import cli

    code = cli.main(["serve", *argv[1:]])
    Path(argv[0]).write_text(json.dumps(launch_counts()))
    return code


def stop_counted(proc, counts_path: Path, what: str) -> dict:
    import signal

    proc.send_signal(signal.SIGTERM)
    check(proc.wait(timeout=120) == 0, f"{what}: exit code")
    return json.loads(counts_path.read_text())


def raw_post(port: int, body: bytes, conn=None) -> tuple:
    """(status, raw body, seconds) of one POST /infer of ``body``."""
    own = conn is None
    if own:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/infer", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data, time.perf_counter() - t0
    finally:
        if own:
            conn.close()


def infer_fragment(raw: bytes) -> bytes:
    """The output_data fragment of an /infer answer, as sent."""
    a = raw.index(b'"output_data": ') + len(b'"output_data": ')
    return raw[a:raw.index(b', "node_id"', a)]


def combined_one_shot(card: str, proc, port: int, counts_path: Path) -> dict:
    """resnet50 on two lanes behind the C++ front (the serve process on
    ``port``): the reference load, the hits' counters and bytes, a lane
    fault and its heal, then the process's counts."""
    rng = np.random.default_rng(20)
    inputs = [json.dumps(np.round(rng.standard_normal(224 * 224 * 3), 4)
                         .tolist()).encode() for _ in range(COMBINED_DISTINCT)]

    def body(rid: str, k: int) -> bytes:
        return (b'{"request_id": "' + rid.encode() + b'", "input_data": '
                + inputs[k] + b"}")
    # Fresh ids, in blocks of COMBINED_DISTINCT per lane in turn. The first
    # two blocks (each input's miss on each lane) complete before a thread
    # takes a later request: a repeat sent while its miss is in flight
    # would wait on it in Python (coalesced), not hit in C++.
    ring = ring_of(["worker_1", "worker_2"])
    per_lane = {n: owned(ring, n, COMBINED_REQUESTS, f"cb{n[-1]}-")
                for n in ("worker_1", "worker_2")}
    rids = [per_lane[f"worker_{(i // COMBINED_DISTINCT) % 2 + 1}"][i]
            for i in range(COMBINED_REQUESTS)]
    out = {"ready_s": wait_health(proc, port)}
    lock = threading.Lock()
    answers, errors = [], []
    nxt = [0]
    cold = 2 * COMBINED_DISTINCT
    cold_done = threading.Semaphore(0)
    warm = threading.Event()

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=300)
        try:
            while True:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                if i >= COMBINED_REQUESTS:
                    return
                if i >= cold:
                    warm.wait(timeout=600)
                k = i % COMBINED_DISTINCT
                try:
                    st, raw, sec = raw_post(port, body(rids[i], k),
                                            conn)
                except Exception as exc:  # reported below
                    errors.append(f"{i}: {exc!r}")
                    conn.close()
                    conn = http.client.HTTPConnection(
                        "127.0.0.1", port, timeout=300)
                    continue
                with lock:
                    answers.append((i, k, st, raw, sec))
                if i < cold:
                    cold_done.release()
        finally:
            conn.close()

    def open_warm():
        for _ in range(cold):
            cold_done.acquire(timeout=600)
        warm.set()
    threads = [threading.Thread(target=client)
               for _ in range(COMBINED_THREADS)]
    t0 = time.perf_counter()
    for th in [threading.Thread(target=open_warm), *threads]:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not errors and len(answers) == COMBINED_REQUESTS
          and all(a[2] == 200 for a in answers),
          f"combined load: {errors[:3]} "
          f"{[a[3][:200] for a in answers if a[2] != 200][:3]}")
    frags, cached, hit_s = {}, 0, []
    for i, k, _, raw, sec in answers:
        ans = json.loads(raw)
        out_data = np.asarray(ans["output_data"], np.float64)
        check(out_data.shape == (1000,) and np.isfinite(out_data).all(),
              f"combined answer {i}: {out_data.shape}")
        frag = infer_fragment(raw)
        first = frags.setdefault((k, ans["node_id"]), frag)
        check(frag == first, f"combined answer {i}: its fragment is "
                             f"not its input's miss fragment")
        if ans["cached"]:
            cached += 1
            hit_s.append(sec)
    health, stats = get(port, "/health"), get(port, "/stats")
    cpp_hits = health["total_requests"] - stats["total_requests"]
    check(health["total_requests"] == COMBINED_REQUESTS,
          f"combined /health total_requests {health['total_requests']}")
    check(health["cache_hits"] == cached,
          f"combined /health cache_hits {health['cache_hits']} != "
          f"{cached} cached answers")
    check(cpp_hits >= COMBINED_REQUESTS - 2 * COMBINED_DISTINCT,
          f"combined: {cpp_hits} C++ hits of {COMBINED_REQUESTS}")
    check(all(health["lanes"][n]["total_requests"] > 0
              for n in ("worker_1", "worker_2")),
          f"combined: a lane served nothing {health['lanes']}")
    p50, p99 = p50_p99_ms(hit_s)
    out.update(wall_s=wall, req_per_s=COMBINED_REQUESTS / wall,
               cpp_hits=cpp_hits, python_hits=cached - cpp_hits,
               misses=COMBINED_REQUESTS - cached,
               hit_p50_ms=p50, hit_p99_ms=p99,
               lanes={n: {k: h[k] for k in ("total_requests",
                                            "cache_hits")}
                      for n, h in health["lanes"].items()})
    log(f"combined resnet50 (bf16, 2 lanes, C++ front): "
        f"{COMBINED_REQUESTS} /infer from {COMBINED_THREADS} threads "
        f"over {COMBINED_DISTINCT} inputs in {wall:.2f} s "
        f"({out['req_per_s']:.1f} req/s), {cpp_hits} C++ hits, "
        f"{cached - cpp_hits} Python hits, {out['misses']} misses; "
        f"hits p50 {p50:.2f} ms p99 {p99:.2f} ms [{card}]")
    # A fault on worker_1: its requests fail over, its counters stand
    # still (no C++ hit); healed, its hits come back through C++.
    rids = owned(ring, "worker_1", 2 * COMBINED_FAULT_REQUESTS, "cf")
    post(port, "/admin/fault", {"node": "worker_1", "action": "fail"})
    w1 = get(port, "/health/worker_1")
    check(w1["healthy"] is False, "combined: faulted lane healthy")
    for rid in rids[:COMBINED_FAULT_REQUESTS]:
        st, raw, _ = raw_post(port, body(rid, 0))
        check(st == 200 and json.loads(raw)["node_id"] == "worker_2",
              f"combined fault: {rid} {st} {raw[:200]!r}")
    w1b = get(port, "/health/worker_1")
    check(w1b["total_requests"] == w1["total_requests"]
          and w1b["cache_hits"] == w1["cache_hits"],
          f"combined fault: worker_1 counted {w1} -> {w1b}")
    post(port, "/admin/fault", {"node": "worker_1", "action": "heal"})
    time.sleep(1.2)  # the breaker's timeout: it half-opens
    gw_before = get(port, "/stats")["total_requests"]
    for rid in rids[COMBINED_FAULT_REQUESTS:]:
        st, raw, _ = raw_post(port, body(rid, 0))
        ans = json.loads(raw)
        check(st == 200 and ans["node_id"] == "worker_1"
              and ans["cached"], f"combined heal: {rid} {raw[:200]!r}")
    w1c = get(port, "/health/worker_1")
    check(w1c["total_requests"] - w1b["total_requests"]
          == COMBINED_FAULT_REQUESTS
          and get(port, "/stats")["total_requests"] == gw_before,
          f"combined heal: worker_1's hits were not C++ hits "
          f"({w1b} -> {w1c})")
    out["fault"] = {"failed_over": COMBINED_FAULT_REQUESTS,
                    "cpp_hits_after_heal": COMBINED_FAULT_REQUESTS}
    log(f"combined fault: worker_1 failed, {COMBINED_FAULT_REQUESTS} "
        f"of its requests served by worker_2, its counters still; "
        f"healed, {COMBINED_FAULT_REQUESTS} C++ hits again")
    counts = stop_counted(proc, counts_path, "combined resnet50")
    check(all(c == [0, 0] for c in counts.values()),
          f"combined resnet50 launched kernels: {counts}")
    return out


def combined_decoder(card: str, proc, port: int, counts_path: Path) -> dict:
    """TinyLlama on a prefill and a decode lane behind the C++ front (the
    serve process on ``port``): streams handed off in process, /score
    rows, greedy identity, and the process's launch counts against the
    lanes' ticks and dispatches."""
    from tpu_engine_torch.models.registry import create_model

    layers = create_model("llama").config.n_layers
    vocab = create_model("llama").config.vocab
    rng = np.random.default_rng(21)

    def toks(n):
        return [int(t) for t in rng.integers(1, vocab, n)]
    out = {"ready_s": wait_health(proc, port, timeout=600)}
    prompts = [toks(int(rng.integers(*COMBINED_PROMPT)))
               for _ in range(COMBINED_STREAMS)]
    readers = [StreamReader(port, {"request_id": f"cs{i}",
                                   "prompt_tokens": p,
                                   "max_new_tokens": COMBINED_NEW})
               for i, p in enumerate(prompts)]
    scores = {f"cc{i}": {"request_id": f"cc{i}",
                         "prompt_tokens": toks(112),
                         "completion_tokens": toks(16)}
              for i in range(COMBINED_SCORES)}
    res = {}
    sc = threading.Thread(target=lambda: res.update(
        concurrent_posts(port, "/score", scores)[0]))
    t0 = time.perf_counter()
    for th in [*readers, sc]:
        th.start()
    for th in [*readers, sc]:
        th.join(timeout=600)
    out["burst_s"] = time.perf_counter() - t0
    for r in readers:
        check(r.final is not None and "error" not in r.final
              and r.tokens == r.final["tokens"]
              and len(r.tokens) == COMBINED_NEW
              and r.final["node_id"] == "worker_2",
              f"combined stream {r.body['request_id']}: {r.final} "
              f"{r.error}")
    check(len(res) == COMBINED_SCORES, f"combined /score: {len(res)}")
    for name, ans in res.items():
        lp = np.asarray(ans["logprobs"], np.float64)
        check(lp.shape == (16,) and np.isfinite(lp).all()
              and (lp <= 0).all(), f"combined /score {name}")
    # Greedy identity under one composition: prompts the prefill lane
    # has seen, each alone, twice.
    passes = [[stream(port, {"request_id": f"ci{j}-{i}",
                             "prompt_tokens": prompts[i],
                             "max_new_tokens": COMBINED_NEW})[0]
               for i in range(COMBINED_IDENTITY)] for j in range(2)]
    check(passes[0] == passes[1],
          "combined: greedy streams differ on repeat")
    stats = get(port, "/stats")
    ho = stats["handoff"]
    n_streams = COMBINED_STREAMS + 2 * COMBINED_IDENTITY
    check(ho["handoffs_spliced"] == n_streams
          and ho["handoff_fallbacks"] == 0
          and ho["roles"] == {"worker_1": "prefill",
                              "worker_2": "decode"},
          f"combined handoff: {ho}")
    lanes = {n: get(port, f"/health/{n}")["generator"]
             for n in ("worker_1", "worker_2")}
    check(lanes["worker_2"]["kv_pool"]["prefilled_tokens"] == 0,
          f"combined: the decode lane prefilled "
          f"{lanes['worker_2']['kv_pool']}")
    ticks = {n: g["mixed"]["ticks"] for n, g in lanes.items()}
    oneshot = {n: g["stateless"]["dispatches"] for n, g in lanes.items()}
    counts = stop_counted(proc, counts_path, "combined llama")
    ragged, flash = (counts["ragged_paged_attention"][0],
                     counts["flash_attention"][0])
    check(all(c[1] == 0 for c in counts.values()),
          f"combined llama: plain versions served: {counts}")
    check(all(c[0] == 0 for k, c in counts.items()
              if k not in ("ragged_paged_attention",
                           "flash_attention")),
          f"combined llama: other kernels launched: {counts}")
    check(ragged == layers * sum(ticks.values()) > 0,
          f"combined llama: #1 {ragged} != {layers} x {ticks}")
    check(flash == layers * sum(oneshot.values()) > 0,
          f"combined llama: #5 {flash} != {layers} x {oneshot}")
    out.update(launches={"ragged_paged_attention": ragged,
                         "flash_attention": flash},
               ticks=ticks, oneshot_dispatches=oneshot,
               handoffs_spliced=ho["handoffs_spliced"],
               tokens_handed_off=ho.get("tokens_handed_off"))
    log(f"combined llama ({layers} layers, bf16, prefill + decode lanes, "
        f"C++ front): {COMBINED_STREAMS} streams handed off in process "
        f"(0 tokens prefilled on the decode lane) and {COMBINED_SCORES} "
        f"/score rows in {out['burst_s']:.1f} s; {COMBINED_IDENTITY} greedy "
        f"streams identical on repeat; #1 {ragged} = {layers} x "
        f"{sum(ticks.values())} ticks {ticks}, #5 {flash} = {layers} x "
        f"{sum(oneshot.values())} one-shot dispatches, no plain call "
        f"[{card}]")
    return out


def phase_combined(torch, card: str) -> dict:
    """The combined serve command: its native library's build, the
    one-shot load on resnet50, the decoder lanes on TinyLlama."""
    from tpu_engine_torch.core import native

    OUT_DIR.mkdir(exist_ok=True)
    # Both serve processes start together: the decoder's starts up while
    # the one-shot load runs; the library builds here while they import.
    procs = {}
    try:
        for name, args in (("infer", COMBINED_INFER_ARGS),
                           ("llama", COMBINED_DECODER_ARGS)):
            counts_path = OUT_DIR / f"combined_{name}_counts.json"
            counts_path.unlink(missing_ok=True)
            proc, port, log_f = spawn_counted_serve(
                args, OUT_DIR / f"combined_{name}.log", counts_path)
            procs[name] = (proc, port, log_f, counts_path)
        t0 = time.perf_counter()
        lib = native.load()
        build_s = time.perf_counter() - t0
        log(f"combined: {Path(lib._name).name} ready in {build_s:.1f} s")
        return {"native_build_s": build_s,
                "one_shot": combined_one_shot(
                    card, *(procs["infer"][i] for i in (0, 1, 3))),
                "decoder": combined_decoder(
                    card, *(procs["llama"][i] for i in (0, 1, 3)))}
    finally:
        for proc, _, log_f, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
            log_f.close()


# -- the elastic phase ---------------------------------------------------------

# The elastic fleet: the combined server's controller on TinyLlama's width
# at cut depth, f32 (streams compared token for token), paged mixed lanes.
ELASTIC_LANE = dict(dtype="float32", gen_kv_block_size=16,
                    gen_mixed_step=True, gen_mixed_token_budget=256,
                    gen_prefill_chunk=256, gen_max_batch_size=8, seed=0)
ELASTIC_GATEWAY = dict(autoscale=True, migrate_streams=True,
                       autoscale_min_lanes=2, autoscale_max_lanes=3,
                       autoscale_interval_s=0.25, autoscale_cooldown_s=0.5,
                       autoscale_spawn_timeout_s=5.0,
                       autoscale_up_pressure=0.30,
                       autoscale_down_pressure=0.20,
                       health_probe_interval_s=0.1)
ELASTIC_BURST = 12            # 12 of the 16 slots of two lanes: 0.75
ELASTIC_SEEDED = 4            # of them sampled at 0.8 with a seed
ELASTIC_NEW = 32
ELASTIC_TRICKLE_NEW = 256     # one per lane, alive through the retire
ELASTIC_STALL_STREAMS = 4
ELASTIC_STALL_NEW = 16
ELASTIC_STALL_ATTEMPTS = 3    # the stall drill's, if one flaps
# Port 9 (discard): nothing answers its /health.
DEAD_WORKER = "127.0.0.1:9"


def elastic_requests(vocab: int) -> dict:
    """Every request of the phase by label: the burst (b*), the trickle
    (t*), the wedge's control stream (w0), the standby lane's (s0) and the
    stall drill's (st*), each with its prompt, budget and sampling."""
    rng = np.random.default_rng(31)

    def toks(n):
        return [int(t) for t in rng.integers(1, vocab, n)]
    reqs = {}
    for i in range(ELASTIC_BURST):
        body = {"prompt_tokens": toks(int(rng.integers(64, 257))),
                "max_new_tokens": ELASTIC_NEW}
        if i >= ELASTIC_BURST - ELASTIC_SEEDED:
            body.update(temperature=0.8, seed=1000 + i)
        reqs[f"b{i}"] = body
    for i in range(3):
        reqs[f"t{i}"] = {"prompt_tokens": toks(96),
                         "max_new_tokens": ELASTIC_TRICKLE_NEW}
    reqs["w0"] = {"prompt_tokens": toks(80), "max_new_tokens": ELASTIC_NEW}
    reqs["s0"] = {"prompt_tokens": toks(80), "max_new_tokens": ELASTIC_NEW}
    for i in range(ELASTIC_STALL_STREAMS):
        reqs[f"st{i}"] = {"prompt_tokens": toks(64),
                          "max_new_tokens": ELASTIC_STALL_NEW}
    return reqs


def elastic_control(model: str, reqs: dict) -> dict:
    """Every request on a static two-lane fleet (no controller) on the
    same seeded weights, in the groups the elastic run sends together:
    tokens by label."""
    from tpu_engine_torch.serving.app import serve_combined, stop_combined
    from tpu_engine_torch.utils.config import WorkerConfig

    gw, workers, srv = serve_combined(
        model=model, lanes=2, port=0, native_front=False,
        worker_config=WorkerConfig(model=model, device="cuda",
                                   **ELASTIC_LANE))
    out = {}
    try:
        for group in ("b", "t", "ws"):
            labels = [k for k in reqs if k[0] in group]
            res = {k: {} for k in labels}
            threads = [threading.Thread(target=gateway_stream, args=(
                gw, dict(reqs[k], request_id=f"ctl-{k}"), res[k]))
                for k in labels]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            for k in labels:
                check(res[k].get("final") is not None
                      and "error" not in res[k]["final"],
                      f"elastic control {k}: {res[k].get('final')}")
                out[k] = res[k]["tokens"]
    finally:
        stop_combined(gw, workers, srv)
    return out


def owned_rid(gw, lane: str, prefix: str) -> str:
    """A request id the gateway's ring gives to ``lane``."""
    return next(r for r in (f"{prefix}{i}" for i in range(10000))
                if gw._ring.get_node(r) == lane)


def wait_for(pred, what: str, timeout: float = 60.0,
             phase: str = "elastic") -> float:
    """Seconds until ``pred()`` held; fails ``phase`` after ``timeout``."""
    t0 = time.perf_counter()
    while not pred():
        check(time.perf_counter() - t0 < timeout, f"{phase}: {what}")
        time.sleep(0.01)
    return time.perf_counter() - t0


def fleet_decisions(gw) -> list:
    """(decision, its wall-clock time in s, attrs) of every fleet marker
    span, in order."""
    return [(s["attrs"]["decision"], s.get("start_ts", s["ts"]),
             s["attrs"])
            for s in gw.tracer.snapshot() if s["op"] == "fleet"]


def decision_walls_ms(decisions: list) -> dict:
    """Each actuated decision's wall: from its *_attempted marker to the
    *_completed or *_failed that ends it, in ms."""
    out, open_at = {}, {}
    for name, ts, attrs in decisions:
        kind, _, what = name.rpartition("_")
        if what == "attempted":
            open_at[kind] = (ts, attrs.get("worker"))
        elif what in ("completed", "failed") and kind in open_at:
            t0, worker = open_at.pop(kind)
            out[f"{kind} {worker} {what}"] = (ts - t0) * 1e3
    return out


def elastic_standby(model: str, params, reqs: dict, control: dict) -> dict:
    """A standby worker served over HTTP in this process joins a gateway
    through StandbyLaneProvider (the HTTP probe gate), serves a stream
    equal to the control's, and goes back to the pool when retired."""
    from tpu_engine_torch.serving.app import serve_gateway, worker_server
    from tpu_engine_torch.serving.worker import WorkerNode
    from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig

    sw = WorkerNode(WorkerConfig(model=model, node_id="standby",
                                 device="cuda", **ELASTIC_LANE),
                    params=params)
    ssrv = worker_server(sw, 0)
    ssrv.start(background=True)
    addr = f"127.0.0.1:{ssrv.port}"
    gw2, srv2 = serve_gateway([], GatewayConfig(port=0, migrate_streams=True),
                              standby_workers=[addr])
    try:
        ctl = gw2._autoscaler
        check(ctl is not None and not ctl.running
              and ctl.provider.capacity() == 1,
              "elastic standby: the provider was not engaged")
        t0 = time.perf_counter()
        up = ctl.scale_up()
        probe_ms = (time.perf_counter() - t0) * 1e3
        check(up == {"ok": True, "status": "registered", "worker": addr}
              and gw2.worker_names() == [addr],
              f"elastic standby: {up}")
        toks, final, _ttft = stream(srv2.port, dict(reqs["s0"],
                                                    request_id="s0"))
        check(final is not None and final.get("node_id") == "standby"
              and toks == control["s0"],
              f"elastic standby stream: {final}; equal "
              f"{toks == control['s0']}")
        down = ctl.scale_down(name=addr)
        check(down["status"] == "removed" and gw2.worker_names() == []
              and ctl.provider.capacity() == 1,
              f"elastic standby retire: {down}")
        ticks = sw.generator.stats()["mixed"]["ticks"]
        return {"probe_gate_ms": probe_ms, "ticks": ticks,
                "fleet": gw2.get_stats()["fleet"]}
    finally:
        srv2.stop()
        gw2.stop()
        ssrv.stop()
        sw.stop()


def elastic_stall(gw, srv, reqs: dict, control: dict) -> dict:
    """One lane's stall threshold at 1e-9 s: its /health reads
    scheduler_stalled, the prober ejects it, streams whose ring owner it
    is complete on the peer; back at 0 the lane is restored.

    ``last_tick_age_s`` is rounded to 1 ms, and the idle lane's decode
    loop beats every 20 ms, so a probe within half a millisecond of a
    beat would read 0, healthy, and restore the lane until the next probe
    ejects it again (a flap; every attempt of one smoke on a slow host
    flapped so). The drill therefore also wedges the lane's prefill
    (``_prefill_busy_since`` 123 s back), which the age takes as its
    maximum: every probe reads the lane stalled. An attempt with one
    ejection and the lane still ejected after its streams ended had no
    flap, and its streams must all be on the peer; a flapped attempt is
    run again, at most ELASTIC_STALL_ATTEMPTS in all, and the phase fails
    if none is clean."""
    lanes = sorted(gw.worker_names())
    stalled, peer = lanes[0], lanes[1]
    worker = gw.lane_clients()[stalled].worker
    attempts = []
    for attempt in range(ELASTIC_STALL_ATTEMPTS):
        ej0 = gw.failover.get("prober_ejections")
        rs0 = gw.failover.get("prober_restores")
        worker.config.scheduler_stall_s = 1e-9
        worker.generator._prefill_busy_since = time.monotonic() - 123
        try:
            eject_s = wait_for(lambda: stalled in gw.ejected_lanes(),
                               "the stalled lane was not ejected", 20.0)
            # A read within half a millisecond of a tick reads healthy:
            # read until one lands later.
            for _ in range(10):
                health = get(srv.port, "/health")
                if health["lanes"][stalled].get("scheduler_stalled"):
                    break
                time.sleep(0.02)
            readers = [StreamReader(srv.port, dict(
                reqs[f"st{i}"],
                request_id=owned_rid(gw, stalled, f"st{attempt}.{i}-")))
                for i in range(ELASTIC_STALL_STREAMS)]
            for r in readers:
                r.start()
            for r in readers:
                r.join(timeout=600)
            ejected_through = stalled in gw.ejected_lanes()
        finally:
            worker.config.scheduler_stall_s = 0.0
            worker.generator._prefill_busy_since = None
        restore_s = wait_for(lambda: stalled not in gw.ejected_lanes(),
                             "the lane was not restored", 20.0)
        ej = gw.failover.get("prober_ejections") - ej0
        rs = gw.failover.get("prober_restores") - rs0
        nodes = [r.final.get("node_id") if r.final else None
                 for r in readers]
        for i, r in enumerate(readers):
            check(r.final is not None and "error" not in r.final
                  and r.tokens == control[f"st{i}"],
                  f"elastic stall stream {i}: {r.final} {r.error}")
        lane_h = health["lanes"][stalled]
        check(lane_h.get("scheduler_stalled") is True
              and lane_h["healthy"] is False and health["healthy"] is False,
              f"elastic stall: /health {lane_h.get('healthy')}, "
              f"{lane_h.get('scheduler_stalled')}")
        check(ej >= 1 and rs == ej, f"elastic stall: {ej} ejections, "
                                    f"{rs} restores")
        attempts.append({"eject_s": eject_s, "restore_s": restore_s,
                         "prober_ejections": ej, "prober_restores": rs,
                         "stream_nodes": nodes})
        if ej == 1 and ejected_through:
            break
    check(ej == 1 and ejected_through, f"elastic stall: every attempt "
                                       f"flapped: {attempts}")
    check(nodes == [peer] * ELASTIC_STALL_STREAMS,
          f"elastic stall: streams on {nodes}, not {peer}")
    return {"stalled": stalled, "peer": peer, "attempts": attempts,
            **attempts[-1]}


def phase_elastic(torch, card: str) -> dict:
    """The elastic fleet on the card (see the module docstring's elastic
    entry)."""
    import gc

    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.ops import kernels
    from tpu_engine_torch.serving.app import serve_combined, stop_combined
    from tpu_engine_torch.serving.resilience import FleetCounters
    from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig

    t_phase = time.perf_counter()
    model = cut_llama()
    cfg = create_model(model).config
    reqs = elastic_requests(cfg.vocab)
    out = {}
    t0 = time.perf_counter()
    control = elastic_control(model, reqs)
    out["control_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    gw, workers, srv = serve_combined(
        model=model, lanes=2, port=0, native_front=True,
        worker_config=WorkerConfig(model=model, device="cuda",
                                   **ELASTIC_LANE),
        gateway_config=GatewayConfig(port=0, **ELASTIC_GATEWAY))
    lanes_seen = list(workers)
    rings = []

    def rings_agree(step: str) -> None:
        cpp, py = sorted(srv.ring_nodes()), sorted(gw.worker_names())
        rings.append((step, py))
        check(cpp == py, f"elastic {step}: C++ ring {cpp} != gateway {py}")

    def memory() -> int:
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    try:
        ctl = gw._autoscaler
        check(ctl is not None and ctl.running,
              "elastic: the controller is not running")
        rings_agree("start")
        provider = ctl.provider
        factory, spawned = provider._factory, {}

        def timed_factory(idx):
            t = time.time()
            w = factory(idx)
            spawned[w.node_id] = {"start": t, "built": time.time()}
            lanes_seen.append(w)
            return w
        provider._factory = timed_factory
        pool = workers[0].generator._pool
        pool_bytes = sum(t.numel() * t.element_size() for t in pool.caches)
        mem_before = memory()
        kernels.reset_counts()  # the main path: counts from 0
        # 1. Ramp up: the burst reads above 0.30 and mints worker_3.
        burst = [StreamReader(srv.port, dict(reqs[f"b{i}"],
                                             request_id=f"b{i}"))
                 for i in range(ELASTIC_BURST)]
        t_burst = time.perf_counter()
        for r in burst:
            r.start()
        up_s = wait_for(lambda: gw.fleet.get("scale_up_completed") >= 1,
                        f"no scale-up: {gw.fleet.as_dict()}")
        minted = lanes_seen[-1]
        check(minted.node_id == "worker_3" and len(lanes_seen) == 3
              and sorted(gw.worker_names())
              == ["worker_1", "worker_2", "worker_3"],
              f"elastic: minted {minted.node_id}, lanes "
              f"{gw.worker_names()}")
        rings_agree("scaled up")
        shared = [a.data_ptr() == b.data_ptr() for a, b in zip(
            leaves(minted.engine.params), leaves(workers[0].engine.params))]
        check(shared and all(shared),
              "elastic: the minted lane drew weights of its own")
        mem_three = memory()
        # 2. Ramp down: one long stream on each lane; as the burst drains
        # the mean falls below 0.20 and a lane retires through the drain
        # and the migration of its stream. The loop waits (paused within
        # its cooldown) until every lane holds its long stream.
        ctl.stop()
        trickle = [StreamReader(srv.port, dict(
            reqs[f"t{i}"], request_id=owned_rid(gw, lane, f"t{i}-")))
            for i, lane in enumerate(sorted(gw.worker_names()))]
        for r in trickle:
            r.start()
        wait_for(lambda: set(gw.active_streams().values()) == set(
            gw.worker_names()) and all(
            r.body["request_id"] in gw.active_streams() for r in trickle),
            "the trickle's streams did not start")
        ctl.start()
        for r in burst:
            r.join(timeout=600)
        burst_s = time.perf_counter() - t_burst
        down_s = wait_for(
            lambda: gw.fleet.get("scale_down_completed") >= 1,
            f"no scale-down: {gw.fleet.as_dict()}")
        for r in trickle:
            r.join(timeout=600)
        rings_agree("scaled down")
        retired = [w for w in lanes_seen
                   if w.node_id not in gw.worker_names()]
        check(len(retired) == 1 and retired[0] not in workers
              and len(workers) == 2
              and retired[0].generator._pool.caches is None,
              f"elastic: retired {[w.node_id for w in retired]}, serving "
              f"{[w.node_id for w in workers]}")
        for i, r in enumerate(burst):
            check(r.final is not None and "error" not in r.final
                  and r.tokens == control[f"b{i}"],
                  f"elastic burst b{i}: {r.final} {r.error}; equal "
                  f"{r.tokens == control[f'b{i}']}")
        for i, r in enumerate(trickle):
            check(r.final is not None and "error" not in r.final
                  and "resumed" not in r.final
                  and r.tokens == control[f"t{i}"],
                  f"elastic trickle t{i}: {r.final} {r.error}; equal "
                  f"{r.tokens == control[f't{i}']}")
        mig = gw.get_stats()["migration"]
        check(mig["streams_migrated"] >= 1
              and mig["migration_fallbacks"] == 0
              and gw.failover.get("tokens_replayed") == 0,
              f"elastic: migration {mig}; decisions "
              f"{[(d, a.get('worker'), a.get('reason')) for d, _t, a in fleet_decisions(gw)]}")
        for w in lanes_seen:
            st = w.generator.stats()
            kp = st["kv_pool"]
            check(st["active"] == 0 and kp["blocks_free"]
                  + kp["radix_nodes"] == kp["blocks_total"],
                  f"elastic: {w.node_id} leaked blocks: {kp}")
        mem_after = memory()
        check(abs(mem_after - mem_before) < pool_bytes,
              f"elastic: memory {mem_before} before the spawn, "
              f"{mem_after} after the retire, one lane's pool "
              f"{pool_bytes}")
        # What stays is cuBLAS's workspace of the retired decode thread's
        # handle, which the next thread to take the handle reuses: read
        # once more without any (every lane is idle).
        torch._C._cuda_clearCublasWorkspaces()
        mem_cleared = memory()
        # 3. Wedges: a dead address latches spawn-wedged while a control
        # stream completes (and the standby drill runs); clear answers
        # cleared.
        add = {}
        adder = threading.Thread(target=lambda: add.update(post(
            srv.port, "/admin/fleet",
            {"action": "add", "worker": DEAD_WORKER})))
        t_add = time.perf_counter()
        adder.start()
        toks, final, _ttft = stream(srv.port, dict(reqs["w0"],
                                                   request_id="w0"))
        out["standby"] = elastic_standby(model, workers[0].engine.params,
                                         reqs, control)
        adder.join(timeout=60)
        wedge_s = time.perf_counter() - t_add
        check(final is not None and "error" not in final
              and toks == control["w0"],
              f"elastic wedge control stream: {final}")
        check(add == {"ok": False, "status": "spawn-wedged",
                      "worker": DEAD_WORKER}, f"elastic add: {add}")
        status = post(srv.port, "/admin/fleet", {"action": "status"})
        fleet = get(srv.port, "/stats")["fleet"]
        check(status["state"] == "degraded:spawn-wedged"
              and fleet["degraded"] == {DEAD_WORKER: "spawn-wedged"},
              f"elastic: wedged status {status}")
        rings_agree("spawn-wedged")
        cleared = post(srv.port, "/admin/fleet",
                       {"action": "clear", "worker": DEAD_WORKER})
        check(cleared == {"ok": True, "status": "cleared"}
              and post(srv.port, "/admin/fleet", {})["state"] == "steady",
              f"elastic clear: {cleared}")
        # 4. The stall drill.
        out["stall"] = elastic_stall(gw, srv, reqs, control)
        rings_agree("after the stall drill")
        # Invariants: counters == spans, the /stats block, #1's count.
        fl = gw.fleet.as_dict()
        spans = [d for d, _ts, _a in fleet_decisions(gw)]
        for f in FleetCounters.SPAN_FIELDS:
            check(spans.count(f) == fl[f],
                  f"elastic: {f} {fl[f]} != {spans.count(f)} spans")
        stats_fleet = get(srv.port, "/stats")["fleet"]
        check({"lanes", "pressure", "degraded"} <= set(stats_fleet)
              and stats_fleet["lanes"] == 2,
              f"elastic /stats fleet: {stats_fleet}")
        ticks = {w.node_id: w.generator.stats()["mixed"]["ticks"]
                 for w in lanes_seen}
        ticks["standby"] = out["standby"]["ticks"]
        launches = check_counts("elastic", "ragged_paged_attention")
        check(launches == cfg.n_layers * sum(ticks.values()) > 0,
              f"elastic: #1 {launches} != {cfg.n_layers} x {ticks}")
        decisions = fleet_decisions(gw)
        walls = decision_walls_ms(decisions)
        up_done = next(ts for d, ts, _a in decisions
                       if d == "scale_up_completed")
        spawn = spawned["worker_3"]
        out.update(
            lanes=sorted(gw.worker_names()), retired=retired[0].node_id,
            minted="worker_3", launches=launches, ticks=ticks,
            layers=cfg.n_layers, rings=rings,
            spawn_build_ms=(spawn["built"] - spawn["start"]) * 1e3,
            spawn_to_probe_pass_ms=(up_done - spawn["start"]) * 1e3,
            decision_walls_ms=walls, burst_to_scale_up_s=up_s,
            burst_s=burst_s, scale_down_wait_s=down_s, wedge_s=wedge_s,
            memory={"before_spawn": mem_before, "three_lanes": mem_three,
                    "after_retire": mem_after,
                    "after_retire_no_cublas_workspaces": mem_cleared,
                    "lane_kv_pool": pool_bytes},
            migration=mig, fleet=stats_fleet,
            decisions=[d for d, _ts, _a in decisions])
    finally:
        stop_combined(gw, workers, srv)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    retire_ms = next((v for k, v in out["decision_walls_ms"].items()
                      if k.startswith("scale_down")), None)
    log(f"elastic ({cfg.n_layers} layers, f32, paged mixed lanes, C++ "
        f"front): 2 -> 3 -> 2 lanes; spawn to probe-pass "
        f"{out['spawn_to_probe_pass_ms']:.1f} ms (lane build "
        f"{out['spawn_build_ms']:.1f} ms), retire {out['retired']} to "
        f"drain-complete {retire_ms:.1f} ms, "
        f"{out['migration']['streams_migrated']} stream(s) migrated; "
        f"{len(control)} streams identical to the static fleet's [{card}]")
    log(f"elastic memory: {mem_before} B allocated before the spawn, "
        f"{mem_three} B with three lanes, {mem_after} B after the retire "
        f"(difference {mem_after - mem_before} B, one lane's KV pool "
        f"{pool_bytes} B; {mem_cleared} B with cuBLAS's workspaces "
        f"dropped) [{card}]")
    log(f"elastic decisions (ms): "
        f"{json.dumps({k: round(v, 3) for k, v in walls.items()})}; "
        f"stall drill: ejected in {out['stall']['eject_s']:.2f} s, "
        f"restored in {out['stall']['restore_s']:.2f} s "
        f"({out['stall']['prober_ejections']} ejection(s), attempt "
        f"{len(out['stall']['attempts'])} of {ELASTIC_STALL_ATTEMPTS}); "
        f"standby probe gate {out['standby']['probe_gate_ms']:.1f} ms; #1 "
        f"{launches} = {cfg.n_layers} x {sum(ticks.values())} ticks "
        f"{ticks}; phase {out['seconds']:.1f} s [{card}]")
    return out


# -- tensor-parallel serving ------------------------------------------------

# The tp phase's ranks: every rank on the one card (a process group of
# NCCL ranks cannot share a card; one scheduler driving its ranks can).
TP_DEVICE = "cuda:0"
# Greedy prompts of the tp lanes, each sent alone (one batch composition
# for every degree): lengths 24, 100 and 300 (two prefill chunks).
TP_PROMPT_LENS = (24, 100, 300)
TP_NEW = 8
# A bf16 tp 2 forward over int8 blocks against the tp 1 forward on the
# same inputs, as max|diff| / max|tp 1|: the ranks' row-parallel partials
# sum in another order than one product's, so the residual stream's bf16
# rounding at each block end may differ by an ulp (2^-8), and 22 layers
# of random weights carry it to the logits.
TP_BF16_LOGIT_TOL = 5e-2
TP_KERNELS = {"ragged_paged_attention": (False, False),
              "paged_attention": (True, False),
              "quant_paged_attention": (True, True),
              "quant_ragged_paged_attention": (False, True)}


def tp_rank_inputs(inp, n: int, r: int):
    """Rank r's share of ``main_path_inputs`` at degree n: its H/n query
    heads and H_kv/n KV heads (payload and int8 scales), contiguous."""
    q, pools, rows = inp[0], inp[1:-3], inp[-3:]
    h, hk = q.shape[2] // n, pools[0].shape[2] // n
    return (q[:, :, r * h:(r + 1) * h].contiguous(),
            *[p[:, :, r * hk:(r + 1) * hk].contiguous() for p in pools],
            *rows)


def tp_kernel_readings(torch, pa) -> dict:
    """#1-#4 at the ranks' shapes of tp 2 and 4 (TinyLlama: 16/2 and 8/1
    query/KV heads a rank, G 8, D 64): each rank's output against the
    plain version (bf16 2e-2, int8 2e-4, as at tp 1), and rank 0's device
    time, plain time, bound and SDPA's device time."""
    dev = torch.device(TP_DEVICE)
    out = {}
    for kernel, (decode_only, int8) in TP_KERNELS.items():
        inp = main_path_inputs(torch, dev, decode_only, int8)
        fn, ref = getattr(pa, kernel), getattr(pa, kernel + "_reference")
        tol = QUANT_TOL if int8 else BF16_TOL
        ragged = "ragged" in kernel
        for n in (2, 4):
            err = 0.0
            for r in range(n):
                t = tp_rank_inputs(inp, n, r)
                args = t if ragged else decode_args(t)
                got, want = fn(*args), ref(*args)
                check(bool(torch.isfinite(got.float()).all()),
                      f"tp {kernel} at tp {n} rank {r}: non-finite")
                err = max(err, _valid_err(torch, got, want, t[-1]) if ragged
                          else float((got.float() - want.float()).abs()
                                     .max()))
            check(err <= tol, f"tp {kernel} at tp {n}: {err} > {tol}")
            t = tp_rank_inputs(inp, n, 0)
            args = t if ragged else decode_args(t)
            device, seen = device_call_ms(torch, lambda: fn(*args),
                                          iters=10)
            plain = time_ms(torch, lambda: ref(*args), iters=3)
            library, _ = device_call_ms(torch, sdpa_yardstick(torch, t,
                                                              int8),
                                        iters=10)
            bound, by = bound_ms(t[0], t[1], t[-3], t[-2], t[-1],
                                 4 if int8 else t[1].element_size(),
                                 scale_bytes=4 if int8 else 0)
            key = f"tp {n} rank shape H {t[0].shape[2]}/{t[1].shape[2]}"
            out.setdefault(kernel, {})[key] = {
                "max_abs_err": err, "device_ms": device,
                "device_calls": seen, "plain_ms": plain,
                "library_device_ms": library, "bound_ms": bound,
                "bound_by": by}
            log(f"tp {kernel} ({shape_key(decode_only)}, {key}, "
                f"{'int8' if int8 else 'bf16'} pool): max_abs_err over "
                f"{n} ranks {err:.3e} (tol {tol:g}); rank 0 device "
                f"{device:.4f} ms ({seen} of 10 seen), plain {plain:.4f} "
                f"ms, sdpa device {library:.4f} ms, bound {bound:.5f} ms "
                f"({by})")
    return out


def tp_params(spec, params, n: int):
    """``params`` sharded over n ranks on the card (n 1: as it is)."""
    from tpu_engine_torch.models.registry import tp_rank_trees
    from tpu_engine_torch.models.transformer import TPParams
    from tpu_engine_torch.parallel.mesh import TPGroup

    if n == 1:
        return params
    group = TPGroup([TP_DEVICE] * n)
    return TPParams(tp_rank_trees(spec, params, group.devices), group)


def tp_pool(torch, cfg, n: int, dtype, nb: int = 8 * 128 + 1,
            src=None):
    """A (L, nb, 16, H_kv, D) K/V pair (or ``src``'s copy), as n
    contiguous head shards for n > 1."""
    from tpu_engine_torch.models.transformer import KVCache

    shape = (cfg.n_layers, nb, 16, cfg.kv_heads, cfg.d_head)
    whole = src or KVCache(*(torch.zeros(shape, dtype=dtype,
                                         device=TP_DEVICE)
                             for _ in range(2)))
    if n == 1:
        return KVCache(*(t.clone() for t in whole))
    return KVCache(*([c.contiguous() for c in t.chunk(n, dim=3)]
                     for t in whole))


def tp_tick_readings(torch, spec, params16) -> dict:
    """The bf16 mixed tick (seven decode rows beside a 249-token chunk,
    width 256) and decode tick (eight rows, width 1) at full TinyLlama
    depth, at tp 1, 2 and 4: the forward's wall (CUDA events around it),
    host issue and device busy, and each rank's memory."""
    from tpu_engine_torch.models.transformer import (
        transformer_step_rows_ragged,
    )

    cfg = spec.config
    dev = torch.device(TP_DEVICE)
    _, _, _, tables, pos0, qlen = main_path_inputs(torch, dev, False)
    qlen[7] = 249
    tokens = torch.randint(0, cfg.vocab, (8, 256), device=dev,
                           dtype=torch.int32)
    out = {}
    for n in TP_DEGREES:
        prm = tp_params(spec, params16, n)
        caches = tp_pool(torch, cfg, n, torch.bfloat16)
        for shape, w in (("mixed W=256", 256), ("decode W=1", 1)):
            ql = qlen.clone() if w > 1 else torch.ones_like(qlen)
            slot = (ql - 1).clamp(min=0)

            def fwd(ql=ql, slot=slot, w=w):
                return transformer_step_rows_ragged(
                    prm, tokens[:, :w].contiguous(), caches, tables, pos0,
                    ql, cfg, dtype=torch.bfloat16, sample_slot=slot)[0]

            check(bool(torch.isfinite(fwd()).all()),
                  f"tp {n} {shape}: non-finite logits")
            ms = time_ms(torch, fwd, iters=3)
            busy = busy_ms(torch, fwd, iters=2)
            r = {"forward_ms": ms, "issue_ms": issue_ms(torch, fwd, 3),
                 "busy_ms": busy, "idle_share": idle_share(busy, ms)}
            out[f"tp {n} {shape}"] = r
            log(f"tp tick ({shape}, bf16, {cfg.n_layers} layers, tp {n} on "
                f"one card): "
                f"{ms:.3f} ms (host issue {r['issue_ms']:.3f} ms, "
                f"{busy_text(busy, r['idle_share'])})")
        ranks = prm.ranks if n > 1 else [prm]
        k = caches.k if n > 1 else [caches.k]
        out[f"tp {n} memory"] = {
            "param_bytes_per_rank": [sum(x.numel() * x.element_size()
                                         for x in leaves(t)) for t in ranks],
            "kv_bytes_per_rank": [2 * s.numel() * s.element_size()
                                  for s in k]}
        log(f"tp {n} memory per rank (bf16): params "
            f"{out[f'tp {n} memory']['param_bytes_per_rank']} B, K/V pool "
            f"of {k[0].shape[1]} blocks "
            f"{out[f'tp {n} memory']['kv_bytes_per_rank']} B")
        del prm, caches
    return out


def tp_int8_logits(torch, spec, params16) -> dict:
    """A bf16 tp 2 forward over int8 blocks against tp 1 on the same
    inputs (the pool is main_path_inputs' quantized K/V in every layer):
    the mixed tick (#4) and the two-path decode step (#3)."""
    from tpu_engine_torch.models.transformer import (
        KVCache,
        transformer_decode_rows_paged,
        transformer_step_rows_ragged,
    )

    cfg = spec.config
    dev = torch.device(TP_DEVICE)
    out = {}
    for decode_only in (False, True):
        q, k, v, ks, vs, tables, pos0, qlen = main_path_inputs(
            torch, dev, decode_only, int8=True)
        layers = (lambda t: t[None].expand(cfg.n_layers, *t.shape)
                  .contiguous())
        pool, scales = (KVCache(layers(k), layers(v)),
                        KVCache(layers(ks), layers(vs)))
        tokens = torch.randint(0, cfg.vocab, (8, q.shape[1]), device=dev,
                               dtype=torch.int32, generator=torch.Generator(
                                   device=dev).manual_seed(5))
        logits = []
        for n in (1, 2):
            prm = tp_params(spec, params16, n)
            c, s = tp_pool(torch, cfg, n, None, src=pool), tp_pool(
                torch, cfg, n, None, src=scales)
            if decode_only:
                logits.append(transformer_decode_rows_paged(
                    prm, tokens[:, 0], c, tables, pos0, cfg,
                    dtype=torch.bfloat16, scales=s)[0])
            else:
                logits.append(transformer_step_rows_ragged(
                    prm, tokens, c, tables, pos0, qlen, cfg,
                    dtype=torch.bfloat16, sample_slot=(qlen - 1),
                    scales=s)[0])
        err = float((logits[1] - logits[0]).abs().max()
                    / logits[0].abs().max())
        key = "decode W=1 (#3)" if decode_only else "mixed W=256 (#4)"
        check(err <= TP_BF16_LOGIT_TOL,
              f"tp 2 bf16 int8 logits {key}: {err} > {TP_BF16_LOGIT_TOL}")
        out[key] = {"rel_err": err,
                    "argmax_equal": float((logits[1].argmax(-1)
                                           == logits[0].argmax(-1))
                                          .float().mean())}
        log(f"tp 2 bf16 logits over int8 blocks against tp 1 ({key}): "
            f"max|diff| / max|tp 1| {err:.3e} (bound "
            f"{TP_BF16_LOGIT_TOL:g}); argmax equal in "
            f"{out[key]['argmax_equal']:.3f} of rows")
    return out


def tp_generator(spec, params, n: int, dtype: str, **kw):
    from tpu_engine_torch.runtime.scheduler import ContinuousGenerator

    kw = dict(dict(kv_block_size=16, kv_blocks=8 * 40 + 1, n_slots=8,
                   prefill_chunk=256), **kw)
    if n > 1:
        kw["tp_devices"] = [TP_DEVICE] * n
    else:
        kw["device"] = TP_DEVICE
    return ContinuousGenerator(spec, params=params, dtype=dtype, tp=n, **kw)


def tp_lane_run(torch, gen, name: str, n: int, prompts, kernel: str,
                steps_per_tick: int = 1, new: int = TP_NEW) -> dict:
    """Each prompt alone through ``gen`` with the launch counts reset
    before and read after: #kernel == n x 22 x the lane's forward steps
    (mixed ticks, or two-path chunks x step_chunk), no other kernel, no
    plain call, no block leaked."""
    from tpu_engine_torch.ops import kernels as kl

    torch.cuda.synchronize()
    kl.reset_counts()
    t0 = time.perf_counter()
    toks = [gen.generate([p], max_new_tokens=new)[0] for p in prompts]
    wall = time.perf_counter() - t0
    launches = check_counts(f"tp {name}", kernel)
    st = gen.stats()
    steps = (st["mixed"]["ticks"] if "mixed" in st
             else st["chunks"] * steps_per_tick)
    layers = gen.cfg.n_layers
    check(launches == n * layers * steps,
          f"tp {name}: {kernel} launched {launches} times, not {n} x "
          f"{layers} x {steps} steps")
    pool = st["kv_pool"]
    check(pool["blocks_free"] + pool["radix_nodes"] == pool["blocks_total"],
          f"tp {name}: blocks leaked: {pool}")
    check(st.get("tp", {}).get("tp", 1) == n and pool.get("tp", 1) == n,
          f"tp {name}: stats carry tp {st.get('tp')}, pool {pool.get('tp')}")
    ntok = sum(len(t) for t in toks)
    log(f"tp {name}: {len(prompts)} prompts alone, {ntok} tokens in "
        f"{wall:.2f} s ({wall / steps * 1e3:.1f} ms a step over {steps} "
        f"steps); {kernel} {launches} = {n} x {layers} x {steps}; no "
        f"block leaked")
    return {"tokens": toks, "kernel": kernel, "launches": launches,
            "steps": steps, "wall_s": wall,
            "ms_per_step": wall / steps * 1e3}


def tp_migration(gen_src, gen_dst, gen_one, prompt) -> dict:
    """A live row of a tp 2 lane, parked after its prefill, exported and
    spliced onto another tp 2 lane (its tokens the destination's own
    uninterrupted run of the prompt, sent alone first, nothing prefilled
    for the import), and the same snapshot refused by a tp 1 lane by
    name."""
    from tpu_engine_torch.runtime.scheduler import ImportRefused

    control = gen_dst.generate([prompt], max_new_tokens=TP_NEW)[0]
    q = queue.Queue()
    gen_src.submit(prompt, max_new_tokens=TP_NEW, stream=q, tag="tp-mig",
                   handoff=True, handoff_park_s=60.0)
    t0 = time.perf_counter()
    snap = gen_src.export_row("tp-mig", timeout_s=60, wait_prefill=True)
    export_s = time.perf_counter() - t0
    check(snap.get("ok") and snap["chain"].get("tp") == 2,
          f"tp migration export: {str(snap)[:300]}")
    body = {k: v for k, v in snap.items() if k != "ok"}
    before = gen_dst.stats()["kv_pool"]["prefilled_tokens"]
    got = gen_dst.submit_import(body).result(300)
    check(got == control, f"tp migration: {got} != {control}")
    check(gen_dst.stats()["kv_pool"]["prefilled_tokens"] == before,
          "tp migration: the destination prefilled tokens")
    refused = ""
    try:
        gen_one.submit_import(body).result(300)
    except ImportRefused as exc:
        refused = str(exc)
    check("shard geometry" in refused,
          f"tp migration: the tp 1 lane did not refuse by name: {refused!r}")
    log(f"tp migration: a parked tp 2 row ({len(snap['chain']['blocks'])} "
        f"blocks, export {export_s * 1e3:.1f} ms) spliced onto a tp 2 lane "
        f"equal to the uninterrupted run, 0 tokens prefilled there; the tp "
        f"1 lane refused: {refused[:90]}")
    return {"export_ms": export_s * 1e3,
            "blocks": len(snap["chain"]["blocks"]), "refused": refused}


def tp_http(torch, spec, params32, prompt, control) -> dict:
    """A WorkerNode(tp=2, device=cuda:0) behind its HTTP server streams
    /generate/stream (the in-process tp 2 lane's tokens) and carries the
    topology label in /health; a gateway over it and an in-process tp 1
    lane weights their vnodes 2 and 1 once its prober has read the
    label."""
    from tpu_engine_torch.ops import kernels as kl
    from tpu_engine_torch.serving.app import serve_worker
    from tpu_engine_torch.serving.gateway import Gateway
    from tpu_engine_torch.serving.worker import WorkerNode
    from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig

    lane = dict(model="llama", dtype="float32", device=TP_DEVICE,
                gen_max_batch_size=8, gen_kv_block_size=16,
                gen_kv_blocks=8 * 40 + 1,
                gen_mixed_step=True, gen_mixed_token_budget=256,
                gen_prefill_chunk=256)
    worker, server = serve_worker(WorkerConfig(port=0, node_id="tp2-http",
                                               tp=2, **lane),
                                  params=params32)
    one = WorkerNode(WorkerConfig(node_id="tp1-local", **lane),
                     params=params32)
    gw = None
    try:
        kl.reset_counts()
        toks, final, ttft = stream(server.port, {
            "request_id": "tp-stream", "prompt_tokens": prompt,
            "max_new_tokens": TP_NEW})
        ticks = worker.generator.stats()["mixed"]["ticks"]
        launches = check_counts("tp http", "ragged_paged_attention")
        check(toks == control and final and final.get("tokens") == toks,
              f"tp http stream: {toks} != {control} ({final})")
        check(launches == 2 * spec.config.n_layers * ticks,
              f"tp http: #1 {launches} != 2 x layers x {ticks}")
        health = get(server.port, "/health")
        check(health.get("topology") == {"tp": 2, "mesh_shape": {"model": 2},
                                         "devices": 2},
              f"tp http /health topology: {health.get('topology')}")
        url = f"127.0.0.1:{server.port}"
        gw = Gateway([url, one], GatewayConfig(health_probe_interval_s=0.1))
        deadline = time.monotonic() + 30
        while "topology" not in gw.get_stats():
            check(time.monotonic() < deadline,
                  "tp http: the gateway's prober read no topology label")
            time.sleep(0.05)
        weights = gw.get_stats()["topology"]["ring_weights"]
        check(weights == {url: 2, "tp1-local": 1},
              f"tp http ring weights: {weights}")
        log(f"tp http: a tp 2 WorkerNode on {TP_DEVICE} streamed "
            f"{len(toks)} tokens over /generate/stream (TTFT "
            f"{ttft * 1e3:.1f} ms) equal to the in-process tp 2 lane; #1 "
            f"{launches} = 2 x {spec.config.n_layers} x {ticks} ticks; "
            f"/health topology "
            f"{health['topology']}; gateway ring_weights {weights}")
        return {"tokens": len(toks), "ttft_ms": ttft * 1e3,
                "launches": launches, "ticks": ticks,
                "topology": health["topology"], "ring_weights": weights}
    finally:
        if gw is not None:
            gw.stop()
        server.stop()
        worker.stop()
        one.stop()


def phase_tp(torch, card: str, pa) -> dict:
    """Tensor-parallel serving (see the module docstring's tp entry)."""
    from tpu_engine_torch.models.convert import init_params
    from tpu_engine_torch.models.registry import create_model

    spec = create_model("llama")
    cfg = spec.config
    walls = {}
    lap = lap_timer(walls)
    res = {"card": card, "walls_s": walls,
           "kernels": tp_kernel_readings(torch, pa)}
    lap("kernels")
    rng = np.random.default_rng(22)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, n)]
               for n in TP_PROMPT_LENS]
    params16 = init_params(cfg, 0, device=TP_DEVICE, dtype="bfloat16")
    res["ticks"] = tp_tick_readings(torch, spec, params16)
    lap("ticks")
    res["int8_logits"] = tp_int8_logits(torch, spec, params16)
    # The bf16 lanes over int8 blocks: #4 (mixed) and #3 (two-path).
    for name, kw, kernel, per in (
            ("mixed int8 bf16 tp 2", dict(mixed_step=True,
                                         mixed_token_budget=256),
             "quant_ragged_paged_attention", 1),
            ("two-path int8 bf16 tp 2", dict(step_chunk=TP_NEW),
             "quant_paged_attention", TP_NEW)):
        gen = tp_generator(spec, params16, 2, "bfloat16", kv_quantize="int8",
                           **kw)
        try:
            run = tp_lane_run(torch, gen, name, 2, prompts[1:2], kernel, per)
        finally:
            gen.stop()
        res[name] = {k: v for k, v in run.items() if k != "tokens"}
    del params16
    lap("int8")
    params32 = init_params(cfg, 0, device=TP_DEVICE, dtype="float32")
    mixed = dict(mixed_step=True, mixed_token_budget=256)
    gens = {}
    try:
        for name, n, kw, kernel, per in (
                ("mixed f32 tp 1", 1, mixed, "ragged_paged_attention", 1),
                ("mixed f32 tp 2", 2, mixed, "ragged_paged_attention", 1),
                ("mixed f32 tp 4", 4, mixed, "ragged_paged_attention", 1),
                ("two-path f32 tp 1", 1, dict(step_chunk=TP_NEW),
                 "paged_attention", TP_NEW),
                ("two-path f32 tp 2", 2, dict(step_chunk=TP_NEW),
                 "paged_attention", TP_NEW)):
            gens[name] = tp_generator(spec, params32, n, "float32", **kw)
            res[name] = tp_lane_run(torch, gens[name], name, n, prompts,
                                    kernel, per)
        base = res["mixed f32 tp 1"]["tokens"]
        for name in ("mixed f32 tp 2", "mixed f32 tp 4"):
            check(res[name]["tokens"] == base,
                  f"tp {name}: streams differ from tp 1: "
                  f"{res[name]['tokens']} != {base}")
        check(res["two-path f32 tp 2"]["tokens"]
              == res["two-path f32 tp 1"]["tokens"],
              "tp two-path f32 tp 2: streams differ from tp 1")
        log(f"tp: f32 greedy streams at tp 2 and 4 (mixed) and tp 2 "
            f"(two-path) token-identical to tp 1 ({len(prompts)} prompts "
            f"x {TP_NEW} tokens, each alone); two-path equal to mixed: "
            f"{res['two-path f32 tp 1']['tokens'] == base}")
        lap("lanes")
        gens["dst"] = tp_generator(spec, params32, 2, "float32", **mixed)
        res["migration"] = tp_migration(
            gens["mixed f32 tp 2"], gens["dst"], gens["mixed f32 tp 1"],
            prompts[1][::-1])
        for name, gen in gens.items():
            pool = gen.stats()["kv_pool"]
            check(pool["blocks_free"] + pool["radix_nodes"]
                  == pool["blocks_total"], f"tp {name}: blocks leaked")
    finally:
        for gen in gens.values():
            gen.stop()
    lap("migration")
    res["http"] = tp_http(torch, spec, params32, prompts[0],
                          res["mixed f32 tp 2"]["tokens"][0])
    lap("http")
    log(f"tp phase walls (s): "
        f"{json.dumps({k: round(v, 1) for k, v in walls.items()})}")
    for name in list(res):
        if isinstance(res[name], dict) and "tokens" in res[name]:
            res[name] = {k: v for k, v in res[name].items()
                         if k != "tokens"}
    return res


# -- mesh-sharded serving and training ----------------------------------------

# Every mesh rank on the one card, as the tp phase's.
MESH_DEVICE = "cuda:0"
# The resnet50 mesh lanes: (mesh, dtype, tolerance) against the single-rank
# engine on the same weights, as max|mesh - single| / max|single|. f32
# (TF32 off): the same convolutions on 2 rows a rank instead of 8 in one
# batch, summed by other cuDNN algorithms, 1e-4. bf16: INFER_BF16_TOL, the
# served lanes' bound (a sum that differs in its last f32 bit can round a
# conv's bf16 input the other way).
MESH_INFER = (("data=2", "bfloat16", INFER_BF16_TOL),
              ("model=2,data=2", "float32", 1e-4),
              ("model=2,data=2", "bfloat16", INFER_BF16_TOL))
MESH_IMAGES = 8
MESH_DECODER_ROWS = 8
MESH_DECODER_TOL = 1e-4
MESH_TRAIN = ("--batch", "4", "--seq", "256", "--steps", "3",
              "--log-every", "1")
MESH_TRAIN_TOL = 1e-4


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def rank_bytes(placed) -> list:
    """The parameter bytes each mesh rank holds (its distinct tensors)."""
    return [sum(t.numel() * t.element_size()
                for t in {id(t): t for t in ts}.values())
            for ts in placed.ranks]


def mesh_resnet_lane(torch, mesh: str, dtype: str, tol: float) -> dict:
    """resnet50 under ``serve --mesh <mesh> --device cuda:0`` (the serve
    command's arguments, its combined server in this process, the C++
    front): the one lane's engine spans the mesh; concurrent images
    against the single-rank engine on the lane's weights; a repeat is a
    cache hit answered in C++; /health."""
    from tpu_engine_torch.runtime.engine import InferenceEngine
    from tpu_engine_torch.serving import cli
    from tpu_engine_torch.serving.app import serve_combined, stop_combined

    kw = cli.serve_args(["--model", "resnet50", "--mesh", mesh, "--device",
                         MESH_DEVICE, "--dtype", dtype, "--port", "0"])
    t0 = time.perf_counter()
    gw, workers, server = serve_combined(**kw)
    ready = time.perf_counter() - t0
    try:
        check([w.node_id for w in workers] == ["worker_1"],
              f"mesh {mesh}: lanes {[w.node_id for w in workers]}")
        eng = workers[0].engine
        n = 1
        for v in eng.stats()["mesh"]["axes"].values():
            n *= v
        check(eng.stats()["mesh"]["n_devices"] == n,
              f"mesh {mesh}: stats {eng.stats()['mesh']}")
        rng = np.random.default_rng(24)
        images = [np.round(rng.random(224 * 224 * 3, np.float32), 3)
                  for _ in range(MESH_IMAGES)]
        bodies = {f"m{i}": json.dumps({
            "request_id": f"mesh-{mesh}-{dtype}-{i}",
            "input_data": images[i].tolist()}).encode()
            for i in range(MESH_IMAGES)}
        answers, wall = concurrent_posts(server.port, "/infer", bodies)
        for name, a in answers.items():
            check(set(a) == {"request_id", "output_data", "node_id",
                             "cached", "inference_time_us"}
                  and a["node_id"] == "worker_1",
                  f"mesh {mesh}: /infer answer {sorted(a)}")
        got = np.stack([np.asarray(answers[f"m{i}"]["output_data"],
                                   np.float32) for i in range(MESH_IMAGES)])
        single = InferenceEngine(eng.spec, params=eng.params, dtype=dtype,
                                 batch_buckets=(MESH_IMAGES,),
                                 device=MESH_DEVICE)
        want = np.stack(single.batch_predict(images))
        err = float(np.abs(got - want).max() / np.abs(want).max())
        check(np.isfinite(got).all() and got.shape == want.shape,
              f"mesh {mesh} {dtype}: answers {got.shape}")
        check(err <= tol, f"mesh {mesh} {dtype}: {err} > {tol}")
        again = post(server.port, "/infer", bodies["m0"].replace(
            b'-0"', b'-again"'))
        check(again["cached"] is True
              and again["output_data"] == answers["m0"]["output_data"],
              f"mesh {mesh}: the repeat was not a cache hit")
        health, stats = get(server.port, "/health"), get(server.port,
                                                         "/stats")
        cxx_hits = health["total_requests"] - stats["total_requests"]
        check(health["healthy"] is True
              and health["total_requests"] == MESH_IMAGES + 1
              and cxx_hits == 1,
              f"mesh {mesh}: /health {health['total_requests']}, /stats "
              f"{stats['total_requests']}")
        resident = rank_bytes(eng._placed)
        log(f"mesh serve resnet50 {dtype} `--mesh {mesh} --device "
            f"{MESH_DEVICE}`: ready in {ready:.1f} s; {MESH_IMAGES} "
            f"concurrent /infer in {wall:.3f} s from worker_1, max|mesh - "
            f"single| / max|single| {err:.3e} (tol {tol}); the repeat "
            f"answered in C++ ({cxx_hits} hit); /health healthy; stats "
            f"mesh {eng.stats()['mesh']}; param bytes held by each rank "
            f"{resident} (the whole tree {tree_bytes(eng.params)})")
        return {"ready_s": ready, "burst_s": wall, "max_rel_err": err,
                "cxx_hits": cxx_hits, "mesh": eng.stats()["mesh"],
                "rank_param_bytes": resident,
                "whole_param_bytes": tree_bytes(eng.params)}
    finally:
        stop_combined(gw, workers, server)


def mesh_decoder_lane(torch) -> dict:
    """TinyLlama width at cut depth (f32) under ``serve --mesh
    model=2,data=2``: concurrent /infer rows of token ids against the
    single-rank engine, #5 == layers x data ranks x the engine's
    dispatches and no other kernel."""
    from tpu_engine_torch.ops import kernels as kl
    from tpu_engine_torch.runtime.engine import InferenceEngine
    from tpu_engine_torch.serving import cli
    from tpu_engine_torch.serving.app import serve_combined, stop_combined

    model = cut_llama()
    kw = cli.serve_args(["--model", model, "--mesh", "model=2,data=2",
                         "--device", MESH_DEVICE, "--dtype", "float32",
                         "--port", "0"])
    gw, workers, server = serve_combined(**kw)
    try:
        eng = workers[0].engine
        layers, vocab = eng.spec.config.n_layers, eng.spec.config.vocab
        rng = np.random.default_rng(25)
        rows = [rng.integers(1, vocab, int(n)).astype(np.float32)
                for n in rng.integers(32, 129, MESH_DECODER_ROWS)]
        dispatched = eng.stats()["execute_count"]
        kl.reset_counts()
        answers, wall = concurrent_posts(server.port, "/infer", {
            f"r{i}": {"request_id": f"mesh-llama-{i}",
                      "input_data": r.tolist()}
            for i, r in enumerate(rows)})
        launches = check_counts("mesh decoder", "flash_attention")
        dispatches = eng.stats()["execute_count"] - dispatched
        check(dispatches > 0 and launches == layers * 2 * dispatches,
              f"mesh decoder: #5 {launches} != {layers} x 2 x "
              f"{dispatches}")
        got = np.stack([np.asarray(answers[f"r{i}"]["output_data"],
                                   np.float32) for i in range(len(rows))])
        single = InferenceEngine(eng.spec, params=eng.params,
                                 dtype="float32",
                                 batch_buckets=(MESH_DECODER_ROWS,),
                                 device=MESH_DEVICE)
        want = np.stack(single.batch_predict(rows))
        err = float(np.abs(got - want).max() / np.abs(want).max())
        check(np.isfinite(got).all() and err <= MESH_DECODER_TOL,
              f"mesh decoder: {err} > {MESH_DECODER_TOL}")
        log(f"mesh serve {model} (TinyLlama width, {layers} layers, f32) "
            f"`--mesh model=2,data=2`: {len(rows)} concurrent /infer rows "
            f"in {wall:.3f} s, {dispatches} dispatch(es); #5 {launches} = "
            f"{layers} x 2 x {dispatches}; max|mesh - single| / "
            f"max|single| {err:.3e} (tol {MESH_DECODER_TOL})")
        return {"launches": launches, "dispatches": dispatches,
                "max_rel_err": err, "burst_s": wall}
    finally:
        stop_combined(gw, workers, server)


def mesh_train(torch) -> dict:
    """``train --mesh data=2,model=2 --device cuda:0`` at TinyLlama width
    and cut depth against the unsharded train command on the card (same
    seed, same batch), each with the launch counts reset before and read
    after; then --out and --resume of a mesh run on llama-small-test."""
    import gc
    import tempfile

    from tpu_engine_torch.ops import kernels as kl

    model = cut_llama()
    common = ["--model", model, *MESH_TRAIN, "--device", MESH_DEVICE]
    steps = int(MESH_TRAIN[MESH_TRAIN.index("--steps") + 1])
    runs = {}
    for name, extra, ranks in (("mesh", ["--mesh", "data=2,model=2"], 2),
                               ("unsharded", [], 1)):
        kl.reset_counts()
        gc.collect()  # earlier lanes' tensors must not leave within
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        text = run_train([*common, *extra])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        counts = launch_counts()
        check(all(p == 0 for _, p in counts.values()),
              f"mesh train {name}: plain versions ran: {counts}")
        bwd = ("flash_attention", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")
        launches = {k: counts[k][0] for k in bwd}
        check(all(v == CUT_LAYERS * ranks * steps
                  for v in launches.values()),
              f"mesh train {name}: launches {launches} != {CUT_LAYERS} x "
              f"{ranks} x {steps}")
        losses = [float(ln.split()[-1]) for ln in text.splitlines()
                  if ln.startswith("step ")]
        check(len(losses) == steps and np.isfinite(losses).all(),
              f"mesh train {name}: losses {losses}")
        runs[name] = {"losses": losses, "launches": launches, "wall_s": wall,
                      "peak_bytes": peak}
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        runs["mesh"]["losses"], runs["unsharded"]["losses"]))
    check(rel <= MESH_TRAIN_TOL,
          f"mesh train: losses {runs['mesh']['losses']} vs unsharded "
          f"{runs['unsharded']['losses']}")
    shape = (f"B {MESH_TRAIN[MESH_TRAIN.index('--batch') + 1]} x S "
             f"{MESH_TRAIN[MESH_TRAIN.index('--seq') + 1]}")
    log(f"mesh train {model} (TinyLlama width, {CUT_LAYERS} layers, f32, "
        f"{shape}) `--mesh data=2,model=2`: losses "
        f"{runs['mesh']['losses']} against the unsharded command's "
        f"{runs['unsharded']['losses']} (max rel {rel:.2e}, tol "
        f"{MESH_TRAIN_TOL}); #5/#6/#7 {runs['mesh']['launches']} == "
        f"{CUT_LAYERS} x 2 x {steps} (unsharded "
        f"{runs['unsharded']['launches']}); walls "
        f"{runs['mesh']['wall_s']:.1f} / {runs['unsharded']['wall_s']:.1f}"
        f" s; peak allocated above the start "
        f"{runs['mesh']['peak_bytes'] / 2**30:.2f} / "
        f"{runs['unsharded']['peak_bytes'] / 2**30:.2f} GiB")
    small = ["--model", "llama-small-test", "--batch", "4", "--seq", "64",
             "--log-every", "1", "--device", MESH_DEVICE]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        run_train([*small, "--steps", "3", "--mesh", "data=2,model=2",
                   "--out", f"{tmp}/ck"])
        text = run_train([*small, "--steps", "2", "--mesh",
                          "data=2,model=2", "--resume", f"{tmp}/ck/state"])
        plain = run_train([*small, "--steps", "5"])
    check("resumed at step 3" in text and "step 5:" in text,
          f"mesh train: --resume did not continue the step count: {text}")
    resumed = [float(ln.split()[-1]) for ln in text.splitlines()
               if ln.startswith("step ")]
    whole = [float(ln.split()[-1]) for ln in plain.splitlines()
             if ln.startswith("step ")][3:]
    rrel = max(abs(a - b) / abs(b) for a, b in zip(resumed, whole))
    check(rrel <= MESH_TRAIN_TOL,
          f"mesh train: the resumed run {resumed} left the unsharded "
          f"run's {whole}")
    log(f"mesh train --out/--resume (llama-small-test, data=2,model=2): "
        f"resumed at step 3, steps 4-5 losses {resumed} == the unsharded "
        f"run's {whole} (max rel {rrel:.2e})")
    return {**runs, "max_rel_loss_diff": rel, "steps": steps,
            "resumed_losses": resumed, "resumed_max_rel": rrel}


def mesh_kernel_readings(torch) -> dict:
    """#5, #6 and #7 at a data rank's shape of the mesh train run (B 2 x
    S 256, H 32, D 64, causal, f32) against their plain versions (#5: out
    and lse within F32_TOL; #6, #7: within BWD_F32_TOL of the gradient's
    largest magnitude), then their device, plain, library and bound times
    (``flash_numbers``, ``flash_bwd_numbers``)."""
    from tpu_engine_torch.ops import flash as fl

    b = int(MESH_TRAIN[MESH_TRAIN.index("--batch") + 1]) // 2
    s = int(MESH_TRAIN[MESH_TRAIN.index("--seq") + 1])
    rng = np.random.default_rng(26)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, s, 32, 64), np.float32)).to(MESH_DEVICE) for _ in range(4))
    out, lse = fl.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = fl.flash_attention_reference(q, k, v, causal=True)
    errs = {"flash_attention": flash_err(torch, out, lse, ref, ref_lse)}
    a = (q, k, v, None, lse, fl.bwd_delta(do, out), do)
    for kernel in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        got = getattr(fl, kernel)(*a, causal=True)
        want = getattr(fl, kernel + "_reference")(*a, causal=True)
        got, want = ((got,), (want,)) if torch.is_tensor(got) else (
            got, want)
        errs[kernel] = max(float((g - w).abs().max() / w.abs().max())
                           for g, w in zip(got, want))
    for kernel, err in errs.items():
        tol = F32_TOL if kernel == "flash_attention" else BWD_F32_TOL
        check(err <= tol, f"mesh {kernel} at the rank shape: {err} > {tol}")
    log(f"mesh kernels at a data rank's train shape (B {b} x S {s}, H 32, "
        f"f32): max err against the plain versions {errs}")
    res = {"flash_attention": flash_numbers(torch, b, s, torch.float32),
           **flash_bwd_numbers(torch, b, s, torch.float32)}
    for kernel, err in errs.items():
        res[kernel]["max_abs_err"] = err
        res[kernel]["shape"] = f"B {b} x S {s} x H 32, f32"
    return res


def phase_mesh(torch, card: str) -> dict:
    """Mesh-sharded serving and training (see the module docstring's mesh
    entry)."""
    import gc

    from tpu_engine_torch.serving.app import parse_mesh_spec

    walls = {}
    lap = lap_timer(walls)
    res = {"card": card, "walls_s": walls}
    if torch.cuda.device_count() == 1:
        try:
            parse_mesh_spec("data=2")
        except ValueError as exc:
            res["refused"] = str(exc)
        check(res.get("refused") == "mesh shape (2,) needs 2 devices, have 1",
              f"mesh: data=2 on one card without --device: "
              f"{res.get('refused')!r}")
        log(f"mesh: `--mesh data=2` without --device on one card refuses: "
            f"{res['refused']}")
    for mesh, dtype, tol in MESH_INFER:
        if dtype == "bfloat16":
            with served_conv_precision(torch):
                res[f"resnet50 {mesh} {dtype}"] = mesh_resnet_lane(
                    torch, mesh, dtype, tol)
        else:
            res[f"resnet50 {mesh} {dtype}"] = mesh_resnet_lane(
                torch, mesh, dtype, tol)
    lap("resnet50")
    res["decoder"] = mesh_decoder_lane(torch)
    lap("decoder")
    res["train"] = mesh_train(torch)
    lap("train")
    res["kernels"] = mesh_kernel_readings(torch)
    lap("kernels")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"mesh phase walls (s): "
        f"{json.dumps({k: round(v, 1) for k, v in walls.items()})} "
        f"[{card}]")
    return res


# -- sequence parallelism, GPipe and expert-parallel MoE ----------------------

SEQPAR_DEVICE = "cuda:0"
# The hop-merge against the plain ring: (case, B, S, H, ranks on seq,
# causal, valid keys a row or None). The JAX tests' shapes (B 2, S 32,
# H 4) at D 64, the smallest head dim #5 takes above JAX's 8, over
# seq=8; and a long row of TinyLlama's heads over seq=4.
SEQPAR_D = 64
SEQPAR_MERGE = (("B2 S32 H4 causal seq=8", 2, 32, 4, 8, True, None),
                ("B2 S32 H4 mask seq=8", 2, 32, 4, 8, False, 20),
                ("B2 S32 H4 causal+mask seq=8", 2, 32, 4, 8, True, 24),
                ("B1 S2048 H32 causal seq=4", 1, 2048, 32, 4, True, None))
# TinyLlama with sequence-parallel attention against its single-rank
# forward through #5, as max|diff| / max|single|: f32 (TF32 off) JAX's
# test bound; bf16 the smoke's bound for #5.
SEQPAR_SEQ = 4
SEQPAR_S = 2048
SEQPAR_PAD_VALID = 1500        # the B 2 case: row 1 right-padded
SEQPAR_MODEL_TOL = {"float32": 2e-4, "bfloat16": BF16_TOL}
# GPipe: TinyLlama's blocks over stage=2, (B, S), microbatch counts.
SEQPAR_GPIPE = (8, 256)
SEQPAR_GPIPE_M = (4, 8)
SEQPAR_GPIPE_TOL = 2e-4
# Expert-parallel gpt2-moe at the registry's width: expert=4, (B, S); the
# unsharded forward's bound per compute dtype (f32 JAX's 1e-4).
SEQPAR_EP = 4
SEQPAR_EP_SHAPE = (4, 128)
SEQPAR_EP_TOL = {"float32": 1e-4, "bfloat16": BF16_TOL}


@contextlib.contextmanager
def counted_copies():
    """The flash wrapper's copies of operands whose rows are not 16-byte
    aligned (``ops.flash._aligned``), counted while the block runs."""
    from tpu_engine_torch.ops import flash as fl

    seen = [0]
    aligned = fl._aligned

    def counting(t):
        out = aligned(t)
        seen[0] += out is not t
        return out
    fl._aligned = counting
    try:
        yield seen
    finally:
        fl._aligned = aligned


def seqpar_merge(torch) -> dict:
    """The card's ring (one #5 call a hop, merged by lse) against the
    plain ring (JAX's accumulation step, on the card) on the same inputs,
    f32 within F32_TOL and bf16 within BF16_TOL, with its launches
    (n(n+1)/2 causal, n² otherwise) and the flash wrapper's copies."""
    from tpu_engine_torch.ops import flash as fl
    from tpu_engine_torch.ops import kernels as kl
    from tpu_engine_torch.parallel import ring
    from tpu_engine_torch.parallel.mesh import Mesh

    res = {}
    rng = np.random.default_rng(27)
    for case, b, s, h, n, causal, valid in SEQPAR_MERGE:
        mesh = Mesh([SEQPAR_DEVICE] * n, (n,), ("seq",))
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, s, h, SEQPAR_D), np.float32)).to(SEQPAR_DEVICE)
            for _ in range(3))
        mask = None
        if valid is not None:
            m = np.zeros((b, s), np.int32)
            m[:, :valid] = 1
            mask = torch.from_numpy(m).to(SEQPAR_DEVICE)
        for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
            dt = getattr(torch, dtype)
            qq, kk, vv = (t.to(dt) for t in (q, k, v))
            kw = dict(axis_name="seq", causal=causal, kv_mask=mask,
                      batch_axis=None)
            with torch.no_grad():
                want = ring._ring(qq, kk, vv, mesh, block=ring.PLAIN, **kw)
                kl.reset_counts()
                with counted_copies() as copies:
                    got = ring.ring_attention(qq, kk, vv, mesh,
                                              causal=causal, kv_mask=mask)
                torch.cuda.synchronize()
            launches = fl.flash_attention_fwd.launches
            hops = n * (n + 1) // 2 if causal else n * n
            check(launches == hops and fl.flash_attention_fwd.plain_calls
                  == 0, f"seqpar merge {case} {dtype}: #5 {launches} != "
                        f"{hops} hops")
            check(got.dtype == dt and bool(torch.isfinite(got).all()),
                  f"seqpar merge {case} {dtype}: {got.dtype}, non-finite")
            err = float((got.float() - want.float()).abs().max())
            check(err <= tol, f"seqpar merge {case} {dtype}: {err} > {tol}")
            res[f"{case} {dtype}"] = {"max_abs_err": err, "launches":
                                      launches, "copies": copies[0]}
            if dtype == "bfloat16":
                # What rounding each hop's output to bf16 before the merge
                # costs: the merged ring and one #5 call over the whole
                # sequence, each against the plain ring in f32 on the
                # same bf16 values.
                with torch.no_grad():
                    exact = ring._ring(qq.float(), kk.float(), vv.float(),
                                       mesh, block=ring.PLAIN, **kw)
                    whole = fl.flash_attention_fwd(qq, kk, vv, causal=causal,
                                                   mask=mask)[0]
                res[f"{case} {dtype}"].update(
                    merged_vs_f32=float((got.float() - exact).abs().max()),
                    one_call_vs_f32=float((whole.float() - exact)
                                          .abs().max()))
    log("seqpar hop-merge (#5 a hop, merged by lse in f32) against the "
        "plain ring on the card: " + "; ".join(
            f"{k} err {v['max_abs_err']:.2e}, #5 {v['launches']}, copies "
            f"{v['copies']}" + (
                f" (against f32 math: merged {v['merged_vs_f32']:.2e}, one "
                f"#5 call {v['one_call_vs_f32']:.2e})"
                if "merged_vs_f32" in v else "") for k, v in res.items()))
    return res


def seqpar_tokens(vocab: int, b: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, (b, s))


def seqpar_compare(torch, what: str, got, want, tol: float, mask=None,
                   max_rel: bool = True) -> dict:
    """max|got - want| / max|want| within ``tol`` (a reading only, with
    ``max_rel`` False), and the argmax equal at every position (valid
    under ``mask``) whose top-2 margin in ``want`` exceeds ``tol`` of
    max|want|."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    check(bool(torch.isfinite(got).all()) and (err <= tol or not max_rel),
          f"{what}: {err} > {tol}")
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > tol * scale
    if mask is not None:
        clear = clear & (mask > 0)
    same = got.argmax(-1) == want.argmax(-1)
    check(bool(same[clear].all()), f"{what}: argmax differs at "
          f"{int((~same & clear).sum())} positions with a clear margin")
    return {"max_rel_err": err, "argmax_checked": int(clear.sum())}


def seqpar_layerwise(torch, params, cfg, tokens, mask, dtype, fn,
                     mesh) -> float:
    """The single-rank forward through #5, each layer's attention also run
    through ``fn`` on the same q, k, v: the largest max|fn - #5| / max|#5|
    over the layers."""
    from tpu_engine_torch.models.transformer import transformer_apply
    from tpu_engine_torch.ops import flash as fl

    worst = 0.0

    def attn(q, k, v, causal, mask):
        nonlocal worst
        a = fl.flash_attention(q, k, v, causal=causal, mask=mask).float()
        r = fn(q, k, v, mesh, causal=causal, kv_mask=mask).float()
        worst = max(worst, float((r - a).abs().max() / a.abs().max()))
        return a.to(q.dtype)
    transformer_apply(params, tokens, cfg, mask=mask, dtype=dtype,
                      attn_fn=attn)
    return worst


def peak_run(torch, fn):
    """``fn()`` with the card's allocation peak above its start (bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def seqpar_bf16_readings(torch, params, cfg, tokens, mesh, single) -> dict:
    """What the bf16 logits' difference stands against (readings, no
    check): the ring with each hop's output rounded to bf16 before the
    merge, and the single-rank forward through #5's plain version, each as
    max|diff| / max|single| from the single-rank forward through #5."""
    from tpu_engine_torch.models.transformer import transformer_apply
    from tpu_engine_torch.ops import flash as fl
    from tpu_engine_torch.parallel import ring

    def bf16_hop(q, k, v, *, causal, mask, out_dtype):
        return fl.flash_attention_fwd(q, k, v, causal=causal, mask=mask)

    def rounded_ring(q, k, v, causal, mask):
        return ring._ring(q, k, v, mesh, axis_name="seq", causal=causal,
                          kv_mask=mask, batch_axis=None, block=bf16_hop)

    def plain(q, k, v, causal, mask):
        return fl.flash_attention_reference(q, k, v, causal=causal,
                                            mask=mask)[0]

    scale = float(single.float().abs().max())
    out = {}
    for name, attn in (("ring with bf16 hop outputs", rounded_ring),
                       ("single rank, #5's plain version", plain)):
        got = transformer_apply(params, tokens, cfg, dtype=torch.bfloat16,
                                attn_fn=attn)
        out[name] = float((got.float() - single.float()).abs().max()) / scale
        del got
    return out


def seqpar_llama(torch) -> dict:
    """TinyLlama (22 layers, random weights from seed 0) with the ring and
    with Ulysses over seq=4 as every block's attention against the
    single-rank forward through #5, f32 and bf16, B 1 x S 2048 and a
    right-padded B 2 case: f32 logits within SEQPAR_MODEL_TOL of the
    largest; bf16 each layer's attention within it on the single-rank
    forward's q, k, v; argmax equal where the top-2 margin exceeds the
    bound; #5 == 22 x 10 (ring) and 22 x 4 (Ulysses) a forward, no plain
    call; each path's peak memory."""
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models.transformer import transformer_apply
    from tpu_engine_torch.ops import flash as fl
    from tpu_engine_torch.ops import kernels as kl
    from tpu_engine_torch.parallel import ring
    from tpu_engine_torch.parallel.mesh import Mesh

    spec = create_model("llama")
    cfg = spec.config
    mesh = Mesh([SEQPAR_DEVICE] * SEQPAR_SEQ, (SEQPAR_SEQ,), ("seq",))
    paths = {"ring": (ring.ring_attention,
                      SEQPAR_SEQ * (SEQPAR_SEQ + 1) // 2),
             "ulysses": (ring.ulysses_attention, SEQPAR_SEQ)}
    m = np.ones((2, SEQPAR_S), np.int32)
    m[1, SEQPAR_PAD_VALID:] = 0
    cases = {"B1": (seqpar_tokens(cfg.vocab, 1, SEQPAR_S, 28), None),
             "B2 right-padded": (seqpar_tokens(cfg.vocab, 2, SEQPAR_S, 29),
                                 m)}
    res = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        params = spec.init(0, device=SEQPAR_DEVICE, dtype=dtype)
        for case, (tokens, mask) in cases.items():
            t = torch.from_numpy(tokens).to(SEQPAR_DEVICE)
            mk = None if mask is None else torch.from_numpy(mask).to(
                SEQPAR_DEVICE)
            with torch.no_grad():
                single, single_peak = peak_run(torch, lambda: transformer_apply(
                    params, t, cfg, mask=mk, dtype=dt))
                for name, (fn, per_layer) in paths.items():
                    def attn(q, k, v, causal, mask, fn=fn):
                        return fn(q, k, v, mesh, causal=causal,
                                  kv_mask=mask)
                    kl.reset_counts()
                    got, peak = peak_run(torch, lambda: transformer_apply(
                        params, t, cfg, mask=mk, dtype=dt, attn_fn=attn))
                    launches = fl.flash_attention_fwd.launches
                    want_n = cfg.n_layers * per_layer
                    check(launches == want_n
                          and fl.flash_attention_fwd.plain_calls == 0,
                          f"seqpar {name} {case} {dtype}: #5 {launches} != "
                          f"{cfg.n_layers} x {per_layer}")
                    tol = SEQPAR_MODEL_TOL[dtype]
                    # bf16 logits after 22 random-weight layers move by
                    # ~2e-2 of the largest under any change of rounding
                    # (#5's own plain version in place of #5: the
                    # readings), so in bf16 the bound holds each layer's
                    # attention on the same q, k, v, and the logits'
                    # difference is read beside the argmax check.
                    row = seqpar_compare(
                        torch, f"seqpar {name} TinyLlama {case} {dtype}",
                        got, single, tol, mk, max_rel=dtype == "float32")
                    del got
                    if dtype == "bfloat16":
                        row["layer_max_rel_err"] = seqpar_layerwise(
                            torch, params, cfg, t, mk, dt, fn, mesh)
                        check(row["layer_max_rel_err"] <= tol,
                              f"seqpar {name} TinyLlama {case} bf16: a "
                              f"layer's attention {row['layer_max_rel_err']}"
                              f" > {tol}")
                    row.update(launches=launches, peak_bytes=peak,
                               single_peak_bytes=single_peak)
                    res[f"{name} {case} {dtype}"] = row
                if mask is None and dtype == "float32":
                    single32 = single
                if dtype == "bfloat16" and mask is None:
                    res[f"readings {case} {dtype}"] = seqpar_bf16_readings(
                        torch, params, cfg, t, mesh, single)
                    res[f"readings {case} {dtype}"][
                        "single rank, bf16 against f32 weights and math"] = \
                        float((single.float() - single32).abs().max()) / \
                        float(single32.abs().max())
                    del single32
            del single
        del params
        torch.cuda.empty_cache()
    log(f"seqpar TinyLlama ({cfg.n_layers} layers, S {SEQPAR_S}, seq="
        f"{SEQPAR_SEQ} on {SEQPAR_DEVICE}) against the single-rank forward "
        f"through #5: " + "; ".join(
            f"{k} max rel {v['max_rel_err']:.2e}"
            + (f" (a layer's attention {v['layer_max_rel_err']:.2e})"
               if "layer_max_rel_err" in v else "")
            + f", argmax equal at {v['argmax_checked']} clear positions, "
            f"#5 {v['launches']}, peak {v['peak_bytes'] / 2**30:.2f} GiB "
            f"(single {v['single_peak_bytes'] / 2**30:.2f})"
            if "max_rel_err" in v else f"{k}: {json.dumps(v)}"
            for k, v in res.items()))
    return res


def seqpar_gpipe(torch) -> dict:
    """TinyLlama's 22 blocks (f32, TF32 off) pipelined over stage=2 at B 8
    x S 256 with M 4 and 8 against the plain loop over ``_block_apply``
    (SEQPAR_GPIPE_TOL of the largest activation), #5 == 22 x M."""
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models import transformer as tt
    from tpu_engine_torch.ops import flash as fl
    from tpu_engine_torch.ops import kernels as kl
    from tpu_engine_torch.parallel.mesh import Mesh
    from tpu_engine_torch.parallel.pipeline import pipeline_apply

    spec = create_model("llama")
    cfg = spec.config
    params = spec.init(0, device=SEQPAR_DEVICE, dtype="float32")
    b, s = SEQPAR_GPIPE
    tokens = torch.from_numpy(seqpar_tokens(cfg.vocab, b, s, 30)).to(
        SEQPAR_DEVICE)
    mesh = Mesh([SEQPAR_DEVICE] * 2, (2,), ("stage",))

    def block(bp, h):
        return tt._block_apply(bp, h, cfg, mask=None, dtype=torch.float32)

    res = {}
    with torch.no_grad():
        h0 = tt._embed(params, tokens, torch.arange(s, device=SEQPAR_DEVICE)
                       [None, :], cfg, torch.float32)
        want, plain_peak = peak_run(torch, lambda: functools.reduce(
            lambda h, bp: block(bp, h), params["blocks"], h0))
        scale = float(want.abs().max())
        for m in SEQPAR_GPIPE_M:
            kl.reset_counts()
            got, peak = peak_run(torch, lambda: pipeline_apply(
                block, params["blocks"], h0, mesh, n_microbatches=m))
            launches = fl.flash_attention_fwd.launches
            check(launches == cfg.n_layers * m
                  and fl.flash_attention_fwd.plain_calls == 0,
                  f"seqpar gpipe M {m}: #5 {launches} != {cfg.n_layers} x "
                  f"{m}")
            err = float((got - want).abs().max()) / scale
            check(err <= SEQPAR_GPIPE_TOL and got.device == mesh.home,
                  f"seqpar gpipe M {m}: {err} > {SEQPAR_GPIPE_TOL}")
            res[f"M {m}"] = {"max_rel_err": err, "launches": launches,
                             "peak_bytes": peak,
                             "plain_peak_bytes": plain_peak}
    del params
    torch.cuda.empty_cache()
    log(f"seqpar GPipe: TinyLlama's {cfg.n_layers} blocks (f32) over "
        f"stage=2, B {b} x S {s}, against the plain loop: " + "; ".join(
            f"{k} max rel {v['max_rel_err']:.2e}, #5 {v['launches']}, peak "
            f"{v['peak_bytes'] / 2**30:.2f} GiB (plain "
            f"{v['plain_peak_bytes'] / 2**30:.2f})" for k, v in res.items()))
    return res


def seqpar_ep(torch) -> dict:
    """gpt2-moe at the registry's width (12 layers, d 768, 8 experts,
    top-2, capacity 1.25) with every block's expert bank split over
    expert=4 against the unsharded forward, in f32, bf16 and with int8
    weights (bf16 compute): the same routing (pairs, slots and drops),
    SEQPAR_EP_TOL, #5 == 12 a forward."""
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models import transformer as tt
    from tpu_engine_torch.ops import flash as fl
    from tpu_engine_torch.ops import kernels as kl
    from tpu_engine_torch.ops.quant import quantize_params
    from tpu_engine_torch.parallel.mesh import Mesh

    spec = create_model("gpt2-moe")
    cfg = spec.config
    mesh = Mesh([SEQPAR_DEVICE] * SEQPAR_EP, (SEQPAR_EP,), ("expert",))
    b, s = SEQPAR_EP_SHAPE
    tokens = torch.from_numpy(seqpar_tokens(cfg.vocab, b, s, 31)).to(
        SEQPAR_DEVICE)
    res = {}
    for name, dtype in (("f32", "float32"), ("bf16", "bfloat16"),
                        ("int8", "bfloat16")):
        dt = getattr(torch, dtype)
        params = spec.init(0, device=SEQPAR_DEVICE,
                           dtype="float32" if name == "int8" else dtype)
        if name == "int8":
            params = quantize_params(params)
        ep = tt.expert_parallel_params(params, mesh, "expert")
        with torch.no_grad():
            with recorded_routing() as plain_routes:
                want, single_peak = peak_run(torch, lambda: tt.transformer_apply(
                    params, tokens, cfg, dtype=dt))
            kl.reset_counts()
            with recorded_routing() as ep_routes:
                got, peak = peak_run(torch, lambda: tt.transformer_apply(
                    ep, tokens, cfg, dtype=dt))
        launches = fl.flash_attention_fwd.launches
        check(launches == cfg.n_layers
              and fl.flash_attention_fwd.plain_calls == 0,
              f"seqpar ep {name}: #5 {launches} != {cfg.n_layers}")
        margin = routing_diff(torch, f"seqpar ep {name}", ep_routes,
                              plain_routes)
        pairs = sum(d.shape[0] for _, d in ep_routes) * cfg.moe_top_k
        routed = sum(int(d.sum()) for _, d in ep_routes)
        row = seqpar_compare(torch, f"seqpar ep gpt2-moe {name}", got, want,
                             SEQPAR_EP_TOL[dtype])
        row.update(launches=launches, pairs=pairs, dropped=pairs - routed,
                   min_router_margin=margin, peak_bytes=peak,
                   single_peak_bytes=single_peak)
        res[name] = row
        del params, ep, got, want
        torch.cuda.empty_cache()
    log(f"seqpar expert-parallel gpt2-moe ({cfg.n_layers} layers, "
        f"{cfg.n_experts} experts over expert={SEQPAR_EP}, B {b} x S {s}) "
        f"against the unsharded forward: " + "; ".join(
            f"{k} max rel {v['max_rel_err']:.2e}, routing equal ("
            f"{v['pairs']} pairs, {v['dropped']} dropped), #5 "
            f"{v['launches']}, peak {v['peak_bytes'] / 2**30:.2f} GiB "
            f"(unsharded {v['single_peak_bytes'] / 2**30:.2f})"
            for k, v in res.items()))
    return res


def phase_seqpar(torch, card: str) -> dict:
    """Sequence parallelism, GPipe and expert-parallel MoE (see the module
    docstring's seqpar entry)."""
    walls = {}
    lap = lap_timer(walls)
    res = {"card": card, "walls_s": walls}
    res["merge"] = seqpar_merge(torch)
    lap("merge")
    res["gpipe"] = seqpar_gpipe(torch)
    lap("gpipe")
    res["ep"] = seqpar_ep(torch)
    lap("ep")
    res["hop"] = {name: flash_numbers(torch, 1, SEQPAR_S // SEQPAR_SEQ,
                                      getattr(torch, name))
                  for name in ("float32", "bfloat16")}
    lap("hop times")
    res["llama"] = seqpar_llama(torch)
    lap("llama")
    log(f"seqpar phase walls (s): "
        f"{json.dumps({k: round(v, 1) for k, v in walls.items()})} [{card}]")
    return res


def leaves(tree) -> list:
    """A parameter tree's tensors, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree] if hasattr(tree, "data_ptr") else []


def kernel_numbers(torch, pa, kernel: str, decode_only: bool,
                   spec: bool = False) -> dict:
    int8 = kernel.startswith("quant")
    dev = torch.device("cuda")
    inp = main_path_inputs(torch, dev, decode_only, int8, spec=spec)
    args = decode_args(inp) if kernel in ("paged_attention",
                                          "quant_paged_attention") else inp
    fn = getattr(pa, kernel)
    ref = getattr(pa, kernel + "_reference")
    ms = time_ms(torch, lambda: fn(*args))
    parts = {}
    device, seen = device_call_ms(torch, lambda: fn(*args), by_kernel=parts)
    plain = time_ms(torch, lambda: ref(*args), iters=5)
    sdpa = sdpa_yardstick(torch, inp, int8)
    library = time_ms(torch, sdpa)
    library_device, library_seen = device_call_ms(torch, sdpa)
    out_item = 4 if int8 else inp[1].element_size()
    bound, by = bound_ms(inp[0], inp[1], inp[-3], inp[-2], inp[-1],
                         out_item, scale_bytes=4 if int8 else 0)
    shape = shape_key(decode_only, spec)
    pool = "int8" if int8 else "bf16"
    log(f"numbers {kernel} ({shape}, B 8, H 32/4, D 64, bs 16, {pool} "
        f"pool): kernel {ms:.4f} ms (device time {device:.4f} ms, {seen} "
        f"of 20 calls seen), plain {plain:.4f} ms, sdpa over pre-gathered "
        f"K/V {library:.4f} ms (device time {library_device:.4f} ms, "
        f"{library_seen} seen), bound {bound:.5f} ms ({by}); device time "
        f"by kernel {json.dumps(parts)}")
    return {"ms": ms, "device_ms": device, "device_calls": seen,
            "device_by_kernel": parts, "plain_ms": plain,
            "library_ms": library, "library_device_ms": library_device,
            "bound_ms": bound, "bound_by": by}


def shape_key(decode_only: bool, spec: bool = False) -> str:
    if spec:
        return f"spec verify W={SPEC_K + 1}" if decode_only \
            else "spec mixed W=256"
    return "decode W=1" if decode_only else "mixed W=256"


def sdpa_backend(torch, dtype):
    """The scaled_dot_product_attention backend the flash yardstick forces:
    FlashAttention for bf16; for f32, which it does not take, the
    memory-efficient kernel (TF32 is off for the whole run)."""
    from torch.nn.attention import SDPBackend

    return (SDPBackend.FLASH_ATTENTION if dtype == torch.bfloat16
            else SDPBackend.EFFICIENT_ATTENTION)


def flash_numbers(torch, b: int, s: int, dtype, heads: int = 32) -> dict:
    """The flash forward over unit-normal (B, S, 32, 64) q, k, v, causal: a
    TinyLlama prefill row (B 1), or the train phase's shape (B 4, S 1024)
    (or ``heads`` other than 32: the draft model's prefill), in f32 (the variant every main path launches: q, k, v come out of
    nn.dense as f32) or bf16. The kernel, with events and a cold L2 (the
    wrapper's host time included) and as device time (``device_call_ms``);
    the plain version; and scaled_dot_product_attention(is_causal=True)
    with its backend forced (``sdpa_backend``) over the same tensors
    transposed to (B, H, S, D) beforehand (the transpose is not timed),
    timed the same two ways."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from tpu_engine_torch.ops import flash as fl

    q, k, v, _ = flash_inputs(torch, torch.device("cuda"), s, heads, 64,
                              dtype=dtype, b=b)
    call = (lambda: fl.flash_attention(q, k, v, causal=True))
    ms = time_ms(torch, call)
    device, seen = device_call_ms(torch, call)
    plain = time_ms(torch, lambda: fl.flash_attention_reference(
        q, k, v, causal=True), iters=3)
    qq, kk, vv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    backend = sdpa_backend(torch, dtype)

    def library_call():
        with sdpa_kernel(backend):
            return F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
    library = time_ms(torch, library_call)
    library_device, library_seen = device_call_ms(torch, library_call)
    bound, by = flash_bound_ms(q)
    name = str(dtype).split(".")[-1]
    log(f"numbers flash_attention (B {b}, S {s}, H {heads}, D 64, causal, "
        f"{name}): kernel {ms:.4f} ms (device time {device:.4f} ms, {seen} "
        f"of 20 calls seen), plain {plain:.4f} ms, sdpa {backend.name} "
        f"{library:.4f} ms (device time {library_device:.4f} ms, "
        f"{library_seen} seen), bound {bound:.5f} ms ({by})")
    return {"ms": ms, "device_ms": device, "device_calls": seen,
            "plain_ms": plain, "library_ms": library,
            "library_device_ms": library_device,
            "library_backend": backend.name, "bound_ms": bound,
            "bound_by": by}


def flash_bwd_bound_ms(torch, q, kernel: str) -> tuple:
    """Least time for #6 or #7 over causal (B, S, H, D) inputs with no
    mask: the larger of the bytes (q, k, v and do read once in their dtype,
    lse and delta in f32, dq (#6) or dk and dv (#7) written once) over
    3.35 TB/s and 6*D (#6: s, dp, dq) or 8*D (#7: s, dp, dv, dk) flops per
    attended (query, key) pair, S(S+1)/2 per head, over the card's peak in
    the inputs' type (bf16 tensor cores, or f32 CUDA cores: the port's f32
    products run without TF32)."""
    b, s, h, d = q.shape
    n_out = 1 if kernel == "flash_attention_bwd_dq" else 2
    nbytes = (4 + n_out) * q.numel() * q.element_size() + 2 * b * h * s * 4
    pairs = b * h * s * (s + 1) // 2
    flops = (6 if n_out == 1 else 8) * d * pairs
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def flash_bwd_numbers(torch, b: int, s: int, dtype) -> dict:
    """#6 and #7 over one causal call (H 32, D 64, unit-normal inputs, the
    forward kernel's out and lse): the kernels, with events and a cold L2
    (the wrapper's host time before the launch included) and as device
    time (``device_call_ms``, the library's measure); their plain
    versions; and the backward of scaled_dot_product_attention
    (is_causal=True) on the same tensors transposed to (B, H, S, D)
    beforehand, its forward run once beforehand and retained (neither
    timed): the device time of one autograd backward call. (Events
    bracketing that call would also count the autograd engine's host gaps
    between its kernels, which vary from run to run.) The library call
    computes dq, dk and dv at once; it is set beside each kernel and
    compares with #6 + #7 together."""
    import torch.nn.functional as F

    from tpu_engine_torch.ops import flash as fl

    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, s, 32, 64), np.float32)).to("cuda", dtype) for _ in range(4))
    out, lse = fl.flash_attention_fwd(q, k, v, causal=True)
    a = (q, k, v, None, lse, fl.bwd_delta(do, out), do)
    qq, kk, vv = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dd = do.transpose(1, 2).contiguous()
    sdpa_out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
    library, library_calls = device_call_ms(
        torch, lambda: torch.autograd.grad(sdpa_out, (qq, kk, vv), dd,
                                           retain_graph=True))
    res = {}
    for kernel in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        fn = getattr(fl, kernel)
        ref = getattr(fl, kernel + "_reference")
        ms = time_ms(torch, lambda: fn(*a, causal=True))
        device, seen = device_call_ms(torch, lambda: fn(*a, causal=True))
        plain = time_ms(torch, lambda: ref(*a, causal=True), iters=3)
        bound, by = flash_bwd_bound_ms(torch, q, kernel)
        log(f"numbers {kernel} (B {b}, S {s}, H 32, D 64, causal, "
            f"{str(dtype).split('.')[-1]}): kernel {ms:.4f} ms (device "
            f"time {device:.4f} ms, {seen} of 20 calls seen), plain "
            f"{plain:.4f} ms, sdpa backward (dq, dk, dv) {library:.4f} ms "
            f"({library_calls} of 20 calls seen), bound {bound:.5f} ms "
            f"({by})")
        res[kernel] = {"ms": ms, "device_ms": device, "device_calls": seen,
                       "plain_ms": plain, "library_ms": library,
                       "library_calls": library_calls, "bound_ms": bound,
                       "bound_by": by}
    del a, out, lse, qq, kk, vv, sdpa_out
    torch.cuda.empty_cache()
    return res


def phase_numbers(torch, pa) -> dict:
    res = {}
    # The flash backward: the train phase's shape first (the row of the
    # kernels line), then the forward's prefill rows.
    shapes = (("train B=4 S=1024 f32", 4, 1024, torch.float32),
              ("prefill S=256 bf16", 1, 256, torch.bfloat16),
              ("prefill S=2048 bf16", 1, 2048, torch.bfloat16))
    for key, b, s, dtype in shapes:
        for kernel, r in flash_bwd_numbers(torch, b, s, dtype).items():
            res.setdefault(kernel, {})[key] = r
    for kernel in KERNELS:
        if kernel.startswith("flash_attention_bwd"):
            continue
        if kernel == "flash_attention":
            res[kernel] = {key: flash_numbers(torch, b, s, getattr(torch, dt))
                           for key, b, s, dt in FLASH_SHAPES}
            # The model-drafted spec lane's draft prefill (distilgpt2
            # width, its largest bucket).
            res[kernel]["draft prefill S=64 H=12 f32"] = flash_numbers(
                torch, 1, 64, torch.float32, heads=12)
            continue
        shapes = (((True, False),) if kernel in ("paged_attention",
                                                 "quant_paged_attention")
                  else ((False, False), (True, False), (True, True),
                        (False, True)))
        res[kernel] = {shape_key(d, sp): kernel_numbers(torch, pa, kernel,
                                                        d, sp)
                       for d, sp in shapes}
    res["forward"] = forward_times(torch, res)
    res["spec_slots"] = spec_slot_times(torch)
    with served_conv_precision(torch):
        res["resnet50_forward"] = resnet_forward_times(torch)
    return res


def resnet_forward_times(torch) -> dict:
    """The forward the resnet50 /infer lane runs (bf16, 224 x 224 x 3, the
    wire already on the card, weights from seed 0) at batch buckets 1, 8
    and 32, timed by the forward rows' harness: ms per forward (events,
    cold L2), the host's time to issue it, the card's busy time in it
    (torch.profiler), the idle share and images/s; at the current TF32
    settings (``served_conv_precision`` gives the served ones)."""
    from tpu_engine_torch.models.registry import create_model

    spec = create_model("resnet50")
    params = spec.init(0, device="cuda", dtype="bfloat16")
    out = {}
    for b in (1, 8, 32):
        x = torch.rand((b, 224, 224, 3), device="cuda").to(torch.bfloat16)

        def fwd():
            with torch.inference_mode():
                return spec.apply(params, x, dtype=torch.bfloat16)

        y = fwd()
        check(bool(torch.isfinite(y).all()) and tuple(y.shape) == (b, 1000),
              f"resnet50 forward B {b}: non-finite or misshapen logits")
        ms = time_ms(torch, fwd, iters=10)
        host = issue_ms(torch, fwd)
        busy = busy_ms(torch, fwd)
        out[f"B={b}"] = res = {
            "forward_ms": ms, "issue_ms": host, "busy_ms": busy,
            "idle_share": idle_share(busy, ms),
            "images_per_s": b / ms * 1e3}
        log(f"forward (resnet50 bf16, B {b}, 224 x 224 x 3): {ms:.3f} ms "
            f"(host issue {host:.3f} ms, "
            f"{busy_text(busy, res['idle_share'])}), "
            f"{res['images_per_s']:.1f} images/s")
    del params
    torch.cuda.empty_cache()
    return out


def spec_slot_times(torch) -> dict:
    """The speculative tick's S-slot accept/emit loop
    (``spec_accept_emit``) apart from its forward, at the spec lanes'
    shape: 8 rows, S = 5 slots over TinyLlama's 32000-token vocabulary,
    four proposals a row. Greedy rows without controls, greedy rows with
    a penalty and stop lists, and drafted rows at temperature 0.8 (the
    rejection rule): the host's time to issue the loop and its time to
    the results on the host (the tick's one copy included)."""
    from tpu_engine_torch.runtime.scheduler import spec_accept_emit

    dev = torch.device("cuda")
    b, S, vocab = 8, SPEC_K + 1, 32000
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((b, S, vocab),
                                                  np.float32)).to(dev)
    tokens = torch.from_numpy(rng.integers(0, vocab, (b, S)).astype(
        np.int32)).to(dev)
    zeros = torch.zeros((b,), dtype=torch.int64, device=dev)
    base = dict(sample_slot=zeros, fold0=zeros + 1700,
                n_draft=torch.full((b,), SPEC_K, device=dev),
                active=torch.ones((b,), dtype=torch.bool, device=dev),
                done=torch.zeros((b,), dtype=torch.bool, device=dev),
                seeds=np.arange(b), topps=np.ones(b, np.float32),
                topks=np.zeros(b, np.int64), minps=np.zeros(b, np.float32),
                eos=zeros - 1)
    greedy = dict(base, stoch=np.zeros(b, bool),
                  temps=np.zeros(b, np.float32))
    variants = {
        "greedy": greedy,
        "greedy with controls": dict(
            greedy, counts=torch.zeros((b, vocab), dtype=torch.int32,
                                       device=dev),
            pens=torch.full((b,), 1.2, device=dev),
            stops=torch.full((b, 4), 7, dtype=torch.int64, device=dev)),
        "sampled drafted": dict(base, stoch=np.ones(b, bool),
                                temps=np.full(b, 0.8, np.float32)),
    }
    out = {}
    for name, kw in variants.items():
        def loop():
            res = spec_accept_emit(logits, tokens, **kw)
            return torch.cat([r.flatten().long() for r in res]).cpu()
        loop()
        host = issue_ms(torch, lambda: spec_accept_emit(logits, tokens,
                                                        **kw))
        t0 = time.perf_counter()
        for _ in range(10):
            loop()
        wall = (time.perf_counter() - t0) / 10 * 1e3
        out[name] = {"issue_ms": host, "wall_ms": wall}
        log(f"numbers spec accept/emit loop ({name}, B {b}, S {S}, V "
            f"{vocab}): host issue {host:.3f} ms, to the host copy "
            f"{wall:.3f} ms")
    return out


def forward_times(torch, kernel_res) -> dict:
    """One full-width forward (22 layers, bf16) per step the lanes run,
    timed on the card, beside the host's time to issue it and the card's
    busy time under the profiler, and the share of it the attention
    kernel takes (22 launches at the isolated kernel's device time): the mixed
    tick at W = 256 and W = 1, the two-path decode step (8 rows) and the
    spec_k = 4 ticks (8 verify windows at W = 5, and 7 beside a 256-token
    chunk; 5 slots a row through the head), over the bf16 and the int8
    pool, the two-path prefill thread's 256-token
    window of one request over its own dense row cache (no pool, no
    paged kernel), and the dense lane's steps: the monolithic prefill of a
    left-padded prompt at buckets 256 and 2048 (the flash kernel) and the
    8-row decode step over the dense cache (grouped dense attention, no
    kernel)."""
    from tpu_engine_torch.models.convert import init_params
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models.transformer import (
        KVCache,
        init_caches,
        transformer_decode_rows,
        transformer_decode_rows_paged,
        transformer_decode_window,
        transformer_prefill,
        transformer_step_rows_ragged,
    )

    cfg = create_model("llama").config
    dev = torch.device("cuda")
    params = init_params(cfg, seed=0, device=dev, dtype="bfloat16")
    shape = (cfg.n_layers, 8 * 128 + 1, 16, cfg.kv_heads, cfg.d_head)
    out = {}

    def record(key, fwd, logits_shape, kernel=None, kshape=None):
        logits = fwd()
        check(bool(torch.isfinite(logits).all())
              and tuple(logits.shape) == logits_shape,
              f"full-width forward {key}: non-finite or misshapen logits")
        ms = time_ms(torch, fwd, iters=10)
        host = issue_ms(torch, fwd)
        busy = busy_ms(torch, fwd)
        res = {"forward_ms": ms, "issue_ms": host, "busy_ms": busy,
               "idle_share": idle_share(busy, ms)}
        line = (f"forward ({key}, llama {cfg.n_layers} layers): {ms:.3f} "
                f"ms per step (host issue {host:.3f} ms, "
                f"{busy_text(busy, res['idle_share'])})")
        if kernel is not None:
            attn = cfg.n_layers * kernel_res[kernel][kshape]["device_ms"]
            res.update(kernel=kernel, attention_ms=attn,
                       attention_share=attn / ms)
            line += f", of which {kernel} {attn:.3f} ms " \
                    f"({100 * attn / ms:.1f}%)"
        out[key] = res
        log(line)

    for int8 in (False, True):
        dt = torch.int8 if int8 else torch.bfloat16
        caches = KVCache(torch.zeros(shape, dtype=dt, device=dev),
                         torch.zeros(shape, dtype=dt, device=dev))
        scales = (KVCache(torch.ones(shape[:-1], device=dev),
                          torch.ones(shape[:-1], device=dev))
                  if int8 else None)
        pool = "int8" if int8 else "bf16"
        steps = (("mixed W=256", False, "ragged", False),
                 ("decode W=1", True, "ragged", False),
                 ("two-path decode step", True, "paged", False),
                 (shape_key(True, True), True, "ragged", True),
                 (shape_key(False, True), False, "ragged", True))
        for name, decode_only, read, spec in steps:
            inp = main_path_inputs(torch, dev, decode_only, spec=spec)
            tables, pos0, qlen = inp[-3:]
            w = inp[0].shape[1]
            tokens = torch.randint(0, cfg.vocab, (8, w), device=dev,
                                   dtype=torch.int32)
            # A spec tick gathers S = k + 1 slots from each verify window's
            # first slot (and from the chunk's last token); a plain tick
            # one slot, each row's last.
            width = SPEC_K + 1 if spec else 1
            slot = (qlen - 1).clamp(min=0)
            if spec:
                slot = torch.where(qlen > width, slot, 0)
            logits_shape = (8, width, cfg.vocab) if spec else (8, cfg.vocab)
            if read == "ragged":
                kernel = ("quant_ragged_paged_attention" if int8
                          else "ragged_paged_attention")

                def fwd():
                    return transformer_step_rows_ragged(
                        params, tokens, caches, tables, pos0, qlen, cfg,
                        dtype=torch.bfloat16, sample_slot=slot,
                        sample_width=width, scales=scales)[0]
            else:
                kernel = ("quant_paged_attention" if int8
                          else "paged_attention")

                def fwd():
                    return transformer_decode_rows_paged(
                        params, tokens[:, 0], caches, tables, pos0, cfg,
                        dtype=torch.bfloat16, scales=scales)[0]
            kshape = (name if spec or name == "mixed W=256"
                      else "decode W=1")
            record(f"{name} {pool}", fwd, logits_shape, kernel, kshape)
        del caches, scales

    # The second window of a 300-token prompt (bucket 512): columns
    # 256..511 of the request's row cache, every slot through the head as
    # the scheduler asks for the window that holds the prompt's end.
    row = init_caches(cfg, 1, 512, torch.bfloat16, dev)
    window = torch.randint(0, cfg.vocab, (1, 256), device=dev,
                           dtype=torch.int32)
    w0 = torch.full((1,), 256, dtype=torch.int32, device=dev)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    record("two-path prefill window W=256",
           lambda: transformer_decode_window(
               params, window, row, w0, cfg, dtype=torch.bfloat16,
               start_vec=zero, head="all")[0],
           (1, 256, cfg.vocab))
    del row

    # The dense lane's monolithic prefill of a prompt 7 tokens short of
    # its bucket (left-padded), into the request's own row cache.
    for pb in (256, 2048):
        tokens = torch.randint(0, cfg.vocab, (1, pb), device=dev,
                               dtype=torch.int32)
        attn = torch.ones((1, pb), dtype=torch.int32, device=dev)
        attn[:, :7] = 0
        pos_ids = (torch.cumsum(attn, 1) - 1).clamp(min=0).int()
        row = init_caches(cfg, 1, pb, torch.bfloat16, dev)
        record(f"dense prefill pb={pb}",
               lambda: transformer_prefill(
                   params, tokens, row, cfg, dtype=torch.bfloat16,
                   attn_mask=attn, pos_ids=pos_ids)[0],
               (1, cfg.vocab), "flash_attention", f"prefill S={pb} f32")
        del row
    # The dense decode step: 8 rows at the main path's depths over the
    # (22, 8, 2048, 4, 64) shared cache, each row's prompt from column 5.
    dense = init_caches(cfg, 8, cfg.max_seq, torch.bfloat16, dev)
    pos = main_path_inputs(torch, dev, True)[-2]
    start = torch.clamp(pos, max=5)
    tok = torch.randint(0, cfg.vocab, (8,), device=dev, dtype=torch.int32)
    record("dense decode step", lambda: transformer_decode_rows(
        params, tok, dense, pos, cfg, dtype=torch.bfloat16,
        start_vec=start)[0], (8, cfg.vocab))
    return out


def split_reference_module():
    """This checkout's ops/paged_attention.py loaded on its own, for its
    split plain versions, whichever tree of the package is imported (its
    imports resolve to that tree's ops modules, whose API is the same)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tpu_engine_torch" / "ops" / \
        "paged_attention.py"
    spec = importlib.util.spec_from_file_location("split_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_times(torch) -> dict:
    """Device time of one call (``device_call_ms``) of #1 and #4 at the
    main path's mixed and decode shapes, #2 and #3 at its decode shape, #5
    at FLASH_SHAPES and #6/#7 at the train phase's shape (f32) and a bf16
    prefill row at S 2048, through whichever tree of the package is
    imported: ``--kernel-times`` runs only this, so that two trees can be
    timed in turns in one call. The paged reads' readings are also split by
    kernel name (split and merge kernels). #3 also at 64 and 128 keys a
    split (the module's DECODE_SPLIT_KEYS set for the reading, then
    restored; the wrapper reads it at each call; a tree whose #3 takes no
    split reads the same twice). Also the bf16 decode read's largest
    difference from this checkout's split plain version (p rounded to bf16
    against each split's maximum before PV) at the main path's decode shape
    and two parity shapes, against PAGED_SPLIT_BF16_TOL."""
    from tpu_engine_torch.ops import flash as fl
    from tpu_engine_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    res = {}
    for decode_only in (False, True):
        key = "decode W=1" if decode_only else "mixed W=256"
        for kernel, int8 in (("ragged_paged_attention", False),
                             ("quant_ragged_paged_attention", True)):
            inp = main_path_inputs(torch, dev, decode_only, int8)
            parts = res[f"{kernel} {key} by kernel"] = {}
            res[f"{kernel} {key}"] = device_call_ms(
                torch, lambda: getattr(pa, kernel)(*inp), by_kernel=parts)[0]
    for kernel, int8 in (("paged_attention", False),
                         ("quant_paged_attention", True)):
        args = decode_args(main_path_inputs(torch, dev, True, int8))
        parts = res[f"{kernel} decode by kernel"] = {}
        res[f"{kernel} decode"] = device_call_ms(
            torch, lambda: getattr(pa, kernel)(*args), by_kernel=parts)[0]
    keys = pa.DECODE_SPLIT_KEYS
    args = decode_args(main_path_inputs(torch, dev, True, True))
    try:
        for split in (64, 128):
            pa.DECODE_SPLIT_KEYS = split
            name = f"quant_paged_attention decode split {split}"
            parts = res[f"{name} by kernel"] = {}
            res[name] = device_call_ms(
                torch, lambda: pa.quant_paged_attention(*args),
                by_kernel=parts)[0]
    finally:
        pa.DECODE_SPLIT_KEYS = keys
    ref = split_reference_module()
    on = (lambda arrs: [torch.from_numpy(a).to(dev) for a in arrs])
    cases = (("main path decode",
              list(decode_args(main_path_inputs(torch, dev, True)))),
             ("parity_check", on(pa.parity_inputs())),
             ("G8 D64 nb33", on(pa.parity_inputs(
                 n_heads=16, n_kv_heads=2, d_head=64, n_blocks=33,
                 table_len=8))))
    for name, t in cases:
        t[1], t[2] = t[1].bfloat16(), t[2].bfloat16()
        out = pa.paged_attention(*t)
        err = float((out.float() - ref.paged_attention_split_reference(*t)
                     .float()).abs().max())
        res[f"paged_attention bf16 {name} err vs split version"] = err
        log(f"paged_attention bf16 {name}: max |kernel - split version| "
            f"{err:.3e} (tight tolerance {PAGED_SPLIT_BF16_TOL:g}: "
            f"{'within' if err <= PAGED_SPLIT_BF16_TOL else 'OVER'})")
    for key, b, s, dt in FLASH_SHAPES:
        q, k, v, _ = flash_inputs(torch, dev, s, 32, 64,
                                  dtype=getattr(torch, dt), b=b)
        res[f"flash {key}"] = device_call_ms(
            torch, lambda: fl.flash_attention_fwd(q, k, v, causal=True))[0]
    for key, b, s, dt in (("train B=4 S=1024 f32", 4, 1024, torch.float32),
                          ("prefill S=2048", 1, 2048, torch.bfloat16)):
        q, k, v, _ = flash_inputs(torch, dev, s, 32, 64, dtype=dt, b=b)
        out, lse = fl.flash_attention_fwd(q, k, v, causal=True)
        a = (q, k, v, None, lse, fl.bwd_delta(torch.ones_like(out), out),
             torch.ones_like(out))
        for kernel in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            fn = getattr(fl, kernel)
            res[f"{kernel} {key}"] = device_call_ms(
                torch, lambda: fn(*a, causal=True))[0]
        del q, k, v, out, lse, a
        torch.cuda.empty_cache()
    return res


def main_kernel_times(torch, root: str) -> int:
    """``--kernel-times [--package-root DIR]``: kernel_times of the package
    under DIR (default: this checkout), one JSON line, appended to
    kernel_times.jsonl in OUT_DIR."""
    card = card_line()
    res = {"root": root, "card": card, "device_ms": kernel_times(torch)}
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "kernel_times.jsonl", "a") as f:
        f.write(json.dumps(res) + "\n")
    log(json.dumps(res))
    return 0


def main_resnet_times(torch, root: str) -> int:
    """``--resnet-times [--package-root DIR]``: the package under DIR
    (default: this checkout) at torch's default TF32 settings, as a worker
    process serves: resnet_forward_times and the bf16 resnets' card vs CPU
    errors (infer_model_errs), one JSON line, appended to
    resnet_times.jsonl in OUT_DIR."""
    res = {"root": root, "card": card_line(),
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "bf16_err": {name: infer_model_errs(torch, name, "bfloat16")
                        for name in ("resnet50", "resnet50-v1")},
           "forward": resnet_forward_times(torch)}
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "resnet_times.jsonl", "a") as f:
        f.write(json.dumps(res) + "\n")
    log(json.dumps(res))
    return 0


def main_profiler_probe(torch) -> int:
    """``--profiler-probe``: how often a torch.profiler session keeps no
    device event, by where it runs and what ran before it in the
    process. Each session runs 20 calls each of
    SDPA (bf16 flash, f32 memory-efficient) and a bf16 matmul and
    synchronises; a session's reading is its count of device events.
    Scenarios: sessions back to back on the main thread (the numbers
    phase's pattern), the same without a synchronise before the session
    ends, sessions wholly on a second thread, a session stopped from
    another thread than the one that opened it, and ``utils.tracing``
    sessions on a thread of their own, started and stopped from other
    threads while the main thread works (also their CPU ops from the
    main thread); then the numbers phase's SDPA f32 yardstick and the
    ragged kernel by ``device_call_ms`` (calls seen of 20): fresh, after
    60 more sessions and 400 threads, after CUDA-event timing, after the
    kernel library's launches. Prints one JSON line."""
    import tempfile

    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.nn.attention import sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    from tpu_engine_torch.utils import tracing

    dev = torch.device("cuda")
    q = torch.randn(8, 32, 128, 64, device=dev, dtype=torch.bfloat16)
    q32 = q.float()
    a = torch.randn(2048, 2048, device=dev, dtype=torch.bfloat16)

    def work(sync=True):
        for _ in range(20):
            with sdpa_kernel(sdpa_backend(torch, torch.bfloat16)):
                F.scaled_dot_product_attention(q, q, q, is_causal=True)
            with sdpa_kernel(sdpa_backend(torch, torch.float32)):
                F.scaled_dot_product_attention(q32, q32, q32,
                                               is_causal=True)
            a @ a
        if sync:
            torch.cuda.synchronize()

    def session(sync_before_exit=True) -> int:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            work(sync_before_exit)
        return sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CUDA)

    def in_thread(fn):
        box = []

        def run():
            try:
                box.append(("ok", fn()))
            except Exception as exc:
                box.append(("raised", exc))
        t = threading.Thread(target=run)
        t.start()
        t.join()
        kind, val = box[0]
        if kind == "raised":
            raise val
        return val

    def stop_elsewhere() -> str:
        """A session opened on this thread, stopped from another: what
        the stop raises."""
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
        work()
        try:
            in_thread(lambda: prof.__exit__(None, None, None))
            return "stopped"
        except Exception as exc:
            return f"{type(exc).__name__}: {exc}"
        finally:
            try:
                prof.__exit__(None, None, None)
            except Exception:
                pass

    def own_thread(log_dir) -> tuple:
        check(in_thread(lambda: tracing.profiler_start(log_dir))["ok"],
              "probe: own-thread session did not start")
        work()
        res = in_thread(tracing.profiler_stop)
        with open(res["trace_file"]) as f:
            cpu = sum(1 for e in json.load(f)["traceEvents"]
                      if e.get("cat") == "cpu_op")
        return res["device_events"], cpu

    # The numbers phase's SDPA f32 yardstick (B 1, S 256, H 32, D 64,
    # memory-efficient backend), which late in a full smoke keeps no
    # device event in three sessions running: its calls seen per session.
    sq, sk, sv = (torch.randn(1, 32, 256, 64, device=dev) for _ in range(3))

    def yardstick():
        with sdpa_kernel(sdpa_backend(torch, torch.float32)):
            return F.scaled_dot_product_attention(sq, sk, sv,
                                                  is_causal=True)

    def yardstick_seen() -> int:
        return device_call_ms(torch, yardstick)[1]

    work()
    out = {"card": card_line(), "torch": torch.__version__}
    out["sdpa f32 yardstick calls seen, fresh x3"] = [
        yardstick_seen() for _ in range(3)]
    out["main thread x12"] = [session() for _ in range(12)]
    out["main thread, no sync before exit x4"] = [
        session(sync_before_exit=False) for _ in range(4)]
    out["second thread x4"] = [in_thread(session) for _ in range(4)]
    out["a session stopped from another thread"] = stop_elsewhere()
    with tempfile.TemporaryDirectory() as tmp:
        out["own thread (device events, main-thread cpu ops) x3"] = [
            own_thread(tmp) for _ in range(3)]
    out["main thread again x4"] = [session() for _ in range(4)]
    # A process with a history: 60 more sessions and 400 threads that
    # each launched work, then the yardstick again.
    for _ in range(60):
        session()
    for _ in range(400):
        in_thread(lambda: (a @ a).sum().item())
    out["after 60 sessions and 400 threads: sessions x4"] = [
        session() for _ in range(4)]
    out["after them: sdpa f32 yardstick calls seen x3"] = [
        yardstick_seen() for _ in range(3)]
    # The numbers phase's order: events-timed calls, then the session.
    out["yardstick after time_ms, calls seen x3"] = [
        (time_ms(torch, yardstick), yardstick_seen())[1] for _ in range(3)]
    # The port's kernels come from a library of their own (ctypes).
    from tpu_engine_torch.ops import kernels as kl
    from tpu_engine_torch.ops import paged_attention as pa

    kl.kernel_library()
    inp = main_path_inputs(torch, dev, False)

    def ragged():
        return pa.ragged_paged_attention(*inp)
    out["ragged kernel, calls seen x3"] = [
        device_call_ms(torch, ragged)[1] for _ in range(3)]
    out["ragged kernel after time_ms, calls seen x3"] = [
        (time_ms(torch, ragged), device_call_ms(torch, ragged))[1][1]
        for _ in range(3)]
    out["yardstick after the kernels, calls seen x3"] = [
        yardstick_seen() for _ in range(3)]
    log(json.dumps(out))
    return 0

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    if len(sys.argv) == 1:
        # A run that outlives its time shows where it stood.
        faulthandler.dump_traceback_later(SMOKE_STACKS_AFTER_S)
    if "--profiler-probe" in sys.argv:
        return main_profiler_probe(torch)
    if "--serve-worker-node" in sys.argv:
        i = sys.argv.index("--serve-worker-node")
        return main_serve_worker_node(sys.argv[i + 1:])
    if "--serve-worker" in sys.argv:
        i = sys.argv.index("--serve-worker")
        return main_serve_worker(sys.argv[i + 1:])
    if "--serve-combined" in sys.argv:
        i = sys.argv.index("--serve-combined")
        return main_serve_combined(sys.argv[i + 1:])
    for flag, mode in (("--kernel-times", main_kernel_times),
                       ("--resnet-times", main_resnet_times)):
        if flag in sys.argv:
            root = "."
            if "--package-root" in sys.argv:
                root = sys.argv[sys.argv.index("--package-root") + 1]
                sys.path.insert(0, str(Path(root).resolve()))
            return mode(torch, root)
    from tpu_engine_torch.ops import kernels as kl
    from tpu_engine_torch.ops import paged_attention as pa

    # Full-f32 products for the plain versions (TF32 keeps ~3 digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    kl.kernel_library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({kl.kernel_library_path().name}, "
        f"{len(KERNELS) + len(RECURRENT_KERNELS)} kernels from "
        f"{len(kl.SOURCES)} sources and {len(kl.HEADERS)} header)")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "build_log.txt").write_text(kl.build_log)
    walls = {"build": time.perf_counter() - t0}

    def timed(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        walls[name] = time.perf_counter() - t
        log(f"phase {name}: {walls[name]:.1f} s")
        return res

    if "--phase" in sys.argv:
        # One phase alone (after the build), for iterating on it: prints
        # its readings, not the contract's result lines.
        name = sys.argv[sys.argv.index("--phase") + 1]
        only = {"handoff": lambda: phase_handoff(torch, card),
                "observe": lambda: phase_observe(torch, card),
                "overload": lambda: phase_overload(torch, card, pa),
                "recurrent": lambda: phase_recurrent(torch, card),
                "moe": lambda: phase_moe(torch, card),
                "batch": lambda: phase_batch(torch, card),
                "combined": lambda: phase_combined(torch, card),
                "elastic": lambda: phase_elastic(torch, card),
                "tp": lambda: phase_tp(torch, card, pa),
                "mesh": lambda: phase_mesh(torch, card),
                "seqpar": lambda: phase_seqpar(torch, card),
                "parity": lambda: phase_parity(torch, pa),
                "gateway": lambda: phase_gateway(torch),
                "kvtier": lambda: phase_kvtier(torch, card),
                "refmodels": lambda: phase_refmodels(
                    torch, card, {"flash_attention": {}}),
                "server": lambda: phase_server(torch)}
        for one in name.split(","):
            res = timed(one, only[one])
            (OUT_DIR / f"phase_{one}.json").write_text(json.dumps(
                res, indent=1, default=str))
            log(f"phase {one} passed [{card}]")
        return 0
    errs = timed("parity", phase_parity, torch, pa)
    infer_parity = timed("infer parity", parity_infer_models, torch)
    timed("small model", phase_small_model, torch)
    train_small = timed("train small", phase_train_small, torch)
    server = timed("server", phase_server, torch)
    gateway = timed("gateway", phase_gateway, torch)
    kvtier = timed("kvtier", phase_kvtier, torch, card)
    refmodels = timed("refmodels", phase_refmodels, torch, card, errs)
    train = timed("train", phase_train, torch)
    numbers = timed("numbers", phase_numbers, torch, pa)
    # Late: its processes and profiler sessions run after every timing of
    # the earlier phases.
    overload = timed("overload", phase_overload, torch, card, pa)
    # Spans, /metrics, the flight recorder and the tick-bounded profile;
    # its profile runs in a worker process of its own.
    observe = timed("observe", phase_observe, torch, card)
    # The handoff family: three worker_node processes behind the gateway.
    handoff = timed("handoff", phase_handoff, torch, card)
    # The recurrent family (mamba2) and its window-scan kernel (#8).
    recurrent = timed("recurrent", phase_recurrent, torch, card)
    # The MoE family (gpt2-moe) and weight-only int8: #1 and #5 in a
    # worker_node process, #4 in a quantized lane in this process.
    moe = timed("moe", phase_moe, torch, card)
    # The batch lanes: the Generator (chunked, fused, beam, score) and the
    # batch SpeculativeGenerator; #5 at their prefills.
    batch = timed("batch", phase_batch, torch, card)
    # The combined serve command: resnet50 behind the C++ front, then
    # TinyLlama on a prefill and a decode lane (#1 and #5).
    combined = timed("combined", phase_combined, torch, card)
    # The elastic fleet and the stall watchdog over in-process lanes (#1).
    elastic = timed("elastic", phase_elastic, torch, card)
    # Tensor-parallel serving: TinyLlama lanes at tp 1, 2 and 4 with every
    # rank on the one card (#1-#4 at the ranks' shapes).
    tp = timed("tp", phase_tp, torch, card, pa)
    # Mesh-sharded serving and training: resnet50 and TinyLlama lanes and
    # the train command over data x model meshes on the one card (#5-#7).
    mesh = timed("mesh", phase_mesh, torch, card)
    # Ring and Ulysses attention, GPipe and expert-parallel MoE, every rank
    # on the one card (#5 in every path).
    seqpar = timed("seqpar", phase_seqpar, torch, card)
    rows = []
    for name, meta in KERNELS.items():
        main_shape = next(iter(numbers[name].values()))
        rows.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": (train["launches"][name] if meta["lane"] == "train"
                         else server[meta["lane"]]["launches"]),
            "max_abs_err": max(errs[name].values()),
            # Device time of one call, the kernel's and the library's (the
            # backward's library reading is device time already).
            "ms": main_shape["device_ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape.get("library_device_ms",
                                         main_shape["library_ms"]),
        })
        if name == "flash_attention":
            # This slice's path: the bert lane (non-causal, padding mask,
            # f32 as launched), its launches from its own run.
            bert = refmodels["flash"]["bert B=32 S=384 H=12 float32"]
            rows[-1]["bert"] = {
                "launches": refmodels["bert"]["launches"],
                "max_abs_err": bert["max_abs_err"],
                "ms": bert["device_ms"], "events_ms": bert["ms"],
                "plain_ms": bert["plain_ms"], "bound_ms": bert["bound_ms"],
                "bound_by": bert["bound_by"],
                "library_ms": bert["library_device_ms"]}
        # The overload phase's launches of the two kernels on its path,
        # each from its own run.
        if name == "ragged_paged_attention":
            ticks = overload["ticks"]
            rows[-1]["overload"] = {
                "launches": sum(overload[part]["launches"] for part in
                                ("worker", "identity", "swap_defer"))
                + overload["gateway"]["launches"][name],
                "ms_by_budget_frac": {
                    f: ticks[f"budget_frac {f}"]["ragged_ms"]
                    for f in ("1.0", "0.25")}}
        if name == "flash_attention":
            rows[-1]["overload"] = {
                "launches": overload["gateway"]["launches"][name],
                "ms": overload["ticks"]["flash score row f32"]}
        # The observe phase's launches, each from its own run, and #1's
        # device time per served tick from its profile.
        lane = observe["spec_lane"]
        if name in lane["launches"]:
            rows[-1]["observe"] = {"launches": lane["launches"][name]}
        if name == "ragged_paged_attention":
            rows[-1]["observe"]["profile_ms_per_tick"] = \
                lane["profile"]["ragged_ms_per_tick"]
        if name == "paged_attention":
            rows[-1]["observe"] = {
                "launches": observe["two_path"]["launches"]}
        # The handoff phase's launches per lane (#1) and in process (#4).
        if name == "ragged_paged_attention":
            rows[-1]["handoff"] = {"launches": handoff["launches"],
                                   "ticks": handoff["ticks"]}
        if name == "quant_ragged_paged_attention":
            rows[-1]["handoff"] = {"launches": handoff["int8"]["launches"],
                                   "ticks": handoff["int8"]["ticks"]}
        # The moe phase's launches, each from its own run: #1 and #5 in
        # the bf16 worker process, #4 in the quantized lane.
        if name in moe["worker"]["launches"]:
            rows[-1]["moe"] = {"launches": moe["worker"]["launches"][name],
                               "ticks": moe["worker"]["ticks"],
                               "oneshot_dispatches":
                                   moe["worker"]["oneshot_dispatches"]}
        if name == "quant_ragged_paged_attention":
            rows[-1]["moe"] = {"launches": moe["int8"]["launches"],
                               "ticks": moe["int8"]["ticks"]}
        # The batch phase's #5: the batch lane's launches (the worker
        # process's counts), at the left-padded B 8 x 512 prefill with 5
        # fully masked rows (f32, as the lane launches it).
        if name == "flash_attention":
            pre = batch["flash"]["f32"]
            rows[-1]["batch"] = {
                "launches": batch["worker"]["launches"],
                "in_process_launches": batch["in_process"]["launches"],
                "spec_launches": {k: batch["spec"][k]["launches"]
                                  for k in ("self", "auto")},
                "max_abs_err": max(batch["flash"][d]["max_abs_err"]
                                   for d in ("f32", "bf16")),
                "ms": pre["device_ms"], "plain_ms": pre["plain_ms"],
                "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
                "library_ms": pre["library_ms"]}
        # The combined phase's launches (its serve process's counts):
        # #1 at the two lanes' mixed ticks, #5 at their one-shot /score
        # dispatches.
        dec = combined["decoder"]
        if name in dec["launches"]:
            rows[-1]["combined"] = {
                "launches": dec["launches"][name],
                "ticks" if name == "ragged_paged_attention"
                else "oneshot_dispatches":
                    dec["ticks"] if name == "ragged_paged_attention"
                    else dec["oneshot_dispatches"]}
        # The elastic phase's #1: every lane's mixed ticks, minted,
        # retired and standby alike.
        if name == "ragged_paged_attention":
            rows[-1]["elastic"] = {"launches": elastic["launches"],
                                   "ticks": elastic["ticks"]}
        # The tp phase's launches (tp x 22 a step) and the kernel's
        # readings at the ranks' shapes.
        if name in tp["kernels"]:
            runs = {lane: {f: tp[lane][f] for f in ("launches", "steps")}
                    for lane in tp if isinstance(tp[lane], dict)
                    and "launches" in tp[lane] and "steps" in tp[lane]
                    and tp[lane].get("kernel") == name}
            rows[-1]["tp"] = {"lanes": runs, "rank_shapes": {
                k: {f: v[f] for f in ("max_abs_err", "device_ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_device_ms")}
                for k, v in tp["kernels"][name].items()}}
        # The mesh phase's launches: #5 at the decoder lane's
        # dispatches (layers x 2 data ranks each), #5-#7 at the mesh train
        # command's steps (layers x 2 each).
        if name in mesh["train"]["mesh"]["launches"]:
            at = mesh["kernels"][name]
            rows[-1]["mesh"] = {
                "train_launches": mesh["train"]["mesh"]["launches"][name],
                "train_steps": mesh["train"]["steps"],
                "shape": at["shape"], "max_abs_err": at["max_abs_err"],
                "ms": at["device_ms"], "plain_ms": at["plain_ms"],
                "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
                "library_ms": at.get("library_device_ms",
                                     at["library_ms"])}
            if name == "flash_attention":
                rows[-1]["mesh"].update(
                    infer_launches=mesh["decoder"]["launches"],
                    infer_dispatches=mesh["decoder"]["dispatches"])
        # The seqpar phase's #5: its launches in each path (a ring hop, an
        # Ulysses rank, a pipelined block, an EP forward's layer), the
        # hop-merge's error against the plain ring, and one hop's times
        # (the diagonal hop of TinyLlama's S 2048 over seq=4, f32).
        if name == "flash_attention":
            hop = seqpar["hop"]["float32"]
            rows[-1]["seqpar"] = {
                "launches": {
                    **{k: v["launches"] for k, v in
                       seqpar["llama"].items() if "launches" in v},
                    **{f"gpipe {k}": v["launches"] for k, v in
                       seqpar["gpipe"].items()},
                    **{f"ep {k}": v["launches"] for k, v in
                       seqpar["ep"].items()}},
                "max_abs_err": max(v["max_abs_err"] for v in
                                   seqpar["merge"].values()),
                "shape": f"B 1 x S {SEQPAR_S // SEQPAR_SEQ} x H 32, "
                         f"causal, f32",
                "ms": hop["device_ms"], "plain_ms": hop["plain_ms"],
                "bound_ms": hop["bound_ms"], "bound_by": hop["bound_by"],
                "library_ms": hop["library_device_ms"]}
    # #8's row: its launches from the recurrent phase's worker (the main
    # path), its times at the decode tick's shape (B 8 x W 1), the other
    # shapes beside them. No single PyTorch call computes the scan, so
    # library_ms is null.
    scan = recurrent["kernel"]
    decode = scan["B8 W1"]
    rows.append({
        "name": "ssd_scan", "route": "cuda",
        "source": RECURRENT_KERNELS["ssd_scan"]["source"],
        "replaces": RECURRENT_KERNELS["ssd_scan"]["replaces"],
        "launches": recurrent["worker"]["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in scan.values()),
        "ms": decode["device_ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": None,
        "shapes": {k: {f: v[f] for f in ("device_ms", "plain_ms",
                                          "bound_ms", "bound_by")}
                   for k, v in scan.items()}})
    kernels = {"kernels": rows}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "parity": errs, "infer_parity": infer_parity,
         "train_small": train_small,
         "server": server, "gateway": gateway, "kvtier": kvtier,
         "refmodels": refmodels, "overload": overload,
         "observe": observe, "handoff": handoff, "recurrent": recurrent,
         "moe": moe, "batch": batch, "combined": combined,
         "elastic": elastic, "tp": tp, "mesh": mesh, "seqpar": seqpar,
         "train": train,
         "phase_seconds": walls,
         "numbers": numbers, **kernels},
        indent=1))
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    finally:
        kill_children()
    sys.exit(code)
