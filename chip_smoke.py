#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run with a nonzero exit:
  1. the card's name and power limit (nvidia-smi), TF32 switched off;
  2. build the CUDA kernels from src/repro_torch/csrc (one nvcc per source,
     all at once, linked into one library);
  3. the int8 wire pair bit-equal to plain at f32, bf16 and f16 in every
     layout that holds the row (warp, block, clusters of 2-8), at D 100,
     768, 2560, 5120, 5124 and 18432 and N 1, 8, 16, 132 and 3408, with u
     as a float, a (0, 0) tensor and dense, x one element off, with row
     stride 0 and with an odd row stride, u one element off, broadcast
     over rows and transposed, payloads dequantized from aligned and
     unaligned bases; ten round-to-nearest wire crossings must run the
     pair and no other kernel (no fill); event and device time of the pair
     at decode (8 and 16 x 5120), prefill (132 x 5120) and training (3408
     x 768, random u) at each dtype, dequantize beside torch.mul at f32;
     the quantize kernel's device time with 1, 2, 4 and 8 blocks a row at
     the decode shapes (the cluster sweep);
     the EL2N kernel in both layouts (a warp a row, a block a row of 512
     or 256 threads) forced at their boundaries (V 1024 and 1025, an LM
     vocabulary, a block whose threads mostly get no column), in dense,
     padded, odd-stride and offset rows, and in the layout its plan picks,
     at f32 (bf16 and f16 below), with near-certain rows, -inf logits, a
     row of -inf alone (NaN, as the plain form) and labels outside [0, V);
     its event and device times (one profiler session) at (16, 100),
     (512, 152064), (16, 152064) and (64, 152064), f32 and bf16;
     then each kernel against its plain PyTorch version on the card, at the
     serving paths' shapes (Qwen2.5-14B widths; zamba2's 32 attention
     heads of 80 for the prefill and decode kernels; the Mamba-2 scan's
     two kernels, the step kernel (decode) and the chunked one (prefill),
     at zamba2's (H 80, P 64, N 64, G 1) for prefill (B 1, T 132, zero and
     random h0) and decode (B 8, T 1), at T 2-65 across the crossover and
     the chunk edges, at G 2 and 4, P 8 with N 100 and N 200, each with a
     fresh final state and written over the input state, with the
     crossover sweep's device times over T 1-16 and prefill and decode
     timed beside the chunked plain version (printed only), and the
     ptxas registers and spills of every Mamba-2 instantiation;
     the RWKV-6 scan at rwkv6-3b's (H 40, K = V = 64) for prefill and
     decode, and a strong decay w = -12) and the training path's
     (ViT-Base: int8 wire on activations and broadcast gradients, EL2N,
     non-causal prefill, the secure masked encode of one client's
     7,171,584-element upload and its recovery stream, compared as bit
     patterns), with its time, the plain
     version's, one PyTorch library call's where one computes the same
     function, and the least time the card could take (bound); the
     prefill kernel also at ragged, narrow, unaligned and batched shapes,
     with its bound at the 3xTF32 tensor-core rate beside the fp32-pipe
     one, device time (profiler) beside event time for it and SDPA, the
     SDPA kernel that served the yardstick (and whether it is
     EFFICIENT_ATTENTION's), and each instantiation's TF32 HMMA count in
     its SASS, registers and spills (fails on no HMMA or any spill);
     the dense decode kernel also with a window across a wrapped ring's
     seam, its split count, valid tiles and idle slots printed, device
     time (profiler) beside event time for it and SDPA, device time at
     every split count 1-8 (each checked against plain), and the ptxas
     registers and spills of both decode kernels and their combine;
     the paged decode kernel also with a fully masked row (it must return
     the mean of every value of its table), its split count and valid
     tiles printed, and device time (profiler) beside event time for it,
     the dense decode kernel on the same data gathered, and SDPA; then
     the other seven kernels again with bf16 inputs (masked encode
     bit-equal, EL2N within 1e-5, bf16 outputs within 2e-2 (1 + |plain|)
     of plain fed the same bf16 tensors, with the error in bf16 ulps;
     decode and paged decode with a bf16 query over f32 and over bf16
     K/V; the scans with their layer's dtype mix), timed beside plain and,
     for all-bf16 prefill and decode, bf16 SDPA, bounds at 2 B a bf16
     value; then those seven once more at f16, at its path shape (masked
     encode bit-equal, EL2N within 1e-5, f16 outputs
     within 2e-3 (1 + |plain|), the error in f16 ulps, one device time
     each beside a bound at 2 B an f16 value);
  4. engine parity: the reduced Qwen2.5 family (with a GQA group of 5)
     served on the card and on the CPU from the same seeded weights, by the
     dense engine and by the paged engine (shared prefix, chunked prefill)
     — tokens equal, logits within 1e-4, wire bytes and page counters
     equal; and the reduced zamba2 (18 layers, 3 cycles) and rwkv6 (3
     layers) through the dense engine — tokens equal, logits within 1e-4,
     wire bytes equal (zamba2 with its tails jittered by 0.2 as well,
     printed, not checked); and the GQA-5 model on the int8 wire through
     both engines at bf16 activations, card against CPU — wire bytes and
     counters equal, every logit finite, and the gap rule: teacher-forced
     on the CPU's tokens, the card's mean logit gap to the CPU at bf16 is
     at most the CPU's own bf16-vs-f32 gap (the paged engine compared
     while its tokens agree);
  5. the dense path at full width: Qwen2.5-14B widths cut to 3 layers (1
     head / 1 body / 1 tail, the fewest a split takes), 4
     tenants, 8 slots, max_seq 512, int8 wire, decode_block 8, 16 synthetic
     requests through `ServeEngine.run`; every request finishes, metered
     wire bytes are within 5% of `serve_comm_breakdown`, and every kernel
     of the dense path was launched (launch counts zeroed just before the
     run), then a profiled replay;
  6. the paged path at full width: the same model and tenants, 16 slots
     over a pool of 128 usable pages of 16 tokens (the KV memory of 4
     dense 512-token slots), a 32-token shared prefix, prefill chunks of
     64, 24 synthetic requests through `PagedServeEngine.run`; every
     request finishes, the pool drains, every join copies its boundary
     page, metered wire bytes are within 0.1% of the exact count, and
     every kernel of the paged path was launched, then a profiled replay;
  7. training parity: one SFPrompt round of the reduced ViT (3 layers,
     d_model 64) on the card and on the CPU from the same seeded weights,
     data and wire noise, with the fp32 wire and with the int8 wire —
     metered bytes, kept_frac and kept sets equal, params and losses
     within 1e-4 on both wires; then one secure + DP round (K = 3, one
     client dropped, numpy-seeded wire and DP noise) — params and secure
     bytes and dp/epsilon equal, params within roundtrip_tol(3) + 1e-4;
  8. the training path at full width: ViT-Base (12 layers, d_model 768,
     head 1 / body 10 / tail 1, prompt 16, 224x224 images, 213 tokens) on
     cifar100-syn, 8 clients of 64 samples, K = 4, U = 2, gamma 0.5, int8
     wire on both boundaries, two `SFPromptTrainer.round`s and
     `evaluate` on 128 test samples; every metric finite, metered bytes
     per boundary within 0.1% of `sfprompt_comm_breakdown` and params
     bytes equal to it, and every kernel of the path was launched (launch
     counts zeroed just before the run), then a profiled replay of one
     round;
  9. the private federated run at full width through its entry point,
     `repro_torch.launch.train.main`: ViT-Base as in phase 8, 512 samples
     over 8 clients, K = 4, 2 rounds, U = 2, int8 wire, secure aggregation,
     DP-SGD at (8, 1e-5) with clip 1, dropout rate 0.2 and seed 8 (round 0
     loses a client, round 1 keeps all four), a checkpoint every round;
     every metric finite, params and secure bytes equal to
     `secure_agg_breakdown` per round, boundary bytes within 0.1% of
     `sfprompt_comm_breakdown_partial`, dp/epsilon equal to the ledger's
     formula, each secure aggregate within roundtrip_tol(4) of
     `fedavg_partial` of the same client trees, K masked-encode launches a
     round plus one in the round with a dropout, the checkpoints and
     final.npz written under chiprun_out/private (then deleted: too large
     to bring back), every kernel of the path launched;
 10. the hybrid path at full width: zamba2-2.7b at published widths
     (d_model 2560, 80 SSM heads of 64, d_state 64, 32 attention heads of
     80, d_ff 10240, vocab 32000) cut to 18 layers (3 cycles: head 1 /
     body 1 / tail 1), with phase 5's tenants, slots, wire and traffic
     through `ServeEngine.run`; every request finishes, metered wire bytes
     are within 5% of `serve_comm_breakdown`, and every kernel of the path
     (the wire, both attention kernels and the Mamba-2 scan) was launched,
     then a profiled replay, which must run both Mamba-2 kernels and
     prints each one's launches and device us a launch beside the
     replay's copy time;
 11. the rwkv path at full width: rwkv6-3b at published widths (d_model
     2560, 40 heads of 64, decay LoRA 64, d_ff 8960, vocab 65536) cut to 3
     layers (head 1 / body 1 / tail 1), checked as phase 10 (the wire and
     the RWKV-6 scan), then a profiled replay;
 12. the dense path at bf16 (run right after phase 6, on its weights):
     phase 5 with `ServeConfig(dtype=torch.bfloat16)`, checked as phase 5,
     the first-token logit gap to f32 printed, then a profiled replay
     whose device time splits into cuBLAS, copies and casts (the per-call
     weight casts), and the port's kernels;
 13. the paged path at bf16: phase 6 at bf16, checked as phase 6, then a
     profiled replay;
 14. gemma2-9b at published widths (d_model 3584, 16 / 8 heads of 256,
     attention softcap 50, 4096-window local layers, final softcap 30,
     d_ff 14336, vocab 256000, tied embeddings) cut to 6 layers (3 cycles
     of local / global: head 1 / body 1 / tail 1) through the dense engine
     with phase 5's tenants, slots, wire and traffic, checked as phase 5
     (paging refuses its local layers, as the JAX engine does), then a
     profiled replay;
 15. stablelm-12b at published widths (d_model 5120, 32 / 8 heads of 160,
     layernorm, d_ff 13824, vocab 100352) cut to 3 layers through the
     paged engine with phase 6's pool, prefix and chunks, checked as phase
     6, then a profiled replay;
 16. the FL and SFL baselines and the heterogeneous-cut trainer (run right
     after phase 9): at the reduced ViT, one round each of FL, SFL+FF and
     SFL+Linear (K = 2) and a two-group hetero round (cuts 1/1 and 2/2,
     numpy-seeded wire noise) on the card and on the CPU from the same
     seeded weights and data, int8 wire — params within 1e-4, the hetero
     round's metered bytes equal, and the body and head changed or kept as
     each mode says; at full width, `repro_torch.launch.train.main` runs
     ViT-Base (head 1 / body 10 / tail 1, 224x224, int8 wire) with
     `--method fl`, `sfl-ff` and `sfl-linear`, one round each, K = 2, U =
     1, 64 samples a client, then a hetero round of two ViT-Base cuts (1/1
     and 2/2, K = 2 a group, gamma 0.5) and its `evaluate`; every metric
     finite, the hetero boundary bytes within 0.1% of
     `sfprompt_comm_breakdown` summed over the groups (params bytes
     equal), and every kernel of each path launched (counts zeroed just
     before each run); the phase's seconds and each path's launches are
     printed;
 17. tracing (run right after phase 13, on phase 5's model): phase 5's
     dense engine serves 6 requests untraced, then a new engine under a
     step-level tracer, then the first again; tokens and wire bytes equal
     across the three, every kernel of the dense path launched in the
     traced run, the tok/s of the three printed, and the export
     (`obs.export_all`: JSONL, Chrome trace, Prometheus text) must pass
     `tools/trace_check.py` in a subprocess, its exact meter bytes
     included; then `repro_torch.launch.train.main` runs one ViT-Base
     round (phase 16's data, K 2, U 1, int8 wire) with `--trace-out
     --trace-level step --metrics-every 1`, and its JSONL (with the round,
     dispatch and phase records) must pass `tools/trace_check.py` too;
 18. the LM training path (run right after phase 16): one SFPrompt round
     on token data for the reduced qwen2.5, zamba2 and rwkv6 (d_model 64,
     3 cycles, vocab 128, 16 tokens, K 2, 8 samples a client, int8 wire,
     numpy-seeded noise) and `evaluate`, card against CPU — bytes,
     kept_frac and kept sets equal, params, losses and eval CE within
     1e-4, and the card's scoring launching the family's kernels (the
     Mamba-2 and RWKV-6 scans included); then Qwen2.5-14B at published
     widths (d_model 5120, 40 / 8 heads of 128, vocab 152064) cut to 6
     layers (1 head / 4 body / 1 tail, prompt 4, int8 wire) through one
     round on `synthetic_lm_dataset` (seq 64, K 2, 16 samples a client,
     batch 4, U 1, gamma 0.5) and `evaluate`: metrics finite, wire bytes
     equal to the exact count, the launches of quantize, dequantize,
     prefill and EL2N printed (each must be > 0), the per-phase wall
     times and peak memory, the EL2N kernel's device time at the round's
     scoring shape (252, 152064) beside its bound; then one
     `launch.steps.make_train_step` (K 2, b 4, S 64, microbatches 2, bf16
     activations: loss finite, the K copies equal) and a prefill plus a
     decode step (bf16 activations, which must launch the wire, prefill
     and decode kernels);
 19. the buffered async runtime and hierarchical aggregation (run right
     after phase 9): at the reduced ViT (3 layers, d_model 32, int8 wire,
     numpy-seeded noise), the sync anchor on the card (buffer K,
     concurrency 1, beta 0: one flush equals one `FederatedEngine` round,
     params and bytes bit for bit, with the same kernel launches in the
     same order), two secure flushes under dropout card against CPU
     (clock, cohorts, ledger and bytes equal, params within
     roundtrip_tol(3) + 1e-4, masked-encode launches one per buffered
     entry plus one per flush with a dropped passenger) and a secure
     hierarchical round (2 edges, one client dropped, one late) card
     against CPU (bytes equal, params within roundtrip_tol(4) + 1e-4, K +
     1 masked-encode launches); then `repro_torch.launch.train.main` at
     ViT-Base width as phase 9 with `--async-buffer 4 --async-concurrency
     2 --regime wan --dropout-rate 0.25 --secure-agg`, 3 flushes (the seed
     puts dropped passengers in flushes 0 and 2), and again with clear
     flushes: the same clock and arrivals, secure params within
     roundtrip_tol(4) + 1e-4 of the clear ones, each flush's uploads and
     secure bytes equal to `secure_agg_breakdown`, its masked-encode
     launches one per entry plus one with a passenger, every metric
     finite; then `--k 4 --edges 2 --secure-agg --dropout-rate 0.2` for 2
     rounds: edge_global, params and secure bytes equal to
     `hierarchical_secure_agg_breakdown` fed the plan's edge uploads, K
     masked-encode launches plus one per edge with a dropout; it prints
     the seconds of each dispatch round, flush and round, the simulated
     seconds, staleness, the contributions held, peak memory and the
     launches per kernel;
 20. the MoE families (run right after phase 19): the reduced phi3.5-moe
     and deepseek-v3 (3 MoE layers of top-2 of 4 experts, deepseek-v3 also
     its dense prefix layer, MLA throughout, a shared expert and the MTP
     head; d_model 64, vocab 128) on the card and on the CPU from the same
     seeded weights: the unsplit `Transformer` (train logits, aux loss,
     MTP logits, prefill then decode logits within 1e-4), the dense engine
     on the int8 wire with phase 4's traffic (tokens and wire bytes equal,
     logits within 1e-4) and an SFPrompt round on token data with
     `evaluate` as phase 18's (bytes, kept_frac and kept sets equal,
     params, losses and eval CE within 1e-4), each run's router margin
     (the smallest gap between a token's k-th and (k+1)-th router
     probability) printed and held above 1e-4 (the round: 1e-5), the
     family's kernels launched on the card; then phi3.5-moe at published
     widths (d_model 4096, 32 / 8 heads of 128, 16 experts top-2 of d_ff
     6400, vocab 32064, layernorm) cut to 4 layers (head 1 / body 2 / tail
     1) and deepseek-v3 at published widths (d_model 7168, MLA with 128
     heads, q_lora 1536, kv_lora 512, nope / rope / v 128 / 64 / 128,
     dense d_ff 18432, a shared expert and routed experts of d_ff 2048
     top-8, vocab 129280, the MTP head in the tail) cut to 6 layers (its 3
     dense prefix layers, then MoE head 1 / body 1 / tail 1) and 16 of its
     256 routed experts, each with 2 tenants and phase 5's slots, wire and
     traffic through `ServeEngine.run`: the weights on the card within 2%
     of `param_count()`, every request finishes, wire bytes within 5% of
     `serve_comm_breakdown`, the dense path's four kernels launched, the
     attention of both kernels at the family's head dims (deepseek-v3:
     192 / 128), the MoE host syncs a decode step and the peak memory
     printed, then a profiled replay;
 21. Whisper and Qwen2-VL (run right after phase 20): the reduced
     whisper-base (a 1-layer encoder over 16 frames, 3 decoder layers) and
     qwen2-vl-72b (M-RoPE (4, 6, 6), QKV bias), d_model 64, vocab 128, on
     the card and on the CPU from the same seeded weights: the unsplit
     `Transformer` (train, prefill and decode logits within 1e-4), a split
     prefill with frames or 8 patch embeddings and their (2, 2, 2) grid
     positions then 4 greedy decode steps on the int8 wire (tokens and
     wire bytes equal, logits within 1e-4), an SFPrompt round (K 2, 16
     samples a client with the family's keys, batch 4, U 1, gamma 0.5;
     bytes, kept_frac and kept sets equal, params, losses and eval CE
     within 1e-4) and `evaluate` on 32 samples; then whisper-base at its
     published width and depth (6 + 6 layers, d_model 512, 8 x 64, 1500
     frames, vocab 51865) through a split prefill of 4 sequences of 64
     tokens with their frames and 32 greedy decode steps, and an SFPrompt
     round (K 2, 16 samples of 16 tokens, batch 4, U 1, gamma 0.5) with
     `evaluate` on 32 samples (kernels 1, 2, 3, 4 and 6: path `whisper`);
     then qwen2-vl-72b at published widths (8192; 64 / 8 x 128; M-RoPE
     16/24/24; QKV bias; vocab 152064) cut to 6 layers (1 head / 4 body /
     1 tail) through a split prefill of 2 sequences of a 4-token prompt, 64
     patch embeddings on a (1, 8, 8) grid and 64 text tokens and 32 greedy
     decode steps (kernels 1-4: path `vlm`); each prints its weights, its
     peak memory, tok/s and its launches by kernel, and its metered bytes
     must equal the exact count;
 22. tensor parallelism (run after phase 15): two host ranks on the one
     card, a gloo group (`repro_torch.launch.mesh.spawn_ranks`), each sending its
     launch counts, all-reduce counts and memory back. (a) Serving: the
     reduced Qwen2.5 family of tests/test_mesh_tp.py (3 layers, d_model
     128, 4 heads of 32, vocab 128), then phase 5's model (Qwen2.5-14B
     widths, 3 layers, seed 0) with 2 tenants, on (data 1, model 2), a
     trace of 6 requests (32-64 prompt, 8-16 new tokens) through the
     dense engine, then the paged one (page 16), each on the fp32 wire,
     then the int8 wire, against one process on the card: wire bytes
     `==` on both wires, tokens `==` on the fp32 wire, and the reduced
     model's fp32 last-step logits within PARITY_TOL; every logit gap and
     the int8 wire's token agreement printed beside one process's own
     gaps (dense vs paged, int8 vs fp32), the local shard shapes, each
     rank's memory, tok/s and the all-reduces a decode step with their
     ms; kernels 1-4 (dense) and 1-3 and 5 (paged) launched on both ranks
     on the int8 wire. (b) Rounds: phase 8's ViT-Base round with client 0
     dropped on (data 2) clear, secure and with FSDP, and on (model 2)
     clear, against one process: params within 1e-4 (clear) and
     roundtrip_tol(4) + 1e-4 (secure), bytes, kept_frac and kept sets
     `==`, kernels 1, 2, 3 and 6 (and 7, secure) launched on both ranks.
     The rates are gloo's through host memory on one card, not a
     tensor-parallel speed. Phase 3 also holds and times the attention
     kernels at a rank's shapes (`tp_shapes`: Qwen2.5-14B's 20 / 4 x 128
     prefill, decode and paged decode; ViT-Base's 6 x 64 prefill);
 23. the families slice H part 2 brought to the mesh (run last), on phase
     22's two ranks: (a) phi3.5-moe and deepseek-v3 at phase 20's depths
     and expert counts (8 experts a rank), zamba2-2.7b at 18 layers (3
     cycles: 40 Mamba-2 heads a rank) and rwkv6-3b at phase 11's 3 layers
     (20 heads a rank), each drawn leaf by leaf (a rank draws a frozen
     leaf whole, keeps its block and frees it), 2 tenants, served on
     (data 1, model 2) over phase 22's trace on the fp32 wire, then its
     first 2 requests on the int8 wire (the card's use read once both
     ranks have built and freed their whole leaves), against one process
     on the card:
     tokens and bytes `==` on the fp32 wire, bytes `==` on the int8 wire;
     the last-step logit gap printed beside one process's batch-1 gap,
     the router margin, MoE host syncs and all-reduces a decode step,
     tok/s, a rank's held and peak GB and the card's use; kernels 1-4
     (moe, mla), 1-4 and 8 (zamba2), 1, 2 and 9 (rwkv6) launched on both
     ranks (the fp32 runs launch all but 1 and 2). (b) Rounds on (data 1,
     model 2), on the fp32 wire and then the int8 wire: whisper-base whole
     (K 2) and qwen2-vl-72b at its published block widths, 3 layers and a
     vocabulary of 32768 (K 1; see `tp2_round_cfg`), against one process
     on the same wire: on the fp32 wire params within PARITY_TOL and the
     losses within PARITY_TOL (1 + |loss|); on both, bytes, kept_frac and
     kept sets `==`; the int8 params gap printed beside one process's own
     int8-vs-fp32 gap; kernels 3 and 6 (fp32) and 1, 2, 3 and 6 (int8)
     launched on both ranks; each round's peak a rank. Phase 3 also holds
     and times the scans and MLA at a rank's shapes (`tp2_shapes`:
     Mamba-2 at 40 heads and RWKV-6 at 20, decode (8, 1) and prefill (1,
     132); MLA decode at 64 heads 192 / 128 over 8 slots of 512 and its
     prefill at (1, 132));
 24. slots over 'data' (run last): phase 22's model, trace and engines,
     its weights drawn leaf by leaf as phase 23's (the ranks of the whole
     group taking turns), on four ranks (data 2, model 2) and then two
     (data 2), after the reduced model on each: the dense engine's ranks
     each decode their block of the 4 slots (2) and gather the next
     tokens and logits, the paged engine's every 'data' row runs the whole
     batch (its pool replicated over 'data'); fp32 then int8 wire; held
     against one process as phase 22 holds its ranks, plus each rank's
     slot block and cache slot axis; all-reduces a decode step, tok/s, a
     rank's memory and the card's printed; kernels 1-4 (dense) and 1-3
     and 5 (paged) launched on every rank on the int8 wire. Phase 3 also
     holds and times the kernels at a rank's shapes (`data_shapes`: the
     dense decode kernel over 2 slots of 256 at 20 / 4 and 40 / 8 x 128,
     the int8 pair on 2 rows of 5120);
 then the `kernels` JSON line (each kernel once, with the dtypes, head
 dims and groups it was held at, its bf16 numbers, its wide-shape
 numbers, its slice G part 2 shapes and its slice H per-rank shapes),
 then the seconds each phase took and the total, then the device line
 last.

 Phase 3 also holds and times the shapes Whisper and Qwen2-VL bring
 (`check_slice_g2`): the prefill kernel at whisper-base's encoder (4,
 1500, 8 x 64, non-causal), its cross-attention (64 and 1 queries over
 1500 frames, non-causal) and qwen2-vl-72b's (2, 132, 64 / 8 x 128,
 causal, G 8); the dense decode kernel at 8 / 8 x 64 and 64 / 8 x 128
 over 8 slots of 512; the int8 pair at (8, 8192) and (132, 8192), the
 block layout at its capacity, bit-equal in every plan.

 The wide attention shapes (head dims 160, 192 and 256; GQA groups up to
 16) run in phase 3 as well: the prefill kernel at gemma2-9b's (1, 132,
 16 / 8 x 256, softcap 50), stablelm-12b's (32 / 8 x 160) and
 nemotron-4-340b's (96 / 8 x 192, G 12) causal prefill, at deepseek-v3's
 MLA prefill over its 128 heads (q/k 192, v 128, G 1), each with the
 plan's rows and blocks, and with values narrower than the keys (192 /
 128, a window and a softcap); the dense decode kernel at the same
 three shapes over 8 slots of 512 (a window across a wrapped ring's seam,
 softcap; device time by split count at gemma2's); the paged decode
 kernel at the three shapes over 16 slots of page 16 (with a fully masked
 row); each timed beside plain and SDPA, on the device and by events,
 with its bound, and each at bf16 too. The dense decode kernel is also
 held and timed at deepseek-v3's MLA shape: 8 slots of 512, 128 / 128
 heads, keys of 192 and values of 128, scale 192^-0.5, a wrapped ring. Phase 3 also prints the
 Qwen2.5-14B, zamba2 and ViT shapes' device times beside the baseline
 PERF.md records for them from before the wide shapes, so drift in the
 instantiations those paths use shows. Phase 4 also serves
 reduced gemma2, stablelm and nemotron models (published head dims and
 groups, narrow elsewhere) card against CPU: tokens equal, logits within
 1e-4, wire bytes (and page counters) equal. nemotron-4-340b has no full-width
 phase: one of its layers is 13.6 GB in f32 and its 256000-row head 18.9
 GB a tenant, so 80 GB holds no useful cut.

Needs a CUDA device and the repository's src/ beside this file; without
either it exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
TF32X3_FLOPS = 495e12 / 3     # dense TF32 (wgmma) over three passes: the
#                               rate of fp32-accurate work on tensor cores
# H100 SXM: 132 SMs, each issuing at most 4 warp instructions (128 thread
# instructions) a clock; its INT32 ALU pipe (IADD3, LOP3, SHF, ISETP) is 64
# lanes wide, and IMAD runs on the FMA pipe beside it
SMS, ISSUE_LANES, INT32_LANES = 132, 128, 64
ALU_OPS = ("IADD3", "LOP3", "SHF", "ISETP")
ATTN_TOL = 2e-5
SCAN_TOL = 2e-5               # |kernel - plain| <= tol (1 + |plain|): the
#                               kernels sum in another order than einsum
EL2N_TOL = 1e-5               # |kernel - one-pass plain| <= tol (1 + |plain|)
BF16_TOL = 2e-2               # bf16 outputs: |kernel - plain| <= tol (1 +
#                               |plain|), the JAX kernel tests' bf16 rtol/atol
BF16_FLOPS = 989e12           # H100 SXM dense bf16 (and f16) on the tensor
#                               cores
F16_TOL = 2e-3                # f16 outputs: |kernel - plain| <= tol (1 +
#                               |plain|): f16 keeps 11 significant bits and
#                               both round the same f32 value once
PARITY_TOL = 1e-4
DIFFER_MARGIN = 0.005         # the 16-bit prefill's share of values that
#                               differ from plain, past the f32 kernel's
#                               (rounded once): 0.5 percentage points
MARKER_PAD = 8                # marker fills at each end of a device_ms_cases
#                               trace
PAGED_WIRE_TOL = 1e-3
TRAIN_WIRE_TOL = 1e-3

# TPU kernels each CUDA kernel replaces (file:line of the def)
REPLACES = {
    "quantize_int8": "src/repro/kernels/quant/kernel.py:46",
    "dequantize_int8": "src/repro/kernels/quant/kernel.py:73",
    "flash_attention_prefill": "src/repro/kernels/flash_attention/kernel.py:93",
    "decode_attention": "src/repro/kernels/flash_attention/decode.py:124",
    "paged_decode_attention":
        "src/repro/kernels/flash_attention/decode.py:261",
    "el2n": "src/repro/kernels/el2n/kernel.py:80",
    "secure_masked_encode": "src/repro/kernels/secure_mask/kernel.py:52",
    "mamba2_scan": "src/repro/kernels/mamba2_scan/kernel.py:83",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan/kernel.py:69",
}
SOURCES = {
    "quantize_int8": "src/repro_torch/csrc/quant.cu",
    "dequantize_int8": "src/repro_torch/csrc/quant.cu",
    "flash_attention_prefill": "src/repro_torch/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "paged_decode_attention": "src/repro_torch/csrc/paged_decode_attention.cu",
    "el2n": "src/repro_torch/csrc/el2n.cu",
    "secure_masked_encode": "src/repro_torch/csrc/secure_mask.cu",
    "mamba2_scan": "src/repro_torch/csrc/mamba2_scan.cu",
    "rwkv6_scan": "src/repro_torch/csrc/rwkv6_scan.cu",
}
# the prefill entry point's 16-bit kernel (bf16 and f16 q, k and v)
SOURCES_16 = {
    "flash_attention_prefill": "src/repro_torch/csrc/flash_attention_16.cu",
}
# the kernels each full-width path must launch
PATHS = {
    "dense": ("quantize_int8", "dequantize_int8", "flash_attention_prefill",
              "decode_attention"),
    "paged": ("quantize_int8", "dequantize_int8", "flash_attention_prefill",
              "paged_decode_attention"),
    "train": ("quantize_int8", "dequantize_int8", "flash_attention_prefill",
              "el2n"),
    "private": ("quantize_int8", "dequantize_int8",
                "flash_attention_prefill", "el2n", "secure_masked_encode"),
    "hybrid": ("quantize_int8", "dequantize_int8", "flash_attention_prefill",
               "decode_attention", "mamba2_scan"),
    "rwkv": ("quantize_int8", "dequantize_int8", "rwkv6_scan"),
    "dense_bf16": ("quantize_int8", "dequantize_int8",
                   "flash_attention_prefill", "decode_attention"),
    "paged_bf16": ("quantize_int8", "dequantize_int8",
                   "flash_attention_prefill", "paged_decode_attention"),
    "gemma2": ("quantize_int8", "dequantize_int8", "flash_attention_prefill",
               "decode_attention"),
    "stablelm": ("quantize_int8", "dequantize_int8",
                 "flash_attention_prefill", "paged_decode_attention"),
    # phase 16: the baselines' gradient passes run attention plain, so only
    # the int8 wire launches; the hetero round is SFPrompt's per group
    "fl": ("quantize_int8", "dequantize_int8"),
    "sfl_ff": ("quantize_int8", "dequantize_int8"),
    "sfl_linear": ("quantize_int8", "dequantize_int8"),
    "hetero": ("quantize_int8", "dequantize_int8", "flash_attention_prefill",
               "el2n"),
    # phase 17: phase 5's dense engine and phase 8's round under a tracer
    "traced_dense": ("quantize_int8", "dequantize_int8",
                     "flash_attention_prefill", "decode_attention"),
    "traced_train": ("quantize_int8", "dequantize_int8",
                     "flash_attention_prefill", "el2n"),
    # phase 18: the LM round at Qwen2.5-14B widths (causal prefill in
    # scoring and evaluate, EL2N at the vocabulary), its prefill and decode
    # steps, and the reduced families' card-vs-CPU rounds (the scans run in
    # scoring)
    "lm": ("quantize_int8", "dequantize_int8", "flash_attention_prefill",
           "el2n"),
    "lm_train_step": ("quantize_int8", "dequantize_int8"),
    "lm_steps": ("quantize_int8", "dequantize_int8",
                 "flash_attention_prefill", "decode_attention"),
    "lm_dense": ("quantize_int8", "dequantize_int8",
                 "flash_attention_prefill", "el2n"),
    "lm_hybrid": ("quantize_int8", "dequantize_int8",
                  "flash_attention_prefill", "el2n", "mamba2_scan"),
    "lm_rwkv": ("quantize_int8", "dequantize_int8", "el2n", "rwkv6_scan"),
    # phase 19: the async runtime's dispatch rounds (SFPrompt rounds) and
    # secure flushes, the same with clear flushes, and the hierarchical
    # round with a secure aggregator per edge
    "async": ("quantize_int8", "dequantize_int8", "flash_attention_prefill",
              "el2n", "secure_masked_encode"),
    "async_clear": ("quantize_int8", "dequantize_int8",
                    "flash_attention_prefill", "el2n"),
    "hier": ("quantize_int8", "dequantize_int8", "flash_attention_prefill",
             "el2n", "secure_masked_encode"),
    # phase 20: phi3.5-moe (moe) and deepseek-v3 (mla: MLA at 192 / 128)
    # served at published widths through the dense engine, and their
    # reduced families card against CPU (the unsplit model, the engine, an
    # SFPrompt round with its scoring and `evaluate`)
    "moe": ("quantize_int8", "dequantize_int8", "flash_attention_prefill",
            "decode_attention"),
    "mla": ("quantize_int8", "dequantize_int8", "flash_attention_prefill",
            "decode_attention"),
    "moe_parity": ("quantize_int8", "dequantize_int8",
                   "flash_attention_prefill", "decode_attention", "el2n"),
    "mla_parity": ("quantize_int8", "dequantize_int8",
                   "flash_attention_prefill", "decode_attention", "el2n"),
    # phase 21: whisper-base (the encoder and the cross-attention through
    # the prefill kernel, non-causal; its round scores with EL2N) and
    # qwen2-vl-72b (causal GQA 8) at published widths, and their reduced
    # families card against CPU
    "whisper": ("quantize_int8", "dequantize_int8",
                "flash_attention_prefill", "decode_attention", "el2n"),
    "vlm": ("quantize_int8", "dequantize_int8", "flash_attention_prefill",
            "decode_attention"),
    "whisper_parity": ("quantize_int8", "dequantize_int8",
                       "flash_attention_prefill", "decode_attention",
                       "el2n"),
    "vlm_parity": ("quantize_int8", "dequantize_int8",
                   "flash_attention_prefill", "decode_attention", "el2n"),
    # phase 22: Qwen2.5-14B served tensor-parallel on two ranks (each rank's
    # counts must show every kernel; the line sums the ranks), and ViT-Base
    # rounds on (data 2), with FSDP, and on (model 2)
    "tp_dense": ("quantize_int8", "dequantize_int8",
                 "flash_attention_prefill", "decode_attention"),
    "tp_paged": ("quantize_int8", "dequantize_int8",
                 "flash_attention_prefill", "paged_decode_attention"),
    "tp_dense_fp32": ("flash_attention_prefill", "decode_attention"),
    "tp_paged_fp32": ("flash_attention_prefill", "paged_decode_attention"),
    "tp_train_data": ("quantize_int8", "dequantize_int8",
                      "flash_attention_prefill", "el2n"),
    "tp_private": ("quantize_int8", "dequantize_int8",
                   "flash_attention_prefill", "el2n", "secure_masked_encode"),
    "tp_train_fsdp": ("quantize_int8", "dequantize_int8",
                      "flash_attention_prefill", "el2n"),
    "tp_train_model": ("quantize_int8", "dequantize_int8",
                       "flash_attention_prefill", "el2n"),
    # phase 23: phi3.5-moe (MoE, expert-parallel), deepseek-v3 (MLA),
    # zamba2-2.7b (Mamba-2 on a rank's heads) and rwkv6-3b (RWKV-6) served
    # tensor-parallel on two ranks, fp32 wire then int8; whisper-base and
    # qwen2-vl-72b rounds on (model 2)
    "tp2_moe": ("quantize_int8", "dequantize_int8",
                "flash_attention_prefill", "decode_attention"),
    "tp2_moe_fp32": ("flash_attention_prefill", "decode_attention"),
    "tp2_mla": ("quantize_int8", "dequantize_int8",
                "flash_attention_prefill", "decode_attention"),
    "tp2_mla_fp32": ("flash_attention_prefill", "decode_attention"),
    "tp2_hybrid": ("quantize_int8", "dequantize_int8",
                   "flash_attention_prefill", "decode_attention",
                   "mamba2_scan"),
    "tp2_hybrid_fp32": ("flash_attention_prefill", "decode_attention",
                        "mamba2_scan"),
    "tp2_rwkv": ("quantize_int8", "dequantize_int8", "rwkv6_scan"),
    "tp2_rwkv_fp32": ("rwkv6_scan",),
    "tp2_whisper": ("quantize_int8", "dequantize_int8",
                    "flash_attention_prefill", "el2n"),
    "tp2_whisper_fp32": ("flash_attention_prefill", "el2n"),
    "tp2_vlm": ("quantize_int8", "dequantize_int8",
                "flash_attention_prefill", "el2n"),
    "tp2_vlm_fp32": ("flash_attention_prefill", "el2n"),
    # phase 24: Qwen2.5-14B served with slots over 'data' on (data 2,
    # model 2) and (data 2), int8 wire then fp32, dense (a rank decodes its
    # block of slots) and paged (every 'data' row runs the whole batch)
    "data_d2m2_dense": ("quantize_int8", "dequantize_int8",
                        "flash_attention_prefill", "decode_attention"),
    "data_d2m2_paged": ("quantize_int8", "dequantize_int8",
                        "flash_attention_prefill", "paged_decode_attention"),
    "data_d2m2_dense_fp32": ("flash_attention_prefill", "decode_attention"),
    "data_d2m2_paged_fp32": ("flash_attention_prefill",
                             "paged_decode_attention"),
    "data_d2_dense": ("quantize_int8", "dequantize_int8",
                      "flash_attention_prefill", "decode_attention"),
    "data_d2_paged": ("quantize_int8", "dequantize_int8",
                      "flash_attention_prefill", "paged_decode_attention"),
    "data_d2_dense_fp32": ("flash_attention_prefill", "decode_attention"),
    "data_d2_paged_fp32": ("flash_attention_prefill",
                           "paged_decode_attention"),
}
# the wide attention shapes of phase 3: (label, Hq, Hkv, Dh)
WIDE_SHAPES = (("gemma2-9b", 16, 8, 256), ("stablelm-12b", 32, 8, 160),
               ("nemotron-4-340b", 96, 8, 192))
# the baseline device ms of the shapes whose instantiations serve the
# earlier paths, from the last chip_smoke.py run before the wide shapes
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md), printed beside this run's
RECORDED_DEVICE_MS = {
    "prefill Qwen2.5-14B": 0.0269, "prefill ViT-Base": 0.1063,
    "prefill zamba2": 0.0199, "decode Qwen2.5-14B": 0.0225,
    "decode zamba2": 0.0363, "paged decode Qwen2.5-14B": 0.0247,
}


# the head dims and GQA groups each attention kernel is held at in phase 3
HEADS = {
    "flash_attention_prefill": ([20, 32, 40, 64, 80, 128, 160, 176, 192,
                                 256], [1, 2, 3, 4, 5, 8, 12]),
    "decode_attention": ([64, 80, 128, 160, 192, 256], [1, 2, 4, 5, 8, 12]),
    "paged_decode_attention": ([128, 160, 192, 256], [2, 4, 5, 12]),
}
T0 = time.perf_counter()
PHASE_S = {}   # seconds each phase took, by phase


def lap(phase: str) -> None:
    """Record the seconds since the last lap (or the start) as `phase`'s."""
    PHASE_S[phase] = time.perf_counter() - T0 - sum(PHASE_S.values())


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ timing
def time_ms(fns, iters: int = 40) -> float:
    """Mean device time of one call, cycling through `fns` (closures over
    distinct input copies, so the inputs are not L2-resident from the
    previous call, as on the serving path)."""
    import torch
    for fn in fns[:3]:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_events(prof):
    """(name, start us, end us) of each device event of a finished
    torch.profiler run, kernels and memcpy/memset only. The profiler also
    lists operator ranges (aten::mm, record_function annotations) on the
    device timeline; they span the kernels they launch and would count
    them twice. Read from the raw Kineto events: building the profiler's
    event tree for a replay took 30-45 s."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() \
                or name.startswith("aten::"):
            continue
        start = e.start_ns() * 1e-3
        out.append((name, start, start + e.duration_ns() * 1e-3))
    return out


def device_ms(fns, iters: int = 40) -> float:
    """Device time of one call in ms: the kernels' time under
    torch.profiler over `iters` calls cycling through `fns`. Unlike
    time_ms it leaves out the host time between launches, which at
    batch-1 shapes can exceed a kernel's own. Each kernel name's mean time
    an event, times its events a call (its count over `iters`, rounded),
    summed over the names: the profiler has returned traces with some of
    a run's events missing (39 of 40, or 11), and a mean over the events
    it kept is not skewed by the ones it lost. After three traces with
    fewer than half the events (runs that opened many sessions saw them
    come back empty), queued_ms times the calls instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for fn in fns[:3]:
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        by_name = {}
        for name, start, end in device_events(prof):
            n, us = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, us + end - start)
        kept = sum(n for n, _ in by_name.values())
        if kept >= iters // 2:
            if kept % iters:
                say(f"device_ms: a trace of {iters} calls held {kept} "
                    f"device events; each name's mean an event is used")
            return sum(us / n * max(1, round(n / iters))
                       for n, us in by_name.values()) * 1e-3
        say(f"device_ms: a trace of {iters} calls held {kept} device "
            f"events; taking it again")
    say(f"device_ms: the profiler's trace of {iters} calls held {kept} "
        f"device events three times over; timed by CUDA events behind a "
        f"sleep instead (queued_ms)")
    return queued_ms(fns, iters)


def queued_ms(fns, iters: int = 40) -> float:
    """Device time of one call in ms by CUDA events, the calls queued
    behind a sleep kernel: the host enqueues all `iters` calls while the
    card sleeps (about 10 ms), so the events span the calls run back to
    back, with no host time between launches (a call that waits on the
    card breaks the queue, and its time then holds the host's). The least
    of three. device_ms's last resort, for a profiler whose traces came
    back empty; it has no per-kernel breakdown."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = math.inf
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start.record()
        for i in range(iters):
            fns[i % len(fns)]()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def device_ms_cases(cases, iters: int = 40, by_name=None):
    """device_ms of each case of `cases` (label -> fns) from ONE profiler
    session, so a sweep does not open a session a case (runs that opened
    some 150 sessions saw the later ones come back empty). The cases run
    in turn, with a one-value fill, a marker kernel, between them and
    MARKER_PAD fills before the first and after the last: later in a run
    a trace loses a few events at its ends (40 calls came back as 37), and
    a lost first or last marker must not merge or drop a case. Markers in
    a row count as one; a case's time is device_ms's sum over its kernel
    names between its markers. Retaken when the cases do not come back
    one segment each or more than half a case's events went missing;
    after three such traces, one device_ms session a case. A dict
    `by_name` receives each case's ms by kernel name (from the one
    session only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    marker = torch.empty(1, device="cuda")
    for fns in cases.values():
        for fn in fns[:3]:
            fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(MARKER_PAD):
                marker.fill_(0.0)
            for fns in cases.values():
                marker.fill_(0.0)
                for i in range(iters):
                    fns[i % len(fns)]()
            for _ in range(MARKER_PAD):
                marker.fill_(0.0)
            torch.cuda.synchronize()
        segments, seg = [], None
        for name, start, end in sorted(device_events(prof),
                                       key=lambda e: e[1]):
            if "FillFunctor" in name:
                if seg:
                    segments.append(seg)
                seg = {}
            elif seg is not None:
                n, us = seg.get(name, (0, 0.0))
                seg[name] = (n + 1, us + end - start)
        if seg:
            segments.append(seg)
        if len(segments) == len(cases) and all(
                sum(n for n, _ in seg.values()) >= iters // 2
                for seg in segments):
            split = {label: {name: us / n * max(1, round(n / iters)) * 1e-3
                             for name, (n, us) in seg.items()}
                     for label, seg in zip(cases, segments)}
            if by_name is not None:
                by_name.update(split)
            return {label: sum(ms.values()) for label, ms in split.items()}
        say(f"device_ms_cases: a trace of {len(cases)} cases lost markers "
            f"or events")
    return {label: device_ms(fns, iters) for label, fns in cases.items()}


def n_copies(bytes_per_set: int) -> int:
    """Input copies to cycle through so their total exceeds the 50 MB L2."""
    return max(2, min(1024, math.ceil(128e6 / max(bytes_per_set, 1))))


def bound(nbytes: float, flops: float, rate: float = FP32_FLOPS):
    """Least time in ms for `nbytes` of device memory traffic and `flops`
    operations at `rate` per second, and which of the two bounds it."""
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations")


# ---------------------------------------------------------------- phase 3
QUANT_DTYPES = ("float32", "bfloat16", "float16")
# bit-equality: D 5124 takes 16-byte loads at f32 and one value a load at
# 16 bits, 100 has dequantize tails, 18432 is nemotron-4-340b's width
QUANT_D = (100, 768, 2560, 5120, 5124, 18432)
QUANT_N = (1, 8, 16, 132, 3408)
QUANT_LAYOUTS = ("offset", "row stride 0", "odd stride", "u offset",
                 "u rows broadcast", "u strided")
# the pair's timed shapes: decode (8 and 16 slots of Qwen2.5-14B's d_model,
# u 0.5), prefill (132 tokens) and training (ViT-Base's 16 x 213 tokens of
# 768, random u)
QUANT_SHAPES = (("decode", 8, 5120), ("decode", 16, 5120),
                ("prefill", 132, 5120), ("train", 3408, 768))
SWEEP_C = (1, 2, 4, 8)   # blocks a row in the cluster sweep (1: a block)


def quant_plans(D):
    """None (the plan `quantize_plan` picks), then every layout that holds
    rows of D values: the warp up to 1024, the block up to 8192, and
    clusters of 2, 3, 4 and 8 blocks from ceil(D / 8192) on."""
    plans = [None]
    if D <= 1024:
        plans.append(("warp", 1, 256))
    if D <= 8192:
        plans.append(("block", 1, 256))
    return plans + [("cluster", C, 256) for C in (2, 3, 4, 8)
                    if C * 8192 >= D]


def quant_us(torch, gen, N, D):
    """u as a float (0.5 and another), a (0, 0)-strided tensor, dense."""
    return (0.5, float(torch.rand((), generator=gen, device="cuda")),
            torch.rand((), generator=gen, device="cuda").expand(N, D),
            torch.rand((N, D), generator=gen, device="cuda"))


def quant_x(torch, gen, N, D, dtype, offset=0):
    """(N, D) normals x 3 of `dtype`, `offset` elements into their storage,
    row 0 opening with zeros and row 1 all zero (scale 1e-8)."""
    x = (torch.randn(N * D + offset, generator=gen, device="cuda") * 3.0
         ).to(dtype)[offset:].view(N, D)
    x[0, :7] = 0.0
    if N > 1:
        x[1] = 0.0
    return x


def quant_equal(torch, label, x, us, plans, dtype):
    """Every (u, plan) against plain, payload and scales; the payload
    dequantized to f32 and to `dtype`, from an aligned base and from one
    byte off 16. Returns the number of quantize cases."""
    from repro_torch.kernels.quant import ref
    from repro_torch.kernels.quant.kernel import dequantize_fwd, quantize_fwd
    for u in us:
        rv, rs = ref.quantize(x, u)
        for plan in plans:
            v, s = quantize_fwd(x, u, plan)
            if not (torch.equal(v, rv) and torch.equal(s, rs)):
                kind = (f"float {u}" if isinstance(u, float)
                        else f"strides {tuple(u.stride())}")
                fail(f"quantize_int8 {label} plan {plan} u {kind}: "
                     f"{int((v != rv).sum())} values, "
                     f"{int((s != rs).sum())} scales differ from plain")
    v1 = torch.empty(rv.numel() + 1, dtype=torch.int8,
                     device="cuda")[1:].view(rv.shape)
    v1.copy_(rv)
    for dt in {torch.float32, dtype}:
        want = ref.dequantize(rv, rs, dt)
        if not (torch.equal(dequantize_fwd(rv, rs, dt), want)
                and torch.equal(dequantize_fwd(v1, rs, dt), want)):
            fail(f"dequantize_int8 {label} to {dt} differs from plain")
    return len(us) * len(plans)


def check_quant(torch, gen, results):
    """The int8 pair bit-equal to plain in every layout, at f32, bf16 and
    f16; a wire crossing launches the pair alone; device times at the
    decode, prefill and training shapes (with dequantize's library call,
    torch.mul); the cluster sweep."""
    from repro_torch.kernels.quant import ref
    n = 0
    for name in QUANT_DTYPES:
        dt = getattr(torch, name)
        for D in QUANT_D:
            for N in QUANT_N:
                n += quant_equal(torch, f"{name} ({N}, {D})",
                                 quant_x(torch, gen, N, D, dt),
                                 quant_us(torch, gen, N, D), quant_plans(D),
                                 dt)
        for layout in QUANT_LAYOUTS:
            for N, D in ((8, 5120), (132, 768), (16, 18432), (3, 100)):
                x, us = quant_x(torch, gen, N, D, dt), None
                if layout == "offset":
                    x = quant_x(torch, gen, N, D, dt, offset=1)
                elif layout == "row stride 0":
                    x = quant_x(torch, gen, 1, D, dt).expand(N, D)
                elif layout == "odd stride":
                    x = quant_x(torch, gen, N, D + 1, dt)[:, :D]
                elif layout == "u offset":
                    us = (torch.rand(N * D + 1, generator=gen,
                                     device="cuda")[1:].view(N, D),)
                elif layout == "u rows broadcast":
                    us = (torch.rand((1, D), generator=gen, device="cuda")
                          .expand(N, D),)
                elif layout == "u strided":
                    us = (torch.rand((D, N), generator=gen,
                                     device="cuda").t(),)
                n += quant_equal(torch, f"{name} ({N}, {D}) {layout}", x,
                                 us or quant_us(torch, gen, N, D),
                                 quant_plans(D), dt)
    say(f"quant: kernel == plain in {n} quantize cases (f32, bf16, f16; D "
        f"{QUANT_D}; N {QUANT_N}; u a float, (0, 0) and dense; every "
        f"layout that holds the row; x one element off, row stride 0 and "
        f"odd; u off, (0, 1) and transposed), dequantized to f32 and x's "
        f"dtype from aligned and unaligned payloads")

    # the training path's shapes (ViT-Base: 16 x 213 tokens of 768 in phase
    # 2, 32 x 213 in evaluate) and the layouts autograd hands the backward
    # crossing: broadcast gradients through the op's .contiguous() branch
    from repro_torch.kernels.quant.kernel import dequantize_fwd
    from repro_torch.kernels.quant.ops import quantize_int8
    D = 768
    for N in (16 * 213, 32 * 213):
        row = torch.randn((1, D), generator=gen, device="cuda").expand(N, D)
        col = torch.randn((N, 1), generator=gen, device="cuda").expand(N, D)
        full = torch.randn((), generator=gen, device="cuda").expand(N, D)
        for u in (0.5, torch.rand((N, D), generator=gen, device="cuda")):
            for name, x in (("strides (0, 1)", row), ("strides (1, 0)", col),
                            ("strides (0, 0)", full)):
                v, s = quantize_int8(x, u)
                rv, rs = ref.quantize(x, u)
                if not (torch.equal(v, rv) and torch.equal(s, rs)
                        and torch.equal(dequantize_fwd(v, s),
                                        ref.dequantize(v, s))):
                    fail(f"quant op ({N}, {D}) {name} differs from plain")
    say(f"quant: op == plain at the training shapes N in (3408, 6816), "
        f"D={D}, u 0.5 and random, broadcast-gradient layouts")
    wire_crossing_kernels(torch, gen)
    quant_timing(torch, gen, results)
    results["quantize_int8"]["cluster_sweep"] = quant_cluster_sweep(torch,
                                                                   gen)


def wire_crossing_kernels(torch, gen):
    """Fail unless ten round-to-nearest crossings of the int8 wire at
    decode (8 slots of 5120) launch 10 quantize and 10 dequantize kernels
    and run nothing else: u goes to the kernel by value, no fill makes it.
    The launch counters of the same window must read 10 and 10. The
    profiler has dropped a kernel's record from such a trace (9 quantize
    and 10 dequantize, no other kernel, in one run): a trace short of the
    pair is taken once more only where the counters read 10 and 10 in its
    window, and the second trace must hold."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import launch_counts
    from repro_torch.runtime.boundary import Boundary
    from repro_torch.runtime.codec import get_codec
    b = Boundary("head_body", get_codec("int8"))
    x = torch.randn((8, 1, 5120), generator=gen, device="cuda")
    b.transmit(x, train=False)
    torch.cuda.synchronize()
    pair = ("quantize_int8", "dequantize_int8")
    for attempt in (1, 2):
        n0 = launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                b.transmit(x, train=False)
            torch.cuda.synchronize()
        n1 = launch_counts()
        launched = [n1[k] - n0[k] for k in pair]
        if launched != [10, 10]:
            fail(f"10 wire crossings launched {launched[0]} quantize and "
                 f"{launched[1]} dequantize kernels")
        names = [name for name, _, _ in device_events(prof)]
        quant = [k for k in names if re.search(r"\bquantize_kernel", k)]
        dequant = [k for k in names if "dequantize_kernel" in k]
        others = sorted(set(names) - set(quant) - set(dequant))
        counted = (f"{len(quant)} quantize and {len(dequant)} dequantize "
                   f"kernels and {others}")
        if len(quant) == 10 and len(dequant) == 10 and not others:
            break
        if attempt == 2 or others or max(len(quant), len(dequant)) > 10:
            fail(f"10 wire crossings ran {counted}")
        say(f"quant: the profiler recorded {counted} for 10 crossings whose "
            f"counters read 10 and 10 launches; tracing them once more")
    say(f"quant: 10 round-to-nearest wire crossings at (8, 1, 5120) "
        f"launched the pair 10 times (counters and trace) and ran no other "
        f"kernel (no fill)")


def quant_timing(torch, gen, results):
    """Event and device ms of the pair at QUANT_SHAPES at every dtype, with
    the same u (0.5 at decode and prefill, dense random u at training) over
    copies past the L2; plain at (8, 5120); dequantize's library call,
    torch.mul(values, scales) (int8 x f32 promotes to f32: bit-equal to
    the kernel's f32 output), at every shape."""
    from repro_torch.kernels.quant import ref
    from repro_torch.kernels.quant.kernel import (dequantize_fwd,
                                                  quantize_fwd, quantize_plan)
    lines = []
    for name in QUANT_DTYPES:
        dt = getattr(torch, name)
        isz = dt.itemsize
        for label, N, D in QUANT_SHAPES:
            random_u = label == "train"
            q_bytes = N * D * isz + N * D * 4 * random_u + N * D + N * 4
            d_bytes = N * D + N * 4 + N * D * isz
            xs = [(torch.randn((N, D), generator=gen, device="cuda") * 3.0
                   ).to(dt) for _ in range(n_copies(q_bytes))]
            us = [torch.rand((N, D), generator=gen, device="cuda")
                  if random_u else 0.5 for _ in xs]
            pays = [quantize_fwd(x, u) for x, u in zip(xs, us)]
            quant = [lambda x=x, u=u: quantize_fwd(x, u)
                     for x, u in zip(xs, us)]
            deq = [lambda p=p: dequantize_fwd(*p, dt) for p in pays]
            cases = {"quantize": quant, "dequantize": deq}
            if dt == torch.float32:
                v, s = pays[0]
                if not torch.equal(torch.mul(v, s), dequantize_fwd(v, s)):
                    fail("torch.mul(values, scales) differs from the "
                         "dequantize kernel at f32")
                cases["torch.mul"] = [lambda p=p: torch.mul(*p)
                                      for p in pays]
            dev = device_ms_cases(cases)
            bq, bd = bound(q_bytes, 4 * N * D), bound(d_bytes, N * D)
            u_s = "random u" if random_u else "u 0.5"
            q = dict(max_abs_err=0.0, ms=time_ms(quant),
                     device_ms=dev["quantize"], bound_ms=bq[0],
                     bound_by=bq[1], library_ms=None, plain_ms=None,
                     plan=quantize_plan(N, D, isz),
                     shape=f"x ({N}, {D}) {name}, {u_s}")
            d = dict(max_abs_err=0.0, ms=time_ms(deq),
                     device_ms=dev["dequantize"], bound_ms=bd[0],
                     bound_by=bd[1], library_ms=None, plain_ms=None,
                     shape=f"v ({N}, {D}) -> {name}")
            if "torch.mul" in dev:
                d["library_ms"] = time_ms(cases["torch.mul"])
                d["library_device_ms"] = dev["torch.mul"]
            if (N, D) == (8, 5120):
                q["plain_ms"] = time_ms([lambda x=x: ref.quantize(x, 0.5)
                                         for x in xs])
                d["plain_ms"] = time_ms([lambda p=p: ref.dequantize(*p, dt)
                                         for p in pays])
            del xs, us, pays, quant, deq, cases
            for kernel, r in (("quantize_int8", q), ("dequantize_int8", d)):
                results.setdefault(kernel, {}).setdefault(
                    {"float32": "f32", "bfloat16": "bf16",
                     "float16": "f16"}[name], {})[r["shape"]] = r
                lib = "" if r["library_ms"] is None else \
                    f", torch.mul {r['library_ms']:.4f} " \
                    f"({r['library_device_ms']:.4f} on the device)"
                lines.append(
                    f"  {kernel} {r['shape']}: {r['ms']:.4f} ms "
                    f"({r['device_ms']:.4f} on the device; bound "
                    f"{r['bound_ms']:.6f}, {r['device_ms'] / r['bound_ms']:.1f}"
                    f"x){lib}" + (f", plan {r['plan']}" if "plan" in r
                                  else ""))
    say("quant timing (event ms, device ms):\n" + "\n".join(lines))
    # the contract's numbers: f32 at the decode shape
    for kernel, case in (("quantize_int8", "x (8, 5120) float32, u 0.5"),
                         ("dequantize_int8", "v (8, 5120) -> float32")):
        results[kernel].update(results[kernel]["f32"][case])


def quant_cluster_sweep(torch, gen):
    """Device ms of the quantize kernel at the decode shapes (N 8 and 16;
    D 2560, 3584, 5120; f32 and bf16; u 0.5) with C blocks a row for C in
    SWEEP_C (C 1: the block layout; each C the mean of two passes, in
    order and reversed, in one profiler session), beside `quantize_plan`'s
    choice, which would take a cluster where one beat C 1 by 10%. Printed
    and returned, by case."""
    from repro_torch.kernels.quant.kernel import quantize_fwd, quantize_plan
    lines, sweep = [], {}
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        for D in (2560, 3584, 5120):
            for N in (8, 16):
                xs = [(torch.randn((N, D), generator=gen, device="cuda")
                       ).to(dt) for _ in range(n_copies(N * D * 3))]
                calls = {C: [lambda x=x, plan=(
                    ("block", 1, 256) if C == 1 else ("cluster", C, 256)):
                    quantize_fwd(x, 0.5, plan) for x in xs] for C in SWEEP_C}
                # each C twice, in order and reversed, against drift
                order = [(C, k) for k, Cs in enumerate(
                    (SWEEP_C, SWEEP_C[::-1])) for C in Cs]
                dev = device_ms_cases({ck: calls[ck[0]] for ck in order})
                ms = {C: (dev[(C, 0)] + dev[(C, 1)]) / 2 for C in SWEEP_C}
                best = min(ms, key=ms.get)
                sweep[f"{name} ({N}, {D})"] = dict(
                    device_ms=ms, best=best,
                    plan=quantize_plan(N, D, dt.itemsize))
                lines.append(
                    f"  {name} ({N}, {D}): " + ", ".join(
                        f"C {C} {t:.5f}" for C, t in ms.items())
                    + f"; best C {best} ({1 - ms[best] / ms[1]:.1%} under "
                      f"C 1); plan {quantize_plan(N, D, dt.itemsize)}")
                del xs
    say("quant cluster sweep (device ms):\n" + "\n".join(lines))
    return sweep


def _prefill_pairs(S, kv_len, window):
    """Unmasked (query, key) pairs of causal prefill: the work the data
    needs."""
    total = 0
    for r in range(S):
        hi = min(r, kv_len - 1)
        lo = max(0, r - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


# Shapes that take the prefill kernel's other paths: (B, Sq, Hq, Hkv, Dh,
# causal, window, softcap, kv_len, offset); q, k and v start `offset`
# floats into their storage (offset 1 takes the 4-byte copies)
PREFILL_CASES = [
    (16, 213, 12, 12, 64, False, None, None, None, 0),
    (1, 1, 4, 2, 64, True, None, None, None, 0),
    (1, 65, 8, 2, 64, True, 20, None, None, 0),
    (2, 129, 4, 1, 32, True, None, 30.0, 100, 0),
    (2, 77, 6, 3, 20, False, None, None, None, 0),
    (1, 200, 4, 4, 40, True, 16, None, 60, 0),
    (2, 50, 6, 2, 64, True, None, None, None, 1),
    (1, 90, 4, 4, 40, False, 24, 10.0, None, 1),
    (1, 100, 10, 2, 128, True, None, None, 70, 0),
    (8, 100, 40, 8, 128, True, 32, 30.0, 90, 0),
    (4, 129, 24, 8, 40, True, None, None, 100, 1),
    (1, 70, 16, 8, 256, True, 20, 50.0, None, 0),
    (1, 100, 24, 2, 192, True, None, None, 80, 1),
    (2, 133, 32, 8, 160, True, 40, None, None, 0),
    (1, 200, 8, 4, 176, False, 16, None, 60, 0),
]


def check_prefill_cases(torch, gen):
    """The prefill kernel against plain at PREFILL_CASES, k and v as views
    into one kv tensor; returns the largest error."""
    import numpy as np
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    worst = 0.0
    for B, S, Hq, Hkv, Dh, causal, window, softcap, kv_len, off in \
            PREFILL_CASES:
        def randn(shape):
            return torch.randn(int(np.prod(shape)) + off, generator=gen,
                               device="cuda")[off:].view(shape)
        q = randn((B, S, Hq, Dh))
        kv = randn((B, S, 2 * Hkv, Dh))
        k, v = kv[:, :, :Hkv], kv[:, :, Hkv:]
        L = kv_len or S
        got = flash_attention_fwd(q, k, v, causal=causal,
                                  sliding_window=window, softcap=softcap,
                                  scale=Dh ** -0.5, kv_len=L)
        want = ref.attention(q, k[:, :L], v[:, :L], causal=causal,
                             sliding_window=window, softcap=softcap,
                             scale=Dh ** -0.5)
        err = float((got - want).abs().max())
        if not (torch.isfinite(got).all() and err <= ATTN_TOL):
            fail(f"prefill case {(B, S, Hq, Hkv, Dh, causal, window, softcap, kv_len, off)}"
                 f": max|kernel - plain| = {err:.3g} > {ATTN_TOL}")
        worst = max(worst, err)
    say(f"prefill: {len(PREFILL_CASES)} cases (ragged Sq 1/65/129, widths "
        f"20/40/176, 4-byte copies, GQA 5 and 12 with kv_len < Sq, windows, "
        f"softcaps, head dims 160/192/256): max abs err {worst:.3g}")
    return max(worst, check_prefill_plans(torch, gen))


# The narrow f32 layout's path shapes at which every row count, a split
# count of 1, 3 and 8 and both groups are forced: (label, B, Sq, Skv, Hq,
# Hkv, Dh, causal, window, kv_len)
PREFILL_PLAN_SHAPES = (
    ("whisper-base cross-attention Sq 1", 4, 1, 1500, 8, 8, 64, False, None,
     None),
    ("whisper-base cross-attention Sq 64", 4, 64, 1500, 8, 8, 64, False,
     None, 1337),
    ("qwen2-vl-72b", 2, 132, 132, 64, 8, 128, True, None, None),
    ("Qwen2.5-14B, a window past kv_len", 1, 132, 132, 40, 8, 128, True, 24,
     70),
    ("ViT-Base", 16, 213, 213, 12, 12, 64, False, None, None),
    ("zamba2", 1, 132, 132, 32, 32, 80, True, None, None),
    ("stablelm-12b", 1, 132, 132, 32, 8, 160, True, None, None))


def check_prefill_plans(torch, gen):
    """The narrow f32 layout against plain at PREFILL_PLAN_SHAPES under
    every plan the kernel takes there (rows 64, 32, 16; splits 1, 3, 8;
    one head a block and the GQA group); returns the largest error."""
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, prefill_plan)
    worst, n = 0.0, 0
    for label, B, Sq, Skv, Hq, Hkv, Dh, causal, window, kv_len in \
            PREFILL_PLAN_SHAPES:
        q = torch.randn((B, Sq, Hq, Dh), generator=gen, device="cuda")
        k = torch.randn((B, Skv, Hkv, Dh), generator=gen, device="cuda")
        v = torch.randn((B, Skv, Hkv, Dh), generator=gen, device="cuda")
        L = kv_len or Skv
        want = ref.attention(q, k[:, :L], v[:, :L], causal=causal,
                             sliding_window=window, scale=Dh ** -0.5)
        base = prefill_plan(B, Sq, Hq, Dh, Dh, 4, SMS, Hkv=Hkv, kv_len=L)
        for rows in (64, 32, 16):
            for splits in (1, 3, 8):
                for group in sorted({1, Hq // Hkv}):
                    if group > rows:
                        continue
                    plan = base._replace(rows=rows, splits=splits,
                                         group=group)
                    got = flash_attention_fwd(
                        q, k, v, causal=causal, sliding_window=window,
                        softcap=None, scale=Dh ** -0.5, kv_len=L, plan=plan)
                    err = float((got - want).abs().max())
                    if not (torch.isfinite(got).all() and err <= ATTN_TOL):
                        fail(f"prefill {label} at rows {rows}, splits "
                             f"{splits}, group {group}: max|kernel - plain| "
                             f"= {err:.3g} > {ATTN_TOL}")
                    worst, n = max(worst, err), n + 1
    say(f"prefill: the narrow layout's {n} forced plans at "
        f"{len(PREFILL_PLAN_SHAPES)} path shapes: max abs err {worst:.3g}")
    return worst


def sdpa_backends(torch, F, args, is_causal, scale):
    """CUDA kernel names of one SDPA call as PyTorch picks it and under
    sdpa_kernel(EFFICIENT_ATTENTION), from the profiler."""
    from torch.autograd import DeviceType
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    def names(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sorted({e.name for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and not e.name.startswith("aten::")})

    def default():
        F.scaled_dot_product_attention(*args, is_causal=is_causal,
                                       scale=scale)

    def efficient():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            F.scaled_dot_product_attention(*args, is_causal=is_causal,
                                           scale=scale)
    return names(default), names(efficient)


def ptxas_report():
    """Registers and spill bytes of every kernel function of the build,
    by mangled name, from the ptxas report (-Xptxas=-v) in build.log."""
    from repro_torch.kernels import build
    out, current = {}, None
    for line in build.build_log().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = out.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            current = None
    return out


def prefill_build_report():
    """Per instantiation of the prefill kernels, f32's
    (flash_narrow_kernel<ND, vec16> at ND 4-20 and flash_wide_kernel<ND,
    NV, vec16> at 24 and 32) and the 16-bit one's (flash16_kernel<ND, vec,
    T>, bf16 and f16): HMMA instructions in its SASS (cuobjdump of the
    built library) by kind, TF32 (m16n8k8) and 16-bit (m16n8k16), and
    registers and spill bytes from the ptxas report. Fails if an f32 one
    has no TF32 HMMA, a 16-bit one no 16-bit HMMA, one spills, a narrow
    one takes more registers than the plan's F32_NARROW_REGISTERS, a 16-bit
    instantiation of the f32 kernels or an instantiation of the old f32
    kernels (flash_fwd_kernel, flash_fwd_wide_kernel) is left in the
    library, or the 44 are not there."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import (
        F32_NARROW_REGISTERS)
    pat = re.compile(r"(flash_fwd_(?:wide_)?kernel|flash_narrow_kernel|"
                     r"flash_wide_kernel|flash16_kernel)ILi(\d+)E(?:Li(\d+)E)?"
                     r"Lb(\d)E(f|13__nv_bfloat16|6__half|E)")
    dtypes = {"f": "f32", "E": "f32", "13__nv_bfloat16": "bf16",
              "6__half": "f16"}
    old_names = {"flash_fwd_kernel": " (old narrow)",
                 "flash_fwd_wide_kernel": " (old wide)"}

    def key(name):
        m = pat.search(name)
        return m and (f"{'16-bit' if m.group(1) == 'flash16_kernel' else 'f32'}"
                      f" ND {m.group(2)}{old_names.get(m.group(1), '')}"
                      f"{f' (wide, V {m.group(3)})' if m.group(3) else ''}, "
                      f"{'vector' if m.group(4) == '1' else 'single'} "
                      f"loads, {dtypes[m.group(5)]}")
    out = {key(name): dict(r) for name, r in ptxas_report().items()
           if key(name)}
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    dump = subprocess.run([str(cuobjdump), "-sass", str(build.library_path())],
                          capture_output=True, text=True, timeout=120)
    if dump.returncode != 0:
        fail(f"cuobjdump failed: {dump.stderr.strip()[:200]}")
    for part in dump.stdout.split("Function : ")[1:]:
        name = key(part.split("\n", 1)[0])
        if name:
            lines = [ln for ln in part.splitlines() if "HMMA" in ln]
            r = out.setdefault(name, {})
            r["hmma_tf32"] = sum(".TF32" in ln for ln in lines)
            r["hmma_16"] = sum("HMMA.16816" in ln for ln in lines)
    old16 = [n for n in out if n.startswith("f32") and not n.endswith("f32")]
    if old16:
        fail(f"16-bit instantiations of the f32 prefill kernels are left in "
             f"the library: {old16}")
    old = [n for n in out if "(old " in n]
    if old:
        fail(f"instantiations of the old f32 kernels are left in the "
             f"library: {old}")
    wide = sorted(n for n in out if "(wide" in n)
    if len(out) != 44 or wide != [
            f"f32 ND {nd} (wide, V {nv}), {c} loads, f32"
            for nd, nv in ((24, 16), (24, 24), (32, 32))
            for c in ("single", "vector")]:
        fail(f"expected 44 prefill kernel instantiations (f32: ND 4, 8, 10, "
             f"16, 20 narrow, ND / V 24 / 16, 24 / 24 and 32 / 32 wide; the "
             f"seven at bf16 and f16; each with both copies), found "
             f"{sorted(out)}")
    for name, r in sorted(out.items()):
        say(f"prefill kernel {name}: {r.get('hmma_tf32')} HMMA .TF32 and "
            f"{r.get('hmma_16')} HMMA.16816 in its SASS, "
            f"{r.get('registers')} registers, {r.get('spill_bytes')} bytes "
            f"spilled")
        kind = "hmma_16" if name.startswith("16") else "hmma_tf32"
        if not r.get(kind):
            fail(f"prefill kernel {name}: no {kind[5:]} HMMA in its SASS")
        if r.get("spill_bytes") != 0:
            fail(f"prefill kernel {name}: {r.get('spill_bytes')} bytes of "
                 f"register spills")
        nd = int(name.split()[2].rstrip(","))
        if name.startswith("f32") and "(wide" not in name \
                and r.get("registers", 0) > F32_NARROW_REGISTERS[nd]:
            fail(f"prefill kernel {name}: {r.get('registers')} registers, "
                 f"over the {F32_NARROW_REGISTERS[nd]} the plan counts "
                 f"(F32_NARROW_REGISTERS)")
    return out


def prefill_instantiation(report, Dh, Dv, dtype_name, vec=True):
    """The build report's entry for the instantiation a call of these
    widths at `dtype_name` ("f32", "bf16", "f16") launches."""
    from repro_torch.kernels.flash_attention.kernel import (
        F32_WIDE, prefill_v_width, prefill_width)
    nd = prefill_width(Dh, Dv)
    kind = "f32" if dtype_name == "f32" else "16-bit"
    wide = (f" (wide, V {prefill_v_width(nd, Dv, 4)})"
            if kind == "f32" and nd >= F32_WIDE else "")
    name = (f"{kind} ND {nd}{wide}, {'vector' if vec else 'single'} loads, "
            f"{dtype_name}")
    return name, report.get(name, {})


def prefill_16_accuracy(torch, label, q, k, v, got, dtype, **kw):
    """half_err of the 16-bit kernel's output `got` against plain, and the
    share of values in which the f32 kernel's output on the widened
    inputs, rounded once to `dtype`, differs from plain; fails if the
    16-bit kernel's share passes that by more than 0.5 percentage points
    (the f32 kernel's accuracy kept)."""
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    L = kw["kv_len"]
    want = ref.attention(q, k[:, :L], v[:, :L], causal=kw["causal"],
                         sliding_window=kw["sliding_window"],
                         softcap=kw["softcap"], scale=kw["scale"])
    err = half_err(torch, label, got, want, dtype)
    f32 = flash_attention_fwd(q.float(), k.float(), v.float(), **kw)
    share32 = half_err(torch, f"{label} (f32 kernel)", f32.to(dtype), want,
                       dtype)["differ_share"]
    if err["differ_share"] > share32 + DIFFER_MARGIN:
        fail(f"{label}: {err['differ_share']:.4f} of the 16-bit kernel's "
             f"values differ from plain, the f32 kernel's {share32:.4f} "
             f"(+ {DIFFER_MARGIN})")
    return dict(err, f32_kernel_differ_share=share32)


def mma_tf32_rate(torch):
    """TF32 flop/s of mma.sync m16n8k8 on this card (csrc/mma_probe.cu:
    8 warps a block, 2 blocks an SM, 8 independent accumulators a warp),
    timed with CUDA events after one warm-up launch."""
    from repro_torch.kernels.build import check, current_stream, library
    lib = library()
    out = torch.zeros(1, device="cuda")
    blocks, warps, iters = 2 * SMS, 8, 4096

    def run():
        check(lib.sfp_mma_probe(out.data_ptr(), blocks, warps, iters,
                                current_stream()), "sfp_mma_probe")
    run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return blocks * warps * iters * 8 * 2048 / (start.elapsed_time(end) * 1e-3)


def prefill_bounds(nbytes, flops):
    """(bound at the 3xTF32 rate, the fp32-pipe bound beside it)."""
    return bound(nbytes, flops, TF32X3_FLOPS), bound(nbytes, flops)


def check_prefill(torch, F, gen, results):
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    B, Hq, Hkv, Dh = 1, 40, 8, 128
    scale = Dh ** -0.5

    def inputs(S):
        return (torch.randn((B, S, Hq, Dh), generator=gen, device="cuda"),
                torch.randn((B, S, Hkv, Dh), generator=gen, device="cuda"),
                torch.randn((B, S, Hkv, Dh), generator=gen, device="cuda"))

    worst = 0.0
    cases = [(37, None, None, 37), (132, None, None, 132),
             (260, None, None, 260), (260, 64, 50.0, 201), (260, 64, 50.0, 37)]
    for S, window, softcap, kv_len in cases:
        q, k, v = inputs(S)
        got = flash_attention_fwd(q, k, v, causal=True, sliding_window=window,
                                  softcap=softcap, scale=scale, kv_len=kv_len)
        want = ref.attention(q, k[:, :kv_len], v[:, :kv_len], causal=True,
                             sliding_window=window, softcap=softcap,
                             scale=scale)
        err = float((got - want).abs().max())
        if not (torch.isfinite(got).all() and err <= ATTN_TOL):
            fail(f"prefill S={S} window={window} softcap={softcap} "
                 f"kv_len={kv_len}: max|kernel - plain| = {err:.3g} "
                 f"> {ATTN_TOL}")
        worst = max(worst, err)
        say(f"prefill: S={S} window={window} softcap={softcap} "
            f"kv_len={kv_len}: max abs err {err:.3g}")

    worst = max(worst, check_prefill_cases(torch, gen))
    instantiations = prefill_build_report()
    mma_rate = mma_tf32_rate(torch)
    say(f"mma.sync m16n8k8 TF32 on this card: {mma_rate / 1e12:.1f} "
        f"TFLOP/s, so {mma_rate / 3e12:.1f} TFLOP/s of 3xTF32 work, against "
        f"the {TF32X3_FLOPS / 1e12:.1f} of wgmma's 495 that the bounds use")

    S = 132   # the main path's longest prompt (128 tokens + 4 soft prompt)
    per = (B * S * (Hq + 2 * Hkv) * Dh + B * S * Hq * Dh) * 4
    sets = [inputs(S) for _ in range(n_copies(per))]
    t_k = time_ms([lambda s=s: flash_attention_fwd(
        *s, causal=True, sliding_window=None, softcap=None, scale=scale,
        kv_len=S) for s in sets])
    t_p = time_ms([lambda s=s: ref.attention(*s, causal=True, scale=scale)
                   for s in sets])
    lib = [(q.transpose(1, 2).contiguous(),
            k.repeat_interleave(Hq // Hkv, 2).transpose(1, 2).contiguous(),
            v.repeat_interleave(Hq // Hkv, 2).transpose(1, 2).contiguous())
           for q, k, v in sets]
    sdpa = [lambda s=s: F.scaled_dot_product_attention(
        *s, is_causal=True, scale=scale) for s in lib]
    t_l = time_ms(sdpa)
    d_k = device_ms([lambda s=s: flash_attention_fwd(
        *s, causal=True, sliding_window=None, softcap=None, scale=scale,
        kv_len=S) for s in sets])
    d_l = device_ms(sdpa)
    flops = _prefill_pairs(S, S, None) * B * Hq * 4 * Dh
    b, b32 = prefill_bounds(per, flops)
    picked, efficient = sdpa_backends(torch, F, lib[0], True, scale)
    say(f"prefill: q ({B}, {S}, {Hq}, {Dh}), kv {Hkv} heads, causal: kernel "
        f"{t_k:.4f} ms ({d_k:.4f} on the device), plain {t_p:.4f} ms, SDPA "
        f"{t_l:.4f} ms ({d_l:.4f}), bound {b[0]:.5f} ms ({b[1]}, 3xTF32), "
        f"fp32-pipe bound {b32[0]:.5f} ms; SDPA ran {picked}, which "
        f"{'matches' if picked == efficient else 'differs from'} "
        f"EFFICIENT_ATTENTION's {efficient}")
    results["flash_attention_prefill"] = dict(
        max_abs_err=worst, ms=t_k, plain_ms=t_p, bound_ms=b[0],
        bound_by=b[1], bound_fp32_ms=b32[0], library_ms=t_l,
        device_ms=d_k, library_device_ms=d_l,
        sdpa_kernels=picked, sdpa_is_efficient=picked == efficient,
        instantiations=instantiations, mma_tf32_flops=mma_rate,
        shape=f"q ({B}, {S}, {Hq}, {Dh}), kv ({B}, {S}, {Hkv}, {Dh}), causal",
        vit_shape=prefill_shape(torch, F, gen, "ViT shape", 16, 12, 64,
                                False, (213,)),
        hd80_shape=prefill_shape(torch, F, gen, "head_dim 80", 1, 32, 80,
                                 True, (37, 132)))


def prefill_launch_shapes() -> dict:
    """The prefill kernel's launches since the last reset_launches, by call
    shape (flash_attention_fwd.shapes, which main() turns on; none for a
    checkout from before the count)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    out = {}
    for (B, Sq, Skv, Hq, Hkv, Dh, Dv, causal, kv_len), n in sorted(
            (getattr(flash_attention_fwd, "shapes", None) or {}).items()):
        heads = f"{Hq}" if Hq == Hkv else f"{Hq} / {Hkv}"
        dims = f"{Dh}" if Dh == Dv else f"{Dh} / {Dv}"
        key = (f"({B}, {Sq}, {heads} x {dims}) over {Skv}"
               f"{', causal' if causal else ''}"
               f"{f', kv_len {kv_len}' if kv_len != Skv else ''}")
        out[key] = out.get(key, 0) + n
    return out


def prefill_blocks(plan, B, Sq, Hq):
    """Blocks a prefill plan launches for (B, Sq, Hq) queries: the narrow
    f32 layout's ceil(Sq / (rows / group)) x Hq / group x B x splits, the
    others' ceil(Sq / rows) x Hq x B."""
    return (-(-Sq // (plan.rows // plan.group)) * (Hq // plan.group) * B
            * plan.splits)


def prefill_shape(torch, F, gen, label, B, H, Dh, causal, lengths,
                  Hkv=None, softcap=None, q_len=None, Dv=None):
    """An extra shape of the prefill kernel, not a kernel record: held
    against plain at each of `lengths` (kv_len = S), timed at the last
    beside plain, SDPA and the bound. The training path's (ViT-Base
    scoring and evaluation: non-causal, B 16, S 213 = 196 patches + CLS +
    16 prompt, 12 heads of 64), zamba2's shared attention block (causal,
    32 heads of 80, at the hybrid path's longest prefill of 132 and an odd
    length), the wide families' (H query heads over Hkv kv heads, with
    gemma2's softcap: SDPA, which has none, is timed without it), and
    Whisper's cross-attention: `q_len` queries over S keys, non-causal;
    values `Dv` wide where they are narrower than the keys (MLA's)."""
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, prefill_plan)
    scale = Dh ** -0.5
    Hkv = Hkv or H
    Dv = Dv or Dh
    if q_len is not None and causal:
        fail(f"prefill {label}: q_len is for non-causal calls")

    def inputs(S):
        return tuple(torch.randn((B, n, h, d), generator=gen, device="cuda")
                     for n, h, d in ((q_len or S, H, Dh), (S, Hkv, Dh),
                                     (S, Hkv, Dv)))

    worst = 0.0
    for S in lengths:
        q, k, v = inputs(S)
        got = flash_attention_fwd(q, k, v, causal=causal,
                                  sliding_window=None, softcap=softcap,
                                  scale=scale, kv_len=S)
        err = float((got - ref.attention(q, k, v, causal=causal,
                                         softcap=softcap, scale=scale))
                    .abs().max())
        if not (torch.isfinite(got).all() and err <= ATTN_TOL):
            fail(f"prefill {label} S={S}: max|kernel - plain| = {err:.3g} "
                 f"> {ATTN_TOL}")
        worst = max(worst, err)
    S = lengths[-1]
    Sq = q_len or S
    per = (B * Sq * H + B * S * Hkv) * (Dh + Dv) * 4
    sets = [inputs(S) for _ in range(n_copies(per))]
    kernel = [lambda s=s: flash_attention_fwd(
        *s, causal=causal, sliding_window=None, softcap=softcap, scale=scale,
        kv_len=S) for s in sets]
    t_k = time_ms(kernel)
    t_p = time_ms([lambda s=s: ref.attention(*s, causal=causal,
                                             softcap=softcap, scale=scale)
                   for s in sets])
    lib = [(q.transpose(1, 2).contiguous(),
            k.repeat_interleave(H // Hkv, 2).transpose(1, 2).contiguous(),
            v.repeat_interleave(H // Hkv, 2).transpose(1, 2).contiguous())
           for q, k, v in sets]
    sdpa = [lambda s=s: F.scaled_dot_product_attention(
        *s, is_causal=causal, scale=scale) for s in lib]
    t_l = time_ms(sdpa)
    d_k = device_ms(kernel)
    d_l = device_ms(sdpa)
    pairs = _prefill_pairs(S, S, None) if causal else Sq * S
    b, b32 = prefill_bounds(per, B * H * pairs * 2 * (Dh + Dv))
    kind = "causal" if causal else "non-causal"
    picked, efficient = sdpa_backends(torch, F, lib[0], causal, scale)
    heads = f"{H}" if Hkv == H else f"{H} / {Hkv}"
    heads += "" if Dv == Dh else f", v {Dv}"
    cap = f", softcap {softcap} (SDPA without)" if softcap else ""
    same = "matches" if picked == efficient else "differs from"
    kv = "" if Sq == S else f" over {S} keys"
    plan = prefill_plan(B, Sq, H, Dh, Dv, 4, SMS, Hkv=Hkv, kv_len=S)
    blocks = prefill_blocks(plan, B, Sq, H)
    say(f"prefill {label}: q ({B}, {Sq}, {heads}, {Dh}){kv} {kind}{cap}: "
        f"max abs err {worst:.3g}; kernel {t_k:.4f} ms ({d_k:.4f} on the "
        f"device), plain {t_p:.4f} ms, SDPA {t_l:.4f} ms ({d_l:.4f}), bound "
        f"{b[0]:.5f} ms ({b[1]}, 3xTF32), fp32-pipe bound {b32[0]:.5f} ms; "
        f"plan {plan.rows} rows, {plan.splits} splits, group "
        f"{plan.group}, {blocks} blocks, {plan.blocks_per_sm} an "
        f"SM ({blocks / (SMS * plan.blocks_per_sm):.2f} waves); SDPA ran "
        f"{picked} ({same} EFFICIENT_ATTENTION)")
    del lib, sdpa, sets
    return dict(shape=f"q ({B}, {Sq}, {H}, {Dh}), k, v ({B}, {S}, {Hkv}, "
                      f"{Dh} / {Dv}), {kind}{cap}",
                plan_rows=plan.rows, plan_splits=plan.splits,
                plan_group=plan.group, plan_blocks=blocks,
                blocks_per_sm=plan.blocks_per_sm,
                max_abs_err=worst, ms=t_k, plain_ms=t_p, library_ms=t_l,
                device_ms=d_k, library_device_ms=d_l,
                bound_ms=b[0], bound_by=b[1], bound_fp32_ms=b32[0],
                sdpa_kernels=picked, sdpa_is_efficient=picked == efficient)


def check_prefill_wide(torch, F, gen, results):
    """The wide instantiations at the wide families' batch-1 causal prefill
    (S 37 and 132: the paths' longest prompt of 128 + 4), deepseek-v3's
    MLA prefill at its 128 heads (q/k 192, v 128, G 1: the mla path's), and
    values narrower than the keys (Dh 192, Dv 128) with a window and a
    softcap, against plain."""
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    rec = results["flash_attention_prefill"]
    rec["wide"] = {label: prefill_shape(
        torch, F, gen, label, 1, Hq, Dh, True, (37, 132), Hkv=Hkv,
        softcap=50.0 if label == "gemma2-9b" else None)
        for label, Hq, Hkv, Dh in WIDE_SHAPES}
    rec["wide"]["deepseek-v3 MLA 128 heads 192 / 128"] = prefill_shape(
        torch, F, gen, "deepseek-v3 MLA", 1, 128, 192, True, (37, 132),
        Dv=128)
    q = torch.randn((2, 77, 24, 192), generator=gen, device="cuda")
    k = torch.randn((2, 77, 2, 192), generator=gen, device="cuda")
    v = torch.randn((2, 77, 2, 128), generator=gen, device="cuda")
    got = flash_attention_fwd(q, k, v, causal=True, sliding_window=16,
                              softcap=50.0, scale=192 ** -0.5, kv_len=77)
    err = float((got - ref.attention(q, k, v, sliding_window=16,
                                     softcap=50.0)).abs().max())
    if not (torch.isfinite(got).all() and err <= ATTN_TOL):
        fail(f"prefill Dh 192, Dv 128: max|kernel - plain| = {err:.3g} > "
             f"{ATTN_TOL}")
    say(f"prefill Dh 192 / Dv 128 (2, 77, 24 / 2 heads, window 16, softcap "
        f"50): max abs err {err:.3g}")
    rec["wide"]["Dh 192, Dv 128"] = dict(max_abs_err=err)
    rec["max_abs_err"] = max(rec["max_abs_err"], err, *(
        r["max_abs_err"] for r in rec["wide"].values()))


def decode_case(torch, gen, B, W, Hq, Hkv, Dh, lengths, wrap_slot=None,
                Dv=None):
    """Ring caches: slot b holds lengths[b] tokens (0 = empty, all -1); the
    `wrap_slot` has run past W so its ring has wrapped. Values are Dv wide
    (default Dh)."""
    q = torch.randn((B, 1, Hq, Dh), generator=gen, device="cuda")
    k = torch.randn((B, W, Hkv, Dh), generator=gen, device="cuda")
    v = torch.randn((B, W, Hkv, Dv or Dh), generator=gen, device="cuda")
    kvp = torch.full((B, W), -1, dtype=torch.int32)
    qp = torch.zeros((B,), dtype=torch.int32)
    for b, n in enumerate(lengths):
        if b == wrap_slot:
            total = W + n                      # ring wrapped: positions
            pos = torch.arange(total - W, total, dtype=torch.int32)
            kvp[b, pos % W] = pos              # total-W .. total-1 at pos % W
            qp[b] = total - 1
        elif n:
            kvp[b, :n] = torch.arange(n, dtype=torch.int32)
            qp[b] = n - 1
    return q, k, v, qp.cuda(), kvp.cuda()


def check_decode(torch, F, gen, results):
    results["decode_attention"] = decode_record(torch, F, gen, 40, 8, 128)
    results["decode_attention"]["hd80_shape"] = decode_record(
        torch, F, gen, 32, 32, 80)
    # the split sweep at gemma2's shape tells whether filling the SMs' one
    # resident block a wave (S 3) beats fewer, longer splits there
    results["decode_attention"]["wide"] = {
        label: decode_record(torch, F, gen, Hq, Hkv, Dh,
                             sweep=label == "gemma2-9b")
        for label, Hq, Hkv, Dh in WIDE_SHAPES}
    # deepseek-v3's MLA decode: 128 heads, each its own kv head (G 1),
    # keys of 192 (nope 128 + rope 64) and values of 128, scale 192^-0.5
    results["decode_attention"]["wide"]["deepseek-v3 MLA"] = decode_record(
        torch, F, gen, 128, 128, 192, sweep=False, Dv=128)
    results["decode_attention"]["ptxas"] = decode_build_report()


def decode_build_report():
    """Registers and spill bytes of each instantiation of the two decode
    kernels (shape (kD, kR), copies, K/V dtype) and of their shared
    combine, from the ptxas report."""
    pat = re.compile(r"\d+(paged_decode_kernel|decode_combine_kernel|"
                     r"decode_kernel)(ILi(\d+)ELi(\d+)ELb(\d)E"
                     r"(f|13__nv_bfloat16|6__half))?")
    out = {}
    for name, r in ptxas_report().items():
        m = pat.search(name)
        if m:
            shape = f" ({m.group(3)}, {m.group(4)})" if m.group(3) else ""
            copies = {"1": ", vector copies", "0": ", single copies"}
            kv = {"f": ", f32 K/V", "13__nv_bfloat16": ", bf16 K/V",
                  "6__half": ", f16 K/V"}
            out[m.group(1) + shape + copies.get(m.group(5), "")
                + kv.get(m.group(6), "")] = r
    for name, r in sorted(out.items()):
        say(f"decode ptxas: {name}: {r.get('registers')} registers, "
            f"{r.get('spill_bytes')} bytes spilled")
        if r.get("spill_bytes") != 0:
            fail(f"decode kernel {name}: {r.get('spill_bytes')} bytes of "
                 f"register spills")
    if len(out) != 49:
        fail(f"expected 49 decode kernel functions in the build (2 kernels "
             f"x 4 shapes x copies x 3 K/V dtypes, and the combine), found "
             f"{sorted(out)}")
    return out


def slot_tiles(torch, qp, kvp, window=None):
    """(slot, 32-key tile) pairs of ring caches that hold a valid key (the
    tiles the dense decode kernel scores), and the slots with none (whose
    rows it folds from V alone)."""
    valid = (kvp >= 0) & (kvp <= qp[:, None])
    if window is not None:
        valid &= kvp > qp[:, None] - window
    pad = -valid.shape[1] % 32
    tiles = torch.nn.functional.pad(valid, (0, pad)).reshape(
        valid.shape[0], -1, 32).any(-1)
    return int(tiles.sum()), int((~valid.any(-1)).sum())


def decode_record(torch, F, gen, Hq, Hkv, Dh, sweep=True, Dv=None,
                  lengths=None, W=512):
    """The decode kernel against plain at 8 slots of 512 (one wrapped ring,
    two empty slots), with and without window and softcap, and with a
    window across the seam of a ring wrapped 8 past W; then timed, by
    events and on the device beside SDPA, and (`sweep`) on the device at
    every split count (each checked against plain): Qwen2.5-14B's (40, 8,
    128), zamba2's shared block (32, 32, 80), the wide shapes and
    deepseek-v3's MLA (128, 128, 192 with values of `Dv` 128). `lengths`
    (a slot each, W wide) replaces the 8 slots: a rank's block of slots
    (phase 24), no ring wrapped."""
    from repro_torch.kernels.flash_attention import decode
    from repro_torch.kernels.flash_attention.decode import (
        decode_attention_fwd, decode_blocks_per_sm, decode_splits,
        grouped_decode, sm_count)
    wrap = None if lengths else 7
    lengths = lengths or [37, 0, 512, 200, 0, 1, 333, 100]
    B = len(lengths)
    G = Hq // Hkv
    Dv = Dv or Dh
    scale = Dh ** -0.5
    cases = [(None, None, lengths), (64, 50.0, lengths)]
    if wrap is not None:
        # slot 7 wrapped 8 past W: a window of 16 keeps keys 504..511 and
        # 0..7
        cases.append((16, None, lengths[:7] + [8]))
    worst = 0.0
    for window, softcap, lens in cases:
        args = decode_case(torch, gen, B, W, Hq, Hkv, Dh, lens,
                           wrap_slot=wrap, Dv=Dv)
        got = decode_attention_fwd(*args, scale=scale,
                                   sliding_window=window, softcap=softcap)
        want = grouped_decode(*args, scale=scale, sliding_window=window,
                              softcap=softcap)
        err = float((got - want).abs().max())
        if not (torch.isfinite(got).all() and err <= ATTN_TOL):
            fail(f"decode Hq={Hq} Hkv={Hkv} Dh={Dh} Dv={Dv} window={window} "
                 f"softcap={softcap} lengths={lens}: max|kernel - plain| = "
                 f"{err:.3g} > {ATTN_TOL}")
        worst = max(worst, err)
        tiles, idle = slot_tiles(torch, *args[3:], window)
        say(f"decode: B={B} W={W} G={G} Dh={Dh} Dv={Dv} lengths={lens} "
            f"(wrapped: slot {wrap}) window={window} softcap={softcap}: "
            f"{tiles} valid tiles of {B * W // 32}, {idle} idle slots; max "
            f"abs err {err:.3g}")

    q, k, v, qp, kvp = decode_case(torch, gen, B, W, Hq, Hkv, Dh, lengths,
                                   wrap_slot=wrap, Dv=Dv)
    n_valid = int(((kvp >= 0) & (kvp <= qp[:, None])).sum())
    tiles, idle = slot_tiles(torch, qp, kvp)
    del q, k, v, qp, kvp
    # bytes the function must move: q, out, the valid entries' K/V, every
    # value of an idle slot (its answer is their mean), the positions
    nbytes = ((B * Hq * (Dh + Dv) + n_valid * Hkv * (Dh + Dv)
               + idle * W * Hkv * Dv) * 4 + B * W * 4 + B * 4)
    flops = n_valid * Hq * 2 * (Dh + Dv) + idle * W * Hq * Dv
    b = bound(nbytes, flops)
    per = (B * W * Hkv * (Dh + Dv) + B * Hq * (Dh + Dv)) * 4 + B * W * 4
    sets = [decode_case(torch, gen, B, W, Hq, Hkv, Dh, lengths,
                        wrap_slot=wrap, Dv=Dv) for _ in range(n_copies(per))]
    kernel = [lambda s=s: decode_attention_fwd(
        *s, scale=scale, sliding_window=None, softcap=None) for s in sets]
    t_k = time_ms(kernel)
    t_p = time_ms([lambda s=s: grouped_decode(
        *s, scale=scale, sliding_window=None, softcap=None) for s in sets])
    lib = []
    for q, k, v, qp, kvp in sets:
        mask = ((kvp >= 0) & (kvp <= qp[:, None]))[:, None, None, :]
        lib.append((q.transpose(1, 2).contiguous(),
                    k.repeat_interleave(G, 2).transpose(1, 2).contiguous(),
                    v.repeat_interleave(G, 2).transpose(1, 2).contiguous(),
                    mask))
    sdpa = [lambda s=s: F.scaled_dot_product_attention(
        s[0], s[1], s[2], attn_mask=s[3], scale=scale) for s in lib]
    t_l = time_ms(sdpa)
    # device time (kernel + combine) beside the event time, which at this
    # size is mostly the wrapper's host time
    d_k = device_ms(kernel)
    d_l = device_ms(sdpa)
    del lib, sdpa
    splits = decode_splits(B, Hkv, W, sm_count(torch.cuda.current_device()),
                           decode_blocks_per_sm(Dh, Dv, G))
    # device time at every split count, each forced by standing in for
    # decode_splits and checked against plain
    by_splits = {}
    try:
        for S in range(1, 9) if sweep else ():
            decode.decode_splits = lambda *shape, S=S: S
            got = decode_attention_fwd(*sets[0], scale=scale,
                                       sliding_window=None, softcap=None)
            err = float((got - grouped_decode(
                *sets[0], scale=scale, sliding_window=None,
                softcap=None)).abs().max())
            if not (torch.isfinite(got).all() and err <= ATTN_TOL):
                fail(f"decode Dh={Dh} at {S} splits: max|kernel - plain| = "
                     f"{err:.3g} > {ATTN_TOL}")
            worst = max(worst, err)
            by_splits[S] = device_ms(kernel)
    finally:
        decode.decode_splits = decode_splits
    if sweep:
        say(f"decode (G {G}, Dh {Dh}) device ms by splits: " + ", ".join(
            f"S {S} {ms:.4f}" for S, ms in by_splits.items()))
    say(f"decode timed: q ({B}, 1, {Hq}, {Dh}), cache ({B}, {W}, {Hkv}, "
        f"{Dh} / {Dv}), {splits} splits a row, {tiles} valid tiles of "
        f"{B * W // 32} and {idle} idle slots (x {Hkv} kv heads): kernel "
        f"{t_k:.4f} ms ({d_k:.4f} on the device), plain {t_p:.4f} ms, SDPA "
        f"{t_l:.4f} ms ({d_l:.4f}), bound {b[0]:.5f} ms ({b[1]})")
    return dict(
        max_abs_err=worst, ms=t_k, plain_ms=t_p, bound_ms=b[0],
        bound_by=b[1], library_ms=t_l, device_ms=d_k,
        library_device_ms=d_l, splits=splits, valid_tiles=tiles,
        idle_slots=idle, device_ms_by_splits=by_splits,
        shape=f"q ({B}, 1, {Hq}, {Dh}), cache ({B}, {W}, {Hkv}, {Dh}"
              f"{'' if Dv == Dh else f' / {Dv}'}), {n_valid} valid "
              f"entries, {idle} idle slots")


def paged_case(torch, gen, lengths, page, nb, P, Hq=40, Hkv=8, Dh=128):
    """A page pool as the paged engine leaves it: slot b owns
    ceil(lengths[b] / page) shuffled, non-contiguous pages holding
    positions 0..lengths[b]-1, NULL (page 0) table entries past them and
    stale positions past its length on its last page; a slot of length 0
    is idle, every block at SCRATCH (page 1); a slot of length None is
    fully masked, every block at NULL (positions -1), query position 0."""
    import numpy as np
    B = len(lengths)
    rng = np.random.default_rng(sum(n or 0 for n in lengths) + page)
    perm = rng.permutation(np.arange(2, P))
    kvp = np.full((P, page), -1, np.int32)
    kvp[1] = rng.integers(0, 4, page)            # scratch: garbage
    tables = np.zeros((B, nb), np.int32)
    used = 0
    for b, n in enumerate(lengths):
        if n is None:
            continue
        if n == 0:
            tables[b] = 1
            continue
        for j in range(-(-n // page)):
            pid = perm[used]
            used += 1
            tables[b, j] = pid
            m = min(page, n - j * page)
            kvp[pid, :m] = j * page + np.arange(m)
            kvp[pid, m:] = 10 ** 6
    if used > P - 2:
        raise ValueError(f"{used} pages do not fit a pool of {P}")
    q = torch.randn((B, 1, Hq, Dh), generator=gen, device="cuda")
    k = torch.randn((P, page, Hkv, Dh), generator=gen, device="cuda")
    v = torch.randn((P, page, Hkv, Dh), generator=gen, device="cuda")
    qp = torch.tensor([max((n or 0) - 1, 0) for n in lengths],
                      dtype=torch.int32)
    return (q, k, v, torch.from_numpy(tables).cuda(), qp.cuda(),
            torch.from_numpy(kvp).cuda())


def valid_tiles(torch, tables, qp, kvp, window=None):
    """32-key tiles of the slots' tables that hold a valid key: the tiles
    the paged kernel visits (it walks every tile of a row with none)."""
    pos = kvp[tables.long()].reshape(tables.shape[0], -1)
    return slot_tiles(torch, qp, pos, window)[0]


def check_paged_decode(torch, F, gen, results):
    results["paged_decode_attention"] = paged_record(torch, F, gen, 40, 8,
                                                     128)
    results["paged_decode_attention"]["wide"] = {
        label: paged_record(torch, F, gen, Hq, Hkv, Dh, sweep=False)
        for label, Hq, Hkv, Dh in WIDE_SHAPES}


def paged_record(torch, F, gen, Hq, Hkv, Dh, sweep=True):
    """The paged decode kernel against plain at 16 slots of page 16 (and
    of page 8 with window and softcap, and with a fully masked row), then
    timed by events and on the device beside plain, the dense decode
    kernel on the same data gathered and SDPA, and (`sweep`) on the device
    at split counts 1-8: Qwen2.5-14B's (40, 8, 128) and the wide
    shapes."""
    from repro_torch.kernels.flash_attention.decode import (
        decode_attention_fwd, decode_blocks_per_sm, paged_decode_attention_fwd,
        decode_splits, paged_gather_decode, sm_count)
    G = Hq // Hkv
    scale = Dh ** -0.5
    # 16 slots, ragged 1..512 tokens, slot 4 idle: 119 of the 128 usable
    # pages of 16 tokens
    lengths = [1, 512, 37, 200, 0, 129, 16, 17, 300, 64, 5, 96, 250, 33, 128,
               9]
    # the same with slot 10 fully masked (all NULL): the mean of every value
    masked = lengths[:10] + [None] + lengths[11:]
    cases = [(lengths, 16, 32, 130, None, None),
             (lengths, 8, 64, 2 + 240, 64, 50.0),
             (masked, 16, 32, 130, None, None)]
    worst = 0.0
    for lens, page, nb, P, window, softcap in cases:
        args = paged_case(torch, gen, lens, page, nb, P, Hq, Hkv, Dh)
        got = paged_decode_attention_fwd(*args, scale=scale,
                                         sliding_window=window,
                                         softcap=softcap)
        want = paged_gather_decode(*args, scale=scale, sliding_window=window,
                                   softcap=softcap)
        err = float((got - want).abs().max())
        for b in (b for b, n in enumerate(lens) if n is None):
            mean = args[2][0].mean(0).repeat_interleave(G, 0)
            err = max(err, float((got[b, 0] - mean).abs().max()))
        if not (torch.isfinite(got).all() and err <= ATTN_TOL):
            fail(f"paged decode page={page} window={window} "
                 f"softcap={softcap} lengths={lens}: max|kernel - plain| = "
                 f"{err:.3g} > {ATTN_TOL}")
        worst = max(worst, err)
        say(f"paged decode: 16 slots, page {page}, nb {nb}, pool {P} pages, "
            f"G={G}, Dh={Dh}, lengths 1..512 + an idle scratch row"
            f"{' + a fully masked row' if None in lens else ''}, "
            f"window={window} softcap={softcap}, "
            f"{valid_tiles(torch, *args[3:], window)} valid tiles of "
            f"{16 * -(-nb * page // 32)}: max abs err {err:.3g}")

    page, nb, P = 16, 32, 130
    B, W = len(lengths), nb * page
    n_valid = sum(lengths)
    splits = decode_splits(B, Hkv, W, sm_count(torch.cuda.current_device()),
                           decode_blocks_per_sm(Dh, Dh, G))
    # bytes the kernel must move: q, out, the valid entries' K/V and
    # positions, the tables and query positions
    nbytes = ((B * Hq * Dh * 2 + n_valid * Hkv * Dh * 2) * 4 + n_valid * 4
              + B * nb * 4 + B * 4)
    sets = [paged_case(torch, gen, lengths, page, nb, P, Hq, Hkv, Dh)
            for _ in range(n_copies(nbytes))]
    t_k = time_ms([lambda s=s: paged_decode_attention_fwd(
        *s, scale=scale, sliding_window=None, softcap=None) for s in sets])
    t_p = time_ms([lambda s=s: paged_gather_decode(
        *s, scale=scale, sliding_window=None, softcap=None) for s in sets])
    # the same data gathered into dense per-slot caches: the library
    # yardstick runs on it, and so does the dense decode kernel, which
    # tells the cost of the page indirection apart from the slot count
    dense = []
    for q, k, v, tables, qp, kvp in sets:
        bt = tables.long()
        dense.append((q, k[bt].reshape(B, W, Hkv, Dh),
                      v[bt].reshape(B, W, Hkv, Dh), qp,
                      kvp[bt].reshape(B, W)))
    t_d = time_ms([lambda s=s: decode_attention_fwd(
        *s, scale=scale, sliding_window=None, softcap=None) for s in dense])
    lib = []
    for q, kg, vg, qp, pg in dense:
        mask = ((pg >= 0) & (pg <= qp[:, None]))[:, None, None, :]
        lib.append((q.transpose(1, 2).contiguous(),
                    kg.repeat_interleave(Hq // Hkv, 2).transpose(1, 2)
                    .contiguous(),
                    vg.repeat_interleave(Hq // Hkv, 2).transpose(1, 2)
                    .contiguous(), mask))
    sdpa = [lambda s=s: F.scaled_dot_product_attention(
        s[0], s[1], s[2], attn_mask=s[3], scale=scale) for s in lib]
    t_l = time_ms(sdpa)
    # device time (kernel + combine) beside the event time, which at this
    # size is the wrapper's host time
    d_k = device_ms([lambda s=s: paged_decode_attention_fwd(
        *s, scale=scale, sliding_window=None, softcap=None) for s in sets])
    d_d = device_ms([lambda s=s: decode_attention_fwd(
        *s, scale=scale, sliding_window=None, softcap=None) for s in dense])
    d_l = device_ms(sdpa)
    del lib, dense, sdpa
    tiles = valid_tiles(torch, *sets[0][3:])
    # the split count against device time: decode_splits asks for the
    # smallest S that gives every SM the three blocks it holds; each S is
    # forced by standing in for it, and checked against plain
    from repro_torch.kernels.flash_attention import decode
    by_splits = {}
    try:
        for S in (1, 2, 3, 4, 6, 8) if sweep else ():
            decode.decode_splits = lambda *shape, S=S: S
            got = paged_decode_attention_fwd(*sets[0], scale=scale,
                                             sliding_window=None,
                                             softcap=None)
            err = float((got - paged_gather_decode(
                *sets[0], scale=scale, sliding_window=None,
                softcap=None)).abs().max())
            if not (torch.isfinite(got).all() and err <= ATTN_TOL):
                fail(f"paged decode at {S} splits: max|kernel - plain| = "
                     f"{err:.3g} > {ATTN_TOL}")
            by_splits[S] = device_ms([
                lambda s=s: paged_decode_attention_fwd(
                    *s, scale=scale, sliding_window=None, softcap=None)
                for s in sets])
    finally:
        decode.decode_splits = decode_splits
    if sweep:
        say("paged decode device ms by splits: " + ", ".join(
            f"S {S} {ms:.4f}" for S, ms in by_splits.items()))
    say(f"paged decode timing (G {G}, Dh {Dh}): {splits} splits a row, "
        f"{tiles} valid tiles "
        f"of {B * -(-W // 32)} (x {Hkv} kv heads): kernel {t_k:.4f} ms "
        f"({d_k:.4f} on the device), dense decode kernel on the same data "
        f"gathered {t_d:.4f} ms ({d_d:.4f}), plain {t_p:.4f} ms, SDPA "
        f"{t_l:.4f} ms ({d_l:.4f})")
    b = bound(nbytes, n_valid * Hq * 4 * Dh)
    return dict(
        max_abs_err=worst, ms=t_k, plain_ms=t_p, bound_ms=b[0],
        bound_by=b[1], library_ms=t_l, dense_kernel_same_data_ms=t_d,
        device_ms=d_k, library_device_ms=d_l,
        dense_kernel_same_data_device_ms=d_d, splits=splits,
        valid_tiles=tiles, device_ms_by_splits=by_splits,
        shape=f"q ({B}, 1, {Hq}, {Dh}), pool ({P}, {page}, {Hkv}, {Dh}), "
              f"tables ({B}, {nb}), {n_valid} valid entries")


def el2n_case(torch, gen, N, V, aligned=True, pad=3):
    """Logits (N, V) read through a row stride of V + `pad` (rows not
    16-byte aligned unless `aligned` and the stride allow it; pad 0: dense
    rows), labels with the first row at column 0 and the last at V - 1."""
    base = 3.0 * torch.randn((N, V + pad), generator=gen, device="cuda")
    logits = base[:, :V] if aligned else base[:, 1:V + 1]
    labels = torch.randint(0, V, (N,), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels[0], labels[-1] = 0, V - 1
    return logits, labels


def _el2n_err(torch, got, want):
    """max |got - want| and whether every element is within EL2N_TOL
    (1 + |want|)."""
    diff = (got - want).abs()
    return float(diff.max()), bool((diff <= EL2N_TOL * (1 + want.abs()))
                                   .all())


# The EL2N kernel's layouts forced at their boundaries (plan, N, V): the
# warp at V 100, at 1000 with 64-thread blocks and at its limit 1024; a
# block of 512 and of 256 threads one past it and at it; both at an LM
# vocabulary; a block whose threads mostly get no column
EL2N_PLAN_CASES = (
    (("warp", 256), 16, 100), (("warp", 256), 9, 1024),
    (("warp", 64), 5, 1000), (("block", 512), 9, 1025),
    (("block", 256), 7, 1024), (("block", 512), 16, 152064),
    (("block", 256), 3, 1025), (("block", 256), 64, 152064),
    (("block", 512), 4, 13))
# row forms (aligned, pad): dense rows; rows padded to a multiple of 8
# values (every row 16-byte aligned, V not a multiple of a load; pad None);
# a stride of V + 3 (row 0 aligned); that stride one value in
EL2N_ROW_FORMS = {"dense": (True, 0), "pad8": (True, None),
                  "stride+3": (True, 3), "offset": (False, 3)}
# the timed shapes: the ViT path's scoring batch, an LM batch, few rows of
# an LM vocabulary
EL2N_SHAPES = ((16, 100), (512, 152064), (16, 152064), (64, 152064))


def el2n_layouts(torch, gen, dtype):
    """Every EL2N_PLAN_CASES plan in every row form with `dtype` logits,
    then the plan `el2n_plan` picks on the same inputs, within EL2N_TOL of
    the one-pass plain form; near-certain rows, -inf logits and labels
    outside [0, V) in each layout, and a row of -inf alone giving NaN
    as the plain form does. Returns the largest error."""
    from repro_torch.kernels.el2n import ref
    from repro_torch.kernels.el2n.kernel import el2n_fwd
    worst = 0.0
    for plan, N, V in EL2N_PLAN_CASES:
        for form, (aligned, pad) in EL2N_ROW_FORMS.items():
            pad = (-V) % 8 + 8 if pad is None else pad
            logits, labels = el2n_case(torch, gen, N, V, aligned, pad)
            logits = logits.to(dtype)
            we, wc = ref.fused_scores(logits, labels)
            for p in (plan, None):
                e, c = el2n_fwd(logits, labels, p)
                errs = [_el2n_err(torch, e, we), _el2n_err(torch, c, wc)]
                if not all(good for _, good in errs) \
                        or e.dtype != torch.float32:
                    fail(f"el2n {dtype} plan {p} (picked for {plan}) N={N} "
                         f"V={V} {form}: max|kernel - plain| "
                         f"{[x for x, _ in errs]} beyond {EL2N_TOL}")
                worst = max(worst, *(x for x, _ in errs))
    for plan, V in ((("warp", 256), 50), (("block", 512), 1100),
                    (("block", 256), 50)):
        logits = torch.zeros((4, V), device="cuda")
        labels = torch.tensor([0, 7, V - 1, 20], dtype=torch.int32,
                              device="cuda")
        logits[torch.arange(4), labels.long()] = torch.tensor(
            [30.0, 40.0, 25.0, 60.0], device="cuda")
        logits[3, 30:40] = -torch.inf
        logits = logits.to(dtype)
        e, c = el2n_fwd(logits, labels, plan)
        we, wc = ref.fused_scores(logits, labels)
        if not ((e >= 0).all() and _el2n_err(torch, e, we)[1]
                and _el2n_err(torch, c, wc)[1]):
            fail(f"el2n {dtype} plan {plan} near-certain rows: "
                 f"{e.tolist()} vs {we.tolist()}")
        bad = torch.tensor([0, V, -1, 3], dtype=torch.int32, device="cuda")
        e, c = el2n_fwd(logits, bad, plan)
        if not (torch.isnan(e[1:3]).all() and torch.isnan(c[1:3]).all()
                and torch.isfinite(e[[0, 3]]).all()):
            fail(f"el2n {dtype} plan {plan}: labels outside [0, V) gave "
                 f"{e.tolist()}, {c.tolist()}")
        logits[1] = -torch.inf
        e, c = el2n_fwd(logits, labels, plan)
        we, wc = ref.fused_scores(logits, labels)
        if not (torch.isnan(torch.stack([e[1], c[1], we[1], wc[1]])).all()
                and _el2n_err(torch, e[[0, 2, 3]], we[[0, 2, 3]])[1]
                and _el2n_err(torch, c[[0, 2, 3]], wc[[0, 2, 3]])[1]):
            fail(f"el2n {dtype} plan {plan}: a row of -inf gave "
                 f"{e.tolist()}, {c.tolist()} against the plain form's "
                 f"{we.tolist()}, {wc.tolist()}")
    say(f"el2n {dtype}: {len(EL2N_PLAN_CASES)} plans x "
        f"{len(EL2N_ROW_FORMS)} row forms and the picked plan within "
        f"{EL2N_TOL} (largest error {worst:.3g}); near-certain rows, a "
        f"row of -inf and bad labels in each layout")
    return worst


def check_el2n(torch, F, gen, results):
    """The EL2N kernel against both plain forms at odd shapes, every layout
    at its boundaries (f32; check_bf16 and check_f16 repeat them at 16
    bits), then event and device times at EL2N_SHAPES, f32 and bf16 (the
    device times in one profiler session), each case's error on its own
    inputs, beside its bound, the plain forms at the path's and an LM
    batch's shapes and F.cross_entropy (CE only) at f32."""
    from repro_torch.kernels.el2n import ref
    from repro_torch.kernels.el2n.kernel import el2n_fwd, el2n_plan
    worst = 0.0
    cases = [(16, 100, True), (7, 1, True), (5, 13, True), (3, 1031, False),
             (64, 4099, False), (512, 152064, True), (16, 152064, False)]
    for N, V, aligned in cases:
        logits, labels = el2n_case(torch, gen, N, V, aligned)
        e, c = el2n_fwd(logits, labels)
        we, wc = ref.fused_scores(logits, labels)
        me, mc = ref.el2n_scores(logits, labels)
        errs = [_el2n_err(torch, e, we), _el2n_err(torch, c, wc),
                _el2n_err(torch, c, mc)]
        # the materialized EL2N only where p_y is not near 1: there the
        # one-pass identity cancels, up to about sqrt(1e-7)
        py = torch.softmax(logits, -1).gather(1, labels.long()[:, None])[:, 0]
        ok = py < 0.99
        if ok.any():
            errs.append(_el2n_err(torch, e[ok], me[ok]))
        if not all(good for _, good in errs):
            fail(f"el2n N={N} V={V} aligned={aligned}: max|kernel - plain| "
                 f"{[round(x, 9) for x, _ in errs]} beyond {EL2N_TOL}")
        worst = max(worst, *(x for x, _ in errs[:2]))
        say(f"el2n: N={N} V={V} aligned={aligned} plan "
            f"{el2n_plan(N, V, SMS)}: max abs err "
            f"{max(x for x, _ in errs[:2]):.3g} against the one-pass plain "
            f"form, {int(ok.sum())} rows against the materialized form")
    worst = max(worst, el2n_layouts(torch, gen, torch.float32))

    out, calls = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        for N, V in EL2N_SHAPES:
            per = N * V * dt.itemsize
            sets = [(lg.to(dt), lb) for lg, lb in (
                el2n_case(torch, gen, N, V, pad=0)
                for _ in range(n_copies(per)))]
            kernel = [lambda s=s: el2n_fwd(*s) for s in sets]
            e, c = kernel[0]()
            we, wc = ref.fused_scores(*sets[0])
            errs = [_el2n_err(torch, e, we), _el2n_err(torch, c, wc)]
            if not all(good for _, good in errs):
                fail(f"el2n timed {str(dt)[6:]} ({N}, {V}): max|kernel - "
                     f"plain| {[x for x, _ in errs]} beyond {EL2N_TOL}")
            b = bound(per + N * 4 + 2 * N * 4, 5 * N * V)
            r = dict(max_abs_err=max(x for x, _ in errs), ms=time_ms(kernel),
                     bound_ms=b[0], bound_by=b[1], library_ms=None,
                     plan=el2n_plan(N, V, SMS),
                     shape=f"logits ({N}, {V}) {str(dt)[6:]}, labels ({N},)")
            if (N, V) in ((16, 100), (512, 152064)):
                r["plain_ms"] = time_ms([lambda s=s: ref.el2n_scores(*s)
                                         for s in sets])
            if dt == torch.float32 and (N, V) in ((16, 100), (512, 152064)):
                longs = [(lg, lb.long()) for lg, lb in sets]
                r.update(
                    one_pass_plain_ms=time_ms(
                        [lambda s=s: ref.fused_scores(*s) for s in sets]),
                    cross_entropy_ms=time_ms([lambda s=s: F.cross_entropy(
                        *s, reduction="none") for s in longs]))
                del longs
            out[(str(dt)[6:], N, V)] = r
            calls[(str(dt)[6:], N, V)] = kernel
    dev = device_ms_cases(calls)
    # device_ms's fallback, on the same calls: the profiler's time beside it
    queued = {key: queued_ms(calls[key]) for key in
              (("float32", 16, 100), ("float32", 512, 152064))}
    del calls
    say("el2n: queued_ms (device_ms's fallback) " + ", ".join(
        f"({N}, {V}) {d} {t:.5f} ms against the profiler's "
        f"{dev[(d, N, V)]:.5f}" for (d, N, V), t in queued.items()))
    for key, r in out.items():
        r["device_ms"] = dev[key]
        say(f"el2n timing {r['shape']}, plan {r['plan']}: max abs err "
            f"{r['max_abs_err']:.3g}, kernel {r['ms']:.4f} ms "
            f"({r['device_ms']:.5f} on the device, "
            f"{r['bound_ms'] / r['device_ms']:.1%} of the bound), bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})"
            + (f", plain (materialized) {r['plain_ms']:.4f} ms"
               if "plain_ms" in r else "")
            + (f", one-pass plain {r['one_pass_plain_ms']:.4f} ms, "
               f"F.cross_entropy (CE only) {r['cross_entropy_ms']:.4f} ms"
               if "one_pass_plain_ms" in r else ""))
    path, lm = out[("float32", 16, 100)], out[("float32", 512, 152064)]
    results["el2n"] = {
        **path, "lm_shape": lm,
        "max_abs_err": max([worst] + [r["max_abs_err"] for (d, _, _), r
                                      in out.items() if d == "float32"]),
        "f32": {f"({N}, {V})": r for (d, N, V), r in out.items()
                if d == "float32"},
        "bf16": {f"({N}, {V})": r for (d, N, V), r in out.items()
                 if d == "bfloat16"}}


def sm_clock_hz() -> float:
    """The SM clock the card can run at (nvidia-smi clocks.max.sm, MHz)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi clocks.max.sm failed: {out.stderr.strip()}")
    return float(out.stdout.split()[0]) * 1e6


def threefry_sass_count():
    """Instructions per threefry evaluation, counted in the SASS of the
    built masked-encode kernel (cuobjdump): the pair loop is the innermost
    backward branch whose body holds the funnel shifts (20 per evaluation,
    four evaluations per iteration); its whole body (the loop's load,
    compare and branch included) is divided by the evaluations. Returns
    (instructions per evaluation, {opcode: count} of one iteration), or
    (None, reason)."""
    import re
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    dump = subprocess.run([str(cuobjdump), "-sass", str(build.library_path())],
                          capture_output=True, text=True, timeout=120)
    if dump.returncode != 0:
        return None, f"cuobjdump failed: {dump.stderr.strip()[:200]}"
    text = dump.stdout
    start = text.find("masked_encode_kernel")
    if start < 0:
        return None, "masked_encode_kernel not in the SASS"
    end = text.find("Function :", start + 1)
    insts, at = [], {}       # (opcode, operands); address or label -> index
    for line in text[start:end if end > 0 else len(text)].splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            at[lab.group(1)] = len(insts)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][\w.]*)(.*)", line)
        if m:
            at[f"0x{int(m.group(1), 16):x}"] = len(insts)
            insts.append((m.group(3), m.group(4)))
    spans = []
    for i, (op, rest) in enumerate(insts):
        tgt = re.search(r"(\.L_x_\d+|0x[0-9a-f]+)", rest)
        if not (op.startswith("BRA") and tgt):
            continue
        key = tgt.group(1)
        key = key if key.startswith(".") else f"0x{int(key, 16):x}"
        if at.get(key, i) < i:
            body = [o for o, _ in insts[at[key]:i + 1]]
            if sum(o.startswith("SHF.L.W") for o in body) >= 80:
                spans.append(body)
    if not spans:
        return None, "no backward branch around the funnel shifts"
    loop = min(spans, key=len)
    counts = {}
    for o in loop:
        counts[o.split(".")[0]] = counts.get(o.split(".")[0], 0) + 1
    n_eval = sum(o.startswith("SHF.L.W") for o in loop) / 20
    return len(loop) / n_eval, counts


def secure_case(torch, gen, n, J, *, edge=False, zero_signs=0):
    """x (n,) on the card (edge: ties at half a unit of 2^-16, beyond
    +-headroom, -0.0 at the front), J seeds (0 and 0xFFFFFFFF among them
    when edge) and signs +-1 with `zero_signs` zeros."""
    from repro_torch.privacy.fixed_point import headroom
    x = torch.randn((n,), generator=gen, device="cuda") * 0.05
    if edge:
        u = 2.0 ** -16
        vals = [0.5 * u, -0.5 * u, 1.5 * u, -1.5 * u, 2.5 * u, -0.0,
                headroom() * 2, -headroom() * 2, headroom(), 1e30]
        x[:len(vals)] = torch.tensor(vals, device="cuda")
    seeds = torch.randint(0, 2 ** 32, (J,), generator=gen, device="cuda",
                          dtype=torch.int64)
    if edge:
        seeds[0], seeds[-1] = 0, 0xFFFFFFFF
    signs = torch.tensor([(-1) ** j for j in range(J)], dtype=torch.int32)
    signs[:zero_signs] = 0
    return x, seeds, signs.cuda()


def check_secure_mask(torch, gen, results):
    from repro_torch.kernels.secure_mask import ref
    from repro_torch.kernels.secure_mask.kernel import masked_encode_fwd
    from repro_torch.kernels.secure_mask.ops import (masked_encode,
                                                     summed_mask)
    n_full = 7_171_584      # ViT-Base (tail, prompt): 28,686,336 B, no pad
    cases = [("full width, 3 pairs", n_full, 3, False, 0),
             ("edge n=896, 4 pairs", 128 * 7, 4, True, 1)]
    for name, n, J, edge, zeros in cases:
        x, seeds, signs = secure_case(torch, gen, n, J, edge=edge,
                                      zero_signs=zeros)
        got = masked_encode(x, seeds, signs)
        want = ref.masked_encode(x, seeds, signs)
        if not torch.equal(got, want):
            fail(f"secure_masked_encode {name}: {int((got != want).sum())} "
                 f"of {n} words differ from plain")
    # the recovery stream: x absent, K(K-1) = 12 pairs, one client dropped
    # (3 nonzero signs)
    _, seeds, signs = secure_case(torch, gen, 128, 12, zero_signs=9)
    got = summed_mask(seeds, signs, n_full, device="cuda")
    if not torch.equal(got, ref.summed_mask(seeds, signs, n_full,
                                            device="cuda")):
        fail("summed_mask (12 pairs, 3 nonzero) differs from plain")
    say("secure_masked_encode: kernel == plain (bit patterns) at the full "
        "width (n 7,171,584, 3 pairs), at n 896 with ties, saturation, -0.0 "
        "and seeds 0 / 0xFFFFFFFF, and as summed_mask (x absent, 12 pairs, "
        "3 nonzero)")

    # timing at the main path's shape: one client's upload, 3 pairs
    J = 3
    sets = [secure_case(torch, gen, n_full, J)
            for _ in range(n_copies(n_full * 8))]
    dev_pairs = [(x, ref.to_ring(s & ref.MASK32), g) for x, s, g in sets]
    ms = time_ms([lambda c=c: masked_encode_fwd(
        c[0], c[1], c[2], n=n_full, frac_bits=16) for c in dev_pairs])
    plain_ms = time_ms([lambda c=c: ref.masked_encode(*c) for c in sets],
                       iters=8)
    per_eval, detail = threefry_sass_count()
    if per_eval is None:
        fail(f"secure_masked_encode: no instruction count for the bound: "
             f"{detail}")
    clock = sm_clock_hz()
    # operations: every instruction of the pair loop, at the SMs' issue
    # rate (the least time); the ALU pipe alone, at 64 lanes, for comparison
    b = bound(2 * n_full * 4, n_full * J * per_eval,
              SMS * ISSUE_LANES * clock)
    alu_per_eval = per_eval * sum(detail.get(o, 0) for o in ALU_OPS) / sum(
        detail.values())
    alu_ms = n_full * J * alu_per_eval / (SMS * INT32_LANES * clock) * 1e3
    say(f"secure_masked_encode timing at (n {n_full}, 3 pairs): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b[0]:.4f} ms "
        f"({b[1]}: {per_eval} instructions per threefry in the SASS loop "
        f"{detail} at {SMS} SMs x {ISSUE_LANES} issue lanes x "
        f"{clock / 1e6:.0f} MHz; bytes {2 * n_full * 4} B at 3.35 TB/s "
        f"{2 * n_full * 4 / HBM_BYTES_PER_S * 1e3:.4f} ms); the ALU pipe "
        f"alone ({alu_per_eval:.2f} a threefry at {INT32_LANES} lanes) "
        f"{alu_ms:.4f} ms")
    results["secure_masked_encode"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
        bound_by=b[1], library_ms=None, sass_per_threefry=per_eval,
        sass_loop_opcodes=detail, sm_clock_mhz=clock / 1e6,
        alu_pipe_ms=alu_ms,
        shape=f"x ({n_full},) f32, 3 pairs")


def _scan_err(torch, got, want):
    """max |kernel - plain| / (1 + |plain|), inf where the kernel is not
    finite."""
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float(((got - want).abs() / (1.0 + want.abs())).max())


def mamba2_case(torch, gen, B, T, H, P, N, G, h0, dtype=None):
    """Inputs laid out as `apply_mamba2` hands them to the scan: x, B and C
    are views into one conv output (B, T, H*P + 2*G*N), of the activation
    dtype (f32 unless `dtype`), dt a softplus and A the init's
    -linspace(1, 16), both f32."""
    F = torch.nn.functional
    conv = torch.randn((B, T, H * P + 2 * G * N), generator=gen,
                       device="cuda").to(dtype or torch.float32)
    x = conv[..., :H * P].reshape(B, T, H, P)
    Bm = conv[..., H * P:H * P + G * N].reshape(B, T, G, N)
    Cm = conv[..., H * P + G * N:].reshape(B, T, G, N)
    dt = F.softplus(torch.randn((B, T, H), generator=gen, device="cuda"))
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    state = (torch.randn((B, H, P, N), generator=gen, device="cuda")
             if h0 else None)
    return x, dt, A, Bm, Cm, state


def time_scan(kernel, plain, make, per_bytes):
    """Kernel and plain times over input copies that exceed the L2 (the
    plain version, a Python loop over T, over fewer calls)."""
    sets = [make() for _ in range(n_copies(per_bytes))]
    return (time_ms([lambda s=s: kernel(*s) for s in sets]),
            time_ms([lambda s=s: plain(*s) for s in sets], iters=10))


def mamba2_build_report():
    """Registers and spill bytes of each Mamba-2 kernel instantiation (the
    chunked and the step kernel per element type of x and y, each typed
    and coded), from the ptxas report; fails on a spill."""
    out = {name: r for name, r in ptxas_report().items()
           if "mamba2_chunk_kernel" in name or "mamba2_step_kernel" in name}
    for name, r in sorted(out.items()):
        say(f"mamba2 ptxas: {name}: {r.get('registers')} registers, "
            f"{r.get('spill_bytes')} bytes spilled")
        if r.get("spill_bytes") != 0:
            fail(f"mamba2 kernel {name}: {r.get('spill_bytes')} bytes of "
                 f"register spills")
    if len(out) != 12:
        fail(f"expected 12 Mamba-2 kernel functions (chunked and step: 3 "
             f"dtypes x typed and coded), found {sorted(out)}")
    return {name: dict(r) for name, r in out.items()}


def mamba2_bound(B, T, H, P, N, G, xb=4):
    """Least device time of one scan call: x, dt, A, B, C and the state
    read once, y and the state written once (x, B, C and y at `xb` bytes
    a value), against 5 flops a state entry a step (decay, input product,
    add; output product, sum), dt x a row and exp(dt A) a head, at the
    fp32 pipe's rate."""
    nbytes = (xb * (2 * B * T * H * P + 2 * B * T * G * N)
              + 4 * (B * T * H + H + 2 * B * H * P * N))
    return nbytes, bound(nbytes, B * T * H * (P * (5 * N + 1) + 2))


def check_mamba2(torch, gen, results):
    """Both Mamba-2 kernels (the step kernel up to the wrapper's
    STEP_MAX_T, the chunked one above it) against the sequential plain
    version at SCAN_TOL, with a fresh final state and written over the
    input state; the crossover sweep over T 1-16; prefill and decode
    timed beside the bound, plain, and the chunked plain version (the
    chunked kernel's algorithm: printed only)."""
    from repro_torch.kernels.mamba2_scan import kernel as K
    from repro_torch.kernels.mamba2_scan import ref
    from repro_torch.kernels.mamba2_scan.kernel import mamba2_fwd
    results["mamba2_build"] = mamba2_build_report()
    worst = 0.0
    # zamba2's path shapes (prefill with zero and random h0, decode), the
    # chunk edges at T 2-132, then G 2 and 4, P 8 with N 100, N 200 (the
    # chunked kernel at T 1), and N 400 and 512 (one stage of inputs)
    cases = [(1, 132, 80, 64, 64, 1, False), (1, 132, 80, 64, 64, 1, True),
             (8, 1, 80, 64, 64, 1, True), (8, 2, 80, 64, 64, 1, True),
             (2, 16, 80, 64, 64, 1, True), (1, 63, 8, 64, 64, 1, True),
             (1, 64, 8, 64, 64, 1, True), (1, 65, 8, 64, 64, 1, True),
             (2, 37, 8, 64, 64, 2, True), (3, 101, 8, 32, 16, 4, False),
             (1, 33, 2, 8, 100, 2, True), (2, 1, 2, 8, 100, 2, True),
             (2, 1, 4, 32, 200, 2, True), (1, 70, 4, 32, 400, 1, True),
             (2, 1, 2, 16, 512, 2, True)]
    for B, T, H, P, N, G, h0 in cases:
        args = mamba2_case(torch, gen, B, T, H, P, N, G, h0)
        ry, rh = ref.mamba2_scan(*args)
        y, h = mamba2_fwd(*args)
        state = args[5] if h0 else torch.full_like(rh, math.nan)
        y2, h2 = mamba2_fwd(*args[:5], args[5], state_out=state)
        if h2 is not state:
            fail("mamba2_scan: state_out was not the tensor returned")
        err = max(_scan_err(torch, y, ry), _scan_err(torch, h, rh),
                  _scan_err(torch, y2, ry), _scan_err(torch, h2, rh))
        form = "step" if K.uses_step_kernel(T, N) else "chunked"
        if not err <= SCAN_TOL:
            fail(f"mamba2_scan ({form}) B={B} T={T} H={H} P={P} N={N} G={G} "
                 f"h0={h0}: max|kernel - plain|/(1 + |plain|) = {err:.3g} "
                 f"> {SCAN_TOL}")
        worst = max(worst, err)
        say(f"mamba2_scan ({form}): B={B} T={T} H={H} P={P} N={N} G={G} "
            f"h0={h0}: max scaled err {err:.3g} (fresh state and in place)")

    def calls(B, T, in_place=True, n=None):
        """Kernel calls over input copies past the L2, each writing its
        final state over its input state as the serving path does."""
        per = mamba2_bound(B, T, 80, 64, 64, 1)[0]
        sets = [mamba2_case(torch, gen, B, T, 80, 64, 64, 1, True)
                for _ in range(n or n_copies(per))]
        return sets, [lambda s=s: mamba2_fwd(*s, state_out=s[5])
                      for s in sets]

    # the crossover: each kernel's device time at zamba2's heads over T
    sweep, keep = {}, K.STEP_MAX_T
    try:
        for B in (8, 1):
            for T in (1, 2, 4, 8, 16):
                _, fns = calls(B, T)
                for form, limit in (("step", 1 << 30), ("chunked", 0)):
                    K.STEP_MAX_T = limit
                    sweep[f"B {B} T {T} {form}"] = device_ms(fns)
                del fns
    finally:
        K.STEP_MAX_T = keep
    say("mamba2_scan crossover (device ms, zamba2's heads): " + "; ".join(
        f"{k} {v:.4f}" for k, v in sweep.items())
        + f"; the wrapper takes the step kernel up to T {K.STEP_MAX_T}")

    timed = {}
    for name, (B, T) in (("decode", (8, 1)), ("prefill", (1, 132))):
        H, P, N, G = 80, 64, 64, 1
        nbytes, b = mamba2_bound(B, T, H, P, N, G)
        sets, fns = calls(B, T)
        t_k, d_k = time_ms(fns), device_ms(fns)
        t_p = time_ms([lambda s=s: ref.mamba2_scan(*s) for s in sets],
                      iters=10)
        t_c = time_ms([lambda s=s: ref.mamba2_chunked(*s, chunk=K.CHUNK)
                       for s in sets], iters=10)
        # the kernel's gap to the chunked plain version (the TPU kernel's
        # algorithm, whose exp arguments are differences of cumsums)
        args = mamba2_case(torch, gen, B, T, H, P, N, G, True)
        cy, ch = ref.mamba2_chunked(*args, chunk=K.CHUNK)
        ky, kh = mamba2_fwd(*args)
        gap = max(_scan_err(torch, ky, cy), _scan_err(torch, kh, ch))
        del sets, fns
        timed[name] = dict(
            ms=t_k, device_ms=d_k, plain_ms=t_p, chunked_plain_ms=t_c,
            gap_to_chunked_plain=gap,
            bound_ms=b[0], bound_by=b[1],
            kernel="step" if K.uses_step_kernel(T, N) else "chunked",
            shape=f"x ({B}, {T}, {H}, {P}), B/C ({B}, {T}, {G}, {N}), "
                  f"state carried and written in place")
        say(f"mamba2_scan {name} ({timed[name]['kernel']} kernel): "
            f"{timed[name]['shape']}: kernel {t_k:.4f} ms ({d_k:.4f} on the "
            f"device), plain {t_p:.4f} ms, chunked plain {t_c:.4f} ms "
            f"(scaled gap to it {gap:.3g}, not checked), bound "
            f"{b[0]:.5f} ms ({b[1]}); device / bound {d_k / b[0]:.2f}")
    results["mamba2_scan"] = dict(
        timed["decode"], max_abs_err=worst, library_ms=None,
        prefill_shape=timed["prefill"], crossover_device_ms=sweep,
        step_max_t=K.STEP_MAX_T, chunk=K.CHUNK)


def rwkv6_case(torch, gen, B, T, H, K, decay=None, dtype=None, V=None):
    """Inputs as `apply_rwkv6` hands them to the scan: contiguous r, k, v
    of the activation dtype (f32 unless `dtype`), the Finch decay
    w = -exp(.), the bonus u, and a carried (B, H, K, V) state (V = K
    unless given), all three f32."""
    V = V or K
    r, k = (torch.randn((B, T, H, K), generator=gen, device="cuda")
            .to(dtype or torch.float32) for _ in range(2))
    v = torch.randn((B, T, H, V), generator=gen, device="cuda").to(
        dtype or torch.float32)
    w = (torch.full((B, T, H, K), decay, device="cuda") if decay is not None
         else -torch.exp(torch.randn((B, T, H, K), generator=gen,
                                     device="cuda") - 1.0))
    u = 0.5 * torch.randn((H, K), generator=gen, device="cuda")
    state = torch.randn((B, H, K, V), generator=gen, device="cuda")
    return r, k, v, w, u, state


def rwkv6_build_report():
    """Registers and spill bytes of each RWKV-6 kernel instantiation (the
    chunked kernel per element type of r and y, typed and coded, at the
    serving shape, plus the swept shapes at f32; the step kernel per
    element type), from the ptxas report; fails on a spill."""
    out = {name: r for name, r in ptxas_report().items()
           if "rwkv6_chunk_kernel" in name or "rwkv6_step_kernel" in name}
    for name, r in sorted(out.items()):
        say(f"rwkv6 ptxas: {name}: {r.get('registers')} registers, "
            f"{r.get('spill_bytes')} bytes spilled")
        if r.get("spill_bytes") != 0:
            fail(f"rwkv6 kernel {name}: {r.get('spill_bytes')} bytes of "
                 f"register spills")
    if len(out) != 12:
        fail(f"expected 12 RWKV-6 kernel functions (chunked: 3 dtypes x "
             f"typed and coded, 3 more f32 shapes; step: 3 dtypes), found "
             f"{sorted(out)}")
    return {name: dict(r) for name, r in out.items()}


def rwkv6_bytes(B, T, H, K, V=None):
    """r, k, v, w, u and the state read once; y and the state written once
    (f32)."""
    V = V or K
    return 4 * (3 * B * T * H * K + 2 * B * T * H * V + H * K
                + 2 * B * H * K * V)


def check_rwkv6(torch, gen, results):
    """Both RWKV-6 kernels (the step kernel up to the wrapper's
    STEP_MAX_T, the chunked one above it) against the sequential plain
    version at SCAN_TOL, with a fresh final state and written over the
    input state; the crossover sweep over T 1-16; the chunked kernel's
    shape sweep (steps a chunk, state columns a block); prefill and decode
    timed beside the bound, plain, and the sub-chunked plain version (the
    chunked kernel's algorithm: printed only)."""
    from repro_torch.kernels.rwkv6_scan import kernel as KR
    from repro_torch.kernels.rwkv6_scan import ref
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_fwd
    results["rwkv6_build"] = rwkv6_build_report()
    worst = 0.0
    # rwkv6-3b's path shapes (prefill, decode, the steps around the
    # crossover), the chunk edges, w = -12, then K 16 and V 16, 48, 96
    cases = [(1, 132, 40, 64, None, None), (8, 1, 40, 64, None, None),
             (8, 2, 40, 64, None, None), (8, 5, 40, 64, None, None),
             (1, 31, 8, 64, None, None), (1, 33, 8, 64, None, None),
             (1, 65, 8, 64, None, None), (2, 37, 4, 64, -12.0, None),
             (8, 1, 4, 64, -12.0, None), (1, 132, 4, 64, -12.0, None),
             (3, 65, 2, 16, None, None), (2, 40, 2, 64, None, 48),
             (2, 3, 2, 64, None, 96), (1, 70, 2, 16, None, 96)]
    for B, T, H, K, decay, V in cases:
        args = rwkv6_case(torch, gen, B, T, H, K, decay, V=V)
        ry, rS = ref.rwkv6_scan(*args)
        y, S = rwkv6_fwd(*args)
        y2, S2 = rwkv6_fwd(*args, state_out=args[5])
        if S2 is not args[5]:
            fail("rwkv6_scan: state_out was not the tensor returned")
        err = max(_scan_err(torch, y, ry), _scan_err(torch, S, rS),
                  _scan_err(torch, y2, ry), _scan_err(torch, S2, rS))
        form = "step" if KR.uses_step_kernel(T) else "chunked"
        if not err <= SCAN_TOL:
            fail(f"rwkv6_scan ({form}) B={B} T={T} H={H} K={K} V={V or K} "
                 f"decay={decay}: max|kernel - plain|/(1 + |plain|) = "
                 f"{err:.3g} > {SCAN_TOL}")
        worst = max(worst, err)
        say(f"rwkv6_scan ({form}): B={B} T={T} H={H} K={K} V={V or K} "
            f"decay={decay}: max scaled err {err:.3g} (fresh state and in "
            f"place)")

    def calls(B, T, n=None):
        """Kernel calls over input copies past the L2, each writing its
        final state over its input state as the serving path does."""
        sets = [rwkv6_case(torch, gen, B, T, 40, 64)
                for _ in range(n or n_copies(rwkv6_bytes(B, T, 40, 64)))]
        return sets, [lambda s=s: rwkv6_fwd(*s, state_out=s[5])
                      for s in sets]

    # the crossover: each kernel's device time at rwkv6-3b's heads over T
    sweep, keep = {}, KR.STEP_MAX_T
    try:
        for B in (8, 1):
            for T in (1, 2, 4, 8, 16):
                _, fns = calls(B, T)
                for form, limit in (("step", 1 << 30), ("chunked", 0)):
                    KR.STEP_MAX_T = limit
                    sweep[f"B {B} T {T} {form}"] = device_ms(fns, iters=20)
                del fns
    finally:
        KR.STEP_MAX_T = keep
    say("rwkv6_scan crossover (device ms, rwkv6-3b's heads): " + "; ".join(
        f"{k} {v:.4f}" for k, v in sweep.items())
        + f"; the wrapper takes the step kernel up to T {KR.STEP_MAX_T}")
    # the chunked kernel's shape: steps a chunk x state columns a block
    shapes, keep = {}, (KR.CHUNK, KR.COLS)
    try:
        for T in (36, 132):
            _, fns = calls(1, T)
            for chunk in (32, 64):
                for cols in (16, 32):
                    KR.CHUNK, KR.COLS = chunk, cols
                    shapes[f"T {T} chunk {chunk} cols {cols}"] = device_ms(
                        fns, iters=20)
            del fns
    finally:
        KR.CHUNK, KR.COLS = keep
    say("rwkv6_scan chunked shapes (device ms, batch-1 prefill): "
        + "; ".join(f"{k} {v:.4f}" for k, v in shapes.items())
        + f"; the wrapper takes chunks of {KR.CHUNK}, {KR.COLS} columns a "
          f"block")

    timed = {}
    for name, (B, T) in (("decode", (8, 1)), ("prefill", (1, 132))):
        H, K = 40, 64
        # r, k, v, w, u and the state read once; y and the state written
        # once; 5 flops per state entry per step (r S and its sum; exp(w) S,
        # k v, add), the bonus r u k (3 per k) and its v term (2 per v)
        nbytes = rwkv6_bytes(B, T, H, K)
        b = bound(nbytes, B * T * H * (5 * K * K + 5 * K))
        sets, fns = calls(B, T)
        t_k, d_k = time_ms(fns), device_ms(fns)
        t_p = time_ms([lambda s=s: ref.rwkv6_scan(*s) for s in sets],
                      iters=5)
        t_c = time_ms([lambda s=s: ref.rwkv6_subchunked(*s, chunk=KR.CHUNK)
                       for s in sets], iters=5)
        # the kernel's gap to its own decomposition in plain PyTorch
        args = rwkv6_case(torch, gen, B, T, H, K)
        cy, cS = ref.rwkv6_subchunked(*args, chunk=KR.CHUNK)
        ky, kS = rwkv6_fwd(*args)
        gap = max(_scan_err(torch, ky, cy), _scan_err(torch, kS, cS))
        del sets, fns
        timed[name] = dict(
            ms=t_k, device_ms=d_k, plain_ms=t_p, subchunked_plain_ms=t_c,
            gap_to_subchunked_plain=gap, bound_ms=b[0], bound_by=b[1],
            kernel="step" if KR.uses_step_kernel(T) else "chunked",
            shape=f"r, k, v, w ({B}, {T}, {H}, {K}), state carried and "
                  f"written in place")
        say(f"rwkv6_scan {name} ({timed[name]['kernel']} kernel): "
            f"{timed[name]['shape']}: kernel {t_k:.4f} ms ({d_k:.4f} on the "
            f"device), plain {t_p:.4f} ms, sub-chunked plain {t_c:.4f} ms "
            f"(scaled gap to it {gap:.3g}, not checked), bound {b[0]:.5f} "
            f"ms ({b[1]}); device / bound {d_k / b[0]:.2f}")
    results["rwkv6_scan"] = dict(
        timed["decode"], max_abs_err=worst, library_ms=None,
        prefill_shape=timed["prefill"], crossover_device_ms=sweep,
        shape_device_ms=shapes, step_max_t=KR.STEP_MAX_T, chunk=KR.CHUNK,
        cols=KR.COLS)


# ------------------------------------------ phase 3, slice G part 2 shapes
# the int8 pair at Qwen2-VL-72B's d_model: 8192 is the block layout's
# capacity (`quantize_plan`), at decode (8 slots) and prefill (132 rows)
G2_QUANT_SHAPES = (("decode", 8, 8192), ("prefill", 132, 8192))


def check_slice_g2(torch, F, gen, results):
    """The attention and int8 shapes Whisper and Qwen2-VL bring, each held
    against plain and timed (event and device ms beside plain, SDPA or
    torch.mul, and the bound), under "g2" in its kernel's record: the
    prefill kernel at Whisper-base's encoder (B 4, 1500 frames, 8 heads of
    64, non-causal), its cross-attention (64 and 1 queries over the 1500
    frames, non-causal) and Qwen2-VL-72B's causal GQA prefill (B 2, S 132,
    64 / 8 heads of 128: G 8); the dense decode kernel at Whisper's 8 / 8 x
    64 (G 1, the kD 128 instantiation's padding lanes) and Qwen2-VL's 64 /
    8 x 128 (G 8) over phase 3's 8 slots of 512; the int8 pair at
    G2_QUANT_SHAPES, bit-equal in every layout that holds a row of 8192."""
    pre = results["flash_attention_prefill"]
    pre["g2"] = {
        "whisper-base encoder": prefill_shape(
            torch, F, gen, "whisper-base encoder", 4, 8, 64, False,
            (1500,)),
        "whisper-base cross-attention Sq 64": prefill_shape(
            torch, F, gen, "whisper-base cross-attention", 4, 8, 64, False,
            (1500,), q_len=64),
        "whisper-base cross-attention Sq 1": prefill_shape(
            torch, F, gen, "whisper-base cross-attention (decode)", 4, 8,
            64, False, (1500,), q_len=1),
        "qwen2-vl-72b": prefill_shape(torch, F, gen, "qwen2-vl-72b", 2, 64,
                                      128, True, (37, 132), Hkv=8)}
    pre["max_abs_err"] = max(pre["max_abs_err"], *(
        r["max_abs_err"] for r in pre["g2"].values()))
    dec = results["decode_attention"]
    dec["g2"] = {
        "whisper-base 8 / 8 x 64": decode_record(torch, F, gen, 8, 8, 64,
                                                 sweep=False),
        "qwen2-vl-72b 64 / 8 x 128": decode_record(torch, F, gen, 64, 8,
                                                   128, sweep=False)}
    dec["max_abs_err"] = max(dec["max_abs_err"], *(
        r["max_abs_err"] for r in dec["g2"].values()))
    g2_quant(torch, gen, results)


def g2_quant(torch, gen, results):
    """The int8 pair at G2_QUANT_SHAPES, f32: bit-equal to plain in every
    plan that holds the row (the block layout at its capacity, clusters of
    2-8), u a float, (0, 0) and dense; then the event and device ms of
    quantize (u 0.5) and of dequantize beside torch.mul, with the bound."""
    from repro_torch.kernels.quant.kernel import (dequantize_fwd,
                                                  quantize_fwd, quantize_plan)
    for _, N, D in G2_QUANT_SHAPES:
        quant_equal(torch, f"float32 ({N}, {D})",
                    quant_x(torch, gen, N, D, torch.float32),
                    quant_us(torch, gen, N, D), quant_plans(D),
                    torch.float32)
    lines = []
    for label, N, D in G2_QUANT_SHAPES:
        q_bytes = N * D * 4 + N * D + N * 4
        xs = [torch.randn((N, D), generator=gen, device="cuda") * 3.0
              for _ in range(n_copies(q_bytes))]
        pays = [quantize_fwd(x, 0.5) for x in xs]
        cases = {"quantize": [lambda x=x: quantize_fwd(x, 0.5) for x in xs],
                 "dequantize": [lambda p=p: dequantize_fwd(*p)
                                for p in pays],
                 "torch.mul": [lambda p=p: torch.mul(*p) for p in pays]}
        dev = device_ms_cases(cases)
        bq, bd = bound(q_bytes, 4 * N * D), bound(q_bytes, N * D)
        q = dict(max_abs_err=0.0, ms=time_ms(cases["quantize"]),
                 device_ms=dev["quantize"], bound_ms=bq[0], bound_by=bq[1],
                 plain_ms=None, library_ms=None,
                 plan=quantize_plan(N, D, 4),
                 shape=f"x ({N}, {D}) float32, u 0.5 ({label})")
        d = dict(max_abs_err=0.0, ms=time_ms(cases["dequantize"]),
                 device_ms=dev["dequantize"], bound_ms=bd[0], bound_by=bd[1],
                 plain_ms=None, library_ms=time_ms(cases["torch.mul"]),
                 library_device_ms=dev["torch.mul"],
                 shape=f"v ({N}, {D}) -> float32 ({label})")
        del xs, pays, cases
        for kernel, r in (("quantize_int8", q), ("dequantize_int8", d)):
            results[kernel].setdefault("g2", {})[r["shape"]] = r
            lines.append(
                f"  {kernel} {r['shape']}: {r['ms']:.4f} ms "
                f"({r['device_ms']:.4f} on the device; bound "
                f"{r['bound_ms']:.6f}, "
                f"{r['device_ms'] / r['bound_ms']:.1f}x)"
                + (f", plan {r['plan']}" if "plan" in r else
                   f", torch.mul {r['library_ms']:.4f} "
                   f"({r['library_device_ms']:.4f} on the device)"))
    say("quant at D 8192 (block layout at capacity), kernel == plain in "
        "every plan; event ms (device ms):\n" + "\n".join(lines))


# ----------------------------------------------------------- phase 3, bf16
def half_err(torch, label, got, want, dtype=None):
    """Fail unless the kernel's and plain's outputs are both of `dtype`
    (bf16 unless given; or f16) and the kernel's is finite and within
    BF16_TOL (F16_TOL) (1 + |plain|); returns the largest error, in
    absolute terms and in ulps of plain's dtype (the two round the same
    f32 value, computed in different orders), and the share of elements
    that differ."""
    dtype = dtype or torch.bfloat16
    tol, bits, tiny = ((BF16_TOL, 8, 2.0 ** -126) if dtype == torch.bfloat16
                       else (F16_TOL, 11, 2.0 ** -14))
    if got.dtype != dtype or want.dtype != dtype:
        fail(f"{label}: the kernel gave {got.dtype} and plain {want.dtype}, "
             f"not {dtype}")
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if not bool(torch.isfinite(g).all()) \
            or bool((d > tol * (1 + w.abs())).any()):
        fail(f"{label}: max|kernel - plain| = {float(d.max()):.3g} beyond "
             f"{tol} (1 + |plain|)")
    _, e = torch.frexp(w.abs().clamp_min(tiny))
    ulp = torch.ldexp(torch.ones_like(w), e - bits)
    return dict(max_abs_err=float(d.max()), max_ulps=float((d / ulp).max()),
                differ_share=float((d > 0).float().mean()))


def worst_err(errs):
    return {k: max(e[k] for e in errs) for k in errs[0]}


def bf16_prefill(torch, F, gen, results):
    """All-bf16 q, k, v at Qwen2.5-14B's (40 / 8 heads of 128), zamba2's
    (32 heads of 80) and the wide shapes' causal prefill through the
    16-bit kernel, checked at S 37 and 132 (at 132 also against the f32
    kernel's share of differing values: `prefill_16_accuracy`), timed at
    132 beside plain and SDPA on the same bf16 values; with the plan's
    rows and blocks and the instantiation's registers and spills."""
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, prefill_plan)
    report = results["flash_attention_prefill"]["instantiations"]
    out = {}
    for label, B, Hq, Hkv, Dh in (("Qwen2.5-14B", 1, 40, 8, 128),
                                  ("zamba2", 1, 32, 32, 80)) + tuple(
            (label, 1, Hq, Hkv, Dh) for label, Hq, Hkv, Dh in WIDE_SHAPES):
        scale = Dh ** -0.5
        kw = dict(causal=True, sliding_window=None, softcap=None, scale=scale)

        def inputs(S):
            return tuple(torch.randn((B, S, h, Dh), generator=gen,
                                     device="cuda").to(torch.bfloat16)
                         for h in (Hq, Hkv, Hkv))
        errs = []
        for S in (37, 132):
            q, k, v = inputs(S)
            got = flash_attention_fwd(q, k, v, kv_len=S, **kw)
            if S == 132:
                acc = prefill_16_accuracy(torch, f"prefill bf16 {label} S={S}",
                                          q, k, v, got, torch.bfloat16,
                                          kv_len=S, **kw)
                errs.append({k_: acc[k_] for k_ in
                             ("max_abs_err", "max_ulps", "differ_share")})
            else:
                errs.append(half_err(torch, f"prefill bf16 {label} S={S}",
                                     got, ref.attention(q, k, v, causal=True,
                                                        scale=scale)))
        S = 132
        plan = prefill_plan(B, S, Hq, Dh, Dh, 2, SMS)
        inst, regs = prefill_instantiation(report, Dh, Dh, "bf16")
        per = (B * S * (Hq + 2 * Hkv) * Dh + B * S * Hq * Dh) * 2
        sets = [inputs(S) for _ in range(n_copies(per))]
        kernel = [lambda s=s: flash_attention_fwd(*s, kv_len=S, **kw)
                  for s in sets]
        t_k, d_k = time_ms(kernel), device_ms(kernel)
        t_p = time_ms([lambda s=s: ref.attention(*s, causal=True,
                                                 scale=scale) for s in sets])
        G = Hq // Hkv
        lib = [(q.transpose(1, 2).contiguous(),
                k.repeat_interleave(G, 2).transpose(1, 2).contiguous(),
                v.repeat_interleave(G, 2).transpose(1, 2).contiguous())
               for q, k, v in sets]
        sdpa = [lambda s=s: F.scaled_dot_product_attention(
            *s, is_causal=True, scale=scale) for s in lib]
        t_l, d_l = time_ms(sdpa), device_ms(sdpa)
        del lib, sdpa, sets
        b = bound(per, _prefill_pairs(S, S, None) * B * Hq * 4 * Dh,
                  BF16_FLOPS)
        out[label] = dict(
            worst_err(errs), ms=t_k, device_ms=d_k, plain_ms=t_p,
            library_ms=t_l, library_device_ms=d_l, bound_ms=b[0],
            bound_by=b[1], f32_kernel_differ_share=acc[
                "f32_kernel_differ_share"], differ_share_s132=acc[
                "differ_share"], rows=plan.rows, blocks=-(-S // plan.rows)
            * Hq * B, blocks_per_sm=plan.blocks_per_sm,
            shared_bytes=plan.shared_bytes, instantiation=inst,
            registers=regs.get("registers"),
            spill_bytes=regs.get("spill_bytes"),
            shape=f"q ({B}, {S}, {Hq}, {Dh}), kv {Hkv} heads, causal, bf16")
        r = out[label]
        say(f"prefill bf16 {label}: {r['shape']}: max abs err "
            f"{r['max_abs_err']:.3g} ({r['max_ulps']:.3g} ulps; at S 132 "
            f"{r['differ_share_s132']:.4f} of values differ from plain, the "
            f"f32 kernel's {r['f32_kernel_differ_share']:.4f}); kernel "
            f"{t_k:.4f} ms ({d_k:.4f} on the device), plain {t_p:.4f} ms, "
            f"SDPA bf16 {t_l:.4f} ms ({d_l:.4f}), bound {b[0]:.5f} ms "
            f"({b[1]}); {plan.rows} rows a block, {r['blocks']} blocks, "
            f"{plan.blocks_per_sm} an SM, {plan.shared_bytes} B shared; "
            f"{inst}: {r['registers']} registers, {r['spill_bytes']} B "
            f"spilled")
    results["flash_attention_prefill"]["bf16"] = out


def bf16_decode(torch, F, gen, results):
    """The dense decode kernel with a bf16 query over an f32 cache (the
    engines' case) and over a bf16 cache, at phase 3's 8 slots of 512 for
    Qwen2.5-14B (40 / 8 heads of 128), zamba2 (32 / 32 of 80) and the wide
    shapes; SDPA is timed on the all-bf16 data only (no one call takes
    mixed dtypes)."""
    from repro_torch.kernels.flash_attention.decode import (
        decode_attention_fwd, grouped_decode)
    B, W = 8, 512
    lengths = [37, 0, 512, 200, 0, 1, 333, 100]
    out = {}
    for label, Hq, Hkv, Dh in (("Qwen2.5-14B", 40, 8, 128),
                               ("zamba2", 32, 32, 80)) + WIDE_SHAPES:
        G, scale = Hq // Hkv, Dh ** -0.5
        for variant, kv_dt in (("q bf16, K/V f32", torch.float32),
                               ("all bf16", torch.bfloat16)):
            def case():
                q, k, v, qp, kvp = decode_case(torch, gen, B, W, Hq, Hkv, Dh,
                                               lengths, wrap_slot=7)
                return q.to(torch.bfloat16), k.to(kv_dt), v.to(kv_dt), qp, \
                    kvp
            name = f"{label}, {variant}"
            s0 = case()
            err = half_err(torch, f"decode {name}", decode_attention_fwd(
                *s0, scale=scale, sliding_window=None, softcap=None),
                grouped_decode(*s0, scale=scale, sliding_window=None,
                               softcap=None))
            n_valid = int(((s0[4] >= 0) & (s0[4] <= s0[3][:, None])).sum())
            tiles, idle = slot_tiles(torch, s0[3], s0[4])
            kvb = 2 if kv_dt == torch.bfloat16 else 4
            nbytes = (B * Hq * Dh * 2 * 2 + (n_valid * Hkv * Dh * 2
                      + idle * W * Hkv * Dh) * kvb + B * W * 4 + B * 4)
            b = bound(nbytes, n_valid * Hq * 4 * Dh + idle * W * Hq * Dh,
                      BF16_FLOPS if kvb == 2 else FP32_FLOPS)
            per = B * W * Hkv * Dh * 2 * kvb + B * Hq * Dh * 4 + B * W * 4
            sets = [case() for _ in range(n_copies(per))]
            kernel = [lambda s=s: decode_attention_fwd(
                *s, scale=scale, sliding_window=None, softcap=None)
                for s in sets]
            t_k, d_k = time_ms(kernel), device_ms(kernel)
            t_p = time_ms([lambda s=s: grouped_decode(
                *s, scale=scale, sliding_window=None, softcap=None)
                for s in sets])
            t_l = d_l = None
            if kvb == 2:
                lib = []
                for q, k, v, qp, kvp in sets:
                    mask = ((kvp >= 0) & (kvp <= qp[:, None]))[:, None,
                                                               None, :]
                    lib.append((q.transpose(1, 2).contiguous(),
                                k.repeat_interleave(G, 2).transpose(1, 2)
                                .contiguous(),
                                v.repeat_interleave(G, 2).transpose(1, 2)
                                .contiguous(), mask))
                sdpa = [lambda s=s: F.scaled_dot_product_attention(
                    s[0], s[1], s[2], attn_mask=s[3], scale=scale)
                    for s in lib]
                t_l, d_l = time_ms(sdpa), device_ms(sdpa)
                del lib, sdpa
            del sets
            out[name] = dict(
                err, ms=t_k, device_ms=d_k, plain_ms=t_p, library_ms=t_l,
                library_device_ms=d_l, bound_ms=b[0], bound_by=b[1],
                shape=f"q ({B}, 1, {Hq}, {Dh}) bf16, cache ({B}, {W}, "
                      f"{Hkv}, {Dh}) {str(kv_dt)[6:]}, {tiles} valid tiles, "
                      f"{idle} idle slots")
            say(f"decode bf16 {name}: max abs err {err['max_abs_err']:.3g} "
                f"({err['max_ulps']:.3g} ulps, {err['differ_share']:.3g} of "
                f"elements differ); kernel {t_k:.4f} ms ({d_k:.4f} on the "
                f"device), plain {t_p:.4f} ms, SDPA bf16 "
                f"{'-' if t_l is None else f'{t_l:.4f} ms ({d_l:.4f})'}, "
                f"bound {b[0]:.5f} ms ({b[1]})")
    results["decode_attention"]["bf16"] = out


def bf16_paged(torch, gen, results):
    """The paged decode kernel with a bf16 query over an f32 pool (the
    engine's case) and over a bf16 pool, at phase 3's 16 slots of page 16
    (and with a fully masked row), at Qwen2.5-14B's (40 / 8 heads of 128;
    keyed by the variant alone) and the wide shapes."""
    out = {}
    for label, Hq, Hkv, Dh in (("Qwen2.5-14B", 40, 8, 128),) + WIDE_SHAPES:
        bf16_paged_shape(torch, gen, out, label, Hq, Hkv, Dh)
    results["paged_decode_attention"]["bf16"] = out


def bf16_paged_shape(torch, gen, out, label, Hq, Hkv, Dh):
    from repro_torch.kernels.flash_attention.decode import (
        paged_decode_attention_fwd, paged_gather_decode)
    scale = Dh ** -0.5
    lengths = [1, 512, 37, 200, 0, 129, 16, 17, 300, 64, 5, 96, 250, 33, 128,
               9]
    masked = lengths[:10] + [None] + lengths[11:]
    page, nb, P = 16, 32, 130
    B, n_valid = len(lengths), sum(lengths)
    for variant, kv_dt in (("q bf16, pool f32", torch.float32),
                           ("all bf16", torch.bfloat16)):
        def case(lens):
            q, k, v, tables, qp, kvp = paged_case(torch, gen, lens, page, nb,
                                                  P, Hq, Hkv, Dh)
            return (q.to(torch.bfloat16), k.to(kv_dt), v.to(kv_dt), tables,
                    qp, kvp)
        errs = []
        for lens in (lengths, masked):
            args = case(lens)
            got = paged_decode_attention_fwd(*args, scale=scale,
                                             sliding_window=None,
                                             softcap=None)
            errs.append(half_err(torch, f"paged decode {variant}", got,
                                 paged_gather_decode(
                                     *args, scale=scale, sliding_window=None,
                                     softcap=None)))
        kvb = 2 if kv_dt == torch.bfloat16 else 4
        nbytes = (B * Hq * Dh * 2 * 2 + n_valid * Hkv * Dh * 2 * kvb
                  + n_valid * 4 + B * nb * 4 + B * 4)
        b = bound(nbytes, n_valid * Hq * 4 * Dh,
                  BF16_FLOPS if kvb == 2 else FP32_FLOPS)
        sets = [case(lengths) for _ in range(n_copies(nbytes))]
        kernel = [lambda s=s: paged_decode_attention_fwd(
            *s, scale=scale, sliding_window=None, softcap=None)
            for s in sets]
        t_k, d_k = time_ms(kernel), device_ms(kernel)
        t_p = time_ms([lambda s=s: paged_gather_decode(
            *s, scale=scale, sliding_window=None, softcap=None)
            for s in sets])
        del sets
        name = variant if label == "Qwen2.5-14B" else f"{label}, {variant}"
        out[name] = r = dict(
            worst_err(errs), ms=t_k, device_ms=d_k, plain_ms=t_p,
            library_ms=None, bound_ms=b[0], bound_by=b[1],
            shape=f"q ({B}, 1, {Hq}, {Dh}) bf16, pool ({P}, {page}, {Hkv}, "
                  f"{Dh}) {str(kv_dt)[6:]}, {n_valid} valid entries")
        say(f"paged decode bf16 {label}, {variant}: max abs err "
            f"{r['max_abs_err']:.3g} ({r['max_ulps']:.3g} ulps); kernel "
            f"{t_k:.4f} ms ({d_k:.4f} on the device), plain {t_p:.4f} ms, "
            f"bound {b[0]:.5f} ms ({b[1]})")


def bf16_el2n(torch, gen, results):
    """bf16 logits read by the kernel itself, within EL2N_TOL of the
    one-pass plain form of the same logits (f32 outputs after an exact
    widening): odd shapes, the path's (16, 100) and an LM vocabulary's
    (512, 152064), and every layout at its boundaries; the largest error
    goes to the group's bf16_max_abs_err (check_el2n timed each case and
    kept its own error)."""
    from repro_torch.kernels.el2n import ref
    from repro_torch.kernels.el2n.kernel import el2n_fwd
    worst = 0.0
    for N, V, aligned in ((16, 100, True), (3, 1031, False),
                          (512, 152064, True)):
        logits, labels = el2n_case(torch, gen, N, V, aligned)
        logits = logits.to(torch.bfloat16)
        e, c = el2n_fwd(logits, labels)
        we, wc = ref.fused_scores(logits, labels)
        errs = [_el2n_err(torch, e, we), _el2n_err(torch, c, wc)]
        if not all(good for _, good in errs) or e.dtype != torch.float32:
            fail(f"el2n bf16 N={N} V={V}: max|kernel - plain| "
                 f"{[x for x, _ in errs]} beyond {EL2N_TOL}, or {e.dtype}")
        worst = max(worst, *(x for x, _ in errs))
    worst = max(worst, el2n_layouts(torch, gen, torch.bfloat16))
    results["el2n"]["bf16_max_abs_err"] = worst


def bf16_secure(torch, gen, results):
    """A bf16 upload masked-encoded bit-equal to plain at the full width
    (and at n 896 with ties and saturation), timed at the full width."""
    from repro_torch.kernels.secure_mask import ref
    from repro_torch.kernels.secure_mask.kernel import masked_encode_fwd
    from repro_torch.kernels.secure_mask.ops import masked_encode
    n_full, J = 7_171_584, 3
    for n, J_, edge in ((n_full, J, False), (128 * 7, 4, True)):
        x, seeds, signs = secure_case(torch, gen, n, J_, edge=edge)
        x = x.to(torch.bfloat16)
        got = masked_encode(x, seeds, signs)
        if not torch.equal(got, ref.masked_encode(x, seeds, signs)):
            fail(f"secure_masked_encode bf16 n={n}: differs from plain")
    sets = [(x.to(torch.bfloat16), s, g) for x, s, g in (
        secure_case(torch, gen, n_full, J)
        for _ in range(n_copies(n_full * 6)))]
    dev_pairs = [(x, ref.to_ring(s & ref.MASK32), g) for x, s, g in sets]
    kernel = [lambda c=c: masked_encode_fwd(
        c[0], c[1], c[2], n=n_full, frac_bits=16) for c in dev_pairs]
    ms, dev = time_ms(kernel), device_ms(kernel)
    plain_ms = time_ms([lambda c=c: ref.masked_encode(*c) for c in sets],
                       iters=8)
    f32 = results["secure_masked_encode"]
    b = bound(n_full * 6, n_full * J * f32["sass_per_threefry"],
              SMS * ISSUE_LANES * f32["sm_clock_mhz"] * 1e6)
    results["secure_masked_encode"]["bf16"] = {"x bf16": dict(
        max_abs_err=0.0, ms=ms, device_ms=dev, plain_ms=plain_ms,
        bound_ms=b[0], bound_by=b[1], library_ms=None,
        shape=f"x ({n_full},) bf16, 3 pairs")}
    say(f"secure_masked_encode bf16: kernel == plain at n {n_full} and 896; "
        f"kernel {ms:.4f} ms ({dev:.4f} on the device), plain "
        f"{plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")


def bf16_scans(torch, gen, results):
    """Both scans with the layer's dtype mix (Mamba-2: x, B, C bf16, dt, A
    and the state f32; RWKV-6: r, k, v bf16, w, u and the state f32), y
    (bf16) within BF16_TOL and the f32 state within SCAN_TOL of plain, at
    phase 3's prefill and decode shapes."""
    from repro_torch.kernels.mamba2_scan import ref as mref
    from repro_torch.kernels.mamba2_scan.kernel import mamba2_fwd
    from repro_torch.kernels.rwkv6_scan import ref as rref
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_fwd
    bf16 = torch.bfloat16
    H, P, N, G = 80, 64, 64, 1      # zamba2's Mamba-2 heads
    Hr, K = 40, 64                  # rwkv6-3b's heads
    scans = {
        "mamba2_scan": (
            mamba2_fwd, mref.mamba2_scan,
            lambda B, T, h0=True: mamba2_case(torch, gen, B, T, H, P, N, G,
                                              h0, dtype=bf16),
            lambda B, T: (2 * (2 * B * T * H * P + 2 * B * T * G * N)
                          + 4 * (B * T * H + H + 2 * B * H * P * N)),
            lambda B, T: B * T * H * (P * (5 * N + 1) + 2),
            f"x ({{}}, {{}}, {H}, {P}) bf16, B/C bf16, dt, A, state f32"),
        "rwkv6_scan": (
            rwkv6_fwd, rref.rwkv6_scan,
            lambda B, T, h0=True: rwkv6_case(torch, gen, B, T, Hr, K,
                                             dtype=bf16),
            lambda B, T: (2 * (3 * B * T * Hr * K + B * T * Hr * K)
                          + 4 * (B * T * Hr * K + Hr * K
                                 + 2 * B * Hr * K * K)),
            lambda B, T: B * T * Hr * (5 * K * K + 5 * K),
            f"r, k, v ({{}}, {{}}, {Hr}, {K}) bf16, w, u, state f32"),
    }
    for name, (kernel, plain, make, nbytes, flops, shape) in scans.items():
        out, errs = {}, []
        for B, T, h0 in ((1, 132, False), (1, 132, True), (8, 1, True)):
            args = make(B, T, h0)
            y, h = kernel(*args)
            ry, rh = plain(*args)
            errs.append(half_err(torch, f"{name} bf16 B={B} T={T}", y, ry))
            err = _scan_err(torch, h, rh)
            if h.dtype != torch.float32 or not err <= SCAN_TOL:
                fail(f"{name} bf16 B={B} T={T}: state {h.dtype}, scaled err "
                     f"{err:.3g} > {SCAN_TOL}")
        for label, (B, T) in (("decode", (8, 1)), ("prefill", (1, 132))):
            b = bound(nbytes(B, T), flops(B, T))
            sets = [make(B, T) for _ in range(n_copies(nbytes(B, T)))]
            calls = [lambda s=s: kernel(*s) for s in sets]
            t_k, d_k = time_ms(calls), device_ms(calls)
            t_p = time_ms([lambda s=s: plain(*s) for s in sets], iters=10)
            out[label] = dict(worst_err(errs), ms=t_k, device_ms=d_k,
                              plain_ms=t_p, bound_ms=b[0], bound_by=b[1],
                              library_ms=None, shape=shape.format(B, T))
            say(f"{name} bf16 {label}: {out[label]['shape']}: y max abs err "
                f"{out[label]['max_abs_err']:.3g} "
                f"({out[label]['max_ulps']:.3g} ulps); kernel {t_k:.4f} ms "
                f"({d_k:.4f} on the device), plain {t_p:.4f} ms, bound "
                f"{b[0]:.5f} ms ({b[1]})")
        results[name]["bf16"] = out


def check_bf16(torch, F, gen, results):
    """Every kernel but the int8 pair (check_quant holds it at every
    dtype) again with bf16 inputs, at the shapes phase 3 times: each held
    against its plain version fed the same bf16 tensors (masked encode
    bit-equal, EL2N within EL2N_TOL, bf16 outputs within BF16_TOL), timed
    beside plain, with a bound at 2 B a bf16 element."""
    bf16_prefill(torch, F, gen, results)
    bf16_decode(torch, F, gen, results)
    bf16_paged(torch, gen, results)
    bf16_el2n(torch, gen, results)
    bf16_secure(torch, gen, results)
    bf16_scans(torch, gen, results)


def check_f16(torch, F, gen, results):
    """Every kernel but the int8 pair (check_quant holds it at every
    dtype) once more with f16 inputs, at its path shape: held against its
    plain version fed the same f16 tensors (masked encode bit-equal, EL2N within EL2N_TOL, f16 outputs within
    F16_TOL, the scans' f32 state within SCAN_TOL), the largest error in
    f16 ulps of plain, and one device time each beside a bound at 2 B an
    f16 value; the all-f16 prefill and dense decode also beside one SDPA
    call on the same f16 values (K/V repeated over the group). No
    sweeps."""
    from repro_torch.kernels.el2n import ref as eref
    from repro_torch.kernels.el2n.kernel import el2n_fwd
    from repro_torch.kernels.flash_attention.decode import (
        decode_attention_fwd, grouped_decode, paged_decode_attention_fwd,
        paged_gather_decode)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, prefill_plan)
    from repro_torch.kernels.mamba2_scan import ref as mref
    from repro_torch.kernels.mamba2_scan.kernel import mamba2_fwd
    from repro_torch.kernels.rwkv6_scan import ref as rref
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_fwd
    from repro_torch.kernels.secure_mask import ref as sref
    from repro_torch.kernels.secure_mask.kernel import masked_encode_fwd
    from repro_torch.kernels.secure_mask.ops import masked_encode
    f16 = torch.float16

    def record(name, case, make, kernel, check, nbytes, flops,
               rate=BF16_FLOPS, library=None):
        """Check `kernel` on one input set (check(args, out) -> error
        dict), then its time and device time over copies past the L2, and
        those of `library(args)` (a closure over copies it prepares: one
        PyTorch call of the same function) where there is one."""
        err = check(make(), kernel)
        sets = [make() for _ in range(n_copies(nbytes))]
        calls = [lambda s=s: kernel(s) for s in sets]
        t_k, d_k = time_ms(calls), device_ms(calls)
        t_l = d_l = None
        if library is not None:
            lib = [library(s) for s in sets]
            t_l, d_l = time_ms(lib), device_ms(lib)
            del lib
        del sets, calls
        b = bound(nbytes, flops, rate)
        r = dict(err, ms=t_k, device_ms=d_k, bound_ms=b[0], bound_by=b[1],
                 library_ms=t_l, library_device_ms=d_l, shape=case)
        results.setdefault(name, {}).setdefault("f16", {})[case] = r
        lib_s = "" if t_l is None else \
            f", SDPA f16 {t_l:.4f} ms ({d_l:.4f} on the device)"
        say(f"{name} f16 {case}: max abs err {r['max_abs_err']:.3g} "
            f"({r.get('max_ulps', 0.0):.3g} ulps); kernel {t_k:.4f} ms "
            f"({d_k:.4f} on the device){lib_s}, bound {b[0]:.5f} ms "
            f"({b[1]})")

    def grouped(q, k, v):
        """(B, S, H, D) q, k, v as SDPA takes them: heads first, K/V
        repeated over the group."""
        G = q.shape[2] // k.shape[2]
        return (q.transpose(1, 2).contiguous(),
                k.repeat_interleave(G, 2).transpose(1, 2).contiguous(),
                v.repeat_interleave(G, 2).transpose(1, 2).contiguous())

    def sdpa_prefill(a, scale):
        s = grouped(*a)
        return lambda: F.scaled_dot_product_attention(*s, is_causal=True,
                                                      scale=scale)

    def sdpa_decode(a, scale):
        q, k, v, qp, kvp = a
        s = grouped(q, k, v)
        mask = ((kvp >= 0) & (kvp <= qp[:, None]))[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(*s, attn_mask=mask,
                                                      scale=scale)

    def equal(label, got, want):
        if not torch.equal(got, want):
            fail(f"{label} f16: kernel differs from plain")
        return dict(max_abs_err=0.0, max_ulps=0.0)

    # prefill, causal, S 132: Qwen2.5-14B and zamba2, through the 16-bit
    # kernel, held also against the f32 kernel's share of differing values
    report = results["flash_attention_prefill"]["instantiations"]
    for label, Hq, Hkv, Dh in (("Qwen2.5-14B", 40, 8, 128),
                               ("zamba2", 32, 32, 80)):
        scale, S = Dh ** -0.5, 132
        kw = dict(causal=True, sliding_window=None, softcap=None,
                  scale=scale, kv_len=S)

        def pq(Hq=Hq, Hkv=Hkv, Dh=Dh):
            return tuple(torch.randn((1, S, h, Dh), generator=gen,
                                     device="cuda").to(f16)
                         for h in (Hq, Hkv, Hkv))
        case = f"{label} q (1, {S}, {Hq}, {Dh}), kv {Hkv} heads, causal"
        record("flash_attention_prefill", case, pq,
               lambda a, kw=kw: flash_attention_fwd(*a, **kw),
               lambda a, k, kw=kw, label=label: prefill_16_accuracy(
                   torch, f"prefill f16 {label}", *a, k(a), f16, **kw),
               S * (2 * Hq + 2 * Hkv) * Dh * 2,
               _prefill_pairs(S, S, None) * Hq * 4 * Dh,
               library=lambda a, scale=scale: sdpa_prefill(a, scale))
        r = results["flash_attention_prefill"]["f16"][case]
        plan = prefill_plan(1, S, Hq, Dh, Dh, 2, SMS)
        r["instantiation"], regs = prefill_instantiation(report, Dh, Dh,
                                                         "f16")
        r.update(rows=plan.rows, blocks_per_sm=plan.blocks_per_sm,
                 registers=regs.get("registers"),
                 spill_bytes=regs.get("spill_bytes"))
        say(f"prefill f16 {label}: {r['differ_share']:.4f} of values differ "
            f"from plain, the f32 kernel's "
            f"{r['f32_kernel_differ_share']:.4f}; {plan.rows} rows a block, "
            f"{plan.blocks_per_sm} an SM; {r['instantiation']}: "
            f"{r['registers']} registers, {r['spill_bytes']} B spilled")

    # dense decode, 8 slots of 512, Qwen2.5-14B: q f16 over f32 and f16 K/V
    B, W, Hq, Hkv, Dh = 8, 512, 40, 8, 128
    lengths = [37, 0, 512, 200, 0, 1, 333, 100]
    for kv_dt in (torch.float32, f16):
        def dc(kv_dt=kv_dt):
            q, k, v, qp, kvp = decode_case(torch, gen, B, W, Hq, Hkv, Dh,
                                           lengths, wrap_slot=7)
            return q.to(f16), k.to(kv_dt), v.to(kv_dt), qp, kvp
        kvb = 2 if kv_dt == f16 else 4
        record("decode_attention",
               f"Qwen2.5-14B q f16, K/V {str(kv_dt)[6:]}", dc,
               lambda a: decode_attention_fwd(
                   *a, scale=Dh ** -0.5, sliding_window=None, softcap=None),
               lambda a, k: half_err(torch, "decode f16", k(a),
                                     grouped_decode(
                                         *a, scale=Dh ** -0.5,
                                         sliding_window=None, softcap=None),
                                     f16),
               B * Hq * Dh * 4 + B * W * Hkv * Dh * 2 * kvb + B * W * 4,
               B * W * Hq * 4 * Dh, BF16_FLOPS if kvb == 2 else FP32_FLOPS,
               library=(lambda a: sdpa_decode(a, Dh ** -0.5))
               if kv_dt == f16 else None)

    # paged decode, 16 slots of page 16, Qwen2.5-14B
    plens = [1, 512, 37, 200, 0, 129, 16, 17, 300, 64, 5, 96, 250, 33, 128,
             9]
    for kv_dt in (torch.float32, f16):
        def pc(kv_dt=kv_dt):
            q, k, v, tables, qp, kvp = paged_case(torch, gen, plens, 16, 32,
                                                  130, 40, 8, 128)
            return q.to(f16), k.to(kv_dt), v.to(kv_dt), tables, qp, kvp
        kvb = 2 if kv_dt == f16 else 4
        n_valid = sum(plens)
        record("paged_decode_attention",
               f"Qwen2.5-14B q f16, pool {str(kv_dt)[6:]}", pc,
               lambda a: paged_decode_attention_fwd(
                   *a, scale=128 ** -0.5, sliding_window=None, softcap=None),
               lambda a, k: half_err(torch, "paged decode f16", k(a),
                                     paged_gather_decode(
                                         *a, scale=128 ** -0.5,
                                         sliding_window=None, softcap=None),
                                     f16),
               16 * 40 * 128 * 4 + n_valid * 8 * 128 * 2 * kvb
               + n_valid * 4 + 16 * 32 * 4, n_valid * 40 * 4 * 128,
               BF16_FLOPS if kvb == 2 else FP32_FLOPS)

    # EL2N at the path's (16, 100) and an LM vocabulary
    for N, V in ((16, 100), (512, 152064)):
        def ec(N=N, V=V):
            logits, labels = el2n_case(torch, gen, N, V)
            return logits.to(f16), labels

        def echeck(a, k, N=N, V=V):
            e, c = k(a)
            we, wc = eref.fused_scores(*a)
            errs = [_el2n_err(torch, e, we), _el2n_err(torch, c, wc)]
            if not all(good for _, good in errs) or e.dtype != torch.float32:
                fail(f"el2n f16 ({N}, {V}): {[x for x, _ in errs]} beyond "
                     f"{EL2N_TOL}, or {e.dtype}")
            return dict(max_abs_err=max(x for x, _ in errs))
        record("el2n", f"logits ({N}, {V}) f16", ec, lambda a: el2n_fwd(*a),
               echeck, N * V * 2 + 3 * N * 4, 5 * N * V)
    el2n_layouts(torch, gen, f16)

    # masked encode at the full width
    n_full, J = 7_171_584, 3

    def mc():
        x, seeds, signs = secure_case(torch, gen, n_full, J)
        return x.to(f16), sref.to_ring(seeds & sref.MASK32), signs, seeds
    f32 = results["secure_masked_encode"]
    record("secure_masked_encode", f"x ({n_full},) f16, {J} pairs", mc,
           lambda a: masked_encode_fwd(a[0], a[1], a[2], n=n_full,
                                       frac_bits=16),
           lambda a, k: equal("masked encode", masked_encode(a[0], a[3],
                                                             a[2]),
                              sref.masked_encode(a[0], a[3], a[2])),
           n_full * 6, n_full * J * f32["sass_per_threefry"],
           SMS * ISSUE_LANES * f32["sm_clock_mhz"] * 1e6)

    # the scans, with the layers' dtype mix at f16, decode and prefill
    for B, T in ((8, 1), (1, 132)):
        def m2(B=B, T=T):
            return mamba2_case(torch, gen, B, T, 80, 64, 64, 1, True,
                               dtype=f16)

        def m2check(a, k, B=B, T=T):
            ry, rh = mref.mamba2_scan(*a)    # before k overwrites a[5]
            y, h = k(a)
            err = half_err(torch, f"mamba2_scan f16 B={B} T={T}", y, ry, f16)
            if h.dtype != torch.float32 or not \
                    _scan_err(torch, h, rh) <= SCAN_TOL:
                fail(f"mamba2_scan f16 B={B} T={T}: state {h.dtype} beyond "
                     f"{SCAN_TOL}")
            return err
        nbytes = mamba2_bound(B, T, 80, 64, 64, 1, xb=2)[0]
        record("mamba2_scan", f"x ({B}, {T}, 80, 64) f16, B/C f16, state "
               f"f32", m2, lambda a: mamba2_fwd(*a, state_out=a[5]),
               m2check, nbytes, B * T * 80 * (64 * (5 * 64 + 1) + 2),
               FP32_FLOPS)

        def r6(B=B, T=T):
            return rwkv6_case(torch, gen, B, T, 40, 64, dtype=f16)

        def r6check(a, k, B=B, T=T):
            (y, S), (ry, rS) = k(a), rref.rwkv6_scan(*a)
            err = half_err(torch, f"rwkv6_scan f16 B={B} T={T}", y, ry, f16)
            if S.dtype != torch.float32 or not \
                    _scan_err(torch, S, rS) <= SCAN_TOL:
                fail(f"rwkv6_scan f16 B={B} T={T}: state beyond {SCAN_TOL}")
            return err
        K = 64
        record("rwkv6_scan", f"r, k, v ({B}, {T}, 40, 64) f16, w, u, state "
               f"f32", r6, lambda a: rwkv6_fwd(*a), r6check,
               2 * 4 * B * T * 40 * K + 4 * (B * T * 40 * K + 40 * K
                                             + 2 * B * 40 * K * K),
               B * T * 40 * (5 * K * K + 5 * K), FP32_FLOPS)


def report_drift(results):
    """The device ms of the shapes the earlier paths' instantiations serve,
    beside their baseline (printed, not checked)."""
    pre, dec = results["flash_attention_prefill"], results["decode_attention"]
    now = {"prefill Qwen2.5-14B": pre["device_ms"],
           "prefill ViT-Base": pre["vit_shape"]["device_ms"],
           "prefill zamba2": pre["hd80_shape"]["device_ms"],
           "decode Qwen2.5-14B": dec["device_ms"],
           "decode zamba2": dec["hd80_shape"]["device_ms"],
           "paged decode Qwen2.5-14B":
               results["paged_decode_attention"]["device_ms"]}
    out = {}
    for name, ms in now.items():
        was = RECORDED_DEVICE_MS[name]
        out[name] = dict(device_ms=ms, baseline_device_ms=was)
        say(f"drift: {name} {ms:.4f} ms on the device, baseline "
            f"{was:.4f}, ratio {ms / was:.3f}")
    return out


# ---------------------------------------------------------------- phase 4
def wide_reduced(arch):
    """A reduced model of `arch` (three cycles of its layer pattern,
    d_model 64, vocab 128) at its published head dim and GQA group:
    gemma2-9b 4 / 2 heads of 256 with both softcaps and a window of 8 (so
    the local layers mask at these lengths), stablelm-12b 8 / 2 of 160,
    nemotron-4-340b 24 / 2 of 192."""
    from repro_torch.configs import get_config
    heads, kv, dh = {"gemma2-9b": (4, 2, 256), "stablelm-12b": (8, 2, 160),
                     "nemotron-4-340b": (24, 2, 192)}[arch]
    base = get_config(arch)
    cfg = base.reduced(n_layers=3 * len(base.layer_pattern), d_model=64,
                       d_ff=128, vocab_size=128)
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, n_heads=heads, n_kv_heads=kv, head_dim=dh,
        sliding_window=8 if cfg.attention.sliding_window else None))


def wide_parity(torch):
    """The wide families reduced (wide_reduced) and served on the card and
    on the CPU from the same seeded weights: gemma2 and nemotron through
    the dense engine, stablelm through the dense and the paged engine
    (shared prefix, chunked prefill); tokens equal, logits within 1e-4,
    wire bytes and page counters equal."""
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.launch.serve import personalized_bank, \
        shared_prefix_tokens
    from repro_torch.runtime import WireSpec
    from repro_torch.serve import (PagedServeConfig, PagedServeEngine,
                                   ServeConfig, ServeEngine, TenantBank,
                                   WorkloadConfig, synthetic_requests)
    from repro_torch.tree import tree_map
    counters = ("wire_bytes", "page_copies", "prefix_hits", "prefix_misses",
                "prefill_chunks", "peak_pages", "pages_in_use")
    out = {}
    for arch, kinds in (("gemma2-9b", ("dense",)),
                        ("stablelm-12b", ("dense", "paged")),
                        ("nemotron-4-340b", ("dense",))):
        cfg = wide_reduced(arch)
        model = SplitModel(cfg, SplitConfig(head_cycles=1, tail_cycles=1,
                                            prompt_len=4),
                           WireSpec.make("fp32"))
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        bank = personalized_bank(model, params, 3, jitter=0.2)
        reqs = synthetic_requests(WorkloadConfig(
            n_requests=6, prompt_choices=(6, 11), new_token_choices=(3, 6),
            n_tenants=3, vocab_size=cfg.vocab_size, seed=3))
        for kind in kinds:
            runs = {}
            for dev in ("cpu", "cuda"):
                p = tree_map(lambda x: x.to(dev), params)
                b = TenantBank(tree_map(lambda x: x.to(dev), bank.tails),
                               bank.prompts.to(dev))
                if kind == "paged":
                    eng = PagedServeEngine(model, p, b, PagedServeConfig(
                        n_slots=3, max_seq=48, decode_block=4, page_size=8,
                        shared_prefix=shared_prefix_tokens(8, 128),
                        prefill_chunk=4), collect_logits=True, device=dev)
                else:
                    eng = ServeEngine(model, p, b, ServeConfig(
                        n_slots=3, max_seq=48, decode_block=4),
                        collect_logits=True, device=dev)
                st = eng.run(reqs)
                runs[dev] = ({f.req.rid: f for f in st["finished"]},
                             {k: st.get(k) for k in counters})
            att = cfg.attention
            label = f"{arch} {kind} engine parity"
            worst = compare_runs(label, runs)
            say(f"{label} ({att.n_heads} / {att.n_kv_heads} heads of "
                f"{att.head_dim}, {cfg.n_layers} layers, fp32 wire, 6 "
                f"requests): tokens ==, max logit diff {worst:.3g}, wire "
                f"bytes{' and page counters' if kind == 'paged' else ''} ==")
            out[f"{arch} {kind}"] = worst
    return out


def compare_runs(label, runs):
    """`runs[dev]` = (finished requests by rid, counters) for "cpu" and
    "cuda": fail unless every request's tokens are equal, its logits within
    PARITY_TOL and the counters (wire bytes, page counters) equal; returns
    the largest logit difference."""
    worst = 0.0
    for rid, f_cpu in runs["cpu"][0].items():
        f_gpu = runs["cuda"][0][rid]
        if not (f_cpu.tokens == f_gpu.tokens).all():
            fail(f"{label} rid={rid}: tokens {f_gpu.tokens.tolist()} on the "
                 f"card vs {f_cpu.tokens.tolist()} on the CPU")
        worst = max(worst, float(abs(f_cpu.logits - f_gpu.logits).max()))
    if worst > PARITY_TOL:
        fail(f"{label}: max logit difference {worst:.3g} > {PARITY_TOL}")
    if runs["cpu"][1] != runs["cuda"][1]:
        fail(f"{label}: wire bytes or page counters differ between devices: "
             f"{runs['cuda'][1]} vs {runs['cpu'][1]}")
    return worst


def gqa_reduced():
    from repro_torch.configs import get_config
    cfg = get_config("qwen2.5-14b").reduced(n_layers=3, d_model=160,
                                            d_ff=128, vocab_size=128)
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, n_heads=10, n_kv_heads=2, head_dim=16))


def engine_parity(torch):
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.launch.serve import personalized_bank, \
        shared_prefix_tokens
    from repro_torch.runtime import WireSpec
    from repro_torch.serve import (PagedServeConfig, PagedServeEngine,
                                   ServeConfig, ServeEngine, TenantBank,
                                   WorkloadConfig, synthetic_requests)
    from repro_torch.tree import tree_map
    cfg = gqa_reduced()
    model = SplitModel(cfg, SplitConfig(head_cycles=1, tail_cycles=1,
                                        prompt_len=4), WireSpec.make("fp32"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    bank = personalized_bank(model, params, 3, jitter=0.2)
    reqs = synthetic_requests(WorkloadConfig(
        n_requests=6, prompt_choices=(6, 11), new_token_choices=(3, 6),
        n_tenants=3, vocab_size=cfg.vocab_size, seed=3))
    engines = {
        "dense": lambda p, b, dev: ServeEngine(
            model, p, b, ServeConfig(n_slots=3, max_seq=48, decode_block=4),
            collect_logits=True, device=dev),
        "paged": lambda p, b, dev: PagedServeEngine(
            model, p, b, PagedServeConfig(
                n_slots=3, max_seq=48, decode_block=4, page_size=8,
                shared_prefix=shared_prefix_tokens(8, cfg.vocab_size),
                prefill_chunk=4),
            collect_logits=True, device=dev),
    }
    counters = ("wire_bytes", "page_copies", "prefix_hits", "prefix_misses",
                "prefill_chunks", "peak_pages", "pages_in_use")
    for kind, make in engines.items():
        runs = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda x: x.to(dev), params)
            b = TenantBank(tree_map(lambda x: x.to(dev), bank.tails),
                           bank.prompts.to(dev))
            st = make(p, b, dev).run(reqs)
            runs[dev] = ({f.req.rid: f for f in st["finished"]},
                         {k: st.get(k) for k in counters})
        worst = compare_runs(f"{kind} engine parity", runs)
        say(f"{kind} engine parity ({cfg.name}, G=5, fp32 wire, 6 requests"
            f"{', page 8, shared prefix 8, chunks of 4' if kind == 'paged' else ''}"
            f"): tokens ==, max logit diff {worst:.3g}, wire bytes "
            f"{'and page counters ' if kind == 'paged' else ''}==")


def gap_rule(label, gaps, ref_gaps):
    """The bf16 gap rule over every logit of every request: the mean of
    |port_bf16 - reference_bf16| may not exceed the mean of
    |reference_bf16 - reference_f32| on the same requests. Fails on a
    non-finite logit; returns both means and both maxima."""
    import numpy as np
    gap, ref = np.concatenate(gaps), np.concatenate(ref_gaps)
    if not np.isfinite(gap).all():
        fail(f"{label}: a logit is not finite")
    out = dict(gap_mean=float(gap.mean()), bf16_f32_mean=float(ref.mean()),
               gap_max=float(gap.max()), bf16_f32_max=float(ref.max()))
    if out["gap_mean"] > out["bf16_f32_mean"]:
        fail(f"{label}: mean logit gap {out['gap_mean']:.4g} exceeds the "
             f"bf16-vs-f32 gap {out['bf16_f32_mean']:.4g}")
    return out


def engine_parity_bf16(torch):
    """Phase 4 at bf16: the reduced Qwen2.5 (GQA 5) on the int8 wire through
    the dense and the paged engine with ServeConfig(dtype=bfloat16), card
    against CPU. Wire bytes and page counters equal; every logit finite;
    the gap rule with the card in the port's place and the CPU in the
    reference's: teacher-forced through the step functions on the CPU's
    tokens, the card's mean logit gap to the CPU at bf16 is no more than
    the CPU's own bf16-vs-f32 gap. The paged engine's logits are compared
    where its card and CPU tokens still agree (every step up to the first
    that differs; free-running tokens are printed, not required equal)."""
    import numpy as np
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.launch.serve import personalized_bank, \
        shared_prefix_tokens
    from repro_torch.runtime import WireSpec
    from repro_torch.serve import (PagedServeConfig, PagedServeEngine,
                                   ServeConfig, ServeEngine, TenantBank,
                                   WorkloadConfig, synthetic_requests)
    from repro_torch.serve.steps import forced_logits
    from repro_torch.tree import tree_map
    bf16 = torch.bfloat16
    cfg = gqa_reduced()
    model = SplitModel(cfg, SplitConfig(head_cycles=1, tail_cycles=1,
                                        prompt_len=4), WireSpec.make("int8"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    bank = personalized_bank(model, params, 3, jitter=0.2)
    reqs = synthetic_requests(WorkloadConfig(
        n_requests=6, prompt_choices=(6, 11), new_token_choices=(3, 6),
        n_tenants=3, vocab_size=cfg.vocab_size, seed=3))
    on = {dev: (tree_map(lambda x: x.to(dev), params),
                TenantBank(tree_map(lambda x: x.to(dev), bank.tails),
                           bank.prompts.to(dev)))
          for dev in ("cpu", "cuda")}
    engines = {
        "dense": lambda p, b, dev: ServeEngine(
            model, p, b, ServeConfig(n_slots=3, max_seq=48, decode_block=4,
                                     dtype=bf16),
            collect_logits=True, device=dev),
        "paged": lambda p, b, dev: PagedServeEngine(
            model, p, b, PagedServeConfig(
                n_slots=3, max_seq=48, decode_block=4, page_size=8,
                shared_prefix=shared_prefix_tokens(8, cfg.vocab_size),
                prefill_chunk=4, dtype=bf16),
            collect_logits=True, device=dev),
    }
    counters = ("wire_bytes", "tokens_out", "decode_steps", "prefills",
                "page_copies", "prefix_hits", "prefix_misses",
                "prefill_chunks", "peak_pages", "pages_in_use")
    runs = {}
    for kind, make in engines.items():
        runs[kind] = {dev: make(*on[dev], dev).run(reqs)
                      for dev in ("cpu", "cuda")}
        got = {k: runs[kind]["cuda"].get(k) for k in counters}
        want = {k: runs[kind]["cpu"].get(k) for k in counters}
        if got != want:
            fail(f"{kind} engine bf16: wire bytes or counters differ between "
                 f"devices: {got} vs {want}")
    # the reference gap: the CPU at bf16 against the CPU at f32, both
    # teacher-forced on the CPU's bf16 dense tokens
    forced = {}
    for f in runs["dense"]["cpu"]["finished"]:
        toks = f.tokens.tolist()
        forced[f.req.rid] = {
            (dev, str(dt)): forced_logits(
                model, {"head": on[dev][0]["head"],
                        "body": on[dev][0]["body"]}, on[dev][1], f.req, toks,
                dtype=dt, max_seq=48, device=dev)
            for dev, dt in (("cpu", bf16), ("cuda", bf16),
                            ("cpu", torch.float32))}
    ref_gaps = [np.abs(r[("cpu", str(bf16))] - r[("cpu", "torch.float32")])
                .ravel() for r in forced.values()]
    out = {"dense": gap_rule("dense engine bf16", [
        np.abs(r[("cuda", str(bf16))] - r[("cpu", str(bf16))]).ravel()
        for r in forced.values()], ref_gaps)}
    cpu = {f.req.rid: f for f in runs["paged"]["cpu"]["finished"]}
    gaps, same = [], 0
    for f in runs["paged"]["cuda"]["finished"]:
        c = cpu[f.req.rid]
        agree = int(np.cumprod(f.tokens == c.tokens).sum())
        same += agree == len(f.tokens)
        n = min(agree + 1, len(f.tokens))   # the step that parts included
        gaps.append(np.abs(f.logits[:n] - c.logits[:n]).ravel())
    out["paged"] = gap_rule("paged engine bf16", gaps, ref_gaps)
    dense_same = sum((f.tokens == g.tokens).all() for f, g in zip(
        runs["dense"]["cpu"]["finished"], runs["dense"]["cuda"]["finished"]))
    for kind, r in out.items():
        r["free_running_tokens_equal"] = int(
            same if kind == "paged" else dense_same)
        say(f"{kind} engine parity at bf16 ({cfg.name}, G=5, int8 wire, "
            f"{len(reqs)} requests): wire bytes and counters ==; mean logit "
            f"gap card vs CPU {r['gap_mean']:.4g} <= the CPU's bf16-vs-f32 "
            f"{r['bf16_f32_mean']:.4g} (max {r['gap_max']:.4g} vs "
            f"{r['bf16_f32_max']:.4g}); free-running tokens equal in "
            f"{r['free_running_tokens_equal']} of {len(reqs)} requests")
    return out


def recurrent_parity(torch):
    """The reduced recurrent families (zamba2 at 18 layers: 3 cycles of 5
    Mamba-2 layers and the shared attention block; rwkv6 at 3 layers) served
    by the dense engine on the card and on the CPU from the same seeded
    weights: tokens equal, logits within 1e-4, wire bytes equal.

    The tenants' tails are the launcher's bank (jitter 0.05). The model's
    own conditioning is printed beside the check: the CPU run again with
    every tail weight scaled by (1 + 1e-7 n), n standard normal, which is
    about the rounding that separates the card's sums from the CPU's. A
    6-layer zamba2 tail jittered by 0.2 (ten times its init scale)
    amplifies that to more than 1e-4: zamba2 is served at that jitter too,
    and the card-vs-CPU gap is printed beside the nudge's, not checked."""
    from repro_torch.configs import get_config
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.launch.serve import personalized_bank
    from repro_torch.runtime import WireSpec
    from repro_torch.serve import (ServeConfig, ServeEngine, TenantBank,
                                   WorkloadConfig, synthetic_requests)
    from repro_torch.tree import tree_map
    out = {}
    for arch in ("zamba2-2.7b", "rwkv6-3b"):
        base = get_config(arch)
        cfg = base.reduced(n_layers=3 * len(base.layer_pattern))
        model = SplitModel(cfg, SplitConfig(head_cycles=1, tail_cycles=1,
                                            prompt_len=4),
                           WireSpec.make("fp32"))
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        reqs = synthetic_requests(WorkloadConfig(
            n_requests=6, prompt_choices=(6, 11), new_token_choices=(3, 6),
            n_tenants=3, vocab_size=cfg.vocab_size, seed=3))

        def serve(jitter):
            """Runs on the CPU, the card and the CPU with nudged tails;
            returns them and the nudge's largest logit change."""
            bank = personalized_bank(model, params, 3, jitter=jitter)
            gen = torch.Generator().manual_seed(5)
            nudged = TenantBank(
                tree_map(lambda x: x * (1 + 1e-7 * torch.randn(
                    x.shape, generator=gen)), bank.tails), bank.prompts)
            runs = {}
            for dev, b in (("cpu", bank), ("cuda", bank), ("nudged", nudged)):
                on = "cpu" if dev == "nudged" else dev
                st = ServeEngine(
                    model, tree_map(lambda x: x.to(on), params),
                    TenantBank(tree_map(lambda x: x.to(on), b.tails),
                               b.prompts.to(on)),
                    ServeConfig(n_slots=3, max_seq=48, decode_block=4),
                    collect_logits=True, device=on).run(reqs)
                runs[dev] = ({f.req.rid: f for f in st["finished"]},
                             st["wire_bytes"])
            nudge = max(float(abs(f.logits - runs["nudged"][0][rid].logits)
                              .max()) for rid, f in runs["cpu"][0].items())
            return runs, nudge

        runs, nudge = serve(0.05)
        worst = compare_runs(f"{arch} engine parity", runs)
        say(f"{arch} engine parity ({cfg.name}, {cfg.n_layers} layers, fp32 "
            f"wire, 6 requests): tokens ==, max logit diff {worst:.3g}, "
            f"wire bytes ==; the CPU's own logit change under a 1e-7 "
            f"relative nudge of the tails {nudge:.3g}")
        out[arch] = {"max_logit_diff": worst, "layers": cfg.n_layers,
                     "cpu_nudge_logit_diff": nudge}
        if arch == "zamba2-2.7b":
            # printed, not checked: the bank jittered by 0.2 (ten times the
            # tail's init scale), where the tail amplifies rounding
            runs, nudge = serve(0.2)
            gap = max(float(abs(f.logits - runs["cuda"][0][rid].logits)
                            .max()) for rid, f in runs["cpu"][0].items()
                      if f.logits.shape == runs["cuda"][0][rid].logits.shape)
            same = all((f.tokens == runs["cuda"][0][rid].tokens).all()
                       for rid, f in runs["cpu"][0].items())
            say(f"{arch} at jitter 0.2 (not checked): card vs CPU max logit "
                f"diff {gap:.3g}, tokens {'==' if same else '!='}; the "
                f"CPU's own change under the 1e-7 nudge {nudge:.3g} (ratio "
                f"{gap / max(nudge, 1e-30):.3g})")
            out[arch].update(jitter02_card_cpu_logit_diff=gap,
                             jitter02_tokens_equal=same,
                             jitter02_cpu_nudge_logit_diff=nudge)
    return out


# ------------------------------------------------ phases 5-6 and 10-11
def full_width_model(torch, arch="qwen2.5-14b", n_layers=3, tenants=4,
                     cfg=None):
    """A model at `arch`'s published widths cut to `n_layers` (one cycle
    of the layer pattern in the head and in the tail, the rest in the
    body; a dense prefix stays in the head), soft prompt 4, int8 wire,
    fp32, `tenants` tenants, seeded random weights; `cfg` replaces the
    cut config (phase 20 also cuts deepseek-v3's routed experts).
    Qwen2.5-14B at 3 layers is shared by the dense and the paged
    full-width runs."""
    from repro_torch.configs import get_config
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.launch.serve import personalized_bank
    from repro_torch.runtime import WireSpec
    cfg = cfg or dataclasses.replace(get_config(arch), n_layers=n_layers)
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=4)
    model = SplitModel(cfg, split, WireSpec.make("int8"))
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, device="cuda")
    bank = personalized_bank(model, params, tenants)
    del params["tail"]
    torch.cuda.synchronize()
    cyc = len(cfg.layer_pattern)
    dense = (f"{cfg.n_dense_layers} dense + " if cfg.n_dense_layers else "")
    desc = (f"{cfg.name} widths, {cfg.n_layers} layers ({dense}1 head / "
            f"{model.body_cycles * cyc} body / 1 tail)" if cyc == 1 else
            f"{cfg.name} widths, {cfg.n_layers} layers ({cfg.n_cycles} "
            f"cycles of {cyc}: 1 head / {model.body_cycles} body / 1 tail)")
    return dict(cfg=cfg, split=split, model=model, params=params, bank=bank,
                desc=desc, tenants=tenants,
                setup_s=time.perf_counter() - t0)


def run_path(torch, path, engine, reqs, warm):
    """Warm the engine up on `warm`, then run `reqs` with every launch
    count zeroed just before and read just after; fail unless every
    request finished with in-range tokens and every kernel of `path` was
    launched."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import layers
    engine.run(warm)       # cuBLAS handles, allocator pools, the library
    engine.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    syncs = layers.moe_host_syncs
    stats = engine.run(reqs)
    torch.cuda.synchronize()
    launches = launch_counts()
    # the MoE blocks' group-size reads (one an `apply_moe` call)
    stats["moe_host_syncs"] = layers.moe_host_syncs - syncs
    vocab = engine.model.cfg.vocab_size
    if stats["n_finished"] != len(reqs):
        fail(f"{path} full width: {stats['n_finished']} of {len(reqs)} "
             f"requests finished")
    for f in stats["finished"]:
        if len(f.tokens) != f.req.max_new or f.tokens.min() < 0 \
                or f.tokens.max() >= vocab:
            fail(f"{path} full width: request {f.req.rid} gave "
                 f"{f.tokens.tolist()}")
    missing = [k for k in PATHS[path] if launches[k] <= 0]
    if missing:
        fail(f"{path} full width: kernels of the path never launched: "
             f"{missing}")
    return stats, launches


def _summary(torch, stats, fw, extra):
    out = {
        "requests": stats["n_finished"], "tokens_out": stats["tokens_out"],
        "wall_s": stats["wall_s"], "tok_per_s": stats["tok_per_s"],
        "p50_latency_s": stats["p50_latency_s"],
        "slowest_latency_s": max(f.latency_s for f in stats["finished"]),
        "decode_steps": stats["decode_steps"],
        "occupancy": stats["occupancy"],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "setup_s": fw["setup_s"],
    }
    out.update(extra)
    return out


WORKLOAD = dict(mean_interarrival=1.0, prompt_choices=(32, 64, 96, 128),
                new_token_choices=(16, 24, 32), n_tenants=4)


def full_width(torch, fw, path="dense", dtype=None):
    """One model through the dense engine at full width with phase 5's
    traffic: 4 tenants, 8 slots, max_seq 512, int8 wire, decode_block 8,
    16 synthetic requests of 32-128 prompt and 16-32 new tokens; at f32
    activations, or at `dtype` (phase 12: bf16, with the first-token
    logit gap to f32 printed)."""
    from repro_torch.core.comm import serve_comm_breakdown
    from repro_torch.serve import (ServeConfig, ServeEngine, WorkloadConfig,
                                   synthetic_requests)
    cfg, split, model = fw["cfg"], fw["split"], fw["model"]
    dtype = dtype or torch.float32
    engine = ServeEngine(model, fw["params"], fw["bank"],
                         ServeConfig(n_slots=8, max_seq=512, decode_block=8,
                                     dtype=dtype),
                         device="cuda")
    wl = dict(WORKLOAD, vocab_size=cfg.vocab_size, n_tenants=fw["tenants"])
    reqs = synthetic_requests(WorkloadConfig(n_requests=16, seed=0, **wl))
    stats, launches = run_path(
        torch, path, engine, reqs,
        synthetic_requests(WorkloadConfig(n_requests=2, seed=1, **wl)))
    analytical = serve_comm_breakdown(
        model.wire, d_model=cfg.d_model, soft_prompt_len=split.prompt_len,
        requests=[(len(r.tokens), r.max_new) for r in reqs])
    wire_err = {}
    for name, want in analytical.items():
        got = stats["wire_bytes"][name]
        wire_err[name] = abs(got - want) / want
        if wire_err[name] > 0.05:
            fail(f"{path} full width: {name} measured {got} B vs analytical "
                 f"{want} B")
    summary = _summary(torch, stats, fw, {
        "config": f"{fw['desc']}, {fw['tenants']} tenants, 8 slots, "
                  f"max_seq 512, int8 wire, decode_block 8, "
                  f"{str(dtype)[6:]}",
        "wire_rel_err": wire_err, "launches": launches})
    if "moe" in cfg.layer_pattern:
        # every prefill runs each MoE layer once; a decode step runs the
        # head's and body's once and the tail's once a tenant present
        n_moe = cfg.n_layers - cfg.n_dense_layers
        decode_syncs = stats["moe_host_syncs"] - stats["prefills"] * n_moe
        summary.update(
            moe_host_syncs=stats["moe_host_syncs"],
            moe_host_syncs_per_decode_step=(decode_syncs
                                            / max(1, stats["decode_steps"])),
            prefills=stats["prefills"])
    if dtype != torch.float32:
        summary["first_token_gap_to_f32"] = first_token_gap(torch, fw, reqs,
                                                            dtype)
    say(f"{path} full width: " + json.dumps(summary, sort_keys=True))
    summary["profile"] = profile_replay(torch, engine, reqs)
    say(f"{path} profile: " + json.dumps(summary["profile"], sort_keys=True))
    if path == "hybrid":
        scan_replay(summary["profile"], "hybrid", "Mamba-2",
                    ("mamba2_chunk_kernel", "mamba2_step_kernel"))
    if path == "rwkv":
        scan_replay(summary["profile"], "rwkv", "RWKV-6",
                    ("rwkv6_chunk_kernel", "rwkv6_step_kernel"))
    del engine
    return launches, summary


def scan_replay(prof, path, label, names):
    """A replay's scan launches and device us a launch, the chunked
    (prefill) and the step kernel (decode) apart, beside the replay's copy
    time; fails unless both kernels ran."""
    us, n = prof["port_kernel_us_per_launch"], prof["port_kernel_launches"]
    missing = [k for k in names if not n.get(k)]
    if missing:
        fail(f"{path} replay: {label} kernels never launched: {missing}")
    by_kind = prof["device_ms_by_kind"]
    copies = by_kind.get("copies and casts (copy_ / to)", 0.0)
    say(f"{path} replay {label}: " + "; ".join(
        f"{k} {n[k]} launches x {us[k]:.2f} us = {n[k] * us[k] * 1e-3:.2f} "
        f"ms" for k in names)
        + f"; copies and casts {copies:.2f} ms; memcpy/memset "
          f"{by_kind.get('memcpy/memset', 0.0):.2f} ms")


def full_width_paged(torch, fw, path="paged", dtype=None):
    """The paged path at full width: 16 slots over a pool of 128 usable
    pages of 16 tokens — the KV memory of 4 dense 512-token slots (393,216
    B a page over 3 layers) — with a 32-token shared prefix and prefill
    chunks of 64; at f32 activations, or at `dtype` (phase 13: bf16)."""
    from repro_torch.launch.serve import shared_prefix_tokens
    from repro_torch.serve import (PagedServeConfig, PagedServeEngine,
                                   WorkloadConfig, synthetic_requests)
    cfg, split, model = fw["cfg"], fw["split"], fw["model"]
    prefix = shared_prefix_tokens(32, cfg.vocab_size)
    dtype = dtype or torch.float32
    pcfg = PagedServeConfig(n_slots=16, max_seq=512, decode_block=8,
                            page_size=16, n_pages=130, shared_prefix=prefix,
                            prefill_chunk=64, dtype=dtype)
    engine = PagedServeEngine(model, fw["params"], fw["bank"], pcfg,
                              device="cuda")
    wl = dict(WORKLOAD, vocab_size=cfg.vocab_size)
    reqs = synthetic_requests(WorkloadConfig(n_requests=24, seed=0, **wl))
    stats, launches = run_path(
        torch, path, engine, reqs,
        synthetic_requests(WorkloadConfig(n_requests=2, seed=1, **wl)))
    joins = stats["prefix_hits"] + stats["prefix_misses"]
    if stats["pages_in_use"] != 0 or joins != len(reqs) \
            or stats["page_copies"] != len(reqs):
        fail(f"{path} full width: pages_in_use {stats['pages_in_use']}, "
             f"prefix joins {joins}, page copies {stats['page_copies']} "
             f"(want 0, {len(reqs)}, {len(reqs)}: the {len(prefix)}-token "
             f"prefix + soft prompt is not page-aligned)")
    # exact bytes: each request's own tokens at prefill (the prefix is not
    # re-sent), max_new - 1 decode crossings, and one [soft prompt |
    # prefix] prefill per prefix MISS; the int8 payload is linear in rows,
    # so chunking does not change it
    wire_err = {}
    for b in model.wire.boundaries:
        nbytes = b.codec.payload_nbytes
        want = sum(nbytes((1, len(r.tokens), cfg.d_model))
                   + (r.max_new - 1) * nbytes((1, 1, cfg.d_model))
                   for r in reqs)
        want += stats["prefix_misses"] * nbytes(
            (1, split.prompt_len + len(prefix), cfg.d_model))
        got = stats["wire_bytes"][b.name]
        wire_err[b.name] = abs(got - want) / want
        if wire_err[b.name] > PAGED_WIRE_TOL:
            fail(f"{path} full width: {b.name} measured {got} B vs exact "
                 f"{want} B")
    summary = _summary(torch, stats, fw, {
        "config": f"{fw['desc']}, 4 tenants, 16 slots, max_seq 512, "
                  f"page 16, 130 pages (128 usable), shared prefix "
                  f"{len(prefix)}, prefill_chunk 64, int8 wire, "
                  f"decode_block 8, {str(dtype)[6:]}",
        "peak_pages": stats["peak_pages"],
        "prefix_hit_ratio": stats["prefix_hit_ratio"],
        "prefix_misses": stats["prefix_misses"],
        "page_copies": stats["page_copies"],
        "prefill_chunks": stats["prefill_chunks"],
        "wire_rel_err": wire_err, "launches": launches})
    say(f"{path} full width: " + json.dumps(summary, sort_keys=True))
    summary["profile"] = profile_replay(torch, engine, reqs)
    say(f"{path} profile: " + json.dumps(summary["profile"], sort_keys=True))
    return launches, summary


def first_token_gap(torch, fw, reqs, dtype):
    """Printed, not checked: each request's prefill logits at `dtype`
    against f32 (the same weights, through the engine's prefill step), the
    largest and the mean absolute gap over every request and logit."""
    import numpy as np
    from repro_torch.serve.steps import forced_logits
    shared = {"head": fw["params"]["head"], "body": fw["params"]["body"]}
    gaps = []
    for r in reqs:
        one = [forced_logits(fw["model"], shared, fw["bank"], r, [0],
                             dtype=dt, max_seq=512, device="cuda")
               for dt in (dtype, torch.float32)]
        gaps.append(np.abs(one[0] - one[1]).ravel())
    gaps = np.concatenate(gaps)
    return dict(max=float(gaps.max()), mean=float(gaps.mean()))


def profile_replay(torch, engine, reqs):
    """Replay the measured trace under torch.profiler (CUDA activity) and
    the engine's own step-level tracer: device busy share, device time by
    kernel, and host time in prefill vs decode spans. A separate run, so
    the measured run above carries no tracing cost. Device activity only:
    tracing every CPU operator as well slowed the replay's host, so the
    busy share read low."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.trace import Tracer
    engine.reset_stats()
    engine.tracer = Tracer("step")
    torch.cuda.synchronize()
    t_replay = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = {}
    for rec in engine.tracer.records():
        if rec.get("kind") == "span":
            spans[rec["name"]] = spans.get(rec["name"], 0) + rec["dur_ns"]
    out = {"wall_s": wall, "tokens_out": stats["tokens_out"],
           "host_span_s": {k: v * 1e-9 for k, v in spans.items()}}
    out.update(device_summary(prof, wall))
    # the replay with its trace's processing: what profiling costs the run
    out["profile_s"] = time.perf_counter() - t_replay
    return out


def device_summary(prof, wall):
    """Device busy share of `wall`, device time by kernel and by kind, from
    a finished torch.profiler run."""
    # device work only (device_events). Kernels are keyed by the first 60
    # characters of their names (after a leading "void at::native::", so
    # PyTorch's elementwise kernels keep the name of their functor), and
    # the template instances of one cuBLAS kernel add up under one key.
    kernels, by_kind, spans_us, port_n, fills = {}, {}, [], {}, 0
    for name, start, end in device_events(prof):
        us = end - start
        fills += "FillFunctor" in name
        key = name.removeprefix("void at::native::")[:60]
        kernels[key] = kernels.get(key, 0) + us
        kind = _device_kind(name)
        by_kind[kind] = by_kind.get(kind, 0) + us
        port = next((k for k in PORT_KERNELS
                     if re.search(rf"(^|[^A-Za-z_]){k}\b", name)), None)
        if port is not None:
            port_n[port] = port_n.get(port, (0, 0))
            port_n[port] = (port_n[port][0] + 1, port_n[port][1] + us)
        spans_us.append((start, end))
    busy_us, reach = 0, None   # union of the device intervals
    for start, end in sorted(spans_us):
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {
        "device_busy_share": busy_us * 1e-6 / wall,
        "device_kernel_s": sum(kernels.values()) * 1e-6,
        "device_kernels": len(kernels),
        "device_ms_by_kind": {k: us * 1e-3 for k, us in by_kind.items()},
        "top_device_ms": {name: us * 1e-3 for name, us in top},
        # device time a launch of each of the port's kernels, averaged over
        # the replay's shapes: unlike phase 3's event timing of single
        # wrapper calls, no host time between launches is in it
        "port_kernel_us_per_launch": {k: us / n
                                      for k, (n, us) in port_n.items()},
        "port_kernel_launches": {k: n for k, (n, _) in port_n.items()},
        # PyTorch's fill kernels (torch.full, zeros, fill_): until the int8
        # wire took u by value, one ran at every round-to-nearest crossing
        "fill_launches": fills,
    }


# device-side names of the port's own kernels (csrc/)
PORT_KERNELS = ("decode_kernel", "paged_decode_kernel",
                "decode_combine_kernel", "flash_narrow_kernel",
                "flash_wide_kernel", "flash16_kernel", "quantize_kernel",
                "dequantize_kernel", "el2n_warp_kernel",
                # flash_fwd_kernel, flash_fwd_wide_kernel: the f32 narrow
                # and wide layouts of checkouts from before their redesigns,
                # which tools/time_prefill.py times beside this tree
                "flash_fwd_kernel", "flash_fwd_wide_kernel",
                # el2n_kernel: the EL2N kernel of checkouts from before its
                # warp and block layouts, which tools/time_el2n.py --replays
                # times beside this tree
                "el2n_stream_kernel", "el2n_kernel", "masked_encode_kernel",
                "mamba2_chunk_kernel", "mamba2_step_kernel",
                "rwkv6_chunk_kernel", "rwkv6_step_kernel")


def _device_kind(name: str) -> str:
    """Coarse class of a device event, for the time breakdown in PERF.md.
    cuBLAS's bf16 products on Hopper are its `nvjet` kernels. Copies are
    PyTorch's copy kernels (`direct_copy_kernel_cuda`, and
    `bfloat16_copy_kernel_cuda` for f32 -> bf16): the per-call weight
    casts of a bf16 run land there."""
    if any(k in name for k in PORT_KERNELS):
        return "port kernels"
    if "gemm" in name.lower() or "gemv" in name.lower() \
            or name.startswith("nvjet"):
        return "cuBLAS gemm/gemv"
    if "copy_kernel" in name:
        return "copies and casts (copy_ / to)"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "memcpy/memset"
    return "other (elementwise, reductions, index)"


# ---------------------------------------------------------------- phase 7
def numpy_wire_noise(torch, device):
    """Stochastic-rounding uniforms from numpy, seeded by (client, step,
    boundary), so the card and the CPU round the int8 wire alike."""
    import numpy as np

    def noise(client, step, name, shape):
        rng = np.random.default_rng(
            [client, step, 0 if name == "head_body" else 1])
        return tuple(torch.from_numpy(rng.random(shape, dtype=np.float32))
                     .to(device) for _ in range(2))
    return noise


def training_parity(torch):
    """One round of the reduced ViT on the card and on the CPU from the same
    weights, data and wire noise, for the fp32 and the int8 wire."""
    from repro_torch.configs import get_config
    from repro_torch.core import (ProtocolConfig, SFPromptTrainer,
                                  SplitConfig, SplitModel)
    from repro_torch.data import (DATASETS, iid_partition, select_clients,
                                  stack_clients, synthetic_image_dataset)
    from repro_torch.runtime import WireSpec
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config("vit-base").reduced(n_layers=3, d_model=64, d_ff=128)
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=4,
                        prune_gamma=0.5, local_epochs=1)
    pcfg = ProtocolConfig(clients_per_round=2, local_epochs=1, batch_size=8,
                          lr_local=0.05, lr_split=0.05)
    d = synthetic_image_dataset(DATASETS["cifar10-syn"], 8 * 24 + 64, seed=0,
                                image_hw=32)
    train = {k: v[:8 * 24] for k, v in d.items()}
    test = {k: v[8 * 24:] for k, v in d.items()}
    cohort = stack_clients(iid_partition(train, 8, seed=0),
                           select_clients(8, 2, seed=0, round_idx=0))
    report = {}
    for wire in ("fp32", "int8"):
        model = SplitModel(cfg, split, WireSpec.make(wire))
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        runs = {}
        for dev in ("cpu", "cuda"):
            tr = SFPromptTrainer(model, pcfg, device=dev)
            state, m = tr.round(
                {"params": tree_map(lambda x: x.to(dev), params),
                 "round": 0}, cohort, wire_noise=numpy_wire_noise(torch, dev))
            ev = tr.evaluate(state["params"], test, batch_size=16)
            runs[dev] = (state["params"], m, tr.last_scores.cpu(),
                         tr.last_kept.cpu(), ev)
        (pc, mc, sc, kc, evc), (pg, mg, sg, kg, evg) = runs["cpu"], \
            runs["cuda"]
        for key in mc:
            if (key.startswith(("wire/", "cohort/")) or key == "kept_frac") \
                    and mg[key] != mc[key]:
                fail(f"training parity ({wire} wire): {key} {mg[key]} on the "
                     f"card vs {mc[key]} on the CPU")
        # this seed has no near-tie at the cut: any difference in the kept
        # sets is a fault (were a new seed to put a score within the
        # tolerance of the cut, the seed would change, not the check)
        for k in range(kc.shape[0]):
            cut = float(sc[k, kc[k, -1]])
            differ = set(kc[k].tolist()) ^ set(kg[k].tolist())
            if differ:
                fail(f"training parity ({wire} wire): client {k} kept "
                     f"samples {sorted(differ)} on one device only, scores "
                     f"{[float(sc[k, i]) for i in sorted(differ)]} vs cut "
                     f"{cut}")
        param_diff = max(float((a.cpu() - b).abs().max())
                         for a, b in zip(tree_leaves(pg), tree_leaves(pc)))
        loss_diff = max(abs(mg[k] - mc[k])
                        for k in ("local_loss", "split_loss", "el2n_mean"))
        score_diff = float((sg - sc).abs().max())
        # both wires: the int8 run gets the same noise on both devices
        if max(param_diff, loss_diff) > PARITY_TOL:
            fail(f"training parity ({wire} wire): params differ by "
                 f"{param_diff:.3g}, losses by {loss_diff:.3g} > {PARITY_TOL}")
        report[wire] = dict(param_max_diff=param_diff,
                            loss_max_diff=loss_diff,
                            score_max_diff=score_diff,
                            eval_ce_diff=abs(evg["ce"] - evc["ce"]),
                            wire_bytes={k: mc[k] for k in mc
                                        if k.startswith("wire/")})
        say(f"training parity ({cfg.name}, K=2, {wire} wire, "
            f"numpy-seeded noise): bytes, kept_frac and kept sets ==, "
            f"max param diff {param_diff:.3g}, loss diff {loss_diff:.3g} "
            f"(<= {PARITY_TOL}), score diff {score_diff:.3g}")
    return report


def numpy_dp_noise(torch, device):
    """DP unit normals from numpy, seeded by (client, leaf path), so the
    card and the CPU add the same noise."""
    import zlib
    import numpy as np

    def noise(client, path, shape):
        rng = np.random.default_rng(
            [client, zlib.crc32("/".join(path).encode())])
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)
    return noise


def private_parity(torch):
    """One secure + DP round of the reduced ViT on the card and on the CPU
    from the same weights, data, wire noise and DP noise, K = 3 with one
    client dropped: metered params and secure bytes ==, dp/epsilon ==,
    params within roundtrip_tol(K) + 1e-4."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import (ProtocolConfig, SFPromptTrainer,
                                  SplitConfig, SplitModel)
    from repro_torch.core.aggregation import get_aggregator
    from repro_torch.data import (DATASETS, iid_partition, select_clients,
                                  stack_clients, synthetic_image_dataset)
    from repro_torch.kernels import launch_counts
    from repro_torch.privacy.fixed_point import roundtrip_tol
    from repro_torch.runtime import WireSpec
    from repro_torch.tree import tree_flatten, tree_map
    K = 3
    cfg = get_config("vit-base").reduced(n_layers=3, d_model=64, d_ff=128)
    model = SplitModel(cfg, SplitConfig(head_cycles=1, tail_cycles=1,
                                        prompt_len=4, prune_gamma=0.5,
                                        local_epochs=1),
                       WireSpec.make("fp32"))
    pcfg = ProtocolConfig(clients_per_round=K, local_epochs=1, batch_size=8,
                          lr_local=0.05, lr_split=0.05, dp_clip=1.0,
                          dp_noise_multiplier=0.8)
    d = synthetic_image_dataset(DATASETS["cifar10-syn"], 8 * 24, seed=0,
                                image_hw=32)
    cohort = stack_clients(iid_partition(d, 8, seed=0),
                           select_clients(8, K, seed=0, round_idx=0))
    part = {"transmit": np.array([1.0, 0.5, 1.0], np.float32),
            "aggregate": np.array([1.0, 0.0, 1.0], np.float32)}
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = SFPromptTrainer(model, pcfg, get_aggregator(secure=True, seed=3),
                             device=dev)
        before = launch_counts()["secure_masked_encode"]
        state, m = tr.round({"params": tree_map(lambda x: x.to(dev), params),
                             "round": 0}, cohort, part,
                            wire_noise=numpy_wire_noise(torch, dev),
                            dp_noise=numpy_dp_noise(torch, dev))
        runs[dev] = (state["params"], m,
                     launch_counts()["secure_masked_encode"] - before)
    (pc, mc, lc), (pg, mg, lg) = runs["cpu"], runs["cuda"]
    if (lc, lg) != (0, K + 1):
        fail(f"private parity: masked-encode launches {lc} on the CPU, {lg} "
             f"on the card (want 0 and K + 1 = {K + 1})")
    for key in ("wire/params_bytes", "wire/secure_bytes", "dp/epsilon",
                "cohort/active", "kept_frac"):
        if mg[key] != mc[key]:
            fail(f"private parity: {key} {mg[key]} on the card vs {mc[key]} "
                 f"on the CPU")
    tol = roundtrip_tol(K) + PARITY_TOL
    diff = max(float((a.cpu() - b).abs().max()) for (_, a), (_, b) in
               zip(tree_flatten(pg), tree_flatten(pc)))
    if diff > tol:
        fail(f"private parity: params differ by {diff:.3g} > {tol:.3g}")
    say(f"private parity ({cfg.name}, K={K}, one dropped, secure + DP, "
        f"numpy-seeded wire and DP noise): params and secure bytes, "
        f"dp/epsilon == ({mc['dp/epsilon']:.6f}), max param diff "
        f"{diff:.3g} (<= {tol:.3g}), {lg} kernel launches on the card")
    return dict(param_max_diff=diff, tol=tol, launches=lg,
                wire_bytes={k: mc[k] for k in mc if k.startswith("wire/")},
                epsilon=mc["dp/epsilon"])


# ---------------------------------------------------------------- phase 8
def full_width_train(torch):
    """ViT-Base at full width and depth through two SFPrompt rounds with the
    int8 wire on both boundaries, then `evaluate`."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import (ProtocolConfig, SFPromptTrainer,
                                  SplitConfig, SplitModel)
    from repro_torch.core.comm import (measured_cost_inputs,
                                       sfprompt_comm_breakdown)
    from repro_torch.data import (DATASETS, iid_partition, select_clients,
                                  stack_clients, synthetic_image_dataset)
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.obs.trace import Tracer
    from repro_torch.runtime import WireSpec
    from repro_torch.tree import tree_leaves
    cfg = get_config("vit-base")
    image_hw = 224
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=16,
                        prune_gamma=0.5, local_epochs=2)
    model = SplitModel(cfg, split, WireSpec.make("int8"))
    n_clients, n_local, K, n_test, bs = 8, 64, 4, 128, 16
    pcfg = ProtocolConfig(clients_per_round=K, local_epochs=2,
                          split_epochs=1, batch_size=bs, lr_local=0.03,
                          lr_split=0.03, optimizer="sgd", momentum=0.9)
    t0 = time.perf_counter()
    # train and test are slices of ONE draw: class anchors depend on n
    d = synthetic_image_dataset(DATASETS["cifar100-syn"],
                                n_clients * n_local + n_test, seed=0,
                                image_hw=image_hw)
    train = {k: v[:n_clients * n_local] for k, v in d.items()}
    test = {k: v[n_clients * n_local:] for k, v in d.items()}
    clients = iid_partition(train, n_clients, seed=0)
    cohorts = [stack_clients(clients, select_clients(n_clients, K, seed=0,
                                                     round_idx=r))
               for r in range(3)]
    state0 = SFPromptTrainer(model, pcfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(state0["params"]))

    # warm-up round on a throwaway trainer (cuBLAS handles, allocator)
    t0 = time.perf_counter()
    SFPromptTrainer(model, pcfg, device="cuda").round(state0, cohorts[2])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    trainer = SFPromptTrainer(model, pcfg, device="cuda",
                              tracer=Tracer("step"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, rounds = state0, []
    for r in range(2):
        t0 = time.perf_counter()
        state, m = trainer.round(state, cohorts[r])
        torch.cuda.synchronize()
        rounds.append({"wall_s": time.perf_counter() - t0, "metrics": m})
    t0 = time.perf_counter()
    ev = trainer.evaluate(state["params"], test, batch_size=32)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = launch_counts()
    prefill_shapes = prefill_launch_shapes()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    phases, i = {}, 0
    for rec in trainer.tracer.records():
        if rec.get("kind") != "span":
            continue
        if rec["name"] == "round":
            rounds[i]["phase_s"] = phases
            phases, i = {}, i + 1
        else:
            phases[rec["name"]] = rec["dur_ns"] * 1e-9
    bad = [k for r in rounds for k, v in r["metrics"].items()
           if not np.isfinite(v)] + [k for k, v in ev.items()
                                     if not np.isfinite(v)]
    if bad:
        fail(f"train full width: non-finite metrics {bad}")
    analytical = sfprompt_comm_breakdown(measured_cost_inputs(
        model, tokens_per_sample=(image_hw // 16) ** 2 + 1, n_local=n_local,
        batch_size=bs,
        K=K, U=pcfg.local_epochs, E=pcfg.split_epochs))
    wire_err = {}
    for r in rounds:
        for name, want in analytical.items():
            got = r["metrics"][f"wire/{name}_bytes"]
            wire_err[name] = max(wire_err.get(name, 0.0),
                                 abs(got - want) / want)
            ok = (got == round(want) if name == "params"
                  else abs(got - want) <= TRAIN_WIRE_TOL * want)
            if not ok:
                fail(f"train full width: {name} measured {got} B vs "
                     f"analytical {want} B")
    missing = [k for k in PATHS["train"] if launches[k] <= 0]
    if missing:
        fail(f"train full width: kernels of the path never launched: "
             f"{missing}")
    samples = K * n_local
    summary = {
        "config": f"{cfg.name}: {cfg.n_layers} layers (1 head / "
                  f"{cfg.n_layers - 2} body / 1 tail), d_model {cfg.d_model}, "
                  f"prompt 16, {image_hw}x{image_hw} "
                  f"({(image_hw // 16) ** 2 + 17} tokens), cifar100-syn, "
                  f"{n_clients} clients x {n_local}, "
                  f"K {K}, U 2, E 1, batch {bs}, gamma 0.5 (keep 32), SGD lr "
                  f"0.03 momentum 0.9, int8 wire, fp32",
        "params": n_params, "setup_s": setup_s, "warmup_round_s": warm_s,
        "rounds": rounds, "eval": ev, "eval_s": eval_s,
        "samples_per_s": [samples / r["wall_s"] for r in rounds],
        "max_memory_allocated_gb": peak_gb, "analytical_bytes": analytical,
        "wire_rel_err": wire_err, "launches": launches,
        "prefill_shapes": prefill_shapes}
    say("train full width: " + json.dumps(summary, sort_keys=True))
    summary["profile"] = profile_round(torch, model, pcfg, state, cohorts[2])
    say("train profile: " + json.dumps(summary["profile"], sort_keys=True))
    return launches, summary


def profile_round(torch, model, pcfg, state, cohort):
    """One more round under torch.profiler, with the phase spans of a
    step-level tracer: device busy share, device time by kernel, host time
    by phase. A separate run, so the measured rounds carry no profiler
    cost."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import SFPromptTrainer
    from repro_torch.obs.trace import Tracer
    trainer = SFPromptTrainer(model, pcfg, device="cuda",
                              tracer=Tracer("step"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.round(state, cohort)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"wall_s": wall, "phase_s": {
        rec["name"]: rec["dur_ns"] * 1e-9 for rec in trainer.tracer.records()
        if rec.get("kind") == "span"}}
    out.update(device_summary(prof, wall))
    return out


# ---------------------------------------------------------------- phase 9
PRIVATE_ARGV = [
    "--arch", "vit-base", "--dataset", "cifar100-syn", "--samples", "512",
    "--clients", "8", "--k", "4", "--rounds", "2", "--local-epochs", "2",
    "--batch-size", "16", "--gamma", "0.5", "--prompt-len", "16",
    "--image-hw", "224", "--wire", "int8", "--secure-agg", "--dp-epsilon",
    "8", "--dp-delta", "1e-5", "--dp-clip", "1.0", "--dropout-rate", "0.2",
    "--seed", "8", "--ckpt-every", "1", "--device", "cuda"]


def full_width_private(torch, kernel_ms):
    """The private federated run at full width through the launcher:
    ViT-Base, 8 clients, K = 4, 2 rounds, secure aggregation, DP-SGD at
    (8, 1e-5), dropouts, int8 wire, a checkpoint every round. The seed
    makes round 0 lose one client and round 1 keep all four."""
    import numpy as np
    from unittest import mock
    from repro_torch.checkpoint import all_checkpoints, load_checkpoint
    from repro_torch.core.aggregation import fedavg_partial
    from repro_torch.core.comm import (measured_cost_inputs,
                                       secure_agg_breakdown,
                                       sfprompt_comm_breakdown_partial)
    from repro_torch.fed import FederatedEngine
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch import train
    from repro_torch.privacy.dp import (calibrate_noise, epsilon_from_rho,
                                        rho_per_release)
    from repro_torch.privacy.fixed_point import roundtrip_tol
    from repro_torch.privacy.secure_agg import SecureAggregator
    from repro_torch.tree import tree_flatten
    out = OUT / "private"
    if out.exists():
        import shutil
        shutil.rmtree(out)
    K = 4
    rounds, aggs = [], []
    run_round, aggregate = FederatedEngine.run_round, SecureAggregator.aggregate

    def timed_round(self, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan, m = run_round(self, **kw)
        torch.cuda.synchronize()
        rounds.append({"wall_s": time.perf_counter() - t0,
                       "n_active": plan.n_active})
        return plan, m

    def checked_aggregate(self, client_trees, weights, fallback, round_idx):
        torch.cuda.synchronize()
        n0 = launch_counts()["secure_masked_encode"]
        t0 = time.perf_counter()
        agg, wire = aggregate(self, client_trees, weights, fallback,
                              round_idx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()["secure_masked_encode"] - n0
        clear = fedavg_partial(client_trees, weights, fallback)
        diff = max(float((a - b).abs().max()) for (_, a), (_, b) in
                   zip(tree_flatten(agg), tree_flatten(clear)))
        aggs.append({"phase3_s": wall, "launches": launches,
                     "vs_fedavg_partial": diff,
                     "n_trainable": sum(x[0].numel() for _, x in
                                        tree_flatten(client_trees))})
        return agg, wire

    reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(FederatedEngine, "run_round", timed_round), \
            mock.patch.object(SecureAggregator, "aggregate",
                              checked_aggregate):
        engine = train.main(PRIVATE_ARGV + ["--out", str(out)])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    with open(out / "vit-base_sfprompt_cifar100-syn.jsonl") as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != 2 or len(rounds) != 2 or len(aggs) != 2:
        fail(f"private full width: {len(recs)} records, {len(rounds)} "
             f"rounds, {len(aggs)} aggregations (want 2 each)")
    bad = [k for r in recs for k, v in r.items()
           if isinstance(v, float) and not np.isfinite(v)]
    if bad:
        fail(f"private full width: non-finite metrics {bad}")
    if not any(0 < r["n_active"] < K for r in rounds):
        fail(f"private full width: no round lost a client "
             f"({[r['n_active'] for r in rounds]}); the recovery path did "
             f"not run")
    model = engine.trainer.model
    ci = measured_cost_inputs(model, tokens_per_sample=(224 // 16) ** 2 + 1,
                              n_local=64, batch_size=16, K=K, U=2)
    n_trainable = aggs[0]["n_trainable"]
    wire_err = 0.0
    for r, rec in enumerate(recs):
        n_up = rounds[r]["n_active"]
        want = secure_agg_breakdown(n_trainable=n_trainable,
                                    param_nbytes=4 * n_trainable, K=K,
                                    n_uploads=n_up)
        for key in ("params", "secure"):
            if rec[f"wire/{key}_bytes"] != want[key]:
                fail(f"private full width round {r}: {key} "
                     f"{rec[f'wire/{key}_bytes']} B vs {want[key]} B")
        part = sfprompt_comm_breakdown_partial(
            ci, transmit_sum=rec["cohort/transmit_sum"], n_uploads=n_up)
        for key in ("head_body", "body_tail"):
            err = abs(rec[f"wire/{key}_bytes"] - part[key]) / part[key]
            wire_err = max(wire_err, err)
            if err > TRAIN_WIRE_TOL:
                fail(f"private full width round {r}: {key} "
                     f"{rec[f'wire/{key}_bytes']} B vs {part[key]} B")
        want_launches = K + int(n_up < K)
        if aggs[r]["launches"] != want_launches:
            fail(f"private full width round {r}: {aggs[r]['launches']} "
                 f"masked-encode launches, want {want_launches}")
        if aggs[r]["vs_fedavg_partial"] > roundtrip_tol(K):
            fail(f"private full width round {r}: secure aggregate differs "
                 f"from fedavg_partial by {aggs[r]['vs_fedavg_partial']:.3g}"
                 f" > roundtrip_tol({K}) = {roundtrip_tol(K):.3g}")
    z = calibrate_noise(8.0, 1e-5, 2)
    want_eps = epsilon_from_rho(2 * rho_per_release(z), 1e-5)
    if recs[-1]["dp/epsilon"] != want_eps:
        fail(f"private full width: dp/epsilon {recs[-1]['dp/epsilon']} vs "
             f"{want_eps}")
    missing = [k for k in PATHS["private"] if launches[k] <= 0]
    if missing:
        fail(f"private full width: kernels never launched: {missing}")
    if launches["secure_masked_encode"] != sum(a["launches"] for a in aggs):
        fail("private full width: masked-encode launches outside phase 3")
    ckpts = [Path(p).name for p in all_checkpoints(str(out / "ckpt"))]
    final = load_checkpoint(str(out / "final.npz"))
    same = all(np.array_equal(a, b.cpu().numpy()) for (_, a), (_, b) in
               zip(tree_flatten(final), tree_flatten(engine.params)))
    if ckpts != ["ckpt_00000001.npz", "ckpt_00000002.npz"] or not same:
        fail(f"private full width: checkpoints {ckpts}, final.npz equal to "
             f"the engine's params: {same}")
    ckpt_mb = sum(p.stat().st_size for p in out.rglob("*.npz")) / 2 ** 20
    for p in out.rglob("*.npz"):    # too large to bring back
        p.unlink()
    for r, a in zip(rounds, aggs):
        a["masked_encode_ms_est"] = a["launches"] * kernel_ms
        a["masked_encode_share"] = a["masked_encode_ms_est"] / (
            1e3 * a["phase3_s"])
    summary = {
        "argv": PRIVATE_ARGV, "total_s": total_s, "rounds": rounds,
        "phase3": aggs, "records": recs, "launches": launches,
        "wire_rel_err": wire_err, "epsilon": recs[-1]["dp/epsilon"],
        "checkpoints": ckpts + ["final.npz"], "checkpoint_mb": ckpt_mb}
    say("private full width: " + json.dumps(summary, sort_keys=True))
    say(f"private full width: rounds {[round(r['wall_s'], 3) for r in rounds]}"
        f" s (active {[r['n_active'] for r in rounds]}), phase 3 "
        f"{[round(a['phase3_s'] * 1e3, 2) for a in aggs]} ms of which "
        f"masked encode ~{[round(a['masked_encode_share'], 3) for a in aggs]}"
        f" ({kernel_ms:.4f} ms a launch, phase 3 timing), epsilon "
        f"{recs[-1]['dp/epsilon']:.6f}")
    return launches, summary


# --------------------------------------------------------------- phase 19
# phase 19's full-width async run: the seed makes flushes 0 and 2 carry
# dropped passengers (entries 5, 4, 5 over four dispatch groups; the
# simulated clock is numpy alone, so a clock-only run on the CPU found it)
ASYNC_SEED = 10
ASYNC_ARGV = [
    "--arch", "vit-base", "--dataset", "cifar100-syn", "--samples", "512",
    "--clients", "8", "--k", "4", "--rounds", "3", "--local-epochs", "2",
    "--batch-size", "16", "--gamma", "0.5", "--prompt-len", "16",
    "--image-hw", "224", "--wire", "int8", "--async-buffer", "4",
    "--async-concurrency", "2", "--regime", "wan", "--dropout-rate", "0.25",
    "--seed", str(ASYNC_SEED), "--device", "cuda"]
# phase 19's hierarchical run: phase 9's seed, so round 0 loses a client
# (one edge recovers a dropped mask) and round 1 keeps all four
HIER_ARGV = [
    "--arch", "vit-base", "--dataset", "cifar100-syn", "--samples", "512",
    "--clients", "8", "--k", "4", "--edges", "2", "--rounds", "2",
    "--local-epochs", "2", "--batch-size", "16", "--gamma", "0.5",
    "--prompt-len", "16", "--image-hw", "224", "--wire", "int8",
    "--secure-agg", "--dropout-rate", "0.2", "--seed", "8",
    "--device", "cuda"]


class launch_sequence:
    """Context manager: every kernel launch inside it appends its kernel's
    name to `log`, in order. Each wrapper counts a launch with
    `fn.launches += 1`; the counters become int subclasses whose `+`
    records the name, and plain ints again on exit."""

    def __init__(self, log):
        self.log = log

    def __enter__(self):
        from repro_torch.kernels import wrappers
        log = self.log

        class Counted(int):
            def __add__(self, n):
                log.append(self.name)
                out = Counted(int(self) + n)
                out.name = self.name
                return out

        self.fns = wrappers()
        for name, fn in self.fns.items():
            fn.launches = Counted(fn.launches)
            fn.launches.name = name
        return log

    def __exit__(self, *exc):
        for fn in self.fns.values():
            fn.launches = int(fn.launches)


def async_parity(torch):
    """Phase 19 (a), the reduced ViT of tests/test_torch_async.py (3 layers,
    d_model 32) on the int8 wire with numpy-seeded noise: the sync anchor
    on the card (one async flush == one synchronous round, bit for bit,
    with the same launches in the same order); an async secure flush under
    dropout card against CPU; a secure hierarchical round card against
    CPU."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import (ProtocolConfig, SFPromptTrainer,
                                  SplitConfig, SplitModel)
    from repro_torch.core.aggregation import get_aggregator
    from repro_torch.data import DATASETS, synthetic_image_dataset
    from repro_torch.fed import (AsyncConfig, AsyncRoundEngine,
                                 ClientSampler, FederatedEngine, Population,
                                 RoundScheduler, StragglerConfig)
    from repro_torch.kernels import launch_counts
    from repro_torch.privacy.fixed_point import roundtrip_tol
    from repro_torch.privacy.secure_agg import SecureAggregator
    from repro_torch.runtime import WireSpec
    from repro_torch.tree import tree_flatten, tree_map
    n_clients, K = 40, 4
    cfg = get_config("vit-base").reduced(n_layers=3, d_model=32, d_ff=64)
    model = SplitModel(cfg, SplitConfig(head_cycles=1, tail_cycles=1,
                                        prompt_len=2, prune_gamma=0.3,
                                        local_epochs=1),
                       WireSpec.make("int8"))
    pcfg = ProtocolConfig(clients_per_round=K, local_epochs=1, batch_size=4,
                          momentum=0.0, return_client_trainable=True)
    data = synthetic_image_dataset(DATASETS["cifar10-syn"], n_clients * 8,
                                   seed=0, image_hw=32)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")

    def pop():
        return Population.from_partition(data, n_clients, scheme="dirichlet",
                                         alpha=0.1, seed=0)

    def wan(dropout):
        return RoundScheduler(StragglerConfig(regime="wan",
                                              dropout_rate=dropout),
                              seed=3, round_bytes_per_client=1e6,
                              round_flops_per_client=1e12)

    def start(engine, dev):
        engine.state = {"params": tree_map(lambda x: x.to(dev), params),
                        "round": 0}
        return engine

    def max_diff(a, b):
        return max(float((x.cpu() - y.cpu()).abs().max()) for (_, x), (_, y)
                   in zip(tree_flatten(a), tree_flatten(b)))

    report = {}
    # ---- the sync anchor on the card: buffer K, concurrency 1, beta 0
    noise = numpy_wire_noise(torch, "cuda")
    sync = start(FederatedEngine(SFPromptTrainer(model, pcfg, device="cuda"),
                                 pop(), ClientSampler(n_clients, K, seed=3)),
                 "cuda")
    with launch_sequence([]) as sync_seq:
        sync.run_round(wire_noise=noise)
    anchor = start(AsyncRoundEngine(
        SFPromptTrainer(model, pcfg, device="cuda"), pop(),
        ClientSampler(n_clients, K, seed=3),
        acfg=AsyncConfig(buffer_size=K, concurrency=1, staleness_beta=0.0)),
        "cuda")
    with launch_sequence([]) as async_seq:
        anchor.run_flushes(1, wire_noise=noise)
    if max_diff(sync.params, anchor.params) != 0.0:
        fail(f"async parity: the sync anchor's flush differs from the sync "
             f"round by {max_diff(sync.params, anchor.params):.3g}")
    sm, am = sync.trainer.meter.as_dict(), anchor.meter.as_dict()
    if sm != am:
        fail(f"async parity: sync anchor bytes {am} vs the round's {sm}")
    if sync_seq != async_seq or not sync_seq:
        fail(f"async parity: the sync round launched {len(sync_seq)} "
             f"kernels, the flush {len(async_seq)}, in another order")
    counts = {k: sync_seq.count(k) for k in sorted(set(sync_seq))}
    report["sync_anchor"] = {"launches": counts, "bytes": am}
    say(f"async parity: sync anchor on the card: params and bytes ==, the "
        f"same {len(sync_seq)} launches in the same order {counts}")

    # ---- an async secure flush under dropout, card against CPU
    runs = {}
    for dev in ("cpu", "cuda"):
        weights = []

        class Recording(SecureAggregator):
            def aggregate(self, client_trees, w, fallback, round_idx):
                weights.append(np.asarray(w.cpu(), np.float32))
                return super().aggregate(client_trees, w, fallback,
                                         round_idx)

        eng = start(AsyncRoundEngine(
            SFPromptTrainer(model, pcfg, device=dev), pop(),
            ClientSampler(n_clients, K, seed=3), wan(0.3),
            AsyncConfig(buffer_size=3, concurrency=2, staleness_beta=0.5),
            aggregator=Recording(seed=0)), dev)
        n0 = launch_counts()["secure_masked_encode"]
        eng.run_flushes(2, wire_noise=numpy_wire_noise(torch, dev))
        runs[dev] = (eng, weights,
                     launch_counts()["secure_masked_encode"] - n0)
    (ec, wc, lc), (eg, wg, lg) = runs["cpu"], runs["cuda"]
    passengers = [int((w == 0).any()) for w in wg]
    want = sum(len(w) for w in wg) + sum(passengers)
    if (lc, lg) != (0, want) or not any(passengers):
        fail(f"async parity: masked-encode launches {lc} on the CPU, {lg} "
             f"on the card (want 0 and {want}), passenger flushes "
             f"{passengers}")
    same = (eg.t_sim == ec.t_sim and eg.arrivals == ec.arrivals
            and eg.flush_history == ec.flush_history
            and eg.meter.state_dict() == ec.meter.state_dict()
            and all((x == y).all() for x, y in zip(wg, wc))
            and all(np.array_equal(v, ec.ledger.state_dict()[k])
                    for k, v in eg.ledger.state_dict().items()))
    if not same:
        fail("async parity: the secure flushes' clock, cohorts, ledger or "
             "bytes differ between the card and the CPU")
    tol = roundtrip_tol(3) + PARITY_TOL
    diff = max_diff(eg.params, ec.params)
    if diff > tol:
        fail(f"async parity: secure flush params differ by {diff:.3g} > "
             f"{tol:.3g}")
    report["secure_flush"] = {"param_max_diff": diff, "tol": tol,
                              "launches": lg, "entries": [len(w) for w in wg],
                              "passenger_flushes": passengers,
                              "t_sim": eg.t_sim}
    say(f"async parity: 2 secure flushes (entries {[len(w) for w in wg]}, "
        f"passengers {passengers}) card vs CPU: clock, cohorts, ledger and "
        f"bytes ==, params {diff:.3g} (<= {tol:.3g}), {lg} masked-encode "
        f"launches on the card")

    # ---- a secure hierarchical round, card against CPU: client 0 of edge
    # 0 dropped, client 1 late at 0.4
    part = {"transmit": np.array([0.0, 0.4, 1.0, 1.0], np.float32),
            "aggregate": np.array([0.0, 1.0, 1.0, 1.0], np.float32)}
    cohort = pop().gather(np.arange(K))
    hier = {}
    for dev in ("cpu", "cuda"):
        tr = SFPromptTrainer(model, pcfg, get_aggregator(
            secure=True, n_edges=2, cohort_size=K, seed=3), device=dev)
        n0 = launch_counts()["secure_masked_encode"]
        st, m = tr.round({"params": tree_map(lambda x: x.to(dev), params),
                          "round": 0}, cohort, part,
                         wire_noise=numpy_wire_noise(torch, dev))
        hier[dev] = (st["params"], m,
                     launch_counts()["secure_masked_encode"] - n0)
    (pc, mc, lc), (pg, mg, lg) = hier["cpu"], hier["cuda"]
    if (lc, lg) != (0, K + 1):
        fail(f"hier parity: masked-encode launches {lc} on the CPU, {lg} on "
             f"the card (want 0 and K + 1 edge with a dropout = {K + 1})")
    for key in mc:
        if key.startswith(("wire/", "cohort/")) and mg[key] != mc[key]:
            fail(f"hier parity: {key} {mg[key]} on the card vs {mc[key]}")
    tol = roundtrip_tol(K) + PARITY_TOL
    diff = max_diff(pg, pc)
    if diff > tol:
        fail(f"hier parity: params differ by {diff:.3g} > {tol:.3g}")
    report["hier"] = {"param_max_diff": diff, "tol": tol, "launches": lg,
                      "wire_bytes": {k: mc[k] for k in mc
                                     if k.startswith("wire/")}}
    say(f"hier parity (2 edges, secure, one dropped, one late) card vs CPU: "
        f"bytes == (edge_global {mc['wire/edge_global_bytes']}), params "
        f"{diff:.3g} (<= {tol:.3g}), {lg} masked-encode launches")
    return report


def _contribution_mb(engine) -> float:
    """MB of client contributions the engine holds (in flight and
    buffered)."""
    from repro_torch.tree import tree_leaves
    held = [f.contribution for f in engine.in_flight] + \
        [e.contribution for e in engine.buffer.entries]
    return sum(x.numel() * x.element_size() for c in held if c is not None
               for x in tree_leaves(c)) / 1e6


def full_width_async(torch):
    """Phase 19 (b): the buffered async runtime at full width through the
    launcher — ViT-Base, 8 clients of 64, K 4, buffer 4, two groups in
    flight, WAN, dropout 0.25, int8 wire, 3 flushes — with secure flushes,
    then again with clear ones."""
    import numpy as np
    from unittest import mock
    from repro_torch.core import SFPromptTrainer
    from repro_torch.core.comm import secure_agg_breakdown
    from repro_torch.fed import AsyncRoundEngine
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch import train
    from repro_torch.privacy.fixed_point import roundtrip_tol
    from repro_torch.privacy.secure_agg import SecureAggregator
    from repro_torch.tree import tree_leaves
    client_updates = SFPromptTrainer.client_updates
    flush, aggregate = AsyncRoundEngine._flush, SecureAggregator.aggregate
    runs, paths = {}, {}
    for label, extra in (("secure", ["--secure-agg"]), ("clear", [])):
        out = OUT / f"async_{label}"
        if out.exists():
            import shutil
            shutil.rmtree(out)
        dispatch_s, flushes, aggs, held = [], [], [], []

        def timed_updates(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = client_updates(self, *a, **kw)
            torch.cuda.synchronize()
            dispatch_s.append(time.perf_counter() - t0)
            return res

        def timed_flush(self):
            entries = list(self.buffer.entries)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flush(self)
            torch.cuda.synchronize()
            flushes.append({"wall_s": time.perf_counter() - t0,
                            "entries": len(entries),
                            "live": sum(not e.dropped for e in entries),
                            "staleness": [self.version - 1 - e.version
                                          for e in entries if not e.dropped]})
            held.append(_contribution_mb(self))

        def counted_aggregate(self, client_trees, weights, fallback,
                              round_idx):
            n0 = launch_counts()["secure_masked_encode"]
            agg, wire = aggregate(self, client_trees, weights, fallback,
                                  round_idx)
            torch.cuda.synchronize()
            aggs.append({"launches": launch_counts()["secure_masked_encode"]
                         - n0, "wire": {k: float(v) for k, v in wire.items()},
                         "n_trainable": sum(x[0].numel() for x in
                                            tree_leaves(client_trees))})
            return agg, wire

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(SFPromptTrainer, "client_updates",
                               timed_updates), \
                mock.patch.object(AsyncRoundEngine, "_flush", timed_flush), \
                mock.patch.object(SecureAggregator, "aggregate",
                                  counted_aggregate):
            engine = train.main(ASYNC_ARGV + extra + ["--out", str(out)])
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = launch_counts()
        prefill_shapes = prefill_launch_shapes()
        with open(out / "vit-base_sfprompt_cifar100-syn.jsonl") as f:
            recs = [json.loads(line) for line in f]
        for p in out.rglob("*.npz"):    # too large to bring back
            p.unlink()
        bad = [k for r in recs for k, v in r.items()
               if isinstance(v, float) and not np.isfinite(v)]
        if len(recs) != 3 or len(flushes) != 3 or bad:
            fail(f"async full width ({label}): {len(recs)} records, "
                 f"{len(flushes)} flushes, non-finite {bad}")
        runs[label] = dict(
            engine=engine, recs=recs, flushes=flushes, aggs=aggs,
            dispatch_s=dispatch_s, held_mb=held, total_s=total_s,
            launches=launches, prefill_shapes=prefill_shapes,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        paths["async" if label == "secure" else "async_clear"] = launches
    sec, clr = runs["secure"], runs["clear"]
    es, ec = sec["engine"], clr["engine"]
    if (es.t_sim, es.arrivals) != (ec.t_sim, ec.arrivals):
        fail(f"async full width: t_sim/arrivals {es.t_sim}/{es.arrivals} "
             f"secure vs {ec.t_sim}/{ec.arrivals} clear")
    tol = roundtrip_tol(4) + PARITY_TOL
    diff = max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(es.params), tree_leaves(ec.params)))
    if diff > tol:
        fail(f"async full width: secure params {diff:.3g} from the clear "
             f"ones > {tol:.3g}")
    passengers = [int(f["entries"] > f["live"]) for f in sec["flushes"]]
    if not any(passengers):
        fail(f"async full width: no flush carried a dropped passenger "
             f"({sec['flushes']})")
    n_tr = sec["aggs"][0]["n_trainable"]
    pb = 4.0 * n_tr
    for i, (f, a) in enumerate(zip(sec["flushes"], sec["aggs"])):
        want = secure_agg_breakdown(n_trainable=n_tr, param_nbytes=pb,
                                    K=f["entries"], n_uploads=f["live"])
        # the flush bills the uploads; each entry's fp32 downlink was
        # billed when its group was dispatched
        got = {"params": a["wire"]["params_up"] + f["entries"] * pb,
               "secure": a["wire"]["secure"]}
        if got != want:
            fail(f"async full width flush {i}: bytes {got} vs "
                 f"secure_agg_breakdown {want}")
        if a["launches"] != f["entries"] + passengers[i]:
            fail(f"async full width flush {i}: {a['launches']} masked-"
                 f"encode launches, want {f['entries'] + passengers[i]}")
    n_dispatched = 4 * len(sec["dispatch_s"])
    want_params = n_dispatched * pb + sum(a["wire"]["params_up"]
                                          for a in sec["aggs"])
    if es.meter.totals["params"] != want_params:
        fail(f"async full width: params total {es.meter.totals['params']} "
             f"vs {want_params}")
    if sec["launches"]["secure_masked_encode"] != sum(
            a["launches"] for a in sec["aggs"]):
        fail("async full width: masked-encode launches outside the flushes")
    for label, path in (("secure", "async"), ("clear", "async_clear")):
        missing = [k for k in PATHS[path] if runs[label]["launches"][k] <= 0]
        if missing:
            fail(f"async full width ({label}): kernels never launched: "
                 f"{missing}")
    summary = {"argv": ASYNC_ARGV, "param_diff_secure_vs_clear": diff,
               "tol": tol, "passenger_flushes": passengers}
    for label, r in runs.items():
        e = r["engine"]
        summary[label] = {
            "total_s": r["total_s"], "dispatch_s": r["dispatch_s"],
            "flushes": r["flushes"], "t_sim": e.t_sim,
            "arrivals": e.arrivals,
            "mean_staleness": e.ledger.mean_staleness(),
            "max_staleness": e.ledger.max_staleness,
            "contributions_mb_after_flush": r["held_mb"],
            "max_memory_allocated_gb": r["peak_gb"],
            "launches": r["launches"], "records": r["recs"],
            "prefill_shapes": r["prefill_shapes"],
            "meter": e.meter.as_dict(), "aggs": r["aggs"]}
        say(f"async full width ({label}): dispatch rounds "
            f"{[round(s, 3) for s in r['dispatch_s']]} s, flushes "
            f"{[round(f['wall_s'] * 1e3, 2) for f in r['flushes']]} ms "
            f"(entries {[f['entries'] for f in r['flushes']]}, live "
            f"{[f['live'] for f in r['flushes']]}), {e.t_sim:.2f} simulated "
            f"s, staleness mean {e.ledger.mean_staleness():.3f} max "
            f"{e.ledger.max_staleness}, contributions held after each flush "
            f"{[round(m, 1) for m in r['held_mb']]} MB "
            f"({n_tr * 4 / 1e6:.1f} MB each), peak "
            f"{r['peak_gb']:.2f} GB, {r['total_s']:.1f} s, launches "
            + json.dumps({k: v for k, v in r["launches"].items() if v},
                         sort_keys=True))
    say(f"async full width: passengers in flushes {passengers}; secure "
        f"params {diff:.3g} from clear (<= {tol:.3g}); per-flush bytes == "
        f"secure_agg_breakdown")
    return paths, summary


def full_width_hier(torch):
    """Phase 19 (c): hierarchical secure aggregation at full width through
    the launcher — ViT-Base, K 4 over 2 edges, dropout 0.2, int8 wire, 2
    rounds."""
    import numpy as np
    from unittest import mock
    from repro_torch.core.comm import (hierarchical_edge_breakdown,
                                       hierarchical_secure_agg_breakdown)
    from repro_torch.fed import FederatedEngine
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch import train
    from repro_torch.privacy.secure_agg import SecureAggregator
    from repro_torch.tree import tree_leaves
    out = OUT / "hier"
    if out.exists():
        import shutil
        shutil.rmtree(out)
    K, E = 4, 2
    run_round, aggregate = FederatedEngine.run_round, SecureAggregator.aggregate
    rounds, edge_launches = [], []

    def timed_round(self, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n0 = launch_counts()["secure_masked_encode"]
        plan, m = run_round(self, **kw)
        torch.cuda.synchronize()
        rounds.append({"wall_s": time.perf_counter() - t0,
                       "aggregate": plan.aggregate.tolist(),
                       "launches": launch_counts()["secure_masked_encode"]
                       - n0})
        return plan, m

    def counted_aggregate(self, client_trees, weights, fallback, round_idx):
        n0 = launch_counts()["secure_masked_encode"]
        agg, wire = aggregate(self, client_trees, weights, fallback,
                              round_idx)
        edge_launches.append(launch_counts()["secure_masked_encode"] - n0)
        return agg, wire

    reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(FederatedEngine, "run_round", timed_round), \
            mock.patch.object(SecureAggregator, "aggregate",
                              counted_aggregate):
        engine = train.main(HIER_ARGV + ["--out", str(out)])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    with open(out / "vit-base_sfprompt_cifar100-syn.jsonl") as f:
        recs = [json.loads(line) for line in f]
    for p in out.rglob("*.npz"):
        p.unlink()
    bad = [k for r in recs for k, v in r.items()
           if isinstance(v, float) and not np.isfinite(v)]
    if len(recs) != 2 or len(rounds) != 2 or bad:
        fail(f"hier full width: {len(recs)} records, {len(rounds)} rounds, "
             f"non-finite {bad}")
    params = engine.params
    n_tr = sum(x.numel() for x in tree_leaves(
        {"tail": params["tail"], "prompt": params["prompt"]}))
    pb = 4.0 * n_tr
    for r, (rec, rd) in enumerate(zip(recs, rounds)):
        alive = np.asarray(rd["aggregate"]) > 0
        ups = [float(alive[e * (K // E):(e + 1) * (K // E)].sum())
               for e in range(E)]
        want = hierarchical_secure_agg_breakdown(
            n_trainable=n_tr, param_nbytes=pb, edge_sizes=[K // E] * E,
            edge_uploads=ups)
        edge = hierarchical_edge_breakdown(
            param_nbytes=pb, n_edges=E,
            live_edges=float(sum(u > 0 for u in ups)))
        if rec["wire/edge_global_bytes"] != edge["edge_global"]:
            fail(f"hier full width round {r}: edge_global "
                 f"{rec['wire/edge_global_bytes']} vs {edge['edge_global']}")
        for key in ("params", "secure"):
            if rec[f"wire/{key}_bytes"] != want[key]:
                fail(f"hier full width round {r}: {key} "
                     f"{rec[f'wire/{key}_bytes']} vs {want[key]}")
        want_launches = K + sum(u < K // E for u in ups)
        if rd["launches"] != want_launches:
            fail(f"hier full width round {r}: {rd['launches']} masked-encode "
                 f"launches, want {want_launches}")
        rd["edge_uploads"] = ups
    if not any(0 < sum(rd["edge_uploads"]) < K for rd in rounds):
        fail("hier full width: no round lost a client")
    missing = [k for k in PATHS["hier"] if launches[k] <= 0]
    if missing:
        fail(f"hier full width: kernels never launched: {missing}")
    summary = {"argv": HIER_ARGV, "total_s": total_s, "rounds": rounds,
               "edge_launches": edge_launches, "records": recs,
               "launches": launches}
    say(f"hier full width: rounds {[round(r['wall_s'], 3) for r in rounds]} "
        f"s, edge uploads {[r['edge_uploads'] for r in rounds]}, masked-"
        f"encode launches {[r['launches'] for r in rounds]} (by edge "
        f"{edge_launches}), bytes == hierarchical_secure_agg_breakdown, "
        f"{total_s:.1f} s, launches "
        + json.dumps({k: v for k, v in launches.items() if v},
                     sort_keys=True))
    return launches, summary


# --------------------------------------------------------------- phase 16
def _changed(torch, new, old):
    """Whether any leaf of `new` differs from the same leaf of `old`."""
    from repro_torch.tree import tree_leaves
    return any(not torch.equal(a.cpu(), b.cpu())
               for a, b in zip(tree_leaves(new), tree_leaves(old)))


# init seed of phase 16's card-vs-CPU baseline rounds: the int8 wire is
# equal on both devices only while their fp32 differences push no value
# across a rounding boundary (ROADMAP Queue 3); seeds 3, 5, 6 and 7 flip
# none in the three rounds, seeds 1, 2 and 4 flip one in FL (params 1.7e-4
# to 2.0e-4 apart) and seed 0 one in SFL+Linear (8.2e-5), on the H100
BASELINE_SEED = 3


def baseline_parity(torch):
    """One round each of FL, SFL+FF and SFL+Linear and a two-group hetero
    round of the reduced ViT on the card and on the CPU from the same
    weights and data, int8 wire."""
    from repro_torch.configs import get_config
    from repro_torch.core import (BaselineConfig, FLTrainer, ProtocolConfig,
                                  SFLTrainer, SplitConfig, SplitModel)
    from repro_torch.data import (DATASETS, iid_partition, select_clients,
                                  stack_clients, synthetic_image_dataset)
    from repro_torch.runtime import WireSpec
    from repro_torch.runtime.hetero import ClientPlan, HeteroSFPromptTrainer
    from repro_torch.tree import tree_leaves, tree_map
    report = {}
    cfg = get_config("vit-base").reduced(n_layers=3, d_model=64, d_ff=128)
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=4,
                        prune_gamma=0.5, local_epochs=1)
    model = SplitModel(cfg, split, WireSpec.make("int8"))
    bcfg = BaselineConfig(local_epochs=1, batch_size=8, lr=0.05)
    d = synthetic_image_dataset(DATASETS["cifar10-syn"], 8 * 24, seed=0,
                                image_hw=32)
    cohort = stack_clients(iid_partition(d, 8, seed=0),
                           select_clients(8, 2, seed=0, round_idx=0))
    # which segments each method trains: (head, body)
    trains = {"fl": (True, True), "sfl-ff": (True, True),
              "sfl-linear": (False, False)}
    for method, (head, body) in trains.items():
        params = model.init(torch.Generator().manual_seed(BASELINE_SEED),
                            device="cpu")
        runs = {}
        for dev in ("cpu", "cuda"):
            tr = (FLTrainer(model, bcfg, device=dev) if method == "fl" else
                  SFLTrainer(model, bcfg, mode=method.split("-")[1],
                             device=dev))
            runs[dev] = tr.round({"params": tree_map(lambda x: x.to(dev),
                                                     params), "round": 0},
                                 cohort)
        (pc, mc), (pg, mg) = ((runs[d][0]["params"], runs[d][1])
                              for d in ("cpu", "cuda"))
        diff = max(float((a.cpu() - b).abs().max())
                   for a, b in zip(tree_leaves(pg), tree_leaves(pc)))
        loss_diff = abs(mg["train_loss"] - mc["train_loss"])
        if max(diff, loss_diff) > PARITY_TOL:
            fail(f"baseline parity ({method}): params differ by {diff:.3g}, "
                 f"train_loss by {loss_diff:.3g} > {PARITY_TOL}")
        got = (_changed(torch, pg["head"], params["head"]),
               _changed(torch, pg["body"], params["body"]))
        if got != (head, body) or _changed(torch, pg["prompt"],
                                           params["prompt"]) \
                or not _changed(torch, pg["tail"]["head"],
                                params["tail"]["head"]):
            fail(f"baseline parity ({method}): head/body changed {got}, "
                 f"want {(head, body)}; the prompt must stay and the task "
                 f"head change")
        report[method] = dict(param_max_diff=diff, loss_diff=loss_diff,
                              train_loss=mg["train_loss"])
        say(f"baseline parity ({cfg.name}, K=2, int8 wire, {method}): max "
            f"param diff {diff:.3g}, train_loss diff {loss_diff:.3g} (<= "
            f"{PARITY_TOL}), head/body changed {got}")

    hcfg = get_config("vit-base").reduced(n_layers=5, d_model=64, d_ff=128)
    plans = [ClientPlan(SplitConfig(head_cycles=c, tail_cycles=c,
                                    prompt_len=4, prune_gamma=0.5,
                                    local_epochs=1), 2, name)
             for c, name in ((1, "phone"), (2, "ws"))]
    pcfg = ProtocolConfig(clients_per_round=2, local_epochs=1, batch_size=8,
                          lr_local=0.05, lr_split=0.05)
    groups = []
    for g in range(2):
        part = {k: v[g * 96:(g + 1) * 96] for k, v in d.items()}
        groups.append(stack_clients(iid_partition(part, 2, seed=g), [0, 1]))
    runs = {}
    states0 = HeteroSFPromptTrainer(hcfg, plans, pcfg, WireSpec.make("int8"),
                                    device="cpu").init(
        torch.Generator().manual_seed(0))
    for dev in ("cpu", "cuda"):
        ht = HeteroSFPromptTrainer(hcfg, plans, pcfg, WireSpec.make("int8"),
                                   device=dev)
        states = [{"params": tree_map(lambda x: x.to(dev), s["params"]),
                   "round": 0} for s in states0]
        new, m = ht.round(states, groups,
                          wire_noise=numpy_wire_noise(torch, dev))
        runs[dev] = (new, m, ht.meter.as_dict())
    (nc, mc, bc), (ng, mg, bg) = runs["cpu"], runs["cuda"]
    if bg != bc:
        fail(f"hetero parity: metered bytes {bg} on the card vs {bc}")
    diff = max(float((a.cpu() - b).abs().max()) for sg, sc in zip(ng, nc)
               for a, b in zip(tree_leaves(sg["params"]),
                               tree_leaves(sc["params"])))
    if diff > PARITY_TOL:
        fail(f"hetero parity: params differ by {diff:.3g} > {PARITY_TOL}")
    if not torch.equal(ng[0]["params"]["prompt"], ng[1]["params"]["prompt"]):
        fail("hetero parity: the groups' prompts differ after the round")
    report["hetero"] = dict(param_max_diff=diff, meter=bg)
    say(f"hetero parity ({hcfg.name}, cuts 1/1 and 2/2, K=2 a group, int8 "
        f"wire, numpy-seeded noise): metered bytes ==, max param diff "
        f"{diff:.3g} (<= {PARITY_TOL})")
    return report


BASELINE_ARGV = [
    "--arch", "vit-base", "--dataset", "cifar100-syn", "--samples", "128",
    "--clients", "2", "--k", "2", "--rounds", "1", "--local-epochs", "1",
    "--batch-size", "16", "--image-hw", "224", "--wire", "int8", "--seed",
    "0", "--device", "cuda"]


def full_width_baselines(torch):
    """FL, SFL+FF and SFL+Linear at full width through the launcher, one
    round each (K = 2, U = 1, 64 samples a client), then a hetero round of
    two ViT-Base cuts and its `evaluate`. Returns the launches by path and
    the summary."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import ProtocolConfig, SplitConfig
    from repro_torch.core.comm import (measured_cost_inputs,
                                       sfprompt_comm_breakdown)
    from repro_torch.data import (DATASETS, iid_partition, stack_clients,
                                  synthetic_image_dataset)
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch import train
    from repro_torch.runtime import WireSpec
    from repro_torch.runtime.hetero import ClientPlan, HeteroSFPromptTrainer
    by_path, summary = {}, {"argv": BASELINE_ARGV}
    for method in ("fl", "sfl-ff", "sfl-linear"):
        out = OUT / "baselines" / method
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        train.main(BASELINE_ARGV + ["--method", method, "--out", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        with open(out / f"vit-base_{method}_cifar100-syn.jsonl") as f:
            recs = [json.loads(line) for line in f]
        for p in out.rglob("*.npz"):    # too large to bring back
            p.unlink()
        path = method.replace("-", "_")
        if len(recs) != 1 or not np.isfinite(recs[0]["train_loss"]):
            fail(f"{method} full width: records {recs}")
        missing = [k for k in PATHS[path] if launches[k] <= 0]
        if missing:
            fail(f"{method} full width: kernels never launched: {missing}")
        by_path[path] = launches
        summary[path] = {"main_s": wall, "round_wall_s": recs[0]["wall_s"],
                         "train_loss": recs[0]["train_loss"],
                         "launches": {k: v for k, v in launches.items()
                                      if v}}
        say(f"{method} full width (ViT-Base, 224x224, K 2, U 1, 64 samples "
            f"a client, int8 wire): train_loss {recs[0]['train_loss']:.6f}, "
            f"round {recs[0]['wall_s']} s (the launcher's record), main "
            f"{wall:.2f} s with set-up, launches {summary[path]['launches']}")

    cfg = get_config("vit-base")
    n_local, K, bs = 64, 2, 16
    plans = [ClientPlan(SplitConfig(head_cycles=c, tail_cycles=c,
                                    prompt_len=16, prune_gamma=0.5,
                                    local_epochs=1), K, name)
             for c, name in ((1, "1/1"), (2, "2/2"))]
    pcfg = ProtocolConfig(clients_per_round=K, local_epochs=1,
                          batch_size=bs, lr_local=0.03, lr_split=0.03)
    d = synthetic_image_dataset(DATASETS["cifar100-syn"],
                                2 * K * n_local + 128, seed=0, image_hw=224)
    groups = []
    for g in range(2):
        part = {k: v[g * K * n_local:(g + 1) * K * n_local]
                for k, v in d.items()}
        groups.append(stack_clients(iid_partition(part, K, seed=g),
                                    list(range(K))))
    test = {k: v[2 * K * n_local:] for k, v in d.items()}
    ht = HeteroSFPromptTrainer(cfg, plans, pcfg, WireSpec.make("int8"),
                               device="cuda")
    states = ht.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    states, m = ht.round(states, groups)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    ev = ht.evaluate(states, test, batch_size=32)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0 - round_s
    launches = launch_counts()
    bad = [k for k, v in m.items() if not np.isfinite(v)] + \
        [k for k in ("ce", "acc") if not np.isfinite(ev[k])]
    if bad:
        fail(f"hetero full width: non-finite metrics {bad}")
    analytical = {"head_body": 0.0, "body_tail": 0.0, "params": 0.0}
    for tr in ht.trainers:
        ci = measured_cost_inputs(tr.model,
                                  tokens_per_sample=(224 // 16) ** 2 + 1,
                                  n_local=n_local, batch_size=bs, K=K)
        for k, v in sfprompt_comm_breakdown(ci).items():
            analytical[k] += v
    metered = ht.meter.as_dict()
    wire_err = {}
    for name, want in analytical.items():
        got = metered[name]
        wire_err[name] = abs(got - want) / want
        ok = (got == want if name == "params"
              else wire_err[name] <= TRAIN_WIRE_TOL)
        if not ok:
            fail(f"hetero full width: {name} metered {got} B vs analytical "
                 f"{want} B")
    missing = [k for k in PATHS["hetero"] if launches[k] <= 0]
    if missing:
        fail(f"hetero full width: kernels never launched: {missing}")
    by_path["hetero"] = launches
    summary["hetero"] = {
        "config": "ViT-Base, cuts 1/1 (body 10) and 2/2 (body 8), prompt "
                  "16, 224x224, K 2 a group, 64 samples a client, U 1, "
                  "gamma 0.5, batch 16, int8 wire",
        "round_s": round_s, "eval_s": eval_s, "metrics": m, "eval": {
            k: ev[k] for k in ("ce", "acc")},
        "metered_bytes": metered, "analytical_bytes": analytical,
        "wire_rel_err": wire_err,
        "launches": {k: v for k, v in launches.items() if v}}
    say("hetero full width: " + json.dumps(summary["hetero"],
                                           sort_keys=True))
    return by_path, summary


# --------------------------------------------------------------- phase 17
def trace_check(path) -> str:
    """`tools/trace_check.py` on an exported JSONL, in a subprocess; fails
    the run unless it exits 0. Returns its summary."""
    res = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "trace_check.py"), str(path)],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        fail(f"trace_check {path}: exit {res.returncode}: "
             f"{res.stdout.strip()} {res.stderr.strip()}")
    return res.stdout.strip()


def traced_serve(torch, fw):
    """Phase 5's full-width dense engine over a short trace, untraced, then
    under a step-level tracer, then untraced again: tokens and wire bytes
    equal across the three, every kernel of the dense path launched in the
    traced run, and the export (JSONL, Chrome trace, Prometheus) passes
    tools/trace_check.py with its exact meter bytes."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.obs import MetricsRegistry, Tracer, export_all
    from repro_torch.serve import (ServeConfig, ServeEngine, WorkloadConfig,
                                   synthetic_requests)
    cfg = fw["cfg"]
    wl = dict(WORKLOAD, vocab_size=cfg.vocab_size)
    reqs = synthetic_requests(WorkloadConfig(n_requests=6, seed=2, **wl))
    OUT.mkdir(exist_ok=True)     # a fresh checkout has no output directory

    def engine(tracer=None):
        return ServeEngine(fw["model"], fw["params"], fw["bank"],
                           ServeConfig(n_slots=8, max_seq=512,
                                       decode_block=8),
                           tracer=tracer, device="cuda")

    def run(eng):
        torch.cuda.synchronize()
        reset_launches()
        stats = eng.run(reqs)
        torch.cuda.synchronize()
        return stats, launch_counts()

    plain = engine()
    plain.run(synthetic_requests(WorkloadConfig(n_requests=2, seed=1, **wl)))
    plain.reset_stats()
    first, _ = run(plain)
    traced = engine(Tracer("step"))
    registry = MetricsRegistry()
    registry.bind_engine(traced)
    on, launches = run(traced)
    plain.reset_stats()
    second, _ = run(plain)
    toks = {f.req.rid: f.tokens.tolist() for f in first["finished"]}
    for label, stats in (("traced", on), ("second untraced", second)):
        got = {f.req.rid: f.tokens.tolist() for f in stats["finished"]}
        if got != toks:
            fail(f"traced serve: the {label} run's tokens differ from the "
                 f"untraced run's")
        if stats["wire_bytes"] != first["wire_bytes"]:
            fail(f"traced serve: the {label} run's wire bytes "
                 f"{stats['wire_bytes']} differ from {first['wire_bytes']}")
    missing = [k for k in PATHS["traced_dense"] if launches[k] <= 0]
    if missing:
        fail(f"traced serve: kernels of the path never launched: {missing}")
    base = OUT / "trace17_serve"
    paths = export_all(traced.tracer, str(base), meter=traced.meter,
                       registry=registry)
    check = trace_check(paths["jsonl"])
    say(f"traced serve ({fw['desc']}, 6 requests, tracer at step): tok/s "
        f"untraced {first['tok_per_s']:.1f}, traced {on['tok_per_s']:.1f}, "
        f"untraced again {second['tok_per_s']:.1f}; tokens and wire bytes "
        f"==; {len(traced.tracer.records())} records; trace_check: "
        + check.splitlines()[0])
    del plain, traced
    return launches, {
        "tok_per_s": {"untraced": first["tok_per_s"],
                      "traced": on["tok_per_s"],
                      "untraced_again": second["tok_per_s"]},
        "wall_s": {"untraced": first["wall_s"], "traced": on["wall_s"],
                   "untraced_again": second["wall_s"]},
        "tokens_out": first["tokens_out"], "trace_check": check,
        "exports": paths,
        "launches": {k: v for k, v in launches.items() if v}}


TRACED_TRAIN_ARGV = [
    "--arch", "vit-base", "--dataset", "cifar100-syn", "--samples", "128",
    "--clients", "2", "--k", "2", "--rounds", "1", "--local-epochs", "1",
    "--batch-size", "16", "--image-hw", "224", "--wire", "int8", "--seed",
    "0", "--device", "cuda", "--trace-level", "step", "--metrics-every",
    "1"]


def traced_train(torch):
    """`launch.train.main` at ViT-Base full width for one SFPrompt round
    with `--trace-out --trace-level step --metrics-every 1`: the record is
    finite, every kernel of the training path launched, and the exported
    JSONL passes tools/trace_check.py."""
    import numpy as np
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch import train
    out, base = OUT / "traced_train", OUT / "trace17_train"
    OUT.mkdir(exist_ok=True)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    train.main(TRACED_TRAIN_ARGV + ["--out", str(out), "--trace-out",
                                    str(base)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    with open(out / "vit-base_sfprompt_cifar100-syn.jsonl") as f:
        recs = [json.loads(line) for line in f]
    for p in out.rglob("*.npz"):    # too large to bring back
        p.unlink()
    bad = [k for r in recs for k, v in r.items()
           if isinstance(v, float) and not np.isfinite(v)]
    if len(recs) != 1 or bad:
        fail(f"traced train: records {recs}")
    missing = [k for k in PATHS["traced_train"] if launches[k] <= 0]
    if missing:
        fail(f"traced train: kernels never launched: {missing}")
    check = trace_check(f"{base}.jsonl")
    names = sorted({json.loads(line)["name"]
                    for line in open(f"{base}.jsonl")})
    for want in ("round", "round.dispatch", "phase1a", "phase1b", "phase2",
                 "phase3", "meter.absorb", "meter.final"):
        if want not in names:
            fail(f"traced train: no {want!r} record in {base}.jsonl")
    say(f"traced train (ViT-Base, 224x224, K 2, U 1, int8 wire, tracer at "
        f"step): main {wall:.2f} s, round {recs[0]['wall_s']} s; "
        f"trace_check: " + check.splitlines()[0])
    return launches, {"argv": TRACED_TRAIN_ARGV, "main_s": wall,
                      "round_wall_s": recs[0]["wall_s"],
                      "record_names": names, "trace_check": check,
                      "launches": {k: v for k, v in launches.items() if v}}


# --------------------------------------------------------------- phase 18
def lm_parity(torch):
    """One SFPrompt round on token data for the reduced qwen2.5, zamba2 and
    rwkv6 (d_model 64, 3 cycles: head 1 / body 1 / tail 1, vocab 128),
    card against CPU (`round_parity`). Returns the card's launches by path
    and the report."""
    from repro_torch.configs import get_config
    by_path, report = {}, {}
    for path, arch in (("lm_dense", "qwen2.5-14b"),
                       ("lm_hybrid", "zamba2-2.7b"),
                       ("lm_rwkv", "rwkv6-3b")):
        cyc = len(get_config(arch).layer_pattern)
        cfg = get_config(arch).reduced(n_layers=3 * cyc, d_model=64,
                                       d_ff=128, vocab_size=128)
        by_path[path], report[arch] = round_parity(torch, path, cfg)
    return by_path, report


def round_parity(torch, path, cfg, seed=0, margin=None, kernels=None,
                 cohort=None, test=None):
    """One SFPrompt round on token data for the reduced `cfg` (head 1 /
    body 1 / tail 1, vocab 128, sequences of 16, K 2, 8 samples a client,
    gamma 0.5; or the given `cohort` and `test` sets) on the card and on
    the CPU from the same weights (the port's init at `seed`), data and
    numpy wire noise, int8 wire, then `evaluate` (batches of 4):
    metered bytes, kept_frac and kept sets equal, params and losses within
    1e-4, and on the card the kernels of `path` (or `kernels`) launched
    (the Mamba-2 and RWKV-6 scans in scoring included). With `margin`,
    the router margin of the card's MoE calls (`router_margins`) is
    printed and must exceed it. Returns the card's launches and the
    report."""
    from repro_torch.core import (ProtocolConfig, SFPromptTrainer,
                                  SplitConfig, SplitModel)
    from repro_torch.data import (iid_partition, stack_clients,
                                  synthetic_lm_dataset)
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.runtime import WireSpec
    from repro_torch.tree import tree_leaves, tree_map
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=4,
                        prune_gamma=0.5, local_epochs=1)
    pcfg = ProtocolConfig(clients_per_round=2, local_epochs=1, batch_size=4,
                          lr_local=0.05, lr_split=0.05)
    if cohort is None:
        cohort = stack_clients(iid_partition(
            synthetic_lm_dataset(16, 16, 128, seed=0), 2, seed=0), [0, 1])
        test = synthetic_lm_dataset(16, 16, 128, seed=1)
    arch = cfg.name
    model = SplitModel(cfg, split, WireSpec.make("int8"))
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")
    runs, margins = {}, []
    for dev in ("cpu", "cuda"):
        tr = SFPromptTrainer(model, pcfg, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            reset_launches()
        with router_margins(margins if dev == "cuda" else []):
            state, m = tr.round(
                {"params": tree_map(lambda x: x.to(dev), params),
                 "round": 0}, cohort, wire_noise=numpy_wire_noise(torch, dev))
            ev = tr.evaluate(state["params"], test, batch_size=4)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = launch_counts()
        runs[dev] = (state["params"], m, tr.last_scores.cpu(),
                     tr.last_kept.cpu(), ev)
    (pc, mc, sc, kc, evc), (pg, mg, sg, kg, evg) = runs["cpu"], runs["cuda"]
    for key in mc:
        if (key.startswith(("wire/", "cohort/")) or key == "kept_frac") \
                and mg[key] != mc[key]:
            fail(f"lm parity ({arch}): {key} {mg[key]} on the card vs "
                 f"{mc[key]} on the CPU")
    for k in range(kc.shape[0]):
        differ = set(kc[k].tolist()) ^ set(kg[k].tolist())
        if differ:
            fail(f"lm parity ({arch}): client {k} kept samples "
                 f"{sorted(differ)} on one device only, scores "
                 f"{[float(sc[k, i]) for i in sorted(differ)]} vs cut "
                 f"{float(sc[k, kc[k, -1]])}")
    param_diff = max(float((a.cpu() - b).abs().max())
                     for a, b in zip(tree_leaves(pg), tree_leaves(pc)))
    loss_diff = max(abs(mg[k] - mc[k])
                    for k in ("local_loss", "split_loss", "el2n_mean"))
    if max(param_diff, loss_diff, abs(evg["ce"] - evc["ce"])) > PARITY_TOL:
        fail(f"lm parity ({arch}): params differ by {param_diff:.3g}, "
             f"losses by {loss_diff:.3g}, eval CE by "
             f"{abs(evg['ce'] - evc['ce']):.3g} > {PARITY_TOL}")
    missing = [k for k in kernels or PATHS[path] if launches[k] <= 0]
    if missing:
        fail(f"lm parity ({arch}): kernels never launched on the card: "
             f"{missing}")
    report = dict(
        param_max_diff=param_diff, loss_max_diff=loss_diff,
        score_max_diff=float((sg - sc).abs().max()),
        eval_ce_diff=abs(evg["ce"] - evc["ce"]),
        wire_bytes={k: mc[k] for k in mc if k.startswith("wire/")},
        launches={k: v for k, v in launches.items() if v})
    extra = ""
    if margin is not None:
        report["router_margin"] = check_margin(f"lm parity ({arch})",
                                               margins, margin)
        extra = f", router margin {report['router_margin']:.3g}"
    say(f"lm parity ({cfg.name}, K 2, int8 wire, numpy-seeded noise): "
        f"bytes, kept_frac and kept sets ==, max param diff "
        f"{param_diff:.3g}, loss diff {loss_diff:.3g} (<= {PARITY_TOL})"
        f"{extra}, card launches {report['launches']}")
    return launches, report


def lm_round(torch):
    """One SFPrompt round on token data at Qwen2.5-14B widths cut to 6
    layers (1 head / 4 body / 1 tail, prompt 4, int8 wire, fp32):
    `synthetic_lm_dataset` at seq 64, K 2, 16 samples a client, batch 4, U
    1, gamma 0.5, then `evaluate` on 16 sequences. Wire bytes equal the
    exact count, every metric finite, the kernels of the path launched
    (counts printed); the EL2N kernel's device time at the round's scoring
    shape (4 x 63 rows of the vocabulary); then one `make_train_step` (K
    2, b 4, S 64, microbatches 2, bf16 activations) and a prefill plus a
    decode step at the same widths. Returns the launches by path and the
    summary."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import (ProtocolConfig, SFPromptTrainer,
                                  SplitConfig, SplitModel)
    from repro_torch.data import (iid_partition, stack_clients,
                                  synthetic_lm_dataset)
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.el2n import ref as el2n_ref
    from repro_torch.kernels.el2n.kernel import el2n_fwd
    from repro_torch.launch import steps
    from repro_torch.obs.trace import Tracer
    from repro_torch.runtime import WireSpec
    from repro_torch.tree import tree_leaves, tree_map
    S, K, n_local, bs, prompt = 64, 2, 16, 4, 4
    cfg = dataclasses.replace(get_config("qwen2.5-14b"), n_layers=6)
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=prompt,
                        prune_gamma=0.5, local_epochs=1)
    model = SplitModel(cfg, split, WireSpec.make("int8"))
    pcfg = ProtocolConfig(clients_per_round=K, local_epochs=1,
                          batch_size=bs, lr_local=0.01, lr_split=0.01)
    V = cfg.vocab_size
    cohort = stack_clients(iid_partition(
        synthetic_lm_dataset(K * n_local, S, V, seed=0), K, seed=0),
        list(range(K)))
    test = synthetic_lm_dataset(16, S, V, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = SFPromptTrainer(model, pcfg, device="cuda",
                              tracer=Tracer("step"))
    state = trainer.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    reset_launches()
    t0 = time.perf_counter()
    state, m = trainer.round(state, cohort)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    round_launches = launch_counts()
    t0 = time.perf_counter()
    ev = trainer.evaluate(state["params"], test, batch_size=bs)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    phase_s = {r["name"]: r["dur_ns"] * 1e-9
               for r in trainer.tracer.records() if r["kind"] == "span"}
    bad = [k for k, v in list(m.items()) + list(ev.items())
           if not np.isfinite(v)]
    if bad:
        fail(f"lm round: non-finite metrics {bad}")
    keep = trainer.phase2_keep(n_local)
    per_crossing = model.wire.head_body.payload_nbytes((bs, prompt + S,
                                                        cfg.d_model))
    want = float(np.float32(K * (keep // bs) * 2 * per_crossing))
    for name in ("head_body", "body_tail"):
        if m[f"wire/{name}_bytes"] != want:
            fail(f"lm round: {name} metered {m[f'wire/{name}_bytes']} B, "
                 f"exact count {want} B")
    missing = [k for k in PATHS["lm"] if launches[k] <= 0]
    if missing:
        fail(f"lm round: kernels of the path never launched: {missing}")
    shown = {k: launches[k] for k in PATHS["lm"]}
    say(f"lm round launches (round + evaluate): {json.dumps(shown)}; the "
        f"round alone: "
        + json.dumps({k: round_launches[k] for k in PATHS["lm"]}))

    # the EL2N kernel at the round's scoring shape
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = bs * (S - 1)
    logits = torch.randn((rows, V), generator=gen, device="cuda")
    labels = torch.randint(0, V, (rows,), generator=gen, device="cuda",
                           dtype=torch.int32)
    got, want_s = el2n_fwd(logits, labels), el2n_ref.fused_scores(logits,
                                                                  labels)
    err = max(float(((a - b).abs() / (1 + b.abs())).max())
              for a, b in zip(got, want_s))
    if err > EL2N_TOL:
        fail(f"lm round: EL2N at ({rows}, {V}) off by {err:.3g}")
    el2n_dev = device_ms([lambda: el2n_fwd(logits, labels)])
    el2n_bound = bound(rows * V * 4 + rows * 4 + 2 * rows * 4,
                       5 * rows * V)[0]
    say(f"lm round EL2N at the scoring shape ({rows}, {V}) f32: device "
        f"{el2n_dev:.4f} ms, bound {el2n_bound:.4f} ms (bytes), err "
        f"{err:.3g}")
    del logits, labels, got, want_s

    # one make_train_step and a prefill plus a decode step, same widths
    params = state["params"]
    del trainer, state
    torch.cuda.empty_cache()
    train_step, opt = steps.make_train_step(model, n_clients=K,
                                            microbatches=2, lr=0.01)
    frozen = {"head": params["head"], "body": params["body"]}
    trainable_k = tree_map(lambda x: x[None].expand((K,) + tuple(x.shape)),
                           {"tail": params["tail"],
                            "prompt": params["prompt"]})
    opt_k = steps.init_opt_states(opt, trainable_k)
    batch_k = {"tokens": torch.from_numpy(
        cohort["tokens"][:, :bs]).cuda()}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    trainable_k, opt_k, loss = train_step(frozen, trainable_k, opt_k,
                                          batch_k)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_launches = launch_counts()
    same = all(bool(torch.equal(x[0], x[1]))
               for x in tree_leaves(trainable_k))
    if not (np.isfinite(float(loss)) and same):
        fail(f"lm train step: loss {float(loss)}, client copies equal "
             f"{same}")
    missing = [k for k in PATHS["lm_train_step"] if step_launches[k] <= 0]
    if missing:
        fail(f"lm train step: kernels never launched: {missing}")
    del trainable_k, opt_k
    torch.cuda.empty_cache()
    prefill = steps.make_prefill_step(model)
    decode = steps.make_decode_step(model)
    cache = model.init_cache(bs, 2 * S + prompt, device="cuda")
    toks = torch.from_numpy(test["tokens"][:bs]).cuda()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    last, cache = prefill(params, {"tokens": toks}, cache)
    nxt = torch.argmax(last, -1).to(torch.int32)[:, None]
    tok, dlogits, cache = decode(
        params, {"tokens": nxt,
                 "pos": torch.full((bs,), S + prompt, dtype=torch.int32,
                                   device="cuda")}, cache)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = launch_counts()
    if not (bool(torch.isfinite(last).all()) and
            bool(torch.isfinite(dlogits).all())) or \
            int(tok.min()) < 0 or int(tok.max()) >= V:
        fail(f"lm prefill/decode steps: tokens {tok.tolist()}")
    missing = [k for k in PATHS["lm_steps"] if serve_launches[k] <= 0]
    if missing:
        fail(f"lm prefill/decode steps: kernels never launched: {missing}")
    summary = {
        "config": f"{cfg.name} widths (d_model {cfg.d_model}, "
                  f"{cfg.attention.n_heads} / {cfg.attention.n_kv_heads} x "
                  f"{cfg.attention.head_dim}, vocab {V}), 6 layers (1 head "
                  f"/ 4 body / 1 tail), prompt {prompt}, "
                  f"synthetic_lm_dataset seq {S}, K {K}, {n_local} samples "
                  f"a client, batch {bs}, U 1, gamma 0.5, int8 wire, fp32",
        "params": n_params, "setup_s": setup_s, "round_s": round_s,
        "phase_s": phase_s, "eval_s": eval_s, "metrics": m, "eval": ev,
        "max_memory_allocated_gb": peak_gb,
        "launches": {k: v for k, v in launches.items() if v},
        "round_launches": {k: v for k, v in round_launches.items() if v},
        "el2n_scoring": {"shape": [rows, V], "device_ms": el2n_dev,
                         "bound_ms": el2n_bound, "max_err": err},
        "train_step": {"s": step_s, "loss": float(loss),
                       "launches": {k: v for k, v in step_launches.items()
                                    if v}},
        "prefill_decode": {"s": serve_s, "tokens": tok.tolist(),
                           "launches": {k: v for k, v in
                                        serve_launches.items() if v}}}
    say("lm round full width: " + json.dumps(summary, sort_keys=True))
    return {"lm": launches, "lm_train_step": step_launches,
            "lm_steps": serve_launches}, summary


# ------------------------------------------------------------- phase 20
MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b")
# the port's init seeds of phase 20 (a) whose reduced runs keep every
# router margin above its floor, drawn on the CPU: for the Transformer and
# the engine, seeds 0-11 kept both above 1e-4 at 2, 8, 9, 10 (phi3.5-moe;
# seed 0's engine 8.3e-5) and 5, 9 (deepseek-v3; seed 0's Transformer
# 7.2e-5); for the round and `evaluate`, 18 and 20 of seeds 0-39 stayed
# above 1e-5 (seed 0: 1.1e-5 and 3.8e-6)
MOE_SEED = {"phi3.5-moe-42b-a6.6b": 9, "deepseek-v3-671b": 9}
MOE_ROUND_SEED = {"phi3.5-moe-42b-a6.6b": 11, "deepseek-v3-671b": 21}
MOE_MARGIN = 1e-4        # the Transformer and the engine
MOE_ROUND_MARGIN = 1e-5  # a round's ~1700 routed tokens a layer pass
#                          (tests/test_torch_moe_round.py)


class router_margins:
    """Context manager: appends the router margin (the smallest gap between
    a token's k-th and (k+1)-th router probability,
    `models/layers.py::router_margin`) of every MoE call inside it to
    `log`."""

    def __init__(self, log):
        self.log = log

    def __enter__(self):
        from repro_torch.models import layers
        self.layers, self.inner, log = layers, layers.apply_moe, self.log

        def probe(p, cfg, x, *mesh, inner=self.inner):
            log.append(layers.router_margin(p, cfg, x))
            return inner(p, cfg, x, *mesh)
        layers.apply_moe = probe
        return log

    def __exit__(self, *exc):
        self.layers.apply_moe = self.inner


def check_margin(label, margins, floor):
    """The smallest router margin of a run; fails at or below `floor`."""
    if not margins:
        fail(f"{label}: no MoE call was probed")
    low = min(margins)
    if low <= floor:
        fail(f"{label}: router margin {low:.3g} <= {floor}: an expert "
             f"choice is within reach of rounding")
    return low


class attention_shapes:
    """Context manager: the (query/key dim, value dim) of every prefill and
    decode attention call the layers make inside it, by op."""

    def __enter__(self):
        from repro_torch.models import layers
        self.layers = layers
        self.inner = (layers.flash_attention, layers.decode_attention)
        self.seen = {"prefill": set(), "decode": set()}

        def rec(op, fn):
            def call(q, k, v, **kw):
                self.seen[op].add((q.shape[-1], v.shape[-1]))
                return fn(q, k, v, **kw)
            return call
        layers.flash_attention = rec("prefill", self.inner[0])
        layers.decode_attention = rec("decode", self.inner[1])
        return self.seen

    def __exit__(self, *exc):
        self.layers.flash_attention, self.layers.decode_attention = \
            self.inner


def reduced_family(arch):
    from repro_torch.configs import get_config
    return get_config(arch).reduced(n_layers=3, d_model=64, d_ff=128,
                                    vocab_size=128)


def moe_parity(torch):
    """Phase 20 (a): the reduced phi3.5-moe and deepseek-v3 (3 MoE layers,
    deepseek-v3 also its dense prefix layer; MLA, a shared expert and the
    MTP head; d_model 64, vocab 128, top-2 of 4) on the card and on the
    CPU from the same seeded weights: the unsplit `Transformer` (train
    logits, aux loss and deepseek-v3's MTP logits, then prefill and decode
    logits, within 1e-4), the dense engine on the int8 wire with phase 4's
    traffic (tokens and wire bytes equal, logits within 1e-4) and an
    SFPrompt round on token data with `evaluate` (`round_parity`, int8,
    numpy noise); the router margins printed and held above their floors,
    the family's kernels launched on the card. Returns the launches by
    path and the report."""
    import numpy as np
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import personalized_bank
    from repro_torch.models.transformer import Transformer
    from repro_torch.runtime import WireSpec
    from repro_torch.serve import (ServeConfig, ServeEngine, TenantBank,
                                   WorkloadConfig, synthetic_requests)
    from repro_torch.tree import tree_map
    by_path, report = {}, {}
    for path, arch in zip(("moe_parity", "mla_parity"), MOE_ARCHS):
        cfg = reduced_family(arch)
        seed, out = MOE_SEED[arch], {}
        torch.cuda.synchronize()
        reset_launches()
        # the unsplit model
        tm = Transformer(cfg)
        params = tm.init(torch.Generator().manual_seed(seed), device="cpu")
        toks = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (2, 17)).astype(np.int32)
        got, margins = {}, []
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda x: x.to(dev), params)
            t = torch.from_numpy(toks).to(dev)
            with torch.no_grad(), router_margins(
                    margins if dev == "cuda" else []):
                tr = tm.apply(p, {"tokens": t}, mode="train")
                cache = tm.init_cache(2, 32, device=dev)
                pre = tm.apply(p, {"tokens": t[:, :16]}, mode="prefill",
                               cache=cache)
                dec = tm.apply(p, {"tokens": t[:, 16:], "pos": torch.full(
                    (2,), 16, dtype=torch.int32, device=dev)},
                    mode="decode", cache=pre["cache"])
            got[dev] = {"train logits": tr["logits"],
                        "aux_loss": tr["aux_loss"],
                        "prefill logits": pre["logits"],
                        "decode logits": dec["logits"]}
            if "mtp_logits" in tr:
                got[dev]["mtp_logits"] = tr["mtp_logits"]
        diffs = {k: float((got["cuda"][k].cpu() - v).abs().max())
                 for k, v in got["cpu"].items()}
        if max(diffs.values()) > PARITY_TOL:
            fail(f"{arch} Transformer card vs CPU: {diffs} > {PARITY_TOL}")
        out["transformer"] = dict(max_diff=diffs, router_margin=check_margin(
            f"{arch} Transformer", margins, MOE_MARGIN))
        # the dense engine, phase 4's traffic
        model = SplitModel(cfg, SplitConfig(head_cycles=1, tail_cycles=1,
                                            prompt_len=4),
                           WireSpec.make("int8"))
        params = model.init(torch.Generator().manual_seed(seed),
                            device="cpu")
        bank = personalized_bank(model, params, 3, jitter=0.2)
        reqs = synthetic_requests(WorkloadConfig(
            n_requests=6, prompt_choices=(6, 11), new_token_choices=(3, 6),
            n_tenants=3, vocab_size=cfg.vocab_size, seed=3))
        runs, margins = {}, []
        for dev in ("cpu", "cuda"):
            with router_margins(margins if dev == "cuda" else []):
                st = ServeEngine(
                    model, tree_map(lambda x: x.to(dev), params),
                    TenantBank(tree_map(lambda x: x.to(dev), bank.tails),
                               bank.prompts.to(dev)),
                    ServeConfig(n_slots=3, max_seq=48, decode_block=4),
                    collect_logits=True, device=dev).run(reqs)
            runs[dev] = ({f.req.rid: f for f in st["finished"]},
                         st["wire_bytes"])
        out["engine"] = dict(
            max_logit_diff=compare_runs(f"{arch} engine parity", runs),
            router_margin=check_margin(f"{arch} engine", margins,
                                       MOE_MARGIN))
        torch.cuda.synchronize()
        serve_launches = launch_counts()
        # the SFPrompt round and `evaluate` (phase 18's setup)
        launches, out["round"] = round_parity(
            torch, path, cfg, seed=MOE_ROUND_SEED[arch],
            margin=MOE_ROUND_MARGIN, kernels=PATHS["lm"])
        by_path[path] = {k: v + serve_launches[k]
                         for k, v in launches.items()}
        missing = [k for k in PATHS[path] if by_path[path][k] <= 0]
        if missing:
            fail(f"{arch} parity: kernels never launched on the card: "
                 f"{missing}")
        out["launches"] = {k: v for k, v in by_path[path].items() if v}
        say(f"{arch} card vs CPU ({cfg.name}, {cfg.n_layers} layers, int8 "
            f"wire): Transformer max diffs {diffs}, router margin "
            f"{out['transformer']['router_margin']:.3g}; engine tokens and "
            f"bytes ==, max logit diff {out['engine']['max_logit_diff']:.3g}"
            f", router margin {out['engine']['router_margin']:.3g}; round "
            f"router margin {out['round']['router_margin']:.3g}; card "
            f"launches {out['launches']}")
        report[arch] = out
    return by_path, report


def moe_full_cfg(arch):
    """Phase 20's full-width configs: phi3.5-moe at 4 layers (head 1 / body
    2 / tail 1); deepseek-v3 at 6 (its 3 dense prefix layers, then MoE
    head 1 / body 1 / tail 1) with 16 of its 256 routed experts."""
    from repro_torch.configs import get_config
    base = get_config(arch)
    if arch == "phi3.5-moe-42b-a6.6b":
        return dataclasses.replace(base, n_layers=4), {
            "n_layers": f"{base.n_layers} -> 4"}
    return (dataclasses.replace(base, n_layers=6, moe=dataclasses.replace(
        base.moe, n_experts=16)),
        {"n_layers": f"{base.n_layers} -> 6 (3 dense + 3 MoE)",
         "routed experts": f"{base.moe.n_experts} -> 16"})


def analytic_weight_bytes(cfg, tenants):
    """4 B a param of what the card holds for a full-width serving run,
    counted from `param_count()`: the model, the MTP head (`param_count`
    leaves it out) and the extra tenants' tails (an MoE layer and the LM
    head, and the MTP head, each)."""
    rep = dataclasses.replace
    total = cfg.param_count()
    moe_layer = total - rep(cfg, n_layers=cfg.n_layers - 1).param_count()
    mtp = 0
    if cfg.mtp:
        n = cfg.n_dense_layers or 1
        dense = (rep(cfg, n_layers=n + 1, n_dense_layers=n + 1).param_count()
                 - rep(cfg, n_layers=n, n_dense_layers=n).param_count())
        mtp = 2 * cfg.d_model ** 2 + dense
    tail = moe_layer + cfg.d_model * cfg.vocab_size + mtp
    return 4 * (total + mtp + (tenants - 1) * tail)


def full_width_moe(torch, arch, path):
    """Phase 20 (b) and (c): `arch` at published widths (`moe_full_cfg`),
    2 tenants, through the dense engine with phase 5's other settings (8
    slots, max_seq 512, int8 wire, decode_block 8, 16 requests): checked
    as phase 5, then a profiled replay; the card's weight bytes after
    set-up against `param_count()` (within 2%), the host syncs per decode
    step, the attention head dims each kernel ran at (deepseek-v3's prefill
    and decode must both run at 192 / 128)."""
    cfg, cuts = moe_full_cfg(arch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    fw = full_width_model(torch, arch, tenants=2, cfg=cfg)
    held = torch.cuda.memory_allocated() - before
    want = analytic_weight_bytes(cfg, 2)
    if abs(held - want) / want > 0.02:
        fail(f"{path} full width: {held / 1e9:.3f} GB of weights on the "
             f"card vs {want / 1e9:.3f} GB by param_count()")
    say(f"{path} full width: {fw['desc']}, cuts {cuts}; weights on the "
        f"card {held / 1e9:.3f} GB, by param_count() {want / 1e9:.3f} GB")
    with attention_shapes() as shapes:
        launches, summary = full_width(torch, fw, path)
    att = cfg.attention
    if att.mla is not None:
        m = att.mla
        want_dims = {(m.qk_nope_head_dim + m.qk_rope_head_dim,
                      m.v_head_dim)}
    else:
        want_dims = {(att.head_dim, att.head_dim)}
    if shapes["prefill"] != want_dims or shapes["decode"] != want_dims:
        fail(f"{path} full width: attention ran at {shapes}, want "
             f"{want_dims} for prefill and decode")
    summary.update(cuts=cuts, weight_gb=held / 1e9,
                   weight_gb_by_param_count=want / 1e9,
                   attention_dims={k: sorted(v) for k, v in shapes.items()})
    say(f"{path} full width: host syncs {summary['moe_host_syncs']} "
        f"({summary['moe_host_syncs_per_decode_step']:.2f} a decode step), "
        f"peak {summary['max_memory_allocated_gb']:.2f} GB, attention dims "
        f"{summary['attention_dims']}")
    del fw
    torch.cuda.empty_cache()
    return launches, summary


# ------------------------------------------------------------- phase 21
G2_ARCHS = ("whisper-base", "qwen2-vl-72b")


def g2_extras(np, cfg, rng, n, grid=(2, 2, 2)):
    """The batch keys the frontend stubs bring for n samples: Whisper's
    frames (n, n_frames, D); Qwen2-VL's patch embeddings (n, t h w, D) and
    their M-RoPE positions on the (t, h, w) `grid`, stored
    client-axis-first as (n, 3, t h w)."""
    if cfg.arch_type == "audio":
        return {"frames": (0.02 * rng.standard_normal(
            (n, cfg.encoder.n_frames, cfg.d_model))).astype(np.float32)}
    g = np.stack(np.meshgrid(*(np.arange(k) for k in grid),
                             indexing="ij")).reshape(3, -1)
    return {"patch_embeds": (0.02 * rng.standard_normal(
                (n, g.shape[1], cfg.d_model))).astype(np.float32),
            "mrope_positions": np.ascontiguousarray(
                np.broadcast_to(g[None], (n,) + g.shape), dtype=np.int32)}


def split_generate(torch, model, params, batch, n_new):
    """Greedy generation through the split route: a prefill of `batch`
    (tensors on the model's device) into a fresh cache, then `n_new`
    decode steps, each feeding back the token before. Returns the tokens
    (B, 1 + n_new), the logits of every step, the wire bytes per link
    summed over the steps, and the prefill and decode seconds (synced)."""
    B, S = batch["tokens"].shape
    dev = batch["tokens"].device
    n_pre = model.split.prompt_len + S + (batch["patch_embeds"].shape[1]
                                          if "patch_embeds" in batch else 0)
    cache = model.init_cache(B, n_pre + n_new, device=dev)
    wire = {}

    def add(out):
        for k, v in out["wire_bytes"].items():
            wire[k] = wire.get(k, 0.0) + float(v)
        return out["logits"][:, -1]

    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = [add(model.forward(params, batch, mode="prefill",
                                    cache=cache))]
        toks = [torch.argmax(logits[-1], -1).to(torch.int32)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in range(n_new):
            step = {"tokens": toks[-1][:, None],
                    "pos": torch.full((B,), n_pre + t, dtype=torch.int32,
                                      device=dev)}
            logits.append(add(model.forward(params, step, mode="decode",
                                            cache=cache)))
            toks.append(torch.argmax(logits[-1], -1).to(torch.int32))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (torch.stack(toks, 1), torch.stack(logits, 1), wire, t1 - t0,
            t2 - t1)


def g2_parity(torch):
    """Phase 21 (a): the reduced whisper-base (a 1-layer encoder over 16
    frames, 3 decoder layers) and qwen2-vl-72b (M-RoPE (4, 6, 6), QKV
    bias), d_model 64, vocab 128, on the card and on the CPU from the same
    seeded weights: the unsplit `Transformer` (train logits, then a
    prefill and a decode step, within 1e-4), a split prefill of (2, 7)
    tokens with frames or 8 patch embeddings on a (2, 2, 2) grid, then 4
    greedy decode steps on the int8 wire (tokens and wire bytes equal,
    logits within 1e-4), and an SFPrompt round (K 2, 16 samples a client
    with the family's keys, batch 4, U 1, gamma 0.5) with `evaluate` on 32
    samples (`round_parity`); the family's kernels launched on the card.
    Returns the launches by path and the report."""
    import numpy as np
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.data import (iid_partition, stack_clients,
                                  synthetic_lm_dataset)
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.transformer import Transformer
    from repro_torch.runtime import WireSpec
    from repro_torch.tree import tree_map
    by_path, report = {}, {}
    for path, arch in zip(("whisper_parity", "vlm_parity"), G2_ARCHS):
        cfg, out = reduced_family(arch), {}
        torch.cuda.synchronize()
        reset_launches()
        # the unsplit model
        tm = Transformer(cfg)
        params = tm.init(torch.Generator().manual_seed(0), device="cpu")
        rng = np.random.default_rng(0)
        batch = dict(tokens=rng.integers(0, 128, (2, 17)).astype(np.int32),
                     **g2_extras(np, cfg, rng, 2))
        n_extra = 8 if "patch_embeds" in batch else 0
        got = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda x: x.to(dev), params)
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            with torch.no_grad():
                tr = tm.apply(p, b, mode="train")
                cache = tm.init_cache(2, 32 + n_extra, device=dev)
                pre = tm.apply(p, dict(b, tokens=b["tokens"][:, :16]),
                               mode="prefill", cache=cache)
                dec = tm.apply(p, {"tokens": b["tokens"][:, 16:],
                                   "pos": torch.full(
                                       (2,), 16 + n_extra, dtype=torch.int32,
                                       device=dev)},
                               mode="decode", cache=pre["cache"])
            got[dev] = {"train logits": tr["logits"],
                        "prefill logits": pre["logits"],
                        "decode logits": dec["logits"]}
        diffs = {k: float((got["cuda"][k].cpu() - v).abs().max())
                 for k, v in got["cpu"].items()}
        if max(diffs.values()) > PARITY_TOL:
            fail(f"{arch} Transformer card vs CPU: {diffs} > {PARITY_TOL}")
        out["transformer_max_diff"] = diffs
        # the split model on the int8 wire
        model = SplitModel(cfg, SplitConfig(head_cycles=1, tail_cycles=1,
                                            prompt_len=4),
                           WireSpec.make("int8"))
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        rng = np.random.default_rng(1)
        batch = dict(tokens=rng.integers(0, 128, (2, 7)).astype(np.int32),
                     **g2_extras(np, cfg, rng, 2))
        runs = {}
        for dev in ("cpu", "cuda"):
            runs[dev] = split_generate(
                torch, model, tree_map(lambda x: x.to(dev), params),
                {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                4)
        (tc, lc, wc, _, _), (tg, lg, wg, _, _) = runs["cpu"], runs["cuda"]
        gap = float((lg.cpu() - lc).abs().max())
        if not torch.equal(tg.cpu(), tc) or wg != wc or gap > PARITY_TOL:
            fail(f"{arch} split generate card vs CPU: tokens "
                 f"{tg.tolist()} vs {tc.tolist()}, bytes {wg} vs {wc}, "
                 f"max logit diff {gap:.3g}")
        out["split"] = dict(tokens=tc.tolist(), wire_bytes=wc,
                            max_logit_diff=gap)
        torch.cuda.synchronize()
        serve_launches = launch_counts()
        # the SFPrompt round with the family's keys, `evaluate` on 32
        rng = np.random.default_rng(2)
        data = synthetic_lm_dataset(32, 16, 128, seed=0)
        data.update(g2_extras(np, cfg, rng, 32))
        test = synthetic_lm_dataset(32, 16, 128, seed=1)
        test.update(g2_extras(np, cfg, rng, 32))
        launches, out["round"] = round_parity(
            torch, path, cfg, kernels=PATHS["lm"],
            cohort=stack_clients(iid_partition(data, 2, seed=0), [0, 1]),
            test=test)
        by_path[path] = {k: v + serve_launches[k]
                         for k, v in launches.items()}
        missing = [k for k in PATHS[path] if by_path[path][k] <= 0]
        if missing:
            fail(f"{arch} parity: kernels never launched on the card: "
                 f"{missing}")
        out["launches"] = {k: v for k, v in by_path[path].items() if v}
        say(f"{arch} card vs CPU ({cfg.name}, {cfg.n_layers} layers, int8 "
            f"wire): Transformer max diffs {diffs}; split tokens and bytes "
            f"==, max logit diff {gap:.3g}; round as above; card launches "
            f"{out['launches']}")
        report[arch] = out
    return by_path, report


def g2_full_cfg(arch):
    """Phase 21's full-width configs: whisper-base whole (6 encoder + 6
    decoder layers); qwen2-vl-72b at 6 of its 80 layers (1 head / 4 body
    / 1 tail)."""
    from repro_torch.configs import get_config
    base = get_config(arch)
    if arch == "whisper-base":
        return base, {}
    return (dataclasses.replace(base, n_layers=6),
            {"n_layers": f"{base.n_layers} -> 6"})


def g2_full_width(torch, arch, path):
    """Phase 21 (b) and (c): `arch` at published widths (`g2_full_cfg`),
    head 1 / tail 1, prompt 4, int8 wire, f32, seeded weights: a split
    prefill and 32 greedy decode steps (Whisper: 4 sequences of 64 tokens
    with their 1500 frames; Qwen2-VL: 2 sequences of a 4-token prompt, 64
    patch embeddings on a (1, 8, 8) grid and 64 text tokens), the metered
    bytes equal to the exact count; for Whisper also an SFPrompt round (K
    2, 16 samples a client of 16 tokens and 1500 frames, batch 4, U 1,
    gamma 0.5) and `evaluate` on 32 samples, the round's bytes equal to the
    exact count. Prints the weights, the peak memory, tok/s and the
    launches by kernel; fails unless every kernel of `path` launched."""
    import numpy as np
    from repro_torch.core import (ProtocolConfig, SFPromptTrainer,
                                  SplitConfig, SplitModel)
    from repro_torch.data import (iid_partition, stack_clients,
                                  synthetic_lm_dataset)
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.obs.trace import Tracer
    from repro_torch.runtime import WireSpec
    from repro_torch.tree import tree_leaves
    cfg, cuts = g2_full_cfg(arch)
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=4,
                        prune_gamma=0.5, local_epochs=1)
    model = SplitModel(cfg, split, WireSpec.make("int8"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    weight_gb = (torch.cuda.memory_allocated() - before) / 1e9
    # the init's own peak (a stack's layers and the stacked copy at once),
    # then the run's from here
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    V, D = cfg.vocab_size, cfg.d_model
    rng = np.random.default_rng(0)
    if cfg.arch_type == "audio":
        B, S, grid = 4, 64, None
        batch = dict(tokens=rng.integers(0, V, (B, S)).astype(np.int32),
                     **g2_extras(np, cfg, rng, B))
    else:
        B, S, grid = 2, 64, (1, 8, 8)
        batch = dict(tokens=rng.integers(0, V, (B, S)).astype(np.int32),
                     **g2_extras(np, cfg, rng, B, grid))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    n_new = 32
    reset_launches()
    toks, logits, wire, pre_s, dec_s = split_generate(torch, model, params,
                                                      batch, n_new)
    gen_launches = launch_counts()
    gen_shapes = prefill_launch_shapes()
    n_pre = split.prompt_len + S + (64 if grid else 0)
    want = float(model.wire.head_body.payload_nbytes((B, n_pre, D))
                 + n_new * model.wire.head_body.payload_nbytes((B, 1, D)))
    if not bool(torch.isfinite(logits).all()) or int(toks.min()) < 0 \
            or int(toks.max()) >= V:
        fail(f"{path} full width: tokens {toks.tolist()}")
    if wire != {"head_body": want, "body_tail": want}:
        fail(f"{path} full width: metered {wire}, exact count {want} B a "
             f"link")
    summary = dict(
        config=f"{cfg.name} widths (d_model {D}, {cfg.attention.n_heads} / "
               f"{cfg.attention.n_kv_heads} x {cfg.attention.head_dim}, "
               f"vocab {V}), {cfg.n_layers} layers (1 head / "
               f"{model.body_cycles} body / 1 tail)"
               + (f", encoder {cfg.encoder.n_layers} layers over "
                  f"{cfg.encoder.n_frames} frames" if cfg.encoder else "")
               + ", prompt 4, int8 wire, fp32",
        cuts=cuts, params=n_params, weight_gb=weight_gb, setup_s=setup_s,
        init_peak_gb=init_peak_gb,
        generate=dict(batch=B, prefill_rows=n_pre, new_tokens=n_new,
                      prefill_s=pre_s, decode_s=dec_s,
                      decode_tok_per_s=B * n_new / dec_s,
                      tok_per_s=B * (n_new + 1) / (pre_s + dec_s),
                      wire_bytes=wire,
                      launches={k: v for k, v in gen_launches.items()
                                if v},
                      prefill_shapes=gen_shapes))
    launches = dict(gen_launches)
    if cfg.arch_type == "audio":
        K, n_local, bs, Sr = 2, 16, 4, 16
        pcfg = ProtocolConfig(clients_per_round=K, local_epochs=1,
                              batch_size=bs, lr_local=0.01, lr_split=0.01)
        data = synthetic_lm_dataset(K * n_local, Sr, V, seed=0)
        data.update(g2_extras(np, cfg, rng, K * n_local))
        cohort = stack_clients(iid_partition(data, K, seed=0),
                               list(range(K)))
        test = synthetic_lm_dataset(32, Sr, V, seed=1)
        test.update(g2_extras(np, cfg, rng, 32))
        trainer = SFPromptTrainer(model, pcfg, device="cuda",
                                  tracer=Tracer("step"))
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state, m = trainer.round({"params": params, "round": 0}, cohort)
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ev = trainer.evaluate(state["params"], test, batch_size=bs)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        round_launches = launch_counts()
        round_shapes = prefill_launch_shapes()
        bad = [k for k, v in list(m.items()) + list(ev.items())
               if not np.isfinite(v)]
        if bad:
            fail(f"{path} round: non-finite metrics {bad}")
        keep = trainer.phase2_keep(n_local)
        per_crossing = model.wire.head_body.payload_nbytes(
            (bs, split.prompt_len + Sr, D))
        want_r = float(np.float32(K * (keep // bs) * 2 * per_crossing))
        for name in ("head_body", "body_tail"):
            if m[f"wire/{name}_bytes"] != want_r:
                fail(f"{path} round: {name} metered "
                     f"{m[f'wire/{name}_bytes']} B, exact count {want_r} B")
        summary["round"] = dict(
            K=K, samples_a_client=n_local, seq=Sr, batch=bs, round_s=round_s,
            eval_s=eval_s, metrics=m, eval=ev,
            phase_s={r["name"]: r["dur_ns"] * 1e-9
                     for r in trainer.tracer.records()
                     if r["kind"] == "span"},
            launches={k: v for k, v in round_launches.items() if v},
            prefill_shapes=round_shapes)
        launches = {k: v + round_launches[k] for k, v in launches.items()}
        del trainer, state
    summary["max_memory_allocated_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    missing = [k for k in PATHS[path] if launches[k] <= 0]
    if missing:
        fail(f"{path} full width: kernels of the path never launched: "
             f"{missing}")
    summary["launches"] = {k: v for k, v in launches.items() if v}
    g = summary["generate"]
    say(f"{path} full width: {summary['config']}, cuts {cuts}; weights "
        f"{weight_gb:.3f} GB ({n_params} params), peak "
        f"{summary['max_memory_allocated_gb']:.2f} GB (the init's "
        f"{init_peak_gb:.2f}); prefill of "
        f"{B} x {n_pre} rows {pre_s:.3f} s, {n_new} decode steps "
        f"{dec_s:.3f} s ({g['decode_tok_per_s']:.1f} tok/s decoding, "
        f"{g['tok_per_s']:.1f} tok/s with the prefill); wire {wire}; "
        f"launches {summary['launches']}")
    if "round" in summary:
        r = summary["round"]
        say(f"{path} round: {r['round_s']:.3f} s (phases "
            + ", ".join(f"{k} {v:.3f}" for k, v in r["phase_s"].items()
                        if k != "round")
            + f"), evaluate {r['eval_s']:.3f} s; metrics {r['metrics']}, "
            f"eval {r['eval']}")
    del params, batch, logits
    torch.cuda.empty_cache()
    return launches, summary


# -------------------------------------------------------------------- main
# ---------------------------------------------------------------- phase 22
TP_RANKS = 2
TP_TENANTS = 2
TP_SERVE_CFG = dict(n_slots=4, max_seq=256, decode_block=8)
TP_PAGE = 16


def tp_shapes(torch, F, gen, results):
    """The attention kernels at the per-rank shapes of phase 22 (a rank's
    heads at 'model' 2), held against plain and timed as phase 3 times
    its shapes, under "tp" in each record: the prefill kernel at
    Qwen2.5-14B's causal prefill (1, 132, 20 / 4 x 128: G 5) and ViT-Base's
    non-causal scoring (16, 213, 6 x 64), the dense decode kernel at 20 / 4
    x 128 over 8 slots of 512 and the paged one at 20 / 4 x 128 over 16
    slots of page 16. The wire and EL2N run on replicated rows, at the
    shapes phase 3 already holds."""
    pre = results["flash_attention_prefill"]
    pre["tp"] = {
        "qwen2.5-14b 20 / 4 x 128": prefill_shape(
            torch, F, gen, "qwen2.5-14b a rank of 2", 1, 20, 128, True,
            (37, 132), Hkv=4),
        "vit-base 6 x 64": prefill_shape(
            torch, F, gen, "vit-base a rank of 2", 16, 6, 64, False, (213,))}
    dec = results["decode_attention"]
    dec["tp"] = {"qwen2.5-14b 20 / 4 x 128": decode_record(
        torch, F, gen, 20, 4, 128, sweep=False)}
    paged = results["paged_decode_attention"]
    paged["tp"] = {"qwen2.5-14b 20 / 4 x 128": paged_record(
        torch, F, gen, 20, 4, 128, sweep=False)}
    for rec in (pre, dec, paged):
        rec["max_abs_err"] = max(rec["max_abs_err"], *(
            r["max_abs_err"] for r in rec["tp"].values()))


def tp_trace(cfg):
    """Phase 22's serving trace: shorter than phase 5's."""
    from repro_torch.serve import WorkloadConfig, synthetic_requests
    return synthetic_requests(WorkloadConfig(
        n_requests=6, seed=3, mean_interarrival=1.0,
        prompt_choices=(32, 64), new_token_choices=(8, 16),
        n_tenants=TP_TENANTS, vocab_size=cfg.vocab_size))


def tp_engine(torch, kind, model, params, bank, mesh, dev):
    from repro_torch.serve import (PagedServeConfig, PagedServeEngine,
                                   ServeConfig, ServeEngine)
    if kind == "dense":
        return ServeEngine(model, params, bank, ServeConfig(**TP_SERVE_CFG),
                           collect_logits=True, mesh=mesh, device=dev)
    return PagedServeEngine(
        model, params, bank,
        PagedServeConfig(page_size=TP_PAGE, **TP_SERVE_CFG),
        collect_logits=True, mesh=mesh, device=dev)


def tp_serve_model(torch, dev, small):
    """Phase 5's model (Qwen2.5-14B widths, 3 layers, seed 0) with
    TP_TENANTS tenants on its int8 wire and the same weights on the fp32
    wire; `small`: the family reduced as tests/test_mesh_tp.py's serving
    fixture (3 layers, d_model 128, d_ff 256, vocab 128)."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.launch.serve import personalized_bank
    from repro_torch.runtime import WireSpec
    cfg = get_config("qwen2.5-14b")
    cfg = (cfg.reduced(n_layers=3, d_model=128, d_ff=256, vocab_size=128)
           if small else dc.replace(cfg, n_layers=3))
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=4)
    models = {w: SplitModel(cfg, split, WireSpec.make(w))
              for w in ("fp32", "int8")}
    params = models["int8"].init(torch.Generator(device=dev).manual_seed(0),
                                 device=dev)
    bank = personalized_bank(models["int8"], params, TP_TENANTS)
    del params["tail"]
    return cfg, models, params, bank


def tp_serve_runs(torch, mesh, dev, small, on_run=None):
    """Dense then paged, fp32 wire then int8, one engine at a time, on
    `mesh` (None: one process). Returns per run the tokens, every logits
    row, the wire bytes, tok/s and (through `on_run(label, engine)`,
    called around each run) whatever the caller measures."""
    import numpy as np
    cfg, models, params, bank = tp_serve_model(torch, dev, small)
    reqs = tp_trace(cfg)
    out = {}
    for wire in ("fp32", "int8"):
        for kind in ("dense", "paged"):
            label = f"{kind}_{wire}"
            eng = tp_engine(torch, kind, models[wire], params, bank, mesh,
                            dev)
            eng.run(tp_trace(cfg)[:1])          # warm: handles, pools
            eng.reset_stats()
            ctx = on_run(label, eng) if on_run else None
            if ctx is not None:
                ctx.__enter__()
            stats = eng.run(list(reqs))
            if dev != "cpu":
                torch.cuda.synchronize()
            if ctx is not None:
                ctx.__exit__(None, None, None)
            if stats["n_finished"] != len(reqs):
                fail(f"phase 22 {label}: {stats['n_finished']} of "
                     f"{len(reqs)} requests finished")
            out[label] = {
                "tokens": {f.req.rid: np.asarray(f.tokens)
                           for f in stats["finished"]},
                "logits": {f.req.rid: np.asarray(f.logits)
                           for f in stats["finished"]},
                "wire": stats["wire_bytes"], "tok_per_s": stats["tok_per_s"],
                "decode_steps": stats["decode_steps"]}
            if label == "dense_int8" and mesh is not None:
                out["shapes"] = tp_shard_shapes(eng)
            if label == "dense_fp32" and mesh is None:
                out["batch1_gap"] = tp_batch1_gap(torch, models[wire],
                                                  params, bank, reqs,
                                                  out[label], dev)
            del eng
            if dev != "cpu":
                torch.cuda.empty_cache()
    return out


def tp_batch1_gap(torch, model, params, bank, reqs, run, dev):
    """One process's own logit gap from a change of batch shape alone:
    each request teacher-forced alone (batch 1, `forced_logits`) on the
    engine's tokens against its rows in the engine's batch of slots."""
    import numpy as np
    from repro_torch.serve.steps import forced_logits
    shared = {"head": params["head"], "body": params["body"]}
    gap = 0.0
    for req in reqs:
        alone = forced_logits(model, shared, bank, req,
                              run["tokens"][req.rid],
                              max_seq=TP_SERVE_CFG["max_seq"], device=dev)
        gap = max(gap, float(np.abs(alone - run["logits"][req.rid]).max()))
    return gap


def tp_shard_shapes(eng):
    """The local shapes of a few of an engine's frozen leaves and caches."""
    h, b = eng.shared["head"], eng.shared["body"]
    att, mlp = b["stack"]["pos0"]["attn"], b["stack"]["pos0"]["mlp"]
    out = {"head embed/tok": h["embed"]["tok"].shape}
    for name, leaf in (("q/w", att["q"]["w"]), ("k/w", att["k"]["w"]),
                       ("o/w", att["o"]["w"]), ("up/w", mlp["up"]["w"]),
                       ("down/w", mlp["down"]["w"])):
        out[f"body {name}"] = leaf.shape
    for seg in ("head", "body", "tail"):
        out[f"{seg} cache k"] = eng.cache[seg]["stack"]["pos0"]["k"].shape
    return {k: list(v) for k, v in out.items()}


class AllReduceClock:
    """Counts and times (host clock, the call blocks until done) the
    all-reduces made while `on` is set."""

    def __init__(self, dist):
        self.dist, self.plain = dist, dist.all_reduce
        self.on, self.calls, self.seconds = False, 0, 0.0
        dist.all_reduce = self

    def __call__(self, *a, **kw):
        if not self.on:
            return self.plain(*a, **kw)
        t = time.perf_counter()
        out = self.plain(*a, **kw)
        self.seconds += time.perf_counter() - t
        self.calls += 1
        return out


def tp_round_setup(torch, dev, small):
    """Phase 8's round (ViT-Base at full width and depth, int8 wire, K 4,
    U 2, 64 samples a client, gamma 0.5) on round 0's cohort with client
    0 dropped; `small` (a CPU rehearsal) the reduced ViT on 32 x 32."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import (ProtocolConfig, SFPromptTrainer,
                                  SplitConfig, SplitModel)
    from repro_torch.data import (DATASETS, iid_partition, select_clients,
                                  stack_clients, synthetic_image_dataset)
    from repro_torch.runtime import WireSpec
    cfg = get_config("vit-base")
    hw, n_local, bs, data = 224, 64, 16, "cifar100-syn"
    if small:
        cfg = cfg.reduced(n_layers=4, d_model=64, d_ff=128)
        hw, n_local, bs, data = 32, 8, 4, "cifar10-syn"
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=16,
                        prune_gamma=0.5, local_epochs=2)
    model = SplitModel(cfg, split, WireSpec.make("int8"))
    K = 4
    pcfg = ProtocolConfig(clients_per_round=K, local_epochs=2,
                          split_epochs=1, batch_size=bs, lr_local=0.03,
                          lr_split=0.03, optimizer="sgd", momentum=0.9)
    d = synthetic_image_dataset(DATASETS[data], 8 * n_local, seed=0,
                                image_hw=hw)
    cohort = stack_clients(iid_partition(d, 8, seed=0),
                           select_clients(8, K, seed=0, round_idx=0))
    part = {"transmit": np.array([0, 1, 1, 1], np.float32),
            "aggregate": np.array([0, 1, 1, 1], np.float32)}
    init = SFPromptTrainer(model, pcfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))["params"]
    return model, pcfg, cohort, part, init


TP_ROUNDS = (("data2_clear", "data", False, False),
             ("data2_secure", "data", True, False),
             ("data2_fsdp", "data", False, True),
             ("model2_clear", "model", False, False))


def tp_round(torch, setup, mesh, secure, fsdp, dev):
    """One round from the setup's init; returns the trained tail and
    prompt, the metrics, the kept sets and the seconds."""
    from repro_torch.core import SFPromptTrainer
    from repro_torch.core.aggregation import get_aggregator
    from repro_torch.tree import tree_flatten
    model, pcfg, cohort, part, init = setup
    agg = get_aggregator(secure=True, seed=0) if secure else None
    tr = SFPromptTrainer(model, pcfg, agg, mesh=mesh, fsdp=fsdp, device=dev)
    state = {"params": tr.shard_params(init), "round": 0}
    if dev != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, metrics = tr.round(state, cohort, part)
    if dev != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    trained = {"/".join(p): x.cpu().numpy() for p, x in tree_flatten(
        {"tail": new["params"]["tail"], "prompt": new["params"]["prompt"]})}
    body = [x for _, x in tree_flatten(new["params"]["body"])]
    return {"params": trained, "metrics": metrics, "seconds": seconds,
            "kept": tr.last_kept.cpu().numpy(),
            "body_bytes": sum((x.local if hasattr(x, "local") else x).numel()
                              * 4 for x in body)}


def tp_rank(small, dev):
    """One rank of phase 22: TP serving on (data 1, model 2), then the
    rounds on (data 2) and (model 2), with this rank's launch counts,
    all-reduces and memory."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    if dev != "cpu":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    meshes = {"model": make_host_mesh(TP_RANKS, model=TP_RANKS),
              "data": make_host_mesh(TP_RANKS)}
    clock = AllReduceClock(dist)
    out = {"launches": {}, "all_reduce": {}, "memory_gb": {}}

    def on_run(label, eng):
        import contextlib

        @contextlib.contextmanager
        def measure():
            dispatch = eng._dispatch_decode

            def timed(*a, **kw):
                clock.on = True
                try:
                    return dispatch(*a, **kw)
                finally:
                    clock.on = False
            eng._dispatch_decode = timed
            clock.calls, clock.seconds = 0, 0.0
            if dev != "cpu":
                torch.cuda.reset_peak_memory_stats()
                out["memory_gb"][f"{label}_held"] = (
                    torch.cuda.memory_allocated() / 1e9)
            reset_launches()
            yield
            del eng._dispatch_decode        # the engine can be freed
            out["launches"][label] = launch_counts()
            out["all_reduce"][label] = {"calls": clock.calls,
                                        "seconds": clock.seconds}
            if dev != "cpu":
                out["memory_gb"][f"{label}_peak"] = (
                    torch.cuda.max_memory_allocated() / 1e9)
        return measure()

    out["reduced"] = tp_serve_runs(torch, meshes["model"], dev, True)
    serve = tp_serve_runs(torch, meshes["model"], dev, small, on_run)
    lead = dist.get_rank() == 0
    out["serve"] = serve if lead else {
        k: ({kk: vv for kk, vv in v.items() if kk != "logits"}
            if isinstance(v, dict) and "logits" in v else v)
        for k, v in serve.items()}
    setup = tp_round_setup(torch, dev, small)
    out["rounds"] = {}
    for label, axis, secure, fsdp in TP_ROUNDS:
        reset_launches()
        out["rounds"][label] = tp_round(torch, setup, meshes[axis], secure,
                                        fsdp, dev)
        out["launches"][label] = launch_counts()
    return out


def _agreeing_gap(a, b):
    """(largest logit gap over the rows two runs share a token prefix for,
    the last step's gap or None where their tokens part) of two runs'
    `tokens` and `logits` by request."""
    import numpy as np
    rows, last = 0.0, 0.0
    for rid, lg in b["logits"].items():
        g = a["logits"][rid]
        agree = int(np.argmax(np.concatenate(
            [a["tokens"][rid] != b["tokens"][rid], [True]])))
        n = min(len(lg), agree + 1)
        rows = max(rows, float(np.abs(g[:n] - lg[:n]).max()))
        if last is not None and agree >= len(lg):
            last = max(last, float(np.abs(g[-1] - lg[-1]).max()))
        else:
            last = None
    return rows, last


def tp_compare_serve(ref, ranks, key="serve", strict=False, phase="22"):
    """Against one process: wire bytes `==` on both wires, tokens `==` on
    the fp32 wire, the int8 wire's logit gap (rows while the tokens
    agree) no larger than one process's own int8-vs-fp32 gap; with
    `strict` (the reduced model) the fp32 wire's last-step logits within
    PARITY_TOL. At full width the random-weight stack amplifies a sum in
    another order (~1e-7 relative) by about 1e3, so there the fp32 gap is
    printed beside one process's own gap from a change of batch shape
    (`tp_batch1_gap`), as is the int8 wire's token agreement: a reordered
    sum can cross an int8 rounding edge."""
    import numpy as np
    summary = {}
    for label in ("dense_fp32", "paged_fp32", "dense_int8", "paged_int8"):
        want = ref[label]
        exact = label.endswith("fp32")
        rec = {}
        for r, res in enumerate(ranks):
            got = res[key][label]
            if got["wire"] != want["wire"]:
                fail(f"phase {phase} {key} {label} rank {r}: wire bytes "
                     f"{got['wire']} != one process {want['wire']}")
            same = {rid: bool(np.array_equal(got["tokens"][rid], t))
                    for rid, t in want["tokens"].items()}
            rec[f"rank{r}_requests_with_equal_tokens"] = sum(same.values())
            if exact and not all(same.values()):
                fail(f"phase {phase} {key} {label} rank {r}: tokens differ "
                     f"from one process: {same}")
        rows, last = _agreeing_gap(ranks[0][key][label], want)
        rec.update(last_step_logit_gap=last, logit_gap_while_agreeing=rows,
                   tok_per_s=ranks[0][key][label]["tok_per_s"],
                   one_process_tok_per_s=want["tok_per_s"])
        if strict and exact and not last <= PARITY_TOL:
            fail(f"phase {phase} {key} {label}: last-step logits {last} from "
                 f"one process > {PARITY_TOL}")
        summary[label] = rec
    own = _agreeing_gap(ref["dense_int8"], ref["dense_fp32"])[0]
    for label in ("dense_int8", "paged_int8"):
        # the int8 wire's own error bounds how far its rounding edges may
        # carry a reordered sum
        if summary[label]["logit_gap_while_agreeing"] > own:
            fail(f"phase {phase} {key} {label}: logit gap to one process "
                 f"{summary[label]['logit_gap_while_agreeing']} exceeds "
                 f"the int8 wire's own gap to fp32 {own}")
    summary["one_process_gaps"] = {
        "dense_vs_paged_fp32": _agreeing_gap(ref["dense_fp32"],
                                             ref["paged_fp32"]),
        "dense_vs_paged_int8": _agreeing_gap(ref["dense_int8"],
                                             ref["paged_int8"]),
        "int8_vs_fp32_dense": _agreeing_gap(ref["dense_int8"],
                                            ref["dense_fp32"]),
        "batch1_vs_batch_fp32": ref["batch1_gap"]}
    return summary


def tp_compare_rounds(ref, ranks, K=4):
    """Params within 1e-4 (clear) and roundtrip_tol(K) + 1e-4 (secure) of
    one process; bytes, kept_frac and kept sets equal."""
    import numpy as np
    from repro_torch.privacy.fixed_point import roundtrip_tol
    summary = {}
    for label, _, secure, _ in TP_ROUNDS:
        want = ref["round_secure" if secure else "round_clear"]
        tol = (roundtrip_tol(K) + 1e-4) if secure else 1e-4
        rec = {}
        for r, res in enumerate(ranks):
            got = res["rounds"][label]
            gap = max(float(np.abs(got["params"][k] - v).max())
                      for k, v in want["params"].items())
            if not gap <= tol:
                fail(f"phase 22 {label} rank {r}: params {gap:.3g} from one "
                     f"process > {tol:.3g}")
            for k, v in want["metrics"].items():
                if not np.isfinite(got["metrics"][k]):
                    fail(f"phase 22 {label} rank {r}: {k} not finite")
                if (k.startswith("wire/") or k == "kept_frac") and \
                        got["metrics"][k] != v:
                    fail(f"phase 22 {label} rank {r}: {k} "
                         f"{got['metrics'][k]} != {v}")
            if not np.array_equal(got["kept"], want["kept"]):
                fail(f"phase 22 {label} rank {r}: kept sets differ")
            rec[f"rank{r}_params_gap"] = gap
        rec.update(seconds=ranks[0]["rounds"][label]["seconds"],
                   one_process_seconds=want["seconds"],
                   body_mb_a_rank=ranks[0]["rounds"][label]["body_bytes"]
                   / 1e6)
        summary[label] = rec
    return summary


TP_PATHS = {"dense_int8": "tp_dense", "paged_int8": "tp_paged",
            "dense_fp32": "tp_dense_fp32", "paged_fp32": "tp_paged_fp32",
            "data2_clear": "tp_train_data", "data2_secure": "tp_private",
            "data2_fsdp": "tp_train_fsdp", "model2_clear": "tp_train_model"}


def tensor_parallel(torch, dev="cuda", small=False):
    """Phase 22: the references in this process, then TP_RANKS ranks on
    the card over gloo; returns (launches by path, summary)."""
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.perf_counter()
    ref_reduced = tp_serve_runs(torch, None, dev, True)
    ref = tp_serve_runs(torch, None, dev, small)
    setup = tp_round_setup(torch, dev, small)
    for secure in (False, True):
        ref[f"round_{'secure' if secure else 'clear'}"] = tp_round(
            torch, setup, None, secure, False, dev)
    del setup
    if dev != "cpu":
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = spawn_ranks(tp_rank, TP_RANKS, small, dev, threads=2)
    ranks_s = time.perf_counter() - t0
    summary = {"reduced": tp_compare_serve(ref_reduced, ranks, "reduced",
                                           strict=True),
               "serve": tp_compare_serve(ref, ranks),
               "rounds": tp_compare_rounds(ref, ranks),
               "one_process_s": ref_s, "ranks_s": ranks_s}
    by_path = {}
    for label, path in TP_PATHS.items():
        per_rank = [r["launches"][label] for r in ranks]
        for r, counts in enumerate(per_rank):
            missing = [k for k in PATHS[path] if counts[k] <= 0]
            if missing:
                fail(f"phase 22 {label}: rank {r} never launched {missing}")
        by_path[path] = {k: sum(c[k] for c in per_rank)
                         for k in per_rank[0]}
        summary.setdefault("launches_by_rank", {})[label] = [
            {k: v for k, v in c.items() if v} for c in per_rank]
    ar = ranks[0]["all_reduce"]
    summary["decode_all_reduces"] = {
        label: {"per_decode_step": ar[label]["calls"] / max(
            1, ranks[0]["serve"][label]["decode_steps"]),
                "ms_each": 1e3 * ar[label]["seconds"] / max(
                    1, ar[label]["calls"])}
        for label in ar}
    summary["shapes"] = ranks[0]["serve"]["shapes"]
    summary["memory_gb_by_rank"] = [r["memory_gb"] for r in ranks]
    summary["note"] = ("the ranks share one card and their all-reduces "
                       "go through host memory (gloo): these rates are "
                       "not a tensor-parallel speed")
    say("phase 22 tensor-parallel: " + json.dumps(summary, sort_keys=True,
                                                   default=str))
    return by_path, summary


# ---------------------------------------------------------------- phase 23
# the families slice H part 2 brought to the mesh: (path, arch) served at
# published widths on (data 1, model 2), and the rounds
TP2_SERVE = (("tp2_moe", MOE_ARCHS[0]), ("tp2_mla", MOE_ARCHS[1]),
             ("tp2_hybrid", "zamba2-2.7b"), ("tp2_rwkv", "rwkv6-3b"))
TP2_ROUNDS = (("tp2_whisper", G2_ARCHS[0]), ("tp2_vlm", G2_ARCHS[1]))
TP2_INT8_REQUESTS = 2      # the int8 wire's run: the trace's first two
TP2_VLM_VOCAB = 32768      # qwen2-vl-72b's round: see `tp2_round_cfg`


def tp2_shapes(torch, F, gen, results):
    """The kernels at a rank's shapes on 'model' 2 of phase 23's families,
    under "tp" in each record: the Mamba-2 scan at zamba2-2.7b's 40 of 80
    heads (decode (8, 1) and prefill (1, 132)), the RWKV-6 scan at
    rwkv6-3b's 20 of 40 heads (the same), and deepseek-v3's MLA at 64 of
    its 128 heads (q/k 192, v 128, G 1): the dense decode kernel over 8
    slots of 512 and the prefill kernel at (1, 132), causal."""
    from repro_torch.kernels.mamba2_scan import ref as mref
    from repro_torch.kernels.mamba2_scan.kernel import mamba2_fwd
    from repro_torch.kernels.rwkv6_scan import ref as rref
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_fwd
    scans = (
        ("mamba2_scan", "zamba2-2.7b 40 heads", 40,
         lambda B, T: mamba2_case(torch, gen, B, T, 40, 64, 64, 1, True),
         mamba2_fwd, mref.mamba2_scan,
         lambda B, T: mamba2_bound(B, T, 40, 64, 64, 1)[1]),
        ("rwkv6_scan", "rwkv6-3b 20 heads", 20,
         lambda B, T: rwkv6_case(torch, gen, B, T, 20, 64),
         rwkv6_fwd, rref.rwkv6_scan,
         lambda B, T: bound(rwkv6_bytes(B, T, 20, 64),
                            B * T * 20 * (5 * 64 * 64 + 5 * 64))))
    for name, label, H, make, kernel, plain, bnd in scans:
        rec = results[name].setdefault("tp", {})
        for case, (B, T) in (("decode", (8, 1)), ("prefill", (1, 132))):
            args = make(B, T)
            ry, rs = plain(*args)
            y, s = kernel(*args)
            err = max(_scan_err(torch, y, ry), _scan_err(torch, s, rs))
            if not err <= SCAN_TOL:
                fail(f"{name} {label} {case}: max|kernel - plain|/(1 + "
                     f"|plain|) = {err:.3g} > {SCAN_TOL}")
            per = sum(a.numel() * a.element_size() for a in args
                      if a is not None)
            sets = [make(B, T) for _ in range(n_copies(per))]
            fns = [lambda s=s: kernel(*s, state_out=s[5]) for s in sets]
            t_k, d_k = time_ms(fns), device_ms(fns)
            t_p = time_ms([lambda s=s: plain(*s) for s in sets], iters=5)
            b = bnd(B, T)
            del sets, fns
            rec[f"{label} {case}"] = dict(
                shape=f"({B}, {T}, {H}, 64)", max_abs_err=err, ms=t_k,
                device_ms=d_k, plain_ms=t_p, library_ms=None,
                bound_ms=b[0], bound_by=b[1])
            say(f"{name} {label} {case} ({B}, {T}, {H}, 64): scaled err "
                f"{err:.3g}; kernel {t_k:.4f} ms ({d_k:.4f} on the device), "
                f"plain {t_p:.4f} ms, bound {b[0]:.5f} ms ({b[1]})")
        results[name]["max_abs_err"] = max(
            results[name]["max_abs_err"],
            *(r["max_abs_err"] for r in rec.values()))
    dec = results["decode_attention"]["tp"]
    dec["deepseek-v3 MLA 64 heads 192 / 128"] = decode_record(
        torch, F, gen, 64, 64, 192, sweep=False, Dv=128)
    pre = results["flash_attention_prefill"]["tp"]
    pre["deepseek-v3 MLA 64 heads 192 / 128"] = prefill_shape(
        torch, F, gen, "deepseek-v3 MLA a rank of 2", 1, 64, 192, True,
        (37, 132), Dv=128)
    for name in ("decode_attention", "flash_attention_prefill"):
        results[name]["max_abs_err"] = max(
            results[name]["max_abs_err"],
            *(r["max_abs_err"] for r in results[name]["tp"].values()))


def tp2_serve_cfg(arch):
    """Phase 23's served configs at published widths: phase 20's MoE
    configs; zamba2-2.7b at 18 layers (3 cycles of its 6: 1 head / 1 body
    / 1 tail, the fewest a split takes); rwkv6-3b at phase 11's 3."""
    from repro_torch.configs import get_config
    if arch in MOE_ARCHS:
        return moe_full_cfg(arch)
    base = get_config(arch)
    n = {"zamba2-2.7b": 18, "rwkv6-3b": 3}[arch]
    return dataclasses.replace(base, n_layers=n), {
        "n_layers": f"{base.n_layers} -> {n}"}


def tp2_round_cfg(arch, vocab=TP2_VLM_VOCAB):
    """Phase 23's round configs: whisper-base whole; qwen2-vl-72b at its
    published block widths (d_model 8192, 64 / 8 heads of 128, d_ff
    29568, M-RoPE 16/24/24, QKV bias) cut to 3 layers (1 head / 1 body /
    1 tail) and a vocabulary of `vocab`: each of the two ranks on the one
    card holds the whole trainable tail (a layer and the LM head), and
    at its published 152064 rows the two ranks' rounds do not fit the
    card (tools/tp2_vlm_memory.py measures them there)."""
    from repro_torch.configs import get_config
    base = get_config(arch)
    if arch == "whisper-base":
        return base, {}
    cuts = {"n_layers": f"{base.n_layers} -> 3"}
    if vocab != base.vocab_size:
        cuts["vocab_size"] = f"{base.vocab_size} -> {vocab}"
    return dataclasses.replace(base, n_layers=3, vocab_size=vocab), cuts


def tp2_leaf(torch, path, shape, dev):
    """One leaf of phase 23's weights, of the kind `SplitModel.init` gives
    it: ones for norm scales and Mamba-2's D, zeros for biases and
    placeholders, Mamba-2's decay and dt bias as `init_mamba2` sets them,
    else 0.02 times a normal draw from a generator seeded by the leaf's
    path, so a rank can draw one leaf alone."""
    import zlib
    name = path[-1]
    if name in ("scale", "D"):
        return torch.ones(shape, device=dev)
    if name in ("bias", "b", "conv_b", "w0", "_"):
        return torch.zeros(shape, device=dev)
    if name == "A_log":
        return torch.log(torch.linspace(1.0, 16.0, shape[-1], device=dev)
                         ).expand(shape).contiguous()
    if name == "dt_bias":
        return torch.full(shape, math.log(math.expm1(0.01)), device=dev)
    gen = torch.Generator(device=dev).manual_seed(
        zlib.crc32("/".join(path).encode()))
    return torch.randn(shape, generator=gen, device=dev).mul_(0.02)


def tp2_build(torch, model, dev, mesh=None):
    """Phase 23's frozen head and body and a bank of TP_TENANTS tenants,
    drawn leaf by leaf (`tp2_leaf`): on `mesh` each frozen leaf is drawn
    whole, cut to this rank's block and freed before the next, so no rank
    ever holds a whole copy of the frozen weights; tenant t's tail and
    prompt are the drawn ones plus 0.05 times a normal draw (tenant 0:
    none)."""
    from repro_torch.serve import TenantBank
    from repro_torch.sharding import params_pspecs, parallel
    from repro_torch.sharding.rules import pop_sharding_fallbacks
    from repro_torch.tree import tree_map_with_path
    whole = model.init(torch.Generator(), device="meta")
    specs = params_pspecs(whole, mesh) if mesh is not None else None
    pop_sharding_fallbacks()

    def spec_of(path):
        node = specs
        for k in path:
            node = node[k]
        return node

    def frozen(path, leaf):
        x = tp2_leaf(torch, path, tuple(leaf.shape), dev)
        if mesh is None or all(e is None for e in spec_of(path)):
            return x
        return parallel.local_shard(x, spec_of(path), mesh).clone()

    def tenants(path, leaf):
        # written tenant by tenant into one buffer: at a vocabulary head a
        # whole copy a tenant is GBs
        out = torch.empty((TP_TENANTS,) + tuple(leaf.shape), device=dev)
        out[0] = tp2_leaf(torch, path, tuple(leaf.shape), dev)
        for t in range(1, TP_TENANTS):
            g = torch.Generator(device=dev).manual_seed(101 + t)
            out[t] = out[0]
            out[t] += torch.randn(leaf.shape, generator=g,
                                  device=dev).mul_(0.05)
        return out

    shared = {seg: tree_map_with_path(
        lambda p, leaf, seg=seg: frozen((seg,) + p, leaf), whole[seg])
        for seg in ("head", "body")}
    bank = TenantBank(
        tree_map_with_path(lambda p, leaf: tenants(("tail",) + p, leaf),
                           whole["tail"]),
        tenants(("prompt",), whole["prompt"]))
    return shared, bank


def tp2_serve_model(torch, arch, mesh, dev, on_run=None, small=False):
    """One family served: the fp32 wire over phase 22's trace (after one
    warm request) and the int8 wire over its first TP2_INT8_REQUESTS, on
    `mesh` (None: one process, which also teacher-forces each request
    alone for its batch-1 gap). Returns tokens, logits, bytes, tok/s,
    decode steps and MoE host syncs a run, and the local shapes of a few
    leaves and caches. `small` (a CPU rehearsal): the family reduced to
    d_model 64, vocab 128."""
    import numpy as np
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.models import layers
    from repro_torch.runtime import WireSpec
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg, cuts = tp2_serve_cfg(arch)
    if small:
        cfg = cfg.reduced(n_layers=3 * len(cfg.layer_pattern), d_model=64,
                          d_ff=128, vocab_size=128)
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=4)
    models = {w: SplitModel(cfg, split, WireSpec.make(w))
              for w in ("fp32", "int8")}
    t0 = time.perf_counter()
    shared, bank = tp2_build(torch, models["fp32"], dev, mesh)
    if dev != "cpu":
        torch.cuda.empty_cache()        # the whole leaves drawn and cut
    reqs = tp_trace(cfg)
    out = {"cuts": cuts, "build_s": time.perf_counter() - t0}
    for wire, trace in (("fp32", reqs), ("int8", reqs[:TP2_INT8_REQUESTS])):
        eng = ServeEngine(models[wire], shared, bank,
                          ServeConfig(**TP_SERVE_CFG), collect_logits=True,
                          mesh=mesh, device=dev)
        if wire == "fp32":
            eng.run(tp_trace(cfg)[:1])          # warm: handles, caches
            eng.reset_stats()
        margins, syncs = [], layers.moe_host_syncs
        ctx = on_run(wire, eng) if on_run else None
        if ctx is not None:
            ctx.__enter__()
        with router_margins(margins):
            stats = eng.run(list(trace))
        if dev != "cpu":
            torch.cuda.synchronize()
        if ctx is not None:
            ctx.__exit__(None, None, None)
        if stats["n_finished"] != len(trace):
            fail(f"phase 23 {arch} {wire}: {stats['n_finished']} of "
                 f"{len(trace)} requests finished")
        out[wire] = {
            "tokens": {f.req.rid: np.asarray(f.tokens)
                       for f in stats["finished"]},
            "logits": {f.req.rid: np.asarray(f.logits)
                       for f in stats["finished"]},
            "wire": stats["wire_bytes"], "tok_per_s": stats["tok_per_s"],
            "decode_steps": stats["decode_steps"],
            "router_margin": min(margins, default=None),
            "moe_host_syncs_a_decode_step": (layers.moe_host_syncs - syncs)
            / max(1, stats["decode_steps"])}
        if wire == "fp32" and mesh is not None:
            out["shapes"] = tp2_shard_shapes(eng)
        if wire == "fp32" and mesh is None:
            out["batch1_gap"] = tp_batch1_gap(
                torch, models[wire], shared, bank, reqs, out[wire], dev)
        del eng
    del shared, bank
    if dev != "cpu":
        torch.cuda.empty_cache()
    return out


def tp2_shard_shapes(eng):
    """The local shapes of an engine's first body layer's frozen leaves
    and of its body and tail caches' leaves."""
    from repro_torch.tree import tree_flatten
    pos0 = eng.shared["body"]["stack"]["pos0"]
    out = {"body " + "/".join(p): list(x.shape)
           for p, x in tree_flatten(pos0) if x.dim() >= 2}
    for seg in ("body", "tail"):
        for p, x in tree_flatten(eng.cache[seg]["stack"]["pos0"]):
            out[f"{seg} cache {'/'.join(p)}"] = list(x.shape)
    return out


def tp2_round_setup(torch, arch, dev, small, wire="int8",
                    vocab=TP2_VLM_VOCAB):
    """Phase 23's round: the `wire`, K 2 (qwen2-vl-72b: 1) clients of 16
    samples of 16 tokens with the family's keys (8 patch embeddings on a
    (2, 2, 2) grid), batch 4, U 1, gamma 0.5, SGD without momentum;
    qwen2-vl-72b's vocabulary `vocab`; `small` (a CPU rehearsal) the
    family reduced to d_model 64."""
    import numpy as np
    from repro_torch.core import (ProtocolConfig, SFPromptTrainer,
                                  SplitConfig, SplitModel)
    from repro_torch.data import (iid_partition, select_clients,
                                  stack_clients, synthetic_lm_dataset)
    from repro_torch.runtime import WireSpec
    cfg, cuts = tp2_round_cfg(arch, vocab)
    if small:
        cfg = cfg.reduced(n_layers=3, d_model=64, d_ff=128, vocab_size=128)
    K = 2 if arch == "whisper-base" else 1
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=4,
                        prune_gamma=0.5, local_epochs=1)
    model = SplitModel(cfg, split, WireSpec.make(wire))
    pcfg = ProtocolConfig(clients_per_round=K, local_epochs=1,
                          split_epochs=1, batch_size=4, lr_local=0.03,
                          lr_split=0.03, optimizer="sgd", momentum=0.0)
    n = 16 * 2
    data = synthetic_lm_dataset(n, 16, cfg.vocab_size, seed=0)
    data.update(g2_extras(np, cfg, np.random.default_rng(0), n))
    cohort = stack_clients(iid_partition(data, 2, seed=0),
                           select_clients(2, K, seed=0, round_idx=0))
    init = SFPromptTrainer(model, pcfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))["params"]
    return model, pcfg, cohort, init, cuts


def tp2_round(torch, setup, mesh, dev):
    """One round from the setup's init on `mesh` (which takes the init's
    whole frozen head and body, leaving it its shards): trained tail and
    prompt, metrics, kept sets, seconds."""
    from repro_torch.core import SFPromptTrainer
    from repro_torch.tree import tree_flatten
    model, pcfg, cohort, init, _ = setup
    tr = SFPromptTrainer(model, pcfg, mesh=mesh, device=dev)
    state = {"params": tr.shard_params(init), "round": 0}
    if mesh is not None:
        # the rank keeps its shards only: the whole frozen weights go
        del init["head"], init["body"]
    if dev != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, metrics = tr.round(state, cohort)
    if dev != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    trained = {"/".join(p): x.cpu().numpy() for p, x in tree_flatten(
        {"tail": new["params"]["tail"], "prompt": new["params"]["prompt"]})}
    return {"params": trained, "metrics": metrics, "seconds": seconds,
            "kept": tr.last_kept.cpu().numpy()}


def tp2_rank(small, dev):
    """One rank of phase 23: the four families served on (data 1, model
    2), then the two rounds, with this rank's launches, all-reduces and
    memory."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    if dev != "cpu":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = make_host_mesh(TP_RANKS, model=TP_RANKS)
    clock = AllReduceClock(dist)
    out = {"launches": {}, "all_reduce": {}, "memory_gb": {}, "serve": {},
           "rounds": {}}
    for path, arch in TP2_SERVE:
        def on_run(wire, eng, path=path):
            import contextlib
            label = path if wire == "int8" else f"{path}_fp32"

            @contextlib.contextmanager
            def measure():
                dispatch = eng._dispatch_decode

                def timed(*a, **kw):
                    clock.on = True
                    try:
                        return dispatch(*a, **kw)
                    finally:
                        clock.on = False
                eng._dispatch_decode = timed
                clock.calls, clock.seconds = 0, 0.0
                # both ranks past their builds: the card's use read after
                # every whole leaf drawn for a cut is freed
                dist.barrier()
                if dev != "cpu":
                    torch.cuda.reset_peak_memory_stats()
                    free, total = torch.cuda.mem_get_info()
                    out["memory_gb"][f"{label}_held"] = (
                        torch.cuda.memory_allocated() / 1e9)
                    out["memory_gb"][f"{label}_card_used"] = (
                        (total - free) / 1e9)
                reset_launches()
                yield
                del eng._dispatch_decode
                out["launches"][label] = launch_counts()
                out["all_reduce"][label] = {"calls": clock.calls,
                                            "seconds": clock.seconds}
                if dev != "cpu":
                    out["memory_gb"][f"{label}_peak"] = (
                        torch.cuda.max_memory_allocated() / 1e9)
            return measure()
        res = tp2_serve_model(torch, arch, mesh, dev, on_run, small)
        if dist.get_rank():
            for wire in ("fp32", "int8"):
                res[wire].pop("logits")
        out["serve"][path] = res
    for path, arch in TP2_ROUNDS:
        for wire in ("fp32", "int8"):
            label = path if wire == "int8" else f"{path}_fp32"
            setup = tp2_round_setup(torch, arch, dev, small, wire)
            dist.barrier()
            if dev != "cpu":
                torch.cuda.reset_peak_memory_stats()
            reset_launches()
            out["rounds"][label] = tp2_round(torch, setup, mesh, dev)
            out["launches"][label] = launch_counts()
            if dev != "cpu":
                out["memory_gb"][f"{label}_peak"] = (
                    torch.cuda.max_memory_allocated() / 1e9)
            del setup
            if dev != "cpu":
                torch.cuda.empty_cache()
    return out


def tp2_compare_serve(path, ref, ranks):
    """Against one process: tokens and bytes `==` on the fp32 wire, bytes
    `==` on the int8 wire; the fp32 last-step logit gap printed beside
    one process's batch-1 gap, the int8 wire's token agreement printed."""
    import numpy as np
    rec = {}
    for wire in ("fp32", "int8"):
        want = ref[wire]
        for r, res in enumerate(ranks):
            got = res["serve"][path][wire]
            if got["wire"] != want["wire"]:
                fail(f"phase 23 {path} {wire} rank {r}: wire bytes "
                     f"{got['wire']} != one process {want['wire']}")
            same = {rid: bool(np.array_equal(got["tokens"][rid], t))
                    for rid, t in want["tokens"].items()}
            if wire == "fp32" and not all(same.values()):
                fail(f"phase 23 {path} fp32 rank {r}: tokens differ from "
                     f"one process: {same}; router margin {got['router_margin']}"
                     f" on the rank, {want['router_margin']} in one process "
                     f"(a near tie routes a token to another expert)")
            rec[f"{wire}_rank{r}_requests_with_equal_tokens"] = sum(
                same.values())
        rows, last = _agreeing_gap(ranks[0]["serve"][path][wire], want)
        got0 = ranks[0]["serve"][path][wire]
        rec[wire] = dict(
            last_step_logit_gap=last, logit_gap_while_agreeing=rows,
            tok_per_s=got0["tok_per_s"], one_process_tok_per_s=want[
                "tok_per_s"], router_margin=got0["router_margin"],
            one_process_router_margin=want["router_margin"],
            moe_host_syncs_a_decode_step=got0[
                "moe_host_syncs_a_decode_step"])
    rec["one_process_batch1_gap"] = ref["batch1_gap"]
    rec["cuts"] = ref["cuts"]
    rec["shapes_rank0"] = ranks[0]["serve"][path]["shapes"]
    return rec


def _params_gap(a, b):
    import numpy as np
    return max(float(np.abs(a[k] - v).max()) for k, v in b.items())


def tp2_compare_round(path, ref, ranks):
    """Against one process on each wire: bytes, kept_frac and kept sets
    `==` and every metric finite. On the fp32 wire the params within
    PARITY_TOL and every other metric within PARITY_TOL (1 + |metric|);
    on the int8 wire, where a sum in another order can carry a value
    across a rounding edge, the params gap is printed, beside one
    process's own int8-vs-fp32 gap, and not held."""
    import numpy as np
    rec = {"one_process_int8_vs_fp32_params_gap": _params_gap(
        ref["int8"]["params"], ref["fp32"]["params"])}
    for wire in ("fp32", "int8"):
        label = path if wire == "int8" else f"{path}_fp32"
        want = ref[wire]
        for r, res in enumerate(ranks):
            got = res["rounds"][label]
            gap = _params_gap(got["params"], want["params"])
            if wire == "fp32" and not gap <= PARITY_TOL:
                fail(f"phase 23 {label} rank {r}: params {gap:.3g} from one "
                     f"process > {PARITY_TOL}")
            for k, v in want["metrics"].items():
                g = got["metrics"][k]
                if not np.isfinite(g):
                    fail(f"phase 23 {label} rank {r}: {k} not finite")
                exact = k.startswith("wire/") or k == "kept_frac"
                if (exact and g != v) or (
                        wire == "fp32" and not exact
                        and not abs(g - v) <= PARITY_TOL * (1 + abs(v))):
                    fail(f"phase 23 {label} rank {r}: {k} {g} != {v}")
            if not np.array_equal(got["kept"], want["kept"]):
                fail(f"phase 23 {label} rank {r}: kept sets differ")
            rec[f"{wire}_rank{r}_params_gap"] = gap
        rec[wire] = dict(seconds=ranks[0]["rounds"][label]["seconds"],
                         one_process_seconds=want["seconds"])
    rec["cuts"] = ref["int8"]["cuts"]
    return rec


def tensor_parallel_families(torch, dev="cuda", small=False):
    """Phase 23: the references in this process (each model freed before
    the next loads, the last before the ranks start), then TP_RANKS ranks
    on the card over gloo; returns (launches by path, summary). `small`
    (a CPU rehearsal) runs every family reduced."""
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.perf_counter()
    ref = {"serve": {}, "rounds": {}}
    for path, arch in TP2_SERVE:
        ref["serve"][path] = tp2_serve_model(torch, arch, None, dev,
                                             small=small)
    for path, arch in TP2_ROUNDS:
        runs = {}
        for wire in ("fp32", "int8"):
            setup = tp2_round_setup(torch, arch, dev, small, wire)
            runs[wire] = dict(tp2_round(torch, setup, None, dev),
                              cuts=setup[4])
            del setup
            if dev != "cpu":
                torch.cuda.empty_cache()
        ref["rounds"][path] = runs
    ref_s = time.perf_counter() - t0
    parent = {}
    if dev != "cpu":
        # what this process still holds on the card while the ranks run
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        parent = {"held_gb": torch.cuda.memory_allocated() / 1e9,
                  "reserved_gb": torch.cuda.memory_reserved() / 1e9,
                  "card_used_gb": (total - free) / 1e9}
    t0 = time.perf_counter()
    ranks = spawn_ranks(tp2_rank, TP_RANKS, small, dev, threads=2)
    summary = {"one_process_s": ref_s, "ranks_s": time.perf_counter() - t0,
               "parent_before_ranks": parent, "serve": {}, "rounds": {}}
    for path, _ in TP2_SERVE:
        summary["serve"][path] = tp2_compare_serve(
            path, ref["serve"][path], ranks)
    for path, _ in TP2_ROUNDS:
        summary["rounds"][path] = tp2_compare_round(
            path, ref["rounds"][path], ranks)
    by_path = {}
    labels = [p for s, _ in TP2_SERVE + TP2_ROUNDS
              for p in (s, f"{s}_fp32")]
    for label in labels:
        per_rank = [r["launches"][label] for r in ranks]
        for r, counts in enumerate(per_rank):
            missing = [k for k in PATHS[label] if counts[k] <= 0]
            if missing:
                fail(f"phase 23 {label}: rank {r} never launched {missing}")
        by_path[label] = {k: sum(c[k] for c in per_rank)
                          for k in per_rank[0]}
        summary.setdefault("launches_by_rank", {})[label] = [
            {k: v for k, v in c.items() if v} for c in per_rank]
    ar = ranks[0]["all_reduce"]
    summary["decode_all_reduces"] = {
        label: {"per_decode_step": ar[label]["calls"] / max(
            1, ranks[0]["serve"][label.replace("_fp32", "")][
                "fp32" if label.endswith("_fp32") else "int8"][
                "decode_steps"]),
                "ms_each": 1e3 * ar[label]["seconds"] / max(
                    1, ar[label]["calls"])}
        for label in ar}
    summary["memory_gb_by_rank"] = [r["memory_gb"] for r in ranks]
    summary["note"] = ("the ranks share one card and their all-reduces "
                       "go through host memory (gloo): these rates are "
                       "not a tensor-parallel speed")
    say("phase 23 tensor-parallel families: " + json.dumps(
        summary, sort_keys=True, default=str))
    return by_path, summary


# ---------------------------------------------------------------- phase 24
# Qwen2.5-14B (phase 22's widths, 3 layers, phase 22's trace and engines)
# served with slots over 'data': (label, ranks, 'model' size). The ranks
# draw their weights leaf by leaf as phase 23's (`tp2_build`), so none
# holds a whole copy of the frozen head and body.
DATA_MESHES = (("d2m2", 4, 2), ("d2", 2, 1))
DATA_RANKS = 4


def data_shapes(torch, F, gen, results):
    """The kernels at a rank's shapes in phase 24, under "data" in each
    record: the dense decode kernel over a rank's block of TP_SERVE_CFG's
    slots (4 / 'data' 2 = 2 slots of 256, lengths 97 and 180) at Qwen's
    kv heads over 'model' 2 (20 / 4 x 128) and whole (40 / 8 x 128), and
    the int8 pair on those 2 rows of 5120. Prefill runs replicated and the
    paged pool is replicated over 'data', so kernels 3 and 5 run at phase
    22's and phase 3's shapes (held there)."""
    from repro_torch.kernels.quant import ref
    from repro_torch.kernels.quant.kernel import dequantize_fwd, quantize_fwd
    rows = TP_SERVE_CFG["n_slots"] // 2
    W = TP_SERVE_CFG["max_seq"]
    dec = results["decode_attention"].setdefault("data", {})
    for label, Hq, Hkv in (("20 / 4 x 128", 20, 4), ("40 / 8 x 128", 40, 8)):
        dec[f"qwen2.5-14b {label}, {rows} slots of {W}"] = decode_record(
            torch, F, gen, Hq, Hkv, 128, sweep=False, lengths=[97, 180],
            W=W)
    D = 5120
    xs = [torch.randn((rows, D), generator=gen, device="cuda") * 3.0
          for _ in range(n_copies(rows * D * 9))]
    v, sc = quantize_fwd(xs[0], 0.5)
    rv, rs = ref.quantize(xs[0], 0.5)
    if not (torch.equal(v, rv) and torch.equal(sc, rs) and torch.equal(
            dequantize_fwd(v, sc), ref.dequantize(v, sc))):
        fail(f"quant pair at a rank's ({rows}, {D}) differs from plain")
    pays = [quantize_fwd(x, 0.5) for x in xs]
    cases = {"quantize": [lambda x=x: quantize_fwd(x, 0.5) for x in xs],
             "dequantize": [lambda p=p: dequantize_fwd(*p) for p in pays],
             "torch.mul": [lambda p=p: torch.mul(*p) for p in pays]}
    dev = device_ms_cases(cases)
    plain = {"quantize": time_ms([lambda x=x: ref.quantize(x, 0.5)
                                  for x in xs]),
             "dequantize": time_ms([lambda p=p: ref.dequantize(*p)
                                    for p in pays])}
    for name, key, nbytes, flops in (
            ("quantize_int8", "quantize", rows * D * 5 + rows * 4,
             4 * rows * D),
            ("dequantize_int8", "dequantize", rows * D * 5 + rows * 4,
             rows * D)):
        b = bound(nbytes, flops)
        rec = dict(max_abs_err=0.0, ms=time_ms(cases[key]),
                   device_ms=dev[key], plain_ms=plain[key], bound_ms=b[0],
                   bound_by=b[1], library_ms=None,
                   shape=f"({rows}, {D}) f32, u 0.5")
        if key == "dequantize":
            rec["library_ms"] = time_ms(cases["torch.mul"])
            rec["library_device_ms"] = dev["torch.mul"]
        results[name].setdefault("data", {})[f"a rank's {rows} rows"] = rec
        say(f"{key} at a rank's ({rows}, {D}): {rec['ms']:.4f} ms "
            f"({rec['device_ms']:.4f} on the device), plain "
            f"{rec['plain_ms']:.4f} ms, bound {b[0]:.6f} ms ({b[1]})")
    results["decode_attention"]["max_abs_err"] = max(
        results["decode_attention"]["max_abs_err"],
        *(r["max_abs_err"] for r in dec.values()))


def data_serve_runs(torch, mesh, dev, small, on_run=None, turns=False):
    """Phase 22's four runs (dense then paged, fp32 wire then int8, each
    after one warm request) of phase 22's model on `mesh` (None: one
    process), with phase 23's leaf-by-leaf weights; returns per run the
    tokens, logits, bytes, tok/s and decode steps, and (dense, on a mesh)
    the rank's slot block and cache slot axis. `small`: the model reduced
    as phase 22's (3 layers, d_model 128, vocab 128). `turns`: the ranks
    of the whole group build their weights one after another, so only
    one holds a build's whole leaves at a time."""
    import torch.distributed as dist
    import dataclasses as dc
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.runtime import WireSpec
    cfg = get_config("qwen2.5-14b")
    cfg = (cfg.reduced(n_layers=3, d_model=128, d_ff=256, vocab_size=128)
           if small else dc.replace(cfg, n_layers=3))
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=4)
    models = {w: SplitModel(cfg, split, WireSpec.make(w))
              for w in ("fp32", "int8")}
    for r in range(dist.get_world_size() if turns else 1):
        if not turns or r == dist.get_rank():
            shared, bank = tp2_build(torch, models["fp32"], dev, mesh)
            if dev != "cpu":
                torch.cuda.empty_cache()    # the whole leaves drawn, cut
        if turns:
            dist.barrier()
    reqs = tp_trace(cfg)
    out = {}
    for wire in ("fp32", "int8"):
        for kind in ("dense", "paged"):
            label = f"{kind}_{wire}"
            eng = tp_engine(torch, kind, models[wire], shared, bank, mesh,
                            dev)
            eng.run(tp_trace(cfg)[:1])          # warm: handles, pools
            eng.reset_stats()
            ctx = on_run(label, eng) if on_run else None
            if ctx is not None:
                ctx.__enter__()
            stats = eng.run(list(reqs))
            if dev != "cpu":
                torch.cuda.synchronize()
            if ctx is not None:
                ctx.__exit__(None, None, None)
            if stats["n_finished"] != len(reqs):
                fail(f"phase 24 {label}: {stats['n_finished']} of "
                     f"{len(reqs)} requests finished")
            out[label] = {
                "tokens": {f.req.rid: np.asarray(f.tokens)
                           for f in stats["finished"]},
                "logits": {f.req.rid: np.asarray(f.logits)
                           for f in stats["finished"]},
                "wire": stats["wire_bytes"], "tok_per_s": stats["tok_per_s"],
                "decode_steps": stats["decode_steps"]}
            if kind == "dense" and mesh is not None:
                k = eng.cache["body"]["stack"]["pos0"]["k"]
                out[f"{label}_slots"] = {"block": list(eng.slots),
                                         "cache_k": list(k.shape)}
            if label == "dense_fp32" and mesh is None:
                out["batch1_gap"] = tp_batch1_gap(torch, models[wire],
                                                  shared, bank, reqs,
                                                  out[label], dev)
            del eng
            if dev != "cpu":
                torch.cuda.empty_cache()
    del shared, bank
    if dev != "cpu":
        torch.cuda.empty_cache()
    return out


def data_rank(small, dev):
    """One rank of phase 24: the reduced model, then phase 22's model, on
    each mesh of DATA_MESHES that holds this rank (the others wait), with
    its launches, all-reduces a decode step and memory."""
    import contextlib
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    if dev != "cpu":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    clock = AllReduceClock(dist)
    out = {}
    for mesh_label, n, tp in DATA_MESHES:
        mesh = make_host_mesh(n, model=tp)
        if dist.get_rank() >= n:
            continue
        rec = {"launches": {}, "all_reduce": {}, "memory_gb": {}}

        def on_run(label, eng, rec=rec):
            @contextlib.contextmanager
            def measure():
                dispatch = eng._dispatch_decode

                def timed(*a, **kw):
                    clock.on = True
                    try:
                        return dispatch(*a, **kw)
                    finally:
                        clock.on = False
                eng._dispatch_decode = timed
                clock.calls, clock.seconds = 0, 0.0
                if dev != "cpu":
                    torch.cuda.reset_peak_memory_stats()
                    free, total = torch.cuda.mem_get_info()
                    rec["memory_gb"][f"{label}_held"] = (
                        torch.cuda.memory_allocated() / 1e9)
                    rec["memory_gb"][f"{label}_card_used"] = (
                        (total - free) / 1e9)
                reset_launches()
                yield
                del eng._dispatch_decode
                rec["launches"][label] = launch_counts()
                rec["all_reduce"][label] = {"calls": clock.calls,
                                            "seconds": clock.seconds}
                if dev != "cpu":
                    rec["memory_gb"][f"{label}_peak"] = (
                        torch.cuda.max_memory_allocated() / 1e9)
            return measure()

        rec["reduced"] = data_serve_runs(torch, mesh, dev, True)
        serve = data_serve_runs(torch, mesh, dev, small, on_run,
                                turns=n == dist.get_world_size())
        if dist.get_rank():
            for v in serve.values():
                if isinstance(v, dict):
                    v.pop("logits", None)
        rec["serve"] = serve
        out[mesh_label] = rec
    return out


def data_parallel(torch, dev="cuda", small=False):
    """Phase 24: the references in this process, then DATA_RANKS ranks on
    the card over gloo serving on each mesh of DATA_MESHES; held as phase
    22 holds its ranks (`tp_compare_serve`: bytes `==`, fp32 tokens `==`,
    the reduced model's fp32 logits within PARITY_TOL, the int8 gap within
    one process's own); returns (launches by path, summary)."""
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.perf_counter()
    ref_reduced = data_serve_runs(torch, None, dev, True)
    ref = data_serve_runs(torch, None, dev, small)
    ref_s = time.perf_counter() - t0
    parent = {}
    if dev != "cpu":
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        parent = {"held_gb": torch.cuda.memory_allocated() / 1e9,
                  "card_used_gb": (total - free) / 1e9}
    t0 = time.perf_counter()
    ranks = spawn_ranks(data_rank, DATA_RANKS, small, dev, threads=2)
    summary = {"one_process_s": ref_s, "ranks_s": time.perf_counter() - t0,
               "parent_before_ranks": parent}
    by_path = {}
    for mesh_label, n, tp in DATA_MESHES:
        sub = [r[mesh_label] for r in ranks[:n]]
        rec = {"reduced": tp_compare_serve(ref_reduced, sub, "reduced",
                                           strict=True, phase="24"),
               "serve": tp_compare_serve(ref, sub, phase="24")}
        rec["slots"] = [r["serve"].get("dense_int8_slots") for r in sub]
        for r, got in enumerate(rec["slots"]):
            d, block = r // tp, TP_SERVE_CFG["n_slots"] // (n // tp)
            if got["block"] != [d * block, (d + 1) * block] or \
                    got["cache_k"][1] != block:
                fail(f"phase 24 {mesh_label} rank {r}: slots {got}, not "
                     f"block {d} of {block}")
        for label in ("dense_int8", "paged_int8", "dense_fp32",
                      "paged_fp32"):
            path = f"data_{mesh_label}_{label}".replace("_int8", "")
            per_rank = [x["launches"][label] for x in sub]
            for r, counts in enumerate(per_rank):
                missing = [k for k in PATHS[path] if counts[k] <= 0]
                if missing:
                    fail(f"phase 24 {path}: rank {r} never launched "
                         f"{missing}")
            by_path[path] = {k: sum(c[k] for c in per_rank)
                             for k in per_rank[0]}
            rec.setdefault("launches_by_rank", {})[label] = [
                {k: v for k, v in c.items() if v} for c in per_rank]
        ar = sub[0]["all_reduce"]
        rec["decode_all_reduces"] = {
            label: {"per_decode_step": ar[label]["calls"] / max(
                1, sub[0]["serve"][label]["decode_steps"]),
                    "ms_each": 1e3 * ar[label]["seconds"] / max(
                        1, ar[label]["calls"])}
            for label in ar}
        rec["memory_gb_by_rank"] = [x["memory_gb"] for x in sub]
        summary[mesh_label] = rec
    summary["note"] = ("the ranks share one card and their collectives go "
                       "through host memory (gloo): these rates are not a "
                       "data-parallel speed")
    say("phase 24 slots over data: " + json.dumps(summary, sort_keys=True,
                                                   default=str))
    return by_path, summary


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a GPU")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    # 1. device line
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the prefill kernel's launches by shape in each path's counted run
    import collections
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    flash_attention_fwd.shapes = collections.Counter()
    import numpy
    say(f"torch {torch.__version__} cuda {torch.version.cuda} numpy "
        f"{numpy.__version__} | matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    lap("1")

    # 2. build
    from repro_torch.kernels import build
    seconds = build.timed_build()
    say(f"build: {len(build.sources())} sources -> "
        f"{build.library_path().name} in {seconds:.1f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            say("  ptxas " + line.strip())
    lap("2")

    # 3. kernels against plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    check_quant(torch, gen, results)
    check_prefill(torch, F, gen, results)
    check_prefill_wide(torch, F, gen, results)
    check_decode(torch, F, gen, results)
    check_paged_decode(torch, F, gen, results)
    check_el2n(torch, F, gen, results)
    check_secure_mask(torch, gen, results)
    check_mamba2(torch, gen, results)
    check_rwkv6(torch, gen, results)
    check_slice_g2(torch, F, gen, results)
    tp_shapes(torch, F, gen, results)
    tp2_shapes(torch, F, gen, results)
    data_shapes(torch, F, gen, results)
    check_bf16(torch, F, gen, results)
    check_f16(torch, F, gen, results)
    drift = report_drift(results)
    lap("3")

    # 4. engine parity card vs CPU, dense and paged, at f32 and bf16; the
    # recurrent families; the wide-head families
    engine_parity(torch)
    bf16_parity = engine_parity_bf16(torch)
    recurrent = recurrent_parity(torch)
    wide = wide_parity(torch)
    lap("4")

    # 5-6. the dense and the paged path at full width; 12-13. the same at
    # bf16 activations, on the same weights
    fw = full_width_model(torch)
    by_path, summaries = {}, {"bf16_parity": bf16_parity,
                              "wide_parity": wide, "drift": drift}
    by_path["dense"], summaries["dense"] = full_width(torch, fw)
    by_path["paged"], summaries["paged"] = full_width_paged(torch, fw)
    lap("5-6")
    by_path["dense_bf16"], summaries["dense_bf16"] = full_width(
        torch, fw, "dense_bf16", torch.bfloat16)
    by_path["paged_bf16"], summaries["paged_bf16"] = full_width_paged(
        torch, fw, "paged_bf16", torch.bfloat16)
    lap("12-13")

    # 17. tracing: phase 5's engine untraced and traced, the export through
    # tools/trace_check.py; then a traced round through the train launcher
    t17 = time.perf_counter()
    by_path["traced_dense"], summaries["traced_serve"] = traced_serve(torch,
                                                                      fw)
    del fw
    torch.cuda.empty_cache()
    by_path["traced_train"], summaries["traced_train"] = traced_train(torch)
    torch.cuda.empty_cache()
    say(f"phase 17: {time.perf_counter() - t17:.1f} s")
    lap("17")

    # 7. training parity card vs CPU, clear and private
    summaries["train_parity"] = training_parity(torch)
    summaries["private_parity"] = private_parity(torch)
    lap("7")

    # 8. the training path at full width
    by_path["train"], summaries["train"] = full_width_train(torch)
    torch.cuda.empty_cache()
    lap("8")

    # 9. the private federated run at full width through the launcher
    by_path["private"], summaries["private"] = full_width_private(
        torch, results["secure_masked_encode"]["ms"])
    summaries["recurrent_parity"] = recurrent
    lap("9")

    # 19. the buffered async runtime and hierarchical aggregation: card
    # against CPU at the reduced ViT, then at full width through the
    # launcher
    t19 = time.perf_counter()
    summaries["async_parity"] = async_parity(torch)
    paths19, summaries["async"] = full_width_async(torch)
    by_path.update(paths19)
    torch.cuda.empty_cache()
    by_path["hier"], summaries["hier"] = full_width_hier(torch)
    torch.cuda.empty_cache()
    say(f"phase 19: {time.perf_counter() - t19:.1f} s")
    lap("19")

    # 20. the MoE families: the reduced phi3.5-moe and deepseek-v3 card
    # against CPU, then each at published widths through the dense engine
    t20 = time.perf_counter()
    paths20, summaries["moe_parity"] = moe_parity(torch)
    by_path.update(paths20)
    for path, arch in (("moe", MOE_ARCHS[0]), ("mla", MOE_ARCHS[1])):
        by_path[path], summaries[path] = full_width_moe(torch, arch, path)
    say(f"phase 20: {time.perf_counter() - t20:.1f} s")
    lap("20")

    # 21. Whisper and Qwen2-VL: the reduced families card against CPU, then
    # whisper-base whole and qwen2-vl-72b at 6 layers, each model freed
    # before the next loads
    t21 = time.perf_counter()
    paths21, summaries["g2_parity"] = g2_parity(torch)
    by_path.update(paths21)
    for path, arch in (("whisper", G2_ARCHS[0]), ("vlm", G2_ARCHS[1])):
        by_path[path], summaries[path] = g2_full_width(torch, arch, path)
    say(f"phase 21: {time.perf_counter() - t21:.1f} s")
    lap("21")

    # 16. the FL and SFL baselines and the heterogeneous-cut trainer: card
    # against CPU at the reduced ViT, then at full width
    t16 = time.perf_counter()
    summaries["baseline_parity"] = baseline_parity(torch)
    paths16, summaries["baselines"] = full_width_baselines(torch)
    by_path.update(paths16)
    torch.cuda.empty_cache()
    say(f"phase 16: {time.perf_counter() - t16:.1f} s; launches "
        + json.dumps({p: {k: v for k, v in c.items() if v}
                      for p, c in paths16.items()}, sort_keys=True))
    lap("16")

    # 18. the LM training path: the reduced families' rounds card against
    # CPU, then Qwen2.5-14B widths through a round, `evaluate`, a
    # `make_train_step` and prefill and decode steps
    t18 = time.perf_counter()
    paths18, summaries["lm_parity"] = lm_parity(torch)
    by_path.update(paths18)
    paths18, summaries["lm"] = lm_round(torch)
    by_path.update(paths18)
    torch.cuda.empty_cache()
    say(f"phase 18: {time.perf_counter() - t18:.1f} s")
    lap("18")

    # 10-11. the recurrent families at full width through the dense engine;
    # 14. gemma2-9b through the dense engine; 15. stablelm-12b through the
    # paged engine; each model freed before the next loads
    for phase, path, arch, n_layers, run in (
            ("10", "hybrid", "zamba2-2.7b", 18, full_width),
            ("11", "rwkv", "rwkv6-3b", 3, full_width),
            ("14", "gemma2", "gemma2-9b", 6, full_width),
            ("15", "stablelm", "stablelm-12b", 3, full_width_paged)):
        torch.cuda.empty_cache()
        fw = full_width_model(torch, arch, n_layers)
        by_path[path], summaries[path] = run(torch, fw, path)
        del fw
        lap(phase)

    # 22. tensor parallelism: two ranks on the card over gloo, serving
    # Qwen2.5-14B widths at 'model' 2 and running ViT-Base rounds on
    # (data 2), with FSDP, and on (model 2), each against one process
    torch.cuda.empty_cache()
    paths22, summaries["tensor_parallel"] = tensor_parallel(torch)
    by_path.update(paths22)
    lap("22")

    # 23. the families slice H part 2 brought to the mesh: phi3.5-moe,
    # deepseek-v3, zamba2 and rwkv6 served at published widths on 'model'
    # 2, whisper-base and qwen2-vl-72b rounds, each against one process
    torch.cuda.empty_cache()
    paths23, summaries["tensor_parallel_families"] = \
        tensor_parallel_families(torch)
    by_path.update(paths23)
    lap("23")

    # 24. slots over 'data': phase 22's model served on four ranks (data
    # 2, model 2) and on two (data 2), dense and paged, fp32 and int8,
    # each against one process
    torch.cuda.empty_cache()
    paths24, summaries["slots_over_data"] = data_parallel(torch)
    by_path.update(paths24)
    lap("24")

    # the kernels line (f32 numbers under the contract's keys, bf16 ones
    # under "bf16" and the wide shapes' under "wide", by case), the phase
    # times, then the device line
    keys = ("max_abs_err", "max_ulps", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_device_ms")
    kernels = []
    for name in REPLACES:
        per_path = {path: counts[name] for path, counts in by_path.items()
                    if name in PATHS[path]}
        rec = dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=sum(per_path.values()),
            launches_by_path=per_path,
            dtypes=["float32", "bfloat16", "float16"],
            bf16={case: {k: r.get(k) for k in keys}
                  for case, r in results[name]["bf16"].items()},
            f16={case: {k: r.get(k) for k in keys}
                 for case, r in results[name]["f16"].items()},
            **{k: results[name][k] for k in
               ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")})
        if name in SOURCES_16:
            rec["source_16_bit"] = SOURCES_16[name]
        if "f32" in results[name]:
            rec["device_ms"] = results[name]["device_ms"]
            rec["f32"] = {case: {k: r.get(k) for k in keys}
                          for case, r in results[name]["f32"].items()}
        if name in HEADS:
            rec["head_dims"], rec["groups"] = HEADS[name]
            rec["wide"] = {case: {k: r.get(k) for k in keys + (
                "plan_rows", "plan_blocks", "blocks_per_sm") if k in r or
                k in keys} for case, r in results[name]["wide"].items()}
        if "g2" in results[name]:
            rec["slice_g2"] = {case: {k: r.get(k) for k in keys}
                               for case, r in results[name]["g2"].items()}
        if "tp" in results[name]:
            rec["slice_h"] = {case: {k: r.get(k) for k in keys}
                              for case, r in results[name]["tp"].items()}
        if "data" in results[name]:
            rec["slice_h_data"] = {
                case: {k: r.get(k) for k in keys}
                for case, r in results[name]["data"].items()}
        kernels.append(rec)
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "phase3": results,
         "full_width": summaries, "phase_s": PHASE_S}, indent=1,
        sort_keys=True))
    say(json.dumps({"kernels": kernels}))
    say("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in PHASE_S.items())
        + f"; total {time.perf_counter() - T0:.1f} s")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
