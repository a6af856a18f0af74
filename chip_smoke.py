"""Chip smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Needs a CUDA device and nvcc; it builds the port's kernels from `csrc/`
(one nvcc per source, all at once), then runs these phases and fails
(non-zero exit) if any of them fails:

  1. device   — the card's name and power limit; TF32 off for matmuls and
                convolutions (the port's float32 path is checked against
                float32 references); the build's registers and spills (no
                instance of the forward bodies or of the backward bodies may
                spill), and the tensor-core instructions of every instance in
                `cuobjdump -sass`: wgmma's (HGMMA) in each instance of the
                forward bodies (K1, K2/K6, K5, K9a-c; bf16
                `causal_wgmma_kernel`, float32 `causal_tf32_wgmma_kernel` in
                split TF32, but K5's float32 instance) and of the backward
                bodies (K3/K7, K4/K8; bf16 `causal_dq_wgmma_kernel` and
                `causal_dkv_wgmma_kernel`, float32 `causal_dq_f32_wgmma_kernel`
                and `causal_dkv_f32_wgmma_kernel` in three bf16 terms),
                mma.sync's (HMMA) in K5's float32 instance
                (`causal_flat_kernel`), both types at head width 64,
                K1-K4's at 80 and 128 and K1's and K5's at 32, none of
                which may lack them;
  2. mask     — the kernel's element predicate (`alive_mask`: the bf16
                body's alive words) against the torch oracle
                `element_mask_int8`, bit for bit, for T up to 8192; the
                forward bodies' pixel quotients, taken from each row's
                reciprocal, against IEEE division, and the bf16 body's alive
                words against the per-column pixel map (T_M = 128, 256, 512,
                causal and bidirectional, every even and every odd pixel
                alive), on every row width to 2^17;
  3. kernel   — the causal fused sparse attention kernel (K1) against its
                plain PyTorch version at the main-path shapes (H=12, D=64,
                T_M=256, k=64, production top-k budget), float32 and
                bfloat16, plus edge cases; times of the kernel, the plain
                version and PyTorch's own SDPA at the same shape (a yardstick
                only); then OPT-2.7b's and LLaMA-7b's layer geometries (1 x
                32 x T x 80 and 1 x 32 x T x 128, T = 1024 and 2048, both
                types): the element mask bit for bit, K1 against its plain
                version, the 128 x 256 lists equal to the 64 x 64 ones bit
                for bit, and rows with nothing alive;
  4. slice    — the serving path: OPT-125m with the SEA student, seeded
                random weights, scoring two prompts of 1024 tokens in one
                batch and then one of 2048 to logits on the fused benchmark
                path; K1 must run 12 times per forward (and the train
                kernels never), and layer 0's kernel inputs, captured from
                the run, are held against the plain version; ms/forward
                beside the dense OPT-125m;
  5. train-kernels — the differentiable path's kernels, forward with stats
                (K2), dq (K3) and dk/dv (K4), against their plain versions
                at the same shapes for T = 1024, 2048 and 4096, the whole
                `FusedSparseAttention` backward against autograd through
                `dense_reference`, two block sizes, and edge cases (empty
                rows, T=128, a mask with every pixel on); two launches of K3
                and of K4 on the same operands must give the same bits; the
                same at widths 80 and 128 (1 x 32 x T x 80 and x 128, T =
                1024 and 2048, and empty rows), the width-128 instances
                also timed at T = 2048 beside SDPA's forward and backward;
 5b. bf16-kernels — the bf16 instances of K2, K3 and K4 against their plain
                versions on the same bf16 operands (the plain result in
                float32) at T = 1024, 2048 and 4096 and on a band of empty
                rows: o within 1e-5 plus half a bf16 ulp, lse within 1e-5,
                each gradient within 1e-4·max|want| plus half a bf16 ulp; two
                launches, and blocks 128 x 256 against 64 x 64, equal bit for
                bit; zeros and no NaN on the empty rows; times at T = 2048
                beside SDPA's bf16 forward and backward; the same checks at
                widths 80 and 128 (1 x 32 x T x 80 and x 128, T = 1024 and
                2048), the width-128 instances timed at T = 2048;
  6. train    — the training path: OPT-125m with `use_fused_train`, full
                width and depth, AdamW steps through `train_steps` on one
                batch of 1 x 2048 tokens (3 steps) and one of 1 x 8192 (2
                steps); every step must give a finite loss and launch K2, K3
                and K4 12 times each and K1 never, and the loss must fall
                over the 2048-token steps; layer 0's kernel inputs and
                incoming gradient, captured from one more step of each
                request, are held against the plain versions; ms/step,
                tokens/s and peak memory beside the
                dense OPT-125m train step at 1 x 2048;
 6b. longctx-32k — `training.longctx.main`'s model (OPT-125m widths, 12
                layers, use_fused_train, bf16 compute, `scan_layers` and
                `scan_remat`) at 1 x 32768 with `--logit-chunk 2048`, 2 AdamW
                steps at lr 1e-5: 24 launches of K2 and 12 each of K3 and K4
                a step (the remat's backward runs each layer's forward
                again), no other kernel, finite losses that fall; ms per
                step and peak memory; then layer 0 of one more step, the
                model freed: the recompute's top-k mask equal to the
                forward's and the card's to the CPU's, K2, K3 and K4
                launched on every head (K2 reproducing the step's output bit
                for bit, two launches of K3 and K4 equal) and held on the
                last head against their plain versions of that head alone,
                and FusedSparseAttention on that head against autograd
                through the plain version (a head's plain versions at this
                length take about 4.3 GB a score tensor);
  7. bidir-mask — the padded bidirectional kernel's (K5) element predicate
                against the lengths-aware oracle, bit for bit, for T = 128,
                512 and 2048 with example lengths 1, 77, 128, 255, 383 and T;
  8. bidir-kernel — K5 against its plain version at T = 256, 512, 1024,
                2048 and 200 (padded inside the wrapper), ragged lengths,
                BERT-base heads (H=12, D=64, T_M=128, k=64, the non-causal
                top-k budget), float32 and bfloat16, plus edge cases (empty
                rows, lengths 0 and 1); times of K5, the plain version and
                PyTorch's SDPA (dense, non-causal, boolean key-padding mask);
  9. bert     — the BERT-base SEA forward to classification logits, full
                width and depth, seeded random weights, on two right-padded
                batches: 32 x 256 (the GLUE trainer's MRPC batch and
                max_length) and 8 x 512 (BERT's most positions). K5 must run
                12 times per forward and K1-K4 never; the logits must be
                finite; layer 0's kernel inputs, captured from the run, are
                held against the plain version and must reproduce the run's
                own kernel output; ms/forward, tokens/s and peak memory
                beside the dense BERT-base;
 10. ring-kernels — the ring's windowed kernels, forward with stats (K6),
                dq (K7) and dk/dv (K8), against their plain versions on every
                (shard, window) of a ring of 4 shards (zigzag rows, blocks 128)
                over synthetic 1 x 4096 inputs (H=12, D=64, T_M=256, the budget
                mask, a band of rows with nothing alive, windows wholly past
                their rows' causal edge); the merged ring forward and backward
                against K2-K4 unsharded on the same inputs; times of the S²
                launches of a layer against one launch of K2/K3/K4; then the
                bf16 instances of K6-K8 on every (shard, window), both row
                orders: outputs within 1e-5 plus half a bf16 ulp of the
                float32 plain result, gradients within 1e-4·max|want| plus
                half an ulp; then 4 shards of 192 rows at blocks of 64 (1 x
                768, rows and windows padded to whole 128-row tiles inside
                the wrappers), float32 and bf16, on every (shard, window);
 11. ring-serve — the OPT-125m benchmark forward at 1 x 16384 (full width,
                6 of its 12 layers since PR 20) inside
                `sharded_attention_scope(LocalGroup(4), kind="auto")`, which
                must resolve to 'ring': 96 K6 launches and no other kernel per
                forward, finite logits, layer 0's attention output within 1e-4
                of the unsharded forward's (K1); ms/forward beside the
                unsharded forward;
 12. ring-train — OPT-125m with `use_fused_train` at full width (6 of its
                12 layers since PR 20),
                2 AdamW steps on 1 x 16384 tokens inside the same scope, then
                the same from the same weights unsharded (K2-K4): 96 launches
                each of K6, K7 and K8 per step and none of K1-K5, the loss
                falling, the first step's loss within 1e-4 of the unsharded
                step's, every layer's top-k mask compared between the arms and
                every parameter gradient within 2e-4 of the unsharded step's
                when no pick differs (the gap is printed either way); on layer
                0's inputs and incoming gradient captured from the ring arm,
                the ring's output within 3e-5 and its dq, dk, dv and dscaler
                within 2e-4 of the unsharded kernels', and K6-K8 against their
                plain versions on every (shard, window), timed; ms/step,
                tokens/s and peak memory of both arms;
 13. seq-head  — the 'seq' and 'head' kinds at 1 x 4096 over LocalGroup(4)
                at 6 of OPT-125m's 12 layers (since PR 20):
                the benchmark forward (K1 with row_base, 24 launches) and two
                train steps (K2-K4, 24 launches each a step) against the
                unsharded ones; the 'auto' rule ('seq' at 4096, 'ring' at 16384,
                never 'ring' for one shard);
 14. impl-mask — the restricted element predicates of the impl variants K9a
                ('flat_wr'), K9b ('flat_fori') and K9c ('subtile') on their own
                tile lists (`alive_mask(impl=)`), against `element_mask_int8` bit
                for bit: budget masks at T = 1024, 2048, 4096 and bench.py's
                `host_topk_mask` at 4096, under every block shape of bench.py's
                candidates and each wrapper's defaults;
 15. impl-kernels — bench.py's canonical configuration (N=1, H=12, T=4096,
                D=64, T_M=256, K=64, its `host_topk_mask` and inputs from seed
                0) in float32 and bfloat16 through every impl and every block
                shape: each kernel against its plain version (`impl_reference`)
                and equal to K1's output bit for bit; at each impl's
                default blocks the kernel's, K1's, the plain version's and
                SDPA's times, the bound, the mean words per listed tile (K9a/b)
                and the share of skipped pieces (K9c). This run is what
                launches K9b and K9c;
 16. sweep    — the attention-operator sweep (`sea_tpu_torch.benchmarks`,
                dense, performer, cosformer, sea_fused) at T = 1024, 2048,
                4096 in float32 and bfloat16: no record may hold an error, and
                sea_fused must launch K9a and never K1; the records as JSON
                lines, dense/sea_fused beside each T; then, outside the
                counted run, sea_fused's call (K9a) on the sweep's own inputs
                at each T and type against its plain version;
 17. cosformer-slice — OPT-125m with the cosformer estimator backend at full
                width and depth on 1 x 2048 tokens: 12 K1 launches per forward
                and no other kernel, finite logits, layer 0's kernel inputs
                held against the plain version; ms/forward beside the
                performer-backend forward of the same weights;
 18. dense-vs-fused — one OPT-125m attention layer (H=12, D=64, T_M=256,
                k=64) on 1 x 2048, float32 with TF32 off: the dense train path
                (plain PyTorch, no kernel) as the reference of the fused
                kernels, as the JAX package holds them to it: the benchmark
                path's context (one K1 launch) within 2e-4 of the dense path's
                (tests/test_fused_path.py:12), use_fused_train's loss Σ context²
                (K2, K3, K4 once each) within 1e-4 relative and every gradient
                within 5e-3 + 1e-2·|dense| (:88); the arms' top-k masks
                compared row by row (a row that picked otherwise would be left
                out of the context check, the gradients then reported only);
 19. kd       — the OPT-125m KD trainer (`OptTrainer`, full width and depth,
                random teacher, synthetic corpus, its defaults: 1 x 512 windows,
                stride 256, accumulation 8, use_remat) for 2 optimizer steps
                (16 micro-steps) through `train()`: no kernel launched (the KD
                step is the dense train path), every logged loss term finite,
                the student moved and the teacher unchanged bit for bit, the KD
                loss of the stream's first batch lower after the steps; ms per
                micro-step, tokens/s and peak memory beside the dense teacher's
                own CE step on the same batch, a [breakdown] of a micro-step,
                `evaluate(max_batches=4)`'s PPL and ms per window, and one
                micro-step at 1 x 2048 with its time and peak memory;
 19a. baselines — the baseline students and methods (plain PyTorch, no
                kernel): OPT-125m at full width and depth on 1 x 2048 with
                each causal student ('performer', 'reformer', 'sinkhorn',
                'cosformer'), one forward and one task-only AdamW step, the
                logits and the loss finite; BERT-base on the 32 x 256 padded
                request with each other method ('performer', 'synthesizer',
                'cosformer', 'reformer', 'scatterbrain', 'sinkhorn'), one
                forward, then the padding's token ids changed: the logits
                unchanged (within 1e-5 of max|logit|) for the methods the
                reference masks padding in (synthesizer, cosformer), the
                change reported for the others (their reference semantics
                read the padding); ms per forward and step, no kernel
                launched;
 19b. glue-kd — `GlueTrainer(model="bert-base", subset="mrpc")` through its
                own constructor on the synthetic fallback (batch 32, T = 64):
                `train()` for 3 KD steps (the student on the dense train
                path, no kernel), the final `evaluate` and `evaluate_teacher`,
                every loss term finite and the student moved; ms per step and
                peak memory; one KD micro-step at 32 x 256 (GLUE's
                max_length) from `synthetic_glue`; then one benchmarking
                forward of the trained student through K5 (12 launches and no
                other kernel), layer 0's K5 held to its plain version and
                reproducing the run's output bit for bit;
 19c. lra     — `LraTrainer` on ListOps at full task scale (6 layers, width
                512, 8 heads, batch 32, T = 512, remat_layers): 2 'dense'
                steps through `train()`, the teacher saved and resumed into
                a new trainer with parameters, optimizer state and step equal
                bit for bit; 2 'distill' steps of 2 micro-batches each; the
                trained student's benchmarking forward through K5 (6
                launches) with layer 0 held to the plain version and timed
                (32 x 8 x 512 x 64); one 'text' KD step at 16 x 1024; ms per
                step and peak memory, remat on;
 19d. lora    — OPT-125m's SEA student with `lora_enabled` and
                `lora_in_approx_enabled`, r = 32, every B drawn N(0, 0.02²)
                from the seed (B is zero at init): the 1 x 2048 benchmark
                forward, 12 K1 launches and no other kernel, the logits moved
                from the same base without LoRA, layer 0's K1 (on the score
                branch's q and k) against its plain version, ms beside the
                LoRA-free forward; the 1 x 1024 prefill's logits and decode
                states equal bit for bit to the LoRA-free model's (JAX's
                prefill takes no deltas); 2 `use_fused_train` steps, 12 each
                of K2-K4 a step, finite losses, layer 0's kernels against
                their plain versions; BERT-base with both flags on the 32 x
                256 GLUE batch, 12 K5 launches, layer 0 within K5's gate;
 19e. csr     — OPT-125m with `use_pallas=False` at 1 x 2048 (the uniform-
                CSR benchmark path, Z = 1664 slots a row): no kernel launched,
                finite logits; layer 0's `cols` equal bit for bit to the
                CPU's expansion of the same compressed mask, its context
                within 1e-5 of a dense masked softmax built from
                `flat_csr_to_dense` of the same CSR; ms and peak memory beside
                the K1 path on the same weights; then BERT-base at 8 x 512
                with `k_oversample=2.0` (JAX's CSR route), no kernel;
 19f. variants — OPT-125m at 1 x 2048 with `predictor_method='comp'` and
                with `enc_per_layer=True`: 12 K1 launches each, layer 0's K1
                against its plain version;
 19g. long-context — `exp_long_context.sweep` on OPT-125m stretched to 4096
                and 8192 positions (`extend_opt_context`), dynamic_k 0 and
                32, query_skips 1 and 2, 2 windows each of the synthetic
                corpus: 12 K1 launches a forward and no other kernel, finite
                PPL, ms per window; layer 0's K1 at 8192 against its plain
                version;
 19h. cli     — `cli.main` in-process: wikitext2, OPT-125m, --enable-lora,
                --checkpoint-rotation 2, 3 KD updates at 1 x 512: no kernel,
                exactly the two newest `ckpt_*` kept, LATEST naming the
                newest, a fresh heartbeat; a second trainer resumed from the
                newest, and its next update equal bit for bit to the
                uninterrupted run's (both under deterministic algorithms);
 19i. width32-kernels — head width 32: K1 at the scaling sweep's
                1 x 4 x 1024 x 32 (T_M 32, k 8) and K5 at LRA image's 256 x 1
                x 1024 x 32 (T_M 128, k 64, half the examples ragged, one
                empty), float32 and bf16, under the width-64 gates: the
                element mask bit for bit, the plain version within the
                tolerances below, K1's 128 x 256 lists equal to 64 x 64, rows
                with nothing alive zero; each timed beside its plain
                version, SDPA and its bound;
 19j. scaling — `benchmarks.scaling_sweep` at 1, 2 and 4 LocalGroup
                positions of the card (the JAX sweep's 4 heads of 32, T =
                1024, kind 'seq'): 43 launches of K1 at width 32 and no other
                kernel, finite records (on one card the split's cost, not
                scaling); layer 0's top-k and K1 checked; the 'seq' context
                over 2 and 4 positions within 2e-5 of the unsharded one; the
                forward again with bf16 parameters (K1's bf16 instance);
 19k. lra-image — `LraTrainer` on LRA's image task at its own geometry (1
                layer, one head of 32, batch 256 x 1024, the synthetic pixel
                stream): a 'dense' step and a 'distill' step through
                `train()`, one more KD step timed, `evaluate('student')` (the
                dense train path, as JAX's: no kernel), finite losses; then
                the student's benchmarking forward through K5 at width 32 in
                float32 and in bf16, one launch each, layer 0 held to the
                plain version and reproducing the run's output bit for bit;
 19l. dp     — `cli.main` on wikitext2 at OPT-125m, 2 KD updates at 1 x 256,
                with and without `--data-parallel` in one process: no
                kernel, the same logged losses and the same student bit for
                bit (deterministic algorithms); the NCCL run over several
                cards waits for a machine that has them;
 20. decode   — OPT-125m with the decode cache (`opt_config` plus use_cache,
                full width, 3 of its 12 layers, seeded random weights,
                float32; the depth cut because the phase's steps are
                host-bound, about 125 launches a layer, and the run's time
                limit is shared by every phase): `generate_greedy` with
                `parallel_prefill` on
                1 x 1024 prompt tokens, max_len 2048, 64 new tokens; the
                prefill must launch K1 once a layer and nothing in the phase
                any other kernel;
                layer 0's K1 inputs, captured from the prefill, held against
                the plain version; the decode logits at positions 1024-1087
                against the full SEA forward of the generated sequence (the
                dense path): at most 2e-2 apart with argmax agreement 1.0
                (tests/test_opt_decode.py:13) on the rows whose top-k picks
                agree in every layer, the rows that differ counted; paged
                decode against contiguous decode for 16 steps (1e-5);
                `generate_sample` (temperature 0.8, top-p 0.9) and
                `generate_beam` (4 beams, 32 steps) give valid ids and finite,
                ordered scores; ms of the prefill, ms per decode step and
                tokens/s at N = 1 and 8, peak memory, a [breakdown] of 8 steps;
 21. serve    — the continuous-batching engine (`ServingEngine`, 4 slots,
                pages of 16, 128 pages a slot, a pool for every slot) on the
                same model: 8 requests, prompts of 17-300 tokens and 32-64
                new tokens, greedy, temperature 0.8 with top-k 50, and
                temperature 0.8 with top-p 0.9, 5 submitted at once and 3
                after 24 decode steps; no kernel launched, every request
                finished with its token count of valid ids; each greedy
                request equal to `generate_greedy` (sequential prefill) on its
                prompt alone up to the first step whose top-2 logit margin
                there is under 1e-4; run with chunk 1 and chunk 8, whose
                greedy outputs must be equal; tokens/s, ms per engine step,
                steps and the pool's bytes;
 21a. tp      — OPT-125m (full width and depth, float32) tensor parallel
                (`parallel.tp.tensor_parallel`) over 2 and 4 LocalGroup
                positions of the card: the benchmark forward at 1 x 2048
                launches K1 12·tp times (each position's heads) and no other
                kernel; the top-k picks that float reassociation flips are
                counted, and the unsharded forward run on the TP run's masks
                (`recorded_masks`) holds layer 0's attention output within
                1e-5·max|want| and the logits within 1e-4·max|logit|; one
                dense-path KD micro-step at 1 x 512 the same way, its
                gradients within 5e-4 (tests/test_tp.py:131-160); ms a
                forward beside the unsharded one (the split's cost on one
                card, not scaling);
 21b. pp      — the same model pipelined (`parallel.pp`) over 4 stages of 3
                layers at 4 x 512 in 4 microbatches: the benchmark forward
                launches K1 48 times and no other kernel, its logits within
                1e-4·max|logit| of the unsharded model's on the same
                microbatches, the task-loss gradients within 1e-5·max|g|;
                the interleaved pipeline (2 stages x 2 chunks) the same; KD
                through GPipe (with and without remat) and 1F1B, 1F1B's
                gradients within 1e-4·max|g| of GPipe's, one AdamW update
                after it; ms and peak GiB of each KD schedule (the stages'
                sum on one card);
 21c. tp-serve — [serve]'s model and requests through the head-sharded
                engine (`mesh=`, 2 positions): every request's tokens those
                of [serve]'s unsharded engine at chunk 8, no kernel;
 21d. dryrun  — `sea_tpu_torch.dryrun.dryrun_multichip(8)`: every section
                of JAX's dry run within its bound, at heads of 64 (K1, K2-K4
                and K6-K8 launched);
 22. opt13b-serve — OPT-1.3b (`opt_1_3b`, full width and depth, seeded
                random weights drawn on the card and cast to bf16 as
                exp_opt27b.py casts its tree),
                the SEA student's forward at 1 x 2048: 24 launches of K1's
                bf16 instance and no other kernel, finite bf16 logits, layer
                0's K1 against its plain version; ms, tokens/s and peak
                memory beside the dense OPT-1.3b on the same weights; then
                float32 parameters with compute_dtype bfloat16 (JAX's
                promotion rule): 24 launches of K1's float32 instance, the
                embedding and layer outputs bf16, the logits float32;
 23. opt13b-train — OPT-1.3b with use_fused_train and bf16 parameters, 3
                AdamW steps (lr 1e-3) on 1 x 2048: 24 launches each of K2,
                K3 and K4's bf16 instances a step and no other kernel, the
                loss finite and falling; layer 0's captured inputs and
                gradient against the plain versions (as bf16-kernels), K2
                reproducing the step's output bit for bit, timed beside
                SDPA; ms per step, tokens/s, peak memory; then the remat arm
                (`scan_layers`, `scan_remat`) on the same weights and batch,
                2 steps: 48 K2 and 24 each of K3 and K4 launches a step, its first loss
                equal to the plain arm's bit for bit (a gap within half a
                bf16 ulp of the loss is logged, a larger one fails), the loss
                falling, layer 0's recomputed top-k mask equal to the
                forward's bit for bit, both arms' peaks;
 24. opt13b-decode — OPT-1.3b with the decode cache, bf16 parameters and
                states: generate_greedy of 16 tokens from a 1 x 512 prompt
                prefilled in one forward (24 bf16 K1 launches, no other
                kernel); the decode logits against the dense forward of the
                generated sequence, every row (in bf16 over 24 layers each
                row picks otherwise in some layer; the layers are counted),
                within 0.18 of the largest |logit| (JAX's own bf16 gap over
                every row, PERF.md) and the same argmax where the top-2
                margin exceeds twice the gap; the engine with dtype=torch.bfloat16,
                4 slots, 4 greedy requests of 17-64 prompt tokens, no kernel,
                each equal to its prompt decoded alone at bf16 states up to
                its first top-2 margin under 0.0625;
 25. opt13b-kd — exp_opt13b.py's configuration, `OptTrainer(model=
                "opt-1.3b", scan_kd=True, logit_chunk=256, param_dtype=
                "bfloat16", moment_dtype="bfloat16")` at 1 x 1024,
                accumulation 1, 2 updates: the scanned pair, no kernel,
                every logged term finite, the student
                moved, the teacher unchanged bit for bit, AdamW's first
                moment bf16; ms per micro-step and peak memory;
 26. opt27b-serve — OPT-2.7b (`opt_2_7b`: hidden 2560, 32 layers, 32 heads
                of 80, FFN 10240, seeded random weights cast to bf16) at 1 x
                2048: 32 launches of K1's bf16 instance at width 80 and no
                other kernel, layer 0's top-k equal to the CPU's and its K1
                against the plain version, finite logits; ms and tokens/s
                beside the dense OPT-2.7b; then float32 parameters under bf16
                compute: 32 launches of K1's float32 instance, none of its
                bf16 one;
 27. opt27b-decode — exp_opt27b.py's second stage: a 1 x 256 prompt
                prefilled in one forward (32 bf16 K1 launches), 16 greedy
                tokens with no kernel launched in the decode steps, every
                decoded row within 0.18 of the forward's largest |logit|;
 28. opt27b-train — use_fused_train, task-only, two arms: (a) bf16
                parameters and moments under the per-layer remat, 3 AdamW
                steps (lr 1e-3) on 1 x 2048, 64 launches of K2's and 32 each
                of K3's and K4's bf16 width-80 instances a step, the loss
                falling, layer 0's recomputed top-k mask equal to the
                forward's; (b) float32 parameters under bf16
                compute, 2 steps on 1 x 512, 32 launches each of the float32
                width-80 instances a step; per arm layer 0's kernels against
                their plain versions (two launches and two block shapes equal
                bit for bit), timed beside SDPA, ms per step and peak memory;
 29. ring-bf16 — OPT-125m with bf16 parameters at 1 x 16384 under the
                ring scope, 6 of its 12 layers since PR 20: the forward
                launches K6's bf16 instance 96 times,
                2 train steps K6-K8's 96 times each a step (the loss
                falling); the unsharded bf16 arms (K1, K2-K4) from the same
                weights; the first step's loss within 2^-9 of it, gradients
                within 2e-2 of the largest where no top-k pick differs,
                layer 0's op within 1e-2·max|want| of the unsharded kernels'
                and bit for bit the step's own; K6-K8 bf16 against their
                plain versions on every (shard, window), timed;
 30. llama7b-serve — LLaMA-7b (`llama_7b`: hidden 4096, 32 layers, 32
                heads of 128, SwiGLU 11008, vocabulary 32000, RoPE, RMSNorm;
                seeded random weights drawn on the card, cast to bf16) at 1 x
                2048: 32 launches of K1's bf16 instance at width 128 and no
                other kernel, layer 0's top-k equal to the CPU's and its K1
                within half a bf16 ulp of the float32 plain result, finite
                logits; ms and tokens/s beside the dense LLaMA-7b; then
                float32 parameters under bf16 compute: 32 launches of K1's
                float32 instance, none of its bf16 one, layer 0 checked;
 31. llama7b-decode — a 1 x 256 prompt prefilled in one forward (32 bf16
                K1 launches), 16 greedy tokens with no kernel launched in the
                decode steps, every decoded row within 0.36 of the forward's
                largest |logit| (JAX's own bf16 gap at llama_tiny); ms per
                decode step beside its device bound (the weights read once);
 32. llama7b-engine — the bf16 engine at 4 slots on 4 greedy requests of
                9-32 prompt tokens: no kernel, bf16 pools, every request
                finished, each equal to its prompt decoded alone up to its
                first top-2 margin under 0.0625;
 33. llama7b-mmlu — `evaluate_mmlu` over 64 synthetic examples, 0-shot,
                batches of 8, scored through `make_choice_score_fn(
                benchmarking=True)`: 32 K1 launches a batch and no other
                kernel, finite logits, n = 64, the (random model's) accuracy;
 34. llama7b-train — use_fused_train, task-only, two arms, each drawn from
                the seed on the card: (a) bf16 parameters and moments at
                full width and depth under the per-layer remat and the
                chunked cross entropy (chunk 256), 3 AdamW steps (lr 1e-3)
                on 1 x 2048, 64 launches of K2's and 32 each of K3's and
                K4's bf16 width-128 instances a step and none of K1 or
                K6-K8, the loss falling, layer 0's recomputed top-k mask
                equal to the forward's, then 2 of the dense LLaMA-7b's CE
                steps on the same starting weights and batch, with the same
                remat and chunk; (b) float32 parameters under
                bf16 compute at 8 layers, 2 steps on 1 x 512, 8 launches each
                of the float32 width-128 instances a step; per arm layer 0's
                kernels against their plain versions (two launches and two
                block shapes equal bit for bit), timed beside SDPA, ms per
                step and peak memory;
 35. llama7b-kd — `OptTrainer(model="llama-7b", param_dtype="bfloat16",
                moment_dtype="bfloat16")` at 1 x 512, accumulation 1, 2
                updates: no kernel, every logged term finite, the student
                moved, the teacher unchanged bit for bit, the first batch's
                KD loss lower; ms per micro-step, peak memory, `evaluate`'s
                PPL (a random model's);
 36. result   — one JSON line of per-kernel numbers (K1-K4's bf16 instances
                beside the float32 ones, K1-K4 at widths 80 and 128 in each
                type, K6-K8's bf16 instances, K1 and K5 at width 32 in each
                type), then the device line.

Tolerances: float32 1e-5 abs for outputs and the logsumexp (both sides do
float32 arithmetic, summed in another order); bfloat16 1e-5 plus half a
bf16 ulp of the float32 plain result on the same bf16 inputs (the kernel
sums in float32 and rounds once); gradients 1e-4·max|want| abs, plus 1e-8
for tensors that are all zero (sums over up to T float32 products in another
order, whose rounding scales with the largest terms rather than with each
element). The ring phases hold the JAX package's own sharded bounds:
the ring's output 3e-5 and its gradients 2e-4 abs against the unsharded
kernels (tests/test_sharded_attention.py:150, :309-312), a layer's
attention output 1e-4 (:257), the first train step's loss 1e-4
(__graft_entry__.py:283-299).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from sea_tpu_torch.benchmarks import (SCALING_CONFIG, SCALING_COUNTS, attention_method_sweep,
                                      host_topk_mask, scaling_forward, scaling_inputs,
                                      scaling_sweep, sweep_inputs)
from sea_tpu_torch.data.lra import LRA_TASKS
from sea_tpu_torch.config import opt_config
from sea_tpu_torch.data.glue import synthetic_glue
from sea_tpu_torch.data.mmlu import (
    CHOICES,
    evaluate_mmlu,
    load_mmlu,
    make_choice_score_fn,
    synthetic_tokenizer,
)
from sea_tpu_torch.models.attention import SeaAttention, init_random_
from sea_tpu_torch.models.bert import BertForSequenceClassification, bert_base
from sea_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
from sea_tpu_torch.models.long_context import extend_opt_model
from sea_tpu_torch.models.lora import LoraDelta
from sea_tpu_torch.models.opt import (BASELINE_METHODS, OptForCausalLM, cross_entropy_shifted,
                                      opt_125m, opt_1_3b, opt_2_7b)
from sea_tpu_torch.ops import flat_csr
from sea_tpu_torch.ops.kernels import _build
from sea_tpu_torch.ops.kernels import block_sparse as bs
from sea_tpu_torch.ops.masks import _ranks_desc, fp_min_for, topk_mask
from sea_tpu_torch.parallel import (
    AttnShardingContext,
    LocalGroup,
    make_mesh,
    resolve_attention_kind,
    sharded_attention_scope,
)
from sea_tpu_torch.parallel import sharded_attention as sa
from sea_tpu_torch.parallel.pp import (make_pp_mesh, pp_causal_lm_forward,
                                       pp_kd_1f1b_value_and_grad, pp_kd_loss)
from sea_tpu_torch.parallel.tp import gather_tp, tensor_parallel
from sea_tpu_torch.dryrun import dryrun_multichip
from sea_tpu_torch.serving import ServingEngine
from sea_tpu_torch.training import cli, exp_long_context, resilience
from sea_tpu_torch.training.distill import SeaOptKD, SeaOptKDScan
from sea_tpu_torch.training.optimizer import GroupedAdamW
from sea_tpu_torch.training.glue_trainer import GlueTrainer, GlueTrainerConfig, build_bert
from sea_tpu_torch.training.lra_trainer import LraTrainer, LraTrainerConfig
from sea_tpu_torch.training.longctx import longctx_model, make_optimizer, train_step, train_steps
from sea_tpu_torch.training.opt_trainer import OptTrainer, TrainerConfig, build_model, model_configs
from sea_tpu_torch.utils.profiler import get_bench

H, D, T_M, K = 12, 64, 256, 64
F32_TOL, BF16_HALF_ULP = 1e-5, 2.0 ** -8
LSE_ULPS = 8  # bf16 K2's lse gate at large |lse|, in float32 ulps of max|lse|
GRAD_ATOL, GRAD_RTOL = 1e-8, 1e-4  # the latter of max|want|: see the module docstring
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # FFMA / tensor cores
KERNEL_SOURCE = "sea_tpu_torch/csrc/block_sparse_causal.cu"
DIFF_SOURCE = "sea_tpu_torch/csrc/block_sparse_diff.cu"
REPLACES = "sea_tpu/ops/kernels/block_sparse.py:240"  # _causal_kernel_flat
# the differentiable path: (wrapper, CUDA entry point, source, TPU kernel
# replaced, FLOPs per alive element / D)
TRAIN_KERNELS = {
    "K2": (bs.causal_fwd_stats, "sea_causal_fwd_stats", KERNEL_SOURCE,
           "sea_tpu/ops/kernels/block_sparse.py:1328", 4),  # _causal_kernel_fwd_stats
    "K3": (bs.causal_dq, "sea_causal_dq", DIFF_SOURCE,
           "sea_tpu/ops/kernels/block_sparse.py:1420", 6),  # _causal_kernel_dq
    "K4": (bs.causal_dkv, "sea_causal_dkv", DIFF_SOURCE,
           "sea_tpu/ops/kernels/block_sparse.py:1463", 8),  # _causal_kernel_dkv
}
# the kernels with a bfloat16 instance on an OPT path, by wrapper (K6-K8:
# RING_KERNELS, added below)
BF16_WRAPPERS = {"K1": bs.sea_block_sparse_attention,
                 **{kid: w for kid, (w, *_) in TRAIN_KERNELS.items()}}
TRAIN_LR = 1e-5  # longctx_train_step.py's AdamW rate
CHECK_TS = (1024, 2048, 4096)  # train-kernel checks; blocks compared at the second
TRAIN_REQUESTS = ((2048, 3), (8192, 2))  # (tokens, AdamW steps): requests A and B
BIDIR_T_M = 128  # bert_config's predictor length
BIDIR_REPLACES = "sea_tpu/ops/kernels/block_sparse.py:839"  # _kernel
# (batch, T, least and most length): the GLUE trainer's MRPC batch at its
# max_length, then BERT's most positions
BERT_REQUESTS = ((32, 256, 32, 256), (8, 512, 128, 512))
# the ring's windowed kernels: (wrapper, CUDA entry point, source, TPU kernel
# replaced, FLOPs per alive element / D)
RING_KERNELS = {
    "K6": (bs.fwd_stats_window, "sea_window_fwd_stats", KERNEL_SOURCE,
           "sea_tpu/ops/kernels/block_sparse.py:1598", 4),  # _causal_kernel_fwd_stats_cb
    "K7": (bs.dq_window, "sea_window_dq", DIFF_SOURCE,
           "sea_tpu/ops/kernels/block_sparse.py:1688", 6),  # _causal_kernel_dq_cb
    "K8": (bs.dkv_window, "sea_window_dkv", DIFF_SOURCE,
           "sea_tpu/ops/kernels/block_sparse.py:1698", 8),  # _causal_kernel_dkv_win
}
BF16_WRAPPERS.update({kid: w for kid, (w, *_) in RING_KERNELS.items()})
BF16_WRAPPERS["K5"] = bs.bidir_forward
RING_SHARDS, RING_BLOCK = 4, 128  # LocalGroup(4); the ring's default blocks
RING_T = 16384  # the ring's main path: kind="auto" resolves to 'ring' from here
RING_CHECK_T = 4096  # ring-kernels' synthetic inputs and the seq-head phase
# ring-serve, ring-train, seq-head and ring-bf16 run 6 of OPT-125m's 12
# layers (their host-bound steps set most of their time; the launch gates
# scale with it)
RING_LAYERS = 6
PAD_SHARD, PAD_BLOCK = 192, 64  # ring-kernels' shards that the wrappers pad to 256 rows
# the JAX package's bounds (see the module docstring)
RING_OUT_TOL, RING_GRAD_TOL, LAYER_TOL, LOSS_TOL = 3e-5, 2e-4, 1e-4, 1e-4
# the causal forward's impl variants: (impl, TPU kernel replaced); each one's
# entry point and wrapper are `bs.IMPL_KERNELS[impl]`
IMPL_VARIANTS = {
    "K9a": ("flat_wr", "sea_tpu/ops/kernels/block_sparse.py:349"),  # _causal_kernel_flat_wr
    "K9b": ("flat_fori", "sea_tpu/ops/kernels/block_sparse.py:557"),  # _causal_kernel_flat_fori
    "K9c": ("subtile", "sea_tpu/ops/kernels/block_sparse.py:685"),  # _causal_kernel, subtile
}
# bench.py's block candidates (bench.py:104-123), then each wrapper's defaults
BENCH_BLOCKS = ((512, 512), (1024, 512), (256, 512), (256, 256), (512, 256), (None, None))
BENCH_T = 4096  # bench.py's canonical length
SWEEP_TS = [1024, 2048, 4096]
COS_T = 2048  # the cosformer slice's request, 1 x COS_T tokens
QUOT_W_MAX = 1 << 17  # row widths whose pixel quotients phase_mask checks
# OPT-2.7b's attention layer: 32 heads of width 80, checked at these lengths
WIDE_H, WIDE_D, WIDE_TS = 32, 80, (1024, 2048)
DENSE_T = 2048  # dense-vs-fused: one OPT-125m attention layer on 1 x DENSE_T
KD_STEPS = 2  # the kd phase's optimizer steps (8 micro-steps each)
KD_ITERS = 3  # timed steady micro-steps and dense CE steps
KD_EVAL_WINDOWS = 4
KD_LONG_T = 2048  # one KD micro-step at OPT's context
DECODE_P, DECODE_MAX_LEN, DECODE_STEPS = 1024, 2048, 64  # the decode phase's request
# the decode and serve phases' depth: OPT-125m cut from 12 layers to 6, since
# their steps are host-bound (launches a layer) and set most of the run's time
# the baselines' request, the GLUE and LRA trainers' steps
BASELINE_T = 2048
BERT_BASELINES = ("performer", "synthesizer", "cosformer", "reformer", "scatterbrain",
                  "sinkhorn")
PADDING_MASKED = ("synthesizer", "cosformer")  # the methods whose reference masks padding
GLUE_STEPS, GLUE_LONG_T = 3, 256
LRA_STEPS, LRA_N_TRAIN, LRA_TEXT_T = 2, 128, 1024
DECODE_LAYERS = 3  # [decode] and [serve]: host-bound steps, cut in depth
DECODE_BATCH = 8  # the second decode rate's rows
DECODE_TOL = 2e-2  # decode against the forward (tests/test_opt_decode.py:13)
PAGED_STEPS, PAGED_TOL = 16, 1e-5
BEAM_SIZE, BEAM_STEPS = 4, 32
PAGE_SIZE = 16
SERVE_SLOTS, SERVE_PAGES_PER_SLOT = 4, 128
SERVE_PROMPTS = (17, 300, 64, 211, 128, 33, 256, 90)  # tokens
SERVE_NEW = (32, 64, 48, 40, 64, 56, 36, 44)
SERVE_FIRST, SERVE_STAGGER = 5, 24  # requests at once; decode steps before the rest
SERVE_CHUNKS = (1, 8)
NEAR_TIE = 1e-4  # a top-2 logit margin under which a greedy pick may flip
OPT13B_T = 2048  # the OPT-1.3b serve and train requests, 1 x OPT13B_T
OPT13B_TRAIN_STEPS = 3
OPT13B_REMAT_STEPS = 2  # the remat arm: the first loss is the comparison
# a bf16 weight of OPT-1.3b's random init (|w| about 0.02, an ulp 1.2e-4)
# does not move under longctx's rate 1e-5; Adam's first steps move each
# weight by about the rate
OPT13B_TRAIN_LR = 1e-3
# the decode request: 16 greedy tokens (the steps are host-bound, and the
# run's time limit is shared by every phase)
OPT13B_P, OPT13B_STEPS, OPT13B_MAX_LEN = 512, 16, 1024
# decode against the forward in bf16, of the forward's largest |logit|:
# JAX's own bf16 run of tests/test_opt_decode.py's comparison (tiny OPT cast
# to bf16, T = 12 and 48, seeds 0-4, every row) reaches 0.18 (PERF.md)
OPT13B_DECODE_REL = 0.18
OPT13B_NEAR_TIE = 0.0625  # a bf16 top-2 margin (2 ulps at logits in [4, 8))
OPT13B_SERVE_PROMPTS = (17, 33, 50, 64)  # tokens; 4 slots, 4 greedy requests
OPT13B_SERVE_NEW = (8, 6, 8, 4)  # new tokens (host-bound engine steps)
# the KD trainer at OPT-1.3b as exp_opt13b.py configures it: scan_kd,
# logit_chunk 256, 1 x 1024, accumulation 1, bf16 parameters and moments
OPT13B_KD_T, OPT13B_KD_ACCUM, OPT13B_KD_STEPS = 1024, 1, 2
LOGIT_CHUNK = 256  # exp_opt13b.py's logit_chunk
# OPT-2.7b (scripts/exp_opt27b.py's stages): the forward at 1 x 2048, a 256-
# token prompt and 16 greedy tokens (max_len their sum, as the script's)
OPT27B_T, OPT27B_P, OPT27B_STEPS = 2048, 256, 16
# its task-only fused training, (tokens, AdamW steps) of each arm: (a) bf16
# parameters and moments at exp_opt27b.py's --seq-len under the per-layer
# remat, (b) float32 parameters under bf16 compute (the long-context path's
# default), no remat
OPT27B_TRAIN = ((2048, 3), (512, 2))
# LLaMA-7b (heads of 128) in bf16: the forward at 1 x max_position_embeddings,
# then exp_opt27b.py's decode lengths (a 256-token prompt, 16 greedy tokens)
LLAMA_D, LLAMA_T, LLAMA_P, LLAMA_STEPS = 128, 2048, 256, 16
# decode against the forward in bf16, of the forward's largest |logit|: the
# larger of OPT's 0.18 and JAX's own bf16 gap at llama_tiny (seeds 0-4, T = 12
# and 48, every row: 0.3555; tests/test_torch_llama.py prints it), rounded up
LLAMA_DECODE_REL = 0.36
LLAMA_SERVE_PROMPTS = (9, 17, 24, 32)  # tokens; 4 slots, 4 greedy requests
LLAMA_SERVE_NEW = (8, 6, 8, 4)
LLAMA_ENGINE_MAX_LEN = 64
LLAMA_MMLU_N, LLAMA_MMLU_BATCH = 64, 8  # synthetic examples, 0-shot
# its task-only fused training, (tokens, AdamW steps) of each arm: (a) bf16
# parameters and moments at full depth, (b) float32 parameters under bf16
# compute (the long-context path's type default) at LLAMA_F32_LAYERS layers, a
# memory cut (16 B a parameter: 3.24 GB a layer, 4.2 GB for the embedding and
# head), no remat; arm (a) at LLaMA's max_position_embeddings under the
# per-layer remat and the chunked cross entropy (LOGIT_CHUNK): without them
# bf16 state (50.2 GiB) and the activations of 1 x 1024 would need 71-76 GiB
LLAMA_TRAIN = ((2048, 3), (512, 2))
LLAMA_DENSE_STEPS = 2  # the dense yardstick of arm (a): one steady step
LLAMA_F32_LAYERS = 8
# the KD trainer at llama-7b: bf16 teacher, student and moments (62.8 GiB);
# accumulation 1 (the kd phase accumulates 8 at OPT-125m)
LLAMA_KD_T, LLAMA_KD_ACCUM, LLAMA_KD_STEPS = 512, 1, 2
# forwards timed by [opt13b-serve] and [llama7b-serve], and decode runs
# timed by [llama7b-decode] (host-bound; the run's time limit is shared)
BIG_FORWARD_ITERS, LLAMA_DECODE_REPS = 3, 2
LLAMA_KD_EVAL_WINDOWS = 2
# the bf16 ring against the unsharded bf16 kernels: the first step's loss
# within half a bf16 ulp of the loss (2^-9 of it), gradients where no top-k
# pick differs within 2e-2 of the largest (tests/test_torch_bf16.py's bound
# against JAX); layer 0's op on captured inputs and the forward's layer-0
# attention output within 1e-2 of the largest |want|
RING_BF16_LOSS_REL, RING_BF16_GRAD_REL, RING_BF16_LAYER_REL = 2.0 ** -9, 2e-2, 1e-2
# the long-context step: longctx.main's model (OPT-125m widths, 12 layers,
# use_fused_train, bf16 compute, scan_layers + scan_remat) at the length the
# JAX script's --logit-chunk help names, --logit-chunk 2048, lr 1e-5
LONGCTX_T, LONGCTX_STEPS, LONGCTX_CHUNK = 32768, 2, 2048
# queue 1 item 4's phases: LoRA at the reference's rank, B drawn N(0, 0.02²)
# (zero at init); the serving request's length; the long-context sweep at 2
# and 4 times OPT's 2048 positions; the CLI's KD updates at 1 x 512
LORA_T, LORA_R, LORA_B_SCALE, LORA_PREFILL = 2048, 32, 0.02, 1024
CSR_T = VARIANT_T = 2048
EXT_CONTEXTS, EXT_DYNAMIC_KS, EXT_QUERY_SKIPS, EXT_WINDOWS = (4096, 8192), (0, 32), (1, 2), 2
CLI_STEPS, CLI_T = 3, 512
# head width 32 (queue 2 item 6's first part): K1 at the scaling sweep's
# 1 x 4 x 1024 x 32 (T_M 32, k 8; `benchmarks.SCALING_CONFIG`) and K5 at LRA
# image's 256 x 1 x 1024 x 32 (T_M 128, k 64, `LraTrainerConfig`'s defaults);
# the image trainer's examples (1024: 4 training batches of 256 and one
# evaluation batch)
SWEEP_H, SWEEP_D = SCALING_CONFIG["num_heads"], SCALING_CONFIG["head_dim"]
SWEEP_T_M, SWEEP_K, SWEEP_T = SCALING_CONFIG["predictor_length"], SCALING_CONFIG["k"], 1024
IMAGE = LRA_TASKS["image"]
IMAGE_N, IMAGE_T, IMAGE_T_M, IMAGE_K = IMAGE.batch_size, IMAGE.max_length, 128, 64
IMAGE_N_TRAIN = 1024
# the data-parallel CLI's runs: 2 KD updates at 1 x 256
DP_STEPS, DP_T = 2, 256
# tensor parallelism ([tp]): OPT-125m's benchmark forward at 1 x TP_T over
# these LocalGroup sizes on the card, a dense KD micro-step at 1 x TP_KD_T
TP_T, TP_SIZES, TP_KD_T = 2048, (2, 4), 512
# pipelines ([pp]): OPT-125m at PP_N x PP_T in PP_M microbatches over PP_S
# stages (3 layers a stage); the interleaved run at PP_IL_S stages x PP_IL_V
# chunks
PP_N, PP_T, PP_M, PP_S, PP_IL_S, PP_IL_V = 4, 512, 4, 4, 2, 2
# [tp-serve]: [serve]'s requests through the head-sharded engine, chunk 8
TP_SERVE, TP_SERVE_CHUNK = 2, 8


def log(*a):
    print(*a, flush=True)


def require(cond, what):
    """A failed check ends the run with a non-zero exit (kept under -O)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, iters=20, warmup=3) -> float:
    """Median over `iters` CUDA-event-timed calls, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def budget_mask(N, T, seed, device, heads=H, t_m=T_M, k=K):
    """(N, heads, T, t_m) compressed mask with the production per-row
    budget round(heads·k·t_m/(r+1)), clipped to [1, heads·t_m], spread at
    random over the row's heads·t_m pixels (the schedule of bench.py,
    written out)."""
    rng = np.random.default_rng(seed)
    flat = np.zeros((N, T, heads * t_m), np.float32)
    for r in range(T):
        budget = min(max(round(heads * k * t_m / (r + 1)), 1), heads * t_m)
        for n in range(N):
            flat[n, r, rng.choice(heads * t_m, size=budget, replace=False)] = 1.0
    m = np.transpose(flat.reshape(N, T, heads, t_m), (0, 2, 1, 3)).copy()
    return torch.from_numpy(m).to(device)


def qkv(N, T, dtype, seed, device, heads=H, width=D):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((N, heads, T, width), generator=g) * 0.2
    k = torch.randn((N, heads, T, width), generator=g) * 0.2
    v = torch.randn((N, heads, T, width), generator=g)
    sc = torch.rand((N, heads, T), generator=g) * 0.9 + 0.1
    return [x.to(device, dtype) for x in (q, k, v)] + [sc.to(device)]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def reset_launches():
    """Set every kernel wrapper's launch counts to 0."""
    bs.sea_block_sparse_attention.launches = 0
    bs.bidir_forward.launches = 0
    bs.alive_mask.launches = 0
    for wrapper, *_ in (*TRAIN_KERNELS.values(), *RING_KERNELS.values()):
        wrapper.launches = 0
    for wrapper in BF16_WRAPPERS.values():
        wrapper.bf16_launches = 0
    for kernel in bs.IMPL_KERNELS.values():
        kernel.wrapper.launches = 0


def launch_counts() -> dict:
    """Launches by kernel; 'K1'-'K8' count both types, 'K1 bf16'-'K8 bf16'
    the bfloat16 instances alone."""
    return {"K1": bs.sea_block_sparse_attention.launches,
            **{kid: TRAIN_KERNELS[kid][0].launches for kid in TRAIN_KERNELS},
            "K5": bs.bidir_forward.launches,
            **{kid: RING_KERNELS[kid][0].launches for kid in RING_KERNELS},
            **{kid: bs.IMPL_KERNELS[impl].wrapper.launches
               for kid, (impl, _) in IMPL_VARIANTS.items()},
            **{f"{kid} bf16": w.bf16_launches for kid, w in BF16_WRAPPERS.items()}}


def check_grad(name, got, want) -> float:
    """|got − want| <= 1e-8 + 1e-4·max|want| and finite; returns max|err|."""
    err = max_err(got, want)
    limit = GRAD_ATOL + GRAD_RTOL * float(want.float().abs().max())
    require(bool(torch.isfinite(got).all()), f"{name}: not finite")
    require(err <= limit, f"{name}: max|err| {err:.3g} over {limit:.3g}")
    return err


def tolerance(want: torch.Tensor, dtype: torch.dtype, floor: float = F32_TOL) -> torch.Tensor:
    """Per-element limit on |kernel − plain|, `want` being the plain version
    in float32 on the kernel's inputs: `floor` (1e-5, or `f32_limit`'s) in
    float32; in bfloat16 also half a bf16 ulp of `want` (2^-8·|want|),
    since the kernel rounds its float32 result to bfloat16 once."""
    if dtype == torch.bfloat16:
        return floor + BF16_HALF_ULP * want.abs()
    return torch.full_like(want, floor)


def bound(ops: bs.KernelOperands, mask_m: torch.Tensor):
    """Least time the card needs for the function this launch computes: the
    larger of the FLOPs its alive elements need (q·k and p·v, 4·D each; the
    count is this mask's element nnz, not the kernel's visited tiles) at the
    peak for the input type, and the bytes of q, k, v, the mask bits, the
    scaler and the row bases read once and the output written once at the
    HBM rate. The tile lists are the kernel's own device, not the
    function's input, so their bytes are not counted."""
    require(ops.oversample == 1.0, "bound() counts alive elements without the keep-predicate")
    N, Hh, T, Dd = ops.shape
    flops = 4 * Dd * int(bs.mask_nnz(mask_m, ops.k.shape[1], True))
    es = ops.q.element_size()
    nbytes = (
        3 * ops.q.numel() * es  # q, k, v
        + ops.mbits.numel() * 4 + ops.scaler.numel() * 4 + ops.row_base.numel() * 4
        + ops.q.numel() * es  # out
    )
    t_ops = flops / PEAK_FLOPS[ops.q.dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def measure(q, k, v, mask, sc, **kw):
    """Kernel-only, wrapper, plain and SDPA times for one call's inputs."""
    x = bs.prepare_inputs(q, k, v, mask, sc)
    ops = bs.kernel_operands(x, kw.get("oversample", 1.0), kw.get("k_cfg", 64.0))
    ms = time_ms(lambda: bs.launch_causal_flat(ops))
    wrapper_ms = time_ms(lambda: bs.sea_block_sparse_attention(q, k, v, mask, sc, **kw))
    plain_ms = time_ms(
        lambda: bs.dense_reference(q, k, v, mask, sc.to(q.dtype), **kw), iters=5, warmup=1
    )
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
    )
    bound_ms, bound_by, flops, nbytes = bound(ops, x.mask_m)
    return dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                flops=flops, bytes=nbytes)


# ---------------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        "TF32 off for matmuls and cuDNN convolutions, bf16 matmuls reduce in float32")
    log(f"[device] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} source(s) compiled in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(_build.sources())})")
    spilled = []
    for name, text in logs.items():
        fn = None
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
                log(f"[build] {name}: {fn}")
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
                if "bytes spill stores" in line and instance_name(fn or ""):
                    if int(line.split("bytes spill stores")[0].split(",")[-1]):
                        spilled.append(fn)
    require(not spilled, f"forward- or backward-body instances that spill: {spilled}")
    tensor_core_check()
    return smi


# the forward bodies' template arguments <D, STATS, BIDIR, IMPL> as the
# mangled name spells them: `causal_tf32_wgmma_kernel`, the float32
# instances on wgmma in split TF32, `causal_flat_kernel`, K5's float32
# instance on mma.sync, and `causal_wgmma_kernel`, the bf16 ones; and the
# kernels each instance is
FLAT_INSTANCE = re.compile(
    r"causal_(tf32_wgmma|flat|wgmma)_kernelILi(32|64|80|128)ELb([01])ELb([01])ELi([0-3])EE")
BODY_TYPES = {"tf32_wgmma": "float32", "flat": "float32", "wgmma": "bfloat16"}
INSTANCE_KIDS = {(0, 0, 0): "K1", (1, 0, 0): "K2/K6", (0, 1, 0): "K5",
                 (0, 0, 1): "K9a", (0, 0, 2): "K9b", (0, 0, 3): "K9c"}
# the backward bodies `causal_dq_f32_wgmma_kernel<D>` and
# `causal_dkv_f32_wgmma_kernel<D>`, the float32 instances on wgmma in three
# bf16 terms, and `causal_dq_wgmma_kernel<D>` and `causal_dkv_wgmma_kernel<D>`,
# the bf16 ones (a float32 instance on mma.sync would be `causal_dq_kernel<D>`
# or `causal_dkv_kernel<D>`: none is left); and the kernels each is
DIFF_INSTANCE = re.compile(r"causal_(dq|dkv)_(f32_wgmma_|wgmma_)?kernelILi(64|80|128)EE")
DIFF_KIDS = {"dq": "K3/K7", "dkv": "K4/K8"}
DIFF_TYPES = {"wgmma_": "bfloat16", "f32_wgmma_": "float32", None: "float32"}
# at widths 80 (OPT-2.7b) and 128 (LLaMA-7b and 13b) only K1-K4 have
# instances: the windows (K6-K8), K5 and K9a-c take 64 alone, so an instance
# shared at 64 is K1-K4's alone there; at 32 K1 (the scaling sweep) and K5
# (LRA image) alone
WIDE_KIDS = {"K1": "K1", "K2/K6": "K2", "K3/K7": "K3", "K4/K8": "K4"}
NARROW_KIDS = ("K1", "K5")
DTYPE_NAMES = ("float32", "bfloat16")


def instance_name(mangled: str):
    """'<kernels> <type> D<width>' of a forward- or backward-body instance
    from its mangled name; None for any other function."""
    found = FLAT_INSTANCE.search(mangled)
    if found:
        body, width, stats, bidir, impl = found.groups()
        kid, dtype = INSTANCE_KIDS[int(stats), int(bidir), int(impl)], BODY_TYPES[body]
    else:
        found = DIFF_INSTANCE.search(mangled)
        if not found:
            return None
        kid, width = DIFF_KIDS[found.group(1)], found.group(3)
        dtype = DIFF_TYPES[found.group(2)]
    if width not in ("32", "64"):
        kid = WIDE_KIDS.get(kid, kid)
    return f"{kid} {dtype} D{width}"


def required_instances() -> set:
    """The instances (as `instance_name` names them) that the entry points
    launch: every one of the forward body's and the backward bodies' in
    both types at width 64, K1-K4's in both types at widths 80 and 128, and
    K1's and K5's at 32."""
    kids = [*INSTANCE_KIDS.values(), *DIFF_KIDS.values()]
    return {f"{kid} {dt} D{width}" for dt in DTYPE_NAMES
            for width, names in (("32", NARROW_KIDS), ("64", kids),
                                 ("80", WIDE_KIDS.values()), ("128", WIDE_KIDS.values()))
            for kid in names}


def tensor_core_op(function: str) -> str:
    """The tensor-core instruction a body instance must contain: wgmma's
    (HGMMA) in the bodies on wgmma (both forward bodies, both backward ones),
    mma.sync's (HMMA) in the float32 one on mma.sync (K5's forward)."""
    return "HGMMA" if "wgmma_kernel" in function else "HMMA"


def tensor_core_check():
    """Count the tensor-core instructions of every instance of the forward
    and backward bodies in the built libraries' SASS (`cuobjdump -sass`):
    every instance the entry points launch must be there, each one on wgmma
    (`causal_wgmma_kernel`, `causal_tf32_wgmma_kernel`,
    `causal_dq_wgmma_kernel`, `causal_dkv_wgmma_kernel`,
    `causal_dq_f32_wgmma_kernel`, `causal_dkv_f32_wgmma_kernel`) with HGMMA,
    the float32 one on mma.sync (`causal_flat_kernel`, K5's) with HMMA."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    counts, ops, name, op = {}, {}, None, None
    for lib in ("block_sparse_causal", "block_sparse_diff"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build._target(lib))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        for line in sass.splitlines():
            if "Function :" in line:
                name = instance_name(line)
                op = tensor_core_op(line)
                if name:
                    counts[name] = 0
                    ops[name] = op
            elif name and op in line:
                counts[name] += 1
    log(f"[device] tensor-core instructions by body instance (HGMMA in the bodies on wgmma, "
        f"HMMA in K5's float32 one on mma.sync): {counts}")
    f32_bwd = sorted(n for n in ops if n.startswith(("K3", "K4")) and "float32" in n)
    log(f"[device] float32 backward instances on wgmma (HGMMA): "
        f"{[n for n in f32_bwd if ops[n] == 'HGMMA']}; kept on mma.sync (HMMA): "
        f"{[n for n in f32_bwd if ops[n] == 'HMMA']}")
    require(set(counts) == required_instances(), f"body instances in the SASS: {sorted(counts)}")
    require(all(counts.values()), f"instances without tensor-core instructions: {counts}")


def phase_sort():
    """torch.sort(stable=True) on the card ranks ties as on the CPU, with
    +0.0 and -0.0 among them, at the grouped top-k's row width (H·T_M)."""
    g = torch.Generator().manual_seed(5)
    x = (torch.randint(0, 6, (64, H * T_M), generator=g) / 8.0).float()
    x[:, ::7] = 0.0
    x[:, 3::11] = -0.0
    cpu = _ranks_desc(x)
    gpu = _ranks_desc(x.cuda()).cpu()
    bad = int((cpu != gpu).sum())
    log(f"[sort] stable ranks on ties, cuda vs cpu: {bad} mismatches")
    require(bad == 0, "torch.sort ranks differ between the card and the CPU")


def phase_mask():
    dev = "cuda"
    g = torch.Generator().manual_seed(1)
    pix = torch.arange(T_M)
    for T in (128, 1000, 1024, 4096, 8192):
        masks = {
            "even": (pix % 2 == 0).float().expand(1, 1, T, T_M),
            "odd": (pix % 2 == 1).float().expand(1, 1, T, T_M),
            "random": (torch.rand((1, 1, T, T_M), generator=g) < 0.3).float(),
        }
        for name, m in masks.items():
            m = m.contiguous().to(dev)
            got = bs.alive_mask(m, T)
            want = bs.element_mask_int8(m, T, True)
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            log(f"[mask] T={T} {name}: {bad} mismatches of {T * T} elements")
            require(bad == 0, f"alive_mask != element_mask_int8 at T={T} ({name})")
    # the forward kernels' pixels: quotients from the row's reciprocal, which
    # must be IEEE division's bit for bit on every row width they can meet
    # and the bf16 body's alive words, built from run boundaries, against
    # each column's pixel
    bad, words = bs.quotient_mismatches(QUOT_W_MAX, dev)
    log(f"[mask] reciprocal quotients vs IEEE division, x = s + 0.5 and s + 1 for every "
        f"0 <= s < w <= {QUOT_W_MAX}: {bad} mismatches of {QUOT_W_MAX * (QUOT_W_MAX + 1)}")
    log(f"[mask] alive words vs the per-column pixel map, every row width w <= {QUOT_W_MAX}, "
        f"T_M 128/256/512, causal and bidirectional, even and odd pixels alive: {words} "
        f"mismatches of {12 * QUOT_W_MAX * (QUOT_W_MAX + 1) // 2} columns")
    require(bad == 0, "the forward's reciprocal quotients differ from IEEE division")
    require(words == 0, "the bf16 body's alive words differ from the per-column pixel map")


def phase_kernel():
    dev = "cuda"
    for T in (1024, 2048, 4096):
        mask = budget_mask(1, T, seed=T, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, sc = qkv(1, T, dtype, seed=T, device=dev)
            got = bs.sea_block_sparse_attention(q, k, v, mask, sc)
            # the plain version in float32 on the same (rounded) inputs
            want = bs.dense_reference(q.float(), k.float(), v.float(), mask,
                                      sc.to(dtype).float())
            diff = (got.float() - want).abs()
            err = float(diff.max())
            over = float((diff - tolerance(want, dtype)).max())
            m = measure(q, k, v, mask, sc)
            log(f"[kernel] T={T} {str(dtype)[6:]}: max|err|={err:.3g} "
                f"(margin to tol {-over:.3g}) "
                f"kernel {m['ms']:.4f} ms (with prep {m['wrapper_ms']:.4f}), "
                f"plain {m['plain_ms']:.3f} ms, sdpa {m['library_ms']:.4f} ms, "
                f"bound {m['bound_ms']:.4f} ms by {m['bound_by']} "
                f"({m['flops'] / 1e9:.4f} GFLOP, {m['bytes'] / 1e6:.2f} MB)")
            require(over <= 0, f"kernel vs plain at T={T} {dtype}: {err}")

    # edge cases, float32
    q, k, v, sc = qkv(1, 1024, torch.float32, seed=7, device=dev)
    mask = budget_mask(1, 1024, seed=7, device=dev)
    empty = mask.clone()
    empty[:, :, 300:400] = 0.0
    got = bs.sea_block_sparse_attention(q, k, v, empty, sc)
    err = max_err(got, bs.dense_reference(q, k, v, empty, sc))
    zero = float(got[:, :, 300:400].abs().max())
    log(f"[kernel] empty rows: max|err|={err:.3g}, |out| on empty rows {zero}")
    require(err <= F32_TOL and zero == 0.0, f"empty rows: err {err}, |out| {zero}")

    kw = dict(oversample=2.0, k_cfg=64.0)
    got = bs.sea_block_sparse_attention(q, k, v, mask, sc, **kw)
    err = max_err(got, bs.dense_reference(q, k, v, mask, sc, **kw))
    log(f"[kernel] oversample=2.0 k_cfg=64: max|err|={err:.3g}")
    require(err <= F32_TOL, f"oversample: err {err}")

    q1, k1, v1, sc1 = qkv(1, 1000, torch.float32, seed=8, device=dev)
    m1 = budget_mask(1, 1000, seed=8, device=dev)
    got = bs.sea_block_sparse_attention(q1, k1, v1, m1, sc1)
    err = max_err(got, bs.dense_reference(q1, k1, v1, m1, sc1))
    log(f"[kernel] T=1000 (padded to 1024): max|err|={err:.3g}, shape {tuple(got.shape)}")
    require(err <= F32_TOL and got.shape[2] == 1000, f"T=1000: err {err}")

    # a sequence shard: local rows 0..1023 are global rows 1024..2047
    row_base = torch.arange(16, dtype=torch.int32, device=dev) * 64 + 1024
    got = bs.sea_block_sparse_attention(q, k, v, mask, sc, row_base=row_base)
    widths = (torch.arange(1024, device=dev) + 1025).float()
    err = max_err(got, bs.dense_reference(q, k, v, mask, sc, row_widths=widths))
    log(f"[kernel] row_base=1024: max|err|={err:.3g}")
    require(err <= F32_TOL, f"row_base: err {err}")
    return phase_kernel_wide()


def phase_kernel_wide():
    """K1 at OPT-2.7b's layer geometry (1 x 32 x T x 80) and LLaMA-7b's (1 x
    32 x T x 128) in both types, with the gates of width 64: the element mask
    bit for bit, the plain version, the 128 x 256 lists equal to the 64 x 64
    ones bit for bit, and rows with nothing alive. Returns {(width, dtype):
    max|err|}."""
    dev = "cuda"
    errs = {}
    for width in (WIDE_D, LLAMA_D):
        wide = dict(heads=WIDE_H, width=width)
        for dtype in (torch.float32, torch.bfloat16):
            errs[width, dtype] = 0.0
        for T in WIDE_TS:
            mask = budget_mask(1, T, seed=T + width, device=dev, heads=WIDE_H)
            bad = int((bs.alive_mask(mask, T) != bs.element_mask_int8(mask, T, True)).sum())
            require(bad == 0, f"alive_mask != element_mask_int8 on the width-{width} mask at T={T}")
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, sc = qkv(1, T, dtype, seed=T + width, device=dev, **wide)
                got = bs.sea_block_sparse_attention(q, k, v, mask, sc)
                want = bs.dense_reference(q.float(), k.float(), v.float(), mask,
                                          sc.to(dtype).float())
                diff = (got.float() - want).abs()
                over = float((diff - tolerance(want, dtype)).max())
                other = bs.sea_block_sparse_attention(q, k, v, mask, sc, block_q=128, block_k=256)
                log(f"[kernel] width {width}, 1x{WIDE_H}x{T}x{width} {str(dtype)[6:]}: max|err|="
                    f"{float(diff.max()):.3g} (margin to tol {-over:.3g}); element mask "
                    f"{bad} mismatches; blocks 128 x 256 equal to 64 x 64: {torch.equal(got, other)}")
                require(over <= 0 and got.dtype == dtype,
                        f"width-{width} K1 vs plain at T={T} {dtype}")
                require(torch.equal(got, other),
                        f"width-{width} K1 depends on the block sizes at T={T}")
                errs[width, dtype] = max(errs[width, dtype], float(diff.max()))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, sc = qkv(1, 1024, dtype, seed=7, device=dev, **wide)
            empty = budget_mask(1, 1024, seed=7, device=dev, heads=WIDE_H)
            empty[:, :, 300:400] = 0.0
            got = bs.sea_block_sparse_attention(q, k, v, empty, sc)
            want = bs.dense_reference(q.float(), k.float(), v.float(), empty,
                                      sc.to(dtype).float())
            ok = bool(((got.float() - want).abs() <= tolerance(want, dtype)).all())
            zero = float(got[:, :, 300:400].abs().max())
            log(f"[kernel] width {width} {str(dtype)[6:]} empty rows: within tolerance {ok}, "
                f"|out| on empty rows {zero}")
            require(ok and zero == 0.0, f"width-{width} empty rows {dtype}")
            errs[width, dtype] = max(errs[width, dtype], max_err(got, want))
    return errs


def forward_ms(model, *inputs, iters=7):
    """Median host ms of one forward ending in a synchronise, after one
    warm-up forward; also the last logits."""
    times = []
    for i in range(iters + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(*inputs, benchmarking=True)["logits"]
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def infer(model, *inputs):
    """One benchmark-path forward under inference mode: the logits."""
    with torch.inference_mode():
        return model(*inputs, benchmarking=True)["logits"]


def host_ms(fn, iters):
    """Median host ms of `fn()` ending in a synchronise, after one warm-up."""
    times = []
    for i in range(iters + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def layer0_k1(phase, run):
    """Run `run()` (a benchmark-path forward) with the buffer registry on, then
    hold layer 0's grouped top-k on the card to the CPU's on the same
    estimates and K1 on layer 0's captured inputs to its plain version.
    Returns (q, k, v, mask, scaler, max|err|)."""
    bench = get_bench()
    bench.activate_temp_buffers(True)
    run()
    buf = {n: bench.get_temp_buffer(n, 0) for n in (
        "q_for_score", "k_for_score", "v", "partial_attention_mask_before_interp",
        "estimated_scales", "masked_estimated_attention_probs", "per_item_top_k")}
    bench.activate_temp_buffers(False)
    # the grouped top-k on the card against the CPU on the same estimates
    probs = buf["masked_estimated_attention_probs"]
    cpu_mask = topk_mask(
        probs.cpu(), torch.ones((probs.shape[0], 1, probs.shape[2], 1), dtype=torch.bool),
        buf["per_item_top_k"].cpu(), "causal_batch", True, fp_min_for(probs.dtype),
    )
    bad = int((cpu_mask != buf["partial_attention_mask_before_interp"].cpu()).sum())
    log(f"[{phase}] layer-0 top-k mask, card vs CPU on the same estimates: "
        f"{bad} mismatches of {cpu_mask.numel()}")
    require(bad == 0, "top-k masks differ between the card and the CPU")
    q, k, v = buf["q_for_score"], buf["k_for_score"], buf["v"]
    mask = (buf["partial_attention_mask_before_interp"] > 0).to(q.dtype)
    sc = torch.sigmoid(buf["estimated_scales"][..., 0])
    got = bs.sea_block_sparse_attention(q, k, v, mask, sc, k_cfg=float(K))
    # the plain version in float32 on the same values (bf16 inputs upcast)
    want = bs.dense_reference(q.float(), k.float(), v.float(), mask.float(),
                              sc.to(q.dtype).float(), k_cfg=float(K))
    err = max_err(got, want)
    density = float(bs.mask_nnz(mask, q.shape[2], True)) / (
        q.shape[0] * q.shape[1] * q.shape[2] * (q.shape[2] + 1) / 2)
    log(f"[{phase}] layer-0 kernel inputs {tuple(q.shape)} {str(q.dtype)[6:]}: kernel vs "
        f"plain max|err|={err:.3g}; element-mask density {density:.4f} of the causal triangle")
    require(bool(((got.float() - want).abs() <= tolerance(want, q.dtype)).all()),
            f"kernel vs plain on layer-0 inputs: {err}")
    return q, k, v, mask, sc, err


def phase_slice():
    dev = "cuda"
    cfg = opt_125m("perlin")
    t0 = time.perf_counter()
    model = OptForCausalLM(cfg, device=dev, seed=0).eval()
    dense = OptForCausalLM(dataclasses.replace(cfg, attention_method="none"),
                           device=dev, seed=0).eval()
    torch.cuda.synchronize()
    log(f"[slice] OPT-125m perlin + dense built on {dev} in "
        f"{time.perf_counter() - t0:.1f} s ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)")
    g = torch.Generator().manual_seed(11)
    requests = [
        torch.randint(4, cfg.vocab_size, (2, 1024), generator=g),
        torch.randint(4, cfg.vocab_size, (1, 2048), generator=g),
    ]
    requests = [r.to(dev) for r in requests]

    # the main path: every request once, kernel launches counted around it
    reset_launches()
    outs = []
    per_forward = []
    for ids in requests:
        before = bs.sea_block_sparse_attention.launches
        with torch.inference_mode():
            outs.append(model(ids, torch.ones_like(ids), benchmarking=True)["logits"])
        per_forward.append(bs.sea_block_sparse_attention.launches - before)
    torch.cuda.synchronize()
    launches = bs.sea_block_sparse_attention.launches
    others = {kid: n for kid, n in launch_counts().items() if kid != "K1"}
    require(not any(others.values()), f"the serving path launched other kernels: {others}")
    for ids, logits, n in zip(requests, outs, per_forward):
        finite = bool(torch.isfinite(logits).all())
        log(f"[slice] request {tuple(ids.shape)}: logits {tuple(logits.shape)} "
            f"finite={finite}, kernel launches {n}")
        require(finite and logits.shape == (*ids.shape, cfg.vocab_size),
                f"logits of request {tuple(ids.shape)}")
        require(n == cfg.num_layers, f"{n} kernel launches in one forward, not {cfg.num_layers}")
    log(f"[slice] main path: {launches} launches of sea_causal_flat_forward, "
        f"{bs.alive_mask.launches} of alive_mask")

    # layer 0's kernel inputs, captured by the buffer registry from the run
    checks = []
    for ids in requests:
        def forward():
            with torch.inference_mode():
                model(ids, torch.ones_like(ids), benchmarking=True)

        checks.append(layer0_k1("slice", forward))

    for ids in requests:
        am = torch.ones_like(ids)
        sea_ms, sea_out = forward_ms(model, ids, am)
        dense_ms, dense_out = forward_ms(dense, ids, am)
        require(bool(torch.isfinite(dense_out).all()), "dense logits not finite")
        ntok = ids.numel()
        log(f"[slice] forward {tuple(ids.shape)}: SEA {sea_ms:.2f} ms "
            f"({ntok / sea_ms * 1e3:.0f} tokens/s), dense OPT-125m {dense_ms:.2f} ms "
            f"({ntok / dense_ms * 1e3:.0f} tokens/s)")
    ids = requests[-1]

    def forward():
        with torch.inference_mode():
            model(ids, torch.ones_like(ids), benchmarking=True)

    breakdown(f"forward {tuple(ids.shape)}", forward)
    return launches, checks


def breakdown(label, run):
    """Where the time of `run()` (one forward, or one train step) goes: the
    SEA attention's forward stages by host region with a device synchronise
    at each region's start and end, then the device kernels by self time from
    torch.profiler, and the device's busy share."""
    bench = get_bench()
    bench.reset()
    bench.synchronize = True
    bench.activate_temp_buffers(True)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    bench.activate_temp_buffers(False)
    bench.synchronize = False
    log(f"[breakdown] {label} with synchronised regions: {wall:.2f} ms; "
        "SEA attention forward stages summed over the 12 layers:")
    for line in bench.format_tracetree().splitlines():
        log(f"[breakdown]   {line}")
    bench.reset()

    from torch.profiler import ProfilerActivity, profile

    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True
    ) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side entries only: an aten op's self device time repeats the
    # time of the kernels it launched, which are listed too, and so does a
    # user annotation's range on the device (the optimizer's step)
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[breakdown] profiled {label} {wall:.2f} ms wall, {sum(e.count for e in kernels)} "
        f"kernel launches, device busy {busy:.2f} ms ({100 * busy / wall:.1f}%, idle "
        f"{100 - 100 * busy / wall:.1f}%); top kernels by device time:")
    for e in kernels[:12]:
        log(f"[breakdown]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")


# ---------------------------------------------------------------------------
# The differentiable path: forward with stats (K2), dq (K3), dk/dv (K4)
# ---------------------------------------------------------------------------


def diff_bound(kid, ops: bs.KernelOperands, mask_m):
    """Least time the card needs for the function one launch of `kid`
    computes: the larger of its FLOPs on the alive elements (per element 4·D
    for K2: q·k, p·v; 6·D for K3: q·k, dO·v, ds·k; 8·D for K4: q·k, dO·v,
    dsᵀ·q, pᵀ·dO; the count is this mask's element nnz) at the peak for the
    operands' type (the float32 FMA pipes, bf16's tensor cores), and its
    bytes (each operand read once, each output written once; q, k, v, dO
    and the outputs in the operands' type, the scaler, lse and delta
    float32) at the HBM rate. The tile lists are the kernels' own device and
    are not counted."""
    N, Hh, T, Dd = ops.shape
    flops = TRAIN_KERNELS[kid][4] * Dd * int(bs.mask_nnz(mask_m, ops.k.shape[1], True))
    tile = N * Hh * T * Dd * ops.q.element_size()  # one (NH, T, D) tensor
    row = N * Hh * T * 4  # one (NH, T) float32 tensor
    nbytes = ops.mbits.numel() * 4 + ops.row_base.numel() * 4 + 3 * tile + {
        "K2": row + tile + row,  # scaler; out, lse
        "K3": tile + 2 * row + tile,  # dO·scaler, lse, delta; dq
        "K4": tile + 2 * row + 2 * tile,  # dO·scaler, lse, delta; dk, dv
    }[kid]
    t_ops = flops / PEAK_FLOPS[ops.q.dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def diff_operands(q, k, v, mask, sc):
    return bs.kernel_operands(bs.prepare_inputs(q, k, v, mask, sc), differentiable=True)


def f32_limit(want: torch.Tensor, scaled: bool) -> float:
    """The float32 gate on |kernel − plain| for a result `want`: 1e-5, or
    with `scaled` 1e-5 of max|want| where that exceeds 1 (the same relative
    precision on data above unit scale, where split TF32's 2^-21 a product
    and the sums' order grow with the values; OPT-2.7b's float32 layer 0)."""
    return F32_TOL * max(1.0, float(want.abs().max())) if scaled else F32_TOL


def check_train_kernels(label, q, k, v, mask, sc, do, scaled=False):
    """K2, K3 and K4 against their plain versions on one set of inputs. K3
    and K4 read the plain version's lse and backward terms, so that each
    kernel is held alone; K2's gate is `f32_limit`'s. Returns {kernel:
    max|err|}."""
    ops = diff_operands(q, k, v, mask, sc)
    o, lse = bs.causal_fwd_stats(ops)
    want_o, want_lse = bs.fwd_with_stats_reference(q, k, v, mask, sc)
    torch.cuda.synchronize()
    inf = torch.isinf(want_lse)
    require(torch.equal(torch.isinf(lse), inf) and bool((lse[inf] > 0).all()),
            f"{label}: the +inf rows of lse differ")
    fin = want_lse[~inf] if bool((~inf).any()) else torch.zeros(1, device=lse.device)
    err_lse = max_err(lse[~inf], want_lse[~inf]) if bool((~inf).any()) else 0.0
    err_o = max_err(o, want_o)
    lim_o, lim_lse = f32_limit(want_o, scaled), f32_limit(fin, scaled)
    if scaled:
        log(f"[train-kernels] {label}: max|o| {float(want_o.abs().max()):.4g}, max|lse| "
            f"{float(fin.abs().max()):.4g}: K2's gates {lim_o:.3g} and {lim_lse:.3g}")
    require(err_o <= lim_o and err_lse <= lim_lse,
            f"{label}: K2 o err {err_o:.3g}, lse err {err_lse:.3g}")
    _, dou, delta = bs.backward_terms(do, want_o, sc, torch.float32)
    dq = bs.causal_dq(ops, dou, want_lse, delta)
    dk, dv = bs.causal_dkv(ops, dou, want_lse, delta)
    # run to run: no atomics and every sum in a fixed order, so the same bits
    again = (bs.causal_dq(ops, dou, want_lse, delta), *bs.causal_dkv(ops, dou, want_lse, delta))
    require(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
            f"{label}: two launches of K3 or K4 on the same operands differ")
    want_dk, want_dv = bs.dkv_reference(q, k, v, mask, dou, want_lse, delta)
    errs = {
        "K2": max(err_o, err_lse),
        "K3": check_grad(f"{label} K3 dq", dq, bs.dq_reference(q, k, v, mask, dou, want_lse, delta)),
        "K4": max(check_grad(f"{label} K4 dk", dk, want_dk), check_grad(f"{label} K4 dv", dv, want_dv)),
    }
    log(f"[train-kernels] {label}: K2 o {err_o:.3g}, lse {err_lse:.3g} ({int(inf.sum())} "
        f"+inf rows); K3 dq {errs['K3']:.3g}; K4 dk/dv {errs['K4']:.3g} (max|err| vs plain); "
        "two launches of K3 and of K4 equal bit for bit")
    return errs


def autograd_outputs(fn, q, k, v, sc, do):
    """fn(q, k, v, sc)'s output and the gradients of <output, do> for q, k,
    v and sc."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, sc)]
    o = fn(*leaves)
    return (o.detach(), *torch.autograd.grad(o, leaves, do))


def check_fused_backward(label, q, k, v, mask, sc, do, scaled=False, **blocks):
    """The whole FusedSparseAttention (K2 forward; K3, K4 backward) against
    autograd through `dense_reference`, the output by `f32_limit`'s gate.
    Returns its outputs."""
    got = autograd_outputs(
        lambda *a: bs.fused_sparse_attention(a[0], a[1], a[2], mask, a[3], **blocks),
        q, k, v, sc, do)
    want = autograd_outputs(
        lambda *a: bs.dense_reference(a[0], a[1], a[2], mask, a[3]), q, k, v, sc, do)
    err_o = max_err(got[0], want[0])
    require(err_o <= f32_limit(want[0], scaled), f"{label}: fused output err {err_o:.3g}")
    errs = [check_grad(f"{label} fused {n}", g, w)
            for n, g, w in zip(("dq", "dk", "dv", "dscaler"), got[1:], want[1:])]
    log(f"[train-kernels] {label}: FusedSparseAttention vs autograd through dense_reference "
        f"{blocks or ''}: o {err_o:.3g}, dq {errs[0]:.3g}, dk {errs[1]:.3g}, dv {errs[2]:.3g}, "
        f"dscaler {errs[3]:.3g}")
    return got


def measure_train(q, k, v, mask, sc, do):
    """Kernel, plain and library times of K2, K3 and K4 on one set of inputs
    (float32 or bfloat16), with their bounds. The library call is
    F.scaled_dot_product_attention at the same shape and type (dense
    causal): its forward for K2, and its backward alone, timed once, for the
    pair K3 and K4."""
    ops = diff_operands(q, k, v, mask, sc)
    o, lse = bs.causal_fwd_stats(ops)
    _, dou, delta = bs.backward_terms(do, o, sc, q.dtype)
    qq, kk, vv = (x.detach().clone().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(sdpa_out, (qq, kk, vv), do, retain_graph=True))
    plain = dict(iters=5, warmup=1)
    out = {
        "K2": dict(
            ms=time_ms(lambda: bs.causal_fwd_stats(ops)),
            plain_ms=time_ms(lambda: bs.fwd_with_stats_reference(q, k, v, mask, sc), **plain),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
        ),
        "K3": dict(
            ms=time_ms(lambda: bs.causal_dq(ops, dou, lse, delta)),
            plain_ms=time_ms(lambda: bs.dq_reference(q, k, v, mask, dou, lse, delta), **plain),
            library_ms=sdpa_bwd,
        ),
        "K4": dict(
            ms=time_ms(lambda: bs.causal_dkv(ops, dou, lse, delta)),
            plain_ms=time_ms(lambda: bs.dkv_reference(q, k, v, mask, dou, lse, delta), **plain),
            library_ms=sdpa_bwd,
        ),
    }
    for kid, m in out.items():
        m["bound_ms"], m["bound_by"], m["flops"], m["bytes"] = diff_bound(kid, ops, mask)
    return out


def log_times(label, m):
    for kid, t in m.items():
        log(f"[train-kernels] {label} {kid}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, "
            f"sdpa {'fwd' if kid == 'K2' else 'bwd'} {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({t['flops'] / 1e9:.4f} GFLOP, "
            f"{t['bytes'] / 1e6:.2f} MB)")


def phase_train_kernels():
    dev = "cuda"
    for T in CHECK_TS:
        mask = budget_mask(1, T, seed=T, device=dev)
        q, k, v, sc = qkv(1, T, torch.float32, seed=T, device=dev)
        do = torch.randn(q.shape, generator=torch.Generator().manual_seed(T + 1)).to(dev)
        check_train_kernels(f"T={T}", q, k, v, mask, sc, do)
        got = check_fused_backward(f"T={T}", q, k, v, mask, sc, do)
        if T == CHECK_TS[1]:
            other = check_fused_backward(f"T={T}", q, k, v, mask, sc, do, block_q=128, block_k=256)
            diff = max(max_err(a, b) for a, b in zip(got, other))
            log(f"[train-kernels] T={T}: blocks 128 x 256 vs 64 x 64, max|diff| {diff:.3g}")
            require(diff == 0.0, f"the result depends on the block sizes: {diff}")
        log_times(f"T={T}", measure_train(q, k, v, mask, sc, do))

    # edge cases, float32
    q, k, v, sc = qkv(1, 1024, torch.float32, seed=7, device=dev)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(9)).to(dev)
    mask = budget_mask(1, 1024, seed=7, device=dev)
    empty = mask.clone()
    empty[:, :, 300:400] = 0.0
    check_train_kernels("empty rows 300-399", q, k, v, empty, sc, do)
    o, dq, dk, dv, dsc = check_fused_backward("empty rows 300-399", q, k, v, empty, sc, do)
    _, lse = bs.causal_fwd_stats(diff_operands(q, k, v, empty, sc))
    zero = max(float(o[:, :, 300:400].abs().max()), float(dq[:, :, 300:400].abs().max()))
    finite = all(bool(torch.isfinite(x).all()) for x in (o, dq, dk, dv, dsc))
    log(f"[train-kernels] empty rows: lse +inf on all of them: "
        f"{bool(torch.isposinf(lse[:, :, 300:400]).all())}; |o|, |dq| there {zero}; "
        f"all finite {finite}")
    require(bool(torch.isposinf(lse[:, :, 300:400]).all()) and zero == 0.0 and finite,
            "empty rows: lse, zero rows or NaN")

    q1, k1, v1, sc1 = qkv(1, 128, torch.float32, seed=8, device=dev)
    do1 = torch.randn(q1.shape, generator=torch.Generator().manual_seed(10)).to(dev)
    m1 = budget_mask(1, 128, seed=8, device=dev)
    check_train_kernels("T=128", q1, k1, v1, m1, sc1, do1)
    check_fused_backward("T=128", q1, k1, v1, m1, sc1, do1)

    full = torch.ones_like(mask)
    check_train_kernels("every pixel on", q, k, v, full, sc, do)
    check_fused_backward("every pixel on", q, k, v, full, sc, do)

    # OPT-2.7b's and LLaMA-7b's layer geometries, 1 x 32 x T x 80 and x 128
    return {width: wide_train_kernels(width) for width in (WIDE_D, LLAMA_D)}


def wide_train_kernels(width):
    """The float32 K2-K4 checks of `phase_train_kernels` at 1 x 32 x T x
    `width` for T in WIDE_TS (blocks 128 x 256 against 64 x 64 at each),
    and on a band of empty rows; at LLaMA-7b's width 128 the kernels are also
    timed at T = WIDE_TS[-1] beside SDPA. Returns {kernel: max|err|}."""
    dev = "cuda"
    wide = dict(heads=WIDE_H, width=width)
    errs = dict.fromkeys(TRAIN_KERNELS, 0.0)
    for T in WIDE_TS:
        mask = budget_mask(1, T, seed=T + width, device=dev, heads=WIDE_H)
        q, k, v, sc = qkv(1, T, torch.float32, seed=T + width, device=dev, **wide)
        do = torch.randn(q.shape, generator=torch.Generator().manual_seed(T + 1)).to(dev)
        e = check_train_kernels(f"width {width} T={T}", q, k, v, mask, sc, do)
        errs = {kid: max(errs[kid], e[kid]) for kid in errs}
        got = check_fused_backward(f"width {width} T={T}", q, k, v, mask, sc, do)
        other = check_fused_backward(f"width {width} T={T}", q, k, v, mask, sc, do,
                                     block_q=128, block_k=256)
        diff = max(max_err(a, b) for a, b in zip(got, other))
        log(f"[train-kernels] width {width} T={T}: blocks 128 x 256 vs 64 x 64, max|diff| "
            f"{diff:.3g}")
        require(diff == 0.0, f"width {width}: the result depends on the block sizes: {diff}")
        del got, other
        if width == LLAMA_D and T == WIDE_TS[-1]:
            log_times(f"width {width} T={T}", measure_train(q, k, v, mask, sc, do))
    q, k, v, sc = qkv(1, 1024, torch.float32, seed=7, device=dev, **wide)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(9)).to(dev)
    empty = budget_mask(1, 1024, seed=7, device=dev, heads=WIDE_H)
    empty[:, :, 300:400] = 0.0
    e = check_train_kernels(f"width {width} empty rows 300-399", q, k, v, empty, sc, do)
    errs = {kid: max(errs[kid], e[kid]) for kid in errs}
    o, dq, dk, dv, dsc = check_fused_backward(f"width {width} empty rows 300-399", q, k, v,
                                              empty, sc, do)
    _, lse = bs.causal_fwd_stats(diff_operands(q, k, v, empty, sc))
    zero = max(float(o[:, :, 300:400].abs().max()), float(dq[:, :, 300:400].abs().max()))
    require(bool(torch.isposinf(lse[:, :, 300:400]).all()) and zero == 0.0
            and all(bool(torch.isfinite(x).all()) for x in (o, dq, dk, dv, dsc)),
            f"width-{width} empty rows: lse, zero rows or NaN")
    return errs


# ---------------------------------------------------------------------------
# bfloat16 K2-K4
# ---------------------------------------------------------------------------


def check_grad_bf16(name, got, want) -> float:
    """A bf16 gradient against the float32 plain result on the same bf16
    operands: |got − want| <= 1e-8 + 1e-4·max|want| + half a bf16 ulp of
    want (the kernel sums in float32 and rounds once), and finite."""
    err = (got.float() - want).abs()
    limit = GRAD_ATOL + GRAD_RTOL * float(want.abs().max()) + BF16_HALF_ULP * want.abs()
    require(bool(torch.isfinite(got).all()), f"{name}: not finite")
    require(bool((err <= limit).all()),
            f"{name}: max|err| {float(err.max()):.3g}, worst margin "
            f"{float((err - limit).max()):.3g}")
    return float(err.max())


def bf16_case(T, seed, device, heads=H, width=D):
    """bf16 q, k, v, scaler and dO for 1 x T, and the budget mask."""
    q, k, v, sc = qkv(1, T, torch.bfloat16, seed, device, heads, width)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(seed + 1))
    return (q, k, v, sc.bfloat16(), do.to(device, torch.bfloat16),
            budget_mask(1, T, seed, device, heads))


def bf16_kernel_outputs(q, k, v, mask, sc, do, lse, delta, dou, **blocks):
    """K2's (o, lse), then K3 and K4 on the given lse and backward terms:
    (o, lse, dq, dk, dv)."""
    ops = bs.kernel_operands(bs.prepare_inputs(q, k, v, mask, sc, **blocks), differentiable=True)
    o, lse_k = bs.causal_fwd_stats(ops)
    return (o, lse_k, bs.causal_dq(ops, dou, lse, delta), *bs.causal_dkv(ops, dou, lse, delta))


def check_bf16_kernels(label, q, k, v, mask, sc, do, scaled=False):
    """K2, K3 and K4 in bf16 against their plain versions on the same bf16
    operands: o within 1e-5 plus half a bf16 ulp of the float32 plain
    result, lse within 1e-5 (with `scaled`, o's 1e-5 is `f32_limit`'s: 1e-5
    of max|want| where that exceeds 1, the float32 sum before the rounding
    being as far from the plain one as on float32 data of that scale; lse's
    is LSE_ULPS float32 ulps of max|lse| where that exceeds 1e-5), each
    gradient within 1e-4·max|want| plus half a bf16 ulp. K3 and K4 read the
    plain version's lse and the backward terms as the path computes them
    (dou in bf16, delta float32), so that each kernel is held alone; two launches of each, and the 128 x 256
    lists against the 64 x 64 ones, give the same bits. Returns ({kernel:
    max|err|}, the kernels' outputs)."""
    f = [x.float() for x in (q, k, v, sc)]
    want_o, want_lse = bs.fwd_with_stats_reference(f[0], f[1], f[2], mask, f[3])
    _, dou, delta = bs.backward_terms(do, want_o.to(torch.bfloat16), sc, torch.bfloat16)
    got = bf16_kernel_outputs(q, k, v, mask, sc, do, want_lse, delta, dou)
    o, lse, dq, dk, dv = got
    torch.cuda.synchronize()
    require(all(x.dtype == torch.bfloat16 for x in (o, dq, dk, dv)) and lse.dtype == torch.float32,
            f"{label}: output types {[x.dtype for x in got]}")
    inf = torch.isinf(want_lse)
    require(torch.equal(torch.isinf(lse), inf) and bool((lse[inf] > 0).all()),
            f"{label}: the +inf rows of lse differ")
    fin = want_lse[~inf] if bool((~inf).any()) else torch.zeros(1, device=lse.device)
    err_lse = max_err(lse[~inf], want_lse[~inf]) if bool((~inf).any()) else 0.0
    err_o = (o.float() - want_o).abs()
    lim_o, lim_lse = f32_limit(want_o, scaled), F32_TOL
    if scaled:
        lim_lse = max(F32_TOL, LSE_ULPS * float(np.spacing(np.float32(float(fin.abs().max())))))
        log(f"[bf16-kernels] {label}: max|o| {float(want_o.abs().max()):.4g}, max|lse| "
            f"{float(fin.abs().max()):.4g}: K2's floors {lim_o:.3g} and {lim_lse:.3g}")
    require(bool((err_o <= tolerance(want_o, torch.bfloat16, lim_o)).all())
            and err_lse <= lim_lse,
            f"{label}: K2 bf16 o err {float(err_o.max()):.3g}, lse err {err_lse:.3g}")
    want_dq = bs.dq_reference(f[0], f[1], f[2], mask, dou.float(), want_lse, delta)
    want_dk, want_dv = bs.dkv_reference(f[0], f[1], f[2], mask, dou.float(), want_lse, delta)
    errs = {
        "K2": max(float(err_o.max()), err_lse),
        "K3": check_grad_bf16(f"{label} K3 bf16 dq", dq, want_dq),
        "K4": max(check_grad_bf16(f"{label} K4 bf16 dk", dk, want_dk),
                  check_grad_bf16(f"{label} K4 bf16 dv", dv, want_dv)),
    }
    again = bf16_kernel_outputs(q, k, v, mask, sc, do, want_lse, delta, dou)
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"{label}: two launches of K2, K3 or K4 in bf16 differ")
    other = bf16_kernel_outputs(q, k, v, mask, sc, do, want_lse, delta, dou,
                                block_q=128, block_k=256)
    require(all(torch.equal(a, b) for a, b in zip(got, other)),
            f"{label}: bf16 K2-K4 at blocks 128 x 256 differ from 64 x 64")
    log(f"[bf16-kernels] {label}: K2 o {errs['K2']:.3g} (lse {err_lse:.3g}, {int(inf.sum())} "
        f"+inf rows); K3 dq {errs['K3']:.3g}; K4 dk/dv {errs['K4']:.3g} (max|err| vs the float32 "
        "plain result on the bf16 operands); two launches, and blocks 128 x 256 against "
        "64 x 64, equal bit for bit")
    return errs, got


def phase_bf16_kernels():
    """K2, K3 and K4's bf16 instances against their plain versions at
    CHECK_TS and on rows with nothing alive; times at T = CHECK_TS[1]
    beside SDPA's bf16 forward and backward; then the same checks at widths
    80 and 128 (`wide_bf16_kernels`). Returns ({kernel: max|err|} at width
    64, {width: the same} at 80 and 128)."""
    dev = "cuda"
    errs = dict.fromkeys(TRAIN_KERNELS, 0.0)
    for T in CHECK_TS:
        q, k, v, sc, do, mask = bf16_case(T, seed=T, device=dev)
        e, _ = check_bf16_kernels(f"T={T}", q, k, v, mask, sc, do)
        errs = {kid: max(errs[kid], e[kid]) for kid in errs}
        if T == CHECK_TS[1]:
            log_times(f"bf16 T={T}", measure_train(q, k, v, mask, sc, do))
    q, k, v, sc, do, mask = bf16_case(1024, seed=7, device=dev)
    mask[:, :, 300:400] = 0.0
    e, (o, lse, dq, dk, dv) = check_bf16_kernels("empty rows 300-399", q, k, v, mask, sc, do)
    errs = {kid: max(errs[kid], e[kid]) for kid in errs}
    zero = max(float(o[:, :, 300:400].abs().max()), float(dq[:, :, 300:400].abs().max()))
    finite = all(bool(torch.isfinite(x).all()) for x in (o, dq, dk, dv))
    log(f"[bf16-kernels] empty rows: lse +inf on all of them "
        f"{bool(torch.isposinf(lse[:, :, 300:400]).all())}; |o|, |dq| there {zero}; "
        f"all finite {finite}")
    require(bool(torch.isposinf(lse[:, :, 300:400]).all()) and zero == 0.0 and finite,
            "bf16 empty rows: lse, zero rows or NaN")
    # OPT-2.7b's and LLaMA-7b's layer geometries, 1 x 32 x T x 80 and x 128
    return errs, {width: wide_bf16_kernels(width) for width in (WIDE_D, LLAMA_D)}


def wide_bf16_kernels(width):
    """The bf16 K2-K4 checks of `phase_bf16_kernels` at 1 x 32 x T x
    `width` for T in WIDE_TS and on a band of empty rows; at LLaMA-7b's
    width 128 the kernels are also timed at T = WIDE_TS[-1] beside SDPA's
    bf16 forward and backward. Returns {kernel: max|err|}."""
    dev = "cuda"
    wide = dict(heads=WIDE_H, width=width)
    errs = dict.fromkeys(TRAIN_KERNELS, 0.0)
    for T in WIDE_TS:
        q, k, v, sc, do, mask = bf16_case(T, seed=T + width, device=dev, **wide)
        e, _ = check_bf16_kernels(f"width {width} T={T}", q, k, v, mask, sc, do)
        errs = {kid: max(errs[kid], e[kid]) for kid in errs}
        if width == LLAMA_D and T == WIDE_TS[-1]:
            log_times(f"bf16 width {width} T={T}", measure_train(q, k, v, mask, sc, do))
    q, k, v, sc, do, mask = bf16_case(1024, seed=7, device=dev, **wide)
    mask[:, :, 300:400] = 0.0
    e, (o, lse, dq, dk, dv) = check_bf16_kernels(f"width {width} empty rows 300-399", q, k, v,
                                                 mask, sc, do)
    errs = {kid: max(errs[kid], e[kid]) for kid in errs}
    zero = max(float(o[:, :, 300:400].abs().max()), float(dq[:, :, 300:400].abs().max()))
    require(bool(torch.isposinf(lse[:, :, 300:400]).all()) and zero == 0.0
            and all(bool(torch.isfinite(x).all()) for x in (o, dq, dk, dv)),
            f"width-{width} bf16 empty rows: lse, zero rows or NaN")
    return errs


def run_train(model, ids, steps, label, want=None, after_step=None, lr=TRAIN_LR,
              logit_chunk=None):
    """`steps` AdamW steps through `train_steps` on one batch (the chunked
    cross entropy with `logit_chunk`), the launch counts set to 0 just
    before and read after every step. Checks a finite loss and, for the SEA
    student, one launch of each of K2, K3 and K4 a layer and none of the
    other kernels per step (no kernel launch at all for the dense model), or
    the launches `want` per step. `after_step(i)` runs after step i's checks,
    outside its time. Returns (losses, ms per step, launches over the run,
    peak GiB)."""
    n_layers = model.cfg.num_layers
    sparse = model.cfg.attention_method == "perlin"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, per_step = [], []
    last = [time.perf_counter(), launch_counts()]

    def on_step(i, loss):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), launch_counts()
        times.append((now - last[0]) * 1e3)
        per_step.append({kid: counts[kid] - last[1][kid] for kid in counts})
        last[:] = [now, counts]
        log(f"[train] {label} step {i + 1}: loss {loss:.6f}, {times[-1]:.2f} ms "
            f"({ids.numel() / times[-1] * 1e3:.0f} tokens/s), launches {per_step[-1]}")
        if after_step is not None:
            after_step(i)
            torch.cuda.synchronize()
            last[:] = [time.perf_counter(), launch_counts()]

    losses = train_steps(model, ids, torch.ones_like(ids), steps, lr=lr, callback=on_step,
                         logit_chunk=logit_chunk)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if want is None:
        want = {**dict.fromkeys(launch_counts(), 0),
                **{kid: n_layers if sparse else 0 for kid in TRAIN_KERNELS}}
    for i, (loss, n) in enumerate(zip(losses, per_step)):
        require(np.isfinite(loss), f"{label} step {i + 1}: loss {loss}")
        require(n == want, f"{label} step {i + 1}: launches {n}, want {want}")
    steady = statistics.median(times[1:])
    log(f"[train] {label}: {steady:.2f} ms/step after the first "
        f"({ids.numel() / steady * 1e3:.0f} tokens/s), peak memory {peak:.2f} GiB")
    return losses, times, launch_counts(), peak


@contextlib.contextmanager
def layer0_registry(model):
    """The buffer registry on while layer 0's SEA attention runs, and off
    for the other layers; layer 0's buffers stay in it afterwards."""
    bench = get_bench()
    attn = model.model.layers[0].self_attn.perlin
    hooks = [attn.register_forward_pre_hook(lambda *_: bench.activate_temp_buffers(True)),
             attn.register_forward_hook(lambda *_: bench.activate_temp_buffers(False))]
    try:
        yield bench
    finally:
        for h in hooks:
            h.remove()
        bench.activate_temp_buffers(False)


def capture_layer0(model, ids, logit_chunk=None):
    """Layer 0's kernel inputs and the gradient reaching its kernel output,
    from one forward and backward of a train step (buffer registry for
    layer 0 and a tensor hook); the parameters' gradients are cleared
    afterwards. Under `scan_remat` the backward recomputes layer 0, whose
    top-k mask must equal the forward's bit for bit (else the gradient would
    be another mask's)."""
    grads = []
    with layer0_registry(model) as bench:
        out = model(ids, torch.ones_like(ids), labels=ids, training=True,
                    logit_chunk=logit_chunk)
        buf = {n: bench.get_temp_buffer(n, 0) for n in (
            "q_for_score", "k_for_score", "v", "partial_attention_mask_before_interp",
            "estimated_scales", "masked_estimated_attention_probs", "per_item_top_k",
            "fused_attention_output")}
        buf["fused_attention_output"].register_hook(grads.append)
        (out["loss"] + 0.0 * out["aux_loss"]).backward()
        if model.cfg.scan_remat:
            # the recompute's registry replaced the forward's buffers
            again = bench.get_temp_buffer("partial_attention_mask_before_interp", 0)
            fwd = buf["partial_attention_mask_before_interp"]
            require(again is not fwd, "the remat backward did not recompute layer 0")
            same = torch.equal(again, fwd)
            log(f"[train] layer-0 top-k mask of the remat recompute equal to the forward's "
                f"bit for bit: {same}")
            require(same, "the remat recompute picked another top-k mask than the forward")
    model.zero_grad(set_to_none=True)
    buf = {n: b.detach() for n, b in buf.items()}
    # the train-mode grouped top-k on the card against the CPU on the same estimates
    probs = buf["masked_estimated_attention_probs"]
    cpu_mask = topk_mask(
        probs.cpu(), torch.ones((probs.shape[0], 1, probs.shape[2], 1), dtype=torch.bool),
        buf["per_item_top_k"].cpu(), "causal_batch", False, fp_min_for(probs.dtype),
    )
    bad = int((cpu_mask != buf["partial_attention_mask_before_interp"].cpu()).sum())
    log(f"[train] layer-0 train-mode top-k mask, card vs CPU on the same estimates: "
        f"{bad} mismatches of {cpu_mask.numel()}")
    require(bad == 0, "train-mode top-k masks differ between the card and the CPU")
    mask = (buf["partial_attention_mask_before_interp"] > -1.0).float()
    sc = torch.sigmoid(buf["estimated_scales"][..., 0])
    return (buf["q_for_score"], buf["k_for_score"], buf["v"], mask, sc, grads[0],
            buf["fused_attention_output"])


def check_layer0(label, q, k, v, mask, sc, do, step_o):
    """K2, K3 and K4, and the whole FusedSparseAttention, against their plain
    versions on layer 0's captured inputs; K2 must also reproduce the step's
    own output bit for bit. Returns {kernel: max|err|}."""
    density = float(bs.mask_nnz(mask, q.shape[2], True)) / (
        q.shape[0] * q.shape[1] * q.shape[2] * (q.shape[2] + 1) / 2)
    log(f"[train] layer-0 kernel inputs {tuple(q.shape)}, element-mask density {density:.4f} "
        f"of the causal triangle, |dO| max {float(do.abs().max()):.3g}")
    errs = check_train_kernels(label, q, k, v, mask, sc, do)
    o, _ = bs.causal_fwd_stats(diff_operands(q, k, v, mask, sc))
    require(torch.equal(o, step_o), f"{label}: K2 on the captured inputs differs from the step's output")
    check_fused_backward(label, q, k, v, mask, sc, do)
    return errs


def check_layer0_head(label, q, k, v, mask, sc, do, step_o, head):
    """Layer 0's check at a length where the plain versions fit for one
    head only: K2, K3 and K4 launched on every head, K2 reproducing the
    step's output bit for bit and two launches of K3 and of K4 equal; each
    held on head `head` against its plain version of that head alone (K3's
    and K4's reading the kernels' lse and backward terms, the same as the
    kernels read), K2's under `f32_limit`'s gate; then FusedSparseAttention
    on that head against autograd through `dense_reference`. Returns
    {kernel: max|err|}."""
    ops = diff_operands(q, k, v, mask, sc)
    o, lse = bs.causal_fwd_stats(ops)
    require(torch.equal(o, step_o), f"{label}: K2 on the captured inputs differs from the step's output")
    _, dou, delta = bs.backward_terms(do, o, sc, torch.float32)
    dq = bs.causal_dq(ops, dou, lse, delta)
    dk, dv = bs.causal_dkv(ops, dou, lse, delta)
    again = (bs.causal_dq(ops, dou, lse, delta), *bs.causal_dkv(ops, dou, lse, delta))
    require(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
            f"{label}: two launches of K3 or K4 on the same operands differ")
    del ops, again
    one = slice(head, head + 1)
    q1, k1, v1, m1, sc1, do1 = (x[:, one].contiguous() for x in (q, k, v, mask, sc, do))
    want_o, want_lse = bs.fwd_with_stats_reference(q1, k1, v1, m1, sc1)
    inf = torch.isinf(want_lse)
    got_lse = lse[:, one]
    require(torch.equal(torch.isinf(got_lse), inf) and bool((got_lse[inf] > 0).all()),
            f"{label}: the +inf rows of lse differ")
    err_o = max_err(o[:, one], want_o)
    err_lse = max_err(got_lse[~inf], want_lse[~inf]) if bool((~inf).any()) else 0.0
    require(err_o <= F32_TOL and err_lse <= F32_TOL,
            f"{label}: K2 o err {err_o:.3g}, lse err {err_lse:.3g}")
    del want_o, want_lse
    stats = [x[:, one].contiguous() for x in (dou, lse, delta)]
    errs = {"K2": max(err_o, err_lse),
            "K3": check_grad(f"{label} K3 dq", dq[:, one], bs.dq_reference(q1, k1, v1, m1, *stats))}
    want_dk, want_dv = bs.dkv_reference(q1, k1, v1, m1, *stats)
    errs["K4"] = max(check_grad(f"{label} K4 dk", dk[:, one], want_dk),
                     check_grad(f"{label} K4 dv", dv[:, one], want_dv))
    del want_dk, want_dv, stats
    torch.cuda.empty_cache()
    log(f"[train-kernels] {label}: K2-K4 on all {q.shape[1]} heads of {tuple(q.shape)}, K2 "
        f"equal to the step's output, two launches of K3 and of K4 equal bit for bit; on head "
        f"{head} against the plain versions: K2 o {err_o:.3g}, lse {err_lse:.3g} "
        f"({int(inf.sum())} +inf rows); K3 dq {errs['K3']:.3g}; K4 dk/dv {errs['K4']:.3g}")
    check_fused_backward(f"{label} head {head}", q1, k1, v1, m1, sc1, do1)
    return errs


def phase_train():
    dev = "cuda"
    (t_a, steps_a), (t_b, steps_b) = TRAIN_REQUESTS
    model = longctx_model(t_a, 12, dev, "float32")
    g = torch.Generator().manual_seed(12)
    ids_a = torch.randint(4, model.cfg.vocab_size, (1, t_a), generator=g).to(dev)
    ids_b = torch.randint(4, model.cfg.vocab_size, (1, t_b), generator=g).to(dev)

    # request A, the main path: 3 steps on 1 x 2048
    losses, _, launches_a, _ = run_train(model, ids_a, steps_a, f"1x{t_a}")
    require(losses[-1] < losses[0], f"the loss did not fall over {steps_a} steps: {losses}")

    # layer 0 of one more step, held against the plain versions
    captured = capture_layer0(model, ids_a)
    errs_a = check_layer0(f"layer-0 1x{t_a}", *captured)
    measured = measure_train(*captured[:6])
    log_times(f"layer-0 1x{t_a}", measured)
    del captured

    optimizer = make_optimizer(model, TRAIN_LR)
    am = torch.ones_like(ids_a)
    breakdown(f"train step (1, {t_a})", lambda: train_step(model, optimizer, ids_a, am))
    dense_cfg = dataclasses.replace(model.cfg, attention_method="none")
    del model, optimizer
    torch.cuda.empty_cache()

    # the yardstick: the dense OPT-125m train step on the same batch
    dense = OptForCausalLM(dense_cfg, device=dev, seed=0)
    run_train(dense, ids_a, steps_a, f"dense 1x{t_a}")
    del dense
    torch.cuda.empty_cache()

    # request B: 2 steps on 1 x 8192, longctx_train_step.py's default length,
    # then layer 0 of one more step against the plain versions (the model is
    # freed first: the dense plain versions hold several 3.2 GB score tensors)
    model_b = longctx_model(t_b, 12, dev, "float32")
    _, _, launches_b, _ = run_train(model_b, ids_b, steps_b, f"1x{t_b}")
    captured = capture_layer0(model_b, ids_b)
    del model_b
    torch.cuda.empty_cache()
    errs_b = check_layer0(f"layer-0 1x{t_b}", *captured)
    del captured
    torch.cuda.empty_cache()
    launches = {kid: launches_a[kid] + launches_b[kid] for kid in TRAIN_KERNELS}
    errs = {kid: max(errs_a[kid], errs_b[kid]) for kid in TRAIN_KERNELS}
    return launches, errs, measured


def phase_longctx_32k():
    """`training.longctx.main`'s model (OPT-125m widths, 12 layers,
    use_fused_train, float32 parameters under bf16 compute, `scan_layers`
    and `scan_remat`) at 1 x LONGCTX_T with the chunked cross entropy
    (LONGCTX_CHUNK), LONGCTX_STEPS AdamW steps at lr 1e-5: 24 launches of
    K2's float32 instance and 12 each of K3's and K4's a step, no other
    kernel, finite losses that fall; ms per step and peak memory; then layer
    0 of one more step, the recompute's top-k mask checked, held by
    `check_layer0_head` on the last head. Returns ({kernel: launches},
    {kernel: max|err|}, ms per step, peak GiB)."""
    model = longctx_model(LONGCTX_T, 12, "cuda", remat=True)
    L = model.cfg.num_layers
    require(model.cfg.scan_remat and model.cfg.compute_dtype == "bfloat16",
            "longctx model: remat or compute type")
    ids = torch.randint(4, model.cfg.vocab_size, (1, LONGCTX_T),
                        generator=torch.Generator().manual_seed(83)).cuda()
    losses, times, launches, peak = run_train(
        model, ids, LONGCTX_STEPS, f"longctx 1x{LONGCTX_T} remat, logit_chunk {LONGCTX_CHUNK}",
        want=train_want(L, True, False), logit_chunk=LONGCTX_CHUNK)
    require(losses[-1] < losses[0], f"the 1x{LONGCTX_T} loss did not fall: {losses}")
    ms = statistics.median(times[1:])
    log(f"[longctx-32k] 1x{LONGCTX_T}, {L} layers: losses {losses}, {ms:.2f} ms per step "
        f"after the first ({LONGCTX_T / ms * 1e3:.0f} tokens/s), peak {peak:.2f} GiB")
    # layer 0 of one more step (the recompute's mask checked in the capture),
    # held once the model is freed
    captured = capture_layer0(model, ids, LONGCTX_CHUNK)
    del model
    torch.cuda.empty_cache()
    errs = check_layer0_head(f"longctx layer-0 1x{LONGCTX_T}", *captured,
                             head=captured[0].shape[1] - 1)
    del captured
    torch.cuda.empty_cache()
    return {kid: launches[kid] for kid in TRAIN_KERNELS}, errs, ms, peak


# ---------------------------------------------------------------------------
# The padded bidirectional path: K5 and the BERT-base SEA forward
# ---------------------------------------------------------------------------


def bidir_mask(lengths, T, seed, device):
    """(N, H, T, T_M=128) compressed mask of right-padded examples with the
    non-causal budget of `per_item_top_k` (round(H·k·T_M/len), clipped to
    [1, H·T_M], the same for every row of an example), spread at random over
    each token row's H·T_M pixels; padded rows keep nothing, as the BERT
    path's top-k gives them."""
    rng = np.random.default_rng(seed)
    width = H * BIDIR_T_M
    flat = np.zeros((len(lengths), T, width), np.float32)
    for n, length in enumerate(lengths):
        if length == 0:
            continue
        budget = min(max(round(H * K * BIDIR_T_M / length), 1), width)
        order = np.argsort(rng.random((length, width)), axis=-1)[:, :budget]
        np.put_along_axis(flat[n, :length], order, 1.0, axis=-1)
    m = np.transpose(flat.reshape(len(lengths), T, H, BIDIR_T_M), (0, 2, 1, 3)).copy()
    return torch.from_numpy(m).to(device)


def key_padding(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """(N, T) bool, True on each example's tokens."""
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def bidir_bound(ops: bs.KernelOperands, mask_m: torch.Tensor, lengths: torch.Tensor):
    """Least time the card needs for one K5 launch's function: the larger of
    4·D FLOPs per alive element (q·k and p·v; the count is this mask's
    element nnz at each example's width) at the peak for the input type,
    and the bytes at the HBM rate: q, the mask bits, the scaler and the
    lengths read once and the output written once at the padded size, and
    k and v read once at each example's own length (no key column past it
    is alive, so the function never needs it). The tile lists are the
    kernel's own device and are not counted."""
    N, Hh, T, Dd = ops.shape
    flops = 4 * Dd * int(bs.mask_nnz(mask_m, ops.k.shape[1], False, lengths=lengths))
    es = ops.q.element_size()
    kv_rows = int(ops.lengths.clamp(max=ops.k.shape[1]).sum())  # over the N·H rows
    nbytes = (2 * ops.q.numel() * es  # q; out
              + 2 * kv_rows * Dd * es  # k, v
              + ops.mbits.numel() * 4 + ops.scaler.numel() * 4 + ops.lengths.numel() * 4)
    t_ops = flops / PEAK_FLOPS[ops.q.dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def measure_bidir(q, k, v, mask, sc, lengths):
    """K5-only, wrapper, plain and SDPA times for one call's inputs (q is
    pre-divided by sqrt(D), so SDPA runs with scale 1)."""
    kw = dict(is_causal=False, lengths=lengths)
    x = bs.prepare_inputs(q, k, v, mask, sc, **kw)
    ops = bs.kernel_operands(x)
    keep = key_padding(lengths, k.shape[2])[:, None, None, :]
    out = dict(
        ms=time_ms(lambda: bs.bidir_forward(ops)),
        wrapper_ms=time_ms(lambda: bs.sea_block_sparse_attention(q, k, v, mask, sc, **kw)),
        plain_ms=time_ms(lambda: bs.dense_reference(q, k, v, mask, sc.to(q.dtype), **kw),
                         iters=5, warmup=1),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep, scale=1.0)),
    )
    out["bound_ms"], out["bound_by"], out["flops"], out["bytes"] = bidir_bound(
        ops, x.mask_m, lengths)
    return out


def check_bidir(label, q, k, v, mask, sc, lengths, timed=False):
    """K5 against its plain version in float32 on the same (rounded)
    inputs, within `tolerance`; returns (max|err|, K5's output)."""
    kw = dict(is_causal=False, lengths=lengths)
    got = bs.sea_block_sparse_attention(q, k, v, mask, sc, **kw)
    want = bs.dense_reference(q.float(), k.float(), v.float(), mask,
                              sc.to(q.dtype).float(), **kw)
    diff = (got.float() - want).abs()
    err = float(diff.max())
    over = float((diff - tolerance(want, q.dtype)).max())
    text = f"[bidir-kernel] {label}: max|err|={err:.3g} (margin to tol {-over:.3g})"
    if timed:
        m = measure_bidir(q, k, v, mask, sc, lengths)
        text += (f"; K5 {m['ms']:.4f} ms (with prep {m['wrapper_ms']:.4f}), plain "
                 f"{m['plain_ms']:.3f} ms, sdpa {m['library_ms']:.4f} ms, bound "
                 f"{m['bound_ms']:.4f} ms by {m['bound_by']} ({m['flops'] / 1e9:.4f} GFLOP, "
                 f"{m['bytes'] / 1e6:.2f} MB)")
    log(text)
    require(over <= 0, f"K5 vs plain, {label}: {err}")
    return err, got


def bidir_lengths(T, seed):
    """Four ragged right-padded lengths in [1, T], the first T."""
    rng = np.random.default_rng(seed)
    return [T, *(int(x) for x in rng.integers(1, T + 1, 3))]


def phase_bidir_mask():
    dev = "cuda"
    g = torch.Generator().manual_seed(2)
    pix = torch.arange(BIDIR_T_M)
    for T in (128, 512, 2048):
        lengths = torch.tensor([n for n in dict.fromkeys((1, 77, 128, 255, 383, T)) if n <= T],
                               dtype=torch.int32, device=dev)
        shape = (lengths.numel(), 2, T, BIDIR_T_M)
        masks = {
            "even": (pix % 2 == 0).float().expand(shape),
            "odd": (pix % 2 == 1).float().expand(shape),
            "random": (torch.rand(shape, generator=g) < 0.3).float(),
        }
        for name, m in masks.items():
            m = m.contiguous().to(dev)
            got = bs.alive_mask(m, T, is_causal=False, lengths=lengths)
            want = bs.element_mask_int8(m, T, False, lengths=lengths)
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            log(f"[bidir-mask] T={T} lengths {lengths.tolist()} {name}: {bad} mismatches "
                f"of {want.numel()} elements")
            require(bad == 0, f"K5's predicate != the oracle at T={T} ({name})")


def phase_bidir_kernel():
    dev = "cuda"
    errs = []
    for T in (256, 512, 1024, 2048, 200):
        lengths = bidir_lengths(T, seed=T)
        mask = bidir_mask(lengths, T, seed=T, device=dev)
        lt = torch.tensor(lengths, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, sc = qkv(len(lengths), T, dtype, seed=T, device=dev)
            err, got = check_bidir(f"T={T} lengths {lengths} {str(dtype)[6:]}",
                                   q / math.sqrt(D), k, v, mask, sc, lt, timed=True)
            require(got.shape[2] == T, f"T={T}: output rows {got.shape[2]}")
            errs.append(err)

    # edge cases, float32: empty rows, and examples of 0 and 1 tokens
    T = 512
    lengths = [T, 300, 1, 0]
    lt = torch.tensor(lengths, dtype=torch.int32, device=dev)
    mask = bidir_mask(lengths, T, seed=3, device=dev)
    mask[0, :, 100:164] = 0.0
    q, k, v, sc = qkv(len(lengths), T, torch.float32, seed=3, device=dev)
    err, got = check_bidir(f"T={T} lengths {lengths}, example 0 rows 100-163 empty",
                           q / math.sqrt(D), k, v, mask, sc, lt)
    zero = max(float(got[0, :, 100:164].abs().max()), float(got[3].abs().max()),
               float(got[2, :, 1:].abs().max()), float(got[1, :, 300:].abs().max()))
    log(f"[bidir-kernel] |out| on empty and padded rows: {zero}; all finite "
        f"{bool(torch.isfinite(got).all())}")
    require(zero == 0.0 and bool(torch.isfinite(got).all()), f"empty rows: |out| {zero}")
    errs.append(err)
    return max(errs)


def bert_batch(n, T, lo, hi, seed, vocab, device):
    """Right-padded token ids (0 on the padding), the 1-D attention mask and
    sentence-pair token types (1 from the middle of each example), with
    lengths uniform in [lo, hi]; the first example is `hi` long."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, n)
    lengths[0] = hi
    pos = np.arange(T)[None, :]
    am = pos < lengths[:, None]
    ids = np.where(am, rng.integers(1000, vocab, (n, T)), 0)
    types = am & (pos >= lengths[:, None] // 2)
    return [torch.from_numpy(x.astype(np.int64)).to(device) for x in (ids, am, types)]


def capture_bert_layer0(model, inputs):
    """Layer 0's K5 inputs and output from one forward (buffer registry);
    the grouped top-k on the card is held against the CPU on the same
    estimates."""
    bench = get_bench()
    bench.activate_temp_buffers(True)
    try:
        with torch.inference_mode():
            model(*inputs, benchmarking=True)
        buf = {n: bench.get_temp_buffer(n, 0) for n in (
            "q_for_score", "k_for_score", "v", "partial_attention_mask_before_interp",
            "estimated_scales", "lengths", "fused_attention_output",
            "masked_estimated_attention_probs", "per_item_top_k")}
    finally:
        bench.activate_temp_buffers(False)
        bench.reset()  # the other layers' buffers
    lengths = buf["lengths"]
    alive = key_padding(lengths, buf["q_for_score"].shape[2])[:, None, :, None]
    probs = buf["masked_estimated_attention_probs"]
    cpu_mask = topk_mask(probs.cpu(), alive.cpu(), buf["per_item_top_k"].cpu(),
                         "causal_batch", True, fp_min_for(probs.dtype))
    bad = int((cpu_mask != buf["partial_attention_mask_before_interp"].cpu()).sum())
    log(f"[bert] layer-0 top-k mask, card vs CPU on the same estimates: "
        f"{bad} mismatches of {cpu_mask.numel()}")
    require(bad == 0, "non-causal top-k masks differ between the card and the CPU")
    # the kernel's own operands: q / sqrt(D) (the model's true division),
    # v zeroed on the padded rows
    q = bs._div(buf["q_for_score"], math.sqrt(model.cfg.head_dim))
    v = torch.where(alive, buf["v"], torch.zeros_like(buf["v"]))
    mask = (buf["partial_attention_mask_before_interp"] > 0).to(q.dtype)
    sc = torch.sigmoid(buf["estimated_scales"][..., 0])
    return q, buf["k_for_score"], v, mask, sc, lengths, buf["fused_attention_output"]


def phase_bert():
    dev = "cuda"
    cfg = bert_base("perlin")
    t0 = time.perf_counter()
    model = BertForSequenceClassification(cfg, device=dev, seed=0).eval()
    dense = BertForSequenceClassification(
        dataclasses.replace(cfg, attention_method="none"), device=dev, seed=0).eval()
    torch.cuda.synchronize()
    log(f"[bert] BERT-base perlin + dense built on {dev} in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)")
    requests = [bert_batch(n, T, lo, hi, seed=20 + i, vocab=cfg.vocab_size, device=dev)
                for i, (n, T, lo, hi) in enumerate(BERT_REQUESTS)]

    # the main path: every request once, kernel launches counted around it
    reset_launches()
    outs, per_forward = [], []
    for inputs in requests:
        before = launch_counts()
        with torch.inference_mode():
            outs.append(model(*inputs, benchmarking=True)["logits"])
        after = launch_counts()
        per_forward.append({kid: after[kid] - before[kid] for kid in after})
    torch.cuda.synchronize()
    launches = bs.bidir_forward.launches
    want = {**dict.fromkeys(launch_counts(), 0), "K5": cfg.num_layers}
    for (ids, am, _), logits, n in zip(requests, outs, per_forward):
        finite = bool(torch.isfinite(logits).all())
        log(f"[bert] request {tuple(ids.shape)} (lengths {int(am.sum(1).min())}-"
            f"{int(am.sum(1).max())}): logits {tuple(logits.shape)} finite={finite}, "
            f"launches {n}")
        require(finite and logits.shape == (ids.shape[0], cfg.num_labels),
                f"logits of request {tuple(ids.shape)}")
        require(n == want, f"launches in one forward {n}, want {want}")
    log(f"[bert] main path: {launches} launches of sea_bidir_forward")

    # layer 0's kernel inputs, captured from one more forward of each request
    errs, captured = [], None
    for inputs in requests:
        q, k, v, mask, sc, lengths, run_out = capture_bert_layer0(model, inputs)
        err, got = check_bidir(f"layer-0 {tuple(q.shape)}", q, k, v, mask, sc, lengths)
        require(torch.equal(got, run_out), "K5 on the captured inputs differs from the run's output")
        N, T = q.shape[0], q.shape[2]
        alive = float(bs.mask_nnz(mask, T, False, lengths=lengths))
        square = float((lengths.double() ** 2).sum()) * H
        log(f"[bert] layer-0 K5 inputs {tuple(q.shape)}: reproduces the run's output bit for "
            f"bit; element-mask density {alive / square:.4f} of the examples' squares")
        errs.append(err)
        if captured is None:
            captured = (q, k, v, mask, sc, lengths)

    for (ids, am, types), (n, T, _, _) in zip(requests, BERT_REQUESTS):
        real = int(am.sum())
        for label, mdl in (("SEA", model), ("dense", dense)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            ms, out = forward_ms(mdl, ids, am, types)
            peak = torch.cuda.max_memory_allocated()
            require(bool(torch.isfinite(out).all()), f"{label} logits not finite")
            log(f"[bert] forward {n}x{T} {label}: {ms:.2f} ms, {real / ms * 1e3:.0f} real "
                f"tokens/s, {n * T / ms * 1e3:.0f} padded tokens/s, peak memory "
                f"{peak / 2 ** 30:.2f} GiB ({(peak - resident) / 2 ** 30:.2f} GiB above the "
                f"{resident / 2 ** 30:.2f} GiB resident: both models and the inputs)")

    inputs = requests[0]

    def forward():
        with torch.inference_mode():
            model(*inputs, benchmarking=True)

    breakdown(f"BERT forward {tuple(inputs[0].shape)}", forward)
    return launches, max(errs), captured


# ---------------------------------------------------------------------------
# The ring: K6, K7, K8, and OPT-125m sequence-sharded over LocalGroup(4)
# ---------------------------------------------------------------------------


def window_nnz(mask_l, rows_l, col0, ch) -> int:
    """Alive elements of the rows whose global ids are `rows_l` (mask_l
    their compressed mask) in the columns col0 .. col0 + ch − 1: each alive
    pixel's run of columns, cut to the window."""
    vs, ve = bs._pixel_starts((rows_l + 1).float(), mask_l.shape[-1])
    run = (ve.clamp(max=col0 + ch) - vs.clamp(min=col0)).clamp(min=0).to(torch.int64)
    return int(((mask_l > 0).to(torch.int64) * run).sum())


def window_bound(kid, ops: bs.WindowOperands, nnz):
    """(t_ops, t_bytes) in ms of one launch of `kid` on one window, as
    `diff_bound` counts K2-K4: its FLOPs on the window's alive elements at
    the peak for the operands' type, and its bytes (q and the per-row
    operands of the shard's rows, k and v of the window, each read once in
    their type, lse and delta float32; each output written once) at the HBM
    rate. The tile lists are not counted."""
    N, Hh, TL, Dd = ops.shape
    flops = RING_KERNELS[kid][4] * Dd * nnz
    es = ops.q.element_size()
    q_tile = N * Hh * TL * Dd * es
    kv_tile = N * Hh * ops.window * Dd * es
    row = N * Hh * TL * 4
    nbytes = ops.mbits.numel() * 4 + ops.row_base.numel() * 4 + q_tile + 2 * kv_tile + {
        "K6": q_tile + row,  # out, lse (the scaler is one)
        "K7": q_tile + 2 * row + q_tile,  # dO·scaler, lse, delta; dq
        "K8": q_tile + 2 * row + 2 * kv_tile,  # dO·scaler, lse, delta; dk, dv
    }[kid]
    return 1e3 * flops / PEAK_FLOPS[ops.q.dtype], 1e3 * nbytes / HBM_BYTES_PER_S


def ring_windows(label, q, k, v, mask, sc, do, timed=False, zigzag=True, block=RING_BLOCK):
    """K6, K7 and K8 against their plain versions on every (shard, window)
    of a ring of RING_SHARDS shards (zigzag rows unless `zigzag` is False,
    blocks `block`) over
    (q, k, v, mask, sc) with incoming gradient `do`, at the ring's merged
    logsumexp and delta (dou in the operands' type, as the ring's backward
    takes it). float32 or bf16 operands; the plain versions run in float32
    on the same values, and bf16 results are held as `check_bf16_kernels`
    holds K2-K4 (outputs within 1e-5 plus half a bf16 ulp, gradients within
    1e-4·max|want| plus half an ulp). Returns {kernel: max|err|} and, if `timed`, each
    kernel's numbers per launch averaged over the S² launches of one layer
    (ms, plain ms, bound ms, the library's ms on one window's shapes: SDPA's
    forward for K6 and its backward for the pair K7 + K8) beside their sums
    and one launch of K2, K3 or K4 at the same T."""
    group = LocalGroup(RING_SHARDS, q.device)
    N, Hh, T, Dd = q.shape
    S = group.size
    bq, bk = sa._ring_blocks(T, S, block, block)
    perm, _, rows = sa._row_order(T, S, bq, zigzag, q.device)
    qp, maskp, scp, dop = (x if perm is None else x[:, :, perm] for x in (q, mask, sc, do))
    out, L, ops = sa._ring_forward(qp, k, v, maskp, scp, rows, group, bq, bk)
    _, dou, delta = bs.backward_terms(dop, out, scp, q.dtype)
    L_b = torch.where(torch.isneginf(L), float("inf"), L)
    q_l, m_l, dou_l, L_l, delta_l, k_w, v_w = (
        group.split_rows(x) for x in (qp, maskp, dou, L_b, delta, k, v))
    r_l = group.split_rows(rows, 0)
    # the plain versions' operands: the same values in float32
    qf_l, douf_l, kf_w, vf_w = ([x.float() for x in xs] for xs in (q_l, dou_l, k_w, v_w))
    grad_check = check_grad if q.dtype == torch.float32 else check_grad_bf16
    errs = dict.fromkeys(RING_KERNELS, 0.0)
    sums = {kid: dict(ms=0.0, plain_ms=0.0, t_ops=0.0, t_bytes=0.0, bound_ms=0.0)
            for kid in RING_KERNELS}
    empty = 0
    for j in range(S):
        widths = (r_l[j] + 1).float()
        for w in range(S):
            col0, ch = w * ops[j].window, ops[j].window
            per_call = (dou_l[j], L_l[j], delta_l[j])
            plain_call = (douf_l[j], L_l[j], delta_l[j])
            plain = {
                "K6": lambda: bs.fwd_stats_window_reference(
                    qf_l[j], kf_w[w], vf_w[w], m_l[j], col0, row_widths=widths),
                "K7": lambda: bs.dq_window_reference(
                    qf_l[j], kf_w[w], vf_w[w], m_l[j], *plain_call, col0, row_widths=widths),
                "K8": lambda: bs.dkv_window_reference(
                    qf_l[j], kf_w[w], vf_w[w], m_l[j], *plain_call, col0, row_widths=widths),
            }
            kern = {
                "K6": lambda: bs.fwd_stats_window(ops[j], w, k_w[w], v_w[w]),
                "K7": lambda: bs.dq_window(ops[j], w, k_w[w], v_w[w], *per_call),
                "K8": lambda: bs.dkv_window(ops[j], w, k_w[w], v_w[w], *per_call),
            }
            where = f"{label} shard {j} window {w}"
            (o, lse), (want_o, want_lse) = kern["K6"](), plain["K6"]()
            torch.cuda.synchronize()
            inf = torch.isposinf(want_lse)
            require(torch.equal(torch.isposinf(lse), inf) and not bool(torch.isnan(lse).any()),
                    f"{where}: K6's +inf rows of lse differ")
            e_lse = max_err(lse[~inf], want_lse[~inf]) if bool((~inf).any()) else 0.0
            e6 = max(max_err(o, want_o), e_lse)
            require(bool(((o.float() - want_o).abs() <= tolerance(want_o, q.dtype)).all())
                    and e_lse <= F32_TOL and o.dtype == q.dtype
                    and bool(torch.isfinite(o).all()), f"{where}: K6 err {e6:.3g}")
            empty += int(bool(inf.all()))
            dq_w = kern["K7"]()
            e7 = grad_check(f"{where} K7 dq", dq_w, plain["K7"]())
            (dk, dv), (want_dk, want_dv) = kern["K8"](), plain["K8"]()
            e8 = max(grad_check(f"{where} K8 dk", dk, want_dk),
                     grad_check(f"{where} K8 dv", dv, want_dv))
            require(dq_w.dtype == dk.dtype == dv.dtype == q.dtype, f"{where}: K7/K8 types")
            for kid, e in (("K6", e6), ("K7", e7), ("K8", e8)):
                errs[kid] = max(errs[kid], e)
            if timed:
                nnz = window_nnz(m_l[j], r_l[j], col0, ch)
                for kid in RING_KERNELS:
                    t_ops, t_bytes = window_bound(kid, ops[j], nnz)
                    sums[kid]["ms"] += time_ms(kern[kid], iters=10)
                    sums[kid]["plain_ms"] += time_ms(plain[kid], iters=3, warmup=1)
                    sums[kid]["t_ops"] += t_ops
                    sums[kid]["t_bytes"] += t_bytes
                    sums[kid]["bound_ms"] += max(t_ops, t_bytes)
    log(f"[ring-kernels] {label} {str(q.dtype)[6:]}: {S * S} (shard, window) pairs, {empty} "
        f"of them with nothing alive on any row; max|err| vs plain K6 {errs['K6']:.3g}, K7 "
        f"{errs['K7']:.3g}, K8 {errs['K8']:.3g}")
    if not timed:
        return errs, None

    # the library's times on one window's shapes, and one launch of K2-K4 at T
    qq, kk, vv = (x.detach().clone().requires_grad_() for x in (q_l[0], k_w[0], v_w[0]))
    sdpa_out = F.scaled_dot_product_attention(qq, kk, vv)
    library = {
        "K6": time_ms(lambda: F.scaled_dot_product_attention(q_l[0], k_w[0], v_w[0])),
        "K7": time_ms(lambda: torch.autograd.grad(sdpa_out, (qq, kk, vv), dou_l[0],
                                                  retain_graph=True)),
    }
    library["K8"] = library["K7"]
    del sdpa_out, qq, kk, vv
    def unsharded_ms(blocks):
        ops_u = bs.kernel_operands(bs.prepare_inputs(q, k, v, mask, sc, block_q=blocks,
                                                     block_k=blocks), differentiable=True)
        o_u, lse_u = bs.causal_fwd_stats(ops_u)
        _, dou_u, delta_u = bs.backward_terms(do, o_u, sc, q.dtype)
        return {
            "K6": time_ms(lambda: bs.causal_fwd_stats(ops_u)),
            "K7": time_ms(lambda: bs.causal_dq(ops_u, dou_u, lse_u, delta_u)),
            "K8": time_ms(lambda: bs.causal_dkv(ops_u, dou_u, lse_u, delta_u)),
        }

    # K2-K4 with the unsharded path's 64-wide tile lists, and with the
    # ring's 128-wide ones: what the lists' width costs apart from the split
    unsharded, unsharded_wide = unsharded_ms(bs.KERNEL_TILE), unsharded_ms(bq)
    n = S * S
    timing = {}
    for kid, t in sums.items():
        timing[kid] = dict(
            ms=t["ms"] / n, sum_ms=t["ms"], plain_ms=t["plain_ms"] / n,
            bound_ms=t["bound_ms"] / n, sum_bound_ms=t["bound_ms"],
            bound_by="operations" if t["t_ops"] >= t["t_bytes"] else "bytes",
            library_ms=library[kid], unsharded_ms=unsharded[kid],
        )
        names = {"K6": "K2", "K7": "K3", "K8": "K4"}
        log(f"[ring-kernels] {label} {kid}: {n} launches {t['ms']:.4f} ms "
            f"({t['ms'] / n:.4f} a launch) against one {names[kid]} launch at T={T} "
            f"{unsharded[kid]:.4f} ms ({t['ms'] / unsharded[kid]:.2f}x; {names[kid]} on "
            f"{bq}-wide lists {unsharded_wide[kid]:.4f} ms, "
            f"{t['ms'] / unsharded_wide[kid]:.2f}x); plain "
            f"{t['plain_ms'] / n:.3f} ms a window; sdpa {'fwd' if kid == 'K6' else 'bwd'} "
            f"{library[kid]:.4f} ms on one window's shapes; bound {t['bound_ms']:.4f} ms over "
            f"the {n} ({t['bound_ms'] / n:.4f} a launch) by {timing[kid]['bound_by']}")
    return errs, timing


def ring_vs_unsharded(label, q, k, v, mask, sc, do):
    """The whole differentiable ring (K6 forward, K7/K8 backward; zigzag,
    blocks RING_BLOCK, LocalGroup(RING_SHARDS)) against FusedSparseAttention
    (K2-K4) unsharded on the same inputs: the output within 3e-5 and dq, dk,
    dv, dscaler within 2e-4 abs and each also within 1e-8 + 1e-4·max|want|
    (check_grad's rule), so that a ring whose gradients are far smaller than
    2e-4 (a CE loss's over 16384 tokens) cannot drop, misroute or zero a dk/dv
    chunk unseen. Returns the ring's (o, dq, dk, dv, dscaler)."""
    group = LocalGroup(RING_SHARDS, q.device)
    got = autograd_outputs(
        lambda a, b, c, d: sa.ring_fused_train_attention(
            a, b, c, mask, d, group, True, RING_BLOCK, RING_BLOCK), q, k, v, sc, do)
    want = autograd_outputs(
        lambda a, b, c, d: bs.fused_sparse_attention(a, b, c, mask, d), q, k, v, sc, do)
    errs = [max_err(g, w) for g, w in zip(got, want)]
    rel = [e / max(float(w.abs().max()), 1e-30) for e, w in zip(errs, want)]
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    log(f"[ring-kernels] {label}: ring (K6-K8) vs unsharded (K2-K4) max|err| o {errs[0]:.3g}, "
        f"dq {errs[1]:.3g}, dk {errs[2]:.3g}, dv {errs[3]:.3g}, dscaler {errs[4]:.3g} "
        f"(relative to max|want|: {', '.join(f'{r:.3g}' for r in rel)}); finite {finite}")
    require(finite and errs[0] <= RING_OUT_TOL and max(errs[1:]) <= RING_GRAD_TOL,
            f"{label}: ring vs unsharded {errs}")
    for name, g, w in zip(("dq", "dk", "dv", "dscaler"), got[1:], want[1:]):
        check_grad(f"{label} ring {name}", g, w)
    return got


def phase_ring_kernels():
    dev = "cuda"
    T = RING_CHECK_T
    q, k, v, sc = qkv(1, T, torch.float32, seed=21, device=dev)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(22)).to(dev)
    mask = budget_mask(1, T, seed=21, device=dev)
    dead = slice(T // 4, T // 4 + 64)
    mask[:, :, dead] = 0.0  # rows with nothing alive
    errs, timing = ring_windows(f"1x{T} zigzag", q, k, v, mask, sc, do, timed=True)
    # rows in the natural order: shard 0's rows end before windows 1-3 begin
    natural, _ = ring_windows(f"1x{T} natural order", q, k, v, mask, sc, do, zigzag=False)
    errs = {kid: max(errs[kid], natural[kid]) for kid in errs}
    o, dq, *_ = ring_vs_unsharded(f"1x{T}", q, k, v, mask, sc, do)
    zero = max(float(o[:, :, dead].abs().max()), float(dq[:, :, dead].abs().max()))
    log(f"[ring-kernels] 1x{T}: |o|, |dq| on rows {dead.start}-{dead.stop - 1}, which have "
        f"nothing alive: {zero}")
    require(zero == 0.0, "rows with nothing alive: nonzero output or dq")
    # the bf16 instances (K2-K4's) on every (shard, window), both row orders
    qb, kb, vb, scb, dob = (x.bfloat16() for x in (q, k, v, sc, do))
    bf16_errs, _ = ring_windows(f"1x{T} zigzag", qb, kb, vb, mask, scb, dob)
    natural, _ = ring_windows(f"1x{T} natural order", qb, kb, vb, mask, scb, dob, zigzag=False)
    bf16_errs = {kid: max(bf16_errs[kid], natural[kid]) for kid in bf16_errs}
    # shards of whole blocks but not of whole 128-row tiles (the JAX ring's
    # `_ring_blocks` takes them): the wrappers pad rows and windows inside
    T = RING_SHARDS * PAD_SHARD
    q, k, v, sc = qkv(1, T, torch.float32, seed=23, device=dev)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(24)).to(dev)
    mask = budget_mask(1, T, seed=23, device=dev)
    for dtype, out in ((torch.float32, errs), (torch.bfloat16, bf16_errs)):
        padded, _ = ring_windows(f"1x{T} {PAD_SHARD}-row shards, blocks {PAD_BLOCK}",
                                 *(x.to(dtype) for x in (q, k, v)), mask, sc.to(dtype),
                                 do.to(dtype), block=PAD_BLOCK)
        for kid in out:
            out[kid] = max(out[kid], padded[kid])
    return errs, timing, bf16_errs


def serve_model(t, layers=12):
    """The serving OPT-125m SEA student with positions up to `t` and
    `layers` of its 12 layers, random weights from seed 0."""
    sea = opt_config(max_position_embeddings=t)
    cfg = dataclasses.replace(opt_125m("perlin", sea=sea), max_position_embeddings=t,
                              num_layers=layers)
    return OptForCausalLM(cfg, device="cuda", seed=0).eval()


def layer0_forward(model, ids, scope=None):
    """One benchmark forward (inside `scope` if given): (logits, layer 0's
    attention output `partial_context_layer`, its kernel output)."""
    with contextlib.ExitStack() as stack:
        if scope is not None:
            stack.enter_context(sharded_attention_scope(**scope))
        bench = stack.enter_context(layer0_registry(model))
        stack.enter_context(torch.inference_mode())
        logits = model(ids, torch.ones_like(ids), benchmarking=True)["logits"]
    out = (logits, bench.get_temp_buffer("partial_context_layer", 0),
           bench.get_temp_buffer("fused_attention_output", 0))
    bench.reset()
    return out


def phase_ring_serve():
    dev = "cuda"
    T = RING_T
    model = serve_model(T, RING_LAYERS)
    n_layers = model.cfg.num_layers
    ids = torch.randint(4, model.cfg.vocab_size, (1, T),
                        generator=torch.Generator().manual_seed(13)).to(dev)
    am = torch.ones_like(ids)
    scope = dict(group=LocalGroup(RING_SHARDS, dev), kind="auto")

    # the main path: one forward inside the scope, launches counted around it
    with sharded_attention_scope(**scope) as ctx:
        kind = resolve_attention_kind(ctx, t=T)
        require(kind == "ring", f"kind='auto' at T={T} over {RING_SHARDS} shards gave {kind}")
        reset_launches()
        with torch.inference_mode():
            logits = model(ids, am, benchmarking=True)["logits"]
        torch.cuda.synchronize()
        counts = launch_counts()
    want = {**dict.fromkeys(counts, 0), "K6": RING_SHARDS ** 2 * n_layers}
    finite = bool(torch.isfinite(logits).all())
    log(f"[ring-serve] 1x{T} under kind='auto' -> {kind}: logits {tuple(logits.shape)} "
        f"finite={finite}, launches {counts}")
    require(finite and logits.shape == (1, T, model.cfg.vocab_size), "ring logits")
    require(counts == want, f"ring forward launches {counts}, want {want}")

    # layer 0 against the unsharded forward (K1)
    ring = layer0_forward(model, ids, scope)
    before = launch_counts()["K1"]
    plain = layer0_forward(model, ids)
    require(launch_counts()["K1"] - before == n_layers, "the unsharded forward's K1 launches")
    err_ctx, err_kernel, err_logits = (max_err(a, b) for a, b in zip(ring[1:] + ring[:1],
                                                                      plain[1:] + plain[:1]))
    log(f"[ring-serve] layer 0 ring vs unsharded: attention output max|err| {err_ctx:.3g}, "
        f"kernel output {err_kernel:.3g}; logits after {n_layers} layers {err_logits:.3g}; the run's "
        f"logits reproduced {torch.equal(ring[0], logits)}")
    require(err_ctx <= LAYER_TOL, f"layer-0 attention output, ring vs unsharded: {err_ctx}")
    del ring, plain

    def ring_forward():
        with sharded_attention_scope(**scope), torch.inference_mode():
            model(ids, am, benchmarking=True)

    def plain_forward():
        with torch.inference_mode():
            model(ids, am, benchmarking=True)

    times = {label: host_ms(fn, iters=3)
             for label, fn in (("ring", ring_forward), ("unsharded", plain_forward))}
    log(f"[ring-serve] forward 1x{T}: ring over {RING_SHARDS} shards {times['ring']:.2f} ms "
        f"({T / times['ring'] * 1e3:.0f} tokens/s), unsharded {times['unsharded']:.2f} ms "
        f"({T / times['unsharded'] * 1e3:.0f} tokens/s)")
    breakdown(f"ring forward (1, {T})", ring_forward)
    del model
    torch.cuda.empty_cache()
    return counts["K6"]
def train_arm(model, ids, steps, label, want=None, lr=TRAIN_LR):
    """`run_train` with the first step's every-layer top-k masks (bool, from
    forward hooks) and parameter gradients kept for `compare_arms`."""
    masks, grads = [], {}
    hooks = [layer.self_attn.perlin.register_forward_hook(
        lambda m, args, out: masks.append(out.partial_attention_mask > -1.0))
        for layer in model.model.layers]

    def after_step(i):
        if i == 0:
            for h in hooks:
                h.remove()
            grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})

    losses, times, launches, peak = run_train(model, ids, steps, label, want=want,
                                              after_step=after_step, lr=lr)
    return dict(label=label, losses=losses, times=times, launches=launches, peak=peak,
                masks=masks, grads=grads, tokens=ids.numel())


def compare_arms(phase, a, b, loss_tol=LOSS_TOL, grad_rel=None):
    """Arm `a` (sharded) against arm `b` (unsharded) from the same weights
    and batch: the first step's loss within `loss_tol` (1e-4); the top-k
    picks of every layer compared; every parameter gradient within 2e-4 abs
    (or `grad_rel` of the largest gradient) when no pick differs (a later
    layer's near-tie pick can flip under the arms' float reassociation; the
    gap is then printed and not held to the bound)."""
    dloss = abs(a["losses"][0] - b["losses"][0])
    differ = [(i, int((ma != mb).sum())) for i, (ma, mb) in enumerate(zip(a["masks"], b["masks"]))]
    differ = [(i, n) for i, n in differ if n]
    gaps = {n: max_err(g, b["grads"][n]) for n, g in a["grads"].items()}
    worst = max(gaps, key=gaps.get)
    scale = max(float(g.abs().max()) for g in b["grads"].values())
    log(f"[{phase}] {a['label']} vs {b['label']}: first-step loss {a['losses'][0]:.6f} vs "
        f"{b['losses'][0]:.6f} (|diff| {dloss:.3g}); top-k picks differing by layer "
        f"{differ or 'none'} of {len(a['masks'])} layers; max|grad diff| {gaps[worst]:.3g} "
        f"({worst}; largest gradient {scale:.3g})")
    grad_tol = RING_GRAD_TOL if grad_rel is None else grad_rel * scale
    require(len(a["masks"]) == len(b["masks"]) > 0, "top-k masks captured")
    require(dloss <= loss_tol, f"{phase}: first-step loss differs by {dloss} (bound {loss_tol:.3g})")
    if differ:
        log(f"[{phase}] top-k picks differ, so the gradient gap {gaps[worst]:.3g} is "
            f"reported and not held to {grad_tol:.3g}")
    else:
        require(gaps[worst] <= grad_tol, f"{phase}: gradient {worst} differs by {gaps[worst]}")
    for arm in (a, b):
        steady = statistics.median(arm["times"][1:])
        log(f"[{phase}] {arm['label']}: {steady:.2f} ms/step after the first "
            f"({arm['tokens'] / steady * 1e3:.0f} tokens/s), peak memory {arm['peak']:.2f} GiB")


def phase_ring_train():
    dev = "cuda"
    T, steps = RING_T, 2
    group = LocalGroup(RING_SHARDS, dev)

    # the main path: 2 steps inside the scope, launches counted step by step
    with sharded_attention_scope(group, kind="auto") as ctx:
        kind = resolve_attention_kind(ctx, t=T)
        require(kind == "ring", f"kind='auto' at T={T} over {RING_SHARDS} shards gave {kind}")
        model = longctx_model(T, RING_LAYERS, dev, "float32")
        ids = torch.randint(4, model.cfg.vocab_size, (1, T),
                            generator=torch.Generator().manual_seed(14)).to(dev)
        n = RING_SHARDS ** 2 * model.cfg.num_layers
        want = {**dict.fromkeys(launch_counts(), 0), "K6": n, "K7": n, "K8": n}
        ring = train_arm(model, ids, steps, f"ring 1x{T}", want=want)
        launches = {kid: ring["launches"][kid] for kid in RING_KERNELS}
        require(ring["losses"][-1] < ring["losses"][0],
                f"the loss did not fall over {steps} steps: {ring['losses']}")
        # layer 0 of one more step, for the op-level checks below
        captured = capture_layer0(model, ids)
    del model
    torch.cuda.empty_cache()

    # the unsharded arm (K2-K4) from the same weights and batch
    model = longctx_model(T, RING_LAYERS, dev, "float32")
    plain = train_arm(model, ids, steps, f"unsharded 1x{T}")
    del model
    torch.cuda.empty_cache()
    compare_arms("ring-train", ring, plain)
    del ring, plain
    torch.cuda.empty_cache()

    # layer 0's attention op at the inputs captured from the ring arm
    q, k, v, mask, sc, do, step_o = captured
    got = ring_vs_unsharded(f"layer-0 1x{T}", q, k, v, mask, sc, do)
    require(torch.equal(got[0], step_o), "the ring on the captured inputs differs from the step's output")
    log(f"[ring-train] layer-0 ring output reproduces the step's own bit for bit")
    del got
    errs, timing = ring_windows(f"layer-0 1x{T}", q, k, v, mask, sc, do, timed=True)
    return launches, errs, timing


def phase_seq_head():
    dev = "cuda"
    T = RING_CHECK_T
    for t, size, want in ((T, RING_SHARDS, "seq"), (RING_T, RING_SHARDS, "ring"),
                          (RING_T, 1, "seq"), (4 * RING_T, 1, "seq")):
        got = resolve_attention_kind(AttnShardingContext(LocalGroup(size, dev)), t=t)
        log(f"[seq-head] kind='auto' at T={t} over {size} shard(s): {got}")
        require(got == want, f"the auto rule at T={t}, {size} shards: {got}, want {want}")

    group = LocalGroup(RING_SHARDS, dev)
    model = serve_model(T, RING_LAYERS)
    n_layers = model.cfg.num_layers
    ids = torch.randint(4, model.cfg.vocab_size, (1, T),
                        generator=torch.Generator().manual_seed(15)).to(dev)
    plain = layer0_forward(model, ids)
    for kind in ("seq", "head", "auto"):
        reset_launches()
        got = layer0_forward(model, ids, dict(group=group, kind=kind))
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {**dict.fromkeys(counts, 0), "K1": RING_SHARDS * n_layers}
        err_ctx, err_logits = max_err(got[1], plain[1]), max_err(got[0], plain[0])
        log(f"[seq-head] forward 1x{T} kind={kind}: launches {counts}; layer-0 attention "
            f"output max|err| {err_ctx:.3g} vs unsharded, logits {err_logits:.3g}; finite "
            f"{bool(torch.isfinite(got[0]).all())}")
        require(counts == want, f"{kind} forward launches {counts}, want {want}")
        require(err_ctx <= LAYER_TOL and bool(torch.isfinite(got[0]).all()),
                f"{kind} forward: layer-0 err {err_ctx}")
    del model, plain, got
    torch.cuda.empty_cache()

    unsharded = train_arm(longctx_model(T, RING_LAYERS, dev, "float32"), ids, 2,
                          f"unsharded 1x{T}")
    for kind in ("seq", "head"):
        with sharded_attention_scope(group, kind=kind):
            n = RING_SHARDS * n_layers
            arm = train_arm(longctx_model(T, RING_LAYERS, dev, "float32"), ids, 2,
                            f"{kind} 1x{T}",
                            want={**dict.fromkeys(launch_counts(), 0),
                                  **dict.fromkeys(TRAIN_KERNELS, n)})
        compare_arms("seq-head", arm, unsharded)
        del arm
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The impl variants K9a-c, the attention-operator sweep, the cosformer slice
# ---------------------------------------------------------------------------


def block_label(bq, bk):
    return "defaults" if bq is None else f"{bq}x{bk}"


def phase_impl_mask():
    dev = "cuda"
    masks = [(f"budget T={T}", T, budget_mask(1, T, seed=T, device=dev)) for T in (1024, 2048, 4096)]
    masks.append((f"host_topk_mask T={BENCH_T}", BENCH_T,
                  torch.from_numpy(host_topk_mask(1, H, BENCH_T, T_M, K, seed=0)).to(dev)))
    checked = 0
    for label, T, m in masks:
        want = bs.element_mask_int8(m, T, True)
        for kid, (impl, _) in IMPL_VARIANTS.items():
            bad = {}
            for bq, bk in BENCH_BLOCKS:
                if bq is not None and (T % bq or T % bk):
                    continue
                got = bs.alive_mask(m, T, impl=impl, block_q=bq, block_k=bk)
                torch.cuda.synchronize()
                bad[block_label(bq, bk)] = int((got != want).sum())
                checked += got.numel()
            log(f"[impl-mask] {label} {kid} ({impl}): mismatches by blocks {bad}")
            require(not any(bad.values()), f"{kid}'s predicate != element_mask_int8 ({label})")
        del want
    log(f"[impl-mask] {checked / 1e9:.2f} G elements checked")


def bench_inputs(dtype, device):
    """bench.py's canonical inputs (bench.py:73-79): q, k, v, the scaler and
    the host-built top-k mask, from numpy seeded 0 in bench.py's order."""
    rng = np.random.default_rng(0)
    shape = (1, H, BENCH_T, D)
    q = rng.standard_normal(shape).astype(np.float32) * 0.2
    k = rng.standard_normal(shape).astype(np.float32) * 0.2
    v = rng.standard_normal(shape).astype(np.float32)
    sc = rng.uniform(0.1, 1.0, (1, H, BENCH_T)).astype(np.float32)
    q, k, v, sc = (torch.from_numpy(x).to(device, dtype) for x in (q, k, v, sc))
    mask = torch.from_numpy(host_topk_mask(1, H, BENCH_T, T_M, K, seed=0)).to(device)
    return q, k, v, sc, mask


def impl_operands(q, k, v, mask, sc, impl, bq, bk):
    """The operands `sea_block_sparse_attention(..., impl=)` builds, at the
    blocks given or the wrapper's defaults."""
    bq, bk, sub = bs.impl_blocks(impl, q.shape[2], k.shape[2], bq, bk)
    x = bs.prepare_inputs(q, k, v, mask, sc, block_q=bq, block_k=bk)
    return bs.kernel_operands(x, impl=impl, sub=sub)


def tile_stats(ops) -> str:
    """What the restriction saves on these operands: K9a/b's mean words per
    listed tile (of the row's n_words) and the shares of one- and two-word
    exact ranges; K9c's share of the listed outer tiles' pieces it skips."""
    listed = torch.arange(ops.idx.shape[-1], device=ops.idx.device) < ops.counts[..., None]
    aux = ops.tile_aux[listed]
    if ops.impl == "subtile":
        n = ops.block_k // ops.sub
        bits = (aux[:, None] >> torch.arange(n, device=aux.device, dtype=torch.int32)) & 1
        active = float(bits.sum()) / bits.numel()
        return (f"{int(listed.sum())} listed outer tiles of {n} pieces of {ops.sub}: "
                f"{100 * (1 - active):.1f}% of pieces skipped")
    lo, hi, exact = aux & 0xFF, (aux >> 8) & 0xFF, (aux >> 16) != 0
    words = (hi - lo + 1).float()
    return (f"{int(listed.sum())} listed tiles: {float(words.mean()):.3f} words of "
            f"{ops.mbits.shape[-1]} on average; exact one word {100 * float((exact & (lo == hi)).float().mean()):.1f}%, "
            f"two {100 * float((exact & (hi == lo + 1)).float().mean()):.1f}%")


def phase_impl_kernels():
    """bench.py's configuration through every impl and block shape. Returns
    the main-path launches of K9a-c, {kid: max|kernel - plain| in float32}
    and {dtype: {kid: times at the defaults}}, K1's beside them."""
    dev = "cuda"
    errs, timing = dict.fromkeys(IMPL_VARIANTS, 0.0), {torch.float32: {}, torch.bfloat16: {}}
    launches = dict.fromkeys(IMPL_VARIANTS, 0)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, sc, mask = bench_inputs(dtype, dev)
        ref = bs.sea_block_sparse_attention(q, k, v, mask, sc)  # K1, 64 x 64
        # the main path: every impl and block shape once, launches counted
        reset_launches()
        outs = {}
        for kid, (impl, _) in IMPL_VARIANTS.items():
            for bq, bk in BENCH_BLOCKS:
                outs[kid, bq, bk] = bs.sea_block_sparse_attention(
                    q, k, v, mask, sc, block_q=bq, block_k=bk, impl=impl)
        torch.cuda.synchronize()
        counts = launch_counts()
        want_counts = {**dict.fromkeys(counts, 0),
                       **dict.fromkeys(IMPL_VARIANTS, len(BENCH_BLOCKS))}
        log(f"[impl-kernels] {str(dtype)[6:]} 1x{BENCH_T}: launches {counts}")
        require(counts == want_counts, f"impl launches {counts}, want {want_counts}")
        for kid in IMPL_VARIANTS:
            launches[kid] += counts[kid]
        for (kid, bq, bk), got in outs.items():
            impl = IMPL_VARIANTS[kid][0]
            ops = impl_operands(q, k, v, mask, sc, impl, bq, bk)
            want = bs.impl_reference(ops._replace(q=ops.q.float(), k=ops.k.float(),
                                                  v=ops.v.float()), impl)
            diff = (got.float() - want).abs()
            err = float(diff.max())
            over = float((diff - tolerance(want, dtype)).max())
            vs_k1 = max_err(got, ref)
            log(f"[impl-kernels] {str(dtype)[6:]} {kid} ({impl}) blocks {block_label(bq, bk)}: "
                f"max|err| vs plain {err:.3g} (margin to tol {-over:.3g}); max|diff| vs K1 "
                f"{vs_k1:.3g}; {tile_stats(ops)}")
            require(over <= 0, f"{kid} vs plain at blocks {block_label(bq, bk)} {dtype}: {err}")
            require(vs_k1 == 0, f"{kid} at blocks {block_label(bq, bk)} {dtype} differs from "
                                f"K1 by {vs_k1}")
            if dtype == torch.float32:
                errs[kid] = max(errs[kid], err)
        del outs

        # times at the defaults, K1 beside them at the same inputs
        x = bs.prepare_inputs(q, k, v, mask, sc)
        k1_ops = bs.kernel_operands(x)
        k1_ms = time_ms(lambda: bs.launch_causal_flat(k1_ops))
        timing[dtype]["K1"] = dict(
            ms=k1_ms, wrapper_ms=time_ms(lambda: bs.sea_block_sparse_attention(q, k, v, mask, sc)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)))
        timing[dtype]["K1"]["bound_ms"], timing[dtype]["K1"]["bound_by"], *_ = bound(k1_ops, mask)
        for kid, (impl, _) in IMPL_VARIANTS.items():
            ops = impl_operands(q, k, v, mask, sc, impl, None, None)
            wrapper = bs.IMPL_KERNELS[impl].wrapper
            m = dict(
                ms=time_ms(lambda: wrapper(ops)),
                wrapper_ms=time_ms(lambda: bs.sea_block_sparse_attention(
                    q, k, v, mask, sc, impl=impl)),
                plain_ms=time_ms(lambda: bs.impl_reference(ops, impl), iters=5, warmup=1),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True)),
            )
            m["bound_ms"], m["bound_by"], m["flops"], m["bytes"] = bound(ops, mask)
            log(f"[impl-kernels] {str(dtype)[6:]} {kid} ({impl}) at its defaults "
                f"({ops.block_q}x{ops.block_k}{f', sub {ops.sub}' if ops.sub else ''}): kernel "
                f"{m['ms']:.4f} ms (K1 {k1_ms:.4f} ms; with prep {m['wrapper_ms']:.4f}), plain "
                f"{m['plain_ms']:.3f} ms, sdpa {m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} "
                f"ms by {m['bound_by']} ({m['flops'] / 1e9:.4f} GFLOP, {m['bytes'] / 1e6:.2f} MB)")
            timing[dtype][kid] = m
        del q, k, v, sc, mask, ref
        torch.cuda.empty_cache()
    return launches, errs, timing


def phase_sweep():
    """The attention-operator sweep on the card, float32 and bfloat16, then
    K9a against its plain version on each T's sea_fused inputs. Returns
    K9a's launches in the sweep and its largest error in float32."""
    n_k9a, err_f32 = 0, 0.0
    for dtype in ("float32", "bfloat16"):
        reset_launches()
        res = attention_method_sweep(seq_lens=SWEEP_TS, dtype=dtype)
        torch.cuda.synchronize()
        counts = launch_counts()
        for rec in res:
            log(f"[sweep] {json.dumps(rec)}")
        bad = [r for r in res if "error" in r]
        require(not bad, f"sweep records with an error: {bad}")
        require({(r["method"], r["seq_len"]) for r in res}
                == {(m, T) for m in ("dense", "performer", "cosformer", "sea_fused")
                    for T in SWEEP_TS}, "the sweep's records")
        by = {(r["method"], r["seq_len"]): r["ms"] for r in res}
        ratios = {T: by["dense", T] / by["sea_fused", T] for T in SWEEP_TS}
        log(f"[sweep] {dtype}: launches {counts}; dense / sea_fused ms by T "
            f"{ {T: round(r, 3) for T, r in ratios.items()} }")
        require(counts["K9a"] > 0 and counts["K1"] == 0,
                f"sea_fused must launch K9a and never K1: {counts}")
        require(not any(n for kid, n in counts.items() if kid != "K9a"),
                f"the sweep launched other kernels: {counts}")
        n_k9a += counts["K9a"]

        # sea_fused's call (`attention_operators`) on the sweep's own inputs,
        # held to the plain version in float32 on the same (rounded) inputs
        dt = getattr(torch, dtype)
        for T in SWEEP_TS:
            q, k, v, mask = sweep_inputs(T, H, D, T_M, K, dt, "cuda")
            got = bs.sea_block_sparse_attention(q, k, v, mask, None, impl="flat_wr")
            ops = impl_operands(q, k, v, mask, None, "flat_wr", None, None)
            want = bs.impl_reference(ops._replace(q=ops.q.float(), k=ops.k.float(),
                                                  v=ops.v.float()), "flat_wr")
            diff = (got.float() - want).abs()
            err = float(diff.max())
            over = float((diff - tolerance(want, dt)).max())
            ms = time_ms(lambda: bs.IMPL_KERNELS["flat_wr"].wrapper(ops))
            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
            bound_ms, bound_by, *_ = bound(ops, mask)
            log(f"[sweep] {dtype} T={T} sea_fused (K9a) vs plain: max|err| {err:.3g} "
                f"(margin to tol {-over:.3g}); K9a {ms:.4f} ms, sdpa {sdpa_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {bound_by}")
            require(over <= 0, f"K9a vs plain on the sweep's inputs at T={T} {dtype}: {err}")
            if dt == torch.float32:
                err_f32 = max(err_f32, err)
            del q, k, v, mask, got, ops, want, diff
        torch.cuda.empty_cache()
    return n_k9a, err_f32


def phase_cosformer_slice():
    dev = "cuda"
    cfg = opt_125m("perlin", sea=opt_config(predictor_backend="cosformer"))
    model = OptForCausalLM(cfg, device=dev, seed=0).eval()
    ids = torch.randint(4, cfg.vocab_size, (1, COS_T),
                        generator=torch.Generator().manual_seed(16)).to(dev)
    am = torch.ones_like(ids)

    # the main path: one forward, launches counted around it
    reset_launches()
    with torch.inference_mode():
        logits = model(ids, am, benchmarking=True)["logits"]
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {**dict.fromkeys(counts, 0), "K1": cfg.num_layers}
    finite = bool(torch.isfinite(logits).all())
    log(f"[cosformer-slice] OPT-125m, cosformer backend, 1x{COS_T}: logits "
        f"{tuple(logits.shape)} finite={finite}, launches {counts}")
    require(finite and logits.shape == (1, COS_T, cfg.vocab_size), "cosformer logits")
    require(counts == want, f"cosformer forward launches {counts}, want {want}")

    # layer 0's kernel inputs, captured from a forward, against the plain version
    bench = get_bench()
    bench.activate_temp_buffers(True)
    with torch.inference_mode():
        model(ids, am, benchmarking=True)
    buf = {n: bench.get_temp_buffer(n, 0) for n in (
        "q", "k", "v", "partial_attention_mask_before_interp", "estimated_scales")}
    bench.activate_temp_buffers(False)
    bench.reset()
    q, k, v = buf["q"], buf["k"], buf["v"]
    mask = (buf["partial_attention_mask_before_interp"] > 0).to(q.dtype)
    sc = torch.sigmoid(buf["estimated_scales"][..., 0])
    err = max_err(bs.sea_block_sparse_attention(q, k, v, mask, sc, k_cfg=float(K)),
                  bs.dense_reference(q, k, v, mask, sc, k_cfg=float(K)))
    log(f"[cosformer-slice] layer-0 kernel inputs {tuple(q.shape)}: K1 vs plain max|err| {err:.3g}")
    require(err <= F32_TOL, f"K1 vs plain on the cosformer layer-0 inputs: {err}")

    # the performer backend with the same weights (all but the cosformer's)
    perf = OptForCausalLM(opt_125m("perlin"), device=dev, seed=None).eval()
    perf.load_state_dict({n: p for n, p in model.state_dict().items()
                          if "cosformer_backend" not in n}, strict=False)
    missing = [n for n in perf.state_dict() if n not in model.state_dict()]
    require(not missing, f"weights the performer model did not get: {missing[:3]}")
    cos_ms, _ = forward_ms(model, ids, am)
    perf_ms, perf_out = forward_ms(perf, ids, am)
    require(bool(torch.isfinite(perf_out).all()), "performer-backend logits not finite")
    log(f"[cosformer-slice] forward 1x{COS_T}: cosformer backend {cos_ms:.2f} ms "
        f"({COS_T / cos_ms * 1e3:.0f} tokens/s), performer backend {perf_ms:.2f} ms "
        f"({COS_T / perf_ms * 1e3:.0f} tokens/s)")

    def forward():
        with torch.inference_mode():
            model(ids, am, benchmarking=True)

    breakdown(f"cosformer-backend forward (1, {COS_T})", forward)
    del model, perf
    torch.cuda.empty_cache()
    return err


# ---------------------------------------------------------------------------
# The dense train path against the fused kernels, and KD training
# ---------------------------------------------------------------------------


def attention_inputs(T, seed, device):
    """q, k, v of OPT-125m's attention width (1, H, T, D) as the JAX
    package's attention tests draw them (N(0, 0.25)) and the square
    additive causal mask."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy((rng.standard_normal((1, H, T, D)) * 0.5).astype(np.float32))
               .to(device) for _ in range(3))
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=device))
    mask = torch.where(causal, 0.0, fp_min_for(torch.float32))[None, None]
    return q, k, v, mask


def dead_rows(a, b):
    """(T,) rows whose dead set differs between two masks (any head)."""
    return (a != b).any(-1).any(1)[0]


def phase_dense_vs_fused():
    """The dense train path (plain PyTorch) as the reference of the fused
    kernels at OPT-125m's attention width on 1 x DENSE_T, float32 with TF32
    off: the benchmark path's context (one K1 launch) within 2e-4 of the
    dense path's (tests/test_fused_path.py:12), and use_fused_train's loss
    Σ context² (K2, K3, K4 once each) at rtol 1e-4 and every gradient at
    atol 5e-3, rtol 1e-2 of the dense path's (:88). The arms compute their
    top-k masks by the same code on the same inputs; rows whose picks differ
    would be counted, left out of the context check, and the gradients then
    reported and not held."""
    dev = "cuda"
    cfg = opt_config()
    q, k, v, mask = attention_inputs(DENSE_T, 17, dev)
    dense = SeaAttention(cfg, device=dev, seed=0)
    fused = SeaAttention(dataclasses.replace(cfg, use_fused_train=True), device=dev, seed=None)
    fused.load_state_dict(dense.state_dict())

    bench = get_bench()

    def arm(model, benchmarking, training):
        """One arm's output, loss Σ context², gradients, launches and
        compressed top-k mask (from the buffer registry)."""
        reset_launches()
        bench.reset()
        bench.activate_temp_buffers(True)
        try:
            out = model(q, k, v, q, k, v, q, k, mask, benchmarking=benchmarking,
                        training=training)
            mask_m = bench.get_temp_buffer("partial_attention_mask_before_interp", 0).detach()
        finally:
            bench.activate_temp_buffers(False)
            bench.reset()
        loss = None
        if not benchmarking:
            loss = (out.context_layer.float() ** 2).sum()
            model.zero_grad(set_to_none=True)
            loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad for n, p in model.named_parameters()}
        # dead pixels: additive masks (train) hold FP_MIN, binary ones 0
        dead = mask_m < -1 if not benchmarking else mask_m <= 0
        return out, loss, grads, launch_counts(), dead

    d_out, d_loss, d_grads, d_n, d_dead = arm(dense, False, True)
    with torch.no_grad():
        b_out, _, _, b_n, b_dead = arm(dense, True, False)
    f_out, f_loss, f_grads, f_n, f_dead = arm(fused, False, True)
    zero = dict.fromkeys(launch_counts(), 0)
    require(d_n == zero, f"the dense path launched kernels: {d_n}")
    require(b_n == {**zero, "K1": 1}, f"the benchmark arm's launches {b_n}")
    require(f_n == {**zero, "K2": 1, "K3": 1, "K4": 1}, f"the fused-train arm's launches {f_n}")

    rows_b = dead_rows(d_dead, b_dead)
    rows_f = dead_rows(d_dead, f_dead)
    keep = ~rows_b
    ctx_err = max_err(d_out.context_layer.detach()[:, keep], b_out.context_layer[:, keep])
    log(f"[dense-vs-fused] 1x{DENSE_T}, H={H} D={D} T_M={T_M} k={K}: top-k rows differing from "
        f"the dense arm's: benchmark {int(rows_b.sum())}, fused-train {int(rows_f.sum())}; "
        f"context, dense vs benchmark path (K1), max|err| {ctx_err:.3g} over "
        f"{int(keep.sum())} rows (bound 2e-4)")
    require(ctx_err < 2e-4, f"dense vs benchmark context {ctx_err}")
    f_loss, d_loss = float(f_loss), float(d_loss)
    rel = abs(f_loss - d_loss) / abs(d_loss)
    worst, worst_name = 0.0, None
    unreached = []
    for name, g in d_grads.items():
        f = f_grads[name]
        if f is None:
            unreached.append(name)
            require(g is None or float(g.abs().max()) == 0.0, f"{name}: dense gradient where fused has none")
            continue
        excess = float(((f - g).abs() - (5e-3 + 1e-2 * g.abs())).max())
        if excess > worst or worst_name is None:
            worst, worst_name = excess, name
    gaps = {n: max_err(f_grads[n], g) for n, g in d_grads.items() if f_grads[n] is not None}
    top = max(gaps, key=gaps.get)
    log(f"[dense-vs-fused] use_fused_train (K2-K4) vs dense: loss {float(f_loss):.6f} vs "
        f"{float(d_loss):.6f} (rel {rel:.3g}, bound 1e-4); max|grad err| {gaps[top]:.3g} "
        f"({top}); largest excess over 5e-3 + 1e-2|dense| {worst:.3g} ({worst_name}); "
        f"{len(unreached)} parameters behind the top-k without a gradient on either path")
    require(rel <= 1e-4, f"fused-train loss vs dense: rel {rel}")
    if rows_f.any():
        log(f"[dense-vs-fused] top-k picks differ, so the gradients are reported and not held")
    else:
        require(worst <= 0.0, f"fused-train gradient {worst_name} off the dense path's by {worst}")
    del dense, fused
    torch.cuda.empty_cache()
    return dict(context=ctx_err, loss_rel=rel, grad=gaps[top])


def kd_config(save_dir):
    """The KD trainer's defaults (OPT-125m, 1 x 512, stride 256,
    accumulation 8, use_remat), KD_STEPS optimizer steps, a log line each."""
    return TrainerConfig(model="opt-125m", num_steps=KD_STEPS, log_steps=1,
                         eval_steps=10 ** 9, save_dir=save_dir)


def phase_kd():
    dev = "cuda"
    with tempfile.TemporaryDirectory() as save_dir:
        t0 = time.perf_counter()
        tr = OptTrainer(kd_config(save_dir), device=dev)
        torch.cuda.synchronize()
        cfg = tr.cfg
        log(f"[kd] OPT-125m teacher and student on {dev} in {time.perf_counter() - t0:.1f} s: "
            f"{tr.s_cfg.num_layers} layers, vocab {tr.s_cfg.vocab_size}, "
            f"{cfg.batch_size}x{cfg.max_seq_len} windows, stride {cfg.stride}, accumulation "
            f"{cfg.gradient_accumulation_steps}, remat {cfg.use_remat}, "
            f"{len(tr.corpus)} training windows (synthetic corpus)")
        fixed = next(tr.corpus.batches(cfg.batch_size, shuffle=True, seed=cfg.seed))
        fixed_t = tr._tensors(*fixed)

        def fixed_loss():
            with torch.no_grad():
                loss, details = tr.kd.kd_loss(*fixed_t, use_remat=False)
            return float(loss), {n: float(x) for n, x in details.items()}

        before, before_terms = fixed_loss()
        student0 = {n: x.clone() for n, x in tr.student.state_dict().items()}
        teacher0 = {n: x.clone() for n, x in tr.teacher.state_dict().items()}

        # the main path: KD_STEPS updates of accumulation 8 through train()
        micro = KD_STEPS * cfg.gradient_accumulation_steps
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        require(tr.step == KD_STEPS, f"the trainer took {tr.step} steps, not {KD_STEPS}")
        require(not any(counts.values()), f"the KD step launched kernels: {counts}")
        with open(tr.metrics_path) as f:
            records = [json.loads(line) for line in f]
        for rec in records:
            log(f"[kd] step {rec['step']}: " + ", ".join(
                f"{n} {v:.6f}" for n, v in rec.items() if n not in ("step", "time")))
        require(len(records) == KD_STEPS and all(
            math.isfinite(v) for rec in records for n, v in rec.items() if n != "time"),
            "a KD loss term is not finite")
        ntok = cfg.batch_size * cfg.max_seq_len
        log(f"[kd] main path: {KD_STEPS} steps, {micro} micro-steps in {wall:.1f} ms: "
            f"{wall / micro:.2f} ms per micro-step with the updates "
            f"({ntok * micro / wall * 1e3:.0f} tokens/s), peak memory {peak:.2f} GiB; "
            f"kernel launches {counts}")

        after, after_terms = fixed_loss()
        moved = sum(not torch.equal(x, student0[n]) for n, x in tr.student.state_dict().items())
        same = all(torch.equal(x, teacher0[n]) for n, x in tr.teacher.state_dict().items())
        log(f"[kd] fixed batch (the stream's first): KD loss {before:.6f} -> {after:.6f}; "
            f"terms before {before_terms}, after {after_terms}; {moved} of {len(student0)} "
            f"student tensors moved; teacher unchanged bit for bit: {same}")
        require(all(math.isfinite(v) for v in (*before_terms.values(), *after_terms.values())),
                "a fixed-batch KD term is not finite")
        require(moved > 0 and same, "the student did not move or the teacher changed")
        require(after < before, f"the fixed batch's KD loss did not fall: {before} -> {after}")

        # steady micro-steps on the fixed batch, beside the dense teacher's CE step
        def micro_step():
            tr.micro_step(*fixed)
            tr.student.zero_grad(set_to_none=True)

        torch.cuda.reset_peak_memory_stats()
        kd_ms = host_ms(micro_step, KD_ITERS)
        kd_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        dense = OptForCausalLM(tr.t_cfg, device=dev, seed=None)
        dense.load_state_dict(tr.teacher.state_dict())
        dense_opt = make_optimizer(dense, TRAIN_LR)
        ids, am = fixed_t[0], fixed_t[1]
        torch.cuda.reset_peak_memory_stats()
        dense_ms = host_ms(lambda: train_step(dense, dense_opt, ids, am), KD_ITERS)
        dense_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del dense, dense_opt
        log(f"[kd] micro-step 1x{cfg.max_seq_len}: {kd_ms:.2f} ms ({ntok / kd_ms * 1e3:.0f} "
            f"tokens/s), peak {kd_peak:.2f} GiB; the dense teacher's own CE train step on the "
            f"same batch {dense_ms:.2f} ms ({ntok / dense_ms * 1e3:.0f} tokens/s), peak "
            f"{dense_peak:.2f} GiB")
        breakdown(f"KD micro-step (1, {cfg.max_seq_len})", micro_step)

        t0 = time.perf_counter()
        ppl = tr.evaluate(max_batches=KD_EVAL_WINDOWS)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3 / KD_EVAL_WINDOWS
        log(f"[kd] evaluate(max_batches={KD_EVAL_WINDOWS}): student PPL {ppl:.4f} "
            f"(random weights, synthetic corpus), {eval_ms:.2f} ms per window")
        require(math.isfinite(ppl), f"PPL {ppl}")

        # one micro-step at OPT's context, 1 x KD_LONG_T
        ids = torch.randint(4, tr.s_cfg.vocab_size, (1, KD_LONG_T),
                            generator=torch.Generator().manual_seed(18))
        long = (ids, torch.ones_like(ids), ids)
        tr.micro_step(*long)  # warm-up
        tr.student.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        details = tr.micro_step(*long)
        torch.cuda.synchronize()
        long_ms = (time.perf_counter() - t0) * 1e3
        long_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        terms = {n: float(x) for n, x in details.items()}
        log(f"[kd] micro-step 1x{KD_LONG_T}: {long_ms:.2f} ms ({KD_LONG_T / long_ms * 1e3:.0f} "
            f"tokens/s), peak {long_peak:.2f} GiB; terms {terms}")
        require(all(math.isfinite(v) for v in terms.values()),
                f"a KD term at 1x{KD_LONG_T} is not finite: {terms}")
        del tr
    torch.cuda.empty_cache()
    return dict(micro_ms=kd_ms, peak=peak, ppl=ppl, long_ms=long_ms, long_peak=long_peak)


# ---------------------------------------------------------------------------
# The baseline methods, BERT's KD through the GLUE and LRA trainers
# ---------------------------------------------------------------------------


def no_kernel(phase, counts):
    require(not any(counts.values()), f"[{phase}] launched kernels: {counts}")


def timed_sync(fn):
    """(host ms of `fn()` ending in a synchronise, its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def phase_baselines():
    dev = "cuda"
    g = torch.Generator().manual_seed(19)
    ids = torch.randint(4, 50272, (1, BASELINE_T), generator=g).to(dev)
    am = torch.ones_like(ids)
    reset_launches()
    for method in BASELINE_METHODS:
        t0 = time.perf_counter()
        model = build_model(opt_125m(method), 0, dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        fwd_ms = host_ms(lambda: infer(model, ids, am), 1)
        logits = infer(model, ids, am)
        opt = make_optimizer(model, TRAIN_LR)
        train_step(model, opt, ids, am)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        step_ms, loss = timed_sync(lambda: float(train_step(model, opt, ids, am)))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finite = bool(torch.isfinite(logits).all()) and math.isfinite(loss)
        log(f"[baselines] OPT-125m '{method}' student 1x{BASELINE_T} (built in {build_s:.1f} s): "
            f"forward {fwd_ms:.2f} ms, task-only step {step_ms:.2f} ms, loss {loss:.6f}, "
            f"peak {peak:.2f} GiB, finite {finite}")
        require(finite and logits.shape == (1, BASELINE_T, 50272),
                f"OPT '{method}' logits or loss not finite")
        del model, opt, logits
        torch.cuda.empty_cache()

    n, T, lo, hi = BERT_REQUESTS[0]
    ids, am, types = bert_batch(n, T, lo, hi, seed=20, vocab=30522, device=dev)
    ids_pad = torch.where(am > 0, ids, torch.full_like(ids, 7))
    for method in BERT_BASELINES:
        model = build_bert(bert_base(method), 0, dev).eval()
        ms, logits = forward_ms(model, ids, am, types, iters=3)
        moved = max_err(infer(model, ids_pad, am, types), logits)
        scale = float(logits.abs().max())
        log(f"[baselines] BERT-base '{method}' {n}x{T} (lengths {lo}-{hi}): forward {ms:.2f} ms, "
            f"logits finite {bool(torch.isfinite(logits).all())}; padding's ids changed: "
            f"max|logit change| {moved:.3g} of max|logit| {scale:.3g}"
            + (" (the reference masks padding here)" if method in PADDING_MASKED
               else " (the reference reads the padding here)"))
        require(bool(torch.isfinite(logits).all()), f"BERT '{method}' logits not finite")
        if method in PADDING_MASKED:
            require(moved <= F32_TOL * scale, f"BERT '{method}': padding moved the logits")
        del model
        torch.cuda.empty_cache()
    no_kernel("baselines", launch_counts())


def student_k5(phase, model, inputs, timed=False):
    """One benchmarking forward of a trained BERT student through K5: one
    launch a layer and no other kernel; layer 0's captured inputs reproduce
    the run's output bit for bit and K5 holds its plain version. Returns
    (launches, max|err|)."""
    model.eval()
    reset_launches()
    logits = infer(model, *inputs)
    torch.cuda.synchronize()
    counts = launch_counts()
    n = model.cfg.num_layers
    bf16 = next(model.parameters()).dtype == torch.bfloat16
    want = {**dict.fromkeys(counts, 0), "K5": n, **({"K5 bf16": n} if bf16 else {})}
    require(counts == want, f"[{phase}] the student's forward launched {counts}, want {want}")
    require(bool(torch.isfinite(logits).all()), f"[{phase}] the student's logits")
    q, k, v, mask, sc, lengths, run_out = capture_bert_layer0(model, inputs)
    err, got = check_bidir(f"{phase} student layer-0 {tuple(q.shape)}", q, k, v, mask, sc,
                           lengths, timed=timed)
    require(torch.equal(got, run_out), f"[{phase}] K5 on the captured inputs differs")
    log(f"[{phase}] trained student through K5: {counts['K5']} launches, layer-0 max|err| "
        f"{err:.3g}")
    return counts["K5"], err


def phase_glue_kd():
    dev = "cuda"
    with tempfile.TemporaryDirectory() as save_dir:
        t0 = time.perf_counter()
        tr = GlueTrainer(GlueTrainerConfig(model="bert-base", subset="mrpc",
                                           num_steps=GLUE_STEPS, eval_steps=10 ** 9,
                                           save_dir=save_dir), device=dev)
        torch.cuda.synchronize()
        T = tr.train_ds.input_ids.shape[1]
        log(f"[glue-kd] GlueTrainer(bert-base, mrpc) on {dev} in {time.perf_counter() - t0:.1f} "
            f"s: batch {tr.batch_size}, T = {T} (synthetic fallback), {len(tr.train_ds)} "
            f"training and {len(tr.eval_ds)} validation examples")
        student0 = {n: x.clone() for n, x in tr.student.state_dict().items()}
        teacher0 = {n: x.clone() for n, x in tr.teacher.state_dict().items()}
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        wall, _ = timed_sync(tr.train)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        no_kernel("glue-kd", launch_counts())
        with open(tr.metrics_path) as f:
            records = [json.loads(line) for line in f]
        moved = sum(not torch.equal(x, student0[n]) for n, x in tr.student.state_dict().items())
        same = all(torch.equal(x, teacher0[n]) for n, x in tr.teacher.state_dict().items())
        require(tr.step == GLUE_STEPS and moved > 0 and same,
                f"steps {tr.step}, {moved} tensors moved, teacher unchanged {same}")
        batch = next(tr.train_ds.batches(tr.batch_size, shuffle=True, seed=7))
        tr.train_step(*batch)  # warm-up
        step_ms, details = timed_sync(lambda: tr.train_step(*batch))
        terms = {n: float(x) for n, x in details.items()}
        require(all(math.isfinite(v) for v in terms.values()), f"a KD term: {terms}")
        eval_ms, score = timed_sync(lambda: tr.evaluate(max_batches=16, return_dict=True))
        teacher_ms, acc = timed_sync(lambda: tr.evaluate_teacher(max_batches=16))
        log(f"[glue-kd] main path: train() of {GLUE_STEPS} steps and its evaluation in "
            f"{wall:.1f} ms (records {records}), peak {peak:.2f} GiB; {moved} of {len(student0)} "
            f"student tensors moved, teacher unchanged; a steady step {step_ms:.2f} ms, terms "
            f"{terms}; evaluate {score} in {eval_ms:.1f} ms, evaluate_teacher {acc:.4f} in "
            f"{teacher_ms:.1f} ms (random teacher, synthetic data)")

        long = synthetic_glue("mrpc", "train", n=tr.batch_size, max_length=GLUE_LONG_T)
        long_t = tr._tensors(*next(long.batches(tr.batch_size)))
        ids, am, tt, labels = long_t

        def micro():
            loss, det = tr.kd.kd_loss(ids, am, labels, tt)
            loss.backward()
            tr.student.zero_grad(set_to_none=True)
            return {n: float(x.detach()) for n, x in det.items() if n != "logits"}

        micro()  # warm-up
        torch.cuda.reset_peak_memory_stats()
        long_ms, long_terms = timed_sync(micro)
        long_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[glue-kd] KD micro-step {tr.batch_size}x{GLUE_LONG_T}: {long_ms:.2f} ms, peak "
            f"{long_peak:.2f} GiB, terms {long_terms}")
        require(all(math.isfinite(v) for v in long_terms.values()), "a 256-token KD term")
        launches, err = student_k5("glue-kd", tr.student, (ids, am, tt))
        del tr
    torch.cuda.empty_cache()
    return dict(launches=launches, err=err, step_ms=step_ms, peak=peak, long_ms=long_ms,
                long_peak=long_peak)


def lra_config(save_dir, **kw):
    return LraTrainerConfig(task="listops", num_steps=LRA_STEPS, n_train=LRA_N_TRAIN,
                            log_every=1, save_dir=save_dir, data_cache_dir=save_dir, **kw)


def phase_lra():
    dev = "cuda"
    with tempfile.TemporaryDirectory() as save_dir:
        t0 = time.perf_counter()
        dense = LraTrainer(lra_config(save_dir, phase="dense"), device=dev)
        torch.cuda.synchronize()
        c = dense.t_cfg
        log(f"[lra] ListOps teacher on {dev} in {time.perf_counter() - t0:.1f} s: {c.num_layers} "
            f"layers, width {c.hidden_size}, {c.num_heads} heads, batch {dense.batch_size}, T = "
            f"{dense.train_ds.input_ids.shape[1]}, remat_layers {c.remat_layers}")
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        wall, _ = timed_sync(lambda: dense.train(log=log))
        dense_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        no_kernel("lra", launch_counts())

        back = LraTrainer(lra_config(save_dir, phase="dense"), device=dev)
        same = all(torch.equal(x, y) for x, y in zip(dense.teacher.state_dict().values(),
                                                       back.teacher.state_dict().values()))
        sa, sb = dense.t_optimizer.state_dict(), back.t_optimizer.state_dict()
        same_opt = sa["count"] == sb["count"] and all(
            torch.equal(sa["state"][n][m], sb["state"][n][m]) for n in sa["state"]
            for m in ("mu", "nu"))
        log(f"[lra] dense: {LRA_STEPS} steps through train() in {wall:.1f} ms with the save "
            f"({wall / LRA_STEPS:.1f} ms a step), peak {dense_peak:.2f} GiB; resumed at step "
            f"{back.step}: parameters equal {same}, optimizer state equal {same_opt}")
        require(back.step == dense.step == LRA_STEPS and same and same_opt,
                "the LRA teacher's resume is not bit for bit")
        del dense, back
        torch.cuda.empty_cache()

        kd = LraTrainer(lra_config(save_dir, phase="distill", accum_steps=2), device=dev)
        student0 = {n: x.clone() for n, x in kd.student.state_dict().items()}
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        wall, _ = timed_sync(lambda: kd.train(log=log))
        kd_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        no_kernel("lra", launch_counts())
        moved = sum(not torch.equal(x, student0[n]) for n, x in kd.student.state_dict().items())
        require(kd.step == LRA_STEPS and moved > 0, f"the distill phase: step {kd.step}, "
                f"{moved} tensors moved")
        micro = list(kd.train_ds.batches(kd.batch_size))[:2]
        torch.cuda.reset_peak_memory_stats()
        step_ms, (loss, terms) = timed_sync(lambda: kd.kd_step(micro))
        step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        terms = {n: float(x) for n, x in terms.items()}
        require(math.isfinite(float(loss)) and all(math.isfinite(v) for v in terms.values()),
                f"an LRA KD term: {terms}")
        log(f"[lra] distill: {LRA_STEPS} steps of 2 micro-batches through train() (with the "
            f"bootstrap probe and the save) in {wall:.1f} ms, peak {kd_peak:.2f} GiB; one more "
            f"step {step_ms:.2f} ms, peak {step_peak:.2f} GiB, loss {float(loss):.6f}, terms "
            f"{terms}")
        ids, am, tt, _ = kd._tensors(*next(kd.eval_ds.batches(kd.batch_size)))
        launches, err = student_k5("lra", kd.student, (ids, am, tt), timed=True)
        del kd
        torch.cuda.empty_cache()

        text = LraTrainer(LraTrainerConfig(task="text", n_train=16, save_dir=save_dir),
                          device=dev)
        batch = [next(text.train_ds.batches(text.batch_size))]
        text.kd_step(batch)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        text_ms, (loss, _) = timed_sync(lambda: text.kd_step(batch))
        text_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[lra] text KD step {text.batch_size}x{text.train_ds.input_ids.shape[1]} "
            f"({text.s_cfg.num_layers} layers, "
            f"width {text.s_cfg.hidden_size}, remat {text.s_cfg.remat_layers}): {text_ms:.2f} ms, "
            f"peak {text_peak:.2f} GiB, loss {float(loss):.6f}")
        require(math.isfinite(float(loss)), "the text KD loss")
        del text
    torch.cuda.empty_cache()
    return dict(launches=launches, err=err, step_ms=step_ms, peak=step_peak, text_ms=text_ms,
                text_peak=text_peak)


# ---------------------------------------------------------------------------
# Decode and serving
# ---------------------------------------------------------------------------


def decode_model():
    """OPT-125m at DECODE_LAYERS layers with the decode cache: `opt_config`
    plus use_cache, seeded random weights, float32."""
    cfg = dataclasses.replace(opt_125m("perlin"), sea=opt_config(use_cache=True),
                              num_layers=DECODE_LAYERS)
    return OptForCausalLM(cfg, device="cuda", seed=0).eval()


def valid_ids(x, vocab) -> bool:
    return bool(((x >= 0) & (x < vocab)).all())


def decode_steps(model, tokens, states, start):
    """Decode steps fed `tokens` (N, n) from position `start`: the per-step
    logits (N, n, V), the per-layer top-k rows of each step (buffer
    'decode_mask_m', step-major) and the final states."""
    bench = get_bench()
    bench.activate_temp_buffers(True)
    pos = torch.full((), start, dtype=torch.int32, device=tokens.device)
    rows = []
    for i in range(tokens.shape[1]):
        lg, states = model.decode_step(tokens[:, i:i + 1], pos + i, states)
        rows.append(lg)
    masks = bench.buffers.get("decode_mask_m", [])
    bench.activate_temp_buffers(False)
    return torch.cat(rows, dim=1), masks, states


def decode_ms(model, prompt, steps, reps=3, max_len=None):
    """Median host ms per step of `steps` greedy decode steps after a
    parallel prefill (the prefill not timed), over `reps` runs; caches of
    `max_len` (DECODE_MAX_LEN by default)."""
    times = []
    for _ in range(reps):
        logits, states = model.prefill_parallel(prompt, max_len or DECODE_MAX_LEN,
                                                last_only=True)
        tok = logits[:, -1].argmax(-1)[:, None]
        pos = torch.full((), prompt.shape[1], dtype=torch.int32, device=prompt.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            lg, states = model.decode_step(tok, pos + i, states)
            tok = lg[:, 0].argmax(-1)[:, None]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / steps)
    return statistics.median(times), times


def phase_decode():
    dev = "cuda"
    t0 = time.perf_counter()
    model = decode_model()
    cfg = model.cfg
    L, V = cfg.num_layers, cfg.vocab_size
    torch.cuda.synchronize()
    log(f"[decode] OPT-125m with the decode cache built on {dev} in "
        f"{time.perf_counter() - t0:.1f} s")
    g = torch.Generator().manual_seed(19)
    prompt = torch.randint(4, V, (1, DECODE_P), generator=g).to(dev)

    # the main path: greedy generation, the prompt prefilled in one forward
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    tokens = model.generate_greedy(prompt, DECODE_MAX_LEN, DECODE_STEPS, parallel_prefill=True)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[decode] main path: generate_greedy 1x{DECODE_P} -> {DECODE_STEPS} tokens, "
        f"max_len {DECODE_MAX_LEN}, parallel prefill: {wall:.1f} ms, peak {peak:.2f} GiB; "
        f"kernel launches {counts}")
    launches = counts["K1"]
    require(launches == L, f"the prefill launched K1 {launches} times, not {L}")
    others = {kid: n for kid, n in counts.items() if kid != "K1" and n}
    require(not others, f"the decode path launched other kernels: {others}")
    require(tokens.shape == (1, DECODE_STEPS) and valid_ids(tokens, V), "greedy tokens")

    # layer 0's K1 inputs, captured from the prefill
    check = layer0_k1("decode", lambda: model.prefill_parallel(
        prompt, DECODE_MAX_LEN, last_only=True))

    # the decode logits against the full forward of the generated sequence
    bench = get_bench()
    bench.activate_temp_buffers(True)
    last, states = model.prefill_parallel(prompt, DECODE_MAX_LEN, last_only=True)
    pre_masks = bench.buffers["partial_attention_mask_before_interp"]
    bench.activate_temp_buffers(False)
    dec, dec_masks, _ = decode_steps(model, tokens, states, DECODE_P)
    require(torch.equal(last[:, -1].argmax(-1), tokens[:, 0])
            and torch.equal(dec[:, :-1].argmax(-1), tokens[:, 1:]),
            "the decode steps do not reproduce generate_greedy's tokens")
    seq = torch.cat([prompt, tokens], dim=1)
    bench.activate_temp_buffers(True)
    with torch.inference_mode():
        full = model(seq, torch.ones_like(seq))["logits"][:, DECODE_P:]
    fwd_masks = bench.buffers["partial_attention_mask_before_interp"]
    bench.activate_temp_buffers(False)
    differ = torch.zeros(DECODE_STEPS, dtype=torch.bool)
    for i in range(DECODE_STEPS):
        for li in range(L):
            d = dec_masks[i * L + li][0, :, 0] > -1
            f = fwd_masks[li][0, :, DECODE_P + i] > -1
            differ[i] |= bool((d != f).any())
    # the prompt's rows: the prefill's benchmark path against the forward's
    # dense path, the same estimator on hidden states that differ by the paths
    pre_differ = torch.zeros(DECODE_P, dtype=torch.bool, device=dev)
    for li in range(L):
        pre = pre_masks[li][0] > 0
        fwd = fwd_masks[li][0, :, :DECODE_P] > -1
        pre_differ |= (pre != fwd).any(-1).any(0)
    bench.buffers = {}
    del fwd_masks, pre_masks
    gap = (dec - full).abs().amax(-1)[0].cpu()
    agree = (dec.argmax(-1) == full.argmax(-1))[0].cpu()
    same = ~differ
    n_same = int(same.sum())
    log(f"[decode] prompt rows whose picks differ in some layer between the prefill "
        f"(benchmark path) and the forward (dense path): {int(pre_differ.sum())} of {DECODE_P}")
    log(f"[decode] decode vs the full forward at positions {DECODE_P}-"
        f"{DECODE_P + DECODE_STEPS - 1}: {int(differ.sum())} of {DECODE_STEPS} rows pick "
        f"otherwise in some layer; over all rows max|gap| {float(gap.max()):.3g}, argmax "
        f"agreement {float(agree.float().mean()):.4f}; over the {n_same} rows that pick "
        f"alike max|gap| {float(gap[same].max()) if n_same else float('nan'):.3g}, "
        f"argmax agreement {float(agree[same].float().mean()) if n_same else float('nan'):.4f}")
    require(n_same * 2 > DECODE_STEPS, "most decoded rows pick otherwise than the forward")
    require(float(gap[same].max()) <= DECODE_TOL and bool(agree[same].all()),
            "decode against the forward on rows that pick alike")

    # paged decode against contiguous decode, from the prefilled prompt
    ps = PAGE_SIZE
    mp = DECODE_MAX_LEN // ps
    pages = (torch.randperm(mp, generator=torch.Generator().manual_seed(29)) + 1)[None].to(dev)
    Hh, Dd = cfg.sea.num_heads, cfg.sea.head_dim
    pool_k = torch.zeros((L, mp + 1, ps, Hh, Dd), device=dev)
    pool_v = torch.zeros_like(pool_k)
    pos = torch.arange(DECODE_P, device=dev)
    page_of, offset = pages[0, pos // ps], pos % ps
    for li, st in enumerate(states):
        pool_k[li, page_of, offset] = st.k_cache[0, :, :DECODE_P].transpose(0, 1)
        pool_v[li, page_of, offset] = st.v_cache[0, :, :DECODE_P].transpose(0, 1)
    paged = [st._replace(k_cache=st.k_cache[:, :, :0], v_cache=st.v_cache[:, :, :0])
             for st in states]
    contiguous = states
    start = torch.full((), DECODE_P, dtype=torch.int32, device=dev)
    paged_err = 0.0
    for i in range(PAGED_STEPS):
        tok = tokens[:, i:i + 1]
        lc, contiguous = model.decode_step(tok, start + i, contiguous)
        lp, paged, pool_k, pool_v = model.decode_step_paged(
            tok, start + i, paged, pool_k, pool_v, pages)
        paged_err = max(paged_err, max_err(lc, lp))
    log(f"[decode] paged (pages of {ps}, a scattered table of {mp}) against contiguous "
        f"decode over {PAGED_STEPS} steps from position {DECODE_P}: max|err| {paged_err:.3g}")
    require(paged_err <= PAGED_TOL, f"paged decode against contiguous: {paged_err}")
    del pool_k, pool_v, paged, contiguous

    sampled = model.generate_sample(prompt, DECODE_MAX_LEN, DECODE_STEPS,
                                    torch.Generator(dev).manual_seed(3), temperature=0.8,
                                    top_p=0.9, parallel_prefill=True)
    beams, scores = model.generate_beam(prompt, DECODE_MAX_LEN, BEAM_STEPS,
                                        beam_size=BEAM_SIZE, parallel_prefill=True)
    log(f"[decode] generate_sample (temperature 0.8, top-p 0.9): {DECODE_STEPS} tokens, "
        f"{int((sampled != tokens).sum())} differ from greedy; generate_beam ({BEAM_SIZE} "
        f"beams, {BEAM_STEPS} steps): scores {[round(float(x), 4) for x in scores[0]]}")
    require(sampled.shape == tokens.shape and valid_ids(sampled, V), "sampled tokens")
    require(beams.shape == (1, BEAM_SIZE, BEAM_STEPS) and valid_ids(beams, V), "beam tokens")
    require(bool(torch.isfinite(scores).all()) and bool((scores[:, 1:] <= scores[:, :-1]).all()),
            "beam scores not finite or not best first")
    counts = launch_counts()
    require(counts["K1"] > 0 and not any(n for kid, n in counts.items() if kid != "K1"),
            f"a kernel other than K1 in the decode phase: {counts}")

    # rates: the prefill, and decode steps at N = 1 and N = DECODE_BATCH
    prefill_ms = host_ms(
        lambda: model.prefill_parallel(prompt, DECODE_MAX_LEN, last_only=True), 3)
    step_ms, step_runs = decode_ms(model, prompt, DECODE_STEPS)
    prompts8 = torch.randint(4, V, (DECODE_BATCH, DECODE_P), generator=g).to(dev)
    torch.cuda.reset_peak_memory_stats()
    step8_ms, step8_runs = decode_ms(model, prompts8, DECODE_STEPS)
    peak8 = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[decode] prefill 1x{DECODE_P}: {prefill_ms:.2f} ms ({DECODE_P / prefill_ms * 1e3:.0f} "
        f"tokens/s); decode at N=1: {step_ms:.3f} ms per step ({1e3 / step_ms:.1f} tokens/s; "
        f"runs {[round(x, 3) for x in step_runs]}); at N={DECODE_BATCH}: {step8_ms:.3f} ms per "
        f"step ({DECODE_BATCH * 1e3 / step8_ms:.1f} tokens/s; runs "
        f"{[round(x, 3) for x in step8_runs]}), peak {peak8:.2f} GiB")

    _, states = model.prefill_parallel(prompt, DECODE_MAX_LEN, last_only=True)

    def eight_steps():
        st = states
        for i in range(8):
            _, st = model.decode_step(tokens[:, i:i + 1], start + i, st)

    breakdown(f"8 decode steps (1, 1) from position {DECODE_P}", eight_steps)
    del model, states
    torch.cuda.empty_cache()
    return dict(launches=launches, err=check[-1], prefill_ms=prefill_ms, step_ms=step_ms,
                step8_ms=step8_ms, peak=peak)


def greedy_margins(model, prompt, tokens):
    """The top-2 logit margin of each of `tokens`' greedy picks in a run of
    `prompt` alone (sequential prefill, as `generate_greedy` runs it)."""
    ids = torch.tensor([prompt + tokens], device="cuda")
    states = model.init_decode_states(1, DECODE_MAX_LEN)
    pos = torch.zeros((), dtype=torch.int32, device="cuda")
    margins = []
    for t in range(ids.shape[1] - 1):
        logits, states = model.decode_step(ids[:, t:t + 1], pos + t, states)
        if t >= len(prompt) - 1:
            top2 = torch.topk(logits[0, 0], 2).values
            margins.append(float(top2[0] - top2[1]))
    return margins


def serve_run(model, requests, chunk, mesh=None):
    """Every request through one engine (head-sharded over `mesh`, a group,
    if given), SERVE_FIRST at once and the rest after SERVE_STAGGER decode
    steps: (outputs by request, ms, engine steps, pool bytes), no kernel
    launched."""
    eng = ServingEngine(model, max_slots=SERVE_SLOTS, page_size=PAGE_SIZE,
                        num_pages=1 + SERVE_SLOTS * SERVE_PAGES_PER_SLOT,
                        max_pages_per_slot=SERVE_PAGES_PER_SLOT, seed=0, device="cuda",
                        mesh=mesh)
    pools = eng.pool_k if mesh is not None else [eng.pool_k]
    pool_bytes = 2 * sum(p.numel() * p.element_size() for p in pools)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, n, **kw) for p, n, kw in requests[:SERVE_FIRST]]
    steps = 0
    for _ in range(SERVE_STAGGER // chunk):
        eng.step(chunk)
        steps += 1
    rids += [eng.submit(p, n, **kw) for p, n, kw in requests[SERVE_FIRST:]]
    while eng.has_work:
        eng.step(chunk)
        steps += 1
        require(steps < 10_000, "the engine did not finish")
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    require(not any(counts.values()), f"the engine launched kernels: {counts}")
    outs = []
    for rid, (p, n, _) in zip(rids, requests):
        req = eng.finished[rid]
        require(req.done and not req.truncated and len(req.output) == n
                and all(0 <= x < model.cfg.vocab_size for x in req.output),
                f"request {rid}: {len(req.output)} tokens of {n}, truncated {req.truncated}")
        outs.append(req.output)
    return outs, wall, steps, pool_bytes


def phase_serve():
    model = decode_model()
    V = model.cfg.vocab_size
    rng = np.random.default_rng(23)
    kinds = ({}, dict(temperature=0.8, top_k=50), dict(temperature=0.8, top_p=0.9))
    requests = [(rng.integers(4, V, size=p).tolist(), n, kinds[i % 3])
                for i, (p, n) in enumerate(zip(SERVE_PROMPTS, SERVE_NEW))]
    fed = sum(len(p) + n - 1 for p, n, _ in requests)
    new = sum(SERVE_NEW)
    runs = {}
    for chunk in SERVE_CHUNKS:
        outs, wall, steps, pool_bytes = serve_run(model, requests, chunk)
        runs[chunk] = outs
        log(f"[serve] chunk {chunk}: {len(requests)} requests ({fed} tokens fed, {new} "
            f"generated) in {wall:.1f} ms over {steps} engine steps ({steps * chunk} decode "
            f"steps): {wall / steps:.2f} ms per engine step, {wall / (steps * chunk):.2f} ms "
            f"per decode step; {new / wall * 1e3:.1f} generated tokens/s, {fed / wall * 1e3:.1f} "
            f"fed tokens/s; pools {pool_bytes / 2 ** 20:.1f} MiB "
            f"({SERVE_SLOTS} slots x {SERVE_PAGES_PER_SLOT} pages of {PAGE_SIZE})")
    greedy = [i for i, (_, _, kw) in enumerate(requests) if not kw]
    a, b = SERVE_CHUNKS
    require(all(runs[a][i] == runs[b][i] for i in greedy),
            f"greedy outputs differ between chunk {a} and chunk {b}")
    for i in greedy:
        p, n, _ = requests[i]
        solo = model.generate_greedy(torch.tensor([p], device="cuda"), DECODE_MAX_LEN, n)[0]
        solo = solo.tolist()
        margins = greedy_margins(model, p, solo)
        stop = next((s for s, m in enumerate(margins) if m < NEAR_TIE), n)
        log(f"[serve] greedy request {i} (prompt {len(p)}, {n} tokens): equal to "
            f"generate_greedy alone on {sum(x == y for x, y in zip(runs[a][i], solo))} of {n} "
            f"tokens; compared up to step {stop} (smallest top-2 margin "
            f"{min(margins):.3g})")
        require(runs[a][i][:stop] == solo[:stop],
                f"greedy request {i} differs from generate_greedy before step {stop}")
    del model
    torch.cuda.empty_cache()
    return requests, runs


# ---------------------------------------------------------------------------
# OPT-1.3b in bfloat16: serve, train, decode and serve, KD
# ---------------------------------------------------------------------------


def opt13b(weights=None, method="perlin", remat=False, **sea_kw) -> OptForCausalLM:
    """OPT-1.3b (`opt_1_3b`: hidden 2048, 24 layers, 32 heads of 64, FFN
    8192, bfloat16 compute) at full width and depth on the card, its SEA
    config `opt_config(num_heads=32, head_dim=64, **sea_kw)`, cast to
    bfloat16 as exp_opt27b.py casts its tree: seeded random weights (seed
    0) or `weights`, a state dict (a dense model takes the shared ones);
    `remat` sets `scan_layers` and `scan_remat`."""
    return bf16_opt(opt_1_3b, 64, weights, method, remat, **sea_kw)


def opt27b(weights=None, method="perlin", remat=False, **sea_kw) -> OptForCausalLM:
    """OPT-2.7b (`opt_2_7b`: hidden 2560, 32 layers, 32 heads of 80, FFN
    10240, vocabulary 50272, bfloat16 compute) at full width and depth, as
    `opt13b` builds OPT-1.3b."""
    return bf16_opt(opt_2_7b, 80, weights, method, remat, **sea_kw)


def bf16_opt(builder, head_dim, weights=None, method="perlin", remat=False,
             **sea_kw) -> OptForCausalLM:
    """`builder`'s OPT with 32 heads of `head_dim` on the card, cast to
    bfloat16: seeded random weights drawn on the card (`init_random_` from a
    CUDA generator of seed 0: the CPU takes 25-45 s over 1.3-2.7 G
    parameters, set-up time of no path) or the state dict `weights`;
    `remat` sets `scan_layers` and `scan_remat` (the per-layer remat)."""
    cfg = builder(method, sea=opt_config(num_heads=32, head_dim=head_dim, **sea_kw))
    cfg = dataclasses.replace(cfg, scan_layers=remat, scan_remat=remat)
    # built on the card, where the layers' default init (overwritten below)
    # takes no host time
    with torch.device("cuda"):
        model = OptForCausalLM(cfg, device="cuda", seed=None)
    if weights is None:
        init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    model.to(torch.bfloat16)
    if weights is not None:
        missing, _ = model.load_state_dict(weights, strict=False)
        require(not missing, f"{builder.__name__} weights missing {missing[:4]}")
    return model.eval()


def bf16_want(**kw) -> dict:
    """Launches per step or forward: `kw` for the kernels named, in both
    counts (all and bf16 instance), 0 for every other kernel."""
    want = dict.fromkeys(launch_counts(), 0)
    for kid, n in kw.items():
        want[kid] = want[f"{kid} bf16"] = n
    return want


def train_want(layers: int, remat: bool, bf16: bool) -> dict:
    """A fused train step's launches: K2, K3 and K4 once a layer, K2 twice
    under the per-layer remat (the backward recomputes each layer's forward),
    in the bf16 instances or the float32 ones; 0 for every other kernel."""
    n = dict(K2=2 * layers if remat else layers, K3=layers, K4=layers)
    return bf16_want(**n) if bf16 else {**bf16_want(), **n}


def phase_opt13b_serve(weights):
    """OPT-1.3b's SEA student with bf16 parameters, forward at 1 x 2048 on
    the benchmark path: 24 launches of K1's bf16 instance and no other
    kernel; layer 0's K1 against its plain version; ms, tokens/s and peak
    memory beside the dense model on the same weights. Then the promotion
    rule on the card: float32 parameters with compute_dtype bfloat16 run
    every projection and K1 in float32 (24 launches of K1's float32
    instance), only the embedding and the layer outputs bf16. Returns
    (K1 launches of each instance, layer 0's K1 inputs and max|err|)."""
    model = opt13b(weights)
    L, V = model.cfg.num_layers, model.cfg.vocab_size
    g = torch.Generator().manual_seed(31)
    ids = torch.randint(4, V, (1, OPT13B_T), generator=g).to("cuda")
    am = torch.ones_like(ids)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with torch.inference_mode():
        logits = model(ids, am, benchmarking=True)["logits"]
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[opt13b-serve] OPT-1.3b perlin, bf16 parameters, 1x{OPT13B_T}: logits "
        f"{tuple(logits.shape)} {str(logits.dtype)[6:]} finite="
        f"{bool(torch.isfinite(logits).all())}, launches {counts}, peak {peak:.2f} GiB")
    require(counts == bf16_want(K1=L), f"OPT-1.3b forward launches {counts}")
    require(logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all()),
            "OPT-1.3b logits")
    captured = layer0_k1("opt13b-serve", lambda: model(ids, am, benchmarking=True))
    ms, _ = forward_ms(model, ids, am, iters=BIG_FORWARD_ITERS)
    del model
    dense = opt13b(weights, "none")
    dense_ms, _ = forward_ms(dense, ids, am, iters=BIG_FORWARD_ITERS)
    del dense
    torch.cuda.empty_cache()
    log(f"[opt13b-serve] {ms:.2f} ms per forward ({OPT13B_T / ms * 1e3:.0f} tokens/s), dense "
        f"OPT-1.3b on the same bf16 weights {dense_ms:.2f} ms ({OPT13B_T / dense_ms * 1e3:.0f} "
        f"tokens/s)")

    # the promotion rule: float32 parameters, bfloat16 compute
    model32 = opt13b({n: w.float() for n, w in weights.items()}).float()
    require(model32.cfg.compute_dtype == "bfloat16", "the builder's compute type")
    reset_launches()
    with torch.inference_mode():
        out = model32(ids, am, benchmarking=True, output_hidden_states=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    types = {str(h.dtype)[6:] for h in out["hidden_states"]}
    log(f"[opt13b-serve] float32 parameters, compute_dtype bfloat16: launches {counts}; "
        f"embedding and layer outputs {types}, logits {str(out['logits'].dtype)[6:]}")
    require(counts == {**bf16_want(), "K1": L}, f"promotion-rule launches {counts}")
    require(types == {"bfloat16"} and out["logits"].dtype == torch.float32
            and bool(torch.isfinite(out["logits"]).all()), "promotion-rule types")
    del model32, out
    torch.cuda.empty_cache()
    return L, captured


def phase_opt13b_train(weights):
    """OPT-1.3b with use_fused_train and bf16 parameters, OPT13B_TRAIN_STEPS
    AdamW steps on 1 x 2048: 24 launches each of K2, K3 and K4's bf16
    instances a step and no other kernel, the loss finite and falling;
    layer 0's kernel inputs and incoming gradient from one more step held
    against the plain versions (`check_bf16_kernels`), K2 reproducing the
    step's output bit for bit, and timed. Then the remat arm on the same
    weights and batch (`scan_layers`, `scan_remat`), OPT13B_REMAT_STEPS
    steps: 48 launches of K2 and
    24 each of K3 and K4 a step, the first loss equal to the plain arm's bit
    for bit (a difference within half a bf16 ulp of the loss is logged as a
    finding, a larger one fails), the loss falling, layer 0's recomputed
    top-k mask equal to the forward's; both arms' peaks logged. Returns
    ({kernel: bf16 launches}, {kernel: max|err|}, times, peaks)."""
    model = opt13b(weights, use_fused_train=True)
    L, V = model.cfg.num_layers, model.cfg.vocab_size
    g = torch.Generator().manual_seed(37)
    ids = torch.randint(4, V, (1, OPT13B_T), generator=g).to("cuda")
    losses, times, launches, peak = run_train(
        model, ids, OPT13B_TRAIN_STEPS, f"opt13b 1x{OPT13B_T}",
        want=train_want(L, False, True), lr=OPT13B_TRAIN_LR)
    require(losses[-1] < losses[0], f"the OPT-1.3b loss did not fall: {losses}")
    q, k, v, mask, sc, do, step_o = capture_layer0(model, ids)
    del model
    torch.cuda.empty_cache()
    errs, got = check_bf16_kernels(f"opt13b layer-0 1x{OPT13B_T}", q, k, v, mask, sc, do)
    require(torch.equal(got[0], step_o), "K2 on the captured inputs differs from the step's output")
    measured = measure_train(q, k, v, mask, sc, do)
    log_times(f"opt13b layer-0 1x{OPT13B_T} bf16", measured)
    del q, k, v, mask, sc, do, step_o, got
    torch.cuda.empty_cache()

    # the remat arm: the same weights and batch under the per-layer remat
    model = opt13b(weights, use_fused_train=True, remat=True)
    r_losses, r_times, r_launches, r_peak = run_train(
        model, ids, OPT13B_REMAT_STEPS, f"opt13b remat 1x{OPT13B_T}",
        want=train_want(L, True, True), lr=OPT13B_TRAIN_LR)
    require(r_losses[-1] < r_losses[0], f"the OPT-1.3b remat loss did not fall: {r_losses}")
    first_gap = abs(r_losses[0] - losses[0])
    log(f"[opt13b-train] remat arm against the plain arm on the same weights and batch: "
        f"first loss {r_losses[0]!r} vs {losses[0]!r} (bit for bit: {first_gap == 0.0}), "
        f"losses {r_losses} vs {losses}; {statistics.median(r_times[1:]):.2f} vs "
        f"{statistics.median(times[1:]):.2f} ms a step, peak {r_peak:.2f} vs {peak:.2f} GiB")
    require(first_gap <= RING_BF16_LOSS_REL * abs(losses[0]),
            f"the remat arm's first loss {r_losses[0]} is not the plain arm's {losses[0]}")
    capture_layer0(model, ids)  # the recompute's top-k mask against the forward's
    del model
    torch.cuda.empty_cache()
    launches = {kid: launches[f"{kid} bf16"] + r_launches[f"{kid} bf16"] for kid in TRAIN_KERNELS}
    return launches, errs, measured, dict(plain=peak, remat=r_peak)


def solo_greedy(model, prompt, n, dtype, max_len=OPT13B_MAX_LEN):
    """`prompt` alone through decode steps at states of `dtype` (the
    engine's), then n greedy steps: (tokens, top-2 margin at each pick)."""
    ids = torch.tensor([prompt], device="cuda")
    states = model.init_decode_states(1, max_len, dtype)
    pos = torch.zeros((), dtype=torch.int32, device="cuda")
    tokens, margins = [], []
    for t in range(len(prompt) + n - 1):
        tok = ids[:, t:t + 1] if t < len(prompt) else torch.tensor([[tokens[-1]]], device="cuda")
        logits, states = model.decode_step(tok, pos + t, states)
        if t >= len(prompt) - 1:
            top2 = torch.topk(logits[0, 0].float(), 2)
            tokens.append(int(top2.indices[0]))
            margins.append(float(top2.values[0] - top2.values[1]))
    return tokens, margins


def decode_vs_forward(phase, model, prompt, tokens, max_len, rel=OPT13B_DECODE_REL):
    """The greedy run's decode steps (bf16 parameters and states) against
    the dense forward of the generated sequence: `prompt` (1, P) prefilled
    in parallel, then the decode steps fed `tokens` (1, n), which must
    reproduce them and launch no kernel; every row within `rel` of the
    forward's largest |logit| (JAX's own bf16 gap, PERF.md) and the
    same argmax wherever the forward's top-2 margin exceeds twice the row's
    gap. In bf16 every row picks otherwise in some layer, so no row is left
    out: the layers that differ are counted."""
    L = model.cfg.num_layers
    P, n = prompt.shape[1], tokens.shape[1]
    last, states = model.prefill_parallel(prompt, max_len, last_only=True)
    require(all(st.k_cache.dtype == torch.bfloat16 and st.performer_S.dtype == torch.float32
                for st in states), "prefill state types")
    torch.cuda.synchronize()
    reset_launches()
    dec, dec_masks, _ = decode_steps(model, tokens, states, P)
    torch.cuda.synchronize()
    counts = launch_counts()
    require(not any(counts.values()), f"{phase}: the decode steps launched kernels: {counts}")
    require(torch.equal(last[:, -1].argmax(-1), tokens[:, 0])
            and torch.equal(dec[:, :-1].argmax(-1), tokens[:, 1:]),
            "the decode steps do not reproduce generate_greedy's tokens")
    seq = torch.cat([prompt, tokens], dim=1)
    bench = get_bench()
    bench.activate_temp_buffers(True)
    with torch.inference_mode():
        full = model(seq, torch.ones_like(seq))["logits"][:, P:]
    fwd_masks = bench.buffers["partial_attention_mask_before_interp"]
    bench.activate_temp_buffers(False)
    # layers in which each decoded row picks otherwise than the forward's row
    differ = torch.zeros(n, dtype=torch.int64)
    for i in range(n):
        for li in range(L):
            d = dec_masks[i * L + li][0, :, 0] > -1
            f = fwd_masks[li][0, :, P + i] > -1
            differ[i] += int(bool((d != f).any()))
    bench.buffers = {}
    del fwd_masks
    dec, full = dec.float(), full.float()
    gap = (dec - full).abs().amax(-1)[0].cpu()
    top2 = torch.topk(full[0], 2, dim=-1).values.cpu()
    margin = top2[:, 0] - top2[:, 1]
    agree = (dec.argmax(-1) == full.argmax(-1))[0].cpu()
    bound = rel * float(full.abs().max())
    decided = margin > 2 * gap
    log(f"[{phase}] decode vs the dense forward at positions {P}-{P + n - 1}: "
        f"{int((differ > 0).sum())} of {n} rows pick otherwise in some of the {L} layers "
        f"(a row in {float(differ.float().mean()):.2f} layers on average, at most "
        f"{int(differ.max())}); over every row max|gap| {float(gap.max()):.4g} (bound "
        f"{bound:.4g} = {rel} x max|logit| {float(full.abs().max()):.4g}), "
        f"argmax agreement {float(agree.float().mean()):.4f}; {int(decided.sum())} rows whose "
        f"top-2 margin exceeds twice their gap, all agreeing: {bool(agree[decided].all())}")
    require(float(gap.max()) <= bound and bool(agree[decided].all()),
            f"{phase}: bf16 decode against the forward")
    return float(gap.max()), float(full.abs().max())


def bf16_engine(phase, model, requests, max_len):
    """The serving engine in bf16 (`dtype=torch.bfloat16`), one slot per
    request of `requests` [(prompt, new tokens)], greedy: no kernel, bf16
    pools, every request finished with valid ids, each equal to its prompt
    decoded alone at the engine's state type up to its first top-2 margin
    under OPT13B_NEAR_TIE. Returns (generated tokens, ms)."""
    V = model.cfg.vocab_size
    ps = PAGE_SIZE
    eng = ServingEngine(model, max_slots=len(requests), page_size=ps,
                        num_pages=1 + len(requests) * (max_len // ps),
                        max_pages_per_slot=max_len // ps, seed=0,
                        dtype=torch.bfloat16, device="cuda")
    require(eng.pool_k.dtype == torch.bfloat16, "the engine's pools")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, m) for p, m in requests]
    out = eng.run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    require(not any(counts.values()), f"the bf16 engine launched kernels: {counts}")
    new = sum(m for _, m in requests)
    log(f"[{phase}] engine, bf16 pools and states, {len(requests)} slots: "
        f"{len(requests)} greedy requests (prompts {[len(p) for p, _ in requests]}) -> {new} "
        f"tokens in {wall:.1f} ms ({new / wall * 1e3:.1f} tokens/s); pools "
        f"{tuple(eng.pool_k.shape)}, {2 * eng.pool_k.numel() * eng.pool_k.element_size() / 2 ** 20:.1f} MiB")
    for rid, (p, m) in zip(rids, requests):
        got = out[rid].output
        require(out[rid].done and len(got) == m and all(0 <= x < V for x in got),
                f"request {rid}")
        solo, margins = solo_greedy(model, p, m, torch.bfloat16, max_len)
        stop = next((s for s, x in enumerate(margins) if x < OPT13B_NEAR_TIE), m)
        log(f"[{phase}] request {rid} (prompt {len(p)}): equal to solo decoding on "
            f"{sum(a == b for a, b in zip(got, solo))} of {m} tokens, compared up to step "
            f"{stop} (smallest top-2 margin {min(margins):.4g})")
        require(got[:stop] == solo[:stop], f"engine request {rid} differs from solo decoding")
    del eng
    return new, wall


def phase_opt13b_decode(weights):
    """OPT-1.3b with the decode cache and bf16 parameters: generate_greedy
    of 16 tokens from a 1 x 512 prompt prefilled in one forward (24 bf16
    K1 launches, no other kernel); the decode logits against the dense
    forward of the generated sequence within OPT13B_DECODE_REL of the
    forward's largest |logit| (JAX's own bf16 gap, PERF.md), and the same
    argmax wherever the forward's top-2 margin exceeds twice the row's gap.
    In bf16 over 24 layers every row picks otherwise in some layer, so no
    row is left out: the bound, as JAX's measurement, covers rows that pick
    otherwise (the layers that differ are counted). Then the serving engine in
    bf16 (`dtype=torch.bfloat16`), 4 slots, 4 greedy requests, each equal
    to its prompt decoded alone at the engine's state type up to its first
    near tie. Returns the prefill's K1 launches."""
    model = opt13b(weights, use_cache=True)
    L, V = model.cfg.num_layers, model.cfg.vocab_size
    P, n = OPT13B_P, OPT13B_STEPS
    g = torch.Generator().manual_seed(41)
    prompt = torch.randint(4, V, (1, P), generator=g).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    tokens = model.generate_greedy(prompt, OPT13B_MAX_LEN, n, parallel_prefill=True)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[opt13b-decode] generate_greedy 1x{P} -> {n} tokens, bf16 parameters and states: "
        f"{wall:.1f} ms, peak {peak:.2f} GiB; launches {counts}")
    require(counts == bf16_want(K1=L), f"OPT-1.3b decode launches {counts}")
    require(tokens.shape == (1, n) and valid_ids(tokens, V), "greedy tokens")

    decode_vs_forward("opt13b-decode", model, prompt, tokens, OPT13B_MAX_LEN)

    # the serving engine in bf16
    rng = np.random.default_rng(43)
    requests = [(rng.integers(4, V, size=p).tolist(), m)
                for p, m in zip(OPT13B_SERVE_PROMPTS, OPT13B_SERVE_NEW)]
    bf16_engine("opt13b-decode", model, requests, OPT13B_MAX_LEN)
    del model
    torch.cuda.empty_cache()
    return L


def phase_opt13b_kd():
    """The KD trainer on OPT-1.3b as exp_opt13b.py configures it
    (`OptTrainer(model="opt-1.3b", scan_kd=True, logit_chunk=256,
    param_dtype="bfloat16", moment_dtype="bfloat16")`, 1 x 1024 windows,
    accumulation 1) for 2 updates: the scanned pair (`SeaOptKDScan`), no
    kernel, every logged term finite, the student moved and the teacher
    unchanged bit for bit, AdamW's first moment bf16; ms per micro-step and
    peak memory."""
    with tempfile.TemporaryDirectory() as save_dir:
        cfg = TrainerConfig(model="opt-1.3b", param_dtype="bfloat16", moment_dtype="bfloat16",
                            max_seq_len=OPT13B_KD_T, stride=OPT13B_KD_T // 2,
                            gradient_accumulation_steps=OPT13B_KD_ACCUM,
                            num_steps=OPT13B_KD_STEPS, log_steps=1, eval_steps=10 ** 9,
                            scan_kd=True, logit_chunk=LOGIT_CHUNK, save_dir=save_dir)
        t0 = time.perf_counter()
        tr = OptTrainer(cfg, device="cuda")
        torch.cuda.synchronize()
        log(f"[opt13b-kd] OPT-1.3b teacher and student (bf16 parameters, compute "
            f"{tr.s_cfg.compute_dtype}, scan_kd, logit_chunk {tr.kd.logit_chunk}) built in "
            f"{time.perf_counter() - t0:.1f} s")
        require(isinstance(tr.kd, SeaOptKDScan) and tr.kd.logit_chunk == LOGIT_CHUNK,
                "the OPT-1.3b KD trainer does not run the scanned pair")
        require(all(p.dtype == torch.bfloat16 for m in (tr.teacher, tr.student)
                    for p in m.parameters()), "KD parameters not bf16")
        student0 = [p.detach().clone() for p in tr.student.parameters()]
        teacher0 = [p.detach().clone() for p in tr.teacher.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        micro = OPT13B_KD_STEPS * OPT13B_KD_ACCUM
        with open(tr.metrics_path) as f:
            records = [json.loads(line) for line in f if "loss_kd_hidden" in line]
        terms = [{k: v for k, v in r.items() if k.startswith("loss") or k == "student_task_loss"}
                 for r in records]
        moved = sum(not torch.equal(p, p0) for p, p0 in zip(tr.student.parameters(), student0))
        same = all(torch.equal(p, p0) for p, p0 in zip(tr.teacher.parameters(), teacher0))
        log(f"[opt13b-kd] {OPT13B_KD_STEPS} updates ({micro} micro-steps of 1x{OPT13B_KD_T}) in "
            f"{wall:.1f} ms: {wall / micro:.2f} ms per micro-step "
            f"({OPT13B_KD_T * micro / wall * 1e3:.0f} tokens/s), peak {peak:.2f} GiB; launches "
            f"{counts}; {moved} of {len(student0)} student tensors moved, teacher unchanged "
            f"{same}; terms {terms}")
        require(tr.step == OPT13B_KD_STEPS, f"the KD trainer took {tr.step} steps")
        require(not any(counts.values()), f"the KD step launched kernels: {counts}")
        require(len(terms) == OPT13B_KD_STEPS
                and all(math.isfinite(v) for r in terms for v in r.values()),
                f"KD terms not finite: {terms}")
        require(moved > 0 and same, "the student did not move or the teacher did")
        require(all(m.dtype == torch.bfloat16 for m in tr.optimizer.mu), "AdamW's mu not bf16")
        del tr, student0, teacher0
    torch.cuda.empty_cache()
    return dict(micro_ms=wall / micro, peak=peak)


# ---------------------------------------------------------------------------
# OPT-2.7b in bfloat16 (head width 80): serve, decode, train; the bf16 ring
# ---------------------------------------------------------------------------


def phase_opt27b_serve(weights):
    """OPT-2.7b's SEA student with bf16 parameters, forward at 1 x 2048 on
    the benchmark path: 32 launches of K1's bf16 instance (head width 80)
    and no other kernel; layer 0's top-k against the CPU's and K1 against
    its plain version; ms and tokens/s beside the dense OPT-2.7b on the same
    weights. Then float32 parameters under bf16 compute: 32 launches of K1's
    float32 instance and none of its bf16 one, layer 0's K1 checked. Returns
    (K1 launches of each type, layer 0's bf16 and float32 K1 inputs)."""
    model = opt27b(weights)
    L, V = model.cfg.num_layers, model.cfg.vocab_size
    require(model.cfg.head_dim == model.cfg.sea.head_dim == WIDE_D, "OPT-2.7b's head width")
    ids = torch.randint(4, V, (1, OPT27B_T), generator=torch.Generator().manual_seed(51)).cuda()
    am = torch.ones_like(ids)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with torch.inference_mode():
        logits = model(ids, am, benchmarking=True)["logits"]
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[opt27b-serve] OPT-2.7b perlin (32 heads of {WIDE_D}), bf16 parameters, "
        f"1x{OPT27B_T}: logits {tuple(logits.shape)} {str(logits.dtype)[6:]} finite="
        f"{bool(torch.isfinite(logits).all())}, launches {counts}, peak {peak:.2f} GiB")
    require(counts == bf16_want(K1=L), f"OPT-2.7b forward launches {counts}")
    require(logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all()),
            "OPT-2.7b logits")
    del logits
    captured = layer0_k1("opt27b-serve", lambda: infer(model, ids, am))
    get_bench().reset()
    ms, _ = forward_ms(model, ids, am)
    del model
    torch.cuda.empty_cache()
    dense = opt27b(weights, "none")
    dense_ms, _ = forward_ms(dense, ids, am)
    del dense
    torch.cuda.empty_cache()
    log(f"[opt27b-serve] {ms:.2f} ms per forward ({OPT27B_T / ms * 1e3:.0f} tokens/s), dense "
        f"OPT-2.7b on the same bf16 weights {dense_ms:.2f} ms ({OPT27B_T / dense_ms * 1e3:.0f} "
        f"tokens/s)")

    # the promotion rule: float32 parameters, bfloat16 compute
    model32 = opt27b({n: w.float() for n, w in weights.items()}).float()
    require(model32.cfg.compute_dtype == "bfloat16", "the builder's compute type")
    reset_launches()
    with torch.inference_mode():
        out = model32(ids, am, benchmarking=True, output_hidden_states=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    types = {str(h.dtype)[6:] for h in out["hidden_states"]}
    log(f"[opt27b-serve] float32 parameters, compute_dtype bfloat16: launches {counts}; "
        f"embedding and layer outputs {types}, logits {str(out['logits'].dtype)[6:]}")
    require(counts == {**bf16_want(), "K1": L}, f"promotion-rule launches {counts}")
    require(types == {"bfloat16"} and out["logits"].dtype == torch.float32
            and bool(torch.isfinite(out["logits"]).all()), "promotion-rule types")
    del out
    captured32 = layer0_k1("opt27b-serve", lambda: infer(model32, ids, am))
    get_bench().reset()
    require(captured32[0].dtype == torch.float32, "the promotion rule's layer-0 K1 inputs")
    del model32
    torch.cuda.empty_cache()
    return {"bfloat16": L, "float32": L}, captured, captured32


def phase_opt27b_decode(weights):
    """OPT-2.7b with the decode cache and bf16 parameters, exp_opt27b.py's
    second stage: generate_greedy of 16 tokens from a 1 x 256 prompt
    prefilled in one forward (32 bf16 K1 launches at width 80, no other
    kernel; the decode steps none), then `decode_vs_forward`. Returns the
    prefill's K1 launches."""
    model = opt27b(weights, use_cache=True)
    L, V = model.cfg.num_layers, model.cfg.vocab_size
    P, n = OPT27B_P, OPT27B_STEPS
    prompt = torch.randint(4, V, (1, P), generator=torch.Generator().manual_seed(53)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    tokens = model.generate_greedy(prompt, P + n, n, parallel_prefill=True)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[opt27b-decode] generate_greedy 1x{P} -> {n} tokens, bf16 parameters and states: "
        f"{wall:.1f} ms, peak {peak:.2f} GiB; launches {counts}")
    require(counts == bf16_want(K1=L), f"OPT-2.7b decode launches {counts}")
    require(tokens.shape == (1, n) and valid_ids(tokens, V), "greedy tokens")
    decode_vs_forward("opt27b-decode", model, prompt, tokens, P + n)
    del model
    torch.cuda.empty_cache()
    return L


def check_arm_layer0(label, arm, q, k, v, mask, sc, do, step_o, scaled_bf16=False):
    """A train arm's layer-0 kernels on its captured inputs and gradient:
    bf16 parameters by `check_bf16_kernels` (with `scaled_bf16` its o and
    lse gates scale-aware), float32 ones by `check_train_kernels` under the
    scale-aware gate and the fused backward at blocks 64 x 64 and 128 x 256
    equal bit for bit; either way K2 must reproduce the step's own output.
    Returns {kernel: max|err|}."""
    if arm == "bfloat16":
        errs, got = check_bf16_kernels(label, q, k, v, mask, sc, do, scaled=scaled_bf16)
        o = got[0]
    else:
        errs = check_train_kernels(label, q, k, v, mask, sc, do, scaled=True)
        o, _ = bs.causal_fwd_stats(diff_operands(q, k, v, mask, sc))
        a = check_fused_backward(label, q, k, v, mask, sc, do, scaled=True)
        b = check_fused_backward(label, q, k, v, mask, sc, do, scaled=True,
                                 block_q=128, block_k=256)
        require(all(torch.equal(x, y) for x, y in zip(a, b)),
                f"{label}: blocks 128 x 256 differ from 64 x 64")
    require(torch.equal(o, step_o), f"{label}: K2 on the captured inputs differs from the "
            "step's output")
    return errs


def phase_opt27b_train(weights):
    """OPT-2.7b with use_fused_train, task-only, two arms. (a) bf16
    parameters and moments under the per-layer remat, 3 AdamW steps (lr
    1e-3) on 1 x 2048: 64 launches of K2's and 32 each of K3 and K4's bf16
    width-80 instances a step and no other kernel, the loss falling, layer
    0's recomputed top-k mask equal to the forward's; layer 0's captured
    inputs and gradient against the plain versions (`check_bf16_kernels`:
    two launches and two block shapes equal bit for bit), K2 reproducing the
    step's output. (b)
    float32 parameters under bf16 compute, 2 steps on 1 x 512: 32 launches
    each of the float32 width-80 instances a step, finite losses; layer 0
    as `check_layer0` holds it, and the 128 x 256 lists equal to the 64 x 64
    ones. Each model is freed before the next. Returns, per arm: launches,
    max|err| and times of K2-K4 at layer 0, ms per step and peak GiB."""
    out = {}
    for arm, (T, steps) in zip(("bfloat16", "float32"), OPT27B_TRAIN):
        remat = arm == "bfloat16"
        if arm == "bfloat16":
            model = opt27b(weights, use_fused_train=True, remat=True)
        else:
            model = opt27b({n: w.float() for n, w in weights.items()}, use_fused_train=True)
            model.float()
        L, V = model.cfg.num_layers, model.cfg.vocab_size
        require(model.cfg.compute_dtype == "bfloat16" and all(
            p.dtype == getattr(torch, arm) for p in model.parameters()), f"arm {arm}: types")
        ids = torch.randint(4, V, (1, T), generator=torch.Generator().manual_seed(57)).cuda()
        label = f"opt27b {arm} parameters 1x{T}" + (" remat" if remat else "")
        losses, times, launches, peak = run_train(model, ids, steps, label,
                                                  want=train_want(L, remat, remat),
                                                  lr=OPT13B_TRAIN_LR)
        if arm == "bfloat16":
            require(losses[-1] < losses[0], f"the OPT-2.7b bf16 loss did not fall: {losses}")
        q, k, v, mask, sc, do, step_o = capture_layer0(model, ids)
        del model
        torch.cuda.empty_cache()
        layer0 = f"opt27b layer-0 1x{T} {arm}"
        errs = check_arm_layer0(layer0, arm, q, k, v, mask, sc, do, step_o)
        measured = measure_train(q, k, v, mask, sc, do)
        log_times(layer0, measured)
        del q, k, v, mask, sc, do, step_o
        torch.cuda.empty_cache()
        steady = statistics.median(times[1:])
        out[arm] = dict(launches={kid: launches[kid] for kid in TRAIN_KERNELS}, errs=errs,
                        m=measured, ms=steady, peak=peak, tokens=T)
        log(f"[opt27b-train] arm {arm} parameters 1x{T}: {steady:.2f} ms per step after the "
            f"first ({T / steady * 1e3:.0f} tokens/s), peak {peak:.2f} GiB; losses {losses}")
    return out


def phase_ring_bf16():
    """OPT-125m (6 of its 12 layers since PR 20) with bf16 parameters and
    bf16 compute at 1 x 16384 inside
    `sharded_attention_scope(LocalGroup(4), kind="auto")` (the ring): the
    forward launches K6's bf16 instance 96 times and nothing else, layer
    0's attention output within 1e-2·max of the unsharded forward's (K1
    bf16); 2 AdamW steps (lr 1e-3) with `use_fused_train` launch K6, K7 and
    K8's bf16 instances 96 times each a step, the loss falling; the
    unsharded arm (K2-K4 bf16) from the same weights and batch, compared by
    `compare_arms` at the bf16 bounds; layer 0's op on the captured inputs
    (ring against unsharded bf16 kernels, and bit for bit against the
    step's own output) and K6-K8 bf16 against their plain versions on every
    (shard, window), timed. Returns (launches of each kernel's bf16
    instance, {kernel: max|err|}, window times)."""
    dev = "cuda"
    T = RING_T
    group = LocalGroup(RING_SHARDS, dev)
    scope = dict(group=group, kind="auto")
    sea = opt_config(max_position_embeddings=T)
    cfg = dataclasses.replace(opt_125m("perlin", sea=sea), max_position_embeddings=T,
                              compute_dtype="bfloat16", num_layers=RING_LAYERS)
    model = OptForCausalLM(cfg, device=dev, seed=0).to(torch.bfloat16).eval()
    L = cfg.num_layers
    n = RING_SHARDS ** 2 * L
    ids = torch.randint(4, cfg.vocab_size, (1, T),
                        generator=torch.Generator().manual_seed(61)).to(dev)
    am = torch.ones_like(ids)
    with sharded_attention_scope(**scope) as ctx:
        require(resolve_attention_kind(ctx, t=T) == "ring", "kind='auto' at 16384")
        reset_launches()
        with torch.inference_mode():
            logits = model(ids, am, benchmarking=True)["logits"]
        torch.cuda.synchronize()
        counts = launch_counts()
    log(f"[ring-bf16] OPT-125m bf16 forward 1x{T} under kind='auto': logits "
        f"{str(logits.dtype)[6:]} finite={bool(torch.isfinite(logits).all())}, launches {counts}")
    require(counts == bf16_want(K6=n), f"bf16 ring forward launches {counts}")
    require(bool(torch.isfinite(logits).all()), "bf16 ring logits")
    fwd_launches = counts["K6 bf16"]
    del logits
    ring = layer0_forward(model, ids, scope)
    plain = layer0_forward(model, ids)
    err_ctx, scale = max_err(ring[1], plain[1]), float(plain[1].float().abs().max())
    log(f"[ring-bf16] layer 0 ring vs unsharded (K1 bf16): attention output max|err| "
        f"{err_ctx:.3g} (max|want| {scale:.3g}); logits after {L} layers "
        f"{max_err(ring[0], plain[0]):.3g}")
    require(err_ctx <= RING_BF16_LAYER_REL * scale, f"bf16 ring layer-0 output: {err_ctx}")
    del ring, plain

    def ring_forward():
        with sharded_attention_scope(**scope), torch.inference_mode():
            model(ids, am, benchmarking=True)

    def plain_forward():
        with torch.inference_mode():
            model(ids, am, benchmarking=True)

    times = {label: host_ms(fn, iters=3)
             for label, fn in (("ring", ring_forward), ("unsharded", plain_forward))}
    log(f"[ring-bf16] forward 1x{T} bf16: ring over {RING_SHARDS} shards {times['ring']:.2f} ms "
        f"({T / times['ring'] * 1e3:.0f} tokens/s), unsharded {times['unsharded']:.2f} ms "
        f"({T / times['unsharded'] * 1e3:.0f} tokens/s)")
    del model
    torch.cuda.empty_cache()

    def train_model():
        return longctx_model(T, L, dev, "bfloat16").to(torch.bfloat16)

    with sharded_attention_scope(group, kind="auto"):
        model = train_model()
        ring = train_arm(model, ids, 2, f"ring bf16 1x{T}", want=bf16_want(K6=n, K7=n, K8=n),
                         lr=OPT13B_TRAIN_LR)
        require(ring["losses"][-1] < ring["losses"][0],
                f"the bf16 ring loss did not fall: {ring['losses']}")
        captured = capture_layer0(model, ids)
    del model
    torch.cuda.empty_cache()
    model = train_model()
    plain = train_arm(model, ids, 2, f"unsharded bf16 1x{T}",
                      want=bf16_want(**dict.fromkeys(TRAIN_KERNELS, L)), lr=OPT13B_TRAIN_LR)
    del model
    torch.cuda.empty_cache()
    compare_arms("ring-bf16", ring, plain,
                 loss_tol=RING_BF16_LOSS_REL * abs(plain["losses"][0]),
                 grad_rel=RING_BF16_GRAD_REL)
    launches = {"K6": fwd_launches + ring["launches"]["K6 bf16"],
                "K7": ring["launches"]["K7 bf16"], "K8": ring["launches"]["K8 bf16"]}
    del ring, plain
    torch.cuda.empty_cache()

    q, k, v, mask, sc, do, step_o = captured
    require(q.dtype == torch.bfloat16, "the bf16 ring's layer-0 inputs")
    got = autograd_outputs(lambda a, b, c, d: sa.ring_fused_train_attention(
        a, b, c, mask, d, group, True, RING_BLOCK, RING_BLOCK), q, k, v, sc, do)
    want = autograd_outputs(lambda a, b, c, d: bs.fused_sparse_attention(a, b, c, mask, d),
                            q, k, v, sc, do)
    # each of (o, dq, dk, dv, dscaler) in bf16, finite, within 1e-2 of its max|want|
    errs = [max_err(g, w) for g, w in zip(got, want)]
    for name, g, w, e in zip(("o", "dq", "dk", "dv", "dscaler"), got, want, errs):
        require(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
                and e <= RING_BF16_LAYER_REL * float(w.float().abs().max()),
                f"ring-bf16 layer-0 {name}: ring vs unsharded max|err| {e:.3g}")
    require(torch.equal(got[0], step_o), "the bf16 ring on the captured inputs differs from "
            "the step's output")
    log(f"[ring-bf16] layer-0 1x{T}: ring (K6-K8 bf16) vs unsharded (K2-K4 bf16) max|err| "
        + ", ".join(f"{nm} {e:.3g}" for nm, e in zip(("o", "dq", "dk", "dv", "dscaler"), errs))
        + "; the ring's output reproduces the step's own bit for bit")
    del got, want
    werrs, timing = ring_windows(f"layer-0 1x{T}", q, k, v, mask, sc, do, timed=True)
    return launches, werrs, timing


# ---------------------------------------------------------------------------
# LLaMA-7b in bfloat16 (heads of 128): serve, decode, the engine, MMLU
# ---------------------------------------------------------------------------


def llama7b(weights=None, method="perlin", dtype=torch.bfloat16, layers=None, remat=False,
            **sea_kw) -> LlamaForCausalLM:
    """LLaMA-7b (`llama_7b`: hidden 4096, 32 layers, 32 heads of 128, SwiGLU
    11008, vocabulary 32000, bfloat16 compute) at full width on the card,
    `layers` deep (all 32 by default), its SEA config `opt_config(num_heads=32,
    head_dim=128, **sea_kw)`, parameters in `dtype`: seeded random weights
    drawn on the card (`init_random_` from a CUDA generator of seed 0: the
    CPU would take minutes over 6.7 G parameters; the same draw gives the
    same weights) or `weights`, a state dict (a dense model takes the shared
    ones; float32 parameters take the bf16 values); `remat` sets
    `scan_layers` and `scan_remat`."""
    cfg = llama_7b(method, sea=opt_config(num_heads=32, head_dim=LLAMA_D, **sea_kw))
    cfg = dataclasses.replace(cfg, scan_layers=remat, scan_remat=remat)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    with torch.device("cuda"):
        model = LlamaForCausalLM(cfg, device="cuda", seed=None)
    if weights is None:
        init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    model.to(dtype)
    if weights is not None:
        missing, _ = model.load_state_dict(weights, strict=False)
        require(not missing, f"llama_7b weights missing {missing[:4]}")
    return model.eval()


def phase_llama7b_serve(weights):
    """LLaMA-7b's SEA student with bf16 parameters, forward at 1 x 2048 on
    the benchmark path: 32 launches of K1's bf16 instance (head width 128)
    and no other kernel; layer 0's top-k against the CPU's and K1 against
    its plain version; finite logits; ms and tokens/s beside the dense
    LLaMA-7b on the same weights. Then float32 parameters under bf16
    compute: 32 launches of K1's float32 instance and none of its bf16 one,
    layer 0's K1 checked. Returns (K1 launches of each type, layer 0's bf16
    and float32 K1 inputs, ms, dense ms)."""
    model = llama7b(weights)
    L, V = model.cfg.num_layers, model.cfg.vocab_size
    require(model.cfg.head_dim == model.cfg.sea.head_dim == LLAMA_D, "LLaMA-7b's head width")
    ids = torch.randint(4, V, (1, LLAMA_T), generator=torch.Generator().manual_seed(61)).cuda()
    am = torch.ones_like(ids)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with torch.inference_mode():
        logits = model(ids, am, benchmarking=True)["logits"]
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[llama7b-serve] LLaMA-7b perlin (32 heads of {LLAMA_D}), bf16 parameters, "
        f"1x{LLAMA_T}: logits {tuple(logits.shape)} {str(logits.dtype)[6:]} finite="
        f"{bool(torch.isfinite(logits).all())}, launches {counts}, peak {peak:.2f} GiB")
    require(counts == bf16_want(K1=L), f"LLaMA-7b forward launches {counts}")
    require(logits.dtype == torch.bfloat16 and logits.shape == (1, LLAMA_T, V)
            and bool(torch.isfinite(logits).all()), "LLaMA-7b logits")
    del logits
    captured = layer0_k1("llama7b-serve", lambda: infer(model, ids, am))
    get_bench().reset()
    ms, _ = forward_ms(model, ids, am, iters=BIG_FORWARD_ITERS)
    del model
    torch.cuda.empty_cache()
    dense = llama7b(weights, "none")
    dense_ms, dense_out = forward_ms(dense, ids, am, iters=BIG_FORWARD_ITERS)
    require(bool(torch.isfinite(dense_out).all()), "dense LLaMA-7b logits not finite")
    del dense, dense_out
    torch.cuda.empty_cache()
    log(f"[llama7b-serve] {ms:.2f} ms per forward ({LLAMA_T / ms * 1e3:.0f} tokens/s), dense "
        f"LLaMA-7b on the same bf16 weights {dense_ms:.2f} ms ({LLAMA_T / dense_ms * 1e3:.0f} "
        f"tokens/s)")

    # the promotion rule: float32 parameters, bfloat16 compute
    model32 = llama7b(weights, dtype=torch.float32)
    require(model32.cfg.compute_dtype == "bfloat16", "the builder's compute type")
    reset_launches()
    with torch.inference_mode():
        out = model32(ids, am, benchmarking=True, output_hidden_states=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    types = {str(h.dtype)[6:] for h in out["hidden_states"]}
    log(f"[llama7b-serve] float32 parameters, compute_dtype bfloat16: launches {counts}; "
        f"embedding and layer outputs {types}, logits {str(out['logits'].dtype)[6:]}")
    require(counts == {**bf16_want(), "K1": L}, f"promotion-rule launches {counts}")
    require(types == {"bfloat16"} and out["logits"].dtype == torch.float32
            and bool(torch.isfinite(out["logits"]).all()), "promotion-rule types")
    del out
    captured32 = layer0_k1("llama7b-serve", lambda: infer(model32, ids, am))
    get_bench().reset()
    require(captured32[0].dtype == torch.float32, "the promotion rule's layer-0 K1 inputs")
    del model32
    torch.cuda.empty_cache()
    return {"bfloat16": L, "float32": L}, captured, captured32, ms, dense_ms


def phase_llama7b_decode(weights):
    """LLaMA-7b with the decode cache and bf16 parameters and states:
    generate_greedy of 16 tokens from a 1 x 256 prompt prefilled in one
    forward (32 bf16 K1 launches at width 128, no other kernel; the decode
    steps none), `decode_vs_forward` within LLAMA_DECODE_REL, then ms per
    decode step beside the step's device bound (every weight but the
    embedding table read once at the HBM rate). Then [llama7b-engine]: the
    bf16 engine at 4 slots on 4 greedy requests (`bf16_engine`). Returns
    the prefill's K1 launches."""
    model = llama7b(weights, use_cache=True)
    L, V = model.cfg.num_layers, model.cfg.vocab_size
    P, n = LLAMA_P, LLAMA_STEPS
    prompt = torch.randint(4, V, (1, P), generator=torch.Generator().manual_seed(63)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    tokens = model.generate_greedy(prompt, P + n, n, parallel_prefill=True)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[llama7b-decode] generate_greedy 1x{P} -> {n} tokens, bf16 parameters and states: "
        f"{wall:.1f} ms, peak {peak:.2f} GiB; launches {counts}")
    require(counts == bf16_want(K1=L), f"LLaMA-7b decode launches {counts}")
    require(tokens.shape == (1, n) and valid_ids(tokens, V), "greedy tokens")
    decode_vs_forward("llama7b-decode", model, prompt, tokens, P + n, LLAMA_DECODE_REL)
    step_ms, runs = decode_ms(model, prompt, n, reps=LLAMA_DECODE_REPS, max_len=P + n)
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters()) - (
        model.model.embed_tokens.weight.numel() * model.model.embed_tokens.weight.element_size())
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[llama7b-decode] {step_ms:.2f} ms per decode step at N=1 (runs "
        f"{', '.join(f'{x:.2f}' for x in runs)}), {1e3 / step_ms:.1f} tokens/s; device bound "
        f"{bound_ms:.3f} ms ({weight_bytes / 1e9:.2f} GB of weights at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")

    rng = np.random.default_rng(67)
    requests = [(rng.integers(4, V, size=p).tolist(), m)
                for p, m in zip(LLAMA_SERVE_PROMPTS, LLAMA_SERVE_NEW)]
    bf16_engine("llama7b-engine", model, requests, LLAMA_ENGINE_MAX_LEN)
    del model
    torch.cuda.empty_cache()
    return L


def phase_llama7b_mmlu(weights):
    """MMLU choice scoring over LLaMA-7b's SEA student (bf16 parameters):
    `evaluate_mmlu` over 64 synthetic examples (`load_mmlu`'s fallback,
    `synthetic_tokenizer`), 0-shot, batches of 8 left-padded prompts, scored
    by `make_choice_score_fn(benchmarking=True)`: 32 K1 launches a batch and
    no other kernel, finite logits, n = 64; the accuracy is a random
    model's. Returns the K1 launches."""
    model = llama7b(weights)
    L, V = model.cfg.num_layers, model.cfg.vocab_size
    examples = load_mmlu(None, synthetic_examples=LLAMA_MMLU_N)
    tok = synthetic_tokenizer(V)
    letters = [tok(c)[0] for c in CHOICES]
    score = make_choice_score_fn(model, benchmarking=True)
    per_batch, widths = [], []

    def counted(ids, mask):
        before = bs.sea_block_sparse_attention.launches
        logits = score(ids, mask)
        per_batch.append(bs.sea_block_sparse_attention.launches - before)
        widths.append(ids.shape[1])
        require(bool(torch.isfinite(logits).all()) and logits.shape == (ids.shape[0], V),
                "MMLU final-position logits")
        return logits

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = evaluate_mmlu(counted, examples, tok, letters, batch_size=LLAMA_MMLU_BATCH)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    log(f"[llama7b-mmlu] {res['n']} synthetic examples, 0-shot, {len(per_batch)} batches of "
        f"{LLAMA_MMLU_BATCH} (left-padded to {min(widths)}-{max(widths)} tokens) in {wall:.1f} ms "
        f"({wall / len(per_batch):.1f} ms a batch): accuracy {res['accuracy']:.4f} (a random "
        f"model's; chance 0.25), K1 launches a batch {per_batch}, launches {counts}")
    require(res["n"] == LLAMA_MMLU_N and per_batch == [L] * len(per_batch),
            f"MMLU: n {res['n']}, K1 launches a batch {per_batch}")
    require(counts == bf16_want(K1=L * len(per_batch)), f"MMLU launches {counts}")
    del model
    torch.cuda.empty_cache()
    return L * len(per_batch)


def phase_llama7b_train():
    """LLaMA-7b with use_fused_train, task-only (CE), two arms, each drawn
    from the seed on the card (the serve phases' weights) and freed before
    the next model. (a) bf16 parameters and moments at full width and depth
    under the per-layer remat and the chunked cross entropy (`logit_chunk`
    256), 3 AdamW steps (lr 1e-3, torch's default multi-tensor AdamW) on 1 x
    2048: 64 launches of K2's and 32 each of K3's and K4's bf16 width-128
    instances a step and no other kernel, the loss falling, layer 0's
    recomputed top-k mask equal to the forward's; layer 0's captured inputs
    and gradient against the plain versions (`check_bf16_kernels` under the
    scale-aware gate: two launches and two block shapes equal bit for bit),
    K2 reproducing the step's output; then, once arm (a)'s model and
    optimizer state are freed, LLAMA_DENSE_STEPS of the dense LLaMA-7b's CE
    steps on the same starting weights and batch, with the same remat and
    chunk. (b) float32 parameters under bf16 compute at LLAMA_F32_LAYERS
    layers (a memory cut), 2 steps on
    1 x 512: 8 launches each of the float32 width-128 instances a step;
    layer 0 as `check_layer0` holds it (the scale-aware gate of OPT-2.7b's
    arm (b)), and the 128 x 256 lists equal to the 64 x 64 ones. Returns,
    per arm: launches, max|err| and times of K2-K4 at layer 0, ms per step,
    peak GiB; and the dense step's ms and peak."""
    out = {}
    for arm, (T, steps) in zip(("bfloat16", "float32"), LLAMA_TRAIN):
        remat = arm == "bfloat16"
        chunk = LOGIT_CHUNK if remat else None
        if arm == "bfloat16":
            model = llama7b(use_fused_train=True, remat=True)
        else:
            model = llama7b(dtype=torch.float32, layers=LLAMA_F32_LAYERS, use_fused_train=True)
        L, V = model.cfg.num_layers, model.cfg.vocab_size
        require(model.cfg.compute_dtype == "bfloat16" and model.cfg.sea.head_dim == LLAMA_D
                and all(p.dtype == getattr(torch, arm) for p in model.parameters()),
                f"LLaMA-7b arm {arm}: types or head width")
        ids = torch.randint(4, V, (1, T), generator=torch.Generator().manual_seed(71)).cuda()
        label = f"llama7b {arm} parameters {L} layers 1x{T}" + (
            f" remat, logit_chunk {chunk}" if remat else "")
        losses, times, launches, peak = run_train(model, ids, steps, label,
                                                  want=train_want(L, remat, remat),
                                                  lr=OPT13B_TRAIN_LR, logit_chunk=chunk)
        if arm == "bfloat16":
            require(losses[-1] < losses[0], f"the LLaMA-7b bf16 loss did not fall: {losses}")
        q, k, v, mask, sc, do, step_o = capture_layer0(model, ids, chunk)
        del model
        torch.cuda.empty_cache()
        dense = None
        if arm == "bfloat16":
            # the yardstick: the dense model's CE step from the same starting
            # weights (drawn again from the seed) on the same batch, with the
            # same remat and chunk
            sea = llama7b()
            shared = {n: w for n, w in sea.state_dict().items() if ".perlin." not in n}
            dense_model = llama7b(shared, "none", remat=True)
            del sea, shared
            torch.cuda.empty_cache()
            _, dense_times, _, dense_peak = run_train(
                dense_model, ids, LLAMA_DENSE_STEPS,
                f"llama7b dense 1x{T} remat, logit_chunk {chunk}",
                lr=OPT13B_TRAIN_LR, logit_chunk=chunk)
            del dense_model
            torch.cuda.empty_cache()
            dense = dict(ms=statistics.median(dense_times[1:]), peak=dense_peak)
        layer0 = f"llama7b layer-0 1x{T} {arm}"
        errs = check_arm_layer0(layer0, arm, q, k, v, mask, sc, do, step_o, scaled_bf16=True)
        measured = measure_train(q, k, v, mask, sc, do)
        log_times(layer0, measured)
        del q, k, v, mask, sc, do, step_o
        torch.cuda.empty_cache()
        steady = statistics.median(times[1:])
        out[arm] = dict(launches={kid: launches[kid] for kid in TRAIN_KERNELS}, errs=errs,
                        m=measured, ms=steady, peak=peak, tokens=T, layers=L, dense=dense)
        log(f"[llama7b-train] arm {arm} parameters, {L} layers, 1x{T}: {steady:.2f} ms per "
            f"step after the first ({T / steady * 1e3:.0f} tokens/s), peak {peak:.2f} GiB; "
            f"losses {losses}" + (f"; the dense LLaMA-7b's CE step {dense['ms']:.2f} ms "
                                 f"({T / dense['ms'] * 1e3:.0f} tokens/s), peak "
                                 f"{dense['peak']:.2f} GiB" if dense else ""))
    return out


def phase_llama7b_kd():
    """The KD trainer on LLaMA-7b (`OptTrainer(model="llama-7b",
    param_dtype="bfloat16", moment_dtype="bfloat16")`: teacher and student
    drawn on the card, 1 x 512 windows, accumulation 1) for 2 updates
    through `train()`: no kernel (the student's dense train path), every
    logged term finite, the student moved and the teacher unchanged bit for
    bit (host copies: the card has no room for a second 12.6 GiB copy), the
    stream's first batch's KD loss lower after the updates, AdamW's first
    moment bf16; ms per micro-step, peak memory, and `evaluate`'s PPL (a
    random model's on the synthetic corpus) and ms per window."""
    with tempfile.TemporaryDirectory() as save_dir:
        cfg = TrainerConfig(model="llama-7b", param_dtype="bfloat16", moment_dtype="bfloat16",
                            max_seq_len=LLAMA_KD_T, stride=LLAMA_KD_T // 2,
                            gradient_accumulation_steps=LLAMA_KD_ACCUM,
                            num_steps=LLAMA_KD_STEPS, log_steps=1, eval_steps=10 ** 9,
                            save_dir=save_dir)
        t0 = time.perf_counter()
        tr = OptTrainer(cfg, device="cuda")
        torch.cuda.synchronize()
        log(f"[llama7b-kd] LLaMA-7b teacher and student (bf16 parameters, compute "
            f"{tr.s_cfg.compute_dtype}, heads of {tr.s_cfg.head_dim}) drawn on the card in "
            f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
        require(isinstance(tr.student, LlamaForCausalLM) and isinstance(tr.teacher,
                                                                        LlamaForCausalLM)
                and tr.s_cfg.head_dim == LLAMA_D
                and all(p.dtype == torch.bfloat16 for m in (tr.teacher, tr.student)
                        for p in m.parameters()), "LLaMA-7b KD models")
        fixed_t = tr._tensors(*next(tr.corpus.batches(cfg.batch_size, shuffle=True,
                                                       seed=cfg.seed)))

        def fixed_loss():
            with torch.no_grad():
                loss, _ = tr.kd.kd_loss(*fixed_t, use_remat=False)
            return float(loss)

        before = fixed_loss()
        student0 = [p.detach().to("cpu", copy=True) for p in tr.student.parameters()]
        teacher0 = [p.detach().to("cpu", copy=True) for p in tr.teacher.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        micro = LLAMA_KD_STEPS * LLAMA_KD_ACCUM
        with open(tr.metrics_path) as f:
            records = [json.loads(line) for line in f if "loss_kd_hidden" in line]
        terms = [{k: v for k, v in r.items() if k.startswith("loss") or k == "student_task_loss"}
                 for r in records]
        moved = sum(not torch.equal(p.detach().cpu(), p0)
                    for p, p0 in zip(tr.student.parameters(), student0))
        same = all(torch.equal(p.detach().cpu(), p0)
                   for p, p0 in zip(tr.teacher.parameters(), teacher0))
        del student0, teacher0
        after = fixed_loss()
        log(f"[llama7b-kd] {LLAMA_KD_STEPS} updates ({micro} micro-steps of 1x{LLAMA_KD_T}) in "
            f"{wall:.1f} ms: {wall / micro:.2f} ms per micro-step "
            f"({LLAMA_KD_T * micro / wall * 1e3:.0f} tokens/s), peak {peak:.2f} GiB; launches "
            f"{counts}; {moved} of {len(list(tr.student.parameters()))} student tensors moved, "
            f"teacher unchanged {same}; the first batch's KD loss {before:.6f} -> {after:.6f}; "
            f"terms {terms}")
        require(tr.step == LLAMA_KD_STEPS, f"the KD trainer took {tr.step} steps")
        require(not any(counts.values()), f"the KD step launched kernels: {counts}")
        require(len(terms) == LLAMA_KD_STEPS
                and all(math.isfinite(v) for r in terms for v in r.values()),
                f"KD terms not finite: {terms}")
        require(moved > 0 and same, "the student did not move or the teacher did")
        require(after < before, f"the fixed batch's KD loss did not fall: {before} -> {after}")
        require(all(m.dtype == torch.bfloat16 for m in tr.optimizer.mu), "AdamW's mu not bf16")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ppl = tr.evaluate(max_batches=LLAMA_KD_EVAL_WINDOWS)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3 / LLAMA_KD_EVAL_WINDOWS
        require(math.isfinite(ppl), f"evaluate's PPL {ppl}")
        log(f"[llama7b-kd] evaluate(max_batches={LLAMA_KD_EVAL_WINDOWS}): PPL {ppl:.4f} (a "
            f"random model's on the synthetic corpus), {eval_ms:.2f} ms per window")
        del tr
    torch.cuda.empty_cache()
    return dict(micro_ms=wall / micro, peak=peak, ppl=ppl, before=before, after=after)


# ---------------------------------------------------------------------------
# item 4 of the port's queue: LoRA, the uniform CSR, the predictor variants,
# the long-context extension and the trainer CLI


def seed_lora_(model, seed, scale=LORA_B_SCALE):
    """Every LoRA delta's A (kaiming-uniform) and B (N(0, scale²)) drawn
    from a generator of `seed` on the model's device: B is zero at init,
    and a zero B makes every delta vanish."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LoraDelta):
                m.reset_parameters(g)
                m.lora_b.copy_(torch.randn(m.lora_b.shape, generator=g, device=dev) * scale)
    return model


def sea_variant(sea, **kw):
    return dataclasses.replace(sea, **kw).validate()


def opt125m_variant(weights=None, seed=0, **sea_kw):
    """OPT-125m's SEA student with its SEA config's fields replaced, on the
    card: random weights from `seed`, or `weights` loaded (the keys it has)."""
    cfg = opt_125m("perlin", sea=sea_variant(opt_config(), **sea_kw))
    model = OptForCausalLM(cfg, device="cuda", seed=seed if weights is None else None).eval()
    if weights is not None:
        missing = model.load_state_dict(weights, strict=False).missing_keys
        require(not missing, f"weights lack {missing[:4]}")
    return model


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms on (warnings only where an op has
    none), then off."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def counted(run):
    """`run()` with the launch counts set to 0 just before and read just
    after: (its result, the counts)."""
    reset_launches()
    out = run()
    torch.cuda.synchronize()
    return out, launch_counts()


def require_launches(phase, counts, **want):
    """Exactly `want`'s launches and none of any other kernel."""
    full = {**dict.fromkeys(counts, 0), **want}
    require(counts == full, f"[{phase}] launches {counts}, want {want} and no other kernel")


def phase_lora():
    dev = "cuda"
    T = LORA_T
    lora_kw = dict(lora_enabled=True, lora_in_approx_enabled=True, lora_r=LORA_R)
    model = seed_lora_(opt125m_variant(**lora_kw), 31)
    n_layers = model.cfg.num_layers
    plain = opt125m_variant(model.state_dict())  # the same base, no deltas
    ids = torch.randint(4, model.cfg.vocab_size, (1, T),
                        generator=torch.Generator().manual_seed(32)).to(dev)
    am = torch.ones_like(ids)
    n_delta = sum(isinstance(m, LoraDelta) for m in model.modules())
    require(n_delta == 8 * n_layers, f"{n_delta} LoRA deltas, want 8 a layer")

    # the main path: the benchmark forward, launches counted around it
    logits, counts = counted(lambda: infer(model, ids, am))
    require_launches("lora", counts, K1=n_layers)
    require(bool(torch.isfinite(logits).all()), "LoRA logits not finite")
    base_logits = infer(plain, ids, am)
    moved = max_err(logits, base_logits)
    log(f"[lora] OPT-125m, both LoRA flags, r={LORA_R}, B ~ N(0, {LORA_B_SCALE}²): 1x{T} "
        f"forward, launches {counts}; logits moved {moved:.3g} from the same base without "
        f"LoRA")
    require(moved > 1e-3, "the LoRA deltas did not move the logits")
    # layer 0's kernel inputs (the score branch's q and k) against the plain version
    *_, err = layer0_k1("lora", lambda: infer(model, ids, am))
    get_bench().reset()
    lora_ms, _ = forward_ms(model, ids, am)
    base_ms, _ = forward_ms(plain, ids, am)
    log(f"[lora] forward 1x{T}: with LoRA {lora_ms:.2f} ms, the same weights without "
        f"{base_ms:.2f} ms")

    # the prefill takes no deltas, as JAX's: equal to the LoRA-free model's
    cached = opt125m_variant(model.state_dict(), use_cache=True, **lora_kw)
    cached_plain = opt125m_variant(model.state_dict(), use_cache=True)
    P = LORA_PREFILL
    (pl, pst), counts_p = counted(lambda: cached.prefill_parallel(ids[:, :P], P))
    require_launches("lora", counts_p, K1=n_layers)
    bl, bst = cached_plain.prefill_parallel(ids[:, :P], P)
    same = torch.equal(pl, bl) and all(torch.equal(x, y) for a, b in zip(pst, bst)
                                       for x, y in zip(a, b))
    log(f"[lora] prefill 1x{P}: logits and decode states equal to the LoRA-free model's "
        f"bit for bit: {same}")
    require(same, "the LoRA model's prefill differs from the LoRA-free one's")
    launches = {"K1": counts["K1"] + counts_p["K1"]}
    del cached, cached_plain, plain, pst, bst
    torch.cuda.empty_cache()

    # two task-only steps through the differentiable kernels
    train = opt125m_variant(model.state_dict(), use_fused_train=True, **lora_kw)
    del model
    losses, _, train_counts, peak = run_train(train, ids, 2, f"lora 1x{T}")
    require(all(np.isfinite(losses)), f"LoRA train losses {losses}")
    captured = capture_layer0(train, ids)
    errs = check_layer0(f"lora layer-0 1x{T}", *captured)
    del train, captured
    torch.cuda.empty_cache()
    launches.update({kid: train_counts[kid] for kid in TRAIN_KERNELS})
    log(f"[lora] 2 fused train steps 1x{T}: losses {[f'{x:.6f}' for x in losses]}, "
        f"peak {peak:.2f} GiB")

    # BERT-base with both flags on the GLUE batch: K5
    bcfg = dataclasses.replace(bert_base("perlin"), sea=sea_variant(bert_base().sea, **lora_kw))
    bert = seed_lora_(BertForSequenceClassification(bcfg, device=dev, seed=0), 33)
    n, Tb, lo, hi = BERT_REQUESTS[0]
    inputs = bert_batch(n, Tb, lo, hi, seed=34, vocab=bcfg.vocab_size, device=dev)
    k5, k5_err = student_k5("lora", bert, inputs)
    del bert
    torch.cuda.empty_cache()
    launches["K5"] = k5
    return dict(launches=launches, err={"K1": err, **errs, "K5": k5_err})


def capture_csr(run):
    """`run()` with the uniform-CSR functions wrapped to keep layer 0's
    operands (the first call of each): the compressed mask and its CSR, the
    scores' q and k, the row scaler, v and the context."""
    names = ("resize_from_m_to_t_csr", "flat_csr_masked_bmm", "flat_csr_elmul",
             "flat_csr_sdbmm")
    real = {n: getattr(flat_csr, n) for n in names}
    seen = {}

    def wrap(name):
        def call(*args, **kw):
            out = real[name](*args, **kw)
            seen.setdefault(name, (args, out))
            return out
        return call

    for n in names:
        setattr(flat_csr, n, wrap(n))
    try:
        run()
    finally:
        for n in names:
            setattr(flat_csr, n, real[n])
    (mask_m, *_), csr = seen["resize_from_m_to_t_csr"]
    (q, k, _), _ = seen["flat_csr_masked_bmm"]
    (_, scaler), _ = seen["flat_csr_elmul"]
    (_, v), ctx = seen["flat_csr_sdbmm"]
    return mask_m, csr, q, k, scaler, v, ctx


def phase_csr():
    dev = "cuda"
    T = CSR_T
    model = opt125m_variant(use_pallas=False)
    fused = opt125m_variant(model.state_dict())
    cfg = model.cfg
    ids = torch.randint(4, cfg.vocab_size, (1, T),
                        generator=torch.Generator().manual_seed(35)).to(dev)
    am = torch.ones_like(ids)
    Z = cfg.sea.max_nnz_for(T)
    log(f"[csr] OPT-125m use_pallas=False, 1x{T}: Z = {Z} slots a row; a gathered K or V "
        f"{T * Z * cfg.sea.head_dim * 4 / 1e9:.3f} GB a layer (float32)")

    # the main path: no kernel may launch
    torch.cuda.reset_peak_memory_stats()
    logits, counts = counted(lambda: infer(model, ids, am))
    csr_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require_launches("csr", counts)
    require(bool(torch.isfinite(logits).all()), "CSR logits not finite")
    torch.cuda.reset_peak_memory_stats()
    k1_logits = infer(fused, ids, am)
    k1_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[csr] no kernel launched; logits finite; max|logits - K1 path's| "
        f"{max_err(logits, k1_logits):.3g} (round-half-away expansion against the kernels' "
        f"floor, PARITY.md §2.1); peak {csr_peak:.2f} GiB against the K1 path's "
        f"{k1_peak:.2f}")

    # layer 0: the context against a dense masked softmax of the same CSR
    mask_m, csr, q, k, scaler, v, ctx = capture_csr(lambda: infer(model, ids, am))
    cpu = flat_csr.resize_from_m_to_t_csr(mask_m.cpu(), cfg.sea.effective_k, T,
                                          is_causal=True, max_nnz=Z)
    same_cols = torch.equal(cpu.cols, csr.cols.cpu())
    log(f"[csr] layer-0 cols (1, {T}, {Z}) on the card equal to the CPU's on the same "
        f"mask bit for bit: {same_cols}; {int(csr.nnz_per_row.sum())} slots alive")
    require(same_cols, "CSR cols differ between the card and the CPU")
    alive = flat_csr.flat_csr_to_dense(csr) > 0
    scores = torch.einsum("nhtd,nhsd->nhts", q.float(), k.float()).masked_fill(~alive, -math.inf)
    probs = torch.nan_to_num(torch.softmax(scores, -1)) * scaler.float()[..., None]
    want = probs @ v.float()
    err = max_err(ctx, want)
    log(f"[csr] layer-0 context against the dense masked softmax of the same CSR: "
        f"max|err| {err:.3g}")
    require(err <= F32_TOL, f"CSR context vs its dense rebuild: {err}")
    del scores, probs, want, alive
    csr_ms, _ = forward_ms(model, ids, am, iters=3)
    k1_ms, _ = forward_ms(fused, ids, am, iters=3)
    log(f"[csr] forward 1x{T}: CSR {csr_ms:.2f} ms, peak {csr_peak:.2f} GiB; K1 path "
        f"{k1_ms:.2f} ms, peak {k1_peak:.2f} GiB (the same weights)")
    del model, fused
    torch.cuda.empty_cache()

    # BERT-base oversampled: JAX's use_fused predicate routes it to the CSR
    bcfg = dataclasses.replace(bert_base("perlin"),
                               sea=sea_variant(bert_base().sea, k_oversample=2.0))
    bert = BertForSequenceClassification(bcfg, device=dev, seed=0).eval()
    n, Tb, lo, hi = BERT_REQUESTS[1]
    inputs = bert_batch(n, Tb, lo, hi, seed=36, vocab=bcfg.vocab_size, device=dev)
    torch.cuda.reset_peak_memory_stats()
    blogits, bcounts = counted(lambda: infer(bert, *inputs))
    bpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    require_launches("csr", bcounts)
    require(bool(torch.isfinite(blogits).all()), "oversampled BERT logits not finite")
    bms = host_ms(lambda: infer(bert, *inputs), iters=2)
    log(f"[csr] BERT-base k_oversample=2.0 {n}x{Tb}: no kernel, finite logits, "
        f"{bms:.2f} ms a forward, peak {bpeak:.2f} GiB (Z = {bcfg.sea.max_nnz_for(Tb)})")
    del bert
    torch.cuda.empty_cache()
    return dict(err=err, csr_ms=csr_ms, k1_ms=k1_ms, csr_peak=csr_peak, k1_peak=k1_peak)


def phase_variants():
    dev = "cuda"
    T = VARIANT_T
    ids = torch.randint(4, opt_125m().vocab_size, (1, T),
                        generator=torch.Generator().manual_seed(37)).to(dev)
    am = torch.ones_like(ids)
    launches, errs = 0, []
    for label, kw in (("comp", dict(predictor_method="comp")),
                      ("enc_per_layer", dict(enc_per_layer=True))):
        model = opt125m_variant(**kw)
        logits, counts = counted(lambda: infer(model, ids, am))
        require_launches("variants", counts, K1=model.cfg.num_layers)
        require(bool(torch.isfinite(logits).all()), f"{label} logits not finite")
        *_, err = layer0_k1(f"variants {label}", lambda: infer(model, ids, am))
        get_bench().reset()
        ms, _ = forward_ms(model, ids, am, iters=3)
        log(f"[variants] OPT-125m {label} 1x{T}: launches {counts}, finite logits, layer-0 "
            f"K1 max|err| {err:.3g}, {ms:.2f} ms a forward")
        launches += counts["K1"]
        errs.append(err)
        del model
        torch.cuda.empty_cache()
    return dict(launches=launches, err=max(errs))


def phase_long_context():
    dev = "cuda"
    contexts = EXT_CONTEXTS
    n_windows = EXT_WINDOWS
    _, s_cfg = model_configs(TrainerConfig(model="opt-125m"))
    recs, counts = counted(lambda: exp_long_context.sweep(
        model="opt-125m", contexts=contexts, dynamic_ks=EXT_DYNAMIC_KS,
        query_skips=EXT_QUERY_SKIPS, n_eval_batches=n_windows, device=dev))
    forwards = len(recs) * n_windows
    require(len(recs) == len(contexts) * len(EXT_DYNAMIC_KS) * len(EXT_QUERY_SKIPS),
            "a record per combination")
    require_launches("long-context", counts, K1=s_cfg.num_layers * forwards)
    require(all(np.isfinite(r["ppl"]) for r in recs), f"non-finite PPL: {recs}")
    for r in recs:
        log(f"[long-context] {json.dumps(r)}")
    # layer 0's K1 at the longest context against its plain version, once
    base = build_model(s_cfg, 0, dev)
    T = contexts[-1]
    ext = extend_opt_model(base, T).eval()
    del base
    ids = torch.randint(4, s_cfg.vocab_size, (1, T),
                        generator=torch.Generator().manual_seed(38)).to(dev)
    *_, err = layer0_k1(f"long-context 1x{T}", lambda: infer(ext, ids, torch.ones_like(ids)))
    get_bench().reset()
    del ext
    torch.cuda.empty_cache()
    ms = {c: [r["ms_per_window"] for r in recs if r["context"] == c] for c in contexts}
    log("[long-context] ms per window: " + "; ".join(
        f"{c}: {min(v):.2f}-{max(v):.2f}" for c, v in ms.items()))
    return dict(launches=counts["K1"], err=err, recs=recs)


def phase_cli():
    dev = "cuda"
    with tempfile.TemporaryDirectory() as root:
        argv = ["--dataset", "wikitext2", "--model", "opt-125m", "--enable-lora",
                "--checkpoint-rotation", "2", "--num-steps", str(CLI_STEPS),
                "--max-seq-len", str(CLI_T), "--gradient-accumulation-steps", "1",
                "--eval-steps", "1", "--log-steps", "1", "--device", dev, "--save-root", root]
        t0 = time.perf_counter()
        tr, counts = counted(lambda: cli.main(argv))
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        require_launches("cli", counts)
        save_dir = tr.cfg.save_dir
        tags = resilience._step_tags(save_dir)
        latest = resilience.resolve_latest(save_dir)
        age = resilience.heartbeat_age_s(save_dir)
        log(f"[cli] cli.main({' '.join(argv[:-1])} DIR): {CLI_STEPS} updates in {took:.1f} s, "
            f"checkpoints {tags}, LATEST {latest}, heartbeat {age:.2f} s old, LoRA on the "
            f"student: {tr.s_cfg.sea.lora_enabled}")
        require(tr.s_cfg.sea.lora_enabled, "--enable-lora did not reach the student")
        require(tags == [f"ckpt_{s:08d}" for s in (CLI_STEPS - 1, CLI_STEPS)],
                f"rotating checkpoints {tags}")
        require(latest == tags[-1], f"LATEST names {latest}, not {tags[-1]}")
        require(age is not None and age < 120, f"heartbeat {age} s old")
        # a second trainer resumed from the newest checkpoint; then the
        # uninterrupted run's next update against the resumed one's, each
        # under deterministic algorithms (the estimator's gathers back-
        # propagate through CUDA's atomic scatter-add otherwise)
        args = cli.build_parser().parse_args(argv)
        args.num_steps = CLI_STEPS + 1
        resumed, _ = cli.build_trainer(args)
        step = resilience.resume_latest(resumed)
        require(step == CLI_STEPS, f"resumed at step {step}, not {CLI_STEPS}")
        tr.cfg.num_steps = CLI_STEPS + 1
        for trainer in (tr, resumed):
            with deterministic():
                trainer.train()
        a, b = tr.student.state_dict(), resumed.student.state_dict()
        differ = [n for n in a if not torch.equal(a[n], b[n])]
        log(f"[cli] resumed at step {step}; its next update against the uninterrupted run's: "
            f"{len(a) - len(differ)} of {len(a)} tensors equal bit for bit")
        require(not differ, f"the resumed update differs: {differ[:4]}")
        del tr, resumed
    torch.cuda.empty_cache()
    return dict(seconds=took)


# ---------------------------------------------------------------------------
# Head width 32: K1 and K5, the scaling sweep, LRA image, data parallelism
# ---------------------------------------------------------------------------


def image_mask(lengths, T, seed, device):
    """(N, 1, T, 128) compressed mask of right-padded one-head examples,
    each token row keeping each pixel with the probability of the non-causal
    budget round(k·T_M/len) / T_M (k = 64); padded rows keep nothing."""
    g = torch.Generator().manual_seed(seed)
    lt = torch.tensor(lengths, dtype=torch.float32)
    density = (torch.round(IMAGE_K * IMAGE_T_M / lt.clamp(min=1)).clamp(1, IMAGE_T_M)
               / IMAGE_T_M)
    m = (torch.rand((len(lengths), 1, T, IMAGE_T_M), generator=g)
         < density[:, None, None, None]).float()
    m *= (torch.arange(T)[None, None, :, None] < lt[:, None, None, None]).float()
    return m.to(device)


def phase_width32_kernels():
    """K1 at the scaling sweep's 1 x 4 x 1024 x 32 and K5 at LRA image's 256
    x 1 x 1024 x 32, in float32 and bf16, under the width-64 gates: the
    element mask bit for bit, each kernel within `tolerance` of its plain
    version, K1's 128 x 256 lists equal to its 64 x 64 ones bit for bit,
    rows with nothing alive zero; each timed beside its plain version, SDPA
    at the same shape and its bound. Returns {(kernel, dtype): max|err|}."""
    dev = "cuda"
    errs = {}
    sweep = dict(heads=SWEEP_H, width=SWEEP_D)
    mask = budget_mask(1, SWEEP_T, seed=32, device=dev, heads=SWEEP_H, t_m=SWEEP_T_M,
                       k=SWEEP_K)
    bad = int((bs.alive_mask(mask, SWEEP_T) != bs.element_mask_int8(mask, SWEEP_T, True)).sum())
    require(bad == 0, "alive_mask != element_mask_int8 on the width-32 causal mask")
    empty = mask.clone()
    empty[:, :, 300:400] = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, sc = qkv(1, SWEEP_T, dtype, seed=32, device=dev, **sweep)
        got = bs.sea_block_sparse_attention(q, k, v, mask, sc)
        want = bs.dense_reference(q.float(), k.float(), v.float(), mask, sc.to(dtype).float())
        diff = (got.float() - want).abs()
        over = float((diff - tolerance(want, dtype)).max())
        other = bs.sea_block_sparse_attention(q, k, v, mask, sc, block_q=128, block_k=256)
        hole = bs.sea_block_sparse_attention(q, k, v, empty, sc)
        hole_want = bs.dense_reference(q.float(), k.float(), v.float(), empty,
                                       sc.to(dtype).float())
        hole_ok = bool(((hole.float() - hole_want).abs() <= tolerance(hole_want, dtype)).all())
        zero = float(hole[:, :, 300:400].abs().max())
        m = measure(q, k, v, mask, sc)
        log(f"[width32-kernels] K1 1x{SWEEP_H}x{SWEEP_T}x{SWEEP_D} {str(dtype)[6:]}: max|err|="
            f"{float(diff.max()):.3g} (margin to tol {-over:.3g}); element mask {bad} "
            f"mismatches; blocks 128 x 256 equal to 64 x 64: {torch.equal(got, other)}; rows "
            f"300-399 empty: within tolerance {hole_ok}, |out| there {zero}; kernel "
            f"{m['ms']:.4f} ms (with prep {m['wrapper_ms']:.4f}), plain {m['plain_ms']:.3f} ms, "
            f"sdpa {m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms by {m['bound_by']} "
            f"({m['flops'] / 1e9:.4f} GFLOP, {m['bytes'] / 1e6:.2f} MB)")
        require(over <= 0 and got.dtype == dtype, f"width-32 K1 vs plain {dtype}")
        require(torch.equal(got, other), f"width-32 K1 depends on the block sizes {dtype}")
        require(hole_ok and zero == 0.0, f"width-32 K1 empty rows {dtype}")
        errs["K1", dtype] = max(float(diff.max()), max_err(hole, hole_want))

    rng = np.random.default_rng(32)
    lengths = [IMAGE_T] * (IMAGE_N // 2) + [int(x) for x in
                                            rng.integers(1, IMAGE_T + 1, IMAGE_N // 2)]
    lengths[-1] = 0
    lt = torch.tensor(lengths, dtype=torch.int32, device=dev)
    mask = image_mask(lengths, IMAGE_T, seed=33, device=dev)
    bad = int((bs.alive_mask(mask, IMAGE_T, is_causal=False, lengths=lt)
               != bs.element_mask_int8(mask, IMAGE_T, False, lengths=lt)).sum())
    log(f"[width32-kernels] K5 {IMAGE_N}x1x{IMAGE_T}x{SWEEP_D}: element mask {bad} mismatches "
        f"(lengths 0-{IMAGE_T}, half of them {IMAGE_T})")
    require(bad == 0, "K5's predicate != the oracle on the width-32 mask")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, sc = qkv(IMAGE_N, IMAGE_T, dtype, seed=33, device=dev, heads=1, width=SWEEP_D)
        err, got = check_bidir(f"width 32, {IMAGE_N}x1x{IMAGE_T}x{SWEEP_D} {str(dtype)[6:]}",
                               bs._div(q, math.sqrt(SWEEP_D)), k, v, mask, sc, lt, timed=True)
        zero = max(float(got[-1].abs().max()),
                   max(float(got[n, :, length:].abs().max()) if length < IMAGE_T else 0.0
                       for n, length in enumerate(lengths)))
        require(zero == 0.0 and bool(torch.isfinite(got).all()),
                f"width-32 K5 padded rows {dtype}: |out| {zero}")
        errs["K5", dtype] = err
    return errs


def phase_scaling():
    """`scaling_sweep` at 1, 2 and 4 positions of one card: K1 at width 32
    launched once a shard a forward and no other kernel, finite records;
    then layer 0 of the sweep's forward held to the plain version (the
    card's top-k to the CPU's), the 'seq' kind's context over 2 and 4
    positions within 2e-5 of the unsharded one (tests/test_torch_mesh.py's
    bound), and the same forward with bf16 parameters and input (K1's bf16
    instance). Returns the launches and the captured inputs of each type."""
    dev = "cuda"
    reset_launches()
    t0 = time.perf_counter()
    records = scaling_sweep(device=dev)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    counts = launch_counts()
    # the mask's forward, then one warm-up and five timed forwards a count
    n = 1 + 6 * sum(SCALING_COUNTS)
    for rec in records:
        log(f"[scaling] {json.dumps(rec)}")
    log(f"[scaling] scaling_sweep({list(SCALING_COUNTS)}) in {took:.1f} s; launches {counts}")
    require([r["devices"] for r in records] == list(SCALING_COUNTS)
            and all(math.isfinite(r["nnz_per_s"]) and r["nnz_per_s"] > 0 for r in records),
            f"scaling records {records}")
    require_launches("scaling", counts, K1=n)

    cfg, q, causal = scaling_inputs(dev)
    model = SeaAttention(cfg, device=dev, seed=0)
    cap = layer0_k1("scaling", lambda: scaling_forward(model, q, causal))
    ctx, _ = scaling_forward(model, q, causal)
    for size in SCALING_COUNTS[1:]:
        with sharded_attention_scope(make_mesh(dp=1, sp=size, devices=[dev] * size),
                                     axis="sp", kind="seq"):
            got, _ = scaling_forward(model, q, causal)
        err = max_err(got, ctx)
        log(f"[scaling] 'seq' over {size} positions vs unsharded: context max|err| {err:.3g}")
        require(err <= 2e-5, f"the sharded sweep forward over {size} positions: {err}")
    model.to(torch.bfloat16)
    qb = q.bfloat16()
    (ctx_bf, _), counts_bf = counted(lambda: scaling_forward(model, qb, causal))
    require_launches("scaling", counts_bf, K1=1, **{"K1 bf16": 1})
    require(ctx_bf.dtype == torch.bfloat16 and bool(torch.isfinite(ctx_bf).all()),
            "the sweep's bf16 forward")
    cap_bf = layer0_k1("scaling", lambda: scaling_forward(model, qb, causal))
    del model
    torch.cuda.empty_cache()
    return dict(launches=n, cap=cap, launches_bf16=counts_bf["K1 bf16"], cap_bf16=cap_bf,
                records=records)


def phase_lra_image():
    """`LraTrainer` on LRA's image task at its own geometry (1 layer, one
    head of 32, ffn 64, batch 256, T = 1024; the synthetic pixel stream): a
    'dense' step through `train()` (the teacher saved), a 'distill' step
    through `train()` from that teacher, one more KD step timed, the
    student's `evaluate` (the dense train path, as JAX's, no kernel), then
    the student's benchmarking forward through K5 at width 32 (one launch,
    layer 0 held to the plain version and reproducing the run's output bit
    for bit), again with the student in bf16. Returns the launches, errors
    and layer-0 inputs of each type."""
    dev = "cuda"
    with tempfile.TemporaryDirectory() as save_dir:
        def config(phase):
            return LraTrainerConfig(task="image", phase=phase, num_steps=1,
                                    n_train=IMAGE_N_TRAIN, log_every=1, save_dir=save_dir)

        t0 = time.perf_counter()
        dense = LraTrainer(config("dense"), device=dev)
        torch.cuda.synchronize()
        c = dense.t_cfg
        T = dense.train_ds.input_ids.shape[1]
        log(f"[lra-image] image teacher on {dev} in {time.perf_counter() - t0:.1f} s: "
            f"{c.num_layers} layer, width {c.hidden_size}, {c.num_heads} head of "
            f"{c.hidden_size // c.num_heads}, batch {dense.batch_size}, T = {T}")
        require((c.num_layers, c.num_heads, c.hidden_size, dense.batch_size, T)
                == (1, 1, SWEEP_D, IMAGE_N, IMAGE_T), "the image task's geometry")
        (dense_ms, _), counts = counted(lambda: timed_sync(lambda: dense.train(log=log)))
        no_kernel("lra-image", counts)
        batch = next(dense.train_ds.batches(dense.batch_size))
        loss = float(dense.dense_step([batch]))
        require(math.isfinite(loss), "the image teacher's loss")
        del dense
        torch.cuda.empty_cache()

        kd = LraTrainer(config("distill"), device=dev)
        torch.cuda.reset_peak_memory_stats()
        (kd_ms, _), counts = counted(lambda: timed_sync(lambda: kd.train(log=log)))
        no_kernel("lra-image", counts)
        require(kd.step == 1, f"the distill phase's step {kd.step}")
        step_ms, (kd_loss, terms) = timed_sync(lambda: kd.kd_step([batch]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        terms = {n: float(x) for n, x in terms.items()}
        require(math.isfinite(float(kd_loss)) and all(map(math.isfinite, terms.values())),
                f"an image KD term: {terms}")
        (acc, counts) = counted(lambda: kd.evaluate("student"))
        no_kernel("lra-image", counts)
        log(f"[lra-image] dense: a step through train() (with the save) in {dense_ms:.1f} ms, "
            f"one more loss {loss:.6f}; distill: a step through train() (with the bootstrap "
            f"probe and the save) in {kd_ms:.1f} ms, one more {step_ms:.2f} ms, peak "
            f"{peak:.2f} GiB, loss {float(kd_loss):.6f}, terms {terms}; evaluate('student') "
            f"{acc:.4f} (a random model's on the synthetic stream; the dense train path)")
        inputs = kd._tensors(*next(kd.eval_ds.batches(kd.batch_size)))[:3]
        out = {}
        for dtype in (torch.float32, torch.bfloat16):
            kd.student.to(dtype)
            launches, err = student_k5("lra-image", kd.student, inputs)
            cap = capture_bert_layer0(kd.student, inputs)
            require(cap[0].dtype == dtype and cap[0].shape == (IMAGE_N, 1, IMAGE_T, SWEEP_D),
                    f"the image student's layer-0 inputs {tuple(cap[0].shape)}")
            out[dtype] = dict(launches=launches, err=err, cap=cap[:6])
        del kd
    torch.cuda.empty_cache()
    return out


def phase_dp():
    """`cli.main` on wikitext2 at OPT-125m, 2 KD updates at 1 x 256, with and
    without `--data-parallel`, in one process (no torch.distributed world):
    the flag is taken, no kernel is launched, and both runs log the same
    losses and end with the same student, bit for bit (under deterministic
    algorithms)."""
    dev = "cuda"
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        for flag in (False, True):
            argv = ["--dataset", "wikitext2", "--model", "opt-125m", "--num-steps",
                    str(DP_STEPS), "--max-seq-len", str(DP_T), "--gradient-accumulation-steps",
                    "1", "--eval-steps", "1000", "--log-steps", "1", "--device", dev,
                    "--save-root", os.path.join(root, str(int(flag)))]
            if flag:
                argv.append("--data-parallel")
            with deterministic():
                tr, counts = counted(lambda: cli.main(argv))
            require_launches("dp", counts)
            with open(tr.metrics_path) as f:
                losses = [json.loads(line)["loss"] for line in f if '"loss"' in line]
            require(tr.cfg.data_parallel == flag and tr.dp is None and len(losses) == DP_STEPS,
                    f"--data-parallel {flag}: config {tr.cfg.data_parallel}, group {tr.dp}, "
                    f"losses {losses}")
            runs[flag] = (losses, tr.student.state_dict())
            del tr
    (a, sa_), (b, sb_) = runs[False], runs[True]
    same = all(torch.equal(sa_[n], sb_[n]) for n in sa_)
    log(f"[dp] cli.main wikitext2 OPT-125m, {DP_STEPS} updates at 1x{DP_T}, one process: losses "
        f"{a} without --data-parallel, {b} with it; students equal bit for bit: {same}")
    require(a == b and same, "--data-parallel in one process changed the run")
    torch.cuda.empty_cache()


@contextlib.contextmanager
def recorded_masks(replay=None):
    """Every SEA layer's compressed top-k mask in call order: recorded (the
    list yielded) or, with `replay`, those masks handed back in place of the
    layer's own picks (so two runs that would flip near-tied picks
    otherwise compare at one mask)."""
    import sea_tpu_torch.models.attention as attention

    own, masks = attention.topk_mask, []
    picks = iter(replay) if replay is not None else None

    def topk(*a, **k):
        if picks is not None:
            return next(picks).detach()
        out = own(*a, **k)
        masks.append(out.detach())
        return out

    attention.topk_mask = topk
    try:
        yield masks
    finally:
        attention.topk_mask = own


def flip_stats(masks, ref):
    """The top-k picks that differ from `ref`'s, layer by layer, and the
    first row (over every layer and head) holding one (T: none)."""
    flips, first = [], ref[0].shape[2]
    for a, b in zip(masks, ref):
        diff = a != b
        flips.append(int(diff.sum()))
        rows = diff.any(dim=3).any(dim=1).any(dim=0).nonzero()
        if len(rows):
            first = min(first, int(rows[0]))
    return flips, first


def attn_out_hook(model):
    """Layer 0's attention output (before the residual) on each call."""
    got = []
    handle = model.model.layers[0].self_attn.register_forward_hook(
        lambda mod, args, out: got.append(out[0].detach()))
    return got, handle


def kd_step_grads(teacher, student, ids, replay=None):
    """One dense-path KD micro-step (SeaOptKD, no remat), its masks
    recorded or replayed: (loss, the student's gradients by name, the
    masks); a tensor-parallel student's gradients come back joined
    (`gather_tp`)."""
    student.zero_grad()
    with recorded_masks(replay) as masks:
        loss, _ = SeaOptKD(teacher, student).kd_loss(ids, torch.ones_like(ids), ids,
                                                     use_remat=False)
        loss.backward()
    if getattr(student, "tp_group", None) is not None:
        grads = gather_tp(student, grads=True)
    else:
        grads = {n: p.grad for n, p in student.named_parameters()}
    return loss.detach(), {n: g for n, g in grads.items() if g is not None}, masks


def phase_tp():
    """OPT-125m (12 layers, 12 heads of 64, float32) tensor parallel over 2
    and 4 LocalGroup positions of one card (`parallel.tp.tensor_parallel`):
    the benchmark forward at 1 x TP_T launches K1 12·tp times (each
    position's heads) and no other kernel. Float reassociation (the row-
    parallel sums) flips near-tied top-k picks past layer 0; they are
    counted, and the unsharded forward is then run again on the TP run's
    own masks (`recorded_masks`): layer 0's attention output within
    1e-5·max|want| of it and the logits within 1e-4·max|logit|, every row.
    One dense-path KD micro-step at 1 x TP_KD_T likewise: its picks' flips
    counted, its gradients within 5e-4 of the unsharded step's on its masks
    (tests/test_tp.py:131-160's bound). ms a forward beside the unsharded
    forward's; the positions share one card, so these are the split's
    cost, not scaling. Returns the K1 launches."""
    dev = "cuda"
    model = OptForCausalLM(opt_125m("perlin"), device=dev, seed=0).eval()
    g = torch.Generator().manual_seed(41)
    ids = torch.randint(4, model.cfg.vocab_size, (1, TP_T), generator=g).to(dev)
    mask = torch.ones_like(ids)
    L = model.cfg.num_layers
    with recorded_masks() as ref_masks:
        infer(model, ids, mask)
    ms_ref, _ = forward_ms(model, ids, mask)
    log(f"[tp] unsharded OPT-125m benchmark forward 1x{TP_T}: {ms_ref:.2f} ms")
    teacher = OptForCausalLM(opt_125m("none"), device=dev, seed=1)
    kd_ids = ids[:, :TP_KD_T]
    _, _, kd_masks = kd_step_grads(teacher, model, kd_ids)
    launches = 0
    for size in TP_SIZES:
        tp_model = tensor_parallel(copy.deepcopy(model), LocalGroup(size, dev))
        got0, hook = attn_out_hook(tp_model)
        with recorded_masks() as masks:
            logits, counts = counted(lambda: infer(tp_model, ids, mask))
        hook.remove()
        require_launches("tp", counts, K1=L * size)
        launches += counts["K1"]
        flips, first = flip_stats(masks[:L], ref_masks[:L])
        want0, hook = attn_out_hook(model)
        with recorded_masks(replay=masks):
            want = infer(model, ids, mask)
        hook.remove()
        err0, scale0 = max_err(got0[0], want0[0]), float(want0[0].abs().max())
        err, scale = max_err(logits, want), float(want.abs().max())
        ms, _ = forward_ms(tp_model, ids, mask)
        log(f"[tp] tp={size}: K1 launches {counts['K1']}; top-k picks flipped by layer {flips} "
            f"(of {masks[0].numel()} a layer; the first at row {first}); on the TP run's masks "
            f"layer 0's attention output max|err| {err0:.3g} (max|want| {scale0:.3g}), the "
            f"logits {err:.3g} (max|logit| {scale:.3g}); {ms:.2f} ms a forward "
            f"({ms_ref:.2f} unsharded)")
        require(err0 <= 1e-5 * scale0, f"tp={size} layer 0 attention output: {err0}")
        require(err <= 1e-4 * scale, f"tp={size} logits: {err}")
        loss, grads, masks = kd_step_grads(teacher, tp_model, kd_ids)
        kd_flips, _ = flip_stats(masks, kd_masks)
        loss_ref, ref, _ = kd_step_grads(teacher, model, kd_ids, replay=masks)
        gerr = max(max_err(grads[n], ref[n]) for n in ref)
        log(f"[tp] tp={size}: KD micro-step 1x{TP_KD_T}: top-k picks flipped {sum(kd_flips)}; "
            f"on its masks loss {float(loss):.6f} ({float(loss_ref):.6f} unsharded), gradients "
            f"max|err| {gerr:.3g} over {len(ref)} parameters")
        require(set(ref) <= set(grads) and gerr <= 5e-4, f"tp={size} KD gradients: {gerr}")
        del tp_model
    del model, teacher
    torch.cuda.empty_cache()
    return launches


def phase_pp():
    """OPT-125m pipelined over PP_S LocalGroup stages of one card (3 layers
    a stage), PP_N x PP_T in PP_M microbatches: the benchmark forward
    launches K1 12·PP_M times (each layer once a microbatch) and no other
    kernel, its logits within 1e-4·max|logit| of the unsharded model's
    (microbatch by microbatch, the same shapes); GPipe's task-loss gradients
    against the unsharded model's (1e-5·max|g|); the interleaved pipeline
    (PP_IL_S stages x PP_IL_V chunks) likewise; then KD through GPipe (with
    and without remat) and through 1F1B, 1F1B's gradients within
    1e-4·max|g| of GPipe's, one AdamW update after it; peak GiB of each KD
    schedule (one card: the stages' sum). Returns the K1 launches."""
    dev = "cuda"
    model = OptForCausalLM(opt_125m("perlin"), device=dev, seed=0)
    L = model.cfg.num_layers
    g = torch.Generator().manual_seed(43)
    ids = torch.randint(4, model.cfg.vocab_size, (PP_N, PP_T), generator=g).to(dev)
    mask = torch.ones_like(ids)
    micro = list(zip(ids.chunk(PP_M), mask.chunk(PP_M)))
    with torch.inference_mode():
        want = torch.cat([model(i, m, benchmarking=True)["logits"] for i, m in micro])
        whole = model(ids, mask, benchmarking=True)["logits"]
    scale = float(want.abs().max())
    launches = 0
    for size, V in ((PP_S, 1), (PP_IL_S, PP_IL_V)):
        mesh = make_pp_mesh(dp=1, pp=size, devices=[dev] * size)

        def fwd():
            with torch.inference_mode():
                return pp_causal_lm_forward(model, ids, mask, mesh=mesh, num_microbatches=PP_M,
                                            benchmarking=True, interleave=V)[0]

        logits, counts = counted(fwd)
        require_launches("pp", counts, K1=L * PP_M)
        launches += counts["K1"]
        err = max_err(logits, want)
        ms = host_ms(fwd, 3)
        log(f"[pp] pp={size} V={V} benchmark forward {PP_N}x{PP_T}, M={PP_M}: K1 launches "
            f"{counts['K1']}; logits max|err| {err:.3g} (max|logit| {scale:.3g}; "
            f"{max_err(logits, whole):.3g} against the whole-batch forward); {ms:.2f} ms")
        require(err <= 1e-4 * scale, f"pp={size} V={V} logits: {err}")

        # the task loss's gradients through the schedule, against the
        # unsharded model's over the same microbatches
        model.zero_grad()
        for i, m in micro:
            (cross_entropy_shifted(model(i, m)["logits"], i) / PP_M).backward()
        ref = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
        model.zero_grad()
        out, _ = pp_causal_lm_forward(model, ids, mask, mesh=mesh, num_microbatches=PP_M,
                                      interleave=V)
        cross_entropy_shifted(out, ids).backward()
        got = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        gscale = max(float(x.abs().max()) for x in ref.values())
        gerr = max(max_err(got[n], ref[n]) for n in ref)
        log(f"[pp] pp={size} V={V} task-loss gradients max|err| {gerr:.3g} (max|g| "
            f"{gscale:.3g}) over {len(ref)} parameters")
        require(set(got) == set(ref) and gerr <= 1e-5 * gscale,
                f"pp={size} V={V} gradients: {gerr}")
        model.zero_grad()
    del model
    torch.cuda.empty_cache()

    teacher = OptForCausalLM(opt_125m("none"), device=dev, seed=1)
    student = OptForCausalLM(opt_125m("perlin"), device=dev, seed=2)
    mesh = make_pp_mesh(dp=1, pp=PP_S, devices=[dev] * PP_S)
    peaks, runs = {}, {}
    for name, remat in (("GPipe", False), ("GPipe+remat", True)):
        student.zero_grad()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, det = pp_kd_loss(teacher, student, ids, mask, ids, mesh=mesh,
                               num_microbatches=PP_M, use_remat=remat)
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[name] = (float(loss), {n: p.grad.clone() for n, p in student.named_parameters()
                                    if p.grad is not None}, ms)
    student.zero_grad()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, det, d_s = pp_kd_1f1b_value_and_grad(teacher, student, ids, mask, ids, mesh=mesh,
                                               num_microbatches=PP_M)
    torch.cuda.synchronize()
    ms_1f1b = (time.perf_counter() - t0) * 1e3
    peaks["1F1B"] = torch.cuda.max_memory_allocated() / 2 ** 30
    gpipe_loss, gpipe, gpipe_ms = runs["GPipe"]
    gscale = max(float(x.abs().max()) for x in gpipe.values())
    gerr = max(max_err(d_s[n], gpipe[n]) for n in gpipe)
    rerr = max(max_err(runs["GPipe+remat"][1][n], gpipe[n]) for n in gpipe)
    before = {n: p.detach().clone() for n, p in student.named_parameters()}
    for n, p in student.named_parameters():
        p.grad = d_s.get(n)
    GroupedAdamW(student, lr=1e-4).step()
    moved = max(max_err(p, before[n]) for n, p in student.named_parameters())
    log(f"[pp] KD {PP_N}x{PP_T}, M={PP_M}, pp={PP_S}: loss GPipe {gpipe_loss:.6f}, 1F1B "
        f"{float(loss):.6f}; 1F1B vs GPipe gradients max|err| {gerr:.3g} (max|g| {gscale:.3g}), "
        f"remat vs not {rerr:.3g}; an AdamW update moved the student by up to {moved:.3g}; "
        f"{gpipe_ms:.1f} ms GPipe, {runs['GPipe+remat'][2]:.1f} ms with remat, {ms_1f1b:.1f} ms "
        f"1F1B; peak {peaks['GPipe']:.2f} GiB GPipe, {peaks['GPipe+remat']:.2f} GiB GPipe+remat, "
        f"{peaks['1F1B']:.2f} GiB 1F1B (the stages' sum on one card)")
    require(all(math.isfinite(float(v)) for v in det.values()), f"1F1B KD details {det}")
    require(set(gpipe) <= set(d_s) and gerr <= 1e-4 * gscale, f"1F1B vs GPipe: {gerr}")
    require(abs(float(loss) - gpipe_loss) <= 1e-4 * abs(gpipe_loss), "1F1B vs GPipe loss")
    require(moved > 0 and math.isfinite(moved), "the update after 1F1B")
    del teacher, student
    torch.cuda.empty_cache()
    return launches


def phase_tp_serve(requests, runs):
    """[serve]'s cut model and requests through the head-sharded engine
    over TP_SERVE positions of one card (the pools and decode states split
    by head, `mesh=`): every request's tokens those of [serve]'s unsharded
    engine at the same chunk, no kernel launched."""
    model = tensor_parallel(decode_model(), LocalGroup(TP_SERVE, "cuda"))
    outs, wall, steps, pool_bytes = serve_run(model, requests, TP_SERVE_CHUNK,
                                              mesh=model.tp_group)
    same = sum(a == b for a, b in zip(outs, runs[TP_SERVE_CHUNK]))
    log(f"[tp-serve] tp={TP_SERVE}, chunk {TP_SERVE_CHUNK}: {len(requests)} requests in "
        f"{wall:.1f} ms over {steps} engine steps ({wall / steps:.2f} ms a step); pools "
        f"{pool_bytes / 2 ** 20:.1f} MiB over {TP_SERVE} positions; {same} of {len(requests)} "
        f"requests' tokens equal to the unsharded engine's")
    require(outs == runs[TP_SERVE_CHUNK], "the head-sharded engine's tokens differ")
    del model
    torch.cuda.empty_cache()


def phase_dryrun():
    """`dryrun_multichip(8)` on the card: every section of JAX's dry run
    over LocalGroup positions, each within JAX's bound (it raises
    otherwise), at heads of 64 (K1, K2-K4 and K6-K8 on the card)."""
    t0 = time.perf_counter()
    _, counts = counted(lambda: dryrun_multichip(8, device="cuda"))
    log(f"[dryrun] dryrun_multichip(8) on the card in {time.perf_counter() - t0:.1f} s; "
        f"launches {counts}")
    require(counts["K1"] > 0 and counts["K2"] > 0 and counts["K6"] > 0,
            f"the dry run's kernel paths: {counts}")
    torch.cuda.empty_cache()


def kernel_entry(name, source, replaces, launches, err, t) -> dict:
    """One kernel of the `kernels` line from its measurements `t`."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


def wide_train_entries(kernels, width, model, arms, bf16_errs, f32_errs):
    """The `kernels` line's K2-K4 entries at head width `width`, one per
    type, each at its train arm's layer-0 inputs (`arms`, a phase's return:
    launches, layer-0 errors and times per parameter type), its error the
    larger of the arm's and the kernel phases' (`bf16_errs`, `f32_errs`:
    {width: {kernel: max|err|}})."""
    for dtype, errs in (("bfloat16", bf16_errs), ("float32", f32_errs)):
        arm = arms[dtype]
        for kid, (_, name, source, replaces, _) in TRAIN_KERNELS.items():
            require(arm["launches"][kid] > 0, f"the {model} {dtype} arm never launched {kid}")
            kernels.append(kernel_entry(f"{name} ({dtype}, head width {width})", source,
                                        replaces, arm["launches"][kid],
                                        max(errs[width][kid], arm["errs"][kid]),
                                        arm["m"][kid]))
        log(f"[result] {model} train, {dtype} parameters, "
            f"{arm.get('layers', 'all')} layers, 1x{arm['tokens']}: {arm['ms']:.2f} ms per "
            f"step, peak {arm['peak']:.2f} GiB")


def time_phase(t0, name):
    log(f"[time] {name} done at {time.perf_counter() - t0:.1f} s")


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    phase_sort()
    phase_mask()
    kernel_wide_errs = phase_kernel()
    time_phase(t_start, "device, sort, mask, kernel")
    launches, checks = phase_slice()
    require(launches > 0, "the main path never launched the kernel")

    # the kernel's numbers at the main path's own inputs (the T=2048 request)
    q, k, v, mask, sc, _ = checks[-1]
    m = measure(q, k, v, mask, sc, k_cfg=float(K))
    err = max(c[-1] for c in checks)
    log(f"[result] main-path T=2048 layer 0: kernel {m['ms']:.4f} ms, plain "
        f"{m['plain_ms']:.3f} ms, sdpa {m['library_ms']:.4f} ms, bound "
        f"{m['bound_ms']:.4f} ms by {m['bound_by']}")
    # the same inputs rounded to bfloat16
    mb = measure(*(x.bfloat16() for x in (q, k, v)), mask, sc, k_cfg=float(K))
    log(f"[result] main-path T=2048 layer 0, bfloat16: K1 {mb['ms']:.4f} ms (with prep "
        f"{mb['wrapper_ms']:.4f}), sdpa {mb['library_ms']:.4f} ms, bound {mb['bound_ms']:.4f} "
        f"ms by {mb['bound_by']}")
    kernels = [{
        "name": "sea_causal_flat_forward",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": err,
        "ms": m["ms"],
        "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"],
        "library_ms": m["library_ms"],
    }]

    time_phase(t_start, "slice")
    train_wide_errs = phase_train_kernels()
    bf16_errs, bf16_wide_errs = phase_bf16_kernels()
    time_phase(t_start, "train-kernels, bf16-kernels")
    train_launches, train_errs, train_m = phase_train()
    time_phase(t_start, "train")
    long_launches, long_errs, long_ms, long_peak = phase_longctx_32k()
    time_phase(t_start, "longctx-32k")
    train_launches = {kid: train_launches[kid] + long_launches[kid] for kid in TRAIN_KERNELS}
    train_errs = {kid: max(train_errs[kid], long_errs[kid]) for kid in TRAIN_KERNELS}
    train_entries = {}
    for kid, (_, name, source, replaces, _) in TRAIN_KERNELS.items():
        t = train_m[kid]
        require(train_launches[kid] > 0, f"the training path never launched {kid}")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": train_launches[kid],
            "max_abs_err": train_errs[kid],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
        train_entries[kid] = kernels[-1]

    phase_bidir_mask()
    bidir_err = phase_bidir_kernel()
    bidir_launches, bert_err, captured = phase_bert()
    time_phase(t_start, "bidir-mask, bidir-kernel, bert")
    require(bidir_launches > 0, "the BERT path never launched K5")
    # K5's numbers at the main path's own inputs (layer 0 of the 32 x 256 request)
    m = measure_bidir(*captured)
    log(f"[result] BERT main path {tuple(captured[0].shape)} layer 0: K5 {m['ms']:.4f} ms, "
        f"plain {m['plain_ms']:.3f} ms, sdpa {m['library_ms']:.4f} ms, bound "
        f"{m['bound_ms']:.4f} ms by {m['bound_by']}; max|err| of the bidir-kernel phase "
        f"{bidir_err:.3g}")
    # the trained BERT students' forwards (glue-kd, lra) add their launches
    k5_entry = kernel_entry("sea_bidir_forward", KERNEL_SOURCE, BIDIR_REPLACES, bidir_launches,
                            bert_err, m)
    kernels.append(k5_entry)

    ring_errs, _, ring_bf16_errs = phase_ring_kernels()
    time_phase(t_start, "ring-kernels")
    serve_launches = phase_ring_serve()
    time_phase(t_start, "ring-serve")
    train_launches, train_errs, ring_m = phase_ring_train()
    time_phase(t_start, "ring-train")
    phase_seq_head()
    time_phase(t_start, "seq-head")
    # K6-K8 at the ring main path's own layer-0 inputs (the 1 x 16384 train
    # step), each number a launch's share of the 16 of a layer
    launches = {"K6": serve_launches + train_launches["K6"],
                "K7": train_launches["K7"], "K8": train_launches["K8"]}
    for kid, (_, name, source, replaces, _) in RING_KERNELS.items():
        t = ring_m[kid]
        require(launches[kid] > 0, f"the ring's main path never launched {kid}")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[kid],
            "max_abs_err": max(ring_errs[kid], train_errs[kid]),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })

    phase_impl_mask()
    impl_launches, impl_errs, impl_m = phase_impl_kernels()
    # K9a's main path is the sweep
    impl_launches["K9a"], sweep_err = phase_sweep()
    impl_errs["K9a"] = max(impl_errs["K9a"], sweep_err)
    time_phase(t_start, "impl-mask, impl-kernels, sweep")
    cos_err = phase_cosformer_slice()
    log(f"[result] cosformer slice layer-0 K1 max|err| {cos_err:.3g}")
    for dtype, m in impl_m.items():
        log(f"[result] bench.py 1x{H}x{BENCH_T} {str(dtype)[6:]}: " + "; ".join(
            f"{kid} {t['ms']:.4f} ms (with prep {t['wrapper_ms']:.4f}), sdpa "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']}"
            for kid, t in m.items()))
    # K9a-c at bench.py's canonical shapes, float32, each impl's default blocks
    for kid, (impl, replaces) in IMPL_VARIANTS.items():
        t = impl_m[torch.float32][kid]
        require(impl_launches[kid] > 0, f"the main path never launched {kid}")
        kernels.append({
            "name": bs.IMPL_KERNELS[impl].entry,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": replaces,
            "launches": impl_launches[kid],
            "max_abs_err": impl_errs[kid],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    time_phase(t_start, "cosformer-slice")
    dense_errs = phase_dense_vs_fused()
    log(f"[result] dense vs fused at 1x{DENSE_T}: K1 context {dense_errs['context']:.3g}, "
        f"K2-K4 loss rel {dense_errs['loss_rel']:.3g}, gradient {dense_errs['grad']:.3g}")
    kd = phase_kd()
    time_phase(t_start, "dense-vs-fused, kd")
    log(f"[result] KD at 1x512: {kd['micro_ms']:.2f} ms per micro-step, peak "
        f"{kd['peak']:.2f} GiB, PPL {kd['ppl']:.4f}; 1x{KD_LONG_T}: {kd['long_ms']:.2f} ms, "
        f"peak {kd['long_peak']:.2f} GiB")
    phase_baselines()
    time_phase(t_start, "baselines")
    glue = phase_glue_kd()
    time_phase(t_start, "glue-kd")
    lra = phase_lra()
    time_phase(t_start, "lra")
    k5_entry["launches"] += glue["launches"] + lra["launches"]
    k5_entry["max_abs_err"] = max(k5_entry["max_abs_err"], glue["err"], lra["err"])
    log(f"[result] GLUE KD (bert-base, 32x64): {glue['step_ms']:.2f} ms a step, peak "
        f"{glue['peak']:.2f} GiB; 32x{GLUE_LONG_T} micro-step {glue['long_ms']:.2f} ms, peak "
        f"{glue['long_peak']:.2f} GiB; LRA ListOps KD step (2 x 32x512, remat) "
        f"{lra['step_ms']:.2f} ms, peak {lra['peak']:.2f} GiB; text 16x{LRA_TEXT_T} "
        f"{lra['text_ms']:.2f} ms, peak {lra['text_peak']:.2f} GiB")

    # queue 1 item 4: LoRA, the uniform CSR, the predictor variants, the
    # long-context sweep and the trainer CLI; their launches join K1-K5's
    lora = phase_lora()
    time_phase(t_start, "lora")
    csr = phase_csr()
    time_phase(t_start, "csr")
    variants = phase_variants()
    time_phase(t_start, "variants")
    ext = phase_long_context()
    time_phase(t_start, "long-context")
    phase_cli()
    time_phase(t_start, "cli")

    # head width 32: K1 (the scaling sweep) and K5 (LRA image), and the
    # data-parallel CLI
    w32_errs = phase_width32_kernels()
    time_phase(t_start, "width32-kernels")
    scaling = phase_scaling()
    time_phase(t_start, "scaling")
    image = phase_lra_image()
    time_phase(t_start, "lra-image")
    phase_dp()
    time_phase(t_start, "dp")
    w32_entries = []
    for dtype, launches, cap in (("float32", scaling["launches"], scaling["cap"]),
                                 ("bfloat16", scaling["launches_bf16"], scaling["cap_bf16"])):
        m = measure(*cap[:5])
        log(f"[result] scaling sweep layer {tuple(cap[0].shape)} {dtype}: K1 {m['ms']:.4f} ms, "
            f"plain {m['plain_ms']:.3f} ms, sdpa {m['library_ms']:.4f} ms, bound "
            f"{m['bound_ms']:.4f} ms by {m['bound_by']}")
        w32_entries.append(kernel_entry(
            f"sea_causal_flat_forward ({dtype}, head width 32)", KERNEL_SOURCE, REPLACES,
            launches, max(w32_errs["K1", getattr(torch, dtype)], cap[5]), m))
    for dtype in (torch.float32, torch.bfloat16):
        run = image[dtype]
        m = measure_bidir(*run["cap"])
        log(f"[result] LRA image student layer 0 {tuple(run['cap'][0].shape)} "
            f"{str(dtype)[6:]}: K5 {m['ms']:.4f} ms, plain {m['plain_ms']:.3f} ms, sdpa "
            f"{m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms by {m['bound_by']}")
        w32_entries.append(kernel_entry(
            f"sea_bidir_forward ({str(dtype)[6:]}, head width 32)", KERNEL_SOURCE,
            BIDIR_REPLACES, run["launches"], max(w32_errs["K5", dtype], run["err"]), m))
    kernels[0]["launches"] += lora["launches"]["K1"] + variants["launches"] + ext["launches"]
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], lora["err"]["K1"],
                                    variants["err"], ext["err"])
    for kid, entry in train_entries.items():
        entry["launches"] += lora["launches"][kid]
        entry["max_abs_err"] = max(entry["max_abs_err"], lora["err"][kid])
    k5_entry["launches"] += lora["launches"]["K5"]
    k5_entry["max_abs_err"] = max(k5_entry["max_abs_err"], lora["err"]["K5"])
    log(f"[result] uniform CSR at OPT-125m 1x{CSR_T}: {csr['csr_ms']:.2f} ms a forward, peak "
        f"{csr['csr_peak']:.2f} GiB; the K1 path {csr['k1_ms']:.2f} ms, peak "
        f"{csr['k1_peak']:.2f} GiB; layer-0 context vs its dense rebuild {csr['err']:.3g}")

    dec = phase_decode()
    kernels[0]["launches"] += dec["launches"]
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], dec["err"])
    log(f"[result] decode: prefill 1x{DECODE_P} {dec['prefill_ms']:.2f} ms, "
        f"{dec['step_ms']:.3f} ms per step at N=1, {dec['step8_ms']:.3f} at "
        f"N={DECODE_BATCH}, peak {dec['peak']:.2f} GiB")
    serve_requests, serve_runs = phase_serve()
    time_phase(t_start, "decode, serve")

    # tensor and pipeline parallelism over LocalGroup positions of this card
    kernels[0]["launches"] += phase_tp()
    time_phase(t_start, "tp")
    kernels[0]["launches"] += phase_pp()
    time_phase(t_start, "pp")
    phase_tp_serve(serve_requests, serve_runs)
    time_phase(t_start, "tp-serve")
    phase_dryrun()
    time_phase(t_start, "dryrun")

    # OPT-1.3b in bfloat16: the random weights built once, cast to bf16
    t0 = time.perf_counter()
    weights = opt13b().state_dict()
    log(f"[opt13b] OPT-1.3b weights (seed 0 on the card, bf16) built in "
        f"{time.perf_counter() - t0:.1f} s")
    serve_launches, captured = phase_opt13b_serve(weights)
    k1_bf16 = measure(*captured[:5], k_cfg=float(K))
    log(f"[result] OPT-1.3b layer 0 {tuple(captured[0].shape)} bfloat16: K1 {k1_bf16['ms']:.4f} "
        f"ms, plain {k1_bf16['plain_ms']:.3f} ms, sdpa {k1_bf16['library_ms']:.4f} ms, bound "
        f"{k1_bf16['bound_ms']:.4f} ms by {k1_bf16['bound_by']}")
    kernels[0]["launches"] += serve_launches  # the promotion check's float32 forward
    train13_launches, train13_errs, train13_m, train13_peaks = phase_opt13b_train(weights)
    prefill_launches = phase_opt13b_decode(weights)
    del weights
    torch.cuda.empty_cache()
    kd13 = phase_opt13b_kd()
    log(f"[result] OPT-1.3b KD at 1x{OPT13B_KD_T} (scan_kd, logit_chunk {LOGIT_CHUNK}): "
        f"{kd13['micro_ms']:.2f} ms per micro-step, peak {kd13['peak']:.2f} GiB; train at "
        f"1x{OPT13B_T}: peak {train13_peaks['plain']:.2f} GiB plain, "
        f"{train13_peaks['remat']:.2f} GiB under remat; the 1x{LONGCTX_T} step "
        f"{long_ms:.2f} ms, peak {long_peak:.2f} GiB")
    time_phase(t_start, "opt13b")
    kernels.append({
        "name": "sea_causal_flat_forward (bfloat16)",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": serve_launches + prefill_launches,
        "max_abs_err": captured[5],
        "ms": k1_bf16["ms"],
        "plain_ms": k1_bf16["plain_ms"],
        "bound_ms": k1_bf16["bound_ms"],
        "bound_by": k1_bf16["bound_by"],
        "library_ms": k1_bf16["library_ms"],
    })
    for kid, (_, name, source, replaces, _) in TRAIN_KERNELS.items():
        t = train13_m[kid]
        require(train13_launches[kid] > 0, f"the OPT-1.3b train path never launched bf16 {kid}")
        kernels.append({
            "name": f"{name} (bfloat16)",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": train13_launches[kid],
            "max_abs_err": max(bf16_errs[kid], train13_errs[kid]),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })


    # OPT-2.7b in bfloat16 (head width 80): the random weights built once
    t0 = time.perf_counter()
    weights = opt27b().state_dict()
    log(f"[opt27b] OPT-2.7b weights (seed 0 on the card, bf16) built in "
        f"{time.perf_counter() - t0:.1f} s")
    k1_27, cap27, cap27_32 = phase_opt27b_serve(weights)
    prefill27 = phase_opt27b_decode(weights)
    train27 = phase_opt27b_train(weights)
    del weights
    torch.cuda.empty_cache()
    time_phase(t_start, "opt27b")
    ring_launches, ring_layer0_errs, ring_bf16_m = phase_ring_bf16()
    time_phase(t_start, "ring-bf16")

    # LLaMA-7b in bfloat16 (head width 128): the random weights built once
    t0 = time.perf_counter()
    weights = llama7b().state_dict()
    torch.cuda.synchronize()
    log(f"[llama7b] LLaMA-7b weights (seed 0 on the card, bf16; "
        f"{sum(w.numel() for w in weights.values()) / 1e9:.3f} G parameters) built in "
        f"{time.perf_counter() - t0:.1f} s")
    k1_llama, cap_llama, cap_llama32, llama_ms, llama_dense_ms = phase_llama7b_serve(weights)
    prefill_llama = phase_llama7b_decode(weights)
    mmlu_llama = phase_llama7b_mmlu(weights)
    del weights
    torch.cuda.empty_cache()
    time_phase(t_start, "llama7b")
    train_llama = phase_llama7b_train()
    time_phase(t_start, "llama7b-train")
    kd_llama = phase_llama7b_kd()
    time_phase(t_start, "llama7b-kd")

    # K1 at width 80, at the OPT-2.7b forward's own layer-0 inputs
    for dtype, cap, launches in (("bfloat16", cap27, k1_27["bfloat16"] + prefill27),
                                 ("float32", cap27_32, k1_27["float32"])):
        m = measure(*cap[:5], k_cfg=float(K))
        log(f"[result] OPT-2.7b layer 0 {tuple(cap[0].shape)} {dtype}: K1 {m['ms']:.4f} ms, "
            f"plain {m['plain_ms']:.3f} ms, sdpa {m['library_ms']:.4f} ms, bound "
            f"{m['bound_ms']:.4f} ms by {m['bound_by']}")
        kernels.append(kernel_entry(
            f"sea_causal_flat_forward ({dtype}, head width 80)", KERNEL_SOURCE, REPLACES,
            launches, max(kernel_wide_errs[WIDE_D, getattr(torch, dtype)], cap[5]), m))
    wide_train_entries(kernels, WIDE_D, "OPT-2.7b", train27, bf16_wide_errs, train_wide_errs)
    # K1 at width 128, at the LLaMA-7b forward's own layer-0 inputs
    for dtype, cap, launches in (
            ("bfloat16", cap_llama, k1_llama["bfloat16"] + prefill_llama + mmlu_llama),
            ("float32", cap_llama32, k1_llama["float32"])):
        m = measure(*cap[:5], k_cfg=float(K))
        log(f"[result] LLaMA-7b layer 0 {tuple(cap[0].shape)} {dtype}: K1 {m['ms']:.4f} ms, "
            f"plain {m['plain_ms']:.3f} ms, sdpa {m['library_ms']:.4f} ms, bound "
            f"{m['bound_ms']:.4f} ms by {m['bound_by']}")
        kernels.append(kernel_entry(
            f"sea_causal_flat_forward ({dtype}, head width 128)", KERNEL_SOURCE, REPLACES,
            launches, max(kernel_wide_errs[LLAMA_D, getattr(torch, dtype)], cap[5]), m))
    log(f"[result] LLaMA-7b forward 1x{LLAMA_T}: {llama_ms:.2f} ms, dense {llama_dense_ms:.2f} ms")
    wide_train_entries(kernels, LLAMA_D, "LLaMA-7b", train_llama, bf16_wide_errs,
                       train_wide_errs)
    dense = train_llama["bfloat16"]["dense"]
    log(f"[result] LLaMA-7b dense CE step 1x{LLAMA_TRAIN[0][0]}: {dense['ms']:.2f} ms, peak "
        f"{dense['peak']:.2f} GiB; KD at 1x{LLAMA_KD_T}: {kd_llama['micro_ms']:.2f} ms per "
        f"micro-step, peak {kd_llama['peak']:.2f} GiB, PPL {kd_llama['ppl']:.4f} (random model)")
    # K6-K8's bf16 instances, at the bf16 ring step's layer-0 inputs (a
    # launch's share of the 16 of a layer)
    for kid, (_, name, source, replaces, _) in RING_KERNELS.items():
        require(ring_launches[kid] > 0, f"the bf16 ring never launched {kid}")
        kernels.append(kernel_entry(f"{name} (bfloat16)", source, replaces, ring_launches[kid],
                                    max(ring_bf16_errs[kid], ring_layer0_errs[kid]),
                                    ring_bf16_m[kid]))

    kernels.extend(w32_entries)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
