#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

From the root of a checkout: puts ``src`` on ``sys.path`` and imports only
``repro_torch``.  In order, it

1. probes the toolchain (torch, CUDA, nvcc, triton, CUTLASS headers, the
   card's name and power limit);
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and prints the build seconds and ptxas's
   register and spill counts, by name for K1's fp32 kernel and K1-bwd's
   dK/dV and dQ kernels at every head dim and type (K3-bwd's in 3f);
3. holds each kernel against its plain PyTorch version on the card, over the
   shape grids of ``tests/test_kernels.py`` and at the llama3_8b shapes (K1,
   K2) or the mamba2_370m prefill shapes (K3) (tolerance 2e-4 in fp32, 5e-4
   at the SSD property points, 2e-2 in bf16), K2 at the edges of its
   partitions, and times kernel, plain version and, where PyTorch has one,
   a library call at those shapes, each as 20 calls back to back between
   CUDA events (``ms``, the method of every earlier run); the kernel and
   the library call also as 20 calls captured in a CUDA graph and replayed,
   with the host out of the way (``graph_ms``).  It also prints each
   kernel's host cost a call, the device time of each launch (K1's one, K2's
   and K3's two; torch.profiler), K1's plan and ptxas's registers and spills
   for the kernel it picks, and K3 at the ragged serving chunk (T=379), at
   T=2048 and 8192, at mamba2_370m's training shape (4 x 2048) and at a
   tensor-parallel rank's heads (2 rows of 1000 tokens, 32, 8 and 2 heads),
   each of K3's launches beside its own bounds, with ptxas's registers and
   spills of every K3 instantiation (none may spill).  K1's grid adds the bf16 kernel's GQA packing (G=8
   at D=128, G=6), windows with G > 1, T and S - T off the tile grids, D=32
   and 64, and B=2 views of a larger slot cache.  K2's grid adds its
   sliding window (windows of 1, page - 1, page, two partitions and one past
   every context), and K2 is timed again at mixtral_8x7b's decode shape
   with its 4096-key window (contexts 4000-8192), SDPA beside it with the
   window as a boolean mask.  At RecurrentGemma's and Whisper's shapes it
   holds K1 at D=256 with 10 query heads over one KV head (bf16
   and fp32, windows, ragged edges), K1 without the causal mask with S off
   the KV tile grid, and K2 at D=256 (G * D = 2560 and 4096, windows); and
   times K1 at recurrentgemma_2b's prefill (T=S=3072 and a 512-token chunk
   over 3072 keys, window 2048, bf16 and fp32) and whisper_base's
   non-causal shapes (T=S=1500 and T=64 over 1500 frames, 8 heads of 64),
   each with SDPA beside it and ptxas's registers and spills at D=256, and
   K2 at recurrentgemma_2b's decode (contexts 2049-3072, window 2048).
   It times K1 at qwen2_5_3b's training shape (B=4, T=S=512, 16 query and
   2 KV heads of 128, causal) in fp32 and bf16 against SDPA with
   ``is_causal``.  Every SDPA time comes with the names of the kernels SDPA
   launched (torch.profiler), and every fp32 time with two bounds, each
   labelled: the CUDA cores at 67 TFLOP/s and 3xTF32 on the tensor cores at
   495 / 3 TFLOP/s, the row's bound being the latter, the arithmetic K1's
   fp32 kernels use.
   For the deferred KV append it holds K1 with ``q_offset`` and
   ``return_lse`` and K2 with ``return_lse`` against their plain versions,
   output and log-sum-exp (-inf in the same rows): the cache segment
   (``q_offset = S``) with windows that empty rows or every row, cached
   lengths off the KV tile grid, the new chunk's segment, D = 256 with
   G = 10, fp32 and bf16; K2 with the window less one over contexts that
   include an empty one; and times K1's cache segment at llama3_8b's chunk
   (T = 512 over 1024 cached keys) and K2 at its decode shape, each with
   and without the lse, back to back and in a CUDA graph;
3e. holds K1's gradient kernel (``csrc/flash_attention_bwd.cu``, through
   ``ops.flash_attention``'s autograd) against autograd through the plain
   version on the same values in fp32, each gradient within 1e-3 (fp32) or
   2e-2 (bf16) of the largest reference entry: fp32 and bf16, D 32-256,
   causal, windowed and non-causal, T 1, 37, 512, 1500 with G 1, 8, 10, and
   whisper's cross-attention (448 queries over 1500 frames); and times it at
   qwen2_5_3b's training shape (B=4, T=S=512, 16 query and 2 KV heads of
   128) against its bounds, autograd's plain backward and SDPA's backward
   (and the names of SDPA's backward kernels), with the device time of each
   of its launches (delta, dK/dV, the sum of the partials, dQ);
3f. holds K3's gradient kernel (``csrc/ssd_scan_bwd.cu``, through
   ``ops.ssd_scan``'s autograd: K3 forward keeping its chunk states, K3-bwd
   backward) against the plain decomposition
   (``ref.ssd_scan_bwd_two_pass``) and against autograd through the plain
   scan on the same values in fp32, each gradient within 1e-4 (fp32) or
   1e-2 (bf16) of its largest entry: T 16, 100, 512, 2048 (ragged and whole
   chunks), N 16 and 128, P 16 and 64, with and without an initial state
   and a final-state gradient, chunks of 128, 64 and 16, bf16 inputs; then
   the edges of the 3xTF32 tiles: N 4, 8, 12 and 100 (padded to the mma's 8
   columns), P 16 and 48, chunks of 16, 32 and 48, T 1, Q + 1 and 2Q − 1,
   one head and heads that the head groups do not divide, bf16 at a ragged
   T; and times it at mamba2_370m's training shape (B=4, T=2048, 32 heads
   of 64, N=128) back to back and in a CUDA graph, with the device time of
   each of its launches and the scratch each reads and writes, beside the
   plain decomposition, autograd through the plain scan and K3's forward
   (with K3's own bounds), its two fp32 bounds (``ssd_bwd_flops``) and
   ptxas's registers and spills for every kernel of both types;
4. builds llama3_8b at full width and depth in bf16 from a seeded generator
   on the card and compares its prefill and decode logits with the kernels
   against the same calls with the plain attention;
4b. compares ``kv_append="defer"`` with the inline append on the same
   weights: the logits of two 512-token prefill chunks and of 4 decodes
   (relative 5e-2) and the caches after the write; K1 must run twice a
   layer on the second chunk and K2 once a layer a decode;
5. serves 8 requests (prompts of 128-1024 tokens, 32 new tokens each)
   through ``build_stack(mode="real")``, with every kernel launch count set
   to 0 just before and read just after, and checks that every request got
   its 32 tokens and that both kernels ran; it logs the (B, T, S) of every
   K1 launch and checks that K1 ran in every layer of every prefill chunk;
5b. serves the same requests with ``kv_append="defer"`` and, beside it, with
   the inline append (each stepped in this thread, the logits kept),
   checks that K1 and K2 ran on the defer path and that its tokens equal
   the inline run's, or where they part that step's logits lie within 5e-2,
   and prints both runs' wall and device times;
6. serves the same requests again under ``torch.profiler`` and prints the
   device time by kernel and the device's busy and idle shares;
6b. holds real execution of llama3_8b against time-warp emulation of the
   same engine (``repro_torch.launch.real_vs_emulated``): a calibration
   stream and a separate evaluation stream in real mode (32 synthesized
   requests each, Poisson arrivals at 2 per second, seeds 1 and 2), a
   ``LinearPredictor`` fitted on the calibration steps, and the evaluation
   stream emulated with it and with the analytical H100 model.  It checks
   that every request finished, that K1 and K2 ran in the real runs, and
   that the emulated runs launched no kernel, left the allocated device
   memory as it was and took less wall time than the real run; it prints
   the errors and the speed-up and asserts nothing about their size;
6c. serves 8 requests that share a 1024-token prefix (the first alone, the
   other 7 after it), with prefix caching on (the runner keeps the cached
   blocks' KV) and off, and checks that the cached run hit and that every
   request's tokens equal the uncached run's, or, at the first token where
   they part, that step's logits lie within the relative 5e-2 of the model
   checks;
6d. serves the smoke traffic in a block pool too small for its decodes,
   checks that the engine preempted, and holds the tokens against the same
   traffic in phase 5's pool as in 6c;
6e. runs the serve CLI in this process, in real mode at full size, as a
   user calls it (``repro_torch.launch.serve.main``, prefix caching on):
   qwen2_5_3b in bf16, 8 synthesized requests at 8 per second that share a
   512-token prefix; it checks that every request finished with its
   ``max_new_tokens`` tokens, that the engine's prefix cache hit, and that
   K1 and K2 ran while it served (counts set to 0 once the stack is built),
   and prints the hits, TTFT p50 and the phase's seconds;
6f. runs fig6's accuracy measurement on qwen2_5_3b at full width in bf16
   (``repro_torch.launch.fig6_accuracy.measure``: a calibration stream of
   15 requests in real mode, a ``LinearPredictor`` fitted on it, then an
   evaluation stream of 30 served twice in real mode and once emulated, on
   fig6's engine: 64-token steps, blocks of 4, prefix caching on); it
   fails where a request did not finish with its tokens, a real run
   launched no K1 or no K2, or the emulated run launched a kernel or
   changed the allocated device memory, and prints the row, its facts (the
   real-vs-real floor beside each error) and the phase's seconds;
7. builds mamba2_370m at full width and depth in bf16 from a seeded
   generator and compares its logits with K3 against the plain scan after a
   256-token prefill, a ragged 379-token chunk from the carried state, and a
   decode: in fp32 to 2e-3, and in bf16 by their distance from the fp32
   model's logits;
8. serves the same 8 requests through ``build_stack(mode="real")`` with
   mamba2_370m, counts set to 0 just before and read just after, and checks
   that every request got its 32 tokens and that K3 ran;
9. profiles that serving run as in 6;
9b. preemption with mamba2_370m, as in 6d, in fp32 (a resumed request's
   SSD state replayed through K3);
10. builds qwen3_30b_a3b at full width and depth in bf16 (30,532,110,336
   parameters, 48 MoE layers of 128 experts, top-8), compares its logits
   with K1 and K2 against the plain attention as in 4, and holds the MoE of
   layer 0 on a 512-token chunk with its grouped products
   (``torch._grouped_mm``) against the per-expert loop (2e-2), timing both;
11. serves the 8 requests of 5 with it, counts as in 5, and checks that K1
   ran in every layer of every chunk and that K2 ran;
12. profiles that run as in 6, with the MoE layers' device time (routing,
   dispatch, grouped products, combine) as a group of its own;
13. builds mixtral_8x7b at full width with 16 of its 32 layers
   (23,482,470,400 parameters) and compares the logits of a 6144-token
   prefill (three 2048-token chunks) and of a decode at position 6144, K1
   and K2 with the 4096-token window against the plain attention, beside
   the same weights without the window; the cache keeps the reference's
   ring of 4096 positions a layer, so the last chunk attends over the
   ring's earlier keys (K1 with ``q_offset``) and its own, merged;
14. serves one request of 6144 prompt tokens and 64 new ones in a slot of
   8192 positions (a ring of 4096) through ``build_stack(mode="real")``
   and checks that K1 ran the ring's earlier keys with ``q_offset`` and the
   window, and K2 every decode with the window over the ring's modular
   block tables, logging K1's (B, T, S, window, causal, q_offset), K2's
   windows and the slot's bytes (the ring's, and a linear row's);
15. builds recurrentgemma_2b at full size (2,894,435,840 parameters: 18
   RG-LRU and 8 local-attention layers, head_dim 256, 10 query heads over
   one KV head, window 2048) and compares the logits of a 3072-token
   prefill (three 1024-token chunks) and of a decode at position 3072 as
   in 13; times the RG-LRU recurrence at 512 and 2048 tokens and a decode;
15b. compares ``kv_append="defer"`` with the inline append on it as in 4b,
   over a 3072-token prefill in 1024-token chunks (past the window: K1's
   cache segment with ``q_offset`` and the window at D = 256) and a decode
   at 3072 (K2 with the window less one);
16. serves 4 requests of 3072 prompt tokens and 32 new ones (slots of
   4096, rings of 2048) and checks that K1 ran in every local-attention
   layer of every chunk and that K2 ran, and logs a slot's bytes;
17. profiles that run as in 6, with the RG-LRU recurrence as a range;
18. builds whisper_base at full size (87,405,056 parameters) and compares
   the logits of a prefill with 1500 random frame embeddings and 64 tokens
   (the encoder and the cross-attention through K1 without the causal
   mask) and of a decode (cross-attention through K2 over the padded
   cross cache) with the kernels and with the plain attention; times the
   encoder;
19. serves 8 text requests (prompts of 16-256 tokens, no frames, as the
   reference's runner) and checks that K1 ran with and without the causal
   mask and that K2 ran;
20. runs the distributed control plane on the host: ``repro_torch.scenario
   .compare`` of the ``distributed_parity`` preset on the thread, process
   (shared memory and TCP) and DES backends, which raises unless the
   reference's parity bar holds; it must launch no kernel and leave the
   allocated device memory as it was;
21. trains qwen2_5_3b at full size in fp32 (3,085,938,688 parameters)
   through the training CLI's code (``repro_torch.launch.train``), batch 8
   of 512 tokens in 2 microbatches, remat: step 1 through the kernels and
   through the plain attention on the same batch (loss 1e-4, gradient norm
   1e-2), then 8 steps (finite losses, parameters moved, K1 144 launches a
   step and K1-bwd 72), step ms, tokens/s, peak memory, and one more step
   under torch.profiler (device busy share, K1 and K1-bwd shares);
21b. restarts on the card: qwen2_5_3b at full width cut to 2 layers, 4
   steps straight against 2, a save, a restore into fresh tensors and 2
   more, bit for bit (the checkpoint in a temporary directory);
22. trains mamba2_370m at full size in fp32 (368,227,840 parameters) the
   same way, batch 8 of 2048 tokens in 2 microbatches with remat, through
   K3 and K3-bwd: step 1 against the plain scan (loss 1e-4, gradient norm
   1e-2, layer 0's ``w_in`` gradient 1e-3 of its largest entry), 8 steps
   (finite losses, parameters moved, K3 192 launches a step and K3-bwd 96,
   the plain run none), step ms, tokens/s, peak memory and a profiled step
   (K3 and K3-bwd shares);
23. expert parallelism on the one card (``repro_torch.launch.parallel``):
   qwen3_30b_a3b at full width (d_model 2048, 128 experts, top-8) cut to 8
   of its 48 layers, first as the one-process dropless model in this
   process, then as 2 rank processes in a gloo group (EP = 2, one data rank,
   64 experts each and, tensor-parallel, 16 of the 32 query heads over 2 of
   the 4 KV heads and half the vocabulary, all on this card, the exchanges
   through host memory), each prefilling the same 4 prompts of 512 tokens
   through ``model.prefill`` with ``moe_impl="a2a"`` (K1 in every layer) at
   capacity_factor 2, where a destination holds all of a rank's pairs and
   nothing drops, and at the config's 1.25, then one decode step (the
   dropless fallback, K2 in every layer).  The no-drop logits and the
   decode's must lie within the relative 5e-2 of the dropless model's, the
   two ranks' logits must agree, each rank's parameters and cache must be
   its placements' blocks (shapes, and allocated bytes up to the
   allocator's rounding), and a rank that fails fails the phase; it prints
   the pairs dropped at 1.25 and the MoE layers' ms (a2a on each rank
   against dropless), labelled as two ranks sharing one card;
24. the dry-run's per-device accounting (``repro_torch.launch.specs``,
   ``mesh.shard_bytes``) at a (1, 1) mesh against the card's allocation:
   qwen3_30b_a3b's bf16 parameters as phase 10 built them, and qwen2_5_3b's
   fp32 parameters and AdamW moments as phase 21 built them, each against
   ``torch.cuda.memory_allocated()`` measured right after it was built; the
   two agree to the byte but for the caching allocator's rounding: each
   tensor up to 512 bytes, and a tensor of over 1 MiB with up to 1 MiB of
   its block left unsplit (it prints the gap, and what fresh segments would
   give);
25. llama3_70b tensor-parallel (``repro_torch.launch.parallel``): at full
   width (d_model 8192, 64 query heads over 8 KV heads of 128, F 28672,
   vocabulary 128256, bf16) cut to 8 of its 80 layers, first as the
   one-process model in this process (17.9 GB of weights), freed, then as 4
   rank processes sharing this card through gloo (TP = 4: 16 query heads
   over 2 KV heads, F 7168 and 32064 rows of the vocabulary each, 4.5 GB a
   rank, each rank drawing its blocks leaf by leaf from the same seed), each
   prefilling 4 prompts of 256 tokens (numpy seed 0) and decoding 4 tokens
   through ``decode_slots``.  Every step's logits must lie within the
   relative 5e-2 of the one-process model's and be the same on every rank,
   K1 must launch once a layer on each rank's prefill and K2 once a layer a
   decode, and each rank's ``memory_allocated()`` grown by its build and by
   its cache must be ``mesh.shard_bytes`` of its placements at a (1, 4)
   mesh up to the allocator's rounding; it prints each rank's prefill and
   decode ms, labelled as ranks sharing one card through gloo;
26. qwen2_5_3b tensor-parallel as 25, at full width cut to 12 of its 36
   layers (bf16, 16 query heads over 2 KV heads of 128, QKV biases, tied embeddings) on 4
   ranks: each rank holds 4 query heads and a 32-wide block of head_dim of
   both KV heads (weights and cache), gathered to whole heads for RoPE, for
   K1 over each prefill's keys and for K2 over each decode's live rows; 4
   prompts of 512 (numpy seed 0), 4 decodes;
27. recurrentgemma_2b tensor-parallel as 25, at full size on 2 ranks: 5 of
   the 10 query heads over 128 of the KV head's 256 dimensions, the ring of
   2048 on those blocks, 1280 of the RG-LRU's 2560 channels (its conv'd
   input gathered once a layer); 2 prompts of 3072, past the window, 4
   decodes;
28. whisper_base tensor-parallel as 25, at full size on 2 ranks: the
   encoder, the decoder and the cross attention on 4 of 8 heads each, the
   cross cache on those heads; 4 rows of 1500 random frame embeddings
   (numpy seed 0) and 64-token prompts, 4 decodes (K1 in each encoder,
   decoder and cross layer of the prefill, K2 in each decoder and cross
   layer of a decode).  26-28 have 25's gates, and print the bytes each
   rank gathered over "model" in the prefill and in each decode;
29. mamba2_370m tensor-parallel as 25, at full width in fp32 cut to 12 of
   its 48 layers on 4 ranks:
   each rank holds 1096 of ``w_in``'s 4384 packed [z | x | B | C | dt]
   columns, 512 of ``w_out``'s 2048 rows, 8 of the state's 32 heads and
   576 of the conv state's 2304 channels, exchanges the columns its heads
   need (``layers._fetch_columns``) and runs K3 over its 8 heads; 2 prompts
   of 1000 tokens (a ragged last chunk), 4 decodes.  The logits are held at
   2e-3 (fp32; the comment in ``tensor_parallel`` says why not bf16), K3
   must launch once a layer on each rank's prefill;
30. mixtral_8x7b tensor-parallel as 25, at full width cut to 2 of its 32
   layers, on 16 ranks: 2 query heads over an 8-wide block of head_dim of
   the 8 KV heads, and the 8 experts, which do not divide 16, on their FFN
   width (1792 of ``w_in``'s 28672 [gate | up] columns, 896 of ``w_out``'s
   14336 rows; the gate and up columns of a rank's rows exchanged); 4
   prompts of 256, 4 decodes, the card's peak memory in use by every
   process logged.  29-30 print the bytes each rank exchanged;
31. training on a ("data", "model") mesh of (2, 2), the reference's
   ``train_4k`` program (``repro_torch.launch.train --mesh 2,2``): 4 rank
   processes sharing this card through gloo, qwen2_5_3b at full width cut
   to 2 of its 36 layers in fp32, batch 8 of 512 tokens in 2 microbatches
   with remat (phase 21's batch), 2 steps.  Each rank holds its blocks of
   the parameters and of both AdamW moments by the "train" rules (8 of the
   16 query heads over 1 of the 2 KV heads, half of F and of the
   vocabulary, and d cut again over "data"), gathers each leaf over "data"
   where a layer uses it and reduces its gradient back to its block (FSDP),
   and runs its block of each microbatch's rows through K1 and K1-bwd on
   its heads; then the one-process model takes the same steps on the same
   weights and batches.  Each step's loss must lie within 1e-4 and its
   grad_norm within 1e-3 of the one process's (relative), the same on
   every rank; step 1's gradient of every leaf, put together from the
   blocks, within 1e-3 of the leaf's largest entry; K1 8 and K1-bwd 4
   launches a step on every rank; each rank's allocated parameter and
   moment bytes ``mesh.shard_bytes`` of the train specs at (2, 2) up to the
   allocator's rounding.  It prints each step's ms by rank and the bytes a
   rank gathered and reduced over "data";
32. mamba2_370m the same way at full width cut to 24 of its 48 layers in
   fp32, batch 8 of 512 tokens (phase 22's batch at a
   quarter of its T): K3 and K3-bwd on each rank's 16 of the 32 heads, 96
   and 48 launches a step on every rank.  Then the one process's step 1 in
   float64 through the plain versions (``train.witness``): every leaf of
   the ranks' step-1 gradient must lie no farther from it than 1.5 times
   the one process's fp32 gradient, plus 1e-5 of its largest entry;
33. serving on a ("data", "model") mesh of (2, 2), as the reference's
   decode cells place it (``repro_torch.launch.parallel --mesh 2,2``; 4
   ranks sharing this card through gloo, then held against the one-process
   model as 25): mixtral_8x7b at full width cut to 4 of its 32 layers in
   bf16, ``long_500k``'s placement at batch 1: one 6144-token prompt past
   its 4096-slot ring, then 8 decodes.  Each "data" rank holds 2048 of the
   ring's slots; every rank prefills the whole prompt through K1 and keeps
   its block's slots; a decode writes the token on the rank whose block
   holds its slot, runs K2 on each run of its block the query sees (two
   where the ring wraps inside it) with their lse, and the ranks' attention
   is merged over "data" in fp32 (``layers.merge_blocks``).  A "model" rank
   holds 4 of the 8 experts, whose d is cut again over "data" and gathered
   where the MoE runs (``layers.gather_experts``);
34. qwen3_30b_a3b the same way at full width cut to 4 of its 48 layers,
   ``decode_32k``'s placement: 8 prompts of 512 tokens, 4 a "data" rank
   (K1 and K2 on its rows), 4 decodes; 64 of the 128 experts a "model"
   rank, their d over "data";
35. recurrentgemma_2b at full size, ``long_500k``'s placement: one
   3072-token prompt past its 2048-slot ring, 1024 slots a "data" rank, 4
   decodes; its one KV head on head_dim over "model" (each decode's rows of
   the rank's block gathered to whole heads, K2 at D=256), the RG-LRU on
   its width, its state whole over "data".  33-35 hold every rank's logits
   at every step within 5e-2 of the one-process model's rows, each rank's
   allocated parameter and cache bytes at ``mesh.shard_bytes`` of the serve
   specs at the mesh up to the allocator's rounding, and each rank's K1 and
   K2 launches at ``parallel.kernel_launches`` (K2 once a layer for each
   run of its block, by decode); they print the bytes and ms of each
   decode's experts' gather and merge and the card's peak in use;
36. qwen2_5_3b under the reference's ``kv_seq_shard`` (``launch.parallel
   --opt kv_seq_shard``) on a (1, 4) mesh, at phase 26's cut (12 of 36
   layers): 8 prompts of 512, 4 decodes; each rank holds 144 of the 576
   slots of both KV heads whole; a decode gathers the ranks' query heads
   to all 16 and the token's k, v to whole heads, runs K2 over its block
   for every query head and merges the (out, lse) over "model"; it prints
   the bytes a rank received a decode beside phase 26's head_dim gather,
   a row each;
37. context parallelism at batch 1: recurrentgemma_2b at full size under
   ``kv_defer_append`` on (2, 1) (one 3072-token prompt past its
   2048-slot ring, 1024 a rank: K2 over the runs of the rank's block of
   the cache before the token, the token's own key counted on the rank
   whose block holds its slot, which alone writes it after the layer), and
   whisper_base at full size with 1500 frames on (4, 1) (375 frames a
   rank, as the reference's rules cut them, stored in 384 slots, the pad
   after them; every rank encodes every frame and keeps its block; a
   decode's self and cross attention each K2 over the rank's block, the
   cross attention's over its 375 frames, merged over "data"; each rank's
   cache bytes are ``mesh.shard_bytes`` at 1500 frames plus the pad).
   36-37 have 33's gates.  In 31, 33 and 36 every collective each rank
   issued at each step (a training step; the prefill and each decode),
   its result bytes and ops by kind as ``layers.record_collective``
   counts them, must equal the census of the same rank's program on the
   meta device (``launch.rank_cost``, run here in a stand-in process group
   of the mesh's size; 33's gathers of the experts' d sized as the rank
   recorded them), exactly;
38. qwen2_5_3b trained as phase 31 on the ("pod", "data", "model") mesh
   of (2, 1, 2): FSDP over ("pod", "data") pod-major, the bytes a rank
   gathers and reduces those of phase 31's (2, 2);
39. whisper_base at full size trained on (2, 2) in fp32 with 1500 frames
   (``launch.train --frames``) and 448 tokens a row, batch 8 in 2
   microbatches: each rank 4 of 8 heads of every encoder, decoder and
   cross attention layer, the leaves cut again over "data", K1 60 and
   K1-bwd 36 launches a step on every rank.  38-39 have 31's gates.

Each model is freed before the next is built.  It prints one JSON
``census`` line (each rank of 31, 33 and 36: its coordinates, its steps,
the bytes and ops it issued by kind, summed over them), one JSON
``kernels`` line (K1, K1-bwd, K2, K3 and K3-bwd; launches summed over the
serving runs of 5, 5b, 6c, 6d, 6e, 8, 9b, 11, 14, 16 and 19, the 8 training
steps of phases 21 and 22, the ranks' prefills and decodes of phases 23,
25-30 and 33-37 and the ranks' training steps of phases 31-32 and 38-39),
the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  ``--kernels-only`` stops after
phase 3f and prints neither (a quick check of the kernels alone).  Any failure raises and the exit
code is not 0; without a CUDA device it exits 1 before doing anything.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import io
import itertools
import json
import math
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import torch
import torch.nn.functional as F

sys.dont_write_bytecode = True
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
PEAK_3XTF32_FLOPS = 495e12 / 3   # fp32 as 3xTF32: three TF32 tensor-core products
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
ALLOC_BLOCK = 512             # the CUDA caching allocator rounds each tensor up to this
ALLOC_UNSPLIT = 1 << 20       # and leaves up to this much of a larger block unsplit with it
# {tree: (torch.cuda.memory_allocated() grown by building it, its tensors' (shape,
# dtype))}: the trees phases 10 and 21 build, which phase 24 accounts for
BUILT_BYTES = {}
SERVING = dict(num=8, prompt_min=128, prompt_max=1024, new_tokens=32, seed=0)


_T0 = time.monotonic()


def log(msg: str) -> None:
    """Print ``msg``; a phase's header (``== ...``) gets the seconds since the
    script started."""
    if msg.startswith("== "):
        msg = f"{msg}  [{time.monotonic() - _T0:.1f} s]"
    print(msg, flush=True)


def sh(cmd) -> str:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (res.stdout + res.stderr).strip()


# -------------------------------------------------------------------------
# 1. probe
# -------------------------------------------------------------------------

def probe() -> str:
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    log("nvcc: " + sh([nvcc, "--version"]).splitlines()[-1])
    try:
        import triton
        log(f"triton {triton.__version__} imports")
    except ImportError as e:
        log(f"triton does not import ({e})")
    try:
        import msgpack
        log(f"msgpack {'.'.join(map(str, msgpack.version))} imports")
    except ImportError as e:
        log(f"msgpack does not import ({e})")
    cutlass = Path("/usr/local/cutlass/include/cutlass/cutlass.h")
    log(f"CUTLASS headers under /usr/local/cutlass/include: {cutlass.exists()}")
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    log(f"nvidia-smi: {smi}")
    log(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}")
    return smi


# -------------------------------------------------------------------------
# 3. kernels against their plain versions
# -------------------------------------------------------------------------

def assert_close(name, out, exp, dtype_name, tol=None):
    tol = tol or TOL[dtype_name]
    o, e = out.float(), exp.float()
    if not torch.isfinite(o).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = float((o - e).abs().max())
    bad = float(((o - e).abs() - (tol + tol * e.abs())).max())
    log(f"  {name:58s} max_abs_err {err:.3e}  {'ok' if bad <= 0 else 'FAIL'}")
    if bad > 0:
        raise AssertionError(f"{name}: outside rtol=atol={tol} (max abs err {err})")
    return err


def qkv(gen, B, T, S, Hq, Hkv, D, dtype):
    dev = "cuda"
    q = torch.randn((B, T, Hq, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    return q, k, v


def paged_inputs(gen, B, Hq, Hkv, D, page, pps, dtype, num_pages=None):
    dev = "cuda"
    num_pages = num_pages or (B * pps + 1)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn((num_pages, page, Hkv, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((num_pages, page, Hkv, D), generator=gen, device=dev).to(dtype)
    bt = torch.arange(B * pps, dtype=torch.int32, device=dev).view(B, pps)
    cl = torch.randint(1, page * pps + 1, (B,), generator=gen, device=dev,
                       dtype=torch.int32)
    return q, kp, vp, bt, cl


def check_flash_grid(ops):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for shape in [(1, 128, 128, 4, 4, 64), (2, 128, 256, 8, 2, 64), (1, 64, 64, 4, 1, 128),
                  (1, 100, 100, 2, 2, 64), (1, 32, 160, 4, 4, 32)]:
        for dt in ("float32", "bfloat16"):
            cases.append((shape, dt, {}))
    # window, non-causal and the property-sweep points in both types (fp32
    # and bf16 run different kernels).  The custom scale stays fp32, as in
    # tests/test_kernels.py: at scale 0.5 the bf16 plain version, which
    # rounds q.k to bf16 before scaling, is itself more than 2e-2 from exact.
    cases.append(((1, 64, 64, 2, 2, 64), "float32", {"softmax_scale": 0.5}))
    for dt in ("float32", "bfloat16"):
        for window in (16, 64, 4096):
            cases.append(((1, 128, 128, 4, 2, 64), dt, {"window": window}))
        cases.append(((2, 64, 64, 4, 4, 64), dt, {"causal": False}))
        for T, extra, Hkv, G, D in [(8, 0, 1, 1, 32), (33, 16, 2, 2, 64), (64, 93, 1, 4, 32),
                                    (127, 0, 2, 4, 64), (127, 93, 2, 1, 32),
                                    (33, 93, 1, 2, 128)]:
            cases.append(((1, T, T + extra, Hkv * G, Hkv, D), dt, {}))
    # the bf16 kernel's packing and tiles: G=8 at D=128 (qwen2_5_3b's widths,
    # Hq=16, Hkv=2), windows with G > 1, T off the query tile grid with S - T
    # off the KV tile grid, D=32 and 64, and a packing that does not fill G
    for shape, kw in [((1, 512, 1024, 16, 2, 128), {}), ((2, 77, 300, 16, 2, 128), {}),
                      ((1, 200, 260, 8, 2, 64), {"window": 48}),
                      ((1, 129, 400, 32, 8, 128), {"window": 100}),
                      ((1, 45, 173, 32, 8, 128), {}), ((1, 333, 1000, 4, 1, 32), {}),
                      ((2, 150, 301, 12, 4, 64), {}), ((1, 97, 97, 6, 1, 32), {}),
                      ((1, 70, 70, 16, 2, 128), {"causal": False})]:
        cases.append((shape, "bfloat16", kw))
    # head_dim 256 with 10 query heads over one KV head (recurrentgemma_2b:
    # packed by 2 into 5 groups), windows and ragged edges; non-causal with S
    # off the KV tile grid (whisper_base's encoder and cross-attention)
    for dt in ("float32", "bfloat16"):
        for shape, kw in [((1, 100, 300, 10, 1, 256), {}), ((2, 77, 77, 10, 1, 256), {}),
                          ((1, 130, 333, 10, 1, 256), {"window": 64}),
                          ((1, 33, 1500, 10, 1, 256), {"causal": False}),
                          ((1, 150, 150, 8, 8, 64), {"causal": False}),
                          ((2, 7, 150, 8, 8, 64), {"causal": False})]:
            cases.append((shape, dt, kw))
    for shape, dt, kw in cases:
        q, k, v = qkv(gen, *shape, getattr(torch, dt))
        out = ops.flash_attention(q, k, v, **kw)
        exp = ops.flash_attention(q, k, v, force="plain", **kw)
        torch.cuda.synchronize()
        assert_close(f"K1 {shape} {dt} {kw}", out, exp, dt)
    # B=2 views of a larger slot cache (batch stride 2048 positions), as the
    # model passes k_c[:, :s1]
    cache = torch.randn((2, 3, 2048, 8, 128), generator=gen, device="cuda").to(torch.bfloat16)
    for T, S in ((200, 456), (64, 64)):
        q = torch.randn((2, T, 32, 128), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = cache[0, 1:, :S], cache[1, 1:, :S]
        assert_close(f"K1 slot-cache views B=2 T={T} S={S} bfloat16", ops.flash_attention(q, k, v),
                     ops.flash_attention(q, k, v, force="plain"), "bfloat16")


def check_paged_grid(ops):
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for shape in [(2, 4, 4, 64, 16, 4), (3, 8, 2, 64, 16, 3), (1, 4, 1, 128, 32, 2),
                  (4, 2, 2, 32, 8, 5)]:
        for dt in ("float32", "bfloat16"):
            cases.append((shape, dt))
    for B, Hkv, G, page, pps in [(1, 1, 1, 8, 1), (4, 2, 4, 16, 5), (3, 1, 2, 8, 3),
                                 (2, 2, 2, 16, 2)]:
        cases.append(((B, Hkv * G, Hkv, 32, page, pps), "float32"))
    # head_dim 256, G = 10 (recurrentgemma_2b; G * D = 2560), and G * D = 4096
    for shape in [(3, 10, 1, 256, 16, 9), (2, 16, 1, 256, 8, 10), (2, 32, 1, 128, 16, 6)]:
        for dt in ("float32", "bfloat16"):
            cases.append((shape, dt))
    for shape, dt in cases:
        q, kp, vp, bt, cl = paged_inputs(gen, *shape, getattr(torch, dt))
        out = ops.paged_attention(q, kp, vp, bt, cl)
        exp = ops.paged_attention(q, kp, vp, bt, cl, force="plain")
        torch.cuda.synchronize()
        assert_close(f"K2 {shape} {dt}", out, exp, dt)
    # scattered tables and a one-token context
    q, kp, vp, _, _ = paged_inputs(gen, 2, 4, 2, 64, 16, 3, torch.float32, num_pages=32)
    bt = torch.tensor([[31, 2, 17], [9, 25, 0]], dtype=torch.int32, device="cuda")
    cl = torch.tensor([40, 33], dtype=torch.int32, device="cuda")
    assert_close("K2 scattered tables", ops.paged_attention(q, kp, vp, bt, cl),
                 ops.paged_attention(q, kp, vp, bt, cl, force="plain"), "float32")
    q, kp, vp, bt, _ = paged_inputs(gen, 1, 2, 2, 32, 8, 2, torch.float32)
    cl = torch.tensor([1], dtype=torch.int32, device="cuda")
    assert_close("K2 ctx=1", ops.paged_attention(q, kp, vp, bt, cl),
                 ops.paged_attention(q, kp, vp, bt, cl, force="plain"), "float32")
    check_paged_partitions(ops, gen)


def check_paged_partitions(ops, gen):
    """K2 at the edges of its partitions (``paged_attention.PARTITION`` keys):
    contexts of 1, one partition, one key past it and the full 2048 (32
    partitions) in one batch over scattered tables at the llama3_8b widths;
    against the plain version and against the plain split-and-merge, in
    both types.  An empty context gives 0, as in the Pallas kernel."""
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.kernels import ref
    part = paged_mod.PARTITION
    B, Hq, Hkv, D, page, pps = 5, 32, 8, 128, 16, 128
    lens = [1, part, part + 1, pps * page, 2 * part - 1]
    for dt in ("float32", "bfloat16"):
        q, kp, vp, _, _ = paged_inputs(gen, B, Hq, Hkv, D, page, pps, getattr(torch, dt))
        bt = torch.randperm(kp.shape[0], generator=gen, device="cuda")[:B * pps]
        bt = bt.to(torch.int32).view(B, pps).contiguous()
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out = ops.paged_attention(q, kp, vp, bt, cl)
        torch.cuda.synchronize()
        assert_close(f"K2 partition edges {lens} {dt}", out,
                     ops.paged_attention(q, kp, vp, bt, cl, force="plain"), dt)
        assert_close(f"K2 partition edges {lens} {dt} vs plain split", out,
                     ref.paged_attention_split(q, kp, vp, bt, cl), dt)
    cl = torch.tensor([0, 3], dtype=torch.int32, device="cuda")
    q, kp, vp, bt, _ = paged_inputs(gen, 2, 4, 2, 64, 16, 20, torch.float32)
    out = ops.paged_attention(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    if out[0].abs().max() != 0 or not torch.isfinite(out).all():
        raise AssertionError("K2: an empty context must give 0")
    assert_close("K2 ctx=3 beside an empty context", out[1:],
                 ops.paged_attention(q, kp, vp, bt, cl, force="plain")[1:], "float32")
    check_paged_windows(ops, gen)


def check_paged_windows(ops, gen):
    """K2's sliding window (the Pallas kernel has none): windows of 1, page
    − 1, page, two partitions and one longer than every context, over
    contexts on both sides of partition edges, against the plain version
    and the plain split-and-merge, in both types."""
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.kernels import ref
    part = paged_mod.PARTITION
    B, Hq, Hkv, D, page, pps = 6, 8, 2, 64, 16, 24
    lens = [1, part - 1, part, part + 1, 2 * part + 5, pps * page]
    for dt in ("float32", "bfloat16"):
        q, kp, vp, _, _ = paged_inputs(gen, B, Hq, Hkv, D, page, pps, getattr(torch, dt))
        bt = torch.randperm(kp.shape[0], generator=gen, device="cuda")[:B * pps]
        bt = bt.to(torch.int32).view(B, pps).contiguous()
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for window in (1, page - 1, page, 2 * part, pps * page + 7):
            out = ops.paged_attention(q, kp, vp, bt, cl, window=window)
            torch.cuda.synchronize()
            assert_close(f"K2 window {window} contexts {lens} {dt}", out,
                         ops.paged_attention(q, kp, vp, bt, cl, window=window, force="plain"), dt)
            assert_close(f"K2 window {window} {dt} vs plain split", out,
                         ref.paged_attention_split(q, kp, vp, bt, cl, window=window), dt)
    # the same windows at head_dim 256, G = 10
    B, Hq, Hkv, D = 6, 10, 1, 256
    for dt in ("float32", "bfloat16"):
        q, kp, vp, _, _ = paged_inputs(gen, B, Hq, Hkv, D, page, pps, getattr(torch, dt))
        bt = torch.randperm(kp.shape[0], generator=gen, device="cuda")[:B * pps]
        bt = bt.to(torch.int32).view(B, pps).contiguous()
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for window in (1, part + 3, pps * page + 7):
            out = ops.paged_attention(q, kp, vp, bt, cl, window=window)
            torch.cuda.synchronize()
            assert_close(f"K2 D=256 G=10 window {window} contexts {lens} {dt}", out,
                         ops.paged_attention(q, kp, vp, bt, cl, window=window, force="plain"), dt)


def assert_lse_close(name, lse, exp, dtype_name):
    """lse against the plain version's: -inf (a row that sees no key) in
    the same places, the rest within the output's tolerance."""
    empty = torch.isinf(exp)
    if not torch.equal(torch.isinf(lse), empty) or (lse[empty] > 0).any():
        raise AssertionError(f"{name}: the kernel's -inf rows differ from the plain version's")
    if not torch.isfinite(lse[~empty]).all():
        raise AssertionError(f"{name}: lse is not finite where a row sees a key")
    if empty.all():
        log(f"  {name:58s} every row sees no key: -inf in both  ok")
        return 0.0
    return assert_close(name, lse[~empty], exp[~empty], dtype_name)


def check_lse_grid(ops, gen):
    """K1 with ``q_offset`` and ``return_lse`` and K2 with ``return_lse``
    against their plain versions (out and lse): the deferred KV append's
    segments.  K1: the cache segment (``q_offset = S``, so only the window
    masks) with windows that leave rows empty and cached lengths s0 off the
    KV tile grid, the new chunk's segment (``q_offset = 0``), an offset in
    between, D = 256 with G = 10, fp32 and bf16; the default offset with the
    lse over part of the grid of :func:`check_flash_grid`.  K2: the decode's
    cache segment, ``context_lens = pos`` and the window less one, an empty
    context (lse = -inf, output 0).  Returns the number of cases."""
    from repro_torch.kernels import ref
    n = 0
    cases = []
    for dt in ("float32", "bfloat16"):
        for B, T, s0, Hq, Hkv, D, window in [
                (1, 64, 64, 4, 2, 64, None), (1, 100, 300, 8, 2, 64, None),
                (2, 77, 129, 16, 2, 128, 48), (1, 130, 200, 32, 8, 128, 100),
                (1, 96, 333, 10, 1, 256, 64), (2, 33, 1000, 10, 1, 256, 2048),
                (1, 50, 70, 6, 1, 32, 1), (1, 200, 128, 16, 2, 128, 64)]:
            cases.append(((B, T, s0, Hq, Hkv, D), dt, {"q_offset": s0, "window": window}))
            cases.append(((B, T, T, Hq, Hkv, D), dt, {"q_offset": 0, "window": window}))
        cases.append(((1, 40, 200, 8, 2, 64), dt, {"q_offset": 37, "window": 30}))
        for shape in [(1, 128, 128, 4, 4, 64), (2, 128, 256, 8, 2, 64),
                      (1, 100, 300, 10, 1, 256), (1, 333, 1000, 4, 1, 32)]:
            cases.append((shape, dt, {}))
        cases.append(((1, 70, 70, 16, 2, 128), dt, {"causal": False}))
    for shape, dt, kw in cases:
        q, k, v = qkv(gen, *shape, getattr(torch, dt))
        out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
        exp, exp_lse = ops.flash_attention(q, k, v, return_lse=True, force="plain", **kw)
        torch.cuda.synchronize()
        assert_close(f"K1 {shape} {dt} {kw} out", out, exp, dt)
        assert_lse_close(f"K1 {shape} {dt} {kw} lse", lse, exp_lse, dt)
        if not torch.equal(out, ops.flash_attention(q, k, v, **kw)):
            raise AssertionError(f"K1 {shape} {dt} {kw}: the output moved with return_lse")
        n += 1
    part = 64
    B, page, pps = 6, 16, 24
    lens = [0, 1, part - 1, part + 1, 2 * part + 5, pps * page]
    for dt in ("float32", "bfloat16"):
        for Hq, Hkv, D in ((8, 2, 64), (32, 8, 128), (10, 1, 256)):
            q, kp, vp, _, _ = paged_inputs(gen, B, Hq, Hkv, D, page, pps, getattr(torch, dt))
            bt = torch.randperm(kp.shape[0], generator=gen, device="cuda")[:B * pps]
            bt = bt.to(torch.int32).view(B, pps).contiguous()
            cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            for window in (None, 2, page, 2 * part + 1):
                w = None if window is None else window - 1
                out, lse = ops.paged_attention(q, kp, vp, bt, cl, window=w, return_lse=True)
                exp, exp_lse = ops.paged_attention(q, kp, vp, bt, cl, window=w,
                                                   return_lse=True, force="plain")
                split, split_lse = ref.paged_attention_split(q, kp, vp, bt, cl, window=w,
                                                             return_lse=True)
                torch.cuda.synchronize()
                name = f"K2 G*D={Hq // Hkv * D} D={D} window {window} - 1 contexts {lens} {dt}"
                if out[0].abs().max() != 0 or not torch.isinf(lse[0]).all():
                    raise AssertionError(f"{name}: an empty context must give 0 and -inf")
                assert_close(f"{name} out", out[1:], exp[1:], dt)
                assert_close(f"{name} out vs plain split", out, split, dt)
                assert_lse_close(f"{name} lse", lse, exp_lse, dt)
                assert_lse_close(f"{name} lse vs plain split", lse, split_lse, dt)
                if not torch.equal(out, ops.paged_attention(q, kp, vp, bt, cl, window=w)):
                    raise AssertionError(f"{name}: the output moved with return_lse")
                n += 1
    log(f"  {n} cases of K1 and K2 with their log-sum-exp: ok")
    return n


def measure_defer_segments(ops):
    """The deferred append's kernel calls at llama3_8b's widths, bf16.  K1's
    cache segment of a 512-token chunk over 1024 cached keys (``q_offset =
    1024``, no mask: every query sees every cached key) with and without the
    lse, its plain version, and SDPA without a mask beside it; K2 at
    :func:`measure_paged`'s decode shape with and without the lse.  Back to
    back (``ms``) and in a CUDA graph (``graph_ms``)."""
    B, T, S, Hq, Hkv, D = 1, 512, 1024, 32, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v = qkv(gen, B, T, S, Hq, Hkv, D, torch.bfloat16)
    seg = lambda **kw: ops.flash_attention(q, k, v, q_offset=S, **kw)    # noqa: E731
    out, lse = seg(return_lse=True)
    exp, exp_lse = seg(return_lse=True, force="plain")
    torch.cuda.synchronize()
    err = assert_close(f"K1 cache segment {(B, T, S, Hq, Hkv, D)} q_offset={S} bfloat16", out,
                       exp, "bfloat16")
    lse_err = assert_lse_close("K1 cache segment lse", lse, exp_lse, "bfloat16")
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    flops = 4 * D * Hq * B * T * S
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) + 4 * lse.numel()
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    k1 = {"shape": [B, T, S, Hq, Hkv, D], "q_offset": S, "max_abs_err": err,
          "lse_max_abs_err": lse_err,
          "ms": time_ms(lambda: seg(return_lse=True)),
          "graph_ms": graph_ms(lambda: seg(return_lse=True)),
          "no_lse_ms": time_ms(lambda: seg()), "no_lse_graph_ms": graph_ms(lambda: seg()),
          "plain_ms": time_ms(lambda: seg(return_lse=True, force="plain")),
          "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)),
          "library_graph_ms": graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)),
          "bound_ms": b_ms, "bound_by": b_by}
    log(f"K1 cache segment: with lse {k1['ms']:.4f} ms ({k1['graph_ms']:.4f} in a graph), "
        f"without {k1['no_lse_ms']:.4f} ms ({k1['no_lse_graph_ms']:.4f}), plain "
        f"{k1['plain_ms']:.4f} ms, SDPA without a mask {k1['library_ms']:.4f} ms "
        f"({k1['library_graph_ms']:.4f}), bound {b_ms:.5f} ms by {b_by}")
    Bp, page, pps = 8, 16, 128
    qd = torch.randn((Bp, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn((Bp * pps, page, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn((Bp * pps, page, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    bt = torch.randperm(Bp * pps, generator=gen, device="cuda").to(torch.int32).view(Bp, pps)
    bt = bt.contiguous()
    cl = torch.tensor([1055, 128, 999, 511, 776, 0, 299, 1023], dtype=torch.int32,
                      device="cuda")
    dec = lambda **kw: ops.paged_attention(qd, kp, vp, bt, cl, **kw)    # noqa: E731
    out, lse = dec(return_lse=True)
    exp, exp_lse = dec(return_lse=True, force="plain")
    torch.cuda.synchronize()
    nz = cl > 0
    ctx = int(cl.sum())
    nbytes = (2 * (qd.numel() + out.numel()) + 2 * 2 * ctx * Hkv * D + 4 * (bt.numel() + Bp)
              + 4 * lse.numel())
    d_ms, d_by = bound(4 * Hq * D * ctx, nbytes, PEAK_BF16_FLOPS)
    k2 = {"shape": [Bp, Hq, Hkv, D, page, pps], "contexts": cl.tolist(),
          "max_abs_err": assert_close("K2 decode cache segment out", out[nz], exp[nz],
                                      "bfloat16"),
          "lse_max_abs_err": assert_lse_close("K2 decode cache segment lse", lse, exp_lse,
                                              "bfloat16"),
          "ms": time_ms(lambda: dec(return_lse=True)),
          "graph_ms": graph_ms(lambda: dec(return_lse=True)),
          "no_lse_ms": time_ms(lambda: dec()), "no_lse_graph_ms": graph_ms(lambda: dec()),
          "plain_ms": time_ms(lambda: dec(return_lse=True, force="plain")),
          "bound_ms": d_ms, "bound_by": d_by}
    log(f"K2 decode cache segment: with lse {k2['ms']:.4f} ms ({k2['graph_ms']:.4f} in a "
        f"graph), without {k2['no_lse_ms']:.4f} ms ({k2['no_lse_graph_ms']:.4f}), plain "
        f"{k2['plain_ms']:.4f} ms, bound {d_ms:.5f} ms by {d_by}")
    return k1, k2


def time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20, reps=5) -> float:
    """Device time a call of ``fn`` with the host out of the way: ``iters``
    calls captured in one CUDA graph, replayed ``reps`` times between CUDA
    events.  That the capture works also shows that ``fn`` reads no device
    value on the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def host_us(fn, n=200) -> float:
    """Host time to issue one call of ``fn`` (the device is not waited for)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def pass_ms(fn, names, iters=20):
    """Device time per call of each launch whose kernel name contains one of
    ``names``, from torch.profiler over ``iters`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for key, _, ns in device_events(prof.profiler.kineto_results.events()):
        for name in names:
            if name in key:
                out[name] += ns / 1e6 / iters
    return out


def device_events(raw, ranges=()):
    """(name, start ns, duration ns) of every kernel, copy and fill among
    ``raw``, a finished torch.profiler run's kineto events as they are
    (``prof.profiler.kineto_results.events()``).  The profiler's own event lists
    (``events()``, ``key_averages()``) build a tree of every event first,
    which for a serving run's hundred thousand launches costs minutes of host
    time.  As there, records of allocations are left out and launches that
    kineto closed with no duration are counted; so are the device-side spans
    of ``record_function`` ranges named in ``ranges`` (no work of their
    own)."""
    out = []
    for e in raw:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        if (name in ranges or name in ("[memory]", "[OutOfMemory]")
                or getattr(e, "activity_type", str)() == "gpu_user_annotation"):
            continue
        out.append((name, e.start_ns(), max(e.duration_ns(), 0)))
    return out


def range_spans(raw, ranges):
    """{range name: [(start ns, end ns), ...]}: among kineto's events ``raw``,
    the device-side span of each call of a ``record_function`` range named
    in ``ranges``, from the first start to the last end of the kernels
    launched inside it."""
    spans = collections.defaultdict(list)
    for e in raw:
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.name() in ranges:
            spans[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return spans


def kernel_table(events):
    """[(ms, calls, name)] of ``device_events`` summed by name, for each
    name with some device time."""
    by_name = collections.defaultdict(lambda: [0, 0])
    for name, _, ns in events:
        by_name[name][0] += ns
        by_name[name][1] += 1
    return [(ns / 1e6, n, name) for name, (ns, n) in by_name.items() if ns > 0]


def kernel_resources(log: str, name: str):
    """Registers, spill stores and loads (bytes) that ptxas reported for the
    first kernel whose mangled name contains ``name``; None where the log
    does not have it (a library built by an earlier run)."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and name in line:
            res = {"registers": None, "spill_stores": None, "spill_loads": None}
            for nxt in lines[i + 1:i + 6]:
                if "spill stores" in nxt:
                    nums = [int(w) for w in nxt.replace(",", " ").split() if w.isdigit()]
                    res["spill_stores"], res["spill_loads"] = nums[1], nums[2]
                if "Used" in nxt and "registers" in nxt:
                    res["registers"] = int(nxt.split("Used")[1].split()[0])
            return res
    return None


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def kernel_bounds(flops, nbytes, dtype):
    """(bound_ms, bound_by, labelled bounds) of a kernel: bf16 on the tensor
    cores at 989 TFLOP/s; fp32 both on the CUDA cores at 67 TFLOP/s and as
    3xTF32 on the tensor cores at 495 / 3 TFLOP/s, the row's bound being the
    latter (the least time fp32-accurate products take on this card, the
    arithmetic K1's fp32 kernels use), whatever units the kernel itself uses."""
    if dtype == "bfloat16":
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        return b_ms, b_by, {"bf16_tensor_cores": [b_ms, b_by]}
    cores = bound(flops, nbytes, PEAK_FP32_FLOPS)
    tf32x3 = bound(flops, nbytes, PEAK_3XTF32_FLOPS)
    return tf32x3[0], tf32x3[1], {"fp32_cuda_cores": list(cores), "3xtf32_tensor_cores": list(tf32x3)}


def cuda_kernel_names(fn):
    """Names of the CUDA kernels one call of ``fn`` launches (torch.profiler),
    so that a library time says what it is."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({name for name, _, _ in device_events(prof.profiler.kineto_results.events())})


def new_kernel_resources():
    """ptxas's registers and spills for K1's fp32 kernel and K1-bwd's
    kernels at every head dim and type (from this run's build log)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as flash_mod
    fwd_log = _build.build_log.get("flash_attention", "")
    bwd_log = _build.build_log.get("flash_attention_bwd", "")
    res = {}
    for D, bk in flash_mod.F32_KEYS.items():
        res[f"flash_fwd_f32_kernel<{D},{bk}>"] = kernel_resources(
            fwd_log, f"flash_fwd_f32_kernelILi{D}ELi{bk}E")
    for tname, mangled in (("float", "f"), ("bf16", "13__nv_bfloat16")):
        for D in flash_mod.HEAD_DIMS:
            for kern in ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"):
                res[f"{kern}<{tname},{D}>"] = kernel_resources(bwd_log,
                                                               f"{kern}I{mangled}Li{D}E")
    for name, r in res.items():
        log(f"  ptxas {name}: {r}")
    return res


def measure_flash(ops):
    """K1 at the llama3_8b prefill shape: one 512-token chunk after 512
    cached tokens.  Besides the times, the device time of one launch
    (torch.profiler), the bf16 kernel's plan there and ptxas's registers
    and spills for the kernel that plan picks."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as flash_mod
    B, T, S, Hq, Hkv, D = 1, 512, 1024, 32, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = qkv(gen, B, T, S, Hq, Hkv, D, torch.bfloat16)
    out = ops.flash_attention(q, k, v)
    exp = ops.flash_attention(q, k, v, force="plain")
    torch.cuda.synchronize()
    err = assert_close(f"K1 llama3_8b {(B, T, S, Hq, Hkv, D)} bfloat16", out, exp, "bfloat16")
    ms = time_ms(lambda: ops.flash_attention(q, k, v))
    plain_ms = time_ms(lambda: ops.flash_attention(q, k, v, force="plain"))
    g_ms = graph_ms(lambda: ops.flash_attention(q, k, v))
    h_us = host_us(lambda: ops.flash_attention(q, k, v))
    # library yardstick: SDPA with the bottom-right causal mask, KV heads
    # repeated and laid out (B, H, S, D) before timing
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    qi = torch.arange(T, device="cuda")[:, None] + (S - T)
    mask = torch.arange(S, device="cuda")[None, :] <= qi
    lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    lib_err = float((lib.transpose(1, 2).float() - exp.float()).abs().max())
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    library_g_ms = graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    pairs = sum(min(S, i + (S - T) + 1) for i in range(T))
    flops = 4 * D * Hq * B * pairs
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    launch_ms = pass_ms(lambda: ops.flash_attention(q, k, v), ("flash_fwd_wgmma",))
    p = flash_mod.plan(B, T, S, Hq, Hkv, D)
    res = kernel_resources(_build.build_log.get("flash_attention", ""),
                           f"flash_fwd_wgmma_kernelILi{D}ELi{p.block_keys}ELi{p.block_rows // 64}E")
    log(f"K1 llama3_8b: kernel {ms:.4f} ms ({g_ms:.4f} in a graph; device time per launch "
        f"{launch_ms['flash_fwd_wgmma']:.4f} ms), plain {plain_ms:.4f} ms, "
        f"SDPA {library_ms:.4f} ms ({library_g_ms:.4f} in a graph) "
        f"(SDPA vs plain max abs err {lib_err:.3e}), bound {b_ms:.5f} ms by {b_by} "
        f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB); "
        f"fp32-core bound {flops / PEAK_FP32_FLOPS * 1e3:.5f} ms; host {h_us:.1f} us a call")
    log(f"K1 plan at that shape: {p}; ptxas for its kernel: {res}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:109",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "graph_ms": g_ms,
            "library_graph_ms": library_g_ms, "host_us": h_us,
            "launch_ms": launch_ms["flash_fwd_wgmma"], "tiles": [p.block_rows, p.block_keys],
            "smem_bytes": p.smem_bytes, "ptxas": res}


def measure_paged(ops):
    """K2 at the llama3_8b decode shape: 8 sequences, page 16, 128 pages
    each, contexts up to 1056."""
    B, Hq, Hkv, D, page, pps = 8, 32, 8, 128, 16, 128
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    perm = torch.randperm(B * pps, generator=gen, device="cuda").to(torch.int32)
    bt = perm.view(B, pps).contiguous()
    cl = torch.tensor([1056, 129, 1000, 512, 777, 1, 300, 1024], dtype=torch.int32,
                      device="cuda")
    out = ops.paged_attention(q, kp, vp, bt, cl)
    exp = ops.paged_attention(q, kp, vp, bt, cl, force="plain")
    torch.cuda.synchronize()
    err = assert_close(f"K2 llama3_8b {(B, Hq, Hkv, D, page, pps)} bfloat16", out, exp,
                       "bfloat16")
    # timed over four KV pools in turn (80 MB, more than the 50 MB L2), so
    # that each launch reads its pages from device memory, as a decode step
    # does after the layer's weights have streamed through the cache
    pools = [(kp, vp)] + [tuple(torch.randn(kp.shape, generator=gen, device="cuda")
                                .to(torch.bfloat16) for _ in range(2)) for _ in range(3)]
    turn = itertools.cycle(pools)
    ms = time_ms(lambda: ops.paged_attention(q, *next(turn), bt, cl))
    plain_ms = time_ms(lambda: ops.paged_attention(q, *next(turn), bt, cl, force="plain"))
    # library yardstick: SDPA over the gathered contexts with a length mask,
    # gathered and laid out (B, H, S, D) before timing
    Smax = int(cl.max())
    kg = kp[bt.long()].reshape(B, pps * page, Hkv, D)[:, :Smax]
    vg = vp[bt.long()].reshape(B, pps * page, Hkv, D)[:, :Smax]
    kh = kg.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    vh = vg.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    qh = q[:, :, None, :]
    mask = (torch.arange(Smax, device="cuda")[None, :] < cl[:, None])[:, None, None, :]
    lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    lib_err = float((lib[:, :, 0].float() - exp.float()).abs().max())
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    library_g_ms = graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    g_ms = graph_ms(lambda: ops.paged_attention(q, *next(turn), bt, cl))
    h_us = host_us(lambda: ops.paged_attention(q, *next(turn), bt, cl))
    passes = pass_ms(lambda: ops.paged_attention(q, *next(turn), bt, cl),
                     ("paged_fwd_partial", "paged_fwd_merge"))
    log("K2 llama3_8b device time per pass: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items()))
    ctx = int(cl.sum())
    flops = 4 * Hq * D * ctx
    nbytes = 2 * (q.numel() + out.numel()) + 2 * 2 * ctx * Hkv * D + 4 * (bt.numel() + B)
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"K2 llama3_8b: kernel {ms:.4f} ms ({g_ms:.4f} in a graph), plain {plain_ms:.4f} ms, "
        f"SDPA {library_ms:.4f} ms ({library_g_ms:.4f} in a graph) "
        f"(SDPA vs plain max abs err {lib_err:.3e}), bound {b_ms:.5f} ms by {b_by} "
        f"({nbytes / 1e6:.3f} MB, contexts {cl.tolist()}); host {h_us:.1f} us a call")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:88",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "graph_ms": g_ms,
            "library_graph_ms": library_g_ms, "host_us": h_us}


def measure_paged_window(ops):
    """K2 at mixtral_8x7b's decode shape with its 4096-key window: 8
    sequences, page 16, 512 pages each (a cache of 8192), contexts in
    4000-8192, bf16; the same timings as :func:`measure_paged`, SDPA beside
    it with the window as a boolean mask.  The bound counts the keys the
    window lets each sequence see."""
    B, Hq, Hkv, D, page, pps, window = 8, 32, 8, 128, 16, 512, 4096
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    bt = torch.randperm(B * pps, generator=gen, device="cuda").to(torch.int32).view(B, pps)
    bt = bt.contiguous()
    cl = torch.tensor([4000, 4096, 4097, 5000, 6144, 6208, 7777, 8192], dtype=torch.int32,
                      device="cuda")
    out = ops.paged_attention(q, kp, vp, bt, cl, window=window)
    exp = ops.paged_attention(q, kp, vp, bt, cl, window=window, force="plain")
    torch.cuda.synchronize()
    err = assert_close(f"K2 mixtral_8x7b {(B, Hq, Hkv, D, page, pps)} window {window} bfloat16",
                       out, exp, "bfloat16")
    ms = time_ms(lambda: ops.paged_attention(q, kp, vp, bt, cl, window=window))
    plain_ms = time_ms(lambda: ops.paged_attention(q, kp, vp, bt, cl, window=window,
                                                   force="plain"))
    g_ms = graph_ms(lambda: ops.paged_attention(q, kp, vp, bt, cl, window=window))
    h_us = host_us(lambda: ops.paged_attention(q, kp, vp, bt, cl, window=window))
    S = pps * page
    kh = kp[bt.long()].reshape(B, S, Hkv, D).repeat_interleave(Hq // Hkv, dim=2)
    vh = vp[bt.long()].reshape(B, S, Hkv, D).repeat_interleave(Hq // Hkv, dim=2)
    kh, vh = kh.transpose(1, 2).contiguous(), vh.transpose(1, 2).contiguous()
    qh = q[:, :, None, :]
    pos = torch.arange(S, device="cuda")[None, :]
    mask = ((pos < cl[:, None]) & (pos >= cl[:, None] - window))[:, None, None, :]
    lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    lib_err = float((lib[:, :, 0].float() - exp.float()).abs().max())
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    library_g_ms = graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    keys = int(torch.clamp(cl, max=window).sum())
    flops = 4 * Hq * D * keys
    nbytes = 2 * (q.numel() + out.numel()) + 2 * 2 * keys * Hkv * D + 4 * (bt.numel() + B)
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"K2 mixtral_8x7b window {window}: kernel {ms:.4f} ms ({g_ms:.4f} in a graph), plain "
        f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms ({library_g_ms:.4f} in a graph) "
        f"(SDPA vs plain max abs err {lib_err:.3e}), bound {b_ms:.5f} ms by {b_by} "
        f"({nbytes / 1e6:.3f} MB, {keys} keys in the windows of contexts {cl.tolist()}); "
        f"host {h_us:.1f} us a call")
    return {"shape": [B, Hq, Hkv, D, page, pps], "window": window, "contexts": cl.tolist(),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "graph_ms": g_ms,
            "library_graph_ms": library_g_ms, "host_us": h_us}


def flash_pairs(T, S, causal, window):
    """Query-key pairs that K1 computes for one (batch, query head): every
    one without the causal mask, else the keys each query position sees."""
    if not causal:
        return T * S
    total = 0
    for i in range(T):
        p = i + S - T
        total += p + 1 - (max(0, p - window + 1) if window else 0)
    return total


def measure_flash_point(ops, gen, B, T, S, Hq, Hkv, D, dtype, causal=True, window=None):
    """K1 at one shape against its plain version, then timed as
    :func:`measure_flash` times it (``ms``, ``graph_ms``, plain), SDPA
    beside it with the same mask as a boolean tensor (KV heads repeated and
    laid out (B, H, S, D) before timing), and the bound from the pairs that
    the causal mask and the window leave."""
    dt = getattr(torch, dtype)
    q, k, v = qkv(gen, B, T, S, Hq, Hkv, D, dt)
    kw = {"causal": causal, "window": window}
    what = f"K1 {(B, T, S, Hq, Hkv, D)} {dtype} causal={causal} window={window}"
    out = ops.flash_attention(q, k, v, **kw)
    exp = ops.flash_attention(q, k, v, force="plain", **kw)
    torch.cuda.synchronize()
    err = assert_close(what, out, exp, dtype)
    del exp
    ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
    g_ms = graph_ms(lambda: ops.flash_attention(q, k, v, **kw))
    plain_ms = time_ms(lambda: ops.flash_attention(q, k, v, force="plain", **kw), iters=5)
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    mask = None
    if causal:
        qi = torch.arange(T, device="cuda")[:, None] + (S - T)
        kj = torch.arange(S, device="cuda")[None, :]
        mask = kj <= qi
        if window:
            mask &= qi - kj < window
    if causal and window is None and S == T:
        mask = None                      # the causal mask as is_causal, as training calls it

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              is_causal=causal and mask is None)
    library_ms = time_ms(sdpa)
    library_g_ms = graph_ms(sdpa)
    names = cuda_kernel_names(sdpa)
    flops = 4 * D * Hq * B * flash_pairs(T, S, causal, window)
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by, bounds = kernel_bounds(flops, nbytes, dtype)
    log(f"{what}: kernel {ms:.4f} ms ({g_ms:.4f} in a graph), plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms ({library_g_ms:.4f} in a graph; {names}), bound {b_ms:.5f} ms "
        f"by {b_by} ({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB; {bounds})")
    return {"shape": [B, T, S, Hq, Hkv, D], "dtype": dtype, "causal": causal, "window": window,
            "max_abs_err": err, "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bounds": bounds, "library_ms": library_ms,
            "library_graph_ms": library_g_ms, "library_kernels": names}


def measure_flash_new_shapes(ops):
    """K1 at the shapes of recurrentgemma_2b's local attention (D=256, 10
    query heads over one KV head, window 2048: a 3072-token prompt at once
    and its last 512-token chunk) in bf16 and fp32, and at whisper_base's
    non-causal shapes (8 heads of 64: the encoder over 1500 frames, a
    64-token decoder chunk over them) in bf16.  Also the bf16 kernel's plan
    and ptxas's registers and spills at D=256."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as flash_mod
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for dtype in ("bfloat16", "float32"):
        for T, S in ((3072, 3072), (512, 3072)):
            rows.append(measure_flash_point(ops, gen, 1, T, S, 10, 1, 256, dtype, window=2048))
    for T in (1500, 64):
        rows.append(measure_flash_point(ops, gen, 1, T, 1500, 8, 8, 64, "bfloat16", causal=False))
    log_text = _build.build_log.get("flash_attention", "")
    for T, S in ((3072, 3072), (512, 3072)):
        p = flash_mod.plan(1, T, S, 10, 1, 256)
        res = kernel_resources(log_text, f"flash_fwd_wgmma_kernelILi256ELi{p.block_keys}"
                                         f"ELi{p.block_rows // 64}E")
        log(f"K1 plan at (T={T}, S={S}, G=10, D=256): {p}; ptxas for its kernel: {res}")
    for tiles in ((64, 64), (128, 64)):
        res = kernel_resources(log_text, f"flash_fwd_wgmma_kernelILi256ELi{tiles[1]}"
                                         f"ELi{tiles[0] // 64}E")
        log(f"K1 bf16 D=256 tiles {tiles}: ptxas {res}")
    log(f"K1 fp32 D=256: ptxas "
        f"{kernel_resources(log_text, f'flash_fwd_f32_kernelILi256ELi{flash_mod.F32_KEYS[256]}E')}")
    return rows


def measure_flash_training(ops):
    """K1 at qwen2_5_3b's training shape (a microbatch of 4 sequences of 512
    tokens, 16 query heads over 2 KV heads of 128, causal) in fp32, the
    type training runs, and bf16: as :func:`measure_flash_point` (SDPA with
    ``is_causal``), with the fp32 kernel's plan."""
    from repro_torch.kernels import flash_attention as flash_mod
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = [measure_flash_point(ops, gen, 4, 512, 512, 16, 2, 128, dtype)
            for dtype in ("float32", "bfloat16")]
    rows[0]["plan"] = flash_mod.f32_plan(4, 512, 512, 16, 2, 128)._asdict()
    log(f"K1 fp32 at the training shape: plan {rows[0]['plan']}")
    return rows


def measure_paged_d256(ops):
    """K2 at recurrentgemma_2b's decode shape: 4 sequences, 10 query heads
    over one KV head of 256, window 2048, page 16, 256 pages a row (a slot
    of 4096), contexts 2049-3072; timed as :func:`measure_paged_window`."""
    from repro_torch.kernels import _build
    B, Hq, Hkv, D, page, pps, window = 4, 10, 1, 256, 16, 256, 2048
    gen = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    bt = torch.arange(B * pps, dtype=torch.int32, device="cuda").view(B, pps)
    cl = torch.tensor([3072, 2049, 2500, 3072], dtype=torch.int32, device="cuda")
    out = ops.paged_attention(q, kp, vp, bt, cl, window=window)
    exp = ops.paged_attention(q, kp, vp, bt, cl, window=window, force="plain")
    torch.cuda.synchronize()
    err = assert_close(f"K2 recurrentgemma_2b {(B, Hq, Hkv, D, page, pps)} window {window} "
                       "bfloat16", out, exp, "bfloat16")
    ms = time_ms(lambda: ops.paged_attention(q, kp, vp, bt, cl, window=window))
    plain_ms = time_ms(lambda: ops.paged_attention(q, kp, vp, bt, cl, window=window,
                                                   force="plain"))
    g_ms = graph_ms(lambda: ops.paged_attention(q, kp, vp, bt, cl, window=window))
    S = pps * page
    kh = kp[bt.long()].reshape(B, S, Hkv, D).repeat_interleave(Hq // Hkv, dim=2)
    vh = vp[bt.long()].reshape(B, S, Hkv, D).repeat_interleave(Hq // Hkv, dim=2)
    kh, vh = kh.transpose(1, 2).contiguous(), vh.transpose(1, 2).contiguous()
    qh = q[:, :, None, :]
    pos = torch.arange(S, device="cuda")[None, :]
    mask = ((pos < cl[:, None]) & (pos >= cl[:, None] - window))[:, None, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    library_g_ms = graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    keys = int(torch.clamp(cl, max=window).sum())
    flops = 4 * Hq * D * keys
    nbytes = 2 * (q.numel() + out.numel()) + 2 * 2 * keys * Hkv * D + 4 * (bt.numel() + B)
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    res = kernel_resources(_build.build_log.get("paged_attention", ""),
                           "paged_fwd_partialI13__nv_bfloat16Li256E")
    log(f"K2 recurrentgemma_2b window {window}: kernel {ms:.4f} ms ({g_ms:.4f} in a graph), "
        f"plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms ({library_g_ms:.4f} in a graph), "
        f"bound {b_ms:.5f} ms by {b_by} ({nbytes / 1e6:.3f} MB, {keys} keys); ptxas {res}")
    return {"shape": [B, Hq, Hkv, D, page, pps], "window": window, "contexts": cl.tolist(),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "graph_ms": g_ms,
            "library_graph_ms": library_g_ms, "ptxas": res}


def ssd_inputs(gen, B, T, H, P, N, dtype, carry=False):
    """Inputs of K3 with realistic decays, dA = -softplus(normal)."""
    dev = "cuda"
    xdt = torch.randn((B, T, H, P), generator=gen, device=dev)
    dA = -F.softplus(torch.randn((B, T, H), generator=gen, device=dev))
    Bm = torch.randn((B, T, N), generator=gen, device=dev)
    Cm = torch.randn((B, T, N), generator=gen, device=dev)
    s0 = torch.randn((B, H, N, P), generator=gen, device=dev) if carry else None
    return [t.to(dtype) for t in (xdt, dA, Bm, Cm)], s0


def check_ssd_grid(ops):
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [((1, 128, 2, 64, 32), 128, "float32", None, False),   # single chunk
             ((2, 256, 2, 64, 32), 128, "float32", None, False),   # two chunks
             ((1, 512, 1, 32, 64), 128, "float32", None, False),   # four chunks
             ((2, 64, 4, 16, 16), 32, "float32", None, False),     # small chunks
             ((1, 96, 2, 32, 32), 32, "float32", None, False),     # non-power-of-two T
             ((1, 128, 2, 32, 32), 64, "bfloat16", None, False)]   # bf16 inputs
    # the property sweep of tests/test_kernels.py, as fixed points, at 5e-4
    for n, chunk, H, P, N in [(1, 16, 1, 16, 16), (4, 64, 3, 32, 32), (2, 32, 2, 16, 32),
                              (3, 16, 3, 32, 16), (1, 64, 2, 16, 16), (4, 32, 1, 32, 16)]:
        cases.append(((1, n * chunk, H, P, N), chunk, "float32", 5e-4, False))
    # what the Pallas kernel does not take: ragged T, a carried state, bf16 with both
    for shape, chunk, dt in [((2, 37, 2, 16, 16), 16, "float32"),
                             ((1, 5, 2, 32, 32), 16, "float32"),
                             ((2, 200, 2, 64, 32), 64, "float32"),
                             ((1, 150, 2, 32, 32), 64, "bfloat16"),
                             ((3, 2000, 4, 32, 32), 32, "float32")]:   # 63 chunks
        cases.append((shape, chunk, dt, None, True))
    # the mamba2_370m prefill shapes: a full 512-token chunk and a ragged one
    for T, carry in ((512, False), (512, True), (379, True)):
        cases.append(((1, T, 32, 64, 128), 128, "float32", None, carry))
    for shape, chunk, dt, tol, carry in cases:
        (xdt, dA, Bm, Cm), s0 = ssd_inputs(gen, *shape, getattr(torch, dt), carry)
        y, st = ops.ssd_scan(xdt, dA, Bm, Cm, chunk=chunk, initial_state=s0)
        y_exp, st_exp = ops.ssd_scan(xdt, dA, Bm, Cm, chunk=chunk, initial_state=s0,
                                     force="plain")
        torch.cuda.synchronize()
        what = f"K3 {shape} chunk {chunk} {dt}{' carried state' if carry else ''}"
        assert_close(what + " y", y, y_exp, dt, tol)
        assert_close(what + " state", st, st_exp, dt, tol)


def ssd_flops(B, T, H, P, N, Q):
    """Operations of the chunked SSD algorithm on these inputs, counting the
    rows of a ragged last chunk only: C·Bᵀ over the causal triangle once per
    (sequence, chunk), since it does not depend on the head; per (sequence,
    head, chunk) the L weighting, (C·Bᵀ ∘ L)·xdt over the triangle,
    exp(cum)·C·S and the state update.  The exponentials are not counted."""
    total = 0
    for c0 in range(0, T, Q):
        q = min(Q, T - c0)
        tri = q * (q + 1) // 2
        total += B * 2 * N * tri
        total += B * H * (tri + 2 * P * tri + (2 * q * N * P + q * P)
                          + (2 * q * N * P + q * P + N * P))
    return total


SSD_FWD_LAUNCHES = ("ssd_fwd_chunk", "ssd_fwd_scan")


def ssd_launch_flops(B, T, H, P, N, Q):
    """``ssd_flops`` cut by launch: ssd_fwd_chunk computes C·Bᵀ over the
    triangle and each head's ΔS with its weighting; ssd_fwd_scan the L
    weighting, (C·Bᵀ ∘ L)·xdt, exp(cum)·C·S_prev and the decay of the
    state."""
    chunk = scan = 0
    for c0 in range(0, T, Q):
        q = min(Q, T - c0)
        tri = q * (q + 1) // 2
        chunk += B * 2 * N * tri + B * H * (2 * q * N * P + q * P)
        scan += B * H * (tri + 2 * P * tri + 2 * q * N * P + q * P + N * P)
    return {"ssd_fwd_chunk": chunk, "ssd_fwd_scan": scan}


def ssd_launch_bounds(B, T, H, P, N, Q):
    """Each launch's least time by its operations alone, ms: at 3xTF32's
    rate on the tensor cores (the arithmetic it uses) and on the CUDA
    cores."""
    return {k: {"3xtf32_ms": f / PEAK_3XTF32_FLOPS * 1e3, "cuda_cores_ms": f / PEAK_FP32_FLOPS * 1e3}
            for k, f in ssd_launch_flops(B, T, H, P, N, Q).items()}


def ssd_fwd_resources():
    """ptxas's registers and spills of every K3 instantiation (both
    launches, fp32 and bf16, column tiles 16, 32 and 64) from this run's
    build log; none may spill."""
    from repro_torch.kernels import _build
    blog = _build.build_log.get("ssd_scan", "")
    res = {f"{k}<{tn},{pt}>": kernel_resources(blog, f"{k}I{mangled}Li{pt}E")
           for k in SSD_FWD_LAUNCHES for tn, mangled in (("float", "f"), ("bf16", "13__nv_bfloat16"))
           for pt in (16, 32, 64)}
    spills = {k: v for k, v in res.items() if v is None or v["spill_stores"] or v["spill_loads"]}
    if spills:
        raise AssertionError(f"K3: ptxas reports spills (or no entry) for {spills}")
    return res


def log_launches(what, launch, bounds):
    log(f"{what} device time per launch: " + "; ".join(
        f"{k} {launch[k]:.4f} ms (bounds by operations: 3xTF32 {bounds[k]['3xtf32_ms']:.5f}, "
        f"CUDA cores {bounds[k]['cuda_cores_ms']:.5f})" for k in SSD_FWD_LAUNCHES))


def measure_ssd(ops):
    """K3 at the mamba2_370m prefill shape: one 512-token chunk of one
    sequence from a carried state, fp32, as the SSD layer calls it; then the
    ragged 379-token chunk of the serving traffic, prefill budgets of 2048
    and 8192 tokens (16 and 64 chunks), where the state passing along the
    chunks would show if it grew faster than the chunks, and mamba2_370m's
    training shape (4 sequences of 2048).  Each launch's device time is
    printed beside its own bounds (``ssd_launch_bounds``), and ptxas's
    registers and spills of every instantiation (``ssd_fwd_resources``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    ptxas = ssd_fwd_resources()
    log(f"K3 ptxas: {ptxas}")
    B, T, H, P, N, Q = 1, 512, 32, 64, 128, 128
    gen = torch.Generator(device="cuda").manual_seed(6)
    (xdt, dA, Bm, Cm), s0 = ssd_inputs(gen, B, T, H, P, N, torch.float32, carry=True)
    y, st = ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0)
    y_exp, st_exp = ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0, force="plain")
    y_two, st_two = ref.ssd_scan_two_pass(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0)
    torch.cuda.synchronize()
    err = max(assert_close(f"K3 mamba2_370m {(B, T, H, P, N)} y", y, y_exp, "float32"),
              assert_close(f"K3 mamba2_370m {(B, T, H, P, N)} state", st, st_exp, "float32"))
    assert_close("K3 plain two passes vs plain y", y_two, y_exp, "float32")
    assert_close("K3 plain two passes vs plain state", st_two, st_exp, "float32")
    ms = time_ms(lambda: ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0))
    plain_ms = time_ms(lambda: ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0,
                                            force="plain"))
    g_ms = graph_ms(lambda: ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0))
    h_us = host_us(lambda: ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0))
    passes = pass_ms(lambda: ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0),
                     SSD_FWD_LAUNCHES)
    log_launches(f"K3 mamba2_370m T={T} (column tile {ssd_mod.col_tile(P)})", passes,
                 ssd_launch_bounds(B, T, H, P, N, Q))
    flops = ssd_flops(B, T, H, P, N, Q)
    nbytes = 4 * (xdt.numel() + dA.numel() + Bm.numel() + Cm.numel() + s0.numel()
                  + y.numel() + st.numel())
    b_ms, b_by, bounds = kernel_bounds(flops, nbytes, "float32")
    log(f"K3 mamba2_370m: kernel {ms:.4f} ms ({g_ms:.4f} in a graph), plain {plain_ms:.4f} ms, "
        f"no library call, "
        f"bound {b_ms:.5f} ms by {b_by} ({flops / 1e9:.4f} GFLOP, "
        f"{nbytes / 1e6:.3f} MB; {bounds}); host {h_us:.1f} us a call")
    # the ragged serving chunk (379 tokens), long prefill budgets and the
    # training shape, each from a carried state
    lengths = {}
    for B2, T2 in ((1, 379), (1, 2048), (1, 8192), (4, 2048)):
        (x2, a2, B2m, C2), s2 = ssd_inputs(gen, B2, T2, H, P, N, torch.float32, carry=True)
        y2, st2 = ops.ssd_scan(x2, a2, B2m, C2, chunk=Q, initial_state=s2)
        y2_exp, st2_exp = ops.ssd_scan(x2, a2, B2m, C2, chunk=Q, initial_state=s2, force="plain")
        torch.cuda.synchronize()
        assert_close(f"K3 mamba2_370m {B2}x{T2} y", y2, y2_exp, "float32")
        assert_close(f"K3 mamba2_370m {B2}x{T2} state", st2, st2_exp, "float32")
        ms2 = time_ms(lambda: ops.ssd_scan(x2, a2, B2m, C2, chunk=Q, initial_state=s2))
        g2 = graph_ms(lambda: ops.ssd_scan(x2, a2, B2m, C2, chunk=Q, initial_state=s2))
        plain2 = time_ms(lambda: ops.ssd_scan(x2, a2, B2m, C2, chunk=Q, initial_state=s2,
                                              force="plain"))
        passes2 = pass_ms(lambda: ops.ssd_scan(x2, a2, B2m, C2, chunk=Q, initial_state=s2),
                          SSD_FWD_LAUNCHES)
        nbytes2 = 4 * (2 * x2.numel() + a2.numel() + B2m.numel() + C2.numel() + 2 * s2.numel())
        b2_ms, b2_by, _ = kernel_bounds(ssd_flops(B2, T2, H, P, N, Q), nbytes2, "float32")
        lengths[f"{B2}x{T2}"] = {"ms": ms2, "graph_ms": g2, "plain_ms": plain2,
                                 "bound_ms": b2_ms, "launch_ms": passes2}
        log(f"K3 mamba2_370m {B2}x{T2}: kernel {ms2:.4f} ms ({g2:.4f} in a graph), "
            f"plain {plain2:.4f} ms, bound {b2_ms:.5f} ms by {b2_by}")
        log_launches(f"K3 mamba2_370m {B2}x{T2}", passes2, ssd_launch_bounds(B2, T2, H, P, N, Q))
    # a tensor-parallel rank's heads (phase 29: 8 of 32 at 4 ranks; 2 at 16)
    # on phase 29's prompt, two rows of 1000 tokens from a carried state
    heads = {}
    for H2 in (32, 8, 2):
        (x2, a2, B2, C2), s2 = ssd_inputs(gen, 2, 1000, H2, P, N, torch.float32, carry=True)
        y2, st2 = ops.ssd_scan(x2, a2, B2, C2, chunk=Q, initial_state=s2)
        y2_exp, st2_exp = ops.ssd_scan(x2, a2, B2, C2, chunk=Q, initial_state=s2, force="plain")
        torch.cuda.synchronize()
        assert_close(f"K3 2x1000, {H2} heads y", y2, y2_exp, "float32")
        assert_close(f"K3 2x1000, {H2} heads state", st2, st2_exp, "float32")
        ms2 = time_ms(lambda: ops.ssd_scan(x2, a2, B2, C2, chunk=Q, initial_state=s2))
        g2 = graph_ms(lambda: ops.ssd_scan(x2, a2, B2, C2, chunk=Q, initial_state=s2))
        plain2 = time_ms(lambda: ops.ssd_scan(x2, a2, B2, C2, chunk=Q, initial_state=s2,
                                              force="plain"))
        nbytes2 = 4 * (2 * x2.numel() + a2.numel() + B2.numel() + C2.numel() + 2 * s2.numel())
        b2_ms, b2_by, _ = kernel_bounds(ssd_flops(2, 1000, H2, P, N, Q), nbytes2, "float32")
        heads[H2] = {"ms": ms2, "graph_ms": g2, "plain_ms": plain2, "bound_ms": b2_ms}
        log(f"K3 2x1000, {H2} heads (a rank's of phase 29 at {32 // H2} ranks): kernel "
            f"{ms2:.4f} ms ({g2:.4f} in a graph), plain {plain2:.4f} ms, bound {b2_ms:.5f} ms "
            f"by {b2_by}")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:84",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bounds": bounds, "library_ms": None, "graph_ms": g_ms,
            "library_graph_ms": None, "host_us": h_us, "launch_ms": passes,
            "lengths": lengths, "rank_heads": heads, "ptxas": ptxas}


# -------------------------------------------------------------------------
# 3e. K1's gradient kernel against autograd through the plain version
# -------------------------------------------------------------------------

# Tolerances of K1-bwd, against the largest entry of the reference gradient:
# fp32 1e-3, since the kernel's fp32 sums run over up to 1500 keys and 10
# query heads of a group in another order than the plain version's products,
# and each dS = P (dP - delta) subtracts two sums of that size; bf16 2e-2, the
# bf16 tolerance of every kernel here: the kernel computes in fp32 but reads
# K1's bf16-rounded output for delta and rounds its own results to bf16.
BWD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}


def flash_grads(ops, q, k, v, dout, force=None, **kw):
    """(out, dq, dk, dv) of ``ops.flash_attention`` under ``dout``."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(q, k, v, force=force, **kw)
    return (out.detach(),) + torch.autograd.grad(out, (q, k, v), dout)


def check_flash_bwd_point(ops, gen, B, T, S, Hq, Hkv, D, dtype, causal=True, window=None):
    """K1's gradient through ``ops.flash_attention`` (K1 forward and K1-bwd)
    against autograd through the plain version on the same values in fp32,
    each of dq, dk, dv within ``BWD_TOL`` of the largest entry of the three.
    Returns the largest error relative to that entry."""
    dt = getattr(torch, dtype)
    q, k, v = qkv(gen, B, T, S, Hq, Hkv, D, dt)
    dout = torch.randn((B, T, Hq, D), generator=gen, device="cuda").to(dt)
    kw = dict(causal=causal, window=window)
    got = flash_grads(ops, q, k, v, dout, **kw)
    exp = flash_grads(ops, q.float(), k.float(), v.float(), dout.float(), force="plain", **kw)
    torch.cuda.synchronize()
    largest = max(float(e.abs().max()) for e in exp[1:])     # dq and dk are 0 at S = 1
    worst_abs = 0.0
    for name, g, e in zip(("dq", "dk", "dv"), got[1:], exp[1:]):
        if g.dtype != dt or not torch.isfinite(g).all():
            raise AssertionError(f"K1-bwd {name}: {g.dtype}, or not finite")
        worst_abs = max(worst_abs, float((g.float() - e).abs().max()))
    worst = worst_abs / largest
    what = f"K1-bwd {(B, T, S, Hq, Hkv, D)} {dtype} causal={causal} window={window}"
    ok = worst <= BWD_TOL[dtype]
    log(f"  {what:70s} max err / max |grad| {worst:.3e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: {worst} of the largest gradient, over {BWD_TOL[dtype]}")
    return worst, worst_abs


def check_flash_bwd_grid(ops):
    """Phase 3e: fp32 and bf16; D 32, 64, 128, 256; causal, windowed and
    non-causal; T 1, 37, 512, 1500 with G 1, 8, 10 and 1; and whisper's
    cross-attention, 448 queries over 1500 frames without the mask."""
    gen = torch.Generator(device="cuda").manual_seed(30)
    n, worst = 0, {"float32": 0.0, "bfloat16": 0.0}
    for dtype in ("float32", "bfloat16"):
        for D in (32, 64, 128, 256):
            for T, Hq, Hkv in ((1, 2, 2), (37, 16, 2), (512, 10, 1), (1500, 4, 4)):
                for causal, window, S in ((True, None, T), (True, max(1, T // 3), T),
                                          (False, None, T + 13)):
                    worst[dtype] = max(worst[dtype], check_flash_bwd_point(
                        ops, gen, 1, T, S, Hq, Hkv, D, dtype, causal, window)[0])
                    n += 1
        worst[dtype] = max(worst[dtype], check_flash_bwd_point(
            ops, gen, 2, 448, 1500, 8, 8, 64, dtype, causal=False)[0])
        n += 1
    log(f"K1-bwd: {n} cases, worst error over the largest gradient entry: {worst}")
    return worst


def measure_flash_bwd(ops):
    """K1-bwd at qwen2_5_3b's training shape (a microbatch of 4 sequences of
    512 tokens, 16 query heads over 2 KV heads of 128, causal) in fp32 and
    bf16: the kernel (back to back, in a CUDA graph, the device time of each
    launch), autograd's backward through the plain version, SDPA's backward
    (its forward and backward less its forward, KV heads repeated and laid
    out (B, H, S, D) first, the causal mask as ``is_causal``) with the names
    of the kernels SDPA launched, and the bounds: five products of
    2 T S_eff D a (batch, head) over the arithmetic's peak (for fp32 both the
    CUDA cores' and 3xTF32's, labelled), against reading q, k, v, out, dout
    and lse once and writing dq, dk, dv once."""
    from repro_torch.kernels import flash_attention_bwd as bwd_mod
    B, T, S, Hq, Hkv, D = 4, 512, 512, 16, 2, 128
    gen = torch.Generator(device="cuda").manual_seed(31)
    res = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q, k, v = qkv(gen, B, T, S, Hq, Hkv, D, dt)
        dout = torch.randn((B, T, Hq, D), generator=gen, device="cuda").to(dt)
        out, lse = ops.flash_attention(q, k, v, return_lse=True)
        err, err_abs = check_flash_bwd_point(ops, gen, B, T, S, Hq, Hkv, D, dtype)

        def kern():
            return bwd_mod.flash_attention_bwd(q, k, v, out, dout, lse)
        ms, g_ms = time_ms(kern), graph_ms(kern)
        qp, kp, vp = (t.detach().requires_grad_() for t in (q, k, v))
        plain_out = ops.flash_attention(qp, kp, vp, force="plain")
        plain_ms = time_ms(lambda: torch.autograd.grad(plain_out, (qp, kp, vp), dout,
                                                       retain_graph=True), iters=5)
        del plain_out
        G = Hq // Hkv
        qh = q.transpose(1, 2).contiguous().requires_grad_()
        kh = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous().requires_grad_()
        vh = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous().requires_grad_()
        doh = dout.transpose(1, 2).contiguous()

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa_fwd(), (qh, kh, vh), doh)
        fwd_ms, fb_ms = time_ms(sdpa_fwd), time_ms(sdpa_fwd_bwd)
        fwd_g, fb_g = graph_ms(sdpa_fwd), graph_ms(sdpa_fwd_bwd)
        fwd_names = set(cuda_kernel_names(sdpa_fwd))
        bwd_names = [n for n in cuda_kernel_names(sdpa_fwd_bwd) if n not in fwd_names]
        pairs = flash_pairs(T, S, True, None)
        flops = 5 * 2 * pairs * D * Hq * B
        # q, out and dout read, dq written; k, v read, dk, dv written; lse read.
        nbytes = q.element_size() * (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) \
            + 4 * lse.numel()
        b_ms, b_by, bounds = kernel_bounds(flops, nbytes, dtype)
        launch = pass_ms(kern, ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_reduce",
                                "flash_bwd_dq"))
        p = bwd_mod.plan(B, T, S, Hq, Hkv, D, dt)
        log(f"K1-bwd qwen2_5_3b {(B, T, S, Hq, Hkv, D)} {dtype}: kernel {ms:.4f} ms "
            f"({g_ms:.4f} in a graph; device time per launch {launch}), plain backward "
            f"{plain_ms:.4f} ms, SDPA backward {fb_ms - fwd_ms:.4f} ms ({fb_g - fwd_g:.4f} in a "
            f"graph; forward {fwd_ms:.4f}, forward and backward {fb_ms:.4f}; its backward "
            f"kernels {bwd_names}), bound {b_ms:.5f} ms by {b_by} ({flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.3f} MB; {bounds}); plan {p}")
        res[dtype] = {"max_err_rel": err, "max_abs_err": err_abs, "ms": ms, "graph_ms": g_ms,
                      "plain_ms": plain_ms, "library_ms": fb_ms - fwd_ms,
                      "library_graph_ms": fb_g - fwd_g, "library_kernels": bwd_names,
                      "bound_ms": b_ms, "bound_by": b_by, "bounds": bounds,
                      "launch_ms": launch, "blocks": [p.dkdv_blocks, p.dq_blocks]}
        del qh, kh, vh
    f32 = res["float32"]
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/kernels/flash_attention.py:109",
           "gradient_of": "K1; the reference differentiates its jnp attention with XLA "
                          "(src/repro/models/transformer.py:133-136)",
           "shape": [B, T, S, Hq, Hkv, D], "dtype": "float32"}
    row.update(f32)
    row["bfloat16"] = res["bfloat16"]
    return row


# -------------------------------------------------------------------------
# 3f. K3's gradient kernel against the plain decomposition and autograd
# -------------------------------------------------------------------------

# Tolerances of K3-bwd, against the largest entry of each reference gradient:
# fp32 1e-4, since the kernel sums its fp32 products over up to 128 positions
# and 128 state rows in another order than the plain versions; bf16 1e-2,
# since the inputs are rounded to bf16 and the gradients returned in it.
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def ssd_grads(ops, xs, s0, dy, d_final, chunk, force=None):
    """The gradients of ``ops.ssd_scan``'s inputs (xdt, dA, Bm, Cm, and the
    initial state where there is one) under ``dy`` and ``d_final`` (None:
    the final state is not used)."""
    ins = [t.detach().requires_grad_() for t in xs]
    if s0 is not None:
        ins.append(s0.detach().requires_grad_())
    y, st = ops.ssd_scan(*ins[:4], chunk=chunk, initial_state=ins[4] if s0 is not None else None,
                         force=force)
    outs, gouts = [y], [dy]
    if d_final is not None:
        outs.append(st)
        gouts.append(d_final)
    return torch.autograd.grad(outs, ins, gouts)


ZERO_GRAD = 1e-6    # a gradient whose largest entry is under this share of the call's is 0
ZERO_GRAD_SCALE = 1e-1      # ... and is judged against this share of the call's largest entry


def grad_scales(exp):
    """The scale each gradient's error is judged against: its largest |exp|,
    or for a gradient that is zero in exact arithmetic (largest entry under
    ``ZERO_GRAD`` of the largest over all the call's gradients: rounding
    noise, as ddA at T = 1 without an initial state, where dA enters
    nothing) ``ZERO_GRAD_SCALE`` of that largest, so that it is still held
    to rounding: its entries are differences of sums of N·P products (the
    state terms of dcum), whose fp32 rounding reaches ~1e-6 of the largest
    entry (8.4e-7 in the plain 3xTF32 arithmetic at N = 128, P = 64), so
    at 1e-4 of 1e-1 an fp32 kernel is held to 1e-5 of it.  Every other case
    keeps its own largest entry: over phase 3f's grid the smallest gradient
    is above 1e-2 of the largest."""
    own = [float(e.abs().max()) for e in exp]
    top = max(own)
    return [m if m > ZERO_GRAD * top else ZERO_GRAD_SCALE * top for m in own]


def grads_err(got, exp):
    """Largest |got - exp| over the gradient's scale (``grad_scales``: its
    largest |exp|), gradient by gradient; returns (worst ratio, worst
    absolute error)."""
    ratio, worst_abs = 0.0, 0.0
    for g, e, scale in zip(got, exp, grad_scales(exp)):
        if not torch.isfinite(g).all():
            raise AssertionError("a gradient is not finite")
        err = float((g.float() - e.float()).abs().max())
        ratio = max(ratio, err / scale)
        worst_abs = max(worst_abs, err)
    return ratio, worst_abs


def check_ssd_bwd_point(ops, gen, B, T, H, P, N, chunk, dtype, init, final):
    """K3-bwd through ``ops.ssd_scan``'s autograd (K3 forward, K3-bwd
    backward, one launch each) against the plain decomposition
    (``ref.ssd_scan_bwd_two_pass``) and against autograd through the plain
    scan, on the same values in fp32; each gradient within ``SSD_BWD_TOL``
    of its largest entry.  Returns the worst ratio and absolute error."""
    from repro_torch.kernels import ref
    dt = getattr(torch, dtype)
    xs, s0 = ssd_inputs(gen, B, T, H, P, N, dt, init)
    dy = torch.randn((B, T, H, P), generator=gen, device="cuda")
    d_final = torch.randn((B, H, N, P), generator=gen, device="cuda") if final else None
    ops.reset_launch_counts()
    got = ssd_grads(ops, xs, s0, dy, d_final, chunk)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    xf = [x.float() for x in xs]
    plain = ssd_grads(ops, xf, s0, dy, d_final, chunk, force="plain")
    two = [g for g in ref.ssd_scan_bwd_two_pass(*xf, dy, chunk=chunk, initial_state=s0,
                                                 d_final=d_final) if g is not None]
    torch.cuda.synchronize()
    if (counts["ssd_scan"], counts["ssd_scan_bwd"]) != (1, 1) or \
            any(g.dtype != x.dtype for g, x in zip(got, xs)):
        raise AssertionError(f"K3-bwd: launches {counts}, types {[g.dtype for g in got]}")
    err_two, abs_two = grads_err(got, two)
    err_plain, _ = grads_err(got, plain)
    err_ref, _ = grads_err(two, plain)
    what = (f"K3-bwd {(B, T, H, P, N)} chunk {chunk} {dtype} init={init} "
            f"d_final={final}")
    ok = max(err_two, err_plain) <= SSD_BWD_TOL[dtype] and err_ref <= SSD_BWD_TOL["float32"]
    log(f"  {what:66s} vs decomposition {err_two:.3e}, vs autograd {err_plain:.3e} "
        f"(decomposition vs autograd {err_ref:.3e})  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: {err_two}, {err_plain}, {err_ref} of the largest "
                             f"gradient, over {SSD_BWD_TOL[dtype]}")
    return max(err_two, err_plain), abs_two


def check_ssd_bwd_grid(ops):
    """Phase 3f: T 16, 100, 512, 2048 (one ragged chunk, a ragged second,
    whole chunks), N 16 and 128, P 16 and 64, with neither or both of an
    initial state and a final-state gradient, in fp32 at chunk 128; then
    each of the two alone, chunks of 64 and 16 (the smallest shape the
    kernel takes among them: one chunk of 16, N = 4, P = 16), and bf16
    inputs; then the edges of the 3xTF32 tiles: N 4, 8, 12, 100 (zero
    columns up to the mma's 8), P 16 and 48 (tiles of 16), chunks of 16, 32
    and 48, T = 1 (with and without an initial state: without one ddA is
    0, ``grad_scales``), Q + 1 and 2Q − 1, one head, 10 heads in groups of 3
    (T = 1024: ``ssd_scan_bwd.plan`` cuts them so), bf16 at a ragged T."""
    gen = torch.Generator(device="cuda").manual_seed(40)
    n, worst = 0, {"float32": 0.0, "bfloat16": 0.0}
    cases = [(T, N, P, 128, "float32", both, both) for T in (16, 100, 512, 2048)
             for N in (16, 128) for P in (16, 64) for both in (False, True)]
    cases += [(300, 128, 64, 128, "float32", True, False), (300, 128, 64, 128, "float32", False, True),
              (200, 32, 32, 64, "float32", True, True), (37, 16, 16, 16, "float32", True, True),
              (16, 4, 16, 16, "float32", True, True),
              (300, 128, 64, 128, "bfloat16", True, True), (512, 128, 64, 128, "bfloat16", False, False)]
    cases = [c[:1] + (4,) + c[1:] for c in cases]
    # the edges of the 3xTF32 tiles (T, H, N, P, chunk, dtype, init, final)
    cases += [(T, 4, N, 16, 128, "float32", True, True) for T, N in ((100, 4), (129, 8), (255, 12),
                                                                     (200, 100))]
    cases += [(129, 4, 128, 48, 128, "float32", True, False), (47, 4, 8, 48, 16, "float32", False, True),
              (63, 4, 12, 16, 32, "float32", True, True), (95, 4, 100, 32, 48, "float32", True, True),
              (1, 4, 4, 16, 128, "float32", True, True), (1, 4, 128, 64, 32, "float32", True, True),
              (1, 4, 128, 64, 32, "float32", False, True),
              (33, 4, 16, 16, 32, "float32", True, True), (63, 4, 64, 48, 32, "float32", False, False),
              (200, 1, 128, 64, 128, "float32", True, True), (1024, 10, 128, 16, 128, "float32", True, True),
              (129, 4, 12, 48, 128, "bfloat16", True, True)]
    for T, H, N, P, chunk, dtype, init, final in cases:
        worst[dtype] = max(worst[dtype], check_ssd_bwd_point(ops, gen, 2, T, H, P, N, chunk, dtype,
                                                             init, final)[0])
        n += 1
    log(f"K3-bwd: {n} cases, worst error over the largest gradient entry: {worst}")
    return worst


def ssd_bwd_flops(B, T, H, P, N, Q):
    """Operations of K3's gradient on these inputs, counting the rows of a
    ragged last chunk only and the causal triangles only: C·Bᵀ once per
    (sequence, chunk); per (sequence, head, chunk) the chunk's share of the
    state gradient, the reverse scan's step, M = L ∘ (dy·xdtᵀ), dC_h, dB_h
    and dxdt (each an intra-chunk product over the triangle and a state
    product), dcum and ddA's reverse cumsum; the sum of the heads' partials.
    dcum counts the triangle's row and column sums of C·Bᵀ ∘ M, ⟨G, S⟩, and
    the state terms as dot products with state parts already counted:
    C_i·(dy ∘ exp(cum))_i·S_cᵀ reads dC_h's (N a row), and the state
    update's term reads dB_h's (N a row) or dxdt's (P a row), whichever is
    shorter.  The exponentials are not counted; the kernel computes more
    than this (whole squares, whole tiles, the y state term from dC_h's and
    the update's from dB_h's), which the bound does not count."""
    total = 0
    for c0 in range(0, T, Q):
        q = min(Q, T - c0)
        tri = q * (q + 1) // 2
        total += B * 2 * N * tri + B * 2 * (H - 1) * q * N
        total += B * H * ((2 * q * N * P + q * N) + 2 * N * P
                          + (2 * P * tri + tri)
                          + 2 * (2 * N * tri + 2 * q * P * N + q * P)
                          + (2 * P * tri + tri + 2 * q * N * P + q * N)
                          + (4 * (tri - q) + 2 * q * N + 2 * q * min(N, P) + 2 * N * P + q))
    return total


SSD_BWD_LAUNCHES = ("ssd_bwd_chunk", "ssd_bwd_state", "ssd_bwd_grads", "ssd_bwd_bc",
                    "ssd_bwd_group_sum")


def ssd_bwd_scratch_mb(B, T, H, P, N, Q):
    """MB of scratch that each of K3-bwd's launches requests from global
    memory, modelled from its grid and ``ssd_scan_bwd.scratch_shapes`` (no
    counter of this card's DRAM bytes is read: re-reads within a launch may
    hit L2).  CB (C·Bᵀ) is written and read over its causal strips only
    (Q·(Q + 16)/2 floats a chunk); ssd_bwd_grads reads it once a (head, tile
    of P), ssd_bwd_bc reads cumx (the cumsum with its exponentials) once a
    (head, slice of P, half of N); G (the state gradient) and decay are
    counted once a launch that touches them, as are the head groups'
    partials of dB and dC."""
    from repro_torch.kernels import ssd_scan_bwd as bwd_mod
    p = bwd_mod.plan(B, T, H, P, N, Q)
    _, g, cumx, decay, part_b, part_c = (4 * math.prod(s) / 1e6
                                         for s in bwd_mod.scratch_shapes(B, T, H, P, N, Q))
    cb = 4 * B * p.chunks * Q * (Q + 16) / 2 / 1e6
    part = part_b + part_c
    return {"ssd_bwd_chunk": {"read": 0.0, "written": cb + g + cumx + decay},
            "ssd_bwd_state": {"read": g + decay, "written": g},
            "ssd_bwd_grads": {"read": cb * H * (P // p.p_tile) + g + cumx, "written": 0.0},
            "ssd_bwd_bc": {"read": g + cumx * p.halves * (P // p.p_slice), "written": part},
            "ssd_bwd_group_sum": {"read": part, "written": 0.0}}


def measure_ssd_bwd(ops):
    """K3-bwd at mamba2_370m's training shape (a microbatch of 4 sequences
    of 2048 tokens, 32 heads of 64, N = 128, chunks of 128) in fp32, as
    training calls it (no initial state, the final state unused): checked
    against the plain decomposition and autograd, then timed back to back
    and in a CUDA graph with the device time of each of its launches and the
    scratch each requests (``ssd_bwd_scratch_mb``, modelled, in the log only),
    beside the plain decomposition, autograd's backward through the plain
    scan and K3's forward at the same shape; the bound from
    ``ssd_bwd_flops`` at the fp32 rates (``kernel_bounds``: the row's is
    3xTF32's, the CUDA cores' is printed beside it) against reading xdt, dA,
    B, C, dy and the kept states once and writing the four gradients once;
    autograd's backward through the plain scan over 10 calls; K3's forward at
    this shape with its own bounds (``ssd_flops``, in the log only); ptxas's
    registers and spills of every kernel of both types, none of which may
    spill.  No
    PyTorch call computes it."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.kernels import ssd_scan_bwd as bwd_mod
    B, T, H, P, N, Q = 4, 2048, 32, 64, 128, 128
    gen = torch.Generator(device="cuda").manual_seed(41)
    err, err_abs = check_ssd_bwd_point(ops, gen, B, T, H, P, N, Q, "float32", False, False)
    xs, _ = ssd_inputs(gen, B, T, H, P, N, torch.float32)
    dy = torch.randn((B, T, H, P), generator=gen, device="cuda")
    _, state, carry = ssd_mod.ssd_scan(*xs, chunk=Q)

    def kern():
        return bwd_mod.ssd_scan_bwd(*xs, dy, carry, state, chunk=Q)
    ms, g_ms, h_us = time_ms(kern), graph_ms(kern), host_us(kern, n=50)
    launch = pass_ms(kern, SSD_BWD_LAUNCHES)
    fwd_ms = graph_ms(lambda: ssd_mod.ssd_scan(*xs, chunk=Q))
    fwd_flops = ssd_flops(B, T, H, P, N, Q)
    fwd_bytes = 4 * (2 * xs[0].numel() + xs[1].numel() + xs[2].numel() + xs[3].numel()
                     + state.numel() + carry.numel())
    fwd_bound = kernel_bounds(fwd_flops, fwd_bytes, "float32")[2]
    scratch = ssd_bwd_scratch_mb(B, T, H, P, N, Q)
    decomp_ms = time_ms(lambda: ref.ssd_scan_bwd_two_pass(*xs, dy, chunk=Q), iters=3, warmup=1)
    ins = [x.detach().requires_grad_() for x in xs]
    y_plain, _ = ops.ssd_scan(*ins, chunk=Q, force="plain")
    plain_ms = time_ms(lambda: torch.autograd.grad(y_plain, ins, dy, retain_graph=True),
                       iters=10, warmup=2)
    del y_plain, ins
    flops = ssd_bwd_flops(B, T, H, P, N, Q)
    nbytes = 4 * (2 * xs[0].numel() + 2 * xs[1].numel() + 2 * xs[2].numel() + 2 * xs[3].numel()
                  + dy.numel() + carry.numel() + state.numel())
    b_ms, b_by, bounds = kernel_bounds(flops, nbytes, "float32")
    blog = _build.build_log.get("ssd_scan_bwd", "")
    ptxas = {f"{k}<{tn}>": kernel_resources(blog, f"{k}I{mangled}E")
             for k in ("ssd_bwd_chunk", "ssd_bwd_grads", "ssd_bwd_bc")
             for tn, mangled in (("float", "f"), ("bf16", "13__nv_bfloat16"))}
    ptxas.update({k: kernel_resources(blog, k) for k in ("ssd_bwd_state", "ssd_bwd_group_sum")})
    spills = {k: v for k, v in ptxas.items() if v is None or v["spill_stores"] or v["spill_loads"]}
    if spills:
        raise AssertionError(f"K3-bwd: ptxas reports spills (or no entry) for {spills}")
    log(f"K3-bwd mamba2_370m training {(B, T, H, P, N)} chunk {Q}: kernel {ms:.4f} ms "
        f"({g_ms:.4f} in a graph; device time per launch "
        + ", ".join(f"{k} {v:.4f}" for k, v in launch.items())
        + f"), plain decomposition {decomp_ms:.4f} ms, autograd through the plain scan "
        f"{plain_ms:.4f} ms, no library call; bound {b_ms:.5f} ms by {b_by} "
        f"({flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB; {bounds}); scratch MB read and "
        f"written per launch, modelled from the grids and scratch shapes, not measured: "
        f"{scratch} (in all {sum(sum(v.values()) for v in scratch.values()):.3f} MB against "
        f"the bound's {nbytes / 1e6:.3f}); K3 forward at this shape {fwd_ms:.4f} ms "
        f"in a graph, its bounds {fwd_bound} ({fwd_flops / 1e9:.4f} GFLOP, "
        f"{fwd_bytes / 1e6:.3f} MB); host {h_us:.1f} us a call; ptxas {ptxas}")
    return {"name": "ssd_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:84",
            "gradient_of": "K3; the reference differentiates its jnp chunked scan with XLA "
                           "(src/repro/models/layers.py:574-634)",
            "shape": [B, T, H, P, N, Q], "dtype": "float32",
            "max_abs_err": err_abs, "max_err_rel": err, "ms": ms, "graph_ms": g_ms,
            "plain_ms": plain_ms, "decomposition_ms": decomp_ms, "library_ms": None,
            "library_graph_ms": None, "bound_ms": b_ms, "bound_by": b_by, "bounds": bounds,
            "gflop": flops / 1e9, "mb": nbytes / 1e6, "launch_ms": launch,
            "forward_graph_ms": fwd_ms, "host_us": h_us, "ptxas": ptxas}


# -------------------------------------------------------------------------
# 4. and 7. model checks
# -------------------------------------------------------------------------

def check_model(model, params, vocab):
    gen = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, vocab, (1, 257), generator=gen, device="cuda")
    results = {}
    for force in (None, "plain"):
        cache = model.init_cache(1, 512, torch.bfloat16, "cuda")
        pre, cache = model.prefill(params, {"tokens": toks[:, :256]}, cache, force=force)
        dec, _ = model.decode_step(params, cache, toks[:, 256:], force=force)
        results[force] = (pre.float(), dec.float())
    torch.cuda.synchronize()
    for i, what in enumerate(("prefill (256 tokens, K1)", "decode (K2)")):
        a, b = results[None][i], results["plain"][i]
        if tuple(a.shape) != (1, vocab) or not torch.isfinite(a).all():
            raise AssertionError(f"model {what}: logits {tuple(a.shape)} not finite "
                                 f"or of the wrong shape")
        rel = float((a - b).abs().max() / b.abs().max())
        log(f"model {what}: max relative error kernels vs plain {rel:.3e} "
            f"(argmax {int(a.argmax())} vs {int(b.argmax())})")
        if rel > 5e-2:
            raise AssertionError(f"model {what}: kernels and plain differ by {rel}")


def check_mamba(model, params, cfg):
    """K3 inside the full model: logits after a 256-token prefill (two full
    chunks), a ragged 379-token chunk from the carried state, and a decode.

    In fp32 (the bf16 weights widened, so nothing else in the model rounds)
    the logits with K3 must equal those with the plain scan to 2e-3, the
    repo's logit tolerance (``tests/test_models_smoke.py``).  In bf16, the
    served type, each layer rounds the scan's output to bf16, so fp32
    differences of ~1e-6 between two orders of summation flip roundings that
    48 layers carry on, and K3 and the plain scan differ by several percent
    (measured on the H100).  So the bf16 logits are held against the fp32
    model's: K3's distance from them must be at most twice the larger
    distance of two plain versions, the plain scan in chunks of 128 (the
    config's) and of 64."""
    import dataclasses

    from repro_torch.models.transformer import build_model
    gen = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (1, 636), generator=gen, device="cuda")
    what = ("prefill (256 tokens, K3)",
            "ragged prefill (379 tokens from the carried state, K3)",
            "decode (plain SSD step)")
    reblocked = build_model(cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk_size=64)))

    def run(m, p, dtype, force):
        cache = m.init_cache(1, 2048, dtype, "cuda")
        a, cache = m.prefill(p, {"tokens": toks[:, :256]}, cache, force=force)
        b, cache = m.prefill(p, {"tokens": toks[:, 256:635]}, cache, force=force)
        c, _ = m.decode_step(p, cache, toks[:, 635:], force=force)
        return [t.float() for t in (a, b, c)]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    params32 = _widen(params)
    k32, p32 = run(model, params32, torch.float32, None), run(model, params32, torch.float32,
                                                              "plain")
    del params32
    k16, p16 = run(model, params, torch.bfloat16, None), run(model, params, torch.bfloat16,
                                                             "plain")
    r16 = run(reblocked, params, torch.bfloat16, "plain")
    torch.cuda.synchronize()
    for i, w in enumerate(what):
        for a in (k32[i], k16[i]):
            if tuple(a.shape) != (1, cfg.vocab_size) or not torch.isfinite(a).all():
                raise AssertionError(f"mamba2 {w}: logits {tuple(a.shape)} not finite "
                                     f"or of the wrong shape")
        e32, e16 = rel(k32[i], p32[i]), rel(k16[i], p16[i])
        ek, ep, er = rel(k16[i], p32[i]), rel(p16[i], p32[i]), rel(r16[i], p32[i])
        log(f"mamba2 {w}: max relative error K3 vs plain {e32:.3e} in fp32 "
            f"(argmax {int(k32[i].argmax())} vs {int(p32[i].argmax())}), {e16:.3e} in bf16 "
            f"(argmax {int(k16[i].argmax())} vs {int(p16[i].argmax())}); bf16 against "
            f"the fp32 model: K3 {ek:.3e}, plain {ep:.3e}, plain in chunks of 64 {er:.3e}")
        if e32 > 2e-3:
            raise AssertionError(f"mamba2 {w}: K3 and plain differ by {e32} in fp32")
        if ek > 2 * max(ep, er):
            raise AssertionError(f"mamba2 {w}: in bf16 K3 is {ek} from the fp32 model, "
                                 f"the plain scan {max(ep, er)}")


# -------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.serve import engine_config, make_requests

    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== 1. probe")
    smi = probe()

    log("== 2. build")
    secs = _build.build()
    log(f"built {list(_build.KERNELS)} in {secs:.2f} s into {_build.build_dir()}")
    for name, out in _build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    resources = new_kernel_resources()

    log("== 3. kernels against their plain versions")
    check_flash_grid(ops)
    check_paged_grid(ops)
    check_ssd_grid(ops)
    kernels = [measure_flash(ops), measure_paged(ops), measure_ssd(ops)]
    kernels[1]["windowed"] = measure_paged_window(ops)
    kernels[0]["shapes"] = measure_flash_new_shapes(ops)
    kernels[0]["training"] = measure_flash_training(ops)
    kernels[1]["d256"] = measure_paged_d256(ops)
    log("== 3 (deferred append). K1 with q_offset and its lse, K2 with its lse")
    check_lse_grid(ops, torch.Generator(device="cuda").manual_seed(20))
    kernels[0]["cache_segment"], kernels[1]["lse"] = measure_defer_segments(ops)
    log("== 3e. K1's gradient kernel against autograd through the plain version")
    check_flash_bwd_grid(ops)
    kernels.insert(1, measure_flash_bwd(ops))
    kernels[1]["ptxas"] = resources      # K1's fp32 kernel and K1-bwd's, every D and type
    log("== 3f. K3's gradient kernel against the plain decomposition and autograd")
    check_ssd_bwd_grid(ops)
    kernels.append(measure_ssd_bwd(ops))
    if "--kernels-only" in sys.argv[1:]:
        log(f"--kernels-only: stopping after phase 3f, {time.monotonic() - t_start:.1f} s")
        return 0
    launches = collections.Counter()      # summed over every serving path

    log("== 4. llama3_8b, full width and depth, bf16, random weights (seed 0)")
    cfg, model, params = build_full("llama3_8b")
    check_model(model, params, cfg.vocab_size)
    log("== 4b. llama3_8b with kv_append='defer' against the inline append")
    deferred = check_defer_model(cfg, model, params, name="llama3_8b", prompt=1024, chunk=512,
                                 cache=2048, decodes=4, seed=22)
    log("== 5. serving llama3_8b through build_stack(mode='real')")
    launches.update(serve_path(ops, cfg, model, params, ("flash_attention", "paged_attention")))
    log("== 5b. serving llama3_8b with kv_append='defer', beside the inline append")
    launches.update(serve_deferred(cfg, model, params, deferred))
    log("== 6. where the device time goes: the same serving run under torch.profiler")
    serve_path(ops, cfg, model, params, (), profile=True)
    log("== 6b. llama3_8b real against time-warp emulation of the same engine")
    real_against_emulated(cfg, model, params)
    log("== 6c. llama3_8b prefix-cache hits: 8 requests sharing a 1024-token prefix")
    launches.update(serve_prefix_hits(cfg, model, params))
    log("== 6d. llama3_8b preemption: the smoke traffic in a block pool too small for it")
    launches.update(serve_preempted(cfg, model, params, ("flash_attention", "paged_attention")))
    del model, params
    torch.cuda.empty_cache()
    log("== 6e. the serve CLI in real mode: qwen2_5_3b, 8 requests sharing a 512-token prefix")
    launches.update(serve_cli_prefix())
    torch.cuda.empty_cache()
    log("== 6f. fig6's accuracy run: qwen2_5_3b served real twice and emulated once, "
        "30 requests")
    launches.update(fig6_accuracy())
    torch.cuda.empty_cache()

    log("== 7. mamba2_370m, full width and depth, bf16, random weights (seed 0)")
    cfg, model, params = build_full("mamba2_370m")
    check_mamba(model, params, cfg)
    log("== 8. serving mamba2_370m through build_stack(mode='real')")
    launches.update(serve_path(ops, cfg, model, params, ("ssd_scan",)))
    log("== 9. where the device time goes: the same serving run under torch.profiler")
    serve_path(ops, cfg, model, params, (), profile=True)
    log("== 9b. mamba2_370m preemption, in fp32: the smoke traffic in a block pool too "
        "small for it")
    launches.update(serve_preempted(cfg, model, params, ("ssd_scan",), dtype=torch.float32))
    del model, params
    torch.cuda.empty_cache()

    log("== 10. qwen3_30b_a3b, full width and depth, bf16, random weights (seed 0)")
    cfg, model, params = build_full("qwen3_30b_a3b", expect=30_532_110_336)
    check_model(model, params, cfg.vocab_size)
    check_moe_grouped(cfg, params)
    log("== 11. serving qwen3_30b_a3b through build_stack(mode='real')")
    launches.update(serve_path(ops, cfg, model, params, ("flash_attention", "paged_attention")))
    log("== 12. where the device time goes: the same serving run under torch.profiler")
    serve_path(ops, cfg, model, params, (), profile=True)
    del model, params
    torch.cuda.empty_cache()

    log("== 13. mixtral_8x7b at full width, 16 of its 32 layers, bf16, random weights")
    cfg, model, params = build_full("mixtral_8x7b", layers=16, expect=23_482_470_400)
    check_window_model(cfg, model, params)
    log("== 14. serving one 6144-token prompt past mixtral's 4096-token window")
    launches.update(serve_window(ops, cfg, model, params))
    del model, params
    torch.cuda.empty_cache()

    log("== 15. recurrentgemma_2b, full size, bf16, random weights (seed 0)")
    cfg, model, params = build_full("recurrentgemma_2b", expect=2_894_435_840)
    check_window_model(cfg, model, params, name="recurrentgemma", prompt=3072, chunk=1024,
                       cache=4096, seed=13)
    time_rglru(cfg, params)
    log("== 15b. recurrentgemma_2b with kv_append='defer' against the inline append")
    check_defer_model(cfg, model, params, name="recurrentgemma_2b", prompt=3072, chunk=1024,
                      cache=4096, decodes=1, seed=23)
    log("== 16. serving recurrentgemma_2b: 4 prompts of 3072 tokens, past its window")
    long_cfg = engine_config(max_num_seqs=4, max_len=4096)
    launches.update(serve_path(ops, cfg, model, params, ("flash_attention", "paged_attention"),
                               reqs=make_requests(4, 3072, 3072, 32, cfg.vocab_size, seed=0),
                               engine_cfg=long_cfg, max_len=4096, slot_bytes=True))
    log("== 17. where the device time goes: the same serving run under torch.profiler")
    serve_path(ops, cfg, model, params, (), profile=True,
               reqs=make_requests(4, 3072, 3072, 32, cfg.vocab_size, seed=0),
               engine_cfg=long_cfg, max_len=4096, ranges=("rglru_scan",))
    del model, params
    torch.cuda.empty_cache()

    log("== 18. whisper_base, full size, bf16, random weights (seed 0)")
    cfg, model, params = build_full("whisper_base", expect=87_405_056)
    check_whisper(cfg, model, params)
    log("== 19. serving whisper_base: 8 text requests, no frames (as the reference)")
    launches.update(serve_path(ops, cfg, model, params, ("flash_attention", "paged_attention"),
                               reqs=make_requests(8, 16, 256, 32, cfg.vocab_size, seed=0),
                               engine_cfg=engine_config(max_num_seqs=8, max_len=512),
                               max_len=512, noncausal=True))
    del model, params
    torch.cuda.empty_cache()

    log("== 20. the distributed control plane: compare distributed_parity on the thread, "
        "process and DES backends")
    control_plane()

    log("== 21. training qwen2_5_3b at full size in fp32 through K1 and K1-bwd")
    launches.update(train_qwen(ops))
    torch.cuda.empty_cache()
    log("== 21b. restart on the card: qwen2_5_3b at full width, 2 layers, bit for bit")
    restart_qwen()
    torch.cuda.empty_cache()
    log("== 22. training mamba2_370m at full size in fp32 through K3 and K3-bwd")
    launches.update(train_mamba(ops))
    torch.cuda.empty_cache()
    log("== 23. expert parallelism: qwen3_30b_a3b through moe_a2a on 2 ranks sharing this card")
    launches.update(expert_parallel())
    torch.cuda.empty_cache()
    log("== 24. the dry-run's per-device bytes against the card's allocation")
    dry_run_bytes()
    log("== 25. llama3_70b tensor-parallel: 4 ranks sharing this card through gloo")
    launches.update(tensor_parallel(25))
    torch.cuda.empty_cache()
    log("== 26. qwen2_5_3b tensor-parallel, its KV heads on head_dim: 4 ranks on this card")
    launches.update(tensor_parallel(26))
    torch.cuda.empty_cache()
    log("== 27. recurrentgemma_2b tensor-parallel past its window: 2 ranks on this card")
    launches.update(tensor_parallel(27))
    torch.cuda.empty_cache()
    log("== 28. whisper_base tensor-parallel with frames: 2 ranks on this card")
    launches.update(tensor_parallel(28))
    torch.cuda.empty_cache()
    log("== 29. mamba2_370m tensor-parallel in fp32, K3 on each rank's heads: 4 ranks on "
        "this card")
    launches.update(tensor_parallel(29))
    torch.cuda.empty_cache()
    log("== 30. mixtral_8x7b tensor-parallel, its experts on their FFN width: 16 ranks on "
        "this card")
    launches.update(tensor_parallel(30))
    torch.cuda.empty_cache()
    log("== 31. qwen2_5_3b trained on a (2, 2) mesh: FSDP over 'data', Megatron over 'model', "
        "K1 and K1-bwd on every rank")
    launches.update(train_mesh(31))
    torch.cuda.empty_cache()
    log("== 32. mamba2_370m trained on a (2, 2) mesh: K3 and K3-bwd on each rank's 16 of 32 "
        "heads")
    launches.update(train_mesh(32))
    torch.cuda.empty_cache()
    log("== 33. mixtral_8x7b served on a (2, 2) mesh, long_500k's placement: K2 on each "
        "rank's block of the ring, merged over 'data'; the experts' d over 'data'")
    launches.update(tensor_parallel(33, SERVE_MESH))
    torch.cuda.empty_cache()
    log("== 34. qwen3_30b_a3b served on a (2, 2) mesh, decode_32k's placement: rows over "
        "'data', the experts' d over 'data'")
    launches.update(tensor_parallel(34, SERVE_MESH))
    torch.cuda.empty_cache()
    log("== 35. recurrentgemma_2b served on a (2, 2) mesh, long_500k's placement: its ring "
        "over 'data', its KV head on head_dim over 'model'")
    launches.update(tensor_parallel(35, SERVE_MESH))
    torch.cuda.empty_cache()
    log("== 36. qwen2_5_3b served under kv_seq_shard on a (1, 4) mesh: each rank the slots of "
        "both KV heads, K2 over its block for every query head, merged over 'model'")
    launches.update(tensor_parallel(36, SERVE_MESH))
    seq_shard_against_head_dim()
    torch.cuda.empty_cache()
    log("== 37. context parallelism under the deferred append and over frames: recurrentgemma_2b "
        "with kv_defer_append on a (2, 1) mesh, whisper_base's cross cache on (4, 1)")
    launches.update(tensor_parallel("37a", SERVE_MESH))
    torch.cuda.empty_cache()
    launches.update(tensor_parallel("37b", SERVE_MESH))
    frame_pad("37b")
    torch.cuda.empty_cache()
    log("== 38. qwen2_5_3b trained on a ('pod', 'data', 'model') mesh of (2, 1, 2): FSDP over "
        "('pod', 'data'), K1 and K1-bwd on every rank")
    launches.update(train_mesh(38))
    torch.cuda.empty_cache()
    log("== 39. whisper_base trained on a (2, 2) mesh with 1500 frames a row: the encoder, "
        "decoder and cross attention through K1 and K1-bwd on every rank")
    launches.update(train_mesh(39))
    torch.cuda.empty_cache()

    for k in kernels:
        k["launches"] = launches[k["name"]]
        library = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        log(f"kernel {k['name']}: {k['ms']:.4f} ms a call ({k['graph_ms']:.4f} in a CUDA "
            f"graph), {k['launches']} launches on its "
            f"serving and training paths, bound {k['bound_ms']:.5f} ms by {k['bound_by']}, plain "
            f"{k['plain_ms']:.4f} ms, library {library}, max abs err {k['max_abs_err']:.3e}")
    log(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"census": CENSUS}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def build_full(arch, layers=None, expect=None):
    """``arch`` at full width in bf16 on the card, at full depth or cut to
    ``layers``, random weights from seed 0; its parameter count must equal
    the config's, and ``expect`` where given."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import build_model
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers, layer_pattern=None)
    model = build_model(cfg)
    t0 = time.monotonic()
    before = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    torch.cuda.synchronize()
    BUILT_BYTES[arch if layers is None else f"{arch}/{layers}"] = (
        torch.cuda.memory_allocated() - before, _shapes(params))
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"initialised {n_params:,} parameters (config says {cfg.param_count():,}) "
        f"in {time.monotonic() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "allocated")
    if n_params != cfg.param_count() or n_params != (expect or n_params):
        raise AssertionError(f"parameter count {n_params} disagrees with the config "
                             f"({cfg.param_count()}) or the expected {expect}")
    return cfg, model, params


def serve_path(ops, cfg, model, params, path_kernels, profile=False, *, reqs=None,
               engine_cfg=None, max_len=2048, ranges=(), noncausal=False, slot_bytes=False):
    """Serve the smoke traffic (8 requests at once, prompts uniform in
    128-1024 from numpy seed 0, 32 new tokens each; vllm policy, 512-token
    step budget, 8 slots, no prefix caching), or ``reqs`` on ``engine_cfg``,
    through ``build_stack(mode="real")``.  The launch counts are set to 0
    just before the run and read just after; every kernel in
    ``path_kernels`` must have launched, and K1 in every attention layer of
    every prefill chunk.  Returns those kernels' counts.  With ``profile``,
    runs under torch.profiler, with the layer functions named in ``ranges``
    as ranges of their own.  With ``noncausal``, K1 must also have run
    without the causal mask (an enc-dec decoder's cross-attention).  With
    ``slot_bytes``, logs the bytes a slot's attention cache holds
    (:func:`log_slot_bytes`)."""
    from repro_torch.launch.serve import engine_config, make_requests, run_requests
    from repro_torch.serving.stack import build_stack
    engine_cfg = engine_cfg or engine_config()
    stack = build_stack(cfg, engine_cfg, "real", model=model, params=params,
                        max_len=max_len, device="cuda", dtype=torch.bfloat16)
    if reqs is None:
        reqs = make_requests(SERVING["num"], SERVING["prompt_min"], SERVING["prompt_max"],
                             SERVING["new_tokens"], cfg.vocab_size, seed=SERVING["seed"])
    new_tokens = [r.max_new_tokens for r in reqs]
    if slot_bytes:
        log_slot_bytes(cfg, stack.runner, max_len)
    if profile:
        profile_serving(lambda: serve_inline(stack, reqs),
                        ranges=ranges or (("moe",) if cfg.moe is not None else ()))
        return {}
    log(f"prompt lengths {[r.prompt_len for r in reqs]}")
    with recording() as rec:
        ops.reset_launch_counts()
        summary = run_requests(stack, reqs, timeout=600)
        counts = ops.launch_counts()
    n_attn = sum(kind in ("attn", "local_attn") for kind in cfg.layer_pattern)
    if rec.flash:
        log(f"K1 launches by (B, T, S, window, causal, q_offset): {sorted(rec.flash.items(), key=str)}")
        if (sum(rec.flash.values()) != counts["flash_attention"]
                or any(n % n_attn for n in rec.flash.values())):
            raise AssertionError(f"K1 did not run in every layer of every prefill chunk: "
                                 f"{dict(rec.flash)} over {n_attn} attention layers")
    if noncausal and not any(not causal for (*_, causal, _) in rec.flash):
        raise AssertionError(f"K1 never ran without the causal mask: {dict(rec.flash)}")
    steps = summary["steps"]
    log("serving: " + json.dumps(summary))
    log(f"launches during serving: {counts} over {steps} steps ("
        + ", ".join(f"{name} {counts[name] / steps:.2f}" for name in path_kernels)
        + " per step)")
    for r, n in zip(reqs, new_tokens):
        if (r.num_generated != n
                or not all(0 <= t < cfg.vocab_size for t in r.output_tokens)):
            raise AssertionError(f"request {r.request_id} produced {r.num_generated} tokens")
    if summary["finished"] != len(reqs):
        raise AssertionError(f"{summary['finished']} of {len(reqs)} requests finished")
    for name in path_kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the serving path")
    return {name: counts[name] for name in path_kernels}


def serve_inline(stack, reqs) -> None:
    """Serve ``reqs``, all arriving at once, by stepping the engine in the
    calling thread until every one has finished, then shut the stack down.
    The profiled runs use it: torch.profiler records operators and their
    ``record_function`` ranges only in the thread that started it, and the
    engine's own loop runs in a thread of its own."""
    engine = stack.engine
    try:
        now = stack.clock.now()
        for r in reqs:
            r.arrival_time = now
            engine.scheduler.add_request(r)
        while not all(r.finished for r in reqs):
            engine.step()
    finally:
        stack.shutdown()


@contextlib.contextmanager
def recording():
    """Counters of the (B, T, S, window, causal, q_offset) of every K1
    launch (``rec.flash``) and of the window of every K2 launch
    (``rec.paged``) while the block runs, taken from shapes and Python
    arguments (no device value is read)."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import paged_attention as paged_mod
    rec = types.SimpleNamespace(flash=collections.Counter(), paged=collections.Counter())
    flash, paged = flash_mod.flash_attention, paged_mod.paged_attention

    def record_flash(q, k, v, **kw):
        rec.flash[(q.shape[0], q.shape[1], k.shape[1], kw.get("window"),
                   kw.get("causal", True), kw.get("q_offset"))] += 1
        return flash(q, k, v, **kw)

    def record_paged(*args, **kw):
        rec.paged[kw.get("window")] += 1
        return paged(*args, **kw)

    flash_mod.flash_attention, paged_mod.paged_attention = record_flash, record_paged
    try:
        yield rec
    finally:
        flash_mod.flash_attention, paged_mod.paged_attention = flash, paged


def serve_window(ops, cfg, model, params):
    """Phase 14: one request of 6144 prompt tokens and 64 new ones through
    ``build_stack(mode="real")`` in one slot of 8192 positions, a ring of
    4096 (512-token chunks).  K1 must have run the ring's earlier keys with
    ``q_offset`` and the window (the chunks past the ring's end) and K2
    every decode with the window; returns the launch counts."""
    from repro_torch.launch.serve import engine_config, make_requests, run_requests
    from repro_torch.serving.stack import build_stack
    window, prompt, new = cfg.sliding_window, 6144, 64
    stack = build_stack(cfg, engine_config(max_num_seqs=1, max_len=8192), "real",
                        model=model, params=params, max_len=8192, device="cuda",
                        dtype=torch.bfloat16)
    log_slot_bytes(cfg, stack.runner, 8192)
    reqs = make_requests(1, prompt, prompt, new, cfg.vocab_size, seed=SERVING["seed"])
    with recording() as rec:
        ops.reset_launch_counts()
        summary = run_requests(stack, reqs, timeout=600)
        counts = ops.launch_counts()
    log("serving: " + json.dumps(summary))
    log(f"K1 launches by (B, T, S, window, causal, q_offset): {sorted(rec.flash.items(), key=str)}")
    log(f"K2 launches by window: {dict(rec.paged)}; launches {counts} over "
        f"{summary['steps']} steps")
    req = reqs[0]
    if req.num_generated != new or summary["finished"] != 1:
        raise AssertionError(f"the request produced {req.num_generated} tokens")
    if not any(off is not None and w == window for (_, _, _, w, _, off) in rec.flash):
        raise AssertionError(f"K1 never ran the ring's earlier keys with q_offset and the "
                             f"window {window}: {dict(rec.flash)}")
    n_attn = sum(kind in ("attn", "local_attn") for kind in cfg.layer_pattern)
    if counts["paged_attention"] != (new - 1) * n_attn:
        raise AssertionError(f"K2 ran {counts['paged_attention']} times for {new - 1} decodes "
                             f"of {n_attn} attention layers")
    if set(rec.paged) != {window}:
        raise AssertionError(f"K2 ran without the window: {dict(rec.paged)}")
    return {name: counts[name] for name in ("flash_attention", "paged_attention")}


def log_slot_bytes(cfg, runner, max_len):
    """Log the bytes one slot of ``runner``'s cache holds in its attention
    layers (K, V and positions), and what a linear row of ``max_len``
    positions, the port's cache before the ring, held."""
    from repro_torch.launch.mesh import leaves_with_names
    ring = linear = 0
    for name, leaf in leaves_with_names(runner.cache["layers"]):
        if name.rsplit("/", 1)[-1] in ("k", "v", "kv_pos"):
            row = leaf.numel() // runner.max_seqs * leaf.element_size()
            ring += row
            linear += row // leaf.shape[-3 if leaf.dim() >= 4 else -1] * max_len
    log(f"slot bytes in the attention layers: {ring:,} ({ring / 2**30:.3f} GiB) on the ring; "
        f"a linear row of {max_len} positions held {linear:,} ({linear / 2**30:.3f} GiB)")


def check_window_model(cfg, model, params, *, name="mixtral", prompt=6144, chunk=2048,
                       cache=8192, seed=9):
    """Phase 13 (and 15): logits of a ``prompt``-token prefill in chunks of
    ``chunk`` (the last one's keys past the window) and of a decode at
    position ``prompt``, with K1 and K2 against the plain attention, in
    relative terms as :func:`check_model`; beside them, how far the same
    weights without the window are, to show that the window shaped the
    result."""
    from repro_torch.models.transformer import build_model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt + 1), generator=gen, device="cuda")
    unwindowed = build_model(cfg.replace(sliding_window=None))
    window = cfg.sliding_window

    def run(m, force):
        c = m.init_cache(1, cache, torch.bfloat16, "cuda")
        for a in range(0, prompt, chunk):
            pre, c = m.prefill(params, {"tokens": toks[:, a:a + chunk]}, c, force=force)
        dec, _ = m.decode_step(params, c, toks[:, prompt:], force=force)
        return pre.float(), dec.float()

    with recording() as rec:
        kern = run(model, None)
    plain, wide = run(model, "plain"), run(unwindowed, None)
    torch.cuda.synchronize()
    log(f"K1 launches by (B, T, S, window, causal, q_offset): {sorted(rec.flash.items(), key=str)}; K2 by "
        f"window: {dict(rec.paged)}")
    for i, what in enumerate((f"prefill to position {prompt - 1} (K1, window {window})",
                              f"decode at position {prompt} (K2, window {window})")):
        a, b, c = kern[i], plain[i], wide[i]
        if tuple(a.shape) != (1, cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"{name} {what}: logits not finite or of the wrong shape")
        rel = float((a - b).abs().max() / b.abs().max())
        rel_wide = float((c - b).abs().max() / b.abs().max())
        log(f"{name} {what}: max relative error kernels vs plain {rel:.3e} (argmax "
            f"{int(a.argmax())} vs {int(b.argmax())}); without the window {rel_wide:.3e}")
        if rel > 5e-2:
            raise AssertionError(f"{name} {what}: kernels and plain differ by {rel}")


def serve_runs(cfg, model, params, engine_cfg, waves, max_len=2048, dtype=torch.bfloat16):
    """Serve ``waves`` of requests through ``build_stack(mode="real")`` (the
    slot cache in ``dtype``), each
    wave arriving when the one before has finished, the engine stepped in
    this thread, the logits of every produced token kept
    (``runner.logits``).  The launch counts are set to 0 just before and
    read just after.  Returns (stack, counts, wall seconds)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.stack import build_stack
    stack = build_stack(cfg, engine_cfg, "real", model=model, params=params, max_len=max_len,
                        device="cuda", dtype=dtype)
    stack.runner.logits = {}
    engine = stack.engine
    try:
        ops.reset_launch_counts()
        t0 = time.monotonic()
        for wave in waves:
            now = stack.clock.now()
            for r in wave:
                r.arrival_time = now
                engine.scheduler.add_request(r)
            while not all(r.finished for r in wave):
                engine.step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = ops.launch_counts()
    finally:
        stack.shutdown()
    return stack, counts, wall


def compare_runs(what, got, got_logits, ref, ref_logits, vocab):
    """Every request of ``got`` must produce the tokens of its twin in
    ``ref``, or, from the first token where bf16 rounding of a differently
    chunked prefill makes them part, that step's logits must lie within
    the relative 5e-2 of the model checks; each parting is logged."""
    parted = []
    for i, (a, b) in enumerate(zip(got, ref)):
        if (a.num_generated != a.max_new_tokens
                or not all(0 <= t < vocab for t in a.output_tokens)):
            raise AssertionError(f"{what}: request {i} produced {a.num_generated} tokens")
        if a.output_tokens == b.output_tokens:
            continue
        j = next(n for n, (x, y) in enumerate(zip(a.output_tokens, b.output_tokens)) if x != y)
        la = got_logits[a.request_id][j].float()
        lb = ref_logits[b.request_id][j].float()
        rel = float((la - lb).abs().max() / lb.abs().max())
        log(f"{what}: request {i} parts at token {j} ({a.output_tokens[j]} against "
            f"{b.output_tokens[j]}); that step's logits differ by {rel:.3e} relative")
        if rel > 5e-2:
            raise AssertionError(f"{what}: request {i}'s logits at token {j} differ by {rel}")
        parted.append(i)
    log(f"{what}: {len(got) - len(parted)} of {len(got)} requests give the same tokens; "
        f"{len(parted)} part, within 5e-2 where they do")


def check_defer_model(cfg, model, params, *, name, prompt, chunk, cache, decodes, seed):
    """Phases 4b and 15b: ``kv_append="defer"`` against the inline append on
    the same weights: the logits of a ``prompt``-token prefill in chunks of
    ``chunk`` (every chunk's) and of ``decodes`` decodes after it, relative
    5e-2 as :func:`check_model`, and the caches after the last write.  On the
    defer path K1 runs twice a layer for every chunk after the first (the
    cached keys with ``q_offset``, then the chunk's own) and K2 once a layer
    a decode (the cached keys; the new token's own is merged on the host
    side of the kernels); the counts are set to 0 just before that run and
    read just after."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import build_model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt + decodes), generator=gen, device="cuda")
    deferred = build_model(cfg.replace(kv_append="defer"))

    def run(m):
        c = m.init_cache(1, cache, torch.bfloat16, "cuda")
        out = []
        for a in range(0, prompt, chunk):
            logits, c = m.prefill(params, {"tokens": toks[:, a:a + chunk]}, c)
            out.append(logits.float())
        for t in range(prompt, prompt + decodes):
            logits, c = m.decode_step(params, c, toks[:, t:t + 1])
            out.append(logits.float())
        return out, c

    with recording() as rec:
        ops.reset_launch_counts()
        got, got_cache = run(deferred)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    exp, exp_cache = run(model)
    torch.cuda.synchronize()
    n_attn = sum(kind in ("attn", "local_attn") for kind in cfg.layer_pattern)
    chunks = -(-prompt // chunk)
    log(f"{name} defer: K1 launches by (B, T, S, window, causal, q_offset): {sorted(rec.flash.items(), key=str)}; "
        f"{counts['flash_attention'] / n_attn:.0f} a layer over {chunks} chunks, "
        f"K2 {counts['paged_attention'] / n_attn:.0f} a layer over {decodes} decodes")
    want = {"flash_attention": n_attn * (2 * chunks - 1),
            "paged_attention": n_attn * decodes if cfg.sliding_window != 1 else 0}
    for kernel, n in want.items():
        if counts[kernel] != n:
            raise AssertionError(f"{name} defer: {kernel} launched {counts[kernel]} times, "
                                 f"not {n}")
    steps = [f"prefill chunk {i} ({min(chunk, prompt - i * chunk)} tokens at {i * chunk})"
             for i in range(chunks)] + [f"decode at {t}" for t in range(prompt, prompt + decodes)]
    for what, a, b in zip(steps, got, exp):
        if tuple(a.shape) != (1, cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"{name} defer {what}: logits not finite or of the wrong shape")
        rel = float((a - b).abs().max() / b.abs().max())
        log(f"{name} {what}: max relative error defer vs inline {rel:.3e} "
            f"(argmax {int(a.argmax())} vs {int(b.argmax())})")
        if rel > 5e-2:
            raise AssertionError(f"{name} defer {what}: defer and inline differ by {rel}")
    worst = 0.0
    for a, b in zip(_leaves(got_cache), _leaves(exp_cache)):
        if a.dtype.is_floating_point:
            worst = max(worst, float((a.float() - b.float()).abs().max() / b.float().abs().max()))
        elif not torch.equal(a, b):
            raise AssertionError(f"{name} defer: positions or lengths differ after the write")
    log(f"{name} defer: caches after the deferred write within {worst:.3e} relative of "
        "the inline caches; positions and lengths equal")
    if worst > 5e-2:
        raise AssertionError(f"{name} defer: the caches differ by {worst}")
    return deferred


def device_ms(serve) -> float:
    """Device time of every kernel over one ``serve()`` call (torch.profiler,
    the device only)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve()
        torch.cuda.synchronize()
    return sum(ns for _, _, ns in device_events(prof.profiler.kineto_results.events())) / 1e6


def serve_deferred(cfg, model, params, deferred):
    """Phase 5b: phase 5's traffic (8 requests, 32 new tokens each) through
    ``build_stack(mode="real")`` with ``kv_append="defer"`` and, beside it on
    the same weights, with the inline append of phase 5, each run stepped in
    this thread with its tokens' logits kept.  K1 and K2 must have run on the
    defer path (counts set to 0 just before and read just after), in every
    attention layer of every chunk; the tokens must equal the inline run's
    or, where they part, lie within 5e-2 there (:func:`compare_runs`).  Wall
    times come from those runs, device times from a second run of each under
    torch.profiler.  Returns the defer run's K1 and K2 launches."""
    from repro_torch.launch.serve import engine_config, make_requests

    def reqs():
        return make_requests(SERVING["num"], SERVING["prompt_min"], SERVING["prompt_max"],
                             SERVING["new_tokens"], cfg.vocab_size, seed=SERVING["seed"])

    runs = {}
    for mode, c, m in (("defer", cfg.replace(kv_append="defer"), deferred),
                       ("inline", cfg, model)):
        rs = reqs()
        with recording() as rec:
            stack, counts, wall = serve_runs(c, m, params, engine_config(), [rs])
        dev = device_ms(lambda: serve_runs(c, m, params, engine_config(), [reqs()]))
        runs[mode] = (rs, stack, counts, wall, dev, rec)
        log(f"serving with kv_append={mode!r}: wall {wall:.3f} s, device {dev:.1f} ms "
            f"({len(stack.engine.step_log)} steps); launches {counts}")
    rs, stack, counts, wall, dev, rec = runs["defer"]
    n_attn = sum(kind in ("attn", "local_attn") for kind in cfg.layer_pattern)
    log(f"defer: K1 launches by (B, T, S, window, causal, q_offset): {sorted(rec.flash.items(), key=str)}")
    if any(n % n_attn for n in rec.flash.values()):
        raise AssertionError(f"defer: K1 did not run in every layer: {dict(rec.flash)}")
    for name in ("flash_attention", "paged_attention"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the defer serving path")
    compare_runs("defer against inline", rs, stack.runner.logits, runs["inline"][0],
                 runs["inline"][1].runner.logits, cfg.vocab_size)
    log(f"defer against inline: wall {wall:.3f} s against {runs['inline'][3]:.3f} s, device "
        f"{dev:.1f} ms against {runs['inline'][4]:.1f} ms")
    return {name: counts[name] for name in ("flash_attention", "paged_attention")}


def control_plane():
    """Phase 20: the distributed control plane on the card's host, no card:
    ``repro_torch.scenario.compare`` of the ``distributed_parity`` preset on
    the thread, process (shared memory and TCP) and DES backends, which
    raises ``ParityError`` unless the reference's parity bar holds.  It must
    launch no kernel and leave the allocated device memory as it was.

    The process backend spawns its replicas, and a spawned process runs the
    parent's main module again unless it has no file: this script, which
    imports torch.  So the script's ``__file__`` is hidden from
    ``multiprocessing`` while the replicas start, and they import only
    ``repro_torch``'s control plane, as under ``python -m
    repro_torch.scenario``."""
    from repro_torch.kernels import ops
    from repro_torch.scenario import compare, get_preset
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    main = sys.modules["__main__"]
    main_file = main.__dict__.pop("__file__", None)
    t0 = time.monotonic()
    try:
        res = compare(get_preset("distributed_parity"),
                      backends=("thread", "process-shm", "process-tcp", "des"), timeout=300)
    finally:
        if main_file is not None:
            main.__file__ = main_file
    wall = time.monotonic() - t0
    counts = ops.launch_counts()
    for backend, r in res.results.items():
        log(f"distributed_parity on {backend}: {r.num_requests} requests, virtual makespan "
            f"{r.makespan_virtual} s, wall {r.wall_seconds} s")
    log(f"compare passed in {wall:.2f} s: max TTFT error {res.max_ttft_err_s} s, TPOT "
        f"{res.max_tpot_err_s} s against a slow step of {res.slow_step_s} s; launches {counts}")
    if any(counts.values()) or torch.cuda.memory_allocated() != before:
        raise AssertionError(f"the control plane touched the card: launches {counts}, "
                             f"allocated {before} -> {torch.cuda.memory_allocated()} bytes")


def serve_prefix_hits(cfg, model, params):
    """Phase 6c: 8 requests that share a 1024-token prefix (suffixes of
    64-320 random tokens, 32 new tokens each, torch seed 14): the first one
    is served alone, the other 7 arrive when it has finished, with prefix
    caching on (the runner keeps the cached blocks' KV, 1024 blocks of 16
    positions) and then off.  The cached run must hit (the engine's and the
    prefix cache's counters) and give the uncached run's tokens
    (:func:`compare_runs`).  Returns the cached run's K1 and K2 launches."""
    from repro_torch.launch.serve import engine_config
    from repro_torch.serving.request import Request
    gen = torch.Generator().manual_seed(14)
    prefix = torch.randint(0, cfg.vocab_size, (1024,), generator=gen).tolist()
    suffixes = [torch.randint(0, cfg.vocab_size, (int(n),), generator=gen).tolist()
                for n in torch.randint(64, 321, (8,), generator=gen)]
    runs = {}
    for caching in (True, False):
        reqs = [Request(prompt_tokens=prefix + sfx, max_new_tokens=32) for sfx in suffixes]
        ec = dataclasses.replace(engine_config(), enable_prefix_caching=caching)
        runs[caching] = (reqs,) + serve_runs(cfg, model, params, ec, [reqs[:1], reqs[1:]])
    reqs, stack, counts, wall = runs[True]
    pc = stack.engine.prefix_cache.stats
    store = stack.runner._store
    gib = sum(t.numel() * t.element_size() for t in store.values()) / 2**30
    skipped = sum(r.cached_prefix_len for r in reqs)
    log(f"prefix hits: {pc.device_hits} block hits, {pc.hit_tokens} of {pc.query_tokens} "
        f"prompt tokens from the cache (hit rate {stack.engine.stats()['prefix_hit_rate']:.4f}), "
        f"{skipped} prefill tokens skipped, cached_prefix_len "
        f"{[r.cached_prefix_len for r in reqs]}; store {gib:.2f} GiB "
        f"({stack.engine.cfg.num_blocks} blocks of {stack.engine.cfg.block_size}); "
        f"wall {wall:.3f} s against {runs[False][3]:.3f} s uncached; launches {counts}")
    if pc.device_hits <= 0 or skipped < 7 * 1024:
        raise AssertionError(f"the prefix cache served {skipped} tokens, not 7 x 1024")
    compare_runs("prefix hits against caching off", reqs, stack.runner.logits,
                 runs[False][0], runs[False][1].runner.logits, cfg.vocab_size)
    return {name: counts[name] for name in ("flash_attention", "paged_attention")}


def serve_preempted(cfg, model, params, path_kernels, dtype=torch.bfloat16):
    """Phases 6d and 9b: the smoke traffic of phase 5 (8 requests, 32 new
    tokens each) in a block pool of one block a request more than the
    prompts take, while 32 new tokens take two a request, so that the
    decodes run out and the engine preempts; then in phase 5's pool (1024
    blocks).  The tight run must preempt and give the roomy run's tokens
    (:func:`compare_runs`); ``path_kernels`` must have run in it.  Returns
    their launches in the tight run.  ``dtype`` is the type of the weights
    (bf16 ones are widened to fp32) and of the slot cache.

    mamba2_370m runs in fp32, as :func:`check_mamba` holds its logits: in
    bf16 two runs of the same requests whose decodes are batched
    differently part by more than 5e-2 (6.032e-02 at token 28 of a request
    that was never preempted, on an H100; the bf16 model is 20-36% from the
    fp32 one), which says nothing of the replay."""
    from repro_torch.launch.serve import engine_config, make_requests
    if dtype == torch.float32:
        params = _widen(params)
    roomy = engine_config()
    waves = {}
    for name in ("tight", "roomy"):
        reqs = make_requests(SERVING["num"], SERVING["prompt_min"], SERVING["prompt_max"],
                             SERVING["new_tokens"], cfg.vocab_size, seed=SERVING["seed"])
        need = sum(-(-r.prompt_len // roomy.block_size) for r in reqs)
        tight = dataclasses.replace(roomy, num_blocks=need + len(reqs))
        ec = tight if name == "tight" else roomy
        waves[name] = (reqs,) + serve_runs(cfg, model, params, ec, [reqs], dtype=dtype)
    reqs, stack, counts, wall = waves["tight"]
    stats = stack.engine.stats()
    log(f"preemption: {stats['num_preemptions']} preemptions in a pool of "
        f"{stack.engine.cfg.num_blocks} blocks, requests preempted "
        f"{[r.num_preemptions for r in reqs]}; {stats['steps']} steps in {wall:.3f} s "
        f"against {waves['roomy'][1].engine.stats()['steps']} steps in "
        f"{waves['roomy'][3]:.3f} s unpressured; launches {counts}")
    if stats["num_preemptions"] <= 0:
        raise AssertionError("the tight pool preempted nothing")
    for name in path_kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched in the preempted run")
    compare_runs("preempted against unpressured", reqs, stack.runner.logits,
                 waves["roomy"][0], waves["roomy"][1].runner.logits, cfg.vocab_size)
    return {name: counts[name] for name in path_kernels}


def serve_cli_prefix():
    """Phase 6e: ``serve.main`` in real mode at full size, as a user runs
    the CLI: qwen2_5_3b in bf16, 8 requests at 8 a second sharing a
    512-token prefix, prefix caching on.  The stack and the requests are
    kept through stand-ins for the CLI's ``build_stack`` and
    ``synthesize``; the launch counts are set to 0 once the stack is built
    (after the runner's warm-up) and read when the CLI returns.  Every
    request must finish with its ``max_new_tokens`` tokens, the engine's
    prefix cache must hit, and K1 and K2 must run.  Returns their
    launches."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    seen = {}
    build, synthesize = serve.build_stack, serve.synthesize

    def built(*a, **k):
        seen["stack"] = build(*a, **k)
        ops.reset_launch_counts()
        return seen["stack"]

    def synthesized(*a, **k):
        seen["reqs"] = synthesize(*a, **k)
        return seen["reqs"]

    t0 = time.monotonic()
    out = io.StringIO()
    serve.build_stack, serve.synthesize = built, synthesized
    try:
        with contextlib.redirect_stdout(out):
            summary = serve.main(["--arch", "qwen2_5_3b", "--shared-prefix", "512",
                                  "--num-requests", "8", "--qps", "8", "--json"])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        serve.build_stack, serve.synthesize = build, synthesize
    secs = time.monotonic() - t0
    for line in out.getvalue().splitlines():
        log(f"  serve: {line}")
    reqs, engine = seen["reqs"], seen["stack"].engine
    pc = engine.prefix_cache.stats
    short = [(r.request_id, r.num_generated, r.max_new_tokens) for r in reqs
             if not r.finished or r.num_generated != r.max_new_tokens]
    if short or summary["num_requests"] != len(reqs):
        raise AssertionError(f"requests unfinished or short of their tokens: {short}")
    if pc.device_hits <= 0:
        raise AssertionError(f"the CLI's prefix cache never hit: {pc}")
    if counts["flash_attention"] <= 0 or counts["paged_attention"] <= 0:
        raise AssertionError(f"K1 or K2 did not run while the CLI served: {counts}")
    log(f"phase 6e: prefix hits {pc.device_hits} blocks ({pc.hit_tokens} of {pc.query_tokens} "
        f"prompt tokens, cached_prefix_len {[r.cached_prefix_len for r in reqs]}), TTFT p50 "
        f"{summary['ttft_p50_ms']:.3f} ms, {len(reqs)} requests, {secs:.1f} s; launches "
        f"{dict(counts)}")
    return {name: counts[name] for name in ("flash_attention", "paged_attention")}


def fig6_accuracy():
    """Phase 6f: ``fig6_accuracy.measure`` on qwen2_5_3b at full width in
    bf16, as the module's entry point runs each architecture.  It raises
    where a request did not finish with its tokens, a real run launched no
    K1 or no K2, or the emulated run launched a kernel or changed the
    allocated bytes; the errors and the floor are logged, not gated.
    Returns the three real runs' launches of K1 and K2."""
    from repro_torch.launch import fig6_accuracy as fig6
    t0 = time.monotonic()
    facts = {}
    row = fig6.measure("qwen2_5_3b", n=30, device="cuda", dtype=torch.bfloat16, facts=facts)
    log("fig6: " + json.dumps({"row": row, "facts": facts}))
    counts = collections.Counter()
    for key in ("calibration", "real", "real2"):
        counts.update(facts["phases"][key]["launches"])
    log(f"phase 6f: TTFT p50 error {row['ttft_p50_err']:.4f} against a real-vs-real floor of "
        f"{row['real_noise_floor']:.4f}, {facts['requests_parted']} of 30 requests parted "
        f"between the real runs, {time.monotonic() - t0:.1f} s")
    return {name: counts[name] for name in ("flash_attention", "paged_attention")}


def time_rglru(cfg, params):
    """The RG-LRU recurrence of recurrentgemma_2b (``layers.rglru_scan``,
    fp32, width 2560) at a 512-token prefill chunk (the serving chunk), at
    2048 tokens, and a decode step of 4 rows; and layer 0's whole RG-LRU
    mixer (projections, conv, gates, recurrence) at 512 tokens, bf16."""
    from repro_torch.models import layers as L
    gen = torch.Generator(device="cuda").manual_seed(15)
    W = cfg.rglru.lru_width
    for B, T in ((1, 512), (1, 2048), (4, 1)):
        log_a = -0.108 * torch.rand((B, T, W), generator=gen, device="cuda")
        b = torch.randn((B, T, W), generator=gen, device="cuda")
        h0 = torch.randn((B, W), generator=gen, device="cuda")
        ms = time_ms(lambda: L.rglru_scan(log_a, b, h0))
        g_ms = graph_ms(lambda: L.rglru_scan(log_a, b, h0))
        nbytes = 4 * (2 * log_a.numel() + b.numel() + h0.numel())
        log(f"RG-LRU recurrence (B={B}, T={T}, W={W}): {ms:.4f} ms ({g_ms:.4f} in a graph); "
            f"reading its inputs and writing h once would take {nbytes / PEAK_BYTES * 1e3:.5f} ms")
    p = params["blocks"][0]["rglru"]
    x = torch.randn((1, 512, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    layer_ms = time_ms(lambda: L.rglru(cfg, p, x))
    log(f"RG-LRU mixer of layer 0 at a 512-token chunk: {layer_ms:.4f} ms")


def check_whisper(cfg, model, params):
    """Phase 18: ``EncDecLM.prefill`` with 1500 random frame embeddings
    (torch seed 0) and a 64-token prompt, then a decode, with the kernels
    (the encoder and the cross-attention through K1 without the causal
    mask, the decode's cross-attention through K2 over the padded cross
    cache) against the plain attention, in relative terms as
    :func:`check_model`; the encoder alone is timed."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    F = cfg.encoder.max_source_positions
    frames = torch.randn((1, F, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (1, 65), generator=gen, device="cuda")
    results = {}
    for force in (None, "plain"):
        with recording() as rec:
            cache = model.init_cache(1, 512, torch.bfloat16, "cuda")
            pre, cache = model.prefill(params, {"tokens": toks[:, :64], "frontend_embeds": frames},
                                       cache, force=force)
            dec, _ = model.decode_step(params, cache, toks[:, 64:], force=force)
        results[force] = (pre.float(), dec.float())
        if force is None:
            log(f"K1 launches by (B, T, S, window, causal, q_offset): {sorted(rec.flash.items(), key=str)}; "
                f"K2: {dict(rec.paged)}; cross cache {tuple(cache['cross_k'].shape)} for "
                f"{cache['cross_frames']} frames")
            if not any(S == F and not causal for (_, _, S, _, causal, _) in rec.flash):
                raise AssertionError("K1 never ran the encoder or the cross-attention")
    torch.cuda.synchronize()
    for i, what in enumerate(("prefill (encoder over 1500 frames, 64 tokens)",
                              "decode (cross-attention over 1500 frames, K2)")):
        a, b = results[None][i], results["plain"][i]
        if tuple(a.shape) != (1, cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"whisper {what}: logits not finite or of the wrong shape")
        rel = float((a - b).abs().max() / b.abs().max())
        log(f"whisper {what}: max relative error kernels vs plain {rel:.3e} "
            f"(argmax {int(a.argmax())} vs {int(b.argmax())})")
        if rel > 5e-2:
            raise AssertionError(f"whisper {what}: kernels and plain differ by {rel}")
    enc_ms = time_ms(lambda: model.encode(params, frames), iters=5)
    log(f"whisper encoder over {F} frames: {enc_ms:.4f} ms")


def check_moe_grouped(cfg, params):
    """The MoE of layer 0 of qwen3_30b_a3b on a 512-token chunk in bf16: the
    grouped call (``torch._grouped_mm``) against the per-expert loop, for
    the whole layer and for the first product alone (2e-2), and both timed;
    the router's expert loads beside them; four more calls of the layer,
    which must repeat its bits (ROADMAP C1)."""
    from repro_torch.models import layers as L
    p = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    gen = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn((1, 512, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    y, aux = L.moe(cfg, p, x)
    y_loop, _ = L.moe(cfg, p, x, force="plain")
    torch.cuda.synchronize()
    # ROADMAP C1: the combine is a fixed-order sum, so the layer repeats its bits
    same = sum(torch.equal(L.moe(cfg, p, x)[0], y) for _ in range(4))
    log(f"MoE layer 0 repeated 4 times on the same chunk: {same} of 4 bit-identical to the first")
    if same != 4:
        raise AssertionError("the MoE layer does not repeat its bits (ROADMAP C1)")
    err = assert_close("MoE layer 0 grouped vs per-expert loop (1, 512) bfloat16", y, y_loop,
                       "bfloat16")
    _, _, idx = L.moe_route(cfg, p, x.reshape(-1, cfg.d_model))
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    xs = x.reshape(-1, cfg.d_model)[order // cfg.moe.top_k]
    sizes = torch.bincount(flat, minlength=cfg.moe.num_experts).int()
    assert_close("MoE w_in product grouped vs loop bfloat16", L.grouped_mm(xs, p["w_in"], sizes),
                 L.grouped_mm_loop(xs, p["w_in"], sizes), "bfloat16")
    ms = time_ms(lambda: L.grouped_mm(xs, p["w_in"], sizes))
    g_ms = graph_ms(lambda: L.grouped_mm(xs, p["w_in"], sizes))
    loop_ms = time_ms(lambda: L.grouped_mm_loop(xs, p["w_in"], sizes))
    layer_ms = time_ms(lambda: L.moe(cfg, p, x))
    loop_layer_ms = time_ms(lambda: L.moe(cfg, p, x, force="plain"))
    rows, (E, d, n) = xs.shape[0], p["w_in"].shape
    nbytes = 2 * (xs.numel() + rows * n + int((sizes > 0).sum()) * d * n)
    b_ms, b_by = bound(2 * rows * d * n, nbytes, PEAK_BF16_FLOPS)
    load = sizes.tolist()
    log(f"MoE layer 0: {sum(1 for s in load if s == 0)} of {E} experts got no token, the "
        f"largest {max(load)} rows; max abs err {err:.3e}; w_in product grouped "
        f"{ms:.4f} ms ({g_ms:.4f} in a graph), loop {loop_ms:.4f} ms, bound {b_ms:.5f} ms by "
        f"{b_by}; whole layer grouped {layer_ms:.4f} ms, loop {loop_layer_ms:.4f} ms; "
        f"aux loss {float(aux['moe_aux_loss']):.4f}")


def real_against_emulated(cfg, model, params) -> None:
    """Phase 6b: ``real_vs_emulated.run`` on the card, with the facts that
    can fail checked here; the sizes of the errors are printed only."""
    from repro_torch.launch import real_vs_emulated as rve
    t0 = time.monotonic()
    report = rve.run(cfg, model, params, device="cuda", dtype=torch.bfloat16,
                     timeout=300)
    for line in rve.format_report(report):
        log("  " + line)
    log("real_vs_emulated: " + json.dumps(report))
    for key in ("calibration", "real"):
        launched = report[key]["launches"]
        if launched["flash_attention"] <= 0 or launched["paged_attention"] <= 0:
            raise AssertionError(f"{key}: K1 or K2 never launched: {launched}")
        if report[key]["num_requests"] != rve.STREAM["num_requests"]:
            raise AssertionError(f"{key}: {report[key]['num_requests']} requests finished")
    for key in ("emulate_linear", "emulate_analytical"):
        r = report[key]
        if any(r["launches"].values()):
            raise AssertionError(f"{key} launched kernels: {r['launches']}")
        if r["allocated_delta_bytes"] != 0:
            raise AssertionError(f"{key} changed the allocated device memory by "
                                 f"{r['allocated_delta_bytes']} bytes")
        if r["num_requests"] != rve.STREAM["num_requests"]:
            raise AssertionError(f"{key}: {r['num_requests']} requests finished")
        if not r["wall_s"] < report["real"]["wall_s"]:
            raise AssertionError(f"{key} took {r['wall_s']} s of wall time, the real "
                                 f"run {report['real']['wall_s']} s")
    log(f"phase 6b took {time.monotonic() - t0:.1f} s")


def profile_serving(serve, ranges=()) -> None:
    """Device time by kernel over one ``serve()`` call, and the device's busy
    share of the wall time (one stream, so kernels do not overlap).  Each
    function of ``repro_torch.models.layers`` named in ``ranges`` (``moe``,
    ``rglru_scan``) runs inside a ``record_function`` range of its name, and
    operators are recorded too: a range's device time is that of every
    kernel that ran within the device-side span of one of its calls (one
    stream, stepped in this thread: for the MoE, routing, sort, gather, the
    grouped products, named ``*group*``, the activation and the scatter-add;
    for the RG-LRU recurrence, its elementwise kernels and reductions).
    Without ranges only the device is traced.  The events are read as
    kineto gives them (:func:`device_events`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import layers as L
    originals = {name: getattr(L, name) for name in ranges}

    def in_range(name, fn):
        def wrapped(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return wrapped

    for name, fn in originals.items():
        setattr(L, name, in_range(name, fn))
    try:
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges else [])
        with profile(activities=activities) as prof:
            t0 = time.monotonic()
            serve()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    finally:
        for name, fn in originals.items():
            setattr(L, name, fn)
    raw = prof.profiler.kineto_results.events()
    events = device_events(raw, tuple(originals))
    kernels = kernel_table(events)
    # the ranges: the kernels that started within a call's span on the device
    in_ranges = {}
    ordered = sorted(events, key=lambda e: e[1])
    starts = [start for _, start, _ in ordered]
    prefix = list(itertools.accumulate((ns for _, _, ns in ordered), initial=0))
    for name, spans in range_spans(raw, tuple(originals)).items():
        ns = sum(prefix[bisect.bisect_right(starts, end)] - prefix[bisect.bisect_left(starts, a)]
                 for a, end in spans)
        in_ranges[name] = [ns / 1e6, len(spans)]
    total = sum(ms for ms, _, _ in kernels)
    if not kernels:
        log("profiler saw no device time")
        return
    groups = {"flash_attention (K1)": 0.0, "paged_attention (K2)": 0.0,
              "ssd_scan (K3)": 0.0, "MoE grouped products": 0.0, "matrix products": 0.0,
              "other": 0.0}
    for ms, _, name in kernels:
        low = name.lower()
        if "group" in low:
            groups["MoE grouped products"] += ms
        elif "flash_fwd" in name:
            groups["flash_attention (K1)"] += ms
        elif "paged_fwd" in name:
            groups["paged_attention (K2)"] += ms
        elif "ssd_fwd" in name:
            groups["ssd_scan (K3)"] += ms
        elif any(w in low for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")):
            groups["matrix products"] += ms
        else:
            groups["other"] += ms
    log(f"wall {wall_ms:.1f} ms under the profiler (engine stepped in this thread), "
        f"device busy {total:.1f} ms "
        f"({100 * total / wall_ms:.1f}%), idle {100 * (1 - total / wall_ms):.1f}%")
    for g, ms in groups.items():
        log(f"  {g:24s} {ms:9.2f} ms  {100 * ms / total:5.1f}% of device time")
    if "moe" in in_ranges:
        moe_ms, moe_calls = in_ranges["moe"]
        log(f"  MoE layers, all their kernels ({moe_calls} calls): {moe_ms:.2f} ms, "
            f"{100 * moe_ms / total:.1f}% of device time; routing, dispatch and combine "
            f"{moe_ms - groups['MoE grouped products']:.2f} ms")
    if "rglru_scan" in in_ranges:
        scan_ms, scan_calls = in_ranges["rglru_scan"]
        log(f"  RG-LRU recurrence, all its kernels ({scan_calls} calls): {scan_ms:.2f} ms, "
            f"{100 * scan_ms / total:.1f}% of device time (within \"other\"); the rest of "
            f"\"other\" {groups['other'] - scan_ms:.2f} ms")
    for ms, n, name in sorted(kernels, reverse=True)[:10]:
        log(f"  {ms:9.2f} ms  x{n:<6d} {name[:110]}")


def train_full(ops, arch, *, seq, expect, kernels, leaf, sample, groups):
    """Train ``arch`` at full size in fp32 through the training CLI's own
    code (``repro_torch.launch.train``: ``setup`` and ``run``) at ``--batch 8
    --seq <seq> --microbatches 2`` with remat.  Step 1 first, without an
    update, through the kernels and through ``force="plain"`` on the same
    batch: loss within 1e-4 and the gradients' global norm within 1e-2
    (relative), and layer 0's ``leaf`` gradient within 1e-3 of its largest
    entry.  Then 8 steps: every loss finite, the parameters ``sample`` picks
    moved, the forward kernel (``kernels[0]``) 4 launches a layer a step
    (the remat runs each forward again) and its gradient kernel 2, the plain
    run none; step ms, tokens/s, peak allocated memory, and one more step
    under torch.profiler with ``groups``.  Returns the 8 steps' launch
    counts."""
    from repro_torch.launch import train as train_cli
    from repro_torch.models.optim import global_norm, init_adamw, tree_leaves, value_and_grad
    args = train_cli.parse_args(["--arch", arch, "--full-config", "--steps", "8",
                                 "--batch", "8", "--seq", str(seq), "--microbatches", "2",
                                 "--log-every", "1"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    before = torch.cuda.memory_allocated()
    cfg, model, params = train_cli.setup(args)
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated() - before
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"initialised {n_params:,} fp32 parameters in {time.monotonic() - t0:.1f} s")
    before = torch.cuda.memory_allocated()
    opt = init_adamw(params)          # the moments train_cli.run builds, measured and freed
    torch.cuda.synchronize()
    BUILT_BYTES[f"{arch}/fp32"] = (built, _shapes(params))
    BUILT_BYTES[f"{arch}/moments"] = (torch.cuda.memory_allocated() - before,
                                      _shapes([opt.step, opt.mu, opt.nu]))
    del opt
    if n_params != expect or n_params != cfg.param_count():
        raise AssertionError(f"{arch} has {n_params} parameters")
    n_layers = cfg.num_layers

    def at(tree, path):
        for key in path:
            tree = tree[key]
        return tree
    batch = next(train_cli.data_stream(cfg.vocab_size, args.batch, args.seq, seed=1234,
                                       start_step=0))
    step1 = {}
    for force in (None, "plain"):
        ops.reset_launch_counts()
        t0 = time.monotonic()
        loss, _, grads = value_and_grad(model, params, batch, microbatches=2, force=force)
        norm = float(global_norm(grads))
        step1[force] = (float(loss), norm, ops.launch_counts(), time.monotonic() - t0)
        log(f"step 1 {'kernels' if force is None else 'plain'}: loss {step1[force][0]:.6f}, "
            f"gradient norm {norm:.6f}, {step1[force][3]:.2f} s, launches {step1[force][2]}")
        if force is None:      # the first layer's leaf, to compare
            leaf_grad = at(grads, leaf)[0].clone()
        del grads
    (l_k, n_k, c_k, _), (l_p, n_p, c_p, _) = step1[None], step1["plain"]
    leaf_plain = at(params, leaf).grad[0]
    leaf_err = float((leaf_grad - leaf_plain).abs().max()) / float(leaf_plain.abs().max())
    log(f"step 1: layer 0's {'/'.join(leaf)} gradient through the kernels is {leaf_err:.3e} of "
        f"its largest entry from the plain one's")
    if abs(l_k - l_p) > 1e-4 * abs(l_p) or abs(n_k - n_p) > 1e-2 * abs(n_p) or leaf_err > 1e-3:
        raise AssertionError(f"step 1: kernels loss {l_k}, norm {n_k}; plain {l_p}, {n_p}; "
                             f"{leaf} gradient {leaf_err} apart")
    if (c_k[kernels[0]], c_k[kernels[1]]) != (4 * n_layers, 2 * n_layers) \
            or c_p[kernels[0]] or c_p[kernels[1]]:
        raise AssertionError(f"step 1 launches: kernels {c_k}, plain {c_p}")
    log(f"step 1 agrees: loss {abs(l_k - l_p) / abs(l_p):.3e}, gradient norm "
        f"{abs(n_k - n_p) / abs(n_p):.3e} apart (relative)")

    before = sample(params)
    ops.reset_launch_counts()
    out = train_cli.run(args, cfg, model, params)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    params, opt = out["params"], out["opt"]
    losses = [h["loss"] for h in out["history"]]
    moved = [float((a - b).abs().max()) for a, b in zip(sample(params), before)]
    expect_counts = (8 * 4 * n_layers, 8 * 2 * n_layers)
    log(f"8 steps: losses {losses}, parameters moved by {moved}, launches {counts}")
    if not all(math.isfinite(x) for x in losses) or not all(m > 0 for m in moved):
        raise AssertionError(f"training: losses {losses}, moved {moved}")
    if (counts[kernels[0]], counts[kernels[1]]) != expect_counts:
        raise AssertionError(f"{kernels} launched {counts}, expected {expect_counts}")
    secs = sorted(h["seconds"] for h in out["history"][1:])
    step_s = secs[len(secs) // 2]
    peak = torch.cuda.max_memory_allocated()
    log(f"train step (median of steps 2-8): {step_s * 1e3:.1f} ms, "
        f"{args.batch * args.seq / step_s:,.0f} tokens/s; steps {[round(h['seconds'] * 1e3, 1) for h in out['history']]} ms; "
        f"peak allocated {peak / 2**30:.2f} GiB; allocated now "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    profile_training(model, params, opt, cfg, args, groups)
    return counts


def train_qwen(ops):
    """Phase 21: qwen2_5_3b at full size in fp32 (3,085,938,688 parameters),
    batch 8 of 512 tokens, through K1 and K1-bwd (``train_full``; layer 0's
    query projection compared at step 1)."""
    return train_full(
        ops, "qwen2_5_3b", seq=512, expect=3_085_938_688,
        kernels=("flash_attention", "flash_attention_bwd"), leaf=("blocks", "attn", "wq"),
        sample=lambda p: [p["embed"][:4].detach().clone(),
                          p["blocks"]["attn"]["wq"][0, :4].detach().clone(),
                          p["blocks"]["mlp"]["wo"][-1, :4].detach().clone()],
        groups={"K1 (flash_fwd)": "flash_fwd", "K1-bwd (flash_bwd)": "flash_bwd"})


def train_mamba(ops):
    """Phase 22: mamba2_370m at full size in fp32 (368,227,840 parameters),
    batch 8 of 2048 tokens, through K3 and K3-bwd (``train_full``; layer 0's
    input projection compared at step 1)."""
    return train_full(
        ops, "mamba2_370m", seq=2048, expect=368_227_840,
        kernels=("ssd_scan", "ssd_scan_bwd"), leaf=("blocks", "ssd", "w_in"),
        sample=lambda p: [p["embed"][:4].detach().clone(),
                          p["blocks"]["ssd"]["w_in"][0, :4].detach().clone(),
                          p["blocks"]["ssd"]["w_out"][-1, :4].detach().clone()],
        groups={"K3 (ssd_fwd)": "ssd_fwd", "K3-bwd (ssd_bwd)": "ssd_bwd"})


def profile_training(model, params, opt, cfg, args, groups):
    """One more train step (step 9, both microbatches) under torch.profiler:
    the device's busy share of the step's wall time and the shares of device
    time of the kernels in ``groups`` (label: a substring of their names),
    the matrix products and the rest.  The profiler's device clock is held
    against CUDA events recorded around the step: where its span from the
    first launch's start to the last one's end differs from theirs by more
    than 5%, its times are scaled to the events' clock and the log says so
    (one full run on the H100 read every kernel of this step at 0.47 of its
    time, with every launch counted)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as train_cli
    from repro_torch.models.optim import OptimizerConfig, make_train_step
    step_fn = make_train_step(model, OptimizerConfig(lr=args.lr, warmup_steps=20,
                                                     total_steps=args.steps),
                              microbatches=args.microbatches)
    batch = next(train_cli.data_stream(cfg.vocab_size, args.batch, args.seq, seed=1234,
                                       start_step=8))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        start.record()
        step_fn(params, opt, batch)
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    events_ms = start.elapsed_time(end)
    events = device_events(prof.profiler.kineto_results.events())
    timed = [(a, ns) for _, a, ns in events if ns > 0]
    span_ms = (max(a + ns for a, ns in timed) - min(a for a, _ in timed)) / 1e6 if timed else 0.0
    scale = events_ms / span_ms if span_ms > 0 else 1.0
    log(f"the profiler's device clock: {len(timed)} device events over {span_ms:.1f} ms from the "
        f"first start to the last end; CUDA events around the step {events_ms:.1f} ms "
        f"(ratio {scale:.4f})")
    if abs(scale - 1) <= 0.05:
        scale = 1.0
    else:
        log(f"  the profiler's clock disagrees with CUDA events: its device times below are "
            f"multiplied by {scale:.4f}")
    shares = dict.fromkeys(list(groups) + ["matrix products", "other"], 0.0)
    kernels = []
    for ms, n, key in kernel_table(events):
        ms *= scale
        kernels.append((ms, n, key))
        low = key.lower()
        label = next((g for g, name in groups.items() if name in key), None)
        if label is not None:
            shares[label] += ms
        elif any(w in low for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")):
            shares["matrix products"] += ms
        else:
            shares["other"] += ms
    total = sum(shares.values())
    if total <= 0:
        raise AssertionError("the profiler saw no device time in a train step")
    log(f"train step under the profiler: wall {wall_ms:.1f} ms, device busy {total:.1f} ms "
        f"({100 * total / wall_ms:.1f}%), idle {100 * (1 - total / wall_ms):.1f}%")
    for g, ms in shares.items():
        log(f"  {g:22s} {ms:9.2f} ms  {100 * ms / total:5.1f}% of device time")
    for ms, n, name in sorted(kernels, reverse=True)[:8]:
        log(f"  {ms:9.2f} ms  x{n:<6d} {name[:110]}")


def restart_qwen():
    """Phase 21b: qwen2_5_3b at full width cut to 2 layers, fp32, batch 8 of
    512 tokens in 2 microbatches: 4 steps straight against 2 steps, a save,
    a restore into fresh tensors and 2 more, every parameter and moment bit
    for bit; the checkpoint in a temporary directory, deleted after."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import data_stream
    from repro_torch.models.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from repro_torch.models.optim import (OptimizerConfig, init_adamw, make_train_step,
                                         tree_leaves)
    from repro_torch.models.transformer import build_model
    cfg = get_config("qwen2_5_3b").replace(num_layers=2, layer_pattern=None)
    model = build_model(cfg)
    step_fn = make_train_step(model, OptimizerConfig(warmup_steps=2, total_steps=10),
                              microbatches=2)

    def fresh():
        params = model.init(torch.Generator(device="cuda").manual_seed(0), torch.float32)
        return params, init_adamw(params)

    def run(params, opt, start, stop):
        stream = data_stream(cfg.vocab_size, 8, 512, seed=7, start_step=start)
        for _ in range(start, stop):
            params, opt, metrics = step_fn(params, opt, next(stream))
        return params, opt, float(metrics["loss"])

    t0 = time.monotonic()
    p_ref, o_ref, loss_ref = run(*fresh(), 0, 4)
    p_half, o_half, _ = run(*fresh(), 0, 2)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        path = save_checkpoint(ckpt_dir, 2, p_half, o_half, extra={"loss": 1.0})
        size = path.stat().st_size
        if latest_step(ckpt_dir) != 2:
            raise AssertionError("latest_step did not find step 2")
        del p_half, o_half
        p_new, o_new, meta = restore_checkpoint(ckpt_dir, 2, *fresh())
    p_out, o_out, loss_out = run(p_new, o_new, 2, 4)
    pairs = list(zip(tree_leaves(p_ref), tree_leaves(p_out))) + list(
        zip(tree_leaves([o_ref.mu, o_ref.nu]), tree_leaves([o_out.mu, o_out.nu])))
    same = sum(torch.equal(a, b) for a, b in pairs)
    log(f"restart: {same} of {len(pairs)} parameter and moment tensors bit-identical, steps "
        f"{int(o_ref.step)} and {int(o_out.step)}, loss {loss_ref} and {loss_out}; checkpoint "
        f"{size / 2**30:.2f} GiB; {time.monotonic() - t0:.1f} s")
    if same != len(pairs) or int(o_out.step) != 4 or loss_out != loss_ref \
            or meta["step"] != 2:
        raise AssertionError("the restarted run is not bit-identical to the straight one")


def expert_parallel():
    """Phase 23: qwen3_30b_a3b at full width, 8 of its 48 layers, served by
    the one-process dropless model here and then by 2 expert-parallel ranks
    (``repro_torch.launch.parallel``: gloo, both on this card, 64 experts
    each, the attention tensor-parallel); see the module docstring.  Returns
    the ranks' kernel launches, summed."""
    from repro_torch.launch import parallel as ep
    args = ep.parse_args(["--arch", "qwen3_30b_a3b", "--layers", "8", "--ranks", "2",
                          "--batch", "4", "--prompt", "512"])
    cfg = ep.model_config(args)
    log(f"qwen3_30b_a3b at full width (d_model {cfg.d_model}, {cfg.moe.num_experts} experts, "
        f"top-{cfg.moe.top_k}), depth cut to {args.layers} of 48 layers: the dropless copy, then "
        f"{args.ranks} ranks of {cfg.moe.num_experts // args.ranks} experts, one after the other; "
        f"capacity factors {ep.capacity_factors(args)} (at {args.ranks:.0f} nothing can drop)")
    t0 = time.monotonic()
    ref = ep.reference(args)
    torch.cuda.empty_cache()
    log(f"dropless model: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    ranks = ep.launch(args)
    log(f"{args.ranks} ranks: {time.monotonic() - t0:.1f} s, built in "
        f"{[round(r['build_seconds'], 1) for r in ranks]} s, peak allocated "
        f"{[round(r['memory'] / 2**30, 2) for r in ranks]} GiB")
    log("times below: two ranks sharing one card, exchange through host memory "
        "(gloo); not a multi-card figure")
    for line in ep.summary(ranks, ref):
        log(line)
    launches = ep.check(args, ranks, ref, 5e-2)
    log(f"phase 23 passed: launches {dict(launches)}")
    return launches


# phase: (the launcher's arguments, what the phase serves); phases 25-28
TENSOR_PARALLEL = {
    25: (["--arch", "llama3_70b", "--layers", "8", "--ranks", "4", "--batch", "4",
          "--prompt", "256", "--decodes", "4"],
         "llama3_70b at full width, 8 of its 80 layers: 64 query heads over 8 KV heads, "
         "each rank 16 over 2"),
    26: (["--arch", "qwen2_5_3b", "--layers", "12", "--ranks", "4", "--batch", "4",
          "--prompt", "512", "--decodes", "4"],
         "qwen2_5_3b at full width, 12 of its 36 layers: 16 query heads over 2 KV heads of "
         "128, each rank 4 query heads over a 32-wide block of head_dim of both KV heads"),
    27: (["--arch", "recurrentgemma_2b", "--ranks", "2", "--batch", "2", "--prompt", "3072",
          "--decodes", "4"],
         "recurrentgemma_2b at full size, 3072-token prompts past its 2048-token window: each "
         "rank 5 query heads over 128 of its KV head's 256 dimensions, 1280 of the RG-LRU's "
         "2560 channels"),
    28: (["--arch", "whisper_base", "--ranks", "2", "--batch", "4", "--prompt", "64",
          "--frames", "1500", "--decodes", "4"],
         "whisper_base at full size, 1500 frames a row: encoder, decoder and cross attention "
         "each rank 4 of 8 heads"),
    29: (["--arch", "mamba2_370m", "--layers", "12", "--ranks", "4", "--batch", "2",
          "--prompt", "1000", "--decodes", "4", "--dtype", "float32"],
         "mamba2_370m at full width in fp32, 12 of its 48 layers, 2 prompts of 1000 tokens (a "
         "ragged last chunk of K3's 128): each rank 8 of the 32 heads (K3 over them), 1096 of "
         "w_in's 4384 packed columns, 576 of the 2304 conv channels"),
    30: (["--arch", "mixtral_8x7b", "--layers", "2", "--ranks", "16", "--batch", "4",
          "--prompt", "256", "--decodes", "4"],
         "mixtral_8x7b at full width, 2 of its 32 layers: each rank 2 of 32 query heads over "
         "an 8-wide block of head_dim of the 8 KV heads, the 8 experts on their FFN width "
         "(1792 of w_in's 28672 columns, 896 of w_out's 14336 rows)"),
}


# phase: (the launcher's arguments, what the phase serves); phases 33-37, on
# ("data", "model") meshes placed as the reference's decode cells
SERVE_MESH = {
    33: (["--arch", "mixtral_8x7b", "--layers", "4", "--mesh", "2,2", "--batch", "1",
          "--prompt", "6144", "--decodes", "8"],
         "mixtral_8x7b at full width, 4 of its 32 layers, long_500k's placement: one 6144-token "
         "prompt past its 4096-slot ring, 2048 slots of it a 'data' rank (K2 on each run of a "
         "rank's block, merged over 'data'); a 'model' rank 16 of 32 query heads over 4 of 8 KV "
         "heads and 4 of the 8 experts, whose d is 2048 of 4096 a 'data' rank"),
    34: (["--arch", "qwen3_30b_a3b", "--layers", "4", "--mesh", "2,2", "--batch", "8",
          "--prompt", "512", "--decodes", "4"],
         "qwen3_30b_a3b at full width, 4 of its 48 layers, decode_32k's placement: 8 rows, 4 a "
         "'data' rank (K2 on its rows); a 'model' rank 16 of 32 query heads over 2 of 4 KV heads "
         "and 64 of the 128 experts, whose d is 1024 of 2048 a 'data' rank"),
    35: (["--arch", "recurrentgemma_2b", "--mesh", "2,2", "--batch", "1", "--prompt", "3072",
          "--decodes", "4"],
         "recurrentgemma_2b at full size, long_500k's placement: one 3072-token prompt past its "
         "2048-slot ring, 1024 slots of it a 'data' rank; a 'model' rank 5 of 10 query heads "
         "over 128 of its KV head's 256 dimensions (K2 at D=256 over the block gathered to "
         "whole heads) and 1280 of the RG-LRU's 2560 channels, its state whole over 'data'"),
    36: (["--arch", "qwen2_5_3b", "--layers", "12", "--mesh", "1,4", "--batch", "8",
          "--prompt", "512", "--decodes", "4", "--opt", "kv_seq_shard"],
         "qwen2_5_3b at full width, 12 of its 36 layers (phase 26's model and ranks), "
         "decode_32k's placement under kv_seq_shard: 8 prompts of 512, each rank 144 of the "
         "576 slots of both KV heads whole; a decode gathers the 4 query heads of each rank "
         "to all 16 and the token's k, v to whole heads, runs K2 over the block for every "
         "query head and merges the (out, lse) over 'model'"),
    "37a": (["--arch", "recurrentgemma_2b", "--mesh", "2,1", "--batch", "1", "--prompt", "3072",
             "--decodes", "4", "--opt", "kv_defer_append"],
            "recurrentgemma_2b at full size, kv_defer_append, long_500k's placement: one "
            "3072-token prompt past its 2048-slot ring, 1024 slots a 'data' rank; a decode "
            "runs K2 over the runs of the rank's block of the cache before the token, the "
            "token's own key counted on the rank whose block holds its slot, and the rank "
            "writes it after the layer"),
    "37b": (["--arch", "whisper_base", "--mesh", "4,1", "--batch", "1", "--prompt", "64",
             "--frames", "1500", "--decodes", "4"],
            "whisper_base at full size, batch 1 on 4 'data' ranks: 1500 frames, 375 a rank in "
            "384 slots (the pad after them), and the decoder's 128 KV slots (32 a rank), every "
            "rank encoding every frame; a decode runs K2 over the rank's block of its own and "
            "of the frames (375 of them), each merged over 'data'"),
}


@contextlib.contextmanager
def card_in_use(every=0.05):
    """The card's largest memory in use, by every process on it, while the
    block runs (``torch.cuda.mem_get_info`` read every ``every`` seconds
    from a thread): yields a dict whose "peak" is in bytes."""
    import threading
    out = {"peak": 0}
    done = threading.Event()

    def poll():
        while not done.is_set():
            free, total = torch.cuda.mem_get_info()
            out["peak"] = max(out["peak"], total - free)
            done.wait(every)

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        done.set()
        thread.join()


def tensor_parallel(phase, table=TENSOR_PARALLEL):
    """Phases 25-30 (and 33-37 from ``SERVE_MESH``): the model of
    ``table[phase]`` served by the one-process model here, which is then
    freed, and by ranks sharing this card (``repro_torch.launch.parallel``:
    gloo, each rank's blocks drawn leaf by leaf, the ranks one after
    another), tensor-parallel over "model" and, on a mesh, placed over
    "data" as the reference's decode cells; see the module docstring.
    Returns the ranks' kernel launches, summed."""
    from repro_torch.launch import parallel
    argv, what = table[phase]
    args = parallel.parse_args(argv)
    log(f"{what}; the one-process model, then {args.ranks} ranks")
    t0 = time.monotonic()
    ref = parallel.reference(args)
    torch.cuda.empty_cache()
    log(f"one-process model: {time.monotonic() - t0:.1f} s; allocated after freeing it "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t0 = time.monotonic()
    with card_in_use() as card:
        ranks = parallel.launch(args)
    (_, p_sizes), (_, c_sizes) = parallel.expected(args)
    log(f"{args.ranks} ranks: {time.monotonic() - t0:.1f} s, built in "
        f"{[round(r['build_seconds'], 1) for r in ranks]} s, peak allocated "
        f"{[round(r['memory'] / 2**30, 2) for r in ranks]} GiB; the card's peak in use by "
        f"every process {card['peak'] / 2**30:.2f} GiB")
    if parallel.model_config(args).ssm is not None:
        log(f"each rank's SSD state {ranks[0]['cache']['layers/state']} (its heads), conv "
            f"{ranks[0]['cache']['layers/conv']}; K3 launches a prefill by rank "
            f"{[r['prefill'][0]['launches']['ssd_scan'] for r in ranks]}")
    for r in ranks:
        log(f"rank {r['rank']}: parameters allocated {r['param_bytes']:,} bytes, "
            f"mesh.shard_bytes {sum(p_sizes):,} (rounded {parallel.allocation_bounds(p_sizes)}); "
            f"cache {r['cache_bytes']:,}, shard_bytes {sum(c_sizes):,} "
            f"(rounded {parallel.allocation_bounds(c_sizes)})")
        if args.mesh:
            allocated, reserved = r["serve_memory"]
            log(f"rank {r['rank']} while serving: peak allocated {allocated / 2**30:.2f} GiB, "
                f"reserved {reserved / 2**30:.2f} GiB")
            per_prefill, per_decode = parallel.kernel_launches(args, r["coords"])
            log(f"rank {r['rank']} at {r['coords']}: rows {r['rows']}, K1 a prefill "
                f"{r['prefill'][0]['launches']['flash_attention']} (expected "
                f"{per_prefill['flash_attention']}), K2 over the decodes "
                f"{r['decode']['launches']['paged_attention']} (expected by decode "
                f"{[d['paged_attention'] for d in per_decode]})")
    log(f"times and gathered bytes below: {args.ranks} ranks sharing one card, the collectives "
        "host-exchanged through gloo; not a multi-card figure")
    for line in parallel.summary(ranks, ref):
        log(line)
    # bf16: the 5e-2 of the model checks; fp32: the repo's logit tolerance,
    # 2e-3, which phase 7 holds K3 to in the same model.  mamba2_370m runs
    # in fp32: in bf16 its 48 random layers carry any change of rounding on
    # (phase 7 prints K3 and the plain scan several per cent apart in bf16),
    # so the bf16 gate would not tell a wrong split from a reordered sum
    tol = 5e-2 if args.dtype == "bfloat16" else 2e-3
    launches = parallel.check(args, ranks, ref, tol)
    if phase in CENSUS_PHASES:
        hold_census(phase, args, ranks)
    DECODE_GATHERED[phase] = (args.batch, ranks[0]["decode"]["gathered"])
    log(f"phase {phase} passed at {tol}: launches {dict(launches)}")
    return launches


# phase: (rows, {what: bytes} rank 0 received in each decode), recorded by
# tensor_parallel for phase 36's comparison
DECODE_GATHERED = {}


def frame_pad(phase):
    """Phase 37b's cache in bytes: a rank's blocks by the cache rules at the
    reference's frame count (``mesh.shard_bytes`` of the specs on a tree
    whose cross cache holds 1500 frames, unpadded) and the pad of its block
    of the frames, which must be the pad slots (``whole_pages(F / n) − F /
    n``) of every layer's k and v exactly; ``parallel.check`` has held each
    rank's allocated cache to their sum."""
    from repro_torch.launch import mesh, parallel
    from repro_torch.models.transformer import build_model, whole_pages
    args = parallel.parse_args(SERVE_MESH[phase][0])
    axes = parallel.mesh_axes(args)
    cfg = parallel.model_config(args)
    with mesh.use_mesh(None):
        whole = parallel._init_cache(args, build_model(cfg), torch.bfloat16, "meta", None)
    F, n = whole["cross_frames"], axes.sizes["data"]
    ref = dict(whole)
    for name in ("cross_k", "cross_v"):
        shape = list(whole[name].shape)
        shape[-3] = F
        ref[name] = torch.empty(shape, dtype=whole[name].dtype, device="meta")
    at_frames = mesh.shard_bytes(ref, mesh.cache_specs(whole, axes, batch=args.batch), axes)
    (_, _), (_, c_sizes) = parallel.expected(args)
    slots = whole_pages(F // n) - F // n
    pad = 2 * cfg.num_layers * args.batch * slots * cfg.num_kv_heads * cfg.head_dim * 2
    if sum(c_sizes) != at_frames + pad:
        raise AssertionError(f"a rank's cache {sum(c_sizes)} bytes is not shard_bytes at {F} "
                             f"frames {at_frames} plus the pad {pad}")
    log(f"phase {phase}: a rank's cache {sum(c_sizes):,} bytes = mesh.shard_bytes at {F} frames "
        f"{at_frames:,} + the pad {pad:,} ({slots} slots after its {F // n} frames, of "
        f"{cfg.num_layers} layers' k and v)")


def seq_shard_against_head_dim():
    """Phase 36's exchange beside phase 26's: the bytes a rank received a
    decode under kv_seq_shard (the query heads and the token's k, v to
    whole heads, the blocks' (out, lse) merged: "seq_shard"; the token's
    k, v gathered off head_dim: "head_dim") against phase 26's head_dim
    gather of each decode's live rows (the same model and ranks), a row."""
    rows26, dec26 = DECODE_GATHERED[26]
    rows36, dec36 = DECODE_GATHERED[36]
    total26 = [sum(step.values()) for step in dec26]
    total36 = [sum(step.values()) for step in dec36]
    log(f"bytes a rank received a decode: phase 26 (head_dim, {rows26} rows) {total26} "
        f"({[round(b / rows26) for b in total26]} a row); phase 36 (kv_seq_shard, {rows36} "
        f"rows) {total36} ({[round(b / rows36) for b in total36]} a row: seq_shard "
        f"{[step.get('seq_shard', 0) for step in dec36]}, head_dim "
        f"{[step.get('head_dim', 0) for step in dec36]})")
    if not all(step.get("seq_shard") for step in dec36):
        raise AssertionError(f"phase 36's decodes exchanged no seq_shard bytes: {dec36}")


# phase: (the training launcher's arguments, what the phase trains)
TRAIN_MESH = {
    31: (["--arch", "qwen2_5_3b", "--full-config", "--layers", "2", "--mesh", "2,2",
          "--steps", "2", "--batch", "8", "--seq", "512", "--microbatches", "2",
          "--log-every", "1"],
         "qwen2_5_3b at full width, 2 of its 36 layers, fp32: each rank 8 of the 16 query "
         "heads over 1 of the 2 KV heads, 5504 of F's 11008, 75968 of the 151936 vocabulary "
         "rows, and d cut again over 'data'"),
    32: (["--arch", "mamba2_370m", "--full-config", "--layers", "24", "--mesh", "2,2",
          "--steps", "2",
          "--batch", "8", "--seq", "512", "--microbatches", "2", "--log-every", "1"],
         "mamba2_370m at full width, 24 of its 48 layers, fp32, batch 8 of 512 tokens: each "
         "rank 16 of "
         "the 32 SSD heads (K3 and K3-bwd over them), 2192 of w_in's 4384 packed columns, "
         "and d cut again over 'data'"),
    38: (["--arch", "qwen2_5_3b", "--full-config", "--layers", "2", "--mesh", "2,1,2",
          "--steps", "2", "--batch", "8", "--seq", "512", "--microbatches", "2",
          "--log-every", "1"],
         "qwen2_5_3b at full width, 2 of its 36 layers, fp32, phase 31's batch on the "
         "(2, 1, 2) pod mesh: each rank 8 of the 16 query heads over 1 of the 2 KV heads, "
         "half of F and of the vocabulary, d cut again over ('pod', 'data')"),
    39: (["--arch", "whisper_base", "--full-config", "--mesh", "2,2", "--frames", "1500",
          "--steps", "2", "--batch", "8", "--seq", "448", "--microbatches", "2",
          "--log-every", "1"],
         "whisper_base at full size, fp32, batch 8 of 1500 frames and 448 tokens: each rank 4 "
         "of the 8 heads of every encoder, decoder and cross attention layer, half of F, the "
         "vocabulary (51865, which 2 does not divide) whole, d cut again over 'data'"),
}


def train_mesh(phase):
    """Phases 31-32 and 38-39: the model of ``TRAIN_MESH[phase]`` trained by
    the 4 ranks of its mesh sharing this card (``repro_torch.launch.train``:
    gloo, each rank's blocks drawn leaf by leaf, the ranks one after
    another), then by the one-process model here, which is then freed;
    ``train.check`` holds the ranks to it.  Returns the ranks' kernel
    launches, summed."""
    from repro_torch.launch import parallel, train
    argv, what = TRAIN_MESH[phase]
    args = train.parse_args(argv)
    log(f"{what}; ranks of the mesh {args.mesh}, then the one-process model")
    t0 = time.monotonic()
    with card_in_use() as card:
        ranks = train.launch(args)
    _, sizes = train.expected(args)
    log(f"{len(ranks)} ranks: {time.monotonic() - t0:.1f} s, built in "
        f"{[round(r['build_seconds'], 1) for r in ranks]} s, peak allocated "
        f"{[round(r['memory'] / 2**30, 2) for r in ranks]} GiB (steps); the card's peak in use "
        f"by every process {card['peak'] / 2**30:.2f} GiB")
    for line in ranks[0]["lines"]:
        log(f"rank 0: {line}")
    moments = sizes + sizes + [4]
    for r in ranks:
        log(f"rank {r['rank']} at (batch axes, model) {r['coords']}: parameters allocated "
            f"{r['param_bytes']:,} bytes, mesh.shard_bytes {sum(sizes):,} (rounded "
            f"{parallel.allocation_bounds(sizes)}); moments {r['moment_bytes']:,}, "
            f"{sum(moments):,} (rounded {parallel.allocation_bounds(moments)}); launches by step "
            f"{[h['launches'] for h in r['history']]}")
    if train.model_config(args, quiet=True).ssm is not None:
        heads = {r["params"]["blocks/ssd/w_out"][-2] // 64 for r in ranks}
        log(f"each rank's SSD heads: {heads} of 32 (w_out rows / head_dim 64), w_in "
            f"{ranks[0]['params']['blocks/ssd/w_in']}")
        if heads != {16}:
            raise AssertionError(f"the ranks' SSD heads are {heads}, not 16 of 32")
    t0 = time.monotonic()
    ref = train.reference(args)
    torch.cuda.empty_cache()
    log(f"one-process model: {time.monotonic() - t0:.1f} s, steps "
        f"{[round(h['seconds'] * 1e3, 1) for h in ref['history']]} ms; allocated after "
        f"freeing it {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    log("times and bytes below: 4 ranks sharing one card, the collectives host-exchanged "
        "through gloo; not a multi-card figure")
    errs = train.gradient_errors(args, ranks, ref)
    for line in train.summary(args, ranks, ref, errs):
        log(line)
    if train.model_config(args, quiet=True).ssm is not None:
        exact_witness(args, ranks, ref)
    launches = train.check(args, ranks, ref, errs, loss_tol=1e-4, norm_tol=1e-3, leaf_tol=1e-3)
    if phase in CENSUS_PHASES:
        hold_census(phase, args, ranks)
    log(f"phase {phase} passed: launches {dict(launches)}, on each rank "
        f"{ {k: n for k, n in train.kernel_launches(args).items() if n} } a step")
    return launches


# the phases whose ranks' collectives are held against their census on the
# meta device (hold_census), and what each rank issued, summed over its steps
CENSUS_PHASES = (31, 33, 36)
CENSUS = {}


def hold_census(phase, args, ranks):
    """Phases 31, 33 and 36: what each rank issued on the card, the result
    bytes and the ops by kind of every collective of each step (a training
    step; a prefill and each decode), recorded by
    ``layers.record_collective``, against the census of the same rank's
    program on the meta device (``launch.rank_cost``: ``train_program``,
    ``serve_program`` with the experts' gathers sized as the rank recorded
    them), exactly.  The census runs here, in a stand-in process group of
    the mesh's size."""
    from repro_torch.launch import parallel, rank_cost, train
    t0 = time.monotonic()
    train_phase = phase in TRAIN_MESH
    axes = (train if train_phase else parallel).mesh_axes(args)
    out = []
    for r in ranks:
        if train_phase:
            d, m = r["coords"]
            coords = {"model": m}
            for a in reversed(axes.names[:-1]):     # the batch coordinate is pod-major
                coords[a], d = d % axes.sizes[a], d // axes.sizes[a]
            coords = {a: coords[a] for a in axes.names}
            cfg = train.model_config(args, quiet=True)
            batch = {k: torch.empty((args.batch, args.seq), dtype=torch.int64, device="meta")
                     for k in ("tokens", "labels")}
            if args.frames:
                batch["frontend_embeds"] = torch.empty((args.batch, args.frames, cfg.d_model),
                                                       device="meta")
            real = [h["census"] for h in r["history"]]
            meta = [rank_cost.census(axes, coords, lambda: rank_cost.train_program(
                cfg, batch, args.microbatches, dtype=torch.float32))] * len(real)
        else:
            coords = r["coords"]
            cfg = parallel.model_config(args, parallel.moe_impl(args),
                                        parallel.capacity_factors(args)[0])
            kept = r["prefill"][0]["kept"] + [k for step in r["decode"]["kept"] for k in step]
            real = [r["prefill"][0]["census"]] + r["decode"]["census"]
            meta = rank_cost.census(axes, coords, lambda: rank_cost.serve_program(
                cfg, args.batch, parallel.cache_len(args), [args.prompt] + [1] * args.decodes,
                dtype=getattr(torch, args.dtype), seq_shard=parallel.seq_shard(args),
                frames=args.frames, kept=kept))
        for step, (got, exp) in enumerate(zip(real, meta)):
            for key in ("bytes_by_op", "ops_by_op"):
                if got[key] != exp[key]:
                    raise AssertionError(f"phase {phase} rank at {coords} step {step}: {key} "
                                         f"issued on the card {got[key]}, census {exp[key]}")
        summed = {key: {k: sum(step[key][k] for step in real) for k in real[0][key]
                        if any(step[key][k] for step in real)}
                  for key in ("bytes_by_op", "ops_by_op")}
        out.append(dict(coords=coords, steps=len(real), **summed))
        log(f"phase {phase} rank at {coords}: {len(real)} steps issued {summed['bytes_by_op']} "
            f"bytes in {summed['ops_by_op']} ops on the card, the census on the meta device "
            f"the same, step for step")
    CENSUS[phase] = out
    log(f"phase {phase}: the census of {len(ranks)} ranks on the meta device held exactly, "
        f"{time.monotonic() - t0:.1f} s")


# a leaf of the ranks' step-1 gradient may lie this many times as far from
# the float64 witness as the one process's, plus this share of its largest
# entry (phase 32: the ranks read 0.47-0.91 times the one process's
# distance at T=512, 0.44-1.07 at T=2048; a split that computed another
# gradient would add its error to the ranks' alone)
EXACT_RATIO, EXACT_FLOOR = 1.5, 1e-5


def exact_witness(args, ranks, ref):
    """Phase 32's float64 witness (``train.witness``: the one process's step
    1 in fp64 through the plain versions, on the same weights and batch):
    each leaf's distance from it of the one process's fp32 gradient and of
    the ranks', relative to the witness's largest entry.  Raises unless
    every leaf of the ranks' lies within ``EXACT_RATIO`` times the one
    process's distance plus ``EXACT_FLOOR``.  At 48 random layers fp32
    rounding alone puts each run about 1e-3 of a leaf's largest entry from
    the exact gradient, the one process included, so the 1e-3 gate against
    the one process (``train.check``) sits at that floor; this one tells a
    split that computed another gradient from rounding."""
    from repro_torch.launch import mesh, train
    t0 = time.monotonic()
    exact = train.witness(args)
    torch.cuda.empty_cache()
    one = train.leaf_errors(dict(mesh.leaves_with_names(ref["grads"])), exact)
    got = train.leaf_errors(train.rank_gradients(args, ranks), exact)
    far = sorted(exact, key=lambda n: got[n] / (one[n] + EXACT_FLOOR), reverse=True)
    log(f"float64 witness of step 1 ({time.monotonic() - t0:.1f} s): the one process's fp32 "
        f"gradient within {max(one.values()):.3e} of each leaf's largest entry, the ranks' "
        f"within {max(got.values()):.3e}; by leaf (ranks, one process): "
        + ", ".join(f"{n} {got[n]:.3e} {one[n]:.3e}" for n in far))
    bad = {n: (got[n], one[n]) for n in far if got[n] > EXACT_RATIO * one[n] + EXACT_FLOOR}
    if bad:
        raise AssertionError(f"the ranks' step-1 gradients lie farther from the float64 witness "
                             f"than {EXACT_RATIO} x the one process's + {EXACT_FLOOR}: {bad}")


def dry_run_bytes():
    """Phase 24: the dry-run's accounting (``specs.abstract_params`` on the
    meta device, ``init_adamw`` of it, ``mesh.param_specs`` and
    ``mesh.shard_bytes`` at a (1, 1) mesh) for qwen3_30b_a3b's bf16
    parameters (phase 10) and qwen2_5_3b's fp32 parameters and moments
    (phase 21), against the allocation measured when each was built: the
    meta trees must have the built trees' shapes and types, their bytes the
    allocation's once each tensor is rounded up to ALLOC_BLOCK."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh, specs
    from repro_torch.models.optim import init_adamw
    from repro_torch.models.transformer import build_model
    axes = mesh.MeshAxes(("data", "model"), (1, 1))
    cases = []
    qwen3 = specs.abstract_params(build_model(get_config("qwen3_30b_a3b")))
    cases.append(("qwen3_30b_a3b bf16 parameters (phase 10)", "qwen3_30b_a3b", qwen3,
                  mesh.param_specs(qwen3, axes, "serve")))
    qwen2 = specs.abstract_params(build_model(get_config("qwen2_5_3b")), torch.float32)
    p_specs = mesh.param_specs(qwen2, axes, "train")
    cases.append(("qwen2_5_3b fp32 parameters (phase 21)", "qwen2_5_3b/fp32", qwen2, p_specs))
    opt = init_adamw(qwen2)
    cases.append(("qwen2_5_3b AdamW moments and step (phase 21)", "qwen2_5_3b/moments",
                  [opt.step, opt.mu, opt.nu], [(), p_specs, p_specs]))
    for what, key, tree, tree_specs in cases:
        measured, built = BUILT_BYTES[key]
        counted = mesh.shard_bytes(tree, tree_specs, axes)
        if _shapes(tree) != built:
            raise AssertionError(f"{what}: the meta tree's shapes and types are not the built tree's")
        sizes = [t.numel() * t.element_size() for t in _leaves(tree)]
        rounded = sum(_rounded(n) for n in sizes)
        large = sum(_rounded(n) > ALLOC_UNSPLIT for n in sizes)
        fresh = sum(_fresh_block(n) for n in sizes)
        log(f"{what}: dry-run argument_bytes {counted:,}; allocated {measured:,}, "
            f"{measured - counted:,} more: {len(sizes)} tensors rounded up to {ALLOC_BLOCK} bytes "
            f"make {rounded:,}, and the {large} of over {ALLOC_UNSPLIT:,} bytes may each hold "
            f"up to {ALLOC_UNSPLIT:,} more of an unsplit block (fresh segments: {fresh:,}, "
            f"{'equal to' if fresh == measured else 'not'} the allocation)")
        if counted != sum(sizes) or not rounded <= measured <= rounded + large * ALLOC_UNSPLIT:
            raise AssertionError(f"{what}: counted {counted}, allocated {measured}, "
                                 f"rounded {rounded}, {large} large tensors")


def _rounded(n):
    """An n-byte tensor's request as the CUDA caching allocator books it."""
    return max(ALLOC_BLOCK, -(-n // ALLOC_BLOCK) * ALLOC_BLOCK)


def _fresh_block(n):
    """The block the caching allocator books for an n-byte tensor from a new
    segment: a request of 10 MiB or more gets a segment rounded up to 2 MiB,
    which is split only if more than ALLOC_UNSPLIT would be left over;
    smaller requests are split out of their segment exactly."""
    size = _rounded(n)
    if size < 10 << 20:
        return size
    segment = -(-size // (2 << 20)) * (2 << 20)
    return segment if segment - size <= ALLOC_UNSPLIT else size


def _shapes(tree):
    """(shape, dtype) of every tensor of ``tree``, in order."""
    return [(tuple(t.shape), t.dtype) for t in _leaves(tree)]


def _widen(tree):
    """The same tree with every tensor in fp32."""
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_widen(v) for v in tree]
    return tree.float()


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
